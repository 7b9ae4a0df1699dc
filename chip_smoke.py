"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    # two commits' kernels on one card, in turns (A, B, B, A)
    python3 chip_smoke.py --kernels wf_ext,profile_bt --port OTHER_CHECKOUT

Phases, each printing its result on its own line:
  1. card and build: the card's name and power limit (nvidia-smi), the
     port's native host library built with cc from
     tidehunter_tpu_torch/native/, then every kernel of csrc/ built with
     nvcc for sm_90a (one nvcc per source, all started together);
  2. every kernel of the consensus path against its plain PyTorch version
     on the card, exact integer equality, at the shapes the default path
     gives it, with both times (CUDA events, the kernel's runs queued
     behind a device sleep); wf_ext also at each lanes-a-thread choice;
     profile_dp off the warp kernel's rungs (full width, the 4096 bucket)
     also against its first version, equal and timed in the same run;
     myers_hw (the adapter search) against hw_batch_plain at the adapter
     path's shapes (4096 searches of the 84 and 25 bp adapters in ~1.1 kb
     doubled consensus) and the single-copy path's (2048 searches of 32,
     64, 65 and 128 bp queries in ~5 kb reads), its bound counting
     ceil(qlen / 64) words a search;
  3. the wavefront dtype probe: wf_dtype_probe against probe_plain, exact,
     in all four variants at (T=512, BT=128) and (T=200, BT=7), then the
     probe's own timing table at its defaults;
  4. the default consensus path end to end: 1024 synthetic R2C2 reads
     (evals/synth.synth_read, seed 42) through pipeline.runner with the
     port's engine on cuda, chunks of 512, one warm run then a timed run;
     every kernel of the path must have launched in the timed run, and the
     records of 32 of those reads plus 12 fuzz-style reads must be
     byte-identical with the port's host oracle
     (pipeline.core.tidehunter_core); then the timed run once more under
     torch.profiler: each kernel's device ms and launches on the slice and
     the device busy share;
  5. short and long periods end to end: 512 reads of a 60 bp unit x 60,
     256 of 1500 bp x 6 and 128 of 3000 bp x 4 (synth_read, seed 43)
     through the same runner and engine, one warm run then a timed run;
     full-width rounds (K3) and the 4096 bucket must have launched; the
     timed run's records of the first 8 reads of each population
     byte-identical with tidehunter_core (run over a pool of host
     processes); the timed run once more under torch.profiler;
  6. options: 1024 R2C2 reads with adapters (each unit the 84 bp 5'
     adapter, a 450 bp insert and the reverse complement of the 25 bp 3'
     adapter; 9 copies at 10% error, a quarter of the reads a single
     copy) through the port's CLI with -5/-3 -f 2, -5/-3 -F and
     -5/-3 -s -F, then the slice's reads with --polish 1 and --msa graph:
     each run's reads/s and stage timers (--metrics), its launches and
     hws_host, the problems of each myers_hw launch, and the records of
     its first 8 reads byte-identical with tidehunter_core (over a pool
     of host processes); the --msa graph run writes a --profile trace,
     which must parse and hold the card's kernels; then myers_hw against
     hw_batch_plain on the inputs of the -5/-3 -f 2 run's largest launch
     (its main path: the numbers the summary line keeps);
  7. the full-width rung: regions that skip or escalate past the band
     window must equal the host mirror banded_profile_consensus.
The line before the last is a JSON object with every kernel's launches,
error, times and bound (the larger of its integer ops over the card's int32
rate and its bytes over 3.35 TB/s; a profile DP's ops count the cells the
data needs, its bytes every lane of the rows written); the last line is the
run's device
record.  Any failure raises and exits non-zero without those two lines.
Without a CUDA card it exits 2.  JAX, the JAX package, bench and
__graft_entry__ are blocked from import: the port must not need them.
"""

from __future__ import annotations

import sys

for _name in ("jax", "jaxlib", "tidehunter_tpu", "bench", "__graft_entry__"):
    sys.modules[_name] = None    # any import of these now fails loudly

import argparse  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

TOL = 0   # every kernel output is an integer, compared exactly
# Shapes the default path gives each kernel (synthetic R2C2 workload):
# aveMatch at (512, 512) (a slice launch carries ~4100 problems), oversize
# partition windows with t_left, boundary extensions at (512, 256) and
# (512, 640) (a slice launch carries 1-11 problems; B=1024 for the issue
# rate), MSA regions at T=640 on every band rung and full width, and at
# B=1 and 8 on the slice's rung; then the largest buckets, which
# long-period reads reach: wavefront rows past a 512 target and the 4096
# MSA bucket banded and at full width.
# wf_global's routes by target bucket T: one column tile of 32 x 4 (T <=
# 128), 32 x 8 (T <= 256) or 32 x 16 (T <= 512) columns; wider targets in
# tiles of 512 with the edge column in shared memory (T=1024, LQ=256) or
# in a global scratch (6144, 8192).  wf_ext's lanes a thread by target
# bucket and launch size (ops/wavefront.EXT_LANES): 1 at B <= the SM
# count and 2 above it up to T=1024, 4 at 4096, 16 at 8192.
# profile_dp's: the warp kernel on the W=128/256/512 rungs of T=640 and
# on the 4096 bucket's W=128; the strips at full width (a warp a region at
# T=128 with the short-period path's ~700 regions a launch; 2 columns a
# lane over one CTA at T=256 and over clusters from T=640) and on the 4096
# bucket's W=512; the first version on its W=256.
# profile_bt has one kernel for every rung: whole band rows or 128-lane
# windows a tile.
WF_CASES = [("iden_only", 2048, 512, 512), ("iden_only", 4096, 512, 512),
            ("iden_only", 256, 128, 128), ("tleft", 256, 256, 200),
            ("tleft", 512, 256, 1024),
            ("ext", 1, 512, 640), ("ext", 4, 512, 640), ("ext", 11, 512, 640),
            ("ext", 1024, 512, 640), ("ext", 1, 512, 256),
            ("ext", 4, 512, 256), ("ext", 11, 512, 256),
            ("ext", 1024, 512, 256),
            ("iden_only", 8, 6144, 6144), ("tleft", 8, 8192, 8192),
            ("ext", 8, 512, 4096), ("ext", 8, 4096, 8192)]
MSA_CASES = [(640, 128, 512, 450), (640, 128, 8, 450), (640, 128, 1, 450),
             (640, 256, 128, 450), (640, 512, 64, 450),
             (640, None, 64, 450), (128, None, 704, 60),
             (256, None, 64, 200), (2048, None, 8, 1500),
             (4096, 128, 64, 3000), (4096, 256, 64, 3000),
             (4096, 512, 8, 3000), (4096, None, 2, 3000)]
WARP_RUNGS = (128, 256, 512)    # profile_dp_warp's rungs below T=4096
# the check whose numbers stand for each kernel in the summary line: the
# largest launch shape of the slice (for wf_ext the route of its launches
# of more than one problem an SM, which hold most of its slice time; for
# myers_hw the largest launch of its main path, phase 6's first run)
MAIN_SHAPES = {"wf_global": "iden_only (512,512) B=4096",
               "wf_ext": "ext (512,640) B=1024",
               "profile_dp": "T=640 W=128 B=512",
               "profile_dp_full": "T=128 W=full B=704",
               "profile_bt": "T=640 W=128 B=512",
               "myers_hw": "largest launch of -5 -3 -f 2"}
# wf_ext's lanes a thread timed at the slice's extension shapes, beside
# the choice of ops/wavefront.ext_lanes
EXT_LANES_SWEEP = ((512, 640), (512, 256))
LANES = (1, 2, 4)
# the probe's comparison shapes: its defaults and an odd tile
PROBE_CASES = [(512, 128), (200, 7)]
SLICE_READS = 1024
SLICE_KERNELS = ("wf_global", "wf_ext", "profile_dp", "profile_bt")
# kernel names in a trace -> the kernel (profile_dp has three)
TRACE_NAMES = {"wf_global_kernel": "wf_global", "wf_ext_kernel": "wf_ext",
               "profile_dp_warp": "profile_dp_warp",
               "profile_dp_strip": "profile_dp_strip",
               "profile_dp_kernel": "profile_dp_first",
               "profile_bt_warp": "profile_bt"}
# phase 5: (name, reads, unit length, copies) of each population
PERIOD_POPULATIONS = (("short", 512, 60, 60), ("amplicon", 256, 1500, 6),
                      ("cdna", 128, 3000, 4))
PERIOD_ORACLE_READS = 8      # reads of each population held to the oracle
# the reference's shipped adapters: the 84 bp 5' adapter (sense strand)
# and the 25 bp 3' adapter (anti-sense strand)
FIVE = ("AATGATACGGCGACCACCGAGATCTACACTCGACTAGTCGTCGGCAGCGTCAGATGTGTATAA"
        "GAGACAGTGAATTCTGGTGGG")
THREE = "AAGCAGTGGTATCAACGCAGAGTAC"
ADAPTER_READS = 1024         # phase 6's adapter population
SC_QLENS = (32, 64, 65, 128)  # single-copy search shapes of phase 2
OPTION_ORACLE_READS = 8      # reads of each option run held to the oracle

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
# int32 results per clock per SM: 64 on the INT pipe (CUDA C++ Programming
# Guide's throughput table, cc 9.0) plus 64 IMAD on the FMA pipe, which
# nvcc uses for adds and moves; at 64 alone wf_dtype_probe measured faster
# than its bound
INT32_PER_CLK_PER_SM = 128
# Integer ops per DP cell (per backtrack step for profile_bt), counted in
# each kernel's source in csrc/ for each variant; the probe's count is in
# its module.
OPS_PER_CELL = {"wf_global iden_only": 51, "wf_global tleft": 70,
                "wf_ext": 49, "profile_dp banded": 88,
                "profile_dp full": 76, "profile_bt": 73}
# myers_hw: int32 operations a target column and 64-bit query word (a
# 64-bit operation counts two), and a column, counted in
# csrc/myers_hw.cu's myers_step and its loop; both passes
MYERS_OPS_PER_COL_WORD = 55
MYERS_OPS_PER_COL = 20


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120, check=True)
    return res.stdout.strip().splitlines()[0]


class Card:
    """The card's int32 rate (INT32_PER_CLK_PER_SM x SMs x the maximum SM
    clock) and the least time for a piece of work."""

    def __init__(self):
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        self.int_rate = INT32_PER_CLK_PER_SM * self.sms * self.clock_mhz * 1e6

    def bound(self, ops: float, nbytes: float):
        t_ops, t_bytes = ops / self.int_rate, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn over reps runs (CUDA events).  The runs queue
    behind a device sleep of ~10 ms, so that a kernel shorter than its
    wrapper's host time is timed back to back, not at the host's rate."""
    return timed(fn, reps)[0]


def timed(fn, reps: int = 1):
    """(mean device ms over reps runs of fn, the last run's result), the
    runs queued behind a device sleep as in cuda_ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def max_err(a, b) -> int:
    """Largest absolute difference over paired integer tensors."""
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


class Checks:
    """Kernel-vs-plain comparisons, one printed line each."""

    def __init__(self, card: Card, only=None):
        self.card = card
        self.only = only          # kernels to check (None: all)
        self.rows = {}

    def wants(self, kernel) -> bool:
        return self.only is None or kernel in self.only

    def run(self, kernel, label, kern_fn, plain_fn, work, select=None,
            reps=5, first_fn=None):
        """Compare, then time and bound (work() -> (integer ops, bytes));
        with first_fn, the first version too (equal, timed beside); the
        main-path shape's numbers go to the summary."""
        if not self.wants(kernel):
            return
        sel = select or (lambda x: x)
        plain_ms, want = timed(plain_fn)
        got, want = sel(kern_fn()), sel(want)
        err = max_err(got, want)
        if first_fn is not None:
            err = max(err, max_err(sel(first_fn()), want))
        if err > TOL:
            raise AssertionError(f"{kernel} {label}: max_abs_err {err}")
        ms = cuda_ms(kern_fn, reps)
        first_ms = cuda_ms(first_fn, reps) if first_fn else None
        self.record(kernel, label, err, ms, plain_ms, *work(),
                    main=label == MAIN_SHAPES[kernel], first_ms=first_ms)

    def record(self, kernel, label, err, ms, plain_ms, ops, nbytes, main,
               first_ms=None):
        bound_ms, by = self.card.bound(ops, nbytes)
        first = (f" first_version_ms={first_ms:.4f} ({first_ms / ms:.2f}x)"
                 if first_ms else "")
        print(f"check {kernel} {label}: max_abs_err={err} ms={ms:.4f}"
              f"{first} plain_ms={plain_ms:.2f} bound_ms={bound_ms:.4f} "
              f"({by}: {ops:.0f} int ops, {nbytes:.0f} bytes) share of "
              f"bound {bound_ms / ms:.4f}", flush=True)
        row = self.rows.setdefault(kernel, {"max_abs_err": 0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if main:
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=by)
            if first_ms:
                row["first_version_ms"] = first_ms


def _mutate(rng, u, err):
    keep = rng.random(len(u)) >= err / 3
    u = np.where(rng.random(len(u)) < err / 3, rng.integers(0, 4, len(u)),
                 u)[keep]
    ins = rng.random(len(u)) < err / 3
    out = np.empty(len(u) + int(ins.sum()), np.uint8)
    pos = np.arange(len(u)) + np.cumsum(ins)
    out[pos] = u
    mask = np.ones(len(out), bool)
    mask[pos] = False
    out[mask] = rng.integers(0, 4, int(mask.sum()))
    return out


def pair_batch(rng, B, LQ, LT, dev):
    """B related (q, t) pairs with lengths in the upper quarter of the
    bucket, as the aveMatch and extension requests of the default path."""
    q = np.full((B, LQ), 4, np.uint8)
    t = np.full((B, LT), 4, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        base = rng.integers(0, 4, max(LQ, LT)).astype(np.uint8)
        qs = _mutate(rng, base, 0.1)[: int(rng.integers(LQ * 3 // 4, LQ + 1))]
        ts = _mutate(rng, base, 0.1)[: int(rng.integers(LT * 3 // 4, LT + 1))]
        q[b, :len(qs)], t[b, :len(ts)] = qs, ts
        qlen[b], tlen[b] = len(qs), len(ts)
    return tuple(torch.as_tensor(a, device=dev) for a in (q, qlen, t, tlen))


def sweep_lanes(checks, label, q, ql, t, tl, sc):
    """wf_ext at each of LANES target lanes a thread: equal to the default
    route's outputs, with its time."""
    from tidehunter_tpu_torch.ops import wavefront as WF

    B, LT = t.shape
    chosen = WF.ext_lanes(LT, B, checks.card.sms)
    want = WF.ext_batch(q, ql, t, tl, sc)
    for L in LANES:
        run = lambda L=L: WF.ext_batch(q, ql, t, tl, sc, lanes=L)  # noqa: E731
        err = max_err(run(), want)
        if err > TOL:
            raise AssertionError(f"wf_ext {label} L={L}: max_abs_err {err}")
        mark = " (ext_lanes' choice)" if L == chosen else ""
        print(f"lanes wf_ext {label} L={L}: ms={cuda_ms(run, 5):.4f}{mark}",
              flush=True)


def dp_cells(qlen, ncol, W) -> float:
    """Cells a profile DP batch needs: (j, c) in [1, qlen] x [1, ncol],
    banded |c - j| <= W - 8 (a cell of row r = j + c - 2 at lane c - 1)."""
    if W is None:
        return float((qlen.double() * ncol.double()).sum())
    j = torch.arange(1, int(qlen.max()) + 1, device=qlen.device)[None, :]
    lo = (j - (W - 8)).clamp(min=1)
    hi = torch.minimum(j + (W - 8), ncol[:, None])
    n = (hi - lo + 1).clamp(min=0) * (j <= qlen[:, None])
    return float(n.double().sum())


def phase_kernels(checks, dev, lanes=True):
    """Every check of WF_CASES and MSA_CASES; with lanes, wf_ext's lanes a
    thread timed at EXT_LANES_SWEEP."""
    from tidehunter_tpu_torch.ops import msa_device as MD
    from tidehunter_tpu_torch.ops import wavefront as WF

    rng = np.random.default_rng(7)
    sc = WF.DEFAULT_SCORES
    for kind, B, LQ, LT in WF_CASES:
        q, ql, t, tl = pair_batch(rng, B, LQ, LT, dev)
        label = f"{kind} ({LQ},{LT}) B={B}"
        # live cells: a problem runs qlen + tlen - 1 rows of live lanes
        cells = float((ql.double() * tl.double()).sum())
        if kind == "ext":
            def plain(q=q, ql=ql, t=t, tl=tl):
                besth, bestr, score = WF.ext_plain(q, ql, t, tl, sc)
                return (*WF.ext_tie_order(besth, bestr, ql, tl), score)

            # writes max, max_t, max_q and score [B], int32
            checks.run("wf_ext", label,
                       lambda: WF.ext_batch(q, ql, t, tl, sc), plain,
                       lambda: (OPS_PER_CELL["wf_ext"] * cells,
                                _nbytes(q, ql, t, tl) + 4 * B * 4))
            if (lanes and checks.wants("wf_ext")
                    and (LQ, LT) in EXT_LANES_SWEEP):
                sweep_lanes(checks, label, q, ql, t, tl, sc)
            continue
        iden_only = kind == "iden_only"
        # t_left requests (oversize partition windows) span qle 0..qlen+1
        qle = (torch.zeros_like(ql) if iden_only else
               (torch.rand(B, device=dev) * (ql + 2).float()).int())
        checks.run("wf_global", label,
                   lambda: WF.global_batch(q, ql, t, tl, qle, sc, iden_only),
                   lambda: WF.global_plain(q, ql, t, tl, qle, sc,
                                           not iden_only),
                   lambda: (OPS_PER_CELL[f"wf_global {kind}"] * cells,
                            _nbytes(q, ql, t, tl, qle) + 2 * B * 4))

    # one unit round of a region batch: the second unit against the
    # profile of the first
    msa = MD.DeviceMSA(2, 4, 4, 2, gap_open2=24, gap_ext2=1, device=dev)
    for T, W, B, L in MSA_CASES:
        units = np.full((B, 2, T), 4, np.uint8)
        ulen = np.zeros((B, 2), np.int32)
        for b in range(B):
            base = rng.integers(0, 4, L).astype(np.uint8)
            for k in range(2):
                u = _mutate(rng, base, 0.1)[:T]
                units[b, k, :len(u)] = u
                ulen[b, k] = len(u)
        units_d = torch.as_tensor(units, device=dev)
        ulen_d = torch.as_tensor(ulen, device=dev)
        st = msa.init_state(units_d, ulen_d)
        sub, wdel, wl, wdel2, wl2 = msa.scores_step(st)
        unit, qlen = units_d[:, 1].contiguous(), ulen_d[:, 1].contiguous()
        args = (unit, qlen, st.ncol, sub, wl, wdel, wl2, wdel2, msa.costs, W)
        rows = torch.arange(2 * T - 1, device=dev)[:, None]
        live = rows < (qlen + st.ncol - 1)[None, :]      # [2T-1, B]
        label = f"T={T} W={W or 'full'} B={B}"
        # the work is the cells the data needs; a region writes one
        # direction byte per lane of its qlen + ncol - 1 rows, dead lanes 0
        dp_ops = (OPS_PER_CELL["profile_dp " + ("banded" if W else "full")]
                  * dp_cells(qlen, st.ncol, W))
        dp_bytes = (_nbytes(unit, qlen, st.ncol, sub, wl, wdel, wl2, wdel2)
                    + float(live.sum()) * (W or T))
        # K3 (full width) and K4 (banded) are one entry point; every shape
        # off the warp kernel's rungs is timed against the first version
        off_rungs = W is None or T >= 4096 or W not in WARP_RUNGS
        checks.run("profile_dp_full" if W is None else "profile_dp", label,
                   lambda: MD.profile_dp(*args),
                   lambda: MD.profile_dp_plain(*args),
                   lambda: (dp_ops, dp_bytes),
                   select=lambda d: (d[live],),
                   first_fn=(lambda: MD.profile_dp(*args, first_version=True))
                   if off_rungs else None)
        dirs = MD.profile_dp(*args)
        bt = MD.profile_bt(dirs, qlen, st.ncol, T, W)
        steps = float(bt[1].double().sum())   # path length, a byte a step
        checks.run("profile_bt", label,
                   lambda: MD.profile_bt(dirs, qlen, st.ncol, T, W),
                   lambda: MD.profile_bt_plain(dirs, qlen, st.ncol, T, W),
                   lambda: (OPS_PER_CELL["profile_bt"] * steps,
                            steps + _nbytes(qlen, st.ncol, *bt)))
    if checks.wants("myers_hw"):
        check_myers(checks, dev, rng)


def revcomp(s: str) -> str:
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def myers_cases(rng):
    """(label, [(query, target, k)]): the adapter path's searches (the
    four adapter orientations in 1024 doubled consensus of an 84 + 450 +
    25 bp unit, k = 20% of the adapter) and the single-copy path's (4
    queries of SC_QLENS bp in 512 reads of ~5 kb, each holding a noisy
    copy of every query)."""
    from tidehunter_tpu_torch.io.codec import decode
    from tidehunter_tpu_torch.ops.myers_device import encode5

    adapters = [FIVE, revcomp(THREE), revcomp(FIVE), THREE]
    codes = [encode5(a) for a in adapters]
    cons = []
    for _ in range(1024):
        unit = np.concatenate([codes[0], rng.integers(0, 4, 450).astype(
            np.uint8), codes[1]])
        unit = np.roll(_mutate(rng, unit, 0.02), int(rng.integers(0, 559)))
        cons.append(decode(np.concatenate([unit, unit])))
    main = [(a, t, int(len(a) * 0.2)) for t in cons for a in adapters]
    queries = [rng.integers(0, 4, n).astype(np.uint8) for n in SC_QLENS]
    reads = []
    for _ in range(512):
        read = [rng.integers(0, 4, 1000).astype(np.uint8)]
        for q in queries:
            read += [_mutate(rng, q, 0.1),
                     rng.integers(0, 4, 1000).astype(np.uint8)]
        reads.append(decode(np.concatenate(read)))
    sc = [(decode(q), t, int(len(q) * 0.2)) for t in reads for q in queries]
    return [("adapters in doubled consensus B=4096", main),
            (f"single-copy qlen {'/'.join(map(str, SC_QLENS))} in ~5 kb "
             f"reads B=2048", sc)]


def check_myers(checks, dev, rng):
    """myers_hw at phase 2's shapes, packed as hw_batch packs them."""
    from tidehunter_tpu_torch.ops.myers_device import pack

    for label, trips in myers_cases(rng):
        seq, meta, rows = pack(*zip(*trips))
        assert len(rows) == len(trips)
        myers_check(checks, label, torch.as_tensor(seq, device=dev),
                    torch.as_tensor(meta, device=dev), int(meta[1].max()))


def myers_check(checks, label, seq, meta, qmax):
    """myers_hw against hw_batch_plain on the card, exact.  The bound
    counts the work this run's data needs: for each search, ceil(qlen /
    64) words over every target column (HW pass) and end + 1 columns
    (SHW pass) when it is within k."""
    from tidehunter_tpu_torch.ops import myers_device as MY

    def work():
        ed, _, end = MY.myers_hw(seq, meta, qmax).double()
        words = torch.ceil(meta[1].double() / 64)
        cols = meta[3].double() + torch.where(ed >= 0, end + 1, 0)
        ops = float((cols * (MYERS_OPS_PER_COL_WORD * words
                             + MYERS_OPS_PER_COL)).sum())
        return ops, _nbytes(seq, meta) + 3 * 4 * meta.shape[1]

    checks.run("myers_hw", label, lambda: (MY.myers_hw(seq, meta, qmax),),
               lambda: (MY.hw_batch_plain(seq, meta),), work, reps=20)


def phase_probe(checks, dev) -> int:
    """wf_dtype_probe against probe_plain (chains of 8 calls, exact), then
    the probe's timing table at its defaults: the run whose launches
    count."""
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch.evals import wf_dtype_probe as P

    worst = 0
    for T, BT in PROBE_CASES:
        for name in P.VARIANTS:
            tb = P.tile(name, T, BT, dev)
            err = max_err(P.chain(tb, name),
                          P.chain(tb, name, P.probe_plain))
            if err > TOL:
                raise AssertionError(
                    f"wf_dtype_probe {name} T={T} BT={BT}: max_abs_err {err}")
            worst = max(worst, err)
            print(f"check wf_dtype_probe {name} T={T} BT={BT}: chain of "
                  f"{P.CHAIN} max_abs_err={err}", flush=True)
    T, BT = PROBE_CASES[0]
    plain_ms = {}
    for name, (dt, iota_dt) in P.VARIANTS.items():
        tb = P.tile(name, T, BT, dev)
        plain_ms[name] = cuda_ms(lambda: P.probe_plain(tb, dt, iota_dt), 1)

    K.reset_launches()
    ms = P.time_variants(T, BT)
    launches = K.WF_DTYPE_PROBE.launches
    for line in P.report(T, BT, ms):
        print(f"probe T={T} BT={BT}: {line}", flush=True)
    # every variant runs the same source ops a cell; tb is read and out
    # written once, at the state type's width
    ops = P.OPS_PER_CELL * BT * T * P.n_rows(T)
    for name, (dt, _) in P.VARIANTS.items():
        bound_ms, by = checks.card.bound(ops, 2 * BT * T * dt.itemsize)
        print(f"probe variant {name} T={T} BT={BT}: ms={ms[name]:.4f} "
              f"plain_ms={plain_ms[name]:.2f} bound_ms={bound_ms:.4f} "
              f"({by}) share of bound {bound_ms / ms[name]:.4f}",
              flush=True)
    checks.record("wf_dtype_probe", f"int32 T={T} BT={BT}", worst,
                  ms["int32"], plain_ms["int32"], ops, 2 * BT * T * 4,
                  main=True)
    checks.rows["wf_dtype_probe"]["variants_ms"] = ms
    return launches


def fuzz_reads(rng, n):
    """Fuzz-style reads: random periods, copy numbers and error rates."""
    from tidehunter_tpu_torch.evals.synth import synth_read
    from tidehunter_tpu_torch.io.fastx import FastxRecord

    out = []
    for i in range(n):
        L = int(rng.integers(30, 600))
        copies = int(rng.integers(2, 9))
        err = float(rng.choice([0.0, 0.05, 0.15]))
        out.append(FastxRecord(name=f"fuzz_{i}", comment="",
                               seq=synth_read(rng, L, copies, err,
                                              int(rng.integers(0, 200)))))
    return out


def serialize(reads, results, mtp):
    from tidehunter_tpu_torch.io.output import write_read_output

    buf = io.StringIO()
    for rec, res in zip(reads, results):
        write_read_output(buf, rec.name, rec.seq, res, mtp)
    return buf.getvalue()


def _oracle_one(task) -> str:
    """(read, params, graph MSA) -> the read's records by tidehunter_core,
    serialized; graph sets the host oracle's graph-POA switch (TH_MSA), as
    the CLI's --msa graph does for its run."""
    from tidehunter_tpu_torch.pipeline.core import tidehunter_core

    rec, mtp, graph = task
    if graph:
        os.environ["TH_MSA"] = "graph"
    else:
        os.environ.pop("TH_MSA", None)
    return serialize([rec], [tidehunter_core(rec.seq, mtp)], mtp)


def oracle_records(tasks):
    """The records of each (read, params, graph MSA) task by the host
    oracle, computed over a pool of host processes (one core left to this
    one); the pool is shut down before returning."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    n = max(1, min(len(tasks), (os.cpu_count() or 2) - 1))
    with ProcessPoolExecutor(n, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        return list(pool.map(_oracle_one, tasks))


def records_by_read(text: str, fmt: int = 1) -> dict:
    """Records grouped by read name: FASTA (fmt 1, the default), FASTQ (3)
    or one tabular line each (2, 4)."""
    out = {}
    lines = text.splitlines(keepends=True)
    if fmt in (2, 4):
        for line in lines:
            name = line.split("\t", 1)[0]
            out[name] = out.get(name, "") + line
        return out
    step = 4 if fmt == 3 else 2
    for i in range(0, len(lines), step):
        name = lines[i][1:].split("_rep", 1)[0]
        out[name] = out.get(name, "") + "".join(lines[i:i + step])
    return out


def phase_slice(tmp, dev):
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch.engine import Engine
    from tidehunter_tpu_torch.evals.synth import synth_read
    from tidehunter_tpu_torch.io.fastx import FastxRecord
    from tidehunter_tpu_torch.params import Params
    from tidehunter_tpu_torch.pipeline import runner
    from tidehunter_tpu_torch.pipeline.core import tidehunter_core
    from tidehunter_tpu_torch.utils.metrics import METRICS

    n_reads = SLICE_READS
    rng = np.random.default_rng(42)
    reads = [FastxRecord(name=f"r2c2_{i}", comment="", seq=synth_read(rng))
             for i in range(n_reads)]
    fa = os.path.join(tmp, "r2c2.fa")
    with open(fa, "w") as f:
        f.writelines(f">{r.name}\n{r.seq}\n" for r in reads)
    mtp = Params()
    mtp.chunk_read_n = 512
    engine = Engine(mtp, device=dev.type)
    t0 = time.perf_counter()
    runner.run(fa, mtp, out=io.StringIO(), process_chunk=engine)
    sync(dev)
    warm_s = time.perf_counter() - t0

    METRICS.reset()
    K.reset_launches()
    sink = io.StringIO()
    t0 = time.perf_counter()
    metrics = runner.run(fa, mtp, out=sink, process_chunk=engine)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in K.launches().items() if k in SLICE_KERNELS}
    snap = METRICS.snapshot()
    print(f"slice: {n_reads} reads in {wall:.3f} s = "
          f"{n_reads / wall:.2f} reads/s (warm run {warm_s:.3f} s); "
          f"consensus records {metrics.cons_records}; "
          f"launches {json.dumps(launches)} over {metrics.chunks} chunks; "
          f"regions past the largest bucket (host rule) "
          f"{int(snap.get('msa_host_oversize', 0))}", flush=True)
    print("slice stages: " + " ".join(
        f"{k}={v}" for k, v in sorted(snap.items())), flush=True)
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by the slice: {idle}")
    trace_run(lambda: runner.run(fa, mtp, out=io.StringIO(),
                                 process_chunk=engine), dev, "slice")
    if metrics.reads != n_reads or metrics.cons_records < n_reads // 2:
        raise AssertionError(f"slice produced {metrics.cons_records} records"
                             f" for {metrics.reads} reads")

    check = reads[:32] + fuzz_reads(np.random.default_rng(2024), 12)
    t0 = time.perf_counter()
    want = [tidehunter_core(r.seq, mtp) for r in check]
    oracle_s = time.perf_counter() - t0
    got = engine(check, mtp)
    bad = [r.name for r, a, b in zip(check, got, want)
           if serialize([r], [a], mtp) != serialize([r], [b], mtp)]
    if bad:
        raise AssertionError(f"records differ from the oracle: {bad}")
    if not sink.getvalue().startswith(serialize(reads[:32], want[:32], mtp)):
        raise AssertionError("slice output differs from the oracle")
    n_rec = sum(len(w.records) for w in want)
    print(f"slice oracle: {len(check)} reads ({n_rec} records) "
          f"byte-identical with tidehunter_core ({oracle_s:.1f} s host)",
          flush=True)
    return launches


def trace_run(run, dev, label):
    """run() once more under torch.profiler: device ms and launches of
    every kernel by name and of each kernel of TRACE_NAMES, and the device
    busy share (the union of kernel and copy intervals over the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name, glob_ms = [], {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        name = ev.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")
        if "wf_global_kernel" in name:
            glob_ms.append((ev.time_range.start,
                            (spans[-1][1] - spans[-1][0]) / 1e3))
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (spans[-1][1] - spans[-1][0]) / 1e3, n + 1)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    per_kernel = {k: [0.0, 0] for k in TRACE_NAMES.values()}
    for name, (ms, n) in sorted(by_name.items(), key=lambda x: -x[1][0]):
        print(f"{label} trace: {name}: {ms:.3f} ms in {n} launches",
              flush=True)
        key = next((v for k, v in TRACE_NAMES.items() if k in name), None)
        if key:
            per_kernel[key][0] += ms
            per_kernel[key][1] += n
    busy_ms = busy_us / 1e3
    print(f"{label} trace summary: " + json.dumps({
        "wall_ms": round(wall_ms, 3), "device_busy_ms": round(busy_ms, 3),
        "device_busy_share": round(busy_ms / wall_ms, 5),
        "device_ms_all": round(sum(ms for ms, _ in by_name.values()), 3),
        "kernels": {k: {"device_ms": round(ms, 3), "launches": n}
                    for k, (ms, n) in per_kernel.items()}}), flush=True)
    return [ms for _, ms in sorted(glob_ms)]


class LaunchShapes:
    """Records the (T, W, B) of every profile_dp call of the device MSA
    and the (LQ, LT, B) of every wf_global call of the engine while active
    (the calls themselves are unchanged)."""

    def __init__(self):
        from tidehunter_tpu_torch.ops import msa_device as MD
        from tidehunter_tpu_torch.ops import wavefront as WF

        self.md, self.wf, self.calls, self.glob = MD, WF, [], []
        self.orig, self.orig_g = MD.profile_dp, WF.global_batch

    def __enter__(self):
        def rec(unit, *args, **kw):
            W = kw.get("W", args[8] if len(args) > 8 else None)
            self.calls.append((args[2].shape[2], W, unit.shape[0]))
            return self.orig(unit, *args, **kw)

        def rec_g(q, ql, t, *args, **kw):
            self.glob.append((q.shape[1], t.shape[1], q.shape[0]))
            return self.orig_g(q, ql, t, *args, **kw)

        self.md.profile_dp, self.wf.global_batch = rec, rec_g
        return self

    def __exit__(self, *exc):
        self.md.profile_dp, self.wf.global_batch = self.orig, self.orig_g

    def summary(self) -> str:
        by = {}
        for T, W, B in self.calls:
            n, lo, hi = by.get((T, W), (0, B, B))
            by[(T, W)] = (n + 1, min(lo, B), max(hi, B))
        return "; ".join(f"T={T} W={W or 'full'}: {n} launches, B "
                         f"{lo}-{hi}" for (T, W), (n, lo, hi) in
                         sorted(by.items(), key=lambda x: (x[0][0],
                                                           x[0][1] or 0)))


def phase_periods(tmp, dev):
    """Short and long periods end to end (PERIOD_POPULATIONS): reads/s,
    stage timers and launches of the timed run, the profile_dp shapes it
    launched, the timed run once more under torch.profiler, and the timed
    run's records of the first PERIOD_ORACLE_READS reads of each
    population against tidehunter_core.  Returns the launches of the timed
    run, K3's as its full-width rounds."""
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch.engine import Engine
    from tidehunter_tpu_torch.evals.synth import synth_read
    from tidehunter_tpu_torch.io.fastx import FastxRecord
    from tidehunter_tpu_torch.params import Params
    from tidehunter_tpu_torch.pipeline import runner
    from tidehunter_tpu_torch.utils.metrics import METRICS

    rng = np.random.default_rng(43)
    pops = []
    for name, n, unit_len, copies in PERIOD_POPULATIONS:
        pops.append([FastxRecord(name=f"{name}_{i}", comment="",
                                 seq=synth_read(rng, unit_len, copies))
                     for i in range(n)])
    reads = [r for pop in pops for r in pop]
    fa = os.path.join(tmp, "periods.fa")
    with open(fa, "w") as f:
        f.writelines(f">{r.name}\n{r.seq}\n" for r in reads)
    mtp = Params()
    mtp.chunk_read_n = 512
    engine = Engine(mtp, device=dev.type)
    t0 = time.perf_counter()
    runner.run(fa, mtp, out=io.StringIO(), process_chunk=engine)
    sync(dev)
    warm_s = time.perf_counter() - t0

    METRICS.reset()
    K.reset_launches()
    sink = io.StringIO()
    with LaunchShapes() as shapes:
        t0 = time.perf_counter()
        metrics = runner.run(fa, mtp, out=sink, process_chunk=engine)
        sync(dev)
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in K.launches().items() if k in SLICE_KERNELS}
    snap = METRICS.snapshot()
    full = int(snap.get("msa_full_rounds", 0))
    mix = ", ".join(f"{n} of {u} bp x {c}"
                    for _, n, u, c in PERIOD_POPULATIONS)
    print(f"periods: {len(reads)} reads ({mix}) in {wall:.3f} s = "
          f"{len(reads) / wall:.2f} reads/s (warm run {warm_s:.3f} s); "
          f"consensus records {metrics.cons_records}; "
          f"launches {json.dumps(launches)}; msa_full_rounds {full}; "
          f"regions past the largest bucket (host rule) "
          f"{int(snap.get('msa_host_oversize', 0))}", flush=True)
    print("periods stages: " + " ".join(
        f"{k}={v}" for k, v in sorted(snap.items())), flush=True)
    print(f"periods profile_dp launches: {shapes.summary()}", flush=True)
    if full <= 0:
        raise AssertionError("the periods path ran no full-width round")
    if not any(T == 4096 for T, _, _ in shapes.calls):
        raise AssertionError("the periods path did not reach the 4096 "
                             "bucket")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by the periods path: "
                             f"{idle}")
    if metrics.reads != len(reads) or metrics.cons_records < len(reads) // 2:
        raise AssertionError(f"periods produced {metrics.cons_records} "
                             f"records for {metrics.reads} reads")
    # wf_global's launches in the traced run, in order, beside their shapes
    with LaunchShapes() as traced:
        glob_ms = trace_run(lambda: runner.run(fa, mtp, out=io.StringIO(),
                                               process_chunk=engine), dev,
                            "periods")
    if len(glob_ms) == len(traced.glob):
        print("periods trace wf_global launches: " + "; ".join(
            f"({lq},{lt}) B={b} {ms:.3f} ms"
            for (lq, lt, b), ms in zip(traced.glob, glob_ms)), flush=True)

    got = records_by_read(sink.getvalue())
    check = [r for pop in pops for r in pop[:PERIOD_ORACLE_READS]]
    t0 = time.perf_counter()
    want = oracle_records([(r, mtp, False) for r in check])
    oracle_s = time.perf_counter() - t0
    bad = [r.name for r, w in zip(check, want) if got.get(r.name, "") != w]
    if bad:
        raise AssertionError(f"periods records differ from the oracle: "
                             f"{bad}")
    for name, *_ in PERIOD_POPULATIONS:
        recs = [w for r, w in zip(check, want)
                if r.name.startswith(name + "_")]
        print(f"periods oracle {name}: the timed run's records of its first "
              f"{len(recs)} reads ({sum(w.count('>') for w in recs)} "
              f"records) byte-identical with tidehunter_core", flush=True)
    print(f"periods oracle: {len(check)} reads in {oracle_s:.1f} s over a "
          f"pool of host processes", flush=True)
    return {**launches, "profile_dp_full": full}


# phase 6: (label, population, CLI arguments) of each option run
OPTION_RUNS = (("-5 -3 -f 2", "adapters", ["-f", "2"]),
               ("-5 -3 -F", "adapters", ["-F"]),
               ("-5 -3 -s -F", "adapters", ["-s", "-F"]),
               ("--polish 1", "slice", ["--polish", "1"]),
               ("--msa graph", "slice", ["--msa", "graph"]))


def adapter_reads(rng, n):
    """R2C2 reads with adapters: each unit the 5' adapter, a 450 bp insert
    and the reverse complement of the 3' adapter, 9 copies at 10% error
    (every fourth read a single copy) between random 150 bp flanks."""
    from tidehunter_tpu_torch.io.codec import decode
    from tidehunter_tpu_torch.io.fastx import FastxRecord
    from tidehunter_tpu_torch.ops.myers_device import encode5

    five, three_rc = encode5(FIVE), encode5(revcomp(THREE))
    out = []
    for i in range(n):
        unit = np.concatenate([five, rng.integers(0, 4, 450).astype(
            np.uint8), three_rc])
        parts = [rng.integers(0, 4, 150).astype(np.uint8)]
        parts += [_mutate(rng, unit, 0.1) for _ in range(1 if i % 4 == 3
                                                          else 9)]
        parts.append(rng.integers(0, 4, 150).astype(np.uint8))
        out.append(FastxRecord(name=f"ada_{i}", comment="",
                               seq=decode(np.concatenate(parts))))
    return out


class MyersLaunches:
    """Records the problem count of every myers_hw launch of hw_batch
    while active, and the inputs of the largest (the calls themselves are
    unchanged)."""

    def __init__(self):
        from tidehunter_tpu_torch.ops import myers_device as MY

        self.my, self.orig = MY, MY.myers_hw
        self.sizes, self.largest = [], None

    def __enter__(self):
        def rec(seq, meta, qmax):
            self.sizes.append(meta.shape[1])
            if self.largest is None or \
                    meta.shape[1] > self.largest[1].shape[1]:
                self.largest = (seq, meta, qmax)
            return self.orig(seq, meta, qmax)

        self.my.myers_hw = rec
        return self

    def __exit__(self, *exc):
        self.my.myers_hw = self.orig


def check_trace(path, label):
    """The --profile trace at path parses as a Chrome trace and holds the
    card's kernels."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            key = next((v for k, v in TRACE_NAMES.items()
                        if k in ev["name"]), "other")
            kernels[key] = kernels.get(key, 0) + 1
    print(f"options {label} --profile: {os.path.getsize(path)} bytes, "
          f"{len(events)} events; kernel events {json.dumps(kernels)}",
          flush=True)
    if not kernels:
        raise AssertionError(f"options {label}: the --profile trace holds "
                             f"no kernel event")


def phase_options(tmp, dev):
    """Each OPTION_RUNS run through the port's CLI on the card: reads/s,
    stage timers (--metrics), launches and hws_host; the adapter runs
    must launch myers_hw, --polish 1 the profile kernels, --msa graph no
    profile DP (its MSA is the host graph-POA), and its --profile trace
    must hold the card's kernels; the records of the first
    OPTION_ORACLE_READS reads of each run must equal tidehunter_core's.
    Returns myers_hw's launches in the first run (its main path) and the
    inputs of that run's largest launch."""
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch import cli
    from tidehunter_tpu_torch.evals.synth import synth_read
    from tidehunter_tpu_torch.io.fastx import FastxRecord
    from tidehunter_tpu_torch.pipeline.runner import load_adapters

    rng = np.random.default_rng(42)
    pops = {"adapters": adapter_reads(np.random.default_rng(44),
                                      ADAPTER_READS),
            "slice": [FastxRecord(name=f"r2c2_{i}", comment="",
                                  seq=synth_read(rng))
                      for i in range(SLICE_READS)]}
    files = {}
    for key, reads in pops.items():
        files[key] = os.path.join(tmp, f"options_{key}.fa")
        with open(files[key], "w") as f:
            f.writelines(f">{r.name}\n{r.seq}\n" for r in reads)
    ada = []
    for name, seq in (("5p", FIVE), ("3p", THREE)):
        ada += ["-5" if name == "5p" else "-3", os.path.join(tmp, name)]
        with open(ada[-1], "w") as f:
            f.write(f">{name}\n{seq}\n")
    out, met = os.path.join(tmp, "options.out"), os.path.join(tmp,
                                                              "options.json")
    trace = os.path.join(tmp, "options_trace.json")
    tasks, got, main = [], [], None
    for label, key, args in OPTION_RUNS:
        argv = (ada if key == "adapters" else []) + args
        prof = ["--profile", trace] if "--msa" in args else []
        K.reset_launches()
        with MyersLaunches() as rec:
            rc = cli.main([*argv, *prof, "--device", dev.type, "-o", out,
                           "--metrics", met, files[key]])
            sync(dev)
        launches = {k: v for k, v in K.launches().items() if v}
        if rc != 0:
            raise AssertionError(f"options {label}: exit {rc}")
        with open(met) as f:
            snap = json.load(f)
        print(f"options {label}: {snap['reads']} reads ({key}) in "
              f"{snap['wall_s']} s = {snap['reads_per_s']} reads/s; "
              f"consensus records {snap['cons_records']}; launches "
              f"{json.dumps(launches)}; hws_host "
              f"{int(snap.get('hws_host', 0))}"
              f"{' (under --profile)' if prof else ''}", flush=True)
        print(f"options {label} stages: " + " ".join(
            f"{k}={v}" for k, v in sorted(snap.items())), flush=True)
        if prof:
            check_trace(trace, label)
        if key == "adapters":
            print(f"options {label} myers_hw problems a launch: "
                  f"{rec.sizes}", flush=True)
            if main is None:
                main = (launches.get("myers_hw", 0), rec.largest)
            need = ["myers_hw"]
        else:
            need = ["wf_global", "wf_ext"]
        if "--polish" in args:
            need += ["profile_dp", "profile_bt"]
        idle = [k for k in need if not launches.get(k)]
        if idle:
            raise AssertionError(f"options {label}: not launched: {idle}")
        if "--msa" in args and launches.get("profile_dp"):
            raise AssertionError("options --msa graph ran the profile DP")
        if snap["reads"] != len(pops[key]) or snap["cons_records"] <= 0:
            raise AssertionError(f"options {label}: {snap['cons_records']} "
                                 f"records for {snap['reads']} reads")
        mtp = cli.parse_args([*argv, files[key]])[0]
        load_adapters(mtp)
        with open(out) as f:
            recs = records_by_read(f.read(), mtp.out_fmt)
        for r in pops[key][:OPTION_ORACLE_READS]:
            tasks.append((r, mtp, "--msa" in args))
            got.append((label, r.name, recs.get(r.name, "")))
    t0 = time.perf_counter()
    want = oracle_records(tasks)
    bad = [f"{label}: {name}" for (label, name, g), w in zip(got, want)
           if g != w]
    if bad:
        raise AssertionError(f"options records differ from the oracle: "
                             f"{bad}")
    print(f"options oracle: the first {OPTION_ORACLE_READS} reads of each "
          f"run ({sum(w.count(chr(10)) for w in want)} lines) "
          f"byte-identical with tidehunter_core ("
          f"{time.perf_counter() - t0:.1f} s over a pool of host "
          f"processes)", flush=True)
    return main


def phase_full_width(dev):
    """Band-touch regions of tests/test_msa_device.py:95-107."""
    from tidehunter_tpu_torch.ops.msa_device import DeviceMSA
    from tidehunter_tpu_torch.ops.poa_profile import banded_profile_consensus
    from tidehunter_tpu_torch.utils.metrics import METRICS

    rng = np.random.default_rng(31)
    regions = []
    for i in range(6):
        p = int(rng.integers(900, 1600))
        unit = rng.integers(0, 4, p)
        us = []
        for _ in range(4):
            u = list(np.where(rng.random(p) < 0.08,
                              rng.integers(0, 4, p), unit))
            if i == 0 and len(us) == 1:
                del u[100:420]
            us.append(np.array(u, np.uint8))
        regions.append(us)
    before = METRICS.snapshot().get("msa_full_rounds", 0)
    dm = DeviceMSA(2, 4, 4, 2, gap_open2=24, gap_ext2=1, device=dev)
    got = dm.consensus_batch(regions)
    full = METRICS.snapshot().get("msa_full_rounds", 0) - before
    for ri, (reg, g) in enumerate(zip(regions, got)):
        want = banded_profile_consensus(reg, 2, 4, 4, 2, gap_open2=24,
                                        gap_ext2=1)
        if g is None or not (np.array_equal(g[0], want[0])
                             and np.array_equal(g[1], want[1])):
            raise AssertionError(f"full-width rung: region {ri} differs")
    if full <= 0:
        raise AssertionError("the full-width rung did not run")
    print(f"full-width rung: {len(regions)} regions equal the host mirror; "
          f"{int(full)} full-width rounds", flush=True)


KERNEL_META = {
    "wf_global": ("tidehunter_tpu_torch/csrc/wavefront.cu",
                  "tidehunter_tpu/ops/wavefront.py:154"),
    "wf_ext": ("tidehunter_tpu_torch/csrc/wavefront.cu",
               "tidehunter_tpu/ops/wavefront.py:333"),
    # one entry point serves both profile DP variants: the banded one
    # (launches from the slice) and the full-width one (launches: the
    # periods path's full-width rounds, one launch a round)
    "profile_dp": ("tidehunter_tpu_torch/csrc/profile_dp.cu",
                   "tidehunter_tpu/ops/msa_device.py:256"),
    "profile_dp_full": ("tidehunter_tpu_torch/csrc/profile_dp.cu",
                        "tidehunter_tpu/ops/msa_device.py:87"),
    "profile_bt": ("tidehunter_tpu_torch/csrc/profile_bt.cu",
                   "tidehunter_tpu/ops/msa_device.py:479"),
    "wf_dtype_probe": ("tidehunter_tpu_torch/csrc/wf_dtype_probe.cu",
                       "evals/wf_dtype_probe.py:111"),
    # a lax.scan, not a Pallas kernel: the hand kernel of the adapter path
    "myers_hw": ("tidehunter_tpu_torch/csrc/myers_hw.cu",
                 "tidehunter_tpu/ops/myers_jax.py:51"),
}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", metavar="DIR",
                    help="import tidehunter_tpu_torch from DIR (the root of "
                         "another checkout) instead of this one, to time two "
                         "commits on one card in turns (A, B, B, A); no lanes "
                         "sweep")
    ap.add_argument("--kernels", metavar="NAMES",
                    help="comma-separated kernels: run the build and only "
                         "their checks (phase 2), then stop")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if args.port:
        sys.path.insert(0, os.path.abspath(args.port))
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch import native

    dev = torch.device("cuda")
    print(nvidia_smi("name,power.limit"), flush=True)
    card = Card()
    print(f"int32 rate: {INT32_PER_CLK_PER_SM} x {card.sms} SMs x "
          f"{card.clock_mhz:.0f} MHz (clocks.max.sm) = "
          f"{card.int_rate / 1e12:.3f} Tops/s; bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s", flush=True)
    native.get_lib()
    print(f"native host library: built from tidehunter_tpu_torch/native/ "
          f"in {native.build_seconds:.2f} s and loaded "
          f"({os.path.relpath(native.lib_path)})", flush=True)
    t0 = time.perf_counter()
    K.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {K.build_seconds:.1f} s)", flush=True)
    for line in K.build_log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("ptxas: " + line.strip().removeprefix("ptxas info    : "))

    only = set(args.kernels.split(",")) if args.kernels else None
    checks = Checks(card, only)
    t0 = time.perf_counter()
    phase_kernels(checks, dev, lanes=not args.port)
    print(f"kernels: all equal their plain versions "
          f"({time.perf_counter() - t0:.1f} s; port "
          f"{os.path.dirname(os.path.abspath(K.__file__))})", flush=True)
    if only:
        return 0
    t0 = time.perf_counter()
    launches = {"wf_dtype_probe": phase_probe(checks, dev)}
    print(f"probe: all variants equal probe_plain "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(phase_slice(tmp, dev))
        t0 = time.perf_counter()
        launches["profile_dp_full"] = phase_periods(tmp, dev)[
            "profile_dp_full"]
        print(f"periods phase: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        launches["myers_hw"], largest = phase_options(tmp, dev)
        print(f"options phase: {time.perf_counter() - t0:.1f} s", flush=True)
    seq, meta, qmax = largest
    print(f"myers_hw main-path launch: B={meta.shape[1]}, longest query "
          f"{qmax} bp", flush=True)
    myers_check(checks, MAIN_SHAPES["myers_hw"], seq, meta, qmax)
    phase_full_width(dev)

    rows = []
    for name, (src, repl) in KERNEL_META.items():
        row = checks.rows[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": launches[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     # no single PyTorch call computes an affine-gap DP
                     # wavefront, a profile-POA DP, its backtrack or a
                     # bit-parallel edit-distance search
                     "library_ms": None})
        for extra in ("variants_ms", "first_version_ms"):
            if extra in row:
                rows[-1][extra] = row[extra]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
