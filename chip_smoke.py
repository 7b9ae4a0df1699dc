"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its result on its own line:
  1. card and build: the card's name and power limit (nvidia-smi), the
     port's native host library built with cc from
     tidehunter_tpu_torch/native/, then every kernel of csrc/ built with
     nvcc for sm_90a (one nvcc per source, all started together);
  2. every kernel of the consensus path against its plain PyTorch version
     on the card, exact integer equality, at the shapes the default path
     gives it, with both times (CUDA events);
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
  5. the full-width rung: regions that skip or escalate past the band
     window must equal the host mirror banded_profile_consensus.
The line before the last is a JSON object with every kernel's launches,
error, times and bound (the larger of its integer ops over the card's int32
rate and its bytes over 3.35 TB/s); the last line is the run's device
record.  Any failure raises and exits non-zero without those two lines.
Without a CUDA card it exits 2.  JAX, the JAX package, bench and
__graft_entry__ are blocked from import: the port must not need them.
"""

from __future__ import annotations

import sys

for _name in ("jax", "jaxlib", "tidehunter_tpu", "bench", "__graft_entry__"):
    sys.modules[_name] = None    # any import of these now fails loudly

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
# (512, 640), MSA regions at T=640 on every band rung and full width; then
# the largest buckets, which long-period reads reach: wavefront rows past
# shared memory and the 4096 MSA bucket banded and at full width.
# wf_global's routes by target bucket T: one column tile of 32 x 4 (T <=
# 128), 32 x 8 (T <= 256) or 32 x 16 (T <= 512) columns; wider targets in
# tiles of 512 with the edge column in shared memory (T=1024, LQ=256) or
# in a global scratch (6144, 8192).  profile_dp's: the warp kernel on the
# W=128/256/512 rungs of T=640, the first version at full width and in the
# 4096 bucket.
WF_CASES = [("iden_only", 2048, 512, 512), ("iden_only", 4096, 512, 512),
            ("iden_only", 256, 128, 128), ("tleft", 256, 256, 200),
            ("tleft", 512, 256, 1024),
            ("ext", 1024, 512, 256), ("ext", 1024, 512, 640),
            ("iden_only", 8, 6144, 6144), ("tleft", 8, 8192, 8192),
            ("ext", 8, 4096, 8192)]
MSA_CASES = [(640, 128, 512, 450), (640, 256, 128, 450),
             (640, 512, 64, 450), (640, None, 64, 450),
             (4096, 512, 8, 3000), (4096, None, 2, 3000)]
MAIN_SHAPES = {"wf_global": "iden_only (512,512) B=4096",
               "wf_ext": "ext (512,640)",
               "profile_dp": "T=640 W=128", "profile_bt": "T=640 W=128"}
# the probe's comparison shapes: its defaults and an odd tile
PROBE_CASES = [(512, 128), (200, 7)]
SLICE_READS = 1024
SLICE_KERNELS = ("wf_global", "wf_ext", "profile_dp", "profile_bt")
# kernel names in a trace -> the wrapper that launches them
TRACE_NAMES = {"wf_global_kernel": "wf_global", "wf_ext_kernel": "wf_ext",
               "profile_dp": "profile_dp", "profile_bt": "profile_bt"}

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
    """Mean device time of fn over reps runs (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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

    def __init__(self, card: Card):
        self.card = card
        self.rows = {}

    def run(self, kernel, label, kern_fn, plain_fn, work, select=None,
            reps=5):
        """Compare, then time and bound (work() -> (integer ops, bytes));
        the main-path shape's numbers go to the summary."""
        got, want = kern_fn(), plain_fn()
        if select is not None:
            got, want = select(got), select(want)
        err = max_err(got, want)
        if err > TOL:
            raise AssertionError(f"{kernel} {label}: max_abs_err {err}")
        ms = cuda_ms(kern_fn, reps)
        plain_ms = cuda_ms(plain_fn, 1)
        self.record(kernel, label, err, ms, plain_ms, *work(),
                    main=label.startswith(MAIN_SHAPES[kernel]))

    def record(self, kernel, label, err, ms, plain_ms, ops, nbytes, main):
        bound_ms, by = self.card.bound(ops, nbytes)
        print(f"check {kernel} {label}: max_abs_err={err} ms={ms:.4f} "
              f"plain_ms={plain_ms:.2f} bound_ms={bound_ms:.4f} ({by}: "
              f"{ops:.0f} int ops, {nbytes:.0f} bytes) share of bound "
              f"{bound_ms / ms:.4f}", flush=True)
        row = self.rows.setdefault(kernel, {"max_abs_err": 0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if main:
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=by)


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


def phase_kernels(checks, dev):
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

            # writes besth, bestr [B, T] and score [B], int32
            checks.run("wf_ext", label,
                       lambda: WF.ext_batch(q, ql, t, tl, sc), plain,
                       lambda: (OPS_PER_CELL["wf_ext"] * cells,
                                _nbytes(q, ql, t, tl) + (2 * LT + 1) * B * 4))
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
        # a region runs qlen + ncol - 1 rows of W (or T) lanes and writes
        # one direction byte per lane of those rows
        dp_cells = float(live.sum()) * (W or T)
        dp_ops = OPS_PER_CELL["profile_dp " + ("banded" if W else "full")]
        inputs = (unit, qlen, st.ncol, sub, wl, wdel, wl2, wdel2)
        checks.run("profile_dp", label,
                   lambda: MD.profile_dp(*args),
                   lambda: MD.profile_dp_plain(*args),
                   lambda: (dp_ops * dp_cells,
                            _nbytes(*inputs) + dp_cells),
                   select=lambda d: (d[live],))
        dirs = MD.profile_dp(*args)
        bt = MD.profile_bt(dirs, qlen, st.ncol, T, W)
        steps = float(bt[1].double().sum())   # path length, a byte a step
        checks.run("profile_bt", label,
                   lambda: MD.profile_bt(dirs, qlen, st.ncol, T, W),
                   lambda: MD.profile_bt_plain(dirs, qlen, st.ncol, T, W),
                   lambda: (OPS_PER_CELL["profile_bt"] * steps,
                            steps + _nbytes(qlen, st.ncol, *bt)))


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
    trace_slice(lambda: runner.run(fa, mtp, out=io.StringIO(),
                                   process_chunk=engine), dev)
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


def trace_slice(run, dev):
    """run() once more under torch.profiler: device ms and launches of
    every kernel by name and of each slice kernel, and the device busy
    share (the union of kernel and copy intervals over the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        name = ev.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (spans[-1][1] - spans[-1][0]) / 1e3, n + 1)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    per_kernel = {k: [0.0, 0] for k in SLICE_KERNELS}
    for name, (ms, n) in sorted(by_name.items(), key=lambda x: -x[1][0]):
        print(f"slice trace: {name}: {ms:.3f} ms in {n} launches",
              flush=True)
        key = next((v for k, v in TRACE_NAMES.items() if k in name), None)
        if key:
            per_kernel[key][0] += ms
            per_kernel[key][1] += n
    busy_ms = busy_us / 1e3
    print("slice trace summary: " + json.dumps({
        "wall_ms": round(wall_ms, 3), "device_busy_ms": round(busy_ms, 3),
        "device_busy_share": round(busy_ms / wall_ms, 5),
        "device_ms_all": round(sum(ms for ms, _ in by_name.values()), 3),
        "kernels": {k: {"device_ms": round(ms, 3), "launches": n}
                    for k, (ms, n) in per_kernel.items()}}), flush=True)


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
    # one kernel serves both profile DP variants; the banded one (:256) is
    # the first rung of every region, the full one is at :87
    "profile_dp": ("tidehunter_tpu_torch/csrc/profile_dp.cu",
                   "tidehunter_tpu/ops/msa_device.py:256"),
    "profile_bt": ("tidehunter_tpu_torch/csrc/profile_bt.cu",
                   "tidehunter_tpu/ops/msa_device.py:479"),
    "wf_dtype_probe": ("tidehunter_tpu_torch/csrc/wf_dtype_probe.cu",
                       "evals/wf_dtype_probe.py:111"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
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

    checks = Checks(card)
    t0 = time.perf_counter()
    phase_kernels(checks, dev)
    print(f"kernels: all equal their plain versions "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    launches = {"wf_dtype_probe": phase_probe(checks, dev)}
    print(f"probe: all variants equal probe_plain "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(phase_slice(tmp, dev))
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
                     # wavefront, a profile-POA DP or its backtrack
                     "library_ms": None})
        if "variants_ms" in row:
            rows[-1]["variants_ms"] = row["variants_ms"]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
