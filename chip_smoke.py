"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its result on its own line:
  1. card and build: the card's name and power limit (nvidia-smi), then
     every kernel of csrc/ built with nvcc for sm_90a;
  2. every kernel against its plain PyTorch version on the card, exact
     integer equality, at the shapes the default path gives it, with both
     times (CUDA events);
  3. the default consensus path end to end: 1024 synthetic R2C2 reads
     (bench.synth_read, seed 42) through pipeline.runner with the port's
     engine on cuda, chunks of 512, one warm run then a timed run; every
     kernel must have launched in the timed run, and the records of 32 of
     those reads plus 12 fuzz-style reads must be byte-identical with the
     host oracle (pipeline.core.tidehunter_core);
  4. the full-width rung: regions that skip or escalate past the band
     window must equal the host mirror banded_profile_consensus.
The line before the last is a JSON object with every kernel's launches,
error and times; the last line is the run's device record.  Any failure
raises and exits non-zero without those two lines.  Without a CUDA card
it exits 2.  JAX is blocked from import: the port must not need it.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

TOL = 0   # every kernel output is an integer, compared exactly
# Shapes the default path gives each kernel (synthetic R2C2 workload):
# aveMatch at (512, 512), oversize partition windows with t_left, boundary
# extensions at (512, 256) and (512, 640), MSA regions at T=640 on every
# band rung and full width; then the largest buckets, which long-period
# reads reach: wavefront rows past shared memory (T > 4096 keeps them in a
# global scratch) and the 4096 MSA bucket banded and at full width.
WF_CASES = [("iden_only", 2048, 512, 512), ("tleft", 512, 256, 1024),
            ("ext", 1024, 512, 256), ("ext", 1024, 512, 640),
            ("iden_only", 8, 6144, 6144), ("tleft", 8, 8192, 8192),
            ("ext", 8, 4096, 8192)]
MSA_CASES = [(640, 128, 512, 450), (640, 256, 128, 450),
             (640, 512, 64, 450), (640, None, 64, 450),
             (4096, 512, 8, 3000), (4096, None, 2, 3000)]
MAIN_SHAPES = {"wf_global": "iden_only (512,512)", "wf_ext": "ext (512,640)",
               "profile_dp": "T=640 W=128", "profile_bt": "T=640 W=128"}
SLICE_READS = 1024


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120, check=True)
    return res.stdout.strip()


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


class Checks:
    """Kernel-vs-plain comparisons, one printed line each."""

    def __init__(self):
        self.rows = {}

    def run(self, kernel, label, kern_fn, plain_fn, select=None, reps=5):
        """Compare, then time; the main-path shape's times go to the
        summary."""
        got, want = kern_fn(), plain_fn()
        if select is not None:
            got, want = select(got), select(want)
        err = max_err(got, want)
        if err > TOL:
            raise AssertionError(f"{kernel} {label}: max_abs_err {err}")
        ms = cuda_ms(kern_fn, reps)
        plain_ms = cuda_ms(plain_fn, 1)
        print(f"check {kernel} {label}: max_abs_err={err} "
              f"ms={ms:.4f} plain_ms={plain_ms:.2f}", flush=True)
        row = self.rows.setdefault(kernel, {"max_abs_err": 0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if label.startswith(MAIN_SHAPES[kernel]):
            row.update(ms=ms, plain_ms=plain_ms)


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
        if kind == "ext":
            def plain(q=q, ql=ql, t=t, tl=tl):
                besth, bestr, score = WF.ext_plain(q, ql, t, tl, sc)
                return (*WF.ext_tie_order(besth, bestr, ql, tl), score)

            checks.run("wf_ext", label,
                       lambda: WF.ext_batch(q, ql, t, tl, sc), plain)
            continue
        iden_only = kind == "iden_only"
        # t_left requests (oversize partition windows) span qle 0..qlen+1
        qle = (torch.zeros_like(ql) if iden_only else
               (torch.rand(B, device=dev) * (ql + 2).float()).int())
        checks.run("wf_global", label,
                   lambda: WF.global_batch(q, ql, t, tl, qle, sc, iden_only),
                   lambda: WF.global_plain(q, ql, t, tl, qle, sc,
                                           not iden_only))

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
        checks.run("profile_dp", label,
                   lambda: MD.profile_dp(*args),
                   lambda: MD.profile_dp_plain(*args),
                   select=lambda d: (d[live],))
        dirs = MD.profile_dp(*args)
        checks.run("profile_bt", label,
                   lambda: MD.profile_bt(dirs, qlen, st.ncol, T, W),
                   lambda: MD.profile_bt_plain(dirs, qlen, st.ncol, T, W))


def fuzz_reads(rng, n):
    """Fuzz-style reads: random periods, copy numbers and error rates."""
    from __graft_entry__ import _tandem_read
    from tidehunter_tpu.io.fastx import FastxRecord

    out = []
    for i in range(n):
        L = int(rng.integers(30, 600))
        copies = int(rng.integers(2, 9))
        err = float(rng.choice([0.0, 0.05, 0.15]))
        out.append(FastxRecord(name=f"fuzz_{i}", comment="",
                               seq=_tandem_read(rng, L, copies, err,
                                                int(rng.integers(0, 200)))))
    return out


def serialize(reads, results, mtp):
    from tidehunter_tpu.io.output import write_read_output

    buf = io.StringIO()
    for rec, res in zip(reads, results):
        write_read_output(buf, rec.name, rec.seq, res, mtp)
    return buf.getvalue()


def phase_slice(tmp, dev):
    from bench import synth_read
    from tidehunter_tpu.io.fastx import FastxRecord
    from tidehunter_tpu.params import Params
    from tidehunter_tpu.pipeline import runner
    from tidehunter_tpu.pipeline.core import tidehunter_core
    from tidehunter_tpu.utils.metrics import METRICS
    from tidehunter_tpu_torch import _kernels as K
    from tidehunter_tpu_torch.engine import Engine

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
    launches = K.launches()
    snap = METRICS.snapshot()
    print(f"slice: {n_reads} reads in {wall:.3f} s = "
          f"{n_reads / wall:.2f} reads/s (warm run {warm_s:.3f} s); "
          f"consensus records {metrics.cons_records}; "
          f"launches {json.dumps(launches)}; regions past the largest "
          f"bucket (host rule) {int(snap.get('msa_host_oversize', 0))}",
          flush=True)
    print("slice stages: " + " ".join(
        f"{k}={v}" for k, v in sorted(snap.items())), flush=True)
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels not launched by the slice: {idle}")
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


def phase_full_width(dev):
    """Band-touch regions of tests/test_msa_device.py:95-107."""
    from tidehunter_tpu.ops.poa_profile import banded_profile_consensus
    from tidehunter_tpu.utils.metrics import METRICS
    from tidehunter_tpu_torch.ops.msa_device import DeviceMSA

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
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.modules["jax"] = None      # the port must run without JAX
    from tidehunter_tpu import native
    from tidehunter_tpu_torch import _kernels as K

    dev = torch.device("cuda")
    print(card_line(), flush=True)
    lib_path = Path(native.__file__).with_name("libchainx.so")
    checked_in = lib_path.read_bytes() if lib_path.exists() else b""
    if native.get_lib() is None:
        raise RuntimeError("native host library did not load")
    print("native host library: " + (
        "checked-in libchainx.so loaded" if lib_path.read_bytes() == checked_in
        else "libchainx.so rebuilt from source and loaded"), flush=True)
    t0 = time.perf_counter()
    K.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {K.build_seconds:.1f} s)", flush=True)
    for line in K.build_log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("ptxas: " + line.strip().removeprefix("ptxas info    : "))

    checks = Checks()
    t0 = time.perf_counter()
    phase_kernels(checks, dev)
    print(f"kernels: all equal their plain versions "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(tmp, dev)
    phase_full_width(dev)

    rows = []
    for name, (src, repl) in KERNEL_META.items():
        row = checks.rows[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": launches[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
