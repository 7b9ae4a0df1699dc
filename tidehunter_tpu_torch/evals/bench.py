"""Full-pipeline reads/s of the port on one card, every record gated.

The port's counterpart of the JAX package's root ``bench.py``, function by
function:

* ``synth_read`` is ``evals/synth.synth_read`` (the same draws from the
  same seed);
* the reads: the slice, 1024 ONT R2C2-style concatemer reads ``r2c2_{i}``
  (~4.3 kb: 9 copies of a 450 bp unit at 10% error between random
  flanks, seed 42, chunks of ``max(64, n // 2)``), bench.py's own
  workload; and the periods path, 896 reads of seed 43 (512 of a 60 bp
  unit x 60, 256 of 1500 bp x 6, 128 of 3000 bp x 4, chunks of 512),
  bench.py's second axis (the reference's ``test.fq``, periods 0.1-3.1
  kb) in a form made from a seed.  ``--fastq PATH`` (default ``test.fq``,
  the reference's 100 ONT reads) keeps that axis itself when the file is
  there, and says on stderr that it was skipped when it is not;
* ``probe_device`` checks for a CUDA card: without one, and without
  ``--device cpu``, the bench exits 2 with one stderr line and prints no
  reads/s;
* ``tpu_smoke`` (the hardware-gated pytest subsets) is not ported: on the
  card that is ``chip_smoke.py``'s phases 2-3, which hold every kernel to
  its plain version;
* ``main``: the engine of ``engine.make_engine``, one warm run a cell,
  then ``BENCH_REPS`` timed runs (default 5; the median needs them), each
  timed on the host clock around ``pipeline.runner.run`` and ending in
  ``torch.cuda.synchronize()``; stage timers reset after the warm run;
  per-rep stage lines and the kernels' Gcell/s on stderr.

Every record is gated, which bench.py was not: the first timed rep's
output is split by read, each read's text (its serialized FASTA records,
the empty string when it has none) is hashed with sha256 and compared with
the host oracle's digest in ``bench_digests.json``, the input FASTA's
sha256 with the file's, and the warm run and the other reps byte for byte
with the first timed rep.  Any difference exits 1 with no numbers line.

Usage:
    python -m tidehunter_tpu_torch.evals.bench [--device cuda|cpu]
        [--cells slice,periods] [--fastq PATH] [--digests PATH]
    BENCH_READS=4 BENCH_REPS=1 python -m tidehunter_tpu_torch.evals.bench \\
        --device cpu --cells slice
    # the host oracle's digests of every read of both cells (~16 min over
    # 7 processes on an 8-core host)
    python -m tidehunter_tpu_torch.evals.bench --write-digests \\
        tidehunter_tpu_torch/evals/bench_digests.json

BENCH_READS takes the first N slice reads (default all 1024), BENCH_CHUNK
sets both cells' chunk size.  The last line of stdout is one JSON object:
bench.py's ``metric``, ``value`` (the slice's best rep), ``unit``,
``vs_baseline`` (over 285.1 reads/s, the reference's own C stages, abPOA's
DP stubbed, on one thread of a CPU host: BASELINE.md), ``vs_t32`` (over 32
times that) and ``median``; ``periods_reads_per_s`` and
``periods_median``; ``reps`` (each rep's reads/s by cell);
``records_checked``; ``device`` and ``power_limit`` (nvidia-smi's, null
on the CPU).  On ``--device cpu`` the kernels' plain versions run, so its
reads/s are no device numbers.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..io.fastx import FastxRecord
from ..params import Params
from .synth import synth_read

DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "bench_digests.json")
DIGEST_COMMAND = ("python -m tidehunter_tpu_torch.evals.bench "
                  "--write-digests tidehunter_tpu_torch/evals/"
                  "bench_digests.json")
DIGEST_FORMAT = ("default (FASTA): sha256 of each read's records by "
                 "pipeline.core.tidehunter_core under Params(), serialized "
                 "by io.output.write_read_output; a read with no records "
                 "has the digest of the empty string")
CELLS = ("slice", "periods")
SLICE_READS = 1024
SLICE_SEED = 42
# the periods path: (name, reads, unit length, copies) of each population
PERIOD_POPULATIONS = (("short", 512, 60, 60), ("amplicon", 256, 1500, 6),
                      ("cdna", 128, 3000, 4))
PERIOD_SEED = 43
PERIOD_CHUNK = 512
DEFAULT_REPS = 5
METRIC = ("reads/s/card, synthetic ONT R2C2 4.3kb (450bp x9, 10% err), "
          "full pipeline, every record gated")
# the reference's own C stages (seeding, chaining, partition, ksw2, edlib;
# abPOA's DP stubbed) on this workload, one thread of a CPU host
# (BASELINE.md "Measured CPU baseline"); vs_t32 is over 32 times that
BASE_READS_PER_S = 285.1
TESTFQ_CHUNK = 100      # bench.py's one chunk of test.fq's 100 reads
TESTFQ_BASE_READS_PER_S = 173.6     # the same C stages on test.fq


def slice_reads(n: int = SLICE_READS):
    """The slice's first n synth_read reads (seed 42)."""
    rng = np.random.default_rng(SLICE_SEED)
    return [FastxRecord(name=f"r2c2_{i}", comment="", seq=synth_read(rng))
            for i in range(n)]


def period_populations():
    """The periods path's populations (seed 43), one list of reads each."""
    rng = np.random.default_rng(PERIOD_SEED)
    return [[FastxRecord(name=f"{name}_{i}", comment="",
                         seq=synth_read(rng, unit_len, copies))
             for i in range(n)]
            for name, n, unit_len, copies in PERIOD_POPULATIONS]


def cell_reads(cell: str):
    """Every read of a cell, in input order."""
    if cell == "slice":
        return slice_reads()
    if cell == "periods":
        return [r for pop in period_populations() for r in pop]
    raise ValueError(f"cell must be one of {CELLS}, got {cell!r}")


def fasta(reads) -> str:
    return "".join(f">{r.name}\n{r.seq}\n" for r in reads)


def sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


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


def load_digests(path: str = DIGESTS) -> dict:
    with open(path) as f:
        return json.load(f)


class GateError(AssertionError):
    """A record, an input or a rep differs from what the gate holds it to."""


def check_input(cell: str, reads, digests: dict) -> None:
    """The cell's whole input FASTA against the file's reads_sha256."""
    want = digests["cells"][cell]["reads_sha256"]
    got = sha256(fasta(reads))
    if got != want:
        raise GateError(f"{cell}: input FASTA sha256 {got} differs from the "
                        f"digest file's {want}")


def check_records(cell: str, reads, text: str, digests: dict) -> int:
    """Every read's records in a run's output text against the oracle's
    digests (the first len(reads) of the cell's, in read order); raises
    on a difference, a read past the file's or a record of no read, else
    returns the number of reads checked."""
    want = digests["cells"][cell]["digests"]
    if len(reads) > len(want):
        raise GateError(f"{cell}: {len(reads)} reads, the digest file holds "
                        f"{len(want)}")
    got = records_by_read(text)
    stray = set(got) - {r.name for r in reads}
    if stray:
        raise GateError(f"{cell}: records of no input read: "
                        f"{sorted(stray)[:8]}")
    bad = [r.name for r, w in zip(reads, want)
           if sha256(got.get(r.name, "")) != w]
    if bad:
        raise GateError(f"{cell}: {len(bad)} reads' records differ from the "
                        f"oracle's digests: {bad[:8]}")
    return len(reads)


def check_reps(cell: str, texts) -> None:
    """The warm run (texts[0]) and every rep byte for byte against the
    first timed rep (texts[1])."""
    for i, text in enumerate(texts):
        if text != texts[1]:
            what = "warm run" if i == 0 else f"rep {i - 1}"
            raise GateError(f"{cell}: the {what}'s output differs from the "
                            f"first timed rep's")


def power_limit(device: str):
    """nvidia-smi's power limit of the first card, None on the CPU."""
    if device != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def stage_lines(label: str, rep_snaps, snap) -> None:
    """bench.py's stage and kernel lines on stderr: the stage timers of
    all reps and of each, then the kernels' Gcell/s."""
    keys = [k for k in sorted(snap) if k.startswith("time_")]
    if keys:
        print(f"# {label} stages (steady, all reps): " + " ".join(
            f"{k[5:-2]}={snap[k]:.2f}s" for k in keys), file=sys.stderr)
        for i, rs in enumerate(rep_snaps):
            print(f"# {label} rep{i}: " + " ".join(
                f"{k[5:-2]}={rs.get(k, 0.0):.2f}s" for k in keys),
                file=sys.stderr)
    wf_t = snap.get("time_dev_global_s", 0) + snap.get("time_dev_ext_s", 0)
    msa_t = snap.get("time_dev_msa_s", 0)
    lines = []
    if wf_t and snap.get("wf_cells"):
        lines.append(f"wavefront {snap['wf_cells'] / wf_t / 1e9:.2f} Gcell/s"
                     f" useful ({snap.get('wf_cells_disp', 0) / wf_t / 1e9:.2f}"
                     f" dispatched)")
    if msa_t and snap.get("msa_cells"):
        lines.append(f"msa {snap['msa_cells'] / msa_t / 1e9:.2f} Gcell/s")
    if snap.get("rounds"):
        lines.append(f"rounds={snap['rounds']:g}")
    if lines:
        print(f"# {label} kernels: " + "; ".join(lines), file=sys.stderr)


def timed_runs(path: str, mtp, engine, reps: int, sync):
    """One warm run, then reps timed runs of the runner over path: (the
    outputs, warm run's first, the reps' walls in s, the reps' stage
    timers, the stage timers of all reps, the reads of a run)."""
    from ..pipeline import runner
    from ..utils.metrics import METRICS

    warm = io.StringIO()
    n_reads = runner.run(path, mtp, out=warm, process_chunk=engine).reads
    sync()
    METRICS.reset()
    texts, dts, rep_snaps = [warm.getvalue()], [], []
    prev = METRICS.snapshot()
    for _ in range(reps):
        sink = io.StringIO()
        t0 = time.perf_counter()
        runner.run(path, mtp, out=sink, process_chunk=engine)
        sync()
        dts.append(time.perf_counter() - t0)
        texts.append(sink.getvalue())
        cur = METRICS.snapshot()
        rep_snaps.append({k: cur.get(k, 0.0) - prev.get(k, 0.0)
                          for k in cur if k.startswith("time_")})
        prev = cur
    return texts, dts, rep_snaps, METRICS.snapshot(), n_reads


def run_cell(cell: str, engine, reps: int, digests: dict, sync, tmp: str,
             n_reads: int, chunk: int):
    """A cell's warm run and timed reps, every record gated: (reads/s of
    each rep, reads checked)."""
    reads = cell_reads(cell)
    check_input(cell, reads, digests)
    reads = reads[:n_reads]
    path = os.path.join(tmp, f"{cell}.fa")
    with open(path, "w") as f:
        f.write(fasta(reads))
    mtp = Params()
    mtp.chunk_read_n = chunk
    texts, dts, rep_snaps, snap, _ = timed_runs(path, mtp, engine, reps,
                                                sync)
    n = check_records(cell, reads, texts[1], digests)
    check_reps(cell, texts)
    rps = [len(reads) / d for d in dts]
    print(f"# {cell}: {len(reads)} reads, chunks of {chunk}; reps "
          + " ".join(f"{x:.1f}" for x in rps) + " reads/s; every read's "
          f"records ({texts[1].count('>')} records) match the oracle's "
          f"digests; warm run and reps byte-identical", file=sys.stderr)
    stage_lines(cell, rep_snaps, snap)
    return rps, n


def run_fastq(path: str, engine, reps: int, sync):
    """bench.py's test.fq axis, ungated (no digests): reads/s of each rep,
    or None when the file is absent."""
    if not os.path.exists(path):
        print(f"# {path}: absent, the test.fq axis skipped", file=sys.stderr)
        return None
    mtp = Params()
    mtp.chunk_read_n = TESTFQ_CHUNK
    _, dts, _, _, n_reads = timed_runs(path, mtp, engine, reps, sync)
    rps = [n_reads / d for d in dts]
    print(f"# {path} reps: {' '.join(f'{x:.1f}' for x in rps)} reads/s "
          f"(C reference 1-thread: {TESTFQ_BASE_READS_PER_S})",
          file=sys.stderr)
    return rps


def median(xs):
    return sorted(xs)[len(xs) // 2]


def _oracle_digest(task):
    from ..pipeline.core import tidehunter_core
    from .accuracy import record_digest

    cell, i, rec = task
    mtp = Params()
    return cell, i, record_digest(rec, tidehunter_core(rec.seq, mtp), mtp)


def write_digests(path: str, cells=CELLS) -> dict:
    """The host oracle's digest of every read of each cell, over a pool of
    spawn processes (the cores less one), longest read first; written to
    path as JSON."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    os.environ.pop("TH_MSA", None)
    reads = {cell: cell_reads(cell) for cell in cells}
    tasks = [(cell, i, r) for cell in cells for i, r in enumerate(reads[cell])]
    order = sorted(tasks, key=lambda t: -len(t[2].seq))
    workers = max(1, (os.cpu_count() or 2) - 1)
    got = {}
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        for k, (cell, i, d) in enumerate(pool.map(_oracle_digest, order)):
            got[(cell, i)] = d
            if (k + 1) % 128 == 0:
                print(f"{k + 1}/{len(order)} reads in "
                      f"{time.perf_counter() - t0:.0f} s", flush=True)
    out = {"cells": {cell: {
        "command": DIGEST_COMMAND, "format": DIGEST_FORMAT,
        "reads": len(reads[cell]),
        "reads_sha256": sha256(fasta(reads[cell])),
        "digests": [got[(cell, i)] for i in range(len(reads[cell]))]}
        for cell in cells}}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"digests of {len(tasks)} reads in {time.perf_counter() - t0:.1f} "
          f"s over {workers} processes -> {path}", flush=True)
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated cells to run (slice, periods)")
    ap.add_argument("--fastq", default="test.fq",
                    help="bench.py's test.fq axis (ungated); skipped when "
                         "the file is absent")
    ap.add_argument("--digests", default=DIGESTS,
                    help="the oracle's digests the records are held to")
    ap.add_argument("--write-digests", metavar="PATH",
                    help="write the host oracle's digests of every read of "
                         "both cells to PATH and exit")
    args = ap.parse_args(argv)
    args.cells = [c for c in args.cells.split(",") if c]
    bad = set(args.cells) - set(CELLS)
    if bad:
        ap.error(f"unknown cells {sorted(bad)}; choose from {CELLS}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.write_digests:
        write_digests(args.write_digests)
        return 0
    import torch

    from ..engine import make_engine

    if args.device == "cuda" and not torch.cuda.is_available():
        # bench.py's probe_device: no card, no numbers
        print("bench: no CUDA device (torch.cuda.is_available() is False); "
              "--device cpu runs the kernels' plain versions",
              file=sys.stderr)
        return 2

    n_reads = int(os.environ.get("BENCH_READS", str(SLICE_READS)))
    chunk = int(os.environ.get("BENCH_CHUNK", "0"))
    reps = max(1, int(os.environ.get("BENCH_REPS", str(DEFAULT_REPS))))
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    digests = load_digests(args.digests)
    engine = make_engine(Params(), args.device)
    rps, checked = {}, 0
    # the runner overlaps a host prepare thread with the device-drive
    # thread: a drive thread woken from a device wait can stall a whole GIL
    # switch interval (default 5 ms) behind the prepare thread
    switch = sys.getswitchinterval()
    sys.setswitchinterval(0.001)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for cell in args.cells:
                n = n_reads if cell == "slice" else None
                c = chunk or (max(64, n_reads // 2) if cell == "slice"
                              else PERIOD_CHUNK)
                rps[cell], k = run_cell(cell, engine, reps, digests, sync,
                                        tmp, n, c)
                checked += k
        fq_rps = run_fastq(args.fastq, engine, reps, sync)
    except GateError as e:
        print(f"bench: gate failed: {e}", file=sys.stderr)
        return 1
    finally:
        sys.setswitchinterval(switch)
        engine.close()

    best = max(rps["slice"]) if "slice" in rps else None
    out = {"metric": METRIC, "value": best, "unit": "reads/s",
           "vs_baseline": best / BASE_READS_PER_S if best else None,
           "vs_t32": best / (32 * BASE_READS_PER_S) if best else None,
           "median": median(rps["slice"]) if "slice" in rps else None,
           "periods_reads_per_s": max(rps["periods"]) if "periods" in rps
           else None,
           "periods_median": median(rps["periods"]) if "periods" in rps
           else None,
           "reps": rps, "records_checked": checked,
           "device": (torch.cuda.get_device_name(0)
                      if args.device == "cuda" else "cpu"),
           "power_limit": power_limit(args.device)}
    if fq_rps:
        out["testfq_reads_per_s"] = max(fq_rps)
        out["testfq_vs_t1"] = max(fq_rps) / TESTFQ_BASE_READS_PER_S
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
