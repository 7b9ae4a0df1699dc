"""Host floor: the port's whole engine pipeline with an INSTANT device.

Counterpart of the JAX package's ``evals/host_floor.py``.  The engine's
aligner and MSA are replaced by stubs that answer every request at once
with plausible values (``InstantAligner``, ``InstantMSA``; the same values
as the JAX tool's), so the measured wall time is the host's own work:
parse, encode, seed, chain, partition walks, the consensus generators and
their drive, the records.  It is the cost a read that no device speedup
can remove: the pipelined runner hides device waits, not host CPU time.

What the floor leaves out, as the JAX floor does: every device round, and
with them the native host alignments that ``BatchAligner.run_global``
resolves below ``host_aln_cap`` (``engine.py``'s ``BatchAligner``): the
stub answers those too.  On the periods path those alignments are most of
consensus, so the floor understates that path's host work.  The engine
resolves MSA through ``self.msa.consensus_batch``, so replacing
``engine.msa`` is enough (the JAX tool also patched its ``_resolve_msa``).
The records are garbage, but byte-identical with the JAX floor's on the
same reads.

    python -m tidehunter_tpu_torch.evals.host_floor [N_READS] [--profile]
        [--device cuda|cpu]

N_READS (default 256) synthetic R2C2 reads (``synth.synth_read``, seed
42), chunks of max(64, N/2), one warm run, then the timed run: host clock
([host]; the stubs put no operation on the device), ms a read, reads/s and
the engine's stage timers a read.  ``--profile`` prints cProfile's top 25
by cumulative time.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

from ..engine import Engine
from ..params import Params
from ..pipeline import runner
from ..utils.metrics import METRICS
from . import _micro
from .synth import synth_read


class InstantAligner:
    """Answers every request at once: global -> identity min(|q|, |t|) and
    t_left at the midpoint, ext -> full spans.  Everything downstream still
    runs (consensus, records, output); only the host cost is measured."""

    use_wavefront = False
    host_aln_cap = 192   # the native walk path reads this off the aligner

    def run_global(self, reqs, scores=None):
        return [(min(len(q), len(t)), max(0, len(t) - max(0, qle)))
                for q, t, qle in reqs]

    def run_giden(self, reqs, scores=None):
        return [min(len(q), len(t)) for q, t in reqs]

    def run_ext(self, reqs, scores=None):
        return [(max(0, len(q) - 1), max(0, min(len(t), 2 * len(q)) - 1))
                for q, t in reqs]

    def run_ops(self, reqs, scores):
        out = []
        for q, t in reqs:
            n = max(len(q), len(t))
            out.append((np.zeros(n, np.int8), n))
        return out


class InstantMSA:
    def consensus_batch(self, regions):
        return [(r[0].copy(), np.full(len(r[0]), len(r), np.int32))
                for r in regions]


def floor_engine(mtp: Params, device: str) -> Engine:
    """The port's engine with the instant aligner and MSA."""
    engine = Engine(mtp, device=device)
    engine.aligner = InstantAligner()
    engine.msa = InstantMSA()
    return engine


def write_reads(path: str, n_reads: int) -> None:
    """N synth_read reads (seed 42) as FASTA, named as the JAX floor names
    them."""
    rng = np.random.default_rng(42)
    with open(path, "w") as f:
        for i in range(n_reads):
            f.write(f">r2c2_{i}\n{synth_read(rng)}\n")


def run_floor(n_reads: int, device: str = "cuda", profile: bool = False):
    """(seconds of the timed run, METRICS snapshot, its output, the
    cProfile or None) of the floor on n_reads reads."""
    mtp = Params()
    mtp.chunk_read_n = max(64, n_reads // 2)
    engine = floor_engine(mtp, device)
    with tempfile.TemporaryDirectory() as tmp:
        fa = os.path.join(tmp, "reads.fa")
        write_reads(fa, n_reads)
        # warm run (imports, first-call set-up)
        runner.run(fa, mtp, out=io.StringIO(), process_chunk=engine)
        METRICS.reset()
        prof = cProfile.Profile() if profile else None
        sink = io.StringIO()
        t0 = time.perf_counter()
        if prof:
            prof.enable()
        runner.run(fa, mtp, out=sink, process_chunk=engine)
        if prof:
            prof.disable()
        dt = time.perf_counter() - t0
    engine.close()
    return dt, METRICS.snapshot(), sink.getvalue(), prof


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=256)
    ap.add_argument("--profile", action="store_true",
                    help="print cProfile's top 25 by cumulative time")
    _micro.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _micro.get_device(args.device)
    n = args.n_reads
    print(f"# host floor on {_micro.describe(dev)}: {n} reads, chunks of "
          f"{max(64, n // 2)}", flush=True)
    dt, snap, _, prof = run_floor(n, args.device, args.profile)
    print(f"host floor: {n} reads in {dt:.4f} s = {1e3 * dt / n:.4f} "
          f"ms/read ({n / dt:.2f} reads/s) [host]", flush=True)
    for k in sorted(snap):
        if k.startswith("time_"):
            print(f"  {k[5:-2]}: {1e3 * snap[k] / n:.4f} ms/read [host]")
    if prof:
        st = pstats.Stats(prof, stream=sys.stdout)
        st.sort_stats("cumulative")
        st.print_stats(25)
    return 0


if __name__ == "__main__":
    sys.exit(main())
