"""Stage split of a FASTQ run on the card: one warm run, then N timed
runs, each with the steady-state METRICS deltas of every stage.

Counterpart of the JAX package's ``evals/testfq_stages.py``, which ran the
reference's ``test.fq`` (its 100 ONT reads) through the engine.  The
engine is ``make_engine(mtp, device=...)`` with ``chunk_read_n = 100``.
Each rep prints reads/s (the file's own read count over the run's wall
time, host clock closed by a device synchronise: [sync]), every
``time_*`` stage timer's delta, and ``rounds``, ``wf_cells`` /
``wf_cells_disp``, ``msa_batches`` and ``msa_retry_touch`` /
``msa_retry_ovf``.

    python -m tidehunter_tpu_torch.evals.testfq_stages [FASTQ [REPS]]
        [--device cuda|cpu]

FASTQ defaults to ``test.fq`` (the reference's file, as the JAX tool read
it; give its path), REPS to 3.
"""

from __future__ import annotations

import argparse
import io
import sys
import time
from typing import List, Optional

from ..engine import make_engine
from ..io.fastx import read_fastx
from ..params import Params
from ..pipeline import runner
from ..utils.metrics import METRICS
from . import _micro

CHUNK_READS = 100


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fastq", nargs="?", default="test.fq")
    ap.add_argument("reps", nargs="?", type=int, default=3)
    _micro.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _micro.get_device(args.device)
    n_reads = sum(1 for _ in read_fastx(args.fastq))
    mtp = Params()
    mtp.chunk_read_n = CHUNK_READS
    engine = make_engine(mtp, device=args.device)
    print(f"# testfq_stages on {_micro.describe(dev)}: {args.fastq}, "
          f"{n_reads} reads, chunks of {CHUNK_READS}", flush=True)

    def run():
        runner.run(args.fastq, mtp, out=io.StringIO(), process_chunk=engine)
        _micro.sync(dev)

    run()       # warm
    METRICS.reset()
    prev = METRICS.snapshot()
    for rep in range(args.reps):
        t0 = time.perf_counter()
        run()
        dt = time.perf_counter() - t0
        cur = METRICS.snapshot()
        d = {k: cur.get(k, 0.0) - prev.get(k, 0.0) for k in cur}
        prev = cur
        stages = " ".join(f"{k[5:-2]}={d[k]:.4f}s" for k in sorted(d)
                          if k.startswith("time_"))
        print(f"rep{rep}: {n_reads / dt:.2f} reads/s [sync] | {stages}",
              flush=True)
        print(f"   rounds={d.get('rounds', 0):g} "
              f"wf_use={d.get('wf_cells', 0) / 1e6:.1f}M/"
              f"{d.get('wf_cells_disp', 0) / 1e6:.1f}M "
              f"msa_batches={d.get('msa_batches', 0):g} "
              f"retry_t={d.get('msa_retry_touch', 0):g} "
              f"retry_o={d.get('msa_retry_ovf', 0):g}", flush=True)
    engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
