"""The packed device seeding route against the host's seed and chain.

Counterpart of the JAX package's ``evals/offload_micro.py``.  On N
synthetic R2C2 reads it times the host route (``seeding_native`` +
``chaining_native``, a read at a time; best of 2) and the packed device
route ``ops/offload.device_seed_chain(bseqs, mtp, chain_mode="device",
device=...)`` (best of 3, after a warm call), with the METRICS counters of
the best device run, then compares every read's chains with the host's.
Times are [sync]: the host clock, closed by the route's own pulls; on
``--device cpu`` the route runs the kernels' plain versions.

The JAX tool also took a chain window; the port's route chains at the
plane's width (``offload.py``), so there is none to pass.  A row the
route leaves to the host chainer (chains None: a seed fallback) is
chained from the route's hits, as the engine does.  Any read whose chains
differ from the host's exits 1.

    python -m tidehunter_tpu_torch.evals.offload_micro [N_READS]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from ..ops import offload
from ..ops.chaining_native import tandem_chain_native
from ..ops.seeding_native import collect_tandem_repeat_hits
from ..params import Params
from ..utils.metrics import METRICS
from . import _micro
from .offload_micro2 import slice_bseqs


def host_path(bseqs, mtp):
    out = []
    for b in bseqs:
        e, p = collect_tandem_repeat_hits(b, mtp.k, mtp.w, mtp.hpc,
                                          mtp.min_p, mtp.max_p)
        out.append(tandem_chain_native(e, p, mtp.k))
    return out


def chain_mismatches(host_chains, hits, chains, mtp) -> int:
    """Reads whose device-route chains differ from the host's (cells of
    every chain, in order)."""
    mismatch = 0
    for i, (_, hch) in enumerate(host_chains):
        entry = chains[i]
        if entry is None:
            entry = tandem_chain_native(*hits[i], mtp.k)
        gch = entry[1]
        if len(hch) != len(gch) or any(
                not np.array_equal(a.cells, b.cells)
                for a, b in zip(hch, gch)):
            mismatch += 1
    return mismatch


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=512)
    _micro.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _micro.get_device(args.device)
    n = args.n_reads
    mtp = Params()
    bseqs = slice_bseqs(n)
    print(f"# offload_micro on {_micro.describe(dev)}: n={n}", flush=True)

    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        host_chains = host_path(bseqs, mtp)
        best = min(best, time.perf_counter() - t0)
    print(_micro.stage_line("host seed+chain", best, n, "host"), flush=True)

    def dev_path():
        return offload.device_seed_chain(bseqs, mtp, chain_mode="device",
                                         device=dev)

    dev_path()      # warm
    best, snap = float("inf"), {}
    for _ in range(3):
        METRICS.reset()
        _micro.sync(dev)
        t0 = time.perf_counter()
        hits, chains = dev_path()
        dt = time.perf_counter() - t0
        if dt < best:
            best, snap = dt, METRICS.snapshot()
            got = (hits, chains)
    print(_micro.stage_line("device route (seed_hits + chain_dp)", best, n,
                            "sync"), flush=True)
    print(f"#   counters: {snap}", flush=True)
    mismatch = chain_mismatches(host_chains, *got, mtp)
    print(f"# chain mismatches vs host: {mismatch}/{n}", flush=True)
    return 1 if mismatch else 0


if __name__ == "__main__":
    sys.exit(main())
