"""Stage split of the packed device seeding route
(``ops/offload.device_seed_chain``, the route ``TH_DEVICE_SEED=1`` takes).

Counterpart of the JAX package's ``evals/offload_micro2.py``.  The route's
chunk call is split into its stages, each timed apart:

  * pack (host): ``offload.pack_reads``, a byte a base, [B, L] with B the
    reads and L the longest;
  * upload of the codes and lengths;
  * ``seed_hits`` with packed hits on the resident codes, with the mean
    and most hits of a row;
  * the decode of the packed (end << pos_bits | period) words into the
    ends and periods planes;
  * ``chain_dp`` at windows 512, 2048 and L, with the rows each flags for
    the host chainer (L is the route's own window: the port has no hit cap,
    and the plane's width takes the JAX route's hit_cap = L // 2 window);
  * the asynchronous pull of the three planes (the packed hits, score and
    from) up to the most hits of a served row, as the route pulls them;
  * the route's own assembly of the pulled planes into each read's hits
    and chains (``offload.assemble``: a ``tandem_chain_from_dp`` a read,
    ``tandem_chain_native`` for a row the DP flags), on the host clock.
    The JAX tool does not time it; it stands here because the other
    stages leave most of the route's chunk call unexplained on the card.

The JAX tool also split its seeding dataflow (keys + pack, the sort, the
binary search).  On the card seeding is one kernel, so its time stands once
in their place: ``seed_hits`` alone on CUDA events.

Each stage prints ms and ms a read, [sync] (the host clock closed by a
device synchronise, where the JAX tool forced a 1-element pull), [events]
or [host].  The staged hits and chains (assembled by the route's own
``offload.assemble``) must equal ``device_seed_chain(...,
chain_mode="device")``'s on the same reads, exactly; a difference exits 1.

    python -m tidehunter_tpu_torch.evals.offload_micro2 [N_READS]
        [--device cuda|cpu] [--reps R]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch

from ..io.codec import encode
from ..ops import offload
from ..ops.chaining_device import chain_dp_batch
from ..ops.seeding_device import collect_hits_packed, pos_bits
from ..params import Params
from ..parallel import mesh as PM
from . import _micro
from .synth import synth_read


def slice_bseqs(n: int) -> List[np.ndarray]:
    """n synth_read reads (seed 42), encoded."""
    rng = np.random.default_rng(42)
    return [encode(synth_read(rng)) for _ in range(n)]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_reads", nargs="?", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3,
                    help="runs a stage, the best kept (default 3)")
    _micro.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _micro.get_device(args.device)
    n, reps = args.n_reads, args.reps
    mtp = Params()
    bseqs = slice_bseqs(n)
    L = max(len(b) for b in bseqs)
    pb = pos_bits(L)
    print(f"# offload_micro2 on {_micro.describe(dev)}: n={n} L={L} pb={pb}"
          f" (packed route supported: {offload.supported(mtp.k, L)})",
          flush=True)

    st = _micro.Stages(dev, n, reps)
    arr, lens, has_n = st.tmin("pack a byte a base (host)",
                               lambda: offload.pack_reads(bseqs, n, L),
                               "host")
    arr_t, lens_t = torch.as_tensor(arr), torch.as_tensor(lens)
    codes_d, lens_d = st.tmin(f"upload ({n * L / 1e6:.1f}MB)",
                              lambda: (arr_t.to(dev), lens_t.to(dev)))

    kw = dict(k=mtp.k, use_hpc=bool(mtp.hpc), min_p=mtp.min_p,
              max_p=mtp.max_p, w=mtp.w)

    def seed():
        return collect_hits_packed(codes_d, lens_d, **kw)

    seed()
    ph_d, n_d, fb_d = st.tmin("seed_hits packed (resident)", seed)
    cnt = n_d.cpu().numpy()
    print(f"# hits: mean={cnt.mean():.1f} max={cnt.max()}", flush=True)
    st.report("  seed_hits alone (one kernel: no keys/sort/bsearch split)",
              _micro.events_s(seed, dev, reps=reps), "events")

    pmask = (1 << pb) - 1
    ends_d, per_d = st.tmin("decode packed hits into planes (device)",
                            lambda: (ph_d >> pb, ph_d & pmask))

    outs = {}
    for W in (512, 2048, L):
        def chain(W=W):
            return chain_dp_batch(ends_d, per_d, n_d, k=mtp.k, window=W)

        chain()
        outs[W] = st.tmin(f"chain_dp window={W} (resident)", chain)
        print(f"#   chain fallback rows: {int(outs[W][2].sum())}/{n}",
              flush=True)
    sc_d, fr_d, fbc_d = outs[L]

    # the route's pulls: the flags, then the planes up to the most hits of
    # a served row, each a pinned copy waited on by its own event
    fb_seed, fb_chain = fb_d.cpu().numpy(), fbc_d.cpu().numpy()
    served = (lens > 0) & ~fb_seed
    H = int(cnt[served].max()) if served.any() else 0

    def pull():
        return PM.pull_async([x[:, :H] for x in (ph_d, sc_d, fr_d)])()

    planes = st.tmin(f"pull 3 planes async [{n},{H}] i32", pull)

    got = st.tmin("assemble hits and chains (host)",
                  lambda: offload.assemble(bseqs, mtp, has_n, cnt, fb_seed,
                                           fb_chain, planes, pb), "host")
    want = offload.device_seed_chain(bseqs, mtp, chain_mode="device",
                                     device=dev)
    bad = _micro.seed_chain_mismatches(*got, *want)
    print(f"# staged hits and chains vs device_seed_chain(chain_mode="
          f"'device'): {len(bad)}/{n} reads differ", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
