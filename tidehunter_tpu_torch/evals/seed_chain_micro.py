"""Stage split of the v1 device seeding route (``Engine._device_seed``
under ``TH_OFFLOAD_V1=1 TH_DEVICE_CHAIN=1``).

Counterpart of the JAX package's ``evals/seed_chain_micro.py``.  The
route's chunk call is split into its stages, each timed apart:

  1. encode + pad (host): ``seeding_device.pad_batch``, [B, L] with B the
     reads and L the longest (the port pads to neither 64 rows nor a
     power of two);
  2. upload of the codes and lengths;
  3. ``seed_hits`` on the resident codes (``collect_hits_batch``);
  4. the hits pulls: the full [B, L] int32 ends and periods, and [B, Lh]
     truncated to int16 (the JAX tool pulls both);
  5. ``chain_dp`` at the engine's window Lh (``engine.v1_chain_window``:
     512 doubled up to the most hits of a row, at most L), forced;
  6. the score and from pulls, [B, Lh] as int32 and as int16;
  7. the copy probes: a 16 MB int32 pull and a 16 MB uint8 push (the JAX
     tool's probe is 16 MB too, though it prints "64MB").

Each stage prints ms and ms a read: [sync] (the host clock closed by a
device synchronise, where the JAX tool forced a 1-element pull) or
[host]; a pull is timed from a tensor already computed, and every pull
copies anew (PyTorch keeps no host copy of a tensor).  The staged hits and
chains (assembled by the engine's own ``engine.v1_assemble``) must equal
what ``Engine._device_seed`` returns for the same reads, exactly; a
difference exits 1.

    python -m tidehunter_tpu_torch.evals.seed_chain_micro [N_READS]
        [--device cuda|cpu] [--reps R]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from ..engine import Engine, v1_assemble, v1_chain_window
from ..io.codec import encode
from ..io.fastx import FastxRecord
from ..ops.chaining_device import chain_dp_batch
from ..ops.seeding_device import collect_hits_batch, pad_batch
from ..params import Params
from . import _micro
from .synth import synth_read

V1_ENV = {"TH_DEVICE_SEED": "1", "TH_DEVICE_CHAIN": "1", "TH_OFFLOAD_V1": "1"}
PROBE_BYTES = 16 << 20


def engine_result(reads, mtp, device: str):
    """Engine._device_seed on the v1 route with device chaining."""
    saved = {k: os.environ.get(k) for k in V1_ENV}
    os.environ.update(V1_ENV)
    try:
        engine = Engine(mtp, device=device)
        out = engine._device_seed(reads, mtp)
        engine.close()
        return out
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
    rng = np.random.default_rng(42)
    reads = [FastxRecord(name=f"r2c2_{i}", comment="", seq=synth_read(rng))
             for i in range(n)]
    print(f"# seed_chain_micro on {_micro.describe(dev)}: n={n}",
          flush=True)

    st = _micro.Stages(dev, n, reps)

    # 1. encode + pad, as the engine's v1 route does
    def encode_pad():
        encoded = [encode(r.seq) for r in reads]
        return (encoded, *pad_batch(encoded))

    encoded, batch, lens = st.tmin("encode+pad (host)", encode_pad, "host")
    B, L = batch.shape
    maxL = int(lens.max())
    print(f"# B={B} L={L} maxL={maxL}", flush=True)

    # 2. upload
    batch_t, lens_t = torch.as_tensor(batch), torch.as_tensor(lens)
    dbatch, dlens = st.tmin(
        f"upload codes [{B},{L}] u8 ({B * L / 1e6:.1f}MB)",
        lambda: (batch_t.to(dev), lens_t.to(dev)))

    # 3. seed_hits on the resident codes
    kw = dict(k=mtp.k, use_hpc=bool(mtp.hpc), min_p=mtp.min_p,
              max_p=mtp.max_p, w=mtp.w)
    collect_hits_batch(dbatch, dlens, **kw)
    ends_d, periods_d, cnt_d, fb_d = st.tmin(
        "seed_hits (resident)", lambda: collect_hits_batch(dbatch, dlens,
                                                           **kw))
    cnt, fb = cnt_d.cpu().numpy(), fb_d.cpu().numpy()
    print(f"# hits: mean={cnt.mean():.1f} max={cnt.max()} seed fallback "
          f"rows {int(fb.sum())}", flush=True)
    H, max_hits, Lh, oversize = v1_chain_window(cnt, fb, L)

    # 4. the hits pulls, each from a computed tensor
    def pull(*xs) -> float:
        return _micro.tmin(lambda: [x.cpu() for x in xs], dev, reps)[0]

    st.report(f"pull hits full [{B},{L}] i32 x2", pull(ends_d, periods_d))
    e16, p16 = (x[:, :Lh].to(torch.int16) for x in (ends_d, periods_d))
    st.report(f"pull hits [{B},{Lh}] i16 x2", pull(e16, p16))

    # 5. chain_dp at the engine's window
    rows = (ends_d[:, :Lh].contiguous(), periods_d[:, :Lh].contiguous(),
            cnt_d.clamp(max=Lh))
    score_d, from_d, fbc_d = st.tmin(
        f"chain_dp window={Lh} (forced)",
        lambda: chain_dp_batch(*rows, k=mtp.k, window=Lh))
    print(f"#   chain fallback rows: {int(fbc_d.sum())}/{n}", flush=True)

    # 6. the score and from pulls
    st.report(f"pull score+from [{B},{Lh}] i32 x2", pull(score_d, from_d))
    s16, f16 = (x.to(torch.int16) for x in (score_d, from_d))
    st.report(f"pull score+from [{B},{Lh}] i16 x2", pull(s16, f16))

    # 7. the copy probes
    probe = torch.zeros(PROBE_BYTES // 4, dtype=torch.int32, device=dev) + 1
    dt = pull(probe)
    print(f"# pull bw: {PROBE_BYTES / 1e6 / dt:.1f} MB/s (16MB int32) "
          f"[{_micro.clock(dev, 'sync')}]", flush=True)
    up = torch.zeros(PROBE_BYTES, dtype=torch.uint8)
    dt = _micro.tmin(lambda: up.to(dev), dev, 1)[0]
    print(f"# push bw: {PROBE_BYTES / 1e6 / dt:.1f} MB/s (16MB uint8) "
          f"[{_micro.clock(dev, 'sync')}]", flush=True)

    # the staged result against the engine's own call
    ends, periods = (x[:, :H].cpu().numpy() for x in (ends_d, periods_d))
    score, from_idx = (x[:, :max_hits].cpu().numpy()
                       for x in (score_d, from_d))
    got = v1_assemble(encoded, mtp, cnt, fb, ends, periods,
                      (score, from_idx, fbc_d.cpu().numpy() | oversize))
    want = engine_result(reads, mtp, args.device)
    bad = _micro.seed_chain_mismatches(*got, *want)
    print(f"# staged hits and chains vs Engine._device_seed (v1 route): "
          f"{len(bad)}/{n} reads differ", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
