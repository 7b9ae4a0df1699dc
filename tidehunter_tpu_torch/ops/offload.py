"""Device seeding offload: one seed launch (and optionally one chain-DP
launch) per chunk, then the hits and DP planes pulled to the host.

Counterpart of ``tidehunter_tpu/ops/offload.py``.  ``device_seed_chain``
keeps its contract: ``hits_list[i] = (ends, periods)`` int64 arrays;
``chains_list[i] = (dp, chains)``, or None for "the caller runs the host
chainer on hits_list[i]" (the hybrid default, ``chain_mode="host"``).

The host reroutes are the JAX package's, counted under its names:
``offload_seed_fb`` for a row holding an N or a row the seeder flags
(w > 1 outside the minimizer preconditions), both seeded on the host;
``offload_chain_fb`` for a row the chain DP's envelope gate flags,
chained on the host from the device hits.

The TPU-shaped parts of the JAX offload are re-derived for the H100:
reads go up as one byte a base (no quarter-block 4-bases-a-byte layout:
a 512-read chunk of 4.4 kb is ~2.3 MB); the launch takes the chunk's own
batch and longest read (no length ladder or batch multiple of 64: nothing
compiles per shape here; ``len_bucket`` still decides, as in JAX, whether
the packed-word route ``supported`` holds); there is no hit cap
(``hit_cap = L // 2`` and its ``over`` reroute), since the hit plane is
pulled only up to the longest served row's hits; and the chain DP's score
and from planes come back as two int32 planes (no ``score << shift |
delta`` word), its window the plane's width so that no cell is ever
incomplete.  Under a mesh the packed reads are split over its devices in
contiguous row blocks (``parallel/mesh.shard_rows``, the counterpart of
the JAX offload's ``P("dp")`` sharding), each on its device's seeding
stream.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel import mesh as PM
from ..utils.metrics import METRICS
from .chaining_device import chain_dp_batch
from .chaining_native import tandem_chain_from_dp, tandem_chain_native
from .seeding import collect_tandem_repeat_hits
from .seeding_device import collect_hits_packed, packed_ok, pos_bits


def len_bucket(n: int) -> int:
    """The JAX offload's read-length ladder: powers of two from 1024 with
    1.5x midpoints."""
    L = 1024
    while L < n:
        L += L // 2 if (L & (L - 1)) == 0 else L // 3
    return L


def supported(k: int, maxL: int) -> bool:
    """Static gate for the packed-word route (the JAX package's)."""
    return packed_ok(k, len_bucket(maxL))


def pack_reads(bseqs: Sequence[Optional[np.ndarray]], B: int, L: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host packing: [B, L] uint8 codes (a byte a base, 4 past a read),
    lengths and has-N flags.  A None entry (a too-short read) and a read
    holding an N (seeded on the host) go up as empty rows."""
    arr = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    has_n = np.zeros(B, bool)
    for i, bs in enumerate(bseqs):
        if bs is None:
            continue
        if (bs >= 4).any():
            has_n[i] = True
            continue
        arr[i, :len(bs)] = bs
        lens[i] = len(bs)
    return arr, lens, has_n


def device_seed_chain(bseqs: List[Optional[np.ndarray]], mtp,
                      chain_mode: str = "host", device="cuda", mesh=None,
                      streams: Optional[Dict[torch.device, object]] = None):
    """Engine entry: one seed_hits launch (packed hits) and, with
    chain_mode="device", one chain_dp launch a device, then two pulls.
    Returns (hits_list, chains_list).

    mesh: a parallel.mesh.Mesh over which the reads are split in
    contiguous row blocks, the results gathered on its first device; None
    runs one block on `device`.  streams: {device: stream} for each mesh
    device's launches and the pulls (None: the current streams; unused
    on the CPU)."""
    n = len(bseqs)
    mesh = PM.Mesh([device]) if mesh is None else mesh
    if mesh.type != "cuda":
        streams = None
    stream = streams[mesh[0]] if streams else None
    L = max((len(b) for b in bseqs if b is not None), default=1)
    pb = pos_bits(L)
    pmask = (1 << pb) - 1
    with_chain = chain_mode == "device"
    arr, lens, has_n = pack_reads(bseqs, n, L)

    def seed_chain(codes, lens_d):
        ph, n_d, fb_d = collect_hits_packed(
            codes, lens_d, k=mtp.k, use_hpc=bool(mtp.hpc), min_p=mtp.min_p,
            max_p=mtp.max_p, w=mtp.w)
        if not with_chain:
            return ph, n_d, fb_d
        # window = the plane's width: every cell sees the front edge, so
        # only the envelope gate can flag a row
        return (ph, n_d, fb_d, *chain_dp_batch(ph >> pb, ph & pmask, n_d,
                                               k=mtp.k, window=L))

    outs = PM.shard_rows(seed_chain, mesh, torch.as_tensor(arr),
                         torch.as_tensor(lens), streams=streams)
    meta = PM.pull_async([outs[1], outs[2], *outs[5:]], stream)()
    cnt, fb_seed = meta[0], meta[1]
    fb_chain = meta[2] if with_chain else None
    served = (lens > 0) & ~fb_seed
    H = int(cnt[served].max()) if served.any() else 0
    planes = PM.pull_async([x[:, :H] for x in (outs[:1] + outs[3:5])],
                           stream)()
    return assemble(bseqs, mtp, has_n, cnt, fb_seed, fb_chain, planes, pb)


def assemble(bseqs: Sequence[Optional[np.ndarray]], mtp, has_n, cnt,
             fb_seed, fb_chain, planes, pb: int):
    """(hits_list, chains_list) of device_seed_chain from its pulled flags
    and planes (the packed hits, and with fb_chain the DP's score and
    from): a too-short read gets no hits and no chains, a read with an N
    or a seed-flagged row is seeded on the host (its chains None, for the
    host chainer); with fb_chain (chain_mode="device") a chain-flagged row
    is chained by tandem_chain_native, every other one from the DP."""
    n = len(bseqs)
    words = planes[0].astype(np.int64)
    ends, periods = words >> pb, words & ((1 << pb) - 1)
    hits_list: List = [None] * n
    chains_list: List = [None] * n
    for i in range(n):
        if bseqs[i] is None:
            hits_list[i] = (np.zeros(0, np.int64), np.zeros(0, np.int64))
            chains_list[i] = (None, [])
            continue
        if has_n[i] or fb_seed[i]:
            METRICS.add("offload_seed_fb")
            hits_list[i] = collect_tandem_repeat_hits(
                bseqs[i], mtp.k, mtp.w, mtp.hpc, mtp.min_p, mtp.max_p)
            continue        # chains_list[i] = None -> the host chainer
        c = int(cnt[i])
        e, p = ends[i, :c], periods[i, :c]
        hits_list[i] = (e, p)
        if fb_chain is None:
            continue
        if c < 2:
            chains_list[i] = (None, [])
        elif fb_chain[i]:
            METRICS.add("offload_chain_fb")
            chains_list[i] = tandem_chain_native(e, p, mtp.k)
        else:
            chains_list[i] = tandem_chain_from_dp(
                e, p, planes[1][i, :c].astype(np.int64),
                planes[2][i, :c].astype(np.int64), mtp.k)
    return hits_list, chains_list
