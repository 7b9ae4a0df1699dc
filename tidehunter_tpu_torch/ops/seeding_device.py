"""Device seeding: batched k-mer keys and tandem self-hits on PyTorch
tensors.

Counterpart of ``tidehunter_tpu/ops/seeding_jax.py``.  Both seeders return
what the JAX functions return, bit for bit, for every row:

  * ``collect_hits_batch``: hits as (ends, periods) [B, L] int32 in
    (end, period) order with INT32_MAX past ``n_hits``, ``n_hits`` [B]
    int32 and the ``fallback`` flags [B] bool;
  * ``collect_hits_packed`` (needs ``packed_ok(k, L)``): the hits as one
    plane of (end << pos_bits(L) | period) words, 0xFFFFFFFF past
    ``n_hits``, held in int32 (the same 32 bits), then ``n_hits`` and
    ``fallback``.

``fallback`` is the JAX package's rule for minimizer seeding (w > 1): any
N, fewer than w seeds, or with HPC a k-mer spanning >= 255 read bases.  A
flagged row's hits are unconstrained; the caller reroutes it through the
exact host seeder.

On a CUDA tensor each seeder is one launch of the hand-written kernel
``csrc/seed_hits.cu: seed_hits`` (a stable radix sort by key and a search
from each lane's rank; a read's arrays in one CTA's shared memory, a
thread-block cluster's, or past both a global scratch); on a CPU
tensor it runs ``seed_plain``, the same function as torch ops: the front
half of the JAX module (``_hpc_compact``, ``_keys_valid_positions``),
then a sort of 64-bit (key, position) words and a ``searchsorted`` for the
nearest earlier occurrence at least ``min_p`` back.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels as K

INT32_MAX = 2**31 - 1
UINT32_MAX = 0xFFFFFFFF
INT64_MAX = 2**63 - 1


def pos_bits(L: int) -> int:
    """Bits needed for a read position in [0, L)."""
    return max(1, int(L - 1).bit_length())


def packed_ok(k: int, L: int) -> bool:
    """The single-uint32-key seeding path fits iff key (2k bits) + pos
    (pos_bits) stay strictly below the 0xFFFFFFFF sentinel, and a hit
    (end, period) pair packs the same way."""
    pb = pos_bits(L)
    return (2 * k + pb <= 31) and (2 * pb <= 31)


def threads_for(L: int) -> int:
    """seed_hits' threads a CTA: a thread per 32 lanes of the next power
    of two, 128-1024 (256 at the slice's ~4.4 kb reads: three CTAs of
    ~71 KB of shared memory an SM)."""
    n = 1 << max(0, int(L - 1).bit_length())
    return min(1024, max(128, n // 32))


def _check(bseq: torch.Tensor, length: torch.Tensor, k: int, w: int):
    if bseq.dtype != torch.uint8 or bseq.dim() != 2:
        raise TypeError("bseq must be [B, L] uint8")
    if length.dim() != 1 or length.shape[0] != bseq.shape[0]:
        raise ValueError("length must be [B]")
    if bseq.device != length.device:
        raise ValueError("bseq and length lie on different devices")
    if not 1 <= k <= 16 or w < 1:
        raise ValueError(f"need 1 <= k <= 16 and w >= 1, got k={k} w={w}")
    if bseq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bseq.device}")


def _launch(bseq, length, k, use_hpc, min_p, max_p, w, packed):
    """One seed_hits launch over [B, L]."""
    B, L = bseq.shape
    dev = bseq.device
    wide = not packed_ok(k, L)
    ends = torch.empty((B, L), dtype=torch.int32, device=dev)
    periods = None if packed else torch.empty_like(ends)
    n_hits = torch.empty(B, dtype=torch.int32, device=dev)
    fb = torch.empty(B, dtype=torch.bool, device=dev)
    if B and L:
        # the route is chosen for, and the launch made on, the data's card
        with torch.cuda.device(dev):
            nbytes = K.host_call("seed_hits_scratch_bytes",
                                 [ctypes.c_int] * 5, ctypes.c_longlong,
                                 B, L, int(use_hpc), w, int(wide))
            if nbytes < 0:
                raise RuntimeError("seed_hits_scratch_bytes: the card's "
                                   "shared memory could not be queried")
            scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
                       if nbytes else None)
            K.SEED_HITS(bseq.contiguous().data_ptr(),
                        length.int().contiguous().data_ptr(), B, L, k, w,
                        int(use_hpc), min_p, max_p, int(wide), pos_bits(L),
                        int(packed), threads_for(L),
                        None if scratch is None else scratch.data_ptr(),
                        ends.data_ptr(),
                        None if periods is None else periods.data_ptr(),
                        n_hits.data_ptr(), fb.data_ptr())
    else:
        n_hits.zero_()
        fb.fill_(w > 1)
    return ends, periods, n_hits, fb


def collect_hits_batch(bseq: torch.Tensor, length: torch.Tensor, *, k: int,
                       use_hpc: bool, min_p: int, max_p: int, w: int = 1):
    """Batched collect_tandem_repeat_hit (reference tandem_hit.c:227-237).

    bseq: [B, L] uint8 encoded reads (0..3 bases, 4 = N; pad with 4);
    length: [B] read lengths.  Returns (ends [B, L] int32, periods [B, L]
    int32, n_hits [B] int32, fallback [B] bool)."""
    _check(bseq, length, k, w)
    if bseq.device.type == "cpu":
        return seed_plain(bseq, length, k=k, use_hpc=use_hpc, min_p=min_p,
                          max_p=max_p, w=w)
    return _launch(bseq, length, k, use_hpc, min_p, max_p, w, False)


def collect_hits_packed(bseq: torch.Tensor, length: torch.Tensor, *, k: int,
                        use_hpc: bool, min_p: int, max_p: int, w: int = 1):
    """Packed-hit variant of collect_hits_batch (requires packed_ok(k,
    L)): (packed [B, L] int32 holding the uint32 words end << pos_bits(L)
    | period, ascending, 0xFFFFFFFF past n_hits; n_hits [B] int32;
    fallback [B] bool)."""
    _check(bseq, length, k, w)
    L = bseq.shape[1]
    if not packed_ok(k, L):
        raise ValueError(f"packed hits need packed_ok(k, L): k={k} L={L}")
    if bseq.device.type == "cuda":
        ph, _, n, fb = _launch(bseq, length, k, use_hpc, min_p, max_p, w,
                               True)
        return ph, n, fb
    ends, periods, n, fb = seed_plain(bseq, length, k=k, use_hpc=use_hpc,
                                      min_p=min_p, max_p=max_p, w=w)
    return pack_hits(ends, periods, n, pos_bits(L)), n, fb


def pack_hits(ends, periods, n_hits, pb: int) -> torch.Tensor:
    """(end << pb | period) words held in int32, -1 (0xFFFFFFFF) past
    n_hits."""
    idx = torch.arange(ends.shape[1], device=ends.device)[None, :]
    words = (ends.long() << pb) | periods.long()
    return torch.where(idx < n_hits[:, None].long(), words,
                       -1).to(torch.int32)


# ------------------------------------------------------- plain version --


def _shift(x: torch.Tensor, o: int, fill) -> torch.Tensor:
    """x[:, i - o] at column i (o > 0: from the left, o < 0: from the
    right), `fill` where that falls outside the row."""
    B, L = x.shape
    pad = torch.full((B, min(abs(o), L)), fill, dtype=x.dtype,
                     device=x.device)
    if o >= 0:
        return torch.cat([pad, x[:, :L - pad.shape[1]]], dim=1)
    return torch.cat([x[:, pad.shape[1]:], pad], dim=1)


def _hpc_compact(bseq: torch.Tensor, length: torch.Tensor):
    """Compress homopolymer runs, keeping each run's LAST index: (stream
    [B, L] uint8, positions [B, L] int64, stream_len [B]); slots past
    stream_len hold base 4 / position INT32_MAX."""
    B, L = bseq.shape
    idx = torch.arange(L, device=bseq.device)[None, :]
    in_read = idx < length[:, None]
    nxt = _shift(bseq, -1, 255)
    nxt_in = _shift(in_read, -1, False)
    keep = in_read & ((bseq != nxt) | ~nxt_in)
    pos_sorted = torch.sort(torch.where(keep, idx, INT32_MAX), dim=1).values
    stream_len = keep.sum(dim=1)
    got = bseq.gather(1, pos_sorted.clamp(max=L - 1))
    stream = torch.where(pos_sorted < INT32_MAX, got, 4).to(torch.uint8)
    return stream, pos_sorted, stream_len


def _keys_valid_positions(bseq, length, *, k, use_hpc, w):
    """Rolling keys, validity, read positions and the w > 1 minimizer
    selection with its fallback rules (seeding_jax.py:72-149): (key [B, L]
    int64 holding uint32, positions [B, L] int64, valid [B, L] bool,
    fallback [B] bool)."""
    B, L = bseq.shape
    dev = bseq.device
    length = length.long()
    if use_hpc:
        stream, positions, stream_len = _hpc_compact(bseq, length)
    else:
        stream = bseq
        positions = torch.arange(L, device=dev)[None, :].expand(B, L)
        stream_len = length
    base = torch.where(stream >= 4, 0, stream).long()
    key = torch.zeros((B, L), dtype=torch.int64, device=dev)
    for o in range(k):
        key |= _shift(base, o, 0) << (2 * o)
    csum = torch.cumsum((stream >= 4).long(), dim=1)
    window_n = csum - _shift(csum, k, 0)
    sidx = torch.arange(L, device=dev)[None, :]
    valid = (sidx >= k - 1) & (sidx < stream_len[:, None]) & (window_n == 0)
    fallback = torch.zeros(B, dtype=torch.bool, device=dev)
    if w > 1:
        in_read = sidx < length[:, None]
        has_n = ((bseq >= 4) & in_read).any(dim=1)
        n_seeds = valid.sum(dim=1)
        fallback = has_n | (n_seeds < w)
        if use_hpc:
            INF = 1 << 30
            posc = positions.clamp(max=INF)
            first_span = torch.where(sidx == 2 * k - 2, posc, 0).sum(1) + 1
            span = posc - _shift(posc, k, 0)
            span_lane = (sidx >= 2 * k - 1) & (sidx < stream_len[:, None])
            last_pos = torch.where(sidx < stream_len[:, None], posc,
                                   -1).max(dim=1).values
            fallback = fallback | torch.where(
                n_seeds >= k,
                (first_span >= 255) | (span_lane & (span >= 255)).any(1),
                (n_seeds >= 1) & (last_pos + 1 >= 255))
        okey = torch.where(valid, key, UINT32_MAX)
        wm = okey
        for o in range(1, w):
            wm = torch.minimum(wm, _shift(okey, o, UINT32_MAX))
        wm_ok = (sidx >= k - 1 + w - 1) & (sidx < stream_len[:, None])
        wmz = torch.where(wm_ok, wm, 0)
        cover = wmz
        for o in range(1, w):
            cover = torch.maximum(cover, _shift(wmz, -o, 0))
        valid = valid & (cover == okey)
    return key, positions, valid, fallback


def seed_plain(bseq, length, *, k, use_hpc, min_p, max_p, w=1):
    """Plain version of seed_hits: (ends, periods [B, L] int32, n_hits
    [B] int32, fallback [B] bool), as collect_hits_batch returns them."""
    B, L = bseq.shape
    dev = bseq.device
    key, positions, valid, fallback = _keys_valid_positions(
        bseq, length, k=k, use_hpc=use_hpc, w=w)
    # 64-bit words key << 31 | position: positions < 2^31 and the largest
    # key keeps them below the INT64_MAX sentinel
    words = torch.where(valid, (key << 31) | positions, INT64_MAX)
    so = torch.sort(words, dim=1).values
    q_ok = valid & (positions >= min_p)
    tgt = torch.where(q_ok, (key << 31) | (positions - min_p), -1)
    cnt = torch.searchsorted(so, tgt.contiguous(), right=True)
    rec = so.gather(1, (cnt - 1).clamp(min=0))
    same_key = (cnt > 0) & ((rec >> 31) == key)
    period = positions - (rec & INT32_MAX)
    hit = q_ok & same_key & (period <= max_p)
    n_hits = hit.sum(dim=1)
    slot = torch.where(hit, torch.cumsum(hit.long(), dim=1) - 1, L)
    ends = torch.full((B, L + 1), INT32_MAX, dtype=torch.int64, device=dev)
    pers = torch.full_like(ends, INT32_MAX)
    ends.scatter_(1, slot, torch.where(hit, positions, INT32_MAX))
    pers.scatter_(1, slot, torch.where(hit, period, INT32_MAX))
    return (ends[:, :L].int(), pers[:, :L].int(), n_hits.int(), fallback)


# ------------------------------------------------------ host wrapper --


def pad_batch(bseqs: Sequence[np.ndarray], pad_to: Optional[int] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """[B, L] uint8 codes (4 past each read) and [B] int32 lengths, L the
    longest read (at least 1, or pad_to)."""
    L = max(1, max((len(b) for b in bseqs), default=1), pad_to or 0)
    batch = np.full((len(bseqs), L), 4, np.uint8)
    lens = np.zeros(len(bseqs), np.int32)
    for i, b in enumerate(bseqs):
        batch[i, :len(b)] = b
        lens[i] = len(b)
    return batch, lens


def collect_hits_batch_host(bseqs: Sequence[np.ndarray], *, k: int, w: int,
                            use_hpc: bool, min_p: int, max_p: int,
                            pad_to: Optional[int] = None, device="cuda"
                            ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Host convenience wrapper: list of uint8 reads -> per-read (ends,
    periods) int64 arrays via one collect_hits_batch call; flagged rows
    reroute through the exact host seeder."""
    from .seeding import collect_tandem_repeat_hits

    batch, lens = pad_batch(bseqs, pad_to)
    dev = torch.device(device)
    ends, periods, n, fb = (t.cpu().numpy() for t in collect_hits_batch(
        torch.as_tensor(batch, device=dev), torch.as_tensor(lens, device=dev),
        k=k, use_hpc=use_hpc, min_p=min_p, max_p=max_p, w=w))
    return [
        collect_tandem_repeat_hits(bseqs[i], k, w, use_hpc, min_p, max_p)
        if fb[i] else
        (ends[i, :n[i]].astype(np.int64), periods[i, :n[i]].astype(np.int64))
        for i in range(len(bseqs))
    ]
