"""Device chain DP: batched, windowed, bit-exact with a fallback flag, on
PyTorch tensors.

Counterpart of ``tidehunter_tpu/ops/chaining_jax.py``: ``chain_dp_batch``
gives every read's per-cell (score, from) of the reference chain DP
(reference src/tandem_chain.c:290-356) over hit matrices in (end, period)
order, and a per-read ``fallback`` flag:

  * the envelope gate: a non-singleton end group, a period >= 2^15 or an
    end >= 2^30 (the native AVX path's gate); a gated read is not run;
  * ``incomplete``: some cell saw no event (window edge, iter_n cutoff,
    SAME/OVL stop) inside its ``window`` predecessors, so the sequential
    scan would have gone on.  With ``window`` >= the plane's width the
    front edge is always inside the window and this never fires.

A flagged read must be rerouted through the host chainer.  On every other
read, score[:n] and from[:n] equal the JAX function's (cell 0 keeps its
base score, from -1); past n_hits, and on gated reads, score is 0 and
from -1.

On a CUDA tensor this is one launch of the hand-written kernel
``csrc/chain_dp.cu: chain_dp`` (a warp a read, its planes in shared
memory where they fit, predecessors scanned 32 a step until the first
event); on a CPU tensor ``chain_dp_plain`` runs the
JAX module's dataflow as torch ops: a Python step per cell, every window
lane of every read evaluated.
"""

from __future__ import annotations

import torch

from .. import _kernels as K

NEG = -(1 << 30)
BIG = 1 << 30


def chain_dp_batch(ends: torch.Tensor, periods: torch.Tensor,
                   n_hits: torch.Tensor, *, k: int, window: int = 512):
    """(score [B, L] int32, from_idx [B, L] int32 (-1 = none), fallback
    [B] bool) of the hit matrices ends, periods [B, L] int32 with n_hits
    [B]."""
    if ends.shape != periods.shape or ends.dim() != 2:
        raise ValueError("ends and periods must be [B, L] alike")
    if n_hits.dim() != 1 or n_hits.shape[0] != ends.shape[0]:
        raise ValueError("n_hits must be [B]")
    if not (ends.device == periods.device == n_hits.device):
        raise ValueError("inputs lie on different devices")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if ends.device.type == "cpu":
        return chain_dp_plain(ends, periods, n_hits, k=k, window=window)
    if ends.device.type != "cuda":
        raise ValueError(f"unsupported device {ends.device}")
    B, L = ends.shape
    score = torch.empty((B, L), dtype=torch.int32, device=ends.device)
    from_idx = torch.empty_like(score)
    fb = torch.empty(B, dtype=torch.bool, device=ends.device)
    if B and L:
        with torch.cuda.device(ends.device):    # the card of the data
            K.CHAIN_DP(ends.int().contiguous().data_ptr(),
                       periods.int().contiguous().data_ptr(),
                       n_hits.int().contiguous().data_ptr(), B, L, k,
                       window, score.data_ptr(), from_idx.data_ptr(),
                       fb.data_ptr())
    else:
        fb.zero_()
    return score, from_idx, fb


def _gate(ends, periods, real):
    nonsingleton = ((ends[:, 1:] == ends[:, :-1]) & real[:, 1:]).any(dim=1)
    return (nonsingleton | (real & (periods >= (1 << 15))).any(dim=1)
            | (real & (ends >= (1 << 30))).any(dim=1))


def chain_dp_plain(ends, periods, n_hits, *, k: int, window: int = 512,
                   scan_lanes: bool = False):
    """Plain version of chain_dp: chaining_jax.chain_dp_batch as torch
    ops.  With scan_lanes, also the number of predecessor lanes the
    sequential scan needs over the served cells (each cell's lanes up to
    and including its first event, or its whole window), the work a
    bound counts.

    Two cuts leave every output as JAX's: cell cur runs only the reads
    with more than cur hits (reads in order of n_hits, a prefix of them),
    and only its last min(window, cur + 1) lanes, since the lane before
    the first hit is an event that ends every scan."""
    B, L = ends.shape
    dev = ends.device
    W = int(window)
    n_hits = n_hits.int()
    order = torch.argsort(n_hits, descending=True, stable=True)
    ends, periods, n = ends.int()[order], periods.int()[order], n_hits[order]
    starts = ends - periods
    base = k + periods.clamp(max=k)
    real = torch.arange(L, device=dev)[None, :] < n[:, None]
    gate = _gate(ends, periods, real)

    def pad(x, fill):
        return torch.cat([torch.full((B, W), fill, dtype=torch.int32,
                                     device=dev), x], dim=1)

    endsP, startsP, scoreP = pad(ends, NEG), pad(starts, 0), pad(base, 0)
    from_all = torch.full((B, L), -1, dtype=torch.int32, device=dev)
    inc = torch.zeros(B, dtype=torch.bool, device=dev)
    lanes = torch.zeros(B, dtype=torch.int64, device=dev)
    n_list = n.tolist()
    live = B
    for cur in range(1, n_list[0] if B else 0):
        while n_list[live - 1] <= cur:
            live -= 1
        Ws = min(W, cur + 1)
        c = cur + W
        ce, cs = endsP[:live, c:c + 1], startsP[:live, c:c + 1]
        base_cur = scoreP[:live, c:c + 1]
        cp = ce - cs
        ew, sw = endsP[:live, c - Ws:c], startsP[:live, c - Ws:c]
        scw = scoreP[:live, c - Ws:c]
        pre_p = ew - sw
        valid = ew >= cs
        conn = valid & (cs > sw) & (5 * cp < 9 * pre_p) & (5 * pre_p < 9 * cp)
        dis1, dis2 = ce - ew, cs - sw
        matched = dis1.clamp(max=k) + dis2.clamp(max=k)
        dlt = (cp - pre_p).abs()
        # ilog2 = 31 - clz(x): frexp's exponent is exact
        ilog2 = torch.frexp((dis1 + dis2).clamp(min=1).double()).exponent - 1
        gap = ((dlt * dlt) >> 1) + (ilog2 >> 1)
        sc = torch.where(conn, scw + matched - gap, NEG)
        suff_incl = torch.cummax(sc.flip(1), dim=1).values.flip(1)
        suff_excl = torch.cat([suff_incl[:, 1:], torch.full(
            (live, 1), NEG, dtype=torch.int32, device=dev)], dim=1)
        improving = conn & (sc > torch.maximum(base_cur, suff_excl))
        idxW = torch.arange(Ws, device=dev)[None, :]
        mi = torch.cummin(torch.where(improving, idxW, BIG).flip(1),
                          dim=1).values.flip(1)
        run = torch.where(mi < BIG, mi - idxW, Ws - idxW)
        iterbrk = run >= cp
        stop = conn & (dlt == 0) & ((matched < 2 * k) | improving)
        event = stop | iterbrk | ~valid
        wT = torch.where(event, idxW, -1).max(dim=1, keepdim=True).values
        include = (idxW > wT) | ((idxW == wT) & stop & improving)
        cand = include & improving
        w_win = torch.where(cand, idxW, BIG).min(dim=1, keepdim=True).values
        has = w_win < BIG
        sc_win = sc.gather(1, w_win.clamp(max=Ws - 1))
        scoreP[:live, c:c + 1] = torch.where(has, sc_win, base_cur)
        from_all[:live, cur:cur + 1] = torch.where(has, cur - Ws + w_win, -1)
        inc[:live] |= wT[:, 0] < 0
        lanes[:live] += torch.where(gate[:live], 0,
                                    Ws - wT[:, 0].clamp(min=0))
    served = real & ~gate[:, None]
    score = torch.where(served, scoreP[:, W:], 0)
    from_idx = torch.where(served, from_all, -1)
    back = torch.argsort(order)
    score, from_idx, fallback = score[back], from_idx[back], (gate | inc)[back]
    if scan_lanes:
        return score, from_idx, fallback, int(lanes.sum())
    return score, from_idx, fallback
