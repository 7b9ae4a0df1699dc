"""Batched Myers bit-parallel infix search (edlib's HW mode) on PyTorch
tensors.

Counterpart of ``tidehunter_tpu/ops/myers_jax.py``: ``hw_batch`` gives
each (query, target, k) the ``(ed, start, end)`` of the host oracle
``ops/myers.align_hw``, bit for bit:

  * ``end`` is the LEFTMOST target position with the least distance;
  * ``start`` comes from an SHW pass over the reversed query and the
    reversed prefix ``target[0..end]``, taking the LAST position whose
    score equals that distance;
  * ``k >= 0`` and ``ed > k`` gives ``(-1, None, None)``.

On a CUDA device every representable problem of a call goes to one launch
of the hand-written kernel ``csrc/myers_hw.cu: myers_hw`` (both passes in
the launch, one pull): a problem's HW pass is split over up to 128 lanes,
each scoring its own target segment after a warm-up of m + min(k, m) - 1
columns, and the SHW start pass stops after min(end + 1, m + ed)
columns.  On the CPU the same tensors go to ``hw_batch_plain``, a column
loop over ``[B]`` lanes of torch ops in the shape of
``myers_jax._scan_batch`` that walks every SHW column (end + 1).

**The JAX package's rule for what the 2-bit+N code cannot represent**
(``myers_jax.hw_batch``): an empty query or target, a query over 128 bp,
or a character outside ACGTN (any case) resolves through the port's own
``ops/myers.align_hw``, which compares ambiguity codes by character
equality.  That is the reference's semantics for those problems, not a
fallback from a failed launch; ``METRICS`` counts them as ``hws_host``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels as K
from ..utils.metrics import METRICS
from .myers import align_hw

MAX_QUERY = 128          # bp: two 64-bit words on the card, four 32-bit here
PAD = 5                  # past a row's end in the plain version's rectangle
M32 = 0xFFFFFFFF

_LUT = np.full(256, 255, np.uint8)     # 255: not representable
for _i, _c in enumerate("ACGTN"):
    _LUT[ord(_c)] = _LUT[ord(_c.lower())] = _i

Hit = Tuple[int, Optional[int], Optional[int]]


def encode5(s: str) -> Optional[np.ndarray]:
    """Codes 0..4 of an ACGTN string (any case), or None when it holds any
    other character."""
    codes = _LUT[np.frombuffer(s.encode("latin1", "replace"), np.uint8)]
    return None if (codes == 255).any() else codes


def pack(queries: Sequence[str], targets: Sequence[str],
         ks: Sequence[int]) -> Tuple[np.ndarray, np.ndarray, List[int]]:
    """(seq, meta, rows): the kernel's inputs for the problems it can
    represent.  seq holds the uint8 codes of each distinct query and
    target once (the four adapter searches of a doubled consensus share
    it); meta [5, len(rows)] int32 is query offset, query length, target
    offset, target length and k; rows are those problems' indices in the
    call.  The others (empty, a query over MAX_QUERY, a non-ACGTN code)
    are left to align_hw."""
    codes: Dict[str, Optional[int]] = {}     # string -> offset in `parts`
    parts: List[np.ndarray] = []
    size = 0
    rows: List[int] = []
    meta: List[Tuple[int, int, int, int, int]] = []

    def offset(s: str) -> Optional[int]:
        nonlocal size
        if s not in codes:
            enc = encode5(s)
            codes[s] = None if enc is None else size
            if enc is not None:
                parts.append(enc)
                size += len(enc)
        return codes[s]

    for i, (q, t) in enumerate(zip(queries, targets)):
        qo = offset(q) if 0 < len(q) <= MAX_QUERY and len(t) > 0 else None
        to = offset(t) if qo is not None else None
        if to is not None:
            rows.append(i)
            meta.append((qo, len(q), to, len(t), int(ks[i])))
    seq = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return (seq, np.ascontiguousarray(np.array(meta, np.int32).reshape(
        -1, 5).T), rows)


def hw_batch(queries: Sequence[str], targets: Sequence[str],
             ks: Sequence[int], device="cuda") -> List[Hit]:
    """[(ed, start, end)] of align_hw(queries[i], targets[i], ks[i]):
    the representable problems in one myers_hw call, the rest on the host
    (counted as hws_host)."""
    seq, meta, rows = pack(queries, targets, ks)
    out: List[Optional[Hit]] = [None] * len(queries)
    if rows:
        dev = torch.device(device)
        res = myers_hw(torch.as_tensor(seq, device=dev),
                       torch.as_tensor(meta, device=dev),
                       int(meta[1].max())).cpu().numpy()
        for r, i in enumerate(rows):
            ed, st, en = (int(x) for x in res[:, r])
            out[i] = (-1, None, None) if ed < 0 else (ed, st, en)
    for i, hit in enumerate(out):
        if hit is None:
            METRICS.add("hws_host")
            out[i] = align_hw(queries[i], targets[i], ks[i])
    return out


def myers_hw(seq: torch.Tensor, meta: torch.Tensor,
             qmax: int) -> torch.Tensor:
    """(ed, start, end) [3, B] int32 of the problems of meta.

    seq: uint8 codes 0..4, queries and targets concatenated; meta [5, B]
    int32: query offset, query length (1..qmax), target offset, target
    length (>= 1), k; qmax: the longest query length in meta, known on the
    host (it sets the kernel's words a query, so nothing is read back
    before the launch).  A CUDA tensor launches the kernel, a CPU tensor
    runs hw_batch_plain."""
    if seq.dtype != torch.uint8 or meta.dtype != torch.int32:
        raise TypeError("seq must be uint8 and meta int32")
    if seq.dim() != 1 or meta.dim() != 2 or meta.shape[0] != 5:
        raise ValueError("seq must be [N] and meta [5, B]")
    if seq.device != meta.device:
        raise ValueError("seq and meta lie on different devices")
    if not 0 < qmax <= MAX_QUERY:
        raise ValueError(f"queries must be 1..{MAX_QUERY} bp, not {qmax}")
    B = meta.shape[1]
    if seq.device.type == "cpu":
        return hw_batch_plain(seq, meta)
    if seq.device.type != "cuda":
        raise ValueError(f"unsupported device {seq.device}")
    out = torch.empty((3, B), dtype=torch.int32, device=seq.device)
    if B:
        # the lanes are chosen for, and the launch made on, the data's card
        with torch.cuda.device(seq.device):
            K.MYERS_HW(seq.contiguous().data_ptr(),
                       meta.contiguous().data_ptr(), B,
                       1 if qmax <= 64 else 2, out.data_ptr())
    return out


# ------------------------------------------------------- plain version --


def _peq(qc: torch.Tensor, W: int) -> torch.Tensor:
    """[B, 5, W] match masks (int64 holding 32-bit words) of the query
    codes qc [B, 32 W] (PAD past the end)."""
    B = qc.shape[0]
    onehot = (qc[:, :, None] == torch.arange(5, device=qc.device)).long()
    weight = torch.ones(32, dtype=torch.int64, device=qc.device) << \
        torch.arange(32, device=qc.device)
    bits = onehot.view(B, W, 32, 5) * weight[None, None, :, None]
    return bits.sum(dim=2).permute(0, 2, 1).contiguous()


def _scan(peq, tgt, m, wmask, shw: bool, best_in=None):
    """The column loop of myers_jax._scan_batch over tgt [B, L] (PAD past
    a row's end).  HW: (least score, its leftmost column); SHW: (best_in,
    the last column whose score equals best_in); -1 when none."""
    B, L = tgt.shape
    W = peq.shape[2]
    dev = tgt.device
    hw_word = ((m - 1) // 32)[:, None]
    hw_bit = (m - 1) % 32
    pv = wmask.clone()
    mv = torch.zeros_like(wmask)
    score = m.clone()
    best = best_in.clone() if shw else torch.full_like(m, 1 << 30)
    pos = torch.full_like(m, -1)
    inject = torch.full((B, 1), int(shw), dtype=torch.int64, device=dev)
    zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    for j in range(L):
        tc = tgt[:, j]
        live = tc < PAD
        eq = peq.gather(1, tc.clamp(max=4)[:, None, None].expand(B, 1, W))[:, 0]
        xv = eq | mv
        add = (eq & pv) + pv
        if W > 1:               # carry low word to high
            words, carry = [], 0
            for w in range(W):
                s = add[:, w] + carry
                words.append(s & M32)
                carry = s >> 32
            add = torch.stack(words, dim=1)
        xh = ((add & M32) ^ pv) | eq
        ph = mv | (~(xh | pv) & wmask)
        mh = pv & xh
        phb = (ph.gather(1, hw_word)[:, 0] >> hw_bit) & 1
        mhb = (mh.gather(1, hw_word)[:, 0] >> hw_bit) & 1
        score = score + torch.where(live, phb - mhb, 0)
        # shift left one across words; HW injects 0 into bit 0, SHW 1
        ph = ((ph << 1) | torch.cat([inject, ph[:, :-1] >> 31], 1)) & wmask
        mh = ((mh << 1) | torch.cat([zero, mh[:, :-1] >> 31], 1)) & wmask
        pv = torch.where(live[:, None], mh | (~(xv | ph) & wmask), pv)
        mv = torch.where(live[:, None], ph & xv, mv)
        if shw:
            pos = torch.where(live & (score == best), j, pos)
        else:
            hit = live & (score < best)
            best = torch.where(hit, score, best)
            pos = torch.where(hit, j, pos)
    return best, pos


def hw_batch_plain(seq: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """Plain version of myers_hw: the HW pass over every target, then the
    SHW pass over the reversed query and reversed target prefix of the
    problems within k, as torch ops over 32-bit words held in int64."""
    dev = seq.device
    qoff, m, toff, tlen, k = meta.long()
    B = m.shape[0]
    if B == 0:
        return torch.empty((3, 0), dtype=torch.int32, device=dev)
    N = seq.shape[0]
    W = -(-int(m.max()) // 32)
    seq = seq.long()

    def rows(off, length, width, rev_end=None):
        """[B, width] codes of seq[off + i] (rev_end: seq[off + rev_end
        - i]) for i < length, PAD past it."""
        i = torch.arange(width, device=dev)[None, :]
        at = (off[:, None] + (i if rev_end is None else rev_end[:, None] - i))
        got = seq[at.clamp(0, N - 1)]
        return torch.where(i < length[:, None], got, PAD)

    qw = torch.arange(W, device=dev)[None, :]
    bits = (m[:, None] - 32 * qw).clamp(0, 32)
    wmask = torch.where(bits >= 32, M32, (torch.ones_like(bits) << bits) - 1)
    q = rows(qoff, m, 32 * W)
    best, end = _scan(_peq(q, W), rows(toff, tlen, int(tlen.max())), m,
                      wmask, False)
    ok = (k < 0) | (best <= k)
    # SHW: query reversed, target t[end], t[end - 1], ..., t[0]
    qrev = rows(qoff, m, 32 * W, rev_end=m - 1)
    span = torch.where(ok, end + 1, 0)
    _, pos = _scan(_peq(qrev, W), rows(toff, span, max(1, int(span.max())),
                                       rev_end=end),
                   m, wmask, True, best)
    neg = torch.full_like(best, -1)
    return torch.stack([torch.where(ok, best, neg),
                        torch.where(ok, end - pos, neg),
                        torch.where(ok, end, neg)]).int()
