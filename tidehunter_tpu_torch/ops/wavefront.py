"""Wavefront affine-gap alignment (ksw2 extz2) on PyTorch tensors.

Counterpart of ``tidehunter_tpu/ops/wavefront.py``: the same
``global_batch`` and ``ext_batch`` outputs, bit-identical with the NumPy
oracle ``tidehunter_tpu/ops/ksw2.py``.  On a CUDA tensor each call launches
one hand-written kernel (``csrc/wavefront.cu``: ``wf_global``, ``wf_ext``);
on a CPU tensor it runs the plain PyTorch version in this module, a loop
over anti-diagonals of ``[B, T]`` tensor ops that mirrors the kernel row
for row.  A launch takes the rows it is given: there is no batch ladder and
no padding beyond the caller's ``[B, LQ] x [B, T]`` rectangle.

Inputs: ``q [B, LQ]`` and ``t [B, T]`` uint8 codes 0..4 (4 = N), ``qlen``,
``tlen`` (and ``qle``) ``[B]`` int32 with ``1 <= qlen <= LQ`` and
``1 <= tlen <= T <= 8192``.  Outputs are int32 tensors on the input's
device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tidehunter_tpu.ops.ksw2 import GAP_EXT, GAP_OPEN, MATCH_SC, MIS_SC

from .. import _kernels as K

NEG_INF32 = -(1 << 30)
DEFAULT_SCORES = (MATCH_SC, MIS_SC, GAP_OPEN, GAP_EXT)
TLB = 14                      # t_left field width (tl + 1; 0 = unset)
TLMASK = (1 << TLB) - 1
BESTR_UNSET = 0x7FFFFFF
MAX_T = 8192                  # the tl + 1 field holds targets up to this
# Shared memory a CTA may take on Hopper; rows that do not fit go to a
# global scratch instead (csrc/wavefront.cu).
SMEM_LIMIT = 227 * 1024
GLOBAL_ROWS, EXT_ROWS = 12, 8


def _check(q, qlen, t, tlen, qle=None):
    if q.dtype != torch.uint8 or t.dtype != torch.uint8:
        raise TypeError("q and t must be uint8 code tensors")
    lens = (qlen, tlen) if qle is None else (qlen, tlen, qle)
    if any(x.dtype != torch.int32 for x in lens):
        raise TypeError("qlen, tlen and qle must be int32")
    if q.dim() != 2 or t.dim() != 2 or q.shape[0] != t.shape[0]:
        raise ValueError("q and t must be [B, LQ] and [B, T]")
    B = q.shape[0]
    if any(x.shape != (B,) for x in lens):
        raise ValueError("length vectors must be [B]")
    if t.shape[1] > MAX_T:
        raise ValueError(f"target width {t.shape[1]} exceeds {MAX_T}")
    devs = {x.device for x in (q, t, *lens)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def _scratch(rows: int, B: int, T: int, device):
    """None when the kernel's rows fit in shared memory, else a global
    buffer of B * rows * T ints."""
    if rows * T * 4 <= SMEM_LIMIT:
        return None
    return torch.empty(B * rows * T, dtype=torch.int32, device=device)


def _ptr(x) -> int:
    return x.data_ptr() if x is not None else None


def global_batch(q, qlen, t, tlen, qle, scores=DEFAULT_SCORES,
                 iden_only=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(iden_n, t_left_ext) per problem of a padded batch.

    iden_only=True runs the leaner variant that carries the identity
    count alone (t_left returned as zeros) — for callers that never read
    t_left (aveMatch)."""
    _check(q, qlen, t, tlen, qle)
    if q.device.type == "cpu":
        return global_plain(q, qlen, t, tlen, qle, scores, not iden_only)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    q, t, qlen, tlen, qle = (x.contiguous() for x in (q, t, qlen, tlen, qle))
    B, LQ = q.shape
    T = t.shape[1]
    iden = torch.empty(B, dtype=torch.int32, device=q.device)
    tleft = torch.empty(B, dtype=torch.int32, device=q.device)
    scratch = _scratch(GLOBAL_ROWS, B, T, q.device)
    m, x, go, ge = (int(s) for s in scores)
    K.WF_GLOBAL(q.data_ptr(), LQ, t.data_ptr(), T, qlen.data_ptr(),
                tlen.data_ptr(), qle.data_ptr(), B, m, x, go, ge,
                int(iden_only), iden.data_ptr(), tleft.data_ptr(),
                _ptr(scratch))
    return iden, tleft


def ext_batch(q, qlen, t, tlen, scores=DEFAULT_SCORES):
    """(max, max_t, max_q, score) per problem of a padded batch: the
    score-only extension alignment with the reference's SIMD row-scan tie
    order (ksw2_extz2_sse.c:224-260)."""
    _check(q, qlen, t, tlen)
    if q.device.type == "cpu":
        besth, bestr, score = ext_plain(q, qlen, t, tlen, scores)
    elif q.device.type == "cuda":
        q, t, qlen, tlen = (x.contiguous() for x in (q, t, qlen, tlen))
        B, LQ = q.shape
        T = t.shape[1]
        besth = torch.empty((B, T), dtype=torch.int32, device=q.device)
        bestr = torch.empty((B, T), dtype=torch.int32, device=q.device)
        score = torch.empty(B, dtype=torch.int32, device=q.device)
        scratch = _scratch(EXT_ROWS, B, T, q.device)
        m, x, go, ge = (int(s) for s in scores)
        K.WF_EXT(q.data_ptr(), LQ, t.data_ptr(), T, qlen.data_ptr(),
                 tlen.data_ptr(), B, m, x, go, ge, besth.data_ptr(),
                 bestr.data_ptr(), score.data_ptr(), _ptr(scratch))
    else:
        raise ValueError(f"unsupported device {q.device}")
    return (*ext_tie_order(besth, bestr, qlen, tlen), score)


def ext_tie_order(besth, bestr, qlen, tlen):
    """(max, max_t, max_q) from the per-lane best H and its first row.

    The winning row r* is the first row reaching the overall max; within
    it the reference scan (ops/ksw2._row_max_scan) takes en0 first, then
    lane-0-first over the 4-lane SIMD range [st0, en1), then the first
    of the remainder [en1, en0)."""
    B, T = besth.shape
    ti = torch.arange(T, device=besth.device, dtype=torch.int32)[None, :]
    qlen1 = qlen[:, None]
    tlen1 = tlen[:, None]
    big = torch.tensor(BESTR_UNSET, dtype=torch.int32, device=besth.device)
    M = besth.max(dim=1, keepdim=True).values
    is_max = besth == M
    rstar = torch.where(is_max, bestr, big).min(dim=1, keepdim=True).values
    st0 = (rstar - qlen1 + 1).clamp(min=0)
    en0 = torch.minimum(tlen1 - 1, rstar)
    en1 = st0 + torch.div(en0 - st0, 4, rounding_mode="floor") * 4
    cand = is_max & (bestr == rstar)
    at_en0 = (cand & (ti == en0)).any(dim=1, keepdim=True)
    BIGI = 1 << 20
    lane = torch.where(ti >= st0, torch.remainder(ti - st0, 4), 0)
    in_vec = cand & (ti >= st0) & (ti < en1)
    vec_key = torch.where(in_vec, lane * BIGI + ti, big).min(
        dim=1, keepdim=True).values
    in_rem = cand & (ti >= en1) & (ti < en0)
    rem_t = torch.where(in_rem, ti, big).min(dim=1, keepdim=True).values
    max_t = torch.where(
        at_en0, en0,
        torch.where(vec_key != big, torch.remainder(vec_key, BIGI),
                    torch.where(rem_t != big, rem_t, en0)))
    found = M[:, 0] > 0
    zero = torch.zeros_like(M[:, 0])
    bmax = torch.where(found, M[:, 0], zero)
    bmax_t = torch.where(found, max_t[:, 0], zero - 1)
    bmax_q = torch.where(found, rstar[:, 0] - max_t[:, 0], zero - 1)
    return bmax.int(), bmax_t.int(), bmax_q.int()


# ------------------------------------------------------- plain versions --


class _Diff:
    """The difference rows u, v, x, y of every problem, [B, T] each, and
    one anti-diagonal step of _dp_row (wavefront.py:86-135)."""

    def __init__(self, q, qlen, t, tlen, scores):
        B, LQ = q.shape
        T = t.shape[1]
        dev = q.device
        self.T = T
        self.scores = scores
        self.ti = torch.arange(T, device=dev, dtype=torch.int32)[None, :]
        self.qlen = qlen[:, None]
        self.tlen = tlen[:, None]
        self.tb = t.int()
        # q[r - t] for every lane; indices past the query read code 4
        self.qpad = torch.cat(
            [q.int(), torch.full((B, T + 1), 4, dtype=torch.int32,
                                 device=dev)], dim=1)
        zeros = torch.zeros((B, T), dtype=torch.int32, device=dev)
        self.u, self.v, self.x, self.y = (zeros.clone() for _ in range(4))
        self.nrows = int((qlen + tlen).max()) - 1 if B else 0

    def step(self, r):
        MATCH, MIS, GO, GE = self.scores
        QE2 = 2 * (GO + GE)
        MAXSC = MATCH + QE2
        ti = self.ti
        j = r - ti
        qb = torch.where(j >= 0, self.qpad.gather(
            1, j.clamp(min=0).expand(self.qpad.shape[0], -1)), 4)
        st0 = (r - self.qlen + 1).clamp(min=0)
        en0 = (self.tlen - 1).clamp(max=r)
        active = r < self.qlen + self.tlen - 1
        mask = (ti >= st0) & (ti <= en0) & active
        tb = self.tb
        s = torch.where((tb == 4) | (qb == 4), -GE,
                        torch.where(tb == qb, MATCH, MIS))
        bq = GO if r > 0 else 0
        is_r = ti == r
        y_b = torch.where(is_r, 0, self.y)
        u_b = torch.where(is_r, bq, self.u)
        x_sh = torch.where(ti == 0, 0, torch.roll(self.x, 1, 1))
        v_sh = torch.where(ti == 0, bq, torch.roll(self.v, 1, 1))
        a = x_sh + v_sh
        b = y_b + u_b
        z = s + QE2
        d = (a > z).int()
        z = torch.maximum(z, a)
        d = torch.where(b > z, 2, d)
        z = torch.maximum(z, b)
        z = z.clamp(max=MAXSC)
        u_new = z - v_sh
        v_new = z - u_b
        z2 = z - GO
        a2 = a - z2
        b2 = b - z2
        self.u = torch.where(mask, u_new, self.u)
        self.v = torch.where(mask, v_new, self.v)
        self.x = torch.where(mask, a2.clamp(min=0), self.x)
        self.y = torch.where(mask, b2.clamp(min=0), self.y)
        return mask, qb, d, a2 > 0, b2 > 0, u_new, v_new, en0


def global_plain(q, qlen, t, tlen, qle, scores, with_tl):
    """Plain version of wf_global: _global_row's forward-carried backtrack
    annotations (wavefront.py:200-262), one anti-diagonal per step."""
    st = _Diff(q, qlen, t, tlen, scores)
    B, T = t.shape
    ti = st.ti
    qlen1, tlen1 = st.qlen, st.tlen
    qle1 = qle[:, None]
    zeros = torch.zeros((B, T), dtype=torch.int32, device=q.device)
    a0 = [zeros.clone(), zeros.clone()]     # by row parity
    a1 = [zeros.clone(), zeros.clone()]
    a2 = [zeros.clone(), zeros.clone()]
    acc = zeros.clone()
    jS = qlen1 - qle1.clamp(min=1)
    has_q = qle1 > 0
    for r in range(st.nrows):
        mask, qb, d, bit08, bit10, _, _, _ = st.step(r)
        p, o = r & 1, (r & 1) ^ 1
        eq = (qb == st.tb).int()
        is_r = ti == r
        if with_tl:
            j = r - ti
            is_jS = j == jS
            tlb = (tlen1 + 1) & TLMASK
            pm_b0 = torch.where(jS <= r - 1, tlb, 0)
            pd_b0 = torch.where(jS <= r, tlb, 0)
            P_M = torch.where(is_r, 0, torch.where(
                ti == 0, pm_b0, torch.roll(a0[p], 1, 1)))
            P_D = torch.where(ti == 0, pd_b0, torch.roll(a1[o], 1, 1))
            P_I = torch.where(is_r, 0, a2[o])
            set_m = (torch.where(has_q, tlen1 - ti, tlen1 - 1 - ti)
                     + 1) & TLMASK
            set_i = (torch.where(has_q, tlen1 - ti - 1, tlen1 - 1 - ti)
                     + 1) & TLMASK
            M_step = (((P_M >> TLB) + eq) << TLB) | torch.where(
                is_jS, set_m, P_M & TLMASK)
            D_step = P_D
            I_step = (P_I & ~TLMASK) | torch.where(is_jS, set_i,
                                                   P_I & TLMASK)
        else:
            P_M = torch.where(is_r | (ti == 0), 0, torch.roll(a0[p], 1, 1))
            M_step = P_M + eq
            D_step = torch.where(ti == 0, 0, torch.roll(a1[o], 1, 1))
            I_step = torch.where(is_r, 0, a2[o])
        A0 = torch.where(d == 0, M_step, torch.where(d == 1, D_step, I_step))
        a0[p] = torch.where(mask, A0, a0[p])
        a1[p] = torch.where(mask, torch.where(bit08, D_step, A0), a1[p])
        a2[p] = torch.where(mask, torch.where(bit10, I_step, A0), a2[p])
        hit = (r == qlen1 + tlen1 - 2) & (ti == tlen1 - 1) & mask
        acc = torch.where(hit, A0, acc)
    packed = acc.max(dim=1).values if T else acc[:, 0]
    if not with_tl:
        return packed.int(), torch.zeros_like(packed).int()
    iden = packed >> TLB
    tl = (packed & TLMASK) - 1
    tleft = torch.where(qle > qlen, tlen, tl)
    return iden.int(), tleft.int()


def ext_plain(q, qlen, t, tlen, scores):
    """Plain version of wf_ext: per-lane best H and its first row
    (_ext_row, wavefront.py:369-403) plus the end score."""
    st = _Diff(q, qlen, t, tlen, scores)
    B, T = t.shape
    ti = st.ti
    QE = scores[2] + scores[3]
    H = torch.full((B, T), NEG_INF32, dtype=torch.int32, device=q.device)
    besth = torch.zeros((B, T), dtype=torch.int32, device=q.device)
    bestr = torch.full((B, T), BESTR_UNSET, dtype=torch.int32,
                       device=q.device)
    sacc = torch.full((B, T), NEG_INF32, dtype=torch.int32, device=q.device)
    for r in range(st.nrows):
        mask, _, _, _, _, u_n, v_n, en0 = st.step(r)
        h_new = torch.where(
            ti == en0,
            torch.where(en0 > 0, torch.roll(H, 1, 1) + u_n - QE,
                        H + v_n - QE),
            H + v_n - QE)
        if r == 0:
            h_new = torch.where(ti == 0, v_n - QE - QE, h_new)
        H = torch.where(mask, h_new, H)
        upd = mask & (H > besth)
        besth = torch.where(upd, H, besth)
        bestr = torch.where(upd, r, bestr)
        hit = (r == st.qlen + st.tlen - 2) & (ti == st.tlen - 1) & mask
        sacc = torch.where(hit, H, sacc)
    return besth, bestr, sacc.max(dim=1).values.int()
