"""Device-resident profile-POA consensus on PyTorch tensors.

Counterpart of ``tidehunter_tpu/ops/msa_device.py``.  All MSA state of a
region batch stays on the device across the unit rounds:

  counts [B, T, 5] int16   profile column base counts
  n_placed, ncol [B] int32, overflow [B] bool, ev [B] int32

and each unit round is

  1. ``scores_step`` (torch ops): fixed-point substitution scores and
     occupancy-weighted deletion prefix sums from the counts — the
     arithmetic of ops/poa_profile.Profile.sub_scores / del_weights;
  2. ``profile_dp``: the profile Gotoh DP in anti-diagonal form, full width
     or in a W-lane band window (``csrc/profile_dp.cu``);
  3. ``profile_bt``: the backtrack into compacted right-anchored ops
     (``csrc/profile_bt.cu``);
  4. ``update_step`` (torch ops): the profile update as gathers.

With ``polish`` > 0, each polish pass realigns every unit (unit 0 too)
against the frozen profile with the same three steps and counts its match
votes with ``polish_update`` (torch ops, the JAX package's jnp code); the
votes then become the counts.

With a mesh (``DeviceMSA(mesh=)``, ``parallel/mesh``) every region batch
is split into contiguous blocks, one a device, each block's rounds queued
on its device and every block's pull issued before any is waited for;
a batch then holds up to ``batch_rows(T, W)`` regions a device.

``consensus_batch`` keeps the JAX package's retry walk exactly (1.2x column
margin, bucket-up on overflow, next band rung on a band touch, units
truncated to T, the ``ev`` first-event rule), so its output is
bit-identical with the host mirror ``ops/poa_profile.
banded_profile_consensus``.  On a CPU device the two kernels run as their
plain PyTorch versions in this module.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels as K
from ..parallel import mesh as PM
from ..utils.metrics import METRICS
from .poa_profile import SCALE, band_ladder

NEG = -(1 << 30)
OP_M, OP_I, OP_D, OP_PAD = 0, 1, 2, 3
BUCKETS = (128, 256, 384, 512, 640, 768, 896, 1024, 2048, 4096)
# Device memory one region batch may spend on its direction plane, which
# costs (2T - 1) * W bytes per region; results do not depend on the batch.
DIRS_BUDGET = 1 << 30


def band_base(r: int, T: int, W: int) -> int:
    """Window base of anti-diagonal r for the |c - j| <= W - 8 band
    (msa_device._band_base): slides one lane every two rows, two lanes of
    left slack, clamped to [0, T - W]."""
    return max(0, min(((r - (W - 8)) >> 1) - 2, T - W))


def n_levels(T: int) -> int:
    """Width NL of the ops rows: 2T + 1 levels rounded up to 128."""
    return ((2 * T + 1 + 127) // 128) * 128


class MSAState(NamedTuple):
    counts: torch.Tensor     # [B, T, 5] int16
    n_placed: torch.Tensor   # [B] int32
    ncol: torch.Tensor       # [B] int32
    overflow: torch.Tensor   # [B] bool
    ev: torch.Tensor         # [B] int32: 0 clean, 1 band touch, 2 overflow


class RoundOut(NamedTuple):
    state: MSAState
    dirs: torch.Tensor       # [2T-1, B, W or T] uint8
    ops: torch.Tensor        # [B, NL] int8
    nst: torch.Tensor        # [B] int32
    tch: torch.Tensor        # [B] int32


def state_from_numpy(counts, n_placed, ncol, overflow, ev,
                     device) -> MSAState:
    """One round's MSA state from NumPy arrays (the form a test hands to
    both this package and the JAX one)."""
    dev = torch.device(device)
    return MSAState(
        torch.as_tensor(np.asarray(counts, np.int16), device=dev),
        torch.as_tensor(np.asarray(n_placed, np.int32), device=dev),
        torch.as_tensor(np.asarray(ncol, np.int32), device=dev),
        torch.as_tensor(np.asarray(overflow, bool), device=dev),
        torch.as_tensor(np.asarray(ev, np.int32), device=dev))


def state_to_numpy(state: MSAState) -> Tuple[np.ndarray, ...]:
    return tuple(x.cpu().numpy() for x in state)


# ------------------------------------------------------------- kernels --


# profile_dp's kernels, indices of csrc/profile_dp.cu's routes (its host
# query profile_dp_route answers with them; profile_dp_on runs either)
DP_ROUTES = ("strips", "band")
BAND_WIDTHS = (128, 256, 512)   # the band kernel's W


def dp_route(W: Optional[int]) -> str:
    """The kernel profile_dp launches at band width W (None: full width):
    the band kernel on the band rungs (BAND_WIDTHS) of every bucket, the
    strips at full width and on every other W (csrc/profile_dp.cu:
    dp_route)."""
    return "band" if W in BAND_WIDTHS else "strips"


def profile_dp(unit, qlen, ncol, sub, wl, wdel, wl2, wdel2, costs,
               W: Optional[int] = None,
               kernel: Optional[str] = None) -> torch.Tensor:
    """Direction plane of one unit round: [2T-1, B, T] (W None, full
    width) or [2T-1, B, W] with lane = (c-1) - band_base(r).  Rows at or
    past a problem's qlen + ncol - 1 are unspecified.

    unit [B, LQ] uint8 (LQ >= qlen), sub [B, 5, T], wl/wdel/wl2/wdel2
    [B, T] and qlen/ncol [B] int32; costs = (oi, ei, od, oi2, ei2, od2).

    On the card (csrc/profile_dp.cu) the kernel is dp_route(W)'s: the
    band rungs W = 128/256/512 of every bucket take profile_dp_band (a CTA
    a region, one band lane a thread over W / 32 warps, the profile in
    shared memory); full width at every T and any other W take
    profile_dp_strip (warps own strips of 32 x L columns, over one CTA or
    a cluster of up to 8; L = 4 up to T = 128, else 2).  Each launch
    counts on K.PROFILE_DP under its route.  kernel "first" runs
    profile_dp_kernel, the first port, and a name of DP_ROUTES that
    route's kernel (the band kernel at W in BAND_WIDTHS), at any shape:
    the yardsticks chip_smoke.py times the routes against."""
    B, LQ = unit.shape
    T = sub.shape[2]
    if unit.dtype != torch.uint8:
        raise TypeError("unit must be uint8")
    if sub.shape != (B, 5, T) or any(
            x.shape != (B, T) for x in (wl, wdel, wl2, wdel2)):
        raise ValueError("sub must be [B, 5, T] and the weights [B, T]")
    if any(x.dtype != torch.int32
           for x in (sub, wl, wdel, wl2, wdel2, qlen, ncol)):
        raise TypeError("scores, weights and lengths must be int32")
    if W is not None and not 8 < W < T:
        raise ValueError(f"band window {W} must lie in (8, T={T})")
    if kernel not in (None, "first", *DP_ROUTES):
        raise ValueError(f"unknown profile_dp kernel {kernel!r}")
    if kernel == "band" and W not in BAND_WIDTHS:
        raise ValueError(f"the {kernel} kernel takes W in {BAND_WIDTHS}")
    if unit.device.type == "cpu":
        return profile_dp_plain(unit, qlen, ncol, sub, wl, wdel, wl2,
                                wdel2, costs, W)
    if unit.device.type != "cuda":
        raise ValueError(f"unsupported device {unit.device}")
    if T > BUCKETS[-1]:
        raise ValueError(f"profile_dp serves the MSA buckets, T <= "
                         f"{BUCKETS[-1]}: wider regions take the host rule, "
                         f"and the first version keeps its rows in shared "
                         f"memory")
    args = [x.contiguous() for x in (unit, sub, wl, wdel, wl2, wdel2,
                                     qlen, ncol)]
    dirs = torch.empty((2 * T - 1, B, W or T), dtype=torch.uint8,
                       device=unit.device)
    ptrs = (args[0].data_ptr(), LQ, *(a.data_ptr() for a in args[1:]), B,
            T, W or 0, *(int(c) for c in costs), dirs.data_ptr())
    if kernel is None:
        K.PROFILE_DP(unit.device, *ptrs, route=dp_route(W))
    elif kernel == "first":
        K.PROFILE_DP_FIRST(unit.device, *ptrs)
    else:
        K.PROFILE_DP_ON(unit.device, DP_ROUTES.index(kernel), *ptrs)
    return dirs


def profile_bt(dirs, qlen, ncol, T: int, W: Optional[int] = None):
    """(ops [B, NL] int8, nst [B] int32, tch [B] int32) from a direction
    plane; see csrc/profile_bt.cu for the layout."""
    B = qlen.shape[0]
    if dirs.dtype != torch.uint8 or dirs.shape != (2 * T - 1, B, W or T):
        raise ValueError("dirs must be uint8 [2T-1, B, W or T]")
    if qlen.dtype != torch.int32 or ncol.dtype != torch.int32:
        raise TypeError("qlen and ncol must be int32")
    if dirs.device.type == "cpu":
        return profile_bt_plain(dirs, qlen, ncol, T, W)
    if dirs.device.type != "cuda":
        raise ValueError(f"unsupported device {dirs.device}")
    NL = n_levels(T)
    dirs, qlen, ncol = (x.contiguous() for x in (dirs, qlen, ncol))
    if dirs.data_ptr() % 16:   # the kernel copies 16-byte pieces of rows
        dirs = dirs.clone()
    ops = torch.empty((B, NL), dtype=torch.int8, device=dirs.device)
    nst = torch.empty(B, dtype=torch.int32, device=dirs.device)
    tch = torch.empty(B, dtype=torch.int32, device=dirs.device)
    K.PROFILE_BT(dirs.device, dirs.data_ptr(), B, T, W or 0,
                 qlen.data_ptr(), ncol.data_ptr(), NL, ops.data_ptr(),
                 nst.data_ptr(), tch.data_ptr())
    return ops, nst, tch


def profile_dp_plain(unit, qlen, ncol, sub, wl, wdel, wl2, wdel2, costs,
                     W):
    """Plain version of profile_dp: _dp_one_row (msa_device.py:142-236)
    over full-width [B, T] rows; the banded form adds the band mask and
    the NEG predecessor masks (msa_device.py:364-373) and cuts each row's
    window out of the full row."""
    oi, ei, od, oi2, ei2, od2 = (int(c) for c in costs)
    B, LQ = unit.shape
    T = sub.shape[2]
    dev = unit.device
    wb = (W or 0) - 8
    ti = torch.arange(T, device=dev, dtype=torch.int32)[None, :]
    Lq = qlen[:, None]
    Tn = ncol[:, None]
    dirs = torch.zeros((2 * T - 1, B, W or T), dtype=torch.uint8,
                       device=dev)
    nrows = int((qlen + ncol).max()) - 1 if B else 0
    upad = torch.cat([unit.int(), torch.full((B, 2 * T), 4,
                                             dtype=torch.int32, device=dev)],
                     dim=1)
    neg = torch.full((B, T), NEG, dtype=torch.int32, device=dev)
    Hs = [neg.clone(), neg.clone()]     # by row parity
    E1s, E2s, F1s, F2s, Gs = (neg.clone() for _ in range(5))
    zcol = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    wl_sh = torch.cat([zcol, wl[:, :-1]], dim=1)
    wl2_sh = torch.cat([zcol, wl2[:, :-1]], dim=1)
    del_top = torch.maximum(-(od + wl), -(od2 + wl2))       # j - 1 == 0
    del_top_sh = torch.maximum(-(od + wl_sh), -(od2 + wl2_sh))

    def ins0(g):
        return max(-(oi + g * ei), -(oi2 + g * ei2))

    def roll(x):
        return torch.roll(x, 1, 1)

    for r in range(nrows):
        j = r - ti
        qb = torch.where(j >= 0, upad.gather(
            1, j.clamp(min=0).expand(B, -1)), 4)
        s = sub.gather(1, qb[:, None, :].long())[:, 0, :]
        mask = (ti <= r) & (ti >= r - Lq + 1) & (ti < Tn) & (r < Lq + Tn - 1)
        is_r = ti == r
        e_fresh = is_r
        f_fresh = ti == 0
        if W:
            off = 2 * ti - r
            mask = mask & (off.abs() <= wb)
            m_up = (off + 1).abs() <= wb
            m_dl = (off - 1).abs() <= wb
            e_fresh = e_fresh | ~m_up
            f_fresh = f_fresh | ~m_dl
        hp2, hp = Hs[r & 1], Hs[(r & 1) ^ 1]
        hm = torch.where(ti == 0, ins0(r), roll(hp2))
        hm = torch.where(is_r, torch.where(ti == 0, 0, del_top_sh), hm)
        M = hm + s

        h_up = torch.where(is_r, del_top, hp)
        if W:
            h_up = torch.where(m_up, h_up, NEG)
        e_up = torch.where(e_fresh, NEG, E1s)
        e_open = h_up - oi - ei
        e_cont = e_up - ei
        E1 = torch.maximum(e_open, e_cont)
        icont1 = e_cont > e_open
        e2_up = torch.where(e_fresh, NEG, E2s)
        e2_open = h_up - oi2 - ei2
        e2_cont = e2_up - ei2
        E2 = torch.maximum(e2_open, e2_cont)
        icont2 = e2_cont > e2_open
        E = torch.maximum(E1, E2)
        isel2 = E2 > E1

        g_sh = torch.where(ti == 0, ins0(r + 1), roll(Gs))
        if W:
            g_sh = torch.where(m_dl, g_sh, NEG)
        f_sh = torch.where(f_fresh, NEG, roll(F1s))
        F1 = torch.maximum(g_sh - od, f_sh) - wdel
        fcont1 = f_sh >= g_sh - od
        f2_sh = torch.where(f_fresh, NEG, roll(F2s))
        F2 = torch.maximum(g_sh - od2, f2_sh) - wdel2
        fcont2 = f2_sh >= g_sh - od2
        Fm = torch.maximum(F1, F2)
        fsel2 = F2 > F1

        G = torch.maximum(M, E)
        H = torch.maximum(G, Fm)
        sel = torch.where(Fm > G, 2, torch.where(E > M, 1, 0))
        d = (sel | (icont1.int() << 2) | (fcont1.int() << 3)
             | (isel2.int() << 4) | (fsel2.int() << 5)
             | (icont2.int() << 6) | (fcont2.int() << 7))
        Hs[r & 1] = torch.where(mask, H, hp2)
        E1s = torch.where(mask, E1, E1s)
        E2s = torch.where(mask, E2, E2s)
        F1s = torch.where(mask, F1, F1s)
        F2s = torch.where(mask, F2, F2s)
        Gs = torch.where(mask, G, Gs)
        drow = torch.where(mask, d, 0).to(torch.uint8)
        if W:
            base = band_base(r, T, W)
            dirs[r] = drow[:, base:base + W]
        else:
            dirs[r] = drow
    return dirs


def profile_bt_plain(dirs, qlen, ncol, T, W):
    """Plain version of profile_bt: the lockstep level walk of
    _make_bt_kernel (msa_device.py:479-578), every problem advancing at
    the levels where j + c == L."""
    B = qlen.shape[0]
    dev = dirs.device
    Wd = W or T
    wb = (W or 0) - 8
    NL = n_levels(T)
    ops = torch.full((B, NL), OP_PAD, dtype=torch.int8, device=dev)
    j = qlen.clone()
    c = ncol.clone()
    mode = torch.full((B,), -1, dtype=torch.int32, device=dev)
    m = torch.zeros(B, dtype=torch.int32, device=dev)
    tch = torch.zeros(B, dtype=torch.int32, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    for L in range(2 * T, 0, -1):
        act = (j + c == L) & ((j > 0) | (c > 0))
        if not bool(act.any()):
            continue
        r = L - 2
        val = zero
        if r >= 0:
            lane = c - 1 - (band_base(r, T, W) if W else 0)
            ok = (j > 0) & (c > 0) & (lane >= 0) & (lane < Wd)
            got = dirs[r].gather(1, lane.clamp(0, Wd - 1)[:, None].long())
            val = torch.where(ok, got[:, 0].int(), zero)
        d = val & 3
        icont1, fcont1 = (val >> 2) & 1, (val >> 3) & 1
        isel2, fsel2 = (val >> 4) & 1, (val >> 5) & 1
        icont2, fcont2 = (val >> 6) & 1, (val >> 7) & 1
        in_run = mode > 0
        run_is_i = in_run & ((mode == 1) | (mode == 3))
        run_is_d = in_run & ((mode == 2) | (mode == 4))
        sel = torch.where(run_is_i, 1, torch.where(run_is_d, 2, d))
        sel = torch.where(j == 0, 2, torch.where(c == 0, 1, sel))
        is_m, is_i, is_d = sel == 0, sel == 1, sel == 2
        idx = (NL - 1 - m).long()[:, None]
        cur = ops.gather(1, idx)
        ops.scatter_(1, idx, torch.where(act[:, None], sel[:, None].to(
            torch.int8), cur))
        if W:
            tch = torch.where(act & ((c - j).abs() >= wb - 8), 1, tch)
        i_trk2 = torch.where(in_run, (mode == 3).int(), isel2)
        d_trk2 = torch.where(in_run, (mode == 4).int(), fsel2)
        icont = torch.where(i_trk2 == 1, icont2, icont1)
        fcont = torch.where(d_trk2 == 1, fcont2, fcont1)
        nmode = torch.where(
            is_m, -1,
            torch.where(
                is_i,
                torch.where(icont == 1, torch.where(i_trk2 == 1, 3, 1), -1),
                torch.where(fcont == 1, torch.where(d_trk2 == 1, 4, 2), -1)))
        j = torch.where(act, j - (is_m | is_i).int(), j)
        c = torch.where(act, c - (is_m | is_d).int(), c)
        mode = torch.where(act, nmode, mode)
        m = m + act.int()
    return ops, m, tch


# ---------------------------------------------------------- region batches --


class DeviceMSA:
    """Batched profile-POA over bucketed (T, W) region batches."""

    def __init__(self, match, mismatch, gap_open, gap_ext, polish=0,
                 gap_open2=None, gap_ext2=None, buckets=BUCKETS,
                 device="cuda", mesh=None):
        """polish: frozen-layout refinement passes after the sequential
        one (bit-exact with profile_consensus(..., polish=polish)).
        mesh: a parallel.mesh.Mesh whose devices each take a contiguous
        block of every region batch (the regions are independent); None
        runs every batch on `device`."""
        self.buckets = tuple(sorted(buckets))
        self.polish = polish
        self.mesh = None if mesh is None else PM.Mesh(mesh)
        self.device = torch.device(device) if mesh is None else self.mesh[0]
        self._devices = self.mesh or (self.device,)
        if gap_open2 is None:
            # single affine: track 2 strictly dominated within any bucket
            gap_open2 = gap_open + gap_ext * (2 * self.buckets[-1] + 2)
            gap_ext2 = gap_ext
        self.match, self.mismatch = match, mismatch
        self.gap_ext, self.gap_ext2 = gap_ext, gap_ext2
        self.costs = (SCALE * gap_open, SCALE * gap_ext, SCALE * gap_open,
                      SCALE * gap_open2, SCALE * gap_ext2, SCALE * gap_open2)

    def _bucket(self, n: int):
        for b in self.buckets:
            if n <= b:
                return b
        return None

    @staticmethod
    def batch_rows(T: int, W: Optional[int]) -> int:
        return max(1, DIRS_BUDGET // ((2 * T - 1) * (W or T)))

    # --- the steps of one unit round (msa_device._build_jits) ---

    def init_state(self, units, ulen) -> MSAState:
        """Profile of unit 0: one-hot counts over its first ulen columns."""
        B, _, T = units.shape
        ci = torch.arange(T, device=units.device)[None, :]
        fl = ulen[:, 0]
        oh = F.one_hot(units[:, 0, :].long(), 5).to(torch.int16)
        counts = torch.where((ci < fl[:, None])[:, :, None], oh,
                             torch.zeros_like(oh))
        return MSAState(
            counts, torch.ones(B, dtype=torch.int32, device=units.device),
            fl.int(), torch.zeros(B, dtype=torch.bool, device=units.device),
            torch.zeros(B, dtype=torch.int32, device=units.device))

    def scores_step(self, state: MSAState):
        """(sub [B,5,T], wdel, wl, wdel2, wl2 [B,T]) — Profile.sub_scores
        and del_weights in fixed point, floor division as in NumPy."""
        counts = state.counts.int()
        B, T, _ = counts.shape
        ci = torch.arange(T, device=counts.device)[None, :]
        live = ci < state.ncol[:, None]
        occ = counts.sum(dim=2, dtype=torch.int32)
        occ1 = occ.clamp(min=1)
        raw = SCALE * ((self.match + self.mismatch) * counts
                       - self.mismatch * occ1[:, :, None])
        sub = torch.div(raw, occ1[:, :, None], rounding_mode="floor")
        sub = torch.where(live[:, :, None], sub, -SCALE * 64)
        sub = sub.permute(0, 2, 1).contiguous().int()
        npl = state.n_placed.clamp(min=1)[:, None]
        out = [sub]
        for ge in (self.gap_ext, self.gap_ext2):
            wdel = torch.div(SCALE * ge * occ, npl, rounding_mode="floor")
            wdel = torch.where(live, wdel, 0).int()
            out += [wdel, torch.cumsum(wdel, dim=1, dtype=torch.int32)]
        return tuple(out)

    @staticmethod
    def update_step(state: MSAState, unit, active, ops, nst):
        """(counts, n_placed, ncol, overflow) after placing the unit along
        its compacted ops: forward step p is profile column p, so the
        update is the gather counts[col(p) - 1] plus the unit's one-hot."""
        counts = state.counts
        B, T, _ = counts.shape
        NP = ops.shape[1]
        posT = torch.arange(T, device=counts.device)[None, :]
        nst1 = nst[:, None]
        src = (posT + (NP - nst1)).clamp(0, NP - 1)
        op = ops.gather(1, src.long()).int()
        valid = (posT < nst1) & active[:, None]
        consumes_c = valid & (op != OP_I)
        consumes_q = valid & (op != OP_D)
        col = torch.cumsum(consumes_c, dim=1, dtype=torch.int32)
        qp = torch.cumsum(consumes_q, dim=1, dtype=torch.int32) - 1
        base = unit.gather(1, qp.clamp(0, unit.shape[1] - 1).long()).long()
        base = torch.where(consumes_q, base, 5)
        onehot = F.one_hot(base, 6)[:, :, :5].to(torch.int16)
        colz = (col - 1).clamp(0, T - 1).long()
        old = counts.gather(1, colz[:, :, None].expand(-1, -1, 5))
        old = torch.where(consumes_c[:, :, None], old, 0).to(torch.int16)
        new = old + torch.where(valid[:, :, None], onehot, 0).to(torch.int16)
        counts2 = torch.where(active[:, None, None], new, counts)
        ncol2 = torch.where(active, nst.clamp(max=T), state.ncol)
        overflow2 = state.overflow | (active & (nst > T))
        n_placed2 = state.n_placed + active.int()
        return counts2, n_placed2, ncol2, overflow2

    @staticmethod
    def polish_update(votes, ncol, active, unit, ops, nst):
        """votes [B, T, 5] int16 plus the match votes of one realigned
        unit (msa_device.polish_update): only M steps into existing
        columns count, the compacted ops realigned to forward order over
        their full width (a step past T can still vote into a column
        below T), the destination clamped to T (dropped).  ncol is unused,
        as in the JAX function.  The scatter-add runs in int32 (int16 has
        no scatter-add on every device) and casts back: a vote count never
        exceeds the unit count."""
        B, T, _ = votes.shape
        NP = ops.shape[1]
        pos = torch.arange(NP, device=votes.device)[None, :]
        nst1 = nst.reshape(B, 1)
        src = (pos + (NP - nst1)).clamp(0, NP - 1)
        op = ops.gather(1, src.long()).int()
        valid = (pos < nst1) & active[:, None]
        consumes_c = valid & (op != OP_I)
        consumes_q = valid & (op != OP_D)
        col = torch.cumsum(consumes_c, dim=1, dtype=torch.int32) - 1
        qp = torch.cumsum(consumes_q, dim=1, dtype=torch.int32) - 1
        is_m = valid & (op == OP_M)
        base = unit.gather(1, qp.clamp(0, unit.shape[1] - 1).long()).long()
        onehot = F.one_hot(torch.where(is_m, base, 5), 6)[:, :, :5].int()
        dest = torch.where(is_m & (col < T), col, T).long()
        padded = torch.zeros((B, T + 1, 5), dtype=torch.int32,
                             device=votes.device)
        padded.scatter_add_(1, dest[:, :, None].expand(-1, -1, 5), onehot)
        return (votes.int() + padded[:, :T]).to(torch.int16)

    def _align(self, state: MSAState, unit, qlen, T: int,
               W: Optional[int]):
        """Scores, DP and backtrack of one unit against the profile."""
        sub, wdel, wl, wdel2, wl2 = self.scores_step(state)
        dirs = profile_dp(unit, qlen, state.ncol, sub, wl, wdel, wl2, wdel2,
                          self.costs, W)
        if W is None:
            METRICS.add("msa_full_rounds")
        return (dirs, *profile_bt(dirs, qlen, state.ncol, T, W))

    def round(self, state: MSAState, unit, qlen, active, T: int,
              W: Optional[int] = None) -> RoundOut:
        """One unit round; W set runs the banded window and threads the
        ev first-event state (touch before overflow within a round)."""
        dirs, ops, nst, tch = self._align(state, unit, qlen, T, W)
        counts, n_placed, ncol, overflow = self.update_step(
            state, unit, active, ops, nst)
        ev = state.ev
        if W is not None:
            touched = (tch > 0) & active
            ovf_new = overflow & ~state.overflow
            ev = torch.where(ev != 0, ev, torch.where(
                touched, 1, torch.where(ovf_new, 2, 0))).int()
        return RoundOut(MSAState(counts, n_placed, ncol, overflow, ev),
                        dirs, ops, nst, tch)

    def polish_round(self, state: MSAState, votes, unit, qlen, active,
                     T: int, W: Optional[int] = None):
        """(votes, ev) after one unit of a polish pass: the unit aligned
        against the frozen state, its match votes added; on a band rung
        ev records a touch only (polish_round_fn)."""
        _dirs, ops, nst, tch = self._align(state, unit, qlen, T, W)
        votes = self.polish_update(votes, state.ncol, active, unit, ops, nst)
        ev = state.ev
        if W is not None:
            ev = torch.where(ev != 0, ev, ((tch > 0) & active).int())
        return votes, ev

    @staticmethod
    def consensus_step(state: MSAState):
        """(best, coverage, keep) per column: majority base, column kept
        when its best count beats the gaps (abPOA RC contract)."""
        counts = state.counts.int()
        T = counts.shape[1]
        ci = torch.arange(T, device=counts.device)[None, :]
        best = counts.argmax(dim=2)
        bc = counts.max(dim=2).values
        gaps = state.n_placed[:, None] - counts.sum(dim=2)
        keep = (bc > gaps) & (ci < state.ncol[:, None])
        return best, bc, keep

    # --- region batches (msa_device.DeviceMSA.consensus_batch) ---

    def consensus_batch(
        self, regions: List[List[np.ndarray]]
    ) -> List[Optional[Tuple[np.ndarray, np.ndarray]]]:
        """[(cons_bases, coverage)] per region; None for a region past the
        largest bucket (the caller resolves it on the host)."""
        out: List = [None] * len(regions)
        spread = [max(map(len, u)) - min(map(len, u)) for u in regions]
        # (region, column need with the 1.2x growth margin, band rung)
        todo = [(ri, int(max(map(len, u)) * 1.2) + 8, 0)
                for ri, u in enumerate(regions)]
        while todo:
            by_bucket = {}
            for ri, need, rung in todo:
                b = self._bucket(need)
                if b is not None:
                    rungs = band_ladder(b, spread[ri])
                    W = rungs[min(rung, len(rungs) - 1)]
                    by_bucket.setdefault((b, W), []).append((ri, rung))
            todo = []
            for (T, W), entries in by_bucket.items():
                step = self.batch_rows(T, W) * len(self._devices)
                for lo in range(0, len(entries), step):
                    part = entries[lo:lo + step]
                    res = self._run_batch([regions[i] for i, _ in part],
                                            T, W)
                    for (i, rung), r in zip(part, res):
                        if r is None:
                            METRICS.add("msa_retry_ovf")
                            todo.append((i, T + 1, 0))
                        elif isinstance(r, str):
                            METRICS.add("msa_retry_touch")
                            todo.append((i, T, rung + 1))
                        else:
                            out[i] = r
        return out

    def _run_batch(self, regs, T: int, W: Optional[int]):
        """A region batch split into contiguous blocks over the mesh: every
        block's rounds are queued on its device, then every block's pull
        is issued before any is waited for, so the devices overlap."""
        pulls = []
        for dev, (lo, hi) in zip(self._devices, PM.row_blocks(
                len(regs), len(self._devices))):
            with PM.on_device(dev):
                pulls.append(PM.pull_async(
                    self._launch_batch(regs[lo:hi], T, W, dev)))
        res = []
        for pull in pulls:
            res += self._results(*pull(), T, W)
        return res

    def _launch_batch(self, regs, T: int, W: Optional[int], dev):
        """Every unit round of one region batch queued on dev: (best, bc,
        keep, overflow, ev) there."""
        B = len(regs)
        U = max(len(units) for units in regs)
        units_arr = np.full((B, U, T), 4, np.uint8)
        ulen = np.zeros((B, U), np.int32)
        nunits = np.array([len(units) for units in regs], np.int32)
        for i, units in enumerate(regs):
            for k, u in enumerate(units):
                n = min(len(u), T)
                units_arr[i, k, :n] = u[:n]
                ulen[i, k] = max(1, n)
        units_d = torch.as_tensor(units_arr, device=dev)
        ulen_d = torch.as_tensor(ulen, device=dev)
        nunits_d = torch.as_tensor(nunits, device=dev)
        state = self.init_state(units_d, ulen_d)
        METRICS.add("msa_batches")
        METRICS.add("msa_cells",
                    float(B) * T * (W or T) * (U - 1 + self.polish * U))
        one = torch.ones(B, dtype=torch.int32, device=dev)

        def gather(k):
            active = k < nunits_d
            return (units_d[:, k], torch.where(active, ulen_d[:, k], one),
                    active)

        for k in range(1, U):
            state = self.round(state, *gather(k), T, W).state
        for _ in range(self.polish):
            # every unit, the first too, against the same frozen counts
            votes = torch.zeros_like(state.counts)
            ev = state.ev
            for k in range(U):
                votes, ev = self.polish_round(state._replace(ev=ev), votes,
                                              *gather(k), T, W)
            state = state._replace(counts=votes,
                                   n_placed=nunits_d.int(), ev=ev)
        return (*self.consensus_step(state), state.overflow, state.ev)

    @staticmethod
    def _results(best, bc, keep, ovf, ev, T: int, W: Optional[int]):
        res = []
        for i in range(len(best)):
            if W is not None and ev[i] == 1:
                res.append("touch")      # band edge: next rung
            elif (W is not None and ev[i] == 2) or ovf[i]:
                res.append(None)         # overflow: bucket up
            else:
                res.append((best[i][keep[i]].astype(np.uint8),
                            bc[i][keep[i]].astype(np.int64)))
        return res
