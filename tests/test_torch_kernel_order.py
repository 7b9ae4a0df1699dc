"""Index maps of the port's warp kernels, written once in NumPy.

csrc/wavefront.cu's ``wf_global`` and csrc/profile_dp.cu's banded
``profile_dp_warp`` compute the same integers as their plain versions in
another order: a warp of 32 lanes per problem, state in registers, values
crossing lanes by shuffles.  The models below follow that schedule step by
step (lane lag, column tiles, the edge column carried between tiles; the
band window held as 32 lanes x W/32 registers and shifted per row), so an
index slip shows here on the CPU before the card runs the kernel.  Each
model must equal the port's plain version and the JAX package's Pallas
kernel in interpret mode.  Tolerance: exact integer equality.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tidehunter_tpu.ops import msa_device as MD
from tidehunter_tpu.ops import wavefront as WF
from tidehunter_tpu_torch.ops import msa_device as TMD
from tidehunter_tpu_torch.ops import wavefront as TW

torch.set_num_threads(1)

LANES = 32
B = 8
TLB, TLMASK = TW.TLB, TW.TLMASK
GAPS = dict(gap_open2=24, gap_ext2=1)


# ------------------------------------------------------------------ K1 --


def _diff_core(qv, tv, u_b, y_b, v_sh, x_sh, scores):
    """diff_core of csrc/wavefront.cu on arrays."""
    match, mis, go, ge = scores
    qe2 = 2 * (go + ge)
    s = np.where((tv == 4) | (qv == 4), -ge, np.where(tv == qv, match, mis))
    a = x_sh + v_sh
    b = y_b + u_b
    z = s + qe2
    d = (a > z).astype(np.int64)
    z = np.maximum(z, a)
    d = np.where(b > z, 2, d)
    z = np.minimum(np.maximum(z, b), match + qe2)
    a2 = a - (z - go)
    b2 = b - (z - go)
    return (z - v_sh, z - u_b, np.maximum(a2, 0), np.maximum(b2, 0), d,
            a2 > 0, b2 > 0)


def _shfl_up(x):
    """__shfl_up_sync(x, 1) over the lane axis: lane 0 keeps its own."""
    return np.concatenate([x[:, :1], x[:, :-1]], axis=1)


def wf_global_model(q, qlen, t, tlen, qle, C, with_tl,
                    scores=TW.DEFAULT_SCORES):
    """(iden, tleft) by wf_global's schedule: lane k owns columns
    [t0 + k C, t0 + k C + C) of each 32 C-wide tile and computes query row
    i = s - k at step s; the strip's left edge at (i, c0 - 1) and the
    diagonal at (i - 1, c0 - 1) come from lane k - 1's previous two steps,
    lane 0's from the t = 0 boundary or the previous tile's edge column."""
    go = scores[2]
    qlen, tlen, qle = (np.asarray(x, np.int64) for x in (qlen, tlen, qle))
    nb = len(qlen)
    lane = np.arange(LANES)[None, :]
    ql, tl = qlen[:, None], tlen[:, None]
    jS = ql - np.maximum(qle[:, None], 1)
    has_q = qle[:, None] > 0
    tl_bound = (tl + 1) & TLMASK
    iden = np.full(nb, -1, np.int64)
    tleft = np.full(nb, -1, np.int64)
    edge = np.zeros((nb, q.shape[1], 4), np.int64)   # v, x, a1, a0 per row
    TWd = LANES * C
    for t0 in range(0, int(tlen.max()), TWd):
        on = t0 < tl                                   # problem has the tile
        last = t0 + TWd >= tl
        c0 = t0 + lane * C
        nl = np.minimum(31, (tl - 1 - t0) // C)
        cols = c0[..., None] + np.arange(C)            # [1, 32, C]
        tv = np.where(cols < tl[..., None],
                      t[np.arange(nb)[:, None, None],
                        np.minimum(cols, t.shape[1] - 1)], 4)
        U = np.broadcast_to(np.where(cols > 0, go, 0), tv.shape).copy()
        Y, A0, A2 = (np.zeros(tv.shape, np.int64) for _ in range(3))
        l_v, l_x, l_a1, l_a0, dg, qv = (np.zeros((nb, LANES), np.int64)
                                        for _ in range(6))
        qv += 4
        for s in range(int((ql + nl)[on[:, 0]].max())):
            i = s - lane
            qv[:, 0] = np.where(s < qlen, q[:, min(s, q.shape[1] - 1)], 4)
            if t0 == 0:
                i0 = i[:, 0]
                l_v[:, 0] = np.where(i0 > 0, go, 0)
                l_x[:, 0] = 0
                l_a1[:, 0] = np.where(with_tl & (jS[:, 0] <= i0),
                                      tl_bound[:, 0], 0)
                dg[:, 0] = np.where(with_tl & (i0 > 0) & (jS[:, 0] <= i0 - 1),
                                    tl_bound[:, 0], 0)
            else:
                e = edge[:, min(s, edge.shape[1] - 1)]
                rd = s < qlen
                for reg, k in ((l_v, 0), (l_x, 1), (l_a1, 2), (l_a0, 3)):
                    reg[:, 0] = np.where(rd, e[:, k], reg[:, 0])
            act = (i >= 0) & (i < ql) & (c0 < tl) & on
            vl, xl, a1l, dgl = l_v.copy(), l_x.copy(), l_a1.copy(), dg.copy()
            for c in range(C):
                tc = c0 + c
                u, v, x, y, d, b08, b10 = _diff_core(
                    qv, tv[:, :, c], U[:, :, c], Y[:, :, c], vl, xl, scores)
                eq = (qv == tv[:, :, c]).astype(np.int64)
                a2p = A2[:, :, c]
                if with_tl:
                    is_jS = i == jS
                    set_m = (np.where(has_q, tl - tc, tl - 1 - tc)
                             + 1) & TLMASK
                    set_i = (np.where(has_q, tl - tc - 1, tl - 1 - tc)
                             + 1) & TLMASK
                    M = (((dgl >> TLB) + eq) << TLB) | np.where(
                        is_jS, set_m, dgl & TLMASK)
                    I = (a2p & ~TLMASK) | np.where(is_jS, set_i, a2p & TLMASK)
                else:
                    M, I = dgl + eq, a2p
                D = a1l
                a0 = np.where(d == 0, M, np.where(d == 1, D, I))
                dgl = np.where(act, A0[:, :, c], dgl)
                for arr, new in ((U, u), (Y, y), (A0, a0),
                                 (A2, np.where(b10, I, a0))):
                    arr[:, :, c] = np.where(act, new, arr[:, :, c])
                vl = np.where(act, v, vl)
                xl = np.where(act, x, xl)
                a1l = np.where(act, np.where(b08, D, a0), a1l)
                hit = act & (i == ql - 1) & (tc == tl - 1)
                for b, k in zip(*np.nonzero(hit)):
                    iden[b] = a0[b, k] >> TLB if with_tl else a0[b, k]
                    tleft[b] = (tlen[b] if qle[b] > qlen[b] else
                                (a0[b, k] & TLMASK) - 1) if with_tl else 0
            out = act & ~last & (lane == 31)
            for b, k in zip(*np.nonzero(out)):
                edge[b, s - k] = (vl[b, k], xl[b, k], a1l[b, k],
                                  A0[b, k, C - 1])
            dg = l_a0
            l_v, l_x, l_a1 = _shfl_up(vl), _shfl_up(xl), _shfl_up(a1l)
            l_a0, qv = _shfl_up(A0[:, :, C - 1]), _shfl_up(qv)
    return iden, tleft


def _pairs(seed, LQ, T):
    """B problems: (1,1), (LQ,T), (1,T), (LQ,1), then random lengths;
    related pairs, codes 0..4; qle over 0..qlen+1."""
    rng = np.random.default_rng(seed)
    q = np.full((B, LQ), 4, np.uint8)
    t = np.full((B, T), 4, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        m, n = [(1, 1), (LQ, T), (1, T), (LQ, 1)][b] if b < 4 else (
            int(rng.integers(1, LQ + 1)), int(rng.integers(1, T + 1)))
        base = rng.integers(0, 5, max(m, n)).astype(np.uint8)
        q[b, :m] = np.where(rng.random(m) < 0.8, base[:m],
                            rng.integers(0, 5, m))
        t[b, :n] = np.where(rng.random(n) < 0.8, base[:n],
                            rng.integers(0, 5, n))
        qlen[b], tlen[b] = m, n
    qle = np.array([[0, qlen[b], qlen[b] + 1, 1][b % 4] if b < 4 else
                    int(rng.integers(0, qlen[b] + 2)) for b in range(B)],
                   np.int32)
    return q, qlen, t, tlen, qle


@pytest.mark.parametrize("with_tl", [False, True], ids=["iden_only", "tleft"])
@pytest.mark.parametrize("C,LQ,T", [(1, 20, 96), (2, 17, 96), (4, 24, 160),
                                    (4, 12, 128), (3, 9, 70)])
def test_wf_global_schedule_matches_plain(C, LQ, T, with_tl):
    q, qlen, t, tlen, qle = _pairs(C * 100 + T, LQ, T)
    got = wf_global_model(q, qlen, t, tlen, qle, C, with_tl)
    want = TW.global_plain(*map(torch.from_numpy, (q, qlen, t, tlen, qle)),
                           TW.DEFAULT_SCORES, with_tl)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


def test_wf_global_schedule_matches_jax(monkeypatch):
    monkeypatch.setattr(WF, "INTERPRET", True)
    monkeypatch.setattr(WF, "_TILE_CELLS", 1024)   # tile_b -> 8 rows
    q, qlen, t, tlen, qle = _pairs(11, 16, 96)
    for with_tl in (False, True):
        got = wf_global_model(q, qlen, t, tlen, qle, 2, with_tl)
        jiden, jtl = WF.global_batch(q, qlen, t, tlen, qle,
                                     iden_only=not with_tl)
        np.testing.assert_array_equal(got[0], np.asarray(jiden))
        np.testing.assert_array_equal(got[1], np.asarray(jtl))


# ------------------------------------------------------------------ K4 --


def _shift_right(x):
    """x[e] <- x[e + 1] across [B, 32, L] (shfl_down for the last)."""
    nxt = np.concatenate([x[:, 1:, 0], x[:, -1:, 0]], axis=1)
    return np.concatenate([x[:, :, 1:], nxt[:, :, None]], axis=2)


def _shift_left(x):
    """x[e] <- x[e - 1] across [B, 32, L] (shfl_up for the first)."""
    prv = np.concatenate([x[:, :1, -1], x[:, :-1, -1]], axis=1)
    return np.concatenate([prv[:, :, None], x[:, :, :-1]], axis=2)


def profile_dp_model(unit, qlen, ncol, sub, wl, wdel, wl2, wdel2, costs, W):
    """Direction plane [2T-1, B, W] by profile_dp_warp's register window:
    lane k holds band lanes [k L, k L + L), L = W / 32; per row the state
    of row r-1 shifts right by one when band_base steps (the view at t),
    else rows r-1 and r-2 shift left by one (the view at t-1)."""
    oi, ei, od, oi2, ei2, od2 = (int(c) for c in costs)
    nb, T = wl.shape
    L = W // LANES
    wb = W - 8
    Lq, Tn = qlen[:, None].astype(np.int64), ncol[:, None].astype(np.int64)
    nrows = Lq[:, 0] + Tn[:, 0] - 1
    dirs = np.zeros((2 * T - 1, nb, W), np.uint8)
    neg = np.full((nb, LANES, L), TMD.NEG, np.int64)
    H1, H2, E1, E2, F1, F2, G = (neg.copy() for _ in range(7))
    rows = np.arange(nb)[:, None]

    def ins0(g):
        return max(-(oi + g * ei), -(oi2 + g * ei2))

    prev = 0
    for r in range(int(nrows.max())):
        base = TMD.band_base(r, T, W)
        if base != prev:
            H1, E1, E2 = map(_shift_right, (H1, E1, E2))
        else:
            G, F1, F2, H2 = map(_shift_left, (G, F1, F2, H2))
        prev = base
        flat = [x.reshape(nb, W) for x in (H1, H2, E1, E2, F1, F2, G)]
        h1, h2, e1, e2, f1, f2, g = flat
        ti = base + np.arange(W)[None, :]
        jq = r - ti
        off = 2 * ti - r
        live = (jq >= 0) & (jq < Lq) & (ti < Tn) & (np.abs(off) <= wb)
        m_up = np.abs(off + 1) <= wb
        m_dl = np.abs(off - 1) <= wb
        tc = np.minimum(ti, T - 1)
        qb = unit[rows, np.clip(jq, 0, unit.shape[1] - 1)].astype(np.int64)
        s = np.where(live, sub[rows, np.minimum(qb, 4), tc], 0)
        wl_t = np.where(live, wl[rows, tc], 0)
        wl2_t = np.where(live, wl2[rows, tc], 0)
        wd = np.where(live, wdel[rows, tc], 0)
        wd2 = np.where(live, wdel2[rows, tc], 0)
        sh = np.maximum(ti - 1, 0)
        wl_sh = np.where(live & (ti > 0), wl[rows, sh], 0)
        wl2_sh = np.where(live & (ti > 0), wl2[rows, sh], 0)

        hm = np.where(ti == r,
                      np.where(ti == 0, 0, np.maximum(-(od + wl_sh),
                                                      -(od2 + wl2_sh))),
                      np.where(ti == 0, ins0(r), h2))
        M = hm + s
        h_up = np.where(ti == r, np.maximum(-(od + wl_t), -(od2 + wl2_t)), h1)
        h_up = np.where(m_up, h_up, TMD.NEG)
        e_fresh = (ti == r) | ~m_up
        e_cont = np.where(e_fresh, TMD.NEG, e1) - ei
        nE1 = np.maximum(h_up - oi - ei, e_cont)
        icont1 = e_cont > h_up - oi - ei
        e2_cont = np.where(e_fresh, TMD.NEG, e2) - ei2
        nE2 = np.maximum(h_up - oi2 - ei2, e2_cont)
        icont2 = e2_cont > h_up - oi2 - ei2
        E = np.maximum(nE1, nE2)
        isel2 = nE2 > nE1
        g_sh = np.where(m_dl, np.where(ti == 0, ins0(r + 1), g), TMD.NEG)
        f_fresh = (ti == 0) | ~m_dl
        f_sh = np.where(f_fresh, TMD.NEG, f1)
        nF1 = np.maximum(g_sh - od, f_sh) - wd
        fcont1 = f_sh >= g_sh - od
        f2_sh = np.where(f_fresh, TMD.NEG, f2)
        nF2 = np.maximum(g_sh - od2, f2_sh) - wd2
        fcont2 = f2_sh >= g_sh - od2
        F = np.maximum(nF1, nF2)
        fsel2 = nF2 > nF1
        nG = np.maximum(M, E)
        sel = np.where(F > nG, 2, np.where(E > M, 1, 0))
        d = (sel | (icont1 << 2) | (fcont1 << 3) | (isel2 << 4)
             | (fsel2 << 5) | (icont2 << 6) | (fcont2 << 7))
        H2 = H1
        H1, E1, E2, F1, F2, G = (x.reshape(nb, LANES, L) for x in (
            np.maximum(nG, F), nE1, nE2, nF1, nF2, nG))
        written = r < nrows
        dirs[r, written] = np.where(live, d, 0)[written].astype(np.uint8)
    return dirs


def _round_inputs(seed, T, lens):
    """One unit round of B regions (unit 1 against the profile of unit 0)
    as NumPy arrays: unit, qlen, ncol, sub, wl, wdel, wl2, wdel2, costs."""
    rng = np.random.default_rng(seed)
    units = np.full((B, 2, T), 4, np.uint8)
    ulen = np.ones((B, 2), np.int32)
    for b, (n0, n1) in enumerate(lens):
        base = rng.integers(0, 4, max(n0, n1)).astype(np.uint8)
        for k, n in enumerate((n0, n1)):
            u = np.where(rng.random(n) < 0.9, base[:n], rng.integers(0, 4, n))
            units[b, k, :n] = u
            ulen[b, k] = n
    msa = TMD.DeviceMSA(2, 4, 4, 2, device="cpu", **GAPS)
    st = msa.init_state(torch.from_numpy(units), torch.from_numpy(ulen))
    sub, wdel, wl, wdel2, wl2 = msa.scores_step(st)
    return (units[:, 1], ulen[:, 1].copy(), st.ncol.numpy(),
            *(x.numpy() for x in (sub, wl, wdel, wl2, wdel2)), msa.costs,
            units[:, 0], ulen[:, 0].copy())


def _live(dirs, qlen, ncol, b):
    return dirs[:qlen[b] + ncol[b] - 1, b]


@pytest.mark.parametrize("T,W", [(96, 32), (96, 64), (160, 64)])
def test_profile_dp_window_matches_plain(T, W):
    # full-length pairs reach the T - W clamp of band_base; short and
    # uneven ones stay left of it
    lens = [(T, T), (T - 3, T), (T, T - 5), (1, T // 2), (T // 2, 1),
            (T // 3, T // 3 + 4), (T - 1, T - 9), (7, 9)]
    unit, qlen, ncol, sub, wl, wdel, wl2, wdel2, costs, _, _ = \
        _round_inputs(T + W, T, lens)
    assert max(qlen + ncol) - 2 >= 2 * (T - W) + W - 8 + 4   # clamp reached
    got = profile_dp_model(unit, qlen, ncol, sub, wl, wdel, wl2, wdel2,
                           costs, W)
    want = TMD.profile_dp_plain(
        *map(torch.from_numpy, (unit, qlen, ncol, sub, wl, wdel, wl2,
                                wdel2)), costs, W).numpy()
    for b in range(B):
        np.testing.assert_array_equal(_live(got, qlen, ncol, b),
                                      _live(want, qlen, ncol, b))


def test_profile_dp_window_matches_jax(monkeypatch):
    monkeypatch.setattr(MD, "INTERPRET", True)
    monkeypatch.setattr(MD, "_B_CAP", B)
    T, W = 256, 128
    lens = [(200, 190), (180, 185), (250, 256), (1, 120), (140, 150),
            (90, 60), (230, 240), (256, 256)]
    (unit, qlen, ncol, sub, wl, wdel, wl2, wdel2, costs, unit0,
     len0) = _round_inputs(5, T, lens)
    got = profile_dp_model(unit, qlen, ncol, sub, wl, wdel, wl2, wdel2,
                           costs, W)

    jm = MD.DeviceMSA(2, 4, 4, 2, **GAPS)
    run_dp, Bj, LQplus = jm._dp_run(T, W, B)
    assert Bj == B
    ci = np.arange(T)[None, :]
    counts = np.where((ci < len0[:, None])[:, :, None],
                      np.eye(5, dtype=np.int16)[unit0], 0).astype(np.int16)
    jc, jn, jcol = (jnp.asarray(counts), jnp.ones(B, jnp.int32),
                    jnp.asarray(ncol))
    ju, jq = jnp.asarray(unit.astype(np.int32)), jnp.asarray(qlen)
    jsub, jwdel, jwl, jwdel2, jwl2, qbuf = jm.scores_step(
        jc, jn, jcol, ju, lqplus=LQplus)
    np.testing.assert_array_equal(np.asarray(jsub), sub)
    maxr = jnp.max(jq + jcol).reshape(1, 1)
    jdirs = np.asarray(run_dp(maxr, qbuf, jsub, jwl, jwdel, jwl2, jwdel2,
                              jq.reshape(-1, 1), jcol.reshape(-1, 1)))
    for b in range(B):
        np.testing.assert_array_equal(_live(got, qlen, ncol, b),
                                      _live(jdirs, qlen, ncol, b))
