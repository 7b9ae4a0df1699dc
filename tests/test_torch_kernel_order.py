"""Index maps of the port's redesigned kernels, written once in NumPy.

csrc/wavefront.cu's ``wf_global`` (its warp and CTA kernels) and
``wf_ext``, csrc/profile_dp.cu's ``profile_dp_band`` and
``profile_dp_strip`` and csrc/profile_bt.cu's ``profile_bt_warp`` compute
the same integers as their plain versions in another order: state in
registers, values crossing lanes by shuffles, tiles prefetched into shared
memory.  The models below follow each schedule step by step (K1: lane lag,
column tiles, the edge column carried between tiles, or warps skewed by
rounds over the tiles with rings between them; K4: the band window held
one lane a thread over W/32 warps and shifted per row, edge words through
slots; K3: fixed column strips,
H by row parity, warps skewed by S rows with a ring of left columns,
asserting that every ring entry a live cell reads holds its row; K5: the
walk over a ring of prefetched tiles of rows, asserting that every byte it
reads lies in the tile prefetched for it; K2: L target lanes a thread,
warps skewed by S anti-diagonals, left neighbours by shuffle or the
previous warp's ring, each lane's best cell and the CTA's tie-order
epilogue), so an index slip shows here on the CPU
before the card runs the kernel.  Each model must equal the port's plain
version and the JAX package's Pallas kernel in interpret mode.
Tolerance: exact integer equality.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tidehunter_tpu.ops import msa_device as MD
from tidehunter_tpu.ops import wavefront as WF
from tidehunter_tpu_torch import _kernels as K
from tidehunter_tpu_torch.ops import msa_device as TMD
from tidehunter_tpu_torch.ops import wavefront as TW

torch.set_num_threads(1)

LANES = 32
B = 8
TLB, TLMASK = TW.TLB, TW.TLMASK
GAPS = dict(gap_open2=24, gap_ext2=1)


def _csrc(name: str, pattern: str) -> tuple:
    """Integers a kernel's source defines (the pattern's groups), read from
    csrc/ so that a model follows the kernel's own geometry."""
    m = re.search(pattern, (K.CSRC / name).read_text())
    assert m, f"{pattern!r} not in csrc/{name}"
    return tuple(int(g) for g in m.groups())


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


def _cta_consts():
    """wf_global_cta's steps a round, rounds of skew a warp and ring rows,
    read from csrc/wavefront.cu."""
    return tuple(_csrc("wavefront.cu", rf"constexpr int {n} = (\d+);")[0]
                 for n in ("CTA_S", "CTA_SKEW", "CTA_RB"))


class _Slots:
    """Edge rows of one problem's rings or wrap column: each slot keeps the
    (tile, row) it holds and the round that wrote it.  A read must find its
    own (tile, row), written in an earlier round; within a round no slot is
    read by one warp and written by another (the round's one barrier orders
    nothing inside it; inside one warp the write depends on the read
    through the lanes' shuffles)."""

    def __init__(self):
        self.vals, self.read_now, self.wrote_now = {}, {}, {}

    def round(self):
        for slot in self.read_now.keys() & self.wrote_now.keys():
            assert self.read_now[slot] == {self.wrote_now[slot]}, (
                "slot read and written", slot)
        self.read_now, self.wrote_now = {}, {}

    def put(self, slot, tag, n, val, warp):
        self.vals[slot] = (tag, n, val)
        self.wrote_now[slot] = warp

    def get(self, slot, tag, n, warp):
        got, wn, val = self.vals.get(slot, (None, None, None))
        assert got == tag and wn < n, (slot, got, tag, wn, n)
        self.read_now.setdefault(slot, set()).add(warp)
        return val


def wf_global_cta_model(q, qlen, t, tlen, qle, C, G, with_tl,
                        scores=TW.DEFAULT_SCORES):
    """(iden, tleft) by wf_global_cta's schedule, one problem at a time:
    G warps (over the CTAs of a cluster) own the column tiles g, g + G, ...;
    in round n warp g runs steps [(n - SKEW g - p P) S, + S) of its pass p
    tile, lane k computing row i = s - k of its strip (lane 0's query code
    and left edge at step s: the t = 0 boundary, or row s of the tile on
    its left from the warp's ring, warp 0's from the wrap column); lane 31
    writes row i of the tile's right edge to the right neighbour's ring of
    RB rows, the last warp to the wrap column.  Every slot read is held to
    the (tile, row) it must hold and to a write of an earlier round; iden
    and t_left come from the lane owning column tlen - 1 at row qlen - 1."""
    S, SKEW, RB = _cta_consts()
    go = scores[2]
    TWd = LANES * C
    lane = np.arange(LANES)
    iden = np.full(len(qlen), -1, np.int64)
    tleft = np.full(len(qlen), -1, np.int64)
    for b in range(len(qlen)):
        ql, tl, qe = int(qlen[b]), int(tlen[b]), int(qle[b])
        jS, has_q, tl_bound = ql - max(qe, 1), qe > 0, (tl + 1) & TLMASK
        nt = -(-tl // TWd)
        R0 = -(-(ql + 31) // S)
        P = max(SKEW * G, R0 + SKEW)
        npass = -(-nt // G)
        rounds = (npass - 1) * P + SKEW * (nt - 1 - (npass - 1) * G) + R0
        rings = [_Slots() for _ in range(G)]     # ring g: written by g - 1
        wrap = _Slots()
        st = [None] * G
        for n in range(rounds):
            for g in range(G - 1, -1, -1):       # any order inside a round
                local = n - SKEW * g
                if local < 0:
                    continue
                p, off = divmod(local, P)
                j = p * G + g
                if j >= nt or off >= R0:
                    continue
                t0 = j * TWd
                c0 = t0 + lane * C
                nl = min(31, (tl - 1 - t0) // C)
                last = t0 + TWd >= tl
                if off == 0:                     # the tile's first round
                    cols = c0[:, None] + np.arange(C)
                    st[g] = {
                        "tv": np.where(cols < tl, t[b, np.minimum(
                            cols, t.shape[1] - 1)], 4).astype(np.int64),
                        "U": np.where(cols > 0, go, 0).astype(np.int64),
                        **{k: np.zeros((LANES, C), np.int64)
                           for k in ("Y", "A0", "A2")},
                        **{k: np.zeros(LANES, np.int64)
                           for k in ("l_v", "l_x", "l_a1", "l_a0", "dg")},
                        "qv": np.full(LANES, 4, np.int64)}
                z = st[g]
                for s in range(off * S, off * S + S):
                    if s >= ql + nl:
                        continue
                    i = s - lane
                    z["qv"][0] = q[b, s] if s < ql else 4
                    if t0 == 0:
                        z["l_v"][0] = go if s > 0 else 0
                        z["l_x"][0] = 0
                        z["l_a1"][0] = tl_bound if with_tl and jS <= s else 0
                        z["dg"][0] = (tl_bound if with_tl and s > 0
                                      and jS <= s - 1 else 0)
                    elif s < ql:
                        src, slot = ((rings[g], s % RB) if g else (wrap, s))
                        (z["l_v"][0], z["l_x"][0], z["l_a1"][0],
                         z["l_a0"][0]) = src.get(slot, (j - 1, s), n, g)
                    act = (i >= 0) & (i < ql) & (c0 < tl)
                    vl, xl, a1l = z["l_v"].copy(), z["l_x"].copy(), \
                        z["l_a1"].copy()
                    dgl = z["dg"].copy()
                    qv = z["qv"]
                    for c in range(C):
                        tc = c0 + c
                        tv = z["tv"][:, c]
                        u, v, x, y, d, b08, b10 = _diff_core(
                            qv, tv, z["U"][:, c], z["Y"][:, c], vl, xl,
                            scores)
                        eq = (qv == tv).astype(np.int64)
                        a2p = z["A2"][:, c]
                        if with_tl:
                            is_jS = i == jS
                            hq = tl - tc if has_q else tl - 1 - tc
                            hi = tl - tc - 1 if has_q else tl - 1 - tc
                            M = (((dgl >> TLB) + eq) << TLB) | np.where(
                                is_jS, (hq + 1) & TLMASK, dgl & TLMASK)
                            I = (a2p & ~TLMASK) | np.where(
                                is_jS, (hi + 1) & TLMASK, a2p & TLMASK)
                        else:
                            M, I = dgl + eq, a2p
                        D = a1l
                        a0 = np.where(d == 0, M, np.where(d == 1, D, I))
                        dgl = np.where(act, z["A0"][:, c], dgl)
                        for k, new in (("U", u), ("Y", y), ("A0", a0),
                                       ("A2", np.where(b10, I, a0))):
                            z[k][:, c] = np.where(act, new, z[k][:, c])
                        vl = np.where(act, v, vl)
                        xl = np.where(act, x, xl)
                        a1l = np.where(act, np.where(b08, D, a0), a1l)
                        for k in np.nonzero(act & (i == ql - 1)
                                            & (tc == tl - 1))[0]:
                            assert iden[b] == -1, "two lanes end it"
                            iden[b] = a0[k] >> TLB if with_tl else a0[k]
                            tleft[b] = ((tl if qe > ql else
                                         (a0[k] & TLMASK) - 1)
                                        if with_tl else 0)
                    if act[31] and not last:
                        r = int(i[31])
                        val = (vl[31], xl[31], a1l[31], z["A0"][31, C - 1])
                        if g + 1 < G:
                            rings[g + 1].put(r % RB, (j, r), n, val, g)
                        else:
                            wrap.put(r, (j, r), n, val, g)
                    z["dg"] = z["l_a0"].copy()
                    up = lambda x: np.concatenate([x[:1], x[:-1]])  # noqa
                    z["l_v"], z["l_x"], z["l_a1"] = up(vl), up(xl), up(a1l)
                    z["l_a0"], z["qv"] = up(z["A0"][:, C - 1]), up(qv)
            for sl in (*rings, wrap):
                sl.round()
    return iden, tleft


def _cta_pairs(seed, LQ, T, qle_at=None):
    """_pairs, with every problem's qle set to qle_at(qlen) if given."""
    q, qlen, t, tlen, qle = _pairs(seed, LQ, T)
    if qle_at is not None:
        qle = np.array([qle_at(int(m)) for m in qlen], np.int32)
    return q, qlen, t, tlen, qle


# (C, LQ, T, G): one tile, tiles = warps, tiles wrapping round the warps
# (one warp; two warps; three tiles over two), qlen or tlen of 1 (the
# first problems of _pairs), qle 0, qlen, qlen + 1 and random
@pytest.mark.parametrize("with_tl", [False, True], ids=["iden_only", "tleft"])
@pytest.mark.parametrize("C,LQ,T,G", [(2, 20, 64, 1), (1, 40, 96, 3),
                                      (1, 40, 96, 1), (1, 23, 128, 2),
                                      (2, 70, 200, 2), (1, 9, 100, 4)])
@pytest.mark.parametrize("qle_at", [None, lambda m: 0, lambda m: m,
                                    lambda m: m + 1],
                         ids=["qle_random", "qle_0", "qle_qlen",
                              "qle_qlen1"])
def test_wf_global_cta_schedule_matches_plain(C, LQ, T, G, with_tl, qle_at):
    q, qlen, t, tlen, qle = _cta_pairs(C * 100 + T + G, LQ, T, qle_at)
    got = wf_global_cta_model(q, qlen, t, tlen, qle, C, G, with_tl)
    want = TW.global_plain(*map(torch.from_numpy, (q, qlen, t, tlen, qle)),
                           TW.DEFAULT_SCORES, with_tl)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


def test_wf_global_cta_schedule_matches_jax(monkeypatch):
    monkeypatch.setattr(WF, "INTERPRET", True)
    monkeypatch.setattr(WF, "_TILE_CELLS", 1024)   # tile_b -> 8 rows
    q, qlen, t, tlen, qle = _pairs(13, 16, 96)
    for with_tl in (False, True):
        for G in (1, 2):                           # wrapping, and not
            got = wf_global_cta_model(q, qlen, t, tlen, qle, 1, G, with_tl)
            jiden, jtl = WF.global_batch(q, qlen, t, tlen, qle,
                                         iden_only=not with_tl)
            np.testing.assert_array_equal(got[0], np.asarray(jiden))
            np.testing.assert_array_equal(got[1], np.asarray(jtl))


@pytest.mark.parametrize("short", [1, 2])
def test_wf_global_cta_model_catches_a_short_skew(monkeypatch, short):
    """With one round of skew less (the smallest fault: 2 x 16 steps < 16 +
    31, so a ring row is read in the round that writes it) or two, warp
    g + 1 reads a ring row its left neighbour has not written yet: the
    model's slot check fails."""
    S, SKEW, RB = _cta_consts()
    monkeypatch.setattr(__import__(__name__), "_cta_consts",
                        lambda: (S, SKEW - short, RB))
    q, qlen, t, tlen, qle = _pairs(5, 40, 96)
    with pytest.raises(AssertionError):
        wf_global_cta_model(q, qlen, t, tlen, qle, 1, 3, False)


# ------------------------------------------------------------------ K4 --


def _dp_cells(r, base, W, T, unit, qlen, ncol, sub, wl, wdel, wl2, wdel2,
              costs, h1, h2, e1, e2, f1, f2, g):
    """Row r of the band window [base, base + W) from row r's views of
    rows r-1 and r-2 ([nb, W] each): (direction bytes with dead lanes 0,
    new H, E1, E2, F1, F2, G), the cell arithmetic of csrc/profile_dp.cu's
    band kernel."""
    oi, ei, od, oi2, ei2, od2 = (int(c) for c in costs)
    nb = wl.shape[0]
    wb = W - 8
    Lq, Tn = qlen[:, None].astype(np.int64), ncol[:, None].astype(np.int64)
    rows = np.arange(nb)[:, None]

    def ins0(g):
        return max(-(oi + g * ei), -(oi2 + g * ei2))

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
    return (np.where(live, d, 0).astype(np.uint8), np.maximum(nG, F), nE1,
            nE2, nF1, nF2, nG)


def _warp_shift(x, step, edge):
    """x [nb, NW, 32] moved one lane inside each warp: step (x[l] <-
    x[l + 1], __shfl_down_sync) or not (x[l] <- x[l - 1], __shfl_up_sync);
    the lane a shuffle leaves keeps its own value, and edge[w] (the
    neighbour warp's word [nb], or None where warp w has none) replaces
    it."""
    if step:
        out = np.concatenate([x[:, :, 1:], x[:, :, -1:]], axis=2)
        k = -1
    else:
        out = np.concatenate([x[:, :, :1], x[:, :, :-1]], axis=2)
        k = 0
    for w, v in enumerate(edge):
        if v is not None:
            out[:, w, k] = v
    return out


def profile_dp_band_model(unit, qlen, ncol, sub, wl, wdel, wl2, wdel2,
                          costs, W):
    """Direction plane [2T-1, B, W] by profile_dp_band's schedule: NW = W
    / 32 warps, band lane l on warp l // 32, lane l % 32, one cell a
    lane.  Per row the state moves one lane inside each warp (a right
    step: H1, E1, E2 down; else G, F1, F2, H2 up), and the lane at a
    warp's edge takes its neighbour warp's word from the slot that warp
    wrote after the row before: slots [2 rows][2 sides][NW], written at
    row r into buffer r & 1 and read at row r + 1, with one barrier a row
    between.  Asserts that every slot read holds row r - 1's words (row 0
    reads the NEG the prologue wrote) and that no buffer is written in the
    row that reads it."""
    nb, T = wl.shape
    NW = W // LANES
    nrows = qlen.astype(np.int64) + ncol - 1
    dirs = np.zeros((2 * T - 1, nb, W), np.uint8)
    neg = np.full((nb, NW, LANES), TMD.NEG, np.int64)
    H1, H2, E1, E2, F1, F2, G = (neg.copy() for _ in range(7))
    # slot[buf][side][w]: (row written, [nb, 4] words); side 0 the first
    # lane's H1, E1, E2, side 1 the last lane's H2, G, F1, F2
    slot = [[[(-1, np.full((nb, 4), TMD.NEG, np.int64)) for _ in range(NW)]
             for _ in range(2)] for _ in range(2)]

    def take(buf, side, w, r):
        row, v = slot[buf][side][w]
        assert row == r - 1, (row, r)
        return v

    prev = 0
    for r in range(int(nrows.max())):
        base = TMD.band_base(r, T, W)
        rb = (r - 1) & 1
        if base != prev:
            edge = [take(rb, 0, w + 1, r) if w + 1 < NW else None
                    for w in range(NW)]
            H1, E1, E2 = (_warp_shift(x, True, [
                None if e is None else e[:, i] for e in edge])
                for i, x in enumerate((H1, E1, E2)))
        else:
            edge = [take(rb, 1, w - 1, r) if w > 0 else None
                    for w in range(NW)]
            H2, G, F1, F2 = (_warp_shift(x, False, [
                None if e is None else e[:, i] for e in edge])
                for i, x in enumerate((H2, G, F1, F2)))
        prev = base
        flat = [x.reshape(nb, W) for x in (H1, H2, E1, E2, F1, F2, G)]
        d, *new = _dp_cells(r, base, W, T, unit, qlen, ncol, sub, wl, wdel,
                            wl2, wdel2, costs, *flat)
        H2 = H1
        H1, E1, E2, F1, F2, G = (x.reshape(nb, NW, LANES) for x in new)
        written = r < nrows
        dirs[r, written] = d[written]
        wbuf = r & 1
        assert wbuf != rb
        for w in range(NW):
            slot[wbuf][0][w] = (r, np.stack(
                [H1[:, w, 0], E1[:, w, 0], E2[:, w, 0],
                 np.zeros(nb, np.int64)], axis=1))
            slot[wbuf][1][w] = (r, np.stack(
                [H2[:, w, -1], G[:, w, -1], F1[:, w, -1], F2[:, w, -1]],
                axis=1))
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


def _jax_dirs(T, W, unit, qlen, ncol, unit0, len0):
    """The JAX package's direction plane for the round _round_inputs made
    (its Pallas kernel; the caller sets interpret mode)."""
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
    maxr = jnp.max(jq + jcol).reshape(1, 1)
    return jsub, np.asarray(run_dp(maxr, qbuf, jsub, jwl, jwdel, jwl2,
                                   jwdel2, jq.reshape(-1, 1),
                                   jcol.reshape(-1, 1)))


@pytest.mark.parametrize("T,W", [(96, 64), (160, 64), (160, 96),
                                 (200, 128)])
def test_profile_dp_band_window_matches_plain(T, W):
    # full-length pairs slide the window across every warp edge to the
    # T - W clamp; short and uneven ones stay left of it
    lens = [(T, T), (T - 3, T), (T, T - 5), (1, T // 2), (T // 2, 1),
            (T // 3, T // 3 + 4), (T - 1, T - 9), (7, 9)]
    unit, qlen, ncol, sub, wl, wdel, wl2, wdel2, costs, _, _ = \
        _round_inputs(T + W + 1, T, lens)
    assert max(qlen + ncol) - 2 >= 2 * (T - W) + W - 8 + 4   # clamp reached
    got = profile_dp_band_model(unit, qlen, ncol, sub, wl, wdel, wl2, wdel2,
                                costs, W)
    want = TMD.profile_dp_plain(
        *map(torch.from_numpy, (unit, qlen, ncol, sub, wl, wdel, wl2,
                                wdel2)), costs, W).numpy()
    for b in range(B):
        np.testing.assert_array_equal(_live(got, qlen, ncol, b),
                                      _live(want, qlen, ncol, b))


def test_profile_dp_band_window_matches_jax(monkeypatch):
    monkeypatch.setattr(MD, "INTERPRET", True)
    monkeypatch.setattr(MD, "_B_CAP", B)
    T, W = 256, 128
    lens = [(200, 190), (180, 185), (250, 256), (1, 120), (140, 150),
            (90, 60), (230, 240), (256, 256)]
    (unit, qlen, ncol, sub, wl, wdel, wl2, wdel2, costs, unit0,
     len0) = _round_inputs(5, T, lens)
    got = profile_dp_band_model(unit, qlen, ncol, sub, wl, wdel, wl2, wdel2,
                                costs, W)
    jsub, jdirs = _jax_dirs(T, W, unit, qlen, ncol, unit0, len0)
    np.testing.assert_array_equal(np.asarray(jsub), sub)
    for b in range(B):
        np.testing.assert_array_equal(_live(got, qlen, ncol, b),
                                      _live(jdirs, qlen, ncol, b))


# ------------------------------------------------------------------ K3 --


def profile_dp_strip_model(unit, qlen, ncol, sub, wl, wdel, wl2, wdel2,
                           costs, W, L, nw):
    """Direction plane by profile_dp_strip's schedule: warp w owns columns
    [32 L w, 32 L (w + 1)) (nw warps; columns past T are dead), H by row
    parity, E, F, G of the row above, all per column and never shifted.
    In round n warp w runs rows [(n - w) S, (n - w + 1) S): each column
    reads its left neighbour's state before the row, the warp's first
    column its left warp's ring entry of row r - 1 (as it stood at the
    round's barrier), or the column-0 boundary.  Banded, a warp skips a
    row whose window misses its strip outright (no store, no ring entry);
    a warp with no live cell in a row leaves its state alone and writes
    zeros; a warp whose columns
    are all live and none is the band-exit column tdl updates every
    column, else only the live ones.  Each warp writes its last column to
    its right neighbour's ring after every row; the model asserts that
    every entry a live cell reads holds its row, then and at the round's
    end.  Each lane reads its unit codes j = r - t from the unit staged
    with 4 outside [0, qlen), and the model asserts that every read lies
    inside the staged bytes."""
    oi, ei, od, oi2, ei2, od2 = (int(c) for c in costs)
    S, = _csrc("profile_dp.cu", r"constexpr int STRIP_S = (\d+);")
    RB = S * _csrc("profile_dp.cu",
                   r"constexpr int STRIP_RB = (\d+) \* STRIP_S;")[0]
    nb, T = wl.shape
    SW = 32 * L
    NC = nw * SW
    wb = (W or 0) - 8
    dirs = np.zeros((2 * T - 1, nb, W or T), np.uint8)
    NEG = TMD.NEG

    def ins0(g):
        return max(-(oi + g * ei), -(oi2 + g * ei2))

    pad = NC - T
    for b in range(nb):
        Lq, Tn = int(qlen[b]), int(ncol[b])
        nrows = Lq + Tn - 1
        col = np.arange(NC)
        inT = col < T
        sb = np.pad(sub[b].astype(np.int64), ((0, 0), (0, pad)))
        wd = np.pad(wdel[b].astype(np.int64), (0, pad))
        wd2 = np.pad(wdel2[b].astype(np.int64), (0, pad))
        top = np.where(inT, np.maximum(-(od + np.pad(wl[b], (0, pad))),
                                       -(od2 + np.pad(wl2[b], (0, pad)))),
                       NEG)
        A0 = np.where(bool(W) & (col >= wb), NEG, top).astype(np.int64)
        A = [A0.copy(), A0.copy()]
        E1, E2, F1, F2, G = (np.full(NC, NEG, np.int64) for _ in range(5))
        UO = T + 4                           # staged code j at UO + j
        UB = (2 * T + unit.shape[1] + 16 + 15) // 16 * 16
        ring = [[None] * RB for _ in range(nw)]     # (row, H, G, F1, F2)
        rounds = (nrows + (nw - 1) * S + S - 1) // S if nrows > 0 else 0
        for n in range(rounds):
            snap = [list(x) for x in ring]
            reads = []
            for w in range(nw):
                wlo, whi = w * SW, w * SW + SW - 1
                cs = slice(wlo, whi + 1)
                c = col[cs]
                rb = (n - w) * S
                assert rb % 2 == 0
                for r in range(max(rb, 0), min(rb + S, nrows)):
                    P = r & 1
                    off = TMD.band_base(r, T, W) if W else 0
                    if W and (off + W <= wlo or off > whi):
                        continue
                    lo, hi = max(r - Lq + 1, 0), min(r, Tn - 1)
                    tdl = -1
                    if W:
                        lo = max(lo, (r - wb + 1) >> 1)
                        hi = min(hi, (r + wb) >> 1)
                        tdl = -1 if (r - wb) & 1 else (r - wb) >> 1
                    # the column left of each: own neighbours before the row
                    if w == 0:
                        left = (ins0(r) if r else 0, ins0(r + 1), NEG, NEG)
                    else:
                        e = snap[w][(r - 1) % RB]
                        if lo <= wlo <= hi:          # a live cell reads it
                            assert e is not None and e[0] == r - 1, (b, r, w)
                            reads.append((w, (r - 1) % RB, r - 1))
                        left = (NEG,) * 4 if e is None else e[1:]
                    hm = np.concatenate([[left[0]], A[P][wlo:whi]])
                    g = np.concatenate([[left[1]], G[wlo:whi]])
                    f1 = np.concatenate([[left[2]], F1[wlo:whi]])
                    f2 = np.concatenate([[left[3]], F2[wlo:whi]])
                    pk = np.zeros(SW, np.int64)
                    if lo <= hi and lo <= whi and hi >= wlo:
                        # a lane's 4 codes: bytes [a, a + 8) hold them
                        t0 = c[::4]
                        a = UO + r - t0[t0 < T] - 3
                        assert (a >= 0).all() and (a // 4 * 4 + 8 <= UB).all()
                        j = r - c
                        code = np.where((j >= 0) & (j < Lq) & (c < T),
                                        unit[b, np.clip(j, 0, Lq - 1)], 4)
                        inner = (lo <= wlo and hi >= whi
                                 and not wlo <= tdl <= whi)
                        exit_ = c == tdl
                        g, f1, f2 = (np.where(exit_, NEG, x)
                                     for x in (g, f1, f2))
                        M = hm + sb[code, c]
                        h_up = A[P ^ 1][cs]
                        e_cont = E1[cs] - ei
                        nE1 = np.maximum(h_up - oi - ei, e_cont)
                        icont1 = e_cont > h_up - oi - ei
                        e2_cont = E2[cs] - ei2
                        nE2 = np.maximum(h_up - oi2 - ei2, e2_cont)
                        icont2 = e2_cont > h_up - oi2 - ei2
                        E = np.maximum(nE1, nE2)
                        isel2 = nE2 > nE1
                        nF1 = np.maximum(g - od, f1) - wd[cs]
                        fcont1 = f1 >= g - od
                        nF2 = np.maximum(g - od2, f2) - wd2[cs]
                        fcont2 = f2 >= g - od2
                        F = np.maximum(nF1, nF2)
                        fsel2 = nF2 > nF1
                        nG = np.maximum(M, E)
                        sel = np.where(F > nG, 2, np.where(E > M, 1, 0))
                        d = (sel | (icont1 << 2) | (fcont1 << 3)
                             | (isel2 << 4) | (fsel2 << 5) | (icont2 << 6)
                             | (fcont2 << 7))
                        live = (c >= lo) & (c <= hi)
                        assert not inner or live.all()
                        for arr, new in ((A[P], np.maximum(nG, F)),
                                         (E1, nE1), (E2, nE2), (F1, nF1),
                                         (F2, nF2), (G, nG)):
                            arr[cs] = np.where(live, new, arr[cs])
                        pk = np.where(live, d, 0)
                    li = c - off
                    ok = (li >= 0) & (li < (W or T))
                    dirs[r, b, li[ok]] = pk[ok]
                    if w + 1 < nw:
                        ring[w + 1][r % RB] = (r, A[P ^ 1][whi], G[whi],
                                               F1[whi], F2[whi])
            # nor did the left warp overwrite them in the round
            for w, slot, row in reads:
                assert ring[w][slot][0] == row, (b, n, w)
    return dirs


# (T, W, L, warps): one warp at full width; several skewed warps at a
# small L, with a padded last warp; banded, where the band leaves most
# strips most rows
@pytest.mark.parametrize("T,W,L,nw", [
    (128, None, 4, 1), (160, None, 1, 5), (160, None, 2, 3),
    (160, 40, 1, 5), (192, 72, 2, 3), (256, 40, 1, 8), (256, 72, 4, 2)])
def test_profile_dp_strips_match_plain(T, W, L, nw):
    lens = [(T, T), (T - 3, T), (T, T - 5), (1, T // 2), (T // 2, 1),
            (T // 3, T // 3 + 4), (T - 1, T - 9), (7, 9)]
    if W:                          # keep the pairs inside the band
        lens = [(n0, min(n1, n0 + (W - 8) // 2 - 1)) for n0, n1 in lens]
    unit, qlen, ncol, sub, wl, wdel, wl2, wdel2, costs, _, _ = \
        _round_inputs(T + L + (W or 0), T, lens)
    got = profile_dp_strip_model(unit, qlen, ncol, sub, wl, wdel, wl2,
                                 wdel2, costs, W, L, nw)
    want = TMD.profile_dp_plain(
        *map(torch.from_numpy, (unit, qlen, ncol, sub, wl, wdel, wl2,
                                wdel2)), costs, W).numpy()
    for b in range(B):
        np.testing.assert_array_equal(_live(got, qlen, ncol, b),
                                      _live(want, qlen, ncol, b))


@pytest.mark.parametrize("W,L,nw", [(None, 2, 4), (136, 1, 8)])
def test_profile_dp_strips_match_jax(monkeypatch, W, L, nw):
    monkeypatch.setattr(MD, "INTERPRET", True)
    monkeypatch.setattr(MD, "_B_CAP", B)
    T = 256
    lens = [(200, 190), (180, 185), (250, 256), (1, 120), (140, 150),
            (90, 60), (230, 240), (256, 256)]
    (unit, qlen, ncol, sub, wl, wdel, wl2, wdel2, costs, unit0,
     len0) = _round_inputs(9, T, lens)
    got = profile_dp_strip_model(unit, qlen, ncol, sub, wl, wdel, wl2,
                                 wdel2, costs, W, L, nw)
    _, jdirs = _jax_dirs(T, W, unit, qlen, ncol, unit0, len0)
    for b in range(B):
        np.testing.assert_array_equal(_live(got, qlen, ncol, b),
                                      _live(jdirs, qlen, ncol, b))


# ------------------------------------------------------------------ K5 --


def _bt_step(mode, val):
    """step() of csrc/profile_bt.cu: (sel, next mode) from a direction
    byte; mode -1 fresh, 1/3 an I run on track 1/2, 2/4 a D run."""
    in_run = mode > 0
    sel = (1 if mode & 1 else 2) if in_run else val & 3
    i_trk2 = (mode == 3) if in_run else (val >> 4) & 1
    d_trk2 = (mode == 4) if in_run else (val >> 5) & 1
    icont = (val >> 6) & 1 if i_trk2 else (val >> 2) & 1
    fcont = (val >> 7) & 1 if d_trk2 else (val >> 3) & 1
    if sel == TMD.OP_M:
        return sel, -1
    if sel == TMD.OP_I:
        return sel, (3 if i_trk2 else 1) if icont else -1
    return sel, (4 if d_trk2 else 2) if fcont else -1


def profile_bt_model(dirs, qlen, ncol, T, W):
    """(ops, nst, tch) by profile_bt_warp's schedule: the walk reads its
    direction bytes only from a ring of NT tiles of KR rows, tile k holding
    rows (R0 - (k + 1) KR, R0 - k KR] in slot k mod NT; tiles 0..NT-1 are
    requested at the start, and when the walk enters tile k the slot of
    tile k - 1 is refilled with tile k + NT - 1.  A tile row is the whole
    band row (banded) or the 128 lanes from window(c) of the walk's entry
    into the tile NT - 1 before it (full width; c = ncol for tiles
    0..NT-1).  Asserts that every byte read lies in the tile of its row,
    present in the ring."""
    (KR,), (NT,), (FT,) = (
        _csrc("profile_bt.cu", rf"constexpr int {n} = (\d+);")
        for n in ("KR", "NTILE", "FULL_TW"))
    nb = len(qlen)
    TWd = W or FT
    NL = TMD.n_levels(T)
    ops = np.full((nb, NL), TMD.OP_PAD, np.int8)
    nst = np.zeros(nb, np.int32)
    tch = np.zeros(nb, np.int32)

    def window(c):
        return min(max(c - NT * KR, 0) & ~15, T - FT)

    for b in range(nb):
        j, c = int(qlen[b]), int(ncol[b])
        R0 = j + c - 2

        def load(k, llo):
            """(k, llo, {row: its TWd bytes from lane llo}) of tile k."""
            assert llo % 16 == 0 and 0 <= llo and llo + TWd <= (W or T)
            rows = range(max(R0 - (k + 1) * KR + 1, 0), R0 - k * KR + 1)
            return k, llo, {r: dirs[r, b, llo:llo + TWd].copy() for r in rows}

        ring = [load(k, 0 if W else window(c)) for k in range(NT)]
        kt = 0
        mode, m, touch = -1, 0, 0
        while j > 0 or c > 0:
            if j > 0 and c > 0:
                r = j + c - 2
                if r <= R0 - (kt + 1) * KR:        # entered tile kt + 1
                    kt += 1
                    ring[(kt + NT - 1) % NT] = load(kt + NT - 1,
                                                    0 if W else window(c))
                k, llo, rows = ring[kt % NT]
                assert k == kt and r in rows, (b, r, kt)
                li = c - 1 - (TMD.band_base(r, T, W) if W else llo)
                if not W:
                    assert 0 <= li < TWd, (b, r, c, llo)
                val = int(rows[r][li]) if 0 <= li < TWd else 0
                sel, mode = _bt_step(mode, val)
            else:
                sel, mode = (TMD.OP_D if j == 0 else TMD.OP_I), -1
            ops[b, NL - 1 - m] = sel
            if W and abs(c - j) >= W - 16:
                touch = 1
            j -= sel != TMD.OP_D
            c -= sel != TMD.OP_I
            m += 1
        nst[b], tch[b] = m, touch
    return ops, nst, tch


def _bt_plane(seed, T, W):
    """A random direction plane (every byte a valid direction: sel 0..2,
    random continuation and track bits) and B paths from corners, edges
    and the middle of the DP matrix."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (2 * T - 1, B, W or T))
    dirs = ((raw & 0xFC) | (raw % 3)).astype(np.uint8)
    qlen = np.array([T, 1, T, T // 2, 7, T - 3, T // 3, 1], np.int32)
    ncol = np.array([T, T, 1, T // 3, T - 5, T, T // 2, 1], np.int32)
    return dirs, qlen, ncol


def _bt_check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w).reshape(g.shape))


@pytest.mark.parametrize("W", [128, 256, 512, None],
                         ids=["W128", "W256", "W512", "full"])
def test_profile_bt_tiles_match_plain(W):
    T = 640
    dirs, qlen, ncol = _bt_plane(T + (W or 0), T, W)
    got = profile_bt_model(dirs, qlen, ncol, T, W)
    want = TMD.profile_bt_plain(*map(torch.from_numpy, (dirs, qlen, ncol)),
                                T, W)
    _bt_check(got, [w.numpy() for w in want])
    if W:
        assert got[2].any() and not got[2].all()   # band touches both ways


def test_profile_bt_tiles_match_jax(monkeypatch):
    monkeypatch.setattr(MD, "INTERPRET", True)
    monkeypatch.setattr(MD, "_B_CAP", B)
    jm = MD.DeviceMSA(2, 4, 4, 2, **GAPS)
    for T, W in ((256, 128), (256, None)):
        dirs, qlen, ncol = _bt_plane(T, T, W)
        got = profile_bt_model(dirs, qlen, ncol, T, W)
        run_bt, Bj, _ = jm._bt_run(T, W, B)
        assert Bj == B
        want = run_bt(jnp.asarray(dirs), jnp.asarray(qlen).reshape(-1, 1),
                      jnp.asarray(ncol).reshape(-1, 1))
        _bt_check(got, want)


# ------------------------------------------------------------------ K2 --


def _tie_key(ti, st0, en0):
    """tie_key of csrc/wavefront.cu: en0, then the SIMD lanes of
    [st0, en1) in lane order, then the remainder; lowest t within each."""
    en1 = st0 + (en0 - st0) // 4 * 4
    cls = np.where(ti == en0, 0,
                   np.where(ti < en1, 1 + ((ti - st0) & 3), 5))
    return (cls << 14) | ti


def _ext_skew(L):
    """ext_skew of csrc/wavefront.cu: anti-diagonals a warp runs between
    barriers."""
    most, few, many = _csrc(
        "wavefront.cu",
        r"ext_skew\(int L\) \{ return L <= (\d+) \? (\d+) : (\d+); \}")
    return few if L <= most else many


def wf_ext_model(q, qlen, t, tlen, L, scores=TW.DEFAULT_SCORES):
    """(max, max_t, max_q, score) by wf_ext's schedule: thread k owns
    lanes [k L, k L + L) of a CTA of 32-thread warps; in round n warp w
    runs rows [(n - w) S, (n - w + 1) S).  Lane t - 1's v, x, H of the
    previous row come from the thread's own registers, from thread k - 1
    (shfl_up) or, at a warp's lane 0, from the previous warp's ring as it
    stood at the round's barrier; the model asserts that every ring entry
    a live lane reads holds the row it needs.  Each warp takes one branch
    a row: none (no live lane in the round, or a row outside the problem),
    the interior cell (no boundary term, no mask) or the edge cell (the
    en0 rule; lanes past en0 keep the state set for their top cell,
    finished lanes take whatever they compute).  Each live lane keeps its
    best H above 0 and the first row reaching it; the epilogue takes the
    CTA's best by (H, -row, -tie key of the lane in that row)."""
    go, ge = scores[2], scores[3]
    QE = go + ge
    S = _ext_skew(L)
    RB = S * _csrc("wavefront.cu",
                   r"ext_ring\(int L\) \{ return (\d+) \* ext_skew\(L\); \}")[0]
    nb, LQ = q.shape
    T = t.shape[1]
    NT = -(-T // (32 * L)) * 32
    NW = NT // 32
    k = np.arange(NT)
    ti = k[:, None] * L + np.arange(L)[None, :]
    lane0 = k % 32 == 0
    wid = k // 32
    w = np.arange(NW)
    wlo, whi = w * 32 * L, w * 32 * L + 32 * L - 1
    from_slot = lane0 & (wid > 0)
    out = np.zeros((4, nb), np.int64)
    for b in range(nb):
        ql, tl = int(qlen[b]), int(tlen[b])
        nrows = ql + tl - 1
        tv = np.where(ti < tl, t[b, np.minimum(ti, T - 1)], 4)
        U = np.where(ti > 0, go, 0).astype(np.int64)
        Y, V, X = (np.zeros((NT, L), np.int64) for _ in range(3))
        H = np.where(ti > 0, TW.NEG_INF32, -QE).astype(np.int64)
        ring = np.full((NW, RB, 4), -(1 << 40), np.int64)   # row, v, x, h
        BH = np.zeros((NT, L), np.int64)
        BR = np.full((NT, L), -1, np.int64)
        rounds = (nrows + (NW - 1) * S + S - 1) // S
        for n in range(rounds):
            rb = (n - w) * S
            live = ((rb < nrows) & (rb + S - 1 >= 0)
                    & (wlo <= np.minimum(tl - 1, rb + S - 1))
                    & (whi >= np.maximum(0, rb - ql + 1)))
            snap = ring.copy()                  # as at the round's barrier
            reads = []          # (warp, ring row, row) read by live lanes
            for kk in range(S):
                rw = rb + kk                    # each warp's row
                r = rw[wid]
                okw = live & (rw >= 0) & (rw < nrows)
                ok = okw[wid]
                st0 = np.maximum(0, r - ql + 1)
                en0 = np.minimum(tl - 1, r)
                s0, e0 = st0[:, None], en0[:, None]
                last = np.stack([V[:, -1], X[:, -1], H[:, -1]], axis=1)
                left = np.roll(last, 1, axis=0)
                src = snap[wid[from_slot] - 1, (r[from_slot] - 1) & (RB - 1)]
                left[from_slot] = src[:, 1:]
                need = from_slot & ok & (ti[:, 0] >= st0) & (ti[:, 0] <= en0)
                reads.append((wid[need] - 1, (r[need] - 1) & (RB - 1),
                              r[need] - 1))
                assert (snap[reads[-1][:2]][:, 0] == r[need] - 1).all()
                left[0, :2] = (go if r[0] > 0 else 0, 0)   # t = 0 boundary
                # q[r - t] = qs[T + LQ - 1 - r + t], qs of LQ + 2T + 32L
                # bytes, read for the rows of the problem
                qi = T + LQ - 1 - r[:, None] + ti
                assert (qi[ok] >= 0).all() and (qi[ok] < LQ + 2 * T + 32 * L).all()
                jq = r[:, None] - ti
                qv = np.where((jq >= 0) & (jq < ql),
                              q[b, np.clip(jq, 0, LQ - 1)], 4)
                v_sh = np.concatenate([left[:, :1], V[:, :-1]], axis=1)
                x_sh = np.concatenate([left[:, 1:2], X[:, :-1]], axis=1)
                h_sh = np.concatenate([left[:, 2:], H[:, :-1]], axis=1)
                u, v, x, y, _, _, _ = _diff_core(qv, tv, U, Y, v_sh, x_sh,
                                                 scores)
                edge = ~((wlo >= np.maximum(0, rw - ql + 1))
                         & (whi < np.minimum(tl - 1, rw)))[wid][:, None]
                h = np.where(edge & (ti == e0) & (e0 > 0), h_sh + u - QE,
                             H + v - QE)
                upd = ok[:, None] & ~(edge & (ti > e0))
                lv = (ti >= s0) & (ti <= e0)
                assert not (ok[:, None] & ~edge & ~lv).any()
                U, Y, V, X, H = (np.where(upd, n_, o) for n_, o in (
                    (u, U), (y, Y), (v, V), (x, X), (h, H)))
                imp = ok[:, None] & lv & (H > BH)
                BH, BR = np.where(imp, H, BH), np.where(imp, r[:, None], BR)
                ring[okw, rw[okw] & (RB - 1)] = np.stack(
                    [rw, V[31::32, -1], X[31::32, -1], H[31::32, -1]],
                    axis=1)[okw]
            # nor did any warp overwrite them in the round (no order
            # between warps inside a round)
            for wi, idx, row in reads:
                assert (ring[wi, idx, 0] == row).all(), (b, n)
        st0 = np.maximum(0, BR - ql + 1)
        key = _tie_key(ti, st0, np.minimum(tl - 1, BR))
        best = np.lexsort((key.ravel(), BR.ravel(), -BH.ravel()))[0]
        mt = key.ravel()[best] & ((1 << 14) - 1)
        found = BH.ravel()[best] > 0
        out[:, b] = (BH.ravel()[best] if found else 0, mt if found else -1,
                     BR.ravel()[best] - mt if found else -1,
                     H[(tl - 1) // L, (tl - 1) % L])
    return out


TIE_SCORES = (2, -2, 0, 1)   # no gap open: equal H in one row is common


def _ext_tie_cases(seed, LQ, T):
    """B problems over 2-4 letters, picked from a seeded pool under
    TIE_SCORES: three with 3 or more lanes at the max in the winning row
    r*, two with 2 or more of them and none at en0, one that never scores
    above 0 (found false), two whose r* has en0 == tlen - 1."""
    rng = np.random.default_rng(seed)
    n = 4096
    q = np.full((n, LQ), 4, np.uint8)
    t = np.full((n, T), 4, np.uint8)
    qlen = rng.integers(1, LQ + 1, n).astype(np.int32)
    tlen = rng.integers(1, T + 1, n).astype(np.int32)
    for b in range(n):
        k = int(rng.integers(2, 5))
        q[b, :qlen[b]] = rng.integers(0, k, qlen[b])
        t[b, :tlen[b]] = rng.integers(0, k, tlen[b])
    besth, bestr, _ = TW.ext_plain(*map(torch.from_numpy, (q, qlen, t, tlen)),
                                   TIE_SCORES)
    besth, bestr = besth.numpy(), bestr.numpy()
    M = besth.max(axis=1)
    rstar = np.where(besth == M[:, None], bestr, 1 << 30).min(axis=1)
    cand = (besth == M[:, None]) & (bestr == rstar[:, None]) & (M[:, None] > 0)
    en0 = np.minimum(tlen - 1, rstar)
    at_en0 = cand[np.arange(n), np.minimum(en0, T - 1)]
    want = ((cand.sum(1) >= 3, 3), ((cand.sum(1) >= 2) & ~at_en0, 2),
            (M <= 0, 1), ((M > 0) & (en0 == tlen - 1) & (qlen > tlen), 2))
    idx = []
    for mask, count in want:
        idx += [int(i) for i in np.nonzero(mask)[0] if i not in idx][:count]
    assert len(idx) == B
    return q[idx], qlen[idx], t[idx], tlen[idx]


@pytest.mark.parametrize("L", [1, 2, 4, 16])
@pytest.mark.parametrize("case", ["pairs", "ties"])
def test_wf_ext_schedule_matches_plain(case, L):
    if case == "pairs":
        q, qlen, t, tlen = _pairs(L * 10 + 7, 72, 80)[:4]
        scores = TW.DEFAULT_SCORES
    else:
        q, qlen, t, tlen = _ext_tie_cases(L, 16, 24)
        scores = TIE_SCORES
    got = wf_ext_model(q, qlen, t, tlen, L, scores)
    want = TW.ext_batch(*map(torch.from_numpy, (q, qlen, t, tlen)), scores)
    np.testing.assert_array_equal(got, np.stack([w.numpy() for w in want]))


def test_wf_ext_schedule_matches_jax(monkeypatch):
    monkeypatch.setattr(WF, "INTERPRET", True)
    monkeypatch.setattr(WF, "_TILE_CELLS", 1024)   # tile_b -> 8 rows
    for (q, qlen, t, tlen), scores, L in (
            (_pairs(13, 16, 96)[:4], TW.DEFAULT_SCORES, 2),
            (_ext_tie_cases(5, 16, 24), TIE_SCORES, 1)):
        got = wf_ext_model(q, qlen, t, tlen, L, scores)
        want = WF.ext_batch(q, qlen, t, tlen, scores)
        np.testing.assert_array_equal(
            got, np.stack([np.asarray(w) for w in want]))


# ------------------------------------------------------ seed_hits ------

RADIX_WARPS, = _csrc("seed_hits.cu", r"RADIX_WARPS = (\d+);")
MAX_CLUSTER, = _csrc("seed_hits.cu", r"MAX_CLUSTER = (\d+);")


def _warp_share(lo, hi, warp, nwk):
    """warp_share of csrc/seed_hits.cu: a warp's contiguous share of
    [lo, hi), in whole chunks of 32."""
    n = max(hi - lo, 0)
    per = -(-(-(-n // nwk)) // 32) * 32
    return lo + min(warp * per, n), lo + min(warp * per + per, n)


def seed_radix_model(key, valid, k, C, P, nw):
    """Step 4 of csrc/seed_hits.cu on one read of len(key) stream lanes,
    over C CTAs of P lanes (C = 1: P = the read) of nw warps: each pass's
    warps walk their shares in chunks of 32, count a digit once a chunk
    (match_any's leader), turn the (digit, CTA, warp) counts into offsets
    and scatter each element after its chunk's peers of lower lanes.
    Returns (the lanes in sorted order, each lane's rank or -1)."""
    S = len(key)
    nwk = min(nw, RADIX_WARPS)
    elems = None                       # the previous pass's output
    n = int(valid.sum())
    for pas in range((2 * k + 7) // 8):
        shift = 8 * pas
        walks = []                     # [c][w]: chunks of element lanes
        for c in range(C):
            lo, hi = c * P, min(c * P + P, S)
            in_hi = min(hi, n) if pas else hi
            walks.append([])
            for w in range(nwk):
                s0, s1 = _warp_share(lo, in_hi, w, nwk)
                chunks = []
                for c0 in range(s0, s1, 32):
                    idx = range(c0, min(c0 + 32, s1))
                    chunks.append([elems[i] if pas else
                                   (i if valid[i] else None) for i in idx])
                walks[c].append(chunks)
        digit = {}

        def dig(lane):
            return (int(key[lane]) >> shift) & 255

        cnt = np.zeros((256, C, nwk), np.int64)
        for c in range(C):
            for w in range(nwk):
                for ch in walks[c][w]:
                    for lane in ch:
                        if lane is not None:
                            cnt[dig(lane), c, w] += 1
        off = (np.cumsum(cnt.ravel()) - cnt.ravel()).reshape(cnt.shape)
        out = [None] * n
        for c in range(C):
            for w in range(nwk):
                for ch in walks[c][w]:
                    ds = [None if x is None else dig(x) for x in ch]
                    for j, lane in enumerate(ch):
                        if lane is None:
                            continue
                        r = off[ds[j], c, w] + ds[:j].count(ds[j])
                        assert out[r] is None      # each slot once
                        out[r] = lane
                    for d in set(x for x in ds if x is not None):
                        off[d, c, w] += ds.count(d)
        elems = out
        del digit
    rank = np.full(S, -1, np.int64)
    for r, lane in enumerate(elems or []):
        rank[lane] = r
    return np.array(elems or [], np.int64), rank


def seed_search_model(skey, spos, rank, key, pos, valid, min_p):
    """Step 5 of csrc/seed_hits.cu: per valid lane with p >= min_p, the
    last sorted word <= (key, p - min_p) in [r - min_p, r] by a binary
    search; returns the found sorted index of each lane or -1."""
    found = np.full(len(key), -1, np.int64)
    for s in np.nonzero(valid)[0]:
        p = int(pos[s])
        if p < min_p:
            continue
        r = int(rank[s])
        tgt = (int(skey[r]), p - min_p)
        j0 = r - min(r, min_p)
        x, y = j0, r + 1
        while x < y:
            mid = (x + y) // 2
            if (int(skey[mid]), int(spos[mid])) <= tgt:
                x = mid + 1
            else:
                y = mid
        if x > j0:
            found[s] = x - 1
    return found


def _seed_lanes(seed, S, alphabet, gaps):
    """S stream lanes: keys from `alphabet` distinct values (collisions
    by the hundred at 3), ~80% valid, positions ascending (gaps: hpc-like
    jumps, else the lane itself)."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 1 << 16, alphabet)
    key = vals[rng.integers(0, alphabet, S)]
    valid = rng.random(S) < 0.8
    pos = (np.cumsum(rng.integers(1, 4, S)) if gaps else np.arange(S))
    return key, valid, pos


# (k, CTAs, lanes a CTA, warps): one pass (k = 4), two (k = 8) and four
# (k = 16); one CTA with fewer warps than RADIX_WARPS, as many and more;
# clusters of 2 and of MAX_CLUSTER with a short last part
@pytest.mark.parametrize("k,C,P,nw", [
    (4, 1, 700, 2), (8, 1, 700, 8), (8, 1, 1000, 16), (16, 1, 700, 4),
    (8, 2, 352, 4), (8, MAX_CLUSTER, 96, 2), (16, 3, 240, 8)])
def test_seed_radix_passes_are_a_stable_sort(k, C, P, nw):
    S = min(C * P, 700 + 300 * (P == 1000)) - 7
    for alphabet in (3, 200):
        key, valid, _ = _seed_lanes(k + C + alphabet, S, alphabet, False)
        key = key & ((1 << (2 * k)) - 1)
        order, rank = seed_radix_model(key, valid, k, C, P, nw)
        lanes = np.nonzero(valid)[0]
        want = lanes[np.lexsort((lanes, key[lanes]))]
        np.testing.assert_array_equal(order, want)
        np.testing.assert_array_equal(rank[order], np.arange(len(order)))
        assert (rank[~valid] == -1).all()


@pytest.mark.parametrize("gaps", [False, True], ids=["lanes", "hpc"])
def test_seed_rank_search_matches_row_search(gaps):
    """The search from a lane's rank in [r - min_p, r] finds the word the
    row-wide search for the last word <= (key, p - min_p) finds (seed_plain's
    searchsorted), for min_p 0 to 5."""
    for seed, alphabet in ((1, 3), (2, 40)):
        key, valid, pos = _seed_lanes(seed, 600, alphabet, gaps)
        order, rank = seed_radix_model(key, valid, 8, 1, 600, 8)
        skey, spos = key[order], pos[order]
        words = (skey.astype(np.int64) << 31) | spos
        for min_p in range(6):
            got = seed_search_model(skey, spos, rank, key, pos, valid, min_p)
            q = valid & (pos >= min_p)
            tgt = (key.astype(np.int64) << 31) | (pos - min_p)
            cnt = np.searchsorted(words, tgt, side="right")
            want = np.where(q & (cnt > 0), cnt - 1, -1)
            np.testing.assert_array_equal(got, want)
            if min_p == 0:
                np.testing.assert_array_equal(got[valid], rank[valid])


def test_seed_schedule_matches_plain():
    """The radix and search models over a batch's own keys (seed_plain's
    front half) give seed_plain's hits, read by read."""
    from test_offload import _random_reads
    from tidehunter_tpu_torch.ops import seeding_device as SD

    reads = _random_reads(np.random.default_rng(3), 6, 900, n_frac=0.0)
    reads.append(np.zeros(300, np.uint8))
    batch, lens = SD.pad_batch(reads, 900)
    tb, tl = torch.from_numpy(batch), torch.from_numpy(lens)
    for hpc in (False, True):
        key, pos, valid, _ = SD._keys_valid_positions(tb, tl, k=8,
                                                      use_hpc=hpc, w=1)
        ends, pers, n, _ = SD.seed_plain(tb, tl, k=8, use_hpc=hpc, min_p=3,
                                         max_p=500)
        for b in range(len(reads)):
            kb, pb_, vb = (x[b].numpy() for x in (key, pos, valid))
            order, rank = seed_radix_model(kb, vb, 8, 2, 464, 4)
            if not len(order):             # no seed (poly-A under -H)
                assert n[b] == 0
                continue
            found = seed_search_model(kb[order], pb_[order], rank, kb, pb_,
                                      vb, 3)
            hit = found >= 0
            hit[hit] &= kb[order][found[hit]] == kb[hit]
            per = pb_ - np.where(hit, pb_[order][np.maximum(found, 0)], 0)
            hit &= per <= 500
            m = int(n[b])
            np.testing.assert_array_equal(pb_[hit], ends[b, :m].numpy())
            np.testing.assert_array_equal(per[hit], pers[b, :m].numpy())


# ------------------------------------------------------- chain_dp ------

CHAIN_NEG = -(1 << 30)


def _chain_terms(E, P, cell, cur, hi, window, k):
    """terms of csrc/chain_dp.cu for the chunk of lanes p = hi - l: the
    S-free terms, and each lane's score S[p] (hit 0's where p < 0)."""
    ce, cp = cell
    cs = ce - cp
    p = hi - np.arange(32)
    q = {"in_win": cur - p <= window, "p": np.maximum(p, 0)}
    pe, pp = E[q["p"]], P[q["p"]]
    ps = pe - pp
    q["valid"] = q["in_win"] & (p >= 0) & (pe >= cs)
    q["conn"] = (q["valid"] & (cs > ps) & (5 * cp < 9 * pp)
                 & (5 * pp < 9 * cp))
    dis1, dis2 = ce - pe, cs - ps
    matched = np.minimum(dis1, k) + np.minimum(dis2, k)
    dlt = np.abs(cp - pp)
    lg = np.array([int(max(x, 1)).bit_length() - 1 for x in dis1 + dis2])
    q["add"] = matched - ((dlt * dlt >> 1) + (lg >> 1))
    q["stop0"] = q["conn"] & (dlt == 0)
    q["stopm"] = q["stop0"] & (matched < 2 * k)
    return q


def _chain_resolve(q, sc, hi, cp, st, full):
    """resolve of csrc/chain_dp.cu: the event ballot; updates st.  Unless
    `full`, a chunk whose lanes' run cannot reach cp takes the reduction
    path: the first S-free event, the SAME lanes before it tested by their
    prefix maxima, the greatest sc up to the event."""
    lanes = np.arange(32)
    if not full and st["iter"] + 32 < cp:
        st["redux"] += 1
        ev0 = q["in_win"] & (~q["valid"] | q["stopm"])
        e0 = int(np.argmax(ev0)) if ev0.any() else 32
        upto = lanes <= e0
        ev = ev0.copy()
        for j in np.nonzero(q["in_win"] & q["stop0"] & ~q["stopm"]
                            & (lanes < e0))[0]:
            st["same"] += 1
            pm = sc[:j].max() if j else CHAIN_NEG
            if sc[j] > max(pm, st["run_max"]):
                upto, ev = lanes <= j, lanes == j
                break
        m = int(np.where(upto, sc, CHAIN_NEG).max())
        if m > st["run_max"]:
            wl = int(np.argmax(upto & (sc == m)))
            st.update(best=m, run_max=m, best_p=hi - wl, iter=31 - wl)
        else:
            st["skipped"] += 1
            st["iter"] += 32
        return ev
    st["prefix"] += 1
    before = np.maximum(np.concatenate(
        [[CHAIN_NEG], np.maximum.accumulate(sc)[:-1]]), st["run_max"])
    imp = q["conn"] & (sc > before)
    last = np.maximum.accumulate(np.where(imp, lanes, -1))
    run = np.where(last >= 0, lanes - last, st["iter"] + lanes + 1)
    stop = q["stopm"] | (q["stop0"] & imp)
    ev = q["in_win"] & (~q["valid"] | stop | (run >= cp))
    e = int(np.argmax(ev)) if ev.any() else 32
    take = lanes < e
    if e < 32 and stop[e] and imp[e]:
        take[e] = True
    cand = imp & take
    if cand.any():
        wl = int(np.nonzero(cand)[0].max())
        st.update(best=int(sc[wl]), best_p=hi - wl, run_max=int(sc[wl]))
    st["iter"] = (31 - int(np.nonzero(imp)[0].max()) if imp.any()
                  else st["iter"] + 32)
    return ev


CHAIN_COUNTS = ("redux", "skipped", "same", "prefix")


def chain_dp_model(ends, periods, n_hits, k, window, full=False):
    """csrc/chain_dp.cu's schedule: each cell's first chunk (its terms and
    the scores of lanes p <= cur - 2) loaded during the cell before, lane 0
    (p = cur - 1) taking that cell's result; later chunks loaded one
    ahead; each chunk resolved by the reduction path where no run can
    reach the period (with `full`: never).  Returns (score, from,
    fallback, path counts)."""
    B, L = ends.shape
    score = np.zeros((B, L), np.int64)
    frm = np.full((B, L), -1, np.int64)
    fb = np.zeros(B, bool)
    counts = dict.fromkeys(CHAIN_COUNTS, 0)
    lanes = np.arange(32)
    for b in range(B):
        n = int(n_hits[b])
        E, P = ends[b, :n].astype(np.int64), periods[b, :n].astype(np.int64)
        if n and ((P >= 1 << 15).any() or (E >= 1 << 30).any()
                  or (E[1:] == E[:-1]).any()):
            fb[b] = True
            continue
        S = k + np.minimum(k, P)
        if n >= 2:
            s_prev = int(S[0])
            f = _chain_terms(E, P, (E[1], P[1]), 1, 0, window, k)
            fs = S[f["p"]]
        for cur in range(1, n):
            ce, cp = int(E[cur]), int(P[cur])
            base = k + min(k, cp)
            nx = min(cur + 1, n - 1)
            fn = _chain_terms(E, P, (E[nx], P[nx]), nx, nx - 1, window, k)
            fns = S[fn["p"]].copy()         # lane 0's is not final yet
            st = dict(run_max=base, best=base, best_p=-1, iter=0,
                      **dict.fromkeys(CHAIN_COUNTS, 0))
            own = np.where(lanes > 0, fs, s_prev)
            ev = _chain_resolve(f, np.where(f["conn"], own + f["add"],
                                            CHAIN_NEG), cur - 1, cp, st, full)
            edge = cur - 32 <= cur - window
            hi = cur - 33
            while not ev.any() and not edge:
                t = _chain_terms(E, P, (ce, cp), cur, hi, window, k)
                ev = _chain_resolve(t, np.where(t["conn"], S[t["p"]]
                                                + t["add"], CHAIN_NEG),
                                    hi, cp, st, full)
                edge = hi - 31 <= cur - window
                hi -= 32
            fb[b] |= not ev.any()
            for key in CHAIN_COUNTS:
                counts[key] += st[key]
            if st["best_p"] >= 0:
                S[cur], frm[b, cur] = st["best"], st["best_p"]
            s_prev, f, fs = st["best"], fn, fns
        score[b, :n] = S
    return score, frm, fb, counts


@pytest.mark.parametrize("window", [None, 64, 24], ids=["full", "w64",
                                                         "w24"])
def test_chain_skip_leaves_outputs_unchanged(window):
    """On the fuzz rows of test_torch_chaining_device, the reduction path
    (its skip where the chunk maximum is at most the running maximum, its
    SAME tests) leaves score, from and fallback as
    the full resolution gives them, and both equal chain_dp_plain and the
    JAX function."""
    from test_chaining_jax import _batch
    from test_torch_chaining_device import _corpus

    from tidehunter_tpu.ops.chaining_jax import chain_dp_batch
    from tidehunter_tpu_torch.ops import chaining_device as CD

    hit_list = _corpus(7, 14)
    ends, pers, cnt = _batch(hit_list)
    W = window or ends.shape[1]
    got = chain_dp_model(ends, pers, cnt, 8, W)
    full = chain_dp_model(ends, pers, cnt, 8, W, full=True)
    assert min(got[3][key] for key in ("redux", "skipped", "same")) > 0
    # a first chunk takes the prefix path only at a period <= 32 (none in
    # this corpus), a later one where iter nears the period
    if W > 32:
        assert got[3]["prefix"] > 0
    assert full[3]["redux"] == 0 and full[3]["prefix"] > got[3]["prefix"]
    want = CD.chain_dp_plain(*map(torch.from_numpy, (ends, pers, cnt)), k=8,
                             window=W)
    js = chain_dp_batch(ends, pers, cnt, k=8, window=W)
    for g, f, x, j in zip(got[:3], full[:3], want, js):
        np.testing.assert_array_equal(g, f)
        np.testing.assert_array_equal(g, x.numpy())
    served = ~got[2]
    np.testing.assert_array_equal(got[2], np.asarray(js[2]))
    for i in np.nonzero(served)[0]:
        m = int(cnt[i])
        np.testing.assert_array_equal(got[0][i, :m], np.asarray(js[0])[i, :m])
        np.testing.assert_array_equal(got[1][i, :m], np.asarray(js[1])[i, :m])


# ------------------------------------------------------- myers_hw ------

MYERS_THREADS, = _csrc("myers_hw.cu", r"MYERS_THREADS = (\d+);")
MYERS_LANES_PER_SM, = _csrc("myers_hw.cu", r"LANES_PER_SM = (\d+);")
MYERS_NO_KEY = (1 << 64) - 1
MYERS_MODEL_LANES = (1, 4, 32, 128)   # several a warp, a warp, 4 warps


def myers_lanes(B, sms):
    """myers_hw_lanes of csrc/myers_hw.cu: the largest power of two P <=
    MYERS_THREADS with B P <= LANES_PER_SM x sms, at least 1."""
    P = 1
    while P < MYERS_THREADS and B * 2 * P <= MYERS_LANES_PER_SM * sms:
        P *= 2
    return P


def myers_warmup(m, k):
    """O of csrc/myers_hw.cu: an alignment of cost d spans at most m + d
    columns, and d <= k (k >= 0) and d <= m."""
    return m + (m if k < 0 or k > m else k) - 1


def _myers_peq(codes):
    peq = [0] * 5
    for i, c in enumerate(codes):
        peq[int(c)] |= 1 << i
    return peq


def _myers_brev(peq, m):
    """reverse_peq of csrc/myers_hw.cu: each mask's 64 W bits reversed,
    then shifted right by 64 W - m."""
    bits = 64 * (1 if m <= 64 else 2)
    return [int(format(v, f"0{bits}b")[::-1], 2) >> (bits - m) for v in peq]


def _myers_scores(peq, m, codes, shw):
    """myers_step over the columns of codes from the fresh state: the score
    of the last query row after each (HW injects 0 at the top, SHW 1)."""
    mask, top = (1 << m) - 1, 1 << (m - 1)
    pv, mv, score = mask, 0, m
    for c in codes:
        eq = peq[int(c)]
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        score += bool(ph & top) - bool(mh & top)
        ph = ((ph << 1) | shw) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
        yield score


def _myers_reduce(keys):
    """The least key of a problem's P lanes as csrc/myers_hw.cu takes it:
    xor shuffles over d = 1, 2, ... < min(P, 32), then (P > 32) each lane
    the least of the warps' keys in shared memory; every lane ends with
    the same key."""
    P, k = len(keys), list(keys)
    d = 1
    while d < min(P, 32):
        k = [min(k[i], k[i ^ d]) for i in range(P)]
        d *= 2
    if P > 32:
        warps = [k[w * 32] for w in range(P // 32)]
        k = [min([k[i], *warps]) for i in range(P)]
    assert len(set(k)) == 1
    return k[0]


def myers_hw_model(q, t, k, P, warmup=myers_warmup):
    """(ed, start, end) of one problem (query and target codes 0..4) as
    csrc/myers_hw.cu computes it on P lanes: lane s scores its segment
    [s S, s S + S), S = ceil(n / P), after warmup(m, k) unreported columns
    from the fresh state; the lanes' (score << 32 | column) keys reduce to
    the least; the SHW pass over the reversed masks runs min(end + 1, m +
    ed) columns of t[end], t[end - 1], ...  (-1, -1, -1) past k."""
    m, n = len(q), len(t)
    peq = _myers_peq(q)
    S, O = -(-n // P), warmup(m, k)
    keys = []
    for s in range(P):
        a, e = min(n, s * S), min(n, s * S + S)
        key = MYERS_NO_KEY
        if a < e:
            best, col = 1 << 30, -1
            j0 = max(0, a - O)
            for j, sc in enumerate(_myers_scores(peq, m, t[j0:e], 0), j0):
                if j >= a and sc < best:
                    best, col = sc, j
            key = best << 32 | col
        keys.append(key)
    key = _myers_reduce(keys)
    best, end = key >> 32, key & 0xFFFFFFFF
    if k >= 0 and best > k:
        return -1, -1, -1
    rpeq = _myers_brev(peq, m)
    assert rpeq == _myers_peq(q[::-1])
    cols = min(end + 1, m + best)
    pos = -1
    for j, sc in enumerate(_myers_scores(rpeq, m, t[end::-1][:cols], 1)):
        if sc == best:
            pos = j
    return best, end - pos, end


def _myers_boundary_cases():
    """Equal scores on both sides of segment boundaries: 84 and 25 bp
    adapters twice in a doubled consensus (one copy in each half), and
    tandem targets (a query back to back, exact and at 10% error)."""
    import test_torch_myers as TM

    rng = np.random.default_rng(11)
    qs, ts, ks = [], [], []
    cons = TM._rand_seq(rng, 200)
    for q in (TM.FIVE, TM.THREE):
        unit = cons[:90] + TM._mutseq(rng, q, 0.05) + cons[90:]
        for k in (-1, 0, 6, len(q)):
            qs.append(q)
            ts.append(unit + unit)
            ks.append(k)
    for m in (7, 33, 64):
        q = TM._rand_seq(rng, m)
        for tgt in (q * 9, "".join(TM._mutseq(rng, q, 0.1)
                                   for _ in range(6))):
            for k in (-1, 2):
                qs.append(q)
                ts.append(tgt)
                ks.append(k)
    return qs, ts, ks


def _myers_k_cases():
    """k = -1, 0, m and past m, queries of 1, 64, 65 and 128 bp, each in a
    random target holding a noisy copy of it."""
    import test_torch_myers as TM

    rng = np.random.default_rng(12)
    qs, ts, ks = [], [], []
    for m in (1, 64, 65, 128):
        q = TM._rand_seq(rng, m)
        t = TM._rand_seq(rng, 150)
        t = t[:70] + TM._mutseq(rng, q, 0.08) + t[70:]
        for k in (-1, 0, m, m + 7):
            qs.append(q)
            ts.append(t)
            ks.append(k)
    return qs, ts, ks


def _myers_edge_cases():
    """Targets shorter than one segment and than the query, all-N targets
    (with and without N in the query), and the best score at column 0 and
    at the last column."""
    import test_torch_myers as TM

    rng = np.random.default_rng(13)
    q65 = TM._rand_seq(rng, 65)
    rows = [("ACGTA", "G", -1), ("ACGTA", "CGT", 1), (q65, q65[10:40], -1),
            (q65, q65[:64], 3), ("A", "C", 0), ("A", "A", 0),
            ("ACGT", "N" * 50, -1), ("ACGT", "N" * 50, 2),
            ("ACNNT", "N" * 50, -1), (q65, "N" * 300, -1),
            ("GGGG", "G" + "T" * 100, -1), ("GGGG", "G" + "T" * 100, 3),
            (q65, q65 + TM._rand_seq(rng, 200), 5),
            (q65, TM._rand_seq(rng, 237) + q65, -1),
            ("ACGTTGCA", TM._rand_seq(rng, 400) + "ACGTTGCA", 0)]
    return tuple(list(x) for x in zip(*rows))


MYERS_CASES = {"boundaries": _myers_boundary_cases, "k": _myers_k_cases,
               "edges": _myers_edge_cases}


def _myers_all_cases():
    import test_torch_myers as TM

    return {**{f"tm_{k}": v for k, v in TM.CASES.items()}, **MYERS_CASES}


@pytest.mark.parametrize("case", list(_myers_all_cases()))
def test_myers_schedule_matches_plain_jax_and_oracle(case):
    """The model at 1, 4, 32 and 128 lanes a problem gives hw_batch_plain's,
    align_hw's and the JAX hw_batch's (ed, start, end) on every case of
    test_torch_myers and on MYERS_CASES."""
    from test_torch_myers import _tensors

    from tidehunter_tpu.ops.myers_jax import hw_batch as jax_hw_batch
    from tidehunter_tpu_torch.ops import myers_device as MY
    from tidehunter_tpu_torch.ops.myers import align_hw

    queries, targets, ks = _myers_all_cases()[case]()
    plain = MY.hw_batch_plain(*_tensors(queries, targets, ks)).T.tolist()
    oracle = [align_hw(q, t, k) for q, t, k in zip(queries, targets, ks)]
    assert jax_hw_batch(queries, targets, ks) == oracle
    for P in MYERS_MODEL_LANES:
        for r, (q, t, k) in enumerate(zip(queries, targets, ks)):
            got = myers_hw_model(MY.encode5(q), MY.encode5(t), k, P)
            assert list(got) == plain[r], (case, P, r)
            ed, st, en = oracle[r]
            assert got == (ed, -1 if st is None else st,
                           -1 if en is None else en), (case, P, r)


def _myers_tight_case(m, k, P, n):
    """A target of n columns holding the query with k random bases inserted
    inside it (an alignment of cost k over m + k columns) ending at the
    first column a of segment P // 2 (S = ceil(n / P)), in random filler;
    the seed is the first for which align_hw places it there."""
    import test_torch_myers as TM

    from tidehunter_tpu_torch.ops.myers import align_hw

    a = -(-n // P) * (P // 2)
    for seed in range(100):
        rng = np.random.default_rng(seed)
        q = TM._rand_seq(rng, m)
        at = sorted(rng.choice(np.arange(1, m), k, replace=False))
        body = "".join(TM._rand_seq(rng, 1) + c if i in at else c
                       for i, c in enumerate(q))
        t = (TM._rand_seq(rng, a + 1 - len(body)) + body
             + TM._rand_seq(rng, n - a - 1))
        if align_hw(q, t, k) == (k, a + 1 - m - k, a):
            return q, t
    raise AssertionError("no seed places the alignment at the boundary")


@pytest.mark.parametrize("m,k,P,n", [(20, 3, 4, 400), (64, 12, 8, 600),
                                     (65, 13, 32, 900), (128, 25, 128, 1200)])
def test_myers_warmup_is_tight(m, k, P, n):
    """An alignment of the largest cost allowed that starts m + k - 1
    columns before a segment's first column and ends on it: the model with
    O = myers_warmup(m, k) finds it, one column less of warm-up does not
    (the lane cannot start the alignment, and the search then reports
    nothing within k)."""
    from tidehunter_tpu_torch.ops import myers_device as MY
    from tidehunter_tpu_torch.ops.myers import align_hw

    q, t = _myers_tight_case(m, k, P, n)
    want = align_hw(q, t, k)
    qc, tc = MY.encode5(q), MY.encode5(t)
    assert myers_hw_model(qc, tc, k, P) == want
    short = myers_hw_model(qc, tc, k, P,
                           warmup=lambda m, k: myers_warmup(m, k) - 1)
    assert short != want and short == (-1, -1, -1)
