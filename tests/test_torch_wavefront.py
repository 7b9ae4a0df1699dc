"""PyTorch port of the wavefront alignment (tidehunter_tpu_torch/ops/
wavefront.py) against the NumPy oracle ops/ksw2.py and the JAX package's
Pallas kernels in interpret mode, on the CPU (the plain versions of
wf_global and wf_ext).  Tolerance: exact integer equality.
"""

import numpy as np
import pytest
import torch

from tidehunter_tpu.ops import ksw2
from tidehunter_tpu.ops import wavefront as WF
from tidehunter_tpu_torch.ops import wavefront as TW

torch.set_num_threads(1)

B = 8   # one interpret-mode tile at _TILE_CELLS = 1024


def _batch(rng, LQ, LT, sim):
    q = np.full((B, LQ), 4, np.uint8)
    t = np.full((B, LT), 4, np.uint8)
    qlen = np.ones(B, np.int32)
    tlen = np.ones(B, np.int32)
    qle = np.zeros(B, np.int32)
    for b in range(B):
        m = int(rng.integers(1, LQ + 1))
        n = int(rng.integers(1, LT + 1))
        m, n = {0: (1, 1), 1: (LQ, 1), 2: (1, LT), 3: (LQ, LT)}.get(b, (m, n))
        qs = rng.integers(0, 5, m).astype(np.uint8)
        ts = rng.integers(0, 5, n).astype(np.uint8)
        if sim:
            k = min(m, n)
            ts[:k] = np.where(rng.random(k) < 0.85, qs[:k], ts[:k])
        q[b, :m] = qs
        t[b, :n] = ts
        qlen[b], tlen[b] = m, n
        qle[b] = [0, m, int(rng.integers(0, m + 1))][b % 3]
    return q, qlen, t, tlen, qle


def _oracle(q, qlen, t, tlen, qle):
    rows = []
    for b in range(B):
        qs, ts = q[b, :qlen[b]], t[b, :tlen[b]]
        iden, cig = ksw2.global_with_cigar(qs, ts)
        tle = ksw2.backtrack_left_end(cig, int(qle[b]))
        rs = ksw2.extz(qs, ts, score_only=True)
        r = ksw2.extz(qs, ts)
        rows.append((iden, tle, rs.max, rs.max_t, rs.max_q, r.score))
    return np.array(rows)


def _port(q, qlen, t, tlen, qle):
    tq, tql, tt, ttl, tqe = map(torch.from_numpy, (q, qlen, t, tlen, qle))
    iden, tleft = TW.global_batch(tq, tql, tt, ttl, tqe)
    ionly, zeros = TW.global_batch(tq, tql, tt, ttl, tqe, iden_only=True)
    mx, mt, mq, sc = TW.ext_batch(tq, tql, tt, ttl)
    outs = (iden, tleft, ionly, zeros, mx, mt, mq, sc)
    assert all(o.dtype == torch.int32 and o.shape == (B,) for o in outs)
    assert not zeros.any()
    return np.stack([o.numpy() for o in (iden, tleft, mx, mt, mq, sc)],
                    axis=1), ionly.numpy()


@pytest.mark.parametrize("LQ,LT", [(32, 32), (32, 64)])
@pytest.mark.parametrize("seed,sim", [(0, True), (1, False), (2, True)])
def test_plain_matches_oracle_and_jax(monkeypatch, seed, sim, LQ, LT):
    monkeypatch.setattr(WF, "INTERPRET", True)
    monkeypatch.setattr(WF, "_TILE_CELLS", 1024)   # tile_b -> 8 rows
    assert WF.tile_b(LT) == B
    rng = np.random.default_rng(seed)
    q, qlen, t, tlen, qle = _batch(rng, LQ, LT, sim)
    want = _oracle(q, qlen, t, tlen, qle)
    got, ionly = _port(q, qlen, t, tlen, qle)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ionly, want[:, 0])

    jiden, jtl = WF.global_batch(q, qlen, t, tlen, qle)
    jionly, _ = WF.global_batch(q, qlen, t, tlen, qle, iden_only=True)
    jext = WF.ext_batch(q, qlen, t, tlen)
    jax_rows = np.stack([np.asarray(x) for x in (jiden, jtl, *jext)], axis=1)
    np.testing.assert_array_equal(got, jax_rows)
    np.testing.assert_array_equal(ionly, np.asarray(jionly))


def test_wrapper_rejects_bad_input():
    q = torch.zeros((2, 4), dtype=torch.uint8)
    n = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        TW.global_batch(q.int(), n, q, n, n)
    with pytest.raises(ValueError):
        TW.ext_batch(q, n, torch.zeros((3, 4), dtype=torch.uint8), n)
    wide = torch.zeros((2, TW.MAX_T + 1), dtype=torch.uint8)
    with pytest.raises(ValueError):
        TW.ext_batch(q, n, wide, n)
