"""The port's chain DP (tidehunter_tpu_torch/ops/chaining_device.py)
against the JAX package's (ops/chaining_jax.py, XLA on the CPU) and the
host chainers, on the CPU, where chain_dp_batch runs its plain version.

Exact equality: the fallback flag of every row; score and from of every
row neither flags; and the chains tandem_chain_from_dp selects from them
equal the port's native chainer's and the sequential oracle's.  At a small
window a row is either exact or flagged, never silently wrong.  The kernel
(csrc/chain_dp.cu) is held to the plain version in
test_torch_csrc_shim.py and on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch
from test_chaining_jax import _batch, _hits, _random_read

from tidehunter_tpu.ops.chaining_jax import chain_dp_batch as jax_chain_dp
from tidehunter_tpu_torch.ops import chaining_device as CD
from tidehunter_tpu_torch.ops.chaining import tandem_chain
from tidehunter_tpu_torch.ops.chaining_native import (
    tandem_chain_from_dp,
    tandem_chain_native,
)

torch.set_num_threads(1)


def _key(chains):
    return [(list(map(int, c.cells)), c.est_period, c.est_start, c.est_ch_i)
            for c in chains]


def _parity(hit_list, window=None, L=None):
    """Both DPs on one batch; returns (rows checked exact, rows flagged)."""
    ends, pers, cnt = _batch(hit_list, L=L)
    W = window or ends.shape[1]
    score, frm, fb = (t.numpy() for t in CD.chain_dp_batch(
        torch.from_numpy(ends), torch.from_numpy(pers),
        torch.from_numpy(cnt), k=8, window=W))
    js, jf, jfb = (np.asarray(t) for t in jax_chain_dp(ends, pers, cnt, k=8,
                                                      window=W))
    np.testing.assert_array_equal(fb, jfb)
    exact = 0
    for i, (e, p) in enumerate(hit_list):
        n = len(e)
        if fb[i]:
            continue
        np.testing.assert_array_equal(score[i, :n], js[i, :n], f"row {i}")
        np.testing.assert_array_equal(frm[i, :n], jf[i, :n], f"row {i}")
        assert (score[i, n:] == 0).all() and (frm[i, n:] == -1).all()
        if n < 2:
            continue
        exact += 1
        dp, want = tandem_chain(np.asarray(e), np.asarray(p), 8)
        np.testing.assert_array_equal(score[i, :n], dp.score)
        np.testing.assert_array_equal(frm[i, :n], dp.from_idx)
        _, got = tandem_chain_from_dp(e, p, score[i, :n].astype(np.int64),
                                      frm[i, :n].astype(np.int64), 8)
        assert _key(got) == _key(tandem_chain_native(e, p, 8)[1]), f"row {i}"
    return exact, int(fb.sum())


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    hits = [_hits(_random_read(rng)) for _ in range(n)]
    return [(e, p) for e, p in hits if len(e) >= 2]


# the fuzz corpus of test_chaining_jax at its window (512), at the full
# window (never incomplete: every row exact) and at 64 (exact or flagged)
@pytest.mark.parametrize("window,seed,n", [(512, 7, 48), (None, 7, 48),
                                           (64, 11, 24)],
                         ids=["w512", "full", "w64"])
def test_chain_dp_matches_jax(window, seed, n):
    hit_list = _corpus(seed, n)
    assert len(hit_list) >= 15
    exact, flagged = _parity(hit_list, window)
    if window is None:
        assert flagged == 0 and exact == len(hit_list)
    else:
        assert exact >= 1 and flagged >= 1


def test_envelope_gate_flags_rows():
    """A non-singleton end group, a period >= 2^15 and an end >= 2^30
    each flag their row (JAX's flags too) and leave the others exact;
    rows of 0 and 1 hits are served."""
    good = _corpus(13, 6)[:2]
    rows = good + [
        (np.array([100, 200, 200, 300]), np.array([50, 50, 60, 50])),
        (np.array([40000, 80000]), np.array([33000, 40000])),
        (np.array([1 << 30, (1 << 30) + 60]), np.array([50, 60])),
        (np.array([77]), np.array([40])),
        (np.zeros(0, np.int64), np.zeros(0, np.int64)),
    ]
    ends, pers, cnt = _batch(rows)
    _, _, fb = CD.chain_dp_batch(torch.from_numpy(ends),
                                 torch.from_numpy(pers),
                                 torch.from_numpy(cnt), k=8,
                                 window=ends.shape[1])
    assert fb.tolist() == [False, False, True, True, True, False, False]
    exact, flagged = _parity(rows)
    assert flagged == 3


def test_cell_zero_and_short_rows():
    ends, pers, cnt = _batch([(np.array([120]), np.array([45])),
                              (np.array([100, 160]), np.array([60, 60]))],
                             L=8)
    score, frm, fb = CD.chain_dp_batch(torch.from_numpy(ends),
                                       torch.from_numpy(pers),
                                       torch.from_numpy(cnt), k=8, window=8)
    assert not fb.any()
    assert score[0, 0] == 16 and frm[0, 0] == -1
    assert frm[1, 0] == -1 and score[1, 0] == 16


def test_chain_dp_refuses_bad_inputs():
    e = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        CD.chain_dp_batch(e, e[:, :3], torch.zeros(2, dtype=torch.int32),
                          k=8)
    with pytest.raises(ValueError):
        CD.chain_dp_batch(e, e, torch.zeros(2, dtype=torch.int32), k=8,
                          window=0)
