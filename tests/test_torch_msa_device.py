"""PyTorch port of the device MSA (tidehunter_tpu_torch/ops/msa_device.py)
against the JAX package and the host mirror, on the CPU.

One unit round — full width at T=128 and banded at T=256, W=128 — goes
from the same NumPy state (state_from_numpy) through the JAX DeviceMSA
pieces in Pallas interpret mode and through the port's plain round: the
scores, the direction plane (live rows), ops/nst/tch and the updated state
must be identical.  consensus_batch must equal banded_profile_consensus,
including a band-touch retry and a bucket overflow.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tidehunter_tpu.ops import msa_device as MD
from tidehunter_tpu.ops.poa_profile import (
    Profile,
    align_to_profile,
    band_ladder,
    banded_profile_consensus,
)
from tidehunter_tpu.utils.metrics import METRICS
from tidehunter_tpu_torch.ops import msa_device as TMD

torch.set_num_threads(1)

B = 8
GAPS = dict(gap_open2=24, gap_ext2=1)


def _mut(rng, u, err):
    out = []
    for c in u:
        r = rng.random()
        if r < err / 3:
            continue
        elif r < 2 * err / 3:
            out.extend([rng.integers(0, 4), c])
        elif r < err:
            out.append(rng.integers(0, 4))
        else:
            out.append(c)
    return np.array(out, np.uint8)


def _state_and_unit(rng, T, lo, hi):
    """A mid-region state: each row's profile holds 2-3 placed units of
    a random unit (host Profile), plus the next unit to place."""
    counts = np.zeros((B, T, 5), np.int16)
    n_placed = np.ones(B, np.int32)
    ncol = np.ones(B, np.int32)
    unit = np.full((B, T), 4, np.uint8)
    qlen = np.ones(B, np.int32)
    for b in range(B):
        base = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        units = [_mut(rng, base, 0.1)[:T] for _ in range(4)]
        prof = Profile(units[0].astype(np.int64))
        for u in units[1:1 + int(rng.integers(1, 3))]:
            ops = align_to_profile(u.astype(np.int64),
                                   prof.sub_scores(2, 4),
                                   prof.del_weights(2), 4, 2)
            prof.update(u.astype(np.int64), ops)
        n = min(prof.ncol, T)
        counts[b, :n] = prof.counts[:n]
        ncol[b] = n
        n_placed[b] = prof.n_placed
        unit[b, :len(units[-1])] = units[-1]
        qlen[b] = max(1, len(units[-1]))
    active = np.ones(B, bool)
    active[-1] = False          # a row past its last unit
    qlen[-1] = 1
    overflow = np.zeros(B, bool)
    ev = np.zeros(B, np.int32)
    ev[0] = 1                   # first event already recorded
    return (counts, n_placed, ncol, overflow, ev), unit, qlen, active


@pytest.mark.parametrize("T,W,lo,hi", [(128, None, 60, 90),
                                       (256, 128, 150, 190)])
def test_round_matches_jax(monkeypatch, T, W, lo, hi):
    monkeypatch.setattr(MD, "INTERPRET", True)
    monkeypatch.setattr(MD, "_B_CAP", B)
    rng = np.random.default_rng(T)
    st_np, unit, qlen, active = _state_and_unit(rng, T, lo, hi)
    counts, n_placed, ncol, overflow, ev = st_np

    # JAX: the pieces of DeviceMSA._round, then the fused round itself
    jm = MD.DeviceMSA(2, 4, 4, 2, **GAPS)
    run_dp, Bj, LQplus = jm._dp_run(T, W, B)
    run_bt, _, NL = jm._bt_run(T, W, B)
    assert Bj == B
    jc, jn, jcol, jo, jev = map(jnp.asarray, st_np)
    ju, jq, ja = (jnp.asarray(unit.astype(np.int32)), jnp.asarray(qlen),
                  jnp.asarray(active))
    sub, wdel, wl, wdel2, wl2, qbuf = jm.scores_step(jc, jn, jcol, ju,
                                                     lqplus=LQplus)
    maxr = jnp.max(jq + jcol).reshape(1, 1)
    jdirs = run_dp(maxr, qbuf, sub, wl, wdel, wl2, wdel2, jq.reshape(-1, 1),
                   jcol.reshape(-1, 1))
    jops, jnst, jtch = run_bt(jdirs, jq.reshape(-1, 1), jcol.reshape(-1, 1))
    round_fn = jm._round(T, W, B)[0]
    jstate = round_fn(jc, jn, jcol, jo, jev, ju, jq, ja)

    # port, plain versions on the CPU
    tm = TMD.DeviceMSA(2, 4, 4, 2, device="cpu", **GAPS)
    state = TMD.state_from_numpy(*st_np, device="cpu")
    tsub, twdel, twl, twdel2, twl2 = tm.scores_step(state)
    for a, b in ((tsub, sub), (twdel, wdel), (twl, wl), (twdel2, wdel2),
                 (twl2, wl2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out = tm.round(state, torch.from_numpy(unit), torch.from_numpy(qlen),
                   torch.from_numpy(active), T, W)

    jdirs = np.asarray(jdirs)
    tdirs = out.dirs.numpy()
    assert tdirs.shape == (2 * T - 1, B, W or T)
    for b in range(B):
        live = qlen[b] + ncol[b] - 1
        np.testing.assert_array_equal(tdirs[:live, b], jdirs[:live, b])
    assert out.ops.shape == (B, NL)
    np.testing.assert_array_equal(out.ops.numpy(), np.asarray(jops))
    np.testing.assert_array_equal(out.nst.numpy(), np.asarray(jnst)[:, 0])
    np.testing.assert_array_equal(out.tch.numpy(), np.asarray(jtch)[:, 0])
    for a, b in zip(TMD.state_to_numpy(out.state), jstate):
        np.testing.assert_array_equal(a, np.asarray(b))


def _regions(rng):
    regs = []
    # T=128 full width and T=256 first rung W=128
    for L, n in ((70, 5), (95, 4), (150, 5), (175, 4)):
        base = rng.integers(0, 4, L).astype(np.uint8)
        regs.append([_mut(rng, base, 0.1) for _ in range(n)])
    # band touch at T=256, W=128 (dual-affine gaps): equal lengths, so the
    # rung is eligible, but unit 1 drops 114 bases after its first 10 and
    # gains 114 at its end -> the path reaches |c-j| = 114 >= 112
    base = rng.integers(0, 4, 200).astype(np.uint8)
    us = [_mut(rng, base, 0.03)[:200] for _ in range(4)]
    us[1] = np.concatenate([base[:10], base[124:],
                            rng.integers(0, 4, 114).astype(np.uint8)])
    assert band_ladder(256, max(map(len, us)) - min(map(len, us)))[0] == 128
    regs.append(us)
    # overflow: unrelated units outgrow the 1.2x margin of bucket 128
    regs.append([rng.integers(0, 4, 100).astype(np.uint8) for _ in range(6)])
    return regs


@pytest.mark.parametrize("gaps", [{}, GAPS], ids=["affine", "dual_24_1"])
def test_consensus_batch_matches_host(gaps):
    regions = _regions(np.random.default_rng(5))
    before = METRICS.snapshot()
    got = TMD.DeviceMSA(2, 4, 4, 2, device="cpu", **gaps).consensus_batch(
        regions)
    after = METRICS.snapshot()
    retries = ["msa_retry_ovf"] + (["msa_retry_touch"] if gaps else [])
    for key in retries:
        assert after.get(key, 0) > before.get(key, 0), key
    for reg, g in zip(regions, got):
        want = banded_profile_consensus(reg, 2, 4, 4, 2, **gaps)
        assert g is not None
        np.testing.assert_array_equal(g[0], want[0])
        np.testing.assert_array_equal(g[1], want[1])


def test_region_past_largest_bucket_returns_none():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, 120).astype(np.uint8)
    regions = [[_mut(rng, base, 0.05) for _ in range(3)]]
    tm = TMD.DeviceMSA(2, 4, 4, 2, device="cpu", buckets=(128,))
    assert tm.consensus_batch(regions) == [None]
