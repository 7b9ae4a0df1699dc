"""The port's --polish rounds of the device MSA on the CPU:
``polish_update`` alone against the JAX function (jit on the CPU) on the
ops and nst of a real round and on paths that run past T, and
``DeviceMSA(polish=n)`` against the host mirror
``banded_profile_consensus(polish=n)`` at full width and on a band rung,
with a band touch and a bucket overflow.  Exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_msa_device as TMDT
import torch

from tidehunter_tpu.ops import msa_device as MD
from tidehunter_tpu.ops.poa_profile import banded_profile_consensus
from tidehunter_tpu_torch.ops import msa_device as TMD

torch.set_num_threads(1)

GAPS = TMDT.GAPS


def _random_ops(rng, T):
    """Compacted ops rows (right-anchored, OP_PAD before) whose paths run
    past T steps: steps past T still vote into columns below T."""
    NL = TMD.n_levels(T)
    ops = np.full((TMDT.B, NL), TMD.OP_PAD, np.int8)
    nst = rng.integers(T // 2, 2 * T, TMDT.B).astype(np.int32)
    for b in range(TMDT.B):
        ops[b, NL - nst[b]:] = rng.choice([0, 0, 0, 1, 2], nst[b])
    return ops, nst


@pytest.mark.parametrize("T,W,lo,hi", [(128, None, 60, 90),
                                       (256, 128, 150, 190)])
def test_polish_update_matches_jax(T, W, lo, hi):
    """polish_update on the ops and nst of a real round (and on random
    ops past T) equals the JAX function, jit on the CPU."""
    rng = np.random.default_rng(T + 1)
    st_np, unit, qlen, active = TMDT._state_and_unit(rng, T, lo, hi)
    tm = TMD.DeviceMSA(2, 4, 4, 2, device="cpu", **GAPS)
    state = TMD.state_from_numpy(*st_np, device="cpu")
    unit_t, qlen_t, active_t = map(torch.from_numpy, (unit, qlen, active))
    _, ops, nst, _ = tm._align(state, unit_t, qlen_t, T, W)
    jm = MD.DeviceMSA(2, 4, 4, 2, **GAPS)
    votes = rng.integers(0, 4, st_np[0].shape).astype(np.int16)
    rops, rnst = _random_ops(rng, T)
    for ops_np, nst_np in ((ops.numpy(), nst.numpy()), (rops, rnst)):
        got = tm.polish_update(torch.from_numpy(votes), state.ncol,
                               active_t, unit_t, torch.from_numpy(ops_np),
                               torch.from_numpy(nst_np))
        want = jm.polish_update(jnp.asarray(votes), jnp.asarray(st_np[2]),
                                jnp.asarray(active),
                                jnp.asarray(unit.astype(np.int32)),
                                jnp.asarray(ops_np),
                                jnp.asarray(nst_np[:, None]))
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("polish,picks", [(1, None), (2, (0, 2))])
def test_device_msa_polish_matches_host(polish, picks):
    """DeviceMSA(polish=n) equals banded_profile_consensus(polish=n) on
    regions at T=128 (full width) and T=256 (W=128), a band touch and a
    bucket overflow (polish=2: the first two kinds), in the manner of
    test_msa_device.py:72."""
    regions = TMDT._regions(np.random.default_rng(5))
    regions = [regions[i] for i in picks] if picks else regions
    got = TMD.DeviceMSA(2, 4, 4, 2, polish=polish, device="cpu",
                        **GAPS).consensus_batch(regions)
    for reg, g in zip(regions, got):
        want = banded_profile_consensus(reg, 2, 4, 4, 2, polish=polish,
                                        **GAPS)
        assert g is not None
        np.testing.assert_array_equal(g[0], want[0])
        np.testing.assert_array_equal(g[1], want[1])
