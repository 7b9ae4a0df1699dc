"""The port's seeding offload (tidehunter_tpu_torch/ops/offload.py) on
the CPU against the JAX package's (ops/offload.py, XLA on the CPU) and
against the host seeder + native chainer.

device_seed_chain must hand back the same hits as both, for every row
(N rows and w > 1 fallbacks rerouted to the host seeder and counted as
offload_seed_fb, too-short rows empty), and, with chain_mode="device",
the chains the native chainer selects; len_bucket and supported are the
JAX package's ladder and gate.
"""

import numpy as np
import pytest
import torch
from test_offload import _random_reads

from tidehunter_tpu.ops import offload as JO
from tidehunter_tpu.params import Params as JaxParams
from tidehunter_tpu_torch.ops import offload as TO
from tidehunter_tpu_torch.ops.chaining_native import tandem_chain_native
from tidehunter_tpu_torch.ops.seeding import collect_tandem_repeat_hits
from tidehunter_tpu_torch.params import Params
from tidehunter_tpu_torch.utils.metrics import METRICS

torch.set_num_threads(1)


def _key(chains):
    return [(list(map(int, c.cells)), c.est_period, c.est_start, c.est_ch_i)
            for c in chains]


def _reads(seed, w):
    rng = np.random.default_rng(seed)
    reads = _random_reads(rng, 24, 900, n_frac=0.01 if w == 1 else 0.0)
    reads += [np.full(120, 4, np.uint8), np.zeros(4, np.uint8),
              np.full(95, 2, np.uint8)]
    reads[3] = reads[3].copy()
    reads[3][len(reads[3]) // 2] = 4              # an N row with w > 1 too
    return reads


@pytest.mark.parametrize("chain_mode", ["host", "device"])
@pytest.mark.parametrize("w,hpc", [(1, False), (1, True), (5, False)])
def test_device_seed_chain_matches_jax_and_host(chain_mode, w, hpc):
    mtp, jmtp = Params(), JaxParams()
    mtp.w = jmtp.w = w
    mtp.hpc = jmtp.hpc = hpc
    reads = _reads(7 + w + hpc, w)
    bseqs = [r if len(r) >= mtp.k else None for r in reads]
    METRICS.reset()
    hits, chains = TO.device_seed_chain(bseqs, mtp, chain_mode=chain_mode,
                                        device="cpu")
    fb = METRICS.snapshot().get("offload_seed_fb", 0)
    jhits, jchains = JO.device_seed_chain(bseqs, jmtp, chain_mode=chain_mode)
    rerouted = sum(1 for b in bseqs if b is not None and (b >= 4).any())
    assert fb >= rerouted >= 2
    for i, r in enumerate(reads):
        np.testing.assert_array_equal(hits[i][0], jhits[i][0], f"read {i}")
        np.testing.assert_array_equal(hits[i][1], jhits[i][1], f"read {i}")
        if bseqs[i] is None:
            assert chains[i] == (None, []) and len(hits[i][0]) == 0
            continue
        we, wp = collect_tandem_repeat_hits(r, mtp.k, w, hpc, mtp.min_p,
                                            mtp.max_p)
        np.testing.assert_array_equal(hits[i][0], we, f"read {i}")
        np.testing.assert_array_equal(hits[i][1], wp, f"read {i}")
        if chain_mode == "host" or (r >= 4).any():
            assert chains[i] is None        # the caller's host chainer
            continue
        if chains[i] is None:               # a seed fallback row
            assert w > 1
            continue
        want = _key(tandem_chain_native(we, wp, mtp.k)[1])
        assert _key(chains[i][1]) == want, f"read {i}"
        if jchains[i] is not None:
            assert _key(jchains[i][1]) == want


def test_len_bucket_and_supported_match_jax():
    for n in (1, 1000, 1024, 1025, 1536, 1537, 2048, 3000, 4395, 6144,
              8193, 12300, 30000, 70000):
        assert TO.len_bucket(n) == JO.len_bucket(n)
        for k in (5, 8, 9, 12, 16):
            assert TO.supported(k, n) == JO.supported(k, n)


def test_pack_reads_holds_the_jax_rows():
    """A byte a base here, the quarter-block nibbles there: the same codes
    and lengths for every row without N; N rows and None go up empty."""
    reads = _reads(3, 1)
    bseqs = [r if len(r) >= 8 else None for r in reads]
    B, L = len(bseqs), 1024
    arr, lens, has_n = TO.pack_reads(bseqs, B, L)
    jp, jlens, jhas_n = JO.pack_reads(bseqs, B, L)
    unpacked = np.concatenate([(jp >> s) & 3 for s in (0, 2, 4, 6)], axis=1)
    np.testing.assert_array_equal(has_n, jhas_n)
    for i, b in enumerate(bseqs):
        if b is None or has_n[i]:
            assert lens[i] == 0 and (arr[i] == 4).all()
            continue
        assert lens[i] == jlens[i] == len(b)
        np.testing.assert_array_equal(arr[i, :lens[i]],
                                      unpacked[i, :lens[i]])
        assert (arr[i, lens[i]:] == 4).all()
