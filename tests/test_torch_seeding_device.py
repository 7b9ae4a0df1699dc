"""The port's device seeders (tidehunter_tpu_torch/ops/seeding_device.py)
against the JAX package's (ops/seeding_jax.py, XLA on the CPU) and the
host oracle, on the CPU, where each seeder runs its plain version
(seed_plain).  Exact equality: the hits and n_hits of every row the JAX
seeder does not flag, the fallback flags of every row, and the oracle's
hits for those rows.  The kernel itself (csrc/seed_hits.cu) is held to
seed_plain in test_torch_csrc_shim.py and on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_offload import _random_reads as _packed_reads
from test_seeding_jax import _random_reads

from tidehunter_tpu.ops import seeding_jax as SJ
from tidehunter_tpu.ops.seeding import collect_tandem_repeat_hits
from tidehunter_tpu_torch.ops import seeding_device as SD

torch.set_num_threads(1)

# the cases of test_seeding_jax.test_device_seeding_matches_oracle
ORACLE_CASES = [
    (8, 1, False, 30, 10000), (8, 1, True, 30, 10000), (5, 1, False, 2, 50),
    (13, 1, False, 30, 200), (16, 1, False, 30, 10000),
    (8, 5, False, 30, 10000), (8, 5, True, 30, 10000),
    (8, 2, False, 30, 10000), (13, 10, False, 2, 10000),
    (16, 3, False, 30, 10000)]
# the cases of test_offload.test_packed_seeder_matches_oracle
PACKED_CASES = [(8, 1, False, 30, 10000), (8, 1, True, 30, 10000),
                (5, 1, False, 2, 50), (8, 5, False, 30, 10000),
                (8, 2, True, 30, 10000)]


def _both(reads, k, w, hpc, min_p, max_p, L=None):
    batch, lens = SD.pad_batch(reads, L)
    mine = [t.numpy() for t in SD.collect_hits_batch(
        torch.from_numpy(batch), torch.from_numpy(lens), k=k, use_hpc=hpc,
        min_p=min_p, max_p=max_p, w=w)]
    jax = [np.asarray(t) for t in SJ.collect_hits_batch(
        jnp.asarray(batch), jnp.asarray(lens), k=k, use_hpc=hpc,
        min_p=min_p, max_p=max_p, w=w)]
    return mine, jax


def _check(reads, mine, jax, k, w, hpc, min_p, max_p):
    ends, periods, n, fb = mine
    np.testing.assert_array_equal(fb, jax[3])
    served = 0
    for i, r in enumerate(reads):
        if fb[i]:
            continue
        served += 1
        assert n[i] == jax[2][i], f"read {i}"
        np.testing.assert_array_equal(ends[i], jax[0][i], err_msg=f"read {i}")
        np.testing.assert_array_equal(periods[i], jax[1][i],
                                      err_msg=f"read {i}")
        we, wp = collect_tandem_repeat_hits(r, k, w, hpc, min_p, max_p)
        np.testing.assert_array_equal(ends[i, :n[i]], we, err_msg=f"read {i}")
        np.testing.assert_array_equal(periods[i, :n[i]], wp,
                                      err_msg=f"read {i}")
    return served


# every case on test_seeding_jax's reads (2% N: with w > 1 nearly every
# row falls back) and on the same reads without N (the minimizer rows
# are served)
@pytest.mark.parametrize("n_frac", [0.02, 0.0], ids=["with_N", "no_N"])
@pytest.mark.parametrize("k,w,hpc,min_p,max_p", ORACLE_CASES)
def test_collect_hits_batch_matches_jax(k, w, hpc, min_p, max_p, n_frac):
    rng = np.random.default_rng(k * 1000 + w * 77 + min_p)
    reads = _random_reads(rng, 24, 700, n_frac=n_frac)
    # a tiny read, an all-N read and poly-T (k = 16: the key equals the
    # uint32 sentinel and must stay a seed)
    reads += [np.zeros(3, np.uint8), np.full(80, 4, np.uint8),
              np.full(90, 3, np.uint8)]
    mine, jax = _both(reads, k, w, hpc, min_p, max_p, 1024)
    served = _check(reads, mine, jax, k, w, hpc, min_p, max_p)
    assert served >= (1 if w > 1 and n_frac else 20)


@pytest.mark.parametrize("k,w,hpc,min_p,max_p", PACKED_CASES)
def test_collect_hits_packed_matches_jax(k, w, hpc, min_p, max_p):
    rng = np.random.default_rng(k * 991 + w)
    reads = _packed_reads(rng, 20, 600, n_frac=0.0)
    reads += [np.zeros(3, np.uint8), np.full(90, 3, np.uint8)]
    batch, lens = SD.pad_batch(reads, 1024)
    ph, n, fb = (t.numpy() for t in SD.collect_hits_packed(
        torch.from_numpy(batch), torch.from_numpy(lens), k=k, use_hpc=hpc,
        min_p=min_p, max_p=max_p, w=w))
    jph, jn, jfb = (np.asarray(t) for t in SJ.collect_hits_packed(
        jnp.asarray(batch), jnp.asarray(lens), k=k, use_hpc=hpc,
        min_p=min_p, max_p=max_p, w=w))
    np.testing.assert_array_equal(fb, jfb)
    pb = SD.pos_bits(1024)
    for i, r in enumerate(reads):
        if fb[i]:
            continue
        assert n[i] == jn[i]
        np.testing.assert_array_equal(ph[i].view(np.uint32), jph[i])
        row = ph[i, :n[i]].view(np.uint32).astype(np.int64)
        we, wp = collect_tandem_repeat_hits(r, k, w, hpc, min_p, max_p)
        np.testing.assert_array_equal(row >> pb, we)
        np.testing.assert_array_equal(row & ((1 << pb) - 1), wp)


def test_hpc_span_fallback_rules_match_jax():
    """The w > 1 HPC rules: a first k-mer spanning >= 255 bases (its
    conservative position[2k - 2] + 1 bound), a long run inside the read,
    too few seeds with a long span, and reads that stay served."""
    rng = np.random.default_rng(5)

    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    def run(c, n):
        return np.full(n, c, np.uint8)

    reads = [
        np.concatenate([run(0, 300), rand(400)]),        # first span
        np.concatenate([rand(200), run(2, 260), rand(200)]),
        np.concatenate([run(1, 300), rand(5)]),           # < k seeds
        np.concatenate([run(1, 240), rand(12)]),          # < k, last < 255
        np.concatenate([rand(100), run(3, 250), rand(100)]),
        rand(600), rand(64),
        np.concatenate([rand(20), run(0, 240), rand(300)]),
    ]
    for k, w in ((8, 5), (5, 3), (13, 2)):
        mine, jax = _both(reads, k, w, True, 30, 10000)
        _check(reads, mine, jax, k, w, True, 30, 10000)
        assert mine[3].any() and not mine[3].all()


def test_min_p_near_zero_matches_jax():
    """min_p = 0, 1, 2, 5: the search target pos - min_p must not find
    the query's own word (min_p >= 1) and must at min_p = 0."""
    rng = np.random.default_rng(9)
    reads = _random_reads(rng, 16, 400, n_frac=0.0)
    reads.append(np.tile(np.array([0, 1], np.uint8), 60))
    for min_p in (0, 1, 2, 5):
        mine, jax = _both(reads, 5, 1, False, min_p, 60)
        _check(reads, mine, jax, 5, 1, False, min_p, 60)


def test_pos_bits_and_packed_ok_match_jax():
    for L in (1, 2, 3, 1000, 1024, 1025, 4400, 6144, 2**15, 2**15 + 1):
        assert SD.pos_bits(L) == SJ.pos_bits(L)
        for k in (1, 5, 8, 9, 13, 16):
            assert SD.packed_ok(k, L) == SJ.packed_ok(k, L)


def test_collect_hits_batch_host_matches_jax():
    reads = _random_reads(np.random.default_rng(3), 12, 500, n_frac=0.01)
    for k, w, hpc in ((8, 1, False), (8, 5, True)):
        got = SD.collect_hits_batch_host(reads, k=k, w=w, use_hpc=hpc,
                                         min_p=30, max_p=10000, device="cpu")
        want = SJ.collect_hits_batch_host(reads, k=k, w=w, use_hpc=hpc,
                                          min_p=30, max_p=10000)
        for (ge, gp), (we, wp) in zip(got, want):
            np.testing.assert_array_equal(ge, we)
            np.testing.assert_array_equal(gp, wp)


def test_seeders_refuse_bad_inputs():
    b = torch.zeros((2, 10), dtype=torch.uint8)
    lens = torch.tensor([10, 5], dtype=torch.int32)
    with pytest.raises(ValueError):
        SD.collect_hits_batch(b, lens, k=17, use_hpc=False, min_p=1,
                              max_p=9)
    with pytest.raises(TypeError):
        SD.collect_hits_batch(b.int(), lens, k=8, use_hpc=False, min_p=1,
                              max_p=9)
    with pytest.raises(ValueError):
        SD.collect_hits_packed(torch.zeros((1, 2**20), dtype=torch.uint8),
                               lens[:1], k=8, use_hpc=False, min_p=1,
                               max_p=9)
