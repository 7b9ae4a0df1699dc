"""The port's Myers adapter search (tidehunter_tpu_torch/ops/myers_device.py)
against the JAX package's myers_jax.hw_batch and the port's host oracle
ops/myers.align_hw, on the CPU: (ed, start, end) exact, including the
leftmost-end / last-equal-start ties, queries across the 32- and 64-bit
word boundaries, k caps, lower case and the problems the 2-bit+N code
cannot represent (resolved by align_hw and counted as hws_host).  The
cases are those of tests/test_myers_jax.py.
"""

import numpy as np
import pytest
import torch

from tidehunter_tpu.ops.myers_jax import hw_batch as jax_hw_batch
from tidehunter_tpu_torch.ops import myers_device as MY
from tidehunter_tpu_torch.ops.myers import align_hw
from tidehunter_tpu_torch.utils.metrics import METRICS

torch.set_num_threads(1)

BASES = "ACGT"
QLENS = [5, 25, 31, 32, 33, 63, 64, 65, 84, 128]
# the reference's shipped adapters (84 bp 5', 25 bp 3')
FIVE = ("AATGATACGGCGACCACCGAGATCTACACTCGACTAGTCGTCGGCAGCGTCAGAT"
        "GTGTATAAGAGACAGTGAATTCTGGTGGG")
THREE = "AAGCAGTGGTATCAACGCAGAGTAC"


def _rand_seq(rng, n):
    return "".join(BASES[c] for c in rng.integers(0, 4, n))


def _mutseq(rng, s, rate):
    out = []
    for c in s:
        r = rng.random()
        if r < rate / 3:
            continue
        elif r < 2 * rate / 3:
            out.append(BASES[rng.integers(0, 4)])
            out.append(c)
        elif r < rate:
            out.append(BASES[rng.integers(0, 4)])
        else:
            out.append(c)
    return "".join(out)


def qlen_cases(qlen):
    """12 problems of test_myers_jax.test_device_matches_oracle: every
    third target holds a noisy copy of the query; k = -1, qlen/2, 2."""
    rng = np.random.default_rng(qlen)
    queries, targets, ks = [], [], []
    for t in range(12):
        q = _rand_seq(rng, qlen)
        tlen = int(rng.integers(qlen, 400))
        tgt = _rand_seq(rng, tlen)
        if t % 3 == 0:
            at = int(rng.integers(0, max(1, tlen - qlen)))
            tgt = tgt[:at] + _mutseq(rng, q, 0.1) + tgt[at:]
        queries.append(q)
        targets.append(tgt)
        ks.append([-1, qlen // 2, 2][t % 3])
    return queries, targets, ks


def adapter_cases():
    rng = np.random.default_rng(0)
    cons = _rand_seq(rng, 300)
    t = cons[50:] + FIVE + cons + THREE + cons[:50]
    tt = t + t
    qs, ts, ks = [], [], []
    for q in (FIVE, THREE):
        for k in (-1, int(len(q) * 0.2)):
            qs.append(q)
            ts.append(tt)
            ks.append(k)
    return qs, ts, ks


def tie_cases():
    """Repeats give several equal ends and starts: the leftmost end and
    the last equal SHW position must win."""
    qs = ["ACGT" * 8, "ACGT" * 16, "AC" * 40 + "G", "A" * 65, "T" * 128]
    ts = ["ACGT" * 30, "GG" + "ACGT" * 40, "AC" * 100, "A" * 200,
          "T" * 300]
    return qs, ts, [-1, 3, -1, 0, -1]


CASES = {f"qlen{q}": (lambda q=q: qlen_cases(q)) for q in QLENS}
CASES["adapters"] = adapter_cases
CASES["ties"] = tie_cases


@pytest.mark.parametrize("case", list(CASES))
def test_hw_batch_matches_jax_and_oracle(case):
    queries, targets, ks = CASES[case]()
    got = MY.hw_batch(queries, targets, ks, device="cpu")
    assert got == jax_hw_batch(queries, targets, ks)
    assert got == [align_hw(q, t, k) for q, t, k in zip(queries, targets,
                                                      ks)]


def _tensors(queries, targets, ks):
    parts, meta, size = [], [], 0
    for q, t, k in zip(queries, targets, ks):
        qe, te = MY.encode5(q), MY.encode5(t)
        meta.append((size, len(q), size + len(q), len(t), k))
        parts += [qe, te]
        size += len(q) + len(t)
    return (torch.as_tensor(np.concatenate(parts)),
            torch.as_tensor(np.array(meta, np.int32).T.copy()))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_oracle(case):
    """hw_batch_plain on its tensors (one target per problem, no sharing)
    and myers_hw on CPU tensors give align_hw's triples."""
    queries, targets, ks = CASES[case]()
    seq, meta = _tensors(queries, targets, ks)
    plain = MY.hw_batch_plain(seq, meta)
    assert torch.equal(MY.myers_hw(seq, meta, max(map(len, queries))), plain)
    for r, (q, t, k) in enumerate(zip(queries, targets, ks)):
        ed, st, en = align_hw(q, t, k)
        want = (ed, -1 if st is None else st, -1 if en is None else en)
        assert tuple(plain[:, r].tolist()) == want, (len(q), len(t), k)


def test_fallbacks_counted_as_hws_host():
    """Lower case goes to the device path; an ambiguity code, an empty
    query or target and a query over 128 bp take align_hw, each counted
    once as hws_host."""
    queries = ["acgT", "ACRT", "", "ACGT", "A" * 129, "ACGT"]
    targets = ["ggACGTgg", "AACRTA", "ACGT", "", "A" * 300, "ACGYACGT"]
    ks = [-1, -1, -1, -1, 5, -1]
    before = METRICS.snapshot().get("hws_host", 0)
    got = MY.hw_batch(queries, targets, ks, device="cpu")
    assert METRICS.snapshot().get("hws_host", 0) - before == 5
    assert got == [align_hw(q, t, k) for q, t, k in zip(queries, targets,
                                                      ks)]
    assert got[:3] == jax_hw_batch(queries[:3], targets[:3], ks[:3])


def test_case_insensitive():
    assert MY.hw_batch(["AcGt"], ["ttACGTtt"], [-1], device="cpu") == \
        [align_hw("AcGt", "ttACGTtt", -1)]


def test_shared_targets_are_uploaded_once():
    """Four searches of one doubled consensus share its codes: the bytes
    handed to the kernel hold each distinct string once, and hw_batch
    launches with them and the longest query."""
    seen = {}
    orig = MY.myers_hw

    def spy(seq, meta, qmax):
        seen.update(n=seq.shape[0], qmax=qmax)
        return orig(seq, meta, qmax)

    qs, ts, ks = adapter_cases()
    seq, meta, rows = MY.pack(qs, ts, ks)
    assert len(seq) == len(FIVE) + len(THREE) + len(ts[0])
    assert rows == list(range(len(qs)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MY, "myers_hw", spy)
        got = MY.hw_batch(qs, ts, ks, device="cpu")
    assert seen == {"n": len(seq), "qmax": len(FIVE)}
    assert got == [align_hw(q, t, k) for q, t, k in zip(qs, ts, ks)]


def test_pack_leaves_unrepresentable_to_the_host():
    """pack's rows skip what align_hw resolves; its meta addresses the
    codes of the rest."""
    qs = ["ACGT", "ACRT", "", "acgt", "A" * 129]
    ts = ["TTACGT", "ACGT", "ACGT", "TTACGT", "ACGT"]
    seq, meta, rows = MY.pack(qs, ts, [1, -1, -1, 2, -1])
    assert rows == [0, 3]
    # "acgt" is a string of its own: stored again, in the same codes
    assert seq.tolist() == [0, 1, 2, 3, 3, 3, 0, 1, 2, 3, 0, 1, 2, 3]
    assert meta.tolist() == [[0, 10], [4, 4], [4, 4], [6, 6], [1, 2]]
    assert MY.pack(["ACRT"], ["ACGT"], [-1])[1].shape == (5, 0)


def test_wrapper_checks_inputs():
    seq, meta = _tensors(["ACGT"], ["AACGTT"], [-1])
    with pytest.raises(TypeError):
        MY.myers_hw(seq.int(), meta, 4)
    with pytest.raises(ValueError):
        MY.myers_hw(seq, meta[:3], 4)
    for qmax in (0, 129):
        with pytest.raises(ValueError):
            MY.myers_hw(seq, meta, qmax)
