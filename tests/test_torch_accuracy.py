"""The port's accuracy eval (tidehunter_tpu_torch/evals/accuracy.py) on the
CPU, against the JAX package's (evals/accuracy.py).

* ``config_reads`` (``make_read``/``mutate`` under the eval's seed) gives
  the JAX eval's reads and units for every config (first 4 reads).
* ``consensus_identity`` equals the JAX eval's on random pairs and on the
  edge cases of tests/test_accuracy_scorer.py (rotations, planted errors,
  an empty consensus).
* ``evaluate`` on ``--device cpu`` prints the JAX eval's ``--device off``
  table (every column but reads/s) for 2 reads of (0.15, 100, 10) and
  (0.15, 500, 10).
* The committed oracle digests (accuracy_digests.json) cover the 14
  configs x 8 reads; reads 0-1 of (0.15, 100, 10), re-derived from the
  port's oracle and from ``Engine(device="cpu")``, equal them, and a
  changed record fails ``check_digests``.
* ``--device cuda`` without a card fails.
Tolerance: exact (reads, identities, table text, digests).
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from tidehunter_tpu_torch.engine import Engine
from tidehunter_tpu_torch.evals import accuracy as A
from tidehunter_tpu_torch.io.codec import decode
from tidehunter_tpu_torch.io.output import TandemResult
from tidehunter_tpu_torch.params import Params
from tidehunter_tpu_torch.pipeline.core import tidehunter_core

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from evals import accuracy as J  # noqa: E402

torch.set_num_threads(1)

TABLE_CONFIGS = [(0.15, 100, 10), (0.15, 500, 10)]


@pytest.fixture(autouse=True)
def no_graph_msa(monkeypatch):
    monkeypatch.delenv("TH_MSA", raising=False)


@pytest.mark.parametrize("cfg", A.CONFIGS, ids=A.config_key)
def test_config_reads_match_jax_eval(cfg):
    reads, units = A.config_reads(cfg, 4)
    err, unit_len, copies = cfg[:3]
    tag = cfg[3] if len(cfg) > 3 else ""
    rng = np.random.default_rng(
        hash((err, unit_len, copies) + ((ord(tag),) if tag else ()))
        % 2**31)
    for i, (rec, unit) in enumerate(zip(reads, units)):
        seq, want_unit = J.make_read(rng, err, unit_len, copies)
        assert (rec.name, rec.seq, unit) == (f"r{i}", seq, want_unit)
    assert A.CONFIGS == J.CONFIGS


def test_mutate_matches_jax_eval():
    for seed in range(10):
        unit = np.random.default_rng(seed).integers(0, 4, 300).astype(
            np.uint8)
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for err in (0.0, 0.13, 0.2, 0.5):
            np.testing.assert_array_equal(A.mutate(a, unit, err),
                                          J.mutate(b, unit, err))


def test_consensus_identity_matches_jax_on_random_pairs():
    rng = np.random.default_rng(5)
    for _ in range(60):
        unit = rng.integers(0, 4, int(rng.integers(20, 300))).astype(
            np.uint8)
        rot = int(rng.integers(0, len(unit)))
        cons = decode(A.mutate(rng, np.roll(unit, rot),
                               float(rng.uniform(0, 0.3))))
        assert A.consensus_identity(cons, decode(unit)) == \
            J.consensus_identity(cons, decode(unit))


EDGES = {
    "empty": ("", "ACGTACGTAC"),
    "rotation": ("GTACGTACAC", "ACGTACGTAC"),
    "one base": ("A", "CGTACGTACG"),
    "longer than the unit": ("ACGTACGTACGTACGTACGTAC", "ACGTAC"),
    "planted substitutions": ("ACGTTCGTACCTACGTAAGT", "ACGTACGTACGTACGTACGT"),
    "no shared base": ("AAAAAAAA", "CCCCCCCC"),
}


@pytest.mark.parametrize("edge", list(EDGES))
def test_consensus_identity_edge_cases(edge):
    cons, unit = EDGES[edge]
    got = A.consensus_identity(cons, unit)
    assert got == J.consensus_identity(cons, unit)
    assert 0.0 <= got <= 1.0
    if edge == "rotation":
        assert got == 1.0


def _table(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return [line.rsplit(None, 1)[0] for line in buf.getvalue().splitlines()]


def test_evaluate_cpu_prints_the_jax_off_table():
    got = _table(lambda: A.evaluate(2, "cpu", TABLE_CONFIGS))
    want = _table(lambda: J.evaluate(2, "off", TABLE_CONFIGS))
    assert got == want
    assert len(got) == 1 + len(TABLE_CONFIGS)


def test_committed_digests_cover_the_protocol():
    dig = A.load_digests()
    assert dig["reads"] == A.DIGEST_READS == 8
    assert list(dig["digests"]) == [A.config_key(c) for c in A.CONFIGS]
    assert all(len(v) == 8 and all(len(d) == 64 for d in v)
               for v in dig["digests"].values())


@pytest.mark.parametrize("route", ["oracle", "engine"])
def test_digests_rederived(route):
    cfg = (0.15, 100, 10)
    reads, _ = A.config_reads(cfg, 2)
    mtp = Params()
    if route == "oracle":
        results = [tidehunter_core(r.seq, mtp) for r in reads]
    else:
        eng = Engine(mtp, device="cpu")
        results = eng.process_chunk(reads, mtp)
        eng.close()
    assert all(res.records for res in results)
    want = A.load_digests()["digests"][A.config_key(cfg)][:2]
    assert [A.record_digest(r, res, mtp)
            for r, res in zip(reads, results)] == want
    assert A.check_digests(cfg, reads, results, mtp, A.load_digests()) == 2


def test_check_digests_fails_on_a_changed_record():
    cfg = (0.15, 100, 10)
    reads, _ = A.config_reads(cfg, 1)
    mtp = Params()
    res = tidehunter_core(reads[0].seq, mtp)
    res.records[0].seq = res.records[0].seq[:-1]
    with pytest.raises(AssertionError, match="differ from the oracle"):
        A.check_digests(cfg, reads, [res], mtp, A.load_digests())
    with pytest.raises(AssertionError, match="differ from the oracle"):
        A.check_digests(cfg, reads, [TandemResult()], mtp, A.load_digests())


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA card")
def test_cuda_without_a_card_fails():
    with pytest.raises(RuntimeError, match="CUDA"):
        A.main(["--device", "cuda", "--reads", "1", "--configs",
                "0.15:100:10"])
