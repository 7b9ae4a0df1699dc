"""The fuzz corpus on the port (tidehunter_tpu_torch/evals/fuzz.py) on the
CPU.

* The port's generators draw what their originals draw, read for read and
  ``Params`` for ``Params``, on 20 seeds each: ``random_read`` and
  ``adapter_read`` against ``tests/test_fuzz.py``'s, ``soak_read`` and
  ``soak_draw`` against ``evals/soak.py``'s (its draw is read out of the
  soak's own loop, with its engine and oracle replaced by recorders).
* The 9 cases of ``test_fuzz.py`` (5 of random reads over formats and
  filters, 4 of adapter and control reads over -F, -s and only_longest)
  through the port's ``Engine(device="cpu")``: a fresh engine, a fresh
  engine under ``TH_HOST_ALN_CAP=0`` (every oversize window on the
  wavefront) and one on a 3-shard CPU mesh, each byte-identical with the
  port's host oracle, ``tidehunter_core``.
* One engine whose ``TH_DEVICE_SEED``/``TH_DEVICE_CHAIN`` flip between
  two ``process_chunk`` calls (6 reads of the first case) takes the other
  route on the second call, by the calls of the offload's seed and chain
  steps: the soak caches its engines by (w, hpc, polish) only, which is
  right because the engine reads the switches at each chunk.
* The soak's loop on the CPU holds 3 seeds to the oracle, counts a
  divergence against a wrong expectation, and restores the switches;
  ``--device cuda`` without a card fails.
Tolerance: exact (reads, Params and records).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from test_fuzz import _adapter_read, _random_read

from tidehunter_tpu.io.codec import decode as jax_decode
from tidehunter_tpu.io.output import TandemResult as JaxTandemResult
from tidehunter_tpu_torch.engine import Engine
from tidehunter_tpu_torch.evals import fuzz
from tidehunter_tpu_torch.ops import offload
from tidehunter_tpu_torch.parallel import mesh as PM
from tidehunter_tpu_torch.pipeline.core import tidehunter_core
from tidehunter_tpu_torch.utils.metrics import METRICS

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

torch.set_num_threads(1)

SEEDS = range(20)
ENV = ("TH_DEVICE_SEED", "TH_DEVICE_CHAIN", "TH_OFFLOAD_V1", "TH_HOST_WALK",
       "TH_HOST_ALN_CAP", "TH_MESH", "TH_MSA")
CASES = ([("fuzz",) + c for c in fuzz.FUZZ_CASES]
         + [("adapters",) + c for c in fuzz.ADAPTER_CASES])
ENGINES = {"fresh": {}, "host_aln_cap_0": {"TH_HOST_ALN_CAP": "0"},
           "mesh_3": {}}


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


# --- the generators against their originals ------------------------------

def _params_equal(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_random_read_matches_test_fuzz():
    for seed in SEEDS:
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(6):
            assert fuzz.random_read(a) == _random_read(b)
        assert a.random() == b.random()      # the same draws, in order


def test_adapter_read_matches_test_fuzz():
    for seed in SEEDS:
        adapters = np.random.default_rng(100 + seed)
        five = jax_decode(adapters.integers(0, 4, 24).astype(np.uint8))
        three_rc = jax_decode(adapters.integers(0, 4, 22).astype(np.uint8))
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for tandem in (True, False, True):
            assert (fuzz.adapter_read(a, five, three_rc, tandem)
                    == _adapter_read(b, five, three_rc, tandem))
        assert a.random() == b.random()


def test_soak_read_matches_soak():
    from evals import soak

    for seed in SEEDS:
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(6):
            assert fuzz.soak_read(a) == soak._random_read(b)
        assert a.random() == b.random()


def test_soak_draw_matches_soak(tmp_path, monkeypatch):
    """The soak's own loop over seeds 1000-1019: its Engine and oracle are
    replaced by recorders of (Params, switches, reads), and the first
    recorder stops the loop through --stop-file after the 20th seed."""
    from evals import soak

    stop = tmp_path / "stop"
    stop.write_text("")
    drawn = []

    class Recorder:
        def __init__(self, mtp, platform):
            assert platform == "cpu"

        def process_chunk(self, reads, mtp):
            drawn.append((dataclasses.replace(mtp),
                          os.environ["TH_DEVICE_SEED"] == "1",
                          os.environ["TH_DEVICE_CHAIN"] == "1",
                          [(r.name, r.seq) for r in reads]))
            if len(drawn) == len(SEEDS):
                stop.write_text("UP ")
            return [JaxTandemResult() for _ in reads]

    monkeypatch.setattr(soak, "Engine", Recorder)
    monkeypatch.setattr(soak, "tidehunter_core",
                        lambda seq, mtp: JaxTandemResult())
    assert soak.main(["--start-seed", "1000", "--reads", "5",
                      "--stop-file", str(stop)]) == 0
    assert len(drawn) == len(SEEDS)
    for i, (mtp, dev_seed, dev_chain, reads) in enumerate(drawn):
        got = fuzz.soak_draw(1000 + i, n_reads=5)
        _params_equal(got[0], mtp)
        assert got[1:3] == (dev_seed, dev_chain)
        assert [(r.name, r.seq) for r in got[3]] == reads


def test_cases_are_test_fuzz_cases(tmp_path):
    """The case tuples are test_fuzz.py's parametrisations, and a case's
    reads are the ones test_fuzz.py builds from its seed."""
    import test_fuzz

    marks = {f.__name__: [m.args for m in f.pytestmark
                          if m.name == "parametrize"][0][1]
             for f in (test_fuzz.test_engine_matches_oracle_fuzz,
                       test_fuzz.test_engine_matches_oracle_adapter_fuzz)}
    assert fuzz.FUZZ_CASES == marks["test_engine_matches_oracle_fuzz"]
    assert (fuzz.ADAPTER_CASES
            == marks["test_engine_matches_oracle_adapter_fuzz"])
    _, reads = fuzz.fuzz_case(3, 1, {"min_copy": 3})
    rng = np.random.default_rng(3)
    assert [r.seq for r in reads] == [_random_read(rng) for _ in range(12)]


# --- the 9 cases through the port's engine -------------------------------

_ORACLE = {}


def _oracle(seed, mtp, reads):
    """The port's host oracle's records of a case, computed once."""
    if seed not in _ORACLE:
        _ORACLE[seed] = fuzz.serialize(
            reads, [tidehunter_core(r.seq, mtp) for r in reads], mtp)
    return _ORACLE[seed]


def _case(kind, seed, fmt, extra, tmp_path):
    if kind == "fuzz":
        return fuzz.fuzz_case(seed, fmt, extra)
    return fuzz.adapter_case(seed, fmt, extra, str(tmp_path))


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("kind,seed,fmt,extra", CASES,
                         ids=[f"{c[0]}{c[1]}" for c in CASES])
def test_case_matches_oracle(kind, seed, fmt, extra, engine, tmp_path,
                             monkeypatch):
    mtp, reads = _case(kind, seed, fmt, extra, tmp_path)
    want = _oracle(seed, mtp, reads)
    for k, v in ENGINES[engine].items():
        monkeypatch.setenv(k, v)
    mesh = PM.make_mesh(3, "cpu") if engine == "mesh_3" else None
    METRICS.reset()
    eng = Engine(mtp, device="cpu", mesh=mesh)
    got = fuzz.serialize(reads, eng.process_chunk(reads, mtp), mtp)
    eng.close()
    assert got == want
    if kind == "adapters" and not extra.get("only_full_length"):
        assert got      # the tandem+adapter reads must yield records
    snap = METRICS.snapshot()
    if engine == "host_aln_cap_0":
        assert not snap.get("host_aln")          # every window on K1
        assert snap.get("time_dev_global_s") is not None
    if engine == "mesh_3":
        assert snap.get("time_device_seed_s") is not None
        assert not snap.get("walk_native")


# --- the switches are read at each chunk ---------------------------------

SWITCHES = {"off": {}, "seed": {"TH_DEVICE_SEED": "1"},
            "seed_chain": {"TH_DEVICE_SEED": "1", "TH_DEVICE_CHAIN": "1"}}


@pytest.mark.parametrize("first,second", [("off", "seed_chain"),
                                          ("seed_chain", "off"),
                                          ("seed", "seed_chain"),
                                          ("seed_chain", "seed")])
def test_engine_reads_the_switches_at_each_chunk(first, second, monkeypatch):
    mtp, reads = fuzz.fuzz_case(1, 2, {}, n_reads=6)
    want = fuzz.serialize(reads, [tidehunter_core(r.seq, mtp)
                                  for r in reads], mtp)
    calls = {"seed": 0, "chain": 0}
    seed_fn, chain_fn = offload.collect_hits_packed, offload.chain_dp_batch

    def seed(*a, **kw):
        calls["seed"] += 1
        return seed_fn(*a, **kw)

    def chain(*a, **kw):
        calls["chain"] += 1
        return chain_fn(*a, **kw)

    monkeypatch.setattr(offload, "collect_hits_packed", seed)
    monkeypatch.setattr(offload, "chain_dp_batch", chain)
    eng = Engine(mtp, device="cpu")
    for setting in (first, second):
        for k in ENV:
            monkeypatch.delenv(k, raising=False)
        for k, v in SWITCHES[setting].items():
            monkeypatch.setenv(k, v)
        METRICS.reset()
        before = dict(calls)
        got = fuzz.serialize(reads, eng.process_chunk(reads, mtp), mtp)
        assert got == want
        ran = {k: calls[k] - before[k] for k in calls}
        assert ran == {"seed": int(setting != "off"),
                       "chain": int(setting == "seed_chain")}, setting
        assert (("time_device_seed_s" in METRICS.snapshot())
                == (setting != "off"))
    eng.close()


# --- the soak's loop ------------------------------------------------------

def test_soak_holds_records_to_the_oracle():
    from tidehunter_tpu_torch.evals import soak

    res = soak.soak(range(1000, 1003), 6, "cpu")
    assert (res.runs, res.divergences, res.crashes) == (3, [], [])
    assert sum(v for k, v in res.drawn.items() if k.startswith("-f ")) == 3
    assert "TH_DEVICE_SEED" not in os.environ      # restored
    wrong = soak.soak([1000], 6, "cpu", want={1000: "not the records"})
    assert wrong.divergences == [1000] and wrong.failures == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA card")
def test_soak_cuda_without_a_card_fails():
    from tidehunter_tpu_torch.evals import soak

    with pytest.raises(RuntimeError, match="CUDA"):
        soak.main(["--device", "cuda", "--minutes", "0.01"])
