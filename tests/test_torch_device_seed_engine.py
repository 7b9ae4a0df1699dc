"""Device seeding and chaining through the port's engine on the CPU.

Engine(device="cpu") with TH_DEVICE_SEED=1 alone (device seeds, the host
chains), with TH_DEVICE_CHAIN=1 (the packed-word route chains on the
device) and with TH_OFFLOAD_V1=1 TH_DEVICE_CHAIN=1 (the unpacked route and
its window-bucket chain DP) writes records byte-identical with the JAX
engine on the CPU under the same environment and with the port's host
oracle, tidehunter_core.  The reads: 48 evals/synth.synth_read reads of
60-170 bp units, 12 reads of chip_smoke.fuzz_reads' generator and two
reads holding an N (rerouted to the host seeder on the packed route,
counted as offload_seed_fb).  (-t's pool: test_torch_threads.py.)
"""

import io

import numpy as np
import pytest
import torch

from tidehunter_tpu.engine import Engine as JaxEngine
from tidehunter_tpu.params import Params as JaxParams
from tidehunter_tpu_torch.engine import Engine
from tidehunter_tpu_torch.evals.synth import synth_read
from tidehunter_tpu_torch.io.codec import encode
from tidehunter_tpu_torch.io.fastx import FastxRecord
from tidehunter_tpu_torch.io.output import write_read_output
from tidehunter_tpu_torch.ops.chaining_native import tandem_chain_native
from tidehunter_tpu_torch.ops.seeding import collect_tandem_repeat_hits
from tidehunter_tpu_torch.params import Params
from tidehunter_tpu_torch.pipeline.core import tidehunter_core
from tidehunter_tpu_torch.utils.metrics import METRICS

torch.set_num_threads(1)

# (unit length, copies, error rate) of the synth_read reads
SHAPES = [(90, 5, 0.05), (150, 4, 0.08), (80, 6, 0.1), (160, 5, 0.05),
          (100, 4, 0.03), (140, 6, 0.1), (60, 5, 0.05), (170, 4, 0.05)]
SETTINGS = {"seed": {"TH_DEVICE_SEED": "1"},
            "seed_chain": {"TH_DEVICE_SEED": "1", "TH_DEVICE_CHAIN": "1"},
            "v1_chain": {"TH_DEVICE_SEED": "1", "TH_DEVICE_CHAIN": "1",
                         "TH_OFFLOAD_V1": "1"}}
ENV = ("TH_DEVICE_SEED", "TH_DEVICE_CHAIN", "TH_OFFLOAD_V1")


def fuzz_reads(rng, n):
    """chip_smoke.fuzz_reads' generator (chip_smoke.py blocks the JAX
    package from import, so it is not imported here)."""
    out = []
    for i in range(n):
        L = int(rng.integers(30, 600))
        copies = int(rng.integers(2, 9))
        err = float(rng.choice([0.0, 0.05, 0.15]))
        out.append(FastxRecord(name=f"fuzz_{i}", comment="",
                               seq=synth_read(rng, L, copies, err,
                                              int(rng.integers(0, 200)))))
    return out


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(3)
    out = [FastxRecord(name=f"r{i}", comment="",
                       seq=synth_read(rng, *SHAPES[i % len(SHAPES)], 40))
           for i in range(48)]
    out += fuzz_reads(np.random.default_rng(2024), 12)
    for i in (1, 6):                  # an N in a tandem read
        s = out[i].seq
        out.append(FastxRecord(name=f"n{i}", comment="",
                               seq=s[:len(s) // 2] + "N" + s[len(s) // 2 + 1:]))
    return out


def _serialize(reads, results, mtp):
    buf = io.StringIO()
    for rec, res in zip(reads, results):
        write_read_output(buf, rec.name, rec.seq, res, mtp)
    return buf.getvalue()


def _chain_key(chains):
    return [(list(map(int, c.cells)), c.est_period, c.est_start, c.est_ch_i)
            for c in chains]


@pytest.fixture(scope="module")
def oracle(reads):
    mtp = Params()
    return _serialize(reads, [tidehunter_core(r.seq, mtp) for r in reads],
                      mtp)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_engine_device_seed_matches_jax_and_oracle(reads, oracle, setting,
                                                   monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in SETTINGS[setting].items():
        monkeypatch.setenv(name, value)
    mtp = Params()
    engine = Engine(mtp, device="cpu")
    METRICS.reset()
    try:
        mine = _serialize(reads, engine(reads, mtp), mtp)
    finally:
        engine.close()
    snap = METRICS.snapshot()
    jmtp = JaxParams()
    jax = _serialize(reads, JaxEngine(jmtp, platform="cpu")(reads, jmtp),
                     mtp)
    assert mine.count(">") >= 50
    assert mine == jax
    assert mine == oracle
    assert snap["time_device_seed_s"] >= 0
    # the packed route reroutes the two N reads; v1 seeds them itself
    assert snap.get("offload_seed_fb", 0) == (0 if setting == "v1_chain"
                                              else 2)


@pytest.mark.parametrize("w", [1, 5])
def test_v1_route_counts_its_host_reroutes(w, monkeypatch):
    """TH_OFFLOAD_V1=1 TH_DEVICE_CHAIN=1: a read of more than 8192 hits
    keeps all its device hits and is chained on the host (counted as
    offload_chain_fb), a w > 1 read holding an N is seeded on the host
    (offload_seed_fb), and every row's hits and chains equal the host
    seeder's and the native chainer's."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in SETTINGS["v1_chain"].items():
        monkeypatch.setenv(name, value)
    rng = np.random.default_rng(11)
    seqs = [synth_read(rng, *SHAPES[i], 40) for i in range(4)]
    seqs.append(synth_read(rng, 150, 80, 0.05, 40))     # > 8192 hits
    seqs.append(seqs[1][:200] + "N" + seqs[1][201:])
    chunk = [FastxRecord(name=f"v{i}", comment="", seq=s)
             for i, s in enumerate(seqs)]
    mtp = Params()
    mtp.w = w
    engine = Engine(mtp, device="cpu")
    METRICS.reset()
    try:
        hits, chains = engine._device_seed(chunk, mtp)
    finally:
        engine.close()
    snap = METRICS.snapshot()
    for i, s in enumerate(seqs):
        b = encode(s)
        we, wp = collect_tandem_repeat_hits(b, mtp.k, w, mtp.hpc, mtp.min_p,
                                            mtp.max_p)
        np.testing.assert_array_equal(hits[i][0], we, f"read {i}")
        np.testing.assert_array_equal(hits[i][1], wp, f"read {i}")
        if chains[i] is not None:
            want = tandem_chain_native(we, wp, mtp.k)[1]
            assert _chain_key(chains[i][1]) == _chain_key(want), f"read {i}"
    assert snap["time_device_chain_s"] >= 0
    if w == 1:
        assert len(hits[4][0]) > 8192 and chains[4] is None
        assert snap.get("offload_chain_fb", 0) == 1
        assert snap.get("offload_seed_fb", 0) == 0
    else:
        assert chains[5] is None
        assert snap.get("offload_seed_fb", 0) >= 1

