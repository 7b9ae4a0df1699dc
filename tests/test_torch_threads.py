"""-t: the port's prepare_chunk seeds and chains a chunk's reads on a
pool of min(-t, cores) threads (the JAX engine's read-parallel pool),
reused across chunks and shut down by Engine.close.  The CLI with -t 1
and -t 4 writes identical records, with host seeding and with
TH_DEVICE_SEED=1; prepare_chunk's chains are the serial run's.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_device_seed_engine import ENV, SHAPES, fuzz_reads

from tidehunter_tpu_torch import cli as tcli
from tidehunter_tpu_torch.engine import Engine
from tidehunter_tpu_torch.evals.synth import synth_read
from tidehunter_tpu_torch.io.fastx import FastxRecord
from tidehunter_tpu_torch.params import Params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(5)
    out = [FastxRecord(name=f"r{i}", comment="",
                       seq=synth_read(rng, *SHAPES[i % len(SHAPES)], 40))
           for i in range(20)]
    return out + fuzz_reads(np.random.default_rng(2024), 4)


def _chain_cells(read_chains):
    return [None if dp is None else [list(map(int, ch.cells)) for ch in chs]
            for dp, chs in read_chains]


@pytest.mark.parametrize("device_seed", [False, True],
                         ids=["host_seed", "device_seed"])
def test_threads_write_identical_records(reads, tmp_path, monkeypatch,
                                         device_seed):
    """-t 1 (serial) and -t 4 (the prepare pool) write the same records;
    the pool is reused across chunks and closed with the engine."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    if device_seed:
        monkeypatch.setenv("TH_DEVICE_SEED", "1")
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">{r.name}\n{r.seq}\n" for r in reads))
    outs = []
    for t in ("1", "4"):
        out = tmp_path / f"t{t}.out"
        assert tcli.main(["-t", t, "-f", "2", "--device", "cpu", "-o",
                          str(out), str(fa)]) == 0
        outs.append(out.read_text())
    assert outs[0] == outs[1] and outs[0].count("\n") >= 10

    mtp = Params()
    mtp.n_thread = 4
    mtp.chunk_read_n = 8
    engine = Engine(mtp, device="cpu")
    chunks = [reads[i:i + 8] for i in range(0, 24, 8)]
    preps = [engine.prepare_chunk(c, mtp)[2] for c in chunks]
    pool = engine._pool
    assert (pool is not None) == ((os.cpu_count() or 1) > 1)
    engine.prepare_chunk(chunks[0], mtp)
    assert engine._pool is pool
    engine.close()
    assert engine._pool is None
    mtp.n_thread = 1
    serial = Engine(mtp, device="cpu")
    for c, got in zip(chunks, preps):
        want = serial.prepare_chunk(c, mtp)[2]
        assert _chain_cells(got) == _chain_cells(want)
    assert serial._pool is None
