"""The port's option paths on the CPU, held to the JAX package and the
host oracles: --polish end to end (the engine against the JAX engine and
tidehunter_core) and for a region past the largest bucket; --msa graph
(the engine's MSA mode "poa", which sends every msa request to the host
oracle) through both CLIs; --metrics against the JAX CLI's run keys; and
--profile's trace.  Records are compared byte for byte.  The device MSA's
polish rounds are in test_torch_msa_polish.py, the reference options in
test_torch_cli_options.py.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import test_torch_msa_device as TMDT
import torch

from tidehunter_tpu import cli as jax_cli
from tidehunter_tpu.engine import Engine as JaxEngine
from tidehunter_tpu.io.output import write_read_output as jax_write
from tidehunter_tpu.ops.poa_profile import banded_profile_consensus
from tidehunter_tpu.params import Params as JaxParams
from tidehunter_tpu.pipeline.core import tidehunter_core
from tidehunter_tpu_torch import cli as tcli
from tidehunter_tpu_torch.engine import Engine
from tidehunter_tpu_torch.evals.synth import synth_read
from tidehunter_tpu_torch.io.fastx import FastxRecord
from tidehunter_tpu_torch.io.output import write_read_output
from tidehunter_tpu_torch.ops.poa_profile import profile_consensus
from tidehunter_tpu_torch.params import Params
from tidehunter_tpu_torch.utils.metrics import METRICS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_KEYS = ("reads", "chunks", "cons_records", "wall_s", "reads_per_s")
# (unit length, copies, error rate): T=128 full width and T=256 banded
SHAPES = [(90, 5, 0.08), (150, 4, 0.1), (70, 6, 0.1), (170, 4, 0.08)]


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(6)
    return [FastxRecord(name=f"p{i}", comment="",
                        seq=synth_read(rng, L, c, e, 40))
            for i, (L, c, e) in enumerate(SHAPES)]


@pytest.fixture(scope="module")
def fasta(reads, tmp_path_factory):
    fn = tmp_path_factory.mktemp("reads") / "reads.fa"
    fn.write_text("".join(f">{r.name}\n{r.seq}\n" for r in reads))
    return str(fn)


def _serialize(reads, results, mtp, write=write_read_output):
    buf = io.StringIO()
    for rec, res in zip(reads, results):
        write(buf, rec.name, rec.seq, res, mtp)
    return buf.getvalue()


@pytest.mark.parametrize("polish,picks", [(1, slice(None)),
                                          (2, slice(1, 2))])
def test_engine_polish_matches_jax_engine_and_oracle(reads, polish, picks):
    """The reads' regions land at T=128 (full width) and T=256 (W=128);
    polish=2 on the second read, at T=256."""
    reads = reads[picks]
    mtp = Params()
    mtp.out_fmt = 2
    mtp.polish = polish
    jmtp = JaxParams()
    jmtp.out_fmt = 2
    jmtp.polish = polish
    port = _serialize(reads, Engine(mtp, device="cpu")(reads, mtp), mtp)
    jax_res = JaxEngine(jmtp, platform="cpu", mesh=None)(reads, jmtp)
    oracle = [tidehunter_core(r.seq, jmtp) for r in reads]
    assert port.count("\n") >= len(reads)
    assert port == _serialize(reads, jax_res, jmtp, jax_write)
    assert port == _serialize(reads, oracle, jmtp, jax_write)


def test_oversize_region_is_polished(monkeypatch):
    """A region past the 4096 bucket (two 3.5 kb units) takes the host
    profile_consensus with the engine's polish passes."""
    from tidehunter_tpu_torch import engine as E

    rng = np.random.default_rng(8)
    base = rng.integers(0, 4, 3500).astype(np.uint8)
    region = [TMDT._mut(rng, base, 0.08) for _ in range(2)]
    mtp = Params()
    mtp.polish = 1
    seen = []

    def spy(*args, **kw):
        seen.append(kw.get("polish", 0))
        return profile_consensus(*args, **kw)

    monkeypatch.setattr(E, "profile_consensus", spy)
    before = METRICS.snapshot().get("msa_host_oversize", 0)
    got = Engine(mtp, device="cpu")._resolve_msa_device([region])[0]
    assert METRICS.snapshot().get("msa_host_oversize", 0) == before + 1
    assert seen == [1]
    want = profile_consensus(region, mtp.match, mtp.mismatch, mtp.gap_open1,
                             mtp.gap_ext1, polish=1, gap_open2=mtp.gap_open2,
                             gap_ext2=mtp.gap_ext2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_engine_poa_mode_routes_msa_to_the_host():
    mtp = Params()
    eng = Engine(mtp, device="cpu", msa_mode="poa")
    rng = np.random.default_rng(2)
    base = rng.integers(0, 4, 80).astype(np.uint8)
    region = [TMDT._mut(rng, base, 0.1) for _ in range(4)]
    before = METRICS.snapshot().get("msa_batches", 0)
    got = eng._resolve_batch([("msa", region)])[0]
    assert METRICS.snapshot().get("msa_batches", 0) == before
    want = banded_profile_consensus(region, mtp.match, mtp.mismatch,
                                    mtp.gap_open1, mtp.gap_ext1,
                                    gap_open2=mtp.gap_open2,
                                    gap_ext2=mtp.gap_ext2)
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(ValueError):
        Engine(mtp, device="cpu", msa_mode="star")


# --------------------------------------------------------- --msa graph --


@pytest.mark.parametrize("device", ["cpu", "off"])
def test_msa_graph_cli_matches_jax_cli(fasta, tmp_path, device):
    mine = tmp_path / "port.tab"
    th_msa = os.environ.get("TH_MSA")
    assert tcli.main(["-f", "2", "--msa", "graph", "--device", device, "-o",
                      str(mine), fasta]) == 0
    assert os.environ.get("TH_MSA") == th_msa     # set for the run only
    ref = tmp_path / "jax.tab"
    subprocess.run([sys.executable, "-m", "tidehunter_tpu.cli", "-f", "2",
                    "--msa", "graph", "--device", "off", "-o", str(ref),
                    fasta], cwd=ROOT, check=True, capture_output=True)
    assert mine.read_text().count("\n") >= len(SHAPES)
    assert mine.read_text() == ref.read_text()


# ------------------------------------------------ --metrics, --profile --


def test_metrics_file_matches_jax_cli(fasta, tmp_path):
    mine, ref = tmp_path / "port.json", tmp_path / "jax.json"
    assert tcli.main(["--device", "cpu", "--metrics", str(mine), "-o",
                      str(tmp_path / "port.fa"), fasta]) == 0
    assert jax_cli.main(["--device", "off", "--metrics", str(ref), "-o",
                         str(tmp_path / "jax.fa"), fasta]) == 0
    got, want = json.loads(mine.read_text()), json.loads(ref.read_text())
    for key in RUN_KEYS:
        assert key in got and key in want, key
    for key in ("reads", "chunks", "cons_records"):
        assert got[key] == want[key], key
    assert got["reads"] == len(SHAPES) and got["cons_records"] > 0
    # the stage timers a benchmark reads
    for key in ("time_seed_chain_s", "time_consensus_s", "time_dev_msa_s"):
        assert got[key] > 0, key


def test_metrics_from_environment(fasta, tmp_path, monkeypatch):
    fn = tmp_path / "env.json"
    monkeypatch.setenv("TH_METRICS", str(fn))
    assert tcli.main(["--device", "off", "-o", str(tmp_path / "x.fa"),
                      fasta]) == 0
    assert json.loads(fn.read_text())["reads"] == len(SHAPES)


def test_profile_writes_a_trace(reads, tmp_path):
    """One read under the profiler (it records every torch op of the
    plain versions): a Chrome trace with complete events."""
    fa = tmp_path / "one.fa"
    fa.write_text(f">{reads[2].name}\n{reads[2].seq}\n")
    trace = tmp_path / "trace.json"
    assert tcli.main(["--device", "cpu", "--profile", str(trace), "-o",
                      str(tmp_path / "x.fa"), str(fa)]) == 0
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(ev.get("ph") == "X" for ev in events)
