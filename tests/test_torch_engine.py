"""PyTorch port end to end on the CPU (tidehunter_tpu_torch engine, CLI
and API): records byte-identical with the JAX package's engine on the CPU
and with the sequential host oracle; a CUDA request without a card fails
loudly, and so does --dist, the one option the port does not run.  (The run with JAX blocked from import is in test_torch_host.py.)

The reads are in-repo tandem reads (evals/synth.synth_read) whose units
land in MSA buckets T=128 (full width) and T=256 (band W=128).
TH_HOST_ALN_CAP is lowered so that the aveMatch and partition alignments
reach the wavefront path too.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tidehunter_tpu.engine import Engine as JaxEngine
from tidehunter_tpu.io.output import write_read_output as jax_write
from tidehunter_tpu.params import Params as JaxParams
from tidehunter_tpu.pipeline.core import tidehunter_core
from tidehunter_tpu_torch import cli as tcli
from tidehunter_tpu_torch.api import Detector
from tidehunter_tpu_torch.engine import Engine
from tidehunter_tpu_torch.evals.synth import synth_read
from tidehunter_tpu_torch.io.fastx import FastxRecord
from tidehunter_tpu_torch.io.output import write_read_output
from tidehunter_tpu_torch.params import Params
from tidehunter_tpu_torch.utils.metrics import METRICS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (unit length, copies, error rate): periods around 60-100 bp -> T=128,
# around 140-175 bp -> T=256 with the W=128 band
SHAPES = [(90, 5, 0.05), (150, 4, 0.08), (80, 6, 0.1), (160, 5, 0.05),
          (100, 4, 0.03), (140, 6, 0.1), (60, 5, 0.05), (170, 4, 0.05)]


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(1)
    return [FastxRecord(name=f"r{i}", comment="",
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


def _jax_params(fmt):
    jmtp = JaxParams()
    jmtp.out_fmt = fmt
    return jmtp


@pytest.fixture(scope="module")
def runs(reads):
    """Results of the three engines, without and with consensus quality
    (-f 1/2 and -f 3/4 differ in the pipeline only by that)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TH_HOST_ALN_CAP", "64")
        for qual, fmt in ((False, 2), (True, 4)):
            mtp = Params()
            mtp.out_fmt = fmt
            before = METRICS.snapshot()
            port = Engine(mtp, device="cpu")(reads, mtp)
            after = METRICS.snapshot()
            for key in ("time_dev_global_s", "time_dev_ext_s",
                        "msa_batches"):
                assert after.get(key, 0) > before.get(key, 0), key
            jmtp = _jax_params(fmt)
            jax_res = JaxEngine(jmtp, platform="cpu", mesh=None)(reads, jmtp)
            oracle = [tidehunter_core(r.seq, jmtp) for r in reads]
            out[qual] = (port, jax_res, oracle)
    return out


@pytest.mark.parametrize("fmt", [1, 2, 3, 4])
def test_engine_matches_jax_engine_and_oracle(runs, reads, fmt):
    mtp = Params()
    mtp.out_fmt = fmt
    port, jax_res, oracle = runs[fmt in (3, 4)]
    port = _serialize(reads, port, mtp)
    jax_res, oracle = (_serialize(reads, r, _jax_params(fmt), jax_write)
                       for r in (jax_res, oracle))
    assert port.count("\n") >= len(reads)
    assert port == jax_res
    assert port == oracle


def test_cli_cpu_matches_jax_cli_off(fasta, tmp_path):
    mine = tmp_path / "port.tab"
    assert tcli.main(["-f", "2", "--device", "cpu", "-o", str(mine),
                      fasta]) == 0
    ref = tmp_path / "jax.tab"
    subprocess.run([sys.executable, "-m", "tidehunter_tpu.cli", "-f", "2",
                    "--device", "off", "-o", str(ref), fasta],
                   cwd=ROOT, check=True, capture_output=True)
    assert mine.read_text() == ref.read_text()
    assert mine.read_text().count("\n") >= len(SHAPES)


def test_cuda_without_card_fails(fasta, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = tmp_path / "never.fa"
    assert tcli.main(["--device", "cuda", "-o", str(out), fasta]) != 0
    assert tcli.main(["-o", str(out), fasta]) != 0   # cuda is the default
    with pytest.raises(RuntimeError):
        Engine(Params(), device="cuda")


@pytest.mark.parametrize("change", ["dist"])
def test_unported_options_are_refused(change, fasta, tmp_path):
    """--dist is the one option of the JAX CLI the port does not run: an
    error, and no output file."""
    out = tmp_path / "x.fa"
    argv = ["--device", "cpu", "-o", str(out), "--dist",
            "localhost:1234/2/0"]
    assert tcli.main(argv + [fasta]) != 0
    assert not out.exists()


def test_detector_cpu_matches_oracle(runs, reads):
    mtp = Params()
    with Detector(device="cpu") as det:
        got = det.detect([(r.name, r.seq) for r in reads])
    assert _serialize(reads, got, mtp) == _serialize(
        reads, runs[False][2], _jax_params(mtp.out_fmt), jax_write)
    with pytest.raises(ValueError):
        Detector(device="tpu")
