"""PyTorch port end to end on the CPU (tidehunter_tpu_torch engine, CLI
and API): records byte-identical with the JAX package's engine on the CPU
and with the sequential host oracle; the port runs with JAX blocked from
import; a CUDA request without a card fails loudly.

The reads are in-repo tandem reads (__graft_entry__._tandem_read) whose
units land in MSA buckets T=128 (full width) and T=256 (band W=128).
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

from __graft_entry__ import _tandem_read
from tidehunter_tpu.engine import Engine as JaxEngine
from tidehunter_tpu.io.fastx import FastxRecord
from tidehunter_tpu.io.output import write_read_output
from tidehunter_tpu.params import Params
from tidehunter_tpu.pipeline.core import tidehunter_core
from tidehunter_tpu.utils.metrics import METRICS
from tidehunter_tpu_torch import cli as tcli
from tidehunter_tpu_torch.api import Detector
from tidehunter_tpu_torch.engine import Engine

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
                        seq=_tandem_read(rng, L, c, e, 40))
            for i, (L, c, e) in enumerate(SHAPES)]


@pytest.fixture(scope="module")
def fasta(reads, tmp_path_factory):
    fn = tmp_path_factory.mktemp("reads") / "reads.fa"
    fn.write_text("".join(f">{r.name}\n{r.seq}\n" for r in reads))
    return str(fn)


def _serialize(reads, results, mtp):
    buf = io.StringIO()
    for rec, res in zip(reads, results):
        write_read_output(buf, rec.name, rec.seq, res, mtp)
    return buf.getvalue()


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
            jax_res = JaxEngine(mtp, platform="cpu", mesh=None)(reads, mtp)
            oracle = [tidehunter_core(r.seq, mtp) for r in reads]
            out[qual] = (port, jax_res, oracle)
    return out


@pytest.mark.parametrize("fmt", [1, 2, 3, 4])
def test_engine_matches_jax_engine_and_oracle(runs, reads, fmt):
    mtp = Params()
    mtp.out_fmt = fmt
    port, jax_res, oracle = (_serialize(reads, r, mtp)
                             for r in runs[fmt in (3, 4)])
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


def test_port_runs_with_jax_blocked(runs, reads, fasta, tmp_path):
    out = tmp_path / "nojax.fa"
    code = ("import sys; sys.modules['jax'] = None\n"
            "import torch; torch.set_num_threads(1)\n"
            "from tidehunter_tpu_torch.cli import main\n"
            f"rc = main(['--device', 'cpu', '-o', {str(out)!r}, {fasta!r}])\n"
            "assert not any(m.startswith('jax') and sys.modules[m] is not None"
            " for m in sys.modules), 'jax was imported'\n"
            "sys.exit(rc)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   capture_output=True)
    assert out.read_text() == _serialize(reads, runs[False][2], Params())


def test_cuda_without_card_fails(fasta, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = tmp_path / "never.fa"
    assert tcli.main(["--device", "cuda", "-o", str(out), fasta]) != 0
    assert tcli.main(["-o", str(out), fasta]) != 0   # cuda is the default
    with pytest.raises(RuntimeError):
        Engine(Params(), device="cuda")


@pytest.mark.parametrize("change", ["polish", "graph", "adapters"])
def test_unported_options_are_refused(change, fasta, tmp_path):
    mtp = Params()
    kwargs = {}
    argv = ["--device", "cpu", "-o", str(tmp_path / "x.fa")]
    if change == "polish":
        mtp.polish = 1
        argv += ["--polish", "1"]
    elif change == "graph":
        kwargs["msa_mode"] = "graph"
        argv += ["--msa", "graph"]
    else:
        mtp.five_fn = mtp.three_fn = fasta
        argv += ["-5", fasta, "-3", fasta]
    with pytest.raises(NotImplementedError):
        Engine(mtp, device="cpu", **kwargs)
    assert tcli.main(argv + [fasta]) != 0


def test_detector_cpu_matches_oracle(runs, reads):
    mtp = Params()
    with Detector(device="cpu") as det:
        got = det.detect([(r.name, r.seq) for r in reads])
    assert _serialize(reads, got, mtp) == _serialize(reads, runs[False][2],
                                                     mtp)
    with pytest.raises(ValueError):
        Detector(device="tpu")
