"""The port's adapter paths on the CPU: the engine's ``hws`` rounds (Myers
adapter searches, ops/myers_device) and its single-copy stage, against the
JAX package's engine and the host oracle, byte for byte.

The cases are those of test_fuzz.py::test_engine_matches_oracle_adapter_fuzz
(plain adapters, -F, -F -s, only_longest), on fewer reads of the same
generator (_adapter_read: the adapters inside every unit, or a single
copy), plus adapter-free controls.
"""

import io

import numpy as np
import pytest
import torch
from test_fuzz import _adapter_read, _random_read

from tidehunter_tpu.engine import Engine as JaxEngine
from tidehunter_tpu.io.output import write_read_output as jax_write
from tidehunter_tpu.params import Params as JaxParams
from tidehunter_tpu.pipeline.core import tidehunter_core
from tidehunter_tpu.pipeline.runner import load_adapters as jax_load
from tidehunter_tpu_torch.api import Detector
from tidehunter_tpu_torch.engine import Engine
from tidehunter_tpu_torch.io.codec import decode
from tidehunter_tpu_torch.io.fastx import FastxRecord
from tidehunter_tpu_torch.io.output import write_read_output
from tidehunter_tpu_torch.params import Params
from tidehunter_tpu_torch.pipeline.runner import load_adapters
from tidehunter_tpu_torch.utils.metrics import METRICS

torch.set_num_threads(1)

COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
CASES = [(11, 2, {}), (12, 3, {"only_full_length": True}),
         (13, 1, {"only_full_length": True, "single_copy": True}),
         (14, 2, {"only_longest": True})]


def _serialize(reads, results, mtp, write=write_read_output):
    buf = io.StringIO()
    for rec, res in zip(reads, results):
        write(buf, rec.name, rec.seq, res, mtp)
    return buf.getvalue()


def adapter_case(tmp_path, seed, fmt, extra, n_reads=6, n_controls=2):
    """(reads, port Params, JAX Params) of one case, adapters loaded."""
    rng = np.random.default_rng(seed)
    five = decode(rng.integers(0, 4, 24).astype(np.uint8))
    three = decode(rng.integers(0, 4, 22).astype(np.uint8))
    three_rc = "".join(COMP[c] for c in reversed(three))
    (tmp_path / "5p.fa").write_text(f">5p\n{five}\n")
    (tmp_path / "3p.fa").write_text(f">3p\n{three}\n")
    params = []
    for cls, load in ((Params, load_adapters), (JaxParams, jax_load)):
        mtp = cls()
        mtp.out_fmt = fmt
        mtp.five_fn = str(tmp_path / "5p.fa")
        mtp.three_fn = str(tmp_path / "3p.fa")
        for k, v in extra.items():
            setattr(mtp, k, v)
        load(mtp)
        params.append(mtp)
    single = extra.get("single_copy", False)
    reads = [FastxRecord(name=f"a{i}", comment="",
                         seq=_adapter_read(rng, five, three_rc,
                                           tandem=not (single and i % 2)))
             for i in range(n_reads)]
    reads += [FastxRecord(name=f"c{i}", comment="", seq=_random_read(rng))
              for i in range(n_controls)]
    return reads, params[0], params[1]


@pytest.mark.parametrize("seed,fmt,extra", CASES,
                         ids=["plain", "F", "F_s", "longest"])
def test_adapter_engine_matches_jax_engine_and_oracle(tmp_path, seed, fmt,
                                                      extra):
    reads, mtp, jmtp = adapter_case(tmp_path, seed, fmt, extra)
    before = METRICS.snapshot()
    port = _serialize(reads, Engine(mtp, device="cpu")(reads, mtp), mtp)
    after = METRICS.snapshot()
    assert after.get("time_dev_hws_s", 0) > before.get("time_dev_hws_s", 0)
    assert after.get("hws_host", 0) == before.get("hws_host", 0)
    if extra.get("single_copy"):
        assert after.get("time_single_copy_s", 0) > before.get(
            "time_single_copy_s", 0)
    jax_res = JaxEngine(jmtp, platform="cpu", mesh=None)(reads, jmtp)
    oracle = [tidehunter_core(r.seq, jmtp) for r in reads]
    assert port == _serialize(reads, jax_res, jmtp, jax_write)
    assert port == _serialize(reads, oracle, jmtp, jax_write)
    if not extra.get("only_full_length"):
        assert port


def test_detector_with_adapters_matches_oracle(tmp_path):
    """Detector(device="cpu", five_fn=..., three_fn=...,
    only_full_length=..., single_copy=...) runs the same engine, no
    refusal."""
    extra = {"only_full_length": True, "single_copy": True}
    reads, mtp, jmtp = adapter_case(tmp_path, 13, 1, extra, 4, 1)
    with Detector(device="cpu", five_fn=mtp.five_fn, three_fn=mtp.three_fn,
                  out_fmt=1, **extra) as det:
        got = det.detect([(r.name, r.seq) for r in reads])
    assert _serialize(reads, got, mtp) == _serialize(
        reads, [tidehunter_core(r.seq, jmtp) for r in reads], jmtp,
        jax_write)
