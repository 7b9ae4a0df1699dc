"""The port's bench (tidehunter_tpu_torch/evals/bench.py) on the CPU,
against the JAX package's root ``bench.py`` and its host oracle.

* The slice's and the periods path's reads are root ``bench.py``'s
  ``synth_read`` draws (the first 16 reads of each), and each cell's whole
  input FASTA matches the committed ``reads_sha256``.
* The committed digests cover every read of both cells; those of slice
  reads 0-1 and of the first 60 bp read equal the ones re-derived through
  the JAX package's ``tidehunter_core`` and through the port's.
* ``main(["--device", "cpu", "--cells", "slice"])`` at ``BENCH_READS=4``,
  ``BENCH_REPS=1`` exits 0, checks 4 reads and prints a JSON line naming
  the CPU.
* A digest changed in a copy of the file makes ``main`` exit 1 with no
  numbers line (the input's sha256, which the gate checks before the
  runs); a changed record digest fails the gate on that 4-read run's
  output; a rep or a warm run that differs from the first rep, and a
  record of no input read, fail it too.
* Without ``--device cpu`` on a host with no card the bench exits 2 and
  prints no reads/s.
Tolerance: exact (reads, digests, records).
"""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tidehunter_tpu_torch.evals import bench as B
from tidehunter_tpu_torch.evals.fuzz import serialize
from tidehunter_tpu_torch.params import Params
from tidehunter_tpu_torch.pipeline.core import tidehunter_core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench as J  # noqa: E402
from tidehunter_tpu.io.output import write_read_output as j_write  # noqa: E402
from tidehunter_tpu.params import Params as JParams  # noqa: E402
from tidehunter_tpu.pipeline.core import tidehunter_core as j_core  # noqa: E402

torch.set_num_threads(1)

FIRST = 16


@pytest.fixture(autouse=True)
def plain_env(monkeypatch):
    for k in ("TH_MSA", "TH_MESH", "TH_DEVICE_SEED", "TH_DEVICE_CHAIN",
              "TH_OFFLOAD_V1", "BENCH_READS", "BENCH_CHUNK", "BENCH_REPS"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def digests():
    return B.load_digests()


@pytest.fixture(scope="module")
def cells():
    return {cell: B.cell_reads(cell) for cell in B.CELLS}


@pytest.fixture(scope="module")
def cpu_run():
    """main on the CPU at 4 slice reads and 1 rep: (exit code, stdout,
    stderr, the first rep's output text as the gate saw it)."""
    seen = []
    check = B.check_records

    def spy(cell, reads, text, digests):
        seen.append(text)
        return check(cell, reads, text, digests)

    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BENCH_READS", "4")
        mp.setenv("BENCH_REPS", "1")
        mp.setattr(B, "check_records", spy)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = B.main(["--device", "cpu", "--cells", "slice",
                         "--fastq", os.path.join(ROOT, "absent.fq")])
    return rc, out.getvalue(), err.getvalue(), seen[0] if seen else None


def test_reads_are_root_bench_synth_reads(cells):
    rng = np.random.default_rng(42)
    want = [J.synth_read(rng) for _ in range(FIRST)]
    assert [r.seq for r in B.slice_reads(FIRST)] == want
    assert [r.seq for r in cells["slice"][:FIRST]] == want
    assert [r.name for r in B.slice_reads(2)] == ["r2c2_0", "r2c2_1"]
    rng = np.random.default_rng(43)
    _, _, unit_len, copies = B.PERIOD_POPULATIONS[0]
    want = [J.synth_read(rng, unit_len, copies) for _ in range(FIRST)]
    periods = cells["periods"]
    assert [r.seq for r in periods[:FIRST]] == want
    assert len(periods) == sum(p[1] for p in B.PERIOD_POPULATIONS) == 896


@pytest.mark.parametrize("cell", B.CELLS)
def test_whole_input_matches_committed_sha256(cell, digests, cells):
    reads = cells[cell]
    entry = digests["cells"][cell]
    assert entry["reads"] == len(reads) == len(entry["digests"])
    assert hashlib.sha256(B.fasta(reads).encode()).hexdigest() \
        == entry["reads_sha256"]
    assert entry["command"] == B.DIGEST_COMMAND
    assert all(len(d) == 64 for d in entry["digests"])
    B.check_input(cell, reads, digests)


def _j_serialize(rec, res, mtp):
    buf = io.StringIO()
    j_write(buf, rec.name, rec.seq, res, mtp)
    return buf.getvalue()


SAMPLE = [("slice", 0), ("slice", 1), ("periods", 0)]


@pytest.mark.parametrize("cell,i", SAMPLE)
def test_committed_digests_rederived_by_both_oracles(cell, i, digests,
                                                     cells):
    rec = cells[cell][i]
    want = digests["cells"][cell]["digests"][i]
    mtp = Params()
    port = B.sha256(serialize([rec], [tidehunter_core(rec.seq, mtp)], mtp))
    jmtp = JParams()
    jax = B.sha256(_j_serialize(rec, j_core(rec.seq, jmtp), jmtp))
    assert port == jax == want


def _json_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("{")]


def test_main_on_cpu_checks_every_read(cpu_run):
    rc, out, err, _ = cpu_run
    assert rc == 0
    res = json.loads(out.splitlines()[-1])
    assert res["device"] == "cpu" and res["power_limit"] is None
    assert res["records_checked"] == 4
    assert len(res["reps"]["slice"]) == 1 and res["value"] > 0
    assert res["median"] == res["value"]
    assert res["vs_baseline"] == res["value"] / B.BASE_READS_PER_S
    assert res["periods_reads_per_s"] is None
    assert "absent, the test.fq axis skipped" in err
    assert "match the oracle's digests" in err


def test_tampered_input_digest_fails_the_bench(monkeypatch, capsys,
                                               tmp_path, digests):
    bad = json.loads(json.dumps(digests))
    entry = bad["cells"]["slice"]
    entry["reads_sha256"] = B.sha256("not the slice")
    path = tmp_path / "digests.json"
    path.write_text(json.dumps(bad))
    monkeypatch.setenv("BENCH_READS", "4")
    monkeypatch.setenv("BENCH_REPS", "1")
    rc = B.main(["--device", "cpu", "--cells", "slice", "--digests",
                 str(path), "--fastq", str(tmp_path / "absent.fq")])
    out, err = capsys.readouterr()
    assert rc == 1
    assert not _json_lines(out)
    assert "input FASTA sha256" in err


@pytest.mark.parametrize("i", range(4))
def test_tampered_record_digest_fails_the_gate(i, cpu_run, digests, cells):
    text = cpu_run[3]
    reads = cells["slice"][:4]
    assert B.check_records("slice", reads, text, digests) == 4
    bad = json.loads(json.dumps(digests))
    d = bad["cells"]["slice"]["digests"]
    d[i] = ("0" if d[i][0] != "0" else "1") + d[i][1:]
    with pytest.raises(B.GateError, match=f"r2c2_{i}'"):
        B.check_records("slice", reads, text, bad)


def test_gate_rejects_reps_and_stray_records(digests):
    B.check_reps("slice", ["a", "a", "a"])
    with pytest.raises(B.GateError, match="rep 1"):
        B.check_reps("slice", ["a", "a", "b"])
    with pytest.raises(B.GateError, match="warm run"):
        B.check_reps("slice", ["b", "a", "a"])
    reads = B.slice_reads(1)
    with pytest.raises(B.GateError, match="records of no input read"):
        B.check_records("slice", reads, ">stray_rep0_1.0 x\nACGT\n",
                        digests)
    with pytest.raises(B.GateError, match="input FASTA"):
        B.check_input("slice", reads, digests)


def test_records_by_read_splits_each_format():
    fa = ">a_rep0_2.0 x\nAC\n>a_rep1_3.0 y\nGT\n>b_rep0_2.0 z\nTT\n"
    assert B.records_by_read(fa) == {
        "a": ">a_rep0_2.0 x\nAC\n>a_rep1_3.0 y\nGT\n",
        "b": ">b_rep0_2.0 z\nTT\n"}
    fq = "@a_rep0 x\nAC\n+\n!!\n"
    assert B.records_by_read(fq, 3) == {"a": fq}
    tab = "a\trep0\t2.0\nb\trep0\t3.0\n"
    assert B.records_by_read(tab, 2) == {"a": "a\trep0\t2.0\n",
                                         "b": "b\trep0\t3.0\n"}


def test_no_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert B.main([]) == 2
    out, err = capsys.readouterr()
    assert out == "" and len(err.splitlines()) == 1


def test_no_card_module_run_exits_2():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m",
                        "tidehunter_tpu_torch.evals.bench"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2
    assert r.stdout == "" and "no CUDA device" in r.stderr
