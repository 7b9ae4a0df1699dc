"""The option runs of the port's bench (tidehunter_tpu_torch/evals/bench.py
OPTION_RUNS) on the CPU: their inputs, the committed oracle digests of
every read (evals/option_digests.json) and the gate that holds a run's
records to them.

* The table's 11 runs hold 6 x 1024 + 3 x 512 + 2 x 448 = 8576 reads, and
  the digest file has one digest a read of each, with its command, argv
  and input sha256.
* The adapter population is chip_smoke.py's adapter_reads(default_rng(44),
  1024) as chip_smoke.py drew it before the bench owned it, read for
  read (that generator is copied below).
* Each run's input file, FASTA or gzipped FASTQ, matches its committed
  sha256 (the FASTQ's decompressed text) and reads back as its reads.
* The gate splits a run's output by its -f and -u: a -f 2 text and a -u
  -f 2 text group by read only so, the old call (FASTA split whatever the
  format) mis-groups them, and a tampered digest of a tab record fails;
  FASTA and FASTQ records of no known header form fail.
* bench.main(["--device", "cpu", "--cells", "ada_f2"]) at BENCH_READS=4,
  BENCH_REPS=1 passes its gate and prints the option cell and the host
  key; a tampered -u tab digest makes main exit 1 with no numbers line.
Tolerance: exact (reads, digests, records).
"""

import contextlib
import gzip
import io
import json
import os

import numpy as np
import pytest
import torch

from tidehunter_tpu_torch.evals import bench as B
from tidehunter_tpu_torch.io.codec import decode
from tidehunter_tpu_torch.io.fastx import FastxRecord, read_fastx
from tidehunter_tpu_torch.io.output import (ConsRecord, TandemResult,
                                            write_read_output)
from tidehunter_tpu_torch.ops.myers_device import encode5
from tidehunter_tpu_torch.params import Params

torch.set_num_threads(1)

NEW_RUNS = ("unit_f2", "scoring", "seeding", "ada_a", "fq_f3_l",
            "fq_f4_filt")
# the bench's last line before option cells and the host key
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_t32", "median",
              "periods_reads_per_s", "periods_median", "reps",
              "records_checked", "device", "power_limit"}


@pytest.fixture(autouse=True)
def plain_env(monkeypatch):
    for k in ("TH_MSA", "TH_MESH", "TH_DEVICE_SEED", "TH_DEVICE_CHAIN",
              "TH_OFFLOAD_V1", "BENCH_READS", "BENCH_CHUNK", "BENCH_REPS"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def digests():
    return B.load_digests(B.OPTION_DIGESTS)


@pytest.fixture(scope="module")
def pops():
    return {pop: B.population(pop) for pop in ("adapters", "slice",
                                               "periods_fq")}


def test_runs_and_digest_file_cover_8576_reads(digests):
    names = [run[0] for run in B.OPTION_RUNS]
    assert names == ["ada_f2", "ada_F", "ada_sF", "polish1", "msa_graph",
                     *NEW_RUNS]
    assert sorted(digests["cells"]) == sorted(names)
    assert sum(n for _, _, n, _ in B.OPTION_RUNS) == 8576
    for name, pop, n, argv in B.OPTION_RUNS:
        entry = digests["cells"][name]
        assert entry["command"] == B.OPTION_DIGEST_COMMAND
        assert entry["format"] == B.OPTION_DIGEST_FORMAT
        assert entry["argv"] == argv
        assert entry["reads"] == n == len(entry["digests"])
        assert all(len(d) == 64 for d in entry["digests"])
        assert len(entry["reads_sha256"]) == 64


# chip_smoke.py's adapter population before the bench owned it, copied
FIVE = ("AATGATACGGCGACCACCGAGATCTACACTCGACTAGTCGTCGGCAGCGTCAGATGTGTATAA"
        "GAGACAGTGAATTCTGGTGGG")
THREE = "AAGCAGTGGTATCAACGCAGAGTAC"


def _old_mutate(rng, u, err):
    keep = rng.random(len(u)) >= err / 3
    u = np.where(rng.random(len(u)) < err / 3, rng.integers(0, 4, len(u)),
                 u)[keep]
    ins = rng.random(len(u)) < err / 3
    out = np.empty(len(u) + int(ins.sum()), np.uint8)
    pos = np.arange(len(u)) + np.cumsum(ins)
    out[pos] = u
    mask = np.ones(len(out), bool)
    mask[pos] = False
    out[mask] = rng.integers(0, 4, int(mask.sum()))
    return out


def _old_revcomp(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _old_adapter_reads(rng, n):
    five, three_rc = encode5(FIVE), encode5(_old_revcomp(THREE))
    out = []
    for i in range(n):
        unit = np.concatenate([five, rng.integers(0, 4, 450).astype(
            np.uint8), three_rc])
        parts = [rng.integers(0, 4, 150).astype(np.uint8)]
        parts += [_old_mutate(rng, unit, 0.1) for _ in range(1 if i % 4 == 3
                                                             else 9)]
        parts.append(rng.integers(0, 4, 150).astype(np.uint8))
        out.append(FastxRecord(name=f"ada_{i}", comment="",
                               seq=decode(np.concatenate(parts))))
    return out


def test_adapter_population_is_chip_smokes_old_draw(pops):
    assert (B.FIVE, B.THREE) == (FIVE, THREE)
    want = _old_adapter_reads(np.random.default_rng(44), 1024)
    got = pops["adapters"]
    assert len(got) == B.ADAPTER_READS == 1024
    assert [(r.name, r.seq) for r in got] == [(r.name, r.seq) for r in want]
    assert [r.seq for r in B.cell_reads("ada_a")] == [r.seq for r in
                                                      want[:512]]


def test_periods_fastq_population(pops):
    reads = pops["periods_fq"]
    periods = B.cell_reads("periods")
    assert len(reads) == 448
    assert [r.name for r in reads] == [r.name for r in periods[::2]]
    assert [r.seq for r in reads] == [r.seq for r in periods[::2]]
    assert [r.name.split("_")[0] for r in reads].count("cdna") == 64
    assert all(len(r.qual) == len(r.seq) and set(r.qual) <= set(
        map(chr, range(35, 74))) for r in reads)
    assert B.periods_fastq_reads(3) == reads[:3]
    assert B.cell_reads("fq_f4_filt", 5) == reads[:5]


@pytest.mark.parametrize("run", [r[0] for r in B.OPTION_RUNS])
def test_input_file_matches_committed_sha256(run, digests, pops, tmp_path):
    pop, n, _ = B.OPTIONS[run]
    reads = pops[pop][:n]
    path = B.write_input(run, reads, str(tmp_path))
    text = B.read_input(path)
    assert B.sha256(text) == digests["cells"][run]["reads_sha256"]
    B.check_input(run, reads, digests, text)
    B.check_input(run, reads, digests)
    back = list(read_fastx(path))
    assert [(r.name, r.seq, r.qual) for r in back] == \
        [(r.name, r.seq, r.qual) for r in reads]
    with open(path, "rb") as f:
        assert (f.read(2) == b"\x1f\x8b") == (pop == "periods_fq")
    if pop == "periods_fq":
        assert path.endswith(".fq.gz")
        assert gzip.decompress(open(path, "rb").read()).decode() == text
    with pytest.raises(B.GateError, match="input FAST"):
        B.check_input(run, reads[:-1], digests)


def test_input_gate_holds_argv(digests, pops):
    bad = json.loads(json.dumps(digests))
    bad["cells"]["scoring"]["argv"] = ["-M", "2"]
    with pytest.raises(B.GateError, match="argv"):
        B.check_input("scoring", pops["slice"][:512], bad)


def _old_split(text):
    """The gate's split before the run's -f and -u reached it (FASTA)."""
    out = {}
    lines = text.splitlines(keepends=True)
    for i in range(0, len(lines), 2):
        name = lines[i][1:].split("_rep", 1)[0]
        out[name] = out.get(name, "") + "".join(lines[i:i + 2])
    return out


def _rec(seq, sub_pos, copy_num=2.0):
    return ConsRecord(seq=seq, qual="5" * len(seq), start=sub_pos[0],
                      end=sub_pos[-1], copy_num=copy_num, ave_match=99.0,
                      sub_pos=sub_pos)


def _texts(mtp):
    """Two reads' records (a_rep's read has two records, b's one, c's none)
    serialized under mtp: the whole text and each read's."""
    res = {"a_rep1": TandemResult(), "b": TandemResult(), "c": TandemResult()}
    res["a_rep1"].records = [_rec("ACGTACGT", [0, 8, 16]),
                             _rec("TTGCA", [20, 25, 30, 35], 3.0)]
    res["b"].records = [_rec("GGCA", [1, 5, 9])]
    if mtp.only_unit:
        for r in res.values():
            r.records = [ConsRecord(sub_pos=c.sub_pos, is_unit=True)
                         for c in r.records]
    per = {}
    for name, r in res.items():
        buf = io.StringIO()
        write_read_output(buf, name, "ACGT" * 10, r, mtp)
        per[name] = buf.getvalue()
    return "".join(per.values()), per


@pytest.mark.parametrize("fmt,only_unit", [(1, False), (2, False), (3, False),
                                           (4, False), (1, True), (2, True)])
def test_gate_splits_by_the_runs_format(fmt, only_unit):
    mtp = Params()
    mtp.out_fmt, mtp.only_unit = fmt, only_unit
    text, per = _texts(mtp)
    assert B.records_by_read(text, fmt, only_unit) == {
        k: v for k, v in per.items() if v}
    reads = [FastxRecord(name=k, comment="", seq="") for k in per]
    dig = {"cells": {"x": {"digests": [B.sha256(per[r.name])
                                       for r in reads]}}}
    assert B.check_records("x", reads, text, dig, fmt, only_unit) == 3
    if fmt == 2:
        # the old gate split every output as FASTA pairs: it mis-groups
        # tab lines, which the split now refuses as FASTA
        assert _old_split(text) != B.records_by_read(text, fmt, only_unit)
        with pytest.raises(B.GateError, match="not a record"):
            B.check_records("x", reads, text, dig)
        # a tampered digest of a tab record fails, naming its read
        bad = json.loads(json.dumps(dig))
        d = bad["cells"]["x"]["digests"]
        d[1] = ("0" if d[1][0] != "0" else "1") + d[1][1:]
        with pytest.raises(B.GateError, match="'b'"):
            B.check_records("x", reads, text, bad, fmt, only_unit)
    if fmt in (1, 3):
        # consensus and unit headers are told apart
        with pytest.raises(B.GateError, match="not a record"):
            B.records_by_read(text, fmt, not only_unit)


def test_gate_rejects_malformed_fasta_and_fastq():
    with pytest.raises(B.GateError, match="not a record"):
        B.records_by_read(">r_rep0_2.0 x\nACGT\n>dangling\n")
    with pytest.raises(B.GateError, match="not a record"):
        B.records_by_read("@r_rep0_2.0 x\nAC\n-\n!!\n", 3)


@pytest.fixture(scope="module")
def cpu_option_run():
    """bench.main on the CPU, the ada_f2 cell at 4 reads and 1 rep."""
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BENCH_READS", "4")
        mp.setenv("BENCH_REPS", "1")
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = B.main(["--device", "cpu", "--cells", "ada_f2", "--fastq",
                         os.path.join(os.sep, "absent.fq")])
    return rc, out.getvalue(), err.getvalue()


def test_bench_option_cell_passes_its_gate(cpu_option_run):
    rc, out, err = cpu_option_run
    assert rc == 0, err
    res = json.loads(out.splitlines()[-1])
    assert set(res) == BENCH_KEYS | {"options", "host"}
    assert res["records_checked"] == 4
    assert res["value"] is None and res["reps"] == {}
    cell = res["options"]["ada_f2"]
    assert set(cell) == {"median", "value", "reps", "records_checked"}
    assert cell["records_checked"] == 4 and len(cell["reps"]) == 1
    assert cell["median"] == cell["value"] == cell["reps"][0] > 0
    assert "ada_f2: 4 reads" in err and "match the oracle's digests" in err


def test_bench_host_key(cpu_option_run):
    _, out, err = cpu_option_run
    host = json.loads(out.splitlines()[-1])["host"]
    assert set(host) == {"cpu_model", "cores", "load_1m", "probe_ms"}
    assert host["cores"] == os.cpu_count()
    assert host == {**B.host_info(), "load_1m": host["load_1m"],
                    "probe_ms": host["probe_ms"]}
    before, after = host["load_1m"]["ada_f2"]
    assert before >= 0 and after >= 0
    assert all(ms > 0 for ms in host["probe_ms"]["ada_f2"])
    assert len(host["probe_ms"]["ada_f2"]) == 2
    assert f"# host: {host['cpu_model']}" in err
    assert "# ada_f2 host load (1 min) before" in err and "host probe" in err


def test_bench_keys_without_option_cells(monkeypatch, capsys):
    """The slice alone: bench.py's keys as before, no option cell."""
    monkeypatch.setenv("BENCH_READS", "1")
    monkeypatch.setenv("BENCH_REPS", "1")
    assert B.main(["--device", "cpu", "--cells", "slice", "--fastq",
                   os.path.join(os.sep, "absent.fq")]) == 0
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(res) == BENCH_KEYS | {"options", "host"}
    assert res["options"] == {} and list(res["reps"]) == ["slice"]
    assert list(res["host"]["load_1m"]) == list(res["host"]["probe_ms"]) \
        == ["slice"]
    assert B.parse_args([]).cells == ["slice", "periods"]
    with pytest.raises(SystemExit):
        B.parse_args(["--cells", "slice,nope"])


def test_tampered_unit_tab_digest_fails_the_bench(monkeypatch, capsys,
                                                  tmp_path, digests):
    """unit_f2 (-u -f 2: tab lines of units) at 4 reads: a digest changed
    in a copy of the file exits 1 with no numbers line."""
    bad = json.loads(json.dumps(digests))
    d = bad["cells"]["unit_f2"]["digests"]
    d[2] = ("0" if d[2][0] != "0" else "1") + d[2][1:]
    path = tmp_path / "option_digests.json"
    path.write_text(json.dumps(bad))
    monkeypatch.setenv("BENCH_READS", "4")
    monkeypatch.setenv("BENCH_REPS", "1")
    rc = B.main(["--device", "cpu", "--cells", "unit_f2", "--option-digests",
                 str(path), "--fastq", str(tmp_path / "absent.fq")])
    out, err = capsys.readouterr()
    assert rc == 1
    assert not [ln for ln in out.splitlines() if ln.startswith("{")]
    assert "r2c2_2" in err and "differ from the oracle's digests" in err
