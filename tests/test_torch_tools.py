"""The port's tools (tidehunter_tpu_torch/tools/merge.py and tab2fa.py)
against the JAX package's originals, on the inputs of test_merge.py and
test_tab2fa.py: the same output for every mode, a merge of the port's own
--shard outputs equal to its unsharded run, and both copies run as
``python -m tidehunter_tpu_torch.tools.<name>``.
"""

import io
import os
import subprocess
import sys

import pytest
from test_merge import _write_reads
from test_tab2fa import TAB

from tidehunter_tpu.tools import merge as jmerge
from tidehunter_tpu.tools import tab2fa as jtab2fa
from tidehunter_tpu_torch import cli as tcli
from tidehunter_tpu_torch.tools import merge as tmerge
from tidehunter_tpu_torch.tools import tab2fa as ttab2fa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FA = ">x_1_0\nAC\n>y_2_1\nGT\n>read1_rep0_4.0_300_51_250_50_100.0_0_1,2\nACGT\n"


@pytest.mark.parametrize("out_type", ["fa", "tab"])
@pytest.mark.parametrize("only_full", [False, True])
def test_tab2fa_matches_original(out_type, only_full):
    for fn in ("tab_transform", "fa_transform"):
        src = TAB if fn == "tab_transform" else FA
        got, want = io.StringIO(), io.StringIO()
        getattr(ttab2fa, fn)(io.StringIO(src), got, out_type, only_full)
        getattr(jtab2fa, fn)(io.StringIO(src), want, out_type, only_full)
        assert got.getvalue() == want.getvalue() != ""


def _module(name, args, cwd):
    return subprocess.run([sys.executable, "-m", name, *args], cwd=cwd,
                          capture_output=True, text=True, check=True,
                          env={**os.environ, "PYTHONPATH": ROOT})


def test_tab2fa_module_matches_original(tmp_path):
    (tmp_path / "in.tab").write_text(TAB)
    for pkg in ("tidehunter_tpu_torch", "tidehunter_tpu"):
        _module(f"{pkg}.tools.tab2fa", ["in.tab", f"{pkg}.fa", "-F"],
                tmp_path)
    got = (tmp_path / "tidehunter_tpu_torch.fa").read_text()
    assert got == (tmp_path / "tidehunter_tpu.fa").read_text()
    assert got.startswith(">read2_")


def _shards(tmp_path, fn, fmt):
    """The port's CLI (host oracle) on the whole input and on --shard
    0/3, 1/3, 2/3."""
    full = tmp_path / f"full.{fmt}"
    assert tcli.main(["-f", str(fmt), "--device", "off", "-o", str(full),
                      fn]) == 0
    shards = []
    for si in range(3):
        out = tmp_path / f"out.shard{si}-of-3.{fmt}"
        assert tcli.main(["-f", str(fmt), "--device", "off", "--shard",
                          f"{si}/3", "-o", str(out), fn]) == 0
        shards.append(str(out))
    return full.read_text(), shards


@pytest.mark.parametrize("fmt", [1, 2, 3])
def test_merge_of_port_shards_matches_original(tmp_path, fmt):
    fn = _write_reads(tmp_path)
    full, shards = _shards(tmp_path, fn, fmt)
    got, want = io.StringIO(), io.StringIO()
    n = tmerge.merge(fn, shards, fmt, got)
    assert n == jmerge.merge(fn, shards, fmt, want) > 0
    assert got.getvalue() == want.getvalue() == full


def test_merge_module_matches_original(tmp_path):
    fn = _write_reads(tmp_path)
    full, shards = _shards(tmp_path, fn, 2)
    outs = [_module(f"{pkg}.tools.merge", ["-i", fn, "-f", "2", *shards],
                    tmp_path).stdout
            for pkg in ("tidehunter_tpu_torch", "tidehunter_tpu")]
    assert outs[0] == outs[1] == full


def test_merge_rejects_foreign_records(tmp_path):
    fn = _write_reads(tmp_path, n=4)
    bogus = tmp_path / "bogus.out"
    bogus.write_text("not_a_read\trep0\t1.0\t1\t1\t1\t1\t1.0\t0\t1\tA\n")
    with pytest.raises(ValueError, match="absent"):
        tmerge.merge(fn, [str(bogus)], 2, io.StringIO())
