"""The port's CLI (--device cpu) against the JAX package's CLI (--device
off, the host oracle), one case per reference option, on in-repo reads:
the written records must be byte-identical.  Also --shard 0/2 with 1/2
covering the unsharded run, and --resume from a cursor.  (--dist, the
one option the port refuses, is in test_torch_engine.py.)

Reads: synth_read tandem reads whose regions land at T=128 (full width)
and T=256 (W=128), and two R2C2-shaped reads with the adapters inside
every unit (test_fuzz._adapter_read) for -a.
"""

import json

import numpy as np
import pytest
import torch
from test_fuzz import _adapter_read

from tidehunter_tpu import cli as jax_cli
from tidehunter_tpu_torch import cli as tcli
from tidehunter_tpu_torch.evals.synth import synth_read
from tidehunter_tpu_torch.io.codec import decode

torch.set_num_threads(1)

SHAPES = [(90, 5, 0.08), (150, 4, 0.1), (70, 6, 0.1)]
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}
# one case per option (-a with the adapters of the reads)
OPTIONS = {
    "k": ["-k", "12"], "w": ["-w", "4"], "H": ["-H"], "c": ["-c", "4"],
    "e": ["-e", "0.1"], "p": ["-p", "100"], "P": ["-P", "120"],
    "MXOE": ["-M", "3", "-X", "5", "-O", "6,20", "-E", "3,1"],
    "m": ["-m", "150"], "r": ["-r", "3"], "l": ["-l"], "a": ["-a", "0.9"],
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(reads.fa, 5' adapter file, 3' adapter file)."""
    d = tmp_path_factory.mktemp("cli_options")
    rng = np.random.default_rng(21)
    seqs = [synth_read(rng, L, c, e, 40) for L, c, e in SHAPES]
    five = decode(rng.integers(0, 4, 24).astype(np.uint8))
    three = decode(rng.integers(0, 4, 22).astype(np.uint8))
    three_rc = "".join(COMP[c] for c in reversed(three))
    seqs += [_adapter_read(rng, five, three_rc, True) for _ in range(2)]
    fa = d / "reads.fa"
    fa.write_text("".join(f">o{i}\n{s}\n" for i, s in enumerate(seqs)))
    (d / "5p.fa").write_text(f">5p\n{five}\n")
    (d / "3p.fa").write_text(f">3p\n{three}\n")
    return str(fa), str(d / "5p.fa"), str(d / "3p.fa")


def _both(tmp_path, args, fa, name="out"):
    """Text written by the port's CLI and by the JAX CLI."""
    mine, ref = tmp_path / f"{name}.port", tmp_path / f"{name}.jax"
    assert tcli.main([*args, "--device", "cpu", "-o", str(mine), fa]) == 0
    assert jax_cli.main([*args, "--device", "off", "-o", str(ref), fa]) == 0
    return mine.read_text(), ref.read_text()


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_matches_jax_cli(inputs, tmp_path, option):
    fa, five, three = inputs
    args = ["-f", "2", *OPTIONS[option]]
    if option == "a":
        args += ["-5", five, "-3", three]
    mine, ref = _both(tmp_path, args, fa)
    assert mine == ref
    assert mine.count("\n") >= 1


def test_shards_cover_unsharded(inputs, tmp_path):
    """--shard 0/2 and 1/2 each equal the JAX CLI's shard, and together
    hold the unsharded run's records, shard 0 the even reads in order."""
    fa = inputs[0]
    full, full_ref = _both(tmp_path, ["-f", "2"], fa, "full")
    assert full == full_ref
    shards = []
    for i in range(2):
        mine, ref = _both(tmp_path, ["-f", "2", "--shard", f"{i}/2"], fa,
                          f"s{i}")
        assert mine == ref
        shards.append(mine.splitlines())
    lines = full.splitlines()
    assert sorted(shards[0] + shards[1]) == sorted(lines)
    names = [ln.split("\t")[0] for ln in shards[0]]
    assert names == [ln.split("\t")[0] for ln in lines
                     if int(ln.split("\t")[0][1:]) % 2 == 0]


def test_resume_matches_jax_cli(inputs, tmp_path):
    """A fresh cursor: the whole run, and the cursor each CLI leaves is
    the same; rerun from it: both skip the finished chunk."""
    fa = inputs[0]
    cursors = [tmp_path / "port.cur", tmp_path / "jax.cur"]
    outs = []
    for run in range(2):
        mine, ref = tmp_path / f"r{run}.port", tmp_path / f"r{run}.jax"
        assert tcli.main(["-f", "2", "--device", "cpu", "--resume",
                          str(cursors[0]), "-o", str(mine), fa]) == 0
        assert jax_cli.main(["-f", "2", "--device", "off", "--resume",
                             str(cursors[1]), "-o", str(ref), fa]) == 0
        assert mine.read_text() == ref.read_text()
        assert json.loads(cursors[0].read_text()) == json.loads(
            cursors[1].read_text()) == {"chunks_done": 1, "reads": 5}
        outs.append(mine.read_text())
    assert outs[0].count("\n") >= 2 and outs[1] == ""

