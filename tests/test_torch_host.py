"""The port's own host layers against the JAX package's originals, on the
CPU, and the guards that keep the port standing alone.

The port keeps a copy of every framework-free module it runs (params, io,
native C, the NumPy ops, pipeline); these tests hold each copy to its
original on the same inputs, made from a numpy seed by the port's
evals/synth.synth_read:

  * synth_read reproduces bench.synth_read and __graft_entry__._tandem_read
    read for read;
  * (a) pipeline.core.tidehunter_core writes byte-identical records with
    the JAX package's for -f 1..4 and -u, on 24 fuzz-style reads (periods
    30-600, 2-8 copies, error 0/5/15%) and 8 default synth_read reads;
  * (b) the native library, built from the port's own C sources into
    tidehunter_tpu_torch/_build/, gives the same seeding hits, chains,
    right-hand walks and global_tleft_one results;
  * (c) no module of the port, and nothing in chip_smoke.py, imports
    tidehunter_tpu, jax, jaxlib, bench or __graft_entry__;
  * (d) with jax and tidehunter_tpu blocked from import, the CLI on the
    CPU writes the records that --device off writes, and those of the JAX
    package's oracle.
"""

import ast
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from __graft_entry__ import _tandem_read
from bench import synth_read as bench_synth_read
from tidehunter_tpu.io.output import write_read_output as jax_write
from tidehunter_tpu.ops import chaining_native as j_chain
from tidehunter_tpu.ops import ksw2_native as j_ksw2
from tidehunter_tpu.ops import seeding_native as j_seed
from tidehunter_tpu.params import Params as JaxParams
from tidehunter_tpu.pipeline.core import tidehunter_core as jax_core
from tidehunter_tpu_torch import native as t_native
from tidehunter_tpu_torch.evals.synth import synth_read
from tidehunter_tpu_torch.io.codec import encode
from tidehunter_tpu_torch.io.fastx import FastxRecord
from tidehunter_tpu_torch.io.output import write_read_output
from tidehunter_tpu_torch.ops import chaining_native as t_chain
from tidehunter_tpu_torch.ops import ksw2_native as t_ksw2
from tidehunter_tpu_torch.ops import seeding_native as t_seed
from tidehunter_tpu_torch.params import Params
from tidehunter_tpu_torch.pipeline.core import tidehunter_core

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tidehunter_tpu_torch")
BLOCKED = ("tidehunter_tpu", "jax", "jaxlib", "bench", "__graft_entry__")
# (unit length, copies, error rate) of the CLI reads: short periods keep
# the CPU run of the plain kernels quick
CLI_SHAPES = [(90, 5, 0.05), (150, 4, 0.08), (80, 6, 0.1), (160, 5, 0.05),
              (100, 4, 0.03), (140, 6, 0.1), (60, 5, 0.05), (170, 4, 0.05)]


def fuzz_reads(rng, n):
    out = []
    for i in range(n):
        L = int(rng.integers(30, 601))
        copies = int(rng.integers(2, 9))
        err = float(rng.choice([0.0, 0.05, 0.15]))
        out.append(FastxRecord(name=f"fuzz_{i}", comment="", seq=synth_read(
            rng, L, copies, err, int(rng.integers(0, 200)))))
    return out


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(2024)
    out = fuzz_reads(rng, 24)
    out += [FastxRecord(name=f"r2c2_{i}", comment="", seq=synth_read(rng))
            for i in range(8)]
    return out


def _serialize(reads, results, mtp, write):
    buf = io.StringIO()
    for rec, res in zip(reads, results):
        write(buf, rec.name, rec.seq, res, mtp)
    return buf.getvalue()


def test_synth_read_reproduces_bench_and_graft_entry():
    args = [(), (450, 9, 0.10, 150), (37, 3, 0.0, 0), (600, 2, 0.15, 199)]
    for seed in (0, 42):
        mine, bench, graft = (np.random.default_rng(seed) for _ in range(3))
        for a in args:
            got = synth_read(mine, *a)
            assert got == bench_synth_read(bench, *a)
            assert got == _tandem_read(graft, *(a or (450, 9, 0.10, 150)))


# --- (a) the oracle pipeline --------------------------------------------

FORMATS = {"f1": (1, False), "f2": (2, False), "f3": (3, False),
           "f4": (4, False), "u": (1, True)}
_core_runs = {}


def _core_results(reads, fmt, unit):
    """Both packages' tidehunter_core over the reads; formats that run the
    same pipeline (quality or not, unit mode or not) share one run."""
    key = (fmt in (3, 4), unit)
    if key not in _core_runs:
        mtp, jmtp = Params(), JaxParams()
        for p in (mtp, jmtp):
            p.out_fmt, p.only_unit = fmt, unit
        _core_runs[key] = ([tidehunter_core(r.seq, mtp) for r in reads],
                           [jax_core(r.seq, jmtp) for r in reads])
    return _core_runs[key]


@pytest.mark.parametrize("flags", list(FORMATS))
def test_core_matches_jax_core(reads, flags):
    fmt, unit = FORMATS[flags]
    port, ref = _core_results(reads, fmt, unit)
    mtp, jmtp = Params(), JaxParams()
    for p in (mtp, jmtp):
        p.out_fmt, p.only_unit = fmt, unit
    got = _serialize(reads, port, mtp, write_read_output)
    want = _serialize(reads, ref, jmtp, jax_write)
    assert got == want
    assert sum(len(r.records) for r in port) >= len(reads) // 2


# --- (b) the native library ---------------------------------------------

def _chain_fields(dp, chains):
    grid = None if dp is None else {
        s: np.asarray(getattr(dp, s)).tolist() for s in type(dp).__slots__
        if getattr(dp, s, None) is not None}
    return grid, [(np.asarray(c.cells).tolist(), c.score, c.est_ch_i,
                   c.est_period, c.est_start) for c in chains]


def _native_inputs(reads):
    mtp = Params()
    for r in reads:
        bseq = encode(r.seq)
        ends, periods = t_seed.collect_tandem_repeat_hits(
            bseq, mtp.k, mtp.w, mtp.hpc, mtp.min_p, mtp.max_p)
        dp, chains = t_chain.tandem_chain_native(ends, periods, mtp.k)
        yield mtp, bseq, ends, periods, dp, chains


def test_native_library_is_the_ports_own():
    t_native.get_lib()
    build = os.path.join(PORT, "_build")
    assert os.path.dirname(t_native.lib_path) == build
    assert os.path.basename(t_native.lib_path).startswith("libth_native_")
    for src in ("chainx.c", "seedx.c", "alignx.c", "poax.c"):
        assert os.path.exists(os.path.join(PORT, "native", src))
    assert t_ksw2.available() and j_ksw2.available()


@pytest.mark.parametrize("what", ["seeds", "chains", "walk_right",
                                  "global_tleft"])
def test_native_matches_jax_native(reads, what):
    assert t_ksw2.available() and j_ksw2.available()
    n_checked = 0
    rng = np.random.default_rng(11)
    for mtp, bseq, ends, periods, dp, chains in _native_inputs(reads):
        if what == "seeds":
            je, jp = j_seed.collect_tandem_repeat_hits(
                bseq, mtp.k, mtp.w, mtp.hpc, mtp.min_p, mtp.max_p)
            np.testing.assert_array_equal(ends, je)
            np.testing.assert_array_equal(periods, jp)
            n_checked += len(ends)
        elif what == "chains":
            assert _chain_fields(dp, chains) == _chain_fields(
                *j_chain.tandem_chain_native(ends, periods, mtp.k))
            n_checked += len(chains)
        elif what == "walk_right":
            for ch in chains:
                cells = np.asarray(ch.cells)
                args = (bseq, dp.start[cells], dp.end[cells], ch.est_start,
                        ch.est_period, mtp.k, mtp.max_div, 192)
                got = t_ksw2.walk_right_native(*args)
                assert got == j_ksw2.walk_right_native(*args)
                n_checked += got is not None
        else:
            for _ in range(8):
                a = int(rng.integers(0, len(bseq) - 8))
                q = bseq[a:a + int(rng.integers(1, 200))]
                b = int(rng.integers(0, len(bseq) - 8))
                t = bseq[b:b + int(rng.integers(1, 200))]
                qle = int(rng.integers(0, len(q) + 2))
                got = t_ksw2.global_tleft_one(q, t, qle)
                assert got == j_ksw2.global_tleft_one(q, t, qle)
                n_checked += 1
    assert n_checked >= len(reads)


# --- (c) the import guard -------------------------------------------------

def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 30
    scanned = {os.path.relpath(f, PORT) for f in files}
    assert {"ops/seeding_device.py", "ops/chaining_device.py",
            "ops/offload.py", "tools/merge.py", "tools/tab2fa.py",
            "parallel/mesh.py", "evals/fuzz.py", "evals/accuracy.py",
            "evals/soak.py", "evals/sass_loops.py",
            "evals/bench.py"} <= scanned
    bad = [f"{os.path.relpath(f, ROOT)}:{line}: {name}"
           for f in files for line, name in _imports(f)
           if name.split(".")[0] in BLOCKED]
    assert not bad, bad


# --- (d) the port with JAX and the JAX package blocked ------------------

@pytest.fixture(scope="module")
def cli_reads(tmp_path_factory):
    rng = np.random.default_rng(1)
    recs = [FastxRecord(name=f"r{i}", comment="",
                        seq=synth_read(rng, L, c, e, 40))
            for i, (L, c, e) in enumerate(CLI_SHAPES)]
    fn = tmp_path_factory.mktemp("reads") / "reads.fa"
    fn.write_text("".join(f">{r.name}\n{r.seq}\n" for r in recs))
    return recs, str(fn)


def _blocked_run(entry, argv):
    """Run the port's CLI in a fresh interpreter with every blocked name
    set to None in sys.modules; fails if any of them got imported."""
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        f"sys.argv = ['tidehunter_tpu_torch.cli'] + {argv!r}\n"
        + ("import runpy\n"
           "try:\n"
           "    runpy.run_module('tidehunter_tpu_torch.cli',"
           " run_name='__main__')\n"
           "except SystemExit as e:\n"
           "    rc = e.code\n"
           if entry == "module" else
           "from tidehunter_tpu_torch.cli import main\n"
           "rc = main(sys.argv[1:])\n")
        + f"leaked = [m for m in sys.modules if m.split('.')[0] in "
          f"{BLOCKED!r} and sys.modules[m] is not None]\n"
          "assert not leaked, leaked\n"
          "sys.exit(rc)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   capture_output=True)


@pytest.mark.parametrize("entry,fmt", [("module", "2"), ("main", "1")],
                         ids=["python_m_cli_f2", "cli_main_f1"])
def test_port_runs_with_jax_blocked(cli_reads, tmp_path, entry, fmt):
    recs, fasta = cli_reads
    outs = {}
    for device in ("cpu", "off"):
        outs[device] = tmp_path / f"{device}.out"
        _blocked_run(entry, ["-f", fmt, "--device", device,
                             "-o", str(outs[device]), fasta])
    jmtp = JaxParams()
    jmtp.out_fmt = int(fmt)
    want = _serialize(recs, [jax_core(r.seq, jmtp) for r in recs], jmtp,
                      jax_write)
    got = outs["cpu"].read_text()
    assert got == outs["off"].read_text() == want
    assert got.count("\n") >= len(recs)
