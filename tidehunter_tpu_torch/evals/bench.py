"""Full-pipeline reads/s of the port on one card, every record gated.

The port's counterpart of the JAX package's root ``bench.py``, function by
function:

* ``synth_read`` is ``evals/synth.synth_read`` (the same draws from the
  same seed);
* the reads: the slice, 1024 ONT R2C2-style concatemer reads ``r2c2_{i}``
  (~4.3 kb: 9 copies of a 450 bp unit at 10% error between random
  flanks, seed 42, chunks of ``max(64, n // 2)``), bench.py's own
  workload; and the periods path, 896 reads of seed 43 (512 of a 60 bp
  unit x 60, 256 of 1500 bp x 6, 128 of 3000 bp x 4, chunks of 512),
  bench.py's second axis (the reference's ``test.fq``, periods 0.1-3.1
  kb) in a form made from a seed.  ``--fastq PATH`` (default ``test.fq``,
  the reference's 100 ONT reads) keeps that axis itself when the file is
  there, and says on stderr that it was skipped when it is not;
* ``probe_device`` checks for a CUDA card: without one, and without
  ``--device cpu``, the bench exits 2 with one stderr line and prints no
  reads/s;
* ``tpu_smoke`` (the hardware-gated pytest subsets) is not ported: on the
  card that is ``chip_smoke.py``'s phases 2-3, which hold every kernel to
  its plain version;
* ``main``: the engine of ``engine.make_engine``, one warm run a cell,
  then ``BENCH_REPS`` timed runs (default 5; the median needs them), each
  timed on the host clock around ``pipeline.runner.run`` and ending in
  ``torch.cuda.synchronize()``; stage timers reset after the warm run;
  per-rep stage lines and the kernels' Gcell/s on stderr.

Every record is gated, which bench.py was not: the first timed rep's
output is split by read, each read's text (its serialized records, the
empty string when it has none) is hashed with sha256 and compared with
the host oracle's digest in ``bench_digests.json``, the input FASTA's
sha256 with the file's, and the warm run and the other reps byte for byte
with the first timed rep.  Any difference exits 1 with no numbers line.

The option runs (``OPTION_RUNS``: adapters with ``-f 2``, ``-F`` and
``-s -F``, ``--polish 1``, ``--msa graph``, ``-u -f 2``, non-default
``-M -X -O -E``, ``-H -k 16 -w 5``, ``-a 0.99 -f 2``, and the periods
path's every second read as gzipped FASTQ under ``-f 3 -l`` and ``-f 4``
with every filter) are cells too: each owns its population, its argv and
its digests in ``option_digests.json``, and takes the same gate, its
output split by its ``-f`` and ``-u`` and its input's sha256 that of the
decompressed text.  An option cell builds its engine from its own Params
as the CLI does (``make_engine``; ``--msa graph`` sets ``TH_MSA`` for
its runs).  chip_smoke.py's phase 6 runs each through the CLI on the card
and holds every read to the same digests with the same gate.

Usage:
    python -m tidehunter_tpu_torch.evals.bench [--device cuda|cpu]
        [--cells slice,periods,ada_f2,...] [--fastq PATH] [--digests PATH]
        [--option-digests PATH]
    BENCH_READS=4 BENCH_REPS=1 python -m tidehunter_tpu_torch.evals.bench \\
        --device cpu --cells slice,ada_f2
    # the host oracle's digests of every read of both cells (~16 min over
    # 7 processes on an 8-core host)
    python -m tidehunter_tpu_torch.evals.bench --write-digests \\
        tidehunter_tpu_torch/evals/bench_digests.json
    # and of every read of the 11 option runs (8576 reads)
    python -m tidehunter_tpu_torch.evals.bench --write-option-digests \\
        tidehunter_tpu_torch/evals/option_digests.json

BENCH_READS takes the first N reads of the slice and of each option cell
(default all), BENCH_CHUNK sets every cell's chunk size (option cells:
the CLI's default, 512).  Each cell's stderr line ends with the host's
1-minute load average and a host probe's ms before and after it; the
host's CPU model and
logical cores are printed first.  The last line of stdout is one JSON
object: bench.py's ``metric``, ``value`` (the slice's best rep), ``unit``,
``vs_baseline`` (over 285.1 reads/s, the reference's own C stages, abPOA's
DP stubbed, on one thread of a CPU host: BASELINE.md), ``vs_t32`` (over 32
times that) and ``median``; ``periods_reads_per_s`` and
``periods_median``; ``reps`` (each rep's reads/s of slice and periods);
``records_checked`` (every cell's); ``device`` and ``power_limit``
(nvidia-smi's, null on the CPU); ``options`` ({run: {median, value, reps,
records_checked}} of the option cells run, empty without); ``host``
({cpu_model, cores, load_1m and probe_ms: {cell: [before, after]}};
probe_ms times a fixed pure-Python loop, since the card machine's host
reads its CPU model as "unknown" and its load as 0.00).  On ``--device
cpu`` the kernels' plain versions run, so its reads/s are no device
numbers.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..io.codec import decode, revcomp_str
from ..io.fastx import FastxRecord
from ..params import FASTA_FMT, FASTQ_FMT, TAB_FMT, TAB_QUAL_FMT, Params
from .synth import synth_read

DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "bench_digests.json")
DIGEST_COMMAND = ("python -m tidehunter_tpu_torch.evals.bench "
                  "--write-digests tidehunter_tpu_torch/evals/"
                  "bench_digests.json")
DIGEST_FORMAT = ("default (FASTA): sha256 of each read's records by "
                 "pipeline.core.tidehunter_core under Params(), serialized "
                 "by io.output.write_read_output; a read with no records "
                 "has the digest of the empty string")
CELLS = ("slice", "periods")
SLICE_READS = 1024
SLICE_SEED = 42
# the periods path: (name, reads, unit length, copies) of each population
PERIOD_POPULATIONS = (("short", 512, 60, 60), ("amplicon", 256, 1500, 6),
                      ("cdna", 128, 3000, 4))
PERIOD_SEED = 43
PERIOD_CHUNK = 512
DEFAULT_REPS = 5
METRIC = ("reads/s/card, synthetic ONT R2C2 4.3kb (450bp x9, 10% err), "
          "full pipeline, every record gated")
# the reference's own C stages (seeding, chaining, partition, ksw2, edlib;
# abPOA's DP stubbed) on this workload, one thread of a CPU host
# (BASELINE.md "Measured CPU baseline"); vs_t32 is over 32 times that
BASE_READS_PER_S = 285.1
TESTFQ_CHUNK = 100      # bench.py's one chunk of test.fq's 100 reads
TESTFQ_BASE_READS_PER_S = 173.6     # the same C stages on test.fq

OPTION_DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "option_digests.json")
OPTION_DIGEST_COMMAND = ("python -m tidehunter_tpu_torch.evals.bench "
                         "--write-option-digests tidehunter_tpu_torch/evals/"
                         "option_digests.json")
OPTION_DIGEST_FORMAT = ("sha256 of each read's records by pipeline.core."
                        "tidehunter_core under the Params that cli.parse_args "
                        "builds from argv (adapters loaded as runner."
                        "load_adapters does; TH_MSA=graph for --msa graph), "
                        "serialized by io.output.write_read_output in the "
                        "run's -f and -u; a read with no records has the "
                        "digest of the empty string")
# the reference's shipped adapters: the 84 bp 5' adapter (sense strand)
# and the 25 bp 3' adapter (anti-sense strand), written to the files that
# the runs' argv name 5p and 3p
FIVE = ("AATGATACGGCGACCACCGAGATCTACACTCGACTAGTCGTCGGCAGCGTCAGATGTGTATAA"
        "GAGACAGTGAATTCTGGTGGG")
THREE = "AAGCAGTGGTATCAACGCAGAGTAC"
ADAPTER_FILES = (("5p", FIVE), ("3p", THREE))
ADAPTER_SEED = 44
ADAPTER_READS = 1024
QUAL_SEED = 45          # the FASTQ population's qualities
# each option run: (name, population, reads, argv); the populations are
# "adapters" (adapter_reads, seed 44), "slice" (slice_reads) and
# "periods_fq" (periods_fastq_reads: every second periods read as gzipped
# FASTQ); a run takes its population's first `reads` reads
OPTION_RUNS = (
    ("ada_f2", "adapters", 1024, ["-5", "5p", "-3", "3p", "-f", "2"]),
    ("ada_F", "adapters", 1024, ["-5", "5p", "-3", "3p", "-F"]),
    ("ada_sF", "adapters", 1024, ["-5", "5p", "-3", "3p", "-s", "-F"]),
    ("polish1", "slice", 1024, ["--polish", "1"]),
    ("msa_graph", "slice", 1024, ["--msa", "graph"]),
    ("unit_f2", "slice", 1024, ["-u", "-f", "2"]),
    ("scoring", "slice", 512, ["-M", "3", "-X", "5", "-O", "6,30", "-E",
                               "3,1"]),
    ("seeding", "slice", 512, ["-H", "-k", "16", "-w", "5"]),
    ("ada_a", "adapters", 512, ["-5", "5p", "-3", "3p", "-a", "0.99", "-f",
                                "2"]),
    ("fq_f3_l", "periods_fq", 448, ["-f", "3", "-l"]),
    ("fq_f4_filt", "periods_fq", 448, ["-f", "4", "-c", "3", "-e", "0.2",
                                       "-p", "50", "-P", "2000", "-m",
                                       "100", "-r", "0.5"]),
)
OPTIONS = {name: (pop, n, argv) for name, pop, n, argv in OPTION_RUNS}


def slice_reads(n: int = SLICE_READS):
    """The slice's first n synth_read reads (seed 42)."""
    rng = np.random.default_rng(SLICE_SEED)
    return [FastxRecord(name=f"r2c2_{i}", comment="", seq=synth_read(rng))
            for i in range(n)]


def period_reads(n=None):
    """The periods path's first n reads (default all), in input order
    (seed 43)."""
    rng = np.random.default_rng(PERIOD_SEED)
    out = []
    for name, size, unit_len, copies in PERIOD_POPULATIONS:
        for i in range(size):
            if n is not None and len(out) >= n:
                return out
            out.append(FastxRecord(name=f"{name}_{i}", comment="",
                                   seq=synth_read(rng, unit_len, copies)))
    return out


def period_populations():
    """The periods path's populations (seed 43), one list of reads each."""
    reads, out = period_reads(), []
    for _, size, _, _ in PERIOD_POPULATIONS:
        out.append(reads[:size])
        reads = reads[size:]
    return out


def mutate(rng, u, err):
    """u (uint8 codes) at rate err split evenly over substitutions,
    deletions and insertions, drawn a whole array at a time (chip_smoke's
    generator of kernel inputs, whose draws the adapter reads keep)."""
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


def adapter_reads(rng, n):
    """R2C2 reads with adapters: each unit the 5' adapter, a 450 bp insert
    and the reverse complement of the 3' adapter, 9 copies at 10% error
    (every fourth read a single copy) between random 150 bp flanks."""
    codes = np.frombuffer(b"ACGT", np.uint8)
    lut = np.zeros(256, np.uint8)
    lut[codes] = np.arange(4, dtype=np.uint8)
    five = lut[np.frombuffer(FIVE.encode(), np.uint8)]
    three_rc = lut[np.frombuffer(revcomp_str(THREE).encode(), np.uint8)]
    out = []
    for i in range(n):
        unit = np.concatenate([five, rng.integers(0, 4, 450).astype(
            np.uint8), three_rc])
        parts = [rng.integers(0, 4, 150).astype(np.uint8)]
        parts += [mutate(rng, unit, 0.1) for _ in range(1 if i % 4 == 3
                                                        else 9)]
        parts.append(rng.integers(0, 4, 150).astype(np.uint8))
        out.append(FastxRecord(name=f"ada_{i}", comment="",
                               seq=decode(np.concatenate(parts))))
    return out


def periods_fastq_reads(n=None):
    """The first n (default all 448) of every second read of the periods
    path (256 of 60 bp units, 128 of 1500 bp, 64 of 3000 bp), each with
    phred+33 qualities 2-40 drawn from QUAL_SEED."""
    rng = np.random.default_rng(QUAL_SEED)
    reads = period_reads(None if n is None else 2 * n)[::2][:n]
    return [FastxRecord(name=r.name, comment="", seq=r.seq,
                        qual=(rng.integers(35, 74, len(r.seq)).astype(
                            np.uint8).tobytes().decode()))
            for r in reads]


def population(pop: str, n=None):
    """The first n (default all) reads of an option run's population, in
    input order."""
    if pop == "adapters":
        return adapter_reads(np.random.default_rng(ADAPTER_SEED),
                             min(n or ADAPTER_READS, ADAPTER_READS))
    if pop == "slice":
        return slice_reads(min(n or SLICE_READS, SLICE_READS))
    if pop == "periods_fq":
        return periods_fastq_reads(n)
    raise ValueError(f"unknown population {pop!r}")


def cell_reads(cell: str, n=None):
    """The first n (default all) reads of a cell or an option run, in input
    order."""
    if cell == "slice":
        return slice_reads(min(n or SLICE_READS, SLICE_READS))
    if cell == "periods":
        return period_reads(n)
    if cell in OPTIONS:
        pop, size, _ = OPTIONS[cell]
        return population(pop, min(n or size, size))
    raise ValueError(f"cell must be one of {CELLS + tuple(OPTIONS)}, got "
                     f"{cell!r}")


def fasta(reads) -> str:
    return "".join(f">{r.name}\n{r.seq}\n" for r in reads)


def fastq(reads) -> str:
    return "".join(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n" for r in reads)


def input_text(reads) -> str:
    """The input file's text: FASTQ when the reads carry qualities."""
    return fastq(reads) if reads and reads[0].qual is not None \
        else fasta(reads)


def sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def write_adapters(tmp: str) -> None:
    """The adapter files that OPTION_RUNS' argv name (5p, 3p) under tmp."""
    for name, seq in ADAPTER_FILES:
        with open(os.path.join(tmp, name), "w") as f:
            f.write(f">{name}\n{seq}\n")


def write_input(cell: str, reads, tmp: str) -> str:
    """The reads written under tmp as the cell's input: FASTA, or gzipped
    FASTQ (a fixed gzip header time) when they carry qualities, and the
    adapter files; returns the input's path."""
    write_adapters(tmp)
    text = input_text(reads)
    if reads and reads[0].qual is not None:
        path = os.path.join(tmp, f"{cell}.fq.gz")
        with open(path, "wb") as raw, gzip.GzipFile(
                fileobj=raw, mode="wb", mtime=0) as f:
            f.write(text.encode())
    else:
        path = os.path.join(tmp, f"{cell}.fa")
        with open(path, "w") as f:
            f.write(text)
    return path


def read_input(path: str) -> str:
    """A written input's text (decompressed when gzipped)."""
    with open(path, "rb") as f:
        data = f.read()
    return (gzip.decompress(data) if data[:2] == b"\x1f\x8b" else
            data).decode()


def option_argv(cell: str, tmp: str):
    """An option run's argv with its adapter files (5p, 3p) under tmp."""
    argv = list(OPTIONS[cell][2])
    for i, tok in enumerate(argv[:-1]):
        if tok in ("-5", "-3"):
            argv[i + 1] = os.path.join(tmp, argv[i + 1])
    return argv


def option_params(cell: str, tmp: str):
    """(Params, --msa) of an option run as cli.parse_args builds them,
    the adapters loaded as runner.load_adapters does (their files written
    under tmp first)."""
    from ..cli import parse_args
    from ..pipeline.runner import load_adapters

    write_adapters(tmp)
    mtp, _, extra = parse_args([*option_argv(cell, tmp), "reads.fa"])
    load_adapters(mtp)
    return mtp, extra["msa"]


# the read a FASTA/FASTQ header's first token names: a consensus
# record's {read}_rep{c}_{copy number}, a unit's {read}_rep{c}_sub{i}
_CONS_NAME = re.compile(r"^(.+)_rep\d+(?:_\d+\.\d)?$")
_UNIT_NAME = re.compile(r"^(.+)_rep\d+_sub\d+$")


def records_by_read(text: str, fmt: int = FASTA_FMT,
                    only_unit: bool = False) -> dict:
    """Records grouped by read name, as io.output writes them under -f fmt
    and -u (only_unit): FASTA (fmt 1, the default) or FASTQ (3) records,
    whose header names {read}_rep{c}_{copies} or, under -u,
    {read}_rep{c}_sub{i}; or one tabular line each (2, 4; -u's too), the
    read's name its first field.  A FASTA or FASTQ record of another form
    raises GateError."""
    out = {}
    lines = text.splitlines(keepends=True)
    if fmt in (TAB_FMT, TAB_QUAL_FMT):
        for line in lines:
            name = line.split("\t", 1)[0]
            out[name] = out.get(name, "") + line
        return out
    step = 4 if fmt == FASTQ_FMT else 2
    mark = "@" if fmt == FASTQ_FMT else ">"
    pattern = _UNIT_NAME if only_unit else _CONS_NAME
    for i in range(0, len(lines), step):
        rec = lines[i:i + step]
        m = pattern.match(rec[0][1:].split(None, 1)[0]
                          if rec[0][1:].strip() else "")
        if (len(rec) != step or not rec[0].startswith(mark) or m is None
                or (step == 4 and rec[2] != "+\n")):
            raise GateError(f"-f {fmt}{' -u' if only_unit else ''}: not a "
                            f"record: {''.join(rec)[:80]!r}")
        out[m.group(1)] = out.get(m.group(1), "") + "".join(rec)
    return out


def load_digests(path: str = DIGESTS) -> dict:
    with open(path) as f:
        return json.load(f)


class GateError(AssertionError):
    """A record, an input or a rep differs from what the gate holds it to."""


def check_input(cell: str, reads, digests: dict, text=None) -> None:
    """The cell's whole input (text: the input file's, decompressed;
    default the reads' FASTA or FASTQ) against the file's reads_sha256,
    and an option run's argv against the file's."""
    entry = digests["cells"][cell]
    text = input_text(reads) if text is None else text
    got, want = sha256(text), entry["reads_sha256"]
    if got != want:
        kind = "FASTQ" if text.startswith("@") else "FASTA"
        raise GateError(f"{cell}: input {kind} sha256 {got} differs from the "
                        f"digest file's {want}")
    if cell in OPTIONS and entry.get("argv") != OPTIONS[cell][2]:
        raise GateError(f"{cell}: argv {OPTIONS[cell][2]} differs from the "
                        f"digest file's {entry.get('argv')}")


def check_records(cell: str, reads, text: str, digests: dict,
                  out_fmt: int = FASTA_FMT, only_unit: bool = False) -> int:
    """Every read's records in a run's output text, split as the run's -f
    (out_fmt) and -u (only_unit) wrote them, against the oracle's digests
    (the first len(reads) of the cell's, in read order); raises on a
    difference, a read past the file's or a record of no read, else
    returns the number of reads checked."""
    want = digests["cells"][cell]["digests"]
    if len(reads) > len(want):
        raise GateError(f"{cell}: {len(reads)} reads, the digest file holds "
                        f"{len(want)}")
    got = records_by_read(text, out_fmt, only_unit)
    stray = set(got) - {r.name for r in reads}
    if stray:
        raise GateError(f"{cell}: records of no input read: "
                        f"{sorted(stray)[:8]}")
    bad = [r.name for r, w in zip(reads, want)
           if sha256(got.get(r.name, "")) != w]
    if bad:
        raise GateError(f"{cell}: {len(bad)} reads' records differ from the "
                        f"oracle's digests: {bad[:8]}")
    return len(reads)


def check_reps(cell: str, texts) -> None:
    """The warm run (texts[0]) and every rep byte for byte against the
    first timed rep (texts[1])."""
    for i, text in enumerate(texts):
        if text != texts[1]:
            what = "warm run" if i == 0 else f"rep {i - 1}"
            raise GateError(f"{cell}: the {what}'s output differs from the "
                            f"first timed rep's")


def power_limit(device: str):
    """nvidia-smi's power limit of the first card, None on the CPU."""
    if device != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def stage_lines(label: str, rep_snaps, snap) -> None:
    """bench.py's stage and kernel lines on stderr: the stage timers of
    all reps and of each, then the kernels' Gcell/s."""
    keys = [k for k in sorted(snap) if k.startswith("time_")]
    if keys:
        print(f"# {label} stages (steady, all reps): " + " ".join(
            f"{k[5:-2]}={snap[k]:.2f}s" for k in keys), file=sys.stderr)
        for i, rs in enumerate(rep_snaps):
            print(f"# {label} rep{i}: " + " ".join(
                f"{k[5:-2]}={rs.get(k, 0.0):.2f}s" for k in keys),
                file=sys.stderr)
    wf_t = snap.get("time_dev_global_s", 0) + snap.get("time_dev_ext_s", 0)
    msa_t = snap.get("time_dev_msa_s", 0)
    lines = []
    if wf_t and snap.get("wf_cells"):
        lines.append(f"wavefront {snap['wf_cells'] / wf_t / 1e9:.2f} Gcell/s"
                     f" useful ({snap.get('wf_cells_disp', 0) / wf_t / 1e9:.2f}"
                     f" dispatched)")
    if msa_t and snap.get("msa_cells"):
        lines.append(f"msa {snap['msa_cells'] / msa_t / 1e9:.2f} Gcell/s")
    if snap.get("rounds"):
        lines.append(f"rounds={snap['rounds']:g}")
    if lines:
        print(f"# {label} kernels: " + "; ".join(lines), file=sys.stderr)


def timed_runs(path: str, mtp, engine, reps: int, sync):
    """One warm run, then reps timed runs of the runner over path: (the
    outputs, warm run's first, the reps' walls in s, the reps' stage
    timers, the stage timers of all reps, the reads of a run)."""
    from ..pipeline import runner
    from ..utils.metrics import METRICS

    warm = io.StringIO()
    n_reads = runner.run(path, mtp, out=warm, process_chunk=engine).reads
    sync()
    METRICS.reset()
    texts, dts, rep_snaps = [warm.getvalue()], [], []
    prev = METRICS.snapshot()
    for _ in range(reps):
        sink = io.StringIO()
        t0 = time.perf_counter()
        runner.run(path, mtp, out=sink, process_chunk=engine)
        sync()
        dts.append(time.perf_counter() - t0)
        texts.append(sink.getvalue())
        cur = METRICS.snapshot()
        rep_snaps.append({k: cur.get(k, 0.0) - prev.get(k, 0.0)
                          for k in cur if k.startswith("time_")})
        prev = cur
    return texts, dts, rep_snaps, METRICS.snapshot(), n_reads


def run_cell(cell: str, engine, reps: int, digests: dict, sync, tmp: str,
             n_reads, chunk: int, device: str = "cpu"):
    """A cell's warm run and timed reps, every record gated: (reads/s of
    each rep, reads checked).  engine: the default engine for slice and
    periods; an option run builds its own from its Params, as the CLI
    does (make_engine; --msa graph sets TH_MSA for the runs)."""
    from ..engine import make_engine

    reads = cell_reads(cell)
    path = write_input(cell, reads, tmp)
    check_input(cell, reads, digests, read_input(path))
    if n_reads is not None and n_reads < len(reads):
        reads = reads[:n_reads]
        path = write_input(cell, reads, tmp)
    split, own, th_msa = {}, None, os.environ.get("TH_MSA")
    if cell in OPTIONS:
        mtp, msa = option_params(cell, tmp)
        split = {"out_fmt": mtp.out_fmt, "only_unit": mtp.only_unit}
        engine = own = make_engine(mtp, device, msa_mode="poa" if msa ==
                                   "graph" else "profile")
        if msa == "graph":
            os.environ["TH_MSA"] = "graph"
    else:
        mtp = Params()
    mtp.chunk_read_n = chunk or mtp.chunk_read_n
    try:
        texts, dts, rep_snaps, snap, _ = timed_runs(path, mtp, engine, reps,
                                                    sync)
    finally:
        if own is not None:
            own.close()
            if th_msa is None:
                os.environ.pop("TH_MSA", None)
            else:
                os.environ["TH_MSA"] = th_msa
    n = check_records(cell, reads, texts[1], digests, **split)
    check_reps(cell, texts)
    rps = [len(reads) / d for d in dts]
    print(f"# {cell}: {len(reads)} reads, chunks of {mtp.chunk_read_n}; "
          "reps " + " ".join(f"{x:.1f}" for x in rps) + " reads/s; every "
          f"read's records ({texts[1].count(chr(10))} lines) match the "
          f"oracle's digests; warm run and reps byte-identical",
          file=sys.stderr)
    stage_lines(cell, rep_snaps, snap)
    return rps, n


def host_info() -> dict:
    """The host's CPU model (/proc/cpuinfo's model name, None where it has
    none) and logical core count."""
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return {"cpu_model": model, "cores": os.cpu_count()}


def load_1m() -> float:
    """The host's 1-minute load average."""
    return os.getloadavg()[0]


PROBE_STEPS = 1_000_000


def host_probe_ms() -> float:
    """ms of a fixed pure-Python loop: the host's speed at the kind of work
    that bounds every path (the drive, the partition walks), where the
    host hides its CPU model and load (the card machine reads "unknown"
    and 0.00)."""
    t0 = time.perf_counter()
    x = 0
    for i in range(PROBE_STEPS):
        x ^= i * 7
    return (time.perf_counter() - t0) * 1e3


def run_fastq(path: str, engine, reps: int, sync):
    """bench.py's test.fq axis, ungated (no digests): reads/s of each rep,
    or None when the file is absent."""
    if not os.path.exists(path):
        print(f"# {path}: absent, the test.fq axis skipped", file=sys.stderr)
        return None
    mtp = Params()
    mtp.chunk_read_n = TESTFQ_CHUNK
    _, dts, _, _, n_reads = timed_runs(path, mtp, engine, reps, sync)
    rps = [n_reads / d for d in dts]
    print(f"# {path} reps: {' '.join(f'{x:.1f}' for x in rps)} reads/s "
          f"(C reference 1-thread: {TESTFQ_BASE_READS_PER_S})",
          file=sys.stderr)
    return rps


def median(xs):
    return sorted(xs)[len(xs) // 2]


def _oracle_digest(task):
    """(cell, i, read, Params, graph MSA) -> (cell, i, the read's digest by
    tidehunter_core); graph sets TH_MSA=graph, as --msa graph does."""
    from ..pipeline.core import tidehunter_core
    from .accuracy import record_digest

    cell, i, rec, mtp, graph = task
    if graph:
        os.environ["TH_MSA"] = "graph"
    else:
        os.environ.pop("TH_MSA", None)
    return cell, i, record_digest(rec, tidehunter_core(rec.seq, mtp), mtp)


def _oracle_pool(tasks) -> dict:
    """{(cell, i): digest} of each _oracle_digest task, over a pool of
    spawn processes (the cores less one), longest read first."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    order = sorted(tasks, key=lambda t: -len(t[2].seq))
    workers = max(1, (os.cpu_count() or 2) - 1)
    got = {}
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        for k, (cell, i, d) in enumerate(pool.map(_oracle_digest, order)):
            got[(cell, i)] = d
            if (k + 1) % 128 == 0:
                print(f"{k + 1}/{len(order)} reads in "
                      f"{time.perf_counter() - t0:.0f} s", flush=True)
    print(f"digests of {len(tasks)} reads in {time.perf_counter() - t0:.1f} "
          f"s over {workers} processes", flush=True)
    return got


def _dump(out: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"-> {path}", flush=True)


def write_digests(path: str, cells=CELLS) -> dict:
    """The host oracle's digest of every read of each cell under Params(),
    written to path as JSON."""
    reads = {cell: cell_reads(cell) for cell in cells}
    got = _oracle_pool([(cell, i, r, Params(), False) for cell in cells
                        for i, r in enumerate(reads[cell])])
    out = {"cells": {cell: {
        "command": DIGEST_COMMAND, "format": DIGEST_FORMAT,
        "reads": len(reads[cell]),
        "reads_sha256": sha256(fasta(reads[cell])),
        "digests": [got[(cell, i)] for i in range(len(reads[cell]))]}
        for cell in cells}}
    _dump(out, path)
    return out


def write_option_digests(path: str, runs=tuple(OPTIONS)) -> dict:
    """The host oracle's digest of every read of each option run under its
    Params (option_params), written to path as JSON."""
    reads = {run: cell_reads(run) for run in runs}
    tasks = []
    with tempfile.TemporaryDirectory() as tmp:
        for run in runs:
            mtp, msa = option_params(run, tmp)
            tasks += [(run, i, r, mtp, msa == "graph")
                      for i, r in enumerate(reads[run])]
        got = _oracle_pool(tasks)
    out = {"cells": {run: {
        "command": OPTION_DIGEST_COMMAND, "format": OPTION_DIGEST_FORMAT,
        "argv": OPTIONS[run][2],
        "population": f"{OPTIONS[run][0]}, first {OPTIONS[run][1]}",
        "reads": len(reads[run]),
        "reads_sha256": sha256(input_text(reads[run])),
        "digests": [got[(run, i)] for i in range(len(reads[run]))]}
        for run in runs}}
    _dump(out, path)
    return out


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated cells to run: slice, periods and "
                         "the option runs " + ", ".join(OPTIONS))
    ap.add_argument("--fastq", default="test.fq",
                    help="bench.py's test.fq axis (ungated); skipped when "
                         "the file is absent")
    ap.add_argument("--digests", default=DIGESTS,
                    help="the oracle's digests the records are held to")
    ap.add_argument("--option-digests", default=OPTION_DIGESTS,
                    help="the oracle's digests the option runs' records are "
                         "held to")
    ap.add_argument("--write-digests", metavar="PATH",
                    help="write the host oracle's digests of every read of "
                         "both cells to PATH and exit")
    ap.add_argument("--write-option-digests", metavar="PATH",
                    help="write the host oracle's digests of every read of "
                         "every option run to PATH and exit")
    args = ap.parse_args(argv)
    args.cells = [c for c in args.cells.split(",") if c]
    bad = set(args.cells) - set(CELLS) - set(OPTIONS)
    if bad:
        ap.error(f"unknown cells {sorted(bad)}; choose from "
                 f"{CELLS + tuple(OPTIONS)}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.write_digests:
        write_digests(args.write_digests)
        return 0
    if args.write_option_digests:
        write_option_digests(args.write_option_digests)
        return 0
    import torch

    from ..engine import make_engine

    if args.device == "cuda" and not torch.cuda.is_available():
        # bench.py's probe_device: no card, no numbers
        print("bench: no CUDA device (torch.cuda.is_available() is False); "
              "--device cpu runs the kernels' plain versions",
              file=sys.stderr)
        return 2

    n_reads = int(os.environ.get("BENCH_READS", str(SLICE_READS)))
    chunk = int(os.environ.get("BENCH_CHUNK", "0"))
    reps = max(1, int(os.environ.get("BENCH_REPS", str(DEFAULT_REPS))))
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    digests = load_digests(args.digests)
    if any(cell in OPTIONS for cell in args.cells):
        digests = {"cells": {**digests["cells"], **load_digests(
            args.option_digests)["cells"]}}
    host = host_info()
    host["load_1m"], host["probe_ms"] = {}, {}
    print(f"# host: {host['cpu_model']}, {host['cores']} logical cores",
          file=sys.stderr)
    engine = make_engine(Params(), args.device)
    rps, checked = {}, 0
    # the runner overlaps a host prepare thread with the device-drive
    # thread: a drive thread woken from a device wait can stall a whole GIL
    # switch interval (default 5 ms) behind the prepare thread
    switch = sys.getswitchinterval()
    sys.setswitchinterval(0.001)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for cell in args.cells:
                n = None if cell == "periods" else n_reads
                c = chunk or (max(64, n_reads // 2) if cell == "slice"
                              else PERIOD_CHUNK if cell == "periods" else 0)
                before = load_1m(), host_probe_ms()
                rps[cell], k = run_cell(cell, engine, reps, digests, sync,
                                        tmp, n, c, args.device)
                after = load_1m(), host_probe_ms()
                host["load_1m"][cell] = [before[0], after[0]]
                host["probe_ms"][cell] = [before[1], after[1]]
                print(f"# {cell} host load (1 min) before {before[0]:.2f}, "
                      f"after {after[0]:.2f}; host probe {before[1]:.2f} / "
                      f"{after[1]:.2f} ms", file=sys.stderr)
                checked += k
        fq_rps = run_fastq(args.fastq, engine, reps, sync)
    except GateError as e:
        print(f"bench: gate failed: {e}", file=sys.stderr)
        return 1
    finally:
        sys.setswitchinterval(switch)
        engine.close()

    best = max(rps["slice"]) if "slice" in rps else None
    out = {"metric": METRIC, "value": best, "unit": "reads/s",
           "vs_baseline": best / BASE_READS_PER_S if best else None,
           "vs_t32": best / (32 * BASE_READS_PER_S) if best else None,
           "median": median(rps["slice"]) if "slice" in rps else None,
           "periods_reads_per_s": max(rps["periods"]) if "periods" in rps
           else None,
           "periods_median": median(rps["periods"]) if "periods" in rps
           else None,
           "reps": {c: r for c, r in rps.items() if c in CELLS},
           "records_checked": checked,
           "device": (torch.cuda.get_device_name(0)
                      if args.device == "cuda" else "cpu"),
           "power_limit": power_limit(args.device),
           "options": {c: {"median": median(r), "value": max(r), "reps": r,
                           "records_checked": min(n_reads, OPTIONS[c][1])}
                       for c, r in rps.items() if c in OPTIONS},
           "host": host}
    if fq_rps:
        out["testfq_reads_per_s"] = max(fq_rps)
        out["testfq_vs_t1"] = max(fq_rps) / TESTFQ_BASE_READS_PER_S
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
