"""Command line of the PyTorch port.

    python -m tidehunter_tpu_torch.cli [reference flags] [--device D] in.fa

Takes the reference flags (the JAX package's parser, copied) plus
``--device cuda|cpu|off`` (default cuda): ``cuda`` runs the hand-written
kernels, ``cpu`` their plain PyTorch versions, ``off`` the sequential host
oracle.  The JAX CLI's own options run as there: ``--polish``, ``--msa
graph`` (the host graph-POA for the consensus MSA, every other stage on
the device), ``--metrics FILE`` (or ``TH_METRICS``), ``--profile PATH`` (a
torch.profiler Chrome/Perfetto trace of the run), ``--shard`` and
``--resume``.  ``--dist`` is not supported by the port and, like a device
that cannot be used, ends the run with an error; nothing falls back to the
host.  Device seeding and chaining are selected, as in the JAX CLI, by
the environment alone: ``TH_DEVICE_SEED=1``, ``TH_DEVICE_CHAIN=1`` and
``TH_OFFLOAD_V1=1`` (see ``--help``).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import List, Optional

from .api import DEVICES
from .params import (
    ADA_MATCH_RAT,
    DEF_MAX_PERIOD_STR,
    DEF_MIN_COV,
    DEF_MIN_LEN,
    DEF_MIN_PERIOD,
    FASTA_FMT,
    FASTQ_FMT,
    KMER_SIZE,
    KMER_WSIZE,
    MATCH,
    MAX_DIV,
    MAX_KMER_SIZE,
    MAX_PERIOD,
    MIN_COPY,
    MIN_PERIOD,
    MISMATCH,
    GAP_EXT1,
    GAP_EXT2,
    GAP_OPEN1,
    GAP_OPEN2,
    TAB_FMT,
    TAB_QUAL_FMT,
    THREAD_N,
    Params,
    parse_num,
)
from .pipeline import runner
from .utils.log import log, resource_line
from .utils.metrics import METRICS
from .version import PROG, REFERENCE_VERSION, __version__


def usage() -> int:
    e = sys.stderr.write
    e("\n")
    e(f"{PROG}: Tandem repeats detection and consensus calling from noisy long reads\n\n")
    e(f"Version: {__version__} (CLI-compatible with TideHunter {REFERENCE_VERSION})\n\n")
    e(f"Usage:   tidehunter-tpu [options] in.fa/fq > cons.fa\n\n")
    e("Options: \n")
    e("  Seeding:\n")
    e(f"    -k --kmer-length INT    k-mer length (no larger than {MAX_KMER_SIZE}) [{KMER_SIZE}]\n")
    e(f"    -w --window-size INT    window size, set as >1 to enable minimizer seeding [{KMER_WSIZE}]\n")
    e("    -H --HPC-kmer           use homopolymer-compressed k-mer [False]\n")
    e("  Tandem repeat criteria:\n")
    e(f"    -c --min-copy    INT    minimum copy number of tandem repeat (>={MIN_COPY}) [{MIN_COPY}]\n")
    e(f"    -e --max-diverg  INT    maximum allowed divergence rate between two consecutive repeats [{MAX_DIV:.2f}]\n")
    e(f"    -p --min-period  INT    minimum period size of tandem repeat (>={MIN_PERIOD}) [{DEF_MIN_PERIOD}]\n")
    e(f"    -P --max-period  INT    maximum period size of tandem repeat (<={MAX_PERIOD}) [{DEF_MAX_PERIOD_STR}]\n")
    e("  Scoring parameters for partial order alignment:\n")
    e(f"    -M --match    INT       match score [{MATCH}]\n")
    e(f"    -X --mismatch INT       mismatch penalty [{MISMATCH}]\n")
    e(f"    -O --gap-open INT(,INT) gap opening penalty (O1,O2) [{GAP_OPEN1},{GAP_OPEN2}]\n")
    e(f"    -E --gap-ext  INT(,INT) gap extension penalty (E1,E2) [{GAP_EXT1},{GAP_EXT2}]\n")
    e("                            convex (default): min{O1+g*E1, O2+g*E2}; affine: O2=0; linear: O1=0\n")
    e("  Adapter sequence:\n")
    e("    -5 --five-prime  STR    5' adapter sequence (sense strand) [NULL]\n")
    e("    -3 --three-prime STR    3' adapter sequence (anti-sense strand) [NULL]\n")
    e(f"    -a --ada-mat-rat FLT    minimum match ratio of adapter sequence [{ADA_MATCH_RAT:.2f}]\n")
    e("  Output:\n")
    e("    -o --output      STR    output file [stdout]\n")
    e(f"    -m --min-len     INT    only output consensus sequence with min. length of [{DEF_MIN_LEN}]\n")
    e(f"    -r --min-cov  FLOAT|INT only output consensus sequence with at least R supporting units [{DEF_MIN_COV:.2f}]\n")
    e("    -u --unit-seq           only output unit sequences of each tandem repeat [False]\n")
    e("    -l --longest            only output consensus of the TR covering the longest read span [False]\n")
    e("    -F --full-len           only output full-length consensus sequence [False]\n")
    e("    -s --single-copy        output additional single-copy full-length consensus sequence [False]\n")
    e(f"    -f --out-fmt     INT    output format [{FASTA_FMT}]: 1 FASTA, 2 Tabular, 3 FASTQ, 4 Tabular+qual\n")
    e("  Computing resource:\n")
    e(f"    -t --thread      INT    number of host worker threads [{THREAD_N}]\n")
    e("  PyTorch port (no reference equivalent):\n")
    e("    --device STR            kernel dispatch: cuda | cpu | off [cuda]\n")
    e("    --resume STR            progress-cursor file for checkpoint/restart [off]\n")
    e("    --shard I/N             process reads I, I+N, I+2N, ... [0/1]\n")
    e("    --metrics STR           write structured run metrics JSON to file [off]\n")
    e("    --profile STR           write a torch.profiler trace (Chrome/Perfetto\n")
    e("                            JSON) of the run to this file [off]\n")
    e("    --polish INT            consensus refinement rounds (realign units to the\n")
    e("                            final profile; improves low-coverage accuracy) [0]\n")
    e("    --msa STR               consensus model: profile (batched device\n")
    e("                            profile-POA) | graph (host graph-POA, the\n")
    e("                            abPOA-faithful model, native C) [profile]\n")
    e("    not supported by the port: --dist\n")
    e("  Environment (no reference equivalent; default: seed and chain on the host):\n")
    e("    TH_DEVICE_SEED=1        seed on the device (seed_hits kernel)\n")
    e("    TH_DEVICE_CHAIN=1       with TH_DEVICE_SEED=1, chain there too (chain_dp)\n")
    e("    TH_OFFLOAD_V1=1         the unpacked seeding route even where the packed\n")
    e("                            one fits (it always serves k > 8-ish, long reads)\n")
    e("  General options:\n")
    e("    -h --help               print this help usage information\n")
    e("    -v --version            show version number\n")
    e("\n")
    return 1


_LONG = {
    "--kmer-length": "k", "--window-size": "w", "--HPC-kmer": "H",
    "--min-copy": "c", "--max-diverg": "e", "--min-period": "p",
    "--max-period": "P", "--match": "M", "--mismatch": "X",
    "--gap_open": "O", "--gap-open": "O", "--gap_ext": "E", "--gap-ext": "E",
    "--five-prime": "5", "--three-prime": "3", "--ada-match-rat": "a",
    "--output": "o", "--min-len": "m", "--min-cov": "r", "--unit-seq": "u",
    "--longest": "l", "--full-len": "F", "--out-fmt": "f",
    "--thread": "t", "--help": "h", "--version": "v",
}
_NO_ARG = set("Hhvulsq") | {"F"}


def _parse_dist(val: str):
    """HOST:PORT/N/I -> (coordinator, num_procs, proc_id), None on error."""
    try:
        coord, n_s, i_s = val.rsplit("/", 2)
        n, i = int(n_s), int(i_s)
    except ValueError:
        sys.stderr.write(
            f"\n[main] Error: --dist needs HOST:PORT/N/I "
            f"(e.g. 10.0.0.1:8476/4/0), got '{val}'.\n")
        return None
    if not coord or not (0 <= i < n):
        sys.stderr.write("\n[main] Error: --dist needs 0 <= I < N and a "
                         "coordinator address.\n")
        return None
    return coord, n, i


def parse_args(argv: List[str]):
    """getopt-style parse. Returns (params, input_path, extra) or an int exit
    code. Mirrors main.c:443-529 including validation messages."""
    mtp = Params()
    extra = {"device": "cuda", "resume": None, "output": None,
             "metrics": None, "shard": None, "profile": None,
             "dist": None, "msa": "profile"}
    pos: List[str] = []
    i = 0
    n = len(argv)

    def need_arg(flag: str) -> Optional[str]:
        nonlocal i
        i += 1
        if i >= n:
            sys.stderr.write(f"Error: option {flag} requires an argument.\n")
            return None
        return argv[i]

    while i < n:
        tok = argv[i]
        if tok == "--device":
            val = need_arg(tok)
            if val is None:
                return 1
            extra["device"] = val
        elif tok == "--resume":
            val = need_arg(tok)
            if val is None:
                return 1
            extra["resume"] = val
        elif tok == "--metrics":
            val = need_arg(tok)
            if val is None:
                return 1
            extra["metrics"] = val
        elif tok == "--profile":
            val = need_arg(tok)
            if val is None:
                return 1
            extra["profile"] = val
        elif tok == "--polish":
            val = need_arg(tok)
            if val is None:
                return 1
            try:
                mtp.polish = int(val)
            except ValueError:
                sys.stderr.write(
                    f"\n[main] Error: --polish needs an integer, got '{val}'.\n"
                )
                return 1
        elif tok == "--msa":
            val = need_arg(tok)
            if val is None:
                return 1
            if val not in ("profile", "graph"):
                sys.stderr.write(
                    f"\n[main] Error: --msa needs profile|graph, got '{val}'.\n"
                )
                return 1
            extra["msa"] = val
        elif tok == "--shard":
            val = need_arg(tok)
            if val is None:
                return 1
            try:
                si, sn = val.split("/")
                extra["shard"] = (int(si), int(sn))
            except ValueError:
                sys.stderr.write(
                    f"\n[main] Error: --shard needs I/N (e.g. 0/4), got '{val}'.\n"
                )
                return 1
            if not (0 <= extra["shard"][0] < extra["shard"][1]):
                sys.stderr.write("\n[main] Error: --shard needs 0 <= I < N.\n")
                return 1
        elif tok == "--dist":
            val = need_arg(tok)
            if val is None:
                return 1
            extra["dist"] = _parse_dist(val)
            if extra["dist"] is None:
                return 1
        elif tok.startswith("--"):
            key = tok.split("=", 1)[0]
            c = _LONG.get(key)
            if c is None:
                return 1
            if "=" in tok:
                val = tok.split("=", 1)[1]
            elif c not in _NO_ARG:
                val = need_arg(tok)
                if val is None:
                    return 1
            else:
                val = ""
            code = _apply_opt(mtp, extra, c, val)
            if code is not None:
                return code
        elif tok.startswith("-") and len(tok) > 1:
            c = tok[1]
            if c in _NO_ARG and len(tok) == 2:
                code = _apply_opt(mtp, extra, c, "")
                if code is not None:
                    return code
            else:
                val = tok[2:] if len(tok) > 2 else need_arg(tok)
                if val is None:
                    return 1
                code = _apply_opt(mtp, extra, c, val)
                if code is not None:
                    return code
        else:
            pos.append(tok)
        i += 1

    # post-parse validation (main.c:513-529)
    if mtp.only_unit and mtp.out_fmt in (FASTQ_FMT, TAB_QUAL_FMT):
        sys.stderr.write(
            "\n[main] Error: unit sequences can only be ouput in FASTA or TAB format.\n"
        )
        usage()
        return 1
    if not pos:
        sys.stderr.write("\n[main] Error: please specify an input file.\n")
        usage()
        return 1
    if mtp.only_full_length and (mtp.five_fn is None or mtp.three_fn is None):
        sys.stderr.write(
            "\n[main] Error: 5' and 3' adapter sequence need to be provided.\n"
        )
        usage()
        return 1
    if mtp.five_fn is None and mtp.three_fn is not None:
        sys.stderr.write(
            "\n[main] Warning: only 3' adapter sequence is provided. "
            "Full-length sequence cannot be determined.\n"
        )
    if mtp.five_fn is not None and mtp.three_fn is None:
        sys.stderr.write(
            "\n[main] Warning: only 5' adapter sequence is provided. "
            "Full-length sequence cannot be determined.\n"
        )
    return mtp, pos[0], extra


def _apply_opt(mtp: Params, extra: dict, c: str, val: str) -> Optional[int]:
    if c == "h":
        return usage()
    if c == "v":
        print(__version__)
        return 0
    if c == "k":
        mtp.k = int(val)
        if mtp.k > MAX_KMER_SIZE:
            sys.stderr.write(
                f"\n[main] Error: k-mer length can not be larger than {MAX_KMER_SIZE} ({mtp.k}).\n"
            )
            return 1
    elif c == "w":
        mtp.w = int(val)
    elif c == "H":
        mtp.hpc = True
    elif c == "c":
        mtp.min_copy = int(val)
        if mtp.min_copy < MIN_COPY:
            sys.stderr.write(
                f"Error: -c --min-copy needs to be >= {MIN_COPY}. ({mtp.min_copy})\n"
            )
            return 1
    elif c == "e":
        mtp.max_div = float(val)
    elif c == "p":
        mtp.min_p = parse_num(val)
        if mtp.min_p < MIN_PERIOD:
            sys.stderr.write(
                f"Error: -p --min-period needs to be >= {MIN_PERIOD}. ({mtp.min_p})\n"
            )
            return 1
    elif c == "P":
        mtp.max_p = parse_num(val)
        if mtp.max_p > MAX_PERIOD:
            sys.stderr.write(
                f"Error: -P --max-period needs to be <= {MAX_PERIOD}. ({mtp.max_p})\n"
            )
            return 1
    elif c == "M":
        mtp.match = int(val)
    elif c == "X":
        mtp.mismatch = int(val)
    elif c == "O":
        parts = val.split(",")
        mtp.gap_open1 = int(parts[0])
        if len(parts) > 1:
            mtp.gap_open2 = int(parts[1])
    elif c == "E":
        parts = val.split(",")
        mtp.gap_ext1 = int(parts[0])
        if len(parts) > 1:
            mtp.gap_ext2 = int(parts[1])
    elif c == "5":
        mtp.five_fn = val
    elif c == "3":
        mtp.three_fn = val
    elif c == "a":
        mtp.ada_match_rat = float(val)
    elif c == "o":
        extra["output"] = val
    elif c == "m":
        mtp.min_len = int(val)
    elif c == "r":
        x = float(val)
        if x < 1.0:
            mtp.min_frac, mtp.min_cov = x, 0
        else:
            mtp.min_cov, mtp.min_frac = int(x + 0.499), 0.0
    elif c == "u":
        mtp.only_unit = True
    elif c == "l":
        mtp.only_longest = True
    elif c == "F":
        mtp.only_full_length = True
    elif c == "s":
        mtp.single_copy = True
    elif c == "f":
        mtp.out_fmt = int(val)
        if mtp.out_fmt not in (FASTA_FMT, TAB_FMT, FASTQ_FMT, TAB_QUAL_FMT):
            sys.stderr.write("\n[main] Error: unknown format number. (-f)\n")
            return 1
    elif c == "t":
        mtp.n_thread = int(val)
    else:
        return 1
    return None


def _set_env(name: str, value: Optional[str]) -> None:
    """os.environ[name] = value; None unsets it."""
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def _error(msg: str) -> int:
    sys.stderr.write(f"\n[main] Error: {msg}\n")
    return 1


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    parsed = parse_args(argv)
    if isinstance(parsed, int):
        return parsed
    mtp, read_fn, extra = parsed
    device = extra["device"]
    if device not in DEVICES:
        return _error(f"--device needs one of {'|'.join(DEVICES)}, "
                      f"got '{device}'.")
    if extra["dist"]:
        return _error("not supported by the PyTorch port: --dist")
    metrics_fn = extra["metrics"] or os.environ.get("TH_METRICS")
    if metrics_fn:
        METRICS.reset()      # the file holds this run's counters only

    engine = None
    if device != "off":
        from .engine import Engine

        try:
            engine = Engine(mtp, device=device,
                            msa_mode="poa" if extra["msa"] == "graph"
                            else "profile")
        except RuntimeError as exc:
            return _error(str(exc))
        log(f"engine ready (device={device})")

    # the pipelined runner overlaps a host prepare thread with the drive
    # thread; a shorter switch interval keeps the drive thread responsive
    sys.setswitchinterval(0.001)
    out = open(extra["output"], "w") if extra["output"] else None
    mtp.cons_out = out
    prof = None
    try:
        with contextlib.ExitStack() as stack:
            if extra["msa"] == "graph":
                # the host oracle's graph-POA switch (pipeline/consensus.py
                # _msa_oracle), set for this run only
                stack.callback(_set_env, "TH_MSA", os.environ.get("TH_MSA"))
                os.environ["TH_MSA"] = "graph"
            if extra["profile"]:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if device == "cuda" else [])
                prof = stack.enter_context(profile(activities=acts))
                log(f"profiler trace -> {extra['profile']}")
            metrics = runner.run(read_fn, mtp, out=out,
                                 resume_cursor=extra["resume"],
                                 process_chunk=engine, shard=extra["shard"])
    except FileNotFoundError as exc:
        return _error(f"can not open file {exc.filename}")
    finally:
        if out is not None:
            out.close()
        if engine is not None:
            engine.close()
    if prof is not None:
        prof.export_chrome_trace(extra["profile"])
    log(resource_line(), func="main")
    log(f"reads: {metrics.reads}; consensus records: {metrics.cons_records}; "
        f"reads/s: {metrics.reads_per_s():.2f}", func="main")
    snap = METRICS.snapshot()
    if snap:
        log(METRICS.summary_line(), func="metrics")
    if metrics_fn:
        snap.update(reads=metrics.reads, chunks=metrics.chunks,
                    cons_records=metrics.cons_records,
                    wall_s=round(metrics.wall_s, 3),
                    reads_per_s=round(metrics.reads_per_s(), 3))
        with open(metrics_fn, "w") as f:
            json.dump(snap, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
