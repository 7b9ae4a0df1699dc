"""Merge per-shard TideHunter outputs back into input-read order.

Multi-host runs shard reads round-robin (`--shard I/N`: host I processes
reads I, I+N, ...), so each shard's output preserves input order only
within its own subset.  This tool restores the global input order — the
reference's per-chunk ordering guarantee (reference src/main.c:402-424) —
by walking the ORIGINAL input's read names and emitting each read's
records from whichever shard holds them.  Reads with zero records are
naturally skipped (they appear in no shard).

Usage:
  python -m tidehunter_tpu_torch.tools.merge -i reads.fq -f 1 \\
      out.shard0-of-2 out.shard1-of-2 > merged.out

-f uses the CLI's format numbers (1 FASTA, 2 TAB, 3 FASTQ, 4 TAB+qual;
unit mode's outputs are the same record shapes).
"""

from __future__ import annotations

import re
import sys
from typing import Dict, Iterator, List, Tuple

from ..io.fastx import read_fastx

_REP = re.compile(r"^(.*)_(?:rep|readLen)\d")


def _record_name(first_line: str, fmt: int) -> str:
    if fmt in (2, 4):
        return first_line.split("\t", 1)[0]
    token = first_line[1:].split(None, 1)[0]
    m = _REP.match(token)
    return m.group(1) if m else token


def _records(path: str, fmt: int) -> Iterator[Tuple[str, List[str]]]:
    """Yield (read_name, record_lines) per consensus/unit record."""
    with open(path) as fh:
        if fmt in (2, 4):
            for line in fh:
                if line.strip():
                    yield _record_name(line, fmt), [line]
            return
        nlines = 4 if fmt == 3 else 2
        buf: List[str] = []
        for line in fh:
            buf.append(line)
            if len(buf) == nlines:
                yield _record_name(buf[0], fmt), buf
                buf = []
        if buf:
            raise ValueError(f"{path}: truncated record at EOF")


def merge(input_fn: str, shard_fns: List[str], fmt: int, out) -> int:
    by_name: Dict[str, List[List[str]]] = {}
    for fn in shard_fns:
        for name, rec in _records(fn, fmt):
            by_name.setdefault(name, []).append(rec)
    n = 0
    for read in read_fastx(input_fn):
        for rec in by_name.pop(read.name, []):
            out.writelines(rec)
            n += 1
    if by_name:
        leftover = next(iter(by_name))
        raise ValueError(
            f"{len(by_name)} record group(s) reference reads absent from "
            f"{input_fn} (e.g. '{leftover}') — wrong input file?"
        )
    return n


def main(argv: List[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    input_fn = None
    fmt = 1
    shards: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-i", "--input"):
            i += 1
            input_fn = argv[i]
        elif a == "-f":
            i += 1
            fmt = int(argv[i])
        elif a in ("-h", "--help"):
            sys.stderr.write(__doc__ + "\n")
            return 0
        else:
            shards.append(a)
        i += 1
    if input_fn is None or not shards:
        sys.stderr.write(
            "usage: merge -i input.fa [-f 1|2|3|4] shard0 shard1 ...\n"
        )
        return 1
    n = merge(input_fn, shards, fmt, sys.stdout)
    sys.stderr.write(f"[merge] {n} records from {len(shards)} shards\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
