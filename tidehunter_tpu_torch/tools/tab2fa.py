"""TideHunter output format transformation (Tabular <-> FASTA).

Behavior-equivalent to the reference converter (reference src/tab2fa.py:7-35):

* tab -> fa: each tabular row becomes a FASTA record whose header is every
  column except the sequence joined with '_' (tab_core, tab2fa.py:19-29).
* fa -> tab: the FASTA header is split on '_' from the right; the last 7
  fields become tab columns, the rest re-join as the read name (fa_core,
  tab2fa.py:7-16). fa -> fa round-trips records verbatim.
* -F keeps only full-length records (fullLen field != '0'); the fullLen
  field is the LAST '_'-field of the name token in fa mode (tab2fa.py:12)
  and column 9 (0-based 8) in tab mode. The reference checks ele[7]
  (tab2fa.py:25) — that is aveMatch, printed "%.1f" and never '0', so the
  upstream tab-mode -F silently filters nothing; we use the real fullLen
  column (reference src/main.c:244: readName repN copyNum readLen start
  end consLen aveMatch fullLen subPos seq).

No pyfaidx dependency: FASTA parsing uses the package's own streaming
reader semantics (multi-line sequences joined, header = full line after
'>').

Usage: python -m tidehunter_tpu_torch.tools.tab2fa in.tab out.fa [-it tab|fa]
       [-ot fa|tab] [-F]
"""

from __future__ import annotations

import argparse
import sys
from typing import IO, Iterator, Tuple


def _iter_fasta(fp: IO[str]) -> Iterator[Tuple[str, str]]:
    """Yield (long_name, seq) with multi-line sequences joined."""
    name = None
    parts = []
    for line in fp:
        line = line.rstrip("\n")
        if line.startswith(">"):
            if name is not None:
                yield name, "".join(parts)
            name = line[1:]
            parts = []
        elif name is not None:
            parts.append(line.strip())
    if name is not None:
        yield name, "".join(parts)


def fa_transform(in_fp: IO[str], out_fp: IO[str], out_type: str,
                 only_full: bool) -> None:
    for long_name, seq in _iter_fasta(in_fp):
        # pyfaidx r.name = first whitespace token of the header
        name = long_name.split()[0] if long_name.split() else ""
        ele = name.split("_")
        if only_full and ele[-1] == "0":
            continue
        if out_type == "tab":
            out_fp.write(
                "{}\t{}\t{}\n".format(
                    "_".join(ele[:-7]), "\t".join(ele[-7:]), seq
                )
            )
        elif out_type == "fa":
            out_fp.write(">{}\n{}\n".format(long_name, seq))


def tab_transform(in_fp: IO[str], out_fp: IO[str], out_type: str,
                  only_full: bool) -> None:
    for line in in_fp:
        ele = line.split()
        if not ele:
            continue
        if only_full and ele[8] == "0":
            continue
        if out_type == "fa":
            out_fp.write(">{}\n{}\n".format("_".join(ele[:-1]), ele[-1]))
        elif out_type == "tab":
            out_fp.write(line)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="TideHunter output format transformation. (Tabular/FASTA)",
    )
    parser.add_argument("in_file", metavar="in.tab/fa")
    parser.add_argument("out_file", metavar="out.tab/fa")
    parser.add_argument("-it", "--in-type", default="tab",
                        choices=["tab", "fa"])
    parser.add_argument("-ot", "--out-type", default="fa",
                        choices=["tab", "fa"])
    parser.add_argument("-F", "--only-full", action="store_true",
                        help="Only output the consensus that is full-length.")
    args = parser.parse_args(argv)
    with open(args.in_file) as in_fp, open(args.out_file, "w") as out_fp:
        if args.in_type == "tab":
            tab_transform(in_fp, out_fp, args.out_type, args.only_full)
        else:
            fa_transform(in_fp, out_fp, args.out_type, args.only_full)
    return 0


if __name__ == "__main__":
    sys.exit(main())
