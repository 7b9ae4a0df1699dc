"""The loops of each compiled kernel, read from its SASS.

    python -m tidehunter_tpu_torch.evals.sass_loops [NAME ...] [--out FILE]
        [--ops]

Builds the port's kernel library (``_kernels.build``), disassembles it
with ``cuobjdump -sass`` and prints, for every kernel whose mangled name
holds one of the NAMEs (all kernels without one), each loop: a backward
branch and the instructions from its target to it, with the count of
barriers, shuffles, shared- and global-memory loads and stores, and
branches inside.  A kernel's row loop is the loop that holds its barrier
or its direction-byte store; its count is the issue a warp spends a row
(each instruction once, whatever its latency).  ``--ops`` adds each
loop's opcodes with their counts (``VIADD.16x2=16``), from which a loop's
work in words or steps is read.  ``--out`` also writes the whole
disassembly.  Needs the CUDA toolkit (``cuobjdump`` beside
``nvcc``); on a host without one it exits 2.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

from .. import _kernels as K

# SASS opcode prefixes counted inside a loop
KINDS = {"BAR": ("BAR",), "SHFL": ("SHFL",), "LDS": ("LDS",),
         "STS": ("STS",), "LDG": ("LDG", "LD."), "STG": ("STG", "ST."),
         "BRA": ("BRA",), "SYNCS": ("SYNCS",)}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)"
                   r"(.*?);")
_TARGET = re.compile(r"(?:`\(\.(L_x_\d+)\)|0x([0-9a-f]+))")
_LABEL = re.compile(r"^\s*\.(L_x_\d+):")


def functions(sass: str) -> Dict[str, List[Tuple[int, str, str]]]:
    """Mangled kernel name -> [(address, opcode, operands)]; labels become
    the address of the instruction after them."""
    out: Dict[str, List[Tuple[int, str, str]]] = {}
    labels: Dict[str, Dict[str, int]] = {}
    cur, pending = None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur, pending = m.group(1), []
            out[cur], labels[cur] = [], {}
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            out[cur].append((addr, m.group(2), m.group(3)))
    # resolve label targets to addresses
    for name, insns in out.items():
        res = []
        for addr, op, rest in insns:
            t = _TARGET.search(rest) if op.startswith("BRA") else None
            tgt = None
            if t:
                tgt = (labels[name].get(t.group(1)) if t.group(1)
                       else int(t.group(2), 16))
            res.append((addr, op, str(tgt) if tgt is not None else ""))
        out[name] = res
    return out


def loops(insns) -> List[dict]:
    """Every backward branch: its span, the counts of KINDS inside and
    each opcode's count (``ops``)."""
    found = []
    for i, (addr, op, tgt) in enumerate(insns):
        if not op.startswith("BRA") or not tgt or int(tgt) >= addr:
            continue
        body = [x for x in insns if int(tgt) <= x[0] <= addr]
        row = {"from": f"{int(tgt):#06x}", "to": f"{addr:#06x}",
               "insns": len(body)}
        for kind, prefixes in KINDS.items():
            row[kind] = sum(x[1].startswith(prefixes) for x in body)
        row["ops"] = dict(Counter(x[1] for x in body).most_common())
        found.append(row)
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--out", help="write the whole disassembly here")
    ap.add_argument("--ops", action="store_true",
                    help="print each loop's opcodes and their counts")
    args = ap.parse_args(argv)
    tool = shutil.which("cuobjdump") or str(Path(K._nvcc()).with_name(
        "cuobjdump"))
    if not Path(tool).exists():
        print("sass_loops: no cuobjdump on this host", file=sys.stderr)
        return 2
    sass = subprocess.run([tool, "-sass", str(K.build())], check=True,
                          capture_output=True, text=True).stdout
    if args.out:
        Path(args.out).write_text(sass)
    for name, insns in functions(sass).items():
        if args.names and not any(n in name for n in args.names):
            continue
        print(f"{name}: {len(insns)} instructions")
        for row in loops(insns):
            if row["insns"] >= 16:
                ops = row.pop("ops")
                print("  loop " + " ".join(f"{k}={v}" for k, v in
                                           row.items()))
                if args.ops:
                    print("    ops " + " ".join(f"{k}={v}" for k, v in
                                                ops.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
