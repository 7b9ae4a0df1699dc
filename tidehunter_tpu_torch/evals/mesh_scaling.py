"""Weak scaling of the mesh path: the same work a device over meshes of
1, 2, 4 and 8 devices.

Counterpart of the JAX package's ``evals/mesh_scaling.py``.  Each mesh
size n runs in its own process (which imports only this package): 24
reads a device (``synth_read(rng, 55, 4, 0.06, 25)``, seed 23, the JAX
tool's ``_tandem_read`` draws) through ``Engine(mtp, device, mesh=...)``,
one warm run, then a timed one (host clock closed by a device
synchronise: [sync]).  Flat per-read wall time means the mesh splits
batches rather than repeating them.

On ``cuda`` the mesh is ``Mesh([cuda:0] * n)``: every block on the one
card, so the split's cost shows and its gain cannot (``make_mesh`` raises
past the visible cards, where the JAX package's gave fewer devices).  On
``--device cpu`` it is n CPU shards.  Every mesh size's records of the
first 24 reads must be byte-identical with n = 1's, or the tool exits 1:
the JAX tool leaves that to ``tests/test_multichip.py``, and on the card
this is the only check of a mesh the run gives.

    python -m tidehunter_tpu_torch.evals.mesh_scaling [--device cuda|cpu]
        [--sizes 1,2,4,8] [--reads-per-device 24]
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from . import _micro

ROOT = Path(__file__).resolve().parents[2]   # the package's parent
SIZES = (1, 2, 4, 8)
READS_PER_DEVICE = 24


def child(n: int, reads_per_device: int, device: str) -> dict:
    """One mesh size in this process: its wall time, records and the
    first reads_per_device reads' records."""
    import torch

    from ..engine import Engine
    from ..io.fastx import FastxRecord
    from ..io.output import write_read_output
    from ..params import Params
    from ..parallel.mesh import Mesh, make_mesh
    from .synth import synth_read

    dev = _micro.get_device(device)
    rng = np.random.default_rng(23)
    reads = [FastxRecord(name=f"m{i}", comment="",
                         seq=synth_read(rng, unit_len=55, copies=4, err=0.06,
                                        flank=25))
             for i in range(reads_per_device * n)]
    mtp = Params()
    mesh = (Mesh([torch.device("cuda", dev.index)] * n)
            if dev.type == "cuda" else make_mesh(n, "cpu"))
    engine = Engine(mtp, device=device, mesh=mesh)
    engine(reads, mtp)          # warm
    _micro.sync(dev)
    t0 = time.perf_counter()
    res = engine(reads, mtp)
    _micro.sync(dev)
    dt = time.perf_counter() - t0
    engine.close()
    buf = io.StringIO()
    for rec, r in zip(reads[:reads_per_device], res):
        write_read_output(buf, rec.name, rec.seq, r, mtp)
    return {"n": n, "reads": len(reads), "wall_s": dt,
            "cons": sum(len(r.records) for r in res),
            "records": buf.getvalue()}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _micro.add_device_arg(ap)
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)),
                    help="mesh sizes, comma-separated (default 1,2,4,8)")
    ap.add_argument("--reads-per-device", type=int, default=READS_PER_DEVICE)
    ap.add_argument("--child", type=int, metavar="N",
                    help=argparse.SUPPRESS)   # one mesh size, in-process
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.reads_per_device,
                               args.device)))
        return 0
    dev = _micro.get_device(args.device)
    print(f"# mesh_scaling on {_micro.describe(dev)}: "
          f"{args.reads_per_device} reads a device", flush=True)
    rows = []
    for n in (int(s) for s in args.sizes.split(",")):
        r = subprocess.run(
            [sys.executable, "-m", __spec__.name, "--child", str(n),
             "--reads-per-device", str(args.reads_per_device), "--device",
             args.device], cwd=ROOT, capture_output=True, text=True,
            timeout=3000)
        lines = (r.stdout or "").strip().splitlines()
        if r.returncode != 0 or not lines:
            print(f"# n={n} FAILED rc={r.returncode}: "
                  f"{(r.stderr or '')[-2000:]}", flush=True)
            return 1
        row = json.loads(lines[-1])
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "records"}),
              flush=True)
    base = rows[0]["wall_s"] / rows[0]["reads"]
    print("# per-read wall (flat = batches split, not repeated) [sync]:")
    for row in rows:
        pr = row["wall_s"] / row["reads"]
        print(f"#   n={row['n']}: {pr * 1e3:.4f} ms/read "
              f"({pr / base:.4f}x of n={rows[0]['n']})", flush=True)
    bad = [row["n"] for row in rows if row["records"] != rows[0]["records"]]
    print(f"# records of the first {args.reads_per_device} reads: "
          + ("byte-identical at every size" if not bad else
             f"differ from n={rows[0]['n']}'s at n={bad}"), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
