"""Command line of the PyTorch port.

    python -m tidehunter_tpu_torch.cli [reference flags] [--device D] in.fa

Takes the reference flags of ``tidehunter_tpu.cli`` (same parser) plus
``--device cuda|cpu|off`` (default cuda): ``cuda`` runs the hand-written
kernels, ``cpu`` their plain PyTorch versions, ``off`` the sequential host
oracle.  A device that cannot be used, and options this port does not
support yet (adapters, --polish, --msa graph, --dist, --profile,
--metrics), end the run with an error; nothing falls back to the host.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from tidehunter_tpu.cli import parse_args
from tidehunter_tpu.pipeline import runner
from tidehunter_tpu.utils.log import log, resource_line
from tidehunter_tpu.utils.metrics import METRICS

from .api import DEVICES


def _error(msg: str) -> int:
    sys.stderr.write(f"\n[main] Error: {msg}\n")
    return 1


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    parsed = parse_args(argv)
    if isinstance(parsed, int):
        return parsed
    mtp, read_fn, extra = parsed
    # parse_args defaults --device to the JAX package's "tpu"
    device = extra["device"] if "--device" in argv else "cuda"
    if device not in DEVICES:
        return _error(f"--device needs one of {'|'.join(DEVICES)}, "
                      f"got '{device}'.")
    unsupported = [f"--{k}" for k in ("dist", "profile", "metrics")
                   if extra[k]]
    if extra["msa"] != "profile":
        unsupported.append(f"--msa {extra['msa']}")
    if unsupported:
        return _error("not supported by the PyTorch port yet: "
                      + ", ".join(unsupported))

    engine = None
    if device != "off":
        from .engine import Engine

        try:
            engine = Engine(mtp, device=device)
        except (NotImplementedError, RuntimeError) as exc:
            return _error(str(exc))
        log(f"engine ready (device={device})")

    # the pipelined runner overlaps a host prepare thread with the drive
    # thread; a shorter switch interval keeps the drive thread responsive
    sys.setswitchinterval(0.001)
    out = open(extra["output"], "w") if extra["output"] else None
    mtp.cons_out = out
    try:
        metrics = runner.run(read_fn, mtp, out=out,
                             resume_cursor=extra["resume"],
                             process_chunk=engine, shard=extra["shard"])
    except FileNotFoundError as exc:
        return _error(f"can not open file {exc.filename}")
    finally:
        if out is not None:
            out.close()
    log(resource_line(), func="main")
    log(f"reads: {metrics.reads}; consensus records: {metrics.cons_records}; "
        f"reads/s: {metrics.reads_per_s():.2f}", func="main")
    if METRICS.snapshot():
        log(METRICS.summary_line(), func="metrics")
    return 0


if __name__ == "__main__":
    sys.exit(main())
