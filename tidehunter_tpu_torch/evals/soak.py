"""Long-running engine-vs-oracle fuzz soak.

Extends the fuzz corpus's contract (evals/fuzz.py): the engine's
serialized records must be byte-identical to the host oracle's
(pipeline.core.tidehunter_core), across many seeds, each of which draws
its own format, minimizer window, -H, filters (min_copy, only_unit,
min_frac, only_longest, min_len), --polish and the device seeding
switches (TH_DEVICE_SEED=1, and with it TH_DEVICE_CHAIN=1 or not)
(fuzz.soak_draw).  Engines are cached by (w, hpc, polish), the knobs an
engine is built with; the switches are read by the engine at each chunk.

Usage:
    python -m tidehunter_tpu_torch.evals.soak [--minutes 60]
        [--start-seed 1000] [--reads 12] [--device cuda|cpu]
        [--stop-file F --stop-pattern "UP "]

Prints one line per divergence or crash (seed + params) and a summary;
the exit code is the number of failures (at most 120).  --device cuda
(the default) fails without a card before the first seed.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time
from collections import Counter
from dataclasses import dataclass, field

from .fuzz import serialize, soak_draw

SWITCHES = ("TH_DEVICE_SEED", "TH_DEVICE_CHAIN")


@dataclass
class SoakResult:
    runs: int = 0
    divergences: list = field(default_factory=list)    # seeds
    crashes: list = field(default_factory=list)        # (seed, error)
    drawn: Counter = field(default_factory=Counter)    # seeds per switch

    @property
    def failures(self) -> int:
        return len(self.divergences) + len(self.crashes)


def _describe(mtp, dev_seed, dev_chain) -> str:
    return (f"fmt={mtp.out_fmt} w={mtp.w} hpc={mtp.hpc} "
            f"min_copy={mtp.min_copy} only_unit={mtp.only_unit} "
            f"dev_seed={dev_seed} dev_chain={dev_chain} polish={mtp.polish}")


def _count(drawn: Counter, mtp, dev_seed, dev_chain) -> None:
    drawn["device seeding"] += dev_seed
    drawn["device chaining"] += dev_chain
    drawn["--polish 1"] += mtp.polish == 1
    drawn["w > 1"] += mtp.w > 1
    drawn["-H"] += mtp.hpc == 1
    drawn[f"-f {mtp.out_fmt}"] += 1


def soak(seeds, n_reads: int = 12, device: str = "cuda", want=None,
         should_stop=None, log=print) -> SoakResult:
    """Runs each seed of `seeds` (any iterable) through a cached Engine
    and holds its records to the oracle.  want: {seed: the oracle's
    serialized records}, computed here, seed by seed, for a seed it lacks.
    should_stop() is asked before each seed.  The switches' environment
    is restored on return."""
    from ..engine import Engine
    from ..pipeline.core import tidehunter_core

    if device == "cuda":
        from .._kernels import require_cuda

        require_cuda()
    saved = {k: os.environ.get(k) for k in SWITCHES}
    engines = {}
    out = SoakResult()
    try:
        for seed in seeds:
            if should_stop is not None and should_stop():
                break
            mtp, dev_seed, dev_chain, reads = soak_draw(seed, n_reads)
            os.environ["TH_DEVICE_SEED"] = "1" if dev_seed else "0"
            os.environ["TH_DEVICE_CHAIN"] = "1" if dev_chain else "0"
            _count(out.drawn, mtp, dev_seed, dev_chain)
            key = (mtp.w, mtp.hpc, mtp.polish)
            if key not in engines:
                engines[key] = Engine(mtp, device=device)
            out.runs += 1
            try:
                got = serialize(reads, engines[key].process_chunk(reads, mtp),
                                mtp)
                expect = (want or {}).get(seed)
                if expect is None:
                    expect = serialize(
                        reads, [tidehunter_core(r.seq, mtp) for r in reads],
                        mtp)
            except Exception as exc:  # noqa: BLE001  (counted as a crash)
                out.crashes.append((seed, f"{type(exc).__name__}: {exc}"))
                log(f"seed={seed} CRASH {exc!r} "
                    f"({_describe(mtp, dev_seed, dev_chain)})")
                continue
            if got != expect:
                out.divergences.append(seed)
                log(f"seed={seed} DIVERGENCE "
                    f"({_describe(mtp, dev_seed, dev_chain)})")
            if out.runs % 25 == 0:
                log(f"# {out.runs} runs, {out.failures} failures, "
                    f"seed cursor {seed + 1}")
    finally:
        for eng in engines.values():
            eng.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=60.0)
    ap.add_argument("--start-seed", type=int, default=1000)
    ap.add_argument("--reads", type=int, default=12)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--stop-file", default=None,
                    help="exit early when this file contains --stop-pattern "
                         "(lets a background soak yield the machine to a "
                         "higher-priority measurement run)")
    ap.add_argument("--stop-pattern", default="UP ")
    args = ap.parse_args(argv)
    deadline = time.time() + args.minutes * 60

    def should_stop() -> bool:
        if time.time() >= deadline:
            return True
        if not args.stop_file:
            return False
        try:
            with open(args.stop_file) as fh:
                return args.stop_pattern in fh.read()
        except OSError:
            return False

    res = soak(itertools.count(args.start_seed), args.reads, args.device,
               should_stop=should_stop,
               log=lambda s: print(s, flush=True))
    print(f"soak done: {res.runs} runs x {args.reads} reads, "
          f"{res.failures} failures")
    return min(res.failures, 120)


if __name__ == "__main__":
    sys.exit(main())
