"""Helpers shared by the measurement tools of this package: the device
argument, the clocks, and the comparison of seed hits and chains.

The tools (``host_floor``, ``seed_chain_micro``, ``offload_micro``,
``offload_micro2``, ``msa_micro``, ``tunnel_micro``, ``dtype_micro``,
``testfq_stages``, ``mesh_scaling``) are the counterparts of the JAX
package's ``evals/*.py`` of the same names.  Each runs on ``cuda`` unless
``--device cpu`` is given; ``cuda`` without a card raises.

Every printed time names its clock in brackets:

  [sync]    host clock around the work, closed by torch.cuda.synchronize()
            (where the JAX tools forced a 1-element pull of the result);
  [events]  CUDA events around the work, queued behind a device sleep:
            device time alone;
  [host]    host clock around work that has no device operation in it.

On ``--device cpu`` the kernels run as their plain versions and every time
is a host-clock time ([sync] then closes nothing): no number of such a run
is a device number.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .._kernels import require_cuda

DEVICES = ("cuda", "cpu")


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="cuda (default; a card is required) or cpu (the "
                         "kernels' plain versions)")


def get_device(name: str) -> torch.device:
    """The tool's device: the current CUDA card (raising without one) or
    the CPU."""
    if name == "cuda":
        require_cuda()
        return torch.device("cuda", torch.cuda.current_device())
    if name != "cpu":
        raise ValueError(f"device must be one of {DEVICES}, got {name!r}")
    return torch.device("cpu")


def describe(dev: torch.device) -> str:
    """The device a result ran on, for the tool's header line."""
    if dev.type == "cuda":
        return (f"{torch.cuda.get_device_name(dev)} (count "
                f"{torch.cuda.device_count()})")
    return "cpu (plain versions, host clock: no device number)"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tmin(fn: Callable, dev: torch.device, reps: int = 3):
    """(best seconds of reps runs of fn on the host clock, each closed by
    sync, the last run's result): the [sync] clock."""
    best, out = float("inf"), None
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


def bench_fn(fn: Callable, dev: torch.device, reps: int = 5, warm: int = 2):
    """msa_micro's bench_fn: warm runs, then the best of reps [sync]
    times."""
    for _ in range(warm):
        fn()
    return tmin(fn, dev, reps)


# device cycles (~10 ms) the timed runs queue behind, so that work whose
# launches cost the host more than the device runs back to back on it
SLEEP_CYCLES = 20_000_000


def events_s(fn: Callable, dev: torch.device, n: int = 1,
             reps: int = 3) -> float:
    """Best of reps [events] times of n back-to-back runs of fn, divided by
    n, in seconds: the runs are queued behind a device sleep, so the time
    is the device's, not the host's launch rate.  On the CPU the [sync]
    clock instead."""
    if dev.type != "cuda":
        return tmin(lambda: [fn() for _ in range(n)], dev, reps)[0] / n
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best / n


def clock(dev: torch.device, kind: str) -> str:
    """The bracketed clock of a time taken with `kind` on dev."""
    return "host" if dev.type != "cuda" and kind == "events" else kind


def stage_line(label: str, seconds: float, n: int, clk: str) -> str:
    """One stage: ms, ms a read and the clock."""
    ms = seconds * 1e3
    return (f"{label:38s} {ms:10.4f} ms  ({ms / max(1, n):8.5f} ms/read)"
            f" [{clk}]")


class Stages:
    """A stage split's printer: each stage as a stage_line of n reads on
    dev, named by its clock."""

    def __init__(self, dev: torch.device, n: int, reps: int):
        self.dev, self.n, self.reps = dev, n, reps

    def report(self, label: str, seconds: float, clk: str = "sync") -> None:
        print(stage_line(label, seconds, self.n, clock(self.dev, clk)),
              flush=True)

    def tmin(self, label: str, fn: Callable, clk: str = "sync"):
        """fn's best of reps on the [sync] clock, reported as `clk` (host
        for a stage with no device operation); returns its result."""
        best, out = tmin(fn, self.dev, self.reps)
        self.report(label, best, clk)
        return out


# --- seed hits and chains --------------------------------------------------

def chain_key(entry) -> Optional[list]:
    """A (dp, chains) entry as comparable values: each chain's cells and
    estimates; None stays None (the entry the host chainer resolves)."""
    if entry is None:
        return None
    return [(tuple(int(c) for c in ch.cells), int(ch.est_period),
             int(ch.est_start), int(ch.est_ch_i)) for ch in entry[1]]


def seed_chain_mismatches(got_hits: Sequence, got_chains: Sequence,
                          want_hits: Sequence, want_chains: Sequence
                          ) -> List[int]:
    """Reads whose hits (ends, periods) or chains differ, exactly."""
    bad = []
    for i, (gh, wh) in enumerate(zip(got_hits, want_hits)):
        same = all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(gh, wh))
        if not same or chain_key(got_chains[i]) != chain_key(want_chains[i]):
            bad.append(i)
    if len(got_hits) != len(want_hits):
        bad.append(min(len(got_hits), len(want_hits)))
    return bad
