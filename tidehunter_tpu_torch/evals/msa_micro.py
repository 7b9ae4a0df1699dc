"""DeviceMSA's unit round split into its steps, each timed apart.

Counterpart of the JAX package's ``evals/msa_micro.py``.  It makes the
slice's MSA workload (``make_regions``: 512 regions of 9 x 450 bp units at
10% error, seed 42; bucket T=640, band W=128) and times:

  * ``consensus_batch`` on all regions, warm and steady (best of 3);
  * then, on one region batch at the first rung's (T, W), each step of a
    unit round of ``ops/msa_device.DeviceMSA`` alone: the gather of unit k
    (as ``_launch_batch``'s ``gather``), ``scores_step``, ``profile_dp``
    (with Gcell/s of dispatched cells, B x T x W), ``profile_bt``,
    ``update_step``, the whole ``round``, ``consensus_step`` and the pull
    of its outputs (as ``_run_batch`` pulls them);
  * 8 chained rounds enqueued, then one synchronise, with the enqueue
    timeline.

Each step prints its [sync] time (host clock closed by a device
synchronise, where the JAX tool blocked on the result; warm runs first,
best of 5) and its [events] time (CUDA events around the step alone: the
device's share of it).  One check the JAX tool lacks, because the card
forces it: the state, plane (on the rows each region writes) and ops
after one ``round`` must equal those after scores -> dp -> bt -> update
run apart, or the tool exits 1; without
it, timing the steps apart would not show that the steps are the round.

    python -m tidehunter_tpu_torch.evals.msa_micro [N_REGIONS]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..ops.msa_device import DeviceMSA, MSAState, profile_bt, profile_dp
from ..ops.poa_profile import band_ladder
from ..params import Params
from ..parallel import mesh as PM
from . import _micro

UNIT_K = 3      # the unit whose round is timed (the JAX tool's k)


def make_regions(n, unit_len=450, copies=9, err=0.10, seed=42):
    """The JAX tool's regions: n lists of `copies` mutated copies of a
    random unit (uint8 codes)."""
    rng = np.random.default_rng(seed)
    regions = []
    for _ in range(n):
        unit = rng.integers(0, 4, unit_len).astype(np.uint8)
        units = []
        for _ in range(copies):
            out = []
            for c in unit:
                r = rng.random()
                if r < err / 3:
                    continue
                elif r < 2 * err / 3:
                    out.append(rng.integers(0, 4))
                    out.append(c)
                elif r < err:
                    out.append(rng.integers(0, 4))
                else:
                    out.append(c)
            units.append(np.array(out, dtype=np.uint8))
        regions.append(units)
    return regions


def make_msa(dev) -> DeviceMSA:
    m = Params()
    return DeviceMSA(m.match, m.mismatch, m.gap_open1, m.gap_ext1,
                     gap_open2=m.gap_open2, gap_ext2=m.gap_ext2, device=dev)


def shape_of(msa: DeviceMSA, regions):
    """(cap, spread, need, T, W) of the regions' first batch, as
    consensus_batch buckets them."""
    cap = max(max(len(u) for u in units) for units in regions)
    spread = max(max(len(u) for u in units) - min(len(u) for u in units)
                 for units in regions)
    need = int(cap * 1.2) + 8
    T = msa._bucket(need)
    return cap, spread, need, T, band_ladder(T, spread)[0]


def batch_inputs(msa: DeviceMSA, regions, T: int, dev):
    """(state after unit 0, units [B, U, T], ulen, nunits) on dev, as
    _launch_batch builds them."""
    B = len(regions)
    U = max(len(units) for units in regions)
    units_arr = np.full((B, U, T), 4, np.uint8)
    ulen = np.zeros((B, U), np.int32)
    nunits = np.array([len(units) for units in regions], np.int32)
    for i, units in enumerate(regions):
        for k, u in enumerate(units):
            n = min(len(u), T)
            units_arr[i, k, :n] = u[:n]
            ulen[i, k] = max(1, n)
    units_d, ulen_d, nunits_d = (torch.as_tensor(a, device=dev)
                                 for a in (units_arr, ulen, nunits))
    return msa.init_state(units_d, ulen_d), units_d, ulen_d, nunits_d


def gather(units_d, ulen_d, nunits_d, k: int):
    """Unit k's (codes, lengths, active), as _launch_batch's gather."""
    active = k < nunits_d
    one = torch.ones_like(ulen_d[:, 0])
    return units_d[:, k], torch.where(active, ulen_d[:, k], one), active


def steps_apart(msa: DeviceMSA, state: MSAState, unit, qlen, active, T, W):
    """scores -> dp -> bt -> update run apart: (counts, n_placed, ncol,
    overflow, dirs, ops, nst, tch)."""
    sub, wdel, wl, wdel2, wl2 = msa.scores_step(state)
    dirs = profile_dp(unit, qlen, state.ncol, sub, wl, wdel, wl2, wdel2,
                      msa.costs, W)
    ops, nst, tch = profile_bt(dirs, qlen, state.ncol, T, W)
    return (*msa.update_step(state, unit, active, ops, nst), dirs, ops, nst,
            tch)


def round_mismatch(msa: DeviceMSA, state: MSAState, unit, qlen, active, T,
                   W) -> List[str]:
    """The fields where one round differs from its steps run apart (the
    round's ev follows from tch and overflow, both compared).  The
    direction plane is compared on the rows each region writes, r < qlen +
    ncol - 1: profile_dp leaves the rest of its [2T-1, B, W] plane
    unspecified."""
    r = msa.round(state, unit, qlen, active, T, W)
    got = (*r.state[:4], r.dirs, r.ops, r.nst, r.tch)
    want = steps_apart(msa, state, unit, qlen, active, T, W)
    rows = torch.arange(2 * T - 1, device=qlen.device)[:, None]
    live = (rows < (qlen + state.ncol - 1)[None, :])[:, :, None]
    got = (*got[:4], torch.where(live, got[4], 0), *got[5:])
    want = (*want[:4], torch.where(live, want[4], 0), *want[5:])
    names = ("counts", "n_placed", "ncol", "overflow", "dirs", "ops", "nst",
             "tch")
    return [nm for nm, a, b in zip(names, got, want)
            if not torch.equal(a, b)]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_regions", nargs="?", type=int, default=512)
    _micro.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _micro.get_device(args.device)
    n = args.n_regions
    msa = make_msa(dev)
    regions = make_regions(n)
    print(f"# msa_micro on {_micro.describe(dev)}: {n} regions", flush=True)

    t0 = time.perf_counter()
    msa.consensus_batch(regions)
    _micro.sync(dev)
    warm = time.perf_counter() - t0
    steady, _ = _micro.tmin(lambda: msa.consensus_batch(regions), dev, 3)
    print(f"consensus_batch({n}): warm={warm:.4f}s steady={steady:.4f}s "
          f"({steady / n * 1e3:.4f} ms/region) [sync]", flush=True)

    cap, spread, need, T, W = shape_of(msa, regions)
    B = min(n, msa.batch_rows(T, W))
    print(f"cap={cap} spread={spread} need={need} -> T={T} W={W}; B={B} "
          f"(batch_rows {msa.batch_rows(T, W)})", flush=True)
    state, units_d, ulen_d, nunits_d = batch_inputs(msa, regions[:B], T,
                                                    dev)
    U = units_d.shape[1]
    k = min(UNIT_K, U - 1)
    total = {"sync": 0.0, "events": 0.0}

    def step(label, fn):
        dt, out = _micro.bench_fn(fn, dev)
        ev = _micro.events_s(fn, dev, reps=5) if dev.type == "cuda" else dt
        total["sync"] += dt
        total["events"] += ev
        print(f"{label}: {dt * 1e3:.4f} ms [sync] {ev * 1e3:.4f} ms "
              f"[{_micro.clock(dev, 'events')}]", flush=True)
        return out, dt

    (unit, qlen, active), _ = step(
        f"gather unit {k}", lambda: gather(units_d, ulen_d, nunits_d, k))
    (sub, wdel, wl, wdel2, wl2), _ = step(
        "scores_step", lambda: msa.scores_step(state))
    dirs, dt = step("profile_dp", lambda: profile_dp(
        unit, qlen, state.ncol, sub, wl, wdel, wl2, wdel2, msa.costs, W))
    cells = float(B) * T * (W or T)
    print(f"  profile_dp: {cells / dt / 1e9:.4f} Gcell/s dispatched [sync]",
          flush=True)
    (ops, nst, _tch), _ = step(
        "profile_bt", lambda: profile_bt(dirs, qlen, state.ncol, T, W))
    step("update_step",
         lambda: msa.update_step(state, unit, active, ops, nst))
    steps = dict(total)
    r, _ = step("round", lambda: msa.round(state, unit, qlen, active, T, W))
    done, _ = step("consensus_step", lambda: msa.consensus_step(r.state))
    outs = (*done, r.state.overflow, r.state.ev)
    t0 = time.perf_counter()
    PM.pull_async(outs)()
    pull = time.perf_counter() - t0
    print(f"pull: {pull * 1e3:.4f} ms [sync]", flush=True)
    print(f"# steps of a round (gather + scores + dp + bt + update): "
          f"{steps['sync'] * 1e3:.4f} ms [sync], {steps['events'] * 1e3:.4f}"
          f" ms [{_micro.clock(dev, 'events')}]; {U - 1} rounds a batch",
          flush=True)

    # 8 dependent rounds enqueued, then one synchronise
    def chained():
        s2, enq = state, []
        t0 = time.perf_counter()
        for _ in range(8):
            s2 = msa.round(s2, unit, qlen, active, T, W).state
            enq.append(time.perf_counter() - t0)
        _micro.sync(dev)
        return time.perf_counter() - t0, enq

    for _ in range(2):
        chained()
    total_s, enq = min(chained() for _ in range(3))
    print(f"8 chained rounds: {total_s * 1e3:.4f} ms total; enqueue "
          f"timeline {' '.join(f'{e * 1e3:.2f}' for e in enq)} ms [sync]",
          flush=True)

    bad = round_mismatch(msa, state, unit, qlen, active, T, W)
    print(f"# one round vs its steps run apart: "
          f"{'equal' if not bad else 'differ in ' + ', '.join(bad)}",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
