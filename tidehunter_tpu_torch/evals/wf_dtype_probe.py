"""Wavefront dtype probe: does a narrow state type pay inside the
wavefront's row loop on the card?

Counterpart of the JAX package's ``evals/wf_dtype_probe.py``.  A
``_dp_row``-shaped loop (two rolls of the previous row, compares, selects,
adds, clamps) runs over a ``[BT, T]`` tile for ``NR * 4`` rows,
``NR = ceil((2T - 1) / 4)``, with the state in one integer type; each call
is fed the previous call's output ``& 3``.  Four variants: int32 state and
lane index, int16 / int16, int16 / int32 and int8 / int32.

``probe`` launches the hand-written kernel (``csrc/wf_dtype_probe.cu``) on
a CUDA tensor and runs ``probe_plain``, the same loop in torch ops, on a
CPU tensor.  The kernel gives a thread one 32-bit word: an int32 lane,
or, in the int16 and int8 variants, the card's packed lanes (two 16-bit
or four 8-bit fields a word, stepped by SIMD and DPX instructions); the
row's words pass through shared memory with one barrier a row.
``main`` times the four variants on the card:

    python -m tidehunter_tpu_torch.evals.wf_dtype_probe [T] [BT]

It prints ms per call (a chain of 8 calls, best of 5 after a warm run, CUDA
events), Gcell/s (``BT * T * NR * 4`` cells per call) and each variant's
speedup over int32.  A variant that fails raises.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import _kernels as K

ROWS_PER_STEP = 4   # K of the JAX probe: rows per grid step
CHAIN = 8
MAX_T = 1024        # a word a thread, at most 1024 threads a CTA
# Integer ops per cell of the JAX kernel's loop, counted in
# csrc/wf_dtype_probe.cu: per 32-bit word, so a packed int16 word does them
# for 2 cells and an int8 word for 4; bytes per cell are the tile read and
# written once per call.
OPS_PER_CELL = 35
# name -> (state type, lane-index type), in the JAX probe's order
VARIANTS = {
    "int32": (torch.int32, torch.int32),
    "int16": (torch.int16, torch.int16),
    "int16/i32iota": (torch.int16, torch.int32),
    "int8/i32iota": (torch.int8, torch.int32),
}


def n_rows(T: int) -> int:
    """NR * 4 rows: 2T - 1 anti-diagonals rounded up to a grid step."""
    nr = (2 * T - 1 + ROWS_PER_STEP - 1) // ROWS_PER_STEP
    return nr * ROWS_PER_STEP


def _variant(tb, dt, iota_dt) -> int:
    pair = (dt, iota_dt)
    if pair not in VARIANTS.values():
        raise ValueError(f"no probe variant for state {dt} / lane {iota_dt}")
    if tb.dtype != dt:
        raise TypeError(f"tb is {tb.dtype}, the variant's state is {dt}")
    if tb.dim() != 2 or not 1 <= tb.shape[1] <= MAX_T:
        raise ValueError(f"tb must be [BT, T] with 1 <= T <= {MAX_T}, got "
                         f"{tuple(tb.shape)}")
    return list(VARIANTS.values()).index(pair)


def probe_plain(tb: torch.Tensor, dt, iota_dt) -> torch.Tensor:
    """One call of the probe in torch ops, row by row: out [BT, T] of dt.
    Every op yields dt, so narrow types wrap after each op as in the
    kernel; the lane index compares in iota_dt (rows stay below 2 * MAX_T,
    inside int16)."""
    _variant(tb, dt, iota_dt)
    dev = tb.device

    def c(v):
        return torch.tensor(v, dtype=dt, device=dev)

    c0, c1, c2, cm2, c7 = c(0), c(1), c(2), c(-2), c(7)
    T = tb.shape[1]
    ti = torch.arange(T, dtype=iota_dt, device=dev)[None, :]
    lane0 = ti == 0
    u, v, x, y, out = (torch.zeros_like(tb) for _ in range(5))
    for r in range(n_rows(T)):
        is_r = ti == r
        qb = torch.where(is_r, tb, torch.roll(u, 1, 1) & 3)
        s = torch.where(qb == tb, c1, cm2)
        y_b = torch.where(is_r, c0, y)
        u_b = torch.where(is_r, c2, u)
        x_sh = torch.where(lane0, c0, torch.roll(x, 1, 1))
        v_sh = torch.where(lane0, c2, torch.roll(v, 1, 1))
        a = x_sh + v_sh
        b = y_b + u_b
        z = s + 6
        d = (a > z).to(dt)
        z = torch.maximum(z, a)
        d = torch.where(b > z, c2, d)
        z = torch.minimum(torch.maximum(z, b), c7)
        u_new = z - v_sh
        v_new = z - u_b
        a2 = a - (z - 2)
        b2 = b - (z - 2)
        mask = is_r | (ti < r)
        u = torch.where(mask, u_new, u)
        v = torch.where(mask, v_new, v)
        x = torch.where(mask, torch.maximum(a2, c0), x)
        y = torch.where(mask, torch.maximum(b2, c0), y)
        out = out + d + u_new
    return out


def probe(tb: torch.Tensor, dt, iota_dt) -> torch.Tensor:
    """One call of the probe: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    variant = _variant(tb, dt, iota_dt)
    if tb.device.type == "cpu":
        return probe_plain(tb, dt, iota_dt)
    if tb.device.type != "cuda":
        raise ValueError(f"unsupported device {tb.device}")
    tb = tb.contiguous()
    BT, T = tb.shape
    out = torch.empty_like(tb)
    K.WF_DTYPE_PROBE(tb.device, tb.data_ptr(), out.data_ptr(), BT, T,
                     n_rows(T), variant)
    return out


def tile(name: str, T: int, BT: int, device) -> torch.Tensor:
    """The JAX probe's input tile: integers 0..3 from seed 0."""
    dt = VARIANTS[name][0]
    tb = np.random.default_rng(0).integers(0, 4, (BT, T))
    return torch.as_tensor(tb).to(dt).to(device)


def chain(tb: torch.Tensor, name: str, fn=probe) -> List[torch.Tensor]:
    """CHAIN calls, each fed the previous output & 3; every output."""
    dt, iota_dt = VARIANTS[name]
    outs = []
    x = tb
    for _ in range(CHAIN):
        outs.append(fn(x, dt, iota_dt))
        x = outs[-1] & 3
    return outs


def time_variants(T: int, BT: int, reps: int = 5) -> Dict[str, float]:
    """ms per call of each variant on the card: a chain of CHAIN calls,
    best of reps after a warm run, timed with CUDA events."""
    K.require_cuda()
    res = {}
    for name in VARIANTS:
        tb = tile(name, T, BT, "cuda")
        chain(tb, name)
        best = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(tb, name)
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end))
        res[name] = best / CHAIN
    return res


def report(T: int, BT: int, ms: Dict[str, float]) -> List[str]:
    cells = BT * T * n_rows(T)
    lines = [f"{name:14s}: {t:8.3f} ms/call  "
             f"{cells / (t * 1e-3) / 1e9:7.2f} Gcell/s"
             for name, t in ms.items()]
    lines += [f"# {name} speedup vs int32: {ms['int32'] / t:.2f}x"
              for name, t in ms.items() if name != "int32"]
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    T = int(argv[0]) if len(argv) > 0 else 512
    BT = int(argv[1]) if len(argv) > 1 else 128
    K.require_cuda()
    print(f"# device={torch.cuda.get_device_name(0)} T={T} BT={BT} "
          f"rows={n_rows(T)}")
    for line in report(T, BT, time_variants(T, BT)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
