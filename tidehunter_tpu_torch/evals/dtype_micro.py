"""Element-type rate micro-benchmark: does a narrow type, or four 8-bit
fields packed in an int32, raise the rate of the DP core's op mix on the
card?

Counterpart of the JAX package's ``evals/dtype_micro.py``.  CHAIN = 64
steps of the recurrence ``x = max(x + a, y); y = where(x > y, x - a, y)``
on (512, 1024) arrays at int32, int16, int8, float32 and bfloat16 (printed
in Gelem-op/s, 3 ops an element a step as the JAX tool counts them), and
the SWAR variant: four 8-bit fields in each int32, stepped as
``x = pmax(padd(x, a), y); y = pmax(x, y)`` with the JAX tool's guard-bit
``padd`` and borrow-detecting ``pmax`` (Gfield-op/s: 3 x 4 a step).  The
inputs are the JAX tool's draws (``default_rng(0)``, in its order).

Under XLA the JAX step is one fused loop.  Eager torch ops would time
3 x 64 launches and the HBM traffic between them, not the ALU rate the
question is about, so on the card ``step`` is one launch of the
hand-written kernel ``csrc/dtype_micro.cu``; on a CPU tensor it runs
``step_plain``, the same steps as torch ops.  The kernel gives a thread
16 bytes of each array, four 32-bit words stepped 64 times in registers:
an int32 or float32 element a word, or the card's packed lanes, two int16
elements a word (Hopper's DPX ``__viaddmax_s16x2`` and the SIMD
``__vcmpgts2``, ``__vsub2``), four int8 (``__vadd4``, ``__vmaxs4``,
``__vcmpgts4``, ``__vsub4``) or two bfloat16 (``__hadd2``, ``__hmax2``,
``__hgt2_mask``, ``__hsub2``), each op wrapping (or rounding) per element
as the plain version does.  SWAR keeps a thread an element: it is the JAX
tool's emulation of those lanes.  A time is the mean of 50 launches after
a warm one, on CUDA events behind a device sleep ([events]; the host clock
on ``--device cpu``).

    python -m tidehunter_tpu_torch.evals.dtype_micro [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _kernels as K
from . import _micro

CHAIN = 64
SHAPE = (512, 1024)
ITERS = 50          # launches a timing
# name -> element type, in the JAX tool's order; "swar" holds four 8-bit
# fields in each int32
VARIANTS = {"int32": torch.int32, "int16": torch.int16, "int8": torch.int8,
            "float32": torch.float32, "bfloat16": torch.bfloat16,
            "swar": torch.int32}
# the ops a 32-bit word a step of csrc/dtype_micro.cu's loop (add, max,
# compare, sub, select; a packed word holds 2 int16, 4 int8 or 2 bfloat16
# elements): the bound's count, against 3 inputs read and 2 outputs
# written once
OPS_PER_STEP = 5
# the JAX tool's rate counts: ops an element a step, fields an element
RATE_OPS, SWAR_FIELDS = 3, 4
H = 0x80808080 - (1 << 32)   # the fields' guard bits, as an int32
M7 = 0x7F7F7F7F


def inputs(B: int, L: int) -> Dict[str, Tuple[np.ndarray, ...]]:
    """{variant: (x, y, a)} as the JAX tool draws them from
    default_rng(0): a, x, y for each native type in order, then the SWAR
    words (x four fields, y two, a two)."""
    rng = np.random.default_rng(0)
    out = {}
    for name in list(VARIANTS)[:5]:
        a = rng.integers(-3, 4, (B, L))
        x = rng.integers(0, 8, (B, L))
        y = rng.integers(0, 8, (B, L))
        out[name] = (x, y, a)

    def fields(n, hi):
        w = np.zeros((B, L), np.int32)
        for f in range(n):
            w |= rng.integers(0, hi, (B, L), dtype=np.int32) << (8 * f)
        return w

    x = fields(4, 100)
    y = fields(2, 100)
    a = rng.integers(0, 4, (B, L), dtype=np.int32) | (
        rng.integers(0, 4, (B, L), dtype=np.int32) << 16)
    out["swar"] = (x, y, a)
    return out


def tensors(name: str, arrays, device) -> Tuple[torch.Tensor, ...]:
    """A variant's (x, y, a) as tensors of its element type on device."""
    return tuple(torch.as_tensor(v).to(VARIANTS[name]).to(device)
                 for v in arrays)


def _w32(v: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32's range (two's complement)."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _pmax(a, b):
    d = _w32((a | H) - (b & M7)) & H
    sel = _w32((d >> 7) * 0xFF)
    return (a & sel) | (b & ~sel)


def _padd(a, b):
    return (((a & M7) + (b & M7)) & M7) | ((a ^ b) & H)


def step_plain(name: str, x, y, a, chain: int = CHAIN):
    """The plain version: chain steps as torch ops, every op in the
    element type (the SWAR words in int64, wrapped to 32 bits after each
    op that can carry past them)."""
    if name == "swar":
        x, y, a = (t.long() for t in (x, y, a))
        for _ in range(chain):
            x = _pmax(_padd(x, a), y)
            y = _pmax(x, y)
        return x.int(), y.int()
    for _ in range(chain):
        x = torch.maximum(x + a, y)
        y = torch.where(x > y, x - a, y)
    return x, y


def step(name: str, x, y, a, chain: int = CHAIN):
    """(x, y) after chain steps: one launch of the kernel on CUDA tensors,
    step_plain on CPU tensors."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}: {list(VARIANTS)}")
    dt = VARIANTS[name]
    if any(t.dtype != dt or t.shape != x.shape or t.device != x.device
           for t in (x, y, a)):
        raise ValueError(f"{name}: x, y and a must be {dt} tensors of one "
                         f"shape on one device")
    if x.device.type == "cpu":
        return step_plain(name, x, y, a, chain)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    # the kernel reads and writes 16 bytes at a time from 16-byte aligned
    # arrays
    x, y, a = (t.contiguous() for t in (x, y, a))
    x, y, a = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, y, a))
    xo, yo = torch.empty_like(x), torch.empty_like(y)
    K.DTYPE_MICRO(x.device, x.data_ptr(), y.data_ptr(), a.data_ptr(),
                  xo.data_ptr(), yo.data_ptr(), x.numel(), chain,
                  list(VARIANTS).index(name))
    return xo, yo


def rate(name: str, B: int, L: int, seconds: float) -> str:
    """The JAX tool's rate line of a variant."""
    if name == "swar":
        g = B * L * CHAIN * RATE_OPS * SWAR_FIELDS / seconds / 1e9
        return f"swar   4x8-in-32 {g:10.2f} Gfield-op/s"
    g = B * L * CHAIN * RATE_OPS / seconds / 1e9
    return f"native {name:9s} {g:10.2f} Gelem-op/s"


def time_variants(B: int, L: int, dev, iters: int = ITERS
                  ) -> Dict[str, float]:
    """Seconds a call of each variant: the mean of iters launches after a
    warm one ([events] on the card)."""
    res = {}
    for name, arrays in inputs(B, L).items():
        x, y, a = tensors(name, arrays, dev)
        step(name, x, y, a)
        res[name] = _micro.events_s(lambda: step(name, x, y, a), dev,
                                    n=iters, reps=1)
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _micro.add_device_arg(ap)
    args = ap.parse_args(argv)
    B, L = SHAPE
    dev = _micro.get_device(args.device)
    clk = _micro.clock(dev, "events")
    print(f"# dtype_micro on {_micro.describe(dev)}: shape=({B},{L}) "
          f"chain={CHAIN}", flush=True)
    for name, t in time_variants(B, L, dev).items():
        print(f"{rate(name, B, L, t)} ({t * 1e3:.4f} ms/call) [{clk}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
