// Packed-lane and thread helpers that CUDA C++ has no intrinsic for.
//
// field_signs16(x): 0xFFFF in each 16-bit field of x whose sign bit is
// set, else 0: one PRMT in its sign-replicating mode (selector nibbles
// 0xb, 0x9 copy the top bit of bytes 3 and 1), which __byte_perm does not
// expose (it keeps 3 bits of each nibble).  The SIMD compares
// (__vcmplts2 and its kin) end in the same PRMT after four other
// instructions.
//
// thread_x(): threadIdx.x read once by a volatile move, so that the
// compiler keeps what is derived from it in registers instead of
// reading the special register again (an S2R, tens of clocks) inside a
// loop.
//
// tests/test_torch_csrc_shim.py runs the sources that include this
// header with its own model of each helper (tests/cuda_shim.h), held to
// NumPy's per-field definition there.

#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t field_signs16(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, 0xbb99;" : "=r"(r) : "r"(x));
  return r;
}

__device__ __forceinline__ int thread_x() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}
