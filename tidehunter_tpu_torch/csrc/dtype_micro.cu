// Element-type rate micro-benchmark for Hopper (sm_90a).
//
// Replaces the step of evals/dtype_micro.py, an XLA-fused loop (jitted
// jnp ops, not a Pallas kernel): CHAIN steps of the DP-core recurrence
//
//   x = max(x + a, y);  y = where(x > y, x - a, y)
//
// on every element of [B, L] arrays, at int32, int16, int8, float32 and
// bfloat16, plus the SWAR variant: four 8-bit fields in an int32, stepped
// as x = pmax(padd(x, a), y); y = pmax(x, y) with the JAX tool's
// guard-bit padd and borrow-detecting pmax (evals/dtype_micro.py:82-110).
// Under XLA the JAX step is one fused loop; eager torch ops would time
// 3 x CHAIN launches and the HBM traffic between them, not the ALU rate
// the tool asks about.  So here it is one kernel: a thread an element, its
// CHAIN steps in registers.
//
// Semantics kept exactly (chip_smoke.py holds this kernel to the plain
// version in tidehunter_tpu_torch/evals/dtype_micro.py, the tests hold
// that version to the JAX step): every integer op wraps to the element
// type (two's complement), the SWAR arithmetic wraps to 32 bits with an
// arithmetic right shift, bfloat16 rounds each op to nearest even.
//
// What bounds it: 5 ops an element a step (add, max, compare, sub,
// select; the narrow integer types add the sign extensions that keep each
// op wrapped, the SWAR step some 23 int32 ops) against 3 inputs read and 2
// outputs written once: operations, at the card's int32 (or fp32, bf16)
// issue rate, with one dependent chain a thread.  Packed 8- and 16-bit
// fields have instructions of their own on this card (__vadd4 /
// __vmaxs4, and Hopper's DPX __viaddmax_s16x2 family); this kernel
// measures the JAX tool's SWAR emulation only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t H = 0x80808080u;    // the fields' guard (top) bits
constexpr uint32_t M7 = 0x7F7F7F7Fu;

// integer types: each op in 32 bits, wrapped back to S
template <typename S>
struct IntOps {
  static __device__ __forceinline__ S add(S a, S b) {
    return (S)(uint32_t)((uint32_t)(int32_t)a + (uint32_t)(int32_t)b);
  }
  static __device__ __forceinline__ S sub(S a, S b) {
    return (S)(uint32_t)((uint32_t)(int32_t)a - (uint32_t)(int32_t)b);
  }
  static __device__ __forceinline__ S max(S a, S b) { return a > b ? a : b; }
  static __device__ __forceinline__ bool gt(S a, S b) { return a > b; }
};

struct FloatOps {
  static __device__ __forceinline__ float add(float a, float b) {
    return a + b;
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return a - b;
  }
  static __device__ __forceinline__ float max(float a, float b) {
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ bool gt(float a, float b) {
    return a > b;
  }
};

struct Bf16Ops {
  using S = __nv_bfloat16;
  static __device__ __forceinline__ S add(S a, S b) { return __hadd(a, b); }
  static __device__ __forceinline__ S sub(S a, S b) { return __hsub(a, b); }
  static __device__ __forceinline__ S max(S a, S b) { return __hmax(a, b); }
  static __device__ __forceinline__ bool gt(S a, S b) { return __hgt(a, b); }
};

template <typename S, typename Ops>
__global__ void __launch_bounds__(THREADS)
    native_kernel(const S* __restrict__ x0, const S* __restrict__ y0,
                  const S* __restrict__ a0, S* __restrict__ xo,
                  S* __restrict__ yo, int n, int chain) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  S x = x0[i], y = y0[i];
  const S a = a0[i];
  for (int s = 0; s < chain; ++s) {
    const S t = Ops::add(x, a);
    x = Ops::max(t, y);
    y = Ops::gt(x, y) ? Ops::sub(x, a) : y;
  }
  xo[i] = x;
  yo[i] = y;
}

__device__ __forceinline__ uint32_t pmax(uint32_t a, uint32_t b) {
  // per-field max by borrow detection: the top bit of each field of d
  // flags a_field >= b_field; the shift is arithmetic, as in the JAX tool
  const int32_t d = (int32_t)(((a | H) - (b & M7)) & H);
  const uint32_t sel = (uint32_t)(d >> 7) * 0xFFu;
  return (a & sel) | (b & ~sel);
}

__device__ __forceinline__ uint32_t padd(uint32_t a, uint32_t b) {
  // fields kept in [0, 127]: the guard bits masked, added, restored
  return (((a & M7) + (b & M7)) & M7) | ((a ^ b) & H);
}

__global__ void __launch_bounds__(THREADS)
    swar_kernel(const uint32_t* __restrict__ x0,
                const uint32_t* __restrict__ y0,
                const uint32_t* __restrict__ a0, uint32_t* __restrict__ xo,
                uint32_t* __restrict__ yo, int n, int chain) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t x = x0[i], y = y0[i];
  const uint32_t a = a0[i];
  for (int s = 0; s < chain; ++s) {
    x = pmax(padd(x, a), y);
    y = pmax(x, y);
  }
  xo[i] = x;
  yo[i] = y;
}

template <typename S, typename Ops>
int launch(const void* x, const void* y, const void* a, void* xo, void* yo,
           int n, int chain, cudaStream_t stream) {
  native_kernel<S, Ops><<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      (const S*)x, (const S*)y, (const S*)a, (S*)xo, (S*)yo, n, chain);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 int32, 1 int16, 2 int8, 3 float32, 4 bfloat16, 5 SWAR (4 x
// 8-bit fields in int32).  x, y, a, xo, yo: n contiguous elements of the
// variant's type.
extern "C" int dtype_micro(const void* x, const void* y, const void* a,
                           void* xo, void* yo, int n, int chain, int variant,
                           void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: return launch<int32_t, IntOps<int32_t>>(x, y, a, xo, yo, n,
                                                    chain, s);
    case 1: return launch<int16_t, IntOps<int16_t>>(x, y, a, xo, yo, n,
                                                    chain, s);
    case 2: return launch<int8_t, IntOps<int8_t>>(x, y, a, xo, yo, n, chain,
                                                  s);
    case 3: return launch<float, FloatOps>(x, y, a, xo, yo, n, chain, s);
    case 4: return launch<__nv_bfloat16, Bf16Ops>(x, y, a, xo, yo, n, chain,
                                                  s);
    case 5:
      swar_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
          (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)a,
          (uint32_t*)xo, (uint32_t*)yo, n, chain);
      return (int)cudaGetLastError();
    default: return (int)cudaErrorInvalidValue;
  }
}
