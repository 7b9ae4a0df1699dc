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
// the tool asks about.  So here it is one kernel, its CHAIN steps in
// registers.
//
// Semantics kept exactly (chip_smoke.py holds this kernel to the plain
// version in tidehunter_tpu_torch/evals/dtype_micro.py, the tests hold
// that version to the JAX step and this source, compiled over
// tests/cuda_shim.h, to the plain version): every integer op wraps to the
// element type (two's complement), the SWAR arithmetic wraps to 32 bits
// with an arithmetic right shift, bfloat16 rounds each op to nearest even.
//
// What bounds it: 5 ops a step (add, max, compare, sub, select) against 3
// inputs read and 2 outputs written once: operations, at the card's issue
// rate for the type's pipe.  The first version: a thread an element,
// the narrow types scalar, each op sign-extended to stay wrapped; at
// (512, 1024), 64 steps: int32 0.0102 ms (0.4916 of its bound), int16
// 0.0157 (0.3202), int8 0.0261 (0.1924), bfloat16 0.0117 (0.1338 of a
// tensor-core bound no elementwise op reaches); on NVIDIA H100 80GB HBM3
// at 700.00 W (PERF.md's kernel table).  A scalar narrow type can only
// lose there; the card's narrow lanes are packed.
//
// Design: a thread takes 16 bytes of each array (one 16-byte load and
// store each): four 32-bit words in registers, stepped as four
// independent chains for ILP, with the whole (512, 1024) int32 array in
// one wave of threads.  A word is one int32 or float32 element (int32's
// max(x + a, y) one DPX op), or two int16 elements stepped as an s16x2
// word, every op one instruction: the DPX __viaddmax_s16x2 is max(x + a,
// y); since x >= y after it, x > y is x != y, a field mask from an
// unsigned min (__vminu2) of x ^ y and 1; x - a is __vadd2 of x and -a,
// made once; the select one LOP3.  Four int8 elements step as an s8x4
// word (__vadd4, __vmaxs4, __vcmpgts4, __vsub4: sm_90 has no 8-bit SIMD
// instruction, each is 5-6), two bfloat16 elements as a __nv_bfloat162
// (__hadd2, __hmax2, __hgt2_mask, __hsub2, one instruction each), each
// op rounding as the scalar one does.  Every packed op wraps per field
// (no saturating form is used).  The 5 ops count a word for the bound,
// so a packed element costs 5 / 2 or 5 / 4.  A ragged tail (bytes not a
// multiple of 16) is read and written byte by byte by the last thread.
// SWAR keeps a thread an element: it is the JAX tool's own emulation, a
// separate question.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t H = 0x80808080u;    // the fields' guard (top) bits
constexpr uint32_t M7 = 0x7F7F7F7Fu;

// One step of one 32-bit word, per element type; prep(a) is a value of
// a the step reads, made once before the chain.
struct StepI32 {
  static __device__ __forceinline__ uint32_t prep(uint32_t a) { return a; }
  static __device__ __forceinline__ void step(uint32_t& x, uint32_t& y,
                                              uint32_t a, uint32_t) {
    const int32_t xn = __viaddmax_s32((int32_t)x, (int32_t)a, (int32_t)y);
    y = xn > (int32_t)y ? (uint32_t)xn - a : y;
    x = (uint32_t)xn;
  }
};

struct StepF32 {
  static __device__ __forceinline__ uint32_t prep(uint32_t a) { return a; }
  static __device__ __forceinline__ void step(uint32_t& x, uint32_t& y,
                                              uint32_t a, uint32_t) {
    const float af = __uint_as_float(a), yf = __uint_as_float(y);
    const float xn = fmaxf(__uint_as_float(x) + af, yf);
    y = xn > yf ? __float_as_uint(xn - af) : y;
    x = __float_as_uint(xn);
  }
};

// s16x2: x = max(x + a, y) is one DPX op; x >= y after it, so x > y is
// x != y: 1 in each field by an unsigned min, times 0xFFFF a field mask;
// x - a is x + (-a), -a made once
struct StepS16x2 {
  static __device__ __forceinline__ uint32_t prep(uint32_t a) {
    return __vsub2(0u, a);
  }
  static __device__ __forceinline__ void step(uint32_t& x, uint32_t& y,
                                              uint32_t a, uint32_t na) {
    x = __viaddmax_s16x2(x, a, y);
    const uint32_t gt = __vminu2(x ^ y, 0x00010001u) * 0xFFFFu;
    y = (__vadd2(x, na) & gt) | (y & ~gt);
  }
};

struct StepS8x4 {
  static __device__ __forceinline__ uint32_t prep(uint32_t a) { return a; }
  static __device__ __forceinline__ void step(uint32_t& x, uint32_t& y,
                                              uint32_t a, uint32_t) {
    x = __vmaxs4(__vadd4(x, a), y);
    const uint32_t gt = __vcmpgts4(x, y);
    y = (__vsub4(x, a) & gt) | (y & ~gt);
  }
};

struct StepBF16x2 {
  static __device__ __forceinline__ __nv_bfloat162 bf(uint32_t u) {
    __nv_bfloat162 h;
    memcpy(&h, &u, 4);
    return h;
  }
  static __device__ __forceinline__ uint32_t word(__nv_bfloat162 h) {
    uint32_t u;
    memcpy(&u, &h, 4);
    return u;
  }
  static __device__ __forceinline__ uint32_t prep(uint32_t a) { return a; }
  static __device__ __forceinline__ void step(uint32_t& x, uint32_t& y,
                                              uint32_t a, uint32_t) {
    const __nv_bfloat162 ah = bf(a), yh = bf(y);
    const __nv_bfloat162 xn = __hmax2(__hadd2(bf(x), ah), yh);
    const uint32_t gt = __hgt2_mask(xn, yh);
    y = (word(__hsub2(xn, ah)) & gt) | (y & ~gt);
    x = word(xn);
  }
};

// 16 bytes at p: one 16-byte load, or, past the end, the bytes there and
// zeros
__device__ __forceinline__ uint4 load16(const unsigned char* p, long left) {
  if (left >= 16) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < left) w[i / 4] |= (uint32_t)p[i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(unsigned char* p, long left,
                                        uint4 v) {
  if (left >= 16) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < left) p[i] = (unsigned char)(w[i / 4] >> (8 * (i % 4)));
}

template <class Step>
__global__ void __launch_bounds__(THREADS)
    packed_kernel(const unsigned char* __restrict__ x0,
                  const unsigned char* __restrict__ y0,
                  const unsigned char* __restrict__ a0,
                  unsigned char* __restrict__ xo,
                  unsigned char* __restrict__ yo, long nbytes, int chain) {
  const long off = ((long)blockIdx.x * THREADS + threadIdx.x) * 16;
  if (off >= nbytes) return;
  const long left = nbytes - off;
  const uint4 xv = load16(x0 + off, left), yv = load16(y0 + off, left),
              av = load16(a0 + off, left);
  uint32_t x[4] = {xv.x, xv.y, xv.z, xv.w};
  uint32_t y[4] = {yv.x, yv.y, yv.z, yv.w};
  const uint32_t a[4] = {av.x, av.y, av.z, av.w};
  uint32_t pa[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) pa[k] = Step::prep(a[k]);
#pragma unroll 4
  for (int s = 0; s < chain; ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) Step::step(x[k], y[k], a[k], pa[k]);
  }
  store16(xo + off, left, make_uint4(x[0], x[1], x[2], x[3]));
  store16(yo + off, left, make_uint4(y[0], y[1], y[2], y[3]));
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

template <class Step>
int launch(const void* x, const void* y, const void* a, void* xo, void* yo,
           long nbytes, int chain, cudaStream_t stream) {
  const long threads = (nbytes + 15) / 16;
  packed_kernel<Step><<<(int)((threads + THREADS - 1) / THREADS), THREADS,
                        0, stream>>>(
      (const unsigned char*)x, (const unsigned char*)y,
      (const unsigned char*)a, (unsigned char*)xo, (unsigned char*)yo,
      nbytes, chain);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 int32, 1 int16, 2 int8, 3 float32, 4 bfloat16, 5 SWAR (4 x
// 8-bit fields in int32).  x, y, a, xo, yo: n contiguous elements of the
// variant's type, each array at a 16-byte aligned address (else
// cudaErrorInvalidValue).
extern "C" int dtype_micro(const void* x, const void* y, const void* a,
                           void* xo, void* yo, int n, int chain, int variant,
                           void* stream) {
  if (n <= 0) return 0;
  static const int SIZE[] = {4, 2, 1, 4, 2, 4};
  if (variant < 0 || variant > 5) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)y | (uintptr_t)a | (uintptr_t)xo |
       (uintptr_t)yo) & 15)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long nbytes = (long)n * SIZE[variant];
  switch (variant) {
    case 0: return launch<StepI32>(x, y, a, xo, yo, nbytes, chain, s);
    case 1: return launch<StepS16x2>(x, y, a, xo, yo, nbytes, chain, s);
    case 2: return launch<StepS8x4>(x, y, a, xo, yo, nbytes, chain, s);
    case 3: return launch<StepF32>(x, y, a, xo, yo, nbytes, chain, s);
    case 4: return launch<StepBF16x2>(x, y, a, xo, yo, nbytes, chain, s);
    default:
      swar_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
          (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)a,
          (uint32_t*)xo, (uint32_t*)yo, n, chain);
      return (int)cudaGetLastError();
  }
}
