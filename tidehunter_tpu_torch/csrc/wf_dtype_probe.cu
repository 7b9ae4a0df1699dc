// Wavefront dtype probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of evals/wf_dtype_probe.py (make_kernel,
// launched by pl.pallas_call at :111): a _dp_row-shaped loop, the op mix
// of tidehunter_tpu/ops/wavefront.py:_dp_row (a roll of the previous row,
// compares, selects, adds, clamps), run over a [BT, T] tile for NR * 4
// rows with the state in one integer type.  It measures whether a narrow
// state type pays inside the wavefront's row structure.  Four variants,
// as in the JAX probe: int32 state / int32 lane index, int16 / int16,
// int16 / int32 and int8 / int32.
//
// Semantics kept exactly (the tests hold the plain version to the JAX
// kernel in interpret mode, and this source, compiled over
// tests/cuda_shim.h, and chip_smoke.py this kernel on the card, to the
// plain version): every op yields the state type and wraps after each op;
// the roll is a rotation, so lane 0 reads lane T-1 (masked for x and v,
// not for the query base taken from u); out accumulates on every lane of
// every row while u, v, x, y change only where lane <= row.
//
// The first version: a thread a lane, u, v and x of lane t-1 through
// two shared-memory rows ping-ponged, one __syncthreads() a row, BT = 128
// CTAs of 512 threads at the default T=512 BT=128: int32 0.1267 ms
// (0.5543 of its bound), int16 / int16 0.1578 ms (0.4449); on NVIDIA H100
// 80GB HBM3 at 700.00 W (PERF.md's kernel table).  Some 245 clocks a row
// against the ~140 that 512 lanes x 35 ops need at 128 int32 results a
// clock an SM: the barrier and the shared-memory round trip each row,
// with one CTA an SM and nothing to hide them behind.
//
// What bounds it: 35 integer ops per cell (counted below) against 2 x
// sizeof(state) bytes per cell of the tile read and written once per
// call, so operations bound it.  A scalar narrow type can only lose on
// CUDA cores (each op pays a sign extension to stay wrapped); the card's
// narrow lanes are packed: two 16-bit or four 8-bit fields in one 32-bit
// register.  So the narrow variants here step packed words, and their
// bound counts the 35 ops a 32-bit word: a cell costs 35 / 2 ops at int16
// and 35 / 4 at int8.
//
// Design, each choice measured on the card (PERF.md's findings):
// - Packed lanes.  A thread owns one 32-bit word: one int32 lane, or two
//   int16 or four int8 consecutive lanes.  On sm_90 every s16x2 op the
//   cell needs is one instruction (VIADD.16x2, VIMNMX.S16x2 / .U16x2, DPX
//   VIMNMX3 and VIADDMNMX.RELU); the SIMD compares (__vcmp*2) are five,
//   so the cell below is rewritten without them, into unsigned minima
//   and max / min identities; there is no 8-bit SIMD instruction, so
//   each s8x4 op is 5-6.  Selects are one LOP3.  The lane-index masks:
//   int16 / int16 compares packed 16-bit lane numbers with the row
//   (VIADD.16x2, then a sign-replicating PRMT); the .../i32iota variants
//   compare in 32 bits (a DPX clamp of row - lane, a funnel shift into a
//   field mask).
// - The roll inside a word is one PRMT, the word to its left the left
//   thread's u, v and x words of the last row from shared memory (a
//   double buffer).  Lane 0's rotation reads lane T-1: thread 0 reads the
//   word of lane T-1's thread with that lane's field shifted to the top,
//   and takes x 0 and v 2 (the JAX kernel's ti == 0 selects).
// - One __syncthreads() a row, as in the first version.  Without it the
//   warps form a ring (lane 0 reads lane T-1), each waiting on its left
//   neighbour's last row: with that wait in neighbour flags in shared
//   memory (a 64-bit slot of payload and row, spun on) or an mbarrier a
//   slot, the same schedule ran 1.7x and 1.4x slower at int32, since
//   every hop's wait adds to the row, where the barrier waits once.
//   Handing a thread's edge on by __shfl_up_sync (an edge word through
//   shared memory between warps) took 79 instructions a row at int32
//   against the 39 of this exchange.
// - Lanes a thread and threads a CTA: a word a thread, so at the default
//   T=512 BT=128 (a CTA an SM) 16, 8 and 4 warps for int32, int16 and
//   int8: four, two and one on each of the SM's 4 schedulers.  Two or
//   four words a thread measured slower at every type: fewer warps to
//   hide the cell's dependent chain and the barrier behind.
// - Ragged T: the fields of the last word past T-1 are padding, right of
//   lane T-1: they feed no real lane, reach no output (no store) and not
//   the rotation (lane T-1's own field is shifted up for lane 0).

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_lanes.cuh"

namespace {

constexpr int MAX_THREADS = 1024;   // T <= 1024 int32 lanes, a word a thread

// The ops of a cell on a word, by state type.  add wraps per field;
// max, min and max3 are signed per field; nz01 is 1 in each field that is
// not zero; z0_of(m) is 7 - 3m per field (m 0 or 1); relu_add(a, b) is
// max(a + b, 0), the add wrapped; roll(left, cur) is cur's fields moved up
// one, the lowest taking left's top field.
//
// int32 state: one lane a word, the compiler's own compares and selects
struct Ops32 {
  using S = int32_t;
  using W = int32_t;
  using M = bool;
  static constexpr int P = 1;
  static __device__ __forceinline__ W add(W a, W b) {
    return (W)((uint32_t)a + (uint32_t)b);
  }
  static __device__ __forceinline__ W sub(W a, W b) {
    return (W)((uint32_t)a - (uint32_t)b);
  }
  static __device__ __forceinline__ W max(W a, W b) { return a > b ? a : b; }
  static __device__ __forceinline__ W min(W a, W b) { return a < b ? a : b; }
  // the lane to the left: with one lane a word, the word to the left
  static __device__ __forceinline__ W roll(W left, W) { return left; }
};

// Two signed 16-bit fields in a word: Hopper has each op in one
// instruction (VIADD.16x2, VIMNMX.S16x2 / .U16x2, DPX VIMNMX3 and
// VIADDMNMX.RELU), every add wrapping per field.  Edge: u and v's top
// fields in one word, x's in the low half of another.
struct Ops16 {
  using S = int16_t;
  using W = uint32_t;
  using M = uint32_t;   // 0xFFFF in each field where true
  static constexpr int P = 2;
  static __device__ __forceinline__ W splat(int c) {
    return ((uint32_t)c & 0xFFFFu) * 0x00010001u;
  }
  static __device__ __forceinline__ W add(W a, W b) { return __vadd2(a, b); }
  static __device__ __forceinline__ W max(W a, W b) { return __vmaxs2(a, b); }
  static __device__ __forceinline__ W min(W a, W b) { return __vmins2(a, b); }
  static __device__ __forceinline__ W max3(W a, W b, W c) {
    return __vimax3_s16x2(a, b, c);
  }
  static __device__ __forceinline__ W nz01(W e) {
    return __vminu2(e, 0x00010001u);
  }
  static __device__ __forceinline__ W z0_of(W m) {
    return 0x00070007u - 3u * m;   // no field borrows: m <= 1
  }
  static __device__ __forceinline__ W relu_add(W a, W b) {
    return __viaddmax_s16x2_relu(a, b, 0x80008000u);
  }
  static __device__ __forceinline__ W sel(M m, W a, W b) {
    return (a & m) | (b & ~m);
  }
  static __device__ __forceinline__ W andc(W a, M m) { return a & ~m; }
  static __device__ __forceinline__ W roll(W left, W cur) {
    return __byte_perm(left, cur, 0x5432);
  }
};

// Four signed 8-bit fields in a word: the SIMD intrinsics, each wrapping
// per field (sm_90 has no 8-bit SIMD instruction: each is 5-6 32-bit
// instructions).
struct Ops8 {
  using S = int8_t;
  using W = uint32_t;
  using M = uint32_t;   // 0xFF in each field where true
  static constexpr int P = 4;
  static __device__ __forceinline__ W splat(int c) {
    return ((uint32_t)c & 0xFFu) * 0x01010101u;
  }
  static __device__ __forceinline__ W add(W a, W b) { return __vadd4(a, b); }
  static __device__ __forceinline__ W max(W a, W b) { return __vmaxs4(a, b); }
  static __device__ __forceinline__ W min(W a, W b) { return __vmins4(a, b); }
  static __device__ __forceinline__ W max3(W a, W b, W c) {
    return max(max(a, b), c);
  }
  static __device__ __forceinline__ W nz01(W e) {
    return __vcmpne4(e, 0u) & 0x01010101u;
  }
  static __device__ __forceinline__ W z0_of(W m) {
    return 0x07070707u - 3u * m;
  }
  static __device__ __forceinline__ W relu_add(W a, W b) {
    return __vmaxs4(__vadd4(a, b), 0u);
  }
  static __device__ __forceinline__ W sel(M m, W a, W b) {
    return (a & m) | (b & ~m);
  }
  static __device__ __forceinline__ W andc(W a, M m) { return a & ~m; }
  static __device__ __forceinline__ W roll(W left, W cur) {
    return __byte_perm(left, cur, 0x6543);
  }
};

// One word of one row.  ur, vr, xr: the previous row's u, v and x one
// lane to the left (the roll); isr: the lane is the row; le: lane <= row.
// Integer ops of the JAX cell, in source order: is_r, &3, qb, ==, s, y_b,
// u_b, ti==0, x_sh, v_sh, a, b, z, a>z, d, max, b>z, d, max, min, u_new,
// v_new, z-2, a2, b2, ti<r, mask, 4 state selects, 2 clamps, 2 out adds =
// 35.  The same function here, written for packed words and a short
// dependent chain (every identity exact under wrapping):
//   qb == tb   <=> ((ur & 3) ^ tb) == 0 where not is_r; true where it is
//   z0 = s + 6 =  7 - 3 [qb != tb]
//   z          =  min(max3(z0, a, b), 7) = max(min(max3(4, a, b), 7), z0),
//                 so the compare of qb waits for nothing but the roll
//   d          =  [zb != z1] + [zb != z0], zb = max3(z0, a, b),
//                 z1 = max(z0, a)
//   z - w      =  ~(w + ~z)                       (u_new, v_new)
//   max(a - (z - 2), 0) = relu((a + 3) + ~z)      (x, y)
// and the two ti == 0 selects ride in lane 0's left word.
template <class O>
struct Cell;

// int32: the JAX cell as written, which the compiler turns into compares,
// selects and min / max (DPX VIMNMX, VIADDMNMX) with no packing to undo
template <>
struct Cell<Ops32> {
  static __device__ __forceinline__ void step(int32_t& u, int32_t& v,
                                              int32_t& x, int32_t& y,
                                              int32_t& acc, int32_t tb,
                                              int32_t ur, int32_t vr,
                                              int32_t xr, bool isr,
                                              bool le) {
    using O = Ops32;
    const int32_t qb = isr ? tb : (ur & 3);
    const int32_t y_b = isr ? 0 : y;
    const int32_t u_b = isr ? 2 : u;
    const int32_t a = O::add(xr, vr);
    const int32_t b = O::add(y_b, u_b);
    int32_t z = qb == tb ? 7 : 4;   // s + 6
    int32_t d = a > z ? 1 : 0;
    z = O::max(z, a);
    if (b > z) d = 2;
    z = O::min(O::max(z, b), 7);
    const int32_t u_new = O::sub(z, vr);
    const int32_t z2 = O::sub(z, 2);
    if (le) {
      u = u_new;
      v = O::sub(z, u_b);
      x = O::max(O::sub(a, z2), 0);
      y = O::max(O::sub(b, z2), 0);
    }
    acc = O::add(O::add(acc, d), u_new);
  }
};

template <class O>
struct Cell {
  using W = typename O::W;
  using M = typename O::M;
  static __device__ __forceinline__ void step(W& u, W& v, W& x, W& y,
                                              W& acc, W tb, W ur, W vr,
                                              W xr, M isr, M le) {
    const W c2 = O::splat(2), c3 = O::splat(3), c4 = O::splat(4),
            c7 = O::splat(7);
    const W e = (ur & O::andc(c3, isr)) ^ O::andc(tb, isr);
    const W z0 = O::z0_of(O::nz01(e));
    const W y_b = O::andc(y, isr);
    const W u_b = O::sel(isr, c2, u);
    const W a = O::add(xr, vr);
    const W b = O::add(y_b, u_b);
    const W nz = ~O::max(O::min(O::max3(c4, a, b), c7), z0);
    const W zb = O::max3(z0, a, b);
    const W d = O::nz01(zb ^ O::max(z0, a)) + O::nz01(zb ^ z0);  // <= 2
    const W u_new = ~O::add(vr, nz);
    const W v_new = ~O::add(u_b, nz);
    u = O::sel(le, u_new, u);
    v = O::sel(le, v_new, v);
    x = O::sel(le, O::relu_add(O::add(a, c3), nz), x);
    y = O::sel(le, O::relu_add(O::add(b, c3), nz), y);
    acc = O::add(O::add(acc, d), u_new);
  }
};

// The lane masks of a thread's word at row r: is_r (lane == r) and
// lane <= r, by the variant's lane-index type.  lanes: the word's first
// lane.
struct MasksI32 {   // int32 state: int32 lane numbers, one a word
  int t;
  __device__ __forceinline__ explicit MasksI32(int lanes) : t(lanes) {}
  __device__ __forceinline__ void get(int r, bool& isr, bool& le) const {
    isr = t == r;
    le = t <= r;
  }
};

// int16 / int16: packed 16-bit lane numbers.  r - lane in each field (one
// VIADD.16x2 of the row and the negated lane numbers); its sign is lane >
// r, the sign of r - lane - 1 is lane >= r (one PRMT each)
struct MasksI16 {
  uint32_t niota;   // the word's negated lane numbers
  __device__ __forceinline__ explicit MasksI16(int lanes)
      : niota(((uint32_t)-lanes & 0xFFFFu) |
              ((uint32_t)(-lanes - 1) << 16)) {}
  static __device__ __forceinline__ uint32_t both(int v) {
    return ((uint32_t)v & 0xFFFFu) * 0x00010001u;
  }
  __device__ __forceinline__ void get(int r, uint32_t& isr,
                                      uint32_t& le) const {
    const uint32_t gt = field_signs16(__vadd2(both(r), niota));
    const uint32_t ge = field_signs16(__vadd2(both(r - 1), niota));
    le = ~gt;
    isr = ge & ~gt;
  }
};

// packed state, 32-bit lane numbers: the count of the word's lanes <= r
// (and < r), clamp(r - lane + 1, 0, P) in bits in one DPX op, shifted
// into a field mask
template <int P>
struct MasksWide {
  static constexpr int BITS = 32 / P;
  int first;
  __device__ __forceinline__ explicit MasksWide(int lanes) : first(lanes) {}
  __device__ __forceinline__ void get(int r, uint32_t& isr,
                                      uint32_t& le) const {
    const int e = (r - first + 1) * BITS;
    const unsigned n_le = (unsigned)__viaddmin_s32_relu(e, 0, 32);
    const unsigned n_lt = (unsigned)__viaddmin_s32_relu(e, -BITS, 32);
    le = __funnelshift_lc(0xFFFFFFFFu, 0u, n_le);
    isr = le ^ __funnelshift_lc(0xFFFFFFFFu, 0u, n_lt);
  }
};

// a word of the state type's fields from lanes t, t+1, ... (0 past T)
template <class O>
__device__ __forceinline__ typename O::W load_word(
    const typename O::S* row, int t, int T) {
  using W = typename O::W;
  if (O::P == 1) return t < T ? (W)row[t] : (W)0;
  uint32_t w = 0;
#pragma unroll
  for (int f = 0; f < O::P; ++f)
    if (t + f < T)
      w |= ((uint32_t)row[t + f] & (0xFFFFFFFFu >> (32 - 32 / O::P)))
           << (f * (32 / O::P));
  return (W)w;
}

template <class O>
__device__ __forceinline__ void store_word(typename O::S* row, int t, int T,
                                           typename O::W w) {
  using S = typename O::S;
#pragma unroll
  for (int f = 0; f < O::P; ++f)
    if (t + f < T) row[t + f] = (S)((uint32_t)w >> (f * (32 / O::P)));
}

// A 32-bit word a thread: one int32 lane, two int16 or four int8.  Row
// r: read the left thread's u, v and x words of row r-1 from shared memory
// (thread 0 reads lane T-1's thread's u, its field moved to the top, and
// takes v 2 and x 0 for lane 0), roll them into the word (one PRMT), step
// the cell, write the word's u, v and x into the other half of a
// double buffer, one barrier.  The double buffer lets a row's writes and
// the next row's reads share that one barrier.
template <class O, class Masks>
__global__ void __launch_bounds__(MAX_THREADS)
    wf_dtype_probe_kernel(const typename O::S* __restrict__ tb_g,
                          typename O::S* __restrict__ out_g, int T,
                          int n_rows) {
  using W = typename O::W;
  using M = typename O::M;
  constexpr int P = O::P, BITS = 32 / P;
  // words[(parity * 3 + c) * n + t]: u, v, x (c) of thread t at a row of
  // that parity
  extern __shared__ uint32_t words[];
  const int tid = thread_x(), n = blockDim.x;
  // lane 0's left lane is T-1: its thread, and the shift that moves its
  // field to the top of the word
  const int jT = (T - 1) / P, shT = BITS * (P - 1 - (T - 1) % P);
  const int left = tid == 0 ? jT : tid - 1;
  const W top2 = (W)(2u << (32 - BITS));   // v = 2 at lane 0
  const W tb = load_word<O>(tb_g + (size_t)blockIdx.x * T, tid * P, T);
  W u = 0, v = 0, x = 0, y = 0, acc = 0;
  const Masks masks(tid * P);
  for (int c = 0; c < 3; ++c) words[(3 + c) * n + tid] = 0u;   // row -1
  __syncthreads();
  for (int r = 0; r < n_rows; ++r) {
    const uint32_t* prv = words + ((r + 1) & 1) * 3 * n;
    W lu = (W)prv[left], lv = (W)prv[n + left], lx = (W)prv[2 * n + left];
    if (tid == 0) {
      lu = (W)((uint32_t)lu << shT);
      lv = top2;
      lx = (W)0;
    }
    M isr, le;
    masks.get(r, isr, le);
    Cell<O>::step(u, v, x, y, acc, tb, O::roll(lu, u), O::roll(lv, v),
                  O::roll(lx, x), isr, le);
    uint32_t* cur = words + (r & 1) * 3 * n;
    cur[tid] = (uint32_t)u;
    cur[n + tid] = (uint32_t)v;
    cur[2 * n + tid] = (uint32_t)x;
    __syncthreads();
  }
  store_word<O>(out_g + (size_t)blockIdx.x * T, tid * P, T, acc);
}

template <class O, class Masks>
int launch(const void* tb, void* out, int BT, int T, int n_rows,
           cudaStream_t stream) {
  const int threads = 32 * ((T + 32 * O::P - 1) / (32 * O::P));
  const size_t smem = sizeof(uint32_t) * 2 * 3 * threads;
  wf_dtype_probe_kernel<O, Masks><<<BT, threads, smem, stream>>>(
      (const typename O::S*)tb, (typename O::S*)out, T, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 int32/int32 iota, 1 int16/int16, 2 int16/int32, 3 int8/int32.
// tb and out: [BT, T] of the state type, 1 <= T <= 1024.
extern "C" int wf_dtype_probe(const void* tb, void* out, int BT, int T,
                              int n_rows, int variant, void* stream) {
  if (BT == 0) return 0;
  if (T < 1 || T > MAX_THREADS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0: return launch<Ops32, MasksI32>(tb, out, BT, T, n_rows, s);
    case 1: return launch<Ops16, MasksI16>(tb, out, BT, T, n_rows, s);
    case 2: return launch<Ops16, MasksWide<2>>(tb, out, BT, T, n_rows, s);
    case 3: return launch<Ops8, MasksWide<4>>(tb, out, BT, T, n_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
