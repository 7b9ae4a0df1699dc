// Backtrack of the profile DP direction plane, for Hopper.
//
// Replaces the Pallas TPU kernel tidehunter_tpu/ops/msa_device.py::
// _make_bt_kernel (full and banded variants).  The TPU kernel walks every
// problem in lockstep over levels L = j + c from 2T down, one dirs row per
// grid step; here each problem walks its own path through the plane, which
// visits exactly the levels the lockstep walk activates for that problem,
// in the same order.
//
// Outputs per problem b, bit-identical with the TPU kernel:
//   ops[b, NL-1-m] = m-th emitted op (0 M, 1 I, 2 D; unused lanes 3), so
//                    lanes [NL - nst, NL) read left to right are the
//                    forward alignment (update_step reads this layout);
//   nst[b]         = number of steps;
//   tch[b]         = 1 when a visited position (j, c) has |c - j| >= wb - 8
//                    (banded only, wb = W - 8), else 0.
// The mode machine (runs commit to a gap track at entry; M over I over D)
// follows msa_device.py:539-573.  At a boundary (j == 0 or c == 0) the op
// is forced and no direction byte is read; a cell whose lane lies outside
// the band window reads as 0, as the TPU kernel's masked extract does.
//
// What bounds it: one chain a problem.  A path has max(qlen, ncol) to
// qlen + ncol steps (~450 on the T = 640 regions of the default path),
// each needing one direction byte that depends on the previous step, and
// the plane ([2T-1, B, W], 84 MB at T=640 W=128 B=512) does not fit in the
// 50 MB L2, so a walk that loads its bytes one at a time from device
// memory pays a device-memory latency a step.  With the bytes in shared
// memory (below) a step costs ~160 ns on the H100 (PERF.md): its
// ~110 SASS instructions, issued by one warp.
//
// The design: one warp per problem, BT_WARPS problems a CTA, so B = 512
// spreads over every SM.  Every step lowers r = j + c - 2 by 1 or 2 and c
// by 0 or 1, so the walk stays KR steps at most in any block of KR rows.
// The warp copies the plane to shared memory in tiles of KR rows: whole
// band rows (W bytes) on the band rungs, and at full width a FULL_TW =
// 128-lane window of each row.  A ring of NTILE tiles (RING rows: row r at
// ring row (R0 - r) mod RING, R0 the first row) holds the tile the walk is
// in and the next NTILE - 1, copied with cp.async, 16 bytes a lane: when
// the walk enters a tile, the slot of the tile it left is refilled with the
// tile NTILE - 1 further on, so a tile's device-memory latency is hidden
// behind the walk of the tiles before it.  A full-width window starts RING
// lanes left of the column at which the walk entered the tile NTILE - 1
// before it (the walk moves at most RING - 1 columns over NTILE tiles).
// All 32 lanes walk the same path from shared memory (no broadcast
// needed).  While the direction byte of cell (r, c) is loaded, the ring
// index of each of the three cells the step can go to (M: r - 2, c - 1;
// I: r - 1, c; D: r - 1, c - 1) is computed, and the byte's op only
// selects one, which keeps the address arithmetic off the step's chain.
// Lane 0 writes each op into a shared-memory copy of the output row,
// pre-filled with PAD, which the warp stores with 16-byte stores at the
// end.  The boundary steps (j == 0 or c == 0) read nothing;
// the warp writes them together after the walk.
//
// Not fused into the DP: three DP kernels write the plane (the band
// kernel, the strips and the first version), and at 84 MB a launch the plane leaves the SM
// and the L2 whichever kernel reads it back.  A 5 x 256-byte transition
// table in shared memory in place of the mode machine's logic measured
// slower at every checked shape (PERF.md) and is not used.

#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int OP_M = 0, OP_I = 1, OP_D = 2;
constexpr int BT_WARPS = 4;        // problems (warps) per CTA
constexpr int KR = 16;             // rows per tile
constexpr int NTILE = 4;           // tiles in the ring
constexpr int RING = KR * NTILE;   // rows in the ring (a power of two)
constexpr int FULL_TW = 128;       // lanes of a full-width tile row
constexpr int SMEM_MAX = 227 * 1024;

__device__ __forceinline__ int band_base(int r, int T, int W) {
  const int wb = W - 8;
  int base = ((r - wb) >> 1) - 2;
  base = base < T - W ? base : T - W;
  return base > 0 ? base : 0;
}

// First lane of a full-width window for the tile NTILE - 1 after the one
// entered at column c: covers lanes [c - RING, c - 1], 16-byte aligned,
// inside [0, T).
__device__ __forceinline__ int window(int c, int T) {
  const int lo = max(c - RING, 0) & ~15;
  return min(lo, T - FULL_TW);
}

// Tile k: rows (R0 - (k + 1) KR, R0 - k KR] of one problem, lanes
// [llo, llo + TW), into its ring slot; rows below 0 are skipped.  One
// commit group a tile.
__device__ __forceinline__ void load_tile(uint8_t* ring, const uint8_t* src,
                                          size_t row_stride, int R0, int k,
                                          int llo, int TW, int lane) {
  const int segs = TW >> 4;
  uint8_t* dst = ring + (size_t)(k % NTILE) * KR * TW;
  for (int i = lane; i < KR * segs; i += 32) {
    const int kk = i / segs, s = i - kk * segs;
    const int r = R0 - k * KR - kk;
    if (r >= 0)
      __pipeline_memcpy_async(dst + kk * TW + s * 16,
                              src + (size_t)r * row_stride + llo + s * 16,
                              16);
  }
  __pipeline_commit();
}

// One step of the mode machine from a direction byte: (sel, next mode).
// mode -1 fresh; 1/3 I run on track 1/2; 2/4 D run on track 1/2.
__device__ __forceinline__ int2 step(int mode, int val) {
  const int d = val & 3;
  const int icont1 = (val >> 2) & 1, fcont1 = (val >> 3) & 1;
  const int isel2 = (val >> 4) & 1, fsel2 = (val >> 5) & 1;
  const int icont2 = (val >> 6) & 1, fcont2 = (val >> 7) & 1;
  const bool in_run = mode > 0;
  const int sel = in_run ? ((mode & 1) ? OP_I : OP_D) : d;
  const int i_trk2 = in_run ? (mode == 3) : isel2;
  const int d_trk2 = in_run ? (mode == 4) : fsel2;
  const int icont = i_trk2 ? icont2 : icont1;
  const int fcont = d_trk2 ? fcont2 : fcont1;
  int nmode;
  if (sel == OP_M)
    nmode = -1;
  else if (sel == OP_I)
    nmode = icont ? (i_trk2 ? 3 : 1) : -1;
  else
    nmode = fcont ? (d_trk2 ? 4 : 2) : -1;
  return make_int2(sel, nmode);
}

// Ring index of cell (r, c) (r >= rlo: the tile with window llo0, else
// the next one, window llo1); -1 when its lane lies outside the tile row,
// which reads as 0 (outside the band window).
__device__ __forceinline__ int ring_at(int r, int c, int R0, int T, int W,
                                       int TW, int rlo, int llo0, int llo1) {
  const int li = (c - 1) - (W ? band_base(r, T, W) : (r > rlo ? llo0 : llo1));
  return (unsigned)li < (unsigned)TW ? ((R0 - r) & (RING - 1)) * TW + li : -1;
}

__global__ void __launch_bounds__(BT_WARPS * 32) profile_bt_warp(
    const uint8_t* __restrict__ dirs, int B, int T, int W,
    const int* __restrict__ qlen_a, const int* __restrict__ ncol_a, int NL,
    int8_t* __restrict__ ops, int* __restrict__ nst,
    int* __restrict__ tch) {
  extern __shared__ uint4 smem_bt[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int bi = blockIdx.x * BT_WARPS + wid;
  if (bi >= B) return;                    // whole warps: no barrier follows
  const int TW = W ? W : FULL_TW;
  const int Wd = W ? W : T;
  const int wb = W - 8;
  const size_t row_stride = (size_t)B * Wd;
  const uint8_t* src = dirs + (size_t)bi * Wd;
  // per warp: the ring of RING x TW bytes, then the ops row
  uint8_t* ring = (uint8_t*)smem_bt + (size_t)wid * (RING * TW + NL);
  uint8_t* orow = ring + RING * TW;
  for (int i = lane; i < NL / 16; i += 32)
    reinterpret_cast<uint4*>(orow)[i] =
        make_uint4(0x03030303u, 0x03030303u, 0x03030303u, 0x03030303u);

  int j = qlen_a[bi], c = ncol_a[bi];
  const int R0 = j + c - 2;
  // the walk is in tile kt, rows (rlo, rlo + KR]; lw[i] is the window of
  // tile kt + i (full width)
  int kt = 0, rlo = R0 - KR;
  int lw[NTILE];
#pragma unroll
  for (int i = 0; i < NTILE; ++i) {
    lw[i] = W ? 0 : window(c, T);
    load_tile(ring, src, row_stride, R0, i, lw[i], TW, lane);
  }
  __pipeline_wait_prior(NTILE - 1);
  __syncwarp();

  int mode = -1, m = 0, touch = 0;
  int r = R0;
  int at = ring_at(r, c, R0, T, W, TW, rlo, lw[0], lw[1]);
  while (j > 0 && c > 0) {
    if (r <= rlo) {                       // entered tile kt + 1
      __pipeline_wait_prior(NTILE - 2);   // it landed (this lane's part)
      __syncwarp();                       // ... and every lane's; tile kt
                                          // is read no more
      ++kt;
      rlo -= KR;
#pragma unroll
      for (int i = 0; i < NTILE - 1; ++i) lw[i] = lw[i + 1];
      lw[NTILE - 1] = W ? 0 : window(c, T);
      load_tile(ring, src, row_stride, R0, kt + NTILE - 1, lw[NTILE - 1], TW,
                lane);
    }
    const int val = at >= 0 ? ring[at] : 0;
    // the three cells the step can go to, while the byte is in flight
    const int at_m = ring_at(r - 2, c - 1, R0, T, W, TW, rlo, lw[0], lw[1]);
    const int at_i = ring_at(r - 1, c, R0, T, W, TW, rlo, lw[0], lw[1]);
    const int at_d = ring_at(r - 1, c - 1, R0, T, W, TW, rlo, lw[0], lw[1]);
    if (W && abs(c - j) >= wb - 8) touch = 1;
    const int2 o = step(mode, val);
    if (lane == 0) orow[NL - 1 - m] = (uint8_t)o.x;
    mode = o.y;
    at = o.x == OP_M ? at_m : (o.x == OP_I ? at_i : at_d);
    r -= o.x == OP_M ? 2 : 1;
    if (o.x != OP_D) j -= 1;
    if (o.x != OP_I) c -= 1;
    ++m;
  }
  // the boundary: the rest of the path is forced, D along j == 0 or I
  // along c == 0, and |c - j| is largest at its first position
  const int rest = j + c;
  const uint8_t op = j == 0 ? OP_D : OP_I;
  for (int i = lane; i < rest; i += 32) orow[NL - 1 - m - i] = op;
  if (W && rest > 0 && rest >= wb - 8) touch = 1;
  m += rest;
  __pipeline_wait_prior(0);               // no copy outlives the warp
  __syncwarp();
  int8_t* dst = ops + (size_t)bi * NL;
  for (int i = lane; i < NL / 16; i += 32)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(orow)[i];
  if (lane == 0) {
    nst[bi] = m;
    tch[bi] = touch;
  }
}

}  // namespace

// dirs [2T-1, B, W or T] uint8 (W = 0: full width), qlen/ncol [B] int32;
// ops [B, NL] int8, nst/tch [B] int32.  The tiles and the ops row move in
// 16-byte pieces: a shape or pointer that does not allow it (T, W or NL
// not a multiple of 16, T < FULL_TW at full width, dirs or ops not
// 16-byte aligned) is refused with cudaErrorInvalidValue.
extern "C" int profile_bt(const void* dirs, int B, int T, int W,
                          const void* qlen, const void* ncol, int NL,
                          void* ops, void* nst, void* tch, void* stream) {
  if (((T | W | NL) & 15) || (!W && T < FULL_TW) ||
      (((uintptr_t)dirs | (uintptr_t)ops) & 15))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int TW = W ? W : FULL_TW;
  const size_t smem = (size_t)BT_WARPS * (RING * TW + NL);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        profile_bt_warp, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc) return rc;
  }
  profile_bt_warp<<<(B + BT_WARPS - 1) / BT_WARPS, BT_WARPS * 32, smem,
                    (cudaStream_t)stream>>>(
      (const uint8_t*)dirs, B, T, W, (const int*)qlen, (const int*)ncol, NL,
      (int8_t*)ops, (int*)nst, (int*)tch);
  return (int)cudaGetLastError();
}
