// Profile Gotoh DP of one unit against the column profile, for Hopper.
//
// Replaces two Pallas TPU kernels of tidehunter_tpu/ops/msa_device.py:
//   W == 0: _make_dp_kernel / _dp_one_row                 (full width)
//   W  > 0: _make_dp_kernel_banded / _dp_one_row_banded   (|c-j| <= W-8)
// Anti-diagonal form: row r, lane t = column c - 1, unit index j - 1 =
// r - t.  Convex (dual-affine) gaps with two insertion tracks E1/E2 and two
// occupancy-weighted deletion tracks F1/F2, 5-way substitution per column.
// Each live cell writes one direction byte
//   sel | icont1<<2 | fcont1<<3 | isel2<<4 | fsel2<<5 | icont2<<6 | fcont2<<7
// into dirs[r, b, lane] with the JAX layouts: lane = t for the full kernel
// ([2T-1, B, T]) and lane = t - band_base(r) for the banded one
// ([2T-1, B, W]); dead lanes of a written row hold 0.  Rows at or past the
// problem's qlen + ncol - 1 are not written (the backtrack never reads
// them).  A live cell reads only live cells of rows r-1 and r-2 (or
// boundary values), and every live cell of a row lies at least two lanes
// inside its band window.
//
// Two kernels, chosen by shape in profile_dp() (dp_route), and a
// yardstick on no route (the first version):
//
// profile_dp_band (the band rungs W = 128, 256, 512 of every bucket): one
// region a CTA of W / 32 warps, one band lane a thread.  Lane l holds the
// cell at t = band_base(r) + l and the state of rows r-1 and r-2 in
// registers: H of rows r-1 and r-2 and E1, E2, F1, F2, G of row r-1, all
// in row r-1's window.  band_base steps by 0 or 1 a row, the same for the
// whole region, so row r's views of them (at t for H, E; at t-1 for G, F
// and H of row r-2) are shifts by one lane with __shfl_down_sync /
// __shfl_up_sync, a warp's edge words through shared memory, one barrier
// a row; the profile in shared memory by bulk copies (bulk_copy.cuh), no
// global load in the row loop.  The 4096 bucket's regions (3000 bp units,
// ~6000 rows) come a few a launch, so a region's row has to be short: W /
// 32 warps split it (PERF.md).
//
// profile_dp_strip (full width at every T, any other W): warps own fixed
// column strips.  Over absolute columns a
// cell reads only columns t and t-1 of rows r-1 and r-2, so the
// dependencies run left only, inside a band too, and no state ever
// shifts.  Warp w owns columns [32 L w, 32 L (w + 1)), lane k of it the L
// columns from t0 = 32 L w + L k (L = 4 up to T = 128, else 2), with H by
// row parity, E1, E2, F1, F2, G and the column weights wdel, wdel2 in
// registers, loaded once; sub sits in shared memory ([5][L][32] a warp:
// no bank conflict), read at the cell's unit code, and so does the unit,
// a lane's L codes read with two word loads and a funnel shift.  The left
// column comes by __shfl_up_sync inside the warp.  A region of T <= 32 L
// is one warp, four regions a CTA, no barrier.  Wider regions take T / 32
// L warps skewed by STRIP_S rows (warp w runs rows [(n - w) S, (n - w + 1)
// S) in round n), each reading its left column from a ring in its own
// shared memory that the warp on its left fills after every row, one
// barrier a round.  A region spans a thread-block cluster of up to 8 CTAs
// (the ring entries cross CTAs through distributed shared memory, the
// barrier is the cluster's) when one CTA would pass 512 threads, or hold
// more than 4 warps while the launch leaves SMs idle: the long-period
// buckets bring few regions a launch, and one SM a region would cap them
// at its issue rate.  Boundaries are initial state, not tests: a column's
// H starts at the j = 0 deletion row its top cell reads (NEG where the
// band's entry row cuts it), E, F, G at NEG, and a cell leaves its state
// alone unless it is live; only the band's exit cell (its (j, c-1)
// neighbour left the band) is a test.  A warp takes a row with every
// column live and no exit cell without any test, skips the cells of a row
// with no live column and writes its dead columns as 0; banded, it skips
// rows whose window misses its strip.
//
// profile_dp_kernel (the first version, on no route; entry point
// profile_dp_first, the yardstick chip_smoke.py times the routes
// against): one CTA per region, threads striding over the W (or T) lanes
// of the row, one __syncthreads() per anti-diagonal, the state rows in a
// shared-memory ring, two dependent global loads a cell (unit code, then
// sub).
//
// What bounds them: ~76-88 integer ops a cell, but every kernel here runs
// a row of one region on one or a few warps in order (PERF.md): issue at
// a low IPC, not the DP's dependent chain (~40 clocks a row).  On the
// H100 a row of one region at T = 4096, W = 256 costs 0.58 us on the first
// version (two dependent global loads a cell) and 0.24 us on the band
// kernel (~130 instructions on each of 8 warps, two a scheduler, and
// ~200 clocks of latency the row's barrier exposes).  The strips win
// where a region's row spreads over many SMs (full width: 1.2x at T =
// 128-640, 3-5x at 2048-4096).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int NEG = -(1 << 30);
// The widest profile, the largest MSA bucket (ops/msa_device.BUCKETS): the
// entry points refuse wider ones before any access
constexpr int PROFILE_DP_MAX_T = 4096;

struct Costs {
  int oi, ei, od, oi2, ei2, od2;
};

__device__ __forceinline__ int band_base(int r, int T, int W) {
  const int wb = W - 8;
  int base = ((r - wb) >> 1) - 2;
  base = base < T - W ? base : T - W;
  return base > 0 ? base : 0;
}

__device__ __forceinline__ int ins0(int g, Costs k) {
  return max(-(k.oi + g * k.ei), -(k.oi2 + g * k.ei2));
}

__global__ void profile_dp_kernel(
    const uint8_t* __restrict__ unit, int LQ, const int* __restrict__ sub,
    const int* __restrict__ wl, const int* __restrict__ wdel,
    const int* __restrict__ wl2, const int* __restrict__ wdel2,
    const int* __restrict__ qlen_a, const int* __restrict__ ncol_a, int B,
    int T, int W, int R, Costs k, uint8_t* __restrict__ dirs) {
  extern __shared__ int smem[];
  const int bi = blockIdx.x;
  const int Wd = W ? W : T;       // lanes per dirs row
  const int wb = W - 8;           // half band (banded only)
  const int rm = R - 1;
  int* Hb = smem;                 // 3 rows (r % 3)
  int* E1b = Hb + 3 * R;          // 2 rows each (parity)
  int* E2b = E1b + 2 * R;
  int* F1b = E2b + 2 * R;
  int* F2b = F1b + 2 * R;
  int* Gb = F2b + 2 * R;
  for (int i = threadIdx.x; i < 13 * R; i += blockDim.x) smem[i] = NEG;
  __syncthreads();

  const int Lq = qlen_a[bi], Tn = ncol_a[bi];
  const uint8_t* ur = unit + (size_t)bi * LQ;
  const int* sr = sub + (size_t)bi * 5 * T;
  const int* wlr = wl + (size_t)bi * T;
  const int* wdr = wdel + (size_t)bi * T;
  const int* wl2r = wl2 + (size_t)bi * T;
  const int* wd2r = wdel2 + (size_t)bi * T;
  const int nrows = Lq + Tn - 1;
  const size_t row_stride = (size_t)B * Wd;

  for (int r = 0; r < nrows; ++r) {
    const int base = W ? band_base(r, T, W) : 0;
    const int cur = r & 1, prv = cur ^ 1;
    int* Hc = Hb + (r % 3) * R;
    const int* H1 = Hb + ((r + 2) % 3) * R;     // row r - 1
    const int* H2 = Hb + ((r + 1) % 3) * R;     // row r - 2
    uint8_t* drow = dirs + (size_t)r * row_stride + (size_t)bi * Wd;
    for (int l = threadIdx.x; l < Wd; l += blockDim.x) {
      const int ti = base + l;
      bool live = ti <= r && ti >= r - Lq + 1 && ti < Tn;
      const int off = 2 * ti - r;     // c - j of this cell
      if (W) live = live && abs(off) <= wb;
      if (!live) {
        drow[l] = 0;
        continue;
      }
      // predecessor band masks: out-of-band neighbours read as NEG
      const bool m_up = !W || abs(off + 1) <= wb;   // (j-1, c)
      const bool m_dl = !W || abs(off - 1) <= wb;   // (j, c-1)
      const int qb = ur[r - ti];
      const int s = sr[qb * T + ti];
      const int wl_t = wlr[ti], wl2_t = wl2r[ti];
      const int wl_sh = ti == 0 ? 0 : wlr[ti - 1];
      const int wl2_sh = ti == 0 ? 0 : wl2r[ti - 1];
      const int ic = ti & rm;
      const int il = (ti - 1) & rm;

      // M: H[j-1][c-1] at (r-2, t-1)
      int hm;
      if (ti == r)
        hm = ti == 0 ? 0 : max(-(k.od + wl_sh), -(k.od2 + wl2_sh));
      else if (ti == 0)
        hm = ins0(r, k);
      else
        hm = H2[il];
      const int M = hm + s;

      // E (insertion, consumes unit): (r-1, t)
      int h_up = ti == r ? max(-(k.od + wl_t), -(k.od2 + wl2_t)) : H1[ic];
      if (!m_up) h_up = NEG;
      const bool e_fresh = ti == r || !m_up;
      const int e_up = e_fresh ? NEG : E1b[prv * R + ic];
      const int e_open = h_up - k.oi - k.ei;
      const int e_cont = e_up - k.ei;
      const int E1 = max(e_open, e_cont);
      const int icont1 = e_cont > e_open;
      const int e2_up = e_fresh ? NEG : E2b[prv * R + ic];
      const int e2_open = h_up - k.oi2 - k.ei2;
      const int e2_cont = e2_up - k.ei2;
      const int E2 = max(e2_open, e2_cont);
      const int icont2 = e2_cont > e2_open;
      const int E = max(E1, E2);
      const int isel2 = E2 > E1;

      // F (deletion, consumes column): (r-1, t-1)
      int g_sh = ti == 0 ? ins0(r + 1, k) : Gb[prv * R + il];
      if (!m_dl) g_sh = NEG;
      const bool f_fresh = ti == 0 || !m_dl;
      const int f_sh = f_fresh ? NEG : F1b[prv * R + il];
      const int F1 = max(g_sh - k.od, f_sh) - wdr[ti];
      const int fcont1 = f_sh >= g_sh - k.od;
      const int f2_sh = f_fresh ? NEG : F2b[prv * R + il];
      const int F2 = max(g_sh - k.od2, f2_sh) - wd2r[ti];
      const int fcont2 = f2_sh >= g_sh - k.od2;
      const int F = max(F1, F2);
      const int fsel2 = F2 > F1;

      const int G = max(M, E);
      const int sel = F > G ? 2 : (E > M ? 1 : 0);
      Hc[ic] = max(G, F);
      E1b[cur * R + ic] = E1;
      E2b[cur * R + ic] = E2;
      F1b[cur * R + ic] = F1;
      F2b[cur * R + ic] = F2;
      Gb[cur * R + ic] = G;
      drow[l] = (uint8_t)(sel | (icont1 << 2) | (fcont1 << 3) |
                          (isel2 << 4) | (fsel2 << 5) | (icont2 << 6) |
                          (fcont2 << 7));
    }
    __syncthreads();
  }
}

constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------ strips --

constexpr int STRIP_S = 16;               // rows a warp runs between barriers
constexpr int STRIP_RB = 4 * STRIP_S;     // ring entries (>= 2 S + 2)
constexpr int STRIP_REGIONS = 4;          // regions a CTA, one warp each
constexpr int STRIP_THREADS = 512;        // most threads a CTA otherwise
constexpr int STRIP_CLUSTER = 8;          // most CTAs a region (portable)
constexpr int STRIP_SPREAD = 4;           // warps a CTA past which a launch
                                          // that leaves SMs idle spreads a
                                          // region over a cluster

// Bytes of the unit staged a region: code j at [T + 4 + j], 4 outside
// [0, qlen), so a lane's codes j = r - t0 - e lie inside for every row.
__host__ __device__ constexpr int strip_unit_bytes(int T, int LQ) {
  return (2 * T + LQ + 16 + 15) / 16 * 16;
}

// Columns [t0, t0 + L) of one row (L <= 4): the lane's direction bytes pk
// (byte e for column t0 + e) at dst[li], li = t0 minus the row's first
// lane, kept inside [0, n).
template <int L>
__device__ __forceinline__ void put_row(uint8_t* row, int li, int n,
                                        uint32_t pk) {
  uint8_t* dst = row + li;
  const bool whole = li >= 0 && li + L <= n && ((uintptr_t)dst % L) == 0;
  if (L == 4 && whole) {
    *reinterpret_cast<uint32_t*>(dst) = pk;
  } else if (L == 2 && whole) {
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)pk;
  } else {
#pragma unroll
    for (int e = 0; e < L; ++e)
      if (li + e >= 0 && li + e < n) dst[e] = (uint8_t)(pk >> (8 * e));
  }
}

// The per-row state of a lane's L columns: H by row parity (X: the values
// last written at a row of parity xpar, read at t-1 as row r-2 when r has
// that parity; Y: the other, row r-1), as the plain version's two H rows;
// E1, E2, F1, F2, G of the row above; the column deletion weights.
template <int L>
struct Strip {
  int X[L], Y[L], E1[L], E2[L], F1[L], F2[L], G[L], wd[L], wd2[L];
};

// One row of the lane's columns t0 + e, unit codes qw (byte e).  hl, gl,
// f1l, f2l: the column left of t0 (H of row r-2; G, F1, F2 of the row
// above).  EDGE: cells outside [lo, hi] keep their state and write 0, and
// the column tdl (the one whose (j, c-1) neighbour left the band) reads
// G, F as NEG.  Elements run right to left, so element e reads e - 1
// before its update.
template <int L, bool EDGE>
__device__ __forceinline__ void strip_row(Strip<L>& s, const int* subs,
                                          uint32_t qw, int t0, int lo, int hi,
                                          int tdl, int hl, int gl, int f1l,
                                          int f2l, Costs k, uint32_t& pk) {
#pragma unroll
  for (int e = L - 1; e >= 0; --e) {
    const int ti = t0 + e;
    // M: H[j-1][c-1] at (r-2, t-1); E's h_up: H[j-1][c] at (r-1, t)
    const int hm = e ? s.X[e - 1] : hl;
    int g = e ? s.G[e - 1] : gl;
    int f1 = e ? s.F1[e - 1] : f1l;
    int f2 = e ? s.F2[e - 1] : f2l;
    if (EDGE && ti == tdl) g = f1 = f2 = NEG;
    const int qb = (qw >> (8 * e)) & 0xff;                  // 0..4
    const int M = hm + subs[qb * 32 * L + e * 32];
    const int h_up = s.Y[e];

    // E (insertion, consumes unit): (r-1, t)
    const int e_cont = s.E1[e] - k.ei;
    const int nE1 = __viaddmax_s32(h_up, -(k.oi + k.ei), e_cont);
    const int icont1 = e_cont > h_up - k.oi - k.ei;
    const int e2_cont = s.E2[e] - k.ei2;
    const int nE2 = __viaddmax_s32(h_up, -(k.oi2 + k.ei2), e2_cont);
    const int icont2 = e2_cont > h_up - k.oi2 - k.ei2;
    const int E = max(nE1, nE2);
    const int isel2 = nE2 > nE1;

    // F (deletion, consumes column): (r-1, t-1)
    const int nF1 = __viaddmax_s32(g, -k.od, f1) - s.wd[e];
    const int fcont1 = f1 >= g - k.od;
    const int nF2 = __viaddmax_s32(g, -k.od2, f2) - s.wd2[e];
    const int fcont2 = f2 >= g - k.od2;
    const int F = max(nF1, nF2);
    const int fsel2 = nF2 > nF1;

    const int nG = max(M, E);
    const int sel = F > nG ? 2 : (E > M ? 1 : 0);
    const uint32_t d = sel | (icont1 << 2) | (fcont1 << 3) | (isel2 << 4) |
                       (fsel2 << 5) | (icont2 << 6) | (fcont2 << 7);
    if (EDGE && (ti < lo || ti > hi)) continue;
    s.X[e] = __vimax3_s32(nG, nF1, nF2);
    s.E1[e] = nE1;
    s.E2[e] = nE2;
    s.F1[e] = nF1;
    s.F2[e] = nF2;
    s.G[e] = nG;
    pk |= d << (8 * e);
  }
}

__device__ __forceinline__ void region_sync(int CL) {
  if (CL > 1)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
}

// One region's columns in strips of 32 L (L = 2 or 4): warp w of the
// region owns columns [32 L w, 32 L (w + 1)), lane k of it the L columns
// from t0 = 32 L w + k L.  SOLO: a region is one warp, STRIP_REGIONS
// regions a CTA, no barrier.  Otherwise a region is nw warps over CL CTAs
// (a thread-block cluster when CL > 1), warps skewed by STRIP_S rows: in
// round n warp w runs rows [(n - w) S, (n - w + 1) S), reading the column
// left of its strip from a ring its left neighbour fills (through
// distributed shared memory across CTAs), and the region syncs once a
// round.  Banded, a warp skips a row whose window misses its strip: no
// live cell, no byte to write, and no right neighbour reads the row (its
// first column is live at r + 1 only if the window at r reaches here).
template <int L, bool SOLO>
__global__ void __launch_bounds__(SOLO ? STRIP_REGIONS * 32 : STRIP_THREADS)
    profile_dp_strip(const uint8_t* __restrict__ unit, int LQ,
                     const int* __restrict__ sub, const int* __restrict__ wl,
                     const int* __restrict__ wdel,
                     const int* __restrict__ wl2,
                     const int* __restrict__ wdel2,
                     const int* __restrict__ qlen_a,
                     const int* __restrict__ ncol_a, int B, int T, int W,
                     int CL, Costs k, uint8_t* __restrict__ dirs) {
  static_assert(L == 2 || L == 4, "codes are read from a word");
  extern __shared__ int strip_s[];
  constexpr int SW = 32 * L;              // columns a warp
  constexpr int S = STRIP_S, RB = STRIP_RB;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwc = blockDim.x >> 5;        // warps a CTA
  const int rank = SOLO ? 0 : (int)(blockIdx.x % CL);
  const int bi = SOLO ? blockIdx.x * nwc + wid : blockIdx.x / CL;
  const int w = SOLO ? 0 : rank * nwc + wid;   // warp of the region
  const int nw = SOLO ? 1 : CL * nwc;
  if (SOLO && bi >= B) return;            // whole warps: no barrier follows
  // sub of each warp's columns, [5][L][32] (lane k's element e at e * 32 +
  // k: no bank conflict); each warp's ring of left columns; the unit
  int* subs = strip_s + wid * 5 * SW;
  int4* rings = reinterpret_cast<int4*>(strip_s + nwc * 5 * SW);
  int4* ring = rings + wid * RB;
  const int UB = strip_unit_bytes(T, LQ);
  uint8_t* us = reinterpret_cast<uint8_t*>(rings + (SOLO ? 0 : nwc * RB)) +
                (SOLO ? wid * UB : 0);
  int4* ring_out = nullptr;               // the right neighbour's ring
  if (!SOLO && w + 1 < nw) {
    if (wid + 1 < nwc)
      ring_out = ring + RB;
    else
      ring_out = cooperative_groups::this_cluster().map_shared_rank(
          rings, rank + 1);
  }

  const int Lq = qlen_a[bi], Tn = ncol_a[bi];
  const int nrows = Lq + Tn - 1;
  const int wb = W - 8;
  const int wlo = w * SW, whi = wlo + SW - 1;
  const int t0 = wlo + lane * L;
  const size_t ro = (size_t)bi * T;
  const uint8_t* ur = unit + (size_t)bi * LQ;
  const int UO = T + 4;                   // us[UO + j] = code j

  // H starts at what a column's first live cell reads above it: the j = 0
  // deletion row (full width, and band columns whose top cell lies in the
  // band), NEG where the band's entry row cuts the column; E, F, G at NEG
  Strip<L> s;
#pragma unroll
  for (int e = 0; e < L; ++e) {
    const int ti = t0 + e;
    const bool in = ti < T;
#pragma unroll
    for (int c = 0; c < 5; ++c)
      subs[c * SW + e * 32 + lane] = in ? sub[ro * 5 + (size_t)c * T + ti] : 0;
    s.wd[e] = in ? wdel[ro + ti] : 0;
    s.wd2[e] = in ? wdel2[ro + ti] : 0;
    const int del = in ? max(-(k.od + wl[ro + ti]), -(k.od2 + wl2[ro + ti]))
                       : NEG;
    s.X[e] = s.Y[e] = (W && ti >= wb) ? NEG : del;
    s.E1[e] = s.E2[e] = s.F1[e] = s.F2[e] = s.G[e] = NEG;
  }
  {
    const int i0 = SOLO ? lane : threadIdx.x, di = SOLO ? 32 : blockDim.x;
    for (int i = i0; i < UB; i += di) {
      const int j = i - UO;
      us[i] = (j >= 0 && j < Lq) ? ur[j] : 4;
    }
  }
  if (!SOLO)
    for (int i = lane; i < RB; i += 32)
      ring[i] = make_int4(NEG, NEG, NEG, NEG);
  subs += lane;
  if (!SOLO) region_sync(CL);   // rings set, every CTA of the cluster running
  __syncwarp();

  const int rounds = nrows > 0 ? (nrows + (nw - 1) * S + S - 1) / S : 0;
  const size_t row_stride = (size_t)B * (W ? W : T);
  uint8_t* const dreg = dirs + (size_t)bi * (W ? W : T);
  // codes of row r: bytes [a, a + L) of us hold j = r - t0 - e reversed
  constexpr uint32_t rev = L == 4 ? 0x0123u : 0x01u;
  int xpar = 0;                           // the parity X holds
  for (int n = 0; n < rounds; ++n) {
    const int r0 = max((n - w) * S, 0);
    int r1 = min((n - w + 1) * S, nrows);
    // banded: base rises with r, so the round misses the strip when the
    // window of its last row ends left of it or that of its first row
    // starts right of it
    if (W && r0 < r1 &&
        (band_base(r1 - 1, T, W) + W <= wlo || band_base(r0, T, W) > whi))
      r1 = r0;
#pragma unroll 1
    for (int r = r0; r < r1; ++r) {
      int base = 0;
      if (W) {
        base = band_base(r, T, W);
        if (base + W <= wlo || base > whi) continue;
      }
      if ((r & 1) != xpar) {              // X and Y trade places
#pragma unroll
        for (int e = 0; e < L; ++e) {
          const int x = s.X[e];
          s.X[e] = s.Y[e];
          s.Y[e] = x;
        }
        xpar ^= 1;
      }
      // live cells: t <= r, r - t < qlen, t < ncol, |2t - r| <= wb
      int lo = max(r - Lq + 1, 0), hi = min(r, Tn - 1), tdl = -1;
      if (W) {
        lo = max(lo, (r - wb + 1) >> 1);
        hi = min(hi, (r + wb) >> 1);
        tdl = ((r - wb) & 1) ? -1 : (r - wb) >> 1;
      }
      uint32_t pk = 0;
      if (lo <= hi && lo <= whi && hi >= wlo) {
        uint32_t qw = 0x04040404u;
        if (t0 < T) {
          const int a = UO + r - t0 - (L - 1);
          const uint32_t* uw = reinterpret_cast<const uint32_t*>(us);
          qw = __byte_perm(
              __funnelshift_r(uw[a >> 2], uw[(a >> 2) + 1], 8 * (a & 3)), 0,
              rev);
        }
        // the column left of t0 before this row
        int hl = __shfl_up_sync(FULL, s.X[L - 1], 1);
        int gl = __shfl_up_sync(FULL, s.G[L - 1], 1);
        int f1l = __shfl_up_sync(FULL, s.F1[L - 1], 1);
        int f2l = __shfl_up_sync(FULL, s.F2[L - 1], 1);
        if (lane == 0) {
          if (w == 0) {                   // column 0: the insertion boundary
            hl = r ? ins0(r, k) : 0;
            gl = ins0(r + 1, k);
            f1l = f2l = NEG;
          } else {
            const int4 v = ring[(r - 1) & (RB - 1)];
            hl = v.x;
            gl = v.y;
            f1l = v.z;
            f2l = v.w;
          }
        }
        if (lo <= wlo && hi >= whi && (tdl < wlo || tdl > whi))
          strip_row<L, false>(s, subs, qw, t0, lo, hi, tdl, hl, gl, f1l, f2l,
                              k, pk);
        else
          strip_row<L, true>(s, subs, qw, t0, lo, hi, tdl, hl, gl, f1l, f2l,
                             k, pk);
      }
      put_row<L>(dreg + (size_t)r * row_stride, t0 - base, W ? W : T, pk);
      // the right neighbour reads this row's last column at row r + 1: H
      // of row r - 1 (parity of r + 1), G, F1, F2 of row r
      if (ring_out && lane == 31)
        ring_out[r & (RB - 1)] =
            make_int4(s.Y[L - 1], s.G[L - 1], s.F1[L - 1], s.F2[L - 1]);
    }
    if (!SOLO) region_sync(CL);
  }
}

// -------------------------------------------------------------- band --

constexpr int BAND_CHUNK = 256;           // profile columns a bulk copy

// Byte offsets of profile_dp_band's shared memory: the profile's planes
// [7][T] (sub 0..4, wdel, wdel2) at 0, the top boundary dels[T], the
// edge slots [2 rows][2 sides][NW] int4, one mbarrier a chunk of columns,
// then the unit's codes, code j at [W + j] and 4 outside [0, qlen): a
// lane's j = r - band_base(r) - l lies in (-W, max(LQ, T) + W].
struct BandLayout {
  int dels, slots, bars, unit, bytes;
};

__host__ __device__ inline BandLayout band_layout(int T, int LQ, int NW) {
  BandLayout l;
  l.dels = 7 * T * 4;
  l.slots = (l.dels + T * 4 + 15) / 16 * 16;
  l.bars = l.slots + 4 * NW * 16;
  l.unit = l.bars + (T + BAND_CHUNK - 1) / BAND_CHUNK * 8;
  l.bytes = (l.unit + 64 * NW + max(LQ, T) + 8 + 15) / 16 * 16;
  return l;
}

// One region a CTA of NW warps, W = 32 NW band lanes, one a thread: lane
// l = threadIdx.x holds the cell at t = band_base(r) + l, and the state of
// rows r-1 and r-2 in registers (H1, H2, E1, E2, F1, F2, G).  When band_base steps, H1, E1 and E2 move one lane down
// (__shfl_down_sync), else G, F1, F2 and H2 move one lane up
// (__shfl_up_sync); the lane at a warp's edge takes the neighbour warp's
// word from a slot in shared memory that the neighbour's edge lane wrote
// after the row before, double-buffered by row, so one __syncthreads() a
// row orders it.  The profile (sub, wdel, wdel2) comes into shared memory
// once, by bulk copies of BAND_CHUNK columns a plane, each chunk on its
// own mbarrier, and a row waits only for the chunk its window reaches;
// the top boundary (from wl, wl2) and the unit are staged by the threads.
// Each lane loads the next row's profile values before the barrier, so a
// row starts from registers.  Nothing is read from global memory inside
// the row loop, and a row's W direction bytes go out as one coalesced
// store of its W threads.
template <int NW>
__global__ void __launch_bounds__(32 * NW, 1) profile_dp_band(
    const uint8_t* __restrict__ unit, int LQ, const int* __restrict__ sub,
    const int* __restrict__ wl, const int* __restrict__ wdel,
    const int* __restrict__ wl2, const int* __restrict__ wdel2,
    const int* __restrict__ qlen_a, const int* __restrict__ ncol_a, int B,
    int T, Costs k, uint8_t* __restrict__ dirs) {
  extern __shared__ int4 band_s[];
  constexpr int W = 32 * NW;
  constexpr int wb = W - 8;               // half band
  const int l = threadIdx.x, lane = l & 31, w = l >> 5;
  const int bi = blockIdx.x;
  const BandLayout lay = band_layout(T, LQ, NW);
  char* const sm = reinterpret_cast<char*>(band_s);
  int* const prof = reinterpret_cast<int*>(sm);
  int* const dels = reinterpret_cast<int*>(sm + lay.dels);
  int4* const slots = reinterpret_cast<int4*>(sm + lay.slots);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(sm + lay.bars);
  uint8_t* const us = reinterpret_cast<uint8_t*>(sm + lay.unit);

  const int Lq = qlen_a[bi], Tn = ncol_a[bi];
  const size_t ro = (size_t)bi * T;
  const int* const sr = sub + ro * 5;
  // whole 16-byte pieces a plane and chunk: bulk copies, else loads
  const bool bulk =
      T % 4 == 0 &&
      (((uintptr_t)sub | (uintptr_t)wdel | (uintptr_t)wdel2) & 15) == 0;
  const int nch = (T + BAND_CHUNK - 1) / BAND_CHUNK;
  if (bulk && l == 0) {
    for (int c = 0; c < nch; ++c) mbar_init(bars + c, 1);
    mbar_fence_init();
    for (int c = 0; c < nch; ++c) {
      const int t0 = c * BAND_CHUNK;
      const unsigned n = 4u * (unsigned)min(BAND_CHUNK, T - t0);
      mbar_arrive_expect_tx(bars + c, 7 * n);
#pragma unroll
      for (int f = 0; f < 5; ++f)
        bulk_g2s(prof + f * T + t0, sr + f * T + t0, n, bars + c);
      bulk_g2s(prof + 5 * T + t0, wdel + ro + t0, n, bars + c);
      bulk_g2s(prof + 6 * T + t0, wdel2 + ro + t0, n, bars + c);
    }
  }
  if (!bulk) {
    for (int i = l; i < 5 * T; i += W) prof[i] = sr[i];
    for (int i = l; i < T; i += W) {
      prof[5 * T + i] = wdel[ro + i];
      prof[6 * T + i] = wdel2[ro + i];
    }
  }
  // the deletion of columns 0..t above the j == 1 row (top_del)
  for (int i = l; i < T; i += W)
    dels[i] = max(-(k.od + wl[ro + i]), -(k.od2 + wl2[ro + i]));
  const int ub = lay.bytes - lay.unit;
  for (int i = l; i < ub; i += W) {
    const int j = i - W;
    us[i] = (j >= 0 && j < Lq) ? unit[(size_t)bi * LQ + j] : 4;
  }
  for (int i = l; i < 4 * NW; i += W) slots[i] = make_int4(NEG, NEG, NEG, NEG);
  __syncthreads();

  const int nrows = Lq + Tn - 1;
  const size_t row_stride = (size_t)B * W;
  uint8_t* drow = dirs + (size_t)bi * W + l;
  int H1 = NEG, H2 = NEG, E1 = NEG, E2 = NEG, F1 = NEG, F2 = NEG, G = NEG;
  int hi = bulk ? 0 : T;                  // profile columns [0, hi) landed
  // this row's window and profile values (sub at its unit code, wdel,
  // wdel2), loaded a row ahead; row 0's window is [0, W)
  int base = 0, prev_base = 0;
  const uint8_t* const uc = us + W - l;   // code j = r - base - l: uc[r - base]
  int sv = 0, wd = 0, wd2 = 0;
  auto load = [&](int r1, int b1) {
    while (hi < b1 + W) {                 // a chunk every BAND_CHUNK / 2 rows
      mbar_wait(bars + hi / BAND_CHUNK, 0);
      hi += BAND_CHUNK;
    }
    const int* const pc = prof + b1 + l;
    sv = pc[uc[r1 - b1] * T];
    wd = pc[5 * T];
    wd2 = pc[6 * T];
  };
  if (nrows > 0) load(0, 0);
  int del_r = dels[0], del_rm1 = 0;       // row r's j == 1 boundary
  int ins_r = ins0(0, k);

#pragma unroll 2
  for (int r = 0; r < nrows; ++r, drow += row_stride) {
    const int4* const in = slots + ((r - 1) & 1) * 2 * NW;
    if (base != prev_base) {
      // the window moved right: row r's view of row r-1 at t
      int h = __shfl_down_sync(FULL, H1, 1);
      int e1 = __shfl_down_sync(FULL, E1, 1);
      int e2 = __shfl_down_sync(FULL, E2, 1);
      if (lane == 31 && w + 1 < NW) {
        const int4 v = in[w + 1];
        h = v.x;
        e1 = v.y;
        e2 = v.z;
      }
      H1 = h;
      E1 = e1;
      E2 = e2;
    } else {
      // row r's view of rows r-1 and r-2 at t-1
      int h2 = __shfl_up_sync(FULL, H2, 1);
      int g = __shfl_up_sync(FULL, G, 1);
      int f1 = __shfl_up_sync(FULL, F1, 1);
      int f2 = __shfl_up_sync(FULL, F2, 1);
      if (lane == 0 && w > 0) {
        const int4 v = in[NW + w - 1];
        h2 = v.x;
        g = v.y;
        f1 = v.z;
        f2 = v.w;
      }
      H2 = h2;
      G = g;
      F1 = f1;
      F2 = f2;
    }

    // the j == 1 boundary of row r + 1 (cell t == r + 1)
    const int del_n = dels[min(r + 1, T - 1)];
    const int ins_r1 = ins0(r + 1, k);

    // the cell (j, c) = (r - t + 1, t + 1) and its predecessors in the
    // band |c - j| <= wb: u = c - j + wb, the same for (j - 1, c) at u + 1
    // and for (j, c - 1) at u - 1
    const int ti = base + l;              // < T: the window lies in [0, T)
    const unsigned u = (unsigned)(2 * ti - r + wb);
    const bool live = u <= 2u * wb && (unsigned)(r - ti) < (unsigned)Lq &&
                      ti < Tn;
    const bool m_up = u + 1 <= 2u * wb;   // (j-1, c)
    const bool m_dl = u - 1 <= 2u * wb;   // (j, c-1)

    // M: H[j-1][c-1] at (r-2, t-1); E's h_up: H[j-1][c] at (r-1, t)
    const bool top = ti == r;
    const int hm = top ? del_rm1 : (ti == 0 ? ins_r : H2);
    int h_up = top ? del_r : H1;
    const int M = hm + sv;

    // E (insertion, consumes unit): (r-1, t)
    if (!m_up) h_up = NEG;
    const bool e_fresh = top || !m_up;
    const int e_cont = (e_fresh ? NEG : E1) - k.ei;
    const int nE1 = __viaddmax_s32(h_up, -(k.oi + k.ei), e_cont);
    const int icont1 = e_cont > h_up - k.oi - k.ei;
    const int e2_cont = (e_fresh ? NEG : E2) - k.ei2;
    const int nE2 = __viaddmax_s32(h_up, -(k.oi2 + k.ei2), e2_cont);
    const int icont2 = e2_cont > h_up - k.oi2 - k.ei2;
    const int E = max(nE1, nE2);
    const int isel2 = nE2 > nE1;

    // F (deletion, consumes column): (r-1, t-1)
    int g_sh = ti == 0 ? ins_r1 : G;
    if (!m_dl) g_sh = NEG;
    const bool f_fresh = ti == 0 || !m_dl;
    const int f_sh = f_fresh ? NEG : F1;
    const int nF1 = __viaddmax_s32(g_sh, -k.od, f_sh) - wd;
    const int fcont1 = f_sh >= g_sh - k.od;
    const int f2_sh = f_fresh ? NEG : F2;
    const int nF2 = __viaddmax_s32(g_sh, -k.od2, f2_sh) - wd2;
    const int fcont2 = f2_sh >= g_sh - k.od2;
    const int F = max(nF1, nF2);
    const int fsel2 = nF2 > nF1;

    const int nG = max(M, E);
    const int sel = F > nG ? 2 : (E > M ? 1 : 0);
    H2 = H1;
    H1 = __vimax3_s32(nG, nF1, nF2);
    E1 = nE1;
    E2 = nE2;
    F1 = nF1;
    F2 = nF2;
    G = nG;
    const uint32_t d = sel | (icont1 << 2) | (fcont1 << 3) | (isel2 << 4) |
                       (fsel2 << 5) | (icont2 << 6) | (fcont2 << 7);
    *drow = live ? (uint8_t)d : (uint8_t)0;
    del_rm1 = del_r;
    del_r = del_n;
    ins_r = ins_r1;
    // the next row's window and profile values
    prev_base = base;
    base = band_base(r + 1, T, W);
    load(r + 1, base);
    // the warp's edge words for row r + 1: its first lane's H1, E1, E2
    // (a right step), its last lane's H2, G, F1, F2 (no step)
    int4* const out = slots + (r & 1) * 2 * NW;
    if (lane == 0) out[w] = make_int4(H1, E1, E2, 0);
    if (lane == 31) out[NW + w] = make_int4(H2, G, F1, F2);
    __syncthreads();
  }
}

template <int NW>
int launch_band(const void* unit, int LQ, const void* sub, const void* wl,
                const void* wdel, const void* wl2, const void* wdel2,
                const void* qlen, const void* ncol, int B, int T, Costs k,
                void* dirs, cudaStream_t stream) {
  const int smem = band_layout(T, LQ, NW).bytes;
  auto kern = profile_dp_band<NW>;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
  }
  kern<<<B, 32 * NW, smem, stream>>>(
      (const uint8_t*)unit, LQ, (const int*)sub, (const int*)wl,
      (const int*)wdel, (const int*)wl2, (const int*)wdel2,
      (const int*)qlen, (const int*)ncol, B, T, k, (uint8_t*)dirs);
  return (int)cudaGetLastError();
}

// The band kernel at W = 128, 256 or 512 (4, 8 or 16 warps a region).
int launch_bands(const void* unit, int LQ, const void* sub, const void* wl,
                 const void* wdel, const void* wl2, const void* wdel2,
                 const void* qlen, const void* ncol, int B, int T, int W,
                 Costs k, void* dirs, cudaStream_t stream) {
  if (W == 128)
    return launch_band<4>(unit, LQ, sub, wl, wdel, wl2, wdel2, qlen, ncol,
                          B, T, k, dirs, stream);
  if (W == 256)
    return launch_band<8>(unit, LQ, sub, wl, wdel, wl2, wdel2, qlen, ncol,
                          B, T, k, dirs, stream);
  if (W == 512)
    return launch_band<16>(unit, LQ, sub, wl, wdel, wl2, wdel2, qlen, ncol,
                           B, T, k, dirs, stream);
  return (int)cudaErrorInvalidValue;
}

int ring_lanes(int T, int W) {
  const int need = W ? W + 2 : T;
  int R = 1;
  while (R < need) R <<= 1;
  return R;
}

int sm_count(int* sms) {
  int dev = 0;
  const int rc = (int)cudaGetDevice(&dev);
  return rc ? rc
            : (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                          dev);
}

template <int L, bool SOLO>
int launch_strip(const void* unit, int LQ, const void* sub, const void* wl,
                 const void* wdel, const void* wl2, const void* wdel2,
                 const void* qlen, const void* ncol, int B, int T, int W,
                 int sms, Costs k, void* dirs, cudaStream_t stream) {
  constexpr int SW = 32 * L;
  int CL = 1, nwc = STRIP_REGIONS, grid = (B + STRIP_REGIONS - 1) /
                                           STRIP_REGIONS;
  if (!SOLO) {
    // a cluster of CL CTAs a region while one CTA would pass
    // STRIP_THREADS, or STRIP_SPREAD warps in a launch that leaves SMs
    // idle; at most STRIP_CLUSTER
    const int nwr = (T + SW - 1) / SW;
    while (CL < STRIP_CLUSTER && 2 * CL <= nwr) {
      const int n = (nwr + CL - 1) / CL;
      if (n * 32 <= STRIP_THREADS && (n <= STRIP_SPREAD || B * CL >= sms))
        break;
      CL *= 2;
    }
    nwc = (nwr + CL - 1) / CL;   // <= 8 warps at T <= PROFILE_DP_MAX_T
    grid = B * CL;
  }
  const size_t smem =
      (size_t)nwc * (5 * SW * sizeof(int) +
                     (SOLO ? 0 : STRIP_RB * sizeof(int4))) +
      (size_t)(SOLO ? nwc : 1) * strip_unit_bytes(T, LQ);
  auto kern = profile_dp_strip<L, SOLO>;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(nwc * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  const int rc = (int)cudaLaunchKernelEx(
      &cfg, kern, (const uint8_t*)unit, LQ, (const int*)sub, (const int*)wl,
      (const int*)wdel, (const int*)wl2, (const int*)wdel2,
      (const int*)qlen, (const int*)ncol, B, T, W, CL, k, (uint8_t*)dirs);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// The strips: a region a warp of 4 columns a lane up to T = 128, else
// skewed warps of 2 columns a lane (fastest or within 1% of L = 1, 2 and
// 4 at every strip shape of chip_smoke.py: PERF.md, PR 5, call 3)
int launch_strips(const void* unit, int LQ, const void* sub, const void* wl,
                  const void* wdel, const void* wl2, const void* wdel2,
                  const void* qlen, const void* ncol, int B, int T, int W,
                  Costs k, void* dirs, cudaStream_t stream) {
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc) return rc;
  if (T <= 128)
    return launch_strip<4, true>(unit, LQ, sub, wl, wdel, wl2, wdel2, qlen,
                                 ncol, B, T, W, sms, k, dirs, stream);
  return launch_strip<2, false>(unit, LQ, sub, wl, wdel, wl2, wdel2, qlen,
                                ncol, B, T, W, sms, k, dirs, stream);
}

int launch_first(const void* unit, int LQ, const void* sub, const void* wl,
                 const void* wdel, const void* wl2, const void* wdel2,
                 const void* qlen, const void* ncol, int B, int T, int W,
                 Costs k, void* dirs, cudaStream_t stream) {
  const int R = ring_lanes(T, W);
  const size_t smem = (size_t)13 * R * sizeof(int);
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        profile_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc) return rc;
  }
  const int lanes = W ? W : T;
  int threads = ((lanes + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  profile_dp_kernel<<<B, threads, smem, stream>>>(
      (const uint8_t*)unit, LQ, (const int*)sub, (const int*)wl,
      (const int*)wdel, (const int*)wl2, (const int*)wdel2,
      (const int*)qlen, (const int*)ncol, B, T, W, R, k, (uint8_t*)dirs);
  return (int)cudaGetLastError();
}

// profile_dp's kernels, as ops/msa_device.DP_ROUTES names them
enum Route { ROUTE_STRIPS = 0, ROUTE_BAND = 1 };

// The band rungs W = 128, 256, 512 take the band kernel at every bucket
// (on the H100 it beat a warp-a-region kernel on every rung of every
// bucket at 8 and 256 regions a launch, and the strips at W = 512:
// PERF.md); full width and every other W take the strips.
int dp_route(int W) {
  return W == 128 || W == 256 || W == 512 ? ROUTE_BAND : ROUTE_STRIPS;
}

int launch_route(int route, const void* unit, int LQ, const void* sub,
                 const void* wl, const void* wdel, const void* wl2,
                 const void* wdel2, const void* qlen, const void* ncol,
                 int B, int T, int W, Costs k, void* dirs,
                 cudaStream_t st) {
  if (T > PROFILE_DP_MAX_T || W >= T) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  switch (route) {
    case ROUTE_BAND:
      return launch_bands(unit, LQ, sub, wl, wdel, wl2, wdel2, qlen, ncol,
                          B, T, W, k, dirs, st);
    case ROUTE_STRIPS:
      return launch_strips(unit, LQ, sub, wl, wdel, wl2, wdel2, qlen, ncol,
                           B, T, W, k, dirs, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// unit [B, LQ] uint8 (0..4), sub [B, 5, T], wl/wdel/wl2/wdel2 [B, T],
// qlen/ncol [B] int32; dirs [2T-1, B, W or T] uint8.  W = 0: full width.
extern "C" int profile_dp(const void* unit, int LQ, const void* sub,
                          const void* wl, const void* wdel, const void* wl2,
                          const void* wdel2, const void* qlen,
                          const void* ncol, int B, int T, int W, int oi,
                          int ei, int od, int oi2, int ei2, int od2,
                          void* dirs, void* stream) {
  return launch_route(dp_route(W), unit, LQ, sub, wl, wdel, wl2, wdel2,
                      qlen, ncol, B, T, W, Costs{oi, ei, od, oi2, ei2, od2},
                      dirs, (cudaStream_t)stream);
}

// profile_dp's kernel at band width W (0: full width), an index of
// ops/msa_device.DP_ROUTES (host query, no launch).
extern "C" int profile_dp_route(int W) { return dp_route(W); }

// One of profile_dp's kernels (route, a DP_ROUTES index) at any shape it
// takes (the band kernel W = 128, 256 or 512): the other route that
// chip_smoke.py times beside the one profile_dp picks.
extern "C" int profile_dp_on(int route, const void* unit, int LQ,
                             const void* sub, const void* wl,
                             const void* wdel, const void* wl2,
                             const void* wdel2, const void* qlen,
                             const void* ncol, int B, int T, int W, int oi,
                             int ei, int od, int oi2, int ei2, int od2,
                             void* dirs, void* stream) {
  return launch_route(route, unit, LQ, sub, wl, wdel, wl2, wdel2, qlen, ncol,
                      B, T, W, Costs{oi, ei, od, oi2, ei2, od2}, dirs,
                      (cudaStream_t)stream);
}

// The first version (profile_dp_kernel) at any shape: the yardstick that
// chip_smoke.py times the routes above against.
extern "C" int profile_dp_first(const void* unit, int LQ, const void* sub,
                                const void* wl, const void* wdel,
                                const void* wl2, const void* wdel2,
                                const void* qlen, const void* ncol, int B,
                                int T, int W, int oi, int ei, int od,
                                int oi2, int ei2, int od2, void* dirs,
                                void* stream) {
  if (T > PROFILE_DP_MAX_T) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return launch_first(unit, LQ, sub, wl, wdel, wl2, wdel2, qlen, ncol, B, T,
                      W, Costs{oi, ei, od, oi2, ei2, od2}, dirs,
                      (cudaStream_t)stream);
}
