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
// Two kernels, chosen by shape in profile_dp():
//
// profile_dp_warp (banded, W = 128, 256, 512, buckets T < 4096): one warp
// per region, DP_WARPS regions a CTA.  Lane k holds the window's band
// lanes [k L, k L + L), L = W / 32, in registers: H of rows r-1 and r-2
// and E1, E2, F1, F2, G of row r-1, all in row r-1's window, and the unit
// codes of row r's cells.  band_base steps by 0 or 1 a row, the same for
// the whole warp, so row r's views of them (at t for H, E; at t-1 for G,
// F and H of row r-2; the unit code one lane over) are register shifts by
// 0 or one lane across lane boundaries with __shfl_down_sync /
// __shfl_up_sync.  No barrier, no state in memory, no branch inside a row:
// a lane's L cells are independent chains.  Each lane stores its L
// direction bytes in one 32-, 64- or 128-bit store, so a row's W bytes go
// out coalesced.  The column profile the window covers is staged in a
// per-warp shared-memory ring, 32 columns at a time (measured faster than
// reading it through __ldg: PERF.md, PR 3).
//
// profile_dp_kernel (first version: full width, W = 0; the 4096 bucket;
// any other W): one CTA per region, threads striding over the W (or T)
// lanes of the row, one __syncthreads() per anti-diagonal.  The state rows
// sit in a shared-memory ring indexed by global lane & (R-1), R a power of
// two >= W + 2 (banded) or >= T (full).  H rotates over three rows; E1,
// E2, F1, F2 and G ping-pong by row parity.  13 rows x R x 4 B is at most
// 208 KB (full width at T = 4096).
//
// What bounds them: ~88 integer ops a cell, ~15 of them a dependent chain
// from one row to the next.  The warp kernel removes the barrier and the
// shared-memory round trips of the state; its parallelism is one warp per
// region, so it needs hundreds of regions a launch (the slice gives 512)
// and loses to the first version's W/32 warps per region when few come.
// The 4096 bucket (long periods: a few regions a batch, and 255 registers
// a thread at W = 512) keeps the first version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 30);

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

constexpr int DP_WARPS = 4;             // regions per CTA (warp kernel)
constexpr unsigned FULL = 0xffffffffu;

// x[e] <- x[e + 1] across the warp: the window moved one lane right.
template <int L>
__device__ __forceinline__ void shift_right(int (&x)[L]) {
  const int nxt = __shfl_down_sync(FULL, x[0], 1);
#pragma unroll
  for (int e = 0; e < L - 1; ++e) x[e] = x[e + 1];
  x[L - 1] = nxt;
}

// x[e] <- x[e - 1] across the warp: the view at t - 1.
template <int L>
__device__ __forceinline__ void shift_left(int (&x)[L]) {
  const int prv = __shfl_up_sync(FULL, x[L - 1], 1);
#pragma unroll
  for (int e = L - 1; e > 0; --e) x[e] = x[e - 1];
  x[0] = prv;
}

// The same on bytes packed four to a word (element e = byte e & 3 of word
// e >> 2); lane 0's first byte becomes `first`.
template <int NW>
__device__ __forceinline__ void shift_left_bytes(uint32_t (&w)[NW],
                                                 uint32_t first, int lane) {
  const uint32_t prv = __shfl_up_sync(FULL, w[NW - 1] >> 24, 1);
#pragma unroll
  for (int i = NW - 1; i > 0; --i) w[i] = (w[i] << 8) | (w[i - 1] >> 24);
  w[0] = (w[0] << 8) | (lane ? prv : first);
}

// Profile columns of one region: a per-warp ring of R = 2W columns in
// shared memory holds sub rows 0..4 and wdel, wdel2 of the window's columns
// [base - 1, base + W); wl, wl2 are read at the top boundary only.
struct Cols {
  const int *sub, *wl, *wl2, *wdel, *wdel2;
  int T;
  int* ring;              // [7][R] of this warp

  __device__ __forceinline__ int s(int qb, int tc, int R) const {
    return ring[qb * R + (tc & (R - 1))];
  }
  __device__ __forceinline__ int wd(int tc, int R) const {
    return ring[5 * R + (tc & (R - 1))];
  }
  __device__ __forceinline__ int wd2(int tc, int R) const {
    return ring[6 * R + (tc & (R - 1))];
  }
  // columns [hi, hi + 32) into the ring, one a lane
  __device__ __forceinline__ void stage(int hi, int lane, int R) const {
    const int tc = hi + lane;
    if (tc < T) {
      const int slot = tc & (R - 1);
#pragma unroll
      for (int f = 0; f < 5; ++f) ring[f * R + slot] = sub[f * T + tc];
      ring[5 * R + slot] = wdel[tc];
      ring[6 * R + slot] = wdel2[tc];
    }
  }
};

// The deletion of columns 0..t above the j == 1 row: H at (j - 1 = 0,
// c = t + 1), the same for every lane (read at t < T only).
__device__ __forceinline__ int top_del(const Cols& col, int t, Costs k) {
  const int tc = min(t, col.T - 1);
  return max(-(k.od + __ldg(col.wl + tc)), -(k.od2 + __ldg(col.wl2 + tc)));
}

template <int L>
__global__ void __launch_bounds__(DP_WARPS * 32) profile_dp_warp(
    const uint8_t* __restrict__ unit, int LQ, const int* __restrict__ sub,
    const int* __restrict__ wl, const int* __restrict__ wdel,
    const int* __restrict__ wl2, const int* __restrict__ wdel2,
    const int* __restrict__ qlen_a, const int* __restrict__ ncol_a, int B,
    int T, Costs k, uint8_t* __restrict__ dirs) {
  extern __shared__ int ring_s[];
  constexpr int W = 32 * L;
  constexpr int R = 2 * W;                // ring columns
  constexpr int wb = W - 8;               // half band
  const int lane = threadIdx.x & 31;
  const int bi = blockIdx.x * DP_WARPS + (threadIdx.x >> 5);
  if (bi >= B) return;                    // whole warps: no barrier follows

  const int Lq = qlen_a[bi], Tn = ncol_a[bi];
  const uint8_t* ur = unit + (size_t)bi * LQ;
  const size_t ro = (size_t)bi * T;
  const Cols col{sub + ro * 5, wl + ro, wl2 + ro, wdel + ro, wdel2 + ro, T,
                 ring_s + (threadIdx.x >> 5) * 7 * R};
  int hi = 0;                             // ring: columns [0, hi) loaded
  const int nrows = Lq + Tn - 1;
  const size_t row_stride = (size_t)B * W;

  // rows r-1 (H1, E*, F*, G) and r-2 (H2) in row r-1's window
  int H1[L], H2[L], E1[L], E2[L], F1[L], F2[L], G[L];
#pragma unroll
  for (int e = 0; e < L; ++e)
    H1[e] = H2[e] = E1[e] = E2[e] = F1[e] = F2[e] = G[e] = NEG;
  // unit codes of this row's cells (j - 1 = r - t); code 4 off the unit
  uint32_t qw[L / 4];
#pragma unroll
  for (int i = 0; i < L / 4; ++i) qw[i] = 0x04040404u;
  int prev_base = 0;
  // loaded a row ahead: the next unit code (index jn = r - base of the
  // next row that needs one) and row r's j == 1 boundary values
  int jn = 0;
  uint32_t qn = ur[0];
  int del_r = top_del(col, 0, k), del_rm1 = 0;

  for (int r = 0; r < nrows; ++r) {
    const int base = band_base(r, T, W);
    if (base != prev_base) {
      // the window moved right: row r's view of row r-1 at t; r - t is
      // unchanged at every band lane
      shift_right(H1);
      shift_right(E1);
      shift_right(E2);
    } else {
      // row r's view of rows r-1 and r-2 at t-1; r - t grew by one, so
      // each lane takes its left neighbour's unit code
      shift_left(G);
      shift_left(F1);
      shift_left(F2);
      shift_left(H2);
      shift_left_bytes(qw, qn, lane);     // r - base == jn
      ++jn;
      qn = jn < Lq ? ur[jn] : 4u;
    }
    prev_base = base;
    if (hi < base + W) {    // at most once every 32 rows
      // a slot is reloaded 2W - 32 columns after its last use
      __syncwarp();
      do {
        col.stage(hi, lane, R);
        hi += 32;
      } while (hi < base + W);
      __syncwarp();
    }

    // the j == 1 boundary of row r + 1 (cell t == r + 1)
    const int del_n = top_del(col, r + 1, k);
    const int ins_r = ins0(r, k), ins_r1 = ins0(r + 1, k);
    // the row's ranges of t: live cells (t <= r, r - t < qlen, t < ncol,
    // |2t - r| <= wb) and in-band predecessors (j-1, c): |2t - r + 1| <=
    // wb, and (j, c-1): |2t - r - 1| <= wb; ceil(x / 2) = (x + 1) >> 1
    const int live_lo = max(max(r - Lq + 1, (r - wb + 1) >> 1), 0);
    const int live_hi = min(min(r, Tn - 1), (r + wb) >> 1);
    const int up_lo = (r - wb) >> 1, up_hi = (r - 1 + wb) >> 1;
    const int dl_lo = (r + 2 - wb) >> 1, dl_hi = (r + 1 + wb) >> 1;

    // no branch below: every element of the lane is an independent chain
    uint32_t pk[L / 4];
#pragma unroll
    for (int w = 0; w < L / 4; ++w) pk[w] = 0;
#pragma unroll
    for (int e = 0; e < L; ++e) {
      const int ti = base + lane * L + e;   // < T: the window lies in [0, T)
      const bool live = ti >= live_lo && ti <= live_hi;
      // predecessor band masks: out-of-band neighbours read as NEG
      const bool m_up = ti >= up_lo && ti <= up_hi;     // (j-1, c)
      const bool m_dl = ti >= dl_lo && ti <= dl_hi;     // (j, c-1)
      const int qb = (qw[e >> 2] >> (8 * (e & 3))) & 0xff;   // 0..4
      const int s = col.s(qb, ti, R);
      const int wd = col.wd(ti, R);
      const int wd2 = col.wd2(ti, R);

      // M: H[j-1][c-1] at (r-2, t-1); E's h_up: H[j-1][c] at (r-1, t)
      const bool top = ti == r;
      const int hm = top ? del_rm1 : (ti == 0 ? ins_r : H2[e]);
      int h_up = top ? del_r : H1[e];
      const int M = hm + s;

      // E (insertion, consumes unit): (r-1, t)
      if (!m_up) h_up = NEG;
      const bool e_fresh = top || !m_up;
      const int e_cont = (e_fresh ? NEG : E1[e]) - k.ei;
      const int nE1 = __viaddmax_s32(h_up, -(k.oi + k.ei), e_cont);
      const int icont1 = e_cont > h_up - k.oi - k.ei;
      const int e2_cont = (e_fresh ? NEG : E2[e]) - k.ei2;
      const int nE2 = __viaddmax_s32(h_up, -(k.oi2 + k.ei2), e2_cont);
      const int icont2 = e2_cont > h_up - k.oi2 - k.ei2;
      const int E = max(nE1, nE2);
      const int isel2 = nE2 > nE1;

      // F (deletion, consumes column): (r-1, t-1)
      int g_sh = ti == 0 ? ins_r1 : G[e];
      if (!m_dl) g_sh = NEG;
      const bool f_fresh = ti == 0 || !m_dl;
      const int f_sh = f_fresh ? NEG : F1[e];
      const int nF1 = __viaddmax_s32(g_sh, -k.od, f_sh) - wd;
      const int fcont1 = f_sh >= g_sh - k.od;
      const int f2_sh = f_fresh ? NEG : F2[e];
      const int nF2 = __viaddmax_s32(g_sh, -k.od2, f2_sh) - wd2;
      const int fcont2 = f2_sh >= g_sh - k.od2;
      const int F = max(nF1, nF2);
      const int fsel2 = nF2 > nF1;

      const int nG = max(M, E);
      const int sel = F > nG ? 2 : (E > M ? 1 : 0);
      H2[e] = H1[e];
      H1[e] = __vimax3_s32(nG, nF1, nF2);
      E1[e] = nE1;
      E2[e] = nE2;
      F1[e] = nF1;
      F2[e] = nF2;
      G[e] = nG;
      const uint32_t d = sel | (icont1 << 2) | (fcont1 << 3) | (isel2 << 4) |
                         (fsel2 << 5) | (icont2 << 6) | (fcont2 << 7);
      pk[e >> 2] |= (live ? d : 0u) << (8 * (e & 3));
    }
    del_rm1 = del_r;
    del_r = del_n;
    uint8_t* dst = dirs + (size_t)r * row_stride + (size_t)bi * W + lane * L;
    if constexpr (L == 4)
      *reinterpret_cast<uint32_t*>(dst) = pk[0];
    else if constexpr (L == 8)
      *reinterpret_cast<uint2*>(dst) = make_uint2(pk[0], pk[1]);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  }
}

template <int L>
int launch_warp(const void* unit, int LQ, const void* sub, const void* wl,
                const void* wdel, const void* wl2, const void* wdel2,
                const void* qlen, const void* ncol, int B, int T, Costs k,
                void* dirs, cudaStream_t stream) {
  const size_t smem = (size_t)DP_WARPS * 7 * 2 * 32 * L * sizeof(int);
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        profile_dp_warp<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc) return rc;
  }
  profile_dp_warp<L><<<(B + DP_WARPS - 1) / DP_WARPS, DP_WARPS * 32, smem,
                       stream>>>(
      (const uint8_t*)unit, LQ, (const int*)sub, (const int*)wl,
      (const int*)wdel, (const int*)wl2, (const int*)wdel2,
      (const int*)qlen, (const int*)ncol, B, T, k, (uint8_t*)dirs);
  return (int)cudaGetLastError();
}

int ring_lanes(int T, int W) {
  const int need = W ? W + 2 : T;
  int R = 1;
  while (R < need) R <<= 1;
  return R;
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
  if (B == 0) return 0;
  const Costs k{oi, ei, od, oi2, ei2, od2};
  cudaStream_t st = (cudaStream_t)stream;
  // the band rungs below the 4096 bucket take the warp kernel
  if (T < 4096 && W == 128)
    return launch_warp<4>(unit, LQ, sub, wl, wdel, wl2, wdel2, qlen, ncol,
                          B, T, k, dirs, st);
  if (T < 4096 && W == 256)
    return launch_warp<8>(unit, LQ, sub, wl, wdel, wl2, wdel2, qlen, ncol,
                          B, T, k, dirs, st);
  if (T < 4096 && W == 512)
    return launch_warp<16>(unit, LQ, sub, wl, wdel, wl2, wdel2, qlen, ncol,
                           B, T, k, dirs, st);
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
  profile_dp_kernel<<<B, threads, smem, st>>>(
      (const uint8_t*)unit, LQ, (const int*)sub, (const int*)wl,
      (const int*)wdel, (const int*)wl2, (const int*)wdel2,
      (const int*)qlen, (const int*)ncol, B, T, W, R, k, (uint8_t*)dirs);
  return (int)cudaGetLastError();
}
