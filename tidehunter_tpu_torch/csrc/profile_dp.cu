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
// them).
//
// Design: one CTA per region, threads striding over the W (or T) lanes of
// the row, one __syncthreads() per anti-diagonal.  A live cell reads only
// live cells of rows r-1 and r-2 (or boundary values), so the state rows
// sit in a shared-memory ring indexed by global lane & (R-1), R a power of
// two >= W + 2 (banded: the window slides at most one lane per row, so
// lanes of rows r-2..r never alias) or >= T (full).  H rotates over three
// rows; E1, E2, F1, F2 and G ping-pong by row parity.  13 rows x R x 4 B
// is at most 208 KB (full width at T = 4096).
//
// What bounds it: the row is a chain of ~60 dependent integer ops per
// lane plus a barrier, and a region is a single CTA, so the DP is
// latency-bound at small region counts and SM-bound once the batch covers
// the card.  Reading sub/wl/wdel straight from global memory (L1/L2
// resident per region) and keeping all state in shared memory is what this
// first version does; a tiled multi-region CTA is left for later.

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
  const Costs k{oi, ei, od, oi2, ei2, od2};
  profile_dp_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)unit, LQ, (const int*)sub, (const int*)wl,
      (const int*)wdel, (const int*)wl2, (const int*)wdel2,
      (const int*)qlen, (const int*)ncol, B, T, W, R, k, (uint8_t*)dirs);
  return (int)cudaGetLastError();
}
