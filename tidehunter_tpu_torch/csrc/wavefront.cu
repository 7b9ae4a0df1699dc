// Wavefront affine-gap alignment kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tidehunter_tpu/ops/wavefront.py:
//   wf_global  <- _global_kernel / _global_row  (with_tl and iden-only)
//   wf_ext     <- _ext_kernel / _ext_row
// Both evaluate the Suzuki-Kasahara difference recurrence of ksw2 extz2
// (reference ksw2/ksw2_extz2_sse.c) with the same integer arithmetic and
// tie rules as the JAX kernels, so every output is bit-identical.
//
// wf_global: one warp per problem, WARPS problems a CTA.  Cell (i, t)
// (query i, target t) reads only (i-1, t), (i, t-1) and (i-1, t-1), and
// every boundary term is local to its row or column (i = 0, t = 0,
// i = jS), so any topological order gives the same integers.  Lane k owns
// C consecutive target columns of a 32*C-wide column tile and walks the
// query rows with a lag of k steps (the inter-thread wavefront of GPU
// Smith-Waterman codes): at step s it computes row i = s - k of its strip
// left to right, keeping the previous row's u, y and the M / I annotations
// of its C columns in registers.  The values of (i, t-1) and (i-1, t-1) at
// the strip's left edge (v, x and the D / M annotations) and the query
// base arrive from lane k-1 by __shfl_up_sync; there is no barrier and no
// state row in memory.  A target wider than 32*C runs tile after tile; a
// tile's right-edge column (v, x, a1, a0 per query row) goes to a buffer
// of qlen rows for the next tile's lane 0, in shared memory when WARPS of
// them fit, else in a global scratch the wrapper allocates.
//
// wf_ext (first version): one CTA per problem, threads striding over the
// live lanes [st0, en0] of each anti-diagonal r (lane t, query r - t), one
// __syncthreads() per anti-diagonal.  Rows read at lane t-1 (v, x, H)
// ping-pong by row parity, rows read only at their own lane (u, y) update
// in place; they live in dynamic shared memory when they fit (8 rows x T x
// 4 B; T <= 4096) and otherwise in a global scratch.
//
// What bounds them: integer operations, a chain of dependent ones per
// cell and no reuse for tensor cores.  wf_global keeps the chain per lane
// (C cells a step) and leaves the card's integer pipes to many warps;
// wf_ext's barrier per anti-diagonal makes short rows latency-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TLB = 14;                 // t_left field width (tl + 1)
constexpr int TLMASK = (1 << TLB) - 1;
constexpr int BESTR_UNSET = 0x7FFFFFF;
constexpr int WARPS = 4;                // wf_global problems per CTA
constexpr unsigned FULL = 0xffffffffu;

struct Scores {
  int match, mis, go, ge;
};

struct DiffRow {
  int u, v, x, y;     // new difference values of the cell
  int d;              // 0 = diagonal, 1 = E, 2 = F (ksw2 direction)
  bool bit08, bit10;  // E / F continuation
};

// One cell of _dp_row from its neighbours' difference values: u_b, y_b of
// the cell above (query - 1), v_sh, x_sh of the cell to the left
// (target - 1), boundary values already substituted.
__device__ __forceinline__ DiffRow diff_core(int qv, int tv, int u_b,
                                             int y_b, int v_sh, int x_sh,
                                             Scores sc) {
  const int QE2 = 2 * (sc.go + sc.ge);
  const int MAXSC = sc.match + QE2;
  const int s = (tv == 4 || qv == 4) ? -sc.ge : (tv == qv ? sc.match : sc.mis);
  const int a = x_sh + v_sh;
  const int b = y_b + u_b;
  int z = s + QE2;
  int d = a > z ? 1 : 0;
  z = max(z, a);
  if (b > z) d = 2;
  z = max(z, b);
  z = min(z, MAXSC);
  const int z2 = z - sc.go;
  const int a2 = a - z2;
  const int b2 = b - z2;
  DiffRow o;
  o.u = z - v_sh;
  o.v = z - u_b;
  o.x = max(a2, 0);
  o.y = max(b2, 0);
  o.d = d;
  o.bit08 = a2 > 0;
  o.bit10 = b2 > 0;
  return o;
}

// One cell of anti-diagonal r at lane ti: reads (r-1, t) in place (u, y)
// and (r-1, t-1) from the previous-parity rows (v, x).
__device__ __forceinline__ DiffRow diff_cell(
    int r, int ti, int qv, int tv, const int* U, const int* Y,
    const int* Vp, const int* Xp, Scores sc) {
  const int bq = r > 0 ? sc.go : 0;
  const bool is_r = ti == r;
  return diff_core(qv, tv, is_r ? bq : U[ti], is_r ? 0 : Y[ti],
                   ti == 0 ? bq : Vp[ti - 1], ti == 0 ? 0 : Xp[ti - 1], sc);
}

template <bool WITH_TL, int C>
__global__ void __launch_bounds__(WARPS * 32) wf_global_kernel(
    const uint8_t* __restrict__ q, int LQ, const uint8_t* __restrict__ t,
    int T, const int* __restrict__ qlen_a, const int* __restrict__ tlen_a,
    const int* __restrict__ qle_a, int B, Scores sc,
    int* __restrict__ iden_out, int* __restrict__ tleft_out,
    int4* __restrict__ edge_g) {
  extern __shared__ int4 edge_s[];
  constexpr int TW = 32 * C;            // columns of one tile
  const int lane = threadIdx.x & 31;
  const int bi = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (bi >= B) return;                  // whole warps: no barrier follows
  int4* edge = edge_g ? edge_g + (size_t)bi * LQ
                      : edge_s + (size_t)(threadIdx.x >> 5) * LQ;

  const int qlen = qlen_a[bi], tlen = tlen_a[bi], qle = qle_a[bi];
  const uint8_t* qr = q + (size_t)bi * LQ;
  const uint8_t* tr = t + (size_t)bi * T;
  // backtrack_left_end split: the step consuming query index qlen-qle
  // (qle == 0: the last query-consuming step)
  const int jS = qlen - max(qle, 1);
  const bool has_q = qle > 0;
  const int tl_bound = (tlen + 1) & TLMASK;

  for (int t0 = 0; t0 < tlen; t0 += TW) {
    const bool last = t0 + TW >= tlen;
    const int c0 = t0 + lane * C;                 // first column of the strip
    const int nl = min(31, (tlen - 1 - t0) / C);  // last lane with a column
    // the strip's target codes, four to a register (4 past tlen: those
    // columns are computed but never reach a live one)
    uint32_t tp[C / 4];
#pragma unroll
    for (int w = 0; w < C / 4; ++w) {
      uint32_t p = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int tc = c0 + 4 * w + b;
        p |= (uint32_t)(tc < tlen ? tr[tc] : 4) << (8 * b);
      }
      tp[w] = p;
    }
    // row i = -1: the i = 0 boundary (u = bq, y = 0, P_I = 0, P_M = 0)
    int U[C], Y[C], A0[C], A2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      U[c] = c0 + c > 0 ? sc.go : 0;
      Y[c] = 0;
      A0[c] = 0;
      A2[c] = 0;
    }
    // left edge at (i, c0 - 1): v, x, a1, a0; dg = a0 at (i - 1, c0 - 1)
    int l_v = 0, l_x = 0, l_a1 = 0, l_a0 = 0, dg = 0;
    int qv = 4;
    for (int s = 0; s < qlen + nl; ++s) {
      const int i = s - lane;
      if (lane == 0) {
        qv = s < qlen ? qr[s] : 4;
        if (t0 == 0) {              // the t = 0 boundary
          l_v = i > 0 ? sc.go : 0;
          l_x = 0;
          l_a1 = WITH_TL && jS <= i ? tl_bound : 0;
          dg = WITH_TL && i > 0 && jS <= i - 1 ? tl_bound : 0;
        } else if (s < qlen) {      // the previous tile's right edge
          const int4 e = edge[s];
          l_v = e.x;
          l_x = e.y;
          l_a1 = e.z;
          l_a0 = e.w;
        }
      }
      int vl = l_v, xl = l_x, a1l = l_a1;
      if (i >= 0 && i < qlen && c0 < tlen) {
        int dgl = dg;
        int res = 0;                    // a0 at (i, tlen - 1)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int tc = c0 + c;
          const int tv = (tp[c >> 2] >> (8 * (c & 3))) & 0xff;
          const DiffRow o = diff_core(qv, tv, U[c], Y[c], vl, xl, sc);
          const int eq = qv == tv ? 1 : 0;
          int M_step, I_step;
          if (WITH_TL) {
            const bool is_jS = i == jS;
            const int set_m =
                ((has_q ? tlen - tc : tlen - 1 - tc) + 1) & TLMASK;
            const int set_i =
                ((has_q ? tlen - tc - 1 : tlen - 1 - tc) + 1) & TLMASK;
            M_step = (((dgl >> TLB) + eq) << TLB) |
                     (is_jS ? set_m : (dgl & TLMASK));
            I_step = (A2[c] & ~TLMASK) | (is_jS ? set_i : (A2[c] & TLMASK));
          } else {
            M_step = dgl + eq;
            I_step = A2[c];
          }
          const int D_step = a1l;
          const int a0 = o.d == 0 ? M_step : (o.d == 1 ? D_step : I_step);
          dgl = A0[c];
          U[c] = o.u;
          Y[c] = o.y;
          A0[c] = a0;
          A2[c] = o.bit10 ? I_step : a0;
          vl = o.v;
          xl = o.x;
          a1l = o.bit08 ? D_step : a0;
          if (tc == tlen - 1) res = a0;
        }
        if (i == qlen - 1 && tlen - 1 < c0 + C) {   // the strip ends it
          if (WITH_TL) {
            iden_out[bi] = res >> TLB;
            tleft_out[bi] = qle > qlen ? tlen : (res & TLMASK) - 1;
          } else {
            iden_out[bi] = res;
            tleft_out[bi] = 0;
          }
        }
        if (!last && lane == 31) edge[i] = make_int4(vl, xl, a1l, A0[C - 1]);
      }
      // lane k + 1 computes row i at step s + 1
      dg = l_a0;
      l_v = __shfl_up_sync(FULL, vl, 1);
      l_x = __shfl_up_sync(FULL, xl, 1);
      l_a1 = __shfl_up_sync(FULL, a1l, 1);
      l_a0 = __shfl_up_sync(FULL, A0[C - 1], 1);
      qv = __shfl_up_sync(FULL, qv, 1);
    }
    __syncwarp();   // the tile's edge column, before the next tile reads it
  }
}

__global__ void wf_ext_kernel(
    const uint8_t* __restrict__ q, int LQ, const uint8_t* __restrict__ t,
    int T, const int* __restrict__ qlen_a, const int* __restrict__ tlen_a,
    Scores sc, int* __restrict__ besth, int* __restrict__ bestr,
    int* __restrict__ score, int* __restrict__ scratch) {
  extern __shared__ int smem[];
  const int bi = blockIdx.x;
  int* buf = scratch ? scratch + (size_t)bi * 8 * T : smem;
  int* U = buf;             // in place
  int* Y = U + T;           // in place
  int* V = Y + T;           // 2 rows (parity)
  int* X = V + 2 * T;       // 2 rows (parity)
  int* H = X + 2 * T;       // 2 rows (parity): 32-bit H of ksw2 extz2
  int* bh = besth + (size_t)bi * T;   // per-lane best H, first row
  int* br = bestr + (size_t)bi * T;

  const int qlen = qlen_a[bi], tlen = tlen_a[bi];
  const uint8_t* qr = q + (size_t)bi * LQ;
  const uint8_t* tr = t + (size_t)bi * T;
  const int QE = sc.go + sc.ge;
  const int nrows = qlen + tlen - 1;

  for (int ti = threadIdx.x; ti < T; ti += blockDim.x) {
    bh[ti] = 0;
    br[ti] = BESTR_UNSET;
  }
  __syncthreads();

  for (int r = 0; r < nrows; ++r) {
    const int st0 = max(0, r - qlen + 1);
    const int en0 = min(tlen - 1, r);
    const int cur = r & 1, prv = cur ^ 1;
    int* Vc = V + cur * T;
    int* Xc = X + cur * T;
    int* Hc = H + cur * T;
    const int* Vp = V + prv * T;
    const int* Xp = X + prv * T;
    const int* Hp = H + prv * T;
    for (int ti = st0 + threadIdx.x; ti <= en0; ti += blockDim.x) {
      const DiffRow o =
          diff_cell(r, ti, qr[r - ti], tr[ti], U, Y, Vp, Xp, sc);
      // ksw2_extz2_sse.c:224-266: H[en0] = H_prev[en0-1] + u - QE,
      // H[t < en0] += v - QE, H[0] at r == 0 = v - 2 QE
      int h;
      if (r == 0 && ti == 0)
        h = o.v - QE - QE;
      else if (ti == en0 && en0 > 0)
        h = Hp[ti - 1] + o.u - QE;
      else
        h = Hp[ti] + o.v - QE;
      U[ti] = o.u;
      Y[ti] = o.y;
      Vc[ti] = o.v;
      Xc[ti] = o.x;
      Hc[ti] = h;
      if (h > bh[ti]) {   // strict: keep the first row reaching the best
        bh[ti] = h;
        br[ti] = r;
      }
      if (r == nrows - 1 && ti == tlen - 1) score[bi] = h;
    }
    __syncthreads();
  }
}

int set_smem(const void* kern, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

template <bool WITH_TL, int C>
int launch_global(const uint8_t* q, int LQ, const uint8_t* t, int T,
                  const int* qlen, const int* tlen, const int* qle, int B,
                  Scores sc, int* iden, int* tleft, int4* scratch,
                  cudaStream_t stream) {
  // edge columns in shared memory only when there is more than one tile
  // and the wrapper gave no global scratch
  const size_t smem =
      (T > 32 * C && !scratch) ? (size_t)WARPS * LQ * sizeof(int4) : 0;
  auto kern = wf_global_kernel<WITH_TL, C>;
  const int rc = set_smem((const void*)kern, smem);
  if (rc) return rc;
  kern<<<(B + WARPS - 1) / WARPS, WARPS * 32, smem, stream>>>(
      q, LQ, t, T, qlen, tlen, qle, B, sc, iden, tleft, scratch);
  return (int)cudaGetLastError();
}

template <bool WITH_TL>
int launch_global_c(const uint8_t* q, int LQ, const uint8_t* t, int T,
                    const int* qlen, const int* tlen, const int* qle, int B,
                    Scores sc, int* iden, int* tleft, int4* scratch,
                    cudaStream_t stream) {
  // the narrowest strip whose tile covers T, at most 16 columns a lane
  if (T <= 128)
    return launch_global<WITH_TL, 4>(q, LQ, t, T, qlen, tlen, qle, B, sc,
                                     iden, tleft, scratch, stream);
  if (T <= 256)
    return launch_global<WITH_TL, 8>(q, LQ, t, T, qlen, tlen, qle, B, sc,
                                     iden, tleft, scratch, stream);
  return launch_global<WITH_TL, 16>(q, LQ, t, T, qlen, tlen, qle, B, sc,
                                    iden, tleft, scratch, stream);
}

int threads_for(int lanes) {
  const int t = ((lanes + 31) / 32) * 32;
  return t < 512 ? t : 512;
}

}  // namespace

extern "C" const char* th_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// scratch: null = edge columns in shared memory (WARPS * LQ * 16 bytes a
// CTA, used only when T > 512), else a global buffer of B * LQ int4.
extern "C" int wf_global(const void* q, int LQ, const void* t, int T,
                         const void* qlen, const void* tlen, const void* qle,
                         int B, int match, int mis, int go, int ge,
                         int iden_only, void* iden, void* tleft,
                         void* scratch, void* stream) {
  if (B == 0) return 0;
  const Scores sc{match, mis, go, ge};
  auto launch = iden_only ? launch_global_c<false> : launch_global_c<true>;
  return launch((const uint8_t*)q, LQ, (const uint8_t*)t, T,
                (const int*)qlen, (const int*)tlen, (const int*)qle, B, sc,
                (int*)iden, (int*)tleft, (int4*)scratch,
                (cudaStream_t)stream);
}

// scratch: null = rows in shared memory (8 * T * 4 bytes), else a global
// buffer of B * 8 * T ints.  besth/bestr: [B, T] per-lane accumulators
// for the row-scan tie-order post-pass done by the wrapper.
extern "C" int wf_ext(const void* q, int LQ, const void* t, int T,
                      const void* qlen, const void* tlen, int B, int match,
                      int mis, int go, int ge, void* besth, void* bestr,
                      void* score, void* scratch, void* stream) {
  if (B == 0) return 0;
  const Scores sc{match, mis, go, ge};
  const size_t smem = scratch ? 0 : (size_t)8 * T * sizeof(int);
  int rc = set_smem((const void*)wf_ext_kernel, smem);
  if (rc) return rc;
  wf_ext_kernel<<<B, threads_for(T), smem, (cudaStream_t)stream>>>(
      (const uint8_t*)q, LQ, (const uint8_t*)t, T, (const int*)qlen,
      (const int*)tlen, sc, (int*)besth, (int*)bestr, (int*)score,
      (int*)scratch);
  return (int)cudaGetLastError();
}
