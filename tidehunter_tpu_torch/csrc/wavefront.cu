// Wavefront affine-gap alignment kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tidehunter_tpu/ops/wavefront.py:
//   wf_global  <- _global_kernel / _global_row  (with_tl and iden-only)
//   wf_ext     <- _ext_kernel / _ext_row
// Both evaluate the Suzuki-Kasahara difference recurrence of ksw2 extz2
// (reference ksw2/ksw2_extz2_sse.c) over anti-diagonals r, lane t =
// target index, query index r - t, with the same integer arithmetic and
// tie rules as the JAX kernels, so every output is bit-identical.
//
// Design: one CTA per problem, threads striding over the live lanes
// [st0, en0] of each anti-diagonal, one __syncthreads() per anti-diagonal.
// A live cell reads only live cells of the previous one or two
// anti-diagonals (or a boundary value), so rows rotate in small buffers:
// state read at lane t-1 (v, x, a1, H) ping-pongs by row parity, the
// M annotation (read two rows back) rotates over three rows, and state
// read only at its own lane (u, y, a2) updates in place.  The rows live in
// dynamic shared memory when they fit (12 rows x T x 4 B; T <= 4096) and
// otherwise in a global scratch the wrapper allocates per problem.
//
// What bounds it: per anti-diagonal the CTA does a handful of integer
// ops per lane and one barrier, so short rows are barrier- and
// latency-bound; there is no reuse for tensor cores.  Keeping every row in
// shared memory and bounding the loop per problem at qlen + tlen - 1 (not
// at the bucket) are what this first version does about it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TLB = 14;                 // t_left field width (tl + 1)
constexpr int TLMASK = (1 << TLB) - 1;
constexpr int BESTR_UNSET = 0x7FFFFFF;

struct Scores {
  int match, mis, go, ge;
};

struct DiffRow {
  int u, v, x, y;     // new difference values of the cell
  int d;              // 0 = diagonal, 1 = E, 2 = F (ksw2 direction)
  bool bit08, bit10;  // E / F continuation
};

// One cell of _dp_row: reads (r-1, t) in place (u, y) and (r-1, t-1)
// from the previous-parity rows (v, x).
__device__ __forceinline__ DiffRow diff_cell(
    int r, int ti, int qv, int tv, const int* U, const int* Y,
    const int* Vp, const int* Xp, Scores sc) {
  const int QE2 = 2 * (sc.go + sc.ge);
  const int MAXSC = sc.match + QE2;
  const int s = (tv == 4 || qv == 4) ? -sc.ge : (tv == qv ? sc.match : sc.mis);
  const int bq = r > 0 ? sc.go : 0;
  const bool is_r = ti == r;
  const int y_b = is_r ? 0 : Y[ti];
  const int u_b = is_r ? bq : U[ti];
  const int x_sh = ti == 0 ? 0 : Xp[ti - 1];
  const int v_sh = ti == 0 ? bq : Vp[ti - 1];
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

template <bool WITH_TL>
__global__ void wf_global_kernel(
    const uint8_t* __restrict__ q, int LQ, const uint8_t* __restrict__ t,
    int T, const int* __restrict__ qlen_a, const int* __restrict__ tlen_a,
    const int* __restrict__ qle_a, Scores sc, int* __restrict__ iden_out,
    int* __restrict__ tleft_out, int* __restrict__ scratch) {
  extern __shared__ int smem[];
  const int bi = blockIdx.x;
  int* buf = scratch ? scratch + (size_t)bi * 12 * T : smem;
  int* U = buf;             // in place
  int* Y = U + T;           // in place
  int* V = Y + T;           // 2 rows (parity)
  int* X = V + 2 * T;       // 2 rows (parity)
  int* A0 = X + 2 * T;      // 3 rows (r % 3): read two rows back
  int* A1 = A0 + 3 * T;     // 2 rows (parity)
  int* A2 = A1 + 2 * T;     // in place

  const int qlen = qlen_a[bi], tlen = tlen_a[bi], qle = qle_a[bi];
  const uint8_t* qr = q + (size_t)bi * LQ;
  const uint8_t* tr = t + (size_t)bi * T;
  // backtrack_left_end split: the step consuming query index qlen-qle
  // (qle == 0: the last query-consuming step)
  const int jS = qlen - max(qle, 1);
  const bool has_q = qle > 0;
  const int nrows = qlen + tlen - 1;
  const int tl_bound = (tlen + 1) & TLMASK;

  for (int r = 0; r < nrows; ++r) {
    const int st0 = max(0, r - qlen + 1);
    const int en0 = min(tlen - 1, r);
    const int cur = r & 1, prv = cur ^ 1;
    int* Vc = V + cur * T;
    int* Xc = X + cur * T;
    const int* Vp = V + prv * T;
    const int* Xp = X + prv * T;
    int* A0c = A0 + (r % 3) * T;
    const int* A0m2 = A0 + ((r + 1) % 3) * T;   // row r - 2
    int* A1c = A1 + cur * T;
    const int* A1p = A1 + prv * T;
    for (int ti = st0 + threadIdx.x; ti <= en0; ti += blockDim.x) {
      const int qv = qr[r - ti];
      const int tv = tr[ti];
      const DiffRow o = diff_cell(r, ti, qv, tv, U, Y, Vp, Xp, sc);
      const bool is_r = ti == r;
      const int eq = qv == tv ? 1 : 0;
      int M_step, D_step, I_step;
      if (WITH_TL) {
        const bool is_jS = (r - ti) == jS;
        const int pm_b0 = jS <= r - 1 ? tl_bound : 0;
        const int pd_b0 = jS <= r ? tl_bound : 0;
        const int P_M = is_r ? 0 : (ti == 0 ? pm_b0 : A0m2[ti - 1]);
        const int P_D = ti == 0 ? pd_b0 : A1p[ti - 1];
        const int P_I = is_r ? 0 : A2[ti];
        const int set_m = ((has_q ? tlen - ti : tlen - 1 - ti) + 1) & TLMASK;
        const int set_i =
            ((has_q ? tlen - ti - 1 : tlen - 1 - ti) + 1) & TLMASK;
        M_step = (((P_M >> TLB) + eq) << TLB) |
                 (is_jS ? set_m : (P_M & TLMASK));
        D_step = P_D;
        I_step = (P_I & ~TLMASK) | (is_jS ? set_i : (P_I & TLMASK));
      } else {
        const int P_M = (is_r || ti == 0) ? 0 : A0m2[ti - 1];
        M_step = P_M + eq;
        D_step = ti == 0 ? 0 : A1p[ti - 1];
        I_step = is_r ? 0 : A2[ti];
      }
      const int a0 = o.d == 0 ? M_step : (o.d == 1 ? D_step : I_step);
      U[ti] = o.u;
      Y[ti] = o.y;
      Vc[ti] = o.v;
      Xc[ti] = o.x;
      A0c[ti] = a0;
      A1c[ti] = o.bit08 ? D_step : a0;
      A2[ti] = o.bit10 ? I_step : a0;
      if (r == nrows - 1 && ti == tlen - 1) {
        if (WITH_TL) {
          iden_out[bi] = a0 >> TLB;
          tleft_out[bi] = qle > qlen ? tlen : (a0 & TLMASK) - 1;
        } else {
          iden_out[bi] = a0;
          tleft_out[bi] = 0;
        }
      }
    }
    __syncthreads();
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

int threads_for(int lanes) {
  const int t = ((lanes + 31) / 32) * 32;
  return t < 512 ? t : 512;
}

}  // namespace

extern "C" const char* th_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// scratch: null = rows in shared memory (12 * T * 4 bytes), else a global
// buffer of B * 12 * T ints.
extern "C" int wf_global(const void* q, int LQ, const void* t, int T,
                         const void* qlen, const void* tlen, const void* qle,
                         int B, int match, int mis, int go, int ge,
                         int iden_only, void* iden, void* tleft,
                         void* scratch, void* stream) {
  if (B == 0) return 0;
  const Scores sc{match, mis, go, ge};
  const size_t smem = scratch ? 0 : (size_t)12 * T * sizeof(int);
  auto kern = iden_only ? wf_global_kernel<false> : wf_global_kernel<true>;
  int rc = set_smem((const void*)kern, smem);
  if (rc) return rc;
  kern<<<B, threads_for(T), smem, (cudaStream_t)stream>>>(
      (const uint8_t*)q, LQ, (const uint8_t*)t, T, (const int*)qlen,
      (const int*)tlen, (const int*)qle, sc, (int*)iden, (int*)tleft,
      (int*)scratch);
  return (int)cudaGetLastError();
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
