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
// them fit, else in a global scratch the wrapper allocates.  That warp
// walks tiles x (qlen + 31) steps alone: a launch of few long problems
// leaves SMs idle and each busy one a few long chains.  There
// (global_route: the target past one tile, the query past the skew, the
// CTA's shared memory within 227 KB and fewer than 5/2 (tiles - 1)^2
// problems an SM) wf_global_cta runs the
// same steps with one CTA, or a
// thread-block cluster of CTAs, a problem and a warp a column tile:
// warp g trails warp g - 1 by CTA_SKEW rounds of CTA_S steps (its lane 0
// reads a row its left neighbour's lane 31 wrote 31 steps after lane 0
// of that warp) and takes the edge column from a ring that warp fills,
// one barrier (the cluster's) a round; the problem walks qlen + 31 +
// (tiles - 1) CTA_SKEW CTA_S steps.
//
// wf_ext: one CTA per problem; the launches of the default path carry
// 1-11 problems, so its time is the latency of one problem's chain of
// qlen + tlen - 1 anti-diagonals.  Thread k owns the L consecutive target
// lanes [k L, k L + L) and keeps their u, y, v, x and H in registers.  Cell
// (r, t) (query r - t) reads u, y of its own lane at r - 1 and v, x (and H
// at t == en0) of lane t - 1 at r - 1: inside the thread from its own
// registers (lanes visited right to left), from the thread before by
// __shfl_up_sync, and across warps through shared memory.  With a barrier
// per anti-diagonal a row cost ~450 clocks at (512,640) on the H100
// (PERF.md), so the warps are skewed instead: in round n warp w runs
// the S anti-diagonals [(n - w) S, (n - w + 1) S) back to back, its lanes
// handing values on by shuffle, and its last lane writes v, x, H of each
// row to the warp's ring of RB rows; warp w + 1 reads rows written one and
// two rounds before.  One __syncthreads() per round; no state row and no
// load from device memory inside the loop (the query is staged reversed in
// shared memory, so q[r - t] over a thread's lanes is a run of consecutive
// bytes; the target codes sit in registers).  A warp takes one branch a
// row, so its lanes never diverge: no work when none of its lanes is live
// in the round, the interior cell when all are live and none is en0 (a
// round wholly inside the band tests nothing else), else the edge cell,
// which masks lanes not yet started (their state already holds what their
// top cell reads) and leaves no other boundary term to test.  Each lane
// keeps its best H and the first row reaching it (rows come in increasing
// r, so a strict > keeps the first); the epilogue gives each lane its tie
// key in that row (the reference's row-scan order) and reduces over the
// CTA into (max, max_t, max_q), the outputs of ops/wavefront.ext_tie_order.
// L is chosen by the wrapper (at most 1024 threads), S by L (ext_skew).
//
// What bounds them: integer operations, a chain of dependent ones per
// cell and no reuse for tensor cores.  wf_global keeps the chain per lane
// (C cells a step) and leaves the card's integer pipes to many warps;
// wf_ext's short launches (one problem an SM) are bound by the issue of
// one SM: a row's loop body is ~115 SASS instructions at L = 1, against
// the 49 ops a cell that chip_smoke.py counts.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TLB = 14;                 // t_left field width (tl + 1)
constexpr int TLMASK = (1 << TLB) - 1;
constexpr int NEG_INF32 = -(1 << 30);
constexpr int WARPS = 4;                // wf_global problems per CTA
constexpr int EXT_THREADS = 1024;       // wf_ext: the most threads a CTA
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

// One lane's state over a column tile of wf_global: its strip's target
// codes, the previous row's u, y and M / I annotations of its C columns,
// and the left edge (v, x, a1, a0; dg = a0 a row up) with the query code
// it takes from the lane before.
template <int C>
struct GlobalStrip {
  uint32_t tp[C / 4];
  int U[C], Y[C], A0[C], A2[C];
  int l_v, l_x, l_a1, l_a0, dg, qv;
};

// The strip of columns [c0, c0 + C) at row i = -1: the i = 0 boundary
// (u = bq, y = 0, P_I = 0, P_M = 0), codes four to a register (4 past
// tlen: those columns are computed but never reach a live one).
template <int C>
__device__ __forceinline__ void strip_begin(GlobalStrip<C>& g,
                                            const uint8_t* tr, int tlen,
                                            int c0, Scores sc) {
#pragma unroll
  for (int w = 0; w < C / 4; ++w) {
    uint32_t p = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int tc = c0 + 4 * w + b;
      p |= (uint32_t)(tc < tlen ? tr[tc] : 4) << (8 * b);
    }
    g.tp[w] = p;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    g.U[c] = c0 + c > 0 ? sc.go : 0;
    g.Y[c] = 0;
    g.A0[c] = 0;
    g.A2[c] = 0;
  }
  g.l_v = g.l_x = g.l_a1 = g.l_a0 = g.dg = 0;
  g.qv = 4;
}

// The problem's terms a step reads: lengths, the backtrack_left_end split
// (jS: the step consuming query index qlen - qle; qle == 0: the last
// query-consuming step) and the t_left boundary value.
struct GlobalProblem {
  int qlen, tlen, qle, jS, tl_bound;
  bool has_q;
};

__device__ __forceinline__ GlobalProblem global_problem(int qlen, int tlen,
                                                        int qle) {
  return {qlen, tlen, qle, qlen - max(qle, 1), (tlen + 1) & TLMASK, qle > 0};
}

// Step s of the column tile at t0: lane k computes query row i = s - k of
// its strip left to right.  Lane 0 takes the query code (qs[s]) and its
// left edge: the t = 0 boundary, or row s of the previous tile's right
// edge column at edge_in[s & in_mask].  Unless the tile is the problem's
// last, lane 31 writes row i of this tile's right edge column to
// edge_out[i & out_mask].  Then every value lane k + 1 reads at step
// s + 1 moves up one lane (__shfl_up_sync): the whole warp takes the step.
template <bool WITH_TL, int C>
__device__ __forceinline__ void global_step(
    GlobalStrip<C>& g, int s, int lane, int t0, int c0, bool last,
    const GlobalProblem& pb, const uint8_t* qs, const int4* edge_in,
    int in_mask, int4* edge_out, int out_mask, Scores sc, int bi,
    int* __restrict__ iden_out, int* __restrict__ tleft_out) {
  const int i = s - lane;
  if (lane == 0) {
    g.qv = s < pb.qlen ? qs[s] : 4;
    if (t0 == 0) {              // the t = 0 boundary
      g.l_v = i > 0 ? sc.go : 0;
      g.l_x = 0;
      g.l_a1 = WITH_TL && pb.jS <= i ? pb.tl_bound : 0;
      g.dg = WITH_TL && i > 0 && pb.jS <= i - 1 ? pb.tl_bound : 0;
    } else if (s < pb.qlen) {   // the previous tile's right edge
      const int4 e = edge_in[s & in_mask];
      g.l_v = e.x;
      g.l_x = e.y;
      g.l_a1 = e.z;
      g.l_a0 = e.w;
    }
  }
  int vl = g.l_v, xl = g.l_x, a1l = g.l_a1;
  if (i >= 0 && i < pb.qlen && c0 < pb.tlen) {
    int dgl = g.dg;
    // tlen - tc at column c, 1..8192 on a live column: the t_left field
    // holds it without a mask (a dead column's value reaches no live one)
    const int tt = pb.tlen - c0;
    const bool is_jS = i == pb.jS;
    int res = 0;                    // a0 at (i, tlen - 1)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int tv = (g.tp[c >> 2] >> (8 * (c & 3))) & 0xff;
      const DiffRow o = diff_core(g.qv, tv, g.U[c], g.Y[c], vl, xl, sc);
      const int eq = g.qv == tv ? 1 : 0;
      int M_step, I_step;
      if (WITH_TL) {
        // ((has_q ? tlen - tc : tlen - 1 - tc) + 1) and
        // ((has_q ? tlen - tc - 1 : tlen - 1 - tc) + 1), masked
        const int set_m = tt - c + (pb.has_q ? 1 : 0);
        const int set_i = tt - c;
        M_step = (((dgl >> TLB) + eq) << TLB) |
                 (is_jS ? set_m : (dgl & TLMASK));
        I_step = (g.A2[c] & ~TLMASK) | (is_jS ? set_i : (g.A2[c] & TLMASK));
      } else {
        M_step = dgl + eq;
        I_step = g.A2[c];
      }
      const int D_step = a1l;
      const int a0 = o.d == 0 ? M_step : (o.d == 1 ? D_step : I_step);
      dgl = g.A0[c];
      g.U[c] = o.u;
      g.Y[c] = o.y;
      g.A0[c] = a0;
      g.A2[c] = o.bit10 ? I_step : a0;
      vl = o.v;
      xl = o.x;
      a1l = o.bit08 ? D_step : a0;
      if (c == tt - 1) res = a0;
    }
    if (i == pb.qlen - 1 && pb.tlen - 1 < c0 + C) {   // the strip ends it
      if (WITH_TL) {
        iden_out[bi] = res >> TLB;
        tleft_out[bi] = pb.qle > pb.qlen ? pb.tlen : (res & TLMASK) - 1;
      } else {
        iden_out[bi] = res;
        tleft_out[bi] = 0;
      }
    }
    if (!last && lane == 31)
      edge_out[i & out_mask] = make_int4(vl, xl, a1l, g.A0[C - 1]);
  }
  // lane k + 1 computes row i at step s + 1
  g.dg = g.l_a0;
  g.l_v = __shfl_up_sync(FULL, vl, 1);
  g.l_x = __shfl_up_sync(FULL, xl, 1);
  g.l_a1 = __shfl_up_sync(FULL, a1l, 1);
  g.l_a0 = __shfl_up_sync(FULL, g.A0[C - 1], 1);
  g.qv = __shfl_up_sync(FULL, g.qv, 1);
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
  const GlobalProblem pb =
      global_problem(qlen_a[bi], tlen_a[bi], qle_a[bi]);
  const uint8_t* qr = q + (size_t)bi * LQ;
  const uint8_t* tr = t + (size_t)bi * T;
  GlobalStrip<C> g;
  for (int t0 = 0; t0 < pb.tlen; t0 += TW) {
    const bool last = t0 + TW >= pb.tlen;
    const int c0 = t0 + lane * C;                    // the strip's column 0
    const int nl = min(31, (pb.tlen - 1 - t0) / C);  // last lane with a column
    strip_begin(g, tr, pb.tlen, c0, sc);
    for (int s = 0; s < pb.qlen + nl; ++s)
      global_step<WITH_TL, C>(g, s, lane, t0, c0, last, pb, qr, edge, -1,
                              edge, -1, sc, bi, iden_out, tleft_out);
    __syncwarp();   // the tile's edge column, before the next tile reads it
  }
}

// wf_global_cta: one problem a CTA, or a thread-block cluster of CL CTAs,
// of G warps in all.  Warp g owns column tiles g, g + G, g + 2G, ...
// (pass p: tile p G + g).  A warp's lane 0 reads row s of the edge column
// of the tile on its left at step s, which that tile's lane 31 wrote at
// step s + 31; so warp g trails warp g - 1 by CTA_SKEW rounds of CTA_S
// steps (CTA_SKEW CTA_S >= CTA_S + 31), one barrier a round: in round n
// warp g runs the steps [(n - CTA_SKEW g - p P) CTA_S, + CTA_S) of its pass
// p tile.  The edge goes to the right neighbour's ring of CTA_RB rows (in
// another CTA's shared memory through the cluster's distributed shared
// memory), and from the last warp to warp 0's next pass through a column
// of LQ rows in rank 0's shared memory (only when tiles wrap round the
// warps).  Passes start P = max(CTA_SKEW G, R0 + CTA_SKEW) rounds apart
// (R0 the rounds of a tile), so that a warp has finished a tile and its
// right neighbour has read its ring (it trails by CTA_SKEW rounds) before
// the next pass writes it.  The whole problem walks qlen + 31 + (tiles -
// 1) CTA_SKEW CTA_S steps where one warp walks tiles (qlen + 31).
constexpr int CTA_S = 16;               // steps a warp runs between barriers
constexpr int CTA_SKEW = 3;             // rounds a warp trails its left one
constexpr int CTA_RB = 64;              // rows of a warp's edge ring
constexpr int CTA_THREADS = 256;        // the most threads a CTA (its
                                        // 255 registers a thread)
constexpr int CTA_CLUSTER = 8;          // the most CTAs a problem
constexpr int CTA_SPREAD = 4;           // warps a CTA of a spread problem
constexpr int CTA_SMEM_MAX = 227 * 1024;  // shared memory a CTA may take
static_assert(CTA_SKEW * CTA_S >= CTA_S + 31, "lane 31 lags lane 0 31 steps");
static_assert(CTA_RB >= (CTA_SKEW + 1) * CTA_S, "rows read and written");

__device__ __forceinline__ void cta_sync(int CL) {
  if (CL > 1)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
}

template <bool WITH_TL, int C>
__global__ void __launch_bounds__(CTA_THREADS) wf_global_cta(
    const uint8_t* __restrict__ q, int LQ, const uint8_t* __restrict__ t,
    int T, const int* __restrict__ qlen_a, const int* __restrict__ tlen_a,
    const int* __restrict__ qle_a, int B, int CL, Scores sc,
    int* __restrict__ iden_out, int* __restrict__ tleft_out) {
  extern __shared__ int4 cta_s[];
  constexpr int TW = 32 * C;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwc = blockDim.x >> 5;          // warps a CTA
  const int rank = (int)(blockIdx.x % CL), bi = (int)(blockIdx.x / CL);
  const int g = rank * nwc + wid, G = CL * nwc;
  // [nwc][CTA_RB] rings, the wrap column [LQ] when the bucket's tiles
  // outnumber the warps, the query
  const bool wraps = (T + TW - 1) / TW > G;
  int4* const rings = cta_s;
  int4* const wrap = rings + nwc * CTA_RB;
  uint8_t* const qs = reinterpret_cast<uint8_t*>(wrap + (wraps ? LQ : 0));
  const GlobalProblem pb =
      global_problem(qlen_a[bi], tlen_a[bi], qle_a[bi]);
  const uint8_t* qr = q + (size_t)bi * LQ;
  const uint8_t* tr = t + (size_t)bi * T;
  for (int k = threadIdx.x; k < pb.qlen; k += blockDim.x) qs[k] = qr[k];
  // warp g reads its own ring (warp 0 the wrap column) and writes its
  // right neighbour's (the last warp rank 0's wrap column)
  const int4* edge_in = g ? rings + wid * CTA_RB : wrap;
  const int in_mask = g ? CTA_RB - 1 : -1;
  int4* edge_out = wrap;
  int out_mask = -1;
  if (g + 1 < G) {
    out_mask = CTA_RB - 1;
    edge_out = wid + 1 < nwc ? rings + (wid + 1) * CTA_RB
                             : cooperative_groups::this_cluster()
                                   .map_shared_rank(rings, rank + 1);
  } else if (CL > 1) {
    edge_out = cooperative_groups::this_cluster().map_shared_rank(wrap, 0);
  }
  cta_sync(CL);   // the query staged, every CTA of the cluster running

  const int nt = (pb.tlen + TW - 1) / TW;   // the problem's tiles
  const int R0 = (pb.qlen + 31 + CTA_S - 1) / CTA_S;
  const int P = max(CTA_SKEW * G, R0 + CTA_SKEW);
  const int np = (nt + G - 1) / G;
  const int rounds = (np - 1) * P + CTA_SKEW * (nt - 1 - (np - 1) * G) + R0;
  GlobalStrip<C> st;
  int t0 = 0, c0 = 0, nl = 0;
  bool last = true;
  for (int n = 0; n < rounds; ++n) {
    const int local = n - CTA_SKEW * g;
    if (local >= 0) {
      const int p = local / P, off = local - p * P, j = p * G + g;
      if (j < nt && off < R0) {
        if (off == 0) {                  // the tile's first round
          t0 = j * TW;
          c0 = t0 + lane * C;
          nl = min(31, (pb.tlen - 1 - t0) / C);
          last = t0 + TW >= pb.tlen;
          strip_begin(st, tr, pb.tlen, c0, sc);
        }
        // one step's code (C cells) in the loop, as the warp kernel's:
        // unrolled, CTA_S steps would overflow the instruction cache
#pragma unroll 1
        for (int k = 0; k < CTA_S; ++k) {
          const int s = off * CTA_S + k;
          if (s < pb.qlen + nl)
            global_step<WITH_TL, C>(st, s, lane, t0, c0, last, pb, qs,
                                    edge_in, in_mask, edge_out, out_mask, sc,
                                    bi, iden_out, tleft_out);
        }
      }
    }
    cta_sync(CL);
  }
}

// The reference's row-scan tie key of lane ti in anti-diagonal r
// (ksw2_extz2_sse.c:229-260, ops/ksw2._row_max_scan): en0 first, then the
// four SIMD lanes of [st0, en1) in lane order, lowest t first, then the
// remainder [en1, en0) lowest t first.  Smaller is earlier; t < 2^14.
__device__ __forceinline__ int tie_key(int ti, int st0, int en0, int en1) {
  const int cls = ti == en0 ? 0 : (ti < en1 ? 1 + ((ti - st0) & 3) : 5);
  return (cls << 14) | ti;
}

// (h, r, key) a better maximum than (h2, r2, key2): higher H, then the
// earlier row, then the earlier tie key.
__device__ __forceinline__ bool better(int h, int r, int k, int h2, int r2,
                                       int k2) {
  return h > h2 || (h == h2 && (r < r2 || (r == r2 && k < k2)));
}

// The staged query of wf_ext: LQ codes with T codes of padding before and
// T + 32 L after (the lanes of a CTA's last warp reach past T).
__host__ __device__ __forceinline__ int ext_qs_bytes(int LQ, int T, int L) {
  return LQ + 2 * T + 32 * L;
}

// Byte e of codes packed four to a word.
template <int N>
__device__ __forceinline__ int code(const uint32_t (&w)[N], int e) {
  return (w[e >> 2] >> (8 * (e & 3))) & 0xff;
}

// One anti-diagonal r over a thread's lanes [t0, t0 + L), right to left
// (lane e reads lane e - 1 before it changes); vl, xl, hl are lane
// t0 - 1's v, x, H at the previous anti-diagonal (at t = 0 the
// boundary's).  Each live lane keeps its best H above 0 and the first row
// reaching it (a strict >: rows come in increasing r).  EDGE = false: the
// whole warp lies in [st0, en0), so every lane is live and none is en0.
// EDGE = true: a lane not yet started (ti > en0) keeps its state, which
// holds the values its first (top) cell needs: U = the i = 0 boundary bq,
// Y = 0, and H = -QE at lane 0 (so its r = 0 cell gets v - 2 QE); a
// finished lane (ti < st0) is overwritten, as no live cell reads it again,
// and keeps its best.
template <int L, bool EDGE>
__device__ __forceinline__ void ext_row(
    int (&U)[L], int (&Y)[L], int (&V)[L], int (&X)[L], int (&H)[L],
    int (&BH)[L], int (&BR)[L], const uint32_t (&tp)[(L + 3) / 4],
    const uint32_t (&qp)[(L + 3) / 4], int t0, int r, int st0, int en0,
    int vl, int xl, int hl, Scores sc) {
  const int QE = sc.go + sc.ge;
#pragma unroll
  for (int e = L - 1; e >= 0; --e) {
    const int ti = t0 + e;
    const DiffRow o = diff_core(code(qp, e), code(tp, e), U[e], Y[e],
                                e ? V[e - 1] : vl, e ? X[e - 1] : xl, sc);
    // ksw2_extz2_sse.c:224-266: H[en0] = H_prev[en0-1] + u - QE,
    // H[t < en0] += v - QE
    int h = H[e] + o.v - QE;
    if (EDGE) {
      if (ti == en0 && en0 > 0) h = (e ? H[e - 1] : hl) + o.u - QE;
      if (ti > en0) continue;
      if (ti >= st0 && h > BH[e]) {
        BH[e] = h;
        BR[e] = r;
      }
    } else if (h > BH[e]) {
      BH[e] = h;
      BR[e] = r;
    }
    U[e] = o.u;
    Y[e] = o.y;
    V[e] = o.v;
    X[e] = o.x;
    H[e] = h;
  }
}

// Anti-diagonals a warp runs between barriers, by lanes a thread (the
// round's ring values and query codes sit in registers, under the 64 a
// thread of a 1024-thread CTA), and the rows of a warp's ring (a power of
// two, at least 2 S + 1: the rows read and the rows written in a round).
__host__ __device__ constexpr int ext_skew(int L) { return L <= 4 ? 4 : 2; }
__host__ __device__ constexpr int ext_ring(int L) { return 4 * ext_skew(L); }

template <int L>
__global__ void __launch_bounds__(L >= 16 ? EXT_THREADS / 2 : EXT_THREADS)
    wf_ext_kernel(const uint8_t* __restrict__ q, int LQ,
                  const uint8_t* __restrict__ t, int T,
                  const int* __restrict__ qlen_a,
                  const int* __restrict__ tlen_a, int B, Scores sc,
                  int* __restrict__ out) {
  constexpr int S = ext_skew(L), RB = ext_ring(L);
  extern __shared__ int ext_s[];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int bi = blockIdx.x;
  int* ring = ext_s;                        // [nw][RB] x (v, x, h)
  int* red = ring + 3 * RB * nw;            // [nw] x (h, r, key)
  uint8_t* qs = (uint8_t*)(red + 3 * nw);   // the query reversed, padded

  const int qlen = qlen_a[bi], tlen = tlen_a[bi];
  const uint8_t* qr = q + (size_t)bi * LQ;
  const uint8_t* tr = t + (size_t)bi * T;
  // q[r - ti] = qs[QO - r + ti], code 4 off the query; every thread's
  // lanes stay inside [0, ext_qs_bytes) for r in [0, qlen + tlen - 1)
  const int QO = T + LQ - 1;
  for (int k = tid; k < ext_qs_bytes(LQ, T, L); k += blockDim.x) {
    const int jj = QO - k;
    qs[k] = (jj >= 0 && jj < qlen) ? qr[jj] : 4;
  }

  // this thread's lanes [t0, t0 + L): target codes, the state of the
  // previous anti-diagonal (u, y at lane t; v, x, H read at t + 1 too),
  // set to what each lane's top cell reads (ext_row), and each lane's
  // best H and its row
  const int t0 = tid * L;
  // the warp's lanes, for the warp-uniform choice of ext_row's variant
  const int wlo = wid * 32 * L, whi = wlo + 32 * L - 1;
  constexpr int NP = (L + 3) / 4;
  uint32_t tp[NP] = {};                     // codes, four a word
  int U[L], Y[L], V[L], X[L], H[L], BH[L], BR[L];
#pragma unroll
  for (int e = 0; e < L; ++e) {
    const int ti = t0 + e;
    tp[e >> 2] |= (uint32_t)(ti < tlen ? tr[ti] : 4) << (8 * (e & 3));
    U[e] = ti > 0 ? sc.go : 0;
    Y[e] = V[e] = X[e] = 0;
    H[e] = ti > 0 ? NEG_INF32 : -(sc.go + sc.ge);
    BH[e] = 0;
    BR[e] = -1;
  }
  const int nrows = qlen + tlen - 1;
  const int rounds = (nrows + (nw - 1) * S + S - 1) / S;
  __syncthreads();
  // lane t0 - 1 at the previous row
  int vl = __shfl_up_sync(FULL, V[L - 1], 1);
  int xl = __shfl_up_sync(FULL, X[L - 1], 1);
  int hl = __shfl_up_sync(FULL, H[L - 1], 1);

  for (int n = 0; n < rounds; ++n) {
    const int rb = (n - wid) * S;           // the warp's rows [rb, rb + S)
    const int re = rb + S - 1;
    if (rb < nrows && re >= 0 && wlo <= min(tlen - 1, re) &&
        whi >= max(0, rb - qlen + 1)) {
      // the round's inputs, read before any store of the round: row r's
      // query codes, and (lane 0) the previous warp's last lane at r - 1
      uint32_t qp[S][NP];
      int rv[S], rx[S], rh[S];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const uint8_t* qn = qs + QO - (rb + k) + t0;
#pragma unroll
        for (int w = 0; w < NP; ++w) qp[k][w] = 0;
        if (rb + k >= 0 && rb + k < nrows) {
#pragma unroll
          for (int e = 0; e < L; ++e)
            qp[k][e >> 2] |= (uint32_t)qn[e] << (8 * (e & 3));
        }
        rv[k] = rx[k] = rh[k] = 0;
        if (lane == 0 && wid > 0) {
          const int* s = ring + 3 * ((wid - 1) * RB + ((rb + k - 1) & (RB - 1)));
          rv[k] = s[0];
          rx[k] = s[1];
          rh[k] = s[2];
        }
      }
      // every row of the round inside the problem and the warp inside
      // every row's [st0, en0): no test a row but the t = 0 boundary
      const bool inner = rb >= 0 && re < nrows &&
                         wlo >= max(0, re - qlen + 1) &&
                         whi < min(tlen - 1, rb);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const int r = rb + k;
        if (!inner && (r < 0 || r >= nrows)) continue;
        const int st0 = max(0, r - qlen + 1);
        const int en0 = min(tlen - 1, r);
        if (lane == 0 && wid > 0) {   // the last lane of the warp before
          vl = rv[k];
          xl = rx[k];
          hl = rh[k];
        }
        if (t0 == 0) {                // the t = 0 boundary
          vl = r > 0 ? sc.go : 0;
          xl = 0;
        }
        if (inner || (wlo >= st0 && whi < en0))
          ext_row<L, false>(U, Y, V, X, H, BH, BR, tp, qp[k], t0, r, st0,
                            en0, vl, xl, hl, sc);
        else
          ext_row<L, true>(U, Y, V, X, H, BH, BR, tp, qp[k], t0, r, st0, en0,
                           vl, xl, hl, sc);
        vl = __shfl_up_sync(FULL, V[L - 1], 1);
        xl = __shfl_up_sync(FULL, X[L - 1], 1);
        hl = __shfl_up_sync(FULL, H[L - 1], 1);
        if (lane == 31) {
          int* s = ring + 3 * (wid * RB + (r & (RB - 1)));
          s[0] = V[L - 1];
          s[1] = X[L - 1];
          s[2] = H[L - 1];
        }
      }
    }
    __syncthreads();
  }
  // the end score: lane tlen - 1's H after its last live row, the last row
  int fin = 0;
  // this thread's best cell: highest H, then the first row, then the
  // reference's row-scan tie key in that row
  int bh = 0, br = -1, bk = 0;
#pragma unroll
  for (int e = 0; e < L; ++e) {
    const int ti = t0 + e;
    if (ti == tlen - 1) fin = H[e];
    const int st0 = max(0, BR[e] - qlen + 1), en0 = min(tlen - 1, BR[e]);
    const int k = tie_key(ti, st0, en0, st0 + ((en0 - st0) >> 2 << 2));
    if (BH[e] > 0 && better(BH[e], BR[e], k, bh, br, bk)) {
      bh = BH[e];
      br = BR[e];
      bk = k;
    }
  }

  // epilogue: the CTA's best cell, then the outputs of ext_tie_order
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int h2 = __shfl_xor_sync(FULL, bh, d);
    const int r2 = __shfl_xor_sync(FULL, br, d);
    const int k2 = __shfl_xor_sync(FULL, bk, d);
    if (better(h2, r2, k2, bh, br, bk)) {
      bh = h2;
      br = r2;
      bk = k2;
    }
  }
  if (lane == 0) {
    red[3 * wid] = bh;
    red[3 * wid + 1] = br;
    red[3 * wid + 2] = bk;
  }
  if (t0 <= tlen - 1 && tlen - 1 < t0 + L) out[3 * B + bi] = fin;   // score
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < nw; ++w)
      if (better(red[3 * w], red[3 * w + 1], red[3 * w + 2], bh, br, bk)) {
        bh = red[3 * w];
        br = red[3 * w + 1];
        bk = red[3 * w + 2];
      }
    const bool found = bh > 0;
    const int mt = bk & ((1 << 14) - 1);
    out[bi] = found ? bh : 0;
    out[B + bi] = found ? mt : -1;
    out[2 * B + bi] = found ? br - mt : -1;
  }
}

int set_smem(const void* kern, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

// wf_global's kernels, as ops/wavefront.GLOBAL_ROUTES names them
enum GlobalRoute { ROUTE_WARP = 0, ROUTE_CTA = 1 };

int sm_count(int* sms) {
  int dev = 0;
  const int rc = (int)cudaGetDevice(&dev);
  return rc ? rc
            : (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                          dev);
}

// The narrowest strip whose tile covers T, at most 16 columns a lane.
int global_cols(int T) { return T <= 128 ? 4 : T <= 256 ? 8 : 16; }

// wf_global_cta's warps a CTA (nw) and CTAs a problem (cl) at bucket T for
// B problems: a warp a tile (the tiles past CTA_THREADS / 32 wrapping),
// one CTA a problem while the launch has a problem for every SM, else a
// cluster of CTAs of at most CTA_SPREAD warps (one a scheduler), at most
// CTA_CLUSTER, so that few long problems spread over SMs.
void cta_shape(int B, int T, int sms, int* nw, int* cl) {
  const int TW = 32 * global_cols(T), nt = (T + TW - 1) / TW;
  int CL = 1;
  if (B < sms)
    CL = min(CTA_CLUSTER, (nt + CTA_SPREAD - 1) / CTA_SPREAD);
  *cl = CL;
  *nw = min((nt + CL - 1) / CL, CTA_THREADS / 32);
}

// wf_global_cta's shared memory a CTA: nw edge rings, the wrap column of
// LQ rows when the bucket's tiles outnumber the nw * cl warps, the query.
size_t cta_smem(int LQ, int T, int nw, int cl) {
  const int TW = 32 * global_cols(T);
  const bool wraps = (T + TW - 1) / TW > nw * cl;
  return (size_t)nw * CTA_RB * sizeof(int4) +
         (wraps ? (size_t)LQ * sizeof(int4) : 0) + LQ;
}

// wf_global's kernel for B problems of (LQ, T) on a card of sms SMs.  A
// problem of nt tiles is a chain of nt (qlen + 31) steps on the warp
// kernel and of qlen + 31 + (nt - 1) CTA_SKEW CTA_S on the CTA kernel,
// whose steps cost more and whose warps a problem fill the card sooner:
// the CTA kernel where the target spans more than one tile, the query
// outlasts the skew, its CTA's shared memory fits (cta_smem) and the
// launch has fewer than 5/2 (nt - 1)^2 problems an SM (on the H100 the
// CTA kernel won up to 1.9 problems an SM and lost from 2.9 at nt = 2,
// won at 9.7 and lost from 13.6 at nt = 3, won up to 15.2 at nt = 4 and
// 6: PERF.md); the warp kernel otherwise, which takes any LQ (its edge
// columns in a global scratch past CTA_SMEM_MAX).  A threshold fitted to
// those sweeps, not a model of either kernel's waves: it takes the
// slower kernel at (1536,1536) B = 850-1000 (the CTA kernel, 4-15%) and
// at (1024,1024) B = 400-528 (the warp kernel, 5%), shapes no recorded
// path launches.
int global_route(int B, int LQ, int T, int sms) {
  const int TW = 32 * global_cols(T), nt = (T + TW - 1) / TW;
  if (nt < 2 || LQ + 31 <= CTA_SKEW * CTA_S) return ROUTE_WARP;
  int nw = 0, cl = 0;
  cta_shape(B, T, sms, &nw, &cl);
  if (cta_smem(LQ, T, nw, cl) > (size_t)CTA_SMEM_MAX) return ROUTE_WARP;
  return 2LL * B < 5LL * (nt - 1) * (nt - 1) * sms ? ROUTE_CTA : ROUTE_WARP;
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

template <bool WITH_TL, int C>
int launch_cta(const uint8_t* q, int LQ, const uint8_t* t, int T,
               const int* qlen, const int* tlen, const int* qle, int B,
               Scores sc, int* iden, int* tleft, int nw, int cl,
               cudaStream_t stream) {
  if (nw < 1 || nw * 32 > CTA_THREADS || cl < 1 || cl > CTA_CLUSTER)
    return (int)cudaErrorInvalidValue;
  const size_t smem = cta_smem(LQ, T, nw, cl);
  if (smem > (size_t)CTA_SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = wf_global_cta<WITH_TL, C>;
  int rc = set_smem((const void*)kern, smem);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cl);
  cfg.blockDim = dim3(nw * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cl > 1 ? 1 : 0;
  rc = (int)cudaLaunchKernelEx(&cfg, kern, q, LQ, t, T, qlen, tlen, qle, B,
                               cl, sc, iden, tleft);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// route's kernel at the strip width of T; nw, cl: the CTA kernel's warps a
// CTA and CTAs a problem (0: cta_shape's)
template <bool WITH_TL>
int launch_global_on(int route, int nw, int cl, const uint8_t* q, int LQ,
                     const uint8_t* t, int T, const int* qlen,
                     const int* tlen, const int* qle, int B, Scores sc,
                     int* iden, int* tleft, int4* scratch,
                     cudaStream_t stream) {
  const int C = global_cols(T);
  if (route == ROUTE_WARP) {
    auto launch = C == 4   ? launch_global<WITH_TL, 4>
                  : C == 8 ? launch_global<WITH_TL, 8>
                           : launch_global<WITH_TL, 16>;
    return launch(q, LQ, t, T, qlen, tlen, qle, B, sc, iden, tleft, scratch,
                  stream);
  }
  if (route != ROUTE_CTA) return (int)cudaErrorInvalidValue;
  if (!nw || !cl) {
    int sms = 0;
    const int rc = sm_count(&sms);
    if (rc) return rc;
    int anw = 0, acl = 0;
    cta_shape(B, T, sms, &anw, &acl);
    if (!nw) nw = anw;
    if (!cl) cl = acl;
  }
  auto launch = C == 4   ? launch_cta<WITH_TL, 4>
                : C == 8 ? launch_cta<WITH_TL, 8>
                         : launch_cta<WITH_TL, 16>;
  return launch(q, LQ, t, T, qlen, tlen, qle, B, sc, iden, tleft, nw, cl,
                stream);
}

template <int L>
int launch_ext(const uint8_t* q, int LQ, const uint8_t* t, int T,
               const int* qlen, const int* tlen, int B, Scores sc, int* out,
               cudaStream_t stream) {
  const int threads = (T + 32 * L - 1) / (32 * L) * 32;
  if (threads > (L >= 16 ? EXT_THREADS / 2 : EXT_THREADS))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * (ext_ring(L) + 1) * (threads / 32) *
                         sizeof(int) + ext_qs_bytes(LQ, T, L);
  auto kern = wf_ext_kernel<L>;
  const int rc = set_smem((const void*)kern, smem);
  if (rc) return rc;
  kern<<<B, threads, smem, stream>>>(q, LQ, t, T, qlen, tlen, B, sc, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* th_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// scratch (the warp kernel's): null = edge columns in shared memory
// (WARPS * LQ * 16 bytes a CTA, used only when T > 512), else a global
// buffer of B * LQ int4.  The kernel is global_route's.
extern "C" int wf_global(const void* q, int LQ, const void* t, int T,
                         const void* qlen, const void* tlen, const void* qle,
                         int B, int match, int mis, int go, int ge,
                         int iden_only, void* iden, void* tleft,
                         void* scratch, void* stream) {
  if (B == 0) return 0;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc) return rc;
  const Scores sc{match, mis, go, ge};
  auto launch = iden_only ? launch_global_on<false> : launch_global_on<true>;
  return launch(global_route(B, LQ, T, sms), 0, 0, (const uint8_t*)q, LQ,
                (const uint8_t*)t, T, (const int*)qlen, (const int*)tlen,
                (const int*)qle, B, sc, (int*)iden, (int*)tleft,
                (int4*)scratch, (cudaStream_t)stream);
}

// wf_global's kernel for B problems of (LQ, T) on a card of sms SMs, an
// index of ops/wavefront.GLOBAL_ROUTES (host query, no launch).
extern "C" int wf_global_route(int B, int LQ, int T, int sms) {
  return global_route(B, LQ, T, sms);
}

// One of wf_global's kernels (route, a GLOBAL_ROUTES index) at any shape,
// the CTA kernel with nw warps a CTA and cl CTAs a problem (0: its
// launcher's choice): the yardsticks chip_smoke.py times the routes by.
extern "C" int wf_global_on(int route, int nw, int cl, const void* q,
                            int LQ, const void* t, int T, const void* qlen,
                            const void* tlen, const void* qle, int B,
                            int match, int mis, int go, int ge,
                            int iden_only, void* iden, void* tleft,
                            void* scratch, void* stream) {
  if (B == 0) return 0;
  const Scores sc{match, mis, go, ge};
  auto launch = iden_only ? launch_global_on<false> : launch_global_on<true>;
  return launch(route, nw, cl, (const uint8_t*)q, LQ, (const uint8_t*)t, T,
                (const int*)qlen, (const int*)tlen, (const int*)qle, B, sc,
                (int*)iden, (int*)tleft, (int4*)scratch,
                (cudaStream_t)stream);
}

// lanes: target lanes a thread owns (1, 2, 4 or 16; at most 1024
// threads, 512 at 16 lanes);
// out [4, B] int32: max, max_t, max_q, score.
extern "C" int wf_ext(const void* q, int LQ, const void* t, int T,
                      const void* qlen, const void* tlen, int B, int match,
                      int mis, int go, int ge, int lanes, void* out,
                      void* stream) {
  if (B == 0) return 0;
  const Scores sc{match, mis, go, ge};
  auto launch = lanes == 1   ? launch_ext<1>
                : lanes == 2 ? launch_ext<2>
                : lanes == 4 ? launch_ext<4>
                : lanes == 16 ? launch_ext<16>
                             : nullptr;
  if (!launch) return (int)cudaErrorInvalidValue;
  return launch((const uint8_t*)q, LQ, (const uint8_t*)t, T, (const int*)qlen,
                (const int*)tlen, B, sc, (int*)out, (cudaStream_t)stream);
}
