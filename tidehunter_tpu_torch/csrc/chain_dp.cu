// Tandem-hit chain DP for Hopper (sm_90a).
//
// Replaces tidehunter_tpu/ops/chaining_jax.py: chain_dp_batch, a
// lax.while_loop over the hits whose every step evaluates all `window`
// predecessor lanes of every read of the batch.  Here one warp runs one
// read, cell after cell, and scans the predecessors of a cell the way the
// reference does (native/chainx.c th_chain): backward from cur - 1, 32
// lanes at a time, and only until the first event.  Per chunk, lane l
// holds predecessor p = hi - l (scan order = lane order):
//
//   * get_con_score (chaining_jax.py:130-140): conn, matched, dlt and the
//     gap ((dlt * dlt) >> 1) + (ilog2(max(dis1 + dis2, 1)) >> 1), ilog2 by
//     __clz; sc = score[p] + matched - gap on conn lanes;
//   * improving = conn & sc > the running maximum before the lane (a warp
//     prefix max by shuffles, seeded with the maximum so far);
//   * iter_n's run: the distance to the last improving lane (a ballot),
//     or the lanes scanned so far; its break at run >= the cell's period;
//   * the stop events: OVL always, SAME when improving; the window edge
//     (end[p] < cur_start, or p < 0);
//   * the first event in scan order (the lowest set lane of a ballot) ends
//     the scan; the cell's value is the last improving lane before it (the
//     event lane itself when it is an improving stop), else its base.
//
// If `window` lanes pass with no event the cell takes the last improving
// lane of the window, as JAX does, and the read's fallback flag is raised
// (`incomplete`).  The envelope gate of chaining_jax.py (a non-singleton
// end group, a period >= 2^15 or an end >= 2^30) is computed in the same
// launch: a gated read is flagged and not run (its score 0, from -1).
// Cell 0 keeps its base score and from = -1; cells past n_hits hold score
// 0 and from -1.
//
// Work (the op counts chip_smoke.py uses for the bound, which charges
// the sequential scan's own work): ~29 int32 ops a predecessor lane
// scanned (get_con_score's 28: the connection test, matched, dlt, ilog2
// and the gap, the score; and the compare with the running maximum) and
// ~20 a cell.  The warp prefix max and ballots are this kernel's
// overhead on top.  What bounds it is the dependent chain of a cell: its
// scan reads score[p] written by the cells before it, so a read's cells
// run one after the other; reads run in parallel, a warp each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAIN_WARPS = 4;      // warps (reads) a CTA
constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(CHAIN_WARPS * 32)
    chain_dp_kernel(const int* __restrict__ ends,
                    const int* __restrict__ periods,
                    const int* __restrict__ n_hits, int B, int L, int k,
                    int window, int* score, int* from, uint8_t* fb) {
  const int row = blockIdx.x * CHAIN_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;
  const int* E = ends + (size_t)row * L;
  const int* P = periods + (size_t)row * L;
  int* S = score + (size_t)row * L;
  int* F = from + (size_t)row * L;
  const int n = min(max(n_hits[row], 0), L);

  int bad = 0;
  for (int i = lane; i < n; i += 32)
    bad |= P[i] >= (1 << 15) || E[i] >= (1 << 30) ||
           (i > 0 && E[i] == E[i - 1]);
  const bool gate = __ballot_sync(FULL, bad) != 0;
  for (int i = lane; i < L; i += 32) {
    S[i] = (!gate && i < n) ? k + min(k, P[i]) : 0;
    F[i] = -1;
  }
  __syncwarp();
  bool incomplete = false;
  for (int cur = 1; cur < n && !gate; ++cur) {
    const int ce = E[cur], cp = P[cur], cs = ce - cp;
    const int base = k + min(k, cp);
    int run_max = base, best = base, best_p = -1, iter = 0;
    for (int hi = cur - 1;; hi -= 32) {
      const int p = hi - lane;
      const bool in_win = cur - p <= window;
      bool valid = false, conn = false;
      int sc = NEG, dlt = 1, matched = 0;
      if (in_win && p >= 0) {
        const int pe = E[p], pp = P[p], ps = pe - pp;
        valid = pe >= cs;
        if (valid) {
          conn = cs > ps && 5 * cp < 9 * pp && 5 * pp < 9 * cp;
          const int dis1 = ce - pe, dis2 = cs - ps;
          matched = min(dis1, k) + min(dis2, k);
          dlt = abs(cp - pp);
          const int lg = 31 - __clz(max(dis1 + dis2, 1));
          if (conn) sc = S[p] + matched - (((dlt * dlt) >> 1) + (lg >> 1));
        }
      }
      // running maximum before this lane, in scan order
      int m = sc;
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(FULL, m, d);
        if (lane >= d) m = max(m, o);
      }
      int before = __shfl_up_sync(FULL, m, 1);
      before = max(lane ? before : NEG, run_max);
      const bool improving = conn && sc > before;
      const unsigned imp = __ballot_sync(FULL, improving);
      const unsigned upto = imp & (FULL >> (31 - lane));
      const int run = upto ? lane - (31 - __clz((int)upto)) : iter + lane + 1;
      const bool stop = conn && dlt == 0 && (matched < 2 * k || improving);
      const bool event = in_win && (!valid || stop || run >= cp);
      const unsigned ev = __ballot_sync(FULL, event);
      const unsigned stop_imp = __ballot_sync(FULL, stop && improving);
      const int e = ev ? __ffs((int)ev) - 1 : 32;
      unsigned take = e == 32 ? FULL : (1u << e) - 1;
      if (e < 32) take |= stop_imp & (1u << e);
      const unsigned cand = imp & take;
      if (cand) {
        const int wl = 31 - __clz((int)cand);
        best = __shfl_sync(FULL, sc, wl);
        best_p = hi - wl;
        run_max = best;
      }
      if (ev) break;
      if (hi - 31 <= cur - window) {     // the window ends in this chunk
        incomplete = true;
        break;
      }
      iter = imp ? 31 - (31 - __clz((int)imp)) : iter + 32;
    }
    if (lane == 0 && best_p >= 0) {
      S[cur] = best;
      F[cur] = best_p;
    }
    __syncwarp();
  }
  if (lane == 0) fb[row] = (uint8_t)(gate || incomplete);
}

}  // namespace

// ends, periods [B, L] int32 sorted by (end, period) per read, n_hits [B]
// int32, window >= 1; outputs score, from [B, L] int32 and fallback [B]
// uint8 (the envelope gate or an incomplete cell).
extern "C" int chain_dp(const void* ends, const void* periods,
                        const void* n_hits, int B, int L, int k, int window,
                        void* score, void* from, void* fallback,
                        void* stream) {
  if (B == 0 || L == 0) return 0;
  if (window < 1) return (int)cudaErrorInvalidValue;
  const int grid = (B + CHAIN_WARPS - 1) / CHAIN_WARPS;
  chain_dp_kernel<<<grid, CHAIN_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int*)ends, (const int*)periods, (const int*)n_hits, B, L, k,
      window, (int*)score, (int*)from, (uint8_t*)fallback);
  return (int)cudaGetLastError();
}
