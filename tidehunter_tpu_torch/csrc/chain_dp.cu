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
// ~20 a cell.  What bounds this kernel is one read's sequence of cells:
// a cell's scan reads score[p] written by the cells before it, so a read's
// cells run one after the other on one warp, and a launch takes as long as
// its longest read (the slice chunk's row of most hits alone, B=1, within
// 7% of all 512 rows on an H100: chip_smoke.py).  A chunk costs the warp
// ~55 instructions and ~600 cycles there, about as much when four
// chunks' independent loads and reductions are issued side by side, so
// neither one chunk's dependency chain nor the memory sets it: the warp
// is bound by instruction issue at a low IPC, alone on its scheduler, and
// the design cuts the instructions and memory latency of a chunk:
//
//   * holds a read's planes (E, P, S: 12 bytes a hit) in shared memory,
//     copied in with coalesced loads and S written back at the end; a CTA
//     has as many warps (reads) as its shared memory holds, at most
//     CHAIN_WARPS and no more than the launch needs to fill the SMs.  A
//     plane too wide for one warp's share runs the same scan over global
//     memory (a route of the same kernel, the same results);
//   * computes a chunk's S-free terms branch-free and loads them with
//     the chunk's scores one chunk ahead (a cell's first chunk during the
//     cell before: only lane 0's score, p = cur - 1, waits on that cell);
//   * resolves a chunk in which no lane's run can reach the period (iter +
//     32 < cp: nearly all of them) by reduction instead of the prefix max:
//     the first S-free event (window edge, OVL), the SAME lanes before it
//     (rare; each tested against its own prefix maximum), and the first
//     lane holding the greatest score up to the event, which is the last
//     improving lane if it beats the running maximum (no lane improves
//     otherwise: the chunk is skipped);
//   * keeps the cell's result in every lane, so that each lane writes
//     S[cur] itself and no warp barrier separates the cells.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int CHAIN_WARPS = 4;      // at most this many warps (reads) a CTA
constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;

struct Cell {
  int ce, cp, cs, base;
};

// a predecessor lane's terms that do not read the score plane
struct Terms {
  int add;                           // matched - gap (conn lanes)
  bool in_win, valid, conn, stop0, stopm;
};

__device__ __forceinline__ Cell cell_at(const int* E, const int* P, int cur,
                                        int k) {
  const int ce = E[cur], cp = P[cur];
  return {ce, cp, ce - cp, k + min(k, cp)};
}

// Branch-free: a lane out of the window or before the first hit loads
// hit 0 and is masked, so that the loads of a chunk issue together.
__device__ __forceinline__ Terms terms(const int* E, const int* P,
                                       const Cell& c, int cur, int p,
                                       int window, int k) {
  Terms t;
  t.in_win = cur - p <= window;
  const int q = max(p, 0);
  const int pe = E[q], pp = P[q], ps = pe - pp;
  t.valid = t.in_win && p >= 0 && pe >= c.cs;
  t.conn = t.valid && c.cs > ps && 5 * c.cp < 9 * pp && 5 * pp < 9 * c.cp;
  const int dis1 = c.ce - pe, dis2 = c.cs - ps;
  const int matched = min(dis1, k) + min(dis2, k);
  const int dlt = abs(c.cp - pp);
  const int lg = 31 - __clz(max(dis1 + dis2, 1));
  t.add = matched - (((dlt * dlt) >> 1) + (lg >> 1));
  t.stop0 = t.conn && dlt == 0;            // SAME or OVL
  t.stopm = t.stop0 && matched < 2 * k;    // OVL: stops either way
  return t;
}

// The running state of a cell's scan.
struct Scan {
  int run_max, best, best_p, iter;
};

// Resolve a chunk (lane l at p = hi - l, its score candidate sc: NEG off
// conn lanes) against the scan's state.  Returns the event ballot
// (nonzero: the scan ends here); updates st.
//
// While iter + 32 < cp no lane's run can reach the period, so the events
// are the window edge, OVL (both S-free) and an improving SAME; and the
// chunk's value, the last improving lane up to the first event, is the
// first lane holding the greatest sc there, if that beats run_max (the
// improving lanes are the strict running maxima above it).  That takes
// two ballots, one __reduce_max_sync and one more ballot, instead of the
// warp prefix max; a SAME lane before the first S-free event is tested
// with its own prefix maximum (one more reduction each, rare).  Past that
// point the full resolution runs: the prefix max, the improving lanes,
// iter_n's run, the stops.
__device__ __forceinline__ unsigned resolve(const Terms& t, int sc, int hi,
                                            int cp, Scan& st) {
  const int lane = threadIdx.x & 31;
  if (st.iter + 32 < cp) {
    const unsigned ev0 =
        __ballot_sync(FULL, t.in_win && (!t.valid || t.stopm));
    const int e0 = ev0 ? __ffs((int)ev0) - 1 : 32;
    const unsigned below = e0 == 32 ? FULL : (1u << e0) - 1;
    unsigned same =
        __ballot_sync(FULL, t.in_win && t.stop0 && !t.stopm) & below;
    // the lanes the chunk's value may come from: up to and with the first
    // event (an improving OVL lane counts, an invalid one holds NEG)
    unsigned upto = e0 == 32 ? FULL : (2u << e0) - 1;
    unsigned ev = ev0;
    while (same) {                 // an improving SAME lane ends the scan
      const int j = __ffs((int)same) - 1;
      const int pm = __reduce_max_sync(FULL, lane < j ? sc : NEG);
      const int scj = __shfl_sync(FULL, sc, j);
      if (scj > max(pm, st.run_max)) {
        upto = (2u << j) - 1;
        ev = 1u << j;
        break;
      }
      same &= same - 1;
    }
    const bool in = (upto >> lane) & 1;
    const int m = __reduce_max_sync(FULL, in ? sc : NEG);
    if (m > st.run_max) {
      const int wl = __ffs((int)__ballot_sync(FULL, in && sc == m)) - 1;
      st.best = st.run_max = m;
      st.best_p = hi - wl;
      st.iter = 31 - wl;
    } else {
      st.iter += 32;
    }
    return ev;
  }
  // running maximum before this lane, in scan order
  int m = sc;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, m, d);
    if (lane >= d) m = max(m, o);
  }
  int before = __shfl_up_sync(FULL, m, 1);
  before = max(lane ? before : NEG, st.run_max);
  const bool improving = t.conn && sc > before;
  const unsigned imp = __ballot_sync(FULL, improving);
  const unsigned upto = imp & (FULL >> (31 - lane));
  const int run = upto ? lane - (31 - __clz((int)upto)) : st.iter + lane + 1;
  const bool stop = t.stopm || (t.stop0 && improving);
  const unsigned ev =
      __ballot_sync(FULL, t.in_win && (!t.valid || stop || run >= cp));
  const unsigned stop_imp = __ballot_sync(FULL, stop && improving);
  const int e = ev ? __ffs((int)ev) - 1 : 32;
  unsigned take = e == 32 ? FULL : (1u << e) - 1;
  if (e < 32) take |= stop_imp & (1u << e);
  const unsigned cand = imp & take;
  const int wl = cand ? 31 - __clz((int)cand) : 0;
  const int bsc = __shfl_sync(FULL, sc, wl);
  if (cand) {
    st.best = bsc;
    st.best_p = hi - wl;
    st.run_max = bsc;
  }
  st.iter = imp ? 31 - (31 - __clz((int)imp)) : st.iter + 32;
  return ev;
}

// One read's scan over its planes E, P (read) and S (scores: bases in,
// the DP's scores out), F (from: -1 in); lane 0 writes F[cur], every lane
// S[cur] (the same value, each lane reading back its own store).  A
// cell's first chunk (its terms and the scores of lanes p <= cur - 2, final
// by then) is loaded during the cell before, so that only lane 0's score,
// the previous cell's result, waits on that cell; a later chunk is loaded
// while the one before it resolves.  Returns the read's `incomplete`.
__device__ bool chain_scan(const int* E, const int* P, int* S, int* F,
                           int n, int k, int window) {
  const int lane = threadIdx.x & 31;
  bool incomplete = false;
  if (n < 2) return false;
  int s_prev = S[0];                  // the cell before's score
  Cell c = cell_at(E, P, 1, k);
  Terms f = terms(E, P, c, 1, -lane, window, k);
  int fs = S[0];
  for (int cur = 1; cur < n; ++cur) {
    // the next cell's first chunk (the last cell's again at the end)
    const int nx = min(cur + 1, n - 1);
    const Cell cn = cell_at(E, P, nx, k);
    const Terms fn = terms(E, P, cn, nx, nx - 1 - lane, window, k);
    const int fns = S[max(nx - 1 - lane, 0)];    // lane 0's is s_prev
    Scan st{c.base, c.base, -1, 0};
    unsigned ev = resolve(f, f.conn ? (lane ? fs : s_prev) + f.add : NEG,
                          cur - 1, c.cp, st);
    bool edge = cur - 32 <= cur - window;    // the window ends here
    if (!ev && !edge) {
      int hi = cur - 33;
      Terms t = terms(E, P, c, cur, hi - lane, window, k);
      int ts = S[max(hi - lane, 0)];
      for (;; hi -= 32) {
        const Terms tn = terms(E, P, c, cur, hi - 32 - lane, window, k);
        const int tns = S[max(hi - 32 - lane, 0)];
        ev = resolve(t, t.conn ? ts + t.add : NEG, hi, c.cp, st);
        edge = hi - 31 <= cur - window;
        if (ev || edge) break;
        t = tn;
        ts = tns;
      }
    }
    incomplete |= !ev;
    // st is the same in every lane: each lane writes S[cur] and later
    // reads it back itself, so no lane waits for another's store
    if (st.best_p >= 0) {
      S[cur] = st.best;
      if (lane == 0) F[cur] = st.best_p;
    }
    s_prev = st.best;
    c = cn;
    f = fn;
    fs = fns;
  }
  return incomplete;
}

// SMEM: a warp's planes in shared memory (Lp ints each), else the scan
// runs over the outputs in global memory
template <bool SMEM>
__global__ void __launch_bounds__(CHAIN_WARPS * 32)
    chain_dp_kernel(const int* __restrict__ ends,
                    const int* __restrict__ periods,
                    const int* __restrict__ n_hits, int B, int L, int Lp,
                    int k, int window, int* score, int* from, uint8_t* fb) {
  extern __shared__ int4 chain_s[];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + wid;
  if (row >= B) return;
  const int* Eg = ends + (size_t)row * L;
  const int* Pg = periods + (size_t)row * L;
  int* Sg = score + (size_t)row * L;
  int* F = from + (size_t)row * L;
  const int n = min(max(n_hits[row], 0), L);
  int* E = SMEM ? (int*)chain_s + (size_t)wid * 3 * Lp : nullptr;
  int* P = SMEM ? E + Lp : nullptr;
  int* S = SMEM ? P + Lp : Sg;

  int bad = 0;
  for (int i = lane; i < n; i += 32) {
    const int e = Eg[i], p = Pg[i];
    bad |= p >= (1 << 15) || e >= (1 << 30) || (i > 0 && e == Eg[i - 1]);
    if (SMEM) {
      E[i] = e;
      P[i] = p;
    }
  }
  const bool gate = __ballot_sync(FULL, bad) != 0;
  for (int i = lane; i < (SMEM ? n : L); i += 32)
    S[i] = (!gate && i < n) ? k + min(k, (SMEM ? P : Pg)[i]) : 0;
  for (int i = lane; i < L; i += 32) F[i] = -1;
  __syncwarp();
  const bool incomplete =
      !gate && (SMEM ? chain_scan(E, P, S, F, n, k, window)
                     : chain_scan(Eg, Pg, S, F, n, k, window));
  if (SMEM)
    for (int i = lane; i < L; i += 32) Sg[i] = (!gate && i < n) ? S[i] : 0;
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
  int dev = 0, cap = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc)
    rc = (int)cudaDeviceGetAttribute(
        &cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!rc)
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc) return rc;
  // a warp's planes: E, P and S of Lp ints (16-byte aligned)
  const int Lp = (L + 3) & ~3;
  const size_t warp_bytes = (size_t)Lp * 3 * sizeof(int);
  const int fit = (int)std::min<size_t>(CHAIN_WARPS, cap / warp_bytes);
  cudaStream_t s = (cudaStream_t)stream;
  if (fit == 0) {
    const int grid = (B + CHAIN_WARPS - 1) / CHAIN_WARPS;
    chain_dp_kernel<false><<<grid, CHAIN_WARPS * 32, 0, s>>>(
        (const int*)ends, (const int*)periods, (const int*)n_hits, B, L, Lp,
        k, window, (int*)score, (int*)from, (uint8_t*)fallback);
    return (int)cudaGetLastError();
  }
  // as few warps a CTA as fill the SMs: each read is one dependent chain
  const int nwc = std::max(1, std::min(fit, (B + sms - 1) / std::max(sms, 1)));
  const size_t smem = warp_bytes * nwc;
  rc = (int)cudaFuncSetAttribute(chain_dp_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
  if (rc) return rc;
  const int grid = (B + nwc - 1) / nwc;
  chain_dp_kernel<true><<<grid, nwc * 32, smem, s>>>(
      (const int*)ends, (const int*)periods, (const int*)n_hits, B, L, Lp, k,
      window, (int*)score, (int*)from, (uint8_t*)fallback);
  return (int)cudaGetLastError();
}
