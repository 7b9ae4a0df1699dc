// Myers bit-parallel infix search (edlib's HW mode) for Hopper (sm_90a).
//
// Replaces tidehunter_tpu/ops/myers_jax.py: _scan_batch, the lax.scan
// over the padded target that hw_batch runs twice a round (the HW pass,
// then the SHW start pass over the reversed query and the reversed target
// prefix, with a host rebuild of both between them).  Here one launch runs
// both passes and one pull brings back (ed, start, end).
//
// Semantics (ops/myers.align_hw, edlib's calculateBlock over 64-bit words):
//   end   = the LEFTMOST target position with the least distance;
//   start = end - pos, where pos is the LAST position of the SHW pass over
//           the reversed query and t[end], t[end - 1], ..., t[0] whose
//           score equals that distance;
//   k >= 0 and ed > k gives (-1, -1, -1) and skips the SHW pass.
//
// Layout: a problem takes P lanes (a power of two, 1 to MYERS_THREADS) of
// a CTA of MYERS_THREADS threads: several problems a warp, a warp, or
// several warps.  The launcher takes the most lanes that keep B P within
// LANES_PER_SM lanes an SM of the data's card (myers_hw_lanes).  The query
// (at most 128 bp) is W <= 2 64-bit words.  Queries and targets arrive
// concatenated in one byte buffer, addressed by int32 offsets and lengths
// (meta [5, B]: qoff, qlen, toff, tlen, k), so a target shared by several
// problems (the doubled consensus of the four adapter searches) is
// uploaded once and no row is padded.
//   1. Match masks peq[5][W]: for each problem of the warp in turn, each
//      lane takes one query base of every 32 and the warp votes once a
//      code (__ballot_sync); the reversed query's masks are their bit
//      reversal, so the SHW pass builds nothing.  Each thread keeps its
//      masks in its own column of shared memory and loads a column's one
//      column ahead (its base two ahead), so the step has no select by
//      code on its chain.
//   2. HW pass, split over the lanes: lane s owns target columns
//      [s S, s S + S), S = ceil(n / P), and first runs O columns before
//      them from the fresh state without reporting them, O = m + min(k, m)
//      - 1 (k < 0: 2m - 1).  An alignment of cost d spans at most m + d
//      columns, so a state started O columns before a column scores it
//      exactly whenever the true score is at most k (at most m: always);
//      a fresh state only drops alignment starts, so it never scores a
//      column lower.  The leftmost least (score, column) therefore
//      survives a min over the lanes' keys (score << 32 | column): xor
//      shuffles within the warp, shared memory across its warps.
//   3. SHW pass, on the problem's first lane: the score at column j of
//      the reversed prefix is at least j + 1 - m, so no column past
//      m + ed - 1 can equal ed, and the pass stops after min(end + 1,
//      m + ed) columns (at most 256).  It reads the query and the target
//      backwards from end: no reversed copy is built.
//
// The carry of the multi-word add runs low word to high; the left shift
// crosses words high to low, reading the lower word before it is shifted.
// HW injects 0 into bit 0 of ph (top row 0), SHW injects 1 (top row j).
//
// What holds it back: a target column is a dependent chain of integer
// operations (~30 a word), one column after the other, and a warp issues
// one instruction a clock.  The first version (a thread a problem) walked
// n + end + 1 columns a problem on a few SMs.  Here a problem's critical
// path is ceil(n / P) + O HW columns plus at most m + ed SHW columns, and
// the launch aims at one warp a scheduler (LANES_PER_SM): two warps a
// scheduler (256) or four (512) were slower on the adapter rows, since a
// column's instructions, not its latency, then set the pace
// (chip_smoke.py --kernels myers_hw; PERF.md).  What is left: the warm-up
// and the SHW pass, on one lane a problem, are about half of the adapter
// path's columns, and a launch of fewer problems than SMs holds a problem
// on one SM.
//
// Target bytes: each lane reads its own segment through __ldg, a byte a
// column, so one 32-byte sector serves 32 columns from L1.  The engine
// sends a consensus's four adapter searches as four consecutive problems
// (an hws request, flattened in order; pack keeps that order), starting
// at a multiple of 4.  A CTA holds 128 / P problems, a multiple of 4 for
// P <= 32, so the four land in one CTA (in one warp for P <= 8: the
// adapter rows run at P = 4 and 8), and lane s of each reads the same
// segment on the same SM: the target leaves HBM and L2 once for the
// four.  Staging it in shared memory would add a copy and a barrier for
// bytes L1 already holds.  At P >= 64 (B at most 2 x the SM count) a
// problem spans half a CTA or more and the four are on 2-4 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr int MYERS_THREADS = 128;   // a CTA, and the most lanes a problem
constexpr int LANES_PER_SM = 128;    // the lanes a launch aims at an SM
constexpr unsigned FULL = 0xffffffffu;
constexpr u64 NO_KEY = ~0ull;        // a lane with no column of its own

template <int W>
struct MyersState {
  u64 pv[W], mv[W];
  int score;
};

// the match masks of the query of each problem of this warp (mine: the
// index of this lane's among them), bit i of word i / 64 for base i
template <int W>
__device__ __forceinline__ void build_peq(const uint8_t* seq,
                                          const int* meta, int B, int b0,
                                          int groups, int mine, int lane,
                                          u64 (&peq)[5][W]) {
#pragma unroll
  for (int c = 0; c < 5; ++c)
#pragma unroll
    for (int w = 0; w < W; ++w) peq[c][w] = 0;
  for (int g = 0; g < groups; ++g) {
    const int b = b0 + g;
    const int m = b < B ? meta[B + b] : 0;
    const uint8_t* q = seq + (b < B ? (size_t)meta[b] : 0);
#pragma unroll
    for (int r = 0; r < 2 * W; ++r) {
      const int i = 32 * r + lane;
      const int code = i < m ? __ldg(q + i) : 5;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const u64 bits = __ballot_sync(FULL, code == c);
        if (g == mine) peq[c][r >> 1] |= bits << (32 * (r & 1));
      }
    }
  }
}

// this thread's masks (ps, as the kernel lays them out) made the reversed
// query's: bit i -> bit m - 1 - i
template <int W>
__device__ __forceinline__ void reverse_peq(int m, u64* ps) {
  const int s = 64 * W - m;       // 0 <= s < 64 W
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    u64* p = ps + c * W * MYERS_THREADS;
    u64 v[W];
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = __brevll(p[(W - 1 - w) * MYERS_THREADS]);
    if (W == 1) {
      p[0] = v[0] >> s;
    } else if (s >= 64) {
      p[0] = v[W - 1] >> (s - 64);
      p[(W - 1) * MYERS_THREADS] = 0;
    } else {
      p[0] = s ? (v[0] >> s) | (v[W - 1] << (64 - s)) : v[0];
      p[(W - 1) * MYERS_THREADS] = v[W - 1] >> s;
    }
  }
}

template <int W>
__device__ __forceinline__ void init_state(const u64 (&mask)[W], int m,
                                           MyersState<W>& s) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    s.pv[w] = mask[w];
    s.mv[w] = 0;
  }
  s.score = m;
}

// One target column whose base matches the query at eqs: the vertical
// deltas and the score of the last query row (bit m - 1 = bit hb of word
// hw).
template <int W, bool SHW>
__device__ __forceinline__ void myers_step(const u64 (&eqs)[W],
                                           const u64 (&mask)[W], int hw,
                                           int hb, MyersState<W>& s) {
  u64 ph[W], mh[W], xv[W];
  u64 carry = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const u64 eq = eqs[w];
    xv[w] = eq | s.mv[w];
    // (eq & pv) + pv over all W words
    const u64 t1 = (eq & s.pv[w]) + s.pv[w];
    const u64 c1 = t1 < s.pv[w];
    const u64 sum = t1 + carry;
    carry = c1 | (u64)(sum < t1);
    const u64 xh = (sum ^ s.pv[w]) | eq;
    ph[w] = s.mv[w] | (~(xh | s.pv[w]) & mask[w]);
    mh[w] = s.pv[w] & xh;
  }
  const u64 phw = (W > 1 && hw) ? ph[W - 1] : ph[0];
  const u64 mhw = (W > 1 && hw) ? mh[W - 1] : mh[0];
  s.score += (int)((phw >> hb) & 1) - (int)((mhw >> hb) & 1);
#pragma unroll
  for (int w = W - 1; w >= 0; --w) {
    const u64 lp = w ? ph[w > 0 ? w - 1 : 0] >> 63 : (SHW ? 1ull : 0ull);
    const u64 lm = w ? mh[w > 0 ? w - 1 : 0] >> 63 : 0ull;
    ph[w] = ((ph[w] << 1) | lp) & mask[w];
    mh[w] = ((mh[w] << 1) | lm) & mask[w];
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    s.pv[w] = mh[w] | (~(xv[w] | ph[w]) & mask[w]);
    s.mv[w] = ph[w] & xv[w];
  }
}

// columns [j, e) of t from state s, this thread's match masks at
// ps[(c W + w) MYERS_THREADS]: each column's base read two columns ahead
// and its masks one column ahead, off the step's chain; visit(j, score)
// after each column.  REV: t[-j], t[-j - 1], ...
template <int W, bool SHW, bool REV, class F>
__device__ __forceinline__ void scan_cols(const uint8_t* t, int j, int e,
                                          const u64* ps,
                                          const u64 (&mask)[W], int hw,
                                          int hb, MyersState<W>& s,
                                          F visit) {
  const int last = e - 1;
  int c1 = __ldg(REV ? t - min(j + 1, last) : t + min(j + 1, last));
  const int c0 = __ldg(REV ? t - j : t + j);
  u64 eq[W];
#pragma unroll
  for (int w = 0; w < W; ++w) eq[w] = ps[(c0 * W + w) * MYERS_THREADS];
  for (; j < e; ++j) {
    const int c2 = __ldg(REV ? t - min(j + 2, last) : t + min(j + 2, last));
    u64 eq1[W];
#pragma unroll
    for (int w = 0; w < W; ++w) eq1[w] = ps[(c1 * W + w) * MYERS_THREADS];
    myers_step<W, SHW>(eq, mask, hw, hb, s);
    visit(j, s.score);
#pragma unroll
    for (int w = 0; w < W; ++w) eq[w] = eq1[w];
    c1 = c2;
  }
}

// P = 1 << lg lanes a problem; problem b = thread >> lg, segment thread &
// (P - 1).  Every thread takes part in the votes and the reduction; only
// then do the lanes part.
template <int W>
__global__ void __launch_bounds__(MYERS_THREADS)
    myers_hw_kernel(const uint8_t* __restrict__ seq,
                    const int* __restrict__ meta, int B, int lg,
                    int* __restrict__ out) {
  // each thread's match masks [5][W][MYERS_THREADS], then each warp's
  // least key (P > 32)
  extern __shared__ u64 myers_s[];
  u64* ps = myers_s + threadIdx.x;
  u64* keys = myers_s + 5 * W * MYERS_THREADS;
  const int P = 1 << lg;
  const int tid = blockIdx.x * MYERS_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31, b = tid >> lg, seg = tid & (P - 1);
  const bool live = b < B;
  const int m = live ? meta[B + b] : 1, n = live ? meta[3 * B + b] : 0;
  const int k = live ? meta[4 * B + b] : -1;
  const uint8_t* t = seq + (live ? (size_t)meta[2 * B + b] : 0);
  u64 mask[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int bits = min(max(m - 64 * w, 0), 64);
    mask[w] = bits >= 64 ? ~0ull : (1ull << bits) - 1;
  }
  const int hw = (m - 1) >> 6, hb = (m - 1) & 63;
  u64 peq[5][W];
  const int groups = P >= 32 ? 1 : 32 >> lg;
  build_peq<W>(seq, meta, B, (tid - lane) >> lg, groups,
               P >= 32 ? 0 : lane >> lg, lane, peq);
#pragma unroll
  for (int c = 0; c < 5; ++c)
#pragma unroll
    for (int w = 0; w < W; ++w) ps[(c * W + w) * MYERS_THREADS] = peq[c][w];

  // HW pass: this lane's segment [a, e) after O warm-up columns
  const int S = (n + P - 1) >> lg;
  const int a = min(n, seg * S), e = min(n, a + S);
  const int O = m + ((k < 0 || k > m) ? m : k) - 1;
  u64 key = NO_KEY;
  if (a < e) {
    MyersState<W> s;
    init_state<W>(mask, m, s);
    int best = 1 << 30, col = -1;
    scan_cols<W, false, false>(t, max(0, a - O), e, ps, mask, hw, hb, s,
                               [&](int j, int sc) {
                                 if (j >= a && sc < best) {
                                   best = sc;
                                   col = j;
                                 }
                               });
    key = ((u64)best << 32) | (unsigned)col;
  }
  // the least key of the problem's lanes
  for (int d = 1; d < min(P, 32); d <<= 1)
    key = min(key, __shfl_xor_sync(FULL, key, d));
  if (P > 32) {
    if (lane == 0) keys[threadIdx.x >> 5] = key;
    __syncthreads();
    const int w0 = (threadIdx.x >> 5) & ~((P >> 5) - 1);
    for (int w = 0; w < P >> 5; ++w) key = min(key, keys[w0 + w]);
  }
  if (!live || seg) return;
  const int best = (int)(key >> 32), end = (int)(unsigned)key;
  if (k >= 0 && best > k) {
    out[b] = out[B + b] = out[2 * B + b] = -1;
    return;
  }

  // SHW pass over the reversed query and t[end], ..., t[0]: the last
  // column whose score equals best, among the first min(end + 1, m + best)
  reverse_peq<W>(m, ps);
  MyersState<W> s;
  init_state<W>(mask, m, s);
  int pos = -1;
  scan_cols<W, true, true>(t + end, 0, min(end + 1, m + best), ps, mask, hw,
                           hb, s, [&](int j, int sc) {
                             if (sc == best) pos = j;
                           });
  out[b] = best;
  out[B + b] = end - pos;
  out[2 * B + b] = end;
}

// log2 of the lanes a problem on the current device, or a CUDA error < 0
int lanes_log2(int B) {
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (!rc)
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
  if (rc) return -rc;
  int lg = 0;
  while ((1 << lg) < MYERS_THREADS &&
         (long long)B << (lg + 1) <= (long long)LANES_PER_SM * sms)
    ++lg;
  return lg;
}

}  // namespace

// The lanes a problem myers_hw gives a launch of B problems on the
// current device: the largest power of two P <= MYERS_THREADS with B P <=
// LANES_PER_SM x its SMs, at least 1; -1 if the device cannot be queried.
extern "C" int myers_hw_lanes(int B) {
  const int lg = lanes_log2(B);
  return lg < 0 ? -1 : 1 << lg;
}

// seq: query and target codes (0..4), concatenated; meta [5, B] int32:
// qoff, qlen (1..64 W), toff, tlen (>= 1), k; out [3, B] int32: ed, start,
// end (-1, -1, -1 when k >= 0 and ed > k).  W: 64-bit words a query, 1 or
// 2, at least ceil(max qlen / 64).
extern "C" int myers_hw(const void* seq, const void* meta, int B, int W,
                        void* out, void* stream) {
  if (B == 0) return 0;
  if (W != 1 && W != 2) return (int)cudaErrorInvalidValue;
  const int lg = lanes_log2(B);
  if (lg < 0) return -lg;
  const long long threads = (long long)B << lg;
  const int grid = (int)((threads + MYERS_THREADS - 1) / MYERS_THREADS);
  const size_t smem = (5 * W * MYERS_THREADS + MYERS_THREADS / 32) *
                      sizeof(u64);
  cudaStream_t s = (cudaStream_t)stream;
  if (W == 1)
    myers_hw_kernel<1><<<grid, MYERS_THREADS, smem, s>>>(
        (const uint8_t*)seq, (const int*)meta, B, lg, (int*)out);
  else
    myers_hw_kernel<2><<<grid, MYERS_THREADS, smem, s>>>(
        (const uint8_t*)seq, (const int*)meta, B, lg, (int*)out);
  return (int)cudaGetLastError();
}
