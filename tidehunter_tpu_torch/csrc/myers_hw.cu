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
// Layout: one thread per problem.  The query (at most 128 bp) is W <= 2
// 64-bit words; its match masks peq[5][W] are built in registers from the
// query codes (0..4, 4 = N).  Queries and targets arrive concatenated in
// one byte buffer, addressed by int32 offsets and lengths (meta [5, B]:
// qoff, qlen, toff, tlen, k), so a target shared by several problems (the
// doubled consensus of the four adapter searches) is uploaded once and no
// row is padded.  The SHW pass reads the query and the target backwards
// from end: no reversed copy is built.
//
// The carry of the multi-word add runs low word to high; the left shift
// crosses words high to low, reading the lower word before it is shifted.
// HW injects 0 into bit 0 of ph (top row 0), SHW injects 1 (top row j).
//
// What bounds it: integer operations, a dependent chain of ~30 a target
// column and word, one column after the other; a thread's byte loads hit
// L1 after the first of each 32-byte sector.  The kernel spreads problems
// over threads only, so a launch of a few thousand problems fills ~30
// SMs: a simple kernel, right first (chip_smoke.py times it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr int MYERS_THREADS = 128;

template <int W>
struct MyersState {
  u64 pv[W], mv[W];
  int score;
};

// match masks of q[0..m) (rev: of the reversed query), bit i of word i/64
template <int W>
__device__ __forceinline__ void build_peq(const uint8_t* q, int m, bool rev,
                                          u64 (&peq)[5][W]) {
#pragma unroll
  for (int c = 0; c < 5; ++c)
#pragma unroll
    for (int w = 0; w < W; ++w) peq[c][w] = 0;
  for (int i = 0; i < m; ++i) {
    const int c = q[rev ? m - 1 - i : i];
    const u64 bit = 1ull << (i & 63);
    const int wi = i >> 6;
#pragma unroll
    for (int cc = 0; cc < 5; ++cc)
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (c == cc && wi == w) peq[cc][w] |= bit;
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

// One target column of code c: the vertical deltas and the score of the
// last query row (bit m - 1 = bit hb of word hw).
template <int W, bool SHW>
__device__ __forceinline__ void myers_step(const u64 (&peq)[5][W],
                                           const u64 (&mask)[W], int hw,
                                           int hb, int c, MyersState<W>& s) {
  u64 ph[W], mh[W], xv[W];
  u64 carry = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const u64 eq = c == 0   ? peq[0][w]
                   : c == 1 ? peq[1][w]
                   : c == 2 ? peq[2][w]
                   : c == 3 ? peq[3][w]
                            : peq[4][w];
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

template <int W>
__global__ void __launch_bounds__(MYERS_THREADS)
    myers_hw_kernel(const uint8_t* __restrict__ seq,
                    const int* __restrict__ meta, int B,
                    int* __restrict__ out) {
  const int b = blockIdx.x * MYERS_THREADS + threadIdx.x;
  if (b >= B) return;
  const int m = meta[B + b], n = meta[3 * B + b], k = meta[4 * B + b];
  const uint8_t* q = seq + (size_t)meta[b];
  const uint8_t* t = seq + (size_t)meta[2 * B + b];
  u64 mask[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int bits = min(max(m - 64 * w, 0), 64);
    mask[w] = bits >= 64 ? ~0ull : (1ull << bits) - 1;
  }
  const int hw = (m - 1) >> 6, hb = (m - 1) & 63;
  u64 peq[5][W];
  MyersState<W> s;

  // HW pass over t[0..n): the leftmost column of the least score
  build_peq<W>(q, m, false, peq);
  init_state<W>(mask, m, s);
  int best = 1 << 30, end = -1;
  for (int j = 0; j < n; ++j) {
    myers_step<W, false>(peq, mask, hw, hb, __ldg(t + j), s);
    if (s.score < best) {
      best = s.score;
      end = j;
    }
  }
  if (k >= 0 && best > k) {
    out[b] = out[B + b] = out[2 * B + b] = -1;
    return;
  }

  // SHW pass over the reversed query and t[end], ..., t[0]: the last
  // column whose score equals best
  build_peq<W>(q, m, true, peq);
  init_state<W>(mask, m, s);
  int pos = -1;
  for (int j = 0; j <= end; ++j) {
    myers_step<W, true>(peq, mask, hw, hb, __ldg(t + end - j), s);
    if (s.score == best) pos = j;
  }
  out[b] = best;
  out[B + b] = end - pos;
  out[2 * B + b] = end;
}

}  // namespace

// seq: query and target codes (0..4), concatenated; meta [5, B] int32:
// qoff, qlen (1..64 W), toff, tlen (>= 1), k; out [3, B] int32: ed, start,
// end (-1, -1, -1 when k >= 0 and ed > k).  W: 64-bit words a query, 1 or
// 2, at least ceil(max qlen / 64).
extern "C" int myers_hw(const void* seq, const void* meta, int B, int W,
                        void* out, void* stream) {
  if (B == 0) return 0;
  const int grid = (B + MYERS_THREADS - 1) / MYERS_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  if (W == 1)
    myers_hw_kernel<1><<<grid, MYERS_THREADS, 0, s>>>(
        (const uint8_t*)seq, (const int*)meta, B, (int*)out);
  else if (W == 2)
    myers_hw_kernel<2><<<grid, MYERS_THREADS, 0, s>>>(
        (const uint8_t*)seq, (const int*)meta, B, (int*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
