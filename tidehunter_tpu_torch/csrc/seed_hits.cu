// Tandem self-hit seeding for Hopper (sm_90a).
//
// Replaces tidehunter_tpu/ops/seeding_jax.py: collect_hits_batch (the
// 3-key merge of 2L records) and collect_hits_packed (one packed-key sort
// and a binary search), with their shared front half _keys_valid_positions
// and _hpc_compact.  On the TPU both are XLA sort dataflows over the whole
// padded batch; here one CTA seeds one read with everything it needs in
// shared memory:
//
//   1. the stream: the read's codes (0..3, 4 = N), or with hpc the last
//      base of each homopolymer run and its read position, compacted by a
//      block-wide prefix sum of the kept indices;
//   2. each stream lane's rolling key (the k bases before it, the newest
//      in the low bits) and its validity (k bases in the stream, no N);
//   3. with w > 1: the minimizer passes (the least key of every window of
//      w lanes, then a lane stays a seed iff some window covering it has
//      its key as the least) and the JAX package's fallback rules: any N,
//      fewer than w seeds, and with hpc a k-mer spanning >= 255 read bases
//      (its first span the conservative position[2k - 2] + 1);
//   4. the seed words (key, position) in lane order, sentinels past the
//      stream: 32 bits (key << pb | position) where 2k + pb <= 31, else
//      64 bits (key << 32 | position), so that the k = 16 poly-T key
//      0xFFFFFFFF stays below the sentinel; a bitonic sort of the row's
//      next power of two of words;
//   5. a binary search per query lane for the last word <= (key, position
//      - min_p): the nearest earlier occurrence at least min_p back;
//   6. the hits (period <= max_p) compacted in lane order by a block-wide
//      prefix sum.  A read has at most one query per position, so lane
//      order is (end, period) order: no second sort.
//
// A read whose arrays do not fit in shared memory runs the same code over
// a global scratch of seed_hits_row_bytes a read (the caller allocates
// seed_hits_scratch_bytes); __syncthreads orders a block's global writes
// as it does its shared ones.
//
// Work (the op counts chip_smoke.py uses for the bound, which charges
// the seeding function's own work, not this kernel's sort network): a
// stream lane costs ~6 int32 ops per key base (k of them) and ~30 more
// (validity, word, search set-up, compaction); a binary-search step ~6
// (9 with 64-bit words), ceil(log2 s) + 1 steps a query for a row of
// stream length s; with w > 1, ~8 a lane and window offset in each of the
// two passes; and the sort of the row's s live words, s * ceil(log2 s)
// compares of ~10 (16) ops.  The bitonic network here does more: Nr/2 *
// log2(Nr) * (log2(Nr) + 1) / 2 compare-exchanges over Nr = the next
// power of two >= s, with a block barrier between its stages; that excess
// and those barriers are what keep the kernel off its bound.  Bytes are
// no limit (a read is ~9 bytes a base in and out).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr int SCAN_BYTES = 256;      // block-scan scratch, head of smem
constexpr int SMEM_CAP = 232448;     // dynamic shared memory a CTA, sm_90
constexpr int INT32_MAX_ = 0x7fffffff;
constexpr int HPC_INF = 1 << 30;

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// byte offsets of a read's arrays in its shared memory or scratch row
struct Layout {
  size_t words, key, pos, wmin, stream, valid, total;
};

__host__ __device__ inline Layout seed_layout(int L, int hpc, int w,
                                              int wide) {
  Layout o;
  size_t at = 0;
  o.words = at;
  at += (size_t)pow2_at_least(L > 0 ? L : 1) * (wide ? 8 : 4);
  o.key = at;
  at += (size_t)L * 4;
  o.pos = at;
  if (hpc) at += (size_t)L * 4;
  o.wmin = at;
  if (w > 1) at += (size_t)L * 4;
  o.stream = at;
  at += L;
  o.valid = at;
  at += L;
  o.total = (at + 15) & ~(size_t)15;
  return o;
}

// exclusive prefix sum of v over the block in thread order; *total gets
// the block's sum.  Every thread of the block must call it.
__device__ int block_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? red[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < nw) red[lane] = s;
  }
  __syncthreads();
  const int before = warp ? red[warp - 1] : 0;
  *total = red[nw - 1];
  __syncthreads();
  return before + x - v;
}

template <bool WIDE>
struct Word;
template <>
struct Word<false> {
  typedef uint32_t T;
  static __device__ T make(uint32_t key, int pos, int pb) {
    return (key << pb) | (uint32_t)pos;
  }
  static __device__ uint32_t key(T w, int pb) { return w >> pb; }
  static __device__ int pos(T w, int pb) {
    return (int)(w & ((1u << pb) - 1));
  }
  static __device__ T maxw() { return 0xffffffffu; }
};
template <>
struct Word<true> {
  typedef u64 T;
  static __device__ T make(uint32_t key, int pos, int) {
    return ((u64)key << 32) | (uint32_t)pos;
  }
  static __device__ uint32_t key(T w, int) { return (uint32_t)(w >> 32); }
  static __device__ int pos(T w, int) { return (int)(uint32_t)w; }
  static __device__ T maxw() { return ~0ull; }
};

struct SeedArgs {
  const uint8_t* codes;
  const int* lens;
  int L, k, w, hpc, min_p, max_p, pb, packed;
  uint8_t* scratch;
  size_t row_bytes;
  int* ends;       // [B, L]: ends, or packed (end << pb | period) words
  int* periods;    // [B, L] (unused when packed)
  int* n_hits;     // [B]
  uint8_t* fb;     // [B] 0/1
};

template <bool WIDE>
__global__ void __launch_bounds__(1024) seed_hits_kernel(SeedArgs a) {
  typedef Word<WIDE> Wd;
  typedef typename Wd::T word_t;
  extern __shared__ uint2 seed_s[];
  int* red = (int*)seed_s;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int L = a.L, k = a.k, w = a.w, pb = a.pb;
  uint8_t* base = a.scratch ? a.scratch + (size_t)b * a.row_bytes
                            : (uint8_t*)seed_s + SCAN_BYTES;
  const Layout lay = seed_layout(L, a.hpc, w, WIDE);
  word_t* words = (word_t*)(base + lay.words);
  uint32_t* key = (uint32_t*)(base + lay.key);
  int* pos = (int*)(base + lay.pos);
  uint32_t* wmin = (uint32_t*)(base + lay.wmin);
  uint8_t* stream = base + lay.stream;
  uint8_t* valid = base + lay.valid;
  const uint8_t* read = a.codes + (size_t)b * L;
  const int len = min(max(a.lens[b], 0), L);
  // each thread's contiguous run of indices, for the order-keeping scans
  const int ch = (L + nt - 1) / nt;
  const int c0 = min(tid * ch, L), c1 = min(c0 + ch, L);
  int total;

  // 1. the stream (and with hpc its read positions)
  int n_in = 0, kept = 0;
  for (int i = c0; i < c1; ++i) {
    if (i >= len) break;
    const int c = read[i];
    n_in += c >= 4;
    kept += !a.hpc || i + 1 >= len || read[i + 1] != c;
  }
  int at = block_scan(kept, red, &total);
  const int slen = a.hpc ? total : len;
  for (int i = c0; i < c1 && i < len; ++i) {
    const int c = read[i];
    if (!a.hpc) {
      stream[i] = (uint8_t)c;
    } else if (i + 1 >= len || read[i + 1] != c) {
      stream[at] = (uint8_t)c;
      pos[at++] = i;
    }
  }
  block_scan(n_in, red, &total);     // its barriers publish the stream
  const int any_n = total > 0;

  // 2. keys and validity
  int n_seed = 0;
  for (int s = tid; s < L; s += nt) {
    uint32_t kk = 0;
    int nn = 0;
    if (s < slen) {
      for (int o = 0; o < k && o <= s; ++o) {
        const int c = stream[s - o];
        if (c >= 4)
          ++nn;
        else
          kk |= (uint32_t)c << (2 * o);
      }
    }
    const int v = s >= k - 1 && s < slen && nn == 0;
    key[s] = kk;
    valid[s] = (uint8_t)v;
    n_seed += v;
  }
  block_scan(n_seed, red, &total);   // its barriers publish key and valid
  const int seeds = total;

  // 3. minimizer selection and its fallback rules
  int fallback = 0;
  if (w > 1) {
    fallback = any_n || seeds < w;
    int wide_span = 0;
    for (int s = tid; s < L; s += nt) {
      uint32_t m = 0xffffffffu;
      for (int o = 0; o < w && o <= s; ++o)
        if (valid[s - o]) m = min(m, key[s - o]);
      wmin[s] = (s >= k + w - 2 && s < slen) ? m : 0u;
      if (a.hpc && s >= 2 * k - 1 && s < slen)
        wide_span |= pos[s] - pos[s - k] >= 255;
    }
    block_scan(wide_span, red, &total);
    if (a.hpc) {
      const int p2 = 2 * k - 2;
      const int first_span =
          (p2 < slen ? pos[p2] : (p2 < L ? HPC_INF : 0)) + 1;
      const int last_pos = slen > 0 ? pos[slen - 1] : -1;
      fallback |= seeds >= k ? (first_span >= 255 || total > 0)
                             : (seeds >= 1 && last_pos + 1 >= 255);
    }
    for (int s = tid; s < slen; s += nt) {
      uint32_t cover = 0;
      for (int o = 0; o < w && s + o < L; ++o) cover = max(cover, wmin[s + o]);
      if (valid[s] && cover != key[s]) valid[s] = 0;
    }
    __syncthreads();
  }

  // 4. seed words, sorted
  const int nr = pow2_at_least(max(slen, 1));
  for (int s = tid; s < nr; s += nt)
    words[s] = (s < slen && valid[s])
                   ? Wd::make(key[s], a.hpc ? pos[s] : s, pb)
                   : Wd::maxw();
  __syncthreads();
  for (int size = 2; size <= nr; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < nr / 2; t += nt) {
        const int i = 2 * t - (t & (stride - 1)), j = i + stride;
        const word_t x = words[i], y = words[j];
        if ((x > y) == ((i & size) == 0)) {
          words[i] = y;
          words[j] = x;
        }
      }
      __syncthreads();
    }

  // 5. per query lane: the last word <= (key, position - min_p); a hit's
  // period replaces the lane's key (-1: no hit), in the thread's own run
  int n_hit = 0;
  for (int s = c0; s < c1 && s < slen; ++s) {
    const int p = a.hpc ? pos[s] : s;
    int period = -1;
    if (valid[s] && p >= a.min_p) {
      const word_t tgt = Wd::make(key[s], p - a.min_p, pb);
      int cnt = 0;
      for (int step = nr; step > 0; step >>= 1)
        if (cnt + step <= nr && words[cnt + step - 1] <= tgt) cnt += step;
      if (cnt > 0) {
        const word_t rec = words[cnt - 1];
        const int d = p - Wd::pos(rec, pb);
        if (Wd::key(rec, pb) == key[s] && d <= a.max_p) period = d;
      }
    }
    key[s] = (uint32_t)period;
    n_hit += period >= 0;
  }

  // 6. compaction in lane order, sentinels past the hits
  at = block_scan(n_hit, red, &total);
  int* ends = a.ends + (size_t)b * L;
  int* pers = a.periods ? a.periods + (size_t)b * L : nullptr;
  for (int s = c0; s < c1 && s < slen; ++s) {
    const int period = (int)key[s];
    if (period < 0) continue;
    const int p = a.hpc ? pos[s] : s;
    if (a.packed) {
      ends[at] = (int)(((uint32_t)p << pb) | (uint32_t)period);
    } else {
      ends[at] = p;
      pers[at] = period;
    }
    ++at;
  }
  for (int i = total + tid; i < L; i += nt) {
    ends[i] = a.packed ? -1 : INT32_MAX_;
    if (!a.packed) pers[i] = INT32_MAX_;
  }
  if (tid == 0) {
    a.n_hits[b] = total;
    a.fb[b] = (uint8_t)fallback;
  }
}

template <bool WIDE>
int launch_seed(const SeedArgs& a, int B, int threads, cudaStream_t stream) {
  const size_t smem = a.scratch ? SCAN_BYTES : SCAN_BYTES + a.row_bytes;
  if (smem > (size_t)SMEM_CAP) return (int)cudaErrorInvalidValue;
  auto kern = seed_hits_kernel<WIDE>;
  const int rc = (int)cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc) return rc;
  kern<<<B, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of one read's arrays (shared memory or a scratch row).
extern "C" long long seed_hits_row_bytes(int L, int hpc, int w, int wide) {
  return (long long)seed_layout(L, hpc, w, wide).total;
}

// Bytes of global scratch a launch needs: 0 when a read's arrays fit in
// shared memory, else B rows of seed_hits_row_bytes.
extern "C" long long seed_hits_scratch_bytes(int B, int L, int hpc, int w,
                                             int wide) {
  const long long row = seed_hits_row_bytes(L, hpc, w, wide);
  return row + SCAN_BYTES <= SMEM_CAP ? 0 : row * B;
}

// codes [B, L] uint8 (0..3, 4 = N, 4 past a read), lens [B] int32; k 1..16;
// wide: 64-bit seed words (required unless 2k + pb <= 31); pb: bits of a
// position (max(1, bit length of L - 1)); packed: ends receives (end << pb
// | period) words with 0xFFFFFFFF sentinels and periods is unused
// (requires 2 pb <= 31 and !wide); threads: a multiple of 32 up to 1024;
// scratch: null runs in shared memory, else B rows of
// seed_hits_row_bytes(L, hpc, w, wide) bytes.  Outputs: ends, periods
// [B, L] int32 (INT32_MAX past n_hits), n_hits [B] int32, fallback [B]
// uint8.
extern "C" int seed_hits(const void* codes, const void* lens, int B, int L,
                         int k, int w, int hpc, int min_p, int max_p,
                         int wide, int pb, int packed, int threads,
                         void* scratch, void* ends, void* periods,
                         void* n_hits, void* fallback, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (k < 1 || k > 16 || w < 1 || threads < 32 || threads > 1024 ||
      threads % 32 || (packed && (wide || 2 * pb > 31)) ||
      (!wide && 2 * k + pb > 31) || (!packed && !periods))
    return (int)cudaErrorInvalidValue;
  SeedArgs a{(const uint8_t*)codes, (const int*)lens, L, k, w, hpc, min_p,
             max_p, pb, packed, (uint8_t*)scratch,
             (size_t)seed_hits_row_bytes(L, hpc, w, wide), (int*)ends,
             (int*)periods, (int*)n_hits, (uint8_t*)fallback};
  cudaStream_t s = (cudaStream_t)stream;
  return wide ? launch_seed<true>(a, B, threads, s)
              : launch_seed<false>(a, B, threads, s);
}
