// Tandem self-hit seeding for Hopper (sm_90a).
//
// Replaces tidehunter_tpu/ops/seeding_jax.py: collect_hits_batch (the
// 3-key merge of 2L records) and collect_hits_packed (one packed-key sort
// and a binary search), with their shared front half _keys_valid_positions
// and _hpc_compact.  On the TPU both are XLA sort dataflows over the whole
// padded batch.  Here a read runs on one CTA with its arrays in shared
// memory, or, past one CTA's shared memory, on a thread-block cluster of up
// to 8 CTAs whose shared memories hold it together:
//
//   1. the stream: the read's codes staged with 16-byte coalesced loads
//      (0..3, 4 = N), or with hpc the last base of each homopolymer run
//      and its read position, compacted in read order (each warp owns a
//      contiguous share of the positions, a ballot ranks a chunk of 32, a
//      scan over the cluster places the warps);
//   2. each stream lane's rolling key (the k bases before it, the newest
//      in the low bits) and its validity (k bases in the stream, no N),
//      each thread rolling over a contiguous run of lanes;
//   3. with w > 1: the minimizer passes (the least key of every window of
//      w lanes, then a lane stays a seed iff some window covering it has
//      its key as the least) and the JAX package's fallback rules: any N,
//      fewer than w seeds, and with hpc a k-mer spanning >= 255 read bases
//      (its first span the conservative position[2k - 2] + 1);
//   4. a stable LSD radix sort of the valid lanes by key alone, 8 bits a
//      pass (2 passes at k = 8, 4 at k = 16).  Lanes come in position
//      order, so a stable sort by key is the (key, position) order the
//      search needs: no sentinels, no padding to a power of two.  The
//      elements are 32-bit words (key << pb | lane) where 2k + pb <= 31,
//      else 64-bit (key << 32 | lane).  A pass: each of up to RADIX_WARPS
//      warps counts the digits of its contiguous share of the elements
//      (shared-memory atomics on its own 256 counters); one scan (across
//      the cluster's CTAs on a cluster) turns the 256 x warps counts into
//      offsets; the warp walks its share again in chunks of 32 and
//      scatters each element to its digit's offset plus its rank among
//      the chunk's elements of that digit (8 ballots, one a digit bit: a
//      single __match_any_sync measured slower on the H100).  The last
//      pass writes the words (key, read position) and each lane's rank r;
//   5. the search from the lane's own rank: the nearest earlier
//      occurrence at least min_p back is the last word <= (key, p - min_p).
//      Positions are distinct and ascend within a key, so the word r - j
//      of the same key lies at p - j or before: the answer lies in
//      [r - min_p, r].  With min_p = 0 it is the lane's own word (period
//      0); in a tandem repeat it is nearly always the word r - 1 (the
//      copy before lies a period back), checked first; else a binary
//      search of [r - min_p, r - 1);
//   6. the hits (period <= max_p) compacted in lane order (ballots, a
//      scan over the warps).  A read has at most one query per position,
//      so lane order is (end, period) order: no second sort.
//
// Routes: a read's arrays (seed_layout) in one CTA's shared memory; past
// that, a cluster of the fewest CTAs (2..8) whose shared memories hold
// ceil(L / C) lanes each, every array spread over them (lane i in CTA
// i / P, read and written through distributed shared memory, the block
// barriers and scans the cluster's, and a last cluster barrier so that no
// CTA exits while another may still read its shared memory); past the
// cluster too, one CTA a read over a global scratch of
// seed_hits_row_bytes.  With sm_90's 232448 bytes
// a block and a 9424-byte head, one CTA holds L <= 15920 bases (32-bit
// words, no hpc, w = 1: 14 bytes a lane), 12384 with hpc, 10128 with hpc
// and w > 1 or with 64-bit words (22 bytes), 7424 with 64-bit words, hpc
// and w > 1 (30 bytes); a cluster of 8 holds 8x that: 127360, 99072,
// 81024 and 59392 bases.  Past those a read takes the global scratch.
//
// Work (the op counts chip_smoke.py uses for the bound, which charges
// the seeding function's own work, the same yardstick for every version
// of this kernel): a stream lane costs ~6 int32 ops per key base (k of
// them) and ~30 more (validity, word, search set-up, compaction); a
// binary-search step ~6 (9 with 64-bit words), ceil(log2 s) + 1 steps a
// query for a row of stream length s; with w > 1, ~8 a lane and window
// offset in each of the two passes; and the sort of the row's s live
// words, s * ceil(log2 s) compares of ~10 (16) ops.  What bounds this
// kernel is issue and its barriers: ~2k/8 radix passes of a few barriers
// each (a bitonic network over the next power of two Nr needs
// log2(Nr)(log2(Nr) + 1)/2, 91 at the slice's reads) and the
// shared-memory steps of the warps' walks (at the slice's reads the
// two scatter walks take ~40% of a CTA's cycles, the search ~17%, keys
// ~13%: clock64 stamps on an H100).  Bytes are no limit (a read is ~9
// bytes a base in and out).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_CLUSTER = 8;       // portable cluster size
constexpr int RADIX = 256;           // 8-bit digits
constexpr int RADIX_WARPS = 8;       // warps that count and scatter a pass
constexpr int INT32_MAX_ = 0x7fffffff;
constexpr int HPC_INF = 1 << 30;
constexpr int SOLO = 0, CLUSTER = 1, GLOBAL = 2;   // routes

// head of every CTA's shared memory
struct Head {
  int red[32];                       // block-scan partials
  int xsum[2];                       // this CTA's sum (a slot a scan)
  uint8_t* parts[MAX_CLUSTER];       // each CTA's shared memory
  int tot[RADIX];                    // this CTA's count of each digit
  int cnt[RADIX_WARPS * RADIX];      // a warp's digit counts, then offsets
};
constexpr int HEAD_BYTES = (int)((sizeof(Head) + 15) & ~(size_t)15);

// byte offsets of a part's arrays (P lanes) in shared memory or scratch
struct Layout {
  size_t bufa, bufb, key, pos, wmin, stream, valid, total;
};

__host__ __device__ inline Layout seed_layout(int P, int hpc, int w,
                                              int wide) {
  const size_t n = ((size_t)(P > 0 ? P : 1) + 15) & ~(size_t)15;
  const size_t wb = wide ? 8 : 4;
  Layout o;
  size_t at = 0;
  o.bufa = at;
  at += n * wb;
  o.bufb = at;
  at += n * wb;
  o.key = at;
  at += n * 4;
  o.pos = at;
  if (hpc) at += n * 4;
  o.wmin = at;
  if (w > 1) at += n * 4;
  o.stream = at;
  at += n;
  o.valid = at;
  at += n;
  o.total = at;                      // a multiple of 16
  return o;
}

// the route of a launch: C CTAs a read of P lanes each (C = 1, P = L: one
// CTA), or the global scratch
struct Route {
  int mode, C, P;
};

__host__ inline Route seed_route(int L, int hpc, int w, int wide, int cap) {
  if (HEAD_BYTES + seed_layout(L, hpc, w, wide).total <= (size_t)cap)
    return {SOLO, 1, L};
  for (int C = 2; C <= MAX_CLUSTER; ++C) {
    const int P = ((L + C - 1) / C + 15) & ~15;
    if (HEAD_BYTES + seed_layout(P, hpc, w, wide).total <= (size_t)cap)
      return {CLUSTER, C, P};
  }
  return {GLOBAL, 1, L};
}

__host__ inline int smem_cap(int* cap) {
  int dev = 0;
  const int rc = (int)cudaGetDevice(&dev);
  return rc ? rc
            : (int)cudaDeviceGetAttribute(
                  cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
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
};
template <>
struct Word<true> {
  typedef u64 T;
  static __device__ T make(uint32_t key, int pos, int) {
    return ((u64)key << 32) | (uint32_t)pos;
  }
  static __device__ uint32_t key(T w, int) { return (uint32_t)(w >> 32); }
  static __device__ int pos(T w, int) { return (int)(uint32_t)w; }
};

struct SeedArgs {
  const uint8_t* codes;
  const int* lens;
  int B, L, k, w, hpc, min_p, max_p, pb, packed;
  uint8_t* scratch;
  size_t row_bytes;
  int* ends;       // [B, L]: ends, or packed (end << pb | period) words
  int* periods;    // [B, L] (unused when packed)
  int* n_hits;     // [B]
  uint8_t* fb;     // [B] 0/1
};

// A read's arrays: lane i of an array lives in part i / P (one part but
// on a cluster), at byte offset `off` of that part's row.
template <int MODE>
struct Row {
  uint8_t* base;                     // this CTA's row
  uint8_t* const* parts;             // every CTA's shared memory (cluster)
  int P, lo;                         // lanes a part, this part's first
  template <class T>
  __device__ T* at(size_t off, int i) const {
    if (MODE != CLUSTER) return (T*)(base + off) + i;
    const unsigned j = (unsigned)(i - lo);
    if (j < (unsigned)P) return (T*)(base + off) + j;
    const int c = i / P;
    return (T*)(parts[c] + HEAD_BYTES + off) + (i - c * P);
  }
};

template <int MODE>
__device__ __forceinline__ void sync_all() {
  if (MODE == CLUSTER)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
}

// exclusive prefix sum of v over the block in thread order; *total gets
// the block's sum.  Every thread of the block must call it.
__device__ int block_scan(int v, int* red, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? red[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, s, d);
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

// block_scan over every thread of the read (all CTAs of a cluster, in
// rank order); its barriers publish what was written before it.  On a
// cluster the CTAs' sums go through xsum[slot], the slot alternating from
// one call to the next (*slot, the same in every thread): a CTA rewrites
// a slot only after the next call's barrier, which every CTA reaches after
// reading it, so one cluster barrier a call suffices.
template <int MODE>
__device__ int scan_all(int v, Head* h, int C, int rank, int* total,
                        int* slot) {
  int local;
  const int ex = block_scan(v, h->red, &local);
  if (MODE != CLUSTER) {
    *total = local;
    return ex;
  }
  const int x = *slot;
  *slot ^= 1;
  if (threadIdx.x == 0) h->xsum[x] = local;
  cooperative_groups::this_cluster().sync();
  int before = 0, all = 0;
  for (int c = 0; c < C; ++c) {
    const int t = ((const Head*)h->parts[c])->xsum[x];
    before += c < rank ? t : 0;
    all += t;
  }
  *total = all;
  return before + ex;
}

// warp `warp` of nwk's contiguous share of [lo, hi), whole chunks of 32
__device__ __forceinline__ void warp_share(int lo, int hi, int warp, int nwk,
                                           int* s0, int* s1) {
  const int n = max(hi - lo, 0);
  const int per = ((n + nwk - 1) / nwk + 31) & ~31;
  *s0 = lo + min(warp * per, n);
  *s1 = lo + min(warp * per + per, n);
}

template <bool WIDE, int MODE>
__global__ void __launch_bounds__(1024)
    seed_hits_kernel(SeedArgs a, int C, int P) {
  typedef Word<WIDE> Wd;
  typedef typename Wd::T word_t;
  extern __shared__ uint2 seed_s[];
  Head* h = (Head*)seed_s;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const unsigned lt = (1u << lane) - 1;
  const int b = blockIdx.x / C, rank = blockIdx.x % C;
  const int L = a.L, k = a.k, w = a.w, pb = a.pb, hpc = a.hpc;
  const Layout lay = seed_layout(P, hpc, w, WIDE);
  uint8_t* base = MODE == GLOBAL ? a.scratch + (size_t)b * a.row_bytes
                                 : (uint8_t*)seed_s + HEAD_BYTES;
  if (MODE == CLUSTER) {
    if (tid < C)
      h->parts[tid] = (uint8_t*)cooperative_groups::this_cluster()
                          .map_shared_rank((void*)h, tid);
    cooperative_groups::this_cluster().sync();   // all running, parts set
  }
  const int lo = rank * P, hi = min(lo + P, L);    // this part's lanes
  const Row<MODE> row{base, h->parts, P, lo};
  uint8_t* stream_l = base + lay.stream;           // this part's arrays
  uint8_t* valid_l = base + lay.valid;
  uint32_t* key_l = (uint32_t*)(base + lay.key);
  int* pos_l = (int*)(base + lay.pos);
  uint32_t* wmin_l = (uint32_t*)(base + lay.wmin);
  const uint8_t* read = a.codes + (size_t)b * L;
  const int len = min(max(a.lens[b], 0), L);
  const int e = min(hi, len);                      // this part's bases
  int total, slen = len, slot = 0;

  // 1. stage this part's bases with 16-byte loads (inside the codes
  // tensor; bytes past its ends singly): into the stream, or with hpc
  // into the unused bufb
  {
    uint8_t* dst = hpc ? base + lay.bufb : stream_l;
    const uint8_t* end_all = a.codes + (size_t)a.B * L;
    const uintptr_t g0 = (uintptr_t)(read + lo) & ~(uintptr_t)15;
    int n_in = 0;
    for (uintptr_t g = g0 + 16 * (uintptr_t)tid; g < (uintptr_t)(read + e);
         g += 16 * (uintptr_t)nt) {
      const uint8_t* gp = (const uint8_t*)g;
      uint32_t v[4];
      if (gp >= a.codes && gp + 16 <= end_all) {
        const uint4 q = *(const uint4*)gp;
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = 0;
          for (int y = 0; y < 4; ++y) {
            const uint8_t* q = gp + 4 * j + y;
            v[j] |= (uint32_t)(q >= a.codes && q < end_all ? *q : 4)
                    << (8 * y);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = (int)(gp + j - read);
        const int c = (v[j >> 2] >> (8 * (j & 3))) & 255;
        if (i >= lo && i < e) {
          dst[i - lo] = (uint8_t)c;
          n_in += c >= 4;
        }
      }
    }
    __syncthreads();
    if (hpc) {
      // keep the last base of each run, in read order, placed by a scan
      // of the warps' counts over the read
      const int nxt = e < len ? read[e] : 255;    // the next part's first
      int s0, s1;
      warp_share(lo, e, warp, nw, &s0, &s1);
      int kept = 0;
      for (int c = s0; c < s1; c += 32) {
        const int i = c + lane;
        const bool kp = i < s1 && (i + 1 >= len ||
                                   (i + 1 < e ? dst[i + 1 - lo] : nxt) !=
                                       dst[i - lo]);
        kept += __popc(__ballot_sync(FULL, kp));
      }
      int at = __shfl_sync(FULL, scan_all<MODE>(lane ? 0 : kept, h, C, rank,
                                                &total, &slot), 0);
      slen = total;
      for (int c = s0; c < s1; c += 32) {
        const int i = c + lane;
        const int code = i < s1 ? dst[i - lo] : 4;
        const bool kp = i < s1 && (i + 1 >= len ||
                                   (i + 1 < e ? dst[i + 1 - lo] : nxt) !=
                                       code);
        const unsigned m = __ballot_sync(FULL, kp);
        if (kp) {
          const int s = at + __popc(m & lt);
          *row.template at<uint8_t>(lay.stream, s) = (uint8_t)code;
          *row.template at<int>(lay.pos, s) = i;
        }
        at += __popc(m);
      }
    }
    scan_all<MODE>(n_in, h, C, rank, &total, &slot);   // publishes the stream
  }
  const int any_n = total > 0;
  const int sh = min(hi, slen);                  // this part's stream lanes

  // 2. keys and validity of this part's lanes, each thread rolling over
  // its contiguous run (one byte in and one out a lane); with w > 1 also
  // each lane's key where valid, else ~0, into the free bufa
  int n_seed = 0;
  {
    uint32_t* okey_l = (uint32_t*)(base + lay.bufa);
    const uint32_t mask = k == 16 ? 0xffffffffu : (1u << (2 * k)) - 1;
    const int ch = (hi - lo + nt - 1) / nt;
    const int r0 = lo + tid * ch, r1 = min(r0 + ch, hi);
    uint32_t kk = 0;
    int nn = 0;                        // Ns among the k bases up to s
    for (int o = k; o >= 1; --o) {      // the k bases before r0
      const int j = r0 - o;
      if (j < 0 || j >= slen) continue;
      const int c = j >= lo ? stream_l[j - lo]
                            : *row.template at<uint8_t>(lay.stream, j);
      kk = ((kk << 2) | (uint32_t)(c < 4 ? c : 0)) & mask;
      nn += c >= 4;
    }
    for (int s = r0; s < r1; ++s) {
      int v = 0;
      if (s < slen) {
        const int c = stream_l[s - lo];
        kk = ((kk << 2) | (uint32_t)(c < 4 ? c : 0)) & mask;
        nn += c >= 4;
        if (s >= k) {
          const int j = s - k;
          nn -= (j >= lo ? stream_l[j - lo]
                         : *row.template at<uint8_t>(lay.stream, j)) >= 4;
        }
        v = s >= k - 1 && nn == 0;
      }
      key_l[s - lo] = s < slen ? kk : 0u;
      valid_l[s - lo] = (uint8_t)v;
      if (w > 1) okey_l[s - lo] = v ? kk : 0xffffffffu;
      n_seed += v;
    }
  }
  scan_all<MODE>(n_seed, h, C, rank, &total, &slot);   // publishes key and valid
  const int seeds = total;

  // 3. minimizer selection and its fallback rules
  int fallback = 0;
  if (w > 1) {
    fallback = any_n || seeds < w;
    int wide_span = 0;
    for (int s = lo + tid; s < hi; s += nt) {
      uint32_t m = 0xffffffffu;
      for (int o = 0; o < w && o <= s; ++o)
        m = min(m, *row.template at<uint32_t>(lay.bufa, s - o));
      wmin_l[s - lo] = (s >= k + w - 2 && s < slen) ? m : 0u;
      if (hpc && s >= 2 * k - 1 && s < slen)
        wide_span |= pos_l[s - lo] - *row.template at<int>(lay.pos, s - k) >=
                     255;
    }
    scan_all<MODE>(wide_span, h, C, rank, &total, &slot);   // publishes wmin
    if (hpc) {
      const int p2 = 2 * k - 2;
      const int first_span =
          (p2 < slen ? *row.template at<int>(lay.pos, p2)
                     : (p2 < L ? HPC_INF : 0)) + 1;
      const int last_pos =
          slen > 0 ? *row.template at<int>(lay.pos, slen - 1) : -1;
      fallback |= seeds >= k ? (first_span >= 255 || total > 0)
                             : (seeds >= 1 && last_pos + 1 >= 255);
    }
    for (int s = lo + tid; s < sh; s += nt) {
      uint32_t cover = 0;
      for (int o = 0; o < w && s + o < L; ++o)
        cover = max(cover, *row.template at<uint32_t>(lay.wmin, s + o));
      if (valid_l[s - lo] && cover != key_l[s - lo]) valid_l[s - lo] = 0;
    }
    sync_all<MODE>();
  }

  // 4. stable LSD radix sort of the valid lanes by key, 8 bits a pass
  const int npass = (2 * k + 7) / 8;
  const int nwk = min(nw, RADIX_WARPS);
  int* cnt = h->cnt + warp * RADIX;
  int n = 0;                                      // valid lanes of the read
  for (int pass = 0; pass < npass; ++pass) {
    const int shift = 8 * pass;
    const bool last = pass == npass - 1;
    const size_t in_off = (pass & 1) ? lay.bufa : lay.bufb;
    const size_t out_off = (pass & 1) ? lay.bufb : lay.bufa;
    const word_t* in_l = (const word_t*)(base + in_off);
    // this CTA's elements: the valid stream lanes (pass 0), else its part
    // of the previous pass's output
    const int in_hi = pass ? min(hi, n) : sh;
    int s0, s1;
    warp_share(lo, in_hi, warp, nwk, &s0, &s1);
    for (int i = tid; i < nwk * RADIX; i += nt) h->cnt[i] = 0;
    __syncthreads();
    if (warp < nwk)
      for (int i = s0 + lane; i < s1; i += 32) {
        const bool has = pass || valid_l[i - lo];
        if (has) {
          const uint32_t kk = pass ? Wd::key(in_l[i - lo], pb) : key_l[i - lo];
          atomicAdd(&cnt[(kk >> shift) & (RADIX - 1)], 1);
        }
      }
    __syncthreads();
    // per digit: the warps' exclusive prefixes and this CTA's total
    for (int d = tid; d < RADIX; d += nt) {
      int run = 0;
      for (int v = 0; v < nwk; ++v) {
        const int x = h->cnt[v * RADIX + d];
        h->cnt[v * RADIX + d] = run;
        run += x;
      }
      h->tot[d] = run;
    }
    sync_all<MODE>();
    // the CTAs before this one (cluster), then the digits before each:
    // a thread's contiguous digits [d0, d0 + per)
    const int per = (RADIX + nt - 1) / nt, d0 = tid * per;
    int dall[RADIX / 32], dpre[RADIX / 32], sum = 0;
    for (int j = 0; j < per; ++j) {
      const int d = d0 + j;
      int all = 0, pre = 0;
      if (d < RADIX) {
        if (MODE == CLUSTER) {
          for (int c = 0; c < C; ++c) {
            const int t = ((const Head*)h->parts[c])->tot[d];
            pre += c < rank ? t : 0;
            all += t;
          }
        } else {
          all = h->tot[d];
        }
      }
      dall[j] = all;
      dpre[j] = pre;
      sum += all;
    }
    int off = block_scan(sum, h->red, &n);
    for (int j = 0; j < per; ++j) {
      const int d = d0 + j;
      if (d < RADIX)
        for (int v = 0; v < nwk; ++v) h->cnt[v * RADIX + d] += off + dpre[j];
      off += dall[j];
    }
    __syncthreads();
    // scatter in the counting walk's order, each element after its
    // chunk's peers of lower lanes
    if (warp < nwk)
      for (int c = s0; c < s1; c += 32) {
        const int i = c + lane;
        bool has = false;
        word_t wd = 0;
        if (i < s1) {
          if (pass) {
            has = true;
            wd = in_l[i - lo];
          } else if (valid_l[i - lo]) {
            has = true;
            wd = Wd::make(key_l[i - lo], i, pb);
          }
        }
        const uint32_t kk = Wd::key(wd, pb);
        const int d = (int)((kk >> shift) & (RADIX - 1));
        // the chunk's elements of this digit: a ballot a digit bit
        unsigned peers = __ballot_sync(FULL, has);
#pragma unroll
        for (int bit = 0; bit < 8; ++bit) {
          const unsigned m = __ballot_sync(FULL, (d >> bit) & 1);
          peers &= (d >> bit) & 1 ? m : ~m;
        }
        const int o = has ? cnt[d] : 0;
        __syncwarp();
        if (has) {
          const int r = o + __popc(peers & lt);
          if (!last) {
            *row.template at<word_t>(out_off, r) = wd;
          } else {
            const int s = Wd::pos(wd, pb);
            const int p = hpc ? *row.template at<int>(lay.pos, s) : s;
            *row.template at<word_t>(out_off, r) = Wd::make(kk, p, pb);
            *row.template at<uint32_t>(lay.key, s) = (uint32_t)r;
          }
          if (!(peers & lt)) cnt[d] = o + __popc(peers);
        }
        __syncwarp();
      }
    sync_all<MODE>();   // the pass's output and ranks, every CTA's
  }
  const size_t sorted = ((npass - 1) & 1) ? lay.bufb : lay.bufa;

  // 5. per query lane, in the warps' shares of the lanes: the last word
  // <= (key, position - min_p) in [r - min_p, r]; a hit's period replaces
  // the lane's rank (-1: no hit)
  int s0, s1;
  warp_share(lo, sh, warp, nw, &s0, &s1);
  int n_hit = 0;
  for (int c = s0; c < s1; c += 32) {
    const int s = c + lane;
    int period = -1;
    if (s < s1 && valid_l[s - lo]) {
      const int p = hpc ? pos_l[s - lo] : s;
      if (p >= a.min_p) {
        const int r = (int)key_l[s - lo];
        const word_t own = *row.template at<word_t>(sorted, r);
        const word_t prev = r ? *row.template at<word_t>(sorted, r - 1) : 0;
        const uint32_t kk = Wd::key(own, pb);
        const word_t tgt = Wd::make(kk, p - a.min_p, pb);
        const int j0 = r - min(r, a.min_p);
        // first word > tgt in [j0, r + 1): the word r itself when min_p
        // = 0, the word before it in a tandem repeat (its last copy lies
        // at least min_p back), else a binary search
        int x = j0, y = r + 1;
        if (a.min_p == 0)
          x = r + 1;
        else if (r && prev <= tgt)
          x = y = r;
        else
          y = r - (r > j0);
        while (x < y) {
          const int mid = (x + y) >> 1;
          if (*row.template at<word_t>(sorted, mid) <= tgt)
            x = mid + 1;
          else
            y = mid;
        }
        if (x > j0) {
          const word_t rec = *row.template at<word_t>(sorted, x - 1);
          const int d = p - Wd::pos(rec, pb);
          if (Wd::key(rec, pb) == kk && d <= a.max_p) period = d;
        }
      }
    }
    if (s < s1) key_l[s - lo] = (uint32_t)period;
    n_hit += __popc(__ballot_sync(FULL, period >= 0));
  }

  // 6. compaction in lane order, sentinels past the hits
  int at = __shfl_sync(FULL, scan_all<MODE>(lane ? 0 : n_hit, h, C, rank,
                                            &total, &slot), 0);
  int* ends = a.ends + (size_t)b * L;
  int* pers = a.periods ? a.periods + (size_t)b * L : nullptr;
  for (int c = s0; c < s1; c += 32) {
    const int s = c + lane;
    const int period = s < s1 ? (int)key_l[s - lo] : -1;
    const unsigned m = __ballot_sync(FULL, period >= 0);
    if (period >= 0) {
      const int p = hpc ? pos_l[s - lo] : s;
      const int o = at + __popc(m & lt);
      if (a.packed) {
        ends[o] = (int)(((uint32_t)p << pb) | (uint32_t)period);
      } else {
        ends[o] = p;
        pers[o] = period;
      }
    }
    at += __popc(m);
  }
  for (int i = max(lo, total) + tid; i < hi; i += nt) {
    ends[i] = a.packed ? -1 : INT32_MAX_;
    if (!a.packed) pers[i] = INT32_MAX_;
  }
  if (rank == 0 && tid == 0) {
    a.n_hits[b] = total;
    a.fb[b] = (uint8_t)fallback;
  }
  // no CTA of a cluster exits while another may still read its shared
  // memory (the last scan_all's xsum)
  if (MODE == CLUSTER) cooperative_groups::this_cluster().sync();
}

template <bool WIDE>
int launch_seed(const SeedArgs& a, const Route& r, int threads,
                cudaStream_t stream) {
  const size_t smem =
      HEAD_BYTES + (r.mode == GLOBAL
                        ? 0
                        : seed_layout(r.P, a.hpc, a.w, WIDE).total);
  void (*kern)(SeedArgs, int, int) =
      r.mode == SOLO      ? seed_hits_kernel<WIDE, SOLO>
      : r.mode == CLUSTER ? seed_hits_kernel<WIDE, CLUSTER>
                          : seed_hits_kernel<WIDE, GLOBAL>;
  int rc = (int)cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * r.C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = r.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = r.C > 1 ? 1 : 0;
  rc = (int)cudaLaunchKernelEx(&cfg, kern, a, r.C, r.P);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of one read's arrays in a global-scratch row.
extern "C" long long seed_hits_row_bytes(int L, int hpc, int w, int wide) {
  return (long long)seed_layout(L, hpc, w, wide).total;
}

// Bytes of global scratch a launch needs: 0 when a read's arrays fit in
// one CTA's shared memory or a cluster's, else B rows of
// seed_hits_row_bytes; -1 if the device cannot be queried.
extern "C" long long seed_hits_scratch_bytes(int B, int L, int hpc, int w,
                                             int wide) {
  int cap = 0;
  if (smem_cap(&cap)) return -1;
  return seed_route(L, hpc, w, wide, cap).mode == GLOBAL
             ? seed_hits_row_bytes(L, hpc, w, wide) * B
             : 0;
}

// The route of a launch at read width L: 1 = one CTA a read, 2..8 = a
// thread-block cluster of that many CTAs, 0 = the global scratch; -1 if
// the device cannot be queried.
extern "C" int seed_hits_route(int L, int hpc, int w, int wide) {
  int cap = 0;
  if (smem_cap(&cap)) return -1;
  const Route r = seed_route(L, hpc, w, wide, cap);
  return r.mode == GLOBAL ? 0 : r.C;
}

// codes [B, L] uint8 (0..3, 4 = N, 4 past a read), lens [B] int32; k 1..16;
// wide: 64-bit seed words (required unless 2k + pb <= 31); pb: bits of a
// position (max(1, bit length of L - 1)); packed: ends receives (end << pb
// | period) words with 0xFFFFFFFF sentinels and periods is unused
// (requires 2 pb <= 31 and !wide); threads: a multiple of 32 up to 1024
// (a CTA's; a cluster's CTAs each have as many); scratch: B rows of
// seed_hits_row_bytes(L, hpc, w, wide) bytes where seed_hits_scratch_bytes
// says so, else unused.  Outputs: ends, periods [B, L] int32 (INT32_MAX
// past n_hits), n_hits [B] int32, fallback [B] uint8.
extern "C" int seed_hits(const void* codes, const void* lens, int B, int L,
                         int k, int w, int hpc, int min_p, int max_p,
                         int wide, int pb, int packed, int threads,
                         void* scratch, void* ends, void* periods,
                         void* n_hits, void* fallback, void* stream) {
  if (B == 0 || L == 0) return 0;
  if (k < 1 || k > 16 || w < 1 || min_p < 0 || threads < 32 ||
      threads > 1024 || threads % 32 || (packed && (wide || 2 * pb > 31)) ||
      (!wide && 2 * k + pb > 31) || (!packed && !periods))
    return (int)cudaErrorInvalidValue;
  int cap = 0;
  const int rc = smem_cap(&cap);
  if (rc) return rc;
  const Route r = seed_route(L, hpc, w, wide, cap);
  if (r.mode == GLOBAL && !scratch) return (int)cudaErrorInvalidValue;
  SeedArgs a{(const uint8_t*)codes, (const int*)lens, B, L, k, w, hpc,
             min_p, max_p, pb, packed, (uint8_t*)scratch,
             (size_t)seed_hits_row_bytes(L, hpc, w, wide), (int*)ends,
             (int*)periods, (int*)n_hits, (uint8_t*)fallback};
  cudaStream_t s = (cudaStream_t)stream;
  return wide ? launch_seed<true>(a, r, threads, s)
              : launch_seed<false>(a, r, threads, s);
}
