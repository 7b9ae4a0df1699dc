// CPU emulation of the CUDA subset that tidehunter_tpu_torch/csrc uses, so
// that tests/test_torch_csrc_shim.py can run the kernels' own source on a
// host without nvcc or a card.  One std::thread per CUDA thread, block by
// block; __syncthreads is a barrier of the block, __syncwarp and every
// shuffle a barrier of the warp (so a kernel that lets a warp's lanes
// diverge across a shuffle deadlocks here, as the CUDA contract forbids).
// Shared memory is filled with 0xA5 bytes, not zeros, as the card gives
// no initial value.  cp.async copies (cuda_pipeline.h) are synchronous.
// A shuffle moves a value of up to 8 bytes whole (CUDA's 32- and 64-bit
// overloads).  Intrinsics compute their exact integer definitions (the
// packed-lane SIMD and DPX ones and packed_lanes.cuh's PRMT field by
// field, wrapped to the field); a ballot or a reduction is a barrier of
// the warp like a shuffle, an atomic a std::atomic_ref operation.  cudaLaunchKernelEx
// runs the CTAs of a thread-block cluster at once: cooperative_groups'
// this_cluster().sync() is a barrier of all their threads and
// map_shared_rank() points into another CTA's shared memory, which is
// filled with 0x5A bytes when that CTA's last thread exits; between two
// cluster barriers the CTA of rank 0 runs before the others, so that a
// read of its shared memory after it exited, which CUDA forbids, shows
// every time.  Hopper's bulk copy (csrc/bulk_copy.cuh: mbar_init,
// mbar_fence_init, mbar_arrive_expect_tx, bulk_g2s, mbar_wait) keeps each
// mbarrier's state (arrivals and bytes still due, its phase) beside it and
// copies at once; a copy that is not whole 16-byte pieces at 16-byte
// aligned addresses, a wait on a barrier never initialised, or a wait that
// a phase would never complete (arrivals or bytes short) aborts, where the
// card would fault or hang.  The SM count
// a program reads is $CUDA_SHIM_SMS (default 132), so that a test can steer
// a launcher's choice of cluster or of lanes a problem, and the opt-in shared memory a block may
// use is $CUDA_SHIM_SMEM (default 232448, sm_90's), so that a test can
// steer a launcher's choice of route by shared-memory capacity.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <cstdio>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

using std::max;
using std::min;

struct dim3s { unsigned x = 0, y = 0, z = 0; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3s threadIdx, blockIdx, blockDim;

struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline int2 make_int2(int a, int b) { return {a, b}; }
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum {
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 97
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline int cudaGetDevice(int* dev) {
  *dev = 0;
  return 0;
}
inline int cudaDeviceGetAttribute(int* v, int attr, int) {
  const bool smem = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin;
  const char* env = std::getenv(smem ? "CUDA_SHIM_SMEM" : "CUDA_SHIM_SMS");
  *v = env ? std::atoi(env) : (smem ? 232448 : 132);
  return 0;
}
// as the card: a dynamic shared-memory size past the opt-in limit fails
template <class F> inline int cudaFuncSetAttribute(F, int attr, int v) {
  int most = 0;
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, 0);
  return attr == cudaFuncAttributeMaxDynamicSharedMemorySize && v > most;
}
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "cuda_shim"; }

struct WarpCtx {
  std::barrier<> bar{32};
  int vals[32];
  unsigned long long vals64[32];
};
struct BlockCtx {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<WarpCtx>> warps;
  std::vector<char> smem;
  std::atomic<int> live{0};          // threads still running
  std::atomic<int> arrivals{0};      // its threads' cluster barriers
  std::atomic<bool> done{false};     // exited, shared memory poisoned
  std::atomic<unsigned> events{0};   // wakes the CTAs waiting their turn
};
inline thread_local BlockCtx* tblock;
inline thread_local char* shim_smem;
struct ClusterCtx {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<BlockCtx*> blocks;
  int block, rank0;                  // threads a CTA, the first's blockIdx
};
inline thread_local ClusterCtx* tcluster;
inline thread_local int tsyncs;      // cluster barriers this thread passed

inline void shim_wake(BlockCtx* b) {
  ++b->events;
  b->events.notify_all();
}

// Between two cluster barriers the CTA of rank 0 runs first: the others
// start only once it has reached the next barrier or exited, so that a
// read of its shared memory after it exited (poisoned) fails every time,
// not only when the threads race that way.
inline void shim_cluster_turn() {
  if ((int)blockIdx.x == tcluster->rank0) return;
  BlockCtx* o = tcluster->blocks[0];
  for (;;) {
    const unsigned ev = o->events.load();
    if (o->done || o->arrivals >= tcluster->block * (tsyncs + 1)) return;
    o->events.wait(ev);
  }
}

namespace cooperative_groups {
struct cluster_group {
  void sync() const {
    ++tblock->arrivals;
    shim_wake(tblock);
    tcluster->bar->arrive_and_wait();
    ++tsyncs;
    shim_cluster_turn();
  }
  template <class T> T* map_shared_rank(T* p, int rank) const {
    const std::ptrdiff_t off = (char*)p - tblock->smem.data();
    return (T*)(tcluster->blocks[rank]->smem.data() + off);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups

inline void __syncthreads() { tblock->bar->arrive_and_wait(); }
inline WarpCtx* my_warp() { return tblock->warps[threadIdx.x / 32].get(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  my_warp()->bar.arrive_and_wait();
}

// the value of lane src(lane) of the warp; a lane whose source lies
// outside the warp keeps its own.  Any type of up to 8 bytes, as CUDA's
// overloads (int, unsigned, long long, unsigned long long, ...) take it,
// moved whole: a 64-bit value is one exchange, not two 32-bit halves.
template <class T, class F> inline T shfl_impl(T v, F src_of) {
  static_assert(sizeof(T) <= sizeof(unsigned long long));
  WarpCtx* w = my_warp();
  const int lane = threadIdx.x & 31;
  std::memcpy(&w->vals64[lane], &v, sizeof(T));
  w->bar.arrive_and_wait();
  const int src = src_of(lane);
  T r = v;
  if (src >= 0 && src < 32) std::memcpy(&r, &w->vals64[src], sizeof(T));
  w->bar.arrive_and_wait();
  return r;
}
template <class T> inline T __shfl_up_sync(unsigned, T v, int d) {
  return shfl_impl(v, [d](int l) { return l - d; });
}
template <class T> inline T __shfl_down_sync(unsigned, T v, int d) {
  return shfl_impl(v, [d](int l) { return l + d; });
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) {
  return shfl_impl(v, [m](int l) { return l ^ m; });
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  return shfl_impl(v, [src](int) { return src & 31; });
}

// the mask of the warp's lanes whose pred is nonzero
inline unsigned __ballot_sync(unsigned, int pred) {
  WarpCtx* w = my_warp();
  const int lane = threadIdx.x & 31;
  w->vals[lane] = pred != 0;
  w->bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (unsigned)(w->vals[i] != 0) << i;
  w->bar.arrive_and_wait();
  return m;
}
// redux.sync: the warp's maximum
inline int __reduce_max_sync(unsigned, int v) {
  WarpCtx* w = my_warp();
  w->vals[threadIdx.x & 31] = v;
  w->bar.arrive_and_wait();
  int r = w->vals[0];
  for (int i = 1; i < 32; ++i) r = max(r, w->vals[i]);
  w->bar.arrive_and_wait();
  return r;
}

// shared- or global-memory atomics: the old value
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline unsigned long long __brevll(unsigned long long x) {
  unsigned long long r = 0;
  for (int i = 0; i < 64; ++i) r |= ((x >> i) & 1ull) << (63 - i);
  return r;
}

// cuda_pipeline.h's primitives: the copy is done at once, so commit and
// wait have nothing left to do
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

// Hopper's bulk copy and its transaction-count mbarrier (bulk_copy.cuh)
struct ShimMbar {
  int count, pending;               // arrivals a phase, still due
  long long tx;                     // bytes announced and not yet copied
  unsigned phase;                   // the parity of the current phase
};
inline std::mutex shim_mbar_mu;
inline std::unordered_map<const void*, ShimMbar> shim_mbars;
inline int shim_mbar_inits = 0;     // mbar_init calls, for a test to read

[[noreturn]] inline void shim_abort(const char* what) {
  std::fprintf(stderr, "cuda_shim: %s\n", what);
  std::abort();
}
inline ShimMbar& shim_mbar(const void* bar) {   // under shim_mbar_mu
  auto it = shim_mbars.find(bar);
  if (it == shim_mbars.end()) shim_abort("mbarrier used before mbar_init");
  return it->second;
}
inline void shim_mbar_step(ShimMbar& m) {        // a phase completes
  if (m.pending == 0 && m.tx == 0) {
    m.phase ^= 1u;
    m.pending = m.count;
  }
}
inline void mbar_init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> g(shim_mbar_mu);
  shim_mbars[bar] = ShimMbar{(int)count, (int)count, 0, 0};
  ++shim_mbar_inits;
}
inline void mbar_fence_init() {}
inline void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> g(shim_mbar_mu);
  ShimMbar& m = shim_mbar(bar);
  m.tx += bytes;
  --m.pending;
  shim_mbar_step(m);
}
inline void bulk_g2s(void* dst, const void* src, unsigned bytes,
                     uint64_t* bar) {
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) || bytes % 16 || !bytes)
    shim_abort("bulk copy of a size or at an address not 16-byte whole");
  std::memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> g(shim_mbar_mu);
  ShimMbar& m = shim_mbar(bar);
  m.tx -= bytes;
  shim_mbar_step(m);
}
// the phase of parity `parity` completes when the current phase has the
// other parity; a wait that lasts $CUDA_SHIM_WAIT_S seconds (default 20)
// would hang on the card
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  const char* env = std::getenv("CUDA_SHIM_WAIT_S");
  const auto limit = std::chrono::seconds(env ? std::atoi(env) : 20);
  const auto t0 = std::chrono::steady_clock::now();
  for (;;) {
    {
      std::lock_guard<std::mutex> g(shim_mbar_mu);
      if (shim_mbar(bar).phase != (parity & 1u)) return;
    }
    if (std::chrono::steady_clock::now() - t0 > limit)
      shim_abort("mbar_wait: the phase never completes");
    std::this_thread::yield();
  }
}

template <class T> inline T __ldg(const T* p) { return *p; }
inline int __viaddmax_s32(int a, int b, int c) {
  return max((int)((unsigned)a + (unsigned)b), c);
}
inline int __vimax3_s32(int a, int b, int c) { return max(max(a, b), c); }
// max(min(a + b, c), 0), the add wrapping to 32 bits
inline int __viaddmin_s32_relu(int a, int b, int c) {
  return max(min((int)((unsigned)a + (unsigned)b), c), 0);
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  return (unsigned)((((unsigned long long)hi << 32) | lo) >> (sh & 31));
}
// the high word of hi:lo shifted left by min(sh, 32)
inline unsigned __funnelshift_lc(unsigned lo, unsigned hi, unsigned sh) {
  const unsigned long long v = ((unsigned long long)hi << 32) | lo;
  return sh >= 32 ? lo : (unsigned)((v << sh) >> 32);
}

// Packed-lane intrinsics: 32 / BITS signed fields of a word, each op on
// each field by its plain integer definition, the result wrapped to the
// field (compares give all ones where true)
template <int BITS, class F>
inline unsigned shim_fields(unsigned a, unsigned b, unsigned c, F f) {
  constexpr unsigned m = (1u << BITS) - 1;
  auto field = [](unsigned w, int i) {
    const int v = (int)((w >> (i * BITS)) & m);
    return v >= (1 << (BITS - 1)) ? v - (1 << BITS) : v;
  };
  unsigned r = 0;
  for (int i = 0; i < 32 / BITS; ++i)
    r |= ((unsigned)f(field(a, i), field(b, i), field(c, i)) & m)
         << (i * BITS);
  return r;
}
#define SHIM_PACKED2(name, BITS, expr)                                \
  inline unsigned name(unsigned a, unsigned b) {                      \
    return shim_fields<BITS>(a, b, 0u, [](int x, int y, int) { return (expr); }); \
  }
#define SHIM_PACKED3(name, BITS, expr)                                \
  inline unsigned name(unsigned a, unsigned b, unsigned c) {          \
    return shim_fields<BITS>(a, b, c, [](int x, int y, int z) { return (expr); }); \
  }
SHIM_PACKED2(__vadd2, 16, x + y)
SHIM_PACKED2(__vsub2, 16, x - y)
SHIM_PACKED2(__vmaxs2, 16, max(x, y))
SHIM_PACKED2(__vmins2, 16, min(x, y))
SHIM_PACKED3(__vimax3_s16x2, 16, max(max(x, y), z))
SHIM_PACKED3(__viaddmax_s16x2_relu, 16, max(max((int)(int16_t)(x + y), z), 0))
SHIM_PACKED2(__vminu2, 16, (int)min((unsigned)x & 0xFFFFu, (unsigned)y & 0xFFFFu))
SHIM_PACKED3(__viaddmax_s16x2, 16, max((int)(int16_t)(x + y), z))
SHIM_PACKED2(__vadd4, 8, x + y)
SHIM_PACKED2(__vsub4, 8, x - y)
SHIM_PACKED2(__vmaxs4, 8, max(x, y))
SHIM_PACKED2(__vmins4, 8, min(x, y))
SHIM_PACKED2(__vcmpgts4, 8, x > y ? -1 : 0)
SHIM_PACKED2(__vcmpne4, 8, x != y ? -1 : 0)

// packed_lanes.cuh: 0xFFFF in each 16-bit field whose sign bit is set;
// the thread's index
inline uint32_t field_signs16(uint32_t x) {
  return ((x & 0x8000u) ? 0xFFFFu : 0u) | ((x & 0x80000000u) ? 0xFFFF0000u : 0u);
}
inline int thread_x() { return (int)threadIdx.x; }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = ((unsigned long long)y << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}

// CTAs [b0, b0 + n) at once, as one cluster; run(b) runs CTA b's thread
template <class F> void run_cluster(int b0, int n, int block, size_t smem,
                                    F run) {
  ClusterCtx cc;
  cc.bar = std::make_unique<std::barrier<>>(n * block);
  cc.block = block;
  cc.rank0 = b0;
  std::vector<std::unique_ptr<BlockCtx>> ctxs;
  for (int i = 0; i < n; ++i) {
    auto ctx = std::make_unique<BlockCtx>();
    ctx->bar = std::make_unique<std::barrier<>>(block);
    for (int w = 0; w < (block + 31) / 32; ++w)
      ctx->warps.push_back(std::make_unique<WarpCtx>());
    ctx->smem.assign(smem + 16, (char)0xA5);
    ctx->live = block;
    cc.blocks.push_back(ctx.get());
    ctxs.push_back(std::move(ctx));
  }
  std::vector<std::thread> ths;
  for (int i = 0; i < n; ++i)
    for (int t = 0; t < block; ++t)
      ths.emplace_back([&, i, t] {
        threadIdx.x = t;
        blockIdx.x = b0 + i;
        blockDim.x = block;
        tblock = cc.blocks[i];
        shim_smem = tblock->smem.data();
        tcluster = &cc;
        tsyncs = 0;
        if (n > 1) shim_cluster_turn();
        run();
        // an exited CTA of a cluster: its shared memory is gone, so a
        // late read through map_shared_rank sees 0x5A bytes
        if (n > 1) {
          if (--tblock->live == 0) {
            std::memset(tblock->smem.data(), 0x5A, tblock->smem.size());
            tblock->done = true;
          }
          shim_wake(tblock);
        }
      });
  for (auto& th : ths) th.join();
}

// kern<<<grid, block, smem, stream>>>(args...)
template <class K, class... A>
void shim_launch(K kern, int grid, int block, size_t smem, cudaStream_t,
                 A... args) {
  for (int b = 0; b < grid; ++b)
    run_cluster(b, 1, block, smem, [&] { kern(args...); });
}

inline int shim_cluster_size = 0;   // the last cudaLaunchKernelEx's

template <class... P, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kern)(P...),
                       A... args) {
  int cl = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cl = (int)cfg->attrs[i].val.clusterDim.x;
  shim_cluster_size = cl;
  const int grid = (int)cfg->gridDim.x;
  if (cl < 1 || cl > 8 || grid % cl) return cudaErrorInvalidValue;
  for (int b = 0; b < grid; b += cl)
    run_cluster(b, cl, (int)cfg->blockDim.x, cfg->dynamicSmemBytes,
                [&] { kern(args...); });
  return 0;
}
