// CPU emulation of the CUDA subset that tidehunter_tpu_torch/csrc uses, so
// that tests/test_torch_csrc_shim.py can run the kernels' own source on a
// host without nvcc or a card.  One std::thread per CUDA thread, block by
// block; __syncthreads is a barrier of the block, __syncwarp and every
// shuffle a barrier of the warp (so a kernel that lets a warp's lanes
// diverge across a shuffle deadlocks here, as the CUDA contract forbids).
// Shared memory is filled with 0xA5 bytes, not zeros, as the card gives
// no initial value.  cp.async copies (cuda_pipeline.h) are synchronous.
// Intrinsics compute their exact integer definitions; a ballot is a
// barrier of the warp like a shuffle.  cudaLaunchKernelEx
// runs the CTAs of a thread-block cluster at once: cooperative_groups'
// this_cluster().sync() is a barrier of all their threads and
// map_shared_rank() points into another CTA's shared memory.  The SM count
// a program reads is $CUDA_SHIM_SMS (default 132), so that a test can steer
// a launcher's choice of cluster.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
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
enum { cudaDevAttrMultiProcessorCount = 16 };
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
inline int cudaDeviceGetAttribute(int* v, int, int) {
  const char* sms = std::getenv("CUDA_SHIM_SMS");
  *v = sms ? std::atoi(sms) : 132;
  return 0;
}
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "cuda_shim"; }

struct WarpCtx {
  std::barrier<> bar{32};
  int vals[32];
};
struct BlockCtx {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<WarpCtx>> warps;
  std::vector<char> smem;
};
inline thread_local BlockCtx* tblock;
inline thread_local char* shim_smem;
struct ClusterCtx {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<BlockCtx*> blocks;
};
inline thread_local ClusterCtx* tcluster;

namespace cooperative_groups {
struct cluster_group {
  void sync() const { tcluster->bar->arrive_and_wait(); }
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
// outside the warp keeps its own
template <class F> inline int shfl_impl(int v, F src_of) {
  WarpCtx* w = my_warp();
  const int lane = threadIdx.x & 31;
  w->vals[lane] = v;
  w->bar.arrive_and_wait();
  const int src = src_of(lane);
  const int r = (src >= 0 && src < 32) ? w->vals[src] : v;
  w->bar.arrive_and_wait();
  return r;
}
inline int __shfl_up_sync(unsigned, int v, int d) {
  return shfl_impl(v, [d](int l) { return l - d; });
}
inline int __shfl_down_sync(unsigned, int v, int d) {
  return shfl_impl(v, [d](int l) { return l + d; });
}
inline int __shfl_xor_sync(unsigned, int v, int m) {
  return shfl_impl(v, [m](int l) { return l ^ m; });
}
inline int __shfl_sync(unsigned, int v, int src) {
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
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __ffs(int x) { return __builtin_ffs(x); }

// cuda_pipeline.h's primitives: the copy is done at once, so commit and
// wait have nothing left to do
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

template <class T> inline T __ldg(const T* p) { return *p; }
inline int __viaddmax_s32(int a, int b, int c) { return max(a + b, c); }
inline int __vimax3_s32(int a, int b, int c) { return max(max(a, b), c); }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  return (unsigned)((((unsigned long long)hi << 32) | lo) >> (sh & 31));
}
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
  std::vector<std::unique_ptr<BlockCtx>> ctxs;
  for (int i = 0; i < n; ++i) {
    auto ctx = std::make_unique<BlockCtx>();
    ctx->bar = std::make_unique<std::barrier<>>(block);
    for (int w = 0; w < (block + 31) / 32; ++w)
      ctx->warps.push_back(std::make_unique<WarpCtx>());
    ctx->smem.assign(smem + 16, (char)0xA5);
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
        run();
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

template <class... P, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kern)(P...),
                       A... args) {
  int cl = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cl = (int)cfg->attrs[i].val.clusterDim.x;
  const int grid = (int)cfg->gridDim.x;
  if (cl < 1 || cl > 8 || grid % cl) return cudaErrorInvalidValue;
  for (int b = 0; b < grid; b += cl)
    run_cluster(b, cl, (int)cfg->blockDim.x, cfg->dynamicSmemBytes,
                [&] { kern(args...); });
  return 0;
}
