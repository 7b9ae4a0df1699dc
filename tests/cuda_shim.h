// CPU emulation of the CUDA subset that tidehunter_tpu_torch/csrc uses, so
// that tests/test_torch_csrc_shim.py can run the kernels' own source on a
// host without nvcc or a card.  One std::thread per CUDA thread, block by
// block; __syncthreads is a barrier of the block, __syncwarp and every
// shuffle a barrier of the warp (so a kernel that lets a warp's lanes
// diverge across a shuffle deadlocks here, as the CUDA contract forbids).
// Shared memory is filled with 0xA5 bytes, not zeros, as the card gives
// no initial value.  Intrinsics compute their exact integer definitions.
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
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__

using std::max;
using std::min;

struct dim3s { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3s threadIdx, blockIdx, blockDim;

struct int4 { int x, y, z, w; };
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

inline void __syncthreads() { tblock->bar->arrive_and_wait(); }
inline WarpCtx* my_warp() { return tblock->warps[threadIdx.x / 32].get(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  my_warp()->bar.arrive_and_wait();
}

inline int shfl_impl(int v, int delta, bool up) {
  WarpCtx* w = my_warp();
  const int lane = threadIdx.x & 31;
  w->vals[lane] = v;
  w->bar.arrive_and_wait();
  const int src = up ? lane - delta : lane + delta;
  const int r = (src >= 0 && src < 32) ? w->vals[src] : v;
  w->bar.arrive_and_wait();
  return r;
}
inline int __shfl_up_sync(unsigned, int v, int d) {
  return shfl_impl(v, d, true);
}
inline int __shfl_down_sync(unsigned, int v, int d) {
  return shfl_impl(v, d, false);
}

template <class T> inline T __ldg(const T* p) { return *p; }
inline int __viaddmax_s32(int a, int b, int c) { return max(a + b, c); }
inline int __vimax3_s32(int a, int b, int c) { return max(max(a, b), c); }

// kern<<<grid, block, smem, stream>>>(args...)
template <class K, class... A>
void shim_launch(K kern, int grid, int block, size_t smem, cudaStream_t,
                 A... args) {
  for (int b = 0; b < grid; ++b) {
    BlockCtx ctx;
    ctx.bar = std::make_unique<std::barrier<>>(block);
    for (int w = 0; w < (block + 31) / 32; ++w)
      ctx.warps.push_back(std::make_unique<WarpCtx>());
    ctx.smem.assign(smem + 16, (char)0xA5);
    std::vector<std::thread> ths;
    for (int t = 0; t < block; ++t)
      ths.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = block;
        tblock = &ctx;
        shim_smem = ctx.smem.data();
        kern(args...);
      });
    for (auto& th : ths) th.join();
  }
}
