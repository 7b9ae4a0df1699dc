// Backtrack of the profile DP direction plane, for Hopper.
//
// Replaces the Pallas TPU kernel tidehunter_tpu/ops/msa_device.py::
// _make_bt_kernel (full and banded variants).  The TPU kernel walks every
// problem in lockstep over levels L = j + c from 2T down, one dirs row per
// grid step; here one thread per problem walks its own path through the
// plane in device memory, which visits exactly the levels the lockstep
// walk activates for that problem, in the same order.
//
// Outputs per problem b, bit-identical with the TPU kernel:
//   ops[b, NL-1-m] = m-th emitted op (0 M, 1 I, 2 D; unused lanes 3), so
//                    lanes [NL - nst, NL) read left to right are the
//                    forward alignment (update_step reads this layout);
//   nst[b]         = number of steps;
//   tch[b]         = 1 when a visited position (j, c) has |c - j| >= wb - 8
//                    (banded only, wb = W - 8), else 0.
// The mode machine (runs commit to a gap track at entry; M over I over D)
// follows msa_device.py:539-573.  At a boundary (j == 0 or c == 0) the op
// is forced and no direction byte is read; a cell whose lane lies outside
// the band window reads as 0, as the TPU kernel's masked extract does.
//
// What bounds it: a dependent chain of one byte load per step (latency,
// not bandwidth); the plane was just written and is largely L2-resident.
// One thread per problem keeps the walk trivially race-free; it costs
// next to nothing beside the DP it follows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_PAD = 3;

__device__ __forceinline__ int band_base(int r, int T, int W) {
  const int wb = W - 8;
  int base = ((r - wb) >> 1) - 2;
  base = base < T - W ? base : T - W;
  return base > 0 ? base : 0;
}

__global__ void profile_bt_kernel(const uint8_t* __restrict__ dirs, int B,
                                  int T, int W,
                                  const int* __restrict__ qlen_a,
                                  const int* __restrict__ ncol_a, int NL,
                                  int8_t* __restrict__ ops,
                                  int* __restrict__ nst,
                                  int* __restrict__ tch) {
  const int bi = blockIdx.x * blockDim.x + threadIdx.x;
  if (bi >= B) return;
  const int Wd = W ? W : T;
  const int wb = W - 8;
  int8_t* orow = ops + (size_t)bi * NL;
  for (int i = 0; i < NL; ++i) orow[i] = OP_PAD;

  int j = qlen_a[bi], c = ncol_a[bi];
  int mode = -1;   // -1 fresh; 1/3 I run track 1/2; 2/4 D run track 1/2
  int m = 0, touch = 0;
  while (j > 0 || c > 0) {
    int val = 0;
    if (j > 0 && c > 0) {
      const int r = j + c - 2;
      const int lane = (c - 1) - (W ? band_base(r, T, W) : 0);
      if (lane >= 0 && lane < Wd)
        val = dirs[(size_t)r * B * Wd + (size_t)bi * Wd + lane];
    }
    const int d = val & 3;
    const int icont1 = (val >> 2) & 1, fcont1 = (val >> 3) & 1;
    const int isel2 = (val >> 4) & 1, fsel2 = (val >> 5) & 1;
    const int icont2 = (val >> 6) & 1, fcont2 = (val >> 7) & 1;
    const bool in_run = mode > 0;
    int sel = d;
    if (in_run) sel = (mode == 1 || mode == 3) ? 1 : 2;
    if (j == 0)
      sel = 2;
    else if (c == 0)
      sel = 1;
    orow[NL - 1 - m] = (int8_t)(sel == 0 ? OP_M : (sel == 1 ? OP_I : OP_D));
    if (W && abs(c - j) >= wb - 8) touch = 1;
    const int i_trk2 = in_run ? (mode == 3) : isel2;
    const int d_trk2 = in_run ? (mode == 4) : fsel2;
    const int icont = i_trk2 ? icont2 : icont1;
    const int fcont = d_trk2 ? fcont2 : fcont1;
    if (sel == 0)
      mode = -1;
    else if (sel == 1)
      mode = icont ? (i_trk2 ? 3 : 1) : -1;
    else
      mode = fcont ? (d_trk2 ? 4 : 2) : -1;
    if (sel != 2) j -= 1;
    if (sel != 1) c -= 1;
    ++m;
  }
  nst[bi] = m;
  tch[bi] = touch;
}

}  // namespace

// dirs [2T-1, B, W or T] uint8 (W = 0: full width), qlen/ncol [B] int32;
// ops [B, NL] int8, nst/tch [B] int32.
extern "C" int profile_bt(const void* dirs, int B, int T, int W,
                          const void* qlen, const void* ncol, int NL,
                          void* ops, void* nst, void* tch, void* stream) {
  if (B == 0) return 0;
  const int threads = 128;
  profile_bt_kernel<<<(B + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)dirs, B, T, W, (const int*)qlen, (const int*)ncol, NL,
      (int8_t*)ops, (int*)nst, (int*)tch);
  return (int)cudaGetLastError();
}
