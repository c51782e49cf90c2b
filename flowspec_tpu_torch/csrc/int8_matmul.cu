// int8 weight-only dequant-matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel flowspec_tpu/ops/quant_matmul.py:_int8_kernel
// (called from :54 int8_matmul). Computes y = bf16((x @ bf16(q)) * scale)
// with x (M, In) bf16, q (In, Out) int8 row-major, scale (Out,) f32, f32
// accumulation -- the rounding order of flowspec_tpu/ops/quant.py:238-240.
//
// Bound on the H100: device-memory bytes. Along the decode path M is 1 (AR
// step), 9-10 (draft), 64 (prefill) or 81 (tree verify), so the product does
// at most ~160 operations per weight byte, well under the ~590 per int8 byte
// at which the bf16 tensor cores would bound it; the weight read (16.8 MB for
// a 7B wq, 45.1 MB for w_gate) sets the time. To come near it the whole card
// has to pull on the weights at once, megabytes have to be in flight, and
// the int8 -> bf16 conversion must not cost more issue slots than the read
// leaves.
//
// Design (`int8_matmul`, the skeleton in qmm_wgmma.cuh):
//  - At most two blocks an SM, each streaming one range of the product's
//    (row tile, 128-column strip, 64-row block) iterations, the ranges
//    within one 64-row block of each other. At least 132 tiles: stream-K,
//    contiguous ranges over the whole product, so every SM reads an equal
//    share of the weight bytes (a grid of whole strips, 148 at Qwen2-7B's
//    w_gate, left 16 SMs with twice the mean); a tile split across blocks
//    is finished by the block holding its last 64-row block from the
//    others' f32 partials. Fewer tiles: each tile in up to eight segments,
//    the tile's blocks one cluster that adds them in shared memory. Either
//    way the segments are added in ascending order, scaled per column and
//    cast once in the same kernel: no atomics on the data, equal bits on
//    every launch, no second pass.
//  - A cp.async ring of 4-6 stages in dynamic shared memory (an 8 KB weight
//    tile and the matching x tile per stage, ~100 KB a block at M 81), so
//    each SM keeps 48-64 KB of weight reads in flight.
//  - `wgmma` on the transposed product: the weight is the register operand,
//    fetched from shared memory as 32-bit words of four adjacent columns
//    (conflict-free by a 32-byte swizzle), turned into bf16 pairs with one
//    `prmt` and one f32 subtract per value, exact; x is the shared-memory
//    operand at the real row count rounded up to 16 / 64 / 96 / 128.
//
// The earlier design stays as `int8_matmul_strip`, for timing one against
// the other in one run: each block owns a strip of 32 or 64 columns and
// loops over all of In (no split-K), a cp.async double buffer in static
// shared memory, mma.sync m16n8k16 with B fragments built from single-byte
// shared loads (int8_mma.cuh, which head_topk.cu goes on using). Nothing on
// the serving path calls it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"
#include "qmm_wgmma.cuh"

namespace {

template <int MT, int NT>
__global__ void __launch_bounds__(128)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y, int M, int In, int Out) {
  __shared__ fs::MmaSmem<MT, NT> sm;
  const int n0 = blockIdx.x * 32 * NT, m0 = blockIdx.y * 16 * MT;
  float acc[MT][NT][4];
  fs::mma_mainloop<MT, NT>(x, q, M, In, Out, m0, n0, sm, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + (warp * NT + nt) * 8 + t4 * 2;
    const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = m0 + mt * 16 + g;
      if (r < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * Out + n) =
            __floats2bfloat162_rn(acc[mt][nt][0] * s0, acc[mt][nt][1] * s1);
      if (r + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(r + 8) * Out + n) =
            __floats2bfloat162_rn(acc[mt][nt][2] * s0, acc[mt][nt][3] * s1);
    }
  }
}

template <int MT, int NT>
void launch(const void* x, const void* q, const void* scale, void* y, int M,
            int In, int Out, cudaStream_t stream) {
  dim3 grid(Out / (32 * NT), (M + 16 * MT - 1) / (16 * MT));
  int8_matmul_kernel<MT, NT><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M, In,
      Out);
}

template <int MT>
void launch_nt(const void* x, const void* q, const void* scale, void* y,
               int M, int In, int Out, cudaStream_t stream) {
  // two n-tiles per warp halve the x re-reads once M is past one m-tile
  if (MT > 1 && Out % 64 == 0)
    launch<MT, 2>(x, q, scale, y, M, In, Out, stream);
  else
    launch<MT, 1>(x, q, scale, y, M, In, Out, stream);
}

}  // namespace

// x (M, In) bf16, q (In, Out) int8, scale (Out,) f32 -> y (M, Out) bf16 by
// the plan (bn, n, grid, split, stages) of `ops/quant_matmul.py matmul_plan`;
// partial is (grid, min(M, n), bn) f32 scratch of the stream-K cut (null
// when no tile is split, and in the split cut), flags the device's zeroed
// flags (qmm_wgmma.cuh `qmm_matmul`). Needs In % 64 == 0, Out % bn == 0 and
// 16-byte aligned x, q, scale, partial and y (the Python wrapper checks).
// Returns the first CUDA error.
extern "C" int int8_matmul(const void* x, const void* q, const void* scale,
                           void* partial, void* flags, void* y, int M, int In,
                           int Out, int bn, int n, int grid, int split,
                           int stages, void* stream) {
  return fs::qmm_matmul<fs::QMM_INT8>(x, q, scale, nullptr, partial, flags, y,
                                      M, In, Out, bn, n, grid, split, stages,
                                      static_cast<cudaStream_t>(stream));
}

// The strip kernel: x (M, In) bf16, q (In, Out) int8, scale (Out,) f32 ->
// y (M, Out) bf16. Needs In % 64 == 0, Out % 32 == 0, 16-byte aligned x and
// q. Returns cudaGetLastError() after the launch.
extern "C" int int8_matmul_strip(const void* x, const void* q,
                                 const void* scale, void* y, int M, int In,
                                 int Out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    launch_nt<1>(x, q, scale, y, M, In, Out, st);
  else if (M <= 32)
    launch_nt<2>(x, q, scale, y, M, In, Out, st);
  else if (M <= 64)
    launch_nt<4>(x, q, scale, y, M, In, Out, st);
  else
    launch_nt<8>(x, q, scale, y, M, In, Out, st);
  return static_cast<int>(cudaGetLastError());
}
