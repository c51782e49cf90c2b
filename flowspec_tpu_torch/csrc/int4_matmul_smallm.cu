// Linear int4 weight-only dequant-matmul for Hopper (sm_90a) at small M
// (M <= 32: autoregressive steps, draft chunks, short tails).
//
// Replaces the TPU kernel flowspec_tpu/ops/quant_matmul.py:203
// _int4_kfull_kernel (called from :256 _int4_matmul_kfull, dispatched by :295
// int4_matmul for B*T <= 32). Same function as int4_matmul.cu: y = bf16(
// sum_f32 x * w ), w = bf16( bf16(nibble - 8) * bf16(scale) ); only the order
// of the f32 sum differs.
//
// Bound on the H100: device-memory bytes. At M = 1 the product does two
// operations per weight, four per packed byte: a 13B wq (5120 x 5120) reads
// 13.1 MB of packed weights and 1.6 MB of scales, 4.4 us at 3.35 TB/s. What
// the TPU kernel does with a grid over K and an accumulator carried from step
// to step is here a grid over (column strip, K split): at M <= 32 a grid over
// columns alone gives 40 to 160 blocks and most of the 132 SMs' memory pipes
// sit idle.
//
// Design (`int4_matmul_smallm`): the `QMM_INT4` instantiation of the
// dequant-matmul skeleton (qmm_wgmma.cuh), the kernel int4_matmul.cu runs
// above 32 rows, cut by `ops/quant_matmul.py matmul_plan`: width 16 up to 16
// rows and 64 for 17-32, the int8 kernel's cut (stream-K over at least 132
// tiles, else each tile's segments in one cluster), a 6-stage cp.async ring
// of the packed tile, its scale row and the x tile, the table-free decode
// `i4_pair_bf16` in registers straight into `wgmma`, and the f32 segments
// added in ascending order inside the same kernel (no atomics on the data:
// equal bits on every launch).
//
// The earlier design stays as `int4_matmul_splitk`, for timing one against
// the other in one run: the same split-K grid (~4 blocks an SM, `split_k`) on
// packed4_mma.cuh's main loop (mma.sync, B fragments from single-byte shared
// loads and a 16-entry table decode), its reduce pass a plain second launch.
// Nothing on the serving path calls it.

#include "packed4_mma.cuh"
#include "qmm_wgmma.cuh"

namespace {

template <int MT, int NT>
__global__ void __launch_bounds__(128)
int4_splitk_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   float* __restrict__ partial, int M, int In, int Out,
                   int chunk) {
  __shared__ fs::P4Smem<MT, NT, 4> sm;
  const int n0 = blockIdx.x * 32 * NT;
  const int nkb = In / fs::BK;
  const int kb0 = min(static_cast<int>(blockIdx.y) * chunk, nkb);
  const int kb1 = min(kb0 + chunk, nkb);
  float acc[MT][NT][4];
  fs::p4_mainloop<false, MT, NT, 4>(x, q, scale, nullptr, M, In, Out, 0, n0,
                                    kb0, kb1, sm, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  float* out = partial + (size_t)blockIdx.y * M * Out;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + (warp * NT + nt) * 8 + t4 * 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = mt * 16 + g;
      if (r < M)
        *reinterpret_cast<float2*>(out + (size_t)r * Out + n) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < M)
        *reinterpret_cast<float2*>(out + (size_t)(r + 8) * Out + n) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// y[i] = bf16( partial[0][i] + partial[1][i] + ... ), two columns a thread
__global__ void __launch_bounds__(256)
int4_splitk_reduce_kernel(const float* __restrict__ partial,
                          __nv_bfloat16* __restrict__ y, int n_pairs,
                          int ksplit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const float2* p = reinterpret_cast<const float2*>(partial) + i;
  float2 s = p[0];
  for (int k = 1; k < ksplit; ++k) {
    const float2 v = p[(size_t)k * n_pairs];
    s.x += v.x;
    s.y += v.y;
  }
  reinterpret_cast<__nv_bfloat162*>(y)[i] = __floats2bfloat162_rn(s.x, s.y);
}

template <int MT, int NT>
void launch(const void* x, const void* q, const void* scale, void* partial,
            int M, int In, int Out, int ksplit, cudaStream_t stream) {
  const int nkb = In / fs::BK;
  const int chunk = (nkb + ksplit - 1) / ksplit;
  dim3 grid(Out / (32 * NT), ksplit);
  int4_splitk_kernel<MT, NT><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(partial), M, In,
      Out, chunk);
}

template <int MT>
void launch_nt(const void* x, const void* q, const void* scale, void* partial,
               int M, int In, int Out, int ksplit, cudaStream_t stream) {
  if (Out % 128 == 0)
    launch<MT, 4>(x, q, scale, partial, M, In, Out, ksplit, stream);
  else if (Out % 64 == 0)
    launch<MT, 2>(x, q, scale, partial, M, In, Out, ksplit, stream);
  else
    launch<MT, 1>(x, q, scale, partial, M, In, Out, ksplit, stream);
}

}  // namespace

// x (M, In) bf16 with M <= 32, q (In/2, Out) uint8, scale (In/64, Out) f32
// -> y (M, Out) bf16 by the plan (bn, n, grid, split, stages) of
// `ops/quant_matmul.py matmul_plan`;
// partial is (grid, min(M, n), bn) f32 scratch of the stream-K cut (null
// when no tile is split, and in the split cut), flags the device's zeroed
// flags (qmm_wgmma.cuh `qmm_matmul`). Needs In % 64 == 0, Out % bn == 0 and
// 16-byte aligned x, q, scale, partial and y (the Python wrapper checks).
// Returns the first CUDA error.
extern "C" int int4_matmul_smallm(const void* x, const void* q,
                                  const void* scale, void* partial,
                                  void* flags, void* y, int M, int In,
                                  int Out, int bn, int n, int grid,
                                  int split, int stages, void* stream) {
  return fs::qmm_matmul<fs::QMM_INT4>(x, q, scale, nullptr, partial, flags, y,
                                      M, In, Out, bn, n, grid, split, stages,
                                      static_cast<cudaStream_t>(stream));
}

// The earlier split-K kernel: the same operands, partial (ksplit, M, Out) f32
// scratch. Split s sums the 64-row blocks [s*chunk, (s+1)*chunk) with chunk =
// ceil(In/64 / ksplit). Needs In % 64 == 0, Out % 32 == 0, ksplit >= 1 and
// 16-byte aligned x, q, scale and partial. Returns cudaGetLastError() after
// the two launches.
extern "C" int int4_matmul_splitk(const void* x, const void* q,
                                  const void* scale, void* partial, void* y,
                                  int M, int In, int Out, int ksplit,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    launch_nt<1>(x, q, scale, partial, M, In, Out, ksplit, st);
  else
    launch_nt<2>(x, q, scale, partial, M, In, Out, ksplit, st);
  const int n_pairs = M * Out / 2;
  int4_splitk_reduce_kernel<<<(n_pairs + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(y),
      n_pairs, ksplit);
  return static_cast<int>(cudaGetLastError());
}
