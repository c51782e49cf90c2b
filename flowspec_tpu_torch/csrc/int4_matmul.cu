// Linear int4 weight-only dequant-matmul for Hopper (sm_90a), the wide-M
// kernel (prefill chunks and tree verification, M > 32).
//
// Replaces the TPU kernel flowspec_tpu/ops/quant_matmul.py:144 _int4_kernel
// (called through :163 _packed4_matmul from :295 int4_matmul). Computes
// y = bf16( sum_f32 x * w ) with x (M, In) bf16 and
// w = bf16( bf16(nibble - 8) * bf16(scale) ) decoded from q (In/2, Out)
// packed uint8 and scale (In/64, Out) f32 -- the TPU kernel's decode and
// rounding order (quant_matmul.py:148-160).
//
// Bound on the H100: device-memory bytes (13.1 MB packed for a 13B wq at
// half a byte per weight; M = 64 or 81 gives ~260-320 operations per weight
// byte against a ridge of ~295, so the decode's issue slots, not only bytes
// in flight, decide how near the bound it comes).
//
// Design (`int4_matmul`, the skeleton in qmm_wgmma.cuh, as nf4_matmul.cu):
// the int8 kernel's cut (stream-K over at least 132 tiles, else each
// tile's segments in one cluster), the f32 segments added in ascending order
// and cast once in the same kernel (no atomics on the data, equal bits on
// every launch); a cp.async ring of 4-6 stages of the packed tile, its scale
// row and the x tile; `wgmma` on the
// transposed product with the decoded weight as the register operand. The
// decode needs no table: `i4_pair_bf16` builds the two bf16 values 128 + n
// of a byte with one prmt and one lop3, subtracts 136 exactly and
// multiplies by the block scale once -- the operand of `decode_pair<false>`
// bit for bit at about four instructions a byte instead of ten. Int4 keeps
// no table in shared memory (QmmTile<QMM_INT4>::LUT_BYTES is 0). Calls with
// M <= 32 run the same instantiation from int4_matmul_smallm.cu, under that
// library's entry point and launch count (the Python wrapper dispatches).
//
// The earlier design stays as `int4_matmul_strip`, for timing one against
// the other in one run: one block per 64 output columns looping over all of
// In, mma.sync with B fragments from single-byte shared loads
// (packed4_mma.cuh `p4_matmul`). Nothing on the serving path calls it.

#include "packed4_mma.cuh"
#include "qmm_wgmma.cuh"

// x (M, In) bf16, q (In/2, Out) uint8, scale (In/64, Out) f32 -> y (M, Out)
// bf16 by the plan (bn, n, grid, split, stages) of `ops/quant_matmul.py
// matmul_plan`;
// partial is (grid, min(M, n), bn) f32 scratch of the stream-K cut (null
// when no tile is split, and in the split cut), flags the device's zeroed
// flags (qmm_wgmma.cuh `qmm_matmul`). Needs In % 64 == 0, Out % bn == 0 and
// 16-byte aligned x, q, scale, partial and y (the Python wrapper checks).
// Returns the first CUDA error.
extern "C" int int4_matmul(const void* x, const void* q, const void* scale,
                           void* partial, void* flags, void* y, int M, int In,
                           int Out, int bn, int n, int grid, int split,
                           int stages, void* stream) {
  return fs::qmm_matmul<fs::QMM_INT4>(x, q, scale, nullptr, partial, flags, y,
                                      M, In, Out, bn, n, grid, split, stages,
                                      static_cast<cudaStream_t>(stream));
}

// The strip kernel: same operands without plan and scratch. Needs In % 64
// == 0, Out % 32 == 0 and 16-byte aligned x, q and scale. Returns
// cudaGetLastError() after the launch.
extern "C" int int4_matmul_strip(const void* x, const void* q,
                                 const void* scale, void* y, int M, int In,
                                 int Out, void* stream) {
  return fs::p4_matmul<false>(x, q, scale, nullptr, y, M, In, Out,
                              static_cast<cudaStream_t>(stream));
}
