// NF4 weight-only dequant-matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel flowspec_tpu/ops/quant_matmul.py:_nf4_kernel (with
// :92 _nf4_decode; called through :163 _packed4_matmul from :318
// nf4_matmul). Computes y = bf16( sum_f32 x * w ) with x (M, In) bf16 and
// w = bf16( bf16(code[nibble]) * bf16(scale) ) decoded from q (In/2, Out)
// packed uint8 and scale (In/64, Out) f32 -- the TPU kernel's decode and
// rounding order (quant_matmul.py:127-141).
//
// Bound on the H100: device-memory bytes, narrowly. The packed weight is
// half a byte per element (8.4 MB for a 7B wq, 22.5 MB for w_gate); at M 81
// the product does ~320 operations per weight byte against ~295 at which the
// tensor cores take over, and every weight costs a table lookup and half a
// bf16 multiply on the CUDA cores on top, so decode work, not only bytes in
// flight, decides how near the bound it comes.
//
// Design (`nf4_matmul`, the skeleton in qmm_wgmma.cuh):
//  - The int8 kernel's cut (qmm_wgmma.cuh): stream-K over at least 132
//    tiles, else each tile's segments in one cluster; the f32 segments
//    added in ascending order and cast once in the same kernel: no atomics
//    on the data, equal bits on every launch. M 1, 9 and 10 are the same
//    kernel at width 16.
//  - A cp.async ring of 4-6 stages in dynamic shared memory: a 4 KB packed
//    tile (64 contraction rows = one scale row), its 512-byte scale row and
//    the x tile per stage.
//  - `wgmma` on the transposed product with the weight as the register
//    operand. One packed byte is two adjacent k of one column, i.e. one A
//    register: a lane fetches a 32-bit word (four adjacent columns of one
//    packed row, conflict-free by a 32-byte swizzle), looks each byte up in
//    a 256-entry table of decoded pairs (bf16x2(code[hi], code[lo]), built
//    per block from the 16 codes and kept in 8 copies so that a warp's
//    lookups spread over the banks) and multiplies by the bf16 block scale
//    with one `__hmul2`: the operand of `decode_pair` (packed4_mma.cuh), bit
//    for bit, at four instructions a byte instead of ten. The TPU kernel's
//    15-select decode tree and its even/odd split of x have no counterpart.
//
// The earlier design stays as `nf4_matmul_strip`, for timing one against
// the other in one run: blocks of 32 or 64 columns looping over all of In,
// a 2-4 stage ring in static shared memory, mma.sync with B fragments from
// single-byte shared loads (packed4_mma.cuh `p4_matmul`, which the int4
// kernels go on using). Nothing on the serving path calls it.

#include "packed4_mma.cuh"
#include "qmm_wgmma.cuh"

// x (M, In) bf16, q (In/2, Out) uint8, scale (In/64, Out) f32, code (16,)
// bf16 -> y (M, Out) bf16 by the plan (bn, n, grid, split, stages) of
// `ops/quant_matmul.py matmul_plan`;
// partial is (grid, min(M, n), bn) f32 scratch of the stream-K cut (null
// when no tile is split, and in the split cut), flags the device's zeroed
// flags (qmm_wgmma.cuh `qmm_matmul`). Needs In % 64 == 0, Out % bn == 0 and
// 16-byte aligned x, q, scale, partial and y (the Python wrapper checks).
// Returns the first CUDA error.
extern "C" int nf4_matmul(const void* x, const void* q, const void* scale,
                          const void* code, void* partial, void* flags,
                          void* y, int M, int In, int Out, int bn, int n,
                          int grid, int split, int stages, void* stream) {
  return fs::qmm_matmul<fs::QMM_NF4>(x, q, scale, code, partial, flags, y, M,
                                     In, Out, bn, n, grid, split, stages,
                                     static_cast<cudaStream_t>(stream));
}

// The strip kernel: same operands without plan and scratch. Needs In % 64
// == 0, Out % 32 == 0 and 16-byte aligned x, q and scale. Returns
// cudaGetLastError() after the launch.
extern "C" int nf4_matmul_strip(const void* x, const void* q,
                                const void* scale, const void* code, void* y,
                                int M, int In, int Out, void* stream) {
  return fs::p4_matmul<true>(x, q, scale, code, y, M, In, Out,
                             static_cast<cudaStream_t>(stream));
}
