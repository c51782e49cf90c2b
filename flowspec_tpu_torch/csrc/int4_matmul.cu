// Linear int4 weight-only dequant-matmul for Hopper (sm_90a), the wide-M
// kernel (prefill chunks and tree verification, M > 32).
//
// Replaces the TPU kernel flowspec_tpu/ops/quant_matmul.py:_int4_kernel
// (called through :163 _packed4_matmul from :295 int4_matmul). Computes
// y = bf16( sum_f32 x * w ) with x (M, In) bf16 and
// w = bf16( bf16(nibble - 8) * bf16(scale) ) decoded from q (In/2, Out)
// packed uint8 and scale (In/64, Out) f32 -- the TPU kernel's decode and
// rounding order (quant_matmul.py:148-160).
//
// Bound on the H100: device-memory bytes (13.1 MB packed for a 13B wq at
// half a byte per weight; M = 64 or 81 gives ~130-160 operations per weight
// byte against a ridge of ~295).
//
// Design (simple first, packed4_mma.cuh): nibbles unpack in registers into
// mma B fragments (a packed byte is two adjacent contraction rows, so x
// needs no even/odd split), nibble - 8 converts exactly to bf16 and meets
// the block scale in one bf16 multiply. Each block owns 64 output columns
// for up to 128 rows and loops over all of In with a cp.async ring: one
// fixed summation order, no cross-block reduction. Calls with M <= 32 go to
// the split-K kernel in int4_matmul_smallm.cu instead (the Python wrapper
// dispatches), which is what fills the card when one strip per block would
// leave most SMs idle.

#include "packed4_mma.cuh"

// x (M, In) bf16, q (In/2, Out) uint8, scale (In/64, Out) f32 -> y (M, Out)
// bf16. Needs In % 64 == 0, Out % 32 == 0 and 16-byte aligned x, q and scale
// (the Python wrapper checks). Returns cudaGetLastError() after the launch.
extern "C" int int4_matmul(const void* x, const void* q, const void* scale,
                           void* y, int M, int In, int Out, void* stream) {
  return fs::p4_matmul<false>(x, q, scale, nullptr, y, M, In, Out,
                              static_cast<cudaStream_t>(stream));
}
