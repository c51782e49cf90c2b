// NF4 weight-only dequant-matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel flowspec_tpu/ops/quant_matmul.py:_nf4_kernel (with
// :92 _nf4_decode; called through :163 _packed4_matmul from :318
// nf4_matmul). Computes y = bf16( sum_f32 x * w ) with x (M, In) bf16 and
// w = bf16( bf16(code[nibble]) * bf16(scale) ) decoded from q (In/2, Out)
// packed uint8 and scale (In/64, Out) f32 -- the TPU kernel's decode and
// rounding order (quant_matmul.py:127-141).
//
// Bound on the H100: device-memory bytes. The packed weight is half a byte
// per element (8.4 MB for a 7B wq, 22.5 MB for w_gate) and along the decode
// path M is 1 to 81, so the product does at most ~320 operations per weight
// byte against a ridge of ~295 per byte: the weight read sets the time.
//
// Design (simple first, packed4_mma.cuh): the TPU kernel's 15-select decode
// tree exists because its vector unit has no gather; here the 16 bf16 code
// values sit in shared memory and a nibble indexes them (16 values span 8
// banks, so the lookups never conflict). The TPU kernel's split of x into
// even and odd columns is gone: a packed byte holds two adjacent contraction
// rows, exactly one 32-bit mma B register. Each block owns 32 or 64 output
// columns and loops over all of In with a cp.async ring, so sums have one
// fixed order and no cross-block reduction. Known slack, left for a later
// change: at M <= 16 only Out/32 blocks run (128 for Out 4096 on 132 SMs)
// with a 1 KB weight tile per stage in flight each.

#include "packed4_mma.cuh"

// x (M, In) bf16, q (In/2, Out) uint8, scale (In/64, Out) f32, code (16,)
// bf16 -> y (M, Out) bf16. Needs In % 64 == 0, Out % 32 == 0 and 16-byte
// aligned x, q and scale (the Python wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int nf4_matmul(const void* x, const void* q, const void* scale,
                          const void* code, void* y, int M, int In, int Out,
                          void* stream) {
  return fs::p4_matmul<true>(x, q, scale, code, y, M, In, Out,
                             static_cast<cudaStream_t>(stream));
}
