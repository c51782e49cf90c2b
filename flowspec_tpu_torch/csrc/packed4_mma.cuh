// Shared main loop of the earlier packed 4-bit weight-only kernels, kept for
// comparison only (`nf4_matmul_strip` in nf4_matmul.cu, `int4_matmul_strip`
// in int4_matmul.cu, `int4_matmul_splitk` in int4_matmul_smallm.cu):
//   acc += x[m0:m0+16*MT, k] @ w[k, n0:n0+32*NT]   for k in 64-row blocks
//                                                   [kb0, kb1)
// with w decoded on the fly from the packed bytes, bf16 tensor-core mma.sync
// (m16n8k16) and f32 accumulation.
//
// Weight format (flowspec_tpu/ops/quant.py NF4Tensor / Int4Tensor): q is
// (In/2, Out) uint8 row-major, byte i of a column = code(row 2i) << 4 |
// code(row 2i+1); scale is (In/64, Out) f32, one per 64 contraction rows per
// column. The decoded operand is, exactly as in the TPU kernels
// (flowspec_tpu/ops/quant_matmul.py:128-139, 149-158, 221-222),
//   w = bf16( bf16(value) * bf16(scale) )
// with value = nibble - 8 (int4) or code[nibble] (nf4, a 16-entry bf16 table
// the caller passes, so kernel and plain version share the operand bit for
// bit). The product is one bf16 multiply (round to nearest even), not an f32
// fma that would skip the middle rounding.
//
// One packed byte holds two *adjacent* contraction rows, which is what an
// mma B fragment wants (two consecutive k per 32-bit register): the high
// nibble lands in the low half, the low nibble in the high half, and x is
// read as it is (the TPU kernels' even/odd split of x has no counterpart).
// A stage is BK = 64 rows = 32 packed rows = exactly one scale row.
//
// A block is 4 warps; warp w owns n-tiles [w*NT, (w+1)*NT) of 8 columns for
// all MT m-tiles. Stages move with 16-byte cp.async copies through a ring of
// STAGES buffers (x tile bf16, packed weight tile, scale row).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace fs {

constexpr int PK = BK / 2;   // packed weight rows per stage

template <int MT, int NT, int STAGES>
struct __align__(16) P4Smem {
  __nv_bfloat16 x[STAGES][MT * 16][XS];
  uint8_t w[STAGES][PK][32 * NT];
  float s[STAGES][32 * NT];
  __nv_bfloat16 code[16];
};

// one packed byte (rows k, k+1 of a column) times the column's block scale
// -> bf16x2 register, row k (high nibble) in the low half
template <bool NF4>
__device__ __forceinline__ uint32_t decode_pair(uint8_t byte,
                                                __nv_bfloat162 s2,
                                                const __nv_bfloat16* code) {
  __nv_bfloat16 hi, lo;
  if (NF4) {
    hi = code[byte >> 4];
    lo = code[byte & 15];
  } else {
    hi = __int2bfloat16_rn(static_cast<int>(byte >> 4) - 8);
    lo = __int2bfloat16_rn(static_cast<int>(byte & 15) - 8);
  }
  __nv_bfloat162 v = __hmul2(__halves2bfloat162(hi, lo), s2);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Requires In % 64 == 0, Out % (32*NT) == 0, 16-byte aligned x, q and scale,
// blockDim.x == 128, 0 <= kb0 <= kb1 <= In/64. `code` is read only when NF4.
// Rows m >= M are zero-filled. On return acc[mt][nt] holds the m16n8
// fragment: c0,c1 at (row g, cols 2*t4, 2*t4+1), c2,c3 at row g+8, with
// g = lane/4, t4 = lane%4.
template <bool NF4, int MT, int NT, int STAGES>
__device__ __forceinline__ void p4_mainloop(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
    const float* __restrict__ scale, const __nv_bfloat16* __restrict__ code,
    int M, int In, int Out, int m0, int n0, int kb0, int kb1,
    P4Smem<MT, NT, STAGES>& sm, float acc[MT][NT][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  constexpr int BN = 32 * NT;
  constexpr int XV = MT * 16 * (BK / 8);   // 16-byte x copies per stage
  constexpr int WV = PK * BN / 16;         // 16-byte weight copies per stage
  constexpr int SV = BN / 4;               // 16-byte scale copies per stage

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  if (NF4 && tid < 16) sm.code[tid] = code[tid];

  auto load = [&](int stage, int kb) {
    const int k0 = kb * BK;
    for (int i = tid; i < XV; i += 128) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int m = m0 + r;
      const bool ok = m < M;
      cp_async16(&sm.x[stage][r][c], x + (size_t)(ok ? m : 0) * In + k0 + c,
                 ok);
    }
    for (int i = tid; i < WV; i += 128) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      cp_async16(&sm.w[stage][r][c],
                 q + (size_t)(kb * PK + r) * Out + n0 + c, true);
    }
    if (tid < SV)
      cp_async16(&sm.s[stage][tid * 4],
                 scale + (size_t)kb * Out + n0 + tid * 4, true);
  };

  // ring of STAGES buffers: a group is committed every step (empty past the
  // end), so waiting for all but the newest STAGES-2 groups means the stage
  // about to be read has landed
  const int nk = kb1 - kb0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, kb0 + s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kc visible; stage kc-1 no longer read
    if (kc + STAGES - 1 < nk)
      load((kc + STAGES - 1) % STAGES, kb0 + kc + STAGES - 1);
    cp_async_commit();
    const int st = kc % STAGES;

    __nv_bfloat162 s2[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16 sb =
          __float2bfloat16_rn(sm.s[st][(warp * NT + nt) * 8 + g]);
      s2[nt] = __halves2bfloat162(sb, sb);
    }
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = (warp * NT + nt) * 8 + g;
        const int kp = ks / 2 + t4;          // packed row of k = ks + 2*t4
        bf[nt][0] = decode_pair<NF4>(sm.w[st][kp][n], s2[nt], sm.code);
        bf[nt][1] = decode_pair<NF4>(sm.w[st][kp + 4][n], s2[nt], sm.code);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* xr = &sm.x[st][mt * 16 + g][ks + t4 * 2];
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(xr);
        a[1] = *reinterpret_cast<const uint32_t*>(xr + 8 * XS);
        a[2] = *reinterpret_cast<const uint32_t*>(xr + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(xr + 8 * XS + 8);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
}

// The wide kernel: a block owns a strip of 32*NT output columns for 16*MT
// rows and loops over all of In (no split-K, so no cross-block reduction and
// a fixed summation order); the epilogue is the single cast to bf16.
template <bool NF4, int MT, int NT, int STAGES>
__global__ void __launch_bounds__(128)
p4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ q,
                 const float* __restrict__ scale,
                 const __nv_bfloat16* __restrict__ code,
                 __nv_bfloat16* __restrict__ y, int M, int In, int Out) {
  __shared__ P4Smem<MT, NT, STAGES> sm;
  const int n0 = blockIdx.x * 32 * NT, m0 = blockIdx.y * 16 * MT;
  float acc[MT][NT][4];
  p4_mainloop<NF4, MT, NT, STAGES>(x, q, scale, code, M, In, Out, m0, n0, 0,
                                   In / BK, sm, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + (warp * NT + nt) * 8 + t4 * 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = m0 + mt * 16 + g;
      if (r < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * Out + n) =
            __floats2bfloat162_rn(acc[mt][nt][0], acc[mt][nt][1]);
      if (r + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(r + 8) * Out + n) =
            __floats2bfloat162_rn(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <bool NF4, int MT, int NT, int STAGES>
void p4_launch(const void* x, const void* q, const void* scale,
               const void* code, void* y, int M, int In, int Out,
               cudaStream_t stream) {
  dim3 grid(Out / (32 * NT), (M + 16 * MT - 1) / (16 * MT));
  p4_matmul_kernel<NF4, MT, NT, STAGES><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale),
      static_cast<const __nv_bfloat16*>(code),
      static_cast<__nv_bfloat16*>(y), M, In, Out);
}

// Tile choice by M: 16*MT rows per block (all rows share each weight tile,
// so the weight is read once per 128 rows); two n-tiles per warp halve the x
// re-reads once M is past one m-tile. The deep ring (4 stages) fits the 48 KB
// of static shared memory up to MT = 4; MT = 8 keeps 2.
template <bool NF4>
int p4_matmul(const void* x, const void* q, const void* scale,
              const void* code, void* y, int M, int In, int Out,
              cudaStream_t st) {
  const bool wide = Out % 64 == 0;
  if (M <= 16)
    p4_launch<NF4, 1, 1, 4>(x, q, scale, code, y, M, In, Out, st);
  else if (M <= 32)
    wide ? p4_launch<NF4, 2, 2, 4>(x, q, scale, code, y, M, In, Out, st)
         : p4_launch<NF4, 2, 1, 4>(x, q, scale, code, y, M, In, Out, st);
  else if (M <= 64)
    wide ? p4_launch<NF4, 4, 2, 4>(x, q, scale, code, y, M, In, Out, st)
         : p4_launch<NF4, 4, 1, 4>(x, q, scale, code, y, M, In, Out, st);
  else
    wide ? p4_launch<NF4, 8, 2, 2>(x, q, scale, code, y, M, In, Out, st)
         : p4_launch<NF4, 8, 1, 2>(x, q, scale, code, y, M, In, Out, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fs
