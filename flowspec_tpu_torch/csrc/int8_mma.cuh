// Shared main loop of the earlier int8 kernels, kept for comparison only
// (`int8_matmul_strip` in int8_matmul.cu, `head_topk_strip` in
// head_topk.cu): acc += x[m0:m0+16*MT, :] @ bf16(q[:, n0:n0+32*NT]) with
// bf16 tensor-core mma.sync (m16n8k16) and f32 accumulation.
//
// A block is 4 warps. Warp w owns n-tiles [w*NT, (w+1)*NT) (8 columns each)
// of the block's 32*NT columns, for all MT m-tiles of 16 rows. The
// contraction runs in stages of BK = 64 rows, double-buffered in shared
// memory with cp.async: the x tile as bf16, the weight tile as raw int8
// (16-byte copies, coalesced along Out). Weights are converted to bf16 when
// the B fragments are built; the conversion is exact for |q| <= 127, so the
// products are exactly those of `x @ q.astype(bf16)` in the JAX package.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fs {

constexpr int BK = 64;       // contraction rows per stage
constexpr int XS = BK + 8;   // padded x-tile row stride (bf16): conflict-free A loads

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;     // 0 source bytes = zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// two int8 weights (k, k+1) -> one bf16x2 register, lower k in the low half
__device__ __forceinline__ uint32_t pack_i8_pair(int8_t a, int8_t b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(a),
                                           static_cast<float>(b));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MT, int NT>
struct __align__(16) MmaSmem {
  __nv_bfloat16 x[2][MT * 16][XS];
  int8_t w[2][BK][32 * NT];
};

// Requires In % 64 == 0, Out % (32*NT) == 0, 16-byte aligned x and q, and
// blockDim.x == 128. Rows m >= M are zero-filled. On return acc[mt][nt]
// holds the m16n8 fragment: c0,c1 at (row g, cols 2*t4, 2*t4+1), c2,c3 at
// row g+8, with g = lane/4, t4 = lane%4.
template <int MT, int NT>
__device__ __forceinline__ void mma_mainloop(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    int M, int In, int Out, int m0, int n0, MmaSmem<MT, NT>& sm,
    float acc[MT][NT][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  constexpr int BN = 32 * NT;
  constexpr int XV = MT * 16 * (BK / 8);   // 16-byte x copies per stage
  constexpr int WV = BK * BN / 16;         // 16-byte weight copies per stage

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  auto load = [&](int stage, int k0) {
    for (int i = tid; i < XV; i += 128) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int m = m0 + r;
      const bool ok = m < M;
      cp_async16(&sm.x[stage][r][c], x + (size_t)(ok ? m : 0) * In + k0 + c,
                 ok);
    }
    for (int i = tid; i < WV; i += 128) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      cp_async16(&sm.w[stage][r][c], q + (size_t)(k0 + r) * Out + n0 + c,
                 true);
    }
    cp_async_commit();
  };

  const int nk = In / BK;
  load(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    const int st = kc & 1;
    if (kc + 1 < nk) {
      load(st ^ 1, (kc + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = (warp * NT + nt) * 8 + g;
        const int k = ks + t4 * 2;
        bf[nt][0] = pack_i8_pair(sm.w[st][k][n], sm.w[st][k + 1][n]);
        bf[nt][1] = pack_i8_pair(sm.w[st][k + 8][n], sm.w[st][k + 9][n]);
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
    __syncthreads();
  }
}

}  // namespace fs
