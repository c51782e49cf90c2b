// Tree-masked latent attention (DeepSeek's MLA, absorbed form) for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no latent attention. It was
// added with DeepSeek-V3 (models/deepseek.py), whose 128 query heads share
// one latent key row per token: the 512 normed latent values c_kv followed
// by the 64 roped key values k_pe (C = 576). With q_nope absorbed through
// kv_b's key half, every head's query is a C-wide row, every key the latent
// row, and every value the latent row's first DV = 512 values; kv_b's value
// half is applied to the output afterwards. For each of `lanes` lanes:
//   O[r] = softmax(Q[r] K^T * scale + bias[r % T]) V,   r < rows = heads * T
// with q (rows, C) bf16 (row r = head r / T at tree position r % T), the
// latent rows kv (S, C) bf16, bias (T, S) f32 (every head of a position
// shares its row) and O (rows, DV) bf16.
//
// Numerics follow the tree-attention kernel: f32 scores (scale, then bias),
// online softmax (m, l, acc) with P rounded to bf16 before the PV product
// and l summed from the f32 P, f32 accumulation, acc / max(l, 1e-30) last.
//
// Live keys. Given a device pointer `n_valid` (one int32 a lane; the
// serving path keeps it on the card so that a replayed CUDA graph sees each
// round's value) a block works through the first ceil(n_valid / 64) 64-key
// tiles (at least one, at most S / 64); given a null pointer, through
// n_keys / 64 tiles. Columns at or past n_valid carry a -1e9 bias (the
// caller's contract, ops/mla_attention.py), so they add exactly nothing.
//
// Bound on the H100: operations, past a few hundred keys. A verify of 81
// tree rows has 128 x 81 = 10,368 query rows against every latent row:
// 2 x 10,368 x keys x (576 + 512) FLOPs, 23 GFLOP at 1024 keys (23 us at
// 989 TFLOP/s), while the latent rows are 1.2 MB (0.35 us at 3.35 TB/s).
// The regime is that of a GEMM, not of the memory-bound GQA kernel.
//
// Design (a first kernel: right and simple):
//  - One block of 8 warps per 32 query rows (BM) of one lane, walking the
//    live 64-key tiles (BN) in order. Q (32 x 576) is loaded once; the key
//    tiles (64 x 576) are double-buffered through cp.async, the next tile in
//    flight while this one is used. V needs no load of its own: it is the
//    first 512 columns of the key tile already in shared memory.
//  - Scores through mma.sync.m16n8k16 (bf16 -> f32): warp w computes the
//    16 x 16 block (rows 16 (w / 4), keys 16 (w % 4)) over the 576-deep
//    product, Q and K read with ldmatrix, and writes it, scaled and biased,
//    to shared memory.
//  - The online softmax of the tile: 8 threads a row, max and sum by warp
//    shuffles; P (bf16) to shared memory, and per row the new max, sum and
//    the factor that rescales the accumulator.
//  - PV through mma.sync: warp w owns rows 16 (w / 4) and value columns
//    128 (w % 4) .. + 128, a 16 x 128 f32 accumulator (64 registers a
//    thread); P read with ldmatrix, V with ldmatrix.trans from the key tile.
//  - Rows of every shared array are padded by 16 bytes so that the 8 rows
//    of an ldmatrix phase fall in 8 different bank groups.
//  - No split over keys and no cluster: 10,368 verify rows are 324 blocks
//    (2.5 waves of one block an SM), a 64-row prefill chunk 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 576;           // latent row: values + rope keys
constexpr int DV = 512;          // value columns
constexpr int BM = 32;           // query rows a block
constexpr int BN = 64;           // keys a tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CP = C + 8;        // padded row of Q and K tiles (bf16)
constexpr int SP = BN + 4;       // padded row of the score tile (f32)
constexpr int PP = BN + 8;       // padded row of the P tile (bf16)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float INIT_M = -1e30f;

constexpr int Q_BYTES = BM * CP * 2;
constexpr int K_BYTES = BN * CP * 2;
constexpr int S_BYTES = BM * SP * 4;
constexpr int P_BYTES = BM * PP * 2;
constexpr int SMEM_BYTES = Q_BYTES + 2 * K_BYTES + S_BYTES + P_BYTES
                           + 3 * BM * 4;

__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem,
                                            bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// one 64 x 576 key tile (keys k0 ..) into shared memory, 16 bytes a copy
__device__ __forceinline__ void load_tile(__nv_bfloat16* ks,
                                          const __nv_bfloat16* kv, int k0) {
  constexpr int CHUNKS = C / 8;                 // 16-byte chunks a row
  for (int i = threadIdx.x; i < BN * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    cp_async16z(ks + r * CP + c, kv + static_cast<int64_t>(k0 + r) * C + c,
                true);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
mla_attention_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ kv,
                     const float* __restrict__ bias,
                     const int* __restrict__ n_valid,
                     __nv_bfloat16* __restrict__ out, int rows, int t,
                     int s_max, int n_keys, int64_t bias_lane_stride,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(smem + Q_BYTES);
  float* ss = reinterpret_cast<float*>(smem + Q_BYTES + 2 * K_BYTES);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(
      smem + Q_BYTES + 2 * K_BYTES + S_BYTES);
  float* m_s = reinterpret_cast<float*>(smem + Q_BYTES + 2 * K_BYTES
                                        + S_BYTES + P_BYTES);
  float* l_s = m_s + BM;
  float* c_s = l_s + BM;

  const int lane_id = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
  q += static_cast<int64_t>(lane_id) * rows * C;
  out += static_cast<int64_t>(lane_id) * rows * DV;
  kv += static_cast<int64_t>(lane_id) * s_max * C;
  bias += lane_id * bias_lane_stride;

  int tiles = n_keys / BN;
  if (n_valid != nullptr) {
    const int nv = n_valid[lane_id];
    tiles = min(max((nv + BN - 1) / BN, 1), s_max / BN);
  }

  // Q (rows past `rows` zero-filled) and the first key tile: one group
  {
    constexpr int CHUNKS = C / 8;
    for (int i = threadIdx.x; i < BM * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const int gr = row0 + r;
      cp_async16z(qs + r * CP + c,
                  q + static_cast<int64_t>(min(gr, rows - 1)) * C + c,
                  gr < rows);
    }
  }
  load_tile(kbuf, kv, 0);
  cp_async_commit();
  if (threadIdx.x < BM) {
    m_s[threadIdx.x] = INIT_M;
    l_s[threadIdx.x] = 0.f;
  }

  const int mt = warp >> 2;            // 16-row slice of the block
  const int part = warp & 3;           // key slice (scores), column slice (PV)
  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < tiles; ++j) {
    __nv_bfloat16* ks = kbuf + (j & 1) * (BN * CP);
    if (j + 1 < tiles) {
      load_tile(kbuf + ((j + 1) & 1) * (BN * CP), kv, (j + 1) * BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // scores: rows 16 mt .., keys 16 part .. of the tile
    {
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      const __nv_bfloat16* qa = qs + (mt * 16 + (l % 16)) * CP + (l / 16) * 8;
      const __nv_bfloat16* kb =
          ks + (part * 16 + (l / 16) * 8 + (l % 8)) * CP + ((l / 8) % 2) * 8;
#pragma unroll 4
      for (int kk = 0; kk < C / 16; ++kk) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, qa + kk * 16);
        ldmatrix_x4(b, kb + kk * 16);
        mma_bf16(c0, a, b[0], b[1]);
        mma_bf16(c1, a, b[2], b[3]);
      }
      const int r_lo = mt * 16 + l / 4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r_lo + half * 8;
        const int gr = min(row0 + r, rows - 1);
        const float* brow = bias + static_cast<int64_t>(gr % t) * s_max
                            + j * BN;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* c = nt ? c1 : c0;
          const int col = part * 16 + nt * 8 + 2 * (l % 4);
          ss[r * SP + col] = c[half * 2] * scale + brow[col];
          ss[r * SP + col + 1] = c[half * 2 + 1] * scale + brow[col + 1];
        }
      }
    }
    __syncthreads();

    // online softmax of the tile: 8 threads a row, 8 keys each
    {
      const int r = threadIdx.x / 8, p8 = (threadIdx.x % 8) * 8;
      float s[8];
      const float4 v0 = *reinterpret_cast<const float4*>(ss + r * SP + p8);
      const float4 v1 = *reinterpret_cast<const float4*>(ss + r * SP + p8 + 4);
      s[0] = v0.x; s[1] = v0.y; s[2] = v0.z; s[3] = v0.w;
      s[4] = v1.x; s[5] = v1.y; s[6] = v1.z; s[7] = v1.w;
      float mx = s[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) mx = fmaxf(mx, s[i]);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float mb = m_new * LOG2E;
      float sum = 0.f;
      uint32_t packed[4];
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        const float p0 = exp2f(s[i] * LOG2E - mb);
        const float p1 = exp2f(s[i + 1] * LOG2E - mb);
        sum += p0 + p1;
        packed[i / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      *reinterpret_cast<uint4*>(ps + r * PP + p8) =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
      if (threadIdx.x % 8 == 0) {
        const float corr = exp2f(m_old * LOG2E - mb);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // PV: rows 16 mt .., value columns 128 part ..
    {
      const int r_lo = mt * 16 + l / 4;
      const float c_lo = c_s[r_lo], c_hi = c_s[r_lo + 8];
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        acc[n][0] *= c_lo; acc[n][1] *= c_lo;
        acc[n][2] *= c_hi; acc[n][3] *= c_hi;
      }
      const __nv_bfloat16* pa = ps + (mt * 16 + (l % 16)) * PP + (l / 16) * 8;
      const __nv_bfloat16* vb =
          ks + (((l / 8) % 2) * 8 + (l % 8)) * CP + part * 128 + (l / 16) * 8;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, pa + kk * 16);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vb + kk * 16 * CP + np * 16);
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  // acc / l, bf16, rows past `rows` dropped
  const int r_lo = mt * 16 + l / 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + half * 8;
    const int gr = row0 + r;
    if (gr >= rows) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    __nv_bfloat16* orow = out + static_cast<int64_t>(gr) * DV + part * 128
                          + 2 * (l % 4);
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][half * 2] * inv, acc[n][half * 2 + 1] * inv);
    }
  }
}

}  // namespace

// q (lanes, rows, 576), kv (lanes, s_max, 576), bias (lanes or 1, t, s_max)
// f32 (bias_shared: one (t, s_max) bias for every lane), n_valid (lanes,)
// int32 on the card or null, out (lanes, rows, 512). Returns
// cudaGetLastError() after the launch.
extern "C" int mla_attention(const void* q, const void* kv, const void* bias,
                             const void* n_valid, void* out, int lanes,
                             int rows, int t, int s_max, int n_keys,
                             int bias_shared, float scale,
                             cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(mla_attention_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    attr = true;
  }
  const dim3 grid((rows + BM - 1) / BM, lanes);
  mla_attention_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kv), static_cast<const float*>(bias),
      static_cast<const int*>(n_valid), static_cast<__nv_bfloat16*>(out),
      rows, t, s_max, n_keys,
      bias_shared ? 0 : static_cast<int64_t>(t) * s_max, scale);
  return static_cast<int>(cudaGetLastError());
}
