// Fused draft-head scoring for Hopper (sm_90a): top-k of
// log_softmax(x @ (q * scale)) in one pass over the int8 head.
//
// Replaces the TPU kernel flowspec_tpu/ops/head_topk.py:90 _kernel (called
// from :125 _head_topk_call, merged at :173-180, entry :242 head_topk). x (T,
// H) bf16, q (H, V) int8, scale (V,) f32, k small -> logp (T, k) f32 and
// tok (T, k) int32, ordered by (log-prob desc, token asc): ties go to the
// lowest token id, as jax.lax.top_k does.
//
// Bound on the H100: device-memory bytes. The beam calls it with T = 1
// (root) or T = 10 (one row per frontier node): 2*T operations per weight
// byte, and the 7B head is 131 MB of int8 (39 us at 3.35 TB/s; the 13B head
// 164 MB, 49 us). The whole card has to stream the head at once, with
// megabytes in flight, and the (T, V) f32 logits must never reach device
// memory (the point of the JAX kernel).
//
// Design (`head_topk`):
//  - The main kernel is the int8 instantiation of the dequant-matmul
//    skeleton's main loop (qmm_wgmma.cuh `qmm_mainloop`: a cp.async ring of
//    6 stages, the int8 weight turned into bf16 wgmma operands in registers,
//    `wgmma` on the transposed product at width 16 for T <= 16 and 64 above,
//    row tiles past 64), with its own epilogue. One block per 128-column
//    strip (250 at V = 32000, about two on every SM) streams its (H, 128)
//    strip once; no K split, so no f32 sum crosses blocks. The plan (width,
//    ring, strips, row tiles) is `ops/head_topk.py head_plan`.
//  - The epilogue applies the per-column scale to the f32 sums, parks the
//    strip's logits in the ring's shared memory (free by then), and one warp
//    per row writes the strip's max, its sum of exp relative to that max, and
//    its top-k as 64-bit order keys (below) in (value desc, index asc)
//    order. A warp takes four rows at once, so their shuffle chains overlap.
//  - The merge is a programmatic dependent launch: one 256-thread block per
//    row, set up while the main grid runs, waiting for all of it
//    (`griddepcontrol.wait`). It copies the row's keys into shared memory
//    in one pass with every load in flight (20 KB at V 32000, k 10), so
//    that no round waits on device memory. The logsumexp over strips is
//    taken in a fixed order. Round j of the top-k takes the largest key
//    below round j-1's: each thread scans its share of the strips' entries
//    at positions <= j (the (j+1)-th best has at most j better entries in
//    its strip), a warp reduces by shuffles, and the eight warps' keys meet
//    in shared memory under one barrier a round. No atomics: equal bits on
//    every launch.
//
// Order keys. key(v, i) = (v's bits mapped to an unsigned order) << 32 |
// ~i: one 64-bit compare orders (value desc, index asc), so ties go to the
// lowest token id inside a strip and across strips alike, and "taken"
// needs no mark (round j takes the largest key below round j-1's).
//
// The earlier design stays as `head_topk_strip`, for timing one against the
// other in one run: the same two passes on the first main loop (int8_mma.cuh:
// a double buffer, mma.sync with B fragments from single-byte shared loads)
// and a merge whose k rounds each run a __syncthreads tree. Nothing on the
// serving path calls it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "int8_mma.cuh"
#include "qmm_wgmma.cuh"

namespace {

constexpr int BNH = 128;     // vocab columns per block (4 warps x 4 n-tiles)
constexpr int MERGE_THREADS = 256;
// the merge stages a row's k x strips keys in shared memory up to this size
// (with its static arrays under 48 KB: no opt-in needed); past it the rounds
// read them from device memory
constexpr int STAGE_BYTES = 47 * 1024;
constexpr int LG = BNH + 4;  // row stride (floats) of the parked logits

// ---- head_topk: the skeleton's main loop, order keys, a shuffle merge -------

__device__ __forceinline__ unsigned long long order_key(float v, int i) {
  uint32_t u = __float_as_uint(v + 0.f);        // -0 -> +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<uint32_t>(~i);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  const uint32_t u = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(~static_cast<uint32_t>(key));
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long ok = __shfl_xor_sync(0xffffffffu, k, o);
    k = ok > k ? ok : k;
  }
  return k;
}

// (m, s) <- the logsumexp pair of (m, s) and (pm, ps): s relative to m; an
// empty pair has s == 0. Commutative, so a butterfly gives every lane the
// same bits.
__device__ __forceinline__ void lse_add(float& m, float& s, float pm,
                                        float ps) {
  if (ps == 0.f) return;
  if (s == 0.f) {
    m = pm;
    s = ps;
  } else if (pm > m) {
    s = s * expf(m - pm) + ps;
    m = pm;
  } else {
    s += ps * expf(pm - m);
  }
}

// Grid (strips, 1, row tiles of N), 128 threads, smem_bytes(N, STAGES) of
// dynamic shared memory. Writes, for every row t < T and strip b: part_m[t][b]
// = the strip's max logit, part_s[t][b] = its sum of exp(logit - max), and
// part_key[t][j][b] (j < k) = the strip's j-th best order key.
template <int N, int STAGES>
__global__ void __launch_bounds__(128)
head_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint8_t* __restrict__ q,
                  const float* __restrict__ scale,
                  unsigned long long* __restrict__ part_key,
                  float* __restrict__ part_m, float* __restrict__ part_s,
                  int T, int H, int V, int k) {
  static_assert(N % 16 == 0 && N * LG * 4 <= STAGES * (N * 128 + 8192),
                "the parked logits must fit the ring");
  extern __shared__ __align__(16) uint8_t head_smem_raw[];
  uint8_t* sx = fs::smem_align1024(head_smem_raw);
  const int nblk = gridDim.x, strip = blockIdx.x;
  const int n0 = strip * BNH, m0 = blockIdx.z * N;
  float acc[2][N / 2];
  fs::qmm_mainloop<fs::QMM_INT8, N, STAGES>(x, q, scale, nullptr, sx, T, H,
                                            V, BNH, n0, m0, 0, H / fs::BK,
                                            acc);
  __syncthreads();               // every warp is past its last read of the ring

  // scaled logits of the block's N rows x 128 columns into shared memory;
  // rows past T hold zeros and are never written out
  float* lg = reinterpret_cast<float*>(sx);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int col = warp * 32 + g * 4;
  const float4 sc = *reinterpret_cast<const float4*>(scale + n0 + col);
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float4*>(lg + (8 * c + 2 * t4 + i) * LG + col) =
          make_float4(acc[0][4 * c + i] * sc.x, acc[0][4 * c + 2 + i] * sc.y,
                      acc[1][4 * c + i] * sc.z, acc[1][4 * c + 2 + i] * sc.w);
  __syncthreads();

  // warp w: rows r0 + 4 rr (rr < 4) for r0 = w, w + 16, ...; lane holds
  // columns lane + 32 i of each
  for (int r0 = warp; r0 < N && m0 + r0 < T; r0 += 16) {
    float v[4][4], mx[4], se[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      mx[rr] = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[rr][i] = lg[(r0 + 4 * rr) * LG + lane + 32 * i];
        mx[rr] = fmaxf(mx[rr], v[rr][i]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], o));
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      se[rr] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) se[rr] += expf(v[rr][i] - mx[rr]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        se[rr] += __shfl_xor_sync(0xffffffffu, se[rr], o);
    unsigned long long key[4][4], prev[4];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      prev[rr] = ~0ull;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        key[rr][i] = order_key(v[rr][i], n0 + lane + 32 * i);
      const int t = m0 + r0 + 4 * rr;
      if (lane == 0 && t < T) {
        part_m[(size_t)t * nblk + strip] = mx[rr];
        part_s[(size_t)t * nblk + strip] = se[rr];
      }
    }
    for (int j = 0; j < k; ++j) {
      unsigned long long best[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        best[rr] = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (key[rr][i] < prev[rr] && key[rr][i] > best[rr])
            best[rr] = key[rr][i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const unsigned long long ob =
              __shfl_xor_sync(0xffffffffu, best[rr], o);
          best[rr] = ob > best[rr] ? ob : best[rr];
        }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int t = m0 + r0 + 4 * rr;
        if (lane == (j & 31) && t < T)
          part_key[((size_t)t * k + j) * nblk + strip] = best[rr];
        prev[rr] = best[rr];
      }
    }
  }
}

// One block per row: the logsumexp over the strips' (max, sum) pairs and the
// top-k of the strips' keys, written as (logp, tok). `staged`: the row's
// k x nblk keys are copied into the dynamic shared memory first (which then
// holds k * nblk * 8 bytes), else read where they are.
__global__ void __launch_bounds__(MERGE_THREADS)
head_select_kernel(const unsigned long long* __restrict__ part_key,
                   const float* __restrict__ part_m,
                   const float* __restrict__ part_s, float* __restrict__ logp,
                   int* __restrict__ tok, int nblk, int k, int staged) {
  extern __shared__ unsigned long long sel_keys[];
  // launched while the main grid still runs: wait for all of it
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float wm[MERGE_THREADS / 32], ws[MERGE_THREADS / 32];
  __shared__ unsigned long long wk[2][MERGE_THREADS / 32];
  const int t = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const unsigned long long* row_keys = part_key + (size_t)t * k * nblk;
  if (staged) {
#pragma unroll 4
    for (int c = tid; c < k * nblk; c += MERGE_THREADS)
      sel_keys[c] = row_keys[c];
  }

  // logsumexp: strided per thread, a butterfly per warp, warps in order
  float m = -CUDART_INF_F, s = 0.f;
  for (int b = tid; b < nblk; b += MERGE_THREADS)
    lse_add(m, s, part_m[(size_t)t * nblk + b], part_s[(size_t)t * nblk + b]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    lse_add(m, s, om, os);
  }
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();               // also: the staged keys are in place
  m = wm[0];
  s = ws[0];
#pragma unroll
  for (int w = 1; w < MERGE_THREADS / 32; ++w) lse_add(m, s, wm[w], ws[w]);
  const float lse = m + logf(s);

  // round j: the largest key below round j-1's, among positions <= j
  const unsigned long long* keys = staged ? sel_keys : row_keys;
  unsigned long long prev = ~0ull;
  for (int j = 0; j < k; ++j) {
    unsigned long long best = 0;
    const int n = (j + 1) * nblk;
    for (int c = tid; c < n; c += MERGE_THREADS) {
      const unsigned long long key = keys[c];
      if (key < prev && key > best) best = key;
    }
    best = warp_max(best);
    if (lane == 0) wk[j & 1][warp] = best;
    __syncthreads();             // a round later the other slot is written
#pragma unroll
    for (int w = 0; w < MERGE_THREADS / 32; ++w)
      best = wk[j & 1][w] > best ? wk[j & 1][w] : best;
    prev = best;
    if (tid == 0) {
      logp[(size_t)t * k + j] = key_value(best) - lse;
      tok[(size_t)t * k + j] = key_index(best);
    }
  }
}

template <int N, int STAGES>
cudaError_t head_launch(const void* x, const void* q, const void* scale,
                        void* part_key, void* part_m, void* part_s, int T,
                        int H, int V, int k, cudaStream_t st) {
  static bool allowed[64] = {};
  constexpr int smem = fs::QmmTile<fs::QMM_INT8>::smem_bytes(N, STAGES);
  cudaError_t e = fs::allow_smem(head_wgmma_kernel<N, STAGES>, smem, allowed);
  if (e != cudaSuccess) return e;
  head_wgmma_kernel<N, STAGES>
      <<<dim3(V / BNH, 1, (T + N - 1) / N), 128, smem, st>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
          static_cast<unsigned long long*>(part_key),
          static_cast<float*>(part_m), static_cast<float*>(part_s), T, H, V,
          k);
  return cudaGetLastError();
}

// ---- head_topk_strip: the earlier design, for comparison only ----------------

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ bool after(float v, int i, float pv, int pi) {
  return v < pv || (v == pv && i > pi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__global__ void __launch_bounds__(128)
head_partial_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ q,
                    const float* __restrict__ scale,
                    float* __restrict__ part_val, int* __restrict__ part_idx,
                    float* __restrict__ part_m, float* __restrict__ part_s,
                    int T, int H, int V, int k) {
  __shared__ fs::MmaSmem<1, 4> sm;
  __shared__ float lg[16][BNH + 1];
  const int nb = blockIdx.x, nblk = gridDim.x;
  const int n0 = nb * BNH, m0 = blockIdx.y * 16;
  float acc[1][4][4];
  fs::mma_mainloop<1, 4>(x, q, T, H, V, m0, n0, sm, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = (warp * 4 + nt) * 8 + t4 * 2;
    const float s0 = scale[n0 + c], s1 = scale[n0 + c + 1];
    lg[g][c] = acc[0][nt][0] * s0;
    lg[g][c + 1] = acc[0][nt][1] * s1;
    lg[g + 8][c] = acc[0][nt][2] * s0;
    lg[g + 8][c + 1] = acc[0][nt][3] * s1;
  }
  __syncthreads();

  for (int r = warp; r < 16; r += 4) {
    const int t = m0 + r;
    if (t >= T) break;
    float v[4];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = lg[r][lane + 32 * i];
      mx = fmaxf(mx, v[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float se = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) se += expf(v[i] - mx);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      se += __shfl_xor_sync(0xffffffffu, se, o);
    const size_t base = (size_t)t * nblk + nb;
    if (lane == 0) {
      part_m[base] = mx;
      part_s[base] = se;
    }
    float pv = CUDART_INF_F;
    int pi = -1;
    for (int j = 0; j < k; ++j) {
      float bv = -CUDART_INF_F;
      int bi = 0x7fffffff;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = lane + 32 * i;
        if (after(v[i], col, pv, pi) && better(v[i], col, bv, bi)) {
          bv = v[i];
          bi = col;
        }
      }
      warp_best(bv, bi);
      if (lane == 0) {
        part_val[base * k + j] = bv;
        part_idx[base * k + j] = bi == 0x7fffffff ? -1 : n0 + bi;
      }
      pv = bv;
      pi = bi;
    }
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
head_merge_kernel(const float* __restrict__ part_val,
                  const int* __restrict__ part_idx,
                  const float* __restrict__ part_m,
                  const float* __restrict__ part_s, float* __restrict__ logp,
                  int* __restrict__ tok, int nblk, int k) {
  __shared__ float sm_a[MERGE_THREADS];
  __shared__ float sm_b[MERGE_THREADS];
  __shared__ int sm_i[MERGE_THREADS];
  const int t = blockIdx.x, tid = threadIdx.x;

  // logsumexp over the blocks' (max, sum exp) pairs, in a fixed order
  float m = -CUDART_INF_F, s = 0.f;
  for (int b = tid; b < nblk; b += MERGE_THREADS) {
    const float pm = part_m[(size_t)t * nblk + b];
    const float ps = part_s[(size_t)t * nblk + b];
    if (pm > m) {
      s = s * expf(m - pm) + ps;
      m = pm;
    } else {
      s += ps * expf(pm - m);
    }
  }
  sm_a[tid] = m;
  sm_b[tid] = s;
  __syncthreads();
  for (int w = MERGE_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w) {
      const float m1 = sm_a[tid], s1 = sm_b[tid];
      const float m2 = sm_a[tid + w], s2 = sm_b[tid + w];
      const float mm = fmaxf(m1, m2);
      const float e1 = s1 == 0.f ? 0.f : s1 * expf(m1 - mm);
      const float e2 = s2 == 0.f ? 0.f : s2 * expf(m2 - mm);
      sm_a[tid] = mm;
      sm_b[tid] = e1 + e2;
    }
    __syncthreads();
  }
  const float lse = sm_a[0] + logf(sm_b[0]);
  __syncthreads();

  const int n = nblk * k;
  const float* pv_row = part_val + (size_t)t * n;
  const int* pi_row = part_idx + (size_t)t * n;
  float pv = CUDART_INF_F;
  int pi = -1;
  for (int j = 0; j < k; ++j) {
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int c = tid; c < n; c += MERGE_THREADS) {
      const float v = pv_row[c];
      const int i = pi_row[c];
      if (i >= 0 && after(v, i, pv, pi) && better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    sm_a[tid] = bv;
    sm_i[tid] = bi;
    __syncthreads();
    for (int w = MERGE_THREADS / 2; w > 0; w >>= 1) {
      if (tid < w && better(sm_a[tid + w], sm_i[tid + w], sm_a[tid],
                            sm_i[tid])) {
        sm_a[tid] = sm_a[tid + w];
        sm_i[tid] = sm_i[tid + w];
      }
      __syncthreads();
    }
    pv = sm_a[0];
    pi = sm_i[0];
    if (tid == 0) {
      logp[(size_t)t * k + j] = pv - lse;
      tok[(size_t)t * k + j] = pi;
    }
    __syncthreads();
  }
}

}  // namespace

// The earlier kernels: x (T, H) bf16, q (H, V) int8, scale (V,) f32;
// scratch part_val/part_idx (T, V/128, k), part_m/part_s (T, V/128); out logp
// (T, k) f32, tok (T, k) int32. Needs H % 64 == 0, V % 128 == 0,
// 1 <= k <= 128, 16-byte aligned x and q (the Python wrapper checks).
// Returns cudaGetLastError().
extern "C" int head_topk_strip(const void* x, const void* q,
                               const void* scale, void* part_val,
                               void* part_idx, void* part_m, void* part_s,
                               void* logp, void* tok, int T, int H, int V,
                               int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = V / BNH;
  head_partial_kernel<<<dim3(nblk, (T + 15) / 16), 128, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(part_val),
      static_cast<int*>(part_idx), static_cast<float*>(part_m),
      static_cast<float*>(part_s), T, H, V, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  head_merge_kernel<<<T, MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(part_val), static_cast<const int*>(part_idx),
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<float*>(logp), static_cast<int*>(tok), nblk, k);
  return static_cast<int>(cudaGetLastError());
}

// x (T, H) bf16, q (H, V) int8, scale (V,) f32 by the plan (n, stages) of
// `ops/head_topk.py head_plan`; scratch part_key (T, k, V/128) u64, part_m /
// part_s (T, V/128) f32; out logp (T, k) f32, tok (T, k) int32. Needs H % 64
// == 0, V % 128 == 0, 1 <= k <= 128, (n, stages) one of (16, 6) and (64, 6),
// 16-byte aligned x, q and scale (the Python wrapper checks). Returns the
// first CUDA error of the two launches, or cudaErrorInvalidValue for what
// the kernel does not take.
extern "C" int head_topk(const void* x, const void* q, const void* scale,
                         void* part_key, void* part_m, void* part_s,
                         void* logp, void* tok, int T, int H, int V, int k,
                         int n, int stages, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || H < fs::BK || H % fs::BK || V % BNH || k < 1 || k > BNH ||
      k > V)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
  if (n == 16 && stages == 6)
    e = head_launch<16, 6>(x, q, scale, part_key, part_m, part_s, T, H, V, k,
                           st);
  else if (n == 64 && stages == 6)
    e = head_launch<64, 6>(x, q, scale, part_key, part_m, part_s, T, H, V, k,
                           st);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the merge's set-up overlaps the main grid's tail
  const size_t keys = (size_t)k * (V / BNH) * sizeof(unsigned long long);
  const bool staged = keys <= STAGE_BYTES;
  return static_cast<int>(fs::launch_dependent(
      head_select_kernel, dim3(T), dim3(MERGE_THREADS), staged ? keys : 0,
      st, static_cast<const unsigned long long*>(part_key),
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<float*>(logp), static_cast<int*>(tok), V / BNH, k,
      static_cast<int>(staged)));
}
