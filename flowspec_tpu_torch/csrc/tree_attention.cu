// Tree-masked GQA attention with an additive bias, for Hopper (sm_90a).
//
// Replaces the TPU kernel flowspec_tpu/ops/tree_attention.py:31 _attn_kernel
// (called from :65 tree_attention) and also covers the XLA length-aware
// path flowspec_tpu/models/llama.py:128 _attention_blocked. Computes
// O = softmax(Q K^T * D^-1/2 + bias) V for q (nkv*G*T, D) grouped per KV
// head (G = nq / nkv query heads share one KV head; row r of a group is
// query head r / T at position r % T), k/v (nkv, S, D) bf16, bias (T, S)
// f32 -> O bf16 in q's layout, for each of `lanes` independent lanes
// (requests served together) stacked in front: q (lanes, nkv*G*T, D), k/v
// (lanes, nkv, S, D), bias (lanes, T, S), one live-row count a lane. The
// lane is folded into grid z (z = lane * nkv + head), so a lane's rows are
// computed by the same blocks, splits and order as a one-lane launch.
//
// Numerics follow the Pallas kernel: f32 scores (scale, then bias), online
// softmax (m, l, acc) with P rounded to bf16 before the PV product and l
// summed from the f32 P, f32 accumulation, acc / max(l, 1e-30) at the end.
//
// Live keys. The grid covers n_keys KV rows (a multiple of 64, at most S).
// Given a device pointer `n_valid` (the live rows, one int32 a lane, which
// the serving path keeps on the card so that a replayed CUDA graph sees
// this round's values), every block reads its lane's and works through the
// first
// ceil(n_valid / 64) 64-key tiles only (at least one, at most n_keys / 64);
// a split whose tiles all lie past them is empty. Given a null pointer, all
// n_keys rows are live (the caller sized the grid to them). Under the
// caller's contract (ops/tree_attention.py) every column at or past n_valid
// carries a -1e9 bias, so exp() of it underflows to exactly 0 beside any
// live column, and the rows skipped would have added exactly nothing. A row
// with no live column at all is garbage that callers discard, as on every
// path of the JAX package.
//
// Bound on the H100: bytes. The shapes of a speculative round are T = 1-96
// query rows per head over 64-512 live keys; a 7B verify layer reads 2 x 32
// heads x 256 rows x 128 x 2 B = 4.2 MB of K and V (1.3 us at 3.35 TB/s) and
// does 0.68 GFLOP (0.7 us at the bf16 tensor-core rate). Nothing of that
// size fills the card by itself, so what decides the time is how many SMs
// have work and how long one block's chain of latencies is.
//
// Design (`tree_attention`):
//  - Tensor cores through mma.sync.m16n8k16 (bf16 -> f32). Each warp owns
//    16 query rows of one KV head. S = Q K^T reads Q and K with ldmatrix;
//    the S accumulator, scaled, biased, exponentiated and rounded to bf16,
//    is PV's A fragment as it stands in the registers (the m16n8 C layout
//    of two adjacent n-tiles is the m16k16 A layout), so P never goes
//    through shared memory; V is read with ldmatrix.trans. Rows are padded
//    by 8 bf16 so the 8 rows of every ldmatrix phase fall in 8 different
//    bank groups. `wgmma` is not used: it takes 64-row tiles, which a T = 1
//    or T = 10 call would fill to 2-16 %, and the whole product is ~1 us
//    even at mma.sync's rate.
//  - Key splits that fill the card. Grid = (key split) x (row tile) x (KV
//    head); a split is a run of 64-key tiles (one tile up to 512 keys), so
//    a 7B verify call runs 4 splits x 2 row tiles x 32 heads = 256 blocks
//    instead of the 96 of one block per (head, 32 rows) looping over every
//    key. Q, the tile's bias rows and K arrive by cp.async as one group and
//    V as a second, so the first device-memory round trip, the longest
//    step of a block, is paid once and the scores are computed while V
//    lands; a split of several tiles double-buffers them. Nothing is held
//    in registers across the wait, which keeps a thread under 170
//    registers: with Q and the bias in registers (254) only two 3-warp
//    blocks fitted an SM and a 7B verify call ran in two waves.
//  - The splits of one (head, row tile) are one thread-block cluster (at
//    most 8 blocks). Each block leaves its unnormalised (m, l, acc) in its
//    shared memory; after cluster.sync() every block reads its peers'
//    through distributed shared memory, combines them in ascending split
//    order and writes its own slice of the output rows, a warp two rows at
//    a time with every remote read of a step issued at once (one
//    distributed-shared-memory round trip a step). No second launch, no
//    f32 scratch in device memory, no atomics: equal bits on every launch.
//    (Pushing each partial to the block that owns its rows by remote 8-byte
//    stores instead, then joining locally, measured slower at every verify
//    shape.) A call of one split (a prefill chunk of 64 keys) writes its
//    rows directly, as acc / max(l, 1e-30), the join's arithmetic with one
//    partial, so the bits do not depend on the split count.
//  - An empty split (a device n_valid below the grid's keys) loads nothing,
//    still reaches both cluster barriers (an early return would deadlock
//    its cluster) and publishes the neutral partial: acc 0, l 0 and a
//    finite m (EMPTY_M), so the join's exp2((m - max) log2 e) is exactly 0
//    and never -inf - -inf. Adding its zeros leaves every sum unchanged:
//    the output equals that of the grid sized to the live tiles bit for
//    bit.
//  - exp(x - m) is computed as exp2(x log2(e) - m log2(e)), one MUFU op.
//  - The plan (warps a block, splits, tiles a split) comes from Python
//    (`ops/tree_attention.py attention_plan`), as `matmul_plan` does for
//    the dequant-matmuls.
//
// `tree_attention_simt` is the earlier kernel, kept for comparison only
// (nothing on the serving path calls it): one block per (KV head, 32 query
// rows) walking all n_keys in 32-key tiles with one synchronous load each,
// scores and PV on the CUDA cores in f32; it reads whole 256-row blocks.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---- the tensor-core kernel ------------------------------------------------

constexpr int KT = 64;          // keys per tile
constexpr int MAX_WARPS = 6;    // warps a block (16 query rows each)
constexpr int MAX_SPLITS = 8;   // blocks a cluster (the portable limit)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float EMPTY_M = -1e30f;  // m of an empty split: below any score

// Phase stamps, compiled in only with -DFS_ATTN_STAMPS (a separate build of
// tools/torch_attention_profile.py; the serving library has none): thread 0
// of every block writes %globaltimer at 8 points of the call into
// g_stamps[block * 8 + i]: 0 start, 1 K (and Q, bias) landed, 2 scores done,
// 3 V landed, 4 all tiles done, 5 after the first cluster barrier, 6 joined,
// 7 end (5-7 stay 0 for a call of one split).
#ifdef FS_ATTN_STAMPS
__device__ unsigned long long* g_stamps = nullptr;
#define FS_STAMP(i)                                                      \
  do {                                                                   \
    if (threadIdx.x == 0 && g_stamps != nullptr) {                       \
      unsigned long long t_;                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));            \
      g_stamps[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +      \
                blockIdx.x) * 8 + (i)] = t_;                             \
    }                                                                    \
  } while (0)
#else
#define FS_STAMP(i) \
  do {              \
  } while (0)
#endif

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
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

// Shared memory of one block (dynamic, `warps` = W, R = 16 W query rows):
// `stages` ring slots, each a K and a V tile of KT rows padded to D + 8 and
// the tile's bias rows (R x BP f32, padded so the 8 rows of a fragment fall
// in different banks), then the block's Q rows (R x (D + 8) bf16). The
// combine step reuses slot 0's K and V for the f32 acc (R x (D + 8)).
constexpr int BP = KT + 8;
template <int D>
__host__ __device__ constexpr int stage_bytes(int warps) {
  return 2 * KT * (D + 8) * 2 + 16 * warps * BP * 4;
}
template <int D>
__host__ __device__ constexpr int smem_bytes(int warps, int stages) {
  return stages * stage_bytes<D>(warps) + 16 * warps * (D + 8) * 2;
}

// 16-byte copy, zero-filled (nothing read) when !pred
__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem,
                                            bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

// Requires D in {64, 128}, n_keys % KT == 0, n_keys <= S, 16-byte aligned
// q/k/v/bias/out, S % 4 == 0, blockDim.x == 32 * warps (warps <=
// MAX_WARPS), gridDim = (splits, ceil(G*T / (16 * warps)), lanes * nkv)
// launched as
// clusters of (splits, 1, 1), splits <= MAX_SPLITS, every split non-empty
// at n_keys: (splits - 1) * tps < n_keys / KT <= splits * tps, and
// smem_bytes<D>(warps, tps > 1 ? 2 : 1) of dynamic shared memory. `n_valid`
// (device, one a lane, may be null) cuts the live tiles, emptying the last
// splits.
template <int D>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
tree_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ bias,
                          const int* __restrict__ n_valid,
                          __nv_bfloat16* __restrict__ out, int nkv, int G,
                          int T, int S, int n_keys, int tps, float scale) {
  constexpr int DP = D + 8;     // bf16 row stride of a K / V / Q tile
  constexpr int DA = D + 8;     // f32 row stride of the combine area
  constexpr int KS = D / 16;    // k16 steps of QK^T
  constexpr int ND = D / 8;     // n8 tiles of the output
  extern __shared__ __align__(16) uint8_t attn_smem[];
  __shared__ float sm_m[MAX_WARPS * 16], sm_l[MAX_WARPS * 16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int R = nthreads / 2;                       // 16 rows a warp
  const int split = blockIdx.x, splits = gridDim.x;
  // h: the (lane, KV head) pair; q, k, v and out are contiguous over it
  const int h = blockIdx.z, lane_id = blockIdx.z / nkv;
  const int rows = G * T;
  const int r0 = blockIdx.y * R;
  const bool live = r0 + warp * 16 < rows;
  const int n_tiles =
      n_valid == nullptr
          ? n_keys / KT
          : min(n_keys / KT, max(1, (n_valid[lane_id] + KT - 1) / KT));
  bias += (size_t)lane_id * T * S;
  const int t_begin = split * tps;
  const int nt = min(t_begin + tps, n_tiles) - t_begin;
  const int sbytes = stage_bytes<D>(nwarps);
  FS_STAMP(0);

  const __nv_bfloat16* qh = q + (size_t)h * rows * D;
  const __nv_bfloat16* kh = k + (size_t)h * S * D;
  const __nv_bfloat16* vh = v + (size_t)h * S * D;
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(
      attn_smem + (nt > 1 ? 2 : 1) * sbytes);

  // Tile `it` of this split into ring slot `slot` as two cp.async groups:
  // K with the tile's bias rows (and, for the first tile, the block's Q
  // rows), then V. Rows past the KV head's G*T are zero-filled.
  auto load = [&](int it, int slot) {
    const int key0 = (t_begin + it) * KT;
    uint8_t* base = attn_smem + slot * sbytes;
    __nv_bfloat16* dk = reinterpret_cast<__nv_bfloat16*>(base);
    __nv_bfloat16* dv = dk + KT * DP;
    float* db = reinterpret_cast<float*>(dv + KT * DP);
    for (int i = tid; i < KT * D / 8; i += nthreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      cp_async16(dk + r * DP + c, kh + (size_t)(key0 + r) * D + c);
    }
    for (int i = tid; i < R * KT / 4; i += nthreads) {
      const int r = i / (KT / 4), c = (i % (KT / 4)) * 4;
      const bool ok = r0 + r < rows;
      cp_async16z(db + r * BP + c,
                  bias + (size_t)(ok ? (r0 + r) % T : 0) * S + key0 + c, ok);
    }
    if (it == 0)
      for (int i = tid; i < R * D / 8; i += nthreads) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        const bool ok = r0 + r < rows;
        cp_async16z(sq + r * DP + c, qh + (size_t)(ok ? r0 + r : 0) * D + c,
                    ok);
      }
    cp_async_commit();
    for (int i = tid; i < KT * D / 8; i += nthreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      cp_async16(dv + r * DP + c, vh + (size_t)(key0 + r) * D + c);
    }
    cp_async_commit();
  };
  if (nt > 0) load(0, 0);

  // ldmatrix addresses. Q as A fragments (matrix i: rows 8(i&1).., k
  // 8(i>>1).. of a k16 step); K as B fragments of two k16 steps (matrix i:
  // keys of n-tile j, d 8i.. of 32); V, transposed, as B fragments of two
  // n8 tiles (matrix i: keys 8(i&1).., d 8(i>>1)..)
  const __nv_bfloat16* qp =
      sq + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * DP +
      8 * (lane >> 4);
  const int koff = (lane & 7) * DP + 8 * (lane >> 3);
  const int voff = ((lane & 7) + 8 * ((lane >> 3) & 1)) * DP + 8 * (lane >> 4);
  // this thread's two rows of the warp's 16: g (a) and g + 8 (b)
  const int la = warp * 16 + g, lb = la + 8;

  float m_a = -CUDART_INF_F, m_b = -CUDART_INF_F, l_a = 0.f, l_b = 0.f;
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < nt; ++it) {
    const int slot = it & 1;
    const bool more = it + 1 < nt;
    if (more) load(it + 1, slot ^ 1);
    if (more)
      cp_async_wait<3>();
    else
      cp_async_wait<1>();
    __syncthreads();                       // K, bias (and Q) have landed
    if (it == 0) FS_STAMP(1);
    const uint8_t* base = attn_smem + slot * sbytes;
    const __nv_bfloat16* tk = reinterpret_cast<const __nv_bfloat16*>(base);
    const __nv_bfloat16* tv = tk + KT * DP;
    const float* tb = reinterpret_cast<const float*>(tv + KT * DP);

    float s[KT / 8][4];
    if (live) {
      // S (16 x 64) = Q K^T, n8 tile j = keys 8j..8j+7: eight independent
      // accumulators a k16 step
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        uint32_t qa0[4], qa1[4];
        ldmatrix_x4(qa0, qp + 16 * kk);
        ldmatrix_x4(qa1, qp + 16 * (kk + 1));
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          uint32_t b[4];
          ldmatrix_x4(b, tk + koff + 8 * j * DP + 16 * kk);
          mma_bf16(s[j], qa0, b[0], b[1]);
          mma_bf16(s[j], qa1, b[2], b[3]);
        }
      }
    }
    if (it == 0) FS_STAMP(2);
    if (more)
      cp_async_wait<2>();
    else
      cp_async_wait<0>();
    __syncthreads();                       // V of tile `it` has landed
    if (it == 0) FS_STAMP(3);
    if (live) {
      float mx_a = -CUDART_INF_F, mx_b = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const float2 ba =
            *reinterpret_cast<const float2*>(tb + la * BP + 8 * j + 2 * t4);
        const float2 bb =
            *reinterpret_cast<const float2*>(tb + lb * BP + 8 * j + 2 * t4);
        s[j][0] = s[j][0] * scale + ba.x;
        s[j][1] = s[j][1] * scale + ba.y;
        s[j][2] = s[j][2] * scale + bb.x;
        s[j][3] = s[j][3] * scale + bb.y;
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int o2 = 1; o2 < 4; o2 <<= 1) {   // the row's 4 lanes
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2f((m_a - mn_a) * LOG2E);
      const float al_b = exp2f((m_b - mn_b) * LOG2E);
      const float ka = mn_a * LOG2E, kb = mn_b * LOG2E;
      m_a = mn_a;
      m_b = mn_b;
      float ps_a = 0.f, ps_b = 0.f;
      uint32_t pa[KT / 16][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const float p0 = exp2f(fmaf(s[j][0], LOG2E, -ka));
        const float p1 = exp2f(fmaf(s[j][1], LOG2E, -ka));
        const float p2 = exp2f(fmaf(s[j][2], LOG2E, -kb));
        const float p3 = exp2f(fmaf(s[j][3], LOG2E, -kb));
        ps_a += p0 + p1;
        ps_b += p2 + p3;
        // C layout of n-tiles 2kk, 2kk+1 == A layout of k16 step kk
        pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l_a = l_a * al_a + ps_a;
      l_b = l_b * al_b + ps_b;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][0] *= al_a;
        o[j][1] *= al_a;
        o[j][2] *= al_b;
        o[j][3] *= al_b;
      }
      // O (16 x D) += P (16 x 64) V (64 x D)
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
        for (int jd = 0; jd < ND; jd += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, tv + voff + 16 * kk * DP + 8 * jd);
          mma_bf16(o[jd], pa[kk], b[0], b[1]);
          mma_bf16(o[jd + 1], pa[kk], b[2], b[3]);
        }
      }
    }
    __syncthreads();                       // this slot may be refilled
  }

  FS_STAMP(4);
  if (nt <= 0) m_a = m_b = EMPTY_M;        // the neutral partial
  // l summed over the row's 4 lanes
#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  if (splits == 1) {                       // one split: the result itself
    const int ra = r0 + la, rb = r0 + lb;
    const float da = fmaxf(l_a, 1e-30f), db = fmaxf(l_b, 1e-30f);
    if (live) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int c = 8 * j + 2 * t4;
        if (ra < rows)
          *reinterpret_cast<uint32_t*>(out + ((size_t)h * rows + ra) * D + c) =
              pack_bf16(o[j][0] / da, o[j][1] / da);
        if (rb < rows)
          *reinterpret_cast<uint32_t*>(out + ((size_t)h * rows + rb) * D + c) =
              pack_bf16(o[j][2] / db, o[j][3] / db);
      }
    }
    return;
  }

  // The block's partial into shared memory: m, l and the unnormalised acc
  cg::cluster_group cluster = cg::this_cluster();
  float* sacc = reinterpret_cast<float*>(attn_smem);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<float2*>(sacc + la * DA + 8 * j + 2 * t4) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(sacc + lb * DA + 8 * j + 2 * t4) =
        make_float2(o[j][2], o[j][3]);
  }
  if (t4 == 0) {
    sm_m[la] = m_a;
    sm_l[la] = l_a;
    sm_m[lb] = m_b;
    sm_l[lb] = l_b;
  }
  cluster.sync();                          // every split's partial is there
  FS_STAMP(5);

  // Combine: this block writes rows [rlo, rhi) of its row tile, a warp two
  // rows at a time. Lane p < splits reads split p's (m, l); each lane reads
  // four adjacent values of both rows from every split, all in one round
  // trip, and adds the splits in ascending order.
  const int rlo = split * R / splits, rhi = (split + 1) * R / splits;
  const int c = 4 * lane;
  const float* pm = cluster.map_shared_rank(&sm_m[0], lane < splits ? lane : 0);
  const float* pl = cluster.map_shared_rank(&sm_l[0], lane < splits ? lane : 0);
  for (int row = rlo + warp; row < rhi && r0 + row < rows;
       row += 2 * nwarps) {
    const int row2 = row + nwarps;
    const bool two = row2 < rhi && r0 + row2 < rows;
    float ma = -CUDART_INF_F, mb = -CUDART_INF_F, lv_a = 0.f, lv_b = 0.f;
    if (lane < splits) {
      ma = pm[row];
      lv_a = pl[row];
      if (two) {
        mb = pm[row2];
        lv_b = pl[row2];
      }
    }
    float4 xa[MAX_SPLITS], xb[MAX_SPLITS];
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p)
      if (p < splits && c < D) {
        const float* pa = cluster.map_shared_rank(sacc, p);
        xa[p] = *reinterpret_cast<const float4*>(pa + row * DA + c);
        if (two) xb[p] = *reinterpret_cast<const float4*>(pa + row2 * DA + c);
      }
    float mxa = ma, mxb = mb;
#pragma unroll
    for (int o2 = 1; o2 < MAX_SPLITS; o2 <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, o2));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, o2));
    }
    const float wa = lane < splits ? exp2f((ma - mxa) * LOG2E) : 0.f;
    const float wb = lane < splits && two ? exp2f((mb - mxb) * LOG2E) : 0.f;
    float da = 0.f, db = 0.f;
    float4 aa = make_float4(0.f, 0.f, 0.f, 0.f), ab = aa;
#pragma unroll
    for (int p = 0; p < MAX_SPLITS; ++p)
      if (p < splits) {
        const float w1 = __shfl_sync(0xffffffffu, wa, p);
        const float w2 = __shfl_sync(0xffffffffu, wb, p);
        da += __shfl_sync(0xffffffffu, lv_a, p) * w1;
        db += __shfl_sync(0xffffffffu, lv_b, p) * w2;
        if (c < D) {
          aa.x += xa[p].x * w1;
          aa.y += xa[p].y * w1;
          aa.z += xa[p].z * w1;
          aa.w += xa[p].w * w1;
          if (two) {
            ab.x += xb[p].x * w2;
            ab.y += xb[p].y * w2;
            ab.z += xb[p].z * w2;
            ab.w += xb[p].w * w2;
          }
        }
      }
    if (c < D) {
      da = fmaxf(da, 1e-30f);
      uint2 pk;
      pk.x = pack_bf16(aa.x / da, aa.y / da);
      pk.y = pack_bf16(aa.z / da, aa.w / da);
      *reinterpret_cast<uint2*>(out + ((size_t)h * rows + r0 + row) * D + c) =
          pk;
      if (two) {
        db = fmaxf(db, 1e-30f);
        pk.x = pack_bf16(ab.x / db, ab.y / db);
        pk.y = pack_bf16(ab.z / db, ab.w / db);
        *reinterpret_cast<uint2*>(out + ((size_t)h * rows + r0 + row2) * D +
                                  c) = pk;
      }
    }
  }
  FS_STAMP(6);
  cluster.sync();                          // peers are done reading ours
  FS_STAMP(7);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* bias,
               const void* n_valid, void* out, int lanes, int nkv, int G,
               int T, int S,
               int n_keys, int warps,
               int splits, int tps, float scale, cudaStream_t st) {
  // dynamic shared memory above 48 KB is an opt-in per kernel and device,
  // made once for each (for the largest block)
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64 || !allowed[dev]) {
    e = cudaFuncSetAttribute(tree_attention_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<D>(MAX_WARPS, 2));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 0 && dev < 64) allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(splits, (G * T + 16 * warps - 1) / (16 * warps), lanes * nkv);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem_bytes<D>(warps, tps > 1 ? 2 : 1);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, tree_attention_mma_kernel<D>,
                         static_cast<const __nv_bfloat16*>(q),
                         static_cast<const __nv_bfloat16*>(k),
                         static_cast<const __nv_bfloat16*>(v),
                         static_cast<const float*>(bias),
                         static_cast<const int*>(n_valid),
                         static_cast<__nv_bfloat16*>(out), nkv, G, T, S,
                         n_keys, tps, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---- the earlier kernel (comparison only) ----------------------------------

constexpr int SKT = 32;         // keys per tile: one per lane
constexpr int RW = 4;           // query rows per warp
constexpr int SWARPS = 8;
constexpr int RB = SWARPS * RW; // query rows per block

template <int D>
__global__ void __launch_bounds__(SWARPS * 32)
tree_attention_simt_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int G, int T,
                           int S, int n_keys, float scale) {
  constexpr int DP = D + 2;     // padded K row: lane j reads bank (j + d) % 32
  constexpr int DL = D / 32;    // output dims per lane
  __shared__ __align__(16) __nv_bfloat16 ks[SKT][DP];
  __shared__ __align__(16) __nv_bfloat16 vs[SKT][D];
  __shared__ __align__(16) float qs[RB][D];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x;
  const int rows = G * T;
  const int r0 = blockIdx.y * RB;
  const __nv_bfloat16* qh = q + (size_t)h * rows * D;
  const __nv_bfloat16* kh = k + (size_t)h * S * D;
  const __nv_bfloat16* vh = v + (size_t)h * S * D;

  for (int i = tid; i < RB * D; i += SWARPS * 32) {
    const int r = i / D, c = i % D;
    qs[r][c] = r0 + r < rows ? __bfloat162float(qh[(size_t)(r0 + r) * D + c])
                             : 0.f;
  }

  float m[RW], l[RW], acc[RW][DL];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    m[rr] = -CUDART_INF_F;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < DL; ++c) acc[rr][c] = 0.f;
  }

  for (int s0 = 0; s0 < n_keys; s0 += SKT) {
    __syncthreads();   // previous tile consumed (first pass: q staged)
    for (int i = tid; i < SKT * D / 8; i += SWARPS * 32) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const uint4 kv = *reinterpret_cast<const uint4*>(
          kh + (size_t)(s0 + r) * D + c);
      uint32_t* kd = reinterpret_cast<uint32_t*>(&ks[r][c]);
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      *reinterpret_cast<uint4*>(&vs[r][c]) = *reinterpret_cast<const uint4*>(
          vh + (size_t)(s0 + r) * D + c);
    }
    __syncthreads();

    // scores of this lane's key for the warp's rows
    float sc[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) sc[rr] = 0.f;
    const __nv_bfloat162* krow =
        reinterpret_cast<const __nv_bfloat162*>(&ks[lane][0]);
#pragma unroll 8
    for (int d2 = 0; d2 < D / 2; ++d2) {
      const float2 kf = __bfloat1622float2(krow[d2]);
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        const float2 qf =
            *reinterpret_cast<const float2*>(&qs[warp * RW + rr][2 * d2]);
        sc[rr] = fmaf(qf.x, kf.x, sc[rr]);
        sc[rr] = fmaf(qf.y, kf.y, sc[rr]);
      }
    }

    const int key = s0 + lane;
    float pb[RW];
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = r0 + warp * RW + rr;
      const float s =
          sc[rr] * scale + (r < rows ? bias[(size_t)(r % T) * S + key] : 0.f);
      float tmax = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m[rr], tmax);
      const float p = expf(s - m_new);
      const float alpha = m[rr] == -CUDART_INF_F ? 0.f : expf(m[rr] - m_new);
      float psum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[rr] = l[rr] * alpha + psum;
      m[rr] = m_new;
      pb[rr] = __bfloat162float(__float2bfloat16(p));
#pragma unroll
      for (int c = 0; c < DL; ++c) acc[rr][c] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < SKT; ++j) {
      float vf[DL];
#pragma unroll
      for (int c = 0; c < DL; ++c)
        vf[c] = __bfloat162float(vs[j][lane * DL + c]);
#pragma unroll
      for (int rr = 0; rr < RW; ++rr) {
        const float pj = __shfl_sync(0xffffffffu, pb[rr], j);
#pragma unroll
        for (int c = 0; c < DL; ++c) acc[rr][c] = fmaf(pj, vf[c], acc[rr][c]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = r0 + warp * RW + rr;
    if (r >= rows) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    __nv_bfloat16* o = out + ((size_t)h * rows + r) * D + lane * DL;
#pragma unroll
    for (int c = 0; c < DL; ++c) o[c] = __float2bfloat16(acc[rr][c] / den);
  }
}

}  // namespace

#ifdef FS_ATTN_STAMPS
// Where the stamps go (null: none); the stamped build only.
extern "C" int tree_attention_set_stamps(void* buf) {
  unsigned long long* p = static_cast<unsigned long long*>(buf);
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
#endif

// q (lanes, nkv*G*T, D), k/v (lanes, nkv, S, D) bf16, bias (lanes, T, S)
// f32 -> out like q, by the plan (warps, splits, tiles_per_split) of
// `ops/tree_attention.py attention_plan` for a grid of n_keys keys; n_valid
// (lanes device int32s, or null for n_keys) the live rows of each lane.
// Needs lanes * nkv <= 65535, D in {64, 128}, n_keys % 64 == 0,
// n_keys <= S, S % 4 == 0 and 16-byte aligned q/k/v/bias/out (the Python
// wrapper checks). Returns the first CUDA error, or cudaErrorInvalidValue
// for a plan the kernel does not take.
extern "C" int tree_attention(const void* q, const void* k, const void* v,
                              const void* bias, const void* n_valid,
                              void* out, int lanes, int nkv, int G,
                              int T, int S, int D, int n_keys, int warps,
                              int splits, int tiles_per_split, float scale,
                              void* stream) {
  const int n_tiles = n_keys / KT;
  if (lanes < 1 || nkv < 1 || (long long)lanes * nkv > 65535 || G < 1 ||
      T < 1 || n_keys < KT || n_keys % KT ||
      n_keys > S || warps < 1 || warps > MAX_WARPS || splits < 1 ||
      splits > MAX_SPLITS || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split < n_tiles ||
      (long long)(splits - 1) * tiles_per_split >= n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch_mma<128>(q, k, v, bias, n_valid, out, lanes, nkv, G, T, S,
                           n_keys, warps, splits, tiles_per_split, scale, st);
  if (D == 64)
    return launch_mma<64>(q, k, v, bias, n_valid, out, lanes, nkv, G, T, S,
                          n_keys, warps, splits, tiles_per_split, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The earlier kernel: the operands of one lane, no plan. Needs D in {64, 128},
// n_keys % 32 == 0, n_keys <= S, 16-byte aligned q/k/v. Returns
// cudaGetLastError().
extern "C" int tree_attention_simt(const void* q, const void* k,
                                   const void* v, const void* bias, void* out,
                                   int nkv, int G, int T, int S, int D,
                                   int n_keys, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(nkv, (G * T + RB - 1) / RB);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (D == 128)
    tree_attention_simt_kernel<128><<<grid, SWARPS * 32, 0, st>>>(
        qp, kp, vp, bp, op, G, T, S, n_keys, scale);
  else if (D == 64)
    tree_attention_simt_kernel<64><<<grid, SWARPS * 32, 0, st>>>(
        qp, kp, vp, bp, op, G, T, S, n_keys, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
