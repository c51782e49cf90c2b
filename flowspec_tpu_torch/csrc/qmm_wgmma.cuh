// Skeleton of the weight-only dequant-matmuls redesigned for Hopper
// (int8_matmul.cu, nf4_matmul.cu, int4_matmul.cu, int4_matmul_smallm.cu) and
// of the fused head top-k (head_topk.cu): the whole card on every product,
// a deep cp.async ring in dynamic shared memory, and warpgroup tensor-core
// products (`wgmma`) on the transposed problem with the weight as the
// register operand.
//
//   y[m][n] = sum over the 64-row blocks k of x[m][k] * w[k][n]
//
// The cut. The product's iterations, (row tile of N rows, strip of bn <= 128
// columns, 64-row block of In) with the 64-row block fastest, are shared by
// at most two blocks an SM in ranges that differ by at most one 64-row
// block. With at least as many tiles as SMs the cut is stream-K: contiguous
// ranges over the whole product, so every SM streams an equal share of the
// weight bytes whatever the number of tiles, and a tile split across blocks
// is finished inside the same kernel by the block holding its last 64-row
// block. With fewer tiles every tile is split into the same number of
// segments, one a block, and the tile's blocks are one thread-block cluster
// that adds the segments in shared memory (see `qmm_kernel`). A block is one
// warpgroup (128 threads). The plan (bn, N, grid, split, stages) comes from
// the Python side (`ops/quant_matmul.py matmul_plan`); nothing of it is
// re-derived here.
//
// The transposed product. `wgmma` multiplies a 64-row A by a B of N columns,
// N any multiple of 8. Taking A = w^T (64 output columns x 16 k) and
// B = x^T (16 k x N rows of x) makes the row count of x the free dimension,
// so 81 rows cost 96 and one row costs 16, and puts the weight where `wgmma`
// accepts registers: int8 -> bf16 (exact), or packed byte -> two codes
// -> one bf16 multiply by the block scale (the operand of `decode_pair` in
// packed4_mma.cuh, bit for bit; nf4 looks the pair up in a table, int4 builds
// it with integer ops, `i4_pair_bf16`), happens in registers and goes straight
// to the tensor cores. x is the shared-memory operand: a tile is N rows of 64 k
// (128 bytes), which is x's own row-major order ("K-major"), stored with the
// 128-byte swizzle the descriptor names.
//
// Which output column a row of A stands for is free, and is chosen so that a
// thread fetches its weights as whole 32-bit words: a warpgroup owns 128
// columns as two m64 tiles, warp w the 32 columns [32w, 32w+32), and lane
// (g = lane/4, t4 = lane%4) the four adjacent columns 32w+4g+{0,1,2,3}:
//   tile 0, A rows 16w+g and 16w+g+8  <->  columns 32w+4g+0 and +1
//   tile 1, A rows 16w+g and 16w+g+8  <->  columns 32w+4g+2 and +3
// One word of a weight row is then the four columns of one lane. Rows are
// swizzled in 32-byte units by the two bits of the row index that equal t4,
// so the four t4 groups of a warp read four different bank groups: no
// single-byte loads and no bank conflicts in the inner loop.
//
// The ring. Every thread issues 16-byte cp.async copies (x tile, weight tile,
// scale row) into a ring of STAGES slots in dynamic shared memory, STAGES - 1
// blocks ahead; each thread copies the same column of every tile, so a copy
// costs one add. Each width has one ring, the deepest of which two blocks fit
// an SM. cp.async rather than TMA: a tensor map encoded wrongly leaves a thread
// spinning on an mbarrier for ever, while a cp.async ring can only be wrong,
// not hang; the depth, which is what the memory system sees, is the same.
//
// The loop is software-pipelined over two register sets: while the tensor
// cores work on block kc (one wgmma group of 8 products), the warps wait for
// block kc+1, refill the slot of block kc-1 and decode block kc+1. One
// barrier a block.
//
// Sums. f32 throughout; a tile's k segments are added in ascending order
// (the earlier segments' f32 sums, then the last one's), the int8
// per-column scale is applied and the result cast once: no atomics on the
// data, equal bits on every launch. The stream-K hand-over is one flag a
// block in a buffer the caller keeps per device, set with release, taken
// with acquire and cleared by the finishing block, so every launch, eager or
// replayed in a graph, finds the flags zero and no memset runs; the split
// cut needs no flags (cluster barriers).
//
// The main loop (`qmm_mainloop`) is a device function of its own, so that a
// kernel with another epilogue runs the same loop: `qmm_kernel` writes the
// product, head_topk.cu's kernel the per-strip softmax partials and top-k.
#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed4_mma.cuh"

namespace fs {

constexpr int QMM_INT8 = 0, QMM_NF4 = 1, QMM_INT4 = 2;

// shared-memory bytes of one ring stage and of a block (the Python plan
// computes the same figures to choose `stages`)
template <int FMT>
struct QmmTile {
  static constexpr int W_ROWS = FMT == QMM_INT8 ? BK : PK;   // 128-byte rows
  static constexpr int W_BYTES = W_ROWS * 128;
  static constexpr int S_BYTES = FMT == QMM_INT8 ? 0 : 512;  // one scale row
  // nf4: 256 decoded byte pairs x 8 copies (see the kernel's `lut`)
  static constexpr int LUT_BYTES = FMT == QMM_NF4 ? 256 * 8 * 4 : 0;
  __host__ __device__ static constexpr int stage_bytes(int n) {
    return n * 128 + W_BYTES + S_BYTES;
  }
  // + 1024 to align the first x tile
  __host__ __device__ static constexpr int smem_bytes(int n, int stages) {
    return stages * stage_bytes(n) + LUT_BYTES + 1024;
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {   // at most N groups pending
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async writes go through the generic proxy, wgmma reads shared memory
// through the async proxy: order the two before the block-wide barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a K-major bf16 operand tile of 128-byte rows with the
// 128-byte swizzle: 8-row groups 1024 bytes apart; the tile is 1024-byte
// aligned. A k16 step inside the row adds 32 bytes (2 encoded units).
__device__ __forceinline__ uint64_t x_tile_desc(const void* smem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

#define FS_D8(o)                                                       \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define FS_WGMMA_TAIL                                                  \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc)

// d (64 x N, f32, N/2 registers a thread) = a (64 x 16 bf16 from registers)
// * b (16 x N bf16 from shared memory, K-major) + (acc ? d : 0)
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : FS_D8(0)
        : FS_WGMMA_TAIL);
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : FS_D8(0), FS_D8(8), FS_D8(16), FS_D8(24)
        : FS_WGMMA_TAIL);
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : FS_D8(0), FS_D8(8), FS_D8(16), FS_D8(24), FS_D8(32), FS_D8(40)
        : FS_WGMMA_TAIL);
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : FS_D8(0), FS_D8(8), FS_D8(16), FS_D8(24), FS_D8(32), FS_D8(40),
          FS_D8(48), FS_D8(56)
        : FS_WGMMA_TAIL);
  }
};

#undef FS_D8
#undef FS_WGMMA_TAIL

// Byte j of `lo` and of `hi` (int8 weights of one column at rows k and k+1,
// each already xor 0x80, i.e. v + 128 as an unsigned byte) -> bf16x2, row k
// in the low half. The byte lands in the mantissa of 2^23, the float is
// 2^23 + v + 128, and subtracting 2^23 + 128 leaves v exactly; |v| <= 127
// is exact in bf16, so the operand equals `bf16(q)` of the plain version.
template <int J>
__device__ __forceinline__ uint32_t i8_pair_bf16(uint32_t lo, uint32_t hi) {
  const float a =
      __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 | J)) - 8388736.f;
  const float b =
      __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 | J)) - 8388736.f;
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte j of `w` (an int4 pair: high nibble row k, low nibble row k+1) times
// the column's bf16 block scale s2 -> bf16x2, row k in the low half: the
// operand of `decode_pair<false>` bit for bit, without its two int -> bf16
// conversions. One prmt puts the high nibble (from w >> 4) in the low half
// and the low nibble in the high half; the mask keeps the two nibbles n and
// the or makes each half the bf16 value 128 + n (0x4300 | n: exponent 2^7,
// mantissa step 1). Subtracting (136, 136) leaves n - 8 exactly, and one
// `__hmul2` by the scale rounds once, as `decode_pair` does.
__device__ __forceinline__ uint32_t i4_pair_bf16(uint32_t w, int j,
                                                 __nv_bfloat162 s2) {
  const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
  const uint32_t p = (__byte_perm(w >> 4, w, sel) & 0x000F000Fu) | 0x43004300u;
  const uint32_t c136 = 0x43084308u;
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p),
                             *reinterpret_cast<const __nv_bfloat162*>(&c136));
  v = __hmul2(v, s2);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The first 1024-byte aligned byte of a kernel's dynamic shared memory (the
// x tiles need it); pointers stay derived from the shared array so that loads
// compile to shared-memory loads.
__device__ __forceinline__ uint8_t* smem_align1024(uint8_t* raw) {
  return raw + ((1024u - (static_cast<uint32_t>(__cvta_generic_to_shared(raw)) &
                          1023u)) & 1023u);
}

// The main loop of every kernel on this skeleton: acc = the block's f32 sum
// over the 64-row blocks [kb0, kb0 + nk) of x rows [m0, m0 + N) times the
// weight columns [n0, n0 + bn), in the transposed layout the epilogues read
// (register 4c+i of tile t: x row 8c + 2*t4 + (i&1), column
// 32w + 4g + 2t + (i>>1)). Rows past M read as zeros. FMT: QMM_INT8 (q (In,
// Out) int8, its per-column scale left to the caller), QMM_NF4 / QMM_INT4 (q
// (In/2, Out) packed, scale (In/64, Out) folded into the operand). N: rows of
// x a block covers (the wgmma width). STAGES: ring slots at `sx` (1024-byte
// aligned, QmmTile<FMT>::smem_bytes(N, STAGES) - 1024 bytes); STAGES - 2
// blocks are in flight behind the one being decoded. Needs nk >= 1, In % 64
// == 0, bn in {32, 64, 128}, 16-byte aligned x, q and scale, and
// blockDim.x == 128. On return every copy and product has ended; the ring is
// free once the block has passed a barrier.
template <int FMT, int N, int STAGES>
__device__ __forceinline__ void qmm_mainloop(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
    const float* __restrict__ scale, const __nv_bfloat16* __restrict__ code,
    uint8_t* sx, int M, int In, int Out, int bn, int n0, int m0, int kb0,
    int nk, float (&acc)[2][N / 2]) {
  using T = QmmTile<FMT>;
  uint8_t* sw = sx + STAGES * (N * 128);
  uint8_t* ss = sw + STAGES * T::W_BYTES;
  uint32_t* lut = reinterpret_cast<uint32_t*>(ss + STAGES * T::S_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // A thread copies the same 16-byte column (lc) of rows lr, lr+16, ... of
  // every tile, so sources and destinations are one base plus a constant
  // step; the swizzle keys depend on the row only through lr.
  const int lr = tid >> 3, lc = tid & 7;
  const int wkey = FMT == QMM_INT8 ? ((lr >> 1) & 3) : (lr & 3);
  const int xdst = lr * 128 + ((lc ^ (lr & 7)) << 4);
  const int wdst = lr * 128 + ((lc ^ (wkey << 1)) << 4);
  const bool wok = lc * 16 < bn;
  const __nv_bfloat16* xsrc = x + (size_t)(m0 + lr) * In + lc * 8;
  const uint8_t* wsrc = q + (size_t)lr * Out + n0 + (wok ? lc * 16 : 0);
  const size_t xstep = (size_t)16 * In, wstep = (size_t)16 * Out;
  const bool sok = tid * 4 < bn;
  const float* ssrc = scale + n0 + (sok ? tid * 4 : 0);

  auto load = [&](int slot, int kb) {
    uint8_t* dx = sx + slot * (N * 128) + xdst;
    const __nv_bfloat16* xs = xsrc + kb * BK;
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      const bool ok = m0 + lr + 16 * j < M;
      cp_async16(dx + j * 2048, ok ? xs + j * xstep : x, ok);
    }
    uint8_t* dw = sw + slot * T::W_BYTES + wdst;
    const uint8_t* ws = wsrc + (size_t)kb * T::W_ROWS * Out;
#pragma unroll
    for (int j = 0; j < T::W_ROWS / 16; ++j)
      cp_async16(dw + j * 2048, ws + j * wstep, wok);
    if (FMT != QMM_INT8 && tid < 32)
      cp_async16(ss + slot * T::S_BYTES + tid * 16, ssrc + (size_t)kb * Out,
                 sok);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, kb0 + s);
    cp_async_commit();
  }
  // a dependent pass (head_topk.cu's merge) may be set up while this grid
  // runs; it waits for the whole grid before it reads a partial
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // nf4: both codes of a packed byte in one lookup. lut[b][r] holds
  // bf16x2(code[b >> 4], code[b & 15]) for r = 0..7; a lane reads copy
  // lane % 8, which spreads a warp's 32 lookups over the banks where 256
  // single entries would collide. Word tid + 128 j is byte (tid >> 3) + 16 j,
  // i.e. high nibble j, low nibble tid >> 3.
  if constexpr (FMT == QMM_NF4) {
    const __nv_bfloat16 lo = code[tid >> 3];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      __nv_bfloat162 v = __halves2bfloat162(code[j], lo);
      lut[tid + 128 * j] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
  const uint32_t* lutl = lut + (lane & 7);

  // this lane's word inside a weight row: 32-byte unit (warp ^ t4), word g
  const int wcol = ((warp ^ t4) << 5) + (g << 2);

  // the block of ring slot `slot` as wgmma A registers: [k16 step][m64
  // tile][register]
  auto decode = [&](int slot, uint32_t (&a)[4][2][4]) {
    const uint8_t* wt = sw + slot * T::W_BYTES + wcol;
    if constexpr (FMT == QMM_INT8) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint8_t* wk = wt + (16 * s + 2 * t4) * 128;
        const uint32_t u0 =
            *reinterpret_cast<const uint32_t*>(wk) ^ 0x80808080u;
        const uint32_t u1 =
            *reinterpret_cast<const uint32_t*>(wk + 128) ^ 0x80808080u;
        const uint32_t u8 =
            *reinterpret_cast<const uint32_t*>(wk + 8 * 128) ^ 0x80808080u;
        const uint32_t u9 =
            *reinterpret_cast<const uint32_t*>(wk + 9 * 128) ^ 0x80808080u;
        a[s][0][0] = i8_pair_bf16<0>(u0, u1);
        a[s][0][1] = i8_pair_bf16<1>(u0, u1);
        a[s][0][2] = i8_pair_bf16<0>(u8, u9);
        a[s][0][3] = i8_pair_bf16<1>(u8, u9);
        a[s][1][0] = i8_pair_bf16<2>(u0, u1);
        a[s][1][1] = i8_pair_bf16<3>(u0, u1);
        a[s][1][2] = i8_pair_bf16<2>(u8, u9);
        a[s][1][3] = i8_pair_bf16<3>(u8, u9);
      }
    } else {
      const float4 sf = *reinterpret_cast<const float4*>(
          ss + slot * T::S_BYTES + (warp * 32 + g * 4) * 4);
      const float sc[4] = {sf.x, sf.y, sf.z, sf.w};
      __nv_bfloat162 s2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16 sb = __float2bfloat16_rn(sc[j]);
        s2[j] = __halves2bfloat162(sb, sb);
      }
      // byte j of a word: column 4g + j, i.e. tile j / 2, register j % 2
      // (+ 2 for the packed row four further on); the operand is
      // `decode_pair`'s, bit for bit: (value(hi), value(lo)) * (s, s) in bf16
      auto pair = [&](uint32_t w, int j) -> uint32_t {
        if constexpr (FMT == QMM_NF4) {
          const uint32_t v = lutl[((w >> (8 * j)) & 0xFF) << 3];
          __nv_bfloat162 r =
              __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&v), s2[j]);
          return *reinterpret_cast<uint32_t*>(&r);
        } else {
          return i4_pair_bf16(w, j, s2[j]);
        }
      };
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint8_t* wk = wt + (8 * s + t4) * 128;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wk);
        const uint32_t w4 = *reinterpret_cast<const uint32_t*>(wk + 4 * 128);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[s][j >> 1][j & 1] = pair(w0, j);
          a[s][j >> 1][2 + (j & 1)] = pair(w4, j);
        }
      }
    }
  };

  // `acc` is not initialised: the first product of each tile (block 0,
  // step 0; a split is never empty) runs with scale-d 0 and overwrites it.

  // One step: the products of block kc go to the tensor cores from `cur`,
  // and while they run block kc+1 is awaited and decoded into `nxt`. Two
  // wgmma groups are in flight at most; before the barrier every thread has
  // seen block kc-1's products end, so its slot is refilled after it (block
  // kc + STAGES - 1: STAGES - 2 blocks stay in flight behind the decode).
  int slot = 0, fill = STAGES - 1;
  auto step = [&](int kc, uint32_t (&cur)[4][2][4], uint32_t (&nxt)[4][2][4]) {
    const uint64_t desc = x_tile_desc(sx + slot * (N * 128));
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      Wgmma<N>::mma(acc[0], cur[s][0], desc + 2 * s, kc | s);
      Wgmma<N>::mma(acc[1], cur[s][1], desc + 2 * s, kc | s);
    }
    wgmma_commit();
    if (++slot == STAGES) slot = 0;
    wgmma_wait<1>();                 // block kc-1's products have ended
    cp_async_wait<STAGES - 3>();     // block kc+1 has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();
    if (kc + STAGES - 1 < nk) load(fill, kb0 + kc + STAGES - 1);
    cp_async_commit();
    if (++fill == STAGES) fill = 0;
    if (kc + 1 < nk) decode(slot, nxt);
  };

  uint32_t a0[4][2][4], a1[4][2][4];
  cp_async_wait<STAGES - 2>();       // block 0 has landed
  fence_proxy_async();
  __syncthreads();
  decode(0, a0);
  for (int kc = 0; kc < nk; kc += 2) {
    step(kc, a0, a1);
    if (kc + 1 < nk) step(kc + 1, a1, a0);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[t][i])::"memory");
}

// Stream-K hand-over of a partial tile. `flag_publish`: every thread's
// stores, a barrier, then one thread's release (the acq_rel fence orders the
// block's earlier stores before the flag, CUTLASS's `GenericBarrier`
// pattern). `flag_take`: acquire the flag once it is set, then clear it, so
// that every launch finds the flags zero.
__device__ __forceinline__ void flag_publish(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("fence.acq_rel.gpu;\nst.relaxed.gpu.global.b32 [%0], %1;\n"
                 ::"l"(flag), "r"(1) : "memory");
}
__device__ __forceinline__ void flag_take(int* flag) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(flag) : "memory");
  while (v == 0) {
    __nanosleep(32);
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v) : "l"(flag) : "memory");
  }
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;\n" ::"l"(flag), "r"(0)
               : "memory");
}

// This lane's rows of the accumulator (four columns from `col`) into `sums`
// (rows of `ld` f32, the tile's row r at r * ld): rows past M are left out.
template <int N>
__device__ __forceinline__ void qmm_stage(float* sums, int ld, int M, int m0,
                                          int col,
                                          const float (&acc)[2][N / 2]) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 8 * c + 2 * t4 + i;
      if (m0 + r < M)
        *reinterpret_cast<float4*>(sums + r * ld + col) =
            make_float4(acc[0][4 * c + i], acc[0][4 * c + 2 + i],
                        acc[1][4 * c + i], acc[1][4 * c + 2 + i]);
    }
}

// y[m][n .. n + 4) = bf16(s * the int8 per-column scale), one cast.
template <int FMT>
__device__ __forceinline__ void qmm_put(const float* __restrict__ scale,
                                        __nv_bfloat16* __restrict__ y,
                                        int Out, int m, int n, float4 s) {
  if (FMT == QMM_INT8) {
    const float4 sc = *reinterpret_cast<const float4*>(scale + n);
    s.x *= sc.x;
    s.y *= sc.y;
    s.z *= sc.z;
    s.w *= sc.w;
  }
  __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(y + (size_t)m * Out + n) = v;
}

// y rows [m0, m0 + N) of this lane's four columns [n, n + 4) from the
// accumulator layout: times the int8 per-column scale, cast once.
template <int FMT, int N>
__device__ __forceinline__ void qmm_store(const float* __restrict__ scale,
                                          __nv_bfloat16* __restrict__ y,
                                          int M, int Out, int m0, int n,
                                          const float (&acc)[2][N / 2]) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + 8 * c + 2 * t4 + i;
      if (m < M)
        qmm_put<FMT>(scale, y, Out, m, n,
                     make_float4(acc[0][4 * c + i], acc[0][4 * c + 2 + i],
                                 acc[1][4 * c + i], acc[1][4 * c + 2 + i]));
    }
}

// The two fix-ups below are calls, not inlined: their code in the kernel's
// body cost the main loop ~10 % on the card, even on launches that never
// ran it. The block's own sums come in through shared memory (`sums`, the
// tile's valid rows x bn f32, row r at r * ld), written by every thread
// before the call.

// The stream-K fix-up, run by the block holding a split tile's last 64-row
// block (block b, the highest index of the tile's blocks): y = bf16((p[first]
// + p[first + 1] + ... + p[b - 1] + sums) * scale), the partials of the
// tile's earlier segments added in ascending k order before this block's
// own. It waits only for blocks of lower index, which the hardware
// dispatched before it. Partial slot p is `slot_rows` x bn f32 at p *
// slot_rows * bn; a warp reads 512 contiguous bytes of it, and a thread
// keeps eight 16-byte loads in flight.
template <int FMT>
__device__ __noinline__ void qmm_fixup(const float* __restrict__ partial,
                                       int* __restrict__ flags,
                                       const float* sums, int ld,
                                       const float* __restrict__ scale,
                                       __nv_bfloat16* __restrict__ y,
                                       int first, int b, int slot_rows,
                                       int rows, int Out, int m0, int n0,
                                       int bn) {
  const int tid = threadIdx.x;
  for (int j = first + tid; j < b; j += 128) flag_take(flags + j);
  __syncthreads();   // the acquires, and every thread's staged sums
  const int lq = __ffs(bn) - 3, nq = rows << lq;   // a row's quads: 1 << lq
  const size_t slot = (size_t)slot_rows * bn;
  for (int k0 = tid; k0 < nq; k0 += 8 * 128) {
    float4 run[8];
    for (int p = first; p < b; ++p) {
      const float4* src = reinterpret_cast<const float4*>(partial + p * slot);
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = k0 + 128 * u;
        v[u] = k < nq ? __ldcg(src + k) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (p == first) {
          run[u] = v[u];
        } else {
          run[u].x += v[u].x;
          run[u].y += v[u].y;
          run[u].z += v[u].z;
          run[u].w += v[u].w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + 128 * u;
      if (k < nq) {
        const int r = k >> lq, c4 = (k & ((1 << lq) - 1)) * 4;
        const float4 own =
            *reinterpret_cast<const float4*>(sums + r * ld + c4);
        qmm_put<FMT>(scale, y, Out, m0 + r, n0 + c4,
                     make_float4(run[u].x + own.x, run[u].y + own.y,
                                 run[u].z + own.z, run[u].w + own.w));
      }
    }
  }
}

// The split cut's fix-up: the `split` blocks of one cluster hold the k
// segments of one tile, in ascending order of rank, each its sums in its own
// shared memory. After a cluster barrier rank j adds rows [j rows / split,
// (j + 1) rows / split) of the tile over the ranks' shared memory in
// ascending rank order (the stream-K fix-up's order: earlier segments
// first), scales (int8), casts once and writes them; a second barrier keeps
// every block's sums alive until its peers have read them. No global
// scratch and no flags.
template <int FMT>
__device__ __noinline__ void qmm_cluster_fixup(
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
    float* sums, int ld, int rows, int Out, int m0, int n0, int bn) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = cluster.num_blocks(), rank = cluster.block_rank();
  cluster.sync();                // every rank's sums are there
  const int lo = rank * rows / split, hi = (rank + 1) * rows / split;
  const int lq = __ffs(bn) - 3;  // a row's quads: 1 << lq
  for (int k = threadIdx.x; k < (hi - lo) << lq; k += 128) {
    const int r = lo + (k >> lq), c4 = (k & ((1 << lq) - 1)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < split) {
        const float4 v = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(sums, j) + r * ld + c4);
        if (j == 0) {
          s = v;
        } else {
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
        }
      }
    qmm_put<FMT>(scale, y, Out, m0 + r, n0 + c4, s);
  }
  cluster.sync();                // the peers have read this block's sums
}

// The dequant-matmul y = x @ w (x (M, In) bf16). The product's iterations
// are (row tile of N rows, strip of bn columns, 64-row block of In), the
// 64-row block fastest; `ops/quant_matmul.py matmul_plan` picks one of two
// cuts, both with at most two blocks an SM and block ranges within one
// 64-row block of each other.
//
// SK (stream-K, products of at least as many tiles as SMs): the iterations
// are cut into gridDim.x contiguous ranges (block b: [b I / G, (b + 1) I /
// G)), so every SM streams an equal share whatever the number of tiles. A
// block runs the tiles of its range, each over the range's part of it, the
// range's last tile first. A tile whose k range lies in one block is scaled
// (int8), cast once and written. A tile split across blocks: each block but
// the one holding its last 64-row block writes its f32 sum to slot b of
// `partial` and sets flags[b]; that one block adds the partials in ascending
// order before its own (`qmm_fixup`), scales, casts and writes. Only a
// range's last tile can be an unfinished head, and only its first a tail
// that others began, so a block has at most one partial and at most one
// fix-up; running the range backwards publishes the head before the block's
// other work and leaves the fix-up, which waits, for the end. Needs 1 <=
// gridDim.x <= the iterations, 16-byte aligned partial (gridDim.x, min(M,
// N), bn) and flags zero on entry (they are zero again on exit).
//
// Split (fewer tiles than SMs, where one block adding a tile's many large
// partials would take longer than the product): every tile is cut into
// `split` segments, one a block, and the tile's blocks are one cluster of
// `split` (block b: tile b / split, segment b % split); with split > 1 the
// cluster adds the segments in its shared memory (`qmm_cluster_fixup`).
//
// No atomics on the data: equal bits on every launch. Needs what
// `qmm_mainloop` needs, Out % bn == 0, 16-byte aligned y, and
// QmmTile<FMT>::smem_bytes(N, STAGES) of dynamic shared memory.
template <int FMT, int N, int STAGES, bool SK>
__global__ void __launch_bounds__(128)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ scale,
           const __nv_bfloat16* __restrict__ code, float* __restrict__ partial,
           int* __restrict__ flags, __nv_bfloat16* __restrict__ y, int M,
           int In, int Out, int bn, int split) {
  extern __shared__ __align__(16) uint8_t qmm_smem_raw[];
  uint8_t* sx = smem_align1024(qmm_smem_raw);
  float* sums = reinterpret_cast<float*>(sx);   // the ring, once it is free
  const int nkb = In / BK, strips = Out / bn, ld = bn + 4;
  // this lane's four columns (accumulator register 4c+i of tile t: x row
  // 8c + 2*t4 + (i&1), column 32w + 4g + 2t + (i>>1))
  const int col = (threadIdx.x >> 5) * 32 + ((threadIdx.x & 31) >> 2) * 4;
  float acc[2][N / 2];
  if constexpr (!SK) {
    const int t = blockIdx.x / split, j = blockIdx.x % split;
    const int k0 = j * nkb / split, k1 = (j + 1) * nkb / split;
    const int n0 = (t % strips) * bn, m0 = (t / strips) * N;
    qmm_mainloop<FMT, N, STAGES>(x, q, scale, code, sx, M, In, Out, bn, n0,
                                 m0, k0, k1 - k0, acc);
    if (split == 1) {
      if (col < bn) qmm_store<FMT, N>(scale, y, M, Out, m0, n0 + col, acc);
      return;
    }
    __syncthreads();             // the ring is free
    if (col < bn) qmm_stage<N>(sums, ld, M, m0, col, acc);
    qmm_cluster_fixup<FMT>(scale, y, sums, ld, min(N, M - m0), Out, m0, n0,
                           bn);
  } else {
    const int rows = min(M, N), t4 = threadIdx.x & 3;
    // iterations and block ranges fit in 32 bits (`qmm_matmul` checks)
    const unsigned iters =
        static_cast<unsigned>((M + N - 1) / N) * strips * nkb;
    const unsigned grid = gridDim.x, b = blockIdx.x;
    const unsigned s = static_cast<unsigned>(
        (unsigned long long)b * iters / grid);
    const unsigned e = static_cast<unsigned>(
        (unsigned long long)(b + 1) * iters / grid);
    const int t_first = s / nkb, t_last = (e - 1) / nkb;
    int n0 = 0, m0 = 0, k0 = 0;
    for (int t = t_last; t >= t_first; --t) {
      const int t0 = t * nkb;
      k0 = max(static_cast<int>(s) - t0, 0);
      const int k1 = min(static_cast<int>(e) - t0, nkb);
      n0 = (t % strips) * bn;
      m0 = (t / strips) * N;
      if (t < t_last) __syncthreads();   // the ring is free for this tile
      qmm_mainloop<FMT, N, STAGES>(x, q, scale, code, sx, M, In, Out, bn,
                                   n0, m0, k0, k1 - k0, acc);
      if (k1 < nkb) {            // the tile goes on in the next block
        if (col < bn) {
          float* out = partial + (size_t)b * rows * bn + col;
#pragma unroll
          for (int c = 0; c < N / 8; ++c)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int m = 8 * c + 2 * t4 + i;
              if (m0 + m < M)
                __stcg(reinterpret_cast<float4*>(out + (size_t)m * bn),
                       make_float4(acc[0][4 * c + i], acc[0][4 * c + 2 + i],
                                   acc[1][4 * c + i],
                                   acc[1][4 * c + 2 + i]));
            }
        }
        flag_publish(flags + b);
      } else if (k0 == 0 && col < bn) {  // the whole tile
        qmm_store<FMT, N>(scale, y, M, Out, m0, n0 + col, acc);
      }
    }
    // k0 > 0 here: the range's first tile, run last, began in earlier
    // blocks (its first 64-row block lies in block `first`) and ends here
    if (k0 > 0 && static_cast<int>(e) - t_first * nkb >= nkb) {
      const int first = static_cast<int>(
          ((unsigned long long)t_first * nkb * grid + grid - 1) / iters);
      __syncthreads();           // the ring is free
      if (col < bn) qmm_stage<N>(sums, ld, M, m0, col, acc);
      qmm_fixup<FMT>(partial, flags, sums, ld, scale, y, first,
                     static_cast<int>(b), rows, min(N, M - m0), Out, m0, n0,
                     bn);
    }
  }
}

// The host side has internal linkage (an unnamed namespace): each library
// that includes this header instantiates its own kernels and must make its
// own shared-memory opt-in for them. A `static` in a template of external
// linkage is one object for the whole process (STB_GNU_UNIQUE), whichever
// library set it; two libraries built with the same instantiation would
// share one flag, and the second would launch without its opt-in.
namespace {

// Dynamic shared memory above 48 KB is an opt-in per kernel and device,
// made once for each: `allowed` is the kernel's own set of flags.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, bool (&allowed)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64 || !allowed[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    if (dev >= 0 && dev < 64) allowed[dev] = true;
  }
  return cudaSuccess;
}

// Launch `kernel` (with `smem` bytes of dynamic shared memory) as a
// programmatic dependent of the kernel before it on `st`: its blocks may be
// set up while that grid runs, and its `griddepcontrol.wait` orders the data.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             size_t smem, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <int FMT, int N, int STAGES, bool SK>
cudaError_t qmm_launch(const void* x, const void* q, const void* scale,
                       const void* code, void* partial, void* flags, void* y,
                       int M, int In, int Out, int bn, int grid, int split,
                       cudaStream_t stream) {
  static bool allowed[64] = {};
  constexpr int smem = QmmTile<FMT>::smem_bytes(N, STAGES);
  cudaError_t e = allow_smem(qmm_kernel<FMT, N, STAGES, SK>, smem, allowed);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;   // the tile's segments, one cluster
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = SK || split < 2 ? 0 : 1;
  e = cudaLaunchKernelEx(&cfg, qmm_kernel<FMT, N, STAGES, SK>,
                         static_cast<const __nv_bfloat16*>(x),
                         static_cast<const uint8_t*>(q),
                         static_cast<const float*>(scale),
                         static_cast<const __nv_bfloat16*>(code),
                         static_cast<float*>(partial),
                         static_cast<int*>(flags),
                         static_cast<__nv_bfloat16*>(y), M, In, Out, bn,
                         split);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Tiles of a stream-K grid whose k range spans more than one block: one for
// each distinct tile a range boundary falls strictly inside
// (`ops/quant_matmul.py matmul_plan` counts the same `fixups`).
inline int qmm_fixups(long long iters, int nkb, int grid) {
  int n = 0;
  long long last = -1;
  for (long long b = 1; b < grid; ++b) {
    const long long s = b * iters / grid;
    if (s % nkb != 0 && s / nkb != last) {
      ++n;
      last = s / nkb;
    }
  }
  return n;
}

constexpr int QMM_MAX_GRID = 1024;   // flags the caller keeps (one a block)
constexpr int QMM_MAX_SPLIT = 8;     // blocks a cluster (the portable limit)

// One product by the plan (bn, n, grid, split, stages): split 0 is stream-K
// over `grid` blocks, `partial` (grid, min(M, n), bn) f32 scratch (null when
// no tile is split) and `flags` QMM_MAX_GRID ints, zero on entry and on
// exit, that the caller keeps for the device (launches on one device do not
// overlap); split >= 1 cuts every tile into `split` segments, grid = tiles
// x split, in clusters of `split` (partial unused). (n, stages) must be one
// of the four instantiated pairs below, one ring per width
// (`ops/quant_matmul.py WGMMA_STAGES` lists the same). Returns the first
// CUDA error of its calls, or cudaErrorInvalidValue for a plan the kernel
// does not take.
template <int FMT>
int qmm_matmul(const void* x, const void* q, const void* scale,
               const void* code, void* partial, void* flags, void* y, int M,
               int In, int Out, int bn, int n, int grid, int split,
               int stages, cudaStream_t st) {
  if (M < 1 || In % BK || (bn != 32 && bn != 64 && bn != 128) || Out % bn ||
      (M > n && n != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (long long)((M + n - 1) / n) * (Out / bn);
  const long long iters = tiles * (In / BK);
  const bool sk = split == 0;
  if (sk ? (grid < 1 || grid > iters || grid > QMM_MAX_GRID ||
            iters > INT_MAX || flags == nullptr ||
            (partial == nullptr && qmm_fixups(iters, In / BK, grid) > 0))
         : (split < 1 || split > QMM_MAX_SPLIT || split > In / BK ||
            grid != tiles * split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
#define FS_QMM_CASE(NN, SS)                                                  \
  if (n == NN && stages == SS)                                               \
    e = sk ? qmm_launch<FMT, NN, SS, true>(x, q, scale, code, partial,       \
                                           flags, y, M, In, Out, bn, grid,   \
                                           split, st)                        \
           : qmm_launch<FMT, NN, SS, false>(x, q, scale, code, partial,      \
                                            flags, y, M, In, Out, bn, grid,  \
                                            split, st);
  FS_QMM_CASE(16, 6)
  FS_QMM_CASE(64, 6)
  FS_QMM_CASE(96, 5)
  FS_QMM_CASE(128, 4)
#undef FS_QMM_CASE
  return static_cast<int>(e);
}

}  // namespace
}  // namespace fs
