// A float32 activation times an int8 weight with a float32 scale a
// channel: the projections and the tied logits of int8-weight serving.
//
// Replaces the int8 branches of the JAX package's decode functions
// (deeplearning4j_tpu/zoo/gpt.py gpt_decode_fns._matmul :262-269 and
// _logits :283-293, the same in gpt_paged_decode_fns). There XLA fused the
// upcast of the int8 payload into the product on the TPU; no Pallas kernel
// stands behind it. Eager PyTorch would write a float32 copy of the weight
// (four times its bytes) before the product.
//
// What it computes, for x [M, K] float32 (row stride sxm), the payload w
// int8 and the scale s float32:
//   layout 0 (a kernel, w [K, N]):   y[m, n] = (sum_k x[m, k] * w[k, n]) * s[n]
//   layout 1 (tied wte, w [N, K]):   y[m, n] = sum_k (x[m, k] * s[k]) * w[n, k]
// the second in the JAX order: x * s rounded to float32 first, then the
// product with the payload read transposed. The payload is read from
// device memory as int8 and widened on chip: no float32 copy of the
// weight is ever written. The scale of layout 0 is applied to the sum in
// the epilogue.
//
// What bounds it on an H100: at decode (M = 8 lanes, 64 at a verify of 8
// lanes x a window of 8) the weight's bytes (K N of them) against 3.35
// TB/s; at a prefill's M the products. An int8 value is exact in bf16, so
// only x is split: x = x_hi + x_mid + x_lo, three bf16 pieces holding its
// 24 significant bits, each multiplied with the widened weight on the
// tensor cores (2 M N K operations three times, at 989 TFLOP/s).
//
// What held the first design (plain FMA, a cluster a 32 x 64 tile) back: each block held one weight tile ahead in
// registers behind two __syncthreads a K step (too few bytes in flight:
// 0.15-0.25 TB/s at decode, as flat from M = 1 to 8 as a latency floor),
// multiplied 32-row tiles of which a decode uses 8, on the FMA units
// (10-18 TFLOP/s at M = 64 and 512).
//
// Design (sm_90a, one warpgroup of 128 threads a block):
// - The weight's N axis is the wgmma's 64-row side (A, from registers)
//   and x's rows are its n side (B, bf16 in shared memory, K-major, the
//   128-byte swizzle), n = 8, 16, 32 or 64 by M: a decode's 8 rows are
//   the MMA's n = 8 and no thread multiplies padding rows.
// - A block takes 64 columns of y and a tile of up to 64 rows; the K axis
//   is cut into 64-deep tiles. Where the weight's 64-column tiles are too
//   few to fill the card (qkv's 72, the projections' 24), a cluster of 8
//   blocks shares them, rank j the j-th eighth (a range set by K alone):
//   even N = 1536 gives 24 x 8 blocks a row tile. Where they are many (the
//   logits' 512), a cluster of 2 halves the K axis: fewer blocks, a
//   shorter exchange. The split is set by the weight's shape, never by M.
// - A ring of stages (2 at up to 32 rows, 1 at 64, whose blocks an SM its
//   shared memory bounds) carries each K tile:
//   the 64 x 64 weight tile as one TMA box of a 2-D tensor map (encoded on
//   the host once a weight and kept), x's rows and (layout 1) the scales
//   as 16-byte cp.async copies, all completing on the stage's mbarrier.
//   One copy a weight tile: 64-byte row copies (one bulk copy each) held
//   a 7 MB product to 0.6 TB/s even with no math behind them.
// - Each thread reads its A fragment's 32 bytes of a tile from the stage
//   (two 16-byte loads in layout 1, sixteen 2-byte loads in layout 0: the
//   tile's K positions are permuted so that a thread's bytes lie together,
//   and x's B tile takes the same permutation) and widens them to bf16
//   pairs; x's tile is cut into its three pieces (layout 1: times s[k],
//   rounded, first; x_hi = bf16(x), x_mid = bf16(x - x_hi), x_lo = bf16(x
//   - x_hi - x_mid), every difference exact) into the three B tiles. Then
//   the stage is free for the next tile it carries.
// - A tile's 12 wgmmas (4 k16 steps x hi, mid, lo, in that order) sum into
//   a fresh float32 partial, added to the thread's running sum with one
//   rounded add: the tensor cores' own accumulation covers 192 products,
//   never a whole K range.
// - Epilogue: each rank pushes an eighth of its partial tile to every rank
//   (st.async into the receiver's shared memory, completing as bytes on its
//   mbarrier); rank j adds its eighth's 8 partials in rank order, applies
//   s[n] (layout 0) and writes y. No block reads another's shared memory.
// Unaligned inputs take plain loads for the same layouts.
// Every order is set by the weight's shape alone (the ranks' K ranges, the
// tiles in order, the pieces, the rank-order combine) and the MMA's n only
// widens the
// product, so a row's result does not depend on M or on the other rows (a
// verify row equals the decode row bit for bit; chip_smoke.py checks it
// at every shape and M) and two calls give the same bits. No atomics, no
// workspace, no allocation, one launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <list>
#include <map>
#include <mutex>
#include <set>
#include <tuple>

#include "sm90.cuh"

namespace i8mm {

using namespace sm90;

constexpr int kBN = 64;         // columns of y a block: the MMA's 64 rows
constexpr int kBK = 64;         // depth of a K tile
// Blocks a cluster (the K tiles cut in that many parts) for a weight of N
// columns: 8 where its 64-column tiles are too few to fill the card (qkv's
// 72), 2 where they are many (the logits' 512). Set by the weight's shape,
// never by M.
constexpr int kManyTiles = 256;
inline int ranks_for(int N) { return (N + 63) / 64 >= kManyTiles ? 2 : 8; }
constexpr int kThreads = 128;   // one warpgroup
constexpr int kPieces = 3;      // x_hi, x_mid, x_lo
constexpr int kWBytes = kBN * kBK;   // a stage's weight tile: 64 rows of 64 bytes

struct Args {
  CUtensorMap wmap;  // the payload as a 2-D int8 tensor, 64 x 64 boxes (tma)
  const float* x;
  const int8_t* w;
  const float* s;
  float* y;
  int M, N, K, mtiles;
  int64_t sxm;
  int vec_x;  // x rows on 16 bytes and K % 4 == 0: 16-byte async copies
  int tma;    // w on 16 bytes and its row length % 16 == 0: wmap is set
};

// Stages a block keeps in flight, and a stage's bytes: the weight tile
// (layout 1 [64 n][64 k], layout 0 [64 k][64 n], 64 bytes a row), x's BM
// rows of 64 floats, and layout 1's 64 scales.
template <int BM>
struct Stage {
  static constexpr int kCount = BM == 64 ? 1 : 2;
  static constexpr int kX = kWBytes;
  static constexpr int kS = kX + BM * kBK * 4;
  static constexpr int kBytes = kS + kBK * 4;
};

// The K tiles of rank `rank` of `ranks`: [t0, t1), set by K alone.
__device__ __forceinline__ void rank_tiles(int K, int ranks, int rank, int& t0, int& t1) {
  const int kt = (K + kBK - 1) / kBK;
  const int per = (kt + ranks - 1) / ranks;
  t0 = min(rank * per, kt);
  t1 = min(t0 + per, kt);
}

// Position p (0 .. 63) of a K tile as read from the weight, and the
// (k16 step, column) of the MMA's K it stands at. Thread quad t of a
// warp holds columns 2t, 2t + 1, 2t + 8, 2t + 9 (j = 0 .. 3) of each
// k16 step kk; layout 1 puts a thread's 16 positions together (p = 16 t
// + 4 kk + j: one 16-byte load a row), layout 0 puts the four quads'
// positions on four neighbouring weight rows (p = 16 kk + 4 j + t).
template <int LAYOUT>
__device__ __forceinline__ int mma_col(int p) {
  const int t = LAYOUT == 1 ? p / 16 : p % 4;
  const int kk = LAYOUT == 1 ? (p / 4) % 4 : p / 16;
  const int j = LAYOUT == 1 ? p % 4 : (p / 4) % 4;
  return 16 * kk + 2 * t + (j & 1) + 8 * (j >> 1);
}

// One 64 x 64 box of the 2-D tensor map (inner coordinate c0) into shared
// memory at `dst`, completing on `bar`: a whole weight tile, one copy.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// 16 bytes (the first `bytes` of them, the rest zero) of global memory
// into shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// This thread's arrival on `bar`, once its earlier cp.async copies land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// This CTA's shared-memory address `local` as rank `rank`'s address in the
// cluster's shared window.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

// 8 bytes into another CTA's shared memory at the cluster address `dst`,
// completing as bytes on its mbarrier `bar`.
__device__ __forceinline__ void st_async2(uint32_t dst, float a, float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          dst),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(int8_t lo, int8_t hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(lo), static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&h);
}

// The B operand: rows [r0, r0 + n) of a K-major tile of 128-byte rows
// (64 bf16 of K), 128-byte swizzle (16-byte chunk c of row r at chunk c ^
// (r % 8)), at k16 step kk: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_b(uint32_t tile, int r0, int kk) {
  return make_desc(tile + r0 * 128 + kk * 32, 16, 1024, 1);
}

// d (64 x N float32, the accumulator fragment) += A . B for one k16 step:
// A (the weight's 64 columns) from registers, B (N rows of x) K-major in
// shared memory; scale_d = 0 overwrites d.
template <int N>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void rs(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// Shared memory of a block of BM rows: the pieces' B tiles, the stages,
// the eighths the cluster pushes here (8 x RANKS / RANKS), and 1024
// bytes to align the swizzled tiles.
template <int BM>
struct Smem {
  static constexpr int kX = kPieces * BM * 128;
  static constexpr int kRecv = 8 * 8 * BM * 4;
  static constexpr int kBytes = 1024 + kX + Stage<BM>::kCount * Stage<BM>::kBytes + kRecv;
};

// One cluster of RANKS blocks a tile of 64 columns x BM rows of y; rank j
// takes the j-th part of the K tiles. BM is 8, 16, 32 or 64: the MMA's n.
template <int LAYOUT, int BM, int RANKS>
__global__ void __cluster_dims__(RANKS, 1, 1) __launch_bounds__(kThreads)
    int8_wgmma_kernel(const __grid_constant__ Args a) {
  constexpr int NW = BM;                        // each wgmma's n
  using St = Stage<BM>;
  constexpr int NS = St::kCount;
  constexpr int XF = BM / 8;                     // 16-byte pieces of x a thread a tile
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ __align__(8) uint64_t full[NS];
  __shared__ __align__(8) uint64_t rbar;
  const uint32_t dyn0 = smem_u32(dyn);
  const uint32_t xs = (dyn0 + 1023u) & ~1023u;   // x_hi, x_mid, x_lo tiles
  const uint32_t ring = xs + Smem<BM>::kX;
  const uint32_t recv = ring + NS * St::kBytes;
  const unsigned char* ring_p = dyn + (ring - dyn0);
  float* recv_p = reinterpret_cast<float*>(dyn + (recv - dyn0));

  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int tile = static_cast<int>(blockIdx.x / RANKS);
  const int n0 = (tile / a.mtiles) * kBN, m0 = (tile % a.mtiles) * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  int t0, t1;
  rank_tiles(a.K, RANKS, static_cast<int>(rank), t0, t1);
  const int nk = t1 - t0;

  if (tid == 0) {
    // a stage completes on every thread's x copies and thread 0's arrival
    // (with the weight tile's bytes)
    for (int s = 0; s < NS; ++s) mbar_init(smem_u32(&full[s]), kThreads + 1);
    mbar_init(smem_u32(&rbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every rank's rbar is initialised before any rank pushes to it (the
  // wait is after the K loop)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // This rank's tile i (K tile t0 + i) into stage i % NS: thread 0 the
  // weight (one TMA box), every thread its share of x's rows (16-byte
  // async copies, zero past M and K) and, in layout 1, of the scales.
  auto issue = [&](int i) {
    const int k0 = (t0 + i) * kBK;
    const uint32_t bar = smem_u32(&full[i % NS]);
    const uint32_t st = ring + (i % NS) * St::kBytes;
    if (tid == 0) {
      if (a.tma) {
        mbar_expect_tx(bar, kWBytes);
        tma_load(st, &a.wmap, bar, LAYOUT == 1 ? k0 : n0, LAYOUT == 1 ? n0 : k0);
      } else {
        mbar_arrive(bar);
      }
    }
    if (a.vec_x) {
#pragma unroll
      for (int c = 0; c < XF; ++c) {
        const int f = tid + kThreads * c;
        const int m = m0 + f / 16, k = k0 + 4 * (f % 16);
        const int keep_b = m < a.M && k < a.K ? 4 * min(4, a.K - k) : 0;
        cp_async16(st + St::kX + f * 16,
                   keep_b ? a.x + static_cast<int64_t>(m) * a.sxm + k : a.x,
                   static_cast<uint32_t>(keep_b));
      }
      if (LAYOUT == 1 && tid < kBK / 4) {
        const int k = k0 + 4 * tid;
        cp_async16(st + St::kS + tid * 16, k < a.K ? a.s + k : a.s,
                   k < a.K ? static_cast<uint32_t>(4 * min(4, a.K - k)) : 0u);
      }
      cp_async_arrive(bar);
    } else {   // x (and the scales) element by element
      float* sx = reinterpret_cast<float*>(dyn + (st - dyn0) + St::kX);
      for (int e = tid; e < BM * kBK; e += kThreads) {
        const int m = m0 + e / kBK, k = k0 + e % kBK;
        sx[e] = m < a.M && k < a.K ? a.x[static_cast<int64_t>(m) * a.sxm + k] : 0.f;
      }
      if (LAYOUT == 1 && tid < kBK) {
        const int k = k0 + tid;
        sx[BM * kBK + tid] = k < a.K ? a.s[k] : 0.f;
      }
      mbar_arrive(bar);
    }
  };
  for (int i = 0; i < min(NS, nk); ++i) issue(i);

  // stage i's x tile cut into x_hi + x_mid + x_lo (layout 1: x * s[k],
  // rounded, first) and stored as the three B tiles at the MMA's columns
  auto store_x = [&](int i) {
    const unsigned char* st = ring_p + (i % NS) * St::kBytes;
#pragma unroll
    for (int c = 0; c < XF; ++c) {
      const int f = tid + kThreads * c;
      const int r = f / 16, q = f % 16;
      float4 v = *reinterpret_cast<const float4*>(st + St::kX + f * 16);
      if (LAYOUT == 1) {   // the JAX order: x * s[k], rounded, before the product
        const float4 sk = *reinterpret_cast<const float4*>(st + St::kS + q * 16);
        v = make_float4(__fmul_rn(v.x, sk.x), __fmul_rn(v.y, sk.y), __fmul_rn(v.z, sk.z),
                        __fmul_rn(v.w, sk.w));
      }
      uint32_t p01[kPieces], p23[kPieces];
      split3(v.x, v.y, p01);
      split3(v.z, v.w, p23);
      const uint32_t row = xs + r * 128;
      if (LAYOUT == 1) {
        // positions 4q .. 4q + 3 are the MMA's columns c, c + 1, c + 8,
        // c + 9 (c = mma_col(4q), even): two 4-byte stores a piece
        const int col = mma_col<LAYOUT>(4 * q);
        const uint32_t o0 = row + ((((col >> 3) ^ r) & 7) << 4) + (col & 7) * 2;
        const uint32_t o1 = row + (((((col + 8) >> 3)) ^ r) & 7) * 16 + (col & 7) * 2;
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          st_shared_u32(o0 + p * BM * 128, p01[p]);
          st_shared_u32(o1 + p * BM * 128, p23[p]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = mma_col<LAYOUT>(4 * q + e);
          const uint32_t off = row + ((((col >> 3) ^ r) & 7) << 4) + (col & 7) * 2;
#pragma unroll
          for (int p = 0; p < kPieces; ++p)
            st_shared_u16(off + p * BM * 128,
                          static_cast<uint16_t>((e < 2 ? p01[p] : p23[p]) >> (16 * (e & 1))));
        }
      }
    }
  };
  // this thread's A fragments of tile i: MMA rows 16 warp + g + 8 h (the
  // weight's column n0 + that row in layout 1, n0 + 16 warp + 2 g + h in
  // layout 0), byte j of word[h][kk] at the fragment's column j of step kk
  uint32_t af[4][4];
  auto load_a = [&](int i) {
    uint32_t word[2][4];
    if (a.tma) {
      const unsigned char* st = ring_p + (i % NS) * St::kBytes;
      if (LAYOUT == 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 u =
              *reinterpret_cast<const uint4*>(st + (16 * warp + g + 8 * h) * 64 + 16 * t);
          word[h][0] = u.x;
          word[h][1] = u.y;
          word[h][2] = u.z;
          word[h][3] = u.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          word[0][kk] = word[1][kk] = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t u = *reinterpret_cast<const uint16_t*>(
                st + (16 * kk + 4 * j + t) * 64 + 16 * warp + 2 * g);
            word[0][kk] |= (u & 0xffu) << (8 * j);
            word[1][kk] |= (u >> 8) << (8 * j);
          }
        }
      }
    } else {   // weight bytes straight from device memory
      const int k0 = (t0 + i) * kBK;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          word[h][kk] = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + 16 * warp + (LAYOUT == 1 ? g + 8 * h : 2 * g + h);
            const int k = k0 + (LAYOUT == 1 ? 16 * t + 4 * kk + j : 16 * kk + 4 * j + t);
            const int8_t b = n < a.N && k < a.K
                                 ? a.w[LAYOUT == 1 ? static_cast<int64_t>(n) * a.K + k
                                                   : static_cast<int64_t>(k) * a.N + n]
                                 : int8_t(0);
            word[h][kk] |= static_cast<uint32_t>(static_cast<uint8_t>(b)) << (8 * j);
          }
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      auto byte = [&](int h, int j) { return static_cast<int8_t>(word[h][kk] >> (8 * j)); };
      af[kk][0] = pack_bf16(byte(0, 0), byte(0, 1));
      af[kk][1] = pack_bf16(byte(1, 0), byte(1, 1));
      af[kk][2] = pack_bf16(byte(0, 2), byte(0, 3));
      af[kk][3] = pack_bf16(byte(1, 2), byte(1, 3));
    }
  };

  float acc[BM / 2], part[BM / 2];
#pragma unroll
  for (int e = 0; e < BM / 2; ++e) acc[e] = part[e] = 0.f;
  for (int i = 0; i < nk; ++i) {
    mbar_wait(smem_u32(&full[i % NS]), static_cast<uint32_t>((i / NS) & 1));
    store_x(i);                       // the last tile's products are done
    load_a(i);
    // the B tiles (written here) before the products read them; the
    // stage's reads before the next copies into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (i + NS < nk) issue(i + NS);
    keep(part);
    wgmma_fence();
    // k16 steps in order, each as x_hi, x_mid, x_lo, into a fresh partial
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
#pragma unroll
        for (int c = 0; c < BM / NW; ++c)
          Mma<NW>::rs(*reinterpret_cast<float(*)[NW / 2]>(part + c * (NW / 2)), af[kk],
                      desc_b(xs + p * BM * 128, c * NW, kk), kk + p > 0);
    wgmma_commit();
    wgmma_wait();
    keep(part);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(af[kk][j])::"memory");
#pragma unroll
    for (int e = 0; e < BM / 2; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
  }

  // Each rank's partial to the owners of its eighths: MMA rows 8 j .. 8 j
  // + 7 (warp j / 2, h = j % 2) to rank j % RANKS, as recv[j / RANKS][this
  // rank][g][m].
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const uint32_t bar = smem_u32(&rbar);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = 2 * warp + h;
    const uint32_t to = j % RANKS;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const int idx = (((j / RANKS) * RANKS + static_cast<int>(rank)) * 8 + g) * BM + 8 * i + 2 * t;
      const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      if (to == rank) {
        recv_p[idx] = v0;
        recv_p[idx + 1] = v1;
      } else {
        st_async2(cluster_addr(recv + idx * 4, to), v0, v1, cluster_addr(bar, to));
      }
    }
  }
  if (tid == 0) mbar_expect_tx(bar, (8 / RANKS) * (RANKS - 1) * 8 * BM * 4);
  __syncthreads();
  mbar_wait(bar, 0);
  // this rank's eighths: each one's RANKS partials in rank order, then
  // s[n], then y
  for (int e = tid; e < (8 / RANKS) * 8 * BM; e += kThreads) {
    const int slot = e / (8 * BM), gg = e % 8, mi = (e / 8) % BM;
    const int j = static_cast<int>(rank) + RANKS * slot;
    const float* pr = recv_p + slot * RANKS * 8 * BM + gg * BM + mi;
    float sum = pr[0];
#pragma unroll
    for (int r = 1; r < RANKS; ++r) sum = __fadd_rn(sum, pr[r * 8 * BM]);
    const int n = n0 + (LAYOUT == 1 ? 8 * j + gg : 16 * (j / 2) + 2 * gg + j % 2);
    const int m = m0 + mi;
    if (n < a.N && m < a.M) {
      if (LAYOUT == 0) sum = __fmul_rn(sum, __ldg(a.s + n));
      a.y[static_cast<int64_t>(m) * a.N + n] = sum;
    }
  }
}

// The kernel's shared memory raised past 48 KB on the current device, once
// per device: a kernel's attributes belong to each device's context.
template <int LAYOUT, int BM, int RANKS>
cudaError_t configure() {
  static std::mutex mu;
  static std::set<int> raised;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  if (raised.count(dev) != 0) return cudaSuccess;
  e = cudaFuncSetAttribute(int8_wgmma_kernel<LAYOUT, BM, RANKS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<BM>::kBytes);
  if (e == cudaSuccess) raised.insert(dev);
  return e;
}

template <int LAYOUT, int BM, int RANKS>
int launch(Args a, cudaStream_t st) {
  a.mtiles = (a.M + BM - 1) / BM;
  const int64_t blocks = static_cast<int64_t>((a.N + kBN - 1) / kBN) * a.mtiles * RANKS;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = configure<LAYOUT, BM, RANKS>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int8_wgmma_kernel<LAYOUT, BM, RANKS>
      <<<static_cast<unsigned>(blocks), kThreads, Smem<BM>::kBytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int LAYOUT, int BM>
int launch_r(const Args& a, cudaStream_t st) {
  return ranks_for(a.N) == 2 ? launch<LAYOUT, BM, 2>(a, st) : launch<LAYOUT, BM, 8>(a, st);
}

// The rows a block by M: a decode's 8 lanes are the MMA's n = 8.
template <int LAYOUT>
int launch_m(const Args& a, cudaStream_t st) {
  if (a.M <= 8) return launch_r<LAYOUT, 8>(a, st);
  if (a.M <= 16) return launch_r<LAYOUT, 16>(a, st);
  if (a.M <= 32) return launch_r<LAYOUT, 32>(a, st);
  return launch_r<LAYOUT, 64>(a, st);
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// cuTensorMapEncodeTiled, from the libcuda the CUDA runtime has loaded.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// Tensor maps kept at most: a GPT-medium's 97 int8 weights, a draft's and
// a re-quantized copy of each (a pull of new weights makes new tensors).
constexpr size_t kMaxMaps = 512;

// The payload's map as a 2-D uint8 tensor (its contiguous axis inner) in
// 64 x 64 boxes, zero past its edges. A map holds only the address and the
// shape, so it is encoded once for each (address, shape) and kept, the
// least recently used dropped past kMaxMaps: a weight's maps are made at
// its first call.
bool weight_map(CUtensorMap* m, const void* w, int64_t K, int64_t N, int layout) {
  using Key = std::tuple<uintptr_t, int64_t, int64_t, int>;
  static std::mutex mu;
  static std::list<std::pair<Key, CUtensorMap>> used;   // most recent first
  static std::map<Key, std::list<std::pair<Key, CUtensorMap>>::iterator> maps;
  const Key key = std::make_tuple(reinterpret_cast<uintptr_t>(w), K, N, layout);
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    used.splice(used.begin(), used, it->second);
    *m = it->second->second;
    return true;
  }
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const int64_t inner = layout == 0 ? N : K, outer = layout == 0 ? K : N;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner)};
  const cuuint32_t box[2] = {kBK, kBN};
  const cuuint32_t unit[2] = {1, 1};
  if (enc(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box, unit,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  used.emplace_front(key, *m);
  maps.emplace(key, used.begin());
  if (used.size() > kMaxMaps) {
    maps.erase(used.back().first);
    used.pop_back();
  }
  return true;
}

}  // namespace i8mm

// x [M, K] float32 at row stride sxm (last stride 1); w int8, contiguous:
// [K, N] for layout 0, [N, K] for layout 1; scale float32 [N] (layout 0)
// or [K] (layout 1); y [M, N] float32, contiguous. Returns the launch's
// cudaError_t.
extern "C" int dl4j_int8_matmul(const void* x, const void* w, const void* scale, void* y,
                                int64_t M, int64_t N, int64_t K, int64_t sxm, int layout,
                                void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K < 0 || M >= (int64_t{1} << 31) || N >= (int64_t{1} << 31) || K >= (int64_t{1} << 31) ||
      (layout != 0 && layout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  i8mm::Args a{};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.s = static_cast<const float*>(scale);
  a.y = static_cast<float*>(y);
  a.M = static_cast<int>(M);
  a.N = static_cast<int>(N);
  a.K = static_cast<int>(K);
  a.sxm = sxm;
  a.vec_x = i8mm::aligned(x, 16) && sxm % 4 == 0 && K % 4 == 0 && i8mm::aligned(scale, 16);
  a.tma = K >= i8mm::kBK && N >= i8mm::kBN && i8mm::aligned(w, 16) &&
          (layout == 0 ? N : K) % 16 == 0 &&
          i8mm::weight_map(&a.wmap, w, K, N, layout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return layout == 0 ? i8mm::launch_m<0>(a, st) : i8mm::launch_m<1>(a, st);
}
