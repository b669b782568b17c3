// Scaled dot-product attention, forward and backward, for Hopper (sm_90a).
//
// Not a TPU kernel: the JAX package's `scaled_dot_product_attention`
// (deeplearning4j_tpu/ops/nn_ops.py:462-488) is one op that XLA fused on the
// TPU. In eager PyTorch the same math writes the float32 scores, the masked
// scores, the probabilities and their cast to device memory; these kernels
// keep them on chip. The plain PyTorch versions are `attention_fwd_plain`
// and `attention_bwd_plain` in kernels/attention.py.
//
// The function, per (batch, head), q [Sq, D], k and v [Sk, D]:
//   x    = (q . k^T) * scale           (float32 sums; float64 for float64)
//   x    = -1e30 where causal and key j > query i + (Sk - Sq)
//   P    = softmax(x) over the keys    (float32; float64 for float64)
//   O    = P (cast to v's dtype) . v
// A row whose every key is masked averages v, as the reference does.
// The forward also writes per row, in the accumulation dtype, the
// log-sum-exp as two numbers in base 2: stats[0] = max_j x_j * log2(e) and
// stats[1] = log2(sum_j 2^(x_j * log2(e) - stats[0])). Kept apart, they give
// P = 2^(x log2(e) - stats[0] - stats[1]) exactly even for a fully masked
// row, where stats[0] is -1.4e30 and their sum would lose stats[1].
// Backward (FlashAttention-2's scheme, P recomputed from stats):
//   delta = rowsum(dO * O)
//   dS    = P * (dO . v^T - delta), 0 where masked (the mask's `where`
//           passes no gradient to a masked score)
//   dv    = P^T . dO,  dk = scale * dS^T . q,  dq = scale * dS . k
// Three launches, no atomics: delta; dk and dv with one block per key tile
// looping over the query tiles; dq with one block per query tile looping
// over the key tiles. Every sum runs in a fixed order: two calls are
// bit-equal.
//
// Types: bf16 (the main path: tensor cores through mma.sync m16n8k16,
// float32 accumulation, P and dS rounded to bf16 before their products, as
// the reference rounds P before P . v), float32 and float64 (one warp per
// row, scalar FMAs: the card-against-CPU checks). D in {16, 32, 64, 128}.
//
// What bounds it: at GPT-medium's shape (16 x 12 heads x 512 x 128, causal)
// one forward is 12.9 GFLOP of products (0.013 ms at 989 TFLOP/s) on 100
// MB of q, k, v and O (0.030 ms at 3.35 TB/s), so the least time is set
// by the bytes; the backward's three kernels likewise. These kernels run
// at ~4-6x that bound (~100-120 TFLOP/s on an H100, PERF.md); what holds
// them there is not measured yet (masking only the diagonal tiles changed
// nothing). wgmma and TMA are the tools for a faster version.
//
// What the design does about it:
// - Blocks of 4 warps; each warp owns 16 rows (the mma's M) of the block's
//   tile, so a K or V tile in shared memory serves four warps.
// - The scores never leave registers: the accumulator fragment of
//   S = Q K^T is, element for element, the A fragment of P . V, so P is
//   rescaled, rounded and fed back without a trip through memory.
// - Causal tiles above the diagonal are skipped: a masked score adds
//   2^(-1.4e30) = 0 to a row that has a visible key, so skipping is exact.
//   A query tile holding a fully masked row (Sq > Sk) visits every key.
// - Tiles are copied to shared memory with cp.async (16 bytes a thread,
//   zero-filled past the sequence's end) and double-buffered: the next
//   key (or query) tile's copies are in flight while the current one is
//   multiplied. Rows are padded by 8 elements, so that ldmatrix reads
//   them without bank conflicts; every mma fragment comes from ldmatrix,
//   and its .trans form serves the products that need a tile transposed
//   (V for P . V; q and dO for dk and dv; k for dq).
// - q, k, v and dO are read at their own (batch, head, row) strides with
//   the last stride 1: the views that split one [B, S, H, 3D] projection
//   need no copy. 16-byte loads where every row is 16-byte aligned.
// - Heavy causal tiles (the last query tiles, the first key tiles) are
//   scheduled first.
// - The wrapper allocates every output; nothing here allocates, and every
//   launch goes on PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr double kLog2eD = 1.4426950408889634;
constexpr float kMasked = -1e30f;

struct Strides {
  int64_t b, h, s;   // element strides of batch, head and row; d's is 1
};

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;      // backward: the forward's output, contiguous
  const void* dout;   // backward: dO, at its own strides
  void* out;          // forward: O, contiguous [B, H, Sq, D]
  void* stats;        // [B, H, Sq, 2] in the accumulation dtype
  void* delta;        // [B, H, Sq] in the accumulation dtype
  void* dq;           // contiguous, like q
  void* dk;           // contiguous, like k
  void* dv;           // contiguous, like v
  Strides sq, sk, sv, sdo;
  int64_t H, Sq, Sk, D;
  int64_t off;        // Sk - Sq: key j is masked for query i when j > i + off
  double scale;
  int causal;
  int vec;            // every row of q, k, v and dO is 16-byte aligned
};

__device__ __forceinline__ const uint16_t* row_base(const void* p, const Strides& s, int64_t bh,
                                                    int64_t H) {
  return static_cast<const uint16_t*>(p) + (bh / H) * s.b + (bh % H) * s.h;
}

template <typename T>
__device__ __forceinline__ const T* row_base_t(const void* p, const Strides& s, int64_t bh,
                                               int64_t H) {
  return static_cast<const T*>(p) + (bh / H) * s.b + (bh % H) * s.h;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// c += a . b for one m16n8k16 tile: bf16 inputs, float32 accumulators.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane
// (lanes 8i..8i+7 give matrix i's rows); ``trans`` delivers them transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The A fragment of the 16 x 16 block at `p` of a row-major tile (row
// stride `ld`): rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9.
__device__ __forceinline__ void load_a(uint32_t a[4], const uint16_t* p, int ld, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4(a, p + ((i & 1) * 8 + r) * ld + (i >> 1) * 8);
}

// The B fragments of two n-tiles (n0 and n0 + 8; b[0..1] and b[2..3]) for
// one k16 step, where B[k][n] = T[n][k] and `p` points at T[n0][k0] of a
// row-major tile T (k contiguous).
__device__ __forceinline__ void load_b_nk(uint32_t b[4], const uint16_t* p, int ld, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4(b, p + ((i >> 1) * 8 + r) * ld + (i & 1) * 8);
}

// The same where B[k][n] = T[k][n] (n contiguous): `p` points at
// T[k0][n0]; the matrices are loaded transposed.
__device__ __forceinline__ void load_b_kn(uint32_t b[4], const uint16_t* p, int ld, int lane) {
  const int i = lane >> 3, r = lane & 7;
  ldsm_x4_t(b, p + ((i & 1) * 8 + r) * ld + (i >> 1) * 8);
}

// An A fragment from two accumulator tiles (columns 0-7 and 8-15).
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + ROWS) of a [S, D] slab (row stride rs) into dst[ROWS][LD],
// zero past row S. Consecutive threads take consecutive 16-byte chunks:
// asynchronous copies (cp.async, zero-filled past S) when every row is
// 16-byte aligned, else plain loads and stores.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* src, int64_t rs,
                                          int64_t r0, int64_t S, int vec) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool in = r0 + r < S;
    if (vec) {
      const uint16_t* p = in ? src + (r0 + r) * rs + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(dst + r * LD + c)),
                   "l"(p), "r"(in ? 16 : 0));
    } else {
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        const uint16_t* p = src + (r0 + r) * rs + c;
        val.x = p[0] | (static_cast<uint32_t>(p[1]) << 16);
        val.y = p[2] | (static_cast<uint32_t>(p[3]) << 16);
        val.z = p[4] | (static_cast<uint32_t>(p[5]) << 16);
        val.w = p[6] | (static_cast<uint32_t>(p[7]) << 16);
      }
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  }
}

// The end of the keys a causal query tile [q0, q0 + rows) must visit.
__device__ __forceinline__ int64_t key_end(const AttnArgs& p, int64_t q0, int64_t rows,
                                           bool all_if_masked_row) {
  if (!p.causal) return p.Sk;
  if (all_if_masked_row && q0 + p.off < 0) return p.Sk;   // a fully masked row
  int64_t e = q0 + rows + p.off;
  e = e < 0 ? 0 : e;
  return e < p.Sk ? e : p.Sk;
}

// The first query a causal key tile starting at j0 must visit.
__device__ __forceinline__ int64_t query_begin(const AttnArgs& p, int64_t j0, int64_t step) {
  if (!p.causal || p.Sq > p.Sk) return 0;   // Sq > Sk: fully masked rows see every key
  int64_t b = j0 - p.off;
  b = b < 0 ? 0 : b;
  return (b / step) * step;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// ---------------------------------------------------------------------------
// bf16 forward: one block per (batch * head, 64-query tile). The K and V
// tiles are double-buffered: the next tile's copies are in flight while
// the current one is multiplied.
constexpr int kFwdBM = 64;
constexpr int kFwdBN = 64;

template <int D>
struct FwdShape {
  static constexpr int LD = D + 8;
  static constexpr int kSmem = (kFwdBM + 4 * kFwdBN) * LD * 2;   // Q, K[2], V[2]
};

template <int D>
__global__ void __launch_bounds__(kThreads) attention_fwd_bf16(AttnArgs p) {
  using S = FwdShape<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;                             // [BM][LD]
  uint16_t* ks = qs + kFwdBM * LD;                 // [2][BN][LD]
  uint16_t* vs = ks + 2 * kFwdBN * LD;             // [2][BN][LD]
  const int64_t bh = blockIdx.x;
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kFwdBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const float scale = static_cast<float>(p.scale);
  const uint16_t* kb = row_base(p.k, p.sk, bh, p.H);
  const uint16_t* vb = row_base(p.v, p.sv, bh, p.H);
  const int64_t kend = key_end(p, q0, kFwdBM, true);
  const int ntiles = static_cast<int>((kend + kFwdBN - 1) / kFwdBN);

  load_rows<kFwdBM, D, LD>(qs, row_base(p.q, p.sq, bh, p.H), p.sq.s, q0, p.Sq, p.vec);
  cp_async_commit();
  load_rows<kFwdBN, D, LD>(ks, kb, p.sk.s, 0, p.Sk, p.vec);
  load_rows<kFwdBN, D, LD>(vs, vb, p.sv.s, 0, p.Sk, p.vec);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qa[kk], qs + wr * LD + kk * 16, LD, lane);

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  const int64_t row0 = q0 + wr + g;

  for (int it = 0; it < ntiles; ++it) {
    const int64_t k0 = static_cast<int64_t>(it) * kFwdBN;
    const uint16_t* kt = ks + (it & 1) * kFwdBN * LD;
    const uint16_t* vt = vs + (it & 1) * kFwdBN * LD;
    if (it + 1 < ntiles) {
      const int nx = (it + 1) & 1;
      load_rows<kFwdBN, D, LD>(ks + nx * kFwdBN * LD, kb, p.sk.s, k0 + kFwdBN, p.Sk, p.vec);
      load_rows<kFwdBN, D, LD>(vs + nx * kFwdBN * LD, vb, p.sv.s, k0 + kFwdBN, p.Sk, p.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[kFwdBN / 8][4];
#pragma unroll
    for (int n = 0; n < kFwdBN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kFwdBN / 16; ++np) {
        uint32_t b[4];
        load_b_nk(b, kt + np * 16 * LD + kk * 16, LD, lane);
        mma16816(s[2 * np], qa[kk], b[0], b[1]);
        mma16816(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kFwdBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t row = row0 + (e >> 1) * 8;
        const int64_t col = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale;
        if (col >= p.Sk) {
          x = -INFINITY;                          // no such key
        } else if (p.causal && col > row + p.off) {
          x = kMasked;
        }
        x *= kLog2e;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mnew = fmaxf(mrow[r], quad_max(mx[r]));
      corr[r] = exp2f(mrow[r] - mnew);
      mrow[r] = mnew;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kFwdBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(s[n][e] - mrow[e >> 1]);
        s[n][e] = pv;
        rs[e >> 1] += pv;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) lrow[r] = lrow[r] * corr[r] + rs[r];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < kFwdBN / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        load_b_kn(b, vt + kk * 16 * LD + dp * 16, LD, lane);
        mma16816(o[2 * dp], a, b[0], b[1]);
        mma16816(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  uint16_t* ob = static_cast<uint16_t*>(p.out) + bh * p.Sq * D;
  float* st = static_cast<float*>(p.stats) + bh * p.Sq * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(lrow[r]);
    const int64_t row = row0 + r * 8;
    if (row < p.Sq) {
      const float inv = 1.f / l;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(ob + row * D + i * 8 + 2 * t) =
            pack_bf16(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
      }
      if (t == 0) {
        st[row * 2] = mrow[r];
        st[row * 2 + 1] = log2f(l);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, any dtype: delta = rowsum(dO * O), one warp per query row.
template <typename T, typename Acc>
__device__ __forceinline__ Acc to_acc(T x) {
  return static_cast<Acc>(x);
}
template <>
__device__ __forceinline__ float to_acc<__nv_bfloat16, float>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(kThreads) attention_bwd_delta(AttnArgs p) {
  const int64_t bh = blockIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.Sq) return;
  const T* d = row_base_t<T>(p.dout, p.sdo, bh, p.H) + row * p.sdo.s;
  const T* o = static_cast<const T*>(p.o) + (bh * p.Sq + row) * p.D;
  Acc acc = 0;
  for (int64_t c = lane; c < p.D; c += 32) acc += to_acc<T, Acc>(d[c]) * to_acc<T, Acc>(o[c]);
  acc = warp_sum(acc);
  if (lane == 0) static_cast<Acc*>(p.delta)[bh * p.Sq + row] = acc;
}

// ---------------------------------------------------------------------------
// bf16 backward, dk and dv: one block per (batch * head, 64-key tile); each
// warp owns 16 keys; the block walks the queries 32 at a time, with the
// next chunk's q and dO copies in flight while the current one is used.
constexpr int kBwdBK = 64;
constexpr int kBwdBQ = 32;

template <int D>
struct DkdvShape {
  static constexpr int LD = D + 8;
  // K, V, Q[2], dO[2]; then stats and delta of the chunk, [2][3][BQ]
  static constexpr int kSmem = (2 * kBwdBK + 4 * kBwdBQ) * LD * 2 + 2 * 3 * kBwdBQ * 4;
};

__device__ __forceinline__ void load_row_stats(float* dst, const float* stats,
                                               const float* delta, int64_t i0, int64_t Sq) {
  for (int r = threadIdx.x; r < kBwdBQ; r += kThreads) {
    const bool in = i0 + r < Sq;
    dst[r] = in ? stats[(i0 + r) * 2] : 0.f;
    dst[kBwdBQ + r] = in ? stats[(i0 + r) * 2 + 1] : 0.f;
    dst[2 * kBwdBQ + r] = in ? delta[i0 + r] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkdv_bf16(AttnArgs p) {
  using S = DkdvShape<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ks = smem;                        // [BK][LD]
  uint16_t* vs = ks + kBwdBK * LD;            // [BK][LD]
  uint16_t* qs = vs + kBwdBK * LD;            // [2][BQ][LD]
  uint16_t* dos = qs + 2 * kBwdBQ * LD;       // [2][BQ][LD]
  float* rows = reinterpret_cast<float*>(dos + 2 * kBwdBQ * LD);   // [2][3][BQ]
  const int64_t bh = blockIdx.x;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * kBwdBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const float scale = static_cast<float>(p.scale);
  const uint16_t* qb = row_base(p.q, p.sq, bh, p.H);
  const uint16_t* db = row_base(p.dout, p.sdo, bh, p.H);
  const float* stats = static_cast<const float*>(p.stats) + bh * p.Sq * 2;
  const float* delta = static_cast<const float*>(p.delta) + bh * p.Sq;
  const int64_t qbeg = query_begin(p, j0, kBwdBQ);

  load_rows<kBwdBK, D, LD>(ks, row_base(p.k, p.sk, bh, p.H), p.sk.s, j0, p.Sk, p.vec);
  load_rows<kBwdBK, D, LD>(vs, row_base(p.v, p.sv, bh, p.H), p.sv.s, j0, p.Sk, p.vec);
  load_rows<kBwdBQ, D, LD>(qs, qb, p.sq.s, qbeg, p.Sq, p.vec);
  load_rows<kBwdBQ, D, LD>(dos, db, p.sdo.s, qbeg, p.Sq, p.vec);
  load_row_stats(rows, stats, delta, qbeg, p.Sq);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const int64_t key0 = j0 + wr + g;

  int stage = 0;
  for (int64_t i0 = qbeg; i0 < p.Sq; i0 += kBwdBQ, stage ^= 1) {
    if (i0 + kBwdBQ < p.Sq) {
      const int nx = stage ^ 1;
      load_rows<kBwdBQ, D, LD>(qs + nx * kBwdBQ * LD, qb, p.sq.s, i0 + kBwdBQ, p.Sq, p.vec);
      load_rows<kBwdBQ, D, LD>(dos + nx * kBwdBQ * LD, db, p.sdo.s, i0 + kBwdBQ, p.Sq, p.vec);
      load_row_stats(rows + nx * 3 * kBwdBQ, stats, delta, i0 + kBwdBQ, p.Sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* qt = qs + stage * kBwdBQ * LD;
    const uint16_t* dt = dos + stage * kBwdBQ * LD;
    const float* m2s = rows + stage * 3 * kBwdBQ;
    const float* lgs = m2s + kBwdBQ;
    const float* dls = lgs + kBwdBQ;
    // S^T = K_w Q^T and dP^T = V_w dO^T: 16 keys x BQ queries per warp
    float st[kBwdBQ / 8][4], dpt[kBwdBQ / 8][4];
#pragma unroll
    for (int n = 0; n < kBwdBQ / 8; ++n) {
      st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
      dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, ks + wr * LD + kk * 16, LD, lane);
      load_a(va, vs + wr * LD + kk * 16, LD, lane);
#pragma unroll
      for (int np = 0; np < kBwdBQ / 16; ++np) {
        uint32_t bq[4], bd[4];
        load_b_nk(bq, qt + np * 16 * LD + kk * 16, LD, lane);
        load_b_nk(bd, dt + np * 16 * LD + kk * 16, LD, lane);
        mma16816(st[2 * np], ka, bq[0], bq[1]);
        mma16816(st[2 * np + 1], ka, bq[2], bq[3]);
        mma16816(dpt[2 * np], va, bd[0], bd[1]);
        mma16816(dpt[2 * np + 1], va, bd[2], bd[3]);
      }
    }
    // P^T and dS^T in place of S^T and dP^T
#pragma unroll
    for (int n = 0; n < kBwdBQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t key = key0 + (e >> 1) * 8;
        const int il = n * 8 + 2 * t + (e & 1);
        const int64_t qi = i0 + il;
        float pv = 0.f, ds = 0.f;
        if (qi < p.Sq && key < p.Sk) {
          const bool masked = p.causal && key > qi + p.off;
          const float x = masked ? kMasked : st[n][e] * scale;
          pv = exp2f(x * kLog2e - m2s[il] - lgs[il]);
          ds = masked ? 0.f : pv * (dpt[n][e] - dls[il]);
        }
        st[n][e] = pv;
        dpt[n][e] = ds;
      }
    }
    // dv += P^T dO and dk += dS^T Q
#pragma unroll
    for (int kk = 0; kk < kBwdBQ / 16; ++kk) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bd[4], bq[4];
        load_b_kn(bd, dt + kk * 16 * LD + dp * 16, LD, lane);
        load_b_kn(bq, qt + kk * 16 * LD + dp * 16, LD, lane);
        mma16816(dv[2 * dp], pa, bd[0], bd[1]);
        mma16816(dv[2 * dp + 1], pa, bd[2], bd[3]);
        mma16816(dk[2 * dp], sa, bq[0], bq[1]);
        mma16816(dk[2 * dp + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  uint16_t* dkb = static_cast<uint16_t*>(p.dk) + bh * p.Sk * D;
  uint16_t* dvb = static_cast<uint16_t*>(p.dv) + bh * p.Sk * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t key = key0 + r * 8;
    if (key < p.Sk) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dkb + key * D + i * 8 + 2 * t) =
            pack_bf16(dk[i][2 * r] * scale, dk[i][2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvb + key * D + i * 8 + 2 * t) =
            pack_bf16(dv[i][2 * r], dv[i][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward, dq: one block per (batch * head, 64-query tile); each warp
// owns 16 queries; the block walks the visible keys 32 at a time, with the
// next chunk's k and v copies in flight while the current one is used.
constexpr int kDqBQ = 64;
constexpr int kDqBK = 32;

template <int D>
struct DqShape {
  static constexpr int LD = D + 8;
  static constexpr int kSmem = (2 * kDqBQ + 4 * kDqBK) * LD * 2;   // Q, dO, K[2], V[2]
};

template <int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_bf16(AttnArgs p) {
  using S = DqShape<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;                        // [BQ][LD]
  uint16_t* dos = qs + kDqBQ * LD;            // [BQ][LD]
  uint16_t* ks = dos + kDqBQ * LD;            // [2][BK][LD]
  uint16_t* vs = ks + 2 * kDqBK * LD;         // [2][BK][LD]
  const int64_t bh = blockIdx.x;
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kDqBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, wr = warp * 16;
  const float scale = static_cast<float>(p.scale);
  const uint16_t* kb = row_base(p.k, p.sk, bh, p.H);
  const uint16_t* vb = row_base(p.v, p.sv, bh, p.H);
  const int64_t kend = key_end(p, q0, kDqBQ, false);
  const int nchunks = static_cast<int>((kend + kDqBK - 1) / kDqBK);

  load_rows<kDqBQ, D, LD>(qs, row_base(p.q, p.sq, bh, p.H), p.sq.s, q0, p.Sq, p.vec);
  load_rows<kDqBQ, D, LD>(dos, row_base(p.dout, p.sdo, bh, p.H), p.sdo.s, q0, p.Sq, p.vec);
  cp_async_commit();
  if (nchunks > 0) {
    load_rows<kDqBK, D, LD>(ks, kb, p.sk.s, 0, p.Sk, p.vec);
    load_rows<kDqBK, D, LD>(vs, vb, p.sv.s, 0, p.Sk, p.vec);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    load_a(qa[kk], qs + wr * LD + kk * 16, LD, lane);
    load_a(da[kk], dos + wr * LD + kk * 16, LD, lane);
  }

  const float* stats = static_cast<const float*>(p.stats) + bh * p.Sq * 2;
  const float* delta = static_cast<const float*>(p.delta) + bh * p.Sq;
  const int64_t row0 = q0 + wr + g;
  float m2[2], lg[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + r * 8;
    const bool in = row < p.Sq;
    m2[r] = in ? stats[row * 2] : 0.f;
    lg[r] = in ? stats[row * 2 + 1] : 0.f;
    dl[r] = in ? delta[row] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int it = 0; it < nchunks; ++it) {
    const int64_t k0 = static_cast<int64_t>(it) * kDqBK;
    const uint16_t* kt = ks + (it & 1) * kDqBK * LD;
    const uint16_t* vt = vs + (it & 1) * kDqBK * LD;
    if (it + 1 < nchunks) {
      const int nx = (it + 1) & 1;
      load_rows<kDqBK, D, LD>(ks + nx * kDqBK * LD, kb, p.sk.s, k0 + kDqBK, p.Sk, p.vec);
      load_rows<kDqBK, D, LD>(vs + nx * kDqBK * LD, vb, p.sv.s, k0 + kDqBK, p.Sk, p.vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[kDqBK / 8][4], dp[kDqBK / 8][4];
#pragma unroll
    for (int n = 0; n < kDqBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kDqBK / 16; ++np) {
        uint32_t bk[4], bv[4];
        load_b_nk(bk, kt + np * 16 * LD + kk * 16, LD, lane);
        load_b_nk(bv, vt + np * 16 * LD + kk * 16, LD, lane);
        mma16816(s[2 * np], qa[kk], bk[0], bk[1]);
        mma16816(s[2 * np + 1], qa[kk], bk[2], bk[3]);
        mma16816(dp[2 * np], da[kk], bv[0], bv[1]);
        mma16816(dp[2 * np + 1], da[kk], bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kDqBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int64_t row = row0 + r * 8;
        const int64_t key = k0 + n * 8 + 2 * t + (e & 1);
        float ds = 0.f;
        if (row < p.Sq && key < p.Sk && !(p.causal && key > row + p.off)) {
          const float pv = exp2f(s[n][e] * scale * kLog2e - m2[r] - lg[r]);
          ds = pv * (dp[n][e] - dl[r]);
        }
        s[n][e] = ds;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kDqBK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dpi = 0; dpi < D / 16; ++dpi) {
        uint32_t b[4];
        load_b_kn(b, kt + kk * 16 * LD + dpi * 16, LD, lane);
        mma16816(dq[2 * dpi], a, b[0], b[1]);
        mma16816(dq[2 * dpi + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  uint16_t* dqb = static_cast<uint16_t*>(p.dq) + bh * p.Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + r * 8;
    if (row < p.Sq) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dqb + row * D + i * 8 + 2 * t) =
            pack_bf16(dq[i][2 * r] * scale, dq[i][2 * r + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 and float64: one warp per row; lane l holds elements l, l + 32,
// l + 64 and l + 96 of its row (D <= 128). Dot products are warp sums in a
// fixed order.
__device__ __forceinline__ float exp2_t(float x) { return exp2f(x); }
__device__ __forceinline__ double exp2_t(double x) { return exp2(x); }
__device__ __forceinline__ float log2_t(float x) { return log2f(x); }
__device__ __forceinline__ double log2_t(double x) { return log2(x); }
template <typename T> __device__ __forceinline__ T log2e_t();
template <> __device__ __forceinline__ float log2e_t<float>() { return kLog2e; }
template <> __device__ __forceinline__ double log2e_t<double>() { return kLog2eD; }

constexpr int kChunks = 4;

template <typename T>
__device__ __forceinline__ void load_row(T x[kChunks], const T* row, int64_t D, int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t d = lane + 32 * c;
    x[c] = d < D ? row[d] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ T row_dot(const T a[kChunks], const T* row, int64_t D, int lane) {
  T acc = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t d = lane + 32 * c;
    if (d < D) acc += a[c] * row[d];
  }
  return warp_sum(acc);
}

template <typename T>
__device__ __forceinline__ void store_row(T* row, const T x[kChunks], T mul, int64_t D,
                                          int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t d = lane + 32 * c;
    if (d < D) row[d] = x[c] * mul;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_fwd_scalar(AttnArgs p) {
  const int64_t bh = blockIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.y) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= p.Sq) return;
  const T scale = static_cast<T>(p.scale);
  const T* kb = row_base_t<T>(p.k, p.sk, bh, p.H);
  const T* vb = row_base_t<T>(p.v, p.sv, bh, p.H);
  T q[kChunks], acc[kChunks] = {0, 0, 0, 0};
  load_row(q, row_base_t<T>(p.q, p.sq, bh, p.H) + i * p.sq.s, p.D, lane);
  const int64_t kend = key_end(p, i, 1, true);
  T m = -INFINITY, l = 0;
  for (int64_t j = 0; j < kend; ++j) {
    T x = row_dot(q, kb + j * p.sk.s, p.D, lane) * scale;
    if (p.causal && j > i + p.off) x = static_cast<T>(kMasked);
    x *= log2e_t<T>();
    const T mnew = x > m ? x : m;
    const T corr = exp2_t(m - mnew), pj = exp2_t(x - mnew);
    m = mnew;
    l = l * corr + pj;
    const T* vr = vb + j * p.sv.s;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t d = lane + 32 * c;
      acc[c] = acc[c] * corr + (d < p.D ? pj * vr[d] : T(0));
    }
  }
  store_row(static_cast<T*>(p.out) + (bh * p.Sq + i) * p.D, acc, T(1) / l, p.D, lane);
  if (lane == 0) {
    T* st = static_cast<T*>(p.stats) + (bh * p.Sq + i) * 2;
    st[0] = m;
    st[1] = log2_t(l);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_scalar(AttnArgs p) {
  const int64_t bh = blockIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.y) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= p.Sq) return;
  const T scale = static_cast<T>(p.scale);
  const T* kb = row_base_t<T>(p.k, p.sk, bh, p.H);
  const T* vb = row_base_t<T>(p.v, p.sv, bh, p.H);
  T q[kChunks], d[kChunks], acc[kChunks] = {0, 0, 0, 0};
  load_row(q, row_base_t<T>(p.q, p.sq, bh, p.H) + i * p.sq.s, p.D, lane);
  load_row(d, row_base_t<T>(p.dout, p.sdo, bh, p.H) + i * p.sdo.s, p.D, lane);
  const T* st = static_cast<const T*>(p.stats) + (bh * p.Sq + i) * 2;
  const T m2 = st[0], lg = st[1], dl = static_cast<const T*>(p.delta)[bh * p.Sq + i];
  const int64_t kend = key_end(p, i, 1, false);
  for (int64_t j = 0; j < kend; ++j) {
    const T* kr = kb + j * p.sk.s;
    const T x = row_dot(q, kr, p.D, lane) * scale;
    const T dp = row_dot(d, vb + j * p.sv.s, p.D, lane);
    if (p.causal && j > i + p.off) continue;
    const T ds = exp2_t(x * log2e_t<T>() - m2 - lg) * (dp - dl);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t e = lane + 32 * c;
      if (e < p.D) acc[c] += ds * kr[e];
    }
  }
  store_row(static_cast<T*>(p.dq) + (bh * p.Sq + i) * p.D, acc, scale, p.D, lane);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkdv_scalar(AttnArgs p) {
  const int64_t bh = blockIdx.x;
  const int64_t j = static_cast<int64_t>(blockIdx.y) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (j >= p.Sk) return;
  const T scale = static_cast<T>(p.scale);
  const T* qb = row_base_t<T>(p.q, p.sq, bh, p.H);
  const T* db = row_base_t<T>(p.dout, p.sdo, bh, p.H);
  const T* st = static_cast<const T*>(p.stats) + bh * p.Sq * 2;
  const T* delta = static_cast<const T*>(p.delta) + bh * p.Sq;
  T k[kChunks], v[kChunks], dk[kChunks] = {0, 0, 0, 0}, dv[kChunks] = {0, 0, 0, 0};
  load_row(k, row_base_t<T>(p.k, p.sk, bh, p.H) + j * p.sk.s, p.D, lane);
  load_row(v, row_base_t<T>(p.v, p.sv, bh, p.H) + j * p.sv.s, p.D, lane);
  for (int64_t i = query_begin(p, j, 1); i < p.Sq; ++i) {
    const T* qr = qb + i * p.sq.s;
    const T* dr = db + i * p.sdo.s;
    const bool masked = p.causal && j > i + p.off;
    T x = row_dot(k, qr, p.D, lane) * scale;
    if (masked) x = static_cast<T>(kMasked);
    const T pv = exp2_t(x * log2e_t<T>() - st[i * 2] - st[i * 2 + 1]);
    const T dp = row_dot(v, dr, p.D, lane);
    const T ds = masked ? T(0) : pv * (dp - delta[i]);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t e = lane + 32 * c;
      if (e < p.D) {
        dv[c] += pv * dr[e];
        dk[c] += ds * qr[e];
      }
    }
  }
  store_row(static_cast<T*>(p.dk) + (bh * p.Sk + j) * p.D, dk, scale, p.D, lane);
  store_row(static_cast<T*>(p.dv) + (bh * p.Sk + j) * p.D, dv, T(1), p.D, lane);
}

// ---------------------------------------------------------------------------
// Launching.
int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const AttnArgs& a, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDelta = 1, kDkdv = 2, kDq = 3 };

template <int D>
cudaError_t launch_bf16(Which w, const AttnArgs& a, int64_t bh, void* stream) {
  switch (w) {
    case kFwd:
      return launch(attention_fwd_bf16<D>, dim3(bh, cdiv(a.Sq, kFwdBM)), FwdShape<D>::kSmem, a,
                    stream);
    case kDkdv:
      return launch(attention_bwd_dkdv_bf16<D>, dim3(bh, cdiv(a.Sk, kBwdBK)),
                    DkdvShape<D>::kSmem, a, stream);
    case kDq:
      return launch(attention_bwd_dq_bf16<D>, dim3(bh, cdiv(a.Sq, kDqBQ)), DqShape<D>::kSmem,
                    a, stream);
    default:
      return launch(attention_bwd_delta<__nv_bfloat16, float>, dim3(bh, cdiv(a.Sq, kWarps)), 0,
                    a, stream);
  }
}

template <typename T>
cudaError_t launch_scalar(Which w, const AttnArgs& a, int64_t bh, void* stream) {
  switch (w) {
    case kFwd:
      return launch(attention_fwd_scalar<T>, dim3(bh, cdiv(a.Sq, kWarps)), 0, a, stream);
    case kDkdv:
      return launch(attention_bwd_dkdv_scalar<T>, dim3(bh, cdiv(a.Sk, kWarps)), 0, a, stream);
    case kDq:
      return launch(attention_bwd_dq_scalar<T>, dim3(bh, cdiv(a.Sq, kWarps)), 0, a, stream);
    default:
      return launch(attention_bwd_delta<T, T>, dim3(bh, cdiv(a.Sq, kWarps)), 0, a, stream);
  }
}

int run(Which w, const void* q, const void* k, const void* v, const void* o, const void* dout,
        void* out, void* stats, void* delta, void* dq, void* dk, void* dv, int64_t B, int64_t H,
        int64_t Sq, int64_t Sk, int64_t D, int64_t sqb, int64_t sqh, int64_t sqs, int64_t skb,
        int64_t skh, int64_t sks, int64_t svb, int64_t svh, int64_t svs, int64_t sdb,
        int64_t sdh, int64_t sds, double scale, int causal, int dtype, int vec, void* stream) {
  const int64_t bh = B * H;
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1 || bh > 0x7fffffff || cdiv(Sq, kWarps) > 65535 ||
      cdiv(Sk, kWarps) > 65535 || dtype < 0 || dtype > 2 ||
      (D != 16 && D != 32 && D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.out = out;
  a.stats = stats;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.sq = Strides{sqb, sqh, sqs};
  a.sk = Strides{skb, skh, sks};
  a.sv = Strides{svb, svh, svs};
  a.sdo = Strides{sdb, sdh, sds};
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.off = Sk - Sq;
  a.scale = scale;
  a.causal = causal;
  a.vec = vec;
  cudaError_t e;
  if (dtype == 1) {
    e = launch_scalar<float>(w, a, bh, stream);
  } else if (dtype == 2) {
    e = launch_scalar<double>(w, a, bh, stream);
  } else {
    switch (D) {
      case 16: e = launch_bf16<16>(w, a, bh, stream); break;
      case 32: e = launch_bf16<32>(w, a, bh, stream); break;
      case 64: e = launch_bf16<64>(w, a, bh, stream); break;
      default: e = launch_bf16<128>(w, a, bh, stream); break;
    }
  }
  return static_cast<int>(e);
}

}  // namespace

// The C entry points (bound with ctypes in kernels/attention.py), one per
// kernel, all with one argument list; an entry reads only the pointers its
// kernel uses (the others may be null). Strides are in elements, in
// (batch, head, row) order; the last dimension's stride is 1. dtype: 0
// bf16, 1 float32, 2 float64. Returns the launch's cudaError_t: 0 when the
// kernel was queued on `stream`.
#define DL4J_ATTENTION_ENTRY(name, which)                                                      \
  extern "C" int name(                                                                         \
      const void* q, const void* k, const void* v, const void* o, const void* dout, void* out, \
      void* stats, void* delta, void* dq, void* dk, void* dv, int64_t B, int64_t H,            \
      int64_t Sq, int64_t Sk, int64_t D, int64_t sqb, int64_t sqh, int64_t sqs, int64_t skb,   \
      int64_t skh, int64_t sks, int64_t svb, int64_t svh, int64_t svs, int64_t sdb,            \
      int64_t sdh, int64_t sds, double scale, int causal, int dtype, int vec, void* stream) {  \
    return run(which, q, k, v, o, dout, out, stats, delta, dq, dk, dv, B, H, Sq, Sk, D, sqb,   \
               sqh, sqs, skb, skh, sks, svb, svh, svs, sdb, sdh, sds, scale, causal, dtype,    \
               vec, stream);                                                                   \
  }

DL4J_ATTENTION_ENTRY(dl4j_attention_fwd, kFwd)
DL4J_ATTENTION_ENTRY(dl4j_attention_bwd_delta, kDelta)
DL4J_ATTENTION_ENTRY(dl4j_attention_bwd_dkdv, kDkdv)
DL4J_ATTENTION_ENTRY(dl4j_attention_bwd_dq, kDq)
