// Float32 attention on Hopper's tensor cores: the dense causal forward and
// the paged prefill in 3xTF32 (one tile engine), and the paged prefill over
// an int8 cache in bf16 wgmma on exact int8 tiles (sm_90a).
//
// Not TPU kernels: XLA fused both on the TPU, with no Pallas kernel
// behind them. The entries replace
// - dl4j_attention_fwd_f32: the JAX package's scaled_dot_product_attention
//   (deeplearning4j_tpu/ops/nn_ops.py:462) in float32, which the dense
//   prefill calls (deeplearning4j_tpu/zoo/gpt.py gpt_decode_fns.prefill_fn
//   :306). The same function as attention_fwd in causal_attention.cu, with
//   the same outputs: O and, per row, the stats of its softmax in base 2
//   (stats[0] = max_j x_j log2(e) with x_j the scaled, masked score, and
//   stats[1] = log2 of sum_j 2^(x_j log2(e) - stats[0]), kept apart), which
//   the float32 backward there reads to recompute P. A fully masked row
//   (Sq > Sk) averages v.
// - dl4j_paged_prefill_f32: the paged prefill's attention over the lane's
//   block table (deeplearning4j_tpu/zoo/gpt.py gpt_paged_decode_fns
//   prefill_fn :586, :621-636), every row in one lane:
//     out[r] = sum_{t <= kmax[r]} softmax_t(q[r] . K[t] / sqrt(D)) V[t]
//     K[t]   = kc[table[t / BS], a, t % BS], and V likewise.
//   A row with kmax < 0 has no key and gets 0, as paged_attention.cu's.
//   With an int8 cache (k_scale and v_scale given, [A, D] float32: the
//   serving tier's int8 KV, zoo/gpt.py :612-628 with _q_load :581-584)
//   K[t] is float(kc_i8[...]) * k_scale[a] and V likewise, and the entry
//   launches prefill_i8_kernel (below the float engine) instead.
//
// What bounds them on an H100: at the serving shapes (12 heads of 128, a
// dense prefill of 512 rows causal; 512 rows after 256 cached keys) the
// products are 0.807 and 1.61 GFLOP on 12.6 and 15.7 MB: operations bound
// them. At the float32 FMA rate (67 TFLOP/s) that is 0.0120 and 0.0241 ms;
// the library's float32 attention multiplies in 3xTF32 on the tensor cores,
// whose rate for float32-grade products is 495 / 3 = 165 TFLOP/s: 0.0049
// and 0.0098 ms. Batch 1 with 12 heads is a small grid, and the heaviest
// causal tile of 64 rows does most of a tile column's work.
//
// Design of the float engine (a float32 cache, and the dense forward):
// - 3xTF32: each float32 operand x is split into hi = tf32(x) and lo =
//   tf32(x - hi), and a product is lo.hi + hi.lo + hi.hi, summed in float32
//   on mma.sync.m16n8k8 tf32: about 2^-21 of each product's size, against
//   a 1e-5 gate on the sum of the absolute terms. The split is integer and
//   float ops (sm90.cuh's tf32_split()), not cvt.rna.tf32, which runs on
//   the slower conversion unit. The scores' small terms go to an
//   accumulator of their own (more independent mma chains, not rounded
//   against the large).
// - A block of 4 warps takes 64 query rows (16 a warp, the mma's M) in
//   shared memory, and walks K and V tiles of BN keys (64; 32 at head dim
//   128, so that two blocks fit an SM) through a ring of two stages filled
//   by cp.async 16-byte copies. A key row's address comes from the strides
//   (dense) or through the table (paged), so a paged tile spans blocks of
//   any size with no gather copy; a key past the tile's end (its largest
//   kmax, or Sk) is never read: cp.async zero-fills its row.
// - S = Q K^T per warp in registers, the online softmax in float32 and base
//   2, then O += P V with P as the A operand straight from the scores'
//   accumulators: the k index of the PV product is permuted (logical k t
//   and t + 4 are keys 2t and 2t + 1), so the C fragment is the A fragment
//   and V's B fragment is two plain shared-memory loads, V untransposed.
// - Balance: a tile's key range is cut into work items of `chunk` keys
//   (the wrapper picks it so that the items fill the card about once), and
//   each item is a block; a tile of one item writes O, a tile of several
//   writes each item's unnormalised O, max and sum, and a second launch
//   combines them in item order. No sum uses atomics: two calls give the
//   same bits.
// - Masks by select: a key past a row's last (j > i + Sk - Sq dense, t >
//   kmax[r] paged) gets the masked score (-1e30 log2(e) dense, as the
//   reference; -inf paged) before the exponent, so its p is 0. Causal tiles
//   wholly above a warp's rows are skipped (exact: they add 0 and change no
//   maximum), and only tiles that cross a row's end are masked at all.
//
// What bounds the float engine (experiments/attention_f32_study.py times
// each choice; the numbers are in PERF.md): the arithmetic, not the loads
// (a variant that loads no key tile after the first two takes about as
// long). Each warp's 16 rows make one chain of dependent mma.sync a score
// column and a tile, with two warps an SM sub-partition to hide it;
// mma.sync tf32 runs below wgmma's rate, and one TF32 product instead of
// three saves only a quarter. wgmma's tf32 form takes B only K-major, so
// P V would need V transposed in shared memory.
//
// The int8 cache changes both facts, and prefill_i8_kernel is designed for
// it (its first design, the float engine with the int8 tiles loaded
// synchronously and dequantised into the float32 tile, is gone from the
// source; experiments/attention_f32_study.py --parent builds it):
// - An integer with |x| <= 127 is exact in bf16, so the cache's tiles are
//   exact wgmma operands, and a scale a channel moves out of the product:
//   S = (q * s_k) . K_i8 (q * s_k rounded to float32 once a row, then cut
//   into three bf16 pieces, hi + mid + lo, every difference exact: the
//   pieces carry its 24 bits) and O = (P . V_i8) * s_v (P cut into three
//   pieces the same way, s_v applied in the epilogue). Each product runs
//   on wgmma bf16, three per pair of operands, summed in float32 by the
//   tensor cores: at twice TF32's rate, and a 16-bit B tile may be
//   MN-major, so V is read untransposed.
// - The tiles are int8 in device memory (a quarter of float32's bytes) and
//   come by cp.async.bulk, a run of a block's rows one copy (a row where
//   the rows are not contiguous), into kI8Stages stages on an mbarrier
//   each (one: the next tile's copy runs under this tile's products),
//   issued by one warp; the block turns each tile into bf16 (K and V in
//   the swizzled layout the descriptors read) once it lands, and hands the
//   stage back to the copies.
// - What sets its time (experiments/attention_f32_study.py): its loads
//   and per-tile chain, not its products. With no products and no bf16
//   tiles it takes about 60% of its time at the serving shape.
// - One warpgroup takes the float engine's 64 rows, its work item and its
//   combining launch, and writes the same partials: s_v goes into a
//   partial's O, so the combine is the float engine's.
// - The online softmax is the float engine's (float32, base 2, -inf past a
//   row's last key); a row's keys are visited in order. No atomics: two
//   calls give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;     // query rows of a tile
constexpr int kChunkAlign = 64;      // a work item's keys: a multiple of this
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked2 = -1e30f * kLog2e;   // a masked score, base-2 units

template <int D>
struct Cfg {
  static constexpr int BN = D == 128 ? 32 : 64;   // keys of a K/V tile
  static constexpr int LQK = D + 8;   // q and k rows: float2 fragments conflict-free
  static constexpr int LV = D + 4;    // v rows: the B fragment's pairs of rows
  static constexpr int kQ = kBM * LQK;
  static constexpr int kK = BN * LQK;
  static constexpr int kStage = kK + BN * LV;
  static constexpr int kSmemBytes = (kQ + 2 * kStage) * 4;
};

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* stats;       // dense only, [B, H, Sq, 2]; null for the paged prefill
  float* part;        // per work item of a split tile: O [kBM][D], then (m, l) [kBM]
  const int* table;   // paged: the lane's block table [MAXB]
  const float* ksc;   // paged int8: the K and V scales [H, D]; null for a float cache
  const float* vsc;
  const int* kmax;    // paged: each row's last key [N]
  int64_t rows;       // Sq, or N
  int64_t H;          // heads (paged: A)
  int64_t Sk;         // keys (paged: the table's reach, MAXB * BS)
  int64_t off;        // dense: Sk - Sq
  int64_t qb, qh, qs; // element strides of q's batch, head and row
  int64_t kb, kh, ks; // k's batch, head, row (paged: block, head, row in block)
  int64_t vb, vh, vs;
  int64_t ob, oh, os; // out's batch, head, row
  float scale2;       // scale * log2(e)
  int BS;
  int causal;
  int chunk;          // keys a work item, a multiple of kChunkAlign
  int tiles;          // query tiles of a (batch, head)
  int ncmax;          // work items a tile at most
};

// 2^x by the SFU; a result below 2^-126 flushes to 0 (against a row sum of
// at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared; src_bytes 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
// a butterfly: every lane of the quad ends with the same bits
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The keys the query tile starting at q0 must visit: [0, end). Paged: the
// tile's largest kmax (clamped to the table's reach) plus one. Dense:
// every key for a tile that holds a fully masked row (or without a causal
// mask), else up to its last row's diagonal. Every thread of the block
// calls it (the paged form synchronises through `red`).
template <bool PAGED>
__device__ int tile_key_end(const F32Args& a, int64_t q0, int* red) {
  const int64_t rend = min(q0 + kBM, a.rows);
  if (PAGED) {
    int m = -1;
    for (int64_t r = q0 + threadIdx.x; r < rend; r += kThreads)
      m = max(m, min(a.kmax[r], static_cast<int>(a.Sk - 1)));
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, s));
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = m;
    __syncthreads();
    m = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = max(m, red[w]);
    return m + 1;
  }
  if (!a.causal || q0 + a.off < 0) return static_cast<int>(a.Sk);
  const int64_t e = rend + a.off;
  return static_cast<int>(e < 0 ? 0 : (e < a.Sk ? e : a.Sk));
}

__device__ __forceinline__ int items_of(int kend, int chunk) {
  return kend <= chunk ? 1 : (kend + chunk - 1) / chunk;
}

// The last key row `r` may see: dense i + Sk - Sq (causal; below 0 for a
// fully masked row) or Sk - 1; paged min(kmax[r], reach - 1). A row past
// the end takes the last real row's.
template <bool PAGED>
__device__ __forceinline__ int row_last_key(const F32Args& a, int64_t r) {
  r = min(r, a.rows - 1);
  if (PAGED) return min(a.kmax[r], static_cast<int>(a.Sk - 1));
  return a.causal ? static_cast<int>(r + a.off) : static_cast<int>(a.Sk - 1);
}

template <int D, bool PAGED>
__device__ __forceinline__ void load_kv(const F32Args& a, float* sk, float* sv, int j0, int kend,
                                        const float* kbase, const float* vbase) {
  using C = Cfg<D>;
  constexpr int kRow = D / 4;   // 16-byte pieces a row
  for (int idx = threadIdx.x; idx < C::BN * kRow; idx += kThreads) {
    const int r = idx / kRow, c = idx % kRow;
    const int t = j0 + r;
    const bool live = t < kend;
    const float* kp = kbase;
    const float* vp = vbase;
    if (live) {
      if (PAGED) {
        const int u = t / a.BS;
        const int64_t blk = a.table[u];
        const int64_t o = t - static_cast<int64_t>(u) * a.BS;
        kp += blk * a.kb + o * a.ks;
        vp += blk * a.vb + o * a.vs;
      } else {
        kp += static_cast<int64_t>(t) * a.ks;
        vp += static_cast<int64_t>(t) * a.vs;
      }
    }
    cp_async16(sk + r * C::LQK + c * 4, kp + c * 4, live ? 16 : 0);
    cp_async16(sv + r * C::LV + c * 4, vp + c * 4, live ? 16 : 0);
  }
}

template <int D, bool PAGED>
__global__ void __launch_bounds__(kThreads, 2) attn_f32_kernel(const F32Args a) {
  using C = Cfg<D>;
  constexpr int BN = C::BN;
  constexpr int NT = BN / 8;    // key columns of 8 in a tile
  constexpr int ND = D / 8;     // head-dim columns of 8
  extern __shared__ __align__(16) float smem[];
  __shared__ int red[kWarps];
  float* sq = smem;

  const int tile = a.tiles - 1 - static_cast<int>(blockIdx.x) / a.ncmax;  // heaviest first
  const int item = static_cast<int>(blockIdx.x) % a.ncmax;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / a.H, h = bh % a.H;
  const int64_t q0 = static_cast<int64_t>(tile) * kBM;
  const int kend = tile_key_end<PAGED>(a, q0, red);
  const int nitems = items_of(kend, a.chunk);
  if (item >= nitems) return;
  const int kbeg = item * a.chunk;
  const int kstop = min(kend, kbeg + a.chunk);
  const int ntiles = kstop > kbeg ? (kstop - kbeg + BN - 1) / BN : 0;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  // the query tile, then the first two key tiles
  const float* qbase = a.q + b * a.qb + h * a.qh;
  for (int idx = tid; idx < kBM * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), c = idx % (D / 4);
    const bool live = q0 + r < a.rows;
    cp_async16(sq + r * C::LQK + c * 4, qbase + (live ? (q0 + r) * a.qs : 0) + c * 4,
               live ? 16 : 0);
  }
  const float* kbase = a.k + (PAGED ? 0 : b * a.kb) + h * a.kh;
  const float* vbase = a.v + (PAGED ? 0 : b * a.vb) + h * a.vh;
  float* stage0 = smem + C::kQ;
  if (ntiles > 0) load_kv<D, PAGED>(a, stage0, stage0 + C::kK, kbeg, kend, kbase, vbase);
  cp_async_commit();
  if (ntiles > 1)
    load_kv<D, PAGED>(a, stage0 + C::kStage, stage0 + C::kStage + C::kK, kbeg + BN, kend, kbase,
                      vbase);
  cp_async_commit();

  // this thread's two rows (g and g + 8 of the warp's 16) and the warp's
  const int64_t ra = q0 + warp * 16 + g;
  const int lim0 = row_last_key<PAGED>(a, ra), lim1 = row_last_key<PAGED>(a, ra + 8);
  int wmin = min(lim0, lim1), wmax = max(lim0, lim1);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, s));
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, s));
  }
  const bool dense_causal = !PAGED && a.causal;
  const float mval = dense_causal ? kMasked2 : -INFINITY;
  // a tile all past the warp's rows adds nothing: skip it, unless a fully
  // masked row (which averages every key) is among them
  const bool may_skip = !dense_causal || wmin >= 0;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float* qa = sq + (warp * 16 + g) * C::LQK + 2 * t;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();
    const float* sk = smem + C::kQ + (it & 1) * C::kStage;
    const float* sv = sk + C::kK;
    const int j0 = kbeg + it * BN;
    if (!(may_skip && j0 > wmax)) {
      // S = Q K^T: s[n][0..1] row g, keys j0 + 8n + 2t (+1); [2..3] row g + 8
      float sb[NT][4], ss[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sb[n][e] = ss[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        // logical k t and t + 4 are head-dim 2t and 2t + 1 of the 8
        const float2 x0 = *reinterpret_cast<const float2*>(qa + kk * 8);
        const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * C::LQK + kk * 8);
        uint32_t ah[4], al[4];
        tf32_split(x0.x, ah[0], al[0]);
        tf32_split(x1.x, ah[1], al[1]);
        tf32_split(x0.y, ah[2], al[2]);
        tf32_split(x1.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 y =
              *reinterpret_cast<const float2*>(sk + (n * 8 + g) * C::LQK + kk * 8 + 2 * t);
          uint32_t bh_[2], bl_[2];
          tf32_split(y.x, bh_[0], bl_[0]);
          tf32_split(y.y, bh_[1], bl_[1]);
          mma_tf32(ss[n], al, bh_);
          mma_tf32(ss[n], ah, bl_);
          mma_tf32(sb[n], ah, bh_);
        }
      }
      // the online softmax, base 2
      const bool masked = j0 + BN - 1 > wmin;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = (sb[n][e] + ss[n][e]) * a.scale2;
          if (masked) {
            const int j = j0 + n * 8 + 2 * t + (e & 1);
            if (j > (e < 2 ? lim0 : lim1)) x = j >= a.Sk ? -INFINITY : mval;
          }
          sb[n][e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      // a row with no key yet keeps m = -inf: exponents against 0 give 0
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0, mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float c0 = ex2(m0 - mu0), c1 = ex2(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        sb[n][0] = ex2(sb[n][0] - mu0);
        sb[n][1] = ex2(sb[n][1] - mu0);
        sb[n][2] = ex2(sb[n][2] - mu1);
        sb[n][3] = ex2(sb[n][3] - mu1);
        ps0 += sb[n][0] + sb[n][1];
        ps1 += sb[n][2] + sb[n][3];
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }
      // O += P V: the k index t is key 8j + 2t, t + 4 is key 8j + 2t + 1
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ah[4], al[4];
        tf32_split(sb[j][0], ah[0], al[0]);
        tf32_split(sb[j][2], ah[1], al[1]);
        tf32_split(sb[j][1], ah[2], al[2]);
        tf32_split(sb[j][3], ah[3], al[3]);
        const float* v0 = sv + (j * 8 + 2 * t) * C::LV + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bh_[2], bl_[2];
          tf32_split(v0[n * 8], bh_[0], bl_[0]);
          tf32_split(v0[C::LV + n * 8], bh_[1], bl_[1]);
          mma3_tf32(o[n], ah, al, bh_, bl_);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
    if (it + 2 < ntiles) {
      float* st = smem + C::kQ + (it & 1) * C::kStage;
      load_kv<D, PAGED>(a, st, st + C::kK, j0 + 2 * BN, kend, kbase, vbase);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (nitems == 1) {
    float* ob = a.out + b * a.ob + h * a.oh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t r = ra + half * 8;
      if (r >= a.rows) continue;
      const float l = half ? l1 : l0;
      float* orow = ob + r * a.os + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float2 w;
        w.x = l > 0.f ? o[n][2 * half] / l : 0.f;     // no key: 0
        w.y = l > 0.f ? o[n][2 * half + 1] / l : 0.f;
        *reinterpret_cast<float2*>(orow + n * 8) = w;
      }
      if (!PAGED && t == 0) {
        float* st = a.stats + (bh * a.rows + r) * 2;
        st[0] = half ? m1 : m0;
        st[1] = log2f(l);
      }
    }
  } else {
    float* pb = a.part +
                ((bh * a.tiles + tile) * a.ncmax + item) * static_cast<int64_t>(kBM) * (D + 2);
    float* pml = pb + kBM * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + half * 8;
      float* prow = pb + r * D + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(prow + n * 8) = make_float2(o[n][2 * half], o[n][2 * half + 1]);
      if (t == 0) {
        pml[2 * r] = half ? m1 : m0;
        pml[2 * r + 1] = half ? l1 : l0;
      }
    }
  }
}

// The tiles cut into several work items: each row's O, max and sum from
// its items, combined in item order. A block takes kCombineRows rows of a
// tile, a thread four columns of a row at a time, so that every load is
// independent of the others.
constexpr int kCombineRows = 16;

template <int D, bool PAGED>
__global__ void __launch_bounds__(kThreads) attn_f32_combine(const F32Args a) {
  constexpr int kQuads = D / 4;
  constexpr int64_t kItem = static_cast<int64_t>(kBM) * (D + 2);
  __shared__ int red[kWarps];
  const int tile = blockIdx.x / (kBM / kCombineRows);
  const int r0 = (blockIdx.x % (kBM / kCombineRows)) * kCombineRows;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / a.H, h = bh % a.H;
  const int64_t q0 = static_cast<int64_t>(tile) * kBM;
  const int nitems = items_of(tile_key_end<PAGED>(a, q0, red), a.chunk);
  if (nitems == 1) return;   // the tile's one item wrote O
  const float* pb = a.part + (bh * a.tiles + tile) * a.ncmax * kItem;
  float* ob = a.out + b * a.ob + h * a.oh;
  for (int e = threadIdx.x; e < kCombineRows * kQuads; e += kThreads) {
    const int r = r0 + e / kQuads, c = (e % kQuads) * 4;
    if (q0 + r >= a.rows) break;
    const float* ml = pb + kBM * D + 2 * r;
    float mx = -INFINITY;
    for (int i = 0; i < nitems; ++i) mx = fmaxf(mx, ml[i * kItem]);
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mx != -INFINITY)
      for (int i = 0; i < nitems; ++i) {
        const float w = ex2(ml[i * kItem] - mx);   // 0 for an item with no key of the row
        const float4 x = *reinterpret_cast<const float4*>(pb + i * kItem + r * D + c);
        l += w * ml[i * kItem + 1];
        acc.x += w * x.x;
        acc.y += w * x.y;
        acc.z += w * x.z;
        acc.w += w * x.w;
      }
    const bool any = l > 0.f;
    *reinterpret_cast<float4*>(ob + (q0 + r) * a.os + c) =
        make_float4(any ? acc.x / l : 0.f, any ? acc.y / l : 0.f, any ? acc.z / l : 0.f,
                    any ? acc.w / l : 0.f);
    if (!PAGED && c == 0) {
      float* st = a.stats + (bh * a.rows + q0 + r) * 2;
      st[0] = mx;
      st[1] = log2f(l);
    }
  }
}

// ---------------------------------------------------------------------------
// The paged prefill over an int8 cache (the design is in the header): one
// warpgroup a block, the float engine's 64 rows, work item and partials.

// int8 K/V tiles in flight a block: one, a tile ahead of the products. At
// head dim 128 a 64-key tile and one stage keep two blocks an SM, which
// measured faster than 32-key tiles in a ring of four (or two) and than a
// ring of four 64-key tiles at one block an SM (experiments/
// attention_f32_study.py; PERF.md). The kernel keeps the ring's general
// form (an mbarrier a stage, stage it % NS, parity (it / NS) & 1) for the
// study's variants, which set kI8Stages to 2 and 4.
constexpr int kI8Stages = 1;

template <int D>
struct I8Cfg {
  static constexpr int BN = 64;                      // keys a tile: divides kChunkAlign
  static constexpr int kQ = kBM * D * 2;             // a bf16 piece of q * s_k
  static constexpr int kT = BN * D * 2;              // the bf16 K (or V) tile
  static constexpr int kStage = 2 * BN * D;          // a stage: int8 K rows, then V rows
  static constexpr int kRing = 3 * kQ + 2 * kT;      // where the stages start
  static constexpr int kBytes = 1024 + kRing + kI8Stages * kStage;   // 1024: to align
};

// The four int8 values of a word as two bf16 pairs, exactly: each byte
// biased to u in 0 .. 255 and put under 2^23's exponent (the float 2^23 +
// u), then 2^23 + 128 taken off.
__device__ __forceinline__ void i8x4_bf16(uint32_t w, uint32_t& p01, uint32_t& p23) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + e)), 8388736.f);
  p01 = bf16x2(f[0], f[1]);
  p23 = bf16x2(f[2], f[3]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) prefill_i8_kernel(const F32Args a) {
  using C = I8Cfg<D>;
  constexpr int BN = C::BN, NS = kI8Stages;
  constexpr int KS = BN / 16;   // k16 steps of P . V
  extern __shared__ __align__(16) unsigned char dyn8[];
  __shared__ int red[kWarps];
  __shared__ __align__(8) uint64_t full[NS];
  const uint32_t raw = smem_u32(dyn8), base = (raw + 1023u) & ~1023u;
  unsigned char* sm = dyn8 + (base - raw);
  // q * s_k's three pieces, the bf16 K and V tiles, the ring of int8 stages
  const uint32_t qt = base, kt = base + 3 * C::kQ, vt = kt + C::kT, ring = base + C::kRing;

  const int tile = a.tiles - 1 - static_cast<int>(blockIdx.x) / a.ncmax;  // heaviest first
  const int item = static_cast<int>(blockIdx.x) % a.ncmax;
  const int64_t h = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(tile) * kBM;
  const int kend = tile_key_end<true>(a, q0, red);
  const int nitems = items_of(kend, a.chunk);
  if (item >= nitems) return;
  const int kbeg = item * a.chunk;
  const int kstop = min(kend, kbeg + a.chunk);
  const int ntiles = kstop > kbeg ? (kstop - kbeg + BN - 1) / BN : 0;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile it (keys kbeg + BN it ..) into stage it % NS, by warp 0: lane 0
  // arrives with the bytes to expect; each run of a block's rows (each row,
  // where a block's rows do not lie one after another) is one bulk copy
  // for K and one for V. Keys past kstop are not copied (they are masked).
  const int8_t* kbase = reinterpret_cast<const int8_t*>(a.k) + h * a.kh;
  const int8_t* vbase = reinterpret_cast<const int8_t*>(a.v) + h * a.vh;
  const bool runs = a.ks == D && a.vs == D;
  auto issue = [&](int it) {
    const int j0 = kbeg + it * BN, n = min(BN, kstop - j0);
    const uint32_t bar = smem_u32(&full[it % NS]);
    const uint32_t dk = ring + (it % NS) * C::kStage, dv = dk + BN * D;
    if (lane == 0) mbar_expect_tx(bar, 2u * n * D);
    __syncwarp();
    for (int r = lane; r < n; r += 32) {
      const int key = j0 + r, u = key / a.BS, off = key - u * a.BS;
      if (runs && r > 0 && off > 0) continue;   // inside an earlier row's run
      const int len = runs ? min(a.BS - off, n - r) : 1;
      const int64_t blk = a.table[u];
      bulk_load(dk + r * D, kbase + blk * a.kb + off * a.ks, len * D, bar);
      bulk_load(dv + r * D, vbase + blk * a.vb + off * a.vs, len * D, bar);
    }
  };
  if (warp == 0)
    for (int it = 0; it < min(NS, ntiles); ++it) issue(it);

  // q * s_k, rounded once, cut into its three pieces: the A tiles of S
  const float* qb = a.q + h * a.qh;
  const float* ks = a.ksc + h * D;
  for (int idx = tid; idx < kBM * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < a.rows) x = *reinterpret_cast<const float4*>(qb + (q0 + r) * a.qs + c);
    x.x = __fmul_rn(x.x, __ldg(ks + c));
    x.y = __fmul_rn(x.y, __ldg(ks + c + 1));
    x.z = __fmul_rn(x.z, __ldg(ks + c + 2));
    x.w = __fmul_rn(x.w, __ldg(ks + c + 3));
    uint32_t p01[3], p23[3];
    split3(x.x, x.y, p01);
    split3(x.z, x.w, p23);
    const uint32_t at = swz<D, kBM>(r, c);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(sm + p * C::kQ + at) = make_uint2(p01[p], p23[p]);
  }

  // this thread's two rows (g and g + 8 of its warp's 16) and their last keys
  const int64_t ra = q0 + warp * 16 + g;
  const int lim0 = row_last_key<true>(a, ra), lim1 = row_last_key<true>(a, ra + 8);
  const int lmin = min(lim0, lim1);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int s = it % NS;
    const int j0 = kbeg + it * BN;
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((it / NS) & 1));
    __syncthreads();   // the last tile's products are done with the bf16 tiles
    // the stage's int8 rows as the bf16 K and V tiles, 16 values a thread at a time
    const unsigned char* st = sm + (ring - base) + s * C::kStage;
    for (int idx = tid; idx < 2 * BN * (D / 16); idx += kThreads) {
      const int kv = idx / (BN * (D / 16)), rem = idx % (BN * (D / 16));
      const int r = rem / (D / 16), c = (rem % (D / 16)) * 16;
      const uint4 w = *reinterpret_cast<const uint4*>(st + kv * BN * D + r * D + c);
      uint32_t b[8];
      i8x4_bf16(w.x, b[0], b[1]);
      i8x4_bf16(w.y, b[2], b[3]);
      i8x4_bf16(w.z, b[4], b[5]);
      i8x4_bf16(w.w, b[6], b[7]);
      unsigned char* tb = sm + ((kv ? vt : kt) - base);
      *reinterpret_cast<uint4*>(tb + swz<D, BN>(r, c)) = make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(tb + swz<D, BN>(r, c + 8)) = make_uint4(b[4], b[5], b[6], b[7]);
    }
    // the bf16 tiles (and q's) before the products read them; the stage's
    // reads before the next copies into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (warp == 0 && it + NS < ntiles) issue(it + NS);

    // S = (q * s_k) . K_i8: the pieces hi, mid, lo in turn, D / 16 steps each
    float sc[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BN>::ss(sc, desc_k<D, kBM>(qt + p * C::kQ, 0, kk), desc_k<D, BN>(kt, 0, kk),
                      p + kk > 0);
    wgmma_commit();
    wgmma_wait();
    keep(sc);

    // the online softmax, base 2; sc[4 j + e] is row g + 8 (e / 2), key j0
    // + 8 j + 2 t + e % 2
    const bool edge = j0 + BN - 1 > lmin;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * a.scale2;
        if (edge && j0 + 8 * j + 2 * t + (e & 1) > (e < 2 ? lim0 : lim1)) x = -INFINITY;
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mu[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      // a row with no key yet keeps m = -inf: exponents against 0 give 0
      mu[r] = mn == -INFINITY ? 0.f : mn;
      corr[r] = ex2(m[r] - mu[r]);
      m[r] = mn;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      sc[i] = ex2(sc[i] - mu[(i >> 1) & 1]);
      ps[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + ps[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P . V_i8: P's pieces as the A fragments of each k16 step (keys
    // 16 kk + 2 t (+1) and + 8 of rows g and g + 8), V read MN-major
    uint32_t pa[3][KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        uint32_t pc[3];
        split3(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1], pc);
#pragma unroll
        for (int p = 0; p < 3; ++p) pa[p][kk][f] = pc[p];
      }
    keep(o);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) Wgmma<D>::rs(o, pa[p][kk], desc_mn<D, BN>(vt, kk));
    wgmma_commit();
    wgmma_wait();
    keep(o);
    keep(pa);
  }

  // s_v times the sums: O (one work item) or the item's partial
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const float* vs = a.vsc + h * D;
  if (nitems == 1) {
    float* ob = a.out + h * a.oh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t r = ra + half * 8;
      if (r >= a.rows) continue;
      const float lr = l[half];
      float* orow = ob + r * a.os + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * t;
        float2 w;
        w.x = lr > 0.f ? o[4 * n + 2 * half] * __ldg(vs + col) / lr : 0.f;   // no key: 0
        w.y = lr > 0.f ? o[4 * n + 2 * half + 1] * __ldg(vs + col + 1) / lr : 0.f;
        *reinterpret_cast<float2*>(orow + n * 8) = w;
      }
    }
  } else {
    float* pb = a.part +
                ((h * a.tiles + tile) * a.ncmax + item) * static_cast<int64_t>(kBM) * (D + 2);
    float* pml = pb + kBM * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + half * 8;
      float* prow = pb + r * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * t;
        *reinterpret_cast<float2*>(prow + n * 8) =
            make_float2(o[4 * n + 2 * half] * __ldg(vs + col),
                        o[4 * n + 2 * half + 1] * __ldg(vs + col + 1));
      }
      if (t == 0) {
        pml[2 * r] = m[half];
        pml[2 * r + 1] = l[half];
      }
    }
  }
}

// The main kernel's shared memory raised past 48 KB on the current device,
// once per device: a kernel's attributes belong to each device's context.
template <int D, bool PAGED>
cudaError_t configure() {
  static std::mutex mu;
  static std::set<int> raised;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  if (raised.count(dev) != 0) return cudaSuccess;
  e = cudaFuncSetAttribute(attn_f32_kernel<D, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Cfg<D>::kSmemBytes);
  if (e == cudaSuccess) raised.insert(dev);
  return e;
}

template <int D, bool PAGED>
int launch(const F32Args& a, int64_t BH, cudaStream_t st) {
  const cudaError_t attr = configure<D, PAGED>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  attn_f32_kernel<D, PAGED>
      <<<dim3(static_cast<unsigned>(a.tiles * a.ncmax), static_cast<unsigned>(BH)), kThreads,
         Cfg<D>::kSmemBytes, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.ncmax == 1) return static_cast<int>(err);
  attn_f32_combine<D, PAGED><<<dim3(static_cast<unsigned>(a.tiles * (kBM / kCombineRows)),
                                     static_cast<unsigned>(BH)),
                                kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool PAGED>
int launch_d(int64_t D, const F32Args& a, int64_t BH, cudaStream_t st) {
  switch (D) {
    case 16: return launch<16, PAGED>(a, BH, st);
    case 32: return launch<32, PAGED>(a, BH, st);
    case 64: return launch<64, PAGED>(a, BH, st);
    case 128: return launch<128, PAGED>(a, BH, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The int8 cache's kernel: its shared memory raised once per device, as
// configure()'s; then the launch and, for a split tile, the float engine's
// combining launch.
template <int D>
cudaError_t configure_i8() {
  static std::mutex mu;
  static std::set<int> raised;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  if (raised.count(dev) != 0) return cudaSuccess;
  e = cudaFuncSetAttribute(prefill_i8_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           I8Cfg<D>::kBytes);
  if (e == cudaSuccess) raised.insert(dev);
  return e;
}

template <int D>
int launch_i8(const F32Args& a, int64_t BH, cudaStream_t st) {
  const cudaError_t attr = configure_i8<D>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  prefill_i8_kernel<D>
      <<<dim3(static_cast<unsigned>(a.tiles * a.ncmax), static_cast<unsigned>(BH)), kThreads,
         I8Cfg<D>::kBytes, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.ncmax == 1) return static_cast<int>(err);
  attn_f32_combine<D, true><<<dim3(static_cast<unsigned>(a.tiles * (kBM / kCombineRows)),
                                   static_cast<unsigned>(BH)),
                              kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_i8_d(int64_t D, const F32Args& a, int64_t BH, cudaStream_t st) {
  switch (D) {
    case 16: return launch_i8<16>(a, BH, st);
    case 32: return launch_i8<32>(a, BH, st);
    case 64: return launch_i8<64>(a, BH, st);
    case 128: return launch_i8<128>(a, BH, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Fills the work split; 0, or cudaErrorInvalidValue for a chunk that is not
// a positive multiple of kChunkAlign or a partials buffer that is too small.
int plan(F32Args& a, int64_t BH, int64_t D, int64_t chunk, int64_t part_floats) {
  if (chunk < kChunkAlign || chunk % kChunkAlign != 0 || chunk > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  a.chunk = static_cast<int>(chunk);
  a.tiles = static_cast<int>((a.rows + kBM - 1) / kBM);
  a.ncmax = static_cast<int>((a.Sk + chunk - 1) / chunk);
  if (a.ncmax < 1) a.ncmax = 1;
  if (a.ncmax > 1 && (a.part == nullptr ||
                      part_floats < BH * a.tiles * a.ncmax * static_cast<int64_t>(kBM) * (D + 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int D, bool PAGED>
int occupancy(int* blocks) {
  const cudaError_t e = configure<D, PAGED>();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, attn_f32_kernel<D, PAGED>, kThreads, Cfg<D>::kSmemBytes));
}

template <int D>
int occupancy_i8(int* blocks) {
  const cudaError_t e = configure_i8<D>();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, prefill_i8_kernel<D>, kThreads, I8Cfg<D>::kBytes));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// dl4j_attention_f32_blocks_per_sm's kinds (attention_f32.KINDS)
enum Kind { kDense = 0, kPaged = 1, kPagedI8 = 2 };

}  // namespace

// The main kernel's resident blocks an SM at head dim D, as launched, for
// kind 0 the dense forward, 1 the paged prefill over a float32 cache, 2
// the paged prefill over an int8 cache (prefill_i8_kernel). Written to
// *blocks; returns the cudaError_t.
extern "C" int dl4j_attention_f32_blocks_per_sm(int64_t D, int kind, int* blocks) {
  if (kind == kPagedI8) {
    switch (D) {
      case 16: return occupancy_i8<16>(blocks);
      case 32: return occupancy_i8<32>(blocks);
      case 64: return occupancy_i8<64>(blocks);
      case 128: return occupancy_i8<128>(blocks);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (kind != kDense && kind != kPaged) return static_cast<int>(cudaErrorInvalidValue);
  switch (D * 2 + (kind == kPaged)) {
    case 32: return occupancy<16, false>(blocks);
    case 33: return occupancy<16, true>(blocks);
    case 64: return occupancy<32, false>(blocks);
    case 65: return occupancy<32, true>(blocks);
    case 128: return occupancy<64, false>(blocks);
    case 129: return occupancy<64, true>(blocks);
    case 256: return occupancy<128, false>(blocks);
    case 257: return occupancy<128, true>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v [B, H, S, D] float32 at element strides (b, h, s, 1), each a
// multiple of 4 and each base on 16 bytes; out [B, H, Sq, D] and stats
// [B, H, Sq, 2] contiguous; part: scratch of part_floats floats (the
// wrapper's attention_f32.partial_floats). chunk: keys a work item.
// Returns the launch's cudaError_t.
extern "C" int dl4j_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* out, void* stats, void* part,
    int64_t part_floats, int64_t B, int64_t H, int64_t Sq, int64_t Sk, int64_t D, int64_t sqb,
    int64_t sqh, int64_t sqs, int64_t skb, int64_t skh, int64_t sks, int64_t svb, int64_t svh,
    int64_t svs, double scale, int causal, int64_t chunk, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (Sk <= 0 || B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  F32Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.stats = static_cast<float*>(stats);
  a.part = static_cast<float*>(part);
  a.rows = Sq;
  a.H = H;
  a.Sk = Sk;
  a.off = Sk - Sq;
  a.qb = sqb, a.qh = sqh, a.qs = sqs;
  a.kb = skb, a.kh = skh, a.ks = sks;
  a.vb = svb, a.vh = svh, a.vs = svs;
  a.ob = H * Sq * D, a.oh = Sq * D, a.os = D;
  a.scale2 = static_cast<float>(scale * 1.4426950408889634);
  a.BS = 1;
  a.causal = causal != 0;
  const int err = plan(a, B * H, D, chunk, part_floats);
  if (err != 0) return err;
  return launch_d<false>(D, a, B * H, static_cast<cudaStream_t>(stream));
}

// q [N, A, D] float32 at strides (sqn, sqa, 1); kc, vc one layer's
// [num_blocks, A, BS, D] at strides (skb, ska, skt, 1) and (svb, sva, svt,
// 1), float32 with strides multiples of 4, or int8 (k_scale and v_scale
// [A, D] float32 contiguous given; nullptr for float32: the int8 kernel)
// with strides multiples of 16, bases on 16 bytes; table [MAXB] and kmax
// [N] int32 contiguous; out [N, A, D] contiguous; part, part_floats and
// chunk as above. Returns the launch's cudaError_t.
extern "C" int dl4j_paged_prefill_f32(
    const void* q, const void* kc, const void* vc, const void* k_scale, const void* v_scale,
    const void* table, const void* kmax, void* out, void* part, int64_t part_floats, int64_t N, int64_t A, int64_t D, int64_t BS,
    int64_t MAXB, int64_t sqn, int64_t sqa, int64_t skb, int64_t ska, int64_t skt, int64_t svb,
    int64_t sva, int64_t svt, double scale, int64_t chunk, void* stream) {
  if (N <= 0 || A <= 0) return 0;
  if (BS < 1 || MAXB < 1 || A > 65535 || BS * MAXB > (1 << 30) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the int8 kernel's bulk copies: rows on 16 bytes
  if (k_scale != nullptr && (!aligned16(kc) || !aligned16(vc) ||
                             (skb | ska | skt | svb | sva | svt) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  F32Args a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(kc);
  a.v = static_cast<const float*>(vc);
  a.out = static_cast<float*>(out);
  a.part = static_cast<float*>(part);
  a.table = static_cast<const int*>(table);
  a.kmax = static_cast<const int*>(kmax);
  a.ksc = static_cast<const float*>(k_scale);
  a.vsc = static_cast<const float*>(v_scale);
  a.rows = N;
  a.H = A;
  a.Sk = BS * MAXB;
  a.qb = 0, a.qh = sqa, a.qs = sqn;
  a.kb = skb, a.kh = ska, a.ks = skt;
  a.vb = svb, a.vh = sva, a.vs = svt;
  a.ob = 0, a.oh = D, a.os = A * D;
  a.scale2 = static_cast<float>(scale * 1.4426950408889634);
  a.BS = static_cast<int>(BS);
  a.causal = 0;
  const int err = plan(a, A, D, chunk, part_floats);
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return k_scale != nullptr ? launch_i8_d(D, a, A, st) : launch_d<true>(D, a, A, st);
}
