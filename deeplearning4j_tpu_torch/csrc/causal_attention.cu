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
// Three launches, no atomic sums: delta; dk and dv over the key tiles,
// each looping over the query tiles; dq over the query tiles, each looping
// over the key tiles. Every sum runs in a fixed order: two calls are
// bit-equal.
//
// Types: bf16 (the main path: wgmma tensor cores fed by TMA, float32
// accumulation, P and dS rounded to bf16 before their products, as the
// reference rounds P before P . v), float32 and float64 (one warp per row,
// scalar FMAs: the card-against-CPU checks). D in {16, 32, 64, 128}.
//
// What bounds it: at GPT-medium's shape (16 x 12 heads x 512 x 128, causal)
// one forward is 12.9 GFLOP of products (0.013 ms at 989 TFLOP/s) on 100
// MB of q, k, v and O (0.030 ms at 3.35 TB/s), so the least time is set by
// the bytes; the backward's kernels likewise. What held the first design
// (mma.sync, 4 warps, 64-row tiles, cp.async; ~110 TFLOP/s, 2x slower than
// PyTorch's fused attention) to 4-6x that bound: every warp reloaded every
// K and V fragment from shared memory with its own ldmatrix, mma.sync tops
// out well under Hopper's tensor-core rate, only 8 warps fit an SM, and
// each block's prologue and scalar epilogue were a large share of its time.
// What bounds this design (ablations in PERF.md): each consumer warpgroup
// runs its scores' product, softmax and second product in turn, so the
// tensor cores wait while the softmax (and the tile loads behind it) run;
// overlapping them would need more registers than the compiler gives a
// consumer thread here (168: setmaxnreg moves the registers at run time
// but did not raise ptxas's budget).
//
// What this design does (the bf16 kernels):
// - Persistent, warp specialised blocks of three warpgroups, one per SM.
//   Work items (a 128-query tile, or a 64-key tile for dk and dv, of one
//   head) come in order from an atomic counter, the launch's own (the
//   wrapper keeps one per stream), which schedules and sums nothing: a
//   head's tiles together, so that K and V (q and dO) are read from device
//   memory about once, the heaviest causal tile first. In the producer
//   warpgroup one thread loads an item's resident tiles into one of two
//   buffers, so the next item's load overlaps this one's work, and keeps a
//   ring of streamed tiles in flight, with full and empty mbarriers for
//   each.
// - Tiles land in shared memory through 4-D tensor maps (D, S, H, B) built
//   from each tensor's own strides, swizzled at the row's width (32, 64 or
//   128 bytes; D = 128 is two 64-column blocks), so that build_gpt's split
//   views of one projection need no copy and wgmma reads them without bank
//   conflicts. The wrapper copies a view whose base or strides are not
//   16-byte multiples first (TMA's rule) and counts the copy.
// - Products are wgmma.mma_async m64nNk16 with both operands in shared
//   memory (K-major descriptors) for the scores, and with P or dS as the
//   register A operand for the second product (the float32 accumulator
//   fragment packs into the A fragment element for element), its B operand
//   MN-major through the descriptor's transpose bit: V for O, dO and q for
//   dv and dk, k for dq. The scores never leave registers.
// - dk and dv: the two consumer warpgroups share 64 keys and split the
//   products (P^T and dv; dP^T, dS^T and dk), handing P^T over through
//   shared memory, so that each holds one accumulator and none spills.
// - Causal tiles above the diagonal are skipped: a masked score adds
//   2^(-1.4e30) = 0 to a row that has a visible key, so skipping is exact.
//   A query tile holding a fully masked row (Sq > Sk) visits every key.
//   Only tiles that cross the diagonal or the sequence's end are masked,
//   by selects (a branch an element cost more than the products).
//   TMA zero-fills rows past the end; their scores are set to -inf.
// - Outputs go through shared memory (the warpgroup's own rows of its
//   resident tile, in the same swizzle) and 16-byte coalesced stores.
// - The wrapper allocates every output; nothing here allocates, and every
//   launch goes on PyTorch's current stream. The tensor maps are encoded
//   on the host per call (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint: the library does not link libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr double kLog2eD = 1.4426950408889634;
constexpr float kMasked = -1e30f;
constexpr float kMasked2 = kMasked * kLog2e;   // a masked score in base-2 units

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
  int* work;          // bf16 forward, dk/dv, dq: this launch's work counter
};

// The bf16 kernels' argument: the tensor maps of q, k, v and dO (each read
// at its own strides; a kernel uses those it needs), and the rest.
struct TmaArgs {
  CUtensorMap tq, tk, tv, tdo;
  AttnArgs a;
  int items;   // work items: (tile, batch * head), a head's tiles together
};

template <typename T>
__device__ __forceinline__ const T* row_base_t(const void* p, const Strides& s, int64_t bh,
                                               int64_t H) {
  return static_cast<const T*>(p) + (bh / H) * s.b + (bh % H) * s.h;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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

// 2^x by the SFU (ex2.approx.ftz: denormal results flush to 0, which
// bf16's P and dS lose anyway); exp2f adds a denormal range fix around it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// Hopper primitives beside sm90.cuh's: TMA loads, the register hand-off.

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// Hand the producer warpgroup's registers to the consumer warpgroups. A
// 384-thread block gets 168 registers a thread; the two consumer
// warpgroups run at 240 (dk and dv at D = 128 hold 128 accumulator
// registers a thread), the producer at 24. One block fills an SM's
// registers, so the consumers' request is always met. Each runs once, at
// the top of its role's branch; the branches never meet again.
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Rows [r0, r0 + R) of (batch b, head h)'s slab into the tile at `dst`.
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap& m, uint32_t bar,
                                          int64_t r0, int h, int b) {
  using G = Geo<D>;
#pragma unroll
  for (int c = 0; c < G::NB; ++c)
    tma_load(dst + c * R * G::RB, &m, bar, c * G::CB, static_cast<int>(r0), h, b);
}

// A warpgroup's 64 x D accumulator, times mul[0] (rows g) and mul[1]
// (rows g + 8), rounded to bf16 into tile rows [row0, row0 + 64).
template <int D, int R>
__device__ __forceinline__ void stage_acc(uint8_t* tile, const float (&acc)[D / 2],
                                          const float (&mul)[2], int row0, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(tile + swz<D, R>(row0 + 8 * r, 8 * j + 2 * t)) =
          pack_bf16(acc[4 * j + 2 * r] * mul[r], acc[4 * j + 2 * r + 1] * mul[r]);
}

// Tile rows [row0, row0 + 64) to rows [g0, g0 + 64) of the contiguous
// [S, D] slab `dst`, those below S, 16 bytes a thread (one warpgroup).
template <int D, int R>
__device__ __forceinline__ void store_rows(uint16_t* dst, const uint8_t* tile, int row0,
                                           int64_t g0, int64_t S, int tid) {
  constexpr int CH = D / 8;
  for (int i = tid; i < 64 * CH; i += 128) {
    const int r = i / CH, c = i % CH;
    if (g0 + r < S)
      *reinterpret_cast<uint4*>(dst + (g0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<D, R>(row0 + r, c * 8));
  }
}

constexpr int kConsumers = 2;                          // warpgroups of 64 rows
constexpr int kWsThreads = (kConsumers + 1) * 128;     // + the producer warpgroup
constexpr int kMaxStages = 4;   // mbarrier slots: a kernel's ring has at most this many stages

// The warp-specialised block's shared memory: two buffers of the resident
// tiles (a work item's and the next one's), the ring of streamed tiles
// (ST stages of `Stage` bytes), `Extra` bytes, then the mbarriers:
// resident buffer b
// full (b) and free (2 + b), each stage full and empty; 1024 bytes of slack
// to align the start.
template <int Resident, int ST, int Stage, int Extra = 0>
struct Smem {
  static_assert(ST <= kMaxStages, "ring too deep");
  static constexpr int kRing = 2 * Resident;
  static constexpr int kExtra = kRing + ST * Stage;   // `Extra` bytes of the kernel's own
  static constexpr int kBars = kExtra + Extra;
  static constexpr int kBytes = 1024 + kBars + 8 * (5 + 2 * kMaxStages);
};

__device__ __forceinline__ uint32_t res_full(uint32_t bars, int b) { return bars + 8 * b; }
__device__ __forceinline__ uint32_t res_free(uint32_t bars, int b) { return bars + 8 * (2 + b); }
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, int s) { return bars + 8 * (4 + s); }
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, int s) {
  return bars + 8 * (4 + kMaxStages + s);
}
__device__ __forceinline__ uint32_t item_slot(uint32_t bars, int b) {
  return bars + 8 * (4 + 2 * kMaxStages) + 4 * b;
}

// Work items are handed out in order by an atomic counter, so that a block
// that drew light items draws more, and the blocks at work at one time
// share a head's K and V (or q and dO) in L2. The counter schedules only:
// which block computes an item changes no sum. It is the launch's own pair
// of ints (next item, blocks done), zero when the launch starts; the block
// that runs out last sets it back to zero. The wrapper keeps one pair per
// stream: launches on one stream run one after another, and launches on two
// streams never share a pair.
__device__ __forceinline__ int next_item(int* work, int items) {
  const int w = atomicAdd(&work[0], 1);
  if (w < items) return w;
  if (atomicAdd(&work[1], 1) == static_cast<int>(gridDim.x) - 1) {
    atomicExch(&work[0], 0);
    atomicExch(&work[1], 0);
  }
  return -1;
}

// The producer publishes work item w (-1: none left) of the block's n-th
// resident buffer use; the consumers read it once the buffer is full.
__device__ __forceinline__ void publish_item(uint8_t* sm, uint32_t base, uint32_t bars, int n,
                                             int w) {
  *reinterpret_cast<volatile int*>(sm + (item_slot(bars, n & 1) - base)) = w;
  if (w < 0) mbar_arrive(res_full(bars, n & 1));
}
__device__ __forceinline__ int read_item(const uint8_t* sm, uint32_t base, uint32_t bars, int n) {
  return *reinterpret_cast<const volatile int*>(sm + (item_slot(bars, n & 1) - base));
}

// Thread 0 sets the barriers up: a full barrier takes one arrival (the
// producer's, with the bytes to expect), a free or empty barrier one per
// consumer warpgroup.
template <int ST>
__device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(res_full(bars, b), 1);
      mbar_init(res_free(bars, b), kConsumers);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_bar(bars, s), 1);
      mbar_init(empty_bar(bars, s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer's wait for ring stage `g % ST` (g counts the tiles it has
// streamed) to be free again.
template <int ST>
__device__ __forceinline__ void wait_free(uint32_t bars, int g) {
  if (g >= ST) mbar_wait(empty_bar(bars, g % ST), ((g / ST) & 1) ^ 1);
}

// The producer's wait for resident buffer n & 1 to be free for work item n
// (the CTA's n-th), and the consumers' wait for it to be loaded.
__device__ __forceinline__ void wait_res_free(uint32_t bars, int n) {
  if (n >= 2) mbar_wait(res_free(bars, n & 1), ((n >> 1) & 1) ^ 1);
}
__device__ __forceinline__ void wait_res_full(uint32_t bars, int n) {
  mbar_wait(res_full(bars, n & 1), (n >> 1) & 1);
}

// A consumer warpgroup is done with resident buffer n & 1, its staging
// included: order its generic accesses before the next TMA writes there.
__device__ __forceinline__ void release_res(uint32_t bars, int n, int wg, int tid) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + wg, 128);
  if (tid == 0) mbar_arrive(res_free(bars, n & 1));
}

// Scale one 64 x N score fragment to base-2 units (scale2 = scale * log2 e)
// and, on a tile that crosses the causal diagonal or the last key (`edge`),
// mask it: -inf past the last key (sk), -1e30 log2 e above the diagonal
// (past key lim[r] for the rows g + 8r). The fragment's columns are c0 + 8j
// + (e & 1). Selects, no branches: a mask costs a compare and a select.
template <int N>
__device__ __forceinline__ void mask_scores(float (&s)[N / 2], const int (&lim)[2], int c0, int sk,
                                            float scale2, bool edge) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 8 * j + (e & 1);
        const float x = s[4 * j + e] * scale2;
        s[4 * j + e] = c >= sk ? -INFINITY : c > lim[e >> 1] ? kMasked2 : x;
      }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] *= scale2;
  }
}

// The m16n8k16 A fragments of a 64 x N accumulator, one per k16 step.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------------------
// bf16 forward, persistent: one block per SM takes work items (128-query
// tile, batch * head) from the counter, a head's heaviest causal tile
// first. The producer loads
// an item's query tile (into the resident buffer the item before last
// freed, so the next item's load overlaps this one's work) and streams its
// visible K and V tiles (BN keys) through the ring; each consumer warpgroup
// runs the online softmax over its 64 rows.
template <int D>
struct FwdCfg {
  static constexpr int BM = 128, BN = 128, ST = 2;
  static constexpr int kQ = BM * D * 2, kKV = BN * D * 2;
  using S = Smem<kQ, ST, 2 * kKV>;
};

// Work item w of a query-tile kernel: (batch * head, first query row), a
// head's tiles together, its heaviest causal tile first.
__device__ __forceinline__ void query_item(const AttnArgs& a, int w, int BM, int64_t& bh,
                                           int64_t& q0) {
  const int nq = static_cast<int>((a.Sq + BM - 1) / BM);
  bh = w / nq;
  q0 = static_cast<int64_t>(nq - 1 - w % nq) * BM;
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    attention_fwd_bf16(const __grid_constant__ TmaArgs p) {
  using C = FwdCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, ST = C::ST;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t ring = base + C::S::kRing, bars = base + C::S::kBars;
  const AttnArgs& a = p.a;
  const int warp = threadIdx.x / 32;
  init_bars<ST>(bars);

  if (warp >= kConsumers * 4) {   // producer warpgroup: one thread issues the loads
    producer_regs();
    if (threadIdx.x == kConsumers * 128) {
      int g = 0;   // K/V tiles streamed
      for (int n = 0;; ++n) {
        wait_res_free(bars, n);
        const int w = next_item(a.work, p.items);
        publish_item(sm, base, bars, n, w);
        if (w < 0) break;
        int64_t bh, q0;
        query_item(a, w, BM, bh, q0);
        const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
        const int ntiles = static_cast<int>((key_end(a, q0, BM, true) + BN - 1) / BN);
        const uint32_t rf = res_full(bars, n & 1);
        mbar_expect_tx(rf, C::kQ);
        load_tile<D, BM>(base + (n & 1) * C::kQ, p.tq, rf, q0, h, b);
        for (int it = 0; it < ntiles; ++it, ++g) {
          wait_free<ST>(bars, g);
          const uint32_t fb = full_bar(bars, g % ST), kt = ring + (g % ST) * 2 * C::kKV;
          mbar_expect_tx(fb, 2 * C::kKV);
          load_tile<D, BN>(kt, p.tk, fb, static_cast<int64_t>(it) * BN, h, b);
          load_tile<D, BN>(kt + C::kKV, p.tv, fb, static_cast<int64_t>(it) * BN, h, b);
        }
      }
    }
  } else {
    consumer_regs();
    const int wg = warp / 4, tid = threadIdx.x % 128, lane = threadIdx.x % 32;
    const int t = lane & 3, rlo = wg * 64 + (warp % 4) * 16 + (lane >> 2);   // tile row of g
    const float scale2 = static_cast<float>(a.scale) * kLog2e;
    const int sk = static_cast<int>(a.Sk), off = static_cast<int>(a.off);
    int g = 0;   // K/V tiles consumed
    for (int n = 0;; ++n) {
      wait_res_full(bars, n);
      const int w = read_item(sm, base, bars, n);
      if (w < 0) break;
      int64_t bh, q0;
      query_item(a, w, BM, bh, q0);
      const int ntiles = static_cast<int>((key_end(a, q0, BM, true) + BN - 1) / BN);
      const uint32_t qs = base + (n & 1) * C::kQ;
      const int64_t row0 = q0 + rlo;
      // the last key rows g and g + 8 (and the warpgroup's first row) may see
      const int lim[2] = {a.causal ? static_cast<int>(row0) + off : INT_MAX,
                          a.causal ? static_cast<int>(row0) + 8 + off : INT_MAX};
      const int lim_lo = a.causal ? static_cast<int>(q0) + wg * 64 + off : INT_MAX;
      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

      for (int it = 0; it < ntiles; ++it, ++g) {
        const int s = g % ST;
        const int64_t k0 = static_cast<int64_t>(it) * BN;
        const uint32_t kt = ring + s * 2 * C::kKV, vt = kt + C::kKV;
        mbar_wait(full_bar(bars, s), (g / ST) & 1);
        float sc[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BN>::ss(sc, desc_k<D, BM>(qs, wg * 64, kk), desc_k<D, BN>(kt, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait();
        keep(sc);
        // mask only the tiles that cross the diagonal or the last key
        const bool edge = k0 + BN > sk || k0 + BN - 1 > lim_lo;
        mask_scores<BN>(sc, lim, static_cast<int>(k0) + 2 * t, sk, scale2, edge);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mnew = fmaxf(mrow[r], quad_max(mx[r]));
          corr[r] = ex2(mrow[r] - mnew);
          mrow[r] = mnew;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int r = (i >> 1) & 1;
          sc[i] = ex2(sc[i] - mrow[r]);
          rs[r] += sc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) lrow[r] = lrow[r] * corr[r] + rs[r];
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {   // a new max
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
        }
        uint32_t pa[BN / 16][4];
        to_a<BN>(pa, sc);
        keep(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) Wgmma<D>::rs(o, pa[kk], desc_mn<D, BN>(vt, kk));
        wgmma_commit();
        wgmma_wait();
        keep(o);
        keep(pa);
        if (tid == 0) mbar_arrive(empty_bar(bars, s));
      }

      // O = o / l through this warpgroup's rows of the query tile; stats.
      float inv[2];
      float* st = static_cast<float*>(a.stats) + bh * a.Sq * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l = quad_sum(lrow[r]);
        inv[r] = 1.f / l;
        const int64_t row = row0 + 8 * r;
        if (t == 0 && row < a.Sq) {
          st[row * 2] = mrow[r];
          st[row * 2 + 1] = log2f(l);
        }
      }
      uint8_t* qsm = sm + (n & 1) * C::kQ;
      stage_acc<D, BM>(qsm, o, inv, rlo, t);
      named_sync(1 + wg, 128);
      store_rows<D, BM>(static_cast<uint16_t*>(a.out) + bh * a.Sq * D, qsm, wg * 64,
                        q0 + wg * 64, a.Sq, tid);
      release_res(bars, n, wg, tid);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: delta = rowsum(dO * O). float32 and float64: one warp per
// query row, in the row's dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads) attention_bwd_delta(AttnArgs p) {
  const int64_t bh = blockIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.Sq) return;
  const T* d = row_base_t<T>(p.dout, p.sdo, bh, p.H) + row * p.sdo.s;
  const T* o = static_cast<const T*>(p.o) + (bh * p.Sq + row) * p.D;
  T acc = 0;
  for (int64_t c = lane; c < p.D; c += 32) acc += d[c] * o[c];
  acc = warp_sum(acc);
  if (lane == 0) static_cast<T*>(p.delta)[bh * p.Sq + row] = acc;
}

// bf16: D / 8 threads a row, 16 bytes of dO and of O each (the wrapper
// puts every row of dO on 16 bytes), summed in float32 across the row's
// threads in a fixed order.
template <int D>
__global__ void __launch_bounds__(kThreads) attention_bwd_delta_bf16(AttnArgs p) {
  constexpr int TPR = D / 8, RPB = kThreads / TPR;   // threads a row, rows a block
  const int64_t bh = blockIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.y) * RPB + threadIdx.x / TPR;
  const int c = (threadIdx.x % TPR) * 8;
  float acc = 0.f;
  if (row < p.Sq) {
    const uint4 dv = *reinterpret_cast<const uint4*>(
        row_base_t<__nv_bfloat16>(p.dout, p.sdo, bh, p.H) + row * p.sdo.s + c);
    const uint4 ov = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.o) + (bh * p.Sq + row) * D + c);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(d2[i]), b = __bfloat1622float2(o2[i]);
      acc += a.x * b.x + a.y * b.y;
    }
  }
#pragma unroll
  for (int m = TPR / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < p.Sq && threadIdx.x % TPR == 0) static_cast<float*>(p.delta)[bh * p.Sq + row] = acc;
}


// ---------------------------------------------------------------------------
// bf16 backward, dq, persistent like the forward: work items (128-query
// tile, batch * head), a head's heaviest causal tile first. The producer loads
// an item's q and dO tiles and streams its visible K and V tiles (BK keys);
// each consumer warpgroup recomputes S and dP for its 64 rows, then
// dq += dS k.
template <int D>
struct DqCfg {
  static constexpr int BM = 128, BK = 64, ST = 3;
  static constexpr int kQ = BM * D * 2, kKV = BK * D * 2;
  using S = Smem<2 * kQ, ST, 2 * kKV>;
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    attention_bwd_dq_bf16(const __grid_constant__ TmaArgs p) {
  using C = DqCfg<D>;
  constexpr int BM = C::BM, BK = C::BK, ST = C::ST;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t ring = base + C::S::kRing, bars = base + C::S::kBars;
  const AttnArgs& a = p.a;
  const int warp = threadIdx.x / 32;
  init_bars<ST>(bars);

  if (warp >= kConsumers * 4) {   // producer warpgroup: one thread issues the loads
    producer_regs();
    if (threadIdx.x == kConsumers * 128) {
      int g = 0;   // K/V tiles streamed
      for (int n = 0;; ++n) {
        wait_res_free(bars, n);
        const int w = next_item(a.work, p.items);
        publish_item(sm, base, bars, n, w);
        if (w < 0) break;
        int64_t bh, q0;
        query_item(a, w, BM, bh, q0);
        const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
        const int ntiles = static_cast<int>((key_end(a, q0, BM, false) + BK - 1) / BK);
        const uint32_t rf = res_full(bars, n & 1), qs = base + (n & 1) * 2 * C::kQ;
        mbar_expect_tx(rf, 2 * C::kQ);
        load_tile<D, BM>(qs, p.tq, rf, q0, h, b);
        load_tile<D, BM>(qs + C::kQ, p.tdo, rf, q0, h, b);
        for (int it = 0; it < ntiles; ++it, ++g) {
          wait_free<ST>(bars, g);
          const uint32_t fb = full_bar(bars, g % ST), kt = ring + (g % ST) * 2 * C::kKV;
          mbar_expect_tx(fb, 2 * C::kKV);
          load_tile<D, BK>(kt, p.tk, fb, static_cast<int64_t>(it) * BK, h, b);
          load_tile<D, BK>(kt + C::kKV, p.tv, fb, static_cast<int64_t>(it) * BK, h, b);
        }
      }
    }
  } else {
    consumer_regs();
    const int wg = warp / 4, tid = threadIdx.x % 128, lane = threadIdx.x % 32;
    const int t = lane & 3, rlo = wg * 64 + (warp % 4) * 16 + (lane >> 2);
    const float scale = static_cast<float>(a.scale), scale2 = scale * kLog2e;
    const int sk = static_cast<int>(a.Sk), off = static_cast<int>(a.off);
    int g = 0;   // K/V tiles consumed
    for (int n = 0;; ++n) {
      wait_res_full(bars, n);
      const int w = read_item(sm, base, bars, n);
      if (w < 0) break;
      int64_t bh, q0;
      query_item(a, w, BM, bh, q0);
      const int ntiles = static_cast<int>((key_end(a, q0, BM, false) + BK - 1) / BK);
      const uint32_t qs = base + (n & 1) * 2 * C::kQ, dos = qs + C::kQ;
      const int64_t row0 = q0 + rlo;
      const float* stats = static_cast<const float*>(a.stats) + bh * a.Sq * 2;
      const float* delta = static_cast<const float*>(a.delta) + bh * a.Sq;
      // per row g + 8r: stats, delta, and the last key it sees (-1: no row)
      float m2[2], lg[2], dl[2];
      int lim[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t row = row0 + 8 * r;
        const bool in = row < a.Sq;
        m2[r] = in ? stats[row * 2] : 0.f;
        lg[r] = in ? stats[row * 2 + 1] : 0.f;
        dl[r] = in ? delta[row] : 0.f;
        lim[r] = !in ? -1 : a.causal ? static_cast<int>(row) + off : INT_MAX;
      }
      float dq[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

      for (int it = 0; it < ntiles; ++it, ++g) {
        const int s = g % ST;
        const int64_t k0 = static_cast<int64_t>(it) * BK;
        const uint32_t kt = ring + s * 2 * C::kKV, vt = kt + C::kKV;
        mbar_wait(full_bar(bars, s), (g / ST) & 1);
        float sc[BK / 2], dp[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          Wgmma<BK>::ss(sc, desc_k<D, BM>(qs, wg * 64, kk), desc_k<D, BK>(kt, 0, kk), kk > 0);
          Wgmma<BK>::ss(dp, desc_k<D, BM>(dos, wg * 64, kk), desc_k<D, BK>(vt, 0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
        keep(sc);
        keep(dp);
        // dS = P (dP - delta), 0 where masked, past the last key or query
        const int c0 = static_cast<int>(k0) + 2 * t;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, c = c0 + 8 * j + (e & 1);
            const float pv = ex2(sc[4 * j + e] * scale2 - m2[r] - lg[r]);
            sc[4 * j + e] = c < sk && c <= lim[r] ? pv * (dp[4 * j + e] - dl[r]) : 0.f;
          }
        uint32_t sa[BK / 16][4];
        to_a<BK>(sa, sc);
        keep(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) Wgmma<D>::rs(dq, sa[kk], desc_mn<D, BK>(kt, kk));
        wgmma_commit();
        wgmma_wait();
        keep(dq);
        keep(sa);
        if (tid == 0) mbar_arrive(empty_bar(bars, s));
      }

      const float mul[2] = {scale, scale};
      uint8_t* qsm = sm + (n & 1) * 2 * C::kQ;
      stage_acc<D, BM>(qsm, dq, mul, rlo, t);
      named_sync(1 + wg, 128);
      store_rows<D, BM>(static_cast<uint16_t*>(a.dq) + bh * a.Sq * D, qsm, wg * 64,
                        q0 + wg * 64, a.Sq, tid);
      release_res(bars, n, wg, tid);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward, dk and dv, persistent: work items (64-key tile, batch *
// head), a head's heaviest causal tile (its first) first. The producer loads an
// item's K and V tiles and streams the q and dO tiles (BQ queries) that can
// see them, with their rows' stats and delta. The two consumer warpgroups
// share the 64 keys and split the products, so that each holds one 64 x D
// accumulator (two, 128 registers a thread at D = 128, do not fit beside
// the scores): the first computes S^T = K q^T, P^T, and dv += P^T dO; the
// second dP^T = V dO^T, dS^T = P^T (dP^T - delta) and dk += dS^T q, with
// P^T (float32) handed over through shared memory: each thread reads what
// its twin in the first warpgroup wrote, since the two accumulator
// fragments match element for element.
template <int D>
struct DkdvCfg {
  static constexpr int BK = 64, BQ = 64, ST = 3;
  static constexpr int kK = BK * D * 2, kQ = BQ * D * 2, kRows = 3 * BQ * 4;
  static constexpr int kP = 128 * (BQ / 2) * 4;   // one chunk's P^T, by thread
  static constexpr int kStage = (2 * kQ + kRows + 1023) / 1024 * 1024;   // tiles on 1024 bytes
  using S = Smem<2 * kK, ST, kStage, 2 * kP>;
};

// Named barriers besides 0 (__syncthreads) and 1 + wg (a warpgroup's
// epilogue): P^T buffer b written (3 + b) and read (5 + b).
constexpr int kBarPFull = 3, kBarPRead = 5;

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    attention_bwd_dkdv_bf16(const __grid_constant__ TmaArgs p) {
  using C = DkdvCfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, ST = C::ST, kStage = C::kStage;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw);
  const uint32_t ring = base + C::S::kRing, bars = base + C::S::kBars;
  float* pbuf = reinterpret_cast<float*>(sm + C::S::kExtra);   // [2][BQ / 2][128]
  const AttnArgs& a = p.a;
  const int nk = static_cast<int>((a.Sk + BK - 1) / BK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_bars<ST>(bars);

  if (warp >= kConsumers * 4) {   // producer warpgroup: its first warp loads
    producer_regs();
    if (warp == kConsumers * 4) {   // (the whole warp copies the rows' stats)
      int g = 0;   // q/dO tiles streamed
      for (int n = 0;; ++n) {
        int w = 0;
        if (lane == 0) {
          wait_res_free(bars, n);
          w = next_item(a.work, p.items);
          publish_item(sm, base, bars, n, w);
        }
        w = __shfl_sync(0xffffffffu, w, 0);
        if (w < 0) break;
        const int64_t bh = w / nk, j0 = static_cast<int64_t>(w % nk) * BK;
        const int64_t qbeg = query_begin(a, j0, BQ);
        const int nchunks = qbeg < a.Sq ? static_cast<int>((a.Sq - qbeg + BQ - 1) / BQ) : 0;
        const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
        const float* stats = static_cast<const float*>(a.stats) + bh * a.Sq * 2;
        const float* delta = static_cast<const float*>(a.delta) + bh * a.Sq;
        if (lane == 0) {
          const uint32_t rf = res_full(bars, n & 1), ks = base + (n & 1) * 2 * C::kK;
          mbar_expect_tx(rf, 2 * C::kK);
          load_tile<D, BK>(ks, p.tk, rf, j0, h, b);
          load_tile<D, BK>(ks + C::kK, p.tv, rf, j0, h, b);
        }
        for (int it = 0; it < nchunks; ++it, ++g) {
          const int64_t i0 = qbeg + static_cast<int64_t>(it) * BQ;
          wait_free<ST>(bars, g);
          const uint32_t st = ring + (g % ST) * kStage;
          float* rows = reinterpret_cast<float*>(sm + (st + 2 * C::kQ - base));
          for (int r = lane; r < BQ; r += 32) {
            const bool in = i0 + r < a.Sq;
            rows[r] = in ? stats[(i0 + r) * 2] : 0.f;
            rows[BQ + r] = in ? stats[(i0 + r) * 2 + 1] : 0.f;
            rows[2 * BQ + r] = in ? delta[i0 + r] : 0.f;
          }
          __syncwarp();
          if (lane == 0) {
            const uint32_t fb = full_bar(bars, g % ST);
            mbar_expect_tx(fb, 2 * C::kQ);
            load_tile<D, BQ>(st, p.tq, fb, i0, h, b);
            load_tile<D, BQ>(st + C::kQ, p.tdo, fb, i0, h, b);
          }
        }
      }
    }
  } else {
    consumer_regs();
    const int wg = warp / 4, tid = threadIdx.x % 128;
    const int t = lane & 3, rlo = (warp % 4) * 16 + (lane >> 2);   // tile key of g
    const float scale = static_cast<float>(a.scale), scale2 = scale * kLog2e;
    const int sq = static_cast<int>(a.Sq), sk = static_cast<int>(a.Sk);
    const int off = static_cast<int>(a.off);
    const bool causal = a.causal;
    int g = 0;   // q/dO tiles consumed, and P^T hand-overs
    for (int n = 0;; ++n) {
      wait_res_full(bars, n);
      const int w = read_item(sm, base, bars, n);
      if (w < 0) break;
      const int64_t bh = w / nk, j0 = static_cast<int64_t>(w % nk) * BK;
      const int64_t qbeg = query_begin(a, j0, BQ);
      const int nchunks = qbeg < a.Sq ? static_cast<int>((a.Sq - qbeg + BQ - 1) / BQ) : 0;
      const uint32_t ks = base + (n & 1) * 2 * C::kK, vs = ks + C::kK;
      const int key[2] = {static_cast<int>(j0) + rlo, static_cast<int>(j0) + rlo + 8};
      float acc[D / 2];   // dv (first warpgroup) or dk (second)
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      for (int it = 0; it < nchunks; ++it, ++g) {
        const int s = g % ST, b = g & 1;
        const int64_t i0 = qbeg + static_cast<int64_t>(it) * BQ;
        const uint32_t qt = ring + s * kStage, dt = qt + C::kQ;
        const float* m2s = reinterpret_cast<const float*>(sm + (qt + 2 * C::kQ - base));
        const float* lgs = m2s + BQ;
        const float* dls = lgs + BQ;
        float* pb = pbuf + b * (BQ / 2) * 128 + tid;
        mbar_wait(full_bar(bars, s), (g / ST) & 1);
        float x[BQ / 2];   // S^T, then P^T (first); dP^T, then dS^T (second): 64 keys x BQ
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<BQ>::ss(x, desc_k<D, BK>(wg == 0 ? ks : vs, 0, kk),
                        desc_k<D, BQ>(wg == 0 ? qt : dt, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait();
        keep(x);
        const int q0c = static_cast<int>(i0) + 2 * t;
        if (wg == 0) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int il = j * 8 + 2 * t + (e & 1), qi = q0c + 8 * j + (e & 1);
              const bool in = qi < sq && key[e >> 1] < sk;
              const bool masked = causal && key[e >> 1] > qi + off;
              const float xs = masked ? kMasked2 : x[4 * j + e] * scale2;
              const float pv = ex2(xs - m2s[il] - lgs[il]);
              x[4 * j + e] = in ? pv : 0.f;
            }
          if (g >= 2) named_sync(kBarPRead + b, 256);
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) pb[i * 128] = x[i];
          __threadfence_block();
          named_arrive(kBarPFull + b, 256);
        } else {
          named_sync(kBarPFull + b, 256);
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int il = j * 8 + 2 * t + (e & 1), qi = q0c + 8 * j + (e & 1);
              const bool live =
                  qi < sq && key[e >> 1] < sk && !(causal && key[e >> 1] > qi + off);
              const float pv = pb[(4 * j + e) * 128];
              x[4 * j + e] = live ? pv * (x[4 * j + e] - dls[il]) : 0.f;
            }
          named_arrive(kBarPRead + b, 256);
        }
        // dv += P^T dO (first), dk += dS^T q (second)
        uint32_t xa[BQ / 16][4];
        to_a<BQ>(xa, x);
        keep(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          Wgmma<D>::rs(acc, xa[kk], desc_mn<D, BQ>(wg == 0 ? dt : qt, kk));
        wgmma_commit();
        wgmma_wait();
        keep(acc);
        keep(xa);
        if (tid == 0) mbar_arrive(empty_bar(bars, s));
      }

      // dv through the K tile (read only by the first warpgroup), dk (times
      // scale) through the V tile (read only by the second)
      const float mul[2] = {wg == 0 ? 1.f : scale, wg == 0 ? 1.f : scale};
      uint8_t* tile = sm + (n & 1) * 2 * C::kK + wg * C::kK;
      stage_acc<D, BK>(tile, acc, mul, rlo, t);
      named_sync(1 + wg, 128);
      store_rows<D, BK>(static_cast<uint16_t*>(wg == 0 ? a.dv : a.dk) + bh * a.Sk * D, tile, 0,
                        j0, a.Sk, tid);
      release_res(bars, n, wg, tid);
    }
    // the first warpgroup waits out the reads it has not waited for, so
    // that every hand-over barrier ends complete
    if (wg == 0)
      for (int h = g > 2 ? g - 2 : 0; h < g; ++h) named_sync(kBarPRead + (h & 1), 256);
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
// A masked score, -1e30 in the accumulation dtype (as the plain version
// writes it: float64 keeps -1e30 exactly, where float32 rounds it).
template <typename T> __device__ __forceinline__ T masked_t();
template <> __device__ __forceinline__ float masked_t<float>() { return kMasked; }
template <> __device__ __forceinline__ double masked_t<double>() { return -1e30; }

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
    if (p.causal && j > i + p.off) x = masked_t<T>();
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
    if (masked) x = masked_t<T>();
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
cudaError_t launch(Kernel kernel, dim3 grid, const AttnArgs& a, void* stream) {
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// What a persistent launch asks of the current device, read once per device
// (and per kernel): its SM count, and the kernel's shared memory raised
// past 48 KB.
cudaError_t prepare(const void* kernel, int smem, int* sms) {
  struct Device {
    int sms = 0;
    std::set<const void*> raised;
  };
  static std::mutex mu;
  static std::map<int, Device> devices;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  Device& d = devices[dev];
  if (d.sms == 0) e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && d.raised.count(kernel) == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) d.raised.insert(kernel);
  }
  *sms = d.sms;
  return e;
}

// A persistent launch: one block per SM (or per work item, if fewer).
template <typename Kernel>
cudaError_t launch_ws(Kernel kernel, int64_t tiles, int64_t bh, int smem, TmaArgs& p,
                      void* stream) {
  if (tiles * bh > INT_MAX || p.a.work == nullptr) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = prepare(reinterpret_cast<const void*>(kernel), smem, &sms);
  if (e != cudaSuccess) return e;
  p.items = static_cast<int>(tiles * bh);
  const int blocks = p.items < sms ? p.items : sms;
  kernel<<<dim3(static_cast<unsigned>(blocks)), kWsThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

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

// The map of a bf16 [B, H, S, D] tensor at its own strides (in elements),
// as dims (D, S, H, B), read in boxes of `rows` rows by one column block
// (Geo<D>), swizzled at the block's row width; rows past S read as zeros.
// TMA needs the base and every stride on 16 bytes (the wrapper sees to it).
bool make_map(CUtensorMap* m, const void* ptr, const Strides& s, int64_t B, int64_t H,
              int64_t S, int64_t D, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const int rb = D >= 64 ? 128 : 2 * static_cast<int>(D);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.s) * 2,
                                 static_cast<cuuint64_t>(s.h) * 2,
                                 static_cast<cuuint64_t>(s.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(rb / 2), static_cast<cuuint32_t>(rows), 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = rb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : rb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

enum Which { kFwd = 0, kDelta = 1, kDkdv = 2, kDq = 3 };

template <int D>
cudaError_t launch_bf16(Which w, const AttnArgs& a, int64_t B, void* stream) {
  const int64_t bh = B * a.H;
  TmaArgs p;
  p.a = a;
  // q and dO in boxes of `qr` rows, k and v of `kr`
  auto maps = [&](int qr, int kr, bool dout) {
    return make_map(&p.tq, a.q, a.sq, B, a.H, a.Sq, D, qr) &&
           make_map(&p.tk, a.k, a.sk, B, a.H, a.Sk, D, kr) &&
           make_map(&p.tv, a.v, a.sv, B, a.H, a.Sk, D, kr) &&
           (!dout || make_map(&p.tdo, a.dout, a.sdo, B, a.H, a.Sq, D, qr));
  };
  switch (w) {
    case kFwd: {
      using C = FwdCfg<D>;
      if (!maps(C::BM, C::BN, false)) return cudaErrorInvalidValue;
      return launch_ws(attention_fwd_bf16<D>, cdiv(a.Sq, C::BM), bh, C::S::kBytes, p, stream);
    }
    case kDkdv: {
      using C = DkdvCfg<D>;
      if (!maps(C::BQ, C::BK, true)) return cudaErrorInvalidValue;
      return launch_ws(attention_bwd_dkdv_bf16<D>, cdiv(a.Sk, C::BK), bh, C::S::kBytes, p, stream);
    }
    case kDq: {
      using C = DqCfg<D>;
      if (!maps(C::BM, C::BK, true)) return cudaErrorInvalidValue;
      return launch_ws(attention_bwd_dq_bf16<D>, cdiv(a.Sq, C::BM), bh, C::S::kBytes, p, stream);
    }
    default:
      return launch(attention_bwd_delta_bf16<D>, dim3(bh, cdiv(a.Sq, kThreads / (D / 8))), a,
                    stream);
  }
}

template <typename T>
cudaError_t launch_scalar(Which w, const AttnArgs& a, int64_t bh, void* stream) {
  switch (w) {
    case kFwd:
      return launch(attention_fwd_scalar<T>, dim3(bh, cdiv(a.Sq, kWarps)), a, stream);
    case kDkdv:
      return launch(attention_bwd_dkdv_scalar<T>, dim3(bh, cdiv(a.Sk, kWarps)), a, stream);
    case kDq:
      return launch(attention_bwd_dq_scalar<T>, dim3(bh, cdiv(a.Sq, kWarps)), a, stream);
    default:
      return launch(attention_bwd_delta<T>, dim3(bh, cdiv(a.Sq, kWarps)), a, stream);
  }
}

int run(Which w, const void* q, const void* k, const void* v, const void* o, const void* dout,
        void* out, void* stats, void* delta, void* dq, void* dk, void* dv, int64_t B, int64_t H,
        int64_t Sq, int64_t Sk, int64_t D, int64_t sqb, int64_t sqh, int64_t sqs, int64_t skb,
        int64_t skh, int64_t sks, int64_t svb, int64_t svh, int64_t svs, int64_t sdb,
        int64_t sdh, int64_t sds, double scale, int causal, int dtype, int* work,
        void* stream) {
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
  a.work = work;
  cudaError_t e;
  if (dtype == 1) {
    e = launch_scalar<float>(w, a, bh, stream);
  } else if (dtype == 2) {
    e = launch_scalar<double>(w, a, bh, stream);
  } else {
    switch (D) {
      case 16: e = launch_bf16<16>(w, a, B, stream); break;
      case 32: e = launch_bf16<32>(w, a, B, stream); break;
      case 64: e = launch_bf16<64>(w, a, B, stream); break;
      default: e = launch_bf16<128>(w, a, B, stream); break;
    }
  }
  return static_cast<int>(e);
}

}  // namespace

// The C entry points (bound with ctypes in kernels/attention.py), one per
// kernel, all with one argument list; an entry reads only the pointers its
// kernel uses (the others may be null). Strides are in elements, in
// (batch, head, row) order; the last dimension's stride is 1; for bf16
// every base and stride is a multiple of 16 bytes. dtype: 0 bf16, 1
// float32, 2 float64. work: two int32 on the device, zero, owned by
// `stream` (the bf16 forward, dk/dv and dq take their work items from it
// and leave it zero; the others ignore it). Returns the launch's
// cudaError_t: 0 when the kernel was queued on `stream`.
#define DL4J_ATTENTION_ENTRY(name, which)                                                      \
  extern "C" int name(                                                                         \
      const void* q, const void* k, const void* v, const void* o, const void* dout, void* out, \
      void* stats, void* delta, void* dq, void* dk, void* dv, int64_t B, int64_t H,            \
      int64_t Sq, int64_t Sk, int64_t D, int64_t sqb, int64_t sqh, int64_t sqs, int64_t skb,   \
      int64_t skh, int64_t sks, int64_t svb, int64_t svh, int64_t svs, int64_t sdb,            \
      int64_t sdh, int64_t sds, double scale, int causal, int dtype, int* work,              \
      void* stream) {                                                                          \
    return run(which, q, k, v, o, dout, out, stats, delta, dq, dk, dv, B, H, Sq, Sk, D, sqb,   \
               sqh, sqs, skb, skh, sks, svb, svh, svs, sdb, sdh, sds, scale, causal, dtype,    \
               work, stream);                                                                  \
  }

DL4J_ATTENTION_ENTRY(dl4j_attention_fwd, kFwd)
DL4J_ATTENTION_ENTRY(dl4j_attention_bwd_delta, kDelta)
DL4J_ATTENTION_ENTRY(dl4j_attention_bwd_dkdv, kDkdv)
DL4J_ATTENTION_ENTRY(dl4j_attention_bwd_dq, kDq)
