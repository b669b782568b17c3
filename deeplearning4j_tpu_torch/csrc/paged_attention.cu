// Attention of query rows over a KV cache held in blocks that a table
// addresses, and the decode step's K/V write: the decode attention of the
// generative serving tier, one launch a layer.
//
// Replaces the JAX package's paged decode (deeplearning4j_tpu/zoo/gpt.py
// gpt_paged_decode_fns.decode_fn :649: the scatter of the step's K/V at
// :668-674, then the gather, mask, softmax and masked V rows zeroed at
// :675-689) and the dense decode (gpt_decode_fns.decode_fn :354: the
// masked per-slot write at :375-382, then attention over the slab at
// :383-394). There each is a write of the step's K and V rows, a gather of
// the lane's whole table into a [T, D] context per layer, scores over all T
// keys, a mask to the lane's position and a where() that zeroes masked V
// rows so a stale or NaN block cannot leak. XLA fused it on the TPU; no
// Pallas kernel stands behind it.
//
// What it computes, for query row r of lane s = lane[r], head a, last key
// kmax[r] (clamped at MAXB * BS - 1):
//   kc[write_block[r], a, write_off[r]] = k_new[r, a]  (and V), if
//                                         write_block[r] >= 0
//   out[r, a] = sum_{t <= kmax[r]} softmax_t(scale * q[r, a] . K[t]) V[t]
//   K[t] = kc[tables[s, t / BS], a, t % BS], and likewise V.
// The caller keeps the contract that a row's write lands where its key
// kmax[r] lies through its table, and that no other row reads that key
// from the cache: so key kmax[r] is taken from k_new and v_new (the bits
// the write stores), the owning block stores them, and no block reads
// them back. With no
// write pointers (dl4j_paged_decode_attention's k_new == nullptr) it is the
// attention alone. It reads only keys t <= kmax[r], so it never loads a
// block past a row's last key: stale and null blocks (even NaN) cannot reach
// a sum. The dense slab [S, A, max_seq, D] is a paged slab with BS = max_seq
// and tables[s] = [s].
//
// dl4j_paged_verify_attention is a speculative verify's layer on the same
// kernel (the JAX verify_fns' write-then-attend, zoo/gpt.py :437-459 dense
// and :728-751 paged): each lane's window of W rows, row w writing its K/V
// at its own place and attending to keys up to pos0 + w, where the keys
// pos0 .. pos0 + w are taken from the launch's new rows (win0, wrow), not
// read back. Row w's output is then the decode entry's at last key pos0 + w
// over the same keys, bit for bit, and no row reads a key another row of
// the launch writes. Its kernel (paged_verify_kernel, below the decode
// kernel) is one cluster of the same 8 ranks a (lane's window, head): each
// chunk of the lane's keys is copied once and serves every row of the
// window (the first verify ran each (lane, w) as a decode cluster and
// read a lane's keys W times). Over an int8 cache in float32 the verify is
// paged_verify_i8_kernel: the same work and bits, its per-key chain
// rebuilt (below paged_verify_kernel).
//
// Both entries take an int8 cache (k_scale and v_scale non-null, [A, D]
// float32 each, the layer's per-(head, channel) scales): the serving
// tier's int8 KV, the JAX decode functions' _q_store and _q_load
// (zoo/gpt.py :294-304, paged :576-584). A row is stored as clip(rint(x /
// s), -127, 127), the quotient an IEEE division (never a reciprocal) and
// rint half to even, as jnp.round; a stored value is read as float(x_i8) *
// s rounded in float32 and only then widened to T, so float64 runs take
// the same int8 path. A row the launch writes is attended to in its stored
// form, as JAX reads it back from the slab: the decode's own key and the
// verify's window keys are dequant(quant(k_new)), made in registers or put
// in the chunk from k_new, never read back (another cluster may not have
// written them yet). The ring holds int8 rows (a chunk of 16 rows of 128
// is 2 KiB, one bulk copy); the order of every sum is the float cache's.
//
// The int8 design (the first one, the float kernel's ring of one slot
// with each element dequantised as the math read it, is gone from the
// source; experiments/paged_decode_study.py --parent builds it): what held
// it back at decode was its chain, not its bytes (the float32 cache, four
// times the bytes, took as long at context 128), each further chunk a rank
// held adding about 2.3 us in series. A deeper int8 ring, every chunk a
// rank owns issued before any math, did not help (a variant with no math
// pays about 1.3 us a chunk a rank with every chunk in flight), so the ring
// stays one slot (kRing). In float32 the scales leave the inner loop
// (Layout's kFold): the scores are (q * s_k) . x_i8, q * s_k rounded once
// a row, and rank 0's combine multiplies the sums of p x_i8 by s_v, so a
// key costs no scale load and no multiply an element. The verifies below
// take the same form, so their rows stay the decode's bits.
//
// What bounds it on an H100: at decode a row reads (kmax + 1) K and V rows
// of D values once and does 4 D FLOP per key, far below the card's ridge:
// bytes bound it (8 lanes x 12 heads x 512 keys x 128 x 4 B x 2 = 50 MB a
// layer at context 512, 0.0151 ms at 3.35 TB/s; an int8 cache a quarter of
// that, 0.0038 ms).
//
// Design: one cluster of 8 blocks of 128 threads a (row, head). What held
// the first kernel (one block of 256 threads a (row, head), since removed;
// PERF.md keeps its times) back, and what this one does about it:
// 1. Too few blocks (one a (row, head): 96 on 132 SMs at decode). Here a
//    row's keys are cut into chunks of 16 positions and cluster rank j takes
//    chunks j, j + 8, j + 16, ...: 768 blocks at decode, all resident at
//    once (about six an SM), so every SM keeps copies in flight.
// 2. Serialised loads (a table entry, then the row, then the math, key by
//    key). Here a block reads the table entries of its chunks first (one
//    load a lane of warp 0 for 32 chunks, issued beside the row's lane and
//    last key), then issues the copy of a chunk into a ring of kRing
//    shared-memory slots before any math, refilling a slot as soon as its
//    chunk is consumed. The ring holds one slot: the copies in flight come
//    from the many resident blocks, and a deeper ring fits fewer of them.
// 3. Narrow loads (4-byte scalars). Where BS % 16 == 0 (blocks of 16, and
//    the dense slab) a chunk's 16 rows of one head are one contiguous run
//    (8 KiB in float32 at D = 128), fetched by one cp.async.bulk for K and
//    one for V, completing on the slot's mbarrier; other block sizes take
//    16-byte cp.async per row into the same layout (completing on the same
//    mbarrier through cp.async.mbarrier.arrive). Both read with an L2
//    evict-first policy: rows read once give up their L2 lines first.
// In a block, a warp's lanes hold 16-byte slices of q (a key's dot product
// is a shuffle butterfly over the lanes that share it) and streams of keys
// run an online softmax, chunk by chunk, in the input's type (float32, or
// float64 for float64). Each rank but 0 pushes its block's (m, l, acc[D])
// into rank 0's shared memory over distributed shared memory (st.async,
// completing as bytes on an mbarrier of rank 0's, initialised before one
// relaxed cluster barrier that no block waits on until it pushes); rank 0
// waits on that mbarrier alone, combines the 8 partials in rank order and
// writes out. No block reads another's shared memory, so none has to stay
// alive for another (no trailing cluster barrier). Which block and
// stream take key t, and the order of every sum, depend on t alone, never
// on BS or the table: paged and dense decode of one context give the same
// bits, and two calls give the same bits. No atomics, no global workspace,
// one launch, no host sync and no allocation.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>

#include "sm90.cuh"

namespace dec {

using namespace sm90;

namespace cg = cooperative_groups;

constexpr int kChunk = 16;                  // key positions a chunk
constexpr int kRanks = 8;                   // blocks a cluster
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Slots of a block's ring of chunks (K and V, 16 KiB a slot in float32 at
// D = 128, 4 KiB in int8). One: a deeper ring keeps more of a block's copies
// in flight but fits fewer blocks an SM, and measured slower at every
// decode context over a float32 cache; over an int8 one four slots (every
// chunk a rank owns in flight before any math up to context 512) measured
// no faster without the step's write and slower with it, eight slower
// still (PERF.md; experiments/paged_decode_study.py builds deeper rings).
constexpr int kRing = 1;
constexpr int kSmemCap = 200 * 1024;        // the ring's shared memory at most
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float rint_(float x) { return rintf(x); }
__device__ __forceinline__ double rint_(double x) { return rint(x); }

// How a block's threads share a chunk, for compute type T, cache type C
// (T, or int8_t) and head dim D. A thread's slice is 16 bytes of T (E
// values); the cache's rows are copied in 16-byte pieces of C.
template <typename T, typename C, int D>
struct Layout {
  static constexpr int E = 16 / static_cast<int>(sizeof(T));  // a slice
  static constexpr int NS = D / E;                 // slices a row
  static constexpr int G = NS < 32 ? NS : 32;      // lanes that share a key
  static constexpr int SL = NS / G;                // slices a lane
  static constexpr int GPW = 32 / G;               // keys a warp at once
  static constexpr int kStreams = kWarps * GPW < kChunk ? kWarps * GPW : kChunk;
  static constexpr int KPS = kChunk / kStreams;    // keys a stream a chunk
  static constexpr int CE = 16 / static_cast<int>(sizeof(C));   // a copy's piece
  static constexpr int NC = D / CE;                // pieces a cache row
  static constexpr int kChunkBytes = kChunk * D * static_cast<int>(sizeof(C));
  static constexpr int kSlotElems = 2 * kChunk * D;    // K rows, then V rows
  static constexpr int kSlotBytes = 2 * kChunkBytes;
  static constexpr int kRingSlots =
      kSmemCap / kSlotBytes < kRing ? kSmemCap / kSlotBytes : kRing;
  // An int8 cache in float32: K's scale folded into q (q * s_k rounded once,
  // times the stored integers) and V's into the combine (the sums of p
  // times the stored integers, times s_v), so that no key pays a scale load
  // and a multiply an element. In float64 a stored value is read as
  // float(x) * s rounded in float32 first, as the JAX _q_load reads it, and
  // that rounding does not move out of the product: no fold.
  static constexpr bool kFold = sizeof(C) == 1 && sizeof(T) == 4;
};

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// A key's or value's E channels from the chunk in shared memory into E
// registers: 16 bytes of a float cache as they are; E bytes of an int8
// cache as their integers (kRaw: the scales folded elsewhere, Layout's
// kFold) or dequantised at the channels' scales s (E of them, in shared
// memory): float(x) * s rounded in float32, then widened to T.
template <bool kRaw, typename T, int E>
__device__ __forceinline__ void ldkv(const T* p, const float*, T (&v)[E]) {
  const typename Vec16<T>::type x = *reinterpret_cast<const typename Vec16<T>::type*>(p);
  const T* xs = reinterpret_cast<const T*>(&x);
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = xs[e];
}
template <bool kRaw, typename T, int E>
__device__ __forceinline__ void ldkv(const int8_t* p, const float* s, T (&v)[E]) {
  signed char xs[E];
  if constexpr (E == 4) {
    const char4 x = *reinterpret_cast<const char4*>(p);
    xs[0] = x.x, xs[1] = x.y, xs[2] = x.z, xs[3] = x.w;
  } else {
    const char2 x = *reinterpret_cast<const char2*>(p);
    xs[0] = x.x, xs[1] = x.y;
  }
#pragma unroll
  for (int e = 0; e < E; ++e)
    v[e] = kRaw ? static_cast<T>(xs[e]) : static_cast<T>(__fmul_rn(static_cast<float>(xs[e]), s[e]));
}

// What the cache stores of x at the scale *s: x itself (a float cache), or
// clip(rint(x / s), -127, 127) as int8, the quotient rounded once (IEEE
// division in T) and rint half to even, as the JAX store's jnp.round.
template <typename C, typename T>
__device__ __forceinline__ C stored(T x, const float* s) {
  if constexpr (sizeof(C) == 1) {
    const T r = rint_(x / static_cast<T>(*s));
    return static_cast<C>(r < T(-127) ? T(-127) : (r > T(127) ? T(127) : r));
  } else {
    return x;
  }
}
// A stored value as the math reads it (ldkv's: its integer under the fold,
// else its dequantisation).
template <bool kRaw, typename T, typename C>
__device__ __forceinline__ T loaded(C x, const float* s) {
  if constexpr (kRaw) {
    return static_cast<T>(x);
  } else if constexpr (sizeof(C) == 1) {
    return static_cast<T>(__fmul_rn(static_cast<float>(x), *s));
  } else {
    return x;
  }
}

// Under the fold (kF), x times its channel's scale *s, rounded once: q's
// channel with K's scale, as the scores take it, and the sums of p times
// the stored V with V's, as the output takes them. x itself otherwise.
template <bool kF, typename T>
__device__ __forceinline__ T fold(T x, const float* s) {
  if constexpr (kF) {
    return __fmul_rn(x, *s);
  } else {
    return x;
  }
}

// The K/V rows are read once: their lines are the first L2 gives up (an
// evict-first policy), before the lines other kernels left there.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "l"(evict_first())
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

// 16 bytes (or 8: the pair) into another CTA's shared memory at the
// cluster address `dst`, completing as bytes on its mbarrier `bar`.
__device__ __forceinline__ void st_async(uint32_t dst, const float (&v)[4], uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t dst, const double (&v)[2], uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], {%1, %2}, [%3];\n" ::"r"(
          dst),
      "d"(v[0]), "d"(v[1]), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async_pair(uint32_t dst, float a, float b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          dst),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async_pair(uint32_t dst, double a, double b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], {%1, %2}, [%3];\n" ::"r"(
          dst),
      "d"(a), "d"(b), "r"(bar)
      : "memory");
}

struct Args {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* kc;
  void* vc;
  const int* tables;
  const int* lane;
  const int* kmax;
  const int* write_block;  // nullptr: no write
  const int* write_off;
  // a verify's windows (nullptr at decode): row r takes keys win0[r] ..
  // kmax[r] from k_new/v_new rows wrow[r] + (t - win0[r]), win0[r] -1: none
  const int* win0;
  const int* wrow;
  void* out;
  // an int8 cache's per-(head, channel) scales [A, D] (nullptr: a float
  // cache)
  const float* ksc;
  const float* vsc;
  int N, A, BS, MAXB, NB, S, bulk;
  int64_t sqn, sqa, skb, ska, skt, svb, sva, svt;
  double scale;
};

template <typename T, typename C, int D>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads)
    paged_decode_kernel(const Args a) {
  using L = Layout<T, C, D>;
  constexpr int E = L::E, G = L::G, SL = L::SL, S = L::kStreams;
  constexpr bool kQ = sizeof(C) == 1;         // an int8 cache
  extern __shared__ __align__(128) unsigned char dyn[];
  C* ring = reinterpret_cast<C*>(dyn);
  __shared__ __align__(8) uint64_t bars[L::kRingSlots];
  // an int8 cache's scales of this head's channels, K's then V's (none
  // for a float cache), and where channel d's lie
  __shared__ __align__(16) float s_sc[2][kQ ? D : 1];
  auto scales = [&](int kv, int d) -> const float* { return kQ ? &s_sc[kv][d] : nullptr; };
  __shared__ T s_m[S], s_l[S];
  __shared__ T s_acc[S][D];
  // rank 0's: each rank's partial (m, l) and acc, pushed there over DSMEM,
  // and the mbarrier they land on
  __shared__ __align__(16) T part_ml[kRanks][2];
  __shared__ __align__(16) T part_acc[kRanks][D];
  __shared__ __align__(8) uint64_t cbar;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t cid = blockIdx.x / kRanks;    // the (row, head) of the cluster
  const int row = static_cast<int>(cid / a.A);
  const int head = static_cast<int>(cid - static_cast<int64_t>(row) * a.A);
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  const int sid = warp * L::GPW + ln / G;     // this thread's stream
  const int gl = ln % G;                      // its lane among the key's G
  const bool live = sid < S;

  // a key past the table's reach is not there (the plain version's mask
  // over T = MAXB * BS keys says the same)
  const int reach = a.MAXB * a.BS;
  const int lane_r = a.lane[row];
  const int* tab = a.tables + static_cast<int64_t>(lane_r) * a.MAXB;
  // the table entries of this rank's first 32 chunks (those the table
  // reaches), read before the row's last key is known, and read as if the
  // row's lane were the row itself (every decode row's is) at the same
  // time as lane[row]; read again from the lane's row where it is not
  int ent = 0;  // bulk: lane l of warp 0 holds the entry of chunk (k & ~31) + l
  if (a.bulk && warp == 0 && (rank + kRanks * ln) * kChunk < reach) {
    const int u = (rank + kRanks * ln) * kChunk / a.BS;
    if (row < a.S) ent = a.tables[static_cast<int64_t>(row) * a.MAXB + u];
    if (lane_r != row) ent = tab[u];
  }
  const int km = a.kmax[row];
  const int last = km < reach - 1 ? km : reach - 1;
  int wb = a.write_block != nullptr ? a.write_block[row] : -1;
  const int wo = wb >= 0 ? a.write_off[row] : 0;
  if (wb >= a.NB || wo < 0 || wo >= a.BS) wb = -1;   // not in the slab: no write
  // the key whose K and V are the step's new rows
  const int wkey = (wb >= 0 && last >= 0 && km == last) ? last : -1;
  const int nch = last >= 0 ? last / kChunk + 1 : 0;
  const int mine = nch > rank ? (nch - 1 - rank) / kRanks + 1 : 0;
  const bool own = rank == (last >= 0 ? (last / kChunk) % kRanks : 0);
  constexpr int nring = L::kRingSlots;

  const C* kh = static_cast<const C*>(a.kc) + static_cast<int64_t>(head) * a.ska;
  const C* vh = static_cast<const C*>(a.vc) + static_cast<int64_t>(head) * a.sva;
  const int64_t qoff = static_cast<int64_t>(row) * a.sqn + static_cast<int64_t>(head) * a.sqa;

  if constexpr (kQ) {
    for (int d = tid; d < 2 * D; d += kThreads)
      s_sc[d / D][d % D] = (d < D ? a.ksc : a.vsc)[static_cast<int64_t>(head) * D + d % D];
  }
  if (tid == 0) {
    for (int s = 0; s < nring; ++s)
      mbar_init(smem_u32(&bars[s]), a.bulk ? 1u : static_cast<uint32_t>(kThreads));
    mbar_init(smem_u32(&cbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // rank 0's cbar is initialised before any rank pushes to it (the wait is
  // at the end, long after)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // Issue chunk k (rank + 8 k) into slot k % nring, in increasing k.
  int islot = 0;
  auto issue = [&](int k) {
    const int c = rank + kRanks * k;
    C* dst = ring + static_cast<int64_t>(islot) * L::kSlotElems;
    const uint32_t bar = smem_u32(&bars[islot]);
    islot = islot + 1 == nring ? 0 : islot + 1;
    if (a.bulk) {
      if (warp != 0) return;
      if (k > 0 && (k & 31) == 0) {
        const int kk = k + ln;
        ent = kk < mine ? tab[(rank + kRanks * kk) * kChunk / a.BS] : 0;
      }
      const int64_t blk = __shfl_sync(kFull, ent, k & 31);
      if (ln == 0) {
        const int64_t off = (c * kChunk) % a.BS;
        mbar_expect_tx(bar, L::kSlotBytes);
        bulk_load(smem_u32(dst), kh + blk * a.skb + off * a.skt, L::kChunkBytes, bar,
                  evict_first());
        bulk_load(smem_u32(dst + kChunk * D), vh + blk * a.svb + off * a.svt, L::kChunkBytes,
                  bar, evict_first());
      }
    } else {
      for (int p = tid; p < 2 * kChunk * L::NC; p += kThreads) {
        const int kv = p / (kChunk * L::NC);
        const int r = (p / L::NC) % kChunk;
        const int s = p % L::NC;
        const int t = c * kChunk + r;
        if (t <= last && t != wkey) {
          const int u = t / a.BS;
          const int64_t blk = tab[u];
          const int64_t off = t - u * a.BS;
          const C* src = kv ? vh + blk * a.svb + off * a.svt : kh + blk * a.skb + off * a.skt;
          cp_async16(smem_u32(dst + kv * kChunk * D + r * D + s * L::CE), src + s * L::CE);
        }
      }
      cp_async_arrive(bar);
    }
  };
  const int first = mine < nring ? mine : nring;
  for (int k = 0; k < first; ++k) issue(k);

  // The step's K/V row, in the owning block's registers (each key group
  // holds the whole row): its stored form (kst, vst: the row itself, or
  // its int8 payload), which its first group stores after the loop, and
  // that form as the math reads it (kn, vn), which its streams take as
  // key wkey's K and V.
  const bool writer = wb >= 0 && own;
  const bool subst = wkey >= 0 && own;
  const T* kn_src = static_cast<const T*>(a.k_new) + qoff;
  const T* vn_src = static_cast<const T*>(a.v_new) + qoff;
  T qr[SL][E], kn[SL][E], vn[SL][E], acc[SL][E];
  C kst[SL][E], vst[SL][E];
  const T* qp = static_cast<const T*>(a.q) + qoff;
#pragma unroll
  for (int j = 0; j < SL; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = (gl + G * j) * E + e;
      qr[j][e] = fold<L::kFold>(qp[d], scales(0, d));
      kst[j][e] = stored<C>(writer ? kn_src[d] : T(0), scales(0, d));
      vst[j][e] = stored<C>(writer ? vn_src[d] : T(0), scales(1, d));
      kn[j][e] = loaded<L::kFold, T>(kst[j][e], scales(0, d));
      vn[j][e] = loaded<L::kFold, T>(vst[j][e], scales(1, d));
      acc[j][e] = T(0);
    }
  T m = -INFINITY, l = T(0);
  const T scale = static_cast<T>(a.scale);

  for (int k = 0, slot = 0, phase = 0; k < mine; ++k) {
    mbar_wait(smem_u32(&bars[slot]), static_cast<uint32_t>(phase));
    const C* sk = ring + static_cast<int64_t>(slot) * L::kSlotElems;
    const C* sv = sk + kChunk * D;
    const int t0 = (rank + kRanks * k) * kChunk;
    T sc[L::KPS];
    bool ok[L::KPS];
#pragma unroll
    for (int jj = 0; jj < L::KPS; ++jj) {
      const int i = (sid + S * jj) & (kChunk - 1);
      const int t = t0 + i;
      ok[jj] = live && t <= last;
      const bool sub = subst && t == wkey;
      T dot = T(0);
#pragma unroll
      for (int j = 0; j < SL; ++j) {
        T kr[E];
        if (sub) {
#pragma unroll
          for (int e = 0; e < E; ++e) kr[e] = kn[j][e];
        } else {
          ldkv<L::kFold, T, E>(sk + i * D + (gl + G * j) * E, scales(0, (gl + G * j) * E), kr);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qr[j][e] * kr[e];
      }
      // a butterfly over the key's G lanes: each ends with the same bits
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
      sc[jj] = ok[jj] ? dot * scale : T(-INFINITY);
    }
    T mx = m;
#pragma unroll
    for (int jj = 0; jj < L::KPS; ++jj) mx = sc[jj] > mx ? sc[jj] : mx;
    if (mx != T(-INFINITY)) {              // a key of this stream so far
      const T corr = exp_(m - mx);         // 0 on the stream's first key
      l *= corr;
#pragma unroll
      for (int j = 0; j < SL; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] *= corr;
#pragma unroll
      for (int jj = 0; jj < L::KPS; ++jj) {
        if (!ok[jj]) continue;             // a masked key's V is never read
        const int i = (sid + S * jj) & (kChunk - 1);
        const bool sub = subst && t0 + i == wkey;
        const T p = exp_(sc[jj] - mx);
        l += p;
#pragma unroll
        for (int j = 0; j < SL; ++j) {
          T vr[E];
          if (sub) {
#pragma unroll
            for (int e = 0; e < E; ++e) vr[e] = vn[j][e];
          } else {
            ldkv<L::kFold, T, E>(sv + i * D + (gl + G * j) * E, scales(1, (gl + G * j) * E), vr);
          }
#pragma unroll
          for (int e = 0; e < E; ++e) acc[j][e] += p * vr[e];
        }
      }
      m = mx;
    }
    if (k + nring < mine) {
      // this slot's reads are done: order them before the next copy into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      issue(k + nring);
    }
    if (++slot == nring) {
      slot = 0;
      phase ^= 1;
    }
  }

  // the block's partial: its streams combined in stream order
  if (live) {
    if (gl == 0) {
      s_m[sid] = m;
      s_l[sid] = l;
    }
#pragma unroll
    for (int j = 0; j < SL; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) s_acc[sid][(gl + G * j) * E + e] = acc[j][e];
  }
  if (writer && sid == 0) {              // no block of this launch reads it
    C* kd = static_cast<C*>(a.kc) + wb * a.skb + head * a.ska + wo * a.skt;
    C* vd = static_cast<C*>(a.vc) + wb * a.svb + head * a.sva + wo * a.svt;
#pragma unroll
    for (int j = 0; j < SL; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kd[(gl + G * j) * E + e] = kst[j][e];
        vd[(gl + G * j) * E + e] = vst[j][e];
      }
  }
  __syncthreads();
  // the block's partial, its streams combined in stream order: a thread
  // takes E elements, and each rank but 0 pushes it to rank 0's part_acc
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < D / E) {
    T mb = s_m[0];
#pragma unroll
    for (int i = 1; i < S; ++i) mb = s_m[i] > mb ? s_m[i] : mb;
    T lb = T(0), ob[E];
#pragma unroll
    for (int e = 0; e < E; ++e) ob[e] = T(0);
    if (mb != T(-INFINITY)) {
#pragma unroll
      for (int i = 0; i < S; ++i) {
        const T w = exp_(s_m[i] - mb);     // 0 for a stream with no key
        lb += s_l[i] * w;
#pragma unroll
        for (int e = 0; e < E; ++e) ob[e] += s_acc[i][tid * E + e] * w;
      }
    }
    if (rank == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) part_acc[0][tid * E + e] = ob[e];
      if (tid == 0) {
        part_ml[0][0] = mb;
        part_ml[0][1] = lb;
      }
    } else {
      const uint32_t bar = cluster_addr(smem_u32(&cbar), 0);
      st_async(cluster_addr(smem_u32(&part_acc[rank][tid * E]), 0), ob, bar);
      if (tid == 0) st_async_pair(cluster_addr(smem_u32(&part_ml[rank][0]), 0), mb, lb, bar);
    }
  }
  if (rank != 0) return;
  // rank 0 combines the cluster's 8 partials, in rank order
  if (tid == 0)
    mbar_expect_tx(smem_u32(&cbar), (kRanks - 1) * (D + 2) * static_cast<uint32_t>(sizeof(T)));
  __syncthreads();
  mbar_wait(smem_u32(&cbar), 0);
  if (tid < D) {
    T mc = T(-INFINITY);
#pragma unroll
    for (int r = 0; r < kRanks; ++r) mc = part_ml[r][0] > mc ? part_ml[r][0] : mc;
    T res = T(0);                           // no key: the JAX mask's 0
    if (mc != T(-INFINITY)) {
      T lc = T(0), oc = T(0);
#pragma unroll
      for (int r = 0; r < kRanks; ++r) {
        const T w = exp_(part_ml[r][0] - mc);   // 0 for a rank with no key
        lc += part_ml[r][1] * w;
        oc += part_acc[r][tid] * w;
      }
      res = fold<L::kFold>(oc, scales(1, tid)) / lc;
    }
    static_cast<T*>(a.out)[cid * D + tid] = res;
  }
}

// The kernel's shared memory raised past 48 KB on the current device, once
// per device: a kernel's attributes belong to each device's context.
template <typename T, typename C, int D>
cudaError_t configure() {
  static std::mutex mu;
  static std::set<int> raised;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  if (raised.count(dev) != 0) return cudaSuccess;
  e = cudaFuncSetAttribute(paged_decode_kernel<T, C, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Layout<T, C, D>::kRingSlots * Layout<T, C, D>::kSlotBytes);
  if (e == cudaSuccess) raised.insert(dev);
  return e;
}

template <typename T, typename C, int D>
int launch(Args a, int64_t N, cudaStream_t st) {
  using L = Layout<T, C, D>;
  // a chunk's 16 rows are one contiguous run of the slab
  a.bulk = a.BS % kChunk == 0 && a.skt == D && a.svt == D;
  const cudaError_t attr = configure<T, C, D>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  paged_decode_kernel<T, C, D><<<static_cast<unsigned>(N * a.A * kRanks), kThreads,
                                 static_cast<size_t>(L::kRingSlots) * L::kSlotBytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the kernel for head dim D and the cache's type: int8 where the scales
// are given, else T
template <typename T>
int launch_d(int64_t D, const Args& a, int64_t N, cudaStream_t st) {
  const bool q8 = a.ksc != nullptr;
  switch (D) {
    case 16: return q8 ? launch<T, int8_t, 16>(a, N, st) : launch<T, T, 16>(a, N, st);
    case 32: return q8 ? launch<T, int8_t, 32>(a, N, st) : launch<T, T, 32>(a, N, st);
    case 64: return q8 ? launch<T, int8_t, 64>(a, N, st) : launch<T, T, 64>(a, N, st);
    case 128: return q8 ? launch<T, int8_t, 128>(a, N, st) : launch<T, T, 128>(a, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The decode kernel as launched: its resident blocks an SM (blocks[0]) and
// the clusters of kRanks blocks the card holds at once (blocks[1]), as the
// occupancy calculator gives them.
template <typename T, typename C, int D>
int occupancy(int* blocks) {
  using L = Layout<T, C, D>;
  const cudaError_t e = configure<T, C, D>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = static_cast<size_t>(L::kRingSlots) * L::kSlotBytes;
  const cudaError_t r = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks[0], paged_decode_kernel<T, C, D>, kThreads, smem);
  if (r != cudaSuccess) return static_cast<int>(r);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kRanks * 1024, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(&blocks[1], paged_decode_kernel<T, C, D>, &cfg));
}

template <typename T>
int occupancy_d(int64_t D, bool q8, int* blocks) {
  switch (D) {
    case 16: return q8 ? occupancy<T, int8_t, 16>(blocks) : occupancy<T, T, 16>(blocks);
    case 32: return q8 ? occupancy<T, int8_t, 32>(blocks) : occupancy<T, T, 32>(blocks);
    case 64: return q8 ? occupancy<T, int8_t, 64>(blocks) : occupancy<T, T, 64>(blocks);
    case 128: return q8 ? occupancy<T, int8_t, 128>(blocks) : occupancy<T, T, 128>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// A speculative verify's layer: one cluster of kVCluster blocks a (group
// of kVRows consecutive rows, head), a group being a lane's window at W =
// 8. Each block takes the decode kernel's ranks rank, rank + kVCluster,
// ... in turn, and as rank j takes chunks j, j + 8, ... of 16 key
// positions up to the run's last key (a run: the neighbouring rows of a
// group that share a lane and a window; one at W = 8), exactly as the
// decode block of rank j takes them. It copies each chunk once for the
// run (a bulk copy where BS % 16 == 0, else cp.async), puts the run's
// window keys (the launch's new rows, never read back from the cache) in
// place of the cache's, and runs each row's streams over it with the
// decode kernel's per-key arithmetic in the decode kernel's order: the
// same keys to the same streams, the same stream and rank combines, so row
// w's output is the decode kernel's at last key pos0 + w, bit for bit. A
// block is kVParts warpgroups, each the decode block's 4 warps for its
// share of the rows; a thread computes its rows' scores key by key
// together (one read of the key's slice, independent dot products and
// butterflies), then their softmax and V sums, each row's in the decode
// kernel's order (one read of a key's V slice serves them all). The
// window's chunk is copied row by row, its window rows from the launch's
// new rows. After each rank's chunks a block combines each row's streams
// into that rank's partial and pushes it to the block of rank row %
// kVCluster, which combines the 8 ranks' partials in rank order, writes
// the output and the row's K/V. The decode kernel above is untouched: a
// runtime window in its body cost it registers. What bounds it: each
// lane's keys read once (50 MB at 8 lanes x 12 heads x context 512, 0.015
// ms at 3.35 TB/s) for W times the decode's operations (0.2 GFLOP at W =
// 8, 0.003 ms at the FMA rate): the bytes. What sets its time at the
// serving contexts (64-145 keys) is waves: its 127 registers a thread
// allow 2 blocks an SM, so 2 blocks a cluster run 8 lanes' 192 blocks in
// one wave, where 8 blocks a cluster ran 768 in 3
// (experiments/paged_verify_study.py).

constexpr int kVRing = 4;        // chunk slots a block
constexpr int kVParts = 2;       // warpgroups a block, each its share of the rows
constexpr int kVMinBlocks = 2;   // blocks an SM the registers must allow
// Blocks a verify cluster, each taking the decode's ranks rank, rank +
// kVCluster, ... one after another (each rank's chunks, streams and
// partial exactly as the decode block of that rank makes them): fewer
// blocks than the decode's 8 ranks, with the same bits.
constexpr int kVCluster = 2;
// Rows a verify cluster: a lane's window at W = 8.
constexpr int kVRows = 8;

template <typename T, typename C, int D>
struct VLayout {
  using L = Layout<T, C, D>;
  static constexpr int R = kVRows;
  static constexpr int P = kVParts < R ? kVParts : R;
  static constexpr int kRing = kSmemCap / L::kSlotBytes < kVRing ? kSmemCap / L::kSlotBytes
                                                                  : kVRing;
  // between a rank's chunks and the next's the same bytes hold the rows'
  // stream partials
  static constexpr int kPartBytes = R * L::kStreams * (D + 2) * static_cast<int>(sizeof(T));
  static constexpr int kBytes =
      kRing * L::kSlotBytes > kPartBytes ? kRing * L::kSlotBytes : kPartBytes;
};

template <typename T, typename C, int D>
__global__ void __cluster_dims__(kVCluster, 1, 1)
    __launch_bounds__(kThreads * VLayout<T, C, D>::P, kVMinBlocks)
        paged_verify_kernel(const Args a) {
  using L = Layout<T, C, D>;
  using V = VLayout<T, C, D>;
  constexpr int E = L::E, G = L::G, SL = L::SL, S = L::kStreams, KPS = L::KPS;
  constexpr int R = V::R, P = V::P, RP = R / P, NT = kThreads * P;
  constexpr int nring = V::kRing;
  constexpr int PR = (R + kVCluster - 1) / kVCluster;   // rows a block combines
  constexpr bool kQ = sizeof(C) == 1;         // an int8 cache
  extern __shared__ __align__(128) unsigned char dyn[];
  C* ring = reinterpret_cast<C*>(dyn);
  __shared__ __align__(8) uint64_t bars[nring];
  // an int8 cache's scales of this head's channels, K's then V's (none
  // for a float cache), and where channel d's lie
  __shared__ __align__(16) float s_sc[2][kQ ? D : 1];
  auto scales = [&](int kv, int d) -> const float* { return kQ ? &s_sc[kv][d] : nullptr; };
  // the rows this block combines: each of the 8 ranks' partial (m, l) and
  // acc, pushed here over DSMEM (or written, for this block's ranks), and
  // the mbarrier they land on
  __shared__ __align__(16) T part_ml[PR][kRanks][2];
  __shared__ __align__(16) T part_acc[PR][kRanks][D];
  __shared__ __align__(8) uint64_t cbar;
  // each row's last key (-1: none, or no row), lane, window, run and
  // refusal; each run's lane, window (first key, new row of key 0) and
  // last key
  __shared__ int s_last[R], s_lane[R], s_w0[R], s_wr[R], s_run[R], s_refused[R];
  __shared__ int u_lane[R], u_w0[R], u_wrk0[R], u_last[R];
  __shared__ int s_nruns;

  cg::cluster_group cluster = cg::this_cluster();
  // this block; it takes the ranks rank, rank + kVCluster, ... of the 8
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t cid = blockIdx.x / kVCluster;   // the (group, head) of the cluster
  const int grp = static_cast<int>(cid / a.A);
  const int head = static_cast<int>(cid - static_cast<int64_t>(grp) * a.A);
  const int r0 = grp * R;
  const int tall = threadIdx.x;
  const int part = tall / kThreads;           // this thread's rows: part RP ..
  const int tid = tall % kThreads, warp = tid / 32, ln = tid % 32;
  const int sid = warp * L::GPW + ln / G;     // this thread's stream
  const int gl = ln % G;                      // its lane among the key's G
  const bool live = sid < S;
  const int reach = a.MAXB * a.BS;
  // this thread's rows' q, read first: nothing below waits on them
  T qr[RP][SL][E], acc[RP][SL][E], m[RP], l[RP];
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int row = r0 + part * RP + i;
    const T* qp = static_cast<const T*>(a.q) + static_cast<int64_t>(row) * a.sqn +
                  static_cast<int64_t>(head) * a.sqa;
#pragma unroll
    for (int j = 0; j < SL; ++j)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = (gl + G * j) * E + e;
        qr[i][j][e] = row < a.N ? qp[d] : T(0);
      }
  }
  // bulk: lane l of warp 0 holds the table entry of the run's chunk (k &
  // ~31) + l of the rank it takes; for the first run (row r0's lane) and
  // rank read at once, beside the rows' own
  int ent = 0;
  if (a.bulk && tall < 32 && r0 < a.N && (rank + kRanks * ln) * kChunk < reach)
    ent = a.tables[static_cast<int64_t>(a.lane[r0]) * a.MAXB +
                   (rank + kRanks * ln) * kChunk / a.BS];

  // each row's lane, last key and window, then the runs: neighbouring
  // rows that share a lane and a window
  if (tall < R) {
    const int row = r0 + tall;
    s_last[tall] = -1;
    s_run[tall] = -1;
    s_refused[tall] = 0;
    if (row < a.N) {
      const int km = a.kmax[row];
      s_last[tall] = km < reach - 1 ? km : reach - 1;
      s_lane[tall] = a.lane[row];
      s_w0[tall] = a.win0[row];
      s_wr[tall] = a.wrow[row];
    }
  }
  if constexpr (kQ) {
    for (int d = tall; d < 2 * D; d += NT)
      s_sc[d / D][d % D] = (d < D ? a.ksc : a.vsc)[static_cast<int64_t>(head) * D + d % D];
  }
  __syncthreads();
  if (tall == 0) {
    int nruns = 0;
    for (int r = 0; r < R && r0 + r < a.N; ++r) {
      const int last = s_last[r], w0 = s_w0[r], wr0 = s_wr[r];
      const int rw0 = w0 >= 0 ? w0 : -1, rwk0 = w0 >= 0 ? wr0 - w0 : 0;
      // a window that does not lie within the launch's rows is refused
      // (its keys would otherwise be read back from slots this launch
      // writes): the row's output is NaN
      s_refused[r] = w0 >= 0 && w0 <= last && !(wr0 >= 0 && wr0 + (last - w0) < a.N);
      if (nruns == 0 || u_lane[nruns - 1] != s_lane[r] || u_w0[nruns - 1] != rw0 ||
          u_wrk0[nruns - 1] != rwk0) {
        u_lane[nruns] = s_lane[r];
        u_w0[nruns] = rw0;
        u_wrk0[nruns] = rwk0;
        u_last[nruns] = -1;
        ++nruns;
      }
      s_run[r] = nruns - 1;
      if (!s_refused[r] && last > u_last[nruns - 1]) u_last[nruns - 1] = last;
    }
    s_nruns = nruns;
    for (int s = 0; s < nring; ++s)
      mbar_init(smem_u32(&bars[s]), a.bulk ? 1u : static_cast<uint32_t>(NT));
    mbar_init(smem_u32(&cbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every block's cbar is initialised before any block pushes to it (the
  // wait is after its first rank's chunks)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const C* kh = static_cast<const C*>(a.kc) + static_cast<int64_t>(head) * a.ska;
  const C* vh = static_cast<const C*>(a.vc) + static_cast<int64_t>(head) * a.sva;
  const T scale = static_cast<T>(a.scale);

  // the chunks rank rx takes of run ux: rx, rx + 8, ... up to its last key
  auto mine_of = [&](int rx, int ux) {
    const int nch = u_last[ux] >= 0 ? u_last[ux] / kChunk + 1 : 0;
    return nch > rx ? (nch - 1 - rx) / kRanks + 1 : 0;
  };
  // Issue run ux's chunk k (rx + 8 k) of rank rx, the block's chunk base
  // + k, into slot (base + k) % nring; ent holds the run's table entries
  // of this rank's chunks (k & ~31) + lane.
  auto issue = [&](int rx, int ux, int k, int base) {
    const int ulast = u_last[ux], w0 = u_w0[ux], wrk0 = u_wrk0[ux];
    const int* tab = a.tables + static_cast<int64_t>(u_lane[ux]) * a.MAXB;
    auto windowed = [&](int t) { return w0 >= 0 && t >= w0; };
    const int c = rx + kRanks * k;
    const int slot = (base + k) % nring;
    C* dst = ring + static_cast<int64_t>(slot) * L::kSlotElems;
    const uint32_t bar = smem_u32(&bars[slot]);
    if (a.bulk) {
      if (tall >= 32) return;
      if (k > 0 && (k & 31) == 0) {
        const int kk = k + ln;
        ent = kk < mine_of(rx, ux) ? tab[(rx + kRanks * kk) * kChunk / a.BS] : 0;
      }
      const int64_t blk = __shfl_sync(kFull, ent, k & 31);
      const int64_t off = (c * kChunk) % a.BS;
      if (!windowed(c * kChunk + kChunk - 1) || !(a.bulk & 2)) {
        if (ln == 0) {
          if (windowed(c * kChunk)) {    // every key a new row's: no copy
            mbar_arrive(bar);
          } else {
            mbar_expect_tx(bar, L::kSlotBytes);
            bulk_load(smem_u32(dst), kh + blk * a.skb + off * a.skt, L::kChunkBytes, bar,
                      evict_first());
            bulk_load(smem_u32(dst + kChunk * D), vh + blk * a.svb + off * a.svt, L::kChunkBytes,
                      bar, evict_first());
          }
        }
      } else if constexpr (!kQ) {
        // the chunk reaches the window: row by row, lane i the K (i <
        // 16) or V row of position i % 16, from the cache below the
        // window and from the launch's new rows from it on (a float
        // cache only: an int8 cache's window keys are the new rows'
        // stored forms, put in place after the copy)
        const int i = ln % kChunk, kv = ln / kChunk, t = c * kChunk + i;
        const T* src = nullptr;
        if (t <= ulast && !windowed(t)) {
          src = kv ? vh + blk * a.svb + (off + i) * a.svt
                   : kh + blk * a.skb + (off + i) * a.skt;
        } else if (t <= ulast && wrk0 + t >= 0 && wrk0 + t < a.N) {
          src = static_cast<const T*>(kv ? a.v_new : a.k_new) +
                (static_cast<int64_t>(wrk0 + t) * a.sqn + static_cast<int64_t>(head) * a.sqa);
        }
        const unsigned rows = __ballot_sync(kFull, src != nullptr);
        constexpr uint32_t kRow = D * static_cast<uint32_t>(sizeof(T));
        if (ln == 0) {
          if (rows != 0u)
            mbar_expect_tx(bar, static_cast<uint32_t>(__popc(rows)) * kRow);
          else
            mbar_arrive(bar);
        }
        if (src != nullptr)
          bulk_load(smem_u32(dst + kv * kChunk * D + i * D), src, kRow, bar, evict_first());
      }
    } else {
      for (int p = tall; p < 2 * kChunk * L::NC; p += NT) {
        const int kv = p / (kChunk * L::NC);
        const int r = (p / L::NC) % kChunk;
        const int s = p % L::NC;
        const int t = c * kChunk + r;
        if (t <= ulast && !windowed(t)) {
          const int ub = t / a.BS;
          const int64_t blk = tab[ub];
          const int64_t off = t - ub * a.BS;
          const C* src = kv ? vh + blk * a.svb + off * a.svt : kh + blk * a.skb + off * a.skt;
          cp_async16(smem_u32(dst + kv * kChunk * D + r * D + s * L::CE), src + s * L::CE);
        }
      }
      cp_async_arrive(bar);
    }
  };

  int item = 0;  // chunks this block took so far: slot item % nring
  for (int rk = rank; rk < kRanks; rk += kVCluster) {   // the decode's rank rk
#pragma unroll
    for (int i = 0; i < RP; ++i) {
#pragma unroll
      for (int j = 0; j < SL; ++j)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][j][e] = T(0);
      m[i] = -INFINITY;
      l[i] = T(0);
    }
    for (int u = 0; u < s_nruns; ++u) {
      const int ulast = u_last[u], w0 = u_w0[u], wrk0 = u_wrk0[u];
      const int mine = mine_of(rk, u);
      // a position at or past the window's first key is a new row's
      auto windowed = [&](int t) { return w0 >= 0 && t >= w0; };
      if ((u > 0 || rk != rank) && a.bulk && tall < 32 && ln < mine)
        ent = a.tables[static_cast<int64_t>(u_lane[u]) * a.MAXB +
                       (rk + kRanks * ln) * kChunk / a.BS];
      const int first = mine < nring ? mine : nring;
      for (int k = 0; k < first; ++k) issue(rk, u, k, item);

      for (int k = 0; k < mine; ++k) {
        const int slot = (item + k) % nring;
        mbar_wait(smem_u32(&bars[slot]), static_cast<uint32_t>(((item + k) / nring) & 1));
        C* sk = ring + static_cast<int64_t>(slot) * L::kSlotElems;
        const C* sv = sk + kChunk * D;
        const int t0 = (rk + kRanks * k) * kChunk;
        if (windowed(t0 + kChunk - 1) && !(a.bulk & 2)) {
          // the window's keys from the launch's new rows (their stored
          // forms), in place
          for (int p = tall; p < 2 * kChunk * D; p += NT) {
            const int kv = p / (kChunk * D), i = (p / D) % kChunk, d = p % D;
            const int t = t0 + i, nr = wrk0 + t;
            if (windowed(t) && t <= ulast && nr >= 0 && nr < a.N)
              sk[kv * kChunk * D + i * D + d] = stored<C>(
                  static_cast<const T*>(kv ? a.v_new : a.k_new)
                      [static_cast<int64_t>(nr) * a.sqn + static_cast<int64_t>(head) * a.sqa + d],
                  scales(kv, d));
          }
          __syncthreads();
        }
        // this thread's rows that take this chunk
        int lastr[RP];
        bool act[RP];
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          const int r = part * RP + i;
          lastr[i] = s_last[r];
          act[i] = s_run[r] == u && !s_refused[r] && t0 <= lastr[i];
        }
        // the rows' scores, key by key: the decode kernel's dot product,
        // butterfly and masked score, for every row at once
        T sc[RP][KPS];
#pragma unroll
        for (int jj = 0; jj < KPS; ++jj) {
          const int i = (sid + S * jj) & (kChunk - 1);
          const int t = t0 + i;
          T kr[SL][E];
#pragma unroll
          for (int j = 0; j < SL; ++j)
            ldkv<false, T, E>(sk + i * D + (gl + G * j) * E, scales(0, (gl + G * j) * E),
                              kr[j]);
          T dot[RP];
#pragma unroll
          for (int x = 0; x < RP; ++x) {
            dot[x] = T(0);
#pragma unroll
            for (int j = 0; j < SL; ++j)
#pragma unroll
              for (int e = 0; e < E; ++e) dot[x] += qr[x][j][e] * kr[j][e];
          }
          // a butterfly over the key's G lanes: each ends with the same bits
#pragma unroll
          for (int off = G / 2; off > 0; off >>= 1)
#pragma unroll
            for (int x = 0; x < RP; ++x) dot[x] += __shfl_xor_sync(kFull, dot[x], off);
#pragma unroll
          for (int x = 0; x < RP; ++x)
            sc[x][jj] = live && t <= lastr[x] ? dot[x] * scale : T(-INFINITY);
        }
        // each row's running max, correction and V sums: the decode
        // kernel's operations on each row's values in its order, the rows
        // side by side (one read of a key's V slice serves them all)
        bool ok[RP][KPS], go[RP];
        T mx[RP];
#pragma unroll
        for (int x = 0; x < RP; ++x) {
#pragma unroll
          for (int jj = 0; jj < KPS; ++jj)
            ok[x][jj] = live && t0 + ((sid + S * jj) & (kChunk - 1)) <= lastr[x];
          mx[x] = m[x];
#pragma unroll
          for (int jj = 0; jj < KPS; ++jj) mx[x] = sc[x][jj] > mx[x] ? sc[x][jj] : mx[x];
          go[x] = act[x] && mx[x] != T(-INFINITY);   // a key of this stream so far
          if (go[x]) {
            const T corr = exp_(m[x] - mx[x]);   // 0 on the stream's first key
            l[x] *= corr;
#pragma unroll
            for (int j = 0; j < SL; ++j)
#pragma unroll
              for (int e = 0; e < E; ++e) acc[x][j][e] *= corr;
          }
        }
#pragma unroll
        for (int jj = 0; jj < KPS; ++jj) {
          const int i = (sid + S * jj) & (kChunk - 1);
          T vr[SL][E];
#pragma unroll
          for (int j = 0; j < SL; ++j)
            ldkv<false, T, E>(sv + i * D + (gl + G * j) * E, scales(1, (gl + G * j) * E),
                              vr[j]);
#pragma unroll
          for (int x = 0; x < RP; ++x) {
            if (!go[x] || !ok[x][jj]) continue;   // a masked key's V is never used
            const T p = exp_(sc[x][jj] - mx[x]);
            l[x] += p;
#pragma unroll
            for (int j = 0; j < SL; ++j)
#pragma unroll
              for (int e = 0; e < E; ++e) acc[x][j][e] += p * vr[j][e];
          }
        }
#pragma unroll
        for (int x = 0; x < RP; ++x)
          if (go[x]) m[x] = mx[x];
        if (k + nring < mine) {
          // this slot's reads are done: order them before the next copy into it
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncthreads();
          issue(rk, u, k + nring, item);
        }
      }
      item += mine;
      // the run's slots are read before the next run's copies (or the
      // partials) take them
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }

    // rank rk's partial: each row's streams' (m, l, acc), in the ring's
    // bytes. A rank with no chunk of any run has every row's no-key
    // partial (m -inf, l 0, acc 0).
    bool took = false;
    for (int u = 0; u < s_nruns; ++u) took |= u_last[u] >= rk * kChunk;
    T* s_acc = reinterpret_cast<T*>(dyn);            // [R][S][D]
    T* s_ml = s_acc + R * S * D;                     // [R][S][2]
    if (took && live) {
#pragma unroll
      for (int x = 0; x < RP; ++x) {
        const int r = part * RP + x;
        if (gl == 0) {
          s_ml[(r * S + sid) * 2] = m[x];
          s_ml[(r * S + sid) * 2 + 1] = l[x];
        }
#pragma unroll
        for (int j = 0; j < SL; ++j)
#pragma unroll
          for (int e = 0; e < E; ++e)
            s_acc[(r * S + sid) * D + (gl + G * j) * E + e] = acc[x][j][e];
      }
    }
    if (took) __syncthreads();
    // each row's rank-rk partial, its streams combined in stream order (a
    // thread takes E elements of a row), pushed to its owner's part_acc
    if (rk == rank) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int idx = tall; idx < R * (D / E); idx += NT) {
      const int r = idx / (D / E), sl = idx % (D / E);   // E elements of row r
      if (r0 + r >= a.N) break;
      const T* rm = s_ml + r * S * 2;
      T mb = T(-INFINITY);
      if (took) {
        mb = rm[0];
#pragma unroll
        for (int i = 1; i < S; ++i) mb = rm[2 * i] > mb ? rm[2 * i] : mb;
      }
      T lb = T(0), ob[E];
#pragma unroll
      for (int e = 0; e < E; ++e) ob[e] = T(0);
      if (mb != T(-INFINITY)) {
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const T w = exp_(rm[2 * i] - mb);      // 0 for a stream with no key
          lb += rm[2 * i + 1] * w;
#pragma unroll
          for (int e = 0; e < E; ++e) ob[e] += s_acc[(r * S + i) * D + sl * E + e] * w;
        }
      }
      const int to = r % kVCluster, pr = r / kVCluster;
      if (to == rank) {
#pragma unroll
        for (int e = 0; e < E; ++e) part_acc[pr][rk][sl * E + e] = ob[e];
        if (sl == 0) {
          part_ml[pr][rk][0] = mb;
          part_ml[pr][rk][1] = lb;
        }
      } else {
        const uint32_t bar = cluster_addr(smem_u32(&cbar), to);
        st_async(cluster_addr(smem_u32(&part_acc[pr][rk][sl * E]), to), ob, bar);
        if (sl == 0)
          st_async_pair(cluster_addr(smem_u32(&part_ml[pr][rk][0]), to), mb, lb, bar);
      }
    }
    // the partials' bytes are read before the next rank's copies take them
    if (took) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
  }

  // this block's rows: r = rank, rank + kVCluster, ... of the group, each
  // taking the 8 ranks' partials, all but this block's own pushed here
  int owned = 0;
  for (int r = rank; r < R && r0 + r < a.N; r += kVCluster) ++owned;
  if (owned == 0) return;
  if (tall == 0)
    mbar_expect_tx(smem_u32(&cbar), owned * (kRanks - kRanks / kVCluster) * (D + 2) *
                                        static_cast<uint32_t>(sizeof(T)));
  __syncthreads();
  mbar_wait(smem_u32(&cbar), 0);
  for (int idx = tall; idx < owned * D; idx += NT) {
    const int pr = idx / D, d = idx % D, r = rank + pr * kVCluster;
    const int row = r0 + r;
    const int64_t qoff = static_cast<int64_t>(row) * a.sqn + static_cast<int64_t>(head) * a.sqa;
    T mc = T(-INFINITY);
#pragma unroll
    for (int k = 0; k < kRanks; ++k) mc = part_ml[pr][k][0] > mc ? part_ml[pr][k][0] : mc;
    T res = T(0);                           // no key: the JAX mask's 0
    if (mc != T(-INFINITY)) {
      T lc = T(0), oc = T(0);
#pragma unroll
      for (int k = 0; k < kRanks; ++k) {
        const T w = exp_(part_ml[pr][k][0] - mc);   // 0 for a rank with no key
        lc += part_ml[pr][k][1] * w;
        oc += part_acc[pr][k][d] * w;
      }
      res = oc / lc;
    }
    static_cast<T*>(a.out)[(static_cast<int64_t>(row) * a.A + head) * D + d] =
        s_refused[r] ? T(NAN) : res;
    // the row's K/V into the cache: every block of the cluster is past its
    // reads (each pushed its partials)
    int wb = a.write_block[row];
    const int wo = wb >= 0 ? a.write_off[row] : 0;
    if (wb >= 0 && wb < a.NB && wo >= 0 && wo < a.BS) {
      static_cast<C*>(a.kc)[wb * a.skb + head * a.ska + wo * a.skt + d] =
          stored<C>(static_cast<const T*>(a.k_new)[qoff + d], scales(0, d));
      static_cast<C*>(a.vc)[wb * a.svb + head * a.sva + wo * a.svt + d] =
          stored<C>(static_cast<const T*>(a.v_new)[qoff + d], scales(1, d));
    }
  }
}

template <typename T, typename C, int D>
cudaError_t configure_verify() {
  static std::mutex mu;
  static std::set<int> raised;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  if (raised.count(dev) != 0) return cudaSuccess;
  e = cudaFuncSetAttribute(paged_verify_kernel<T, C, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, VLayout<T, C, D>::kBytes);
  if (e == cudaSuccess) raised.insert(dev);
  return e;
}

// ---------------------------------------------------------------------------
// The verify over an int8 cache in float32 (paged_verify_i8_kernel): the
// work and the bits of paged_verify_kernel (the same clusters, ranks, runs,
// chunk copies, stream partials and combine; row w the decode kernel's bits
// at last key pos0 + w), its per-key chain rebuilt. What held the first
// int8 form (paged_verify_kernel<float, int8_t, D>, now gone:
// experiments/paged_verify_study.py --cache int8 --parent builds it) back:
// a key's score was a 4-FMA partial a lane, then a 5-level shuffle
// butterfly, for every row in each of the key's 32 lanes; every K and V
// element an I2F (16 a clock an SM) in both warpgroups; every p and
// correction an exp in all 32 lanes of its stream; a window chunk's rows
// quantised into the ring element by element behind a barrier. Here a
// chunk goes through three phases, a barrier after each of the first two:
// 1. The chunk's K and V as float32 into shared memory, once a block:
//    each 4-byte word of int8 by byte permutes and one FADD a value
//    (i8x4: exact, so the I2F's bits), K rows padded by 8 floats. A window
//    key is the launch's new row in stored form, quantised once a block
//    for the group's 8 rows (s_new, while the first copies are on their
//    way); a chunk's bulk copy takes only its rows below the window.
// 2. Each (key, row) score in four threads, each summing a quarter of the
//    key's G lane partials (the decode lane's E-term FMA chain; the lanes
//    l = qb mod 4) in registers in the butterfly's own pairing, then two
//    shuffles for its last two levels: the decode's tree, so its bits
//    (float addition commutes, and every lane of a butterfly ends with the
//    same value). A thread keeps q's quarter-row in registers and takes 2
//    keys (a warp: 8 rows x 4 quarters).
// 3. Each row's running max, correction, p, l and V sums in the decode's
//    layout and order (a thread: a stream's lane, 4 rows): the stream's
//    exps made once, one or two a lane, passed round in shared memory.
// The float buffers are double-buffered and the ring is one slot, refilled
// as soon as phase 1 has read it. Every operation a row's bits depend on
// is the decode's, on the same operands in the same order, its rounding
// spelt out (__fmaf_rn, __fadd_rn, __fmul_rn). The float64 verify over an
// int8 cache keeps paged_verify_kernel (no fold: float(x) * s rounds in
// float32 first). What its time is (the study's variants, H100): at 8
// lanes x W 8 x context 512 about half is the chain of copies, waits,
// barriers and combines that the variant with no math keeps; the scores'
// tree in registers beat the shuffle butterfly, and two blocks a cluster
// beat one, four and eight.

constexpr int kQCluster = 2;     // blocks a cluster, as kVCluster
constexpr int kQRing = 1;        // int8 chunk slots a block
constexpr int kQMinBlocks = 2;   // blocks an SM the registers must allow
constexpr int kQThreads = 256;   // 8 warps: a chunk's 16 keys, 2 a warp

template <int D>
struct QLayout {
  using L = Layout<float, int8_t, D>;
  static constexpr int R = kVRows;
  static constexpr int S = L::kStreams;
  static constexpr int W = D / 4;             // 4-byte words of a cache row
  static constexpr int KP = D + 8;            // floats of a converted K row
  static constexpr int kRingBytes = kQRing * L::kSlotBytes;
  static constexpr int kBufFloats = kChunk * KP + kChunk * D;   // K, then V
  // two chunk buffers; between a rank's chunks and the next's the same
  // bytes hold the rows' stream partials
  static constexpr int kPartFloats = R * S * (D + 2);
  static constexpr int kWorkFloats = 2 * kBufFloats > kPartFloats ? 2 * kBufFloats : kPartFloats;
  static constexpr int kBytes = kRingBytes + kWorkFloats * 4;
};

// 4 int8 values (a little-endian word) as exact float32s: byte b with its
// sign bit flipped is b + 128 in [0, 255]; under the bits 0x4B000000 (2^23)
// it makes the float 2^23 + b + 128, and one FADD of -(2^23 + 128) leaves
// b exactly (the I2F's bits) without the conversion pipe.
__device__ __forceinline__ float4 i8x4(uint32_t w) {
  const uint32_t x = w ^ 0x80808080u;
  constexpr float kBias = -8388736.0f;
  return make_float4(__fadd_rn(__int_as_float(__byte_perm(x, 0x4B000000u, 0x7540)), kBias),
                     __fadd_rn(__int_as_float(__byte_perm(x, 0x4B000000u, 0x7541)), kBias),
                     __fadd_rn(__int_as_float(__byte_perm(x, 0x4B000000u, 0x7542)), kBias),
                     __fadd_rn(__int_as_float(__byte_perm(x, 0x4B000000u, 0x7543)), kBias));
}

// 4 values of a new row (src) in stored form at their scales (s), as one
// little-endian word: out of line, for the rare window key that is a row of
// another group, so that its divisions cost the chunk loop no registers.
__device__ __noinline__ uint32_t stored_word(const float* src, const float* s) {
  uint32_t x = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    x |= static_cast<uint32_t>(static_cast<uint8_t>(stored<int8_t>(src[e], s + e))) << (8 * e);
  return x;
}

// N consecutive floats of shared memory (on 4 N bytes) in one load
template <int N>
__device__ __forceinline__ void ld_row(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

template <int D>
__global__ void __cluster_dims__(kQCluster, 1, 1) __launch_bounds__(kQThreads, kQMinBlocks)
    paged_verify_i8_kernel(const Args a) {
  using L = Layout<float, int8_t, D>;
  using Q = QLayout<D>;
  constexpr int G = L::G, S = Q::S, KPS = L::KPS, W = Q::W, KP = Q::KP;
  constexpr int R = Q::R, NT = kQThreads, nring = kQRing;
  constexpr int RP = R / 2;        // rows of a thread's V sums
  constexpr int QN = G / 4;        // lane partials of a score a thread sums
  constexpr int NV = RP * KPS + RP;   // a stream's p and corrections of a chunk
  constexpr int PR = (R + kQCluster - 1) / kQCluster;   // rows a block combines
  extern __shared__ __align__(128) unsigned char dyn[];
  int8_t* ring = reinterpret_cast<int8_t*>(dyn);
  float* work = reinterpret_cast<float*>(dyn + Q::kRingBytes);
  __shared__ __align__(8) uint64_t bars[nring];
  // the scales of this head's channels, K's then V's
  __shared__ __align__(16) float s_sc[2][D];
  // the group's rows' K and V in stored form (the window's keys, and what
  // the rows write)
  __shared__ __align__(16) int8_t s_new[2][R][D];
  // a chunk's scores, key sid + S jj of row x at [x][sid][jj]; each (part,
  // stream)'s p (-1: none) and corrections, passed within its lanes
  __shared__ __align__(16) float s_score[R][S][KPS];
  __shared__ __align__(16) float s_ev[2][S][NV];
  __shared__ __align__(16) float part_ml[PR][kRanks][2];
  __shared__ __align__(16) float part_acc[PR][kRanks][D];
  __shared__ __align__(8) uint64_t cbar;
  __shared__ int s_last[R], s_lane[R], s_w0[R], s_wr[R], s_run[R], s_refused[R];
  __shared__ int u_lane[R], u_w0[R], u_wrk0[R], u_last[R];
  __shared__ int s_nruns;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t cid = blockIdx.x / kQCluster;   // the (group, head) of the cluster
  const int group = static_cast<int>(cid / a.A);
  const int head = static_cast<int>(cid - static_cast<int64_t>(group) * a.A);
  const int r0 = group * R;
  const int tall = threadIdx.x, ln = tall % 32;
  // phase 2: this thread's row, quarter (the lanes l = qb mod 4) and keys
  // (2 w, 2 w + 1 of warp w)
  const int xb = ln & 7, qb = ln >> 3, ib = 2 * (tall / 32);
  // phase 3: its rows part * RP .., its stream and lane, as the decode's
  const int part = tall / kThreads;
  const int tid = tall % kThreads, warp = tid / 32;
  const int sid = warp * L::GPW + ln / G;
  const int gl = ln % G;
  const bool live = sid < S;
  const int reach = a.MAXB * a.BS;
  const int64_t sqh = static_cast<int64_t>(head) * a.sqa;
  // q * s_k of this thread's score row at its quarter's lanes (lane 4 m +
  // qb: channels 4 (4 m + qb) ..), read first: nothing below waits on them
  float qh[QN][4];
  {
    const int row = r0 + xb;
    const float* qp = static_cast<const float*>(a.q) + static_cast<int64_t>(row) * a.sqn + sqh;
    const float* ks = a.ksc + static_cast<int64_t>(head) * D;
#pragma unroll
    for (int m = 0; m < QN; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (4 * m + qb) + e;
        qh[m][e] = row < a.N ? fold<true>(qp[d], ks + d) : 0.0f;
      }
  }
  // bulk: lane l of warp 0 holds the table entry of the run's chunk (k &
  // ~31) + l of the rank it takes; for the first run (row r0's lane) and
  // rank read at once, beside the rows' own
  int ent = 0;
  if (a.bulk && tall < 32 && r0 < a.N && (rank + kRanks * ln) * kChunk < reach)
    ent = a.tables[static_cast<int64_t>(a.lane[r0]) * a.MAXB +
                   (rank + kRanks * ln) * kChunk / a.BS];
  if (tall < R) {
    const int row = r0 + tall;
    s_last[tall] = -1;
    s_run[tall] = -1;
    s_refused[tall] = 0;
    if (row < a.N) {
      const int km = a.kmax[row];
      s_last[tall] = km < reach - 1 ? km : reach - 1;
      s_lane[tall] = a.lane[row];
      s_w0[tall] = a.win0[row];
      s_wr[tall] = a.wrow[row];
    }
  }
  for (int d = tall; d < 2 * D; d += NT)
    s_sc[d / D][d % D] = (d < D ? a.ksc : a.vsc)[static_cast<int64_t>(head) * D + d % D];
  // the group's new rows (this thread's NS values), read now and stored
  // (s_new) once the first chunks' copies are on their way
  constexpr int NS = (2 * R * D + NT - 1) / NT;
  float xnew[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int p = tall + NT * j, kv = p / (R * D), row = r0 + (p / D) % R;
    xnew[j] = p < 2 * R * D && row < a.N
                  ? static_cast<const float*>(kv ? a.v_new : a.k_new)
                        [static_cast<int64_t>(row) * a.sqn + sqh + p % D]
                  : 0.0f;
  }
  __syncthreads();
  if (tall == 0) {
    int nruns = 0;
    for (int r = 0; r < R && r0 + r < a.N; ++r) {
      const int last = s_last[r], w0 = s_w0[r], wr0 = s_wr[r];
      const int rw0 = w0 >= 0 ? w0 : -1, rwk0 = w0 >= 0 ? wr0 - w0 : 0;
      // a window that does not lie within the launch's rows is refused:
      // the row's output is NaN
      s_refused[r] = w0 >= 0 && w0 <= last && !(wr0 >= 0 && wr0 + (last - w0) < a.N);
      if (nruns == 0 || u_lane[nruns - 1] != s_lane[r] || u_w0[nruns - 1] != rw0 ||
          u_wrk0[nruns - 1] != rwk0) {
        u_lane[nruns] = s_lane[r];
        u_w0[nruns] = rw0;
        u_wrk0[nruns] = rwk0;
        u_last[nruns] = -1;
        ++nruns;
      }
      s_run[r] = nruns - 1;
      if (!s_refused[r] && last > u_last[nruns - 1]) u_last[nruns - 1] = last;
    }
    s_nruns = nruns;
    for (int s = 0; s < nring; ++s)
      mbar_init(smem_u32(&bars[s]), a.bulk ? 1u : static_cast<uint32_t>(NT));
    mbar_init(smem_u32(&cbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int8_t* kh = static_cast<const int8_t*>(a.kc) + static_cast<int64_t>(head) * a.ska;
  const int8_t* vh = static_cast<const int8_t*>(a.vc) + static_cast<int64_t>(head) * a.sva;
  const float scale = static_cast<float>(a.scale);

  auto mine_of = [&](int rx, int ux) {
    const int nch = u_last[ux] >= 0 ? u_last[ux] / kChunk + 1 : 0;
    return nch > rx ? (nch - 1 - rx) / kRanks + 1 : 0;
  };
  // Issue run ux's chunk k (rx + 8 k) of rank rx, the block's chunk base +
  // k, into slot (base + k) % nring: its rows below the run's window (all
  // 16 where it has none); ent holds the run's table entries of this
  // rank's chunks (k & ~31) + lane.
  auto issue = [&](int rx, int ux, int k, int base) {
    const int ulast = u_last[ux], w0 = u_w0[ux];
    const int* tab = a.tables + static_cast<int64_t>(u_lane[ux]) * a.MAXB;
    const int c = rx + kRanks * k;
    const int slot = (base + k) % nring;
    int8_t* dst = ring + static_cast<int64_t>(slot) * L::kSlotElems;
    const uint32_t bar = smem_u32(&bars[slot]);
    const int below = w0 < 0 ? kChunk : min(kChunk, max(0, w0 - c * kChunk));
    if (a.bulk) {
      if (tall >= 32) return;
      if (k > 0 && (k & 31) == 0) {
        const int kk = k + ln;
        ent = kk < mine_of(rx, ux) ? tab[(rx + kRanks * kk) * kChunk / a.BS] : 0;
      }
      const int64_t blk = __shfl_sync(kFull, ent, k & 31);
      const int64_t off = (c * kChunk) % a.BS;
      if (ln == 0) {
        if (below == 0) {
          mbar_arrive(bar);
        } else {
          const uint32_t n = static_cast<uint32_t>(below * D);
          mbar_expect_tx(bar, 2 * n);
          bulk_load(smem_u32(dst), kh + blk * a.skb + off * a.skt, n, bar, evict_first());
          bulk_load(smem_u32(dst + kChunk * D), vh + blk * a.svb + off * a.svt, n, bar,
                    evict_first());
        }
      }
    } else {
      for (int p = tall; p < 2 * kChunk * L::NC; p += NT) {
        const int kv = p / (kChunk * L::NC);
        const int r = (p / L::NC) % kChunk;
        const int s = p % L::NC;
        const int t = c * kChunk + r;
        if (t <= ulast && r < below) {
          const int ub = t / a.BS;
          const int64_t blk = tab[ub];
          const int64_t off = t - ub * a.BS;
          const int8_t* src = kv ? vh + blk * a.svb + off * a.svt : kh + blk * a.skb + off * a.skt;
          cp_async16(smem_u32(dst + kv * kChunk * D + r * D + s * L::CE), src + s * L::CE);
        }
      }
      cp_async_arrive(bar);
    }
  };

  // phase 1's words of this thread (NW a chunk): where each lies in a ring
  // slot and in the chunk's float buffer
  constexpr int NW = (2 * kChunk * W + NT - 1) / NT;
  int w_src[NW], w_dst[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int p = tall + NT * j;
    const int kv = p / (kChunk * W), i = (p / W) % kChunk, wd = p % W;
    w_src[j] = kv * kChunk * D + i * D + 4 * wd;
    w_dst[j] = kv ? kChunk * KP + i * D + 4 * wd : i * KP + 4 * wd;
  }

  // the first run's first chunks of this block's first rank on their way,
  // then the group's rows in stored form: one IEEE division an element
  for (int k = 0; k < mine_of(rank, 0) && k < nring; ++k) issue(rank, 0, k, 0);
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int p = tall + NT * j, kv = p / (R * D), r = (p / D) % R, d = p % D;
    if (p < 2 * R * D)
      s_new[kv][r][d] = r0 + r < a.N ? stored<int8_t>(xnew[j], &s_sc[kv][d]) : int8_t(0);
  }
  __syncthreads();

  // phase 3's rows' running max, sum of p and sums of p V (each lane of a
  // stream holds the stream's m and l)
  float m4[RP], l4[RP], acc[RP][4];
  int item = 0;  // chunks this block took so far: slot item % nring, buffer item % 2
  for (int rk = rank; rk < kRanks; rk += kQCluster) {   // the decode's rank rk
#pragma unroll
    for (int x = 0; x < RP; ++x) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][e] = 0.0f;
      m4[x] = -INFINITY;
      l4[x] = 0.0f;
    }
    for (int u = 0; u < s_nruns; ++u) {
      const int ulast = u_last[u], w0 = u_w0[u], wrk0 = u_wrk0[u];
      const int mine = mine_of(rk, u);
      if (u > 0 || rk != rank) {   // (the first run of the first rank: issued above)
        if (a.bulk && tall < 32 && ln < mine)
          ent = a.tables[static_cast<int64_t>(u_lane[u]) * a.MAXB +
                         (rk + kRanks * ln) * kChunk / a.BS];
        const int first = mine < nring ? mine : nring;
        for (int k = 0; k < first; ++k) issue(rk, u, k, item);
      }
      // phase 3's rows: their last keys (-1: not in this run)
      int last4[RP];
#pragma unroll
      for (int x = 0; x < RP; ++x) {
        const int r = part * RP + x;
        last4[x] = s_run[r] == u && !s_refused[r] ? s_last[r] : -1;
      }

      for (int k = 0; k < mine; ++k) {
        const int it = item + k, slot = it % nring;
        mbar_wait(smem_u32(&bars[slot]), static_cast<uint32_t>((it / nring) & 1));
        const int8_t* sk = ring + static_cast<int64_t>(slot) * L::kSlotElems;
        float* fk = work + (it & 1) * Q::kBufFloats;
        float* fv = fk + kChunk * KP;
        const int t0 = (rk + kRanks * k) * kChunk;
        // 1. the chunk as float32: the ring's rows, then from the window
        // on (rows the copy left out) the new rows' stored forms
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          if (NW * NT > 2 * kChunk * W && tall + NT * j >= 2 * kChunk * W) break;
          *reinterpret_cast<float4*>(fk + w_dst[j]) =
              i8x4(*reinterpret_cast<const uint32_t*>(sk + w_src[j]));
        }
        if (w0 >= 0 && t0 + kChunk - 1 >= w0) {
          for (int p = tall; p < 2 * kChunk * W; p += NT) {
            const int kv = p / (kChunk * W), i = (p / W) % kChunk, wd = p % W;
            const int t = t0 + i, nr = wrk0 + t;
            if (t < w0 || t > ulast || nr < 0 || nr >= a.N) continue;
            const uint32_t x =
                nr >= r0 && nr < r0 + R
                    ? *reinterpret_cast<const uint32_t*>(&s_new[kv][nr - r0][4 * wd])
                    : stored_word(static_cast<const float*>(kv ? a.v_new : a.k_new) +
                                      static_cast<int64_t>(nr) * a.sqn + sqh + 4 * wd,
                                  &s_sc[kv][4 * wd]);   // a row of another group
            *reinterpret_cast<float4*>(fk + (kv ? kChunk * KP + i * D : i * KP) + 4 * wd) =
                i8x4(x);
          }
        }
        // the slot is read: order that before the next copy into it
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (k + nring < mine) issue(rk, u, k + nring, item);
        // 2. the scores of keys ib, ib + 1: this quarter's lane partials
        // summed in the butterfly's pairing (level v pairs entries m and m
        // + (QN >> v): lanes l and l ^ 2 (QN >> v)), then lanes l ^ 2 and
        // l ^ 1 across the quarters
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float* kr = fk + (ib + b) * KP + 4 * qb;
          float pt[QN];
#pragma unroll
          for (int m = 0; m < QN; ++m) {
            const float4 kk = *reinterpret_cast<const float4*>(kr + 16 * m);
            float s = __fmaf_rn(qh[m][0], kk.x, 0.0f);
            s = __fmaf_rn(qh[m][1], kk.y, s);
            s = __fmaf_rn(qh[m][2], kk.z, s);
            pt[m] = __fmaf_rn(qh[m][3], kk.w, s);
          }
#pragma unroll
          for (int v = 1; (QN >> v) > 0; ++v)
#pragma unroll
            for (int m = 0; m < (QN + 1) / 2; ++m)
              if (m < (QN >> v)) pt[m] = __fadd_rn(pt[m], pt[m + (QN >> v)]);
          float dot = __fadd_rn(pt[0], __shfl_xor_sync(kFull, pt[0], 16));
          dot = __fadd_rn(dot, __shfl_xor_sync(kFull, dot, 8));
          if (qb == 0) s_score[xb][(ib + b) % S][(ib + b) / S] = __fmul_rn(dot, scale);
        }
        __syncthreads();
        // 3. each row's running max, correction, p, l and V sums in the
        // decode's order and layout: the stream's G lanes make its NV
        // exps, one or two a lane, and pass them round
        if (live) {
          float sc[RP][KPS], mx[RP];
          bool go[RP];
#pragma unroll
          for (int x = 0; x < RP; ++x) {
            float sr[KPS];
            ld_row<KPS>(&s_score[part * RP + x][sid][0], sr);
            mx[x] = m4[x];
#pragma unroll
            for (int jj = 0; jj < KPS; ++jj) {
              const int i = sid + S * jj;
              sc[x][jj] = t0 + i <= last4[x] ? sr[jj] : -INFINITY;
              mx[x] = sc[x][jj] > mx[x] ? sc[x][jj] : mx[x];
            }
            go[x] = t0 <= last4[x] && mx[x] != -INFINITY;
          }
          // value v: row v / KPS's p of its key v % KPS (v < RP KPS), else
          // row v - RP KPS's correction; -1 where the decode makes none
#pragma unroll
          for (int c = 0; c < (NV + G - 1) / G; ++c) {
            const int v = gl + G * c;
            if (v >= NV) break;
            const bool pv = v < RP * KPS;
            const int x = pv ? v / KPS : v - RP * KPS, jj = pv ? v % KPS : 0;
            float mxx = mx[0], mxm = m4[0];
            bool g0 = go[0];
            int lx = last4[0];
#pragma unroll
            for (int xx = 1; xx < RP; ++xx)
              if (xx == x) mxx = mx[xx], mxm = m4[xx], g0 = go[xx], lx = last4[xx];
            const float a0 = pv ? s_score[part * RP + x][sid][jj] : mxm;
            g0 = g0 && (!pv || t0 + sid + S * jj <= lx);
            s_ev[part][sid][v] = g0 ? exp_(a0 - mxx) : -1.0f;
          }
          __syncwarp();
          float pr[RP][KPS], corr[RP];
          ld_row<RP>(&s_ev[part][sid][RP * KPS], corr);
#pragma unroll
          for (int x = 0; x < RP; ++x) ld_row<KPS>(&s_ev[part][sid][x * KPS], pr[x]);
          __syncwarp();
#pragma unroll
          for (int x = 0; x < RP; ++x)
            if (go[x]) {
              l4[x] = __fmul_rn(l4[x], corr[x]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[x][e] = __fmul_rn(acc[x][e], corr[x]);
            }
#pragma unroll
          for (int jj = 0; jj < KPS; ++jj) {
            const int i = sid + S * jj;
            const float4 vv = *reinterpret_cast<const float4*>(fv + i * D + 4 * gl);
#pragma unroll
            for (int x = 0; x < RP; ++x) {
              const float p = pr[x][jj];
              if (!go[x] || t0 + i > last4[x]) continue;
              l4[x] = __fadd_rn(l4[x], p);
              acc[x][0] = __fmaf_rn(p, vv.x, acc[x][0]);
              acc[x][1] = __fmaf_rn(p, vv.y, acc[x][1]);
              acc[x][2] = __fmaf_rn(p, vv.z, acc[x][2]);
              acc[x][3] = __fmaf_rn(p, vv.w, acc[x][3]);
            }
          }
#pragma unroll
          for (int x = 0; x < RP; ++x)
            if (go[x]) m4[x] = mx[x];
        }
      }
      item += mine;
    }
    // the chunks' buffers are read before the partials take their bytes
    __syncthreads();

    // the rank's partial of each row's streams (m, l, acc) in the work
    // bytes; a rank with no chunk of any run has every row's no-key
    // partial (m -inf, l 0, acc 0)
    bool took = false;
    for (int u = 0; u < s_nruns; ++u) took |= u_last[u] >= rk * kChunk;
    float* s_acc = work;                             // [R][S][D]
    float* s_ml = s_acc + R * S * D;                 // [R][S][2]
    if (took) {
      if (live)
#pragma unroll
        for (int x = 0; x < RP; ++x) {
          const int rs = (part * RP + x) * S + sid;
          if (gl == 0) {
            s_ml[rs * 2] = m4[x];
            s_ml[rs * 2 + 1] = l4[x];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s_acc[rs * D + 4 * gl + e] = acc[x][e];
        }
      __syncthreads();
    }
    if (rk == rank) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int idx = tall; idx < R * (D / 4); idx += NT) {
      const int r = idx / (D / 4), sl = idx % (D / 4);   // 4 elements of row r
      if (r0 + r >= a.N) break;
      const float* rm = s_ml + r * S * 2;
      float mb = -INFINITY;
      if (took) {
        mb = rm[0];
#pragma unroll
        for (int i = 1; i < S; ++i) mb = rm[2 * i] > mb ? rm[2 * i] : mb;
      }
      float lb = 0.0f, ob[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (mb != -INFINITY) {
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const float w = exp_(rm[2 * i] - mb);      // 0 for a stream with no key
          lb += rm[2 * i + 1] * w;
#pragma unroll
          for (int e = 0; e < 4; ++e) ob[e] += s_acc[(r * S + i) * D + sl * 4 + e] * w;
        }
      }
      const int to = r % kQCluster, pr = r / kQCluster;
      if (to == rank) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part_acc[pr][rk][sl * 4 + e] = ob[e];
        if (sl == 0) {
          part_ml[pr][rk][0] = mb;
          part_ml[pr][rk][1] = lb;
        }
      } else {
        const uint32_t bar = cluster_addr(smem_u32(&cbar), to);
        st_async(cluster_addr(smem_u32(&part_acc[pr][rk][sl * 4]), to), ob, bar);
        if (sl == 0)
          st_async_pair(cluster_addr(smem_u32(&part_ml[pr][rk][0]), to), mb, lb, bar);
      }
    }
    // the partials' bytes are read before the next rank's chunks take them
    if (took) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
  }

  // this block's rows r = rank, rank + kQCluster, ... of the group, each
  // taking the 8 ranks' partials, all but this block's own pushed here
  int owned = 0;
  for (int r = rank; r < R && r0 + r < a.N; r += kQCluster) ++owned;
  if (owned == 0) return;
  if (tall == 0)
    mbar_expect_tx(smem_u32(&cbar),
                   owned * (kRanks - kRanks / kQCluster) * (D + 2) * static_cast<uint32_t>(4));
  __syncthreads();
  mbar_wait(smem_u32(&cbar), 0);
  for (int idx = tall; idx < owned * D; idx += NT) {
    const int pr = idx / D, d = idx % D, r = rank + pr * kQCluster;
    const int row = r0 + r;
    float mc8 = -INFINITY;
#pragma unroll
    for (int k = 0; k < kRanks; ++k) mc8 = part_ml[pr][k][0] > mc8 ? part_ml[pr][k][0] : mc8;
    float res = 0.0f;                       // no key: the JAX mask's 0
    if (mc8 != -INFINITY) {
      float lc8 = 0.0f, oc8 = 0.0f;
#pragma unroll
      for (int k = 0; k < kRanks; ++k) {
        const float w = exp_(part_ml[pr][k][0] - mc8);   // 0 for a rank with no key
        lc8 += part_ml[pr][k][1] * w;
        oc8 += part_acc[pr][k][d] * w;
      }
      res = fold<true>(oc8, &s_sc[1][d]) / lc8;
    }
    static_cast<float*>(a.out)[(static_cast<int64_t>(row) * a.A + head) * D + d] =
        s_refused[r] ? NAN : res;
  }
  // the rows' K/V into the cache in stored form, 16 bytes a store: every
  // block of the cluster is past its reads (each pushed its partials)
  for (int p = tall; p < owned * 2 * (D / 16); p += NT) {
    const int pr = p / (2 * (D / 16)), kv = (p / (D / 16)) % 2, c16 = p % (D / 16);
    const int r = rank + pr * kQCluster, row = r0 + r;
    const int wb = a.write_block[row];
    const int wo = wb >= 0 ? a.write_off[row] : 0;
    if (wb >= 0 && wb < a.NB && wo >= 0 && wo < a.BS) {
      int8_t* dst = kv ? static_cast<int8_t*>(a.vc) + wb * a.svb + head * a.sva + wo * a.svt
                       : static_cast<int8_t*>(a.kc) + wb * a.skb + head * a.ska + wo * a.skt;
      *reinterpret_cast<uint4*>(dst + 16 * c16) =
          *reinterpret_cast<const uint4*>(&s_new[kv][r][16 * c16]);
    }
  }
}

template <int D>
cudaError_t configure_verify_i8() {
  static std::mutex mu;
  static std::set<int> raised;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> lock(mu);
  if (raised.count(dev) != 0) return cudaSuccess;
  e = cudaFuncSetAttribute(paged_verify_i8_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, QLayout<D>::kBytes);
  if (e == cudaSuccess) raised.insert(dev);
  return e;
}

template <int D>
int launch_verify_i8(Args a, int64_t N, cudaStream_t st) {
  constexpr int R = kVRows;
  // a chunk's 16 rows are one contiguous run of the slab
  a.bulk = a.skt == D && a.svt == D && a.BS % kChunk == 0;
  const cudaError_t attr = configure_verify_i8<D>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  paged_verify_i8_kernel<D><<<static_cast<unsigned>((N + R - 1) / R * a.A * kQCluster),
                              kQThreads, QLayout<D>::kBytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// bulk: bit 1, a chunk's 16 rows are one contiguous run of the slab; bit 2,
// the new rows are on 16 bytes too (a chunk reaching the window is copied
// row by row, the window's rows from the launch's new rows; never for an
// int8 cache, whose window keys are the new rows' stored forms).
template <typename T, typename C, int D>
int launch_verify(Args a, int64_t N, cudaStream_t st) {
  if constexpr (sizeof(T) == 4 && sizeof(C) == 1) {
    return launch_verify_i8<D>(a, N, st);
  } else {
    constexpr int R = kVRows;
    const int64_t es = static_cast<int64_t>(sizeof(T));
    a.bulk = a.BS % kChunk == 0 && a.skt == D && a.svt == D
                 ? 1 | (sizeof(C) == sizeof(T) && aligned16(a.k_new) && aligned16(a.v_new) &&
                                (a.sqn * es) % 16 == 0 && (a.sqa * es) % 16 == 0
                            ? 2
                            : 0)
                 : 0;
    const cudaError_t attr = configure_verify<T, C, D>();
    if (attr != cudaSuccess) return static_cast<int>(attr);
    paged_verify_kernel<T, C, D><<<static_cast<unsigned>((N + R - 1) / R * a.A * kVCluster),
                                   kThreads * VLayout<T, C, D>::P, VLayout<T, C, D>::kBytes,
                                   st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_verify_d(int64_t D, const Args& a, int64_t N, cudaStream_t st) {
  const bool q8 = a.ksc != nullptr;
  switch (D) {
    case 16: return q8 ? launch_verify<T, int8_t, 16>(a, N, st) : launch_verify<T, T, 16>(a, N, st);
    case 32: return q8 ? launch_verify<T, int8_t, 32>(a, N, st) : launch_verify<T, T, 32>(a, N, st);
    case 64: return q8 ? launch_verify<T, int8_t, 64>(a, N, st) : launch_verify<T, T, 64>(a, N, st);
    case 128:
      return q8 ? launch_verify<T, int8_t, 128>(a, N, st) : launch_verify<T, T, 128>(a, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


}  // namespace dec

// q, k_new, v_new [N, A, D] at strides (sqn, sqa, 1); kc, vc
// [NB, A, BS, D] at strides (skb, ska, skt, 1) and (svb, sva, svt, 1), each
// row on 16 bytes; tables [S, MAXB], lane [N], kmax [N], write_block [N]
// and write_off [N] int32, contiguous; out [N, A, D] contiguous. With
// k_new == nullptr there is no write (v_new, write_block and write_off are
// not read). dtype (q's, k_new's, v_new's and out's): 1 float32, 2
// float64. k_scale and v_scale: nullptr, kc and vc of dtype; or both [A, D]
// float32 contiguous, kc and vc int8 (the int8 cache). Returns the
// launch's cudaError_t.
extern "C" int dl4j_paged_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* kc, void* vc,
    const void* k_scale, const void* v_scale, const void* tables, const void* lane,
    const void* kmax, const void* write_block, const void* write_off, void* out, int64_t N,
    int64_t A, int64_t D, int64_t BS, int64_t MAXB, int64_t NB, int64_t S, int64_t sqn,
    int64_t sqa, int64_t skb, int64_t ska, int64_t skt, int64_t svb,
    int64_t sva, int64_t svt, double scale, int dtype,
    void* stream) {
  if (N <= 0 || A <= 0) return 0;
  if (BS < 1 || MAXB < 1 || MAXB * BS >= (int64_t{1} << 31) ||
      N * A * dec::kRanks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k_new != nullptr && (v_new == nullptr || write_block == nullptr || write_off == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t es = k_scale != nullptr ? 1 : (dtype == 2 ? 8 : 4);
  if (!dec::aligned16(kc) || !dec::aligned16(vc) ||
      ((skb | ska | skt | svb | sva | svt) * es) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dec::Args a{q, k_new, v_new, kc, vc, static_cast<const int*>(tables),
              static_cast<const int*>(lane), static_cast<const int*>(kmax),
              k_new != nullptr ? static_cast<const int*>(write_block) : nullptr,
              static_cast<const int*>(write_off), nullptr, nullptr, out,
              static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
              static_cast<int>(N), static_cast<int>(A), static_cast<int>(BS),
              static_cast<int>(MAXB), static_cast<int>(NB), static_cast<int>(S), 0,
              sqn, sqa, skb, ska, skt, svb, sva, svt, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dec::launch_d<float>(D, a, N, st);
  if (dtype == 2) return dec::launch_d<double>(D, a, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A speculative verify's layer (paged_verify_kernel): the rows of every
// lane's window (row r of lane lane[r], last key kmax[r]), each row's K/V
// written at (write_block[r], write_off[r]) (-1: none), and the keys
// win0[r] .. kmax[r] taken from k_new/v_new rows wrow[r] + (t - win0[r])
// (win0[r] -1: none), the bits the launch writes there; keys below win0[r]
// come from the cache through the table; a row whose window does not lie
// within the N rows (wrow[r] < 0 or wrow[r] + (kmax[r] - win0[r]) >= N)
// gets NaN, its write still made. A row's output is the decode entry's
// for the same row, last key and keys, bit for bit: the same keys to the
// same streams, the same sums in the same order. Any window length runs in
// one launch; the rows of one lane's window share its chunks' copies where
// they are neighbours in a group of kVRows (8). Arguments as
// dl4j_paged_decode_attention (an int8 cache too), with win0 [N] and wrow
// [N] int32, contiguous; k_new is required.
extern "C" int dl4j_paged_verify_attention(
    const void* q, const void* k_new, const void* v_new, void* kc, void* vc,
    const void* k_scale, const void* v_scale, const void* tables, const void* lane,
    const void* kmax, const void* win0, const void* wrow, const void* write_block,
    const void* write_off, void* out, int64_t N, int64_t A, int64_t D, int64_t BS, int64_t MAXB, int64_t NB, int64_t S, int64_t sqn,
    int64_t sqa, int64_t skb, int64_t ska, int64_t skt, int64_t svb,
    int64_t sva, int64_t svt, double scale, int dtype,
    void* stream) {
  if (N <= 0 || A <= 0) return 0;
  if (BS < 1 || MAXB < 1 || MAXB * BS >= (int64_t{1} << 31) ||
      N * A * dec::kRanks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k_new == nullptr || v_new == nullptr || write_block == nullptr || write_off == nullptr ||
      win0 == nullptr || wrow == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t es = k_scale != nullptr ? 1 : (dtype == 2 ? 8 : 4);
  if (!dec::aligned16(kc) || !dec::aligned16(vc) ||
      ((skb | ska | skt | svb | sva | svt) * es) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dec::Args a{q, k_new, v_new, kc, vc, static_cast<const int*>(tables),
              static_cast<const int*>(lane), static_cast<const int*>(kmax),
              static_cast<const int*>(write_block), static_cast<const int*>(write_off),
              static_cast<const int*>(win0), static_cast<const int*>(wrow), out,
              static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
              static_cast<int>(N), static_cast<int>(A), static_cast<int>(BS),
              static_cast<int>(MAXB), static_cast<int>(NB), static_cast<int>(S), 0,
              sqn, sqa, skb, ska, skt, svb, sva, svt, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return dec::launch_verify_d<float>(D, a, N, st);
  if (dtype == 2) return dec::launch_verify_d<double>(D, a, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The decode kernel at head dim D, dtype as dl4j_paged_decode_attention's,
// over an int8 cache where int8 is nonzero: its resident blocks an SM in
// blocks[0] and the clusters the card holds at once in blocks[1]. Returns
// the cudaError_t.
extern "C" int dl4j_paged_decode_occupancy(int64_t D, int dtype, int int8, int* blocks) {
  if (dtype == 1) return dec::occupancy_d<float>(D, int8 != 0, blocks);
  if (dtype == 2) return dec::occupancy_d<double>(D, int8 != 0, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}
