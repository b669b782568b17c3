// The LSTM recurrence for Hopper (sm_90a): one launch a layer and a
// direction over the whole sequence, each timestep's recurrent product and
// the cell inside it.
//
// Replaces no TPU kernel: the JAX package writes the recurrence in jnp, as
// the body of `lax.scan` in `lstm_layer` (deeplearning4j_tpu/ops/nn_ops.py
// :539-556) around `lstm_cell` (:520-536, h_prev @ w_hh included), and XLA
// fused that body. kernels/lstm.py hoists x @ W_ih + b for all timesteps
// into one GEMM before the forward kernel, and leaves dx, dW_ih, dW_hh and
// db to single GEMMs and a sum after the backward one, as the JAX package
// left those products to XLA. The plain PyTorch versions are
// `lstm_recurrence_fwd_plain` and `lstm_recurrence_bwd_plain` there.
//
// Gate order [i, f, g, o] (sigmoid, sigmoid, tanh, sigmoid); time-major
// rows of B examples and U units; every array contiguous:
//
//   forward: z [T, B, 4U] holds gx_t = x_t W_ih + b on entry and the
//   activated gates on exit (the backward's saved gates); w [U, 4U]; h0, c0
//   [B, U]; hs, cs [T, B, U] are written. For t = 0 .. T-1:
//     i, f, g, o = act(gx_t + h_{t-1} W_hh)   (h_{-1} = h0, c_{-1} = c0)
//     c_t = f c_{t-1} + i g,  h_t = o tanh(c_t)
//
//   backward: the saved gates, cs, c0, w, the output gradient d_hs [T, B,
//   U] and dh_T, dc_T [B, U] (each may be null: zero). For t = T-1 .. 0:
//     dh = d_hs[t] + dh_carried,  tc = tanh(c_t)
//     dc = dc_carried + dh o (1 - tc^2)
//     dz_i = dc g i (1 - i),  dz_f = dc c_{t-1} f (1 - f)
//     dz_g = dc i (1 - g^2),  dz_o = dh tc o (1 - o)
//     dc_carried = dc f,  dh_carried = dz_t W_hh^T
//   writes dz [T, B, 4U], and dh0, dc0 (the carried gradients after t = 0).
//
// What bounds it on an H100: for one TextGenLSTM layer over a TBPTT chunk
// (B 32, T 50, U 256, float32) each direction moves about 17.5 MB (W_hh
// once; gx, the gates, hs and cs, or the gates, cs, d_hs and dz), 5.2 us at
// 3.35 TB/s, and multiplies 0.84 GFLOP, 5.1 us at 3xTF32's 165 TFLOP/s.
// Neither is what sets its time: each step waits on the one before it
// through h_t (dh), so the chain of T steps sets a floor of T times a
// step's latency, which no bound of bytes or operations captures. Of a
// step (experiments/lstm_recurrence_study.py takes it apart; the numbers
// are in PERF.md) about a third is the product, whose mma.sync tf32 issue
// at a quarter of the tensor cores' rate and whose fragment loads and
// splits take as long again; the cluster barrier, the pushes, the cell's
// activations, the stage copies and the output stores share the rest.
//
// What the design does about the chain:
// - One launch does all T steps. A thread-block cluster of R blocks (R <=
//   16; above 8 the non-portable cluster size) takes a tile of bt = 8 NT
//   batch rows; rows are independent, so more rows are more clusters. Block
//   k of the cluster owns nu = ceil(U / R) hidden units J_k and their four
//   gate columns of W_hh, a [U, 4 nu] slice. The slice is loaded once a
//   launch into shared memory (the resident form; at U = 256 and R = 16 it
//   is 64 KiB) and serves both directions: the forward multiplies h_{t-1}
//   by it, the backward dz_t[:, gates(J_k)] by its transpose. Where it does
//   not fit (float32 past U of about 380), the streamed form (below) reads
//   the slice and the exchanged vector from global memory (L2) each step,
//   at any U.
// - The forward's exchange: each block pushes its units' h_t (staged in
//   shared memory with the step's other outputs) to every block's
//   double-buffered h tile through distributed shared memory (mapa +
//   st.shared::cluster, 16 bytes a store, from all its threads), then the
//   cluster meets once a step
//   (barrier.cluster arrive.release after the pushes, wait.acquire before
//   the next step's product; the step's gates, h and c, staged in shared
//   memory, go to global memory from the whole block in between, so the
//   barrier's release waits on no global store). Double buffering makes
//   that one barrier enough: a tile is rewritten two steps after it was
//   read, and every block has passed the barrier in between.
// - The backward's exchange: block k's product is a partial dh for every
//   unit ([bt, U], over its own gate columns); it pushes the columns of
//   unit owner m into m's receive slot for rank k, and after the barrier
//   each block sums the R partials of its own units in rank order. No
//   atomics: two calls give the same bits.
// - The product runs on the tensor cores. Float32: 3xTF32 on
//   mma.sync.m16n8k8 (sm90.cuh: tf32_split, mma_tf32), products summed in
//   float32 to about 2^-21 of their size, so PyTorch's default (TF32 off
//   for a float32 product) keeps its accuracy. The forward's A operand is
//   the slice's transpose (M: 32 gate columns a group of 8 units, ordered
//   [i x 8, f x 8, g x 8, o x 8]), B is h^T (N: 8 batch rows a tile), so a
//   thread's accumulators hold all four gates of one unit for two rows: the
//   cell runs on them, and z never goes to memory except as the saved
//   gates. The K (U) range is split over the block's 8 warps and the
//   partial sums added in a fixed order. The backward's A is the slice
//   itself (M: units, K: the block's gate columns), B is dz^T. Each warp
//   keeps the small (lo.hi + hi.lo) and the large (hi.hi) terms, of even
//   and of odd k steps, in four accumulators: four independent mma chains,
//   where one accumulator made each step's latency a chain of 3 K/8 mma.
//   Float64: the same structure with the product in double FMAs, a thread
//   computing the entries an mma fragment would hold.
// - A resident float32 slice is stored in its direction's fragment order
//   (load_frags): a fragment is one 16-byte load a lane, free of bank
//   conflicts and of address arithmetic. A float64 slice is stored in rows
//   with a 4-column XOR swizzle on bit 2 of the row (row stride 8 mod 32
//   words).
// - The next step's inputs are prefetched: the forward's gx rows, the
//   backward's saved gates, c_t, c_{t-1} and d_hs rows are copied by
//   cp.async into a second stage while the current step's product runs, 16
//   bytes a copy where every block's units start on 16 bytes (else an
//   element).
// - The cell is spread over up to 8 warps (a group's row pairs split
//   between warps); the cell state stays in shared memory of its owning
//   thread for the whole sequence (c forward, dc backward).
// No allocation and no host sync: the wrappers launch on PyTorch's current
// stream (cudaLaunchKernelEx with the cluster dimension), so CUDA graphs
// capture the launches; kernel attributes are set on a launch or occupancy
// query before any capture.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <mutex>
#include <set>
#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRanks = 16;
constexpr int64_t kSmemLimit = 232448;   // a block's shared memory on Hopper

// The resident kernels' work split and shared-memory layout of one block,
// from U, the cluster's R blocks and NT batch tiles of 8 rows.
// kernels/lstm.py `recurrence_geometry` is the same arithmetic.
struct RecGeo {
  int nu;      // units a block (the last block may own fewer)
  int ng;      // groups of 8 units a block
  int nc;      // gate columns a block, padded: 32 a group
  int up;      // U padded to 16 (the backward's M, the forward's K)
  int bt;      // batch rows a cluster
  int ldw;     // the slice's row stride [up][ldw]
  int ldh;     // the h tile's row stride [bt][ldh]
  int ldg;     // a stage or output plane's, the cell state's and a partial's [bt][ldg]
  int ldz;     // dz^T's [bt][ldz]
  int kt;      // k steps of 8 in the forward's product
  int ksplit;  // the forward's K range split over this many warps
  int kper;    // k steps a split (even, as kt)
  int items;   // the forward's (group, split) products
  int parts;   // the cell's (row pair) parts a group, each a warp's
  int64_t w;   // elements of the slice
  // elem: the value's bytes. A float32 slice is kept in the direction's mma
  // fragment order [up * nc], a float64 one as rows [up][ldw].
  __host__ __device__ RecGeo(int U, int R, int nt, int elem) {
    nu = (U + R - 1) / R;
    ng = (nu + 7) / 8;
    nc = 32 * ng;
    up = (U + 15) / 16 * 16;
    bt = 8 * nt;
    ldw = nc + 8;
    ldh = up + 4;
    ldg = 8 * ng + 4;
    ldz = nc + 4;
    kt = up / 8;
    const int want = ng >= kWarps ? 1 : kWarps / ng;
    ksplit = want < kt ? want : kt;
    kper = ((kt + ksplit - 1) / ksplit + 1) / 2 * 2;   // even: k steps go in pairs
    items = ng * ksplit;
    parts = want < 2 * nt ? want : 2 * nt;
    w = static_cast<int64_t>(up) * (elem == 4 ? nc : ldw);
  }
  // the slice, h [2][bt][ldh], the partial products [items][8 nt][32], the
  // gx stages [2][4][bt][ldg], c [bt][ldg] and the step's outputs [6][bt][ldg]
  __host__ __device__ int64_t fwd_elems(int nt) const {
    return w + 2LL * bt * ldh + static_cast<int64_t>(items) * 8 * nt * 32 + 15LL * bt * ldg;
  }
  // the slice, the partial dh [2][R][bt][ldg], dz^T [bt][ldz], the stages
  // [2][7][bt][ldg] and dc [bt][ldg]
  __host__ __device__ int64_t bwd_elems(int R) const {
    return w + 2LL * R * bt * ldg + static_cast<int64_t>(bt) * ldz + 15LL * bt * ldg;
  }
};

template <typename T>
struct FwdArgs {
  T* z;          // [steps, B, 4U]: gx in, the activated gates out
  const T* w;    // [U, 4U]
  const T* h0;   // [B, U]
  const T* c0;
  T* hs;         // [steps, B, U]
  T* cs;
  int64_t steps, B;
  int U, R;
  int vec;       // 16-byte copies (every row and the blocks' units on 16 bytes)
};

template <typename T>
struct BwdArgs {
  const T* gates;   // [steps, B, 4U]
  const T* cs;      // [steps, B, U]
  const T* c0;      // [B, U]
  const T* w;       // [U, 4U]
  const T* d_hs;    // [steps, B, U] or null
  const T* dh_T;    // [B, U] or null
  const T* dc_T;
  T* dz;            // [steps, B, 4U]
  T* dh0;           // [B, U]
  T* dc0;
  int64_t steps, B;
  int U, R;
  int vec;
};

// `local`, a shared-memory address of this block, as block `rank`'s
__device__ __forceinline__ uint32_t peer(const void* local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(local)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void st_peer(uint32_t addr, double v) {
  asm volatile("st.shared::cluster.f64 [%0], %1;\n" ::"r"(addr), "d"(v) : "memory");
}
__device__ __forceinline__ void st_peer16(uint32_t addr, const uint4 v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// global -> shared, one element or 16 bytes; `valid` false writes zeros
// and reads nothing
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)), "l"(src),
               "n"(static_cast<int>(sizeof(T))), "r"(valid ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Global rows into shared memory, every thread of the block (cp.async;
// the caller commits): row r's first lim(r) of n elements from src(r) to
// dst(r, c), the rest zero-filled and not read. 16 bytes a copy where
// `vec` (n, every lim(r), the rows and the pointers on 16 bytes), else an
// element; `any` is a global address the zero fills name.
//
// A row's copies are rounded up to a power of two (their index a shift and
// a mask, not a division); those past n write nothing (a zero fill there
// would land in the next row), those in [lim(r), n) write zeros.
__device__ __forceinline__ int log2_ceil(int x) { return x > 1 ? 32 - __clz(x - 1) : 0; }

template <typename T, typename Src, typename Lim, typename Dst>
__device__ __forceinline__ void copy_rows(int rows, int n, bool vec, const T* any, Src src, Lim lim,
                                          Dst dst) {
  const int step = vec ? 16 / static_cast<int>(sizeof(T)) : 1, sh = log2_ceil(n / step);
  for (int e = threadIdx.x; e < rows << sh; e += kThreads) {
    const int r = e >> sh, c = (e & ((1 << sh) - 1)) * step;
    if (c >= n) continue;
    const bool ok = c < lim(r);
    const T* s = ok ? src(r) + c : any;
    if (vec)
      cp_async16(dst(r, c), s, ok);
    else
      cp_async(dst(r, c), s, ok);
  }
}

// Shared rows to global memory, every thread of the block: row r's first
// lim(r) of n elements from src(r) to dst(r); 16 bytes a store where
// `vec`.
template <typename T, typename Src, typename Lim, typename Dst>
__device__ __forceinline__ void store_rows(int rows, int n, bool vec, Src src, Lim lim, Dst dst) {
  const int step = vec ? 16 / static_cast<int>(sizeof(T)) : 1, sh = log2_ceil(n / step);
  for (int e = threadIdx.x; e < rows << sh; e += kThreads) {
    const int r = e >> sh, c = (e & ((1 << sh) - 1)) * step;
    if (c >= lim(r)) continue;
    if (vec)
      *reinterpret_cast<uint4*>(dst(r) + c) = *reinterpret_cast<const uint4*>(src(r) + c);
    else
      dst(r)[c] = src(r)[c];
  }
}

// Shared rows to every block of the cluster, every thread of the block:
// row r = (rank, row) goes from src(row % rows) to block rank's dst(row)
// (its own address of the same place), lim elements of n, 16 bytes a
// store where `vec`.
template <typename T, int ROWS, typename Src, typename Dst>
__device__ __forceinline__ void push_rows(int ranks, int n, int lim, bool vec, Src src, Dst dst) {
  const int step = vec ? 16 / static_cast<int>(sizeof(T)) : 1, sh = log2_ceil(n / step);
  for (int e = threadIdx.x; e < ranks * ROWS << sh; e += kThreads) {
    const int r = e >> sh, c = (e & ((1 << sh) - 1)) * step;
    if (c >= lim) continue;
    const uint32_t to = peer(dst(r % ROWS) + c, r / ROWS);
    if (vec)
      st_peer16(to, *reinterpret_cast<const uint4*>(src(r % ROWS) + c));
    else
      st_peer(to, src(r % ROWS)[c]);
  }
}

// Block-local gate column cl of unit jj (0 <= jj < 8 ng) and gate q: groups
// of 8 units, each 32 columns [i x 8, f x 8, g x 8, o x 8].
__device__ __forceinline__ int col_q(int cl) { return (cl >> 3) & 3; }
__device__ __forceinline__ int col_unit(int cl) { return (cl >> 5) * 8 + (cl & 7); }
// the slice's element (u, cl): 4-column XOR swizzle on bit 2 of u
__device__ __forceinline__ int slice_at(int u, int cl, int ldw) {
  return u * ldw + (cl ^ (((u >> 2) & 1) << 2));
}

// The products' A operands, W_hh entries by (m, k) of the fragment they
// fill; kFragOf: a float32 slice in fragment order, read a fragment at a
// time.
//
// The resident slice: float32 by fragment (frag(f, lane) is the four values
// lane holds of the slice's f-th 16 x 8 A fragment, load_frags), float64 in
// swizzled rows, (u, block-local gate column cl).
template <typename T>
struct Resident {
  const T* s;
  int ldw;
  __device__ __forceinline__ T operator()(int u, int cl) const { return s[slice_at(u, cl, ldw)]; }
  __device__ __forceinline__ float4 frag(int f, int lane) const {
    return *reinterpret_cast<const float4*>(s + f * 128 + lane * 4);
  }
};

// The streamed forward's: W_hh[u, gate column cl of units j0 .. j0 + nr)
// from global memory, 0 past U and past nr.
template <typename T>
struct Cols {
  const T* g;
  int U, j0, nr;
  __device__ __forceinline__ T operator()(int u, int cl) const {
    const int jj = col_unit(cl);
    return u < U && jj < nr ? __ldg(g + static_cast<int64_t>(u) * 4 * U + col_q(cl) * U + j0 + jj)
                            : T(0);
  }
};

// The streamed backward's: W_hh[j0 + u, k] (row u of units j0 .. j0 + nr,
// any of the 4U gate columns) from global memory, 0 past nr and past 4U.
template <typename T>
struct Rows {
  const T* g;
  int U, j0, nr;
  __device__ __forceinline__ T operator()(int u, int k) const {
    return u < nr && k < 4 * U ? __ldg(g + static_cast<int64_t>(j0 + u) * 4 * U + k) : T(0);
  }
};

template <typename W>
constexpr bool kFragOf = false;
template <>
constexpr bool kFragOf<Resident<float>> = true;

// The products' B operands by (batch row, k): a tile in shared memory
// (zero past its columns), or rows of a global array that other blocks of
// the cluster wrote this launch, read at L2 (ld.global.cg: no stale L1
// line), zero past `rows` and `n`.
template <typename T>
struct SmemTile {
  const T* p;
  int ld;
  __device__ __forceinline__ T operator()(int r, int k) const { return p[r * ld + k]; }
};
template <typename T>
struct GlobalTile {
  const T* p;
  int64_t ld;
  int rows, n;
  __device__ __forceinline__ T operator()(int r, int k) const {
    return r < rows && k < n ? __ldcg(p + r * ld + k) : T(0);
  }
};

__device__ __forceinline__ void tf32_split4(const float4 v, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  tf32_split(v.x, hi[0], lo[0]);
  tf32_split(v.y, hi[1], lo[1]);
  tf32_split(v.z, hi[2], lo[2]);
  tf32_split(v.w, hi[3], lo[3]);
}

// One k step of the forward's float32 product: the small terms (lo.hi +
// hi.lo) into sm, the large (hi.hi) into bg.
template <int NT, typename W, typename H>
__device__ __forceinline__ void fwd_kstep(const W& w, const H& hp, int G, int kt, int kk, int lane,
                                          float (&sm)[2][NT][4], float (&bg)[2][NT][4]) {
  const int gi = lane >> 2, ti = lane & 3, u0 = kk * 8 + ti, u1 = u0 + 4;
  uint32_t ah[2][4], al[2][4];
  if constexpr (kFragOf<W>) {
    // fragments 2 (G kt + kk) + h: one 16-byte load each
#pragma unroll
    for (int h = 0; h < 2; ++h) tf32_split4(w.frag((G * kt + kk) * 2 + h, lane), ah[h], al[h]);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = G * 32 + h * 16 + gi;
      tf32_split(w(u0, m), ah[h][0], al[h][0]);
      tf32_split(w(u0, m + 8), ah[h][1], al[h][1]);
      tf32_split(w(u1, m), ah[h][2], al[h][2]);
      tf32_split(w(u1, m + 8), ah[h][3], al[h][3]);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t bh[2], bl[2];
    tf32_split(hp(n * 8 + gi, u0), bh[0], bl[0]);
    tf32_split(hp(n * 8 + gi, u1), bh[1], bl[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mma_tf32(sm[h][n], al[h], bh);
      mma_tf32(sm[h][n], ah[h], bl);
      mma_tf32(bg[h][n], ah[h], bh);
    }
  }
}

// The streamed form's float32 products run their mma chains kFlush k steps
// at a time, adding each run's sums into the result in float32 (round to
// nearest): the tensor cores' accumulation loses low bits an mma, an error
// that grows with the chain, and its K is 4U a warp (the resident form's
// chains are at most 24 k steps and run whole: FLUSH 0).
constexpr int kFlush = 16;

// The forward's product for group G over k steps [k0, k1): acc[h][n] is the
// m16n8 C fragment of gate rows G*32 + 16h .. +15 (rows gi: gate 2h, gi + 8:
// gate 2h + 1, of unit G*8 + gi) and batch rows 8n .. 8n + 7, of
// h_{t-1} @ W_hh[:, those columns]. Float32: 3xTF32 with the small and the
// large terms, and the even and odd k steps, in accumulators of their own
// (four independent mma chains, a quarter of one chain's latency).
template <typename T, int NT, int FLUSH, typename W, typename H>
__device__ __forceinline__ void fwd_product(const W& w, const H& hp, int G, int kt, int k0, int k1,
                                            int lane, T (&acc)[2][NT][4]) {
  const int gi = lane >> 2, ti = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][n][e] = T(0);
  if constexpr (std::is_same<T, float>::value) {
    for (int kb = k0; kb < k1;) {
      const int kend = FLUSH && kb + FLUSH < k1 ? kb + FLUSH : k1;
      float sm[2][2][NT][4] = {}, bg[2][2][NT][4] = {};
#pragma unroll 2
      for (int kk = kb; kk < kend; kk += 2) {   // k1 - k0 is even
        fwd_kstep<NT>(w, hp, G, kt, kk, lane, sm[0], bg[0]);
        fwd_kstep<NT>(w, hp, G, kt, kk + 1, lane, sm[1], bg[1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = (bg[0][h][n][e] + bg[1][h][n][e]) + (sm[0][h][n][e] + sm[1][h][n][e]);
            if constexpr (FLUSH != 0)
              acc[h][n][e] += v;
            else
              acc[h][n][e] = v;
          }
      kb = kend;
    }
  } else {
    for (int u = k0 * 8; u < k1 * 8; ++u) {
      T wv[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wv[h][0] = w(u, G * 32 + h * 16 + gi);
        wv[h][1] = w(u, G * 32 + h * 16 + gi + 8);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T x0 = hp(n * 8 + 2 * ti, u), x1 = hp(n * 8 + 2 * ti + 1, u);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[h][n][0] += wv[h][0] * x0;
          acc[h][n][1] += wv[h][0] * x1;
          acc[h][n][2] += wv[h][1] * x0;
          acc[h][n][3] += wv[h][1] * x1;
        }
      }
    }
  }
}

// One k step of the backward's float32 product (as fwd_kstep); nk: the
// resident slice's k steps a fragment row.
template <int NT, typename W, typename Z>
__device__ __forceinline__ void bwd_kstep(const W& w, const Z& dz, int mt, int nk, int kk, int lane,
                                          float (&sm)[NT][4], float (&bg)[NT][4]) {
  const int gi = lane >> 2, ti = lane & 3, k = kk * 8 + ti, u = mt * 16 + gi;
  uint32_t ah[4], al[4];
  if constexpr (kFragOf<W>) {
    tf32_split4(w.frag(mt * nk + kk, lane), ah, al);   // fragment mt nk + kk
  } else {
    tf32_split(w(u, k), ah[0], al[0]);
    tf32_split(w(u + 8, k), ah[1], al[1]);
    tf32_split(w(u, k + 4), ah[2], al[2]);
    tf32_split(w(u + 8, k + 4), ah[3], al[3]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    uint32_t bh[2], bl[2];
    tf32_split(dz(n * 8 + gi, k), bh[0], bl[0]);
    tf32_split(dz(n * 8 + gi, k + 4), bh[1], bl[1]);
    mma_tf32(sm[n], al, bh);
    mma_tf32(sm[n], ah, bl);
    mma_tf32(bg[n], ah, bh);
  }
}

// The backward's product for units mt*16 .. +15 over k steps [k0, k1) of
// gate columns: acc[n] is the m16n8 C fragment of (W_hh[u, those columns]
// . dz^T[those columns, batch rows 8n ..]), a part of dh for those units
// (float32: four accumulators, as fwd_product).
template <typename T, int NT, int FLUSH, typename W, typename Z>
__device__ __forceinline__ void bwd_product(const W& w, const Z& dz, int mt, int nk, int k0, int k1,
                                            int lane, T (&acc)[NT][4]) {
  const int gi = lane >> 2, ti = lane & 3, u = mt * 16 + gi;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = T(0);
  if constexpr (std::is_same<T, float>::value) {
    for (int kb = k0; kb < k1;) {
      const int kend = FLUSH && kb + FLUSH < k1 ? kb + FLUSH : k1;
      float sm[2][NT][4] = {}, bg[2][NT][4] = {};
#pragma unroll 2
      for (int kk = kb; kk < kend; kk += 2) {   // k1 - k0 is even
        bwd_kstep<NT>(w, dz, mt, nk, kk, lane, sm[0], bg[0]);
        bwd_kstep<NT>(w, dz, mt, nk, kk + 1, lane, sm[1], bg[1]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = (bg[0][n][e] + bg[1][n][e]) + (sm[0][n][e] + sm[1][n][e]);
          if constexpr (FLUSH != 0)
            acc[n][e] += v;
          else
            acc[n][e] = v;
        }
      kb = kend;
    }
  } else {
    for (int k = k0 * 8; k < k1 * 8; ++k) {
      const T w0 = w(u, k), w1 = w(u + 8, k);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T x0 = dz(n * 8 + 2 * ti, k), x1 = dz(n * 8 + 2 * ti + 1, k);
        acc[n][0] += w0 * x0;
        acc[n][1] += w0 * x1;
        acc[n][2] += w1 * x0;
        acc[n][3] += w1 * x1;
      }
    }
  }
}

// The resident float32 slice in the direction's fragment order (the
// forward's A is the slice's transpose, the backward's the slice): element
// e = 128 f + 4 lane + i is value i (a0 .. a3: rows g, g + 8, g, g + 8 at
// columns t, t, t + 4, t + 4 of lane = 4 g + t) of fragment f; the forward's
// fragment f = 2 (G kt + kk) + h covers gate rows G*32 + 16h .. and k step
// kk, the backward's f = mt nc/8 + kk units mt*16 .. and k step kk. An
// element a cp.async (a launch's one reorder), zero past U and past the
// block's units (the caller commits).
template <bool FWD>
__device__ __forceinline__ void load_frags(float* ws, const float* w, const RecGeo& g, int U, int j0,
                                           int nr) {
  for (int e = threadIdx.x; e < g.up * g.nc; e += kThreads) {
    const int f = e >> 7, lane = (e >> 2) & 31, i = e & 3, gi = lane >> 2, ti = lane & 3;
    int u, cl;
    if (FWD) {
      const int kk = (f >> 1) % g.kt, G = (f >> 1) / g.kt;
      u = kk * 8 + ti + (i >> 1) * 4;
      cl = G * 32 + (f & 1) * 16 + gi + (i & 1) * 8;
    } else {
      const int kk = f % (g.nc / 8), mt = f / (g.nc / 8);
      u = mt * 16 + gi + (i & 1) * 8;
      cl = kk * 8 + ti + (i >> 1) * 4;
    }
    const int jj = col_unit(cl);
    const bool ok = u < U && jj < nr;
    cp_async(ws + e, ok ? w + static_cast<int64_t>(u) * 4 * U + col_q(cl) * U + j0 + jj : w, ok);
  }
}

// The resident float64 slice: this block's gate columns of W_hh in rows
// [up][ldw], zero past U and past its units, a row of a gate's 8 columns of
// a group at a time (cp.async; the caller commits). The swizzle keeps a
// 16-byte run of columns contiguous.
template <typename T>
__device__ __forceinline__ void load_slice(T* ws, const T* w, const RecGeo& g, int U, int j0, int nr,
                                           bool vec) {
  // row r: (u, group G, gate q) = (r / 4ng, r % 4ng / 4, r % 4)
  const int per_u = 4 * g.ng;
  copy_rows<T>(
      g.up * per_u, 8, vec, w,
      [&](int r) { return w + static_cast<int64_t>(r / per_u) * 4 * U + (r & 3) * U + j0 + (r % per_u >> 2) * 8; },
      [&](int r) { return r / per_u < U ? min(8, max(0, nr - (r % per_u >> 2) * 8)) : 0; },
      [&](int r, int c) { return ws + slice_at(r / per_u, (r % per_u >> 2) * 32 + (r & 3) * 8 + c, g.ldw); });
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1) lstm_recurrence_fwd_kernel(const FwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RecGeo g(a.U, a.R, NT, sizeof(T));
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* hbuf = ws + g.w;                             // [2][bt][ldh]
  T* red = hbuf + 2 * g.bt * g.ldh;               // [items][8 NT][32]
  T* gxs = red + g.items * 8 * NT * 32;           // [2][4][bt][ldg]
  T* cst = gxs + 8 * g.bt * g.ldg;                // [bt][ldg]
  T* outs = cst + g.bt * g.ldg;                   // [6][bt][ldg]: gates, h, c
  const int rank = cluster_rank();
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / a.R) * g.bt;
  const int j0 = rank * g.nu, nr = min(g.nu, a.U - j0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2, ti = lane & 3;
  const int64_t U4 = 4LL * a.U;
  const bool vec = a.vec != 0;
  const Resident<T> W{ws, g.ldw};

  constexpr int BT = 8 * NT;   // g.bt: row maps divide by a constant
  // step t's gx of this block's units and rows (plane q, row b) into stage s
  auto stage = [&](int64_t t, int s) {
    copy_rows<T>(
        4 * BT, 8 * g.ng, vec, a.z,
        [&](int r) { return a.z + (t * a.B + row0 + r % BT) * U4 + (r / BT) * a.U + j0; },
        [&](int r) { return row0 + r % BT < a.B ? nr : 0; },
        [&](int r, int c) { return gxs + (s * 4 * BT + r) * g.ldg + c; });
  };

  if constexpr (std::is_same<T, float>::value)
    load_frags<true>(ws, a.w, g, a.U, j0, nr);
  else
    load_slice(ws, a.w, g, a.U, j0, nr, vec);
  stage(0, 0);
  cp_async_commit();
  // h_{-1} in tile 1 (tile 0 zero: its columns past U stay so)
  for (int e = tid; e < 2 * g.bt * g.ldh; e += kThreads) {
    const int u = e % g.ldh, b = (e / g.ldh) % g.bt, s = e / (g.ldh * g.bt);
    hbuf[e] = s == 1 && u < a.U && row0 + b < a.B ? a.h0[(row0 + b) * a.U + u] : T(0);
  }
  for (int e = tid; e < g.bt * g.ldg; e += kThreads) {
    const int jj = e % g.ldg, b = e / g.ldg;
    cst[e] = jj < nr && row0 + b < a.B ? a.c0[(row0 + b) * a.U + j0 + jj] : T(0);
  }
  cp_async_wait<0>();
  cluster_arrive();   // every block's tiles are set before any block pushes
  for (int64_t t = 0; t < a.steps; ++t) {
    const int s = static_cast<int>(t & 1);
    cluster_wait();   // h_{t-1} from every block (the tiles, at t = 0)
    if (t + 1 < a.steps) stage(t + 1, s ^ 1);
    cp_async_commit();
    // h_{t-1} @ W_hh[:, this block's columns], K split over the warps
    const SmemTile<T> hp{hbuf + (s ^ 1) * g.bt * g.ldh, g.ldh};
    for (int it = warp; it < g.items; it += kWarps) {
      const int G = it % g.ng, ks = it / g.ng;
      const int k0 = ks * g.kper, k1 = min(g.kt, k0 + g.kper);
      T acc[2][NT][4];
      fwd_product<T, NT, 0>(W, hp, G, g.kt, k0, k1, lane, acc);
      T* r = red + it * 8 * NT * 32 + lane;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) r[((h * NT + n) * 4 + e) * 32] = acc[h][n][e];
    }
    cp_async_wait<1>();   // stage t landed
    __syncthreads();
    // the cell: a thread's unit G*8 + gi, rows 8n + 2ti + e for its part's
    // (n, e) pairs; the step's outputs into outs
    T* hnext = hbuf + s * g.bt * g.ldh;
    const T* gx = gxs + s * 4 * g.bt * g.ldg;
    for (int it = warp; it < g.ng * g.parts; it += kWarps) {
      const int G = it % g.ng, jj = G * 8 + gi;
      for (int pe = it / g.ng; pe < 2 * NT; pe += g.parts) {
        const int n = pe >> 1, e = pe & 1, b = n * 8 + 2 * ti + e;
        T z[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const T* p = red + (G * 8 * NT + ((q >> 1) * NT + n) * 4 + (q & 1) * 2 + e) * 32 + lane;
          T v = p[0];
          for (int ks = 1; ks < g.ksplit; ++ks) v += p[ks * g.ng * 8 * NT * 32];
          z[q] = gx[(q * g.bt + b) * g.ldg + jj] + v;
        }
        const T i = sigmoid_(z[0]), f = sigmoid_(z[1]), gg = tanh_(z[2]), o = sigmoid_(z[3]);
        T* cp = cst + b * g.ldg + jj;
        const T cn = f * *cp + i * gg;
        const T hn = o * tanh_(cn);
        *cp = cn;
        T* out = outs + b * g.ldg + jj;
        out[0] = i;
        out[g.bt * g.ldg] = f;
        out[2 * g.bt * g.ldg] = gg;
        out[3 * g.bt * g.ldg] = o;
        out[4 * g.bt * g.ldg] = hn;
        out[5 * g.bt * g.ldg] = cn;
      }
    }
    __syncthreads();
    // h_t of this block's units into every block's tile
    push_rows<T, BT>(
        a.R, 8 * g.ng, nr, vec, [&](int b) { return outs + (4 * BT + b) * g.ldg; },
        [&](int b) { return hnext + b * g.ldh + j0; });
    cluster_arrive();   // h_t pushed
    // the step's gates (over gx), h and c, while the cluster meets
    store_rows<T>(
        6 * BT, nr, vec, [&](int r) { return outs + r * g.ldg; },
        [&](int r) { return row0 + r % BT < a.B ? nr : 0; },
        [&](int r) {
          const int p = r / BT;
          const int64_t row = t * a.B + row0 + r % BT;
          return p < 4 ? a.z + row * U4 + p * a.U + j0 : (p == 4 ? a.hs : a.cs) + row * a.U + j0;
        });
  }
  cluster_wait();   // no block exits while another still pushes into it
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1) lstm_recurrence_bwd_kernel(const BwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RecGeo g(a.U, a.R, NT, sizeof(T));
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* recv = ws + g.w;                             // [2][R][bt][ldg]
  T* dzs = recv + 2 * a.R * g.bt * g.ldg;         // [bt][ldz]
  T* stg = dzs + g.bt * g.ldz;                    // [2][7][bt][ldg]
  T* dcs = stg + 14 * g.bt * g.ldg;               // [bt][ldg]
  const int rank = cluster_rank();
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / a.R) * g.bt;
  const int j0 = rank * g.nu, nr = min(g.nu, a.U - j0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2, ti = lane & 3;
  const int64_t U4 = 4LL * a.U;
  const int part = a.R * g.bt * g.ldg;            // a receive slot
  const bool vec = a.vec != 0;
  const Resident<T> W{ws, g.ldw};

  constexpr int BT = 8 * NT;   // g.bt: row maps divide by a constant
  // step t's planes into stage s: gates i, f, g, o; c_t; c_{t-1}; d_hs[t]
  auto stage = [&](int64_t t, int s) {
    copy_rows<T>(
        7 * BT, 8 * g.ng, vec, a.gates,
        [&](int r) {
          const int p = r / BT;
          const int64_t row = row0 + r % BT;
          if (p < 4) return a.gates + (t * a.B + row) * U4 + p * a.U + j0;
          if (p == 4) return a.cs + (t * a.B + row) * a.U + j0;
          if (p == 5) return t > 0 ? a.cs + ((t - 1) * a.B + row) * a.U + j0 : a.c0 + row * a.U + j0;
          return a.d_hs + (t * a.B + row) * a.U + j0;
        },
        [&](int r) { return row0 + r % BT < a.B && (r < 6 * BT || a.d_hs != nullptr) ? nr : 0; },
        [&](int r, int c) { return stg + (s * 7 * BT + r) * g.ldg + c; });
  };

  if constexpr (std::is_same<T, float>::value)
    load_frags<false>(ws, a.w, g, a.U, j0, nr);
  else
    load_slice(ws, a.w, g, a.U, j0, nr, vec);
  stage(a.steps - 1, static_cast<int>((a.steps - 1) & 1));
  cp_async_commit();
  for (int e = tid; e < g.bt * g.ldg; e += kThreads) {
    const int jj = e % g.ldg, b = e / g.ldg;
    dcs[e] = a.dc_T != nullptr && jj < nr && row0 + b < a.B ? a.dc_T[(row0 + b) * a.U + j0 + jj] : T(0);
  }
  for (int e = tid; e < g.bt * g.ldz; e += kThreads) dzs[e] = T(0);
  cp_async_wait<0>();
  cluster_arrive();   // every block's buffers are set before any block pushes
  for (int64_t t = a.steps - 1; t >= 0; --t) {
    const int s = static_cast<int>(t & 1);
    cluster_wait();   // step t + 1's partials from every block
    if (t > 0) stage(t - 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // stage t landed
    __syncthreads();      // (and the last step's dz is stored: dzs is free)
    // the cell's gradient: a thread's unit G*8 + gi, rows 8n + 2ti + e for
    // its part's (n, e) pairs
    const T* in = stg + s * 7 * g.bt * g.ldg;
    const T* dhp = recv + (s ^ 1) * part;         // the R partials of step t + 1
    for (int it = warp; it < g.ng * g.parts; it += kWarps) {
      const int G = it % g.ng, jj = G * 8 + gi;
      const bool unit = jj < nr;
      for (int pe = it / g.ng; pe < 2 * NT; pe += g.parts) {
        const int n = pe >> 1, e = pe & 1, b = n * 8 + 2 * ti + e, at = b * g.ldg + jj;
        T dhn = T(0);
        if (t == a.steps - 1) {
          if (a.dh_T != nullptr && unit && row0 + b < a.B) dhn = a.dh_T[(row0 + b) * a.U + j0 + jj];
        } else {
          dhn = dhp[at];
          for (int r = 1; r < a.R; ++r) dhn += dhp[r * g.bt * g.ldg + at];
        }
        const T dh = in[(6 * g.bt + b) * g.ldg + jj] + dhn;
        const T i = in[b * g.ldg + jj], f = in[(g.bt + b) * g.ldg + jj];
        const T gg = in[(2 * g.bt + b) * g.ldg + jj], o = in[(3 * g.bt + b) * g.ldg + jj];
        const T ct = in[(4 * g.bt + b) * g.ldg + jj], cp = in[(5 * g.bt + b) * g.ldg + jj];
        const T tc = tanh_(ct);
        const T dc = dcs[at] + dh * o * (T(1) - tc * tc);
        T dz[4] = {dc * gg * i * (T(1) - i), dc * cp * f * (T(1) - f), dc * i * (T(1) - gg * gg),
                   dh * tc * o * (T(1) - o)};
        if (!unit) dz[0] = dz[1] = dz[2] = dz[3] = T(0);
        dcs[at] = unit ? dc * f : T(0);
#pragma unroll
        for (int q = 0; q < 4; ++q) dzs[b * g.ldz + G * 32 + q * 8 + gi] = dz[q];
      }
    }
    __syncthreads();
    // this block's part of dz_t W_hh^T for every unit, pushed to each
    // unit's owner (its slot for this rank)
    T* mine = recv + s * part + rank * g.bt * g.ldg;
    for (int mt = warp; mt < g.up / 16; mt += kWarps) {
      T acc[NT][4];
      bwd_product<T, NT, 0>(W, SmemTile<T>{dzs, g.ldz}, mt, g.nc / 8, 0, g.nc / 8, lane, acc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int u = mt * 16 + gi + 8 * hh;
        if (u < a.U) {
          const int owner = u / g.nu, ju = u - owner * g.nu;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              st_peer(peer(mine + (n * 8 + 2 * ti + e) * g.ldg + ju, owner), acc[n][hh * 2 + e]);
        }
      }
    }
    cluster_arrive();   // the partials pushed
    // dz_t, while the cluster meets: row r is gate q's 8 columns of group G
    // at batch row b, (G, q, b) = (r / BT / 4, r / BT % 4, r % BT)
    store_rows<T>(
        4 * g.ng * BT, 8, vec, [&](int r) { return dzs + (r % BT) * g.ldz + (r / BT) * 8; },
        [&](int r) { return row0 + r % BT < a.B ? min(8, max(0, nr - (r / BT >> 2) * 8)) : 0; },
        [&](int r) {
          return a.dz + (t * a.B + row0 + r % BT) * U4 + (r / BT & 3) * a.U + j0 + (r / BT >> 2) * 8;
        });
  }
  cluster_wait();   // step 0's partials; no block exits while another pushes
  // dh0 = the partials of step 0, dc0 = the carried dc
  for (int e = tid; e < g.bt * nr; e += kThreads) {
    const int b = e / nr, jj = e - b * nr, at = b * g.ldg + jj;
    if (row0 + b >= a.B) continue;
    T dh = recv[at];
    for (int r = 1; r < a.R; ++r) dh += recv[r * g.bt * g.ldg + at];
    a.dh0[(row0 + b) * a.U + j0 + jj] = dh;
    a.dc0[(row0 + b) * a.U + j0 + jj] = dcs[at];
  }
}

// The streamed form, for widths whose slice does not fit shared memory: the
// same cluster of R blocks and ownership of units, 8 batch rows a cluster,
// but W_hh is read from global memory (L2) every step, and so is the
// exchanged vector: a block stores its units' h_t (dz_t) to the output in
// global memory before the cluster's barrier (its release orders those
// stores before every block's wait), and every block reads the whole of it
// at L2 after. The backward's product is then each block's own: dh for its
// units is dz_{t+1} (all 4U gate columns) times its units' rows of W_hh,
// no partials. A block takes its units in passes of kPass, each pass's
// product, over K split between the warps, summed in shared memory in a
// fixed order, then its cell, which reads and writes global memory (the
// carried c and dc in cs and dc0). Its shared memory is the partial
// products alone, so it takes any U.
constexpr int kPass = 64;
constexpr int kStreamFwdElems = kWarps * 8 * 32;   // a warp's m32n8 product
constexpr int kStreamBwdElems = kWarps * 4 * 32;   // a warp's m16n8 product

// n products over ksteps (even) k steps of 8: the K range split over
// ksplit warps of kper (even) steps each
__device__ __forceinline__ void split_k(int n, int ksteps, int& ksplit, int& kper) {
  const int want = n >= kWarps ? 1 : kWarps / n;
  ksplit = want < ksteps ? want : ksteps;
  kper = ((ksteps + ksplit - 1) / ksplit + 1) / 2 * 2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) lstm_stream_fwd_kernel(const FwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);   // [items][8][32]
  const int rank = cluster_rank(), nu = (a.U + a.R - 1) / a.R;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / a.R) * 8;
  const int rows = a.B - row0 < 8 ? static_cast<int>(a.B - row0) : 8;
  const int j0 = rank * nu, nr = min(nu, a.U - j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gi = lane >> 2, ti = lane & 3;
  const int kt = (a.U + 15) / 16 * 2;
  const int64_t U4 = 4LL * a.U;
  for (int64_t t = 0; t < a.steps; ++t) {
    if (t > 0) cluster_wait();   // h_{t-1} of every block stored
    const T* hprev = t > 0 ? a.hs + ((t - 1) * a.B + row0) * a.U : a.h0 + row0 * a.U;
    const T* cprev = t > 0 ? a.cs + ((t - 1) * a.B + row0) * a.U : a.c0 + row0 * a.U;
    const GlobalTile<T> hp{hprev, a.U, rows, a.U};
    for (int p0 = 0; p0 < nr; p0 += kPass) {
      const int pr = min(kPass, nr - p0), ng = (pr + 7) / 8;
      int ksplit, kper;
      split_k(ng, kt, ksplit, kper);
      const Cols<T> W{a.w, a.U, j0 + p0, pr};
      for (int it = warp; it < ng * ksplit; it += kWarps) {
        const int G = it % ng, k0 = it / ng * kper, k1 = min(kt, k0 + kper);
        T acc[2][1][4];
        fwd_product<T, 1, kFlush>(W, hp, G, kt, k0, k1, lane, acc);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[(it * 8 + h * 4 + e) * 32 + lane] = acc[h][0][e];
      }
      __syncthreads();
      // the cell: a thread's unit G*8 + gi of the pass, rows 2ti + e
      const int parts = ng >= kWarps ? 1 : (kWarps / ng < 2 ? kWarps / ng : 2);
      for (int it = warp; it < ng * parts; it += kWarps) {
        const int G = it % ng, jj = G * 8 + gi;
        for (int e = it / ng; e < 2; e += parts) {
          const int b = 2 * ti + e;
          if (jj >= pr || b >= rows) continue;
          const int j = j0 + p0 + jj;
          T* zr = a.z + (t * a.B + row0 + b) * U4 + j;
          T z[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const T* p = red + (G * 8 + (q >> 1) * 4 + (q & 1) * 2 + e) * 32 + lane;
            T v = p[0];
            for (int ks = 1; ks < ksplit; ++ks) v += p[ks * ng * 8 * 32];
            z[q] = zr[q * a.U] + v;
          }
          const T i = sigmoid_(z[0]), f = sigmoid_(z[1]), gg = tanh_(z[2]), o = sigmoid_(z[3]);
          const T cn = f * cprev[b * a.U + j] + i * gg;
          zr[0] = i;
          zr[a.U] = f;
          zr[2 * a.U] = gg;
          zr[3 * a.U] = o;
          const int64_t at = (t * a.B + row0 + b) * a.U + j;
          a.hs[at] = o * tanh_(cn);
          a.cs[at] = cn;
        }
      }
      __syncthreads();   // the partials are the next pass's
    }
    cluster_arrive();   // h_t stored
  }
  cluster_wait();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) lstm_stream_bwd_kernel(const BwdArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);   // [items][4][32]
  const int rank = cluster_rank(), nu = (a.U + a.R - 1) / a.R;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / a.R) * 8;
  const int rows = a.B - row0 < 8 ? static_cast<int>(a.B - row0) : 8;
  const int j0 = rank * nu, nr = min(nu, a.U - j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kt = (4 * a.U + 15) / 16 * 2;   // k steps over the 4U gate columns
  const int64_t U4 = 4LL * a.U;
  // dz_s @ W_hh[units p0 .. p0 + pr of this block, :]^T into red; the split
  auto carried = [&](int64_t s, int p0, int pr, int& mts, int& ksplit) {
    mts = (pr + 15) / 16;
    int kper;
    split_k(mts, kt, ksplit, kper);
    const Rows<T> W{a.w, a.U, j0 + p0, pr};
    const GlobalTile<T> dz{a.dz + (s * a.B + row0) * U4, U4, rows, 4 * a.U};
    for (int it = warp; it < mts * ksplit; it += kWarps) {
      const int mt = it % mts, k0 = it / mts * kper, k1 = min(kt, k0 + kper);
      T acc[1][4];
      bwd_product<T, 1, kFlush>(W, dz, mt, 0, k0, k1, lane, acc);
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(it * 4 + e) * 32 + lane] = acc[0][e];
    }
  };
  // the carried dh of unit jj (of the pass) at row b: its C fragment entry,
  // the K split's parts in order
  auto dh_of = [&](int jj, int b, int mts, int ksplit) {
    const T* p = red + ((jj >> 4) * 4 + ((jj >> 3) & 1) * 2 + (b & 1)) * 32 + (jj & 7) * 4 + (b >> 1);
    T v = p[0];
    for (int ks = 1; ks < ksplit; ++ks) v += p[ks * mts * 4 * 32];
    return v;
  };
  for (int64_t t = a.steps - 1; t >= 0; --t) {
    const bool last = t == a.steps - 1;
    if (!last) cluster_wait();   // dz_{t+1} of every block stored
    for (int p0 = 0; p0 < nr; p0 += kPass) {
      const int pr = min(kPass, nr - p0);
      int mts = 0, ksplit = 0;
      if (!last) carried(t + 1, p0, pr, mts, ksplit);
      __syncthreads();
      // the cell's gradient: element x of the pass, (row, unit) = (x / pr, x % pr)
      for (int x = threadIdx.x; x < 8 * pr; x += kThreads) {
        const int b = x / pr, jj = x - b * pr;
        if (b >= rows) continue;
        const int j = j0 + p0 + jj;
        const int64_t r = row0 + b, row = t * a.B + r;
        T dhn = T(0), dcn = T(0);
        if (last) {
          if (a.dh_T != nullptr) dhn = a.dh_T[r * a.U + j];
          if (a.dc_T != nullptr) dcn = a.dc_T[r * a.U + j];
        } else {
          dhn = dh_of(jj, b, mts, ksplit);
          dcn = a.dc0[r * a.U + j];   // this thread's, a step before
        }
        const T dh = (a.d_hs != nullptr ? a.d_hs[row * a.U + j] : T(0)) + dhn;
        const T* gr = a.gates + row * U4 + j;
        const T i = gr[0], f = gr[a.U], gg = gr[2 * a.U], o = gr[3 * a.U];
        const T ct = a.cs[row * a.U + j];
        const T cp = t > 0 ? a.cs[(row - a.B) * a.U + j] : a.c0[r * a.U + j];
        const T tc = tanh_(ct);
        const T dc = dcn + dh * o * (T(1) - tc * tc);
        T* dzr = a.dz + row * U4 + j;
        dzr[0] = dc * gg * i * (T(1) - i);
        dzr[a.U] = dc * cp * f * (T(1) - f);
        dzr[2 * a.U] = dc * i * (T(1) - gg * gg);
        dzr[3 * a.U] = dh * tc * o * (T(1) - o);
        a.dc0[r * a.U + j] = dc * f;
      }
      __syncthreads();   // the partials are the next pass's
    }
    cluster_arrive();   // dz_t stored
  }
  cluster_wait();   // dz_0 of every block
  // dh0 = dz_0 @ W_hh^T for this block's units
  for (int p0 = 0; p0 < nr; p0 += kPass) {
    const int pr = min(kPass, nr - p0);
    int mts, ksplit;
    carried(0, p0, pr, mts, ksplit);
    __syncthreads();
    for (int x = threadIdx.x; x < 8 * pr; x += kThreads) {
      const int b = x / pr, jj = x - b * pr;
      if (b < rows) a.dh0[(row0 + b) * a.U + j0 + p0 + jj] = dh_of(jj, b, mts, ksplit);
    }
    __syncthreads();
  }
}

// the kernel of (type, batch tiles, resident) and direction; the streamed
// form takes one tile
template <typename T, int NT, bool RES>
void (*fwd_kernel())(FwdArgs<T>) {
  if constexpr (RES) return lstm_recurrence_fwd_kernel<T, NT>;
  else return lstm_stream_fwd_kernel<T>;
}
template <typename T, int NT, bool RES>
void (*bwd_kernel())(BwdArgs<T>) {
  if constexpr (RES) return lstm_recurrence_bwd_kernel<T, NT>;
  else return lstm_stream_bwd_kernel<T>;
}

// a block's shared memory (bytes)
template <typename T, int NT, bool RES>
int64_t smem_bytes(int U, int R, bool fwd) {
  if (!RES) return (fwd ? kStreamFwdElems : kStreamBwdElems) * static_cast<int64_t>(sizeof(T));
  const RecGeo g(U, R, NT, sizeof(T));
  return (fwd ? g.fwd_elems(NT) : g.bwd_elems(R)) * static_cast<int64_t>(sizeof(T));
}

// Shared memory past 48 KB and the non-portable cluster size, once per
// device and kernel (sm90.cuh).
template <typename T, int NT, bool RES, bool FWD>
cudaError_t configure() {
  static std::mutex mu;
  static std::set<int> raised;
  const int smem = static_cast<int>(kSmemLimit);
  return FWD ? allow_clusters_once(fwd_kernel<T, NT, RES>(), smem, mu, raised)
             : allow_clusters_once(bwd_kernel<T, NT, RES>(), smem, mu, raised);
}

// a launch's configuration: `clusters` clusters of R blocks
struct Launch : ClusterLaunch {
  Launch(int64_t clusters, int R, size_t smem, cudaStream_t st)
      : ClusterLaunch(clusters, R, kThreads, smem, st) {}
};

// what the entries take: R blocks a cluster, each with at least one unit,
// and 1, 2 or 4 batch tiles
bool valid_split(int64_t U, int R, int nt) {
  return valid_cluster_split(U, R, kMaxRanks) && (nt == 1 || nt == 2 || nt == 4);
}

template <typename T, int NT, bool RES>
int launch_fwd(const FwdArgs<T>& a, cudaStream_t st) {
  const int64_t smem = smem_bytes<T, NT, RES>(a.U, a.R, true);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = configure<T, NT, RES, true>();
  if (e != cudaSuccess) return static_cast<int>(e);
  Launch l((a.B + 8 * NT - 1) / (8 * NT), a.R, static_cast<size_t>(smem), st);
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, fwd_kernel<T, NT, RES>(), a));
}

template <typename T, int NT, bool RES>
int launch_bwd(const BwdArgs<T>& a, cudaStream_t st) {
  const int64_t smem = smem_bytes<T, NT, RES>(a.U, a.R, false);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = configure<T, NT, RES, false>();
  if (e != cudaSuccess) return static_cast<int>(e);
  Launch l((a.B + 8 * NT - 1) / (8 * NT), a.R, static_cast<size_t>(smem), st);
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, bwd_kernel<T, NT, RES>(), a));
}

// out: the forward's and the backward's shared memory (bytes), and the
// clusters of R blocks the card holds at once for each (the occupancy
// calculator; 0 where the memory does not fit a block)
template <typename T, int NT, bool RES>
int query(int U, int R, int64_t* out) {
  out[0] = smem_bytes<T, NT, RES>(U, R, true);
  out[1] = smem_bytes<T, NT, RES>(U, R, false);
  out[2] = out[3] = 0;
  for (int d = 0; d < 2; ++d) {
    if (out[d] > kSmemLimit) continue;
    const cudaError_t e = d == 0 ? configure<T, NT, RES, true>() : configure<T, NT, RES, false>();
    if (e != cudaSuccess) return static_cast<int>(e);
    Launch l(1, R, static_cast<size_t>(out[d]), nullptr);
    int n = 0;
    const cudaError_t r = d == 0 ? cudaOccupancyMaxActiveClusters(&n, fwd_kernel<T, NT, RES>(), &l.cfg)
                                 : cudaOccupancyMaxActiveClusters(&n, bwd_kernel<T, NT, RES>(), &l.cfg);
    if (r != cudaSuccess) return static_cast<int>(r);
    out[2 + d] = n;
  }
  return 0;
}

// the instantiation for (nt, resident): the streamed form at one tile
#define DL4J_LSTM_DISPATCH(fn, T, ...)                                                 \
  switch (nt * 2 + (resident ? 1 : 0)) {                                             \
    case 2: return fn<T, 1, false>(__VA_ARGS__);                                     \
    case 3: return fn<T, 1, true>(__VA_ARGS__);                                      \
    case 5: return fn<T, 2, true>(__VA_ARGS__);                                      \
    case 9: return fn<T, 4, true>(__VA_ARGS__);                                      \
    default: return static_cast<int>(cudaErrorInvalidValue);                         \
  }

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte copies: the units of every row and of every block start on 16
// bytes
template <typename T>
int vec_ok(int64_t U, int R, std::initializer_list<const void*> ptrs) {
  constexpr int64_t E = 16 / sizeof(T);
  if (U % E != 0 || ((U + R - 1) / R) % E != 0) return 0;
  for (const void* p : ptrs)
    if (p != nullptr && !on16(p)) return 0;
  return 1;
}

template <typename T>
int fwd_t(const void* z, const void* w_hh, const void* h0, const void* c0, void* hs, void* cs,
          int64_t steps, int64_t B, int64_t U, int R, int nt, int resident, cudaStream_t st) {
  FwdArgs<T> a;
  a.z = static_cast<T*>(const_cast<void*>(z));
  a.w = static_cast<const T*>(w_hh);
  a.h0 = static_cast<const T*>(h0);
  a.c0 = static_cast<const T*>(c0);
  a.hs = static_cast<T*>(hs);
  a.cs = static_cast<T*>(cs);
  a.steps = steps;
  a.B = B;
  a.U = static_cast<int>(U);
  a.R = R;
  a.vec = vec_ok<T>(U, R, {z, w_hh, hs, cs});
  DL4J_LSTM_DISPATCH(launch_fwd, T, a, st)
}

template <typename T>
int bwd_t(const void* gates, const void* cs, const void* c0, const void* w_hh, const void* d_hs,
          const void* dh_T, const void* dc_T, void* dz, void* dh0, void* dc0, int64_t steps, int64_t B,
          int64_t U, int R, int nt, int resident, cudaStream_t st) {
  BwdArgs<T> a;
  a.gates = static_cast<const T*>(gates);
  a.cs = static_cast<const T*>(cs);
  a.c0 = static_cast<const T*>(c0);
  a.w = static_cast<const T*>(w_hh);
  a.d_hs = static_cast<const T*>(d_hs);
  a.dh_T = static_cast<const T*>(dh_T);
  a.dc_T = static_cast<const T*>(dc_T);
  a.dz = static_cast<T*>(dz);
  a.dh0 = static_cast<T*>(dh0);
  a.dc0 = static_cast<T*>(dc0);
  a.steps = steps;
  a.B = B;
  a.U = static_cast<int>(U);
  a.R = R;
  a.vec = vec_ok<T>(U, R, {gates, cs, c0, w_hh, d_hs, dz});
  DL4J_LSTM_DISPATCH(launch_bwd, T, a, st)
}

template <typename T>
int query_t(int64_t U, int R, int nt, int resident, int64_t* out) {
  DL4J_LSTM_DISPATCH(query, T, static_cast<int>(U), R, out)
}

}  // namespace

// dtype: 0 float32, 1 float64; R blocks a cluster, nt tiles of 8 batch rows
// a cluster (1, 2 or 4; 1 where not resident), resident: the W_hh slice in
// shared memory, else the streamed form. z holds
// gx on entry and the activated gates on return. Returns the launch's
// cudaError_t.
extern "C" int dl4j_lstm_recurrence_fwd(void* z, const void* w_hh, const void* h0, const void* c0,
                                        void* hs, void* cs, int64_t T, int64_t B, int64_t U, int R,
                                        int nt, int resident, int dtype, void* stream) {
  if (T < 1 || B < 1 || !valid_split(U, R, nt) || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fwd_t<float>(z, w_hh, h0, c0, hs, cs, T, B, U, R, nt, resident, s)
                    : fwd_t<double>(z, w_hh, h0, c0, hs, cs, T, B, U, R, nt, resident, s);
}

// d_hs, dh_T and dc_T may be null (zero).
extern "C" int dl4j_lstm_recurrence_bwd(const void* gates, const void* cs, const void* c0,
                                        const void* w_hh, const void* d_hs, const void* dh_T,
                                        const void* dc_T, void* dz, void* dh0, void* dc0, int64_t T,
                                        int64_t B, int64_t U, int R, int nt, int resident, int dtype,
                                        void* stream) {
  if (T < 1 || B < 1 || !valid_split(U, R, nt) || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? bwd_t<float>(gates, cs, c0, w_hh, d_hs, dh_T, dc_T, dz, dh0, dc0, T, B, U, R,
                                   nt, resident, s)
                    : bwd_t<double>(gates, cs, c0, w_hh, d_hs, dh_T, dc_T, dz, dh0, dc0, T, B, U, R,
                                    nt, resident, s);
}

// out: int64[4], the forward's and the backward's shared memory a block
// (bytes) and the clusters the card holds at once for each.
extern "C" int dl4j_lstm_recurrence_query(int64_t U, int R, int nt, int resident, int dtype,
                                          void* out) {
  if (!valid_split(U, R, nt) || dtype < 0 || dtype > 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t* o = static_cast<int64_t*>(out);
  return dtype == 0 ? query_t<float>(U, R, nt, resident, o) : query_t<double>(U, R, nt, resident, o);
}
