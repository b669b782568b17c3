// The GRU, peephole (Graves) LSTM and simple RNN recurrences for Hopper
// (sm_90a): one launch a layer and a direction over the whole sequence, each
// timestep's recurrent product and the cell inside it.
//
// Replaces no TPU kernel: the JAX package writes these recurrences in jnp,
// as the bodies of `lax.scan` in `gru_layer` (deeplearning4j_tpu/ops/
// nn_ops.py:569-592), `simple_rnn_layer` (:607-624) and `graves_lstm_layer`
// (deeplearning4j_tpu/ops/nn_ext.py:29-64), and XLA fused each body.
// kernels/recurrence.py hoists x W_ih + b for all timesteps into one GEMM
// before the forward kernel and leaves dx, dW_ih, dW_hh and the bias and
// peephole gradients to GEMMs and sums after the backward one. The plain
// PyTorch versions are `recurrence_fwd_plain` and `recurrence_bwd_plain`
// there.
//
// Time-major rows of B examples and U units; G gate columns a unit (GRU 3
// in the order [r, u, c], Graves 4 in [i, f, g, o], simple RNN 1); every
// array contiguous. The forward takes z [T, B, GU] holding gx_t = x_t W_ih
// + b_ih, w [U, GU] (W_hh) and h0 [B, U], and for t = 0 .. T-1 with
// a = h_{t-1} W_hh:
//
//   GRU:    r = sig(gx_r + a_r + bh_r), u = sig(gx_u + a_u + bh_u),
//           n = a_c + bh_c,  c = tanh(gx_c + r n),  h_t = u h_{t-1} + (1 - u) c
//           z_t <- [r, u, c], hn_t <- n                       (bh: b_hh [GU])
//   Graves: i = sig(z_i + p0 c_{t-1}), f = sig(z_f + p1 c_{t-1}), g = tanh(z_g),
//           c_t = f c_{t-1} + i g,  o = sig(z_o + p2 c_t),  h_t = o tanh(c_t)
//           z_t <- [i, f, g, o], cs_t <- c_t        (z = gx + a; p: w_peep [3, U])
//   simple: z_t <- gx + a,  h_t = act(z_t)
//
// and writes hs [T, B, U]. The backward takes the saved z, hs, cs, hn, h0,
// c0, w, the output gradient d_hs [T, B, U] and dh_T, dc_T [B, U] (each may
// be null: zero) and for t = T-1 .. 0, with dh = d_hs[t] + the carried dh:
//
//   GRU:    du = dh (h_{t-1} - c), dcand = dh (1 - u) (1 - c^2),
//           dz = [dn r (1 - r), du u (1 - u), dcand] with dn = dcand n,
//           dzh = [dz_r, dz_u, dcand r],  carried dh = dh u + dzh W_hh^T
//   Graves: tc = tanh(c_t), dz_o = dh tc o (1 - o),
//           dc = dc_carried + dh o (1 - tc^2) + dz_o p2,
//           dz_i = dc g i (1 - i), dz_f = dc c_{t-1} f (1 - f),
//           dz_g = dc i (1 - g^2), dc_carried = dc f + dz_i p0 + dz_f p1,
//           carried dh = dz W_hh^T                                  (dzh = dz)
//   simple: dz = dh act'(z_t), carried dh = dz W_hh^T               (dzh = dz)
//
// and writes dz [T, B, GU] (the gradient of gx), dzh (that of h W_hh +
// b_hh; the GRU's own buffer, the others' is dz), dh0 and, for Graves,
// dc0 [B, U].
//
// The design (the first, simple form; PERF.md has its times). What it
// shares with lstm_recurrence.cu (the cells' math, the cluster's rank
// and barrier, the launch and its attributes) is in sm90.cuh; its cells
// are to become instantiations of lstm_recurrence.cu's kernels, one
// engine with DSMEM pushes and 3xTF32 (ROADMAP queue 2b item 14):
// - A thread-block cluster of R blocks (R <= 16) takes a tile of 8 batch
//   rows; more rows are more clusters, independent of each other. Block k
//   owns nu = ceil(U / R) units. The forward's product for its G nu gate
//   columns, the backward's for its units' dh.
// - The forward keeps its columns of W_hh ([U, G nu]) and the backward its
//   units' rows ([nu, GU]) in shared memory for the whole sequence (the
//   resident form), or reads them from L2 each step where they do not fit
//   (the streamed form, any width).
// - The exchange is global memory and one cluster barrier a step: a block
//   stores its units' h_t (dzh_t) to the output, arrives (release), and
//   every block waits (acquire) before reading the whole vector at L2
//   (ld.global.cg) for the next step. Each timestep's vector has its own
//   place in the output, so one barrier a step is enough.
// - The products are FMAs in T (float32 stays float32: no TF32), a thread
//   a gate column (a unit in the backward) for all 8 rows, the K range split
//   over the block's threads where the columns are few and the parts summed
//   in a fixed order: no atomics, two calls give the same bits.
// - The cell's carried values (the Graves dc, the GRU's direct dh u) stay
//   in dc0 / dh0, each element read and written by the one thread that owns
//   it.
// - What a step waits on is latency, not bytes or operations: the barrier,
//   the exchanged vector's L2 reads and the cell's loads. A thread's cell
//   inputs (gx or the saved values, the states, d_hs) are loaded before
//   the step's product, and the vector is staged kBatch loads a thread in
//   flight at once.
// No allocation and no host sync: launches go on PyTorch's current stream
// (cudaLaunchKernelEx with the cluster dimension), so CUDA graphs capture
// them; kernel attributes are set on a launch or occupancy query before any
// capture.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kThreads = 256;
constexpr int kRows = 8;                 // batch rows a cluster
constexpr int kPad = 1;                  // the backward's resident rows' padding
constexpr int kMaxRanks = 16;
constexpr int64_t kSmemLimit = 232448;   // a block's shared memory on Hopper

enum Cell { kGru = 0, kGraves = 1, kSimple = 2 };
template <int C>
constexpr int kGates = C == kGru ? 3 : (C == kGraves ? 4 : 1);

// the simple RNN's activations (kernels/recurrence.py ACTIVATIONS)
enum Act { kIdentity = 0, kTanh = 1, kRelu = 2, kSigmoid = 3, kLeaky = 4, kHardTanh = 5,
           kSoftsign = 6 };

template <typename T>
struct Args {
  T* z;             // [T, B, GU]: gx on the forward's entry, the saved values after
  const T* w;       // [U, GU]
  const T* b_hh;    // [GU] (GRU)
  const T* wp;      // [3, U] (Graves)
  const T* h0;      // [B, U]
  const T* c0;      // [B, U] (Graves)
  T* hs;            // [T, B, U]
  T* cs;            // [T, B, U] (Graves)
  T* hn;            // [T, B, U] (GRU)
  const T* d_hs;    // [T, B, U] or null
  const T* dh_T;    // [B, U] or null
  const T* dc_T;    // [B, U] or null (Graves)
  T* dz;            // [T, B, GU]
  T* dzh;           // [T, B, GU] (GRU; else dz)
  T* dh0;           // [B, U]
  T* dc0;           // [B, U] (Graves)
  int64_t steps, B;
  int U, R, act;
};

template <typename T>
__device__ __forceinline__ T activate(int act, T z) {
  switch (act) {
    case kTanh: return tanh_(z);
    case kRelu: return z > T(0) ? z : T(0);
    case kSigmoid: return sigmoid_(z);
    case kLeaky: return z >= T(0) ? z : T(0.01) * z;
    case kHardTanh: return z < T(-1) ? T(-1) : (z > T(1) ? T(1) : z);
    case kSoftsign: return z / (T(1) + fabs(z));
    default: return z;
  }
}

// act'(z) from z and h = act(z), with the JAX package's gradient at a tie
// (relu 0 at 0, leaky relu 1 at 0, hard tanh half on a bound)
template <typename T>
__device__ __forceinline__ T activate_grad(int act, T z, T h) {
  switch (act) {
    case kTanh: return T(1) - h * h;
    case kRelu: return z > T(0) ? T(1) : T(0);
    case kSigmoid: return h * (T(1) - h);
    case kLeaky: return z >= T(0) ? T(1) : T(0.01);
    case kHardTanh:
      return (z == T(1) || z == T(-1)) ? T(0.5) : ((z > T(-1) && z < T(1)) ? T(1) : T(0));
    case kSoftsign: {
      const T d = T(1) + fabs(z);
      return T(1) / (d * d);
    }
    default: return T(1);
  }
}

// The work split of one block, from U, R and the cell's G.
struct Geo {
  int nu, j0, nr;       // units a block, this block's first and its count
  int fcols, fsplit, fkper;   // forward: gate columns, K split, K a part
  int bsplit, bkper;          // backward: K (GU) split over the units, K a part
  int64_t GU;
  __host__ __device__ Geo(int U, int R, int G, int rank) {
    nu = (U + R - 1) / R;
    j0 = rank * nu;
    nr = U - j0 < nu ? U - j0 : nu;
    if (nr < 0) nr = 0;
    // every block's split is the first block's (nu units), so that shared
    // memory is one size
    fcols = G * nu;
    fsplit = fcols >= kThreads ? 1 : kThreads / fcols;
    fkper = (U + fsplit - 1) / fsplit;
    GU = static_cast<int64_t>(G) * U;
    bsplit = nu >= kThreads ? 1 : kThreads / nu;
    bkper = static_cast<int>((GU + bsplit - 1) / bsplit);
  }
  // shared memory (elements): the partial sums, then (resident) the slice
  // and the staged vector
  __host__ __device__ int64_t fwd_elems(bool res, int U) const {
    const int64_t red = static_cast<int64_t>(fsplit) * fcols * kRows;
    return red + (res ? static_cast<int64_t>(U) * fcols + static_cast<int64_t>(kRows) * U : 0);
  }
  __host__ __device__ int64_t bwd_elems(bool res) const {
    const int64_t red = static_cast<int64_t>(bsplit) * nu * kRows;
    return red + (res ? static_cast<int64_t>(nu) * (GU + kPad) + kRows * GU : 0);
  }
};

// a row of a vector other blocks of the cluster stored this launch, read at
// L2 (no stale L1 line)
template <typename T>
__device__ __forceinline__ T ld_l2(const T* p) {
  return __ldcg(p);
}

// dst [kRows][n] <- the first `rows` rows of src [rows][n] read at L2, zero
// past them: kBatch loads a thread in flight before their stores (a load's
// L2 latency, not a chain of them, a batch)
constexpr int kBatch = 8;
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int rows, int n) {
  const int total = kRows * n, valid = rows * n;
  for (int base = threadIdx.x; base < total; base += kBatch * kThreads) {
    T v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int x = base + i * kThreads;
      v[i] = x < valid ? ld_l2(src + x) : T(0);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int x = base + i * kThreads;
      if (x < total) dst[x] = v[i];
    }
  }
}

template <typename T, int CELL, bool RES>
__global__ void __launch_bounds__(kThreads, 1) rnn_fwd_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int G = kGates<CELL>;
  const Geo g(a.U, a.R, G, cluster_rank());
  const int U = a.U, nr = g.nr, cols = G * nr;
  const int64_t GU = g.GU;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / a.R) * kRows;
  const int rows = a.B - row0 < kRows ? static_cast<int>(a.B - row0) : kRows;
  T* red = reinterpret_cast<T*>(smem_raw);                     // [fsplit][fcols][8]
  T* ws = red + static_cast<int64_t>(g.fsplit) * g.fcols * kRows;   // [U][cols]
  T* hsm = ws + static_cast<int64_t>(U) * cols;                // [8][U]
  if (RES) {   // the slice [U][cols], once a launch
    for (int x = threadIdx.x; x < U * cols; x += kThreads) {
      const int k = x / cols, col = x - k * cols;
      ws[x] = __ldg(a.w + k * GU + (col / nr) * U + g.j0 + col % nr);
    }
  }
  // the cell's inputs of item x at step t: gx's G columns, h_{t-1} (and
  // the Graves c_{t-1}), the GRU's b_hh and the peepholes; a thread's
  // first item is loaded before the step's product, which hides the loads
  struct In {
    T gx[G], hp, cp, p[3];
  };
  auto load_in = [&](int x, int64_t t) {
    In in;
    const int b = x / nr, jj = x - b * nr, j = g.j0 + jj;
    const int64_t at = (t * a.B + row0 + b) * U + j;
    const T* zr = a.z + (t * a.B + row0 + b) * GU + j;
#pragma unroll
    for (int q = 0; q < G; ++q) in.gx[q] = zr[q * U];
    in.hp = t > 0 ? a.hs[at - a.B * U] : a.h0[(row0 + b) * U + j];
    in.cp = T(0);
#pragma unroll
    for (int q = 0; q < 3; ++q) in.p[q] = T(0);
    if constexpr (CELL == kGraves) {
      in.cp = t > 0 ? a.cs[at - a.B * U] : a.c0[(row0 + b) * U + j];
#pragma unroll
      for (int q = 0; q < 3; ++q) in.p[q] = __ldg(a.wp + q * U + j);
    }
    if constexpr (CELL == kGru) {
#pragma unroll
      for (int q = 0; q < 3; ++q) in.p[q] = __ldg(a.b_hh + q * U + j);
    }
    return in;
  };
  for (int64_t t = 0; t < a.steps; ++t) {
    if (t > 0) cluster_wait();   // h_{t-1} of every block stored
    const int tid = static_cast<int>(threadIdx.x);
    In pre;
    if (tid < rows * nr) pre = load_in(tid, t);
    const T* hprev = t > 0 ? a.hs + ((t - 1) * a.B + row0) * U : a.h0 + row0 * U;
    if (RES) stage_rows(hsm, hprev, rows, U);
    __syncthreads();
    // the product: a thread a gate column and a part of K, all 8 rows
    for (int it = threadIdx.x; it < g.fsplit * cols; it += kThreads) {
      const int col = it % cols, ks = it / cols;
      const int k0 = ks * g.fkper, k1 = min(U, k0 + g.fkper);
      const int64_t wc = (col / nr) * U + g.j0 + col % nr;
      T acc[kRows];
#pragma unroll
      for (int b = 0; b < kRows; ++b) acc[b] = T(0);
      for (int k = k0; k < k1; ++k) {
        const T w = RES ? ws[static_cast<int64_t>(k) * cols + col] : __ldg(a.w + k * GU + wc);
#pragma unroll
        for (int b = 0; b < kRows; ++b) {
          const T h = RES ? hsm[b * U + k] : (b < rows ? ld_l2(hprev + b * U + k) : T(0));
          acc[b] = fma(h, w, acc[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < kRows; ++b) red[(static_cast<int64_t>(ks) * g.fcols + col) * kRows + b] = acc[b];
    }
    __syncthreads();
    // the cell: a thread a (row, unit)
    for (int x = threadIdx.x; x < rows * nr; x += kThreads) {
      const In in = x == tid ? pre : load_in(x, t);
      const int b = x / nr, jj = x % nr, j = g.j0 + jj;
      const int64_t row = t * a.B + row0 + b, at = row * U + j;
      T v[G];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        T s = red[(static_cast<int64_t>(q) * nr + jj) * kRows + b];
        for (int ks = 1; ks < g.fsplit; ++ks)
          s += red[(static_cast<int64_t>(ks) * g.fcols + q * nr + jj) * kRows + b];
        v[q] = s;
      }
      T* zr = a.z + row * GU + j;
      const T hp = in.hp;
      if constexpr (CELL == kGru) {
        const T n = v[2] + in.p[2];
        const T r = sigmoid_(in.gx[0] + (v[0] + in.p[0]));
        const T u = sigmoid_(in.gx[1] + (v[1] + in.p[1]));
        const T c = tanh_(in.gx[2] + r * n);
        zr[0] = r;
        zr[U] = u;
        zr[2 * U] = c;
        a.hn[at] = n;
        a.hs[at] = u * hp + (T(1) - u) * c;
      } else if constexpr (CELL == kGraves) {
        const T cp = in.cp;
        const T i = sigmoid_(in.gx[0] + v[0] + in.p[0] * cp);
        const T f = sigmoid_(in.gx[1] + v[1] + in.p[1] * cp);
        const T gg = tanh_(in.gx[2] + v[2]);
        const T cn = f * cp + i * gg;
        const T o = sigmoid_(in.gx[3] + v[3] + in.p[2] * cn);
        zr[0] = i;
        zr[U] = f;
        zr[2 * U] = gg;
        zr[3 * U] = o;
        a.cs[at] = cn;
        a.hs[at] = o * tanh_(cn);
      } else {
        const T zz = in.gx[0] + v[0];
        zr[0] = zz;
        a.hs[at] = activate(a.act, zz);
      }
    }
    cluster_arrive();   // h_t stored
  }
  cluster_wait();   // no block leaves while another may still read
}

// dzh_s [rows, GU] times this block's units' rows of W_hh, transposed, into
// red [bsplit][nu][8]; `dzs` the staged vector (resident)
template <typename T, bool RES>
__device__ __forceinline__ void carried_product(const Args<T>& a, const Geo& g, const T* ws,
                                                T* dzs, T* red, const T* dzh, int rows) {
  const int64_t GU = g.GU;
  if (RES) {
    stage_rows(dzs, dzh, rows, static_cast<int>(GU));
    __syncthreads();
  }
  for (int it = threadIdx.x; it < g.bsplit * g.nr; it += kThreads) {
    const int jj = it % g.nr, ks = it / g.nr;
    const int64_t k0 = static_cast<int64_t>(ks) * g.bkper;
    const int64_t k1 = k0 + g.bkper < GU ? k0 + g.bkper : GU;
    const T* wr = RES ? ws + jj * (GU + kPad) : a.w + static_cast<int64_t>(g.j0 + jj) * GU;
    T acc[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc[b] = T(0);
    for (int64_t k = k0; k < k1; ++k) {
      const T w = RES ? wr[k] : __ldg(wr + k);
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const T d = RES ? dzs[b * GU + k] : (b < rows ? ld_l2(dzh + b * GU + k) : T(0));
        acc[b] = fma(d, w, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < kRows; ++b) red[(static_cast<int64_t>(ks) * g.nu + jj) * kRows + b] = acc[b];
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ T carried_sum(const Geo& g, const T* red, int jj, int b) {
  T s = red[jj * kRows + b];
  for (int ks = 1; ks < g.bsplit; ++ks) s += red[(static_cast<int64_t>(ks) * g.nu + jj) * kRows + b];
  return s;
}

template <typename T, int CELL, bool RES>
__global__ void __launch_bounds__(kThreads, 1) rnn_bwd_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int G = kGates<CELL>;
  const Geo g(a.U, a.R, G, cluster_rank());
  const int U = a.U, nr = g.nr;
  const int64_t GU = g.GU;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / a.R) * kRows;
  const int rows = a.B - row0 < kRows ? static_cast<int>(a.B - row0) : kRows;
  T* red = reinterpret_cast<T*>(smem_raw);                       // [bsplit][nu][8]
  T* ws = red + static_cast<int64_t>(g.bsplit) * g.nu * kRows;    // [nr][GU + kPad]
  T* dzs = ws + static_cast<int64_t>(nr) * (GU + kPad);          // [8][GU]
  if (RES) {   // the rows [nr][GU + kPad], once a launch
    const int gu = static_cast<int>(GU);
    for (int x = threadIdx.x; x < nr * gu; x += kThreads) {
      const int jj = x / gu, k = x - jj * gu;
      ws[jj * (gu + kPad) + k] = __ldg(a.w + static_cast<int64_t>(g.j0) * gu + x);
    }
    __syncthreads();
  }
  // the cell's inputs of item x at step t (the forward's saved values,
  // the output gradient, the states it needs, the peepholes); a thread's
  // first item is loaded before the step's product
  struct In {
    T z[G], dhs, c, cp, hn, h, p[3];
  };
  auto load_in = [&](int x, int64_t t) {
    In in;
    const int b = x / nr, jj = x - b * nr, j = g.j0 + jj;
    const int64_t r = row0 + b, at = (t * a.B + r) * U + j, rj = r * U + j;
    const T* zr = a.z + (t * a.B + r) * GU + j;
#pragma unroll
    for (int q = 0; q < G; ++q) in.z[q] = zr[q * U];
    in.dhs = a.d_hs != nullptr ? a.d_hs[at] : T(0);
    in.c = in.cp = in.hn = in.h = T(0);
#pragma unroll
    for (int q = 0; q < 3; ++q) in.p[q] = T(0);
    if constexpr (CELL == kGru) {
      in.hn = a.hn[at];
      in.h = t > 0 ? a.hs[at - a.B * U] : a.h0[rj];
    } else if constexpr (CELL == kGraves) {
      in.c = a.cs[at];
      in.cp = t > 0 ? a.cs[at - a.B * U] : a.c0[rj];
#pragma unroll
      for (int q = 0; q < 3; ++q) in.p[q] = __ldg(a.wp + q * U + j);
    } else {
      in.h = a.hs[at];
    }
    return in;
  };
  const int tid = static_cast<int>(threadIdx.x);
  for (int64_t t = a.steps - 1; t >= 0; --t) {
    const bool last = t == a.steps - 1;
    if (!last) cluster_wait();   // dzh_{t+1} of every block stored
    In pre;
    if (tid < rows * nr) pre = load_in(tid, t);
    if (!last)
      carried_product<T, RES>(a, g, ws, dzs, red, a.dzh + ((t + 1) * a.B + row0) * GU, rows);
    for (int x = tid; x < rows * nr; x += kThreads) {
      const In in = x == tid ? pre : load_in(x, t);
      const int b = x / nr, jj = x % nr, j = g.j0 + jj;
      const int64_t r = row0 + b, row = t * a.B + r, rj = r * U + j;
      T dh = in.dhs;
      if (last) {
        if (a.dh_T != nullptr) dh += a.dh_T[rj];
      } else {
        dh += carried_sum(g, red, jj, b);
      }
      T* dzr = a.dz + row * GU + j;
      if constexpr (CELL == kGru) {
        if (!last) dh += a.dh0[rj];   // the direct term dh_{t+1} u_{t+1}
        const T rr = in.z[0], u = in.z[1], c = in.z[2], n = in.hn;
        const T du = dh * (in.h - c);
        const T dcand = dh * (T(1) - u) * (T(1) - c * c);
        const T dzr_ = dcand * n * rr * (T(1) - rr);
        const T dzu = du * u * (T(1) - u);
        dzr[0] = dzr_;
        dzr[U] = dzu;
        dzr[2 * U] = dcand;
        T* dhr = a.dzh + row * GU + j;
        dhr[0] = dzr_;
        dhr[U] = dzu;
        dhr[2 * U] = dcand * rr;
        a.dh0[rj] = dh * u;
      } else if constexpr (CELL == kGraves) {
        const T i = in.z[0], f = in.z[1], gg = in.z[2], o = in.z[3];
        const T ct = in.c, cp = in.cp;
        T dcn = T(0);
        if (last) {
          if (a.dc_T != nullptr) dcn = a.dc_T[rj];
        } else {
          dcn = a.dc0[rj];
        }
        const T tc = tanh_(ct);
        const T dzo = dh * tc * o * (T(1) - o);
        const T dc = dcn + dh * o * (T(1) - tc * tc) + dzo * in.p[2];
        const T dzi = dc * gg * i * (T(1) - i);
        const T dzf = dc * cp * f * (T(1) - f);
        dzr[0] = dzi;
        dzr[U] = dzf;
        dzr[2 * U] = dc * i * (T(1) - gg * gg);
        dzr[3 * U] = dzo;
        a.dc0[rj] = dc * f + dzi * in.p[0] + dzf * in.p[1];
      } else {
        dzr[0] = dh * activate_grad(a.act, in.z[0], in.h);
      }
    }
    cluster_arrive();   // dz_t (dzh_t) stored
  }
  cluster_wait();   // dzh_0 of every block
  carried_product<T, RES>(a, g, ws, dzs, red, a.dzh + row0 * GU, rows);
  for (int x = threadIdx.x; x < rows * nr; x += kThreads) {
    const int b = x / nr, jj = x % nr;
    const int64_t rj = (row0 + b) * U + g.j0 + jj;
    T dh = carried_sum(g, red, jj, b);
    if (CELL == kGru) dh += a.dh0[rj];
    a.dh0[rj] = dh;
  }
}

template <typename T, int CELL, bool RES, bool FWD>
void (*kernel())(Args<T>) {
  if constexpr (FWD) return rnn_fwd_kernel<T, CELL, RES>;
  else return rnn_bwd_kernel<T, CELL, RES>;
}

template <typename T, int CELL, bool RES, bool FWD>
int64_t smem_bytes(int U, int R) {
  const Geo g(U, R, kGates<CELL>, 0);
  return (FWD ? g.fwd_elems(RES, U) : g.bwd_elems(RES)) * static_cast<int64_t>(sizeof(T));
}

// Shared memory past 48 KB and the non-portable cluster size, once per
// device and kernel (sm90.cuh).
template <typename T, int CELL, bool RES, bool FWD>
cudaError_t configure() {
  static std::mutex mu;
  static std::set<int> raised;
  return allow_clusters_once(kernel<T, CELL, RES, FWD>(), static_cast<int>(kSmemLimit), mu, raised);
}

// a launch's configuration: `clusters` clusters of R blocks
struct Launch : ClusterLaunch {
  Launch(int64_t clusters, int R, size_t smem, cudaStream_t st)
      : ClusterLaunch(clusters, R, kThreads, smem, st) {}
};

// what the entries take: R blocks a cluster, each with at least one unit
bool valid_split(int64_t U, int R) { return valid_cluster_split(U, R, kMaxRanks); }

template <typename T, int CELL, bool RES, bool FWD>
int launch(const Args<T>& a, cudaStream_t st) {
  const int64_t smem = smem_bytes<T, CELL, RES, FWD>(a.U, a.R);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = configure<T, CELL, RES, FWD>();
  if (e != cudaSuccess) return static_cast<int>(e);
  Launch l((a.B + kRows - 1) / kRows, a.R, static_cast<size_t>(smem), st);
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, kernel<T, CELL, RES, FWD>(), a));
}

// out: the forward's and the backward's shared memory (bytes), and the
// clusters of R blocks the card holds at once for each (0 where the memory
// does not fit a block)
template <typename T, int CELL, bool RES>
int query(int U, int R, int64_t* out) {
  out[0] = smem_bytes<T, CELL, RES, true>(U, R);
  out[1] = smem_bytes<T, CELL, RES, false>(U, R);
  out[2] = out[3] = 0;
  for (int d = 0; d < 2; ++d) {
    if (out[d] > kSmemLimit) continue;
    const cudaError_t e = d == 0 ? configure<T, CELL, RES, true>() : configure<T, CELL, RES, false>();
    if (e != cudaSuccess) return static_cast<int>(e);
    Launch l(1, R, static_cast<size_t>(out[d]), nullptr);
    int n = 0;
    const cudaError_t r = d == 0 ? cudaOccupancyMaxActiveClusters(&n, kernel<T, CELL, RES, true>(), &l.cfg)
                                 : cudaOccupancyMaxActiveClusters(&n, kernel<T, CELL, RES, false>(), &l.cfg);
    if (r != cudaSuccess) return static_cast<int>(r);
    out[2 + d] = n;
  }
  return 0;
}

// the instantiation for (cell, resident)
#define DL4J_RNN_DISPATCH(fn, T, FWD, ...)                         \
  switch (cell * 2 + (resident ? 1 : 0)) {                         \
    case 0: return fn<T, kGru, false FWD>(__VA_ARGS__);            \
    case 1: return fn<T, kGru, true FWD>(__VA_ARGS__);             \
    case 2: return fn<T, kGraves, false FWD>(__VA_ARGS__);         \
    case 3: return fn<T, kGraves, true FWD>(__VA_ARGS__);          \
    case 4: return fn<T, kSimple, false FWD>(__VA_ARGS__);         \
    case 5: return fn<T, kSimple, true FWD>(__VA_ARGS__);          \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

#define DL4J_COMMA ,

template <typename T>
int fwd_t(int cell, void* z, const void* w, const void* b_hh, const void* wp, const void* h0,
          const void* c0, void* hs, void* cs, void* hn, int64_t steps, int64_t B, int64_t U, int R,
          int resident, int act, cudaStream_t st) {
  Args<T> a{};
  a.z = static_cast<T*>(z);
  a.w = static_cast<const T*>(w);
  a.b_hh = static_cast<const T*>(b_hh);
  a.wp = static_cast<const T*>(wp);
  a.h0 = static_cast<const T*>(h0);
  a.c0 = static_cast<const T*>(c0);
  a.hs = static_cast<T*>(hs);
  a.cs = static_cast<T*>(cs);
  a.hn = static_cast<T*>(hn);
  a.steps = steps;
  a.B = B;
  a.U = static_cast<int>(U);
  a.R = R;
  a.act = act;
  DL4J_RNN_DISPATCH(launch, T, DL4J_COMMA true, a, st)
}

template <typename T>
int bwd_t(int cell, const void* z, const void* hs, const void* cs, const void* hn, const void* h0,
          const void* c0, const void* w, const void* wp, const void* d_hs, const void* dh_T,
          const void* dc_T, void* dz, void* dzh, void* dh0, void* dc0, int64_t steps, int64_t B,
          int64_t U, int R, int resident, int act, cudaStream_t st) {
  Args<T> a{};
  a.z = static_cast<T*>(const_cast<void*>(z));
  a.hs = static_cast<T*>(const_cast<void*>(hs));
  a.cs = static_cast<T*>(const_cast<void*>(cs));
  a.hn = static_cast<T*>(const_cast<void*>(hn));
  a.h0 = static_cast<const T*>(h0);
  a.c0 = static_cast<const T*>(c0);
  a.w = static_cast<const T*>(w);
  a.wp = static_cast<const T*>(wp);
  a.d_hs = static_cast<const T*>(d_hs);
  a.dh_T = static_cast<const T*>(dh_T);
  a.dc_T = static_cast<const T*>(dc_T);
  a.dz = static_cast<T*>(dz);
  a.dzh = static_cast<T*>(cell == kGru ? dzh : dz);
  a.dh0 = static_cast<T*>(dh0);
  a.dc0 = static_cast<T*>(dc0);
  a.steps = steps;
  a.B = B;
  a.U = static_cast<int>(U);
  a.R = R;
  a.act = act;
  DL4J_RNN_DISPATCH(launch, T, DL4J_COMMA false, a, st)
}

template <typename T>
int query_t(int cell, int64_t U, int R, int resident, int64_t* out) {
  DL4J_RNN_DISPATCH(query, T, , static_cast<int>(U), R, out)
}

// the pointers each cell needs
bool has_inputs(int cell, const void* b_hh, const void* wp, const void* c0) {
  if (cell == kGru) return b_hh != nullptr;
  if (cell == kGraves) return wp != nullptr && c0 != nullptr;
  return cell == kSimple;
}

}  // namespace

// cell: 0 GRU, 1 Graves (peephole) LSTM, 2 simple RNN; dtype: 0 float32, 1
// float64; R blocks a cluster of 8 batch rows; resident: W_hh's slice in
// shared memory, else the streamed form; act: the simple RNN's activation
// (enum Act). z holds gx on entry and the saved values on return; cs
// (Graves) and hn (GRU) are written, null for the other cells. Returns the
// launch's cudaError_t.
extern "C" int dl4j_rnn_recurrence_fwd(int cell, void* z, const void* w_hh, const void* b_hh,
                                       const void* w_peep, const void* h0, const void* c0, void* hs,
                                       void* cs, void* hn, int64_t T, int64_t B, int64_t U, int R,
                                       int resident, int act, int dtype, void* stream) {
  if (T < 1 || B < 1 || !valid_split(U, R) || dtype < 0 || dtype > 1 || act < 0 || act > 6 ||
      !has_inputs(cell, b_hh, w_peep, c0) || (cell == kGraves && cs == nullptr) ||
      (cell == kGru && hn == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fwd_t<float>(cell, z, w_hh, b_hh, w_peep, h0, c0, hs, cs, hn, T, B, U, R,
                                   resident, act, s)
                    : fwd_t<double>(cell, z, w_hh, b_hh, w_peep, h0, c0, hs, cs, hn, T, B, U, R,
                                    resident, act, s);
}

// d_hs, dh_T and dc_T may be null (zero); dzh is the GRU's own buffer (the
// other cells pass dz); dc0 is written for Graves only.
extern "C" int dl4j_rnn_recurrence_bwd(int cell, const void* z, const void* hs, const void* cs,
                                       const void* hn, const void* h0, const void* c0,
                                       const void* w_hh, const void* w_peep, const void* d_hs,
                                       const void* dh_T, const void* dc_T, void* dz, void* dzh,
                                       void* dh0, void* dc0, int64_t T, int64_t B, int64_t U, int R,
                                       int resident, int act, int dtype, void* stream) {
  if (T < 1 || B < 1 || !valid_split(U, R) || dtype < 0 || dtype > 1 || act < 0 || act > 6 ||
      cell < 0 || cell > 2 || (cell == kGraves && (w_peep == nullptr || c0 == nullptr || cs == nullptr ||
                                                   dc0 == nullptr)) ||
      (cell == kGru && hn == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? bwd_t<float>(cell, z, hs, cs, hn, h0, c0, w_hh, w_peep, d_hs, dh_T, dc_T, dz,
                                   dzh, dh0, dc0, T, B, U, R, resident, act, s)
                    : bwd_t<double>(cell, z, hs, cs, hn, h0, c0, w_hh, w_peep, d_hs, dh_T, dc_T, dz,
                                    dzh, dh0, dc0, T, B, U, R, resident, act, s);
}

// out: int64[4], the forward's and the backward's shared memory a block
// (bytes) and the clusters the card holds at once for each.
extern "C" int dl4j_rnn_recurrence_query(int cell, int64_t U, int R, int resident, int dtype,
                                         void* out) {
  if (!valid_split(U, R) || dtype < 0 || dtype > 1 || cell < 0 || cell > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t* o = static_cast<int64_t*>(out);
  return dtype == 0 ? query_t<float>(cell, U, R, resident, o)
                    : query_t<double>(cell, U, R, resident, o);
}
