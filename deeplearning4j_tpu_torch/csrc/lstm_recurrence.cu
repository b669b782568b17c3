// The recurrence engine for Hopper (sm_90a): one launch a layer and a
// direction over the whole sequence, each timestep's recurrent product and
// the cell inside it, for four cells: the LSTM, the peephole (Graves) LSTM,
// the GRU and the simple RNN.
//
// Replaces no TPU kernel: the JAX package writes each recurrence in jnp, as
// the body of a `lax.scan` that XLA fused: `lstm_layer`
// (deeplearning4j_tpu/ops/nn_ops.py:539-556, `lstm_cell` :520-536, h_prev
// @ w_hh included), `gru_layer` (:569-592), `simple_rnn_layer` (:607-624)
// and `graves_lstm_layer` (deeplearning4j_tpu/ops/nn_ext.py:29-64).
// kernels/_sequence.py hoists x W_ih + b for all timesteps into one GEMM
// before the forward kernel, and leaves dx, dW_ih, dW_hh, the biases' and
// the peepholes' gradients to GEMMs and sums after the backward one, as the
// JAX package left those products to XLA. The plain PyTorch versions are
// kernels/lstm.py `lstm_recurrence_fwd_plain` / `lstm_recurrence_bwd_plain`
// and kernels/recurrence.py `recurrence_fwd_plain` / `recurrence_bwd_plain`.
//
// Time-major rows of B examples and U units, G gate columns a unit (LSTM
// and Graves 4 in the order [i, f, g, o], GRU 3 in [r, u, c], simple 1);
// every array contiguous. The forward takes z [T, B, GU] holding gx_t = x_t
// W_ih + b, w [U, GU] (W_hh), h0 [B, U] (the LSTM's and Graves' c0; the
// GRU's b_hh [GU]; Graves' w_peep [3, U]) and for t = 0 .. T-1, with a =
// h_{t-1} W_hh (h_{-1} = h0, c_{-1} = c0):
//
//   LSTM:   i, f, g, o = sig, sig, tanh, sig (gx + a),
//           c_t = f c_{t-1} + i g,  h_t = o tanh(c_t)
//   Graves: i = sig(z_i + p0 c_{t-1}), f = sig(z_f + p1 c_{t-1}), g = tanh(z_g),
//           c_t = f c_{t-1} + i g,  o = sig(z_o + p2 c_t),  h_t = o tanh(c_t)
//           (z = gx + a, p = w_peep)
//   GRU:    r = sig(gx_r + (a_r + bh_r)), u = sig(gx_u + (a_u + bh_u)),
//           n = a_c + bh_c,  c = tanh(gx_c + r n),  h_t = u h_{t-1} + (1 - u) c
//   simple: z = gx + a,  h_t = act(z)
//
// keeps over z what the backward needs (the activated gates; the simple
// RNN's z) and writes hs [T, B, U] and cs (LSTM, Graves) or hn (GRU: n) [T,
// B, U]. The backward takes those, the output gradient d_hs [T, B, U] and
// dh_T, dc_T [B, U] (each may be null: zero) and for t = T-1 .. 0, with dh
// = d_hs[t] + the carried dh:
//
//   LSTM:   tc = tanh(c_t),  dc = dc_carried + dh o (1 - tc^2),
//           dz = [dc g i (1 - i), dc c_{t-1} f (1 - f), dc i (1 - g^2),
//                 dh tc o (1 - o)],  dc_carried = dc f
//   Graves: dz_o as the LSTM's, dc = dc_carried + dh o (1 - tc^2) + dz_o p2,
//           dz_i, dz_f, dz_g as the LSTM's, dc_carried = dc f + dz_i p0 + dz_f p1
//   GRU:    dh += dh_direct,  du = dh (h_{t-1} - c),  dcand = dh (1 - u) (1 - c^2),
//           dz = [dcand n r (1 - r), du u (1 - u), dcand],
//           dzh = [dz_r, dz_u, dcand r],  dh_direct = dh u
//   simple: dz = dh act'(z)   (the JAX package's gradient at a tie)
//
// with the carried dh = dzh W_hh^T (dzh = dz but for the GRU). It writes dz
// [T, B, GU] (the gradient of gx), the GRU's dzh (that of h W_hh + b_hh),
// dh0 (the GRU's with the last dh_direct) and the LSTM's and Graves' dc0.
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
// What the design does about the chain (every cell alike):
// - One launch does all T steps. A thread-block cluster of R blocks (R <=
//   16; above 8 the non-portable cluster size) takes a tile of bt = 8 NT
//   batch rows; rows are independent, so more rows are more clusters. Block
//   k of the cluster owns nu = ceil(U / R) hidden units J_k and their G gate
//   columns of W_hh, a [U, G nu] slice. The slice is loaded once a launch
//   into shared memory (the resident form; at U = 256 and R = 16 it is 64
//   KiB for the LSTM) and serves both directions: the forward multiplies
//   h_{t-1} by it, the backward dzh_t[:, gates(J_k)] by its transpose.
//   Where it does not fit (float32 past U of about 380), the streamed form
//   (below) reads the slice and the exchanged vector from global memory (L2)
//   each step, at any U.
// - The forward's exchange: each block pushes its units' h_t (staged in
//   shared memory with the step's other outputs) to every block's
//   double-buffered h tile through distributed shared memory (mapa +
//   st.shared::cluster, 16 bytes a store, from all its threads), then the
//   cluster meets once a step
//   (barrier.cluster arrive.release after the pushes, wait.acquire before
//   the next step's product; the step's outputs, staged in shared memory,
//   go to global memory from the whole block in between, so the barrier's
//   release waits on no global store). Double buffering makes that one
//   barrier enough: a tile is rewritten two steps after it was read, and
//   every block has passed the barrier in between.
// - The backward's exchange: block k's product is a partial dh for every
//   unit ([bt, U], over its own gate columns); it pushes the columns of
//   unit owner m into m's receive slot for rank k, and after the barrier
//   each block sums the R partials of its own units in rank order. No
//   atomics: two calls give the same bits.
// - The product runs on the tensor cores. Float32: 3xTF32 on
//   mma.sync.m16n8k8 (sm90.cuh: tf32_split, mma_tf32), products summed in
//   float32 to about 2^-21 of their size, so PyTorch's default (TF32 off
//   for a float32 product) keeps its accuracy. The forward's A operand is
//   the slice's transpose (M: a group's gate columns, below), B is h^T (N: 8
//   batch rows a tile), so a thread's accumulators hold every gate of its
//   units for two rows: the cell runs on them, and z never goes to memory
//   except as the saved values. The K (U) range is split over the block's 8
//   warps and the partial sums added in a fixed order. The backward's A is
//   the slice itself (M: units, K: the block's gate columns: a 4U-wide dz
//   row is K steps of the tensor cores, not a thread's loop), B is dzh^T.
//   Each warp keeps the small (lo.hi + hi.lo) and the large (hi.hi) terms,
//   of even and of odd k steps, in four accumulators: four independent mma
//   chains, where one accumulator made each step's latency a chain of 3 K/8
//   mma. Float64: the same structure with the product in double FMAs, a
//   thread computing the entries an mma fragment would hold.
// - A resident float32 slice is stored in its direction's fragment order
//   (load_frags): a fragment is one 16-byte load a lane, free of bank
//   conflicts and of address arithmetic. A float64 slice is stored in rows
//   with a 4-column XOR swizzle on bit 2 of the row (row stride 8 mod 32
//   words).
// - The next step's inputs are prefetched: the forward's gx rows, the
//   backward's saved values and the cell's other planes (c_t, c_{t-1}; the
//   GRU's hn and h_{t-1}; the simple RNN's h_t) and d_hs rows are copied by
//   cp.async into a second stage while the current step's product runs, 16
//   bytes a copy where every block's units start on 16 bytes (else an
//   element).
// - The cell is spread over up to 8 warps (a group's row pairs split
//   between warps); the carried state stays in shared memory of its owning
//   thread for the whole sequence (c forward; dc, or the GRU's dh_direct,
//   backward).
//
// How each cell fits that engine (Traits<C> below; kernels/_sequence.py
// `recurrence_geometry` is the same arithmetic as RecGeo):
// - Gate columns come in groups: a group is UG units (8 for the 4-gate
//   cells, 16 for the GRU and the simple RNN) and their G UG columns, in
//   slots of 8: slot q (UG / 8) + s holds gate q of the group's units 8s ..
//   8s + 7. An m16 tile of the forward's A is two slots, so a group is MT =
//   G UG / 16 tiles: the LSTM and Graves [i x8, f x8], [g x8, o x8] (2); the
//   GRU [r x8, r x8'], [u x8, u x8'], [c x8, c x8'] (3, for 16 units); the
//   simple RNN [z x8, z x8'] (1, for 16 units). Accumulator c0 / c1 of tile
//   h is slot 2h, c2 / c3 slot 2h + 1, so a lane holds every gate of units
//   gi (and gi + 8) for its two rows. The GRU is regrouped to 16 units, not
//   padded with a zero gate to 32 columns a group of 8: the padding would
//   spend a quarter of its product on zeros.
// - The GRU's candidate: the reset gate scales only the hidden part, so the
//   product's c slot is a_c alone and gx_c stays in its stage plane; the
//   cell adds b_hh (loaded once a launch into shared memory beside the
//   block's units; the LSTM folds its one bias into gx) and saves hn = a_c +
//   bh_c for the backward.
// - The GRU's backward: the product's operand is dzh (its c column dcand r)
//   and dz's c column (dcand) is staged in a tile of its own for the store.
//   The carried dh's direct term dh u is the unit owner's alone: it stays in
//   the owning thread's shared memory (as the LSTM's dc) and is added after
//   the R partials are summed in rank order, (d_hs + sum_r partial_r) +
//   dh_direct, the plain version's order.
// - Graves' peepholes: w_peep is loaded once a launch into shared memory
//   beside the block's units; o needs c_t, which the same thread computes
//   from the same accumulators just before. dW_peep is summed after the
//   kernel from dz and cs (kernels/_sequence.py).
// - The simple RNN's activation is a launch argument (Act), its gradient
//   taken from z and h_t (a stage plane).
// - Cluster geometry: the resident LSTM takes 1, 2 or 4 batch tiles a
//   cluster, the other cells 1 or 2; the plans (kernels/lstm.py,
//   kernels/recurrence.py) take the fewest rows a cluster for which all
//   clusters fit on the card at once (the occupancy calculator, asked on a
//   first eager launch), so that no cluster waits for a second wave.
// No allocation and no host sync: the wrappers launch on PyTorch's current
// stream (cudaLaunchKernelEx with the cluster dimension), so CUDA graphs
// capture the launches; kernel attributes (shared memory, the non-portable
// cluster size) are set on a launch or occupancy query before any capture.

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

// the cells; the C entries' cell codes are the engine's less one
enum Cell { kLstm = 0, kGru = 1, kGraves = 2, kSimple = 3 };

// the simple RNN's activations (kernels/recurrence.py ACTIVATIONS)
enum Act { kIdentity = 0, kTanh = 1, kRelu = 2, kSigmoid = 3, kLeaky = 4, kHardTanh = 5,
           kSoftsign = 6 };

// A cell's shape in the engine:
//   G      gate columns a unit
//   UG     units a group (its G UG columns in slots of 8; see the header)
//   NI     the backward's stage planes a step: the saved values, then LSTM
//          and Graves c_t, c_{t-1}; GRU hn, h_{t-1}; simple h_t; then d_hs
//   NO     the forward's output planes a step: the saved values, h_t, then
//          c_t (LSTM, Graves) or hn (GRU)
//   STATE  a forward state plane (c)
//   CARRY  a backward carried plane (dc; the GRU's dh_direct)
//   PF, PB parameter rows kept in shared memory, forward and backward
//          (GRU b_hh forward only: its backward reads hn; Graves w_peep)
//   X      a tile for dz beside dzh (the GRU's)
template <int C>
struct Traits;
template <>
struct Traits<kLstm> {
  static constexpr int G = 4, UG = 8, NI = 7, NO = 6, STATE = 1, CARRY = 1, PF = 0, PB = 0, X = 0;
};
template <>
struct Traits<kGraves> {
  static constexpr int G = 4, UG = 8, NI = 7, NO = 6, STATE = 1, CARRY = 1, PF = 3, PB = 3, X = 0;
};
template <>
struct Traits<kGru> {
  static constexpr int G = 3, UG = 16, NI = 6, NO = 5, STATE = 0, CARRY = 1, PF = 3, PB = 0, X = 1;
};
template <>
struct Traits<kSimple> {
  static constexpr int G = 1, UG = 16, NI = 3, NO = 2, STATE = 0, CARRY = 0, PF = 0, PB = 0, X = 0;
};

// The gate columns of a block: groups of UG units, a group's NCG = G UG
// columns in S slots of 8, MT m16 tiles.
template <int C>
struct Lay : Traits<C> {
  static constexpr int SB = Traits<C>::UG / 8;   // slots a gate
  static constexpr int S = Traits<C>::G * SB;
  static constexpr int NCG = 8 * S;
  static constexpr int MT = S / 2;
  // block-local column cl's slot in its group, gate and unit
  static __device__ __forceinline__ int slot(int cl) { return (cl % NCG) >> 3; }
  static __device__ __forceinline__ int gate(int cl) { return slot(cl) / SB; }
  static __device__ __forceinline__ int unit(int cl) {
    return (cl / NCG) * Traits<C>::UG + (slot(cl) % SB) * 8 + (cl & 7);
  }
  // the column of block-local unit jj's gate q
  static __device__ __forceinline__ int col(int jj, int q) {
    return (jj / Traits<C>::UG) * NCG + (q * SB + (jj % Traits<C>::UG) / 8) * 8 + (jj & 7);
  }
  // a slot's (of the block's ng S) gate and first unit
  static __device__ __forceinline__ int slot_gate(int sl) { return sl % S / SB; }
  static __device__ __forceinline__ int slot_unit(int sl) {
    return sl / S * Traits<C>::UG + sl % S % SB * 8;
  }
};

// The resident kernels' work split and shared-memory layout of one block,
// from U, the cluster's R blocks and NT batch tiles of 8 rows.
// kernels/_sequence.py `recurrence_geometry` is the same arithmetic.
template <int C>
struct RecGeo {
  int nu;      // units a block (the last block may own fewer)
  int ng;      // groups of UG units a block
  int nc;      // gate columns a block, padded: NCG a group
  int up;      // U padded to 16 (the backward's M, the forward's K)
  int bt;      // batch rows a cluster
  int ldw;     // the slice's row stride [up][ldw]
  int ldh;     // the h tile's row stride [bt][ldh]
  int ldg;     // a stage or output plane's, a state's and a partial's [bt][ldg]
  int ldz;     // dzh^T's [bt][ldz]
  int kt;      // k steps of 8 in the forward's product
  int ksplit;  // the forward's K range split over this many warps
  int kper;    // k steps a split (even, as kt)
  int items;   // the forward's (group, split) products
  int parts;   // the cell's (row pair, slot of 8 units) parts a group, each a warp's
  int64_t w;   // elements of the slice
  // elem: the value's bytes. A float32 slice is kept in the direction's mma
  // fragment order [up * nc], a float64 one as rows [up][ldw].
  __host__ __device__ RecGeo(int U, int R, int nt, int elem) {
    using L = Lay<C>;
    nu = (U + R - 1) / R;
    ng = (nu + L::UG - 1) / L::UG;
    nc = L::NCG * ng;
    up = (U + 15) / 16 * 16;
    bt = 8 * nt;
    ldw = nc + 8;
    ldh = up + 4;
    ldg = L::UG * ng + 4;
    ldz = nc + 4;
    kt = up / 8;
    const int want = ng >= kWarps ? 1 : kWarps / ng;
    ksplit = want < kt ? want : kt;
    kper = ((kt + ksplit - 1) / ksplit + 1) / 2 * 2;   // even: k steps go in pairs
    items = ng * ksplit;
    parts = want < 2 * nt * L::SB ? want : 2 * nt * L::SB;
    w = static_cast<int64_t>(up) * (elem == 4 ? nc : ldw);
  }
  // the slice, h [2][bt][ldh], the partial products [items][MT 4 nt][32],
  // the gx stages [2][G][bt][ldg], the state [STATE][bt][ldg], the step's
  // outputs [NO][bt][ldg] and the parameters [PF][ldg]
  __host__ __device__ int64_t fwd_elems(int nt) const {
    using L = Lay<C>;
    return w + 2LL * bt * ldh + static_cast<int64_t>(items) * L::MT * 4 * nt * 32 +
           static_cast<int64_t>(2 * L::G + L::STATE + L::NO) * bt * ldg + L::PF * ldg;
  }
  // the slice, the partial dh [2][R][bt][ldg], dzh^T [bt][ldz] (and the
  // GRU's dz^T), the stages [2][NI][bt][ldg], the carried state
  // [CARRY][bt][ldg] and the parameters [PB][ldg]
  __host__ __device__ int64_t bwd_elems(int R) const {
    using L = Lay<C>;
    return w + 2LL * R * bt * ldg + static_cast<int64_t>(1 + L::X) * bt * ldz +
           static_cast<int64_t>(2 * L::NI + L::CARRY) * bt * ldg + L::PB * ldg;
  }
};

template <typename T>
struct FwdArgs {
  T* z;          // [steps, B, GU]: gx in, the saved values out
  const T* w;    // [U, GU]
  const T* p;    // [3, U]: the GRU's b_hh, Graves' w_peep (else null)
  const T* h0;   // [B, U]
  const T* c0;   // (LSTM, Graves)
  T* hs;         // [steps, B, U]
  T* cs;         // (LSTM, Graves)
  T* hn;         // (GRU)
  int64_t steps, B;
  int U, R;
  int act;       // the simple RNN's activation (Act)
  int vec;       // 16-byte copies (every row and the blocks' units on 16 bytes)
};

template <typename T>
struct BwdArgs {
  const T* gates;   // [steps, B, GU]: the forward's saved values
  const T* hs;      // [steps, B, U] (GRU, simple)
  const T* cs;      // (LSTM, Graves)
  const T* hn;      // (GRU)
  const T* h0;      // [B, U] (GRU)
  const T* c0;      // (LSTM, Graves)
  const T* w;       // [U, GU]
  const T* p;       // [3, U] (Graves' w_peep)
  const T* d_hs;    // [steps, B, U] or null
  const T* dh_T;    // [B, U] or null
  const T* dc_T;    // (LSTM, Graves) or null
  T* dz;            // [steps, B, GU]
  T* dzh;           // the GRU's [steps, B, GU]; else dz
  T* dh0;           // [B, U]
  T* dc0;           // (LSTM, Graves)
  int64_t steps, B;
  int U, R;
  int act;
  int vec;
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

// The cell's forward for one unit and row: gx and a = h_{t-1} W_hh (G
// values each), the unit's h_{t-1} (GRU) and c_{t-1} (LSTM, Graves), its
// parameters pr (GRU b_hh, Graves w_peep: a stride apart); out: the NO
// output planes' values (the saved values, h_t, then c_t or hn).
template <int C, typename T>
__device__ __forceinline__ void cell_fwd(const T* gx, const T* v, T hp, T cp, const T* pr, int ps,
                                         int act, T* out) {
  if constexpr (C == kLstm) {
    const T i = sigmoid_(gx[0] + v[0]), f = sigmoid_(gx[1] + v[1]), gg = tanh_(gx[2] + v[2]),
            o = sigmoid_(gx[3] + v[3]);
    const T cn = f * cp + i * gg;
    out[0] = i;
    out[1] = f;
    out[2] = gg;
    out[3] = o;
    out[4] = o * tanh_(cn);
    out[5] = cn;
  } else if constexpr (C == kGraves) {
    const T i = sigmoid_(gx[0] + v[0] + pr[0] * cp), f = sigmoid_(gx[1] + v[1] + pr[ps] * cp);
    const T gg = tanh_(gx[2] + v[2]);
    const T cn = f * cp + i * gg;
    const T o = sigmoid_(gx[3] + v[3] + pr[2 * ps] * cn);
    out[0] = i;
    out[1] = f;
    out[2] = gg;
    out[3] = o;
    out[4] = o * tanh_(cn);
    out[5] = cn;
  } else if constexpr (C == kGru) {
    const T n = v[2] + pr[2 * ps];
    const T r = sigmoid_(gx[0] + (v[0] + pr[0]));
    const T u = sigmoid_(gx[1] + (v[1] + pr[ps]));
    const T c = tanh_(gx[2] + r * n);
    out[0] = r;
    out[1] = u;
    out[2] = c;
    out[3] = u * hp + (T(1) - u) * c;
    out[4] = n;
  } else {
    const T zz = gx[0] + v[0];
    out[0] = zz;
    out[1] = activate(act, zz);
  }
}

// The cell's backward for one unit and row: in, its NI stage values (the
// saved values, the cell's planes, d_hs last), dhn the carried dh (the
// summed partials, or dh_T), carry (dc; the GRU's dh_direct) in and
// updated, the parameters pr (Graves' w_peep, a stride apart); out: dz and
// dzh (the product's operand; the GRU's c column differs).
template <int C, typename T>
__device__ __forceinline__ void cell_bwd(const T* in, T dhn, T& carry, const T* pr, int ps, int act,
                                         T* dz, T* dzh) {
  constexpr int NI = Traits<C>::NI;
  const T dh = in[NI - 1] + dhn;
  if constexpr (C == kLstm || C == kGraves) {
    const T i = in[0], f = in[1], gg = in[2], o = in[3], ct = in[4], cp = in[5];
    const T tc = tanh_(ct);
    if constexpr (C == kLstm) {
      const T dc = carry + dh * o * (T(1) - tc * tc);
      dz[0] = dc * gg * i * (T(1) - i);
      dz[1] = dc * cp * f * (T(1) - f);
      dz[2] = dc * i * (T(1) - gg * gg);
      dz[3] = dh * tc * o * (T(1) - o);
      carry = dc * f;
    } else {
      const T dzo = dh * tc * o * (T(1) - o);
      const T dc = carry + dh * o * (T(1) - tc * tc) + dzo * pr[2 * ps];
      const T dzi = dc * gg * i * (T(1) - i);
      const T dzf = dc * cp * f * (T(1) - f);
      dz[0] = dzi;
      dz[1] = dzf;
      dz[2] = dc * i * (T(1) - gg * gg);
      dz[3] = dzo;
      carry = dc * f + dzi * pr[0] + dzf * pr[ps];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) dzh[q] = dz[q];
  } else if constexpr (C == kGru) {
    const T d = dh + carry;
    const T r = in[0], u = in[1], c = in[2], n = in[3], hp = in[4];
    const T du = d * (hp - c);
    const T dcand = d * (T(1) - u) * (T(1) - c * c);
    dz[0] = dzh[0] = dcand * n * r * (T(1) - r);
    dz[1] = dzh[1] = du * u * (T(1) - u);
    dz[2] = dcand;
    dzh[2] = dcand * r;
    carry = d * u;
  } else {
    dz[0] = dzh[0] = dh * activate_grad(act, in[0], in[1]);
  }
}

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
template <int C, typename T>
struct Cols {
  const T* g;
  int U, j0, nr;
  __device__ __forceinline__ T operator()(int u, int cl) const {
    using L = Lay<C>;
    const int jj = L::unit(cl);
    return u < U && jj < nr
               ? __ldg(g + static_cast<int64_t>(u) * L::G * U + L::gate(cl) * U + j0 + jj)
               : T(0);
  }
};

// The streamed backward's: W_hh[j0 + u, k] (row u of units j0 .. j0 + nr,
// any of the GU gate columns) from global memory, 0 past nr and past GU.
template <typename T>
struct Rows {
  const T* g;
  int GU, j0, nr;
  __device__ __forceinline__ T operator()(int u, int k) const {
    return u < nr && k < GU ? __ldg(g + static_cast<int64_t>(j0 + u) * GU + k) : T(0);
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

// One k step of the forward's float32 product over a group's MT tiles: the
// small terms (lo.hi + hi.lo) into sm, the large (hi.hi) into bg.
template <int NT, int MT, int NCG, typename W, typename H>
__device__ __forceinline__ void fwd_kstep(const W& w, const H& hp, int G, int kt, int kk, int lane,
                                          float (&sm)[MT][NT][4], float (&bg)[MT][NT][4]) {
  const int gi = lane >> 2, ti = lane & 3, u0 = kk * 8 + ti, u1 = u0 + 4;
  uint32_t ah[MT][4], al[MT][4];
  if constexpr (kFragOf<W>) {
    // fragments MT (G kt + kk) + h: one 16-byte load each
#pragma unroll
    for (int h = 0; h < MT; ++h) tf32_split4(w.frag((G * kt + kk) * MT + h, lane), ah[h], al[h]);
  } else {
#pragma unroll
    for (int h = 0; h < MT; ++h) {
      const int m = G * NCG + h * 16 + gi;
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
    for (int h = 0; h < MT; ++h) {
      mma_tf32(sm[h][n], al[h], bh);
      mma_tf32(sm[h][n], ah[h], bl);
      mma_tf32(bg[h][n], ah[h], bh);
    }
  }
}

// The streamed form's float32 products run their mma chains kFlush k steps
// at a time, adding each run's sums into the result in float32 (round to
// nearest): the tensor cores' accumulation loses low bits an mma, an error
// that grows with the chain, and its K is GU a warp (the resident form's
// chains are at most 24 k steps and run whole: FLUSH 0).
constexpr int kFlush = 16;

// The forward's product for group G over k steps [k0, k1): acc[h][n] is the
// m16n8 C fragment of the group's gate rows G*NCG + 16h .. +15 (rows gi:
// slot 2h, gi + 8: slot 2h + 1) and batch rows 8n .. 8n + 7, of h_{t-1} @
// W_hh[:, those columns]. Float32: 3xTF32 with the small and the large
// terms, and the even and odd k steps, in accumulators of their own (four
// independent mma chains, a quarter of one chain's latency).
template <typename T, int NT, int FLUSH, int MT, int NCG, typename W, typename H>
__device__ __forceinline__ void fwd_product(const W& w, const H& hp, int G, int kt, int k0, int k1,
                                            int lane, T (&acc)[MT][NT][4]) {
  const int gi = lane >> 2, ti = lane & 3;
#pragma unroll
  for (int h = 0; h < MT; ++h)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][n][e] = T(0);
  if constexpr (std::is_same<T, float>::value) {
    for (int kb = k0; kb < k1;) {
      const int kend = FLUSH && kb + FLUSH < k1 ? kb + FLUSH : k1;
      float sm[2][MT][NT][4] = {}, bg[2][MT][NT][4] = {};
#pragma unroll 2
      for (int kk = kb; kk < kend; kk += 2) {   // k1 - k0 is even
        fwd_kstep<NT, MT, NCG>(w, hp, G, kt, kk, lane, sm[0], bg[0]);
        fwd_kstep<NT, MT, NCG>(w, hp, G, kt, kk + 1, lane, sm[1], bg[1]);
      }
#pragma unroll
      for (int h = 0; h < MT; ++h)
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
      T wv[MT][2];
#pragma unroll
      for (int h = 0; h < MT; ++h) {
        wv[h][0] = w(u, G * NCG + h * 16 + gi);
        wv[h][1] = w(u, G * NCG + h * 16 + gi + 8);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T x0 = hp(n * 8 + 2 * ti, u), x1 = hp(n * 8 + 2 * ti + 1, u);
#pragma unroll
        for (int h = 0; h < MT; ++h) {
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
// . dzh^T[those columns, batch rows 8n ..]), a part of dh for those units
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
// fragment f = MT (G kt + kk) + h covers gate rows G*NCG + 16h .. and k step
// kk, the backward's f = mt nc/8 + kk units mt*16 .. and k step kk. An
// element a cp.async (a launch's one reorder), zero past U and past the
// block's units (the caller commits).
template <int C, bool FWD>
__device__ __forceinline__ void load_frags(float* ws, const float* w, const RecGeo<C>& g, int U, int j0,
                                           int nr) {
  using L = Lay<C>;
  for (int e = threadIdx.x; e < g.up * g.nc; e += kThreads) {
    const int f = e >> 7, lane = (e >> 2) & 31, i = e & 3, gi = lane >> 2, ti = lane & 3;
    int u, cl;
    if (FWD) {
      const int kk = (f / L::MT) % g.kt, G = (f / L::MT) / g.kt;
      u = kk * 8 + ti + (i >> 1) * 4;
      cl = G * L::NCG + (f % L::MT) * 16 + gi + (i & 1) * 8;
    } else {
      const int kk = f % (g.nc / 8), mt = f / (g.nc / 8);
      u = mt * 16 + gi + (i & 1) * 8;
      cl = kk * 8 + ti + (i >> 1) * 4;
    }
    const int jj = L::unit(cl);
    const bool ok = u < U && jj < nr;
    cp_async(ws + e, ok ? w + static_cast<int64_t>(u) * L::G * U + L::gate(cl) * U + j0 + jj : w, ok);
  }
}

// The resident float64 slice: this block's gate columns of W_hh in rows
// [up][ldw], zero past U and past its units, a row of a slot's 8 columns
// at a time (cp.async; the caller commits). The swizzle keeps a 16-byte
// run of columns contiguous.
template <int C, typename T>
__device__ __forceinline__ void load_slice(T* ws, const T* w, const RecGeo<C>& g, int U, int j0, int nr,
                                           bool vec) {
  using L = Lay<C>;
  // row r: (u, slot sl of the block's ng S) = (r / ng S, r % ng S)
  const int per_u = L::S * g.ng;
  copy_rows<T>(
      g.up * per_u, 8, vec, w,
      [&](int r) {
        const int sl = r % per_u;
        return w + static_cast<int64_t>(r / per_u) * L::G * U + L::slot_gate(sl) * U + j0 +
               L::slot_unit(sl);
      },
      [&](int r) { return r / per_u < U ? min(8, max(0, nr - L::slot_unit(r % per_u))) : 0; },
      [&](int r, int c) { return ws + slice_at(r / per_u, (r % per_u) * 8 + c, g.ldw); });
}

template <int C, typename T, int NT>
__device__ __forceinline__ void resident_fwd(const FwdArgs<T>& a) {
  using L = Lay<C>;
  constexpr int G = L::G, MT = L::MT, SB = L::SB, NO = L::NO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RecGeo<C> g(a.U, a.R, NT, sizeof(T));
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* hbuf = ws + g.w;                             // [2][bt][ldh]
  T* red = hbuf + 2 * g.bt * g.ldh;               // [items][MT 4 NT][32]
  T* gxs = red + g.items * MT * 4 * NT * 32;      // [2][G][bt][ldg]
  T* cst = gxs + 2 * G * g.bt * g.ldg;            // [STATE][bt][ldg]
  T* outs = cst + L::STATE * g.bt * g.ldg;        // [NO][bt][ldg]
  T* par = outs + NO * g.bt * g.ldg;              // [PF][ldg]
  const int rank = cluster_rank();
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / a.R) * g.bt;
  const int j0 = rank * g.nu, nr = min(g.nu, a.U - j0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2, ti = lane & 3;
  const int64_t GU = static_cast<int64_t>(G) * a.U;
  const bool vec = a.vec != 0;
  const Resident<T> W{ws, g.ldw};

  constexpr int BT = 8 * NT;   // g.bt: row maps divide by a constant
  // step t's gx of this block's units and rows (plane q, row b) into stage s
  auto stage = [&](int64_t t, int s) {
    copy_rows<T>(
        G * BT, L::UG * g.ng, vec, a.z,
        [&](int r) { return a.z + (t * a.B + row0 + r % BT) * GU + (r / BT) * a.U + j0; },
        [&](int r) { return row0 + r % BT < a.B ? nr : 0; },
        [&](int r, int c) { return gxs + (s * G * BT + r) * g.ldg + c; });
  };

  if constexpr (std::is_same<T, float>::value)
    load_frags<C, true>(ws, a.w, g, a.U, j0, nr);
  else
    load_slice<C>(ws, a.w, g, a.U, j0, nr, vec);
  stage(0, 0);
  cp_async_commit();
  // h_{-1} in tile 1 (tile 0 zero: its columns past U stay so)
  for (int e = tid; e < 2 * g.bt * g.ldh; e += kThreads) {
    const int u = e % g.ldh, b = (e / g.ldh) % g.bt, s = e / (g.ldh * g.bt);
    hbuf[e] = s == 1 && u < a.U && row0 + b < a.B ? a.h0[(row0 + b) * a.U + u] : T(0);
  }
  if constexpr (L::STATE != 0) {
    for (int e = tid; e < g.bt * g.ldg; e += kThreads) {
      const int jj = e % g.ldg, b = e / g.ldg;
      cst[e] = jj < nr && row0 + b < a.B ? a.c0[(row0 + b) * a.U + j0 + jj] : T(0);
    }
  }
  if constexpr (L::PF != 0) {
    for (int e = tid; e < L::PF * g.ldg; e += kThreads) {
      const int jj = e % g.ldg, q = e / g.ldg;
      par[e] = jj < nr ? a.p[q * a.U + j0 + jj] : T(0);
    }
  }
  cp_async_wait<0>();
  cluster_arrive();   // every block's tiles are set before any block pushes
  for (int64_t t = 0; t < a.steps; ++t) {
    const int s = static_cast<int>(t & 1);
    cluster_wait();   // h_{t-1} from every block (the tiles, at t = 0)
    if (t + 1 < a.steps) stage(t + 1, s ^ 1);
    cp_async_commit();
    // h_{t-1} @ W_hh[:, this block's columns], K split over the warps
    const T* hprev = hbuf + (s ^ 1) * g.bt * g.ldh;
    const SmemTile<T> hp{hprev, g.ldh};
    for (int it = warp; it < g.items; it += kWarps) {
      const int G0 = it % g.ng, ks = it / g.ng;
      const int k0 = ks * g.kper, k1 = min(g.kt, k0 + g.kper);
      T acc[MT][NT][4];
      fwd_product<T, NT, 0, MT, L::NCG>(W, hp, G0, g.kt, k0, k1, lane, acc);
      T* r = red + it * MT * 4 * NT * 32 + lane;
#pragma unroll
      for (int h = 0; h < MT; ++h)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) r[((h * NT + n) * 4 + e) * 32] = acc[h][n][e];
    }
    cp_async_wait<1>();   // stage t landed
    __syncthreads();
    // the cell: a thread's unit G0*UG + 8sb + gi, rows 8n + 2ti + e for its
    // part's (n, e, sb); the step's outputs into outs
    T* hnext = hbuf + s * g.bt * g.ldh;
    const T* gx = gxs + s * G * g.bt * g.ldg;
    for (int it = warp; it < g.ng * g.parts; it += kWarps) {
      const int G0 = it % g.ng;
      for (int pe = it / g.ng; pe < 2 * NT * SB; pe += g.parts) {
        const int n = (pe >> 1) % NT, e = pe & 1, sb = (pe >> 1) / NT;
        const int b = n * 8 + 2 * ti + e, jj = G0 * L::UG + sb * 8 + gi;
        T v[G], x[G], out[NO];
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int sl = q * SB + sb;
          const T* p =
              red + (G0 * MT * 4 * NT + ((sl >> 1) * NT + n) * 4 + (sl & 1) * 2 + e) * 32 + lane;
          T acc = p[0];
          for (int ks = 1; ks < g.ksplit; ++ks) acc += p[ks * g.ng * MT * 4 * NT * 32];
          v[q] = acc;
          x[q] = gx[(q * g.bt + b) * g.ldg + jj];
        }
        T hp_own = T(0), cp = T(0);
        if constexpr (C == kGru) hp_own = jj < nr ? hprev[b * g.ldh + j0 + jj] : T(0);
        T* cpp = cst + b * g.ldg + jj;
        if constexpr (L::STATE != 0) cp = *cpp;
        cell_fwd<C>(x, v, hp_own, cp, par + jj, g.ldg, a.act, out);
        if constexpr (L::STATE != 0) *cpp = out[G + 1];
        T* o = outs + b * g.ldg + jj;
#pragma unroll
        for (int q = 0; q < NO; ++q) o[q * g.bt * g.ldg] = out[q];
      }
    }
    __syncthreads();
    // h_t of this block's units into every block's tile
    push_rows<T, BT>(
        a.R, L::UG * g.ng, nr, vec, [&](int b) { return outs + (G * BT + b) * g.ldg; },
        [&](int b) { return hnext + b * g.ldh + j0; });
    cluster_arrive();   // h_t pushed
    // the step's outputs (the saved values over gx, h, c or hn), while the
    // cluster meets
    store_rows<T>(
        NO * BT, nr, vec, [&](int r) { return outs + r * g.ldg; },
        [&](int r) { return row0 + r % BT < a.B ? nr : 0; },
        [&](int r) {
          const int p = r / BT;
          const int64_t row = t * a.B + row0 + r % BT;
          return p < G ? a.z + row * GU + p * a.U + j0
                       : (p == G ? a.hs : (C == kGru ? a.hn : a.cs)) + row * a.U + j0;
        });
  }
  cluster_wait();   // no block exits while another still pushes into it
}

template <int C, typename T, int NT>
__device__ __forceinline__ void resident_bwd(const BwdArgs<T>& a) {
  using L = Lay<C>;
  constexpr int G = L::G, SB = L::SB, NI = L::NI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const RecGeo<C> g(a.U, a.R, NT, sizeof(T));
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* recv = ws + g.w;                             // [2][R][bt][ldg]
  T* dzs = recv + 2 * a.R * g.bt * g.ldg;         // [bt][ldz]: dzh^T
  T* dzo = dzs + g.bt * g.ldz;                    // [X][bt][ldz]: the GRU's dz^T
  T* stg = dzo + L::X * g.bt * g.ldz;             // [2][NI][bt][ldg]
  T* dcs = stg + 2 * NI * g.bt * g.ldg;           // [CARRY][bt][ldg]
  T* par = dcs + L::CARRY * g.bt * g.ldg;         // [PB][ldg]
  const int rank = cluster_rank();
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / a.R) * g.bt;
  const int j0 = rank * g.nu, nr = min(g.nu, a.U - j0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2, ti = lane & 3;
  const int64_t GU = static_cast<int64_t>(G) * a.U;
  const int part = a.R * g.bt * g.ldg;            // a receive slot
  const bool vec = a.vec != 0;
  const Resident<T> W{ws, g.ldw};

  constexpr int BT = 8 * NT;   // g.bt: row maps divide by a constant
  // step t's planes into stage s: the saved values, the cell's planes,
  // d_hs[t] (Traits::NI)
  auto stage = [&](int64_t t, int s) {
    copy_rows<T>(
        NI * BT, L::UG * g.ng, vec, a.gates,
        [&](int r) {
          const int p = r / BT;
          const int64_t row = row0 + r % BT, at = (t * a.B + row) * a.U + j0;
          if (p < G) return a.gates + (t * a.B + row) * GU + p * a.U + j0;
          if (p == NI - 1) return a.d_hs + at;
          if constexpr (C == kLstm || C == kGraves) {
            if (p == G) return a.cs + at;
            return t > 0 ? a.cs + at - a.B * a.U : a.c0 + row * a.U + j0;
          } else if constexpr (C == kGru) {
            if (p == G) return a.hn + at;
            return t > 0 ? a.hs + at - a.B * a.U : a.h0 + row * a.U + j0;
          } else {
            return a.hs + at;
          }
        },
        [&](int r) { return row0 + r % BT < a.B && (r < (NI - 1) * BT || a.d_hs != nullptr) ? nr : 0; },
        [&](int r, int c) { return stg + (s * NI * BT + r) * g.ldg + c; });
  };

  if constexpr (std::is_same<T, float>::value)
    load_frags<C, false>(ws, a.w, g, a.U, j0, nr);
  else
    load_slice<C>(ws, a.w, g, a.U, j0, nr, vec);
  stage(a.steps - 1, static_cast<int>((a.steps - 1) & 1));
  cp_async_commit();
  if constexpr (L::CARRY != 0) {
    for (int e = tid; e < g.bt * g.ldg; e += kThreads) {
      const int jj = e % g.ldg, b = e / g.ldg;
      dcs[e] = C != kGru && a.dc_T != nullptr && jj < nr && row0 + b < a.B
                   ? a.dc_T[(row0 + b) * a.U + j0 + jj]
                   : T(0);
    }
  }
  if constexpr (L::PB != 0) {
    for (int e = tid; e < L::PB * g.ldg; e += kThreads) {
      const int jj = e % g.ldg, q = e / g.ldg;
      par[e] = jj < nr ? a.p[q * a.U + j0 + jj] : T(0);
    }
  }
  for (int e = tid; e < (1 + L::X) * g.bt * g.ldz; e += kThreads) dzs[e] = T(0);
  cp_async_wait<0>();
  cluster_arrive();   // every block's buffers are set before any block pushes
  for (int64_t t = a.steps - 1; t >= 0; --t) {
    const int s = static_cast<int>(t & 1);
    cluster_wait();   // step t + 1's partials from every block
    if (t > 0) stage(t - 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // stage t landed
    __syncthreads();      // (and the last step's dz is stored: dzs is free)
    // the cell's gradient: a thread's unit G0*UG + 8sb + gi, rows 8n + 2ti
    // + e for its part's (n, e, sb)
    const T* in = stg + s * NI * g.bt * g.ldg;
    const T* dhp = recv + (s ^ 1) * part;         // the R partials of step t + 1
    for (int it = warp; it < g.ng * g.parts; it += kWarps) {
      const int G0 = it % g.ng;
      for (int pe = it / g.ng; pe < 2 * NT * SB; pe += g.parts) {
        const int n = (pe >> 1) % NT, e = pe & 1, sb = (pe >> 1) / NT;
        const int b = n * 8 + 2 * ti + e, jj = G0 * L::UG + sb * 8 + gi, at = b * g.ldg + jj;
        const bool unit = jj < nr;
        T dhn = T(0);
        if (t == a.steps - 1) {
          if (a.dh_T != nullptr && unit && row0 + b < a.B) dhn = a.dh_T[(row0 + b) * a.U + j0 + jj];
        } else {
          dhn = dhp[at];
          for (int r = 1; r < a.R; ++r) dhn += dhp[r * g.bt * g.ldg + at];
        }
        T x[NI], dz[G], dzh[G];
#pragma unroll
        for (int p = 0; p < NI; ++p) x[p] = in[(p * g.bt + b) * g.ldg + jj];
        T carry = T(0);
        if constexpr (L::CARRY != 0) carry = dcs[at];
        cell_bwd<C>(x, dhn, carry, par + jj, g.ldg, a.act, dz, dzh);
        if constexpr (L::CARRY != 0) dcs[at] = unit ? carry : T(0);
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int cl = L::col(jj, q);
          dzs[b * g.ldz + cl] = unit ? dzh[q] : T(0);
          if constexpr (L::X != 0) dzo[b * g.ldz + cl] = unit ? dz[q] : T(0);
        }
      }
    }
    __syncthreads();
    // this block's part of dzh_t W_hh^T for every unit, pushed to each
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
    // dz_t (the GRU's dzh_t too), while the cluster meets: row r is slot
    // r / BT's 8 columns at batch row r % BT
    for (int o = 0; o < 1 + L::X; ++o) {
      const T* tile = o == 0 ? dzs : dzo;
      T* dst = o == 0 ? a.dzh : a.dz;
      store_rows<T>(
          g.ng * L::S * BT, 8, vec, [&](int r) { return tile + (r % BT) * g.ldz + (r / BT) * 8; },
          [&](int r) { return row0 + r % BT < a.B ? min(8, max(0, nr - L::slot_unit(r / BT))) : 0; },
          [&](int r) {
            return dst + (t * a.B + row0 + r % BT) * GU + L::slot_gate(r / BT) * a.U + j0 +
                   L::slot_unit(r / BT);
          });
    }
  }
  cluster_wait();   // step 0's partials; no block exits while another pushes
  // dh0 = the partials of step 0 (the GRU's with its direct term), dc0 =
  // the carried dc
  for (int e = tid; e < g.bt * nr; e += kThreads) {
    const int b = e / nr, jj = e - b * nr, at = b * g.ldg + jj;
    if (row0 + b >= a.B) continue;
    T dh = recv[at];
    for (int r = 1; r < a.R; ++r) dh += recv[r * g.bt * g.ldg + at];
    if constexpr (C == kGru) dh += dcs[at];
    a.dh0[(row0 + b) * a.U + j0 + jj] = dh;
    if constexpr (C == kLstm || C == kGraves) a.dc0[(row0 + b) * a.U + j0 + jj] = dcs[at];
  }
}

// The streamed form, for widths whose slice does not fit shared memory: the
// same cluster of R blocks and ownership of units, 8 batch rows a cluster,
// but W_hh is read from global memory (L2) every step, and so is the
// exchanged vector: a block stores its units' h_t (dzh_t) to the output in
// global memory before the cluster's barrier (its release orders those
// stores before every block's wait), and every block reads the whole of it
// at L2 after. The backward's product is then each block's own: dh for its
// units is dzh_{t+1} (all GU gate columns) times its units' rows of W_hh,
// no partials. A block takes its units in passes of kPass, each pass's
// product, over K split between the warps, summed in shared memory in a
// fixed order, then its cell, which reads and writes global memory (the
// carried c and dc in cs and dc0, the GRU's dh_direct in dh0). Its shared
// memory is the partial products alone, so it takes any U.
constexpr int kPass = 64;
constexpr int kStreamBwdElems = kWarps * 4 * 32;   // a warp's m16n8 product
// a warp's forward product: MT m16n8 tiles
template <int C>
constexpr int kStreamFwdElems = kWarps * Lay<C>::MT * 4 * 32;

// n products over ksteps (even) k steps of 8: the K range split over
// ksplit warps of kper (even) steps each
__device__ __forceinline__ void split_k(int n, int ksteps, int& ksplit, int& kper) {
  const int want = n >= kWarps ? 1 : kWarps / n;
  ksplit = want < ksteps ? want : ksteps;
  kper = ((ksteps + ksplit - 1) / ksplit + 1) / 2 * 2;
}

template <int C, typename T>
__device__ __forceinline__ void stream_fwd(const FwdArgs<T>& a) {
  using L = Lay<C>;
  constexpr int G = L::G, MT = L::MT, SB = L::SB, NO = L::NO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);   // [items][MT 4][32]
  const int rank = cluster_rank(), nu = (a.U + a.R - 1) / a.R;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / a.R) * 8;
  const int rows = a.B - row0 < 8 ? static_cast<int>(a.B - row0) : 8;
  const int j0 = rank * nu, nr = min(nu, a.U - j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gi = lane >> 2, ti = lane & 3;
  const int kt = (a.U + 15) / 16 * 2;
  const int64_t GU = static_cast<int64_t>(G) * a.U;
  for (int64_t t = 0; t < a.steps; ++t) {
    if (t > 0) cluster_wait();   // h_{t-1} of every block stored
    const T* hprev = t > 0 ? a.hs + ((t - 1) * a.B + row0) * a.U : a.h0 + row0 * a.U;
    const T* cprev = t > 0 ? a.cs + ((t - 1) * a.B + row0) * a.U : a.c0 + row0 * a.U;
    const GlobalTile<T> hp{hprev, a.U, rows, a.U};
    for (int p0 = 0; p0 < nr; p0 += kPass) {
      const int pr = min(kPass, nr - p0), ng = (pr + L::UG - 1) / L::UG;
      int ksplit, kper;
      split_k(ng, kt, ksplit, kper);
      const Cols<C, T> W{a.w, a.U, j0 + p0, pr};
      for (int it = warp; it < ng * ksplit; it += kWarps) {
        const int G0 = it % ng, k0 = it / ng * kper, k1 = min(kt, k0 + kper);
        T acc[MT][1][4];
        fwd_product<T, 1, kFlush, MT, L::NCG>(W, hp, G0, kt, k0, k1, lane, acc);
#pragma unroll
        for (int h = 0; h < MT; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[(it * MT * 4 + h * 4 + e) * 32 + lane] = acc[h][0][e];
      }
      __syncthreads();
      // the cell: a thread's unit G0*UG + 8sb + gi of the pass, rows 2ti + e
      const int parts = ng >= kWarps ? 1 : (kWarps / ng < 2 * SB ? kWarps / ng : 2 * SB);
      for (int it = warp; it < ng * parts; it += kWarps) {
        const int G0 = it % ng;
        for (int pe = it / ng; pe < 2 * SB; pe += parts) {
          const int e = pe & 1, sb = pe >> 1, b = 2 * ti + e, jj = G0 * L::UG + sb * 8 + gi;
          if (jj >= pr || b >= rows) continue;
          const int j = j0 + p0 + jj;
          T* zr = a.z + (t * a.B + row0 + b) * GU + j;
          T v[G], x[G], out[NO], prm[3] = {T(0), T(0), T(0)};
#pragma unroll
          for (int q = 0; q < G; ++q) {
            const int sl = q * SB + sb;
            const T* p = red + (G0 * MT * 4 + (sl >> 1) * 4 + (sl & 1) * 2 + e) * 32 + lane;
            T acc = p[0];
            for (int ks = 1; ks < ksplit; ++ks) acc += p[ks * ng * MT * 4 * 32];
            v[q] = acc;
            x[q] = zr[q * a.U];
          }
          if constexpr (L::PF != 0) {
#pragma unroll
            for (int q = 0; q < 3; ++q) prm[q] = a.p[q * a.U + j];
          }
          T hp_own = T(0), cp = T(0);
          if constexpr (C == kGru) hp_own = hprev[b * a.U + j];
          if constexpr (L::STATE != 0) cp = cprev[b * a.U + j];
          cell_fwd<C>(x, v, hp_own, cp, prm, 1, a.act, out);
#pragma unroll
          for (int q = 0; q < G; ++q) zr[q * a.U] = out[q];
          const int64_t at = (t * a.B + row0 + b) * a.U + j;
          a.hs[at] = out[G];
          if constexpr (C == kGru) a.hn[at] = out[G + 1];
          if constexpr (L::STATE != 0) a.cs[at] = out[G + 1];
        }
      }
      __syncthreads();   // the partials are the next pass's
    }
    cluster_arrive();   // h_t stored
  }
  cluster_wait();
}

template <int C, typename T>
__device__ __forceinline__ void stream_bwd(const BwdArgs<T>& a) {
  using L = Lay<C>;
  constexpr int G = L::G, NI = L::NI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* red = reinterpret_cast<T*>(smem_raw);   // [items][4][32]
  const int rank = cluster_rank(), nu = (a.U + a.R - 1) / a.R;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / a.R) * 8;
  const int rows = a.B - row0 < 8 ? static_cast<int>(a.B - row0) : 8;
  const int j0 = rank * nu, nr = min(nu, a.U - j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int GU = G * a.U;
  const int kt = (GU + 15) / 16 * 2;   // k steps over the GU gate columns
  // dzh_s @ W_hh[units p0 .. p0 + pr of this block, :]^T into red; the split
  auto carried = [&](int64_t s, int p0, int pr, int& mts, int& ksplit) {
    mts = (pr + 15) / 16;
    int kper;
    split_k(mts, kt, ksplit, kper);
    const Rows<T> W{a.w, GU, j0 + p0, pr};
    const GlobalTile<T> dz{a.dzh + (s * a.B + row0) * GU, GU, rows, GU};
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
    if (!last) cluster_wait();   // dzh_{t+1} of every block stored
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
        const int64_t r = row0 + b, row = t * a.B + r, at = row * a.U + j, rj = r * a.U + j;
        T dhn = T(0), carry = T(0);
        if (last) {
          if (a.dh_T != nullptr) dhn = a.dh_T[rj];
          if (C != kGru && L::CARRY != 0 && a.dc_T != nullptr) carry = a.dc_T[rj];
        } else {
          dhn = dh_of(jj, b, mts, ksplit);
          // this thread's, a step before: dc in dc0, the GRU's dh_direct in dh0
          if constexpr (C == kGru) carry = a.dh0[rj];
          else if constexpr (L::CARRY != 0) carry = a.dc0[rj];
        }
        T in[NI], dz[G], dzh[G], prm[3] = {T(0), T(0), T(0)};
        const T* gr = a.gates + row * GU + j;
#pragma unroll
        for (int q = 0; q < G; ++q) in[q] = gr[q * a.U];
        in[NI - 1] = a.d_hs != nullptr ? a.d_hs[at] : T(0);
        if constexpr (C == kLstm || C == kGraves) {
          in[4] = a.cs[at];
          in[5] = t > 0 ? a.cs[at - a.B * a.U] : a.c0[rj];
        } else if constexpr (C == kGru) {
          in[3] = a.hn[at];
          in[4] = t > 0 ? a.hs[at - a.B * a.U] : a.h0[rj];
        } else {
          in[1] = a.hs[at];
        }
        if constexpr (L::PB != 0) {
#pragma unroll
          for (int q = 0; q < 3; ++q) prm[q] = a.p[q * a.U + j];
        }
        cell_bwd<C>(in, dhn, carry, prm, 1, a.act, dz, dzh);
#pragma unroll
        for (int q = 0; q < G; ++q) {
          a.dz[row * GU + q * a.U + j] = dz[q];
          if constexpr (C == kGru) a.dzh[row * GU + q * a.U + j] = dzh[q];
        }
        if constexpr (C == kGru) a.dh0[rj] = carry;
        else if constexpr (L::CARRY != 0) a.dc0[rj] = carry;
      }
      __syncthreads();   // the partials are the next pass's
    }
    cluster_arrive();   // dzh_t stored
  }
  cluster_wait();   // dzh_0 of every block
  // dh0 = dzh_0 @ W_hh^T for this block's units (the GRU's plus its direct
  // term, which dh0 holds)
  for (int p0 = 0; p0 < nr; p0 += kPass) {
    const int pr = min(kPass, nr - p0);
    int mts, ksplit;
    carried(0, p0, pr, mts, ksplit);
    __syncthreads();
    for (int x = threadIdx.x; x < 8 * pr; x += kThreads) {
      const int b = x / pr, jj = x - b * pr;
      if (b >= rows) continue;
      T* d = a.dh0 + (row0 + b) * a.U + j0 + p0 + jj;
      const T v = dh_of(jj, b, mts, ksplit);
      *d = C == kGru ? v + *d : v;
    }
    __syncthreads();
  }
}

// The kernels, a cell's each: the resident form (NT batch tiles) and the
// streamed one, each way.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1) lstm_recurrence_fwd_kernel(const FwdArgs<T> a) {
  resident_fwd<kLstm, T, NT>(a);
}
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1) lstm_recurrence_bwd_kernel(const BwdArgs<T> a) {
  resident_bwd<kLstm, T, NT>(a);
}
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) lstm_stream_fwd_kernel(const FwdArgs<T> a) {
  stream_fwd<kLstm>(a);
}
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) lstm_stream_bwd_kernel(const BwdArgs<T> a) {
  stream_bwd<kLstm>(a);
}
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1) gru_recurrence_fwd_kernel(const FwdArgs<T> a) {
  resident_fwd<kGru, T, NT>(a);
}
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1) gru_recurrence_bwd_kernel(const BwdArgs<T> a) {
  resident_bwd<kGru, T, NT>(a);
}
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) gru_stream_fwd_kernel(const FwdArgs<T> a) {
  stream_fwd<kGru>(a);
}
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) gru_stream_bwd_kernel(const BwdArgs<T> a) {
  stream_bwd<kGru>(a);
}
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1) graves_recurrence_fwd_kernel(const FwdArgs<T> a) {
  resident_fwd<kGraves, T, NT>(a);
}
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1) graves_recurrence_bwd_kernel(const BwdArgs<T> a) {
  resident_bwd<kGraves, T, NT>(a);
}
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) graves_stream_fwd_kernel(const FwdArgs<T> a) {
  stream_fwd<kGraves>(a);
}
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) graves_stream_bwd_kernel(const BwdArgs<T> a) {
  stream_bwd<kGraves>(a);
}
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1) simple_recurrence_fwd_kernel(const FwdArgs<T> a) {
  resident_fwd<kSimple, T, NT>(a);
}
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1) simple_recurrence_bwd_kernel(const BwdArgs<T> a) {
  resident_bwd<kSimple, T, NT>(a);
}
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) simple_stream_fwd_kernel(const FwdArgs<T> a) {
  stream_fwd<kSimple>(a);
}
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) simple_stream_bwd_kernel(const BwdArgs<T> a) {
  stream_bwd<kSimple>(a);
}

// the kernel of (cell, type, batch tiles, resident) and direction; the
// streamed form takes one tile
template <int C, typename T, int NT, bool RES>
void (*fwd_kernel())(FwdArgs<T>) {
  if constexpr (C == kLstm) {
    if constexpr (RES) return lstm_recurrence_fwd_kernel<T, NT>;
    else return lstm_stream_fwd_kernel<T>;
  } else if constexpr (C == kGru) {
    if constexpr (RES) return gru_recurrence_fwd_kernel<T, NT>;
    else return gru_stream_fwd_kernel<T>;
  } else if constexpr (C == kGraves) {
    if constexpr (RES) return graves_recurrence_fwd_kernel<T, NT>;
    else return graves_stream_fwd_kernel<T>;
  } else {
    if constexpr (RES) return simple_recurrence_fwd_kernel<T, NT>;
    else return simple_stream_fwd_kernel<T>;
  }
}
template <int C, typename T, int NT, bool RES>
void (*bwd_kernel())(BwdArgs<T>) {
  if constexpr (C == kLstm) {
    if constexpr (RES) return lstm_recurrence_bwd_kernel<T, NT>;
    else return lstm_stream_bwd_kernel<T>;
  } else if constexpr (C == kGru) {
    if constexpr (RES) return gru_recurrence_bwd_kernel<T, NT>;
    else return gru_stream_bwd_kernel<T>;
  } else if constexpr (C == kGraves) {
    if constexpr (RES) return graves_recurrence_bwd_kernel<T, NT>;
    else return graves_stream_bwd_kernel<T>;
  } else {
    if constexpr (RES) return simple_recurrence_bwd_kernel<T, NT>;
    else return simple_stream_bwd_kernel<T>;
  }
}

// a block's shared memory (bytes)
template <int C, typename T, int NT, bool RES>
int64_t smem_bytes(int U, int R, bool fwd) {
  if (!RES) return (fwd ? kStreamFwdElems<C> : kStreamBwdElems) * static_cast<int64_t>(sizeof(T));
  const RecGeo<C> g(U, R, NT, sizeof(T));
  return (fwd ? g.fwd_elems(NT) : g.bwd_elems(R)) * static_cast<int64_t>(sizeof(T));
}

// Shared memory past 48 KB and the non-portable cluster size, once per
// device and kernel (sm90.cuh).
template <int C, typename T, int NT, bool RES, bool FWD>
cudaError_t configure() {
  static std::mutex mu;
  static std::set<int> raised;
  const int smem = static_cast<int>(kSmemLimit);
  return FWD ? allow_clusters_once(fwd_kernel<C, T, NT, RES>(), smem, mu, raised)
             : allow_clusters_once(bwd_kernel<C, T, NT, RES>(), smem, mu, raised);
}

// a launch's configuration: `clusters` clusters of R blocks
struct Launch : ClusterLaunch {
  Launch(int64_t clusters, int R, size_t smem, cudaStream_t st)
      : ClusterLaunch(clusters, R, kThreads, smem, st) {}
};

// what the entries take: R blocks a cluster, each with at least one unit,
// and 1, 2 or 4 batch tiles (the LSTM; the other cells 1 or 2)
bool valid_split(int64_t U, int R, int nt, int max_nt) {
  return valid_cluster_split(U, R, kMaxRanks) && (nt == 1 || nt == 2 || nt == 4) && nt <= max_nt;
}

template <int C, typename T, int NT, bool RES>
int launch_fwd(const FwdArgs<T>& a, cudaStream_t st) {
  const int64_t smem = smem_bytes<C, T, NT, RES>(a.U, a.R, true);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = configure<C, T, NT, RES, true>();
  if (e != cudaSuccess) return static_cast<int>(e);
  Launch l((a.B + 8 * NT - 1) / (8 * NT), a.R, static_cast<size_t>(smem), st);
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, fwd_kernel<C, T, NT, RES>(), a));
}

template <int C, typename T, int NT, bool RES>
int launch_bwd(const BwdArgs<T>& a, cudaStream_t st) {
  const int64_t smem = smem_bytes<C, T, NT, RES>(a.U, a.R, false);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = configure<C, T, NT, RES, false>();
  if (e != cudaSuccess) return static_cast<int>(e);
  Launch l((a.B + 8 * NT - 1) / (8 * NT), a.R, static_cast<size_t>(smem), st);
  return static_cast<int>(cudaLaunchKernelEx(&l.cfg, bwd_kernel<C, T, NT, RES>(), a));
}

// out: the forward's and the backward's shared memory (bytes), and the
// clusters of R blocks the card holds at once for each (the occupancy
// calculator; 0 where the memory does not fit a block)
template <int C, typename T, int NT, bool RES>
int query(int U, int R, int64_t* out) {
  out[0] = smem_bytes<C, T, NT, RES>(U, R, true);
  out[1] = smem_bytes<C, T, NT, RES>(U, R, false);
  out[2] = out[3] = 0;
  for (int d = 0; d < 2; ++d) {
    if (out[d] > kSmemLimit) continue;
    const cudaError_t e = d == 0 ? configure<C, T, NT, RES, true>() : configure<C, T, NT, RES, false>();
    if (e != cudaSuccess) return static_cast<int>(e);
    Launch l(1, R, static_cast<size_t>(out[d]), nullptr);
    int n = 0;
    const cudaError_t r = d == 0 ? cudaOccupancyMaxActiveClusters(&n, fwd_kernel<C, T, NT, RES>(), &l.cfg)
                                 : cudaOccupancyMaxActiveClusters(&n, bwd_kernel<C, T, NT, RES>(), &l.cfg);
    if (r != cudaSuccess) return static_cast<int>(r);
    out[2 + d] = n;
  }
  return 0;
}

// the LSTM's instantiation for (nt, resident): the streamed form at one tile
#define DL4J_LSTM_DISPATCH(fn, T, ...)                                                 \
  switch (nt * 2 + (resident ? 1 : 0)) {                                             \
    case 2: return fn<kLstm, T, 1, false>(__VA_ARGS__);                              \
    case 3: return fn<kLstm, T, 1, true>(__VA_ARGS__);                               \
    case 5: return fn<kLstm, T, 2, true>(__VA_ARGS__);                               \
    case 9: return fn<kLstm, T, 4, true>(__VA_ARGS__);                               \
    default: return static_cast<int>(cudaErrorInvalidValue);                         \
  }

// the other cells' instantiation for (cell, tiles): tiles 0 the streamed
// form, 1 or 2 the resident form at that many batch tiles
#define DL4J_CELL_DISPATCH(fn, T, ...)                                                 \
  switch (cell * 3 + tiles) {                                                        \
    case 0: return fn<kGru, T, 1, false>(__VA_ARGS__);                               \
    case 1: return fn<kGru, T, 1, true>(__VA_ARGS__);                                \
    case 2: return fn<kGru, T, 2, true>(__VA_ARGS__);                                \
    case 3: return fn<kGraves, T, 1, false>(__VA_ARGS__);                            \
    case 4: return fn<kGraves, T, 1, true>(__VA_ARGS__);                             \
    case 5: return fn<kGraves, T, 2, true>(__VA_ARGS__);                             \
    case 6: return fn<kSimple, T, 1, false>(__VA_ARGS__);                            \
    case 7: return fn<kSimple, T, 1, true>(__VA_ARGS__);                             \
    case 8: return fn<kSimple, T, 2, true>(__VA_ARGS__);                             \
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
  FwdArgs<T> a{};
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
  BwdArgs<T> a{};
  a.gates = static_cast<const T*>(gates);
  a.cs = static_cast<const T*>(cs);
  a.c0 = static_cast<const T*>(c0);
  a.w = static_cast<const T*>(w_hh);
  a.d_hs = static_cast<const T*>(d_hs);
  a.dh_T = static_cast<const T*>(dh_T);
  a.dc_T = static_cast<const T*>(dc_T);
  a.dz = static_cast<T*>(dz);
  a.dzh = a.dz;
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

template <typename T>
int rnn_fwd_t(int cell, void* z, const void* w, const void* b_hh, const void* wp, const void* h0,
              const void* c0, void* hs, void* cs, void* hn, int64_t steps, int64_t B, int64_t U, int R,
              int tiles, int act, cudaStream_t st) {
  FwdArgs<T> a{};
  a.z = static_cast<T*>(z);
  a.w = static_cast<const T*>(w);
  a.p = static_cast<const T*>(cell == 0 ? b_hh : wp);
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
  a.vec = vec_ok<T>(U, R, {z, w, hs, cs, hn});
  DL4J_CELL_DISPATCH(launch_fwd, T, a, st)
}

template <typename T>
int rnn_bwd_t(int cell, const void* z, const void* hs, const void* cs, const void* hn, const void* h0,
              const void* c0, const void* w, const void* wp, const void* d_hs, const void* dh_T,
              const void* dc_T, void* dz, void* dzh, void* dh0, void* dc0, int64_t steps, int64_t B,
              int64_t U, int R, int tiles, int act, cudaStream_t st) {
  BwdArgs<T> a{};
  a.gates = static_cast<const T*>(z);
  a.hs = static_cast<const T*>(hs);
  a.cs = static_cast<const T*>(cs);
  a.hn = static_cast<const T*>(hn);
  a.h0 = static_cast<const T*>(h0);
  a.c0 = static_cast<const T*>(c0);
  a.w = static_cast<const T*>(w);
  a.p = static_cast<const T*>(wp);
  a.d_hs = static_cast<const T*>(d_hs);
  a.dh_T = static_cast<const T*>(dh_T);
  a.dc_T = static_cast<const T*>(dc_T);
  a.dz = static_cast<T*>(dz);
  a.dzh = static_cast<T*>(cell == 0 ? dzh : dz);
  a.dh0 = static_cast<T*>(dh0);
  a.dc0 = static_cast<T*>(dc0);
  a.steps = steps;
  a.B = B;
  a.U = static_cast<int>(U);
  a.R = R;
  a.act = act;
  a.vec = vec_ok<T>(U, R, {z, hs, cs, hn, h0, c0, w, d_hs, dz, a.dzh});
  DL4J_CELL_DISPATCH(launch_bwd, T, a, st)
}

template <typename T>
int rnn_query_t(int cell, int64_t U, int R, int tiles, int64_t* out) {
  DL4J_CELL_DISPATCH(query, T, static_cast<int>(U), R, out)
}

// the pointers each cell needs (0 GRU, 1 Graves, 2 simple)
bool rnn_inputs(int cell, const void* b_hh, const void* wp, const void* c0) {
  if (cell == 0) return b_hh != nullptr;
  if (cell == 1) return wp != nullptr && c0 != nullptr;
  return cell == 2;
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
  if (T < 1 || B < 1 || !valid_split(U, R, nt, 4) || dtype < 0 || dtype > 1)
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
  if (T < 1 || B < 1 || !valid_split(U, R, nt, 4) || dtype < 0 || dtype > 1)
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
  if (!valid_split(U, R, nt, 4) || dtype < 0 || dtype > 1) return static_cast<int>(cudaErrorInvalidValue);
  int64_t* o = static_cast<int64_t*>(out);
  return dtype == 0 ? query_t<float>(U, R, nt, resident, o) : query_t<double>(U, R, nt, resident, o);
}

// The GRU, Graves and simple RNN cells. cell: 0 GRU, 1 Graves (peephole)
// LSTM, 2 simple RNN; dtype: 0 float32, 1 float64; R blocks a cluster;
// resident: 0 the streamed form (a tile of 8 batch rows a cluster), 1 or 2
// the resident form (W_hh's slice in shared memory) at that many tiles of
// 8 batch rows a cluster; act: the simple RNN's activation (enum Act). z
// holds gx on entry and the saved values on return; cs (Graves) and hn
// (GRU) are written, null for the other cells. Returns the launch's
// cudaError_t.
extern "C" int dl4j_rnn_recurrence_fwd(int cell, void* z, const void* w_hh, const void* b_hh,
                                       const void* w_peep, const void* h0, const void* c0, void* hs,
                                       void* cs, void* hn, int64_t T, int64_t B, int64_t U, int R,
                                       int resident, int act, int dtype, void* stream) {
  if (T < 1 || B < 1 || resident < 0 || !valid_split(U, R, resident > 0 ? resident : 1, 2) ||
      dtype < 0 || dtype > 1 || act < 0 || act > 6 || !rnn_inputs(cell, b_hh, w_peep, c0) ||
      (cell == 1 && cs == nullptr) || (cell == 0 && hn == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = resident;
  return dtype == 0 ? rnn_fwd_t<float>(cell, z, w_hh, b_hh, w_peep, h0, c0, hs, cs, hn, T, B, U, R,
                                       tiles, act, s)
                    : rnn_fwd_t<double>(cell, z, w_hh, b_hh, w_peep, h0, c0, hs, cs, hn, T, B, U, R,
                                        tiles, act, s);
}

// d_hs, dh_T and dc_T may be null (zero); dzh is the GRU's own buffer (the
// other cells pass dz); dc0 is written for Graves only.
extern "C" int dl4j_rnn_recurrence_bwd(int cell, const void* z, const void* hs, const void* cs,
                                       const void* hn, const void* h0, const void* c0,
                                       const void* w_hh, const void* w_peep, const void* d_hs,
                                       const void* dh_T, const void* dc_T, void* dz, void* dzh,
                                       void* dh0, void* dc0, int64_t T, int64_t B, int64_t U, int R,
                                       int resident, int act, int dtype, void* stream) {
  if (T < 1 || B < 1 || resident < 0 || !valid_split(U, R, resident > 0 ? resident : 1, 2) ||
      dtype < 0 || dtype > 1 || act < 0 || act > 6 || cell < 0 || cell > 2 ||
      (cell == 1 && (w_peep == nullptr || c0 == nullptr || cs == nullptr || dc0 == nullptr)) ||
      (cell == 0 && (hn == nullptr || dzh == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = resident;
  return dtype == 0 ? rnn_bwd_t<float>(cell, z, hs, cs, hn, h0, c0, w_hh, w_peep, d_hs, dh_T, dc_T,
                                       dz, dzh, dh0, dc0, T, B, U, R, tiles, act, s)
                    : rnn_bwd_t<double>(cell, z, hs, cs, hn, h0, c0, w_hh, w_peep, d_hs, dh_T, dc_T,
                                        dz, dzh, dh0, dc0, T, B, U, R, tiles, act, s);
}

// out: int64[4], the forward's and the backward's shared memory a block
// (bytes) and the clusters the card holds at once for each; resident as
// the entries' (0 streamed, else the resident form's tiles).
extern "C" int dl4j_rnn_recurrence_query(int cell, int64_t U, int R, int resident, int dtype,
                                         void* out) {
  if (resident < 0 || !valid_split(U, R, resident > 0 ? resident : 1, 2) || dtype < 0 ||
      dtype > 1 || cell < 0 || cell > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t* o = static_cast<int64_t*>(out);
  const int tiles = resident;
  return dtype == 0 ? rnn_query_t<float>(cell, U, R, tiles, o)
                    : rnn_query_t<double>(cell, U, R, tiles, o);
}
