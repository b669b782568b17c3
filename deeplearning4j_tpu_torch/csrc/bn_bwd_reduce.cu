// Phase 1 of the training batch norm's backward, with its fold, in one
// launch per BN layer, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_phase1_kernel` of `bn_relu_bwd_pallas`
// (experiments/pallas_bn_spike.py:40, launched at :87) together with the
// fold the spike ran between its two kernels (:97-107). Phase 2 stays a
// Triton kernel (kernels/bn_relu_triton.py); the plain PyTorch version of
// this function is `phase1_fold_plain` in kernels/bn_relu.py.
//
// Per channel c, over the R rows of x and dy (N*H*W of an NCHW tensor):
//   dz     = dy * [round(round(x * a) + b) > 0]   (dz = dy without the
//            ReLU; each rounding to x's dtype, as the forward computed it)
//   s1     = sum(dz),  s2 = sum(dz * (x - mean))
//   dgamma = inv * s2, dbeta = s1                 (in gamma's dtype)
//   g      = gamma * inv, c1 = s1 / R, c2 = inv * dgamma / R
//                                                 (accumulation dtype)
// Types: x, dy, a, b in bf16, float32 or float64; mean and inv in the
// accumulation type (float32, float64 for float64 input); gamma in bf16,
// float32 or float64.
//
// What bounds it: device-memory bandwidth. It reads x and dy once (4 bytes
// per element in bf16) and does ~9 operations per element, far under the
// card's operations-per-byte line.
//
// What the design does about it:
// - Grid (channel blocks) x (row splits). A block is 256 threads in a
//   (TX, 256 / TX) layout; each thread owns V consecutive channels (V = 8
//   bf16, 4 float32, 2 float64: one 16-byte load) and a strided subset of
//   its split's rows. The wrapper sizes the splits from R, C and the SM
//   count so that the grid fills the card's resident blocks (two per SM)
//   in one wave: a few blocks past it would run as a second wave.
// - Channels-last rows (the main path) take 16-byte loads, four rows per
//   step, each predicated, so a thread keeps eight loads in flight to the
//   last step. Any other layout (a dy in NCHW, a C that is not a multiple
//   of V) takes the element-strided loop of the same kernel: no copy.
// - Sums in float32 (float64 for float64), reduced within the block in a
//   fixed order: a butterfly of shuffles over a warp's row lanes, then the
//   warps in order through shared memory.
// - The fold runs in the same launch, deterministically and without
//   atomics on data: every block writes its partial (s1, s2) to a
//   workspace [splits, 2, n_cblk * CB] and counts itself in on its channel
//   block's counter (one acquire-release atomic). The last block to arrive
//   sums the splits in a fixed order (lane l takes splits l, l + L, ..., in
//   order, then the L lanes in order), applies the fold with gamma and inv
//   it read at its start, writes the five vectors and resets its counter
//   to 0, so the next launch needs no memset. Results are bit-equal from
//   run to run.
// - The ReLU mask recomputes z with __fmul_rn / __fadd_rn (rounded to bf16
//   after each for bf16 input), so nvcc cannot contract x * a + b into one
//   FMA: the mask equals the forward's bit for bit.
// - The wrapper launches on PyTorch's current stream and allocates the
//   outputs; the workspace and counters are cached per device and stay at
//   the same address across calls. Nothing here allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct Phase1Params {
  const void* x;
  const void* dy;
  const void* a;
  const void* b;
  const void* mean;
  const void* inv;
  const void* gamma;
  void* dgamma;
  void* dbeta;
  void* g;
  void* c1;
  void* c2;
  void* ws;
  unsigned int* counters;
  int64_t R, C, HW, W;
  int64_t rsx, rsy;        // row strides (elements) on the vector path
  int64_t sx[4], sy[4];    // element strides in logical (N, H, W, C) order
  int64_t rows_per_split;
  int vec;                 // 1: channels-last rows, 16-byte loads
  int gamma_dtype;         // 0 bf16, 1 float32, 2 float64
};

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // rows in flight per thread in the main loop
constexpr int kFoldUnroll = 8;   // splits in flight per thread in the fold
constexpr int kMinBlocksPerSM = 2;

__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_acc(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
struct Traits;

template <>
struct Traits<__nv_bfloat16> {
  using Acc = float;
  using Raw = unsigned short;
  using Pack = uint4;
  static constexpr int kVec = 8;
  __device__ static Pack load_pack(const Raw* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void unpack(const Pack& u, float (&v)[kVec]) {
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float load(const Raw* p) {
    return __uint_as_float(static_cast<unsigned int>(__ldg(p)) << 16);
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float mul(float a, float b) { return round(__fmul_rn(a, b)); }
  __device__ static float add(float a, float b) { return round(__fadd_rn(a, b)); }
};

template <>
struct Traits<float> {
  using Acc = float;
  using Raw = float;
  using Pack = float4;
  static constexpr int kVec = 4;
  __device__ static Pack load_pack(const Raw* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void unpack(const Pack& u, float (&v)[kVec]) {
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
  __device__ static float load(const Raw* p) { return __ldg(p); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};

template <>
struct Traits<double> {
  using Acc = double;
  using Raw = double;
  using Pack = double2;
  static constexpr int kVec = 2;
  __device__ static Pack load_pack(const Raw* p) {
    return __ldg(reinterpret_cast<const double2*>(p));
  }
  __device__ static void unpack(const Pack& u, double (&v)[kVec]) {
    v[0] = u.x;
    v[1] = u.y;
  }
  __device__ static double load(const Raw* p) { return __ldg(p); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
};

// 16 bytes of the workspace, through L2 only (other blocks wrote them)
__device__ __forceinline__ void load_ws(const float* p, float (&v)[4]) {
  const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load_ws(const double* p, double (&v)[2]) {
  const double2 d = __ldcg(reinterpret_cast<const double2*>(p));
  v[0] = d.x;
  v[1] = d.y;
}

template <typename Acc>
__device__ __forceinline__ Acc load_gamma(const void* p, int64_t c, int dt) {
  if (dt == 0) {
    const unsigned short* h = static_cast<const unsigned short*>(p);
    return static_cast<Acc>(__uint_as_float(static_cast<unsigned int>(h[c]) << 16));
  }
  if (dt == 1) return static_cast<Acc>(static_cast<const float*>(p)[c]);
  return static_cast<Acc>(static_cast<const double*>(p)[c]);
}

// v in gamma's dtype, rounded as PyTorch's .to() rounds it
template <typename Acc>
__device__ __forceinline__ void store_gamma_dtype(void* p, int64_t c, int dt, Acc v) {
  if (dt == 0) {
    static_cast<__nv_bfloat16*>(p)[c] = __float2bfloat16_rn(static_cast<float>(v));
  } else if (dt == 1) {
    static_cast<float*>(p)[c] = static_cast<float>(v);
  } else {
    static_cast<double*>(p)[c] = static_cast<double>(v);
  }
}

// atomicAdd(counter, 1) with acquire-release semantics at GPU scope
__device__ __forceinline__ unsigned int count_in(unsigned int* counter) {
  unsigned int before;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(before)
               : "l"(counter)
               : "memory");
  return before;
}

template <typename T, bool RELU, typename Acc>
__device__ __forceinline__ void accumulate(Acc x, Acc dy, Acc a, Acc b, Acc mean,
                                           Acc& s1, Acc& s2) {
  Acc dz = dy;
  if constexpr (RELU) {
    const Acc z = Traits<T>::add(Traits<T>::mul(x, a), b);
    dz = z > Acc(0) ? dy : Acc(0);
  }
  s1 += dz;
  s2 = fma_acc(dz, x - mean, s2);
}

template <typename T, bool RELU>
__device__ __forceinline__ void phase1(const Phase1Params& p) {
  using Tr = Traits<T>;
  using Acc = typename Tr::Acc;
  using Raw = typename Tr::Raw;
  using Pack = typename Tr::Pack;
  constexpr int V = Tr::kVec;
  constexpr int AV = 16 / static_cast<int>(sizeof(Acc));
  constexpr int kWarps = kThreads / 32;

  // [2][kWarps * CB] per-warp sums, then [2 * CB] block sums; the last
  // block reuses it for [L][2 * CB] lane sums of the splits (L * 2 * CB =
  // kThreads * AV <= kThreads * V)
  __shared__ __align__(16) Acc red[kThreads * V];
  __shared__ __align__(16) Acc tot[2 * kThreads];
  __shared__ bool is_last;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int t = ty * TX + tx;
  const int CB = TX * V;                          // channels of the block
  const int64_t cb = static_cast<int64_t>(blockIdx.x) * CB;
  const int64_t c0 = cb + static_cast<int64_t>(tx) * V;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * p.rows_per_split;
  const int64_t r_stop = r_begin + p.rows_per_split;
  const int64_t r_end = r_stop < p.R ? r_stop : p.R;

  const Raw* x = static_cast<const Raw*>(p.x);
  const Raw* dy = static_cast<const Raw*>(p.dy);
  const Raw* av = static_cast<const Raw*>(p.a);
  const Raw* bv = static_cast<const Raw*>(p.b);
  const Acc* meanv = static_cast<const Acc*>(p.mean);

  // the fold's per-channel inputs, read now (CB <= kThreads): should this
  // block be the last, they are in registers when it needs them
  const int64_t fold_c = cb + t;
  const bool folds = t < CB && fold_c < p.C;
  Acc fold_inv = Acc(0), fold_gamma = Acc(0);
  if (folds) {
    fold_inv = static_cast<const Acc*>(p.inv)[fold_c];
    fold_gamma = load_gamma<Acc>(p.gamma, fold_c, p.gamma_dtype);
  }

  Acc a[V], b[V], mean[V], s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int64_t c = c0 + v;
    const bool in = c < p.C;
    a[v] = in ? Tr::load(av + c) : Acc(0);
    b[v] = in ? Tr::load(bv + c) : Acc(0);
    mean[v] = in ? meanv[c] : Acc(0);
    s1[v] = Acc(0);
    s2[v] = Acc(0);
  }

  if (p.vec) {
    // channels-last rows; C % V == 0, so a vector is all in or all out.
    // kUnroll rows per step, each load predicated: every step keeps
    // 2 * kUnroll loads in flight, the last one too
    if (c0 < p.C) {
      const Raw* xc = x + c0;
      const Raw* yc = dy + c0;
      for (int64_t r = r_begin + ty; r < r_end; r += kUnroll * TY) {
        Pack px[kUnroll], py[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t ru = r + u * TY;
          if (ru < r_end) {
            px[u] = Tr::load_pack(xc + ru * p.rsx);
            py[u] = Tr::load_pack(yc + ru * p.rsy);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (r + u * TY < r_end) {
            Acc xv[V], yv[V];
            Tr::unpack(px[u], xv);
            Tr::unpack(py[u], yv);
#pragma unroll
            for (int v = 0; v < V; ++v)
              accumulate<T, RELU>(xv[v], yv[v], a[v], b[v], mean[v], s1[v], s2[v]);
          }
        }
      }
    }
  } else {
    // any element strides: a dy in NCHW layout, a ragged C
    for (int64_t r = r_begin + ty; r < r_end; r += TY) {
      const int64_t n = r / p.HW;
      const int64_t hw = r - n * p.HW;
      const int64_t h = hw / p.W;
      const int64_t w = hw - h * p.W;
      const int64_t ox = n * p.sx[0] + h * p.sx[1] + w * p.sx[2];
      const int64_t oy = n * p.sy[0] + h * p.sy[1] + w * p.sy[2];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int64_t c = c0 + v;
        if (c < p.C)
          accumulate<T, RELU>(Tr::load(x + ox + c * p.sx[3]), Tr::load(dy + oy + c * p.sy[3]),
                              a[v], b[v], mean[v], s1[v], s2[v]);
      }
    }
  }

  // the block's partial sums in a fixed order: the row lanes of a warp by
  // a butterfly of shuffles, then the warps in order
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    for (int off = TX; off < 32; off <<= 1) {
      s1[v] += __shfl_xor_sync(0xffffffffu, s1[v], off);
      s2[v] += __shfl_xor_sync(0xffffffffu, s2[v], off);
    }
  }
  if (lane < TX) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red[warp * CB + tx * V + v] = s1[v];
      red[(kWarps + warp) * CB + tx * V + v] = s2[v];
    }
  }
  __syncthreads();
  Acc* ws = static_cast<Acc*>(p.ws);
  const int64_t Cp = static_cast<int64_t>(gridDim.x) * CB;   // padded C
  for (int col = t; col < 2 * CB; col += kThreads) {
    const int which = col / CB, cc = col - which * CB;
    Acc s = Acc(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(which * kWarps + w) * CB + cc];
    ws[(static_cast<int64_t>(blockIdx.y) * 2 + which) * Cp + cb + cc] = s;
  }

  // publish, then count this block in; the last one of its channel block
  // folds. Thread 0's count is acquire-release at GPU scope: it releases
  // the whole block's stores (ordered before it by the barrier) and
  // acquires the other blocks', which the barrier after it hands on.
  __syncthreads();
  if (t == 0) is_last = count_in(p.counters + blockIdx.x) == gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;

  // sum the splits: NV 16-byte columns over the 2 * CB sums, L lanes of
  // splits, each lane in split order, then the lanes in order
  const int NV = 2 * CB / AV;           // a power of two dividing kThreads
  const int L = kThreads / NV;
  const int j = t % NV, sl = t / NV;
  const int col0 = j * AV;
  const int which = col0 / CB, cc0 = col0 - which * CB;
  const Acc* src = ws + static_cast<int64_t>(which) * Cp + cb + cc0;
  const int64_t split_step = 2 * Cp;
  const int splits = static_cast<int>(gridDim.y);
  Acc acc[AV];
#pragma unroll
  for (int k = 0; k < AV; ++k) acc[k] = Acc(0);
  for (int s = sl; s < splits; s += kFoldUnroll * L) {
    Acc vs[kFoldUnroll][AV];
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u)
      if (s + u * L < splits) load_ws(src + (s + u * L) * split_step, vs[u]);
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u)
      if (s + u * L < splits)
#pragma unroll
        for (int k = 0; k < AV; ++k) acc[k] += vs[u][k];
  }
  Acc* lanes = red;
#pragma unroll
  for (int k = 0; k < AV; ++k) lanes[sl * 2 * CB + col0 + k] = acc[k];
  __syncthreads();
  for (int col = t; col < 2 * CB; col += kThreads) {
    Acc sum = Acc(0);
    for (int l = 0; l < L; ++l) sum += lanes[l * 2 * CB + col];
    tot[col] = sum;
  }
  __syncthreads();

  // the fold: what autograd returns and what phase 2 takes
  if (folds) {
    const Acc S1 = tot[t], S2 = tot[CB + t];
    const Acc rows = static_cast<Acc>(p.R);
    const Acc dgamma = fold_inv * S2;
    store_gamma_dtype(p.dgamma, fold_c, p.gamma_dtype, dgamma);
    store_gamma_dtype(p.dbeta, fold_c, p.gamma_dtype, S1);
    static_cast<Acc*>(p.g)[fold_c] = fold_gamma * fold_inv;
    static_cast<Acc*>(p.c1)[fold_c] = S1 / rows;
    static_cast<Acc*>(p.c2)[fold_c] = fold_inv * dgamma / rows;
  }
  if (t == 0) p.counters[blockIdx.x] = 0u;
}

}  // namespace

// One kernel per input type and ReLU flag, named so that launch counts and
// profiles tell the 33 masked BN layers from the 20 unmasked ones.
#define DL4J_PHASE1_KERNELS(T, tag)                                                  \
  extern "C" __global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)           \
      bn_relu_bwd_phase1_##tag(Phase1Params p) {                                     \
    phase1<T, true>(p);                                                              \
  }                                                                                  \
  extern "C" __global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)           \
      bn_bwd_phase1_##tag(Phase1Params p) {                                          \
    phase1<T, false>(p);                                                             \
  }

DL4J_PHASE1_KERNELS(__nv_bfloat16, bf16)
DL4J_PHASE1_KERNELS(float, f32)
DL4J_PHASE1_KERNELS(double, f64)

namespace {

int launch_phase1(bool relu, const void* x, const void* dy, const void* a, const void* b,
                  const void* mean, const void* inv, const void* gamma, void* dgamma,
                  void* dbeta, void* g, void* c1, void* c2, void* ws, void* counters,
                  int64_t R, int64_t C, int64_t HW, int64_t W, int64_t rsx, int64_t rsy,
                  int64_t sxn, int64_t sxh, int64_t sxw, int64_t sxc, int64_t syn,
                  int64_t syh, int64_t syw, int64_t syc, int64_t rows_per_split,
                  int dtype, int gamma_dtype, int vec, int tx, int n_cblk, int splits,
                  void* stream) {
  static void (*const kernels[2][3])(Phase1Params) = {
      {bn_bwd_phase1_bf16, bn_bwd_phase1_f32, bn_bwd_phase1_f64},
      {bn_relu_bwd_phase1_bf16, bn_relu_bwd_phase1_f32, bn_relu_bwd_phase1_f64}};
  if (dtype < 0 || dtype > 2 || gamma_dtype < 0 || gamma_dtype > 2 || tx < 1 ||
      tx > 32 || (tx & (tx - 1)) != 0 || n_cblk < 1 || splits < 1 || splits > 65535 ||
      R < 1 || C < 1 || HW < 1 || W < 1 || rows_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Phase1Params p;
  p.x = x;
  p.dy = dy;
  p.a = a;
  p.b = b;
  p.mean = mean;
  p.inv = inv;
  p.gamma = gamma;
  p.dgamma = dgamma;
  p.dbeta = dbeta;
  p.g = g;
  p.c1 = c1;
  p.c2 = c2;
  p.ws = ws;
  p.counters = static_cast<unsigned int*>(counters);
  p.R = R;
  p.C = C;
  p.HW = HW;
  p.W = W;
  p.rsx = rsx;
  p.rsy = rsy;
  p.sx[0] = sxn;
  p.sx[1] = sxh;
  p.sx[2] = sxw;
  p.sx[3] = sxc;
  p.sy[0] = syn;
  p.sy[1] = syh;
  p.sy[2] = syw;
  p.sy[3] = syc;
  p.rows_per_split = rows_per_split;
  p.vec = vec;
  p.gamma_dtype = gamma_dtype;
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(kernels[relu ? 1 : 0][dtype]),
      dim3(static_cast<unsigned int>(n_cblk), static_cast<unsigned int>(splits)),
      dim3(static_cast<unsigned int>(tx), static_cast<unsigned int>(kThreads / tx)), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entry points (bound with ctypes in kernels/bn_relu.py). dtype and
// gamma_dtype: 0 bf16, 1 float32, 2 float64. Returns the launch's
// cudaError_t: 0 when the kernel was queued on `stream`.
#define DL4J_PHASE1_ENTRY(name, relu)                                                 \
  extern "C" int name(                                                                \
      const void* x, const void* dy, const void* a, const void* b, const void* mean,  \
      const void* inv, const void* gamma, void* dgamma, void* dbeta, void* g,         \
      void* c1, void* c2, void* ws, void* counters, int64_t R, int64_t C, int64_t HW, \
      int64_t W, int64_t rsx, int64_t rsy, int64_t sxn, int64_t sxh, int64_t sxw,     \
      int64_t sxc, int64_t syn, int64_t syh, int64_t syw, int64_t syc,                \
      int64_t rows_per_split, int dtype, int gamma_dtype, int vec, int tx,            \
      int n_cblk, int splits, void* stream) {                                         \
    return launch_phase1(relu, x, dy, a, b, mean, inv, gamma, dgamma, dbeta, g, c1,   \
                         c2, ws, counters, R, C, HW, W, rsx, rsy, sxn, sxh, sxw, sxc, \
                         syn, syh, syw, syc, rows_per_split, dtype, gamma_dtype, vec, \
                         tx, n_cblk, splits, stream);                                 \
  }

DL4J_PHASE1_ENTRY(dl4j_bn_relu_bwd_phase1, true)
DL4J_PHASE1_ENTRY(dl4j_bn_bwd_phase1, false)
