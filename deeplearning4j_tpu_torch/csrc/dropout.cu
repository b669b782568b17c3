// Inverted dropout with a counter-based generator drawn inside the kernel.
//
// Replaces no TPU kernel: the JAX package's ``dropout`` op
// (deeplearning4j_tpu/ops/random.py:104-114) draws its mask with
// ``jax.random.bernoulli`` under XLA, keyed by ``fold_in(fold_in(base_key,
// iteration), node)`` on the device (autodiff/samediff.py:490, :826-829).
// The port needs the same property on the card: a captured CUDA graph
// replays its launches with the arguments it recorded, so the draw must
// read the step's iteration from device memory, not take it as a host
// argument, or every replay would drop the same units.
//
// What it computes, for n elements of x in its dtype (bf16, float32 or
// float64):
//
//   y[i] = keep(i) ? x[i] / p : 0,    keep(i) = (r(i) >> 8) < threshold
//
// where r(i) is word i % 4 of Philox4x32-10 (Salmon et al., SC'11; the
// generator of cuRAND and PyTorch) at
//
//   counter = (g_lo, g_hi, iteration_lo, iteration_hi),  g = i / 4,
//   key     = (seed_lo, seed_hi ^ node),
//
// ``seed`` and ``iteration`` read from device memory (int64 each), and
// ``threshold = ceil(p * 2^24)``: keep is ``u < p`` with u the top 24 bits
// of the word over 2^24, computed in integers so that the plain version
// (kernels/dropout.py ``dropout_plain``) gives the same mask bit for bit.
// The division is a division (IEEE round to nearest), in float for bf16
// and float32 and in double for float64, as the JAX op's ``x / p`` rounds;
// a multiplication by 1/p would round differently for p = 0.8. The
// backward is the same function of dy (dx = keep ? dy / p : 0): the mask
// is drawn again from the same key and counter, and no mask is stored.
//
// What bounds it on the card: bytes. Each element is read once and written
// once (8 bytes an element in float32); the ten Philox rounds are 20 32-bit
// multiplies for four elements, far below the card's integer rate. The
// design: one thread draws once for 4 consecutive elements and moves them
// with 16-byte loads and stores where x and y are 16-byte aligned (two for
// float64, one 8-byte pair for bf16), elementwise otherwise and for the
// ragged last group; a grid-stride loop over the groups. Sums are none, so
// the result does not depend on the launch's shape.
//
// The noise draws of the other random ops share the generator and its keying
// (``dl4j_noise``; kernels/dropout.py ``noise_plain`` is their plain
// version):
//
//   gaussian_noise    y = x + s n(i)                (backward: dy, no draw)
//   gaussian_dropout  y = x (1 + s n(i))            (backward: dy (1 + s n(i)))
//   alpha_dropout     y = a (keep(i) ? x : alpha') + b   (backward: keep(i) ? a dy : 0)
//   spatial_dropout   y = keep(m) ? x / p : 0, m = batch * C + channel, one
//                     draw a (batch, channel), broadcast over the rest
//
// n(i) is a standard normal by Box-Muller from the group's four words:
// words 0 and 1 give elements 4g and 4g + 1 (rho cos, rho sin), words 2 and 3
// elements 4g + 2 and 4g + 3, with rho = sqrt(-2 log u1), u1 = ((w >> 8) + 1)
// / 2^24 in (0, 1] and the angle 2 pi u2, u2 = (w' >> 8) / 2^24; rho and
// the angle's sine and cosine are computed once a pair. For bf16 and
// float32 outputs in float: u1, u2 and 2 u2 are exact, logf and
// sincospif(2 u2) (the sine and cosine of pi times an exact argument, so
// the angle itself is not rounded) are CUDA's precise functions, each
// within 1 ulp, sqrtf is correctly rounded; for float64 outputs in double
// (log, sqrt, and sin and cos of the rounded angle 2 pi u2). Each product
// and sum is rounded on its own (no contraction into an FMA), as the plain
// version's separate tensor ops round. kernels/dropout.py
// `normals_plain` computes the float normals with torch's float32 log and
// sqrt and the float64 sine and cosine of 2 pi u2 rounded once; a normal
// of this kernel and of the plain version differ by at most 2^-20 of its
// magnitude (8 float32 ulp of 1: each log within 1 ulp, sincospif within
// 1, the float64 values rounded within half, and the roundings of sqrt
// and of the product). Each backward draws again from the same key and
// counter; nothing is stored.
//
// What bounds the noise draws: bytes, as the dropout's; a group of four
// elements moves as one 16-byte load and store where x and y are 16-byte
// aligned (two for float64, one 8-byte pair for bf16), and its two pairs
// of normals cost two logf, two sqrtf and two sincospif.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kW0;
    k.y += kW1;
  }
  return c;
}

// The element type's arithmetic: load to the compute type, divide, store.
template <typename T> struct Elem;
template <> struct Elem<float> {
  using C = float;
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float div(float a, float p) {
    return __fdiv_rn(a, p);
  }
};
template <> struct Elem<double> {
  using C = double;
  static __device__ __forceinline__ double load(double v) { return v; }
  static __device__ __forceinline__ double store(double v) { return v; }
  static __device__ __forceinline__ double div(double a, double p) {
    return __ddiv_rn(a, p);
  }
};
template <> struct Elem<__nv_bfloat16> {
  using C = float;
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float div(float a, float p) {
    return __fdiv_rn(a, p);
  }
};

template <typename T>
__device__ __forceinline__ T drop(T v, bool keep, typename Elem<T>::C p) {
  return keep ? Elem<T>::store(Elem<T>::div(Elem<T>::load(v), p))
              : Elem<T>::store(0);
}

// Four consecutive elements as one 16-byte (bf16: 8-byte) move.
template <typename T> struct Quad;
template <> struct Quad<float> {
  static __device__ __forceinline__ void move(const float* x, float* y,
                                              const bool* k, float p) {
    const float4 v = *reinterpret_cast<const float4*>(x);
    *reinterpret_cast<float4*>(y) = make_float4(
        drop(v.x, k[0], p), drop(v.y, k[1], p), drop(v.z, k[2], p),
        drop(v.w, k[3], p));
  }
};
template <> struct Quad<double> {
  static __device__ __forceinline__ void move(const double* x, double* y,
                                              const bool* k, double p) {
    const double2 a = *reinterpret_cast<const double2*>(x);
    const double2 b = *reinterpret_cast<const double2*>(x + 2);
    *reinterpret_cast<double2*>(y) =
        make_double2(drop(a.x, k[0], p), drop(a.y, k[1], p));
    *reinterpret_cast<double2*>(y + 2) =
        make_double2(drop(b.x, k[2], p), drop(b.y, k[3], p));
  }
};
template <> struct Quad<__nv_bfloat16> {
  static __device__ __forceinline__ void move(const __nv_bfloat16* x,
                                              __nv_bfloat16* y,
                                              const bool* k, float p) {
    union U { uint2 u; __nv_bfloat16 h[4]; };
    U in, out;
    in.u = *reinterpret_cast<const uint2*>(x);
#pragma unroll
    for (int j = 0; j < 4; ++j) out.h[j] = drop(in.h[j], k[j], p);
    *reinterpret_cast<uint2*>(y) = out.u;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t n,
               const int64_t* __restrict__ seed,
               const int64_t* __restrict__ iteration, uint32_t node,
               uint32_t threshold, typename Elem<T>::C p, bool aligned) {
  const uint64_t s = static_cast<uint64_t>(*seed);
  const uint64_t it = static_cast<uint64_t>(*iteration);
  const uint2 key = make_uint2(static_cast<uint32_t>(s),
                               static_cast<uint32_t>(s >> 32) ^ node);
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       g < groups; g += stride) {
    const uint64_t gu = static_cast<uint64_t>(g);
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<uint32_t>(gu), static_cast<uint32_t>(gu >> 32),
                   static_cast<uint32_t>(it), static_cast<uint32_t>(it >> 32)),
        key);
    const bool keep[4] = {(r.x >> 8) < threshold, (r.y >> 8) < threshold,
                          (r.z >> 8) < threshold, (r.w >> 8) < threshold};
    const int64_t i = 4 * g;
    if (aligned && i + 4 <= n) {
      Quad<T>::move(x + i, y + i, keep, p);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < n) y[i + j] = drop(x[i + j], keep[j], p);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int64_t n, const void* seed,
                   const void* iteration, uint32_t node, uint32_t threshold,
                   double p, cudaStream_t stream) {
  const int64_t groups = (n + 3) / 4;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > (1 << 16)) blocks = 1 << 16;   // the loop covers the rest
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  dropout_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n,
      static_cast<const int64_t*>(seed), static_cast<const int64_t*>(iteration),
      node, threshold, static_cast<typename Elem<T>::C>(p), aligned);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the other noise draws
enum Noise { kGaussNoise = 0, kGaussDropout = 1, kAlphaFwd = 2, kAlphaBwd = 3, kSpatial = 4 };

__device__ __forceinline__ uint4 draw(uint64_t g, uint64_t it, uint2 key) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32),
                                  static_cast<uint32_t>(it), static_cast<uint32_t>(it >> 32)),
                       key);
}

// The group's four normals in the compute type: pair k (words 2k, 2k + 1)
// gives elements 2k, 2k + 1 as rho cos, rho sin, rho and the angle once a
// pair (the header has the functions and their bounds).
__device__ __forceinline__ void normals(const uint4& r, float (&out)[4]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float u1 = __fmul_rn(static_cast<float>((w[2 * k] >> 8) + 1u), 5.9604644775390625e-08f);
    const float u2 = __fmul_rn(static_cast<float>(w[2 * k + 1] >> 8), 5.9604644775390625e-08f);
    const float rho = sqrtf(__fmul_rn(-2.0f, logf(u1)));
    float sn, cs;
    sincospif(__fmul_rn(2.0f, u2), &sn, &cs);
    out[2 * k] = __fmul_rn(rho, cs);
    out[2 * k + 1] = __fmul_rn(rho, sn);
  }
}
__device__ __forceinline__ void normals(const uint4& r, double (&out)[4]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const double u1 = static_cast<double>((w[2 * k] >> 8) + 1u) * 5.9604644775390625e-08;
    const double u2 = static_cast<double>(w[2 * k + 1] >> 8) * 5.9604644775390625e-08;
    const double rho = sqrt(-2.0 * log(u1));
    const double ang = 6.283185307179586 * u2;
    out[2 * k] = __dmul_rn(rho, cos(ang));
    out[2 * k + 1] = __dmul_rn(rho, sin(ang));
  }
}

// Four consecutive elements in the compute type, one 16-byte (bf16:
// 8-byte) load or store.
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  static __device__ __forceinline__ void load(const float* x, float (&v)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(x);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* y, const float (&v)[4]) {
    *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec4<double> {
  static __device__ __forceinline__ void load(const double* x, double (&v)[4]) {
    const double2 a = *reinterpret_cast<const double2*>(x);
    const double2 b = *reinterpret_cast<const double2*>(x + 2);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
  static __device__ __forceinline__ void store(double* y, const double (&v)[4]) {
    *reinterpret_cast<double2*>(y) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(y + 2) = make_double2(v[2], v[3]);
  }
};
template <> struct Vec4<__nv_bfloat16> {
  union U { uint2 u; __nv_bfloat16 h[4]; };
  static __device__ __forceinline__ void load(const __nv_bfloat16* x, float (&v)[4]) {
    U in;
    in.u = *reinterpret_cast<const uint2*>(x);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(in.h[j]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* y, const float (&v)[4]) {
    U out;
#pragma unroll
    for (int j = 0; j < 4; ++j) out.h[j] = __float2bfloat16_rn(v[j]);
    *reinterpret_cast<uint2*>(y) = out.u;
  }
};

__device__ __forceinline__ float mul_(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
noise_kernel(int kind, const T* __restrict__ x, T* __restrict__ y, int64_t n,
             const int64_t* __restrict__ seed, const int64_t* __restrict__ iteration,
             uint32_t node, uint32_t threshold, double p0, double p1, double p2,
             int64_t per_batch, int64_t channels, int64_t inner, bool aligned) {
  using C = typename Elem<T>::C;
  const uint64_t s = static_cast<uint64_t>(*seed);
  const uint64_t it = static_cast<uint64_t>(*iteration);
  const uint2 key = make_uint2(static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32) ^ node);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kind == kSpatial) {
    const C p = static_cast<C>(p0);
    for (int64_t i = start; i < n; i += stride) {
      const int64_t m = (i / per_batch) * channels + (i / inner) % channels;
      const uint4 r = draw(static_cast<uint64_t>(m / 4), it, key);
      const int j = static_cast<int>(m % 4);
      const uint32_t w = j == 0 ? r.x : (j == 1 ? r.y : (j == 2 ? r.z : r.w));
      y[i] = drop(x[i], (w >> 8) < threshold, p);
    }
    return;
  }
  const C c0 = static_cast<C>(p0), c1 = static_cast<C>(p1), c2 = static_cast<C>(p2);
  const int64_t groups = (n + 3) / 4;
  for (int64_t g = start; g < groups; g += stride) {
    const uint4 r = draw(static_cast<uint64_t>(g), it, key);
    const int64_t i = 4 * g;
    const bool full = aligned && i + 4 <= n;
    C v[4], out[4];
    if (full) {
      Vec4<T>::load(x + i, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = i + j < n ? Elem<T>::load(x[i + j]) : C(0);
    }
    if (kind == kGaussNoise || kind == kGaussDropout) {
      C nrm[4];
      normals(r, nrm);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[j] = kind == kGaussNoise ? add_(v[j], mul_(c0, nrm[j]))
                                     : mul_(v[j], add_(C(1), mul_(c0, nrm[j])));
    } else {
      const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep = (words[j] >> 8) < threshold;
        if (kind == kAlphaFwd) out[j] = add_(mul_(c0, keep ? v[j] : c2), c1);
        else out[j] = keep ? mul_(c0, v[j]) : C(0);
      }
    }
    if (full) {
      Vec4<T>::store(y + i, out);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < n) y[i + j] = Elem<T>::store(out[j]);
    }
  }
}

template <typename T>
cudaError_t launch_noise(int kind, const void* x, void* y, int64_t n, const void* seed,
                         const void* iteration, uint32_t node, uint32_t threshold, double p0,
                         double p1, double p2, int64_t per_batch, int64_t channels, int64_t inner,
                         cudaStream_t stream) {
  const int64_t items = kind == kSpatial ? n : (n + 3) / 4;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > (1 << 16)) blocks = 1 << 16;   // the loop covers the rest
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  noise_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      kind, static_cast<const T*>(x), static_cast<T*>(y), n, static_cast<const int64_t*>(seed),
      static_cast<const int64_t*>(iteration), node, threshold, p0, p1, p2, per_batch, channels,
      inner, aligned);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 bf16, 1 float32, 2 float64. ``seed`` and ``iteration`` point to
// one int64 each on the device; ``threshold`` is ceil(p * 2^24).
extern "C" int dl4j_dropout(const void* x, void* y, int64_t n,
                            const void* seed, const void* iteration,
                            int64_t node, int64_t threshold, double p,
                            int dtype, void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const uint32_t nd = static_cast<uint32_t>(node);
  const uint32_t t = static_cast<uint32_t>(threshold);
  switch (dtype) {
    case 0: return launch<__nv_bfloat16>(x, y, n, seed, iteration, nd, t, p, s);
    case 1: return launch<float>(x, y, n, seed, iteration, nd, t, p, s);
    case 2: return launch<double>(x, y, n, seed, iteration, nd, t, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// kind: 0 gaussian noise (p0 = s), 1 gaussian dropout (p0 = s), 2 alpha
// dropout (p0 = a, p1 = b, p2 = alpha'), 3 its backward (p0 = a), 4 spatial
// dropout (p0 = p; element i's draw is m = (i / per_batch) * channels + (i /
// inner) % channels); ``threshold`` is ceil(p * 2^24) for the Bernoulli
// kinds. dtype as dl4j_dropout's.
extern "C" int dl4j_noise(int kind, const void* x, void* y, int64_t n, const void* seed,
                          const void* iteration, int64_t node, int64_t threshold, double p0,
                          double p1, double p2, int64_t per_batch, int64_t channels, int64_t inner,
                          int dtype, void* stream) {
  if (n <= 0) return 0;
  if (kind < 0 || kind > 4 || (kind == 4 && (per_batch < 1 || channels < 1 || inner < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const uint32_t nd = static_cast<uint32_t>(node);
  const uint32_t t = static_cast<uint32_t>(threshold);
  switch (dtype) {
    case 0: return launch_noise<__nv_bfloat16>(kind, x, y, n, seed, iteration, nd, t, p0, p1, p2,
                                               per_batch, channels, inner, s);
    case 1: return launch_noise<float>(kind, x, y, n, seed, iteration, nd, t, p0, p1, p2, per_batch,
                                       channels, inner, s);
    case 2: return launch_noise<double>(kind, x, y, n, seed, iteration, nd, t, p0, p1, p2, per_batch,
                                        channels, inner, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
