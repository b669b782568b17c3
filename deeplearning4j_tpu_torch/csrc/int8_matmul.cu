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
// device memory as int8 and widened in registers: no float32 copy of the
// weight is ever written. The scale of layout 0 is applied to the sum in
// the epilogue.
//
// What bounds it on an H100: at decode (M = 8 lanes, 64 at a verify of 8
// lanes x a window of 8) the weight's bytes (K N of them) against 3.35
// TB/s; at a prefill's M, the 2 M N K float32 operations against the FMA
// rate (67 TFLOP/s). int8 values are exact in TF32 and bf16, so a tensor-
// core version would only have to split x; this first version is a plain
// FMA kernel.
//
// Design: one cluster of kRanks = 8 blocks of 256 threads takes a tile of
// kBM rows x kBN columns of y; rank j takes the j-th eighth of the K axis
// (in tiles of kBK), so a cluster reads its columns' weight once, and even
// N = 1536 gives 24 x 8 blocks a row tile. A block keeps its tile of x and
// of the widened weight in shared memory, the next tile's loads in
// registers while it multiplies the current one; a thread holds 2 x 4
// sums. The ranks' partial sums are added in rank order over distributed
// shared memory, each rank combining an eighth of the tile. The order of
// every sum is set by K alone: a row's result does not depend on M or on
// the other rows (a verify row equals the decode row bit for bit), and two
// calls give the same bits. Every product and sum is an explicitly rounded
// intrinsic, so no contraction the compiler chooses can change the bits.
// No atomics, no workspace, no allocation, one launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace i8mm {

namespace cg = cooperative_groups;

constexpr int kBM = 32;        // rows of y a tile
constexpr int kBN = 64;        // columns of y a tile
constexpr int kBK = 32;        // depth of one step of the K loop
constexpr int kRanks = 8;      // blocks a cluster: the K axis cut in eighths
constexpr int kThreads = 256;  // 16 x 16 threads, 2 rows x 4 columns each
constexpr int kXPad = 2;       // x tile [kBK][kBM + kXPad]: float2 reads
constexpr int kWPad = 4;       // w tile [kBK][kBN + kWPad]: float4 reads

struct Args {
  const float* x;
  const int8_t* w;
  const float* s;
  float* y;
  int M, N, K;
  int64_t sxm;
  int vec_x;  // x rows on 16 bytes and K % 4 == 0: float4 loads
  int vec_w;  // w on 8 bytes and its row length % 8 == 0: 8-byte loads
};

// The K tiles of rank `rank`: [t0, t1), set by K alone.
__device__ __forceinline__ void rank_tiles(int K, int rank, int& t0, int& t1) {
  const int kt = (K + kBK - 1) / kBK;
  const int per = (kt + kRanks - 1) / kRanks;
  t0 = min(rank * per, kt);
  t1 = min(t0 + per, kt);
}

template <int LAYOUT>
struct Loader {
  // this thread's share of one K tile: 4 values of x and 8 of the payload
  float xv[4];
  int8_t wv[8];

  __device__ __forceinline__ void load(const Args& a, int m0, int n0, int k0, int tid) {
    // x: row xr, columns xc .. xc + 3 of the tile
    const int xr = tid / 8, xc = (tid % 8) * 4;
    const int m = m0 + xr, k = k0 + xc;
    if (m < a.M && a.vec_x && k + 3 < a.K) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(a.x + m * a.sxm + k));
      xv[0] = v.x;
      xv[1] = v.y;
      xv[2] = v.z;
      xv[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xv[e] = (m < a.M && k + e < a.K) ? __ldg(a.x + m * a.sxm + k + e) : 0.f;
    }
    if (LAYOUT == 1) {
      // the JAX order: x * s[k], rounded, before the product
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k + e < a.K) xv[e] = __fmul_rn(xv[e], __ldg(a.s + k + e));
    }
    // the payload: 8 bytes along the weight's contiguous axis
    if (LAYOUT == 0) {  // w [K, N]: row k0 + wr, columns wc .. wc + 7
      const int wr = tid / 8, wc = (tid % 8) * 8;
      const int kk = k0 + wr, n = n0 + wc;
      if (kk < a.K && a.vec_w && n + 7 < a.N) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(a.w + (int64_t)kk * a.N + n));
        const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e) wv[e] = b[e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wv[e] = (kk < a.K && n + e < a.N) ? a.w[(int64_t)kk * a.N + n + e] : int8_t(0);
      }
    } else {  // w [N, K]: column n0 + wc of y, depths wr .. wr + 7
      const int wc = tid / 4, wr = (tid % 4) * 8;
      const int n = n0 + wc, kk = k0 + wr;
      if (n < a.N && a.vec_w && kk + 7 < a.K) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(a.w + (int64_t)n * a.K + kk));
        const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int e = 0; e < 8; ++e) wv[e] = b[e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wv[e] = (n < a.N && kk + e < a.K) ? a.w[(int64_t)n * a.K + kk + e] : int8_t(0);
      }
    }
  }

  __device__ __forceinline__ void store(float (*xs)[kBM + kXPad], float (*ws)[kBN + kWPad],
                                        int tid) const {
    const int xr = tid / 8, xc = (tid % 8) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) xs[xc + e][xr] = xv[e];
    if (LAYOUT == 0) {
      const int wr = tid / 8, wc = (tid % 8) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) ws[wr][wc + e] = static_cast<float>(wv[e]);
    } else {
      const int wc = tid / 4, wr = (tid % 4) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) ws[wr + e][wc] = static_cast<float>(wv[e]);
    }
  }
};

template <int LAYOUT>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads)
    int8_matmul_kernel(const Args a) {
  __shared__ __align__(16) float xs[kBK][kBM + kXPad];
  __shared__ __align__(16) float ws[kBK][kBN + kWPad];
  __shared__ __align__(16) float part[kBM * kBN];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = static_cast<int>(blockIdx.x / kRanks) * kBN;
  const int m0 = static_cast<int>(blockIdx.y) * kBM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;     // columns 4 tx .., rows 2 ty ..

  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  int t0, t1;
  rank_tiles(a.K, rank, t0, t1);
  Loader<LAYOUT> ld;
  if (t0 < t1) ld.load(a, m0, n0, t0 * kBK, tid);
  for (int t = t0; t < t1; ++t) {
    __syncthreads();                          // the last tile's reads are done
    ld.store(xs, ws, tid);
    __syncthreads();
    if (t + 1 < t1) ld.load(a, m0, n0, (t + 1) * kBK, tid);   // in flight
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {           // k in order: the sum's order
      const float2 xa = *reinterpret_cast<const float2*>(&xs[k][2 * ty]);
      const float4 wb = *reinterpret_cast<const float4*>(&ws[k][4 * tx]);
      const float xr[2] = {xa.x, xa.y};
      const float wr[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(xr[i], wr[j], acc[i][j]);
    }
  }

  // this rank's partial, then the cluster's eight added in rank order
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[(2 * ty + i) * kBN + 4 * tx + j] = acc[i][j];
  cluster.sync();
  constexpr int kShare = kBM * kBN / kRanks;  // elements this rank combines
  for (int e = tid; e < kShare; e += kThreads) {
    const int idx = rank * kShare + e;
    const int m = m0 + idx / kBN, n = n0 + idx % kBN;
    float sum = *cluster.map_shared_rank(&part[idx], 0);
#pragma unroll
    for (int r = 1; r < kRanks; ++r) sum = __fadd_rn(sum, *cluster.map_shared_rank(&part[idx], r));
    if (m < a.M && n < a.N) {
      if (LAYOUT == 0) sum = __fmul_rn(sum, __ldg(a.s + n));
      a.y[static_cast<int64_t>(m) * a.N + n] = sum;
    }
  }
  cluster.sync();                             // no rank leaves while read
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

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
      (M + i8mm::kBM - 1) / i8mm::kBM > 65535 || (layout != 0 && layout != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  i8mm::Args a{static_cast<const float*>(x),
               static_cast<const int8_t*>(w),
               static_cast<const float*>(scale),
               static_cast<float*>(y),
               static_cast<int>(M),
               static_cast<int>(N),
               static_cast<int>(K),
               sxm,
               i8mm::aligned(x, 16) && sxm % 4 == 0 && K % 4 == 0,
               i8mm::aligned(w, 8) && (layout == 0 ? N : K) % 8 == 0};
  const dim3 grid(static_cast<unsigned>((N + i8mm::kBN - 1) / i8mm::kBN * i8mm::kRanks),
                  static_cast<unsigned>((M + i8mm::kBM - 1) / i8mm::kBM));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == 0)
    i8mm::int8_matmul_kernel<0><<<grid, i8mm::kThreads, 0, st>>>(a);
  else
    i8mm::int8_matmul_kernel<1><<<grid, i8mm::kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
