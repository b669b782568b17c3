// Attention of query rows over a KV cache held in blocks that a table
// addresses: the decode and cached prefill attention of the generative
// serving tier.
//
// Replaces the JAX package's paged decode attention
// (deeplearning4j_tpu/zoo/gpt.py gpt_paged_decode_fns: decode_fn :649,
// gather :675-680, mask and softmax :681-685, masked V rows zeroed
// :686-688), its paged prefill's attention over the table (:586, :621-636)
// and the dense decode's attention over its slot rows (gpt_decode_fns
// decode_fn :354, :383-394). There each is a gather of the lane's whole
// table into a [T, D] context per layer, scores over all T keys, a mask to
// the lane's position and a where() that zeroes masked V rows so a stale
// or NaN block cannot leak. XLA fused it on the TPU; no Pallas kernel
// stands behind it.
//
// What it computes, for query row r of lane s = lane[r], head a, last key
// kmax[r]:
//   out[r, a] = sum_{t <= kmax[r]} softmax_t(scale * q[r, a] . K[t]) V[t]
//   K[t] = kc[tables[s, t / BS], a, t % BS], and likewise V.
// It reads only keys t <= kmax[r], so it never loads a block past a row's
// last key: stale and null blocks (even NaN) cannot reach a sum. The dense
// slab [S, A, max_seq, D] is a paged slab with BS = max_seq and
// tables[s] = [s].
//
// What bounds it on an H100: at decode a row reads (kmax + 1) K and V rows
// of D values once and does 4 D FLOP per key, so it is bound by bytes
// (8 lanes x 12 heads x ~300 keys x 128 x 4 B x 2 = 29 MB a layer, ~9 us at
// 3.35 TB/s). At prefill the rows of one lane share their keys, and the
// float32 products (not the tensor cores) bound it.
//
// Design (a simple one; its times are in PERF.md): one block of 256
// threads per (row, head). Eight lanes share one key: each holds D / 8
// elements of q, K, V and of the output sum, at d = e * 8 + lane % 8, so
// the eight lanes read 32 contiguous bytes of a row per load. A warp holds
// four such groups, a block 32: stream sid = warp * 4 + group takes keys
// t = sid, sid + 32, ... with an online softmax (running maximum, sum and
// weighted V in registers). Which stream takes key t, and the order of
// every sum, depend on t alone, never on BS or the table: paged and dense
// decode of one context give the same bits, and two calls give the same
// bits (no atomics). At the end the 32 streams are combined in shared
// memory, in stream order. Scores and softmax are in the input's type:
// float32, or float64 for float64 input.
//
// At decode (8 lanes x 12 heads) the grid is 96 blocks on 132 SMs, and a
// block's 32 streams each walk their keys one after another: splitting the
// key range over blocks (flash-decoding) is later work, and so is fusing
// the K/V write of the step into this kernel (it is a PyTorch indexing op
// before the launch).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kGroup = 8;                       // lanes that share a key
constexpr int kGroupsPerWarp = 32 / kGroup;     // 4
constexpr int kStreams = kWarps * kGroupsPerWarp;   // 32
constexpr int kThreads = kWarps * 32;           // 256

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                       const T* __restrict__ vc,
                       const int* __restrict__ tables,
                       const int* __restrict__ lane,
                       const int* __restrict__ kmax, T* __restrict__ out,
                       int A, int BS, int MAXB, int64_t sqn, int64_t sqa,
                       int64_t skb, int64_t ska, int64_t skt, int64_t svb,
                       int64_t sva, int64_t svt, T scale) {
  constexpr int E = D / kGroup;                 // elements per lane
  __shared__ T sm_m[kStreams];
  __shared__ T sm_l[kStreams];
  __shared__ T sm_acc[kStreams][D];

  const int row = blockIdx.x / A;
  const int head = blockIdx.x - row * A;
  const int warp = threadIdx.x / 32;
  const int grp = (threadIdx.x % 32) / kGroup;
  const int gl = threadIdx.x % kGroup;
  const int sid = warp * kGroupsPerWarp + grp;
  // a key past the table's reach is not there (the plain version's mask
  // over T = MAXB * BS keys says the same)
  const int last = min(kmax[row], MAXB * BS - 1);
  const int* tab = tables + (int64_t)lane[row] * MAXB;
  const T* kh = kc + (int64_t)head * ska;
  const T* vh = vc + (int64_t)head * sva;

  T qr[E], acc[E];
  const T* qp = q + (int64_t)row * sqn + (int64_t)head * sqa;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qr[e] = qp[e * kGroup + gl];
    acc[e] = T(0);
  }
  T m = -INFINITY, l = T(0);

  // the loop bound is the warp's first key, so a warp's lanes run the
  // same iterations and the shuffles below see all 32 of them
  for (int t0 = warp * kGroupsPerWarp; t0 <= last; t0 += kStreams) {
    const int t = t0 + grp;
    const bool valid = t <= last;
    T kr[E], vr[E];
    if (valid) {
      const int u = t / BS;
      const int64_t blk = tab[u];
      const int off = t - u * BS;
      const T* kp = kh + blk * skb + (int64_t)off * skt;
      const T* vp = vh + blk * svb + (int64_t)off * svt;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[e] = kp[e * kGroup + gl];
        vr[e] = vp[e * kGroup + gl];
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) kr[e] = vr[e] = T(0);
    }
    T s = T(0);
#pragma unroll
    for (int e = 0; e < E; ++e) s += qr[e] * kr[e];
    // a butterfly within the group: every lane ends with the same bits
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (valid) {
      s *= scale;
      const T mn = s > m ? s : m;
      const T corr = exp_(m - mn);              // 0 on the stream's first key
      const T p = exp_(s - mn);
      l = l * corr + p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = acc[e] * corr + p * vr[e];
      m = mn;
    }
  }

  if (gl == 0) {
    sm_m[sid] = m;
    sm_l[sid] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[sid][e * kGroup + gl] = acc[e];
  __syncthreads();

  const int d = threadIdx.x;
  if (d < D) {
    T* op = out + ((int64_t)row * A + head) * D + d;
    if (last < 0) {                             // no key: the JAX mask's 0
      *op = T(0);
      return;
    }
    T mx = sm_m[0];
    for (int i = 1; i < kStreams; ++i) mx = sm_m[i] > mx ? sm_m[i] : mx;
    T lsum = T(0), o = T(0);
    for (int i = 0; i < kStreams; ++i) {
      const T w = exp_(sm_m[i] - mx);          // 0 for a stream with no key
      lsum += sm_l[i] * w;
      o += sm_acc[i][d] * w;
    }
    *op = o / lsum;
  }
}

template <typename T, int D>
void launch(const void* q, const void* kc, const void* vc, const void* tables,
            const void* lane, const void* kmax, void* out, int64_t N,
            int64_t A, int64_t BS, int64_t MAXB, int64_t sqn, int64_t sqa,
            int64_t skb, int64_t ska, int64_t skt, int64_t svb, int64_t sva,
            int64_t svt, double scale, cudaStream_t stream) {
  paged_attention_kernel<T, D><<<(unsigned)(N * A), kThreads, 0, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (const int*)tables,
      (const int*)lane, (const int*)kmax, (T*)out, (int)A, (int)BS,
      (int)MAXB, sqn, sqa, skb, ska, skt, svb, sva, svt, (T)scale);
}

template <typename T>
int launch_d(int64_t D, const void* q, const void* kc, const void* vc,
             const void* tables, const void* lane, const void* kmax,
             void* out, int64_t N, int64_t A, int64_t BS, int64_t MAXB,
             int64_t sqn, int64_t sqa, int64_t skb, int64_t ska, int64_t skt,
             int64_t svb, int64_t sva, int64_t svt, double scale,
             cudaStream_t st) {
#define DL4J_PAGED(DD)                                                       \
  launch<T, DD>(q, kc, vc, tables, lane, kmax, out, N, A, BS, MAXB, sqn,     \
                sqa, skb, ska, skt, svb, sva, svt, scale, st)
  switch (D) {
    case 16: DL4J_PAGED(16); break;
    case 32: DL4J_PAGED(32); break;
    case 64: DL4J_PAGED(64); break;
    case 128: DL4J_PAGED(128); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef DL4J_PAGED
  return 0;
}

}  // namespace

// q [N, A, D] at strides (sqn, sqa, 1); kc, vc [num_blocks, A, BS, D] at
// strides (skb, ska, skt, 1) and (svb, sva, svt, 1); tables [S, MAXB],
// lane [N] and kmax [N] int32, contiguous; out [N, A, D] contiguous.
// dtype: 1 float32, 2 float64. Returns the launch's cudaError_t.
extern "C" int dl4j_paged_attention(
    const void* q, const void* kc, const void* vc, const void* tables,
    const void* lane, const void* kmax, void* out, int64_t N, int64_t A,
    int64_t D, int64_t BS, int64_t MAXB, int64_t sqn, int64_t sqa,
    int64_t skb, int64_t ska, int64_t skt, int64_t svb, int64_t sva,
    int64_t svt, double scale, int dtype, void* stream) {
  if (N <= 0 || A <= 0) return 0;
  if (BS < 1 || MAXB < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (dtype == 1)
    err = launch_d<float>(D, q, kc, vc, tables, lane, kmax, out, N, A, BS,
                          MAXB, sqn, sqa, skb, ska, skt, svb, sva, svt,
                          scale, st);
  else if (dtype == 2)
    err = launch_d<double>(D, q, kc, vc, tables, lane, kmax, out, N, A, BS,
                           MAXB, sqn, sqa, skb, ska, skt, svb, sva, svt,
                           scale, st);
  else
    err = (int)cudaErrorInvalidValue;
  if (err != 0) return err;
  return (int)cudaGetLastError();
}
