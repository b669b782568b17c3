// The LSTM cell's pointwise forward and backward, one launch a timestep
// each, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes the cell in jnp
// (deeplearning4j_tpu/ops/nn_ops.py `lstm_cell` :520-536, scanned by
// `lstm_layer` :539-556), and XLA fused the gates' activations, the cell
// update and their gradients into the body of `lax.scan`. Written as
// eager PyTorch, the same cell is about 10 passes over device memory a
// timestep in the forward and about 15 in the backward; each kernel here
// is one. The products (x @ W_ih for all timesteps at once, h @ W_hh a
// step, dz @ W_hh^T a step, the weight gradients) stay cuBLAS GEMMs, as
// the JAX package left them to XLA; kernels/lstm.py runs the recurrence.
// Its plain PyTorch versions are `lstm_cell_fwd_plain` and
// `lstm_cell_bwd_plain` there.
//
// Gate order [i, f, g, o] (sigmoid, sigmoid, tanh, sigmoid), rows of B
// examples and U units, every array contiguous:
//
//   forward, z [B, 4U] = x W_ih + b + h_prev W_hh, c_prev [B, U]:
//     i, f, g, o = act(z)               (written back over z: the saved
//                                        gates of the backward)
//     c = f * c_prev + i * g,  h = o * tanh(c)
//
//   backward, the saved gates [B, 4U], c_prev, c, dh = dh_up + dh_next
//   (the step's output gradient and the carried one, summed here), and
//   dc_next:
//     tc = tanh(c),  dc = dc_next + dh * o * (1 - tc^2)
//     dz_i = dc * g * i (1 - i),   dz_f = dc * c_prev * f (1 - f)
//     dz_g = dc * i * (1 - g^2),   dz_o = dh * tc * o (1 - o)
//     dc_prev = dc * f
//   dh_up, dh_next and dc_next may be null (zero). dc_prev may be dc_next
//   itself: each thread reads its element before it writes it.
//
// Types: float32 and float64 (the float64 instantiation runs the card
// against the CPU). The arithmetic is in the tensors' type.
//
// What bounds it: a launch's latency. At TextGenLSTM's rows (B = 32, U =
// 256) the forward moves 360 KB and the backward 590 KB, 0.11 and 0.18 us
// at 3.35 TB/s, against a few microseconds a launch; the work of a
// timestep cannot be spread wider than B * U threads, and the next
// timestep waits on this one through h @ W_hh. Per timestep this is one
// launch in place of the ~10 / ~15 of eager PyTorch, which is what this
// design buys; inside a captured fit window the launches are graph nodes.
//
// What the design does about it: one thread a (b, j) unit, reading its
// four gates at j, U + j, 2U + j and 3U + j of the row (each a coalesced
// load across the warp) and writing its outputs once; a grid-stride loop
// of 256-thread blocks. No shared memory, no atomics, no allocation, no
// host sync: the wrapper launches on PyTorch's current stream, so the fit
// tiers can capture it. Folding h @ W_hh into a persistent kernel that
// keeps W_hh on chip across the timesteps is later work (ROADMAP queue 2b
// item 11).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 65535;

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float tanh_(float x) { return tanhf(x); }
__device__ __forceinline__ double tanh_(double x) { return tanh(x); }

template <typename T>
__device__ __forceinline__ T sigmoid_(T x) {
  return T(1) / (T(1) + exp_(-x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_cell_fwd_kernel(T* __restrict__ z, const T* __restrict__ c_prev,
                         T* __restrict__ h, T* __restrict__ c, int64_t B,
                         int64_t U) {
  const int64_t n = B * U;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = e / U, j = e - b * U;
    T* row = z + b * 4 * U;
    const T i = sigmoid_(row[j]);
    const T f = sigmoid_(row[U + j]);
    const T g = tanh_(row[2 * U + j]);
    const T o = sigmoid_(row[3 * U + j]);
    const T cn = f * c_prev[e] + i * g;
    row[j] = i;
    row[U + j] = f;
    row[2 * U + j] = g;
    row[3 * U + j] = o;
    c[e] = cn;
    h[e] = o * tanh_(cn);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_cell_bwd_kernel(const T* __restrict__ gates,
                         const T* __restrict__ c_prev,
                         const T* __restrict__ c, const T* __restrict__ dh_up,
                         const T* __restrict__ dh_next, const T* dc_next,
                         T* __restrict__ dz, T* dc_prev, int64_t B, int64_t U) {
  const int64_t n = B * U;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t b = e / U, j = e - b * U;
    const T* row = gates + b * 4 * U;
    const T i = row[j], f = row[U + j], g = row[2 * U + j], o = row[3 * U + j];
    const T dh = (dh_up ? dh_up[e] : T(0)) + (dh_next ? dh_next[e] : T(0));
    const T tc = tanh_(c[e]);
    const T dc = (dc_next ? dc_next[e] : T(0)) + dh * o * (T(1) - tc * tc);
    T* out = dz + b * 4 * U;
    out[j] = dc * g * i * (T(1) - i);
    out[U + j] = dc * c_prev[e] * f * (T(1) - f);
    out[2 * U + j] = dc * i * (T(1) - g * g);
    out[3 * U + j] = dh * tc * o * (T(1) - o);
    dc_prev[e] = dc * f;
  }
}

int blocks(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

// dtype: 0 float32, 1 float64. Returns the launch's cudaError_t.
extern "C" int dl4j_lstm_cell_fwd(void* z, const void* c_prev, void* h, void* c,
                                  int64_t B, int64_t U, int dtype, void* stream) {
  if (B < 1 || U < 1 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = blocks(B * U);
  if (dtype == 0)
    lstm_cell_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(z), static_cast<const float*>(c_prev),
        static_cast<float*>(h), static_cast<float*>(c), B, U);
  else
    lstm_cell_fwd_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<double*>(z), static_cast<const double*>(c_prev),
        static_cast<double*>(h), static_cast<double*>(c), B, U);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dl4j_lstm_cell_bwd(const void* gates, const void* c_prev,
                                  const void* c, const void* dh_up,
                                  const void* dh_next, const void* dc_next,
                                  void* dz, void* dc_prev, int64_t B, int64_t U,
                                  int dtype, void* stream) {
  if (B < 1 || U < 1 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = blocks(B * U);
  if (dtype == 0)
    lstm_cell_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(gates), static_cast<const float*>(c_prev),
        static_cast<const float*>(c), static_cast<const float*>(dh_up),
        static_cast<const float*>(dh_next), static_cast<const float*>(dc_next),
        static_cast<float*>(dz), static_cast<float*>(dc_prev), B, U);
  else
    lstm_cell_bwd_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<const double*>(gates), static_cast<const double*>(c_prev),
        static_cast<const double*>(c), static_cast<const double*>(dh_up),
        static_cast<const double*>(dh_next), static_cast<const double*>(dc_next),
        static_cast<double*>(dz), static_cast<double*>(dc_prev), B, U);
  return static_cast<int>(cudaGetLastError());
}
