// Fused LSTM cell gate math, forward and backward, for Hopper (sm_90a).
//
// Forward replaces the TPU kernel mxnet_tpu/kernels/lstm_cell.py:57-67,
// 92-119, 126-128 (_pallas_call(_fwd_kernel) in _make_pallas): from the
// (B, 4H) gate pre-activations in gate order [i, f, c, o] and the previous
// cell c_prev (B, H),
//   c = sigmoid(f) * c_prev + sigmoid(i) * tanh(g),
//   h = sigmoid(o) * tanh(c).
//
// Backward replaces mxnet_tpu/kernels/lstm_cell.py:70-89, 120-124, 135-138
// (_pallas_call(_bwd_kernel)): it recomputes i, f, g, o, c and tanh(c) from
// the saved inputs (gates, c_prev), never from stored activations, then
//   dc      = dc_in + dh * o * (1 - tanh(c)^2)
//   do      = dh * tanh(c) * o * (1 - o)
//   di      = dc * g * i * (1 - i)
//   df      = dc * c_prev * f * (1 - f)
//   dg      = dc * i * (1 - g^2)
//   dgates  = [di, df, dg, do],   dc_prev = dc * f.
//
// Bound: memory traffic.  Per (b, j) element the forward reads 5 values and
// writes 2, the backward reads 7 and writes 5, for a few dozen flops and
// five transcendentals: far below the ~20 flops per byte at which an H100
// SXM (data sheet, 700 W: 67 TFLOP/s float32, 3.35 TB/s HBM3) stops being
// limited by memory.  At the language model's (B, H) = (32, 200) one launch
// moves 179 kB (forward) or 307 kB (backward) in float32, a twentieth of a
// microsecond at the HBM rate, so launch latency sets its time there.
// The design moves each byte once: one thread per (b, j) in a 1-D
// grid-stride loop with 64-bit indices (no limit on B * H), neighbouring
// threads on neighbouring j, so each of the four gate slices of a row and
// the (B, H) tensors are read and written coalesced.  Nothing is reduced,
// so there are no atomics and the result is deterministic.  Arithmetic is
// float32 whatever the storage type (float32 or bfloat16), with expf and
// tanhf (no fast-math intrinsics) and sigmoid written 1 / (1 + exp(-x)),
// as jax.nn.sigmoid computes it; each product and sum is rounded on its
// own (__fmul_rn, __fadd_rn, no fma contraction), as the plain PyTorch
// version's separate elementwise ops round them.  Unlike the TPU kernel
// there is no (H % 128, rows % 8) tiling gate: every shape runs.
//
// C interface (bound with ctypes): contiguous row-major tensors; each
// function launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, add(1.f, expf(-x)));
}

struct Gates {
  float i, f, g, o;
};

// the four activations of element (b, j); row points at gates[b, 0]
template <typename T>
__device__ __forceinline__ Gates activations(const T* row, int64_t j,
                                             int64_t hidden) {
  Gates a;
  a.i = sigmoid(load_f32(row + j));
  a.f = sigmoid(load_f32(row + hidden + j));
  a.g = tanhf(load_f32(row + 2 * hidden + j));
  a.o = sigmoid(load_f32(row + 3 * hidden + j));
  return a;
}

template <typename T>
__global__ void lstm_cell_fwd_kernel(const T* __restrict__ gates,
                                     const T* __restrict__ c_prev,
                                     T* __restrict__ h_out,
                                     T* __restrict__ c_out, int64_t total,
                                     int64_t hidden) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += step) {
    const int64_t b = e / hidden;
    const int64_t j = e - b * hidden;
    const Gates a = activations(gates + b * 4 * hidden, j, hidden);
    const float c = add(mul(a.f, load_f32(c_prev + e)), mul(a.i, a.g));
    store_f32(c_out + e, c);
    store_f32(h_out + e, mul(a.o, tanhf(c)));
  }
}

template <typename T>
__global__ void lstm_cell_bwd_kernel(const T* __restrict__ gates,
                                     const T* __restrict__ c_prev,
                                     const T* __restrict__ dh_in,
                                     const T* __restrict__ dc_in,
                                     T* __restrict__ dgates,
                                     T* __restrict__ dc_prev, int64_t total,
                                     int64_t hidden) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += step) {
    const int64_t b = e / hidden;
    const int64_t j = e - b * hidden;
    const Gates a = activations(gates + b * 4 * hidden, j, hidden);
    const float cp = load_f32(c_prev + e);
    const float c = add(mul(a.f, cp), mul(a.i, a.g));
    const float tc = tanhf(c);
    const float dh = load_f32(dh_in + e);
    // dc accumulates the explicit cotangent and the h = o * tanh(c) path
    const float dc = add(load_f32(dc_in + e),
                         mul(mul(dh, a.o), sub(1.f, mul(tc, tc))));
    const float d_o = mul(mul(mul(dh, tc), a.o), sub(1.f, a.o));
    const float d_i = mul(mul(mul(dc, a.g), a.i), sub(1.f, a.i));
    const float d_f = mul(mul(mul(dc, cp), a.f), sub(1.f, a.f));
    const float d_g = mul(mul(dc, a.i), sub(1.f, mul(a.g, a.g)));
    T* row = dgates + b * 4 * hidden;
    store_f32(row + j, d_i);
    store_f32(row + hidden + j, d_f);
    store_f32(row + 2 * hidden + j, d_g);
    store_f32(row + 3 * hidden + j, d_o);
    store_f32(dc_prev + e, mul(dc, a.f));
  }
}

// enough blocks to fill 132 SMs many times over; the loop covers the rest
unsigned grid_for(int64_t total, int threads) {
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return (unsigned)blocks;
}

constexpr int kThreads = 256;

template <typename T>
int launch_fwd(const void* gates, const void* c_prev, void* h, void* c,
               int64_t total, int64_t hidden, cudaStream_t s) {
  lstm_cell_fwd_kernel<T><<<grid_for(total, kThreads), kThreads, 0, s>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c_prev),
      static_cast<T*>(h), static_cast<T*>(c), total, hidden);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* gates, const void* c_prev, const void* dh,
               const void* dc, void* dgates, void* dc_prev, int64_t total,
               int64_t hidden, cudaStream_t s) {
  lstm_cell_bwd_kernel<T><<<grid_for(total, kThreads), kThreads, 0, s>>>(
      static_cast<const T*>(gates), static_cast<const T*>(c_prev),
      static_cast<const T*>(dh), static_cast<const T*>(dc),
      static_cast<T*>(dgates), static_cast<T*>(dc_prev), total, hidden);
  return (int)cudaGetLastError();
}

}  // namespace

// gates: (rows, 4 * hidden); c_prev, h, c: (rows, hidden)
extern "C" int mxt_lstm_cell_fwd(const void* gates, const void* c_prev,
                                 void* h, void* c, long long rows,
                                 long long hidden, int dtype, void* stream) {
  if (rows < 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)rows * hidden;
  if (total == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_fwd<float>(gates, c_prev, h, c, total, hidden, s);
  if (dtype == kBFloat16)
    return launch_fwd<__nv_bfloat16>(gates, c_prev, h, c, total, hidden, s);
  return (int)cudaErrorInvalidValue;
}

// gates, dgates: (rows, 4 * hidden); c_prev, dh, dc, dc_prev: (rows, hidden)
extern "C" int mxt_lstm_cell_bwd(const void* gates, const void* c_prev,
                                 const void* dh, const void* dc, void* dgates,
                                 void* dc_prev, long long rows,
                                 long long hidden, int dtype, void* stream) {
  if (rows < 0 || hidden <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)rows * hidden;
  if (total == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_bwd<float>(gates, c_prev, dh, dc, dgates, dc_prev, total,
                             hidden, s);
  if (dtype == kBFloat16)
    return launch_bwd<__nv_bfloat16>(gates, c_prev, dh, dc, dgates, dc_prev,
                                     total, hidden, s);
  return (int)cudaErrorInvalidValue;
}
