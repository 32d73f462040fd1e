// Fused BatchNorm-apply + activation, forward and backward, for Hopper
// (sm_90a).
//
// Forward replaces the TPU kernel mxnet_tpu/kernels/bn_act.py:109-130
// (_make_norm_act.fwd_call, body fwd_kernel): y = act(x * scale + shift)
// over x viewed as (N, C, M), M = H*W, with per-channel scale and shift
// computed outside the kernel from batch or moving statistics.
//
// Backward replaces mxnet_tpu/kernels/bn_act.py:113-149
// (_make_norm_act.bwd_call, body bwd_kernel): recompute y, then
// dpre = dy * act'(y), dx = dpre * scale, and the per-(n, c) partial sums
// sum_m dpre * x and sum_m dpre that the caller folds over N into the
// scale and shift gradients.
//
// Bound: memory traffic, for both.  Each element costs a few flops plus
// the activation, far below the ~20 flops per byte at which an H100 SXM
// (data sheet, 700 W: 67 TFLOP/s float32, 3.35 TB/s HBM3) stops being
// limited by memory.  So each design moves each byte once:
//   - forward: one pass, y written once, in x's dtype; a 1-D grid-stride
//     loop over the N*C*M elements with 64-bit indices, so neighbouring
//     threads touch neighbouring addresses (coalesced) and no shape limit
//     applies (N*C may exceed gridDim.y's 65,535); the channel of element
//     i is (i / M) % C;
//   - backward: one block per (n, c) row on grid-x (no 65,535 limit),
//     threads striding over the row's M contiguous elements, x and dy
//     read once, dx written once, and the two row sums reduced in the
//     block (warp shuffles, then one shared-memory step) and written to an
//     (N*C) float32 buffer by thread 0.  No float atomics: every sum is
//     taken in a fixed order, so the result is deterministic.
//   - arithmetic and accumulation in f32 whatever the storage type (f32
//     or bf16).
// x * scale + shift is rounded as two separate operations (__fmul_rn,
// __fadd_rn) rather than contracted into one fma: the relu backward's
// mask y > 0 is then decided on exactly the value the forward produced
// and the plain PyTorch version computes, not on a value one rounding
// away from it.
// Unlike the TPU kernels there is no (8, 128) tiling gate: every shape
// runs.
//
// C interface (bound with ctypes): each function launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum Act { kActNone = 0, kActRelu = 1, kActSigmoid = 2, kActTanh = 3 };
enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float pre_act(float x, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x, scale), shift);
}

template <int ACT>
__device__ __forceinline__ float apply_act(float y) {
  if (ACT == kActRelu) return y < 0.f ? 0.f : y;  // NaN passes through
  if (ACT == kActSigmoid) return 1.f / (1.f + expf(-y));
  if (ACT == kActTanh) return tanhf(y);
  return y;
}

// act'(pre) from the post-activation value y (bn_act.py:80-88); for relu
// a NaN y gives 0, as (y > 0) does
template <int ACT>
__device__ __forceinline__ float act_grad(float y) {
  if (ACT == kActRelu) return y > 0.f ? 1.f : 0.f;
  if (ACT == kActSigmoid) return y * (1.f - y);
  if (ACT == kActTanh) return 1.f - y * y;
  return 1.f;
}

template <typename T, int ACT>
__global__ void bn_act_fwd_kernel(const T* __restrict__ x,
                                  const T* __restrict__ scale,
                                  const T* __restrict__ shift,
                                  T* __restrict__ y, int64_t total,
                                  int64_t channels, int64_t m) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const int64_t c = (i / m) % channels;
    const float v = pre_act(load_f32(x + i), load_f32(scale + c),
                            load_f32(shift + c));
    store_f32(y + i, apply_act<ACT>(v));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, offset);
  return v;
}

// one block per (n, c) row; blockDim.x is a multiple of 32, at most 1024
template <typename T, int ACT>
__global__ void bn_act_bwd_kernel(const T* __restrict__ x,
                                  const T* __restrict__ scale,
                                  const T* __restrict__ shift,
                                  const T* __restrict__ dy,
                                  T* __restrict__ dx,
                                  float* __restrict__ dscale_rows,
                                  float* __restrict__ dshift_rows,
                                  int64_t channels, int64_t m) {
  const int64_t row = blockIdx.x;
  const int64_t c = row % channels;
  const float s = load_f32(scale + c);
  const float b = load_f32(shift + c);
  const int64_t base = row * m;
  float acc_s = 0.f, acc_b = 0.f;
  for (int64_t i = threadIdx.x; i < m; i += blockDim.x) {
    const float xv = load_f32(x + base + i);
    const float yv = apply_act<ACT>(pre_act(xv, s, b));
    const float dpre = load_f32(dy + base + i) * act_grad<ACT>(yv);
    store_f32(dx + base + i, dpre * s);
    acc_s += dpre * xv;
    acc_b += dpre;
  }
  __shared__ float part_s[32];
  __shared__ float part_b[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  acc_s = warp_sum(acc_s);
  acc_b = warp_sum(acc_b);
  if (lane == 0) {
    part_s[warp] = acc_s;
    part_b[warp] = acc_b;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    acc_s = lane < n_warps ? part_s[lane] : 0.f;
    acc_b = lane < n_warps ? part_b[lane] : 0.f;
    acc_s = warp_sum(acc_s);
    acc_b = warp_sum(acc_b);
    if (lane == 0) {
      dscale_rows[row] = acc_s;
      dshift_rows[row] = acc_b;
    }
  }
}

template <typename T, int ACT>
void launch_fwd(const void* x, const void* scale, const void* shift, void* y,
                int64_t total, int64_t channels, int64_t m,
                cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  if (blocks > 132 * 32) blocks = 132 * 32;
  bn_act_fwd_kernel<T, ACT><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<T*>(y), total, channels, m);
}

template <typename T, int ACT>
void launch_bwd(const void* x, const void* scale, const void* shift,
                const void* dy, void* dx, float* dscale_rows,
                float* dshift_rows, int64_t rows, int64_t channels,
                int64_t m, cudaStream_t stream) {
  // a warp per 32 elements of the row, 32 to 256 threads: M = 49 takes
  // two warps, M >= 225 takes eight
  int threads = (int)((m + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  bn_act_bwd_kernel<T, ACT><<<(unsigned)rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<const T*>(dy),
      static_cast<T*>(dx), dscale_rows, dshift_rows, channels, m);
}

template <typename T>
int dispatch_fwd(int act, const void* x, const void* scale, const void* shift,
                 void* y, int64_t total, int64_t channels, int64_t m,
                 cudaStream_t s) {
  switch (act) {
    case kActNone: launch_fwd<T, kActNone>(x, scale, shift, y, total, channels, m, s); break;
    case kActRelu: launch_fwd<T, kActRelu>(x, scale, shift, y, total, channels, m, s); break;
    case kActSigmoid: launch_fwd<T, kActSigmoid>(x, scale, shift, y, total, channels, m, s); break;
    case kActTanh: launch_fwd<T, kActTanh>(x, scale, shift, y, total, channels, m, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(int act, const void* x, const void* scale, const void* shift,
                 const void* dy, void* dx, float* ds, float* db, int64_t rows,
                 int64_t channels, int64_t m, cudaStream_t s) {
  switch (act) {
    case kActNone: launch_bwd<T, kActNone>(x, scale, shift, dy, dx, ds, db, rows, channels, m, s); break;
    case kActRelu: launch_bwd<T, kActRelu>(x, scale, shift, dy, dx, ds, db, rows, channels, m, s); break;
    case kActSigmoid: launch_bwd<T, kActSigmoid>(x, scale, shift, dy, dx, ds, db, rows, channels, m, s); break;
    case kActTanh: launch_bwd<T, kActTanh>(x, scale, shift, dy, dx, ds, db, rows, channels, m, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mxt_bn_act_fwd(const void* x, const void* scale,
                              const void* shift, void* y, long long n,
                              long long channels, long long m, int dtype,
                              int act, void* stream) {
  const int64_t total = (int64_t)n * channels * m;
  if (total == 0) return (int)cudaSuccess;
  if (channels <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch_fwd<float>(act, x, scale, shift, y, total, channels, m, s);
  if (dtype == kBFloat16)
    return dispatch_fwd<__nv_bfloat16>(act, x, scale, shift, y, total, channels, m, s);
  return (int)cudaErrorInvalidValue;
}

// dscale_rows, dshift_rows: float32 buffers of n * channels entries, the
// per-(n, c) partial sums; the caller sums them over n
extern "C" int mxt_bn_act_bwd(const void* x, const void* scale,
                              const void* shift, const void* dy, void* dx,
                              void* dscale_rows, void* dshift_rows,
                              long long n, long long channels, long long m,
                              int dtype, int act, void* stream) {
  const int64_t rows = (int64_t)n * channels;
  if (rows == 0) return (int)cudaSuccess;
  if (channels <= 0 || m <= 0 || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ds = static_cast<float*>(dscale_rows);
  float* db = static_cast<float*>(dshift_rows);
  if (dtype == kFloat32)
    return dispatch_bwd<float>(act, x, scale, shift, dy, dx, ds, db, rows, channels, m, s);
  if (dtype == kBFloat16)
    return dispatch_bwd<__nv_bfloat16>(act, x, scale, shift, dy, dx, ds, db, rows, channels, m, s);
  return (int)cudaErrorInvalidValue;
}
