// The rtc escape hatch's elementwise kernel, for Hopper (sm_90a): a
// TEMPLATE into which mxnet_tpu_torch/rtc.py (elementwise_cuda_kernel)
// pastes a user's body before nvcc builds it.  It is not built as it
// stands: the marker below is replaced by the body, the rendered source is
// written under mxnet_tpu_torch/_build/rtc/ and built there, keyed by a
// hash of this file's bytes, the body and the nvcc flags.
//
// Replaces the TPU kernel mxnet_tpu/rtc.py:124-143
// (elementwise_pallas_kernel): a user body kernel(in_ref, out_ref) run by
// pl.pallas_call over one block that covers the whole array, the output of
// the input's shape and dtype.  The port has no Pallas, so the body is the
// card's own kernel language, as the Pallas body was the TPU's: a CUDA C++
// statement over the element `in` that assigns `out`, for example
//     out = in / (1.0f + expf(-in));
// `in` and `out` have the math type `scalar_t`: float for float32,
// bfloat16 and float16 storage, double for float64.
//
// Stated divergence: the body must be ELEMENTWISE.  A Pallas body sees the
// whole block and could read any element of it; this body sees one
// element and writes that element's output.
//
// Bound: memory traffic.  Each element is read once and written once,
// (bytes(in) + bytes(out)) / 3.35 TB/s on an H100 SXM (data sheet, 700 W),
// for the few flops and one transcendental of a typical body: far below
// the ~20 flops per byte at which the card stops being limited by memory.
// At (32, 256, 56, 56) float32 that is 205.5 MB, 61 us.  The design moves
// each byte once: one thread per element per iteration of a 1-D
// grid-stride loop with 64-bit indices (no limit on the element count),
// neighbouring threads on neighbouring addresses (coalesced).  Loads and
// stores go through the dtype's intrinsics (__bfloat162float /
// __float2bfloat16, __half2float / __float2half, both rounding to nearest
// even).  Vector loads (16 bytes a thread) are left for a later change.
//
// C interface (bound with ctypes): one entry per dtype, each taking
// (const void* in, void* out, int64_t n, void* stream) over contiguous
// tensors of n elements; it launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// enough blocks to fill 132 SMs several times over; the loop strides past
// the end of the grid for larger arrays
constexpr int64_t kMaxBlocks = 132 * 32;

template <typename T> struct Storage;
template <> struct Storage<float> {
  typedef float scalar_t;
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <> struct Storage<double> {
  typedef double scalar_t;
  static __device__ __forceinline__ double load(const double* p) { return *p; }
  static __device__ __forceinline__ void store(double* p, double v) { *p = v; }
};
template <> struct Storage<__nv_bfloat16> {
  typedef float scalar_t;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};
template <> struct Storage<__half> {
  typedef float scalar_t;
  static __device__ __forceinline__ float load(const __half* p) {
    return __half2float(*p);
  }
  static __device__ __forceinline__ void store(__half* p, float v) {
    *p = __float2half(v);
  }
};

// the user's body, pasted in place of the marker
template <typename scalar_t>
__device__ __forceinline__ scalar_t mxt_rtc_body(scalar_t in) {
  scalar_t out;
  /*@MXT_RTC_BODY@*/
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rtc_elementwise_kernel(const T* __restrict__ in, T* __restrict__ out,
                       int64_t n) {
  typedef typename Storage<T>::scalar_t scalar_t;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    Storage<T>::store(out + i, mxt_rtc_body<scalar_t>(Storage<T>::load(in + i)));
  }
}

template <typename T>
int launch(const void* in, void* out, int64_t n, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if (n < 0) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  rtc_elementwise_kernel<T><<<(unsigned)blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mxt_rtc_elementwise_f32(const void* in, void* out, int64_t n,
                                       void* stream) {
  return launch<float>(in, out, n, stream);
}

extern "C" int mxt_rtc_elementwise_bf16(const void* in, void* out, int64_t n,
                                        void* stream) {
  return launch<__nv_bfloat16>(in, out, n, stream);
}

extern "C" int mxt_rtc_elementwise_f16(const void* in, void* out, int64_t n,
                                       void* stream) {
  return launch<__half>(in, out, n, stream);
}

extern "C" int mxt_rtc_elementwise_f64(const void* in, void* out, int64_t n,
                                       void* stream) {
  return launch<double>(in, out, n, stream);
}
