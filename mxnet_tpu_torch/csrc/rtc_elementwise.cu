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
// each byte once, 16 bytes per load and per store (4 float, 8 bfloat16 or
// float16, 2 double): each thread of a 1-D grid-stride loop with 64-bit
// indices loads kUnroll vectors before it computes and stores any, so
// every SM keeps enough bytes in flight; the grid is sized from the
// vector count.  The wrapper (rtc.py) splits the n elements at 16-byte
// boundaries: `head` scalar elements before the first boundary (a view
// such as x[1:] starts 4 bytes off), `vectors` aligned vectors, and a
// scalar tail of the last n - head - vectors * N elements; it allocates
// the output at the input's offset from a boundary, so one split serves
// both.  Loads and stores of bfloat16 and float16 go through the dtype's
// intrinsics (__bfloat162float / __float2bfloat16, __half2float /
// __float2half, both rounding to nearest even); the body runs once per
// element on every path, in the same rounding.
//
// C interface (bound with ctypes): one entry per dtype, each taking
// (const void* in, void* out, int64_t n, int64_t head, int64_t vectors,
// void* stream) over contiguous tensors of n elements; it checks the split
// (in + head and out + head 16-byte aligned when vectors > 0), launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // 16-byte vectors per thread per iteration
// more blocks than this stride through the array instead
constexpr int64_t kMaxBlocks = 1 << 20;

template <typename T> struct Storage;
template <> struct Storage<float> {
  typedef float scalar_t;
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <> struct Storage<double> {
  typedef double scalar_t;
  static __device__ __forceinline__ double load(double x) { return x; }
  static __device__ __forceinline__ double store(double v) { return v; }
};
template <> struct Storage<__nv_bfloat16> {
  typedef float scalar_t;
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16(v);
  }
};
template <> struct Storage<__half> {
  typedef float scalar_t;
  static __device__ __forceinline__ float load(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half store(float v) {
    return __float2half(v);
  }
};

// 16 bytes of T, loaded and stored as one vector
template <typename T>
struct alignas(16) Vec {
  T v[16 / sizeof(T)];
};

// the user's body, pasted in place of the marker
template <typename scalar_t>
__device__ __forceinline__ scalar_t mxt_rtc_body(scalar_t in) {
  scalar_t out;
  /*@MXT_RTC_BODY@*/
  return out;
}

template <typename T>
__device__ __forceinline__ T apply(T x) {
  typedef typename Storage<T>::scalar_t scalar_t;
  return Storage<T>::store(mxt_rtc_body<scalar_t>(Storage<T>::load(x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rtc_elementwise_kernel(const T* __restrict__ in, T* __restrict__ out,
                       int64_t n, int64_t head, int64_t vectors) {
  constexpr int N = 16 / sizeof(T);
  static_assert(sizeof(Vec<T>) == 16, "one 16-byte vector");
  // the scalar prologue and tail: the first threads of the grid
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t body_end = head + vectors * N;
  if (tid < head) out[tid] = apply(in[tid]);
  if (tid < n - body_end) out[body_end + tid] = apply(in[body_end + tid]);
  // the aligned body: kUnroll vectors a thread, all loaded before any is
  // computed
  const Vec<T>* vin = reinterpret_cast<const Vec<T>*>(in + head);
  Vec<T>* vout = reinterpret_cast<Vec<T>*>(out + head);
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  for (int64_t base = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x;
       base < vectors; base += step) {
    Vec<T> r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + (int64_t)u * kThreads;
      if (i < vectors) r[u] = vin[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + (int64_t)u * kThreads;
      if (i < vectors) {
        Vec<T> w;
#pragma unroll
        for (int e = 0; e < N; ++e) w.v[e] = apply(r[u].v[e]);
        vout[i] = w;
      }
    }
  }
}

template <typename T>
int launch(const void* in, void* out, int64_t n, int64_t head,
           int64_t vectors, void* stream) {
  constexpr int N = 16 / sizeof(T);
  // the split: head < N elements, then whole vectors, then a tail < N
  if (n < 0 || head < 0 || head >= N || vectors < 0 ||
      head + vectors * N > n || n - head - vectors * N >= N)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (vectors > 0 &&
      ((reinterpret_cast<uintptr_t>(static_cast<const T*>(in) + head) |
        reinterpret_cast<uintptr_t>(static_cast<T*>(out) + head)) & 15))
    return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)kThreads * kUnroll;
  int64_t blocks = (vectors + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;  // the scalar prologue and tail
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  rtc_elementwise_kernel<T><<<(unsigned)blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n, head, vectors);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mxt_rtc_elementwise_f32(const void* in, void* out, int64_t n,
                                       int64_t head, int64_t vectors,
                                       void* stream) {
  return launch<float>(in, out, n, head, vectors, stream);
}

extern "C" int mxt_rtc_elementwise_bf16(const void* in, void* out, int64_t n,
                                        int64_t head, int64_t vectors,
                                        void* stream) {
  return launch<__nv_bfloat16>(in, out, n, head, vectors, stream);
}

extern "C" int mxt_rtc_elementwise_f16(const void* in, void* out, int64_t n,
                                       int64_t head, int64_t vectors,
                                       void* stream) {
  return launch<__half>(in, out, n, head, vectors, stream);
}

extern "C" int mxt_rtc_elementwise_f64(const void* in, void* out, int64_t n,
                                       int64_t head, int64_t vectors,
                                       void* stream) {
  return launch<double>(in, out, n, head, vectors, stream);
}
