// LSTM for Hopper (sm_90a): the fused cell, forward and backward, and one
// persistent recurrence kernel per layer (and direction), forward and
// backward, that runs all T steps of the fused RNN op in one launch.
//
// 1. The cell (mxt_lstm_cell_fwd / mxt_lstm_cell_bwd).
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
// 2. The recurrence (mxt_lstm_seq_fwd / mxt_lstm_seq_bwd).
//
// Replaces the same two TPU kernels (rows 3-4 above) together with the
// lax.scan of the fused RNN op that calls them once per step,
// mxnet_tpu/ops/nn.py:927-931 (step: x_proj + h . W_h2h^T + b_h2h, then the
// cell) and :1030-1032 (the scan over T).  For one layer and direction,
// from xg (T, N, 4H), the hoisted input projection with both biases added,
// W_h2h (4H, H), h0 and c0 (N, H):
//   forward:  gates_t = xg[t] + h_{t-1} . W^T,  (h_t, c_t) = cell(gates_t,
//             c_{t-1}); it writes hs, cs (T, N, H), hT, cT and, when the
//             caller needs a gradient, the pre-activations gates (T, N, 4H);
//   backward: for t = T-1 .. 0, dh = dhs[t] + dh_rec (dh_rec starts as
//             dhT, dc as dcT), the cell backward above from gates[t] and
//             c_prev[t], dgates[t], then dh_rec = dgates[t] . W and
//             dc = dc * f; it writes dgates (T, N, 4H), dh0 and dc0.
//             dW_h2h = dgates^T . [h0; hs[:-1]] and the bias sums stay
//             outside, one torch.matmul, as the JAX package leaves them to
//             XLA.
// The cell's arithmetic is the device functions of section 1 (activate,
// cell_forward, cell_backward), called in the same order.
//
// Bound at the language model's layer, (T, N, H) = (32, 32, 200): the
// products, 2 T N 4H H = 327.7 MFLOP, 4.9 us at 67 TFLOP/s in float32; in
// bfloat16 (989 TFLOP/s on the tensor cores) the bytes, xg and W read and
// hs, cs and gates written once, 4.4 MB, 1.3 us at 3.35 TB/s.  The
// backward does the same products (dW's matmul is outside).  What the
// per-step route cannot avoid is one launch of about 2 us for each
// product and cell of each step; the design removes them:
// - a grid of thread-block clusters of K blocks (K = 8, or 16 with the
//   non-portable cluster size; cudaLaunchKernelEx with
//   cudaLaunchAttributeClusterDimension).  Batch rows are independent, so
//   each cluster owns a tile of `rows` batch rows, and more clusters fill
//   more SMs, up to the clusters the card holds at once (an H100 holds 15
//   of 8 blocks, 7 of 16: a cluster beyond them would wait for a whole
//   sequence); the Python wrapper (kernels/lstm_cell.py lstm_seq_plan)
//   picks K and the tile and this file checks them against shared memory;
// - block k of a cluster owns U = ceil(H / K) hidden units S_k and the 4U
//   rows of W_h2h that produce their i, f, g and o gates.  The forward
//   holds those rows, the backward their transpose, in dynamic shared
//   memory for all T steps, loaded once;
// - forward step t: each block computes its gate columns h_{t-1} . W^T
//   (float32 FFMA, register tiles of 4 rows of W by the tile's batch rows
//   fed by 16-byte shared loads, the dot product split over up to 32 lanes
//   and summed by warp shuffles in a fixed order; bfloat16 with mma.sync
//   m16n8k16, float32 accumulators, two chains over the depth),
//   adds xg[t], runs the cell (c and the activations in registers), writes
//   h_t and c_t to global memory and h_t into every block's next h buffer
//   through distributed shared memory (cluster.map_shared_rank); one
//   cluster barrier a step publishes it (h double-buffered, so one barrier
//   suffices; its arrive is a release, and the global stores of h_t, c_t
//   and the gates run between arrive and wait).  The loads of xg[t+1] (the
//   backward: gates[t-1], c_prev[t-1], dhs[t-1]) go to registers as soon
//   as step t has read xg[t], and land while the barrier and the next
//   product run: cp.async has no 2-byte copy, and a bfloat16 slice of U
//   units need not start on a 4-byte boundary;
// - backward step t: block k forms P_k = dgates[t][:, R_k] . W[R_k, :]
//   (N_tile x H, float32) in its shared memory; after the cluster barrier
//   block j sums P_0 .. P_{K-1} over its units S_j, in that order, from
//   the cluster's shared memory: no atomics, the same result on every
//   run.  The dc chain stays in each block's registers;
// - float32 is float32 (FFMA, no TF32).  bfloat16 rounds where the
//   per-step route (addmm into bf16, then the cell kernel) rounds: the
//   pre-activation once, h and c when stored, and the bf16 h feeds the
//   next product; the backward rounds dh_rec, dh, dgates and dc as the
//   per-step backward's bf16 tensors are rounded.  So the routes differ
//   only in the order of summation.
// Where the weights and buffers do not fit one block's 227 KB at K <= 16
// (H = 1024 in float32: W_h2h is 16 MB) the wrapper takes the per-step
// route.  Before a launch the entry checks cudaOccupancyMaxActiveClusters
// and returns kErrNoCluster when no cluster of the configuration can be
// resident; the wrapper raises on it and on every other error.
// nvcc's -Xptxas -v report (registers, spills) goes to the build log
// beside the library (kernels/__init__.py build).
//
// C interface (bound with ctypes): contiguous row-major tensors; each
// function launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (or an error of its own checks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

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

// v rounded to the storage type T, kept in float
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
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

// the four activations from the four pre-activations
__device__ __forceinline__ Gates activate(float pi, float pf, float pg,
                                          float po) {
  Gates a;
  a.i = sigmoid(pi);
  a.f = sigmoid(pf);
  a.g = tanhf(pg);
  a.o = sigmoid(po);
  return a;
}

// the four activations of element (b, j); row points at gates[b, 0]
template <typename T>
__device__ __forceinline__ Gates activations(const T* row, int64_t j,
                                             int64_t hidden) {
  return activate(load_f32(row + j), load_f32(row + hidden + j),
                  load_f32(row + 2 * hidden + j),
                  load_f32(row + 3 * hidden + j));
}

// (h, c) from the activations and c_prev; h from the unrounded c
__device__ __forceinline__ void cell_forward(const Gates& a, float cp,
                                             float& h, float& c) {
  c = add(mul(a.f, cp), mul(a.i, a.g));
  h = mul(a.o, tanhf(c));
}

// d = [di, df, dg, do] and dc_prev from the activations, c_prev and the
// cotangents (dh, dc_in) of (h, c)
__device__ __forceinline__ void cell_backward(const Gates& a, float cp,
                                              float dh, float dc_in,
                                              float d[4], float& dc_prev) {
  const float c = add(mul(a.f, cp), mul(a.i, a.g));
  const float tc = tanhf(c);
  // dc accumulates the explicit cotangent and the h = o * tanh(c) path
  const float dc = add(dc_in, mul(mul(dh, a.o), sub(1.f, mul(tc, tc))));
  d[3] = mul(mul(mul(dh, tc), a.o), sub(1.f, a.o));
  d[0] = mul(mul(mul(dc, a.g), a.i), sub(1.f, a.i));
  d[1] = mul(mul(mul(dc, cp), a.f), sub(1.f, a.f));
  d[2] = mul(mul(dc, a.i), sub(1.f, mul(a.g, a.g)));
  dc_prev = mul(dc, a.f);
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
    float h, c;
    cell_forward(a, load_f32(c_prev + e), h, c);
    store_f32(c_out + e, c);
    store_f32(h_out + e, h);
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
    float d[4], dcp;
    cell_backward(a, load_f32(c_prev + e), load_f32(dh_in + e),
                  load_f32(dc_in + e), d, dcp);
    T* row = dgates + b * 4 * hidden;
    store_f32(row + j, d[0]);
    store_f32(row + hidden + j, d[1]);
    store_f32(row + 2 * hidden + j, d[2]);
    store_f32(row + 3 * hidden + j, d[3]);
    store_f32(dc_prev + e, dcp);
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

// ---------------------------------------------------------------------------
// the persistent recurrence
// ---------------------------------------------------------------------------

constexpr int kSeqThreads = 256;
constexpr int kSeqElems = 2;          // (row, unit) cells a thread owns
constexpr int kSmemLimit = 232448;    // dynamic shared memory of one block
constexpr int kErrNoCluster = 10000;  // no cluster of the launch fits an SM

// Elements of a shared-memory row of `len` values: zero-padded to the
// product's depth step (4 floats, or 16 bf16 for mma k16), then to a row
// pitch of 16 mod 32 bytes, so the rows a warp reads at once fall in
// distinct banks.  kernels/lstm_cell.py _pitch computes the same.
__host__ __device__ inline int seq_pitch(int len, int size) {
  const int step = size == 4 ? 4 : 16;
  int p = (len + step - 1) / step * step;
  if ((p * size) % 32 == 0) p += 16 / size;
  return p;
}

__host__ __device__ inline int seq_depth(int len, int size) {
  const int step = size == 4 ? 4 : 16;
  return (len + step - 1) / step * step;
}

// dynamic shared memory bytes: forward W rows (4U x pitch(H)), h
// double-buffer, float32 gate sums; backward W^T (H x pitch(4U)), dgates
// tile, float32 partial-product double-buffer
__host__ __device__ inline int64_t seq_smem(int hidden, int cluster,
                                            int rows, int size, bool bwd) {
  const int units = (hidden + cluster - 1) / cluster;
  const int R = 4 * units;
  if (!bwd) {
    const int ph = seq_pitch(hidden, size);
    return (int64_t)R * ph * size + 2LL * rows * ph * size +
           (int64_t)rows * R * 4;
  }
  const int pr = seq_pitch(R, size);
  return (int64_t)hidden * pr * size + (int64_t)rows * pr * size +
         2LL * rows * hidden * 4;
}

// out[j * ldo + i] = sum_k A[i * lda + k] * B[j * ldb + k] for i < MA,
// j < MB over the zero-padded depth Lp, A and B in shared memory; every
// thread of the block calls it.  float32: each thread a 4 x MJ tile, rows
// i strided by ti so a warp's lanes read neighbouring rows; the depth's
// 16-byte chunks split over S lanes of one warp, summed by xor shuffles.
template <int MJ>
__device__ __forceinline__ void gemm_f32(const float* A, int lda, int MA,
                                         const float* B, int ldb, int MB,
                                         int Lp, float* out, int ldo) {
  constexpr int MI = 4;
  const int ti = (MA + MI - 1) / MI, tj = (MB + MJ - 1) / MJ;
  const int tiles = ti * tj;
  const int chunks = Lp / 4;
  int S = 1;
  while (S < 32 && tiles * S * 2 <= kSeqThreads && S * 2 <= chunks) S *= 2;
  const int lane_s = threadIdx.x % S;
  const int per_round = kSeqThreads / S;
  for (int base = 0; base < tiles; base += per_round) {
    const int tile = base + threadIdx.x / S;
    const bool live = tile < tiles;
    const int tc = live ? tile : tiles - 1;
    const int ib = tc % ti, j0 = (tc / ti) * MJ;
    const float4* a[MI];
    const float4* b[MJ];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      a[mi] = reinterpret_cast<const float4*>(
          A + min(ib + mi * ti, MA - 1) * lda);
#pragma unroll
    for (int mj = 0; mj < MJ; ++mj)
      b[mj] = reinterpret_cast<const float4*>(B + min(j0 + mj, MB - 1) * ldb);
    float acc[MI][MJ];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int mj = 0; mj < MJ; ++mj) acc[mi][mj] = 0.f;
#pragma unroll 2
    for (int c = lane_s; c < chunks; c += S) {
      float4 av[MI], bv[MJ];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) av[mi] = a[mi][c];
#pragma unroll
      for (int mj = 0; mj < MJ; ++mj) bv[mj] = b[mj][c];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int mj = 0; mj < MJ; ++mj) {
          float s = acc[mi][mj];
          s = fmaf(av[mi].x, bv[mj].x, s);
          s = fmaf(av[mi].y, bv[mj].y, s);
          s = fmaf(av[mi].z, bv[mj].z, s);
          s = fmaf(av[mi].w, bv[mj].w, s);
          acc[mi][mj] = s;
        }
    }
    for (int off = S / 2; off > 0; off >>= 1)
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int mj = 0; mj < MJ; ++mj)
          acc[mi][mj] += __shfl_xor_sync(0xffffffffu, acc[mi][mj], off);
    if (live && lane_s == 0) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int mj = 0; mj < MJ; ++mj) {
          const int i = ib + mi * ti, j = j0 + mj;
          if (i < MA && j < MB) out[j * ldo + i] = acc[mi][mj];
        }
    }
  }
}

// MJ covers the batch tile's rows (up to 4 at once), so the depth splits
// over as many lanes as the block has threads for
__device__ __forceinline__ void block_gemm(const float* A, int lda, int MA,
                                           const float* B, int ldb, int MB,
                                           int Lp, float* out, int ldo) {
  switch (MB) {
    case 1:
      gemm_f32<1>(A, lda, MA, B, ldb, MB, Lp, out, ldo);
      break;
    case 2:
      gemm_f32<2>(A, lda, MA, B, ldb, MB, Lp, out, ldo);
      break;
    case 3:
      gemm_f32<3>(A, lda, MA, B, ldb, MB, Lp, out, ldo);
      break;
    default:
      gemm_f32<4>(A, lda, MA, B, ldb, MB, Lp, out, ldo);
  }
}

// acc += A (16 x 16, rows a_lo and a_hi = a_lo + 8 rows) . B (16 x 8, the
// transposed rows at b), one mma.sync m16n8k16 with bf16 inputs and float32
// accumulators; the pointers are this lane's (row g, k 2q) elements
__device__ __forceinline__ void mma_bf16(float (&acc)[4],
                                         const __nv_bfloat16* a_lo,
                                         const __nv_bfloat16* a_hi,
                                         const __nv_bfloat16* b) {
  const uint32_t a0 = *reinterpret_cast<const uint32_t*>(a_lo);
  const uint32_t a1 = *reinterpret_cast<const uint32_t*>(a_hi);
  const uint32_t a2 = *reinterpret_cast<const uint32_t*>(a_lo + 8);
  const uint32_t a3 = *reinterpret_cast<const uint32_t*>(a_hi + 8);
  const uint32_t b0 = *reinterpret_cast<const uint32_t*>(b);
  const uint32_t b1 = *reinterpret_cast<const uint32_t*>(b + 8);
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bfloat16: one warp per 16 x 8 output tile (A rows x B rows), mma.sync
// m16n8k16 over the depth, float32 accumulators; fragments read from
// shared memory as 32-bit pairs (pitch 16 mod 32 bytes: no bank conflict)
__device__ __forceinline__ void block_gemm(const __nv_bfloat16* A, int lda,
                                           int MA, const __nv_bfloat16* B,
                                           int ldb, int MB, int Lp,
                                           float* out, int ldo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const int tm = (MA + 15) / 16, tn = (MB + 7) / 8;
  for (int tile = warp; tile < tm * tn; tile += kSeqThreads / 32) {
    const int m0 = (tile % tm) * 16, n0 = (tile / tm) * 8;
    const __nv_bfloat16* a_lo = A + min(m0 + g, MA - 1) * lda + 2 * q;
    const __nv_bfloat16* a_hi = A + min(m0 + g + 8, MA - 1) * lda + 2 * q;
    const __nv_bfloat16* bp = B + min(n0 + g, MB - 1) * ldb + 2 * q;
    // two accumulator chains (even and odd k-steps), summed at the end:
    // consecutive mma.sync do not wait on each other
    float c[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
    int k0 = 0;
#pragma unroll 2
    for (; k0 + 16 < Lp; k0 += 32) {
      mma_bf16(c, a_lo + k0, a_hi + k0, bp + k0);
      mma_bf16(d, a_lo + k0 + 16, a_hi + k0 + 16, bp + k0 + 16);
    }
    if (k0 < Lp) mma_bf16(c, a_lo + k0, a_hi + k0, bp + k0);
#pragma unroll
    for (int r = 0; r < 4; ++r) c[r] += d[r];
    // c0, c1: row m0 + g, columns n0 + 2q, +1; c2, c3: row m0 + g + 8
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = m0 + g + (r >= 2 ? 8 : 0), j = n0 + 2 * q + (r & 1);
      if (i < MA && j < MB) out[j * ldo + i] = c[r];
    }
  }
}

// zero `bytes` (a multiple of 16) of shared memory from p
__device__ void zero_shared(void* p, int64_t bytes) {
  float4* v = static_cast<float4*>(p);
  for (int64_t x = threadIdx.x; x < bytes / 16; x += kSeqThreads)
    v[x] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dst_of(r)[m * step] = src_of(r)[m] for r < nrows, m < len: rows of
// global memory into shared memory, a warp 4 rows at a time, 16 loads a
// lane in flight before their stores (the tail's missing rows repeat the
// last one, which writes the same values twice)
template <typename T, typename Src, typename Dst>
__device__ __forceinline__ void stage_rows(int nrows, int len, int step,
                                           Src src_of, Dst dst_of) {
  constexpr int kRows = 4, kCols = 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r0 = warp * kRows; r0 < nrows; r0 += kSeqThreads / 32 * kRows) {
    const T* src[kRows];
    T* dst[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      src[i] = src_of(min(r0 + i, nrows - 1));
      dst[i] = dst_of(min(r0 + i, nrows - 1));
    }
    for (int m0 = lane; m0 < len; m0 += 32 * kCols) {
      T v[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (m0 + 32 * c < len) v[i][c] = src[i][m0 + 32 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (m0 + 32 * c < len)
            dst[i][(int64_t)(m0 + 32 * c) * step] = v[i][c];
    }
  }
}

// the two halves of a cluster barrier: arrive publishes this thread's
// earlier writes (release), wait sees every block's (acquire); work that
// touches no shared memory may run between them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kSeqThreads, 1) lstm_seq_fwd_kernel(
    const T* __restrict__ xg, const T* __restrict__ w,
    const T* __restrict__ h0, const T* __restrict__ c0, T* __restrict__ hs,
    T* __restrict__ cs, T* __restrict__ gates, T* __restrict__ hT,
    T* __restrict__ cT, int steps, int batch, int hidden, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int k = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / K) * rows;
  const int nt = min(rows, batch - n0);
  const int U = (hidden + K - 1) / K;
  const int j0 = k * U;
  const int uk = max(0, min(U, hidden - j0));
  const int R = 4 * U;
  const int ph = seq_pitch(hidden, (int)sizeof(T));
  const int depth = seq_depth(hidden, (int)sizeof(T));
  T* w_s = reinterpret_cast<T*>(smem);                // [R][ph]
  T* h_s = w_s + (int64_t)R * ph;                     // [2][rows][ph]
  float* pre_s = reinterpret_cast<float*>(h_s + 2LL * rows * ph);  // [rows][R]
  const int64_t H4 = 4LL * hidden;

  zero_shared(smem, seq_smem(hidden, K, rows, (int)sizeof(T), false));
  __syncthreads();
  // W's rows for this block's units, then the h0 tile
  stage_rows<T>(
      4 * uk + nt, hidden, 1,
      [&](int r) {
        return r < 4 * uk
                   ? w + (int64_t)((r / uk) * hidden + j0 + r % uk) * hidden
                   : h0 + (int64_t)(n0 + r - 4 * uk) * hidden;
      },
      [&](int r) {
        return r < 4 * uk ? w_s + (int64_t)((r / uk) * U + r % uk) * ph
                          : h_s + (int64_t)(r - 4 * uk) * ph;
      });
  // the cells (row n of the tile, unit u) this thread owns, n = -1 for
  // none; per cell c, h, the pre-activations and xg[t], whose loads for
  // the next step are issued as soon as this step has read them
  const int cells = nt * uk;
  int cn[kSeqElems], cu[kSeqElems];
  float c_reg[kSeqElems], h_reg[kSeqElems], p_reg[kSeqElems][4],
      x[kSeqElems][4];
#pragma unroll
  for (int s = 0; s < kSeqElems; ++s) {
    const int e = threadIdx.x + s * kSeqThreads;
    cn[s] = e < cells ? e / uk : -1;
    cu[s] = e < cells ? e % uk : 0;
    c_reg[s] = h_reg[s] = 0.f;
  }
  auto load_x = [&](int t, int s) {
    const T* at = xg + ((int64_t)t * batch + n0 + cn[s]) * H4 + j0 + cu[s];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
      x[s][gate] = load_f32(at + gate * hidden);
  };
#pragma unroll
  for (int s = 0; s < kSeqElems; ++s) {
    if (cn[s] >= 0) {
      c_reg[s] = load_f32(c0 + (int64_t)(n0 + cn[s]) * hidden + j0 + cu[s]);
      load_x(0, s);
    }
  }
  // every block of the cluster runs (its shared memory may be written)
  // and this block's W and h0 are in place
  cluster.sync();

  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    block_gemm(w_s, ph, R, h_s + (int64_t)cur * rows * ph, ph, nt, depth,
               pre_s, R);
    __syncthreads();
    T* h_next = h_s + (int64_t)(cur ^ 1) * rows * ph;
#pragma unroll
    for (int s = 0; s < kSeqElems; ++s) {
      if (cn[s] >= 0) {
        const int n = cn[s], u = cu[s];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          p_reg[s][gate] =
              round_to<T>(add(pre_s[n * R + gate * U + u], x[s][gate]));
        if (t + 1 < steps) load_x(t + 1, s);
        float h, c;
        cell_forward(activate(p_reg[s][0], p_reg[s][1], p_reg[s][2],
                              p_reg[s][3]),
                     c_reg[s], h, c);
        c_reg[s] = round_to<T>(c);
        h_reg[s] = round_to<T>(h);
        T hv;
        store_f32(&hv, h);
        for (int rank = 0; rank < K; ++rank)
          cluster.map_shared_rank(h_next, rank)[(int64_t)n * ph + j0 + u] = hv;
      }
    }
    // arrive publishes h_t to every block and says this block is done
    // with pre_s and h_s[cur]; the global stores overlap the barrier
    cluster_arrive();
#pragma unroll
    for (int s = 0; s < kSeqElems; ++s) {
      if (cn[s] >= 0) {
        const int64_t row = n0 + cn[s];
        const int64_t at = ((int64_t)t * batch + row) * hidden + j0 + cu[s];
        store_f32(hs + at, h_reg[s]);
        store_f32(cs + at, c_reg[s]);
        if (gates != nullptr) {
          T* g = gates + ((int64_t)t * batch + row) * H4 + j0 + cu[s];
#pragma unroll
          for (int gate = 0; gate < 4; ++gate)
            store_f32(g + gate * hidden, p_reg[s][gate]);
        }
      }
    }
    cluster_wait();
  }
#pragma unroll
  for (int s = 0; s < kSeqElems; ++s) {
    if (cn[s] >= 0) {
      const int64_t at = (int64_t)(n0 + cn[s]) * hidden + j0 + cu[s];
      store_f32(hT + at, h_reg[s]);
      store_f32(cT + at, c_reg[s]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kSeqThreads, 1) lstm_seq_bwd_kernel(
    const T* __restrict__ gates, const T* __restrict__ c_prev,
    const T* __restrict__ w, const T* __restrict__ dhs,
    const T* __restrict__ dhT, const T* __restrict__ dcT,
    T* __restrict__ dgates, T* __restrict__ dh0, T* __restrict__ dc0,
    int steps, int batch, int hidden, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int k = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / K) * rows;
  const int nt = min(rows, batch - n0);
  const int U = (hidden + K - 1) / K;
  const int j0 = k * U;
  const int uk = max(0, min(U, hidden - j0));
  const int R = 4 * U;
  const int pr = seq_pitch(R, (int)sizeof(T));
  const int depth = seq_depth(R, (int)sizeof(T));
  T* wt_s = reinterpret_cast<T*>(smem);               // [hidden][pr]
  T* dg_s = wt_s + (int64_t)hidden * pr;              // [rows][pr]
  float* p_s = reinterpret_cast<float*>(dg_s + (int64_t)rows * pr);
  // p_s: [2][rows][hidden], block k's partial dgates[:, R_k] . W[R_k, :]
  const int64_t H4 = 4LL * hidden;

  zero_shared(smem, seq_smem(hidden, K, rows, (int)sizeof(T), true));
  __syncthreads();
  // W's rows for this block's units, written as columns of W^T
  stage_rows<T>(
      4 * uk, hidden, pr,
      [&](int r) {
        return w + (int64_t)((r / uk) * hidden + j0 + r % uk) * hidden;
      },
      [&](int r) { return wt_s + (r / uk) * U + r % uk; });

  const int cells = nt * uk;
  // the cells (row n of the tile, unit u) this thread owns, n = -1 for
  // none; per cell the dc chain, the recurrent dh, this step's dgates and
  // its inputs (4 gates, c_prev, dhs), whose loads for the previous step
  // are issued as soon as this step has read them
  int cn[kSeqElems], cu[kSeqElems];
  float dc[kSeqElems], dh_rec[kSeqElems], d_reg[kSeqElems][4],
      in[kSeqElems][6];
  auto load_in = [&](int t, int s) {
    const int64_t tb = (int64_t)t * batch + n0 + cn[s];
    const int j = j0 + cu[s];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
      in[s][gate] = load_f32(gates + tb * H4 + gate * hidden + j);
    in[s][4] = load_f32(c_prev + tb * hidden + j);
    in[s][5] = load_f32(dhs + tb * hidden + j);
  };
#pragma unroll
  for (int s = 0; s < kSeqElems; ++s) {
    const int e = threadIdx.x + s * kSeqThreads;
    cn[s] = e < cells ? e / uk : -1;
    cu[s] = e < cells ? e % uk : 0;
    dc[s] = dh_rec[s] = 0.f;
    if (cn[s] >= 0) {
      const int64_t at = (int64_t)(n0 + cn[s]) * hidden + j0 + cu[s];
      dc[s] = load_f32(dcT + at);
      dh_rec[s] = load_f32(dhT + at);
      load_in(steps - 1, s);
    }
  }
  cluster.sync();

  for (int t = steps - 1; t >= 0; --t) {
#pragma unroll
    for (int s = 0; s < kSeqElems; ++s) {
      if (cn[s] >= 0) {
        const int n = cn[s], u = cu[s];
        const float dh = round_to<T>(add(in[s][5], dh_rec[s]));
        const Gates a = activate(in[s][0], in[s][1], in[s][2], in[s][3]);
        const float cp = in[s][4];
        if (t > 0) load_in(t - 1, s);
        float dcp;
        cell_backward(a, cp, dh, dc[s], d_reg[s], dcp);
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          d_reg[s][gate] = round_to<T>(d_reg[s][gate]);
          store_f32(dg_s + n * pr + gate * U + u, d_reg[s][gate]);
        }
        dc[s] = round_to<T>(dcp);
      }
    }
    __syncthreads();
    float* p_buf = p_s + (int64_t)(t & 1) * rows * hidden;
    block_gemm(wt_s, pr, hidden, dg_s, pr, nt, depth, p_buf, hidden);
    // arrive says this block's partial product is in place and its dg_s
    // free; the global stores overlap the barrier
    cluster_arrive();
#pragma unroll
    for (int s = 0; s < kSeqElems; ++s) {
      if (cn[s] >= 0) {
        T* out = dgates + ((int64_t)t * batch + n0 + cn[s]) * H4 + j0 +
                 cu[s];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          store_f32(out + gate * hidden, d_reg[s][gate]);
      }
    }
    cluster_wait();
#pragma unroll
    for (int s = 0; s < kSeqElems; ++s) {
      if (cn[s] >= 0) {
        const int at = cn[s] * hidden + j0 + cu[s];
        float sum = 0.f;
        for (int rank = 0; rank < K; ++rank)
          sum = add(sum, cluster.map_shared_rank(p_buf, rank)[at]);
        dh_rec[s] = round_to<T>(sum);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kSeqElems; ++s) {
    if (cn[s] >= 0) {
      const int64_t at = (int64_t)(n0 + cn[s]) * hidden + j0 + cu[s];
      store_f32(dh0 + at, dh_rec[s]);
      store_f32(dc0 + at, dc[s]);
    }
  }
  // no block leaves while another may still read its partial products
  cluster.sync();
}

// the launch configuration of a persistent kernel: one block of
// kSeqThreads threads a (cluster, batch tile), clusters of `cluster` blocks
struct SeqLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  SeqLaunch(int64_t clusters, int cluster, int64_t smem, cudaStream_t s) {
    cfg = {};
    cfg.gridDim = dim3((unsigned)(clusters * cluster), 1, 1);
    cfg.blockDim = dim3(kSeqThreads, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of this configuration the device holds at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.  The
// kernel's attributes are set once per kernel and device (the largest
// shared memory any plan asks for, so a smaller launch never lowers a
// larger one's) and the count is cached per configuration.
template <typename Kernel>
int seq_resident(Kernel kernel, int key, SeqLaunch& launch, int cluster) {
  static std::mutex lock;
  static std::map<std::tuple<int, int, int, int>, int> known;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return -(int)e;
  std::lock_guard<std::mutex> guard(lock);
  const auto attrs = std::make_tuple(device, key, 0, -1);
  if (known.find(attrs) == known.end()) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return -(int)e;
    known.emplace(attrs, 1);
  }
  const auto at = std::make_tuple(device, key, cluster,
                                  (int)launch.cfg.dynamicSmemBytes);
  auto found = known.find(at);
  if (found == known.end()) {
    int resident = 0;
    e = cudaOccupancyMaxActiveClusters(&resident, (void*)kernel, &launch.cfg);
    if (e != cudaSuccess) return -(int)e;
    found = known.emplace(at, resident).first;
  }
  return found->second;
}

// Checks a plan: a cluster size the card takes, a tile of rows whose cells
// the threads hold, shared memory one block holds.  Returns 0 or an error.
int seq_check(int64_t batch, int hidden, int cluster, int rows, int size,
              bool bwd) {
  if (cluster < 1 || cluster > 16 || rows < 1 || hidden < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const int units = (hidden + cluster - 1) / cluster;
  if ((int64_t)rows * units > (int64_t)kSeqThreads * kSeqElems)
    return (int)cudaErrorInvalidValue;
  if (seq_smem(hidden, cluster, rows, size, bwd) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if ((batch + rows - 1) / rows * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// one launch of a persistent kernel: the plan's checks, the device's
// cluster occupancy, and cudaLaunchKernelEx with the cluster dimension
template <typename Kernel, typename... Args>
int launch_seq(Kernel kernel, int key, int64_t batch, int hidden, int cluster,
               int rows, int size, bool bwd, cudaStream_t s, Args... args) {
  const int bad = seq_check(batch, hidden, cluster, rows, size, bwd);
  if (bad) return bad;
  SeqLaunch launch((batch + rows - 1) / rows, cluster,
                   seq_smem(hidden, cluster, rows, size, bwd), s);
  const int resident = seq_resident(kernel, key, launch, cluster);
  if (resident < 0) return -resident;
  if (resident < 1) return kErrNoCluster;
  cudaError_t e = cudaLaunchKernelEx(&launch.cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
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

// Shared-memory bytes of one block of the persistent kernels (forward, or
// backward when bwd != 0), for the wrapper to hold its plan against.
extern "C" long long mxt_lstm_seq_smem(long long hidden, int cluster,
                                       int rows, int dtype, int bwd) {
  if (hidden < 1 || cluster < 1 || rows < 1) return -1;
  return seq_smem((int)hidden, cluster, rows, dtype == kBFloat16 ? 2 : 4,
                  bwd != 0);
}

// Clusters of the persistent kernel (forward, or backward when bwd != 0)
// the device holds at once for this plan (cudaOccupancyMaxActiveClusters),
// or a negative CUDA error.
extern "C" int mxt_lstm_seq_resident(long long batch, long long hidden,
                                     int cluster, int rows, int dtype,
                                     int bwd) {
  const int size = dtype == kBFloat16 ? 2 : 4;
  if (hidden > 0x7fffffffLL || (dtype != kFloat32 && dtype != kBFloat16))
    return -(int)cudaErrorInvalidValue;
  const int bad = seq_check(batch, (int)hidden, cluster, rows, size, bwd);
  if (bad) return -bad;
  SeqLaunch launch((batch + rows - 1) / rows, cluster,
                   seq_smem((int)hidden, cluster, rows, size, bwd != 0),
                   nullptr);
  if (dtype == kFloat32)
    return bwd ? seq_resident(lstm_seq_bwd_kernel<float>, 2, launch, cluster)
               : seq_resident(lstm_seq_fwd_kernel<float>, 0, launch, cluster);
  return bwd ? seq_resident(lstm_seq_bwd_kernel<__nv_bfloat16>, 3, launch,
                            cluster)
             : seq_resident(lstm_seq_fwd_kernel<__nv_bfloat16>, 1, launch,
                            cluster);
}

// xg, gates: (steps, batch, 4 * hidden); w: (4 * hidden, hidden); h0, c0,
// hT, cT: (batch, hidden); hs, cs: (steps, batch, hidden).  gates may be
// null (no gradient wanted).  `cluster` blocks a cluster, `rows` batch rows
// a cluster.
extern "C" int mxt_lstm_seq_fwd(const void* xg, const void* w, const void* h0,
                                const void* c0, void* hs, void* cs,
                                void* gates, void* hT, void* cT,
                                long long steps, long long batch,
                                long long hidden, int cluster, int rows,
                                int dtype, void* stream) {
  if (steps < 1 || steps > 0x7fffffffLL || batch > 0x7fffffffLL ||
      hidden > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_seq(lstm_seq_fwd_kernel<float>, 0, batch, (int)hidden,
                      cluster, rows, 4, false, s,
                      static_cast<const float*>(xg),
                      static_cast<const float*>(w),
                      static_cast<const float*>(h0),
                      static_cast<const float*>(c0), static_cast<float*>(hs),
                      static_cast<float*>(cs), static_cast<float*>(gates),
                      static_cast<float*>(hT), static_cast<float*>(cT),
                      (int)steps, (int)batch, (int)hidden, rows);
  if (dtype == kBFloat16) {
    using B = __nv_bfloat16;
    return launch_seq(lstm_seq_fwd_kernel<B>, 1, batch, (int)hidden, cluster,
                      rows, 2, false, s, static_cast<const B*>(xg),
                      static_cast<const B*>(w), static_cast<const B*>(h0),
                      static_cast<const B*>(c0), static_cast<B*>(hs),
                      static_cast<B*>(cs), static_cast<B*>(gates),
                      static_cast<B*>(hT), static_cast<B*>(cT), (int)steps,
                      (int)batch, (int)hidden, rows);
  }
  return (int)cudaErrorInvalidValue;
}

// gates, dgates: (steps, batch, 4 * hidden); c_prev, dhs: (steps, batch,
// hidden), c_prev[t] the cell before step t; w: (4 * hidden, hidden); dhT,
// dcT, dh0, dc0: (batch, hidden).
extern "C" int mxt_lstm_seq_bwd(const void* gates, const void* c_prev,
                                const void* w, const void* dhs,
                                const void* dhT, const void* dcT,
                                void* dgates, void* dh0, void* dc0,
                                long long steps, long long batch,
                                long long hidden, int cluster, int rows,
                                int dtype, void* stream) {
  if (steps < 1 || steps > 0x7fffffffLL || batch > 0x7fffffffLL ||
      hidden > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_seq(lstm_seq_bwd_kernel<float>, 2, batch, (int)hidden,
                      cluster, rows, 4, true, s,
                      static_cast<const float*>(gates),
                      static_cast<const float*>(c_prev),
                      static_cast<const float*>(w),
                      static_cast<const float*>(dhs),
                      static_cast<const float*>(dhT),
                      static_cast<const float*>(dcT),
                      static_cast<float*>(dgates), static_cast<float*>(dh0),
                      static_cast<float*>(dc0), (int)steps, (int)batch,
                      (int)hidden, rows);
  if (dtype == kBFloat16) {
    using B = __nv_bfloat16;
    return launch_seq(lstm_seq_bwd_kernel<B>, 3, batch, (int)hidden, cluster,
                      rows, 2, true, s, static_cast<const B*>(gates),
                      static_cast<const B*>(c_prev), static_cast<const B*>(w),
                      static_cast<const B*>(dhs), static_cast<const B*>(dhT),
                      static_cast<const B*>(dcT), static_cast<B*>(dgates),
                      static_cast<B*>(dh0), static_cast<B*>(dc0), (int)steps,
                      (int)batch, (int)hidden, rows);
  }
  return (int)cudaErrorInvalidValue;
}
