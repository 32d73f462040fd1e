// Flash attention forward (tiled online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/kernels/flash_attention.py:137-220
// (_flash_pallas_fwd, whose pl.pallas_call at :214 runs _flash_kernel).
// For q (B, Tq, H, D) and k, v (B, Tk, H, D), float32 or bfloat16, it
// writes o (B, Tq, H, D) in q's dtype:
//   o[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h], masked) v[b, j, h]
// with float32 softmax and accumulation, the mask `j < Tk` and, when
// causal, `i + (Tk - Tq) >= j` (the bottom-right aligned convention of
// full_attention).  Every route keeps, per query row, a running (max m,
// sum s, acc) with the JAX kernel's guards: a fully masked key chunk moves
// nothing, the rescale factor is 0 while m is still -inf, and the output
// is acc / max(s, 1e-20), so a row that sees no key is 0, not NaN.
//
// Three device routes behind two C entries (the Python wrapper picks the
// route from the dtype and D, kernels/flash_attention.py flash_route):
//
// 1. mma_bf16 (mxt_flash_attention_fwd, bfloat16, D <= 128): tensor
//    cores.  Bound at the model's shape (B 4, T 4096, H 4, D 16, causal):
//    not the products (4 B H Tq Tk D / 2 flops, 9 us at 989 TFLOP/s) but
//    the exponentials, one ex2 per visible (query, key) pair at 16 per
//    clock per SM (CUDA C Programming Guide, throughput of native
//    arithmetic instructions, compute capability 9.0): about 32 us.  So
//    the design keeps everything else off the critical path: 4 warps per
//    block, 16 query rows per warp, 64 rows per block; K and V tiles of
//    64 keys brought into shared memory by cp.async (16 bytes a thread),
//    double-buffered so the next tile's copy overlaps this tile's
//    products; fragments read with ldmatrix (V with .trans); S = Q K^T by
//    mma.sync.m16n8k16 (bf16 in, float32 accumulate) stays in registers;
//    the online softmax runs on the accumulator fragment (row max and sum
//    over the 4 lanes of a quad, the sum reduced once at the end); the
//    max is taken over the raw scores (q's sign flipped for a negative
//    scale), and one FFMA folds scale * log2(e) into the argument of
//    exp2 (ex2.approx on the special-function unit); P is converted to bf16
//    A-fragments in registers for O += P V.  P is rounded to bfloat16
//    before the second product, as the flash backend of PyTorch's
//    scaled_dot_product_attention does; the row sum s is taken from the
//    float32 P.
// 2. tiled_f32 (mxt_flash_attention_fwd, float32, D <= 128): float32 FFMA
//    (TF32 stays off: float32 means float32 in this package).  Bound: the
//    products, 4 B H Tq Tk D / 2 flops at 67 TFLOP/s (138 us at the
//    model's shape), and under them the shared-memory loads that feed the
//    FMAs.  A block of 128 threads owns 64 query rows (32 rows at D 128,
//    for more blocks); Q, K and V tiles go through shared memory by
//    cp.async, K and V double-buffered.  Each thread computes a 4 x 8
//    micro-tile of scores (2 x 4 at D 128, 32-key tiles) from float4
//    shared loads: 12 loads feed 128 FMAs.  P goes through shared memory
//    (transposed, so a thread reads 4 rows in one float4) into a second
//    register tile of 4 rows x TD dims of O (TD 4 to 16); at D 16 and at
//    D 128 two threads split each tile's keys and add their sums once at
//    the end.
// 3. rowwise (mxt_flash_attention_fwd_rowwise, both dtypes, D <= 256): the
//    first kernel of this file, one query row per group of lanes, K and V
//    converted to float32 in shared memory, FFMA.  It takes D in
//    (128, 256], and stays callable at every D as the yardstick of the
//    tiled routes.
//
// Loads: the tiled routes stage a tile with 16-byte cp.async when every
// row start is 16-byte aligned (base pointers, and the b, t and h strides
// times the element size, over dims longer than 1) and a row of D elements
// is a whole number of 16-byte chunks; otherwise (D 5, D 12 in bfloat16,
// or a misaligned view the caller did not copy) they stage it with
// element loads, a template choice.  D is padded with zeros in shared
// memory to the instantiated width (16, 32, 64 or 128), and key rows past
// Tk are zeros, so no padding copy exists in device memory.  The 1-D grid
// runs the heaviest causal query tiles of every head first (in the order
// of a (tile, head, batch) grid the last heads' long tiles start late and
// set the tail), and a causal key tile that lies wholly above the
// diagonal is never loaded (its probabilities are all zero).  wgmma, TMA
// and warp specialisation are left for later: at D <= 128 a well-fed
// mma.sync kernel is what SDPA's own flash backend is.
//
// C interface (bound with ctypes): strides in elements, the head dim's
// stride must be 1; the output is contiguous.  A function launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <cmath>

namespace {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
};

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// PTX helpers: cp.async, ldmatrix, mma.sync, bf16 packing
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register round trip; an invalid
// chunk reads nothing and writes 16 zero bytes
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)) : "memory");
}

// c (16 x 8, float32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16,
// column-major)
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a b, the accumulator starting from 0 (no registers to clear)
__device__ __forceinline__ void mma_16816_zero(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// two floats rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// 2^x on the special-function unit (2 ulp, subnormal results flushed to
// 0: a probability below 2^-126 of the row's largest); 2^-inf = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T> __device__ __forceinline__ T zero_value();
template <> __device__ __forceinline__ float zero_value<float>() {
  return 0.f;
}
template <> __device__ __forceinline__ bf16 zero_value<bf16>() {
  return __float2bfloat16(0.f);
}

// Stage rows [row0, row0 + ROWS) of one head of a (B, T, H, D) tensor
// (`g` points at its row 0, rows `stride_t` elements apart) into shared
// memory, PITCH elements a row, DP columns; rows at or past `nrows` and
// columns at or past `d` are zeros.  VEC: 16-byte cp.async chunks (row
// starts 16-byte aligned, d a whole number of chunks); else element loads.
template <typename T, int ROWS, int DP, int PITCH, int NT, bool VEC>
__device__ __forceinline__ void stage_tile(T* sm, const T* g,
                                           long long stride_t, int row0,
                                           int nrows, int d, int tid) {
  if constexpr (VEC) {
    constexpr int EPC = 16 / sizeof(T);  // elements per chunk
    constexpr int CPR = DP / EPC;        // chunks per row
    constexpr int TOTAL = ROWS * CPR;
#pragma unroll
    for (int i = 0; i < (TOTAL + NT - 1) / NT; ++i) {
      const int c = tid + i * NT;
      if (TOTAL % NT == 0 || c < TOTAL) {
        const int r = c / CPR;
        const int col = (c % CPR) * EPC;
        const bool ok = row0 + r < nrows && col < d;
        const T* src = ok ? g + (long long)(row0 + r) * stride_t + col : g;
        cp_async_16(sm + r * PITCH + col, src, ok);
      }
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < ROWS * DP; e += NT) {
      const int r = e / DP;
      const int col = e % DP;
      T val = zero_value<T>();
      if (row0 + r < nrows && col < d)
        val = g[(long long)(row0 + r) * stride_t + col];
      sm[r * PITCH + col] = val;
    }
  }
}

// K and V rows of key tile `t` (BN keys) into pipeline slot t % STAGES
template <typename T, int BN, int DP, int PITCH, int NT, int STAGES, bool VEC>
__device__ __forceinline__ void stage_kv(T* ks, T* vs, int t, const T* kg,
                                         const T* vg, long long kstride,
                                         long long vstride, int tk, int d,
                                         int tid) {
  const int slot = (t % STAGES) * BN * PITCH;
  stage_tile<T, BN, DP, PITCH, NT, VEC>(ks + slot, kg, kstride, t * BN, tk,
                                        d, tid);
  stage_tile<T, BN, DP, PITCH, NT, VEC>(vs + slot, vg, vstride, t * BN, tk,
                                        d, tid);
}

// key tiles (of bn keys) any row of the query tile [q0, q0 + rows) sees
__device__ __forceinline__ int visible_tiles(int q0, int rows, int tq,
                                             int tk, int causal, int bn) {
  long long kend = tk;
  if (causal) {
    const int q_last = (q0 + rows < tq ? q0 + rows : tq) - 1;
    const long long visible = q_last + ((long long)tk - tq) + 1;
    if (visible < kend) kend = visible;
  }
  return kend > 0 ? (int)((kend + bn - 1) / bn) : 0;
}

// ---------------------------------------------------------------------------
// route mma_bf16: bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

namespace mma {

constexpr int BM = 64;   // query rows per block, 16 per warp
constexpr int BN = 64;   // keys per tile
constexpr int NT = 128;  // 4 warps

template <int DP>
struct Cfg {
  static constexpr int PITCH = DP + 8;  // bf16 a row: 16 bytes of pad keep
                                        // ldmatrix's 8 rows on 8 bank groups
  static constexpr int KD = DP / 16;    // k-steps of S = Q K^T
  static constexpr int NS = BN / 8;     // 8-key n-blocks of S
  static constexpr int ND = DP / 8;     // 8-dim n-blocks of O
  static constexpr int STAGES = 2;  // K/V slots: double-buffered
  static constexpr int SMEM = (BM + 2 * STAGES * BN) * PITCH * 2;
};

template <int DP, bool VEC>
__global__ void __launch_bounds__(NT)
flash_attention_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           bf16* __restrict__ o, int tq, int tk, int heads,
                           int d, Strides st, int causal, float scale_log2) {
  using C = Cfg<DP>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BM * C::PITCH;              // STAGES slots of BN rows
  bf16* vs = ks + C::STAGES * BN * C::PITCH;  // STAGES slots of BN rows

  // one block per (query tile, head, batch), in the order of the 1-D
  // grid: the heaviest causal tiles of every head first
  const int nq = (tq + BM - 1) / BM;
  const int bh_count = gridDim.x / nq;
  const int tile = nq - 1 - (int)(blockIdx.x / bh_count);
  const int h = (int)(blockIdx.x % bh_count) % heads;
  const int b = (int)(blockIdx.x % bh_count) / heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = tile * BM;
  const long long offset = (long long)tk - tq;
  const int ntiles = visible_tiles(q0, BM, tq, tk, causal, BN);

  const bf16* qg = q + b * st.qb + h * st.qh;
  const bf16* kg = k + b * st.kb + h * st.kh;
  const bf16* vg = v + b * st.vb + h * st.vh;
  // Q rides with the first key tile; STAGES - 1 tiles go ahead, one
  // cp.async group each
  stage_tile<bf16, BM, DP, C::PITCH, NT, VEC>(qs, qg, st.qt, q0, tq, d, tid);
#pragma unroll
  for (int t = 0; t < C::STAGES - 1; ++t) {
    if (t < ntiles)
      stage_kv<bf16, BN, DP, C::PITCH, NT, C::STAGES, VEC>(
          ks, vs, t, kg, vg, st.kt, st.vt, tk, d, tid);
    cp_async_commit();
  }

  // accumulator fragment: c[0], c[1] at row g, columns c2, c2 + 1 of an
  // 8-column block; c[2], c[3] at row g + 8
  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
  const int row_lo = q0 + warp * 16 + g;

  float acc[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max of the raw scores q.k, with q's sign flipped for a
  // negative scale, so that the scale (in the log2 domain) is positive
  // and folds into the exponent's FFMA
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};  // this lane's share of the row sums
  const uint32_t qsign = scale_log2 < 0.f ? 0x80008000u : 0u;
  const float sl2 = fabsf(scale_log2);
  uint32_t qf[C::KD][4];

#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    // the copy of tile it + STAGES - 1 overlaps the products of this one
    if (it + C::STAGES - 1 < ntiles)
      stage_kv<bf16, BN, DP, C::PITCH, NT, C::STAGES, VEC>(
          ks, vs, it + C::STAGES - 1, kg, vg, st.kt, st.vt, tk, d, tid);
    cp_async_commit();
    cp_async_wait<C::STAGES - 1>();  // tile it (and Q) have landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kd = 0; kd < C::KD; ++kd) {
        ldsm_x4(qf[kd], qs + (warp * 16 + (lane & 15)) * C::PITCH + kd * 16 +
                            (lane >> 4) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[kd][e] ^= qsign;
      }
    }
    const bf16* kt = ks + (it % C::STAGES) * BN * C::PITCH;
    const bf16* vt = vs + (it % C::STAGES) * BN * C::PITCH;

    // S = Q K^T: K rows are the column-major B operand as they lie
    float s[C::NS][4];
#pragma unroll
    for (int kd = 0; kd < C::KD; ++kd) {
#pragma unroll
      for (int n2 = 0; n2 < C::NS / 2; ++n2) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + (n2 * 16 + (lane >> 4) * 8 + (lane & 7)) * C::PITCH +
                        kd * 16 + ((lane >> 3) & 1) * 8);
        if (kd == 0) {
          mma_16816_zero(s[2 * n2], qf[kd], bk[0], bk[1]);
          mma_16816_zero(s[2 * n2 + 1], qf[kd], bk[2], bk[3]);
        } else {
          mma_16816(s[2 * n2], qf[kd], bk[0], bk[1]);
          mma_16816(s[2 * n2 + 1], qf[kd], bk[2], bk[3]);
        }
      }
    }

    // mask only tiles on an edge
    const int k0 = it * BN;
    const bool edge = k0 + BN > tk || (causal && k0 + BN - 1 > q0 + offset);
    if (edge) {
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + c2 + (e & 1);
          const long long row = row_lo + (e >> 1) * 8;
          if (key >= tk || (causal && key > row + offset))
            s[n][e] = -CUDART_INF_F;
        }
      }
    }

    // online softmax on the fragment: rows g and g + 8 of this warp
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < C::NS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = m_run[r] == -CUDART_INF_F
                              ? 0.f
                              : exp2_approx((m_run[r] - m_new) * sl2);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new * sl2;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < C::NS; ++n) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          // p = 2^(scale log2(e) (s - m)); masked: 2^-inf = 0
          const float p = exp2_approx(fmaf(s[n][e], sl2, -m_use));
          s[n][e] = p;
          sum += p;
        }
      }
      l_run[r] = l_run[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < C::ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
      m_run[r] = m_new;
    }

    // O += P V: the S fragments of keys 16 kk .. 16 kk + 15 are the bf16 A
    // fragment, V rows the row-major B operand read with .trans
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < C::ND / 2; ++n2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   C::PITCH + n2 * 16 + (lane >> 4) * 8);
        mma_16816(acc[2 * n2], pa, bv[0], bv[1]);
        mma_16816(acc[2 * n2 + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this slot is read; a later copy may overwrite it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-20f);
    const int row = row_lo + 8 * r;
    if (row >= tq) continue;
    bf16* orow = o + (((long long)b * tq + row) * heads + h) * d;
#pragma unroll
    for (int n = 0; n < C::ND; ++n) {
      const int col = n * 8 + c2;
      const float x0 = acc[n][2 * r] * inv;
      const float x1 = acc[n][2 * r + 1] * inv;
      if ((d & 1) == 0) {
        if (col < d)
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16x2(x0, x1);
      } else {
        if (col < d) orow[col] = __float2bfloat16(x0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

}  // namespace mma

// ---------------------------------------------------------------------------
// route tiled_f32: register-tiled float32 FFMA
// ---------------------------------------------------------------------------

namespace tiled {

template <int DP>
struct Cfg {
  // query rows and keys per block: fewer at D 128, for more blocks
  static constexpr int BM = DP >= 128 ? 32 : 64;
  static constexpr int BN = DP >= 128 ? 32 : 64;
  static constexpr int PITCH = DP + 4;  // floats a Q/K/V row (16 B of pad)
  static constexpr int TX = 8;          // threads over the keys of S
  static constexpr int TM = DP >= 128 ? 2 : 4;  // S rows per thread
  static constexpr int TN = BN / TX;    // S keys per thread
  static constexpr int RG = BM / TM;    // groups of TM rows
  static constexpr int NT = RG * TX;    // threads per block
  // O = P V: P goes through shared memory (transposed, one row per key)
  // into a second register tile, 4 rows x TD dims a thread, KS threads
  // over each tile's keys, their sums added once at the end
  static constexpr int PPITCH = BM + 4; // floats a P^T row
  static constexpr int TD = DP <= 32 ? 4 : DP / 8;  // O dims per thread
  static constexpr int DG = DP / TD;    // threads over the dims of O
  static constexpr int KS = NT / ((BM / 4) * DG);  // threads over the keys
  static constexpr int STAGES = 2;  // K/V slots: double-buffered
  static constexpr int SMEM =
      (BM * PITCH + 2 * STAGES * BN * PITCH + BN * PPITCH + 2 * BM) * 4;
  static_assert(KS >= 1 && (BM / 4) * DG * KS == NT, "O threads");
  static_assert(KS == 1 || (KS - 1) * BM * DP <= STAGES * BN * PITCH,
                "the split-key reduction fits in the K slots");
};

template <int DP, bool VEC>
__global__ void __launch_bounds__(Cfg<DP>::NT)
flash_attention_tiled_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ o, int tq, int tk, int heads,
                             int d, Strides st, int causal,
                             float scale_log2) {
  using C = Cfg<DP>;
  constexpr int BM = C::BM;
  constexpr int BN = C::BN;
  constexpr int NT = C::NT;
  constexpr int TM = C::TM;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + BM * C::PITCH;              // STAGES slots of BN rows
  float* vs = ks + C::STAGES * BN * C::PITCH;  // STAGES slots of BN rows
  float* ps = vs + C::STAGES * BN * C::PITCH;  // P^T: BN rows of BM
  float* alpha_s = ps + BN * C::PPITCH;  // this tile's rescale, per row
  float* l_s = alpha_s + BM;             // the final row sums

  // one block per (query tile, head, batch), in the order of the 1-D
  // grid: the heaviest causal tiles of every head first
  const int nq = (tq + BM - 1) / BM;
  const int bh_count = gridDim.x / nq;
  const int tile = nq - 1 - (int)(blockIdx.x / bh_count);
  const int h = (int)(blockIdx.x % bh_count) % heads;
  const int b = (int)(blockIdx.x % bh_count) / heads;
  const int tid = threadIdx.x;
  const int q0 = tile * BM;
  const long long offset = (long long)tk - tq;
  const int ntiles = visible_tiles(q0, BM, tq, tk, causal, BN);

  const float* qg = q + b * st.qb + h * st.qh;
  const float* kg = k + b * st.kb + h * st.kh;
  const float* vg = v + b * st.vb + h * st.vh;
  // Q rides with the first key tile; STAGES - 1 tiles go ahead, one
  // cp.async group each
  stage_tile<float, BM, DP, C::PITCH, NT, VEC>(qs, qg, st.qt, q0, tq, d, tid);
#pragma unroll
  for (int t = 0; t < C::STAGES - 1; ++t) {
    if (t < ntiles)
      stage_kv<float, BN, DP, C::PITCH, NT, C::STAGES, VEC>(
          ks, vs, t, kg, vg, st.kt, st.vt, tk, d, tid);
    cp_async_commit();
  }

  // S: rows ty * TM + i, keys tx + TX * j (the TX lanes of a row are
  // neighbours in a warp and read neighbouring K rows)
  const int tx = tid % C::TX;
  const int ty = tid / C::TX;
  // O: rows r0 .. r0 + 3, dims dg * TD .. + TD - 1, keys kq, kq + KS, ...
  const int dg = tid % C::DG;
  const int r0 = ((tid / C::DG) % (BM / 4)) * 4;
  const int kq = tid / (C::DG * (BM / 4));

  float m_run[TM], l_run[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;  // this thread's share of the row sum
  }
  float acc[4][C::TD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < C::TD; ++t) acc[i][t] = 0.f;

#pragma unroll 1
  for (int it = 0; it < ntiles; ++it) {
    // the copy of tile it + STAGES - 1 overlaps the products of this one
    if (it + C::STAGES - 1 < ntiles)
      stage_kv<float, BN, DP, C::PITCH, NT, C::STAGES, VEC>(
          ks, vs, it + C::STAGES - 1, kg, vg, st.kt, st.vt, tk, d, tid);
    cp_async_commit();
    cp_async_wait<C::STAGES - 1>();  // tile it (and Q) have landed
    __syncthreads();
    const float* kt = ks + (it % C::STAGES) * BN * C::PITCH;
    const float* vt = vs + (it % C::STAGES) * BN * C::PITCH;

    float s[TM][C::TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < DP / 4; ++c) {
      float4 qv[TM], kv[C::TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            qs + (ty * TM + i) * C::PITCH + 4 * c);
#pragma unroll
      for (int j = 0; j < C::TN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            kt + (tx + C::TX * j) * C::PITCH + 4 * c);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < C::TN; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }

    // scale into the log2 domain; mask only tiles on an edge
    const int k0 = it * BN;
    const bool edge = k0 + BN > tk || (causal && k0 + BN - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        float x = s[i][j] * scale_log2;
        if (edge) {
          const int key = k0 + tx + C::TX * j;
          const long long row = q0 + ty * TM + i;
          if (key >= tk || (causal && key > row + offset)) x = -CUDART_INF_F;
        }
        s[i][j] = x;
      }
    }

    // online softmax: the TX lanes of a row reduce its max by shuffles
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < C::TN; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int x = 1; x < C::TX; x <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha =
          m_run[i] == -CUDART_INF_F ? 0.f : exp2_approx(m_run[i] - m_new);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        // masked: 2^-inf = 0
        const float p = exp2_approx(s[i][j] - m_use);
        s[i][j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
      if (tx == 0) alpha_s[ty * TM + i] = alpha;
    }
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      float* prow = ps + (tx + C::TX * j) * C::PPITCH + ty * TM;
      if constexpr (TM == 4)
        *reinterpret_cast<float4*>(prow) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      else
        *reinterpret_cast<float2*>(prow) = make_float2(s[0][j], s[1][j]);
    }
    __syncthreads();

    // O = O * alpha + P V over this thread's keys
    const float4 al = *reinterpret_cast<const float4*>(alpha_s + r0);
#pragma unroll
    for (int t = 0; t < C::TD; ++t) {
      acc[0][t] *= al.x;
      acc[1][t] *= al.y;
      acc[2][t] *= al.z;
      acc[3][t] *= al.w;
    }
#pragma unroll 8
    for (int u = 0; u < BN / C::KS; ++u) {
      const int key = u * C::KS + kq;
      const float4 p =
          *reinterpret_cast<const float4*>(ps + key * C::PPITCH + r0);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < C::TD / 4; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vt + key * C::PITCH + dg * C::TD + 4 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * c + 0] = fmaf(pr[i], vv.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(pr[i], vv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pr[i], vv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pr[i], vv.w, acc[i][4 * c + 3]);
        }
      }
    }
    __syncthreads();  // P and this slot are read
  }
  cp_async_wait<0>();

  // the row sums: the TX lanes of a row add their shares
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int x = 1; x < C::TX; x <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, x);
    if (tx == 0) l_s[ty * TM + i] = l;
  }
  __syncthreads();
  if (C::KS > 1) {  // add the key splits' sums (scratch: the K slots)
    float* red = ks;
    if (kq > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < C::TD; ++t)
          red[((kq - 1) * BM + r0 + i) * DP + dg * C::TD + t] = acc[i][t];
    }
    __syncthreads();
    if (kq == 0) {
#pragma unroll
      for (int sp = 1; sp < C::KS; ++sp)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < C::TD; ++t)
            acc[i][t] += red[((sp - 1) * BM + r0 + i) * DP + dg * C::TD + t];
    }
  }
  if (kq != 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= tq) continue;
    const float denom = fmaxf(l_s[r0 + i], 1e-20f);
    float* orow = o + (((long long)b * tq + row) * heads + h) * d;
    if ((d & 3) == 0) {
#pragma unroll
      for (int c = 0; c < C::TD / 4; ++c) {
        const int dd = dg * C::TD + 4 * c;
        if (dd < d)
          *reinterpret_cast<float4*>(orow + dd) = make_float4(
              acc[i][4 * c] / denom, acc[i][4 * c + 1] / denom,
              acc[i][4 * c + 2] / denom, acc[i][4 * c + 3] / denom);
      }
    } else {
#pragma unroll
      for (int t = 0; t < C::TD; ++t) {
        const int dd = dg * C::TD + t;
        if (dd < d) orow[dd] = acc[i][t] / denom;
      }
    }
  }
}

}  // namespace tiled

// ---------------------------------------------------------------------------
// route rowwise: the first kernel (one query row per group of lanes)
// ---------------------------------------------------------------------------

namespace rowwise {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

// Tiling for a padded head dim DP.
template <int DP>
struct Cfg {
  static constexpr int DPT = DP < 16 ? DP : 16;         // dims per lane
  static constexpr int GD = DP / DPT;                   // lanes over D
  static constexpr int GK = GD >= 4 ? 1 : 4 / GD;       // lanes over keys
  static constexpr int GROUP = GD * GK;                 // lanes per row
  static constexpr int ROWS = DP >= 256 ? 32 : 64;      // query rows/block
  static constexpr int NT = ROWS * GROUP;               // threads/block
  static constexpr int BK = DP >= 256 ? 16 : (DP >= 128 ? 32 : 64);
  static constexpr int KC = BK < 32 ? BK : 32;          // keys per chunk
  static constexpr int SPT = KC / GK;                   // scores per lane
  static constexpr int PITCH = DP + 4;                  // smem row, floats
  static constexpr int NV = DPT / 4;                    // float4 per lane
  static_assert(GROUP <= 32 && 32 % GROUP == 0, "row group spans warps");
  static_assert(KC % GK == 0 && BK % KC == 0, "chunking");
};


template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<DP>::NT)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int tq, int tk, int heads, int d, Strides st,
                           int causal, float scale) {
  using C = Cfg<DP>;
  __shared__ __align__(16) float ks[C::BK * C::PITCH];
  __shared__ __align__(16) float vs[C::BK * C::PITCH];

  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / C::GROUP;
  const int lane_in_group = tid % C::GROUP;
  const int dp = lane_in_group % C::GD;  // which dims of the row
  const int kp = lane_in_group / C::GD;  // which keys of each chunk
  const int q0 = tile * C::ROWS;
  const int qi = q0 + row;
  const bool active = qi < tq;
  const long long offset = (long long)tk - tq;
  const long long qpos = qi + offset;  // the last key position row qi sees

  // keys any row of this tile may see: causal tiles stop at the diagonal
  long long kend = tk;
  if (causal) {
    const int q_last = (q0 + C::ROWS < tq ? q0 + C::ROWS : tq) - 1;
    const long long visible = q_last + offset + 1;
    if (visible < kend) kend = visible;
  }

  // this lane's dims: float4 chunk c = dp + GD * i covers 4c .. 4c + 3
  float qr[C::DPT];
  float acc[C::DPT];
  const T* qrow = q + b * st.qb + (long long)qi * st.qt + h * st.qh;
#pragma unroll
  for (int i = 0; i < C::NV; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int dd = 4 * (dp + C::GD * i) + r;
      qr[4 * i + r] = (active && dd < d) ? load_f32(qrow + dd) : 0.f;
      acc[4 * i + r] = 0.f;
    }
  }
  float m_run = -CUDART_INF_F;
  float s_run = 0.f;

  const T* kbase = k + b * st.kb + h * st.kh;
  const T* vbase = v + b * st.vb + h * st.vh;
  for (long long k0 = 0; k0 < kend; k0 += C::BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = tid; e < C::BK * DP; e += C::NT) {
      const int j = e / DP;
      const int dd = e - j * DP;
      const long long kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < tk && dd < d) {
        kv = load_f32(kbase + kj * st.kt + dd);
        vv = load_f32(vbase + kj * st.vt + dd);
      }
      ks[j * C::PITCH + dd] = kv;
      vs[j * C::PITCH + dd] = vv;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < C::BK; c += C::KC) {
      float sc[C::SPT];
      float m_blk = -CUDART_INF_F;
#pragma unroll
      for (int s = 0; s < C::SPT; ++s) {
        const int j = c + kp + C::GK * s;
        const float4* kr = reinterpret_cast<const float4*>(ks + j * C::PITCH);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < C::NV; ++i) {
          const float4 kk = kr[dp + C::GD * i];
          dot = fmaf(qr[4 * i + 0], kk.x, dot);
          dot = fmaf(qr[4 * i + 1], kk.y, dot);
          dot = fmaf(qr[4 * i + 2], kk.z, dot);
          dot = fmaf(qr[4 * i + 3], kk.w, dot);
        }
#pragma unroll
        for (int x = 1; x < C::GD; x <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, x);
        const long long kj = k0 + j;
        const bool valid = active && kj < tk && (!causal || kj <= qpos);
        sc[s] = valid ? dot * scale : -CUDART_INF_F;
        m_blk = fmaxf(m_blk, sc[s]);
      }
      if (m_blk == -CUDART_INF_F) continue;  // fully masked: moves nothing
      const float m_new = fmaxf(m_run, m_blk);
      const float alpha = m_run == -CUDART_INF_F ? 0.f : expf(m_run - m_new);
      s_run *= alpha;
#pragma unroll
      for (int i = 0; i < C::DPT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int s = 0; s < C::SPT; ++s) {
        const float p = sc[s] == -CUDART_INF_F ? 0.f : expf(sc[s] - m_new);
        s_run += p;
        const int j = c + kp + C::GK * s;
        const float4* vr = reinterpret_cast<const float4*>(vs + j * C::PITCH);
#pragma unroll
        for (int i = 0; i < C::NV; ++i) {
          const float4 vv = vr[dp + C::GD * i];
          acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
        }
      }
      m_run = m_new;
    }
  }

  // merge the GK key-split states of the row (lanes GD, 2 GD, ... apart)
#pragma unroll
  for (int x = C::GD; x < C::GROUP; x <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m_run, x);
    const float s_o = __shfl_xor_sync(0xffffffffu, s_run, x);
    const float m_new = fmaxf(m_run, m_o);
    const float a = m_run == -CUDART_INF_F ? 0.f : expf(m_run - m_new);
    const float bo = m_o == -CUDART_INF_F ? 0.f : expf(m_o - m_new);
    s_run = s_run * a + s_o * bo;
#pragma unroll
    for (int i = 0; i < C::DPT; ++i) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[i], x);
      acc[i] = acc[i] * a + acc_o * bo;
    }
    m_run = m_new;
  }

  if (!active || kp != 0) return;
  const float denom = fmaxf(s_run, 1e-20f);
  T* orow = o + (((long long)b * tq + qi) * heads + h) * d;
#pragma unroll
  for (int i = 0; i < C::NV; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int dd = 4 * (dp + C::GD * i) + r;
      if (dd < d) store_f32(orow + dd, acc[4 * i + r] / denom);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int tq, int tk, int heads, int d, const Strides& st, int causal,
           float scale, cudaStream_t s) {
  using C = Cfg<DP>;
  const dim3 grid((tq + C::ROWS - 1) / C::ROWS, heads, b);
  flash_attention_fwd_kernel<T, DP><<<grid, C::NT, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), tq, tk, heads, d, st,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int tq, int tk, int heads, int d, const Strides& st, int causal,
             float scale, cudaStream_t s) {
  if (d <= 8)
    return launch<T, 8>(q, k, v, o, b, tq, tk, heads, d, st, causal, scale, s);
  if (d <= 16)
    return launch<T, 16>(q, k, v, o, b, tq, tk, heads, d, st, causal, scale,
                         s);
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, b, tq, tk, heads, d, st, causal, scale,
                         s);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, b, tq, tk, heads, d, st, causal, scale,
                         s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, b, tq, tk, heads, d, st, causal, scale,
                          s);
  return launch<T, 256>(q, k, v, o, b, tq, tk, heads, d, st, causal, scale,
                        s);
}


}  // namespace rowwise

// ---------------------------------------------------------------------------
// launch of the tiled routes
// ---------------------------------------------------------------------------

// whether every row start of a (n0, n1, n2, d) view is 16-byte aligned for
// cp.async (dims of length 1 do not count) and a row is whole chunks
bool rows_aligned(const void* p, long long n0, long long n1, long long n2,
                  long long s0, long long s1, long long s2, long long d,
                  long long es) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || (d * es) % 16 != 0)
    return false;
  return (n0 <= 1 || (s0 * es) % 16 == 0) &&
         (n1 <= 1 || (s1 * es) % 16 == 0) && (n2 <= 1 || (s2 * es) % 16 == 0);
}

template <typename T, int DP, bool VEC>
int launch_tiled(const void* q, const void* k, const void* v, void* o, int b,
                 int tq, int tk, int heads, int d, const Strides& st,
                 int causal, float scale_log2, cudaStream_t s) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int smem = kMma ? mma::Cfg<DP>::SMEM : tiled::Cfg<DP>::SMEM;
  constexpr int bm = kMma ? mma::BM : tiled::Cfg<DP>::BM;
  constexpr int nt = kMma ? mma::NT : tiled::Cfg<DP>::NT;
  void (*kernel)(const T*, const T*, const T*, T*, int, int, int, int,
                 Strides, int, float);
  if constexpr (kMma)
    kernel = mma::flash_attention_mma_kernel<DP, VEC>;
  else
    kernel = tiled::flash_attention_tiled_kernel<DP, VEC>;
  static bool configured = false;  // shared memory above 48 KB: opt in once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long blocks = (long long)((tq + bm - 1) / bm) * heads * b;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  kernel<<<grid, nt, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), tq, tk, heads, d, st,
      causal, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int dispatch_tiled(const void* q, const void* k, const void* v, void* o,
                   int b, int tq, int tk, int heads, int d, const Strides& st,
                   int causal, float scale_log2, cudaStream_t s) {
  if (d <= 16)
    return launch_tiled<T, 16, VEC>(q, k, v, o, b, tq, tk, heads, d, st,
                                    causal, scale_log2, s);
  if (d <= 32)
    return launch_tiled<T, 32, VEC>(q, k, v, o, b, tq, tk, heads, d, st,
                                    causal, scale_log2, s);
  if (d <= 64)
    return launch_tiled<T, 64, VEC>(q, k, v, o, b, tq, tk, heads, d, st,
                                    causal, scale_log2, s);
  return launch_tiled<T, 128, VEC>(q, k, v, o, b, tq, tk, heads, d, st,
                                   causal, scale_log2, s);
}

template <typename T>
int run_tiled(const void* q, const void* k, const void* v, void* o, int b,
              int tq, int tk, int heads, int d, const Strides& st,
              int causal, float scale, cudaStream_t s) {
  const long long es = sizeof(T);
  const bool vec =
      rows_aligned(q, b, tq, heads, st.qb, st.qt, st.qh, d, es) &&
      rows_aligned(k, b, tk, heads, st.kb, st.kt, st.kh, d, es) &&
      rows_aligned(v, b, tk, heads, st.vb, st.vt, st.vh, d, es);
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)
  if (vec)
    return dispatch_tiled<T, true>(q, k, v, o, b, tq, tk, heads, d, st,
                                   causal, scale_log2, s);
  return dispatch_tiled<T, false>(q, k, v, o, b, tq, tk, heads, d, st,
                                  causal, scale_log2, s);
}

bool bad_shape(long long b, long long tq, long long tk, long long heads,
               long long d, long long max_d) {
  return b < 0 || tq < 0 || tk < 0 || heads < 0 || d < 1 || d > max_d ||
         b > 65535 || heads > 65535 || tq > INT32_MAX || tk > INT32_MAX;
}

}  // namespace

// q: (b, tq, heads, d) at strides q_s{b,t,h}; k, v: (b, tk, heads, d) at
// their strides; o: contiguous (b, tq, heads, d).  d in [1, 128]: the
// mma_bf16 route for bfloat16, tiled_f32 for float32; scale finite and
// not 0 (the wrapper passes 1/sqrt(d) for 0).
extern "C" int mxt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long b,
    long long tq, long long tk, long long heads, long long d, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    int causal, float scale, int dtype, void* stream) {
  if (bad_shape(b, tq, tk, heads, d, 128) || scale == 0.f ||
      !std::isfinite(scale))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || tq == 0 || heads == 0) return (int)cudaSuccess;
  const Strides st = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return run_tiled<float>(q, k, v, o, (int)b, (int)tq, (int)tk, (int)heads,
                            (int)d, st, causal, scale, s);
  if (dtype == kBFloat16)
    return run_tiled<bf16>(q, k, v, o, (int)b, (int)tq, (int)tk, (int)heads,
                           (int)d, st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The rowwise route, same arguments; d in [1, 256].
extern "C" int mxt_flash_attention_fwd_rowwise(
    const void* q, const void* k, const void* v, void* o, long long b,
    long long tq, long long tk, long long heads, long long d, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    int causal, float scale, int dtype, void* stream) {
  if (bad_shape(b, tq, tk, heads, d, 256)) return (int)cudaErrorInvalidValue;
  if (b == 0 || tq == 0 || heads == 0) return (int)cudaSuccess;
  const Strides st = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return rowwise::dispatch<float>(q, k, v, o, (int)b, (int)tq, (int)tk,
                                    (int)heads, (int)d, st, causal, scale, s);
  if (dtype == kBFloat16)
    return rowwise::dispatch<bf16>(q, k, v, o, (int)b, (int)tq, (int)tk,
                                   (int)heads, (int)d, st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
