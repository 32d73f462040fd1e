// Flash attention forward (tiled online softmax) for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/kernels/flash_attention.py:137-220
// (_flash_pallas_fwd, whose pl.pallas_call at :214 runs _flash_kernel).
// For q (B, Tq, H, D) and k, v (B, Tk, H, D), float32 or bfloat16, it
// writes o (B, Tq, H, D) in q's dtype:
//   o[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h], masked) v[b, j, h]
// with float32 math, the mask `j < Tk` and, when causal,
// `i + (Tk - Tq) >= j` (the bottom-right aligned convention of
// full_attention).  Each query row keeps a running (max m, sum s, acc) and
// takes the JAX kernel's guards: a fully masked key chunk moves nothing,
// the rescale factor is 0 while m is still -inf, and the output is
// acc / max(s, 1e-20), so a row that sees no key is 0, not NaN.
//
// Bound: at the model's long context (B 4, T 4096, H 4, D 16) the work is
// float32 FFMA compute: 4 * B * H * Tq * Tk * D flops for the two products
// against 16.8 MB of q, k, v and o, about 276 us of compute (half of it
// causal) at the H100's 67 TFLOP/s float32 rate and 5 us of HBM traffic.
// At T 512 the whole call is a few microseconds of work, and the launch
// latency sets its time.
//
// Design.  One CUDA block per (query tile of ROWS rows, head, batch), grid
// (ceil(Tq / ROWS), H, B); the query tiles run heaviest first, since a
// causal tile's work grows with its position.  Each query row is owned by
// a group of GD * GK neighbouring lanes of one warp: GD lanes split the
// (padded) head dim, 16 dims each, in float4 chunks interleaved so that
// the group reads neighbouring shared-memory words; GK lanes split the keys
// of every chunk, each with its own running (m, s, acc), merged by warp
// shuffles at the end.  q and acc live in registers.  K and V tiles of BK
// rows are staged in shared memory as float32 (coalesced loads from the
// strided (B, T, H, D) layout, so the model's split q/k/v views need no
// copy), with a row pitch of DP + 4 floats that keeps the lanes of a group
// on distinct banks.  Scores of a chunk of KC keys are held in registers,
// their max taken, and the running triple rescaled once per chunk.  The
// ragged Tq and Tk edges are masked in the kernel (no padding copies), and
// a causal tile that lies wholly above the diagonal is never loaded: such
// a tile's probabilities are all zero, so skipping it changes no result.
// Head dims are instantiated for D in {8, 16, 32, 64, 128, 256}; a D in
// between takes the next size up with the tail masked.  wgmma, TMA and
// warp specialisation are left for later: this first kernel is plain
// FFMA, and exp is expf (no fast-math intrinsic).
//
// C interface (bound with ctypes): strides in elements, the head dim's
// stride must be 1; the output is contiguous.  The function launches on
// the given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
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

struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
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

}  // namespace

// q: (b, tq, heads, d) at strides q_s{b,t,h}; k, v: (b, tk, heads, d) at
// their strides; o: contiguous (b, tq, heads, d).  d in [1, 256].
extern "C" int mxt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long b,
    long long tq, long long tk, long long heads, long long d, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    int causal, float scale, int dtype, void* stream) {
  if (b < 0 || tq < 0 || tk < 0 || heads < 0 || d < 1 || d > 256 ||
      b > 65535 || heads > 65535 || tq > INT32_MAX || tk > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || tq == 0 || heads == 0) return (int)cudaSuccess;
  const Strides st = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(q, k, v, o, (int)b, (int)tq, (int)tk, (int)heads,
                           (int)d, st, causal, scale, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(q, k, v, o, (int)b, (int)tq, (int)tk,
                                   (int)heads, (int)d, st, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
