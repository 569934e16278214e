// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel lmrl_gym_tpu/ops/flash_attention.py::
// _flash_kernel (K1, launched by _flash_forward). Same function:
//   O = softmax(scale * Q K^T + bias, causal with queries right-aligned at
//       offset = S - Tq) V,   lse = per-row logsumexp,
// fp32 online softmax, masked scores at -0.7 * FLT_MAX, key tiles past the
// causal limit never read.
//
// Design: one thread block per (q-tile of 16 rows, head, batch row); the
// TPU's sequential kv grid axis is the loop over key tiles inside the
// block. 128 threads = 16 query rows x 8 lanes. Per key tile the block
// stages K and V (converted to fp32) in shared memory; each thread scores 8
// (or 4, 2) keys of its row, the row's 8 lanes reduce max and sum with warp
// shuffles, and each thread then accumulates Dh/8 output dims of P V.
// Queries, keys and values are addressed by batch/head/row strides with a
// contiguous last dim, so a cached append can pass a strided view of the
// filled cache prefix without a copy.
//
// What bounds it on an H100: at the serving path's shapes (Tq <= 10,
// S <= 128, Dh = 64) the work is ~10 FLOP per byte, so device-memory bytes
// (K/V of the filled prefix) are the bound. What this simple design leaves
// on the table: no tensor cores (wgmma) and no TMA/cp.async pipelining;
// 2-byte scalar global loads; a 16-row q tile that wastes 6 rows at
// Tq = 10; one pass per key tile with two block barriers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -0.7f * 3.4028234663852886e38f;  // _NEG_BIG
constexpr int kBQ = 16;        // query rows per block
constexpr int kThreads = 128;  // kBQ rows x 8 lanes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float row_max(float x) {  // over the row's 8 lanes
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

template <int DMAX, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (DMAX + 1) + BK * (DMAX + 1) + BK * DMAX + kBQ * (BK + 1));
}

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse,
    int H, int Tq, int S, int Dh,
    int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_st,
    int64_t bias_sb, int offset, float scale, int causal) {
  extern __shared__ float smem[];
  float* sQ = smem;                     // [kBQ][DMAX + 1]
  float* sK = sQ + kBQ * (DMAX + 1);    // [BK][DMAX + 1]
  float* sV = sK + BK * (DMAX + 1);     // [BK][DMAX]
  float* sP = sV + BK * DMAX;           // [kBQ][BK + 1]

  const int tid = threadIdx.x;
  const int row = tid >> 3;  // query row within the tile
  const int sub = tid & 7;   // lane within the row's group of 8
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;

  // Q tile, pre-scaled as the Pallas kernel does (q * sm_scale)
  for (int i = tid; i < kBQ * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh;
    const int t = q0 + r;
    sQ[r * (DMAX + 1) + d] = t < Tq ? to_f(qb[t * q_st + d]) * scale : 0.f;
  }

  // keys [0, kv_end) are visible to some real query of this tile
  const int q_last = min(q0 + kBQ, Tq) - 1;
  const int kv_end = causal ? min(S, offset + q_last + 1) : S;
  const int qpos = offset + q0 + row;  // absolute position of this row's query

  float m = kNegBig, l = 0.f;
  float acc[DMAX / 8];
#pragma unroll
  for (int t = 0; t < DMAX / 8; ++t) acc[t] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();  // sQ written / previous tile's sK, sV, sP consumed
    for (int i = tid; i < BK * Dh; i += kThreads) {
      const int r = i / Dh, d = i - r * Dh;
      const int j = j0 + r;
      const bool live = j < kv_end;
      sK[r * (DMAX + 1) + d] = live ? to_f(kb[j * k_st + d]) : 0.f;
      sV[r * DMAX + d] = live ? to_f(vb[j * v_st + d]) : 0.f;
    }
    __syncthreads();

    // scores of this row against keys sub, sub+8, ...
    float s[BK / 8];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i] = 0.f;
    const float* qr = sQ + row * (DMAX + 1);
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) s[i] = fmaf(qd, sK[(sub + 8 * i) * (DMAX + 1) + d], s[i]);
    }
    float m_tile = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int j = j0 + sub + 8 * i;
      if (j >= kv_end) {
        s[i] = -INFINITY;  // past the causal limit of the whole tile: weight exactly 0
      } else {
        if (biasb) s[i] += biasb[j];
        if (causal && j > qpos) s[i] = kNegBig;
      }
      m_tile = fmaxf(m_tile, s[i]);
    }
    m_tile = row_max(m_tile);
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);  // rescale the running accumulator
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float p = expf(s[i] - m_new);
      psum += p;
      sP[row * (BK + 1) + sub + 8 * i] = p;
    }
    l = l * alpha + row_sum(psum);
    m = m_new;
#pragma unroll
    for (int t = 0; t < DMAX / 8; ++t) acc[t] *= alpha;
    __syncthreads();

    const float* pr = sP + row * (BK + 1);
#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      const float p = pr[jj];
      const float* vr = sV + jj * DMAX + sub;
#pragma unroll
      for (int t = 0; t < DMAX / 8; ++t) acc[t] = fmaf(p, vr[8 * t], acc[t]);
    }
  }

  const int t_row = q0 + row;
  if (t_row < Tq) {
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
    T* orow = out + b * o_sb + h * o_sh + t_row * o_st;
#pragma unroll
    for (int t = 0; t < DMAX / 8; ++t) {
      const int d = sub + 8 * t;
      if (d < Dh) orow[d] = from_f<T>(acc[t] * inv);
    }
    if (sub == 0) lse[((int64_t)b * H + h) * Tq + t_row] = m + logf(lc);
  }
}

template <typename T, int DMAX, int BK>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out,
           void* lse, int B, int H, int Tq, int S, int Dh,
           int64_t q_sb, int64_t q_sh, int64_t q_st,
           int64_t k_sb, int64_t k_sh, int64_t k_st,
           int64_t v_sb, int64_t v_sh, int64_t v_st,
           int64_t o_sb, int64_t o_sh, int64_t o_st,
           int64_t bias_sb, int offset, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX, BK>();
  auto kernel = flash_fwd_kernel<T, DMAX, BK>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), static_cast<float*>(lse),
      H, Tq, S, Dh, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st,
      o_sb, o_sh, o_st, bias_sb, offset, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* bias, void* out,
             void* lse, int B, int H, int Tq, int S, int Dh,
             int64_t q_sb, int64_t q_sh, int64_t q_st,
             int64_t k_sb, int64_t k_sh, int64_t k_st,
             int64_t v_sb, int64_t v_sh, int64_t v_st,
             int64_t o_sb, int64_t o_sh, int64_t o_st,
             int64_t bias_sb, int offset, float scale, int causal, cudaStream_t stream) {
#define FLASH_ARGS q, k, v, bias, out, lse, B, H, Tq, S, Dh, q_sb, q_sh, q_st, k_sb, k_sh, \
    k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st, bias_sb, offset, scale, causal, stream
  if (Dh <= 64) return launch<T, 64, 64>(FLASH_ARGS);
  if (Dh <= 128) return launch<T, 128, 32>(FLASH_ARGS);
  return launch<T, 256, 16>(FLASH_ARGS);
#undef FLASH_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. out is indexed by (b, h, t) strides with
// a contiguous last dim; lse is contiguous [B, H, Tq] float32; bias is
// [B, >= S] float32 with row stride bias_sb, or null. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape the
// kernel does not take).
extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v,
                         const void* bias, void* out, void* lse,
                         int B, int H, int Tq, int S, int Dh,
                         long long q_sb, long long q_sh, long long q_st,
                         long long k_sb, long long k_sh, long long k_st,
                         long long v_sb, long long v_sh, long long v_st,
                         long long o_sb, long long o_sh, long long o_st,
                         long long bias_sb, int offset, float scale, int causal,
                         void* stream) {
  if (Dh <= 0 || Dh > 256 || Dh % 8 != 0 || B <= 0 || H <= 0 || Tq <= 0 || S <= 0 ||
      B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(q, k, v, bias, out, lse, B, H, Tq, S, Dh, q_sb, q_sh, q_st,
                           k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st, bias_sb,
                           offset, scale, causal, st);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, bias, out, lse, B, H, Tq, S, Dh, q_sb, q_sh,
                                   q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh,
                                   o_st, bias_sb, offset, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}
