// Single-query (q_len = 1) attention over a static KV cache for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas kernel lmrl_gym_tpu/ops/decode_attention.py::
// _decode1_kernel (K4, launched by _decode_attention_dispatch). Same
// function: key slot j is visible iff j <= index and the additive bias
// allows it; fp32 online softmax; slots past `index` are never read, so
// cache traffic scales with the fill, not with T_max.
//
// Design: one thread block (4 warps) per (batch row, head). Lanes form
// groups of Dh/8 (8 for Dh = 64): each lane of a group holds 8 consecutive
// dims of q and of its output accumulator, and a group reads one key row per
// step with one 16-byte load per lane (two for fp32), so a warp streams
// 32/G key rows of K and V per load instruction, coalesced. Each group runs
// its own online softmax over keys g, g + NG, ...; the NG partial
// (max, sum, acc) triples are merged in shared memory at the end.
//
// What bounds it on an H100: reading K and V of the filled prefix, about
// 2 FLOP per byte — device-memory bandwidth. What this simple design leaves
// on the table: no split of long caches over several blocks (one block per
// (b, h) is enough parallelism at B*H = 6144 but not at small batch), no
// cp.async/TMA prefetch of the next key rows, and G-fold redundant exp()
// per key across a group's lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// 8 consecutive elements at p (16-byte aligned for bf16, 32 for fp32) → fp32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// G lanes per key row; DMAX = 8 * G dims per row at most
template <typename T, int G>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out,
    int H, int Dh, int n_keys,
    int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t bias_sb, float scale) {
  constexpr int kRowsPerWarp = 32 / G;
  constexpr int kGroups = kWarps * kRowsPerWarp;
  constexpr int kDmax = 8 * G;
  __shared__ float sM[kGroups], sL[kGroups];
  __shared__ float sAcc[kGroups][kDmax];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = lane % G;                           // lane within the group
  const int g = warp * kRowsPerWarp + lane / G;      // group id
  const int d0 = 8 * li;
  const bool has_dims = d0 < Dh;                     // Dh % 8 == 0: all 8 or none

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;

  float qf[8], acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    qf[e] = has_dims ? to_f(qb[d0 + e]) * scale : 0.f;
    acc[e] = 0.f;
  }

  float m = -INFINITY, l = 0.f;
  // the trip count is uniform across the warp (the shuffles need every lane);
  // group g reads keys g, g + kGroups, ...
  for (int jw = warp * kRowsPerWarp; jw < n_keys; jw += kGroups) {
    const int j = jw + lane / G;
    const bool live = j < n_keys;
    float kf[8], vf[8];
    float dot = 0.f;
    if (live && has_dims) {
      load8(kb + j * k_st + d0, kf);
      load8(vb + j * v_st + d0, vf);
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(qf[e], kf[e], dot);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (live) {
      const float s = biasb ? dot + biasb[j] : dot;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * alpha + p;
      m = m_new;
      if (has_dims) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, vf[e], acc[e] * alpha);
      }
    }
  }

  if (li == 0) {
    sM[g] = m;
    sL[g] = l;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) sAcc[g][d0 + e] = acc[e];
  __syncthreads();

  // merge the groups' partial softmaxes; key 0 is always read, so M is finite
  for (int d = threadIdx.x; d < Dh; d += kThreads) {
    float M = -INFINITY;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) M = fmaxf(M, sM[i]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const float w = expf(sM[i] - M);
      lsum = fmaf(sL[i], w, lsum);
      o = fmaf(sAcc[i][d], w, o);
    }
    out[((int64_t)b * H + h) * Dh + d] = from_f<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int G>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out,
           int B, int H, int Dh, int n_keys, int64_t q_sb, int64_t q_sh,
           int64_t k_sb, int64_t k_sh, int64_t k_st,
           int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t bias_sb, float scale,
           cudaStream_t stream) {
  dim3 grid(H, B);
  decode_attn_kernel<T, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), H, Dh, n_keys,
      q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, bias_sb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* bias, void* out,
             int B, int H, int Dh, int n_keys, int64_t q_sb, int64_t q_sh,
             int64_t k_sb, int64_t k_sh, int64_t k_st,
             int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t bias_sb, float scale,
             cudaStream_t stream) {
#define DECODE_ARGS q, k, v, bias, out, B, H, Dh, n_keys, q_sb, q_sh, k_sb, k_sh, k_st, \
    v_sb, v_sh, v_st, bias_sb, scale, stream
  if (Dh <= 32) return launch<T, 4>(DECODE_ARGS);
  if (Dh <= 64) return launch<T, 8>(DECODE_ARGS);
  if (Dh <= 128) return launch<T, 16>(DECODE_ARGS);
  return launch<T, 32>(DECODE_ARGS);
#undef DECODE_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is [B, H, Dh] by (b, h) strides; k/v
// rows are addressed by (b, h, slot) strides with a contiguous last dim and
// must be 16-byte aligned (the wrapper checks); keys 0 .. n_keys - 1
// (= index) are read. out is contiguous [B, H, Dh]. bias is [B, >= n_keys]
// float32 with row stride bias_sb, or null. Returns cudaGetLastError().
extern "C" int decode_attn(int dtype, const void* q, const void* k, const void* v,
                           const void* bias, void* out, int B, int H, int Dh, int n_keys,
                           long long q_sb, long long q_sh,
                           long long k_sb, long long k_sh, long long k_st,
                           long long v_sb, long long v_sh, long long v_st,
                           long long bias_sb, float scale, void* stream) {
  if (Dh <= 0 || Dh > 256 || Dh % 8 != 0 || B <= 0 || H <= 0 || n_keys <= 0 ||
      B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(q, k, v, bias, out, B, H, Dh, n_keys, q_sb, q_sh, k_sb, k_sh,
                           k_st, v_sb, v_sh, v_st, bias_sb, scale, st);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(q, k, v, bias, out, B, H, Dh, n_keys, q_sb, q_sh, k_sb,
                                   k_sh, k_st, v_sb, v_sh, v_st, bias_sb, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}
