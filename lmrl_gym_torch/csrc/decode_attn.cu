// Single-query (q_len = 1) attention over a static KV cache for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas kernel lmrl_gym_tpu/ops/decode_attention.py::
// _decode1_kernel (K4, launched by _decode_attention_dispatch). Same
// function: key slot j is visible iff j <= index and the additive bias
// allows it; fp32 online softmax; slots past `index` are never read, so
// cache traffic scales with the fill, not with T_max.
//
// Design up to Dh = 128: one thread block (4 warps) per (batch row, head).
// Lanes form groups of Dh/8 (8 for Dh = 64): each lane of a group holds 8
// consecutive dims of q and of its output accumulator, and a group reads
// one key row per step with one 16-byte load per lane (two for fp32), so a
// warp streams 32/G key rows of K and V per load instruction, coalesced.
// Each group runs its own online softmax over keys g, g + NG, ...; the NG
// partial (max, sum, acc) triples are merged in shared memory at the end.
// At small B x H (below two blocks per SM) the same groups run over splits
// of the keys, several blocks per (b, h), in one launch (the split route,
// below). Dh in (128, 256] (GPT-J) at small B x H takes a route of its own:
// 8 lanes per key row, each holding 32 dims.
//
// What bounds it on an H100: reading K and V of the filled prefix, about
// 2 FLOP per byte — device-memory bandwidth, where enough blocks are in
// flight (B x H = 6,144 on the serving rollout). At small B x H the bound is
// latency: one block per (b, h) walks its fill in dependent steps, each a
// device-memory round trip, with too few bytes in flight to fill the card;
// the split route answers that. What the design leaves on the table: no
// cp.async/TMA ring, and G-fold redundant exp() per key across a group's
// lanes.

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

// ---- Dh in (128, 256] at small B x H: a route of its own --------------------
//
// Above, a key row of 256 dims takes the whole warp (G = 32): a five-step
// shuffle reduction, 32 lanes taking the same exp() per key, and four keys in
// flight per block. With one block per (b, h) that is enough where B x H
// fills the card (the GPT-J rollout's B = 256 x 16 heads: 0.70-0.86 of the
// bytes bound on an H100), but a served batch of 16 gives 256 blocks, two
// per SM, and there it reached 0.41. Here 8 lanes share a key row, each
// holding 32 consecutive dims (four 16-byte loads of K and four of V in
// bf16), so a warp streams 4 keys per step and a block of 8 warps 32, with
// a three-step reduction and a quarter of the redundant exp(). q comes in
// by the same 16-byte loads (the wrapper checks its alignment at Dh > 128),
// and the groups' partial softmaxes are merged with each group's weight
// computed once. K and V stay raw (16-byte words) until used, so a lane's
// eight loads in flight cost 32 registers. Below kWideBelowBlocks blocks the
// dispatch takes this route; at and above it, the G = 32 kernel, whose
// small register and shared-memory footprint keeps more blocks resident
// (at the rollout's short fills this route's per-block merge made it 2.5x
// slower there). Splitting a (b, h)'s keys over several blocks was no
// faster at B = 16 on an H100 (an earlier split-and-merge version of this
// route: 0.069-0.084 ms with 3-5 splits of 676 keys, 0.066-0.070 unsplit).
constexpr int kWideG = 8;                      // lanes per key row
constexpr int kWideLoads = 4;                  // 8-element loads per lane and row
constexpr int kWideDims = 8 * kWideLoads;      // dims per lane
constexpr int kWideRows = 32 / kWideG;         // key rows per warp and step
constexpr int kWideWarps = 8;
constexpr int kWideThreads = kWideWarps * 32;
constexpr int kWideGroups = kWideWarps * kWideRows;
constexpr int64_t kWideBelowBlocks = 1024;  // ~8 blocks per SM of an H100 (132 SMs)
constexpr int kWideDmax = kWideG * kWideDims;  // 256

// 8 elements as raw 16-byte words (two for fp32), unpacked to fp32 on use
template <typename T> struct Raw8;
template <> struct Raw8<__nv_bfloat16> { uint4 w; };
template <> struct Raw8<float> { float4 a, b; };

__device__ __forceinline__ Raw8<__nv_bfloat16> load_raw(const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}
__device__ __forceinline__ Raw8<float> load_raw(const float* p) {
  return {*reinterpret_cast<const float4*>(p), *reinterpret_cast<const float4*>(p + 4)};
}
__device__ __forceinline__ void unpack(const Raw8<__nv_bfloat16>& r, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack(const Raw8<float>& r, float* f) {
  f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
  f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads, 2) decode_attn_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out,
    int H, int Dh, int n_keys,
    int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t bias_sb, float scale) {
  __shared__ float sM[kWideGroups], sL[kWideGroups], sW[kWideGroups], sLsum;
  __shared__ float sAcc[kWideGroups][kWideDmax];

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int li = lane % kWideG;
  const int g = warp * kWideRows + lane / kWideG;  // group id
  const int d0 = kWideDims * li;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;

  float qf[kWideDims], acc[kWideDims];
#pragma unroll
  for (int u = 0; u < kWideLoads; ++u) {
    if (d0 + 8 * u < Dh) {  // Dh % 8 == 0: all 8 or none
      unpack(load_raw(qb + d0 + 8 * u), qf + 8 * u);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[8 * u + e] = 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < kWideDims; ++e) {
    qf[e] *= scale;
    acc[e] = 0.f;
  }

  float m = -INFINITY, l = 0.f;
  // the trip count is uniform across the warp (the shuffles need every lane)
  for (int jw = warp * kWideRows; jw < n_keys; jw += kWideGroups) {
    const int j = jw + lane / kWideG;
    const bool live = j < n_keys;
    Raw8<T> kr[kWideLoads], vr[kWideLoads];
#pragma unroll
    for (int u = 0; u < kWideLoads; ++u) {
      if (live && d0 + 8 * u < Dh) {
        kr[u] = load_raw(kb + j * k_st + d0 + 8 * u);
        vr[u] = load_raw(vb + j * v_st + d0 + 8 * u);
      }
    }
    float dot = 0.f;
#pragma unroll
    for (int u = 0; u < kWideLoads; ++u) {
      if (live && d0 + 8 * u < Dh) {
        float kf[8];
        unpack(kr[u], kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qf[8 * u + e], kf[e], dot);
      }
    }
#pragma unroll
    for (int off = kWideG / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (live) {
      const float s = biasb ? dot + biasb[j] : dot;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * alpha + p;
      m = m_new;
#pragma unroll
      for (int u = 0; u < kWideLoads; ++u) {
        if (d0 + 8 * u < Dh) {
          float vf[8];
          unpack(vr[u], vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[8 * u + e] = fmaf(p, vf[e], acc[8 * u + e] * alpha);
        }
      }
    }
  }

  if (li == 0) {
    sM[g] = m;
    sL[g] = l;
  }
#pragma unroll
  for (int e = 0; e < kWideDims; ++e) sAcc[g][d0 + e] = acc[e];
  __syncthreads();

  // the groups' weights e^(m_g - M) and the total sum, once, by warp 0 (one
  // group per lane); key 0 is always read, so M is finite
  static_assert(kWideGroups <= 32, "one group per lane of warp 0");
  if (warp == 0) {
    const float mg = lane < kWideGroups ? sM[lane] : -INFINITY;
    float M = mg;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float w = expf(mg - M);  // 0 for the lanes past the groups
    float lw = lane < kWideGroups ? sL[lane] * w : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lw += __shfl_xor_sync(0xffffffffu, lw, off);
    if (lane < kWideGroups) sW[lane] = w;
    if (lane == 0) sLsum = fmaxf(lw, 1e-30f);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < Dh; d += kWideThreads) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < kWideGroups; ++i) o = fmaf(sAcc[i][d], sW[i], o);
    out[((int64_t)b * H + h) * Dh + d] = from_f<T>(o / sLsum);
  }
}

// ---- Dh <= 128 at small B x H: the split route -------------------------------
//
// Below two blocks per SM (the wrapper's `_decode_splits` decides, since
// `index` is a host int) one block per (b, h) leaves most SMs idle or
// with one block: B x H = 64 (an f32 dialog policy, B = 16 x 4 heads) fills
// 64 of 132 SMs, and at B x H = 192 (a served Text-Nav turn) each SM holds
// 1.45 blocks. Such a block walks its whole fill one dependent step at a time
// (~50 steps at slot 792, each a device-memory round trip), so the route is
// bound by latency, not by the card's bytes. Here the keys 0 .. n_keys - 1
// are cut into `gridDim.x` consecutive splits of equal size to a key (at
// least 64 keys each, about 4 blocks per SM in all), and each split block runs the grouped
// online softmax above over its own range, with every group issuing the
// 16-byte loads of kSplitRows key rows (and their bias) before it uses the
// first. Each block merges its groups and writes its (m, l, acc[Dh]) partial
// to f32 scratch; then, after a __threadfence(), one thread takes a ticket
// from an int counter per (b, h). The block that takes the last ticket reads
// every partial and merges them in split order (so every run gives the same
// bits, whichever block finishes last), writes out, and resets the counter to
// 0 for the next launch on the stream (the wrapper keeps one zeroed counter
// buffer per device and stream). One launch: the paths that decode at small
// batch are paced by the host, and a second merge kernel would add a launch
// to every served token. A split whose every key is masked by left padding
// has m ~ -0.7 * FLT_MAX and weight exp(m - M) = 0 in the merge; a group
// that gets no key of its split keeps m = -inf and weight 0.
//
// The Dh = 256 route above tried splits and dropped them (its note: no
// faster at B = 16); there B x H = 256 already gave two blocks per SM and a
// block kept 32 key rows of 512 bytes in flight. Up to Dh = 128 a block of
// the kernel above keeps 16 rows of 128 bytes (Dh = 64, bf16) in flight and
// issues the next row only after this row's softmax update, so the card is
// short of bytes in flight, which splits and the kSplitRows prefetch supply.
constexpr int kSplitRows = 4;   // key rows in flight per group
constexpr int kMaxSplits = 64;  // ops/decode_attention.py::_SPLIT_MAX

template <typename T, int G>
__global__ void __launch_bounds__(kThreads) decode_attn_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ part, int* __restrict__ count,
    int H, int Dh, int n_keys,
    int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t bias_sb, float scale) {
  constexpr int kRowsPerWarp = 32 / G;
  constexpr int kGroups = kWarps * kRowsPerWarp;
  constexpr int kDmax = 8 * G;
  static_assert(kGroups <= 32, "one group per lane of warp 0");
  __shared__ float sM[kGroups], sL[kGroups], sW[kMaxSplits];
  __shared__ float sAcc[kGroups][kDmax];
  __shared__ float sMax, sLsum;
  __shared__ int sLast;

  const int n_splits = gridDim.x;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = lane % G;                           // lane within the group
  const int g = warp * kRowsPerWarp + lane / G;      // group id
  const int d0 = 8 * li;
  const bool has_dims = d0 < Dh;                     // Dh % 8 == 0: all 8 or none
  // split s reads keys [s n / S, (s + 1) n / S): S <= n / 64 splits of >= 64 keys
  const int j_begin = (int)((int64_t)split * n_keys / n_splits);
  const int j_end = (int)((int64_t)(split + 1) * n_keys / n_splits);

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
  // group g reads keys j_begin + g, + kGroups, ...; each step kSplitRows of
  // them, all loads issued first. The trip count is uniform across the warp
  // (the shuffles need every lane).
  for (int jw = j_begin + warp * kRowsPerWarp; jw < j_end; jw += kGroups * kSplitRows) {
    Raw8<T> kr[kSplitRows], vr[kSplitRows];
    float bj[kSplitRows];
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      const int j = jw + r * kGroups + lane / G;
      bj[r] = 0.f;
      if (j < j_end) {
        if (has_dims) {
          kr[r] = load_raw(kb + j * k_st + d0);
          vr[r] = load_raw(vb + j * v_st + d0);
        }
        if (biasb) bj[r] = biasb[j];
      }
    }
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      const int j = jw + r * kGroups + lane / G;
      const bool live = j < j_end;
      float dot = 0.f;
      if (live && has_dims) {
        float kf[8];
        unpack(kr[r], kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qf[e], kf[e], dot);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (live) {
        const float s = biasb ? dot + bj[r] : dot;
        const float m_new = fmaxf(m, s);
        const float alpha = expf(m - m_new);
        const float p = expf(s - m_new);
        l = l * alpha + p;
        m = m_new;
        if (has_dims) {
          float vf[8];
          unpack(vr[r], vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = fmaf(p, vf[e], acc[e] * alpha);
        }
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

  // this split's partial: the groups' weights by warp 0; the split holds at
  // least one key, so its max is finite
  if (warp == 0) {
    const float mg = lane < kGroups ? sM[lane] : -INFINITY;
    float M = mg;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    const float w = lane < kGroups ? expf(mg - M) : 0.f;
    float lw = lane < kGroups ? sL[lane] * w : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lw += __shfl_xor_sync(0xffffffffu, lw, off);
    if (lane < kGroups) sW[lane] = w;
    if (lane == 0) {
      sMax = M;
      sLsum = lw;
    }
  }
  __syncthreads();
  const int row = Dh + 2;  // a partial: m, l, acc[Dh]
  float* mine = part + ((int64_t)bh * n_splits + split) * row;
  for (int d = threadIdx.x; d < Dh; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) o = fmaf(sAcc[i][d], sW[i], o);
    mine[2 + d] = o;
  }
  if (threadIdx.x == 0) {
    mine[0] = sMax;
    mine[1] = sLsum;
  }
  __threadfence();  // the partial is visible to every block before the ticket
  __syncthreads();
  if (threadIdx.x == 0) sLast = atomicAdd(count + bh, 1) == n_splits - 1;
  __syncthreads();
  if (!sLast) return;
  __threadfence();

  // the last block of (b, h): merge the partials in split order (L2 reads)
  const float* all = part + (int64_t)bh * n_splits * row;
  if (warp == 0) {
    float M = -INFINITY;
    for (int s = lane; s < n_splits; s += 32) M = fmaxf(M, __ldcg(all + s * row));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    for (int s = lane; s < n_splits; s += 32) sW[s] = expf(__ldcg(all + s * row) - M);
    __syncwarp();
    if (lane == 0) {
      float lsum = 0.f;
      for (int s = 0; s < n_splits; ++s) lsum = fmaf(__ldcg(all + s * row + 1), sW[s], lsum);
      sLsum = fmaxf(lsum, 1e-30f);
      count[bh] = 0;  // ready for the next launch on this stream
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < Dh; d += kThreads) {
    float o = 0.f;
    for (int s = 0; s < n_splits; ++s) o = fmaf(__ldcg(all + s * row + 2 + d), sW[s], o);
    out[(int64_t)bh * Dh + d] = from_f<T>(o / sLsum);
  }
}

template <typename T, int G>
int launch_split(const void* q, const void* k, const void* v, const void* bias, void* out,
                 void* part, void* count, int B, int H, int Dh, int n_keys, int splits,
                 int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_st,
                 int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t bias_sb, float scale,
                 cudaStream_t stream) {
  decode_attn_split_kernel<T, G><<<dim3(splits, H, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), static_cast<float*>(part),
      static_cast<int*>(count), H, Dh, n_keys,
      q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, bias_sb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* bias, void* out,
             void* part, void* count, int B, int H, int Dh, int n_keys, int splits,
             int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_st,
             int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t bias_sb, float scale,
             cudaStream_t stream) {
  if (splits > 1) {
#define SPLIT_ARGS q, k, v, bias, out, part, count, B, H, Dh, n_keys, splits, q_sb, q_sh, \
    k_sb, k_sh, k_st, v_sb, v_sh, v_st, bias_sb, scale, stream
    if (Dh <= 32) return launch_split<T, 4>(SPLIT_ARGS);
    if (Dh <= 64) return launch_split<T, 8>(SPLIT_ARGS);
    return launch_split<T, 16>(SPLIT_ARGS);
#undef SPLIT_ARGS
  }
#define DECODE_ARGS q, k, v, bias, out, B, H, Dh, n_keys, q_sb, q_sh, k_sb, k_sh, k_st, \
    v_sb, v_sh, v_st, bias_sb, scale, stream
  if (Dh <= 32) return launch<T, 4>(DECODE_ARGS);
  if (Dh <= 64) return launch<T, 8>(DECODE_ARGS);
  if (Dh <= 128) return launch<T, 16>(DECODE_ARGS);
  if ((int64_t)B * H >= kWideBelowBlocks) return launch<T, 32>(DECODE_ARGS);
#undef DECODE_ARGS
  decode_attn_wide_kernel<T><<<dim3(H, B), kWideThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), H, Dh, n_keys,
      q_sb, q_sh, k_sb, k_sh, k_st, v_sb, v_sh, v_st, bias_sb, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is [B, H, Dh] by (b, h) strides; k/v
// rows are addressed by (b, h, slot) strides with a contiguous last dim and
// must be 16-byte aligned (the wrapper checks; for Dh > 128 q's rows too);
// keys 0 .. n_keys - 1 (= index) are read. out is contiguous [B, H, Dh].
// bias is [B, >= n_keys] float32 with row stride bias_sb, or null. splits = 1
// takes one block per (b, h); splits > 1 (Dh <= 128, splits <= n_keys) the
// split route, split s reading keys [s * n_keys / splits, (s + 1) * n_keys /
// splits), with `part` f32 scratch of B * H * splits * (Dh + 2) and `count`
// B * H ints that are 0 (and are 0 again when the launch ends). Returns
// cudaGetLastError() (cudaErrorInvalidValue, without launching, for what the
// kernels do not take).
extern "C" int decode_attn(int dtype, const void* q, const void* k, const void* v,
                           const void* bias, void* out, void* part, void* count,
                           int B, int H, int Dh, int n_keys, int splits,
                           long long q_sb, long long q_sh,
                           long long k_sb, long long k_sh, long long k_st,
                           long long v_sb, long long v_sh, long long v_st,
                           long long bias_sb, float scale, void* stream) {
  if (Dh <= 0 || Dh > 256 || Dh % 8 != 0 || B <= 0 || H <= 0 || n_keys <= 0 ||
      B > 65535 || H > 65535 || splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (splits > 1 && (Dh > 128 || splits > kMaxSplits || splits > n_keys || part == nullptr ||
                     count == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ENTRY_ARGS q, k, v, bias, out, part, count, B, H, Dh, n_keys, splits, q_sb, q_sh, \
    k_sb, k_sh, k_st, v_sb, v_sh, v_st, bias_sb, scale, st
  if (dtype == 0) return dispatch<float>(ENTRY_ARGS);
  if (dtype == 1) return dispatch<__nv_bfloat16>(ENTRY_ARGS);
  return (int)cudaErrorInvalidValue;
#undef ENTRY_ARGS
}
