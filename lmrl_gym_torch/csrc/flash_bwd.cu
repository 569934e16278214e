// Causal flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernels lmrl_gym_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel (K2) and _flash_bwd_dkv_kernel (K3), launched by
// _flash_backward. Same functions, with P rebuilt from the forward's saved
// logsumexp instead of an online softmax:
//   s  = scale * Q K^T + bias, masked to -0.7 * FLT_MAX where a key lies past
//        its query (queries right-aligned at offset = S - Tq),
//   P  = exp(s - lse),  dS = P * (dO V^T - delta),  delta = rowsum(dO * O),
//   K2: dQ = scale * dS K                  (one block per q tile),
//   K3: dV = P^T dO,  dK = scale * dS^T Q  (one block per key tile).
// delta is computed by the caller (as the JAX package computes it outside
// its kernels). Keys past the causal limit of a whole tile are never read.
//
// Design, simple first: 128 threads = 16 rows x 8 lanes, fp32 on the CUDA
// cores, tiles staged in shared memory as fp32 with a padded row stride (no
// bank conflicts when 8 lanes read 8 rows at one column).
// - K2: the block owns 16 query rows and loops over key tiles up to the
//   causal limit of its last real query, as the forward kernel does. Each
//   thread scores BK/8 keys of its row (QK^T and dO V^T in one pass over
//   Dh), writes its dS values to shared memory, then accumulates Dh/8
//   columns of its row of dQ.
// - K3: the block owns 16 key rows and loops over query tiles, starting at
//   the first tile whose last row can see its first key ((k0 - offset) /
//   BQ), to the end. Each thread scores BQ/8 queries against its key, and
//   accumulates Dh/8 columns of its key's dK and dV. Splitting dQ from
//   dK/dV into two kernels, as the TPU version does, needs no atomics.
// Inputs and outputs are addressed by batch/head/row strides with a
// contiguous last dim, so q/k/v may be views into a fused qkv projection and
// the gradients can be written into a [B, T, H, Dh] layout.
//
// What bounds them on an H100: at the training shapes (T = 160, Dh = 64)
// the work is ~50 FLOP per byte, below the card's ~295 bf16 ridge, so the
// bound is device-memory bytes. What this design leaves on the table: no
// tensor cores (wgmma) and no TMA/cp.async pipelining; 2-byte scalar loads;
// K3 re-reads Q and dO once per 16-key tile (from L2); the score pass
// recomputes QK^T in both kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -0.7f * 3.4028234663852886e38f;  // _NEG_BIG
constexpr int kRows = 16;      // rows a block owns: queries (K2) or keys (K3)
constexpr int kThreads = 128;  // kRows rows x 8 lanes

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {  // batch, head, row strides in elements
  int64_t b, h, t;
};

// Rows [r0, r0 + n_rows) of one (b, h) slice into shared memory as fp32,
// row stride ld; rows at or past `limit` are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, int64_t st, int r0,
                                           int n_rows, int limit, int Dh) {
  for (int i = threadIdx.x; i < n_rows * Dh; i += kThreads) {
    const int r = i / Dh, d = i - r * Dh;
    const int t = r0 + r;
    dst[r * ld + d] = t < limit ? to_f(src[t * st + d]) : 0.f;
  }
}

template <int DMAX, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * kRows * (DMAX + 1) + 2 * BK * (DMAX + 1) + kRows * (BK + 1));
}

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int Tq, int S, int Dh,
    Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, int64_t bias_sb, int offset,
    float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = DMAX + 1;
  float* sQ = smem;                 // [kRows][LD]
  float* sDO = sQ + kRows * LD;     // [kRows][LD]
  float* sK = sDO + kRows * LD;     // [BK][LD]
  float* sV = sK + BK * LD;         // [BK][LD]
  float* sDS = sV + BK * LD;        // [kRows][BK + 1]

  const int tid = threadIdx.x;
  const int row = tid >> 3;  // query row within the tile
  const int sub = tid & 7;   // lane within the row's group of 8
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;

  stage_rows(sQ, LD, q + b * qs.b + h * qs.h, qs.t, q0, kRows, Tq, Dh);
  stage_rows(sDO, LD, dout + b * dos.b + h * dos.h, dos.t, q0, kRows, Tq, Dh);

  const int t_row = q0 + row;
  const bool row_live = t_row < Tq;
  const int64_t stat = ((int64_t)b * H + h) * Tq + t_row;
  const float lse_r = row_live ? lse[stat] : 0.f;
  const float delta_r = row_live ? delta[stat] : 0.f;
  const int q_last = min(q0 + kRows, Tq) - 1;
  const int kv_end = causal ? min(S, offset + q_last + 1) : S;
  const int qpos = offset + t_row;  // absolute position of this row's query

  float acc[DMAX / 8];
#pragma unroll
  for (int t = 0; t < DMAX / 8; ++t) acc[t] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();  // sQ/sDO written / previous tile's sK, sV consumed
    stage_rows(sK, LD, kb, ks.t, j0, BK, kv_end, Dh);
    stage_rows(sV, LD, vb, vs.t, j0, BK, kv_end, Dh);
    __syncthreads();

    float s[BK / 8], dp[BK / 8];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i] = dp[i] = 0.f;
    const float* qr = sQ + row * LD;
    const float* dor = sDO + row * LD;
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      const float qd = qr[d], dod = dor[d];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        s[i] = fmaf(qd, sK[(sub + 8 * i) * LD + d], s[i]);
        dp[i] = fmaf(dod, sV[(sub + 8 * i) * LD + d], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int j = j0 + sub + 8 * i;
      float ds = 0.f;
      if (row_live && j < kv_end) {
        float sc = s[i] * scale;
        if (biasb) sc += biasb[j];
        if (causal && j > qpos) sc = kNegBig;
        ds = expf(sc - lse_r) * (dp[i] - delta_r);
      }
      sDS[row * (BK + 1) + sub + 8 * i] = ds;
    }
    __syncwarp();  // a row's 8 lanes share one warp: dS of the row is visible

    const float* dsr = sDS + row * (BK + 1);
#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      const float dsv = dsr[jj];
      const float* kr = sK + jj * LD + sub;
#pragma unroll
      for (int t = 0; t < DMAX / 8; ++t) acc[t] = fmaf(dsv, kr[8 * t], acc[t]);
    }
  }

  if (row_live) {
    T* dqr = dq + b * dqs.b + h * dqs.h + t_row * dqs.t;
#pragma unroll
    for (int t = 0; t < DMAX / 8; ++t) {
      const int d = sub + 8 * t;
      if (d < Dh) dqr[d] = from_f<T>(acc[t] * scale);
    }
  }
}

template <int DMAX, int BQ>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (2 * kRows * (DMAX + 1) + 2 * BQ * (DMAX + 1) + 2 * kRows * (BQ + 1) + 2 * BQ);
}

template <typename T, int DMAX, int BQ>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H, int Tq,
    int S, int Dh, Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
    int64_t bias_sb, int offset, float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = DMAX + 1;
  float* sK = smem;                   // [kRows][LD]
  float* sV = sK + kRows * LD;        // [kRows][LD]
  float* sQ = sV + kRows * LD;        // [BQ][LD]
  float* sDO = sQ + BQ * LD;          // [BQ][LD]
  float* sP = sDO + BQ * LD;          // [kRows][BQ + 1]
  float* sDS = sP + kRows * (BQ + 1);  // [kRows][BQ + 1]
  float* sL = sDS + kRows * (BQ + 1);  // [BQ] lse
  float* sD = sL + BQ;                 // [BQ] delta

  const int tid = threadIdx.x;
  const int row = tid >> 3;  // key row within the tile
  const int sub = tid & 7;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const float* lseb = lse + ((int64_t)b * H + h) * Tq;
  const float* deltab = delta + ((int64_t)b * H + h) * Tq;

  stage_rows(sK, LD, k + b * ks.b + h * ks.h, ks.t, k0, kRows, S, Dh);
  stage_rows(sV, LD, v + b * vs.b + h * vs.h, vs.t, k0, kRows, S, Dh);

  const int j = k0 + row;  // this row's key
  const bool key_live = j < S;
  const float bias_j = (bias && key_live) ? bias[b * bias_sb + j] : 0.f;
  // the first query that sees key k0 sits at t = k0 - offset
  const int t_begin = causal ? max(0, k0 - offset) : 0;

  float acc_k[DMAX / 8], acc_v[DMAX / 8];
#pragma unroll
  for (int t = 0; t < DMAX / 8; ++t) acc_k[t] = acc_v[t] = 0.f;

  for (int t0 = (t_begin / BQ) * BQ; t0 < Tq; t0 += BQ) {
    __syncthreads();  // sK/sV written / previous tile's sQ, sDO consumed
    stage_rows(sQ, LD, qb, qs.t, t0, BQ, Tq, Dh);
    stage_rows(sDO, LD, dob, dos.t, t0, BQ, Tq, Dh);
    for (int i = tid; i < BQ; i += kThreads) {
      const bool live = t0 + i < Tq;
      sL[i] = live ? lseb[t0 + i] : 0.f;
      sD[i] = live ? deltab[t0 + i] : 0.f;
    }
    __syncthreads();

    float s[BQ / 8], dp[BQ / 8];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) s[i] = dp[i] = 0.f;
    const float* kr = sK + row * LD;
    const float* vr = sV + row * LD;
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        s[i] = fmaf(sQ[(sub + 8 * i) * LD + d], kd, s[i]);
        dp[i] = fmaf(sDO[(sub + 8 * i) * LD + d], vd, dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const int qq = sub + 8 * i;
      const int t = t0 + qq;
      float p = 0.f, ds = 0.f;
      if (key_live && t < Tq) {
        float sc = s[i] * scale + bias_j;
        if (causal && j > offset + t) sc = kNegBig;
        p = expf(sc - sL[qq]);
        ds = p * (dp[i] - sD[qq]);
      }
      sP[row * (BQ + 1) + qq] = p;
      sDS[row * (BQ + 1) + qq] = ds;
    }
    __syncwarp();  // a row's 8 lanes share one warp

    const float* pr = sP + row * (BQ + 1);
    const float* dsr = sDS + row * (BQ + 1);
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      const float pv = pr[qq], dsv = dsr[qq];
      const float* dor = sDO + qq * LD + sub;
      const float* qr = sQ + qq * LD + sub;
#pragma unroll
      for (int t = 0; t < DMAX / 8; ++t) {
        acc_v[t] = fmaf(pv, dor[8 * t], acc_v[t]);
        acc_k[t] = fmaf(dsv, qr[8 * t], acc_k[t]);
      }
    }
  }

  if (key_live) {
    T* dkr = dk + b * dks.b + h * dks.h + j * dks.t;
    T* dvr = dv + b * dvs.b + h * dvs.h + j * dvs.t;
#pragma unroll
    for (int t = 0; t < DMAX / 8; ++t) {
      const int d = sub + 8 * t;
      if (d < Dh) {
        dkr[d] = from_f<T>(acc_k[t] * scale);
        dvr[d] = from_f<T>(acc_v[t]);
      }
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return 0;
}

template <typename T, int DMAX, int BK>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* bias,
              const void* lse, const void* delta, void* dq, int B, int H, int Tq, int S, int Dh,
              Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, int64_t bias_sb,
              int offset, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DMAX, BK>();
  auto kernel = flash_bwd_dq_kernel<T, DMAX, BK>;
  if (int rc = set_smem(kernel, smem)) return rc;
  dim3 grid((Tq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq), H,
      Tq, S, Dh, qs, ks, vs, dos, dqs, bias_sb, offset, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX, int BQ>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* bias,
               const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Tq, int S,
               int Dh, Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
               int64_t bias_sb, int offset, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DMAX, BQ>();
  auto kernel = flash_bwd_dkv_kernel<T, DMAX, BQ>;
  if (int rc = set_smem(kernel, smem)) return rc;
  dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Tq, S, Dh, qs, ks, vs, dos, dks, dvs, bias_sb, offset, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout, const void* bias,
                const void* lse, const void* delta, void* dq, int B, int H, int Tq, int S, int Dh,
                Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, int64_t bias_sb,
                int offset, float scale, int causal, cudaStream_t st) {
#define DQ_ARGS q, k, v, dout, bias, lse, delta, dq, B, H, Tq, S, Dh, qs, ks, vs, dos, dqs, \
    bias_sb, offset, scale, causal, st
  if (Dh <= 64) return launch_dq<T, 64, 64>(DQ_ARGS);
  if (Dh <= 128) return launch_dq<T, 128, 32>(DQ_ARGS);
  return launch_dq<T, 256, 16>(DQ_ARGS);
#undef DQ_ARGS
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* bias,
                 const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Tq,
                 int S, int Dh, Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
                 Strides dvs, int64_t bias_sb, int offset, float scale, int causal,
                 cudaStream_t st) {
#define DKV_ARGS q, k, v, dout, bias, lse, delta, dk, dv, B, H, Tq, S, Dh, qs, ks, vs, dos, dks, \
    dvs, bias_sb, offset, scale, causal, st
  if (Dh <= 64) return launch_dkv<T, 64, 64>(DKV_ARGS);
  if (Dh <= 128) return launch_dkv<T, 128, 32>(DKV_ARGS);
  return launch_dkv<T, 256, 16>(DKV_ARGS);
#undef DKV_ARGS
}

bool bad_shape(int B, int H, int Tq, int S, int Dh) {
  return Dh <= 0 || Dh > 256 || Dh % 8 != 0 || B <= 0 || H <= 0 || Tq <= 0 || S <= 0 ||
         Tq > S || B > 65535 || H > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients alike).
// Every tensor argument is indexed by (b, h, t) strides with a contiguous
// last dim, except lse and delta: contiguous [B, H, Tq] float32. bias is
// [B, >= S] float32 with row stride bias_sb, or null. Each returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for a shape the
// kernel does not take).
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const void* bias, const void* lse,
                            const void* delta, void* dq, int B, int H, int Tq, int S, int Dh,
                            long long q_sb, long long q_sh, long long q_st,
                            long long k_sb, long long k_sh, long long k_st,
                            long long v_sb, long long v_sh, long long v_st,
                            long long do_sb, long long do_sh, long long do_st,
                            long long dq_sb, long long dq_sh, long long dq_st,
                            long long bias_sb, int offset, float scale, int causal,
                            void* stream) {
  if (bad_shape(B, H, Tq, S, Dh)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st}, vs{v_sb, v_sh, v_st};
  const Strides dos{do_sb, do_sh, do_st}, dqs{dq_sb, dq_sh, dq_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_dq<float>(q, k, v, dout, bias, lse, delta, dq, B, H, Tq, S, Dh, qs, ks, vs,
                              dos, dqs, bias_sb, offset, scale, causal, st);
  }
  if (dtype == 1) {
    return dispatch_dq<__nv_bfloat16>(q, k, v, dout, bias, lse, delta, dq, B, H, Tq, S, Dh, qs,
                                      ks, vs, dos, dqs, bias_sb, offset, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, const void* bias, const void* lse,
                             const void* delta, void* dk, void* dv, int B, int H, int Tq, int S,
                             int Dh, long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st,
                             long long do_sb, long long do_sh, long long do_st,
                             long long dk_sb, long long dk_sh, long long dk_st,
                             long long dv_sb, long long dv_sh, long long dv_st,
                             long long bias_sb, int offset, float scale, int causal,
                             void* stream) {
  if (bad_shape(B, H, Tq, S, Dh)) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st}, vs{v_sb, v_sh, v_st};
  const Strides dos{do_sb, do_sh, do_st}, dks{dk_sb, dk_sh, dk_st}, dvs{dv_sb, dv_sh, dv_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_dkv<float>(q, k, v, dout, bias, lse, delta, dk, dv, B, H, Tq, S, Dh, qs, ks,
                               vs, dos, dks, dvs, bias_sb, offset, scale, causal, st);
  }
  if (dtype == 1) {
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, bias, lse, delta, dk, dv, B, H, Tq, S, Dh,
                                       qs, ks, vs, dos, dks, dvs, bias_sb, offset, scale, causal,
                                       st);
  }
  return (int)cudaErrorInvalidValue;
}
