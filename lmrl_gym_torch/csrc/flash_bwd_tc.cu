// Causal flash-attention backward on Hopper's tensor cores (sm_90a), bf16,
// plain C interface.
//
// Replaces the Pallas kernels lmrl_gym_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel (K2) and _flash_bwd_dkv_kernel (K3), launched by
// _flash_backward, for bf16 inputs with a head dim that is a multiple of 16
// up to 128 (csrc/flash_bwd.cu keeps f32 and Dh = 256). Same functions:
//   s  = scale * Q K^T + bias, masked to -0.7 * FLT_MAX where a key lies past
//        its query (queries right-aligned at offset = S - Tq),
//   P  = exp(s - lse),  dS = P * (dO V^T - delta),  delta = rowsum(dO * O),
//   K2: dQ = scale * dS K                  (one block per 64-query tile),
//   K3: dV = P^T dO,  dK = scale * dS^T Q  (one block per 64-key tile).
// Split into two kernels as on the TPU, so K3 needs no atomics.
//
// Bound at the training shapes (B = 32, H = 12, T = 160, Dh = 64): device
// memory bytes, 11.9 us (K2) and 14.2 us (K3) at 3.35 TB/s; their tensor-core
// FLOPs take 1.9 and 2.6 us at 989 TF/s. So the products use mma.sync
// (m16n8k16, bf16 in, f32 sums) fed by ldmatrix, not wgmma: the kernels do
// not need the last factor of FLOP rate, and the register fragments of
// mma.sync let P and dS go from one product's accumulator to the next
// product's A operand without a trip through shared memory.
//
// Design: 128 threads = 4 warps; the block owns 64 rows (queries in K2, keys
// in K3), each warp 16 of them. The other side streams in 32-row tiles
// through a two-stage ring in shared memory, filled with 16-byte cp.async
// (zero-filled past the sequence end and past Dh), one stage in flight while
// the other is used:
// - K2: per 32-key tile, S = Q K^T and dP = dO V^T (B operands K, V read as
//   stored), dS in the accumulator registers, rounded to bf16 as the A
//   operand of dQ += dS K (K read transposed with ldmatrix.trans). The key
//   loop stops at the block's last causally live key.
// - K3: per 32-query tile, S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T
//   come out in the A layout of dV += P^T dO and dK += dS^T Q (dO and Q read
//   transposed). The query loop starts at the first tile whose last row sees
//   the block's first key: (k0 - offset) / BQ.
// Masking is done per element in fragment coordinates. Rows are padded by
// 16 bytes in shared memory, so the 8 rows an ldmatrix reads fall in 8
// different bank groups. Fully masked (left-pad) query rows keep the
// reference's behaviour: their lse is -0.7 * FLT_MAX, so P = 1 on their keys.
//
// At these shapes a block runs 1-5 short tiles, so the kernels are bound by
// latency (load waits, mma and ldmatrix chains), not by bytes or tensor-core
// rate: what moved them on an H100 was more resident warps. Hence 32-row
// streamed tiles (fewer accumulator registers than 64) and launch bounds that
// cap registers for 5 (K2) and 4 (K3) blocks per SM at Dh <= 64. On an H100,
// 16-row tiles, tighter caps, skipping masked 16-row strips inside diagonal
// tiles (predicated mma in the unrolled loops), and launching the heavy
// query tiles first were no faster.
//
// What it still leaves: warp specialisation (a producer warp with TMA and
// mbarriers) and wgmma; a persistent grid (the last 32-row tile of T = 160
// leaves half a block idle); K2 and K3 fused into one pass with dQ by
// atomics; delta = rowsum(dO * O) computed inside the kernels instead of by
// the caller; staging the epilogue through shared memory for 16-byte stores.

#include "tc_common.cuh"

namespace {

constexpr int kTile = 64;      // rows a block owns: queries (K2) or keys (K3)
constexpr int kThreads = 128;  // 4 warps x 16 rows

// acc[n] += A (16 rows of `a_src`, DMAX deep) * B^T, B = NB rows of `b_src`
// (row stride DMAX + 8): one warp's 16 x NB product over the head dim.
template <int DMAX, int NB>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[NB / 8][4], const bf16* a_src, const bf16* b_src,
                                              int lane) {
  constexpr int LD = DMAX + 8;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_src + a_row(lane) * LD + kk * 16 + a_col(lane));
#pragma unroll
    for (int np = 0; np < NB / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_src + (np * 16 + b_row(lane)) * LD + kk * 16 + b_col(lane));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

template <int DMAX, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (2 * kTile + 4 * BK) * (DMAX + 8) + sizeof(float) * 2 * BK;
}

template <int DMAX, int BK, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS) flash_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Tq, int S, int Dh, Strides qs,
    Strides ks, Strides vs, Strides dos, Strides dqs, int64_t bias_sb, int offset, float scale, int causal) {
  constexpr int LD = DMAX + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [kTile][LD]
  bf16* sDO = sQ + kTile * LD;               // [kTile][LD]
  bf16* sK = sDO + kTile * LD;               // [2][BK][LD]
  bf16* sV = sK + 2 * BK * LD;               // [2][BK][LD]
  float* sB = reinterpret_cast<float*>(sV + 2 * BK * LD);  // [2][BK] bias

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  // keys past the causal limit of the block's last query are never read
  const int q_last = min(q0 + kTile, Tq) - 1;
  const int kv_end = causal ? min(S, offset + q_last + 1) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;

  load_tile<kTile, DMAX, kThreads>(sQ, q + b * qs.b + h * qs.h, qs.t, q0, Tq, Dh, threadIdx.x);
  load_tile<kTile, DMAX, kThreads>(sDO, dout + b * dos.b + h * dos.h, dos.t, q0, Tq, Dh, threadIdx.x);
  cp_async_commit();
  auto load_kv = [&](int it) {
    const int stage = it & 1;
    load_tile<BK, DMAX, kThreads>(sK + stage * BK * LD, kb, ks.t, it * BK, kv_end, Dh, threadIdx.x);
    load_tile<BK, DMAX, kThreads>(sV + stage * BK * LD, vb, vs.t, it * BK, kv_end, Dh, threadIdx.x);
    if (biasb) load_vec<BK, kThreads>(sB + stage * BK, biasb, it * BK, kv_end, threadIdx.x);
    cp_async_commit();
  };
  load_kv(0);

  // this thread's query rows: r (fragment row g) and r + 8 of the warp's 16
  const int r_lo = warp * 16 + g;
  int t_row[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    t_row[i] = q0 + r_lo + 8 * i;
    const int64_t stat = ((int64_t)b * H + h) * Tq + t_row[i];
    lse_r[i] = t_row[i] < Tq ? lse[stat] : 0.f;
    delta_r[i] = t_row[i] < Tq ? delta[stat] : 0.f;
  }

  float acc[DMAX / 8][4];
  zero(acc);

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + (it & 1) * BK * LD;
    const bf16* cV = sV + (it & 1) * BK * LD;
    const float* cB = sB + (it & 1) * BK;

    float s[BK / 8][4], dp[BK / 8][4];
    zero(s);
    zero(dp);
    rows_dot_rows<DMAX, BK>(s, sQ + warp * 16 * LD, cK, lane);
    rows_dot_rows<DMAX, BK>(dp, sDO + warp * 16 * LD, cV, lane);

    // dS = P * (dP - delta), P = exp(s - lse), in place of s
    const int j0 = it * BK;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = n * 8 + 2 * tq + (e & 1), j = j0 + jj, i = e >> 1;
        float ds = 0.f;
        if (t_row[i] < Tq && j < kv_end) {
          float sc = s[n][e] * scale;
          if (biasb) sc += cB[jj];
          if (causal && j > offset + t_row[i]) sc = kNegBig;
          ds = __expf(sc - lse_r[i]) * (dp[n][e] - delta_r[i]);
        }
        s[n][e] = ds;
      }
    }
    acc_dot_rows<DMAX, BK>(acc, s, cK, lane);
    __syncthreads();  // this stage is consumed before the next prefetch overwrites it
  }

  store_rows<DMAX>(dq + b * dqs.b + h * dqs.h + q0 * dqs.t, dqs.t, acc, r_lo, Tq - q0, Dh, scale, tq);
}

template <int DMAX, int BQ>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (2 * kTile + 4 * BQ) * (DMAX + 8) + sizeof(float) * 4 * BQ;
}

template <int DMAX, int BQ, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS) flash_bwd_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Tq, int S,
    int Dh, Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, int64_t bias_sb,
    int offset, float scale, int causal) {
  constexpr int LD = DMAX + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // [kTile][LD]
  bf16* sV = sK + kTile * LD;                // [kTile][LD]
  bf16* sQ = sV + kTile * LD;                // [2][BQ][LD]
  bf16* sDO = sQ + 2 * BQ * LD;              // [2][BQ][LD]
  float* sL = reinterpret_cast<float*>(sDO + 2 * BQ * LD);  // [2][BQ] lse
  float* sD = sL + 2 * BQ;                                   // [2][BQ] delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const float* lseb = lse + ((int64_t)b * H + h) * Tq;
  const float* deltab = delta + ((int64_t)b * H + h) * Tq;
  // the first query that sees key k0 sits at t = k0 - offset
  const int it0 = causal ? max(0, k0 - offset) / BQ : 0;
  const int n_tiles = (Tq + BQ - 1) / BQ;

  load_tile<kTile, DMAX, kThreads>(sK, k + b * ks.b + h * ks.h, ks.t, k0, S, Dh, threadIdx.x);
  load_tile<kTile, DMAX, kThreads>(sV, v + b * vs.b + h * vs.h, vs.t, k0, S, Dh, threadIdx.x);
  cp_async_commit();
  auto load_q = [&](int it) {
    const int stage = it & 1;
    load_tile<BQ, DMAX, kThreads>(sQ + stage * BQ * LD, qb, qs.t, it * BQ, Tq, Dh, threadIdx.x);
    load_tile<BQ, DMAX, kThreads>(sDO + stage * BQ * LD, dob, dos.t, it * BQ, Tq, Dh, threadIdx.x);
    load_vec<BQ, kThreads>(sL + stage * BQ, lseb, it * BQ, Tq, threadIdx.x);
    load_vec<BQ, kThreads>(sD + stage * BQ, deltab, it * BQ, Tq, threadIdx.x);
    cp_async_commit();
  };
  if (it0 < n_tiles) load_q(it0);

  // this thread's key rows: r (fragment row g) and r + 8 of the warp's 16
  const int r_lo = warp * 16 + g;
  int j_row[2];
  float bias_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    j_row[i] = k0 + r_lo + 8 * i;
    bias_r[i] = (bias && j_row[i] < S) ? bias[b * bias_sb + j_row[i]] : 0.f;
  }

  float acc_k[DMAX / 8][4], acc_v[DMAX / 8][4];
  zero(acc_k);
  zero(acc_v);

  for (int it = it0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_q(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQ + (it & 1) * BQ * LD;
    const bf16* cDO = sDO + (it & 1) * BQ * LD;
    const float* cL = sL + (it & 1) * BQ;
    const float* cD = sD + (it & 1) * BQ;

    float p[BQ / 8][4], ds[BQ / 8][4];  // S^T, dP^T, then P^T, dS^T
    zero(p);
    zero(ds);
    rows_dot_rows<DMAX, BQ>(p, sK + warp * 16 * LD, cQ, lane);
    rows_dot_rows<DMAX, BQ>(ds, sV + warp * 16 * LD, cDO, lane);

    const int t0 = it * BQ;
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = n * 8 + 2 * tq + (e & 1), t = t0 + tt, i = e >> 1;
        float pv = 0.f, dsv = 0.f;
        if (j_row[i] < S && t < Tq) {
          float sc = p[n][e] * scale + bias_r[i];
          if (causal && j_row[i] > offset + t) sc = kNegBig;
          pv = __expf(sc - cL[tt]);
          dsv = pv * (ds[n][e] - cD[tt]);
        }
        p[n][e] = pv;
        ds[n][e] = dsv;
      }
    }
    acc_dot_rows<DMAX, BQ>(acc_v, p, cDO, lane);
    acc_dot_rows<DMAX, BQ>(acc_k, ds, cQ, lane);
    __syncthreads();  // this stage is consumed before the next prefetch overwrites it
  }
  cp_async_wait<0>();  // K/V's group when the loop ran no iteration

  store_rows<DMAX>(dk + b * dks.b + h * dks.h + k0 * dks.t, dks.t, acc_k, r_lo, S - k0, Dh, scale, tq);
  store_rows<DMAX>(dv + b * dvs.b + h * dvs.h + k0 * dvs.t, dvs.t, acc_v, r_lo, S - k0, Dh, 1.f, tq);
}

template <int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* bias, const void* lse,
              const void* delta, void* dq, int B, int H, int Tq, int S, int Dh, Strides qs, Strides ks,
              Strides vs, Strides dos, Strides dqs, int64_t bias_sb, int offset, float scale, int causal,
              cudaStream_t stream) {
  // 32-key tiles, registers capped for 5 blocks (20 warps) per SM up to
  // Dh = 64: the kernel is latency-bound, and more resident warps hide it
  constexpr int BK = 32, kMinBlocks = DMAX <= 64 ? 5 : 1;
  constexpr size_t smem = dq_smem_bytes<DMAX, BK>();
  auto kernel = flash_bwd_dq_tc_kernel<DMAX, BK, kMinBlocks>;
  if (int rc = set_smem(kernel, smem)) return rc;
  dim3 grid((Tq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), H, Tq, S, Dh, qs, ks, vs, dos, dqs, bias_sb,
      offset, scale, causal);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* bias, const void* lse,
               const void* delta, void* dk, void* dv, int B, int H, int Tq, int S, int Dh, Strides qs,
               Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs, int64_t bias_sb, int offset,
               float scale, int causal, cudaStream_t stream) {
  // 32-query tiles, registers capped for 4 blocks (16 warps) per SM up to
  // Dh = 64 (Dh = 128 keeps its four 16 x 128 accumulators without a cap)
  constexpr int BQ = 32, kMinBlocks = DMAX <= 64 ? 4 : 1;
  constexpr size_t smem = dkv_smem_bytes<DMAX, BQ>();
  auto kernel = flash_bwd_dkv_tc_kernel<DMAX, BQ, kMinBlocks>;
  if (int rc = set_smem(kernel, smem)) return rc;
  dim3 grid((S + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(bias), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Tq, S, Dh, qs, ks,
      vs, dos, dks, dvs, bias_sb, offset, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, dout and gradients, indexed by (b, h, t) strides with a
// contiguous last dim; lse and delta contiguous [B, H, Tq] float32; bias
// [B, >= S] float32 with row stride bias_sb, or null. Each returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for a shape
// or alignment the kernel does not take.
extern "C" int flash_bwd_dq_tc(const void* q, const void* k, const void* v, const void* dout, const void* bias,
                               const void* lse, const void* delta, void* dq, int B, int H, int Tq, int S,
                               int Dh, long long q_sb, long long q_sh, long long q_st, long long k_sb,
                               long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
                               long long do_sb, long long do_sh, long long do_st, long long dq_sb,
                               long long dq_sh, long long dq_st, long long bias_sb, int offset, float scale,
                               int causal, void* stream) {
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st}, vs{v_sb, v_sh, v_st};
  const Strides dos{do_sb, do_sh, do_st}, dqs{dq_sb, dq_sh, dq_st};
  if (bad_shape(B, H, Tq, S, Dh) || misaligned(q, qs) || misaligned(k, ks) || misaligned(v, vs) ||
      misaligned(dout, dos) || misaligned_out(dq, dqs)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DQ_ARGS q, k, v, dout, bias, lse, delta, dq, B, H, Tq, S, Dh, qs, ks, vs, dos, dqs, bias_sb, offset, \
    scale, causal, st
  if (Dh <= 32) return launch_dq<32>(DQ_ARGS);
  if (Dh <= 64) return launch_dq<64>(DQ_ARGS);
  return launch_dq<128>(DQ_ARGS);
#undef DQ_ARGS
}

extern "C" int flash_bwd_dkv_tc(const void* q, const void* k, const void* v, const void* dout, const void* bias,
                                const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Tq,
                                int S, int Dh, long long q_sb, long long q_sh, long long q_st, long long k_sb,
                                long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
                                long long do_sb, long long do_sh, long long do_st, long long dk_sb,
                                long long dk_sh, long long dk_st, long long dv_sb, long long dv_sh,
                                long long dv_st, long long bias_sb, int offset, float scale, int causal,
                                void* stream) {
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st}, vs{v_sb, v_sh, v_st};
  const Strides dos{do_sb, do_sh, do_st}, dks{dk_sb, dk_sh, dk_st}, dvs{dv_sb, dv_sh, dv_st};
  if (bad_shape(B, H, Tq, S, Dh) || misaligned(q, qs) || misaligned(k, ks) || misaligned(v, vs) ||
      misaligned(dout, dos) || misaligned_out(dk, dks) || misaligned_out(dv, dvs)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKV_ARGS q, k, v, dout, bias, lse, delta, dk, dv, B, H, Tq, S, Dh, qs, ks, vs, dos, dks, dvs, bias_sb, \
    offset, scale, causal, st
  if (Dh <= 32) return launch_dkv<32>(DKV_ARGS);
  if (Dh <= 64) return launch_dkv<64>(DKV_ARGS);
  return launch_dkv<128>(DKV_ARGS);
#undef DKV_ARGS
}
