// Causal flash-attention forward on Hopper's tensor cores (sm_90a), bf16,
// plain C interface.
//
// Replaces the Pallas kernel lmrl_gym_tpu/ops/flash_attention.py::
// _flash_kernel (K1, launched by _flash_forward) for bf16 inputs with a head
// dim that is a multiple of 16 up to 128 (csrc/flash_fwd.cu keeps f32 and
// Dh = 256). Same function:
//   O = softmax(scale * Q K^T + bias, causal with queries right-aligned at
//       offset = S - Tq) V,   lse = per-row logsumexp,
// masked scores at -0.7 * FLT_MAX, f32 online softmax and f32 sums, keys
// past the causal limit of a block's last query never read.
//
// What bounds it on an H100: at the serving path's shapes (B = 512, H = 12,
// Dh = 64, Tq = 8 or 10 queries over S <= 128 cached keys) device-memory
// bytes: K and V of the filled prefix, ~10 FLOP per byte, 36.6 us at
// 3.35 TB/s on the mean shape. At the training shapes (B = 32, T = 160) the
// bytes take 9.5 us and the tensor-core FLOPs 2 us, but a block runs only
// 1-3 short key tiles, so latency (load waits, the mma -> exp -> mma chain)
// decides, as in the backward kernels.
//
// Design: every warp owns 16 query rows (one m16 tile) and keeps its Q
// fragments in registers, loaded straight from global memory. Keys and
// values stream through a ring of stages in shared memory, filled by
// 16-byte cp.async (zero-filled past the stream's end and past Dh) with
// STAGES - 1 tiles in flight and one barrier per tile. Per key tile:
// S = Q K^T by mma.sync m16n8k16 (bf16 in, f32 sums; K read as stored with
// ldmatrix); scale, bias and masks applied to the f32 accumulator in
// fragment coordinates; the row max and the rescale of the running sums
// reduced over the 4 lanes that share a row; P = exp(s - m) rounded once to
// bf16 straight into the A operand of O += P V (V read with
// ldmatrix.trans), the row sum taken from P in f32. Two block shapes, picked
// from Tq:
// - Tq > 16 (training, T = 160): a block of 4 warps takes 64 consecutive
//   query rows of one (b, h) and the warps share 32-key tiles in two
//   stages. The key loop stops at the block's last causally live key, and a
//   warp skips the products of tiles wholly past its own rows' limit.
// - Tq <= 16 (serving's appends, the next-window forward): each warp takes a
//   (b, h) of its own and streams its own K/V, so no block carries 64 rows
//   for 10 queries. Bytes in flight per SM are what counts here: 16 warps
//   per SM (blocks of two), each with two 16-key tiles (4 KB of K and V at
//   Dh = 64 each) loading while it computes on a third.
// A sweep of launch shapes on an H100 (Dh = 64) chose these: 32-key tiles
// beat 64 at T = 160 (64 needs more registers than the cap for 4 blocks
// per SM), and one barrier per tile beat two; 2-warp blocks, a third stage,
// and launching the heaviest 64-row tiles first were no faster there. For
// the per-warp shape, tile sizes of 16 to 64 keys, 2 to 4 stages and 1 to 4
// warps per block made little difference.
// Keys past the stream's end score -inf (weight exactly 0, never the
// -0.7 * FLT_MAX of a masked key, which a zero key would share); fully
// masked (left-pad) query rows keep lse = -0.7 * FLT_MAX, which the backward
// kernels read as P = 1. Scale, bias and masks are applied before any
// exponent, and exp is taken of (s - m), never of a scaled mask value.
//
// What it still leaves: wgmma with TMA and mbarriers, warp specialisation
// and a persistent grid (the last 64-row tile of T = 160 leaves half a block
// idle); 16 of the warp's rows are computed for serving's 10 queries;
// bf16 with Dh = 256; the epilogue writes bf16 pairs, not 16-byte rows.

#include <math.h>

#include "tc_common.cuh"

namespace {

constexpr int kRows = 16;  // query rows of one warp: one m16 tile

// One K/V stream: STAGES stages of K and V tiles and of the bias.
template <int DMAX, int BK, int STAGES>
__host__ __device__ constexpr size_t stream_bytes() {
  return STAGES * (sizeof(bf16) * 2 * BK * (DMAX + 8) + sizeof(float) * BK);
}

template <bool SHARED>
__device__ __forceinline__ void stream_sync() {
  if constexpr (SHARED) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float quad_max(float x) {  // over the 4 lanes of a fragment row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// SHARED: the block's WARPS warps own 16 consecutive query rows each of one
// (b, h) and share one K/V stream. Otherwise each warp owns all Tq <= 16
// rows of a (b, h) of its own and streams its own K/V.
template <int DMAX, int BK, int STAGES, int WARPS, bool SHARED, int MIN_BLOCKS>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) flash_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, bf16* __restrict__ out, float* __restrict__ lse, int B, int H, int Tq, int S,
    int Dh, Strides qs, Strides ks, Strides vs, Strides os, int64_t bias_sb, int offset, float scale, int causal) {
  constexpr int LD = DMAX + 8;
  constexpr int STAGE = 2 * BK * LD;  // elements of one stage: K then V
  constexpr int NT = SHARED ? WARPS * 32 : 32;  // threads that fill one stream
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row and column pair
  int b, h, q0, qt = 0;  // q0: the warp's first query row; qt: the block's 64-row tile
  if constexpr (SHARED) {
    qt = blockIdx.x;
    b = blockIdx.z;
    h = blockIdx.y;
    q0 = qt * (WARPS * kRows) + warp * kRows;
  } else {
    const int64_t bh = (int64_t)blockIdx.x * WARPS + warp;
    if (bh >= (int64_t)B * H) return;  // nothing here waits on other warps
    b = (int)(bh / H);
    h = (int)(bh % H);
    q0 = 0;
  }
  bf16* sKV = reinterpret_cast<bf16*>(smem + (SHARED ? 0 : warp * stream_bytes<DMAX, BK, STAGES>()));
  float* sB = reinterpret_cast<float*>(sKV + STAGES * STAGE);  // [STAGES][BK]
  const int tid = SHARED ? (int)threadIdx.x : lane;

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  // keys [0, kv_end) are streamed: up to the causal limit of the stream's
  // last query; a warp computes on keys [0, warp_end) of them
  const int rows_end = SHARED ? min((qt + 1) * WARPS * kRows, Tq) : Tq;
  const int kv_end = causal ? min(S, offset + rows_end) : S;
  const int warp_end = q0 >= Tq ? 0 : causal ? min(S, offset + min(q0 + kRows, Tq)) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;

  // tile `it` into stage it % STAGES, one cp.async group per tile (an empty
  // group past the last tile, so that group counts stay uniform)
  auto load_kv = [&](int it) {
    if (it < n_tiles) {
      bf16* st = sKV + (it % STAGES) * STAGE;
      load_tile<BK, DMAX, NT>(st, kb, ks.t, it * BK, kv_end, Dh, tid);
      load_tile<BK, DMAX, NT>(st + BK * LD, vb, vs.t, it * BK, kv_end, Dh, tid);
      if (biasb) load_vec<BK, NT>(sB + (it % STAGES) * BK, biasb, it * BK, kv_end, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) load_kv(it);

  // this thread's query rows: q0 + g (fragment row g) and q0 + g + 8; their
  // A fragments of Q for each k16 step of the head dim, zero past Tq and Dh
  const int t_row[2] = {q0 + g, q0 + g + 8};
  const bf16* qb = q + b * qs.b + h * qs.h;
  uint32_t qf[DMAX / 16][4];
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool live = t_row[i] < Tq && kk * 16 < Dh;
      const bf16* p = qb + t_row[i] * qs.t + kk * 16 + 2 * tq;
      qf[kk][i] = live ? ldg32(p) : 0u;
      qf[kk][i + 2] = live ? ldg32(p + 8) : 0u;
    }
  }

  float acc[DMAX / 8][4];
  zero(acc);
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};  // l: this lane's part of the row sum

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();  // tile it has landed (this thread's copies)
    // ... and every thread's; and every warp is done with tile it - 1, whose
    // stage the next load overwrites
    stream_sync<SHARED>();
    load_kv(it + STAGES - 1);
    const int j0 = it * BK;
    if (j0 < warp_end) {
      const bf16* cK = sKV + (it % STAGES) * STAGE;
      const bf16* cV = cK + BK * LD;
      const float* cB = sB + (it % STAGES) * BK;

      float s[BK / 8][4];
      zero(s);
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, cK + (np * 16 + b_row(lane)) * LD + kk * 16 + b_col(lane));
          mma(s[2 * np], qf[kk], kf[0], kf[1]);
          mma(s[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // scores: scaled, biased and masked in f32, then the row max
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = n * 8 + 2 * tq + (e & 1), j = j0 + jj, i = e >> 1;
          float x;
          if (j >= kv_end) {
            x = -INFINITY;  // zero-filled past the stream's end: weight exactly 0
          } else {
            x = s[n][e] * scale;
            if (biasb) x += cB[jj];
            if (causal && j > offset + t_row[i]) x = kNegBig;
          }
          s[n][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));  // finite: key j0 is live
        alpha[i] = __expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(s[n][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[n][e] = p;
        }
      }
      acc_dot_rows<DMAX, BK>(acc, s, cV, lane);  // O += P V, P rounded to bf16
    }
  }

  float lse_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lc = fmaxf(quad_sum(l[i]), 1e-30f);
    lse_r[i] = m[i] + logf(lc);
    l[i] = 1.f / lc;
  }
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    acc[n][0] *= l[0];
    acc[n][1] *= l[0];
    acc[n][2] *= l[1];
    acc[n][3] *= l[1];
  }
  store_rows<DMAX>(out + b * os.b + h * os.h + q0 * os.t, os.t, acc, g, Tq - q0, Dh, 1.f, tq);
  if (tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (t_row[i] < Tq) lse[((int64_t)b * H + h) * Tq + t_row[i]] = lse_r[i];
    }
  }
}

template <int DMAX, int BK, int STAGES, int WARPS, bool SHARED, int MIN_BLOCKS>
int launch_shape(dim3 grid, const void* q, const void* k, const void* v, const void* bias, void* out, void* lse,
                 int B, int H, int Tq, int S, int Dh, Strides qs, Strides ks, Strides vs, Strides os,
                 int64_t bias_sb, int offset, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = (SHARED ? 1 : WARPS) * stream_bytes<DMAX, BK, STAGES>();
  auto kernel = flash_fwd_tc_kernel<DMAX, BK, STAGES, WARPS, SHARED, MIN_BLOCKS>;
  if (int rc = set_smem(kernel, smem)) return rc;
  kernel<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), static_cast<bf16*>(out), static_cast<float*>(lse), B, H, Tq, S, Dh, qs, ks,
      vs, os, bias_sb, offset, scale, causal);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, void* lse, int B, int H,
           int Tq, int S, int Dh, Strides qs, Strides ks, Strides vs, Strides os, int64_t bias_sb, int offset,
           float scale, int causal, cudaStream_t stream) {
#define FWD_ARGS q, k, v, bias, out, lse, B, H, Tq, S, Dh, qs, ks, vs, os, bias_sb, offset, scale, causal, stream
  if (Tq <= kRows) {
    // one (b, h) per warp, two warps per block, 16-key tiles in three
    // stages: eight blocks (16 warps) per SM up to Dh = 64
    constexpr int kWarps = 2;
    const dim3 grid((unsigned)(((int64_t)B * H + kWarps - 1) / kWarps));
    return launch_shape<DMAX, 16, 3, kWarps, false, DMAX <= 64 ? 8 : 3>(grid, FWD_ARGS);
  }
  // 64 query rows per block (four warps) over shared 32-key tiles in two
  // stages, registers capped for 4 blocks per SM up to Dh = 64
  constexpr int kWarps = 4;
  const dim3 grid((Tq + kWarps * kRows - 1) / (kWarps * kRows), H, B);
  return launch_shape<DMAX, 32, 2, kWarps, true, DMAX <= 64 ? 4 : 1>(grid, FWD_ARGS);
#undef FWD_ARGS
}

}  // namespace

// bf16 q, k, v and out, indexed by (b, h, t) strides with a contiguous last
// dim; lse contiguous [B, H, Tq] float32; bias [B, >= S] float32 with row
// stride bias_sb, or null. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape or alignment the kernel does not take.
extern "C" int flash_fwd_tc(const void* q, const void* k, const void* v, const void* bias, void* out, void* lse,
                            int B, int H, int Tq, int S, int Dh, long long q_sb, long long q_sh, long long q_st,
                            long long k_sb, long long k_sh, long long k_st, long long v_sb, long long v_sh,
                            long long v_st, long long o_sb, long long o_sh, long long o_st, long long bias_sb,
                            int offset, float scale, int causal, void* stream) {
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st}, vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  if (bad_shape(B, H, Tq, S, Dh) || misaligned(q, qs) || misaligned(k, ks) || misaligned(v, vs) ||
      misaligned_out(out, os)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD_ARGS q, k, v, bias, out, lse, B, H, Tq, S, Dh, qs, ks, vs, os, bias_sb, offset, scale, causal, st
  if (Dh <= 32) return launch<32>(FWD_ARGS);
  if (Dh <= 64) return launch<64>(FWD_ARGS);
  return launch<128>(FWD_ARGS);
#undef FWD_ARGS
}
