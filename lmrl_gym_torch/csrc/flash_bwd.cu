// Causal flash-attention backward on Hopper's fp32 CUDA cores (sm_90a), plain
// C interface.
//
// Replaces the Pallas kernels lmrl_gym_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel (K2, :182, pallas_call :310) and _flash_bwd_dkv_kernel
// (K3, :229, pallas_call :324), launched by _flash_backward, for f32 inputs
// and for bf16 with a head dim that is not a multiple of 16
// (csrc/flash_bwd_tc.cu takes the rest of bf16). Same functions, with P
// rebuilt from the forward's saved logsumexp:
//   s  = scale * Q K^T + bias, masked to -0.7 * FLT_MAX where a key lies past
//        its query (queries right-aligned at offset = S - Tq),
//   P  = exp(s - lse),  dS = P * (dO V^T - delta),  delta = rowsum(dO * O),
//   K2: dQ = scale * dS K                  (one block per 64 query rows),
//   K3: dV = P^T dO,  dK = scale * dS^T Q  (one block per 64 key rows).
// delta is computed by the caller (as the JAX package computes it outside
// its kernels). dQ stays in K2 and dK/dV in K3: no atomics, no split sums,
// so a launch repeats to the bit. A fully masked (left-pad) row reads
// P = 1 from lse = -0.7 * FLT_MAX on the pairs a block visits; every loss
// gives such rows a zero cotangent, so their dS is 0.
//
// What bounds them on an H100: f32 stays off the tensor cores (TF32 is off
// by the port's rule, core/device.py), so at the dialog gates' train windows
// (T = 256 to 768, Dh = 32 to 64) the bound is f32 FMA issue at 67 TF/s:
// 6 Dh FLOPs per visible (query, key) pair in K2, 8 Dh in K3. The first
// version of these kernels (16 rows per block, every FMA fed by its own
// shared-memory load, tiles staged by scalar loads) was bound by
// shared-memory issue at 0.07-0.14 of that bound.
//
// Design, after csrc/flash_fwd.cu: a block of 256 threads owns 64 rows of
// one (b, h) and keeps them in shared memory as f32 for the whole block,
// while the other side streams through a two-stage ring of 16-byte cp.async
// copies (bf16 is copied raw and converted from shared memory). The threads
// form a 16 x 16 grid: thread (tr, tc) owns the block's rows 4 tr + i
// (i < 4), so warp w owns rows 8 w .. 8 w + 7, and in each streamed tile the
// columns tc + 16 j (j < BN / 16). A step of a score loop takes four
// consecutive dims: four 16-byte loads of the block's rows (a broadcast) and
// BN / 16 of the tile's rows feed 16 BN / 16 FMAs, 8 per load at BN = 64.
// - K2 (dQ): rows are queries; K/V tiles of BK keys. Thread (tr, tc) holds
//   4 x BK/16 micro-tiles of S = Q K^T and dP = dO V^T (two passes over Dh,
//   so only one pair of operand sets is live), lse and delta of its rows in
//   registers. dS goes to shared memory as [key][row], over the V stage of
//   the tile (a barrier lets every warp finish dP first), and dQ += dS K
//   takes K1's P V split: rows 4 tr + i, OW consecutive dims per 16 OW-dim
//   chunk from 4 tc, one 16-byte load of dS and one of K per key and chunk
//   for 16 FMAs. Blocks take query tiles from the last (the longest key
//   range) to the first; on the causal diagonal a warp skips the 16-key
//   blocks, and the dS K keys, wholly past its last query.
// - K3 (dK, dV): rows are keys, with their bias in registers; Q/dO tiles of
//   BQ queries with their lse and delta slices stream from the first query
//   that sees the block's first key (k0 - offset), unaligned. Thread (tr, tc)
//   holds 4 x BQ/16 micro-tiles of S^T = K Q^T and dP^T = V dO^T; P^T and
//   dS^T go to shared memory as [query][key], and the thread accumulates
//   dV += P^T dO and dK += dS^T Q for its 4 key rows x Dh/16 dims. A warp
//   skips the leading 16-query blocks, and the queries, that see none of
//   its keys. Blocks take key tiles from the first (the most queries).
// Only a thread's own warp reads the dS (K2) or P^T/dS^T (K3) rows it
// writes, so those exchanges need only __syncwarp; K2's aliasing of dS over
// V costs one more block barrier per tile. Tiles: BN = 64 up to Dh = 64,
// 32 up to Dh = 128, 16 above. Two blocks per SM (<= 113 KB shared memory
// each, <= 128 registers a thread) for K2 up to Dh = 64 and K3 up to
// Dh = 32; one block per SM for the rest. K3 at Dh 33..64 needs 140 KB (64
// queries of P^T and dS^T beside K, V and the ring) and took 5-8% less time
// on an H100 at the dialog gates' windows than with 32-query tiles at two
// blocks per SM; at Dh = 128 the 64 stationary rows alone take 67 KB, at
// Dh = 256 133 KB.
//
// What it leaves: 3xTF32 or bf16x3 splits that would put f32 on the tensor
// cores (ruled out with TF32); the score pass is recomputed in both kernels
// (the price of no atomics); at two bytes of shared-memory traffic per FMA
// shared-memory bandwidth still limits before the FMA rate; the zero-padded
// dims of Dh = 48 in a 64-dim instantiation are computed (a quarter of the
// product FMAs); T = 256 launches only a few blocks per SM and is latency
// bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -0.7f * 3.4028234663852886e38f;  // _NEG_BIG
constexpr int kRows = 64;      // rows a block owns: queries (K2) or keys (K3)
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kRowsPer = kRows / 16;  // rows per thread
constexpr size_t kTwoBlockSmem = 113 * 1024;  // two blocks per SM up to here

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// 4 (or 2) consecutive elements -> f32, from 16- (8-) byte aligned memory
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void st2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Strides {  // batch, head, row strides in elements
  int64_t b, h, t;
};

// Shapes of one instantiation: DMAX (32, 64, 128, 256) bounds Dh, BN rows per
// streamed tile (keys in K2, queries in K3). Shared rows are padded by 16
// bytes, so rows r .. r + 7 start 4 banks apart.
template <typename T, int DMAX, int BN>
struct Cfg {
  static constexpr int NJ = BN / 16;                     // tile columns per thread
  static constexpr int LDS = DMAX + 4;                   // f32 rows the block owns
  static constexpr int LDT = DMAX + 16 / sizeof(T);      // streamed rows, elements of T
  static constexpr int LDP = kRows + 4;                  // f32 exchange tiles [column][row]
  static constexpr int OW = DMAX >= 64 ? 4 : 2;          // consecutive output dims per chunk
  static constexpr int OU = DMAX / (16 * OW);            // chunks of 16 * OW dims
  static constexpr int CH = DMAX * (int)sizeof(T) / 16;  // 16-byte pieces per streamed row
  static constexpr int EPC = 16 / (int)sizeof(T);        // elements per piece
  static constexpr size_t own_bytes = sizeof(float) * kRows * LDS;  // one owned [64][LDS] tile
  static constexpr size_t tile_bytes = sizeof(T) * BN * LDT;        // one stage of one streamed tile
  static constexpr size_t xch_bytes = sizeof(float) * BN * LDP;     // one [BN][LDP] exchange tile
  static_assert(BN * CH % kThreads == 0, "whole 16-byte pieces per thread");
  static_assert(2 * BN <= kThreads, "one bias, lse or delta element per thread");
  static_assert(tile_bytes % 16 == 0 && xch_bytes % 16 == 0, "16-byte aligned regions");
};

// K2: sQ, sDO [64][LDS]; sK [2][BK][LDT]; per stage a V tile that dS
// [BK][LDP] then overwrites; bias [2][BK]
template <typename T, int DMAX, int BK>
struct DqCfg : Cfg<T, DMAX, BK> {
  using C = Cfg<T, DMAX, BK>;
  static constexpr size_t vds_bytes = C::tile_bytes > C::xch_bytes ? C::tile_bytes : C::xch_bytes;
  static constexpr size_t smem = 2 * C::own_bytes + 2 * C::tile_bytes + 2 * vds_bytes + sizeof(float) * 2 * BK;
  static constexpr int min_blocks = smem <= kTwoBlockSmem ? 2 : 1;
};

// K3: sK, sV [64][LDS]; sQ, sDO [2][BQ][LDT]; lse, delta [2][BQ]; P^T, dS^T [BQ][LDP]
template <typename T, int DMAX, int BQ>
struct DkvCfg : Cfg<T, DMAX, BQ> {
  using C = Cfg<T, DMAX, BQ>;
  static constexpr size_t smem = 2 * C::own_bytes + 4 * C::tile_bytes + 2 * C::xch_bytes + sizeof(float) * 4 * BQ;
  static constexpr int min_blocks = smem <= kTwoBlockSmem ? 2 : 1;
};

// acc[i][j] += a row i . b row (16 j) over dims [0, Dh) in steps of 4, for
// the tile columns j in [J0, J1); a: the thread's 4 owned f32 rows, b: its
// first streamed row (column tc)
template <int J0, int J1, int NJ, int LDA, int LDB, typename T>
__device__ __forceinline__ void dot_cols(float (&acc)[kRowsPer][NJ], const float* a, const T* b, int Dh) {
  if constexpr (J1 > J0) {
#pragma unroll 2
    for (int d = 0; d < Dh; d += 4) {
      float4 av[kRowsPer], bv[J1 - J0];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) av[i] = ld4(a + i * LDA + d);
#pragma unroll
      for (int j = J0; j < J1; ++j) bv[j - J0] = ld4(b + 16 * j * LDB + d);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = J0; j < J1; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j - J0].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j - J0].y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv[j - J0].z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv[j - J0].w, acc[i][j]);
        }
    }
  }
}

// dot_cols over the first `live` columns blocks (a warp-uniform count)
template <int L, int NJ, int LDA, int LDB, typename T>
__device__ __forceinline__ void dot_head(float (&acc)[kRowsPer][NJ], const float* a, const T* b, int Dh, int live) {
  if constexpr (L > 0) {
    if (live == L) {
      dot_cols<0, L, NJ, LDA, LDB>(acc, a, b, Dh);
    } else {
      dot_head<L - 1, NJ, LDA, LDB>(acc, a, b, Dh, live);
    }
  }
}

// dot_cols over the column blocks from `dead` on (a warp-uniform count)
template <int J0, int NJ, int LDA, int LDB, typename T>
__device__ __forceinline__ void dot_tail(float (&acc)[kRowsPer][NJ], const float* a, const T* b, int Dh, int dead) {
  if constexpr (J0 < NJ) {
    if (dead == J0) {
      dot_cols<J0, NJ, NJ, LDA, LDB>(acc, a, b, Dh);
    } else {
      dot_tail<J0 + 1, NJ, LDA, LDB>(acc, a, b, Dh, dead);
    }
  }
}

// rows [r0, r0 + 64) of one (b, h) slice into shared memory as f32, row
// stride LDS; rows at or past `limit` and dims at or past Dh are zero
template <int DMAX, int LDS, typename T>
__device__ __forceinline__ void stage_owned(float* dst, const T* src, int64_t st, int r0, int limit, int Dh) {
  for (int i = threadIdx.x; i < kRows * (DMAX / 4); i += kThreads) {
    const int r = i / (DMAX / 4), d = (i % (DMAX / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit && d < Dh) x = ld4(src + (r0 + r) * st + d);
    st4(dst + r * LDS + d, x.x, x.y, x.z, x.w);
  }
}

// acc[i][u * OW + e] += w[i] * x[e] for the OW dims of chunk u
template <int OW, int NA>
__device__ __forceinline__ void axpy_rows(float (&acc)[kRowsPer][NA], const float4 w, int u, const float* x) {
  const float wr[kRowsPer] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int e = 0; e < OW; ++e) acc[i][u * OW + e] = fmaf(wr[i], x[e], acc[i][u * OW + e]);
}

template <int OW, typename T>
__device__ __forceinline__ void load_dims(float (&x)[4], const T* p) {
  if constexpr (OW == 4) {
    const float4 v = ld4(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    const float2 v = ld2(p);
    x[0] = v.x, x[1] = v.y;
  }
}

// rows 4 tr + i of an [rows][dims] output, acc * mul, rows at or past `limit` skipped
template <int OW, int OU, typename T>
__device__ __forceinline__ void store_rows(T* base, int64_t st, int r0, int limit, int Dh, int tc,
                                           const float (&acc)[kRowsPer][OU * OW], float mul) {
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    if (r0 + i >= limit) continue;
    T* row = base + (r0 + i) * st;
#pragma unroll
    for (int u = 0; u < OU; ++u) {
      const int d = u * 16 * OW + tc * OW;
      if (d >= Dh) continue;  // Dh % 8 == 0: all OW dims or none
      if constexpr (OW == 4) {
        st4(row + d, acc[i][4 * u] * mul, acc[i][4 * u + 1] * mul, acc[i][4 * u + 2] * mul, acc[i][4 * u + 3] * mul);
      } else {
        st2(row + d, acc[i][2 * u] * mul, acc[i][2 * u + 1] * mul);
      }
    }
  }
}

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads, DqCfg<T, DMAX, BK>::min_blocks) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int Tq, int S, int Dh,
    Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, int64_t bias_sb, int offset,
    float scale, int causal) {
  using C = DqCfg<T, DMAX, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);                               // [64][LDS]
  float* sDO = sQ + kRows * C::LDS;                                             // [64][LDS]
  T* sK = reinterpret_cast<T*>(smem_raw + 2 * C::own_bytes);                    // [2][BK][LDT]
  unsigned char* sVDS = smem_raw + 2 * C::own_bytes + 2 * C::tile_bytes;        // [2] V tile, then dS
  float* sB = reinterpret_cast<float*>(sVDS + 2 * C::vds_bytes);                // [2][BK]

  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows 4 tr + i: warp w owns rows 8 w .. 8 w + 7
  const int tc = tid & 15;  // keys tc + 16 j of each tile; dQ dims from tc
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest key ranges first
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;

  // keys [0, kv_end) are visible to some real query of this block
  const int q_last = min(q0 + kRows, Tq) - 1;
  const int kv_end = causal ? min(S, offset + q_last + 1) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int warp_last = offset + q0 + 8 * (tid >> 5) + 7;  // the warp's last query position

  auto load_tile = [&](int t, int stage) {
    const int j0 = t * BK;
    T* dk = sK + stage * BK * C::LDT;
    T* dv = reinterpret_cast<T*>(sVDS + stage * C::vds_bytes);
#pragma unroll
    for (int it = 0; it < BK * C::CH / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / C::CH, c = (i % C::CH) * C::EPC;
      const bool ok = j0 + r < kv_end && c < Dh;
      cp_async16(dk + r * C::LDT + c, ok ? kb + (j0 + r) * ks.t + c : kb, ok);
      cp_async16(dv + r * C::LDT + c, ok ? vb + (j0 + r) * vs.t + c : vb, ok);
    }
    if (biasb && tid < BK) {
      const bool ok = j0 + tid < kv_end;
      cp_async4(sB + stage * BK + tid, ok ? biasb + j0 + tid : biasb, ok);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  stage_owned<DMAX, C::LDS>(sQ, q + b * qs.b + h * qs.h, qs.t, q0, Tq, Dh);
  stage_owned<DMAX, C::LDS>(sDO, dout + b * dos.b + h * dos.h, dos.t, q0, Tq, Dh);

  float lse_r[kRowsPer], delta_r[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int t_row = q0 + 4 * tr + i;
    const int64_t stat = ((int64_t)b * H + h) * Tq + t_row;
    lse_r[i] = t_row < Tq ? lse[stat] : 0.f;
    delta_r[i] = t_row < Tq ? delta[stat] : 0.f;
  }

  float acc[kRowsPer][C::OU * C::OW];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int e = 0; e < C::OU * C::OW; ++e) acc[i][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed for all; the previous tile's dS K is done
    if (t + 1 < n_tiles) load_tile(t + 1, stage ^ 1);
    const T* tk = sK + stage * BK * C::LDT;
    const T* tv = reinterpret_cast<const T*>(sVDS + stage * C::vds_bytes);
    float* sDS = reinterpret_cast<float*>(sVDS + stage * C::vds_bytes);
    const int j0 = t * BK;

    // S and dP: rows 4 tr + i against keys tc + 16 j. Under the causal mask a
    // key block (16 keys) wholly past the warp's last query is not computed.
    const int live = !causal ? C::NJ : warp_last < j0 ? 0 : min(C::NJ, (warp_last - j0) / 16 + 1);
    float s[kRowsPer][C::NJ], dp[kRowsPer][C::NJ];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_head<C::NJ, C::NJ, C::LDS, C::LDT>(s, sQ + 4 * tr * C::LDS, tk + tc * C::LDT, Dh, live);
    dot_head<C::NJ, C::NJ, C::LDS, C::LDT>(dp, sDO + 4 * tr * C::LDS, tv + tc * C::LDT, Dh, live);

    // dS = P (dP - delta), P = exp(s - lse); 0 past kv_end, past Tq and on
    // the skipped blocks
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int t_row = q0 + 4 * tr + i;
      const int qpos = offset + t_row;  // absolute position of the row's query
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) {
        const int key = j0 + tc + 16 * j;
        float ds = 0.f;
        if (j < live && key < kv_end && t_row < Tq) {
          float sc = s[i][j] * scale;
          if (biasb) sc += sB[stage * BK + tc + 16 * j];
          if (causal && key > qpos) sc = kNegBig;
          ds = expf(sc - lse_r[i]) * (dp[i][j] - delta_r[i]);
        }
        s[i][j] = ds;
      }
    }
    __syncthreads();  // every warp has read this stage's V: dS goes over it
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) st4(sDS + (tc + 16 * j) * C::LDP + 4 * tr, s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();  // a warp reads only the dS of its own rows

    // dQ += dS K: rows 4 tr + i, dims u * 16 * OW + tc * OW + e; keys past
    // the warp's last query weigh 0
    const int k_end = !causal ? BK : min(BK, (max(0, warp_last - j0 + 1) + 3) & ~3);
    const float* dsr = sDS + 4 * tr;
    const T* kr = tk + tc * C::OW;
#pragma unroll 4
    for (int jj = 0; jj < k_end; ++jj) {
      const float4 w = *reinterpret_cast<const float4*>(dsr + jj * C::LDP);
#pragma unroll
      for (int u = 0; u < C::OU; ++u) {
        float x[4];
        load_dims<C::OW>(x, kr + jj * C::LDT + 16 * C::OW * u);
        axpy_rows<C::OW>(acc, w, u, x);
      }
    }
  }

  store_rows<C::OW, C::OU>(dq + b * dqs.b + h * dqs.h, dqs.t, q0 + 4 * tr, Tq, Dh, tc, acc, scale);
}

template <typename T, int DMAX, int BQ>
__global__ void __launch_bounds__(kThreads, DkvCfg<T, DMAX, BQ>::min_blocks) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H, int Tq,
    int S, int Dh, Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
    int64_t bias_sb, int offset, float scale, int causal) {
  using C = DkvCfg<T, DMAX, BQ>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);                     // [64][LDS]
  float* sV = sK + kRows * C::LDS;                                    // [64][LDS]
  T* sQ = reinterpret_cast<T*>(smem_raw + 2 * C::own_bytes);          // [2][BQ][LDT]
  T* sDO = sQ + 2 * BQ * C::LDT;                                      // [2][BQ][LDT]
  float* sP = reinterpret_cast<float*>(sDO + 2 * BQ * C::LDT);        // [BQ][LDP] P^T
  float* sS = sP + BQ * C::LDP;                                       // [BQ][LDP] dS^T
  float* sL = sS + BQ * C::LDP;                                       // [2][BQ] lse
  float* sD = sL + 2 * BQ;                                            // [2][BQ] delta

  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // key rows 4 tr + i: warp w owns keys 8 w .. 8 w + 7
  const int tc = tid & 15;  // queries tc + 16 j of each tile; dK/dV dims from tc
  const int k0 = blockIdx.x * kRows;  // key tile 0 (the most queries) first
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  const float* lseb = lse + ((int64_t)b * H + h) * Tq;
  const float* deltab = delta + ((int64_t)b * H + h) * Tq;

  // queries [t_begin, Tq): the first query that sees key k0 sits at k0 - offset
  const int t_begin = causal ? max(0, k0 - offset) : 0;
  const int n_tiles = (Tq - t_begin + BQ - 1) / BQ;
  const int warp_first = k0 + 8 * (tid >> 5) - offset;  // the first query that sees a key of the warp

  auto load_tile = [&](int t, int stage) {
    const int t0 = t_begin + t * BQ;
    T* dq_ = sQ + stage * BQ * C::LDT;
    T* ddo = sDO + stage * BQ * C::LDT;
#pragma unroll
    for (int it = 0; it < BQ * C::CH / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / C::CH, c = (i % C::CH) * C::EPC;
      const bool ok = t0 + r < Tq && c < Dh;
      cp_async16(dq_ + r * C::LDT + c, ok ? qb + (t0 + r) * qs.t + c : qb, ok);
      cp_async16(ddo + r * C::LDT + c, ok ? dob + (t0 + r) * dos.t + c : dob, ok);
    }
    if (tid < 2 * BQ) {
      const int r = tid % BQ;
      const bool ok = t0 + r < Tq;
      const float* src = tid < BQ ? lseb : deltab;
      cp_async4((tid < BQ ? sL : sD) + stage * BQ + r, ok ? src + t0 + r : src, ok);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  stage_owned<DMAX, C::LDS>(sK, k + b * ks.b + h * ks.h, ks.t, k0, S, Dh);
  stage_owned<DMAX, C::LDS>(sV, v + b * vs.b + h * vs.h, vs.t, k0, S, Dh);

  float bias_k[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int key = k0 + 4 * tr + i;
    bias_k[i] = (bias && key < S) ? bias[b * bias_sb + key] : 0.f;
  }

  float acc_k[kRowsPer][C::OU * C::OW], acc_v[kRowsPer][C::OU * C::OW];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int e = 0; e < C::OU * C::OW; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed for all; the previous tile's sums are done
    if (t + 1 < n_tiles) load_tile(t + 1, stage ^ 1);
    const T* tq = sQ + stage * BQ * C::LDT;
    const T* tdo = sDO + stage * BQ * C::LDT;
    const int t0 = t_begin + t * BQ;

    // S^T and dP^T: key rows 4 tr + i against queries tc + 16 j. Under the
    // causal mask a query block (16 queries) wholly before the first query
    // that sees the warp's first key is not computed.
    const int dead = !causal ? 0 : min(C::NJ, max(0, warp_first - t0) / 16);
    float s[kRowsPer][C::NJ], dp[kRowsPer][C::NJ];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < C::NJ; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_tail<0, C::NJ, C::LDS, C::LDT>(s, sK + 4 * tr * C::LDS, tq + tc * C::LDT, Dh, dead);
    dot_tail<0, C::NJ, C::LDS, C::LDT>(dp, sV + 4 * tr * C::LDS, tdo + tc * C::LDT, Dh, dead);

    // P^T = exp(s - lse), dS^T = P^T (dP^T - delta); 0 past Tq, past S and
    // on the skipped blocks
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) {
      const int qq = tc + 16 * j;
      const int t_q = t0 + qq;
      const float lse_q = sL[stage * BQ + qq], delta_q = sD[stage * BQ + qq];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const int key = k0 + 4 * tr + i;
        float p = 0.f, ds = 0.f;
        if (j >= dead && t_q < Tq && key < S) {
          float sc = s[i][j] * scale + bias_k[i];
          if (causal && key > offset + t_q) sc = kNegBig;
          p = expf(sc - lse_q);
          ds = p * (dp[i][j] - delta_q);
        }
        s[i][j] = p;
        dp[i][j] = ds;
      }
      st4(sP + qq * C::LDP + 4 * tr, s[0][j], s[1][j], s[2][j], s[3][j]);
      st4(sS + qq * C::LDP + 4 * tr, dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncwarp();  // a warp reads only the P^T and dS^T of its own key rows

    // dV += P^T dO, dK += dS^T Q: key rows 4 tr + i, dims u * 16 * OW + tc * OW
    // + e, over the queries from the first that sees a key of the warp
    const int qq_begin = !causal ? 0 : min(BQ, max(0, warp_first - t0)) & ~3;
    const int qq_end = min(BQ, (Tq - t0 + 3) & ~3);
    const float* pr = sP + 4 * tr;
    const float* sr = sS + 4 * tr;
    const T* dor = tdo + tc * C::OW;
    const T* qr = tq + tc * C::OW;
#pragma unroll 4
    for (int qq = qq_begin; qq < qq_end; ++qq) {
      const float4 p = *reinterpret_cast<const float4*>(pr + qq * C::LDP);
      const float4 ds = *reinterpret_cast<const float4*>(sr + qq * C::LDP);
#pragma unroll
      for (int u = 0; u < C::OU; ++u) {
        float x[4], y[4];
        load_dims<C::OW>(x, dor + qq * C::LDT + 16 * C::OW * u);
        load_dims<C::OW>(y, qr + qq * C::LDT + 16 * C::OW * u);
        axpy_rows<C::OW>(acc_v, p, u, x);
        axpy_rows<C::OW>(acc_k, ds, u, y);
      }
    }
    __syncwarp();  // the next tile's P^T and dS^T go over these
  }

  store_rows<C::OW, C::OU>(dk + b * dks.b + h * dks.h, dks.t, k0 + 4 * tr, S, Dh, tc, acc_k, scale);
  store_rows<C::OW, C::OU>(dv + b * dvs.b + h * dvs.h, dvs.t, k0 + 4 * tr, S, Dh, tc, acc_v, 1.f);
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
  constexpr size_t smem = DqCfg<T, DMAX, BK>::smem;
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
  constexpr size_t smem = DkvCfg<T, DMAX, BQ>::smem;
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
  if (Dh <= 32) return launch_dq<T, 32, 64>(DQ_ARGS);
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
  if (Dh <= 32) return launch_dkv<T, 32, 64>(DKV_ARGS);
  if (Dh <= 64) return launch_dkv<T, 64, 64>(DKV_ARGS);
  if (Dh <= 128) return launch_dkv<T, 128, 32>(DKV_ARGS);
  return launch_dkv<T, 256, 16>(DKV_ARGS);
#undef DKV_ARGS
}

bool bad_shape(int B, int H, int Tq, int S, int Dh) {
  return Dh <= 0 || Dh > 256 || Dh % 8 != 0 || B <= 0 || H <= 0 || Tq <= 0 || S <= 0 ||
         Tq > S || B > 65535 || H > 65535;
}

// 16-byte copies need 16-byte aligned rows (the wrapper checks): base
// pointers on 16 bytes, batch/head/row strides in multiples of 8 elements.
bool misaligned(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0 || s.b % 8 != 0 || s.h % 8 != 0 || s.t % 8 != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients alike).
// Every tensor argument is indexed by (b, h, t) strides with a contiguous
// last dim, starting on 16 bytes with strides in multiples of 8 elements,
// except lse and delta: contiguous [B, H, Tq] float32. bias is [B, >= S]
// float32 with row stride bias_sb, or null. Each returns cudaGetLastError()
// after its launch (cudaErrorInvalidValue for a shape or layout the kernel
// does not take, without launching).
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
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st}, vs{v_sb, v_sh, v_st};
  const Strides dos{do_sb, do_sh, do_st}, dqs{dq_sb, dq_sh, dq_st};
  if (bad_shape(B, H, Tq, S, Dh) || misaligned(q, qs) || misaligned(k, ks) || misaligned(v, vs) ||
      misaligned(dout, dos) || misaligned(dq, dqs)) {
    return (int)cudaErrorInvalidValue;
  }
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
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st}, vs{v_sb, v_sh, v_st};
  const Strides dos{do_sb, do_sh, do_st}, dks{dk_sb, dk_sh, dk_st}, dvs{dv_sb, dv_sh, dv_st};
  if (bad_shape(B, H, Tq, S, Dh) || misaligned(q, qs) || misaligned(k, ks) || misaligned(v, vs) ||
      misaligned(dout, dos) || misaligned(dk, dks) || misaligned(dv, dvs)) {
    return (int)cudaErrorInvalidValue;
  }
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
