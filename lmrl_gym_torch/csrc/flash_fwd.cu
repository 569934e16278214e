// Causal flash-attention forward on Hopper's fp32 CUDA cores (sm_90a), plain
// C interface.
//
// Replaces the Pallas kernel lmrl_gym_tpu/ops/flash_attention.py::
// _flash_kernel (K1, launched by _flash_forward) for f32 inputs, and for
// bf16 with a head dim that is not a multiple of 16 (csrc/flash_fwd_tc.cu
// takes the rest of bf16). Same function:
//   O = softmax(scale * Q K^T + bias, causal with queries right-aligned at
//       offset = S - Tq) V,   lse = per-row logsumexp,
// f32 online softmax, masked scores at -0.7 * FLT_MAX, key tiles past the
// causal limit of a block's last query never read.
//
// What bounds it on an H100: f32 stays off the tensor cores (TF32 is off by
// the port's rule, core/device.py), so at the dialog gates' shapes (T = 256
// to 768 queries over as many keys, Dh = 32 to 64) the bound is f32 FMA issue
// at 67 TF/s: ~64 FLOP per byte of K and V at T = 768, Dh = 64. The first
// version of this kernel (16 query rows per block, every FMA fed by its own
// shared-memory load) was bound by shared-memory issue instead and read K
// and V once per 16-row tile.
//
// Design: a block of 256 threads owns 64 consecutive query rows of one
// (b, h) and walks 64-key tiles (32 at Dh > 64, to fit shared memory). The
// threads form a 16 x 16 grid: thread (tr, tc) owns query rows 4 tr + i
// (i < 4) and, in each tile, keys tc + 16 j (j < BK / 16), so it holds a 4 x 4
// micro-tile of scores (4 x 2 at BK = 32), and warp w owns rows 8 w .. 8 w + 7.
// On the causal diagonal a warp skips the key blocks (16 keys) and the P V
// keys wholly past its last query. Q (scaled once, f32) and the K
// tile sit in shared memory as [row][d]; a step of the score loop takes four
// consecutive dims: four 16-byte loads of Q rows (one address per
// quarter-warp: a broadcast) and four of K rows (eight consecutive rows per
// quarter-warp, rows 4 banks apart: no conflict) feed 64 FMAs, 8 per load.
// The row max and sum are reduced over the 16 lanes of a half-warp that share
// the rows, by shuffles; P goes to shared memory as [key][row] so that one
// 16-byte load gives a key's weight for a thread's four rows, and O = P V
// uses the same row split with 4 (2 at Dh <= 32) consecutive dims per 64-dim
// chunk: per key one load of P and one of V per chunk feed 16 FMAs. The next
// K/V tile (and bias) comes in by 16-byte cp.async into the other stage of a
// two-stage ring while this tile's math runs; two barriers per tile. Blocks
// take query tiles from the last (the longest key range) to the first.
// bf16 inputs are copied raw and converted to f32 from shared memory.
// Keys past the block's causal limit score -inf (weight exactly 0); a fully
// masked (left-pad) row keeps lse = -0.7 * FLT_MAX, which the backward
// kernels read as P = 1.
//
// What it leaves: 3xTF32 or bf16x3 splits that would put f32 on the tensor
// cores (ruled out with TF32); at 2 bytes of shared-memory traffic per FMA
// (a 4 x 4 micro-tile) the shared-memory bandwidth, not the FMA rate, is
// the limit, and a larger micro-tile needs more than the 128 registers that
// two blocks per SM allow; one block per SM at Dh > 128 (Q alone is 66 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegBig = -0.7f * 3.4028234663852886e38f;  // _NEG_BIG
constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kRowsPer = kBQ / 16;  // query rows per thread

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

// over the 16 lanes of a half-warp (the threads that share a query row)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shapes of one instantiation: DMAX (32, 64, 128, 256) bounds Dh, BK keys
// per tile. Shared rows are padded by 16 bytes (4 f32 banks), so rows
// r .. r + 7 start 4 banks apart.
template <typename T, int DMAX, int BK>
struct Cfg {
  static constexpr int KJ = BK / 16;                    // keys per thread and tile
  static constexpr int LDQ = DMAX + 4;                  // f32
  static constexpr int LDK = DMAX + 16 / sizeof(T);     // elements of T
  static constexpr int LDP = kBQ + 4;                   // f32, sP is [key][row slot]
  static constexpr int OW = DMAX >= 64 ? 4 : 2;         // consecutive output dims per chunk
  static constexpr int OU = DMAX / (16 * OW);           // chunks of 16 * OW dims
  static constexpr int CH = DMAX * (int)sizeof(T) / 16;  // 16-byte pieces per K/V row
  static constexpr int EPC = 16 / (int)sizeof(T);       // elements per piece
  static constexpr size_t q_bytes = sizeof(float) * kBQ * LDQ;
  static constexpr size_t kv_bytes = sizeof(T) * BK * LDK;  // one stage of K (or V)
  static constexpr size_t smem = q_bytes + 4 * kv_bytes + sizeof(float) * (2 * BK + BK * LDP);
  static_assert(BK * CH % kThreads == 0, "whole 16-byte pieces per thread");
  static_assert(BK <= kThreads, "one bias element per thread");
};

// s[i][j] = q row i . k key block j (keys tc + 16 j) for the first NJ key
// blocks, over dims [0, Dh) in steps of 4; the other blocks stay 0
template <int NJ, int KJ, int LDQ, int LDK, typename T>
__device__ __forceinline__ void score_rows(float (&s)[kRowsPer][KJ], const float* qr, const T* kr, int Dh) {
  if constexpr (NJ > 0) {
#pragma unroll 2
    for (int d = 0; d < Dh; d += 4) {
      float4 qv[kRowsPer], kv[NJ];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) qv[i] = ld4(qr + i * LDQ + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = ld4(kr + 16 * j * LDK + d);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
  }
}

// score_rows for the first `live` key blocks (a warp-uniform count)
template <int NJ, int KJ, int LDQ, int LDK, typename T>
__device__ __forceinline__ void score_live(float (&s)[kRowsPer][KJ], const float* qr, const T* kr, int Dh, int live) {
  if constexpr (NJ > 0) {
    if (live == NJ) {
      score_rows<NJ, KJ, LDQ, LDK>(s, qr, kr, Dh);
    } else {
      score_live<NJ - 1, KJ, LDQ, LDK>(s, qr, kr, Dh, live);
    }
  }
}

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kThreads, DMAX > 128 ? 1 : 2) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, float* __restrict__ lse,
    int H, int Tq, int S, int Dh,
    int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st,
    int64_t o_sb, int64_t o_sh, int64_t o_st,
    int64_t bias_sb, int offset, float scale, int causal) {
  using C = Cfg<T, DMAX, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);                            // [kBQ][LDQ]
  T* sK = reinterpret_cast<T*>(smem_raw + C::q_bytes);                       // [2][BK][LDK]
  T* sV = reinterpret_cast<T*>(smem_raw + C::q_bytes + 2 * C::kv_bytes);     // [2][BK][LDK]
  float* sB = reinterpret_cast<float*>(smem_raw + C::q_bytes + 4 * C::kv_bytes);  // [2][BK]
  float* sP = sB + 2 * BK;                                                   // [BK][LDP]

  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows 4 tr + i: warp w owns rows 8 w .. 8 w + 7
  const int tc = tid & 15;  // keys tc + 16 j; output dims from tc
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // the longest key ranges first
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;

  // keys [0, kv_end) are visible to some real query of this tile
  const int q_last = min(q0 + kBQ, Tq) - 1;
  const int kv_end = causal ? min(S, offset + q_last + 1) : S;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int warp_last = offset + q0 + 8 * (tid >> 5) + 7;  // the warp's last query position

  auto load_tile = [&](int t, int stage) {
    const int j0 = t * BK;
    T* dk = sK + stage * BK * C::LDK;
    T* dv = sV + stage * BK * C::LDK;
#pragma unroll
    for (int it = 0; it < BK * C::CH / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / C::CH, c = (i % C::CH) * C::EPC;
      const bool ok = j0 + r < kv_end && c < Dh;
      cp_async16(dk + r * C::LDK + c, ok ? kb + (j0 + r) * k_st + c : kb, ok);
      cp_async16(dv + r * C::LDK + c, ok ? vb + (j0 + r) * v_st + c : vb, ok);
    }
    if (biasb && tid < BK) {
      const bool ok = j0 + tid < kv_end;
      cp_async4(sB + stage * BK + tid, ok ? biasb + j0 + tid : biasb, ok);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  // Q tile, pre-scaled as the Pallas kernel does (q * sm_scale), f32
  for (int i = tid; i < kBQ * (DMAX / 4); i += kThreads) {
    const int r = i / (DMAX / 4), d = (i % (DMAX / 4)) * 4;
    const int t = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < Tq && d < Dh) x = ld4(qb + t * q_st + d);
    st4(sQ + r * C::LDQ + d, x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  float m[kRowsPer], l[kRowsPer];  // l: this thread's share of the row sum
  float acc[kRowsPer][C::OU * C::OW];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < C::OU * C::OW; ++e) acc[i][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed for all; the previous tile's P V is done
    if (t + 1 < n_tiles) load_tile(t + 1, stage ^ 1);
    const T* tk = sK + stage * BK * C::LDK;
    const T* tv = sV + stage * BK * C::LDK;
    const int j0 = t * BK;

    // scores: rows 4 tr + i against keys tc + 16 j. Under the causal mask a
    // key block (16 keys) wholly past the warp's last query is masked for all
    // its rows and is not computed (the diagonal tiles).
    const int live = !causal ? C::KJ : warp_last < j0 ? 0 : min(C::KJ, (warp_last - j0) / 16 + 1);
    float s[kRowsPer][C::KJ];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < C::KJ; ++j) s[i][j] = 0.f;
    score_live<C::KJ, C::KJ, C::LDQ, C::LDK>(s, sQ + 4 * tr * C::LDQ, tk + tc * C::LDK, Dh, live);

    // online softmax over the tile, per row
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int qpos = offset + q0 + 4 * tr + i;  // absolute position of the row's query
      float m_tile = -INFINITY;
#pragma unroll
      for (int j = 0; j < C::KJ; ++j) {
        const int key = j0 + tc + 16 * j;
        if (key >= kv_end) {
          s[i][j] = -INFINITY;  // past the causal limit of the whole tile: weight exactly 0
        } else {
          if (biasb) s[i][j] += sB[stage * BK + tc + 16 * j];
          if (causal && key > qpos) s[i][j] = kNegBig;
        }
        m_tile = fmaxf(m_tile, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(m_tile));
      const float alpha = expf(m[i] - m_new);  // rescale the running sums
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < C::KJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
      }
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < C::OU * C::OW; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < C::KJ; ++j) st4(sP + (tc + 16 * j) * C::LDP + 4 * tr, s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // O += P V: rows 4 tr + i, dims u * 16 * OW + tc * OW + e; keys past the
    // warp's last query weigh 0 for every row that sees a key
    const int pv_end = !causal ? BK : min(BK, (max(0, warp_last - j0 + 1) + 3) & ~3);
    const float* pr = sP + 4 * tr;
    const T* vr = tv + tc * C::OW;
#pragma unroll 4
    for (int jj = 0; jj < pv_end; ++jj) {
      const float4 p = *reinterpret_cast<const float4*>(pr + jj * C::LDP);
      const float pw[kRowsPer] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int u = 0; u < C::OU; ++u) {
        if constexpr (C::OW == 4) {
          const float4 x = ld4(vr + jj * C::LDK + 64 * u);
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) {
            acc[i][4 * u] = fmaf(pw[i], x.x, acc[i][4 * u]);
            acc[i][4 * u + 1] = fmaf(pw[i], x.y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(pw[i], x.z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(pw[i], x.w, acc[i][4 * u + 3]);
          }
        } else {
          const float2 x = ld2(vr + jj * C::LDK + 32 * u);
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) {
            acc[i][2 * u] = fmaf(pw[i], x.x, acc[i][2 * u]);
            acc[i][2 * u + 1] = fmaf(pw[i], x.y, acc[i][2 * u + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const float lc = fmaxf(row_sum16(l[i]), 1e-30f);
    const int t_row = q0 + 4 * tr + i;
    if (t_row < Tq) {
      const float inv = 1.f / lc;
      T* orow = out + b * o_sb + h * o_sh + t_row * o_st;
#pragma unroll
      for (int u = 0; u < C::OU; ++u) {
        const int d = u * 16 * C::OW + tc * C::OW;
        if (d >= Dh) continue;  // Dh % 8 == 0: all OW dims or none
        if constexpr (C::OW == 4) {
          st4(orow + d, acc[i][4 * u] * inv, acc[i][4 * u + 1] * inv, acc[i][4 * u + 2] * inv,
              acc[i][4 * u + 3] * inv);
        } else {
          st2(orow + d, acc[i][2 * u] * inv, acc[i][2 * u + 1] * inv);
        }
      }
      if (tc == 0) lse[((int64_t)b * H + h) * Tq + t_row] = m[i] + logf(lc);
    }
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
  constexpr size_t smem = Cfg<T, DMAX, BK>::smem;
  auto kernel = flash_fwd_kernel<T, DMAX, BK>;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
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
  if (Dh <= 32) return launch<T, 32, 64>(FLASH_ARGS);
  if (Dh <= 64) return launch<T, 64, 64>(FLASH_ARGS);
  if (Dh <= 128) return launch<T, 128, 32>(FLASH_ARGS);
  return launch<T, 256, 32>(FLASH_ARGS);
#undef FLASH_ARGS
}

// 16-byte loads and stores need 16-byte aligned rows (the wrapper checks):
// base pointers on 16 bytes, batch/head/row strides in multiples of 8 elements.
bool misaligned(const void* p, long long sb, long long sh, long long st) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0 || sb % 8 != 0 || sh % 8 != 0 || st % 8 != 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v and out are indexed by (b, h, t)
// strides with a contiguous last dim, each starting on 16 bytes with strides
// in multiples of 8 elements; lse is contiguous [B, H, Tq] float32; bias is
// [B, >= S] float32 with row stride bias_sb, or null. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape or
// layout the kernel does not take, without launching).
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
      B > 65535 || H > 65535 || misaligned(q, q_sb, q_sh, q_st) || misaligned(k, k_sb, k_sh, k_st) ||
      misaligned(v, v_sb, v_sh, v_st) || misaligned(out, o_sb, o_sh, o_st)) {
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
