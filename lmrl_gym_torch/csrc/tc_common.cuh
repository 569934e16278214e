// Device helpers shared by the tensor-core flash-attention kernels
// (flash_fwd_tc.cu: K1; flash_bwd_tc.cu: K2, K3), sm_90a, bf16.
//
// 16-byte cp.async copies into shared memory, ldmatrix loads of mma.sync
// fragments, the m16n8k16 product (bf16 in, f32 sums), the conversion of an
// f32 accumulator into the next product's bf16 A operand, and the shape and
// alignment checks of the C entry points. Each source that includes this
// builds into a library of its own, so everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegBig = -0.7f * 3.4028234663852886e38f;  // _NEG_BIG

struct Strides {  // batch, head, row strides in elements
  int64_t b, h, t;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then not read, but must be a valid address).
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of one k16 step from two n8 accumulator tiles (c0, c1):
// a 16 x 16 block of the accumulator rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Rows [r0, r0 + ROWS) of one (b, h) slice into shared memory (row stride
// DMAX + 8 elements), copied by the NT threads numbered `tid`; rows at or
// past `limit` and columns at or past Dh are zero-filled.
template <int ROWS, int DMAX, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t st, int r0, int limit, int Dh,
                                          int tid) {
  constexpr int LD = DMAX + 8, CH = DMAX / 8;
  static_assert(ROWS * CH % NT == 0, "whole 16-byte chunks per thread");
#pragma unroll
  for (int m = 0; m < ROWS * CH / NT; ++m) {
    const int i = tid + m * NT;
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < limit && c * 8 < Dh;
    cp_async16(dst + r * LD + c * 8, ok ? src + (r0 + r) * st + c * 8 : src, ok);
  }
}

// src[i0 .. i0 + N) into shared memory by the NT threads numbered `tid`,
// zero at or past `limit`.
template <int N, int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* src, int i0, int limit, int tid) {
  static_assert(N <= NT, "one element per thread");
  if (tid < N) {
    const bool ok = i0 + tid < limit;
    cp_async4(dst + tid, ok ? src + i0 + tid : src, ok);
  }
}

// ldmatrix lane addresses (row, column) inside a 16 x 16 block:
// A layout, and B read transposed (ldsm_x4_t): matrices (rows 0-7, cols 0-7),
// (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
// B read as stored ([n][k], k contiguous), two n8 tiles: matrices
// (n 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15).
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) << 3; }

// acc[d] += C (16 x NK accumulator tiles, rounded to bf16) * B, B = NK rows
// of `b_src` [k][DMAX] read transposed: one warp's 16 x DMAX product.
template <int DMAX, int NK>
__device__ __forceinline__ void acc_dot_rows(float (&acc)[DMAX / 8][4], const float (&c)[NK / 8][4],
                                             const bf16* b_src, int lane) {
  constexpr int LD = DMAX + 8;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[4];
    acc_to_a(a, c[2 * kk], c[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < DMAX / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, b_src + (kk * 16 + a_row(lane)) * LD + dp * 16 + a_col(lane));
      mma(acc[2 * dp], a, b[0], b[1]);
      mma(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// Rows r (fragment row g) and r + 8 of a warp's 16 x DMAX accumulator, times
// `mul`, as bf16 pairs; rows at or past `limit` and columns at or past Dh
// are not written.
template <int DMAX>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t st, const float (&acc)[DMAX / 8][4], int r,
                                           int limit, int Dh, float mul, int tq) {
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    const int d = n * 8 + 2 * tq;
    if (d >= Dh) continue;
    if (r < limit) {
      *reinterpret_cast<uint32_t*>(dst + r * st + d) = pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    }
    if (r + 8 < limit) {
      *reinterpret_cast<uint32_t*>(dst + (r + 8) * st + d) = pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
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

bool bad_shape(int B, int H, int Tq, int S, int Dh) {
  return Dh <= 0 || Dh > 128 || Dh % 16 != 0 || B <= 0 || H <= 0 || Tq <= 0 || S <= 0 || Tq > S ||
         B > 65535 || H > 65535;
}

// 16-byte cp.async needs 16-byte aligned rows: base pointers on 16 bytes,
// batch/head/row strides in multiples of 8 elements.
bool misaligned(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0 || s.b % 8 != 0 || s.h % 8 != 0 || s.t % 8 != 0;
}

// Outputs are written as bf16 pairs: even strides, 4-byte aligned.
bool misaligned_out(const void* p, Strides s) {
  return reinterpret_cast<uintptr_t>(p) % 4 != 0 || s.b % 2 != 0 || s.h % 2 != 0 || s.t % 2 != 0;
}

}  // namespace
