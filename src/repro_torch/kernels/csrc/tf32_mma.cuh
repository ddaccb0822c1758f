// The 3xTF32 tensor-core machinery of the port's matrix-product kernels
// (B4 and B5 in linear_attn_scan.cu, B6 in prf_featmap.cu): TF32 rounding
// and the hi/lo split of an f32 value, mma.sync m16n8k8 in TF32 with f32
// sums and its three-product (3xTF32) form, zero-filling 16-byte cp.async
// staging of a tile, and paired stores.
#pragma once

#include <cstdint>

#include "prf_common.cuh"

namespace tc {

using prf::from_f;

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x: to the nearest
// value with 10 mantissa bits, ties away from zero (two integer ops; ptxas
// lowers the cvt to four, with a guard for Inf and NaN)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each rounded to TF32: |lo| <= 2^-11 |x|, and hi + lo is
// within 2^-22 |x| of x
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

// d += a b for one m16n8k8 tile: a row-major 16 x 8, b 8 x 8 (k x n)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), small terms
// first, a given split (split4). ExactB: b is exact in TF32 (a bf16
// value), so lo(b) = 0 and two products do.
template <bool ExactB>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  if constexpr (ExactB) {
    mma(d, al, __float_as_uint(b0), __float_as_uint(b1));
    mma(d, ah, __float_as_uint(b0), __float_as_uint(b1));
  } else {
    uint32_t h0, l0, h1, l1;
    split(b0, h0, l0);
    split(b1, h1, l1);
    mma(d, ah, l0, l1);
    mma(d, al, h0, h1);
    mma(d, ah, h0, h1);
  }
}

__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Copy rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a row-major
// array (row stride ld) into dst (row stride ds), zero outside [0, rmax)
// x [0, cmax). vec: 16-byte cp.async (the base and every row start on a
// 16-byte boundary, cmax a whole number of 16-byte pieces); else plain
// loads and stores. Runs on the block's NT threads.
template <int ROWS, int COLS, int NT, typename E>
__device__ __forceinline__ void stage(E* dst, int ds, const E* src,
                                      size_t ld, int r0, int rmax, int c0,
                                      int cmax, bool vec) {
  constexpr int PV = 16 / sizeof(E);
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * COLS / PV; i += NT) {
      const int r = i / (COLS / PV), c = (i % (COLS / PV)) * PV;
      const bool ok = r0 + r < rmax && c0 + c < cmax;
      cp_async16z(dst + r * ds + c,
                  ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      dst[r * ds + c] = r0 + r < rmax && c0 + c < cmax
                            ? src[(size_t)(r0 + r) * ld + c0 + c]
                            : from_f<E>(0.f);
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* p, size_t row_bytes) {
  return ((size_t)p | row_bytes) % 16 == 0;
}

// Two neighbouring columns (col, col + 1) of one row, in T; col + 1 may lie
// past the row's end (n columns)
template <typename T>
__device__ __forceinline__ void store2(T* row, int col, int n, float a,
                                       float b) {
  if ((n & 1) == 0 && col + 1 < n) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(row + col) = make_float2(a, b);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(row + col) =
          __floats2bfloat162_rn(a, b);
    }
    return;
  }
  if (col < n) row[col] = from_f<T>(a);
  if (col + 1 < n) row[col + 1] = from_f<T>(b);
}

}  // namespace tc
