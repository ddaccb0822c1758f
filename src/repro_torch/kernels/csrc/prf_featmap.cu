// PRF feature map for Hopper (sm_90a), on the tensor cores in 3xTF32.
//
// Replaces: the Pallas TPU kernel repro/kernels/prf_featmap.py,
//   prf_featmap_fwd (bodies _kernel_dark and _kernel_iso). Per row x of
//   an (N, d) input:
//     x~ = M x (dark; x~ = x for the isotropic kinds, M = null)
//     phi(x) = exp(W x~ - ||x~||^2 / 2 - c) / sqrt(m)      (N, m) f32
//   with W (m, r), M (r, d) and the scalar stabilizer c (device memory).
//
// What bounds it on the H100: max(bytes / 3.35 TB/s, operations / 495
//   TFLOP/s of TF32 on the tensor cores). At the smollm-135m training
//   feature shape (36 864 rows, d = r = 64, m = 256, f32 x) x in and phi
//   out move 47 MB, 14.1 us, and the two products take 1.5 GFLOP, 3.1 us:
//   the bytes bound it, phi's 38 MB of stores above all. At darkformer-2b's
//   widths (32 768 rows, d = r = m = 256) 68 MB, 20.2 us, against 8.6
//   GFLOP, 17.4 us; 3xTF32 issues three products for each one counted
//   (52 us at the peak rate).
//
// Design. Both products run on the tensor cores in 3xTF32 (tf32_mma.cuh):
//   mma.sync m16n8k8, and wgmma for the logits at r <= 64 (a bf16 x is
//   exact in TF32, so x M^T takes two products, not three).
//   A warp owns 16 rows. x~ = x M^T accumulates in the warp's C fragments
//   (16 x r, r up to 256: r / 2 registers a thread) and never leaves the
//   registers: the fragment's pairs (g, 2t), (g, 2t + 1) are taken as the
//   k-indices t, t + 4 of the A operand of logits = x~ W^T, with W's
//   columns read in the same order, a float2 at a time (x M^T reads x and
//   M the same way). ||x~||^2 / 2 comes from the same registers and a
//   quad shuffle. W (m, r) and M (r, d) are row-major with the reduced
//   index contiguous, which is the mma's col-major B operand already:
//   nothing is transposed. They are staged by 16-byte cp.async
//   (zero-filled past the widths; plain loads where a row is not 16-byte
//   aligned) into rows padded to a stride of 8 mod 32 words, so no float2
//   fragment load meets a bank twice. The products run over whole tiles,
//   zero padding included: bounds (r, d, m) checked inside the unrolled
//   loops halved the speed (PERF.md). Three kernels, as many blocks as
//   the card holds:
//   - wgmma, at r <= 64 where W's hi and lo fit a block beside M
//     (smollm-135m's heads): as resident, with the logits on wgmma, the
//     warpgroup product, at twice mma.sync's issue rate, from W split
//     once into its canonical shared-memory layout; one block of three
//     warpgroups a SM;
//   - resident, 256 threads, where W and M fit a block (every r <= 128
//     at m = 256): each block stages them once, then its warps run
//     without a barrier, each loading its tile's x straight into
//     registers (two blocks a SM at r <= 64, one above);
//   - streaming, 256 threads, above (darkformer-2b's W and M take 540
//     KB; one block a SM): W and M pass through a ring of three slabs (32
//     columns of M, 64 rows of W) loaded two ahead, once for every 128
//     rows; the L2's deliveries of those slabs, the same to every block,
//     set its pace (PERF.md).
//   Warp w of block b takes tile b + G (w + 8 k) in step k, so the last
//   step's tiles spread over the SMs. The epilogue exponentiates the C
//   fragments (ex2.approx, with log2 e, c and the norm folded into one FMA
//   a value) and stores them as float2 with an evict-first hint: four
//   lanes fill one 32-byte sector of a row, and nothing in the call reads
//   phi back. c is read once a block.
#include <cmath>
#include <cstdint>

#include "prf_common.cuh"
#include "tf32_mma.cuh"

namespace pfm {

using prf::cp_async_commit;
using prf::cp_async_wait;
using prf::from_f;
using tc::aligned16;
using tc::cp_async16z;
using tc::mma;
using tc::mma3;
using tc::split;
using tc::split4;
using tc::stage;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKs = 32;              // columns of x and M a slab (x M^T's k)
constexpr int kNs = 64;              // rows of W a slab (logit columns)
constexpr int kStages = 3;           // the ring of slabs
constexpr int kPs = kKs + 8;         // row stride of an x or M slab
constexpr float kLog2e = 1.4426950408889634f;

template <int R>
constexpr int kWs = R + 8;           // row stride of a W slab

// bytes of the warps' x slabs, then of a stage: x and (Dark) M's slab, or
// W's slab, whichever is larger
template <typename T>
constexpr int kXBytes = kWarps * 16 * kPs * (int)sizeof(T);
template <typename T, int R, bool Dark>
constexpr int kStageBytes =
    kXBytes<T> + (Dark ? R * kPs * 4 : 0) > kNs * kWs<R> * 4
        ? kXBytes<T> + (Dark ? R * kPs * 4 : 0)
        : kNs * kWs<R> * 4;

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d += a b in 3xTF32, a given split; ExactA: a is exact in TF32 (a bf16
// x), so lo(a) = 0 and lo(b) hi(a) + hi(b) hi(a) do
template <bool ExactA>
__device__ __forceinline__ void mma_a(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], float b0,
                                      float b1) {
  if constexpr (ExactA) {
    uint32_t h0, l0, h1, l1;
    split(b0, h0, l0);
    split(b1, h1, l1);
    mma(d, ah, l0, l1);
    mma(d, ah, h0, h1);
  } else {
    mma3<false>(d, ah, al, b0, b1);
  }
}

// The warp's x slab: rows [row0, row0 + 16) x columns [k0, k0 + kKs) of
// x (N, d) into dst (stride kPs), zero outside the array; 16-byte cp.async
// when vec, else plain loads
template <typename T>
__device__ __forceinline__ void stage_x(T* dst, const T* x, int row0, int N,
                                        int k0, int d, bool vec, int lane) {
  constexpr int PV = 16 / sizeof(T), PR = kKs / PV;
  if (vec) {
    for (int i = lane; i < 16 * PR; i += 32) {
      const int r = i / PR, c = (i % PR) * PV;
      const bool ok = row0 + r < N && k0 + c < d;
      cp_async16z(dst + r * kPs + c,
                  ok ? x + (size_t)(row0 + r) * d + k0 + c : x, ok);
    }
  } else {
    for (int i = lane; i < 16 * kKs; i += 32) {
      const int r = i / kKs, c = i % kKs;
      dst[r * kPs + c] = row0 + r < N && k0 + c < d
                             ? x[(size_t)(row0 + r) * d + k0 + c]
                             : from_f<T>(0.f);
    }
  }
}

// Two neighbouring columns (col, col + 1 < m when m is even) of phi's row,
// with the evict-first hint
__device__ __forceinline__ void store_phi(float* row, int col, int m, float a,
                                          float b) {
  if ((m & 1) == 0) {
    __stcs(reinterpret_cast<float2*>(row + col), make_float2(a, b));
    return;
  }
  __stcs(row + col, a);
  if (col + 1 < m) __stcs(row + col + 1, b);
}

// Shared by the kernels. A warp owns 16 rows; x~ lives in its mma C
// fragments xt[j] (columns 8 j .. 8 j + 7): (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).

// xt += a M^T over one k-step of 8 columns of x: a holds the A fragment of
// x with k-index t at column 2t and t + 4 at 2t + 1 (rows g, g + 8); mb
// points at M's row g, column 2t of that k-step (row stride ms). Column
// tiles past r meet M's zero-filled rows.
template <int R, bool ExactA>
__device__ __forceinline__ void xm_step(float (&xt)[R / 8][4],
                                        const float (&a)[4], const float* mb,
                                        int ms) {
  uint32_t ah[4], al[4];
  if constexpr (ExactA) {
#pragma unroll
    for (int e = 0; e < 4; ++e) ah[e] = __float_as_uint(a[e]);
  } else {
    split4(a, ah, al);
  }
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
    const float2 bm = ld2(mb + 8 * j * ms);
    mma_a<ExactA>(xt[j], ah, al, bm.x, bm.y);
  }
}

// log2(1/sqrt(m)) - (||x~||^2 / 2 + c) log2 e for rows g and g + 8
template <int R>
__device__ __forceinline__ void phi_bias(const float (&xt)[R / 8][4],
                                         float cval, float log2_scale,
                                         float (&bias)[2]) {
  float sq[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
    sq[0] += xt[j][0] * xt[j][0] + xt[j][1] * xt[j][1];
    sq[1] += xt[j][2] * xt[j][2] + xt[j][3] * xt[j][3];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    bias[h] = log2_scale - (0.5f * prf::group_sum(sq[h]) + cval) * kLog2e;
}

// phi = 2^(logits log2 e + bias) from the C fragments of logits for
// columns n0 .. n0 + kNs of the warp's rows row0 + g, row0 + g + 8
__device__ __forceinline__ void phi_store(const float (&acc)[kNs / 8][4],
                                          int n0, int row0, int N, int m,
                                          const float (&bias)[2],
                                          float* __restrict__ out, int g,
                                          int t) {
#pragma unroll
  for (int j = 0; j < kNs / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row < N && col < m)
        store_phi(out + (size_t)row * m, col, m,
                  ex2(fmaf(acc[j][2 * h], kLog2e, bias[h])),
                  ex2(fmaf(acc[j][2 * h + 1], kLog2e, bias[h])));
    }
  }
}

// logits = x~ W^T for columns n0 .. n0 + kNs of the warp's rows row0 ..
// row0 + 15, then phi = 2^(logits log2 e + bias) into out. wb points at
// W's row n0 + g, column 2t (row stride kWs<R>): x~'s C fragment is the A
// operand as it stands, its k-index t being column 2t and t + 4 column
// 2t + 1, read from W in the same order. Rows past W's m meet zero-filled
// rows; their phi is not stored.
template <int R>
__device__ __forceinline__ void logits_phi(const float (&xt)[R / 8][4],
                                           const float* wb, int n0, int row0,
                                           int N, int m,
                                           const float (&bias)[2],
                                           float* __restrict__ out, int g,
                                           int t) {
  float acc[kNs / 8][4] = {};
#pragma unroll
  for (int kt = 0; kt < R / 8; ++kt) {
    const float a[4] = {xt[kt][0], xt[kt][2], xt[kt][1], xt[kt][3]};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
#pragma unroll
    for (int j = 0; j < kNs / 8; ++j) {
      const float2 bw = ld2(wb + 8 * j * kWs<R> + 8 * kt);
      mma3<false>(acc[j], ah, al, bw.x, bw.y);
    }
  }
  phi_store(acc, n0, row0, N, m, bias, out, g, t);
}

// Columns (col, col + 1) of x's row (zero past the array), as floats; vec:
// d is even and x 8-byte aligned (4-byte for bf16), so a pair is one load
template <typename T>
__device__ __forceinline__ float2 x_pair(const T* x, int row, int col, int N,
                                         int d, bool vec) {
  if (row >= N) return make_float2(0.f, 0.f);
  const T* p = x + (size_t)row * d + col;
  if (vec) return col < d ? ld2(p) : make_float2(0.f, 0.f);
  return make_float2(col < d ? prf::to_f(p[0]) : 0.f,
                     col + 1 < d ? prf::to_f(p[1]) : 0.f);
}

// x~ for the warp's rows row0 .. row0 + 15 into its C fragments xt, x
// read straight from device memory (d <= R): Dark, x's A fragments
// (k-steps of 8 columns) times M, resident at ms (R rows, stride kWs<R>);
// else x itself, in the C layout
template <typename T, int R, bool Dark>
__device__ __forceinline__ void form_xt(const T* __restrict__ x,
                                        const float* ms, int row0, int N,
                                        int d, bool vec_x, int g, int t,
                                        float (&xt)[R / 8][4]) {
  constexpr int kRt = R / 8;
  if constexpr (Dark) {
    float xa[kRt][4];
#pragma unroll
    for (int kk = 0; kk < kRt; ++kk) {
      const float2 lo = x_pair(x, row0 + g, 8 * kk + 2 * t, N, d, vec_x),
                   hi = x_pair(x, row0 + g + 8, 8 * kk + 2 * t, N, d, vec_x);
      xa[kk][0] = lo.x;
      xa[kk][1] = hi.x;
      xa[kk][2] = lo.y;
      xa[kk][3] = hi.y;
    }
#pragma unroll
    for (int j = 0; j < kRt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) xt[j][e] = 0.f;
    const float* mb = ms + g * kWs<R> + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kRt; ++kk)
      xm_step<R, sizeof(T) == 2>(xt, xa[kk], mb + 8 * kk, kWs<R>);
  } else {
#pragma unroll
    for (int j = 0; j < kRt; ++j) {
      const float2 lo = x_pair(x, row0 + g, 8 * j + 2 * t, N, d, vec_x),
                   hi = x_pair(x, row0 + g + 8, 8 * j + 2 * t, N, d, vec_x);
      xt[j][0] = lo.x;
      xt[j][1] = lo.y;
      xt[j][2] = hi.x;
      xt[j][3] = hi.y;
    }
  }
}

// Shared memory of the resident kernel: W's rows rounded up to kNs and
// (Dark) M's R rows, both at row stride kWs<R>
template <int R, bool Dark>
size_t resident_bytes(int m) {
  const size_t mp = (size_t)(m + kNs - 1) / kNs * kNs;
  return sizeof(float) * kWs<R> * (mp + (Dark ? R : 0));
}

// W and M resident. Each block stages W (m, r) and M (r, d <= R) once,
// then its warps run on their own, without a barrier: warp w of block b
// takes the 16-row tiles b + G (w + 8 k), loads its rows of x straight
// into the A fragments of x M^T (or, isotropic, into x~'s), forms x~ and
// its norm, and writes phi kNs columns at a time. Used where W and M fit
// a block's shared memory.
template <typename T, int R, bool Dark>
__global__ void __launch_bounds__(kThreads, R <= 64 ? 2 : 1) resident_kernel(
    const T* __restrict__ x, const float* __restrict__ mm,
    const float* __restrict__ w, const float* __restrict__ c,
    float* __restrict__ out, int N, int d, int r, int m, float log2_scale) {
  constexpr int kRt = R / 8, kS = kWs<R>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);           // W, (mp, kS)
  const int mp = (m + kNs - 1) / kNs * kNs;
  float* ms = ws + mp * kS;                              // M, (R, kS)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31,
            g = lane >> 2, t = lane & 3;
  const bool vec_w = aligned16(w, (size_t)r * 4);
  for (int n0 = 0; n0 < mp; n0 += kNs)
    stage<kNs, R, kThreads>(ws + n0 * kS, kS, w, r, n0, m, 0, r, vec_w);
  if constexpr (Dark)
    stage<R, R, kThreads>(ms, kS, mm, d, 0, r, 0, d,
                          aligned16(mm, (size_t)d * 4));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float cval = *c;
  const bool vec_x = d % 2 == 0 && ((size_t)x % (2 * sizeof(T))) == 0;
  const int tiles = (N + 15) / 16, G = gridDim.x;
  for (int tile = warp * G + blockIdx.x; tile < tiles; tile += kWarps * G) {
    const int row0 = tile * 16;
    float xt[kRt][4];
    form_xt<T, R, Dark>(x, ms, row0, N, d, vec_x, g, t, xt);
    float bias[2];
    phi_bias<R>(xt, cval, log2_scale, bias);
    for (int n0 = 0; n0 < m; n0 += kNs)
      logits_phi<R>(xt, ws + (n0 + g) * kS + 2 * t, n0, row0, N, m, bias,
                    out, g, t);
  }
}

// r <= 64: the logits on wgmma, the warpgroup product (four warps, 64
// rows), whose issue rate is twice mma.sync's. The hi and lo of W
// (tc::split) are staged once into the canonical K-major layout without
// swizzle: core matrices of 8 rows x 4 columns (16 bytes a row, 128 bytes
// a matrix), kWgLbo bytes apart along k and kWgSbo along n. Within each 8
// columns the even ones fill the first core matrix and the odd ones the
// second, so that k-index t of a k-step is column 2t and t + 4 is 2t + 1,
// the order x~'s C fragment holds them in: x~ is the A operand as it
// stands.
constexpr int kWgThreads = 384;                  // three warpgroups a block
constexpr int kWgLbo = 128;                      // bytes, along k
constexpr int kWgSbo = 64 / 4 * 128;             // bytes, along n (R = 64)

// hi and lo of rows [0, rows) x columns [0, 64) of src (row stride ld),
// zero past rmax rows and cmax columns, in the canonical layout
__device__ __forceinline__ void stage_split(float* hi, float* lo,
                                            const float* __restrict__ src,
                                            int rows, int rmax, int cmax,
                                            int ld) {
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * 64; i += kWgThreads) {
    const int n = i / 64, col = i % 64;
    const float v = n < rmax && col < cmax ? src[(size_t)n * ld + col] : 0.f;
    uint32_t h, l;
    split(v, h, l);
    const int o = (n / 8) * (kWgSbo / 4) +
                  (2 * (col / 8) + (col & 1)) * (kWgLbo / 4) + (n % 8) * 4 +
                  (col % 8) / 2;
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(l);
  }
}

__device__ __forceinline__ uint64_t wg_desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(kWgLbo >> 4) << 16) |
         ((uint64_t)(kWgSbo >> 4) << 32);
}

// d += a b over one k-step of 8: a the warp's 16 rows of the warpgroup's
// 64 (the mma.sync A fragment), b 64 columns in shared memory (desc); d
// as mma.sync's C fragments of 8 column tiles
__device__ __forceinline__ void wgmma_64x64x8(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d is read only after this (the compiler may not move its reads above a
// wgmma.wait_group)
__device__ __forceinline__ void wg_pin(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    asm volatile("" : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]),
                 "+f"(d[j][3]));
}

// d = a b for the warpgroup's 64 rows and the 64 columns of W at hi, lo:
// over 8 k-steps, lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), waited for
__device__ __forceinline__ void wg_products(float (&d)[8][4],
                                            const uint32_t (&ah)[8][4],
                                            const uint32_t (&al)[8][4],
                                            const float* hi,
                                            const float* lo) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    const int o = 2 * kt * (kWgLbo / 4);
    wgmma_64x64x8(d, al[kt], wg_desc(hi + o));
    wgmma_64x64x8(d, ah[kt], wg_desc(lo + o));
    wgmma_64x64x8(d, ah[kt], wg_desc(hi + o));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_pin(d);
}

// W and M resident, the logits on wgmma (R = 64, d <= 64): as
// resident_kernel, with tiles of 64 rows a warpgroup, each warp forming
// x~ for its 16 of them on mma.sync; then the warpgroup forms the logits
// 64 columns at a time and writes phi from the accumulators.
template <typename T, bool Dark>
__global__ void __launch_bounds__(kWgThreads, 1) wgmma_kernel(
    const T* __restrict__ x, const float* __restrict__ mm,
    const float* __restrict__ w, const float* __restrict__ c,
    float* __restrict__ out, int N, int d, int r, int m, float log2_scale) {
  constexpr int R = 64, kRt = R / 8, kS = kWs<R>, NWG = kWgThreads / 128;
  extern __shared__ __align__(16) unsigned char smem[];
  const int mp = (m + kNs - 1) / kNs * kNs;
  float* whi = reinterpret_cast<float*>(smem);          // (mp, R), canonical
  float* wlo = whi + mp * R;
  float* ms = wlo + mp * R;                              // M, (R, kS)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31,
            g = lane >> 2, t = lane & 3;
  if constexpr (Dark)
    stage<R, R, kWgThreads>(ms, kS, mm, d, 0, r, 0, d,
                            aligned16(mm, (size_t)d * 4));
  cp_async_commit();
  stage_split(whi, wlo, w, mp, m, r, r);
  // W's hi and lo, stored by the generic proxy, are read by wgmma through
  // the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  cp_async_wait<0>();
  __syncthreads();
  const float cval = *c;
  const bool vec_x = d % 2 == 0 && ((size_t)x % (2 * sizeof(T))) == 0;
  const int tiles = (N + 63) / 64, G = gridDim.x;
  for (int tile = warp / 4 * G + blockIdx.x; tile < tiles;
       tile += NWG * G) {
    const int row0 = tile * 64 + 16 * (warp % 4);
    float xt[kRt][4];
    form_xt<T, R, Dark>(x, ms, row0, N, d, vec_x, g, t, xt);
    float bias[2];
    phi_bias<R>(xt, cval, log2_scale, bias);
    uint32_t ah[kRt][4], al[kRt][4];
#pragma unroll
    for (int kt = 0; kt < kRt; ++kt) {
      const float a[4] = {xt[kt][0], xt[kt][2], xt[kt][1], xt[kt][3]};
      split4(a, ah[kt], al[kt]);
    }
    for (int n0 = 0; n0 < m; n0 += kNs) {
      const int o = n0 / 8 * (kWgSbo / 4);
      float acc[kNs / 8][4];
      wg_products(acc, ah, al, whi + o, wlo + o);
      phi_store(acc, n0, row0, N, m, bias, out, g, t);
    }
  }
}

// W and M streamed. Each step of the block is one slab through a ring of
// kStages, loaded kStages - 1 steps ahead: per tile step, ceil(d / kKs)
// slabs of x (and M) form x~ and its norm, then ceil(m / kNs) slabs of W
// form logits and write phi. Warp w of block b takes tile b + G (w + 8 k)
// in tile step k. Used where W and M do not fit a block.
template <typename T, int R, bool Dark>
__global__ void __launch_bounds__(kThreads, R <= 64 ? 2 : 1) stream_kernel(
    const T* __restrict__ x, const float* __restrict__ mm,
    const float* __restrict__ w, const float* __restrict__ c,
    float* __restrict__ out, int N, int d, int r, int m, float log2_scale) {
  constexpr int kRt = R / 8;                 // x~'s column tiles
  constexpr int kStage = kStageBytes<T, R, Dark>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31,
            g = lane >> 2, t = lane & 3;
  const int G = gridDim.x, b = blockIdx.x;
  const int tiles = (N + 15) / 16;
  const int s1 = (d + kKs - 1) / kKs, per = s1 + (m + kNs - 1) / kNs;
  const int total = (tiles - b + kWarps * G - 1) / (kWarps * G) * per;
  const bool vec_x = aligned16(x, (size_t)d * sizeof(T)),
             vec_m = Dark && aligned16(mm, (size_t)d * 4),
             vec_w = aligned16(w, (size_t)r * 4);
  const float cval = *c;
  auto first_row = [&](int k) { return ((k * kWarps + warp) * G + b) * 16; };

  auto issue = [&](int q) {
    unsigned char* st = smem + (q % kStages) * kStage;
    const int k = q / per, s = q % per;
    if (s < s1) {
      stage_x<T>(reinterpret_cast<T*>(st) + warp * 16 * kPs, x, first_row(k),
                 N, s * kKs, d, vec_x, lane);
      if constexpr (Dark)
        stage<R, kKs, kThreads>(reinterpret_cast<float*>(st + kXBytes<T>),
                                kPs, mm, d, 0, r, s * kKs, d, vec_m);
    } else {
      stage<kNs, R, kThreads>(reinterpret_cast<float*>(st), kWs<R>, w, r,
                              (s - s1) * kNs, m, 0, r, vec_w);
    }
  };
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < total) issue(q);
    cp_async_commit();
  }

  float xt[kRt][4];
  float bias[2] = {0.f, 0.f};
  for (int q = 0; q < total; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // slab q landed; q - 1 fully read
    if (q + kStages - 1 < total) issue(q + kStages - 1);
    cp_async_commit();
    const unsigned char* st = smem + (q % kStages) * kStage;
    const int s = q % per, row0 = first_row(q / per);
    if (row0 >= N) continue;         // the warp has no tile in this step
    if (s >= s1) {
      logits_phi<R>(xt, reinterpret_cast<const float*>(st) + g * kWs<R> +
                            2 * t, (s - s1) * kNs, row0, N, m, bias, out, g,
                    t);
      continue;
    }
    if (s == 0) {
#pragma unroll
      for (int j = 0; j < kRt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xt[j][e] = 0.f;
    }
    // the warp's x slab, k-index t at column kk + 2t, t + 4 at kk + 2t + 1
    const T* xs = reinterpret_cast<const T*>(st) + (warp * 16 + g) * kPs +
                  2 * t;
    if constexpr (Dark) {
      const float* mb =
          reinterpret_cast<const float*>(st + kXBytes<T>) + g * kPs + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kKs; kk += 8) {
        const float2 lo = ld2(xs + kk), hi = ld2(xs + 8 * kPs + kk);
        const float a[4] = {lo.x, hi.x, lo.y, hi.y};
        xm_step<R, sizeof(T) == 2>(xt, a, mb + kk, kPs);
      }
    } else {
      // x~ = x: slab s holds x~'s column tiles 4 s .. 4 s + 3
#pragma unroll
      for (int j = 0; j < kRt; ++j)
        if ((j >> 2) == s) {
          const float2 lo = ld2(xs + 8 * (j & 3)),
                       hi = ld2(xs + 8 * kPs + 8 * (j & 3));
          xt[j][0] = lo.x;
          xt[j][1] = lo.y;
          xt[j][2] = hi.x;
          xt[j][3] = hi.y;
        }
    }
    if (s == s1 - 1) phi_bias<R>(xt, cval, log2_scale, bias);
  }
}

// The wgmma kernel where its split W fits a block beside M (r <= 64), else
// the resident kernel where W and M fit, else the streaming one; as many
// blocks as the card holds at once (the occupancy calculator's count a
// SM), at most one per 8 tiles of 16 rows (wgmma: per 3 tiles of 64).
template <typename T, int R, bool Dark>
int launch(const void* x, const float* mm, const float* w, const float* c,
           float* out, int N, int d, int r, int m, float log2_scale,
           cudaStream_t st) {
  constexpr size_t kMaxShmem = 232448;         // a block's, on sm_90
  const int need = ((N + 15) / 16 + kWarps - 1) / kWarps;
  const T* xt = static_cast<const T*>(x);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if constexpr (R == 64) {
    const size_t mp = (size_t)(m + kNs - 1) / kNs * kNs;
    const size_t shmem =
        sizeof(float) * (2 * mp * R + (Dark ? R * kWs<R> : 0));
    if (d <= R && shmem <= kMaxShmem) {
      auto kern = wgmma_kernel<T, Dark>;
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
      if (err != cudaSuccess) return (int)err;
      const int wgs = (N + 63) / 64, per = kWgThreads / 128;
      const int blocks = (wgs + per - 1) / per;
      kern<<<blocks < sms ? blocks : sms, kWgThreads, shmem, st>>>(
          xt, mm, w, c, out, N, d, r, m, log2_scale);
      return (int)cudaGetLastError();
    }
  }
  if constexpr (R <= 128) {
    const size_t shmem = resident_bytes<R, Dark>(m);
    if (d <= R && shmem <= kMaxShmem) {
      auto kern = resident_kernel<T, R, Dark>;
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
      if (err != cudaSuccess) return (int)err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, shmem);
      if (err != cudaSuccess) return (int)err;
      const int cap = (per_sm > 0 ? per_sm : 1) * sms;
      kern<<<need < cap ? need : cap, kThreads, shmem, st>>>(
          xt, mm, w, c, out, N, d, r, m, log2_scale);
      return (int)cudaGetLastError();
    }
  }
  constexpr size_t shmem = (size_t)kStages * kStageBytes<T, R, Dark>;
  auto kern = stream_kernel<T, R, Dark>;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      shmem);
  if (err != cudaSuccess) return (int)err;
  const int cap = (per_sm > 0 ? per_sm : 1) * sms;
  kern<<<need < cap ? need : cap, kThreads, shmem, st>>>(
      xt, mm, w, c, out, N, d, r, m, log2_scale);
  return (int)cudaGetLastError();
}

template <typename T, bool Dark>
int launch_width(const void* x, const float* mm, const float* w,
                 const float* c, float* out, int N, int d, int r, int m,
                 float log2_scale, cudaStream_t st) {
  if (r <= 64)
    return launch<T, 64, Dark>(x, mm, w, c, out, N, d, r, m, log2_scale, st);
  if (r <= 128)
    return launch<T, 128, Dark>(x, mm, w, c, out, N, d, r, m, log2_scale,
                                st);
  if (r <= 256)
    return launch<T, 256, Dark>(x, mm, w, c, out, N, d, r, m, log2_scale,
                                st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace pfm

// x: (N, d) f32 or bf16; m_mat: (r, d) f32 or null (isotropic: r = d);
// w: (m, r) f32; c: one f32; out: (N, m) f32. r (d when m_mat is null) at
// most 256; d and m any. Returns a cudaError_t (cudaErrorInvalidValue for
// r > 256).
extern "C" int prf_featmap(const void* x, const float* m_mat, const float* w,
                           const float* c, float* out, int N, int d, int r,
                           int m, int bf16_x, float inv_sqrt_m,
                           void* stream) {
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float l2s = std::log2(inv_sqrt_m);
  if (m_mat != nullptr) {
    if (bf16_x)
      return pfm::launch_width<__nv_bfloat16, true>(x, m_mat, w, c, out, N, d,
                                                    r, m, l2s, st);
    return pfm::launch_width<float, true>(x, m_mat, w, c, out, N, d, r, m,
                                          l2s, st);
  }
  if (bf16_x)
    return pfm::launch_width<__nv_bfloat16, false>(x, m_mat, w, c, out, N, d,
                                                   d, m, l2s, st);
  return pfm::launch_width<float, false>(x, m_mat, w, c, out, N, d, d, m,
                                         l2s, st);
}
