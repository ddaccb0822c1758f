// Fused PRF feature map for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/prf_featmap.py,
//   prf_featmap_fwd (bodies _kernel_dark and _kernel_iso). Per row x of
//   an (N, d) input:
//     x~ = M x (dark; x~ = x for the isotropic kinds, M = null)
//     phi(x) = exp(W x~ - ||x~||^2 / 2 - c) / sqrt(m)      (N, m) f32
//   with W (m, r), M (r, d) and the scalar stabilizer c (device memory).
//
// What bounds it on the H100: the arithmetic. At the smollm-135m training
//   feature shape (36 864 rows, d = r = 64, m = 256) the two products take
//   2 d r + 2 r m flops a row, 1.51 GFLOP, 22.5 us at the 67 TFLOP/s of
//   f32 outside the tensor cores; x in and phi out move 47 MB, 14 us.
//
// Design: W^T and M^T stay resident in shared memory for the whole call
//   (transposed so that neighbouring threads read neighbouring words); a
//   grid of up to two blocks per SM walks the rows in tiles of 64. Per
//   tile the block stages x, forms x~ = x M^T and the half squared norms
//   in shared memory, then each thread computes an 8 x 8 block of the
//   (64, 256) logit tile in registers (rows ty + 8a, columns tx + 32b) and
//   writes exp(logit - ||x~||^2/2 - c)/sqrt(m) coalesced. x~ never leaves
//   shared memory.
#include "prf_common.cuh"

namespace pfm {

using prf::to_f;

constexpr int kThreads = 256;
constexpr int kRows = 64;                  // rows of x per tile
constexpr int kMicro = 8;                  // a thread's rows / columns
constexpr int kCols = 32 * kMicro;         // logit columns per pass

template <typename T, bool Dark>
__global__ void __launch_bounds__(kThreads) prf_featmap_kernel(
    const T* __restrict__ x, const float* __restrict__ mm,
    const float* __restrict__ w, const float* __restrict__ c,
    float* __restrict__ out, int N, int d, int r, int m, float inv_sqrt_m) {
  extern __shared__ float smem[];
  float* wt = smem;                            // (r, m) = W^T
  float* mt = wt + r * m;                      // (d, r) = M^T (dark)
  float* xs = mt + (Dark ? d * r : 0);         // (kRows, d)
  float* xt = Dark ? xs + kRows * d : xs;      // (kRows, r)
  float* sq = xt + kRows * r;                  // (kRows)
  const int tid = threadIdx.x;
  for (int idx = tid; idx < m * r; idx += kThreads) {
    const int j = idx / r, k = idx - j * r;
    wt[k * m + j] = w[idx];
  }
  if (Dark) {
    for (int idx = tid; idx < r * d; idx += kThreads) {
      const int k = idx / d, e = idx - k * d;
      mt[e * r + k] = mm[idx];
    }
  }
  const float cval = *c;
  const int tx = tid % 32, ty = tid / 32;
  const int warp = tid / 32, lane = tid % 32;

  for (int row0 = blockIdx.x * kRows; row0 < N; row0 += gridDim.x * kRows) {
    __syncthreads();                 // W, M staged; the last tile consumed
    for (int idx = tid; idx < kRows * d; idx += kThreads) {
      const int i = idx / d;
      xs[idx] = row0 + i < N ? to_f(x[(size_t)row0 * d + idx]) : 0.f;
    }
    __syncthreads();
    if (Dark) {
      for (int idx = tid; idx < kRows * r; idx += kThreads) {
        const int i = idx / r, k = idx - i * r;
        float acc = 0.f;
        for (int e = 0; e < d; ++e) acc += xs[i * d + e] * mt[e * r + k];
        xt[idx] = acc;
      }
      __syncthreads();
    }
    for (int i = warp; i < kRows; i += kThreads / 32) {
      float s = 0.f;
      for (int k = lane; k < r; k += 32) s += xt[i * r + k] * xt[i * r + k];
      s = prf::warp_sum(s);
      if (lane == 0) sq[i] = 0.5f * s;
    }
    __syncthreads();
    for (int j0 = 0; j0 < m; j0 += kCols) {
      float acc[kMicro][kMicro];
#pragma unroll
      for (int a = 0; a < kMicro; ++a)
#pragma unroll
        for (int b = 0; b < kMicro; ++b) acc[a][b] = 0.f;
      for (int k = 0; k < r; ++k) {
        float xa[kMicro], wb[kMicro];
#pragma unroll
        for (int a = 0; a < kMicro; ++a) xa[a] = xt[(ty + 8 * a) * r + k];
#pragma unroll
        for (int b = 0; b < kMicro; ++b) {
          const int j = j0 + tx + 32 * b;
          wb[b] = j < m ? wt[k * m + j] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kMicro; ++a)
#pragma unroll
          for (int b = 0; b < kMicro; ++b) acc[a][b] += xa[a] * wb[b];
      }
#pragma unroll
      for (int a = 0; a < kMicro; ++a) {
        const int i = ty + 8 * a;
        if (row0 + i >= N) continue;
#pragma unroll
        for (int b = 0; b < kMicro; ++b) {
          const int j = j0 + tx + 32 * b;
          if (j < m)
            out[(size_t)(row0 + i) * m + j] =
                expf(acc[a][b] - sq[i] - cval) * inv_sqrt_m;
        }
      }
    }
  }
}

template <typename T, bool Dark>
int launch(const void* x, const float* mm, const float* w, const float* c,
           float* out, int N, int d, int r, int m, float inv_sqrt_m,
           size_t shmem, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (N + kRows - 1) / kRows;
  const int grid = tiles < 2 * sms ? tiles : 2 * sms;
  auto kern = prf_featmap_kernel<T, Dark>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)shmem);
  kern<<<grid, kThreads, shmem, st>>>(static_cast<const T*>(x), mm, w, c, out,
                                      N, d, r, m, inv_sqrt_m);
  return (int)cudaGetLastError();
}

}  // namespace pfm

// Shared memory the kernel needs for these widths (the wrapper refuses a
// call above the card's 227 KB a block).
extern "C" size_t prf_featmap_smem(int d, int r, int m, int dark) {
  const int rr = dark ? r : d;
  return sizeof(float) * ((size_t)rr * m + (dark ? (size_t)d * r : 0) +
                          (size_t)pfm::kRows * d +
                          (dark ? (size_t)pfm::kRows * r : 0) + pfm::kRows);
}

// x: (N, d) f32 or bf16; m_mat: (r, d) f32 or null; w: (m, r) f32 (r = d
// when m_mat is null); c: one f32; out: (N, m) f32.
extern "C" int prf_featmap(const void* x, const float* m_mat, const float* w,
                           const float* c, float* out, int N, int d, int r,
                           int m, int bf16_x, float inv_sqrt_m,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dark = m_mat != nullptr;
  const size_t shmem = prf_featmap_smem(d, r, m, dark);
  if (dark) {
    if (bf16_x)
      return pfm::launch<__nv_bfloat16, true>(x, m_mat, w, c, out, N, d, r, m,
                                              inv_sqrt_m, shmem, st);
    return pfm::launch<float, true>(x, m_mat, w, c, out, N, d, r, m,
                                    inv_sqrt_m, shmem, st);
  }
  if (bf16_x)
    return pfm::launch<__nv_bfloat16, false>(x, m_mat, w, c, out, N, d, d, m,
                                             inv_sqrt_m, shmem, st);
  return pfm::launch<float, false>(x, m_mat, w, c, out, N, d, d, m,
                                   inv_sqrt_m, shmem, st);
}
