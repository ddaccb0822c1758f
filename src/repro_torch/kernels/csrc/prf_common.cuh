// Device helpers shared by the port's kernels (csrc/*.cu): type
// conversion, warp and block reductions and the raw PRF logits through the
// precomposed projection A = (W M)^T.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace prf {

constexpr int kThreads = 256;                  // threads per block
constexpr int kRowGroups = 4;                  // threads sharing a column
constexpr int kTileCols = kThreads / kRowGroups;   // dv columns per block
constexpr float kNeg = -3.402823466e+38f;      // finfo(float32).min

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the kRowGroups neighbouring lanes that share one output column.
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// Block-wide max; every thread gets the result. scratch: >= 32 floats.
__device__ float block_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                     // scratch may still be read
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : kNeg;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum; every thread gets the result. scratch: >= 32 floats.
__device__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                     // scratch may still be read
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0.f;
  return warp_sum(v);
}

// Raw PRF logits of the n rows of xs (n <= NMAX, row stride d, shared
// memory): raw[t*m + i] = sum_e xs[t][e] a[e][i] - ||M xs[t]||^2 / 2,
// with ||xs[t]||^2 / 2 when mm is null (isotropic kinds). Used by
// prf_fused_decode.cu alone: the prefill kernel computes its logits as
// register tiles of its own.
// a: (d, m) and mm: (r, d) of this KV group, f32 in device memory.
// xt: n*r floats and nrm: n floats of shared scratch. Ends synchronised.
template <int NMAX>
__device__ void featurize(const float* xs, int n, const float* __restrict__ a,
                          const float* __restrict__ mm, int d, int r, int m,
                          float* xt, float* nrm, float* raw) {
  const int tid = threadIdx.x;
  if (mm != nullptr) {
    for (int idx = tid; idx < n * r; idx += blockDim.x) {
      const int t = idx / r, rr = idx - t * r;
      const float* mrow = mm + (size_t)rr * d;
      const float* x = xs + t * d;
      float acc = 0.f;
      for (int e = 0; e < d; ++e) acc += mrow[e] * x[e];
      xt[idx] = acc;
    }
    __syncthreads();
  }
  const float* src = mm != nullptr ? xt : xs;
  const int w = mm != nullptr ? r : d;
  const int warp = tid >> 5, lane = tid & 31;
  for (int t = warp; t < n; t += blockDim.x >> 5) {
    float acc = 0.f;
    for (int e = lane; e < w; e += 32) {
      const float u = src[t * w + e];
      acc += u * u;
    }
    acc = warp_sum(acc);
    if (lane == 0) nrm[t] = 0.5f * acc;
  }
  __syncthreads();
  for (int i = tid; i < m; i += blockDim.x) {
    float acc[NMAX];
#pragma unroll
    for (int t = 0; t < NMAX; ++t) acc[t] = 0.f;
    for (int e = 0; e < d; ++e) {
      const float av = a[(size_t)e * m + i];
#pragma unroll
      for (int t = 0; t < NMAX; ++t)
        if (t < n) acc[t] += xs[t * d + e] * av;
    }
#pragma unroll
    for (int t = 0; t < NMAX; ++t)
      if (t < n) raw[t * m + i] = acc[t] - nrm[t];
  }
  __syncthreads();
}

}  // namespace prf
