// Device helpers shared by the port's kernels (csrc/*.cu): type
// conversion, warp and block reductions, cp.async staging, 16-byte loads,
// programmatic dependent launch, cluster barriers, and the one-token
// state stream of B1 and B3.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace prf {

constexpr int kThreads = 256;                  // threads per block
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

// Sum over the four neighbouring lanes that share one output column.
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Programmatic dependent launch: a kernel launched by launch_after() may
// start while the kernel before it in the stream finishes; it waits here,
// before its first read of device memory, until that kernel has finished
// and its writes are visible (a no-op for a plain launch). A kernel lets
// its dependent start launching once every block has passed
// grid_dependents_launch().
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Thread block cluster barrier halves: arrive releases this thread's
// writes (shared memory included) to the cluster, wait acquires the
// others'. Between them a block may work; it must not exit while another
// block may still read its shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// RPT consecutive floats (16-byte aligned when RPT is a multiple of 4).
template <int RPT>
__device__ __forceinline__ void load_rows(const float* p, float* out) {
  if constexpr (RPT % 4 == 0) {
#pragma unroll
    for (int u = 0; u < RPT; u += 4) {
      const float4 t = ld4(p + u);
      out[u] = t.x; out[u + 1] = t.y; out[u + 2] = t.z; out[u + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < RPT; ++u) out[u] = p[u];
  }
}

// One block's share of a one-token step of a linear-attention state (B1's
// stream launch, B3): over all M rows of the COLS columns col0 .. of one
// query row's S (M x dv f32, in place)
//   S' = rho S + kf v^T,  out = qf.S' / (den + eps)
// with den = qf.z when z holds z' already (OLD_Z false), or den =
// qf.(rho z + kf) over the old z (OLD_Z true: the blocks of the row form a
// thread block cluster, and each arrives on the cluster barrier once it
// has read z; the caller waits on it before z' is written). v (dv) is the
// row's value, qf, kf, z (M) its features and normalizer, rho its rescale,
// out (dv) its output. A thread holds RPT rows x 4 columns of S. Its S
// loads (16 bytes each) and v are issued before grid_dependency_wait(),
// and qf, kf, rho and z are read only after it, so a kernel launched by
// launch_after() streams S while the kernel before it finishes (for a
// plain launch the wait is a no-op). Each S element is read and written
// once. num sums over a column's row lanes by shuffles, then over the
// block's warps in shared memory; den is summed once per row, by the
// first 4 columns' threads, in the same pass. s, qf, kf and z 16-byte
// aligned, dv % 4 == 0.
template <typename T, int M, int COLS, bool OLD_Z>
__device__ __forceinline__ void state_stream(
    const T* __restrict__ v, const float* __restrict__ qf,
    const float* __restrict__ kf, const float* __restrict__ rho,
    const float* __restrict__ z, float* __restrict__ s,
    float* __restrict__ out, int col0, int dv, float eps) {
  constexpr int QUADS = COLS / 4;                 // threads across a row
  constexpr int ROW_LANES = kThreads / QUADS;
  constexpr int RPT = M >= ROW_LANES ? M / ROW_LANES : 1;  // rows a thread
  constexpr int LANES = M / RPT;                  // row lanes in use
  constexpr int WARPS = kThreads / 32;
  static_assert(COLS % 4 == 0 && 32 % QUADS == 0 && M % RPT == 0, "tile");
  __shared__ float red[WARPS][COLS + 1];          // num, then den
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = tid % QUADS, rl = tid / QUADS;
  const int j = col0 + 4 * quad;                  // the thread's columns
  const bool act = rl < LANES && j < dv;
  const int i0 = rl * RPT;
  float* sp = s + (size_t)i0 * dv + j;
  float4 sv[RPT];
  float vv[4] = {0.f, 0.f, 0.f, 0.f};
  if (act) {
#pragma unroll
    for (int p = 0; p < RPT; ++p) sv[p] = ld4(sp + (size_t)p * dv);
#pragma unroll
    for (int u = 0; u < 4; ++u) vv[u] = to_f(v[j + u]);
  }
  grid_dependency_wait();            // the kernel before has written its part
  float num[4] = {0.f, 0.f, 0.f, 0.f};
  float den = 0.f;
  if (act) {
    float q[RPT], k[RPT];
    load_rows<RPT>(qf + i0, q);
    load_rows<RPT>(kf + i0, k);
    const float r = *rho;
    if (quad == 0) {                 // den once per row
      float zn[RPT];
      load_rows<RPT>(z + i0, zn);
#pragma unroll
      for (int p = 0; p < RPT; ++p)
        den += q[p] * (OLD_Z ? zn[p] * r + k[p] : zn[p]);
    }
    if constexpr (OLD_Z) cluster_arrive();   // this thread has read z
#pragma unroll
    for (int p = 0; p < RPT; ++p) {
      float4 x = sv[p];
      x.x = x.x * r + k[p] * vv[0];
      x.y = x.y * r + k[p] * vv[1];
      x.z = x.z * r + k[p] * vv[2];
      x.w = x.w * r + k[p] * vv[3];
      *reinterpret_cast<float4*>(sp + (size_t)p * dv) = x;
      num[0] += q[p] * x.x;
      num[1] += q[p] * x.y;
      num[2] += q[p] * x.z;
      num[3] += q[p] * x.w;
    }
  } else if constexpr (OLD_Z) {
    cluster_arrive();
  }
  // over the row lanes of a column: the lanes of a warp, then the warps
#pragma unroll
  for (int o = QUADS; o < 32; o <<= 1) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      num[u] += __shfl_xor_sync(0xffffffffu, num[u], o);
    den += __shfl_xor_sync(0xffffffffu, den, o);
  }
  if (lane < QUADS) {
#pragma unroll
    for (int u = 0; u < 4; ++u) red[warp][4 * lane + u] = num[u];
  }
  if (lane == 0) red[warp][COLS] = den;
  __syncthreads();
  const int col = col0 + tid;
  if (tid < COLS && col < dv) {
    float acc = 0.f, dsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      acc += red[w][tid];
      dsum += red[w][COLS];
    }
    out[col] = acc / (dsum + eps);
  }
}

// Launch `kern` on `st` so that it may start while the kernel before it
// finishes (it waits in grid_dependency_wait()).
template <typename... Params, typename... Args>
int launch_after(void (*kern)(Params...), dim3 grid, int threads,
                 size_t smem, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, args...);
}

}  // namespace prf
