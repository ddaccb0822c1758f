// Two-stage one-token PRF decode step for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/prf_decode_step.py,
//   prf_decode_step_fwd (body _kernel). Per query row n, over features
//   computed beforehand (qf, kf) and the stabilizer's rescale rho:
//     S' = rho S + kf v^T,  z' = rho z + kf,  out = qf.S' / (qf.z' + eps)
//   with S and z updated in place. kf, v and rho are read per KV row:
//   query row n uses KV row n / hq, so the hq query heads of a GQA group
//   share one copy (no broadcast copy). v is f32 or bf16, cast here.
//
// What bounds it on the H100: the bytes of the state. Each call reads and
//   writes S (N*m*dv f32) and z (N*m f32) once: for smollm-135m at 8
//   slots (N = 72 rows, m = 256, dv = 64) that is 2 * 4.72 MB, 2.9 us at
//   3.35 TB/s, against 0.005 GFLOP of arithmetic. On the serving path
//   each layer's S is cold: the 30 layers' pools (141 MB at 8 slots) pass
//   through the 50 MB L2 every step.
//
// Design: one launch, B1's S stream (prf::state_stream, prf_common.cuh)
//   with the row's tiles in a thread block cluster. A block covers all m
//   rows of COLS columns of one query row: COLS = 16 up to dv = 128, 32
//   above, so a row is at most 8 blocks, a portable cluster (288 blocks in
//   clusters of 4 at smollm-135m's 8 slots, 512 in clusters of 8 at
//   darkformer-2b's). A thread holds 4 (8 at COLS = 32) rows x 4 columns
//   of S, loaded 16 bytes at a time before anything else; every S element
//   is read and written once, and den = qf.(rho z + kf) is formed once per
//   row in the numerator's own reduction. Every tile needs the old z for
//   den, so each arrives on the cluster barrier once it has read z, and
//   the first tile writes z' = rho z + kf in place after the barrier: no
//   copy of z, nothing allocated but the output, 0.5-1 KB of static
//   shared memory and so no attribute to set. Two launches (z' first, then
//   the stream after a programmatic-dependent wait, as B1 runs) measured
//   slower at smollm-135m's shapes and faster at darkformer-2b's 8 slots
//   on an H100 (PERF.md section 6).
#include "prf_common.cuh"

namespace prf {
namespace step {

// The S stream of one (query row, COLS columns) over the old z, the row's
// tiles a cluster; the first tile writes z' once every tile has read z.
template <typename T, int M, int COLS>
__global__ void __launch_bounds__(kThreads) step_kernel(
    const float* __restrict__ qf, const float* __restrict__ kf,
    const T* __restrict__ v, const float* __restrict__ rho,
    float* __restrict__ z, float* __restrict__ s, float* __restrict__ out,
    int dv, int hq, float eps) {
  const int n = blockIdx.y, nk = n / hq;
  float* zn = z + (size_t)n * M;
  const float* kn = kf + (size_t)nk * M;
  state_stream<T, M, COLS, true>(
      v + (size_t)nk * dv, qf + (size_t)n * M, kn, rho + nk, zn,
      s + (size_t)n * M * dv, out + (size_t)n * dv, blockIdx.x * COLS, dv,
      eps);
  cluster_wait();                    // every tile has read the row's z
  if (blockIdx.x == 0) {
    const float r = rho[nk];
    for (int i = threadIdx.x; i < M; i += kThreads) zn[i] = zn[i] * r + kn[i];
  }
}

template <typename T, int M, int COLS>
int run(const float* qf, const float* kf, const void* v, const float* rho,
        float* s, float* z, float* out, int N, int hq, int dv, float eps,
        cudaStream_t st) {
  const dim3 grid((dv + COLS - 1) / COLS, N);
  if (grid.x > 8) return (int)cudaErrorInvalidValue;   // a portable cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, step_kernel<T, M, COLS>, qf, kf,
                                 static_cast<const T*>(v), rho, z, s, out,
                                 dv, hq, eps);
}

template <typename T, int COLS>
int dispatch_m(int m, const float* qf, const float* kf, const void* v,
               const float* rho, float* s, float* z, float* out, int N,
               int hq, int dv, float eps, cudaStream_t st) {
#define PRF_STEP_CASE(MM)                                                 \
  case MM:                                                                \
    return run<T, MM, COLS>(qf, kf, v, rho, s, z, out, N, hq, dv, eps, st);
  switch (m) {
    PRF_STEP_CASE(16)
    PRF_STEP_CASE(32)
    PRF_STEP_CASE(64)
    PRF_STEP_CASE(128)
    PRF_STEP_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PRF_STEP_CASE
}

template <typename T>
int dispatch_cols(int m, const float* qf, const float* kf, const void* v,
                  const float* rho, float* s, float* z, float* out, int N,
                  int hq, int dv, float eps, cudaStream_t st) {
  if (dv <= 128)
    return dispatch_m<T, 16>(m, qf, kf, v, rho, s, z, out, N, hq, dv, eps,
                             st);
  return dispatch_m<T, 32>(m, qf, kf, v, rho, s, z, out, N, hq, dv, eps, st);
}

}  // namespace step
}  // namespace prf

// qf: (N, m); kf: (Nk, m); v: (Nk, dv) f32, or bf16 when bf16_v; rho:
// (Nk); s: (N, m, dv) and z: (N, m), updated in place; out: (N, dv). All
// f32 but v; query row n reads KV row n / (N / Nk). m in 16, 32, 64, 128,
// 256; dv a multiple of 4, at most 256; qf, kf, s and z 16-byte aligned.
extern "C" int prf_decode_step(const float* qf, const float* kf,
                               const void* v, const float* rho, float* s,
                               float* z, float* out, int N, int Nk, int m,
                               int dv, int bf16_v, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dv % 4 || Nk <= 0 || N % Nk) return (int)cudaErrorInvalidValue;
  if (bf16_v)
    return prf::step::dispatch_cols<__nv_bfloat16>(
        m, qf, kf, v, rho, s, z, out, N, N / Nk, dv, eps, st);
  return prf::step::dispatch_cols<float>(m, qf, kf, v, rho, s, z, out, N,
                                         N / Nk, dv, eps, st);
}
