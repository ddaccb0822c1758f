// Two-stage one-token PRF decode step for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/prf_decode_step.py,
//   prf_decode_step_fwd (body _kernel). Per query row n, over features
//   computed beforehand (qf, kf) and the stabilizer's rescale rho:
//     S' = rho S + kf v^T,  z' = rho z + kf,  out = qf.S' / (qf.z' + eps)
//   with S and z updated in place. kf, v and rho are read per KV row:
//   query row n uses KV row n / hq, so the hq query heads of a GQA group
//   share one copy (no broadcast copy).
//
// What bounds it on the H100: the bytes of the state. Each call reads and
//   writes S (N*m*dv f32) and z (N*m f32) once: for smollm-135m at 8
//   slots (N = 72 rows, m = 256, dv = 64) that is 2 * 4.72 MB, 2.9 us at
//   3.35 TB/s, against 0.005 GFLOP of arithmetic.
//
// Design: one block per (query row, 16-column tile of dv), 288 blocks at
//   that shape (one block per row would leave 60 of the 132 SMs idle).
//   The block stages qf and kf in shared memory and forms the denominator
//   qf.z' itself; then each thread streams its column of the tile over a
//   sixteenth of the rows, so every element of S is read, rescaled,
//   updated and written back exactly once while its share of the readout
//   is summed. All tiles of a row need z (the denominator), so they read
//   it from a snapshot copied here before the launch when there is more
//   than one tile; tile 0 writes z'.
#include "prf_common.cuh"

namespace pds {

constexpr int kThreads = 256;
constexpr int kCols = 16;                      // dv columns per block
constexpr int kGroups = kThreads / kCols;      // row groups per column

__global__ void __launch_bounds__(kThreads) decode_step_kernel(
    const float* __restrict__ qf, const float* __restrict__ kf,
    const float* __restrict__ v, const float* __restrict__ rho, float* s,
    float* z, const float* z_old, float* __restrict__ out, int m, int dv,
    int hq, float eps) {
  extern __shared__ float smem[];
  float* qs = smem;                            // (m)
  float* ks = qs + m;                          // (m)
  float* red = ks + m;                         // (kThreads)
  const int tid = threadIdx.x;
  const int tile = blockIdx.x, n = blockIdx.y, nk = n / hq;
  const float r = rho[nk];
  const float* qn = qf + (size_t)n * m;
  const float* kn = kf + (size_t)nk * m;
  const float* zn = z_old + (size_t)n * m;

  float den = 0.f;
  for (int i = tid; i < m; i += kThreads) {
    const float q = qn[i], k = kn[i];
    qs[i] = q;
    ks[i] = k;
    den += q * (zn[i] * r + k);
  }
  den = prf::block_sum(den, red);              // synchronises: qs, ks ready

  const int j = tile * kCols + tid % kCols, rg = tid / kCols;
  float num = 0.f;
  if (j < dv) {
    const float vj = v[(size_t)nk * dv + j];
    float* sn = s + (size_t)n * m * dv + j;
#pragma unroll 4
    for (int i = rg; i < m; i += kGroups) {
      const float sv = sn[(size_t)i * dv] * r + ks[i] * vj;
      sn[(size_t)i * dv] = sv;
      num += qs[i] * sv;
    }
  }
  __syncthreads();                             // block_sum done with red
  red[tid] = num;
  __syncthreads();
  if (tid < kCols && tile * kCols + tid < dv) {
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) acc += red[g * kCols + tid];
    out[(size_t)n * dv + tile * kCols + tid] = acc / (den + eps);
  }
  if (tile == 0) {                             // this block read z already
    float* zw = z + (size_t)n * m;
    for (int i = tid; i < m; i += kThreads) zw[i] = zn[i] * r + ks[i];
  }
}

}  // namespace pds

// qf: (N, m); kf: (Nk, m); v: (Nk, dv); rho: (Nk); s: (N, m, dv) and
// z: (N, m), updated in place; z_old: (N, m) scratch for z's snapshot (may
// be z itself when dv fits one tile); out: (N, dv). All f32; query row n
// reads KV row n / (N / Nk).
extern "C" int prf_decode_step(const float* qf, const float* kf,
                               const float* v, const float* rho, float* s,
                               float* z, float* z_old, float* out, int N,
                               int Nk, int m, int dv, float eps,
                               void* stream) {
  using namespace pds;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (z_old != z) {
    const cudaError_t err =
        cudaMemcpyAsync(z_old, z, sizeof(float) * (size_t)N * m,
                        cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t shmem = sizeof(float) * (2 * (size_t)m + kThreads);
  cudaFuncSetAttribute(decode_step_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)shmem);
  const dim3 grid((dv + kCols - 1) / kCols, N);
  decode_step_kernel<<<grid, kThreads, shmem, st>>>(
      qf, kf, v, rho, s, z, z_old, out, m, dv, N / Nk, eps);
  return (int)cudaGetLastError();
}
