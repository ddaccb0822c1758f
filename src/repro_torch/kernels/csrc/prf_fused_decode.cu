// Fused one-token data-aligned PRF decode for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/prf_fused_decode.py,
//   prf_fused_decode_fwd (body _kernel). Per (b, g, h):
//     qraw = q A - |Mq|^2/2,  kraw = k A - |Mk|^2/2
//     c' = max(c, max_m kraw), rho = exp(c - c')
//     qf = exp(qraw - max_m qraw)/sqrt(m),  kf = exp(kraw - c')/sqrt(m)
//     S' = rho S + kf v^T,  z' = rho z + kf,  out = qf.S' / (qf.z' + eps)
//   with S, z, c updated in place (stabilize=0: c' = 0, rho = exp(c)).
//
// What bounds it on the H100: the bytes of the state. Each call reads and
//   writes S (B*G*Hg*m*dv f32) and z (B*G*Hg*m f32) once: for smollm-135m
//   at 8 slots (G=3, Hg=3, m=256, dv=64) that is 2 * 4.72 MB = 9.4 MB,
//   2.8 us at 3.35 TB/s, against 0.009 GFLOP of arithmetic (features and
//   state update), 0.13 us at the 67 TFLOP/s of f32.
//
// Design: one block per (b, g, h, 64-column tile of dv). The block
//   computes both feature vectors (m floats each) into shared memory, then
//   streams its m x 64 slice of S exactly once: each element is read,
//   rescaled, updated and written back while its contribution to the
//   readout is summed, so S makes one round trip through device memory.
//   Four threads share a column (neighbouring lanes) and reduce by
//   shuffles. c is shared by the Hg heads of a group and z by the tiles of
//   a head, so blocks read c (and, with several tiles, z) from snapshots
//   copied here before the launch; (h = 0, tile 0) writes c, tile 0 writes z.
#include "prf_common.cuh"

namespace prf {

template <typename T>
__global__ void __launch_bounds__(kThreads) prf_fused_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ a, const float* __restrict__ mm, float* s,
    float* z, const float* z_old, float* c, const float* c_old,
    float* __restrict__ out, int G, int Hg, int d, int r, int m, int dv,
    int stabilize, float eps, float inv_sqrt_m) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x, h = blockIdx.y, bg = blockIdx.z;
  const int g = bg % G;
  const size_t head = (size_t)bg * Hg + h;        // flat (b, g, h)
  float* xs = smem;                              // (2, d): q row, k row
  float* xt = xs + 2 * d;                        // (2, r)
  float* nrm = xt + 2 * r;                       // (2) padded to 32
  float* feat = nrm + 32;                        // (2, m): qf, kf
  float* scratch = feat + 2 * m;                 // (32)

  for (int e = tid; e < d; e += blockDim.x) {
    xs[e] = to_f(q[head * d + e]);
    xs[d + e] = to_f(k[(size_t)bg * d + e]);
  }
  __syncthreads();
  featurize<2>(xs, 2, a + (size_t)g * d * m,
               mm != nullptr ? mm + (size_t)g * r * d : nullptr, d, r, m, xt,
               nrm, feat);

  float qm = kNeg, km = kNeg;
  for (int i = tid; i < m; i += blockDim.x) {
    qm = fmaxf(qm, feat[i]);
    km = fmaxf(km, feat[m + i]);
  }
  qm = block_max(qm, scratch);
  km = block_max(km, scratch);
  const float c_in = c_old[bg];
  float c_new, rho, qshift;
  if (stabilize) {
    c_new = fmaxf(c_in, km);
    rho = expf(c_in - c_new);
    qshift = qm;
  } else {
    c_new = 0.f;
    rho = expf(c_in);
    qshift = 0.f;
  }
  for (int i = tid; i < m; i += blockDim.x) {
    feat[i] = expf(feat[i] - qshift) * inv_sqrt_m;
    feat[m + i] = expf(feat[m + i] - c_new) * inv_sqrt_m;
  }
  __syncthreads();
  const float* qf = feat;
  const float* kf = feat + m;

  const int rg = tid & (kRowGroups - 1);
  const int j = tile * kTileCols + tid / kRowGroups;
  const bool col = j < dv;
  const float vj = col ? to_f(v[(size_t)bg * dv + j]) : 0.f;
  float* sh = s + head * m * dv;
  const float* zh = z_old + head * m;
  float num = 0.f, den = 0.f;
  for (int i = rg; i < m; i += kRowGroups) {
    const float kfi = kf[i], qfi = qf[i];
    if (col) {
      const float sv = sh[(size_t)i * dv + j] * rho + kfi * vj;
      sh[(size_t)i * dv + j] = sv;
      num += qfi * sv;
    }
    den += qfi * (zh[i] * rho + kfi);
  }
  num = group_sum(num);
  den = group_sum(den);
  if (rg == 0 && col) out[head * dv + j] = num / (den + eps);
  if (tile == 0) {
    __syncthreads();                   // every read of z_old (maybe z) done
    for (int i = tid; i < m; i += blockDim.x)
      z[head * m + i] = zh[i] * rho + kf[i];
    if (h == 0 && tid == 0) c[bg] = c_new;
  }
}

}  // namespace prf

extern "C" int prf_fused_decode(const void* q, const void* k, const void* v,
                                const float* a, const float* m_mat, float* s,
                                float* z, float* c, float* z_old, float* c_old,
                                float* out, int B, int G, int Hg, int d, int r,
                                int m, int dv, int bf16_inputs, int stabilize,
                                float eps, float inv_sqrt_m, void* stream) {
  using namespace prf;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemcpyAsync(c_old, c, sizeof(float) * B * G, cudaMemcpyDeviceToDevice,
                  st);
  if (z_old != z)
    cudaMemcpyAsync(z_old, z, sizeof(float) * B * G * Hg * m,
                    cudaMemcpyDeviceToDevice, st);
  const dim3 grid((dv + kTileCols - 1) / kTileCols, Hg, B * G);
  const size_t shmem = sizeof(float) * (2 * d + 2 * r + 32 + 2 * m + 32);
  if (bf16_inputs) {
    auto kern = prf_fused_decode_kernel<__nv_bfloat16>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)shmem);
    kern<<<grid, kThreads, shmem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), a, m_mat, s, z, z_old, c, c_old,
        out, G, Hg, d, r, m, dv, stabilize, eps, inv_sqrt_m);
  } else {
    auto kern = prf_fused_decode_kernel<float>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)shmem);
    kern<<<grid, kThreads, shmem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), a, m_mat, s, z, z_old, c, c_old, out, G,
        Hg, d, r, m, dv, stabilize, eps, inv_sqrt_m);
  }
  return (int)cudaGetLastError();
}
