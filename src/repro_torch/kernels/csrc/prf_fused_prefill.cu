// Fused resumable data-aligned PRF prefill chunk for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/prf_fused_prefill.py,
//   prf_fused_prefill_fwd (body _kernel). Over each internal T-chunk of a
//   packed (B, L) chunk, per (b, g, h):
//     qraw = q A - |Mq|^2/2,  kraw = k A - |Mk|^2/2
//     c' = max(c, max_{valid,m} kraw), rho = exp(c - c')
//     qf = exp(qraw - max_{valid,m} qraw)/sqrt(m)
//     kf = [pos < valid_len] exp(kraw - c')/sqrt(m)
//     out = (qf.(rho S) + tril(qf kf^T) v) / (qf.(rho z) + sum tril + eps)
//     S' = rho S + kf^T v,  z' = rho z + sum_T kf
//   carrying (S, z, c) from one T-chunk to the next, written in place.
//
// What bounds it on the H100: the state's bytes and the arithmetic of
//   the causal scan. Each call reads and writes S (B*G*Hg*m*dv f32) and z
//   once: for smollm-135m at 8 rows that is 2 * 4.72 MB = 9.4 MB, 2.8 us
//   at 3.35 TB/s. The arithmetic is the features, 2*d*m + 2*r*d flops per
//   featurized q or k row, plus the scan, 4*m*dv + 4*m flops per token per
//   head: 0.28 GFLOP for 8 rows of 32 tokens (0.13 features, 0.15 scan),
//   4.2 us at the 67 TFLOP/s of f32 outside the tensor cores, so at
//   serving shapes the arithmetic bounds it.
//
// Design: one block per (b, g, h, 64-column tile of dv). The TPU kernel's
//   sequential chunk axis, which kept S in VMEM, becomes a loop inside
//   the block, and S stays in registers for the whole call: each of the
//   256 threads holds m/4 rows of one column of S (and the matching m/4
//   entries of z), so S crosses device memory once in and once out.
//   Per T-chunk the block makes two passes over the tokens, 8 at a time:
//   the first computes the raw logits for the valid-position maxes, the
//   second recomputes them, exponentiates them into shared memory and
//   runs the token-by-token causal scan S += kf v^T, out = qf.S / qf.z.
//   Recomputing the logits costs 2*d*m flops per token per row, less
//   than storing (T, m) features per head in device memory would move.
//   c is shared by the Hg heads of a group and z by the tiles of a head,
//   so blocks read c (and, with several tiles, z) from snapshots copied
//   here before the launch; (h = 0, tile 0) writes c, tile 0 writes z.
#include "prf_common.cuh"

namespace prf {

constexpr int kSub = 8;                        // tokens featurized together

template <typename T>
__device__ void load_tokens(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, int t0, int ns, int d,
                            int dv, int j0, float* xs, float* vs) {
  for (int idx = threadIdx.x; idx < kSub * d; idx += blockDim.x) {
    const int t = idx / d, e = idx - t * d;
    const bool ok = t < ns;
    xs[idx] = ok ? to_f(q[(size_t)(t0 + t) * d + e]) : 0.f;
    xs[kSub * d + idx] = ok ? to_f(k[(size_t)(t0 + t) * d + e]) : 0.f;
  }
  if (vs != nullptr) {
    for (int idx = threadIdx.x; idx < kSub * kTileCols; idx += blockDim.x) {
      const int t = idx / kTileCols, jj = idx - t * kTileCols;
      vs[idx] = (t < ns && j0 + jj < dv)
                    ? to_f(v[(size_t)(t0 + t) * dv + j0 + jj])
                    : 0.f;
    }
  }
  __syncthreads();
}

template <typename T, int M>
__global__ void __launch_bounds__(kThreads) prf_fused_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ a, const float* __restrict__ mm,
    const int* __restrict__ valid_len, float* s, float* z,
    const float* z_old, float* c, const float* c_old, T* __restrict__ out,
    int G, int Hg, int L, int d, int r, int dv, int chunk, int stabilize,
    float eps, float inv_sqrt_m) {
  constexpr int MR = M / kRowGroups;           // rows of S per thread
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int tile = blockIdx.x, h = blockIdx.y, bg = blockIdx.z;
  const int b = bg / G, g = bg % G;
  const size_t head = (size_t)bg * Hg + h;
  float* xs = smem;                              // (2*kSub, d): q rows, k rows
  float* xt = xs + 2 * kSub * d;                 // (2*kSub, r)
  float* nrm = xt + 2 * kSub * r;                // (2*kSub) padded to 32
  float* feat = nrm + 32;                        // (2*kSub, M): q, k
  float* vs = feat + 2 * kSub * M;               // (kSub, kTileCols)
  float* scratch = vs + kSub * kTileCols;        // (32)

  const T* qh = q + head * L * d;
  const T* kg = k + (size_t)bg * L * d;
  const T* vg = v + (size_t)bg * L * dv;
  const float* ag = a + (size_t)g * d * M;
  const float* mg = mm != nullptr ? mm + (size_t)g * r * d : nullptr;
  const int vl = valid_len != nullptr ? valid_len[b] : L;

  const int rg = tid & (kRowGroups - 1);
  const int jj = tid / kRowGroups;
  const int j0 = tile * kTileCols;
  const int j = j0 + jj;
  const bool col = j < dv;
  float* sh = s + head * M * dv;
  float S[MR], Z[MR];
#pragma unroll
  for (int kk = 0; kk < MR; ++kk) {
    const int i = rg + kRowGroups * kk;
    S[kk] = col ? sh[(size_t)i * dv + j] : 0.f;
    Z[kk] = z_old[head * M + i];
  }
  float c_run = c_old[bg];

  for (int t0 = 0; t0 < L; t0 += chunk) {
    const int tl = min(chunk, L - t0);
    // pass 1: the maxes of the valid raw logits of this T-chunk
    float qm = kNeg, km = kNeg;
    if (stabilize) {
      for (int sb = 0; sb < tl; sb += kSub) {
        const int ns = min(kSub, tl - sb);
        load_tokens(qh, kg, vg, t0 + sb, ns, d, dv, j0, xs, nullptr);
        featurize<2 * kSub>(xs, 2 * kSub, ag, mg, d, r, M, xt, nrm, feat);
        for (int idx = tid; idx < ns * M; idx += blockDim.x) {
          if (t0 + sb + idx / M < vl) {
            qm = fmaxf(qm, feat[idx]);
            km = fmaxf(km, feat[kSub * M + idx]);
          }
        }
      }
      qm = block_max(qm, scratch);
      km = block_max(km, scratch);
    }
    float c_new, rho, qshift;
    if (stabilize) {
      c_new = fmaxf(c_run, km);
      rho = expf(c_run - c_new);
      qshift = qm;
    } else {
      c_new = 0.f;
      rho = expf(c_run);
      qshift = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < MR; ++kk) {
      S[kk] *= rho;
      Z[kk] *= rho;
    }
    // pass 2: features, then the causal scan token by token
    for (int sb = 0; sb < tl; sb += kSub) {
      const int ns = min(kSub, tl - sb);
      load_tokens(qh, kg, vg, t0 + sb, ns, d, dv, j0, xs, vs);
      featurize<2 * kSub>(xs, 2 * kSub, ag, mg, d, r, M, xt, nrm, feat);
      for (int idx = tid; idx < ns * M; idx += blockDim.x) {
        const bool valid = t0 + sb + idx / M < vl;
        feat[idx] = expf(feat[idx] - qshift) * inv_sqrt_m;
        const float kr = feat[kSub * M + idx];
        feat[kSub * M + idx] = valid ? expf(kr - c_new) * inv_sqrt_m : 0.f;
      }
      __syncthreads();
      for (int t = 0; t < ns; ++t) {
        const float* qf = feat + t * M;
        const float* kf = feat + (kSub + t) * M;
        const float vj = vs[t * kTileCols + jj];
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int kk = 0; kk < MR; ++kk) {
          const int i = rg + kRowGroups * kk;
          const float kfi = kf[i], qfi = qf[i];
          S[kk] += kfi * vj;
          Z[kk] += kfi;
          num += qfi * S[kk];
          den += qfi * Z[kk];
        }
        num = group_sum(num);
        den = group_sum(den);
        if (rg == 0 && col)
          out[(head * L + t0 + sb + t) * dv + j] = from_f<T>(num / (den + eps));
      }
      __syncthreads();                 // before the next tokens overwrite
    }
    c_run = c_new;
  }

#pragma unroll
  for (int kk = 0; kk < MR; ++kk) {
    const int i = rg + kRowGroups * kk;
    if (col) sh[(size_t)i * dv + j] = S[kk];
  }
  if (tile == 0) {
    __syncthreads();                   // every read of z_old (maybe z) done
    if (jj == 0) {
#pragma unroll
      for (int kk = 0; kk < MR; ++kk) z[head * M + rg + kRowGroups * kk] = Z[kk];
    }
    if (h == 0 && tid == 0) c[bg] = c_run;
  }
}

template <typename T, int M>
int launch(const void* q, const void* k, const void* v, const float* a,
           const float* m_mat, const int* valid_len, float* s, float* z,
           float* c, const float* z_old, const float* c_old, void* out, int B,
           int G, int Hg, int L, int d, int r, int dv, int chunk,
           int stabilize, float eps, float inv_sqrt_m, cudaStream_t st) {
  const dim3 grid((dv + kTileCols - 1) / kTileCols, Hg, B * G);
  const size_t shmem =
      sizeof(float) * (2 * kSub * d + 2 * kSub * r + 32 + 2 * kSub * M +
                       kSub * kTileCols + 32);
  auto kern = prf_fused_prefill_kernel<T, M>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)shmem);
  kern<<<grid, kThreads, shmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), a, m_mat, valid_len, s, z, z_old, c, c_old,
      static_cast<T*>(out), G, Hg, L, d, r, dv, chunk, stabilize, eps,
      inv_sqrt_m);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_m(int m, const void* q, const void* k, const void* v,
               const float* a, const float* m_mat, const int* valid_len,
               float* s, float* z, float* c, const float* z_old,
               const float* c_old, void* out, int B, int G, int Hg, int L,
               int d, int r, int dv, int chunk, int stabilize, float eps,
               float inv_sqrt_m, cudaStream_t st) {
#define PRF_PREFILL_CASE(MM)                                                  \
  case MM:                                                                    \
    return launch<T, MM>(q, k, v, a, m_mat, valid_len, s, z, c, z_old, c_old, \
                         out, B, G, Hg, L, d, r, dv, chunk, stabilize, eps,   \
                         inv_sqrt_m, st);
  switch (m) {
    PRF_PREFILL_CASE(16)
    PRF_PREFILL_CASE(32)
    PRF_PREFILL_CASE(64)
    PRF_PREFILL_CASE(128)
    PRF_PREFILL_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PRF_PREFILL_CASE
}

}  // namespace prf

extern "C" int prf_fused_prefill(const void* q, const void* k, const void* v,
                                 const float* a, const float* m_mat,
                                 const int* valid_len, float* s, float* z,
                                 float* c, float* z_old, float* c_old,
                                 void* out, int B, int G, int Hg, int L,
                                 int d, int r, int m, int dv, int chunk,
                                 int bf16_inputs, int stabilize, float eps,
                                 float inv_sqrt_m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemcpyAsync(c_old, c, sizeof(float) * B * G, cudaMemcpyDeviceToDevice,
                  st);
  if (z_old != z)
    cudaMemcpyAsync(z_old, z, sizeof(float) * B * G * Hg * m,
                    cudaMemcpyDeviceToDevice, st);
  if (bf16_inputs)
    return prf::dispatch_m<__nv_bfloat16>(
        m, q, k, v, a, m_mat, valid_len, s, z, c, z_old, c_old, out, B, G, Hg,
        L, d, r, dv, chunk, stabilize, eps, inv_sqrt_m, st);
  return prf::dispatch_m<float>(m, q, k, v, a, m_mat, valid_len, s, z, c,
                                z_old, c_old, out, B, G, Hg, L, d, r, dv,
                                chunk, stabilize, eps, inv_sqrt_m, st);
}
