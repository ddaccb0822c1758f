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
//   at 8 slots (G=3, Hg=3, m=256, dv=64) that is 2 * 4.8 MB, 9.9 MB with
//   the inputs, 2.9 us at 3.35 TB/s, against 0.009 GFLOP of arithmetic
//   (features and state update), 0.13 us at the 67 TFLOP/s of f32. On the
//   main path each layer's S is cold: the 30 layers' pools (141 MB at 8
//   slots) pass through the 50 MB L2 every step.
//
// Design: two launches in stream order, no snapshot of the state.
//   1. features: a cluster of 4 blocks per (b, g), each over a quarter of
//      the m columns of A and a quarter of the rows of M, so no SM pulls
//      more than a quarter of the group's A (64 KB at smollm-135m) and the
//      k features are computed once per KV group, not once per head. A
//      block stages its columns of A and z and its rows of M in shared
//      memory by 16-byte cp.async, with the group's Hg q rows and its k
//      row; it sums x A (a thread a column and a share of d) and |M x|^2
//      (a warp a row of M), and the four blocks combine the rows' maxima
//      and norms through distributed shared memory. The cluster then owns
//      z and c: each block writes z' = rho z + kf for its columns of the
//      Hg heads in place, rank 0 writes c', being their only readers, and
//      leaves qf, kf and rho in a per-call scratch of B G ((Hg + 1) m + 1)
//      floats (0.1 MB at 8 slots). Its first act lets launch 2 start.
//   2. stream: one block per (b, g, h, 16 columns of dv): 288 blocks at 8
//      slots, several per SM. A thread holds 4 rows x 4 columns of S. The
//      block issues its S tile's 16-byte loads (and v) before it waits
//      for launch 1 (programmatic dependent launch), so the S stream
//      overlaps the features; then it reads the scratch and z' and writes
//      S' = rho S + kf v^T over the loaded tile, once, and sums num =
//      qf.S' per column and den = qf.z' by shuffles and over its 8 warps
//      in shared memory: out = num / (den + eps). Each block holds all m
//      rows of its columns, so no sum crosses blocks. The body is
//      prf::state_stream (prf_common.cuh), which B3 shares.
//   The host sets the shared-memory limit once per kernel and process.
#include <cooperative_groups.h>

#include "prf_common.cuh"

namespace cg = cooperative_groups;

namespace prf {
namespace decode {

constexpr int kCluster = 4;    // features blocks per (b, g): a cluster
constexpr int kRowTile = 4;    // rows summed at once (independent chains)
constexpr int kFeatThreads = 256;  // a features block
constexpr int kFeatWarps = kFeatThreads / 32;
constexpr int kCols = 16;      // dv columns per stream block
constexpr int kMaxSmem = 232448;   // a block's shared memory on Hopper

// Launch 1: features of one (b, g) by a cluster of kCluster blocks, each
// over M / kCluster columns of m and a share of the rows of M; z and c
// advanced in place.
template <typename T, int M>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kFeatThreads) features_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const float* __restrict__ a, const float* __restrict__ mm,
        float* __restrict__ z, float* __restrict__ c,
        float* __restrict__ feat, float* __restrict__ rho_out, int G,
        int Hg, int d, int r, int stabilize, float inv_sqrt_m) {
  constexpr int MC = M / kCluster;         // columns of m a block
  constexpr int EG = kFeatThreads / MC;    // shares of d a column's sum
  extern __shared__ __align__(16) float smem[];
  grid_dependents_launch();          // launch 2 reads S and v until it waits
  const int n = Hg + 1;                             // q rows, then the k row
  const int dp = (d + 3) / 4 * 4;                   // a row of x, padded
  const int cr = blockIdx.x;                        // rank in the cluster
  const int rb = mm != nullptr ? (r + kCluster - 1) / kCluster : 0;
  const int rr0 = min(r, cr * rb);
  const int nr = mm != nullptr ? min(r, rr0 + rb) - rr0 : 0;  // rows of M
  float* as = smem;                        // (d, MC) the block's A columns
  float* ms = as + d * MC;                 // (rb, d) the block's rows of M
  float* xs = ms + rb * d;                 // (n, dp) the rows
  float* part = xs + n * dp;               // (EG, n, MC) partial x A
  float* raw = part + EG * n * MC;         // (n, MC) x A
  float* zs = raw + n * MC;                // (Hg, MC) the heads' z
  float* wsq = zs + Hg * MC;               // (kFeatWarps, n) part of |Mx|^2
  float* red = wsq + kFeatWarps * n;       // (2, n) the block's max, |Mx|^2
  float* tot = red + 2 * n;                // (2, n) row max of the logits, nrm
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bg = blockIdx.y, g = bg % G, i0 = cr * MC;
  const float c_in = c[bg];

  // A's and z's columns i0 .. i0 + MC, the block's rows of M: cp.async
  const float* ag = a + (size_t)g * d * M + i0;
  for (int idx = tid; idx < d * (MC / 4); idx += kFeatThreads) {
    const int e = idx / (MC / 4), c4 = idx - e * (MC / 4);
    cp_async16(as + e * MC + 4 * c4, ag + (size_t)e * M + 4 * c4);
  }
  if (nr > 0) {
    const float* mg = mm + ((size_t)g * r + rr0) * d;
    for (int idx = tid; idx < nr * d / 4; idx += kFeatThreads)
      cp_async16(ms + 4 * idx, mg + 4 * idx);
  }
  const float* zg = z + (size_t)bg * Hg * M + i0;
  for (int idx = tid; idx < Hg * (MC / 4); idx += kFeatThreads) {
    const int h = idx / (MC / 4), c4 = idx - h * (MC / 4);
    cp_async16(zs + h * MC + 4 * c4, zg + (size_t)h * M + 4 * c4);
  }
  cp_async_commit();
#pragma unroll 4
  for (int idx = tid; idx < n * dp; idx += kFeatThreads) {
    const int t = idx / dp, e = idx - t * dp;
    float x = 0.f;
    if (e < d)
      x = to_f(t < Hg ? q[((size_t)bg * Hg + t) * d + e]
                      : k[(size_t)bg * d + e]);
    xs[idx] = x;
  }
  for (int idx = tid; idx < kFeatWarps * n; idx += kFeatThreads)
    wsq[idx] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // x A over the block's columns: a thread a column and every EG-th run
  // of 4 values of e, kRowTile rows at a time
  {
    const int eg = tid / MC, cc = tid - eg * MC;
    for (int t0 = 0; t0 < n; t0 += kRowTile) {
      float acc[kRowTile];
#pragma unroll
      for (int u = 0; u < kRowTile; ++u) acc[u] = 0.f;
      for (int e = 4 * eg; e < d; e += 4 * EG) {
        float av[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) av[w] = as[(e + w) * MC + cc];
#pragma unroll
        for (int u = 0; u < kRowTile; ++u) {
          const float4 xv = ld4(xs + min(t0 + u, n - 1) * dp + e);
          acc[u] += xv.x * av[0] + xv.y * av[1] + xv.z * av[2] +
                    xv.w * av[3];
        }
      }
#pragma unroll
      for (int u = 0; u < kRowTile; ++u)
        if (t0 + u < n) part[(eg * n + t0 + u) * MC + cc] = acc[u];
    }
  }
  // |M x|^2 over the block's rows of M (a warp a row, lanes along d), or
  // |x|^2 over the block's share of e for the isotropic kinds
  if (mm != nullptr) {
    for (int lr = warp; lr < nr; lr += kFeatWarps) {
      const float* mrow = ms + lr * d;
      for (int t0 = 0; t0 < n; t0 += kRowTile) {
        float pv[kRowTile];
#pragma unroll
        for (int u = 0; u < kRowTile; ++u) pv[u] = 0.f;
        for (int e = 4 * lane; e < d; e += 128) {
          const float4 mv = ld4(mrow + e);
#pragma unroll
          for (int u = 0; u < kRowTile; ++u) {
            const float4 xv = ld4(xs + min(t0 + u, n - 1) * dp + e);
            pv[u] += xv.x * mv.x + xv.y * mv.y + xv.z * mv.z + xv.w * mv.w;
          }
        }
#pragma unroll
        for (int u = 0; u < kRowTile; ++u) pv[u] = warp_sum(pv[u]);
        if (lane == 0) {
#pragma unroll
          for (int u = 0; u < kRowTile; ++u)
            if (t0 + u < n) wsq[warp * n + t0 + u] += pv[u] * pv[u];
        }
      }
    }
  } else {
    const int eb = (d + kCluster - 1) / kCluster;
    for (int t = warp; t < n; t += kFeatWarps) {
      float acc = 0.f;
      for (int e = cr * eb + lane; e < min(d, (cr + 1) * eb); e += 32)
        acc += xs[t * dp + e] * xs[t * dp + e];
      acc = warp_sum(acc);
      if (lane == 0) wsq[warp * n + t] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < n * MC; idx += kFeatThreads) {
    float acc = 0.f;
    for (int eg = 0; eg < EG; ++eg) acc += part[eg * n * MC + idx];
    raw[idx] = acc;
  }
  if (tid < n) {
    float sq = 0.f;
    for (int w = 0; w < kFeatWarps; ++w) sq += wsq[w * n + tid];
    red[n + tid] = sq;
  }
  __syncthreads();
  for (int t = warp; t < n; t += kFeatWarps) {   // the block's row maxima
    float mxv = kNeg;
    for (int cc = lane; cc < MC; cc += 32) mxv = fmaxf(mxv, raw[t * MC + cc]);
    for (int o = 16; o > 0; o >>= 1)
      mxv = fmaxf(mxv, __shfl_xor_sync(0xffffffffu, mxv, o));
    if (lane == 0) red[t] = mxv;
  }

  // over the cluster: each row's max over m and |M x|^2 / 2
  cluster_arrive();
  cluster_wait();
  if (tid < n) {
    cg::cluster_group cluster = cg::this_cluster();
    float mxv = kNeg, sq = 0.f;
    for (int rk = 0; rk < kCluster; ++rk) {
      const float* rr = cluster.map_shared_rank(red, rk);
      mxv = fmaxf(mxv, rr[tid]);
      sq += rr[n + tid];
    }
    tot[n + tid] = 0.5f * sq;
    tot[tid] = mxv - 0.5f * sq;     // the max over m of the row's logits
  }
  cluster_arrive();                 // the cluster's shared memory is read
  __syncthreads();

  const float* rmx = tot;
  const float* nrm = tot + n;
  float c_new, rho;
  if (stabilize) {
    c_new = fmaxf(c_in, rmx[Hg]);
    rho = expf(c_in - c_new);
  } else {
    c_new = 0.f;
    rho = expf(c_in);
  }
  // the features of the block's columns to the scratch, z' = rho z + kf
  // in place: an element (row t, column i0 + cc) a thread
  float* fb = feat + (size_t)bg * n * M + i0;
  for (int idx = tid; idx < n * MC; idx += kFeatThreads) {
    const int t = idx / MC, cc = idx - t * MC;
    const float kf =
        expf((raw[Hg * MC + cc] - nrm[Hg]) - c_new) * inv_sqrt_m;
    if (t == Hg) {
      fb[(size_t)t * M + cc] = kf;
    } else {
      fb[(size_t)t * M + cc] =
          expf((raw[idx] - nrm[t]) - (stabilize ? rmx[t] : 0.f)) *
          inv_sqrt_m;
      z[((size_t)bg * Hg + t) * M + i0 + cc] = zs[idx] * rho + kf;
    }
  }
  if (cr == 0 && tid == 0) {          // the cluster read c before arriving
    rho_out[bg] = rho;
    c[bg] = c_new;
  }
  cluster_wait();
}

// Launch 2: S' = rho S + kf v^T over all m rows of 16 columns of one
// (b, g, h), and out = qf.S' / (qf.z' + eps) for those columns
// (prf::state_stream over launch 1's features and z').
template <typename T, int M>
__global__ void __launch_bounds__(kThreads) stream_kernel(
    const T* __restrict__ v, const float* __restrict__ feat,
    const float* __restrict__ rho_in, const float* __restrict__ z,
    float* __restrict__ s, float* __restrict__ out, int Hg, int dv,
    float eps) {
  const int h = blockIdx.y, bg = blockIdx.z;
  const size_t head = (size_t)bg * Hg + h;
  const float* fb = feat + (size_t)bg * (Hg + 1) * M;
  state_stream<T, M, kCols, false>(
      v + (size_t)bg * dv, fb + (size_t)h * M, fb + (size_t)Hg * M,
      rho_in + bg, z + head * M, s + head * M * dv, out + head * dv,
      blockIdx.x * kCols, dv, eps);
}

template <typename T, int M>
int run(const void* q, const void* k, const void* v, const float* a,
        const float* m_mat, float* s, float* z, float* c, float* scratch,
        float* out, int B, int G, int Hg, int d, int r, int dv,
        int stabilize, float eps, float inv_sqrt_m, cudaStream_t st) {
  constexpr int MC = M / kCluster, EG = kFeatThreads / MC;
  const int n = Hg + 1;
  const int dp = (d + 3) / 4 * 4;
  const int rb = m_mat != nullptr ? (r + kCluster - 1) / kCluster : 0;
  const size_t sh1 =
      sizeof(float) * ((size_t)d * MC + (size_t)rb * d + (size_t)n * dp +
                       (size_t)(EG + 1) * n * MC + (size_t)Hg * MC +
                       (size_t)(kFeatWarps + 4) * n);
  if (sh1 > (size_t)kMaxSmem || d % 4) return (int)cudaErrorInvalidValue;
  static const bool limit_set = [] {  // once per kernel and process
    cudaFuncSetAttribute(features_kernel<T, M>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    return true;
  }();
  (void)limit_set;
  float* feat = scratch;
  float* rho = scratch + (size_t)B * G * n * M;
  features_kernel<T, M><<<dim3(kCluster, B * G), kFeatThreads, sh1, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), a, m_mat, z, c,
      feat, rho, G, Hg, d, r, stabilize, inv_sqrt_m);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_after(stream_kernel<T, M>,
                      dim3((dv + kCols - 1) / kCols, Hg, B * G), kThreads, 0,
                      st, static_cast<const T*>(v), (const float*)feat,
                      (const float*)rho, (const float*)z, s, out, Hg, dv,
                      eps);
}

template <typename T>
int dispatch_m(int m, const void* q, const void* k, const void* v,
               const float* a, const float* m_mat, float* s, float* z,
               float* c, float* scratch, float* out, int B, int G, int Hg,
               int d, int r, int dv, int stabilize, float eps,
               float inv_sqrt_m, cudaStream_t st) {
#define PRF_DECODE_CASE(MM)                                                  \
  case MM:                                                                   \
    return run<T, MM>(q, k, v, a, m_mat, s, z, c, scratch, out, B, G, Hg, d, \
                      r, dv, stabilize, eps, inv_sqrt_m, st);
  switch (m) {
    PRF_DECODE_CASE(16)
    PRF_DECODE_CASE(32)
    PRF_DECODE_CASE(64)
    PRF_DECODE_CASE(128)
    PRF_DECODE_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PRF_DECODE_CASE
}

}  // namespace decode
}  // namespace prf

// scratch: B G ((Hg + 1) m + 1) floats, 16-byte aligned: per (b, g) the
// features (qf of the Hg heads, then kf), then rho per (b, g). a, s and z
// 16-byte aligned, d and dv multiples of 4.
extern "C" int prf_fused_decode(const void* q, const void* k, const void* v,
                                const float* a, const float* m_mat, float* s,
                                float* z, float* c, float* scratch, float* out,
                                int B, int G, int Hg, int d, int r, int m,
                                int dv, int bf16_inputs, int stabilize,
                                float eps, float inv_sqrt_m, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_inputs)
    return prf::decode::dispatch_m<__nv_bfloat16>(
        m, q, k, v, a, m_mat, s, z, c, scratch, out, B, G, Hg, d, r, dv,
        stabilize, eps, inv_sqrt_m, st);
  return prf::decode::dispatch_m<float>(m, q, k, v, a, m_mat, s, z, c,
                                        scratch, out, B, G, Hg, d, r, dv,
                                        stabilize, eps, inv_sqrt_m, st);
}
