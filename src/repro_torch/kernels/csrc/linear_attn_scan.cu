// Causal linear attention, from a zero state or from a carried one, for
// Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernels of repro/kernels/linear_attn_scan.py,
//   linear_attention_causal_fwd (body _kernel; C entry linear_attn_causal)
//   and linear_attention_causal_carry_fwd (body _kernel_carry; C entry
//   linear_attn_carry). Per query row n:
//     out_i = qf_i . S_i / (qf_i . z_i + eps),
//     S_i = S0 + sum_{j<=i} kf_j v_j^T,  z_i = z0 + sum_{j<=i} kf_j
//   with S0 = 0, z0 = 0 (causal) or the carried state (carry, which also
//   returns S_L, z_L), computed chunk-parallel: over chunks of kChunk keys
//   the state increments dS_c = K_c^T V_c (m x dv) and dz_c = sum K_c (m),
//   and inside a chunk
//     out = (Q S_in + tril(Q K^T) V) / (Q z_in + rowsum tril(Q K^T) + eps)
//   with S_in = S0 + sum of the earlier chunks' increments. kf and v are
//   read per KV row: query row n uses KV row n / h, so the Hg query heads
//   of a GQA group share one copy (no broadcast copy). The carried state
//   is per query row, as the serving pool holds it.
//
// What bounds it on the H100: the arithmetic for training. For smollm-135m
//   training (72 query rows of 512 tokens, m = 256, dv = 64) the function
//   needs 1.64 GFLOP in its token-serial form, 24 us at the 67 TFLOP/s of
//   f32 outside the tensor cores; its bytes (qf, kf, v read once, out
//   written once, 57 MB) take 17 us. A carried serving chunk of 8 rows x 32
//   tokens is bound by its bytes: the pool's S is read and written once
//   (2 x 4.7 MB) beside qf and kf (3.1 MB), 3.9 us.
//
// Design: two launches for causal, three for carry. chunk_state_kernel
//   computes each chunk's state increment, one block per (KV row, chunk,
//   64 x 64 tile of S), all in parallel (causal skips the last chunk, which
//   no later chunk reads; carry needs it for the final state and masks a
//   partial one). out_kernel runs one block per (query row, 64 query
//   positions): it forms the causal scores P = tril(Q K^T) against the
//   keys of its own chunk up to its last position (64-key tiles past it are
//   skipped) and keeps P in shared memory, then per 64-column tile of dv
//   sums Q S_in + P V. Every product is a 64 x 64 tile staged through
//   shared memory in slabs of 32, each thread holding a 4 x 4 block of the
//   tile in registers. final_state_kernel (carry) then writes S0 + sum dS
//   and z0 + sum dz, in place over S0, z0: it runs after out_kernel, so no
//   block still reads the carried state it overwrites.
#include "prf_common.cuh"

namespace las {

using prf::from_f;
using prf::to_f;

constexpr int kThreads = 256;
constexpr int kTile = 64;                  // query rows / output tile edge
constexpr int kChunk = 256;                // keys per chunk of the state
constexpr int kSlab = 32;                  // depth of one staged slab
constexpr int kPad = kTile + 1;            // staged row stride (no conflicts)
constexpr int kMicro = 4;                  // a thread's outputs per axis
constexpr int kGrid = kTile / kMicro;      // 16 x 16 threads

// acc[a][b] += sum_{k<K} A(ty + 16a, k) * B(k, tx + 16b), reading A and B
// through the functors (each returns 0 outside its own range) and staging
// them in shared memory (as, bs: kSlab * kPad floats each). AKFast /
// BKFast: consecutive k lie next to each other in memory, so the staging
// loop walks k fastest to read coalesced. Ends synchronised.
template <bool AKFast, bool BKFast, class FA, class FB>
__device__ __forceinline__ void gemm_tile(float (&acc)[kMicro][kMicro], int K,
                                          FA a_at, FB b_at, float* as,
                                          float* bs) {
  const int tx = threadIdx.x % kGrid, ty = threadIdx.x / kGrid;
  for (int k0 = 0; k0 < K; k0 += kSlab) {
    for (int idx = threadIdx.x; idx < kSlab * kTile; idx += kThreads) {
      const int kk = AKFast ? idx % kSlab : idx / kTile;
      const int i = AKFast ? idx / kSlab : idx % kTile;
      as[kk * kPad + i] = k0 + kk < K ? a_at(i, k0 + kk) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kSlab * kTile; idx += kThreads) {
      const int kk = BKFast ? idx % kSlab : idx / kTile;
      const int j = BKFast ? idx / kSlab : idx % kTile;
      bs[kk * kPad + j] = k0 + kk < K ? b_at(k0 + kk, j) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kSlab; ++kk) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r) a[r] = as[kk * kPad + ty + kGrid * r];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) b[c] = bs[kk * kPad + tx + kGrid * c];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) acc[r][c] += a[r] * b[c];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[kMicro][kMicro]) {
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int c = 0; c < kMicro; ++c) acc[r][c] = 0.f;
}

// dS[nk, c] = K_c^T V_c (m x dv) and dz[nk, c] = sum K_c (m) of the first
// gridDim.y chunks (a partial last chunk is masked). Grid: (m tiles * dv
// tiles, chunks, Nk).
template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(
    const float* __restrict__ kf, const T* __restrict__ v,
    float* __restrict__ ds, float* __restrict__ dz, int L, int m, int dv) {
  __shared__ float as[kSlab * kPad], bs[kSlab * kPad];
  const int ndv = (dv + kTile - 1) / kTile;
  const int i0 = (blockIdx.x / ndv) * kTile, j0 = (blockIdx.x % ndv) * kTile;
  const int c = blockIdx.y, nk = blockIdx.z, nc1 = gridDim.y;
  const int tlen = min(kChunk, L - c * kChunk);      // keys in this chunk
  const float* kc = kf + ((size_t)nk * L + (size_t)c * kChunk) * m;
  const T* vc = v + ((size_t)nk * L + (size_t)c * kChunk) * dv;
  float acc[kMicro][kMicro];
  zero(acc);
  gemm_tile<false, false>(
      acc, tlen,
      [&](int i, int t) { return i0 + i < m ? kc[(size_t)t * m + i0 + i] : 0.f; },
      [&](int t, int j) {
        return j0 + j < dv ? to_f(vc[(size_t)t * dv + j0 + j]) : 0.f;
      },
      as, bs);
  const int tx = threadIdx.x % kGrid, ty = threadIdx.x / kGrid;
  float* dsc = ds + ((size_t)nk * nc1 + c) * m * dv;
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int cc = 0; cc < kMicro; ++cc) {
      const int i = i0 + ty + kGrid * r, j = j0 + tx + kGrid * cc;
      if (i < m && j < dv) dsc[(size_t)i * dv + j] = acc[r][cc];
    }
  if (j0 == 0 && threadIdx.x < kTile && i0 + threadIdx.x < m) {
    const int i = i0 + threadIdx.x;
    float s = 0.f;
    for (int t = 0; t < tlen; ++t) s += kc[(size_t)t * m + i];
    dz[((size_t)nk * nc1 + c) * m + i] = s;
  }
}

// out for query positions [p0, p0 + kTile) of query row n, from the
// carried state (s0, z0) of row n or, when they are null, from zero. Grid:
// (ceil(L / kTile), N). Shared memory: P (kTile x kChunk), two staging
// slabs and the denominators.
template <typename T>
__global__ void __launch_bounds__(kThreads) out_kernel(
    const float* __restrict__ qf, const float* __restrict__ kf,
    const T* __restrict__ v, const float* __restrict__ s0,
    const float* __restrict__ z0, const float* __restrict__ ds,
    const float* __restrict__ dz, T* __restrict__ out, int L, int m, int dv,
    int h, int nc1, float eps) {
  extern __shared__ float smem[];
  float* ps = smem;                            // (kTile, kChunk)
  float* as = ps + kTile * kChunk;             // (kSlab, kPad)
  float* bs = as + kSlab * kPad;               // (kSlab, kPad)
  float* den = bs + kSlab * kPad;              // (kTile)
  const int tid = threadIdx.x;
  const int tx = tid % kGrid, ty = tid / kGrid;
  const int p0 = blockIdx.x * kTile, n = blockIdx.y, nk = n / h;
  const int c = p0 / kChunk, cs = c * kChunk;
  const int kend = min(p0 + kTile, L);         // keys [cs, kend)
  const int nkb = (kend - cs + kTile - 1) / kTile;
  const float* qn = qf + ((size_t)n * L + p0) * m;
  const float* kc = kf + ((size_t)nk * L + cs) * m;
  const T* vc = v + ((size_t)nk * L + cs) * dv;
  const float* dsn = ds + (size_t)nk * nc1 * m * dv;
  const float* dzn = dz + (size_t)nk * nc1 * m;
  const float* s0n = s0 == nullptr ? nullptr : s0 + (size_t)n * m * dv;
  const float* z0n = z0 == nullptr ? nullptr : z0 + (size_t)n * m;
  auto q_at = [&](int i, int k) {
    return p0 + i < L ? qn[(size_t)i * m + k] : 0.f;
  };

  // P = tril(Q K^T) over the chunk's keys up to this tile's last position
  float acc[kMicro][kMicro];
  for (int kb = 0; kb < nkb; ++kb) {
    zero(acc);
    gemm_tile<true, true>(
        acc, m, q_at,
        [&](int k, int j) {
          const int t = kb * kTile + j;
          return cs + t < kend ? kc[(size_t)t * m + k] : 0.f;
        },
        as, bs);
#pragma unroll
    for (int r = 0; r < kMicro; ++r)
#pragma unroll
      for (int cc = 0; cc < kMicro; ++cc) {
        const int i = ty + kGrid * r, t = kb * kTile + tx + kGrid * cc;
        const int key = cs + t;
        ps[i * kChunk + t] = key <= p0 + i && key < kend ? acc[r][cc] : 0.f;
      }
  }
  __syncthreads();

  // den_i = rowsum(P_i) + q_i . z_in, four neighbouring lanes per row
  {
    const int i = tid / 4, part = tid % 4;
    float s = 0.f;
    for (int t = part; t < nkb * kTile; t += 4) s += ps[i * kChunk + t];
    if ((c > 0 || z0n != nullptr) && p0 + i < L) {
      for (int k = part; k < m; k += 4) {
        float zin = z0n == nullptr ? 0.f : z0n[k];
        for (int cc = 0; cc < c; ++cc) zin += dzn[(size_t)cc * m + k];
        s += qn[(size_t)i * m + k] * zin;
      }
    }
    s = prf::group_sum(s);
    if (part == 0) den[i] = s;
  }
  __syncthreads();

  for (int j0 = 0; j0 < dv; j0 += kTile) {
    zero(acc);
    if (c > 0 || s0n != nullptr) {     // Q S_in, S_in = S0 + sum dS_{<c}
      gemm_tile<true, false>(
          acc, m, q_at,
          [&](int k, int j) {
            if (j0 + j >= dv) return 0.f;
            float s = s0n == nullptr ? 0.f : s0n[(size_t)k * dv + j0 + j];
            for (int cc = 0; cc < c; ++cc)
              s += dsn[((size_t)cc * m + k) * dv + j0 + j];
            return s;
          },
          as, bs);
    }
    gemm_tile<true, false>(                   // + P V
        acc, nkb * kTile, [&](int i, int t) { return ps[i * kChunk + t]; },
        [&](int t, int j) {
          return cs + t < kend && j0 + j < dv
                     ? to_f(vc[(size_t)t * dv + j0 + j])
                     : 0.f;
        },
        as, bs);
#pragma unroll
    for (int r = 0; r < kMicro; ++r)
#pragma unroll
      for (int cc = 0; cc < kMicro; ++cc) {
        const int i = ty + kGrid * r, j = j0 + tx + kGrid * cc;
        if (p0 + i < L && j < dv)
          out[((size_t)n * L + p0 + i) * dv + j] =
              from_f<T>(acc[r][cc] / (den[i] + eps));
      }
  }
}

// S0 += sum_c dS[nk, c] and z0 += sum_c dz[nk, c] over the nc chunks, in
// place, for query row n (KV row nk = n / h). Grid: (blocks, N).
__global__ void __launch_bounds__(kThreads) final_state_kernel(
    float* s0, float* z0, const float* __restrict__ ds,
    const float* __restrict__ dz, int m, int dv, int h, int nc) {
  const int n = blockIdx.y, nk = n / h;
  const size_t ms = (size_t)m * dv;
  float* sn = s0 + n * ms;
  float* zn = z0 + (size_t)n * m;
  const float* dsn = ds + (size_t)nk * nc * ms;
  const float* dzn = dz + (size_t)nk * nc * m;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < ms + m;
       e += (size_t)gridDim.x * kThreads) {
    if (e < ms) {
      float acc = sn[e];
      for (int c = 0; c < nc; ++c) acc += dsn[c * ms + e];
      sn[e] = acc;
    } else {
      const size_t i = e - ms;
      float acc = zn[i];
      for (int c = 0; c < nc; ++c) acc += dzn[(size_t)c * m + i];
      zn[i] = acc;
    }
  }
}

// Causal (s0 and z0 null) or carried (s0, z0 advanced in place) scan.
template <typename T>
int launch(const float* qf, const float* kf, const void* v, float* s0,
           float* z0, float* ds, float* dz, void* out, int N, int Nk, int L,
           int m, int dv, float eps, cudaStream_t st) {
  const int nc = (L + kChunk - 1) / kChunk;
  // increments needed: the earlier chunks' for the outputs, and the last
  // chunk's too for a carried final state
  const int ns = s0 != nullptr ? nc : nc - 1;
  const T* vt = static_cast<const T*>(v);
  if (ns > 0) {
    const dim3 grid(((m + kTile - 1) / kTile) * ((dv + kTile - 1) / kTile),
                    ns, Nk);
    chunk_state_kernel<T><<<grid, kThreads, 0, st>>>(kf, vt, ds, dz, L, m,
                                                     dv);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t shmem =
      sizeof(float) * (kTile * kChunk + 2 * kSlab * kPad + kTile);
  auto kern = out_kernel<T>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)shmem);
  const dim3 grid((L + kTile - 1) / kTile, N);
  kern<<<grid, kThreads, shmem, st>>>(qf, kf, vt, s0, z0, ds, dz,
                                      static_cast<T*>(out), L, m, dv, N / Nk,
                                      ns > 1 ? ns : 1, eps);
  if (s0 == nullptr) return (int)cudaGetLastError();
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t per_row = (size_t)m * dv + m;
  const dim3 fgrid((unsigned)((per_row + 4 * kThreads - 1) / (4 * kThreads)),
                   N);
  final_state_kernel<<<fgrid, kThreads, 0, st>>>(s0, z0, ds, dz, m, dv,
                                                 N / Nk, nc);
  return (int)cudaGetLastError();
}

}  // namespace las

// qf: (N, L, m) f32; kf: (Nk, L, m) f32; v: (Nk, L, dv) f32 or bf16;
// query row n reads KV row n / (N / Nk). ds: (Nk, max(nc - 1, 1), m, dv)
// and dz: (Nk, max(nc - 1, 1), m) f32 scratch; out: (N, L, dv) in v's type.
extern "C" int linear_attn_causal(const float* qf, const float* kf,
                                  const void* v, float* ds, float* dz,
                                  void* out, int N, int Nk, int L, int m,
                                  int dv, int bf16_v, float eps,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_v)
    return las::launch<__nv_bfloat16>(qf, kf, v, nullptr, nullptr, ds, dz,
                                      out, N, Nk, L, m, dv, eps, st);
  return las::launch<float>(qf, kf, v, nullptr, nullptr, ds, dz, out, N, Nk,
                            L, m, dv, eps, st);
}

// As linear_attn_causal, resumed from the carried state s0: (N, m, dv) and
// z0: (N, m) f32 of each query row, which end advanced over the L tokens
// (in place). ds: (Nk, nc, m, dv) and dz: (Nk, nc, m) f32 scratch.
extern "C" int linear_attn_carry(const float* qf, const float* kf,
                                 const void* v, float* s0, float* z0,
                                 float* ds, float* dz, void* out, int N,
                                 int Nk, int L, int m, int dv, int bf16_v,
                                 float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_v)
    return las::launch<__nv_bfloat16>(qf, kf, v, s0, z0, ds, dz, out, N, Nk,
                                      L, m, dv, eps, st);
  return las::launch<float>(qf, kf, v, s0, z0, ds, dz, out, N, Nk, L, m, dv,
                            eps, st);
}
