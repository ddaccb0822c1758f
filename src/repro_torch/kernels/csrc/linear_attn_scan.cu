// Causal linear attention, from a zero state (B5) or from a carried one
// (B4), for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernels of repro/kernels/linear_attn_scan.py,
//   linear_attention_causal_fwd (body _kernel; C entry linear_attn_causal)
//   and linear_attention_causal_carry_fwd (body _kernel_carry; C entry
//   linear_attn_carry). Per query row n:
//     out_i = qf_i . S_i / (qf_i . z_i + eps),
//     S_i = S0 + sum_{j<=i} kf_j v_j^T,  z_i = z0 + sum_{j<=i} kf_j
//   with S0 = 0, z0 = 0 (causal) or the carried state (carry, which also
//   returns S_L, z_L), computed chunk-parallel: over chunks of keys the
//   state increments dS_c = K_c^T V_c (m x dv) and dz_c = sum K_c (m),
//   and inside a chunk
//     out = (Q S_in + tril(Q K^T) V) / (Q z_in + rowsum tril(Q K^T) + eps)
//   with S_in = S0 + sum of the earlier chunks' increments. kf and v are
//   read per KV row: query row n uses KV row n / h, so the Hg query heads
//   of a GQA group share one copy (no broadcast copy). The carried state
//   is per query row, as the serving pool holds it.
//
// What bounds it on the H100. Training (B5; smollm-135m: 72 query rows of
//   512 tokens, m = 256, dv = 64): its bytes, qf, kf, v read once and out
//   written once (57 MB), 17 us at 3.35 TB/s; its operations (1.64 GFLOP
//   in the token-serial form) take 3.3 us at the 495 TFLOP/s of TF32 on
//   the tensor cores, 24 us at the 67 TFLOP/s of f32 outside them. A
//   carried serving chunk (B4) is bound by its bytes at every grant of
//   the packer once its products run on the tensor cores: at 8 rows x 32
//   tokens (72 query rows) the pool's S read and written once (2 x 4.7
//   MB) beside qf and kf (3.1 MB), 3.9 us; at 1 x 256 (9 rows, S 0.6 MB)
//   4.7 MB, 1.4 us (its operations take 0.36 us in TF32, 2.7 us at f32's
//   rate). The four grants (8 x 32, 4 x 64, 2 x 128, 1 x 256) each hold
//   2304 query positions and differ in how they split over the card; the
//   packer also makes smaller calls (3 x 64, 5 x 32 and others, PERF.md
//   section 5), which split the same way.
//
// B5's design: 64-key chunks, one prefix state per chunk, every product
//   on the tensor cores in 3xTF32 (mma.sync m16n8k8: each f32 operand
//   split into hi = TF32(x) and lo = TF32(x - hi), both rounded to
//   nearest, and lo hi + hi lo + hi hi summed in f32, so the result keeps
//   about f32's precision; a bf16 V is exact in TF32 and needs two
//   products). Three launches:
//   1a (chunk_delta_kernel) computes every chunk's increment dS_c, dz_c
//   at once, one block per (KV row, chunk, 32 features, 64 columns of
//   dv); 1b (prefix_scan_kernel) turns them in place into the exclusive
//   prefixes S_in[c], z_in[c], a thread per entry walking the chunks;
//   2 (causal_out_kernel) runs one block per (64 query positions, KV
//   row, up to 4 query heads of its group): Q, K_c, S_in[c] and z_in[c]
//   staged by cp.async in feature slabs of 32, a ring of three (K_c,
//   S_in[c] and z_in[c] once for the block's heads), the scores kept in
//   registers, masked there and fed to A V_c as the mma's A operand
//   without a trip through shared memory; a warp skips the key tiles past
//   its last query row. Every output block reads one prefix state; the
//   causal mask touches only its own 64 x 64 tile. 1b and 2 may start
//   while the launch before them finishes (programmatic dependent launch).
//
// B4's design: the same 3xTF32 products and cp.async staging over 32-key
//   chunks, with the carried state read once and written once, and the
//   stabilizer's rescale rho applied as S0 is read (one FMA, not a pass
//   over the pool). The state is per query row and only kf and v are
//   shared, so the outputs split over (query row, 32 query positions =
//   one chunk, 64 columns of dv): at each of smollm-135m's four grants
//   (every one holds 2304 query positions) 72 blocks of 8 warps, each
//   block the same size, none padded past its chunk. Three launches:
//   1 (carry_prefix_kernel) the inclusive prefixes of the chunk
//   increments per KV row, a block per 32 features and 64 columns, eight
//   chunks at a time side by side (one a warp) and summed in order in
//   shared memory;
//   2 (carry_out_kernel) the outputs: 2 row blocks x 4 column groups of
//   warps over 64-feature slabs, S_in = rho S0 + prefix[c - 1] formed as
//   the products read it, registers capped so that two blocks share a
//   SM (16 positions a block, 144 blocks, measured slower: PERF.md);
//   3 (carry_final_kernel) S_L = rho S0 + prefix[nc - 1] in place, after
//   launch 2 has read S0, at every L (S_L written by launch 2 where one
//   block owns the row measured no faster). 2 and 3 may start while the
//   launch before them finishes (programmatic dependent launch).
//   It stays far above its bound (PERF.md): with about one block a SM,
//   a block's eight warps are too few to hide the latency of their
//   staging and of each 3xTF32 chain (split, FMA, three mma in turn).
#include <cstdint>

#include "prf_common.cuh"
#include "tf32_mma.cuh"

namespace las {

using prf::cp_async_commit;
using prf::cp_async_wait;
using prf::to_f;
using tc::aligned16;
using tc::mma3;
using tc::split4;
using tc::stage;
using tc::store2;

// ---------------------------------------------------------------------------
// B5, causal from a zero state, on the tensor cores (3xTF32 mma.sync)
// ---------------------------------------------------------------------------

constexpr int kC = 64;          // keys per chunk = query rows per output tile
constexpr int kMs = 32;         // feature columns per staged slab
constexpr int kDf = 32;         // features per launch-1a block
constexpr int kDs = kDf + 4;    // stride of launch 1a's K tile [key][feature]
constexpr int kDvT = 64;        // dv columns per output pass / state tile
constexpr int kRs = kMs + 4;    // stride of a [row][feature] slab (Q, K)
constexpr int kSs = kDvT + 8;   // stride of an S_in slab [feature][dv]
constexpr int kWarpsPerHead = kC / 16;

// V tile [key][dv] stride: read with two keys a thread (k-index t is key
// 2t, t + 4 is key 2t + 1), conflict-free for f32 at 68, bf16 at 72
template <typename T>
constexpr int kVs = sizeof(T) == 4 ? kDvT + 4 : kDvT + 8;

// Launch 1a. dS_c = K_c^T V_c (a kDf x kDvT tile of it) and, in the
// blocks of the first dv tile, dz_c = sum K_c (kDf features), for every
// chunk c < nc - 1 at once, into slot c of s_in (Nk, nc - 1, m, dv) and
// z_in (Nk, nc - 1, m). Grid: (feature slabs * dv tiles, nc - 1, Nk); 128
// threads, warp w owning features 16 (w % 2) .. + 16 and dv columns
// 32 (w / 2) .. + 32.
template <typename T>
__global__ void __launch_bounds__(128) chunk_delta_kernel(
    const float* __restrict__ kf, const T* __restrict__ v,
    float* __restrict__ s_in, float* __restrict__ z_in, int L, int m,
    int dv) {
  constexpr int kV = kVs<T>;
  __shared__ __align__(16) float ks[kC * kDs];
  __shared__ __align__(16) T vs[kC * kV];
  const int ndv = (dv + kDvT - 1) / kDvT;
  const int i0 = (blockIdx.x / ndv) * kDf, j0 = (blockIdx.x % ndv) * kDvT;
  const int c = blockIdx.y, nk = blockIdx.z, nc1 = gridDim.y;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int r0 = 16 * (warp & 1), n0 = 32 * (warp >> 1);
  stage<kC, kDf, 128>(ks, kDs, kf + ((size_t)nk * L + c * kC) * m, m, 0, kC,
                      i0, m, aligned16(kf, m * 4));
  stage<kC, kDvT, 128>(vs, kV, v + ((size_t)nk * L + c * kC) * dv, dv, 0, kC,
                       j0, dv, aligned16(v, dv * sizeof(T)));
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  prf::grid_dependents_launch();
  float acc[4][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < kC; k0 += 8) {
    // A = K_c^T (features x keys), k-index t -> key 2t, t + 4 -> 2t + 1
    const float* a0 = ks + (k0 + 2 * t) * kDs + r0 + g;
    const float a[4] = {a0[0], a0[8], a0[kDs], a0[kDs + 8]};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
    const T* b = vs + (k0 + 2 * t) * kV + n0 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma3<sizeof(T) == 2>(acc[j], ah, al, to_f(b[8 * j]),
                           to_f(b[kV + 8 * j]));
  }
  float* so = s_in + ((size_t)nk * nc1 + c) * m * dv;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int i = i0 + r0 + g + 4 * e;
      if (i < m)
        store2(so + (size_t)i * dv, j0 + n0 + 8 * j + 2 * t, dv, acc[j][e],
               acc[j][e + 1]);
    }
  if (j0 == 0) {
    // column sums of the slab: 4 lanes a column, 16 keys each
    const int col = threadIdx.x >> 2;
    float zs = 0.f;
#pragma unroll
    for (int key = t; key < kC; key += 4) zs += ks[key * kDs + col];
    zs = prf::group_sum(zs);
    if (t == 0 && i0 + col < m)
      z_in[((size_t)nk * nc1 + c) * m + i0 + col] = zs;
  }
}

// Launch 1b. The increments of launch 1a turned, in place, into the
// prefixes the outputs read: slot c - 1 of s_in and z_in becomes S_in[c]
// = sum_{c' < c} dS_c' and z_in[c], one thread per entry of a KV row's
// (S, z) walking the nc - 1 slots. Grid: (ceil((m dv + m) / 256), Nk).
__global__ void __launch_bounds__(256) prefix_scan_kernel(
    float* __restrict__ s_in, float* __restrict__ z_in, int m, int dv,
    int nc1) {
  prf::grid_dependency_wait();
  prf::grid_dependents_launch();
  const size_t ms = (size_t)m * dv;
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= ms + m) return;
  float* p = e < ms ? s_in + (size_t)blockIdx.y * nc1 * ms + e
                    : z_in + (size_t)blockIdx.y * nc1 * m + (e - ms);
  const size_t step = e < ms ? ms : m;
  float acc = 0.f;
  for (int c0 = 0; c0 < nc1; c0 += 8, p += 8 * step) {
    float x[8];                       // eight slots' loads in flight at once
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = c0 + i < nc1 ? p[i * step] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c0 + i < nc1) p[i * step] = acc += x[i];
  }
}

// Launch 2. out for the 64 query positions p0 = 64 c .. of HB query heads
// of one KV group: per head (4 warps, 16 rows each)
//   A = tril(Q_c K_c^T),  den = rowsum(A) + Q_c z_in[c],
//   out = (Q_c S_in[c] + A V_c) / (den + eps)
// over feature slabs of kMs, a ring of kOutStages<HB> slabs staged by
// cp.async, K_c, S_in[c] and z_in[c] once for the HB heads. A stays in
// registers and feeds A V_c as the mma's A operand directly (its keys
// taken in the order the accumulator holds them); a warp skips the key
// tiles past its last query row, and the heads of a block rotate their
// row blocks over the warps so that each SM sub-partition gets a share
// of the short and the long rows. dv > 64 takes further passes of kDvT
// columns, each restaging Q_c and S_in[c]. Grid: (ceil(L / 64), Nk *
// ceil(h / HB)).
template <int HB>
constexpr int kOutStages = HB == 1 ? 2 : 3;
template <int HB>
constexpr int kOutStage = (HB + 1) * kC * kRs + kMs * kSs + kMs;
template <typename T, int HB>
constexpr size_t kOutSmem =
    sizeof(float) * kOutStages<HB> * kOutStage<HB> + sizeof(T) * kC * kVs<T>;

template <typename T, int HB>
__global__ void __launch_bounds__(128 * HB) causal_out_kernel(
    const float* __restrict__ qf, const float* __restrict__ kf,
    const T* __restrict__ v, const float* __restrict__ s_in,
    const float* __restrict__ z_in, T* __restrict__ out, int L, int m, int dv,
    int h, float eps) {
  constexpr int NT = 128 * HB, kV = kVs<T>, kQ = kC * kRs;
  constexpr int kStages = kOutStages<HB>, kStage = kOutStage<HB>;
  extern __shared__ __align__(16) float smem[];
  T* vs = reinterpret_cast<T*>(smem + kStages * kStage);
  const int c = blockIdx.x, p0 = c * kC, nc1 = (L + kC - 1) / kC - 1;
  const int nhb = (h + HB - 1) / HB;
  const int nk = blockIdx.y / nhb, hb = blockIdx.y % nhb;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int hs = warp / kWarpsPerHead;
  const int rb = 16 * ((warp + hs) % kWarpsPerHead);
  const int jmax = rb / 8 + 2;        // key tiles up to the warp's last row
  const int nheads = min(HB, h - hb * HB);
  const bool active = hs < nheads;
  const int n = nk * h + hb * HB + hs;
  const float* qc = qf + ((size_t)(nk * h + hb * HB) * L + p0) * m;
  const float* kc = kf + ((size_t)nk * L + p0) * m;
  const T* vc = v + ((size_t)nk * L + p0) * dv;
  const size_t slot = c > 0 ? (size_t)nk * nc1 + c - 1 : 0;
  const float* sc = s_in + slot * m * dv;
  const float* zc = z_in + slot * m;
  const int rows = min(kC, L - p0);
  const bool vec_q = aligned16(qf, m * 4), vec_k = aligned16(kf, m * 4),
             vec_s = aligned16(s_in, dv * 4), vec_z = aligned16(z_in, m * 4),
             vec_v = aligned16(v, dv * sizeof(T));
  const int nms = (m + kMs - 1) / kMs;

  float acc_a[8][4] = {}, den[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < dv; j0 += kDvT) {
    const bool first = j0 == 0;
    stage<kC, kDvT, NT>(vs, kV, vc, dv, 0, rows, j0, dv, vec_v);
    cp_async_commit();
    auto issue = [&](int s) {
      float* st = smem + (s % kStages) * kStage;
      const int f0 = s * kMs;
      for (int hh = 0; hh < nheads; ++hh)
        stage<kC, kMs, NT>(st + hh * kQ, kRs, qc + (size_t)hh * L * m, m, 0,
                           rows, f0, m, vec_q);
      if (first)
        stage<kC, kMs, NT>(st + HB * kQ, kRs, kc, m, 0, rows, f0, m, vec_k);
      if (c > 0) {
        stage<kMs, kDvT, NT>(st + (HB + 1) * kQ, kSs, sc, dv, f0, m, j0, dv,
                             vec_s);
        if (first)
          stage<1, kMs, NT>(st + (HB + 1) * kQ + kMs * kSs, kMs, zc, m, 0, 1,
                            f0, m, vec_z);
      }
    };
    float acc_n[8][4] = {}, qz[2] = {0.f, 0.f};
    if (first || c > 0) {
      if (first) prf::grid_dependency_wait();   // s_in, z_in of launch 1b
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nms) issue(s);
        cp_async_commit();
      }
      for (int s = 0; s < nms; ++s) {
        cp_async_wait<kStages - 2>();
        __syncthreads();              // slab s landed; s - 1 fully read
        if (s + kStages - 1 < nms) issue(s + kStages - 1);
        cp_async_commit();
        if (!active) continue;
        const float* st = smem + (s % kStages) * kStage;
        const float* qs = st + hs * kQ + (rb + g) * kRs + t;
        const float* ks = st + HB * kQ + g * kRs + t;
        const float* ss = st + (HB + 1) * kQ + t * kSs + g;
        const float* zs = st + (HB + 1) * kQ + kMs * kSs + t;
#pragma unroll
        for (int k0 = 0; k0 < kMs; k0 += 8) {
          const float a[4] = {qs[k0], qs[8 * kRs + k0], qs[k0 + 4],
                              qs[8 * kRs + k0 + 4]};
          uint32_t ah[4], al[4];
          split4(a, ah, al);
          if (first) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (j < jmax)
                mma3<false>(acc_a[j], ah, al, ks[8 * j * kRs + k0],
                            ks[8 * j * kRs + k0 + 4]);
            if (c > 0) {
              qz[0] += a[0] * zs[k0] + a[2] * zs[k0 + 4];
              qz[1] += a[1] * zs[k0] + a[3] * zs[k0 + 4];
            }
          }
          if (c > 0) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              mma3<false>(acc_n[j], ah, al, ss[k0 * kSs + 8 * j],
                          ss[(k0 + 4) * kSs + 8 * j]);
          }
        }
      }
    }
    if (first && active) {
      // causal mask (key <= query within the chunk), then the row sums
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = rb + g + 8 * (e >> 1), key = 8 * j + 2 * t + (e & 1);
          if (key > qi) acc_a[j][e] = 0.f;
          rs[e >> 1] += acc_a[j][e];
        }
      den[0] = prf::group_sum(rs[0] + qz[0]) + eps;
      den[1] = prf::group_sum(rs[1] + qz[1]) + eps;
    }
    cp_async_wait<0>();
    __syncthreads();                  // V_c landed
    if (active) {
      // + A V_c: the accumulator's entries (g, 2t), (g, 2t + 1), (g + 8,
      // 2t), (g + 8, 2t + 1) of key tile j are the A operand with k-index
      // t -> key 2t and t + 4 -> key 2t + 1
      const T* b = vs + 2 * t * kV + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= jmax) break;
        const float a[4] = {acc_a[j][0], acc_a[j][2], acc_a[j][1],
                            acc_a[j][3]};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
          mma3<sizeof(T) == 2>(acc_n[jn], ah, al,
                               to_f(b[8 * j * kV + 8 * jn]),
                               to_f(b[(8 * j + 1) * kV + 8 * jn]));
      }
      T* on = out + ((size_t)n * L + p0) * dv;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int qi = rb + g + 4 * e;
          if (qi < rows)
            store2(on + (size_t)qi * dv, j0 + 8 * jn + 2 * t, dv,
                   acc_n[jn][e] / den[e >> 1],
                   acc_n[jn][e + 1] / den[e >> 1]);
        }
    }
    __syncthreads();                  // V and the slabs are free again
  }
}

// Launch 2; after launch 1b (nc > 1) it may start while 1b finishes, and
// then reads qf, kf and v before it waits: launch 1a, before 1b, started
// only when the kernels that wrote them had finished.
template <typename T, int HB>
int launch_out(const float* qf, const float* kf, const T* v,
               const float* s_in, const float* z_in, T* out, int N, int Nk,
               int L, int m, int dv, float eps, cudaStream_t st) {
  constexpr size_t shmem = kOutSmem<T, HB>;
  const cudaError_t attr = cudaFuncSetAttribute(
      causal_out_kernel<T, HB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (attr != cudaSuccess) return (int)attr;
  const int h = N / Nk;
  const dim3 grid((L + kC - 1) / kC, Nk * ((h + HB - 1) / HB));
  if (L > kC)
    return prf::launch_after(causal_out_kernel<T, HB>, grid, 128 * HB,
                             shmem, st, qf, kf, v, s_in, z_in, out, L, m, dv,
                             h, eps);
  causal_out_kernel<T, HB><<<grid, 128 * HB, shmem, st>>>(
      qf, kf, v, s_in, z_in, out, L, m, dv, h, eps);
  return (int)cudaGetLastError();
}

// B5: launches 1a and 1b (when there is more than one chunk), then launch
// 2 with the query heads of a KV group split evenly over blocks of at
// most 4 heads (8 heads: 4 + 4; 5: 3 + 2). 1b and 2 may start while the
// launch before them finishes (programmatic dependent launch).
template <typename T>
int launch_causal(const float* qf, const float* kf, const void* v,
                  float* s_in, float* z_in, void* out, int N, int Nk, int L,
                  int m, int dv, float eps, cudaStream_t st) {
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const int nc1 = (L + kC - 1) / kC - 1;
  if (nc1 > 0) {
    const dim3 grid(((m + kDf - 1) / kDf) * ((dv + kDvT - 1) / kDvT), nc1,
                    Nk);
    chunk_delta_kernel<T><<<grid, 128, 0, st>>>(kf, vt, s_in, z_in, L, m,
                                                dv);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t per_row = (size_t)m * dv + m;
    err = (cudaError_t)prf::launch_after(
        prefix_scan_kernel, dim3((unsigned)((per_row + 255) / 256), Nk), 256,
        0, st, s_in, z_in, m, dv, nc1);
    if (err != cudaSuccess) return (int)err;
  }
  const int h = N / Nk, blocks = (h + 3) / 4;
  switch ((h + blocks - 1) / blocks) {
    case 1:
      return launch_out<T, 1>(qf, kf, vt, s_in, z_in, ot, N, Nk, L, m, dv,
                              eps, st);
    case 2:
      return launch_out<T, 2>(qf, kf, vt, s_in, z_in, ot, N, Nk, L, m, dv,
                              eps, st);
    case 3:
      return launch_out<T, 3>(qf, kf, vt, s_in, z_in, ot, N, Nk, L, m, dv,
                              eps, st);
    default:
      return launch_out<T, 4>(qf, kf, vt, s_in, z_in, ot, N, Nk, L, m, dv,
                              eps, st);
  }
}

// ---------------------------------------------------------------------------
// B4, resumed from a carried state, on the same tensor-core machinery
// ---------------------------------------------------------------------------

constexpr int kCc = 32;             // keys per B4 chunk
constexpr int kAs = kCc + 4;        // stride of the scores tile A [row][key]
constexpr int kCarryStages = 2;     // launch 2's ring of feature slabs
constexpr int kCms = 64;            // features a launch-2 slab holds
constexpr int kCrs = kCms + 4;      // its [row][feature] stride (Q, K)

// s[i] = r s[i] + p[i] for i < count, on thread i0 of `stride` threads (in
// 16-byte pieces when both arrays allow them)
__device__ __forceinline__ void advance(float* s, const float* __restrict__ p,
                                        int count, float r, int i0,
                                        int stride) {
  if (aligned16(s, (size_t)count * 4) && aligned16(p, 0)) {
    float4* s4 = reinterpret_cast<float4*>(s);
    for (int i = i0; i < count / 4; i += stride) {
      float4 a = s4[i];
      const float4 b = prf::ld4(p + 4 * i);
      a.x = fmaf(r, a.x, b.x);
      a.y = fmaf(r, a.y, b.y);
      a.z = fmaf(r, a.z, b.z);
      a.w = fmaf(r, a.w, b.w);
      s4[i] = a;
    }
  } else {
    for (int i = i0; i < count; i += stride) s[i] = fmaf(r, s[i], p[i]);
  }
}

// Launch 1. The inclusive prefixes of the chunk increments of every KV
// row: slot c of pfx (Nk, nc, m, dv) and pz (Nk, nc, m) holds
// sum_{c' <= c} K_c'^T V_c' and sum_{c' <= c} sum K_c' (a kDf x kDvT tile
// of it). The chunks go in groups of eight, one a warp, so no chain of
// products runs through them: K and V of the group staged at once, each
// warp forms its chunk's increment and dz, the increments meet in shared
// memory, and each thread adds its entries over the group's chunks in
// order (carrying the sum from the group before) and writes every slot.
// Grid: (feature slabs * dv tiles, Nk); 256 threads.
constexpr int kPrefixChunks = 8;
constexpr int kPrefixSlot = kDf * kSs + kDf;    // an increment in shared memory
template <typename T>
constexpr size_t kPrefixStaged = sizeof(float) * kPrefixChunks * kCc * kDs +
                                 sizeof(T) * kPrefixChunks * kCc * kVs<T>;
template <typename T>
constexpr size_t kPrefixSmem =
    kPrefixStaged<T> > sizeof(float) * kPrefixChunks * kPrefixSlot
        ? kPrefixStaged<T>
        : sizeof(float) * kPrefixChunks * kPrefixSlot;

template <typename T>
__global__ void __launch_bounds__(256) carry_prefix_kernel(
    const float* __restrict__ kf, const T* __restrict__ v,
    float* __restrict__ pfx, float* __restrict__ pz, int L, int m, int dv) {
  constexpr int kV = kVs<T>, kG = kPrefixChunks;
  constexpr int kPer = kDf * kDvT / 256;            // entries a thread scans
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                                 // (kG kCc, kDs)
  T* vs = reinterpret_cast<T*>(smem + kG * kCc * kDs);   // (kG kCc, kV)
  prf::grid_dependents_launch();      // launch 2 reads pfx after its wait
  const int ndv = (dv + kDvT - 1) / kDvT;
  const int i0 = (blockIdx.x / ndv) * kDf, j0 = (blockIdx.x % ndv) * kDvT;
  const int nk = blockIdx.y, nc = (L + kCc - 1) / kCc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31,
            g = lane >> 2, t = lane & 3;
  const float* kn = kf + (size_t)nk * L * m;
  const T* vn = v + (size_t)nk * L * dv;
  const bool vec_k = aligned16(kf, m * 4),
             vec_v = aligned16(v, dv * sizeof(T));
  float run[kPer] = {}, run_z = 0.f;
  for (int cb = 0; cb < nc; cb += kG) {
    for (int w = 0; w < kG && cb + w < nc; ++w) {
      const int k0 = (cb + w) * kCc;
      stage<kCc, kDf, 256>(ks + w * kCc * kDs, kDs, kn, m, k0, L, i0, m,
                           vec_k);
      stage<kCc, kDvT, 256>(vs + w * kCc * kV, kV, vn, dv, k0, L, j0, dv,
                            vec_v);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const bool mine = cb + warp < nc;
    float acc[2][8][4] = {}, zs = 0.f;
    if (mine) {
      const float* kb = ks + warp * kCc * kDs;
      const T* vb = vs + warp * kCc * kV;
#pragma unroll
      for (int k0 = 0; k0 < kCc; k0 += 8) {
        // A = K_c^T (features x keys), k-index t -> key 2t, t + 4 -> 2t + 1
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* a0 = kb + (k0 + 2 * t) * kDs + 16 * mt + g;
          const float a[4] = {a0[0], a0[8], a0[kDs], a0[kDs + 8]};
          split4(a, ah[mt], al[mt]);
        }
        const T* b = vb + (k0 + 2 * t) * kV + g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float b0 = to_f(b[8 * j]), b1 = to_f(b[kV + 8 * j]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma3<sizeof(T) == 2>(acc[mt][j], ah[mt], al[mt], b0, b1);
        }
      }
      if (j0 == 0)
#pragma unroll 8
        for (int key = 0; key < kCc; ++key) zs += kb[key * kDs + lane];
    }
    __syncthreads();                  // K, V read: the area takes dS
    if (mine) {
      float* dw = smem + warp * kPrefixSlot;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dw[(16 * mt + g + 8 * (e >> 1)) * kSs + 8 * j + 2 * t + (e & 1)] =
                acc[mt][j][e];
      dw[kDf * kSs + lane] = zs;
    }
    __syncthreads();
    for (int w = 0; w < kG && cb + w < nc; ++w) {
      const float* dw = smem + w * kPrefixSlot;
      const size_t slot = (size_t)nk * nc + cb + w;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = threadIdx.x + 256 * i, row = e / kDvT, col = e % kDvT;
        run[i] += dw[row * kSs + col];
        if (i0 + row < m && j0 + col < dv)
          pfx[(slot * m + i0 + row) * dv + j0 + col] = run[i];
      }
      if (j0 == 0 && threadIdx.x < kDf) {
        run_z += dw[kDf * kSs + threadIdx.x];
        if (i0 + threadIdx.x < m) pz[slot * m + i0 + threadIdx.x] = run_z;
      }
    }
    __syncthreads();                  // the area is free for the next group
  }
}

// Launch 2. out for the kCc query positions p0 .. of query row n (its
// chunk c = p0 / kCc), dv columns j0 .. + 64:
//   A = tril(Q K_c^T),  S_in = rho S0 + pfx[c - 1],  z_in likewise,
//   out = (Q S_in + A V_c) / (rowsum(A) + Q z_in + eps)
// over feature slabs of kCms, a ring of kCarryStages staged by cp.async
// (Q, K_c, S0, z0 and, past the first chunk, launch 1's prefix); rho
// scales S0 and z0 as the slab is read. Eight warps: 2 row blocks x 4
// column groups. Warp (rb, cg) forms A's key tile cg (8 keys) for its 16
// rows and the outputs' columns 16 cg .. + 16 from S_in, A meets in
// shared memory, and the warp adds A V_c for its columns over the key
// tiles up to its last row. Grid: (nc * dv tiles, N).
constexpr int kCarryStage = 2 * kCc * kCrs + 2 * kCms * kSs + 2 * kCms;
template <typename T>
constexpr size_t kCarrySmem =
    sizeof(float) * (kCarryStages * kCarryStage + kCc * kAs) +
    sizeof(T) * kCc * kVs<T>;

template <typename T>
__global__ void __launch_bounds__(256, 2) carry_out_kernel(
    const float* __restrict__ qf, const float* __restrict__ kf,
    const T* __restrict__ v, const float* __restrict__ s0,
    const float* __restrict__ z0, const float* __restrict__ rho,
    const float* __restrict__ pfx, const float* __restrict__ pz,
    T* __restrict__ out, int L, int m, int dv, int h, float eps) {
  constexpr int NT = 256, kV = kVs<T>;
  extern __shared__ __align__(16) float smem[];
  float* as = smem + kCarryStages * kCarryStage;     // A, (kCc, kAs)
  T* vs = reinterpret_cast<T*>(as + kCc * kAs);      // V_c, (kCc, kV)
  const int ndv = (dv + kDvT - 1) / kDvT, nc = (L + kCc - 1) / kCc;
  const int c = blockIdx.x / ndv, j0 = (blockIdx.x % ndv) * kDvT;
  const int p0 = c * kCc, kend = min(L, p0 + kCc);
  const int n = blockIdx.y, nk = n / h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31,
            g = lane >> 2, t = lane & 3;
  const int rb = 16 * (warp >> 2), cg = warp & 3;
  const int last = rb + 15;             // the warp's last row, as a key of c
  const bool a_tile = 8 * cg <= last;   // its key tile of A is not all masked
  const bool has_p = c > 0;
  const float r = rho == nullptr ? 1.f : rho[n];
  const float* qn = qf + (size_t)n * L * m;
  const float* kn = kf + (size_t)nk * L * m;
  const T* vn = v + (size_t)nk * L * dv;
  const float* sn = s0 + (size_t)n * m * dv;
  const float* zn = z0 + (size_t)n * m;
  const size_t slot = (size_t)nk * nc + (has_p ? c - 1 : 0);
  const float* pc = pfx + slot * m * dv;
  const float* pzc = pz + slot * m;
  const bool vec_q = aligned16(qf, m * 4), vec_k = aligned16(kf, m * 4),
             vec_s = aligned16(s0, dv * 4), vec_p = aligned16(pfx, dv * 4),
             vec_z = aligned16(z0, m * 4), vec_pz = aligned16(pz, m * 4),
             vec_v = aligned16(v, dv * sizeof(T));
  const int nms = (m + kCms - 1) / kCms;

  if (has_p) prf::grid_dependency_wait();           // pfx, pz of launch 1
  stage<kCc, kDvT, NT>(vs, kV, vn, dv, p0, kend, j0, dv, vec_v);
  cp_async_commit();
  auto issue = [&](int s) {
    float* st = smem + (s % kCarryStages) * kCarryStage;
    float* sb = st + 2 * kCc * kCrs;
    const int f0 = s * kCms;
    stage<kCc, kCms, NT>(st, kCrs, qn, m, p0, kend, f0, m, vec_q);
    stage<kCc, kCms, NT>(st + kCc * kCrs, kCrs, kn, m, p0, kend, f0, m,
                         vec_k);
    stage<kCms, kDvT, NT>(sb, kSs, sn, dv, f0, m, j0, dv, vec_s);
    stage<1, kCms, NT>(sb + 2 * kCms * kSs, kCms, zn, m, 0, 1, f0, m, vec_z);
    if (has_p) {
      stage<kCms, kDvT, NT>(sb + kCms * kSs, kSs, pc, dv, f0, m, j0, dv, vec_p);
      stage<1, kCms, NT>(sb + 2 * kCms * kSs + kCms, kCms, pzc, m, 0, 1, f0, m,
                        vec_pz);
    }
  };
#pragma unroll
  for (int s = 0; s < kCarryStages - 1; ++s) {
    if (s < nms) issue(s);
    cp_async_commit();
  }
  // the warp's sums: A's tile, the outputs' and the denominators' Q z_in
  float acc_a[4] = {}, acc_n[2][4] = {}, qz[2] = {0.f, 0.f};
  for (int s = 0; s < nms; ++s) {
    cp_async_wait<kCarryStages - 2>();
    __syncthreads();                  // slab s landed; s - 1 fully read
    if (s + kCarryStages - 1 < nms) issue(s + kCarryStages - 1);
    cp_async_commit();
    const float* st = smem + (s % kCarryStages) * kCarryStage;
    const float* qs = st + (rb + g) * kCrs + t;
    const float* ks = st + (kCc + 8 * cg + g) * kCrs + t;
    const float* ss = st + 2 * kCc * kCrs + t * kSs + 16 * cg + g;
    const float* ps = ss + kCms * kSs;
    const float* zs = st + 2 * kCc * kCrs + 2 * kCms * kSs + t;
    const float* pzs = zs + kCms;
#pragma unroll
    for (int k0 = 0; k0 < kCms; k0 += 8) {
      const float a[4] = {qs[k0], qs[8 * kCrs + k0], qs[k0 + 4],
                          qs[8 * kCrs + k0 + 4]};
      uint32_t ah[4], al[4];
      split4(a, ah, al);
      if (a_tile) mma3<false>(acc_a, ah, al, ks[k0], ks[k0 + 4]);
      const float zlo = fmaf(r, zs[k0], has_p ? pzs[k0] : 0.f);
      const float zhi = fmaf(r, zs[k0 + 4], has_p ? pzs[k0 + 4] : 0.f);
      qz[0] += a[0] * zlo + a[2] * zhi;
      qz[1] += a[1] * zlo + a[3] * zhi;
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const int o = k0 * kSs + 8 * jn, o4 = o + 4 * kSs;
        mma3<false>(acc_n[jn], ah, al, fmaf(r, ss[o], has_p ? ps[o] : 0.f),
                    fmaf(r, ss[o4], has_p ? ps[o4] : 0.f));
      }
    }
  }
  // the warp's key tile of A, causally masked, into shared memory
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = rb + g + 8 * (e >> 1), key = 8 * cg + 2 * t + (e & 1);
    as[row * kAs + key] = a_tile && key <= row ? acc_a[e] : 0.f;
  }
  prf::grid_dependents_launch();      // launch 3 may start; it waits
  cp_async_wait<0>();
  __syncthreads();                    // A complete, V_c landed
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int k = t; k < kCc; k += 4) {
    rs[0] += as[(rb + g) * kAs + k];
    rs[1] += as[(rb + g + 8) * kAs + k];
  }
  const float den[2] = {prf::group_sum(rs[0] + qz[0]) + eps,
                        prf::group_sum(rs[1] + qz[1]) + eps};
  // + A V_c over the key tiles up to the warp's last row, the k-index t
  // taken as key 2t and t + 4 as key 2t + 1 (as launch 1 reads V)
  const int nkt = last / 8 + 1;
#pragma unroll
  for (int kt = 0; kt < kCc / 8; ++kt) {
    if (kt >= nkt) break;
    const float* a0 = as + (rb + g) * kAs + 8 * kt + 2 * t;
    const float a[4] = {a0[0], a0[8 * kAs], a0[1], a0[8 * kAs + 1]};
    uint32_t ah[4], al[4];
    split4(a, ah, al);
    const T* b = vs + (8 * kt + 2 * t) * kV + 16 * cg + g;
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
      mma3<sizeof(T) == 2>(acc_n[jn], ah, al, to_f(b[8 * jn]),
                           to_f(b[kV + 8 * jn]));
  }
  T* on = out + ((size_t)n * L + p0) * dv;
#pragma unroll
  for (int jn = 0; jn < 2; ++jn)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int row = rb + g + 4 * e;
      if (p0 + row < L)
        store2(on + (size_t)row * dv, j0 + 16 * cg + 8 * jn + 2 * t, dv,
               acc_n[jn][e] / den[e >> 1], acc_n[jn][e + 1] / den[e >> 1]);
    }
  // launch 1 ends before this launch does: launch 3 reads its last slot
  if (!has_p) prf::grid_dependency_wait();
}

// Launch 3. S_L = rho S0 + pfx[nc - 1] and z_L = rho z0 + pz[nc - 1] in
// place for query row n (KV row n / h), once launch 2 has read S0 and z0.
// Grid: (blocks, N).
__global__ void __launch_bounds__(256) carry_final_kernel(
    float* s0, float* z0, const float* __restrict__ rho,
    const float* __restrict__ pfx, const float* __restrict__ pz, int m,
    int dv, int h, int nc) {
  prf::grid_dependency_wait();
  const int n = blockIdx.y, nk = n / h;
  const float r = rho == nullptr ? 1.f : rho[n];
  const size_t fin = (size_t)nk * nc + nc - 1;
  const int i0 = blockIdx.x * 256 + threadIdx.x, stride = gridDim.x * 256;
  advance(s0 + (size_t)n * m * dv, pfx + fin * m * dv, m * dv, r, i0,
          stride);
  advance(z0 + (size_t)n * m, pz + fin * m, m, r, i0, stride);
}

// B4: launch 1, launch 2, then launch 3 (S_L in place), the later two
// started by programmatic dependent launch while the one before them
// finishes.
template <typename T>
int launch_carry(const float* qf, const float* kf, const void* v,
                 float* s0, float* z0, const float* rho, float* pfx,
                 float* pz, void* out, int N, int Nk, int L, int m, int dv,
                 float eps, cudaStream_t st) {
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const int nc = (L + kCc - 1) / kCc, ndv = (dv + kDvT - 1) / kDvT;
  cudaError_t err = cudaFuncSetAttribute(
      carry_prefix_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kPrefixSmem<T>);
  if (err != cudaSuccess) return (int)err;
  carry_prefix_kernel<T><<<dim3(((m + kDf - 1) / kDf) * ndv, Nk), 256,
                           kPrefixSmem<T>, st>>>(kf, vt, pfx, pz, L, m, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(carry_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kCarrySmem<T>);
  if (err != cudaSuccess) return (int)err;
  const int e = prf::launch_after(
      carry_out_kernel<T>, dim3(nc * ndv, N), 256, kCarrySmem<T>, st, qf, kf,
      vt, (const float*)s0, (const float*)z0, rho, (const float*)pfx,
      (const float*)pz, ot, L, m, dv, N / Nk, eps);
  if (e != 0) return e;
  const int blocks = (m * dv / 4 + 1023) / 1024;    // 4 pieces a thread
  return prf::launch_after(carry_final_kernel,
                           dim3(blocks > 0 ? blocks : 1, N), 256, 0, st, s0,
                           z0, rho, (const float*)pfx, (const float*)pz, m,
                           dv, N / Nk, nc);
}

}  // namespace las

// qf: (N, L, m) f32; kf: (Nk, L, m) f32; v: (Nk, L, dv) f32 or bf16;
// query row n reads KV row n / (N / Nk). s_in: (Nk, max(nc - 1, 1), m, dv)
// and z_in: (Nk, max(nc - 1, 1), m) f32 scratch, nc = ceil(L / 64); out:
// (N, L, dv) in v's type.
extern "C" int linear_attn_causal(const float* qf, const float* kf,
                                  const void* v, float* s_in, float* z_in,
                                  void* out, int N, int Nk, int L, int m,
                                  int dv, int bf16_v, float eps,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_v)
    return las::launch_causal<__nv_bfloat16>(qf, kf, v, s_in, z_in, out, N,
                                             Nk, L, m, dv, eps, st);
  return las::launch_causal<float>(qf, kf, v, s_in, z_in, out, N, Nk, L, m,
                                   dv, eps, st);
}

// As linear_attn_causal, resumed from the carried state s0: (N, m, dv) and
// z0: (N, m) f32 of each query row, scaled first by rho: (N) f32 (null:
// 1), then advanced over the L tokens, in place. pfx: (Nk, nc, m, dv) and
// pz: (Nk, nc, m) f32 scratch, nc = ceil(L / 32).
extern "C" int linear_attn_carry(const float* qf, const float* kf,
                                 const void* v, float* s0, float* z0,
                                 const float* rho, float* pfx, float* pz,
                                 void* out, int N, int Nk, int L, int m,
                                 int dv, int bf16_v, float eps,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_v)
    return las::launch_carry<__nv_bfloat16>(qf, kf, v, s0, z0, rho, pfx, pz,
                                            out, N, Nk, L, m, dv, eps, st);
  return las::launch_carry<float>(qf, kf, v, s0, z0, rho, pfx, pz, out, N,
                                  Nk, L, m, dv, eps, st);
}
