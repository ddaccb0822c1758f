// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/wkv6_scan.py, wkv6_fwd
//   (body _kernel). Per (batch * head) row n, with a dh x dh f32 state S
//   that starts from zero:
//     o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   u is one (dh,) vector shared by every row; o is written in v's type.
//
// What bounds it on the H100: the bytes. At the rwkv6-7b geometry (512
//   rows = 64 heads x batch 8, L = 512, dh = 64, f32) r, k, v, w are read
//   once and o written once, 335 MB, 100 us at 3.35 TB/s; the recurrence
//   needs about 5 dh^2 operations a token and row, 5.4 GFLOP, 80 us at the
//   67 TFLOP/s of f32.
//
// Design: the recurrence is serial in t (the data-dependent decay w_t rules
//   out a plain matmul form), so a block owns one row and walks its tokens
//   with the state in registers: 4 dh threads, thread (e, part) holding
//   column e of S on the rows d = part, part + 4, ... (at most 16 floats).
//   Per token each thread folds its rows into its share of o_t[e] and
//   updates them; the 4 parts of a column are neighbouring lanes and
//   reduce by shuffles. r, k, v and w of a run of kRun tokens are staged in
//   shared memory as f32 (coalesced loads; the rows a thread reads are
//   4 words apart, so the 4 parts hit 4 different banks), and the run's
//   outputs are staged there too and written coalesced. The tail of L is
//   masked, not padded: a run stops at the last token.
#include "prf_common.cuh"

namespace wkv {

using prf::from_f;
using prf::to_f;

constexpr int kParts = 4;                  // threads per column of S
constexpr int kMaxDh = 64;
constexpr int kRows = kMaxDh / kParts;     // state rows a thread holds
constexpr int kRun = 32;                   // tokens staged at a time

template <typename T>
__global__ void __launch_bounds__(kParts * kMaxDh) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u, T* __restrict__ o,
    int L, int dh) {
  __shared__ float rs[kRun * kMaxDh], ks[kRun * kMaxDh], vs[kRun * kMaxDh],
      ws[kRun * kMaxDh], os[kRun * kMaxDh];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int e = tid / kParts, part = tid % kParts;
  const size_t base = (size_t)blockIdx.x * L * dh;
  float st[kRows], ur[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int d = i * kParts + part;
    st[i] = 0.f;
    ur[i] = d < dh ? u[d] : 0.f;
  }
  for (int t0 = 0; t0 < L; t0 += kRun) {
    const int run = min(kRun, L - t0);
    const size_t off = base + (size_t)t0 * dh;
    __syncthreads();                       // the last run's os written out
    for (int idx = tid; idx < run * dh; idx += nthr) {
      rs[idx] = to_f(r[off + idx]);
      ks[idx] = to_f(k[off + idx]);
      vs[idx] = to_f(v[off + idx]);
      ws[idx] = to_f(w[off + idx]);
    }
    __syncthreads();
    for (int t = 0; t < run; ++t) {
      const float* rt = rs + t * dh;
      const float* kt = ks + t * dh;
      const float* wt = ws + t * dh;
      const float ve = vs[t * dh + e];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int d = i * kParts + part;
        if (d < dh) {
          const float kv = kt[d] * ve;
          acc += rt[d] * (st[i] + ur[i] * kv);
          st[i] = wt[d] * st[i] + kv;
        }
      }
      acc = prf::group_sum(acc);
      if (part == 0) os[t * dh + e] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < run * dh; idx += nthr)
      o[off + idx] = from_f<T>(os[idx]);
  }
}

}  // namespace wkv

// r, k, v, w: (N, L, dh) in one type, f32 or bf16; u: (dh) f32; o: (N, L,
// dh) in that type. dh a multiple of 8, at most 64.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const float* u, void* o, int N, int L,
                        int dh, int bf16, void* stream) {
  using namespace wkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = kParts * dh;
  if (bf16) {
    using T = __nv_bfloat16;
    wkv6_kernel<T><<<N, threads, 0, st>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(w), u,
        static_cast<T*>(o), L, dh);
  } else {
    wkv6_kernel<float><<<N, threads, 0, st>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w), u,
        static_cast<float*>(o), L, dh);
  }
  return (int)cudaGetLastError();
}
