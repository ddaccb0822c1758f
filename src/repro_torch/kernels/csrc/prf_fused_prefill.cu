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
// What bounds it on the H100: f32 operations. For smollm-135m (G 3, Hg 3,
//   d = r = 64, m 256, dv 64) the serving grants hold 256 tokens a call
//   (8 rows x 32, 4 x 64, 2 x 128, 1 x 256), and the fewest operations
//   that compute the function are the features, 2*d*m + 2*r*d + 2*r per
//   featurized q or k row, and the token-serial scan, 4*m*dv + 4*m per
//   token per head: 0.28 GFLOP at every grant, 4.2 us at the 67 TFLOP/s of
//   f32 outside the tensor cores. The bytes (S and z read and written once,
//   9.4 MB at 8 rows, 1.2 MB at 1 row) take 2.8 us and 0.4 us at 3.35 TB/s.
//
// Design: per T-chunk, three launches in stream order, four when the
//   chunk holds more than 64 tokens; each is parallel over the chunk's
//   tokens (the TPU kernel's sequential chunk axis stays a loop, on the
//   host, over T-chunks only). A zeroed max-slot array comes first; the
//   launches after the first may start while the one before finishes
//   (programmatic dependent launch) and wait for it before they read.
//   1. logits: one block per (32 of the (Hg + 1) T q and k rows of a
//      (b, g), b g). The rows are staged in shared memory; A and M^T come
//      through it in slabs of 16 rows, a ring of four filled by cp.async;
//      each thread keeps a 4 x 8 register tile of x A (m = 256) and a
//      warp's lanes the columns of M x for |Mx|^2. k rows are featurized
//      once per KV group, not once per head. The raw logits go to an f32
//      scratch of (B G, Hg + 1, T, m), 3.1 MB at the serving grants,
//      which stays in the L2; the valid rows' maxima are folded, one
//      atomicMax per head and block, into a per-(b, g, h) q slot and a
//      per-(b, g) k slot on an order-preserving integer image (a max is
//      order-free: deterministic).
//   2. prefix (T > 64 only): one block per (b g, 16 rows of S, 64 columns
//      of dv) sums kf^T v and sum kf over the chunk's steps of 64 tokens
//      and writes the exclusive prefix after each step but the last, once
//      per KV group.
//   3. output: one block of 16 warps per (b g h, 32 queries, 64 columns
//      of dv). It builds its qf tile, reads rho S + the prefix of its step
//      (cp.async and 16-byte loads), and adds the causal products of its
//      step's own key tiles up to the diagonal (one or two tiles of 32
//      keys): num = qf.(rho S + P) + tril(qf kf^T) v, den likewise. So
//      every block does the same work wherever its tile lies in a long
//      chunk. Two groups of 8 warps split each sum and add their halves
//      in shared memory. Blocks of (h 0, tile 0) leave c' and rho for
//      launch 4.
//   4. state, after every read of the old state: one block per (b g, 16
//      rows of S, 64 columns of dv) adds the last step's kf^T v and sum kf
//      to the prefix and writes S_h <- rho S_h + dS, z_h <- rho z_h +
//      sum kf for each of the Hg heads, and c <- c'. So no snapshot of c
//      or z is needed. A row with valid_len 0 gets c' = c, rho = 1 and
//      kf = 0: its state stays bitwise.
//   Every phase that reads device memory issues all of its loads before
//   it uses the first. The arithmetic stays f32 throughout (no TF32
//   tensor cores): the port's tolerances (kernels/check.py) are those of
//   f32 sums, and TF32 keeps about three decimal digits. The gain over a
//   token-serial block comes from parallelism over tokens, shared-memory
//   staging and computing each feature once. At 8 rows x 32 the launches
//   fill 96, 72 and 384 blocks, and each launch's fixed cost is a large
//   share of the call (times on an H100: PERF.md).
#include "prf_common.cuh"

namespace prf {
namespace prefill {

constexpr int kRows = 32;      // q/k rows per logits block
constexpr int kSlab = 16;      // rows of A per cp.async slab
constexpr int kStages = 4;     // slabs in flight or in use: a ring
constexpr int kQT = 32;        // queries (and keys) per output tile
constexpr int kSub = 64;       // tokens per prefix step (two key tiles)
constexpr int kDvT = 64;       // dv columns per output and state block
constexpr int kSRows = 16;     // rows of S per prefix and state block
constexpr int kBatch = 256;    // keys a prefix or state block stages at once
constexpr int kOutThreads = 512; // output block: two groups of 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRLanes = 8;                  // r <= 256: M x columns a lane
constexpr unsigned kNegOrder = 0x80800000u;    // order image of kNeg

// An unsigned image of x that orders as the floats do, 0 being kNeg's:
// zeroed slots read as kNeg.
__device__ __forceinline__ unsigned encode_max(float x) {
  const int i = __float_as_int(fmaxf(x, kNeg));
  const int o = i >= 0 ? i : i ^ 0x7fffffff;
  return (unsigned)o - kNegOrder;
}

__device__ __forceinline__ float decode_max(unsigned u) {
  const int o = (int)(u + kNegOrder);
  return __int_as_float(o >= 0 ? o : o ^ 0x7fffffff);
}

// V consecutive floats from shared memory (16- or 8-byte loads).
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (V == 4) {
    const float4 t = ld4(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
    *p = in[0];
  }
}

__device__ __forceinline__ float lane_of(const float4& t, int u) {
  return u == 0 ? t.x : u == 1 ? t.y : u == 2 ? t.z : t.w;
}

// The logits block's register tile: CT columns of m a thread (V at a
// time, CG column groups side by side), RPT rows.
template <int M>
struct Tile {
  static constexpr int CT = M >= 32 ? M / 32 : 1;
  static constexpr int V = CT < 4 ? CT : 4;
  static constexpr int CG = M / CT;
  static constexpr int RG = kThreads / CG;
  static constexpr int RPT = kRows / RG;
};

// Columns of M x a lane of the logits block: 32 lanes cover r (<= 256).
__host__ __device__ inline int r_lanes(int r) {
  return r <= 32 ? 1 : r <= 64 ? 2 : r <= 128 ? 4 : kMaxRLanes;
}

// One slab of M x for a warp's NR rows: xt[i][w] += sum over the slab's
// 16 values of e of x[i][e] M^T[e][lane + 32 w], for w < UR.
template <int UR, int NR>
__device__ __forceinline__ void mx_slab(const float* xe, int dp,
                                        const float* mb, int rp,
                                        float (&xt)[NR][kMaxRLanes]) {
#pragma unroll
  for (int e4 = 0; e4 < kSlab; e4 += 4) {
    float4 xv[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i)
      xv[i] = ld4(xe + i * dp + e4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int w = 0; w < UR; ++w) {
        const float mv = mb[(e4 + u) * rp + 32 * w];
#pragma unroll
        for (int i = 0; i < NR; ++i) xt[i][w] += lane_of(xv[i], u) * mv;
      }
    }
  }
}

// Launch 1: raw logits of 32 q/k rows of one (b, g) over all m columns.
// Row j of a (b, g) is head j / tl's (head Hg: the keys) token j % tl.
// Each slab of 16 rows of A, and of M^T (dark kinds), comes through
// shared memory by cp.async, three slabs ahead of the one multiplied.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads) logits_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const float* __restrict__ a, const float* __restrict__ mm,
    const int* __restrict__ valid_len, float* __restrict__ raw,
    unsigned* __restrict__ slots, int G, int Hg, int L, int d, int r,
    int t0, int tl, int tmax, int stabilize) {
  using Geo = Tile<M>;
  constexpr int NR = kRows / kWarps;              // rows a warp, for M x
  extern __shared__ __align__(16) float smem[];
  const int dp = (d + kSlab - 1) / kSlab * kSlab;  // d padded to slabs
  const int ur = mm != nullptr ? r_lanes(r) : 0;   // M x columns a lane
  const int rp = mm != nullptr ? 32 * ur + 1 : 0;  // M^T slab row stride
  float* as = smem;                        // kStages slabs (kSlab, M)
  float* ms = as + kStages * kSlab * M;    // kStages slabs (kSlab, rp)
  float* xs = ms + kStages * kSlab * rp;   // (kRows, dp)
  float* nrm = xs + kRows * dp;                    // (kRows)
  float* rmx = nrm + kRows;                        // (kRows) row maxima
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bg = blockIdx.y, g = bg % G, b = bg / G;
  const int rows = (Hg + 1) * tl;
  const int row0 = blockIdx.x * kRows;
  const float* ag = a + (size_t)g * d * M;
  const float* mg = mm != nullptr ? mm + (size_t)g * r * d : nullptr;

  const int ns = dp / kSlab;
  // slab sl into ring buffer sl % kStages, or nothing past the last slab;
  // one commit group either way, so the group count stays in step
  auto issue = [&](int sl) {
    if (sl >= ns) {
      cp_async_commit();
      return;
    }
    float* dst = as + (sl % kStages) * kSlab * M;
    const int e0 = sl * kSlab;
    for (int idx = tid; idx < kSlab * M / 4; idx += kThreads) {
      const int e = idx / (M / 4), c4 = idx - e * (M / 4);
      float* sp = dst + e * M + 4 * c4;
      if (e0 + e < d)
        cp_async16(sp, ag + (size_t)(e0 + e) * M + 4 * c4);
      else
        *reinterpret_cast<float4*>(sp) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (mg != nullptr) {               // M^T, transposed on the way
      float* mdst = ms + (sl % kStages) * kSlab * rp;
      for (int idx = tid; idx < kSlab * r; idx += kThreads) {
        const int rr = idx / kSlab, e = idx - rr * kSlab;
        float* sp = mdst + e * rp + rr;
        if (e0 + e < d)
          cp_async4(sp, mg + (size_t)rr * d + e0 + e);
        else
          *sp = 0.f;
      }
    }
    cp_async_commit();
  };
  for (int sl = 0; sl < kStages - 1; ++sl) issue(sl);

  // the rows, 8 loads a thread in flight before their stores
  for (int base = 0; base < kRows * dp; base += 8 * kThreads) {
    float xv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + u * kThreads + tid;
      const int rr = idx / dp, e = idx - rr * dp;
      const int row = row0 + rr;
      xv[u] = 0.f;
      if (idx < kRows * dp && row < rows && e < d) {
        const int hh = row / tl, t = row - hh * tl;
        const T* src = hh < Hg
                           ? q + (((size_t)bg * Hg + hh) * L + t0 + t) * d
                           : k + ((size_t)bg * L + t0 + t) * d;
        xv[u] = to_f(src[e]);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + u * kThreads + tid;
      if (idx < kRows * dp) xs[idx] = xv[u];
    }
  }

  // x A over the slabs of A (register tile), and M x (warp w's NR rows,
  // lanes over r; columns of M x a lane beyond r are never summed)
  const int rg = tid / Geo::CG, cg = tid - rg * Geo::CG;
  float acc[Geo::RPT][Geo::CT];
#pragma unroll
  for (int i = 0; i < Geo::RPT; ++i)
#pragma unroll
    for (int cc = 0; cc < Geo::CT; ++cc) acc[i][cc] = 0.f;
  float xt[NR][kMaxRLanes];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int u = 0; u < kMaxRLanes; ++u) xt[i][u] = 0.f;
  const float* xr = xs + rg * Geo::RPT * dp;
  const float* xw = xs + warp * NR * dp;
  for (int sl = 0; sl < ns; ++sl) {
    issue(sl + kStages - 1);          // into the buffer read last round
    cp_async_wait<kStages - 1>();     // slab sl has landed
    __syncthreads();
    const float* ab = as + (sl % kStages) * kSlab * M + cg * Geo::V;
    const float* xb = xr + sl * kSlab;
#pragma unroll
    for (int e4 = 0; e4 < kSlab; e4 += 4) {
      float4 xv[Geo::RPT];            // 4 values of e a row, one load
#pragma unroll
      for (int i = 0; i < Geo::RPT; ++i)
        xv[i] = ld4(xb + i * dp + e4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float av[Geo::CT];
#pragma unroll
        for (int j = 0; j < Geo::CT / Geo::V; ++j)
          load_vec<Geo::V>(ab + (e4 + u) * M + j * Geo::CG * Geo::V,
                           av + j * Geo::V);
#pragma unroll
        for (int i = 0; i < Geo::RPT; ++i) {
          const float x = lane_of(xv[i], u);
#pragma unroll
          for (int cc = 0; cc < Geo::CT; ++cc) acc[i][cc] += x * av[cc];
        }
      }
    }
    if (mg != nullptr) {
      const float* mb = ms + (sl % kStages) * kSlab * rp + lane;
      const float* xe = xw + sl * kSlab;
      switch (ur) {
        case 1: mx_slab<1>(xe, dp, mb, rp, xt); break;
        case 2: mx_slab<2>(xe, dp, mb, rp, xt); break;
        case 4: mx_slab<4>(xe, dp, mb, rp, xt); break;
        default: mx_slab<8>(xe, dp, mb, rp, xt); break;
      }
    }
    __syncthreads();
  }

  // |M x|^2 / 2, or |x|^2 / 2 for the isotropic kinds
  {
    float sq[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) sq[i] = 0.f;
    if (mg != nullptr) {
#pragma unroll
      for (int u = 0; u < kMaxRLanes; ++u)
        if (lane + 32 * u < r) {
#pragma unroll
          for (int i = 0; i < NR; ++i) sq[i] += xt[i][u] * xt[i][u];
        }
    } else {
      for (int e = lane; e < d; e += 32) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const float x = xw[i * dp + e];
          sq[i] += x * x;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float tot = warp_sum(sq[i]);
      if (lane == 0) nrm[warp * NR + i] = 0.5f * tot;
    }
  }
  __syncthreads();

  const int vl = valid_len != nullptr ? valid_len[b] : L;
  float* rb = raw + (size_t)bg * (Hg + 1) * tmax * M + cg * Geo::V;
#pragma unroll
  for (int i = 0; i < Geo::RPT; ++i) {
    const int row = row0 + rg * Geo::RPT + i;
    const int hh = row / tl, t = row - hh * tl;
    const float n = nrm[rg * Geo::RPT + i];
    float vals[Geo::CT];
    float mx = kNeg;
#pragma unroll
    for (int cc = 0; cc < Geo::CT; ++cc) {
      vals[cc] = acc[i][cc] - n;
      mx = fmaxf(mx, vals[cc]);
    }
    if (row < rows) {
      float* dst = rb + ((size_t)hh * tmax + t) * M;
#pragma unroll
      for (int j = 0; j < Geo::CT / Geo::V; ++j)
        store_vec<Geo::V>(dst + j * Geo::CG * Geo::V, vals + j * Geo::V);
    }
    // the row's max over m: the CG lanes of its row group
#pragma unroll
    for (int o = Geo::CG / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (cg == 0)
      rmx[rg * Geo::RPT + i] = row < rows && t0 + t < vl ? mx : kNeg;
  }
  grid_dependents_launch();
  // one atomicMax per head among the block's rows: warp 0, a lane a row,
  // takes the max over each run of rows of one head (a segmented suffix
  // max), and the run's first lane folds it into the head's slot
  if (!stabilize) return;
  __syncthreads();
  if (warp == 0) {
    const int row = row0 + lane;
    const int hh = row < rows ? row / tl : -1;
    float mx = rmx[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float other = __shfl_down_sync(0xffffffffu, mx, o);
      const int oh = __shfl_down_sync(0xffffffffu, hh, o);
      if (lane + o < 32 && oh == hh) mx = fmaxf(mx, other);
    }
    const int prev = __shfl_up_sync(0xffffffffu, hh, 1);
    if (hh >= 0 && (lane == 0 || prev != hh) && mx > kNeg)
      atomicMax(slots + (size_t)bg * (Hg + 1) + hh, encode_max(mx));
  }
}

// The stabilizer of (b, g) after this T-chunk's keys: c' and rho (and the
// query shift of head h), from c and the max slots.
__device__ __forceinline__ void stabilizer(const float* __restrict__ c,
                                           const unsigned* __restrict__ slots,
                                           int bg, int h, int Hg,
                                           int stabilize, float* c_new,
                                           float* rho, float* qshift) {
  const float c_old = c[bg];
  if (stabilize) {
    *c_new = fmaxf(c_old, decode_max(slots[(size_t)bg * (Hg + 1) + Hg]));
    *rho = expf(c_old - *c_new);
    *qshift = decode_max(slots[(size_t)bg * (Hg + 1) + h]);
  } else {
    *c_new = 0.f;
    *rho = expf(c_old);
    *qshift = 0.f;
  }
}

// Features of kQT rows of raw logits (row stride M): exp(raw - shift)/
// sqrt(m) for the first nvalid rows, 0 for the others, by a block of NT
// threads. load() issues every load of the tile into registers; store()
// writes the features to shared memory (row stride `stride`), so the
// loads can be in flight across other work.
template <int M, int NT>
struct FeatureTile {
  static constexpr int N4 = kQT * M / 4;
  static constexpr int IT = (N4 + NT - 1) / NT;
  float4 r[IT];

  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       int nvalid) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int idx = threadIdx.x + it * NT;
      const int j = idx / (M / 4), c4 = idx - j * (M / 4);
      r[it] = idx < N4 && j < nvalid ? ld4(src + (size_t)j * M + 4 * c4)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void store(float* dst, int stride, int nvalid,
                                        float shift,
                                        float inv_sqrt_m) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int idx = threadIdx.x + it * NT;
      const int j = idx / (M / 4), c4 = idx - j * (M / 4);
      if (idx < N4) {
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < nvalid) {
          f.x = expf(r[it].x - shift) * inv_sqrt_m;
          f.y = expf(r[it].y - shift) * inv_sqrt_m;
          f.z = expf(r[it].z - shift) * inv_sqrt_m;
          f.w = expf(r[it].w - shift) * inv_sqrt_m;
        }
        *reinterpret_cast<float4*>(dst + j * stride + 4 * c4) = f;
      }
    }
  }
};

// A key tile's v (kQT rows x kDvT columns from column j0), in registers
// until store().
template <typename T, int NT>
struct ValueTile {
  static constexpr int NV = kQT * kDvT / NT;
  float r[NV];

  __device__ __forceinline__ void load(const T* __restrict__ vk, int n,
                                       int dv, int j0) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int idx = threadIdx.x + u * NT;
      const int j = idx / kDvT, jj = idx - j * kDvT;
      r[u] = j < n && j0 + jj < dv ? to_f(vk[(size_t)j * dv + j0 + jj])
                                   : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* vs) const {
#pragma unroll
    for (int u = 0; u < NV; ++u) vs[threadIdx.x + u * NT] = r[u];
  }
};

// Launch 3: the outputs of 32 queries x 64 columns of one (b, g, h). The
// query tile lies in prefix step `sub` (64 tokens a step): the block
// reads the carried state rho S + the earlier steps' kf^T v (launch 2)
// and adds the causal products of the step's own key tiles up to the
// diagonal (one or two tiles of 32 keys). Two groups of 8 warps split
// each product's sum (m for qf.(rho S + P) and the scores, the keys for
// the scores times v) and add their halves in shared memory; in a group,
// a warp covers 8 rows x 32 columns of the output (or 8 rows x 16 keys
// of the scores), a lane 2 rows x 4 columns (2 x 2), the products'
// shared loads 16 bytes each.
template <typename T, int M>
__global__ void __launch_bounds__(kOutThreads) output_kernel(
    const T* __restrict__ v, const float* __restrict__ raw,
    const unsigned* __restrict__ slots, const int* __restrict__ valid_len,
    const float* __restrict__ s, const float* __restrict__ z,
    const float* __restrict__ c, const float* __restrict__ pre,
    const float* __restrict__ zpre, float* __restrict__ carry,
    T* __restrict__ out, int G, int Hg, int L, int dv, int t0, int tl,
    int tmax, int pstride, int stabilize, float eps, float inv_sqrt_m) {
  constexpr int NT = kOutThreads;
  constexpr int QS = M + 4;           // padded row stride of qs and ks
  constexpr int PS = kQT + 4;         // padded row stride of the scores
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // (kQT, QS) query features
  float* ss = qs + kQT * QS;          // (M, kDvT) rho S + prefix
  float* ks = ss + M * kDvT;          // (kQT, QS) key features
  float* vs = ks + kQT * QS;          // (kQT, kDvT)
  float* ps = vs + kQT * kDvT;        // (kQT, PS) scores
  float* px = ps + kQT * PS;          // (kQT, PS) group 1's partial scores
  float* nx = px + kQT * PS;          // (kQT, kDvT) group 1's partial out
  float* zs = nx + kQT * kDvT;        // (M) rho z + prefix
  float* dens = zs + M;               // (kQT) denominators
  grid_dependency_wait();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp >> 3, gw = warp & 7;      // warp group, its warp
  const int bgh = blockIdx.x, bg = bgh / Hg, h = bgh - bg * Hg, b = bg / G;
  const int qt = blockIdx.y, q0 = qt * kQT, sub = q0 / kSub;
  const int j0 = blockIdx.z * kDvT;
  const int vl = valid_len != nullptr ? valid_len[b] : L;
  const int kvalid = min(tl, vl - t0);          // keys valid below this
  const int kt0 = sub * (kSub / kQT);           // this step's first tile
  // the register tiles: rows r8 + 2 lr + {0, 1}; output columns
  // c32 + 4 lc .. + 3, or score keys k16 + lc + {0, 8} (neighbouring
  // lanes on neighbouring key rows: no bank conflict)
  const int lr = lane >> 3, lc = lane & 7;
  const int ra = (gw & 3) * 8 + 2 * lr;
  const int ca = (gw >> 2) * 32 + 4 * lc;
  const int ka = (gw >> 2) * 16 + lc;
  const int ib = grp * (M / 2), ie = ib + M / 2;  // this group's half of m

  // loads in flight together: the S tile and z (cp.async), the raw query
  // logits, the first key tile's raw logits and v
  const float* sh = s + (size_t)bgh * M * dv + j0;
  for (int idx = tid; idx < M * kDvT / 4; idx += NT) {
    const int i = idx / (kDvT / 4), c4 = idx - i * (kDvT / 4);
    float* dst = ss + i * kDvT + 4 * c4;
    if (j0 + 4 * c4 < dv)
      cp_async16(dst, sh + (size_t)i * dv + 4 * c4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int idx = tid; idx < M / 4; idx += NT)
    cp_async16(zs + 4 * idx, z + (size_t)bgh * M + 4 * idx);
  cp_async_commit();
  const float* rq = raw + ((size_t)bg * (Hg + 1) + h) * tmax * M;
  const float* rk = raw + ((size_t)bg * (Hg + 1) + Hg) * tmax * M;
  const T* vk = v + ((size_t)bg * L + t0) * dv;
  FeatureTile<M, NT> fq, fk;
  ValueTile<T, NT> fv;
  fq.load(rq + (size_t)q0 * M, tl - q0);
  fk.load(rk + (size_t)kt0 * kQT * M, kvalid - kt0 * kQT);
  fv.load(vk + (size_t)kt0 * kQT * dv, tl - kt0 * kQT, dv, j0);
  float c_new, rho, qshift;
  stabilizer(c, slots, bg, h, Hg, stabilize, &c_new, &rho, &qshift);
  if (h == 0 && qt == 0 && blockIdx.z == 0 && tid == 0) {
    carry[2 * bg] = c_new;
    carry[2 * bg + 1] = rho;
  }
  fq.store(qs, QS, tl - q0, qshift, inv_sqrt_m);
  cp_async_wait<0>();
  __syncthreads();

  // rho S + P, rho z + zP, P the kf^T v of the steps before this one
  {
    constexpr int N4 = M * kDvT / 4;
    constexpr int IT = (N4 + NT - 1) / NT;
    const float* pt =
        sub > 0 ? pre + ((size_t)bg * pstride + sub - 1) * M * dv + j0
                : nullptr;
    float4 pr[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int idx = tid + it * NT;
      const int i = idx / (kDvT / 4), c4 = idx - i * (kDvT / 4);
      pr[it] = pt != nullptr && idx < N4 && j0 + 4 * c4 < dv
                   ? ld4(pt + (size_t)i * dv + 4 * c4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int idx = tid + it * NT;
      if (idx < N4) {
        float4* d4 = reinterpret_cast<float4*>(ss) + idx;
        float4 x = *d4;
        x.x = x.x * rho + pr[it].x;
        x.y = x.y * rho + pr[it].y;
        x.z = x.z * rho + pr[it].z;
        x.w = x.w * rho + pr[it].w;
        *d4 = x;
      }
    }
    const float* zp =
        sub > 0 ? zpre + ((size_t)bg * pstride + sub - 1) * M : nullptr;
    for (int i = tid; i < M; i += NT)
      zs[i] = zs[i] * rho + (zp != nullptr ? zp[i] : 0.f);
  }
  __syncthreads();

  // the carried part: num = qf.(rho S + P) over this group's half of m;
  // den = qf.(rho z + zP), two rows a warp
  float num[2][4];
#pragma unroll
  for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) num[k2][cc] = 0.f;
#pragma unroll 2
  for (int i = ib; i < ie; i += 4) {
    const float4 q0v = ld4(qs + ra * QS + i);
    const float4 q1v = ld4(qs + (ra + 1) * QS + i);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 sv = ld4(ss + (i + u) * kDvT + ca);
      const float a0 = lane_of(q0v, u), a1 = lane_of(q1v, u);
      num[0][0] += a0 * sv.x; num[0][1] += a0 * sv.y;
      num[0][2] += a0 * sv.z; num[0][3] += a0 * sv.w;
      num[1][0] += a1 * sv.x; num[1][1] += a1 * sv.y;
      num[1][2] += a1 * sv.z; num[1][3] += a1 * sv.w;
    }
  }
#pragma unroll
  for (int rr = 0; rr < kQT / (NT / 32); ++rr) {
    const int row = warp * (kQT / (NT / 32)) + rr;
    float acc = 0.f;
#pragma unroll
    for (int i = lane; i < M; i += 32) acc += qs[row * QS + i] * zs[i];
    acc = warp_sum(acc);
    if (lane == 0) dens[row] = acc;
  }

  // this step's own keys, tile by tile up to the diagonal
  for (int kti = kt0; kti <= qt; ++kti) {
    const int k0 = kti * kQT;
    if (kti > kt0) {
      fk.load(rk + (size_t)k0 * M, kvalid - k0);
      fv.load(vk + (size_t)k0 * dv, tl - k0, dv, j0);
    }
    __syncthreads();                  // the last tile's ks, vs, ps read
    fk.store(ks, QS, kvalid - k0, c_new, inv_sqrt_m);
    fv.store(vs);
    __syncthreads();
    float p[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
    for (int i = ib; i < ie; i += 4) {
      const float4 q0v = ld4(qs + ra * QS + i);
      const float4 q1v = ld4(qs + (ra + 1) * QS + i);
      const float4 k0v = ld4(ks + ka * QS + i);
      const float4 k1v = ld4(ks + (ka + 8) * QS + i);
      p[0][0] += q0v.x * k0v.x + q0v.y * k0v.y + q0v.z * k0v.z + q0v.w * k0v.w;
      p[0][1] += q0v.x * k1v.x + q0v.y * k1v.y + q0v.z * k1v.z + q0v.w * k1v.w;
      p[1][0] += q1v.x * k0v.x + q1v.y * k0v.y + q1v.z * k0v.z + q1v.w * k0v.w;
      p[1][1] += q1v.x * k1v.x + q1v.y * k1v.y + q1v.z * k1v.z + q1v.w * k1v.w;
    }
    if (grp == 1) {
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        px[(ra + k2) * PS + ka] = p[k2][0];
        px[(ra + k2) * PS + ka + 8] = p[k2][1];
      }
    }
    __syncthreads();
    if (grp == 0) {                   // the two halves, the causal mask
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int key = ka + 8 * kk, row = ra + k2;
          const float sc = p[k2][kk] + px[row * PS + key];
          ps[row * PS + key] = kti == qt && key > row ? 0.f : sc;
        }
    }
    __syncthreads();
    if (tid < kQT) {                  // the scores' row sums
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < kQT; ++j) acc += ps[tid * PS + j];
      dens[tid] += acc;
    }
    // scores times v over this group's half of the keys
    const int jb = grp * (kQT / 2);
#pragma unroll
    for (int j = jb; j < jb + kQT / 2; j += 4) {
      const float4 p0 = ld4(ps + ra * PS + j);
      const float4 p1 = ld4(ps + (ra + 1) * PS + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 vv = ld4(vs + (j + u) * kDvT + ca);
        const float a0 = lane_of(p0, u), a1 = lane_of(p1, u);
        num[0][0] += a0 * vv.x; num[0][1] += a0 * vv.y;
        num[0][2] += a0 * vv.z; num[0][3] += a0 * vv.w;
        num[1][0] += a1 * vv.x; num[1][1] += a1 * vv.y;
        num[1][2] += a1 * vv.z; num[1][3] += a1 * vv.w;
      }
    }
  }
  if (grp == 1) {
#pragma unroll
    for (int k2 = 0; k2 < 2; ++k2)
      *reinterpret_cast<float4*>(nx + (ra + k2) * kDvT + ca) = make_float4(
          num[k2][0], num[k2][1], num[k2][2], num[k2][3]);
  }
  __syncthreads();                    // dens and group 1's halves complete
  grid_dependents_launch();
  if (grp == 1) return;
#pragma unroll
  for (int k2 = 0; k2 < 2; ++k2) {
    const int t = q0 + ra + k2;
    if (t < tl) {
      const float den = dens[ra + k2] + eps;
      const float4 o1 = ld4(nx + (ra + k2) * kDvT + ca);
      const float o[4] = {num[k2][0] + o1.x, num[k2][1] + o1.y,
                          num[k2][2] + o1.z, num[k2][3] + o1.w};
      T* op = out + ((size_t)bgh * L + t0 + t) * dv + j0 + ca;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        if (j0 + ca + cc < dv) op[cc] = from_f<T>(o[cc] / den);
    }
  }
}

// The prefix and state blocks' keys: kBatch keys of the chunk at a time,
// staged in shared memory by cp.async (every copy in flight at once):
// kf = exp(raw - c')/sqrt(m) (0 at or past kvalid) for rows i0 .. i0 + 15
// of S, and v for columns j0 .. j0 + 63.
template <typename T>
struct KeyStage {
  float* kf;                          // (kBatch, kSRows)
  T* vs;                              // (kBatch, kDvT)

  static constexpr size_t bytes() {
    return sizeof(float) * kBatch * kSRows + sizeof(T) * kBatch * kDvT;
  }

  // rk: the chunk's raw key logits from column i0; vg: its v rows.
  __device__ void load(const float* __restrict__ rk,
                       const T* __restrict__ vg, int kb, int n, int kvalid,
                       int dv, int j0, float c_new, float inv_sqrt_m) {
    constexpr int PER = 16 / sizeof(T);       // values a 16-byte piece
    const int tid = threadIdx.x;
    __syncthreads();                  // the last batch is summed
    for (int idx = tid; idx < n * (kSRows / 4); idx += kThreads) {
      const int j = idx / (kSRows / 4), c4 = idx - j * (kSRows / 4);
      cp_async16(kf + j * kSRows + 4 * c4,
                 rk + (size_t)(kb + j) * kDim + 4 * c4);
    }
    for (int idx = tid; idx < n * (kDvT / PER); idx += kThreads) {
      const int j = idx / (kDvT / PER), p = idx - j * (kDvT / PER);
      T* dst = vs + j * kDvT + p * PER;
      if (j0 + p * PER < dv)
        cp_async16(dst, vg + (size_t)(kb + j) * dv + j0 + p * PER);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int idx = tid; idx < n * kSRows; idx += kThreads)
      kf[idx] = kb + idx / kSRows < kvalid
                    ? expf(kf[idx] - c_new) * inv_sqrt_m
                    : 0.f;
    __syncthreads();
  }

  // acc += kf^T v over staged keys [j0k, j1k) for rows ig .. ig + 3 and
  // the thread's column; zacc += sum kf for row tid (tid < kSRows).
  __device__ void sum(int j0k, int j1k, float* acc, float& zacc) const {
    const int tid = threadIdx.x;
    const int jj = tid % kDvT, ig = (tid / kDvT) * 4;
#pragma unroll 8
    for (int j = j0k; j < j1k; ++j) {
      const float vv = to_f(vs[j * kDvT + jj]);
      const float4 kv = ld4(kf + j * kSRows + ig);
      acc[0] += kv.x * vv;
      acc[1] += kv.y * vv;
      acc[2] += kv.z * vv;
      acc[3] += kv.w * vv;
    }
    if (tid < kSRows)
      for (int j = j0k; j < j1k; ++j) zacc += kf[j * kSRows + tid];
  }

  int kDim;                           // row stride of the raw logits: m
};

// Launch 2 (chunks of more than one step): the exclusive prefix of the
// steps' kf^T v and sum kf for 16 rows x 64 columns of one (b, g):
// P_k = sum over steps j < k, written for k = 1 .. nsub - 1.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads) prefix_kernel(
    const T* __restrict__ v, const float* __restrict__ raw,
    const unsigned* __restrict__ slots, const int* __restrict__ valid_len,
    const float* __restrict__ c, float* __restrict__ pre,
    float* __restrict__ zpre, int G, int Hg, int L, int dv, int t0, int tl,
    int tmax, int nsub, int pstride, int stabilize, float inv_sqrt_m) {
  extern __shared__ __align__(16) float smem[];
  KeyStage<T> st{smem, reinterpret_cast<T*>(smem + kBatch * kSRows), M};
  grid_dependency_wait();
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kSRows, bg = blockIdx.y, b = bg / G;
  const int j0 = blockIdx.z * kDvT;
  const int jj = tid % kDvT, ig = (tid / kDvT) * 4;
  const int vl = valid_len != nullptr ? valid_len[b] : L;
  float c_new, rho, qshift;
  stabilizer(c, slots, bg, 0, Hg, stabilize, &c_new, &rho, &qshift);
  const float* rk = raw + ((size_t)bg * (Hg + 1) + Hg) * tmax * M + i0;
  const T* vg = v + ((size_t)bg * L + t0) * dv;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float zacc = 0.f;
  const int kend = (nsub - 1) * kSub;
  for (int kb = 0; kb < kend; kb += kBatch) {
    const int n = min(kBatch, kend - kb);
    st.load(rk, vg, kb, n, min(tl, vl - t0), dv, j0, c_new, inv_sqrt_m);
    for (int j = 0; j < n; j += kSub) {
      st.sum(j, j + kSub, acc, zacc);
      const size_t step = (size_t)bg * pstride + (kb + j) / kSub;
      if (j0 + jj < dv) {
        float* pp = pre + (step * M + i0 + ig) * dv + j0 + jj;
#pragma unroll
        for (int u = 0; u < 4; ++u) pp[(size_t)u * dv] = acc[u];
      }
      if (blockIdx.z == 0 && tid < kSRows) zpre[step * M + i0 + tid] = zacc;
    }
  }
  grid_dependents_launch();
}

// Launch 4: the whole chunk's kf^T v and sum kf for 16 rows x 64 columns
// of one (b, g) (the last step's, added to the prefix before it), then
// the Hg heads' S and z advanced in place, and c.
template <typename T, int M>
__global__ void __launch_bounds__(kThreads) state_kernel(
    const T* __restrict__ v, const float* __restrict__ raw,
    const int* __restrict__ valid_len, const float* __restrict__ carry,
    const float* __restrict__ pre, const float* __restrict__ zpre,
    float* __restrict__ s, float* __restrict__ z, float* __restrict__ c,
    int G, int Hg, int L, int dv, int t0, int tl, int tmax, int nsub,
    int pstride, float inv_sqrt_m) {
  extern __shared__ __align__(16) float smem[];
  KeyStage<T> st{smem, reinterpret_cast<T*>(smem + kBatch * kSRows), M};
  grid_dependency_wait();
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kSRows, bg = blockIdx.y, b = bg / G;
  const int j0 = blockIdx.z * kDvT;
  const int jj = tid % kDvT, ig = (tid / kDvT) * 4;
  const bool col = j0 + jj < dv;
  const int vl = valid_len != nullptr ? valid_len[b] : L;
  const float c_new = carry[2 * bg], rho = carry[2 * bg + 1];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float zacc = 0.f;
  if (nsub > 1) {
    const size_t step = (size_t)bg * pstride + nsub - 2;
    if (col) {
      const float* pp = pre + (step * M + i0 + ig) * dv + j0 + jj;
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = pp[(size_t)u * dv];
    }
    if (tid < kSRows) zacc = zpre[step * M + i0 + tid];
  }
  const int k0 = (nsub - 1) * kSub;     // the last step: <= kSub keys
  st.load(raw + ((size_t)bg * (Hg + 1) + Hg) * tmax * M + i0,
          v + ((size_t)bg * L + t0) * dv, k0, tl - k0, min(tl, vl - t0), dv,
          j0, c_new, inv_sqrt_m);
  st.sum(0, tl - k0, acc, zacc);
  // S and z of the Hg heads: every load of four heads before their stores
  for (int h0 = 0; h0 < Hg; h0 += 4) {
    float sv[4][4], zv[4];
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const size_t head = (size_t)bg * Hg + h0 + hh;
      if (h0 + hh < Hg) {
        if (col) {
          const float* sp = s + (head * M + i0 + ig) * dv + j0 + jj;
#pragma unroll
          for (int u = 0; u < 4; ++u) sv[hh][u] = sp[(size_t)u * dv];
        }
        if (blockIdx.z == 0 && tid < kSRows) zv[hh] = z[head * M + i0 + tid];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const size_t head = (size_t)bg * Hg + h0 + hh;
      if (h0 + hh < Hg) {
        if (col) {
          float* sp = s + (head * M + i0 + ig) * dv + j0 + jj;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            sp[(size_t)u * dv] = sv[hh][u] * rho + acc[u];
        }
        if (blockIdx.z == 0 && tid < kSRows)
          z[head * M + i0 + tid] = zv[hh] * rho + zacc;
      }
    }
  }
  if (blockIdx.x == 0 && blockIdx.z == 0 && tid == 0) c[bg] = c_new;
  grid_dependents_launch();
}

template <typename T, int M>
int run(const void* q, const void* k, const void* v, const float* a,
        const float* m_mat, const int* valid_len, float* s, float* z,
        float* c, float* scratch, void* out, int B, int G, int Hg, int L,
        int d, int r, int dv, int chunk, int stabilize, float eps,
        float inv_sqrt_m, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  const int bgn = B * G;
  const int tmax = chunk < L ? chunk : L;
  const int pstride = (tmax + kSub - 1) / kSub - 1;   // prefix steps kept
  float* raw = scratch;
  float* pre = raw + (size_t)bgn * (Hg + 1) * tmax * M;
  float* zpre = pre + (size_t)bgn * pstride * M * dv;
  unsigned* slots =
      reinterpret_cast<unsigned*>(zpre + (size_t)bgn * pstride * M);
  float* carry = reinterpret_cast<float*>(slots + (size_t)bgn * (Hg + 1));
  const int dp = (d + kSlab - 1) / kSlab * kSlab;
  const int rp = m_mat != nullptr ? 32 * r_lanes(r) + 1 : 0;
  const size_t sh1 = sizeof(float) * (kStages * kSlab * (M + rp) +
                                      kRows * dp + 2 * kRows);
  const size_t sh3 = sizeof(float) * (2 * kQT * (M + 4) + M * kDvT +
                                      2 * kQT * kDvT + 2 * kQT * (kQT + 4) +
                                      M + kQT);
  const size_t sh24 = KeyStage<T>::bytes();
  auto k1 = logits_kernel<T, M>;
  auto k3 = output_kernel<T, M>;
  // the shared-memory limits, raised once per instance (launch 1's
  // again for a wider d)
  static size_t sh1_set = 0;
  if (sh1 > sh1_set) {
    cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sh1);
    sh1_set = sh1;
  }
  static const bool others_set = [&] {
    const void* kernels[] = {(const void*)k1, (const void*)k3,
                             (const void*)prefix_kernel<T, M>,
                             (const void*)state_kernel<T, M>};
    for (const void* f : kernels)
      cudaFuncSetAttribute(f, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
    cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sh3);
    cudaFuncSetAttribute(prefix_kernel<T, M>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sh24);
    cudaFuncSetAttribute(state_kernel<T, M>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sh24);
    return true;
  }();
  (void)others_set;
  const int dvt = (dv + kDvT - 1) / kDvT;
  for (int t0 = 0; t0 < L; t0 += chunk) {
    const int tl = L - t0 < chunk ? L - t0 : chunk;
    const int nsub = (tl + kSub - 1) / kSub;
    int err = 0;
    if (stabilize)
      err = (int)cudaMemsetAsync(slots, 0, sizeof(unsigned) * bgn * (Hg + 1),
                                 st);
    if (err) return err;
    k1<<<dim3(((Hg + 1) * tl + kRows - 1) / kRows, bgn), kThreads, sh1,
         st>>>(qt, kt, a, m_mat, valid_len, raw, slots, G, Hg, L, d, r, t0,
               tl, tmax, stabilize);
    err = (int)cudaGetLastError();
    if (err) return err;
    if (nsub > 1) {
      err = launch_after(prefix_kernel<T, M>, dim3(M / kSRows, bgn, dvt),
                         kThreads, sh24, st, vt, (const float*)raw,
                         (const unsigned*)slots, valid_len, (const float*)c,
                         pre, zpre, G, Hg, L, dv, t0, tl, tmax, nsub,
                         pstride, stabilize, inv_sqrt_m);
      if (err) return err;
    }
    err = launch_after(k3, dim3(bgn * Hg, (tl + kQT - 1) / kQT, dvt),
                       kOutThreads, sh3, st, vt, (const float*)raw,
                       (const unsigned*)slots, valid_len, (const float*)s,
                       (const float*)z, (const float*)c, (const float*)pre,
                       (const float*)zpre, carry, ot, G, Hg, L, dv, t0, tl,
                       tmax, pstride, stabilize, eps, inv_sqrt_m);
    if (err) return err;
    err = launch_after(state_kernel<T, M>, dim3(M / kSRows, bgn, dvt),
                       kThreads, sh24, st, vt, (const float*)raw, valid_len,
                       (const float*)carry, (const float*)pre,
                       (const float*)zpre, s, z, c, G, Hg, L, dv, t0, tl,
                       tmax, nsub, pstride, inv_sqrt_m);
    if (err) return err;
  }
  return 0;
}

template <typename T>
int dispatch_m(int m, const void* q, const void* k, const void* v,
               const float* a, const float* m_mat, const int* valid_len,
               float* s, float* z, float* c, float* scratch, void* out, int B,
               int G, int Hg, int L, int d, int r, int dv, int chunk,
               int stabilize, float eps, float inv_sqrt_m, cudaStream_t st) {
#define PRF_PREFILL_CASE(MM)                                                \
  case MM:                                                                  \
    return run<T, MM>(q, k, v, a, m_mat, valid_len, s, z, c, scratch, out, \
                      B, G, Hg, L, d, r, dv, chunk, stabilize, eps,         \
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

}  // namespace prefill
}  // namespace prf

// scratch: B G ((Hg + 1) T m + (ceil(T / 64) - 1) m (dv + 1) + Hg + 3)
// floats, T = min(chunk, L), 16-byte aligned: the raw logits, the prefix
// steps' kf^T v and sum kf, the max slots, then c' and rho per (b, g).
// a, v, s and z 16-byte aligned, a row of v a whole number of 16-byte
// pieces, r <= 256.
extern "C" int prf_fused_prefill(const void* q, const void* k, const void* v,
                                 const float* a, const float* m_mat,
                                 const int* valid_len, float* s, float* z,
                                 float* c, float* scratch, void* out, int B,
                                 int G, int Hg, int L, int d, int r, int m,
                                 int dv, int chunk, int bf16_inputs,
                                 int stabilize, float eps, float inv_sqrt_m,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_inputs)
    return prf::prefill::dispatch_m<__nv_bfloat16>(
        m, q, k, v, a, m_mat, valid_len, s, z, c, scratch, out, B, G, Hg, L,
        d, r, dv, chunk, stabilize, eps, inv_sqrt_m, st);
  return prf::prefill::dispatch_m<float>(
      m, q, k, v, a, m_mat, valid_len, s, z, c, scratch, out, B, G, Hg, L, d,
      r, dv, chunk, stabilize, eps, inv_sqrt_m, st);
}
