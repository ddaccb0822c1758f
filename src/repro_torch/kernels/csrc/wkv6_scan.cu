// RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel repro/kernels/wkv6_scan.py, wkv6_fwd
//   (body _kernel). Per (batch * head) row n, with a dh x dh f32 state S
//   that starts from zero:
//     o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   u is one (dh,) vector shared by every row; o is written in v's type.
//   Any dh from 1 to 128.
//
// What bounds it on the H100. At the rwkv6-7b geometry (512 rows = 64
//   heads x batch 8, L = 512, dh = 64, f32) r, k, v, w are read once and o
//   written once, 335 MB, 100 us at 3.35 TB/s; the recurrence needs about
//   5 dh^2 operations a token and row, 5.4 GFLOP, 81 us at the 67 TFLOP/s
//   of f32. Stepping the state costs f32 instructions on every element of
//   it for every token, so instruction issue, not the bytes, sets the
//   pace; the design cuts the instructions a state element takes and
//   keeps everything else a small share of them.
//
// Design: the recurrence is serial in t, so a row's tokens are walked in
//   order, with S in registers, two tokens at a step (wkv6_kernel):
//     o_t     = r_t^T S + beta_t v_t
//     o_{t+1} = (r_{t+1} * w_t)^T S + c v_t + beta_{t+1} v_{t+1}
//     S''     = (w_t * w_{t+1}) S + (k_t * w_{t+1}) v_t^T + k_{t+1} v_{t+1}^T
//   with beta_t = r_t . (u * k_t) (the bonus folded out of the state) and
//   c = r_{t+1} . k_t: five f32 instructions a state element and pair,
//   where the single-token step takes six (o's FMA, k v's product, the
//   decayed update); the pair's factors and dot products are taken once
//   per block, by 16 lanes a pair, while its run is staged. A thread holds
//   an A x C tile of S (rows d, columns e); the RG lanes of a warp that
//   share C columns hold all dh rows, so a pair costs a thread A/4 16-byte
//   reads of each factor from shared memory. o's partial sums over a
//   thread's rows are reduced over the RG lanes for RG/C tokens at once
//   by a reduce-scatter (RG - 1 shuffles in all, each lane left with one
//   finished output), not one shuffle tree per column and token. The tile
//   follows the rows: with many rows A = 8, RG = 8 (4 warps a row at dh
//   64); with too few rows to fill the card A = 4, RG = 16 (8 warps a
//   row), and column e of S and o depending only on column e of v, a
//   row's columns split over blocks (64 rows: 2 blocks a row) with runs
//   of 64 tokens, not 16. Runs of r, k, v, w are copied by cp.async, whole
//   16-byte pieces of the run's contiguous bytes (any dh, any alignment of
//   the element type), into one of two buffers while the block computes
//   on the other. f32 rows of dh 16, 32, 64 or 128 on 16-byte boundaries
//   are read where they landed (Direct); otherwise the pass also converts
//   r, k and v to f32, zero past dh, so no state row or column outside dh
//   ever moves. Outputs are staged in shared memory and written
//   coalesced. The tail of L is masked, not padded.
//
// Measured (PERF.md): the chunked form on 3xTF32 tensor cores was timed
//   beside this one and was slower: its intra-chunk decay matrix and
//   staging, not its matrix products, set its pace.
#include <atomic>
#include <cstddef>
#include <cstdint>

#include "prf_common.cuh"

namespace wkv {

using prf::from_f;
using prf::to_f;

constexpr int kUnroll = 16;    // tokens of a run unrolled at a time
constexpr int kMaxDh = 128;
constexpr int kMaxThreads = 512;
constexpr int kPl = 16;        // lanes that prepare a pair of tokens

// A thread holds A rows x C columns of S; RG lanes of a warp share
// columns and together hold kDhp = A * RG rows.
template <int A, int RG, int C>
struct Tile {
  static constexpr int kCg = 32 / RG;             // column groups a warp
  static constexpr int kWarpCols = kCg * C;       // columns a warp
  static constexpr int kDhp = A * RG;             // dh, padded
  static constexpr int kTpr = RG / C;             // tokens a reduce-scatter
  static_assert(kTpr * C == RG && kTpr % 2 == 0 && kUnroll % kTpr == 0,
                "tile");
};

// Bytes of one staged array of one run of R tokens: the run's elements
// plus the pieces a 16-byte window adds before and after them.
__host__ __device__ inline int raw_bytes(int R, int dh, int esize) {
  return (R * dh * esize + 32 + 15) / 16 * 16;
}

// The block's shared memory: the staged runs (2 buffers x r, k, v, w in
// the input type), o (R x ec), beta (R), c (R/2), u (dhp), a pair's
// r~, k~ and P (R/2 x dhp each), then, unless direct, the f32 r of its
// first token and k of its second (R/2 x dhp each) and v (R x ec).
__host__ __device__ inline size_t smem_bytes(int R, int dh, int esize,
                                             int dhp, int ec, bool direct) {
  return (size_t)8 * raw_bytes(R, dh, esize) +
         sizeof(float) *
             ((size_t)R * (ec + 1) + R / 2 + dhp + (size_t)R / 2 * 3 * dhp +
              (direct ? 0 : (size_t)R / 2 * 2 * dhp + (size_t)R * ec));
}

// Byte offset of p inside its aligned 16-byte piece.
__device__ __forceinline__ int in_piece(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// Copy elements [0, count) at src into dst as the whole 16-byte pieces
// that hold them (zero past the last element, nothing read past it; the
// first piece may start up to 15 bytes before src, inside the same
// aligned piece, so src's first element lands at dst + in_piece(src)).
template <typename T>
__device__ __forceinline__ void stage_run(unsigned char* dst, const T* src,
                                          int count) {
  const uintptr_t b = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = reinterpret_cast<uintptr_t>(src + count);
  const uintptr_t a0 = b & ~uintptr_t(15);
  const int pieces = (int)((e - a0 + 15) >> 4);
  for (int p = threadIdx.x; p < pieces; p += blockDim.x) {
    const uintptr_t s = a0 + 16 * (uintptr_t)p;
    const int nb = e - s < 16 ? (int)(e - s) : 16;
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + 16 * p);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(s), "r"(nb)
                 : "memory");
  }
}

// The A rows of lane rg of a column group, from a token's f32 row of a
// factor: vectors of V = min(A, 4) rows at q * RG * V + rg * V, so that
// the RG lanes read one contiguous stretch per vector (RG = 1: A
// consecutive floats).
template <int A, int RG>
__device__ __forceinline__ void load_rows(const float* run, int rg,
                                          float (&x)[A]) {
  constexpr int V = A < 4 ? A : 4;
#pragma unroll
  for (int q = 0; q < A / V; ++q) {
    const float* p = run + q * RG * V + rg * V;
    if constexpr (V == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      x[4 * q] = t.x; x[4 * q + 1] = t.y; x[4 * q + 2] = t.z;
      x[4 * q + 3] = t.w;
    } else if constexpr (V == 2) {
      const float2 t = *reinterpret_cast<const float2*>(p);
      x[2 * q] = t.x; x[2 * q + 1] = t.y;
    } else {
      x[q] = *p;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_rows(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4)
      *reinterpret_cast<float4*>(p + q) =
          make_float4(x[q], x[q + 1], x[q + 2], x[q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) p[q] = x[q];
  }
}

// Rows d0 .. d0 + N - 1 of one staged token (dh elements of T at row),
// as f32: `fill` where the token lies past L or the row past dh. Direct:
// f32 rows of dh = kDhp on 16-byte boundaries, read as vectors, and a
// token past L is left as it lies (whatever it holds reaches only the
// outputs past L, which are not written, and the state after the last
// token).
template <bool Direct, int N, typename T>
__device__ __forceinline__ void load_token(const T* row, int d0, int dh,
                                           bool live, float fill,
                                           float (&x)[N]) {
  if constexpr (Direct) {
    load_rows<N, 1>(reinterpret_cast<const float*>(row) + d0, 0, x);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      x[i] = live && d0 + i < dh ? to_f(row[d0 + i]) : fill;
  }
}

// a where mask is all ones, b where it is zero: one LOP3, written in PTX so
// that the compiler cannot turn a select between two entries of a
// register array into an indexed load of the array from local memory
__device__ __forceinline__ float pick(int mask, float a, float b) {
  int x;
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;"
      : "=r"(x)
      : "r"(__float_as_int(a)), "r"(__float_as_int(b)), "r"(mask));
  return __int_as_float(x);
}

// v[0..V) summed over the N lanes lane ^ 1 .. lane ^ N/2 and scattered:
// lane index g (lane % N) is left with the sums of entries g * V/N ..
// (g + 1) * V/N - 1 in v[0..V/N). Each step halves the entries (M of them
// kept): lanes with bit H of g keep the upper half and send the lower;
// each loop's bound is a constant, so v stays in registers.
template <int M, int H, int V>
__device__ __forceinline__ void reduce_step(float (&v)[V], int g) {
  if constexpr (H >= 1) {
    const int up = -((g & H) != 0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float send = pick(up, v[i], v[i + M]);
      const float keep = pick(up, v[i + M], v[i]);
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
    }
    reduce_step<M / 2, H / 2>(v, g);
  }
}

template <int N, int V>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int g) {
  static_assert(V % N == 0, "reduce_scatter");
  reduce_step<V / 2, N / 2>(v, g);
}

// Copy elements [0, count) of one run of each of r, k, v, w (at offset off
// of their rows) into the staging buffer buf (4 x rawb bytes).
template <typename T>
__device__ __forceinline__ void issue_run(unsigned char* buf, int rawb,
                                          const T* r, const T* k, const T* v,
                                          const T* w, size_t off, int count) {
  stage_run(buf, r + off, count);
  stage_run(buf + rawb, k + off, count);
  stage_run(buf + 2 * rawb, v + off, count);
  stage_run(buf + 3 * rawb, w + off, count);
  prf::cp_async_commit();
}

// Tokens [0, cnt) of a run's staged outputs os (R x ec) to o from op (the
// block's first column of the run's first token), coalesced: where
// Direct (f32, the block's columns all inside dh, o on a 16-byte
// boundary) 4 columns a thread in 16-byte stores, else column tid % ec
// of tokens tid / ec, tid / ec + nt / ec, ... (`in`: that column < dh).
template <bool Direct, typename T>
__device__ __forceinline__ void write_out(T* op, const float* os, int cnt,
                                          int ec, int dh, bool in) {
  const int nt = blockDim.x, tid = threadIdx.x;
  if constexpr (Direct) {
    const int nv = ec / 4, e = tid % nv * 4;
    for (int t = tid / nv; t < cnt; t += nt / nv)
      *reinterpret_cast<float4*>(op + (size_t)t * dh + e) =
          *reinterpret_cast<const float4*>(os + t * ec + e);
  } else if (in) {
    const int e = tid % ec;
    for (int t = tid / ec; t < cnt; t += nt / ec)
      op[(size_t)t * dh + e] = from_f<T>(os[t * ec + e]);
  }
}

// One block: row n = blockIdx.x / slices, columns [e0, e0 + ec) with ec =
// (blockDim.x / 32) * kWarpCols. Tokens go in pairs (t, t + 1) = (2q,
// 2q + 1): with r~ = r_{t+1} * w_t, k~ = k_t * w_{t+1}, P = w_t * w_{t+1},
// c = r_{t+1} . k_t,
//   o_t     = r_t^T S + beta_t v_t
//   o_{t+1} = r~^T S + c v_t + beta_{t+1} v_{t+1}
//   S''     = P S + k~ v_t^T + k_{t+1} v_{t+1}^T
// (S the state before t): five f32 instructions a state element and pair
// where the token steps take six. Direct: f32 rows of dh = kDhp, every
// array on a 16-byte boundary, so the tiles read r_t, k_{t+1} and v from
// the staged bytes; else a pass converts those to f32 too.
template <typename T, int A, int RG, int C, int R, bool Direct>
__global__ void __launch_bounds__(kMaxThreads) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const float* __restrict__ u, T* __restrict__ o,
    int L, int dh, int slices) {
  using Tl = Tile<A, RG, C>;
  constexpr int DHP = Tl::kDhp;
  static_assert(R % kUnroll == 0, "run");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, ec = (nt >> 5) * Tl::kWarpCols;
  const int n = blockIdx.x / slices;
  const int e0 = blockIdx.x % slices * ec;
  const size_t base = (size_t)n * L * dh;
  const int rawb = raw_bytes(R, dh, sizeof(T));
  float* os = reinterpret_cast<float*>(smem + 8 * rawb);
  float* bs = os + R * ec;
  float* cs = bs + R;
  float* us = cs + R / 2;
  float* rts = us + DHP;            // a pair's r~, k~, P
  float* kts = rts + R / 2 * DHP;
  float* ps = kts + R / 2 * DHP;
  float* r0s = ps + R / 2 * DHP;    // unless Direct: r_t, k_{t+1}, v in f32
  float* k1s = r0s + R / 2 * DHP;
  float* vs = k1s + R / 2 * DHP;
  for (int d = tid; d < DHP; d += nt) us[d] = d < dh ? u[d] : 0.f;

  const int rg = lane % RG, cg = lane / RG;
  const int col = (warp * Tl::kCg + cg) * C;   // the thread's first column
  float st[A][C];
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) st[i][j] = 0.f;

  // v of a run is converted by thread (t, e): column e = tid % ec of
  // tokens tid / ec, tid / ec + kStep, ... (nt = kStep * ec)
  constexpr int kStep = 32 / Tl::kWarpCols;
  const int ce = tid % ec, ct = tid / ec;
  const bool cin = e0 + ce < dh;
  const int nruns = (L + R - 1) / R;
  issue_run(smem, rawb, r, k, v, w, base, min(R, L) * dh);
  for (int run = 0; run < nruns; ++run) {
    const int t0 = run * R, len = min(R, L - t0);
    prf::cp_async_wait<0>();
    __syncthreads();      // run's bytes landed; the last run's o staged
    if (run + 1 < nruns)
      issue_run(smem + ((run + 1) & 1) * 4 * rawb, rawb, r, k, v, w,
                base + (size_t)(t0 + R) * dh, min(R, L - t0 - R) * dh);
    if (run > 0)          // the last run's outputs, coalesced
      write_out<Direct>(o + base + (size_t)(t0 - R) * dh + e0, os, R, ec,
                        dh, cin);
    // a pair's r~, k~, P, beta_t, beta_{t+1} and c by kPl lanes (lane j
    // rows j * PV .. j * PV + PV - 1), zero past dh; past L r = k = 0 and
    // w = 1. Unless Direct, r_t, k_{t+1} and v in f32 too.
    const size_t off = base + (size_t)t0 * dh;
    const unsigned char* buf = smem + (run & 1) * 4 * rawb;
    const T* rr = reinterpret_cast<const T*>(buf + in_piece(r + off));
    const T* kk = reinterpret_cast<const T*>(buf + rawb + in_piece(k + off));
    const T* vv =
        reinterpret_cast<const T*>(buf + 2 * rawb + in_piece(v + off));
    const T* ww =
        reinterpret_cast<const T*>(buf + 3 * rawb + in_piece(w + off));
    {
      constexpr int PV = DHP / kPl;
      const int j = tid % kPl, d0 = j * PV;
      float uu[PV];
      load_rows<PV, 1>(us + d0, 0, uu);
      for (int q = tid / kPl; q < R / 2; q += nt / kPl) {
        const int t = 2 * q;
        const bool l0 = t < len, l1 = t + 1 < len;
        float r0[PV], r1[PV], k0[PV], k1[PV], w0[PV], w1[PV];
        load_token<Direct, PV>(rr + t * dh, d0, dh, l0, 0.f, r0);
        load_token<Direct, PV>(kk + t * dh, d0, dh, l0, 0.f, k0);
        load_token<Direct, PV>(ww + t * dh, d0, dh, l0, 1.f, w0);
        load_token<Direct, PV>(rr + (t + 1) * dh, d0, dh, l1, 0.f, r1);
        load_token<Direct, PV>(kk + (t + 1) * dh, d0, dh, l1, 0.f, k1);
        load_token<Direct, PV>(ww + (t + 1) * dh, d0, dh, l1, 1.f, w1);
        float b0 = 0.f, b1 = 0.f, cq = 0.f, rt[PV], kt[PV], pw[PV];
#pragma unroll
        for (int i = 0; i < PV; ++i) {
          b0 = fmaf(r0[i], uu[i] * k0[i], b0);
          b1 = fmaf(r1[i], uu[i] * k1[i], b1);
          cq = fmaf(r1[i], k0[i], cq);
          rt[i] = r1[i] * w0[i];
          kt[i] = k0[i] * w1[i];
          pw[i] = w0[i] * w1[i];
        }
        store_rows<PV>(rts + q * DHP + d0, rt);
        store_rows<PV>(kts + q * DHP + d0, kt);
        store_rows<PV>(ps + q * DHP + d0, pw);
        if constexpr (!Direct) {
          store_rows<PV>(r0s + q * DHP + d0, r0);
          store_rows<PV>(k1s + q * DHP + d0, k1);
        }
#pragma unroll
        for (int h = kPl / 2; h >= 1; h /= 2) {
          b0 += __shfl_xor_sync(0xffffffffu, b0, h);
          b1 += __shfl_xor_sync(0xffffffffu, b1, h);
          cq += __shfl_xor_sync(0xffffffffu, cq, h);
        }
        if (j == 0) {
          bs[t] = b0;
          bs[t + 1] = b1;
          cs[q] = cq;
        }
      }
      if constexpr (!Direct) {
#pragma unroll 4
        for (int t = ct; t < R; t += kStep)
          vs[t * ec + ce] =
              t < len && cin ? to_f(vv[t * dh + e0 + ce]) : 0.f;
      }
    }
    // the f32 rows the tiles read: r_t and k_{t+1} of pair q at q * pst
    // (k_{t+1} from k1p), v of token t at t * vst
    const float* r0p = Direct ? reinterpret_cast<const float*>(rr) : r0s;
    const float* k1p =
        Direct ? reinterpret_cast<const float*>(kk) + DHP : k1s;
    const int pst = Direct ? 2 * DHP : DHP;
    const float* vf = Direct ? reinterpret_cast<const float*>(vv) + e0 : vs;
    const int vst = Direct ? dh : ec;
    __syncthreads();      // the pairs' factors ready
#pragma unroll 1
    for (int tu = 0; tu < R; tu += kUnroll)
#pragma unroll
    for (int t = tu; t < tu + kUnroll; t += Tl::kTpr) {
      float p[RG];
#pragma unroll
      for (int pp = 0; pp < Tl::kTpr; pp += 2) {
        const int q = (t + pp) / 2;
        float r0[A], rt[A], kt[A], k1[A], pw[A], v0[C], v1[C];
        load_rows<A, RG>(r0p + q * pst, rg, r0);
        load_rows<A, RG>(rts + q * DHP, rg, rt);
        load_rows<A, RG>(kts + q * DHP, rg, kt);
        load_rows<A, RG>(k1p + q * pst, rg, k1);
        load_rows<A, RG>(ps + q * DHP, rg, pw);
        load_rows<C, 1>(vf + (t + pp) * vst + col, 0, v0);
        load_rows<C, 1>(vf + (t + pp + 1) * vst + col, 0, v1);
#pragma unroll
        for (int jj = 0; jj < C; ++jj) {
          float a0 = 0.f, a1 = 0.f;
#pragma unroll
          for (int i = 0; i < A; ++i) {
            a0 = fmaf(r0[i], st[i][jj], a0);
            a1 = fmaf(rt[i], st[i][jj], a1);
          }
          p[pp * C + jj] = a0;
          p[(pp + 1) * C + jj] = a1;
        }
#pragma unroll
        for (int i = 0; i < A; ++i)
#pragma unroll
          for (int jj = 0; jj < C; ++jj)
            st[i][jj] = fmaf(k1[i], v1[jj],
                             fmaf(kt[i], v0[jj], pw[i] * st[i][jj]));
      }
      reduce_scatter<RG>(p, rg);
      // lane rg: token tt, column c; o_{t+1} also takes c v_t
      const int tt = t + rg / C, c = col + rg % C;
      const float codd = tt & 1 ? cs[tt >> 1] : 0.f;
      os[tt * ec + c] =
          fmaf(bs[tt], vf[tt * vst + c],
               fmaf(codd, vf[(tt & ~1) * vst + c], p[0]));
    }
  }
  __syncthreads();
  const int p0 = (nruns - 1) * R;
  write_out<Direct>(o + base + (size_t)p0 * dh + e0, os, L - p0, ec, dh,
                    cin);
}

constexpr int kMaxDevices = 64;    // devices whose facts are cached

// The current device and its SM count, asked of CUDA once a device.
inline int device_sms(int* dev, int* sms) {
  static std::atomic<int> cached[kMaxDevices];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev < kMaxDevices && (*sms = cached[*dev].load()) > 0) return 0;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess && *dev < kMaxDevices) cached[*dev].store(*sms);
  return (int)err;
}

template <typename T, int A, int RG, int C, int R>
int launch_run(const T* r, const T* k, const T* v, const T* w, const float* u,
               T* o, int N, int L, int dh, int slices, int warps, int ec,
               bool direct, int dev, cudaStream_t st) {
  // the most dynamic shared memory each variant has been allowed a device
  static std::atomic<int> allowed[2][kMaxDevices];
  const int shmem =
      (int)smem_bytes(R, dh, sizeof(T), Tile<A, RG, C>::kDhp, ec, direct);
  auto kern = wkv6_kernel<T, A, RG, C, R, false>;
  if constexpr (sizeof(T) == 4) {
    if (direct) kern = wkv6_kernel<T, A, RG, C, R, true>;
  }
  std::atomic<int>* seen = dev < kMaxDevices ? &allowed[direct][dev] : nullptr;
  if (!seen || seen->load() < shmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
    if (err != cudaSuccess) return (int)err;
    if (seen) seen->store(shmem);
  }
  kern<<<(unsigned)N * slices, warps * 32, shmem, st>>>(r, k, v, w, u, o, L,
                                                         dh, slices);
  return (int)cudaGetLastError();
}

// Split a row's columns over `slices` blocks while the rows alone fill
// fewer than the card's SMs (slices a power of two, at most one warp of
// columns a block), and over as many as keep a block within kMaxThreads
// (dh 65..128 takes 17..32 warps a row); direct where the rows are f32 of
// width kDhp on 16-byte boundaries; runs of 64 tokens where a block has a
// SM to itself and they fit (fewer barriers a token), else of 16 (more
// blocks a SM).
template <typename T, int A, int RG, int C = 4>
int launch(const T* r, const T* k, const T* v, const T* w, const float* u,
           T* o, int N, int L, int dh, int dev, int sms, cudaStream_t st) {
  using Tl = Tile<A, RG, C>;
  constexpr size_t kMaxShmem = 232448;         // a block's, on sm_90
  constexpr int kMaxWarps = kMaxThreads / 32;
  const int wpr = (dh + Tl::kWarpCols - 1) / Tl::kWarpCols;  // warps a row
  int slices = 1;
  while (2 * slices <= wpr && (long long)N * 2 * slices <= sms) slices *= 2;
  if (slices * kMaxWarps < wpr) slices = (wpr + kMaxWarps - 1) / kMaxWarps;
  const int warps = (wpr + slices - 1) / slices;
  const int ec = warps * Tl::kWarpCols;
  slices = (dh + ec - 1) / ec;
  const bool direct =
      sizeof(T) == 4 && dh == Tl::kDhp &&
      ((uintptr_t)r | (uintptr_t)k | (uintptr_t)v | (uintptr_t)w |
       (uintptr_t)o) % 16 == 0;
  if ((long long)N * slices <= sms &&
      smem_bytes(64, dh, sizeof(T), Tl::kDhp, ec, direct) <= kMaxShmem)
    return launch_run<T, A, RG, C, 64>(r, k, v, w, u, o, N, L, dh, slices,
                                       warps, ec, direct, dev, st);
  return launch_run<T, A, RG, C, 16>(r, k, v, w, u, o, N, L, dh, slices,
                                     warps, ec, direct, dev, st);
}

// The tile by width: rows padded to 16, 32, 64 or 128; at dh 33..64 the
// larger tile (8 rows, 8 lanes a column group: 4 warps a row) once the
// rows give the card four such warps a SM, else 4 rows x 16 lanes (8
// warps a row, split over blocks). check.wkv6_tile mirrors this rule for
// the tests' model of the kernel's order; change both together.
template <typename T>
int launch_width(const void* r, const void* k, const void* v, const void* w,
                 const float* u, void* o, int N, int L, int dh,
                 cudaStream_t st) {
  int dev = 0, sms = 0;
  const int err = device_sms(&dev, &sms);
  if (err != 0) return err;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(o);
  if (dh <= 16)
    return launch<T, 2, 8>(rt, kt, vt, wt, u, ot, N, L, dh, dev, sms, st);
  if (dh <= 32)
    return launch<T, 4, 8>(rt, kt, vt, wt, u, ot, N, L, dh, dev, sms, st);
  if (dh <= 64) {
    if ((long long)N * ((dh + 15) / 16) >= 4LL * sms)
      return launch<T, 8, 8>(rt, kt, vt, wt, u, ot, N, L, dh, dev, sms, st);
    return launch<T, 4, 16>(rt, kt, vt, wt, u, ot, N, L, dh, dev, sms, st);
  }
  return launch<T, 8, 16, 2>(rt, kt, vt, wt, u, ot, N, L, dh, dev, sms, st);
}

}  // namespace wkv

// r, k, v, w: (N, L, dh) in one type, f32 or bf16; u: (dh) f32; o: (N, L,
// dh) in that type. dh from 1 to 128 (cudaErrorInvalidValue above).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const float* u, void* o, int N, int L,
                        int dh, int bf16, void* stream) {
  if (dh < 1 || dh > wkv::kMaxDh) return (int)cudaErrorInvalidValue;
  if (N == 0 || L == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return wkv::launch_width<__nv_bfloat16>(r, k, v, w, u, o, N, L, dh, st);
  return wkv::launch_width<float>(r, k, v, w, u, o, N, L, dh, st);
}
