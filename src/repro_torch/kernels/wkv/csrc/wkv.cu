// Chunked RWKV-6 WKV forward for Hopper: three launches a call.
//
// Replaces the TPU kernel repro/kernels/wkv/kernel.py::_wkv_kernel (built by
// build_wkv_call).  Per (batch, head), over chunks of C rows, with the
// (D, D) fp32 state S carried from chunk to chunk:
//
//   o_t   = sum_{s<t} (sum_d r[t,d] k[s,d] A[t-1,d]/A[s,d]) v_s
//           + ((u . r_t) . k_t) v_t + (r_t . A[t-1]) S_in
//   S_out = A[C-1] . S_in + sum_s (k_s . A[C-1]/A[s]) v_s^T
//
// with A[t] the in-chunk cumulative product of the decay w (A[-1] = 1).  The
// TPU kernel factors the pair term as (r . A[t-1]) (k / A[s])^T, and k / A[s]
// grows as w^-C across a chunk: fp32 overflows once w falls below about
// 0.25 at C = 64.  Here every decay factor is exp2 of a non-positive
// difference of the in-chunk cumulative log2 decay L[t] = sum_{u<=t} log2 w_u,
// so nothing can overflow:
//   * a pair (t, s), s < t, in a 4x4 tile on the diagonal gets
//     exp2(L[t-1] - L[s]) itself;  a tile (I, J) below the diagonal is split
//     at m = L[4I-1], the row before its first row, into
//     exp2(L[t-1] - m) * exp2(m - L[s]), both factors <= 1 (s <= 4I-1 <= t-1);
//   * the cross term reads r . exp2(L[t-1]);
//   * the state increment reads k . exp2(L[C-1] - L[s]), the decay of the
//     state exp2(L[C-1]).
// It is the same function; where the TPU kernel's form stays finite the two
// agree to rounding.
//
// Why three launches.  The Pallas grid (B*H, n_chunks) runs in order on one
// core, so the TPU kernel carries S from chunk to chunk in VMEM.  Blocks on
// Hopper run in parallel and in no order, and a block that walks the chunks
// itself leaves B*H blocks for 132 SMs and a serial chain of n_chunks steps.
// Only the state depends on the chunks before; the rest of a chunk's work
// depends on its own rows.  So:
//   1. wkv_states_kernel, one block per (b*h, chunk): L, A_c = exp2(L[C-1])
//      and the chunk's state increment dS_c = sum_s (k_s . exp2(L[C-1] -
//      L[s])) v_s^T into a (B*H, n_chunks, D, D) fp32 workspace;
//   2. wkv_scan_kernel, one thread per (b*h, d, e) state element, over the
//      chunks in order: it writes S_in of chunk c over dS_c and steps
//      S <- fmaf(A_c[d], S, dS_c).  The scan is sequential per element, with
//      no parallel-prefix reassociation, so a call that starts from another
//      call's final state does the arithmetic of one call over both;
//   3. wkv_outputs_kernel, one block per (b*h, chunk): L again (cheaper than
//      storing it), the strictly-lower pair matrix P with the bonus diagonal,
//      and o = P v + (r . exp2(L[t-1])) S_in.
// At rwkv6-3b's shape (B*H 40, S 4096, D 64, C 64) that is 2,560 blocks for
// launches 1 and 3.
//
// Inside a block: the products are fp32 FMAs on the CUDA cores, each thread
// holding a 4x4 tile of outputs in registers and reading its operands as
// float4 rows of shared memory.  A block issues all its global loads before
// it stores any, so it waits on memory once.  Launch 3 keeps r, k, L and the
// row-factored r transposed ([d][t]), so that a 4x4 pair tile reads its four
// rows at one d in one load; it keeps r and k in their input type, and lays
// v and S_in over dead regions once the pair matrix is done, which leaves
// 70 KB a block at bf16 and three blocks an SM.  The tiles below the
// diagonal, the diagonal tiles and the bonus diagonal run on warps of their
// own, so no warp runs both branches.
//
// Layout: r, k, v and w are read in place through (b, s, h) strides with d
// contiguous (every stride a multiple of 4 and the rows aligned, so that
// four elements load at once; the wrapper copies what is not), so the
// model's (B, S, H, D) projections go in without a transposing copy, and o
// is written through its own strides.  u is (H, D), indexed by head; the
// states are (B, H, D, D) fp32, contiguous.  r, k, v are fp32 or bf16 and o
// is fp32 or r's type; w is fp32, and all arithmetic is fp32.  D and C are
// 16, 32 or 64.
//
// What bounds it on an H100, at the LM path's shape and types (bf16 r, k,
// v, fp32 w and o): the function reads r, k, v, w once and writes o once,
// 148.1 MB with the states (0.0442 ms at 3.35 TB/s), and needs 4.06 GFLOP
// (per chunk 2*D*C*(C-1) for the pairs and P v, 5*C*D for the bonus
// diagonal, 4*C*D^2 for r S_in and the state increment), 0.0606 ms at the
// 67 TFLOP/s fp32 rate of the CUDA cores: it is bound by operations.  The
// three launches move more: the workspace's round trip (written by launch
// 1, read and written by the scan, read by launch 3: about 168 MB), w read
// twice and k, v read twice, about 400 MB in all; and they pay exp2 per
// (pair, d) on the diagonal tiles and per (column, d) of a tile elsewhere,
// about 49 k a chunk, and log2 twice per element.  A block's loads and its
// products overlap only across the blocks of an SM.  Left for later steps:
// the products on the tensor cores (bf16 mma or wgmma with fp32 sums) with
// loads kept in flight (TMA or cp.async), and a sub-chunk factorisation of
// the pair matrix that pays fewer exps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

constexpr int WKV_THREADS = 256;       // launches 1 and 3
constexpr int WKV_SCAN_THREADS = 256;  // launch 2
constexpr int WKV_SCAN_UNROLL = 8;     // chunks a scan thread loads at once
constexpr int WKV_MAX_CHUNKS = 65535;  // grid.y of launches 1 and 3
constexpr int WKV_MAX_DEVICES = 64;

// Keep in step with ``_Args`` in kernel.py.
struct WkvArgs {
  const void* r;
  const void* k;
  const void* v;
  const float* w;             // decay in (0, 1)
  const float* u;             // (H, D) bonus
  const float* s_in;          // (B, H, D, D)
  void* o;
  float* s_out;               // (B, H, D, D)
  float* ws;                  // (B*H, n_chunks, D, D): dS_c, then S_in of c
  float* a_end;               // (B*H, n_chunks, D): exp2(L[C-1]) of chunk c
  int64_t r_sb, r_ss, r_sh;   // strides in elements of (b, s, h); d is 1
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t w_sb, w_ss, w_sh;
  int64_t o_sb, o_ss, o_sh;
  int32_t heads;              // H
  int32_t nbh;                // B * H
  int32_t seq;                // S, a multiple of the chunk
};

// Four consecutive elements as one load brings them: a float4, or four
// bf16 in a uint2.
template <typename T>
struct WkvVec {
  using type = float4;
};
template <>
struct WkvVec<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ float4 wkv_float4(float4 x) { return x; }
__device__ __forceinline__ float4 wkv_float4(uint2 raw) {
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float wkv_float(float x) { return x; }
__device__ __forceinline__ float wkv_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive elements from global or shared memory, as fp32.
template <typename T>
__device__ __forceinline__ float4 wkv_load4(const T* p) {
  return wkv_float4(*reinterpret_cast<const typename WkvVec<T>::type*>(p));
}

// 2^x on the SFU (ex2.approx.ftz.f32: a relative error of about 2^-22, as
// exp2f's).  Every argument here is <= 0, so the result is in [0, 1]; one
// below 2^-126 flushes to 0.
__device__ __forceinline__ float wkv_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wkv_store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void wkv_store4(__nv_bfloat16* p,
                                           const float (&x)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(x[0], x[1]);
  q[1] = __floats2bfloat162_rn(x[2], x[3]);
}

// acc[i][j] += a[i] * b[j]
__device__ __forceinline__ void wkv_outer(float (&acc)[4][4], float4 a,
                                          float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// float4s a thread of a chunk's C x D rows
template <int C, int D>
__host__ __device__ constexpr int wkv_vecs() {
  return (C * D / 4 + WKV_THREADS - 1) / WKV_THREADS;
}

// Where quad e (four consecutive d) of a chunk's C x D rows lies: row t,
// columns d0..d0+3.  Row-major (TR false), consecutive threads walk a row.
// For a store transposed into a [d][t] array (TR true), a warp takes 8 rows
// of 4 quads, so that its stores fall in 16 banks.
template <int C, int D, bool TR>
__device__ __forceinline__ void wkv_quad(int e, int* t, int* d0) {
  constexpr int Q = D / 4;
  if (TR) {
    const int lane = e % 32, wi = e / 32;
    *t = (wi % (C / 8)) * 8 + lane % 8;
    *d0 = ((wi / (C / 8)) * 4 + lane / 8) * 4;
  } else {
    *t = e / Q;
    *d0 = (e % Q) * 4;
  }
}

// Issues the loads of the chunk's rows [t0, t0 + C) of a (b, s, h)-strided
// tensor, four elements a load, into registers as they come: a block
// fetches all its inputs before it stores any, so they wait on memory once.
template <int C, int D, bool TR, typename T>
__device__ __forceinline__ void wkv_fetch(
    typename WkvVec<T>::type (&buf)[wkv_vecs<C, D>()], const T* src,
    int64_t ss) {
#pragma unroll
  for (int j = 0; j < wkv_vecs<C, D>(); ++j) {
    const int e = threadIdx.x + j * WKV_THREADS;
    if (e < C * D / 4) {
      int t, d0;
      wkv_quad<C, D, TR>(e, &t, &d0);
      buf[j] = *reinterpret_cast<const typename WkvVec<T>::type*>(
          src + t * ss + d0);
    }
  }
}

// Stores fetched rows into shared memory as fp32, [t][d] (TR false) or
// [d][t] (TR true), pitch P; f applies to each element.
template <int C, int D, bool TR, int P, typename V, typename F>
__device__ __forceinline__ void wkv_put(float* dst,
                                        const V (&buf)[wkv_vecs<C, D>()],
                                        F f) {
#pragma unroll
  for (int j = 0; j < wkv_vecs<C, D>(); ++j) {
    const int e = threadIdx.x + j * WKV_THREADS;
    if (e < C * D / 4) {
      int t, d0;
      wkv_quad<C, D, TR>(e, &t, &d0);
      const float4 v = wkv_float4(buf[j]);
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dst[TR ? (d0 + c) * P + t : t * P + d0 + c] = f(x[c]);
    }
  }
}

// Stores fetched rows into shared memory as they came (type T),
// transposed: [d][t], pitch P.
template <int C, int D, int P, typename T>
__device__ __forceinline__ void wkv_put_t(
    T* dst, const typename WkvVec<T>::type (&buf)[wkv_vecs<C, D>()]) {
#pragma unroll
  for (int j = 0; j < wkv_vecs<C, D>(); ++j) {
    const int e = threadIdx.x + j * WKV_THREADS;
    if (e < C * D / 4) {
      int t, d0;
      wkv_quad<C, D, true>(e, &t, &d0);
      const T* x = reinterpret_cast<const T*>(&buf[j]);
#pragma unroll
      for (int c = 0; c < 4; ++c) dst[(d0 + c) * P + t] = x[c];
    }
  }
}

struct WkvIdentity {
  __device__ float operator()(float x) const { return x; }
};
struct WkvLog2 {
  __device__ float operator()(float x) const { return log2f(x); }
};

// sL holds log2 w on entry and L on exit, element (t, d) at t * ST + d * SD.
// Each column is cut into NS segments, one thread each, summed in order;
// then each segment adds the totals of the segments before it, in order.
// Both chunk kernels call this, so they derive the same L bit for bit.
// Ends with a barrier.  sTot holds NS * D floats (at most WKV_THREADS).
template <int C, int D, int ST, int SD>
__device__ __forceinline__ void wkv_cumsum(float* sL, float* sTot) {
  constexpr int SEG = WKV_THREADS / D;
  constexpr int NS = SEG < C ? SEG : C;
  constexpr int LEN = C / NS;
  const int d = threadIdx.x % D, g = threadIdx.x / D;
  float* col = sL + g * LEN * ST + d * SD;
  if (g < NS) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < LEN; ++t) {
      acc += col[t * ST];
      col[t * ST] = acc;
    }
    sTot[g * D + d] = acc;
  }
  __syncthreads();
  if (g < NS && g > 0) {
    float off = 0.f;
    for (int j = 0; j < g; ++j) off += sTot[j * D + d];
#pragma unroll
    for (int t = 0; t < LEN; ++t) col[t * ST] += off;
  }
  __syncthreads();
}

// The paper's 2D triangular map at tile granularity: lambda -> (I, J),
// J <= I, for the lower-triangular 4x4 tiles of the pair matrix.
__device__ __forceinline__ void wkv_tile_ij(int lam, int* I, int* J) {
  int i = (int)((sqrtf(8.f * (float)lam + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= lam) ++i;
  while (i * (i + 1) / 2 > lam) --i;
  *I = i;
  *J = lam - i * (i + 1) / 2;
}

// -- launch 1: the chunk's decay and state increment -------------------------

__host__ __device__ constexpr int wkv_states_smem_floats(int C, int D) {
  return 3 * C * D + WKV_THREADS;  // sK, sV, sL; sTot
}

template <typename T, int C, int D>
__global__ void __launch_bounds__(WKV_THREADS, sizeof(T) == 2 ? 4 : 3)
    wkv_states_kernel(WkvArgs a) {
  static_assert((D / 4) * (D / 4) <= WKV_THREADS, "a 4x4 tile per thread");
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;              // k, then k . exp2(L[C-1] - L[s])
  float* sV = sK + C * D;
  float* sL = sV + C * D;        // log2 w, then L
  float* sTot = sL + C * D;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, ch = blockIdx.y, nc = gridDim.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int64_t t0 = (int64_t)ch * C;
  const T* k = (const T*)a.k + b * a.k_sb + h * a.k_sh + t0 * a.k_ss;
  const T* v = (const T*)a.v + b * a.v_sb + h * a.v_sh + t0 * a.v_ss;
  const float* w = a.w + b * a.w_sb + h * a.w_sh + t0 * a.w_ss;

  typename WkvVec<T>::type fk[wkv_vecs<C, D>()], fv[wkv_vecs<C, D>()];
  float4 fw[wkv_vecs<C, D>()];
  wkv_fetch<C, D, false>(fk, k, a.k_ss);
  wkv_fetch<C, D, false>(fv, v, a.v_ss);
  wkv_fetch<C, D, false>(fw, w, a.w_ss);
  wkv_put<C, D, false, D>(sK, fk, WkvIdentity());
  wkv_put<C, D, false, D>(sV, fv, WkvIdentity());
  wkv_put<C, D, false, D>(sL, fw, WkvLog2());
  __syncthreads();
  wkv_cumsum<C, D, D, 1>(sL, sTot);
  for (int e = tid; e < C * D; e += WKV_THREADS)
    sK[e] *= wkv_exp2(sL[(C - 1) * D + e % D] - sL[e]);
  if (tid < D)
    a.a_end[((int64_t)bh * nc + ch) * D + tid] =
        wkv_exp2(sL[(C - 1) * D + tid]);
  __syncthreads();

  // dS[d][e] = sum_s k'[s][d] v[s][e], a 4x4 (d, e) tile per thread
  constexpr int Q = D / 4;
  if (tid < Q * Q) {
    const int d0 = (tid / Q) * 4, e0 = (tid % Q) * 4;
    float acc[4][4] = {};
#pragma unroll 8
    for (int s = 0; s < C; ++s)
      wkv_outer(acc, *reinterpret_cast<const float4*>(sK + s * D + d0),
                *reinterpret_cast<const float4*>(sV + s * D + e0));
    float* ws = a.ws + ((int64_t)bh * nc + ch) * D * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) wkv_store4(ws + (d0 + i) * D + e0, acc[i]);
  }
}

// -- launch 2: the state scan ------------------------------------------------

template <int D>
__global__ void __launch_bounds__(WKV_SCAN_THREADS)
    wkv_scan_kernel(WkvArgs a, int nc) {
  constexpr int DD = D * D;
  const int64_t i = (int64_t)blockIdx.x * WKV_SCAN_THREADS + threadIdx.x;
  if (i >= (int64_t)a.nbh * DD) return;
  const int64_t bh = i / DD;
  const int de = (int)(i % DD);
  float* ws = a.ws + bh * nc * DD + de;
  const float* ae = a.a_end + bh * nc * D + de / D;
  float S = a.s_in[i];
  // the loads of the next group of chunks go out before this group's steps
  constexpr int U = WKV_SCAN_UNROLL;
  float ds[U], ac[U];
  int c = 0;
  if (nc >= U) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      ds[j] = ws[(int64_t)j * DD];
      ac[j] = ae[(int64_t)j * D];
    }
  }
  for (; c + U <= nc; c += U) {
    float dn[U], an[U];
    const bool more = c + 2 * U <= nc;
    if (more) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        dn[j] = ws[(int64_t)(c + U + j) * DD];
        an[j] = ae[(int64_t)(c + U + j) * D];
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      ws[(int64_t)(c + j) * DD] = S;
      S = fmaf(ac[j], S, ds[j]);
    }
    if (more) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        ds[j] = dn[j];
        ac[j] = an[j];
      }
    }
  }
  for (; c < nc; ++c) {
    const float d1 = ws[(int64_t)c * DD], a1 = ae[(int64_t)c * D];
    ws[(int64_t)c * DD] = S;
    S = fmaf(a1, S, d1);
  }
  a.s_out[i] = S;
}

// -- launch 3: the chunk's outputs -------------------------------------------

__host__ __device__ constexpr int wkv_max(int x, int y) {
  return x > y ? x : y;
}

// r, k, L and the row-factored r are held transposed, [d][t] with pitch
// P = C + 4, so that a 4x4 tile reads its four rows at one d in one load;
// r and k stay in their input type.  Regions, in order:
//   r^T, k^T (T)                 later S_in [d][e], pitch D
//   L^T                          later v [t][e], pitch D
//   (r . exp2(L[t-1] - L[4I-1]))^T   later r'^T = (r . exp2(L[t-1]))^T
//   P^T [s][t], pitch C;  u: D;  the cumsum's totals: WKV_THREADS
template <typename T>
__host__ __device__ constexpr int wkv_rk_floats(int C, int D) {
  return wkv_max(2 * D * (C + 4) * (int)sizeof(T) / 4, D * D);
}
template <typename T>
__host__ __device__ constexpr int wkv_outputs_smem_floats(int C, int D) {
  return wkv_rk_floats<T>(C, D) + 2 * D * (C + 4) + C * C + D + WKV_THREADS;
}

template <typename T, typename TO, int C, int D>
__global__ void __launch_bounds__(WKV_THREADS, sizeof(T) == 2 ? 3 : 2)
    wkv_outputs_kernel(WkvArgs a) {
  constexpr int P = C + 4;                  // pitch of the [d][t] arrays
  constexpr int NT = C / 4;                 // 4x4 tiles per side
  constexpr int OFF = NT * (NT - 1) / 2;    // tiles below the diagonal
  // each kind of pair work on warps of its own: the tiles below the
  // diagonal on threads [0, OFF), the diagonal tiles on [W1, W1 + NT), the
  // bonus diagonal on [W2, W2 + C)
  constexpr int W1 = (OFF + 31) / 32 * 32;
  constexpr int W2 = (W1 + NT + 31) / 32 * 32;
  constexpr int Q = D / 4;
  static_assert(W2 + C <= WKV_THREADS, "too few threads for the pairs");
  static_assert(NT * Q <= WKV_THREADS, "a 4x4 tile of o per thread");
  extern __shared__ __align__(16) float smem[];
  T* sR = reinterpret_cast<T*>(smem);
  T* sK = sR + D * P;
  float* sS = smem;
  float* sL = smem + wkv_rk_floats<T>(C, D);
  float* sV = sL;
  float* sRt = sL + D * P;
  float* sRp = sRt;
  float* sPT = sRt + D * P;
  float* sU = sPT + C * C;
  float* sTot = sU + D;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, ch = blockIdx.y, nc = gridDim.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int64_t t0 = (int64_t)ch * C;
  const T* r = (const T*)a.r + b * a.r_sb + h * a.r_sh + t0 * a.r_ss;
  const T* k = (const T*)a.k + b * a.k_sb + h * a.k_sh + t0 * a.k_ss;
  const T* v = (const T*)a.v + b * a.v_sb + h * a.v_sh + t0 * a.v_ss;
  const float* w = a.w + b * a.w_sb + h * a.w_sh + t0 * a.w_ss;
  TO* o = (TO*)a.o + b * a.o_sb + h * a.o_sh + t0 * a.o_ss;
  const float* s_in = a.ws + ((int64_t)bh * nc + ch) * D * D;

  // every global load of the block goes out here; v and S_in wait in
  // registers until their shared memory is free
  constexpr int SV = D * D / 4 / WKV_THREADS > 0 ? D * D / 4 / WKV_THREADS : 1;
  float4 sv[SV];
#pragma unroll
  for (int j = 0; j < SV; ++j) {
    const int e = (tid + j * WKV_THREADS) * 4;
    if (e < D * D) sv[j] = *reinterpret_cast<const float4*>(s_in + e);
  }
  typename WkvVec<T>::type fv[wkv_vecs<C, D>()];
  wkv_fetch<C, D, false>(fv, v, a.v_ss);
  {
    typename WkvVec<T>::type fr[wkv_vecs<C, D>()], fk[wkv_vecs<C, D>()];
    float4 fw[wkv_vecs<C, D>()];
    wkv_fetch<C, D, true>(fr, r, a.r_ss);
    wkv_fetch<C, D, true>(fk, k, a.k_ss);
    wkv_fetch<C, D, true>(fw, w, a.w_ss);
    wkv_put_t<C, D, P>(sR, fr);
    wkv_put_t<C, D, P>(sK, fk);
    wkv_put<C, D, true, P>(sL, fw, WkvLog2());
  }
  for (int d = tid; d < D; d += WKV_THREADS) sU[d] = a.u[h * D + d];
  __syncthreads();
  wkv_cumsum<C, D, 1, P>(sL, sTot);
  // L[t-1] at column d, L[-1] = 0
  auto lprev = [&](int d, int t) { return t > 0 ? sL[d * P + t - 1] : 0.f; };
  // the row factor of the tiles below the diagonal, once per row
  for (int e = tid; e < C * D; e += WKV_THREADS) {
    const int t = e % C, d = e / C;
    sRt[d * P + t] = wkv_float(sR[d * P + t]) *
                     wkv_exp2(lprev(d, t) - lprev(d, t & ~3));
  }
  __syncthreads();

  // the pair matrix, written transposed with zeros above the diagonal
  if (tid < OFF) {
    int I, J;
    wkv_tile_ij(tid, &I, &J);
    ++I;                                    // J < I
    float acc[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float* row = sL + d * P;
      const float m = row[4 * I - 1];        // L[4I-1]
      const float4 l4 = *reinterpret_cast<const float4*>(row + 4 * J);
      const float4 k4 = wkv_load4(sK + d * P + 4 * J);
      const float4 kk = make_float4(
          k4.x * wkv_exp2(m - l4.x), k4.y * wkv_exp2(m - l4.y),
          k4.z * wkv_exp2(m - l4.z), k4.w * wkv_exp2(m - l4.w));
      wkv_outer(acc, *reinterpret_cast<const float4*>(sRt + d * P + 4 * I),
                kk);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sPT[(4 * J + j) * C + 4 * I + i] = acc[i][j];
  } else if (tid >= W1 && tid < W1 + NT) {
    const int I = tid - W1;                 // the diagonal tile (I, I)
    float acc[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float* row = sL + d * P;
      const float4 l4 = *reinterpret_cast<const float4*>(row + 4 * I);
      const float4 r4 = wkv_load4(sR + d * P + 4 * I);
      const float4 k4 = wkv_load4(sK + d * P + 4 * I);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ls[4] = {l4.x, l4.y, l4.z, l4.w};                 // L[s]
      const float lp[4] = {I > 0 ? row[4 * I - 1] : 0.f, l4.x, l4.y,
                           l4.z};                                  // L[t-1]
#pragma unroll
      for (int i = 1; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < i; ++j)
          acc[i][j] = fmaf(rr[i] * kk[j], wkv_exp2(lp[i] - ls[j]), acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j != i) sPT[(4 * I + j) * C + 4 * I + i] = j < i ? acc[i][j] : 0.f;
  } else if (tid >= W2 && tid < W2 + C) {
    const int t = tid - W2;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d)
      acc = fmaf(wkv_float(sR[d * P + t]) * sU[d], wkv_float(sK[d * P + t]),
                 acc);
    sPT[t * C + t] = acc;
  }
  __syncthreads();

  // r' = r . exp2(L[t-1]), transposed, over the row factor (dead now)
  for (int e = tid; e < C * D; e += WKV_THREADS) {
    const int t = e % C, d = e / C;
    sRp[d * P + t] = wkv_float(sR[d * P + t]) * wkv_exp2(lprev(d, t));
  }
  __syncthreads();
  // S_in over r and k, v over L (all dead now)
#pragma unroll
  for (int j = 0; j < SV; ++j) {
    const int e = (tid + j * WKV_THREADS) * 4;
    if (e < D * D) *reinterpret_cast<float4*>(sS + e) = sv[j];
  }
  wkv_put<C, D, false, D>(sV, fv, WkvIdentity());
  __syncthreads();

  // o = P v + r' S_in, a 4x4 (t, e) tile per thread
  if (tid < NT * Q) {
    const int tr = (tid / Q) * 4, e0 = (tid % Q) * 4;
    float acc[4][4] = {};
#pragma unroll 4
    for (int s = 0; s < tr + 4; ++s)
      wkv_outer(acc, *reinterpret_cast<const float4*>(sPT + s * C + tr),
                *reinterpret_cast<const float4*>(sV + s * D + e0));
#pragma unroll 8
    for (int d = 0; d < D; ++d)
      wkv_outer(acc, *reinterpret_cast<const float4*>(sRp + d * P + tr),
                *reinterpret_cast<const float4*>(sS + d * D + e0));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      wkv_store4(o + (tr + i) * a.o_ss + e0, acc[i]);
  }
}

// -- host --------------------------------------------------------------------

// Raises the dynamic shared-memory limit of the two chunk kernels of one
// instantiation, once per device.
template <typename T, typename TO, int C, int D>
static cudaError_t wkv_set_smem(size_t sm1, size_t sm3) {
  static std::atomic<bool> done[WKV_MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < WKV_MAX_DEVICES && done[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  err = cudaFuncSetAttribute(wkv_states_kernel<T, C, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv_outputs_kernel<T, TO, C, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm3);
  if (err == cudaSuccess && dev < WKV_MAX_DEVICES)
    done[dev].store(true, std::memory_order_relaxed);
  return err;
}

template <typename T, typename TO, int C, int D>
static int wkv_run(const WkvArgs& a, int phases, cudaStream_t st,
                   int32_t* issued) {
  const int nc = a.seq / C;
  const size_t sm1 = sizeof(float) * wkv_states_smem_floats(C, D);
  const size_t sm3 = sizeof(float) * wkv_outputs_smem_floats<T>(C, D);
  cudaError_t err = wkv_set_smem<T, TO, C, D>(sm1, sm3);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.nbh, nc);
  wkv_states_kernel<T, C, D><<<grid, WKV_THREADS, sm1, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*issued;
  if (phases < 2) return 0;
  const int64_t n = (int64_t)a.nbh * D * D;
  wkv_scan_kernel<D><<<(unsigned)((n + WKV_SCAN_THREADS - 1) /
                                  WKV_SCAN_THREADS),
                       WKV_SCAN_THREADS, 0, st>>>(a, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*issued;
  if (phases < 3) return 0;
  wkv_outputs_kernel<T, TO, C, D><<<grid, WKV_THREADS, sm3, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*issued;
  return 0;
}

template <typename T, typename TO, int C>
static int wkv_dispatch_d(const WkvArgs& a, int head_dim, int phases,
                          cudaStream_t st, int32_t* issued) {
  switch (head_dim) {
    case 16: return wkv_run<T, TO, C, 16>(a, phases, st, issued);
    case 32: return wkv_run<T, TO, C, 32>(a, phases, st, issued);
    case 64: return wkv_run<T, TO, C, 64>(a, phases, st, issued);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename TO>
static int wkv_dispatch(const WkvArgs& a, int chunk, int head_dim, int phases,
                        cudaStream_t st, int32_t* issued) {
  switch (chunk) {
    case 16: return wkv_dispatch_d<T, TO, 16>(a, head_dim, phases, st,
                                               issued);
    case 32: return wkv_dispatch_d<T, TO, 32>(a, head_dim, phases, st,
                                               issued);
    case 64: return wkv_dispatch_d<T, TO, 64>(a, head_dim, phases, st,
                                               issued);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Issues the three kernels on `stream`: chunk states and chunk outputs over
// grid (B*H, S / chunk), the scan over B*H*D*D threads.  dtype codes: 0
// fp32, 1 bf16; r, k, v in `in_dtype`, o in `out_dtype`, which is fp32 or
// `in_dtype`; `phases` (1-3) issues only the first kernels, to check each
// against its plain version.  Adds to `*issued` one for each kernel it
// launched.  Returns the first failing launch's cudaError_t (0 on
// success), or cudaErrorInvalidValue for an argument this file has no
// kernel for.
extern "C" int wkv_launch(const WkvArgs* a, int32_t chunk, int32_t head_dim,
                          int32_t in_dtype, int32_t out_dtype, int32_t phases,
                          void* stream, int32_t* issued) {
  if (a->nbh <= 0 || a->seq <= 0) return 0;
  if (a->heads <= 0 || a->nbh % a->heads != 0 || chunk <= 0 ||
      a->seq % chunk != 0 || a->seq / chunk > WKV_MAX_CHUNKS || phases < 1 ||
      phases > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (in_dtype == 0 && out_dtype == 0)
    return wkv_dispatch<float, float>(*a, chunk, head_dim, phases, st,
                                      issued);
  if (in_dtype == 1 && out_dtype == 1)
    return wkv_dispatch<__nv_bfloat16, __nv_bfloat16>(*a, chunk, head_dim,
                                                      phases, st, issued);
  if (in_dtype == 1 && out_dtype == 0)
    return wkv_dispatch<__nv_bfloat16, float>(*a, chunk, head_dim, phases,
                                              st, issued);
  return (int)cudaErrorInvalidValue;
}
