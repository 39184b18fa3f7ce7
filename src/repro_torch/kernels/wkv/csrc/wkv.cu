// Chunked RWKV-6 WKV forward for Hopper.
//
// Replaces the TPU kernel repro/kernels/wkv/kernel.py::_wkv_kernel (built by
// build_wkv_call).  Per (batch, head), over chunks of C rows in order, with
// the (D, D) fp32 state S carried from chunk to chunk:
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
//   * the state update reads exp2(L[C-1]) and k . exp2(L[C-1] - L[s]).
// It is the same function; where the TPU kernel's form stays finite the two
// agree to rounding.
//
// Layout: one block per (bh, v-column slice) loops over the chunks in order
// and keeps its slice of S (D x D/nsplit fp32) in shared memory; the v
// columns of S are independent, so the slices need no communication and each
// recomputes the (C x C) pair matrix.  r, k, v and w are read in place
// through (b, s, h) strides with d contiguous, so the model's (B, S, H, D)
// projections go in without a transposing copy, and o is written through its
// own strides.  u is (H, D), indexed by head; the states are (B, H, D, D)
// fp32, contiguous.  r, k, v (and o) are fp32 or bf16, w is fp32, and all
// arithmetic is fp32.  D and C are 16, 32 or 64.
//
// What bounds it on an H100: at the LM path's shape (B*H = 40, S = 4096,
// D = 64, fp32) the function reads r, k, v, w once and writes o once
// (about 211 MB with the states, 0.063 ms at 3.35 TB/s) and needs about
// 5.4 GFLOP (0.005 ms at 989 TFLOP/s): it is bound by bytes.  This first
// version is the simple one: the products are fp32 FMAs on the CUDA cores
// out of shared memory, the pair matrix pays exp2 per (pair, d) on the
// diagonal tiles and per (row, d) of a tile elsewhere, and the chunks of a
// block run one after another with no load in flight, so it runs far from
// that bound.  Tensor cores, TMA and a sub-chunk factorization of the pair
// matrix are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int WKV_THREADS = 256;

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
  int64_t r_sb, r_ss, r_sh;   // strides in elements of (b, s, h); d is 1
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t w_sb, w_ss, w_sh;
  int64_t o_sb, o_ss, o_sh;
  int32_t heads;              // H
  int32_t nbh;                // B * H
  int32_t seq;                // S, a multiple of the chunk
  int32_t dv;                 // v columns per block: D / nsplit
};

__device__ __forceinline__ float wkv_load(const float* p) { return *p; }
__device__ __forceinline__ float wkv_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void wkv_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void wkv_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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

__host__ __device__ constexpr int wkv_smem_floats(int C, int D, int dv) {
  // sR, sK: C x (D+1); sL: (C+1) x (D+1); sP: C x (C+1); sU, sA: D;
  // sV: C x dv; sS: D x dv
  return 2 * C * (D + 1) + (C + 1) * (D + 1) + C * (C + 1) + 2 * D +
         C * dv + D * dv;
}

template <typename T, int C, int D>
__global__ void __launch_bounds__(WKV_THREADS) wkv_kernel(WkvArgs a) {
  constexpr int LP = D + 1;                 // padded row pitches
  constexpr int PP = C + 1;
  constexpr int NT = C / 4;                 // 4x4 tiles per side
  constexpr int TILES = NT * (NT + 1) / 2;  // on or below the diagonal
  static_assert(TILES + C <= WKV_THREADS, "too few threads for the pairs");
  extern __shared__ float smem[];
  float* sR = smem;                // r, then r . exp2(L[t-1])
  float* sK = sR + C * LP;         // k, then k . exp2(L[C-1] - L[s])
  float* sL = sK + C * LP;         // row 0: 0; row t+1: L[t] (log2 units)
  float* sP = sL + (C + 1) * LP;   // pair matrix, diagonal = bonus term
  float* sU = sP + C * PP;
  float* sA = sU + D;              // exp2(L[C-1])
  float* sV = sA + D;              // C x dv, this block's v columns
  float* sS = sV + C * a.dv;       // D x dv, this block's state columns

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh % a.heads;
  const int dv = a.dv;
  const int c0 = blockIdx.y * dv;
  const T* r = (const T*)a.r + b * a.r_sb + h * a.r_sh;
  const T* k = (const T*)a.k + b * a.k_sb + h * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + h * a.v_sh + c0;
  const float* w = a.w + b * a.w_sb + h * a.w_sh;
  T* o = (T*)a.o + b * a.o_sb + h * a.o_sh + c0;
  const float* s_in = a.s_in + (int64_t)bh * D * D + c0;
  float* s_out = a.s_out + (int64_t)bh * D * D + c0;

  for (int d = tid; d < D; d += WKV_THREADS) {
    sU[d] = a.u[h * D + d];
    sL[d] = 0.f;
  }
  for (int e = tid; e < D * dv; e += WKV_THREADS)
    sS[e] = s_in[(e / dv) * D + e % dv];

  const int nchunks = a.seq / C;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int64_t t0 = (int64_t)ch * C;
    for (int e = tid; e < C * D; e += WKV_THREADS) {
      const int t = e / D, d = e % D;
      const int64_t row = t0 + t;
      sR[t * LP + d] = wkv_load(r + row * a.r_ss + d);
      sK[t * LP + d] = wkv_load(k + row * a.k_ss + d);
      sL[(t + 1) * LP + d] = log2f(w[row * a.w_ss + d]);
    }
    for (int e = tid; e < C * dv; e += WKV_THREADS) {
      const int t = e / dv, c = e % dv;
      sV[e] = wkv_load(v + (t0 + t) * a.v_ss + c);
    }
    __syncthreads();
    // the in-chunk cumulative log2 decay, one column per thread
    if (tid < D) {
      float acc = 0.f;
      for (int t = 1; t <= C; ++t) {
        acc += sL[t * LP + tid];
        sL[t * LP + tid] = acc;
      }
    }
    __syncthreads();
    // the pair matrix: one 4x4 tile per thread, then the bonus diagonal
    if (tid < TILES) {
      int I, J;
      wkv_tile_ij(tid, &I, &J);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (I == J) {
        for (int d = 0; d < D; ++d) {
          float rr[4], lp[4], kk[4], ls[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            rr[i] = sR[(4 * I + i) * LP + d];
            lp[i] = sL[(4 * I + i) * LP + d];        // L[t-1]
            kk[i] = sK[(4 * J + i) * LP + d];
            ls[i] = sL[(4 * J + i + 1) * LP + d];    // L[s]
          }
#pragma unroll
          for (int i = 1; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < i; ++j)
              acc[i][j] = fmaf(rr[i] * kk[j], exp2f(lp[i] - ls[j]), acc[i][j]);
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float m = sL[(4 * I) * LP + d];    // L[4I-1]
          float rr[4], kk[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            rr[i] = sR[(4 * I + i) * LP + d] *
                    exp2f(sL[(4 * I + i) * LP + d] - m);
            kk[i] = sK[(4 * J + i) * LP + d] *
                    exp2f(m - sL[(4 * J + i + 1) * LP + d]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(rr[i], kk[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * J + j < 4 * I + i) sP[(4 * I + i) * PP + 4 * J + j] = acc[i][j];
    } else if (tid < TILES + C) {
      const int t = tid - TILES;
      float acc = 0.f;
      for (int d = 0; d < D; ++d)
        acc = fmaf(sR[t * LP + d] * sU[d], sK[t * LP + d], acc);
      sP[t * PP + t] = acc;
    }
    __syncthreads();
    // r . A[t-1] and k . A[C-1] / A[s] in place; A[C-1]
    for (int e = tid; e < C * D; e += WKV_THREADS) {
      const int t = e / D, d = e % D;
      const float lend = sL[C * LP + d];
      sR[t * LP + d] *= exp2f(sL[t * LP + d]);
      sK[t * LP + d] *= exp2f(lend - sL[(t + 1) * LP + d]);
    }
    for (int d = tid; d < D; d += WKV_THREADS) sA[d] = exp2f(sL[C * LP + d]);
    __syncthreads();
    // o = P v + (r . A[t-1]) S_in
    for (int e = tid; e < C * dv; e += WKV_THREADS) {
      const int t = e / dv, c = e % dv;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc = fmaf(sP[t * PP + s], sV[s * dv + c], acc);
      for (int d = 0; d < D; ++d) acc = fmaf(sR[t * LP + d], sS[d * dv + c], acc);
      wkv_store(o + (t0 + t) * a.o_ss + c, acc);
    }
    __syncthreads();
    // S = A[C-1] . S + sum_s (k_s . A[C-1] / A[s]) v_s^T
    for (int e = tid; e < D * dv; e += WKV_THREADS) {
      const int d = e / dv, c = e % dv;
      float acc = sA[d] * sS[e];
      for (int s = 0; s < C; ++s) acc = fmaf(sK[s * LP + d], sV[s * dv + c], acc);
      sS[e] = acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < D * dv; e += WKV_THREADS)
    s_out[(e / dv) * D + e % dv] = sS[e];
}

template <typename T, int C, int D>
static int wkv_launch_t(const WkvArgs& a, int nsplit, cudaStream_t st) {
  const size_t smem = sizeof(float) * wkv_smem_floats(C, D, a.dv);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T, C, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv_kernel<T, C, D><<<dim3(a.nbh, nsplit), WKV_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int C>
static int wkv_dispatch_d(const WkvArgs& a, int head_dim, int nsplit,
                          cudaStream_t st) {
  switch (head_dim) {
    case 16: return wkv_launch_t<T, C, 16>(a, nsplit, st);
    case 32: return wkv_launch_t<T, C, 32>(a, nsplit, st);
    case 64: return wkv_launch_t<T, C, 64>(a, nsplit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int wkv_dispatch(const WkvArgs& a, int chunk, int head_dim, int nsplit,
                        cudaStream_t st) {
  switch (chunk) {
    case 16: return wkv_dispatch_d<T, 16>(a, head_dim, nsplit, st);
    case 32: return wkv_dispatch_d<T, 32>(a, head_dim, nsplit, st);
    case 64: return wkv_dispatch_d<T, 64>(a, head_dim, nsplit, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches the kernel on `stream` over grid (B*H, nsplit); dtype 0 is fp32,
// 1 bf16 (r, k, v and o).  Returns the launch's cudaError_t (0 on success),
// or cudaErrorInvalidValue for an argument this file has no kernel for.
extern "C" int wkv_launch(const WkvArgs* a, int32_t chunk, int32_t head_dim,
                          int32_t dtype, int32_t nsplit, void* stream) {
  if (a->nbh <= 0 || a->seq <= 0) return 0;
  if (a->heads <= 0 || a->nbh % a->heads != 0 || chunk <= 0 ||
      a->seq % chunk != 0)
    return (int)cudaErrorInvalidValue;
  if (nsplit <= 0 || nsplit > 65535 || head_dim % nsplit != 0 ||
      a->dv != head_dim / nsplit)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return wkv_dispatch<float>(*a, chunk, head_dim, nsplit, st);
  if (dtype == 1)
    return wkv_dispatch<__nv_bfloat16>(*a, chunk, head_dim, nsplit, st);
  return (int)cudaErrorInvalidValue;
}
