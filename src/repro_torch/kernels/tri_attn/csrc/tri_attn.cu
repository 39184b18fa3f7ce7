// Causal attention forward over the lower-triangular block domain, for Hopper.
//
// Replaces the TPU kernel repro/kernels/tri_attn/kernel.py::_attn_kernel
// (built by build_attention_call): o = softmax(q k^T D^-1/2, causal) v, with
// fp32 m / l / acc, NEG_INF masking and o in q's dtype.  The wrapper
// (kernel.py::launch_attention) takes one of two routes, by dtype and shape,
// before any launch:
//
//   * sm90 (tri_attn_sm90.cuh, included at the end of this file): bf16,
//     block 128, head_dim 64 or 128 -- the LM path's case.  Tensor cores
//     (wgmma), TMA loads and a persistent grid of n_SM CTAs that each walk a
//     contiguous range of the paper's lambda grid with the row state on
//     chip; see the note there.
//   * simt (this file): every other shape -- fp32 inputs, and bf16 with
//     another block or head_dim (8, 16, 32, 64 or 128; blocks of 16, 32, 64
//     or 128 rows).  It is the first version, described below; head_dim 8
//     (the smoke configs') leaves half of each p v row's 16 lanes idle.
//
// The simt route.  The (q block i, k block j) pairs with j <= i are the
// paper's 2D triangular domain.  On the TPU the grid ran in order and carried
// m, l, acc from step j to step j+1 in VMEM; here nothing carries over
// between blocks, so the work is split in two launches:
//
//   * the pair launch: one block per (bh, i, j) pair computes that pair's
//     partial (m, l, acc) -- block-local row max, exp, row sum, p v -- and
//     writes it to an fp32 workspace at lambda(i, j) = i(i+1)/2 + j.  Its grid
//     is the paper's point: "mapped" launches exactly B*H*T(nb) blocks, with
//     T(nb) = nb(nb+1)/2, and block lambda derives (i, j) from the inverse
//     triangular map with an exact integer square root (int64 8*lambda+1, a
//     float64 seed and a correction ladder; exact for every nb the grid can
//     hold); "bounding_box" launches B*H*nb*nb blocks and the blocks with
//     j > i return at once (the paper's discard `if`).
//   * the combine launch, shared by both modes: one block per (bh, i) merges
//     the partials j = 0..i in ascending j with the online-softmax rescale
//     and writes o.  Both modes compute the same partials with the same code
//     and merge them in the same order, so their outputs are bit-identical.
//
// q is scaled in fp32 before the product.  GQA: a block reads kv head
// h / (H / Hk) directly; nothing is repeated.  q, k, v and o are addressed
// through (b, h, s) strides with d contiguous.
//
// What bounds the simt route: causal attention at (1, 32, 4 kv, 4096, 128)
// needs 137.5 GFLOP, operations-bound on an H100 (0.139 ms at 989 TFLOP/s
// bf16, 0.023 ms of bytes).  The products here are fp32 FMAs on the CUDA
// cores out of shared memory (4x4 to 8x8 register tiles per thread), one
// block of 256 threads per pair, and the workspace round trip
// (B*H*T(nb)*block*(D+2)*4 bytes; the wrapper splits B*H under a 2 GiB cap)
// costs about 0.7 ms more at that shape in bf16, which is why the LM path's
// case takes the sm90 route instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TA_NEG_INF (-1e30f)

constexpr int TA_THREADS = 256;   // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int TA_KC = 32;         // k / v rows per shared-memory sub-tile

// Keep in step with ``_Args`` in kernel.py.
struct TaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;   // strides in elements of (b, h, s); d is 1
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  float* ws_acc;              // (nbh, T(nb), block, D) unnormalized p v
  float* ws_m;                // (nbh, T(nb), block) block-local row max
  float* ws_l;                // (nbh, T(nb), block) row sum of exp
  int32_t heads, kv_heads;
  int32_t bh0, nbh;           // this launch's (b*H + h) range
  int32_t nb;                 // seq / block
  float scale;                // head_dim^-1/2, applied to q in fp32
};

// The paper's 2D triangular map g(lambda) = (i, j), j <= i, exact: int64
// 8*lambda+1, a float64 square-root seed, then a ladder that corrects the
// seed in both directions until r = isqrt(8*lambda+1).
__device__ __forceinline__ void ta_lam_to_ij(int64_t lam, int32_t* i,
                                             int32_t* j) {
  const int64_t v = 8 * lam + 1;
  int64_t r = (int64_t)sqrt((double)v);
  while ((r + 1) * (r + 1) <= v) ++r;
  while (r * r > v) --r;
  const int64_t ii = (r - 1) / 2;
  *i = (int32_t)ii;
  *j = (int32_t)(lam - ii * (ii + 1) / 2);
}

__device__ __forceinline__ float ta_load(const float* p) { return *p; }
__device__ __forceinline__ float ta_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void ta_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void ta_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int BLK, int D>
constexpr int ta_smem_floats() {
  return BLK * (D + 1) + BLK * (BLK + 1) + (BLK < TA_KC ? BLK : TA_KC) * (D + 1);
}

// One (i, j) pair of one (b, h): the partial (m, l, acc) of q block i
// against k/v block j, written at lambda(i, j).
template <typename T, int BLK, int D>
__device__ __forceinline__ void ta_pair(const TaArgs& a, int bh_local,
                                        int32_t i, int32_t j) {
  constexpr int KC = BLK < TA_KC ? BLK : TA_KC;
  constexpr int RM = BLK / 16;   // q rows per thread
  constexpr int CN = KC / 16;    // k rows per thread per sub-tile
  constexpr int DN = (D + 15) / 16;  // output columns per thread
  // below 16 columns, lanes tx >= D hold no column: they read and write
  // nothing (the test is true at compile time for D a multiple of 16)
  constexpr int QP = D + 1;      // padded row pitches (no bank conflicts)
  constexpr int SP = BLK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                 // BLK x QP, q * scale
  float* sS = sQ + BLK * QP;        // BLK x SP, scores then p
  float* sKV = sS + BLK * SP;       // KC x QP, a k or v sub-tile

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = a.bh0 + bh_local;
  const int b = bh / a.heads, h = bh % a.heads;
  const int hk = h / (a.heads / a.kv_heads);
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh + (int64_t)i * BLK * a.q_ss;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh + (int64_t)j * BLK * a.k_ss;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh + (int64_t)j * BLK * a.v_ss;

  for (int e = tid; e < BLK * D; e += TA_THREADS) {
    const int r = e / D, d = e % D;
    sQ[r * QP + d] = ta_load(q + r * a.q_ss + d) * a.scale;
  }
  // s = (q * scale) k^T, KC columns at a time; causal mask by position
  for (int c0 = 0; c0 < BLK; c0 += KC) {
    __syncthreads();
    for (int e = tid; e < KC * D; e += TA_THREADS) {
      const int r = e / D, d = e % D;
      sKV[r * QP + d] = ta_load(k + (c0 + r) * a.k_ss + d);
    }
    __syncthreads();
    float acc[RM][CN];
#pragma unroll
    for (int x = 0; x < RM; ++x)
#pragma unroll
      for (int y = 0; y < CN; ++y) acc[x][y] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RM], kb[CN];
#pragma unroll
      for (int x = 0; x < RM; ++x) qa[x] = sQ[(ty + 16 * x) * QP + d];
#pragma unroll
      for (int y = 0; y < CN; ++y) kb[y] = sKV[(tx + 16 * y) * QP + d];
#pragma unroll
      for (int x = 0; x < RM; ++x)
#pragma unroll
        for (int y = 0; y < CN; ++y) acc[x][y] = fmaf(qa[x], kb[y], acc[x][y]);
    }
#pragma unroll
    for (int x = 0; x < RM; ++x)
#pragma unroll
      for (int y = 0; y < CN; ++y) {
        const int r = ty + 16 * x, c = c0 + tx + 16 * y;
        const bool keep = (int64_t)i * BLK + r >= (int64_t)j * BLK + c;
        sS[r * SP + c] = keep ? acc[x][y] : TA_NEG_INF;
      }
  }
  __syncthreads();
  // per row: block-local max m, p = exp(s - m), l = sum p.  Row r is owned
  // by the 16 lanes that share ty (a half warp).
  const int64_t pair = (int64_t)bh_local * ((int64_t)a.nb * (a.nb + 1) / 2) +
                       (int64_t)i * (i + 1) / 2 + j;
#pragma unroll
  for (int x = 0; x < RM; ++x) {
    const int r = ty + 16 * x;
    float m = TA_NEG_INF;
    for (int c = tx; c < BLK; c += 16) m = fmaxf(m, sS[r * SP + c]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int c = tx; c < BLK; c += 16) {
      const float p = expf(sS[r * SP + c] - m);
      sS[r * SP + c] = p;
      l += p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (tx == 0) {
      a.ws_m[pair * BLK + r] = m;
      a.ws_l[pair * BLK + r] = l;
    }
  }
  // acc = p v, KC rows of v at a time
  float o[RM][DN];
#pragma unroll
  for (int x = 0; x < RM; ++x)
#pragma unroll
    for (int y = 0; y < DN; ++y) o[x][y] = 0.f;
  for (int c0 = 0; c0 < BLK; c0 += KC) {
    __syncthreads();
    for (int e = tid; e < KC * D; e += TA_THREADS) {
      const int r = e / D, d = e % D;
      sKV[r * QP + d] = ta_load(v + (c0 + r) * a.v_ss + d);
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < KC; ++c) {
      float pa[RM], vb[DN];
#pragma unroll
      for (int x = 0; x < RM; ++x) pa[x] = sS[(ty + 16 * x) * SP + c0 + c];
#pragma unroll
      for (int y = 0; y < DN; ++y)
        vb[y] = (D % 16 == 0 || tx + 16 * y < D) ? sKV[c * QP + tx + 16 * y]
                                                 : 0.f;
#pragma unroll
      for (int x = 0; x < RM; ++x)
#pragma unroll
        for (int y = 0; y < DN; ++y) o[x][y] = fmaf(pa[x], vb[y], o[x][y]);
    }
  }
  float* ws = a.ws_acc + pair * BLK * D;
#pragma unroll
  for (int x = 0; x < RM; ++x)
#pragma unroll
    for (int y = 0; y < DN; ++y)
      if (D % 16 == 0 || tx + 16 * y < D)
        ws[(ty + 16 * x) * D + tx + 16 * y] = o[x][y];
}

// grid (T(nb), nbh): block lambda is pair g(lambda)
template <typename T, int BLK, int D>
__global__ void __launch_bounds__(TA_THREADS)
ta_pair_mapped_kernel(TaArgs a) {
  int32_t i, j;
  ta_lam_to_ij((int64_t)blockIdx.x, &i, &j);
  ta_pair<T, BLK, D>(a, blockIdx.y, i, j);
}

// grid (nb, nb, nbh): block (j, i); the upper triangle is discarded
template <typename T, int BLK, int D>
__global__ void __launch_bounds__(TA_THREADS)
ta_pair_bb_kernel(TaArgs a) {
  const int32_t j = blockIdx.x, i = blockIdx.y;
  if (j > i) return;
  ta_pair<T, BLK, D>(a, blockIdx.z, i, j);
}

// grid (nb, nbh): q block i of one (b, h) merges its partials j = 0..i
template <typename T, int BLK, int D>
__global__ void __launch_bounds__(TA_THREADS)
ta_combine_kernel(TaArgs a) {
  const int32_t i = blockIdx.x;
  const int bh_local = blockIdx.y;
  const int bh = a.bh0 + bh_local;
  const int b = bh / a.heads, h = bh % a.heads;
  const int64_t row0 = (int64_t)bh_local * ((int64_t)a.nb * (a.nb + 1) / 2) +
                       (int64_t)i * (i + 1) / 2;
  T* o = (T*)a.o + b * a.o_sb + h * a.o_sh + (int64_t)i * BLK * a.o_ss;
  for (int e = threadIdx.x; e < BLK * D; e += TA_THREADS) {
    const int r = e / D, d = e % D;
    float m = TA_NEG_INF, l = 0.f, acc = 0.f;
    for (int32_t j = 0; j <= i; ++j) {
      const int64_t p = row0 + j;
      const float mj = a.ws_m[p * BLK + r];
      const float mn = fmaxf(m, mj);
      const float alpha = expf(m - mn), beta = expf(mj - mn);
      l = l * alpha + a.ws_l[p * BLK + r] * beta;
      acc = acc * alpha + a.ws_acc[(p * BLK + r) * D + d] * beta;
      m = mn;
    }
    ta_store(o + r * a.o_ss + d, acc / l);
  }
}

template <typename T, int BLK, int D>
static int ta_launch(const TaArgs& a, int mode, cudaStream_t st) {
  constexpr size_t smem = sizeof(float) * ta_smem_floats<BLK, D>();
  const unsigned int nbh = (unsigned int)a.nbh, nb = (unsigned int)a.nb;
  cudaError_t err;
  if (mode == 0) {
    err = cudaFuncSetAttribute(ta_pair_mapped_kernel<T, BLK, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned int tri = (unsigned int)((int64_t)nb * (nb + 1) / 2);
    ta_pair_mapped_kernel<T, BLK, D><<<dim3(tri, nbh), TA_THREADS, smem, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(ta_pair_bb_kernel<T, BLK, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ta_pair_bb_kernel<T, BLK, D><<<dim3(nb, nb, nbh), TA_THREADS, smem, st>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ta_combine_kernel<T, BLK, D><<<dim3(nb, nbh), TA_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int BLK>
static int ta_dispatch_d(const TaArgs& a, int head_dim, int mode,
                         cudaStream_t st) {
  switch (head_dim) {
    case 8: return ta_launch<T, BLK, 8>(a, mode, st);
    case 16: return ta_launch<T, BLK, 16>(a, mode, st);
    case 32: return ta_launch<T, BLK, 32>(a, mode, st);
    case 64: return ta_launch<T, BLK, 64>(a, mode, st);
    case 128: return ta_launch<T, BLK, 128>(a, mode, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int ta_dispatch(const TaArgs& a, int block, int head_dim, int mode,
                       cudaStream_t st) {
  switch (block) {
    case 16: return ta_dispatch_d<T, 16>(a, head_dim, mode, st);
    case 32: return ta_dispatch_d<T, 32>(a, head_dim, mode, st);
    case 64: return ta_dispatch_d<T, 64>(a, head_dim, mode, st);
    case 128: return ta_dispatch_d<T, 128>(a, head_dim, mode, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches the pair launch (mode 0: mapped, 1: bounding box) and the combine
// launch on `stream`; dtype 0 is fp32, 1 bf16.  Returns the launches'
// cudaError_t (0 on success), or cudaErrorInvalidValue for an argument this
// file has no kernel for.
extern "C" int ta_attn_launch(const TaArgs* a, int32_t block,
                              int32_t head_dim, int32_t dtype, int32_t mode,
                              void* stream) {
  if (a->nbh <= 0 || a->nb <= 0) return 0;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (a->kv_heads <= 0 || a->heads % a->kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  if (a->nbh > 65535 || (int64_t)a->nb * (a->nb + 1) / 2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return ta_dispatch<float>(*a, block, head_dim, mode, st);
  if (dtype == 1) return ta_dispatch<__nv_bfloat16>(*a, block, head_dim, mode, st);
  return (int)cudaErrorInvalidValue;
}

__global__ void ta_lam_to_ij_kernel(int64_t lam0, int64_t n,
                                    int32_t* __restrict__ i_out,
                                    int32_t* __restrict__ j_out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    int32_t i, j;
    ta_lam_to_ij(lam0 + t, &i, &j);
    i_out[t] = i;
    j_out[t] = j;
  }
}

// Writes the pair kernel's own (i, j) for lambda in [lam0, lam0 + n), so a
// caller can hold the device-side map exact against integer arithmetic.
extern "C" int ta_lam_to_ij_launch(int64_t lam0, int64_t n, int32_t* i_out,
                                   int32_t* j_out, void* stream) {
  if (n <= 0) return 0;
  const int64_t want = (n + 255) / 256;
  const unsigned int blocks = (unsigned int)(want < 65536 ? want : 65536);
  ta_lam_to_ij_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(lam0, n, i_out,
                                                                 j_out);
  return (int)cudaGetLastError();
}

#include "tri_attn_sm90.cuh"
