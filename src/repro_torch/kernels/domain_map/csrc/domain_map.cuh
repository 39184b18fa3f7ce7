// Shared geometry for the two domain-map kernels (map_kernel.cu,
// membership_kernel.cu): the launch descriptor, the run bookkeeping and the
// __device__ code of the two geometry families in
// kernels/domain_map/geometry.py.
//
//   PEEL    the m-simplex layer peel: per level, the largest x with
//           C(x+m-1, m) <= lam from a root seed and an exact ladder.  tri2d
//           and pyramid3d are the m = 2, 3 peels with their axes permuted;
//           msimplex2-5 are the peel as it stands.
//   DIGITS  the base-B digit engine for the six digit fractals: digit d adds
//           vecs[d] * scale^level.  The generator table (at most 20 vectors)
//           arrives in the descriptor.
//
// Both kernels give each thread a run of R consecutive points (R per kernel:
// DM_RUN_* in each .cu): the run's first point is derived in full, the
// others are stepped from it.
// Index math is 32-bit where the host (geometry.py: map_index_bits,
// membership_index_bits) proves it exact for the whole launch and the
// kernel has a 32-bit path (the membership kernel, the peel for m >= 4),
// and 64-bit otherwise.  The descriptor layout must match the ctypes structure _Geom in
// kernel.py field for field.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#define DM_MAX_DIM 5
#define DM_MAX_BASE 20
#define DM_THREADS 256

enum { DM_PEEL = 0, DM_DIGITS = 1 };

struct DomainGeom {
  int32_t family;                         // DM_PEEL | DM_DIGITS
  int32_t dim;                            // output axes, 1..DM_MAX_DIM
  int32_t m;                              // PEEL: levels of the peel
  int32_t perm[DM_MAX_DIM];               // PEEL: axis k = layer perm[k]
  int32_t nchain;                         // PEEL membership: pairs in chain
  int32_t chain_lo[DM_MAX_DIM];           //   axes[lo] <= axes[hi]
  int32_t chain_hi[DM_MAX_DIM];
  int32_t base;                           // DIGITS: digit base B
  int32_t scale;                          // DIGITS: spatial scale per level
  int32_t vecs[DM_MAX_BASE * DM_MAX_DIM]; // DIGITS: vecs[d * MAX_DIM + k]
  uint32_t allowed;                       // DIGITS: bit c <=> code c allowed
  int32_t all_levels;                     // DIGITS: test every level
};

// Number of blocks for a grid-stride loop over n items.
static inline unsigned int dm_blocks(int64_t n) {
  int64_t b = (n + DM_THREADS - 1) / DM_THREADS;
  const int64_t cap = int64_t(1) << 24;
  return (unsigned int)(b < cap ? b : cap);
}

// The grid of a kernel that builds a shared-memory table in every block: as
// many blocks as fit on the card at once, fewer if the work is smaller.  The
// kernel's shared-memory limit is raised to `smem`, and its resident-block
// count taken, once per device at its first launch there, and kept in
// `cache` (one per kernel instantiation); later launches only read it.
#define DM_MAX_DEVICES 64
struct DmResident {
  std::atomic<int> cap[DM_MAX_DEVICES];   // 0 until taken
};

template <typename Kern>
static inline unsigned int dm_resident_blocks(Kern kern, int64_t items,
                                              size_t smem,
                                              DmResident& cache) {
  int dev = 0;
  cudaGetDevice(&dev);
  int cap = dev < DM_MAX_DEVICES ? cache.cap[dev].load(std::memory_order_relaxed)
                                 : 0;
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, DM_THREADS,
                                                  smem);
    cap = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
    if (dev < DM_MAX_DEVICES)
      cache.cap[dev].store(cap, std::memory_order_relaxed);
  }
  const int64_t b = (items + DM_THREADS - 1) / DM_THREADS;
  return (unsigned int)(b < cap ? (b > 0 ? b : 1) : cap);
}

template <int N>
__host__ __device__ constexpr int64_t dm_ipow(int64_t b) {
  return N == 0 ? 1 : b * dm_ipow<(N > 0 ? N - 1 : 0)>(b);
}

// The staging area of one block: R int32 per thread.
#define DM_STAGE_INT4(R) (DM_THREADS * (R) / 4)

// Store a run's R values v[] at row[i0..].  Where the warp's 32 runs
// lie whole in the row and the row is 16-byte aligned, the values pass
// through the warp's part of the block's staging area, so that each 16-byte
// store instruction of the warp writes 512 contiguous bytes (whole 32-byte
// sectors, whatever R is); elsewhere, masked scalar stores.  All lanes of
// a warp call it in the same step of the grid-stride loop.
template <int R>
__device__ __forceinline__ void dm_store_run(int32_t* __restrict__ row,
                                             int64_t i0, int64_t n,
                                             bool aligned,
                                             const int32_t (&v)[R],
                                             int4* stage) {
  static_assert(R % 4 == 0, "a run is whole 16-byte stores");
  const int lane = threadIdx.x & 31;
  const int64_t w0 = i0 - (int64_t)lane * R;        // the warp's first point
  if (aligned && w0 + 32 * R <= n) {                // the same in every lane
    int4* s = stage + (threadIdx.x & ~31) * (R / 4);
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
      s[lane * (R / 4) + j] =
          make_int4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    __syncwarp();
    int4* p = reinterpret_cast<int4*>(row + w0);
#pragma unroll
    for (int j = 0; j < R / 4; ++j) p[j * 32 + lane] = s[j * 32 + lane];
    __syncwarp();
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (i0 + j < n) row[i0 + j] = v[j];
  }
}

// ---------------------------------------------------------------------------
// PEEL, 64-bit: the exact int64 peel (float64 seed, int64 ladder)
// ---------------------------------------------------------------------------

// C(x+M-1, M), dividing stepwise so every division is exact and the
// running value stays below M * C(x+M-1, M).
template <int M>
__device__ __forceinline__ int64_t dm_simplex_size(int64_t x) {
  int64_t r = 1;
#pragma unroll
  for (int i = 1; i <= M; ++i) r = r * (x + i - 1) / i;
  return r;
}

// Largest x with C(x+M-1, M) <= lam: float64 seed (M! lam)^(1/M), then an
// exact ladder in both directions.
template <int M>
__device__ __forceinline__ int64_t dm_simplex_layer(int64_t lam) {
  double fact = 1.0;
#pragma unroll
  for (int i = 2; i <= M; ++i) fact *= i;
  int64_t x = (int64_t)pow((double)lam * fact, 1.0 / M);
  if (x < 0) x = 0;
  while (dm_simplex_size<M>(x + 1) <= lam) ++x;
  while (x > 0 && dm_simplex_size<M>(x) > lam) --x;
  return x;
}

// ---------------------------------------------------------------------------
// PEEL, 32-bit: fp32 seed from the special-function unit, uint32 ladder.
// Level l's ladder evaluates C(x+l-1, l) only for x <= dm_xmax32(l), the
// largest x whose stepwise intermediates i * C(x+i-1, i) all stay below
// 2^32 (geometry.py: peel_xmax32 computes them and a test holds this table
// to it).  A launch takes this path only if every lam < C(XMAX+l-1, l) for
// each level l <= m (geometry.py: PEEL_LAM32), so every layer + 1 <= XMAX.
// ---------------------------------------------------------------------------

__host__ __device__ constexpr uint32_t dm_xmax32(int level) {
  return level == 2 ? 65535u : level == 3 ? 2047u : level == 4 ? 399u
       : level == 5 ? 157u : 0u;
}

template <int M>
__device__ __forceinline__ uint32_t dm_simplex_size32(uint32_t x) {
  uint32_t r = x;
#pragma unroll
  for (int i = 2; i <= M; ++i) r = r * (x + i - 1) / i;
  return r;
}

template <int M>
__device__ __forceinline__ float dm_root_seed(float y) {
  if (M == 2) return sqrtf(y);
  if (M == 3) return cbrtf(y);
  if (M == 4) return sqrtf(sqrtf(y));
  return exp2f(log2f(y) * (1.0f / M));
}

// Largest x with C(x+M-1, M) <= rem, and that size (in *size).
template <int M>
__device__ __forceinline__ uint32_t dm_simplex_layer32(uint32_t rem,
                                                       uint32_t* size) {
  float fact = 1.0f;
#pragma unroll
  for (int i = 2; i <= M; ++i) fact *= i;
  const float seed = dm_root_seed<M>((float)rem * fact);
  constexpr uint32_t cap = dm_xmax32(M) - 1;
  uint32_t x = seed > 0.0f ? (uint32_t)seed : 0u;
  x = x < cap ? x : cap;
  uint32_t s0 = dm_simplex_size32<M>(x), s1 = dm_simplex_size32<M>(x + 1);
  while (s1 <= rem) { ++x; s0 = s1; s1 = dm_simplex_size32<M>(x + 1); }
  while (s0 > rem) { --x; s0 = dm_simplex_size32<M>(x); }
  *size = s0;
  return x;
}

// The peel of lam into layers x_1..x_M (ascending), in index type T.
template <int M, typename T>
__device__ __forceinline__ void dm_peel(uint64_t lam, T (&x)[M]) {
  if constexpr (sizeof(T) == 4) {
    uint32_t rem = (uint32_t)lam;
#pragma unroll
    for (int level = M; level >= 2; --level) {
      uint32_t s, v;
      switch (level) {   // level is a constant after unrolling
        case 5: v = dm_simplex_layer32<5>(rem, &s); break;
        case 4: v = dm_simplex_layer32<4>(rem, &s); break;
        case 3: v = dm_simplex_layer32<3>(rem, &s); break;
        default: v = dm_simplex_layer32<2>(rem, &s); break;
      }
      x[level - 1] = (T)v;
      rem -= s;
    }
    x[0] = (T)rem;
  } else {
    int64_t rem = (int64_t)lam;
#pragma unroll
    for (int level = M; level >= 2; --level) {
      int64_t v;
      switch (level) {
        case 5: v = dm_simplex_layer<5>(rem); rem -= dm_simplex_size<5>(v); break;
        case 4: v = dm_simplex_layer<4>(rem); rem -= dm_simplex_size<4>(v); break;
        case 3: v = dm_simplex_layer<3>(rem); rem -= dm_simplex_size<3>(v); break;
        default: v = dm_simplex_layer<2>(rem); rem -= dm_simplex_size<2>(v); break;
      }
      x[level - 1] = (T)v;
    }
    x[0] = (T)rem;
  }
}

// lam -> lam + 1 on the layers: the canonical order's odometer.  x_1 counts
// up to x_2, then returns to 0 and carries; the top layer is unbounded.
template <int M, typename T>
__device__ __forceinline__ void dm_peel_step(T (&x)[M]) {
  ++x[0];
#pragma unroll
  for (int l = 0; l < M - 1; ++l) {
    if (x[l] <= x[l + 1]) break;
    x[l] = 0;
    ++x[l + 1];
  }
}

// ---------------------------------------------------------------------------
// Unsigned division by a runtime divisor through a host-made multiplier
// (geometry.py: magic / magic_div, the round-up method with an add step):
//   t = mulhi(n, mul); q = (t + ((n - t) >> sh1)) >> sh2,
// exact for every n of the width (d = 1 is mul 1, sh1 = sh2 = 0).
// ---------------------------------------------------------------------------

struct DmMagic {
  uint64_t mul;
  int32_t sh1, sh2;
};

__device__ __forceinline__ uint32_t dm_mulhi(uint32_t a, uint32_t b) {
  return __umulhi(a, b);
}
__device__ __forceinline__ uint64_t dm_mulhi(uint64_t a, uint64_t b) {
  return __umul64hi(a, b);
}

template <typename U>
__device__ __forceinline__ U dm_div(U n, const DmMagic& d) {
  const U t = dm_mulhi(n, (U)d.mul);
  return (t + ((n - t) >> d.sh1)) >> d.sh2;
}
