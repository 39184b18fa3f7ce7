// Shared geometry for the two domain-map kernels (map_kernel.cu,
// membership_kernel.cu): the launch descriptor and the __device__ code of
// the two geometry families in kernels/domain_map/geometry.py.
//
//   PEEL    the m-simplex layer peel: per level, the largest x with
//           C(x+m-1, m) <= lam from a float64 m-th-root seed and an exact
//           int64 ladder.  tri2d and pyramid3d are the m = 2, 3 peels with
//           their axes permuted; msimplex2-5 are the peel as it stands.
//   DIGITS  the base-B digit engine for the six digit fractals: digit d adds
//           vecs[d] * scale^level.  The generator table (at most 20 vectors)
//           arrives in the descriptor; a gather from it replaces the TPU
//           kernel's where-ladders, which the TPU needed for lack of gathers.
//
// All index math is int64.  The descriptor layout must match the ctypes
// structure _Geom in kernel.py field for field.
#pragma once

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

// Number of blocks for a grid-stride loop over n elements.
static inline unsigned int dm_blocks(int64_t n) {
  int64_t b = (n + DM_THREADS - 1) / DM_THREADS;
  const int64_t cap = int64_t(1) << 24;
  return (unsigned int)(b < cap ? b : cap);
}

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

// The peel: layers[level-1] for level = M..1 (layers ascending x_1..x_M).
template <int M>
__device__ __forceinline__ void dm_peel(int64_t lam,
                                        int64_t (&layers)[DM_MAX_DIM]) {
  int64_t rem = lam;
#pragma unroll
  for (int level = M; level >= 2; --level) {
    int64_t x;
    switch (level) {   // level is a constant after unrolling
      case 5: x = dm_simplex_layer<5>(rem); rem -= dm_simplex_size<5>(x); break;
      case 4: x = dm_simplex_layer<4>(rem); rem -= dm_simplex_size<4>(x); break;
      case 3: x = dm_simplex_layer<3>(rem); rem -= dm_simplex_size<3>(x); break;
      default: x = dm_simplex_layer<2>(rem); rem -= dm_simplex_size<2>(x); break;
    }
    layers[level - 1] = x;
  }
  layers[0] = rem;
}

// value of a[idx] for a runtime idx, without spilling a to local memory
__device__ __forceinline__ int64_t dm_pick(const int64_t (&a)[DM_MAX_DIM],
                                           int idx) {
  int64_t v = a[0];
#pragma unroll
  for (int j = 1; j < DM_MAX_DIM; ++j) v = (idx == j) ? a[j] : v;
  return v;
}
