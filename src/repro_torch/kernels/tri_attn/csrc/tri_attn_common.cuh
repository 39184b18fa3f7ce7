// What the tri_attn kernels share: the includes, the mask value and the
// paper's exact 2D triangular map.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TA_NEG_INF (-1e30f)

// T(n) = n(n+1)/2: the triangle's cells, the start of row n.
__host__ __device__ __forceinline__ int64_t ta_tri(int64_t n) {
  return n * (n + 1) / 2;
}

// The row of the paper's 2D triangular map: q with T(q) <= t < T(q+1), exact:
// int64 8t+1, a float64 square-root seed, then a ladder that corrects the
// seed in both directions until r = isqrt(8t+1).
__device__ __forceinline__ int64_t ta_tri_row(int64_t t) {
  const int64_t v = 8 * t + 1;
  int64_t r = (int64_t)sqrt((double)v);
  while ((r + 1) * (r + 1) <= v) ++r;
  while (r * r > v) --r;
  return (r - 1) / 2;
}

// The paper's 2D triangular map g(lambda) = (i, j), j <= i (the sm90 route's).
__device__ __forceinline__ void ta_lam_to_ij(int64_t lam, int32_t* i,
                                             int32_t* j) {
  const int64_t ii = ta_tri_row(lam);
  *i = (int32_t)ii;
  *j = (int32_t)(lam - ii * (ii + 1) / 2);
}
