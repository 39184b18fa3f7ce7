// Mapped-grid coordinate kernel: the paper's mapped strategy (Sec. V.C).
//
// Replaces the TPU kernel repro/kernels/domain_map/kernel.py::_map_kernel
// (built by build_map_call).  One thread per lambda, lambda = lam_offset + i
// in int64, writing a (dim, n) int32 array: row k holds axis k, so
// neighbouring threads store to neighbouring addresses.  The TPU kernel's
// zero rows dim..7 existed only for its (8, 128) tiling and are dropped.
//
// What bounds it on an H100: the output, n * dim * 4 bytes written once at
// 3.35 TB/s; there is no input.  This first version is the simple one:
// compile-time bases and peel depths turn the int64 divisions into
// multiplies, and nothing else is tuned yet.
#include "domain_map.cuh"

template <int M>
__global__ void dm_map_peel_kernel(DomainGeom g, int32_t* __restrict__ out,
                                   int64_t n, int64_t lam_offset) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t layers[DM_MAX_DIM] = {0, 0, 0, 0, 0};
    dm_peel<M>(lam_offset + i, layers);
#pragma unroll
    for (int k = 0; k < M; ++k)
      out[(int64_t)k * n + i] = (int32_t)dm_pick(layers, g.perm[k]);
  }
}

// B > 0: compile-time base; B == 0: the base comes from the descriptor.
template <int B>
__global__ void dm_map_digits_kernel(DomainGeom g, int32_t* __restrict__ out,
                                     int64_t n, int64_t lam_offset,
                                     int32_t ndigits) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const uint64_t base = B > 0 ? (uint64_t)B : (uint64_t)g.base;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t axes[DM_MAX_DIM] = {0, 0, 0, 0, 0};
    uint64_t rem = (uint64_t)(lam_offset + i);
    int64_t s = 1;
    // exactly ndigits digits; once rem is 0 every further digit is the
    // origin cell and adds nothing
    for (int level = 0; level < ndigits && rem != 0; ++level) {
      const uint64_t q = rem / base;
      const int d = (int)(rem - q * base);
      rem = q;
#pragma unroll
      for (int k = 0; k < DM_MAX_DIM; ++k)
        if (k < g.dim) axes[k] += (int64_t)g.vecs[d * DM_MAX_DIM + k] * s;
      s *= g.scale;
    }
#pragma unroll
    for (int k = 0; k < DM_MAX_DIM; ++k)
      if (k < g.dim) out[(int64_t)k * n + i] = (int32_t)axes[k];
  }
}

// Launches on `stream`; returns the launch's cudaError_t (0 on success), or
// cudaErrorInvalidValue for a descriptor this file has no kernel for.
extern "C" int dm_map_launch(const DomainGeom* g, int32_t* out, int64_t n,
                             int64_t lam_offset, int32_t ndigits,
                             void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned int blocks = dm_blocks(n);
  if (g->family == DM_PEEL) {
    if (g->dim != g->m) return (int)cudaErrorInvalidValue;
    switch (g->m) {
      case 2: dm_map_peel_kernel<2><<<blocks, DM_THREADS, 0, st>>>(*g, out, n, lam_offset); break;
      case 3: dm_map_peel_kernel<3><<<blocks, DM_THREADS, 0, st>>>(*g, out, n, lam_offset); break;
      case 4: dm_map_peel_kernel<4><<<blocks, DM_THREADS, 0, st>>>(*g, out, n, lam_offset); break;
      case 5: dm_map_peel_kernel<5><<<blocks, DM_THREADS, 0, st>>>(*g, out, n, lam_offset); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (g->family == DM_DIGITS) {
    if (g->dim < 1 || g->dim > DM_MAX_DIM || g->base < 2 ||
        g->base > DM_MAX_BASE)
      return (int)cudaErrorInvalidValue;
    switch (g->base) {
      case 3: dm_map_digits_kernel<3><<<blocks, DM_THREADS, 0, st>>>(*g, out, n, lam_offset, ndigits); break;
      case 4: dm_map_digits_kernel<4><<<blocks, DM_THREADS, 0, st>>>(*g, out, n, lam_offset, ndigits); break;
      case 5: dm_map_digits_kernel<5><<<blocks, DM_THREADS, 0, st>>>(*g, out, n, lam_offset, ndigits); break;
      case 8: dm_map_digits_kernel<8><<<blocks, DM_THREADS, 0, st>>>(*g, out, n, lam_offset, ndigits); break;
      case 20: dm_map_digits_kernel<20><<<blocks, DM_THREADS, 0, st>>>(*g, out, n, lam_offset, ndigits); break;
      default: dm_map_digits_kernel<0><<<blocks, DM_THREADS, 0, st>>>(*g, out, n, lam_offset, ndigits); break;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
