// Bounding-box membership kernel: the paper's BB baseline (Sec. V.C).
//
// Replaces the TPU kernel
// repro/kernels/domain_map/kernel.py::_membership_kernel (built by
// build_membership_call).  One thread per cell of the box: the cell's
// row-major index (int64, so boxes past 2^31 cells are exact) unravels into
// box axes, the domain's membership test runs, and a 0/1 int32 is written.
// The test reproduces the membership tier in geometry.py bit for bit on box
// axes (which are never negative):
//   PEEL    a chain of axes[lo] <= axes[hi] tests;
//   DIGITS  per level, the cell code sum (axis % scale) * scale^k against a
//           bitmask of the generator's codes (at most 27 codes), for
//           ndigits levels or, where the tier is a bitwise AND over the
//           whole axis (gasket2d, sierpinski3d), up to the last nonzero
//           digit.
//
// What bounds it on an H100: the mask, total * 4 bytes written once at
// 3.35 TB/s; there is no input.  The int64 unravel divides by the box
// strides at run time; that and the per-level divisions are left for a
// later, faster version.
#include "domain_map.cuh"

struct DomainBox {
  int64_t extent[DM_MAX_DIM];
  int64_t stride[DM_MAX_DIM];   // row-major: stride[dim-1] = 1
};

__device__ __forceinline__ void dm_unravel(const DomainGeom& g,
                                           const DomainBox& box, int64_t lam,
                                           int64_t (&axes)[DM_MAX_DIM]) {
#pragma unroll
  for (int k = 0; k < DM_MAX_DIM; ++k)
    axes[k] = k < g.dim ? (lam / box.stride[k]) % box.extent[k] : 0;
}

__global__ void dm_membership_chain_kernel(DomainGeom g, DomainBox box,
                                           int32_t* __restrict__ out,
                                           int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    int64_t axes[DM_MAX_DIM];
    dm_unravel(g, box, i, axes);
    bool ok = true;
#pragma unroll
    for (int c = 0; c < DM_MAX_DIM; ++c)
      if (c < g.nchain)
        ok = ok && dm_pick(axes, g.chain_lo[c]) <= dm_pick(axes, g.chain_hi[c]);
    out[i] = ok ? 1 : 0;
  }
}

// S > 0: compile-time scale; S == 0: the scale comes from the descriptor.
template <int S>
__global__ void dm_membership_digits_kernel(DomainGeom g, DomainBox box,
                                            int32_t* __restrict__ out,
                                            int64_t total, int32_t levels) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t scale = S > 0 ? S : g.scale;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    int64_t axes[DM_MAX_DIM];
    dm_unravel(g, box, i, axes);
    bool ok = true;
    for (int level = 0; level < levels && ok; ++level) {
      bool any = false;
#pragma unroll
      for (int k = 0; k < DM_MAX_DIM; ++k) any = any || axes[k] != 0;
      if (!any) break;   // the origin cell is always allowed from here on
      uint32_t code = 0;
#pragma unroll
      for (int k = 0; k < DM_MAX_DIM; ++k) {
        if (k < g.dim) {
          const int64_t q = axes[k] / scale;
          code = code * (uint32_t)scale + (uint32_t)(axes[k] - q * scale);
          axes[k] = q;
        }
      }
      ok = (g.allowed >> code) & 1u;
    }
    out[i] = ok ? 1 : 0;
  }
}

// Launches on `stream`; returns the launch's cudaError_t (0 on success), or
// cudaErrorInvalidValue for a descriptor this file has no kernel for.
extern "C" int dm_membership_launch(const DomainGeom* g, const DomainBox* box,
                                    int32_t* out, int64_t total,
                                    int32_t ndigits, void* stream) {
  if (total <= 0) return 0;
  if (g->dim < 1 || g->dim > DM_MAX_DIM) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned int blocks = dm_blocks(total);
  if (g->family == DM_PEEL) {
    dm_membership_chain_kernel<<<blocks, DM_THREADS, 0, st>>>(*g, *box, out,
                                                              total);
  } else if (g->family == DM_DIGITS) {
    // every cell code must index the 32-bit mask
    int64_t codes = 1;
    for (int k = 0; k < g->dim; ++k) codes *= g->scale;
    if (g->scale < 2 || codes > 32) return (int)cudaErrorInvalidValue;
    const int32_t levels = g->all_levels ? 64 : ndigits;
    switch (g->scale) {
      case 2: dm_membership_digits_kernel<2><<<blocks, DM_THREADS, 0, st>>>(*g, *box, out, total, levels); break;
      case 3: dm_membership_digits_kernel<3><<<blocks, DM_THREADS, 0, st>>>(*g, *box, out, total, levels); break;
      default: dm_membership_digits_kernel<0><<<blocks, DM_THREADS, 0, st>>>(*g, *box, out, total, levels); break;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
