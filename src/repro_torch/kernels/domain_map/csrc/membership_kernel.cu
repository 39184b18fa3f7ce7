// Bounding-box membership kernel: the paper's BB baseline (Sec. V.C).
//
// Replaces the TPU kernel
// repro/kernels/domain_map/kernel.py::_membership_kernel (built by
// build_membership_call).  It writes the 0/1 int32 discard test of the
// first `total` row-major cells of the box (cells past prod(extent) wrap
// around the box), bit for bit the membership tier in geometry.py on box
// axes (which are never negative):
//   PEEL    a chain of axes[lo] <= axes[hi] tests;
//   DIGITS  per level, the cell code sum (axis % scale) * scale^k against a
//           bitmask of the generator's codes, for ndigits levels or, where
//           the tier runs to the last nonzero digit (gasket2d,
//           sierpinski3d), every level.
//
// What bounds it on an H100: the mask, total * 4 bytes written once at
// 3.35 TB/s; there is no input.  The first version unravelled every cell
// with two 64-bit runtime divisions per axis and divided every axis by the
// scale at every level, and ran 6-20x that bound.  This one:
//   * each thread takes a run of 16 consecutive cells (8 for menger3d, see
//     dm_fractal_run), and a warp writes its 32 runs through shared memory
//     with 16-byte stores of 512 contiguous bytes;
//   * a run's first cell is unravelled with the host's multipliers
//     (DomainBox.div_*, geometry.py: magic): 32-bit where the padded total
//     is <= 2^32 (every paper box, pyramid3d's 2,998,443,008 cells too),
//     64-bit above; the rest step the last axis and carry;
//   * PEEL: the chain folds, per row, into rowok && lb <= a_last <= ub, so a
//     cell costs two compares;
//   * DIGITS: levels are taken T at a time (a group): whether a cell passes
//     a group's T levels is a table over the group's digits of every axis,
//     the membership of the level-T fractal on its scale^T cube
//     (scale^(T*dim) bytes <= 32 KB), which each block of a resident grid
//     builds once in shared memory from the generator's codes (the
//     descriptor's `allowed`; geometry.py: group_table rehearses it).  A run
//     folds the other axes' digits into the row's index once and tests the
//     groups above the lowest once for its block of scale^T cells and once
//     for the next; a cell costs one table read.
// The tier's early exit at the origin cell changes nothing here: code 0 is
// always allowed (the host checks it), so skipping all-zero levels is exact.
// Registers (ptxas -v, chip_smoke.py's build phase, NVIDIA H100 80GB HBM3 at
// 700.00 W), 32-bit / 64-bit: chain 34-44 / 38-56; the four compile-time
// fractal kernels 30-40 / 50-60; no spills, but for the generic scale's
// 64-bit kernels of dim 1 and 5 (44 and 72 bytes), which no registered
// domain takes.
#include "domain_map.cuh"

// cells per thread-run (geometry.py: RUN_CHAIN, fractal_run): 16, but 8
// for a fractal whose group block of scale^T cells is under 32 (menger3d's
// 27), where longer runs cross into the next block in most runs
constexpr int DM_RUN_CHAIN = 16;

struct DomainBox {
  int64_t extent[DM_MAX_DIM];
  DmMagic div_stride[DM_MAX_DIM];   // cell / row-major stride k, at the
                                    //   launch's width
  DmMagic div_extent0;              // q_0 / extent[0]: the padding's wrap
  int32_t group_levels;             // DIGITS: T, levels per table group
  int32_t groups;                   // DIGITS: groups to test, >= 1
  int64_t top_mod;                  // DIGITS: scale^(levels in the top group)
                                    //   where the levels stop short of the
                                    //   axes' digits, else 0
};

// cell index -> box axes (the row-major unravel, axis 0 wrapping)
template <int D, typename U>
__device__ __forceinline__ void dm_unravel(const DomainBox& box, U cell,
                                           U (&a)[D]) {
  U prev = 0;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const U q = dm_div<U>(cell, box.div_stride[k]);
    if (k == 0) {
      a[0] = q - dm_div<U>(q, box.div_extent0) * (U)box.extent[0];
    } else {
      a[k] = q - prev * (U)box.extent[k];
    }
    prev = q;
  }
}

// the last axis has reached its extent: 0, and carry into the others
template <int D, typename U>
__device__ __forceinline__ void dm_carry_row(const DomainBox& box, U (&a)[D]) {
  a[D - 1] = 0;
#pragma unroll
  for (int k = D - 2; k >= 0; --k) {
    if (++a[k] < (U)box.extent[k]) break;
    a[k] = 0;
  }
}

template <int D, typename U>
__device__ __forceinline__ U dm_pick_u(const U (&a)[D], int idx) {
  U v = a[0];
#pragma unroll
  for (int j = 1; j < D; ++j) v = (idx == j) ? a[j] : v;
  return v;
}

// ---------------------------------------------------------------------------
// PEEL: chain domains
// ---------------------------------------------------------------------------

template <int D, typename U>
struct DmChainRow {
  bool ok;   // the pairs without the last axis
  U lb, ub;  // lb <= a_last <= ub for the pairs with it
};

template <int D, typename U>
__device__ __forceinline__ DmChainRow<D, U> dm_chain_row(const DomainGeom& g,
                                                         const U (&a)[D]) {
  DmChainRow<D, U> row{true, 0, ~(U)0};
#pragma unroll
  for (int c = 0; c < DM_MAX_DIM; ++c) {
    if (c < g.nchain) {
      const int lo = g.chain_lo[c], hi = g.chain_hi[c];
      const U vlo = dm_pick_u(a, lo), vhi = dm_pick_u(a, hi);
      if (lo != D - 1 && hi != D - 1) {
        row.ok = row.ok && vlo <= vhi;
      } else if (lo != D - 1) {           // a[lo] <= a_last
        row.lb = vlo > row.lb ? vlo : row.lb;
      } else if (hi != D - 1) {           // a_last <= a[hi]
        row.ub = vhi < row.ub ? vhi : row.ub;
      }
    }
  }
  return row;
}

template <int D, typename U>
__global__ void __launch_bounds__(DM_THREADS)
dm_membership_chain_kernel(DomainGeom g, DomainBox box,
                           int32_t* __restrict__ out, int64_t total) {
  __shared__ int4 stage[DM_STAGE_INT4(DM_RUN_CHAIN)];
  const int64_t runs = (total + DM_RUN_CHAIN - 1) / DM_RUN_CHAIN;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const U last_ext = (U)box.extent[D - 1];
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < runs;
       r += stride) {
    const int64_t i0 = r * DM_RUN_CHAIN;
    U a[D];
    dm_unravel<D, U>(box, (U)i0, a);
    DmChainRow<D, U> row = dm_chain_row<D, U>(g, a);
    int32_t v[DM_RUN_CHAIN];
#pragma unroll
    for (int j = 0; j < DM_RUN_CHAIN; ++j) {
      const U x = a[D - 1];
      v[j] = (row.ok && x >= row.lb && x <= row.ub) ? 1 : 0;
      if (j + 1 < DM_RUN_CHAIN && ++a[D - 1] == last_ext) {
        dm_carry_row<D, U>(box, a);
        row = dm_chain_row<D, U>(g, a);
      }
    }
    dm_store_run(out, i0, total, true, v, stage);
  }
}

// ---------------------------------------------------------------------------
// DIGITS: fractal domains, T levels per table read
// ---------------------------------------------------------------------------

// Levels per group: the most with scale^(T * D) table bytes <= 32 KB; the
// generic scale (S == 0, from the descriptor) takes one level a group.
__host__ __device__ constexpr int dm_group_levels(int S, int D) {
  if (S <= 0) return 1;
  int64_t sd = 1;
  for (int i = 0; i < D; ++i) sd *= S;
  int T = 0;
  int64_t e = 1;
  while (e * sd <= 32768) { e *= sd; ++T; }
  return T;
}

// Cells per fractal run (geometry.py: fractal_run).
__host__ __device__ constexpr int dm_fractal_run(int S, int D) {
  int64_t q = 1;
  for (int i = 0; i < dm_group_levels(S, D); ++i) q *= S;
  return S > 0 && q < 32 ? DM_RUN_CHAIN / 2 : DM_RUN_CHAIN;
}

// Whether the groups above the lowest pass, for the cells whose other axes
// are a[0..D-2] and whose last axis lies in block hl of Q cells (up), or in
// block hl + 1 (up2): group g's digits of every axis index the table (the
// top group's reduced mod top_mod where the levels stop inside it).
template <int D, typename U>
__device__ __forceinline__ void dm_upper_ok(const uint8_t* okt, U Q,
                                            int groups, U top_mod,
                                            const U (&a)[D], U hl, bool& up,
                                            bool& up2) {
  U t[D];
#pragma unroll
  for (int k = 0; k < D - 1; ++k) t[k] = a[k] / Q;
  t[D - 1] = hl;
  U t2 = hl + 1;
  up = up2 = true;
  for (int gi = 1; gi < groups && (up || up2); ++gi) {
    U any = t2;
#pragma unroll
    for (int k = 0; k < D; ++k) any |= t[k];
    if (any == 0) break;   // every higher group is the origin cube's cell 0
    const bool top = gi == groups - 1 && top_mod != 0;
    auto digit = [&](U& x) {
      const U q = x / Q;
      U d = x - q * Q;
      if (top) d %= top_mod;
      x = q;
      return (uint32_t)d;
    };
    uint32_t idx = 0;
#pragma unroll
    for (int k = 0; k < D - 1; ++k) idx = idx * (uint32_t)Q + digit(t[k]);
    idx *= (uint32_t)Q;
    const uint32_t d1 = digit(t[D - 1]), d2 = digit(t2);
    up = up && okt[idx + d1];
    up2 = up2 && okt[idx + d2];
  }
}

// Whether cell e of the group cube passes its T levels: e's base-Q digits
// are the axes (axis 0 the highest), and level l's code sums axis k's l-th
// base-scale digit times scale^(D-1-k), the tier's cell code.
template <int D>
__device__ __forceinline__ uint8_t dm_group_cell_ok(uint32_t e, uint32_t Q,
                                                    uint32_t scale, int T,
                                                    uint32_t allowed) {
  uint32_t ax[D];
#pragma unroll
  for (int k = D - 1; k >= 0; --k) {
    ax[k] = e % Q;
    e /= Q;
  }
  bool ok = true;
  for (int l = 0; l < T; ++l) {
    uint32_t code = 0;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      code = code * scale + ax[k] % scale;
      ax[k] /= scale;
    }
    ok = ok && ((allowed >> code) & 1u);
  }
  return ok ? 1 : 0;
}

template <int S, int D, typename U>
__global__ void __launch_bounds__(DM_THREADS)
dm_membership_digits_kernel(DomainGeom g, DomainBox box,
                            int32_t* __restrict__ out, int64_t total) {
  constexpr int R = dm_fractal_run(S, D);
  __shared__ int4 stage[DM_STAGE_INT4(R)];
  extern __shared__ uint8_t okt[];   // [Q^D]: group index -> passes
  constexpr int TC = dm_group_levels(S, D);
  const uint32_t scale = S > 0 ? (uint32_t)S : (uint32_t)g.scale;
  const U Q = S > 0 ? (U)dm_ipow<TC>(S > 0 ? S : 1) : (U)scale;
  uint32_t QD = 1;
#pragma unroll
  for (int k = 0; k < D; ++k) QD *= (uint32_t)Q;
  // the block's table (compile-time Q, scale and T where S > 0, so its
  // divisions are multiplies)
  for (uint32_t e = threadIdx.x; e < QD; e += blockDim.x)
    okt[e] = dm_group_cell_ok<D>(e, (uint32_t)Q, scale, TC, g.allowed);
  __syncthreads();

  const int groups = box.groups;
  const U top_mod = (U)box.top_mod;
  const bool reduce0 = groups == 1 && top_mod != 0;
  const U last_ext = (U)box.extent[D - 1];
  const int64_t runs = (total + R - 1) / R;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < runs;
       r += stride) {
    const int64_t i0 = r * R;
    U a[D];
    dm_unravel<D, U>(box, (U)i0, a);
    // the row's index (the other axes' lowest-group digits), the last
    // axis's lowest-group digits, and the upper groups' test for this block
    // of Q cells and the next, both at once: a run crosses into the next
    // block at most once where Q >= R, and a test taken at the
    // crossing would diverge within the warp
    uint32_t hidx = 0, low = 0;
    bool up = true, up2 = true;
    auto setup = [&]() {
      hidx = 0;
#pragma unroll
      for (int k = 0; k < D - 1; ++k) {
        U d = a[k] % Q;
        if (reduce0) d %= top_mod;
        hidx = hidx * (uint32_t)Q + (uint32_t)d;
      }
      hidx *= (uint32_t)Q;
      const U hl = a[D - 1] / Q;
      low = (uint32_t)(a[D - 1] - hl * Q);
      dm_upper_ok<D, U>(okt, Q, groups, top_mod, a, hl, up, up2);
    };
    setup();
    int32_t v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint32_t d = reduce0 ? low % (uint32_t)top_mod : low;
      v[j] = (up && okt[hidx + d]) ? 1 : 0;
      if (j + 1 < R) {
        ++low;
        if (++a[D - 1] == last_ext) {
          dm_carry_row<D, U>(box, a);
          setup();
        } else if (low == (uint32_t)Q) {
          low = 0;
          up = up2;
          if ((uint32_t)Q < R)   // the generic scale only
            dm_upper_ok<D, U>(okt, Q, groups, top_mod, a, a[D - 1] / Q, up,
                              up2);
        }
      }
    }
    dm_store_run(out, i0, total, true, v, stage);
  }
}

template <int D, typename U>
static void dm_launch_chain(const DomainGeom& g, const DomainBox& box,
                            int32_t* out, int64_t total, cudaStream_t st) {
  const unsigned int blocks = dm_blocks((total + DM_RUN_CHAIN - 1) / DM_RUN_CHAIN);
  dm_membership_chain_kernel<D, U><<<blocks, DM_THREADS, 0, st>>>(g, box, out,
                                                                  total);
}

template <int S, int D, typename U>
static int dm_launch_digits(const DomainGeom& g, const DomainBox& box,
                            int32_t* out, int64_t total, cudaStream_t st) {
  constexpr int TC = dm_group_levels(S, D);
  constexpr int R = dm_fractal_run(S, D);
  if (box.group_levels != TC || box.groups < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t Q = S > 0 ? dm_ipow<TC>(S > 0 ? S : 1) : g.scale;
  int64_t QD = 1;
  for (int k = 0; k < D; ++k) QD *= Q;
  // the most the instantiation's table can take (the limit is set once):
  // the generic scale's table is its codes, at most 32
  constexpr int64_t QD_max = S > 0 ? dm_ipow<D>(dm_ipow<TC>(S > 0 ? S : 1))
                                   : 32;
  static DmResident resident;
  auto kern = dm_membership_digits_kernel<S, D, U>;
  const unsigned int blocks =
      dm_resident_blocks(kern, (total + R - 1) / R, (size_t)QD_max, resident);
  kern<<<blocks, DM_THREADS, (size_t)QD, st>>>(g, box, out, total);
  return 0;
}

template <typename U>
static int dm_launch(const DomainGeom& g, const DomainBox& box, int32_t* out,
                     int64_t total, cudaStream_t st) {
  if (g.family == DM_PEEL) {
    switch (g.dim) {
      case 1: dm_launch_chain<1, U>(g, box, out, total, st); break;
      case 2: dm_launch_chain<2, U>(g, box, out, total, st); break;
      case 3: dm_launch_chain<3, U>(g, box, out, total, st); break;
      case 4: dm_launch_chain<4, U>(g, box, out, total, st); break;
      default: dm_launch_chain<5, U>(g, box, out, total, st); break;
    }
    return 0;
  }
  const int key = g.scale * 8 + g.dim;
  switch (key) {
    case 2 * 8 + 2: return dm_launch_digits<2, 2, U>(g, box, out, total, st);
    case 2 * 8 + 3: return dm_launch_digits<2, 3, U>(g, box, out, total, st);
    case 3 * 8 + 2: return dm_launch_digits<3, 2, U>(g, box, out, total, st);
    case 3 * 8 + 3: return dm_launch_digits<3, 3, U>(g, box, out, total, st);
    default:
      switch (g.dim) {
        case 1: return dm_launch_digits<0, 1, U>(g, box, out, total, st);
        case 2: return dm_launch_digits<0, 2, U>(g, box, out, total, st);
        case 3: return dm_launch_digits<0, 3, U>(g, box, out, total, st);
        case 4: return dm_launch_digits<0, 4, U>(g, box, out, total, st);
        default: return dm_launch_digits<0, 5, U>(g, box, out, total, st);
      }
  }
}

// Launches on `stream`; returns the launch's cudaError_t (0 on success), or
// cudaErrorInvalidValue for a descriptor this file has no kernel for or a
// 32-bit launch past 2^32 cells.  bits is 32 or 64 (geometry.py:
// membership_index_bits); the box's multipliers are made for that width.
extern "C" int dm_membership_launch(const DomainGeom* g, const DomainBox* box,
                                    int32_t* out, int64_t total, int32_t bits,
                                    void* stream) {
  if (total <= 0) return 0;
  if (g->dim < 1 || g->dim > DM_MAX_DIM || (bits != 32 && bits != 64) ||
      (bits == 32 && total > (int64_t(1) << 32)))
    return (int)cudaErrorInvalidValue;
  if (g->family == DM_DIGITS) {
    // every cell code must index the 32-bit mask, and code 0 (the origin
    // cell) must be allowed for the early exit to be exact
    int64_t codes = 1;
    for (int k = 0; k < g->dim; ++k) codes *= g->scale;
    if (g->scale < 2 || codes > 32 || !(g->allowed & 1u))
      return (int)cudaErrorInvalidValue;
  } else if (g->family != DM_PEEL) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = bits == 32
                     ? dm_launch<uint32_t>(*g, *box, out, total, st)
                     : dm_launch<uint64_t>(*g, *box, out, total, st);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
