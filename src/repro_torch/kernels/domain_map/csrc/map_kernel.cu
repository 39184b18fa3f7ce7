// Mapped-grid coordinate kernel: the paper's mapped strategy (Sec. V.C).
//
// Replaces the TPU kernel repro/kernels/domain_map/kernel.py::_map_kernel
// (built by build_map_call).  It writes a (dim, n) int32 array, row k = axis
// k, for lambda = lam_offset + i; the TPU kernel's zero rows dim..7 existed
// only for its (8, 128) tiling and are dropped.
//
// What bounds it on an H100: the output, n * dim * 4 bytes written once at
// 3.35 TB/s; there is no input.  The first version derived every lambda from
// scratch (a float64 pow and an int64 ladder per peel level, up to ndigits
// 64-bit divisions per digit map) and ran 4-18x that bound.  This one:
//   * each thread takes a run of consecutive lambda (16 for PEEL, 4 for
//     DIGITS), and a warp writes its 32 runs of each row through shared
//     memory with 16-byte stores of 512 contiguous bytes (scalar stores
//     where a row is not 16-byte aligned, and in the ragged tail);
//   * PEEL: the run's first lambda is peeled in full, the rest step the
//     layers' odometer (x_1 + 1 up to x_2, then carry).  For m >= 4, where
//     the host proves it exact (lam_offset + n <= DM_LAM32_PEEL[m]), the
//     peel is 32-bit: an fp32 root seed from the special-function unit and
//     a uint32 ladder; above it, and for m = 2, 3 (where the 32-bit peel
//     measured no faster), the int64 peel with its float64 seed;
//   * DIGITS: map(lam) = map_L(lam mod B^L) + scale^L * map(lam div B^L).
//     Each block builds map_L for all B^L low parts in shared memory
//     (B^L * dim * 4 <= 32 KB), once, and strides over the runs; a run
//     derives the high part once (one table read per L digits), and each
//     point costs one shared-memory read and an add per axis.  The few
//     divisions left (one per L digits a run, by a compile-time B^L) stay
//     64-bit: a 32-bit path measured no faster at N = 5e8.
// Coordinates are the exact ones truncated to int32, as the plain version's;
// the digit sums wrap in uint32, which truncation commutes with.
//
// At N = 5e8 msimplex4 and msimplex5 take the 32-bit path (the lower bound,
// m = 5, is 846,678,392); the other PEEL domains and DIGITS the 64-bit one.
// Registers (ptxas -v, chip_smoke.py's build phase, NVIDIA H100 80GB HBM3 at
// 700.00 W): the peel kernels 64 (m = 2), 79 (3), 98 (4), 121 (5), either
// width; the digit kernels 32-38 (the six domains), 30-46 (the generic
// base); no spills.
#include "domain_map.cuh"

// lambda per thread-run (geometry.py: RUN_PEEL, RUN_DIGITS): the peel's
// derive is dear, so its runs are long; the digit runs derive cheaply, and
// short runs keep their registers few
constexpr int DM_RUN_PEEL = 16;
constexpr int DM_RUN_DIGITS = 4;

// exclusive lambda bound of the 32-bit peel, by m: C(XMAX+m-1, m) for
// XMAX = dm_xmax32(m) (geometry.py: PEEL_LAM32, PEEL32_M); 0 where m has no
// 32-bit path
static const int64_t DM_LAM32_PEEL[6] = {0, 0, 0, 0, 1071993300LL,
                                         846678392LL};

template <int M, typename T>
__global__ void __launch_bounds__(DM_THREADS)
dm_map_peel_kernel(DomainGeom g, int32_t* __restrict__ out, int64_t n,
                   int64_t lam_offset) {
  __shared__ int4 stage[DM_STAGE_INT4(DM_RUN_PEEL)];
  // the output row of layer l
  int32_t* rows[M];
  bool aligned[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
#pragma unroll
    for (int l = 0; l < M; ++l)
      if (g.perm[k] == l) {
        rows[l] = out + (int64_t)k * n;
        aligned[l] = (((int64_t)k * n) & 3) == 0;
      }
  }
  const int64_t runs = (n + DM_RUN_PEEL - 1) / DM_RUN_PEEL;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < runs;
       r += stride) {
    const int64_t i0 = r * DM_RUN_PEEL;
    T x[M];
    dm_peel<M, T>((uint64_t)(lam_offset + i0), x);
    int32_t v[M][DM_RUN_PEEL];
#pragma unroll
    for (int j = 0; j < DM_RUN_PEEL; ++j) {
#pragma unroll
      for (int l = 0; l < M; ++l) v[l][j] = (int32_t)x[l];
      if (j + 1 < DM_RUN_PEEL) dm_peel_step<M, T>(x);
    }
#pragma unroll
    for (int l = 0; l < M; ++l)
      dm_store_run(rows[l], i0, n, aligned[l], v[l], stage);
  }
}

// Low digits per table entry: the most with B^L * D * 4 bytes <= 32 KB.
// The generic base (B == 0) takes the fewest with B^L >= DM_RUN_DIGITS.
// Either way B^L >= DM_RUN_DIGITS, so a run crosses into the next high part
// at most once.
__host__ __device__ constexpr int dm_table_digits(int B, int D) {
  int L = 0;
  int64_t e = 1;
  while (e < DM_RUN_DIGITS || e * B * D * 4 <= 32768) { e *= B; ++L; }
  return L;
}
__host__ __device__ inline int dm_generic_digits(int base) {
  int L = 0;
  int64_t e = 1;
  while (e < DM_RUN_DIGITS) { e *= base; ++L; }
  return L;
}

// hi[k] = scale^L * map_rd(q): the digits of q (those above a table's L),
// up to rd of them, one table read per group of L digits.  tab is the shared
// table, SoA: tab[k * BL + lo] = map_L(lo) on axis k.
template <int D>
__device__ __forceinline__ void dm_digits_high(uint64_t q, int rd, int L,
                                               uint64_t BL, uint32_t SL,
                                               uint32_t base,
                                               const uint32_t* tab,
                                               uint32_t (&hi)[D]) {
  uint32_t s = SL;
#pragma unroll
  for (int k = 0; k < D; ++k) hi[k] = 0;
  while (rd > 0 && q != 0) {
    uint64_t d;
    if (rd >= L) {
      d = q % BL;
      q /= BL;
      rd -= L;
    } else {   // the top rd < L digits: q mod B^rd, which is q itself as a
               // rule (the launch's lambda < B^ndigits)
      uint64_t pw = 1;
      for (int i = 0; i < rd; ++i) pw *= base;
      d = q < pw ? q : q % pw;
      q = 0;
      rd = 0;
    }
#pragma unroll
    for (int k = 0; k < D; ++k)
      hi[k] += s * tab[(uint32_t)k * (uint32_t)BL + (uint32_t)d];
    s *= SL;
  }
}

// B > 0: compile-time base (and L, B^L); B == 0: the base from the
// descriptor, with the fewest digits a table entry may hold.
template <int B, int D>
__global__ void __launch_bounds__(DM_THREADS)
dm_map_digits_kernel(DomainGeom g, int32_t* __restrict__ out, int64_t n,
                     int64_t lam_offset, int32_t ndigits) {
  __shared__ int4 stage[DM_STAGE_INT4(DM_RUN_DIGITS)];
  extern __shared__ uint32_t tab[];   // [D][BL]
  constexpr int LC = B > 0 ? dm_table_digits(B, D) : 0;
  const uint32_t base = B > 0 ? (uint32_t)B : (uint32_t)g.base;
  const int L = B > 0 ? LC : dm_generic_digits((int)base);
  uint64_t BL = 1;
  if (B > 0) {
    BL = (uint64_t)dm_ipow<LC>(B);
  } else {
    for (int i = 0; i < L; ++i) BL *= base;
  }
  const uint32_t scale = (uint32_t)g.scale;
  uint32_t SL = 1;
  for (int i = 0; i < L; ++i) SL *= scale;
  // map_Le(lo) for every lo < B^L, Le = min(L, ndigits): digits past
  // ndigits are dropped, as the plain version drops them
  const int Le = ndigits < L ? ndigits : L;
  for (uint32_t e = threadIdx.x; e < (uint32_t)BL; e += blockDim.x) {
    uint32_t acc[D], s = 1, rem = e;
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = 0;
    for (int l = 0; l < Le; ++l) {
      const uint32_t d = rem % base;
      rem /= base;
#pragma unroll
      for (int k = 0; k < D; ++k)
        acc[k] += s * (uint32_t)g.vecs[d * DM_MAX_DIM + k];
      s *= scale;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) tab[(uint32_t)k * (uint32_t)BL + e] = acc[k];
  }
  __syncthreads();

  const int rd = ndigits - L;   // digits above the table's
  int32_t* rows[D];
  bool aligned[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    rows[k] = out + (int64_t)k * n;
    aligned[k] = (((int64_t)k * n) & 3) == 0;
  }
  const int64_t runs = (n + DM_RUN_DIGITS - 1) / DM_RUN_DIGITS;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < runs;
       r += stride) {
    const int64_t i0 = r * DM_RUN_DIGITS;
    const uint64_t lam0 = (uint64_t)(lam_offset + i0);
    const uint64_t q = lam0 / BL;
    const uint32_t lo0 = (uint32_t)(lam0 - q * BL);
    uint32_t hi[D], hi2[D];
    dm_digits_high<D>(q, rd, L, BL, SL, base, tab, hi);
    // the run crosses into the next high part (rare: DM_RUN_DIGITS << B^L)
    if (lo0 + DM_RUN_DIGITS > (uint32_t)BL) {
      dm_digits_high<D>(q + 1, rd, L, BL, SL, base, tab, hi2);
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) hi2[k] = hi[k];
    }
    int32_t v[D][DM_RUN_DIGITS];
#pragma unroll
    for (int j = 0; j < DM_RUN_DIGITS; ++j) {
      uint32_t lo = lo0 + j;
      const bool c = lo >= (uint32_t)BL;
      lo = c ? lo - (uint32_t)BL : lo;
#pragma unroll
      for (int k = 0; k < D; ++k)
        v[k][j] = (int32_t)(tab[(uint32_t)k * (uint32_t)BL + lo] +
                            (c ? hi2[k] : hi[k]));
    }
#pragma unroll
    for (int k = 0; k < D; ++k)
      dm_store_run(rows[k], i0, n, aligned[k], v[k], stage);
  }
}

template <int M>
static int dm_launch_peel(const DomainGeom& g, int32_t* out, int64_t n,
                          int64_t lam_offset, int bits, cudaStream_t st) {
  const unsigned int blocks = dm_blocks((n + DM_RUN_PEEL - 1) / DM_RUN_PEEL);
  if constexpr (M >= 4) {
    if (bits == 32) {
      dm_map_peel_kernel<M, uint32_t><<<blocks, DM_THREADS, 0, st>>>(
          g, out, n, lam_offset);
      return 0;
    }
  }
  dm_map_peel_kernel<M, int64_t><<<blocks, DM_THREADS, 0, st>>>(g, out, n,
                                                               lam_offset);
  return 0;
}

template <int B, int D>
static int dm_launch_digits(const DomainGeom& g, int32_t* out, int64_t n,
                            int64_t lam_offset, int32_t ndigits,
                            cudaStream_t st) {
  constexpr int LC = B > 0 ? dm_table_digits(B, D) : 0;
  const int L = B > 0 ? LC : dm_generic_digits(g.base);
  int64_t BL = 1;
  for (int i = 0; i < L; ++i) BL *= B > 0 ? B : g.base;
  const size_t smem = (size_t)BL * D * sizeof(uint32_t);
  // the most the instantiation's table can take (the limit is set once):
  // the generic base's B^L is the base itself for a base >= DM_RUN_DIGITS,
  // 4 or 9 below, so at most DM_MAX_BASE
  constexpr size_t smem_max =
      (size_t)(B > 0 ? dm_ipow<LC>(B > 0 ? B : 1) : DM_MAX_BASE) * D *
      sizeof(uint32_t);
  static DmResident resident;
  auto kern = dm_map_digits_kernel<B, D>;
  const unsigned int blocks = dm_resident_blocks(
      kern, (n + DM_RUN_DIGITS - 1) / DM_RUN_DIGITS, smem_max, resident);
  kern<<<blocks, DM_THREADS, smem, st>>>(g, out, n, lam_offset, ndigits);
  return 0;
}

// Launches on `stream`; returns the launch's cudaError_t (0 on success), or
// cudaErrorInvalidValue for a descriptor this file has no kernel for, or a
// 32-bit launch past its proven bound (or of an m without that path).  bits is 32 or 64: the host's choice
// (geometry.py: map_index_bits; DIGITS is always 64).
extern "C" int dm_map_launch(const DomainGeom* g, int32_t* out, int64_t n,
                             int64_t lam_offset, int32_t ndigits, int32_t bits,
                             void* stream) {
  if (n <= 0) return 0;
  if (lam_offset < 0 || (bits != 32 && bits != 64))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t end = lam_offset + n;
  int rc;
  if (g->family == DM_PEEL) {
    if (g->dim != g->m || g->m < 2 || g->m > 5)
      return (int)cudaErrorInvalidValue;
    if (bits == 32 && end > DM_LAM32_PEEL[g->m])
      return (int)cudaErrorInvalidValue;
    switch (g->m) {
      case 2: rc = dm_launch_peel<2>(*g, out, n, lam_offset, bits, st); break;
      case 3: rc = dm_launch_peel<3>(*g, out, n, lam_offset, bits, st); break;
      case 4: rc = dm_launch_peel<4>(*g, out, n, lam_offset, bits, st); break;
      default: rc = dm_launch_peel<5>(*g, out, n, lam_offset, bits, st); break;
    }
  } else if (g->family == DM_DIGITS) {
    if (g->dim < 1 || g->dim > DM_MAX_DIM || g->base < 2 ||
        g->base > DM_MAX_BASE || ndigits < 0)
      return (int)cudaErrorInvalidValue;
    if (bits != 64) return (int)cudaErrorInvalidValue;
    const int key = g->base * 8 + g->dim;
#define DM_DIG(B, D) dm_launch_digits<B, D>(*g, out, n, lam_offset, ndigits, st)
    switch (key) {
      case 3 * 8 + 2: rc = DM_DIG(3, 2); break;    // gasket2d
      case 8 * 8 + 2: rc = DM_DIG(8, 2); break;    // carpet2d
      case 4 * 8 + 3: rc = DM_DIG(4, 3); break;    // sierpinski3d
      case 20 * 8 + 3: rc = DM_DIG(20, 3); break;  // menger3d
      case 4 * 8 + 2: rc = DM_DIG(4, 2); break;    // cantor2d
      case 5 * 8 + 2: rc = DM_DIG(5, 2); break;    // vicsek2d
      default:
        switch (g->dim) {
          case 1: rc = DM_DIG(0, 1); break;
          case 2: rc = DM_DIG(0, 2); break;
          case 3: rc = DM_DIG(0, 3); break;
          case 4: rc = DM_DIG(0, 4); break;
          default: rc = DM_DIG(0, 5); break;
        }
    }
#undef DM_DIG
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
