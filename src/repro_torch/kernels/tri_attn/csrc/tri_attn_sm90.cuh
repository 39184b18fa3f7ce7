// The tri_attn kernel's sm90 route: causal attention forward on Hopper's
// tensor cores, for bf16 q, k, v, block 128 and head_dim 64 or 128 (the LM
// path's case).  Included by tri_attn.cu; the simt strip-and-combine kernel
// there keeps every other shape.
//
// Replaces, on that route, repro/kernels/tri_attn/kernel.py::_attn_kernel.
// The TPU kernel walks a sequential grid: in mapped mode (bh, lambda), and
// ascending lambda gives j = 0..i for each row i, so m, l and acc stay in
// VMEM from step to step.  CUDA blocks cannot carry state from one block to
// the next, but a block can carry it along a contiguous range of lambda:
//
//   * Work.  A step is one (bh, i, j).  Mapped: the steps are gamma in
//     [0, B*H*T(nb)), bh = gamma / T(nb), (i, j) = g(gamma mod T(nb)) with the
//     paper's exact triangular map (ta_lam_to_ij).  BB: gamma runs over the
//     box [0, B*H*nb^2), bh = gamma / nb^2, i = (gamma mod nb^2) / nb,
//     j = gamma mod nb, and the cells with j > i are discarded (the paper's
//     `if`).
//   * Grid.  CTA c takes the U consecutive cells [cU, (c+1)U).  The wrapper
//     sets U = ceil(B*H*T(nb) / n_SM), so mapped fills the card in one wave;
//     BB uses the same U over the box and launches about twice the CTAs, as
//     the paper's BB grid launches the box's blocks.  The map is evaluated
//     once per CTA; then (i, j) advances incrementally (j++, and at a row's
//     end i++, j = 0), and (m, l, acc) stay in registers along each row.
//   * Split rows.  A row that starts and ends inside one CTA writes o.  A row
//     cut by a CTA boundary leaves pieces: a piece that starts at j > 0 goes
//     to its CTA's slot 0, one that starts at j = 0 and stops short of the
//     diagonal to slot 1 (at most two per CTA).  A second, short launch
//     (ta_sm90_combine_kernel, one block per CTA boundary, acting only at the
//     first boundary inside a row) merges a row's pieces in ascending j with
//     the online-softmax rescale and writes o.  The order is fixed, so each
//     mode is deterministic; the two modes split rows at other places, so
//     they agree to rounding, not bit for bit.
//   * Inside a CTA.  Two consumer warpgroups take 64 q rows each.  Thread 0
//     issues every TMA load (q, k, v described as 4-D (D, S, H, B) tensor
//     maps through their own strides, 128-byte swizzle, D cut into 64-column
//     boxes) on mbarriers: q double-buffered by row, k and v in a ring of two
//     stages, two steps ahead.  S = Q K^T is wgmma m64n128k16 with A and B
//     from shared memory; softmax runs in the accumulator's registers in the
//     log2 domain (scale * log2 e folded into one fp32 multiply, exp2f, quad
//     shuffles for the row max; the causal mask only when j == i, NEG_INF
//     -1e30 as in the reference); P is rounded to bf16 in registers and
//     O += P V is wgmma with A from registers and V as an MN-major B.  At a
//     row's end O / l is written through o's (b, h, s) strides in bf16.
//   * GQA: kv head h / (H / Hk) is read in place by the k and v maps.
//   * Row log-sum-exp.  Where the autograd node asks for it (a.lse not
//     null: training), the row's end, or the combine for a cut row, also
//     stores L = m + log2(l) in fp32, the one residual the backward
//     (tri_attn_bwd.cu) needs beside q, k, v and o; scoring passes null
//     and stores nothing more.
//
// What bounds it on an H100: at the LM path's shape (1, 32 heads, 4 kv
// heads, 4096, 128) causal attention needs 137.5 GFLOP, 0.139 ms at
// 989 TFLOP/s bf16, against 0.023 ms to read q, k, v and write o once: it is
// bound by operations.  This design issues both products on the tensor
// cores but does not overlap them with the exps or with each other (no
// warp specialisation, no ping-pong between the warpgroups): each step
// waits for S, computes P, then waits for P V.  Workspace: 2 pieces per CTA,
// 2 * n_CTA * 128 * (D + 2) fp32, 17.6 MB at the LM shape.
#include "tri_attn_hopper.cuh"

#define TA_SM90_THREADS 256   // two consumer warpgroups

// Keep in step with ``_Sm90Args`` in kernel.py.
struct TaSm90Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_sh, q_ss;   // strides in elements of (b, h, s); d is 1
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  float* ws_acc;              // (n_cta, 2, 128, D) unnormalized pieces
  float* ws_m;                // (n_cta, 2, 128) running max, log2 domain
  float* ws_l;                // (n_cta, 2, 128) running sum of exp2
  float* lse;                 // (B, H, S) row log-sum-exp m + log2(l),
                              // log2 domain; null where no autograd
                              // node wants it (nothing is stored)
  int32_t batch, heads, kv_heads, seq;
  int32_t nb;                 // seq / 128
  int32_t mode;               // 0 mapped, 1 bounding box
  int64_t steps_per_cta;      // U
  int64_t n_cells;            // B*H*T(nb) (mapped) or B*H*nb^2 (BB)
  int64_t n_cta;              // ceil(n_cells / U)
  float scale_log2;           // head_dim^-1/2 * log2(e)
};

// ---------------------------------------------------------------------------
// the work enumeration
// ---------------------------------------------------------------------------

// A step (bh, i, j); ta_advance moves to the next valid step: j++, and past
// the diagonal to the next row (or the next (b, h)) at j = 0.
struct TaStep {
  int64_t bh;
  int32_t i, j;
};

__device__ __forceinline__ void ta_advance(TaStep& s, int32_t nb) {
  if (++s.j > s.i) {
    s.j = 0;
    if (++s.i == nb) {
      s.i = 0;
      ++s.bh;
    }
  }
}

// The cell gamma of the CTAs' enumeration as (bh, i, j); in BB mode j may
// lie past the diagonal (a discarded cell).
__device__ __forceinline__ TaStep ta_cell(const TaSm90Args& a, int64_t g) {
  TaStep s;
  if (a.mode == 0) {
    const int64_t tri = ta_tri(a.nb);
    s.bh = g / tri;
    ta_lam_to_ij(g % tri, &s.i, &s.j);
  } else {
    const int64_t box = (int64_t)a.nb * a.nb, r = g % box;
    s.bh = g / box;
    s.i = (int32_t)(r / a.nb);
    s.j = (int32_t)(r % a.nb);
  }
  return s;
}

// The number of valid (j <= i) cells of the BB box before cell g.
__device__ __forceinline__ int64_t ta_bb_valid_before(int64_t g, int32_t nb) {
  const int64_t box = (int64_t)nb * nb, r = g % box;
  const int64_t i = r / nb, j = r % nb;
  return g / box * ta_tri(nb) + ta_tri(i) + (j < i + 1 ? j : i + 1);
}

// CTA `cta`'s first valid step and its number of valid steps.
__device__ __forceinline__ int64_t ta_cta_steps(const TaSm90Args& a,
                                                int64_t cta, TaStep* first) {
  const int64_t g0 = cta * a.steps_per_cta;
  const int64_t g1 = g0 + a.steps_per_cta < a.n_cells
                         ? g0 + a.steps_per_cta : a.n_cells;
  *first = ta_cell(a, g0);
  if (a.mode == 0) return g1 - g0;
  if (first->j > first->i) {         // a discarded cell: the next row
    first->j = first->i;
    ta_advance(*first, a.nb);
  }
  return ta_bb_valid_before(g1, a.nb) - ta_bb_valid_before(g0, a.nb);
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

template <int D>
struct TaSm90Smem {
  static constexpr int TILE = TA_SM90_BLK * D * 2;   // one 128 x D bf16 tile
  static constexpr int BOX = TA_SM90_BLK * 64 * 2;   // one 64-column box
  // q[2], k[2], v[2]; six mbarriers; slack to align the tiles to 1024
  static constexpr int BYTES = 6 * TILE + 6 * 8 + 1024;
};

// grid (n_cta): CTA c walks the valid steps of cells [cU, (c+1)U).
template <int D>
__global__ void __launch_bounds__(TA_SM90_THREADS, 1)
ta_sm90_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const TaSm90Args a) {
  constexpr int TILE = TaSm90Smem<D>::TILE, BOX = TaSm90Smem<D>::BOX;
  constexpr int NBOX = D / 64;    // 64-column boxes per tile
  constexpr int NO = D / 2;       // O accumulator floats per thread
  extern __shared__ uint8_t ta_sm90_smem[];
  const uint32_t base = (ta_smem(ta_sm90_smem) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + 2 * TILE, sv = base + 4 * TILE;
  const uint32_t bar = base + 6 * TILE;   // full_q[2], full_k[2], full_v[2]

  TaStep cur;
  const int64_t count = ta_cta_steps(a, blockIdx.x, &cur);
  if (count <= 0) return;           // BB: every cell of this CTA discarded
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int x = 0; x < 6; ++x) ta_mbar_init(bar + 8 * x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The loader, run by thread 0 alone: step ld_t into k/v stage ld_t % 2,
  // and the q tile of a new row into buffer (row ordinal) % 2.
  const int group = a.heads / a.kv_heads;
  TaStep ld = cur;
  int64_t ld_t = 0;
  int32_t ld_row = 0;
  auto issue = [&]() {
    if (ld_t >= count) return;
    const int b = (int)(ld.bh / a.heads), h = (int)(ld.bh % a.heads);
    const int hk = h / group;
    if (ld_t == 0 || ld.j == 0) {
      if (ld_t > 0) ++ld_row;
      const uint32_t fq = bar + 8 * (ld_row & 1);
      ta_mbar_expect_tx(fq, TILE);
#pragma unroll
      for (int x = 0; x < NBOX; ++x)
        ta_tma_load(sq + (ld_row & 1) * TILE + x * BOX, &tq, fq, 64 * x,
                    ld.i * TA_SM90_BLK, h, b);
    }
    const int st = (int)(ld_t & 1);
    const uint32_t fk = bar + 16 + 8 * st, fv = bar + 32 + 8 * st;
    ta_mbar_expect_tx(fk, TILE);
#pragma unroll
    for (int x = 0; x < NBOX; ++x)
      ta_tma_load(sk + st * TILE + x * BOX, &tk, fk, 64 * x,
                  ld.j * TA_SM90_BLK, hk, b);
    ta_mbar_expect_tx(fv, TILE);
#pragma unroll
    for (int x = 0; x < NBOX; ++x)
      ta_tma_load(sv + st * TILE + x * BOX, &tv, fv, 64 * x,
                  ld.j * TA_SM90_BLK, hk, b);
    ta_advance(ld, a.nb);
    ++ld_t;
  };
  if (tid == 0) {
    issue();
    issue();
  }
  __syncwarp();

  // This thread's rows of the 128-row tile (the accumulator layout: values
  // 4c + {0, 1} at row_a, 4c + {2, 3} at row_a + 8, columns 8c + cb + {0, 1})
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int row_a = wg * 64 + warp * 16 + (lane >> 2);
  const int cb = 2 * (lane & 3);
  float s[64], o[NO];
  uint32_t pf[32];
#pragma unroll
  for (int x = 0; x < 64; ++x) s[x] = 0.f;
  float m_a = TA_NEG_INF, m_b = TA_NEG_INF, l_a = 0.f, l_b = 0.f;
  int32_t seg_j0 = 0, row = 0;

#pragma unroll 1
  for (int64_t t = 0; t < count; ++t) {
    if (t == 0 || cur.j == 0) {       // a new row segment
      if (t > 0) ++row;
      seg_j0 = cur.j;
      m_a = m_b = TA_NEG_INF;
      l_a = l_b = 0.f;
#pragma unroll
      for (int x = 0; x < NO; ++x) o[x] = 0.f;
      ta_mbar_wait(bar + 8 * (row & 1), (row >> 1) & 1);
    }
    const int st = (int)(t & 1);
    const uint32_t ph = (uint32_t)(t >> 1) & 1u;
    ta_mbar_wait(bar + 16 + 8 * st, ph);
    __syncwarp();

    // S = Q K^T over D / 16 k-steps: 32 bytes along a 128-byte swizzle row,
    // then the next 64-column box
    const uint32_t qa = sq + (row & 1) * TILE + wg * 64 * 128;
    const uint32_t ka = sk + st * TILE;
    ta_reg_fence(s);
    ta_wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
      ta_wgmma_ss_n128(s, ta_desc(qa + off, 16, 1024),
                       ta_desc(ka + off, 16, 1024), kk > 0);
    }
    ta_wg_commit();
    ta_wg_wait0();
    ta_reg_fence(s);

    // online softmax in the log2 domain, on the accumulator's registers
    const bool diag = cur.j == cur.i;
    float mx_a = TA_NEG_INF, mx_b = TA_NEG_INF;
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * c + e] * a.scale_log2;
        if (diag && 8 * c + cb + (e & 1) > row_a + 8 * (e >> 1))
          x = TA_NEG_INF;
        s[4 * c + e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[4 * c + e] - (e < 2 ? mn_a : mn_b));
        s[4 * c + e] = p;
        if (e < 2) sum_a += p;
        else sum_b += p;
      }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      o[4 * c] *= al_a;
      o[4 * c + 1] *= al_a;
      o[4 * c + 2] *= al_b;
      o[4 * c + 3] *= al_b;
    }
    // P in bf16 as wgmma's A fragment: k-step kt takes columns 16kt..16kt+15
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
      pf[4 * kt] = ta_pack_bf16(s[8 * kt], s[8 * kt + 1]);
      pf[4 * kt + 1] = ta_pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
      pf[4 * kt + 2] = ta_pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
      pf[4 * kt + 3] = ta_pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
    }

    // O += P V: V (keys x D, D contiguous) is an MN-major B; a k-step is 16
    // key rows (2048 bytes), the second 64-column box is LBO away
    ta_mbar_wait(bar + 32 + 8 * st, ph);
    __syncwarp();
    const uint32_t va = sv + st * TILE;
    ta_reg_fence(o);
    ta_wg_fence();
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
      const uint32_t pa[4] = {pf[4 * kt], pf[4 * kt + 1], pf[4 * kt + 2],
                              pf[4 * kt + 3]};
      ta_wgmma_pv<D>(o, pa, ta_desc(va + kt * 2048, BOX, 1024));
    }
    ta_wg_commit();
    ta_wg_wait0();
    ta_reg_fence(o);

    if (cur.j == cur.i || t == count - 1) {     // the segment's end
      float la = l_a + __shfl_xor_sync(0xffffffffu, l_a, 1);
      la += __shfl_xor_sync(0xffffffffu, la, 2);
      float lb = l_b + __shfl_xor_sync(0xffffffffu, l_b, 1);
      lb += __shfl_xor_sync(0xffffffffu, lb, 2);
      if (seg_j0 == 0 && cur.j == cur.i) {      // a whole row: write o
        const int64_t b = cur.bh / a.heads, h = cur.bh % a.heads;
        __nv_bfloat16* oa = (__nv_bfloat16*)a.o + b * a.o_sb + h * a.o_sh +
                            ((int64_t)cur.i * TA_SM90_BLK + row_a) * a.o_ss;
        __nv_bfloat16* ob = oa + 8 * a.o_ss;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          *reinterpret_cast<__nv_bfloat162*>(oa + 8 * c + cb) =
              __floats2bfloat162_rn(o[4 * c] / la, o[4 * c + 1] / la);
          *reinterpret_cast<__nv_bfloat162*>(ob + 8 * c + cb) =
              __floats2bfloat162_rn(o[4 * c + 2] / lb, o[4 * c + 3] / lb);
        }
        if (a.lse != nullptr && (lane & 3) == 0) {
          float* lr = a.lse + cur.bh * a.seq + (int64_t)cur.i * TA_SM90_BLK;
          lr[row_a] = m_a + log2f(la);
          lr[row_a + 8] = m_b + log2f(lb);
        }
      } else {                                  // a piece: its slot
        const int64_t p = (int64_t)blockIdx.x * 2 + (seg_j0 > 0 ? 0 : 1);
        float* wa = a.ws_acc + (p * TA_SM90_BLK + row_a) * D;
        float* wb = wa + 8 * D;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          *reinterpret_cast<float2*>(wa + 8 * c + cb) =
              make_float2(o[4 * c], o[4 * c + 1]);
          *reinterpret_cast<float2*>(wb + 8 * c + cb) =
              make_float2(o[4 * c + 2], o[4 * c + 3]);
        }
        if ((lane & 3) == 0) {
          a.ws_m[p * TA_SM90_BLK + row_a] = m_a;
          a.ws_m[p * TA_SM90_BLK + row_a + 8] = m_b;
          a.ws_l[p * TA_SM90_BLK + row_a] = la;
          a.ws_l[p * TA_SM90_BLK + row_a + 8] = lb;
        }
      }
    }
    __syncthreads();                  // stage st and the old q buffer free
    if (tid == 0) issue();
    __syncwarp();
    ta_advance(cur, a.nb);
  }
}

// grid (n_cta - 1): block c - 1 looks at the boundary between CTAs c - 1
// and c.  It acts only if that boundary cuts a row (0 < j <= i at cell cU)
// and is the row's first boundary; then it merges the row's pieces -- CTA
// c0's slot 1, CTAs c0+1..c1's slot 0 -- in ascending j and writes o.
template <int D>
__global__ void __launch_bounds__(TA_SM90_THREADS)
ta_sm90_combine_kernel(const TaSm90Args a) {
  const int64_t c = (int64_t)blockIdx.x + 1;
  const int64_t g = c * a.steps_per_cta;
  if (g >= a.n_cells) return;
  const TaStep at = ta_cell(a, g);
  if (at.j == 0 || at.j > at.i) return;
  const int64_t row0 = g - at.j;                  // the row's cell j = 0
  const int64_t c0 = row0 / a.steps_per_cta;
  if (c0 != c - 1) return;
  const int64_t c1 = (row0 + at.i) / a.steps_per_cta;
  const int64_t b = at.bh / a.heads, h = at.bh % a.heads;
  __nv_bfloat16* o = (__nv_bfloat16*)a.o + b * a.o_sb + h * a.o_sh +
                     (int64_t)at.i * TA_SM90_BLK * a.o_ss;
  for (int e = threadIdx.x; e < TA_SM90_BLK * D; e += TA_SM90_THREADS) {
    const int r = e / D, d = e % D;
    float m = TA_NEG_INF, l = 0.f, acc = 0.f;
    for (int64_t cc = c0; cc <= c1; ++cc) {
      const int64_t p = (cc * 2 + (cc == c0 ? 1 : 0)) * TA_SM90_BLK + r;
      const float mj = a.ws_m[p];
      const float mn = fmaxf(m, mj);
      const float alpha = exp2f(m - mn), beta = exp2f(mj - mn);
      l = l * alpha + a.ws_l[p] * beta;
      acc = acc * alpha + a.ws_acc[p * D + d] * beta;
      m = mn;
    }
    o[r * a.o_ss + d] = __float2bfloat16_rn(acc / l);
    if (a.lse != nullptr && d == 0)
      a.lse[at.bh * a.seq + (int64_t)at.i * TA_SM90_BLK + r] = m + log2f(l);
  }
}

// ---------------------------------------------------------------------------
// host side: the launch
// ---------------------------------------------------------------------------

template <int D>
static int ta_sm90_run(const TaSm90Args& a, const CUtensorMap& tq,
                       const CUtensorMap& tk, const CUtensorMap& tv,
                       cudaStream_t st) {
  constexpr int smem = TaSm90Smem<D>::BYTES;
  // the shared-memory opt-in, once per device (it is a host call per launch
  // otherwise)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(ta_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) opted_in[dev] = true;
  }
  ta_sm90_kernel<D><<<(unsigned int)a.n_cta, TA_SM90_THREADS, smem, st>>>(
      tq, tk, tv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_cta < 2) return (int)err;
  ta_sm90_combine_kernel<D>
      <<<(unsigned int)(a.n_cta - 1), TA_SM90_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Launches the sm90 route (the step kernel, then the combine) on `stream`:
// bf16 q, k, v, block 128, head_dim 64 or 128.  Returns 0, a cudaError_t,
// or a TA_ERR_* code.
extern "C" int ta_sm90_launch(const TaSm90Args* a, int32_t head_dim,
                              void* stream) {
  if (head_dim != 64 && head_dim != 128) return (int)cudaErrorInvalidValue;
  if (a->mode != 0 && a->mode != 1) return (int)cudaErrorInvalidValue;
  if (a->kv_heads <= 0 || a->heads % a->kv_heads != 0 || a->nb <= 0 ||
      (int64_t)a->nb * TA_SM90_BLK != a->seq || a->steps_per_cta <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t per_bh = a->mode == 0 ? ta_tri(a->nb)
                                      : (int64_t)a->nb * a->nb;
  if (a->n_cells != (int64_t)a->batch * a->heads * per_bh ||
      a->n_cta != (a->n_cells + a->steps_per_cta - 1) / a->steps_per_cta ||
      a->n_cta > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (a->n_cells == 0) return 0;
  CUtensorMap tq, tk, tv;
  int rc = ta_tensor_map(&tq, a->q, a->batch, a->heads, a->seq, head_dim,
                         a->q_sb, a->q_sh, a->q_ss);
  if (rc == 0)
    rc = ta_tensor_map(&tk, a->k, a->batch, a->kv_heads, a->seq, head_dim,
                       a->k_sb, a->k_sh, a->k_ss);
  if (rc == 0)
    rc = ta_tensor_map(&tv, a->v, a->batch, a->kv_heads, a->seq, head_dim,
                       a->v_sb, a->v_sh, a->v_ss);
  if (rc != 0) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  return head_dim == 128 ? ta_sm90_run<128>(*a, tq, tk, tv, st)
                         : ta_sm90_run<64>(*a, tq, tk, tv, st);
}
