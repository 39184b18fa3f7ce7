// The tri_attn kernel's backward on the sm90 route: dq, dk and dv of causal
// attention for bf16 q, k, v, block 128 and head_dim 64 or 128, on Hopper's
// tensor cores.  Built into a library of its own and loaded at the first
// backward, so a process that only scores neither builds nor loads it.
//
// Replaces no TPU kernel: the reference's custom_vjp runs its jnp oracle.
// It was added because that oracle, run in torch (the whole S x S square in
// fp32 on the CUDA cores, k and v repeated to every q head), was 69% of a
// training step's device time at yi-6b's shape, about 56 ms a call.
//
// What bounds it on an H100: at (1, 32 heads, 4 kv heads, 4096, 128) the
// backward needs dV = P^T dO, dP = dO V^T, dQ = dS K and dK = dS^T Q over
// the causal pairs, 275 GFLOP (0.278 ms at 989 TFLOP/s bf16), against
// 0.045 ms to read q, k, v, o, dO and write dq, dk, dv once (151 MB): it is
// bound by operations.  This design recomputes S = Q K^T in both of its
// passes and keeps every sum deterministic (no atomics), so it issues 7
// products a cell pair where the counted work is 4: 481 GFLOP done for the
// 275 counted.  Products take bf16 operands (P and dS rounded to bf16, as the
// forward's P V does) with fp32 sums; L, delta and every accumulator are
// fp32; dq, dk, dv are rounded to bf16 once, at the end.
//
//   * Residuals.  The forward stores L = m + log2(l) per row (log2 domain)
//     where the autograd node wants it, so P = 2^(S D^-1/2 log2 e - L).
//     ta_bwd_delta_kernel computes delta = rowsum(dO o) in fp32 first.
//   * dK, dV pass (ta_bwd_dkdv_kernel), key-stationary, on the lambda grid.
//     A stair is one (b, kv head hk); its row r is the column of key block
//     j = nb-1-r, holding G (nb - j) cells, G = H/Hk: q head g of hk's
//     group against q block i >= j, g major, i ascending.  Mapped: the
//     cells are gamma in [0, B*Hk*G*T(nb)), the stair gamma / (G T(nb)),
//     and lambda = gamma mod G T(nb) gives r = tri_row(lambda / G) through
//     the paper's exact triangular map and p = lambda - G T(r).  BB: the box
//     B*Hk*nb*(G nb), every column padded to G nb cells, the cells past a
//     column's end discarded.  GQA sums over the group inside the column:
//     no repeated k, v and no separate reduction.  K_j and V_j stay in
//     shared memory, dK and dV in fp32 registers; q, dO (TMA) and the
//     cell's L and delta (bulk copies) arrive in a ring of two stages.  Each
//     warpgroup owns 64 keys and takes the cell's 128 queries in two halves
//     of 64: S^T = K Q^T, P^T, dV += P^T dO beside dP^T = V dO^T,
//     dS^T = P^T (dP^T - delta), dK += dS^T Q.
//   * dQ pass (ta_bwd_dq_kernel), query-stationary, on the forward's own
//     row stream (the same lambda enumeration and the same U): Q_i and dO_i
//     stay in shared memory, K_j and V_j arrive in a ring of two; each
//     warpgroup owns 64 queries and takes the keys in two halves: S, P,
//     dP = dO V^T, dS, dQ += dS K.
//   * Grid and pieces.  Both passes cut their cells into ranges of U for a
//     persistent grid of about n_SM CTAs, as the forward does.  A column
//     (row) that starts and ends inside a CTA writes dk, dv (dq); one cut by
//     a CTA boundary leaves fp32 pieces, at most two a CTA (slot 0: starts
//     inside the column, slot 1: starts at its first cell), and
//     ta_bwd_combine_kernel adds them in ascending order of their cells.
//     Every sum runs in a fixed order, so a gradient is bitwise repeatable.
//   * The diagonal cell's half where every key follows every query (keys
//     64..127 against queries 0..63) is skipped: its P is 0.
//
// What it does not do: overlap the exps with the products across cells
// (no warp specialisation, no ping-pong: each half waits for S and dP,
// then for the accumulating products), or keep dq's pieces out of memory.
// Workspace: 3 * 2 * n_CTA * 128 * D fp32 (52 MB at yi-6b's shape).
#include "tri_attn_common.cuh"
#include "tri_attn_hopper.cuh"

#define TA_BWD_THREADS 256   // two consumer warpgroups

// Keep in step with ``_BwdArgs`` in kernel.py.
struct TaBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_sh, q_ss;   // strides in elements of (b, h, s); d is 1
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  const float* lse;           // (B, H, S) the forward's L, log2 domain
  float* delta;               // (B, H, S) rowsum(dO o)
  float* ws_dq;               // (n_cta, 2, 128, D) row pieces of dQ
  float* ws_dk;               // (n_cta, 2, 128, D) column pieces of dK
  float* ws_dv;               // (n_cta, 2, 128, D) column pieces of dV
  int32_t batch, heads, kv_heads, seq;
  int32_t nb;                 // seq / 128
  int32_t mode;               // 0 mapped, 1 bounding box
  int64_t steps_per_cta;      // U, both passes
  int64_t n_cells;            // B*H*T(nb) (mapped) or B*H*nb^2 (BB)
  int64_t n_cta;              // ceil(n_cells / U)
  float scale_log2;           // head_dim^-1/2 * log2(e)
  float scale;                // head_dim^-1/2
};

// ---------------------------------------------------------------------------
// the work enumeration: stairs of rows, row r holding G (r + 1) cells
// ---------------------------------------------------------------------------

// A cell: stair st, row r, position p in the row.  The dQ pass's stairs are
// the (b, h) with G = 1 (row r = q block i, p = key block j: the forward's
// enumeration); the dK, dV pass's are the (b, kv head) with G = H / Hk.
struct TaRun {
  int64_t st;
  int32_t r, p;
};

__device__ __forceinline__ void ta_run_advance(TaRun& c, int32_t nb,
                                               int32_t grp) {
  if (++c.p == grp * (c.r + 1)) {
    c.p = 0;
    if (++c.r == nb) {
      c.r = 0;
      ++c.st;
    }
  }
}

// Cell g; in BB mode p may lie past the row's end (a discarded cell).
__device__ __forceinline__ TaRun ta_run_cell(int32_t mode, int32_t nb,
                                             int32_t grp, int64_t g) {
  TaRun c;
  if (mode == 0) {
    const int64_t per = grp * ta_tri(nb), lam = g % per;
    const int64_t r = ta_tri_row(lam / grp);
    c.st = g / per;
    c.r = (int32_t)r;
    c.p = (int32_t)(lam - grp * ta_tri(r));
  } else {
    const int64_t width = (int64_t)grp * nb, per = width * nb, rem = g % per;
    c.st = g / per;
    c.r = (int32_t)(rem / width);
    c.p = (int32_t)(rem % width);
  }
  return c;
}

// The valid cells of the BB box before cell g.
__device__ __forceinline__ int64_t ta_run_bb_before(int64_t g, int32_t nb,
                                                    int32_t grp) {
  const int64_t width = (int64_t)grp * nb, per = width * nb, rem = g % per;
  const int64_t r = rem / width, p = rem % width, len = grp * (r + 1);
  return g / per * grp * ta_tri(nb) + grp * ta_tri(r) + (p < len ? p : len);
}

// CTA `cta`'s first valid cell and its number of valid cells.
__device__ __forceinline__ int64_t ta_run_cta(const TaBwdArgs& a, int32_t grp,
                                              int64_t cta, TaRun* first) {
  const int64_t g0 = cta * a.steps_per_cta;
  const int64_t g1 = g0 + a.steps_per_cta < a.n_cells
                         ? g0 + a.steps_per_cta : a.n_cells;
  *first = ta_run_cell(a.mode, a.nb, grp, g0);
  if (a.mode == 0) return g1 - g0;
  if (first->p >= grp * (first->r + 1)) {   // discarded: the next row
    first->p = grp * (first->r + 1) - 1;
    ta_run_advance(*first, a.nb, grp);
  }
  return ta_run_bb_before(g1, a.nb, grp) - ta_run_bb_before(g0, a.nb, grp);
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

template <int D>
struct TaBwdSmem {
  static constexpr int TILE = TA_SM90_BLK * D * 2;   // one 128 x D bf16 tile
  static constexpr int BOX = TA_SM90_BLK * 64 * 2;   // one 64-column box
  static constexpr int HALF = 64 * 128;              // 64 rows of a box
  static constexpr int ROW = TA_SM90_BLK * 4;        // 128 fp32
  // six tiles; L[2] and delta[2]; four mbarriers; slack to align to 1024
  static constexpr int BYTES = 6 * TILE + 4 * ROW + 4 * 8 + 1024;
};

// delta = rowsum(dO o) in fp32, one warp a row of (B, H, S).
template <int D>
__global__ void __launch_bounds__(256) ta_bwd_delta_kernel(const TaBwdArgs a) {
  const int64_t rows = (int64_t)a.batch * a.heads * a.seq;
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t s = row % a.seq, bh = row / a.seq;
  const int64_t b = bh / a.heads, h = bh % a.heads;
  const __nv_bfloat16* o =
      (const __nv_bfloat16*)a.o + b * a.o_sb + h * a.o_sh + s * a.o_ss;
  const __nv_bfloat16* g =
      (const __nv_bfloat16*)a.dout + b * a.do_sb + h * a.do_sh + s * a.do_ss;
  float acc = 0.f;
#pragma unroll
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + d));
    const float2 y = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(g + d));
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) a.delta[row] = acc;
}

// P's or dS's 64 x 64 accumulator (the values 4c + e, c < 8) as wgmma's A
// fragments, four k-steps of 16 columns.
__device__ __forceinline__ void ta_pack_a(const float (&x)[32],
                                          uint32_t (&f)[16]) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    f[4 * kt] = ta_pack_bf16(x[8 * kt], x[8 * kt + 1]);
    f[4 * kt + 1] = ta_pack_bf16(x[8 * kt + 2], x[8 * kt + 3]);
    f[4 * kt + 2] = ta_pack_bf16(x[8 * kt + 4], x[8 * kt + 5]);
    f[4 * kt + 3] = ta_pack_bf16(x[8 * kt + 6], x[8 * kt + 7]);
  }
}

// acc (64 x D fp32, the accumulator layout) += A B over 64 rows of K: A the
// four k-steps of `f`, B the 64 x D tile at `b` (64 rows of 128-byte swizzle
// rows per 64-column box, MN-major).
template <int D>
__device__ __forceinline__ void ta_acc_64(float (&acc)[D / 2],
                                          const uint32_t (&f)[16],
                                          uint32_t b) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) {
    const uint32_t fa[4] = {f[4 * kt], f[4 * kt + 1], f[4 * kt + 2],
                            f[4 * kt + 3]};
    ta_wgmma_pv<D>(acc, fa, ta_desc(b + kt * 2048, TaBwdSmem<D>::BOX, 1024));
  }
}

// d (64 x 64 fp32) = A B^T over D: A 64 rows at `a`, B 64 rows at `b`, both
// K-major tiles of 128-byte swizzle rows, D cut into 64-column boxes.
template <int D>
__device__ __forceinline__ void ta_prod_64(float (&d)[32], uint32_t a,
                                           uint32_t b) {
  constexpr int BOX = TaBwdSmem<D>::BOX;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * BOX + (kk & 3) * 32;
    ta_wgmma_ss_n64(d, ta_desc(a + off, 16, 1024), ta_desc(b + off, 16, 1024),
                    kk > 0);
  }
}

// Store rows row_a and row_a + 8 of a 64 x D accumulator times `mul`: bf16
// through (b, h, s) strides at `dst` (row 0 of the tile), or fp32 into a
// workspace tile `ws` (128 x D, contiguous).
template <int D>
__device__ __forceinline__ void ta_store_bf16(const float (&x)[D / 2],
                                              __nv_bfloat16* dst,
                                              int64_t ss, int row_a, int cb,
                                              float mul) {
  __nv_bfloat16* ra = dst + row_a * ss;
  __nv_bfloat16* rb = ra + 8 * ss;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    *reinterpret_cast<__nv_bfloat162*>(ra + 8 * c + cb) =
        __floats2bfloat162_rn(x[4 * c] * mul, x[4 * c + 1] * mul);
    *reinterpret_cast<__nv_bfloat162*>(rb + 8 * c + cb) =
        __floats2bfloat162_rn(x[4 * c + 2] * mul, x[4 * c + 3] * mul);
  }
}

template <int D>
__device__ __forceinline__ void ta_store_ws(const float (&x)[D / 2],
                                            float* ws, int row_a, int cb) {
  float* wa = ws + row_a * D;
  float* wb = wa + 8 * D;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    *reinterpret_cast<float2*>(wa + 8 * c + cb) =
        make_float2(x[4 * c], x[4 * c + 1]);
    *reinterpret_cast<float2*>(wb + 8 * c + cb) =
        make_float2(x[4 * c + 2], x[4 * c + 3]);
  }
}

// grid (n_cta): CTA c walks the valid cells of [cU, (c+1)U) of the columns.
template <int D>
__global__ void __launch_bounds__(TA_BWD_THREADS, 1)
ta_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const TaBwdArgs a) {
  using SM = TaBwdSmem<D>;
  constexpr int TILE = SM::TILE, BOX = SM::BOX, HALF = SM::HALF;
  constexpr int NBOX = D / 64, NA = D / 2;
  extern __shared__ uint8_t ta_bwd_smem[];
  const uint32_t raw = ta_smem(ta_bwd_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sk = base, sv = base + TILE, sq = base + 2 * TILE,
                 sdo = base + 4 * TILE, sl = base + 6 * TILE;
  const uint32_t bar = sl + 4 * SM::ROW;   // full_kv, full_q[2]
  // L[2] then delta[2], as the threads read them
  const float* lrows = reinterpret_cast<const float*>(
      ta_bwd_smem + (sl - raw));

  const int grp = a.heads / a.kv_heads;
  TaRun cur;
  const int64_t count = ta_run_cta(a, grp, blockIdx.x, &cur);
  if (count <= 0) return;            // BB: every cell of this CTA discarded
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int x = 0; x < 3; ++x) ta_mbar_init(bar + 8 * x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The loader, run by thread 0 alone: cell ld_t's q, dO, L and delta into
  // stage ld_t % 2; k and v of a column when the column starts.
  TaRun ld = cur;
  int64_t ld_t = 0;
  auto issue_q = [&]() {
    if (ld_t >= count) return;
    const int b = (int)(ld.st / a.kv_heads), hk = (int)(ld.st % a.kv_heads);
    const int j = a.nb - 1 - ld.r;
    const int h = hk * grp + ld.p / (ld.r + 1), i = j + ld.p % (ld.r + 1);
    const int st = (int)(ld_t & 1);
    const uint32_t fq = bar + 8 + 8 * st;
    ta_mbar_expect_tx(fq, 2 * TILE + 2 * SM::ROW);
#pragma unroll
    for (int x = 0; x < NBOX; ++x) {
      ta_tma_load(sq + st * TILE + x * BOX, &tq, fq, 64 * x,
                  i * TA_SM90_BLK, h, b);
      ta_tma_load(sdo + st * TILE + x * BOX, &tdo, fq, 64 * x,
                  i * TA_SM90_BLK, h, b);
    }
    const int64_t row = ((int64_t)b * a.heads + h) * a.seq +
                        (int64_t)i * TA_SM90_BLK;
    ta_bulk_load(sl + st * SM::ROW, a.lse + row, SM::ROW, fq);
    ta_bulk_load(sl + (2 + st) * SM::ROW, a.delta + row, SM::ROW, fq);
    ta_run_advance(ld, a.nb, grp);
    ++ld_t;
  };
  auto issue_kv = [&](const TaRun& c) {
    const int b = (int)(c.st / a.kv_heads), hk = (int)(c.st % a.kv_heads);
    const int j = a.nb - 1 - c.r;
    ta_mbar_expect_tx(bar, 2 * TILE);
#pragma unroll
    for (int x = 0; x < NBOX; ++x) {
      ta_tma_load(sk + x * BOX, &tk, bar, 64 * x, j * TA_SM90_BLK, hk, b);
      ta_tma_load(sv + x * BOX, &tv, bar, 64 * x, j * TA_SM90_BLK, hk, b);
    }
  };
  if (tid == 0) {
    issue_kv(cur);
    issue_q();
    issue_q();
  }
  __syncwarp();

  // This thread's keys of the 128-key tile (the accumulator layout: values
  // 4c + {0, 1} at row_a, 4c + {2, 3} at row_a + 8, columns 8c + cb + {0, 1})
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int row_a = wg * 64 + warp * 16 + (lane >> 2);
  const int cb = 2 * (lane & 3);
  float dk[NA], dv[NA], s[32], dp[32];
  uint32_t pf[16];
#pragma unroll
  for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
  int32_t seg_p0 = 0, col = 0;

#pragma unroll 1
  for (int64_t t = 0; t < count; ++t) {
    if (t == 0 || cur.p == 0) {       // a new column segment
      if (t > 0) ++col;
      seg_p0 = cur.p;
#pragma unroll
      for (int x = 0; x < NA; ++x) dk[x] = dv[x] = 0.f;
      ta_mbar_wait(bar, col & 1);
    }
    const int st = (int)(t & 1);
    ta_mbar_wait(bar + 8 + 8 * st, (uint32_t)(t >> 1) & 1u);
    __syncwarp();
    const int j = a.nb - 1 - cur.r, i = j + cur.p % (cur.r + 1);
    const bool diag = i == j;
    const float* lr = lrows + st * TA_SM90_BLK;
    const float* dr = lrows + (2 + st) * TA_SM90_BLK;

#pragma unroll 1
    for (int hq = 0; hq < 2; ++hq) {
      if (diag && hq == 0 && wg == 1) continue;   // keys after every query
      const uint32_t qh = sq + st * TILE + hq * HALF;
      const uint32_t doh = sdo + st * TILE + hq * HALF;
      // S^T = K Q^T (64 keys x 64 queries)
      ta_reg_fence(s);
      ta_wg_fence();
      ta_prod_64<D>(s, sk + wg * HALF, qh);
      ta_wg_commit();
      ta_wg_wait0();
      ta_reg_fence(s);
      // P^T = 2^(S^T D^-1/2 log2 e - L[query]), the causal mask at i == j
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int qc = hq * 64 + 8 * c + cb;
        const float2 l = *reinterpret_cast<const float2*>(lr + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = exp2f(fmaf(s[4 * c + e], a.scale_log2,
                               -((e & 1) ? l.y : l.x)));
          if (diag && row_a + 8 * (e >> 1) > qc + (e & 1)) x = 0.f;
          s[4 * c + e] = x;
        }
      }
      ta_pack_a(s, pf);
      // dV += P^T dO and dP^T = V dO^T, in flight together
      ta_reg_fence(dv);
      ta_reg_fence(dp);
      ta_wg_fence();
      ta_acc_64<D>(dv, pf, doh);
      ta_prod_64<D>(dp, sv + wg * HALF, doh);
      ta_wg_commit();
      ta_wg_wait0();
      ta_reg_fence(dv);
      ta_reg_fence(dp);
      // dS^T = P^T (dP^T - delta[query])
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 dd = *reinterpret_cast<const float2*>(
            dr + hq * 64 + 8 * c + cb);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * c + e] = s[4 * c + e] *
                          (dp[4 * c + e] - ((e & 1) ? dd.y : dd.x));
      }
      ta_pack_a(dp, pf);
      // dK += dS^T Q
      ta_reg_fence(dk);
      ta_wg_fence();
      ta_acc_64<D>(dk, pf, qh);
      ta_wg_commit();
      ta_wg_wait0();
      ta_reg_fence(dk);
    }

    const int32_t len = grp * (cur.r + 1);
    if (cur.p == len - 1 || t == count - 1) {     // the segment's end
      const int64_t b = cur.st / a.kv_heads, hk = cur.st % a.kv_heads;
      if (seg_p0 == 0 && cur.p == len - 1) {      // a whole column
        const int64_t s0 = (int64_t)j * TA_SM90_BLK;
        ta_store_bf16<D>(dk, (__nv_bfloat16*)a.dk + b * a.dk_sb +
                                 hk * a.dk_sh + s0 * a.dk_ss,
                         a.dk_ss, row_a, cb, a.scale);
        ta_store_bf16<D>(dv, (__nv_bfloat16*)a.dv + b * a.dv_sb +
                                 hk * a.dv_sh + s0 * a.dv_ss,
                         a.dv_ss, row_a, cb, 1.f);
      } else {                                    // a piece: its slot
        const int64_t p = (int64_t)blockIdx.x * 2 + (seg_p0 > 0 ? 0 : 1);
        ta_store_ws<D>(dk, a.ws_dk + p * TA_SM90_BLK * D, row_a, cb);
        ta_store_ws<D>(dv, a.ws_dv + p * TA_SM90_BLK * D, row_a, cb);
      }
    }
    __syncthreads();                  // stage st (and k, v at a column's
    if (tid == 0) {                   // end) free
      issue_q();
      if (t + 1 < count) {
        TaRun nx = cur;
        ta_run_advance(nx, a.nb, grp);
        if (nx.p == 0) issue_kv(nx);
      }
    }
    __syncwarp();
    ta_run_advance(cur, a.nb, grp);
  }
}

// grid (n_cta): CTA c walks the valid cells of [cU, (c+1)U) of the rows.
template <int D>
__global__ void __launch_bounds__(TA_BWD_THREADS, 1)
ta_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const TaBwdArgs a) {
  using SM = TaBwdSmem<D>;
  constexpr int TILE = SM::TILE, BOX = SM::BOX, HALF = SM::HALF;
  constexpr int NBOX = D / 64, NA = D / 2;
  extern __shared__ uint8_t ta_bwd_smem[];
  const uint32_t base = (ta_smem(ta_bwd_smem) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + TILE, sk = base + 2 * TILE,
                 sv = base + 4 * TILE;
  const uint32_t bar = base + 6 * TILE;   // full_row, full_kv[2]

  TaRun cur;
  const int64_t count = ta_run_cta(a, 1, blockIdx.x, &cur);
  if (count <= 0) return;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int x = 0; x < 3; ++x) ta_mbar_init(bar + 8 * x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The loader, run by thread 0 alone: cell ld_t's k and v into stage
  // ld_t % 2; q and dO of a row when the row starts.
  const int group = a.heads / a.kv_heads;
  TaRun ld = cur;
  int64_t ld_t = 0;
  auto issue_kv = [&]() {
    if (ld_t >= count) return;
    const int b = (int)(ld.st / a.heads), h = (int)(ld.st % a.heads);
    const int st = (int)(ld_t & 1);
    const uint32_t fk = bar + 8 + 8 * st;
    ta_mbar_expect_tx(fk, 2 * TILE);
#pragma unroll
    for (int x = 0; x < NBOX; ++x) {
      ta_tma_load(sk + st * TILE + x * BOX, &tk, fk, 64 * x,
                  ld.p * TA_SM90_BLK, h / group, b);
      ta_tma_load(sv + st * TILE + x * BOX, &tv, fk, 64 * x,
                  ld.p * TA_SM90_BLK, h / group, b);
    }
    ta_run_advance(ld, a.nb, 1);
    ++ld_t;
  };
  auto issue_row = [&](const TaRun& c) {
    const int b = (int)(c.st / a.heads), h = (int)(c.st % a.heads);
    ta_mbar_expect_tx(bar, 2 * TILE);
#pragma unroll
    for (int x = 0; x < NBOX; ++x) {
      ta_tma_load(sq + x * BOX, &tq, bar, 64 * x, c.r * TA_SM90_BLK, h, b);
      ta_tma_load(sdo + x * BOX, &tdo, bar, 64 * x, c.r * TA_SM90_BLK, h, b);
    }
  };
  if (tid == 0) {
    issue_row(cur);
    issue_kv();
    issue_kv();
  }
  __syncwarp();

  // This thread's queries of the 128-row tile (the accumulator layout)
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int row_a = wg * 64 + warp * 16 + (lane >> 2);
  const int cb = 2 * (lane & 3);
  float dq[NA], s[32], dp[32];
  uint32_t pf[16];
#pragma unroll
  for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
  float l_a = 0.f, l_b = 0.f, d_a = 0.f, d_b = 0.f;
  int32_t seg_j0 = 0, row = 0;

#pragma unroll 1
  for (int64_t t = 0; t < count; ++t) {
    const int i = cur.r, j = cur.p;
    if (t == 0 || j == 0) {           // a new row segment
      if (t > 0) ++row;
      seg_j0 = j;
#pragma unroll
      for (int x = 0; x < NA; ++x) dq[x] = 0.f;
      const int64_t r0 = cur.st * a.seq + (int64_t)i * TA_SM90_BLK + row_a;
      l_a = a.lse[r0];
      l_b = a.lse[r0 + 8];
      d_a = a.delta[r0];
      d_b = a.delta[r0 + 8];
      ta_mbar_wait(bar, row & 1);
    }
    const int st = (int)(t & 1);
    ta_mbar_wait(bar + 8 + 8 * st, (uint32_t)(t >> 1) & 1u);
    __syncwarp();
    const bool diag = i == j;

#pragma unroll 1
    for (int kh = 0; kh < 2; ++kh) {
      if (diag && kh == 1 && wg == 0) continue;   // keys after every query
      const uint32_t kb = sk + st * TILE + kh * HALF;
      const uint32_t vb = sv + st * TILE + kh * HALF;
      // S = Q K^T and dP = dO V^T (64 queries x 64 keys)
      ta_reg_fence(s);
      ta_reg_fence(dp);
      ta_wg_fence();
      ta_prod_64<D>(s, sq + wg * HALF, kb);
      ta_prod_64<D>(dp, sdo + wg * HALF, vb);
      ta_wg_commit();
      ta_wg_wait0();
      ta_reg_fence(s);
      ta_reg_fence(dp);
      // P = 2^(S D^-1/2 log2 e - L), the causal mask at i == j;
      // dS = P (dP - delta)
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          float p = exp2f(fmaf(s[4 * c + e], a.scale_log2, -(lo ? l_a : l_b)));
          if (diag && kh * 64 + 8 * c + cb + (e & 1) > row_a + 8 * (e >> 1))
            p = 0.f;
          dp[4 * c + e] = p * (dp[4 * c + e] - (lo ? d_a : d_b));
        }
      ta_pack_a(dp, pf);
      // dQ += dS K
      ta_reg_fence(dq);
      ta_wg_fence();
      ta_acc_64<D>(dq, pf, kb);
      ta_wg_commit();
      ta_wg_wait0();
      ta_reg_fence(dq);
    }

    if (j == i || t == count - 1) {             // the segment's end
      if (seg_j0 == 0 && j == i) {              // a whole row
        const int64_t b = cur.st / a.heads, h = cur.st % a.heads;
        ta_store_bf16<D>(dq, (__nv_bfloat16*)a.dq + b * a.dq_sb +
                                 h * a.dq_sh +
                                 (int64_t)i * TA_SM90_BLK * a.dq_ss,
                         a.dq_ss, row_a, cb, a.scale);
      } else {                                  // a piece: its slot
        const int64_t p = (int64_t)blockIdx.x * 2 + (seg_j0 > 0 ? 0 : 1);
        ta_store_ws<D>(dq, a.ws_dq + p * TA_SM90_BLK * D, row_a, cb);
      }
    }
    __syncthreads();                  // stage st (and q, dO at a row's end)
    if (tid == 0) {                   // free
      issue_kv();
      if (t + 1 < count) {
        TaRun nx = cur;
        ta_run_advance(nx, a.nb, 1);
        if (nx.p == 0) issue_row(nx);
      }
    }
    __syncwarp();
    ta_run_advance(cur, a.nb, 1);
  }
}

// grid (n_cta - 1, 2): block (c - 1, y) looks at the boundary between CTAs
// c - 1 and c of the dQ pass's rows (y = 0) or of the dK, dV pass's columns
// (y = 1).  It acts only if that boundary cuts a row (column) and is its
// first boundary; then it adds the pieces -- CTA c0's slot 1, CTAs
// c0+1..c1's slot 0 -- in ascending order and writes the gradient.
template <int D>
__global__ void __launch_bounds__(TA_BWD_THREADS)
ta_bwd_combine_kernel(const TaBwdArgs a) {
  const int64_t c = (int64_t)blockIdx.x + 1;
  const int64_t g = c * a.steps_per_cta;
  if (g >= a.n_cells) return;
  const bool cols = blockIdx.y == 1;
  const int32_t grp = cols ? a.heads / a.kv_heads : 1;
  const TaRun at = ta_run_cell(a.mode, a.nb, grp, g);
  const int64_t len = (int64_t)grp * (at.r + 1);
  if (at.p == 0 || at.p >= len) return;
  const int64_t row0 = g - at.p;                  // the row's first cell
  const int64_t c0 = row0 / a.steps_per_cta;
  if (c0 != c - 1) return;
  const int64_t c1 = (row0 + len - 1) / a.steps_per_cta;
  if (!cols) {
    const int64_t b = at.st / a.heads, h = at.st % a.heads;
    __nv_bfloat16* dq = (__nv_bfloat16*)a.dq + b * a.dq_sb + h * a.dq_sh +
                        (int64_t)at.r * TA_SM90_BLK * a.dq_ss;
    for (int e = threadIdx.x; e < TA_SM90_BLK * D; e += TA_BWD_THREADS) {
      float acc = 0.f;
      for (int64_t cc = c0; cc <= c1; ++cc)
        acc += a.ws_dq[(cc * 2 + (cc == c0 ? 1 : 0)) * TA_SM90_BLK * D + e];
      dq[(e / D) * a.dq_ss + e % D] = __float2bfloat16_rn(acc * a.scale);
    }
    return;
  }
  const int64_t b = at.st / a.kv_heads, hk = at.st % a.kv_heads;
  const int64_t s0 = (int64_t)(a.nb - 1 - at.r) * TA_SM90_BLK;
  __nv_bfloat16* dk = (__nv_bfloat16*)a.dk + b * a.dk_sb + hk * a.dk_sh +
                      s0 * a.dk_ss;
  __nv_bfloat16* dv = (__nv_bfloat16*)a.dv + b * a.dv_sb + hk * a.dv_sh +
                      s0 * a.dv_ss;
  for (int e = threadIdx.x; e < TA_SM90_BLK * D; e += TA_BWD_THREADS) {
    float sk = 0.f, sv = 0.f;
    for (int64_t cc = c0; cc <= c1; ++cc) {
      const int64_t p = (cc * 2 + (cc == c0 ? 1 : 0)) * TA_SM90_BLK * D + e;
      sk += a.ws_dk[p];
      sv += a.ws_dv[p];
    }
    dk[(e / D) * a.dk_ss + e % D] = __float2bfloat16_rn(sk * a.scale);
    dv[(e / D) * a.dv_ss + e % D] = __float2bfloat16_rn(sv);
  }
}

// ---------------------------------------------------------------------------
// host side: the launch
// ---------------------------------------------------------------------------

template <int D>
static int ta_bwd_run(const TaBwdArgs& a, const CUtensorMap& tq,
                      const CUtensorMap& tk, const CUtensorMap& tv,
                      const CUtensorMap& tdo, cudaStream_t st) {
  constexpr int smem = TaBwdSmem<D>::BYTES;
  // the shared-memory opt-in, once per device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !opted_in[dev]) {
    err = cudaFuncSetAttribute(ta_bwd_dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ta_bwd_dq_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) opted_in[dev] = true;
  }
  const int64_t rows = (int64_t)a.batch * a.heads * a.seq;
  ta_bwd_delta_kernel<D><<<(unsigned int)((rows + 7) / 8), 256, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ta_bwd_dkdv_kernel<D><<<(unsigned int)a.n_cta, TA_BWD_THREADS, smem, st>>>(
      tq, tk, tv, tdo, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ta_bwd_dq_kernel<D><<<(unsigned int)a.n_cta, TA_BWD_THREADS, smem, st>>>(
      tq, tk, tv, tdo, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_cta < 2) return (int)err;
  ta_bwd_combine_kernel<D>
      <<<dim3((unsigned int)(a.n_cta - 1), 2), TA_BWD_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// Launches the sm90 route's backward (delta, the dK/dV pass, the dQ pass,
// the combine) on `stream`: bf16 q, k, v, o, dO, block 128, head_dim 64 or
// 128, and the forward's L.  Returns 0, a cudaError_t, or a TA_ERR_* code.
extern "C" int ta_bwd_launch(const TaBwdArgs* a, int32_t head_dim,
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
  CUtensorMap tq, tk, tv, tdo;
  int rc = ta_tensor_map(&tq, a->q, a->batch, a->heads, a->seq, head_dim,
                         a->q_sb, a->q_sh, a->q_ss);
  if (rc == 0)
    rc = ta_tensor_map(&tk, a->k, a->batch, a->kv_heads, a->seq, head_dim,
                       a->k_sb, a->k_sh, a->k_ss);
  if (rc == 0)
    rc = ta_tensor_map(&tv, a->v, a->batch, a->kv_heads, a->seq, head_dim,
                       a->v_sb, a->v_sh, a->v_ss);
  if (rc == 0)
    rc = ta_tensor_map(&tdo, a->dout, a->batch, a->heads, a->seq, head_dim,
                       a->do_sb, a->do_sh, a->do_ss);
  if (rc != 0) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  return head_dim == 128 ? ta_bwd_run<128>(*a, tq, tk, tv, tdo, st)
                         : ta_bwd_run<64>(*a, tq, tk, tv, tdo, st);
}
