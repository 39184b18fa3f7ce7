// Causal attention forward over the lower-triangular block domain, for Hopper.
//
// Replaces the TPU kernel repro/kernels/tri_attn/kernel.py::_attn_kernel
// (built by build_attention_call): o = softmax(q k^T D^-1/2, causal) v, with
// fp32 m / l / acc, NEG_INF masking and o in q's dtype.  The wrapper
// (kernel.py::launch_attention) takes one of two routes, by dtype and shape,
// before any launch:
//
//   * sm90 (tri_attn_sm90.cuh, included at the end of this file): bf16,
//     block 128, head_dim 64 or 128 -- the LM path's case.  wgmma, TMA loads
//     and a persistent grid; see the note there.
//   * simt (this file): every other shape -- fp32 inputs, and bf16 with
//     another block (16, 32 or 64 rows) or head_dim (8, 16 or 32).
//
// The simt route.  The (q block i, k block j) pairs with j <= i are the
// paper's 2D triangular domain.  On the TPU the grid ran in order and carried
// m, l, acc from step j to step j+1 in VMEM; a CUDA block carries them only
// inside itself, so the work is cut into cells and two launches:
//
//   * Cells are strips.  Cell (bh, i, g) takes q block i against the key
//     blocks j = gG .. min(i, gG+G-1), a strip of at most G blocks, with the
//     online softmax's (m, l, acc) in registers along it in ascending j, and
//     writes one fp32 partial.  Row i has floor(i/G)+1 strips; the wrapper
//     picks G (kernel.py::default_strip).  G = 1 is the pair grid.
//   * The strip launch's grid is the paper's point.  "mapped" launches
//     exactly B*H*C(nb, G) blocks, C = sum_i (floor(i/G)+1) = G*T(Q) + r*(Q+1)
//     for nb = QG + r, and block lambda derives (i, g) through the exact
//     staircase map (ta_lam_to_ig): q = tri_row(floor(lambda/G)) with the
//     int64 root and ladder of the triangular map, rem = lambda - G*T(q),
//     i = qG + floor(rem/(q+1)), g = rem mod (q+1).  "bounding_box" launches
//     nb*ceil(nb/G) blocks a (b, h) and those with g > floor(i/G) return at
//     once (the paper's discard `if`).  Both index the partial by lambda.
//   * The combine launch, shared by both modes: one warp takes a group of q
//     rows and merges each row's strips in ascending g (m and l read once and
//     two exp2 a (row, strip), acc as float4), then writes o.  Both modes
//     compute the same cells with the same code and merge them in the same
//     order, so their outputs are bit-identical.
//
// Inside a cell: BLK/16 warps, each owning 16 q rows.  K and V arrive in
// tiles of KT keys (32 in fp32, 64 in bf16, at most the block) by 16-byte
// cp.async into a two-stage ring, so tile t+1 loads while tile t computes;
// q arrives once a strip.  Both products run on the tensor cores as
// mma.sync m16n8k8 TF32 with fp32 accumulation:
//
//   * fp32 inputs are split 3xTF32: hi = tf32(x) (rna), lo = x - hi, and
//     a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, which keeps fp32 accuracy
//     (one TF32 product keeps about 3 digits).  At block 128 each k and v
//     tile is split once for all eight warps into hi/lo buffers (TaStrip).
//   * bf16 inputs are exact in TF32: Q K^T is one product; P V is two, P
//     split and V exact.  P is never rounded to bf16.
//   * The scale D^-1/2 log2(e) multiplies the fp32 scores (not q), the causal
//     mask is applied only where j == i (a tile whose keys all follow a
//     warp's rows is skipped), and the row max, exp2 and row sum run on the
//     accumulator fragments (quad shuffles).  Each 8-wide k step takes its k
//     index in the order (0, 2, 4, 6, 1, 3, 5, 7), in both operands alike, so
//     an accumulator fragment of S is already P's operand fragment for P V:
//     P never leaves the registers, and a thread's two k values of K (and of
//     q) are adjacent in shared memory.  Row pitches are padded so the
//     fragment loads hit distinct banks.
//
// GQA: a block reads kv head h / (H / Hk) in place.  q, k, v and o are
// addressed through (b, h, s) strides with d contiguous; the wrapper makes a
// copy only where a row is not 16-byte aligned.
//
// What bounds the simt route on an H100: at (1, 32, 4 kv, 4096, 128) causal
// attention needs 137.5 GFLOP -- in bf16 0.139 ms at 989 TFLOP/s, in fp32
// as 3xTF32 0.833 ms at 495 TFLOP/s (2.05 ms on the CUDA cores at 67) --
// against 0.023-0.045 ms of bytes: it is bound by operations.  This design
// keeps the products on the tensor cores and the scores on chip; what it
// does not do is wgmma (mma.sync reaches only a part of the TF32 rate),
// overlap the exps and splits with the products (the warps of a block meet
// at a barrier every tile), or keep the workspace on chip:
// B*H*C*block*(D+2) fp32 (170 MB at block 128 with G = 8 and at block 64
// with G = 16, against 1.125 and 2.215 GB for the pair grid), written once
// and read once by the combine.
#include "tri_attn_common.cuh"

constexpr int TA_COMBINE_THREADS = 128;

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
  float* ws_acc;              // (nbh, C, block, D) unnormalized strip p v
  float* ws_m;                // (nbh, C, block) strip row max, log2 domain
  float* ws_l;                // (nbh, C, block) strip row sum of exp2
  int64_t cells;              // C(nb, G): cells (strips) per (b, h)
  int32_t heads, kv_heads;
  int32_t bh0, nbh;           // this launch's (b*H + h) range
  int32_t nb;                 // seq / block
  int32_t strip;              // G: key blocks a cell
  float scale_log2;           // head_dim^-1/2 * log2(e), on the fp32 scores
};

// The staircase map lambda -> (i, g) over the cells of strips of G blocks:
// rows qG .. qG+G-1 each have q+1 strips and start at lambda = G*T(q).
__device__ __forceinline__ void ta_lam_to_ig(int64_t lam, int32_t strip,
                                             int32_t* i, int32_t* g) {
  const int64_t q = ta_tri_row(lam / strip);
  const int64_t rem = lam - (int64_t)strip * (q * (q + 1) / 2);
  *i = (int32_t)(q * strip + rem / (q + 1));
  *g = (int32_t)(rem % (q + 1));
}

// Its inverse: the lambda of cell (i, g).
__device__ __forceinline__ int64_t ta_ig_to_lam(int32_t i, int32_t g,
                                                int32_t strip) {
  const int64_t q = i / strip;
  return (int64_t)strip * (q * (q + 1) / 2) + (int64_t)(i - q * strip) * (q + 1)
         + g;
}

// ---------------------------------------------------------------------------
// building blocks
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ta_cp16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void ta_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every committed group but the newest has landed
__device__ __forceinline__ void ta_cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ta_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo: hi = tf32(x) rounded to nearest, lo = x - hi exactly (|lo| <=
// 2^-11 |x|).  A TF32 product reads only an operand's top 19 bits, so lo
// enters it truncated to TF32: x is kept to about 2^-21.
__device__ __forceinline__ void ta_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = ta_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b, one m16n8k8 TF32 product with fp32 accumulation
__device__ __forceinline__ void ta_mma(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two adjacent elements as fp32 (exact for bf16)
__device__ __forceinline__ float2 ta_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ta_pair(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float ta_elem(const float* p) { return *p; }
__device__ __forceinline__ float ta_elem(const __nv_bfloat16* p) {
  return __uint_as_float((uint32_t)(*reinterpret_cast<const uint16_t*>(p))
                         << 16);
}

__device__ __forceinline__ void ta_store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void ta_store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&a);
  w.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

// Shapes of a cell's block: warps of 16 q rows; KT keys a tile; row pitches
// (elements) padded so each fragment load of a warp hits distinct banks.
//   * q (and bf16 k): 8 mod 16, a thread's two k values adjacent (fp32
//     8-byte loads; bf16 4-byte loads); bf16 v: 8 mod 16 (rows 2t, 2t+1).
//   * fp32 at block 128 (SB): k and v arrive raw in a two-stage ring (PK,
//     PV) and are split once a tile for all 8 warps into hi/lo buffers, read
//     by one 16-byte load a fragment: KS holds (hi, hi, lo, lo) of k's two
//     adjacent columns (pitch 16 mod 32), VS of v's two adjacent rows (pitch
//     8 mod 32).  Splitting each fragment in every warp instead repeats
//     every split eight times over.  At 1-4 warps a block the buffers cost
//     more than they save: they raise a block's shared memory at D 128
//     from 103 to 172 KB (block 64) and from 86 to 154 KB (block 32), one
//     block an SM instead of two, and at (1, 32, 4 kv, 4096, 128) on an
//     H100 (attn_times.py) took 4.28 ms against 3.21 at block 64 and
//     11.40 against 5.27 at block 32.
//   * otherwise k and v are read as they arrived, from a two-stage ring
//     (fp32 split at each fragment; bf16 exact).
template <typename T, int BLK, int D>
struct TaStrip {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int WARPS = BLK / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int KT = BLK < (F32 ? 32 : 64) ? BLK : (F32 ? 32 : 64);
  static constexpr int SUB = BLK / KT;             // tiles a key block
  static constexpr int DR = (D + 15) / 16 * 16;
  static constexpr int PK = DR + 8;
  static constexpr int PV = F32 ? D + 4 : PK;
  static constexpr int PKS = 2 * DR + 16;          // floats, fp32 only
  static constexpr int PVS = 4 * D + 8;
  static constexpr bool SB = F32 && WARPS == 8;
  static constexpr int SPLIT = SB ? (KT * PKS + KT / 2 * PVS) * 4 : 0;
  static constexpr int SMEM =
      (BLK * PK + 2 * KT * (PK + PV)) * (int)sizeof(T) + SPLIT;
  static_assert(D % 8 == 0 && D <= 128, "head_dim: a multiple of 8, <= 128");
};

// ROWS rows of D elements from global (row stride ss) to shared (PITCH), as
// 16-byte cp.async copies spread over the block's threads
template <typename T, int ROWS, int D, int PITCH, int THREADS>
__device__ __forceinline__ void ta_load_rows(T* s, const T* g, int64_t ss,
                                             int tid) {
  constexpr int EPC = 16 / (int)sizeof(T);
  constexpr int CPR = D / EPC;
  for (int e = tid; e < ROWS * CPR; e += THREADS) {
    const int r = e / CPR, c = (e % CPR) * EPC;
    ta_cp16(s + r * PITCH + c, g + r * ss + c);
  }
}

// (hi, hi, lo, lo) of two fp32 values
__device__ __forceinline__ float4 ta_split2(float x, float y) {
  uint32_t hx, lx, hy, ly;
  ta_split(x, hx, lx);
  ta_split(y, hy, ly);
  return make_float4(__uint_as_float(hx), __uint_as_float(hy),
                     __uint_as_float(lx), __uint_as_float(ly));
}

// One cell (bh, i, g): q block i against key blocks gG .. min(i, gG+G-1),
// its partial (m, l, acc) written at cell lambda.
template <typename T, int BLK, int D>
__device__ __forceinline__ void ta_strip(const TaArgs& a, int bh_local,
                                         int32_t i, int32_t g, int64_t lam) {
  using C = TaStrip<T, BLK, D>;
  constexpr int KT = C::KT, PK = C::PK, PV = C::PV, NT = KT / 8, ND = D / 8;
  constexpr int PKS = C::PKS, PVS = C::PVS;
  extern __shared__ __align__(16) unsigned char ta_strip_smem[];
  T* sQ = reinterpret_cast<T*>(ta_strip_smem);  // BLK x PK
  T* sK = sQ + BLK * PK;                        // 2 stages of KT x PK
  T* sV = sK + 2 * KT * PK;                     // 2 stages of KT x PV
  float* sKS = reinterpret_cast<float*>(sV + 2 * KT * PV);  // KT x PKS
  float* sVS = sKS + KT * PKS;                  // KT/2 x PVS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bh = a.bh0 + bh_local;
  const int b = bh / a.heads, h = bh % a.heads;
  const int hk = h / (a.heads / a.kv_heads);
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh +
               (int64_t)i * BLK * a.q_ss;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  const int32_t j0 = g * a.strip;
  const int32_t j1 = min(i, j0 + a.strip - 1);
  const int ntile = (j1 - j0 + 1) * C::SUB;

  // tile t: keys (t % SUB) * KT .. of block j0 + t / SUB, into stage t & 1
  auto issue = [&](int t) {
    const int64_t row = (int64_t)(j0 + t / C::SUB) * BLK + (t % C::SUB) * KT;
    ta_load_rows<T, KT, D, PK, C::THREADS>(sK + (t & 1) * KT * PK,
                                           k + row * a.k_ss, a.k_ss, tid);
    ta_load_rows<T, KT, D, PV, C::THREADS>(sV + (t & 1) * KT * PV,
                                           v + row * a.v_ss, a.v_ss, tid);
  };
  ta_load_rows<T, BLK, D, PK, C::THREADS>(sQ, q, a.q_ss, tid);
  issue(0);
  ta_cp_commit();
  if (ntile > 1) issue(1);
  ta_cp_commit();

  const int r0 = warp * 16 + gid;               // this thread's rows r0, r0+8
  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m0 = TA_NEG_INF, m1 = TA_NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < ntile; ++t) {
    ta_cp_wait_all_but_one();                   // tile t (and q) landed
    __syncthreads();                            // ... for every thread
    const T* tK = sK + (t & 1) * KT * PK;
    const T* tV = sV + (t & 1) * KT * PV;
    if constexpr (C::SB) {
      // split the tile once for all warps (tile t-1's reads are done), then
      // free its stage for tile t+2
      for (int e = tid; e < KT * D / 2; e += C::THREADS) {
        const int r = e / (D / 2), c = e % (D / 2);
        const float2 x = ta_pair(tK + r * PK + 2 * c);
        *reinterpret_cast<float4*>(sKS + r * PKS + 4 * c) = ta_split2(x.x, x.y);
      }
      for (int e = tid; e < KT / 2 * D; e += C::THREADS) {
        const int r = e / D, c = e % D;
        *reinterpret_cast<float4*>(sVS + r * PVS + 4 * c) =
            ta_split2(tV[2 * r * PV + c], tV[(2 * r + 1) * PV + c]);
      }
      __syncthreads();
      if (t + 2 < ntile) issue(t + 2);
      ta_cp_commit();
    }
    const int32_t j = j0 + t / C::SUB;
    const int kb = (t % C::SUB) * KT;           // the tile's first key in j
    const bool diag = j == i;
    // on the diagonal a tile whose keys all follow this warp's rows is skipped
    if (!diag || kb <= warp * 16 + 15) {
      // S = q k^T: fragment (nt, e) is row r0 + 8(e/2), key
      // kb + 8nt + 2tig + e%2
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < ND; ++kt) {
        const int c = kt * 8 + 2 * tig;
        const float2 qa = ta_pair(sQ + r0 * PK + c);
        const float2 qb = ta_pair(sQ + (r0 + 8) * PK + c);
        uint32_t ah[4], al[4];
        if constexpr (C::F32) {
          ta_split(qa.x, ah[0], al[0]);
          ta_split(qb.x, ah[1], al[1]);
          ta_split(qa.y, ah[2], al[2]);
          ta_split(qb.y, ah[3], al[3]);
        } else {
          ah[0] = __float_as_uint(qa.x);
          ah[1] = __float_as_uint(qb.x);
          ah[2] = __float_as_uint(qa.y);
          ah[3] = __float_as_uint(qb.y);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh0, bh1, bl0, bl1;
          if constexpr (C::SB) {
            const float4 kq = *reinterpret_cast<const float4*>(
                sKS + (nt * 8 + gid) * PKS + 16 * kt + 4 * tig);
            bh0 = __float_as_uint(kq.x);
            bh1 = __float_as_uint(kq.y);
            bl0 = __float_as_uint(kq.z);
            bl1 = __float_as_uint(kq.w);
          } else {
            const float2 kk = ta_pair(tK + (nt * 8 + gid) * PK + c);
            if constexpr (C::F32) {
              ta_split(kk.x, bh0, bl0);
              ta_split(kk.y, bh1, bl1);
            } else {
              bh0 = __float_as_uint(kk.x);
              bh1 = __float_as_uint(kk.y);
            }
          }
          if constexpr (C::F32) {
            ta_mma(s[nt], al, bh0, bh1);
            ta_mma(s[nt], ah, bl0, bl1);
          }
          ta_mma(s[nt], ah, bh0, bh1);
        }
      }
      // scale, causal mask, online softmax in the log2 domain
      float mx0 = TA_NEG_INF, mx1 = TA_NEG_INF;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * a.scale_log2;
          if (diag && kb + nt * 8 + 2 * tig + (e & 1) > r0 + 8 * (e >> 1))
            x = TA_NEG_INF;
          s[nt][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - mn0);
        s[nt][1] = exp2f(s[nt][1] - mn0);
        s[nt][2] = exp2f(s[nt][2] - mn1);
        s[nt][3] = exp2f(s[nt][3] - mn1);
        rs0 += s[nt][0] + s[nt][1];
        rs1 += s[nt][2] + s[nt][3];
      }
      l0 = l0 * al0 + rs0;                      // this thread's columns only
      l1 = l1 * al1 + rs1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        o[dn][0] *= al0;
        o[dn][1] *= al0;
        o[dn][2] *= al1;
        o[dn][3] *= al1;
      }
      // O += P V: S's fragment kk is P's operand for keys kb + 8kk ..
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t ph[4], pl[4];
        ta_split(s[kk][0], ph[0], pl[0]);
        ta_split(s[kk][2], ph[1], pl[1]);
        ta_split(s[kk][1], ph[2], pl[2]);
        ta_split(s[kk][3], ph[3], pl[3]);
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          uint32_t bh0, bh1, bl0, bl1;
          if constexpr (C::SB) {
            const float4 vq = *reinterpret_cast<const float4*>(
                sVS + (kk * 4 + tig) * PVS + 4 * (dn * 8 + gid));
            bh0 = __float_as_uint(vq.x);
            bh1 = __float_as_uint(vq.y);
            bl0 = __float_as_uint(vq.z);
            bl1 = __float_as_uint(vq.w);
          } else {
            const T* vr = tV + (kk * 8 + 2 * tig) * PV + dn * 8 + gid;
            if constexpr (C::F32) {
              ta_split(ta_elem(vr), bh0, bl0);
              ta_split(ta_elem(vr + PV), bh1, bl1);
            } else {
              bh0 = __float_as_uint(ta_elem(vr));
              bh1 = __float_as_uint(ta_elem(vr + PV));
            }
          }
          ta_mma(o[dn], pl, bh0, bh1);
          if constexpr (C::F32) ta_mma(o[dn], ph, bl0, bl1);
          ta_mma(o[dn], ph, bh0, bh1);
        }
      }
    }
    if constexpr (!C::SB) {
      __syncthreads();                          // stage t & 1 is free again
      if (t + 2 < ntile) issue(t + 2);
      ta_cp_commit();
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int64_t row = ((int64_t)bh_local * a.cells + lam) * BLK + r0;
  float* wa = a.ws_acc + row * D + 2 * tig;
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
    *reinterpret_cast<float2*>(wa + dn * 8) = make_float2(o[dn][0], o[dn][1]);
    *reinterpret_cast<float2*>(wa + 8 * D + dn * 8) =
        make_float2(o[dn][2], o[dn][3]);
  }
  if (tig == 0) {
    a.ws_m[row] = m0;
    a.ws_m[row + 8] = m1;
    a.ws_l[row] = l0;
    a.ws_l[row + 8] = l1;
  }
}

// grid (C, nbh): block lambda is cell (i, g) of the staircase map
template <typename T, int BLK, int D>
__global__ void __launch_bounds__(TaStrip<T, BLK, D>::THREADS)
ta_strip_mapped_kernel(TaArgs a) {
  int32_t i, g;
  ta_lam_to_ig((int64_t)blockIdx.x, a.strip, &i, &g);
  ta_strip<T, BLK, D>(a, blockIdx.y, i, g, (int64_t)blockIdx.x);
}

// grid (ceil(nb / G), nb, nbh): block (g, i); cells past row i's last strip
// are discarded
template <typename T, int BLK, int D>
__global__ void __launch_bounds__(TaStrip<T, BLK, D>::THREADS)
ta_strip_bb_kernel(TaArgs a) {
  const int32_t g = blockIdx.x, i = blockIdx.y;
  if (g > i / a.strip) return;
  ta_strip<T, BLK, D>(a, blockIdx.z, i, g, ta_ig_to_lam(i, g, a.strip));
}

// grid (nb, nbh): q block i of one (b, h) merges its strips g = 0..i/G.  A
// row is D/4 float4 columns, one a lane; a warp takes 32/(D/4) rows at once.
template <typename T, int BLK, int D>
__global__ void __launch_bounds__(TA_COMBINE_THREADS)
ta_strip_combine_kernel(TaArgs a) {
  constexpr int LPR = D / 4;                    // lanes a row (D <= 128)
  constexpr int RPI = TA_COMBINE_THREADS / LPR;
  const int32_t i = blockIdx.x;
  const int bh_local = blockIdx.y;
  const int bh = a.bh0 + bh_local;
  const int b = bh / a.heads, h = bh % a.heads;
  const int32_t n_strip = i / a.strip + 1;
  const int64_t cell0 =
      (int64_t)bh_local * a.cells + ta_ig_to_lam(i, 0, a.strip);
  T* o = (T*)a.o + b * a.o_sb + h * a.o_sh + (int64_t)i * BLK * a.o_ss;
  const int c4 = threadIdx.x % LPR;
  const float4* acc4 = reinterpret_cast<const float4*>(a.ws_acc);
  for (int r = threadIdx.x / LPR; r < BLK; r += RPI) {
    float m = TA_NEG_INF, l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int32_t gg = 0; gg < n_strip; ++gg) {
      const int64_t row = (cell0 + gg) * BLK + r;
      const float mj = a.ws_m[row], lj = a.ws_l[row];
      const float mn = fmaxf(m, mj);
      const float alpha = exp2f(m - mn), beta = exp2f(mj - mn);
      const float4 x = acc4[row * LPR + c4];
      l = l * alpha + lj * beta;
      acc.x = acc.x * alpha + x.x * beta;
      acc.y = acc.y * alpha + x.y * beta;
      acc.z = acc.z * alpha + x.z * beta;
      acc.w = acc.w * alpha + x.w * beta;
      m = mn;
    }
    ta_store4(o + r * a.o_ss + 4 * c4,
              make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l));
  }
}

template <typename T, int BLK, int D>
static int ta_launch(const TaArgs& a, int mode, cudaStream_t st) {
  using C = TaStrip<T, BLK, D>;
  const unsigned int nbh = (unsigned int)a.nbh, nb = (unsigned int)a.nb;
  cudaError_t err;
  if (mode == 0) {
    err = cudaFuncSetAttribute(ta_strip_mapped_kernel<T, BLK, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return (int)err;
    ta_strip_mapped_kernel<T, BLK, D>
        <<<dim3((unsigned int)a.cells, nbh), C::THREADS, C::SMEM, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(ta_strip_bb_kernel<T, BLK, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (err != cudaSuccess) return (int)err;
    const unsigned int n_strip = (nb + a.strip - 1) / a.strip;
    ta_strip_bb_kernel<T, BLK, D>
        <<<dim3(n_strip, nb, nbh), C::THREADS, C::SMEM, st>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ta_strip_combine_kernel<T, BLK, D>
      <<<dim3(nb, nbh), TA_COMBINE_THREADS, 0, st>>>(a);
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

// Launches the strip launch (mode 0: mapped, 1: bounding box) and the combine
// launch on `stream`; dtype 0 is fp32, 1 bf16.  Returns the launches'
// cudaError_t (0 on success), or cudaErrorInvalidValue for an argument this
// file has no kernel for (a->cells must be C(nb, strip)).
extern "C" int ta_attn_launch(const TaArgs* a, int32_t block,
                              int32_t head_dim, int32_t dtype, int32_t mode,
                              void* stream) {
  if (a->nbh <= 0 || a->nb <= 0) return 0;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  if (a->kv_heads <= 0 || a->heads % a->kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  if (a->strip < 1 || a->strip > a->nb) return (int)cudaErrorInvalidValue;
  const int64_t nq = a->nb / a->strip, rest = a->nb % a->strip;
  if (a->cells != a->strip * (nq * (nq + 1) / 2) + rest * (nq + 1))
    return (int)cudaErrorInvalidValue;
  if (a->nbh > 65535 || a->nb > 65535 || a->cells > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return ta_dispatch<float>(*a, block, head_dim, mode, st);
  if (dtype == 1)
    return ta_dispatch<__nv_bfloat16>(*a, block, head_dim, mode, st);
  return (int)cudaErrorInvalidValue;
}

__global__ void ta_lam_to_ig_kernel(int64_t lam0, int64_t n, int32_t strip,
                                    int32_t* __restrict__ i_out,
                                    int32_t* __restrict__ g_out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    int32_t i, g;
    ta_lam_to_ig(lam0 + t, strip, &i, &g);
    i_out[t] = i;
    g_out[t] = g;
  }
}

// Writes the strip kernel's own (i, g) for lambda in [lam0, lam0 + n) at
// strip length `strip` (strip 1: the triangular map's (i, j)), so a caller
// can hold the device-side map exact against integer arithmetic.
extern "C" int ta_lam_to_ig_launch(int64_t lam0, int64_t n, int32_t strip,
                                   int32_t* i_out, int32_t* g_out,
                                   void* stream) {
  if (n <= 0) return 0;
  if (strip < 1) return (int)cudaErrorInvalidValue;
  const int64_t want = (n + 255) / 256;
  const unsigned int blocks = (unsigned int)(want < 65536 ? want : 65536);
  ta_lam_to_ig_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      lam0, n, strip, i_out, g_out);
  return (int)cudaGetLastError();
}

#include "tri_attn_sm90.cuh"
