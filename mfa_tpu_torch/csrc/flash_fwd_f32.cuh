// The fp32 attention tiles for Hopper (sm_90a): fp32 q, k, v (or fp32 q on
// int8 / fp8 / int4 pages). The prefill kernels run the 64-row tile on
// tensor cores (`attend_tc` below) when their inputs are fp32: kernels 1-4,
// 7 and 9 (fwd_kernel below: the classic, flagged, repair, bound /
// unchecked and image kinds of flash_fwd_sm90.cuh, and its packed layout),
// launched from prefill.cu, bound.cu and blockmask.cu, and kernel 8
// (paged_prefill.cu). The decode kernels 5 and 6 take fp32 q on their own
// tile (decode_sm90.cuh).
// Each kernel sets up its block's rows (a Row each: q and O rows, position,
// visible columns, ALiBi slope) and an issuer of its K/V tiles' copies, and
// runs the body. The semantics are those of the bf16 tiles and of the plain
// versions (kernels/prefill.py, paged_prefill.py): row r sees the band
// columns [lo, hi), the sink columns [slo, shi) and, for the image kind,
// the columns that carry its own image-run id; a row that sees no column
// stores O = 0 and LSE = -inf.
//
// Bound: operations, 4 D flops per visible (row, column) pair, at the
// card's fp32-accurate tensor-core rate: 3xTF32, 495 / 3 = 165 TFLOP/s.
// The 64-row tile's design:
//  - Products on tensor cores in 3xTF32 (tf32.cuh): mma.sync m16n8k8 .tf32,
//    lo.hi + hi.lo + hi.hi of each fp32 product (lo.lo dropped), each part
//    a fresh accumulator's pass over all n-tiles before the next.
//    kernels/backward.py:_matmul_3xtf32_plain emulates
//    them. wgmma's .tf32 form takes only K-major operands, and V in P V is
//    MN-major.
//  - Operands stay fp32 in shared memory and are split as they are read
//    (hi rounded to TF32, lo = x - hi passed whole: three instructions a
//    value). Split once into hi / lo planes, a tile would cost a pass and a
//    barrier more, and the planes twice the shared-memory reads, the rate
//    that bounds this tile: each K value is read by the 4 row groups.
//  - 8 warps as 4 row groups x 2 feature halves: warp (rg, cg) forms S of
//    its 16 rows over every key of the tile but only its half cg of the
//    features, swaps that partial S with warp (rg, 1 - cg) through an
//    exchange buffer (a named barrier of the pair), so that both hold the
//    whole S (the same sum in both: the softmax and l agree bit for bit),
//    and forms O of its 16 rows on its half of the columns. A row's
//    reductions are quad shuffles (4 lanes).
//  - P stays in registers: the m16n8 accumulator holds columns 2t, 2t + 1 of
//    a lane's rows and the m16n8k8 .tf32 A operand k slots t, t + 4, so
//    within each 8-key slab the keys feed P V in the order 0, 2, 4, 6, 1, 3,
//    5, 7, and V's B fragment reads keys 2t and 2t + 1 to match (the sum
//    over keys is unchanged). The same pairing feeds S: k slots t, t + 4 <-
//    features 2t, 2t + 1 of both Q and K, one 8-byte read each.
//  - Row strides: Q and K D + 8 floats (8-byte reads at banks 8g + 2t), V
//    D + 4 (4-byte reads of rows 2t, 2t + 1 at banks 8t + g).
//  - Accumulation: the tensor core truncates the sums it accumulates, so S
//    sums fresh accumulators over at most 64 features, O a fresh one over a
//    tile, added to the running sums by FADD (O = O alpha + f: one FFMA).
//  - Loads: a 2-slot cp.async ring (zeros past the valid length and past
//    dw) handed over by mbarriers, with no block barrier: each thread's
//    arrival on the slot's full barrier fires once its copies land
//    (cp.async.mbarrier.arrive), each warp arrives on its empty barrier
//    when done with it, and tile t + 1 is issued as soon as every warp has
//    released tile t - 1, so it lands during tile t's products. The warps
//    drift apart by up to a tile; a pair sits on two schedulers (warps 2 rg
//    and 2 rg + 1), so that on each scheduler one warp's products can
//    overlap another's softmax.
//  - Quantized pages (kernel 8): the payload values are exact in TF32 and in
//    bf16 (lo = 0), so S is q_lo.k + q_hi.k, and p, rounded to bf16 after
//    V's scale is folded in, meets V in one exact bf16 m16n8k16 product. The
//    bytes land in the ring and are converted once a tile in shared memory
//    (K to fp32 rows, V to bf16 key pairs) between two block barriers.
//  - BN = 64 keys a tile at D 128, 32 at D 64 and 256 (TcPlan::bytes:
//    65-221 KB); one block an SM, two at D 64 (at most 128 registers a
//    thread), so that short rows overlap one block's first loads with the
//    other's products. The mask is skipped where the band covers the
//    warp's rows over the whole tile.
// Softmax: classic = online softmax in the log2 domain, y = s c (softcap
// first; ALiBi subtracted as slope log2 e |position - column|), p =
// exp2(y - m), a masked column's p exactly 0. Zero shift (kernels 2 and 4)
// = p = exp2(y) with no max and no rescale; in fp32 p is not rounded for
// P V, so O is normalized by the same l that gives LSE = ln l and the
// poison check (flash_fwd_sm90.cuh, prefill.py:_zero_shift_plain): a row is
// poisoned when its band is not structurally empty and l lies outside
// (MFA_L_MIN, inf), or one of its O values is not finite; a block (64 rows)
// is one flag tile. Quantized pages (fp32 q): K's scales multiply the
// score columns, V's fold into p after the row sum, and p is rounded to
// bf16 before P V, as the plain versions and mfa_tpu compute them (q . k in
// fp32 against the payload values, which are exact in bf16).
#pragma once

#include "flash_fwd_sm90.cuh"
#include "tf32.cuh"

namespace af32 {

using namespace tc32;

constexpr int THREADS = 256;  // 8 warps

// A block row: what a block body needs of it. Rows that hold no query (q
// null) compute on zeros and store nothing unless o / lse are set.
struct Row {
  const float* q;  // q row (dw features), or null
  float* o;        // O row, or null (not stored)
  float* lse;      // natural-log LSE, or null
  int lo, hi;      // band columns [lo, hi)
  int slo, shi;    // sink columns [slo, shi)
  int pos;         // position against the columns (ALiBi)
  int rid;         // image-run id (-1: none)
  float slope;     // ALiBi slope in the log2 domain (0: none)
};

// The tiles a block visits: sink tiles [sfirst, sfirst + nsink), then the
// band's from `first`; n in all.
struct Tiles {
  int sfirst, nsink, first, n;
  __device__ __forceinline__ int at(int i) const { return i < nsink ? sfirst + i : first + (i - nsink); }
};

// The block's column bounds, gathered from its rows (shared ints, set by
// bounds_init before and combined by bounds_add).
struct Bounds {
  int blo, bhi, slo, shi;
};
__device__ __forceinline__ void bounds_init(Bounds* b) {
  b->blo = 0x7fffffff;
  b->bhi = 0;
  b->slo = 0x7fffffff;
  b->shi = 0;
}
__device__ __forceinline__ void bounds_add(Bounds* b, const Row& r) {
  if (r.hi > r.lo) {
    atomicMin(&b->blo, r.lo);
    atomicMax(&b->bhi, r.hi);
  }
  if (r.shi > r.slo) {
    atomicMin(&b->slo, r.slo);
    atomicMax(&b->shi, r.shi);
  }
}
// Bounds -> tiles of bn keys: the sink tiles before the band's first tile,
// then the band (the two merged where they meet). Sinks never start past
// the band (slo <= lo for every row).
__device__ __forceinline__ Tiles tiles_of(const Bounds& b, int bn) {
  int a0 = b.slo / bn, a1 = (b.shi + bn - 1) / bn;  // sink tiles [a0, a1)
  int c0 = b.blo / bn, c1 = (b.bhi + bn - 1) / bn;  // band tiles [c0, c1)
  const bool sink = b.shi > b.slo, band = b.bhi > b.blo;
  if (!sink && !band) return Tiles{0, 0, 0, 0};
  if (!sink) return Tiles{0, 0, c0, c1 - c0};
  if (!band || a1 >= c0) {  // one run of tiles
    const int hi = band ? max(a1, c1) : a1;
    return Tiles{0, 0, a0, hi - a0};
  }
  return Tiles{a0, a1 - a0, c0, (a1 - a0) + (c1 - c0)};
}

// The scores' arithmetic: c = scale * log2 e (log2 e with a softcap, whose
// multiplier folds the scale), softcap > 0: tanh(s * softcap_mul) * softcap.
struct Math {
  float c, softcap, softcap_mul;
  int dw;  // stored features of a row (a multiple of 4, <= D)
};

// A row's band is structurally empty and no sink column lies below its end.
__device__ __forceinline__ bool empty_band(const Row& r) { return r.hi <= r.lo && r.shi <= r.slo; }

// One quantized byte -> its payload value (exact in fp32, and in bf16).
__device__ __forceinline__ float e4m3_value(uint32_t b) {
  const uint32_t e = (b >> 3) & 15u, mant = b & 7u;
  float x;
  if (e == 0)
    x = (float)mant * 0x1p-9f;  // subnormal: mant 2^-9
  else if (e == 15 && mant == 7)
    x = __int_as_float(0x7fc00000);  // the NaN code
  else
    x = __uint_as_float(((e + 120u) << 23) | (mant << 20));
  return __uint_as_float(__float_as_uint(x) | ((b & 0x80u) << 24));
}

__device__ __forceinline__ float* smem_f32() {
  extern __shared__ __align__(16) float af32_smem[];
  return af32_smem;
}

// -- the 64-row tile on tensor cores ------------------------------------------

// Shared memory of the 64-row tile (floats): Q [64][QS]; the ring [2][SLOT]
// (fp32: K rows [BN][KS], V rows [BN][VS], the columns' image-run ids [BN];
// quantized pages: K and V bytes and their scales); quantized pages only,
// the converted tile: K [BN][KS] fp32 (exact values) and V as bf16 key
// pairs [VR][VS] (row (s, t) of the 16-key slab s holds keys 16 s + 2 t, +
// 1 and 16 s + 2 t + 8, + 9 of each column); the exchange [2 halves][64][ES];
// the tile's K and V scales [2][BN]; the rows; the ring's mbarriers (full
// [2]: every thread's copies of the slot's tile landed; empty [2]: every
// warp is done with it).
template <int D, bool QUANT>
struct TcPlan {
  static constexpr int RM = 64;                   // rows: one flag tile
  static constexpr int BN = D == 128 ? 64 : 32;   // keys a tile
  static constexpr int BLOCKS = D == 64 ? 2 : 1;  // blocks an SM
  static constexpr int HD = D / 2;                // a warp's half
  static constexpr int NT = BN / 8;               // S n-tiles a warp
  static constexpr int NO = HD / 8;               // O n-tiles a warp
  static constexpr int QS = D + 8;                // Q row (floats)
  static constexpr int KS = D + 8;                // K row
  static constexpr int VS = QUANT ? 2 * D + 8 : D + 4;  // V row (fp32), or words a pair row
  static constexpr int VR = QUANT ? BN / 4 : 0;   // converted V rows
  static constexpr int ES = BN + 8;               // exchange row
  static constexpr int SLOT = QUANT ? BN * D / 2 + 2 * BN : BN * (KS + VS) + BN;
  static constexpr int ring_off = RM * QS;
  static constexpr int kp_off = ring_off + 2 * SLOT;
  static constexpr int vp_off = kp_off + (QUANT ? BN * KS : 0);
  static constexpr int e_off = vp_off + VR * VS;
  static constexpr int sc_off = e_off + 2 * RM * ES;
  static constexpr int row_off = sc_off + 2 * BN;
  static constexpr size_t bar_bytes = (size_t)row_off * 4 + RM * sizeof(Row);
  static constexpr size_t bytes = bar_bytes + 4 * 8;
  static_assert(D % 64 == 0 && row_off % 4 == 0 && SLOT % 4 == 0 && bar_bytes % 8 == 0,
                "tile shape");
  static_assert(BLOCKS * (bytes + sizeof(Bounds) + 1024) <= 233472, "an SM's shared memory");
};

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void st2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ uint32_t fu(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Payload value of feature c of a staged row of bytes (int4: feature 2c in
// byte c's low nibble).
template <KV F>
__device__ __forceinline__ float byte_value(const uint8_t* row, int c) {
  if constexpr (F == KV::I4) {
    const uint32_t b = row[c >> 1];
    return (float)((int32_t)(b << (28 - 4 * (c & 1))) >> 28);
  } else if constexpr (F == KV::E4M3) {
    return e4m3_value(row[c]);
  } else {
    return (float)(int8_t)row[c];
  }
}

// Q's 64 rows, fp32 (zeros for rows without q and past dw).
template <int D>
__device__ __forceinline__ void load_q(float* qs, const Row* rows, int dw) {
  using P = TcPlan<D, false>;
  for (int i = threadIdx.x; i < P::RM * D / 4; i += THREADS) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rows[r].q != nullptr && c < dw) x = __ldg(reinterpret_cast<const float4*>(rows[r].q + c));
    *reinterpret_cast<float4*>(qs + r * P::QS + c) = x;
  }
}

// Copy the fp32 tile of columns [kv0, kv0 + BN) into a ring slot: row_of(col)
// -> the offset of column col's row in k and v (floats), for col < valid;
// other rows and the features past dw are zeros.
template <int D, class RowOf>
__device__ __forceinline__ void issue_f32(float* slot, const float* k, const float* v, int kv0,
                                          int valid, int dw, RowOf row_of) {
  using P = TcPlan<D, false>;
  constexpr int BN = P::BN, CH = D / 4;
#pragma unroll
  for (int i = threadIdx.x; i < BN * CH; i += THREADS) {
    const int j = i / CH, c = (i % CH) * 4, col = kv0 + j;
    const bool ok = col < valid && c < dw;
    const size_t off = ok ? row_of(col) + c : 0;
    cp16(slot + j * P::KS + c, k + off, ok);
    cp16(slot + BN * P::KS + j * P::VS + c, v + off, ok);
  }
}

// The same from quantized pages: rows of w bytes staged at D bytes (D / 2
// for int4) apart, then the K and V row scales; page_row(col) -> the row's
// index in the pool, for col < valid; other rows are zeros with zero scales.
template <int D, KV F, class PageRow>
__device__ __forceinline__ void issue_quant(float* slot, const int8_t* k, const int8_t* v,
                                            const float* k_scale, const float* v_scale, int kv0,
                                            int valid, int dw, PageRow page_row) {
  constexpr int BN = TcPlan<D, true>::BN, RB = F == KV::I4 ? D / 2 : D, CH = RB / 16;
  const int w = F == KV::I4 ? dw / 2 : dw;
  uint8_t* kb = reinterpret_cast<uint8_t*>(slot);
  for (int i = threadIdx.x; i < BN * CH; i += THREADS) {
    const int j = i / CH, c = (i % CH) * 16, col = kv0 + j;
    const bool ok = col < valid && c < w;
    const size_t off = ok ? (size_t)page_row(col) * w + c : 0;
    cp16(kb + j * RB + c, k + off, ok);
    cp16(kb + BN * D + j * RB + c, v + off, ok);
  }
  float* sc = reinterpret_cast<float*>(kb + 2 * BN * D);
  for (int j = threadIdx.x; j < BN; j += THREADS) {
    const int col = kv0 + j;
    const bool ok = col < valid;
    const size_t r = ok ? (size_t)page_row(col) : 0;
    cp4(sc + j, k_scale + r, ok);
    cp4(sc + BN + j, v_scale + r, ok);
  }
}

// A landed slot of bytes converted: K to fp32 rows, V to bf16 key pairs,
// the scales to `scs` (they outlive the slot, which the next copy takes).
template <int D, KV F>
__device__ __forceinline__ void convert_kv(const float* slot, float* ks, float* vs, float* scs) {
  using P = TcPlan<D, true>;
  constexpr int BN = P::BN, RB = F == KV::I4 ? D / 2 : D;
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(slot);
  const uint8_t* vb = kb + BN * D;
  for (int i = threadIdx.x; i < BN * D / 4; i += THREADS) {  // K row j, features c..c + 3
    const int j = i / (D / 4), c = (i % (D / 4)) * 4;
    const uint8_t* r = kb + j * RB;
    *reinterpret_cast<float4*>(ks + j * P::KS + c) =
        make_float4(byte_value<F>(r, c), byte_value<F>(r, c + 1), byte_value<F>(r, c + 2),
                    byte_value<F>(r, c + 3));
  }
  uint32_t* vw = reinterpret_cast<uint32_t*>(vs);
  for (int i = threadIdx.x; i < BN / 4 * D; i += THREADS) {  // V row (s, t), column c
    const int st = i / D, c = i % D;
    const uint8_t* r = vb + (16 * (st >> 2) + 2 * (st & 3)) * RB;
    const uint32_t w0 = pack_bf16(byte_value<F>(r, c), byte_value<F>(r + RB, c));
    const uint32_t w1 = pack_bf16(byte_value<F>(r + 8 * RB, c), byte_value<F>(r + 9 * RB, c));
    *reinterpret_cast<uint2*>(vw + st * P::VS + 2 * c) = make_uint2(w0, w1);
  }
  const float* sc = reinterpret_cast<const float*>(kb + 2 * BN * D);
  for (int j = threadIdx.x; j < 2 * BN; j += THREADS) scs[j] = sc[j];
}

// The warp's partial S: rows r0 + g (+ 8) x the tile's keys 8 j + 2t (+ 1)
// over features [cg HD, (cg + 1) HD), fresh accumulators of at most 64
// features added in order. Both operands are read as fp32 and split as
// read (k slots t, t + 4 <- features 2t, 2t + 1 of Q and K); QUANT: K's
// values are exact in TF32, so S = q_lo.k + q_hi.k. Each pass runs over
// all n-tiles before the next: NT independent accumulators.
template <int D, bool QUANT>
__device__ __forceinline__ void s_half(float (&s)[TcPlan<D, QUANT>::NT][4], const float* qs,
                                       const float* kt, int r0, int cg) {
  using P = TcPlan<D, QUANT>;
  constexpr int NT = P::NT, HD = P::HD, KC = HD < 64 ? HD : 64;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* qa = qs + (r0 + g) * P::QS + cg * HD + 2 * t4;
  const float* kb = kt + g * P::KS + cg * HD + 2 * t4;
#pragma unroll
  for (int c0 = 0; c0 < HD; c0 += KC) {
    float f[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) f[j][0] = f[j][1] = f[j][2] = f[j][3] = 0.f;
#pragma unroll
    for (int kk = c0; kk < c0 + KC; kk += 8) {
      uint32_t ah[4], al[4];
      const float2 a = ld2(qa + kk), b = ld2(qa + 8 * P::QS + kk);
      split(a.x, ah[0], al[0]);
      split(b.x, ah[1], al[1]);
      split(a.y, ah[2], al[2]);
      split(b.y, ah[3], al[3]);
      float2 x[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) x[j] = ld2(kb + 8 * j * P::KS + kk);
      if constexpr (QUANT) {
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(f[j], al, fu(x[j].x), fu(x[j].y));
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(f[j], ah, fu(x[j].x), fu(x[j].y));
      } else {
        uint32_t h[NT][2], l[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          split(x[j].x, h[j][0], l[j][0]);
          split(x[j].y, h[j][1], l[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(f[j], al, h[j][0], h[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(f[j], ah, l[j][0], l[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(f[j], ah, h[j][0], h[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = c0 == 0 ? f[j][e] : s[j][e] + f[j][e];
  }
}

// The 64-row block body. issue(kv0, slot) copies the tile of columns [kv0,
// kv0 + BN) into a ring slot (issue_f32 or issue_quant; F: KV::F16 = fp32
// rows, else the page format). ZS: the zero-shift softmax; returns whether
// one of this thread's rows is poisoned (ZS only). IMG: `ids` [sk]
// image-run ids of the sequence's columns (a column is also visible to a
// row of the same id).
template <int D, bool ZS, KV F, bool IMG, class Issue>
__device__ __forceinline__ bool attend_tc(float* sm, const Row* rows, const Tiles& tl,
                                          const Math& mt, const int* ids, int sk, Issue issue) {
  constexpr bool QUANT = F != KV::F16;
  using P = TcPlan<D, QUANT>;
  constexpr int BN = P::BN, NT = P::NT, NO = P::NO, HD = P::HD, ES = P::ES, VS = P::VS;
  constexpr int NC = NO < 8 ? NO : 8;  // O n-tiles formed together
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int rg = warp >> 1, cg = warp & 1, r0 = 16 * rg;
  float* qs = sm;
  float* ring = sm + P::ring_off;
  float* mine = sm + P::e_off + cg * P::RM * ES;  // this warp's partial S
  const float* other = sm + P::e_off + (1 - cg) * P::RM * ES;
  float* scs = sm + P::sc_off;  // K scales [BN], V scales [BN]
  const uint32_t full = smem_u32(reinterpret_cast<char*>(sm) + P::bar_bytes), empty = full + 16;
  // tile i's copies into slot i % 2 (and, IMG, its columns' run ids: a
  // column past sk lands as 0 and is told apart by col < sk); fp32: each
  // thread's arrival on the slot's full barrier once its copies land
  auto fetch = [=](int i) {
    const int kv0 = tl.at(i) * BN;
    float* slot = ring + (i & 1) * P::SLOT;
    issue(kv0, slot);
    if constexpr (IMG) {
      int* id = reinterpret_cast<int*>(slot + BN * (P::KS + VS));
      for (int j = threadIdx.x; j < BN; j += THREADS) {
        const bool ok = kv0 + j < sk;
        cp4(id + j, ids + (ok ? kv0 + j : 0), ok);
      }
    }
    if constexpr (QUANT)
      cp_commit();
    else
      cp_arrive(full + 8 * (i & 1));
  };

  if (threadIdx.x == 0) {
    mbar_init(full, THREADS);
    mbar_init(full + 8, THREADS);
    mbar_init(empty, 8);
    mbar_init(empty + 8, 8);
    mbar_fence_init();
  }
  __syncthreads();
  if (tl.n > 0) fetch(0);
  load_q<D>(qs, rows, mt.dw);  // while the first tile lands
  __syncthreads();
  // the lane's two rows, r0 + g and r0 + g + 8
  int lo[2], hi[2], slo[2], shi[2], pos[2], rid[2];
  float sl[2], m[2], l[2], o[NO][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const Row& r = rows[r0 + g + 8 * h];
    lo[h] = r.lo, hi[h] = r.hi, slo[h] = r.slo, shi[h] = r.shi;
    pos[h] = r.pos, rid[h] = r.rid, sl[h] = r.slope;
    m[h] = ZS ? 0.f : MFA_MASK;
    l[h] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int it = 0; it < tl.n; ++it) {
    const int kv0 = tl.at(it) * BN;
    const float* slot = ring + (it & 1) * P::SLOT;
    if constexpr (QUANT) {
      cp_wait<0>();
      __syncthreads();  // tile it landed; every read of tile it - 1 is done
      if (it + 1 < tl.n) fetch(it + 1);  // lands during this tile's products
    } else {
      // no block barrier: the warps drift apart by up to a tile, so that
      // one warp's products overlap another's softmax on a scheduler
      if (it + 1 < tl.n) {
        // slot (it + 1) % 2 held tile it - 1: every warp has released it
        if (it >= 1) mbar_wait(empty + 8 * ((it + 1) & 1), ((it - 1) >> 1) & 1);
        fetch(it + 1);  // lands during this tile's products
      }
      mbar_wait(full + 8 * (it & 1), (it >> 1) & 1);  // tile it landed
    }
    const float* kt = slot;
    const float* vt = slot + BN * P::KS;
    const int* idt = reinterpret_cast<const int*>(slot + BN * (P::KS + VS));
    if constexpr (QUANT) {
      convert_kv<D, F>(slot, sm + P::kp_off, sm + P::vp_off, scs);
      __syncthreads();  // the converted tile is whole
      kt = sm + P::kp_off;
      vt = sm + P::vp_off;
    }

    // S = Q K^T: this half's features, then the other half's added
    float s[NT][4];
    s_half<D, QUANT>(s, qs, kt, r0, cg);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      st2(mine + (r0 + g) * ES + 8 * j + 2 * t4, s[j][0], s[j][1]);
      st2(mine + (r0 + g + 8) * ES + 8 * j + 2 * t4, s[j][2], s[j][3]);
    }
    named_sync(1 + rg, 64);  // warps 2 rg and 2 rg + 1
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 a = ld2(other + (r0 + g) * ES + 8 * j + 2 * t4);
      const float2 b = ld2(other + (r0 + g + 8) * ES + 8 * j + 2 * t4);
      s[j][0] += a.x, s[j][1] += a.y, s[j][2] += b.x, s[j][3] += b.y;
    }
    named_sync(1 + rg, 64);  // both halves read: the buffers are free again

    // scores in the log2 domain, masks, softmax (element e of n-tile j: row
    // r0 + g + 8 (e >> 1), column kv0 + 8 j + 2 t4 + (e & 1))
    const bool whole = __all_sync(0xffffffffu, lo[0] <= kv0 && kv0 + BN <= hi[0] &&
                                                   lo[1] <= kv0 && kv0 + BN <= hi[1]);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t vis = 0xffffffffu;  // bit 2 j + e
      float mx = MFA_MASK;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jj = 8 * j + 2 * t4 + e, col = kv0 + jj;
          float y = s[j][2 * h + e];
          if constexpr (QUANT) y *= scs[jj];
          if (mt.softcap > 0.f) y = tanhf(y * mt.softcap_mul) * mt.softcap;
          y *= mt.c;
          if (sl[h] != 0.f) y -= sl[h] * fabsf((float)(pos[h] - col));
          if (!whole) {
            bool v = (col >= lo[h] && col < hi[h]) || (col >= slo[h] && col < shi[h]);
            if constexpr (IMG) v = v || (col < sk && rid[h] >= 0 && idt[jj] == rid[h]);
            if (!v) {
              vis &= ~(1u << (2 * j + e));
              y = MFA_MASK;
            }
          }
          s[j][2 * h + e] = y;
          mx = fmaxf(mx, y);
        }
      float ps = 0.f;
      if constexpr (ZS) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& p = s[j][2 * h + e];
            p = (vis >> (2 * j + e)) & 1u ? exp2f(p) : 0.f;
            ps += p;
          }
        l[h] += ps;
        alpha[h] = 1.f;
      } else {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[h], mx);
        alpha[h] = exp2f(m[h] - mn);
        m[h] = mn;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& p = s[j][2 * h + e];
            p = (vis >> (2 * j + e)) & 1u ? exp2f(p - mn) : 0.f;
            ps += p;
          }
        l[h] = alpha[h] * l[h] + ps;
      }
    }

    // O = O alpha + P V over this warp's columns [cg HD, (cg + 1) HD), NC
    // n-tiles at a time (independent accumulators, fresh over the tile)
    if constexpr (QUANT) {
      // V's scales fold into p, rounded to bf16: one exact bf16 product
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 vsc = ld2(scs + BN + 8 * j + 2 * t4);
        pa[j / 2][2 * (j & 1)] = pack_bf16(s[j][0] * vsc.x, s[j][1] * vsc.y);
        pa[j / 2][2 * (j & 1) + 1] = pack_bf16(s[j][2] * vsc.x, s[j][3] * vsc.y);
      }
      const uint32_t* vb = reinterpret_cast<const uint32_t*>(vt) + t4 * VS + 2 * (cg * HD + g);
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NC) {
        float f[NC][4];
#pragma unroll
        for (int n = 0; n < NC; ++n) f[n][0] = f[n][1] = f[n][2] = f[n][3] = 0.f;
#pragma unroll
        for (int s2 = 0; s2 < NT / 2; ++s2) {
          uint2 b[NC];
#pragma unroll
          for (int n = 0; n < NC; ++n)
            b[n] = *reinterpret_cast<const uint2*>(vb + 4 * s2 * VS + 16 * (n0 + n));
#pragma unroll
          for (int n = 0; n < NC; ++n) mma_bf16(f[n], pa[s2], b[n].x, b[n].y);
        }
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[n0 + n][e] = ZS ? o[n0 + n][e] + f[n][e] : fmaf(o[n0 + n][e], alpha[e >> 1], f[n][e]);
      }
    } else {
      // keys 2t, 2t + 1 of each 8-key slab in k slots t, t + 4: P straight
      // from the S accumulators, V's rows 2t and 2t + 1 read to match
      const float* vb = vt + 2 * t4 * VS + cg * HD + g;
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += NC) {
        float f[NC][4];
#pragma unroll
        for (int n = 0; n < NC; ++n) f[n][0] = f[n][1] = f[n][2] = f[n][3] = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t ph[4], pl[4];
          split(s[j][0], ph[0], pl[0]);
          split(s[j][2], ph[1], pl[1]);
          split(s[j][1], ph[2], pl[2]);
          split(s[j][3], ph[3], pl[3]);
          uint32_t h[NC][2], lw[NC][2];
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            const float* v = vb + 8 * j * VS + 8 * (n0 + n);
            split(v[0], h[n][0], lw[n][0]);
            split(v[VS], h[n][1], lw[n][1]);
          }
#pragma unroll
          for (int n = 0; n < NC; ++n) mma_tf32(f[n], pl, h[n][0], h[n][1]);
#pragma unroll
          for (int n = 0; n < NC; ++n) mma_tf32(f[n], ph, lw[n][0], lw[n][1]);
#pragma unroll
          for (int n = 0; n < NC; ++n) mma_tf32(f[n], ph, h[n][0], h[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[n0 + n][e] = ZS ? o[n0 + n][e] + f[n][e] : fmaf(o[n0 + n][e], alpha[e >> 1], f[n][e]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (it & 1));  // this warp is done with slot it % 2
    }
  }

  // Epilogue: full row sums, O and LSE of the stored rows.
  bool poison = false;
  const int dw = mt.dw;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float li = l[h];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const Row& r = rows[r0 + g + 8 * h];
    const bool bad = li == 0.f || isnan(li);
    // classic: a row with l == 0 saw no column (O = 0); zero shift: O = acc / l
    // with l == 0 or NaN left unnormalized, as the plain version does
    const float inv = ZS ? 1.f / (bad ? 1.f : li) : (li == 0.f ? 0.f : 1.f / li);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float x0 = o[n][2 * h] * inv, x1 = o[n][2 * h + 1] * inv;
      if constexpr (ZS) poison |= !(isfinite(x0) && isfinite(x1));
      const int c = cg * HD + 8 * n + 2 * t4;
      if (r.o != nullptr && c < dw) st2(r.o + c, x0, x1);
    }
    if constexpr (ZS) {
      if (r.q != nullptr)
        poison |= !((li > MFA_L_MIN && li < INFINITY) || (empty_band(r) && li == 0.f));
    }
    if (r.lse != nullptr && cg == 0 && t4 == 0)
      r.lse[0] = li == 0.f ? -INFINITY : (ZS ? logf(bad ? 1.f : li) : m[h] * MFA_LN2 + logf(li));
  }
  return poison;
}

// Kernels 1-4, 7 and 9 in fp32: grid (hq, batch, ceil(sq / 64)), 64 rows a
// block = one flag tile [b, hq, ceil(sq / 64)]. KIND as flash_fwd_sm90.cuh:
// PREFILL (classic), FLAGGED (zero shift, the tile's poison flag written
// to table unless it is null), REPAIR (a block whose flag is 0 leaves;
// otherwise the classic rows over the same tiles in the same order as
// PREFILL, so a repaired tile equals kernel 1's bit for bit), BOUND (the
// risky bit picks the softmax; a null table = "unchecked", all zero
// shift), IMAGE (classic, plus the same-run columns). PACKED (PREFILL
// only): q [total_q, hq, dw], k/v [total_k, hkv, dw], LSE [hq, total_q],
// offsets from cu_seqlens. The layouts, the band, sinks, ALiBi (slopes in
// the raw score domain) and kv_off are fa90::Args'.
template <int D, int KIND, bool PACKED>
__global__ void __launch_bounds__(THREADS, TcPlan<D, false>::BLOCKS)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int* __restrict__ table, const fa90::Args args) {
  static_assert(!PACKED || KIND == fa90::PREFILL, "the packed layout runs the classic softmax");
  using P = TcPlan<D, false>;
  constexpr int RM = P::RM;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // longest causal tiles first
  const int q0 = qb * RM;
  fa90::Args a = args;
  int q_row0 = 0, k_row0 = 0;
  if constexpr (PACKED) {
    q_row0 = a.cu_q[b];
    a.sq = a.cu_q[b + 1] - q_row0;
    if (q0 >= a.sq) return;
    k_row0 = a.cu_k[b];
    a.sk = a.cu_k[b + 1] - k_row0;
  }
  const size_t tile = (size_t)(b * a.hq + h) * ((a.sq + RM - 1) / RM) + qb;
  if constexpr (KIND == fa90::REPAIR) {
    if (table[tile] == 0) return;  // nothing poisoned
  }
  float* sm = smem_f32();
  Row* rows = reinterpret_cast<Row*>(sm + P::row_off);
  __shared__ Bounds bnd;
  if (threadIdx.x == 0) bounds_init(&bnd);
  __syncthreads();
  const int dw = a.dw, hk = h / (a.hq / a.hkv);
  const float c = a.scale_log2e;
  if (threadIdx.x < RM) {
    const int qr = q0 + threadIdx.x;
    Row r{};
    r.rid = -1;
    if (qr < a.sq) {
      const size_t head = PACKED ? (size_t)(q_row0 + qr) * a.hq + h : (size_t)(b * a.hq + h) * a.sq + qr;
      r.q = q + head * dw;
      r.o = o + head * dw;
      if (lse != nullptr)
        r.lse = PACKED ? lse + (size_t)h * a.total_q + q_row0 + qr : lse + head;
      const int p = qr + a.kv_off;
      r.pos = p;
      r.lo = a.wl >= 0 ? max(0, p - a.wl) : 0;
      r.hi = a.wr >= 0 ? min(a.sk, p + a.wr + 1) : a.sk;
      r.shi = a.wl >= 0 && a.sinks > 0 ? min(a.sinks, r.hi) : 0;
      r.slope = a.slopes != nullptr ? a.slopes[h] * c : 0.f;
      if constexpr (KIND == fa90::IMAGE) r.rid = __ldg(a.ids + (size_t)b * a.sq + qr);
      bounds_add(&bnd, r);
    }
    rows[threadIdx.x] = r;
  }
  if constexpr (KIND == fa90::IMAGE) {
    // the image runs of the block's first and last rows widen its columns
    // (a run is contiguous: those two bound every row's run)
    if (threadIdx.x >= 64 && threadIdx.x < 96) {
      const int* ids = a.ids + (size_t)b * a.sq;
      const int last = min(q0 + RM, a.sq) - 1;
      const int lo = fa90::run_start(ids, q0), hi = fa90::run_end(ids, a.sq, last);
      if (threadIdx.x == 64) {
        atomicMin(&bnd.blo, lo);
        atomicMax(&bnd.bhi, hi + 1);
      }
    }
  }
  __syncthreads();
  const Tiles tl = tiles_of(bnd, P::BN);
  const Math mt{c, a.softcap, a.softcap_mul, dw};
  const float* kb = k + (PACKED ? (size_t)k_row0 * a.hkv + hk : (size_t)(b * a.hkv + hk) * a.sk) * dw;
  const float* vb = v + (kb - k);
  const size_t rs = PACKED ? (size_t)a.hkv * dw : (size_t)dw;
  const int sk = a.sk;
  // lambdas capture by value: a reference capture keeps its variable in
  // local memory
  auto issue = [=](int kv0, float* slot) {
    issue_f32<D>(slot, kb, vb, kv0, sk, dw, [rs](int col) { return col * rs; });
  };
  const int* ids = KIND == fa90::IMAGE ? a.ids + (size_t)b * a.sq : nullptr;
  bool zs = KIND == fa90::FLAGGED || KIND == fa90::UNCHECKED;
  if constexpr (KIND == fa90::BOUND) zs = table == nullptr || table[tile] == 0;
  if constexpr (KIND == fa90::PREFILL || KIND == fa90::REPAIR || KIND == fa90::IMAGE) {
    attend_tc<D, false, KV::F16, KIND == fa90::IMAGE>(sm, rows, tl, mt, ids, sk, issue);
  } else if (!zs) {
    attend_tc<D, false, KV::F16, false>(sm, rows, tl, mt, ids, sk, issue);
  } else {
    const bool poison = attend_tc<D, true, KV::F16, false>(sm, rows, tl, mt, ids, sk, issue);
    if constexpr (KIND == fa90::FLAGGED) {
      const int any = __syncthreads_or(poison);
      if (table != nullptr && threadIdx.x == 0) table[tile] = any != 0;
    }
  }
}

// Launch kernels 1-4 or 9 (batched layout) or 7 (PACKED: max_sq bounds
// every sequence's q length). Returns a cudaError_t code or MFA_BAD_CONFIG.
template <int D, int KIND, bool PACKED = false>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int* table,
               int batch, int max_sq, const fa90::Args& a, cudaStream_t stream) {
  using P = TcPlan<D, false>;
  if (a.dw <= 0 || a.dw > D || a.dw % 4 != 0) return MFA_BAD_CONFIG;
  auto kern = fwd_kernel<D, KIND, PACKED>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                          100))
    return err;
  const dim3 grid(a.hq, batch, (max_sq + 63) / 64);
  kern<<<grid, THREADS, P::bytes, stream>>>(static_cast<const float*>(q),
                                            static_cast<const float*>(k),
                                            static_cast<const float*>(v), static_cast<float*>(o),
                                            lse, table, a);
  return (int)cudaGetLastError();
}

}  // namespace af32
