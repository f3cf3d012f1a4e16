// The fp32 attention tile for Hopper (sm_90a): fp32 q, k, v (or fp32 q on
// int8 / fp8 / int4 pages), one SIMT block body shared by every forward
// attention kernel of the port when its inputs are fp32:
//  - kernels 1-4, 7 and 9 (fwd_kernel below: the classic, flagged, repair,
//    bound / unchecked and image kinds of flash_fwd_sm90.cuh, and its
//    packed layout), launched from prefill.cu, bound.cu and blockmask.cu;
//  - kernels 5 and 6 (decode_f32.cuh, launched from decode.cu and paged.cu);
//  - kernel 8 (paged_prefill.cu).
// Each kernel sets up its block's rows (a Row each: q and O rows, position,
// visible columns, ALiBi slope) and a loader of its K/V tiles, and runs
// `attend`. The semantics are those of the bf16 tiles and of the plain
// versions (kernels/prefill.py, decode.py, paged.py, paged_prefill.py): row
// r sees the band columns [lo, hi), the sink columns [slo, shi) and, for
// the image kind, the columns that carry its own image-run id; a row that
// sees no column stores O = 0 and LSE = -inf.
//
// Why SIMT: wgmma and mma.sync take no fp32 operand, and single-pass TF32
// keeps about three decimal digits, short of the 1e-4 the port's fp32
// results are held to (its plain versions run fp32 matmuls at "highest"
// precision). Each product here is an fp32 FFMA chain, as exact as the
// plain version's, in another order.
//
// Bound: like the bf16 tiles, operations for prefill-shaped calls (4 D
// flops per visible (row, column) pair) and bytes for decode (K and V read
// once); the card's fp32-accurate rate is what bounds it (3xTF32: 495 / 3
// TFLOP/s, or 67 TFLOP/s of FFMA here). The design is the plain one, right
// first (speed is later work):
//  - 256 threads as 16 x 16: thread (ty, tx) owns RPT = RM / 16 rows of S
//    and O (rows ty RPT + i), the S columns tx + 16 j of each BN-key tile,
//    and O's columns 64 c + 4 tx .. + 3.
//  - Q [RM][D + 4] is loaded once; each tile's K [BN][D + 4] and V [BN][D]
//    are loaded by all threads with 16-byte loads (quantized rows converted
//    exactly to fp32 as they land; rows past the valid length and columns
//    past the stored width are zeros), S = Q K^T from float4 reads (the
//    padded rows keep K's reads free of bank conflicts), the online softmax
//    with each row spread over the 16 threads of a half warp (shuffles),
//    P through shared memory, O += P V from float4 reads.
//  - BN = 64 keys a tile at D 64, 32 at D 128 and 256: a block's shared
//    memory (Q + K + V + P) is then 68 KB at D 64, 76 KB at D 128 and 141
//    KB at D 256 with 64 rows, so below D 256 two blocks share an SM
//    (__launch_bounds__ caps them at 128 registers a thread); a row's
//    bounds are read from shared memory, not held in registers.
//  - Blocks visit only the tiles some row can see: the sink tiles, then the
//    band's, no tile twice (the union of their rows' ranges); masks are per
//    element.
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

namespace af32 {

constexpr int THREADS = 256;  // 16 x 16

// A block row: what `attend` needs of it. Rows that hold no query (q
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

template <int RM, int D>
struct Plan {
  static constexpr int BN = D >= 128 ? 32 : 64;  // keys a tile
  static constexpr int RPT = RM / 16;           // rows a thread
  static constexpr int CPT = BN / 16;           // S columns a thread
  static constexpr int OC = D / 64;             // O float4 chunks a thread
  static constexpr int QS = D + 4;              // Q and K row stride (floats)
  static constexpr int PS = BN + 4;             // P row stride
  static constexpr int k_off = RM * QS;
  static constexpr int v_off = k_off + BN * QS;
  static constexpr int p_off = v_off + BN * D;
  static constexpr int ks_off = p_off + RM * PS;  // K scales [BN]
  static constexpr int vs_off = ks_off + BN;      // V scales [BN]
  static constexpr int id_off = vs_off + BN;      // image-run ids [BN]
  static constexpr int row_off = (id_off + BN + 3) / 4 * 4;
  static constexpr size_t bytes = row_off * 4 + RM * sizeof(Row);
  static_assert(RM % 16 == 0 && D % 64 == 0, "tile shape");
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

// The block body. load(kv0, k, v, k_scales, v_scales) fills the tile of
// columns [kv0, kv0 + BN): K rows at stride D + 4, V rows at stride D, fp32
// (zeros past the valid length and past dw); QUANT: the row scales too.
// ZS: the zero-shift softmax; returns whether one of this thread's rows is
// poisoned (ZS only). IMG: `ids` [sk] image-run ids of the sequence's
// columns (a column is also visible to a row of the same id).
template <int RM, int D, bool ZS, bool QUANT, bool IMG, class Load>
__device__ __forceinline__ bool attend(float* sm, const Row* rows, const Tiles& tl,
                                       const Math& mt, const int* ids, int sk, Load load) {
  using P = Plan<RM, D>;
  constexpr int BN = P::BN, RPT = P::RPT, CPT = P::CPT, OC = P::OC, QS = P::QS, PS = P::PS;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float* qs = sm;
  float* ksm = sm + P::k_off;
  float* vsm = sm + P::v_off;
  float* psm = sm + P::p_off;
  float* kss = sm + P::ks_off;
  float* vss = sm + P::vs_off;
  int* idsm = reinterpret_cast<int*>(sm + P::id_off);
  const int dw = mt.dw;

  for (int idx = tid; idx < RM * (D / 4); idx += THREADS) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rows[r].q != nullptr && c < dw) x = __ldg(reinterpret_cast<const float4*>(rows[r].q + c));
    *reinterpret_cast<float4*>(qs + r * QS + c) = x;
  }
  // the rows' bounds stay in shared memory (read once a tile): registers
  // hold only each row's running max and sum and its O
  float m[RPT], l[RPT], acc[RPT][OC][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = ZS ? 0.f : MFA_MASK;
    l[i] = 0.f;
#pragma unroll
    for (int oc = 0; oc < OC; ++oc)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][oc][e] = 0.f;
  }

  for (int it = 0; it < tl.n; ++it) {
    const int kv0 = tl.at(it) * BN;
    __syncthreads();  // the previous tile's K, V and P reads are done
    load(kv0, ksm, vsm, kss, vss);
    if constexpr (IMG) {
      for (int j = tid; j < BN; j += THREADS) idsm[j] = kv0 + j < sk ? __ldg(ids + kv0 + j) : -1;
    }
    __syncthreads();

    // S = Q K^T
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 2  // 4 spilled past the 128 registers of two blocks an SM
    for (int kk = 0; kk < D; kk += 4) {
      float4 a[RPT], b[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (ty * RPT + i) * QS + kk);
#pragma unroll
      for (int j = 0; j < CPT; ++j) b[j] = *reinterpret_cast<const float4*>(ksm + (tx + 16 * j) * QS + kk);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float x = s[i][j];
          x = fmaf(a[i].x, b[j].x, x);
          x = fmaf(a[i].y, b[j].y, x);
          x = fmaf(a[i].z, b[j].z, x);
          x = fmaf(a[i].w, b[j].w, x);
          s[i][j] = x;
        }
    }

    // scores in the log2 domain, masks, softmax; P to shared memory
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const Row& r = rows[ty * RPT + i];
      const int lo = r.lo, hi = r.hi, slo = r.slo, shi = r.shi;
      const float sl = r.slope;
      bool vis[CPT];
      float mx = MFA_MASK;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int jj = tx + 16 * j, col = kv0 + jj;
        float y = s[i][j];
        if constexpr (QUANT) y *= kss[jj];
        if (mt.softcap > 0.f) y = tanhf(y * mt.softcap_mul) * mt.softcap;
        y *= mt.c;
        if (sl != 0.f) y -= sl * fabsf((float)(r.pos - col));
        bool v = (col >= lo && col < hi) || (col >= slo && col < shi);
        if constexpr (IMG) v = v || (r.rid >= 0 && idsm[jj] == r.rid);
        vis[j] = v;
        s[i][j] = v ? y : MFA_MASK;
        mx = fmaxf(mx, s[i][j]);
      }
      float ps = 0.f;
      if constexpr (ZS) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = vis[j] ? exp2f(s[i][j]) : 0.f;
          ps += s[i][j];
        }
        l[i] += ps;
      } else {
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mn = fmaxf(m[i], mx), alpha = exp2f(m[i] - mn);
        m[i] = mn;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = vis[j] ? exp2f(s[i][j] - mn) : 0.f;
          ps += s[i][j];
        }
        l[i] = alpha * l[i] + ps;
#pragma unroll
        for (int oc = 0; oc < OC; ++oc)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][oc][e] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float p = s[i][j];
        if constexpr (QUANT) {  // V scales fold into p, then p is rounded to bf16
          p = __bfloat162float(__float2bfloat16_rn(p * vss[tx + 16 * j]));
        }
        psm[(ty * RPT + i) * PS + tx + 16 * j] = p;
      }
    }
    __syncthreads();

    // O += P V
#pragma unroll 2
    for (int j = 0; j < BN; j += 4) {
      float4 pr[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = *reinterpret_cast<const float4*>(psm + (ty * RPT + i) * PS + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int oc = 0; oc < OC; ++oc) {
          const float4 vv = *reinterpret_cast<const float4*>(vsm + (j + e) * D + 64 * oc + 4 * tx);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float p = e == 0 ? pr[i].x : e == 1 ? pr[i].y : e == 2 ? pr[i].z : pr[i].w;
            acc[i][oc][0] = fmaf(p, vv.x, acc[i][oc][0]);
            acc[i][oc][1] = fmaf(p, vv.y, acc[i][oc][1]);
            acc[i][oc][2] = fmaf(p, vv.z, acc[i][oc][2]);
            acc[i][oc][3] = fmaf(p, vv.w, acc[i][oc][3]);
          }
        }
      }
    }
  }

  // Epilogue: full row sums, O and LSE of the stored rows.
  bool poison = false;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float li = l[i];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) li += __shfl_xor_sync(0xffffffffu, li, o);
    const Row& r = rows[ty * RPT + i];
    const bool bad = li == 0.f || isnan(li);
    // classic: a row with l == 0 saw no column (O = 0); zero shift: O = acc / l
    // with l == 0 or NaN left unnormalized, as the plain version does
    const float inv = ZS ? 1.f / (bad ? 1.f : li) : (li == 0.f ? 0.f : 1.f / li);
#pragma unroll
    for (int oc = 0; oc < OC; ++oc) {
      float4 x = make_float4(acc[i][oc][0] * inv, acc[i][oc][1] * inv, acc[i][oc][2] * inv,
                             acc[i][oc][3] * inv);
      if constexpr (ZS) poison |= !(isfinite(x.x) && isfinite(x.y) && isfinite(x.z) && isfinite(x.w));
      const int c = 64 * oc + 4 * tx;
      if (r.o != nullptr && c < dw) *reinterpret_cast<float4*>(r.o + c) = x;
    }
    if constexpr (ZS) {
      if (r.q != nullptr)
        poison |= !((li > MFA_L_MIN && li < INFINITY) || (empty_band(r) && li == 0.f));
    }
    if (r.lse != nullptr && tx == 0)
      r.lse[0] = li == 0.f ? -INFINITY : (ZS ? logf(bad ? 1.f : li) : m[i] * MFA_LN2 + logf(li));
  }
  return poison;
}

// Fill K/V tile rows from row-addressed fp32 sources: row(col) -> the
// offset of column col's row in k and v (floats), for col < valid; other
// rows and the features past dw are zeros.
template <int RM, int D, class RowOf>
__device__ __forceinline__ void load_f32(const float* k, const float* v, int kv0, int valid,
                                         int dw, float* ksm, float* vsm, RowOf row_of) {
  using P = Plan<RM, D>;
#pragma unroll
  for (int idx = threadIdx.x; idx < P::BN * (D / 4); idx += THREADS) {
    const int j = idx / (D / 4), c = (idx % (D / 4)) * 4, col = kv0 + j;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (col < valid && c < dw) {
      const size_t off = row_of(col) + c;
      kx = __ldg(reinterpret_cast<const float4*>(k + off));
      vx = __ldg(reinterpret_cast<const float4*>(v + off));
    }
    *reinterpret_cast<float4*>(ksm + j * P::QS + c) = kx;
    *reinterpret_cast<float4*>(vsm + j * D + c) = vx;
  }
}

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

// Fill a tile from quantized pages: rows of w bytes (int4: two features a
// byte, feature 2c in byte c's low nibble), their fp32 row scales beside
// them. page_row(col) -> the row's index in the pool ((hk P + page) page_size
// + row), for col < valid; other rows are zeros with zero scales.
template <int RM, int D, KV F, class RowOf>
__device__ __forceinline__ void load_quant(const int8_t* k, const int8_t* v, const float* k_scale,
                                           const float* v_scale, int kv0, int valid, int dw,
                                           float* ksm, float* vsm, float* kss, float* vss,
                                           RowOf page_row) {
  using P = Plan<RM, D>;
  constexpr int FPC = F == KV::I4 ? 32 : 16;  // features a 16-byte chunk holds
  const int w = F == KV::I4 ? dw / 2 : dw;    // bytes of a stored row
  for (int idx = threadIdx.x; idx < P::BN * (D / FPC); idx += THREADS) {
    const int j = idx / (D / FPC), ch = idx % (D / FPC), col = kv0 + j;
    uint4 kb = make_uint4(0u, 0u, 0u, 0u), vb = kb;
    if (col < valid && ch * 16 < w) {
      const size_t off = (size_t)page_row(col) * w + ch * 16;
      kb = __ldg(reinterpret_cast<const uint4*>(k + off));
      vb = __ldg(reinterpret_cast<const uint4*>(v + off));
    }
    const uint32_t kw[4] = {kb.x, kb.y, kb.z, kb.w}, vw[4] = {vb.x, vb.y, vb.z, vb.w};
    float* kd = ksm + j * P::QS + ch * FPC;
    float* vd = vsm + j * D + ch * FPC;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if constexpr (F == KV::I4) {
        float kf[8], vf[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          // nibble n of the word: sign-extended 4-bit value
          kf[n] = (float)((int32_t)(kw[x] << (28 - 4 * n)) >> 28);
          vf[n] = (float)((int32_t)(vw[x] << (28 - 4 * n)) >> 28);
        }
        *reinterpret_cast<float4*>(kd + 8 * x) = make_float4(kf[0], kf[1], kf[2], kf[3]);
        *reinterpret_cast<float4*>(kd + 8 * x + 4) = make_float4(kf[4], kf[5], kf[6], kf[7]);
        *reinterpret_cast<float4*>(vd + 8 * x) = make_float4(vf[0], vf[1], vf[2], vf[3]);
        *reinterpret_cast<float4*>(vd + 8 * x + 4) = make_float4(vf[4], vf[5], vf[6], vf[7]);
      } else {
        float kf[4], vf[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t kbyte = (kw[x] >> (8 * n)) & 0xffu, vbyte = (vw[x] >> (8 * n)) & 0xffu;
          if constexpr (F == KV::E4M3) {
            kf[n] = e4m3_value(kbyte);
            vf[n] = e4m3_value(vbyte);
          } else {
            kf[n] = (float)(int8_t)kbyte;
            vf[n] = (float)(int8_t)vbyte;
          }
        }
        *reinterpret_cast<float4*>(kd + 4 * x) = make_float4(kf[0], kf[1], kf[2], kf[3]);
        *reinterpret_cast<float4*>(vd + 4 * x) = make_float4(vf[0], vf[1], vf[2], vf[3]);
      }
    }
  }
  for (int j = threadIdx.x; j < P::BN; j += THREADS) {
    const int col = kv0 + j;
    const bool ok = col < valid;
    const size_t r = ok ? (size_t)page_row(col) : 0;
    kss[j] = ok ? __ldg(k_scale + r) : 0.f;
    vss[j] = ok ? __ldg(v_scale + r) : 0.f;
  }
}

__device__ __forceinline__ float* smem_f32() {
  extern __shared__ __align__(16) float af32_smem[];
  return af32_smem;
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
__global__ void __launch_bounds__(THREADS, D > 128 ? 1 : 2)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int* __restrict__ table, const fa90::Args args) {
  static_assert(!PACKED || KIND == fa90::PREFILL, "the packed layout runs the classic softmax");
  constexpr int RM = 64;
  using P = Plan<RM, D>;
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
  auto load = [=](int kv0, float* ksm, float* vsm, float*, float*) {
    load_f32<RM, D>(kb, vb, kv0, sk, dw, ksm, vsm, [rs](int col) { return col * rs; });
  };
  const int* ids = KIND == fa90::IMAGE ? a.ids + (size_t)b * a.sq : nullptr;
  bool zs = KIND == fa90::FLAGGED || KIND == fa90::UNCHECKED;
  if constexpr (KIND == fa90::BOUND) zs = table == nullptr || table[tile] == 0;
  if constexpr (KIND == fa90::PREFILL || KIND == fa90::REPAIR || KIND == fa90::IMAGE) {
    attend<RM, D, false, false, KIND == fa90::IMAGE>(sm, rows, tl, mt, ids, sk, load);
  } else if (!zs) {
    attend<RM, D, false, false, false>(sm, rows, tl, mt, ids, sk, load);
  } else {
    const bool poison = attend<RM, D, true, false, false>(sm, rows, tl, mt, ids, sk, load);
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
  using P = Plan<64, D>;
  if (a.dw <= 0 || a.dw > D || a.dw % 4 != 0) return MFA_BAD_CONFIG;
  auto kern = fwd_kernel<D, KIND, PACKED>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  const dim3 grid(a.hq, batch, (max_sq + 63) / 64);
  kern<<<grid, THREADS, P::bytes, stream>>>(static_cast<const float*>(q),
                                            static_cast<const float*>(k),
                                            static_cast<const float*>(v), static_cast<float*>(o),
                                            lse, table, a);
  return (int)cudaGetLastError();
}

}  // namespace af32
