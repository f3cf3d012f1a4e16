// The fp32 backward tile for Hopper (sm_90a): fp32 q, k, v, O and dO, one
// block body (bwd_kernel below) behind every backward launch of the port
// when its inputs are fp32:
//  - kernel 11 (MODE FUSED, mfa_bwd_fused): a block owns R keys of one kv
//    head and walks the q tiles that see them, for every q head of the
//    group; dK and dV stay in registers, dQ is added into the fp32
//    workspace [b, hq, sq, dw] by 16-byte atomic adds (float4 atomicAdd,
//    done in L2), so it varies in the last bits between runs, as the bf16
//    kernel's does;
//  - kernel 12 (MODE DKV, mfa_bwd_dkv): the same block without its dQ step,
//    deterministic;
//  - kernel 13 (MODE DQ, mfa_bwd_dq): a block owns R q rows of one q head
//    and walks the band's key tiles with dQ in registers, deterministic;
//  - kernel 14 (DKV and DQ on the packed layout, PACKED: mfa_varlen_bwd_dkv
//    and mfa_varlen_bwd_dq): offsets from cu_seqlens, a block whose tile
//    lies past its sequence leaves at once.
// They replace mfa_tpu/kernels/backward.py:_fused_bwd_kernel,
// _dkv_kernel / _dkv_tri_kernel, _dq_kernel / _dq_tri_kernel and
// _vl_dkv_kernel / _vl_dq_kernel on fp32 inputs, which the Pallas kernels
// take with fp32 products. All compute kernels/backward.py:_bwd_plain:
//
//   P  = exp2(S c2 - LSE log2 e)  with S = Q K^T (softcap: cap tanh(S scale / cap))
//   dV = P^T dO     dS = P (dO V^T - delta) scale (* (1 - tanh^2))
//   dK = dS^T Q     dQ = dS K
//
// with delta = rowsum(dO * O) from the caller (fp32), P = 0 on rows whose
// LSE is -inf (they saw no column) and on rows past sq, dK and dV summed
// over the GQA group. The band, sinks (FUSED only: the split refuses them,
// as mfa_tpu does), ALiBi (slopes in the log2 domain, subtracted from P's
// exponent as slope |position - key|), kv_position_offset (dense launches)
// and softcap are fb90::Args', and so is the band arithmetic: a key block
// walks fb90::q_tiles, a q block the key tiles of fa90::span_of.
//
// Bound: operations, 10 hq D flops a visible (row, key) pair for the fused
// launch (8 dK/dV, 6 dQ), at the card's fp32-accurate tensor-core rate:
// 3xTF32, 495 / 3 = 165 TFLOP/s. The design:
//  - Products on tensor cores in 3xTF32. mma.sync m16n8k8 .tf32 with fp32
//    accumulation for all five (S or S^T, dP or dP^T, dV, dK, dQ). Each
//    fp32 operand x is split into hi = rna.tf32(x) and lo = x - hi passed
//    whole (tf32.cuh), and a product is lo.hi + hi.lo + hi.hi, the small
//    terms first, lo.lo dropped. The split
//    is most of the tile's instructions, so it is done once where shared
//    memory allows: up to D 128 a walked tile (Q and dO, or K and V) is
//    split once into hi and lo planes by the whole block after it lands;
//    the block's own tiles, P and dS, and at D 256 the walked tiles too,
//    are split in registers as they are read. The tensor core truncates
//    the sums it accumulates, so every product sums into a fresh
//    accumulator over at most 64 of its terms (products 1-2: a 64-feature
//    chunk; dK, dV, dQ: one walked tile) and that is added to the running
//    sum by FADD, which rounds.
//  - The elementwise step (exp2, softcap's tanh and its derivative, ALiBi,
//    masks, delta) stays fp32 SIMT on the accumulator fragments.
//  - Warps: 8 a block as NR row groups x NC = D / 64 column groups. A
//    warp's accumulators are 16 of the block's R = 16 NR own rows (keys,
//    or q rows for DQ) x 64 features (dK and dV, or dQ): 64 / 32 registers
//    at every D. The pair tile of a walked tile of C = 32 rows is cut the
//    same way (16 rows x C / NC columns a warp); P and dS go through a
//    shared exchange buffer [R][C] so that each warp reads its 16 rows
//    over all C as the A operand of dV += P^T dO, dK += dS^T Q (dQ += dS K).
//    FUSED: dQ of the q tile = dS K over the block's R keys, one 16-row x
//    D / 4 slice a warp, added to the workspace by atomics. At D 128 the
//    two warps of a row group split S and dP by features instead (each
//    its half of D over all C columns), so that each X row is split once
//    a tile, and swap the halves through the exchange buffers.
//  - The mask is skipped where a warp's whole fragment is visible.
//  - Loads: cp.async with zero fill (rows past the sequence, columns past
//    dw) into a 2-slot ring of walked tiles (Q, dO, LSE and delta; or K
//    and V), each slot's completion on an mbarrier that every thread's
//    cp.async.mbarrier.arrive.noinc feeds. Tile t + 2 is issued as soon as
//    tile t's reads are done, so it lands while tile t + 1 is in the
//    products; a warp waits on the barrier of the tile it reads (up to D
//    128: of the tile it splits next, at the end of tile t), never on a
//    block barrier for a load.
//  - Shared memory without bank conflicts: X and Y tiles of D + 8 floats a
//    row. An operand read along the contraction (K-major) takes two
//    adjacent features a lane as a float2 (k slots t, t + 4 <- features
//    2t, 2t + 1, the same pairing for A and B). One read across rows
//    (MN-major: dO, Q, K as B of dV, dK, dQ) takes two adjacent output
//    columns as a float2 that feed two interleaved n-tiles, so a lane ends
//    with four adjacent columns (float4 stores); from split planes it
//    takes one float a value instead, each straight into the register the
//    mma reads (a float2 would cost two moves a value). The exchange buffer has
//    rows of C = 32 floats with column c at c ^ ((r & 3) << 3 | (r & 4)):
//    conflict-free read along rows (dV, dK, and DQ's dQ) and across them
//    (FUSED's dQ), and written from the accumulator fragments as float2.
//  - Sizes (X: the block's K and V, or Q and dO; the ring; the exchange
//    buffers): D 64: R 128, 177 KB (DQ 161 KB); D 128: R 64, 221 KB (DQ
//    221 KB); D 256: R 32, 207 KB (DQ 202 KB); one block an SM, at most
//    255 registers a thread.
//  - Rows are dw features wide (a multiple of 4, <= D): the columns past dw
//    load as zeros, inert in every product, and are never stored.
#pragma once

#include "flash_bwd_sm90.cuh"
#include "tf32.cuh"

namespace bf32 {

using fb90::Args;
using namespace tc32;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int C = 32;  // rows of a walked tile (q rows; keys for DQ)
enum Mode { FUSED = 0, DKV = 1, DQ = 2 };

template <int D, int MODE>
struct Plan {
  static constexpr int NC = D / 64;       // column groups: 64 features a warp
  static constexpr int NR = WARPS / NC;   // row groups of 16
  static constexpr int R = 16 * NR;       // the block's own rows
  static constexpr int NT = C / NC / 8;   // n-tiles of a warp's pair tile
  static constexpr int XS = D + 8;        // X and Y row stride (floats)
  // the walked tiles held as their hi and lo planes (split once a tile)
  // where shared memory allows; at D 256 split as they are read
  static constexpr bool PRESPLIT = D <= 128;
  static constexpr int TILE = (PRESPLIT ? 2 : 1) * C * XS;  // a walked tile's floats
  // exchange buffers: P (or S's halves at D 128) and dS
  static constexpr int NE = MODE == DQ && D != 128 ? 1 : 2;
  static constexpr int x_off = 0;                // X [2][R][XS]
  static constexpr int y_off = 2 * R * XS;       // ring [2 slots][2][planes][C][XS]
  static constexpr int e_off = y_off + 4 * TILE;  // exchange [NE][R][C]
  static constexpr int row_off = e_off + NE * R * C;  // LSE, delta: [2 slots][2][C] or [2][R]
  static constexpr int bar_off = row_off + (MODE == DQ ? 2 * R : 4 * C);  // 2 mbarriers
  static constexpr size_t bytes = (size_t)bar_off * 4 + 16;
  static_assert(D % 64 == 0 && NT >= 1 && C % 32 == 0 && bar_off % 2 == 0, "tile shape");
  static_assert(bytes <= 232448, "a block's shared memory");
};

__device__ __forceinline__ float* smem_f32() {
  extern __shared__ __align__(16) float bf32_smem[];
  return bf32_smem;
}

// -- loads ------------------------------------------------------------------

// Rows [0, NR) of `src` (rows rs floats apart) into a tile of stride D + 8:
// zeros past `valid` rows and past dw columns.
template <int D, int NR>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t rs, int valid,
                                          int dw) {
  constexpr int CH = D / 4, STEP = THREADS / CH;  // 16-byte chunks a row, rows a pass
  static_assert(NR % STEP == 0, "whole passes");
  const int r0 = threadIdx.x / CH, c = (threadIdx.x % CH) * 4;
  const float* s = src + r0 * rs + c;
  float* d = dst + r0 * (D + 8) + c;
#pragma unroll
  for (int i = 0; i < NR / STEP; ++i) {
    const bool ok = c < dw && r0 + i * STEP < valid;
    cp16(d + i * STEP * (D + 8), ok ? s + i * STEP * rs : src, ok);
  }
}

// NR rows' LSE and delta (contiguous), zeros past `valid`.
template <int NR>
__device__ __forceinline__ void load_rows(float* ls, float* ds, const float* lse,
                                          const float* delta, int valid) {
  for (int r = threadIdx.x; r < NR; r += THREADS) {
    const bool ok = r < valid;
    cp4(ls + r, ok ? lse + r : lse, ok);
    cp4(ds + r, ok ? delta + r : delta, ok);
  }
}

// -- 3xTF32 -------------------------------------------------------------------

// d += a b in 3xTF32: lo.hi, hi.lo, then hi.hi.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, l0, l1);
  mma_tf32(d, ah, h0, h1);
}
// The same with b split already: b0, b1's hi and lo parts.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float2 bh, float2 bl) {
  const uint32_t h0 = __float_as_uint(bh.x), h1 = __float_as_uint(bh.y);
  mma_tf32(d, al, h0, h1);
  mma_tf32(d, ah, __float_as_uint(bl.x), __float_as_uint(bl.y));
  mma_tf32(d, ah, h0, h1);
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// A walked slot's two tiles (C rows each, hi planes as loaded) split in
// place: hi stays, lo goes to the plane C rows of stride D + 8 after it.
template <int D>
__device__ __forceinline__ void presplit(float* slot) {
  constexpr int XS = D + 8, CH = D / 4;
  for (int i = threadIdx.x; i < 2 * C * CH; i += THREADS) {
    const int t = i / (C * CH), r = (i / CH) % C, c = (i % CH) * 4;
    float* hi = slot + t * 2 * C * XS + r * XS + c;
    const float4 x = *reinterpret_cast<const float4*>(hi);
    uint32_t h[4], l[4];
    split4(x.x, x.y, x.z, x.w, h, l);
    *reinterpret_cast<float4*>(hi) = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                                 __uint_as_float(h[2]), __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(hi + C * XS) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                    __uint_as_float(l[3]));
  }
}

// Column c of exchange row r (rows of C = 32 floats).
__device__ __forceinline__ int ex_at(int r, int c) {
  return r * C + (c ^ (((r & 3) << 3) | (r & 4)));
}

// -- the products ---------------------------------------------------------

// f[j] = X[r0, r0 + 16)[k0, k0 + 64) . Y[c0 + 8 j, + 8)[k0, k0 + 64)^T, a
// fresh 64-feature chunk of the pair tile's S (S^T) or dP (dP^T); X and Y
// K-major, rows of D + 8 floats; BSPLIT: Y is a hi plane with its lo plane
// C rows after it.
template <int D, int NT, bool BSPLIT>
__device__ __forceinline__ void pair_chunk(float (&f)[NT][4], const float* xs, const float* ys,
                                           int r0, int c0, int k0) {
  constexpr int XS = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* xa = xs + (r0 + g) * XS + 2 * t4 + k0;
  const float* yb = ys + (c0 + g) * XS + 2 * t4 + k0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 64; kk += 8) {
    const float2 x0 = ld2(xa + kk), x1 = ld2(xa + 8 * XS + kk);
    uint32_t ah[4], al[4];
    split4(x0.x, x1.x, x0.y, x1.y, ah, al);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 y = ld2(yb + 8 * j * XS + kk);
      if constexpr (BSPLIT)
        mma3(f[j], ah, al, y, ld2(yb + C * XS + 8 * j * XS + kk));
      else
        mma3(f[j], ah, al, y.x, y.y);
    }
  }
}

// s[j] = X[r0, r0 + 16) . Y[c0 + 8 j, + 8)^T over D: the pair tile's S
// (S^T) or dP (dP^T), its 64-feature chunks added in order.
template <int D, int NT, bool BSPLIT>
__device__ __forceinline__ void pair_products(float (&s)[NT][4], const float* xs, const float* ys,
                                              int r0, int c0) {
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 64) {
    float f[NT][4];
    pair_chunk<D, NT, BSPLIT>(f, xs, ys, r0, c0, k0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = k0 == 0 ? f[j][e] : s[j][e] + f[j][e];
  }
}

// D 128 (two column groups): S and dP of the warp's 16 columns c0 = 16 cg
// with each X row split once a tile, not once a column group. The warp
// takes its feature half [64 cg, + 64) over all C columns, hands the
// partner warp (same rows, other cg) its half of the partner's columns
// through the exchange buffers es_s, es_dp (which the partner overwrites
// with P and dS once read) and adds the partner's half of its own: the
// same two chunk sums as pair_products.
template <int D>
__device__ __forceinline__ void pair_products_halves(float (&s)[2][4], float (&dp)[2][4],
                                                     const float* xs, const float* ys,
                                                     const float* x2s, const float* y2s,
                                                     float* es_s, float* es_dp, int r0, int cg) {
  static_assert(D == 128, "two feature halves of 64");
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float f[4][4], h[4][4];
  pair_chunk<D, 4, true>(f, xs, ys, r0, 0, 64 * cg);
  pair_chunk<D, 4, true>(h, x2s, y2s, r0, 0, 64 * cg);
  // the partner's columns (n-tiles 2 pc + n, pc = 1 - cg) out, by selects on
  // constant indices so that f and h stay in registers
  float fo[2][4], ho[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fo[n][e] = cg ? f[n][e] : f[2 + n][e];
      ho[n][e] = cg ? h[n][e] : h[2 + n][e];
      s[n][e] = cg ? f[2 + n][e] : f[n][e];
      dp[n][e] = cg ? h[2 + n][e] : h[n][e];
    }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int c = 16 * (1 - cg) + 8 * n + 2 * t4;
    *reinterpret_cast<float2*>(es_s + ex_at(r0 + g, c)) = make_float2(fo[n][0], fo[n][1]);
    *reinterpret_cast<float2*>(es_s + ex_at(r0 + g + 8, c)) = make_float2(fo[n][2], fo[n][3]);
    *reinterpret_cast<float2*>(es_dp + ex_at(r0 + g, c)) = make_float2(ho[n][0], ho[n][1]);
    *reinterpret_cast<float2*>(es_dp + ex_at(r0 + g + 8, c)) = make_float2(ho[n][2], ho[n][3]);
  }
  named_sync(1 + r0 / 16, 64);  // the two warps of rows r0
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int c = 16 * cg + 8 * n + 2 * t4;
    const float2 s0 = ld2(es_s + ex_at(r0 + g, c)), s1 = ld2(es_s + ex_at(r0 + g + 8, c));
    const float2 d0 = ld2(es_dp + ex_at(r0 + g, c)), d1 = ld2(es_dp + ex_at(r0 + g + 8, c));
    s[n][0] += s0.x, s[n][1] += s0.y, s[n][2] += s1.x, s[n][3] += s1.y;
    dp[n][0] += d0.x, dp[n][1] += d0.y, dp[n][2] += d1.x, dp[n][3] += d1.y;
  }
}

// S and dP of the warp's pair-tile fragment (rows r0, columns c0): whole
// chunks in the warp (pair_products), or at D 128 feature halves swapped
// with the partner warp through the exchange buffers es_s, es_dp.
template <int D, int NT, bool BSPLIT>
__device__ __forceinline__ void s_dp(float (&s)[NT][4], float (&dp)[NT][4], const float* xs,
                                     const float* ys, const float* x2s, const float* y2s,
                                     float* es_s, float* es_dp, int r0, int cg, int c0) {
  if constexpr (D == 128) {
    static_assert(NT == 2 && BSPLIT, "D 128: two column groups, split planes");
    pair_products_halves<D>(s, dp, xs, ys, x2s, y2s, es_s, es_dp, r0, cg);
  } else {
    pair_products<D, NT, BSPLIT>(s, xs, ys, r0, c0);
    pair_products<D, NT, BSPLIT>(dp, x2s, y2s, r0, c0);
  }
}

// acc += E[r0, r0 + 16)[0, C) . Z[0, C)[cd, cd + 64): dV += P^T dO, dK +=
// dS^T Q, or dQ += dS K. E: an exchange buffer (A, K-major); Z: rows of D
// + 8 floats (B, MN-major). acc[p] holds n-tile pair p: columns cd + 16 p
// + 2 n and + 1 as its two n-tiles, so that a lane's four are adjacent;
// BSPLIT (Z a hi plane, its lo plane C rows after it): n-tiles 2 p and 2 p
// + 1 as they are, each B value loaded into the register it is used in.
template <int D, bool BSPLIT>
__device__ __forceinline__ void tile_products(float (&acc)[4][8], const float* es,
                                              const float* zs, int r0, int cd) {
  constexpr int XS = D + 8, KS = C / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  uint32_t ah[KS][4], al[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int k = 8 * s + t4;
    split4(es[ex_at(r0 + g, k)], es[ex_at(r0 + g + 8, k)], es[ex_at(r0 + g, k + 4)],
           es[ex_at(r0 + g + 8, k + 4)], ah[s], al[s]);
  }
  const float* zb = zs + t4 * XS + cd + 2 * g;
  const float* zn = zs + t4 * XS + cd + g;  // BSPLIT: plain n-tiles
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float f[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      if constexpr (BSPLIT) {  // n-tiles 2 p and 2 p + 1, b0 and b1 loaded where they go
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float* z = zn + 8 * s * XS + 8 * (2 * p + n);
          mma3(f[n], ah[s], al[s], make_float2(z[0], z[4 * XS]),
               make_float2(z[C * XS], z[C * XS + 4 * XS]));
        }
      } else {
        const float2 b0 = ld2(zb + 8 * s * XS + 16 * p), b1 = ld2(zb + (8 * s + 4) * XS + 16 * p);
        mma3(f[0], ah[s], al[s], b0.x, b1.x);
        mma3(f[1], ah[s], al[s], b0.y, b1.y);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[p][e] += f[0][e];
      acc[p][4 + e] += f[1][e];
    }
  }
}

// Store a warp's accumulators (rows r0 + g and + 8 of `out`, rows rs
// floats apart, `valid` of them; n-tile pairs from column cd, laid out as
// tile_products<D, BSPLIT> leaves them) below dw.
template <bool BSPLIT>
__device__ __forceinline__ void store_acc(float* out, size_t rs, const float (&acc)[4][8], int r0,
                                          int cd, int valid, int dw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  if constexpr (BSPLIT) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cd + 8 * j + 2 * t4;
      if (col >= dw) continue;
      const float* f = acc[j / 2] + 4 * (j % 2);
      if (r0 + g < valid)
        *reinterpret_cast<float2*>(out + (size_t)(r0 + g) * rs + col) = make_float2(f[0], f[1]);
      if (r0 + g + 8 < valid)
        *reinterpret_cast<float2*>(out + (size_t)(r0 + g + 8) * rs + col) =
            make_float2(f[2], f[3]);
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int col = cd + 16 * p + 4 * t4;
    if (col >= dw) continue;
    const float(&f)[8] = acc[p];
    if (r0 + g < valid)
      *reinterpret_cast<float4*>(out + (size_t)(r0 + g) * rs + col) =
          make_float4(f[0], f[4], f[1], f[5]);
    if (r0 + g + 8 < valid)
      *reinterpret_cast<float4*>(out + (size_t)(r0 + g + 8) * rs + col) =
          make_float4(f[2], f[6], f[3], f[7]);
  }
}

// P and dS of a pair-tile fragment in place of S and dP (KEYROWS: rows are
// keys kv0 + row and columns q rows q0 + col; else rows are q rows and
// columns keys), the row's log2 LSE from its natural-log `ls`, delta `dl`.
template <bool KEYROWS, bool MASK, int NT>
__device__ __forceinline__ void p_ds(float (&s)[NT][4], float (&dp)[NT][4], const Args& a,
                                     const float* ls, const float* dl, int q0, int kv0, int r0,
                                     int c0, float sl) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e >> 1), col = c0 + 8 * j + 2 * t4 + (e & 1);
      const int qi = KEYROWS ? col : row, key = kv0 + (KEYROWS ? row : col);
      const int pos = q0 + qi + a.kv_off;
      bool ok = true;
      if constexpr (MASK) {
        ok = key < a.sk && q0 + qi < a.sq;
        if (a.wr >= 0) ok = ok && key <= pos + a.wr;
        if (a.wl >= 0) ok = ok && (key >= pos - a.wl || key < a.sinks);
      }
      const float lse = ls[qi];
      float x = s[j][e], dcap = 1.f;
      if (a.softcap > 0.f) {
        const float t = tanhf(x * a.softcap_mul);
        x = t * a.softcap;
        dcap = 1.f - t * t;
      }
      float ex = x * a.c2 - (lse == -INFINITY ? INFINITY : lse * fb90::LOG2E);
      if (sl != 0.f) ex -= sl * fabsf((float)(pos - key));
      const float pr = ok ? exp2f(ex) : 0.f;
      s[j][e] = pr;
      dp[j][e] = pr * (dp[j][e] - dl[qi]) * a.scale * dcap;
    }
}

// P and dS of the warp's fragment (p_ds), masked unless every one of its
// pairs is visible: q rows [qa, qa + nq) and keys [ka, ka + nk) inside the
// sequences and the band.
template <bool KEYROWS, int NT>
__device__ __forceinline__ void p_ds_tile(float (&s)[NT][4], float (&dp)[NT][4], const Args& a,
                                          const float* ls, const float* dl, int q0, int kv0,
                                          int r0, int c0, float sl) {
  constexpr int NQ = KEYROWS ? 8 * NT : 16, NK = KEYROWS ? 16 : 8 * NT;
  const int qa = q0 + (KEYROWS ? c0 : r0), ka = kv0 + (KEYROWS ? r0 : c0);
  const int pa = qa + a.kv_off;  // the first row's position
  const bool whole = ka + NK <= a.sk && qa + NQ <= a.sq &&
                     (a.wr < 0 || ka + NK - 1 <= pa + a.wr) &&
                     (a.wl < 0 || ka >= pa + NQ - 1 - a.wl);
  if (whole)
    p_ds<KEYROWS, false, NT>(s, dp, a, ls, dl, q0, kv0, r0, c0, sl);
  else
    p_ds<KEYROWS, true, NT>(s, dp, a, ls, dl, q0, kv0, r0, c0, sl);
}

// A pair-tile fragment into an exchange buffer, rows r0 + g (+ 8), columns
// c0 + 8 j + 2 t4 (+ 1).
template <int NT>
__device__ __forceinline__ void put_tile(float* es, const float (&x)[NT][4], int r0, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = c0 + 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(es + ex_at(r0 + g, c)) = make_float2(x[j][0], x[j][1]);
    *reinterpret_cast<float2*>(es + ex_at(r0 + g + 8, c)) = make_float2(x[j][2], x[j][3]);
  }
}

// FUSED: the q tile's dQ = dS K over the block's R keys (dS^T in `es`, K in
// `ks`), warp w's rows 16 (w % 2) + g (+ 8) and D / 4 columns from D / 4
// (w / 2), added into the workspace rows `ws` (dw floats apart, `valid`).
template <int D, int R>
__device__ __forceinline__ void dq_step(float* ws, const float* es, const float* ks, int valid,
                                        int dw) {
  constexpr int XS = D + 8, NP = D / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int m0 = 16 * (warp & 1), cd = (D / 4) * (warp >> 1);
  float acc[NP][2][4];  // n-tile pair p: columns cd + 16 p + 2 n and + 1
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[p][0][e] = acc[p][1][e] = 0.f;
  const float* kb = ks + t4 * XS + cd + 2 * g;
#pragma unroll 4
  for (int kk = 0; kk < R; kk += 8) {
    uint32_t ah[4], al[4];
    split4(es[ex_at(kk + t4, m0 + g)], es[ex_at(kk + t4, m0 + g + 8)],
           es[ex_at(kk + t4 + 4, m0 + g)], es[ex_at(kk + t4 + 4, m0 + g + 8)], ah, al);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float2 b0 = ld2(kb + kk * XS + 16 * p), b1 = ld2(kb + (kk + 4) * XS + 16 * p);
      mma3(acc[p][0], ah, al, b0.x, b1.x);
      mma3(acc[p][1], ah, al, b0.y, b1.y);
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int col = cd + 16 * p + 4 * t4;
    if (col >= dw) continue;
    const float(&f)[4] = acc[p][0];
    const float(&h)[4] = acc[p][1];
    if (m0 + g < valid)
      atomicAdd(reinterpret_cast<float4*>(ws + (size_t)(m0 + g) * dw + col),
                make_float4(f[0], h[0], f[1], h[1]));
    if (m0 + g + 8 < valid)
      atomicAdd(reinterpret_cast<float4*>(ws + (size_t)(m0 + g + 8) * dw + col),
                make_float4(f[2], h[2], f[3], h[3]));
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][8]) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[p][e] = 0.f;
}

// FUSED / DKV: grid (hkv, batch, ceil(sk / R)), packed (hkv, sequence,
// ceil(max_sk / R)); the key tile is the slowest axis, so the causal
// blocks with the most q tiles launch first. DQ: grid (hq, batch, ceil(sq
// / R)), packed ceil(max_sq / R), the q tile reversed (the causal blocks
// with the most key tiles first). dq: the zeroed fp32 workspace (FUSED) or
// the dQ output (DQ); dk, dv: the outputs (FUSED, DKV). Layouts as
// flash_bwd_sm90.cuh's, fp32, rows of dw features.
template <int D, int MODE, bool PACKED>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
               const Args args) {
  static_assert(!(MODE == FUSED && PACKED), "the packed layout runs the split");
  using P = Plan<D, MODE>;
  constexpr int R = P::R, NT = P::NT, XS = P::XS, NC = P::NC, TILE = P::TILE;
  constexpr bool SPLIT = P::PRESPLIT;
  float* sm = smem_f32();
  float* xs = sm + P::x_off;
  float* ys = sm + P::y_off;
  float* es = sm + P::e_off;
  float* rows = sm + P::row_off;
  const uint32_t bars = smem_u32(sm + P::bar_off);
  const int warp = threadIdx.x >> 5;
  const int r0 = 16 * (warp / NC), cg = warp % NC;
  const int c0 = cg * (C / NC), cd = 64 * cg;  // the warp's pair-tile columns, features
  const int b = blockIdx.y;
  Args a = args;
  const int dw = a.dw, group = a.hq / a.hkv;
  // the q and k rows' strides in floats, and the sequence's first rows
  const size_t q_rs = PACKED ? (size_t)a.hq * dw : (size_t)dw;
  const size_t k_rs = PACKED ? (size_t)a.hkv * dw : (size_t)dw;
  int q_row0 = 0, k_row0 = 0;
  // walked tile it: its slot (two tiles of TILE floats), its barrier
  auto slot_of = [&](int it) { return ys + (it & 1) * 2 * TILE; };
  auto wait_tile = [&](int it) { mbar_wait(bars + 8 * (it & 1), (it >> 1) & 1); };
  // tile it + 1 landed and split (SPLIT), before the barrier that ends tile it
  auto next_ready = [&](int it, int n) {
    if constexpr (SPLIT) {
      if (it + 1 < n) {
        wait_tile(it + 1);
        presplit<D>(slot_of(it + 1));
      }
    }
  };

  if constexpr (MODE == DQ) {
    const int h = blockIdx.x, q0 = (gridDim.z - 1 - blockIdx.z) * R;
    if constexpr (PACKED) {
      q_row0 = a.cu_q[b];
      a.sq = a.cu_q[b + 1] - q_row0;
      if (q0 >= a.sq) return;  // tile past this sequence
      k_row0 = a.cu_k[b];
      a.sk = a.cu_k[b + 1] - k_row0;
    }
    const int hk = h / group;
    const size_t qh = PACKED ? ((size_t)q_row0 + q0) * a.hq + h : (size_t)(b * a.hq + h) * a.sq + q0;
    const size_t rh = PACKED ? (size_t)h * a.total_q + q_row0 + q0 : qh;  // LSE, delta
    const float* kbase = k + (PACKED ? (size_t)k_row0 * a.hkv + hk : (size_t)(b * a.hkv + hk) * a.sk) * dw;
    const float* vbase = v + (kbase - k);
    const int valid = min(R, a.sq - q0);
    const int p0 = q0 + a.kv_off;
    const fa90::Span sp = fa90::span_of(p0, p0 + valid - 1, a.sk, a.wl, a.wr, C);
    const int n = sp.last - sp.first + 1;
    float acc[4][8];
    zero_acc(acc);
    if (n > 0) {
      const float sl = a.slopes != nullptr ? a.slopes[h] : 0.f;
      if (threadIdx.x == 0) {
        mbar_init(bars, THREADS);
        mbar_init(bars + 8, THREADS);
      }
      __syncthreads();
      auto fill = [&](int it) {  // key tile sp.first + it (K, then V) into its slot
        const int kv0 = (sp.first + it) * C;
        float* slot = slot_of(it);
        load_tile<D, C>(slot, kbase + kv0 * k_rs, k_rs, a.sk - kv0, dw);
        load_tile<D, C>(slot + TILE, vbase + kv0 * k_rs, k_rs, a.sk - kv0, dw);
        cp_arrive(bars + 8 * (it & 1));
      };
      load_tile<D, R>(xs, q + qh * dw, q_rs, valid, dw);
      load_tile<D, R>(xs + R * XS, dO + qh * dw, q_rs, valid, dw);
      load_rows<R>(rows, rows + R, lse + rh, delta + rh, valid);
      fill(0);
      if (n > 1) fill(1);
      if constexpr (SPLIT) {
        wait_tile(0);
        presplit<D>(slot_of(0));
        __syncthreads();
      }
      for (int it = 0; it < n; ++it) {
        const int kv0 = (sp.first + it) * C;
        const float* kt = slot_of(it);
        if constexpr (!SPLIT) wait_tile(it);
        float st[NT][4], dpt[NT][4];  // S = Q K^T, dP = dO V^T
        s_dp<D, NT, SPLIT>(st, dpt, xs, kt, xs + R * XS, kt + TILE, es + R * C, es, r0, cg, c0);
        p_ds_tile<false, NT>(st, dpt, a, rows, rows + R, q0, kv0, r0, c0, sl);
        put_tile<NT>(es, dpt, r0, c0);
        __syncthreads();  // dS is whole
        tile_products<D, SPLIT>(acc, es, kt, r0, cd);  // dQ += dS K
        next_ready(it, n);
        __syncthreads();  // every read of the slot and of dS is done
        if (it + 2 < n) fill(it + 2);
      }
    }
    store_acc<SPLIT>(dq + qh * dw, q_rs, acc, r0, cd, valid, dw);
  } else {
    const int hk = blockIdx.x, kv0 = blockIdx.z * R;
    if constexpr (PACKED) {
      k_row0 = a.cu_k[b];
      a.sk = a.cu_k[b + 1] - k_row0;
      if (kv0 >= a.sk) return;  // tile past this sequence
      q_row0 = a.cu_q[b];
      a.sq = a.cu_q[b + 1] - q_row0;
    }
    const size_t kh = PACKED ? ((size_t)k_row0 + kv0) * a.hkv + hk
                             : (size_t)(b * a.hkv + hk) * a.sk + kv0;
    const int kvalid = min(R, a.sk - kv0);
    const fb90::QTiles qt = fb90::q_tiles(kv0, R, C, a);
    const int per_head = max(0, qt.last - qt.first + 1);
    const int n = group * per_head;
    float dka[4][8], dva[4][8];
    zero_acc(dka);
    zero_acc(dva);
    if (n > 0) {
      if (threadIdx.x == 0) {
        mbar_init(bars, THREADS);
        mbar_init(bars + 8, THREADS);
      }
      __syncthreads();
      // q tile it % per_head of head it / per_head (Q, then dO) into its slot
      auto fill = [&](int it) {
        const int h = hk * group + it / per_head, q0 = (qt.first + it % per_head) * C;
        const size_t qh = PACKED ? ((size_t)q_row0 + q0) * a.hq + h
                                 : (size_t)(b * a.hq + h) * a.sq + q0;
        const size_t rh = PACKED ? (size_t)h * a.total_q + q_row0 + q0 : qh;
        const int valid = min(C, a.sq - q0);
        float* slot = slot_of(it);
        float* rs = rows + (it & 1) * 2 * C;
        load_tile<D, C>(slot, q + qh * dw, q_rs, valid, dw);
        load_tile<D, C>(slot + TILE, dO + qh * dw, q_rs, valid, dw);
        load_rows<C>(rs, rs + C, lse + rh, delta + rh, valid);
        cp_arrive(bars + 8 * (it & 1));
      };
      load_tile<D, R>(xs, k + kh * dw, k_rs, kvalid, dw);
      load_tile<D, R>(xs + R * XS, v + kh * dw, k_rs, kvalid, dw);
      fill(0);
      if (n > 1) fill(1);
      if constexpr (SPLIT) {
        wait_tile(0);
        presplit<D>(slot_of(0));
        __syncthreads();
      }
      for (int it = 0; it < n; ++it) {
        const int h = hk * group + it / per_head, q0 = (qt.first + it % per_head) * C;
        const float sl = a.slopes != nullptr ? a.slopes[h] : 0.f;
        const float* qs = slot_of(it);
        const float* dos = qs + TILE;
        const float* rs = rows + (it & 1) * 2 * C;
        if constexpr (!SPLIT) wait_tile(it);
        float st[NT][4], dpt[NT][4];  // S^T = K Q^T, dP^T = V dO^T
        s_dp<D, NT, SPLIT>(st, dpt, xs, qs, xs + R * XS, dos, es, es + R * C, r0, cg, c0);
        p_ds_tile<true, NT>(st, dpt, a, rs, rs + C, q0, kv0, r0, c0, sl);
        put_tile<NT>(es, st, r0, c0);
        put_tile<NT>(es + R * C, dpt, r0, c0);
        __syncthreads();  // P^T and dS^T are whole
        tile_products<D, SPLIT>(dva, es, dos, r0, cd);         // dV += P^T dO
        tile_products<D, SPLIT>(dka, es + R * C, qs, r0, cd);  // dK += dS^T Q
        if constexpr (MODE == FUSED) {
          // the workspace is [b, hq, sq, dw]: row q0 + r of head h
          dq_step<D, R>(dq + ((size_t)(b * a.hq + h) * a.sq + q0) * dw, es + R * C, xs,
                        min(C, a.sq - q0), dw);
        }
        next_ready(it, n);
        __syncthreads();  // every read of the slot and of P^T, dS^T is done
        if (it + 2 < n) fill(it + 2);
      }
    }
    // dK and dV of the block's keys (zeros for keys no row sees)
    store_acc<SPLIT>(dk + kh * dw, k_rs, dka, r0, cd, kvalid, dw);
    store_acc<SPLIT>(dv + kh * dw, k_rs, dva, r0, cd, kvalid, dw);
  }
}

// Launch MODE at D on fp32 tensors. rows: sk (FUSED, DKV) or sq (DQ), or
// the packed layout's max_sk / max_sq, the grid's tile axis. Returns a
// cudaError_t code or MFA_BAD_CONFIG.
template <int D, int MODE, bool PACKED>
int launch(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           const float* delta, float* dq, void* dk, void* dv, int batch, int rows,
           const Args& a, cudaStream_t stream) {
  using P = Plan<D, MODE>;
  if (a.dw <= 0 || a.dw > D || a.dw % 4 != 0) return MFA_BAD_CONFIG;
  auto kern = bwd_kernel<D, MODE, PACKED>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  const dim3 grid(MODE == DQ ? a.hq : a.hkv, batch, (rows + P::R - 1) / P::R);
  kern<<<grid, THREADS, P::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dO), lse, delta, dq, static_cast<float*>(dk),
      static_cast<float*>(dv), a);
  return (int)cudaGetLastError();
}

}  // namespace bf32
