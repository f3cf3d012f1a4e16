// Single-query decode for Hopper (sm_90a): one tile for two sources.
//  - Kernel 5's launch 1 (decode.cu): a contiguous [b, hkv, S, D] cache;
//    replaces mfa_tpu/kernels/decode.py:_decode_kernel.
//  - Kernel 6 (paged.cu): a page pool [hkv, P, page, D] read in place
//    through the block table, bf16/fp16 pages or int8 pages with fp32 row
//    scales [hkv, P, page]; replaces mfa_tpu/kernels/paged.py:
//    _paged_kernel_body for q_span == 1.
// One block owns one (batch, kv head, split): the group's <= 8 q rows
// against rows [lo, hi) of one sequence. With one split and `out` set it
// stores the final O in the q dtype and the natural-log LSE; otherwise each
// split's normalized fp32 O and LSE for the combine (decode.cu, launch 2).
//
// Bound: device-memory bytes, K and V read once (a decode row does 4 D
// operations per 4 D cache bytes, far below the ~295 operations a byte
// where the tensor cores would be the limit). The design keeps the memory
// busy and takes the arithmetic off the CUDA cores:
//  - One producer thread TMA-loads 64-token K and V tiles into a ring of
//    STAGES slots (about 190 KB) with full/empty mbarriers. A contiguous
//    cache is one box a tile of a 3-D map over (D, S, b * hkv); the maps
//    clip at S with zeros. Pages come one box per page (box_rows =
//    gcd(page, 64) rows, so a larger page is cut into 64-row boxes) of a
//    map over (D, page, hkv * P), the pool page read from the block table
//    (clamped into the pool, as the plain version clamps it) by the whole
//    producer warp, 32 table entries a load; int8 pages bring their row
//    scales beside them by bulk copies. No box is issued for rows outside
//    [lo, hi): table entries there may be garbage or -1.
//  - Eight consumer warps in two teams (one team at D 256): team t takes
//    tiles t, t + 2, ..., and warp w of a team the tile's tokens [16 w,
//    16 w + 16). Each warp is its own split of the split: its online
//    softmax (m, l) and O live in registers, no barrier joins the warps
//    while the ring runs, and one shared-memory merge ends the block.
//  - S = Q K^T and O += P V run on mma.sync m16n8k16 (the group's rows
//    padded to 16); P stays in registers as the A fragment of P V.
//    16-bit tiles come in the 128-byte swizzle, K's B fragments by ldmatrix
//    and V's by ldmatrix.trans. There is no int8 x bf16 product, so int8
//    rows are converted exactly to bf16 in registers: the TMA swizzles a
//    row by its width (64 B at D 64, 128 B chunks above), K is read as
//    16-byte units whose four-byte words become B fragments of a permuted
//    contraction (Q's A fragments are permuted to match, so S is
//    unchanged), and V as 4 tokens x 4 bytes a thread, transposed with
//    byte permutes into four B fragments whose output columns are permuted
//    (undone in the merge). K scales multiply the score columns; V scales
//    fold into p after the row sum, before p is rounded for P V.
//  - Only a warp's 16 tokens that cross lo or hi are masked: their scores
//    become MASK, their p exactly 0, their 16-bit V fragments zero and
//    their scaled p zero (a row or scale past the length may hold
//    anything, and 0 * NaN would survive).
//
// Semantics of the plain versions (kernels/decode.py, kernels/paged.py),
// kept exactly: scores scaled into the log2 domain before the max (softcap
// first), probabilities rounded to V's dtype (bf16 for int8 pages) before
// P V while l sums them unrounded, a row with no visible column stores O =
// 0 and LSE = -inf, and split ranges are whole 64-token tiles.
#pragma once

#include "wgmma.cuh"

namespace kd90 {

constexpr int TILE = 64;  // tokens a tile (kernels/decode.py:TILE)

struct Args {
  const void* q;       // [b, hq, D]
  const int* lens;     // [b] stored lengths
  float* o_part;       // [b, hkv, splits, group, D] fp32
  float* lse_part;     // [b, hkv, splits, group]
  int hq, hkv, group, S, tokens_per_split, num_splits, window_left;
  float scale_log2e, softcap, softcap_mul;
  // the paged source (zero for the contiguous cache): S = pps * page
  const int* table;      // [b, pps] pool pages
  const float* k_scale;  // int8 pages: [hkv, P, page] fp32
  const float* v_scale;
  void* out;             // one split: O [b, hq, D] in T (else null)
  float* lse_out;        // and its LSE [b, hq]
  int num_pages, page_size, pps, box_rows, pos_offset;
};

// Shared memory: STAGES slots of [K tile | V tile (| K scales | V scales)],
// then the barriers (full[STAGES], empty[STAGES]). A 16-bit tile is [D / 64
// chunks][64 tokens][64] with the 128-byte swizzle, an int8 tile [D / CB
// chunks][64 tokens][CB bytes] with the CB-byte swizzle. The final merge
// reuses the ring: per consumer warp m[8], l[8] and O[8][D] fp32. At D 256
// one team of four consumer warps: a thread's O alone takes 128 registers,
// and nine warps could hold no more than 168 a thread (three warps share a
// quarter of the register file).
template <int D, bool QUANT>
struct Plan {
  static constexpr int TEAMS = D > 128 ? 1 : 2;  // tiles the consumer warps work on at once
  static constexpr int CWARPS = 4 * TEAMS;       // consumer warps, 16 tokens of a tile each
  static constexpr int THREADS = 32 * (1 + CWARPS);
  static constexpr int CB = QUANT && D < 128 ? D : 128;  // bytes of a chunk row
  static constexpr uint32_t CHUNK = TILE * CB;           // bytes of a chunk
  static constexpr uint32_t KV_BYTES = TILE * D * (QUANT ? 1 : 2);  // one K or V tile
  static constexpr uint32_t sc_off = 2 * KV_BYTES;                  // int8: K, V scales
  static constexpr uint32_t STAGE_BYTES =  // a slot, 1024-byte aligned for the swizzle
      (sc_off + (QUANT ? 2 * TILE * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int FIT = (192 * 1024) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 16 ? FIT : 16;
  static constexpr uint32_t bar_off = STAGES * STAGE_BYTES;
  static constexpr size_t bytes = bar_off + 16 * STAGES + 1024;  // + 1 KB to align the base
  static constexpr uint32_t ml_off = CWARPS * 8 * D * 4;         // after the O rows
  static_assert(ml_off + CWARPS * 16 * 4 <= bar_off, "the merge must fit in the ring");
};

__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) { return bars + 8 * s; }
template <int STAGES>
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (STAGES + s);
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a2,
                                         const uint32_t* b);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], uint32_t a0,
                                                        uint32_t a2, const uint32_t* b) {
  // rows 8-15 of A are padding: zero registers
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%6,%5,%6}, {%7,%8}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a2), "r"(0u), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], uint32_t a0, uint32_t a2,
                                                 const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%6,%5,%6}, {%7,%8}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a2), "r"(0u), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Shared address of 16-bit element (row, col) of a [D / 64][64][64] tile in
// the 128-byte swizzle (col a multiple of 8: one 16-byte unit).
__device__ __forceinline__ uint32_t swz(uint32_t tile, int row, int col) {
  return tile + (col >> 6) * (TILE * 128) + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4);
}

// Byte offset of 16-byte unit `unit` of row `row` inside an int8 chunk of
// CB-byte rows, as the TMA's CB-byte swizzle stores it (address bits 4-6
// XOR bits 7-9 for 128 B, bits 4-5 XOR bits 7-8 for 64 B; chunks are
// 1024-byte aligned).
template <int CB>
__device__ __forceinline__ int swz8(int row, int unit) {
  return CB == 128 ? row * 128 + ((unit ^ (row & 7)) << 4)
                   : row * 64 + ((unit ^ ((row >> 1) & 3)) << 4);
}

// Four words of four bytes (rows r0..r3) -> four words, word i holding byte
// i of each row in row order.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// Output column of accumulator column n (0-7) of n-tile j in the int8 P V:
// thread g of a warp reads bytes [c CB + (CB / 8) g, + CB / 8) of V's rows,
// and n-tile j = 4 (c CB / 32 + w) + i is byte 4 w + i of them.
template <int CB>
__device__ __forceinline__ int quant_col(int j, int n) {
  const int cw = j >> 2, c = cw / (CB / 32), w = cw % (CB / 32);
  return c * CB + (CB / 8) * n + 4 * w + (j & 3);
}

// Where the merge keeps column x of row r (r % 8 = the row's g) of a warp's
// O, so that the lanes' stores of one accumulator spread over the banks
// (rows are D floats apart: unswizzled, the 8 rows' stores share banks).
// 16-bit: bits 3-5 XOR g (column pairs stay together for 8-byte stores);
// int8: bits 0-4 XOR (g, and the t4 whose accumulator holds the column:
// unswizzled, all 32 lanes hit one bank).
template <int CB, bool QUANT>
__device__ __forceinline__ int merge_col(int r, int x) {
  return QUANT ? x ^ (((r & 7) << 2) | ((x % CB) / (CB / 4))) : x ^ ((r & 7) << 3);
}

// Grid (splits, hkv, batch). PAGED: the source is a page pool through the
// block table; QUANT: int8 pages with fp32 row scales (T is then bf16).
template <typename T, int D, bool PAGED, bool QUANT>
__global__ void __launch_bounds__(Plan<D, QUANT>::THREADS, 1)
    splitkv_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const Args a) {
  using P = Plan<D, QUANT>;
  constexpr int STAGES = P::STAGES, TEAMS = P::TEAMS, CWARPS = P::CWARPS, CB = P::CB;
  static_assert(PAGED || !QUANT, "int8 rows come only as pages");
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.group;
  const int length = a.lens[b];
  const int start = a.window_left >= 0 ? max(0, length + a.pos_offset - 1 - a.window_left) : 0;
  const int lo = max(start, split * a.tokens_per_split);
  const int hi = min(min(length, a.S), (split + 1) * a.tokens_per_split);
  const int first = lo / TILE;
  const int n_tiles = lo < hi ? (hi + TILE - 1) / TILE - first : 0;

  extern __shared__ __align__(16) unsigned char kd_smem[];
  unsigned char* smem = kd_smem + ((1024u - (smem_u32(kd_smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + P::bar_off;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(bars, s), 1);
      mbar_init(bar_empty<STAGES>(bars, s), 4);  // lane 0 of each warp of the tile's team
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    if constexpr (!PAGED) {
      if (lane == 0) {
        for (int i = 0; i < n_tiles; ++i) {
          const int s = i % STAGES;
          mbar_wait(bar_empty<STAGES>(bars, s), ((i / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full(bars, s), 2 * P::KV_BYTES);
          const uint32_t k_s = base + s * P::STAGE_BYTES, v_s = k_s + P::KV_BYTES;
          const int row = (first + i) * TILE, plane = b * a.hkv + hk;
#pragma unroll
          for (int ch = 0; ch < D / 64; ++ch) {
            tma_load_3d(k_s + ch * (TILE * 128), &tk, bar_full(bars, s), ch * 64, row, plane);
            tma_load_3d(v_s + ch * (TILE * 128), &tv, bar_full(bars, s), ch * 64, row, plane);
          }
        }
      }
    } else {
      // Lane l holds the pool page of table entry id0 + l; the warp reloads
      // the next 32 entries when a box's page passes them.
      const int* tbl = a.table + (size_t)b * a.pps;
      const int R = a.box_rows, page = a.page_size, last_pi = (hi - 1) / page;
      const uint32_t box_bytes = QUANT ? 2 * R * (D + 4) : 2 * R * D * 2;
      int ids = 0, id0 = -32;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, t0 = (first + i) * TILE;
        const int jb0 = max(0, lo - t0) / R, jb1 = (min(TILE, hi - t0) + R - 1) / R;
        const uint32_t k_s = base + s * P::STAGE_BYTES, v_s = k_s + P::KV_BYTES;
        if (lane == 0) {
          mbar_wait(bar_empty<STAGES>(bars, s), ((i / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full(bars, s), (jb1 - jb0) * box_bytes);
        }
        for (int jb = jb0; jb < jb1; ++jb) {
          const int key = t0 + jb * R, pi = key / page, row = key % page;
          if (pi >= id0 + 32) {  // warp-uniform
            id0 = pi;
            ids = id0 + lane <= last_pi ? tbl[id0 + lane] : 0;
          }
          const int pg = min(max(__shfl_sync(0xffffffffu, ids, pi - id0), 0), a.num_pages - 1);
          if (lane == 0) {
            const int plane = hk * a.num_pages + pg;
            if constexpr (QUANT) {
#pragma unroll
              for (int c = 0; c < D / CB; ++c) {
                const uint32_t at = c * P::CHUNK + jb * R * CB;
                tma_load_3d(k_s + at, &tk, bar_full(bars, s), c * CB, row, plane);
                tma_load_3d(v_s + at, &tv, bar_full(bars, s), c * CB, row, plane);
              }
              const size_t srow = (size_t)plane * page + row;
              const uint32_t sc = k_s + P::sc_off + jb * R * 4;
              bulk_load(sc, a.k_scale + srow, R * 4, bar_full(bars, s));
              bulk_load(sc + TILE * 4, a.v_scale + srow, R * 4, bar_full(bars, s));
            } else {
#pragma unroll
              for (int ch = 0; ch < D / 64; ++ch) {
                const uint32_t at = ch * (TILE * 128) + jb * R * 128;
                tma_load_3d(k_s + at, &tk, bar_full(bars, s), ch * 64, row, plane);
                tma_load_3d(v_s + at, &tv, bar_full(bars, s), ch * 64, row, plane);
              }
            }
          }
        }
      }
    }
    return;
  }

  const int cw = warp - 1, team = cw >> 2, quarter = cw & 3;
  const int g = lane >> 2, t4 = lane & 3;
  // Q rows of the group as A fragments (row g; rows >= G and 8-15 zero).
  // 16-bit: step kk holds columns 16 kk + 2 t4 (+1) and 16 kk + 8 + 2 t4
  // (+1). int8: step kk = c CB / 16 + w holds columns c CB + (CB / 4) t4 +
  // 4 w + 0..1 and + 2..3, the four bytes of K this thread reads there.
  uint32_t qa[D / 16][2];
  {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        static_cast<const T*>(a.q) + ((size_t)b * a.hq + (size_t)hk * G + min(g, G - 1)) * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = QUANT ? (kk / (CB / 16)) * CB + (CB / 4) * t4 + 4 * (kk % (CB / 16))
                            : 16 * kk + 2 * t4;
      qa[kk][0] = g < G ? qr[col / 2] : 0u;
      qa[kk][1] = g < G ? qr[col / 2 + (QUANT ? 1 : 4)] : 0u;
    }
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m = MFA_MASK, l = 0.f;  // row g's running max (log2 domain) and this thread's sum
  const int lr = lane & 7, mi = lane >> 3;

  for (int i = team; i < n_tiles; i += TEAMS) {
    const int s = i % STAGES;
    mbar_wait(bar_full(bars, s), (i / STAGES) & 1);
    const int tok0 = (first + i) * TILE + 16 * quarter;  // this warp's first token
    if (tok0 < hi && tok0 + 16 > lo) {
      const bool edge = tok0 < lo || tok0 + 16 > hi;
      const uint32_t k_s = base + s * P::STAGE_BYTES, v_s = k_s + P::KV_BYTES;
      const unsigned char* slot = smem + s * P::STAGE_BYTES;
      const int row0 = 16 * quarter;  // this warp's rows of the tile

      // S = Q K^T over the warp's 16 tokens: two 8-token n-tiles
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if constexpr (QUANT) {
        // every load of the tile's K units first, then the conversions
        uint4 kw[2][D / CB][CB / 64];
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
          for (int c = 0; c < D / CB; ++c) {
#pragma unroll
            for (int x = 0; x < CB / 64; ++x) {
              kw[jn][c][x] = *reinterpret_cast<const uint4*>(
                  slot + c * P::CHUNK + swz8<CB>(row0 + 8 * jn + g, (CB / 64) * t4 + x));
            }
          }
        }
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
          for (int c = 0; c < D / CB; ++c) {
#pragma unroll
            for (int x = 0; x < CB / 64; ++x) {
              const uint32_t wd[4] = {kw[jn][c][x].x, kw[jn][c][x].y, kw[jn][c][x].z,
                                      kw[jn][c][x].w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int kk = c * (CB / 16) + 4 * x + e;
                uint32_t kb[2];
                i8x4_to_bf16(wd[e], kb[0], kb[1]);
                mma16816<T>(sc[jn], qa[kk][0], qa[kk][1], kb);
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t kb[4];
          ldsm_x4(kb, swz(k_s, row0 + (mi >> 1) * 8 + lr, 16 * kk + (mi & 1) * 8));
          mma16816<T>(sc[0], qa[kk][0], qa[kk][1], kb);
          mma16816<T>(sc[1], qa[kk][0], qa[kk][1], kb + 2);
        }
      }
      // row g's scores (c0, c1 of each n-tile): token tok0 + 8 j + 2 t4 + e
      const float* scl = reinterpret_cast<const float*>(slot + P::sc_off);
      float ks[4] = {1.f, 1.f, 1.f, 1.f}, vs[4] = {1.f, 1.f, 1.f, 1.f};
      if constexpr (QUANT) {
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const float2 k2 = *reinterpret_cast<const float2*>(scl + row0 + 8 * jn + 2 * t4);
          const float2 v2 = *reinterpret_cast<const float2*>(scl + TILE + row0 + 8 * jn + 2 * t4);
          ks[2 * jn] = k2.x;
          ks[2 * jn + 1] = k2.y;
          vs[2 * jn] = v2.x;
          vs[2 * jn + 1] = v2.y;
        }
      }
      float v[4];
      float mx = MFA_MASK;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float y = sc[x >> 1][x & 1];
        if constexpr (QUANT) y *= ks[x];
        if (a.softcap > 0.f) y = tanhf(y * a.softcap_mul) * a.softcap;
        y *= a.scale_log2e;
        if (edge) {
          const int tok = tok0 + 8 * (x >> 1) + 2 * t4 + (x & 1);
          if (tok < lo || tok >= hi) y = MFA_MASK;
        }
        v[x] = y;
        mx = fmaxf(mx, y);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2f(m - m_new);
      float ps = 0.f;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        v[x] = (edge && v[x] == MFA_MASK) ? 0.f : exp2f(v[x] - m_new);
        ps += v[x];
      }
      m = m_new;
      l = alpha * l + ps;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= alpha;
        acc[j][1] *= alpha;
      }
      if constexpr (QUANT) {  // V scales fold into p; a masked p stays exactly 0
#pragma unroll
        for (int x = 0; x < 4; ++x) v[x] = v[x] == 0.f ? 0.f : v[x] * vs[x];
      }
      // P rounded to V's dtype: the A fragment of P V (rows 8-15 zero)
      const uint32_t pa0 = pack2<T>(v[0], v[1]), pa2 = pack2<T>(v[2], v[3]);
      if constexpr (QUANT) {
        // rows 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 of the warp's 16: the
        // k-slots of this thread's B fragments
#pragma unroll
        for (int c = 0; c < D / CB; ++c) {
          uint32_t rw[4][CB / 32];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = row0 + 2 * t4 + (r & 1) + 8 * (r >> 1);
            const unsigned char* vr = slot + P::KV_BYTES + c * P::CHUNK;
            if constexpr (CB == 128) {
              const uint4 u = *reinterpret_cast<const uint4*>(vr + swz8<CB>(row, g));
              rw[r][0] = u.x;
              rw[r][1] = u.y;
              rw[r][2] = u.z;
              rw[r][3] = u.w;
            } else {
              const uint2 u =
                  *reinterpret_cast<const uint2*>(vr + swz8<CB>(row, g >> 1) + (g & 1) * 8);
              rw[r][0] = u.x;
              rw[r][1] = u.y;
            }
          }
#pragma unroll
          for (int w = 0; w < CB / 32; ++w) {
            const uint32_t col4[4] = {rw[0][w], rw[1][w], rw[2][w], rw[3][w]};
            uint32_t tr[4];
            transpose4x4(col4, tr);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              uint32_t vb[2];
              i8x4_to_bf16(tr[e], vb[0], vb[1]);
              mma16816<T>(acc[4 * (c * (CB / 32) + w) + e], pa0, pa2, vb);
            }
          }
        }
      } else {
        // V fragments of tokens outside [lo, hi) are zeroed on an edge
        uint32_t keep0 = 0xffffffffu, keep1 = 0xffffffffu;
        if (edge) {
          const int t = tok0 + 2 * t4;
          keep0 = (t >= lo && t < hi ? 0x0000ffffu : 0u) |
                  (t + 1 >= lo && t + 1 < hi ? 0xffff0000u : 0u);
          keep1 = (t + 8 >= lo && t + 8 < hi ? 0x0000ffffu : 0u) |
                  (t + 9 >= lo && t + 9 < hi ? 0xffff0000u : 0u);
        }
#pragma unroll
        for (int j2 = 0; j2 < D / 16; ++j2) {
          uint32_t vb[4];
          ldsm_x4_t(vb, swz(v_s, row0 + (mi & 1) * 8 + lr, 8 * (2 * j2 + (mi >> 1))));
          vb[0] &= keep0;
          vb[2] &= keep0;
          vb[1] &= keep1;
          vb[3] &= keep1;
          mma16816<T>(acc[2 * j2], pa0, pa2, vb);
          mma16816<T>(acc[2 * j2 + 1], pa0, pa2, vb + 2);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty<STAGES>(bars, s));
  }

  // Merge the consumer warps' (m, l, O) of rows g < G: O = sum_w 2^(m_w - M)
  // O_w / sum_w 2^(m_w - M) l_w with M the largest m_w.
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  named_sync(1, 32 * CWARPS);  // no warp reads the ring any more
  float* mo = reinterpret_cast<float*>(smem);               // [CWARPS][8][D]
  float* ml = reinterpret_cast<float*>(smem + P::ml_off);   // [CWARPS][2][8]
  float* orow = mo + (cw * 8 + g) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if constexpr (QUANT) {
      orow[merge_col<CB, true>(g, quant_col<CB>(j, 2 * t4))] = acc[j][0];
      orow[merge_col<CB, true>(g, quant_col<CB>(j, 2 * t4 + 1))] = acc[j][1];
    } else {
      *reinterpret_cast<float2*>(orow + merge_col<CB, false>(g, 8 * j + 2 * t4)) =
          make_float2(acc[j][0], acc[j][1]);
    }
  }
  if (t4 == 0) {
    ml[cw * 16 + g] = m;
    ml[cw * 16 + 8 + g] = l;
  }
  named_sync(1, 32 * CWARPS);
  const bool final_out = a.out != nullptr;  // one split: O in T and the LSE
  const size_t row0 = final_out ? (size_t)b * a.hq + (size_t)hk * G
                                : (((size_t)b * a.hkv + hk) * a.num_splits + split) * G;
  for (int idx = threadIdx.x - 32; idx < G * D; idx += 32 * CWARPS) {
    const int r = idx / D, x = idx % D, xs = merge_col<CB, QUANT>(r, x);
    float mm = MFA_MASK;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) mm = fmaxf(mm, ml[w * 16 + r]);
    float ls = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) {
      const float wt = exp2f(ml[w * 16 + r] - mm);
      ls += wt * ml[w * 16 + 8 + r];
      o += wt * mo[(w * 8 + r) * D + xs];
    }
    const bool empty = ls == 0.f;
    const float lsafe = (empty || isnan(ls)) ? 1.f : ls;
    const float lse = empty ? -INFINITY : mm * MFA_LN2 + logf(lsafe);
    if (final_out) {
      static_cast<T*>(a.out)[(row0 + r) * D + x] = from_float<T>(o / lsafe);
      if (x == 0 && a.lse_out != nullptr) a.lse_out[row0 + r] = lse;
    } else {
      a.o_part[(row0 + r) * D + x] = o / lsafe;
      if (x == 0) a.lse_part[row0 + r] = lse;
    }
  }
}

// Encode the K and V maps and launch (a contiguous cache k, v [b, hkv, S,
// D], or the page pools [hkv, P, page, D]). Returns a cudaError_t code,
// MFA_TMA_ENCODE, or 0.
template <typename T, int D, bool PAGED, bool QUANT>
int launch(const void* k, const void* v, const Args& a, int batch, cudaStream_t stream) {
  using P = Plan<D, QUANT>;
  constexpr bool BF = kIsBf16<T>;
  CUtensorMap tk, tv;
  if constexpr (PAGED) {
    const size_t elem = QUANT ? 1 : 2;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)a.page_size,
                                (cuuint64_t)a.hkv * a.num_pages};
    const cuuint64_t strides[2] = {(cuuint64_t)(D * elem),
                                   (cuuint64_t)a.page_size * D * elem};
    const cuuint32_t box[3] = {QUANT ? (cuuint32_t)P::CB : 64u, (cuuint32_t)a.box_rows, 1};
    const CUtensorMapDataType type =
        QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
              : (BF ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16);
    const CUtensorMapSwizzle sw =
        P::CB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    if (int err = mfa_encode(&tk, k, type, 3, dims, strides, box, sw)) return err;
    if (int err = mfa_encode(&tv, v, type, 3, dims, strides, box, sw)) return err;
  } else {
    // S == 0: no tile is ever loaded; the maps only need a valid base
    const bool kv = a.S > 0;
    const int rows = kv ? a.S : 1, planes = kv ? batch * a.hkv : 1;
    if (int err = mfa_tensor_map_3d(&tk, kv ? k : a.q, BF, D, rows, planes, TILE)) return err;
    if (int err = mfa_tensor_map_3d(&tv, kv ? v : a.q, BF, D, rows, planes, TILE)) return err;
  }
  auto kern = splitkv_kernel<T, D, PAGED, QUANT>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  const dim3 grid(a.num_splits, a.hkv, batch);
  kern<<<grid, P::THREADS, P::bytes, stream>>>(tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace kd90
