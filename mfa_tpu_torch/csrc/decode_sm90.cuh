// Single-query decode for Hopper (sm_90a): one tile for two sources.
//  - Kernel 5's launch 1 (decode.cu): a contiguous [b, hkv, S, D] cache;
//    replaces mfa_tpu/kernels/decode.py:_decode_kernel.
//  - Kernel 6 (paged.cu): a page pool [hkv, P, page, D] read in place
//    through the block table, bf16/fp16 pages or quantized pages with fp32
//    row scales [hkv, P, page]: int8, fp8 (e4m3) or int4 (rows of D / 2
//    bytes, feature 2c in byte c's low nibble, 2c + 1 in its high one);
//    replaces mfa_tpu/kernels/paged.py:_paged_kernel_body, with its
//    multi-query spans (q [b, q_span, hq, D]: the rows of a kv head are
//    [q_span, group] flattened, row r at span position r / group).
// One block owns one (batch, kv head, split) and, with M16, one block of 16
// of its rows: without M16 the group's <= 8 q rows (q_span 1) sit in rows
// 0-7 of the m16 tile and rows 8-15 are zero registers; with M16 all 16
// rows hold queries and a fourth grid axis (folded into x) takes the next
// 16, so q_span x group may be anything (kernel 5 takes any group this
// way, its contiguous cache a span of 1).
// Rows are dw features wide (Args::dw <= D; 16 bytes a multiple of a
// stored row's bytes): q, O and the partials at dw, the K/V maps encoded at
// the stored row width, so TMA fills each box's columns past it with zeros
// (inert in Q K^T; a zero byte is 0 in every page format) and q's columns
// past dw are zero registers. Each row sees its own columns
// [lo, hi) of one sequence: span row si sits at position len + pos_offset -
// q_span + si. With a left window the columns < sinks stay visible too
// (StreamingLLM sinks, decode.py:91-117, paged.py:310-331): a block then
// reads its split's sink columns [s_lo, min(sinks, hi)) as tiles of their
// own ahead of the band [lo, hi), no tile twice where the two meet, so each
// sink column is read by exactly the split that holds it (the split count
// still comes from the shapes alone). ALiBi subtracts slope * |position -
// column| from each row's log2-domain scores, the slope of the row's q
// head pre-multiplied by log2 e (decode.py:108-111, paged.py:363-370).
// With one split the block stores the final O in the q dtype and the
// natural-log LSE. With more, each block stores its split's normalized fp32
// O and LSE, and the last block of its (batch, kv head, row block) to do so
// merges every split's into O and the LSE (merge_splits): one launch at any
// split count.
//
// Bound: device-memory bytes, K and V read once (a decode row does 4 D
// operations per 4 D cache bytes, far below the ~295 operations a byte
// where the tensor cores would be the limit). The design keeps the memory
// busy and takes the arithmetic off the CUDA cores:
//  - One producer thread TMA-loads 64-token K and V tiles into a ring of
//    STAGES slots (up to 192 KB, Plan) with full/empty mbarriers. A contiguous
//    cache is one box a tile of a 3-D map over (D, S, b * hkv); the maps
//    clip at S with zeros. Pages of any row count come in boxes of
//    box_rows = gcd(page, 64) rows (1 at an odd page, 64 past a multiple of
//    64; a box never straddles a page) of a map over (D, page, hkv * P), the
//    pool page read from the block table (clamped into the pool, as the
//    plain version clamps it) by the whole producer warp, 32 table entries
//    a load, each lane issuing every 32nd box of a tile. The TMA's swizzle
//    follows the shared-memory address, so boxes of fewer than 8 rows tile
//    the swizzle atoms as one 8-row box does; quantized pages bring their
//    row scales beside them by bulk copies. Quantized boxes of fewer than 4
//    rows (pages of 1, 2, 6, 10, ... rows) come by cp.async instead, 16-byte
//    units into the same swizzled places and 4-byte scales, completing on
//    the slot's full barrier by cp.async.mbarrier.arrive: the TMA writes only
//    128-byte-aligned shared memory and bulk copies move 16-byte runs. No box
//    is issued for rows outside [lo, hi): table entries there may be garbage
//    or -1.
//  - Eight consumer warps in two teams (one team of four at D 256; two of
//    two for fp32 rows there): team t takes tiles t, t + TEAMS, ..., and
//    warp w of a team the tile's tokens [16 w, 16 w + 16). Each warp is
//    its own split of the split: its online
//    softmax (m, l) and O live in registers, no barrier joins the warps
//    while the ring runs, and one shared-memory merge ends the block.
//  - S = Q K^T and O += P V run on mma.sync m16n8k16 (the group's rows
//    padded to 16); P stays in registers as the A fragment of P V.
//    16-bit tiles come in the 128-byte swizzle, K's B fragments by ldmatrix
//    and V's by ldmatrix.trans. There is no int8 x bf16 product, so
//    quantized rows are converted exactly to bf16 in registers (wgmma.cuh:
//    i8x4_to_bf16, e4m3x4_to_bf16, i4x8_to_bf16): the TMA swizzles a row
//    by its byte width RB (D, or D / 2 for int4: 128 B chunks, 64 B, or
//    unswizzled 32 B rows at int4 D 64), K is read as 8- to 32-byte runs
//    whose four-byte words become B fragments of a permuted contraction
//    (one step a word, two for int4's eight values; Q's A fragments are
//    permuted to match, so S is unchanged), and V as 4 tokens x 4 bytes a
//    thread, transposed with byte permutes into B fragments (four a word,
//    eight for int4: a byte's two nibbles are two features) whose output
//    columns are permuted (undone in the merge). K scales multiply the
//    score columns; V scales fold into p after the row sum, before p is
//    rounded for P V.
//  - The block reads the union of its rows' ranges, [lo of its oldest row,
//    hi of its newest). Only a warp's 16 tokens that cross some row's lo or
//    hi are masked: a score outside its own row's range becomes MASK, its p
//    exactly 0 and its scaled p zero; 16-bit and fp8 V fragments outside
//    the union are zeroed (a row or scale past the length may hold
//    anything, and 0 * NaN would survive; a column inside the union is a
//    stored row, finite, and p = 0 is enough there; int8 and int4 codes
//    are all finite, and the fp8 conversion makes its NaN codes finite).
//
//
// fp32 q (T = float) runs the same ring, warps and merge, O and the
// partials in fp32:
//  - fp32 caches and pages: an fp32 row at D has the bytes of a bf16 row at
//    2 D, so a tile is [D / 32 chunks][tokens][32 floats] in the same
//    128-byte swizzle, one box per chunk of a map over 4-byte elements.
//    Both products run in 3xTF32 on mma.sync m16n8k8 .tf32 (tf32.cuh:
//    lo.hi + hi.lo + hi.hi, lo.lo dropped; kernels/backward.py:
//    _matmul_3xtf32_plain is the CPU emulation). K and V are split as they
//    are read, each by the one warp that reads it. S's k step takes
//    features f, f + 1 in k slots t4, t4 + 4 with f from s_feat (one 8-byte
//    read of 16-byte units kk % 4 and kk % 4 + 4: no bank conflict under the
//    swizzle); P stays in registers with tokens 2 t4, 2 t4 + 1 of each 8
//    in k slots t4, t4 + 4, so V's B fragment reads tokens 2 t4, 2 t4 + 1
//    of feature g, at bank 4 ((g >> 2) ^ 2 t4) + (g & 3) (no conflict).
//    Without M16, rows 8-15 of A carry the lo part of rows 0-7: hi.lo in
//    rows 0-7 of one product, hi.hi and lo.hi in rows 0-7 and 8-15 of the
//    next, added by FADD, so two products do the work of three. The tensor
//    core truncates what it accumulates: S takes a fresh accumulator every
//    64 features, O one every 16 tokens, added to the running sums by
//    FADD / FFMA. A 64-token fp32 tile is 64 KB at D 128: two slots, one a
//    team (a slot serves one team: Plan::STAGES); D 256 takes 32-token
//    tiles (two warps a tile, two teams), two slots of 64 KB too.
//  - int8 / fp8 / int4 pages: the ring, the conversions and P V are the
//    bf16 kernel's. q is split once a block into three bf16 parts, hi +
//    mid + lo = q exactly (kernels/wmatmul.py:_split_bf16x3_plain), so q . k
//    is three m16n8k16 products against the same converted K fragments,
//    each product exact in fp32 and each part its own accumulator, added
//    (lo + mid) + hi by FADD (without M16, hi and mid share one product as
//    rows 0-7 and 8-15).
//  - Q lives in shared memory after the barriers, read once a k step:
//    fp32 rows in the tile's swizzle, or the bf16 parts as the A fragment
//    words of each k step.
//
// Semantics of the plain versions (kernels/decode.py, kernels/paged.py),
// kept exactly: scores scaled into the log2 domain before the max (softcap
// first), probabilities rounded to V's dtype (bf16 for int8 pages) before
// P V while l sums them unrounded (fp32 caches: not rounded), a row with
// no visible column stores O = 0 and LSE = -inf, and split ranges are
// whole 64-token units.
#pragma once

#include <type_traits>

#include "tf32.cuh"

namespace kd90 {

// tokens a split unit, and a tile but for fp32 rows at D 256 (kernels/decode.py:TILE)
constexpr int TILE = 64;
// the most splits a launch takes (kernels/decode.py:MAX_SPLITS): the merge
// keeps a weight per split and row in shared memory
constexpr int MAX_SPLITS = 128;

struct Args {
  const void* q;       // [b, hq, dw]
  const int* lens;     // [b] stored lengths
  float* o_part;       // [b, hkv, splits, group, dw] fp32
  float* lse_part;     // [b, hkv, splits, group]
  int hq, hkv, group, S, tokens_per_split, num_splits, window_left;
  float scale_log2e, softcap, softcap_mul;
  // the paged source (zero for the contiguous cache): S = pps * page
  const int* table;      // [b, pps] pool pages
  const float* k_scale;  // quantized pages: [hkv, P, page] fp32
  const float* v_scale;
  void* out;             // O [b, q_span, hq, dw] in T
  float* lse_out;        // and its LSE [b, q_span, hq] (or null)
  // splits > 1: one ticket counter per (batch, kv head, row block), zero
  // before the launch and again after it (kernels/_build.py:split_counters)
  int* counters;
  int num_pages, page_size, pps, box_rows, pos_offset;
  int q_span;  // M16: span positions of q [b, q_span, hq, D] (else 1)
  int sinks;   // with a left window: columns < sinks stay visible (else 0)
  const float* slopes;  // ALiBi [hq] in the log2 domain, or null
  int dw;      // features of a q, O and stored K/V row (<= D)
  // the page pools (paged quantized boxes of fewer than 4 rows are copied
  // by cp.async from them; else only the tensor maps read them)
  const void* k_pages;
  const void* v_pages;
};

// Shared memory: STAGES slots of [K tile | V tile (| K scales | V scales)],
// then the barriers (full[STAGES], empty[STAGES]), then (fp32 q) Q. A
// 16-bit tile is [D / 64 chunks][64 tokens][64] with the 128-byte swizzle,
// an fp32 tile [D / 32][TT tokens][32] in the same swizzle, a quantized
// tile [RB / CB chunks][64 tokens][CB bytes] with the CB-byte swizzle (none
// at 32). Q (fp32 q): fp32 rows [D / 32][16][32] in the swizzle, or the
// bf16 parts [3][16 rows][QW words] (QW = D / 2 + 8: rows 8 banks apart).
// The final merge reuses the ring: per consumer warp m[ROWS], l[ROWS] and
// O[ROWS][D] fp32 (ROWS 8, or 16 with M16: 64 KB at D 128 and D 256). At
// D 256 four consumer warps: a thread's O alone takes 128 registers, and
// nine warps could hold no more than 168 a thread (three warps share a
// quarter of the register file).
template <int D, KV F, bool F32 = false>
struct Plan {
  static constexpr bool QUANT = F != KV::F16;
  static constexpr bool F32P = F32 && !QUANT;                // fp32 rows, 3xTF32
  static constexpr int TT = F32P && D > 128 ? TILE / 2 : TILE;  // tokens a tile
  static constexpr int WPT = TT / 16;                        // consumer warps a tile
  static constexpr int CWARPS = D > 128 ? 4 : 8;             // 16 tokens of a tile each
  static constexpr int TEAMS = CWARPS / WPT;                 // tiles worked on at once
  static constexpr int THREADS = 32 * (1 + CWARPS);
  static constexpr int EB = F32P ? 4 : 2;                    // bytes of a 16-bit / fp32 value
  static constexpr int CE = 128 / EB;                        // values of a 128-byte chunk row
  static constexpr int RB = F == KV::I4 ? D / 2 : D;       // bytes of a quantized row
  static constexpr int CB = QUANT && RB < 128 ? RB : 128;  // bytes of a chunk row
  static constexpr uint32_t CHUNK = TT * CB;               // bytes of a chunk
  static constexpr uint32_t KV_BYTES = TT * (QUANT ? RB : EB * D);  // one K or V tile
  static constexpr uint32_t sc_off = 2 * KV_BYTES;  // quantized: K, V scales
  static constexpr uint32_t STAGE_BYTES =  // a slot, 1024-byte aligned for the swizzle
      (sc_off + (QUANT ? 2 * TT * 4 : 0) + 1023) / 1024 * 1024;
  // Slot i % STAGES holds tile i and team i % TEAMS takes it: with STAGES a
  // multiple of TEAMS every slot has one team, which waits on its phases in
  // turn (a slot shared by two teams would let a team's parity wait pass on
  // the other team's phase two phases back).
  static constexpr int FIT = (192 * 1024) / STAGE_BYTES;
  static constexpr int STAGES = (FIT < 16 ? FIT : 16) / TEAMS * TEAMS;
  static constexpr uint32_t bar_off = STAGES * STAGE_BYTES;
  static constexpr int QW = D / 2 + 8;  // words of a row of one bf16 part of q
  static constexpr uint32_t q_off = (bar_off + 16 * STAGES + 127) / 128 * 128;
  static constexpr uint32_t Q_BYTES = !F32 ? 0 : F32P ? 16 * D * 4 : 3 * 16 * QW * 4;
  static constexpr size_t bytes = q_off + Q_BYTES + 1024;  // + 1 KB to align the base
  // the merge of ROWS rows a warp: O rows, then (m, l)
  template <int ROWS>
  static constexpr uint32_t ml_off = CWARPS * ROWS * D * 4;
  static_assert(STAGES >= 2 && STAGES % TEAMS == 0, "a ring of a slot or more a team");
  static_assert(ml_off<16> + CWARPS * 2 * 16 * 4 <= bar_off, "the merge must fit in the ring");
  // the split merge: the weights below (m, l), the staged partials from
  // past them to the barriers, at least one split's rows at a time
  template <int ROWS>
  static constexpr uint32_t stage_off = (ml_off<ROWS> + CWARPS * 2 * ROWS * 4 + 15) / 16 * 16;
  static_assert(8 * (MAX_SPLITS + 2) * 4 <= ml_off<8> && 16 * (MAX_SPLITS + 2) * 4 <= ml_off<16>,
                "the split merge's weights must fit below (m, l)");
  static_assert(stage_off<16> + 16 * D * 4 <= bar_off, "a split's rows must fit the stage");
  static_assert(bytes <= 232448, "a block's shared memory");
};

// fp32 S: k step kk (8 features) puts features f and f + 1 in k slots t4
// and t4 + 4, f = 32 (kk / 4) + 4 (kk % 4) + 16 (t4 / 2) + 2 (t4 % 2):
// lanes t4 0, 1 read 16-byte unit kk % 4 of a 128-byte chunk row, lanes 2,
// 3 unit kk % 4 + 4, so the 16 lanes of rows g 0-3 (or 4-7) cover the 32
// banks once under the swizzle.
__device__ __forceinline__ int s_feat(int kk, int t4) {
  return 32 * (kk >> 2) + 4 * (kk & 3) + 16 * (t4 >> 1) + 2 * (t4 & 1);
}

// Byte offset of fp32 (row, col) in a [D / 32][ROWS][32] tile in the
// 128-byte swizzle (16-byte unit (col % 32) / 4 of row `row` stored at unit
// ^ row % 8).
template <int ROWS>
__device__ __forceinline__ int swz32(int row, int col) {
  return (col >> 5) * (ROWS * 128) + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
         ((col & 3) << 2);
}

__device__ __forceinline__ float2 lds2(const unsigned char* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float lds1(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}

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

// All 16 rows of A: a0 / a1 rows g / g + 8 at k 0-7, a2 / a3 at k 8-15.
template <typename T>
__device__ __forceinline__ void mma16816_full(float (&c)[4], uint32_t a0, uint32_t a1,
                                              uint32_t a2, uint32_t a3, const uint32_t* b);
template <>
__device__ __forceinline__ void mma16816_full<__nv_bfloat16>(float (&c)[4], uint32_t a0,
                                                             uint32_t a1, uint32_t a2,
                                                             uint32_t a3, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma16816_full<__half>(float (&c)[4], uint32_t a0, uint32_t a1,
                                                      uint32_t a2, uint32_t a3,
                                                      const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b[0]), "r"(b[1]));
}

// The block's A operand a: M16 {row g lo, row g + 8 lo, row g hi, row g + 8
// hi}; else {row g lo, row g hi} with rows 8-15 zero.
template <typename T, bool M16>
__device__ __forceinline__ void mma_rows(float (&c)[4], const uint32_t* a, const uint32_t* b) {
  if constexpr (M16) {
    mma16816_full<T>(c, a[0], a[1], a[2], a[3], b);
  } else {
    mma16816<T>(c, a[0], a[1], b);
  }
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

// Byte offset of 16-byte unit `unit` of row `row` inside a quantized
// chunk of CB-byte rows, as the TMA's CB-byte swizzle stores it (address
// bits 4-6 XOR bits 7-9 for 128 B, bits 4-5 XOR bits 7-8 for 64 B; chunks
// are 1024-byte aligned); 32-byte rows come unswizzled.
template <int CB>
__device__ __forceinline__ int swz8(int row, int unit) {
  return CB == 128  ? row * 128 + ((unit ^ (row & 7)) << 4)
         : CB == 64 ? row * 64 + ((unit ^ ((row >> 1) & 3)) << 4)
                    : row * 32 + (unit << 4);
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

// Output column of accumulator column n (0-7) of n-tile j in the quantized
// P V: thread g of a warp reads bytes [c CB + (CB / 8) g, + CB / 8) of V's
// rows in chunk c. One byte a value: n-tile j = 4 (c CB / 32 + w) + e is
// byte 4 w + e of them. int4: n-tile j = c CB / 4 + 8 w + 2 e + h is the
// low (h 0) or high (h 1) nibble of byte 4 w + e, features 2 byte + h.
template <KV F, int CB>
__device__ __forceinline__ int quant_col(int j, int n) {
  if constexpr (F == KV::I4) {
    const int c = j / (CB / 4), r = j % (CB / 4);
    return 2 * (c * CB + (CB / 8) * n + 4 * (r >> 3) + ((r >> 1) & 3)) + (r & 1);
  } else {
    const int cw = j >> 2, c = cw / (CB / 32), w = cw % (CB / 32);
    return c * CB + (CB / 8) * n + 4 * w + (j & 3);
  }
}

// Where the merge keeps column x of row r (r % 8 = the row's g) of a warp's
// O, so that the lanes' stores of one accumulator spread over the banks
// (rows are D floats apart: unswizzled, the 8 rows' stores share banks).
// 16-bit: bits 3-5 XOR g (column pairs stay together for 8-byte stores);
// quantized: bits 0-4 XOR (g, and bits of the column that set the t4
// whose accumulator holds it: unswizzled, all 32 int8 lanes hit one bank).
template <int CB, bool QUANT>
__device__ __forceinline__ int merge_col(int r, int x) {
  return QUANT ? x ^ (((r & 7) << 2) | ((x % CB) / (CB / 4))) : x ^ ((r & 7) << 3);
}

// Column of the first of the four q values of k step kk that lane t4's A
// words hold, ordered as its K (or V) reads: 16-bit, columns 16 kk + 2 t4
// (+ 1) and + 8 (+ 1); one byte a value, step kk = c NW + w, columns c CB +
// (CB / 4) t4 + 4 w + 0..3 (the four bytes of K this lane reads there);
// int4, steps 2 (c NW + w) + h, columns 2 (c CB + (CB / 4) t4 + 4 w) + 4 h
// + 0..3 (half of the word's eight nibbles each).
template <KV F, int CB>
__device__ __forceinline__ int q_col(int kk, int t4) {
  constexpr int NW = CB / 16;
  if constexpr (F == KV::I4) {
    const int W = kk >> 1;
    return 2 * ((W / NW) * CB + (CB / 4) * t4 + 4 * (W % NW)) + 4 * (kk & 1);
  } else if constexpr (F != KV::F16) {
    return (kk / NW) * CB + (CB / 4) * t4 + 4 * (kk % NW);
  } else {
    return 16 * kk + 2 * t4;
  }
}

// The K words a lane reads of row `row` in a chunk of a quantized tile:
// bytes [(CB / 4) t4, + CB / 4) (of the row's g), as NW = CB / 16 words.
template <int CB>
__device__ __forceinline__ void k_words(const unsigned char* chunk, int row, int t4,
                                        uint32_t (&kw)[CB / 16]) {
  if constexpr (CB == 32) {
    const uint2 u = *reinterpret_cast<const uint2*>(chunk + swz8<CB>(row, 0) + 8 * t4);
    kw[0] = u.x;
    kw[1] = u.y;
  } else {
#pragma unroll
    for (int x = 0; x < CB / 64; ++x) {
      const uint4 u = *reinterpret_cast<const uint4*>(chunk + swz8<CB>(row, (CB / 64) * t4 + x));
      kw[4 * x] = u.x;
      kw[4 * x + 1] = u.y;
      kw[4 * x + 2] = u.z;
      kw[4 * x + 3] = u.w;
    }
  }
}

// K word -> the bf16 B fragment(s) of its k step(s): two words (int8,
// fp8), or four (int4: two k steps).
template <KV F>
__device__ __forceinline__ void k_frag(uint32_t w, uint32_t (&kb)[4]) {
  if constexpr (F == KV::I4) {
    i4x8_to_bf16(w, kb);
  } else if constexpr (F == KV::E4M3) {
    e4m3x4_to_bf16(w, kb[0], kb[1]);
  } else {
    i8x4_to_bf16(w, kb[0], kb[1]);
  }
}

// The split merge of one (batch, kv head, row block) by the NT consumer
// threads of the block that arrived last: rows r0 .. r0 + nrows - 1 of the
// partials o_part / lse_part (other blocks wrote them: read through L2)
// into O in T and the LSE. The arithmetic of the two-launch design's merge
// kernel, expression for expression and in split order: m = the largest
// LSE (0 if all are -inf), w_s = expf(lse_s - m), denominator = the w_s
// summed in order (1 if 0), O = sum_s w_s o_s / denominator (one fused
// multiply-add a split), LSE = m + logf(denominator) (-inf if all are
// -inf). So O and the LSE are the bits that merge gave, whatever the order
// in which the splits ended. The tail is latency: the partials come into
// shared memory by cp.async, every split's rows in flight at once (in
// chunks of as many splits as [stage_off, stage_end) holds), while the
// weights are formed. Shared memory from sm: the weights [nrows][splits],
// then the rows' m and denominators; named barrier 1 joins the NT threads.
template <typename T, int D, int ROWS, int NT, bool M16>
__device__ __forceinline__ void merge_splits(const Args& a, int b, int hk, int r0, int nrows,
                                             int span, unsigned char* sm, uint32_t stage_off,
                                             uint32_t stage_end) {
  const int ns = a.num_splits, G = a.group, R = span * G, dw = a.dw;
  const int tid = threadIdx.x - 32;
  float* w = reinterpret_cast<float*>(sm);  // the LSE, then the weight, of row r, split s
  float* mrow = w + ROWS * MAX_SPLITS;      // a row's largest LSE
  float* drow = mrow + ROWS;                // its safe denominator
  float* stage = reinterpret_cast<float*>(sm + stage_off);  // [splits][nrows][dw]
  const int per_split = nrows * dw;  // floats of one split's rows: contiguous in o_part
  const int chunk = min(ns, (int)((stage_end - stage_off) / 4) / per_split);
  const size_t part0 = ((size_t)b * a.hkv + hk) * ns * R + r0;  // split 0's row r0
  auto stage_splits = [&](int s0, int n) {
    for (int i = tid; i < n * per_split / 4; i += NT) {
      const int sp = i / (per_split / 4), u = i % (per_split / 4);
      tc32::cp16(stage + 4 * i, a.o_part + (part0 + (size_t)(s0 + sp) * R) * dw + 4 * u, true);
    }
    tc32::cp_commit();
  };
  stage_splits(0, chunk);
  for (int i = tid; i < nrows * ns; i += NT) {
    const int r = i / ns, sp = i % ns;
    w[i] = __ldcg(a.lse_part + part0 + (size_t)sp * R + r);
  }
  named_sync(1, NT);
  if (tid < nrows) {
    float m = -INFINITY;
    for (int sp = 0; sp < ns; ++sp) m = fmaxf(m, w[tid * ns + sp]);
    mrow[tid] = m;
  }
  named_sync(1, NT);
  for (int i = tid; i < nrows * ns; i += NT) {
    const float m = mrow[i / ns];
    w[i] = expf(w[i] - (m == -INFINITY ? 0.f : m));
  }
  named_sync(1, NT);
  // row r0 + r of the (batch, kv head): its row of O and of the LSE
  auto out_row = [&](int r) {
    const int rr = r0 + r, si = M16 ? rr / G : 0, gi = M16 ? rr % G : rr;
    return ((size_t)b * span + si) * a.hq + (size_t)hk * G + gi;
  };
  if (tid < nrows) {
    float denom = 0.f;
    for (int sp = 0; sp < ns; ++sp) denom += w[tid * ns + sp];
    const float dsafe = denom == 0.f ? 1.f : denom;
    drow[tid] = dsafe;
    const bool all_empty = mrow[tid] == -INFINITY;
    if (a.lse_out != nullptr)
      a.lse_out[out_row(tid)] = all_empty ? -INFINITY : mrow[tid] + logf(dsafe);
  }
  // four columns of a row a thread, EPT of them (D, not dw, in the index
  // arithmetic, as in the block's own merge). Up to D 128 (EPT <= 2) a
  // column's splits run 4 at a time; at D 256 a split's EPT reads go out
  // together, one split at a time (more held 4 x EPT float4s in flight and
  // spilled beside the 16-row tile's 255 registers).
  constexpr int EPT = (ROWS * D / 4 + NT - 1) / NT;
  int at[EPT], wat[EPT];  // row * dw + column in a split's staged rows (or
                          // -1), and row * splits: the row's weights
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    const int i = tid + k * NT, r = i / (D / 4), x = 4 * (i % (D / 4));
    at[k] = r < nrows && x < dw ? r * dw + x : -1;
    wat[k] = r * ns;
  }
  float acc[EPT][4] = {};
  auto fma4 = [&](int k, int sp, int s0) {
    const float4 o = *reinterpret_cast<const float4*>(stage + sp * per_split + at[k]);
    const float ws = w[wat[k] + s0 + sp];
    acc[k][0] += ws * o.x;
    acc[k][1] += ws * o.y;
    acc[k][2] += ws * o.z;
    acc[k][3] += ws * o.w;
  };
  for (int s0 = 0; s0 < ns; s0 += chunk) {
    const int n = min(chunk, ns - s0);
    tc32::cp_wait<0>();
    named_sync(1, NT);  // splits [s0, s0 + n) staged (and the denominators stored)
    if constexpr (EPT <= 2) {
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        if (at[k] < 0) continue;
#pragma unroll 4
        for (int sp = 0; sp < n; ++sp) fma4(k, sp, s0);
      }
    } else {
#pragma unroll 1
      for (int sp = 0; sp < n; ++sp) {
#pragma unroll
        for (int k = 0; k < EPT; ++k)
          if (at[k] >= 0) fma4(k, sp, s0);
      }
    }
    if (s0 + n < ns) {
      named_sync(1, NT);  // every thread is done with this chunk
      stage_splits(s0 + n, min(chunk, ns - s0 - n));
    }
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    if (at[k] < 0) continue;
    const int r = wat[k] / ns, x = at[k] - r * dw;
    const float dsafe = drow[r];
    T* out = static_cast<T*>(a.out) + out_row(r) * dw + x;
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = from_float<T>(acc[k][e] / dsafe);
  }
}

// Grid (splits x row blocks, hkv, batch). T: q's dtype (bf16, fp16 or
// float). PAGED: the source is a page pool through the block table; F:
// the pages' format (KV::F16: T's rows; quantized: fp32 row scales, T bf16
// or float); M16: 16 query rows a block, each with its own columns (spans,
// groups above 8).
template <typename T, int D, bool PAGED, KV F, bool M16>
__global__ void __launch_bounds__(Plan<D, F>::THREADS, 1)
    splitkv_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const Args a) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using P = Plan<D, F, F32>;
  using TM = std::conditional_t<F32, __nv_bfloat16, T>;  // 16-bit operands of the products
  constexpr bool QUANT = P::QUANT, F32P = P::F32P, F32Q = F32 && QUANT;
  constexpr int STAGES = P::STAGES, TEAMS = P::TEAMS, CWARPS = P::CWARPS, CB = P::CB;
  constexpr int TT = P::TT, WPT = P::WPT, CE = P::CE;
  constexpr int NCH = P::RB / CB, NW = CB / 16;  // quantized: chunks a row, words a thread reads in each
  constexpr int ROWS = M16 ? 16 : 8;  // rows of the merge a warp
  constexpr int NR = M16 ? 2 : 1;     // rows a thread owns: g (and g + 8)
  static_assert(PAGED || !QUANT, "quantized rows come only as pages");
  const int split = M16 ? blockIdx.x % a.num_splits : blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = a.group;
  const int span = M16 ? a.q_span : 1;
  const int R = span * G;                  // rows of the (batch, kv head)
  const int r0 = M16 ? 16 * (blockIdx.x / a.num_splits) : 0;  // the block's first row
  const int nrows = M16 ? min(16, R - r0) : G;
  const int length = a.lens[b];
  // Columns [row_lo(si), row_hi(si)) of span row si inside this split
  const int s_lo = split * a.tokens_per_split;
  const int s_hi = min(a.S, (split + 1) * a.tokens_per_split);
  auto row_lo = [&](int si) {
    const int pos = length + a.pos_offset - span + si;
    return max(s_lo, a.window_left >= 0 ? max(0, pos - a.window_left) : 0);
  };
  auto row_hi = [&](int si) {
    return min(s_hi, min(length, length + a.pos_offset - span + si + 1));
  };
  const int si_first = r0 / G, si_last = (r0 + nrows - 1) / G;
  const int lo = row_lo(si_first), hi = row_hi(si_last);  // the union of the rows' ranges
  // the columns every row of the block sees: a warp's tokens inside need no mask
  const int lo_all = M16 ? row_lo(si_last) : lo, hi_all = M16 ? row_hi(si_first) : hi;
  // the split's sink columns [sa_lo, sa_hi) (empty: sa_hi == sa_lo), read
  // as tiles [sa_lo / TT, + nsink) ahead of the band's tiles from bfirst
  const int sa_lo = s_lo, sa_hi = max(s_lo, min(a.sinks, hi));
  const int nsink = sa_hi > sa_lo ? (sa_hi + TT - 1) / TT - sa_lo / TT : 0;
  const int bfirst = max(lo / TT, sa_lo / TT + nsink);
  const int n_tiles = nsink + (lo < hi ? max(0, (hi + TT - 1) / TT - bfirst) : 0);
  auto tile_of = [&](int i) { return i < nsink ? sa_lo / TT + i : bfirst + (i - nsink); };

  extern __shared__ __align__(16) unsigned char kd_smem[];
  unsigned char* smem = kd_smem + ((1024u - (smem_u32(kd_smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + P::bar_off;
  if (threadIdx.x == 0) {
    // paged quantized boxes of fewer than 4 rows: 32 producer lanes arrive
    // by cp.async besides the TMA's announcing arrival
    const uint32_t full_count = PAGED && QUANT && a.box_rows < 4 ? 33 : 1;
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(bars, s), full_count);
      mbar_init(bar_empty<STAGES>(bars, s), WPT);  // lane 0 of each warp of the tile's team
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
          const int row = tile_of(i) * TT, plane = b * a.hkv + hk;
#pragma unroll
          for (int ch = 0; ch < D / CE; ++ch) {
            tma_load_3d(k_s + ch * (TT * 128), &tk, bar_full(bars, s), ch * CE, row, plane);
            tma_load_3d(v_s + ch * (TT * 128), &tv, bar_full(bars, s), ch * CE, row, plane);
          }
        }
      }
    } else {
      // Lane l issues boxes jb0 + l, jb0 + l + 32, ... of a tile and holds
      // the pool page of table entry id0 + l; the warp reloads 32 entries
      // when a group of 32 boxes passes them (their pages span at most 32
      // entries: a box is R rows of one page, R dividing the page).
      const int* tbl = a.table + (size_t)b * a.pps;
      const int R = a.box_rows, page = a.page_size, last_pi = (hi - 1) / page;
      // quantized boxes of R < 4 rows come by cp.async (cp_box): the TMA
      // writes only to 128-byte-aligned shared memory (a box of 1 row of 64
      // bytes, or 2 of 32, is not), and bulk copies of scales need 16-byte
      // runs; their bytes are not in the expected count
      const bool cp_box = QUANT && R < 4;
      const uint32_t box_bytes = cp_box ? 0 : QUANT ? 2 * R * (P::RB + 4) : 2 * R * D * P::EB;
      int ids = 0, id0 = -32;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, t0 = tile_of(i) * TT;
        // the hull of the tile's tokens in [sa_lo, sa_hi) and [lo, hi)
        int tlo = TT, thi = 0;
        if (sa_lo < sa_hi && sa_lo < t0 + TT && sa_hi > t0) {
          tlo = max(sa_lo - t0, 0);
          thi = min(sa_hi - t0, TT);
        }
        if (lo < hi && lo < t0 + TT && hi > t0) {
          tlo = min(tlo, max(lo - t0, 0));
          thi = max(thi, min(hi - t0, TT));
        }
        const int jb0 = tlo / R, jb1 = (thi + R - 1) / R;
        const uint32_t k_s = base + s * P::STAGE_BYTES, v_s = k_s + P::KV_BYTES;
        if (lane == 0) {
          mbar_wait(bar_empty<STAGES>(bars, s), ((i / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full(bars, s), (jb1 - jb0) * box_bytes);
        }
        __syncwarp();  // the slot is free and its bytes announced
        for (int jg = jb0; jg < jb1; jg += 32) {
          // warp-uniform: the page of the group's last box
          if ((t0 + (min(jg + 32, jb1) - 1) * R) / page >= id0 + 32) {
            id0 = (t0 + jg * R) / page;
            ids = id0 + lane <= last_pi ? tbl[id0 + lane] : 0;
          }
          const int jb = jg + lane, key = t0 + jb * R, pi = key / page, row = key % page;
          const int pg =
              min(max(__shfl_sync(0xffffffffu, ids, (pi - id0) & 31), 0), a.num_pages - 1);
          if (jb >= jb1) continue;
          const int plane = hk * a.num_pages + pg;
          if constexpr (QUANT) {
            const size_t srow = (size_t)plane * page + row;
            if (cp_box) {
              // 16-byte units into the chunks' swizzle, zeros past the
              // stored row (as the TMA fills them); the scales 4 bytes each
              const int w = F == KV::I4 ? a.dw / 2 : a.dw;
              const unsigned char* kg = static_cast<const unsigned char*>(a.k_pages);
              const unsigned char* vg = static_cast<const unsigned char*>(a.v_pages);
              unsigned char* sk = smem + s * P::STAGE_BYTES;
              for (int r = 0; r < R; ++r) {
                const size_t g0 = (srow + r) * w;
#pragma unroll
                for (int c = 0; c < NCH; ++c)
#pragma unroll
                  for (int u = 0; u < CB / 16; ++u) {
                    const int col = c * CB + 16 * u;
                    const int at = c * P::CHUNK + swz8<CB>(jb * R + r, u);
                    const bool ok = col < w;
                    tc32::cp16(sk + at, kg + (ok ? g0 + col : 0), ok);
                    tc32::cp16(sk + P::KV_BYTES + at, vg + (ok ? g0 + col : 0), ok);
                  }
                float* scl = reinterpret_cast<float*>(sk + P::sc_off) + jb * R + r;
                tc32::cp4(scl, a.k_scale + srow + r, true);
                tc32::cp4(scl + TT, a.v_scale + srow + r, true);
              }
            } else {
#pragma unroll
              for (int c = 0; c < NCH; ++c) {
                const uint32_t at = c * P::CHUNK + jb * R * CB;
                tma_load_3d(k_s + at, &tk, bar_full(bars, s), c * CB, row, plane);
                tma_load_3d(v_s + at, &tv, bar_full(bars, s), c * CB, row, plane);
              }
              const uint32_t sc = k_s + P::sc_off + jb * R * 4;
              bulk_load(sc, a.k_scale + srow, R * 4, bar_full(bars, s));
              bulk_load(sc + TT * 4, a.v_scale + srow, R * 4, bar_full(bars, s));
            }
          } else {
            // 16-bit and fp32 rows are 128 bytes a chunk: a box of any R
            // lands 128-byte aligned, and the TMA's 128-byte swizzle follows
            // the shared-memory address, so R-row boxes tile the atoms
            // exactly as one 8-row box does (tests/test_torch_kernels_gpu.py
            // ::test_tma_boxes_under_8_rows)
#pragma unroll
            for (int ch = 0; ch < D / CE; ++ch) {
              const uint32_t at = ch * (TT * 128) + jb * R * 128;
              tma_load_3d(k_s + at, &tk, bar_full(bars, s), ch * CE, row, plane);
              tma_load_3d(v_s + at, &tv, bar_full(bars, s), ch * CE, row, plane);
            }
          }
        }
        if (cp_box) tc32::cp_arrive(bar_full(bars, s));  // every lane, once its copies land
      }
    }
    return;
  }

  const int cw = warp - 1;  // consumer warp
  const int team = (unsigned)cw / WPT, quarter = (unsigned)cw % WPT;
  const int g = lane >> 2, t4 = lane & 3;
  // This thread's rows g (and g + 8): [lo, hi) of each, their positions
  // and ALiBi slopes. A padding row (past the group, or past q_span x
  // group) takes the last row's range.
  int rlo[NR], rhi[NR], rpos[NR];
  float rsl[NR];
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    const int rc = M16 ? min(r0 + g + 8 * h, r0 + nrows - 1) : min(g, G - 1);
    const int si = M16 ? rc / G : 0;
    rlo[h] = M16 ? row_lo(si) : lo;
    rhi[h] = M16 ? row_hi(si) : hi;
    rpos[h] = length + a.pos_offset - span + si;
    rsl[h] = a.slopes != nullptr ? a.slopes[hk * G + rc % G] : 0.f;
  }
  const bool alibi = a.slopes != nullptr;
  // 16-bit q: Q rows as A fragments (qa[kk][h] the low k half of row g + 8
  // h, qa[kk][NR + h] the high one; padding rows zero), columns from q_col
  uint32_t qa[F32 ? 1 : D / 16][2 * NR];
  if constexpr (!F32) {
#pragma unroll
    for (int h = 0; h < NR; ++h) {
      const int r = M16 ? r0 + g + 8 * h : g;
      const bool live = M16 ? r < R : g < G;
      const int rc = M16 ? min(r, R - 1) : min(g, G - 1);
      const int si = M16 ? rc / G : 0, gi = M16 ? rc % G : rc;
      const uint32_t* qr = reinterpret_cast<const uint32_t*>(
          static_cast<const T*>(a.q) +
          (((size_t)b * span + si) * a.hq + (size_t)hk * G + gi) * a.dw);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int col = q_col<F, CB>(kk, t4);
        // columns past dw are zeros (a quantized step's four columns lie on
        // one side of dw, a multiple of 16)
        qa[kk][h] = live && col < a.dw ? qr[col / 2] : 0u;
        qa[kk][NR + h] = live && col + (QUANT ? 0 : 8) < a.dw ? qr[col / 2 + (QUANT ? 1 : 4)] : 0u;
      }
    }
  } else {
    // fp32 q into shared memory once: the rows (F32P), or the A words of
    // each k step of its three bf16 parts (F32Q); padding rows and columns
    // past dw zero
    unsigned char* qs = smem + P::q_off;
    for (int i = threadIdx.x - 32; i < 16 * (D / 4); i += 32 * CWARPS) {
      const int r = i / (D / 4), x = i % (D / 4);  // block row r (without M16: group row r)
      const int c = F32P ? 4 * x : q_col<F, CB>(x >> 2, x & 3);  // F32Q: step x / 4, lane x % 4
      const int rr = r0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if ((M16 ? rr < R : r < G) && c < a.dw) {
        const int si = M16 ? rr / G : 0, gi = M16 ? rr % G : r;
        const float* qr = reinterpret_cast<const float*>(a.q) +
                          (((size_t)b * span + si) * a.hq + (size_t)hk * G + gi) * a.dw;
        v = __ldg(reinterpret_cast<const float4*>(qr + c));
      }
      if constexpr (F32P) {
        *reinterpret_cast<float4*>(qs + swz32<16>(r, c)) = v;
      } else {
        const float vv[4] = {v.x, v.y, v.z, v.w};
        uint32_t part[3][4];  // hi, mid, lo bf16 bits of each value
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat16 h0 = __float2bfloat16_rn(vv[e]);
          const float r1 = vv[e] - __bfloat162float(h0);
          const __nv_bfloat16 m0 = __float2bfloat16_rn(r1);
          const __nv_bfloat16 l0 = __float2bfloat16_rn(r1 - __bfloat162float(m0));
          part[0][e] = __bfloat16_as_ushort(h0);
          part[1][e] = __bfloat16_as_ushort(m0);
          part[2][e] = __bfloat16_as_ushort(l0);
        }
        uint32_t* qw = reinterpret_cast<uint32_t*>(qs);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          *reinterpret_cast<uint2*>(qw + (p * 16 + r) * P::QW + 2 * x) =
              make_uint2(part[p][0] | (part[p][1] << 16), part[p][2] | (part[p][3] << 16));
      }
    }
    named_sync(1, 32 * CWARPS);
  }
  const unsigned char* qs = smem + P::q_off;
  // fp32 q's bf16 parts, the A words {low k half, high k half} of part p,
  // row r (0-15), k step kk. With M16 an ordered load each: left free,
  // the compiler hoists them all ahead of the products and spills.
  auto qpart = [&](int p, int r, int kk) {
    const int off = 4 * ((p * 16 + r) * P::QW + 8 * kk + 2 * t4);
    if constexpr (M16) {
      uint2 u;
      asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                   : "=r"(u.x), "=r"(u.y)
                   : "r"(base + P::q_off + off));
      return u;
    } else {
      return *reinterpret_cast<const uint2*>(qs + off);
    }
  };
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // rows g (+ 8)'s running max (log2 domain) and this thread's sums
  float m[NR], l[NR];
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    m[h] = MFA_MASK;
    l[h] = 0.f;
  }
  const int lr = lane & 7, mi = lane >> 3;

  for (int i = team; i < n_tiles; i += TEAMS) {
    const int s = i % STAGES;
    mbar_wait(bar_full(bars, s), (i / STAGES) & 1);
    const int tok0 = tile_of(i) * TT + 16 * quarter;  // this warp's first token
    if ((tok0 < hi && tok0 + 16 > lo) || (tok0 < sa_hi && tok0 + 16 > sa_lo)) {
      const bool edge = tok0 < lo_all || tok0 + 16 > hi_all;
      const uint32_t k_s = base + s * P::STAGE_BYTES, v_s = k_s + P::KV_BYTES;
      const unsigned char* slot = smem + s * P::STAGE_BYTES;
      const int row0 = 16 * quarter;  // this warp's rows of the tile

      // S = Q K^T over the warp's 16 tokens: two 8-token n-tiles
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if constexpr (QUANT) {
        // with M16 (Q's fragments take twice the registers) one n-tile at a
        // time
        constexpr int JN = M16 ? 1 : 2;
        constexpr int KS = F == KV::I4 ? 2 : 1;  // k steps a K word
#pragma unroll
        for (int jb = 0; jb < 2; jb += JN) {
          if constexpr (F32) {
            // fp32 q: an accumulator a part for these n-tiles (without M16,
            // hi and mid as rows 0-7 and 8-15 of one); a chunk's K words at
            // a time, q's parts of a k step read once for every n-tile
            constexpr int NP = M16 ? 3 : 2;
            float sq[NP][JN][4] = {};
#pragma unroll
            for (int c = 0; c < NCH; ++c) {
              uint32_t kw[JN][NW];
#pragma unroll
              for (int jn = 0; jn < JN; ++jn)
                k_words<CB>(slot + c * P::CHUNK, row0 + 8 * (jb + jn) + g, t4, kw[jn]);
#pragma unroll
              for (int w = 0; w < NW; ++w) {
                const int W = c * NW + w;
                uint32_t kb[JN][4];
#pragma unroll
                for (int jn = 0; jn < JN; ++jn) k_frag<F>(kw[jn][w], kb[jn]);
#pragma unroll
                for (int e = 0; e < KS; ++e) {
                  uint2 qp[NR][3];
#pragma unroll
                  for (int h = 0; h < NR; ++h)
#pragma unroll
                    for (int p = 0; p < 3; ++p) qp[h][p] = qpart(p, g + 8 * h, KS * W + e);
#pragma unroll
                  for (int jn = 0; jn < JN; ++jn) {
                    const uint32_t* b2 = kb[jn] + 2 * e;
                    if constexpr (M16) {
#pragma unroll
                      for (int p = 0; p < 3; ++p)
                        mma16816_full<TM>(sq[p][jn], qp[0][p].x, qp[1][p].x, qp[0][p].y,
                                          qp[1][p].y, b2);
                    } else {
                      mma16816_full<TM>(sq[0][jn], qp[0][0].x, qp[0][1].x, qp[0][0].y,
                                        qp[0][1].y, b2);
                      mma16816<TM>(sq[1][jn], qp[0][2].x, qp[0][2].y, b2);
                    }
                  }
                }
              }
            }
#pragma unroll
            for (int jn = 0; jn < JN; ++jn)  // (lo + mid) + hi
#pragma unroll
              for (int e = 0; e < 4; ++e)
                sc[jb + jn][e] =
                    M16 ? (sq[2 % NP][jn][e] + sq[1][jn][e]) + sq[0][jn][e]
                        : (sq[1][jn][e & 1] + sq[0][jn][2 + (e & 1)]) + sq[0][jn][e & 1];
          } else {
            // every load of the tile's K words first, then the conversions
            uint32_t kw[JN][NCH][NW];
#pragma unroll
            for (int jn = 0; jn < JN; ++jn)
#pragma unroll
              for (int c = 0; c < NCH; ++c)
                k_words<CB>(slot + c * P::CHUNK, row0 + 8 * (jb + jn) + g, t4, kw[jn][c]);
#pragma unroll
            for (int jn = 0; jn < JN; ++jn) {
#pragma unroll
              for (int c = 0; c < NCH; ++c) {
#pragma unroll
                for (int w = 0; w < NW; ++w) {
                  uint32_t kb[4];
                  k_frag<F>(kw[jn][c][w], kb);
#pragma unroll
                  for (int e = 0; e < KS; ++e)
                    mma_rows<T, M16>(sc[jb + jn], qa[KS * (c * NW + w) + e], kb + 2 * e);
                }
              }
            }
          }
        }
      } else if constexpr (F32P) {
        // 3xTF32, a fresh accumulator every 64 features; lane reads of Q
        // and K at the features s_feat gives them
        const unsigned char* kt = slot;
#pragma unroll
        for (int c0 = 0; c0 < D / 8; c0 += 8) {
          float f[2][4] = {};
#pragma unroll
          for (int kk = c0; kk < c0 + 8; ++kk) {
            const int x = s_feat(kk, t4);
            uint32_t qh[NR][2], ql[NR][2];  // rows g (+ 8): k slots t4, t4 + 4
#pragma unroll
            for (int h = 0; h < NR; ++h) {
              const float2 q2 = lds2(qs + swz32<16>(g + 8 * h, x));
              tc32::split(q2.x, qh[h][0], ql[h][0]);
              tc32::split(q2.y, qh[h][1], ql[h][1]);
            }
#pragma unroll
            for (int jn = 0; jn < 2; ++jn) {
              const float2 k2 = lds2(kt + swz32<TT>(row0 + 8 * jn + g, x));
              uint32_t kh0, kl0, kh1, kl1;
              tc32::split(k2.x, kh0, kl0);
              tc32::split(k2.y, kh1, kl1);
              if constexpr (M16) {
                const uint32_t al[4] = {ql[0][0], ql[1][0], ql[0][1], ql[1][1]};
                const uint32_t ah[4] = {qh[0][0], qh[1][0], qh[0][1], qh[1][1]};
                tc32::mma_tf32(f[jn], al, kh0, kh1);
                tc32::mma_tf32(f[jn], ah, kl0, kl1);
                tc32::mma_tf32(f[jn], ah, kh0, kh1);
              } else {
                // rows 0-7: hi.lo then hi.hi; rows 8-15: lo.hi
                const uint32_t a1[4] = {qh[0][0], 0u, qh[0][1], 0u};
                const uint32_t a2[4] = {qh[0][0], ql[0][0], qh[0][1], ql[0][1]};
                tc32::mma_tf32(f[jn], a1, kl0, kl1);
                tc32::mma_tf32(f[jn], a2, kh0, kh1);
              }
            }
          }
#pragma unroll
          for (int jn = 0; jn < 2; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[jn][e] += M16 ? f[jn][e] : f[jn][2 + (e & 1)] + f[jn][e & 1];
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t kb[4];
          ldsm_x4(kb, swz(k_s, row0 + (mi >> 1) * 8 + lr, 16 * kk + (mi & 1) * 8));
          mma_rows<T, M16>(sc[0], qa[kk], kb);
          mma_rows<T, M16>(sc[1], qa[kk], kb + 2);
        }
      }
      // row g + 8 h's scores (c 2 h, 2 h + 1 of each n-tile): token tok0 + 8
      // j + 2 t4 + e
      const float* scl = reinterpret_cast<const float*>(slot + P::sc_off);
      float ks[4] = {1.f, 1.f, 1.f, 1.f}, vs[4] = {1.f, 1.f, 1.f, 1.f};
      if constexpr (QUANT) {
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const float2 k2 = *reinterpret_cast<const float2*>(scl + row0 + 8 * jn + 2 * t4);
          const float2 v2 = *reinterpret_cast<const float2*>(scl + TT + row0 + 8 * jn + 2 * t4);
          ks[2 * jn] = k2.x;
          ks[2 * jn + 1] = k2.y;
          vs[2 * jn] = v2.x;
          vs[2 * jn + 1] = v2.y;
        }
      }
      float v[NR][4], alph[NR];  // F32P: alpha of row g + 8 h, for the tile's fresh O sum
#pragma unroll
      for (int h = 0; h < NR; ++h) {
        float mx = MFA_MASK;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float y = sc[x >> 1][2 * h + (x & 1)];
          if constexpr (QUANT) y *= ks[x];
          if (a.softcap > 0.f) y = tanhf(y * a.softcap_mul) * a.softcap;
          y *= a.scale_log2e;
          const int tok = tok0 + 8 * (x >> 1) + 2 * t4 + (x & 1);
          if (alibi) y -= rsl[h] * fabsf((float)(rpos[h] - tok));
          if (edge) {
            if ((tok < rlo[h] && tok >= a.sinks) || tok >= rhi[h]) y = MFA_MASK;
          }
          v[h][x] = y;
          mx = fmaxf(mx, y);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float alpha = exp2f(m[h] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          v[h][x] = (edge && v[h][x] == MFA_MASK) ? 0.f : exp2f(v[h][x] - m_new);
          ps += v[h][x];
        }
        m[h] = m_new;
        l[h] = alpha * l[h] + ps;
        if constexpr (F32P) {
          alph[h] = alpha;
        } else {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            acc[j][2 * h] *= alpha;
            acc[j][2 * h + 1] *= alpha;
          }
        }
        if constexpr (QUANT) {  // V scales fold into p; a masked p stays exactly 0
#pragma unroll
          for (int x = 0; x < 4; ++x) v[h][x] = v[h][x] == 0.f ? 0.f : v[h][x] * vs[x];
        }
      }
      if constexpr (F32P) {
        // O += P V in 3xTF32: P of 8-token step j from the S accumulators
        // (k slots t4, t4 + 4 <- tokens 2 t4, 2 t4 + 1), V's rows 2 t4 and
        // 2 t4 + 1 of the step at feature 8 n + g of n-tile n, split as read
        // and zeroed outside the union (a row past the length may hold
        // anything, and 0 * NaN would survive)
        const unsigned char* vt = slot + P::KV_BYTES;
        auto in_u = [&](int u) { return (u >= lo && u < hi) || (u >= sa_lo && u < sa_hi); };
        bool keep[2][2];
        uint32_t ph[2][NR][2], pl[2][NR][2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            keep[j][e] = !edge || in_u(tok0 + 8 * j + 2 * t4 + e);
#pragma unroll
            for (int h = 0; h < NR; ++h) tc32::split(v[h][2 * j + e], ph[j][h][e], pl[j][h][e]);
          }
        constexpr int NC = M16 ? 4 : 8;  // n-tiles of fresh accumulators at once
#pragma unroll
        for (int n0 = 0; n0 < D / 8; n0 += NC) {
          float f[NC][4] = {};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int row = row0 + 8 * j + 2 * t4;
#pragma unroll
            for (int n = 0; n < NC; ++n) {
              const int col = 8 * (n0 + n) + g;
              float x0 = lds1(vt + swz32<TT>(row, col)), x1 = lds1(vt + swz32<TT>(row + 1, col));
              x0 = keep[j][0] ? x0 : 0.f;
              x1 = keep[j][1] ? x1 : 0.f;
              uint32_t vh0, vl0, vh1, vl1;
              tc32::split(x0, vh0, vl0);
              tc32::split(x1, vh1, vl1);
              if constexpr (M16) {
                const uint32_t al[4] = {pl[j][0][0], pl[j][1][0], pl[j][0][1], pl[j][1][1]};
                const uint32_t ah[4] = {ph[j][0][0], ph[j][1][0], ph[j][0][1], ph[j][1][1]};
                tc32::mma_tf32(f[n], al, vh0, vh1);
                tc32::mma_tf32(f[n], ah, vl0, vl1);
                tc32::mma_tf32(f[n], ah, vh0, vh1);
              } else {
                // rows 0-7: hi.lo then hi.hi; rows 8-15: lo.hi
                const uint32_t a1[4] = {ph[j][0][0], 0u, ph[j][0][1], 0u};
                const uint32_t a2[4] = {ph[j][0][0], pl[j][0][0], ph[j][0][1], pl[j][0][1]};
                tc32::mma_tf32(f[n], a1, vl0, vl1);
                tc32::mma_tf32(f[n], a2, vh0, vh1);
              }
            }
          }
#pragma unroll
          for (int n = 0; n < NC; ++n)
#pragma unroll
            for (int e = 0; e < 2 * NR; ++e)
              acc[n0 + n][e] = fmaf(acc[n0 + n][e], alph[e >> 1],
                                    M16 ? f[n][e] : f[n][2 + e] + f[n][e]);
        }
      } else {
        // P rounded to V's dtype: the A fragments of P V, ordered as qa's
        uint32_t pa[2 * NR];
#pragma unroll
        for (int h = 0; h < NR; ++h) {
          pa[h] = pack2<TM>(v[h][0], v[h][1]);
          pa[NR + h] = pack2<TM>(v[h][2], v[h][3]);
        }
        // V fragments of tokens outside the union are zeroed on an edge: b0
        // holds tokens 2 t4, 2 t4 + 1, b1 tokens 2 t4 + 8, 2 t4 + 9
        uint32_t keep0 = 0xffffffffu, keep1 = 0xffffffffu;
        if (edge) {
          const int t = tok0 + 2 * t4;
          auto in_u = [&](int u) { return (u >= lo && u < hi) || (u >= sa_lo && u < sa_hi); };
          keep0 = (in_u(t) ? 0x0000ffffu : 0u) | (in_u(t + 1) ? 0xffff0000u : 0u);
          keep1 = (in_u(t + 8) ? 0x0000ffffu : 0u) | (in_u(t + 9) ? 0xffff0000u : 0u);
        }
        if constexpr (QUANT) {
          // rows 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 of the warp's 16: the
          // k-slots of this thread's B fragments
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
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
              } else if constexpr (CB == 64) {
                const uint2 u =
                    *reinterpret_cast<const uint2*>(vr + swz8<CB>(row, g >> 1) + (g & 1) * 8);
                rw[r][0] = u.x;
                rw[r][1] = u.y;
              } else {
                rw[r][0] = *reinterpret_cast<const uint32_t*>(vr + swz8<CB>(row, 0) + 4 * g);
              }
            }
#pragma unroll
            for (int w = 0; w < CB / 32; ++w) {
              const uint32_t col4[4] = {rw[0][w], rw[1][w], rw[2][w], rw[3][w]};
              uint32_t tr[4];
              transpose4x4(col4, tr);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if constexpr (F == KV::I4) {
                  uint32_t lo4[2], hi4[2];
                  i4x8_tokens_to_bf16(tr[e], lo4, hi4);
                  const int j = c * (CB / 4) + 8 * w + 2 * e;
                  mma_rows<TM, M16>(acc[j], pa, lo4);
                  mma_rows<TM, M16>(acc[j + 1], pa, hi4);
                } else {
                  uint32_t vb[2];
                  if constexpr (F == KV::E4M3) {
                    e4m3x4_to_bf16(tr[e], vb[0], vb[1]);
                    if (edge) {  // the one format with NaN codes (converted finite)
                      vb[0] &= keep0;
                      vb[1] &= keep1;
                    }
                  } else {
                    i8x4_to_bf16(tr[e], vb[0], vb[1]);
                  }
                  mma_rows<TM, M16>(acc[4 * (c * (CB / 32) + w) + e], pa, vb);
                }
              }
            }
          }
        } else {
#pragma unroll
          for (int j2 = 0; j2 < D / 16; ++j2) {
            uint32_t vb[4];
            ldsm_x4_t(vb, swz(v_s, row0 + (mi & 1) * 8 + lr, 8 * (2 * j2 + (mi >> 1))));
            vb[0] &= keep0;
            vb[2] &= keep0;
            vb[1] &= keep1;
            vb[3] &= keep1;
            mma_rows<T, M16>(acc[2 * j2], pa, vb);
            mma_rows<T, M16>(acc[2 * j2 + 1], pa, vb + 2);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty<STAGES>(bars, s));
  }

  // Merge the consumer warps' (m, l, O) of the block's rows: O = sum_w
  // 2^(m_w - M) O_w / sum_w 2^(m_w - M) l_w with M the largest m_w.
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  named_sync(1, 32 * CWARPS);  // no warp reads the ring any more
  float* mo = reinterpret_cast<float*>(smem);  // [CWARPS][ROWS][D]
  float* ml = reinterpret_cast<float*>(smem + P::template ml_off<ROWS>);  // [CWARPS][2][ROWS]
#pragma unroll
  for (int h = 0; h < NR; ++h) {
    float* orow = mo + (cw * ROWS + g + 8 * h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if constexpr (QUANT) {
        orow[merge_col<CB, true>(g, quant_col<F, CB>(j, 2 * t4))] = acc[j][2 * h];
        orow[merge_col<CB, true>(g, quant_col<F, CB>(j, 2 * t4 + 1))] = acc[j][2 * h + 1];
      } else {
        *reinterpret_cast<float2*>(orow + merge_col<CB, false>(g, 8 * j + 2 * t4)) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
    if (t4 == 0) {
      ml[cw * 2 * ROWS + g + 8 * h] = m[h];
      ml[cw * 2 * ROWS + ROWS + g + 8 * h] = l[h];
    }
  }
  named_sync(1, 32 * CWARPS);
  const bool final_out = a.num_splits == 1;  // O in T and the LSE
  const int dw = a.dw;
  for (int idx = threadIdx.x - 32; idx < nrows * D; idx += 32 * CWARPS) {
    // D, not dw, in the index arithmetic: a division by a run-time dw here
    // cost up to 7% of an 8B decode step's kernel 6 (scripts/time_paged_span.py)
    const int r = idx / D, x = idx % D, xs = merge_col<CB, QUANT>(r, x);
    if (x >= dw) continue;  // O's columns past dw are not stored
    float mm = MFA_MASK;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) mm = fmaxf(mm, ml[w * 2 * ROWS + r]);
    float ls = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) {
      const float wt = exp2f(ml[w * 2 * ROWS + r] - mm);
      ls += wt * ml[w * 2 * ROWS + ROWS + r];
      o += wt * mo[(w * ROWS + r) * D + xs];
    }
    const bool empty = ls == 0.f;
    const float lsafe = (empty || isnan(ls)) ? 1.f : ls;
    const float lse = empty ? -INFINITY : mm * MFA_LN2 + logf(lsafe);
    // row r0 + r of the (batch, kv head): span position si, group row gi
    const int rr = r0 + r, si = M16 ? rr / G : 0, gi = M16 ? rr % G : rr;
    if (final_out) {
      const size_t orow = ((size_t)b * span + si) * a.hq + (size_t)hk * G + gi;
      static_cast<T*>(a.out)[orow * dw + x] = from_float<T>(o / lsafe);
      if (x == 0 && a.lse_out != nullptr) a.lse_out[orow] = lse;
    } else {
      const size_t prow = (((size_t)b * a.hkv + hk) * a.num_splits + split) * R + rr;
      a.o_part[prow * dw + x] = o / lsafe;
      if (x == 0) a.lse_part[prow] = lse;
    }
  }
  if (final_out) return;
  // Every block gets here, whatever its split held (no tile, lengths short
  // of the split, a window that empties it: its partial is O = 0, LSE =
  // -inf): a block that left before its ticket would leave the counter
  // short for the next launch. The ticket goes after this block's partial
  // is in L2; the block that takes the last one merges.
  __threadfence();
  named_sync(1, 32 * CWARPS);  // every partial stored, and mo / ml free
  int* last = reinterpret_cast<int*>(ml);
  if (threadIdx.x == 32) {
    const int row_blocks = M16 ? (R + 15) / 16 : 1;
    int* ctr = a.counters + ((size_t)b * a.hkv + hk) * row_blocks + r0 / 16;
    const int ticket = atomicAdd(ctr, 1);
    if (ticket == a.num_splits - 1) {
      *ctr = 0;  // every split is in: zero for the next launch or graph replay
      __threadfence();
    }
    *last = ticket == a.num_splits - 1;
  }
  named_sync(1, 32 * CWARPS);
  if (*last)
    merge_splits<T, D, ROWS, 32 * CWARPS, M16>(a, b, hk, r0, nrows, span, smem,
                                                P::template stage_off<ROWS>, P::bar_off);
}

// Encode the K and V maps and launch (a contiguous cache k, v [b, hkv, S,
// dw], or the page pools [hkv, P, page, w] with w = dw, or dw / 2 bytes
// for int4), in boxes of the template's D. Returns a cudaError_t code,
// MFA_TMA_ENCODE, or 0.
template <typename T, int D, bool PAGED, KV F, bool M16 = false>
int launch(const void* k, const void* v, const Args& args, int batch, cudaStream_t stream) {
  constexpr bool F32 = std::is_same<T, float>::value;
  using P = Plan<D, F, F32>;
  constexpr bool BF = kIsBf16<T>, QUANT = P::QUANT;
  if (args.dw <= 0 || args.dw > D) return MFA_BAD_CONFIG;
  Args a = args;
  a.box_rows = a.box_rows < P::TT ? a.box_rows : P::TT;  // gcd(page, TT): both powers of two
  a.k_pages = k;
  a.v_pages = v;
  const CUtensorMapDataType type =
      QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8
            : F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                  : (BF ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16);
  CUtensorMap tk, tv;
  if constexpr (PAGED) {
    const int w = F == KV::I4 ? a.dw / 2 : a.dw;  // elements of a stored row
    const size_t row_bytes = QUANT ? w : (size_t)P::EB * w;
    const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)a.page_size,
                                (cuuint64_t)a.hkv * a.num_pages};
    const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)a.page_size * row_bytes};
    const cuuint32_t box[3] = {QUANT ? (cuuint32_t)P::CB : (cuuint32_t)P::CE,
                               (cuuint32_t)a.box_rows, 1};
    const CUtensorMapSwizzle sw = P::CB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : P::CB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_NONE;
    if (int err = mfa_encode(&tk, k, type, 3, dims, strides, box, sw)) return err;
    if (int err = mfa_encode(&tv, v, type, 3, dims, strides, box, sw)) return err;
  } else {
    // S == 0: no tile is ever loaded; the maps only need a valid base
    const bool kv = a.S > 0;
    const int rows = kv ? a.S : 1, planes = kv ? batch * a.hkv : 1;
    const size_t row_bytes = (size_t)P::EB * a.dw;
    if (int err = mfa_encode_3d(&tk, kv ? k : a.q, type, a.dw, rows, planes, row_bytes,
                                rows * row_bytes, P::CE, P::TT))
      return err;
    if (int err = mfa_encode_3d(&tv, kv ? v : a.q, type, a.dw, rows, planes, row_bytes,
                                rows * row_bytes, P::CE, P::TT))
      return err;
  }
  auto kern = splitkv_kernel<T, D, PAGED, F, M16>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  const int row_blocks = M16 ? (a.q_span * a.group + 15) / 16 : 1;
  const dim3 grid(a.num_splits * row_blocks, a.hkv, batch);
  kern<<<grid, P::THREADS, P::bytes, stream>>>(tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace kd90
