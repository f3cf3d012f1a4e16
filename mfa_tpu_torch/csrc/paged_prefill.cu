// Paged prefill for Hopper (sm_90a): query chunks against a paged KV cache,
// read in place through the block table.
//
// Replaces mfa_tpu/kernels/paged_prefill.py:_body (paged_prefill_attention):
// chunked prefill, prefix-cache suffixes and the paged route of the varlen
// entry point. Query row r of sequence b sits at absolute position
// q_start[b] + r and sees columns c with
//     c <  lens[b]                      (cache bound, chunk included)
//     c <= q_start[b] + r + wr          (band end; causal is wr == 0)
//     c >= q_start[b] + r - wl          (sliding window)
//         or c < sinks                  (StreamingLLM sinks, with a window)
// (wl/wr = -1: unbounded). Rows r >= q_lens[b] store O = 0, LSE = -inf.
// ALiBi subtracts slope_h / scale * |q_start[b] + r - c| from the raw score
// of q head h (the chunk's absolute positions, paged_prefill.py:456-462).
// A warpgroup's tiles are the sink tiles [0, nsink) then its band's, no
// tile twice (fa90::Span), and the block loads their union.
//
// Bound: tensor-core operations at chunk sizes (4 D flops per visible
// (row, column) pair of every q head, against each row's pages read once).
// The design is the warp-specialised block of flash_fwd_sm90.cuh:
//  - A block of 384 threads owns 2 wpos chunk positions of one (sequence,
//    kv head, head chunk), wpos = 64 / hc (rounded down), hc = min(group,
//    64) q heads a position. Warpgroup 0 is the producer (one warp: TMA and
//    the block table; setmaxnreg hands its registers to the consumers);
//    consumer warpgroup w owns positions [t0 + w wpos, + wpos) as packed
//    rows: its row r is position t0 + w wpos + r / hc of q head hk * group
//    + h0 + r % hc, so every K/V tile it stages serves all q heads of the
//    kv head (the TPU kernel's [group, bq] rows, position-major). Up to
//    group 64 there is one head chunk (h0 = 0, hc = group); above it a
//    warpgroup holds 64 q heads of one position and the grid takes
//    ceil(group / 64) head chunks (h0 = 64 c), each reading the K/V tiles
//    again (Falcon-7B's group 71: 2 chunks). Rows r >= wpos * hc (64 % group
//    of them: 1 at group 7, 4 at groups 5 and 6) and rows of the last
//    chunk past the group (57 at group 71) are a dead tail (tail_row):
//    wgmma rows are independent, so whatever their shared memory holds
//    reaches only their own accumulators; they are never stored, and the
//    masking decisions (all_live, needs_mask) look at the live positions
//    only.
//  - Q is one TMA box a 64-column chunk of a 4-D map over q [b, sq, hq, D]
//    (64 columns x hc heads x 2 wpos positions) when hc divides 64, else
//    one box a warpgroup (x wpos positions, at the warpgroup's 64-row
//    offset): it lands as the packed rows in the 128-byte swizzle wgmma
//    reads. A last head chunk's box reaches past the group into the next
//    kv head's heads (or past hq: zeros), which only tail rows hold.
//  - K and V come by TMA into a ring of BN-key tiles (128; 64 at D 256,
//    Plan) through the block table, in boxes of R = gcd(page, BN) rows (1
//    at an odd page; a box never straddles a page) of a map over the pages
//    [hkv, P, page, D] as (D, page, hkv * P); the producer warp loads the
//    table 32 entries at a time and each lane issues every 32nd box. The
//    TMA's 128-byte swizzle follows the shared-memory address, so 16-bit
//    boxes of fewer than 8 rows tile its atoms as one 8-row box does.
//    Page ids are clamped into the pool, as the plain version clamps them;
//    no box is issued for rows at or past lens. Rows past lens inside a
//    loaded page, or left over in the slot, may hold anything: K's columns
//    are masked, V's rows are zeroed in shared memory before P V (p = 0
//    there, but 0 * NaN survives P V).
//  - 16-bit pages feed wgmma from the TMA slot as kernel 1 does. Quantized
//    pages (int8, fp8 e4m3, or int4 rows of D / 2 bytes: feature 2c in
//    byte c's low nibble, 2c + 1 in its high one) come unswizzled into a
//    staging slot, their fp32 row scales beside them by bulk copies (boxes
//    of fewer than 4 rows by cp.async from the producer lanes instead, 16
//    bytes and 4-byte scales, completing on the slot's full barrier: the
//    TMA writes only 128-byte-aligned shared memory, bulk copies 16-byte
//    runs); the
//    256 consumer threads convert the payload exactly to bf16 (wgmma.cuh:
//    i8x4_to_bf16, e4m3x4_to_bf16, i4x8_to_bf16) into one
//    128-byte-swizzled K/V buffer (every load of a
//    thread issued before its first conversion) and copy the scales beside
//    it (zeros past lens), fence the writes to the async proxy and meet at
//    a named barrier before wgmma reads them; the staging slot is released
//    at once, so the ring's next load overlaps the tile's products. K
//    scales multiply the score columns before the log2 scale; V scales
//    fold into p after the row sum and before p is rounded for P V
//    (mfa_tpu/kernels/paged_prefill.py). At the 8B chunk batch on an H100
//    (scripts/time_paged_blockmask.py) int8 pages take 0.27 ms where bf16
//    pages take 0.17; two converted buffers with one barrier a tile (one
//    staging slot at D 128) were no faster on pages of 64 and 16% slower
//    on pages of 16.
//  - Each consumer warpgroup visits only the tiles its own live rows can
//    see ([row_lo, row_hi) of the TPU kernel's _row_lo/_row_hi) and masks
//    element by element only the tiles that cross lens, a band edge or a
//    dead row. A block with no live row stores its zeros and leaves; blocks
//    launch last q tiles first.
//
// Rows are dw features wide (Params::dw <= D): q and O at dw, the page maps
// encoded at the stored row width (dw, or dw / 2 bytes for int4), so TMA
// fills each box's columns past it with zeros, inert in Q K^T and P V (a
// zero byte converts to 0 in every page format); O's columns past dw are
// never stored.
//
// Numerics: kernel 1's classic online softmax (flash_fwd_sm90.cuh); a row
// that sees no column keeps m == MASK and stores O = 0, LSE = -inf.
//
// fp32 q (MFA_F32, af32::paged_prefill_kernel below) runs
// the 64-row tensor-core tile of flash_fwd_f32.cuh (3xTF32) on fp32 pages,
// or on int8 / fp8 / int4 pages with q . k in fp32 against the payload
// values (two TF32 passes: the values are exact) and p rounded to bf16 for
// one exact bf16 P V product (mfa_tpu/kernels/paged_prefill.py:440-441
// keeps fp32 q): 64 rows a block, the same packed rows (64 / group positions
// of every q head of one kv head), each tile's page rows copied through the
// block table by cp.async, bytes converted once a tile in shared memory.
#include "flash_fwd_f32.cuh"

namespace pp90 {

using fa90::BM;
using fa90::Span;
using fa90::THREADS;
using fa90::WG_M;
constexpr int STAGES = 2;   // ring slots
constexpr int BAR_CVT = 1;  // named barrier of the 256 consumer threads (quantized)

struct Params {
  const int* lens;      // [b] visible KV length
  const int* q_start;   // [b] absolute position of q row 0
  const int* q_lens;    // [b] real q rows
  const int* table;     // [b, pps]
  const float* k_scale;  // [hkv, P, page] or null
  const float* v_scale;
  void* out;   // [b, sq, hq, dw]
  float* lse;  // [b, hq, sq]
  int sq, hq, hkv, group, num_pages, page_size, pps, box_rows, wl, wr;
  float scale_log2e, softcap, softcap_mul;
  int hc;       // q heads of a position in a warpgroup's rows: min(group, WG_M)
  int nchunks;  // head chunks of a kv head: ceil(group / WG_M) (a grid axis)
  int wpos;     // chunk positions a consumer warpgroup: WG_M / hc
  int q_boxes;  // Q boxes a 64-column chunk: 1 if hc divides WG_M, else 2
  int sinks;             // with a left window: columns < sinks stay visible (else 0)
  const float* slopes;   // ALiBi [hq] in the raw score domain (slope / scale), or null
  int dw;                // features of a q, O and stored K/V row (<= D)
  // the page pools (quantized boxes of fewer than 4 rows are copied by
  // cp.async from them; else only the tensor maps read them)
  const void* k_pages;
  const void* v_pages;
};

// Packed row r (0-63) of a warpgroup in the head chunk from q head h0
// holds head h0 + r % hc (of the kv head's group) at chunk position
// offset r / hc. Rows past wpos * hc, or whose head is past the group (the
// last chunk of a group above 64), are the dead tail.
__device__ __forceinline__ bool tail_row(const Params& p, int h0, int r) {
  return r >= p.wpos * p.hc || h0 + r % p.hc >= p.group;
}

// Shared memory: Q [D/64][BM][64]; STAGES ring slots, each K then V
// [D/64][BN][64] as stored (16-bit pages), or quantized K [BN][RB], V
// [BN][RB] (RB bytes a row), K scales [BN], V scales [BN]; for quantized
// pages one converted buffer of bf16 K, V (swizzled like a 16-bit slot)
// and the tile's scales; the barriers (Q, full[STAGES], empty[STAGES]).
// Every swizzled chunk is 1024-byte aligned. BN = 128 keys a tile, 64 at
// D 256 (kernel 1's rule, flash_fwd_sm90.cuh): 128 keys there would take
// 64 KB of Q and two slots of 128 KB (bf16), or staging plus a 128 KB
// converted buffer (quantized), past the 227 KB of a block; at 64 the O
// accumulator is 128 fp32 registers a thread, as in kernel 1.
template <int D, KV F>
struct Plan {
  static constexpr bool QUANT = F != KV::F16;
  static constexpr int BN = D > 128 ? 64 : 128;       // keys a tile
  static constexpr int RB = F == KV::I4 ? D / 2 : D;  // bytes of a quantized row
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t TILE16 = BN * D * 2;  // one 16-bit K or V tile
  static constexpr uint32_t SCALES = 2 * BN * 4;  // a tile's K and V scales
  // a slot rounded up to the swizzle's 1024-byte alignment
  static constexpr uint32_t SLOT =
      ((QUANT ? 2 * BN * RB + SCALES : 2 * TILE16) + 1023) / 1024 * 1024;
  static constexpr uint32_t ring_off = Q_BYTES;
  static constexpr uint32_t cvt_off = ring_off + STAGES * SLOT;
  static constexpr uint32_t bar_off = cvt_off + (QUANT ? 2 * TILE16 + SCALES : 0);
  static constexpr size_t used = bar_off + 8 * (1 + 2 * STAGES) + 1024;  // + 1 KB to align
  // at least 120 KB, so that two blocks never share an SM (their setmaxnreg
  // requests could not both be met)
  static constexpr size_t bytes = used > 120 * 1024 ? used : 120 * 1024;
};

__device__ __forceinline__ uint32_t bar_q(uint32_t bars) { return bars; }
__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) { return bars + 8 * (1 + s); }
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (1 + STAGES + s);
}

// KV tiles of bn keys that the live rows among chunk positions [ta, ta +
// n) see: the sink tiles [0, nsink) and the band [first, last] (first >
// last: no band).
__device__ __forceinline__ Span span_of(int ta, int n, int q_len, int q_start, int sk, int wl,
                                        int wr, int bn, int sinks) {
  const Span none{1, 0};
  if (ta >= q_len) return none;
  const int tb = min(ta + n, q_len) - 1;  // last live position
  int hi = sk;                            // columns [lo, hi)
  if (wr >= 0) hi = min(hi, q_start + tb + wr + 1);
  const int lo = wl >= 0 ? max(0, q_start + ta - wl) : 0;
  const int sh = wl >= 0 ? min(sinks, hi) : 0;  // sink columns [0, sh)
  Span s = hi <= lo ? none : Span{lo / bn, (hi - 1) / bn};
  if (sh > 0) s.nsink = hi <= lo ? (sh + bn - 1) / bn : min((sh + bn - 1) / bn, s.first);
  return s;
}

// The 256 consumer threads (ctid) convert the quantized slot into a bf16
// buffer: one 64-column chunk row is UC 16-byte units (4 of 16 values, or
// 2 of 32 int4 values), rows in the order of the 128-byte swizzle's atoms,
// every load issued before the first conversion; rows at or past sk become
// zeros (the zero byte is 0 in every format), and so do their scales.
template <int D, KV F>
__device__ __forceinline__ void convert_tile(const unsigned char* slot, unsigned char* cvt,
                                             int kv0, int sk, int ctid) {
  using PL = Plan<D, F>;
  constexpr int RB = PL::RB, BN = PL::BN;
  constexpr int UC = F == KV::I4 ? 2 : 4;  // 16-byte units of a 64-column chunk row
  constexpr int UNITS = BN * RB / 16;      // 16-byte units of one tile
  constexpr int PER = 2 * UNITS / 256;     // K's and V's units a thread
  uint4 raw[PER];
#pragma unroll
  for (int x = 0; x < PER; ++x) {
    const int u = ctid + 256 * x, r = u % UNITS, row = (r / UC) % BN;
    raw[x] = kv0 + row < sk ? *reinterpret_cast<const uint4*>(
                                  slot + (u / UNITS) * BN * RB + row * RB +
                                  (r / (BN * UC)) * (16 * UC) + (r % UC) * 16)
                            : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int x = 0; x < PER; ++x) {
    const int u = ctid + 256 * x, r = u % UNITS;  // u / UNITS: 0 K, 1 V
    const int ch = r / (BN * UC), row = (r / UC) % BN, qd = r % UC;
    unsigned char* dst = cvt + (u / UNITS) * PL::TILE16 + ch * (BN * 128) + row * 128;
    const uint32_t wd[4] = {raw[x].x, raw[x].y, raw[x].z, raw[x].w};
    if constexpr (F == KV::I4) {  // a word: 8 values, one 16-byte unit of bf16
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t o[4];
        i4x8_to_bf16(wd[e], o);
        *reinterpret_cast<uint4*>(dst + (((4 * qd + e) ^ (row & 7)) << 4)) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    } else {
      uint4 o0, o1;
      if constexpr (F == KV::E4M3) {
        e4m3x4_to_bf16(wd[0], o0.x, o0.y);
        e4m3x4_to_bf16(wd[1], o0.z, o0.w);
        e4m3x4_to_bf16(wd[2], o1.x, o1.y);
        e4m3x4_to_bf16(wd[3], o1.z, o1.w);
      } else {
        i8x4_to_bf16(wd[0], o0.x, o0.y);
        i8x4_to_bf16(wd[1], o0.z, o0.w);
        i8x4_to_bf16(wd[2], o1.x, o1.y);
        i8x4_to_bf16(wd[3], o1.z, o1.w);
      }
      *reinterpret_cast<uint4*>(dst + (((2 * qd) ^ (row & 7)) << 4)) = o0;
      *reinterpret_cast<uint4*>(dst + (((2 * qd + 1) ^ (row & 7)) << 4)) = o1;
    }
  }
  // one scale a thread: K's BN, then V's BN
  const float* src = reinterpret_cast<const float*>(slot + 2 * BN * RB);
  if (ctid < 2 * BN)
    reinterpret_cast<float*>(cvt + 2 * PL::TILE16)[ctid] =
        kv0 + (ctid % BN) < sk ? src[ctid] : 0.f;
}

// One consumer warpgroup (w, thread wtid of 128) over its 64 packed rows:
// the KV loop over the block's tiles (nsink sink tiles, then the band from
// `first`: n_tiles in all), computing those of `mine`, then O and LSE of
// its live rows < sq.
template <typename T, KV F, int D>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, int first,
                                        int n_tiles, int nsink, Span mine, int w, int wtid,
                                        int b, int hk, int h0, int t0, int q_len, int q_start,
                                        int sk) {
  using PL = Plan<D, F>;
  constexpr bool QUANT = PL::QUANT;
  constexpr int BN = PL::BN;
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + PL::bar_off;
  const uint32_t q_wg = base + w * WG_M * 128;  // this warpgroup's rows of each Q chunk
  const int lane = wtid & 31, g = lane >> 2, t4 = lane & 3;
  const int group = p.group, hc = p.hc, wpos = p.wpos;
  const int tw = t0 + w * wpos;                   // the warpgroup's first chunk position
  const int r0 = (wtid >> 5) * 16 + g;            // this thread's packed rows: r0, r0 + 8
  // their chunk positions; a tail row's lies past every chunk, so it is
  // never live and never stored (a separate tail flag, kept to the
  // epilogue, spilled 8 bytes in the d 256 int8 and fp8 instantiations at
  // their 168-register budget: scripts/ptxas_report.py)
  constexpr int NOWHERE = 1 << 29;
  const int tr0 = tail_row(p, h0, r0) ? NOWHERE : tw + r0 / hc;
  const int tr1 = tail_row(p, h0, r0 + 8) ? NOWHERE : tw + (r0 + 8) / hc;
  const bool live0 = tr0 < q_len, live1 = tr1 < q_len;
  const int pos0 = q_start + tr0, pos1 = q_start + tr1;
  const int pos_lo = q_start + tw, pos_hi = pos_lo + wpos - 1;
  const bool all_live = tw + wpos <= q_len;
  const int wl = p.wl, wr = p.wr, sinks = p.sinks;
  const float c = p.scale_log2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = MFA_MASK, m1 = MFA_MASK;  // running max, raw score domain
  float l0 = 0.f, l1 = 0.f;            // this thread's partial row sums

  mbar_wait(bar_q(bars), 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int jt = fa90::tile_at(i, nsink, first), s = i % STAGES, kv0 = jt * BN;
    mbar_wait(bar_full(bars, s), (i / STAGES) & 1);
    unsigned char* slot = smem + PL::ring_off + s * PL::SLOT;
    unsigned char* kv = slot;  // 16-bit K then V, swizzled
    if constexpr (QUANT) {
      kv = smem + PL::cvt_off;
      named_sync(BAR_CVT, 256);  // the buffer's readers of the last tile are done
      convert_tile<D, F>(slot, kv, kv0, sk, w * 128 + wtid);
      fence_async_smem();
      named_sync(BAR_CVT, 256);
      mbar_arrive(bar_empty(bars, s));  // the staging slot is free
    }
    if (fa90::in_span(jt, mine)) {
      const uint32_t k_s = smem_u32(kv), v_s = k_s + PL::TILE16;
      if constexpr (!QUANT) {
        if (kv0 + BN > sk) {
          // V rows past lens -> zeros (both warpgroups may write the same
          // zeros; each reads them only after its own writes)
          const int z0 = sk - kv0;
          for (int u = wtid; u < (BN - z0) * (D / 8); u += 128) {
            const int row = z0 + u / (D / 8), ch = (u % (D / 8)) >> 3, unit = u & 7;
            *reinterpret_cast<uint4*>(kv + PL::TILE16 + ch * (BN * 128) + row * 128 +
                                      unit * 16) = make_uint4(0u, 0u, 0u, 0u);
          }
          fence_async_smem();
          named_sync(2 + w, 128);
        }
      }

      // S = Q K^T: D / 16 steps, 32 bytes apart inside a 64-column chunk.
      float sc[BN / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t qa = q_wg + (kk >> 2) * (BM * 128) + (kk & 3) * 32;
        const uint32_t kb = k_s + (kk >> 2) * (BN * 128) + (kk & 3) * 32;
        wgmma_ss<T, BN>(sc, sw128_desc(qa, 0), sw128_desc(kb, 0), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(sc);

      const float* scl = reinterpret_cast<const float*>(kv + 2 * PL::TILE16);  // quantized: K, V scales
      if constexpr (QUANT) {  // K scales on the score columns
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 ks = *reinterpret_cast<const float2*>(scl + 8 * j + 2 * t4);
          sc[4 * j] *= ks.x;
          sc[4 * j + 1] *= ks.y;
          sc[4 * j + 2] *= ks.x;
          sc[4 * j + 3] *= ks.y;
        }
      }
      if (p.softcap > 0.f) {
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) sc[x] = tanhf(sc[x] * p.softcap_mul) * p.softcap;
      }
      if (p.slopes != nullptr) {  // raw domain: - slope / scale * |position - column|
        // the slopes of the thread's rows' q heads, loaded here so that they
        // hold no register through the loop without ALiBi
        // (a tail row reads a live head's slope: past the group lies
        // another kv head's, or past hq nothing)
        const float sl0 = p.slopes[hk * group + min(h0 + r0 % hc, group - 1)];
        const float sl1 = p.slopes[hk * group + min(h0 + (r0 + 8) % hc, group - 1)];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + 8 * j + 2 * t4 + (e & 1);
            sc[4 * j + e] -= ((e >> 1) ? sl1 : sl0) * fabsf((float)(((e >> 1) ? pos1 : pos0) - col));
          }
        }
      }
      // Mask only tiles that cross lens, a band edge or a dead row.
      const bool needs_mask = !all_live || (kv0 + BN > sk) ||
                              (wr >= 0 && kv0 + BN - 1 > pos_lo + wr) ||
                              (wl >= 0 && kv0 < pos_hi - wl);
      if (needs_mask) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + 8 * j + 2 * t4 + (e & 1);
            const int pos = (e >> 1) ? pos1 : pos0;
            bool ok = ((e >> 1) ? live1 : live0) && col < sk;
            if (wr >= 0) ok = ok && col <= pos + wr;
            if (wl >= 0) ok = ok && (col >= pos - wl || col < sinks);
            if (!ok) sc[4 * j + e] = MFA_MASK;
          }
        }
      }

      // online softmax: each row is spread over the 4 threads of a quad
      float mx0 = MFA_MASK, mx1 = MFA_MASK;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = exp2f((m0 - mn0) * c), alpha1 = exp2f((m1 - mn1) * c);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        sc[4 * j] = exp2f((sc[4 * j] - mn0) * c);
        sc[4 * j + 1] = exp2f((sc[4 * j + 1] - mn0) * c);
        sc[4 * j + 2] = exp2f((sc[4 * j + 2] - mn1) * c);
        sc[4 * j + 3] = exp2f((sc[4 * j + 3] - mn1) * c);
        ps0 += sc[4 * j] + sc[4 * j + 1];
        ps1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = alpha0 * l0 + ps0;
      l1 = alpha1 * l1 + ps1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
      if constexpr (QUANT) {  // V scales fold into p (zeros past lens)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float2 vs = *reinterpret_cast<const float2*>(scl + BN + 8 * j + 2 * t4);
          sc[4 * j] *= vs.x;
          sc[4 * j + 1] *= vs.y;
          sc[4 * j + 2] *= vs.x;
          sc[4 * j + 3] *= vs.y;
        }
      }

      // P in registers: 16 columns of S are one A fragment of P V.
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kc][x] = pack2<T>(sc[8 * kc + 2 * x], sc[8 * kc + 2 * x + 1]);
      }
      // O += P V: 16 keys a step, 16 rows = 2048 bytes of every V chunk.
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        wgmma_rs<T, D>(acc, pa[kc], sw128_desc(v_s + kc * 2048, BN * 128), 1);
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
    }
    if constexpr (!QUANT) mbar_arrive(bar_empty(bars, s));
  }

  // Epilogue: full row sums, dead-row guard, store O and LSE of rows < sq.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ms[2] = {m0, m1}, ls[2] = {l0, l1};
  const int trs[2] = {tr0, tr1};
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int t = trs[x], h = hk * group + h0 + (r0 + 8 * x) % hc;
    if (t >= p.sq) continue;  // past the chunk, or a tail row
    const float m = ms[x], l = ls[x];
    const bool dead = m <= MFA_MASK * 0.5f || l == 0.f;
    const float inv = dead ? 0.f : 1.f / (isnan(l) ? 1.f : l);
    T* orow = out + (((size_t)b * p.sq + t) * p.hq + h) * p.dw;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float o0 = dead ? 0.f : acc[4 * j + 2 * x] * inv;
      const float o1 = dead ? 0.f : acc[4 * j + 2 * x + 1] * inv;
      if (8 * j + 2 * t4 < p.dw)  // columns past dw are not O's
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) = pack2<T>(o0, o1);
    }
    if (p.lse != nullptr && t4 == 0)
      p.lse[((size_t)b * p.hq + h) * p.sq + t] =
          dead ? -INFINITY : m * c * MFA_LN2 + logf(isnan(l) ? 1.f : l);
  }
}

// Grid (hkv x head chunks, batch, ceil(sq / (2 wpos))).
template <typename T, KV F, int D>
__global__ void __launch_bounds__(THREADS, 1)
    paged_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const Params p) {
  using PL = Plan<D, F>;
  constexpr bool QUANT = PL::QUANT;
  constexpr int RB = PL::RB, BN = PL::BN;
  const int hk = blockIdx.x / p.nchunks, b = blockIdx.y;
  const int h0 = (blockIdx.x % p.nchunks) * WG_M;  // the head chunk's first q head
  const int qt = gridDim.z - 1 - blockIdx.z;  // last (longest) q tiles first
  const int group = p.group, hc = p.hc, wpos = p.wpos;
  const int t0 = qt * 2 * wpos;  // the block's first chunk position
  const int q_len = min(max(p.q_lens[b], 0), p.sq);
  if (t0 >= q_len) {
    // no live row: O = 0 and LSE = -inf for the rows < sq, nothing loaded
    // (packed row i: warpgroup i / WG_M, its row i % WG_M)
    T* out = static_cast<T*>(p.out);
    const int units = p.dw / 8;  // 16-byte units of an O row
    for (int u = threadIdx.x; u < BM * units; u += THREADS) {
      const int i = u / units, r = i % WG_M;
      const int t = t0 + (i / WG_M) * wpos + r / hc, h = hk * group + h0 + r % hc;
      T* orow = out + (((size_t)b * p.sq + t) * p.hq + h) * p.dw;
      if (!tail_row(p, h0, r) && t < p.sq)
        *reinterpret_cast<uint4*>(orow + (u % units) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = threadIdx.x; i < BM; i += THREADS) {
      const int r = i % WG_M;
      const int t = t0 + (i / WG_M) * wpos + r / hc, h = hk * group + h0 + r % hc;
      if (!tail_row(p, h0, r) && t < p.sq && p.lse != nullptr)
        p.lse[((size_t)b * p.hq + h) * p.sq + t] = -INFINITY;
    }
    return;
  }
  const int q_start = p.q_start[b];
  const int sk = min(p.lens[b], p.pps * p.page_size);
  const Span s0 = span_of(t0, wpos, q_len, q_start, sk, p.wl, p.wr, BN, p.sinks);
  const Span s1 = span_of(t0 + wpos, wpos, q_len, q_start, sk, p.wl, p.wr, BN, p.sinks);
  int first = s0.first, last = s0.last;
  if (s0.first > s0.last) {
    first = s1.first;
    last = s1.last;
  } else if (s1.first <= s1.last) {
    first = min(first, s1.first);
    last = max(last, s1.last);
  }
  // the sink tiles ahead of the band; the band starts past them
  const int nsink = max(s0.nsink, s1.nsink);
  first = max(first, nsink);
  const int n_tiles = nsink + max(0, last - first + 1);

  extern __shared__ __align__(16) unsigned char pp90_smem[];
  unsigned char* smem = pp90_smem + ((1024u - (smem_u32(pp90_smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + PL::bar_off;
  const int R = p.box_rows;
  // quantized boxes of R < 4 rows come by cp.async from the producer warp's
  // 32 lanes (the TMA writes only 128-byte-aligned shared memory: 1 row of
  // 64 bytes, or 2 of 32, is not; bulk copies of scales need 16-byte runs),
  // each arriving on the full barrier besides the TMA's announcing arrival
  const bool cp_box = QUANT && R < 4;
  if (threadIdx.x == 0) {
    mbar_init(bar_q(bars), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(bars, s), cp_box ? 33 : 1);
      mbar_init(bar_empty(bars, s), 2 * 128);  // every consumer thread releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warp-uniform by construction (a shuffle from lane 0), as setmaxnreg's
  // .sync.aligned form needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg == 0) {
    regs_dec<fa90::PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        // Q: per 64-column chunk, q_boxes boxes of (2 / q_boxes) wpos
        // positions of hc heads from the chunk's first, box qb at the
        // packed row qb * WG_M
        const int qpos = 2 * wpos / p.q_boxes;
        mbar_expect_tx(bar_q(bars), (D / 64) * 2 * wpos * hc * 128);
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch)
          for (int qb = 0; qb < p.q_boxes; ++qb)
            tma_load_4d(base + ch * (BM * 128) + qb * (WG_M * 128), &tq, bar_q(bars), ch * 64,
                        hk * group + h0, t0 + qb * qpos, b);
      }
      // K and V: lane l issues boxes l, l + 32, ... of a tile and holds the
      // pool page of table entry id0 + l, reloaded 32 entries at a time
      // (32 boxes of R rows, R dividing the page, span at most 32 pages)
      const int* tbl = p.table + (size_t)b * p.pps;
      const int page = p.page_size, last_pi = (sk - 1) / page;
      // bytes of one box of K and V (quantized: payload rows and their scales)
      const uint32_t box_bytes = cp_box ? 0 : QUANT ? 2 * R * (RB + 4) : 2 * R * D * 2;
      int ids = 0, id0 = -32;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, kv0 = fa90::tile_at(i, nsink, first) * BN;
        const int nb = min(BN / R, (sk - kv0 + R - 1) / R);  // boxes below sk
        if (lane == 0) {
          mbar_wait(bar_empty(bars, s), ((i / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar_full(bars, s), nb * box_bytes);
        }
        __syncwarp();  // the slot is free and its bytes announced
        const uint32_t slot = base + PL::ring_off + s * PL::SLOT;
        for (int jg = 0; jg < nb; jg += 32) {
          if ((kv0 + (min(jg + 32, nb) - 1) * R) / page >= id0 + 32) {  // warp-uniform
            id0 = (kv0 + jg * R) / page;
            ids = id0 + lane <= last_pi ? tbl[id0 + lane] : 0;
          }
          const int jb = jg + lane, key = kv0 + jb * R, row = key % page;
          const int pg = min(max(__shfl_sync(0xffffffffu, ids, (key / page - id0) & 31), 0),
                             p.num_pages - 1);
          if (jb >= nb) continue;
          const int plane = hk * p.num_pages + pg;
          if constexpr (QUANT) {
            const size_t srow = (size_t)plane * page + row;
            if (cp_box) {
              // unswizzled rows, 16-byte units (zeros past the stored row,
              // as the TMA fills them), then the scales 4 bytes each
              unsigned char* st = smem + PL::ring_off + s * PL::SLOT;
              const int w = F == KV::I4 ? p.dw / 2 : p.dw;
              for (int r = 0; r < R; ++r) {
                const int x = jb * R + r;
                const size_t g0 = (srow + r) * w;
#pragma unroll
                for (int u = 0; u < RB / 16; ++u) {
                  const bool ok = 16 * u < w;
                  const size_t src = ok ? g0 + 16 * u : 0;
                  tc32::cp16(st + x * RB + 16 * u,
                             static_cast<const unsigned char*>(p.k_pages) + src, ok);
                  tc32::cp16(st + BN * RB + x * RB + 16 * u,
                             static_cast<const unsigned char*>(p.v_pages) + src, ok);
                }
                float* sc = reinterpret_cast<float*>(st + 2 * BN * RB);
                tc32::cp4(sc + x, p.k_scale + srow + r, true);
                tc32::cp4(sc + BN + x, p.v_scale + srow + r, true);
              }
            } else {
              tma_load_3d(slot + jb * R * RB, &tk, bar_full(bars, s), 0, row, plane);
              tma_load_3d(slot + BN * RB + jb * R * RB, &tv, bar_full(bars, s), 0, row, plane);
              bulk_load(slot + 2 * BN * RB + jb * R * 4, p.k_scale + srow, R * 4,
                        bar_full(bars, s));
              bulk_load(slot + 2 * BN * RB + (BN + jb * R) * 4, p.v_scale + srow, R * 4,
                        bar_full(bars, s));
            }
          } else {
            // 128-byte chunk rows: a box of any R lands 128-byte aligned,
            // and the 128-byte swizzle follows the shared-memory address
#pragma unroll
            for (int ch = 0; ch < D / 64; ++ch) {
              const uint32_t at = slot + ch * (BN * 128) + jb * R * 128;
              tma_load_3d(at, &tk, bar_full(bars, s), ch * 64, row, plane);
              tma_load_3d(at + PL::TILE16, &tv, bar_full(bars, s), ch * 64, row, plane);
            }
          }
        }
        if (cp_box) tc32::cp_arrive(bar_full(bars, s));  // every lane, once its copies land
      }
    }
  } else {
    regs_inc<fa90::CONSUMER_REGS>();
    const int w = wg - 1;
    consume<T, F, D>(p, smem, first, n_tiles, nsink, w == 0 ? s0 : s1, w, threadIdx.x & 127,
                     b, hk, h0, t0, q_len, q_start, sk);
  }
}

// Encode the maps and launch: q [b, sq, hq, dw] as (dw, hq, sq, b) in boxes
// of (64, hc, 2 wpos / q_boxes, 1); the pages [hkv, P, page, w] (w = dw,
// or dw / 2 bytes for int4) as (w, page, hkv * P) in boxes of one page's
// box_rows rows (16-bit: 64-column chunks, swizzled; quantized: rows of RB
// bytes, unswizzled), the template's D wide. Returns a cudaError_t code,
// MFA_TMA_ENCODE, or 0.
template <typename T, KV F, int D>
int launch(const void* q, const void* k_pages, const void* v_pages, Params p, int batch,
           cudaStream_t stream) {
  using PL = Plan<D, F>;
  constexpr bool QUANT = PL::QUANT;
  if (p.dw <= 0 || p.dw > D) return MFA_BAD_CONFIG;
  p.box_rows = PL::BN;  // gcd(page_size, BN): a power of two, 1 to BN
  while (p.page_size % p.box_rows != 0) p.box_rows >>= 1;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  const CUtensorMapDataType qtype =
      kIsBf16<T> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap tq, tk, tv;
  {
    const cuuint64_t dims[4] = {(cuuint64_t)p.dw, (cuuint64_t)p.hq, (cuuint64_t)p.sq,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)p.dw * 2, (cuuint64_t)p.hq * p.dw * 2,
                                   (cuuint64_t)p.sq * p.hq * p.dw * 2};
    const cuuint32_t box[4] = {64, (cuuint32_t)p.hc, (cuuint32_t)(2 * p.wpos / p.q_boxes), 1};
    if (int err = mfa_encode(&tq, q, qtype, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return err;
  }
  const int w = F == KV::I4 ? p.dw / 2 : p.dw;  // elements of a stored row
  const size_t row_bytes = QUANT ? w : 2 * w;
  const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)p.page_size,
                              (cuuint64_t)p.hkv * p.num_pages};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)(p.page_size * row_bytes)};
  const cuuint32_t box[3] = {QUANT ? (cuuint32_t)PL::RB : 64u, (cuuint32_t)p.box_rows, 1};
  const CUtensorMapDataType kvtype = QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : qtype;
  const CUtensorMapSwizzle sw = QUANT ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  if (int err = mfa_encode(&tk, k_pages, kvtype, 3, dims, strides, box, sw)) return err;
  if (int err = mfa_encode(&tv, v_pages, kvtype, 3, dims, strides, box, sw)) return err;
  auto kern = paged_prefill_kernel<T, F, D>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)PL::bytes))
    return err;
  const int npos = 2 * p.wpos;
  const dim3 grid(p.hkv * p.nchunks, batch, (p.sq + npos - 1) / npos);
  kern<<<grid, THREADS, PL::bytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace pp90

namespace af32 {

// Kernel 8 in fp32: grid (hkv x head chunks, batch, ceil(sq / wpos)), wpos =
// 64 / hc chunk positions a block; row r is position t0 + r / hc of q head
// hk group + h0 + r % hc (pp90::tail_row: rows past wpos hc, or past the
// group in a group's last chunk of 64 heads, are a dead tail). F: KV::F16
// = fp32 pages, else the quantized format.
template <int D, KV F>
__global__ void __launch_bounds__(THREADS, TcPlan<D, F != KV::F16>::BLOCKS)
    paged_prefill_kernel(const float* __restrict__ q, const void* __restrict__ k_pages,
                         const void* __restrict__ v_pages, const pp90::Params p) {
  using PL = TcPlan<D, F != KV::F16>;
  constexpr int RM = PL::RM;
  const int hk = blockIdx.x / p.nchunks, b = blockIdx.y;
  const int h0 = (blockIdx.x % p.nchunks) * RM;  // the head chunk's first q head
  const int t0 = (gridDim.z - 1 - blockIdx.z) * p.wpos;  // last q tiles first
  const int G = p.group, sk = p.lens[b], q0 = p.q_start[b], q_len = p.q_lens[b], dw = p.dw;
  const float c = p.scale_log2e;
  float* sm = smem_f32();
  Row* rows = reinterpret_cast<Row*>(sm + PL::row_off);
  __shared__ Bounds bnd;
  if (threadIdx.x == 0) bounds_init(&bnd);
  __syncthreads();
  if (threadIdx.x < RM) {
    const int pi = threadIdx.x / p.hc, hq = hk * G + h0 + threadIdx.x % p.hc, t = t0 + pi;
    Row r{};
    r.rid = -1;
    if (!pp90::tail_row(p, h0, threadIdx.x) && t < p.sq) {
      const size_t qrow = ((size_t)b * p.sq + t) * p.hq + hq;
      r.q = q + qrow * dw;
      r.o = static_cast<float*>(p.out) + qrow * dw;
      r.lse = p.lse + ((size_t)b * p.hq + hq) * p.sq + t;
      if (t < q_len) {  // rows past q_lens see nothing: O = 0, LSE = -inf
        const int pos = q0 + t;
        r.pos = pos;
        r.lo = p.wl >= 0 ? max(0, pos - p.wl) : 0;
        r.hi = p.wr >= 0 ? min(sk, pos + p.wr + 1) : sk;
        r.shi = p.wl >= 0 && p.sinks > 0 ? min(p.sinks, r.hi) : 0;
        r.slope = p.slopes != nullptr ? p.slopes[hq] * c : 0.f;
        bounds_add(&bnd, r);
      }
    }
    rows[threadIdx.x] = r;
  }
  __syncthreads();
  const Tiles tl = tiles_of(bnd, PL::BN);
  const Math mt{c, p.softcap, p.softcap_mul, dw};
  // lambdas capture by value (a reference capture keeps its variable in
  // local memory)
  const int* tab = p.table + (size_t)b * p.pps;
  const int n_pages = p.num_pages, page = p.page_size;
  auto page_row = [=](int col) {
    const int pg = min(max(tab[col / page], 0), n_pages - 1);
    return ((size_t)hk * n_pages + pg) * page + col % page;
  };
  if constexpr (F != KV::F16) {
    const int8_t* kq = static_cast<const int8_t*>(k_pages);
    const int8_t* vq = static_cast<const int8_t*>(v_pages);
    const float *ksc = p.k_scale, *vsc = p.v_scale;
    auto issue = [=](int kv0, float* slot) {
      issue_quant<D, F>(slot, kq, vq, ksc, vsc, kv0, sk, dw, page_row);
    };
    attend_tc<D, false, F, false>(sm, rows, tl, mt, nullptr, 0, issue);
  } else {
    const float* kf = static_cast<const float*>(k_pages);
    const float* vf = static_cast<const float*>(v_pages);
    auto issue = [=](int kv0, float* slot) {
      issue_f32<D>(slot, kf, vf, kv0, sk, dw, [=](int col) { return page_row(col) * dw; });
    };
    attend_tc<D, false, F, false>(sm, rows, tl, mt, nullptr, 0, issue);
  }
}

template <int D, KV F>
int launch_paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                         const pp90::Params& p, int batch, cudaStream_t stream) {
  using PL = TcPlan<D, F != KV::F16>;
  const int align = F == KV::I4 ? 32 : F == KV::F16 ? 4 : 16;  // 16-byte row chunks
  if (p.dw <= 0 || p.dw > D || p.dw % align != 0) return MFA_BAD_CONFIG;
  auto kern = paged_prefill_kernel<D, F>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)PL::bytes))
    return err;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                          100))
    return err;
  const dim3 grid(p.hkv * p.nchunks, batch, (p.sq + p.wpos - 1) / p.wpos);
  kern<<<grid, THREADS, PL::bytes, stream>>>(static_cast<const float*>(q), k_pages, v_pages, p);
  return (int)cudaGetLastError();
}

}  // namespace af32

// q_dtype: the q/out dtype (quantized pages take bf16 or fp32 q); kv_dtype:
// the 16-bit or fp32 pages' dtype code (the q dtype), or the format code
// MFA_I8, MFA_E4M3, MFA_I4.
// group = hq / hkv, any (a consumer warpgroup's 64 rows hold 64 / group
// chunk positions, rounded down, of every q head of one kv head; above 64
// one position of 64 q heads, the grid taking ceil(group / 64) head
// chunks); page_size any row count. d: features of q's and a stored page
// row (int4: 2 a byte), a multiple of 8 (16-bit), 16 (int8, fp8) or 32
// (int4) up to 256, run at the instantiated D kd. Returns a cudaError_t
// code.
extern "C" int mfa_paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                                 const float* k_scale, const float* v_scale, const int* lens,
                                 const int* q_start, const int* q_lens, const int* table,
                                 void* out, float* lse, int q_dtype, int kv_dtype, int batch,
                                 int sq, int hq, int hkv, int num_pages, int page_size,
                                 int pps, int d, int kd, int window_left, int window_right,
                                 float scale_log2e, float softcap, float softcap_mul,
                                 int sinks, const float* slopes, void* stream) {
  if (batch == 0 || sq == 0) return 0;
  const int group = hkv > 0 ? hq / hkv : 0;
  if (group <= 0 || hq != group * hkv || page_size <= 0) return MFA_BAD_CONFIG;
  const int hc = group < fa90::WG_M ? group : fa90::WG_M;
  const pp90::Params p{lens,      q_start, q_lens, table,     k_scale,    v_scale,
                       out,       lse,     sq,     hq,        hkv,        group,
                       num_pages, page_size, pps,  0,         window_left, window_right,
                       scale_log2e, softcap, softcap_mul, hc,
                       (group + fa90::WG_M - 1) / fa90::WG_M, fa90::WG_M / hc,
                       fa90::WG_M % hc ? 2 : 1, sinks,  slopes,      d, k_pages, v_pages};
  if (!mfa_dims_fit(d, kd)) return MFA_BAD_CONFIG;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFA_PP(T, F)                                                       \
  if (kd == 64) return pp90::launch<T, F, 64>(q, k_pages, v_pages, p, batch, s);   \
  if (kd == 128) return pp90::launch<T, F, 128>(q, k_pages, v_pages, p, batch, s); \
  if (kd == 256) return pp90::launch<T, F, 256>(q, k_pages, v_pages, p, batch, s); \
  return MFA_BAD_CONFIG
  if (kv_dtype == MFA_I8 && q_dtype == MFA_BF16) { MFA_PP(__nv_bfloat16, KV::I8); }
  if (kv_dtype == MFA_E4M3 && q_dtype == MFA_BF16) { MFA_PP(__nv_bfloat16, KV::E4M3); }
  if (kv_dtype == MFA_I4 && q_dtype == MFA_BF16) { MFA_PP(__nv_bfloat16, KV::I4); }
  if (kv_dtype == MFA_BF16 && q_dtype == MFA_BF16) { MFA_PP(__nv_bfloat16, KV::F16); }
  if (kv_dtype == MFA_F16 && q_dtype == MFA_F16) { MFA_PP(__half, KV::F16); }
#undef MFA_PP
#define MFA_PP32(F)                                                                   \
  if (kd == 64) return af32::launch_paged_prefill<64, F>(q, k_pages, v_pages, p, batch, s);   \
  if (kd == 128) return af32::launch_paged_prefill<128, F>(q, k_pages, v_pages, p, batch, s); \
  return af32::launch_paged_prefill<256, F>(q, k_pages, v_pages, p, batch, s)
  if (q_dtype == MFA_F32) {
    if (kv_dtype == MFA_F32) { MFA_PP32(KV::F16); }
    if (kv_dtype == MFA_I8) { MFA_PP32(KV::I8); }
    if (kv_dtype == MFA_E4M3) { MFA_PP32(KV::E4M3); }
    if (kv_dtype == MFA_I4) { MFA_PP32(KV::I4); }
  }
#undef MFA_PP32
  return MFA_BAD_CONFIG;
}
