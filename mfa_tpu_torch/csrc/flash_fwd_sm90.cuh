// The dense flash-attention forward tile for Hopper (sm_90a), shared by
// kernel 1 (the classic prefill, prefill.cu), kernels 2-4 (the zero-shift
// engines and the repair, bound.cu), kernel 7 (packed varlen, prefill.cu)
// and kernel 9 (image-block prefill, blockmask.cu). Layout: q [b, hq, sq,
// dw], k/v [b, hkv, sk, dw], o like q, LSE [b, hq, sq] fp32; or packed
// (kernel 7): q [total_q, hq, dw], k/v [total_k, hkv, dw], LSE [hq, total_q],
// each block reading its sequence's offsets from cu_seqlens. GQA by head
// index (kv head = h / (hq / hkv)); the band (wl, wr) around each row's own
// position, -1 = unbounded (causal = (-1, 0)). Row r sits at position r +
// kv_off (kernel 1 and the zero-shift engines: mfa_tpu's
// kv_position_offset, the ring's geometry). With a left window the first
// `sinks` columns stay visible to every row (StreamingLLM sinks,
// prefill.py:_band_mask): a span is then the sink tiles [0, nsink) followed
// by the band's tiles, no tile twice, and the block loads that list.
// ALiBi (kernels 1 and 7, the classic softmax only) subtracts slope_h *
// |position - column| from the raw scores, the slope pre-divided by the
// softmax scale (prefill.py:1303-1312).
// Rows are dw features wide (Args::dw, any multiple of 8 up to D): the
// tensor maps are encoded at dw, so TMA fills each box's columns past dw
// with zeros (a whole 64-column chunk past dw at D 256 and dw <= 192), and
// zero features add nothing to Q K^T or P V; O is stored at dw, its
// columns past dw never written. The softmax scale is the caller's (that
// of the true head dim), whatever D is.
// Kernel 7 differs from kernel 1 only in the addressing (strided tensor
// maps, the sequence's first rows as box coordinates, O's row stride), so
// on equal lengths the two give the same bits. Kernel 9 (kind IMAGE) is
// kernel 1's classic code with one more visibility rule, a column that
// carries the row's own image-run id: each warpgroup's span is widened by
// the runs of its rows, which one warp finds in the ids at the block's
// start (kernels/blockmask.py:kv_tile_bounds states the same spans), and
// with every id at -1 it gives kernel 1's bits.
//
// Bound: operations. Past a few hundred keys a row does 4 D flops per
// visible key on 2 D bytes of K and V read once per 128 rows, so the
// tensor cores, not the memory, are the limit. The design follows
// FlashAttention on Hopper (arXiv 2312.11918, 2407.08608):
//  - A warp-specialised block of 384 threads owns 128 q rows. Warpgroup 0
//    is the producer: one thread issues every TMA load, and setmaxnreg
//    hands its registers to the two consumer warpgroups (24 / 240 a
//    thread), each of which owns 64 q rows.
//  - Q is loaded once by TMA; K and V come by TMA into a ring of STAGES
//    slots with a full and an empty mbarrier each, so the next tile loads
//    while the consumers compute on this one. The tensor maps are 3-D,
//    (D, rows, b * heads): rows past sk (or sq) read as zeros, never as
//    another head's rows, and 64-column boxes with the 128-byte swizzle
//    give each row chunk the layout wgmma reads.
//  - S = Q K^T is one wgmma chain with both operands in shared memory; P
//    is rounded to 16 bits in registers and is the register A operand of
//    O += P V, whose B operand is V as stored (row-major, read through the
//    transpose bit): nothing is transposed or copied by the threads.
//  - BN = 128 keys a tile at D 64 and 128; 64 at D 256, where the O
//    accumulator alone is 128 fp32 registers a thread.
//  - Only tiles that cross the band's edge or the tail are masked element
//    by element; a tile no row of a warpgroup sees is skipped by that
//    warpgroup (it still waits for and releases the slot, so the ring's
//    phases stay in step). Such a tile would add exact zeros (m unchanged,
//    alpha = 1, p = 0), so skipping it changes no bit.
//  - Blocks launch longest causal q tiles first (blockIdx.z reversed, the
//    slowest grid axis).
//
// The flags and risky bits stay per 64-row tile, [b, hq, ceil(sq / 64)]:
// each consumer warpgroup owns exactly one. Kernel 2 (FLAGGED) ORs its
// rows' poison checks per warpgroup; kernel 4 (BOUND) picks the softmax per
// warpgroup from its risky bit; kernel 3 (REPAIR) leaves when both of its
// flags are 0 and otherwise runs the classic softmax on the flagged
// warpgroups, while a warpgroup with flag 0 only keeps the ring in step and
// stores nothing. Kernel 1 and the repair run the same classic code over the
// same tiles in the same order, so a repaired tile equals kernel 1's bit
// for bit.
//
// Softmax (the repository guide's numerics rules): classic = the online
// softmax, exponents formed subtract-first, exp2((s - m) * c), a row that
// sees no column keeps m == MASK and stores O = 0, LSE = -inf. Zero shift =
// mfa_tpu/kernels/prefill.py:_bound_body: p = exp2(s * c) with no row max
// and no rescale; O is normalized by the sum of p as rounded for P.V, LSE
// (= ln l) and the poison check use the unrounded sum l, as JAX does (in
// fp32 the two agree). A row is poisoned when its band is not structurally
// empty and l lies outside (MFA_L_MIN, inf), or one of its O values is not
// finite.
#pragma once

#include "wgmma.cuh"

// A zero-shift row sum at or below 2^-89 proves nothing about the row's
// largest exponent (mfa_tpu/kernels/prefill.py:_L_MIN): its tile is repaired.
#define MFA_L_MIN 0x1p-89f

namespace fa90 {

constexpr int BM = 128;      // q rows a block
constexpr int WG_M = 64;     // q rows a consumer warpgroup (one flag tile)
constexpr int THREADS = 384;  // producer warpgroup + two consumers
constexpr int STAGES = 2;    // K/V ring slots
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

enum Kind { PREFILL, FLAGGED, REPAIR, BOUND, UNCHECKED, IMAGE };

struct Args {
  int hq, hkv, sq, sk, wl, wr;
  float scale_log2e, softcap, softcap_mul;
  int dw = 0;      // features of a q, k, v and o row (a multiple of 8, <= D)
  int sinks = 0;   // columns < sinks stay visible through the left window
  int kv_off = 0;  // row r sits at position r + kv_off
  const float* slopes = nullptr;  // ALiBi [hq], raw score domain (or null)
  float alibi = 0.f;              // the block's head's slope (set by the kernel)
  // the packed layout (kernel 7): [batch + 1] sequence offsets and q's row
  // count; sq and sk are then each block's own sequence's lengths
  const int* cu_q = nullptr;
  const int* cu_k = nullptr;
  int total_q = 0;
  // kind IMAGE (kernel 9): image-run ids [batch, sq] (-1: text)
  const int* ids = nullptr;
};

// Shared memory: Q [D/64][BM][64], K and V slots [D/64][BN][64] each (every
// chunk 1024-byte aligned), the barriers (Q, full[STAGES], empty[STAGES]),
// one poison word per consumer warpgroup, and (IMAGE) the warpgroups'
// spans.
template <int D>
struct Plan {
  static constexpr int BN = D > 128 ? 64 : 128;
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;  // one K or V tile
  static constexpr uint32_t k_off = Q_BYTES;
  static constexpr uint32_t v_off = k_off + STAGES * KV_BYTES;
  static constexpr uint32_t bar_off = v_off + STAGES * KV_BYTES;
  static constexpr uint32_t flag_off = bar_off + 8 * (1 + 2 * STAGES);
  // + 1 KB to align the base; at least 120 KB, so that two blocks never
  // share an SM (their setmaxnreg requests could not both be met)
  static constexpr uint32_t span_off = flag_off + 8;
  static constexpr size_t bytes = span_off + 16 + 1024 > 120 * 1024 ? span_off + 16 + 1024
                                                                    : 120 * 1024;
};

__device__ __forceinline__ uint32_t bar_q(uint32_t bars) { return bars; }
__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) { return bars + 8 * (1 + s); }
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (1 + STAGES + s);
}

// KV tiles that rows at positions [lo, hi] can see: the sink tiles [0,
// nsink) (sinks > 0 with a left window: every column < sinks stays
// visible), then the band [first, last], which starts past the sink tiles.
struct Span {
  int first, last;
  int nsink = 0;
};
__device__ __forceinline__ Span span_of(int lo, int hi, int sk, int wl, int wr, int bn,
                                        int sinks = 0) {
  Span s;
  s.last = (sk + bn - 1) / bn - 1;
  if (wr >= 0) s.last = min(s.last, (hi + wr) / bn);
  s.first = wl >= 0 ? max(0, (lo - wl) / bn) : 0;
  if (wl >= 0 && sinks > 0) s.nsink = max(0, min(min((sinks + bn - 1) / bn, s.first), s.last + 1));
  return s;
}
// Tile i of a list of nsink sink tiles followed by the band from `first`.
__device__ __forceinline__ int tile_at(int i, int nsink, int first) {
  return i < nsink ? i : first + (i - nsink);
}
__device__ __forceinline__ bool in_span(int jt, const Span& s) {
  return jt < s.nsink || (jt >= s.first && jt <= s.last);
}

// The last (run_end) and first (run_start) index of the image run that
// holds row r (r itself for text, id -1), read by one warp 32 ids a step: a
// run is a maximal segment of equal ids >= 0
// (kernels/blockmask.py:image_run_bounds).
__device__ __forceinline__ int run_end(const int* ids, int s, int r) {
  const int id = __ldg(ids + r), lane = threadIdx.x & 31;
  if (id < 0) return r;
  for (int j0 = r + 1; j0 < s; j0 += 32) {
    const int j = j0 + lane;
    const unsigned m = __ballot_sync(0xffffffffu, j >= s || __ldg(ids + j) != id);
    if (m) return j0 + __ffs(m) - 2;
  }
  return s - 1;
}
__device__ __forceinline__ int run_start(const int* ids, int r) {
  const int id = __ldg(ids + r), lane = threadIdx.x & 31;
  if (id < 0) return r;
  for (int j0 = r - 1; j0 >= 0; j0 -= 32) {
    const int j = j0 - lane;
    const unsigned m = __ballot_sync(0xffffffffu, j < 0 || __ldg(ids + j) != id);
    if (m) return j0 - __ffs(m) + 2;
  }
  return 0;
}

// The sum of the two 16-bit values packed in x.
template <typename T>
__device__ __forceinline__ float sum2(uint32_t x);
template <>
__device__ __forceinline__ float sum2<__nv_bfloat16>(uint32_t x) {
  return __uint_as_float(x << 16) + __uint_as_float(x & 0xffff0000u);
}
template <>
__device__ __forceinline__ float sum2<__half>(uint32_t x) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&x));
  return f.x + f.y;
}

// The block's view of its rows and the ring.
struct Block {
  uint32_t base;   // shared-memory base (1024-aligned)
  int first;       // first KV tile of the block's band
  int n_tiles;     // KV tiles the ring carries
  int nsink;       // sink tiles [0, nsink) ahead of the band
};

// A warpgroup that computes nothing: it waits for each slot and releases it.
template <int D>
__device__ __forceinline__ void consume_idle(const Block& blk) {
  const uint32_t bars = blk.base + Plan<D>::bar_off;
  mbar_wait(bar_q(bars), 0);
  for (int i = 0; i < blk.n_tiles; ++i) {
    mbar_wait(bar_full(bars, i % STAGES), (i / STAGES) & 1);
    mbar_arrive(bar_empty(bars, i % STAGES));
  }
}

// One consumer warpgroup (w, thread wtid of 128) over its 64 rows from
// row pos_lo (position pos_lo + kv_off): the KV loop, then O and LSE of
// its rows < sq (O's rows o_stride elements apart). ZS: the zero-shift
// softmax; returns whether one of this thread's rows is poisoned. IMG: a column is also visible when it carries
// the row's image-run id (a.ids, this sequence's row).
template <typename T, int D, bool ZS, bool IMG = false>
__device__ __forceinline__ bool consume(const Block& blk, int w, int wtid, const Args& a,
                                        Span mine, int pos_lo, T* o_head, size_t o_stride,
                                        float* lse_head) {
  using P = Plan<D>;
  constexpr int BN = P::BN;
  const uint32_t bars = blk.base + P::bar_off;
  const uint32_t q_wg = blk.base + w * WG_M * 128;  // this warpgroup's rows of each Q chunk
  const int lane = wtid & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = pos_lo + (wtid >> 5) * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int off = a.kv_off, p0 = r0 + off;       // and their positions: p0, p0 + 8
  const int pw_lo = pos_lo + off, pw_hi = pw_lo + WG_M - 1;
  const int sk = a.sk, wl = a.wl, wr = a.wr, sinks = a.sinks;
  const float c = a.scale_log2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running max, raw score domain (zero shift: fixed at 0)
  float m0 = ZS ? 0.f : MFA_MASK, m1 = ZS ? 0.f : MFA_MASK;
  float l0 = 0.f, l1 = 0.f;  // this thread's partial row sums
  float n0 = 0.f, n1 = 0.f;  // zero shift: sums of p as rounded for P.V
  // image runs of this thread's rows (-1: text, or past sq)
  int rid0 = -1, rid1 = -1;
  if constexpr (IMG) {
    if (r0 < a.sq) rid0 = __ldg(a.ids + r0);
    if (r0 + 8 < a.sq) rid1 = __ldg(a.ids + r0 + 8);
  }

  mbar_wait(bar_q(bars), 0);
  for (int i = 0; i < blk.n_tiles; ++i) {
    const int jt = tile_at(i, blk.nsink, blk.first), s = i % STAGES;
    mbar_wait(bar_full(bars, s), (i / STAGES) & 1);
    if (in_span(jt, mine)) {
      const int kv0 = jt * BN;
      const uint32_t k_s = blk.base + P::k_off + s * P::KV_BYTES;
      const uint32_t v_s = blk.base + P::v_off + s * P::KV_BYTES;

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
      // Mask only tiles that cross the sequence tail or the band's edge
      // (every tile an image run or the sinks add lies above the diagonal
      // or left of the window, so it is one of them).
      const bool needs_mask = (kv0 + BN > sk) || (wr >= 0 && kv0 + BN - 1 > pw_lo + wr) ||
                              (wl >= 0 && kv0 < pw_hi - wl);
      // IMG: bit 2 j + e of same0 / same1 says that column 8 j + 2 t4 + e
      // of the tile carries row r0's / r0 + 8's run id; the ids load while
      // the product runs
      uint32_t same0 = 0, same1 = 0;
      if constexpr (IMG) {
        if (needs_mask && (rid0 >= 0 || rid1 >= 0)) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = kv0 + 8 * j + 2 * t4 + e;
              const int id = col < sk ? __ldg(a.ids + col) : -1;
              same0 |= (uint32_t)(id == rid0) << (2 * j + e);
              same1 |= (uint32_t)(id == rid1) << (2 * j + e);
            }
          }
          if (rid0 < 0) same0 = 0;
          if (rid1 < 0) same1 = 0;
        }
      }
      wg_wait_all();
      fence_regs(sc);

      if (a.softcap > 0.f) {
#pragma unroll
        for (int x = 0; x < BN / 2; ++x) sc[x] = tanhf(sc[x] * a.softcap_mul) * a.softcap;
      }
      if constexpr (!ZS) {
        if (a.alibi != 0.f) {  // raw domain: - slope / scale * |position - column|
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = kv0 + 8 * j + 2 * t4 + (e & 1);
              sc[4 * j + e] -= a.alibi * fabsf((float)(p0 + 8 * (e >> 1) - col));
            }
          }
        }
      }
      if (needs_mask) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + 8 * j + 2 * t4 + (e & 1);
            const int row = p0 + 8 * (e >> 1);
            bool ok = col < sk;
            if (wr >= 0) ok = ok && col <= row + wr;
            if (wl >= 0) ok = ok && (col >= row - wl || col < sinks);
            if constexpr (IMG) ok = ok || ((((e >> 1) ? same1 : same0) >> (2 * j + (e & 1))) & 1u);
            if (!ok) sc[4 * j + e] = MFA_MASK;
          }
        }
      }

      if constexpr (ZS) {
        // one exp2 pass, purely additive sums (O's normalizer n is summed
        // below, from p as packed for P.V)
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[4 * j + e] = exp2f(sc[4 * j + e] * c);
          ps0 += sc[4 * j] + sc[4 * j + 1];
          ps1 += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l0 += ps0;
        l1 += ps1;
      } else {
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
      }

      // P in registers: 16 columns of S are one A fragment of P V.
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pa[kc][x] = pack2<T>(sc[8 * kc + 2 * x], sc[8 * kc + 2 * x + 1]);
        if constexpr (ZS) {
          // O's normalizer: p as rounded to T, the weights P.V uses, so O
          // stays a convex combination of V's rows
          n0 += sum2<T>(pa[kc][0]) + sum2<T>(pa[kc][2]);
          n1 += sum2<T>(pa[kc][1]) + sum2<T>(pa[kc][3]);
        }
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
    mbar_arrive(bar_empty(bars, s));
  }

  // Epilogue: full row sums, dead-row guard, store O and LSE of rows < sq.
  // A zero-shift row has m == 0: it is never "dead", and l == 0 stores
  // O = 0, LSE = -inf.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if constexpr (ZS) {
    n0 += __shfl_xor_sync(0xffffffffu, n0, 1);
    n0 += __shfl_xor_sync(0xffffffffu, n0, 2);
    n1 += __shfl_xor_sync(0xffffffffu, n1, 1);
    n1 += __shfl_xor_sync(0xffffffffu, n1, 2);
  }
  const float ms[2] = {m0, m1}, ls[2] = {l0, l1}, ns[2] = {n0, n1};
  bool poison = false;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = r0 + 8 * x;
    if (r >= a.sq) continue;
    const float m = ms[x], l = ls[x];
    const float norm = ZS ? ns[x] : l;  // O's normalizer
    const bool dead = m <= MFA_MASK * 0.5f;
    const bool bad = dead || l == 0.f || isnan(l);
    const float inv = dead ? 0.f : 1.f / (bad ? 1.f : norm);
    T* orow = o_head + (size_t)r * o_stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float o0 = acc[4 * j + 2 * x] * inv, o1 = acc[4 * j + 2 * x + 1] * inv;
      if constexpr (ZS) poison |= !(isfinite(o0) && isfinite(o1));
      if (8 * j + 2 * t4 < a.dw)  // columns past dw are not O's
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) = pack2<T>(o0, o1);
    }
    if constexpr (ZS) {
      // A row whose band [max(0, p - wl), min(sk, p + wr + 1)) at position
      // p is empty may keep l == 0, unless sink columns lie below its end
      // (prefill.py:626-646).
      const int p = r + off;
      const int band_lo = wl >= 0 ? max(0, p - wl) : 0;
      const int band_hi = wr >= 0 ? min(sk, p + wr + 1) : sk;
      const bool empty = band_hi <= band_lo && (sinks <= 0 || band_hi <= 0);
      poison |= !((l > MFA_L_MIN && l < INFINITY) || (empty && l == 0.f));
    }
    if (lse_head != nullptr && t4 == 0)
      lse_head[r] = (dead || l == 0.f) ? -INFINITY : m * c * MFA_LN2 + logf(bad ? 1.f : l);
  }
  return poison;
}

// Grid (hq, batch, ceil(sq / BM)); on the packed layout (PACKED, kernel 1's
// function only) ceil(max_sq / BM). table: kernel 2's flags (written; null
// = none), kernel 3's flags (read), kernel 4's risky bits (read), or null.
// IMAGE: a warpgroup's rows [lo, hi] see the columns [min(lo - wl,
// run_start(lo)), run_end(hi)] (a run is contiguous, so the tile's first
// and last row bound every row's run); the block loads the union of the
// two spans.
template <typename T, int D, int KIND, bool PACKED = false>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
               float* __restrict__ lse, int* __restrict__ table, const Args args) {
  static_assert(!PACKED || KIND == PREFILL, "the packed layout runs the classic softmax");
  using P = Plan<D>;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;  // longest causal tiles first
  const int q0 = qb * BM;
  Args a = args;
  int q_row0 = 0, k_row0 = 0;  // the sequence's first rows in the maps
  if constexpr (PACKED) {
    // Rows of a sequence are followed by the next sequence's, not by
    // zeros: key columns >= sk are masked (needs_mask), q rows >= sq are
    // computed and never stored.
    q_row0 = a.cu_q[b];
    a.sq = a.cu_q[b + 1] - q_row0;
    if (q0 >= a.sq) return;  // tile past this sequence: the whole block leaves
    k_row0 = a.cu_k[b];
    a.sk = a.cu_k[b + 1] - k_row0;
  }
  const int nt64 = (a.sq + WG_M - 1) / WG_M;
  const size_t tile0 = (size_t)(b * a.hq + h) * nt64 + 2 * qb;  // this block's first flag
  const bool two = q0 + WG_M < a.sq;  // the second warpgroup has rows
  if constexpr (KIND == REPAIR) {
    if (table[tile0] == 0 && !(two && table[tile0 + 1] != 0)) return;  // nothing poisoned
  }
  extern __shared__ __align__(16) unsigned char fa90_smem[];
  unsigned char* smem = fa90_smem + ((1024u - (smem_u32(fa90_smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + P::bar_off;
  int* wg_poison = reinterpret_cast<int*>(smem + P::flag_off);

  if (a.slopes != nullptr) a.alibi = a.slopes[h];
  const int p_q0 = q0 + a.kv_off;  // the block's first position
  Span s0 = span_of(p_q0, p_q0 + WG_M - 1, a.sk, a.wl, a.wr, P::BN, a.sinks);
  Span s1 = span_of(p_q0 + WG_M, p_q0 + BM - 1, a.sk, a.wl, a.wr, P::BN, a.sinks);
  int* img_span = reinterpret_cast<int*>(smem + P::span_off);  // IMAGE: s0, s1
  if constexpr (KIND == IMAGE) {
    a.ids += (size_t)b * a.sq;
    if (threadIdx.x >= 32 && threadIdx.x < 64) {  // warp 1, while thread 0 sets up
      for (int w = 0; w < (two ? 2 : 1); ++w) {
        const int lo = q0 + w * WG_M, hi = min(lo + WG_M - 1, a.sq - 1);
        const int col_lo = a.wl >= 0 ? min(max(lo - a.wl, 0), run_start(a.ids, lo)) : 0;
        const int col_hi = run_end(a.ids, a.sq, hi);
        if (threadIdx.x == 32) {
          img_span[2 * w] = col_lo / P::BN;
          img_span[2 * w + 1] = col_hi / P::BN;
        }
      }
    }
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q(bars), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(bars, s), 1);
      mbar_init(bar_empty(bars, s), 2 * 128);  // every consumer thread releases
    }
    mbar_fence_init();
  }
  if (threadIdx.x < 2) wg_poison[threadIdx.x] = 0;
  __syncthreads();
  int first = s0.first, last = two ? s1.last : s0.last;
  // sink tiles ahead of the band; the band starts past them
  const int nsink = max(s0.nsink, two ? s1.nsink : 0);
  first = max(first, nsink);
  if constexpr (KIND == IMAGE) {
    s0 = Span{img_span[0], img_span[1]};
    first = s0.first;
    last = s0.last;
    if (two) {
      s1 = Span{img_span[2], img_span[3]};
      first = min(first, s1.first);
      last = max(last, s1.last);
    }
  }
  const Block blk{base, first, nsink + max(0, last - first + 1), nsink};

  // warp-uniform by construction (a shuffle from lane 0), as setmaxnreg's
  // .sync.aligned form needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg == 0) {
    // producer: one thread issues every load
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      // map planes: (batch, head) matrices, or one head's packed rows
      const int hk = h / (a.hq / a.hkv);
      const int bh_q = PACKED ? h : b * a.hq + h, bh_kv = PACKED ? hk : b * a.hkv + hk;
      mbar_expect_tx(bar_q(bars), P::Q_BYTES);
#pragma unroll
      for (int ch = 0; ch < D / 64; ++ch)
        tma_load_3d(base + ch * (BM * 128), &tq, bar_q(bars), ch * 64, q_row0 + q0, bh_q);
      for (int i = 0; i < blk.n_tiles; ++i) {
        const int s = i % STAGES, kv0 = k_row0 + tile_at(i, blk.nsink, blk.first) * P::BN;
        mbar_wait(bar_empty(bars, s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full(bars, s), 2 * P::KV_BYTES);
        const uint32_t k_s = base + P::k_off + s * P::KV_BYTES;
        const uint32_t v_s = base + P::v_off + s * P::KV_BYTES;
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch)
          tma_load_3d(k_s + ch * (P::BN * 128), &tk, bar_full(bars, s), ch * 64, kv0, bh_kv);
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch)
          tma_load_3d(v_s + ch * (P::BN * 128), &tv, bar_full(bars, s), ch * 64, kv0, bh_kv);
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    const int w = wg - 1, wtid = threadIdx.x & 127;
    const bool live = w == 0 || two;
    const int pos_lo = q0 + w * WG_M;
    const Span mine = w == 0 ? s0 : s1;
    // O [b, hq, sq, dw] and LSE [b, hq, sq], or packed O [total_q, hq, dw]
    // and LSE [hq, total_q]
    const size_t head = PACKED ? (size_t)q_row0 * a.hq + h : (size_t)(b * a.hq + h) * a.sq;
    const size_t o_stride = PACKED ? (size_t)a.hq * a.dw : (size_t)a.dw;
    T* o_head = o + head * a.dw;
    float* lse_head = lse == nullptr ? nullptr
                      : PACKED       ? lse + (size_t)h * a.total_q + q_row0
                                     : lse + head;
    bool poison = false;
    if constexpr (KIND == IMAGE) {
      if (live) {
        consume<T, D, false, true>(blk, w, wtid, a, mine, pos_lo, o_head, o_stride, lse_head);
      } else {
        consume_idle<D>(blk);
      }
    } else if constexpr (KIND == PREFILL) {
      if (live) {
        consume<T, D, false>(blk, w, wtid, a, mine, pos_lo, o_head, o_stride, lse_head);
      } else {
        consume_idle<D>(blk);
      }
    } else if constexpr (KIND == REPAIR) {
      if (live && table[tile0 + w] != 0) {
        consume<T, D, false>(blk, w, wtid, a, mine, pos_lo, o_head, o_stride, lse_head);
      } else {
        consume_idle<D>(blk);
      }
    } else if constexpr (KIND == BOUND) {
      if (!live) {
        consume_idle<D>(blk);
      } else if (table[tile0 + w] != 0) {  // risky: the classic softmax
        consume<T, D, false>(blk, w, wtid, a, mine, pos_lo, o_head, o_stride, lse_head);
      } else {
        consume<T, D, true>(blk, w, wtid, a, mine, pos_lo, o_head, o_stride, lse_head);
      }
    } else {  // FLAGGED, UNCHECKED
      if (live) {
        poison = consume<T, D, true>(blk, w, wtid, a, mine, pos_lo, o_head, o_stride, lse_head);
      } else {
        consume_idle<D>(blk);
      }
    }
    if constexpr (KIND == FLAGGED) {
      if (table != nullptr) {  // null: "flag_presence" (no flag computed)
        if (__any_sync(0xffffffffu, poison) && (wtid & 31) == 0) atomicOr(&wg_poison[w], 1);
        named_sync(1 + w, 128);
        if (wtid == 0 && live) table[tile0 + w] = wg_poison[w];
      }
    }
  }
}

// Encode the three tensor maps and launch. Returns a cudaError_t code,
// MFA_TMA_ENCODE, or 0.
template <typename T, int D, int KIND>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int* table,
           int batch, const Args& a, cudaStream_t stream) {
  using P = Plan<D>;
  constexpr bool BF = kIsBf16<T>;
  CUtensorMap tq, tk, tv;
  // sk == 0: no KV tile is ever loaded; the maps only need a valid base
  const bool kv = a.sk > 0;
  if (a.dw <= 0 || a.dw > D || a.dw % 8 != 0) return MFA_BAD_CONFIG;
  if (int err = mfa_tensor_map_3d(&tq, q, BF, a.dw, a.sq, batch * a.hq, BM)) return err;
  if (int err = mfa_tensor_map_3d(&tk, kv ? k : q, BF, a.dw, kv ? a.sk : a.sq,
                                  batch * (kv ? a.hkv : a.hq), P::BN))
    return err;
  if (int err = mfa_tensor_map_3d(&tv, kv ? v : q, BF, a.dw, kv ? a.sk : a.sq,
                                  batch * (kv ? a.hkv : a.hq), P::BN))
    return err;
  auto kern = fwd_kernel<T, D, KIND>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  const dim3 grid(a.hq, batch, (a.sq + BM - 1) / BM);
  kern<<<grid, THREADS, P::bytes, stream>>>(tq, tk, tv, static_cast<T*>(o), lse, table, a);
  return (int)cudaGetLastError();
}

// Kernel 1's function on packed rows: q [total_q, hq, D], k/v [total_k,
// hkv, D], o like q, lse [hq, total_q] or null; cu_q/cu_k [batch + 1] on the
// device (a.cu_q, a.cu_k, a.total_q set), max_sq bounds every sequence's q
// length. The maps are strided over (D, total, heads): a tile's box starts
// at its sequence's first row.
template <typename T, int D>
int launch_packed(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                  int total_k, int max_sq, const Args& a, cudaStream_t stream) {
  using P = Plan<D>;
  constexpr bool BF = kIsBf16<T>;
  CUtensorMap tq, tk, tv;
  const int dw = a.dw;
  if (dw <= 0 || dw > D || dw % 8 != 0) return MFA_BAD_CONFIG;
  const size_t row_q = (size_t)a.hq * dw * 2, row_k = (size_t)a.hkv * dw * 2;
  if (int err = mfa_tensor_map_3d_strided(&tq, q, BF, dw, a.total_q, a.hq, row_q, dw * 2, BM))
    return err;
  // total_k == 0: no KV tile is ever loaded; the maps only need a valid base
  const bool kv = total_k > 0;
  if (int err = mfa_tensor_map_3d_strided(&tk, kv ? k : q, BF, dw, kv ? total_k : a.total_q,
                                          kv ? a.hkv : a.hq, kv ? row_k : row_q, dw * 2, P::BN))
    return err;
  if (int err = mfa_tensor_map_3d_strided(&tv, kv ? v : q, BF, dw, kv ? total_k : a.total_q,
                                          kv ? a.hkv : a.hq, kv ? row_k : row_q, dw * 2, P::BN))
    return err;
  auto kern = fwd_kernel<T, D, PREFILL, true>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  const dim3 grid(a.hq, batch, (max_sq + BM - 1) / BM);
  kern<<<grid, THREADS, P::bytes, stream>>>(tq, tk, tv, static_cast<T*>(o), lse, nullptr, a);
  return (int)cudaGetLastError();
}

}  // namespace fa90
