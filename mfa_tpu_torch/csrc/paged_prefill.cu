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
// (wl/wr = -1: unbounded). Rows r >= q_lens[b] store O = 0, LSE = -inf.
//
// Bound: tensor-core operations at chunk sizes (4 D flops per visible
// (row, column) pair of every q head, against each row's pages read once).
// The design is the warp-specialised block of flash_fwd_sm90.cuh:
//  - A block of 384 threads owns 128 packed rows of one (sequence, kv
//    head): row i is chunk position t0 + i / group of q head
//    hk * group + i % group, so every K/V tile it stages serves all q heads
//    of the kv head (the TPU kernel's [group, bq] rows, position-major).
//    Warpgroup 0 is the producer (one TMA thread; setmaxnreg hands its
//    registers to the consumers), the two consumer warpgroups own 64 rows
//    each, so the group must divide 64.
//  - Q is one TMA box a 64-column chunk of a 4-D map over q [b, sq, hq, D]
//    (64 columns x group heads x 128 / group positions): it lands as the
//    128 packed rows in the 128-byte swizzle wgmma reads.
//  - K and V come by TMA into a ring of 128-key tiles through the block
//    table, one box per page (or per gcd(page, 128) rows of a larger one)
//    of a map over the pages [hkv, P, page, D] as (D, page, hkv * P). Page
//    ids are clamped into the pool, as the plain version clamps them; no
//    box is issued for rows at or past lens. Rows past lens inside a loaded
//    page, or left over in the slot, may hold anything: K's columns are
//    masked, V's rows are zeroed in shared memory before P V (p = 0 there,
//    but 0 * NaN survives P V). Pages must hold a multiple of 8 rows: a box
//    of fewer rows would break the 1024-byte swizzle atom.
//  - 16-bit pages feed wgmma from the TMA slot as kernel 1 does. int8 pages
//    come unswizzled into a staging slot, their fp32 row scales beside them
//    by bulk copies; the 256 consumer threads convert the payload exactly
//    to bf16 into one 128-byte-swizzled K/V buffer (every load of a
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
// Numerics: kernel 1's classic online softmax (flash_fwd_sm90.cuh); a row
// that sees no column keeps m == MASK and stores O = 0, LSE = -inf.
#include "flash_fwd_sm90.cuh"

namespace pp90 {

using fa90::BM;
using fa90::Span;
using fa90::THREADS;
using fa90::WG_M;
constexpr int BN = 128;     // keys a tile
constexpr int STAGES = 2;   // ring slots
constexpr int BAR_CVT = 1;  // named barrier of the 256 consumer threads (int8)

struct Params {
  const int* lens;      // [b] visible KV length
  const int* q_start;   // [b] absolute position of q row 0
  const int* q_lens;    // [b] real q rows
  const int* table;     // [b, pps]
  const float* k_scale;  // [hkv, P, page] or null
  const float* v_scale;
  void* out;   // [b, sq, hq, D]
  float* lse;  // [b, hq, sq]
  int sq, hq, hkv, group, num_pages, page_size, pps, box_rows, wl, wr;
  float scale_log2e, softcap, softcap_mul;
};

// Shared memory: Q [D/64][BM][64]; STAGES ring slots, each K then V
// [D/64][BN][64] as stored (16-bit pages), or int8 K [BN][D], V [BN][D],
// K scales [BN], V scales [BN] (int8 pages); for int8 one converted buffer
// of bf16 K, V (swizzled like a 16-bit slot) and the tile's scales; the
// barriers (Q, full[STAGES], empty[STAGES]). Every swizzled chunk is
// 1024-byte aligned.
template <int D, bool QUANT>
struct Plan {
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t TILE16 = BN * D * 2;  // one 16-bit K or V tile
  static constexpr uint32_t SCALES = 2 * BN * 4;  // a tile's K and V scales
  static constexpr uint32_t SLOT = QUANT ? 2 * BN * D + SCALES : 2 * TILE16;
  static constexpr uint32_t ring_off = Q_BYTES;
  static constexpr uint32_t cvt_off = ring_off + STAGES * SLOT;
  static constexpr uint32_t bar_off = cvt_off + (QUANT ? 2 * TILE16 + SCALES : 0);
  static constexpr size_t used = bar_off + 8 * (1 + 2 * STAGES) + 1024;  // + 1 KB to align
  // at least 120 KB, so that two blocks never share an SM (their setmaxnreg
  // requests could not both be met)
  static constexpr size_t bytes = used > 120 * 1024 ? used : 120 * 1024;
  static_assert(SLOT % 1024 == 0, "ring slots keep the swizzle's 1024-byte alignment");
};

__device__ __forceinline__ uint32_t bar_q(uint32_t bars) { return bars; }
__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) { return bars + 8 * (1 + s); }
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (1 + STAGES + s);
}

// KV tiles [first, last] that the live rows among chunk positions
// [ta, ta + n) see (first > last: none).
__device__ __forceinline__ Span span_of(int ta, int n, int q_len, int q_start, int sk, int wl,
                                        int wr) {
  const Span none{0, -1};
  if (ta >= q_len) return none;
  const int tb = min(ta + n, q_len) - 1;  // last live position
  int hi = sk;                            // columns [lo, hi)
  if (wr >= 0) hi = min(hi, q_start + tb + wr + 1);
  const int lo = wl >= 0 ? max(0, q_start + ta - wl) : 0;
  if (hi <= lo) return none;
  return Span{lo / BN, (hi - 1) / BN};
}

// The 256 consumer threads (ctid) convert the int8 slot into a bf16
// buffer: 16 values a unit, one 64-column chunk row as 4 units, rows in
// the order of the 128-byte swizzle's atoms, every load issued before the
// first conversion; rows at or past sk become zeros, and so do their
// scales.
template <int D>
__device__ __forceinline__ void convert_tile(const unsigned char* slot, unsigned char* cvt,
                                             int kv0, int sk, int ctid) {
  using PL = Plan<D, true>;
  constexpr int UNITS = BN * D / 16;       // 16-byte int8 units of one tile
  constexpr int PER = 2 * UNITS / 256;     // K's and V's units a thread
  uint4 raw[PER];
#pragma unroll
  for (int x = 0; x < PER; ++x) {
    const int u = ctid + 256 * x, r = u % UNITS, row = (r >> 2) % BN;
    raw[x] = kv0 + row < sk ? *reinterpret_cast<const uint4*>(
                                  slot + (u / UNITS) * BN * D + row * D + (r / (BN * 4)) * 64 +
                                  (r & 3) * 16)
                            : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int x = 0; x < PER; ++x) {
    const int u = ctid + 256 * x, r = u % UNITS;  // u / UNITS: 0 K, 1 V
    const int ch = r / (BN * 4), row = (r >> 2) % BN, qd = r & 3;
    uint4 o0, o1;
    i8x4_to_bf16(raw[x].x, o0.x, o0.y);
    i8x4_to_bf16(raw[x].y, o0.z, o0.w);
    i8x4_to_bf16(raw[x].z, o1.x, o1.y);
    i8x4_to_bf16(raw[x].w, o1.z, o1.w);
    unsigned char* dst = cvt + (u / UNITS) * PL::TILE16 + ch * (BN * 128) + row * 128;
    *reinterpret_cast<uint4*>(dst + (((2 * qd) ^ (row & 7)) << 4)) = o0;
    *reinterpret_cast<uint4*>(dst + (((2 * qd + 1) ^ (row & 7)) << 4)) = o1;
  }
  // one scale a thread: K's BN, then V's BN
  const float* src = reinterpret_cast<const float*>(slot + 2 * BN * D);
  reinterpret_cast<float*>(cvt + 2 * PL::TILE16)[ctid] =
      kv0 + (ctid % BN) < sk ? src[ctid] : 0.f;
}

// One consumer warpgroup (w, thread wtid of 128) over its 64 packed rows:
// the KV loop over the block's tiles [first, first + n_tiles), computing
// those of `mine`, then O and LSE of its rows < sq.
template <typename T, bool QUANT, int D>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, int first,
                                        int n_tiles, Span mine, int w, int wtid, int b, int hk,
                                        int t0, int q_len, int q_start, int sk) {
  using PL = Plan<D, QUANT>;
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + PL::bar_off;
  const uint32_t q_wg = base + w * WG_M * 128;  // this warpgroup's rows of each Q chunk
  const int lane = wtid & 31, g = lane >> 2, t4 = lane & 3;
  const int group = p.group;
  const int i0 = w * WG_M + (wtid >> 5) * 16 + g;  // this thread's packed rows: i0, i0 + 8
  const int tr0 = t0 + i0 / group, tr1 = t0 + (i0 + 8) / group;  // their chunk positions
  const bool live0 = tr0 < q_len, live1 = tr1 < q_len;
  const int pos0 = q_start + tr0, pos1 = q_start + tr1;
  const int wpos = WG_M / group;  // positions a warpgroup
  const int pos_lo = q_start + t0 + w * wpos, pos_hi = pos_lo + wpos - 1;
  const bool all_live = t0 + (w + 1) * wpos <= q_len;
  const int wl = p.wl, wr = p.wr;
  const float c = p.scale_log2e;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = MFA_MASK, m1 = MFA_MASK;  // running max, raw score domain
  float l0 = 0.f, l1 = 0.f;            // this thread's partial row sums

  mbar_wait(bar_q(bars), 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int jt = first + i, s = i % STAGES, kv0 = jt * BN;
    mbar_wait(bar_full(bars, s), (i / STAGES) & 1);
    unsigned char* slot = smem + PL::ring_off + s * PL::SLOT;
    unsigned char* kv = slot;  // 16-bit K then V, swizzled
    if constexpr (QUANT) {
      kv = smem + PL::cvt_off;
      named_sync(BAR_CVT, 256);  // the buffer's readers of the last tile are done
      convert_tile<D>(slot, kv, kv0, sk, w * 128 + wtid);
      fence_async_smem();
      named_sync(BAR_CVT, 256);
      mbar_arrive(bar_empty(bars, s));  // the staging slot is free
    }
    if (jt >= mine.first && jt <= mine.last) {
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

      const float* scl = reinterpret_cast<const float*>(kv + 2 * PL::TILE16);  // int8: K, V scales
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
            if (wl >= 0) ok = ok && col >= pos - wl;
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
    const int t = trs[x], h = hk * group + (i0 + 8 * x) % group;
    if (t >= p.sq) continue;
    const float m = ms[x], l = ls[x];
    const bool dead = m <= MFA_MASK * 0.5f || l == 0.f;
    const float inv = dead ? 0.f : 1.f / (isnan(l) ? 1.f : l);
    T* orow = out + (((size_t)b * p.sq + t) * p.hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float o0 = dead ? 0.f : acc[4 * j + 2 * x] * inv;
      const float o1 = dead ? 0.f : acc[4 * j + 2 * x + 1] * inv;
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) = pack2<T>(o0, o1);
    }
    if (p.lse != nullptr && t4 == 0)
      p.lse[((size_t)b * p.hq + h) * p.sq + t] =
          dead ? -INFINITY : m * c * MFA_LN2 + logf(isnan(l) ? 1.f : l);
  }
}

// Grid (hkv, batch, ceil(sq / (BM / group))).
template <typename T, bool QUANT, int D>
__global__ void __launch_bounds__(THREADS, 1)
    paged_prefill_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const Params p) {
  using PL = Plan<D, QUANT>;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // last (longest) q tiles first
  const int group = p.group, npos = BM / group;
  const int t0 = qt * npos;  // the block's first chunk position
  const int q_len = min(max(p.q_lens[b], 0), p.sq);
  if (t0 >= q_len) {
    // no live row: O = 0 and LSE = -inf for the rows < sq, nothing loaded
    T* out = static_cast<T*>(p.out);
    for (int u = threadIdx.x; u < BM * (D / 8); u += THREADS) {
      const int i = u / (D / 8), t = t0 + i / group, h = hk * group + i % group;
      T* orow = out + (((size_t)b * p.sq + t) * p.hq + h) * D;
      if (t < p.sq)
        *reinterpret_cast<uint4*>(orow + (u % (D / 8)) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = threadIdx.x; i < BM; i += THREADS) {
      const int t = t0 + i / group, h = hk * group + i % group;
      if (t < p.sq && p.lse != nullptr) p.lse[((size_t)b * p.hq + h) * p.sq + t] = -INFINITY;
    }
    return;
  }
  const int q_start = p.q_start[b];
  const int sk = min(p.lens[b], p.pps * p.page_size);
  const int wpos = WG_M / group;
  const Span s0 = span_of(t0, wpos, q_len, q_start, sk, p.wl, p.wr);
  const Span s1 = span_of(t0 + wpos, wpos, q_len, q_start, sk, p.wl, p.wr);
  int first = s0.first, last = s0.last;
  if (s0.first > s0.last) {
    first = s1.first;
    last = s1.last;
  } else if (s1.first <= s1.last) {
    first = min(first, s1.first);
    last = max(last, s1.last);
  }
  const int n_tiles = max(0, last - first + 1);

  extern __shared__ __align__(16) unsigned char pp90_smem[];
  unsigned char* smem = pp90_smem + ((1024u - (smem_u32(pp90_smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + PL::bar_off;
  if (threadIdx.x == 0) {
    mbar_init(bar_q(bars), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(bars, s), 1);
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
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q(bars), PL::Q_BYTES);
#pragma unroll
      for (int ch = 0; ch < D / 64; ++ch)
        tma_load_4d(base + ch * (BM * 128), &tq, bar_q(bars), ch * 64, hk * group, t0, b);
      const int* tbl = p.table + (size_t)b * p.pps;
      const int R = p.box_rows, page = p.page_size;
      // bytes of one box of K and V (int8: payload rows and their scales)
      const uint32_t box_bytes = QUANT ? 2 * R * (D + 4) : 2 * R * D * 2;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, kv0 = (first + i) * BN;
        const int nb = min(BN / R, (sk - kv0 + R - 1) / R);  // boxes below sk
        mbar_wait(bar_empty(bars, s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full(bars, s), nb * box_bytes);
        const uint32_t slot = base + PL::ring_off + s * PL::SLOT;
        for (int jb = 0; jb < nb; ++jb) {
          const int key = kv0 + jb * R, row = key % page;
          const int pg = min(max(tbl[key / page], 0), p.num_pages - 1);
          const int plane = hk * p.num_pages + pg;
          if constexpr (QUANT) {
            tma_load_3d(slot + jb * R * D, &tk, bar_full(bars, s), 0, row, plane);
            tma_load_3d(slot + BN * D + jb * R * D, &tv, bar_full(bars, s), 0, row, plane);
            const size_t srow = (size_t)plane * page + row;
            bulk_load(slot + 2 * BN * D + jb * R * 4, p.k_scale + srow, R * 4, bar_full(bars, s));
            bulk_load(slot + 2 * BN * D + (BN + jb * R) * 4, p.v_scale + srow, R * 4,
                      bar_full(bars, s));
          } else {
#pragma unroll
            for (int ch = 0; ch < D / 64; ++ch) {
              const uint32_t at = slot + ch * (BN * 128) + jb * R * 128;
              tma_load_3d(at, &tk, bar_full(bars, s), ch * 64, row, plane);
              tma_load_3d(at + PL::TILE16, &tv, bar_full(bars, s), ch * 64, row, plane);
            }
          }
        }
      }
    }
  } else {
    regs_inc<fa90::CONSUMER_REGS>();
    const int w = wg - 1;
    consume<T, QUANT, D>(p, smem, first, n_tiles, w == 0 ? s0 : s1, w, threadIdx.x & 127, b,
                         hk, t0, q_len, q_start, sk);
  }
}

// Encode the maps and launch: q [b, sq, hq, D] as (D, hq, sq, b) in boxes
// of (64, group, BM / group, 1); the pages [hkv, P, page, D] as (D, page,
// hkv * P) in boxes of one page's box_rows rows (16-bit: 64-column chunks,
// swizzled; int8: whole rows, unswizzled). Returns a cudaError_t code,
// MFA_TMA_ENCODE, or 0.
template <typename T, bool QUANT, int D>
int launch(const void* q, const void* k_pages, const void* v_pages, const Params& p, int batch,
           cudaStream_t stream) {
  using PL = Plan<D, QUANT>;
  const CUtensorMapDataType qtype =
      kIsBf16<T> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  CUtensorMap tq, tk, tv;
  {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)p.hq, (cuuint64_t)p.sq,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)p.hq * D * 2,
                                   (cuuint64_t)p.sq * p.hq * D * 2};
    const cuuint32_t box[4] = {64, (cuuint32_t)p.group, (cuuint32_t)(BM / p.group), 1};
    if (int err = mfa_encode(&tq, q, qtype, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return err;
  }
  const size_t elem = QUANT ? 1 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)p.page_size,
                              (cuuint64_t)p.hkv * p.num_pages};
  const cuuint64_t strides[2] = {(cuuint64_t)(D * elem), (cuuint64_t)(p.page_size * D * elem)};
  const cuuint32_t box[3] = {QUANT ? (cuuint32_t)D : 64u, (cuuint32_t)p.box_rows, 1};
  const CUtensorMapDataType kvtype = QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : qtype;
  const CUtensorMapSwizzle sw = QUANT ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  if (int err = mfa_encode(&tk, k_pages, kvtype, 3, dims, strides, box, sw)) return err;
  if (int err = mfa_encode(&tv, v_pages, kvtype, 3, dims, strides, box, sw)) return err;
  auto kern = paged_prefill_kernel<T, QUANT, D>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)PL::bytes))
    return err;
  const int npos = BM / p.group;
  const dim3 grid(p.hkv, batch, (p.sq + npos - 1) / npos);
  kern<<<grid, THREADS, PL::bytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace pp90

// q_dtype: the q/out dtype (int8 pages take bf16 q); kv_dtype: the pages'.
// group = hq / hkv must divide 64 (a consumer warpgroup's 64 rows hold
// 64 / group chunk positions of every q head of one kv head); page_size a
// multiple of 8. Returns a cudaError_t code.
extern "C" int mfa_paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                                 const float* k_scale, const float* v_scale, const int* lens,
                                 const int* q_start, const int* q_lens, const int* table,
                                 void* out, float* lse, int q_dtype, int kv_dtype, int batch,
                                 int sq, int hq, int hkv, int num_pages, int page_size,
                                 int pps, int d, int window_left, int window_right,
                                 float scale_log2e, float softcap, float softcap_mul,
                                 void* stream) {
  if (batch == 0 || sq == 0) return 0;
  const int group = hkv > 0 ? hq / hkv : 0;
  if (group <= 0 || fa90::WG_M % group != 0 || page_size <= 0 || page_size % 8 != 0)
    return MFA_BAD_CONFIG;
  int box_rows = pp90::BN;  // gcd(page_size, BN): a power of two >= 8
  while (page_size % box_rows != 0) box_rows >>= 1;
  const pp90::Params p{lens,      q_start, q_lens, table,     k_scale,    v_scale,
                       out,       lse,     sq,     hq,        hkv,        group,
                       num_pages, page_size, pps,  box_rows,  window_left, window_right,
                       scale_log2e, softcap, softcap_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFA_PP(T, QUANT)                                                      \
  if (d == 64) return pp90::launch<T, QUANT, 64>(q, k_pages, v_pages, p, batch, s);   \
  if (d == 128) return pp90::launch<T, QUANT, 128>(q, k_pages, v_pages, p, batch, s); \
  return MFA_BAD_CONFIG
  if (kv_dtype == MFA_I8 && q_dtype == MFA_BF16) { MFA_PP(__nv_bfloat16, true); }
  if (kv_dtype == MFA_BF16 && q_dtype == MFA_BF16) { MFA_PP(__nv_bfloat16, false); }
  if (kv_dtype == MFA_F16 && q_dtype == MFA_F16) { MFA_PP(__half, false); }
#undef MFA_PP
  return MFA_BAD_CONFIG;
}
