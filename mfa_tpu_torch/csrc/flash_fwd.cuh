// The mma.sync flash-attention forward tile of the paged-prefill (kernel 8,
// paged_prefill.cu) and image-block (kernel 9, blockmask.cu) kernels. The
// dense prefill kernels 1-4 and packed varlen (kernel 7) run the wgmma +
// TMA tile of flash_fwd_sm90.cuh; these two are still to move.
//
// One block of 4 warps owns 64 query rows (16 per warp); each thread holds
// two of them (rows g and g + 8 of its warp's mma fragment). The caller
// resolves, per thread, where its two rows live (pointers into Q, O and the
// LSE, or null past the end), each row's absolute position for the band
// mask, and whether the row is live (a dead row sees no column and stores
// O = 0, LSE = -inf). A KV source (DenseKV or PagedKV below) stages each
// 64-row K/V tile into shared memory; tiles outside [first, last] are
// never loaded.
//
// Bound: at d = 128 the work is tensor-core operations, so both products
// run on mma.sync.m16n8k16 with fp32 accumulation: Q fragments stay in
// registers for the whole KV loop, V is stored transposed in shared memory
// (conflict-free 32-bit operand reads), and the S accumulator is reused as
// the A operand of P.V without a round trip through shared memory. No
// cp.async/TMA pipelining: loads and math do not overlap (flash_fwd_sm90.cuh
// does both on wgmma + TMA). At d = 256 the O accumulator alone takes 128 registers a
// thread, and Q's fragments would take 64 more: there each warp stages its
// 16 Q rows in shared memory once and reads one 16-column A fragment per
// product step instead (FlashSmem::Q_SMEM).
//
// A visibility policy (the last template argument) can let columns through
// that the band masks: the image-block kernel (blockmask.cu) adds "same
// image run" with it. The default adds nothing and compiles to the band
// test alone. Every tile that such a policy reaches beyond the band lies
// above the diagonal or left of the window, so the needs_mask test below
// already masks it element by element.
//
// Numerics (the repository guide's "Softmax-kernel numerics rules"): the
// running max m is kept in the raw score domain and every exponent is
// formed subtract-first, exp2((s - m) * c); a row that saw no visible column
// keeps m == MASK and stores O = 0 and LSE = -inf. Quantized pages (int8
// payload + fp32 per-row scales) follow mfa_tpu/kernels/paged_prefill.py:
// the payload contracts in the compute dtype (int8 -> bf16 is exact), K
// scales multiply the score columns, V scales fold into the probabilities
// before they are rounded for P.V.
#pragma once

#include "common.cuh"

constexpr int FA_BM = 64;        // query rows per block
constexpr int FA_BN = 64;        // key/value rows per tile
constexpr int FA_THREADS = 128;  // 4 warps x 16 query rows

template <typename T>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float c[4], const uint32_t a[4],
                                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float c[4], const uint32_t a[4],
                                                  const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared-memory plan: K tile [BN][D + 8], V^T tile [D][BN + 8] (both in the
// compute dtype T), then the tile's K and V scales (quantized sources), its
// column run ids (a visibility policy), and at D > 128 the block's Q rows
// [BM][D + 8].
template <typename T, int D>
struct FlashSmem {
  static constexpr bool Q_SMEM = D > 128;  // Q fragments read from shared memory
  static constexpr int KS = D + 8;      // K and Q row stride (elements): conflict-free
  static constexpr int VS = FA_BN + 8;  // V^T row stride (elements)
  static constexpr size_t v_off = sizeof(T) * FA_BN * KS;
  static constexpr size_t sc_off = v_off + sizeof(T) * D * VS;
  static constexpr size_t ids_off = sc_off + sizeof(float) * 2 * FA_BN;
  static constexpr size_t q_off = ids_off + sizeof(int) * FA_BN;
  static constexpr size_t bytes(bool quant, bool ids = false) {
    return Q_SMEM ? q_off + sizeof(T) * FA_BM * KS : ids ? q_off : quant ? ids_off : sc_off;
  }
};

// 16 bytes of stored K/V values -> compute-dtype values.
template <typename T, typename TKV>
struct Vec16 {
  static constexpr int N = 16 / (int)sizeof(TKV);
  __device__ __forceinline__ static T at(const uint4& v, int x) {
    if constexpr (sizeof(TKV) == 1) {
      return from_float<T>(static_cast<float>(reinterpret_cast<const int8_t*>(&v)[x]));
    } else {
      return reinterpret_cast<const T*>(&v)[x];
    }
  }
};

// Stage one tile: row r of the tile is K/V row `src.row(kv0 + r)` (an
// element offset, or -1 past the end: zeros, since a NaN there would
// survive p = 0). K row-major, V transposed.
template <typename T, typename TKV, int D, class Src>
__device__ __forceinline__ void stage_tile(const Src& src, int kv0, T* ks, T* vts, int tid) {
  using SM = FlashSmem<T, D>;
  using V16 = Vec16<T, TKV>;
  constexpr int VPR = D / V16::N;  // 16-byte vectors per row
  // K: coalesced 16-byte loads, row-major in shared memory.
  for (int i = tid; i < FA_BN * VPR; i += FA_THREADS) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    const long long off = src.row(kv0 + r);
    if (off >= 0) val = *reinterpret_cast<const uint4*>(src.k + off + c * V16::N);
    T* dst = ks + r * SM::KS + c * V16::N;
    if constexpr (sizeof(TKV) == sizeof(T)) {
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
#pragma unroll
      for (int x = 0; x < V16::N; ++x) dst[x] = V16::at(val, x);
    }
  }
  // V, transposed: consecutive threads take consecutive rows so the 2-byte
  // transposed stores hit consecutive addresses.
  for (int i = tid; i < FA_BN * VPR; i += FA_THREADS) {
    const int r = i % FA_BN, c = i / FA_BN;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    const long long off = src.row(kv0 + r);
    if (off >= 0) val = *reinterpret_cast<const uint4*>(src.v + off + c * V16::N);
#pragma unroll
    for (int x = 0; x < V16::N; ++x) vts[(c * V16::N + x) * SM::VS + r] = V16::at(val, x);
  }
}

// Contiguous K/V rows: row j at k + j * stride (elements), j < sk.
template <typename T>
struct DenseKV {
  using Stored = T;
  static constexpr bool QUANT = false;
  const T* k;
  const T* v;
  long long stride;
  int sk;
  __device__ __forceinline__ long long row(int j) const { return j < sk ? j * stride : -1; }
};

// Paged K/V of one (sequence, kv head): token j lives in page
// table[j / page_size] at row j % page_size of pages [hkv, P, page, D].
// Page ids are clamped into the pool, as in the decode kernels.
template <typename TKV, int D>
struct PagedKV {
  using Stored = TKV;
  static constexpr bool QUANT = sizeof(TKV) == 1;
  const TKV* k;  // pages of this kv head: [P, page, D]
  const TKV* v;
  const float* k_scale;  // [P, page] of this kv head, or null
  const float* v_scale;
  const int* table;  // this sequence's row of the block table [pps]
  int num_pages, page_size, sk;  // sk: visible length (<= pps * page_size)
  __device__ __forceinline__ long long slot(int j) const {
    if (j >= sk) return -1;
    int page = table[j / page_size];
    page = min(max(page, 0), num_pages - 1);
    return (long long)page * page_size + j % page_size;
  }
  __device__ __forceinline__ long long row(int j) const {
    const long long s = slot(j);
    return s < 0 ? -1 : s * D;
  }
};

// This thread's two query rows.
template <typename T>
struct TileRows {
  const T* q[2];   // row pointers (D elements), null = zero row
  T* o[2];         // output rows, null = not stored
  float* lse[2];   // LSE slots, null = not stored
  int pos[2];      // absolute positions (band mask)
  bool live[2];    // false: the row sees no column (O = 0, LSE = -inf)
};

// The block-wide facts that let a tile skip its mask.
struct TileBand {
  int first, last;     // KV tiles to visit (inclusive; first > last = none)
  int pos_lo, pos_hi;  // least and greatest row position of the block
  bool all_live;
  int wl, wr;          // band around each row, -1 = unbounded
};

// Live KV tiles of the q rows [q0, q0 + BM) against sk keys.
__device__ __forceinline__ TileBand band_of(int q0, int sk, int wl, int wr) {
  TileBand t;
  t.last = (sk + FA_BN - 1) / FA_BN - 1;
  if (wr >= 0) t.last = min(t.last, (q0 + FA_BM - 1 + wr) / FA_BN);
  t.first = wl >= 0 ? max(0, (q0 - wl) / FA_BN) : 0;
  t.pos_lo = q0;
  t.pos_hi = q0 + FA_BM - 1;
  t.all_live = true;
  t.wl = wl;
  t.wr = wr;
  return t;
}

// Rows q0 + warp*16 + g (+8) of one (sequence, head): q/o rows `q_stride`
// elements apart, LSE entries 1 apart.
template <typename T>
__device__ __forceinline__ TileRows<T> rows_of(const T* qp, T* op, float* lp, int q_stride,
                                               int q0, int sq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  TileRows<T> rows;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = q0 + warp * 16 + (lane >> 2) + 8 * x;
    const bool in = r < sq;
    rows.q[x] = in ? qp + (size_t)r * q_stride : nullptr;
    rows.o[x] = in ? op + (size_t)r * q_stride : nullptr;
    rows.lse[x] = (in && lp != nullptr) ? lp + r : nullptr;
    rows.pos[x] = r;
    rows.live[x] = true;
  }
  return rows;
}

// The default visibility policy: the band alone.
struct BandOnly {
  static constexpr bool ENABLED = false;
};

// Vis: the visibility policy. When Vis::ENABLED, Vis::extra(x, id) says
// whether this thread's row x sees a column whose id (staged from
// Vis::col_ids) is `id`, beyond the band.
template <typename T, int D, class Src, class Vis = BandOnly>
__device__ __forceinline__ void flash_fwd_tile(const Src& src, const TileRows<T>& rows,
                                               const TileBand& band, float scale_log2e,
                                               float softcap, float softcap_mul,
                                               unsigned char* smem, const Vis& vis = Vis{}) {
  using SM = FlashSmem<T, D>;
  constexpr int KS = SM::KS, VS = SM::VS;
  constexpr bool Q_SMEM = SM::Q_SMEM;
  T* ks = reinterpret_cast<T*>(smem);
  T* vts = reinterpret_cast<T*>(smem + SM::v_off);
  float* ksc = reinterpret_cast<float*>(smem + SM::sc_off);
  float* vsc = ksc + FA_BN;
  int* cids = reinterpret_cast<int*>(smem + SM::ids_off);

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int sk = src.sk;
  const int wl = band.wl, wr = band.wr;

  // Q as mma A fragments: resident in registers for the whole KV loop, or
  // (Q_SMEM) this warp's 16 rows staged once in shared memory, each quad
  // copying its own two rows as 16-byte vectors.
  uint32_t qf[Q_SMEM ? 1 : D / 16][4];
  const T* qs = reinterpret_cast<const T*>(smem + SM::q_off) + ((tid >> 5) * 16 + g) * KS;
  if constexpr (Q_SMEM) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      T* dst = reinterpret_cast<T*>(smem + SM::q_off) + ((tid >> 5) * 16 + g + 8 * x) * KS;
      const T* qr = rows.q[x];
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        const int c = (t4 + 4 * j) * 8;
        *reinterpret_cast<uint4*>(dst + c) =
            qr ? *reinterpret_cast<const uint4*>(qr + c) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int c = kc * 16 + t4 * 2;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const T* qr = rows.q[x & 1];
        qf[kc][x] = qr ? *reinterpret_cast<const uint32_t*>(qr + c + (x >> 1) * 8) : 0u;
      }
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = MFA_MASK, m1 = MFA_MASK;  // running max, raw score domain
  float l0 = 0.f, l1 = 0.f;            // this thread's partial row sums

  for (int jt = band.first; jt <= band.last; ++jt) {
    const int kv0 = jt * FA_BN;
    __syncthreads();  // every warp is done with the previous tile
    stage_tile<T, typename Src::Stored, D>(src, kv0, ks, vts, tid);
    if constexpr (Src::QUANT) {
      for (int i = tid; i < FA_BN; i += FA_THREADS) {
        const long long s = src.slot(kv0 + i);
        ksc[i] = s < 0 ? 0.f : src.k_scale[s];
        vsc[i] = s < 0 ? 0.f : src.v_scale[s];
      }
    }
    if constexpr (Vis::ENABLED) {
      for (int i = tid; i < FA_BN; i += FA_THREADS)
        cids[i] = kv0 + i < sk ? vis.col_ids[kv0 + i] : -1;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BN columns.
    float s[FA_BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < FA_BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qa[4];
      if constexpr (Q_SMEM) {
        const T* qr = qs + kc * 16 + t4 * 2;
        qa[0] = *reinterpret_cast<const uint32_t*>(qr);
        qa[1] = *reinterpret_cast<const uint32_t*>(qr + 8 * KS);
        qa[2] = *reinterpret_cast<const uint32_t*>(qr + 8);
        qa[3] = *reinterpret_cast<const uint32_t*>(qr + 8 * KS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < FA_BN / 8; ++nt) {
        const T* kr = ks + (nt * 8 + g) * KS + kc * 16 + t4 * 2;
        uint32_t bfr[2];
        bfr[0] = *reinterpret_cast<const uint32_t*>(kr);
        bfr[1] = *reinterpret_cast<const uint32_t*>(kr + 8);
        if constexpr (Q_SMEM) {
          mma16816<T>(s[nt], qa, bfr);
        } else {
          mma16816<T>(s[nt], qf[kc], bfr);
        }
      }
    }

    if constexpr (Src::QUANT) {  // K scales on the score columns
#pragma unroll
      for (int nt = 0; nt < FA_BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= ksc[nt * 8 + t4 * 2 + (e & 1)];
    }
    if (softcap > 0.f) {
#pragma unroll
      for (int nt = 0; nt < FA_BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = tanhf(s[nt][e] * softcap_mul) * softcap;
    }
    // Mask only tiles that cross the sequence tail or the band's edge.
    const bool needs_mask = !band.all_live || (kv0 + FA_BN > sk) ||
                            (wr >= 0 && kv0 + FA_BN - 1 > band.pos_lo + wr) ||
                            (wl >= 0 && kv0 < band.pos_hi - wl);
    if (needs_mask) {
#pragma unroll
      for (int nt = 0; nt < FA_BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nt * 8 + t4 * 2 + (e & 1);
          const int col = kv0 + c;
          const int row = rows.pos[e >> 1];
          bool in_band = true;
          if (wr >= 0) in_band = col <= row + wr;
          if (wl >= 0) in_band = in_band && (col >= row - wl);
          if constexpr (Vis::ENABLED) in_band = in_band || vis.extra(e >> 1, cids[c]);
          const bool ok = rows.live[e >> 1] && col < sk && in_band;
          if (!ok) s[nt][e] = MFA_MASK;
        }
      }
    }

    // Online softmax: rows are spread over the 4 threads of a quad.
    float mx0 = MFA_MASK, mx1 = MFA_MASK;
#pragma unroll
    for (int nt = 0; nt < FA_BN / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f((m0 - mn0) * scale_log2e);
    const float alpha1 = exp2f((m1 - mn1) * scale_log2e);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < FA_BN / 8; ++nt) {
      s[nt][0] = exp2f((s[nt][0] - mn0) * scale_log2e);
      s[nt][1] = exp2f((s[nt][1] - mn0) * scale_log2e);
      s[nt][2] = exp2f((s[nt][2] - mn1) * scale_log2e);
      s[nt][3] = exp2f((s[nt][3] - mn1) * scale_log2e);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = alpha0 * l0 + ps0;
    l1 = alpha1 * l1 + ps1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }
    if constexpr (Src::QUANT) {  // V scales fold into the probabilities
#pragma unroll
      for (int nt = 0; nt < FA_BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= vsc[nt * 8 + t4 * 2 + (e & 1)];
    }

    // O += P V: the S accumulator layout is the A fragment layout of the
    // next product (two 8-column tiles make one 16-deep chunk).
#pragma unroll
    for (int kc = 0; kc < FA_BN / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack2<T>(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack2<T>(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack2<T>(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack2<T>(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const T* vr = vts + (dt * 8 + g) * VS + kc * 16 + t4 * 2;
        uint32_t bfr[2];
        bfr[0] = *reinterpret_cast<const uint32_t*>(vr);
        bfr[1] = *reinterpret_cast<const uint32_t*>(vr + 8);
        mma16816<T>(acc[dt], a, bfr);
      }
    }
  }

  // Epilogue: full row sums, dead-row guard, store O and LSE.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float ms[2] = {m0, m1}, ls[2] = {l0, l1};
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const float m = ms[x], l = ls[x];
    const bool dead = m <= MFA_MASK * 0.5f;
    const bool bad = dead || l == 0.f || isnan(l);
    const float inv = dead ? 0.f : 1.f / (bad ? 1.f : l);
    if (T* o = rows.o[x]) {
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const float o0 = acc[dt][2 * x] * inv, o1 = acc[dt][2 * x + 1] * inv;
        *reinterpret_cast<uint32_t*>(o + dt * 8 + t4 * 2) = pack2<T>(o0, o1);
      }
    }
    if (rows.lse[x] != nullptr && t4 == 0)
      *rows.lse[x] = (dead || l == 0.f) ? -INFINITY
                                        : m * scale_log2e * MFA_LN2 + logf(bad ? 1.f : l);
  }
}
