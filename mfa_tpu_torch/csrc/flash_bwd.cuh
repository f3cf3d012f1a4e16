// The mma.sync flash-attention backward tiles of three launches of
// backward.cu: the deterministic split's dQ (kernel 13) and the
// packed-varlen split (kernel 14). The fused launch (kernel 11) and the
// split's dK/dV (kernel 12) run the wgmma + TMA kernel of
// flash_bwd_sm90.cuh.
//
// Every launch recomputes the probabilities from the forward's saved
// natural-log LSE and runs the FlashAttention-2 recurrence on mma.sync
// (m16n8k16, fp32 accumulation):
//
//   P  = exp2(S * c - LSE * log2e),  S = Q K^T (softcap: cap * tanh(S * scale / cap))
//   dV += P^T dO        dP = dO V^T        dS = P * (dP - delta) * scale (* (1 - tanh^2))
//   dK += dS^T Q        dQ += dS K
//
// with delta = rowsum(dO * O) computed by the caller in fp32.
//
// Two block bodies:
//  * bwd_dkv_block: one block owns BWD_BN key rows of one kv head (16 per
//    warp). K and V stay in shared memory and dK/dV in registers while the
//    block walks the GQA group's q heads and, for each, the q tiles of the
//    band. Each warp computes S^T and dP^T for its own key rows, so the
//    accumulators of P^T and dS^T are already the A operands of P^T dO and
//    dS^T Q (no transpose through shared memory).
//  * bwd_dq_block: one block owns 64 q rows of one q head (16 per warp),
//    walks the band's kv tiles, and keeps dQ in registers until one store.
//
// Transposed operands (dO and Q as B of P^T dO and dS^T Q, K as B of dS K)
// come straight from row-major shared memory through ldmatrix.trans. P and
// dS are rounded to the compute dtype before their products, as the
// forward rounds P.
//
// Row sources: the caller resolves base pointers of one (batch or packed
// sequence, head) and the element strides between heads and rows, so the
// dense [b, h, s, d] layout and the packed [total, h, d] layout share the
// bodies. A row whose LSE is -inf (it saw no column in the forward) gets
// P = 0, hence zero gradients; key rows with no live q row in the band keep
// dK = dV = 0 and are still stored.
//
// Bound: tensor-core operations (4 products of 2 * d flops per visible
// (row, column) pair and q head in dK/dV, 3 in dQ). No cp.async/TMA
// pipelining and no wgmma: loads and math do not overlap. Moving these
// launches onto the fused kernel's wgmma + TMA design is later work.
#pragma once

#include "flash_fwd.cuh"

constexpr int BWD_THREADS = 128;  // 4 warps
constexpr int BWD_BN = 64;        // key rows of a dK/dV block (16 per warp)
constexpr int BWD_DQ_BM = 64;     // q rows of a dQ block (16 per warp)
constexpr float BWD_LOG2E = 1.4426950408889634f;

// Strides (elements) and band of one launch; sq/sk are per sequence.
struct BwdGeom {
  long long q_head, q_row;  // q, dO, dQ: between heads' row 0, between rows
  long long l_head;         // LSE, delta: between heads (rows are adjacent)
  long long k_row;          // K, V, dK, dV: between rows of one kv head
  int sq, sk;
  int wl, wr;               // band around each row, -1 = unbounded
  float scale;              // softmax scale (dS carries it)
  float c2;                 // (capped) score -> log2 domain multiplier
  float softcap, softcap_mul;
};

// Shared-memory plan of the dK/dV block: K, V [BN][D + 8], Q, dO [BM][D + 8],
// the q tile's log2 LSE and delta [BM].
template <typename T, int D>
struct BwdSmem {
  // q rows per step of the dK/dV loop: 32 at d = 128 keeps dK + dV (128
  // fp32 registers a thread) plus S^T and dP^T under the register limit.
  static constexpr int BM = D >= 128 ? 32 : 64;
  static constexpr int RS = D + 8;  // row stride: 16-byte aligned, conflict-free
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + sizeof(T) * BWD_BN * RS;
  static constexpr size_t q_off = v_off + sizeof(T) * BWD_BN * RS;
  static constexpr size_t do_off = q_off + sizeof(T) * BM * RS;
  static constexpr size_t l_off = do_off + sizeof(T) * BM * RS;
  static constexpr size_t dl_off = l_off + sizeof(float) * BM;
  static constexpr size_t bytes = dl_off + sizeof(float) * BM;
};

// Shared-memory plan of the dQ block: Q, dO [64][D + 8], K, V [BN][D + 8].
template <typename T, int D>
struct BwdDqSmem {
  static constexpr int RS = D + 8;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + sizeof(T) * BWD_DQ_BM * RS;
  static constexpr size_t k_off = do_off + sizeof(T) * BWD_DQ_BM * RS;
  static constexpr size_t v_off = k_off + sizeof(T) * BWD_BN * RS;
  static constexpr size_t bytes = v_off + sizeof(T) * BWD_BN * RS;
};

// Four 8x8 16-bit matrices, transposed, from shared memory (lane l gives the
// address of row l % 8 of matrix l / 8).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// Copy `rows` rows of D values (16-byte vectors) into shared memory with row
// stride D + 8; rows at or past `valid` are zeros (a NaN there would survive
// p = 0).
template <typename T, int D>
__device__ __forceinline__ void bwd_stage(T* dst, const T* src, long long stride, int valid,
                                          int rows, int tid) {
  constexpr int N = 16 / (int)sizeof(T);
  constexpr int VPR = D / N;
  for (int i = tid; i < rows * VPR; i += BWD_THREADS) {
    const int r = i / VPR, c = i % VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c * N);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c * N) = val;
  }
}

// A fragment (16 rows x 16 columns) of a row-major shared tile.
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t a[4], const T* tile, int rs, int row0, int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const T* p = tile + (row0 + g) * rs + col0 + t4 * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * rs);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * rs + 8);
}

// B fragment of X^T for a row-major shared tile X (n rows x k columns).
template <typename T>
__device__ __forceinline__ void frag_b(uint32_t b[2], const T* tile, int rs, int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const T* p = tile + (n0 + g) * rs + k0 + t4 * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragments of two n-tiles (columns n0 .. n0 + 15) of a row-major shared
// tile X used as it is (k rows x n columns): r[0..1] n-tile n0, r[2..3] n0 + 8.
template <typename T>
__device__ __forceinline__ void frag_b2_trans(uint32_t r[4], const T* tile, int rs, int k0,
                                              int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(r, tile + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * rs + n0 + (lane >> 4) * 8);
}

// The probability and dS of one (key row, q row) pair, in place:
// s = raw score, dp = dO . v; l2 = log2-domain LSE (+inf on a dead row).
__device__ __forceinline__ void bwd_pair(float& s, float& dp, bool visible, float l2,
                                         float delta, const BwdGeom& g) {
  float x = s, dcap = 1.f;
  if (g.softcap > 0.f) {
    const float t = tanhf(x * g.softcap_mul);
    x = t * g.softcap;
    dcap = 1.f - t * t;
  }
  const float p = visible ? exp2f(x * g.c2 - l2) : 0.f;
  s = p;
  dp = p * (dp - delta) * g.scale * dcap;
}

// q, dO, lse, delta: (batch or sequence, head 0); k, v, dk, dv: (batch or
// sequence, kv head), row 0. Heads h0 .. h0 + group - 1 read this kv head;
// kv0 is the block's first key row.
template <typename T, int D>
__device__ __forceinline__ void bwd_dkv_block(const T* __restrict__ q, const T* __restrict__ k,
                                              const T* __restrict__ v, const T* __restrict__ dO,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              T* __restrict__ dk, T* __restrict__ dv, int h0,
                                              int group, int kv0,
                                              const BwdGeom& g, unsigned char* smem) {
  using SM = BwdSmem<T, D>;
  constexpr int BM = SM::BM, RS = SM::RS;
  T* ks = reinterpret_cast<T*>(smem + SM::k_off);
  T* vs = reinterpret_cast<T*>(smem + SM::v_off);
  T* qs = reinterpret_cast<T*>(smem + SM::q_off);
  T* dos = reinterpret_cast<T*>(smem + SM::do_off);
  float* l2s = reinterpret_cast<float*>(smem + SM::l_off);
  float* dls = reinterpret_cast<float*>(smem + SM::dl_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16;  // this warp's key rows within the block
  const int nkv = min(BWD_BN, g.sk - kv0);
  bwd_stage<T, D>(ks, k + (long long)kv0 * g.k_row, g.k_row, nkv, BWD_BN, tid);
  bwd_stage<T, D>(vs, v + (long long)kv0 * g.k_row, g.k_row, nkv, BWD_BN, tid);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  // q tiles that see a key row of this block (the transpose of the
  // forward's band: row r sees key c when r - wl <= c <= r + wr)
  int q_first = 0, q_last = g.sq > 0 ? (g.sq - 1) / BM : -1;
  if (g.wr >= 0) q_first = max(0, kv0 - g.wr) / BM;
  if (g.wl >= 0) q_last = min(q_last, (kv0 + BWD_BN - 1 + g.wl) / BM);

  for (int hi = 0; hi < group; ++hi) {
    const long long ho = (long long)(h0 + hi) * g.q_head;
    const float* lh = lse + (long long)(h0 + hi) * g.l_head;
    const float* dh = delta + (long long)(h0 + hi) * g.l_head;
    for (int it = q_first; it <= q_last; ++it) {
      const int q0 = it * BM;
      const int nq = min(BM, g.sq - q0);
      __syncthreads();  // every warp is done with the previous q tile
      bwd_stage<T, D>(qs, q + ho + (long long)q0 * g.q_row, g.q_row, nq, BM, tid);
      bwd_stage<T, D>(dos, dO + ho + (long long)q0 * g.q_row, g.q_row, nq, BM, tid);
      for (int i = tid; i < BM; i += BWD_THREADS) {
        const float l = i < nq ? lh[q0 + i] : -INFINITY;
        l2s[i] = (l == -INFINITY || isnan(l)) ? INFINITY : l * BWD_LOG2E;
        dls[i] = i < nq ? dh[q0 + i] : 0.f;
      }
      __syncthreads();

      // dP^T = V dO^T and S^T = K Q^T for this warp's 16 key rows
      float dp[BM / 8][4], s[BM / 8][4];
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t av[4], ak[4];
        frag_a<T>(av, vs, RS, row0, kc * 16);
        frag_a<T>(ak, ks, RS, row0, kc * 16);
#pragma unroll
        for (int nt = 0; nt < BM / 8; ++nt) {
          uint32_t b[2];
          frag_b<T>(b, dos, RS, nt * 8, kc * 16);
          mma16816<T>(dp[nt], av, b);
          frag_b<T>(b, qs, RS, nt * 8, kc * 16);
          mma16816<T>(s[nt], ak, b);
        }
      }
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = kv0 + row0 + gq + (e >> 1) * 8;  // key position
          const int c = nt * 8 + t4 * 2 + (e & 1);       // q row in the tile
          const int pos = q0 + c;
          bool ok = r < g.sk;
          if (g.wr >= 0) ok = ok && (r <= pos + g.wr);
          if (g.wl >= 0) ok = ok && (r >= pos - g.wl);
          bwd_pair(s[nt][e], dp[nt][e], ok, l2s[c], dls[c], g);
        }
      }

      // dV += P^T dO and dK += dS^T Q: the accumulators are the A operands
#pragma unroll
      for (int kc = 0; kc < BM / 16; ++kc) {
        uint32_t ap[4], ad[4];
        ap[0] = pack2<T>(s[2 * kc][0], s[2 * kc][1]);
        ap[1] = pack2<T>(s[2 * kc][2], s[2 * kc][3]);
        ap[2] = pack2<T>(s[2 * kc + 1][0], s[2 * kc + 1][1]);
        ap[3] = pack2<T>(s[2 * kc + 1][2], s[2 * kc + 1][3]);
        ad[0] = pack2<T>(dp[2 * kc][0], dp[2 * kc][1]);
        ad[1] = pack2<T>(dp[2 * kc][2], dp[2 * kc][3]);
        ad[2] = pack2<T>(dp[2 * kc + 1][0], dp[2 * kc + 1][1]);
        ad[3] = pack2<T>(dp[2 * kc + 1][2], dp[2 * kc + 1][3]);
#pragma unroll
        for (int dt = 0; dt < D / 8; dt += 2) {
          uint32_t b[4];
          frag_b2_trans<T>(b, dos, RS, kc * 16, dt * 8);
          mma16816<T>(dva[dt], ap, b);
          mma16816<T>(dva[dt + 1], ap, b + 2);
          frag_b2_trans<T>(b, qs, RS, kc * 16, dt * 8);
          mma16816<T>(dka[dt], ad, b);
          mma16816<T>(dka[dt + 1], ad, b + 2);
        }
      }
    }
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = row0 + gq + 8 * x;
    if (r < nkv) {
      const long long o = (long long)(kv0 + r) * g.k_row + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(dk + o + dt * 8) = pack2<T>(dka[dt][2 * x], dka[dt][2 * x + 1]);
        *reinterpret_cast<uint32_t*>(dv + o + dt * 8) = pack2<T>(dva[dt][2 * x], dva[dt][2 * x + 1]);
      }
    }
  }
}

// q, dO, dq: (batch or sequence, this q head), row 0; lse, delta: this
// head's row 0; k, v: (batch or sequence, its kv head), row 0. q0 is the
// block's first q row.
template <typename T, int D>
__device__ __forceinline__ void bwd_dq_block(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, const T* __restrict__ dO,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, T* __restrict__ dq,
                                             int q0, const BwdGeom& g, unsigned char* smem) {
  using SM = BwdDqSmem<T, D>;
  constexpr int RS = SM::RS;
  T* qs = reinterpret_cast<T*>(smem + SM::q_off);
  T* dos = reinterpret_cast<T*>(smem + SM::do_off);
  T* ks = reinterpret_cast<T*>(smem + SM::k_off);
  T* vs = reinterpret_cast<T*>(smem + SM::v_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16;
  const int nq = min(BWD_DQ_BM, g.sq - q0);
  bwd_stage<T, D>(qs, q + (long long)q0 * g.q_row, g.q_row, nq, BWD_DQ_BM, tid);
  bwd_stage<T, D>(dos, dO + (long long)q0 * g.q_row, g.q_row, nq, BWD_DQ_BM, tid);
  float l2[2], dl[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = row0 + gq + 8 * x;
    const float l = r < nq ? lse[q0 + r] : -INFINITY;
    l2[x] = (l == -INFINITY || isnan(l)) ? INFINITY : l * BWD_LOG2E;
    dl[x] = r < nq ? delta[q0 + r] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // key tiles of the band (the forward's rule)
  int first = 0, last = (g.sk + BWD_BN - 1) / BWD_BN - 1;
  if (g.wr >= 0) last = min(last, (q0 + BWD_DQ_BM - 1 + g.wr) / BWD_BN);
  if (g.wl >= 0) first = max(0, (q0 - g.wl) / BWD_BN);

  for (int jt = first; jt <= last; ++jt) {
    const int kv0 = jt * BWD_BN;
    const int nkv = min(BWD_BN, g.sk - kv0);
    __syncthreads();  // every warp is done with the previous key tile
    bwd_stage<T, D>(ks, k + (long long)kv0 * g.k_row, g.k_row, nkv, BWD_BN, tid);
    bwd_stage<T, D>(vs, v + (long long)kv0 * g.k_row, g.k_row, nkv, BWD_BN, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 q rows
    float s[BWD_BN / 8][4], dp[BWD_BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BWD_BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t aq[4], ado[4];
      frag_a<T>(aq, qs, RS, row0, kc * 16);
      frag_a<T>(ado, dos, RS, row0, kc * 16);
#pragma unroll
      for (int nt = 0; nt < BWD_BN / 8; ++nt) {
        uint32_t b[2];
        frag_b<T>(b, ks, RS, nt * 8, kc * 16);
        mma16816<T>(s[nt], aq, b);
        frag_b<T>(b, vs, RS, nt * 8, kc * 16);
        mma16816<T>(dp[nt], ado, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BWD_BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = q0 + row0 + gq + (e >> 1) * 8;
        const int c = kv0 + nt * 8 + t4 * 2 + (e & 1);
        bool ok = c < g.sk;
        if (g.wr >= 0) ok = ok && (c <= pos + g.wr);
        if (g.wl >= 0) ok = ok && (c >= pos - g.wl);
        bwd_pair(s[nt][e], dp[nt][e], ok, l2[e >> 1], dl[e >> 1], g);
      }
    }

    // dQ += dS K: the dS accumulator is the A operand, K comes transposed
#pragma unroll
    for (int kc = 0; kc < BWD_BN / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack2<T>(dp[2 * kc][0], dp[2 * kc][1]);
      a[1] = pack2<T>(dp[2 * kc][2], dp[2 * kc][3]);
      a[2] = pack2<T>(dp[2 * kc + 1][0], dp[2 * kc + 1][1]);
      a[3] = pack2<T>(dp[2 * kc + 1][2], dp[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t b[4];
        frag_b2_trans<T>(b, ks, RS, kc * 16, dt * 8);
        mma16816<T>(acc[dt], a, b);
        mma16816<T>(acc[dt + 1], a, b + 2);
      }
    }
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = row0 + gq + 8 * x;
    if (r < nq) {
      T* o = dq + (long long)(q0 + r) * g.q_row + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        *reinterpret_cast<uint32_t*>(o + dt * 8) = pack2<T>(acc[dt][2 * x], acc[dt][2 * x + 1]);
    }
  }
}
