// The flash-attention backward for Hopper (sm_90a) on wgmma and TMA, in two
// kernels:
//  - bwd_kernel<T, D, DQ = true>: dQ, dK and dV in one pass (kernel 11,
//    mfa_bwd_fused in backward.cu), replacing
//    mfa_tpu/kernels/backward.py:_fused_bwd_kernel.
//  - bwd_kernel<T, D, DQ = false, PACKED>: dK and dV alone, the first launch
//    of the deterministic split: dense (kernel 12, mfa_bwd_dkv), replacing
//    _dkv_kernel / _dkv_tri_kernel (_dkv_body), and packed (kernel 14's
//    first launch, mfa_varlen_bwd_dkv), replacing _vl_dkv_kernel. No dQ
//    step: no dS^T buffers, no consumer barrier, no dQ product, tile or
//    reduction; the shared memory this frees holds a third ring slot. A
//    block owns its keys and sums dK and dV over the group's q heads and
//    the band's q tiles in registers in a fixed order and stores them
//    once, so its results are the same bits run to run.
//  - dq_kernel<T, D, PACKED>: dQ alone, the split's second launch: dense
//    (kernel 13, mfa_bwd_dq), replacing _dq_kernel / _dq_tri_kernel
//    (_dq_body), and packed (kernel 14's second launch, mfa_varlen_bwd_dq),
//    replacing _vl_dq_kernel. Its block is the forward's tile
//    (flash_fwd_sm90.cuh): it owns q rows and walks the band's key tiles
//    (below).
// The packed layout (PACKED) differs from the dense one only in the
// addressing, as kernel 7 does from kernel 1: strided tensor maps over
// (D, total, heads), the sequence's first rows as box coordinates from
// cu_seqlens, LSE and delta [hq, total_q], and the rows' stride in the
// stores. So on equal lengths kernel 14 gives the bits of kernels 12 + 13.
// All compute the function of kernels/backward.py:_bwd_plain:
//
//   P  = exp2(S * c - LSE * log2e),  S = Q K^T (softcap: cap * tanh(S * scale / cap))
//   dV = P^T dO     dS = P * (dO V^T - delta) * scale (* (1 - tanh^2))
//   dK = dS^T Q     dQ = dS K
//
// with delta = rowsum(dO * O) from the caller in fp32, P = 0 on rows whose
// LSE is -inf, and dK, dV summed over the GQA group. Layout: q, dO [b, hq,
// sq, D], k, v, dK, dV [b, hkv, sk, D], LSE and delta [b, hq, sq] fp32, or
// packed q, dO [total_q, hq, D], k, v [total_k, hkv, D], LSE and delta
// [hq, total_q]; the fused kernel adds dQ into a zeroed fp32 workspace
// [b, hq, sq, D], the split's dQ launch stores it in the dtype.
//
// Bound: tensor-core operations, 5 products of 2 D flops per visible (row,
// key) pair and q head (4 in dK/dV, 3 in dQ). bwd_kernel follows
// FlashAttention-3's Hopper backward (arXiv 2407.08608):
//  - One block of 384 threads owns BN = 128 keys of one kv head. Warpgroup
//    0 is the producer (setmaxnreg 24): thread 0 loads K and V once by TMA
//    and each (q head, 64-row q tile) of Q and dO into a ring of 2 slots
//    with full and empty mbarriers; warp 1 stages that tile's LSE (as log2,
//    +inf on a dead row or past sq) and delta into the same slot. The two
//    consumer warpgroups (setmaxnreg 240) own 64 keys each and keep their
//    dK and dV accumulators in registers to the end.
//  - The transposed products keep every accumulator where the next product
//    needs it: S^T = K Q^T and dP^T = V dO^T (wgmma, both operands K-major
//    in shared memory, M = 64 keys, N = 64 rows); P^T and dS^T rounded to T
//    in registers are the register A operands of dV += P^T dO and dK +=
//    dS^T Q, whose B operands are dO and Q as stored (MN-major, the
//    transpose bit).
//  - dQ = dS K (DQ only) needs all 128 keys: each consumer writes its dS^T to a
//    swizzled shared buffer (two of them, by tile parity), a named barrier
//    of the two consumers follows, and each computes half of dQ's D columns
//    as a wgmma with both operands MN-major (A = the dS^T buffer, B = K).
//    The two halves go to a swizzled fp32 tile in shared memory, and one
//    thread adds the tile into the workspace with bulk TMA reductions
//    (cp.reduce.async.bulk.tensor .add.f32, done in L2 a whole line at a
//    time; rows past sq are skipped by the map's bound), where fp32 atomics
//    from registers would send one scattered L2 operation per value.
//  - The block walks only the q tiles the band lets see its keys; a
//    warpgroup whose 64 keys no row of a tile sees skips its products
//    there but still waits for and releases the slot (the ring's phases
//    stay in step) and takes its half of dQ over the live keys only. Key
//    rows that no q row sees keep dK = dV = 0 and are stored.
//  - Only tiles that cross the band's edge or the key tail are masked
//    element by element; P = 0 is set explicitly there. Rows past sq read
//    as zeros (the tensor map's bound) or, packed, as the next sequence's
//    rows, with LSE +inf, so they add nothing.
// dq_kernel is the forward's block shape with the backward's products:
//  - 384 threads own 128 q rows of one q head: Q and dO of those rows are
//    loaded once by TMA and stay in shared memory; the band's key tiles of
//    K and V (BN keys) stream through a 2-slot TMA ring with full and empty
//    mbarriers. The producer warpgroup (setmaxnreg 24) issues the loads,
//    two consumer warpgroups (setmaxnreg 240) own 64 rows each, with their
//    two rows' LSE (log2, +inf on a dead row or past sq) and delta in
//    registers.
//  - Per key tile, S = Q K^T and dP = dO V^T are two SS wgmma chains (the
//    forward's S product); P and dS = P (dP - delta) scale are formed in
//    the accumulators, dS rounded to T is the register A operand of dQ +=
//    dS K, whose B operand is K as stored (MN-major, the transpose bit),
//    as the forward's O += P V reads V.
//  - The elementwise step is one of four copies of its loop (ds_tile:
//    softcap or not, masked or not), chosen once per tile. With the two
//    tests inside the unrolled loop the launch took 2.2x as long at the
//    train shape (PERF.md §6).
//  - BN = 64 keys a tile (S, dP and dQ are 32 + 32 + D / 2 fp32 registers
//    a thread). 128 keys do not fit 240 registers at D 128 and spill at D
//    64; Q and dO as register A operands of S and dP spill at D 128.
//  - The forward's band walk (fa90::span_of per warpgroup, the block
//    loads the union) and its needs_mask rule; blocks launch longest
//    causal tiles first. dQ stays in registers and is stored once, rows <
//    sq only (a packed box's tail rows belong to the next sequence): no
//    atomics, so the launch is deterministic. A block whose rows see no
//    key loads nothing and stores dQ = 0.
#pragma once

#include "flash_fwd_sm90.cuh"

namespace fb90 {

constexpr int BN = 128;       // keys a block
constexpr int WG_N = 64;      // keys a consumer warpgroup
constexpr int BM = 64;        // q rows a ring slot
constexpr int THREADS = 384;  // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  int hq, hkv, sq, sk, wl, wr;
  float scale;        // softmax scale (dS carries it)
  float c2;           // (capped) score -> log2 domain multiplier
  float softcap, softcap_mul;
  // the packed layout: [batch + 1] sequence offsets and q's row count; sq
  // and sk are then each block's own sequence's lengths
  const int* cu_q = nullptr;
  const int* cu_k = nullptr;
  int total_q = 0;
};

// Shared memory (every tile 1024-byte aligned, 128-byte swizzled rows):
// K, V [D/64][BN][64]; STAGES Q and dO slots [D/64][BM][64] (2 with the dQ
// step, 3 without); with the dQ step two dS^T buffers [BN][BM] and the
// fp32 dQ tile [D/32][BM][32]; per slot the log2 LSE and delta of its BM
// rows; the barriers (kv, full[STAGES], empty[STAGES]).
template <int D, bool DQ>
struct Plan {
  static constexpr int STAGES = DQ ? 2 : 3;
  static constexpr uint32_t KV_BYTES = BN * D * 2;
  static constexpr uint32_t Q_BYTES = BM * D * 2;
  static constexpr uint32_t DS_BYTES = DQ ? BN * BM * 2 : 0;
  static constexpr uint32_t DQ_BYTES = DQ ? BM * D * 4 : 0;
  static constexpr uint32_t k_off = 0;
  static constexpr uint32_t v_off = KV_BYTES;
  static constexpr uint32_t q_off = 2 * KV_BYTES;
  static constexpr uint32_t do_off = q_off + STAGES * Q_BYTES;
  static constexpr uint32_t ds_off = do_off + STAGES * Q_BYTES;
  static constexpr uint32_t dq_off = ds_off + 2 * DS_BYTES;
  static constexpr uint32_t row_off = dq_off + DQ_BYTES;
  static constexpr uint32_t bar_off = row_off + STAGES * 2 * BM * 4;
  // + 1 KB to align the base; at least 120 KB, so that two blocks never
  // share an SM (their setmaxnreg requests could not both be met)
  static constexpr size_t bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024 > 120 * 1024
                                      ? bar_off + 8 * (1 + 2 * STAGES) + 1024
                                      : 120 * 1024;
};

__device__ __forceinline__ uint32_t bar_kv(uint32_t bars) { return bars; }
__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) { return bars + 8 * (1 + s); }
template <int STAGES>
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (1 + STAGES + s);
}

// Whether some row of [q0, q0 + BM) sees some key of [k0, k0 + WG_N).
__device__ __forceinline__ bool sees(int k0, int q0, const Args& a) {
  const int k_hi = min(k0 + WG_N, a.sk) - 1, r_hi = min(q0 + BM, a.sq) - 1;
  if (k0 > k_hi || q0 > r_hi) return false;
  if (a.wr >= 0 && k0 > r_hi + a.wr) return false;
  if (a.wl >= 0 && k_hi < q0 - a.wl) return false;
  return true;
}

// Grid (hkv, batch, ceil(sk / BN)), packed (hkv, sequence, ceil(max_sk /
// BN)): the key tile is the slowest axis, so the causal blocks with the
// most q tiles (the first keys) launch first.
template <typename T, int D, bool DQ, bool PACKED = false>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
               const Args args) {
  static_assert(!(DQ && PACKED), "the packed layout runs the split's dK/dV launch");
  using P = Plan<D, DQ>;
  constexpr int STAGES = P::STAGES;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * BN;
  Args a = args;
  int q_row0 = 0, k_row0 = 0;  // the sequence's first rows in the maps
  if constexpr (PACKED) {
    // Keys of a sequence are followed by the next sequence's: keys >= sk
    // are masked (needs_mask) and never stored; q rows >= sq get LSE +inf.
    k_row0 = a.cu_k[b];
    a.sk = a.cu_k[b + 1] - k_row0;
    if (kv0 >= a.sk) return;  // tile past this sequence: the whole block leaves
    q_row0 = a.cu_q[b];
    a.sq = a.cu_q[b + 1] - q_row0;
  }
  const int group = a.hq / a.hkv, h0 = hk * group;
  // q tiles that see a key of this block (the transpose of the forward's
  // band: row r sees key c when r - wl <= c <= r + wr)
  const int kv_hi = min(kv0 + BN, a.sk) - 1;
  int q_first = 0, q_last = (a.sq + BM - 1) / BM - 1;
  if (a.wr >= 0) q_first = max(0, kv0 - a.wr) / BM;
  if (a.wl >= 0) q_last = min(q_last, (kv_hi + a.wl) / BM);
  const int per_head = max(0, q_last - q_first + 1);
  const int n_tiles = group * per_head;

  extern __shared__ __align__(16) unsigned char fb90_smem[];
  unsigned char* smem = fb90_smem + ((1024u - (smem_u32(fb90_smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + P::bar_off;
  float* rows = reinterpret_cast<float*>(smem + P::row_off);  // [STAGES][l2, delta][BM]

  if (threadIdx.x == 0) {
    mbar_init(bar_kv(bars), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(bars, s), 1 + 32);  // the TMA thread and warp 1's lanes
      mbar_init(bar_empty<STAGES>(bars, s), 2 * 128);  // every consumer thread releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg == 0) {
    regs_dec<PRODUCER_REGS>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
      // map planes: (batch, head) matrices, or one head's packed rows
      const int bh_kv = PACKED ? hk : b * a.hkv + hk;
      mbar_expect_tx(bar_kv(bars), 2 * P::KV_BYTES);
#pragma unroll
      for (int ch = 0; ch < D / 64; ++ch) {
        tma_load_3d(base + P::k_off + ch * (BN * 128), &tk, bar_kv(bars), ch * 64,
                    k_row0 + kv0, bh_kv);
        tma_load_3d(base + P::v_off + ch * (BN * 128), &tv, bar_kv(bars), ch * 64,
                    k_row0 + kv0, bh_kv);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, hi = i / per_head;
        const int q0 = q_row0 + (q_first + i % per_head) * BM;
        const int bh_q = PACKED ? h0 + hi : b * a.hq + h0 + hi;
        mbar_wait(bar_empty<STAGES>(bars, s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full(bars, s), 2 * P::Q_BYTES);
        const uint32_t q_s = base + P::q_off + s * P::Q_BYTES;
        const uint32_t do_s = base + P::do_off + s * P::Q_BYTES;
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch) {
          tma_load_3d(q_s + ch * (BM * 128), &tq, bar_full(bars, s), ch * 64, q0, bh_q);
          tma_load_3d(do_s + ch * (BM * 128), &tdo, bar_full(bars, s), ch * 64, q0, bh_q);
        }
      }
    } else if (warp == 1) {
      // the tile's LSE as log2 (+inf: P = 0) and delta, two rows a lane
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, hi = i / per_head, q0 = (q_first + i % per_head) * BM;
        const size_t row0 = PACKED ? (size_t)(h0 + hi) * a.total_q + q_row0
                                   : (size_t)(b * a.hq + h0 + hi) * a.sq;
        mbar_wait(bar_empty<STAGES>(bars, s), ((i / STAGES) & 1) ^ 1);
        float* slot = rows + s * 2 * BM;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int r = lane + 32 * x, pos = q0 + r;
          const float l = pos < a.sq ? lse[row0 + pos] : -INFINITY;
          slot[r] = (l == -INFINITY || isnan(l)) ? INFINITY : l * LOG2E;
          slot[BM + r] = pos < a.sq ? delta[row0 + pos] : 0.f;
        }
        mbar_arrive(bar_full(bars, s));
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    const int w = wg - 1, wtid = threadIdx.x & 127;
    const int lane = wtid & 31, g = lane >> 2, t4 = lane & 3, wi = wtid >> 5;
    const int key_lo = kv0 + w * WG_N;     // this warpgroup's first key
    const int r0 = key_lo + wi * 16 + g;   // this thread's keys: r0 and r0 + 8
    const uint32_t k_w = base + P::k_off + w * (WG_N * 128);  // its rows of each K chunk
    const uint32_t v_w = base + P::v_off + w * (WG_N * 128);
    // its half of dQ's columns: B = K from column dq_col0 on
    constexpr int DQ_N = D / 2;
    const int dq_col0 = w * DQ_N;
    const uint32_t k_dq = base + P::k_off + (dq_col0 / 64) * (BN * 128) + (dq_col0 % 64) * 2;
    const uint32_t dq_s = base + P::dq_off;
    const bool issuer = wg == 1 && wtid == 0;  // issues the dQ reductions

    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dka[x] = dva[x] = 0.f;

    mbar_wait(bar_kv(bars), 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES, hi = i / per_head, q0 = (q_first + i % per_head) * BM;
      const int h = h0 + hi;
      const bool live0 = sees(kv0, q0, a), live1 = sees(kv0 + WG_N, q0, a);
      const uint32_t q_s = base + P::q_off + s * P::Q_BYTES;
      const uint32_t do_s = base + P::do_off + s * P::Q_BYTES;
      const uint32_t ds_s = base + P::ds_off + (i & 1) * P::DS_BYTES;
      mbar_wait(bar_full(bars, s), (i / STAGES) & 1);

      if (w == 0 ? live0 : live1) {
        // S^T = K Q^T and dP^T = V dO^T: D / 16 steps each
        float st[BM / 2], dp[BM / 2];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ko = (kk >> 2) * (BN * 128) + (kk & 3) * 32;
          const uint32_t qo = (kk >> 2) * (BM * 128) + (kk & 3) * 32;
          wgmma_ss<T, BM>(st, sw128_desc(k_w + ko, 0), sw128_desc(q_s + qo, 0), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t ko = (kk >> 2) * (BN * 128) + (kk & 3) * 32;
          const uint32_t qo = (kk >> 2) * (BM * 128) + (kk & 3) * 32;
          wgmma_ss<T, BM>(dp, sw128_desc(v_w + ko, 0), sw128_desc(do_s + qo, 0), kk > 0);
        }
        wg_commit();
        wg_wait_all();
        fence_regs(st);
        fence_regs(dp);

        // P^T and dS^T in place; column c of the accumulators is q row q0 + c
        const float* l2s = rows + s * 2 * BM;
        const float* dls = l2s + BM;
        const bool needs_mask = (key_lo + WG_N > a.sk) ||
                                (a.wr >= 0 && key_lo + WG_N - 1 > q0 + a.wr) ||
                                (a.wl >= 0 && key_lo < q0 + BM - 1 - a.wl);
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(l2s + 8 * j + 2 * t4);
          const float2 dl = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = q0 + 8 * j + 2 * t4 + (e & 1);
            const int key = r0 + 8 * (e >> 1);
            bool ok = true;
            if (needs_mask) {
              ok = key < a.sk;
              if (a.wr >= 0) ok = ok && key <= col + a.wr;
              if (a.wl >= 0) ok = ok && key >= col - a.wl;
            }
            float x = st[4 * j + e], dcap = 1.f;
            if (a.softcap > 0.f) {
              const float t = tanhf(x * a.softcap_mul);
              x = t * a.softcap;
              dcap = 1.f - t * t;
            }
            const float p = ok ? exp2f(x * a.c2 - ((e & 1) ? l2.y : l2.x)) : 0.f;
            st[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x)) * a.scale * dcap;
          }
        }

        // P^T and dS^T rounded to T: 16 columns are one register A fragment
        uint32_t pa[BM / 16][4], da[BM / 16][4];
#pragma unroll
        for (int kc = 0; kc < BM / 16; ++kc) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            pa[kc][x] = pack2<T>(st[8 * kc + 2 * x], st[8 * kc + 2 * x + 1]);
            da[kc][x] = pack2<T>(dp[8 * kc + 2 * x], dp[8 * kc + 2 * x + 1]);
          }
        }
        if constexpr (DQ) {
          // dS^T into the swizzled [BN keys][BM rows] buffer: the pair
          // da[kc][x] is key row 64 w + 16 wi + g + 8 (x & 1), 16-byte unit
          // 2 kc + x / 2
#pragma unroll
          for (int kc = 0; kc < BM / 16; ++kc) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int row = w * WG_N + wi * 16 + g + 8 * (x & 1);
              const int unit = (2 * kc + (x >> 1)) ^ g;
              asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(ds_s + row * 128 + unit * 16 +
                                                              4 * t4),
                           "r"(da[kc][x])
                           : "memory");
            }
          }
          fence_async_smem();
        }

        // dV += P^T dO and dK += dS^T Q: 16 q rows a step (2048 bytes of a chunk)
        fence_regs(dva);
        fence_regs(dka);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < BM / 16; ++kc)
          wgmma_rs<T, D>(dva, pa[kc], sw128_desc(do_s + kc * 2048, BM * 128), 1);
#pragma unroll
        for (int kc = 0; kc < BM / 16; ++kc)
          wgmma_rs<T, D>(dka, da[kc], sw128_desc(q_s + kc * 2048, BM * 128), 1);
        wg_commit();
      }

      if constexpr (DQ) {
        // the previous tile's dQ reductions have read the dQ tile
        if (issuer) bulk_wait_read();
        named_sync(1, 2 * 128);  // both halves of dS^T are in shared memory

        // dQ[:, dq_col0 : + D/2] = dS K over the live keys: A = dS^T read
        // MN-major, B = K MN-major, 16 keys (2048 bytes) a step
        const int kk_lo = live0 ? 0 : WG_N / 16, kk_hi = live1 ? BN / 16 : WG_N / 16;
        float dq[DQ_N / 2];
#pragma unroll
        for (int x = 0; x < DQ_N / 2; ++x) dq[x] = 0.f;
        if (kk_lo < kk_hi) {
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < BN / 16; ++kk) {
            if (kk >= kk_lo && kk < kk_hi)
              wgmma_ss_t<T, DQ_N, 1, 1>(dq, sw128_desc(ds_s + kk * 2048, BN * 128),
                                        sw128_desc(k_dq + kk * 2048, BN * 128), 1);
          }
          wg_commit();
        }
        wg_wait_all();
        fence_regs(dka);
        fence_regs(dva);
        fence_regs(dq);
        mbar_arrive(bar_empty<STAGES>(bars, s));  // Q, dO, LSE and delta of the slot are read

        if (kk_lo < kk_hi) {
          // this half of dQ into the fp32 tile: 32-column chunks of 128-byte
          // rows, 16-byte unit u of row r at unit u ^ (r % 8) (conflict-free)
#pragma unroll
          for (int j = 0; j < DQ_N / 8; ++j) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int r = wi * 16 + g + 8 * x, col = dq_col0 + 8 * j + 2 * t4;
              const uint32_t at = dq_s + (col >> 5) * (BM * 128) + r * 128 +
                                  ((((col & 31) >> 2) ^ g) << 4) + (col & 3) * 4;
              asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at),
                           "f"(dq[4 * j + 2 * x]), "f"(dq[4 * j + 2 * x + 1])
                           : "memory");
            }
          }
          fence_async_smem();
          named_sync(2, 2 * 128);  // both halves of the dQ tile are written
          if (issuer) {
#pragma unroll
            for (int ch = 0; ch < D / 32; ++ch)
              tma_reduce_add_3d(&tdq, dq_s + ch * (BM * 128), ch * 32, q0, b * a.hq + h);
            bulk_commit();
          }
        }
      } else {
        wg_wait_all();
        fence_regs(dka);
        fence_regs(dva);
        mbar_arrive(bar_empty<STAGES>(bars, s));  // Q, dO, LSE and delta of the slot are read
      }
    }
    if constexpr (DQ) {
      if (issuer) bulk_wait();
    }

    // dK and dV of this warpgroup's keys < sk
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int key = r0 + 8 * x;
      if (key < a.sk) {
        const size_t o = (PACKED ? (size_t)(k_row0 + key) * a.hkv + hk
                                 : (size_t)(b * a.hkv + hk) * a.sk + key) *
                             D +
                         2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dk + o + 8 * j) =
              pack2<T>(dka[4 * j + 2 * x], dka[4 * j + 2 * x + 1]);
          *reinterpret_cast<uint32_t*>(dv + o + 8 * j) =
              pack2<T>(dva[4 * j + 2 * x], dva[4 * j + 2 * x + 1]);
        }
      }
    }
  }
}

// Encode the tensor maps (the dQ workspace's only with DQ) and launch (sq >
// 0, sk > 0). Returns a cudaError_t code, MFA_TMA_ENCODE, or 0.
template <typename T, int D, bool DQ>
int launch(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           const float* delta, float* dq_ws, void* dk, void* dv, int batch, const Args& a,
           cudaStream_t stream) {
  using P = Plan<D, DQ>;
  constexpr bool BF = kIsBf16<T>;
  CUtensorMap tq, tk, tv, tdo, tdq = {};
  if (int err = mfa_tensor_map_3d(&tq, q, BF, D, a.sq, batch * a.hq, BM)) return err;
  if (int err = mfa_tensor_map_3d(&tdo, dO, BF, D, a.sq, batch * a.hq, BM)) return err;
  if (int err = mfa_tensor_map_3d(&tk, k, BF, D, a.sk, batch * a.hkv, BN)) return err;
  if (int err = mfa_tensor_map_3d(&tv, v, BF, D, a.sk, batch * a.hkv, BN)) return err;
  // the fp32 workspace [b * hq, sq, D] in boxes of 32 columns x BM rows
  if (DQ) {
    if (int err = mfa_encode_3d(&tdq, dq_ws, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, D, a.sq,
                                batch * a.hq, (size_t)D * 4, (size_t)a.sq * D * 4, 32, BM))
      return err;
  }
  auto kern = bwd_kernel<T, D, DQ>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  const dim3 grid(a.hkv, batch, (a.sk + BN - 1) / BN);
  kern<<<grid, THREADS, P::bytes, stream>>>(tq, tk, tv, tdo, tdq, lse, delta,
                                            static_cast<T*>(dk), static_cast<T*>(dv), a);
  return (int)cudaGetLastError();
}

// The packed maps: q and dO (D, total_q, hq), k and v (D, total_k, hkv),
// strided, in boxes of q_box and k_box rows. A layout with no rows (total
// 0) is never loaded; its maps only need a valid base, the other tensor's.
template <typename T, int D>
int packed_maps(CUtensorMap* tq, CUtensorMap* tdo, CUtensorMap* tk, CUtensorMap* tv,
                const void* q, const void* dO, const void* k, const void* v, int total_k,
                int q_box, int k_box, const Args& a) {
  constexpr bool BF = kIsBf16<T>;
  const size_t row_q = (size_t)a.hq * D * 2, row_k = (size_t)a.hkv * D * 2;
  const bool qs = a.total_q > 0, ks = total_k > 0;
  if (int err = mfa_tensor_map_3d_strided(tq, qs ? q : k, BF, D, qs ? a.total_q : total_k,
                                          qs ? a.hq : a.hkv, qs ? row_q : row_k, D * 2, q_box))
    return err;
  if (int err = mfa_tensor_map_3d_strided(tdo, qs ? dO : v, BF, D, qs ? a.total_q : total_k,
                                          qs ? a.hq : a.hkv, qs ? row_q : row_k, D * 2, q_box))
    return err;
  if (int err = mfa_tensor_map_3d_strided(tk, ks ? k : q, BF, D, ks ? total_k : a.total_q,
                                          ks ? a.hkv : a.hq, ks ? row_k : row_q, D * 2, k_box))
    return err;
  return mfa_tensor_map_3d_strided(tv, ks ? v : dO, BF, D, ks ? total_k : a.total_q,
                                   ks ? a.hkv : a.hq, ks ? row_k : row_q, D * 2, k_box);
}

// Kernel 14's dK/dV launch: bwd_kernel<T, D, false, true> on q, dO
// [total_q, hq, D], k, v, dk, dv [total_k, hkv, D], LSE and delta [hq,
// total_q]; a.cu_q, a.cu_k (device, [batch + 1]) and a.total_q set, max_sk
// > 0 bounds every sequence's key length.
template <typename T, int D>
int launch_packed_dkv(const void* q, const void* k, const void* v, const void* dO,
                      const float* lse, const float* delta, void* dk, void* dv, int batch,
                      int total_k, int max_sk, const Args& a, cudaStream_t stream) {
  using P = Plan<D, false>;
  CUtensorMap tq, tk, tv, tdo, tdq = {};
  if (int err = packed_maps<T, D>(&tq, &tdo, &tk, &tv, q, dO, k, v, total_k, BM, BN, a))
    return err;
  auto kern = bwd_kernel<T, D, false, true>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  const dim3 grid(a.hkv, batch, (max_sk + BN - 1) / BN);
  kern<<<grid, THREADS, P::bytes, stream>>>(tq, tk, tv, tdo, tdq, lse, delta,
                                            static_cast<T*>(dk), static_cast<T*>(dv), a);
  return (int)cudaGetLastError();
}

// -- dq_kernel: the split's dQ launch (kernels 13 and 14) ---------------------

constexpr int DQ_BM = 128;  // q rows a dQ block: two consumer warpgroups of BM

// Shared memory (every tile 1024-byte aligned, 128-byte swizzled rows): Q
// and dO [D/64][DQ_BM][64]; STAGES K and V slots [D/64][BN][64] each; the
// barriers (Q, full[STAGES], empty[STAGES]).
template <int D>
struct DqPlan {
  static constexpr int BN = 64;  // keys a ring slot
  static constexpr int STAGES = 2;
  static constexpr uint32_t Q_BYTES = DQ_BM * D * 2;
  static constexpr uint32_t KV_BYTES = BN * D * 2;
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t do_off = Q_BYTES;
  static constexpr uint32_t k_off = 2 * Q_BYTES;
  static constexpr uint32_t v_off = k_off + STAGES * KV_BYTES;
  static constexpr uint32_t bar_off = v_off + STAGES * KV_BYTES;
  // + 1 KB to align the base; at least 120 KB (one block an SM, as above)
  static constexpr size_t bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024 > 120 * 1024
                                      ? bar_off + 8 * (1 + 2 * STAGES) + 1024
                                      : 120 * 1024;
};

// dS = P (dP - delta) scale (* (1 - tanh^2)) in place of dP, P = exp2(S c2
// - LSE2) or 0 where masked; the thread's rows r0, r0 + 8 and columns kv0 +
// 8 j + 2 t4 + {0, 1} of the accumulators. CAP and MASK are the runtime
// softcap and needs_mask, fixed per call so that the loop tests neither.
template <int KN, bool CAP, bool MASK>
__device__ __forceinline__ void ds_tile(float (&sc)[KN / 2], float (&dp)[KN / 2], const Args& a,
                                        int kv0, int r0, int t4, const float (&l2)[2],
                                        const float (&dl)[2]) {
#pragma unroll
  for (int j = 0; j < KN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool ok = true;
      if constexpr (MASK) {
        const int col = kv0 + 8 * j + 2 * t4 + (e & 1);
        const int row = r0 + 8 * (e >> 1);
        ok = col < a.sk;
        if (a.wr >= 0) ok = ok && col <= row + a.wr;
        if (a.wl >= 0) ok = ok && col >= row - a.wl;
      }
      float x = sc[4 * j + e], dcap = 1.f;
      if constexpr (CAP) {
        const float t = tanhf(x * a.softcap_mul);
        x = t * a.softcap;
        dcap = 1.f - t * t;
      }
      const float p = ok ? exp2f(x * a.c2 - l2[e >> 1]) : 0.f;
      dp[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]) * a.scale * dcap;
    }
  }
}

// Grid (hq, batch, ceil(sq / DQ_BM)), packed (hq, sequence, ceil(max_sq /
// DQ_BM)); the q tile is the slowest axis, reversed: the causal blocks
// with the most key tiles (the last rows) launch first.
template <typename T, int D, bool PACKED>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, const Args args) {
  using P = DqPlan<D>;
  constexpr int KN = P::BN, STAGES = P::STAGES;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_BM;
  Args a = args;
  int q_row0 = 0, k_row0 = 0;  // the sequence's first rows in the maps
  if constexpr (PACKED) {
    // Rows of a sequence are followed by the next sequence's: key columns
    // >= sk are masked (needs_mask), q rows >= sq are computed and never
    // stored.
    q_row0 = a.cu_q[b];
    a.sq = a.cu_q[b + 1] - q_row0;
    if (q0 >= a.sq) return;  // tile past this sequence: the whole block leaves
    k_row0 = a.cu_k[b];
    a.sk = a.cu_k[b + 1] - k_row0;
  }
  const int hk = h / (a.hq / a.hkv);
  const bool two = q0 + BM < a.sq;  // the second warpgroup has rows
  const fa90::Span s0 = fa90::span_of(q0, q0 + BM - 1, a.sk, a.wl, a.wr, KN);
  const fa90::Span s1 = two ? fa90::span_of(q0 + BM, q0 + DQ_BM - 1, a.sk, a.wl, a.wr, KN)
                            : fa90::Span{1, 0};
  const int first = s0.first, n_tiles = max(0, (two ? s1.last : s0.last) - first + 1);

  extern __shared__ __align__(16) unsigned char fb90_smem[];
  unsigned char* smem = fb90_smem + ((1024u - (smem_u32(fb90_smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + P::bar_off;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv(bars), 1);  // Q and dO
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(bars, s), 1);
      mbar_init(bar_empty<STAGES>(bars, s), 2 * 128);  // every consumer thread releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg == 0) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      // map planes: (batch, head) matrices, or one head's packed rows
      const int bh_q = PACKED ? h : b * a.hq + h, bh_kv = PACKED ? hk : b * a.hkv + hk;
      mbar_expect_tx(bar_kv(bars), 2 * P::Q_BYTES);
#pragma unroll
      for (int ch = 0; ch < D / 64; ++ch) {
        tma_load_3d(base + P::q_off + ch * (DQ_BM * 128), &tq, bar_kv(bars), ch * 64,
                    q_row0 + q0, bh_q);
        tma_load_3d(base + P::do_off + ch * (DQ_BM * 128), &tdo, bar_kv(bars), ch * 64,
                    q_row0 + q0, bh_q);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, kv0 = k_row0 + (first + i) * KN;
        mbar_wait(bar_empty<STAGES>(bars, s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full(bars, s), 2 * P::KV_BYTES);
        const uint32_t k_s = base + P::k_off + s * P::KV_BYTES;
        const uint32_t v_s = base + P::v_off + s * P::KV_BYTES;
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch)
          tma_load_3d(k_s + ch * (KN * 128), &tk, bar_full(bars, s), ch * 64, kv0, bh_kv);
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch)
          tma_load_3d(v_s + ch * (KN * 128), &tv, bar_full(bars, s), ch * 64, kv0, bh_kv);
      }
    }
  } else {
    regs_inc<CONSUMER_REGS>();
    const int w = wg - 1, wtid = threadIdx.x & 127;
    const int lane = wtid & 31, g = lane >> 2, t4 = lane & 3;
    const int pos_lo = q0 + w * BM, pos_hi = pos_lo + BM - 1;
    const int r0 = pos_lo + (wtid >> 5) * 16 + g;  // this thread's rows: r0 and r0 + 8
    const fa90::Span mine = w == 0 ? s0 : s1;
    const uint32_t q_wg = base + P::q_off + w * (BM * 128);  // its rows of each chunk
    const uint32_t do_wg = base + P::do_off + w * (BM * 128);
    // LSE [b, hq, sq] and delta, or packed [hq, total_q]
    const size_t row_base =
        PACKED ? (size_t)h * a.total_q + q_row0 : (size_t)(b * a.hq + h) * a.sq;
    float l2[2], dl[2];  // the rows' LSE as log2 (+inf: P = 0) and delta
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r0 + 8 * x;
      const float l = r < a.sq ? lse[row_base + r] : -INFINITY;
      l2[x] = (l == -INFINITY || isnan(l)) ? INFINITY : l * LOG2E;
      dl[x] = r < a.sq ? delta[row_base + r] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) acc[x] = 0.f;

    if (n_tiles > 0) mbar_wait(bar_kv(bars), 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int jt = first + i, s = i % STAGES;
      mbar_wait(bar_full(bars, s), (i / STAGES) & 1);
      if (jt >= mine.first && jt <= mine.last) {
        const int kv0 = jt * KN;
        const uint32_t k_s = base + P::k_off + s * P::KV_BYTES;
        const uint32_t v_s = base + P::v_off + s * P::KV_BYTES;

        // S = Q K^T and dP = dO V^T: D / 16 steps each, 32 bytes apart
        // inside a 64-column chunk
        float sc[KN / 2], dp[KN / 2];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qo = (kk >> 2) * (DQ_BM * 128) + (kk & 3) * 32;
          const uint32_t ko = (kk >> 2) * (KN * 128) + (kk & 3) * 32;
          wgmma_ss<T, KN>(sc, sw128_desc(q_wg + qo, 0), sw128_desc(k_s + ko, 0), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qo = (kk >> 2) * (DQ_BM * 128) + (kk & 3) * 32;
          const uint32_t ko = (kk >> 2) * (KN * 128) + (kk & 3) * 32;
          wgmma_ss<T, KN>(dp, sw128_desc(do_wg + qo, 0), sw128_desc(v_s + ko, 0), kk > 0);
        }
        wg_commit();
        // mask only tiles that cross the key tail or the band's edge
        const bool needs_mask = (kv0 + KN > a.sk) ||
                                (a.wr >= 0 && kv0 + KN - 1 > pos_lo + a.wr) ||
                                (a.wl >= 0 && kv0 < pos_hi - a.wl);
        wg_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        // dS in place of dP; column c of the accumulators is key kv0 + c
        if (a.softcap > 0.f) {
          if (needs_mask)
            ds_tile<KN, true, true>(sc, dp, a, kv0, r0, t4, l2, dl);
          else
            ds_tile<KN, true, false>(sc, dp, a, kv0, r0, t4, l2, dl);
        } else {
          if (needs_mask)
            ds_tile<KN, false, true>(sc, dp, a, kv0, r0, t4, l2, dl);
          else
            ds_tile<KN, false, false>(sc, dp, a, kv0, r0, t4, l2, dl);
        }

        // dS rounded to T: 16 keys are one register A fragment of dQ += dS K
        uint32_t da[KN / 16][4];
#pragma unroll
        for (int kc = 0; kc < KN / 16; ++kc) {
#pragma unroll
          for (int x = 0; x < 4; ++x)
            da[kc][x] = pack2<T>(dp[8 * kc + 2 * x], dp[8 * kc + 2 * x + 1]);
        }
        // dQ += dS K: 16 keys a step, 16 rows = 2048 bytes of every K chunk
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < KN / 16; ++kc)
          wgmma_rs<T, D>(acc, da[kc], sw128_desc(k_s + kc * 2048, KN * 128), 1);
        wg_commit();
        wg_wait_all();
        fence_regs(acc);
      }
      mbar_arrive(bar_empty<STAGES>(bars, s));  // K and V of the slot are read
    }

    // dQ of rows < sq: [b, hq, sq, D], or packed [total_q, hq, D]
    const size_t stride = PACKED ? (size_t)a.hq * D : (size_t)D;
    T* dq_head = dq + (PACKED ? (size_t)q_row0 * a.hq + h : (size_t)(b * a.hq + h) * a.sq) * D;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = r0 + 8 * x;
      if (r < a.sq) {
        T* row = dq_head + (size_t)r * stride + 2 * t4;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(row + 8 * j) =
              pack2<T>(acc[4 * j + 2 * x], acc[4 * j + 2 * x + 1]);
      }
    }
  }
}

// Kernel 13 (dense, sq > 0) or kernel 14's dQ launch (PACKED: a.cu_q,
// a.cu_k, a.total_q set; max_sq bounds every sequence's q length, total_k
// is the keys' rows; both unused dense). Returns a cudaError_t code,
// MFA_TMA_ENCODE, or 0.
template <typename T, int D, bool PACKED>
int launch_dq(const void* q, const void* k, const void* v, const void* dO, const float* lse,
              const float* delta, void* dq, int batch, int total_k, int max_sq, const Args& a,
              cudaStream_t stream) {
  using P = DqPlan<D>;
  constexpr bool BF = kIsBf16<T>;
  CUtensorMap tq, tk, tv, tdo;
  if constexpr (PACKED) {
    if (int err = packed_maps<T, D>(&tq, &tdo, &tk, &tv, q, dO, k, v, total_k, DQ_BM, P::BN, a))
      return err;
  } else {
    // sk == 0: no key tile is ever loaded; the maps only need a valid base
    const bool kv = a.sk > 0;
    if (int err = mfa_tensor_map_3d(&tq, q, BF, D, a.sq, batch * a.hq, DQ_BM)) return err;
    if (int err = mfa_tensor_map_3d(&tdo, dO, BF, D, a.sq, batch * a.hq, DQ_BM)) return err;
    if (int err = mfa_tensor_map_3d(&tk, kv ? k : q, BF, D, kv ? a.sk : a.sq,
                                    batch * (kv ? a.hkv : a.hq), P::BN))
      return err;
    if (int err = mfa_tensor_map_3d(&tv, kv ? v : dO, BF, D, kv ? a.sk : a.sq,
                                    batch * (kv ? a.hkv : a.hq), P::BN))
      return err;
  }
  auto kern = dq_kernel<T, D, PACKED>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  const dim3 grid(a.hq, batch, ((PACKED ? max_sq : a.sq) + DQ_BM - 1) / DQ_BM);
  kern<<<grid, THREADS, P::bytes, stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), a);
  return (int)cudaGetLastError();
}

}  // namespace fb90
