// The flash-attention backward for Hopper (sm_90a) on wgmma and TMA, in two
// instantiations of one kernel:
//  - DQ = true: dQ, dK and dV in one pass (kernel 11, mfa_bwd_fused in
//    backward.cu), replacing mfa_tpu/kernels/backward.py:_fused_bwd_kernel.
//  - DQ = false: dK and dV alone (kernel 12, mfa_bwd_dkv), replacing
//    _dkv_kernel / _dkv_tri_kernel (_dkv_body): the first launch of the
//    deterministic split. No dQ step: no dS^T buffers, no consumer barrier,
//    no dQ product, tile or reduction; the shared memory this frees holds
//    a third ring slot. A block owns its keys and sums dK and dV over the
//    group's q heads and the band's q tiles in registers in a fixed order
//    and stores them once, so its results are the same bits run to run.
// Both compute the function of kernels/backward.py:_bwd_plain:
//
//   P  = exp2(S * c - LSE * log2e),  S = Q K^T (softcap: cap * tanh(S * scale / cap))
//   dV = P^T dO     dS = P * (dO V^T - delta) * scale (* (1 - tanh^2))
//   dK = dS^T Q     dQ = dS K
//
// with delta = rowsum(dO * O) from the caller in fp32, P = 0 on rows whose
// LSE is -inf, and dK, dV summed over the GQA group. Layout: q, dO [b, hq,
// sq, D], k, v, dK, dV [b, hkv, sk, D], LSE and delta [b, hq, sq] fp32; dQ
// is added into a zeroed fp32 workspace [b, hq, sq, D].
//
// Bound: tensor-core operations, 5 products of 2 D flops per visible (row,
// key) pair and q head. The design follows FlashAttention-3's Hopper
// backward (arXiv 2407.08608):
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
//    as zeros (the tensor map's bound) with LSE +inf, so they add nothing.
#pragma once

#include "wgmma.cuh"

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

// Grid (hkv, batch, ceil(sk / BN)): the key tile is the slowest axis, so
// the causal blocks with the most q tiles (the first keys) launch first.
template <typename T, int D, bool DQ>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
               const Args a) {
  using P = Plan<D, DQ>;
  constexpr int STAGES = P::STAGES;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int kv0 = blockIdx.z * BN;
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
      const int bh_kv = b * a.hkv + hk;
      mbar_expect_tx(bar_kv(bars), 2 * P::KV_BYTES);
#pragma unroll
      for (int ch = 0; ch < D / 64; ++ch) {
        tma_load_3d(base + P::k_off + ch * (BN * 128), &tk, bar_kv(bars), ch * 64, kv0, bh_kv);
        tma_load_3d(base + P::v_off + ch * (BN * 128), &tv, bar_kv(bars), ch * 64, kv0, bh_kv);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, hi = i / per_head, q0 = (q_first + i % per_head) * BM;
        const int bh_q = b * a.hq + h0 + hi;
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
        const size_t row0 = (size_t)(b * a.hq + h0 + hi) * a.sq;
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
        const size_t o = ((size_t)(b * a.hkv + hk) * a.sk + key) * D + 2 * t4;
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

}  // namespace fb90
