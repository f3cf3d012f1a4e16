// int8-weight matmul for Hopper (sm_90a): out[m, N] = (x[m, K] @ qw[K, N]) *
// scale[N], x bf16, fp16 or fp32, qw int8 (per-output-channel symmetric
// weights, mfa_tpu_torch/models/wquant.py), scale fp32, fp32 accumulation,
// the scale applied to the accumulator and the result rounded once
// (mfa_tpu/kernels/wmatmul.py:49; fp32 x: out fp32, as mfa_tpu's kernel
// casts W to x's dtype and contracts in it).
//
// Replaces mfa_tpu/kernels/wmatmul.py:_kernel (int8_matmul). In JAX that
// kernel is a baseline beside XLA's fused convert; eager PyTorch fuses
// nothing, so on the card this kernel is the int8 weight path of every
// projection and the lm_head.
//
// Bound: at decode (m = 16) the weight stream, K * N bytes of int8 against
// 2 m K N operations, far below the card's ~295 operations a byte; at a
// prefill wave (m in the thousands) tensor-core operations. Design (the
// warp-specialised shape of csrc/flash_fwd_sm90.cuh):
//  - The product runs transposed, out^T[N, m] = W^T[N, K] x^T[K, m], so the
//    weight's N is wgmma's 64-row side and m its n side (16 to 256): a
//    decode batch of 16 wastes no rows. A block owns 128 weight columns
//    (64 per consumer warpgroup) and BMX rows of x.
//  - One producer thread TMA-loads, per 64-deep K step, the x tile [BMX][64]
//    (K-major, 128-byte swizzle: wgmma's B operand as stored) and the int8
//    W tile [64 k][128 n] (N contiguous, 128-byte swizzle) into a ring of
//    STAGES slots with full/empty mbarriers. The maps clip the m, K and N
//    tails with zeros.
//  - wgmma cannot mix int8 and 16-bit operands, so W^T is the register
//    operand A: each consumer warp reads its 16 columns of the int8 tile
//    with ldmatrix.trans of 16-bit pairs (a register then holds two k
//    rows of two adjacent columns: fragment rows g and g + 8 are columns 2g
//    and 2g + 1, a permutation the epilogue undoes) and converts them
//    exactly in registers (byte permutes and one packed subtraction per two
//    values). Nothing is written back to shared memory, so no proxy fence
//    or barrier joins the warps a step; the A registers of step i stay
//    untouched until step i + 1's wait retires its product, so the
//    conversion of one step overlaps the product of the previous one.
//  - The per-column scale is a per-row multiply of the transposed
//    accumulator, applied in the epilogue, which stages the fp32 tile in
//    shared memory (the ring, now idle) and writes out[m, N] rows with
//    coalesced vector stores.
//  - Decode-sized m gives N / 128 output tiles, fewer than the card's 132
//    SMs: K is split over gridDim.z, and the splits of a tile form one
//    thread-block cluster. Each split stages its fp32 partial in its own
//    shared memory; after a cluster barrier split r reduces output rows r,
//    r + splits, ... over the splits' tiles in rank order (distributed
//    shared memory), applies the scale and rounds. One launch, no fp32
//    workspace, the same bits for every run.
//  - BMX 16 and 32 (decode) run two blocks an SM with a ~100 KB ring
//    each; BMX 64 to 256 one block with a ~200 KB ring. At BMX 128 and 256
//    (prefill waves) setmaxnreg moves registers from the producer to the
//    consumers.
//
// Any m; K and N multiples of 16 (the wrapper checks: the maps' row strides
// are multiples of 16 bytes, and a 4-column vector of the output lies
// wholly inside or outside the matrix).
//
// fp32 x (NX = 3): every int8 weight is exact in bf16, and an fp32 x splits
// exactly into three bf16 parts, x = hi + mid + lo (hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid), each difference exact in fp32:
// 8 + 8 + 8 bits cover fp32's 24 for normal values; a part that falls
// below bf16's subnormals loses bits, which only |x| < ~2^-110 reach). A
// pre-pass kernel (split3_kernel) writes the parts to a bf16 scratch [3,
// rows, K]; the matmul loads the three x tiles of a K step beside the one
// W tile and runs the three products against the same converted W^T
// registers, so W's bytes and conversion are paid once. The three
// products of a K step go into a fresh fp32 accumulator (lo first, with
// scale-d 0, then mid, then hi) that is added to the block's sum by FADD:
// the tensor core truncates its internal sums, and a K step's partial is
// ~sqrt(K / 64) times smaller than the whole, so the truncation stays
// near fp32's own rounding of the sum. The step's conversion of the next W tile overlaps
// its products; its wait retires them before the add. Rows a block <= 128
// (the step accumulator doubles the registers), one block an SM.
//
// The expert-bank launch (mfa_int8_bank_matmul: the int8 MoE banks of
// mfa_tpu/models/llama.py:_moe_dense_int8 and ragged_qmm, which are XLA
// einsums and lax.ragged_dot there, no Pallas kernel) is the same body with
// the expert on gridDim.z beside the K splits. W is a 3-D map (N, K, E), so
// TMA clips the K and N tails of every expert's matrix. Dense form: out[e] =
// x_e @ W_e for every e, x one [M, K] for all experts (gate, up) or one an
// expert, [E, M, K] (down), out [E, M, N]. Grouped form: expert e owns the
// rows offs[e]:offs[e + 1] of expert-sorted x [R, K] (offs on the device);
// its row tiles start at offs[e] in the 2-D x map, which clips only at R, so
// a tile may read the next expert's rows: the store skips rows past the
// group, and a block whose first row is past it leaves at once. The grid
// holds the most row tiles one expert can need (a token picks an expert at
// most once), so the launch reads nothing on the host and can be captured.
#include "wgmma.cuh"

namespace wm90 {

constexpr int BN = 128;        // weight columns a block: 64 per consumer warpgroup
constexpr int BK = 64;         // K a step
constexpr int THREADS = 384;   // producer warpgroup + two consumers
constexpr uint32_t W_BYTES = BK * BN;      // one int8 W tile
constexpr int ST_STRIDE = BN * 4 + 16;     // bytes a row of the fp32 output staging tile
constexpr int MAX_SPLITS = 8;              // portable cluster size
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Shared memory: STAGES slots of [x tile | int8 W tile] (every tile
// 1024-byte aligned), then the barriers (full[STAGES], empty[STAGES]). The
// epilogue's staging tile [BMX][BN] fp32 (rows ST_STRIDE bytes apart) reuses
// the ring.
// NX: x tiles a K step (3: the bf16 parts of fp32 x).
template <int BMX, int NX = 1>
struct Plan {
  static_assert(NX == 1 || (NX == 3 && BMX <= 128), "fp32 x: at most 128 rows a block");
  static constexpr int MIN_BLOCKS = NX == 1 && BMX <= 32 ? 2 : 1;
  static constexpr int STAGES =
      NX == 3 ? (BMX == 128 ? 4 : BMX == 64 ? 6 : BMX == 32 ? 10 : 12)
              : (BMX == 256 ? 5 : BMX == 128 ? 8 : BMX == 64 ? 12 : BMX == 32 ? 8 : 10);
  static constexpr uint32_t X_BYTES = NX * BMX * 128;  // NX x [BMX rows][64 k] 16-bit
  static constexpr uint32_t STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr uint32_t bar_off = STAGES * STAGE_BYTES;
  static constexpr size_t bytes = bar_off + 16 * STAGES + 1024;  // + 1 KB to align the base
  static_assert(BMX * ST_STRIDE <= bar_off, "the staging tile must fit in the ring");
  static_assert(bytes <= 232448, "a block's shared memory");
};

__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) { return bars + 8 * s; }
template <int STAGES>
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (STAGES + s);
}

// Four signed bytes (k, n), (k, n + 1), (k + 1, n), (k + 1, n + 1) -> the
// pair of column n (bytes 0 and 2) and of column n + 1 (bytes 1 and 3) as
// two 16-bit values each, exactly. bf16: the low 7 bits under exponent 2^7
// give 128 + low, the sign bit there 128 or 256, and their difference is
// the byte. fp16: the byte, offset by 128, is the low mantissa of 1024.
template <typename T>
__device__ __forceinline__ void cvt_pairs(uint32_t w, uint32_t& even, uint32_t& odd);
template <>
__device__ __forceinline__ void cvt_pairs<__nv_bfloat16>(uint32_t w, uint32_t& even,
                                                        uint32_t& odd) {
  const uint32_t low = w & 0x7F7F7F7Fu, sign = w & 0x80808080u;
  const uint32_t a0 = __byte_perm(low, 0x43434343u, 0x6240), b0 = __byte_perm(sign, 0x43434343u, 0x6240);
  const uint32_t a1 = __byte_perm(low, 0x43434343u, 0x7351), b1 = __byte_perm(sign, 0x43434343u, 0x7351);
  const __nv_bfloat162 r0 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a0),
                                    *reinterpret_cast<const __nv_bfloat162*>(&b0));
  const __nv_bfloat162 r1 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a1),
                                    *reinterpret_cast<const __nv_bfloat162*>(&b1));
  even = *reinterpret_cast<const uint32_t*>(&r0);
  odd = *reinterpret_cast<const uint32_t*>(&r1);
}
template <>
__device__ __forceinline__ void cvt_pairs<__half>(uint32_t w, uint32_t& even, uint32_t& odd) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t a = __byte_perm(u, 0x64646464u, 0x6240), b = __byte_perm(u, 0x64646464u, 0x7351);
  const __half2 bias = __floats2half2_rn(1152.f, 1152.f);
  const __half2 ra = __hsub2(*reinterpret_cast<const __half2*>(&a), bias);
  const __half2 rb = __hsub2(*reinterpret_cast<const __half2*>(&b), bias);
  even = *reinterpret_cast<const uint32_t*>(&ra);
  odd = *reinterpret_cast<const uint32_t*>(&rb);
}

// A fragments of one K step for a warp's 16 columns of the int8 tile at
// `raw` ([64 k][128 n], 16-byte unit u of row k stored at u ^ (k & 7));
// `unit` is the warp's 16-byte unit. Matrix j of an ldmatrix.x4.trans is k
// rows 8 j..8 j + 7 of 32, each 16-bit column a pair of adjacent columns:
// lane (g, t4) gets k 2 t4 and 2 t4 + 1 of columns 2g and 2g + 1, i.e. rows
// g (column 2g) and g + 8 (column 2g + 1) of the A fragment.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&af)[BK / 16][4], uint32_t raw, int unit,
                                       int lane) {
  const int lr = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int h = 0; h < BK / 32; ++h) {
    const int k = 32 * h + 8 * mi + lr;
    uint32_t r[4];
    ldsm_x4_t(r, raw + k * 128 + ((unit ^ (k & 7)) << 4));
#pragma unroll
    for (int x = 0; x < 4; ++x)
      cvt_pairs<T>(r[x], af[2 * h + (x >> 1)][2 * (x & 1)], af[2 * h + (x >> 1)][2 * (x & 1) + 1]);
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack2<__nv_bfloat16>(v.x, v.y), pack2<__nv_bfloat16>(v.z, v.w));
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2<__half>(v.x, v.y), pack2<__half>(v.z, v.w));
}

// An expert-bank launch: `experts` matrices of W, gridDim.z = experts x
// splits. offs: the grouped form's group bounds [experts + 1], or nullptr
// for the dense form, where x_per_expert says whether x holds one matrix an
// expert (its map's third coordinate) or one for all.
struct Bank {
  const int* offs;
  int experts;
  int x_per_expert;
};

// Grid (row tiles, ceil(N / BN), experts x splits), the splits of a tile
// one cluster; split z covers K steps [z * steps_per_split, (z + 1) *
// steps_per_split). Without BANK: one expert, x rows [0, M). NX = 3: tx
// maps the bf16 parts of fp32 x, (K, rows, part), the dense bank's
// matrices an expert as rows ex M + m (T is then bf16).
template <typename T, typename OutT, int BMX, bool BANK, int NX>
__global__ void __launch_bounds__(THREADS, (Plan<BMX, NX>::MIN_BLOCKS))
    wmatmul_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const float* __restrict__ scale, OutT* __restrict__ out, int M, int N, int K,
                   int steps_per_split, Bank bank) {
  using P = Plan<BMX, NX>;
  constexpr int STAGES = P::STAGES;
  constexpr bool SETREG = BMX >= 128;  // the accumulator needs the registers
  const int m0 = blockIdx.x * BMX, n0 = blockIdx.y * BN;
  const int splits = BANK ? gridDim.z / bank.experts : gridDim.z;
  const int split = splits > 1 ? (int)cluster_rank() : 0;
  const int ex = BANK ? blockIdx.z / splits : 0;  // the expert
  // rows of this block's matrix or group; its first row in the x map
  // (x_row0, plane x_plane) and in out viewed as [*, N] (out_row0)
  int rows_m = M, x_row0 = m0, x_plane = 0;
  size_t out_row0 = m0;
  if constexpr (BANK) {
    if (bank.offs != nullptr) {
      const int g0 = __ldg(bank.offs + ex);
      rows_m = __ldg(bank.offs + ex + 1) - g0;
      if (m0 >= rows_m) return;  // the whole block (and cluster), before any barrier
      x_row0 = g0 + m0;
      out_row0 = (size_t)g0 + m0;
    } else {
      x_plane = bank.x_per_expert ? ex : 0;
      out_row0 = (size_t)ex * M + m0;
    }
  }
  const int k_steps = (K + BK - 1) / BK;
  const int kt0 = split * steps_per_split;
  const int n_steps = max(0, min(k_steps, kt0 + steps_per_split) - kt0);

  extern __shared__ __align__(16) unsigned char wm_smem[];
  unsigned char* smem = wm_smem + ((1024u - (smem_u32(wm_smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + P::bar_off;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(bars, s), 1);
      mbar_init(bar_empty<STAGES>(bars, s), 2 * 128);  // every consumer thread releases
    }
    mbar_fence_init();
  }
  __syncthreads();

  // warp-uniform by construction, as setmaxnreg's .sync.aligned form needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  if (wg == 0) {
    if constexpr (SETREG) regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&tx);
      prefetch_tensormap(&tw);
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % STAGES, k0 = (kt0 + i) * BK;
        mbar_wait(bar_empty<STAGES>(bars, s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full(bars, s), P::STAGE_BYTES);
        const uint32_t xs = base + s * P::STAGE_BYTES;
        if constexpr (NX == 1) {
          tma_load_3d(xs, &tx, bar_full(bars, s), k0, x_row0, x_plane);
        } else {
#pragma unroll
          for (int part = 0; part < NX; ++part)
            tma_load_3d(xs + part * BMX * 128, &tx, bar_full(bars, s), k0, x_plane * M + x_row0,
                        part);
        }
        tma_load_3d(xs + P::X_BYTES, &tw, bar_full(bars, s), n0, k0, ex);
      }
    }
  } else {
    if constexpr (SETREG) regs_inc<CONSUMER_REGS>();
    const int w = wg - 1, wt = threadIdx.x & 127, lane = wt & 31, wi = wt >> 5;
    const int unit = 4 * w + wi;  // this warp's 16 columns of the W tile
    float acc[BMX / 2];
#pragma unroll
    for (int x = 0; x < BMX / 2; ++x) acc[x] = 0.f;
    uint32_t fa[BK / 16][4], fb[BK / 16][4];
    if constexpr (NX == 1) {
      // step i converts into `af` while step i - 1's product (reading `prev`)
      // may still run; its wait then retires step i - 1 and frees its slot
      auto step = [&](int i, uint32_t (&af)[BK / 16][4], uint32_t (&prev)[BK / 16][4]) {
        const int s = i % STAGES;
        const uint32_t xs = base + s * P::STAGE_BYTES;
        mbar_wait(bar_full(bars, s), (i / STAGES) & 1);
        load_a<T>(af, xs + P::X_BYTES, unit, lane);
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_t<T, BMX, 0>(acc, af[kk], sw128_desc(xs + kk * 32, 0), 1);
        wg_commit();
        wg_wait<1>();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(prev[kk]);
        if (i > 0) mbar_arrive(bar_empty<STAGES>(bars, (i - 1) % STAGES));
      };
      for (int i = 0; i < n_steps; i += 2) {
        step(i, fa, fb);
        if (i + 1 < n_steps) step(i + 1, fb, fa);
      }
      wg_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        fence_regs(fa[kk]);
        fence_regs(fb[kk]);
      }
    } else {
      float tmp[BMX / 2];
#pragma unroll
      for (int x = 0; x < BMX / 2; ++x) tmp[x] = 0.f;
      // wait for step i's tiles and convert its W^T into af
      auto convert = [&](int i, uint32_t (&af)[BK / 16][4]) {
        const int s = i % STAGES;
        mbar_wait(bar_full(bars, s), (i / STAGES) & 1);
        load_a<T>(af, base + s * P::STAGE_BYTES + P::X_BYTES, unit, lane);
      };
      // step i's three products into a fresh tmp (scale-d 0 first), the
      // smallest part first, so that the truncated sums of lo and mid are
      // taken while tmp is small; step i + 1's W^T converts into `next`
      // meanwhile; the wait retires them, tmp joins acc by FADD and the
      // slot is released
      auto step = [&](int i, uint32_t (&af)[BK / 16][4], uint32_t (&next)[BK / 16][4]) {
        const uint32_t xs = base + (i % STAGES) * P::STAGE_BYTES;
        fence_regs(tmp);
        wg_fence();
#pragma unroll
        for (int pi = 0; pi < NX; ++pi)
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_rs_t<T, BMX, 0>(tmp, af[kk],
                                  sw128_desc(xs + (NX - 1 - pi) * BMX * 128 + kk * 32, 0),
                                  pi + kk > 0);
        wg_commit();
        if (i + 1 < n_steps) convert(i + 1, next);
        wg_wait<0>();
        fence_regs(tmp);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(af[kk]);
#pragma unroll
        for (int x = 0; x < BMX / 2; ++x) acc[x] += tmp[x];
        mbar_arrive(bar_empty<STAGES>(bars, i % STAGES));
      };
      if (n_steps > 0) convert(0, fa);
      for (int i = 0; i < n_steps; i += 2) {
        step(i, fa, fb);
        if (i + 1 < n_steps) step(i + 1, fb, fa);
      }
    }
    named_sync(1, 2 * 128);  // no product reads the ring any more

    // Stage the fp32 tile: accumulator element 4j + 2h + e is x row 8 j +
    // 2 t4 + e of weight column 64 w + 16 wi + 2g + h.
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t col = (64 * w + 16 * wi + 2 * g) * 4;
#pragma unroll
    for (int j = 0; j < BMX / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(
                         base + (8 * j + 2 * t4 + e) * ST_STRIDE + col),
                     "f"(acc[4 * j + e]), "f"(acc[4 * j + 2 + e])
                     : "memory");
    }
  }

  // Every split's tile is staged; split r then writes rows r, r + splits,
  // ... of the output tile: the sum over the splits in rank order, times
  // the scale, rounded once.
  if (splits > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
  if (wg != 0) {
    const int ct = threadIdx.x - 128;
    const int rows = (min(BMX, rows_m - m0) - split + splits - 1) / splits;
    for (int it = ct; it < rows * (BN / 4); it += 2 * 128) {
      const int r = split + (it / (BN / 4)) * splits, v = it % (BN / 4);
      const int n = n0 + 4 * v;
      if (n >= N) continue;
      const uint32_t a = base + r * ST_STRIDE + v * 16;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int rk = 0; rk < splits; ++rk) {  // in rank order
        float4 p;
        if (splits > 1) {
          p = ld_cluster_f4(a, rk);
        } else {
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(p.x), "=f"(p.y), "=f"(p.z), "=f"(p.w)
                       : "r"(a));
        }
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
      const float4 sc = *reinterpret_cast<const float4*>(scale + (size_t)ex * N + n);
      store4(out + (out_row0 + r) * N + n,
             make_float4(sum.x * sc.x, sum.y * sc.y, sum.z * sc.z, sum.w * sc.w));
    }
  }
  if (splits > 1) cluster_sync();  // no block leaves while another reads its tile
}

// tx: the x tensor map; the grid is (m_tiles, ceil(N / BN), experts x
// splits).
template <typename T, typename OutT, int BMX, bool BANK, int NX>
int launch(const CUtensorMap& tx, const int8_t* qw, const float* scale, void* out, int M, int K,
           int N, int splits, int steps_per_split, Bank bank, int m_tiles, cudaStream_t stream) {
  using P = Plan<BMX, NX>;
  CUtensorMap tw;
  if (int err = mfa_encode_3d(&tw, qw, CU_TENSOR_MAP_DATA_TYPE_UINT8, N, K, bank.experts,
                              (size_t)N, (size_t)K * N, BN, BK))
    return err;
  auto kern = wmatmul_kernel<T, OutT, BMX, BANK, NX>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m_tiles, (N + BN - 1) / BN, bank.experts * splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = P::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  if (int err = (int)cudaLaunchKernelEx(&cfg, kern, tx, tw, scale, static_cast<OutT*>(out), M,
                                        N, K, steps_per_split, bank))
    return err;
  return (int)cudaGetLastError();
}

// The 2-D launch: one x [M, K] (NX = 3: its bf16 parts [3, M, K]), one W.
template <typename T, typename OutT, int BMX, int NX>
int launch_2d(const void* x, const int8_t* qw, const float* scale, void* out, int M, int K, int N,
              int splits, int steps_per_split, cudaStream_t stream) {
  CUtensorMap tx;
  if (int err = mfa_tensor_map_3d(&tx, x, kIsBf16<T>, K, M, NX, BMX)) return err;
  return launch<T, OutT, BMX, false, NX>(tx, qw, scale, out, M, K, N, splits, steps_per_split,
                                         Bank{nullptr, 1, 0}, (M + BMX - 1) / BMX, stream);
}

// x rows a block: kernels/wmatmul.py:block_m (fp32 x: at most 128).
template <typename T, typename OutT, int NX = 1>
int launch_m(const void* x, const int8_t* qw, const float* scale, void* out, int M, int K, int N,
             int splits, int steps_per_split, cudaStream_t s) {
#define MFA_WMM_BM(B) \
  return launch_2d<T, OutT, B, NX>(x, qw, scale, out, M, K, N, splits, steps_per_split, s)
  if (M <= 16) MFA_WMM_BM(16);
  if (M <= 32) MFA_WMM_BM(32);
  if (M <= 64) MFA_WMM_BM(64);
  if constexpr (NX == 3) {
    MFA_WMM_BM(128);
  } else {
    if (M < 256) MFA_WMM_BM(128);
    MFA_WMM_BM(256);
  }
#undef MFA_WMM_BM
}

// fp32 x [n] (n a multiple of 4) -> its three bf16 parts parts[p][n], x =
// hi + mid + lo exactly for normal values (the header's split).
__global__ void split3_kernel(const float4* __restrict__ x, uint2* __restrict__ parts, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    const float f[4] = {v.x, v.y, v.z, v.w};
    float h[4], m[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = __bfloat162float(__float2bfloat16_rn(f[e]));
      const float r = f[e] - h[e];  // exact
      m[e] = __bfloat162float(__float2bfloat16_rn(r));
      l[e] = r - m[e];  // exact, and exact in bf16
    }
    parts[i] = make_uint2(pack2<__nv_bfloat16>(h[0], h[1]), pack2<__nv_bfloat16>(h[2], h[3]));
    parts[n4 + i] = make_uint2(pack2<__nv_bfloat16>(m[0], m[1]), pack2<__nv_bfloat16>(m[2], m[3]));
    parts[2 * n4 + i] =
        make_uint2(pack2<__nv_bfloat16>(l[0], l[1]), pack2<__nv_bfloat16>(l[2], l[3]));
  }
}

int split3(const void* x, void* parts, size_t n, cudaStream_t s) {
  const size_t n4 = n / 4;
  if (n4 == 0) return 0;
  const int blocks = (int)((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  split3_kernel<<<blocks, 256, 0, s>>>(static_cast<const float4*>(x), static_cast<uint2*>(parts),
                                       n4);
  return (int)cudaGetLastError();
}

// The bank launch at BMX rows a block. Dense: x [M, K] (x_per_expert 0) or
// [experts, M, K]; grouped: x [M, K] with M the rows of every group. NX =
// 3: x is the parts [3, planes M, K] of the same rows.
template <typename T, typename OutT, int BMX, int NX>
int launch_bank(const void* x, const int8_t* qw, const float* scale, void* out, int M, int K,
                int N, Bank bank, int m_tiles, int splits, int steps_per_split,
                cudaStream_t stream) {
  CUtensorMap tx;
  const int planes = bank.offs == nullptr && bank.x_per_expert ? bank.experts : 1;
  if (int err = NX == 1 ? mfa_tensor_map_3d(&tx, x, kIsBf16<T>, K, M, planes, BMX)
                        : mfa_tensor_map_3d(&tx, x, kIsBf16<T>, K, planes * M, NX, BMX))
    return err;
  return launch<T, OutT, BMX, true, NX>(tx, qw, scale, out, M, K, N, splits, steps_per_split,
                                        bank, m_tiles, stream);
}

template <typename T, typename OutT, int NX = 1>
int launch_bank_m(const void* x, const int8_t* qw, const float* scale, void* out, int M, int K,
                  int N, Bank bank, int bm, int m_tiles, int splits, int steps_per_split,
                  cudaStream_t s) {
#define MFA_WMB_BM(B)                                                                    \
  if (bm == B)                                                                           \
    return launch_bank<T, OutT, B, NX>(x, qw, scale, out, M, K, N, bank, m_tiles, splits, \
                                       steps_per_split, s);
  MFA_WMB_BM(16)
  MFA_WMB_BM(32)
  MFA_WMB_BM(64)
  MFA_WMB_BM(128)
  if constexpr (NX == 1) {
    MFA_WMB_BM(256)
  }
#undef MFA_WMB_BM
  return MFA_BAD_CONFIG;
}

}  // namespace wm90

// x [M, K] (dtype: MFA_BF16, MFA_F16 or MFA_F32), qw [K, N] int8, scale [N]
// fp32, out [M, N] in x's dtype (out_f32 = 0) or fp32 (out_f32 = 1; fp32 x
// takes only that); x3: fp32 x's scratch, bf16 [3, M, K] (null otherwise);
// every pointer 16-byte aligned. Split s of `splits` (at most 8, one
// cluster) covers K steps of 64 [s * k_steps_per_split, (s + 1) *
// k_steps_per_split). Returns a cudaError_t code, MFA_TMA_ENCODE or
// MFA_BAD_CONFIG (0 = launched).
extern "C" int mfa_int8_matmul(const void* x, const int8_t* qw, const float* scale, void* out,
                               void* x3, int dtype, int out_f32, int M, int K, int N, int splits,
                               int k_steps_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (K % 16 || N % 16 || splits < 1 || splits > wm90::MAX_SPLITS) return MFA_BAD_CONFIG;
  if (K == 0)  // an empty contraction: zeros
    return (int)cudaMemsetAsync(out, 0, (size_t)M * N * (out_f32 ? 4 : 2), s);
#define MFA_WMM(T, OutT) \
  return wm90::launch_m<T, OutT>(x, qw, scale, out, M, K, N, splits, k_steps_per_split, s)
  if (dtype == MFA_BF16 && !out_f32) MFA_WMM(__nv_bfloat16, __nv_bfloat16);
  if (dtype == MFA_BF16 && out_f32) MFA_WMM(__nv_bfloat16, float);
  if (dtype == MFA_F16 && !out_f32) MFA_WMM(__half, __half);
  if (dtype == MFA_F16 && out_f32) MFA_WMM(__half, float);
#undef MFA_WMM
  if (dtype == MFA_F32) {
    if (x3 == nullptr || !out_f32) return MFA_BAD_CONFIG;
    if (int err = wm90::split3(x, x3, (size_t)M * K, s)) return err;
    return wm90::launch_m<__nv_bfloat16, float, 3>(x3, qw, scale, out, M, K, N, splits,
                                                   k_steps_per_split, s);
  }
  return MFA_BAD_CONFIG;
}

// The expert-bank launch. qw [experts, K, N] int8, scale [experts, N] fp32,
// x and out in `dtype` (MFA_BF16, MFA_F16 or MFA_F32; fp32 x: x3 its bf16
// scratch [3, rows of x, K], bm at most 128), every pointer 16-byte aligned.
// offs == nullptr (dense): x [M, K] (x_per_expert 0) or [experts, M, K],
// out [experts, M, N]. Else (grouped): offs [experts + 1] int32 on the
// device, nondecreasing from 0 to M, expert e owning rows offs[e]:offs[e +
// 1] of x [M, K] and out [M, N], no group above m_tiles * bm rows. bm: x rows
// a block (16, 32, 64, 128 or 256); m_tiles: row tiles an expert (dense:
// ceil(M / bm)). Splits as mfa_int8_matmul. Returns a cudaError_t code,
// MFA_TMA_ENCODE or MFA_BAD_CONFIG (0 = launched).
extern "C" int mfa_int8_bank_matmul(const void* x, const int8_t* qw, const float* scale,
                                    void* out, const int* offs, void* x3, int dtype, int M, int K,
                                    int N, int experts, int x_per_expert, int bm, int m_tiles,
                                    int splits, int k_steps_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0 || experts == 0 || m_tiles == 0) return 0;
  if (K % 16 || N % 16 || splits < 1 || splits > wm90::MAX_SPLITS || K == 0)
    return MFA_BAD_CONFIG;
  const wm90::Bank bank{offs, experts, x_per_expert};
  if (dtype == MFA_BF16)
    return wm90::launch_bank_m<__nv_bfloat16, __nv_bfloat16>(
        x, qw, scale, out, M, K, N, bank, bm, m_tiles, splits, k_steps_per_split, s);
  if (dtype == MFA_F16)
    return wm90::launch_bank_m<__half, __half>(x, qw, scale, out, M, K, N, bank, bm, m_tiles,
                                               splits, k_steps_per_split, s);
  if (dtype == MFA_F32) {
    if (x3 == nullptr) return MFA_BAD_CONFIG;
    const size_t rows = (size_t)(offs == nullptr && x_per_expert ? experts : 1) * M;
    if (int err = wm90::split3(x, x3, rows * K, s)) return err;
    return wm90::launch_bank_m<__nv_bfloat16, float, 3>(x3, qw, scale, out, M, K, N, bank, bm,
                                                        m_tiles, splits, k_steps_per_split, s);
  }
  return MFA_BAD_CONFIG;
}
