// Split-KV decode over a contiguous cache for Hopper (sm_90a): launch 1 of
// kernel 5 (decode.cu), the per-split partials.
//
// Replaces mfa_tpu/kernels/decode.py:_decode_kernel. One block owns one
// (batch, kv head, split): the group's <= 8 q rows against cache rows
// [lo, hi) of a [b, hkv, S, D] cache, and writes the split's normalized
// fp32 O and natural-log LSE for the combine (launch 2).
//
// Bound: device-memory bytes, K and V read once (a decode row does 4 D
// operations per 4 D cache bytes, far below the ~295 operations a byte
// where the tensor cores would be the limit). The design keeps the memory
// busy and takes the arithmetic off the CUDA cores:
//  - One producer thread TMA-loads 64-token K and V tiles through 3-D maps
//    over (D, S, b * hkv) into a ring of STAGES slots (192 KB: 6 slots at D
//    128) with full/empty mbarriers; the maps clip at S with zeros, rows in
//    [len, S) are masked. The box coordinates come from one function
//    (tile_row), so a paged source needs only one box per page through the
//    block table there.
//  - Eight consumer warps in two teams (one team at D 256): team t takes
//    tiles t, t + 2, ..., and warp w of a team the tile's tokens [16 w,
//    16 w + 16). Each warp is
//    its own split of the split: its online softmax (m, l) and O live in
//    registers, no barrier joins the warps while the ring runs, and one
//    shared-memory merge ends the block.
//  - S = Q K^T and O += P V run on mma.sync m16n8k16 (the group's rows
//    padded to 16): K's B fragments by ldmatrix and V's by ldmatrix.trans
//    straight from the TMA's 128-byte swizzle; P stays in registers as the
//    A fragment of P V.
//  - Only a warp's 16 tokens that cross lo or hi are masked: their scores
//    become MASK, their p exactly 0, and their V fragments zero (a row past
//    the length may hold anything, and 0 * NaN would survive).
//
// Semantics of decode_common.cuh, kept exactly: scores scaled into the log2
// domain before the max (softcap first), probabilities rounded to V's dtype
// before P V while l sums them unrounded, a row with no visible column
// stores O = 0 and LSE = -inf, and split ranges are whole 64-token tiles.
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
};

// Shared memory: STAGES slots of [K tile | V tile], each [D / 64 chunks][64
// tokens][64] 16-bit with the 128-byte swizzle, then the barriers
// (full[STAGES], empty[STAGES]). The final merge reuses the ring:
// per consumer warp m[8], l[8] and O[8][D] fp32. At D 256 one team of four
// consumer warps: a thread's O alone takes 128 registers, and nine warps
// could hold no more than 168 a thread (three warps share a quarter of the
// register file).
template <int D>
struct Plan {
  static constexpr int TEAMS = D > 128 ? 1 : 2;  // tiles the consumer warps work on at once
  static constexpr int CWARPS = 4 * TEAMS;       // consumer warps, 16 tokens of a tile each
  static constexpr int THREADS = 32 * (1 + CWARPS);
  static constexpr int STAGES = D == 64 ? 12 : D == 128 ? 6 : 3;
  static constexpr uint32_t KV_BYTES = TILE * D * 2;  // one K or V tile
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;
  static constexpr uint32_t bar_off = STAGES * STAGE_BYTES;
  static constexpr size_t bytes = bar_off + 16 * STAGES + 1024;  // + 1 KB to align the base
  static constexpr uint32_t ml_off = CWARPS * 8 * D * 4;         // after the O rows
  static_assert(ml_off + CWARPS * 16 * 4 <= bar_off, "the merge must fit in the ring");
};

__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) { return bars + 8 * s; }
template <int D>
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (Plan<D>::STAGES + s);
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

// The map coordinates (row, plane) of a tile's first token: the contiguous
// cache's (batch, kv head) plane.
__device__ __forceinline__ int2 tile_row(const Args& a, int b, int hk, int tok0) {
  return make_int2(tok0, b * a.hkv + hk);
}

// Grid (splits, hkv, batch).
template <typename T, int D>
__global__ void __launch_bounds__(Plan<D>::THREADS, 1)
    splitkv_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const Args a) {
  using P = Plan<D>;
  constexpr int STAGES = P::STAGES, TEAMS = P::TEAMS, CWARPS = P::CWARPS;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.group;
  const int length = a.lens[b];
  const int start = a.window_left >= 0 ? max(0, length - 1 - a.window_left) : 0;
  const int lo = max(start, split * a.tokens_per_split);
  const int hi = min(length, (split + 1) * a.tokens_per_split);
  const int first = lo / TILE;
  const int n_tiles = lo < hi ? (hi + TILE - 1) / TILE - first : 0;

  extern __shared__ __align__(16) unsigned char kd_smem[];
  unsigned char* smem = kd_smem + ((1024u - (smem_u32(kd_smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + P::bar_off;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full(bars, s), 1);
      mbar_init(bar_empty<D>(bars, s), 4);  // lane 0 of each warp of the tile's team
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(bar_empty<D>(bars, s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full(bars, s), P::STAGE_BYTES);
        const uint32_t k_s = base + s * P::STAGE_BYTES, v_s = k_s + P::KV_BYTES;
        const int2 rp = tile_row(a, b, hk, (first + i) * TILE);
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch) {
          tma_load_3d(k_s + ch * (TILE * 128), &tk, bar_full(bars, s), ch * 64, rp.x, rp.y);
          tma_load_3d(v_s + ch * (TILE * 128), &tv, bar_full(bars, s), ch * 64, rp.x, rp.y);
        }
      }
    }
    return;
  }

  const int cw = warp - 1, team = cw >> 2, quarter = cw & 3;
  const int g = lane >> 2, t4 = lane & 3;
  // Q rows of the group as A fragments (row g; rows >= G and 8-15 zero):
  // step kk holds columns 16 kk + 2 t4 (+1) and 16 kk + 8 + 2 t4 (+1)
  uint32_t qa[D / 16][2];
  {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        static_cast<const T*>(a.q) + ((size_t)b * a.hq + (size_t)hk * G + min(g, G - 1)) * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = g < G ? qr[8 * kk + t4] : 0u;
      qa[kk][1] = g < G ? qr[8 * kk + 4 + t4] : 0u;
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
      const int row0 = 16 * quarter;  // this warp's rows of the tile

      // S = Q K^T over the warp's 16 tokens: two 8-token n-tiles
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, swz(k_s, row0 + (mi >> 1) * 8 + lr, 16 * kk + (mi & 1) * 8));
        mma16816<T>(sc[0], qa[kk][0], qa[kk][1], kb);
        mma16816<T>(sc[1], qa[kk][0], qa[kk][1], kb + 2);
      }
      // row g's scores (c0, c1 of each n-tile): token tok0 + 8 j + 2 t4 + e
      float v[4];
      float mx = MFA_MASK;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float y = sc[x >> 1][x & 1];
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
      // P rounded to V's dtype: the A fragment of P V (rows 8-15 zero)
      const uint32_t pa0 = pack2<T>(v[0], v[1]), pa2 = pack2<T>(v[2], v[3]);
      // V fragments of tokens outside [lo, hi) are zeroed on an edge
      uint32_t keep0 = 0xffffffffu, keep1 = 0xffffffffu;
      if (edge) {
        const int t = tok0 + 2 * t4;
        keep0 = (t >= lo && t < hi ? 0x0000ffffu : 0u) | (t + 1 >= lo && t + 1 < hi ? 0xffff0000u : 0u);
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
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty<D>(bars, s));
  }

  // Merge the consumer warps' (m, l, O) of rows g < G: O = sum_w 2^(m_w - M)
  // O_w / sum_w 2^(m_w - M) l_w with M the largest m_w.
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  named_sync(1, 32 * CWARPS);  // no warp reads the ring any more
  float* mo = reinterpret_cast<float*>(smem);               // [CWARPS][8][D]
  float* ml = reinterpret_cast<float*>(smem + P::ml_off);   // [CWARPS][2][8]
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<float2*>(mo + (cw * 8 + g) * D + 8 * j + 2 * t4) =
        make_float2(acc[j][0], acc[j][1]);
  if (t4 == 0) {
    ml[cw * 16 + g] = m;
    ml[cw * 16 + 8 + g] = l;
  }
  named_sync(1, 32 * CWARPS);
  const size_t row0 = (((size_t)b * a.hkv + hk) * a.num_splits + split) * G;
  for (int idx = threadIdx.x - 32; idx < G * D; idx += 32 * CWARPS) {
    const int r = idx / D, x = idx % D;
    float mm = MFA_MASK;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) mm = fmaxf(mm, ml[w * 16 + r]);
    float ls = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) {
      const float wt = exp2f(ml[w * 16 + r] - mm);
      ls += wt * ml[w * 16 + 8 + r];
      o += wt * mo[(w * 8 + r) * D + x];
    }
    const bool empty = ls == 0.f;
    const float lsafe = (empty || isnan(ls)) ? 1.f : ls;
    a.o_part[(row0 + r) * D + x] = o / lsafe;
    if (x == 0) a.lse_part[row0 + r] = empty ? -INFINITY : mm * MFA_LN2 + logf(lsafe);
  }
}

// Encode the K and V maps and launch. Returns a cudaError_t code,
// MFA_TMA_ENCODE, or 0.
template <typename T, int D>
int launch(const void* k, const void* v, const Args& a, int batch, cudaStream_t stream) {
  using P = Plan<D>;
  constexpr bool BF = kIsBf16<T>;
  CUtensorMap tk, tv;
  // S == 0: no tile is ever loaded; the maps only need a valid base
  const bool kv = a.S > 0;
  const int rows = kv ? a.S : 1, planes = kv ? batch * a.hkv : 1;
  if (int err = mfa_tensor_map_3d(&tk, kv ? k : a.q, BF, D, rows, planes, TILE)) return err;
  if (int err = mfa_tensor_map_3d(&tv, kv ? v : a.q, BF, D, rows, planes, TILE)) return err;
  auto kern = splitkv_kernel<T, D>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  const dim3 grid(a.num_splits, a.hkv, batch);
  kern<<<grid, P::THREADS, P::bytes, stream>>>(tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace kd90
