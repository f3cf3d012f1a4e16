// Kernels 5 (decode over a contiguous cache) and 6 (paged decode) in fp32:
// fp32 q with fp32 caches or pages, or with int8 / fp8 / int4 pages and
// their fp32 row scales, on a SIMT tile of 16 rows a block (`attend`
// below); the rows, tiles and bounds it shares with the 64-row tensor-core
// tile are flash_fwd_f32.cuh's.
//
// One block owns one (batch, kv head, split) and 16 of that kv head's rows
// ([q_span, group] flattened, as decode_sm90.cuh's M16 blocks: a fourth
// grid axis of row blocks is folded into x), so any group and span run the
// same way. Split s covers tokens [s tps, (s + 1) tps) in whole 64-token
// tiles (kernels/decode.py:split_layout, paged.py:split_plan): BN divides
// 64, so a tile never straddles two splits. Span row si sits at position
// len + pos_offset - q_span + si and sees the columns [max(split start,
// position - wl), min(split end, len, position + 1)), and with a left
// window the split's columns below `sinks` (each sink read by the split
// that holds it, as in decode_sm90.cuh). ALiBi slopes come in the log2
// domain. With one split and `out` set the block stores the final O (fp32)
// and LSE; otherwise normalized fp32 partials and their LSE for the
// combine (decode.cu, launch 2). Rows past a sequence's length are never
// read: their tile rows are zeros (page ids are clamped into the pool, as
// the plain version clamps them).
//
// Bound: bytes of K and V (and the scales), read once. 16 rows a block
// keep the SIMT products off the critical path at the 8B group of 4; the
// tile's loads of a block (BN x D of K and of V) are issued together,
// which takes registers: with __launch_bounds__(256) alone ptxas kept
// 40-57 a thread (and spilled at D 64 on int8 pages), with a minimum of
// one block an SM it takes 72-117 and spills nothing.
//
// The SIMT tile: each product an fp32 FFMA chain, as exact as the plain
// version's, in another order.
//  - 256 threads as 16 x 16: thread (ty, tx) owns row ty of S and O, the
//    S columns tx + 16 j of each BN-key tile, and O's columns 64 c + 4 tx
//    .. + 3.
//  - Q [16][D + 4] is loaded once; each tile's K [BN][D + 4] and V [BN][D]
//    are loaded by all threads with 16-byte loads (quantized rows converted
//    exactly to fp32 as they land; rows past the valid length and columns
//    past the stored width are zeros), S = Q K^T from float4 reads (the
//    padded rows keep K's reads free of bank conflicts), the online softmax
//    with each row spread over the 16 threads of a half warp (shuffles),
//    P through shared memory, O += P V from float4 reads.
//  - BN = 64 keys a tile at D 64, 32 at D 128 and 256; a row's bounds are
//    read from shared memory, not held in registers.
//  - Blocks visit only the tiles some row can see (the sink tiles, then
//    the band's); masks are per element. Quantized pages: K's scales
//    multiply the score columns, V's fold into p after the row sum, and p
//    is rounded to bf16 before P V, as the plain versions compute them.
#pragma once

#include "decode_sm90.cuh"
#include "flash_fwd_f32.cuh"

namespace af32 {

// The tile's shared memory: Q [RM][D + 4], K [BN][D + 4], V [BN][D], P
// [RM][BN + 4], the K and V scales [BN] each, the rows.
template <int D>
struct Plan {
  static constexpr int RM = 16;                  // rows a block
  static constexpr int BN = D >= 128 ? 32 : 64;  // keys a tile
  static constexpr int CPT = BN / 16;           // S columns a thread
  static constexpr int OC = D / 64;             // O float4 chunks a thread
  static constexpr int QS = D + 4;              // Q and K row stride (floats)
  static constexpr int PS = BN + 4;             // P row stride
  static constexpr int k_off = RM * QS;
  static constexpr int v_off = k_off + BN * QS;
  static constexpr int p_off = v_off + BN * D;
  static constexpr int ks_off = p_off + RM * PS;  // K scales [BN]
  static constexpr int vs_off = ks_off + BN;      // V scales [BN]
  static constexpr int row_off = (vs_off + BN + 3) / 4 * 4;
  static constexpr size_t bytes = row_off * 4 + RM * sizeof(Row);
  static_assert(D % 64 == 0, "tile shape");
};

// The block body. load(kv0, k, v, k_scales, v_scales) fills the tile of
// columns [kv0, kv0 + BN): K rows at stride D + 4, V rows at stride D, fp32
// (zeros past the valid length and past dw); QUANT: the row scales too.
template <int D, bool QUANT, class Load>
__device__ __forceinline__ void attend(float* sm, const Row* rows, const Tiles& tl, const Math& mt,
                                       Load load) {
  using P = Plan<D>;
  constexpr int RM = P::RM, BN = P::BN, CPT = P::CPT, OC = P::OC, QS = P::QS, PS = P::PS;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float* qs = sm;
  float* ksm = sm + P::k_off;
  float* vsm = sm + P::v_off;
  float* psm = sm + P::p_off;
  float* kss = sm + P::ks_off;
  float* vss = sm + P::vs_off;
  const int dw = mt.dw;

  for (int idx = tid; idx < RM * (D / 4); idx += THREADS) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rows[r].q != nullptr && c < dw) x = __ldg(reinterpret_cast<const float4*>(rows[r].q + c));
    *reinterpret_cast<float4*>(qs + r * QS + c) = x;
  }
  // the row's bounds stay in shared memory (read once a tile): registers
  // hold only its running max and sum and its O
  float m = MFA_MASK, l = 0.f, acc[OC][4];
#pragma unroll
  for (int oc = 0; oc < OC; ++oc)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[oc][e] = 0.f;
  const float* qrow = qs + ty * QS;
  float* prow = psm + ty * PS;

  for (int it = 0; it < tl.n; ++it) {
    const int kv0 = tl.at(it) * BN;
    __syncthreads();  // the previous tile's K, V and P reads are done
    load(kv0, ksm, vsm, kss, vss);
    __syncthreads();

    // S = Q K^T
    float s[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = 0.f;
#pragma unroll 2  // 4 spilled past the 128 registers of two blocks an SM
    for (int kk = 0; kk < D; kk += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qrow + kk);
      float4 b[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) b[j] = *reinterpret_cast<const float4*>(ksm + (tx + 16 * j) * QS + kk);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float x = s[j];
        x = fmaf(a.x, b[j].x, x);
        x = fmaf(a.y, b[j].y, x);
        x = fmaf(a.z, b[j].z, x);
        x = fmaf(a.w, b[j].w, x);
        s[j] = x;
      }
    }

    // scores in the log2 domain, masks, softmax; P to shared memory
    {
      const Row& r = rows[ty];
      const int lo = r.lo, hi = r.hi, slo = r.slo, shi = r.shi;
      const float sl = r.slope;
      bool vis[CPT];
      float mx = MFA_MASK;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int jj = tx + 16 * j, col = kv0 + jj;
        float y = s[j];
        if constexpr (QUANT) y *= kss[jj];
        if (mt.softcap > 0.f) y = tanhf(y * mt.softcap_mul) * mt.softcap;
        y *= mt.c;
        if (sl != 0.f) y -= sl * fabsf((float)(r.pos - col));
        vis[j] = (col >= lo && col < hi) || (col >= slo && col < shi);
        s[j] = vis[j] ? y : MFA_MASK;
        mx = fmaxf(mx, s[j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m, mx), alpha = exp2f(m - mn);
      m = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[j] = vis[j] ? exp2f(s[j] - mn) : 0.f;
        ps += s[j];
      }
      l = alpha * l + ps;
#pragma unroll
      for (int oc = 0; oc < OC; ++oc)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[oc][e] *= alpha;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float p = s[j];
        if constexpr (QUANT) {  // V scales fold into p, then p is rounded to bf16
          p = __bfloat162float(__float2bfloat16_rn(p * vss[tx + 16 * j]));
        }
        prow[tx + 16 * j] = p;
      }
    }
    __syncthreads();

    // O += P V
#pragma unroll 2
    for (int j = 0; j < BN; j += 4) {
      const float4 pr = *reinterpret_cast<const float4*>(prow + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = e == 0 ? pr.x : e == 1 ? pr.y : e == 2 ? pr.z : pr.w;
#pragma unroll
        for (int oc = 0; oc < OC; ++oc) {
          const float4 vv = *reinterpret_cast<const float4*>(vsm + (j + e) * D + 64 * oc + 4 * tx);
          acc[oc][0] = fmaf(p, vv.x, acc[oc][0]);
          acc[oc][1] = fmaf(p, vv.y, acc[oc][1]);
          acc[oc][2] = fmaf(p, vv.z, acc[oc][2]);
          acc[oc][3] = fmaf(p, vv.w, acc[oc][3]);
        }
      }
    }
  }

  // Epilogue: the full row sum, O and LSE of a stored row (l == 0: the row
  // saw no column, O = 0 and LSE = -inf).
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  const Row& r = rows[ty];
  const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
  for (int oc = 0; oc < OC; ++oc) {
    const int c = 64 * oc + 4 * tx;
    if (r.o != nullptr && c < dw)
      *reinterpret_cast<float4*>(r.o + c) =
          make_float4(acc[oc][0] * inv, acc[oc][1] * inv, acc[oc][2] * inv, acc[oc][3] * inv);
  }
  if (r.lse != nullptr && tx == 0) r.lse[0] = l == 0.f ? -INFINITY : m * MFA_LN2 + logf(l);
}

// Fill K/V tile rows from row-addressed fp32 sources: row(col) -> the
// offset of column col's row in k and v (floats), for col < valid; other
// rows and the features past dw are zeros.
template <int D, class RowOf>
__device__ __forceinline__ void load_f32(const float* k, const float* v, int kv0, int valid,
                                         int dw, float* ksm, float* vsm, RowOf row_of) {
  using P = Plan<D>;
#pragma unroll
  for (int idx = threadIdx.x; idx < P::BN * (D / 4); idx += THREADS) {
    const int j = idx / (D / 4), c = (idx % (D / 4)) * 4, col = kv0 + j;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (col < valid && c < dw) {
      const size_t off = row_of(col) + c;
      kx = __ldg(reinterpret_cast<const float4*>(k + off));
      vx = __ldg(reinterpret_cast<const float4*>(v + off));
    }
    *reinterpret_cast<float4*>(ksm + j * P::QS + c) = kx;
    *reinterpret_cast<float4*>(vsm + j * D + c) = vx;
  }
}

// Fill a tile from quantized pages: rows of w bytes (int4: two features a
// byte, feature 2c in byte c's low nibble), their fp32 row scales beside
// them. page_row(col) -> the row's index in the pool ((hk P + page) page_size
// + row), for col < valid; other rows are zeros with zero scales.
template <int D, KV F, class RowOf>
__device__ __forceinline__ void load_quant(const int8_t* k, const int8_t* v, const float* k_scale,
                                           const float* v_scale, int kv0, int valid, int dw,
                                           float* ksm, float* vsm, float* kss, float* vss,
                                           RowOf page_row) {
  using P = Plan<D>;
  constexpr int FPC = F == KV::I4 ? 32 : 16;  // features a 16-byte chunk holds
  const int w = F == KV::I4 ? dw / 2 : dw;    // bytes of a stored row
  for (int idx = threadIdx.x; idx < P::BN * (D / FPC); idx += THREADS) {
    const int j = idx / (D / FPC), ch = idx % (D / FPC), col = kv0 + j;
    uint4 kb = make_uint4(0u, 0u, 0u, 0u), vb = kb;
    if (col < valid && ch * 16 < w) {
      const size_t off = (size_t)page_row(col) * w + ch * 16;
      kb = __ldg(reinterpret_cast<const uint4*>(k + off));
      vb = __ldg(reinterpret_cast<const uint4*>(v + off));
    }
    const uint32_t kw[4] = {kb.x, kb.y, kb.z, kb.w}, vw[4] = {vb.x, vb.y, vb.z, vb.w};
    float* kd = ksm + j * P::QS + ch * FPC;
    float* vd = vsm + j * D + ch * FPC;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if constexpr (F == KV::I4) {
        float kf[8], vf[8];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          // nibble n of the word: sign-extended 4-bit value
          kf[n] = (float)((int32_t)(kw[x] << (28 - 4 * n)) >> 28);
          vf[n] = (float)((int32_t)(vw[x] << (28 - 4 * n)) >> 28);
        }
        *reinterpret_cast<float4*>(kd + 8 * x) = make_float4(kf[0], kf[1], kf[2], kf[3]);
        *reinterpret_cast<float4*>(kd + 8 * x + 4) = make_float4(kf[4], kf[5], kf[6], kf[7]);
        *reinterpret_cast<float4*>(vd + 8 * x) = make_float4(vf[0], vf[1], vf[2], vf[3]);
        *reinterpret_cast<float4*>(vd + 8 * x + 4) = make_float4(vf[4], vf[5], vf[6], vf[7]);
      } else {
        float kf[4], vf[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t kbyte = (kw[x] >> (8 * n)) & 0xffu, vbyte = (vw[x] >> (8 * n)) & 0xffu;
          if constexpr (F == KV::E4M3) {
            kf[n] = e4m3_value(kbyte);
            vf[n] = e4m3_value(vbyte);
          } else {
            kf[n] = (float)(int8_t)kbyte;
            vf[n] = (float)(int8_t)vbyte;
          }
        }
        *reinterpret_cast<float4*>(kd + 4 * x) = make_float4(kf[0], kf[1], kf[2], kf[3]);
        *reinterpret_cast<float4*>(vd + 4 * x) = make_float4(vf[0], vf[1], vf[2], vf[3]);
      }
    }
  }
  for (int j = threadIdx.x; j < P::BN; j += THREADS) {
    const int col = kv0 + j;
    const bool ok = col < valid;
    const size_t r = ok ? (size_t)page_row(col) : 0;
    kss[j] = ok ? __ldg(k_scale + r) : 0.f;
    vss[j] = ok ? __ldg(v_scale + r) : 0.f;
  }
}


// Grid (splits x row blocks, hkv, batch). PAGED: the source is the page
// pool through the block table (k_pages, v_pages [hkv, P, page, w]); else
// k, v [b, hkv, S, dw]. F: KV::F16 = pages of q's dtype (fp32 here), else
// the quantized format.
template <int D, bool PAGED, KV F>
__global__ void __launch_bounds__(THREADS, 1)
    decode_kernel(const void* __restrict__ k, const void* __restrict__ v, const kd90::Args a) {
  using P = Plan<D>;
  constexpr int RM = P::RM;
  constexpr bool QUANT = F != KV::F16;
  static_assert(PAGED || !QUANT, "quantized rows come only as pages");
  const int split = blockIdx.x % a.num_splits, r0 = RM * (blockIdx.x / a.num_splits);
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = a.group, span = a.q_span, R = span * G;
  const int length = a.lens[b];
  const int s_lo = split * a.tokens_per_split;
  const int s_hi = min(a.S, (split + 1) * a.tokens_per_split);
  const int dw = a.dw;
  float* sm = smem_f32();
  Row* rows = reinterpret_cast<Row*>(sm + P::row_off);
  __shared__ Bounds bnd;
  if (threadIdx.x == 0) bounds_init(&bnd);
  __syncthreads();
  if (threadIdx.x < RM) {
    const int rr = r0 + threadIdx.x;
    Row r{};
    if (rr < R) {
      const int si = rr / G, hq = hk * G + rr % G;
      const size_t qrow = ((size_t)b * span + si) * a.hq + hq;
      r.q = static_cast<const float*>(a.q) + qrow * dw;
      if (a.out != nullptr) {
        r.o = static_cast<float*>(a.out) + qrow * dw;
        r.lse = a.lse_out != nullptr ? a.lse_out + qrow : nullptr;
      } else {
        const size_t prow = (((size_t)b * a.hkv + hk) * a.num_splits + split) * R + rr;
        r.o = a.o_part + prow * dw;
        r.lse = a.lse_part + prow;
      }
      const int pos = length + a.pos_offset - span + si;
      r.pos = pos;
      r.lo = max(s_lo, a.window_left >= 0 ? max(0, pos - a.window_left) : 0);
      r.hi = min(s_hi, min(length, pos + 1));
      r.slo = s_lo;
      r.shi = max(s_lo, min(a.sinks, r.hi));
      r.slope = a.slopes != nullptr ? a.slopes[hq] : 0.f;
      bounds_add(&bnd, r);
    }
    rows[threadIdx.x] = r;
  }
  __syncthreads();
  const Tiles tl = tiles_of(bnd, P::BN);
  const Math mt{a.scale_log2e, a.softcap, a.softcap_mul, dw};
  // the pool row of column col (PAGED); lambdas capture by value (a
  // reference capture keeps its variable in local memory)
  const int* tab = PAGED ? a.table + (size_t)b * a.pps : nullptr;
  const int n_pages = a.num_pages, page = a.page_size;
  auto page_row = [=](int col) {
    const int pg = min(max(tab[col / page], 0), n_pages - 1);
    return ((size_t)hk * n_pages + pg) * page + col % page;
  };
  if constexpr (QUANT) {
    const int8_t* kq = static_cast<const int8_t*>(k);
    const int8_t* vq = static_cast<const int8_t*>(v);
    const float *ksc = a.k_scale, *vsc = a.v_scale;
    auto load = [=](int kv0, float* ksm, float* vsm, float* kss, float* vss) {
      load_quant<D, F>(kq, vq, ksc, vsc, kv0, length, dw, ksm, vsm, kss, vss, page_row);
    };
    attend<D, true>(sm, rows, tl, mt, load);
  } else {
    const size_t plane = PAGED ? 0 : (size_t)(b * a.hkv + hk) * a.S * dw;
    const float* kf = static_cast<const float*>(k) + plane;
    const float* vf = static_cast<const float*>(v) + plane;
    const int valid = PAGED ? length : min(length, a.S);
    auto load = [=](int kv0, float* ksm, float* vsm, float*, float*) {
      load_f32<D>(kf, vf, kv0, valid, dw, ksm, vsm,
                      [=](int col) { return (PAGED ? page_row(col) : (size_t)col) * dw; });
    };
    attend<D, false>(sm, rows, tl, mt, load);
  }
}

// Launch kernel 5's launch 1 (PAGED false: a.out null, partials) or kernel
// 6. Returns a cudaError_t code or MFA_BAD_CONFIG.
template <int D, bool PAGED, KV F>
int launch_decode(const void* k, const void* v, const kd90::Args& a, int batch,
                  cudaStream_t stream) {
  using P = Plan<D>;
  const int align = F == KV::I4 ? 32 : F == KV::F16 ? 4 : 16;  // 16-byte row chunks
  if (a.dw <= 0 || a.dw > D || a.dw % align != 0 || a.group < 1 || a.q_span < 1)
    return MFA_BAD_CONFIG;
  auto kern = decode_kernel<D, PAGED, F>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  const int row_blocks = (a.q_span * a.group + 15) / 16;
  const dim3 grid(a.num_splits * row_blocks, a.hkv, batch);
  kern<<<grid, THREADS, P::bytes, stream>>>(k, v, a);
  return (int)cudaGetLastError();
}

}  // namespace af32
