// Kernels 5 (decode over a contiguous cache) and 6 (paged decode) in fp32:
// fp32 q with fp32 caches or pages, or with int8 / fp8 / int4 pages and
// their fp32 row scales. The block body is the fp32 tile of
// flash_fwd_f32.cuh; this file sets up a block's rows and its K/V loader.
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
#pragma once

#include "decode_sm90.cuh"
#include "flash_fwd_f32.cuh"

namespace af32 {

// Grid (splits x row blocks, hkv, batch). PAGED: the source is the page
// pool through the block table (k_pages, v_pages [hkv, P, page, w]); else
// k, v [b, hkv, S, dw]. F: KV::F16 = pages of q's dtype (fp32 here), else
// the quantized format.
template <int D, bool PAGED, KV F>
__global__ void __launch_bounds__(THREADS, 1)
    decode_kernel(const void* __restrict__ k, const void* __restrict__ v, const kd90::Args a) {
  constexpr int RM = 16;
  constexpr bool QUANT = F != KV::F16;
  static_assert(PAGED || !QUANT, "quantized rows come only as pages");
  using P = Plan<RM, D>;
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
    r.rid = -1;
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
      load_quant<RM, D, F>(kq, vq, ksc, vsc, kv0, length, dw, ksm, vsm, kss, vss, page_row);
    };
    attend<RM, D, false, true, false>(sm, rows, tl, mt, nullptr, 0, load);
  } else {
    const size_t plane = PAGED ? 0 : (size_t)(b * a.hkv + hk) * a.S * dw;
    const float* kf = static_cast<const float*>(k) + plane;
    const float* vf = static_cast<const float*>(v) + plane;
    const int valid = PAGED ? length : min(length, a.S);
    auto load = [=](int kv0, float* ksm, float* vsm, float*, float*) {
      load_f32<RM, D>(kf, vf, kv0, valid, dw, ksm, vsm,
                      [=](int col) { return (PAGED ? page_row(col) : (size_t)col) * dw; });
    };
    attend<RM, D, false, false, false>(sm, rows, tl, mt, nullptr, 0, load);
  }
}

// Launch kernel 5's launch 1 (PAGED false: a.out null, partials) or kernel
// 6. Returns a cudaError_t code or MFA_BAD_CONFIG.
template <int D, bool PAGED, KV F>
int launch_decode(const void* k, const void* v, const kd90::Args& a, int batch,
                  cudaStream_t stream) {
  using P = Plan<16, D>;
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
