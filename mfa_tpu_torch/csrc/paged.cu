// Paged decode attention over a KV page pool, read in place (kernel 6).
//
// Replaces mfa_tpu/kernels/paged.py:_paged_kernel_body (paged_attention,
// also reached through decode.py:paged_decode_attention) for q_span == 1.
// Pages are [hkv, num_pages, page_size, head_dim] in bf16/fp16, or int8 with
// fp32 per-row scales [hkv, num_pages, page_size]. The tile is kernel 5's
// (decode_sm90.cuh: a TMA ring of 64-token tiles, the products on mma.sync)
// with one TMA box per page through the block table; int8 rows convert to
// bf16 in registers. pos_offset > 0 is the deferred-append query position
// (the query sits pos_offset past the stored length; reads stay bounded by
// it). Bound: bytes of the visible pages (int8 halves them).
//
// The TPU kernel walks a sequence's pages in order; here a grid that does
// not fill the 132 SMs splits each sequence's pages into whole 64-token
// tiles (num_splits, tokens_per_split from kernels/paged.py:split_plan).
// One split writes the final O and LSE in this launch; more write fp32
// partials that decode.cu's mfa_decode_combine merges.
//
// The TPU-only layout tricks (128-lane page padding, fp8-as-int8 bits, int4
// token-pair order) do not exist here: rows are head_dim wide.
#include "decode_sm90.cuh"

// q [b, hq, d] (int8 pages take bf16 q); with num_splits == 1: out [b, hq,
// d] in the q dtype and lse_out [b, hq] fp32, else o_part [b, hkv,
// num_splits, hq / hkv, d] and lse_part [b, hkv, num_splits, hq / hkv]
// fp32. page_size a multiple of 8; every pointer 16-byte aligned. Returns a
// cudaError_t code.
extern "C" int mfa_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                const float* k_scale, const float* v_scale, const int* lens,
                                const int* table, void* out, float* lse_out, float* o_part,
                                float* lse_part, int q_dtype, int kv_dtype, int batch, int hq,
                                int hkv, int num_pages, int page_size, int pps, int d,
                                int num_splits, int tokens_per_split, int pos_offset,
                                int window_left, float scale_log2e, float softcap,
                                float softcap_mul, void* stream) {
  if (batch == 0) return 0;
  const int group = hkv > 0 ? hq / hkv : 0;
  if (group < 1 || group > 8 || num_pages < 1 || page_size <= 0 || page_size % 8 != 0 ||
      num_splits < 1 || tokens_per_split % kd90::TILE != 0)
    return MFA_BAD_CONFIG;
  int box_rows = kd90::TILE;  // gcd(page_size, 64): a power of two >= 8
  while (page_size % box_rows != 0) box_rows >>= 1;
  kd90::Args a = {};
  a.q = q;
  a.lens = lens;
  a.o_part = o_part;
  a.lse_part = lse_part;
  a.hq = hq;
  a.hkv = hkv;
  a.group = group;
  a.S = pps * page_size;
  a.tokens_per_split = tokens_per_split;
  a.num_splits = num_splits;
  a.window_left = window_left;
  a.scale_log2e = scale_log2e;
  a.softcap = softcap;
  a.softcap_mul = softcap_mul;
  a.table = table;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.out = num_splits == 1 ? out : nullptr;
  a.lse_out = lse_out;
  a.num_pages = num_pages;
  a.page_size = page_size;
  a.pps = pps;
  a.box_rows = box_rows;
  a.pos_offset = pos_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFA_PAGED(T, QUANT)                                                            \
  if (d == 64) return kd90::launch<T, 64, true, QUANT>(k_pages, v_pages, a, batch, s);   \
  if (d == 128) return kd90::launch<T, 128, true, QUANT>(k_pages, v_pages, a, batch, s); \
  if (d == 256) return kd90::launch<T, 256, true, QUANT>(k_pages, v_pages, a, batch, s); \
  return MFA_BAD_CONFIG
  if (kv_dtype == MFA_I8 && q_dtype == MFA_BF16) { MFA_PAGED(__nv_bfloat16, true); }
  if (kv_dtype == MFA_BF16 && q_dtype == MFA_BF16) { MFA_PAGED(__nv_bfloat16, false); }
  if (kv_dtype == MFA_F16 && q_dtype == MFA_F16) { MFA_PAGED(__half, false); }
#undef MFA_PAGED
  return MFA_BAD_CONFIG;
}
