// Paged decode attention over a KV page pool, read in place.
//
// Replaces mfa_tpu/kernels/paged.py:_paged_kernel_body (paged_attention,
// also reached through decode.py:paged_decode_attention) for q_span == 1.
// Pages are [hkv, num_pages, page_size, head_dim] in bf16/fp16, or int8 with
// fp32 per-row scales [hkv, num_pages, page_size]; each block looks its
// rows up through block_table and never builds a dense copy. One block per
// (batch, kv head) writes the final output (no split axis, as on the TPU);
// pos_offset > 0 is the deferred-append query position (the query sits
// pos_offset past the stored length; reads stay bounded by it).
// Bound: bytes of the visible pages (int8 halves them). The TPU-only
// layout tricks (128-lane page padding, fp8-as-int8 bits, int4 token-pair
// order) do not exist here: rows are head_dim wide.
#include "decode_common.cuh"

// q [b, hq, d]; out [b, hq, d] in the q dtype; lse_out [b, hq] fp32 or
// null. int8 pages take bf16 q (kv_dtype MFA_I8 requires q_dtype MFA_BF16).
extern "C" int mfa_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                const float* k_scale, const float* v_scale, const int* lens,
                                const int* table, void* out, float* lse_out, int q_dtype,
                                int kv_dtype, int batch, int hq, int hkv, int num_pages,
                                int page_size, int pps, int d, int pos_offset,
                                int window_left, float scale_log2e, float softcap,
                                float softcap_mul, void* stream) {
  if (batch == 0) return 0;
  DecodeParams p = {};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.lens = lens;
  p.table = table;
  p.out = out;
  p.lse_out = lse_out;
  p.hq = hq;
  p.hkv = hkv;
  p.group = hq / hkv;
  p.num_pages = num_pages;
  p.page_size = page_size;
  p.pps = pps;
  p.pos_offset = pos_offset;
  p.window_left = window_left;
  p.scale_log2e = scale_log2e;
  p.softcap = softcap;
  p.softcap_mul = softcap_mul;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == MFA_I8 && q_dtype == MFA_BF16)
    return launch_decode_dg<__nv_bfloat16, int8_t, __nv_bfloat16>(p, d, batch, s);
  if (kv_dtype == MFA_BF16 && q_dtype == MFA_BF16)
    return launch_decode_dg<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(p, d, batch, s);
  if (kv_dtype == MFA_F16 && q_dtype == MFA_F16)
    return launch_decode_dg<__half, __half, __half>(p, d, batch, s);
  return MFA_BAD_CONFIG;
}
