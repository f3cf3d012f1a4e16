// Split-KV decode over a contiguous cache (kernel 5).
//
// Replaces mfa_tpu/kernels/decode.py:_decode_kernel (decode_attention) and
// its jnp combine_splits. One launch of kd90::splitkv_kernel
// (decode_sm90.cuh: a TMA ring of K/V tiles, products on the tensor cores)
// runs one block per (batch, kv head, split). At one split it writes O and
// the natural-log LSE; at more, each block writes its split's normalized
// fp32 partial O and LSE and the last block of each (batch, kv head) to
// finish merges them, with the max subtracted first and -inf (empty)
// splits weighted 0, as the reference's combine should (SURVEY.md §2.5
// hazard note). Bound: bytes of K + V; splits exist to put enough blocks on
// the 132 SMs when batch x kv heads is small
// (dispatch/config.py:num_splits_heuristic, one block an SM). fp32 q and
// caches (MFA_F32) run splitkv_kernel<float, ..> (both products in
// 3xTF32).
#include "decode_sm90.cuh"

// q [b, hq, d]; k/v [b, hkv, S, d]; out [b, hq, d] in q's dtype and
// lse_out [b, hq] fp32 (or null). num_splits > 1 (at most
// kd90::MAX_SPLITS): scratch o_part [b, hkv, splits, hq/hkv, d] fp32 and
// lse_part [b, hkv, splits, hq/hkv], and counters, b * hkv * row blocks
// int32 zeros (row blocks: 1 up to 8 q heads a kv head, else one per 16),
// zero again when the launch ends; launches that share them run one at a
// time. Every pointer 16-byte aligned. d: any multiple of 8 up to 256 (run
// at the instantiated D kd); any group hq / hkv: up to 8 q rows sit in one
// m16 tile, more take the 16-row blocks kernel 6 uses (M16, a span of 1).
extern "C" int mfa_decode_partials(const void* q, const void* k, const void* v,
                                   const int* lens, void* out, float* lse_out, float* o_part,
                                   float* lse_part, int* counters, int dtype, int batch,
                                   int hq, int hkv, int S, int d, int kd, int num_splits,
                                   int tokens_per_split, int window_left, float scale_log2e,
                                   float softcap, float softcap_mul, int sinks,
                                   const float* slopes, void* stream) {
  if (batch == 0) return 0;
  const int group = hkv > 0 ? hq / hkv : 0;
  if (group < 1 || num_splits < 1 || num_splits > kd90::MAX_SPLITS) return MFA_BAD_CONFIG;
  const bool m16 = group > 8;  // 16 query rows a block
  kd90::Args a = {q, lens, o_part, lse_part, hq, hkv, group, S, tokens_per_split,
                  num_splits, window_left, scale_log2e, softcap, softcap_mul};
  a.out = out;
  a.lse_out = lse_out;
  a.counters = counters;
  a.q_span = 1;
  a.sinks = sinks;
  a.slopes = slopes;
  a.dw = d;
  if (!mfa_dims_fit(d, kd)) return MFA_BAD_CONFIG;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFA_DEC_D(T, M)                                                               \
  if (kd == 64) return kd90::launch<T, 64, false, KV::F16, M>(k, v, a, batch, s);   \
  if (kd == 128) return kd90::launch<T, 128, false, KV::F16, M>(k, v, a, batch, s); \
  if (kd == 256) return kd90::launch<T, 256, false, KV::F16, M>(k, v, a, batch, s); \
  return MFA_BAD_CONFIG;
#define MFA_DEC(T)      \
  if (m16) {            \
    MFA_DEC_D(T, true)  \
  }                     \
  MFA_DEC_D(T, false)
  if (dtype == MFA_BF16) { MFA_DEC(__nv_bfloat16) }
  if (dtype == MFA_F16) { MFA_DEC(__half) }
  if (dtype == MFA_F32) { MFA_DEC(float) }
#undef MFA_DEC
#undef MFA_DEC_D
  return MFA_BAD_CONFIG;
}
