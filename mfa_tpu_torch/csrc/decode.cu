// Split-KV decode over a contiguous cache, plus the split combine.
//
// Replaces mfa_tpu/kernels/decode.py:_decode_kernel (decode_attention) and
// its jnp combine_splits. Launch 1 (kd90::splitkv_kernel, decode_sm90.cuh:
// a TMA ring of K/V tiles, products on the tensor cores) runs one block per
// (batch, kv head, split) and writes each split's normalized fp32 partial O
// and natural-log LSE; launch 2 (combine_kernel) merges the splits with the
// max subtracted first and -inf (empty) splits weighted 0, as the
// reference's combine kernel should (SURVEY.md §2.5 hazard note). Launch 2
// also merges the paged decode's splits (paged.cu, kernel 6).
// Bound: bytes of K + V; splits exist to put enough blocks on the 132 SMs
// when batch x kv heads is small (dispatch/config.py:num_splits_heuristic,
// one block of launch 1 an SM). fp32 q and caches (MFA_F32) run launch 1
// as splitkv_kernel<float, ..> (both products in 3xTF32) and the combine
// as combine_kernel<float>.
#include "decode_sm90.cuh"

namespace {

// One block per (batch, kv head, q row): rows are [span, group] flattened
// (span 1 but for kernel 6's multi-query spans); threads over D.
template <typename TQ>
__global__ void combine_kernel(const float* __restrict__ o_part,
                               const float* __restrict__ lse_part, TQ* __restrict__ out,
                               float* __restrict__ lse_out, int hkv, int group, int span,
                               int splits, int d) {
  const int rows = span * group;
  const int row = blockIdx.x;  // over batch * hkv * rows
  const int r = row % rows, bk = row / rows;
  const int b = bk / hkv, hk = bk % hkv;
  const float* lp = lse_part + (size_t)bk * splits * rows + r;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, lp[(size_t)s * rows]);
  const bool all_empty = m == -INFINITY;
  if (all_empty) m = 0.f;
  float denom = 0.f;
  for (int s = 0; s < splits; ++s) denom += expf(lp[(size_t)s * rows] - m);
  const float dsafe = denom == 0.f ? 1.f : denom;
  // out [b, span, hkv * group, d]
  const size_t orow = ((size_t)b * span + r / group) * hkv * group + (size_t)hk * group +
                      r % group;
  for (int x = threadIdx.x; x < d; x += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(lp[(size_t)s * rows] - m);
      acc += w * o_part[(((size_t)bk * splits + s) * rows + r) * d + x];
    }
    out[orow * d + x] = from_float<TQ>(acc / dsafe);
  }
  if (threadIdx.x == 0 && lse_out != nullptr)
    lse_out[orow] = all_empty ? -INFINITY : m + logf(dsafe);
}

}  // namespace

// Launch 1: per-split partials. q [b, hq, d]; k/v [b, hkv, S, d];
// o_part [b, hkv, splits, hq/hkv, d] fp32; lse_part [b, hkv, splits, hq/hkv];
// every pointer 16-byte aligned. d: any multiple of 8 up to 256 (run at
// the instantiated D kd); any group hq / hkv: up to 8 q rows sit in one
// m16 tile, more take the 16-row blocks kernel 6 uses (M16, a span of 1).
extern "C" int mfa_decode_partials(const void* q, const void* k, const void* v,
                                   const int* lens, float* o_part, float* lse_part,
                                   int dtype, int batch, int hq, int hkv, int S, int d, int kd,
                                   int num_splits, int tokens_per_split, int window_left,
                                   float scale_log2e, float softcap, float softcap_mul,
                                   int sinks, const float* slopes, void* stream) {
  if (batch == 0) return 0;
  const int group = hkv > 0 ? hq / hkv : 0;
  if (group < 1) return MFA_BAD_CONFIG;
  const bool m16 = group > 8;  // 16 query rows a block
  kd90::Args a = {q, lens, o_part, lse_part, hq, hkv, group, S, tokens_per_split,
                  num_splits, window_left, scale_log2e, softcap, softcap_mul};
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

// Launch 2: merge the splits of o_part [b, hkv, splits, q_span * hq / hkv,
// d] into out [b, q_span, hq, d] (q dtype) and, when lse_out is not null,
// the fp32 LSE [b, q_span, hq] (q_span 1 but for kernel 6's spans); dtype
// bf16, fp16 or fp32.
extern "C" int mfa_decode_combine(const float* o_part, const float* lse_part, void* out,
                                  float* lse_out, int dtype, int batch, int hq, int hkv,
                                  int num_splits, int d, int q_span, void* stream) {
  if (batch == 0) return 0;
  const int group = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(batch * hkv * group * q_span);
  if (dtype == MFA_BF16)
    combine_kernel<__nv_bfloat16><<<grid, 128, 0, s>>>(
        o_part, lse_part, static_cast<__nv_bfloat16*>(out), lse_out, hkv, group, q_span,
        num_splits, d);
  else if (dtype == MFA_F16)
    combine_kernel<__half><<<grid, 128, 0, s>>>(o_part, lse_part, static_cast<__half*>(out),
                                                 lse_out, hkv, group, q_span, num_splits, d);
  else if (dtype == MFA_F32)
    combine_kernel<float><<<grid, 128, 0, s>>>(o_part, lse_part, static_cast<float*>(out),
                                                lse_out, hkv, group, q_span, num_splits, d);
  else
    return MFA_BAD_CONFIG;
  return (int)cudaGetLastError();
}
