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
// one block of launch 1 an SM).
#include "decode_sm90.cuh"

namespace {

// One block per (batch, kv head, q row of the group); threads over D.
template <typename TQ>
__global__ void combine_kernel(const float* __restrict__ o_part,
                               const float* __restrict__ lse_part, TQ* __restrict__ out,
                               float* __restrict__ lse_out, int hkv, int group, int splits,
                               int d) {
  const int row = blockIdx.x;  // over batch * hkv * group
  const int g = row % group, bk = row / group;
  const int b = bk / hkv, hk = bk % hkv;
  const float* lp = lse_part + (size_t)bk * splits * group + g;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, lp[(size_t)s * group]);
  const bool all_empty = m == -INFINITY;
  if (all_empty) m = 0.f;
  float denom = 0.f;
  for (int s = 0; s < splits; ++s) denom += expf(lp[(size_t)s * group] - m);
  const float dsafe = denom == 0.f ? 1.f : denom;
  const size_t orow = (size_t)b * hkv * group + (size_t)hk * group + g;
  for (int x = threadIdx.x; x < d; x += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(lp[(size_t)s * group] - m);
      acc += w * o_part[(((size_t)bk * splits + s) * group + g) * d + x];
    }
    out[orow * d + x] = from_float<TQ>(acc / dsafe);
  }
  if (threadIdx.x == 0 && lse_out != nullptr)
    lse_out[orow] = all_empty ? -INFINITY : m + logf(dsafe);
}

}  // namespace

// Launch 1: per-split partials. q [b, hq, d]; k/v [b, hkv, S, d];
// o_part [b, hkv, splits, hq/hkv, d] fp32; lse_part [b, hkv, splits, hq/hkv];
// every pointer 16-byte aligned.
extern "C" int mfa_decode_partials(const void* q, const void* k, const void* v,
                                   const int* lens, float* o_part, float* lse_part,
                                   int dtype, int batch, int hq, int hkv, int S, int d,
                                   int num_splits, int tokens_per_split, int window_left,
                                   float scale_log2e, float softcap, float softcap_mul,
                                   void* stream) {
  if (batch == 0) return 0;
  const int group = hq / hkv;
  if (group < 1 || group > 8) return MFA_BAD_CONFIG;
  kd90::Args a = {q, lens, o_part, lse_part, hq, hkv, group, S, tokens_per_split,
                  num_splits, window_left, scale_log2e, softcap, softcap_mul};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFA_DEC(T)                                                  \
  if (d == 64) return kd90::launch<T, 64, false, false>(k, v, a, batch, s);   \
  if (d == 128) return kd90::launch<T, 128, false, false>(k, v, a, batch, s); \
  if (d == 256) return kd90::launch<T, 256, false, false>(k, v, a, batch, s); \
  return MFA_BAD_CONFIG;
  if (dtype == MFA_BF16) { MFA_DEC(__nv_bfloat16) }
  if (dtype == MFA_F16) { MFA_DEC(__half) }
#undef MFA_DEC
  return MFA_BAD_CONFIG;
}

// Launch 2: merge the splits into out [b, hq, d] (q dtype) and, when
// lse_out is not null, the fp32 LSE [b, hq].
extern "C" int mfa_decode_combine(const float* o_part, const float* lse_part, void* out,
                                  float* lse_out, int dtype, int batch, int hq, int hkv,
                                  int num_splits, int d, void* stream) {
  if (batch == 0) return 0;
  const int group = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(batch * hkv * group);
  if (dtype == MFA_BF16)
    combine_kernel<__nv_bfloat16><<<grid, 128, 0, s>>>(
        o_part, lse_part, static_cast<__nv_bfloat16*>(out), lse_out, hkv, group,
        num_splits, d);
  else if (dtype == MFA_F16)
    combine_kernel<__half><<<grid, 128, 0, s>>>(o_part, lse_part, static_cast<__half*>(out),
                                                 lse_out, hkv, group, num_splits, d);
  else
    return MFA_BAD_CONFIG;
  return (int)cudaGetLastError();
}
