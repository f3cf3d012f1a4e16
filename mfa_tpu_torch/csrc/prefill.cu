// Flash-attention prefill forward for Hopper (sm_90a): O and natural-log
// LSE, on the batched layout (mfa_prefill_fwd, kernel 1) and on packed
// variable-length sequences (mfa_varlen_fwd, kernel 7).
//
// mfa_prefill_fwd replaces mfa_tpu/kernels/prefill.py:_prefill_body (via
// _prefill_flat_kernel / _prefill_bht_kernel): the classic online-softmax
// forward, on the warp-specialised wgmma + TMA tile of flash_fwd_sm90.cuh
// (128 q rows a block, K/V through a TMA ring, both products on wgmma).
// Bound: tensor-core operations past a few hundred keys (4 D flops per
// visible (row, key) pair against 2 D bytes of K/V per 128 rows); at the
// 8B wave's 256-token prompts the load of q/k/v/o. Softcap and fp16 run
// only here; the default bf16 engines are bound.cu's.
// Layout: q [b, hq, sq, D], k/v [b, hkv, sk, D], o like q, lse [b, hq, sq];
// head_dim 64, 128 and 256 (Gemma), bf16 and fp16.
//
// mfa_varlen_fwd replaces mfa_tpu/kernels/varlen.py:_varlen_kernel
// (varlen_attention's packed route), on the same wgmma + TMA tile: the
// classic softmax over packed rows (fwd_kernel<.., PACKED>). The TPU kernel
// tiles the packed token axis and masks by segment id, with
// scalar-prefetched per-q-block KV bounds, because a TPU grid is static with
// no early exit. Here, as in the original CUDA library, the grid is (q
// head, sequence, q tile of max_seqlen_q): each block reads its sequence's
// offsets from cu_seqlens, exits when its tile lies past that sequence's
// length, and runs kernel 1's tile over the sequence's KV band, its TMA
// boxes starting at the sequence's first rows. Layout: q [total_q, hq, D],
// k/v [total_k, hkv, D], o like q, lse [hq, total_q] (flash-attn's varlen
// softmax_lse layout); head_dim 64, 128 and 256, bf16 and fp16. Bound: as
// kernel 1.
//
// Both: fp32 LSE, GQA by head index (kv head = h / (hq / hkv)); causal is
// top-left aligned per sequence and expressed as window_right = 0; the
// window (left, right) counts from each row's own position.
#include "flash_fwd_sm90.cuh"

// lse may be null (no LSE output). Returns a cudaError_t code (0 = launched).
extern "C" int mfa_prefill_fwd(const void* q, const void* k, const void* v, void* o,
                               float* lse, int dtype, int batch, int hq, int hkv, int sq,
                               int sk, int d, int window_left, int window_right,
                               float scale_log2e, float softcap, float softcap_mul,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || sq == 0) return 0;
  const fa90::Args a{hq, hkv, sq, sk, window_left, window_right, scale_log2e, softcap,
                     softcap_mul};
#define MFA_PREFILL(T, D) \
  return fa90::launch<T, D, fa90::PREFILL>(q, k, v, o, lse, nullptr, batch, a, s)
  if (dtype == MFA_BF16 && d == 64) MFA_PREFILL(__nv_bfloat16, 64);
  if (dtype == MFA_BF16 && d == 128) MFA_PREFILL(__nv_bfloat16, 128);
  if (dtype == MFA_BF16 && d == 256) MFA_PREFILL(__nv_bfloat16, 256);
  if (dtype == MFA_F16 && d == 64) MFA_PREFILL(__half, 64);
  if (dtype == MFA_F16 && d == 128) MFA_PREFILL(__half, 128);
  if (dtype == MFA_F16 && d == 256) MFA_PREFILL(__half, 256);
#undef MFA_PREFILL
  return MFA_BAD_CONFIG;
}

// cu_q/cu_k: [batch + 1] int32 on the device; max_sq bounds every
// sequence's q length (the grid's q-tile axis). lse [hq, total_q] or null.
extern "C" int mfa_varlen_fwd(const void* q, const void* k, const void* v, void* o,
                              float* lse, const int* cu_q, const int* cu_k, int dtype,
                              int batch, int hq, int hkv, int total_q, int total_k, int max_sq,
                              int d, int window_left, int window_right, float scale_log2e,
                              float softcap, float softcap_mul, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || total_q == 0 || max_sq == 0) return 0;
  fa90::Args a{hq, hkv, 0, 0, window_left, window_right, scale_log2e, softcap, softcap_mul};
  a.cu_q = cu_q;
  a.cu_k = cu_k;
  a.total_q = total_q;
#define MFA_VARLEN(T, D) \
  return fa90::launch_packed<T, D>(q, k, v, o, lse, batch, total_k, max_sq, a, s)
  if (dtype == MFA_BF16 && d == 64) MFA_VARLEN(__nv_bfloat16, 64);
  if (dtype == MFA_BF16 && d == 128) MFA_VARLEN(__nv_bfloat16, 128);
  if (dtype == MFA_BF16 && d == 256) MFA_VARLEN(__nv_bfloat16, 256);
  if (dtype == MFA_F16 && d == 64) MFA_VARLEN(__half, 64);
  if (dtype == MFA_F16 && d == 128) MFA_VARLEN(__half, 128);
  if (dtype == MFA_F16 && d == 256) MFA_VARLEN(__half, 256);
#undef MFA_VARLEN
  return MFA_BAD_CONFIG;
}
