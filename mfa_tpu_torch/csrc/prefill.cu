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
// Layout: q [b, hq, sq, d], k/v [b, hkv, sk, d], o like q, lse [b, hq, sq];
// any row width d that is a multiple of 8 up to 256, run at the
// instantiated D kd of 64, 128 or 256 at least d (the maps' zero-filled
// columns past d are inert), bf16 and fp16 (fp32: see below).
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
// k/v [total_k, hkv, d], o like q, lse [hq, total_q] (flash-attn's varlen
// softmax_lse layout); d as kernel 1's, bf16 and fp16. Bound: as
// kernel 1.
//
// fp32 q, k, v (dtype MFA_F32) run both on the tensor-core fp32 tile of
// flash_fwd_f32.cuh (3xTF32; rows of any width that is a multiple of 4 up
// to kd).
//
// Both: fp32 LSE, GQA by head index (kv head = h / (hq / hkv)); causal is
// top-left aligned per sequence and expressed as window_right = 0; the
// window (left, right) counts from each row's own position. sinks: with a
// left window, columns < sinks stay visible; slopes: ALiBi [hq] in the raw
// score domain (slope / scale), or null; kv_off (kernel 1 only): row r sits
// at position r + kv_off.
#include "flash_fwd_f32.cuh"

// lse may be null (no LSE output). Returns a cudaError_t code (0 = launched).
extern "C" int mfa_prefill_fwd(const void* q, const void* k, const void* v, void* o,
                               float* lse, int dtype, int batch, int hq, int hkv, int sq,
                               int sk, int d, int kd, int window_left, int window_right,
                               float scale_log2e, float softcap, float softcap_mul,
                               int sinks, int kv_off, const float* slopes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || sq == 0) return 0;
  fa90::Args a{hq, hkv, sq, sk, window_left, window_right, scale_log2e, softcap, softcap_mul};
  a.sinks = sinks;
  a.kv_off = kv_off;
  a.slopes = slopes;
  a.dw = d;
  if (!mfa_dims_fit(d, kd)) return MFA_BAD_CONFIG;
#define MFA_PREFILL(T, D) \
  return fa90::launch<T, D, fa90::PREFILL>(q, k, v, o, lse, nullptr, batch, a, s)
  if (dtype == MFA_BF16 && kd == 64) MFA_PREFILL(__nv_bfloat16, 64);
  if (dtype == MFA_BF16 && kd == 128) MFA_PREFILL(__nv_bfloat16, 128);
  if (dtype == MFA_BF16 && kd == 256) MFA_PREFILL(__nv_bfloat16, 256);
  if (dtype == MFA_F16 && kd == 64) MFA_PREFILL(__half, 64);
  if (dtype == MFA_F16 && kd == 128) MFA_PREFILL(__half, 128);
  if (dtype == MFA_F16 && kd == 256) MFA_PREFILL(__half, 256);
#undef MFA_PREFILL
#define MFA_PREFILL32(D) \
  return af32::launch_fwd<D, fa90::PREFILL>(q, k, v, o, lse, nullptr, batch, sq, a, s)
  if (dtype == MFA_F32 && kd == 64) MFA_PREFILL32(64);
  if (dtype == MFA_F32 && kd == 128) MFA_PREFILL32(128);
  if (dtype == MFA_F32 && kd == 256) MFA_PREFILL32(256);
#undef MFA_PREFILL32
  return MFA_BAD_CONFIG;
}

// cu_q/cu_k: [batch + 1] int32 on the device; max_sq bounds every
// sequence's q length (the grid's q-tile axis). lse [hq, total_q] or null.
extern "C" int mfa_varlen_fwd(const void* q, const void* k, const void* v, void* o,
                              float* lse, const int* cu_q, const int* cu_k, int dtype,
                              int batch, int hq, int hkv, int total_q, int total_k, int max_sq,
                              int d, int kd, int window_left, int window_right,
                              float scale_log2e,
                              float softcap, float softcap_mul, int sinks,
                              const float* slopes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || total_q == 0 || max_sq == 0) return 0;
  fa90::Args a{hq, hkv, 0, 0, window_left, window_right, scale_log2e, softcap, softcap_mul};
  a.sinks = sinks;
  a.slopes = slopes;
  a.cu_q = cu_q;
  a.cu_k = cu_k;
  a.total_q = total_q;
  a.dw = d;
  if (!mfa_dims_fit(d, kd)) return MFA_BAD_CONFIG;
#define MFA_VARLEN(T, D) \
  return fa90::launch_packed<T, D>(q, k, v, o, lse, batch, total_k, max_sq, a, s)
  if (dtype == MFA_BF16 && kd == 64) MFA_VARLEN(__nv_bfloat16, 64);
  if (dtype == MFA_BF16 && kd == 128) MFA_VARLEN(__nv_bfloat16, 128);
  if (dtype == MFA_BF16 && kd == 256) MFA_VARLEN(__nv_bfloat16, 256);
  if (dtype == MFA_F16 && kd == 64) MFA_VARLEN(__half, 64);
  if (dtype == MFA_F16 && kd == 128) MFA_VARLEN(__half, 128);
  if (dtype == MFA_F16 && kd == 256) MFA_VARLEN(__half, 256);
#undef MFA_VARLEN
#define MFA_VARLEN32(D) \
  return af32::launch_fwd<D, fa90::PREFILL, true>(q, k, v, o, lse, nullptr, batch, max_sq, a, s)
  if (dtype == MFA_F32 && kd == 64) MFA_VARLEN32(64);
  if (dtype == MFA_F32 && kd == 128) MFA_VARLEN32(128);
  if (dtype == MFA_F32 && kd == 256) MFA_VARLEN32(256);
#undef MFA_VARLEN32
  return MFA_BAD_CONFIG;
}
