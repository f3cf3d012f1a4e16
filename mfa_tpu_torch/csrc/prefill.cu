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
// (varlen_attention's packed route), still on the mma.sync tile of
// flash_fwd.cuh. The TPU kernel tiles the packed token axis and masks by
// segment id, with scalar-prefetched per-q-block KV bounds, because a TPU
// grid is static with no early exit. Here, as in the original CUDA library
// (prefill.cuh:19-33, :724-726), the grid is (q tile of max_seqlen_q, q
// head, sequence): each block reads its sequence's offsets from cu_seqlens,
// exits when its tile lies past that sequence's length, and runs the same
// tile loop over the sequence's KV band. Layout: q [total_q, hq, D], k/v
// [total_k, hkv, D], o like q, lse [hq, total_q] (flash-attn's varlen
// softmax_lse layout); head_dim 64 and 128.
//
// Both: fp32 LSE, GQA by head index (kv head = h / (hq / hkv)); causal is
// top-left aligned per sequence and expressed as window_right = 0; the
// window (left, right) counts from each row's own position.
#include "flash_fwd.cuh"
#include "flash_fwd_sm90.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
    varlen_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, const int* __restrict__ cu_q,
                      const int* __restrict__ cu_k, int hq, int hkv, int total_q,
                      float scale_log2e, float softcap, float softcap_mul, int wl, int wr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q_start = cu_q[b], sq = cu_q[b + 1] - q_start;
  const int q0 = qb * FA_BM;
  if (q0 >= sq) return;  // tile past this sequence: the whole block leaves
  const int k_start = cu_k[b], sk = cu_k[b + 1] - k_start;
  const int hk = h / (hq / hkv);
  const size_t qo = ((size_t)q_start * hq + h) * D;
  const size_t ko = ((size_t)k_start * hkv + hk) * D;
  DenseKV<T> src{k + ko, v + ko, (long long)hkv * D, sk};
  const TileRows<T> rows = rows_of<T>(
      q + qo, o + qo, lse == nullptr ? nullptr : lse + (size_t)h * total_q + q_start, hq * D,
      q0, sq);
  flash_fwd_tile<T, D>(src, rows, band_of(q0, sk, wl, wr), scale_log2e, softcap, softcap_mul,
                       smem_raw);
}

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T, int D>
int launch_varlen(const void* q, const void* k, const void* v, void* o, float* lse,
                  const int* cu_q, const int* cu_k, int batch, int hq, int hkv, int total_q,
                  int max_sq, int wl, int wr, float scale_log2e, float softcap,
                  float softcap_mul, cudaStream_t stream) {
  const size_t smem = FlashSmem<T, D>::bytes(false);
  auto kern = varlen_fwd_kernel<T, D>;
  if (int err = prepare(kern, smem)) return err;
  dim3 grid((max_sq + FA_BM - 1) / FA_BM, hq, batch);
  kern<<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, cu_q, cu_k, hq, hkv, total_q, scale_log2e, softcap, softcap_mul,
      wl, wr);
  return (int)cudaGetLastError();
}

}  // namespace

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
                              int batch, int hq, int hkv, int total_q, int max_sq, int d,
                              int window_left, int window_right, float scale_log2e,
                              float softcap, float softcap_mul, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || total_q == 0 || max_sq == 0) return 0;
#define MFA_VARLEN(T, D)                                                                    \
  return launch_varlen<T, D>(q, k, v, o, lse, cu_q, cu_k, batch, hq, hkv, total_q, max_sq, \
                             window_left, window_right, scale_log2e, softcap, softcap_mul, s)
  if (dtype == MFA_BF16 && d == 64) MFA_VARLEN(__nv_bfloat16, 64);
  if (dtype == MFA_BF16 && d == 128) MFA_VARLEN(__nv_bfloat16, 128);
  if (dtype == MFA_F16 && d == 64) MFA_VARLEN(__half, 64);
  if (dtype == MFA_F16 && d == 128) MFA_VARLEN(__half, 128);
#undef MFA_VARLEN
  return MFA_BAD_CONFIG;
}
