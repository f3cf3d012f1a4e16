// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV from the
// forward's saved LSE. Five launches, on bf16 / fp16 inputs all on the
// warp-specialised wgmma + TMA kernels of flash_bwd_sm90.cuh (fp32: below):
//
//  * mfa_bwd_fused (kernel 11) replaces
//    mfa_tpu/kernels/backward.py:_fused_bwd_kernel (fb90::bwd_kernel<T, D,
//    true>). One block per (kv head, batch, 128-key tile; 64 keys at head
//    dim 256, flash_bwd_sm90.cuh's Plan::SPLIT) computes dK and
//    dV for its keys and adds dQ into a zeroed fp32 workspace [b, hq, sq,
//    d] with bulk TMA reductions; the wrapper casts it to q's dtype. One
//    pass computes all three gradients (5 products per tile), as the TPU
//    kernel does. Its dQ varies in the last bits from run to run (the
//    order of the blocks' additions).
//  * mfa_bwd_dkv (kernel 12) replaces _dkv_kernel / _dkv_tri_kernel
//    (_dkv_body): kernel 11's kernel without its dQ step (fb90::bwd_kernel<T,
//    D, false>); mfa_bwd_dq (kernel 13) replaces _dq_kernel / _dq_tri_kernel
//    (_dq_body): fb90::dq_kernel<T, D, false>, the forward's tile of 128 q
//    rows walking the band's key tiles with dQ in registers. Together the
//    deterministic two-launch split (4 + 3 products). The TPU's rectangular
//    and triangular grids are two enumerations of one function; here a
//    block computes its band's bounds and skips dead tiles, so each is one
//    launch.
//  * mfa_varlen_bwd_dkv / mfa_varlen_bwd_dq (kernel 14) replace
//    _vl_dkv_kernel / _vl_dq_kernel (varlen_attention_bwd): the same two
//    kernels on the packed layout (PACKED: strided tensor maps, each block
//    reading its sequence's offsets from cu_seqlens and leaving when its
//    tile lies past that sequence). Causal and the window act on positions
//    local to the sequence, top-left aligned. On equal lengths they give
//    the bits of kernels 12 + 13.
//
// Layouts: dense q, dO, dQ [b, hq, sq, d], k, v, dK, dV [b, hkv, sk, d],
// LSE and delta [b, hq, sq]; packed q [total_q, hq, d], k [total_k, hkv, d],
// LSE and delta [hq, total_q]; d any multiple of 8 up to 256, run at the
// instantiated D kd of 64, 128 or 256 at least d. LSE is the natural log of
// the scaled (capped) logits, -inf on rows that saw no column; it becomes
// log2 once.
// GQA: q head h reads kv head h / (hq / hkv), and a dK/dV block sums over
// the group's q heads. slopes: ALiBi [hq] in the log2 domain (slope *
// log2 e) or null, on every launch; kv_off (row r at position r + kv_off):
// the dense launches; sinks: the fused launch only (mfa_tpu's split refuses
// them).
//
// fp32 inputs (dtype MFA_F32) run every launch on the tile of
// flash_bwd_f32.cuh (bf32::bwd_kernel<D, MODE, PACKED>: FUSED, DKV, DQ), the
// same function and options with its five products on mma.sync in 3xTF32
// (three TF32 products a product: fp32-class accuracy).
//
// Bound: tensor-core operations, 10 * hq * d flops per visible (row,
// column) pair for the fused launch (8 for dK/dV, 6 for dQ); at training
// shapes it is far from the 295 flops-per-byte line.
#include "flash_bwd_f32.cuh"

// d: the rows' width (a multiple of 8 up to 256), run at the instantiated
// D kd (Args::dw = d); CALL(T, D) launches a 16-bit dtype, CALL32(D) fp32
#define MFA_BWD_DISPATCH(CALL, CALL32)                                 \
  if (!mfa_dims_fit(d, kd)) return MFA_BAD_CONFIG;                     \
  if (dtype == MFA_F32 && kd == 64) return CALL32(64);                 \
  if (dtype == MFA_F32 && kd == 128) return CALL32(128);               \
  if (dtype == MFA_F32 && kd == 256) return CALL32(256);               \
  if (dtype == MFA_BF16 && kd == 64) return CALL(__nv_bfloat16, 64);   \
  if (dtype == MFA_BF16 && kd == 128) return CALL(__nv_bfloat16, 128); \
  if (dtype == MFA_BF16 && kd == 256) return CALL(__nv_bfloat16, 256); \
  if (dtype == MFA_F16 && kd == 64) return CALL(__half, 64);           \
  if (dtype == MFA_F16 && kd == 128) return CALL(__half, 128);         \
  if (dtype == MFA_F16 && kd == 256) return CALL(__half, 256);         \
  return MFA_BAD_CONFIG

namespace {

fb90::Args args_of(int hq, int hkv, int sq, int sk, int d, int window_left, int window_right,
                   float scale, float softcap, int sinks, int kv_off, const float* slopes) {
  const float c2 = softcap > 0.f ? fb90::LOG2E : scale * fb90::LOG2E;
  fb90::Args a{hq,    hkv, sq,      sk, window_left, window_right,
               scale, c2,  softcap, softcap > 0.f ? scale / softcap : 0.f};
  a.sinks = sinks;
  a.kv_off = kv_off;
  a.slopes = slopes;
  a.dw = d;
  return a;
}

// Kernel 11 (dq_ws set: dQ added into it) or kernel 12 (dq_ws null: dK and
// dV alone) on fb90::bwd_kernel.
int launch_sm90(const void* q, const void* k, const void* v, const void* dO, const float* lse,
                const float* delta, float* dq_ws, void* dk, void* dv, int dtype, int batch,
                int hq, int hkv, int sq, int sk, int d, int kd, int window_left,
                int window_right, float scale, float softcap, int sinks, int kv_off,
                const float* slopes, void* stream) {
  if (batch == 0 || sk == 0) return 0;
  if (sq == 0) {  // no row sees a key: dK = dV = 0
    const size_t bytes = (size_t)batch * hkv * sk * d * (dtype == MFA_F32 ? 4 : 2);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (int err = (int)cudaMemsetAsync(dk, 0, bytes, st)) return err;
    return (int)cudaMemsetAsync(dv, 0, bytes, st);
  }
  const fb90::Args a = args_of(hq, hkv, sq, sk, d, window_left, window_right, scale, softcap,
                               sinks, kv_off, slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MFA_CALL(T, D)                                                                        \
  (dq_ws != nullptr                                                                           \
       ? fb90::launch<T, D, true>(q, k, v, dO, lse, delta, dq_ws, dk, dv, batch, a, st)      \
       : fb90::launch<T, D, false>(q, k, v, dO, lse, delta, nullptr, dk, dv, batch, a, st))
#define MFA_CALL32(D)                                                                         \
  (dq_ws != nullptr ? bf32::launch<D, bf32::FUSED, false>(q, k, v, dO, lse, delta, dq_ws, dk, \
                                                          dv, batch, sk, a, st)               \
                    : bf32::launch<D, bf32::DKV, false>(q, k, v, dO, lse, delta, nullptr, dk, \
                                                        dv, batch, sk, a, st))
  MFA_BWD_DISPATCH(MFA_CALL, MFA_CALL32);
#undef MFA_CALL
#undef MFA_CALL32
}

}  // namespace

// dq_ws: zeroed fp32 [b, hq, sq, d] (the fused launch adds dQ into it);
// dk, dv: [b, hkv, sk, d] in the dtype.
// Every launch returns a cudaError_t code (0 = launched).
extern "C" int mfa_bwd_fused(const void* q, const void* k, const void* v, const void* dO,
                             const float* lse, const float* delta, float* dq_ws, void* dk,
                             void* dv, int dtype, int batch, int hq, int hkv, int sq, int sk,
                             int d, int kd, int window_left, int window_right, float scale,
                             float softcap, int sinks, int kv_off, const float* slopes,
                             void* stream) {
  if (dq_ws == nullptr) return MFA_BAD_CONFIG;
  return launch_sm90(q, k, v, dO, lse, delta, dq_ws, dk, dv, dtype, batch, hq, hkv, sq, sk, d,
                     kd, window_left, window_right, scale, softcap, sinks, kv_off, slopes,
                     stream);
}

extern "C" int mfa_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                           const float* lse, const float* delta, void* dk, void* dv, int dtype,
                           int batch, int hq, int hkv, int sq, int sk, int d, int kd,
                           int window_left, int window_right, float scale, float softcap,
                           int kv_off, const float* slopes, void* stream) {
  return launch_sm90(q, k, v, dO, lse, delta, nullptr, dk, dv, dtype, batch, hq, hkv, sq, sk, d,
                     kd, window_left, window_right, scale, softcap, 0, kv_off, slopes, stream);
}

// dq: [b, hq, sq, d] in the dtype, every row stored (0 where no key is seen).
extern "C" int mfa_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                          const float* lse, const float* delta, void* dq, int dtype, int batch,
                          int hq, int hkv, int sq, int sk, int d, int kd,
                          int window_left, int window_right, float scale, float softcap,
                          int kv_off, const float* slopes, void* stream) {
  if (batch == 0 || sq == 0) return 0;
  const fb90::Args a = args_of(hq, hkv, sq, sk, d, window_left, window_right, scale, softcap,
                               0, kv_off, slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MFA_CALL(T, D) \
  fb90::launch_dq<T, D, false>(q, k, v, dO, lse, delta, dq, batch, 0, 0, a, st)
#define MFA_CALL32(D)                                                                     \
  bf32::launch<D, bf32::DQ, false>(q, k, v, dO, lse, delta, static_cast<float*>(dq), nullptr, \
                                   nullptr, batch, sq, a, st)
  MFA_BWD_DISPATCH(MFA_CALL, MFA_CALL32);
#undef MFA_CALL
#undef MFA_CALL32
}

// cu_q/cu_k: [batch + 1] int32 on the device; max_sk bounds every sequence's
// key length (the grid's tile axis). dk, dv: [total_k, hkv, d], every key
// of every sequence stored.
extern "C" int mfa_varlen_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                                  const float* lse, const float* delta, void* dk, void* dv,
                                  const int* cu_q, const int* cu_k, int dtype, int batch,
                                  int hq, int hkv, int total_q, int total_k, int max_sk, int d,
                                  int kd, int window_left, int window_right, float scale,
                                  float softcap, const float* slopes, void* stream) {
  if (batch == 0 || max_sk == 0) return 0;
  fb90::Args a =
      args_of(hq, hkv, 0, 0, d, window_left, window_right, scale, softcap, 0, 0, slopes);
  a.cu_q = cu_q;
  a.cu_k = cu_k;
  a.total_q = total_q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MFA_CALL(T, D)                                                                    \
  fb90::launch_packed_dkv<T, D>(q, k, v, dO, lse, delta, dk, dv, batch, total_k, max_sk, a, \
                                st)
#define MFA_CALL32(D)                                                                   \
  bf32::launch<D, bf32::DKV, true>(q, k, v, dO, lse, delta, nullptr, dk, dv, batch, max_sk, \
                                   a, st)
  MFA_BWD_DISPATCH(MFA_CALL, MFA_CALL32);
#undef MFA_CALL
#undef MFA_CALL32
}

// dq: [total_q, hq, d], every row of every sequence stored; max_sq bounds
// every sequence's q length.
extern "C" int mfa_varlen_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                                 const float* lse, const float* delta, void* dq,
                                 const int* cu_q, const int* cu_k, int dtype, int batch, int hq,
                                 int hkv, int total_q, int total_k, int max_sq, int d,
                                 int kd, int window_left, int window_right, float scale,
                                 float softcap, const float* slopes, void* stream) {
  if (batch == 0 || max_sq == 0 || total_q == 0) return 0;
  fb90::Args a =
      args_of(hq, hkv, 0, 0, d, window_left, window_right, scale, softcap, 0, 0, slopes);
  a.cu_q = cu_q;
  a.cu_k = cu_k;
  a.total_q = total_q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MFA_CALL(T, D) \
  fb90::launch_dq<T, D, true>(q, k, v, dO, lse, delta, dq, batch, total_k, max_sq, a, st)
#define MFA_CALL32(D)                                                                     \
  bf32::launch<D, bf32::DQ, true>(q, k, v, dO, lse, delta, static_cast<float*>(dq), nullptr, \
                                  nullptr, batch, max_sq, a, st)
  MFA_BWD_DISPATCH(MFA_CALL, MFA_CALL32);
#undef MFA_CALL
#undef MFA_CALL32
}

// The product of the fused kernel's dQ step alone, with both operands
// MN-major in shared memory (wgmma_ss_t): d [64, n] fp32 = a^T b[:, n0 :
// n0 + n] for bf16 a [64, 64] and b [64, 64] row-major (64 rows of the
// contraction), n 32 or 64, n0 0 or 32 (n0 + n <= 64). One warpgroup.
namespace {

__global__ void __launch_bounds__(128)
    wgmma_ss_t_check_kernel(const __nv_bfloat16* __restrict__ a,
                            const __nv_bfloat16* __restrict__ b, float* __restrict__ d, int n,
                            int n0) {
  __shared__ __align__(16) unsigned char raw[2 * 8192 + 1024];
  unsigned char* sm = raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
  const uint32_t sa = smem_u32(sm), sb = sa + 8192;
  const int tid = threadIdx.x;
  // 64 rows of 128 bytes each, 16-byte unit u of row r at unit u ^ (r % 8)
  for (int i = tid; i < 64 * 8; i += 128) {
    const int r = i / 8, u = i % 8;
    const int off = r * 128 + ((u ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(sm + off) = *reinterpret_cast<const uint4*>(a + r * 64 + u * 8);
    *reinterpret_cast<uint4*>(sm + 8192 + off) =
        *reinterpret_cast<const uint4*>(b + r * 64 + u * 8);
  }
  fence_async_smem();
  __syncthreads();
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3, wi = tid >> 5;
  float acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.f;
  wg_fence();
  if (n == 64) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_t<__nv_bfloat16, 64, 1, 1>(acc, sw128_desc(sa + kk * 2048, 64 * 128),
                                          sw128_desc(sb + n0 * 2 + kk * 2048, 64 * 128), 1);
  } else {
    float(&acc16)[16] = *reinterpret_cast<float(*)[16]>(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_t<__nv_bfloat16, 32, 1, 1>(acc16, sw128_desc(sa + kk * 2048, 64 * 128),
                                          sw128_desc(sb + n0 * 2 + kk * 2048, 64 * 128), 1);
  }
  wg_commit();
  wg_wait_all();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < n / 8) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[(wi * 16 + g + 8 * (e >> 1)) * n + 8 * j + 2 * t4 + (e & 1)] = acc[4 * j + e];
    }
  }
}

}  // namespace

extern "C" int mfa_wgmma_ss_t_check(const void* a, const void* b, float* d, int n, int n0,
                                    void* stream) {
  if (!((n == 32 && (n0 == 0 || n0 == 32)) || (n == 64 && n0 == 0))) return MFA_BAD_CONFIG;
  wgmma_ss_t_check_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), d, n, n0);
  return (int)cudaGetLastError();
}
