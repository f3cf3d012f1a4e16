// The zero-shift prefill engines for Hopper (sm_90a): the JAX package's
// default prefill path. Three launches of the wgmma + TMA tile of
// flash_fwd_sm90.cuh (kernel 1's tile, grid and band: 128 q rows a block,
// two consumer warpgroups of 64), each tile's flags and risky bits kept per
// 64-row tile, int32 [b, hq, ceil(sq / 64)]:
//
// mfa_flagged_fwd (kernel 2) replaces mfa_tpu/kernels/prefill.py:
// _flagged_flat_kernel and _flagged_bht_kernel (_bound_body with
// flag_ref): the zero-shift softmax, then one flag per consumer warpgroup,
// the OR of its rows' poison checks, which read values already in
// registers (the row sums and the O values being stored).
//
// mfa_repair_fwd (kernel 3) replaces _repair_kernel (_repair_poisoned): a
// block reads its two flags and leaves when both are 0; otherwise its
// flagged warpgroups rerun kernel 1's classic tile over their full band,
// overwriting their O rows and LSE in place (a warpgroup with flag 0 keeps
// the load ring in step and stores nothing), so a repaired tile equals
// kernel 1's bit for bit. It is launched after every flagged launch, so
// the flags never go to the host. The TPU kernel scans the flags in one
// grid step because a TPU grid is static; here the blocks with nothing to
// do simply leave.
//
// mfa_bound_fwd (kernel 4) replaces _bound_flat_kernel and
// _bound_bht_kernel: a warpgroup whose risky bit
// (mfa_tpu_torch/kernels/prefill.py:_risky_bits, the q/k norm bound of
// _bound_risky, computed with torch ops per 64-row tile) is set runs the
// classic softmax for its whole KV loop, every other one the zero-shift
// softmax, both on the same ring. With no bits ("unchecked") the classic
// branch is not compiled in.
//
// Bound: as kernel 1 (tensor-core operations past a few hundred keys, the
// load of q/k/v/o at the 8B wave's short prompts); the zero-shift softmax
// drops the row max, its quad shuffles and the rescale of O from the inner
// loop, which on this tile run beside the other warpgroup's products. bf16
// only: in fp16 an unshifted p leaves the type's range (ROADMAP Queue 3),
// and the wrapper sends fp16 to kernel 1. fp32 (MFA_F32) runs the same three
// launches on the tensor-core fp32 tile of flash_fwd_f32.cuh (3xTF32, 64
// rows a block, one flag tile each; p = exp2(s c) stays fp32 for P V). Layout as mfa_prefill_fwd:
// q [b, hq, sq, D], k/v [b, hkv, sk, D], o like q, lse [b, hq, sq] fp32 or
// null.
#include "flash_fwd_f32.cuh"

namespace {

using BF = __nv_bfloat16;

// d: the rows' width (a.dw), run at the instantiated D kd; the flagged
// engine and its repair have no D 64 and run kd 64 at D 128 (mfa_tpu
// selects them at head_dim % 128 == 0).
template <int KIND>
int launch_kind(int dtype, int d, int kd, const void* q, const void* k, const void* v, void* o,
                float* lse, int* table, int batch, fa90::Args a, cudaStream_t s) {
  a.dw = d;
  if (!mfa_dims_fit(d, kd)) return MFA_BAD_CONFIG;
  if (dtype == MFA_F32) {
    if (kd == 64) return af32::launch_fwd<64, KIND>(q, k, v, o, lse, table, batch, a.sq, a, s);
    if (kd == 128) return af32::launch_fwd<128, KIND>(q, k, v, o, lse, table, batch, a.sq, a, s);
    return af32::launch_fwd<256, KIND>(q, k, v, o, lse, table, batch, a.sq, a, s);
  }
  if (dtype != MFA_BF16) return MFA_BAD_CONFIG;
  if constexpr (KIND == fa90::BOUND || KIND == fa90::UNCHECKED) {
    if (kd == 64) return fa90::launch<BF, 64, KIND>(q, k, v, o, lse, table, batch, a, s);
  }
  if (kd == 64 || kd == 128)
    return fa90::launch<BF, 128, KIND>(q, k, v, o, lse, table, batch, a, s);
  if (kd == 256) return fa90::launch<BF, 256, KIND>(q, k, v, o, lse, table, batch, a, s);
  return MFA_BAD_CONFIG;
}

}  // namespace

// The three launches share one C signature. table: the flags (int32
// [batch, hq, ceil(sq / 64)]; written by mfa_flagged_fwd, where null means
// none is computed, and read by mfa_repair_fwd) or the risky bits (read by
// mfa_bound_fwd; null = "unchecked"). lse may be null. dtype: bf16 or fp32.
// The flagged engine and its repair take head_dim 128 and 256 (JAX sends
// head_dim % 128 != 0 to the bound engine), the bound engine 64, 128 and
// 256. Each returns a cudaError_t code (0 = launched).
#define MFA_ZS_PREAMBLE                                                        \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                          \
  if (batch == 0 || sq == 0) return 0;                                         \
  fa90::Args a{hq, hkv, sq, sk, window_left, window_right, scale_log2e, 0.f, 0.f}; \
  a.sinks = sinks;                                                             \
  a.kv_off = kv_off;
#define MFA_ZS_ARGS                                                                       \
  const void *q, const void *k, const void *v, void *o, float *lse, int *table, int dtype, \
      int batch, int hq, int hkv, int sq, int sk, int d, int kd, int window_left,       \
      int window_right, float scale_log2e, int sinks, int kv_off, void *stream

extern "C" int mfa_flagged_fwd(MFA_ZS_ARGS) {
  MFA_ZS_PREAMBLE
  return launch_kind<fa90::FLAGGED>(dtype, d, kd, q, k, v, o, lse, table, batch, a, s);
}

extern "C" int mfa_repair_fwd(MFA_ZS_ARGS) {
  MFA_ZS_PREAMBLE
  return launch_kind<fa90::REPAIR>(dtype, d, kd, q, k, v, o, lse, table, batch, a, s);
}

extern "C" int mfa_bound_fwd(MFA_ZS_ARGS) {
  MFA_ZS_PREAMBLE
  return table != nullptr
             ? launch_kind<fa90::BOUND>(dtype, d, kd, q, k, v, o, lse, table, batch, a, s)
             : launch_kind<fa90::UNCHECKED>(dtype, d, kd, q, k, v, o, lse, table, batch, a, s);
}
