// The zero-shift prefill engines for Hopper (sm_90a): the JAX package's
// default prefill path. Three launches on the forward tile of
// flash_fwd.cuh, all on kernel 1's grid (q tile of 64, q head, batch) and
// band:
//
// mfa_flagged_fwd replaces mfa_tpu/kernels/prefill.py:_flagged_flat_kernel
// and _flagged_bht_kernel (_bound_body with flag_ref): the tile under the
// ZeroShiftSoftmax policy, then one int32 flag per block,
// flags[b, h, q tile], the block-wide OR (__syncthreads_or) of its rows'
// poison checks, which read values already in registers (the row sums and
// the O values being stored).
//
// mfa_repair_fwd replaces _repair_kernel (_repair_poisoned): one block per
// (q tile, head, batch) reads its flag, returns when it is 0, and otherwise
// runs the classic tile over its full band, overwriting its O rows and LSE
// in place. It is launched after every flagged launch, so the flags never
// go to the host. The TPU kernel scans the flags in one grid step because
// a TPU grid is static; here the blocks with nothing to do simply leave.
//
// mfa_bound_fwd replaces _bound_flat_kernel and _bound_bht_kernel: a block
// whose risky bit (mfa_tpu_torch/kernels/prefill.py:_risky_bits, the q/k
// norm bound of _bound_risky, computed with torch ops per 64-row tile) is
// set runs the classic tile for its whole KV loop, every other block the
// zero-shift tile. With no bits ("unchecked") the classic branch is not
// compiled in.
//
// Bound: as kernel 1 (tensor-core operations at long sequences, the load of
// q/k/v at short ones); the zero-shift tile drops the row max, its quad
// shuffles and the rescale of O from the inner loop. bf16 only: in fp16 an
// unshifted p leaves the type's range (ROADMAP Queue 3), and the wrapper
// sends fp16 to kernel 1. Layout as mfa_prefill_fwd: q [b, hq, sq, D],
// k/v [b, hkv, sk, D], o like q, lse [b, hq, sq] fp32 or null.
#include "flash_fwd.cuh"

namespace {

struct Args {
  int hq, hkv, sq, sk, wl, wr;
  float scale_log2e;
};

// This block's K/V source and rows.
template <typename T, int D>
struct BlockIO {
  DenseKV<T> src;
  TileRows<T> rows;
  TileBand band;
  size_t tile;  // index of this block's flag / risky bit: (b * hq + h) * n_qt + qb
};

template <typename T, int D>
__device__ __forceinline__ BlockIO<T, D> block_io(const T* q, const T* k, const T* v, T* o,
                                                  float* lse, const Args& a) {
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const size_t qo = (size_t)(b * a.hq + h) * a.sq;
  const size_t ko = (size_t)(b * a.hkv + hk) * a.sk * D;
  return BlockIO<T, D>{DenseKV<T>{k + ko, v + ko, D, a.sk},
                       rows_of<T>(q + qo * D, o + qo * D, lse == nullptr ? nullptr : lse + qo,
                                  D, qb * FA_BM, a.sq),
                       band_of(qb * FA_BM, a.sk, a.wl, a.wr),
                       (size_t)(b * a.hq + h) * gridDim.x + qb};
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
    flagged_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       int* __restrict__ flags, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BlockIO<T, D> io = block_io<T, D>(q, k, v, o, lse, a);
  const bool poison = flash_fwd_tile<T, D, DenseKV<T>, BandOnly, ZeroShiftSoftmax>(
      io.src, io.rows, io.band, a.scale_log2e, 0.f, 0.f, smem_raw);
  if (flags != nullptr) {  // null: "flag_presence" (no flag computed)
    const int any = __syncthreads_or(poison);
    if (threadIdx.x == 0) flags[io.tile] = any;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
    repair_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                      const int* __restrict__ flags, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t tile = (size_t)(blockIdx.z * a.hq + blockIdx.y) * gridDim.x + blockIdx.x;
  if (flags[tile] == 0) return;  // the whole block leaves: nothing poisoned
  const BlockIO<T, D> io = block_io<T, D>(q, k, v, o, lse, a);
  flash_fwd_tile<T, D>(io.src, io.rows, io.band, a.scale_log2e, 0.f, 0.f, smem_raw);
}

template <typename T, int D, bool CHECKED>
__global__ void __launch_bounds__(FA_THREADS)
    bound_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ risky, Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const BlockIO<T, D> io = block_io<T, D>(q, k, v, o, lse, a);
  if constexpr (CHECKED) {
    if (risky[io.tile] != 0) {  // uniform over the block
      flash_fwd_tile<T, D>(io.src, io.rows, io.band, a.scale_log2e, 0.f, 0.f, smem_raw);
      return;
    }
  }
  flash_fwd_tile<T, D, DenseKV<T>, BandOnly, ZeroShiftSoftmax>(io.src, io.rows, io.band,
                                                               a.scale_log2e, 0.f, 0.f,
                                                               smem_raw);
}

template <typename Kern>
int launch(Kern kern, size_t smem, int batch, const void* q, const void* k, const void* v,
           void* o, float* lse, int* table, const Args& a, cudaStream_t stream) {
  using T = __nv_bfloat16;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem))
    return err;
  dim3 grid((a.sq + FA_BM - 1) / FA_BM, a.hq, batch);
  kern<<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, table, a);
  return (int)cudaGetLastError();
}

using BF = __nv_bfloat16;

}  // namespace

// The three launches share one C signature. table: the flags (int32
// [batch, hq, ceil(sq / 64)]; written by mfa_flagged_fwd, where null means
// none is computed, and read by mfa_repair_fwd) or the risky bits (read by
// mfa_bound_fwd; null = "unchecked"). lse may be null. dtype must be bf16.
// The flagged engine and its repair take head_dim 128 and 256 (JAX sends
// head_dim % 128 != 0 to the bound engine), the bound engine 64, 128 and
// 256. Each returns a cudaError_t code (0 = launched).
#define MFA_ZS_PREAMBLE                                                        \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                          \
  if (batch == 0 || sq == 0) return 0;                                         \
  if (dtype != MFA_BF16) return MFA_BAD_CONFIG;                                \
  const Args a{hq, hkv, sq, sk, window_left, window_right, scale_log2e};
#define MFA_ZS_ARGS                                                                       \
  const void *q, const void *k, const void *v, void *o, float *lse, int *table, int dtype, \
      int batch, int hq, int hkv, int sq, int sk, int d, int window_left, int window_right, \
      float scale_log2e, void *stream

extern "C" int mfa_flagged_fwd(MFA_ZS_ARGS) {
  MFA_ZS_PREAMBLE
  if (d == 128)
    return launch(flagged_fwd_kernel<BF, 128>, FlashSmem<BF, 128>::bytes(false), batch, q, k,
                  v, o, lse, table, a, s);
  if (d == 256)
    return launch(flagged_fwd_kernel<BF, 256>, FlashSmem<BF, 256>::bytes(false), batch, q, k,
                  v, o, lse, table, a, s);
  return MFA_BAD_CONFIG;
}

extern "C" int mfa_repair_fwd(MFA_ZS_ARGS) {
  MFA_ZS_PREAMBLE
  if (d == 128)
    return launch(repair_fwd_kernel<BF, 128>, FlashSmem<BF, 128>::bytes(false), batch, q, k,
                  v, o, lse, table, a, s);
  if (d == 256)
    return launch(repair_fwd_kernel<BF, 256>, FlashSmem<BF, 256>::bytes(false), batch, q, k,
                  v, o, lse, table, a, s);
  return MFA_BAD_CONFIG;
}

extern "C" int mfa_bound_fwd(MFA_ZS_ARGS) {
  MFA_ZS_PREAMBLE
#define MFA_BOUND(D)                                                                         \
  if (d == D)                                                                                \
    return table != nullptr                                                                  \
               ? launch(bound_fwd_kernel<BF, D, true>, FlashSmem<BF, D>::bytes(false), batch, \
                        q, k, v, o, lse, table, a, s)                                        \
               : launch(bound_fwd_kernel<BF, D, false>, FlashSmem<BF, D>::bytes(false),      \
                        batch, q, k, v, o, lse, table, a, s);
  MFA_BOUND(64)
  MFA_BOUND(128)
  MFA_BOUND(256)
#undef MFA_BOUND
  return MFA_BAD_CONFIG;
}
