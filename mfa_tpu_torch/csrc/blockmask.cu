// Flash prefill under the Gemma3 multimodal mask for Hopper (sm_90a):
//
//     visible(row, col) = (causal AND window)(row, col) OR same_image_run(row, col)
//
// Replaces mfa_tpu/kernels/blockmask.py:_kernel (image_block_prefill). The
// TPU kernel runs a static 4-D grid and scalar-prefetches, per (batch, q
// block), the first and last KV block that any row of the block can see,
// skipping the steps outside them. Here the grid is (q tile of 64, q head,
// batch) and each block reads its own KV tile range [kv_first, kv_last]
// from two [batch, n_qtiles] int32 tensors that the wrapper computes with
// torch ops (kernels/blockmask.py:kv_tile_bounds), then runs the forward
// tile of flash_fwd.cuh with the SameRun visibility policy: a column is
// visible when the band lets it through or when it carries the row's own
// image-run id (text rows and padding carry -1 and never match). Every row
// sees itself, so no row is dead and no LSE is returned.
//
// Bound: like kernel 1, tensor-core operations over the visible (row,
// column) pairs (the causal triangle plus the bidirectional part of each
// image run); the run ids add 4 bytes a token. The tile's needs_mask test
// masks, element by element, every tile that the run extension adds (they
// lie above the diagonal or left of the window), and tiles inside the band
// need no mask, since there the OR changes nothing.
//
// Layout: q [b, hq, s, D], k/v [b, hkv, s, D] (sq == sk), ids [b, s] int32,
// o like q. GQA by head index.
#include "flash_fwd.cuh"

namespace {

// Same-image-run visibility: the tile's column ids are staged in shared
// memory from col_ids; row x of this thread carries row_id[x].
struct SameRun {
  static constexpr bool ENABLED = true;
  const int* col_ids;  // this sequence's run ids [s]
  int row_id[2];
  __device__ __forceinline__ bool extra(int x, int id) const {
    return row_id[x] >= 0 && row_id[x] == id;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
    image_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       const int* __restrict__ ids, const int* __restrict__ kv_first,
                       const int* __restrict__ kv_last, int hq, int hkv, int s, int n_qt,
                       float scale_log2e, int wl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qb * FA_BM;
  const size_t qo = (size_t)(b * hq + h) * s * D;
  const size_t ko = (size_t)(b * hkv + hk) * s * D;
  DenseKV<T> src{k + ko, v + ko, D, s};
  const TileRows<T> rows = rows_of<T>(q + qo, o + qo, nullptr, D, q0, s);
  SameRun vis;
  vis.col_ids = ids + (size_t)b * s;
#pragma unroll
  for (int x = 0; x < 2; ++x) vis.row_id[x] = rows.pos[x] < s ? vis.col_ids[rows.pos[x]] : -1;
  TileBand band = band_of(q0, s, wl, 0);
  band.first = kv_first[(size_t)b * n_qt + qb];
  band.last = kv_last[(size_t)b * n_qt + qb];
  flash_fwd_tile<T, D>(src, rows, band, scale_log2e, 0.f, 0.f, smem_raw, vis);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const int* ids,
           const int* kv_first, const int* kv_last, int batch, int hq, int hkv, int s, int wl,
           float scale_log2e, cudaStream_t stream) {
  const size_t smem = FlashSmem<T, D>::bytes(false, true);
  auto kern = image_block_kernel<T, D>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem))
    return err;
  const int n_qt = (s + FA_BM - 1) / FA_BM;
  dim3 grid(n_qt, hq, batch);
  kern<<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), ids, kv_first, kv_last, hq, hkv, s, n_qt, scale_log2e, wl);
  return (int)cudaGetLastError();
}

}  // namespace

// ids [batch, s]; kv_first/kv_last [batch, ceil(s / 64)] int32 on the
// device. Returns a cudaError_t code (0 = launched).
extern "C" int mfa_image_block_fwd(const void* q, const void* k, const void* v, void* o,
                                   const int* ids, const int* kv_first, const int* kv_last,
                                   int dtype, int batch, int hq, int hkv, int s, int d,
                                   int window_left, float scale_log2e, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || s == 0) return 0;
#define MFA_IMAGE_BLOCK(T, D) \
  return launch<T, D>(q, k, v, o, ids, kv_first, kv_last, batch, hq, hkv, s, window_left, \
                      scale_log2e, st)
  if (dtype == MFA_BF16 && d == 64) MFA_IMAGE_BLOCK(__nv_bfloat16, 64);
  if (dtype == MFA_BF16 && d == 128) MFA_IMAGE_BLOCK(__nv_bfloat16, 128);
  if (dtype == MFA_BF16 && d == 256) MFA_IMAGE_BLOCK(__nv_bfloat16, 256);
  if (dtype == MFA_F16 && d == 64) MFA_IMAGE_BLOCK(__half, 64);
  if (dtype == MFA_F16 && d == 128) MFA_IMAGE_BLOCK(__half, 128);
  if (dtype == MFA_F16 && d == 256) MFA_IMAGE_BLOCK(__half, 256);
#undef MFA_IMAGE_BLOCK
  return MFA_BAD_CONFIG;
}
