// Flash prefill under the Gemma3 multimodal mask for Hopper (sm_90a):
//
//     visible(row, col) = (causal AND window)(row, col) OR same_image_run(row, col)
//
// Replaces mfa_tpu/kernels/blockmask.py:_kernel (image_block_prefill). The
// TPU kernel runs a static 4-D grid and scalar-prefetches, per (batch, q
// block), the first and last KV block that any row of the block can see,
// skipping the steps outside them. Here the launch is kernel 1's wgmma +
// TMA tile (flash_fwd_sm90.cuh, kind IMAGE): at the block's start one warp
// finds, in the ids, the KV tile range each consumer warpgroup's 64 rows
// can see (the band widened by the image runs of its first and last row;
// kernels/blockmask.py:kv_tile_bounds states the same ranges), the block
// loads the union of the two ranges, and in the tiles that cross the band's
// edge a column is visible when the band lets it through or when it
// carries the row's own image-run id (text rows and padding carry -1 and
// never match). Finding the ranges in the kernel spares the torch ops
// that computed them per call (0.08-0.09 ms of device time on an H100,
// scripts/time_paged_blockmask.py). Every row sees itself, so no row is dead and no LSE is
// returned. With every id at -1 the code path, tiles and order are kernel
// 1's, and so are the bits.
//
// Bound: like kernel 1, tensor-core operations over the visible (row,
// column) pairs (the causal triangle plus the bidirectional part of each
// image run); the run ids add 4 bytes a token. Every tile that the run
// extension adds lies above the diagonal or left of the window, so the
// tile's needs_mask test already masks it element by element; tiles inside
// the band need no mask, since there the OR changes nothing.
//
// Layout: q [b, hq, s, D], k/v [b, hkv, s, D] (sq == sk), ids [b, s] int32,
// o like q. GQA by head index. fp32 (MFA_F32) runs kind IMAGE of the
// tensor-core fp32 tile of flash_fwd_f32.cuh (3xTF32): the same spans, found by the same helpers.
#include "flash_fwd_f32.cuh"

// ids [batch, s] int32 on the device. Returns a cudaError_t code (0 =
// launched).
extern "C" int mfa_image_block_fwd(const void* q, const void* k, const void* v, void* o,
                                   const int* ids, int dtype, int batch, int hq, int hkv, int s,
                                   int d, int kd, int window_left, float scale_log2e,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch == 0 || s == 0) return 0;
  fa90::Args a{hq, hkv, s, s, window_left, 0, scale_log2e, 0.f, 0.f};
  a.ids = ids;
  a.dw = d;
  if (!mfa_dims_fit(d, kd)) return MFA_BAD_CONFIG;
#define MFA_IMAGE_BLOCK(T, D) \
  return fa90::launch<T, D, fa90::IMAGE>(q, k, v, o, nullptr, nullptr, batch, a, st)
  if (dtype == MFA_BF16 && kd == 64) MFA_IMAGE_BLOCK(__nv_bfloat16, 64);
  if (dtype == MFA_BF16 && kd == 128) MFA_IMAGE_BLOCK(__nv_bfloat16, 128);
  if (dtype == MFA_BF16 && kd == 256) MFA_IMAGE_BLOCK(__nv_bfloat16, 256);
  if (dtype == MFA_F16 && kd == 64) MFA_IMAGE_BLOCK(__half, 64);
  if (dtype == MFA_F16 && kd == 128) MFA_IMAGE_BLOCK(__half, 128);
  if (dtype == MFA_F16 && kd == 256) MFA_IMAGE_BLOCK(__half, 256);
#undef MFA_IMAGE_BLOCK
#define MFA_IMAGE_BLOCK32(D) \
  return af32::launch_fwd<D, fa90::IMAGE>(q, k, v, o, nullptr, nullptr, batch, s, a, st)
  if (dtype == MFA_F32 && kd == 64) MFA_IMAGE_BLOCK32(64);
  if (dtype == MFA_F32 && kd == 128) MFA_IMAGE_BLOCK32(128);
  if (dtype == MFA_F32 && kd == 256) MFA_IMAGE_BLOCK32(256);
#undef MFA_IMAGE_BLOCK32
  return MFA_BAD_CONFIG;
}
