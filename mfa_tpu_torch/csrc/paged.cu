// Paged decode attention over a KV page pool, read in place (kernel 6).
//
// Replaces mfa_tpu/kernels/paged.py:_paged_kernel_body (paged_attention,
// also reached through decode.py:paged_decode_attention), multi-query spans
// included (q [b, q_span, hq, d], speculative verification).
// Pages are [hkv, num_pages, page_size, head_dim] in bf16/fp16, or int8,
// fp8 (e4m3) or int4 (head_dim / 2 bytes a row, feature pairs) with fp32
// per-row scales [hkv, num_pages, page_size]. The tile is kernel 5's
// (decode_sm90.cuh: a TMA ring of 64-token tiles, the products on mma.sync)
// with TMA boxes of gcd(page_size, 64) rows through the block table (pages
// of any row count); quantized rows convert exactly to bf16 in registers. pos_offset > 0 is the deferred-append query
// position (the query sits pos_offset past the stored length; reads stay
// bounded by it); span row si sits at stored length + pos_offset - q_span
// + si and sees the columns before it. q_span > 1 or more than 8 q heads a
// kv head take the template's M16 blocks (16 query rows each, a fourth grid
// axis of row blocks; each row block reads the pages again). Bound: bytes of
// the visible pages and their scales (int8 and fp8 rows d + 4 bytes, int4
// rows d / 2 + 4, bf16 rows 2 d).
//
// The TPU kernel walks a sequence's pages in order; here a grid that does
// not fill the 132 SMs splits each sequence's pages into whole 64-token
// tiles (num_splits, tokens_per_split from kernels/paged.py:split_plan).
// One split writes the final O and LSE; with more, each block writes its
// fp32 partial and the last block of each (sequence, kv head, row block)
// to finish merges them into O and the LSE, in the same launch.
//
// The TPU-only layout tricks (128-lane page padding, fp8-as-int8 bits, int4
// token-pair order) do not exist here: rows are d values wide, d the
// head-dim plan's stored width (dispatch/config.py:head_dim_plan: head_dim,
// widened only to make a row's bytes a multiple of 16), and int4 pairs a
// row's features, so tokens keep their natural order.
#include "decode_sm90.cuh"

// fp32 q (MFA_F32) runs the same template with T = float on fp32 pages
// (both products in 3xTF32) or on quantized pages (q . k in fp32 against
// the payload values, as three exact bf16 products of q's parts; p rounded
// to bf16 for P V, as mfa_tpu computes it), O in fp32.
//
// q [b, q_span, hq, d] (quantized pages take bf16 or fp32 q); kv_dtype:
// MFA_BF16 / MFA_F16 / MFA_F32 (the q dtype) or the format code MFA_I8,
// MFA_E4M3, MFA_I4. out [b, q_span, hq, d] in the q dtype and lse_out [b,
// q_span, hq] fp32 (or null); num_splits > 1 (at most kd90::MAX_SPLITS)
// also takes scratch o_part [b, hkv, num_splits, q_span * hq / hkv, d] and
// lse_part [b, hkv, num_splits, q_span * hq / hkv] fp32 (rows [q_span,
// group] flattened) and counters, b * hkv * row blocks int32 zeros (row
// blocks: 1, or one per 16 rows with spans and groups above 8), zero again
// when the launch ends; launches that share them run one at a time. d:
// features of q's and a stored page row (int4: 2 a byte), a multiple of 8
// (16-bit), 16 (int8, fp8) or 32 (int4) up to 256, run at the
// instantiated D kd. page_size any row count (boxes of gcd(page_size,
// 64) rows); every pointer 16-byte aligned.
// Returns a cudaError_t code.
extern "C" int mfa_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                const float* k_scale, const float* v_scale, const int* lens,
                                const int* table, void* out, float* lse_out, float* o_part,
                                float* lse_part, int* counters, int q_dtype, int kv_dtype,
                                int batch, int hq, int hkv, int num_pages, int page_size,
                                int pps, int d, int kd,
                                int q_span, int num_splits, int tokens_per_split, int pos_offset,
                                int window_left, float scale_log2e, float softcap,
                                float softcap_mul, int sinks, const float* slopes,
                                void* stream) {
  if (batch == 0) return 0;
  const int group = hkv > 0 ? hq / hkv : 0;
  if (group < 1 || q_span < 1 || num_pages < 1 || page_size <= 0 || num_splits < 1 ||
      num_splits > kd90::MAX_SPLITS || tokens_per_split % kd90::TILE != 0)
    return MFA_BAD_CONFIG;
  const bool m16 = q_span > 1 || group > 8;  // 16 query rows a block
  int box_rows = kd90::TILE;  // gcd(page_size, 64): a power of two, 1 to 64
  while (page_size % box_rows != 0) box_rows >>= 1;
  kd90::Args a = {};
  a.q = q;
  a.lens = lens;
  a.o_part = o_part;
  a.lse_part = lse_part;
  a.hq = hq;
  a.hkv = hkv;
  a.group = group;
  a.S = pps * page_size;
  a.tokens_per_split = tokens_per_split;
  a.num_splits = num_splits;
  a.window_left = window_left;
  a.scale_log2e = scale_log2e;
  a.softcap = softcap;
  a.softcap_mul = softcap_mul;
  a.table = table;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.out = out;
  a.lse_out = lse_out;
  a.counters = counters;
  a.num_pages = num_pages;
  a.page_size = page_size;
  a.pps = pps;
  a.box_rows = box_rows;
  a.pos_offset = pos_offset;
  a.q_span = q_span;
  a.sinks = sinks;
  a.slopes = slopes;
  a.dw = d;
  if (!mfa_dims_fit(d, kd)) return MFA_BAD_CONFIG;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFA_PAGED_D(T, F, M)                                                           \
  if (kd == 64) return kd90::launch<T, 64, true, F, M>(k_pages, v_pages, a, batch, s);   \
  if (kd == 128) return kd90::launch<T, 128, true, F, M>(k_pages, v_pages, a, batch, s); \
  if (kd == 256) return kd90::launch<T, 256, true, F, M>(k_pages, v_pages, a, batch, s); \
  return MFA_BAD_CONFIG
#define MFA_PAGED(T, F)          \
  if (m16) {                     \
    MFA_PAGED_D(T, F, true);     \
  }                              \
  MFA_PAGED_D(T, F, false)
  if (kv_dtype == MFA_I8 && q_dtype == MFA_BF16) { MFA_PAGED(__nv_bfloat16, KV::I8); }
  if (kv_dtype == MFA_E4M3 && q_dtype == MFA_BF16) { MFA_PAGED(__nv_bfloat16, KV::E4M3); }
  if (kv_dtype == MFA_I4 && q_dtype == MFA_BF16) { MFA_PAGED(__nv_bfloat16, KV::I4); }
  if (kv_dtype == MFA_BF16 && q_dtype == MFA_BF16) { MFA_PAGED(__nv_bfloat16, KV::F16); }
  if (kv_dtype == MFA_F16 && q_dtype == MFA_F16) { MFA_PAGED(__half, KV::F16); }
  if (q_dtype == MFA_F32) {
    if (kv_dtype == MFA_F32) { MFA_PAGED(float, KV::F16); }
    if (kv_dtype == MFA_I8) { MFA_PAGED(float, KV::I8); }
    if (kv_dtype == MFA_E4M3) { MFA_PAGED(float, KV::E4M3); }
    if (kv_dtype == MFA_I4) { MFA_PAGED(float, KV::I4); }
  }
#undef MFA_PAGED
#undef MFA_PAGED_D
  return MFA_BAD_CONFIG;
}

// A probe of the TMA's boxes of fewer than 8 rows (tests only, not a
// kernel of any path): rows [r0, r0 + rows) of a [*, row_bytes] byte
// matrix loaded into a 1024-byte-aligned tile as rows / box_rows boxes,
// box jb at byte jb * box_rows * row_bytes, in the swizzle of
// `swizzle_bytes` (0, 32, 64 or 128); the tile is then copied out as it
// lies in shared memory. A page of a row count off 8 comes as such boxes.
__global__ void tma_box_probe_kernel(const __grid_constant__ CUtensorMap t, unsigned char* out,
                                     int rows, int row_bytes, int r0, int box_rows) {
  __shared__ __align__(1024) unsigned char tile[64 * 128];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = smem_u32(&bar);
  if (threadIdx.x == 0) {
    mbar_init(b, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(b, rows * row_bytes);
    for (int jb = 0; jb < rows / box_rows; ++jb)
      tma_load_3d(smem_u32(tile) + jb * box_rows * row_bytes, &t, b, 0, r0 + jb * box_rows, 0);
  }
  mbar_wait(b, 0);
  for (int i = threadIdx.x; i < rows * row_bytes; i += blockDim.x) out[i] = tile[i];
}

// src: [total_rows, row_bytes] bytes; out: [rows, row_bytes]. rows a
// multiple of box_rows, rows * row_bytes <= 8192, and box_rows * row_bytes
// a multiple of 128: the TMA writes only 128-byte-aligned shared memory
// (a box of 64 bytes at a 64-byte offset faults with a misaligned
// address). Returns a cudaError_t code, MFA_TMA_ENCODE, or MFA_BAD_CONFIG.
extern "C" int mfa_tma_box_probe(const void* src, void* out, int total_rows, int rows,
                                 int row_bytes, int r0, int box_rows, int swizzle_bytes,
                                 void* stream) {
  if (rows <= 0 || box_rows <= 0 || rows % box_rows != 0 || rows * row_bytes > 64 * 128 ||
      r0 + rows > total_rows || box_rows * row_bytes % 128 != 0)
    return MFA_BAD_CONFIG;
  const CUtensorMapSwizzle sw = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                : swizzle_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                      : CU_TENSOR_MAP_SWIZZLE_NONE;
  const cuuint64_t dims[3] = {(cuuint64_t)row_bytes, (cuuint64_t)total_rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)total_rows * row_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)row_bytes, (cuuint32_t)box_rows, 1};
  CUtensorMap t;
  if (int err = mfa_encode(&t, src, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, dims, strides, box, sw))
    return err;
  tma_box_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<unsigned char*>(out), rows, row_bytes, r0, box_rows);
  return (int)cudaGetLastError();
}
