// Paged prefill: query chunks against a paged KV cache, read in place.
//
// Replaces mfa_tpu/kernels/paged_prefill.py:_body (paged_prefill_attention):
// chunked prefill, prefix-cache suffixes and the paged route of the varlen
// entry point. Query row r of sequence b sits at absolute position
// q_start[b] + r and sees columns c with
//     c <  lens[b]                      (cache bound, chunk included)
//     c <= q_start[b] + r + wr          (band end; causal is wr == 0)
//     c >= q_start[b] + r - wl          (sliding window)
// (wl/wr = -1: unbounded). Rows r >= q_lens[b] store O = 0, LSE = -inf.
//
// One block per (q tile, kv head, sequence) holds the whole GQA group's
// rows, the TPU kernel's [group, bq] row layout: block row i is q head
// hk * group + i / bq at chunk row tile * bq + i % bq, so each K/V tile it
// stages serves every q head that reads it. The tile loop visits the band
// [row_lo, row_hi) of the block's rows only (_row_lo/_row_hi of the TPU
// kernel) and resolves each token's page through the block table: no dense
// copy of the prefix is made. Pages are [hkv, P, page, D] in bf16/fp16, or
// int8 with fp32 per-row scales [hkv, P, page] (payload -> bf16 exactly,
// K scales on score columns, V scales folded into the probabilities).
// Bound: tensor-core operations at chunk sizes (4 * rows * visible
// columns * D); the math is flash_fwd.cuh's mma.sync tile.
#include "flash_fwd.cuh"

namespace {

struct PagedPrefillParams {
  const void* q;        // [b, sq, hq, D]
  const void* k_pages;  // [hkv, P, page, D]
  const void* v_pages;
  const float* k_scale;  // [hkv, P, page] or null
  const float* v_scale;
  const int* lens;     // [b] visible KV length
  const int* q_start;  // [b] absolute position of q row 0
  const int* q_lens;   // [b] real q rows
  const int* table;    // [b, pps]
  void* out;           // [b, sq, hq, D]
  float* lse;          // [b, hq, sq] or null
  int sq, hq, hkv, group, bq, num_pages, page_size, pps, wl, wr;
  float scale_log2e, softcap, softcap_mul;
};

template <typename T, typename TKV, int D>
__global__ void __launch_bounds__(FA_THREADS) paged_prefill_kernel(PagedPrefillParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bq = p.bq;
  const int q_start = p.q_start[b];
  const int q_len = min(p.q_lens[b], p.sq);
  const int sk = min(p.lens[b], p.pps * p.page_size);
  const int t0 = qt * bq;  // first chunk row of this tile

  PagedKV<TKV, D> src;
  const size_t head_rows = (size_t)hk * p.num_pages * p.page_size;
  src.k = static_cast<const TKV*>(p.k_pages) + head_rows * D;
  src.v = static_cast<const TKV*>(p.v_pages) + head_rows * D;
  src.k_scale = p.k_scale == nullptr ? nullptr : p.k_scale + head_rows;
  src.v_scale = p.v_scale == nullptr ? nullptr : p.v_scale + head_rows;
  src.table = p.table + (size_t)b * p.pps;
  src.num_pages = p.num_pages;
  src.page_size = p.page_size;
  src.sk = sk;

  const T* q = static_cast<const T*>(p.q);
  T* o = static_cast<T*>(p.out);
  TileRows<T> rows;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int i = warp * 16 + (lane >> 2) + 8 * x;  // block row
    const int h = hk * p.group + i / bq, r = t0 + i % bq;
    const bool in = r < p.sq;
    const size_t off = (((size_t)b * p.sq + r) * p.hq + h) * D;
    rows.q[x] = in ? q + off : nullptr;
    rows.o[x] = in ? o + off : nullptr;
    rows.lse[x] = (in && p.lse != nullptr) ? p.lse + ((size_t)b * p.hq + h) * p.sq + r : nullptr;
    rows.pos[x] = q_start + r;
    rows.live[x] = r < q_len;
  }

  TileBand band;
  band.wl = p.wl;
  band.wr = p.wr;
  band.pos_lo = q_start + t0;
  band.pos_hi = q_start + t0 + bq - 1;
  band.all_live = t0 + bq <= q_len;
  // [row_lo, row_hi): the columns any live row of the tile can see
  int row_hi = sk;
  if (p.wr >= 0) row_hi = min(row_hi, q_start + t0 + bq + p.wr);
  const int row_lo = p.wl >= 0 ? max(0, q_start + t0 - p.wl) : 0;
  band.first = row_lo / FA_BN;
  band.last = (t0 < q_len && row_hi > row_lo) ? (row_hi - 1) / FA_BN : -1;
  flash_fwd_tile<T, D>(src, rows, band, p.scale_log2e, p.softcap, p.softcap_mul, smem_raw);
}

template <typename T, typename TKV, int D>
int launch(const PagedPrefillParams& p, int batch, cudaStream_t stream) {
  const size_t smem = FlashSmem<T, D>::bytes(sizeof(TKV) == 1);
  auto kern = paged_prefill_kernel<T, TKV, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.sq + p.bq - 1) / p.bq, p.hkv, batch);
  kern<<<grid, FA_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q_dtype: the q/out dtype (int8 pages take bf16 q); kv_dtype: the pages'.
// group = hq / hkv must divide 64 (the block's 64 rows hold 64 / group
// chunk rows of every q head of one kv head). Returns a cudaError_t code.
extern "C" int mfa_paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                                 const float* k_scale, const float* v_scale, const int* lens,
                                 const int* q_start, const int* q_lens, const int* table,
                                 void* out, float* lse, int q_dtype, int kv_dtype, int batch,
                                 int sq, int hq, int hkv, int num_pages, int page_size,
                                 int pps, int d, int window_left, int window_right,
                                 float scale_log2e, float softcap, float softcap_mul,
                                 void* stream) {
  if (batch == 0 || sq == 0) return 0;
  const int group = hq / hkv;
  if (group <= 0 || FA_BM % group != 0) return MFA_BAD_CONFIG;
  PagedPrefillParams p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.k_scale = k_scale;
  p.v_scale = v_scale;
  p.lens = lens;
  p.q_start = q_start;
  p.q_lens = q_lens;
  p.table = table;
  p.out = out;
  p.lse = lse;
  p.sq = sq;
  p.hq = hq;
  p.hkv = hkv;
  p.group = group;
  p.bq = FA_BM / group;
  p.num_pages = num_pages;
  p.page_size = page_size;
  p.pps = pps;
  p.wl = window_left;
  p.wr = window_right;
  p.scale_log2e = scale_log2e;
  p.softcap = softcap;
  p.softcap_mul = softcap_mul;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MFA_PP(T, TKV)                                                   \
  if (d == 64) return launch<T, TKV, 64>(p, batch, s);                   \
  if (d == 128) return launch<T, TKV, 128>(p, batch, s);                 \
  return MFA_BAD_CONFIG
  if (kv_dtype == MFA_I8 && q_dtype == MFA_BF16) { MFA_PP(__nv_bfloat16, int8_t); }
  if (kv_dtype == MFA_BF16 && q_dtype == MFA_BF16) { MFA_PP(__nv_bfloat16, __nv_bfloat16); }
  if (kv_dtype == MFA_F16 && q_dtype == MFA_F16) { MFA_PP(__half, __half); }
#undef MFA_PP
  return MFA_BAD_CONFIG;
}
