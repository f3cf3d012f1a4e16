// Flash-attention prefill forward for Hopper (sm_90a): O and natural-log LSE.
//
// Replaces the Pallas kernels of mfa_tpu/kernels/prefill.py:
// _prefill_body (via _prefill_flat_kernel / _prefill_bht_kernel), the
// zero-shift _flagged_* engine and its _repair_kernel. This kernel is the
// classic online-softmax forward, exact by construction, so it computes
// the function of all three without a poison flag or a repair pass.
//
// Layout: q [b, hq, sq, D], k/v [b, hkv, sk, D], o like q, lse [b, hq, sq]
// fp32. GQA by head index (kv head = h / (hq / hkv)). Causal is top-left
// aligned and expressed as window_right = 0; window (left, right) counts
// from each row's own position.
//
// Bound: at the serving shapes (d = 128) the work is tensor-core
// operations (4 * sq * sk * d per head, halved by causality), so the design
// keeps both products on mma.sync.m16n8k16 with fp32 accumulation: one
// block of 4 warps owns 64 query rows (16 per warp, Q fragments held in
// registers for the whole KV loop), K and V tiles of 64 rows are staged in
// shared memory (V transposed, so the P.V operand reads are conflict-free
// 32-bit words), the S fragment is reused as the A operand of P.V without
// a round trip through shared memory, and tiles outside the causal/window
// band are never loaded. No cp.async/TMA pipelining yet: loads and math do
// not overlap (later work: wgmma + TMA).
//
// Numerics (the repository guide's "Softmax-kernel numerics rules"): the running
// max m is kept in the raw score domain and every exponent is formed
// subtract-first, exp2((s - m) * c); a row that saw no visible column keeps
// m == MASK and stores O = 0 and LSE = -inf.
#include "common.cuh"

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // key/value rows per tile
constexpr int NTHREADS = 128; // 4 warps x 16 query rows

template <typename T>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], const uint32_t b[2]);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float c[4], const uint32_t a[4],
                                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float c[4], const uint32_t a[4],
                                                  const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T, int D>
__device__ __forceinline__ uint32_t load_q_pair(const T* qp, int row, int col, int sq) {
  if (row >= sq) return 0u;
  return *reinterpret_cast<const uint32_t*>(qp + (size_t)row * D + col);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    prefill_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                       float scale_log2e, float softcap, float softcap_mul,
                       int wl, int wr) {
  constexpr int KS = D + 8;   // K tile row stride (elements): conflict-free
  constexpr int VS = BN + 8;  // V^T tile row stride (elements)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [BN][KS]
  T* vts = ks + BN * KS;                   // [D][VS], vts[d][j] = V[j][d]

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qb * BM;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int r1 = r0 + 8;

  const T* qp = q + (size_t)(b * hq + h) * sq * D;
  const T* kp = k + (size_t)(b * hkv + hk) * sk * D;
  const T* vp = v + (size_t)(b * hkv + hk) * sk * D;

  // Q as mma A fragments, resident for the whole KV loop.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + t4 * 2;
    qf[kc][0] = load_q_pair<T, D>(qp, r0, c, sq);
    qf[kc][1] = load_q_pair<T, D>(qp, r1, c, sq);
    qf[kc][2] = load_q_pair<T, D>(qp, r0, c + 8, sq);
    qf[kc][3] = load_q_pair<T, D>(qp, r1, c + 8, sq);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = MFA_MASK, m1 = MFA_MASK;  // running max, raw score domain
  float l0 = 0.f, l1 = 0.f;            // this thread's partial row sums

  // Live KV tiles of this q block's band (dead causal/window tiles skipped).
  const int n_tiles = (sk + BN - 1) / BN;
  int last = n_tiles - 1;
  if (wr >= 0) last = min(last, (q0 + BM - 1 + wr) / BN);
  int first = 0;
  if (wl >= 0) first = max(0, (q0 - wl) / BN);

  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int jt = first; jt <= last; ++jt) {
    const int kv0 = jt * BN;
    __syncthreads();  // every warp is done with the previous tile
    // K tile: coalesced 16-byte loads, row-major in shared memory.
    for (int i = tid; i < BN * VPR; i += NTHREADS) {
      const int r = i / VPR, c = i % VPR;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (kv0 + r < sk) val = *reinterpret_cast<const uint4*>(kp + (size_t)(kv0 + r) * D + c * 8);
      *reinterpret_cast<uint4*>(ks + r * KS + c * 8) = val;
    }
    // V tile, transposed: consecutive threads take consecutive rows so the
    // 2-byte transposed stores hit consecutive addresses.
    for (int i = tid; i < BN * VPR; i += NTHREADS) {
      const int r = i % BN, c = i / BN;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (kv0 + r < sk) val = *reinterpret_cast<const uint4*>(vp + (size_t)(kv0 + r) * D + c * 8);
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int x = 0; x < 8; ++x) vts[(c * 8 + x) * VS + r] = e[x];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BN columns.
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const T* kr = ks + (nt * 8 + g) * KS + kc * 16 + t4 * 2;
        uint32_t bfr[2];
        bfr[0] = *reinterpret_cast<const uint32_t*>(kr);
        bfr[1] = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma16816<T>(s[nt], qf[kc], bfr);
      }
    }

    if (softcap > 0.f) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = tanhf(s[nt][e] * softcap_mul) * softcap;
    }
    // Mask only tiles that cross the sequence tail or the band's edge.
    const bool needs_mask = (kv0 + BN > sk) || (wr >= 0 && kv0 + BN - 1 > q0 + wr) ||
                            (wl >= 0 && kv0 < q0 + BM - 1 - wl);
    if (needs_mask) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + nt * 8 + t4 * 2 + (e & 1);
          const int row = (e < 2) ? r0 : r1;
          bool ok = col < sk;
          if (wr >= 0) ok = ok && (col <= row + wr);
          if (wl >= 0) ok = ok && (col >= row - wl);
          if (!ok) s[nt][e] = MFA_MASK;
        }
      }
    }

    // Online softmax: rows are spread over the 4 threads of a quad.
    float mx0 = MFA_MASK, mx1 = MFA_MASK;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f((m0 - mn0) * scale_log2e);
    const float alpha1 = exp2f((m1 - mn1) * scale_log2e);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = exp2f((s[nt][0] - mn0) * scale_log2e);
      s[nt][1] = exp2f((s[nt][1] - mn0) * scale_log2e);
      s[nt][2] = exp2f((s[nt][2] - mn1) * scale_log2e);
      s[nt][3] = exp2f((s[nt][3] - mn1) * scale_log2e);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    l0 = alpha0 * l0 + ps0;
    l1 = alpha1 * l1 + ps1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // O += P V: the S accumulator layout is the A fragment layout of the
    // next product (two 8-column tiles make one 16-deep chunk).
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack2<T>(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack2<T>(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack2<T>(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack2<T>(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const T* vr = vts + (dt * 8 + g) * VS + kc * 16 + t4 * 2;
        uint32_t bfr[2];
        bfr[0] = *reinterpret_cast<const uint32_t*>(vr);
        bfr[1] = *reinterpret_cast<const uint32_t*>(vr + 8);
        mma16816<T>(acc[dt], a, bfr);
      }
    }
  }

  // Epilogue: full row sums, dead-row guard, store O and LSE.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const bool dead0 = m0 <= MFA_MASK * 0.5f, dead1 = m1 <= MFA_MASK * 0.5f;
  const bool bad0 = dead0 || l0 == 0.f || isnan(l0);
  const bool bad1 = dead1 || l1 == 0.f || isnan(l1);
  const float inv0 = dead0 ? 0.f : 1.f / (bad0 ? 1.f : l0);
  const float inv1 = dead1 ? 0.f : 1.f / (bad1 ? 1.f : l1);
  T* op = o + (size_t)(b * hq + h) * sq * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(op + (size_t)r0 * D + c) =
          pack2<T>(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(op + (size_t)r1 * D + c) =
          pack2<T>(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  if (lse != nullptr && t4 == 0) {
    float* lp = lse + (size_t)(b * hq + h) * sq;
    const float c = scale_log2e * MFA_LN2;
    if (r0 < sq) lp[r0] = (dead0 || l0 == 0.f) ? -INFINITY : m0 * c + logf(bad0 ? 1.f : l0);
    if (r1 < sq) lp[r1] = (dead1 || l1 == 0.f) ? -INFINITY : m1 * c + logf(bad1 ? 1.f : l1);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
           int hq, int hkv, int sq, int sk, int wl, int wr, float scale_log2e, float softcap,
           float softcap_mul, cudaStream_t stream) {
  const size_t smem = (size_t)(BN * (D + 8) + D * (BN + 8)) * sizeof(T);
  auto kern = prefill_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BM - 1) / BM, hq, batch);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, hq, hkv, sq, sk, scale_log2e, softcap, softcap_mul, wl, wr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o, float* lse,
             int batch, int hq, int hkv, int sq, int sk, int wl, int wr, float scale_log2e,
             float softcap, float softcap_mul, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, batch, hq, hkv, sq, sk, wl, wr, scale_log2e,
                           softcap, softcap_mul, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, batch, hq, hkv, sq, sk, wl, wr, scale_log2e,
                            softcap, softcap_mul, stream);
    default:
      return MFA_BAD_CONFIG;
  }
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
  if (dtype == MFA_BF16)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, lse, batch, hq, hkv, sq, sk, window_left,
                                   window_right, scale_log2e, softcap, softcap_mul, s);
  if (dtype == MFA_F16)
    return launch_d<__half>(d, q, k, v, o, lse, batch, hq, hkv, sq, sk, window_left,
                            window_right, scale_log2e, softcap, softcap_mul, s);
  return MFA_BAD_CONFIG;
}
