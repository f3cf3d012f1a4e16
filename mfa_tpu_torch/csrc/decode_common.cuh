// Single-query (seqlen_q == 1) attention over a paged KV cache: the tile of
// the paged decode (paged.cu). The contiguous split-KV decode runs its own
// tile (decode_sm90.cuh).
//
// One block of 128 threads owns one (batch, kv head): all `group` q
// heads of the kv head ride together, so each K/V row is read from device
// memory once per step (the GQA trick of mfa_tpu/kernels/decode.py). The
// block walks its token range in tiles of 64 rows staged in shared memory:
// scores (one thread per token, q in shared memory as fp32), an online
// softmax per q row (one warp per row), then P.V (one thread per feature).
// Bound: device-memory bytes (K + V read once); the math is CUDA-core fp32,
// about 4 FMAs per cache byte. No copy/compute overlap yet.
//
// Semantics follow mfa_tpu/kernels/paged.py:_paged_kernel_body: scores are
// scaled into the log2 domain before the max; int8 K scales multiply score
// columns after the contraction and V scales fold into the probabilities;
// the probabilities are rounded to the value dtype (bf16 for int8 pages)
// before P.V, as the TPU kernels do; a row with no visible column stores
// O = 0 and LSE = -inf. The LSE is the natural log, m * ln2 + log(l).
#pragma once

#include "common.cuh"

struct DecodeParams {
  const void* q;            // [b, hq, D]
  const void* k;            // pages [hkv, P, page, D]
  const void* v;
  const float* k_scale;     // int8 pages: [hkv, P, page] fp32, else null
  const float* v_scale;
  const int* lens;          // [b] stored lengths
  const int* table;         // [b, pps] physical page ids
  void* out;                // [b, hq, D] in the q dtype
  float* lse_out;           // [b, hq] or null
  int hq, hkv, group;
  int num_pages, page_size, pps;
  int pos_offset, window_left;
  float scale_log2e, softcap, softcap_mul;
};

constexpr int DEC_THREADS = 128;
constexpr int DEC_TILE = 64;

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Shared-memory plan of one instantiation (byte offsets, 16-byte aligned).
template <typename TKV, int D, int GM>
struct DecodeSmem {
  static constexpr int KPAD = 4 / (int)sizeof(TKV);  // odd word stride per K row
  static constexpr int KSTR = D + KPAD;
  static constexpr int TSPLIT = D < DEC_THREADS ? DEC_THREADS / D : 1;
  static constexpr size_t q_off = 0;                                   // float [GM][D]
  static constexpr size_t sc_off = align16(q_off + sizeof(float) * GM * D);    // float [GM][TILE]
  static constexpr size_t st_off = align16(sc_off + sizeof(float) * GM * DEC_TILE);  // m,l,alpha
  static constexpr size_t scale_off = align16(st_off + sizeof(float) * 3 * GM);      // ks, vs
  static constexpr size_t k_off = align16(scale_off + sizeof(float) * 2 * DEC_TILE);
  static constexpr size_t v_off = align16(k_off + sizeof(TKV) * DEC_TILE * KSTR);
  static constexpr size_t red_off = align16(v_off + sizeof(TKV) * DEC_TILE * D);
  static constexpr size_t bytes =
      red_off + (TSPLIT > 1 ? sizeof(float) * TSPLIT * GM * D : 0);
};

__device__ __forceinline__ size_t kv_row(const DecodeParams& p, int b, int hk, int tok) {
  int page = p.table[(size_t)b * p.pps + tok / p.page_size];
  page = min(max(page, 0), p.num_pages - 1);
  return ((size_t)hk * p.num_pages + page) * p.page_size + tok % p.page_size;
}

// TQ: q/out dtype. TKV: cache dtype. TV: dtype the probabilities are
// rounded to before P.V. GM: q rows per block rounded up to a power of two.
template <typename TQ, typename TKV, typename TV, int D, int GM>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(DecodeParams p) {
  using SM = DecodeSmem<TKV, D, GM>;
  constexpr int KSTR = SM::KSTR;
  constexpr int TSPLIT = SM::TSPLIT;
  constexpr int DPT = D > DEC_THREADS ? D / DEC_THREADS : 1;
  constexpr bool QUANT = sizeof(TKV) == 1;
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + SM::q_off);
  float* sc = reinterpret_cast<float*>(smem + SM::sc_off);
  float* m_run = reinterpret_cast<float*>(smem + SM::st_off);
  float* l_run = m_run + GM;
  float* alpha_s = l_run + GM;
  float* ksc = reinterpret_cast<float*>(smem + SM::scale_off);
  float* vsc = ksc + DEC_TILE;
  TKV* kt = reinterpret_cast<TKV*>(smem + SM::k_off);
  TKV* vt = reinterpret_cast<TKV*>(smem + SM::v_off);

  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.group;

  const int length = p.lens[b];
  int start = 0;
  if (p.window_left >= 0) start = max(0, length + p.pos_offset - 1 - p.window_left);
  const int lo = start;
  const int hi = min(length, p.pps * p.page_size);

  const TQ* qp = static_cast<const TQ*>(p.q) + ((size_t)b * p.hq + (size_t)hk * G) * D;
  for (int i = tid; i < GM * D; i += DEC_THREADS)
    qs[i] = (i < G * D) ? to_float(qp[i]) : 0.f;
  if (tid < GM) {
    m_run[tid] = MFA_MASK;
    l_run[tid] = 0.f;
    alpha_s[tid] = 1.f;
  }
  float acc[GM][DPT];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[g][j] = 0.f;
  __syncthreads();

  constexpr int VEC = 16 / (int)sizeof(TKV);  // elements per 16-byte vector
  constexpr int VPR = D / VEC;
  const TKV* kbase = static_cast<const TKV*>(p.k);
  const TKV* vbase = static_cast<const TKV*>(p.v);

  for (int t0 = lo; t0 < hi; t0 += DEC_TILE) {
    const int nt = min(DEC_TILE, hi - t0);
    // Stage K/V rows (zero past the range: a NaN there would survive p = 0).
    for (int i = tid; i < DEC_TILE * VPR; i += DEC_THREADS) {
      const int r = i / VPR, c = i % VPR;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (r < nt) {
        const size_t off = kv_row(p, b, hk, t0 + r) * D + (size_t)c * VEC;
        kv4 = *reinterpret_cast<const uint4*>(kbase + off);
        vv4 = *reinterpret_cast<const uint4*>(vbase + off);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(kt + r * KSTR + c * VEC);
      kd[0] = kv4.x;
      kd[1] = kv4.y;
      kd[2] = kv4.z;
      kd[3] = kv4.w;
      *reinterpret_cast<uint4*>(vt + r * D + c * VEC) = vv4;
    }
    if (QUANT) {
      for (int i = tid; i < DEC_TILE; i += DEC_THREADS) {
        float a = 0.f, bb = 0.f;
        if (i < nt) {
          const size_t row = kv_row(p, b, hk, t0 + i);
          a = p.k_scale[row];
          bb = p.v_scale[row];
        }
        ksc[i] = a;
        vsc[i] = bb;
      }
    }
    __syncthreads();

    // Scores: thread (tok, half) computes rows g == half (mod 2).
    {
      const int tok = tid % DEC_TILE, half = tid / DEC_TILE;
      constexpr int RPT = GM > 1 ? GM / 2 : 1;
      float s[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) s[j] = 0.f;
      if (GM > 1 || half == 0) {
        const TKV* kr = kt + tok * KSTR;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          const float kv = to_float(kr[d]);
#pragma unroll
          for (int j = 0; j < RPT; ++j) s[j] += qs[(half + 2 * j) * D + d] * kv;
        }
        const float kscale = QUANT ? ksc[tok] : 1.f;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          float x = s[j] * kscale;
          if (p.softcap > 0.f) x = tanhf(x * p.softcap_mul) * p.softcap;
          x *= p.scale_log2e;
          sc[(half + 2 * j) * DEC_TILE + tok] = tok < nt ? x : MFA_MASK;
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp per q row (log2 domain).
    for (int g = warp; g < G; g += DEC_THREADS / 32) {
      const float v0 = sc[g * DEC_TILE + lane], v1 = sc[g * DEC_TILE + lane + 32];
      const float m_prev = m_run[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(v0, v1)));
      const float alpha = exp2f(m_prev - m_new);
      float p0 = exp2f(v0 - m_new), p1 = exp2f(v1 - m_new);
      const float sum = warp_sum(p0 + p1);
      __syncwarp();
      if (lane == 0) {
        m_run[g] = m_new;
        l_run[g] = alpha * l_run[g] + sum;
        alpha_s[g] = alpha;
      }
      if (QUANT) {
        p0 *= vsc[lane];
        p1 *= vsc[lane + 32];
      }
      sc[g * DEC_TILE + lane] = to_float(from_float<TV>(p0));
      sc[g * DEC_TILE + lane + 32] = to_float(from_float<TV>(p1));
    }
    __syncthreads();

    // O = alpha * O + P V: thread owns feature d (and a token phase when
    // D < 128 threads).
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = DPT > 1 ? tid + j * DEC_THREADS : tid % D;
      const int phase = TSPLIT > 1 ? tid / D : 0;
#pragma unroll
      for (int g = 0; g < GM; ++g) acc[g][j] *= alpha_s[g];
      for (int t = phase; t < nt; t += TSPLIT) {
        const float vv = to_float(vt[t * D + d]);
#pragma unroll
        for (int g = 0; g < GM; ++g) acc[g][j] += sc[g * DEC_TILE + t] * vv;
      }
    }
    __syncthreads();
  }

  if (TSPLIT > 1) {
    float* red = reinterpret_cast<float*>(smem + SM::red_off);
    const int d = tid % D, phase = tid / D;
#pragma unroll
    for (int g = 0; g < GM; ++g) red[(phase * GM + g) * D + d] = acc[g][0];
    __syncthreads();
    if (phase == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float x = 0.f;
        for (int ph = 0; ph < TSPLIT; ++ph) x += red[(ph * GM + g) * D + d];
        acc[g][0] = x;
      }
    }
  }
  if (TSPLIT > 1 && tid >= D) return;

#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = DPT > 1 ? tid + j * DEC_THREADS : tid % D;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      const float l = l_run[g], m = m_run[g];
      const bool empty = l == 0.f;
      const float ls = (empty || isnan(l)) ? 1.f : l;
      const float o = acc[g][j] / ls;
      const float lse = empty ? -INFINITY : m * MFA_LN2 + logf(ls);
      const size_t row = (size_t)b * p.hq + (size_t)hk * G + g;
      static_cast<TQ*>(p.out)[row * D + d] = from_float<TQ>(o);
      if (d == 0 && p.lse_out != nullptr) p.lse_out[row] = lse;
    }
  }
}

template <typename TQ, typename TKV, typename TV, int D, int GM>
int launch_decode(const DecodeParams& p, int batch, cudaStream_t stream) {
  using SM = DecodeSmem<TKV, D, GM>;
  auto kern = decode_kernel<TQ, TKV, TV, D, GM>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SM::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(1, p.hkv, batch);
  kern<<<grid, DEC_THREADS, SM::bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// Dispatch on head_dim (64, 128, 256) and the q rows per block (rounded up
// to 1/2/4/8). At D = 256 each thread owns two features (DPT = 2) and the
// K/V tiles take ~66 KB of shared memory for 16-bit pages (~33 KB for int8),
// past the 48 KB default: launch_decode opts in.
template <typename TQ, typename TKV, typename TV>
int launch_decode_dg(const DecodeParams& p, int d, int batch, cudaStream_t stream) {
  const int g = p.group;
#define MFA_DEC_G(D)                                                                   \
  if (g <= 1) return launch_decode<TQ, TKV, TV, D, 1>(p, batch, stream); \
  if (g <= 2) return launch_decode<TQ, TKV, TV, D, 2>(p, batch, stream); \
  if (g <= 4) return launch_decode<TQ, TKV, TV, D, 4>(p, batch, stream); \
  if (g <= 8) return launch_decode<TQ, TKV, TV, D, 8>(p, batch, stream); \
  return MFA_BAD_CONFIG;
  if (d == 64) { MFA_DEC_G(64) }
  if (d == 128) { MFA_DEC_G(128) }
  if (d == 256) { MFA_DEC_G(256) }
#undef MFA_DEC_G
  return MFA_BAD_CONFIG;
}
