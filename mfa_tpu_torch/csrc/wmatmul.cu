// w8a16 matmul for Hopper (sm_90a): out[m, N] = (x[m, K] @ qw[K, N]) * scale[N],
// x bf16 or fp16, qw int8 (per-output-channel symmetric weights,
// mfa_tpu_torch/models/wquant.py), scale fp32, fp32 accumulation, the
// scale applied to the accumulator and the result rounded once
// (mfa_tpu/kernels/wmatmul.py:49).
//
// Replaces mfa_tpu/kernels/wmatmul.py:_kernel (int8_matmul). In JAX that
// kernel is a baseline beside XLA's fused convert; eager PyTorch fuses
// nothing, so on the card this kernel is the int8 weight path of every
// projection and the lm_head.
//
// Bound: at decode (m = 16) the weight stream, K * N bytes of int8 against
// 2 m K N operations, far below the card's ~295 operations a byte; at a
// prefill wave (m in the thousands) tensor-core operations. Design: one
// block owns a BM x 128 output tile and walks K in steps of 64: BM = 16
// when m <= 16 (4 warps of 16 x 32: a decode batch wastes no mma rows),
// 64 below m = 256 (4 warps) and 128 above (8 warps, converting each W
// tile once for twice the rows).
// Each step stages the x tile [BM x 64] with 16-byte loads, row-major, and
// the int8 W tile [64 k x 128 n] with 16-byte loads, converted to the
// compute dtype (exact for |q| <= 127: int8 -> fp32 by a byte permute onto
// 2^23, then a packed round) while it is written n-major (W^T [128 n][64
// k]): mma.sync.m16n8k16's B operand wants two consecutive k values of one
// column in a 32-bit register, as the flash tile's V^T. Each thread takes
// two consecutive k rows of one 16-column chunk, so it stores k pairs as
// 32-bit words and consecutive threads hit consecutive words. Both tiles
// are double-buffered: while a step computes from one buffer, the threads
// write the next step's tiles (loaded into registers a step earlier) into
// the other, so one barrier a step separates them (no cp.async/TMA yet). A
// warp computes a 32 x 64 (BM 64, 128) or 16 x 32 (BM 16) sub-tile, its
// fragments read with ldmatrix. When the output tiles cannot fill the card
// (decode: N / 128 blocks, 8 for a 4096 -> 1024 projection) the wrapper
// splits K over gridDim.z: each split writes fp32 partial sums to a
// workspace [splits, m, N] and a second launch adds them, applies the
// scale and rounds.
//
// Any m; K and N multiples of 16 (the wrapper checks), so every 16-byte
// vector of x and W lies wholly inside or outside the matrix.
#include "flash_fwd.cuh"  // mma16816, pack2

namespace {

constexpr int WM_BN = 128;   // output columns per block
constexpr int WM_BK = 64;    // K per step
constexpr int WM_S = WM_BK + 8;  // row stride (elements) of both tiles: conflict-free fragments

// Threads of a block with BM output rows: 4 warps, or 2 per 32 rows.
__host__ __device__ constexpr int wm_threads(int bm) { return bm == 16 ? 128 : 2 * bm; }

// Dynamic shared memory of a block: two buffers of the x tile [BM][WM_S]
// and the W^T tile [WM_BN][WM_S].
template <typename T>
constexpr size_t wm_smem_bytes(int bm) {
  return 2 * sizeof(T) * (size_t)(bm + WM_BN) * WM_S;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(__half* p, float v) { *p = __float2half_rn(v); }

// Four 8x8 16-bit matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8, and receives (row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1) of each, an mma fragment register.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// Signed byte e of w as a float: the byte, offset by 128, becomes the low
// mantissa of 2^23.
__device__ __forceinline__ float i8_at(uint32_t w, int e) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 + e)) -
         8388736.f;
}

// partial == null: out = acc * scale; else partial[split] = acc (fp32).
template <typename T, typename OutT, int BM>
__global__ void __launch_bounds__(wm_threads(BM))
    wmatmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
                   const float* __restrict__ scale, OutT* __restrict__ out,
                   float* __restrict__ partial, int M, int K, int N, int k_steps_per_split) {
  constexpr int WM_THREADS = wm_threads(BM);
  constexpr int MT = BM == 16 ? 1 : 2;   // 16-row mma tiles of a warp
  constexpr int NT = BM == 16 ? 4 : 8;   // 8-column mma tiles of a warp
  constexpr int XV = BM * (WM_BK / 8) / WM_THREADS;      // x vectors a thread a step
  constexpr int WP = WM_BK / 2 * (WM_BN / 16) / WM_THREADS;  // W row pairs a thread a step
  extern __shared__ __align__(16) unsigned char wm_smem_raw[];
  T* const smem = reinterpret_cast<T*>(wm_smem_raw);
  constexpr int BUF = (BM + WM_BN) * WM_S;  // elements: x tile (row-major), then W^T (n-major)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * WM_BN, m0 = blockIdx.y * BM, split = blockIdx.z;
  const int wm = BM == 16 ? 0 : (warp >> 1) * 32;     // this warp's rows
  const int wn = BM == 16 ? warp * 32 : (warp & 1) * 64;  // and columns
  const int k_steps = (K + WM_BK - 1) / WM_BK;
  const int kt0 = split * k_steps_per_split;
  const int kt1 = min(k_steps, kt0 + k_steps_per_split);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  // One step's vectors in registers: x rows (8 values each), W row pairs
  // (2 x 16 int8 of rows 2 kp and 2 kp + 1 of a 16-column chunk); zeros
  // past m, K or N.
  uint4 xr[XV], wr[WP][2];
  auto load = [&](int kt) {
    const int k0 = kt * WM_BK;
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = tid + j * WM_THREADS, r = i >> 3, c = (i & 7) * 8;
      xr[j] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + c < K)
        xr[j] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c);
    }
#pragma unroll
    for (int j = 0; j < WP; ++j) {
      const int i = tid + j * WM_THREADS, kp = i % (WM_BK / 2), c = (i / (WM_BK / 2)) * 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + 2 * kp + h;
        wr[j][h] = make_uint4(0u, 0u, 0u, 0u);
        if (k < K && n0 + c < N)
          wr[j][h] = __ldg(reinterpret_cast<const uint4*>(qw + (size_t)k * N + n0 + c));
      }
    }
  };

  // Write the vectors in registers into buffer b, W converted and transposed.
  auto store = [&](int b) {
    T* xs = smem + b * BUF;
    T* wts = xs + BM * WM_S;
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int i = tid + j * WM_THREADS;
      *reinterpret_cast<uint4*>(xs + (i >> 3) * WM_S + (i & 7) * 8) = xr[j];
    }
#pragma unroll
    for (int j = 0; j < WP; ++j) {
      const int i = tid + j * WM_THREADS, kp = i % (WM_BK / 2), c = (i / (WM_BK / 2)) * 16;
      const uint32_t* a = reinterpret_cast<const uint32_t*>(&wr[j][0]);
      const uint32_t* b2 = reinterpret_cast<const uint32_t*>(&wr[j][1]);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        *reinterpret_cast<uint32_t*>(wts + (c + e) * WM_S + 2 * kp) =
            pack2<T>(i8_at(a[e >> 2], e & 3), i8_at(b2[e >> 2], e & 3));
    }
  };

  // Fragments by ldmatrix: A's four 8 x 8 pieces are (rows 0-7 | 8-15) x
  // (k 0-7 | 8-15) of the x tile; B's are two n tiles x (k 0-7 | 8-15) of
  // W^T, whose rows are n (so no transpose).
  const int lr = lane & 7, lm = lane >> 3;
  auto compute = [&](int b) {
    const T* xs = smem + b * BUF;
    const T* wts = xs + BM * WM_S;
#pragma unroll
    for (int kc = 0; kc < WM_BK / 16; ++kc) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], xs + (wm + mt * 16 + (lm & 1) * 8 + lr) * WM_S + kc * 16 + (lm >> 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, wts + (wn + (nt + (lm >> 1)) * 8 + lr) * WM_S + kc * 16 + (lm & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816<T>(acc[mt][nt], af[mt], bf);
          mma16816<T>(acc[mt][nt + 1], af[mt], bf + 2);
        }
      }
    }
  };

  // Step kt computes from buffer (kt - kt0) & 1 while the threads fill the
  // other with step kt + 1, read by no warp since the last barrier.
  if (kt0 < kt1) {
    load(kt0);
    store(0);
  }
  __syncthreads();
  if (kt0 + 1 < kt1) load(kt0 + 1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int cur = (kt - kt0) & 1;
    compute(cur);
    if (kt + 1 < kt1) {
      store(cur ^ 1);
      if (kt + 2 < kt1) load(kt + 2);
    }
    __syncthreads();
  }

  // Epilogue: accumulator element e of an mma tile is row g (+8 for e >= 2),
  // column 2 t4 + (e & 1).
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + wn + nt * 8 + t4 * 2;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mt * 16 + g + 8 * h;
        if (row >= M) continue;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (partial != nullptr) {
          *reinterpret_cast<float2*>(partial + ((size_t)split * M + row) * N + n) =
              make_float2(v0, v1);
        } else {
          OutT* o = out + (size_t)row * N + n;
          put(o, v0 * scale[n]);
          put(o + 1, v1 * scale[n + 1]);
        }
      }
    }
  }
}

// out = (sum over splits of partial) * scale, rounded once.
template <typename OutT>
__global__ void wmatmul_reduce_kernel(const float* __restrict__ partial,
                                      const float* __restrict__ scale, OutT* __restrict__ out,
                                      int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * total + i];
    put(out + i, acc * scale[i % N]);
  }
}

template <typename T, typename OutT>
int launch(const void* x, const int8_t* qw, const float* scale, void* out, float* partial,
           int M, int K, int N, int splits, int k_steps_per_split, cudaStream_t stream) {
  const int bm = M <= 16 ? 16 : M < 256 ? 64 : 128;  // kernels/wmatmul.py:block_m
  dim3 grid((N + WM_BN - 1) / WM_BN, (M + bm - 1) / bm, splits);
  auto kern = bm == 16   ? wmatmul_kernel<T, OutT, 16>
              : bm == 64 ? wmatmul_kernel<T, OutT, 64>
                         : wmatmul_kernel<T, OutT, 128>;
  const size_t smem = wm_smem_bytes<T>(bm);
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem))
    return err;
  kern<<<grid, wm_threads(bm), smem, stream>>>(static_cast<const T*>(x), qw, scale,
                                            static_cast<OutT*>(out),
                                            splits > 1 ? partial : nullptr, M, K, N,
                                            k_steps_per_split);
  if (int err = (int)cudaGetLastError()) return err;
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    const size_t want = (total + 255) / 256;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    wmatmul_reduce_kernel<OutT><<<blocks, 256, 0, stream>>>(partial, scale,
                                                           static_cast<OutT*>(out), M, N, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K] (dtype: MFA_BF16 or MFA_F16), qw [K, N] int8, scale [N] fp32,
// out [M, N] in x's dtype (out_f32 = 0) or fp32 (out_f32 = 1). splits > 1
// needs partial: fp32 [splits, M, N]; split s covers K steps of 64
// [s * k_steps_per_split, (s + 1) * k_steps_per_split). Returns a
// cudaError_t code (0 = launched).
extern "C" int mfa_int8_matmul(const void* x, const int8_t* qw, const float* scale, void* out,
                               float* partial, int dtype, int out_f32, int M, int K, int N,
                               int splits, int k_steps_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || N == 0) return 0;
  if (K % 16 || N % 16 || splits < 1 || (splits > 1 && partial == nullptr))
    return MFA_BAD_CONFIG;
#define MFA_WMM(T, OutT) \
  return launch<T, OutT>(x, qw, scale, out, partial, M, K, N, splits, k_steps_per_split, s)
  if (dtype == MFA_BF16 && !out_f32) MFA_WMM(__nv_bfloat16, __nv_bfloat16);
  if (dtype == MFA_BF16 && out_f32) MFA_WMM(__nv_bfloat16, float);
  if (dtype == MFA_F16 && !out_f32) MFA_WMM(__half, __half);
  if (dtype == MFA_F16 && out_f32) MFA_WMM(__half, float);
#undef MFA_WMM
  return MFA_BAD_CONFIG;
}
