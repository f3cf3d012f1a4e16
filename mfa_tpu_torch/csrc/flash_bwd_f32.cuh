// The fp32 backward tile for Hopper (sm_90a): fp32 q, k, v, O and dO, one
// SIMT block body (bwd_kernel below) behind every backward launch of the
// port when its inputs are fp32:
//  - kernel 11 (MODE FUSED, mfa_bwd_fused): a block owns BN keys of one kv
//    head and walks the q tiles that see them, for every q head of the
//    group; dK and dV stay in registers, dQ is added into the fp32
//    workspace [b, hq, sq, dw] a row at a time by bulk async reductions
//    (cp.reduce.async.bulk .add.f32, done in L2), so it varies in the last
//    bits between runs, as the bf16 kernel's does;
//  - kernel 12 (MODE DKV, mfa_bwd_dkv): the same block without its dQ step,
//    deterministic;
//  - kernel 13 (MODE DQ, mfa_bwd_dq): a block owns BM q rows of one q head
//    and walks the band's key tiles with dQ in registers, deterministic;
//  - kernel 14 (DKV and DQ on the packed layout, PACKED: mfa_varlen_bwd_dkv
//    and mfa_varlen_bwd_dq): offsets from cu_seqlens, a block whose tile
//    lies past its sequence leaves at once.
// They replace mfa_tpu/kernels/backward.py:_fused_bwd_kernel,
// _dkv_kernel / _dkv_tri_kernel, _dq_kernel / _dq_tri_kernel and
// _vl_dkv_kernel / _vl_dq_kernel on fp32 inputs, which the Pallas kernels
// take with fp32 products. All compute kernels/backward.py:_bwd_plain:
//
//   P  = exp2(S c2 - LSE log2 e)  with S = Q K^T (softcap: cap tanh(S scale / cap))
//   dV = P^T dO     dS = P (dO V^T - delta) scale (* (1 - tanh^2))
//   dK = dS^T Q     dQ = dS K
//
// with delta = rowsum(dO * O) from the caller (fp32), P = 0 on rows whose
// LSE is -inf (they saw no column) and on rows past sq, dK and dV summed
// over the GQA group. The band, sinks (FUSED only: the split refuses them,
// as mfa_tpu does), ALiBi (slopes in the log2 domain, subtracted from P's
// exponent as slope |position - key|), kv_position_offset (dense launches)
// and softcap are fb90::Args', and so is the band arithmetic: a key block
// walks fb90::q_tiles, a q block the key tiles of fa90::span_of.
//
// Why SIMT: wgmma and mma.sync take no fp32 operand, and one TF32 pass
// keeps about three decimal digits, short of the 1e-4 the fp32 gradients
// are held to. Each product here is an fp32 FFMA chain, as exact as the
// plain version's matmuls, in another order.
//
// Bound: operations, 10 hq D flops a visible (row, key) pair for the fused
// launch (8 dK/dV, 6 dQ), at the card's fp32-accurate rate (3xTF32: 495 /
// 3 TFLOP/s; 67 TFLOP/s of FFMA here). The design is the plain one, right
// first (speed is later work):
//  - 256 threads as 16 x 16. Of a [BM rows][BN keys] pair tile, thread (ty,
//    tx) computes S and dP for rows ty RPT + i and keys tx + 16 j (RPT = BM
//    / 16, CPT = BN / 16) from float4 reads of the Q, dO, K and V tiles
//    (rows padded to D + 4 floats: K's and V's reads free of bank
//    conflicts), forms P and dS in registers, and writes P, then dS, to
//    one shared [BM][BN + 4] buffer.
//  - dV += P^T dO and dK += dS^T Q are outer products over the tile's
//    rows: the thread owns keys ty KPT + kk (KPT = BN / 16) and columns 64
//    c + 4 tx .. + 3 of its block's dK and dV (registers to the end).
//  - dQ = dS K is the forward tile's O += P V: the thread owns rows ty RPT
//    + i and the same columns. FUSED: the partial goes into the Q tile's
//    shared memory once dK's reads of Q are done, and warp 0 adds it into
//    the workspace, one bulk reduction a row; the next tile's Q load waits
//    for those reads.
//  - Sizes by D (keys BN a tile, q rows BM = 64 a tile; Q, dO, K and V
//    tiles of D + 4 floats a row, the P / dS buffer, LSE and delta of BM
//    rows): D 64: BN 64, 87.6 KB; D 128: BN 32, 111.1 KB (two blocks an
//    SM at both, 128 registers a thread); D 256: BN 32, 209.4 KB (one
//    block an SM). The accumulators a thread keeps: dK + dV 2 KPT D / 16
//    floats (32 at D 64 and 128, 64 at D 256), or dQ RPT D / 16 (16 / 32 /
//    64).
//  - Masks are per element; rows past sq read as zeros with LSE +inf, keys
//    past sk as zeros (masked). Rows are dw features wide (a multiple of 4,
//    <= D): the columns past dw load as zeros, inert in every product, and
//    are never stored.
#pragma once

#include "flash_bwd_sm90.cuh"

namespace bf32 {

using fb90::Args;

constexpr int THREADS = 256;  // 16 x 16
constexpr int BM = 64;        // q rows a tile
enum Mode { FUSED = 0, DKV = 1, DQ = 2 };

template <int D>
struct Plan {
  static constexpr int BN = D >= 128 ? 32 : 64;  // keys a tile
  static constexpr int RPT = BM / 16;            // S rows a thread
  static constexpr int CPT = BN / 16;            // S keys a thread
  static constexpr int KPT = BN / 16;            // dK / dV key rows a thread
  static constexpr int OC = D / 64;              // float4 column chunks a thread
  static constexpr int QS = D + 4;               // Q, dO, K and V row stride (floats)
  static constexpr int PS = BN + 4;              // P / dS row stride
  static constexpr int q_off = 0;
  static constexpr int do_off = BM * QS;
  static constexpr int k_off = 2 * BM * QS;
  static constexpr int v_off = k_off + BN * QS;
  static constexpr int p_off = v_off + BN * QS;
  static constexpr int l2_off = p_off + BM * PS;  // log2 LSE [BM]
  static constexpr int dl_off = l2_off + BM;      // delta [BM]
  static constexpr size_t bytes = (size_t)(dl_off + BM) * 4;
  static_assert(D % 64 == 0 && BN % 16 == 0 && (KPT == 2 || KPT == 4), "tile shape");
  static_assert(bytes <= 232448, "a block's shared memory");
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// Rows [0, NR) of `src` (rows rs floats apart) into a tile of stride QS:
// zeros past `valid` rows and past dw columns.
template <int D, int NR>
__device__ __forceinline__ void load_tile(float* dst, const float* src, size_t rs, int valid,
                                          int dw) {
  constexpr int QS = Plan<D>::QS;
  for (int idx = threadIdx.x; idx < NR * (D / 4); idx += THREADS) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid && c < dw) x = __ldg(reinterpret_cast<const float4*>(src + r * rs + c));
    st4(dst + r * QS + c, x);
  }
}

// The BM rows' log2 LSE (+inf on a row that saw no column or past `valid`:
// its P is 0) and delta, from contiguous lse and delta.
__device__ __forceinline__ void load_rows(float* l2s, float* dls, const float* lse,
                                          const float* delta, int valid) {
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    float l2 = INFINITY, dl = 0.f;
    if (r < valid) {
      const float x = __ldg(lse + r);
      l2 = x == -INFINITY ? INFINITY : x * fb90::LOG2E;
      dl = __ldg(delta + r);
    }
    l2s[r] = l2;
    dls[r] = dl;
  }
}

// The pair tile of q rows (positions p0 + r) and keys kv0 + c in shared
// memory -> P and dS for the thread's rows ty RPT + i and keys tx + 16 j.
template <int D>
__device__ __forceinline__ void p_ds(const float* sm, const Args& a, int p0, int kv0, float sl,
                                     float (&p)[Plan<D>::RPT][Plan<D>::CPT],
                                     float (&ds)[Plan<D>::RPT][Plan<D>::CPT]) {
  using P = Plan<D>;
  constexpr int RPT = P::RPT, CPT = P::CPT, QS = P::QS;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) p[i][j] = ds[i][j] = 0.f;
  // S = Q K^T into p, dP = dO V^T into ds: two chains, so that one chain's
  // operands are live at a time; two k steps at once, one at 64 keys a tile
  // (there two spilled past the 128 registers of two blocks an SM)
  constexpr int UNROLL = CPT > 2 ? 1 : 2;
#pragma unroll UNROLL
  for (int kk = 0; kk < D; kk += 4) {
    float4 qa[RPT], kb[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) qa[i] = ld4(sm + P::q_off + (ty * RPT + i) * QS + kk);
#pragma unroll
    for (int j = 0; j < CPT; ++j) kb[j] = ld4(sm + P::k_off + (tx + 16 * j) * QS + kk);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float x = p[i][j];
        x = fmaf(qa[i].x, kb[j].x, x);
        x = fmaf(qa[i].y, kb[j].y, x);
        x = fmaf(qa[i].z, kb[j].z, x);
        x = fmaf(qa[i].w, kb[j].w, x);
        p[i][j] = x;
      }
  }
#pragma unroll UNROLL
  for (int kk = 0; kk < D; kk += 4) {
    float4 ga[RPT], vb[CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) ga[i] = ld4(sm + P::do_off + (ty * RPT + i) * QS + kk);
#pragma unroll
    for (int j = 0; j < CPT; ++j) vb[j] = ld4(sm + P::v_off + (tx + 16 * j) * QS + kk);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float x = ds[i][j];
        x = fmaf(ga[i].x, vb[j].x, x);
        x = fmaf(ga[i].y, vb[j].y, x);
        x = fmaf(ga[i].z, vb[j].z, x);
        x = fmaf(ga[i].w, vb[j].w, x);
        ds[i][j] = x;
      }
  }
  // P and dS in place, masked per element
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i, pos = p0 + r;
    const float l2 = sm[P::l2_off + r], dl = sm[P::dl_off + r];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int key = kv0 + tx + 16 * j;
      bool ok = key < a.sk;
      if (a.wr >= 0) ok = ok && key <= pos + a.wr;
      if (a.wl >= 0) ok = ok && (key >= pos - a.wl || key < a.sinks);
      float x = p[i][j], dcap = 1.f;
      if (a.softcap > 0.f) {
        const float t = tanhf(x * a.softcap_mul);
        x = t * a.softcap;
        dcap = 1.f - t * t;
      }
      float ex = x * a.c2 - l2;
      if (sl != 0.f) ex -= sl * fabsf((float)(pos - key));
      const float pr = ok ? exp2f(ex) : 0.f;
      p[i][j] = pr;
      ds[i][j] = pr * (ds[i][j] - dl) * a.scale * dcap;
    }
  }
}

// The thread's P or dS elements into the shared [BM][BN + 4] buffer.
template <int D>
__device__ __forceinline__ void put_tile(float* psm, const float (&x)[Plan<D>::RPT][Plan<D>::CPT]) {
  using P = Plan<D>;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < P::RPT; ++i)
#pragma unroll
    for (int j = 0; j < P::CPT; ++j) psm[(ty * P::RPT + i) * P::PS + tx + 16 * j] = x[i][j];
}

// acc[kk][c] += sum_r w[r][key kk] x[r][column c] over the tile's BM rows
// (dV += P^T dO, dK += dS^T Q): keys ty KPT + kk, columns 64 c + 4 tx.
template <int D>
__device__ __forceinline__ void outer_acc(float (&acc)[Plan<D>::KPT][Plan<D>::OC][4],
                                          const float* psm, const float* xs) {
  using P = Plan<D>;
  constexpr int KPT = P::KPT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int r = 0; r < BM; ++r) {
    float w[KPT];
    if constexpr (KPT == 4) {
      const float4 t = ld4(psm + r * P::PS + ty * 4);
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(psm + r * P::PS + ty * 2);
      w[0] = t.x, w[1] = t.y;
    }
#pragma unroll
    for (int c = 0; c < P::OC; ++c) {
      const float4 g = ld4(xs + r * P::QS + 64 * c + 4 * tx);
#pragma unroll
      for (int kk = 0; kk < KPT; ++kk) fma4(acc[kk][c], w[kk], g);
    }
  }
}

// acc[i][c] += sum_j dS[row i][j] K[j][column c] over the tile's BN keys:
// rows ty RPT + i, columns 64 c + 4 tx.
template <int D>
__device__ __forceinline__ void dq_acc(float (&acc)[Plan<D>::RPT][Plan<D>::OC][4],
                                       const float* psm, const float* ks) {
  using P = Plan<D>;
  constexpr int RPT = P::RPT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int j = 0; j < P::BN; j += 4) {
    float4 w[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) w[i] = ld4(psm + (ty * RPT + i) * P::PS + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int c = 0; c < P::OC; ++c) {
        const float4 kv = ld4(ks + (j + e) * P::QS + 64 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < RPT; ++i) fma4(acc[i][c], comp(w[i], e), kv);
      }
    }
  }
}

__device__ __forceinline__ float* smem_f32() {
  extern __shared__ __align__(16) float bf32_smem[];
  return bf32_smem;
}

// FUSED / DKV: grid (hkv, batch, ceil(sk / BN)), packed (hkv, sequence,
// ceil(max_sk / BN)); the key tile is the slowest axis, so the causal
// blocks with the most q tiles launch first. DQ: grid (hq, batch, ceil(sq
// / BM)), packed ceil(max_sq / BM), the q tile reversed (the causal blocks
// with the most key tiles first). dq: the zeroed fp32 workspace (FUSED) or
// the dQ output (DQ); dk, dv: the outputs (FUSED, DKV). Layouts as
// flash_bwd_sm90.cuh's, fp32, rows of dw features.
template <int D, int MODE, bool PACKED>
__global__ void __launch_bounds__(THREADS, D > 128 ? 1 : 2)
    bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
               const Args args) {
  static_assert(!(MODE == FUSED && PACKED), "the packed layout runs the split");
  using P = Plan<D>;
  constexpr int BN = P::BN, RPT = P::RPT, CPT = P::CPT, KPT = P::KPT, OC = P::OC, QS = P::QS;
  float* sm = smem_f32();
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y;
  Args a = args;
  const int dw = a.dw, group = a.hq / a.hkv;
  // the q and k rows' strides in floats, and the sequence's first rows
  const size_t q_rs = PACKED ? (size_t)a.hq * dw : (size_t)dw;
  const size_t k_rs = PACKED ? (size_t)a.hkv * dw : (size_t)dw;
  int q_row0 = 0, k_row0 = 0;

  if constexpr (MODE == DQ) {
    const int h = blockIdx.x, q0 = (gridDim.z - 1 - blockIdx.z) * BM;
    if constexpr (PACKED) {
      q_row0 = a.cu_q[b];
      a.sq = a.cu_q[b + 1] - q_row0;
      if (q0 >= a.sq) return;  // tile past this sequence
      k_row0 = a.cu_k[b];
      a.sk = a.cu_k[b + 1] - k_row0;
    }
    const int hk = h / group;
    const size_t qh = PACKED ? ((size_t)q_row0 + q0) * a.hq + h : (size_t)(b * a.hq + h) * a.sq + q0;
    const size_t rh = PACKED ? (size_t)h * a.total_q + q_row0 + q0 : qh;  // LSE, delta
    const float* kbase = k + (PACKED ? (size_t)k_row0 * a.hkv + hk : (size_t)(b * a.hkv + hk) * a.sk) * dw;
    const float* vbase = v + (kbase - k);
    const int valid = min(BM, a.sq - q0);
    load_tile<D, BM>(sm + P::q_off, q + qh * dw, q_rs, valid, dw);
    load_tile<D, BM>(sm + P::do_off, dO + qh * dw, q_rs, valid, dw);
    load_rows(sm + P::l2_off, sm + P::dl_off, lse + rh, delta + rh, valid);
    const int p0 = q0 + a.kv_off;
    const fa90::Span sp = fa90::span_of(p0, p0 + valid - 1, a.sk, a.wl, a.wr, BN);
    const float sl = a.slopes != nullptr ? a.slopes[h] : 0.f;
    float acc[RPT][OC][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < OC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
    for (int t = sp.first; t <= sp.last; ++t) {
      const int kv0 = t * BN;
      __syncthreads();  // the previous tile's reads of K, V and dS are done
      load_tile<D, BN>(sm + P::k_off, kbase + kv0 * k_rs, k_rs, a.sk - kv0, dw);
      load_tile<D, BN>(sm + P::v_off, vbase + kv0 * k_rs, k_rs, a.sk - kv0, dw);
      __syncthreads();
      float pt[RPT][CPT], dst[RPT][CPT];
      p_ds<D>(sm, a, p0, kv0, sl, pt, dst);
      put_tile<D>(sm + P::p_off, dst);
      __syncthreads();
      dq_acc<D>(acc, sm + P::p_off, sm + P::k_off);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
      if (r >= valid) continue;
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int col = 64 * c + 4 * tx;
        if (col < dw)
          st4(dq + (qh * dw) + r * q_rs + col,
              make_float4(acc[i][c][0], acc[i][c][1], acc[i][c][2], acc[i][c][3]));
      }
    }
  } else {
    const int hk = blockIdx.x, kv0 = blockIdx.z * BN;
    if constexpr (PACKED) {
      k_row0 = a.cu_k[b];
      a.sk = a.cu_k[b + 1] - k_row0;
      if (kv0 >= a.sk) return;  // tile past this sequence
      q_row0 = a.cu_q[b];
      a.sq = a.cu_q[b + 1] - q_row0;
    }
    const size_t kh = PACKED ? ((size_t)k_row0 + kv0) * a.hkv + hk
                             : (size_t)(b * a.hkv + hk) * a.sk + kv0;
    const int kvalid = min(BN, a.sk - kv0);
    load_tile<D, BN>(sm + P::k_off, k + kh * dw, k_rs, kvalid, dw);
    load_tile<D, BN>(sm + P::v_off, v + kh * dw, k_rs, kvalid, dw);
    const fb90::QTiles qt = fb90::q_tiles(kv0, BN, BM, a);
    float dka[KPT][OC][4], dva[KPT][OC][4];
#pragma unroll
    for (int kk = 0; kk < KPT; ++kk)
#pragma unroll
      for (int c = 0; c < OC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[kk][c][e] = dva[kk][c][e] = 0.f;
    const uint32_t q_smem = smem_u32(sm + P::q_off);
    for (int hi = 0; hi < group; ++hi) {
      const int h = hk * group + hi;
      const float sl = a.slopes != nullptr ? a.slopes[h] : 0.f;
      for (int t = qt.first; t <= qt.last; ++t) {
        const int q0 = t * BM;
        const size_t qh = PACKED ? ((size_t)q_row0 + q0) * a.hq + h
                                 : (size_t)(b * a.hq + h) * a.sq + q0;
        const size_t rh = PACKED ? (size_t)h * a.total_q + q_row0 + q0 : qh;
        const int valid = min(BM, a.sq - q0);
        if constexpr (MODE == FUSED) {
          if (tid < 32) bulk_wait_read();  // the last tile's dQ rows have left the Q tile
        }
        __syncthreads();  // the previous tile's reads are done
        load_tile<D, BM>(sm + P::q_off, q + qh * dw, q_rs, valid, dw);
        load_tile<D, BM>(sm + P::do_off, dO + qh * dw, q_rs, valid, dw);
        load_rows(sm + P::l2_off, sm + P::dl_off, lse + rh, delta + rh, valid);
        __syncthreads();
        float pt[RPT][CPT], dst[RPT][CPT];
        p_ds<D>(sm, a, q0 + a.kv_off, kv0, sl, pt, dst);
        put_tile<D>(sm + P::p_off, pt);
        __syncthreads();
        outer_acc<D>(dva, sm + P::p_off, sm + P::do_off);
        __syncthreads();
        put_tile<D>(sm + P::p_off, dst);
        __syncthreads();
        outer_acc<D>(dka, sm + P::p_off, sm + P::q_off);
        if constexpr (MODE == FUSED) {
          float acc[RPT][OC][4];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int c = 0; c < OC; ++c)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
          dq_acc<D>(acc, sm + P::p_off, sm + P::k_off);
          __syncthreads();  // every read of the Q tile is done: dQ's rows go there
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int c = 0; c < OC; ++c)
              st4(sm + P::q_off + (ty * RPT + i) * QS + 64 * c + 4 * tx,
                  make_float4(acc[i][c][0], acc[i][c][1], acc[i][c][2], acc[i][c][3]));
          fence_async_smem();
          __syncthreads();
          if (tid < 32) {
            // the workspace is [b, hq, sq, dw]: row q0 + r of head h
            float* ws = dq + ((size_t)(b * a.hq + h) * a.sq + q0) * dw;
            for (int r = tid; r < valid; r += 32)
              bulk_reduce_add_f32(ws + (size_t)r * dw, q_smem + r * QS * 4, dw * 4);
            bulk_commit();
          }
        }
      }
    }
    // dK and dV of the block's keys (zeros for keys no row sees)
#pragma unroll
    for (int kk = 0; kk < KPT; ++kk) {
      const int j = ty * KPT + kk;
      if (j >= kvalid) continue;
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const int col = 64 * c + 4 * tx;
        if (col >= dw) continue;
        const size_t off = kh * dw + j * k_rs + col;
        st4(dk + off, make_float4(dka[kk][c][0], dka[kk][c][1], dka[kk][c][2], dka[kk][c][3]));
        st4(dv + off, make_float4(dva[kk][c][0], dva[kk][c][1], dva[kk][c][2], dva[kk][c][3]));
      }
    }
    if constexpr (MODE == FUSED) {
      if (tid < 32) bulk_wait();  // the reductions are done before the block leaves
    }
  }
}

// Launch MODE at D on fp32 tensors. rows: sk (FUSED, DKV) or sq (DQ), or
// the packed layout's max_sk / max_sq, the grid's tile axis. Returns a
// cudaError_t code or MFA_BAD_CONFIG.
template <int D, int MODE, bool PACKED>
int launch(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           const float* delta, float* dq, void* dk, void* dv, int batch, int rows,
           const Args& a, cudaStream_t stream) {
  using P = Plan<D>;
  if (a.dw <= 0 || a.dw > D || a.dw % 4 != 0) return MFA_BAD_CONFIG;
  auto kern = bwd_kernel<D, MODE, PACKED>;
  if (int err = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)P::bytes))
    return err;
  const dim3 grid(MODE == DQ ? a.hq : a.hkv, batch,
                  MODE == DQ ? (rows + BM - 1) / BM : (rows + P::BN - 1) / P::BN);
  kern<<<grid, THREADS, P::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dO), lse, delta, dq, static_cast<float*>(dk),
      static_cast<float*>(dv), a);
  return (int)cudaGetLastError();
}

}  // namespace bf32
