// 3xTF32 products on mma.sync and cp.async loads: the pieces the fp32
// tiles share (flash_fwd_f32.cuh's 64-row forward tile, flash_bwd_f32.cuh's
// backward tile).
//
// An fp32 operand x is split into hi = rna.tf32(x) and lo = x - hi passed
// whole (the tensor core reads its TF32 bits, the low 13 ignored: hi + lo
// keeps ~21 bits, one instruction fewer than rounding lo too), and a
// product is lo.hi + hi.lo + hi.hi, the small terms first, lo.lo dropped
// (kernels/backward.py:_matmul_3xtf32_plain is the CPU emulation).
#pragma once

#include "wgmma.cuh"

namespace tc32 {

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// cvt.rna.tf32.f32's rounding on a finite x, as two integer operations on
// its bit pattern (the cvt instruction adds an Inf / NaN guard that
// doubles the split's cost, and the operands here are finite).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// An A fragment (a0..a3) split into its hi and lo parts.
__device__ __forceinline__ void split4(float a0, float a1, float a2, float a3, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(a0, hi[0], lo[0]);
  split(a1, hi[1], lo[1]);
  split(a2, hi[2], lo[2]);
  split(a3, hi[3], lo[3]);
}
// d += a b, m16n8k8, TF32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b, m16n8k16, bf16 operands (pairs along k), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 (cp16) or 4 (cp4) bytes from global to shared memory, zeros when !ok
// (src is then any valid address: no byte of it is read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
// The barrier's arrival of this thread once its cp.async copies so far land.
__device__ __forceinline__ void cp_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// Close this thread's group of cp.async copies; wait until at most N of
// its groups are in flight.
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tc32
