// mma.sync.m16n8k16 with fp32 accumulation, the product of the split
// backward's tiles (flash_bwd.cuh: kernels 12-14). Every forward kernel runs
// wgmma: the dense prefill kernels 1-4, packed varlen (kernel 7) and the
// image-block prefill (kernel 9) on flash_fwd_sm90.cuh's tile, paged prefill
// (kernel 8) on its own (paged_prefill.cu).
#pragma once

#include "common.cuh"

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
