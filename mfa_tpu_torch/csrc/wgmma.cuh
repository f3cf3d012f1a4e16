// Hopper (sm_90a) building blocks of the hand-written kernels: mbarriers,
// TMA tile loads, the register budget of a warp-specialised block, and
// warpgroup matrix products (wgmma) with their shared-memory descriptors.
//
// wgmma computes a 64-row product as one instruction of a warpgroup (four
// consecutive warps). Its fp32 accumulator is spread over the 128 threads
// as the mma.sync m16n8 fragments of each warp's 16 rows, one 8-column
// block after another: thread (warp w, lane l) holds, for column block j,
// d[4j + 0..1] = row 16w + l/4, columns 8j + 2(l%4) + {0, 1}, and
// d[4j + 2..3] = the same columns of row 16w + l/4 + 8. Packed in pairs to
// 16-bit values, 16 consecutive columns of that accumulator are exactly the
// register A fragment of the next product (d[8c..8c+7] -> a[0..3]).
//
// Shared-memory operands use the 128-byte swizzle that a TMA load with
// CU_TENSOR_MAP_SWIZZLE_128B writes: a tile is stored as 64-element
// (128-byte) column chunks of `rows` rows each, every chunk 1024-byte
// aligned, so 8 rows make one 1024-byte swizzle atom.
//  - K-major operand (the contraction runs along the stored row): a
//    16-deep step starts 32 bytes further inside the chunk, the next 8
//    rows are 1024 bytes on (SBO); the next chunk is a new descriptor.
//  - MN-major operand (the contraction runs across rows; wgmma's
//    transpose bit): a 16-deep step is 16 rows = 2048 bytes on, the next
//    8 rows 1024 bytes on (SBO), the next 64 output columns one chunk on
//    (LBO = rows * 128 bytes).
// (CUTLASS's make_gmma_desc builds the same fields.)
//
// Both operands may be MN-major in shared memory (wgmma_ss_t): an A operand
// stored as K rows of 64 M values is read through A's transpose bit with
// the same fields (a 16-deep step is 2048 bytes on, SBO 1024). A product
// narrower than a 64-column chunk (N = 32) starts its descriptor inside the
// chunk's rows, as a K-major 16-deep step does: the swizzle acts on the
// address, not on the descriptor.
//
// Inline PTX takes its operand list as a string literal, so the
// accumulator lists below are spelled out (16, 32, 64 and 128 registers).
#pragma once

#include <cuda.h>
#include <type_traits>

#include "common.cuh"

#define MFA_ACC_STR_8 "{%0, %1, %2, %3, %4, %5, %6, %7}"

#define MFA_ACC_OUT_8(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])

#define MFA_ACC_STR_16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

#define MFA_ACC_OUT_16(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

#define MFA_ACC_STR_32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define MFA_ACC_OUT_32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define MFA_ACC_STR_64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define MFA_ACC_OUT_64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define MFA_ACC_STR_128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

#define MFA_ACC_OUT_128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// -- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Make the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The producer's arrival, announcing the bytes its TMA loads will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed. (No
// watchdog here: a __trap in the consumers' loop makes ptxas ignore their
// setmaxnreg budget and spill at head_dim 256.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Fetch a tensor map (a kernel parameter) into the TMA unit's cache ahead of
// its first load.
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes of global memory into shared memory (both 16-byte
// aligned, bytes a multiple of 16), completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Add a box of shared memory into a 3-D tensor map's tile (fp32 adds done
// in L2; rows past the map's bound are skipped), as one bulk async group
// member. The source must be made visible to the async proxy first.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, uint32_t src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Add `bytes` contiguous fp32 values of shared memory into global memory
// (both 16-byte aligned, bytes a multiple of 16; the adds done in L2), as
// one bulk async group member. The source must be made visible to the
// async proxy first.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until this thread's bulk groups have read their shared memory
// (bulk_wait_read) or have completed (bulk_wait).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Register budget of a warpgroup (every warp of it executes this).
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// A barrier of `count` threads other than __syncthreads' (id 0).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Make this thread's shared-memory stores visible to the async proxy (a
// later wgmma reading them as an operand).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma --------------------------------------------------------------------

// Descriptor of a 128-byte-swizzled shared-memory operand at `addr`
// (lbo_bytes: the chunk stride of an MN-major operand; ignored K-major).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of wgmma's registers across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Four 8 x 8 16-bit matrices from shared memory, transposed: lane l gives
// the address of row l % 8 of matrix l / 8 and receives, of each, rows
// 2 (l % 4) (low half) and 2 (l % 4) + 1 of column l / 4.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Four int8 values -> two packed bf16 pairs (bytes 0, 1 and 2, 3), exactly:
// the low 7 bits under exponent 2^7 give 128 + low, the sign bit there 128
// or 256, and their difference is the byte (csrc/wmatmul.cu's conversion).
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t low = w & 0x7F7F7F7Fu, sign = w & 0x80808080u;
  const uint32_t a0 = __byte_perm(low, 0x43434343u, 0x4140);
  const uint32_t b0 = __byte_perm(sign, 0x43434343u, 0x4140);
  const uint32_t a1 = __byte_perm(low, 0x43434343u, 0x4342);
  const uint32_t b1 = __byte_perm(sign, 0x43434343u, 0x4342);
  const __nv_bfloat162 r0 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a0),
                                    *reinterpret_cast<const __nv_bfloat162*>(&b0));
  const __nv_bfloat162 r1 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a1),
                                    *reinterpret_cast<const __nv_bfloat162*>(&b1));
  lo = *reinterpret_cast<const uint32_t*>(&r0);
  hi = *reinterpret_cast<const uint32_t*>(&r1);
}

__device__ __forceinline__ uint32_t bf16x2_op(uint32_t a, uint32_t b, bool mul) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&b);
  const __nv_bfloat162 r = mul ? __hmul2(x, y) : __hsub2(x, y);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Four e4m3 bytes -> two packed bf16 pairs (bytes 0, 1 and 2, 3), exactly.
// A byte's sign goes to bit 15 of its 16-bit lane and its exponent and
// mantissa bits to bits 4-10: a bf16 whose exponent field holds e4m3's
// (bias 7 read as 127), so one multiply by 2^120 gives the value. An e4m3
// subnormal is a bf16 subnormal there, which the bf16 product keeps (no
// flush to zero for bf16). The NaN codes 0x7F / 0xFF come out finite (+-480)
// and quantize_rows never writes them.
__device__ __forceinline__ void e4m3x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t a = __byte_perm(w, 0u, 0x4140), b = __byte_perm(w, 0u, 0x4342);
  const uint32_t fa = ((a << 8) & 0x80008000u) | ((a << 4) & 0x07F007F0u);
  const uint32_t fb = ((b << 8) & 0x80008000u) | ((b << 4) & 0x07F007F0u);
  lo = bf16x2_op(fa, 0x7B807B80u, true);  // x {2^120, 2^120}
  hi = bf16x2_op(fb, 0x7B807B80u, true);
}

// Four bytes of 4-bit values under the magic exponent: byte b of x -> lane
// b of {128 + x.b0, 128 + x.b1}, {128 + x.b2, 128 + x.b3}, less 136 (the
// nibbles carry value + 8).
__device__ __forceinline__ void u4x4_to_bf16(uint32_t x, uint32_t& lo, uint32_t& hi) {
  lo = bf16x2_op(__byte_perm(x, 0x43434343u, 0x4140), 0x43084308u, false);
  hi = bf16x2_op(__byte_perm(x, 0x43434343u, 0x4342), 0x43084308u, false);
}

// Four bytes of int4 feature pairs (byte j: feature 2j in the low nibble,
// 2j + 1 in the high one, two's complement) -> o[j] = bf16 pair {feature
// 2j, feature 2j + 1}, exactly: n ^ 8 = n + 8 in [0, 15] becomes the
// mantissa of 128.0 (bf16 0x4300), and 136 comes off.
__device__ __forceinline__ void i4x8_to_bf16(uint32_t w, uint32_t (&o)[4]) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t lo = u & 0x0F0F0F0Fu, hi = (u >> 4) & 0x0F0F0F0Fu;
  // [lo.b0, hi.b0, lo.b1, hi.b1] and [lo.b2, hi.b2, lo.b3, hi.b3]
  u4x4_to_bf16(__byte_perm(lo, hi, 0x5140), o[0], o[1]);
  u4x4_to_bf16(__byte_perm(lo, hi, 0x7362), o[2], o[3]);
}

// Four bytes of int4 feature pairs, byte r from token r -> the low nibbles'
// feature as bf16 pairs {token 0, 1}, {token 2, 3} (lo) and the high
// nibbles' (hi), exactly.
__device__ __forceinline__ void i4x8_tokens_to_bf16(uint32_t w, uint32_t (&lo)[2],
                                                    uint32_t (&hi)[2]) {
  const uint32_t u = w ^ 0x88888888u;
  u4x4_to_bf16(u & 0x0F0F0F0Fu, lo[0], lo[1]);
  u4x4_to_bf16((u >> 4) & 0x0F0F0F0Fu, hi[0], hi[1]);
}

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

#define MFA_WGMMA_SS(NN, TY, R, IA, IB, IS)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IS ", 0;\n"                             \
               "wgmma.mma_async.sync.aligned.m64n" NN "k16.f32." TY "." TY " " MFA_ACC_STR_##R \
               ", " IA ", " IB ", p, 1, 1, 0, 0;\n}\n"                                     \
               : MFA_ACC_OUT_##R(d)                                                        \
               : "l"(a), "l"(b), "r"(scale_d))

#define MFA_WGMMA_RS(NN, TY, R, IA0, IA1, IA2, IA3, IB, IS)                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IS ", 0;\n"                             \
               "wgmma.mma_async.sync.aligned.m64n" NN "k16.f32." TY "." TY " " MFA_ACC_STR_##R \
               ", {" IA0 ", " IA1 ", " IA2 ", " IA3 "}, " IB ", p, 1, 1, 1;\n}\n"           \
               : MFA_ACC_OUT_##R(d)                                                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

// d[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared memory
// (descriptors a, b). scale_d = 0 overwrites d.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N in {32, 64, 128}");
  if constexpr (N == 32) {
    if constexpr (kIsBf16<T>)
      MFA_WGMMA_SS("32", "bf16", 16, "%16", "%17", "%18");
    else
      MFA_WGMMA_SS("32", "f16", 16, "%16", "%17", "%18");
  } else if constexpr (N == 64) {
    if constexpr (kIsBf16<T>)
      MFA_WGMMA_SS("64", "bf16", 32, "%32", "%33", "%34");
    else
      MFA_WGMMA_SS("64", "f16", 32, "%32", "%33", "%34");
  } else {
    if constexpr (kIsBf16<T>)
      MFA_WGMMA_SS("128", "bf16", 64, "%64", "%65", "%66");
    else
      MFA_WGMMA_SS("128", "f16", 64, "%64", "%65", "%66");
  }
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], A in registers (the fragment of the
// header), B MN-major in shared memory (descriptor b, transpose bit set).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_rs: N in {64, 128, 256}");
  if constexpr (N == 64) {
    if constexpr (kIsBf16<T>)
      MFA_WGMMA_RS("64", "bf16", 32, "%32", "%33", "%34", "%35", "%36", "%37");
    else
      MFA_WGMMA_RS("64", "f16", 32, "%32", "%33", "%34", "%35", "%36", "%37");
  } else if constexpr (N == 128) {
    if constexpr (kIsBf16<T>)
      MFA_WGMMA_RS("128", "bf16", 64, "%64", "%65", "%66", "%67", "%68", "%69");
    else
      MFA_WGMMA_RS("128", "f16", 64, "%64", "%65", "%66", "%67", "%68", "%69");
  } else {
    if constexpr (kIsBf16<T>)
      MFA_WGMMA_RS("256", "bf16", 128, "%128", "%129", "%130", "%131", "%132", "%133");
    else
      MFA_WGMMA_RS("256", "f16", 128, "%128", "%129", "%130", "%131", "%132", "%133");
  }
}

#define MFA_WGMMA_RS_T(NN, TY, R, IA0, IA1, IA2, IA3, IB, IS, ITB)                         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IS ", 0;\n"                             \
               "wgmma.mma_async.sync.aligned.m64n" NN "k16.f32." TY "." TY " " MFA_ACC_STR_##R \
               ", {" IA0 ", " IA1 ", " IA2 ", " IA3 "}, " IB ", p, 1, 1, " ITB ";\n}\n"     \
               : MFA_ACC_OUT_##R(d)                                                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB))

// d[64 x N] (+)= A[64 x 16] B[16 x N], A in registers (the fragment of the
// header), B in shared memory read K-major (TB = 0) or MN-major (TB = 1).
// The A registers are read while the product runs: keep them unchanged
// until a wait retires it.
template <typename T, int N, int TB>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 256,
                "wgmma_rs_t: N in {16, 32, 64, 128, 256}");
#define MFA_RS_T(NN, R, I0, I1, I2, I3, IB, IS, ITB)          \
  if constexpr (kIsBf16<T>)                                   \
    MFA_WGMMA_RS_T(NN, "bf16", R, I0, I1, I2, I3, IB, IS, ITB); \
  else                                                        \
    MFA_WGMMA_RS_T(NN, "f16", R, I0, I1, I2, I3, IB, IS, ITB);
  if constexpr (N == 16) {
    MFA_RS_T("16", 8, "%8", "%9", "%10", "%11", "%12", "%13", "%14")
  } else if constexpr (N == 32) {
    MFA_RS_T("32", 16, "%16", "%17", "%18", "%19", "%20", "%21", "%22")
  } else if constexpr (N == 64) {
    MFA_RS_T("64", 32, "%32", "%33", "%34", "%35", "%36", "%37", "%38")
  } else if constexpr (N == 128) {
    MFA_RS_T("128", 64, "%64", "%65", "%66", "%67", "%68", "%69", "%70")
  } else {
    MFA_RS_T("256", 128, "%128", "%129", "%130", "%131", "%132", "%133", "%134")
  }
#undef MFA_RS_T
}

#define MFA_WGMMA_SS_T(NN, TY, R, IA, IB, IS, ITA, ITB)                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IS ", 0;\n"                             \
               "wgmma.mma_async.sync.aligned.m64n" NN "k16.f32." TY "." TY " " MFA_ACC_STR_##R \
               ", " IA ", " IB ", p, 1, 1, " ITA ", " ITB ";\n}\n"                         \
               : MFA_ACC_OUT_##R(d)                                                        \
               : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB))

// d[64 x N] (+)= A[64 x 16] B[16 x N], both in shared memory; TA / TB = 1
// reads that operand MN-major (its transpose bit), 0 K-major.
template <typename T, int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t a, uint64_t b,
                                           int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss_t: N in {32, 64, 128}");
  if constexpr (N == 32) {
    if constexpr (kIsBf16<T>)
      MFA_WGMMA_SS_T("32", "bf16", 16, "%16", "%17", "%18", "%19", "%20");
    else
      MFA_WGMMA_SS_T("32", "f16", 16, "%16", "%17", "%18", "%19", "%20");
  } else if constexpr (N == 64) {
    if constexpr (kIsBf16<T>)
      MFA_WGMMA_SS_T("64", "bf16", 32, "%32", "%33", "%34", "%35", "%36");
    else
      MFA_WGMMA_SS_T("64", "f16", 32, "%32", "%33", "%34", "%35", "%36");
  } else {
    if constexpr (kIsBf16<T>)
      MFA_WGMMA_SS_T("128", "bf16", 64, "%64", "%65", "%66", "%67", "%68");
    else
      MFA_WGMMA_SS_T("128", "f16", 64, "%64", "%65", "%66", "%67", "%68");
  }
}

#undef MFA_WGMMA_SS
#undef MFA_WGMMA_RS
#undef MFA_WGMMA_SS_T
#undef MFA_WGMMA_RS_T

// -- clusters ------------------------------------------------------------------

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives and waits; shared-memory
// writes before it are visible to the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// 16 bytes at shared address `addr` of the cluster's block `rank`.
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote));
  return v;
}

// -- host: tensor maps ---------------------------------------------------------

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (the
// libraries link against the runtime alone).
typedef CUresult (*MfaEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline MfaEncodeTiled mfa_encode_tiled() {
  static MfaEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<MfaEncodeTiled>(p);
  }
  return fn;
}

// A map of `rank` (at most 4) dimensions over `type`: dims[0] contiguous,
// dimension i + 1 strides[i] bytes apart (multiples of 16), in boxes of
// box[0..rank). Coordinates past a dimension read as zeros (and are not
// written). Returns 0 or MFA_TMA_ENCODE.
inline int mfa_encode(CUtensorMap* map, const void* base, CUtensorMapDataType type, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  MfaEncodeTiled encode = mfa_encode_tiled();
  if (encode == nullptr) return MFA_TMA_ENCODE;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MFA_TMA_ENCODE;
}

// A 3-D map over n [rows, cols] matrices of `type`, rows row_bytes apart
// and matrices plane_bytes apart (both multiples of 16), in boxes of
// box_cols columns (128 bytes) x box_rows rows with the 128-byte swizzle.
// Rows past `rows` read as zeros (and are not written). Returns 0 or
// MFA_TMA_ENCODE.
inline int mfa_encode_3d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int cols,
                         int rows, int n, size_t row_bytes, size_t plane_bytes, int box_cols,
                         int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)plane_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  return mfa_encode(map, base, type, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The same over 16-bit values, in boxes of 64 columns. The packed layout
// [total, heads, cols] is n = heads matrices of `total` rows, heads * cols
// * 2 bytes a row and cols * 2 bytes between heads.
inline int mfa_tensor_map_3d_strided(CUtensorMap* map, const void* base, bool bf16, int cols,
                                     int rows, int n, size_t row_bytes, size_t plane_bytes,
                                     int box_rows) {
  return mfa_encode_3d(map, base,
                       bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                       cols, rows, n, row_bytes, plane_bytes, 64, box_rows);
}

// n contiguous [rows, cols] matrices (the batched layout [b * heads, rows,
// cols]).
inline int mfa_tensor_map_3d(CUtensorMap* map, const void* base, bool bf16, int cols, int rows,
                             int n, int box_rows) {
  return mfa_tensor_map_3d_strided(map, base, bf16, cols, rows, n, (size_t)cols * 2,
                                   (size_t)rows * cols * 2, box_rows);
}
