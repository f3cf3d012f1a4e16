// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every source in this directory compiles on its own into a shared library
// with a plain C interface (nvcc -shared), loaded from Python with ctypes
// (mfa_tpu_torch/kernels/_build.py). Launch functions take raw pointers and
// the caller's cudaStream_t, launch on that stream without synchronising,
// and return cudaGetLastError() so the Python wrapper can raise on a
// refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers (kernels/_build.py)
#define MFA_F16 0
#define MFA_BF16 1
#define MFA_I8 2
// quantized KV page formats (kernels/_build.py:KV_CODES): fp8 e4m3 bytes,
// and int4 as bytes of two features (feature 2c low nibble, 2c + 1 high)
#define MFA_E4M3 3
#define MFA_I4 4
// fp32 q, k, v (and O): the fp32 tiles of flash_fwd_f32.cuh
#define MFA_F32 5

// A paged kernel's page format: pages of the q dtype (16-bit, or fp32 with
// fp32 q: F16 names "unquantized" there), or one byte
// a value (int8, e4m3) or half a byte (int4) with fp32 row scales.
enum class KV { F16, I8, E4M3, I4 };

// Large negative, safe in fp32 exp2: exp2(MASK - m) flushes to 0, never NaN
// (the numerics rules of mfa_tpu: subtract first, guard dead rows).
#define MFA_MASK (-1e30f)
#define MFA_LN2 0.69314718055994531f

// Unsupported configuration (checked by the Python wrapper first).
#define MFA_BAD_CONFIG 9999
// cuTensorMapEncodeTiled was not found or refused a tensor map.
#define MFA_TMA_ENCODE 9998

// Every attention launch takes rows of dw features (the stored width) and
// the instantiated head dim kd (64, 128 or 256) to run them at, both from
// dispatch/config.py:head_dim_plan (stored, kernel_dim); a launch only
// checks that the rows fit. A row's bytes must also be a multiple of 16,
// TMA's global stride rule: cuTensorMapEncodeTiled refuses any other map
// (MFA_TMA_ENCODE).
inline bool mfa_dims_fit(int dw, int kd) {
  return (kd == 64 || kd == 128 || kd == 256) && dw > 0 && dw <= kd;
}

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_float<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_float<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// Two floats -> one 32-bit register of two 16-bit values, lower column in
// the lower half (the mma.sync fragment convention).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

extern "C" const char* mfa_error_string(int code) {
  if (code == MFA_BAD_CONFIG) return "unsupported kernel configuration";
  if (code == MFA_TMA_ENCODE) return "TMA tensor map encoding failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
