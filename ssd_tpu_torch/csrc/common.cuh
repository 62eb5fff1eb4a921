// Shared helpers of the port's attention kernels: element conversion and
// vector loads for the storage types the kernels take (fp32 and bf16 q and
// caches, int8 caches). Float math accumulates in fp32, integer dots in int32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace ssd {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Eight consecutive elements as floats. `p` must be 16-byte aligned for bf16
// and 32-byte aligned for fp32 (the wrappers check the base pointers; every
// offset used is a multiple of 8 elements).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// N (2 or 4) consecutive elements as floats; `p` aligned to N elements.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    static_assert(N == 2, "load_n takes 2 or 4 elements");
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    static_assert(N == 2, "load_n takes 2 or 4 elements");
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = a.x; v[1] = a.y;
  }
}

// --- int8 cache (kv_quant) ---

// The f32 nearest 1/127: q and p quantize as x * kInv127, as the TPU
// kernel's `* (1.0 / 127.0)` does.
constexpr float kInv127 = 1.0f / 127.0f;

// Byte j of a 32-bit word as a signed value.
__device__ __forceinline__ int sbyte(int w, int j) {
  return static_cast<int>(static_cast<unsigned>(w) << (24 - 8 * j)) >> 24;
}

// N (2, 4 or 8) consecutive int8 values, widened; `p` aligned to N bytes.
template <int N>
__device__ __forceinline__ void load_i8(const int8_t* p, int (&v)[N]) {
  if constexpr (N == 8) {
    const int2 u = *reinterpret_cast<const int2*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = sbyte(u.x, j);
      v[4 + j] = sbyte(u.y, j);
    }
  } else if constexpr (N == 4) {
    const int u = *reinterpret_cast<const int*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = sbyte(u, j);
  } else {
    static_assert(N == 2, "load_i8 takes 2, 4 or 8 elements");
    const int u = *reinterpret_cast<const short*>(p);
    v[0] = sbyte(u, 0);
    v[1] = sbyte(u, 1);
  }
}

// Eight consecutive int8 values as floats (exact); `p` 8-byte aligned.
__device__ __forceinline__ void load8(const int8_t* p, float (&v)[8]) {
  int w[8];
  load_i8<8>(p, w);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = static_cast<float>(w[j]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace ssd
