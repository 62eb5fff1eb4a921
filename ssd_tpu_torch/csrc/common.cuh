// Shared helpers of the port's kernels: element conversion and vector loads
// for the storage types the kernels take (fp32 and bf16 q and caches, int8
// caches and weights), tensor-core and async-copy wrappers, and the row
// tiles of grouped products. Float math accumulates in fp32, integer dots in
// int32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace ssd {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// Stage variants of the paged kernels (bench probes): the production kernel,
// its page loads alone, its math alone on resident rows, neither.
enum Stage : int { kStageFull = 0, kStageLoads = 1, kStageMath = 2, kStageEmpty = 3 };

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

// --- Tensor cores and asynchronous copies (sm_80+: mma.sync, ldmatrix,
// cp.async), shared by the grouped GEMM, the paged kernels and the s8 probe ---

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !pred.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(smem)), "l"(gmem), "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zeros where !pred.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(smem)), "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row-major fragment) . b (16 x 8, column fragment), bf16
// products summed in fp32. Fragments (g = lane / 4, t = lane % 4): a[0] row
// g, columns 2t, 2t+1; a[1] row g+8; a[2], a[3] the same rows at columns
// 2t+8, 2t+9; b0 rows 2t, 2t+1 of column g, b1 rows 2t+8, 2t+9; d[0], d[1]
// row g, columns 2t, 2t+1, d[2], d[3] row g+8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 32 s8) . b (32 x 8 s8) in int32. a[0] row g, columns 4t..4t+3;
// a[1] row g+8; a[2], a[3] the same rows at columns 16+4t..; b[0] rows
// 4t..4t+3 of column g, b[1] rows 16+4t..; c as mma_bf16's d.
__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats as a bf16 pair (x in the low half), rounded to nearest.
__device__ __forceinline__ unsigned bf16x2(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Two int8 values (bytes 0 and 1 of a 16-bit word) as a bf16 pair, low half
// first: exact, since |x| <= 128.
__device__ __forceinline__ unsigned s8x2_to_bf16x2(int w) {
  return bf16x2(static_cast<float>(sbyte(w, 0)), static_cast<float>(sbyte(w, 1)));
}

// --- Groups of rows (expert-sorted MoE dispatches), shared by the grouped
// GEMM (K6) and the W8A16 GEMM (K9) ---

constexpr unsigned kFull = 0xffffffffu;

// Row tile `target` of rows sorted by group, group g owning rows
// [offs[g], offs[g+1]) cut into tiles of BM: group e_out, rows
// [row0, row_end). The tiles are numbered group after group; one warp forms
// their prefix sum with a shuffle scan, 32 groups a step, the first 256
// groups' offsets loaded before the scan so that their latencies overlap.
// False when `target` is past the last tile; every thread of the block gets
// the same answer.
template <int BM>
__device__ __forceinline__ bool find_row_tile_at(const int* __restrict__ offs, int E,
                                                 int target, int& e_out, int& row0,
                                                 int& row_end) {
  __shared__ int tile[3];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    constexpr int kPre = 8;  // steps whose offsets are loaded up front
    int pre[kPre + 1];
#pragma unroll
    for (int i = 0; i <= kPre; ++i) pre[i] = 32 * i + lane <= E ? offs[32 * i + lane] : 0;
    int carry = 0, found = -1, beg = 0, end = 0;
#pragma unroll 1
    for (int base = 0; base < E; base += 32) {
      const int e = base + lane;
      int lo, hi;
      if (base < 32 * kPre) {
        // offs[e] and offs[e + 1]: this lane's preload and the next lane's
        // (lane 31 takes the next step's lane 0).
        const int step = base / 32;
        int cur = 0, next = 0;
#pragma unroll
        for (int i = 0; i < kPre; ++i)
          if (i == step) {
            cur = pre[i];
            next = pre[i + 1];
          }
        const int up = __shfl_down_sync(kFull, cur, 1);
        const int wrap = __shfl_sync(kFull, next, 0);
        lo = cur;
        hi = lane == 31 ? wrap : up;
      } else {
        lo = e < E ? offs[e] : 0;
        hi = e < E ? offs[e + 1] : 0;
      }
      if (e >= E) lo = hi = 0;
      const int tiles = (hi - lo + BM - 1) / BM;
      int incl = tiles;  // inclusive prefix sum over the 32 lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const int start = carry + incl - tiles;
      if (e < E && target >= start && target < start + tiles) {
        found = e;
        beg = lo + (target - start) * BM;
        end = min(beg + BM, hi);
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) tile[0] = -1;
    __syncwarp();
    if (found >= 0) {  // at most one lane
      tile[0] = found;
      tile[1] = beg;
      tile[2] = end;
    }
  }
  __syncthreads();
  e_out = tile[0];
  row0 = tile[1];
  row_end = tile[2];
  return e_out >= 0;
}

}  // namespace ssd
