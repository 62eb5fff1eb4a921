// The int8 dot-rate probe: out[n, r, l] = sum_d q[n, r, d] * k[n, l, d] for
// N batched row blocks of R = 8 query rows, as s8 x s8 -> s32 and as the
// same dot after k is cast to bf16 with fp32 accumulation.
//
// Replaces the TPU kernels bench/s8_probe.py::_kernel_s8 and ::_kernel_bf16
// (one pallas_call each), which time the chip's int8 dot against its bf16 dot
// at the int8 paged kernel's tile: N = 64 row blocks, R = 8 query rows,
// L = 512 positions, D = 128 (2 * hd) contraction. Three entry points:
//  - ssd_s8_dot_mma: tensor cores, mma.sync m16n8k32 s8 -> s32;
//  - ssd_s8_dot_dp4a: SIMT, __dp4a;
//  - ssd_s8_dot_bf16: tensor cores, mma.sync m16n8k16 bf16 -> fp32, q in
//    bf16 and k widened to bf16 in registers.
// Integers of magnitude <= 127 are exact in bf16 and every product sum is
// below 2^24, so all three paths are exact in any order of summation: their
// plain version is the fp64 product (ops/probes.py).
//
// What bounds it on an H100: bytes. k is N * L * D = 4 MiB of int8 and the
// output 1 MiB (s32 or fp32), against 2 * N * R * L * D = 67 MOP, some 0.03
// us at the int8 tensor rate: far below the ~590 operations per byte where
// the tensor cores would bound it. So the design is about moving k:
//  - One skeleton serves the three paths. A block owns one tile: one row
//    block n and kP = 64 consecutive positions, so its k is one contiguous
//    span of kP * D bytes, which every thread requests as its first act
//    with 16-byte cp.async (consecutive threads on consecutive pieces).
//    Small blocks (~12 KB of shared memory, up to 16 an SM) put the probe's
//    512 tiles on the card in one wave, so all of k is requested at once;
//    at 4096 positions the card keeps ~2,100 tiles in flight. (A persistent
//    grid walking tiles through a two-stage ring took 1.06-1.09x this
//    kernel's time at 4096 positions on an H100, and the same at 512.)
//    Shared rows are padded to D + 16 bytes: eight consecutive rows start
//    on eight different 16-byte bank groups, so ldmatrix (eight rows of one
//    16-byte column) and the SIMT path (a lane a row) read without
//    conflicts.
//  - The tensor-core paths swap the operands' roles against the product
//    q k^T: the positions are the mma's M (a warp owns 16 of them, one m16
//    tile) and q's 8 rows its N = 8, so every accumulator holds a result
//    (an M = 16 tile over q's 8 rows would be half zeros). q's B fragment
//    is loaded from device memory into registers once per warp, while k is
//    in flight: D / 32 k-steps of 2 registers for s8, D / 16 for bf16. The
//    A fragments come from shared memory with ldmatrix.x4: 16 rows by 32
//    bytes a call, one m16n8k32 step for s8, two m16n8k16 steps for bf16.
//  - bf16 without 2-byte loads: the order of the contraction is free, so in
//    a k16 step lane (g, t) lets its columns 2t, 2t+1 | 2t+8, 2t+9 stand for
//    d = 4t, 4t+1 | 4t+2, 4t+3 of the 16-d chunk: the 4-byte word ldmatrix
//    gives the lane (row g, bytes 4t..4t+3) widens exactly into the A
//    fragment's two bf16 pairs (s8x4_to_bf16x4), and q's B fragment is
//    q[g, 4t .. 4t+3] of the chunk, one 8-byte load.
//  - __dp4a: the same staged tile; two threads a position, each with 4 of
//    the 8 rows, reading the position's row from shared memory and q's rows
//    (staged beside k) as warp-wide broadcasts.
//  - The accumulators come out position-major and out is [N, 8, L],
//    contiguous in l: each block stages its 8 x kP tile in shared memory
//    (row pitch kP + 4 words: the fragments' stores hit 32 banks) and writes
//    each row r with 16-byte stores (scalar ones when L % 4 != 0, whose rows
//    are not 16-byte aligned), rows past L masked.
// mma.sync rather than wgmma: at 0.03 us of tensor work the instruction
// does not bound the kernel, and m16n8 tiles keep a block at 64 positions
// (wgmma's M = 64 a warpgroup would take 64 positions a warpgroup and the
// descriptors' swizzled layouts for the same bytes).
#include "common.cuh"

namespace ssd {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kP = 16 * kWarps;        // positions a block: one m16 tile a warp
constexpr int kOutPitch = kP + 4;      // words a row of the staged output tile

enum Path : int { kMma = 0, kDp4a = 1, kBf16 = 2 };

// Grid: one block a tile of kP positions of one row block, N * ceil(L / kP)
// tiles, row block after row block. D is 64 or 128 (a multiple of 32 and of
// 16: the k-steps of both mma shapes, and 16-byte pieces of every row).
template <int D, int PATH>
__global__ void __launch_bounds__(kThreads)
    s8_dot_kernel(const void* __restrict__ q, const int8_t* __restrict__ k,
                  void* __restrict__ out, int L, int tiles_per_row) {
  constexpr int kPitch = D + 16;       // bytes a staged k row
  constexpr int kChunks = D / 16;      // 16-byte pieces a row
  __shared__ __align__(16) int8_t k_s[kP * kPitch];
  __shared__ __align__(16) unsigned out_s[8 * kOutPitch];
  __shared__ __align__(16) int8_t q_s[PATH == kDp4a ? 8 * D : 16];
  const int n = blockIdx.x / tiles_per_row, l0 = (blockIdx.x % tiles_per_row) * kP;
  const int tid = threadIdx.x;

  // k[n, l0 : l0 + kP, :] into k_s first, rows past L zero-filled;
  // consecutive threads on consecutive 16-byte pieces.
  const int8_t* kn = k + (size_t)n * L * D;
  static_assert(kP * kChunks % kThreads == 0, "whole pieces a thread");
#pragma unroll
  for (int i = 0; i < kP * kChunks / kThreads; ++i) {
    const int e = tid + i * kThreads, r = e / kChunks, c = e % kChunks;
    const bool live = l0 + r < L;
    cp_async16(k_s + r * kPitch + 16 * c, kn + (size_t)(live ? l0 + r : 0) * D + 16 * c, live);
  }
  if constexpr (PATH == kDp4a) {
    const int8_t* qn = static_cast<const int8_t*>(q) + (size_t)n * 8 * D;
    for (int e = tid; e < 8 * kChunks; e += kThreads) cp_async16(q_s + 16 * e, qn + 16 * e, true);
  }
  cp_async_commit();
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if constexpr (PATH == kDp4a) {
    cp_async_wait<0>();
    __syncthreads();
    const int p = tid % kP, r0 = 4 * (tid / kP);   // warp-uniform rows r0..r0+3
    const int8_t* krow = k_s + p * kPitch;
    int acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int4 kv = *reinterpret_cast<const int4*>(krow + 16 * c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int4 qv = *reinterpret_cast<const int4*>(q_s + (r0 + r) * D + 16 * c);
        acc[r] = __dp4a(qv.x, kv.x, acc[r]);
        acc[r] = __dp4a(qv.y, kv.y, acc[r]);
        acc[r] = __dp4a(qv.z, kv.z, acc[r]);
        acc[r] = __dp4a(qv.w, kv.w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) out_s[(r0 + r) * kOutPitch + p] = static_cast<unsigned>(acc[r]);
  } else {
    // ldmatrix.x4 row addresses: lanes 0-7 rows 0-7 and lanes 8-15 rows 8-15
    // of the warp's tile at the step's first 16 bytes, lanes 16-31 the same
    // rows at its second 16 bytes (A fragments a[0], a[1], a[2], a[3]).
    const int8_t* arow =
        k_s + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * kPitch + 16 * (lane >> 4);
    // Accumulators: position 16 warp + g (c[0], c[1]) and + g + 8 (c[2],
    // c[3]), q rows 2t and 2t + 1.
    unsigned res[4];
    if constexpr (PATH == kMma) {
      const int8_t* qn = static_cast<const int8_t*>(q) + (size_t)n * 8 * D + g * D + 4 * t;
      int b[D / 32][2];
#pragma unroll
      for (int s = 0; s < D / 32; ++s) {
        b[s][0] = *reinterpret_cast<const int*>(qn + 32 * s);
        b[s][1] = *reinterpret_cast<const int*>(qn + 32 * s + 16);
      }
      cp_async_wait<0>();
      __syncthreads();
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < D / 32; ++s) {
        int a[4];
        ldmatrix_x4(reinterpret_cast<unsigned(&)[4]>(a), arow + 32 * s);
        mma_s8(c, a, b[s]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) res[i] = static_cast<unsigned>(c[i]);
    } else {
      const __nv_bfloat16* qn =
          static_cast<const __nv_bfloat16*>(q) + (size_t)n * 8 * D + g * D + 4 * t;
      uint2 b[D / 16];
#pragma unroll
      for (int s = 0; s < D / 16; ++s) b[s] = *reinterpret_cast<const uint2*>(qn + 16 * s);
      cp_async_wait<0>();
      __syncthreads();
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < D / 32; ++s) {
        unsigned w[4];
        ldmatrix_x4(w, arow + 32 * s);
        unsigned a0[4], a1[4];   // the k16 steps over bytes 0-15 and 16-31
        s8x4_to_bf16x4(w[0], a0[0], a0[2]);
        s8x4_to_bf16x4(w[1], a0[1], a0[3]);
        s8x4_to_bf16x4(w[2], a1[0], a1[2]);
        s8x4_to_bf16x4(w[3], a1[1], a1[3]);
        mma_bf16(c, a0, b[2 * s].x, b[2 * s].y);
        mma_bf16(c, a1, b[2 * s + 1].x, b[2 * s + 1].y);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) res[i] = __float_as_uint(c[i]);
    }
    const int p = 16 * warp + g;
    out_s[(2 * t) * kOutPitch + p] = res[0];
    out_s[(2 * t + 1) * kOutPitch + p] = res[1];
    out_s[(2 * t) * kOutPitch + p + 8] = res[2];
    out_s[(2 * t + 1) * kOutPitch + p + 8] = res[3];
  }
  __syncthreads();

  // The tile's 8 rows of kP words: 16 threads a row, 4 positions a thread.
  static_assert(kThreads * 4 == 8 * kP, "one 4-word piece a thread");
  const int r = tid / (kP / 4), j = 4 * (tid % (kP / 4));
  unsigned* orow = static_cast<unsigned*>(out) + ((size_t)n * 8 + r) * L + l0 + j;
  const unsigned* srow = out_s + r * kOutPitch + j;
  if (L % 4 == 0) {
    if (l0 + j < L) *reinterpret_cast<uint4*>(orow) = *reinterpret_cast<const uint4*>(srow);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (l0 + j + i < L) orow[i] = srow[i];
  }
}

// The launch of path PATH at D (64 or 128); R must be 8.
template <int PATH>
int launch(const void* q, const void* k, void* out, int N, int R, int L, int D, void* stream) {
  const long long tiles_per_row = (L + kP - 1) / kP;
  if (R != 8 || N <= 0 || L <= 0 || tiles_per_row * N > INT_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles_per_row * N);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* k8 = static_cast<const int8_t*>(k);
  const int per_row = static_cast<int>(tiles_per_row);
  if (D == 64)
    s8_dot_kernel<64, PATH><<<grid, kThreads, 0, st>>>(q, k8, out, L, per_row);
  else if (D == 128)
    s8_dot_kernel<128, PATH><<<grid, kThreads, 0, st>>>(q, k8, out, L, per_row);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace
}  // namespace ssd

// q [N, 8, D] int8, k [N, L, D] int8 -> out [N, 8, L] int32. D is 64 or
// 128, L >= 1, N >= 1 (the checks of ops/probes.py).
extern "C" int ssd_s8_dot_mma(const void* q, const void* k, void* out, int N,
                              int R, int L, int D, void* stream) {
  return ssd::launch<ssd::kMma>(q, k, out, N, R, L, D, stream);
}

// The same product on SIMT with __dp4a.
extern "C" int ssd_s8_dot_dp4a(const void* q, const void* k, void* out, int N,
                               int R, int L, int D, void* stream) {
  return ssd::launch<ssd::kDp4a>(q, k, out, N, R, L, D, stream);
}

// q [N, 8, D] bf16, k [N, L, D] int8 -> out [N, 8, L] fp32 (k cast to bf16).
extern "C" int ssd_s8_dot_bf16(const void* q, const void* k, void* out, int N,
                               int R, int L, int D, void* stream) {
  return ssd::launch<ssd::kBf16>(q, k, out, N, R, L, D, stream);
}
