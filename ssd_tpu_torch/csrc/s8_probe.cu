// The int8 dot-rate probe: out[n, r, l] = sum_d q[n, r, d] * k[n, l, d] for
// N batched row blocks, as s8 x s8 -> s32 and as the same dot after k is cast
// to bf16 with fp32 accumulation.
//
// Replaces the TPU kernels bench/s8_probe.py::_kernel_s8 and ::_kernel_bf16
// (one pallas_call each), which time the chip's int8 dot against its bf16 dot
// at the int8 paged kernel's tile: N = 64 row blocks, R = 8 query rows,
// L = 512 positions, D = 128 (2 * hd) contraction. Three paths:
//  - ssd_s8_dot_mma: tensor cores, mma.sync m16n8k32 s8 -> s32. A warp owns
//    one row block's 8 query rows (rows 8..15 of the 16-row A tile are zero)
//    and a run of 8-position column tiles; each tile is D / 32 = 4 mma steps.
//    Fragments come straight from global memory (4 bytes a lane per operand
//    register; q is 1 KB per row block and stays in L1).
//  - ssd_s8_dot_dp4a: SIMT, one thread per (row block, position) computing
//    its 8 rows with __dp4a over the position's k row (16-byte loads) and the
//    block's q rows in shared memory.
//  - ssd_s8_dot_bf16: tensor cores, mma.sync m16n8k16 bf16 -> fp32, q in
//    bf16 and each k byte pair cast to a bf16 pair in registers.
// Integers of magnitude <= 127 are exact in bf16 and every product sum is
// below 2^24, so all three paths are exact: their plain version is the fp64
// product (ops/probes.py).
//
// What bounds it on an H100: bytes. k is N * L * D = 4 MiB of int8 and the
// output 1 MiB (s32) or 1 MiB (fp32), against 2 * N * R * L * D = 67 MOP of
// work, far below the ~590 operations per byte where int8 tensor cores
// would bound it.
#include "common.cuh"

namespace ssd {
namespace {

constexpr int kProbeWarps = 4;
constexpr int kProbeThreads = kProbeWarps * 32;

// Grid (ceil(L / (8 * kProbeWarps * tiles_per_warp)), N); R must be 8 and D a
// multiple of 32. Lane (g = lane / 4, t = lane % 4): A row g, B column g.
__global__ void __launch_bounds__(kProbeThreads)
    s8_dot_mma_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                      int* __restrict__ out, int L, int D, int tiles_per_warp) {
  const int n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int8_t* qn = q + (size_t)n * 8 * D;
  const int8_t* kn = k + (size_t)n * L * D;
  int* on = out + (size_t)n * 8 * L;
  const int tile0 = (blockIdx.x * kProbeWarps + warp) * tiles_per_warp;
  for (int tt = 0; tt < tiles_per_warp; ++tt) {
    const int l0 = (tile0 + tt) * 8;
    if (l0 >= L) break;
    int c[4] = {0, 0, 0, 0};
    const int8_t* krow = kn + (size_t)(l0 + g) * D;
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int a[4] = {*reinterpret_cast<const int*>(qn + g * D + d0 + 4 * t), 0,
                        *reinterpret_cast<const int*>(qn + g * D + d0 + 16 + 4 * t), 0};
      const int b[2] = {*reinterpret_cast<const int*>(krow + d0 + 4 * t),
                        *reinterpret_cast<const int*>(krow + d0 + 16 + 4 * t)};
      mma_s8(c, a, b);
    }
    // c[0], c[1]: row g, columns 2t and 2t+1 of the tile (c[2], c[3] are the
    // zero rows 8..15).
    *reinterpret_cast<int2*>(on + (size_t)g * L + l0 + 2 * t) = make_int2(c[0], c[1]);
  }
}

// Grid (ceil(L / kProbeThreads), N); one thread per position, R = 8 rows.
template <int D>
__global__ void __launch_bounds__(kProbeThreads)
    s8_dot_dp4a_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                       int* __restrict__ out, int L) {
  constexpr int W = D / 4;
  __shared__ __align__(16) int q_s[8][W];
  const int n = blockIdx.y;
  for (int e = threadIdx.x; e < 8 * W; e += kProbeThreads)
    q_s[e / W][e % W] = reinterpret_cast<const int*>(q + (size_t)n * 8 * D)[e];
  __syncthreads();
  const int l = blockIdx.x * kProbeThreads + threadIdx.x;
  if (l >= L) return;
  const int8_t* krow = k + ((size_t)n * L + l) * D;
  int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int w0 = 0; w0 < W; w0 += 4) {
    const int4 k4 = *reinterpret_cast<const int4*>(krow + 4 * w0);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int4 qa = *reinterpret_cast<const int4*>(&q_s[r][w0]);
      acc[r] = __dp4a(qa.x, k4.x, acc[r]);
      acc[r] = __dp4a(qa.y, k4.y, acc[r]);
      acc[r] = __dp4a(qa.z, k4.z, acc[r]);
      acc[r] = __dp4a(qa.w, k4.w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) out[((size_t)n * 8 + r) * L + l] = acc[r];
}

// The mma layout of s8_dot_mma_kernel with bf16 m16n8k16: A row g holds
// columns 2t, 2t+1 (a[0]) and 2t+8, 2t+9 (a[2]); B column g the same rows.
__global__ void __launch_bounds__(kProbeThreads)
    s8_dot_bf16_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                       float* __restrict__ out, int L, int D, int tiles_per_warp) {
  const int n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qn = q + (size_t)n * 8 * D;
  const int8_t* kn = k + (size_t)n * L * D;
  float* on = out + (size_t)n * 8 * L;
  const int tile0 = (blockIdx.x * kProbeWarps + warp) * tiles_per_warp;
  for (int tt = 0; tt < tiles_per_warp; ++tt) {
    const int l0 = (tile0 + tt) * 8;
    if (l0 >= L) break;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const int8_t* krow = kn + (size_t)(l0 + g) * D;
    for (int d0 = 0; d0 < D; d0 += 16) {
      const unsigned a[4] = {
          *reinterpret_cast<const unsigned*>(qn + g * D + d0 + 2 * t), 0u,
          *reinterpret_cast<const unsigned*>(qn + g * D + d0 + 8 + 2 * t), 0u};
      const unsigned b[2] = {
          s8x2_to_bf16x2(*reinterpret_cast<const short*>(krow + d0 + 2 * t)),
          s8x2_to_bf16x2(*reinterpret_cast<const short*>(krow + d0 + 8 + 2 * t))};
      mma_bf16(c, a, b[0], b[1]);
    }
    *reinterpret_cast<float2*>(on + (size_t)g * L + l0 + 2 * t) = make_float2(c[0], c[1]);
  }
}

constexpr int kTilesPerWarp = 4;

dim3 mma_grid(int N, int L) {
  const int per_block = 8 * kProbeWarps * kTilesPerWarp;
  return dim3((L + per_block - 1) / per_block, N);
}

}  // namespace
}  // namespace ssd

// q [N, 8, D] int8, k [N, L, D] int8 -> out [N, 8, L] int32. L a multiple
// of 8, D of 32.
extern "C" int ssd_s8_dot_mma(const void* q, const void* k, void* out, int N,
                              int R, int L, int D, void* stream) {
  if (R != 8 || L % 8 || D % 32 || N <= 0) return cudaErrorInvalidValue;
  ssd::s8_dot_mma_kernel<<<ssd::mma_grid(N, L), ssd::kProbeThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<int*>(out), L, D, ssd::kTilesPerWarp);
  return cudaGetLastError();
}

// The same product on SIMT with __dp4a. D is 64 or 128.
extern "C" int ssd_s8_dot_dp4a(const void* q, const void* k, void* out, int N,
                               int R, int L, int D, void* stream) {
  if (R != 8 || N <= 0 || L <= 0) return cudaErrorInvalidValue;
  const dim3 grid((L + ssd::kProbeThreads - 1) / ssd::kProbeThreads, N);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* q8 = static_cast<const int8_t*>(q);
  const auto* k8 = static_cast<const int8_t*>(k);
  if (D == 64)
    ssd::s8_dot_dp4a_kernel<64><<<grid, ssd::kProbeThreads, 0, st>>>(q8, k8, static_cast<int*>(out), L);
  else if (D == 128)
    ssd::s8_dot_dp4a_kernel<128><<<grid, ssd::kProbeThreads, 0, st>>>(q8, k8, static_cast<int*>(out), L);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// q [N, 8, D] bf16, k [N, L, D] int8 -> out [N, 8, L] fp32 (k cast to bf16).
// L a multiple of 8, D of 16.
extern "C" int ssd_s8_dot_bf16(const void* q, const void* k, void* out, int N,
                               int R, int L, int D, void* stream) {
  if (R != 8 || L % 8 || D % 16 || N <= 0) return cudaErrorInvalidValue;
  ssd::s8_dot_bf16_kernel<<<ssd::mma_grid(N, L), ssd::kProbeThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<float*>(out), L, D, ssd::kTilesPerWarp);
  return cudaGetLastError();
}
