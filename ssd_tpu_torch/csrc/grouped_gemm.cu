// Grouped GEMM over expert-sorted rows: the experts of a Qwen3-MoE layer.
//
// Replaces the TPU kernel that ssd_tpu's ragged MoE path calls: the megablox
// `gmm` Pallas kernel (jax.experimental.pallas.ops.tpu.megablox.gmm), called
// at ssd_tpu/models/transformer.py:268-273 in _moe_mlp (lax.ragged_dot, the
// same function, below 256 rows and off the TPU).
//
// Contract. x [N, K] holds rows sorted by expert: expert e owns rows
// [offs[e], offs[e+1]) of x, with offs [E+1] int32 running from 0 to N; w is
// [E, K, Nout]. out[r] = x[r] @ w[e(r)], accumulated in fp32 and rounded
// once to x's dtype, as gmm(..., preferred_element_type=f32).astype(x.dtype)
// does. K and Nout are multiples of 8 (16-byte rows); N, K and Nout need not
// be multiples of a tile, and any group may be empty.
//
// Tiles without a host read. The row tiles of all experts are numbered
// expert after expert, ceil(n_e / BM) of them for expert e. Their total is at
// most ceil(N / BM) + E, so the grid is that static bound times the column
// tiles. Each block forms the device-side prefix sum of ceil(n_e / BM) with
// one warp's shuffle scan (32 experts a step: at E = 128, four steps, which
// cost less than the eight dependent loads of a binary search in memory),
// takes the expert whose range holds its tile number, and returns if none
// does. So the wrapper never reads the group sizes on the host, and an MoE
// layer launches its three grouped GEMMs without a device-to-host sync.
//
// What bounds it on an H100 (Qwen3-30B-A3B, D 2048, Im 768, 128 experts,
// top-8). At prefill (the 8 serve prompts: N = 44,272 rows, gate K 2048 ->
// Nout 768) a call does 139 GFLOP and moves 0.6 GB: operations over the bf16
// tensor-core peak bound it (989 TFLOP/s, 0.141 ms). At decode (8 tokens:
// N = 64 rows over ~50 experts) it streams the selected experts' weights,
// ~157 MB for ~0.2 GFLOP: bytes over 3.35 TB/s bound it (0.047 ms). The
// design for both: bf16 runs on the tensor cores, mma.sync m16n8k16 with fp32
// accumulators on 128 x 128 output tiles (eight warps of 32 x 64); K advances
// in 32-wide slices that cp.async stages in shared memory two deep, so the
// next slice's weights stream while the tensor cores work on this one; the
// fragments come from shared memory by ldmatrix (B transposed on the fly, as
// w is stored [K, Nout]). A weight tile is read once per row tile, which at
// decode means once: a block there holds the one or two rows its expert got,
// and its time is the weight stream. fp32 (the dtype of the exactness checks)
// runs the same tiling on the SIMT units with fp32 FMAs. Next: wgmma with a
// TMA pipeline, and a short row tile for decode-sized groups.
#include "common.cuh"

namespace ssd {
namespace {

constexpr unsigned kFull = 0xffffffffu;

// This block's row tile: expert e_out, rows [row0, row_end) of x. False when
// blockIdx.x is past the last tile; every thread of the block gets the same
// answer.
template <int BM>
__device__ __forceinline__ bool find_row_tile(const int* __restrict__ offs, int E,
                                              int& e_out, int& row0, int& row_end) {
  __shared__ int tile[3];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int target = blockIdx.x;
    int carry = 0, found = -1, beg = 0, end = 0;
    for (int base = 0; base < E; base += 32) {
      const int e = base + lane;
      int lo = 0, hi = 0;
      if (e < E) {
        lo = offs[e];
        hi = offs[e + 1];
      }
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

// --- bf16: tensor cores ---

constexpr int kBM = 128;             // rows per block tile
constexpr int kBN = 128;             // output columns per block tile
constexpr int kBK = 32;              // K per shared-memory stage
constexpr int kThreads = 256;        // 8 warps: 4 (rows) x 2 (columns)
constexpr int kAStride = kBK + 8;    // bf16 per A row in shared memory (80 B)
constexpr int kBStride = kBN + 8;    // bf16 per B row in shared memory (272 B)
// The padded strides put the 8 rows an ldmatrix reads in 8 disjoint groups
// of banks.

__global__ void __launch_bounds__(kThreads)
    grouped_gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             const int* __restrict__ offs,
                             __nv_bfloat16* __restrict__ out, int K, int Nout,
                             int E) {
  __shared__ __align__(16) __nv_bfloat16 As[2][kBM * kAStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][kBK * kBStride];
  int e, row0, row_end;
  if (!find_row_tile<kBM>(offs, E, e, row0, row_end)) return;
  const int m_rows = row_end - row0;
  const int n0 = blockIdx.y * kBN;
  const __nv_bfloat16* xa = x + (size_t)row0 * K;
  const __nv_bfloat16* wb = w + (size_t)e * K * Nout + n0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // warp tile: rows 32 wm, cols 64 wn

  // One stage: A is kBM x kBK and B kBK x kBN, 512 chunks of 8 bf16 each,
  // two chunks of each per thread. Rows past the group, K past the end and
  // columns past Nout load zeros.
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 2, kc = (c & 3) * 8;
      const bool ok = r < m_rows && k0 + kc < K;
      cp_async16(&As[stage][r * kAStride + kc], ok ? xa + (size_t)r * K + k0 + kc : x, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      const int kr = c >> 4, nc = (c & 15) * 8;
      const bool ok = k0 + kr < K && n0 + nc < Nout;
      cp_async16(&Bs[stage][kr * kBStride + nc], ok ? wb + (size_t)(k0 + kr) * Nout + nc : w,
                 ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * kBK);
    cp_async_commit();
    cp_async_wait<1>();  // this slice has landed; the next one is in flight
    __syncthreads();
    const __nv_bfloat16* as = As[kt & 1];
    const __nv_bfloat16* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A fragments: lanes 0-15 address rows 0-15 at k, lanes 16-31 at k + 8.
      unsigned a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], as + (wm * 32 + mi * 16 + (lane & 15)) * kAStride + kk +
                               (lane >> 4) * 8);
      // B fragments of two 8-column tiles per ldmatrix: matrix m = lane / 8
      // holds k rows (m & 1) * 8 .. + 7 of column tile 2 nj + (m >> 1),
      // transposed into the column-fragment layout.
      const int mat = lane >> 3;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        unsigned b[4];
        ldmatrix_x4_trans(b, bs + (kk + (mat & 1) * 8 + (lane & 7)) * kBStride + wn * 64 +
                                 (2 * nj + (mat >> 1)) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // before the next iteration refills this stage
  }

  // Accumulator (mi, ni): rows g and g + 8 of the 16-row tile, columns 2c
  // and 2c + 1 of the 8-column tile; rounded once to bf16.
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mi * 16 + g + half * 8;
      if (r >= m_rows) continue;
      __nv_bfloat16* orow = out + (size_t)(row0 + r) * Nout + n0;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = wn * 64 + ni * 8 + 2 * c;
        if (n0 + col < Nout)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

// --- fp32: SIMT ---

constexpr int kSBM = 64;   // rows per block tile
constexpr int kSBN = 64;   // output columns per block tile
constexpr int kSBK = 16;   // K per shared-memory tile; 16 x 16 threads, 4 x 4 each

__global__ void __launch_bounds__(kThreads)
    grouped_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const int* __restrict__ offs, float* __restrict__ out,
                            int K, int Nout, int E) {
  __shared__ float As[kSBK][kSBM + 4];  // k-major: a row's values broadcast
  __shared__ float Bs[kSBK][kSBN + 4];
  int e, row0, row_end;
  if (!find_row_tile<kSBM>(offs, E, e, row0, row_end)) return;
  const int m_rows = row_end - row0;
  const int n0 = blockIdx.y * kSBN;
  const float* xa = x + (size_t)row0 * K;
  const float* wb = w + (size_t)e * K * Nout + n0;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSBK) {
    for (int i = tid; i < kSBM * kSBK; i += kThreads) {
      const int r = i / kSBK, kk = i % kSBK;
      As[kk][r] = r < m_rows && k0 + kk < K ? xa[(size_t)r * K + k0 + kk] : 0.f;
    }
    for (int i = tid; i < kSBK * kSBN; i += kThreads) {
      const int kk = i / kSBN, n = i % kSBN;
      Bs[kk][n] = k0 + kk < K && n0 + n < Nout ? wb[(size_t)(k0 + kk) * Nout + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= m_rows) continue;
    float* orow = out + (size_t)(row0 + r) * Nout + n0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + tx + 16 * j < Nout) orow[tx + 16 * j] = acc[i][j];
  }
}

}  // namespace
}  // namespace ssd

extern "C" int ssd_grouped_gemm(int dtype, const void* x, const void* w,
                                const int* group_offsets, void* out, int N, int K,
                                int Nout, int E, void* stream) {
  if (N == 0 || Nout == 0) return cudaSuccess;
  if (E <= 0 || K <= 0 || K % 8 != 0 || Nout % 8 != 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ssd::kBFloat16) {
    const dim3 grid((N + ssd::kBM - 1) / ssd::kBM + E, (Nout + ssd::kBN - 1) / ssd::kBN);
    ssd::grouped_gemm_bf16_kernel<<<grid, ssd::kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        group_offsets, static_cast<__nv_bfloat16*>(out), K, Nout, E);
    return cudaGetLastError();
  }
  if (dtype == ssd::kFloat32) {
    const dim3 grid((N + ssd::kSBM - 1) / ssd::kSBM + E, (Nout + ssd::kSBN - 1) / ssd::kSBN);
    ssd::grouped_gemm_f32_kernel<<<grid, ssd::kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), group_offsets,
        static_cast<float*>(out), K, Nout, E);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
