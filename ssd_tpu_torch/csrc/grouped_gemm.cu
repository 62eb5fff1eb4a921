// Grouped GEMM over expert-sorted rows: the experts of a Qwen3-MoE layer.
//
// Replaces the TPU kernel that ssd_tpu's ragged MoE path calls: the megablox
// `gmm` Pallas kernel (jax.experimental.pallas.ops.tpu.megablox.gmm), called
// at ssd_tpu/models/transformer.py:268-273 in _moe_mlp (lax.ragged_dot, the
// same function, below 256 rows and off the TPU).
//
// Contract. x [N, K] holds rows sorted by expert: expert e owns rows
// [offs[e], offs[e+1]) of x, with offs [E+1] int32 rising from 0 to at most
// N (rows from offs[E] on belong to no expert and are not written: another
// rank's rows under expert parallelism); w is [E, K, Nout]. out[r] =
// x[r] @ w[e(r)], accumulated in fp32 and rounded once to x's dtype, as
// gmm(..., preferred_element_type=f32).astype(x.dtype) does. K and Nout are
// multiples of 8 (16-byte rows); N, K and Nout need not be multiples of a
// tile, and any group may be empty.
//
// Tiles without a host read. The row tiles of all experts are numbered
// expert after expert, ceil(n_e / BM) of them for expert e. Their total is at
// most ceil(N / BM) + min(E, N), since at most N groups hold a row, so the
// bf16 grid is that static bound times the column tiles (fp32's keeps + E).
// At a b1 decode dispatch (8 rows) that is 9 row tiles' blocks where + E
// launched 129, all but 8 of them returning at once. Each block forms the
// device-side prefix sum of ceil(n_e / BM) with one warp's shuffle scan (32
// experts a step: at E = 128, four steps, which cost less than the eight
// dependent loads of a binary search in memory), takes the expert whose range holds its tile number, and returns if none
// does. So the wrapper never reads the group sizes on the host, and an MoE
// layer launches its three grouped GEMMs without a device-to-host sync.
//
// What bounds it on an H100 (Qwen3-30B-A3B, D 2048, Im 768, 128 experts,
// top-8). At prefill (the 8 serve prompts: N = 44,272 rows) the gate call
// (K 2048 -> Nout 768) moves x 181 MB, the experts' w 403 MB and out 68 MB:
// 0.652 GB, 0.195 ms at 3.35 TB/s; its 139 GFLOP take 0.141 ms at the bf16
// tensor-core peak (989 TFLOP/s). So bytes bound it, with the tensor cores
// close behind: the kernel has to stream near the HBM rate and multiply near
// the wgmma rate at once. At decode (8 tokens: N = 64 rows over ~50
// experts) it streams the selected experts' weights, ~157 MB for ~0.2
// GFLOP: bytes bound it (0.047 ms), and the rows are too few to fill any
// tensor-core tile.
//
// Design, bf16 (the serving dtype), two routes that the wrapper picks from
// N and E alone (ops/moe.py::grouped_gemm_route), never from a device read:
//  - prefill: 128 x 256 output tiles, K in 64-wide slices. TMA
//    (cp.async.bulk.tensor, 128-byte swizzle) fills a four-stage ring of
//    48 KB stages from two tensor maps, x [N, K] (2-D, K-major) and w
//    [E, K, Nout] (3-D, read MN-major); one producer warp keeps the ring
//    full through full/empty mbarriers, and two consumer warpgroups run
//    wgmma.mma_async m64n256k16 (bf16 in, fp32 sums; B transposed) on the
//    swizzled tiles, one stage's group in flight while the next is issued.
//    Consecutive blocks take the column tiles of one row tile, so a row
//    tile's x and its expert's weights are read from HBM about once. The
//    epilogue stages the tile in shared memory and writes whole 512-byte
//    rows: the accumulator fragments' own 4-byte stores (8 rows x 16 bytes
//    a warp instruction) had cost a tenth of the gate call and a sixth of
//    down on the card. A 128 x 256 tile reads 25% fewer L2 bytes per flop
//    than 128 x 128 and measured 1.10-1.15x faster; clusters sharing x by
//    TMA multicast, and a persistent grid, measured slower and were left
//    out. A tile's TMA box may run past its group's end: those rows (the
//    next expert's, or zeros past N) are read and never stored.
//  - decode: the product turned around, out^T = w^T . x^T: 64 weight
//    columns are wgmma's M operand (m64n16k16, A transposed) and the
//    tile's 16 rows its N, so a group of 1-2 rows costs one 16-row tile
//    and not a 128-row one. An eight-stage ring of 10 KB per block keeps the
//    weight stream, not latency, setting the time.
// The epilogue rounds the fp32 sums once to bf16 and stores only rows in
// [row0, row_end) and columns below Nout. fp32 (the dtype of the exactness
// checks) runs a 64 x 64 tiling on the SIMT units with fp32 FMAs. The
// tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// from the driver through cudaGetDriverEntryPoint) and passed as
// __grid_constant__ kernel parameters.
#include "common.cuh"
#include "hopper.cuh"

namespace ssd {
namespace {

// This block's row tile, blockIdx.x.
template <int BM>
__device__ __forceinline__ bool find_row_tile(const int* __restrict__ offs, int E,
                                              int& e_out, int& row0, int& row_end) {
  return find_row_tile_at<BM>(offs, E, blockIdx.x, e_out, row0, row_end);
}

// --- bf16: wgmma on TMA-fed shared memory ---

namespace gmm {
// Prefill route: 128 x 256 output tiles, two consumer warpgroups of 64 rows.
constexpr int kBM = 128;
constexpr int kBN = 256;
constexpr int kBK = 64;                          // one 128-byte swizzle row of bf16
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kWgThreads = kConsumers * 128 + 32;  // + the producer warp
constexpr int kABytes = kBM * kBK * 2;           // 16 KB of x rows
constexpr int kPanel = kBK * 64 * 2;             // 8 KB: 64 K rows x 64 columns of w[e]
constexpr int kStageBytes = kABytes + (kBN / 64) * kPanel;  // 48 KB
constexpr int kSmem = kStages * kStageBytes + 1024;         // + the 1024-byte alignment
// Decode route (out^T = w^T . x^T): 64 output columns are wgmma's M, the
// tile's 16 rows its N.
constexpr int kDM = 64;
constexpr int kDR = 16;
constexpr int kDStages = 8;
constexpr int kDThreads = 128 + 32;
constexpr int kDWBytes = kBK * kDM * 2;          // 8 KB of w[e]
constexpr int kDStageBytes = kDWBytes + kDR * kBK * 2;  // + 2 KB of x rows
constexpr int kDSmem = kDStages * kDStageBytes + 1024;
static_assert(kStageBytes % 1024 == 0 && kDStageBytes % 1024 == 0 && kDWBytes % 1024 == 0,
              "TMA tiles with the 128-byte swizzle start 1024-byte aligned");
}  // namespace gmm

// Prefill route. Block b computes row tile b / col_tiles (find_row_tile_at)
// times columns [n0, n0 + 256), n0 = 256 (b % col_tiles): consecutive blocks
// share the tile's x rows and its expert's weights in L2. Warp 8 is the
// producer: one lane waits for a free stage, announces its bytes and sends
// the TMA loads (x rows [row0, row0 + 128) x K slice, and four 64-column
// panels of w[e]'s K slice). Warpgroups 0 and 1 wait for a full stage and
// run four m64n256k16 wgmmas on it (rows 64 wg ..), keeping one stage's
// group in flight: a stage is released when the group that read it is done.
__global__ void __launch_bounds__(gmm::kWgThreads, 1)
    grouped_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap wmap,
                              const int* __restrict__ offs, __nv_bfloat16* __restrict__ out,
                              int K, int Nout, int E, int col_tiles) {
  using namespace gmm;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  int e, row0, row_end;
  if (!find_row_tile_at<kBM>(offs, E, blockIdx.x / col_tiles, e, row0, row_end)) return;
  const int n0 = (blockIdx.x % col_tiles) * kBN;
  unsigned char* smem = hopper::align1024(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int nk = (K + kBK - 1) / kBK;

  if (warp == 4 * kConsumers) {
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        hopper::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        unsigned char* st = smem + s * kStageBytes;
        hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
        hopper::tma_load_2d(st, &xmap, &full[s], kt * kBK, row0);
#pragma unroll
        for (int p = 0; p < kBN / 64; ++p)
          hopper::tma_load_3d(st + kABytes + p * kPanel, &wmap, &full[s], n0 + 64 * p, kt * kBK, e);
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    hopper::mbar_wait(&full[s], (kt / kStages) & 1);
    const unsigned char* a = smem + s * kStageBytes + wg * 64 * 128;
    const unsigned char* b = smem + s * kStageBytes + kABytes;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hopper::wgmma_m64n256k16_bt(acc, hopper::gmma_desc(a + 32 * kk, 16, 1024),
                                  hopper::gmma_desc(b + 2048 * kk, kPanel, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the group of stage kt-1 is done
    hopper::fence_regs(acc);
    if (kt > 0 && threadIdx.x % 128 == 0) hopper::mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // The tile goes out through shared memory (the ring, read by now): warp
  // w's 16 rows, rounded once to bf16, then one 512-byte row a store. Rows
  // past the group's end were read (the next expert's rows, or TMA's zeros
  // past N) and are not stored; nor are columns past Nout.
  const int g = lane / 4, t = lane % 4;
  constexpr int kStride = kBN * 2 + 16;  // padded: the fragment writes hit 32 banks
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  unsigned char* stg = smem + warp * 16 * kStride;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      *reinterpret_cast<unsigned*>(stg + (g + 8 * half) * kStride + (8 * j + 2 * t) * 2) =
          bf16x2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
  __syncwarp();
  const int r0 = row0 + wg * 64 + (warp % 4) * 16, col = n0 + 8 * lane;
  for (int rr = 0; rr < 16 && r0 + rr < row_end; ++rr)
    if (col < Nout)
      *reinterpret_cast<uint4*>(out + (size_t)(r0 + rr) * Nout + col) =
          *reinterpret_cast<const uint4*>(stg + rr * kStride + lane * 16);
}

// Decode route: the groups hold a few rows each, so a block takes a
// 16-row tile and 64 output columns, and its time is the stream of w[e]'s
// K x 64 slab. wgmma computes out^T: M = the 64 columns of w[e] (A, read
// MN-major: trans-a), N = the tile's 16 rows of x (B, K-major), through an
// eight-stage ring of 10 KB, so each block keeps up to 80 KB of the weight
// stream in flight.
__global__ void __launch_bounds__(gmm::kDThreads)
    grouped_gemm_wgmma_decode_kernel(const __grid_constant__ CUtensorMap xmap,
                                     const __grid_constant__ CUtensorMap wmap,
                                     const int* __restrict__ offs,
                                     __nv_bfloat16* __restrict__ out, int K, int Nout, int E,
                                     int col_tiles) {
  using namespace gmm;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kDStages], empty[kDStages];
  int e, row0, row_end;
  if (!find_row_tile_at<kDR>(offs, E, blockIdx.x / col_tiles, e, row0, row_end)) return;
  const int n0 = (blockIdx.x % col_tiles) * kDM;
  unsigned char* smem = hopper::align1024(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int nk = (K + kBK - 1) / kBK;

  if (warp == 4) {
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kDStages;
        hopper::mbar_wait(&empty[s], ((kt / kDStages) & 1) ^ 1);
        unsigned char* st = smem + s * kDStageBytes;
        hopper::mbar_arrive_expect_tx(&full[s], kDStageBytes);
        hopper::tma_load_3d(st, &wmap, &full[s], n0, kt * kBK, e);
        hopper::tma_load_2d(st + kDWBytes, &xmap, &full[s], kt * kBK, row0);
      }
    }
    return;
  }

  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kDStages;
    hopper::mbar_wait(&full[s], (kt / kDStages) & 1);
    const unsigned char* a = smem + s * kDStageBytes;
    const unsigned char* b = a + kDWBytes;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      hopper::wgmma_m64n16k16_at(acc, hopper::gmma_desc(a + 2048 * kk, kDWBytes, 1024),
                                 hopper::gmma_desc(b + 32 * kk, 16, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(acc);
    if (kt > 0 && threadIdx.x == 0) hopper::mbar_arrive(&empty[(kt - 1) % kDStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // acc[4j + 2 half + u]: column n0 + 16 warp + g + 8 half of row
  // row0 + 8j + 2t + u.
  const int g = lane / 4, t = lane % 4;
  const int m_rows = row_end - row0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int col = n0 + 16 * warp + g + 8 * half;
    if (col >= Nout) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = 8 * j + 2 * t + u;
        if (r < m_rows) out[(size_t)(row0 + r) * Nout + col] = __float2bfloat16(acc[4 * j + 2 * half + u]);
      }
  }
}

// --- fp32: SIMT ---

constexpr int kThreads = 256;  // 16 x 16 threads
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

namespace ssd {
namespace {

// A bf16 tensor map with the 128-byte swizzle (hopper::encode_map).
bool encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box) {
  return hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_128B,
                            base, rank, dims, strides, box);
}

// x [N, K] in boxes of 64 K x `rows` rows; w [E, K, Nout] in boxes of 64
// columns x 64 K of one expert.
bool encode_maps(CUtensorMap* xmap, CUtensorMap* wmap, const void* x, const void* w, int N,
                 int K, int Nout, int E, int rows) {
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t xs[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xb[2] = {gmm::kBK, (cuuint32_t)rows};
  const cuuint64_t wd[3] = {(cuuint64_t)Nout, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t ws[2] = {(cuuint64_t)Nout * 2, (cuuint64_t)K * Nout * 2};
  const cuuint32_t wb[3] = {64, gmm::kBK, 1};
  return encode_bf16(xmap, x, 2, xd, xs, xb) && encode_bf16(wmap, w, 3, wd, ws, wb);
}

bool bad_shape(int N, int K, int Nout, int E) {
  return E <= 0 || K <= 0 || K % 8 != 0 || Nout % 8 != 0 || N < 0;
}

// The bf16 grids' bound on the row tiles of N rows over E groups.
long long row_tile_bound(int N, int BM, int E) {
  return (long long)(N + BM - 1) / BM + (E < N ? E : N);
}


}  // namespace
}  // namespace ssd

// Prefill route for bf16 (and the fp32 SIMT kernel).
extern "C" int ssd_grouped_gemm(int dtype, const void* x, const void* w,
                                const int* group_offsets, void* out, int N, int K,
                                int Nout, int E, void* stream) {
  using namespace ssd;
  if (N == 0 || Nout == 0) return cudaSuccess;
  if (bad_shape(N, K, Nout, E)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    CUtensorMap xmap, wmap;
    if (!encode_maps(&xmap, &wmap, x, w, N, K, Nout, E, gmm::kBM)) return cudaErrorInvalidValue;
    const int col_tiles = (Nout + gmm::kBN - 1) / gmm::kBN;
    const long long blocks = row_tile_bound(N, gmm::kBM, E) * col_tiles;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        grouped_gemm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gmm::kSmem);
    if (err != cudaSuccess) return err;
    grouped_gemm_wgmma_kernel<<<(unsigned)blocks, gmm::kWgThreads, gmm::kSmem, st>>>(
        xmap, wmap, group_offsets, static_cast<__nv_bfloat16*>(out), K, Nout, E, col_tiles);
    return cudaGetLastError();
  }
  if (dtype == kFloat32) {
    const dim3 grid((N + kSBM - 1) / kSBM + E, (Nout + kSBN - 1) / kSBN);
    grouped_gemm_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), group_offsets,
        static_cast<float*>(out), K, Nout, E);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// Decode route, bf16 only.
extern "C" int ssd_grouped_gemm_decode(const void* x, const void* w, const int* group_offsets,
                                       void* out, int N, int K, int Nout, int E,
                                       void* stream) {
  using namespace ssd;
  if (N == 0 || Nout == 0) return cudaSuccess;
  if (bad_shape(N, K, Nout, E)) return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  if (!encode_maps(&xmap, &wmap, x, w, N, K, Nout, E, gmm::kDR)) return cudaErrorInvalidValue;
  const int col_tiles = (Nout + gmm::kDM - 1) / gmm::kDM;
  const long long blocks = row_tile_bound(N, gmm::kDR, E) * col_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(grouped_gemm_wgmma_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         gmm::kDSmem);
  if (err != cudaSuccess) return err;
  grouped_gemm_wgmma_decode_kernel<<<(unsigned)blocks, gmm::kDThreads, gmm::kDSmem,
                                     static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, group_offsets, static_cast<__nv_bfloat16*>(out), K, Nout, E, col_tiles);
  return cudaGetLastError();
}

// Dynamic shared memory of a bf16 route's kernel (for the smoke run's
// resource report).
extern "C" int ssd_grouped_gemm_smem_bytes(int decode) {
  return decode ? ssd::gmm::kDSmem : ssd::gmm::kSmem;
}
