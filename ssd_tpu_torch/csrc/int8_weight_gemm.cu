// W8A16 GEMM: y = (x @ q^T) * s over int8 weights with per-output-channel
// scales, optionally grouped (the experts of a Qwen3-MoE layer). K9.
//
// Replaces no Pallas kernel. Under quantization="int8" the JAX package
// computes every linear layer as (x @ q.astype(x.dtype)) * s
// (ssd_tpu/models/transformer.py:153-161 `_mm`, :224-233 `row_mm`,
// :265-278 `rdot`, :290-293 `emm`, :415-417 the LM head;
// ssd_tpu/models/eagle3.py:93-104, :175-177), and XLA fuses the int8 -> bf16
// convert into the dot's operand, so HBM reads only the int8 bytes
// (ssd_tpu/utils/quant.py:4-7). In plain PyTorch the convert writes a bf16
// copy of the weight first (5 bytes a weight where bf16 reads 2), so the
// port needs its own kernel for int8 weights to pay off.
//
// Contract. x [M, K] (bf16 or fp32), q int8 [G, N, K] (K-contiguous: the
// port stores int8 weights [out, in], utils/quant.py), s fp32 [G, N]. With
// group offsets offs [G+1] (int32, on the device, from 0 to M), group g owns
// rows [offs[g], offs[g+1]) of x; without them G = 1 and every row is group
// 0. out[m, n] = s[g(m), n] * sum_k x[m, k] q[g(m), n, k], summed in fp32,
// scaled once and rounded once to the output type (bf16 or fp32; fp32 x
// gives fp32). K is a multiple of 16; M and N are any; an empty group writes
// nothing.
//
// What bounds it on an H100. At decode (M = 8 rows of the Llama-3.2-1B
// geometry) it streams the weights, ~1 byte a weight for 2 operations each:
// bytes bound it, and the int8 weights halve them against bf16. At prefill
// (M = 5534) it is ~5534 operations a byte: the tensor cores bound it.
//
// Design, bf16 x: mma.sync m16n8k16 (bf16 in, fp32 sums) on tiles fed by a
// cp.async ring. A block of four warps computes BM x BN outputs over the
// whole of K; each stage holds a K slice of BK of x (bf16) and of the BN
// weight rows (int8), and each warp takes a quarter of every slice, so the
// four warps stream the weights together and sum partial tiles that a
// shared-memory pass adds in a fixed order at the end (no atomics: the same
// inputs give the same bits, eager or replayed in a graph). A weight
// fragment is one 32-bit shared load of four int8 values, widened in
// registers to two bf16 pairs exactly (|q| <= 127 needs 8 significant
// bits): the bytes are biased into the mantissa of 2^23 and the bias
// subtracted in fp32, with no int-to-float conversion instructions. The four
// values are four consecutive k, which m16n8k16's fragment expects at k
// 2t, 2t+1, 2t+8, 2t+9: x's fragment is loaded with the same permutation of
// k, and a sum over k does not depend on it. Two tile shapes, picked by the
// wrapper from M, N and G alone (ops/linear.py::int8_linear_route): 16 x
// 16 tiles with 256-wide K slices and a four-stage ring for decode-sized
// groups (narrow tiles, so that even N = 512 makes 32 blocks to stream the
// weights), 64 x 64 tiles with 64-wide slices and three stages for prefill
// and for wide outputs (the LM head, gate/up) past 16 rows.
// The scale is applied in the epilogue, once per output.
//
// Design, fp32 x: fp32 FMAs on 64 x 64 tiles with 16-wide K slices, the int8
// values widened exactly to fp32 as they are staged; x is never rounded.
//
// Groups without a host read: the row tiles of all groups are numbered
// group after group (find_row_tile_at, shared with the grouped GEMM K6);
// the grid is the static bound ceil(M / BM) + min(G, M) row tiles times the
// column tiles, and a block past the last tile returns at once. So a
// captured CUDA graph serves any routing.
#include "common.cuh"

namespace ssd {
namespace {

namespace w8 {
constexpr int kThreads = 128;  // four warps, each a quarter of every K slice

// A block's BM x BN outputs, K slices of BK a stage, STAGES stages.
template <int BM_, int BN_, int BK_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static_assert(BM % 16 == 0 && BN % 8 == 0 && BK % 64 == 0,
                "m16 row tiles, n8 column tiles, a k16 step per warp");
  static constexpr int kWRow = BK + 16;        // bytes of a weight row in shared memory
  static constexpr int kXRow = 2 * BK + 32;    // bytes of an x row
  static constexpr int kStage = BN * kWRow + BM * kXRow;
  static constexpr int kRedRow = BN + 8;       // floats of a row of a warp's partial tile
  static constexpr int kRed = 4 * BM * kRedRow * 4;
  static constexpr int kSmem = STAGES * kStage > kRed ? STAGES * kStage : kRed;
};
// The two routes (ops/linear.py::INT8_ROUTES): 0 decode-sized groups, where
// the weights' bytes bound the product and narrow column tiles give enough
// blocks to stream them (N = 2048 makes 128); 1 prefill.
using Small = Tile<16, 16, 256, 4>;
using Large = Tile<64, 64, 64, 3>;
}  // namespace w8

// Four int8 values (one 32-bit word) as two bf16 pairs, exactly: byte b,
// biased to b + 128 in [0, 255], becomes the low mantissa byte of 2^23, and
// 2^23 + 128 is subtracted in fp32; the integer result fits bf16, so its
// top 16 bits are it. lo = (byte 0, byte 1), hi = (byte 2, byte 3), each
// with the first value in the low half.
__device__ __forceinline__ void s8x4_to_bf16x4(unsigned w, unsigned& lo, unsigned& hi) {
  const unsigned u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// This block's rows: group g, rows [row0, row_end) of x; false past the
// last row tile. Without offsets, row tile blockIdx.x of group 0.
template <int BM>
__device__ __forceinline__ bool w8_rows(const int* __restrict__ offs, int M, int G, int& g,
                                        int& row0, int& row_end) {
  if (offs == nullptr) {
    g = 0;
    row0 = blockIdx.x * BM;
    row_end = min(row0 + BM, M);
    return row0 < M;
  }
  return find_row_tile_at<BM>(offs, G, blockIdx.x, g, row0, row_end);
}

// bf16 x: block (row tile blockIdx.x, columns [BN blockIdx.y, + BN)).
template <typename Tl, typename OutT>
__global__ void __launch_bounds__(w8::kThreads)
    w8a16_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, const int* __restrict__ offs,
                     OutT* __restrict__ out, int M, int N, int K, int G) {
  using namespace w8;
  constexpr int BM = Tl::BM, BN = Tl::BN, BK = Tl::BK, STAGES = Tl::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  int g, row0, row_end;
  if (!w8_rows<BM>(offs, M, G, g, row0, row_end)) return;
  const int rows = row_end - row0;
  const int n0 = blockIdx.y * BN;
  const int8_t* wg = w + (size_t)g * N * K;
  const __nv_bfloat16* xr = x + (size_t)row0 * K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;

  // One stage: the BN weight rows' and the tile's x rows' K slice
  // [k0, k0 + BK), 16 bytes a copy; rows past N or the group, and k past K,
  // read as zeros.
  auto load_stage = [&](int buf, int k0) {
    unsigned char* ws = smem + buf * Tl::kStage;
    unsigned char* xs = ws + BN * Tl::kWRow;
    for (int c = tid; c < BN * BK / 16; c += kThreads) {
      const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
      const bool ok = n0 + r < N && k0 + kc < K;
      cp_async16(ws + r * Tl::kWRow + kc, ok ? wg + (size_t)(n0 + r) * K + k0 + kc : w, ok);
    }
    for (int c = tid; c < BM * BK / 8; c += kThreads) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const bool ok = r < rows && k0 + kc < K;
      cp_async16(xs + r * Tl::kXRow + 2 * kc, ok ? xr + (size_t)r * K + k0 + kc : x, ok);
    }
  };

  constexpr int MT = BM / 16, NT = BN / 8;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt is in; every warp is done with stage kt - 1
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    cp_async_commit();
    const unsigned char* ws = smem + (kt % STAGES) * Tl::kStage;
    const unsigned char* xs = ws + BN * Tl::kWRow;
#pragma unroll
    for (int ks = 0; ks < BK / 64; ++ks) {
      const int kb = warp * (BK / 4) + ks * 16;   // this warp's k16 step
      unsigned a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // x[row][kb + 4t .. 4t+3] as (2t, 2t+1) and (2t+8, 2t+9).
        const uint2 lo = *reinterpret_cast<const uint2*>(
            xs + (mt * 16 + gr) * Tl::kXRow + 2 * (kb + 4 * t4));
        const uint2 hi = *reinterpret_cast<const uint2*>(
            xs + (mt * 16 + gr + 8) * Tl::kXRow + 2 * (kb + 4 * t4));
        a[mt][0] = lo.x;
        a[mt][1] = hi.x;
        a[mt][2] = lo.y;
        a[mt][3] = hi.y;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned q = *reinterpret_cast<const unsigned*>(
            ws + (nt * 8 + gr) * Tl::kWRow + kb + 4 * t4);
        unsigned b0, b1;
        s8x4_to_bf16x4(q, b0, b1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // The four warps' partial tiles, added in warp order, scaled, stored.
  float* red = reinterpret_cast<float*>(smem);
  float* mine = red + warp * BM * Tl::kRedRow;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = mt * 16 + gr, c = nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(mine + r * Tl::kRedRow + c) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(mine + (r + 8) * Tl::kRedRow + c) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  const float* sg = scale + (size_t)g * N;
  for (int i = tid; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    if (r >= rows || n0 + c >= N) continue;
    const int o = r * Tl::kRedRow + c, stride = BM * Tl::kRedRow;
    const float sum = ((red[o] + red[o + stride]) + red[o + 2 * stride]) + red[o + 3 * stride];
    out[(size_t)(row0 + r) * N + n0 + c] = from_float<OutT>(sum * sg[n0 + c]);
  }
}

// fp32 x: 64 x 64 output tiles, 16 x 16 threads of 4 x 4 outputs.
constexpr int kFThreads = 256;
constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFBK = 16;

__global__ void __launch_bounds__(kFThreads)
    w8_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, const int* __restrict__ offs,
                  float* __restrict__ out, int M, int N, int K, int G) {
  __shared__ float As[kFBK][kFBM + 4];  // k-major: a row's values broadcast
  __shared__ float Bs[kFBK][kFBN + 4];
  int g, row0, row_end;
  if (!w8_rows<kFBM>(offs, M, G, g, row0, row_end)) return;
  const int rows = row_end - row0;
  const int n0 = blockIdx.y * kFBN;
  const int8_t* wg = w + (size_t)g * N * K;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lr = tid / 4, lk = (tid % 4) * 4;  // the staging thread's row and k

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFBK) {
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lr < rows) xv = *reinterpret_cast<const float4*>(x + (size_t)(row0 + lr) * K + k0 + lk);
    As[lk][lr] = xv.x;
    As[lk + 1][lr] = xv.y;
    As[lk + 2][lr] = xv.z;
    As[lk + 3][lr] = xv.w;
    const int q = n0 + lr < N ? *reinterpret_cast<const int*>(wg + (size_t)(n0 + lr) * K + k0 + lk)
                              : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) Bs[lk + j][lr] = static_cast<float>(sbyte(q, j));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
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

  const float* sg = scale + (size_t)g * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
    float* orow = out + (size_t)(row0 + r) * N + n0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (n0 + c < N) orow[c] = acc[i][j] * sg[n0 + c];
    }
  }
}

template <typename Tl, typename OutT>
cudaError_t launch_mma(const void* x, const void* w, const float* scale, const int* offs,
                       void* out, int M, int N, int K, int G, cudaStream_t st) {
  constexpr int BM = Tl::BM, BN = Tl::BN;
  auto kernel = w8a16_mma_kernel<Tl, OutT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem);
  if (err != cudaSuccess) return err;
  const long long row_tiles =
      (M + BM - 1) / BM + (offs != nullptr ? (G < M ? G : M) : 0);
  const dim3 grid((unsigned)row_tiles, (N + BN - 1) / BN);
  kernel<<<grid, w8::kThreads, Tl::kSmem, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                 static_cast<const int8_t*>(w), scale, offs,
                                                 static_cast<OutT*>(out), M, N, K, G);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_route(int route, const void* x, const void* w, const float* scale,
                         const int* offs, void* out, int M, int N, int K, int G,
                         cudaStream_t st) {
  if (route == 0) return launch_mma<w8::Small, OutT>(x, w, scale, offs, out, M, N, K, G, st);
  return launch_mma<w8::Large, OutT>(x, w, scale, offs, out, M, N, K, G, st);
}

}  // namespace
}  // namespace ssd

// out [M, N] = (x [M, K] @ w[g]^T) * scale[g] per group g of rows (offs
// [G+1], or nullptr for one group). dtype: x's type (kFloat32 or
// kBFloat16); out_fp32: the output type for bf16 x (fp32 x writes fp32);
// route: 0 or 1, the bf16 tile shape (w8::Small, w8::Large).
extern "C" int ssd_int8_linear(int dtype, int out_fp32, int route, const void* x,
                               const void* w, const float* scale, const int* offs, void* out,
                               int M, int N, int K, int G, void* stream) {
  using namespace ssd;
  if (M == 0 || N == 0) return cudaSuccess;
  if (M < 0 || N < 0 || K <= 0 || K % 16 != 0 || G <= 0 || (offs == nullptr && G != 1) ||
      (route != 0 && route != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    return out_fp32 ? launch_route<float>(route, x, w, scale, offs, out, M, N, K, G, st)
                    : launch_route<__nv_bfloat16>(route, x, w, scale, offs, out, M, N, K, G, st);
  }
  if (dtype == kFloat32 && out_fp32) {
    const long long row_tiles = (M + kFBM - 1) / kFBM + (offs != nullptr ? (G < M ? G : M) : 0);
    const dim3 grid((unsigned)row_tiles, (N + kFBN - 1) / kFBN);
    w8_f32_kernel<<<grid, kFThreads, 0, st>>>(static_cast<const float*>(x),
                                              static_cast<const int8_t*>(w), scale, offs,
                                              static_cast<float*>(out), M, N, K, G);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of a bf16 route's kernel (for the smoke run's
// resource report).
extern "C" int ssd_int8_linear_smem_bytes(int route) {
  return route == 0 ? ssd::w8::Small::kSmem : ssd::w8::Large::kSmem;
}
