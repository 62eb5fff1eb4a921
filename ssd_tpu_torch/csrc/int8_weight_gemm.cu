// W8A16 GEMM: y = (x @ q^T) * s over int8 weights with per-output-channel
// scales, optionally grouped (the experts of a Qwen3-MoE layer). K9.
//
// Replaces no Pallas kernel: it stands for XLA's fused convert. Under
// quantization="int8" the JAX package computes every linear layer as
// (x @ q.astype(x.dtype)) * s
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
// group offsets offs [G+1] (int32, on the device, rising from 0 to at most
// M; rows from offs[G] on are not written), group g owns rows [offs[g],
// offs[g+1]) of x; without them G = 1 and every row is group
// 0. out[m, n] = s[g(m), n] * sum_k x[m, k] q[g(m), n, k], summed in fp32,
// scaled once and rounded once to the output type (bf16 or fp32; fp32 x
// gives fp32). K is a multiple of 16; M and N are any; an empty group writes
// nothing.
//
// What bounds it on an H100. At decode (8-128 rows of the Llama-3.2-1B
// geometry; a b8 dispatch of Qwen3-30B-A3B's experts) it streams the
// weights, ~1 byte a weight for 2 to 256 operations: bytes bound it (a q/o
// projection's 4.2 MB take 1.3 us at 3.35 TB/s), and int8 halves them
// against bf16, but a call's fixed cost (launch, first TMA round trip,
// the K splits' reduction) is several microseconds, as large as the
// stream of a small product. At prefill (5534 rows) it does ~5,500
// operations a weight byte: the tensor cores bound it (gate/up, 186
// GFLOP, 0.188 ms at 989 TFLOP/s), and each 256-row x tile is re-read from
// L2 for every 128 output columns.
//
// Design, bf16 x (routes 1 and 2, w8a16_wgmma_kernel): the product turned
// around, out^T = q . x^T, so that 64 weight rows (int8, K-major, as the
// port stores them) are wgmma's M operand and a tile of x rows its N.
// wgmma has no bf16 x s8 form, so A comes from registers: each warp loads
// its 16 rows' int8 bytes of a k16 step from shared memory (two 16-bit
// loads a row, the bytes m16n8k16's A fragment wants) and widens them
// exactly to bf16 (s8x4_to_bf16x4); B is x's tile in shared memory. One
// producer warp keeps a ring of stages full with TMA (cp.async.bulk.tensor:
// x's box bf16 with the 128-byte swizzle, the weights' box int8 with the
// 64-byte swizzle, so the fragment loads hit 32 banks), through full/empty
// mbarriers; each stage's wgmmas are waited for before the stage is
// released (ptxas serializes register-A wgmmas whose A is written while
// one is in flight, so one warp cannot overlap its widening with its
// products: two consumer warpgroups that take alternate stages do).
//  - decode (route 1): x tiles of 8, 16, 32, 64 or 128 rows, from the rows
//    a group (one tile holds a whole decode batch, so the weights are read
//    once, and x once per 64 or 128 output columns); at up to 64 rows the
//    two warpgroups share 64 weight rows and take alternate stages, at 128
//    each takes 64 of 128 rows (8 rows: one warpgroup, five blocks an SM).
//    Outputs too narrow to fill the SMs split K across the blocks of a
//    thread-block cluster (split_of: the largest power of two up to K / 512
//    and 8, halved while the grid would exceed two blocks an SM). Each block
//    writes its fp32 partial of every output into the shared memory of the
//    block that owns the output (distributed shared memory), one cluster
//    barrier later each owner adds the S partials in rank order: no
//    atomics, the same order on every call, so a graph replay equals the
//    eager call bit for bit.
//  - prefill (route 2): 128 output columns by 256 x rows (192 over groups,
//    whose few hundred rows an expert fill 256-row tiles poorly), two
//    warpgroups of 64 weight rows each on m64n256k16 (m64n192k16), no
//    split. Pairs of blocks sharing x by TMA multicast, and two warpgroups
//    taking alternate stages of 128 weight rows over 128-row x tiles,
//    measured slower and were left out.
// The scale is applied once per output in the epilogue, which stages the
// tile in shared memory and stores four outputs a thread (8 or 16 bytes).
// Up to three products over the same x (q/k/v, gate/up; the experts'
// gate/up) share one launch (ssd_int8_linear_multi): their column tiles
// follow each other in the grid, each with its own tensor map, scales and
// output, and each output is computed as its own call on that route
// computes it.
//
// Design, fp32 x: fp32 FMAs on 64 x 64 tiles with 16-wide K slices, the int8
// values widened exactly to fp32 as they are staged; x is never rounded.
//
// Groups without a host read: the row tiles of all groups are numbered
// group after group (find_row_tile_at, shared with the grouped GEMM K6);
// the grid is the static bound ceil(M / BM) + min(G, M) row tiles times the
// column tiles (times the K splits), and a block (a cluster) past the last
// tile returns at once. So a captured CUDA graph serves any routing.
#include "common.cuh"
#include "hopper.cuh"

namespace ssd {
namespace {

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

// --- bf16 x on wgmma: the decode and prefill routes ---

namespace w8h {
constexpr int kBK = 64;  // K a stage: a 128-byte row of bf16 x, a 64-byte row of int8

// A tile of BM output columns (weight rows; wgmma's M) by BN rows of x
// (wgmma's N), K in stages of kBK through a STAGES-deep ring: x's BN x 64
// box (bf16, 128-byte swizzle), then the weights' BM x 64 box (int8,
// 64-byte swizzle). WG consumer warpgroups: with ALT they share the tile's
// 64 weight rows and take alternate stages (one widens while the other's
// wgmma runs; their sums are added in warpgroup order); without, each
// takes 64 of BM = 64 WG rows of every stage. SPLIT: K may be split across
// a cluster. MIN_BLOCKS is the residency the registers are held to.
template <int BN_, int WG_, bool ALT_, int STAGES_, bool SPLIT_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int BN = BN_, WG = WG_, STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr bool ALT = ALT_, SPLIT = SPLIT_;
  static constexpr int BM = ALT ? 64 : 64 * WG;
  static constexpr int kThreads = 128 * WG + 32;   // + the producer warp
  static constexpr int kXBytes = BN * 128;         // x's BN rows x 64 K
  static constexpr int kWBytes = BM * kBK;
  static constexpr int kStage = kXBytes + kWBytes;
  static constexpr int kRing = STAGES * kStage;
  static constexpr int kPStride = BM + 4;          // floats a row of the fp32 tile
  static constexpr int kPart = BN * kPStride * 4;
  static constexpr int kQuads = BN * BM / 4;       // the tile's outputs in fours
  // The K splits' partial quads, at their owner: written by the cluster's
  // other blocks while this one may still read its ring, so apart from it.
  static constexpr int kSlotOff = kRing > kPart ? kRing : kPart;
  static constexpr int kSmem = kSlotOff + (SPLIT ? kQuads * 16 : 0) + 1024;  // + the alignment
  static_assert(kXBytes % 1024 == 0 && kWBytes % 1024 == 0 && kPart % 16 == 0,
                "TMA boxes with the 128-byte swizzle start 1024-byte aligned");
  static_assert(kQuads % 8 == 0, "K splits of 1, 2, 4 or 8 share the quads evenly");
};
// Decode and verify (route 1): x tiles of 8 to 128 rows, picked from the
// rows a group.
using D8 = Cfg<8, 1, false, 8, true, 5>;
using D16 = Cfg<16, 2, true, 8, true, 3>;
using D32 = Cfg<32, 2, true, 8, true, 3>;
using D64 = Cfg<64, 2, true, 6, true, 2>;
using D128 = Cfg<128, 2, false, 4, true, 1>;
// Prefill (route 2): 128 output columns by 256 rows, m64n256k16, no split;
// by 192 rows over groups (an expert's few hundred rows fill 256-row tiles
// poorly: ~346 rows take 2 x 192, not 2 x 256).
using P256 = Cfg<256, 2, false, 4, false, 1>;
using P192 = Cfg<192, 2, false, 5, false, 1>;

// One product over the shared x: its weights' tensor map is the kernel's
// wmap<i>, its scales, its output and its width, and its first column tile.
struct Seg {
  const float* scale;  // [G, N]
  void* out;           // [M, N]
  int N;
  int tile0;
};

struct Args {
  Seg seg[3];
  const int* offs;  // [G+1] or nullptr
  int nseg, M, K, G;
  int col_tiles;    // of all segments
  int split;        // K splits: the cluster's blocks
  int krange;       // K a split (a multiple of the stage's K)
  int out_f32;
};
}  // namespace w8h

__device__ __forceinline__ uint32_t lds_u16(const unsigned char* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Block b: split b % S of tile b / S, tile = (row tile, column tile) with
// the column tiles of one row tile consecutive. Warp 4 WG is the producer:
// one lane keeps the ring full. A consumer warpgroup loads its int8
// fragments of a stage from shared memory, widens them exactly to bf16 in
// registers, runs register-A wgmmas on x's box, waits for them and
// releases the stage. The fp32 tile then goes to shared memory [x row][out
// column]. With S > 1 the S blocks of the cluster (one per K split) each
// own a share of the tile's outputs: every block writes its partial of each
// share into the owner's slot for its rank (distributed shared memory),
// and after one cluster barrier each owner adds its S slots in rank order.
// The sum is scaled once per output and rounded once.
template <typename C>
__global__ void __launch_bounds__(C::kThreads, C::MIN_BLOCKS)
    w8a16_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap0,
                       const __grid_constant__ CUtensorMap wmap1,
                       const __grid_constant__ CUtensorMap wmap2,
                       const __grid_constant__ w8h::Args a) {
  using namespace hopper;
  constexpr int BN = C::BN, BM = C::BM, BK = w8h::kBK, STAGES = C::STAGES, WG = C::WG;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ float sscale[BM];
  const int S = C::SPLIT ? a.split : 1;
  const int tile = blockIdx.x / S, split = blockIdx.x % S;
  const int rt = tile / a.col_tiles, ct = tile % a.col_tiles;
  const int si = a.nseg > 2 && ct >= a.seg[2].tile0   ? 2
                 : a.nseg > 1 && ct >= a.seg[1].tile0 ? 1
                                                      : 0;  // the product of this column tile
  const CUtensorMap* wmap = si == 0 ? &wmap0 : si == 1 ? &wmap1 : &wmap2;
  if (threadIdx.x == 4 * WG * 32) {
    prefetch_map(&xmap);
    prefetch_map(wmap);
  }
  int g, row0, row_end;
  if (a.offs == nullptr) {
    g = 0;
    row0 = rt * BN;
    row_end = min(row0 + BN, a.M);
    if (row0 >= a.M) return;
  } else if (!find_row_tile_at<BN>(a.offs, a.G, rt, g, row0, row_end)) {
    return;  // every block of the cluster has this tile, so all return
  }
  const int N = si == 0 ? a.seg[0].N : si == 1 ? a.seg[1].N : a.seg[2].N;
  const float* scale = si == 0 ? a.seg[0].scale : si == 1 ? a.seg[1].scale : a.seg[2].scale;
  void* out = si == 0 ? a.seg[0].out : si == 1 ? a.seg[1].out : a.seg[2].out;
  const int n0 = (ct - (si == 0 ? 0 : si == 1 ? a.seg[1].tile0 : a.seg[2].tile0)) * BM;
  const int kb = split * a.krange;
  const int nk = max(0, (min(a.K, kb + a.krange) - kb + BK - 1) / BK);

  unsigned char* smem = align1024(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::ALT ? 4 : 4 * WG);  // its consumer warps
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (S > 1) cluster_arrive_relaxed();  // this block has started (waited on before the slots)

  const int wg = warp / 4;
  const int gr = lane / 4, t = lane % 4;
  // a[0]/a[2]'s weight row in the tile; a[1]/a[3]'s is r0 + 8.
  const int r0 = (C::ALT ? 0 : wg * 64) + (warp % 4) * 16 + gr;
  float* P = reinterpret_cast<float*>(smem);
  if (warp == 4 * WG) {
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * C::kStage;
        mbar_arrive_expect_tx(&full[s], C::kStage);
        const int k = kb + kt * BK;
        tma_load_2d(st, &xmap, &full[s], k, row0);
        tma_load_3d(st + C::kXBytes, wmap, &full[s], k, n0, g);
      }
    }
    __syncwarp();
  } else {
    // The scales of the tile's columns, read now and used after the loop.
    const int tid = threadIdx.x;
    const float sc = tid < BM && n0 + tid < N ? scale[(size_t)g * N + n0 + tid] : 0.f;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // Row r's 16-byte chunk c of the 64-byte-swizzled weight box sits at
    // r * 64 + ((c ^ ((r >> 1) & 3)) << 4); rows r0 and r0 + 8 share the
    // phase. A k16 step j is chunk j: this thread's bytes 2t, 2t+1 and
    // 2t+8, 2t+9 of it are a[0]/a[2] (row r0) and a[1]/a[3] (row r0 + 8).
    const int phase = (r0 >> 1) & 3;
    for (int kt = C::ALT ? wg : 0; kt < nk; kt += C::ALT ? WG : 1) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const unsigned char* xs = smem + s * C::kStage;
      const unsigned char* w0 = xs + C::kXBytes + r0 * BK + 2 * t;
      uint32_t af[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* p0 = w0 + ((j ^ phase) << 4);
        const unsigned char* p1 = p0 + 8 * BK;
        s8x4_to_bf16x4(lds_u16(p0) | (lds_u16(p0 + 8) << 16), af[j][0], af[j][2]);
        s8x4_to_bf16x4(lds_u16(p1) | (lds_u16(p1 + 8) << 16), af[j][1], af[j][3]);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) wgmma_rs<BN>(acc, af[j], gmma_desc(xs + 32 * j, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // Every consumer warp is done with the ring before the tile overwrites
    // it; with ALT the warpgroups add their sums in order.
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WG) : "memory");
    if (tid < BM) sscale[tid] = sc;
    // acc[4j + 2h + u]: weight row r0 + 8h, x row 8j + 2t + u.
#pragma unroll
    for (int w = 0; w < (C::ALT ? WG : 1); ++w) {
      if (!C::ALT || wg == w) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              float& p = P[(8 * j + 2 * t + u) * C::kPStride + r0 + 8 * h];
              p = (C::ALT && w > 0 ? p : 0.f) + acc[4 * j + 2 * h + u];
            }
      }
      if (C::ALT && w + 1 < WG) asm volatile("bar.sync 1, %0;\n" ::"n"(128 * WG) : "memory");
    }
  }
  __syncthreads();

  // Quad q (four outputs) of the tile: x row q / (BM/4), columns 4 (q %
  // (BM/4)) ..; kept where its row is the group's and its first column is
  // below N.
  const int share = (C::kQuads + S - 1) / S;
  auto quad = [&](int q, int& row, int& col) {
    row = row0 + q / (BM / 4);
    col = n0 + 4 * (q % (BM / 4));
    return row < row_end && col < N;
  };
  const float4* P4 = reinterpret_cast<const float4*>(P);
  auto local = [&](int q) {
    return P4[(q / (BM / 4)) * (C::kPStride / 4) + q % (BM / 4)];
  };
  float4* slots = reinterpret_cast<float4*>(smem + C::kSlotOff);
  if (S > 1) {
    cluster_wait();  // every block of the cluster has started
    for (int q = threadIdx.x; q < C::kQuads; q += C::kThreads) {
      int row, col;
      if (!quad(q, row, col)) continue;
      const int owner = q / share;
      st_cluster_f4(cluster_addr(slots + split * share + (q - owner * share), owner), local(q));
    }
    cluster_sync();
  }
  const bool vec = N % 4 == 0;
  const int q_hi = min(C::kQuads, (split + 1) * share);
  for (int q = split * share + threadIdx.x; q < q_hi; q += C::kThreads) {
    int row, col;
    if (!quad(q, row, col)) continue;
    float4 v;
    if (S > 1) {
      const int i = q - split * share;
      v = slots[i];
      for (int r = 1; r < S; ++r) {
        const float4 p = slots[r * share + i];
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
    } else {
      v = local(q);
    }
    const int c = col - n0;
    const float y[4] = {v.x * sscale[c], v.y * sscale[c + 1], v.z * sscale[c + 2],
                        v.w * sscale[c + 3]};
    const size_t o = (size_t)row * N + col;
    if (a.out_f32) {
      float* dst = static_cast<float*>(out) + o;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
        for (int u = 0; u < 4 && col + u < N; ++u) dst[u] = y[u];
      }
    } else {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + o;
      if (vec) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(bf16x2(y[0], y[1]), bf16x2(y[2], y[3]));
      } else {
        for (int u = 0; u < 4 && col + u < N; ++u) dst[u] = __float2bfloat16(y[u]);
      }
    }
  }
}

// K splits of route C's tiles for M rows over G groups into N columns and
// K: the largest power of two up to K / 512 and 8, then halved while the
// grid would hold more than two blocks an SM (132 SMs) for the groups'
// rows that can be live. A power of two divides the tile's quads, so the S
// shares of the slots fill them exactly.
template <typename C>
int split_of(int M, int N, int K, int G) {
  const long long live = G == 1 ? (M + C::BN - 1) / C::BN : (G < M ? G : M);
  const long long tiles = live * ((N + C::BM - 1) / C::BM);
  int s = 1;
  while (s < 8 && 2 * s * 512 <= K) s *= 2;
  while (s > 1 && tiles * s > 2 * 132) s /= 2;
  return s;
}

// The tensor maps and the launch of route C over nseg products that share
// x: segment i multiplies x by w[i] [G, N[i], K] into out[i], all with the
// split of the first.
template <typename C>
cudaError_t launch_wgmma(const void* x, int nseg, const void* const* w, const float* const* scale,
                         void* const* out, const int* N, const int* offs, int M, int K, int G,
                         bool decode, int out_f32, cudaStream_t st) {
  using namespace hopper;
  const int split = decode ? split_of<C>(M, N[0], K, G) : 1;
  for (int i = 1; i < nseg; ++i)
    if (decode && split_of<C>(M, N[i], K, G) != split) return cudaErrorInvalidValue;
  w8h::Args a{};
  CUtensorMap xmap, wmap[3];
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xs[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xb[2] = {w8h::kBK, (cuuint32_t)C::BN};
  if (!encode_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_128B, x, 2, xd,
                  xs, xb))
    return cudaErrorInvalidValue;
  int tiles = 0;
  for (int i = 0; i < 3; ++i) {
    if (i >= nseg) {
      wmap[i] = wmap[0];
      continue;
    }
    const cuuint64_t wd[3] = {(cuuint64_t)K, (cuuint64_t)N[i], (cuuint64_t)G};
    const cuuint64_t ws[2] = {(cuuint64_t)K, (cuuint64_t)N[i] * K};
    const cuuint32_t wb[3] = {w8h::kBK, (cuuint32_t)C::BM, 1};
    if (!encode_map(&wmap[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_64B, w[i], 3,
                    wd, ws, wb))
      return cudaErrorInvalidValue;
    a.seg[i] = w8h::Seg{scale[i], out[i], N[i], tiles};
    tiles += (N[i] + C::BM - 1) / C::BM;
  }
  a.offs = offs;
  a.nseg = nseg;
  a.M = M;
  a.K = K;
  a.G = G;
  a.col_tiles = tiles;
  a.split = split;
  a.krange = ((K + split - 1) / split + w8h::kBK - 1) / w8h::kBK * w8h::kBK;
  a.out_f32 = out_f32;
  const long long row_tiles = (M + C::BN - 1) / C::BN + (offs != nullptr ? (G < M ? G : M) : 0);
  const long long blocks = row_tiles * tiles * split;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = w8a16_wgmma_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (split > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, xmap, wmap[0], wmap[1], wmap[2], a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Route 1 (decode: x tiles of 8-128 rows from the rows a group, K split
// by split_of) or 2 (prefill: 256-row tiles, 192 over groups, no split);
// F(config) is applied to the route's configuration.
template <typename F>
auto with_config(int route, int M, int G, F f) {
  if (route == 2) {
    if (G > 1) return f(w8h::P192{});
    return f(w8h::P256{});
  }
  const int rows = (M + G - 1) / G;
  if (rows <= 8) return f(w8h::D8{});
  if (rows <= 16) return f(w8h::D16{});
  if (rows <= 32) return f(w8h::D32{});
  if (rows <= 64) return f(w8h::D64{});
  return f(w8h::D128{});
}

cudaError_t launch_hopper(int route, const void* x, int nseg, const void* const* w,
                          const float* const* scale, void* const* out, const int* N,
                          const int* offs, int M, int K, int G, int out_f32, cudaStream_t st) {
  return with_config(route, M, G, [&](auto c) {
    return launch_wgmma<decltype(c)>(x, nseg, w, scale, out, N, offs, M, K, G, route == 1,
                                     out_f32, st);
  });
}

}  // namespace
}  // namespace ssd

// out [M, N] = (x [M, K] @ w[g]^T) * scale[g] per group g of rows (offs
// [G+1], or nullptr for one group). dtype: x's type (kFloat32 or
// kBFloat16); out_fp32: the output type for bf16 x (fp32 x writes fp32);
// route, bf16 x only: 1 decode or 2 prefill, the wgmma routes (w8h).
extern "C" int ssd_int8_linear(int dtype, int out_fp32, int route, const void* x,
                               const void* w, const float* scale, const int* offs, void* out,
                               int M, int N, int K, int G, void* stream) {
  using namespace ssd;
  if (M == 0 || N == 0) return cudaSuccess;
  if (M < 0 || N < 0 || K <= 0 || K % 16 != 0 || G <= 0 || (offs == nullptr && G != 1) ||
      (dtype == kBFloat16 && route != 1 && route != 2))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return launch_hopper(route, x, 1, &w, &scale, &out, &N, offs, M, K, G, out_fp32, st);
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

// Up to three products over one bf16 x in one launch of wgmma route 1 or
// 2: out_i [M, N_i] = (x @ w_i[g]^T) * scale_i[g], each output computed as
// ssd_int8_linear computes it on that route (the same tiles and K splits),
// so bit for bit the separate calls' results. Unused segments' pointers
// may be null.
extern "C" int ssd_int8_linear_multi(int out_fp32, int route, const void* x, int nseg,
                                     const void* w0, const void* w1, const void* w2,
                                     const float* s0, const float* s1, const float* s2,
                                     void* o0, void* o1, void* o2, int N0, int N1, int N2,
                                     const int* offs, int M, int K, int G, void* stream) {
  using namespace ssd;
  const void* w[3] = {w0, w1, w2};
  const float* scale[3] = {s0, s1, s2};
  void* out[3] = {o0, o1, o2};
  const int N[3] = {N0, N1, N2};
  if (nseg < 1 || nseg > 3 || M < 0 || K <= 0 || K % 16 != 0 || G <= 0 ||
      (offs == nullptr && G != 1) || (route != 1 && route != 2))
    return cudaErrorInvalidValue;
  for (int i = 0; i < nseg; ++i)
    if (N[i] <= 0) return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;
  return launch_hopper(route, x, nseg, w, scale, out, N, offs, M, K, G, out_fp32,
                       static_cast<cudaStream_t>(stream));
}


// The K splits route 1 or 2 takes for M rows over G groups into N
// outputs (1 on route 2): products whose splits agree can share a launch.
extern "C" int ssd_int8_linear_split(int route, int M, int N, int K, int G) {
  using namespace ssd;
  if (route != 1 || M <= 0 || N <= 0 || K <= 0 || G <= 0) return 1;
  return with_config(route, M, G, [&](auto c) { return split_of<decltype(c)>(M, N, K, G); });
}

// Dynamic shared memory of a bf16 route's kernel (for the smoke run's
// resource report): route 1 at `rows` rows a group, 2 over G groups.
extern "C" int ssd_int8_linear_smem_bytes(int route, int rows, int G) {
  using namespace ssd;
  return with_config(route, rows * G, G, [](auto c) { return decltype(c)::kSmem; });
}
