// The split-KV tree kernels: K3 (csrc/tree_attention.cu, bf16/fp32 pages)
// and K5 (csrc/tree_attention_int8.cu, int8 pages in both kv_quant modes)
// are this one kernel, instantiated per cache kind.
//
// Contract (the entries' headers state it in full): q [B, MQ, Hq, hd]; a
// layer [Hkv, S, 2*hd] with K in [0, hd) and V in [hd, 2*hd) of each slot
// row (f32 scales [Hkv, 2, S] beside an int8 layer); block_tables [B, M],
// where -1 reads page 0; with prefix = ctx - (K+1) - (s+1)*MQ, tree row r
// attends p below min(ctx, M * block_size) when p < prefix, or
// 0 <= p - prefix <= fan[r], or t = p - prefix - (K+1) has
// 0 <= t < (s+1)*MQ and t % MQ == r; rows that attend nothing give zeros;
// any block size and any MQ; any even hd in [16, 256] (the template's HD is
// the padded width, 64, 128, 192 or 256, common.cuh::padded_head_dim; the s8
// kind only at hd = HD).
//
// What bounds it on an H100: bytes. Every row of a sequence attends its
// whole prefix, so each K|V byte serves R = MQ * G query rows of its KV head
// (40 at K=4, fan-out 2, G=4; 80 at G=8), far below the ~295 operations per
// byte where the tensor cores would bound it. The design is the paged
// kernels' split (csrc/paged_split.cuh), with the rows laid out for the
// tree's many rows:
//  1. Split-KV. The grid is (chunks, Hkv, B): block (c, h, b) walks the
//     positions [c * chunk, (c + 1) * chunk) of sequence b, KV head h. The
//     chunk length is a multiple of the 64-position tile and depends on the
//     head width and the cache kind only (the wrapper's TREE_CHUNK), so a
//     row's result depends on neither the batch nor the other sequences.
//     At long contexts a block takes up to 512 positions of consecutive
//     chunks, which changes no result.
//  2. The whole chunk stays resident in shared memory. Its 64-position
//     tiles go out at once through cp.async, each slot's K|V row as 16-byte
//     pieces copied by neighbouring threads (narrower where hd * esize is no
//     multiple of 16, and the pad lanes of a padded width zero-filled:
//     common.cuh; for int8 its two scales as 4-byte copies beside it),
//     gathered through the page table (the
//     block's slots resolved once, into shared memory); the query rows'
//     copies go out first. The math on tile 0 starts while the later tiles
//     are in flight.
//  3. All rows in one pass over the chunk. Each warp owns a 16-row tile, so
//     the block's four warps cover 64 rows (row r * G + g for tree row r,
//     query head g) and every warp reads each resident tile for its rows.
//     Above 64 rows (Qwen3-30B-A3B's G=8: 80) the block loops over row
//     groups on the resident chunk: the chunk is read from HBM once.
//     Four warps and not eight: 4 x 16 rows cover the serve and EAGLE
//     shapes (40 rows) in one group, and a warp's state at hd 128 (64
//     accumulators, 32 scores, the softmax) takes up to 255 registers a
//     thread, so eight warps would leave one block an SM.
//  4. Tensor cores where they are exact enough; each warp keeps its rows'
//     online softmax in registers:
//     - bf16 q over the fp cache or the "int8" mode: Q.K^T on mma.sync
//       m16n8k16 with fp32 sums (bf16 products are exact in fp32; int8 k ->
//       bf16 is exact too, then * scale * sk); P (p, or p * sv) split into
//       hi = bf16(p) and lo = bf16(p - hi), fed from the score fragments
//       into two P.V mmas on one fp32 accumulator (P carries ~16 bits).
//     - int8_mxu (any q dtype): q8.k8 and p8.v8 on mma.sync m16n8k32 s8
//       with int32 sums; each tile's weights are quantized per row from the
//       tile's own scores, as the plain version does at TREE_S8_TILE. The
//       A fragment of P.V takes its positions in the order the score
//       fragments hold them, and V's B fragment is gathered in the same
//       order: the integer sums do not depend on it.
//     - fp32 q: fp32 FMAs, no TF32; lanes take positions for the scores and
//       columns for P.V, the weights passing through the warp's own slice
//       of shared memory.
//  5. The mask only where it is needed: a tile entirely below the prefix
//     (and the context) is attended by every row; only the tiles that hold
//     the tail [prefix, ctx) evaluate attends() per (row, position).
//  6. Each block ends with its rows' partial softmax state (m, l, acc) in
//     fp32. With one live chunk it writes the output itself; otherwise it
//     writes the partial to a workspace the wrapper allocates per call on
//     the caller's stream, and the last block of each (b, h) to finish
//     (found through a per-stream counter, incremented once per block and
//     reset by that last block) merges the partials in chunk order: a chunk
//     in which a row attends nothing (m = -inf) weighs 0, never NaN. No
//     data atomics, so results are bitwise repeatable.
//
// This is a header of its own, not an instantiation of paged_split.cuh:
// there a warp owns 16 positions of every tile and a pass holds 16 rows,
// here a warp owns 16 rows and the block holds the chunk for all of them,
// and leaving paged_split.cuh as it is keeps K2 and K4 bit for bit.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ssd {
namespace tree {

enum Kind : int { kFp = 0, kI8 = 1, kS8 = 2 };

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                // positions per tile (= TREE_S8_TILE)
constexpr int kGroupRows = 16 * kWarps;  // rows of one pass: a 16-row tile a warp
constexpr int kMergeRows = kGroupRows;   // rows the last block merges at a time
constexpr int kMaxChunk = 512;           // positions one block walks, at most
constexpr int kMaxSmem = 232448;         // an H100 block's shared memory (227 KB)

struct Args {
  const void* q;
  const void* kv;
  const float* scales;  // int8 kinds: [Hkv, 2, S]
  const int* block_tables;
  const int* context_lens;
  const int* fan;       // [B, MQ] glue depth of each tree row
  void* out;
  float* ws;      // partials: acc [B, Hkv, NC, R, hd], then (m, l) [B, Hkv, NC, R, 2]
  int* counters;  // [B * Hkv], zero between calls
  int MQ, Hq, Hkv;
  long long S;
  int M, bs, step, K, chunk;
  int per_block;  // consecutive chunks each block takes
  float scale;
  int hd;         // the head dim, even, at most the instantiation's padded width
};

// Shared-memory layout of one instantiation for a chunk of `chunk`
// positions (byte offsets, 16-aligned).
template <typename T, int HD, int KIND>
struct Layout {
  using CT = std::conditional_t<KIND == kFp, T, int8_t>;  // cache element
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool kWarpMma = kBf16 && KIND != kS8;   // m16n8k16 path
  static constexpr bool kFma = !kBf16 && KIND != kS8;      // fp32 q
  static constexpr int kRowBytes = 2 * HD * (int)sizeof(CT);  // one slot's K|V
  static constexpr int kKvStride = kRowBytes + 16;             // padded: no bank conflicts
  static constexpr int kQStride = KIND == kS8 ? HD + 16 : kBf16 ? 2 * (HD + 8) : 4 * (HD + 4);
  static constexpr int kPStride = kTile + 4;  // floats: the fp32 path's weights
  static constexpr int kMergeBytes = kMergeRows * (32 * 12 + 4);  // (m, l), weights, L
  int sc, q, qsc, p, slots, bytes;
  __host__ __device__ explicit Layout(int chunk) {
    const int ring = chunk * kKvStride;  // the chunk's K|V, then the merge's scratch
    sc = ring > kMergeBytes ? ring : kMergeBytes;
    q = sc + (KIND == kFp ? 0 : 2 * chunk * 4);  // sk [chunk], sv [chunk]
    qsc = q + kGroupRows * kQStride;
    p = qsc + (KIND == kS8 ? kGroupRows * 4 : 0);
    slots = p + (kFma ? kWarps * 16 * kPStride * 4 : 0);
    bytes = slots + kMaxChunk * 4 + 16;  // + the last-block flag
  }
};

// Whether tree row `row` (glue depth `fan`; -1 for a padding row) attends
// position p, p below the context.
__device__ __forceinline__ bool attends(int p, int row, int fan, int prefix, int K, int MQ,
                                        int tree_end) {
  if (p < prefix) return true;
  const int glue = p - prefix;
  if (glue <= fan) return true;
  const int t = glue - (K + 1);
  return t >= 0 && t < tree_end && t % MQ == row;
}

// cp.async.wait_group with a count known at run time (at most 8 tiles).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// PAD: the instantiation for hd < HD (the lanes past hd zero, rows copied in
// pieces as wide as hd allows); without it hd = HD, every offset a constant,
// so the padded path costs the unpadded one no registers.
template <typename T, int HD, int KIND, bool PAD>
__global__ void __launch_bounds__(kThreads) tree_split_kernel(const Args a) {
  using L = Layout<T, HD, KIND>;
  using CT = typename L::CT;
  constexpr int NT = HD / 8;  // 8-column tiles of a row's output (tensor-core paths)
  const L lay(a.chunk);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kv_s = smem;
  float* sc_s = reinterpret_cast<float*>(smem + lay.sc);
  unsigned char* q_s = smem + lay.q;
  float* qsc_s = reinterpret_cast<float*>(smem + lay.qsc);
  float* p_s = reinterpret_cast<float*>(smem + lay.p);
  int* slot_s = reinterpret_cast<int*>(smem + lay.slots);
  int* last_s = slot_s + kMaxChunk;

  const int h = blockIdx.y, b = blockIdx.z, Hkv = gridDim.y;
  const int chunk = a.chunk;
  const int NC = (a.M * a.bs + chunk - 1) / chunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = a.Hq / Hkv, R = a.MQ * G;
  const int ctx = a.context_lens[b];
  const int n_pos = max(0, min(ctx, a.M * a.bs));
  const int n_live = (n_pos + chunk - 1) / chunk;
  // This block's chunks: [c_first, c_last), `per_block` consecutive ones.
  const int c_first = blockIdx.x * a.per_block;
  if (c_first >= max(n_live, 1)) return;
  const int c_last = min(c_first + a.per_block, max(n_live, 1));
  const int span0 = c_first * chunk;
  const int prefix = ctx - (a.K + 1) - (a.step + 1) * a.MQ;
  const int tree_end = (a.step + 1) * a.MQ;
  const int full_end = max(0, min(prefix, n_pos));  // every row attends [0, full_end)
  const int bh = b * Hkv + h;
  const int hd = PAD ? a.hd : HD;
  const int hb = hd * (int)sizeof(CT);  // bytes of a K or V half in device memory
  const int gran_kv = copy_granule(hb), gran_q = copy_granule(hd * (int)sizeof(T));
  const CT* kv_h = static_cast<const CT*>(a.kv) + (size_t)h * a.S * (2 * hd);
  const float* sk_h = a.scales + (size_t)h * 2 * a.S;  // int8: K scales; V scales at + S
  const T* qg = static_cast<const T*>(a.q);
  T* og = static_cast<T*>(a.out);
  const int* fan_b = a.fan + (size_t)b * a.MQ;
  float* ws_acc = a.ws + (size_t)bh * NC * R * HD;
  float2* ws_ml = reinterpret_cast<float2*>(a.ws + (size_t)gridDim.z * Hkv * NC * R * HD) +
                  (size_t)bh * NC * R;
  auto q_at = [&](int r) {  // row r of the head: tree row r / G, query head h * G + r % G
    return (((size_t)b * a.MQ + r / G) * a.Hq + h * G + r % G) * hd;
  };
  // Tree row and glue depth of row r (-1, -1 for a padding row).
  auto row_of = [&](int r) { return r < R ? r / G : -1; };
  auto fan_of = [&](int r) { return r < R ? fan_b[r / G] : -1; };
  auto attended = [&](int p, int row, int fan) {
    return p < n_pos && attends(p, row, fan, prefix, a.K, a.MQ, tree_end);
  };

  // The query rows [r0, r0 + 64) (zeros past R and past hd): bf16/fp32
  // copies by cp.async in one commit group; int8_mxu rows (hd = HD) quantized
  // once by the warps, qs = max(max|q|, 1e-30) / 127, q8 = round(q / qs).
  auto load_q = [&](int r0) {
    if constexpr (KIND == kS8) {
      for (int rr = warp; rr < kGroupRows; rr += kWarps) {
        int8_t* q8 = reinterpret_cast<int8_t*>(q_s + rr * L::kQStride);
        const int r = r0 + rr;
        if (r < R) {
          const T* qrow = qg + q_at(r);
          float amax = 0.f;
          for (int d = lane; d < HD; d += 32) amax = fmaxf(amax, fabsf(to_float(qrow[d])));
          const float qs = fmaxf(warp_max(amax), 1e-30f) * kInv127;
          for (int d = lane; d < HD; d += 32)
            q8[d] = static_cast<int8_t>(__float2int_rn(to_float(qrow[d]) / qs));
          if (lane == 0) qsc_s[rr] = __fmul_rn(qs, a.scale);
        } else {
          for (int d = lane; d < HD; d += 32) q8[d] = 0;
          if (lane == 0) qsc_s[rr] = 0.f;
        }
      }
    } else if constexpr (!PAD) {  // 16-byte pieces at fixed offsets
      constexpr int QP = HD * (int)sizeof(T) / 16;  // 16-byte pieces per row
      for (int e = tid; e < kGroupRows * QP; e += kThreads) {
        const int rr = e / QP, piece = e % QP, r = r0 + rr;
        const bool live = r < R;
        const T* src = live ? qg + q_at(r) + piece * (16 / (int)sizeof(T)) : qg;
        cp_async16(q_s + rr * L::kQStride + piece * 16, src, live);
      }
      cp_async_commit();
    } else {
      with_granule<(int)sizeof(T)>(gran_q, [&](auto gc) {
        constexpr int GR = decltype(gc)::value;
        constexpr int QP = HD * (int)sizeof(T) / GR;  // pieces per padded row
#pragma unroll 1
        for (int e = tid; e < kGroupRows * QP; e += kThreads) {
          const int rr = e / QP, off = (e % QP) * GR, r = r0 + rr;
          const bool live = r < R && off < hd * (int)sizeof(T);
          const unsigned char* src = live ? reinterpret_cast<const unsigned char*>(qg + q_at(r)) + off
                                          : reinterpret_cast<const unsigned char*>(qg);
          copy_piece<GR>(q_s + rr * L::kQStride + off, src, live);
        }
      });
      cp_async_commit();
    }
  };

  // Tile `it` of the chunk starting at p_begin (zeros at and past c_end),
  // one commit group.
  auto load_tile = [&](int p_begin, int c_end, int it) {
    unsigned char* dst = kv_s + it * kTile * L::kKvStride;
    const int t0 = p_begin + it * kTile;
    if constexpr (!PAD) {  // 16-byte pieces at fixed offsets
      constexpr int CPR = L::kRowBytes / 16;  // 16-byte pieces per slot row
      for (int e = tid; e < kTile * CPR; e += kThreads) {
        const int row = e / CPR, piece = e % CPR, p = t0 + row;
        const bool live = p < c_end;
        const CT* src = live ? kv_h + (size_t)slot_s[p - span0] * (2 * HD) : kv_h;
        cp_async16(dst + row * L::kKvStride + piece * 16,
                   reinterpret_cast<const unsigned char*>(src) + (live ? piece * 16 : 0), live);
      }
    } else {
      with_granule<(int)sizeof(CT)>(gran_kv, [&](auto gc) {
        constexpr int GR = decltype(gc)::value;
        constexpr int CPR = L::kRowBytes / GR;  // pieces per padded slot row
#pragma unroll 1
        for (int e = tid; e < kTile * CPR; e += kThreads) {
          const int row = e / CPR, p = t0 + row;
          const RowPiece pc = kv_row_piece<GR, HD * (int)sizeof(CT)>(e % CPR, hb);
          const bool live = p < c_end && pc.data;
          const unsigned char* src =
              live ? reinterpret_cast<const unsigned char*>(kv_h + (size_t)slot_s[p - span0] * (2 * hd)) + pc.src
                   : reinterpret_cast<const unsigned char*>(kv_h);
          copy_piece<GR>(dst + row * L::kKvStride + pc.dst, src, live);
        }
      });
    }
    if constexpr (KIND != kFp) {
      for (int e = tid; e < 2 * kTile; e += kThreads) {
        const int which = e / kTile, row = e % kTile, p = t0 + row;
        const bool live = p < c_end;
        const float* src = live ? sk_h + which * a.S + slot_s[p - span0] : sk_h;
        cp_async4(sc_s + which * chunk + it * kTile + row, src, live);
      }
    }
    cp_async_commit();
  };

  // Pass 0's query rows go out before the page-table reads.
  if constexpr (KIND != kS8) load_q(0);
  // The chunks' slots, through the page table (-1 reads page 0).
  for (int p = span0 + tid; p < min(c_last * chunk, n_pos); p += kThreads)
    slot_s[p - span0] = max(a.block_tables[(size_t)b * a.M + p / a.bs], 0) * a.bs + p % a.bs;

  for (int c = c_first; c < c_last; ++c) {
    const int p_begin = c * chunk;
    const int c_end = min(p_begin + chunk, n_pos);
    const int nt = c_end > p_begin ? (c_end - p_begin + kTile - 1) / kTile : 0;
    __syncthreads();  // the slots are in; the previous chunk is done with the buffers
    // With one row group the query rows stay for the block's later chunks.
    if constexpr (KIND != kS8) {
      if (c > c_first && R > kGroupRows) load_q(0);
    }
    for (int it = 0; it < nt; ++it) load_tile(p_begin, c_end, it);
    if constexpr (KIND == kS8) {
      if (c == c_first || R > kGroupRows) load_q(0);
    }

    for (int r0 = 0; r0 < R; r0 += kGroupRows) {
      if (r0 == 0) {
        cp_async_wait_n(nt);  // the query rows landed (the tiles may not have)
        __syncthreads();
      } else {  // the next row group on the resident chunk
        __syncthreads();  // every warp is done with the previous group's rows
        load_q(r0);
        cp_async_wait<0>();
        __syncthreads();
      }
      const int wr = r0 + 16 * warp;  // the warp's first row
      const bool active = wr < R;
      // Rows g and g+8 of the warp's tile, in each quad (tensor-core paths).
      const int ra = wr + g, rb = wr + g + 8;
      const int row2[2] = {row_of(ra), row_of(rb)}, fan2[2] = {fan_of(ra), fan_of(rb)};
      // The tensor-core paths' rows g and g+8 of the warp's tile: their
      // partial (or, with one live chunk, their output).
      auto put_mma = [&](const float (&acc)[NT][4], const float (&mw)[2], const float (&lw)[2]) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = hf ? rb : ra;
          if (r >= R) continue;
          if (n_live <= 1) {
            T* orow = og + q_at(r);
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int u = 0; u < 2; ++u)
                if (8 * n + 2 * t + u < hd)
                  orow[8 * n + 2 * t + u] =
                      from_float<T>(lw[hf] > 0.f ? acc[n][2 * hf + u] / lw[hf] : 0.f);
          } else {
            float* wrow = ws_acc + ((size_t)c * R + r) * HD;
#pragma unroll
            for (int n = 0; n < NT; ++n)
              *reinterpret_cast<float2*>(wrow + 8 * n + 2 * t) =
                  make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
            if (t == 0) ws_ml[(size_t)c * R + r] = make_float2(mw[hf], lw[hf]);
          }
        }
      };
      // Tile `it` is in shared memory for every thread (first group only).
      auto arrive = [&](int it) {
        if (r0 == 0) {
          cp_async_wait_n(nt - 1 - it);
          __syncthreads();
        }
      };

      if constexpr (L::kWarpMma) {
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
        float mw[2] = {-CUDART_INF_F, -CUDART_INF_F}, lw[2] = {0.f, 0.f};
        // The warp's query rows, read as A fragments where they are used
        // (registers go to the accumulators).
        const unsigned char* qrow = q_s + (16 * warp + (lane & 15)) * L::kQStride + (lane >> 4) * 16;
        for (int it = 0; it < nt; ++it) {
          arrive(it);
          if (!active) continue;
          const int t0 = p_begin + it * kTile;
          const unsigned char* kt = kv_s + it * kTile * L::kKvStride;
          const float* skt = sc_s + it * kTile;  // sk; sv at + chunk
          // Scores on m16n8k16, eight 8-position tiles: s[j][0..1] row g,
          // s[j][2..3] row g+8, positions 8j + 2t, +1.
          float s[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) s[j][u] = 0.f;
#pragma unroll
          for (int kk = 0; kk < HD / 32; ++kk) {
            unsigned qa[2][4];  // k-steps 2kk and 2kk+1
            ldmatrix_x4(qa[0], qrow + 64 * kk);
            ldmatrix_x4(qa[1], qrow + 64 * kk + 32);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              unsigned bfr[4];  // b0, b1 of k-steps 2kk and 2kk+1
              if constexpr (KIND == kFp) {
                ldmatrix_x4(bfr, kt + (8 * j + (lane & 7)) * L::kKvStride +
                                     (32 * kk + (lane >> 3) * 8) * 2);
              } else {  // int8 -> bf16, exact
                const unsigned char* kr = kt + (8 * j + g) * L::kKvStride + 32 * kk + 2 * t;
#pragma unroll
                for (int u = 0; u < 4; ++u)
                  bfr[u] = s8x2_to_bf16x2(*reinterpret_cast<const short*>(kr + 8 * u));
              }
              mma_bf16(s[j], qa[0], bfr[0], bfr[1]);
              mma_bf16(s[j], qa[1], bfr[2], bfr[3]);
            }
          }
          // Online softmax over the tile (a quad holds a row's 64 positions).
          const bool full = t0 + kTile <= full_end;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float mx = -CUDART_INF_F;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int pt = 8 * j + 2 * t + u;
                float x = s[j][2 * hf + u] * a.scale;
                if constexpr (KIND == kI8) x *= skt[pt];
                if (!full && !attended(t0 + pt, row2[hf], fan2[hf])) x = -CUDART_INF_F;
                s[j][2 * hf + u] = x;
                mx = fmaxf(mx, x);
              }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(mw[hf], mx);
            const float alpha = mw[hf] == -CUDART_INF_F ? 0.f : expf(mw[hf] - m_new);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const float x = s[j][2 * hf + u];
                const float e = x == -CUDART_INF_F ? 0.f : expf(x - m_new);
                s[j][2 * hf + u] = e;
                ps += e;
              }
            ps += __shfl_xor_sync(0xffffffffu, ps, 1);
            ps += __shfl_xor_sync(0xffffffffu, ps, 2);
            lw[hf] = lw[hf] * alpha + ps;
            mw[hf] = m_new;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              acc[n][2 * hf] *= alpha;
              acc[n][2 * hf + 1] *= alpha;
            }
          }
          // P.V on m16n8k16, four 16-position k-steps. The weights (p, or
          // p * sv) as hi + lo bf16 parts in the A fragment: a[2jj + hf]
          // holds row g + 8hf at the positions of 8-position tile 2kk + jj.
          const unsigned char* vt = kt + HD * (int)sizeof(CT);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            unsigned ahi[4], alo[4];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int j = 2 * kk + jj;
                float w0 = s[j][2 * hf], w1 = s[j][2 * hf + 1];
                if constexpr (KIND == kI8) {
                  w0 *= skt[chunk + 8 * j + 2 * t];
                  w1 *= skt[chunk + 8 * j + 2 * t + 1];
                }
                const __nv_bfloat16 h0 = __float2bfloat16(w0), h1 = __float2bfloat16(w1);
                ahi[2 * jj + hf] = bf16x2(__bfloat162float(h0), __bfloat162float(h1));
                alo[2 * jj + hf] = bf16x2(w0 - __bfloat162float(h0), w1 - __bfloat162float(h1));
              }
#pragma unroll
            for (int np = 0; np < HD / 16; ++np) {
              unsigned bv[4];  // b0, b1 of column tiles 2np and 2np+1
              if constexpr (KIND == kFp) {
                ldmatrix_x4_trans(bv, vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * L::kKvStride +
                                          (16 * np + (lane >> 4) * 8) * 2);
              } else {  // int8 V -> bf16 pairs (exact)
                const int8_t* v0 = reinterpret_cast<const int8_t*>(vt) +
                                   (16 * kk + 2 * t) * L::kKvStride + 16 * np + g;
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  const int8_t* vv = v0 + (u >> 1) * 8 + (u & 1) * 8 * L::kKvStride;
                  bv[u] = bf16x2(static_cast<float>(vv[0]), static_cast<float>(vv[L::kKvStride]));
                }
              }
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                mma_bf16(acc[2 * np + u], ahi, bv[2 * u], bv[2 * u + 1]);
                mma_bf16(acc[2 * np + u], alo, bv[2 * u], bv[2 * u + 1]);
              }
            }
          }
        }
        if (active) put_mma(acc, mw, lw);
      } else if constexpr (KIND == kS8) {
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
        float mw[2] = {-CUDART_INF_F, -CUDART_INF_F}, lw[2] = {0.f, 0.f};
        // q8 of rows g, g+8, read as m16n8k32 A fragments where used.
        const unsigned char* q0 = q_s + (16 * warp + g) * L::kQStride + 4 * t;
        float qsc[2] = {0.f, 0.f};
        if (active) {
          qsc[0] = qsc_s[16 * warp + g];
          qsc[1] = qsc_s[16 * warp + g + 8];
        }
        for (int it = 0; it < nt; ++it) {
          arrive(it);
          if (!active) continue;
          const int t0 = p_begin + it * kTile;
          const unsigned char* kt = kv_s + it * kTile * L::kKvStride;
          const float* skt = sc_s + it * kTile;  // sk; sv at + chunk
          // Integer scores on m16n8k32: si[j] as the m16n8k16 C fragment.
          int si[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int u = 0; u < 4; ++u) si[j][u] = 0;
#pragma unroll
          for (int ks = 0; ks < HD / 32; ++ks) {
            const int qa[4] = {*reinterpret_cast<const int*>(q0 + 32 * ks),
                               *reinterpret_cast<const int*>(q0 + 8 * L::kQStride + 32 * ks),
                               *reinterpret_cast<const int*>(q0 + 32 * ks + 16),
                               *reinterpret_cast<const int*>(q0 + 8 * L::kQStride + 32 * ks + 16)};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const unsigned char* kr = kt + (8 * j + g) * L::kKvStride + 4 * t + 32 * ks;
              const int bfr[2] = {*reinterpret_cast<const int*>(kr),
                                  *reinterpret_cast<const int*>(kr + 16)};
              mma_s8(si[j], qa, bfr);
            }
          }
          // The tile's weights quantized per row from its own scores (the
          // plain version's rounding): e = exp(s - tmax), pq = e * sv,
          // ps = max(max pq, 1e-30) / 127, p8 = round(pq / ps). p8 goes
          // straight into the A fragments of P.V: byte 2jj' + u of a[2*(jj/2)
          // + hf] in k-step j/4 holds position 8j + 2t + u (jj = j % 4,
          // jj' = jj % 2), and V's B fragment is gathered in that order.
          const bool full = t0 + kTile <= full_end;
          int pa[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
          float f[2];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float x[8][2];
            float tmax = -CUDART_INF_F;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int pt = 8 * j + 2 * t + u;
                float v = __fmul_rn(__fmul_rn(static_cast<float>(si[j][2 * hf + u]), qsc[hf]),
                                    skt[pt]);
                if (!full && !attended(t0 + pt, row2[hf], fan2[hf])) v = -CUDART_INF_F;
                x[j][u] = v;
                tmax = fmaxf(tmax, v);
              }
            tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
            tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
            float esum = 0.f, pmax = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const float e = x[j][u] == -CUDART_INF_F ? 0.f : expf(x[j][u] - tmax);
                esum += e;
                x[j][u] = __fmul_rn(e, skt[chunk + 8 * j + 2 * t + u]);  // pq
                pmax = fmaxf(pmax, x[j][u]);
              }
            esum += __shfl_xor_sync(0xffffffffu, esum, 1);
            esum += __shfl_xor_sync(0xffffffffu, esum, 2);
            pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, 1));
            pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, 2));
            const float ps = fmaxf(pmax, 1e-30f) * kInv127;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const unsigned p8 = static_cast<unsigned>(__float2int_rn(x[j][u] / ps)) & 0xffu;
                const int jj = j & 3;
                pa[j >> 2][2 * (jj >> 1) + hf] |= static_cast<int>(p8 << (8 * (2 * (jj & 1) + u)));
              }
            const float m_new = fmaxf(mw[hf], tmax);
            const float alpha = mw[hf] == -CUDART_INF_F ? 0.f : expf(mw[hf] - m_new);
            const float cf = tmax == -CUDART_INF_F ? 0.f : expf(tmax - m_new);
            lw[hf] = lw[hf] * alpha + cf * esum;
            mw[hf] = m_new;
            f[hf] = cf * ps;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              acc[n][2 * hf] *= alpha;
              acc[n][2 * hf + 1] *= alpha;
            }
          }
          // P.V: two k32 steps over the tile's 64 positions into one int32
          // sum per 8-column tile; b[0] holds column 8n + g at positions
          // 32ks + 2t, +1, +8, +9 (b[1] the same + 16).
          const unsigned char* vt = kt + HD;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            int ti[4] = {0, 0, 0, 0};
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              const unsigned char* v0 = vt + (32 * ks + 2 * t) * L::kKvStride + 8 * n + g;
              int bfr[2];
#pragma unroll
              for (int hk = 0; hk < 2; ++hk) {
                const unsigned char* vv = v0 + 16 * hk * L::kKvStride;
                bfr[hk] = static_cast<int>(vv[0] | (vv[L::kKvStride] << 8) |
                                           (vv[8 * L::kKvStride] << 16) |
                                           (static_cast<unsigned>(vv[9 * L::kKvStride]) << 24));
              }
              mma_s8(ti, pa[ks], bfr);
            }
            acc[n][0] = fmaf(static_cast<float>(ti[0]), f[0], acc[n][0]);
            acc[n][1] = fmaf(static_cast<float>(ti[1]), f[0], acc[n][1]);
            acc[n][2] = fmaf(static_cast<float>(ti[2]), f[1], acc[n][2]);
            acc[n][3] = fmaf(static_cast<float>(ti[3]), f[1], acc[n][3]);
          }
        }
        if (active) put_mma(acc, mw, lw);
      } else {
        // fp32 q: the warp's 16 rows; lane = positions lane and lane + 32
        // for the scores, columns lane + 32k for P.V.
        constexpr int NCL = HD / 32;
        constexpr int KS = L::kKvStride / (int)sizeof(CT);  // elements per slot row
        float acc[16][NCL];
        float mr[16], lr[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          mr[k] = -CUDART_INF_F;
          lr[k] = 0.f;
#pragma unroll
          for (int n = 0; n < NCL; ++n) acc[k][n] = 0.f;
        }
        float* pw = p_s + warp * 16 * L::kPStride;
        const float* qw = reinterpret_cast<const float*>(q_s + 16 * warp * L::kQStride);
        for (int it = 0; it < nt; ++it) {
          arrive(it);
          if (!active) continue;
          const int t0 = p_begin + it * kTile;
          const CT* kt = reinterpret_cast<const CT*>(kv_s + it * kTile * L::kKvStride);
          const float* skt = sc_s + it * kTile;
          float s[16][2];
#pragma unroll
          for (int k = 0; k < 16; ++k) s[k][0] = s[k][1] = 0.f;
#pragma unroll 2
          for (int d0 = 0; d0 < HD; d0 += 8) {
            float ka[8], kb[8];
            load8(kt + lane * KS + d0, ka);
            load8(kt + (lane + 32) * KS + d0, kb);
#pragma unroll
            for (int k = 0; k < 16; ++k) {
              const float* qr = qw + k * (L::kQStride / 4) + d0;
              const float4 q0 = *reinterpret_cast<const float4*>(qr);
              const float4 q1 = *reinterpret_cast<const float4*>(qr + 4);
              const float qv[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                s[k][0] = fmaf(ka[e], qv[e], s[k][0]);
                s[k][1] = fmaf(kb[e], qv[e], s[k][1]);
              }
            }
          }
          const bool full = t0 + kTile <= full_end;
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const int row = full ? 0 : row_of(wr + k), fan = full ? 0 : fan_of(wr + k);
            float x[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int pt = lane + 32 * u;
              x[u] = s[k][u] * a.scale;
              if constexpr (KIND == kI8) x[u] *= skt[pt];
              if (!full && !attended(t0 + pt, row, fan)) x[u] = -CUDART_INF_F;
            }
            const float m_new = fmaxf(mr[k], warp_max(fmaxf(x[0], x[1])));
            const float alpha = mr[k] == -CUDART_INF_F ? 0.f : expf(mr[k] - m_new);
            float e[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) e[u] = x[u] == -CUDART_INF_F ? 0.f : expf(x[u] - m_new);
            lr[k] = lr[k] * alpha + warp_sum(e[0] + e[1]);
            mr[k] = m_new;
#pragma unroll
            for (int u = 0; u < 2; ++u)
              pw[k * L::kPStride + lane + 32 * u] =
                  KIND == kI8 ? e[u] * skt[chunk + lane + 32 * u] : e[u];
#pragma unroll
            for (int n = 0; n < NCL; ++n) acc[k][n] *= alpha;
          }
          __syncwarp();
          const CT* vt = kt + HD;
#pragma unroll 4
          for (int j = 0; j < kTile; ++j) {
            float v[NCL];
#pragma unroll
            for (int n = 0; n < NCL; ++n) {
              if constexpr (KIND == kFp)
                v[n] = to_float(vt[j * KS + lane + 32 * n]);
              else
                v[n] = static_cast<float>(vt[j * KS + lane + 32 * n]);
            }
#pragma unroll
            for (int k = 0; k < 16; ++k) {
              const float p = pw[k * L::kPStride + j];
#pragma unroll
              for (int n = 0; n < NCL; ++n) acc[k][n] = fmaf(p, v[n], acc[k][n]);
            }
          }
          __syncwarp();  // the next tile rewrites the weights
        }
        if (active)
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const int r = wr + k;
            if (r >= R) continue;
            if (n_live <= 1) {
              T* orow = og + q_at(r);
#pragma unroll
              for (int n = 0; n < NCL; ++n)
                if (lane + 32 * n < hd)
                  orow[lane + 32 * n] = from_float<T>(lr[k] > 0.f ? acc[k][n] / lr[k] : 0.f);
            } else {
              float* wrow = ws_acc + ((size_t)c * R + r) * HD;
#pragma unroll
              for (int n = 0; n < NCL; ++n) wrow[lane + 32 * n] = acc[k][n];
              if (lane == 0) ws_ml[(size_t)c * R + r] = make_float2(mr[k], lr[k]);
            }
          }
      }
    }
  }
  cp_async_wait<0>();
  if (n_live <= 1) return;

  // The last block of (b, h) to finish merges the partials in chunk order.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int mine = c_last - c_first;
    *last_s = atomicAdd(a.counters + bh, mine) == n_live - mine;
  }
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  // Rows in groups of kMergeRows, chunks in batches of 32; the chunk's
  // shared memory is free now. Each batch's (m, l) go to shared memory in
  // one round of loads; a thread per row takes the largest m, then each
  // chunk's weight exp(m_c - m) (0 where the row attends nothing in that
  // chunk) and L = sum l_c * weight. Every thread owns fixed 4-column
  // slices of the group's rows and sums acc_c * weight over the chunks in
  // chunk order, with the loads of DJ chunks in flight at a time.
  float2* ml_s = reinterpret_cast<float2*>(kv_s);                // [kMergeRows][32]
  float* f_s = reinterpret_cast<float*>(ml_s + kMergeRows * 32);   // [kMergeRows][32]
  float* L_s = f_s + kMergeRows * 32;
  constexpr int C4 = HD / 4;                                       // 4-column slices a row
  constexpr int NS = kMergeRows * C4 / kThreads;                   // slices a thread
  constexpr int DJ = HD == 64 ? 2 : 1;
  auto load_ml = [&](int g0, int ng, int c0, int nb) {
    for (int e = tid; e < ng * 32; e += kThreads) {
      const int rr = e / 32, j = e % 32;
      if (j < nb) ml_s[e] = __ldcg(ws_ml + (size_t)(c0 + j) * R + g0 + rr);
    }
  };
  for (int g0 = 0; g0 < R; g0 += kMergeRows) {
    const int ng = min(kMergeRows, R - g0);
    float mx = -CUDART_INF_F;  // thread rr < ng: its row's largest m
    for (int c0 = 0; c0 < n_live; c0 += 32) {
      const int nb = min(32, n_live - c0);
      __syncthreads();  // the previous group or batch is done with ml_s
      load_ml(g0, ng, c0, nb);
      __syncthreads();
      if (tid < ng)
        for (int j = 0; j < nb; ++j) mx = fmaxf(mx, ml_s[tid * 32 + j].x);
    }
    float Ls = 0.f;
    float4 acc[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < n_live; c0 += 32) {
      const int nb = min(32, n_live - c0);
      if (n_live > 32) {  // otherwise the one batch is still in ml_s
        __syncthreads();
        load_ml(g0, ng, c0, nb);
        __syncthreads();
      }
      if (tid < ng)
        for (int j = 0; j < nb; ++j) {
          const float2 v = ml_s[tid * 32 + j];
          const float f = mx == -CUDART_INF_F || v.x == -CUDART_INF_F ? 0.f : expf(v.x - mx);
          f_s[tid * 32 + j] = f;
          Ls = fmaf(v.y, f, Ls);
        }
      __syncthreads();  // the weights are in
      for (int j = 0; j < nb; j += DJ) {
        float4 x[DJ][NS];
#pragma unroll
        for (int u = 0; u < DJ; ++u)
#pragma unroll
          for (int k = 0; k < NS; ++k) {
            const int sl = tid + k * kThreads, rr = sl / C4;
            x[u][k] = rr < ng && j + u < nb
                          ? __ldcg(reinterpret_cast<const float4*>(
                                ws_acc + ((size_t)(c0 + j + u) * R + g0 + rr) * HD) + sl % C4)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
        for (int u = 0; u < DJ; ++u)
#pragma unroll
          for (int k = 0; k < NS; ++k) {
            const int rr = (tid + k * kThreads) / C4;
            if (rr < ng && j + u < nb) {
              const float f = f_s[rr * 32 + j + u];
              acc[k].x = fmaf(x[u][k].x, f, acc[k].x);
              acc[k].y = fmaf(x[u][k].y, f, acc[k].y);
              acc[k].z = fmaf(x[u][k].z, f, acc[k].z);
              acc[k].w = fmaf(x[u][k].w, f, acc[k].w);
            }
          }
      }
    }
    if (tid < ng) L_s[tid] = Ls;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int sl = tid + k * kThreads, rr = sl / C4, c4 = sl % C4;
      if (rr >= ng) continue;
      const float Lr = L_s[rr];
      T* o = og + q_at(g0 + rr) + 4 * c4;
      const float v[4] = {acc[k].x, acc[k].y, acc[k].z, acc[k].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * c4 + e < hd) o[e] = from_float<T>(Lr > 0.f ? v[e] / Lr : 0.f);
    }
  }
  if (tid == 0) a.counters[bh] = 0;  // ready for the stream's next call
}

template <typename T, int HD, int KIND, bool PAD>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  const Layout<T, HD, KIND> lay(a.chunk);
  if (lay.bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto* kern = tree_split_kernel<T, HD, KIND, PAD>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int NC = (a.M * a.bs + a.chunk - 1) / a.chunk;
  kern<<<dim3((NC + a.per_block - 1) / a.per_block, a.Hkv, B), kThreads, lay.bytes, st>>>(a);
  return cudaGetLastError();
}

// By padded width (common.cuh::padded_head_dim), unpadded (hd = HP) or
// padded; the s8 kind takes hd 64, 128, 192 and 256 unpadded (the wrappers
// send it nothing else).
template <typename T, int HP, int KIND>
cudaError_t launch_width(int hd, const Args& a, int B, cudaStream_t st) {
  if (hd == HP) return launch<T, HP, KIND, false>(a, B, st);
  if constexpr (KIND == kS8) return cudaErrorInvalidValue;
  else return launch<T, HP, KIND, true>(a, B, st);
}

template <typename T, int KIND>
cudaError_t dispatch_width(int hd, const Args& a, int B, cudaStream_t st) {
  const int hp = padded_head_dim(hd);
  if (hp == 64) return launch_width<T, 64, KIND>(hd, a, B, st);
  if (hp == 128) return launch_width<T, 128, KIND>(hd, a, B, st);
  if (hp == 192) return launch_width<T, 192, KIND>(hd, a, B, st);
  if (hp == 256) return launch_width<T, 256, KIND>(hd, a, B, st);
  return cudaErrorInvalidValue;
}

template <int KIND>
cudaError_t dispatch(int dtype, int hd, const Args& a, int B, cudaStream_t st) {
  if (dtype == kFloat32) return dispatch_width<float, KIND>(hd, a, B, st);
  if (dtype == kBFloat16) return dispatch_width<__nv_bfloat16, KIND>(hd, a, B, st);
  return cudaErrorInvalidValue;
}

// Shared memory of one instantiation at `chunk` (the resource report of
// chip_smoke.py, and the check of the wrappers' TREE_CHUNK); -1 for a
// combination not built.
inline int smem_bytes(int kind, int dtype, int hd, int chunk) {
  const int hp = padded_head_dim(hd);
  auto pick = [&](auto k) -> int {
    constexpr int K = decltype(k)::value;
    auto at = [&](auto t) -> int {
      using T = decltype(t);
      return hp == 64 ? Layout<T, 64, K>(chunk).bytes
           : hp == 128 ? Layout<T, 128, K>(chunk).bytes
           : hp == 192 ? Layout<T, 192, K>(chunk).bytes
           : hp == 256 ? Layout<T, 256, K>(chunk).bytes : -1;
    };
    if (dtype == kFloat32) return at(0.f);
    if (dtype == kBFloat16) return at(__nv_bfloat16{});
    return -1;
  };
  return kind == kFp ? pick(std::integral_constant<int, kFp>{})
       : kind == kI8 ? pick(std::integral_constant<int, kI8>{})
       : kind == kS8 ? pick(std::integral_constant<int, kS8>{}) : -1;
}

// The entries' argument checks.
inline bool valid(int B, int MQ, int Hq, int Hkv, int M, int bs, int step, int K, int chunk,
                  int per_block) {
  return B > 0 && MQ > 0 && Hkv > 0 && Hq % Hkv == 0 && M > 0 && bs > 0 && step >= 0 &&
         step < K && chunk > 0 && chunk % kTile == 0 && per_block > 0 &&
         chunk * per_block <= kMaxChunk;
}

}  // namespace tree
}  // namespace ssd
