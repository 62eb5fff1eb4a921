// The split-KV skeleton of the paged decode/verify kernels: K2
// (csrc/paged_attention.cu, bf16/fp32 pages) and K4
// (csrc/paged_attention_int8.cu, int8 pages in both kv_quant modes) are this
// one kernel, instantiated per cache kind.
//
// Contract (the entries' headers state it in full): q [B, Q, Hq, hd]; a
// layer [Hkv, S, 2*hd] with K in [0, hd) and V in [hd, 2*hd) of each slot
// row (f32 scales [Hkv, 2, S] beside an int8 layer); block_tables [B, M],
// where -1 reads page 0; query i of sequence b attends p <= ctx - qeff + i
// with p < min(ctx, M * block_size); rows that attend nothing give zeros;
// any block size; any even hd in [16, 256] (the template's HD is the padded
// width, 64, 128, 192 or 256, common.cuh::padded_head_dim; the s8 kind only
// at hd = HD).
//
// What bounds it on an H100: bytes. Every attended K|V row is read once per
// call; at decode each byte feeds Q * G query rows (4-72 here), far below
// the ~295 operations per byte where the tensor cores would bound it. The
// design:
//  1. Split-KV. The grid is (chunks, Hkv, B): block (c, h, b) walks the
//     positions [c * chunk, (c + 1) * chunk) of sequence b, KV head h. The
//     chunk length is a multiple of 64 positions and depends on the head
//     width and the cache kind only (the wrapper's PAGED_CHUNK), so a row's
//     result depends on neither the batch, nor Q, nor the other rows.
//  2. The chunk's K|V goes through a cp.async ring of page tiles: each
//     slot's K|V row is 2 * hd contiguous elements, copied as 16-byte pieces
//     by neighbouring threads (narrower where hd * esize is no multiple of
//     16, and the pad lanes of a padded width zero-filled: common.cuh), and,
//     for int8, its two scales as 4-byte copies, gathered through the page
//     table (the chunk's slots resolved once, into shared memory). The next
//     tiles stay in flight while one is used; the query rows' copies go out
//     with the first tiles'.
//  3. bf16 q over the fp cache or the "int8" mode ("warp-split"): 64-position
//     tiles, three stages (two at bf16 hd 128). Each warp owns 16 of every 64
//     positions, all columns and 16 query rows, and keeps its own online
//     softmax in registers: Q.K^T on mma.sync m16n8k16 with fp32 sums (bf16
//     products are exact in fp32; int8 k -> bf16 is exact too, then
//     * scale * sk); the scores' row max and sum over a quad of lanes; P
//     split into hi = bf16(p) and lo = bf16(p - hi) (p * sv for int8) and
//     fed straight from the score fragments into two P.V mmas on one fp32
//     accumulator (P carries ~16 bits, not 8). No block barrier but the
//     ring's per tile; the four warps' states merge at the end of a pass.
//     A pass holds 16 rows: R = Q * G above 16 takes several passes over the
//     chunk (the re-reads hit L2). One instantiation serves every Q, which
//     is what keeps a row's bits independent of Q; holding more rows would
//     need more accumulators than the registers allow at hd 128.
//  4. int8_mxu (any q dtype) and fp32 q: 32-position tiles, three stages, all
//     rows of the head in one pass in 16-row tiles (up to 64 rows a pass).
//     Warp w scores positions 8w..8w+7 of every row into shared memory; one
//     warp per row takes the online softmax (for int8_mxu with each tile's
//     weights quantized from its own scores, as the plain version does);
//     warp w accumulates P.V for columns [w * hd/4, (w+1) * hd/4). int8_mxu
//     runs q8.k8 and p8.v8 on mma.sync m16n8k32 s8 with int32 sums; fp32 q
//     stays on fp32 FMAs, no TF32.
//  5. Each block ends with its rows' partial softmax state (m, l, acc) in
//     fp32. With one live chunk it writes the output itself; otherwise it
//     writes the partial to a workspace the wrapper allocates per call on
//     the caller's stream, and the last block of each (b, h) to finish
//     (found through a per-stream counter, incremented once per block and
//     reset by that last block) merges the partials in chunk order: a chunk
//     in which a row attends nothing (m = -inf) weighs 0, never NaN. No
//     data atomics, so results are bitwise repeatable.
//
// Every sum is taken in an order fixed by the positions alone, so a row's
// result is bitwise the same alone, in a batch, or beside other queries, as
// the tests check on the card.
//
// Stage variants (template STAGE, bench probe bench/kernel_diag.py): "loads"
// runs the ring and no math; "math" loads the chunk's first tile once and
// runs the dots and the softmax of every tile on it; "empty" does neither
// (grid, query rows, partials and merge). "full" is the production kernel.
// The variants are built for the warp-split kinds (bf16 q) only.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ssd {
namespace paged {

enum Kind : int { kFp = 0, kI8 = 1, kS8 = 2 };

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;       // positions per ring stage (= the s8 tile); twice that warp-split
constexpr int kMergeRows = 32;  // rows the last block merges at a time
constexpr int kMaxChunk = 512;  // positions one block walks, at most (its slots in shared memory)

struct Args {
  const void* q;
  const void* kv;
  const float* scales;  // int8 kinds: [Hkv, 2, S]
  const int* block_tables;
  const int* context_lens;
  const int* qeff;
  void* out;
  float* ws;      // partials: acc [B, Hkv, NC, R, hd], then (m, l) [B, Hkv, NC, R, 2]
  int* counters;  // [B * Hkv], zero between calls
  int Q, Hq, Hkv;
  long long S;
  int M, bs, chunk;
  int per_block;  // consecutive chunks each block takes
  float scale;
  int hd;         // the head dim, even, at most the instantiation's padded width
};

constexpr int kMaxSmem = 232448;  // an H100 block's shared memory (227 KB)

// Shared-memory layout of one instantiation (byte offsets, 16-aligned).
template <typename T, int HD, int MT, int KIND>
struct Layout {
  using CT = std::conditional_t<KIND == kFp, T, int8_t>;  // cache element
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool kMma = KIND == kS8 || kBf16;
  static constexpr int kRows = 16 * MT;
  static constexpr int kRowBytes = 2 * HD * (int)sizeof(CT);  // one slot's K|V
  static constexpr int kKvStride = kRowBytes + 16;             // padded: no bank conflicts
  static constexpr int kQStride = KIND == kS8 ? HD + 16 : kMma ? 2 * (HD + 8) : 4 * (HD + 4);
  static constexpr int kSStride = kTile + 4;                   // floats
  static constexpr int kPStride = KIND == kS8 ? kTile + 16 : kTile + 8;  // int8 / bf16
  // bf16 q over the fp cache or the "int8" mode: each warp owns 16 of every
  // 64 positions with its own online softmax (see the kernel), 16 rows a pass.
  static constexpr bool kWarpSplit = kBf16 && KIND != kS8;
  static constexpr int kTileL = kWarpSplit ? 2 * kTile : kTile;  // positions per stage
  // The warps' partial states, merged at the end of a pass (over the ring).
  static constexpr int kWarpMerge = kWarpSplit ? kWarps * 16 * (HD + 2) * 4 : 0;
  static constexpr int kPBytes = KIND == kS8 ? kRows * kPStride : kMma ? 2 * kRows * kPStride * 2 : 0;
  // Bytes of the layout below past the ring and its scales, and in all at
  // three stages.
  static constexpr int kRest = kRows * kQStride + kRows * kSStride * 4 + kPBytes +
                               5 * kRows * 4 + kMaxChunk * 4 + 16;
  static constexpr int kRing3 = 3 * kTileL * kKvStride;
  static constexpr int kBytes3 = (kRing3 > kWarpMerge ? kRing3 : kWarpMerge) +
                                 (KIND == kFp ? 0 : 3 * 2 * kTileL * 4) + kRest;
  // Ring depth: three stages; two for bf16 warp-split over the fp cache from
  // hd 128 up, where a third 33 KB stage (hd 128) would cost a block per SM,
  // and wherever three would not fit (fp32 at HD 256, four row tiles).
  static constexpr int kStagesL =
      (kWarpSplit && KIND == kFp && HD >= 128) || kBytes3 > kMaxSmem ? 2 : 3;
  static constexpr int kRing = kStagesL * kTileL * kKvStride;
  static constexpr int kKv = 0;
  static constexpr int kSc = kKv + (kRing > kWarpMerge ? kRing : kWarpMerge);
  static_assert((2 + 32 + HD) * kMergeRows * 4 <= kSc, "the merge's scratch must fit the ring");
  static constexpr int kQ = kSc + (KIND == kFp ? 0 : kStagesL * 2 * kTileL * 4);
  static constexpr int kS = kQ + kRows * kQStride;
  static constexpr int kP = kS + kRows * kSStride * 4;
  static constexpr int kRowF = kP + kPBytes;                   // alpha, f, qsc, m, l per row
  static constexpr int kSlots = kRowF + 5 * kRows * 4;
  static constexpr int kBytes = kSlots + kMaxChunk * 4 + 16;   // + the last-block flag
  static_assert(kBytes <= kMaxSmem, "the layout must fit a block's shared memory");
};

// PAD: the instantiation for hd < HD (the lanes past hd zero, rows copied in
// pieces as wide as hd allows); without it hd = HD, every offset a constant,
// so the padded path costs the unpadded one no registers.
template <typename T, int HD, int MT, int KIND, int STAGE, bool PAD>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(const Args a) {
  using L = Layout<T, HD, MT, KIND>;
  using CT = typename L::CT;
  constexpr int TP = L::kTileL, NS = L::kStagesL;
  constexpr int ROWS = L::kRows;
  constexpr int RPW = ROWS / kWarps;  // rows each warp's softmax owns
  constexpr bool kLoad = STAGE == kStageFull || STAGE == kStageLoads;
  constexpr bool kMath = STAGE == kStageFull || STAGE == kStageMath;
  constexpr bool kRun = STAGE != kStageEmpty;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* kv_s = smem + L::kKv;
  float* sc_s = reinterpret_cast<float*>(smem + L::kSc);
  unsigned char* q_s = smem + L::kQ;
  float* s_s = reinterpret_cast<float*>(smem + L::kS);
  unsigned char* p_s = smem + L::kP;
  float* alpha_s = reinterpret_cast<float*>(smem + L::kRowF);
  float* f_s = alpha_s + ROWS;
  float* qsc_s = f_s + ROWS;
  float* m_s = qsc_s + ROWS;
  float* l_s = m_s + ROWS;
  int* slot_s = reinterpret_cast<int*>(smem + L::kSlots);
  int* last_s = slot_s + kMaxChunk;

  const int h = blockIdx.y, b = blockIdx.z;
  const int NC = (a.M * a.bs + a.chunk - 1) / a.chunk, Hkv = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = a.Hq / Hkv, R = a.Q * G;
  const int ctx = a.context_lens[b];
  const int kv_len = min(ctx, a.M * a.bs);
  const int first_limit = ctx - a.qeff[b];  // query i attends p <= first_limit + i
  const int n_pos = max(0, min(kv_len, first_limit + a.Q));
  const int n_live = (n_pos + a.chunk - 1) / a.chunk;
  // This block's chunks: [c_first, c_last), `per_block` consecutive ones
  // (the mapping of chunks to blocks changes no result).
  const int c_first = blockIdx.x * a.per_block;
  if (c_first >= max(n_live, 1)) return;
  const int c_last = min(c_first + a.per_block, max(n_live, 1));
  const int span0 = c_first * a.chunk;
  const int bh = b * Hkv + h;
  const int hd = PAD ? a.hd : HD;
  const int hb = hd * (int)sizeof(CT);  // bytes of a K or V half in device memory
  const int gran_kv = copy_granule(hb), gran_q = copy_granule(hd * (int)sizeof(T));
  const CT* kv_h = static_cast<const CT*>(a.kv) + (size_t)h * a.S * (2 * hd);
  const float* sk_h = a.scales + (size_t)h * 2 * a.S;  // int8: K scales; V scales at + S
  const T* qg = static_cast<const T*>(a.q);
  T* og = static_cast<T*>(a.out);
  float* ws_acc = a.ws + (size_t)bh * NC * R * HD;
  float2* ws_ml = reinterpret_cast<float2*>(a.ws + (size_t)gridDim.z * Hkv * NC * R * HD) +
                  (size_t)bh * NC * R;

  // Warp-split kinds: a pass's 16 query rows by cp.async (zeros past R and
  // past hd), one commit group ahead of its first tiles', so their latencies
  // overlap; pass 0's go out before the page-table reads.
  auto load_q = [&](int r0, int nr) {
    if constexpr (!PAD) {  // 16-byte pieces at fixed offsets
      constexpr int QP = HD * 2 / 16;  // 16-byte pieces per row
      for (int e = tid; e < 16 * QP; e += kThreads) {
        const int rr = e / QP, piece = e % QP, r = r0 + rr;
        const bool live = rr < nr;
        const T* src = live ? qg + (((size_t)b * a.Q + r / G) * a.Hq + h * G + r % G) * HD + piece * 8
                            : qg;
        cp_async16(q_s + rr * L::kQStride + piece * 16, src, live);
      }
    } else {
      with_granule<(int)sizeof(T)>(gran_q, [&](auto gc) {
        constexpr int GR = decltype(gc)::value;
        constexpr int QP = HD * (int)sizeof(T) / GR;  // pieces per padded row
#pragma unroll 1
        for (int e = tid; e < 16 * QP; e += kThreads) {
          const int rr = e / QP, off = (e % QP) * GR, r = r0 + rr;
          const bool live = rr < nr && off < hd * (int)sizeof(T);
          const unsigned char* src =
              live ? reinterpret_cast<const unsigned char*>(
                         qg + (((size_t)b * a.Q + r / G) * a.Hq + h * G + r % G) * hd) + off
                   : reinterpret_cast<const unsigned char*>(qg);
          copy_piece<GR>(q_s + rr * L::kQStride + off, src, live);
        }
      });
    }
    cp_async_commit();
  };
  if constexpr (L::kWarpSplit) load_q(0, min(16, R));

  // The chunks' slots, through the page table (-1 reads page 0).
  for (int p = span0 + tid; p < min(c_last * a.chunk, n_pos); p += kThreads)
    slot_s[p - span0] = max(a.block_tables[(size_t)b * a.M + p / a.bs], 0) * a.bs + p % a.bs;

  for (int c = c_first; c < c_last; ++c) {
    const int p_begin = c * a.chunk;
    const int c_end = min(p_begin + a.chunk, n_pos);
    for (int r0 = 0; r0 < R; r0 += ROWS) {
      const int nr = min(ROWS, R - r0);
      // This pass's positions: up to its last row's causal limit.
      const int p_end = min(c_end, max(0, min(kv_len, first_limit + (r0 + nr - 1) / G + 1)));
      const int nt = p_end > p_begin ? (p_end - p_begin + TP - 1) / TP : 0;

      // Per-row softmax state, owned by warp (row % 4), replicated in its lanes.
      float m_r[RPW], l_r[RPW];
      int lim_r[RPW];
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int rr = warp + kWarps * k;
        m_r[k] = -CUDART_INF_F;
        l_r[k] = 0.f;
        lim_r[k] = rr < nr ? first_limit + (r0 + rr) / G : -1;
      }
      // The P.V accumulators: with tensor cores warp w owns output columns
      // [w * HD/4, (w+1) * HD/4) of every row tile (NT 8-column tiles); on
      // fp32 FMAs thread tid owns the (row, column) pairs e = tid + k *
      // kThreads of the pass, row e / HD, column e % HD.
      constexpr int NT = HD / 32;
      constexpr int NACC = L::kMma ? MT * NT * 4 : ROWS * HD / kThreads;
      static_assert(L::kMma || ROWS * HD % kThreads == 0, "whole (row, column) pairs a thread");
      float acc[NACC];
#pragma unroll
      for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
      const int col0 = warp * (HD / 4);

      auto stage_kv = [&](int s) { return kv_s + s * TP * L::kKvStride; };
      auto load_tile = [&](int s, int t0) {
        unsigned char* dst = stage_kv(s);
        if constexpr (!PAD) {  // 16-byte pieces at fixed offsets
          constexpr int CPR = L::kRowBytes / 16;  // 16-byte pieces per slot row
          for (int e = tid; e < TP * CPR; e += kThreads) {
            const int row = e / CPR, piece = e % CPR, p = t0 + row;
            const bool live = p < p_end;
            const CT* src = live ? kv_h + (size_t)slot_s[p - span0] * (2 * HD) : kv_h;
            cp_async16(dst + row * L::kKvStride + piece * 16,
                       reinterpret_cast<const unsigned char*>(src) + (live ? piece * 16 : 0), live);
          }
        } else {
          with_granule<(int)sizeof(CT)>(gran_kv, [&](auto gc) {
            constexpr int GR = decltype(gc)::value;
            constexpr int CPR = L::kRowBytes / GR;  // pieces per padded slot row
#pragma unroll 1
            for (int e = tid; e < TP * CPR; e += kThreads) {
              const int row = e / CPR, p = t0 + row;
              const RowPiece pc = kv_row_piece<GR, HD * (int)sizeof(CT)>(e % CPR, hb);
              const bool live = p < p_end && pc.data;
              const unsigned char* src =
                  live ? reinterpret_cast<const unsigned char*>(kv_h + (size_t)slot_s[p - span0] * (2 * hd)) +
                             pc.src
                       : reinterpret_cast<const unsigned char*>(kv_h);
              copy_piece<GR>(dst + row * L::kKvStride + pc.dst, src, live);
            }
          });
        }
        if constexpr (KIND != kFp) {
          for (int e = tid; e < 2 * TP; e += kThreads) {
            const int which = e / TP, row = e % TP, p = t0 + row;
            const bool live = p < p_end;
            const float* src = live ? sk_h + which * a.S + slot_s[p - span0] : sk_h;
            cp_async4(sc_s + (s * 2 + which) * TP + row, src, live);
          }
        }
      };

      __syncthreads();  // the slots are in; the previous pass is done
      if constexpr (L::kWarpSplit) {
        // Pass 0's rows of the first chunk went out before the slots; with
        // one pass they stay for the block's later chunks.
        if (r0 > 0 || (c > c_first && R > 16)) load_q(r0, nr);
      }
      // The first tiles' copies go out before the query rows are read, so
      // the two latencies overlap.
      if constexpr (kRun) {
        if constexpr (kLoad) {
#pragma unroll
          for (int s = 0; s < NS - 1; ++s) {
            if (s < nt) load_tile(s, p_begin + s * TP);
            cp_async_commit();
          }
        } else {  // kStageMath: the first tile, once
          if (nt > 0) load_tile(0, p_begin);
          cp_async_commit();
          cp_async_wait<0>();
        }
      }
      // Query rows of the pass (rows past R are zeros).
      if constexpr (KIND == kS8) {
        // Each row quantized once: qs = max(max|q|, 1e-30) / 127, q8 = round(q / qs).
        for (int rr = warp; rr < ROWS; rr += kWarps) {
          int8_t* q8 = reinterpret_cast<int8_t*>(q_s + rr * L::kQStride);
          if (rr < nr) {  // the s8 kind runs at hd = HD only
            const int r = r0 + rr, i = r / G, gg = r % G;
            const T* qrow = qg + (((size_t)b * a.Q + i) * a.Hq + h * G + gg) * HD;
            float amax = 0.f;
            for (int d = lane; d < HD; d += 32) amax = fmaxf(amax, fabsf(to_float(qrow[d])));
            const float qs = fmaxf(warp_max(amax), 1e-30f) * kInv127;
            for (int d = lane; d < HD; d += 32) q8[d] = static_cast<int8_t>(__float2int_rn(to_float(qrow[d]) / qs));
            if (lane == 0) qsc_s[rr] = __fmul_rn(qs, a.scale);
          } else {
            for (int d = lane; d < HD; d += 32) q8[d] = 0;
            if (lane == 0) qsc_s[rr] = 0.f;
          }
        }
      } else if constexpr (L::kWarpSplit) {
        cp_async_wait<kRun && kLoad ? NS - 1 : 0>();  // the query rows landed
      } else {
        for (int e = tid; e < ROWS * HD; e += kThreads) {
          const int rr = e / HD, d = e % HD;
          float val = 0.f;
          if (rr < nr && (!PAD || d < hd)) {
            const int r = r0 + rr, i = r / G, gg = r % G;
            val = to_float(qg[(((size_t)b * a.Q + i) * a.Hq + h * G + gg) * hd + d]);
          }
          if constexpr (L::kMma)
            reinterpret_cast<__nv_bfloat16*>(q_s + rr * L::kQStride)[d] = __float2bfloat16(val);
          else
            reinterpret_cast<float*>(q_s + rr * L::kQStride)[d] = val;
        }
      }

      __syncthreads();  // the query rows are in
      // Warp-split state: rows g and g+8 of the pass in each quad, all
      // columns (NTW 8-column tiles), the query fragments in registers.
      constexpr bool kWS = L::kWarpSplit;
      constexpr int NTW = kWS ? HD / 8 : 1;
      float accw[NTW][4];
      float mw[2] = {-CUDART_INF_F, -CUDART_INF_F}, lw[2] = {0.f, 0.f};
      int limw[2] = {-1, -1};
      unsigned qa[kWS ? HD / 16 : 1][4];
      if constexpr (kWS) {
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) accw[n][j] = 0.f;
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks)
          ldmatrix_x4(qa[ks], q_s + (lane & 15) * L::kQStride + (16 * ks + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (g + 8 * hf < nr) limw[hf] = first_limit + (r0 + g + 8 * hf) / G;
      }
      unsigned chk = 0;  // kStageLoads: bits of the loaded tiles, kept alive
      for (int it = 0; kRun && it < nt; ++it) {
        const int t0 = p_begin + it * TP;
        if constexpr (kLoad) {
          cp_async_wait<NS - 2>();
          __syncthreads();  // tile `it` landed; tile it-1 is no longer read
          const int nx = it + NS - 1;
          if (nx < nt) load_tile(nx % NS, p_begin + nx * TP);
          cp_async_commit();
        } else {
          __syncthreads();
        }
        const int st = kLoad ? it % NS : 0;
        const unsigned char* kt = stage_kv(st);
        const float* skt = sc_s + st * 2 * TP;  // sk [TP], then sv [TP]
        if constexpr (!kMath) {
          chk ^= reinterpret_cast<const unsigned*>(kt)[tid];
          continue;
        }

        if constexpr (kWS) {
          // Warp w: positions 16w..16w+15 of the 64-position tile, all 16
          // rows, all columns; no block barrier until the next tile. Scores on
          // mma m16n8k16, two 8-position tiles: sa[j][0..1] row g, sa[j][2..3]
          // row g+8, positions 16w + 8j + 2t, +1.
          float sa[2][4] = {};
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int kk = 0; kk < HD / 32; ++kk) {
              unsigned bfr[4];
              const int prow = warp * 16 + 8 * j;
              if constexpr (KIND == kFp) {
                ldmatrix_x4(bfr, kt + (prow + (lane & 7)) * L::kKvStride +
                                     (32 * kk + (lane >> 3) * 8) * 2);
              } else {
                const unsigned char* kr = kt + (prow + g) * L::kKvStride + 32 * kk + 2 * t;
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  bfr[q] = s8x2_to_bf16x2(*reinterpret_cast<const short*>(kr + 8 * q));
              }
              mma_bf16(sa[j], qa[2 * kk], bfr[0], bfr[1]);
              mma_bf16(sa[j], qa[2 * kk + 1], bfr[2], bfr[3]);
            }
          // Online softmax over the warp's 16 positions (a quad holds a row's
          // 16); rows g+8 are all padding when the pass has <= 8 rows.
          const int pc = warp * 16 + 2 * t;
          unsigned ahi[4] = {0u, 0u, 0u, 0u}, alo[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            if (hf == 1 && nr <= 8) break;
            float x[2][2];
            bool ok[2][2];
            float mx = -CUDART_INF_F;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int pt = pc + 8 * j + u;
                float sc = sa[j][2 * hf + u] * a.scale;
                if constexpr (KIND == kI8) sc *= skt[pt];
                ok[j][u] = t0 + pt < p_end && t0 + pt <= limw[hf];
                x[j][u] = ok[j][u] ? sc : -CUDART_INF_F;
                mx = fmaxf(mx, x[j][u]);
              }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(mw[hf], mx);
            const float alpha = mw[hf] == -CUDART_INF_F ? 0.f : expf(mw[hf] - m_new);
            float e[2][2], ps = 0.f;
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                e[j][u] = ok[j][u] ? expf(x[j][u] - m_new) : 0.f;
                ps += e[j][u];
              }
            ps += __shfl_xor_sync(0xffffffffu, ps, 1);
            ps += __shfl_xor_sync(0xffffffffu, ps, 2);
            lw[hf] = lw[hf] * alpha + ps;
            mw[hf] = m_new;
#pragma unroll
            for (int n = 0; n < NTW; ++n) {
              accw[n][2 * hf] *= alpha;
              accw[n][2 * hf + 1] *= alpha;
            }
            // The P.V weights (p, or p * sv) as hi + lo bf16 parts, in the A
            // fragment: a[hf] positions 2t, 2t+1 of the warp's 16, a[2+hf]
            // positions 8+2t, 8+2t+1.
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float w[2];
#pragma unroll
              for (int u = 0; u < 2; ++u)
                w[u] = KIND == kI8 ? e[j][u] * skt[TP + pc + 8 * j + u] : e[j][u];
              const __nv_bfloat16 h0 = __float2bfloat16(w[0]), h1 = __float2bfloat16(w[1]);
              ahi[2 * j + hf] = bf16x2(__bfloat162float(h0), __bfloat162float(h1));
              alo[2 * j + hf] = bf16x2(w[0] - __bfloat162float(h0), w[1] - __bfloat162float(h1));
            }
          }
          // P.V on mma m16n8k16: k = the warp's 16 positions.
          const unsigned char* vt = kt + HD * (int)sizeof(CT);
#pragma unroll
          for (int np = 0; np < HD / 16; ++np) {
            unsigned bv[4];  // b0, b1 of column tiles 2np and 2np+1
            if constexpr (KIND == kFp) {
              ldmatrix_x4_trans(bv, vt + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::kKvStride +
                                        (16 * np + (lane >> 4) * 8) * 2);
            } else {
              const int8_t* v0 = reinterpret_cast<const int8_t*>(vt) +
                                 (warp * 16 + 2 * t) * L::kKvStride + 16 * np + g;
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int8_t* vv = v0 + (q >> 1) * 8 + (q & 1) * 8 * L::kKvStride;
                bv[q] = bf16x2(static_cast<float>(vv[0]), static_cast<float>(vv[L::kKvStride]));
              }
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              mma_bf16(accw[2 * np + u], ahi, bv[2 * u], bv[2 * u + 1]);
              mma_bf16(accw[2 * np + u], alo, bv[2 * u], bv[2 * u + 1]);
            }
          }
          continue;
        }

        // ---- Scores S = Q K^T * scale (* sk), [ROWS, 32], into s_s ----
        if constexpr (KIND == kS8) {
          // Warp w: positions 8w..8w+7; m16n8k32 over HD in 32-byte steps.
          int si[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j) si[m][j] = 0;
          const unsigned char* kr = kt + (warp * 8 + g) * L::kKvStride;
#pragma unroll
          for (int ks = 0; ks < HD / 32; ++ks) {
            const int bfr[2] = {*reinterpret_cast<const int*>(kr + 32 * ks + 4 * t),
                                *reinterpret_cast<const int*>(kr + 32 * ks + 16 + 4 * t)};
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const unsigned char* q0 = q_s + (16 * m + g) * L::kQStride + 32 * ks + 4 * t;
              const int afr[4] = {*reinterpret_cast<const int*>(q0),
                                  *reinterpret_cast<const int*>(q0 + 8 * L::kQStride),
                                  *reinterpret_cast<const int*>(q0 + 16),
                                  *reinterpret_cast<const int*>(q0 + 8 * L::kQStride + 16)};
              mma_s8(si[m], afr, bfr);
            }
          }
          const int pc = warp * 8 + 2 * t;
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int rr = 16 * m + g + 8 * hf;
              const float qsc = qsc_s[rr];
              *reinterpret_cast<float2*>(s_s + rr * L::kSStride + pc) = make_float2(
                  __fmul_rn(__fmul_rn(static_cast<float>(si[m][2 * hf]), qsc), skt[pc]),
                  __fmul_rn(__fmul_rn(static_cast<float>(si[m][2 * hf + 1]), qsc), skt[pc + 1]));
            }
        } else if constexpr (L::kMma) {
          // bf16 q: warp w computes positions 8w..8w+7 for every row tile.
          float sa[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < 4; ++j) sa[m][j] = 0.f;
#pragma unroll
          for (int kk = 0; kk < HD / 32; ++kk) {
            unsigned bfr[4];  // b0, b1 of k-steps 2kk and 2kk+1
            if constexpr (KIND == kFp) {
              ldmatrix_x4(bfr, kt + (warp * 8 + (lane & 7)) * L::kKvStride +
                                   (32 * kk + (lane >> 3) * 8) * 2);
            } else {  // int8 -> bf16, exact
              const unsigned char* kr = kt + (warp * 8 + g) * L::kKvStride + 32 * kk + 2 * t;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                bfr[j] = s8x2_to_bf16x2(*reinterpret_cast<const short*>(kr + 8 * j));
            }
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                unsigned afr[4];
                ldmatrix_x4(afr, q_s + (16 * m + (lane & 15)) * L::kQStride +
                                     (32 * kk + 16 * half + (lane >> 4) * 8) * 2);
                mma_bf16(sa[m], afr, bfr[2 * half], bfr[2 * half + 1]);
              }
          }
          const int pc = warp * 8 + 2 * t;
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int rr = 16 * m + g + 8 * hf;
              float2 v = make_float2(sa[m][2 * hf] * a.scale, sa[m][2 * hf + 1] * a.scale);
              if constexpr (KIND == kI8) {
                v.x *= skt[pc];
                v.y *= skt[pc + 1];
              }
              *reinterpret_cast<float2*>(s_s + rr * L::kSStride + pc) = v;
            }
        } else {
          // fp32 q: lane = position, warp w rows w, w+4, ...; fp32 FMAs.
          float sf[RPW];
#pragma unroll
          for (int k = 0; k < RPW; ++k) sf[k] = 0.f;
          const CT* kr = reinterpret_cast<const CT*>(kt + lane * L::kKvStride);
#pragma unroll 2
          for (int d0 = 0; d0 < HD; d0 += 8) {
            float k8[8];
            load8(kr + d0, k8);
#pragma unroll
            for (int k = 0; k < RPW; ++k) {
              const float* qr = reinterpret_cast<const float*>(q_s + (warp + kWarps * k) * L::kQStride) + d0;
              const float4 qa = *reinterpret_cast<const float4*>(qr);
              const float4 qb = *reinterpret_cast<const float4*>(qr + 4);
              sf[k] = fmaf(k8[0], qa.x, sf[k]);
              sf[k] = fmaf(k8[1], qa.y, sf[k]);
              sf[k] = fmaf(k8[2], qa.z, sf[k]);
              sf[k] = fmaf(k8[3], qa.w, sf[k]);
              sf[k] = fmaf(k8[4], qb.x, sf[k]);
              sf[k] = fmaf(k8[5], qb.y, sf[k]);
              sf[k] = fmaf(k8[6], qb.z, sf[k]);
              sf[k] = fmaf(k8[7], qb.w, sf[k]);
            }
          }
#pragma unroll
          for (int k = 0; k < RPW; ++k) {
            float v = sf[k] * a.scale;
            if constexpr (KIND == kI8) v *= skt[lane];
            s_s[(warp + kWarps * k) * L::kSStride + lane] = v;
          }
        }
        __syncthreads();

        // ---- Online softmax: warp w owns rows w + 4k, lane = position ----
        const int p = t0 + lane;
#pragma unroll
        for (int k = 0; k < RPW; ++k) {
          const int rr = warp + kWarps * k;
          if (rr >= nr) {  // padding rows of the last row tile: zero weights
            if constexpr (KIND == kS8) {
              reinterpret_cast<int8_t*>(p_s)[rr * L::kPStride + lane] = 0;
              if (lane == 0) f_s[rr] = 0.f;
            } else if constexpr (L::kMma) {
              __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(p_s);
              ph[rr * L::kPStride + lane] = __float2bfloat16(0.f);
              ph[(ROWS + rr) * L::kPStride + lane] = __float2bfloat16(0.f);
            } else {
              s_s[rr * L::kSStride + lane] = 0.f;
            }
            if (lane == 0) alpha_s[rr] = 1.f;
            continue;
          }
          const bool ok = p < p_end && p <= lim_r[k];
          const float sc = ok ? s_s[rr * L::kSStride + lane] : -CUDART_INF_F;
          const float m_old = m_r[k];
          float alpha;
          if constexpr (KIND == kS8) {
            // The tile's weights quantized from its own scores (the plain
            // version's rounding): e = exp(s - tmax), pq = e * sv,
            // p8 = round(pq / ps), ps = max(max pq, 1e-30) / 127.
            const float tmax = warp_max(sc);
            const float m_new = fmaxf(m_old, tmax);
            const float e = ok ? expf(sc - tmax) : 0.f;
            const float pq = __fmul_rn(e, skt[kTile + lane]);
            const float ps = fmaxf(warp_max(pq), 1e-30f) * kInv127;
            const int p8 = __float2int_rn(pq / ps);
            alpha = m_old == -CUDART_INF_F ? 0.f : expf(m_old - m_new);
            const float cf = tmax == -CUDART_INF_F ? 0.f : expf(tmax - m_new);
            l_r[k] = l_r[k] * alpha + cf * warp_sum(e);
            m_r[k] = m_new;
            reinterpret_cast<int8_t*>(p_s)[rr * L::kPStride + lane] = static_cast<int8_t>(p8);
            if (lane == 0) f_s[rr] = cf * ps;
          } else {
            const float m_new = fmaxf(m_old, warp_max(sc));
            const float pr = ok ? expf(sc - m_new) : 0.f;
            alpha = m_old == -CUDART_INF_F ? 0.f : expf(m_old - m_new);
            l_r[k] = l_r[k] * alpha + warp_sum(pr);
            m_r[k] = m_new;
            const float w = KIND == kI8 ? pr * skt[kTile + lane] : pr;  // the P.V weight
            if constexpr (L::kMma) {
              // P as hi + lo, two bf16 parts: p - hi is exact in fp32.
              __nv_bfloat16* ph = reinterpret_cast<__nv_bfloat16*>(p_s);
              const __nv_bfloat16 hi = __float2bfloat16(w);
              ph[rr * L::kPStride + lane] = hi;
              ph[(ROWS + rr) * L::kPStride + lane] = __float2bfloat16(w - __bfloat162float(hi));
            } else {
              s_s[rr * L::kSStride + lane] = w;
            }
          }
          if (lane == 0) alpha_s[rr] = alpha;
        }
        __syncthreads();

        // ---- acc = acc * alpha + P V ----
        if constexpr (L::kMma) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float a0 = alpha_s[16 * m + g], a1 = alpha_s[16 * m + g + 8];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              float* ac = acc + (m * NT + n) * 4;
              ac[0] *= a0;
              ac[1] *= a0;
              ac[2] *= a1;
              ac[3] *= a1;
            }
          }
          const unsigned char* vt = kt + HD * (int)sizeof(CT);  // V half of each row
          if constexpr (KIND == kS8) {
            // One m16n8k32 step covers the whole 32-position tile.
            int bfr[NT][2];
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const unsigned char* vc = vt + col0 + 8 * n + g;
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const unsigned char* v0 = vc + (16 * hf + 4 * t) * L::kKvStride;
                bfr[n][hf] = static_cast<int>(v0[0] | (v0[L::kKvStride] << 8) |
                                              (v0[2 * L::kKvStride] << 16) |
                                              (static_cast<unsigned>(v0[3 * L::kKvStride]) << 24));
              }
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const unsigned char* p0 = p_s + (16 * m + g) * L::kPStride + 4 * t;
              const int afr[4] = {*reinterpret_cast<const int*>(p0),
                                  *reinterpret_cast<const int*>(p0 + 8 * L::kPStride),
                                  *reinterpret_cast<const int*>(p0 + 16),
                                  *reinterpret_cast<const int*>(p0 + 8 * L::kPStride + 16)};
              const float f0 = f_s[16 * m + g], f1 = f_s[16 * m + g + 8];
#pragma unroll
              for (int n = 0; n < NT; ++n) {
                int ti[4] = {0, 0, 0, 0};
                mma_s8(ti, afr, bfr[n]);
                float* ac = acc + (m * NT + n) * 4;
                ac[0] = fmaf(static_cast<float>(ti[0]), f0, ac[0]);
                ac[1] = fmaf(static_cast<float>(ti[1]), f0, ac[1]);
                ac[2] = fmaf(static_cast<float>(ti[2]), f1, ac[2]);
                ac[3] = fmaf(static_cast<float>(ti[3]), f1, ac[3]);
              }
            }
          } else {
            const __nv_bfloat16* ph = reinterpret_cast<const __nv_bfloat16*>(p_s);
#pragma unroll
            for (int ks = 0; ks < kTile / 16; ++ks) {
              unsigned bfr[NT][2];
              if constexpr (KIND == kFp) {
#pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                  unsigned r4[4];
                  ldmatrix_x4_trans(r4, vt + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * L::kKvStride +
                                            (col0 + 16 * np + (lane >> 4) * 8) * 2);
                  bfr[2 * np][0] = r4[0];
                  bfr[2 * np][1] = r4[1];
                  bfr[2 * np + 1][0] = r4[2];
                  bfr[2 * np + 1][1] = r4[3];
                }
              } else {  // int8 V -> bf16 pairs (exact)
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                  const int8_t* v0 = reinterpret_cast<const int8_t*>(vt) +
                                     (16 * ks + 2 * t) * L::kKvStride + col0 + 8 * n + g;
#pragma unroll
                  for (int hf = 0; hf < 2; ++hf) {
                    const int8_t* vv = v0 + 8 * hf * L::kKvStride;
                    bfr[n][hf] = bf16x2(static_cast<float>(vv[0]), static_cast<float>(vv[L::kKvStride]));
                  }
                }
              }
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                unsigned ahi[4], alo[4];
                const int prow = 16 * m + (lane & 15), pcol = 16 * ks + (lane >> 4) * 8;
                ldmatrix_x4(ahi, ph + prow * L::kPStride + pcol);
                ldmatrix_x4(alo, ph + (ROWS + prow) * L::kPStride + pcol);
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                  float* ap = acc + (m * NT + n) * 4;
                  float ac[4] = {ap[0], ap[1], ap[2], ap[3]};
                  mma_bf16(ac, ahi, bfr[n][0], bfr[n][1]);
                  mma_bf16(ac, alo, bfr[n][0], bfr[n][1]);
#pragma unroll
                  for (int j = 0; j < 4; ++j) ap[j] = ac[j];
                }
              }
            }
          }
        } else if constexpr (kThreads % HD == 0) {  // one column a thread
          constexpr int RS = kThreads / HD;
          const int cc = tid % HD;
          const CT* vcol = reinterpret_cast<const CT*>(kt) + HD + cc;
#pragma unroll
          for (int k = 0; k < NACC; ++k) acc[k] *= alpha_s[tid / HD + RS * k];
#pragma unroll 4
          for (int j = 0; j < kTile; ++j) {
            const float v = static_cast<float>(vcol[j * (L::kKvStride / (int)sizeof(CT))]);
#pragma unroll
            for (int k = 0; k < NACC; ++k)
              acc[k] = fmaf(s_s[(tid / HD + RS * k) * L::kSStride + j], v, acc[k]);
          }
        } else {  // HD 192: each pair its own column
          const CT* vrow = reinterpret_cast<const CT*>(kt) + HD;
#pragma unroll
          for (int k = 0; k < NACC; ++k) acc[k] *= alpha_s[(tid + kThreads * k) / HD];
#pragma unroll 2
          for (int j = 0; j < kTile; ++j) {
#pragma unroll
            for (int k = 0; k < NACC; ++k) {
              const int e = tid + kThreads * k;
              const float v = static_cast<float>(vrow[j * (L::kKvStride / (int)sizeof(CT)) + e % HD]);
              acc[k] = fmaf(s_s[(e / HD) * L::kSStride + j], v, acc[k]);
            }
          }
        }
      }
      cp_async_wait<0>();

      if constexpr (kWS) {
        if constexpr (STAGE == kStageLoads) {  // the folded bits reach the output
          accw[0][0] = static_cast<float>(chk >> 8);
          mw[0] = mw[1] = 0.f;
          lw[0] = lw[1] = 1.f;
        }
        // The four warps' states (each over its own positions) merge in warp
        // order into the block's partial for the pass's rows.
        __syncthreads();  // every warp is done with the ring
        float* wst = reinterpret_cast<float*>(kv_s);        // [warp][16][HD] acc
        float* wml = wst + kWarps * 16 * HD;                 // [warp][16][2] m, l
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wst[(warp * 16 + g + 8 * (j >> 1)) * HD + 8 * n + 2 * t + (j & 1)] = accw[n][j];
        if (t == 0)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            wml[(warp * 16 + g + 8 * hf) * 2] = mw[hf];
            wml[(warp * 16 + g + 8 * hf) * 2 + 1] = lw[hf];
          }
        __syncthreads();
        for (int e = tid; e < nr * HD; e += kThreads) {
          const int rr = e / HD, cc = e % HD;
          float mx = -CUDART_INF_F;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wml[(w * 16 + rr) * 2]);
          float Lb = 0.f, Ab = 0.f;
          if (mx != -CUDART_INF_F)
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
              const float mwv = wml[(w * 16 + rr) * 2];
              const float f = mwv == -CUDART_INF_F ? 0.f : expf(mwv - mx);
              Lb = fmaf(wml[(w * 16 + rr) * 2 + 1], f, Lb);
              Ab = fmaf(wst[(w * 16 + rr) * HD + cc], f, Ab);
            }
          const int r = r0 + rr;
          if (n_live <= 1) {
            const int i = r / G, gg = r % G;
            if (cc < hd)
              og[(((size_t)b * a.Q + i) * a.Hq + h * G + gg) * hd + cc] =
                  from_float<T>(Lb > 0.f ? Ab / Lb : 0.f);
          } else {
            ws_acc[((size_t)c * R + r) * HD + cc] = Ab;
            if (cc == 0) ws_ml[(size_t)c * R + r] = make_float2(mx, Lb);
          }
        }
        __syncthreads();  // the next pass reuses the ring
        continue;
      }

      if constexpr (STAGE == kStageLoads) {  // the folded bits reach the output
        acc[0] = static_cast<float>(chk >> 8);
#pragma unroll
        for (int k = 0; k < RPW; ++k) {
          m_r[k] = 0.f;
          l_r[k] = 1.f;
        }
      }
      // The pass's row states, then its partial (or, with one live chunk, the output).
#pragma unroll
      for (int k = 0; k < RPW; ++k)
        if (lane == 0) {
          m_s[warp + kWarps * k] = m_r[k];
          l_s[warp + kWarps * k] = l_r[k];
        }
      __syncthreads();
      auto put = [&](int rr, int cc, float v) {
        if (rr >= nr) return;
        const int r = r0 + rr;
        if (n_live <= 1) {
          const int i = r / G, gg = r % G;
          const float l = l_s[rr];
          if (cc < hd)
            og[(((size_t)b * a.Q + i) * a.Hq + h * G + gg) * hd + cc] = from_float<T>(l > 0.f ? v / l : 0.f);
        } else {
          ws_acc[((size_t)c * R + r) * HD + cc] = v;
        }
      };
      if constexpr (L::kMma) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              put(16 * m + g + 8 * (j >> 1), col0 + 8 * n + 2 * t + (j & 1), acc[(m * NT + n) * 4 + j]);
      } else if constexpr (kThreads % HD == 0) {
        constexpr int RS = kThreads / HD;
#pragma unroll
        for (int k = 0; k < NACC; ++k) put(tid / HD + RS * k, tid % HD, acc[k]);
      } else {
#pragma unroll
        for (int k = 0; k < NACC; ++k) put((tid + kThreads * k) / HD, (tid + kThreads * k) % HD, acc[k]);
      }
      if (n_live > 1)
        for (int rr = tid; rr < nr; rr += kThreads)
          ws_ml[(size_t)c * R + r0 + rr] = make_float2(m_s[rr], l_s[rr]);
      __syncthreads();  // the next pass reuses the row buffers
    }
  }
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
  // Rows in groups of kMergeRows; the ring's shared memory is free now and
  // holds the weights and the running sums.
  // Per row, a warp takes the chunks lane by lane: the largest m, then
  // L = sum l_c exp(m_c - m). Then, 32 chunks at a time, each chunk's
  // weight exp(m_c - m) (0 where the row attends nothing in that chunk) goes
  // to shared memory and every (row, column) sums acc_c * weight in chunk
  // order. The sums add exact zeros for the chunks a row does not reach, so
  // a row's result does not depend on how many chunks the call has.
  float* mx_s = reinterpret_cast<float*>(kv_s);
  float* L_s = mx_s + kMergeRows;
  float* f_s32 = L_s + kMergeRows;  // [kMergeRows][32]
  for (int g0 = 0; g0 < R; g0 += kMergeRows) {
    const int ng = min(kMergeRows, R - g0);
    for (int rr = warp; rr < ng; rr += kWarps) {
      const float2* ml = ws_ml + g0 + rr;
      float mx = -CUDART_INF_F;
      for (int ch = lane; ch < n_live; ch += 32) mx = fmaxf(mx, __ldcg(ml + (size_t)ch * R).x);
      mx = warp_max(mx);
      float Ls = 0.f;
      if (mx != -CUDART_INF_F)
        for (int ch = lane; ch < n_live; ch += 32) {
          const float2 v = __ldcg(ml + (size_t)ch * R);
          Ls += v.y * (v.x == -CUDART_INF_F ? 0.f : expf(v.x - mx));
        }
      Ls = warp_sum(Ls);
      if (lane == 0) {
        mx_s[rr] = mx;
        L_s[rr] = Ls;
      }
    }
    float* As = f_s32 + kMergeRows * 32;  // [kMergeRows][HD] running sums
    for (int e = tid; e < ng * HD; e += kThreads) As[e] = 0.f;
    for (int c0 = 0; c0 < n_live; c0 += 32) {
      const int nb = min(32, n_live - c0);
      __syncthreads();  // the row maxima are in; the previous weights are used
      for (int rr = warp; rr < ng; rr += kWarps) {
        float f = 0.f;
        if (lane < nb && mx_s[rr] != -CUDART_INF_F) {
          const float m = __ldcg(ws_ml + (size_t)(c0 + lane) * R + g0 + rr).x;
          f = m == -CUDART_INF_F ? 0.f : expf(m - mx_s[rr]);
        }
        f_s32[rr * 32 + lane] = f;
      }
      __syncthreads();
      for (int e = tid; e < ng * HD; e += kThreads) {
        const int rr = e / HD, cc = e % HD;
        const float* src = ws_acc + ((size_t)c0 * R + g0 + rr) * HD + cc;
        float sum = As[e];
#pragma unroll 8
        for (int j = 0; j < nb; ++j)
          sum = fmaf(__ldcg(src + (size_t)j * R * HD), f_s32[rr * 32 + j], sum);
        As[e] = sum;
      }
    }
    __syncthreads();
    for (int e = tid; e < ng * HD; e += kThreads) {
      const int rr = e / HD, cc = e % HD;
      const int r = g0 + rr, i = r / G, gg = r % G;
      const float Ls = L_s[rr];
      if (cc < hd)
        og[(((size_t)b * a.Q + i) * a.Hq + h * G + gg) * hd + cc] =
            from_float<T>(Ls > 0.f ? As[e] / Ls : 0.f);
    }
    __syncthreads();  // the next group reuses mx_s, L_s
  }
  if (tid == 0) a.counters[bh] = 0;  // ready for the stream's next call
}

template <typename T, int HD, int MT, int KIND, int STAGE, bool PAD>
cudaError_t launch_mt(const Args& a, int B, cudaStream_t st) {
  using L = Layout<T, HD, MT, KIND>;
  auto* kern = paged_split_kernel<T, HD, MT, KIND, STAGE, PAD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  const int NC = (a.M * a.bs + a.chunk - 1) / a.chunk;
  kern<<<dim3((NC + a.per_block - 1) / a.per_block, a.Hkv, B), kThreads, L::kBytes, st>>>(a);
  return cudaGetLastError();
}

// Row tiles per pass: one for the warp-split kinds (bf16 q over the fp
// cache or the "int8" mode: 16 rows a pass); otherwise by Q * G, 1 (<= 16
// rows), 2 (<= 32) or 4 (64 rows a pass), and one at widths 192 and 256 or
// for a padded hd (more passes over the chunk, whose re-reads hit L2; a
// row's arithmetic is the same in any tile count). The stage variants exist
// for the warp-split kinds, unpadded, only.
template <typename T, int HD, int KIND, int STAGE, bool PAD>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  constexpr bool kWS = Layout<T, HD, 1, KIND>::kWarpSplit;
  if constexpr (STAGE != kStageFull && (!kWS || PAD)) {
    return cudaErrorInvalidValue;
  } else if constexpr (kWS || HD > 128 || PAD) {
    return launch_mt<T, HD, 1, KIND, STAGE, PAD>(a, B, st);
  } else {
    const int R = a.Q * (a.Hq / a.Hkv);
    if (R <= 16) return launch_mt<T, HD, 1, KIND, STAGE, PAD>(a, B, st);
    if (R <= 32) return launch_mt<T, HD, 2, KIND, STAGE, PAD>(a, B, st);
    return launch_mt<T, HD, 4, KIND, STAGE, PAD>(a, B, st);
  }
}

// An instantiation by padded width: unpadded (hd = HP) or padded.
template <typename T, int HP, int KIND, int STAGE>
cudaError_t launch_width(int hd, const Args& a, int B, cudaStream_t st) {
  if (hd == HP) return launch<T, HP, KIND, STAGE, false>(a, B, st);
  if constexpr (KIND == kS8 || STAGE != kStageFull) return cudaErrorInvalidValue;
  else return launch<T, HP, KIND, STAGE, true>(a, B, st);
}

// By padded width (common.cuh::padded_head_dim). The s8 kind takes hd 64,
// 128, 192 and 256 unpadded (the JAX router's s8 kernel needs (2 hd) % 128
// == 0, and the wrappers send it nothing else); the stage variants take
// bf16 q at the widths 64 and 128.
template <typename T, int KIND, int STAGE>
cudaError_t dispatch_width(int hd, const Args& a, int B, cudaStream_t st) {
  const int hp = padded_head_dim(hd);
  if (hp == 64) return launch_width<T, 64, KIND, STAGE>(hd, a, B, st);
  if (hp == 128) return launch_width<T, 128, KIND, STAGE>(hd, a, B, st);
  if constexpr (STAGE == kStageFull) {
    if (hp == 192) return launch_width<T, 192, KIND, STAGE>(hd, a, B, st);
    if (hp == 256) return launch_width<T, 256, KIND, STAGE>(hd, a, B, st);
  }
  return cudaErrorInvalidValue;
}

template <int KIND, int STAGE>
cudaError_t dispatch(int dtype, int hd, const Args& a, int B, cudaStream_t st) {
  if constexpr (STAGE == kStageFull) {
    if (dtype == kFloat32) return dispatch_width<float, KIND, STAGE>(hd, a, B, st);
  }
  if (dtype == kBFloat16) return dispatch_width<__nv_bfloat16, KIND, STAGE>(hd, a, B, st);
  return cudaErrorInvalidValue;
}

// The entries' argument checks.
inline bool valid(int B, int Q, int Hq, int Hkv, int M, int bs, int chunk, int per_block) {
  return B > 0 && Q > 0 && Hkv > 0 && Hq % Hkv == 0 && M > 0 && bs > 0 && chunk > 0 &&
         chunk % (2 * kTile) == 0 && per_block > 0 && chunk * per_block <= kMaxChunk;
}

}  // namespace paged
}  // namespace ssd
