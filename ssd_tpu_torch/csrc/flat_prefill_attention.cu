// Ragged causal prefill of a whole mixed-length batch in one launch.
//
// Replaces the TPU kernel ssd_tpu/ops/pallas_attention.py::_flat_prefill_kernel
// (wrapper flat_prefill_attention).
//
// Contract. q [T, Hq, hd] holds the new tokens of every sequence,
// concatenated. flat_pages [P] lists, sequence after sequence, the pages each
// one attends (-1 = padding); flat context column c lives in cache slot
// flat_pages[c / bs] * bs + c % bs of the paged layer [Hkv, S, 2*hd] (K in
// lanes [0, hd), V in [hd, 2*hd)). Token t attends columns
// [row_lo[t], row_hi[t]); that interval encodes both the sequence's own run
// and causality, prefix-cached pages included. Padding tokens carry
// lo == hi and give zeros. Unlike the TPU wrapper, which first gathers the
// pages into a dense copy, this kernel resolves each column's page itself.
// Any even hd in [16, 256]: each kernel instantiates a padded width (64,
// 128, 192 or 256, common.cuh::padded_head_dim) with the lanes past hd zero
// in shared memory, and writes hd columns out.
//
// What bounds it on an H100: operations. Each K/V column is reused by all
// query rows of its sequence, so a call does 4 Hq hd sum(hi - lo) flops
// (Q.K^T and P.V) on a few MB of cache and queries: at the 8 serve prompts
// 0.034-0.056 ms at the bf16 tensor-core peak, far above the bytes' time.
// So the work has to run on the tensor cores.
//
// bf16 q (the serving dtype; flat_prefill_tc_kernel below): a block takes 64
// query rows (the G query heads of one KV head times 64 / G tokens, so each
// K/V tile serves the G heads), a warp 16 of them. The 64-column K|V tiles
// of the rows' hull stream through a three-stage cp.async ring (each slot
// row resolved through its page), with one block barrier per tile. Each
// warp computes S = Q.K^T (16 x 64) on mma.sync m16n8k16 with fp32 sums,
// keeps its rows' online softmax in registers (quad shuffles), and feeds P
// straight from the score fragments into P.V as hi = bf16(p) plus lo =
// bf16(p - hi), so p keeps ~16 bits and the result holds one bf16 rounding
// of the fp32 reference. Masks only on tiles that are not inside every row's
// interval; tiles outside a warp's rows are skipped. Tiles sit at absolute
// multiples of 64 in the flat stream, so at a block size that is a multiple
// of 64 a row's bits do not depend on the other prompts of the batch.
//
// fp32 q (the exactness checks) keeps the first design: a plain flash tile
// loop on the fp32 SIMT units, 64 rows a block, 4 x 4 register micro-tiles,
// fp32 shared memory.
//
// int8 pages (Config.kv_quant, entry ssd_flat_prefill_attention_int8): the
// layer is int8 [Hkv, S, 2*hd] with f32 scales [Hkv, 2, S]; the values are
// those of ssd_tpu/ops/attention.py::dense_pages, x_i8 * scales[h, 0|1,
// slot], which the TPU path gathers and casts to q's dtype before its
// kernel. Under bf16 q the ring carries the int8 rows and their scales:
// k_i8 -> bf16 is exact, so the mma sums are the scores q.k_i8, times
// scale * sk; the V scale folds into p before the hi/lo split (K4's "int8"
// mode). Under fp32 q each element dequantizes in fp32 as it is loaded. The
// prefill never takes the s8 arithmetic.
#include "common.cuh"

#include <type_traits>

namespace ssd {
namespace {

constexpr int kBR = 64;       // query rows per block
constexpr int kBC = 64;       // context columns per tile
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 micro-tiles

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBR * (HD + 1) + kBC * (HD + 1) + kBC * HD +
                          kBR * (kBC + 1)) +
         sizeof(int) * 2 * kBR;
}

// PAD: the instantiation for hd < HD (the lanes past hd zero); without it
// hd = HD and every offset a constant (both kernels below).
template <typename T, typename KV, int HD, bool PAD>
__global__ void __launch_bounds__(kThreads)
    flat_prefill_kernel(const T* __restrict__ q, const KV* __restrict__ kv,
                        const float* __restrict__ scales,  // int8 KV only
                        const int* __restrict__ flat_pages,
                        const int* __restrict__ row_lo,
                        const int* __restrict__ row_hi, T* __restrict__ out,
                        int T_tokens, int Hq, int Hkv, long long S, int P,
                        int bs, float scale, int hd_arg) {
  constexpr int KD = HD / 16;  // output dims per thread (HD the padded width)
  const int hd = PAD ? hd_arg : HD;
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBR][HD + 1]
  float* Ks = Qs + kBR * (HD + 1);     // [kBC][HD + 1]
  float* Vs = Ks + kBC * (HD + 1);     // [kBC][HD]
  float* Ps = Vs + kBC * HD;           // [kBR][kBC + 1]
  int* lo_s = reinterpret_cast<int*>(Ps + kBR * (kBC + 1));
  int* hi_s = lo_s + kBR;
  __shared__ int hull[2];

  const int h = blockIdx.y;
  const int G = Hq / Hkv;
  const int tokens = kBR / G;  // tokens per block
  const int t0 = blockIdx.x * tokens;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const KV* kv_h = kv + (size_t)h * S * (2 * hd);

  // The K and V tiles' lanes past hd stay zero; the tiles write lanes < hd.
  if constexpr (PAD)
    for (int e = tid; e < kBC * (HD + 1) + kBC * HD; e += kThreads) Ks[e] = 0.f;
  // Row r = (token t0 + r / G, query head h * G + r % G).
  if (tid < kBR) {
    const int t = t0 + tid / G;
    const bool valid = tid < tokens * G && t < T_tokens;
    lo_s[tid] = valid ? row_lo[t] : 0;
    hi_s[tid] = valid ? row_hi[t] : 0;
  }
  for (int e = tid; e < kBR * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int t = t0 + r / G;
    float val = 0.f;
    if (r < tokens * G && t < T_tokens && d < hd)
      val = to_float(q[((size_t)t * Hq + h * G + r % G) * hd + d]);
    Qs[r * (HD + 1) + d] = val;
  }
  __syncthreads();
  if (tid < 32) {  // interval hull of the block's non-empty rows
    int lo = INT_MAX, hi = 0;
    for (int r = tid; r < kBR; r += 32) {
      if (lo_s[r] < hi_s[r]) {
        lo = min(lo, lo_s[r]);
        hi = max(hi, hi_s[r]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (tid == 0) {
      hull[0] = lo;
      hull[1] = hi;
    }
  }
  __syncthreads();
  const int c_begin = hull[0] < hull[1] ? (hull[0] / kBC) * kBC : 0;
  const int c_end = hull[0] < hull[1] ? hull[1] : 0;
  const int n_cols = P * bs;

  int lo_r[4], hi_r[4];
  float m[4], l[4], o[4][KD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo_r[i] = lo_s[ty * 4 + i];
    hi_r[i] = hi_s[ty * 4 + i];
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < KD; ++k) o[i][k] = 0.f;
  }

  for (int c0 = c_begin; c0 < c_end; c0 += kBC) {
    // K/V tile: each column's slot row, resolved through its page; 8-element
    // loads where hd is a multiple of 8, else one element at a time.
    if (hd % 8 == 0) {
      const int chunks = 2 * hd / 8;  // 8-element chunks per slot row
      for (int e = tid; e < kBC * chunks; e += kThreads) {
        const int cc = e / chunks, d8 = (e % chunks) * 8;
        const int col = c0 + cc;
        float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (col < n_cols) {
          const int page = max(flat_pages[col / bs], 0);
          const size_t slot = (size_t)page * bs + col % bs;
          load8(kv_h + slot * (2 * hd) + d8, v8);
          if constexpr (std::is_same_v<KV, int8_t>) {
            const float sc = scales[((size_t)h * 2 + (d8 < hd ? 0 : 1)) * S + slot];
#pragma unroll
            for (int j = 0; j < 8; ++j) v8[j] *= sc;
          }
        }
        if (d8 < hd) {
#pragma unroll
          for (int j = 0; j < 8; ++j) Ks[cc * (HD + 1) + d8 + j] = v8[j];
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) Vs[cc * HD + d8 - hd + j] = v8[j];
        }
      }
    } else {
      for (int e = tid; e < kBC * 2 * hd; e += kThreads) {
        const int cc = e / (2 * hd), d = e % (2 * hd);
        const int col = c0 + cc;
        float v = 0.f;
        if (col < n_cols) {
          const int page = max(flat_pages[col / bs], 0);
          const size_t slot = (size_t)page * bs + col % bs;
          v = static_cast<float>(kv_h[slot * (2 * hd) + d]);  // fp32 or int8 pages
          if constexpr (std::is_same_v<KV, int8_t>)
            v *= scales[((size_t)h * 2 + (d < hd ? 0 : 1)) * S + slot];
        }
        if (d < hd)
          Ks[cc * (HD + 1) + d] = v;
        else
          Vs[cc * HD + d - hd] = v;
      }
    }
    __syncthreads();

    // S = Q.K^T on this thread's rows ty*4+i and columns tx+16j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // Online softmax; a row's 64 columns live in the 16 lanes sharing ty.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        ok[j] = col >= lo_r[i] && col < hi_r[i];
        s[i][j] = ok[j] ? s[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * (kBC + 1) + tx + 16 * j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = m[i] == -CUDART_INF_F ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int k = 0; k < KD; ++k) o[i][k] *= alpha;
    }
    __syncthreads();

    // O += P.V on this thread's rows and dims tx+16k.
#pragma unroll 4
    for (int c = 0; c < kBC; ++c) {
      float pv[4], vv[KD];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (kBC + 1) + c];
#pragma unroll
      for (int k = 0; k < KD; ++k) vv[k] = Vs[c * HD + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < KD; ++k) o[i][k] = fmaf(pv[i], vv[k], o[i][k]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int t = t0 + r / G;
    if (r >= tokens * G || t >= T_tokens) continue;
    T* orow = out + ((size_t)t * Hq + h * G + r % G) * hd;
#pragma unroll
    for (int k = 0; k < KD; ++k)
      if (tx + 16 * k < hd) orow[tx + 16 * k] = from_float<T>(l[i] > 0.f ? o[i][k] / l[i] : 0.f);
  }
}

template <typename T, typename KV, int HD, bool PAD>
cudaError_t launch(const void* q, const void* kv, const float* scales,
                   const int* pages, const int* lo, const int* hi, void* out,
                   int T_tokens, int Hq, int Hkv, int hd, long long S, int P, int bs,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flat_prefill_kernel<T, KV, HD, PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tokens = kBR / (Hq / Hkv);
  const dim3 grid((T_tokens + tokens - 1) / tokens, Hkv);
  flat_prefill_kernel<T, KV, HD, PAD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kv), scales, pages, lo,
      hi, static_cast<T*>(out), T_tokens, Hq, Hkv, S, P, bs, scale, hd);
  return cudaGetLastError();
}

// --- bf16 q: tensor cores over an asynchronous page ring ---

namespace tc {
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kTile = 64;           // context columns per ring stage
constexpr int kStages = 3;

template <typename KV, int HD>
struct Layout {
  static constexpr bool kI8 = std::is_same_v<KV, int8_t>;
  static constexpr int kRowBytes = 2 * HD * (int)sizeof(KV);  // one slot's K|V
  static constexpr int kKvStride = kRowBytes + 16;             // padded: no bank conflicts
  static constexpr int kStage = kTile * kKvStride;
  // The query rows go through the last ring stage before the loop uses it.
  static constexpr int kQStride = 2 * HD + 16;
  static_assert(kRows * kQStride <= kStage, "the query rows must fit one stage");
  static constexpr int kScales = kStages * kStage;  // int8: sk [kTile], sv [kTile] a stage
  static constexpr int kBytes = kScales + (kI8 ? kStages * 2 * kTile * 4 : 0);
};
}  // namespace tc

// Block b: KV head h = b % Hkv, query tile n_qtiles - 1 - b / Hkv (the last
// tiles first: within a prompt they hold the longest causal rows). Its 64
// rows are tokens t0 .. t0 + 64/G - 1 times the G heads of h; warp w owns
// rows 16w .. 16w + 15. The block walks the 64-column tiles at absolute
// multiples of 64 that meet its rows' [min lo, max hi) hull; a three-stage
// cp.async ring brings each tile's K|V slot rows (each column's page read
// from flat_pages), the first two with the query rows. Per tile one block
// barrier; then each warp, unless the tile misses all its rows:
//  S = Q.K^T on mma.sync m16n8k16 (16 rows x 64 columns, fp32 sums; int8
//  k -> bf16 is exact, the sums are the integer scores, times scale * sk);
//  the mask only where the tile is not inside every row's interval; the
//  online softmax in registers, row max and sum over each quad of lanes;
//  P.V from the score fragments, p (p * sv for int8) split into hi =
//  bf16(p) and lo = bf16(p - hi), two mmas on one fp32 accumulator.
// A tile outside a row's interval leaves its (m, l, acc) bit for bit as they
// were, so a row's result depends only on its own columns and on where the
// 64-column tiles fall in the flat stream.
template <typename KV, int HD, bool PAD>
__global__ void __launch_bounds__(tc::kThreads)
    flat_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kv,
                           const float* __restrict__ scales,  // int8 KV only
                           const int* __restrict__ flat_pages,
                           const int* __restrict__ row_lo, const int* __restrict__ row_hi,
                           __nv_bfloat16* __restrict__ out, int T_tokens, int Hq, int Hkv,
                           long long S, int P, int bs, float scale, int n_qtiles, int hd_arg) {
  const int hd = PAD ? hd_arg : HD;
  using L = tc::Layout<KV, HD>;
  constexpr int TP = tc::kTile, NS = tc::kStages;
  constexpr bool kI8 = L::kI8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  float* sc_s = reinterpret_cast<float*>(smem_tc + L::kScales);
  __shared__ int hull_s[tc::kWarps][2];

  const int h = blockIdx.x % Hkv;
  const int G = Hq / Hkv;
  const int tokens = tc::kRows / G;
  const int t0 = (n_qtiles - 1 - blockIdx.x / Hkv) * tokens;
  const int n_rows = tokens * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const KV* kv_h = kv + (size_t)h * S * (2 * hd);
  const float* sk_h = scales + (size_t)h * 2 * S;  // int8: K scales; V scales at + S
  const int n_cols = P * bs;
  const int hb = hd * (int)sizeof(KV);  // bytes of a K or V half in device memory

  // This warp's rows: lane l takes row 16 warp + (l & 15). Rows past the
  // block's tokens or past T are empty (lo = hi = 0).
  int lo_i, hi_i;
  {
    const int r = warp * 16 + (lane & 15), tok = t0 + r / G;
    const bool valid = r < n_rows && tok < T_tokens;
    lo_i = valid ? row_lo[tok] : 0;
    hi_i = valid ? row_hi[tok] : 0;
  }
  // The warp's hull (non-empty rows) and the columns inside every row's
  // interval, [in_lo, in_hi) (empty if any row is empty).
  int hull_lo = lo_i < hi_i ? lo_i : INT_MAX, hull_hi = lo_i < hi_i ? hi_i : 0;
  int in_lo = lo_i, in_hi = hi_i;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    hull_lo = min(hull_lo, __shfl_xor_sync(0xffffffffu, hull_lo, o));
    hull_hi = max(hull_hi, __shfl_xor_sync(0xffffffffu, hull_hi, o));
    in_lo = max(in_lo, __shfl_xor_sync(0xffffffffu, in_lo, o));
    in_hi = min(in_hi, __shfl_xor_sync(0xffffffffu, in_hi, o));
  }
  int lo_r[2], hi_r[2];  // rows g and g + 8
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lo_r[hf] = __shfl_sync(0xffffffffu, lo_i, g + 8 * hf);
    hi_r[hf] = __shfl_sync(0xffffffffu, hi_i, g + 8 * hf);
  }
  if (lane == 0) {
    hull_s[warp][0] = hull_lo;
    hull_s[warp][1] = hull_hi;
  }

  // The query rows, into the last ring stage (zeros for empty rows and
  // past hd).
  unsigned char* q_s = smem_tc + (NS - 1) * L::kStage;
  if constexpr (!PAD) {  // 16-byte pieces at fixed offsets
    constexpr int QP = HD * 2 / 16;  // 16-byte pieces per row
    for (int e = tid; e < tc::kRows * QP; e += tc::kThreads) {
      const int r = e / QP, piece = e % QP, tok = t0 + r / G;
      const bool live = r < n_rows && tok < T_tokens;
      const __nv_bfloat16* src =
          live ? q + ((size_t)tok * Hq + h * G + r % G) * HD + piece * 8 : q;
      cp_async16(q_s + r * L::kQStride + piece * 16, src, live);
    }
  } else {
    with_granule<2>(copy_granule(2 * hd), [&](auto gc) {
      constexpr int GR = decltype(gc)::value;
      constexpr int QP = HD * 2 / GR;  // pieces per padded row
#pragma unroll 1
      for (int e = tid; e < tc::kRows * QP; e += tc::kThreads) {
        const int r = e / QP, off = (e % QP) * GR, tok = t0 + r / G;
        const bool live = r < n_rows && tok < T_tokens && off < 2 * hd;
        const unsigned char* src =
            live ? reinterpret_cast<const unsigned char*>(q + ((size_t)tok * Hq + h * G + r % G) * hd) + off
                 : reinterpret_cast<const unsigned char*>(q);
        copy_piece<GR>(q_s + r * L::kQStride + off, src, live);
      }
    });
  }
  cp_async_commit();
  __syncthreads();  // the warps' hulls are in
  int blo = INT_MAX, bhi = 0;
#pragma unroll
  for (int w = 0; w < tc::kWarps; ++w) {
    blo = min(blo, hull_s[w][0]);
    bhi = max(bhi, hull_s[w][1]);
  }
  const int c_begin = blo < bhi ? (blo / TP) * TP : 0;
  const int nt = blo < bhi ? (bhi - c_begin + TP - 1) / TP : 0;

  // Tile loads: warp w copies slot rows 16w .. 16w + 15 of the tile, lane
  // (l & 15) resolving row 16w + (l & 15)'s slot once; pieces as wide as hd
  // allows, the pad lanes zero-filled (common.cuh).
  const int gran_kv = copy_granule(hb);
  auto load_tile = [&](int s, int c0) {
    const int col = c0 + warp * 16 + (lane & 15);
    const bool live_i = col < n_cols;
    const int slot_i = live_i ? max(flat_pages[col / bs], 0) * bs + col % bs : 0;
    unsigned char* dst = smem_tc + s * L::kStage;
    constexpr int CPR16 = L::kRowBytes / 16;  // 16-byte pieces per unpadded slot row
    if constexpr (!PAD && 32 % CPR16 == 0) {  // hd 64, 128: 16-byte pieces at fixed offsets
      constexpr int RPI = 32 / CPR16;         // rows per warp step
#pragma unroll
      for (int i = 0; i < 16 / RPI; ++i) {
        const int rr = i * RPI + lane / CPR16, piece = lane % CPR16;
        const int slot = __shfl_sync(0xffffffffu, slot_i, rr);
        const bool live = __shfl_sync(0xffffffffu, live_i ? 1 : 0, rr) != 0;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(kv_h + (size_t)slot * (2 * HD));
        cp_async16(dst + (warp * 16 + rr) * L::kKvStride + piece * 16,
                   live ? src + piece * 16 : reinterpret_cast<const unsigned char*>(kv_h), live);
      }
    } else {
      with_granule<(int)sizeof(KV)>(gran_kv, [&](auto gc) {
        constexpr int GR = decltype(gc)::value;
        constexpr int CPR = L::kRowBytes / GR;  // pieces per padded slot row (a multiple of 8)
#pragma unroll 1
        for (int i = 0; i < 16 * CPR / 32; ++i) {
          const int e = 32 * i + lane, rr = e / CPR;
          const RowPiece pc = kv_row_piece<GR, HD * (int)sizeof(KV)>(e % CPR, hb);
          const int slot = __shfl_sync(0xffffffffu, slot_i, rr);
          const bool live = __shfl_sync(0xffffffffu, live_i ? 1 : 0, rr) != 0 && pc.data;
          const unsigned char* src = reinterpret_cast<const unsigned char*>(kv_h + (size_t)slot * (2 * hd));
          copy_piece<GR>(dst + (warp * 16 + rr) * L::kKvStride + pc.dst,
                         live ? src + pc.src : reinterpret_cast<const unsigned char*>(kv_h), live);
        }
      });
    }
    if constexpr (kI8) {
      const int which = lane >> 4;  // lanes 0-15: K scales, 16-31: V scales
      cp_async4(sc_s + (s * 2 + which) * TP + warp * 16 + (lane & 15),
                live_i ? sk_h + which * S + slot_i : sk_h, live_i);
    }
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nt) load_tile(s, c_begin + s * TP);
    cp_async_commit();
  }
  cp_async_wait<NS - 1>();  // the query rows landed
  __syncthreads();
  unsigned qa[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    ldmatrix_x4(qa[ks], q_s + (warp * 16 + (lane & 15)) * L::kQStride + (16 * ks + (lane >> 4) * 8) * 2);

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile `it` landed; tile it-1 (and the query rows) are no longer read
    const int nx = it + NS - 1;
    if (nx < nt) load_tile(nx % NS, c_begin + nx * TP);
    cp_async_commit();
    const int c0 = c_begin + it * TP;
    if (c0 >= hull_hi || c0 + TP <= hull_lo) continue;  // none of this warp's rows
    const unsigned char* kt = smem_tc + (it % NS) * L::kStage;
    const float* skt = sc_s + (it % NS) * 2 * TP;  // sk [TP], then sv [TP]

    // Scores: sa[j][0..1] row g, sa[j][2..3] row g + 8, columns 8j + 2t, +1.
    float sa[TP / 8][4];
#pragma unroll
    for (int j = 0; j < TP / 8; ++j) {
#pragma unroll
      for (int u = 0; u < 4; ++u) sa[j][u] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk) {
        unsigned bfr[4];  // b0, b1 of k-steps 2kk and 2kk + 1
        if constexpr (kI8) {
          const unsigned char* kr = kt + (8 * j + g) * L::kKvStride + 32 * kk + 2 * t;
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
            bfr[qq] = s8x2_to_bf16x2(*reinterpret_cast<const short*>(kr + 8 * qq));
        } else {
          ldmatrix_x4(bfr, kt + (8 * j + (lane & 7)) * L::kKvStride + (32 * kk + (lane >> 3) * 8) * 2);
        }
        mma_bf16(sa[j], qa[2 * kk], bfr[0], bfr[1]);
        mma_bf16(sa[j], qa[2 * kk + 1], bfr[2], bfr[3]);
      }
    }

    // Online softmax; the mask only on tiles not inside every row's interval.
    const bool edge = !(c0 >= in_lo && c0 + TP <= in_hi);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < TP / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int cc = 8 * j + 2 * t + u;
          float x = sa[j][2 * hf + u] * scale;
          if constexpr (kI8) x *= skt[cc];
          if (edge && !(c0 + cc >= lo_r[hf] && c0 + cc < hi_r[hf])) x = -CUDART_INF_F;
          sa[j][2 * hf + u] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hf], mx);
      const float alpha = m_r[hf] == -CUDART_INF_F ? 0.f : expf(m_r[hf] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < TP / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float x = sa[j][2 * hf + u];
          const float p = x == -CUDART_INF_F ? 0.f : expf(x - m_new);
          sa[j][2 * hf + u] = p;
          ps += p;
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l_r[hf] = l_r[hf] * alpha + ps;
      m_r[hf] = m_new;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][2 * hf] *= alpha;
        acc[n][2 * hf + 1] *= alpha;
      }
    }

    // P.V, 16 columns a k-step: the A fragment straight from the scores
    // (a[0] row g columns 2t, 2t+1; a[1] row g + 8; a[2], a[3] the same
    // rows at columns 8 + 2t, 9 + 2t), as hi + lo bf16 parts.
    const unsigned char* vt = kt + HD * (int)sizeof(KV);
#pragma unroll
    for (int ks = 0; ks < TP / 16; ++ks) {
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float w[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            w[u] = sa[2 * ks + jj][2 * hf + u];
            if constexpr (kI8) w[u] *= skt[TP + 16 * ks + 8 * jj + 2 * t + u];
          }
          const __nv_bfloat16 h0 = __float2bfloat16(w[0]), h1 = __float2bfloat16(w[1]);
          ahi[2 * jj + hf] = bf16x2(__bfloat162float(h0), __bfloat162float(h1));
          alo[2 * jj + hf] = bf16x2(w[0] - __bfloat162float(h0), w[1] - __bfloat162float(h1));
        }
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        unsigned bv[4];  // b0, b1 of output column tiles 2np and 2np + 1
        if constexpr (kI8) {
          const int8_t* v0 = reinterpret_cast<const int8_t*>(vt) + (16 * ks + 2 * t) * L::kKvStride +
                             16 * np + g;
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const int8_t* vv = v0 + (qq >> 1) * 8 + (qq & 1) * 8 * L::kKvStride;
            bv[qq] = bf16x2(static_cast<float>(vv[0]), static_cast<float>(vv[L::kKvStride]));
          }
        } else {
          ldmatrix_x4_trans(bv, vt + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * L::kKvStride +
                                    (16 * np + (lane >> 4) * 8) * 2);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mma_bf16(acc[2 * np + u], ahi, bv[2 * u], bv[2 * u + 1]);
          mma_bf16(acc[2 * np + u], alo, bv[2 * u], bv[2 * u + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Rows g and g + 8 of the warp: acc / l in bf16 (zeros where l = 0).
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = warp * 16 + g + 8 * hf, tok = t0 + r / G;
    if (r >= n_rows || tok >= T_tokens) continue;
    __nv_bfloat16* orow = out + ((size_t)tok * Hq + h * G + r % G) * hd;
    const float l = l_r[hf];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      if (8 * n + 2 * t < hd)  // hd is even: both columns or neither
        *reinterpret_cast<unsigned*>(orow + 8 * n + 2 * t) =
            bf16x2(l > 0.f ? acc[n][2 * hf] / l : 0.f, l > 0.f ? acc[n][2 * hf + 1] / l : 0.f);
  }
}

template <typename KV, int HD, bool PAD>
cudaError_t launch_tc(const void* q, const void* kv, const float* scales, const int* pages,
                      const int* lo, const int* hi, void* out, int T_tokens, int Hq, int Hkv,
                      int hd, long long S, int P, int bs, float scale, cudaStream_t stream) {
  constexpr int smem = tc::Layout<KV, HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flat_prefill_tc_kernel<KV, HD, PAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tokens = tc::kRows / (Hq / Hkv);
  const int n_qtiles = (T_tokens + tokens - 1) / tokens;
  flat_prefill_tc_kernel<KV, HD, PAD><<<n_qtiles * Hkv, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(kv), scales, pages, lo, hi,
      static_cast<__nv_bfloat16*>(out), T_tokens, Hq, Hkv, S, P, bs, scale, n_qtiles, hd);
  return cudaGetLastError();
}

// The cache's element type is q's (fp) or int8 (KV8 = true, with scales).
template <bool KV8>
cudaError_t dispatch(int dtype, const void* q, const void* kv,
                     const float* scales, const int* pages, const int* lo,
                     const int* hi, void* out, int T, int Hq, int Hkv, int hd,
                     long long S, int P, int bs, float scale, cudaStream_t st) {
  using KVf = std::conditional_t<KV8, int8_t, float>;
  using KVb = std::conditional_t<KV8, int8_t, __nv_bfloat16>;
  auto at = [&](auto w) -> cudaError_t {  // padded width HP, unpadded (hd = HP) or padded
    constexpr int HP = decltype(w)::value;
    const bool pad = hd != HP;
    if (dtype == kFloat32 && pad)
      return launch<float, KVf, HP, true>(q, kv, scales, pages, lo, hi, out, T, Hq, Hkv, hd, S, P,
                                          bs, scale, st);
    if (dtype == kFloat32)
      return launch<float, KVf, HP, false>(q, kv, scales, pages, lo, hi, out, T, Hq, Hkv, hd, S,
                                           P, bs, scale, st);
    if (dtype == kBFloat16 && pad)
      return launch_tc<KVb, HP, true>(q, kv, scales, pages, lo, hi, out, T, Hq, Hkv, hd, S, P, bs,
                                      scale, st);
    if (dtype == kBFloat16)
      return launch_tc<KVb, HP, false>(q, kv, scales, pages, lo, hi, out, T, Hq, Hkv, hd, S, P,
                                       bs, scale, st);
    return cudaErrorInvalidValue;
  };
  switch (padded_head_dim(hd)) {
    case 64: return at(std::integral_constant<int, 64>{});
    case 128: return at(std::integral_constant<int, 128>{});
    case 192: return at(std::integral_constant<int, 192>{});
    case 256: return at(std::integral_constant<int, 256>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ssd

extern "C" int ssd_flat_prefill_attention(int dtype, const void* q,
                                          const void* kv,
                                          const int* flat_pages,
                                          const int* row_lo, const int* row_hi,
                                          void* out, int T, int Hq, int Hkv,
                                          int hd, long long S, int P, int bs,
                                          float scale, void* stream) {
  if (T == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > ssd::kBR || bs <= 0)
    return cudaErrorInvalidValue;
  return ssd::dispatch<false>(dtype, q, kv, nullptr, flat_pages, row_lo, row_hi, out, T, Hq, Hkv, hd, S, P, bs, scale,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_flat_prefill_attention_int8(int dtype, const void* q,
                                               const void* kv,
                                               const float* scales,
                                               const int* flat_pages,
                                               const int* row_lo,
                                               const int* row_hi, void* out,
                                               int T, int Hq, int Hkv, int hd,
                                               long long S, int P, int bs,
                                               float scale, void* stream) {
  if (T == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > ssd::kBR || bs <= 0)
    return cudaErrorInvalidValue;
  return ssd::dispatch<true>(dtype, q, kv, scales, flat_pages, row_lo, row_hi, out, T, Hq, Hkv, hd, S, P, bs, scale,
                             static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the bf16 kernel's instantiation for hd (for the
// smoke run's resource report); 0 for a head size it does not take.
template <int HP>
int tc_smem(int int8) {
  using namespace ssd;
  return int8 ? tc::Layout<int8_t, HP>::kBytes : tc::Layout<__nv_bfloat16, HP>::kBytes;
}

extern "C" int ssd_flat_prefill_smem_bytes(int int8, int hd) {
  switch (ssd::padded_head_dim(hd)) {
    case 64: return tc_smem<64>(int8);
    case 128: return tc_smem<128>(int8);
    case 192: return tc_smem<192>(int8);
    case 256: return tc_smem<256>(int8);
  }
  return 0;
}
