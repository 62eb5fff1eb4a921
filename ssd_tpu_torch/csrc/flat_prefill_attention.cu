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
//
// What bounds it on an H100: operations (each K/V column is reused by all
// query rows of its sequence). The design is a plain flash-attention tile
// loop on the fp32 SIMT units: a block takes 64 query rows (the G query heads
// of one KV head times 64 / G tokens, so the K/V tile is shared by the G
// heads), walks 64-column K/V tiles only inside the rows' [min lo, max hi)
// hull, computes S = Q.K^T and P.V from shared memory in 4 x 4 register
// micro-tiles per thread, and keeps the online softmax in fp32 registers.
// It runs on the CUDA cores at a fraction of the tensor cores' rate;
// mma.sync/wgmma tiles and a TMA pipeline are the next step.
//
// int8 pages (Config.kv_quant, entry ssd_flat_prefill_attention_int8): the
// layer is int8 [Hkv, S, 2*hd] with f32 scales [Hkv, 2, S], and each K|V
// element dequantizes as it is loaded into the tile, x_i8 * scales[h, 0|1,
// slot], in fp32: the values of ssd_tpu/ops/attention.py::dense_pages, which
// the TPU path gathers and casts to q's dtype before its kernel. The rest of
// the kernel is unchanged; prefill never takes the s8 arithmetic.
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

template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(kThreads)
    flat_prefill_kernel(const T* __restrict__ q, const KV* __restrict__ kv,
                        const float* __restrict__ scales,  // int8 KV only
                        const int* __restrict__ flat_pages,
                        const int* __restrict__ row_lo,
                        const int* __restrict__ row_hi, T* __restrict__ out,
                        int T_tokens, int Hq, int Hkv, long long S, int P,
                        int bs, float scale) {
  constexpr int KD = HD / 16;  // output dims per thread
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
  const KV* kv_h = kv + (size_t)h * S * (2 * HD);

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
    if (r < tokens * G && t < T_tokens)
      val = to_float(q[((size_t)t * Hq + h * G + r % G) * HD + d]);
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
    // K/V tile: each column's slot row, resolved through its page.
    constexpr int kChunks = 2 * HD / 8;  // 8-element chunks per slot row
    for (int e = tid; e < kBC * kChunks; e += kThreads) {
      const int cc = e / kChunks, d8 = (e % kChunks) * 8;
      const int col = c0 + cc;
      float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (col < n_cols) {
        const int page = max(flat_pages[col / bs], 0);
        const size_t slot = (size_t)page * bs + col % bs;
        load8(kv_h + slot * (2 * HD) + d8, v8);
        if constexpr (std::is_same_v<KV, int8_t>) {
          const float sc = scales[((size_t)h * 2 + (d8 < HD ? 0 : 1)) * S + slot];
#pragma unroll
          for (int j = 0; j < 8; ++j) v8[j] *= sc;
        }
      }
      if (d8 < HD) {
#pragma unroll
        for (int j = 0; j < 8; ++j) Ks[cc * (HD + 1) + d8 + j] = v8[j];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) Vs[cc * HD + d8 - HD + j] = v8[j];
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
    T* orow = out + ((size_t)t * Hq + h * G + r % G) * HD;
#pragma unroll
    for (int k = 0; k < KD; ++k)
      orow[tx + 16 * k] = from_float<T>(l[i] > 0.f ? o[i][k] / l[i] : 0.f);
  }
}

template <typename T, typename KV, int HD>
cudaError_t launch(const void* q, const void* kv, const float* scales,
                   const int* pages, const int* lo, const int* hi, void* out,
                   int T_tokens, int Hq, int Hkv, long long S, int P, int bs,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flat_prefill_kernel<T, KV, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tokens = kBR / (Hq / Hkv);
  const dim3 grid((T_tokens + tokens - 1) / tokens, Hkv);
  flat_prefill_kernel<T, KV, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kv), scales, pages, lo,
      hi, static_cast<T*>(out), T_tokens, Hq, Hkv, S, P, bs, scale);
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
  if (dtype == kFloat32 && hd == 64)
    return launch<float, KVf, 64>(q, kv, scales, pages, lo, hi, out, T, Hq, Hkv, S, P, bs, scale, st);
  if (dtype == kFloat32 && hd == 128)
    return launch<float, KVf, 128>(q, kv, scales, pages, lo, hi, out, T, Hq, Hkv, S, P, bs, scale, st);
  if (dtype == kBFloat16 && hd == 64)
    return launch<__nv_bfloat16, KVb, 64>(q, kv, scales, pages, lo, hi, out, T, Hq, Hkv, S, P, bs, scale, st);
  if (dtype == kBFloat16 && hd == 128)
    return launch<__nv_bfloat16, KVb, 128>(q, kv, scales, pages, lo, hi, out, T, Hq, Hkv, S, P, bs, scale, st);
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
