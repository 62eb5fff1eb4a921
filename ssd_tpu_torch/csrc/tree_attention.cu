// Tree-decode attention of the async draft (SSD): the MQ fork rows of every
// sequence attend their shared prefix, their glue ancestors and their own
// column of every tree step so far.
//
// Replaces the TPU kernels ssd_tpu/ops/pallas_attention.py::_tree_attn_kernel
// (page per grid step, the router's fallback), ::_tree_attn_v2_kernel (B = 1,
// double-buffered) and ::_tree_attn_v3_kernel (B > 1, NB sequences per grid
// step): one contract that the TPU split three ways for grid-step cost and
// VMEM budgets.
//
// Contract. q [B, MQ, Hq, hd], KV cache layer [Hkv, S, 2*hd] (K in lanes
// [0, hd), V in [hd, 2*hd)), block_tables [B, M] (-1 = no page, read as
// page 0 like the gather oracle), context_lens [B], fan_idx_rows [B, MQ], the
// tree step s and the speculation depth K. With
// prefix = ctx - (K+1) - (s+1)*MQ, tree row r attends position p when p is
// below min(ctx, M * block_size) and p < prefix, or 0 <= p - prefix <=
// fan_idx[r] (its glue ancestors), or t = p - prefix - (K+1) satisfies
// 0 <= t < (s+1)*MQ and t % MQ == r (its own column of each step). Rows that
// attend nothing (ghost rows with a negative prefix included) give zeros.
// The mask is evaluated from these integers per position; no bitmask exists.
//
// What bounds it on an H100: bytes. Every row of a sequence shares the
// prefix, so a K/V byte serves at most MQ * G query rows (40 at the serve
// shape, K=4 and fan-out 2 with G=4), far below the ~295 flops per byte
// where the tensor cores would become the limit. The design therefore reads
// each K/V tile once for all the rows that share it: one block per (sequence,
// KV head) holds up to 64 rows (tree row r, query head g as row r*G + g; a
// larger MQ*G takes more blocks along z, each rereading the prefix), walks
// 64-position K/V tiles up to min(ctx, M * block_size), resolving each
// position's page itself, computes S = Q.K^T and P.V from shared memory in
// 4 x 4 fp32 register micro-tiles per thread, and keeps the online softmax
// in fp32 registers. No split over the context and no cp.async/TMA pipeline
// yet: at B = 1 only Hkv blocks run, which is the first thing a faster
// version changes.
#include "common.cuh"

namespace ssd {
namespace {

constexpr int kBR = 64;       // query rows per block
constexpr int kBC = 64;       // context positions per tile
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 micro-tiles

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBR * (HD + 1) + kBC * (HD + 1) + kBC * HD +
                          kBR * (kBC + 1)) +
         sizeof(int) * 2 * kBR;
}

// Whether tree row `row` (glue depth `fan`) attends position p.
__device__ __forceinline__ bool attends(int p, int row, int fan, int prefix,
                                        int K, int MQ, int tree_end) {
  if (p < prefix) return true;
  const int glue = p - prefix;
  if (glue <= fan) return true;
  const int t = glue - (K + 1);
  return t >= 0 && t < tree_end && t % MQ == row;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    tree_attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ context_lens,
                          const int* __restrict__ fan_idx_rows,
                          T* __restrict__ out, int MQ, int Hq, int Hkv,
                          long long S, int M, int bs, int step, int K,
                          float scale) {
  constexpr int KD = HD / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBR][HD + 1]
  float* Ks = Qs + kBR * (HD + 1);     // [kBC][HD + 1]
  float* Vs = Ks + kBC * (HD + 1);     // [kBC][HD]
  float* Ps = Vs + kBC * HD;           // [kBR][kBC + 1]
  int* row_s = reinterpret_cast<int*>(Ps + kBR * (kBC + 1));  // tree row, -1 = none
  int* fan_s = row_s + kBR;                                   // its glue depth

  const int h = blockIdx.x, b = blockIdx.y, r0 = blockIdx.z * kBR;
  const int G = Hq / Hkv, R = MQ * G;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int ctx = context_lens[b];
  const int n_pos = max(0, min(ctx, M * bs));
  const int prefix = ctx - (K + 1) - (step + 1) * MQ;
  const int tree_end = (step + 1) * MQ;
  const int* table = block_tables + (size_t)b * M;
  const T* kv_h = kv + (size_t)h * S * (2 * HD);

  if (tid < kBR) {
    const int r = r0 + tid;
    const int row = r < R ? r / G : -1;
    row_s[tid] = row;
    fan_s[tid] = row >= 0 ? fan_idx_rows[(size_t)b * MQ + row] : -1;
  }
  for (int e = tid; e < kBR * HD; e += kThreads) {
    const int rr = e / HD, d = e % HD, r = r0 + rr;
    float val = 0.f;
    if (r < R)
      val = to_float(q[(((size_t)b * MQ + r / G) * Hq + h * G + r % G) * HD + d]);
    Qs[rr * (HD + 1) + d] = val;
  }
  __syncthreads();

  int row_r[4], fan_r[4];
  float m[4], l[4], o[4][KD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_r[i] = row_s[ty * 4 + i];
    fan_r[i] = fan_s[ty * 4 + i];
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < KD; ++k) o[i][k] = 0.f;
  }

  for (int c0 = 0; c0 < n_pos; c0 += kBC) {
    // K/V tile: each position's slot row, resolved through its page.
    constexpr int kChunks = 2 * HD / 8;  // 8-element chunks per slot row
    for (int e = tid; e < kBC * kChunks; e += kThreads) {
      const int cc = e / kChunks, d8 = (e % kChunks) * 8;
      const int p = c0 + cc;
      float v8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (p < n_pos) {
        const int page = max(table[p / bs], 0);
        load8(kv_h + ((size_t)page * bs + p % bs) * (2 * HD) + d8, v8);
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

    // S = Q.K^T on this thread's rows ty*4+i and positions tx+16j.
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

    // Online softmax; a row's 64 positions live in the 16 lanes sharing ty.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = c0 + tx + 16 * j;
        ok[j] = p < n_pos && row_r[i] >= 0 &&
                attends(p, row_r[i], fan_r[i], prefix, K, MQ, tree_end);
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
    const int r = r0 + ty * 4 + i;
    if (r >= R) continue;
    T* orow = out + (((size_t)b * MQ + r / G) * Hq + h * G + r % G) * HD;
#pragma unroll
    for (int k = 0; k < KD; ++k)
      orow[tx + 16 * k] = from_float<T>(l[i] > 0.f ? o[i][k] / l[i] : 0.f);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kv, const int* bt,
                   const int* ctx, const int* fan, void* out, int B, int MQ,
                   int Hq, int Hkv, long long S, int M, int bs, int step,
                   int K, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      tree_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int R = MQ * (Hq / Hkv);
  const dim3 grid(Hkv, B, (R + kBR - 1) / kBR);
  tree_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), bt, ctx, fan,
      static_cast<T*>(out), MQ, Hq, Hkv, S, M, bs, step, K, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ssd

extern "C" int ssd_tree_attention(int dtype, const void* q, const void* kv,
                                  const int* block_tables,
                                  const int* context_lens,
                                  const int* fan_idx_rows, void* out, int B,
                                  int MQ, int Hq, int Hkv, int hd, long long S,
                                  int M, int bs, int step, int K, float scale,
                                  void* stream) {
  if (B == 0 || MQ == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || M <= 0 || bs <= 0 || step < 0 || K <= step)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using ssd::launch;
  if (dtype == ssd::kFloat32 && hd == 64)
    return launch<float, 64>(q, kv, block_tables, context_lens, fan_idx_rows, out, B, MQ, Hq, Hkv, S, M, bs, step, K, scale, st);
  if (dtype == ssd::kFloat32 && hd == 128)
    return launch<float, 128>(q, kv, block_tables, context_lens, fan_idx_rows, out, B, MQ, Hq, Hkv, S, M, bs, step, K, scale, st);
  if (dtype == ssd::kBFloat16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, kv, block_tables, context_lens, fan_idx_rows, out, B, MQ, Hq, Hkv, S, M, bs, step, K, scale, st);
  if (dtype == ssd::kBFloat16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, kv, block_tables, context_lens, fan_idx_rows, out, B, MQ, Hq, Hkv, S, M, bs, step, K, scale, st);
  return cudaErrorInvalidValue;
}
