// Tree-decode attention of the async draft (SSD) over the int8 KV cache
// (Config.kv_quant "int8" and "int8_mxu").
//
// Replaces the TPU kernel ssd_tpu/ops/pallas_attention.py::_tree_attn_v3_kernel_i8
// (body _tree_attn_v3_body with its scales input, both s8 modes), which the
// TPU router tree_attention_best sends every int8 tree step to, B = 1
// included.
//
// Contract: that of csrc/tree_attention.cu (q [B, MQ, Hq, hd], tables with
// -1 read as page 0, context_lens, fan_idx_rows [B, MQ], step s, depth K;
// with prefix = ctx - (K+1) - (s+1)*MQ, tree row r attends p below
// min(ctx, M * block_size) when p < prefix, or 0 <= p - prefix <= fan_idx[r],
// or t = p - prefix - (K+1) has 0 <= t < (s+1)*MQ and t % MQ == r; rows that
// attend nothing, ghost rows with a negative prefix included, give zeros)
// over an int8 layer [Hkv, S, 2*hd] and its f32 scales [Hkv, 2, S]
// (scales[h, 0|1, slot] dequantize the slot's K|V row), whose pages and
// scales the kernel resolves itself.
//
// Modes (template S8), as in csrc/paged_attention_int8.cu:
//  S8 = false ("int8"): scores = (q . k_i8) * scale * sk, P.V over p * sv,
//   online fp32 softmax.
//  S8 = true ("int8_mxu"): q8 = round(q / qs) per query row, qs =
//   max(max|q|, 1e-30) * (1/127); scores = float(q8 . k_i8) * (qs * scale)
//   * sk; the softmax weights quantize per row and per TILE of 64 positions
//   [64j, 64j+64) (one K/V tile): with t the tile's largest score, e =
//   exp(s - t), pq = e * sv, ps = max(max pq, 1e-30) * (1/127), p8 =
//   round(pq / ps); the tile adds float(p8 . v_i8) * ps * exp(t - m) to the
//   output and sum(e) * exp(t - m) to the denominator. The plain version
//   (ops/attention.py, tile TREE_S8_TILE) rounds the same integers. Both
//   dots are __dp4a over int8 tiles in shared memory (V transposed so that
//   four positions of one dim share a word); their sums stay below 2^24.
//
// What bounds it on an H100: bytes (a K/V byte serves at most MQ * G rows,
// 40 at K=4, fan-out 2, G=4). The design is K3's: one block per (sequence,
// KV head) holds up to 64 rows (tree row r, query head g as row r*G + g; more
// rows take more blocks along z), walks 64-position K/V tiles, and computes
// both products in 4 x 4 register micro-tiles per thread from shared memory:
// fp32 tiles of the dequantized-free int8 values for S8 = false, int8 tiles
// and int32 sums for S8 = true. No split over the context and no tensor
// cores yet.
#include "common.cuh"

namespace ssd {
namespace {

constexpr int kBR = 64;       // query rows per block
constexpr int kBC = 64;       // context positions per tile
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 micro-tiles

// Shared memory. S8 = false: Qs [kBR][HD+1], Ks [kBC][HD+1], Vs [kBC][HD],
// Ps [kBR][kBC+1] (f32). S8 = true, in 32-bit words of four int8: Q8
// [kBR][HD/4+1], K8 [kBC][HD/4+1], Vt8 [HD][kBC/4+1] (V transposed),
// P8 [kBR][kBC/4+1], and qsc [kBR] (f32, qs * scale). Both: sk, sv [kBC]
// (f32) and the rows' tree row and glue depth [kBR] (int).
template <int HD, bool S8>
constexpr size_t smem_bytes() {
  const size_t tail = sizeof(float) * 2 * kBC + sizeof(int) * 2 * kBR;
  if constexpr (S8)
    return sizeof(int) * (kBR * (HD / 4 + 1) + kBC * (HD / 4 + 1) +
                          HD * (kBC / 4 + 1) + kBR * (kBC / 4 + 1)) +
           sizeof(float) * kBR + tail;
  else
    return sizeof(float) * (kBR * (HD + 1) + kBC * (HD + 1) + kBC * HD +
                            kBR * (kBC + 1)) +
           tail;
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

template <typename T, int HD, bool S8>
__global__ void __launch_bounds__(kThreads)
    tree_attention_int8_kernel(const T* __restrict__ q,
                               const int8_t* __restrict__ kv,
                               const float* __restrict__ scales,
                               const int* __restrict__ block_tables,
                               const int* __restrict__ context_lens,
                               const int* __restrict__ fan_idx_rows,
                               T* __restrict__ out, int MQ, int Hq, int Hkv,
                               long long S, int M, int bs, int step, int K,
                               float scale) {
  constexpr int KD = HD / 16;      // output dims per thread
  constexpr int QW = HD / 4 + 1;   // words per Q8 / K8 row
  constexpr int PW = kBC / 4 + 1;  // words per P8 / Vt8 row
  extern __shared__ float smem[];
  // f32 layout (S8 = false)
  float* Qs = smem;
  float* Ks = Qs + kBR * (HD + 1);
  float* Vs = Ks + kBC * (HD + 1);
  float* Ps = Vs + kBC * HD;
  // int8 layout (S8 = true), over the same buffer
  int* Q8 = reinterpret_cast<int*>(smem);
  int* K8 = Q8 + kBR * QW;
  int* Vt8 = K8 + kBC * QW;
  int* P8 = Vt8 + HD * PW;
  float* qsc_s = reinterpret_cast<float*>(P8 + kBR * PW);
  float* tail = S8 ? qsc_s + kBR : Ps + kBR * (kBC + 1);
  float* sk_s = tail;
  float* sv_s = sk_s + kBC;
  int* row_s = reinterpret_cast<int*>(sv_s + kBC);  // tree row, -1 = none
  int* fan_s = row_s + kBR;                         // its glue depth

  const int h = blockIdx.x, b = blockIdx.y, r0 = blockIdx.z * kBR;
  const int G = Hq / Hkv, R = MQ * G;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int ctx = context_lens[b];
  const int n_pos = max(0, min(ctx, M * bs));
  const int prefix = ctx - (K + 1) - (step + 1) * MQ;
  const int tree_end = (step + 1) * MQ;
  const int* table = block_tables + (size_t)b * M;
  const int8_t* kv_h = kv + (size_t)h * S * (2 * HD);
  const float* sk_h = scales + (size_t)h * 2 * S;  // K scales; V scales at + S

  if (tid < kBR) {
    const int r = r0 + tid;
    const int row = r < R ? r / G : -1;
    row_s[tid] = row;
    fan_s[tid] = row >= 0 ? fan_idx_rows[(size_t)b * MQ + row] : -1;
    if constexpr (S8) {
      // Row tid quantized: qs = max(max|q|, 1e-30) / 127, q8 = round(q / qs).
      const T* qrow = q + (((size_t)b * MQ + (r < R ? r / G : 0)) * Hq + h * G +
                           (r < R ? r % G : 0)) * HD;
      float amax = 0.f;
      if (r < R)
        for (int d = 0; d < HD; ++d) amax = fmaxf(amax, fabsf(to_float(qrow[d])));
      const float qs = fmaxf(amax, 1e-30f) * kInv127;
      for (int w = 0; w < HD / 4; ++w) {
        unsigned packed = 0;
        if (r < R) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            packed |= (static_cast<unsigned>(__float2int_rn(to_float(qrow[4 * w + j]) / qs)) & 0xffu)
                      << (8 * j);
        }
        Q8[tid * QW + w] = static_cast<int>(packed);
      }
      qsc_s[tid] = __fmul_rn(qs, scale);
    }
  }
  if constexpr (!S8) {
    for (int e = tid; e < kBR * HD; e += kThreads) {
      const int rr = e / HD, d = e % HD, r = r0 + rr;
      float val = 0.f;
      if (r < R)
        val = to_float(q[(((size_t)b * MQ + r / G) * Hq + h * G + r % G) * HD + d]);
      Qs[rr * (HD + 1) + d] = val;
    }
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
    // K/V tile and its scales, each position's slot resolved through its page.
    constexpr int kChunks = 2 * HD / 8;  // 8-byte chunks per slot row
    for (int e = tid; e < kBC * kChunks; e += kThreads) {
      const int cc = e / kChunks, d8 = (e % kChunks) * 8;
      const int p = c0 + cc;
      int2 raw = make_int2(0, 0);
      if (p < n_pos) {
        const int page = max(table[p / bs], 0);
        raw = *reinterpret_cast<const int2*>(kv_h + ((size_t)page * bs + p % bs) * (2 * HD) + d8);
      }
      if constexpr (S8) {
        if (d8 < HD) {
          K8[cc * QW + d8 / 4] = raw.x;
          K8[cc * QW + d8 / 4 + 1] = raw.y;
        } else {
          int8_t* vt = reinterpret_cast<int8_t*>(Vt8);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            vt[(d8 - HD + j) * (4 * PW) + cc] =
                static_cast<int8_t>(sbyte(j < 4 ? raw.x : raw.y, j & 3));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float x = static_cast<float>(sbyte(j < 4 ? raw.x : raw.y, j & 3));
          if (d8 < HD)
            Ks[cc * (HD + 1) + d8 + j] = x;
          else
            Vs[cc * HD + d8 - HD + j] = x;
        }
      }
    }
    if (tid < kBC) {
      const int p = c0 + tid;
      float sk = 0.f, sv = 0.f;
      if (p < n_pos) {
        const int slot = max(table[p / bs], 0) * bs + p % bs;
        sk = sk_h[slot];
        sv = sk_h[S + slot];
      }
      sk_s[tid] = sk;
      sv_s[tid] = sv;
    }
    __syncthreads();

    // S = Q.K^T on this thread's rows ty*4+i and positions tx+16j.
    float s[4][4];
    if constexpr (S8) {
      int si[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) si[i][j] = 0;
#pragma unroll 4
      for (int w = 0; w < HD / 4; ++w) {
        int a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Q8[(ty * 4 + i) * QW + w];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = K8[(tx + 16 * j) * QW + w];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) si[i][j] = __dp4a(a[i], bk[j], si[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qsc = qsc_s[ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = __fmul_rn(__fmul_rn(static_cast<float>(si[i][j]), qsc), sk_s[tx + 16 * j]);
      }
    } else {
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
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = s[i][j] * scale * sk_s[tx + 16 * j];
    }

    // Softmax over the tile; a row's 64 positions live in the 16 lanes
    // sharing ty.
    float f[4];  // S8: what the tile's integer P.V is worth, ps * exp(t - m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = c0 + tx + 16 * j;
        ok[j] = p < n_pos && row_r[i] >= 0 &&
                attends(p, row_r[i], fan_r[i], prefix, K, MQ, tree_end);
        s[i][j] = ok[j] ? s[i][j] : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m[i] == -CUDART_INF_F ? 0.f : expf(m[i] - m_new);
      float sum = 0.f;
      if constexpr (S8) {
        float pq[4], pmax = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = ok[j] ? expf(s[i][j] - mx) : 0.f;
          pq[j] = __fmul_rn(e, sv_s[tx + 16 * j]);
          pmax = fmaxf(pmax, pq[j]);
          sum += e;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
        const float ps = fmaxf(pmax, 1e-30f) * kInv127;
        int8_t* prow = reinterpret_cast<int8_t*>(P8 + (ty * 4 + i) * PW);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          prow[tx + 16 * j] = static_cast<int8_t>(__float2int_rn(pq[j] / ps));
        const float c = mx == -CUDART_INF_F ? 0.f : expf(mx - m_new);
        l[i] = l[i] * alpha + c * sum;
        f[i] = c * ps;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
          Ps[(ty * 4 + i) * (kBC + 1) + tx + 16 * j] = pj * sv_s[tx + 16 * j];
          sum += pj;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[i] = l[i] * alpha + sum;
        f[i] = 0.f;
      }
      m[i] = m_new;
#pragma unroll
      for (int k = 0; k < KD; ++k) o[i][k] *= alpha;
    }
    __syncthreads();

    // O += P.V on this thread's rows and dims tx+16k.
    if constexpr (S8) {
      int t[4][KD];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < KD; ++k) t[i][k] = 0;
#pragma unroll 4
      for (int w = 0; w < kBC / 4; ++w) {
        int a[4], bv[KD];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = P8[(ty * 4 + i) * PW + w];
#pragma unroll
        for (int k = 0; k < KD; ++k) bv[k] = Vt8[(tx + 16 * k) * PW + w];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < KD; ++k) t[i][k] = __dp4a(a[i], bv[k], t[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < KD; ++k)
          o[i][k] = fmaf(static_cast<float>(t[i][k]), f[i], o[i][k]);
    } else {
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

template <typename T, int HD, bool S8>
cudaError_t launch(const void* q, const void* kv, const float* scales,
                   const int* bt, const int* ctx, const int* fan, void* out,
                   int B, int MQ, int Hq, int Hkv, long long S, int M, int bs,
                   int step, int K, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, S8>();
  cudaError_t err = cudaFuncSetAttribute(
      tree_attention_int8_kernel<T, HD, S8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int R = MQ * (Hq / Hkv);
  const dim3 grid(Hkv, B, (R + kBR - 1) / kBR);
  tree_attention_int8_kernel<T, HD, S8><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kv), scales, bt,
      ctx, fan, static_cast<T*>(out), MQ, Hq, Hkv, S, M, bs, step, K, scale);
  return cudaGetLastError();
}

template <bool S8>
cudaError_t dispatch(int dtype, const void* q, const void* kv,
                     const float* scales, const int* bt, const int* ctx,
                     const int* fan, void* out, int B, int MQ, int Hq, int Hkv,
                     int hd, long long S, int M, int bs, int step, int K,
                     float scale, cudaStream_t st) {
  if (dtype == kFloat32 && hd == 64)
    return launch<float, 64, S8>(q, kv, scales, bt, ctx, fan, out, B, MQ, Hq, Hkv, S, M, bs, step, K, scale, st);
  if (dtype == kFloat32 && hd == 128)
    return launch<float, 128, S8>(q, kv, scales, bt, ctx, fan, out, B, MQ, Hq, Hkv, S, M, bs, step, K, scale, st);
  if (dtype == kBFloat16 && hd == 64)
    return launch<__nv_bfloat16, 64, S8>(q, kv, scales, bt, ctx, fan, out, B, MQ, Hq, Hkv, S, M, bs, step, K, scale, st);
  if (dtype == kBFloat16 && hd == 128)
    return launch<__nv_bfloat16, 128, S8>(q, kv, scales, bt, ctx, fan, out, B, MQ, Hq, Hkv, S, M, bs, step, K, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ssd

extern "C" int ssd_tree_attention_int8(int dtype, int s8, const void* q,
                                       const void* kv, const float* scales,
                                       const int* block_tables,
                                       const int* context_lens,
                                       const int* fan_idx_rows, void* out,
                                       int B, int MQ, int Hq, int Hkv, int hd,
                                       long long S, int M, int bs, int step,
                                       int K, float scale, void* stream) {
  if (B == 0 || MQ == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || M <= 0 || bs <= 0 || step < 0 || K <= step)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s8 ? ssd::dispatch<true>(dtype, q, kv, scales, block_tables, context_lens, fan_idx_rows, out, B, MQ, Hq, Hkv, hd, S, M, bs, step, K, scale, st)
            : ssd::dispatch<false>(dtype, q, kv, scales, block_tables, context_lens, fan_idx_rows, out, B, MQ, Hq, Hkv, hd, S, M, bs, step, K, scale, st);
}
