// Causal paged attention over block tables (decode, verify, any Q).
//
// Replaces the TPU kernels ssd_tpu/ops/pallas_attention.py::_paged_attn_v2_kernel
// (B = 1) and ::_paged_attn_v3_kernel (B > 1), one contract that the TPU split
// only to save grid steps; it also covers the contract of ::_paged_attn_kernel.
//
// Contract. q [B, Q, Hq, hd], KV cache layer [Hkv, S, 2*hd] with K in lanes
// [0, hd) and V in [hd, 2*hd) of each slot row, block_tables [B, M] (-1 = no
// page), context_lens [B], qeff [B]. Query i of sequence b attends positions p
// with p <= ctx_b - qeff_b + i and p < min(ctx_b, M * block_size). A -1 table
// entry reads page 0, as the gather oracle does; rows that attend nothing give
// zeros.
//
// What bounds it on an H100: bytes. At decode each KV byte is used by Q * G
// query rows (4 at Llama-3.2-1B), far below the ~295 flops per byte where
// the tensor cores would become the limit. The design reads every attended
// KV row once per pass: one thread block per (sequence, KV head) holds the
// Q * G query rows that share the head (up to 8 per pass, in shared memory),
// its 4 warps stride over 32-position tiles (one position per lane for Q.K,
// one output slice per lane for P.V), and each warp keeps an online fp32
// softmax in registers; the warps merge at the end. There is no split over
// the context and no cp.async/TMA pipelining yet: at small batch fewer blocks
// than SMs run, which is the first thing a faster version changes.
#include "common.cuh"

namespace ssd {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename T, int HD, int ROWS>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                           const int* __restrict__ block_tables,
                           const int* __restrict__ context_lens,
                           const int* __restrict__ qeff, T* __restrict__ out,
                           int Q, int Hq, int Hkv, long long S, int M, int bs,
                           float scale) {
  constexpr int DPL = HD / 32;  // output dims per lane
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = Hq / Hkv, R = Q * G;
  const int ctx = context_lens[b];
  const int kv_len = min(ctx, M * bs);
  const int first_limit = ctx - qeff[b];  // query i attends p <= first_limit + i
  const T* kv_h = kv + (size_t)h * S * (2 * HD);
  const int* table = block_tables + (size_t)b * M;

  __shared__ __align__(16) float q_s[ROWS][HD];
  __shared__ float m_s[kWarps][ROWS];
  __shared__ float l_s[kWarps][ROWS];
  __shared__ float acc_s[kWarps][ROWS][HD];

  for (int r0 = 0; r0 < R; r0 += ROWS) {
    const int nr = min(ROWS, R - r0);
    for (int e = threadIdx.x; e < ROWS * HD; e += kThreads) {
      const int rr = e / HD, d = e % HD;
      float val = 0.f;
      if (rr < nr) {
        const int r = r0 + rr, i = r / G, g = r % G;
        val = to_float(q[(((size_t)b * Q + i) * Hq + h * G + g) * HD + d]);
      }
      q_s[rr][d] = val;
    }
    __syncthreads();

    int row_limit[ROWS];  // last attended position of each row (inclusive)
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)
      row_limit[rr] = rr < nr ? first_limit + (r0 + rr) / G : -1;
    // Positions this pass reads: up to its last row's causal limit.
    const int n_pos = max(0, min(kv_len, first_limit + (r0 + nr - 1) / G + 1));

    float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      m[rr] = -CUDART_INF_F;
      l[rr] = 0.f;
#pragma unroll
      for (int k = 0; k < DPL; ++k) acc[rr][k] = 0.f;
    }

    for (int t0 = warp * 32; t0 < n_pos; t0 += kThreads) {
      const int p = t0 + lane;
      const bool live = p < n_pos;
      int slot = 0;
      if (live) {
        const int page = max(table[p / bs], 0);
        slot = page * bs + p % bs;
      }
      float s[ROWS];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) s[rr] = 0.f;
      if (live) {
        const T* krow = kv_h + (size_t)slot * (2 * HD);
#pragma unroll
        for (int d0 = 0; d0 < HD; d0 += 8) {
          float k8[8];
          load8(krow + d0, k8);
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) {
            const float4 qa = *reinterpret_cast<const float4*>(&q_s[rr][d0]);
            const float4 qb = *reinterpret_cast<const float4*>(&q_s[rr][d0 + 4]);
            s[rr] = fmaf(k8[0], qa.x, s[rr]);
            s[rr] = fmaf(k8[1], qa.y, s[rr]);
            s[rr] = fmaf(k8[2], qa.z, s[rr]);
            s[rr] = fmaf(k8[3], qa.w, s[rr]);
            s[rr] = fmaf(k8[4], qb.x, s[rr]);
            s[rr] = fmaf(k8[5], qb.y, s[rr]);
            s[rr] = fmaf(k8[6], qb.z, s[rr]);
            s[rr] = fmaf(k8[7], qb.w, s[rr]);
          }
        }
      }
      // Online softmax over this warp's 32 positions, one row at a time.
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const bool ok = live && p <= row_limit[rr];
        const float sc = ok ? s[rr] * scale : -CUDART_INF_F;
        const float m_new = fmaxf(m[rr], warp_max(sc));
        const float pr = ok ? expf(sc - m_new) : 0.f;
        const float alpha = m[rr] == -CUDART_INF_F ? 0.f : expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + warp_sum(pr);
#pragma unroll
        for (int k = 0; k < DPL; ++k) acc[rr][k] *= alpha;
        m[rr] = m_new;
        s[rr] = pr;
      }
      // P.V: lane owns dims [lane*DPL, lane*DPL + DPL). Dead lanes carry
      // p = 0 and slot 0, so the loop needs no bound.
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const int slot_j = __shfl_sync(0xffffffffu, slot, j);
        float v[DPL];
        load_n<DPL>(kv_h + (size_t)slot_j * (2 * HD) + HD + lane * DPL, v);
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const float pj = __shfl_sync(0xffffffffu, s[rr], j);
#pragma unroll
          for (int k = 0; k < DPL; ++k) acc[rr][k] = fmaf(pj, v[k], acc[rr][k]);
        }
      }
    }

    // Merge the warps' partial softmax states.
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      if (lane == 0) {
        m_s[warp][rr] = m[rr];
        l_s[warp][rr] = l[rr];
      }
#pragma unroll
      for (int k = 0; k < DPL; ++k) acc_s[warp][rr][lane * DPL + k] = acc[rr][k];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nr * HD; e += kThreads) {
      const int rr = e / HD, d = e % HD;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][rr]);
      float L = 0.f, A = 0.f;
      if (mx != -CUDART_INF_F) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float f =
              m_s[w][rr] == -CUDART_INF_F ? 0.f : expf(m_s[w][rr] - mx);
          L += l_s[w][rr] * f;
          A += acc_s[w][rr][d] * f;
        }
      }
      const int r = r0 + rr, i = r / G, g = r % G;
      out[(((size_t)b * Q + i) * Hq + h * G + g) * HD + d] =
          from_float<T>(L > 0.f ? A / L : 0.f);
    }
    __syncthreads();
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kv, const int* bt,
                   const int* ctx, const int* qeff, void* out, int B, int Q,
                   int Hq, int Hkv, long long S, int M, int bs, float scale,
                   cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  if (Q * (Hq / Hkv) <= 4) {
    paged_attention_kernel<T, HD, 4><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kv), bt, ctx, qeff,
        static_cast<T*>(out), Q, Hq, Hkv, S, M, bs, scale);
  } else {
    paged_attention_kernel<T, HD, 8><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kv), bt, ctx, qeff,
        static_cast<T*>(out), Q, Hq, Hkv, S, M, bs, scale);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace ssd

extern "C" int ssd_paged_attention(int dtype, const void* q, const void* kv,
                                   const int* block_tables,
                                   const int* context_lens, const int* qeff,
                                   void* out, int B, int Q, int Hq, int Hkv,
                                   int hd, long long S, int M, int bs,
                                   float scale, void* stream) {
  if (B == 0 || Q == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || M <= 0 || bs <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using ssd::launch;
  if (dtype == ssd::kFloat32 && hd == 64)
    return launch<float, 64>(q, kv, block_tables, context_lens, qeff, out, B, Q, Hq, Hkv, S, M, bs, scale, st);
  if (dtype == ssd::kFloat32 && hd == 128)
    return launch<float, 128>(q, kv, block_tables, context_lens, qeff, out, B, Q, Hq, Hkv, S, M, bs, scale, st);
  if (dtype == ssd::kBFloat16 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, kv, block_tables, context_lens, qeff, out, B, Q, Hq, Hkv, S, M, bs, scale, st);
  if (dtype == ssd::kBFloat16 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, kv, block_tables, context_lens, qeff, out, B, Q, Hq, Hkv, S, M, bs, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
