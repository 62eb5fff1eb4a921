// Causal paged attention over the int8 KV cache (Config.kv_quant "int8" and
// "int8_mxu"): decode, verify, the draft chain and the async draft's glue.
//
// Replaces the TPU kernel ssd_tpu/ops/pallas_attention.py::_paged_attn_v3_kernel_i8
// (body _paged_attn_v3_body with its scales input, both s8 modes), which the
// TPU router paged_attention_best sends every int8 decode/verify to, B = 1
// included.
//
// Contract: that of csrc/paged_attention.cu (q [B, Q, Hq, hd], block_tables
// [B, M] with -1 read as page 0, context_lens and qeff [B]; query i attends
// p <= ctx - qeff + i below min(ctx, M * block_size); rows that attend
// nothing give zeros) over an int8 layer [Hkv, S, 2*hd] (K in bytes [0, hd),
// V in [hd, 2*hd) of each slot row) and its f32 scales [Hkv, 2, S]:
// scales[h, 0, slot] dequantizes that slot's K row, scales[h, 1, slot] its V
// row. The kernel resolves each position's page and reads its two scales
// itself; the TPU's gathered copy of the scales does not exist here.
//
// Modes (template S8).
//  S8 = false ("int8"): fp32 semantics, scores = (q . k_i8) * scale * sk and
//   P.V over p * sv, with the online fp32 softmax of csrc/paged_attention.cu.
//  S8 = true ("int8_mxu"), the TPU's s8 path: each query row is quantized
//   once, qs = max(max|q|, 1e-30) * (1/127), q8 = round(q / qs), and scores =
//   float(q8 . k_i8) * (qs * scale) * sk, the dot by __dp4a. The softmax
//   weights are quantized per row and per TILE of 32 positions [32j, 32j+32),
//   the tile one warp handles at a time: with t the tile's largest score,
//   e = exp(s - t), pq = e * sv, ps = max(max pq, 1e-30) * (1/127) and
//   p8 = round(pq / ps); the tile adds float(p8 . v_i8) * ps * exp(t - m) to
//   the output and sum(e) * exp(t - m) to the denominator, m the running max.
//   This is the TPU kernel's quantization of p * sv per KV chunk (its p
//   carries the same exp(-m) for every position of the chunk, which
//   round(pq / ps) does not see), at a tile of 32 positions instead of its
//   chunk of C * block_size. p8 depends on the tile's scores alone, not on
//   the running max or the order in which warps meet tiles, so the plain
//   version (ops/attention.py, tile PAGED_S8_TILE) rounds the same integers.
//   Integer dots stay below 2^24 (|q8 . k| <= 127^2 * 128, |p8 . v| <=
//   127^2 * 32) and convert to fp32 exactly. The products that feed a
//   rounding use __fmul_rn, which the compiler never fuses into an FMA.
//
// What bounds it on an H100: bytes. A position costs 2 * hd bytes of K|V and
// 8 of scales, 136 bytes per (position, KV head) at hd 64 against bf16's 256.
// The design is K2's: one block per (sequence, KV head) holds the Q * G query
// rows that share the head (up to 8 per pass), its 4 warps stride over
// 32-position tiles, one position per lane for Q.K (the lane's K row as
// 16-byte loads, its scales as one coalesced 4-byte load per lane) and one
// output slice per lane for P.V; each warp keeps an online softmax in fp32
// registers and the warps merge at the end. No split over the context and
// no tensor cores (mma.sync s8 / wgmma) yet.
//
// Stage variants of the "int8" mode (template STAGE, ssd_paged_attention_int8_diag),
// as in csrc/paged_attention.cu: kStageLoads walks the pages and loads every
// K row, V row and scale without the math (their bits XORed into eight
// independent words); kStageMath does the math on rows
// and scales that stay resident (no page loads); kStageEmpty neither. The
// production entry instantiates kStageFull only.
#include "common.cuh"

namespace ssd {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename T, int HD, int ROWS, bool S8, int STAGE = kStageFull>
__global__ void __launch_bounds__(kThreads)
    paged_attention_int8_kernel(const T* __restrict__ q,
                                const int8_t* __restrict__ kv,
                                const float* __restrict__ scales,
                                const int* __restrict__ block_tables,
                                const int* __restrict__ context_lens,
                                const int* __restrict__ qeff,
                                T* __restrict__ out, int Q, int Hq, int Hkv,
                                long long S, int M, int bs, float scale) {
  constexpr int DPL = HD / 32;  // output dims per lane
  constexpr int W = HD / 4;     // 32-bit words of one K row
  constexpr bool kLoad = STAGE == kStageFull || STAGE == kStageLoads;
  constexpr bool kMath = STAGE == kStageFull || STAGE == kStageMath;
  static_assert(STAGE == kStageFull || !S8, "stage variants are of the int8 mode");
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = Hq / Hkv, R = Q * G;
  const int ctx = context_lens[b];
  const int kv_len = min(ctx, M * bs);
  const int first_limit = ctx - qeff[b];  // query i attends p <= first_limit + i
  const int8_t* kv_h = kv + (size_t)h * S * (2 * HD);
  const float* sk_h = scales + (size_t)h * 2 * S;  // K scales; V scales at + S
  const int* table = block_tables + (size_t)b * M;

  __shared__ __align__(16) float q_s[ROWS][HD];
  __shared__ __align__(16) int q8_s[ROWS][W];  // S8: quantized rows, 4 per word
  __shared__ float qsc_s[ROWS];                // S8: qs * scale per row
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
    if constexpr (S8) {
      for (int rr = warp; rr < ROWS; rr += kWarps) {  // one warp per row
        float amax = 0.f;
        for (int d = lane; d < HD; d += 32) amax = fmaxf(amax, fabsf(q_s[rr][d]));
        const float qs = fmaxf(warp_max(amax), 1e-30f) * kInv127;
        for (int w = lane; w < W; w += 32) {
          unsigned packed = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            packed |= (static_cast<unsigned>(__float2int_rn(q_s[rr][4 * w + j] / qs)) & 0xffu)
                      << (8 * j);
          q8_s[rr][w] = static_cast<int>(packed);
        }
        if (lane == 0) qsc_s[rr] = __fmul_rn(qs, scale);
      }
      __syncthreads();
    }

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

    unsigned chk[8] = {};  // kStageLoads: the loaded values' bits, XORed
    for (int t0 = warp * 32; (kLoad || kMath) && t0 < n_pos; t0 += kThreads) {
      const int p = t0 + lane;
      const bool live = p < n_pos;
      int slot = 0;
      if (live) {
        const int page = kLoad ? max(table[p / bs], 0) : 0;
        slot = page * bs + p % bs;
      }
      // Dead lanes read slot 0 (valid memory) and are masked below.
      const float sk = kLoad ? sk_h[slot] : q_s[0][lane];
      const float sv = kLoad ? sk_h[S + slot] : q_s[1 % ROWS][lane];
      const int8_t* krow = kv_h + (size_t)slot * (2 * HD);
      float s[ROWS];
      if constexpr (S8) {
        int si[ROWS];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) si[rr] = 0;
        if (live) {
#pragma unroll
          for (int w0 = 0; w0 < W; w0 += 4) {
            const int4 k4 = *reinterpret_cast<const int4*>(krow + 4 * w0);
#pragma unroll
            for (int rr = 0; rr < ROWS; ++rr) {
              const int4 qa = *reinterpret_cast<const int4*>(&q8_s[rr][w0]);
              si[rr] = __dp4a(qa.x, k4.x, si[rr]);
              si[rr] = __dp4a(qa.y, k4.y, si[rr]);
              si[rr] = __dp4a(qa.z, k4.z, si[rr]);
              si[rr] = __dp4a(qa.w, k4.w, si[rr]);
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr)
          s[rr] = __fmul_rn(__fmul_rn(static_cast<float>(si[rr]), qsc_s[rr]), sk);
      } else {
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) s[rr] = 0.f;
        if (live) {
#pragma unroll
          for (int d0 = 0; d0 < HD; d0 += 8) {
            float k8[8];
            if constexpr (kLoad) {
              load8(krow + d0, k8);
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j) k8[j] = q_s[lane % ROWS][d0 + j];
            }
            if constexpr (!kMath) {
#pragma unroll
              for (int j = 0; j < 8; ++j) chk[j] ^= __float_as_uint(k8[j]);
              continue;
            }
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
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) s[rr] = s[rr] * scale * sk;
      }

      if constexpr (S8) {
        // Quantized softmax weights of this 32-position tile, then P.V in
        // int32: lane owns dims [lane*DPL, lane*DPL + DPL).
        int p8[ROWS];
        float f[ROWS];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const bool ok = live && p <= row_limit[rr];
          const float sc = ok ? s[rr] : -CUDART_INF_F;
          const float tmax = warp_max(sc);
          const float m_new = fmaxf(m[rr], tmax);
          const float e = ok ? expf(sc - tmax) : 0.f;
          const float pq = __fmul_rn(e, sv);
          const float ps = fmaxf(warp_max(pq), 1e-30f) * kInv127;
          p8[rr] = __float2int_rn(pq / ps);
          const float alpha = m[rr] == -CUDART_INF_F ? 0.f : expf(m[rr] - m_new);
          const float c = tmax == -CUDART_INF_F ? 0.f : expf(tmax - m_new);
          l[rr] = l[rr] * alpha + c * warp_sum(e);
#pragma unroll
          for (int k = 0; k < DPL; ++k) acc[rr][k] *= alpha;
          m[rr] = m_new;
          f[rr] = c * ps;
        }
        int t[ROWS][DPL];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
          for (int k = 0; k < DPL; ++k) t[rr][k] = 0;
#pragma unroll 4
        for (int j = 0; j < 32; ++j) {
          const int slot_j = __shfl_sync(0xffffffffu, slot, j);
          int v[DPL];
          load_i8<DPL>(kv_h + (size_t)slot_j * (2 * HD) + HD + lane * DPL, v);
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) {
            const int pj = __shfl_sync(0xffffffffu, p8[rr], j);
#pragma unroll
            for (int k = 0; k < DPL; ++k) t[rr][k] += pj * v[k];
          }
        }
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
          for (int k = 0; k < DPL; ++k)
            acc[rr][k] = fmaf(static_cast<float>(t[rr][k]), f[rr], acc[rr][k]);
      } else {
        if constexpr (!kMath) {
          chk[0] ^= __float_as_uint(sk);
          chk[1] ^= __float_as_uint(sv);
        }
        // Online softmax, one row at a time; the P.V weight is p * sv.
#pragma unroll
        for (int rr = 0; rr < ROWS && kMath; ++rr) {
          const bool ok = live && p <= row_limit[rr];
          const float sc = ok ? s[rr] : -CUDART_INF_F;
          const float m_new = fmaxf(m[rr], warp_max(sc));
          const float pr = ok ? expf(sc - m_new) : 0.f;
          const float alpha = m[rr] == -CUDART_INF_F ? 0.f : expf(m[rr] - m_new);
          l[rr] = l[rr] * alpha + warp_sum(pr);
#pragma unroll
          for (int k = 0; k < DPL; ++k) acc[rr][k] *= alpha;
          m[rr] = m_new;
          s[rr] = pr * sv;
        }
#pragma unroll 4
        for (int j = 0; j < 32; ++j) {
          const int slot_j = __shfl_sync(0xffffffffu, slot, j);
          int v[DPL];
          if constexpr (kLoad) {
            load_i8<DPL>(kv_h + (size_t)slot_j * (2 * HD) + HD + lane * DPL, v);
          } else {
#pragma unroll
            for (int k = 0; k < DPL; ++k) v[k] = static_cast<int>(q_s[j % ROWS][lane * DPL + k]);
          }
          if constexpr (!kMath) {
#pragma unroll
            for (int k = 0; k < DPL; ++k) chk[k % 8] ^= static_cast<unsigned>(v[k]);
            continue;
          }
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) {
            const float pj = __shfl_sync(0xffffffffu, s[rr], j);
#pragma unroll
            for (int k = 0; k < DPL; ++k)
              acc[rr][k] = fmaf(pj, static_cast<float>(v[k]), acc[rr][k]);
          }
        }
      }
    }

    if constexpr (STAGE == kStageLoads) {  // the folded bits reach the output
      unsigned c = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) c ^= chk[j];
      m[0] = 0.f;
      l[0] = 1.f;
      acc[0][0] = static_cast<float>(c >> 8);
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

template <typename T, int HD, bool S8, int STAGE = kStageFull>
cudaError_t launch(const void* q, const void* kv, const float* scales,
                   const int* bt, const int* ctx, const int* qeff, void* out,
                   int B, int Q, int Hq, int Hkv, long long S, int M, int bs,
                   float scale, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  const auto* kv8 = static_cast<const int8_t*>(kv);
  if (Q * (Hq / Hkv) <= 4) {
    paged_attention_int8_kernel<T, HD, 4, S8, STAGE><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), kv8, scales, bt, ctx, qeff,
        static_cast<T*>(out), Q, Hq, Hkv, S, M, bs, scale);
  } else {
    paged_attention_int8_kernel<T, HD, 8, S8, STAGE><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), kv8, scales, bt, ctx, qeff,
        static_cast<T*>(out), Q, Hq, Hkv, S, M, bs, scale);
  }
  return cudaGetLastError();
}

template <bool S8, int STAGE = kStageFull>
cudaError_t dispatch(int dtype, const void* q, const void* kv,
                     const float* scales, const int* bt, const int* ctx,
                     const int* qeff, void* out, int B, int Q, int Hq, int Hkv,
                     int hd, long long S, int M, int bs, float scale,
                     cudaStream_t st) {
  if (dtype == kFloat32 && hd == 64)
    return launch<float, 64, S8, STAGE>(q, kv, scales, bt, ctx, qeff, out, B, Q, Hq, Hkv, S, M, bs, scale, st);
  if (dtype == kFloat32 && hd == 128)
    return launch<float, 128, S8, STAGE>(q, kv, scales, bt, ctx, qeff, out, B, Q, Hq, Hkv, S, M, bs, scale, st);
  if (dtype == kBFloat16 && hd == 64)
    return launch<__nv_bfloat16, 64, S8, STAGE>(q, kv, scales, bt, ctx, qeff, out, B, Q, Hq, Hkv, S, M, bs, scale, st);
  if (dtype == kBFloat16 && hd == 128)
    return launch<__nv_bfloat16, 128, S8, STAGE>(q, kv, scales, bt, ctx, qeff, out, B, Q, Hq, Hkv, S, M, bs, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ssd

extern "C" int ssd_paged_attention_int8(int dtype, int s8, const void* q,
                                        const void* kv, const float* scales,
                                        const int* block_tables,
                                        const int* context_lens,
                                        const int* qeff, void* out, int B,
                                        int Q, int Hq, int Hkv, int hd,
                                        long long S, int M, int bs,
                                        float scale, void* stream) {
  if (B == 0 || Q == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || M <= 0 || bs <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s8 ? ssd::dispatch<true>(dtype, q, kv, scales, block_tables, context_lens, qeff, out, B, Q, Hq, Hkv, hd, S, M, bs, scale, st)
            : ssd::dispatch<false>(dtype, q, kv, scales, block_tables, context_lens, qeff, out, B, Q, Hq, Hkv, hd, S, M, bs, scale, st);
}

// The stage variants of the "int8" mode (bench probe; see the header).
// stage: 0 full, 1 loads, 2 math, 3 empty.
extern "C" int ssd_paged_attention_int8_diag(int stage, int dtype, const void* q,
                                             const void* kv, const float* scales,
                                             const int* block_tables,
                                             const int* context_lens,
                                             const int* qeff, void* out, int B,
                                             int Q, int Hq, int Hkv, int hd,
                                             long long S, int M, int bs,
                                             float scale, void* stream) {
  if (B == 0 || Q == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || M <= 0 || bs <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using ssd::dispatch;
  switch (stage) {
    case ssd::kStageFull:
      return dispatch<false, ssd::kStageFull>(dtype, q, kv, scales, block_tables, context_lens, qeff, out, B, Q, Hq, Hkv, hd, S, M, bs, scale, st);
    case ssd::kStageLoads:
      return dispatch<false, ssd::kStageLoads>(dtype, q, kv, scales, block_tables, context_lens, qeff, out, B, Q, Hq, Hkv, hd, S, M, bs, scale, st);
    case ssd::kStageMath:
      return dispatch<false, ssd::kStageMath>(dtype, q, kv, scales, block_tables, context_lens, qeff, out, B, Q, Hq, Hkv, hd, S, M, bs, scale, st);
    case ssd::kStageEmpty:
      return dispatch<false, ssd::kStageEmpty>(dtype, q, kv, scales, block_tables, context_lens, qeff, out, B, Q, Hq, Hkv, hd, S, M, bs, scale, st);
  }
  return cudaErrorInvalidValue;
}
