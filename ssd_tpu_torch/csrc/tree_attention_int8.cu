// Tree-decode attention of the async draft (SSD) over the int8 KV cache
// (Config.kv_quant "int8" and "int8_mxu"). K5.
//
// Replaces the TPU kernel ssd_tpu/ops/pallas_attention.py::_tree_attn_v3_kernel_i8
// (body _tree_attn_v3_body with its scales input, both s8 modes), which the
// TPU router tree_attention_best sends every int8 tree step to, B = 1
// included.
//
// Contract: that of csrc/tree_attention.cu (q [B, MQ, Hq, hd] at any even
// hd in [16, 256], the s8 mode at hd 64, 128, 192 or 256 only, tables with
// -1 read as page 0, context_lens, fan_idx_rows [B, MQ], step s, depth K;
// with prefix = ctx - (K+1) - (s+1)*MQ, tree row r attends p below
// min(ctx, M * block_size) when p < prefix, or 0 <= p - prefix <= fan_idx[r],
// or t = p - prefix - (K+1) has 0 <= t < (s+1)*MQ and t % MQ == r; rows that
// attend nothing, ghost rows with a negative prefix included, give zeros;
// the chunk, workspace and counters) over an int8 layer [Hkv, S, 2*hd] and
// its f32 scales [Hkv, 2, S] (scales[h, 0|1, slot] dequantize the slot's K|V
// row), whose pages and scales the kernel resolves itself.
//
// Modes (s8), as in csrc/paged_attention_int8.cu:
//  s8 = 0 ("int8"): scores = (q . k_i8) * scale * sk, P.V over p * sv,
//   online fp32 softmax.
//  s8 = 1 ("int8_mxu"): q8 = round(q / qs) per query row, qs =
//   max(max|q|, 1e-30) * (1/127); scores = float(q8 . k_i8) * (qs * scale)
//   * sk; the softmax weights quantize per row and per TILE of 64 positions
//   [64j, 64j+64) (TREE_S8_TILE): with t the tile's largest score, e =
//   exp(s - t), pq = e * sv, ps = max(max pq, 1e-30) * (1/127), p8 =
//   round(pq / ps); the tile adds float(p8 . v_i8) * ps * exp(t - m) to the
//   output and sum(e) * exp(t - m) to the denominator. The plain version
//   (ops/attention.py, tile TREE_S8_TILE) rounds the same integers. Both
//   dots run on mma.sync m16n8k32 s8; their int32 sums stay below 2^24 and
//   convert to fp32 exactly; the products that feed a rounding use
//   __fmul_rn, which the compiler never fuses into an FMA.
//
// What bounds it on an H100: bytes (2 * hd bytes of K|V and 8 of scales per
// position and KV head, each serving MQ * G rows). The design is K3's
// (csrc/tree_split.cuh): the "int8" mode with bf16 q converts the int8 rows
// to bf16 exactly for the m16n8k16 products (fp32 FMAs for fp32 q); int8_mxu
// runs both dots on s8 tensor cores.
#include "tree_split.cuh"

// The build compiles this file three times (ops/cuda_lib.py::SPLIT_SOURCES):
// with SSD_S8_PART it holds only the int8_mxu kernels, with SSD_BF16_PART
// only the "int8" mode's bf16 ones, and without either the rest: the three
// parts of the instantiations build in parallel.
namespace ssd {
namespace tree {
cudaError_t dispatch_s8(int dtype, int hd, const Args& a, int B, cudaStream_t st);
cudaError_t dispatch_i8_bf16(int hd, const Args& a, int B, cudaStream_t st);
}  // namespace tree
}  // namespace ssd

#if defined(SSD_S8_PART)
cudaError_t ssd::tree::dispatch_s8(int dtype, int hd, const Args& a, int B, cudaStream_t st) {
  return dispatch<kS8>(dtype, hd, a, B, st);
}
#elif defined(SSD_BF16_PART)
cudaError_t ssd::tree::dispatch_i8_bf16(int hd, const Args& a, int B, cudaStream_t st) {
  return dispatch_width<__nv_bfloat16, kI8>(hd, a, B, st);
}
#else

extern "C" int ssd_tree_attention_int8(int dtype, int s8, const void* q, const void* kv,
                                       const float* scales, const int* block_tables,
                                       const int* context_lens, const int* fan_idx_rows,
                                       void* out, void* ws, void* counters, int B, int MQ,
                                       int Hq, int Hkv, int hd, long long S, int M, int bs,
                                       int step, int K, int chunk, int per_block, float scale,
                                       void* stream) {
  if (B == 0 || MQ == 0) return cudaSuccess;
  if (!ssd::tree::valid(B, MQ, Hq, Hkv, M, bs, step, K, chunk, per_block))
    return cudaErrorInvalidValue;
  const ssd::tree::Args a{q, kv, scales, block_tables, context_lens, fan_idx_rows, out,
                          static_cast<float*>(ws), static_cast<int*>(counters), MQ, Hq, Hkv,
                          S, M, bs, step, K, chunk, per_block, scale, hd};
  const auto st = static_cast<cudaStream_t>(stream);
  using namespace ssd::tree;
  if (s8) return dispatch_s8(dtype, hd, a, B, st);
  if (dtype == ssd::kBFloat16) return dispatch_i8_bf16(hd, a, B, st);
  if (dtype == ssd::kFloat32) return dispatch_width<float, kI8>(hd, a, B, st);
  return cudaErrorInvalidValue;
}
#endif  // SSD_S8_PART, SSD_BF16_PART
