// Causal paged attention over the int8 KV cache (Config.kv_quant "int8" and
// "int8_mxu"): decode, verify, the draft chain and the async draft's glue.
// K4.
//
// Replaces the TPU kernel ssd_tpu/ops/pallas_attention.py::_paged_attn_v3_kernel_i8
// (body _paged_attn_v3_body with its scales input, both s8 modes), which the
// TPU router paged_attention_best sends every int8 decode/verify to, B = 1
// included.
//
// Contract: that of csrc/paged_attention.cu (q [B, Q, Hq, hd] at any even hd
// in [16, 256], the s8 mode at hd 64, 128, 192 or 256 only, block_tables
// [B, M] with -1 read as page 0, context_lens and qeff [B]; query i attends
// p <= ctx - qeff + i below min(ctx, M * block_size); rows that attend
// nothing give zeros; the chunk, workspace and counters) over an int8 layer
// [Hkv, S, 2*hd] (K in bytes [0, hd), V in [hd, 2*hd) of each slot row) and
// its f32 scales [Hkv, 2, S]: scales[h, 0, slot] dequantizes that slot's K
// row, scales[h, 1, slot] its V row. The kernel resolves each position's
// page and reads its two scales itself.
//
// Modes (s8).
//  s8 = 0 ("int8"): fp32 semantics, scores = (q . k_i8) * scale * sk and
//   P.V over p * sv, with the online fp32 softmax of K2.
//  s8 = 1 ("int8_mxu"), the TPU's s8 path: each query row is quantized once,
//   qs = max(max|q|, 1e-30) * (1/127), q8 = round(q / qs), and scores =
//   float(q8 . k_i8) * (qs * scale) * sk. The softmax weights are quantized
//   per row and per TILE of 32 positions [32j, 32j+32) (PAGED_S8_TILE): with
//   t the tile's largest score, e = exp(s - t), pq = e * sv,
//   ps = max(max pq, 1e-30) * (1/127) and p8 = round(pq / ps); the tile adds
//   float(p8 . v_i8) * ps * exp(t - m) to the output and sum(e) * exp(t - m)
//   to the denominator, m the running max. This is the TPU kernel's
//   quantization of p * sv per KV chunk at a tile of 32 positions instead of
//   its chunk of C * block_size. p8 depends on the tile's scores alone, so
//   the plain version (ops/attention.py) rounds the same integers. Integer
//   dots stay below 2^24 and convert to fp32 exactly; the products that feed
//   a rounding use __fmul_rn, which the compiler never fuses into an FMA.
//
// What bounds it on an H100: bytes. A position costs 2 * hd bytes of K|V and
// 8 of scales, 136 bytes per (position, KV head) at hd 64 against bf16's 256.
// The design is K2's (csrc/paged_split.cuh): the "int8" mode with bf16 q is
// K2's warp-split path on the exactly converted int8 rows (fp32 FMAs for
// fp32 q); int8_mxu runs both dots on mma.sync m16n8k32 s8 with all rows of
// the head in one pass.
//
// Stage variants of the "int8" mode (ssd_paged_attention_int8_diag), as in
// csrc/paged_attention.cu.
#include "paged_split.cuh"

// The build compiles this file twice (ops/cuda_lib.py::SPLIT_SOURCES), the
// second time with SSD_S8_PART, which holds only the int8_mxu kernels: the
// two halves of the instantiations build in parallel.
namespace ssd {
namespace paged {
cudaError_t dispatch_s8(int dtype, int hd, const Args& a, int B, cudaStream_t st);
}  // namespace paged
}  // namespace ssd

#ifdef SSD_S8_PART
cudaError_t ssd::paged::dispatch_s8(int dtype, int hd, const Args& a, int B, cudaStream_t st) {
  return dispatch<kS8, kStageFull>(dtype, hd, a, B, st);
}
#else
namespace {

ssd::paged::Args make_args(const void* q, const void* kv, const float* scales, const int* bt,
                           const int* ctx, const int* qeff, void* out, void* ws,
                           void* counters, int Q, int Hq, int Hkv, int hd, long long S, int M,
                           int bs, int chunk, int per_block, float scale) {
  return {q, kv, scales, bt, ctx, qeff, out, static_cast<float*>(ws),
          static_cast<int*>(counters), Q, Hq, Hkv, S, M, bs, chunk, per_block, scale, hd};
}

}  // namespace

extern "C" int ssd_paged_attention_int8(int dtype, int s8, const void* q, const void* kv,
                                        const float* scales, const int* block_tables,
                                        const int* context_lens, const int* qeff, void* out,
                                        void* ws, void* counters, int B, int Q, int Hq,
                                        int Hkv, int hd, long long S, int M, int bs,
                                        int chunk, int per_block, float scale,
                                        void* stream) {
  if (B == 0 || Q == 0) return cudaSuccess;
  if (!ssd::paged::valid(B, Q, Hq, Hkv, M, bs, chunk, per_block)) return cudaErrorInvalidValue;
  const auto a = make_args(q, kv, scales, block_tables, context_lens, qeff, out, ws, counters,
                           Q, Hq, Hkv, hd, S, M, bs, chunk, per_block, scale);
  const auto st = static_cast<cudaStream_t>(stream);
  using namespace ssd::paged;
  return s8 ? dispatch_s8(dtype, hd, a, B, st) : dispatch<kI8, ssd::kStageFull>(dtype, hd, a, B, st);
}

// The stage variants of the "int8" mode (bench probe). stage: 0 full,
// 1 loads, 2 math, 3 empty; stages 1-3 take bf16 q.
extern "C" int ssd_paged_attention_int8_diag(int stage, int dtype, const void* q,
                                             const void* kv, const float* scales,
                                             const int* block_tables,
                                             const int* context_lens, const int* qeff,
                                             void* out, void* ws, void* counters, int B,
                                             int Q, int Hq, int Hkv, int hd, long long S,
                                             int M, int bs, int chunk, int per_block,
                                             float scale, void* stream) {
  if (B == 0 || Q == 0) return cudaSuccess;
  if (!ssd::paged::valid(B, Q, Hq, Hkv, M, bs, chunk, per_block)) return cudaErrorInvalidValue;
  const auto a = make_args(q, kv, scales, block_tables, context_lens, qeff, out, ws, counters,
                           Q, Hq, Hkv, hd, S, M, bs, chunk, per_block, scale);
  const auto st = static_cast<cudaStream_t>(stream);
  using ssd::paged::dispatch;
  using ssd::paged::kI8;
  switch (stage) {
    case ssd::kStageFull: return dispatch<kI8, ssd::kStageFull>(dtype, hd, a, B, st);
    case ssd::kStageLoads: return dispatch<kI8, ssd::kStageLoads>(dtype, hd, a, B, st);
    case ssd::kStageMath: return dispatch<kI8, ssd::kStageMath>(dtype, hd, a, B, st);
    case ssd::kStageEmpty: return dispatch<kI8, ssd::kStageEmpty>(dtype, hd, a, B, st);
  }
  return cudaErrorInvalidValue;
}
#endif  // SSD_S8_PART
