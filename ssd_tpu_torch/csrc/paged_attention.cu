// Causal paged attention over block tables (decode, verify, any Q), over the
// bf16 or fp32 cache: K2.
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
// zeros. Any block size; hd 64 or 128.
//
// Beside them the caller passes the chunk length (a multiple of 64: the
// positions of one partial softmax state), the number of consecutive chunks
// each block takes (chunk * per_block <= 512; it changes no result), a
// workspace of
// B * Hkv * ceil(M * block_size / chunk) * Q * (Hq / Hkv) * (hd + 2) floats
// for the blocks' partial softmax states, and B * Hkv int counters that are
// zero before the call and zero again after it; neither may be shared with a
// call running on another stream.
//
// What bounds it on an H100, and the design (split-KV, a cp.async ring of
// page tiles, mma.sync with per-warp online softmax for bf16, fp32 FMAs for
// fp32, a deterministic last-block merge): csrc/paged_split.cuh.
//
// Stage variants (ssd_paged_attention_diag): the counterpart of
// bench/kernel_diag.py::_diag_kernel, which splits the TPU kernel's time into
// its stages; see paged_split.cuh. Stage 0 is the production kernel.
#include "paged_split.cuh"

namespace {

ssd::paged::Args make_args(const void* q, const void* kv, const int* bt, const int* ctx,
                           const int* qeff, void* out, void* ws, void* counters, int Q,
                           int Hq, int Hkv, long long S, int M, int bs, int chunk,
                           int per_block, float scale) {
  return {q, kv, nullptr, bt, ctx, qeff, out, static_cast<float*>(ws),
          static_cast<int*>(counters), Q, Hq, Hkv, S, M, bs, chunk, per_block, scale};
}

}  // namespace

extern "C" int ssd_paged_attention(int dtype, const void* q, const void* kv,
                                   const int* block_tables, const int* context_lens,
                                   const int* qeff, void* out, void* ws, void* counters,
                                   int B, int Q, int Hq, int Hkv, int hd, long long S, int M,
                                   int bs, int chunk, int per_block, float scale,
                                   void* stream) {
  if (B == 0 || Q == 0) return cudaSuccess;
  if (!ssd::paged::valid(B, Q, Hq, Hkv, M, bs, chunk, per_block)) return cudaErrorInvalidValue;
  const auto a = make_args(q, kv, block_tables, context_lens, qeff, out, ws, counters, Q, Hq,
                           Hkv, S, M, bs, chunk, per_block, scale);
  return ssd::paged::dispatch<ssd::paged::kFp, ssd::kStageFull>(
      dtype, hd, a, B, static_cast<cudaStream_t>(stream));
}

// The stage variants (bench probe; see paged_split.cuh). stage: 0 full,
// 1 loads, 2 math, 3 empty; stages 1-3 take bf16 q.
extern "C" int ssd_paged_attention_diag(int stage, int dtype, const void* q, const void* kv,
                                        const int* block_tables, const int* context_lens,
                                        const int* qeff, void* out, void* ws, void* counters,
                                        int B, int Q, int Hq, int Hkv, int hd, long long S,
                                        int M, int bs, int chunk, int per_block, float scale,
                                        void* stream) {
  if (B == 0 || Q == 0) return cudaSuccess;
  if (!ssd::paged::valid(B, Q, Hq, Hkv, M, bs, chunk, per_block)) return cudaErrorInvalidValue;
  const auto a = make_args(q, kv, block_tables, context_lens, qeff, out, ws, counters, Q, Hq,
                           Hkv, S, M, bs, chunk, per_block, scale);
  const auto st = static_cast<cudaStream_t>(stream);
  using ssd::paged::dispatch;
  using ssd::paged::kFp;
  switch (stage) {
    case ssd::kStageFull: return dispatch<kFp, ssd::kStageFull>(dtype, hd, a, B, st);
    case ssd::kStageLoads: return dispatch<kFp, ssd::kStageLoads>(dtype, hd, a, B, st);
    case ssd::kStageMath: return dispatch<kFp, ssd::kStageMath>(dtype, hd, a, B, st);
    case ssd::kStageEmpty: return dispatch<kFp, ssd::kStageEmpty>(dtype, hd, a, B, st);
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one instantiation of the paged kernels (kind 0
// fp, 1 int8, 2 int8_mxu; dtype 0 fp32, 1 bf16; mt row tiles), for the
// resource report of chip_smoke.py; -1 for a combination not built.
template <typename T, int HD>
int smem_of(int kind, int mt) {
  using namespace ssd::paged;
  auto pick = [&](auto k) -> int {
    constexpr int K = decltype(k)::value;
    return mt == 1 ? Layout<T, HD, 1, K>::kBytes
         : mt == 2 ? Layout<T, HD, 2, K>::kBytes
         : mt == 4 ? Layout<T, HD, 4, K>::kBytes : -1;
  };
  return kind == kFp ? pick(std::integral_constant<int, kFp>{})
       : kind == kI8 ? pick(std::integral_constant<int, kI8>{})
       : kind == kS8 ? pick(std::integral_constant<int, kS8>{}) : -1;
}

extern "C" int ssd_paged_smem_bytes(int kind, int dtype, int hd, int mt) {
  if (dtype == ssd::kFloat32 && hd == 64) return smem_of<float, 64>(kind, mt);
  if (dtype == ssd::kFloat32 && hd == 128) return smem_of<float, 128>(kind, mt);
  if (dtype == ssd::kBFloat16 && hd == 64) return smem_of<__nv_bfloat16, 64>(kind, mt);
  if (dtype == ssd::kBFloat16 && hd == 128) return smem_of<__nv_bfloat16, 128>(kind, mt);
  return -1;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
