// Tree-decode attention of the async draft (SSD): the MQ fork rows of every
// sequence attend their shared prefix, their glue ancestors and their own
// column of every tree step so far. K3.
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
// Any block size and any MQ; any even hd in [16, 256].
//
// Beside them the caller passes the chunk length (a multiple of 64: the
// positions of one partial softmax state), the number of consecutive chunks
// each block takes (chunk * per_block <= 512; it changes no result), a
// workspace of
// B * Hkv * ceil(M * block_size / chunk) * MQ * (Hq / Hkv) * (HP + 2) floats,
// HP the padded width (common.cuh::padded_head_dim),
// for the blocks' partial softmax states, and B * Hkv int counters that are
// zero before the call and zero again after it; neither may be shared with a
// call running on another stream.
//
// What bounds it on an H100 (bytes), and the design (split-KV on absolute
// chunks, the chunk resident in shared memory through cp.async, every row of
// a KV head in one pass with a 16-row tile per warp, mma.sync for bf16, fp32
// FMAs for fp32, the mask only on the tail's tiles, a deterministic
// last-block merge): csrc/tree_split.cuh.
#include "tree_split.cuh"

// The build compiles this file twice (ops/cuda_lib.py::SPLIT_SOURCES), the
// second time with SSD_BF16_PART, which holds only the bf16 kernels: the
// two halves of the instantiations build in parallel.
namespace ssd {
namespace tree {
cudaError_t dispatch_fp_bf16(int hd, const Args& a, int B, cudaStream_t st);
}  // namespace tree
}  // namespace ssd

#ifdef SSD_BF16_PART
cudaError_t ssd::tree::dispatch_fp_bf16(int hd, const Args& a, int B, cudaStream_t st) {
  return dispatch_width<__nv_bfloat16, kFp>(hd, a, B, st);
}
#else

extern "C" int ssd_tree_attention(int dtype, const void* q, const void* kv,
                                  const int* block_tables, const int* context_lens,
                                  const int* fan_idx_rows, void* out, void* ws, void* counters,
                                  int B, int MQ, int Hq, int Hkv, int hd, long long S, int M,
                                  int bs, int step, int K, int chunk, int per_block,
                                  float scale, void* stream) {
  if (B == 0 || MQ == 0) return cudaSuccess;
  if (!ssd::tree::valid(B, MQ, Hq, Hkv, M, bs, step, K, chunk, per_block))
    return cudaErrorInvalidValue;
  const ssd::tree::Args a{q, kv, nullptr, block_tables, context_lens, fan_idx_rows, out,
                          static_cast<float*>(ws), static_cast<int*>(counters), MQ, Hq, Hkv,
                          S, M, bs, step, K, chunk, per_block, scale, hd};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == ssd::kBFloat16) return ssd::tree::dispatch_fp_bf16(hd, a, B, st);
  if (dtype == ssd::kFloat32) return ssd::tree::dispatch_width<float, ssd::tree::kFp>(hd, a, B, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one instantiation of the tree kernels (kind 0
// fp, 1 int8, 2 int8_mxu; dtype 0 fp32, 1 bf16) at `chunk` positions, for
// the resource report of chip_smoke.py; -1 for a combination not built.
extern "C" int ssd_tree_smem_bytes(int kind, int dtype, int hd, int chunk) {
  return ssd::tree::smem_bytes(kind, dtype, hd, chunk);
}
#endif  // SSD_BF16_PART
