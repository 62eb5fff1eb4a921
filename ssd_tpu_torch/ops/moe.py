"""Sparse mixture-of-experts feed-forward (Qwen3-MoE) and its grouped GEMM.

Counterpart of ssd_tpu/models/transformer.py::_moe_mlp (HF
Qwen3MoeSparseMoeBlock semantics: fp32 softmax router, top-k, optional
renormalisation, weighted sum of the experts' SiLU MLPs). The JAX package
picks one of three dispatch shapes per dispatch size (a per-row weight gather
at decode, a ragged grouped GEMM, a dense all-expert einsum); the port has
one: the (token, expert) pairs sorted by expert through `grouped_gemm`. A
grouped GEMM reads only the experts that received rows, so at decode it
streams the selected experts' weights, which is what the TPU's gather path
was for, and at prefill it does k/E of the dense einsum's work.

`grouped_gemm` (kernel csrc/grouped_gemm.cu) replaces the megablox `gmm`
Pallas kernel that ssd_tpu's ragged path calls on the TPU
(ssd_tpu/models/transformer.py:268-273; `lax.ragged_dot`, the same function,
elsewhere). Given CPU tensors it computes the plain version; given CUDA
tensors it launches the kernel or raises, and counts the launch in
`grouped_gemm.launches`.

Nothing in moe_mlp reads a device value on the host: group sizes come from
scatter_add_ and their prefix sum stays on the device, and the sorted rows
are gathered by index arithmetic (row r of the sorted list is token
order[r] // k), so a layer launches its kernels without a sync.

Expert parallelism (parallel/mesh.py): a rank holds E/tp consecutive
experts of every stack and the whole router, so its top-k is the global
one. Its own (token, expert) pairs sort first, by expert, the others after
them; the grouped GEMMs run over the rank's groups, whose offsets end at
its pair count (rows past it are not written, and are masked), and the
rank's partial sum of each token's experts goes to the all-reduce of
models/transformer.py. JAX keeps the dense all-expert einsum under a
sharded mesh (ssd_tpu/engine/model_runner.py); the grouped form does k/E
of its work here as on one card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ssd_tpu_torch.ops import cuda_lib
from ssd_tpu_torch.ops.layers import silu_mul
from ssd_tpu_torch.ops.linear import int8_linear, int8_linear_shared
from ssd_tpu_torch.ops.spec_math import stable_topk_indices


def route(x: torch.Tensor, router: torch.Tensor, top_k: int,
          norm_topk_prob: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Router of x [T, D] over router [D, E]: softmax of x @ router in fp32,
    the top_k experts in jax.lax.top_k's order (ties to the lowest index: in
    bf16, logits over many experts tie often, and a tie at the k-th place
    changes the expert set), weights renormalised if norm_topk_prob and cast
    to x's dtype, then each token's k experts put in expert-index order.
    Returns (experts [T, k] int64, weights [T, k])."""
    probs = torch.softmax((x @ router).float(), dim=-1)
    top_i = stable_topk_indices(probs, top_k)
    top_w = probs.gather(-1, top_i)
    if norm_topk_prob:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    top_w = top_w.to(x.dtype)
    # Expert-index order, as JAX sums the experts: a different order can
    # move the sum by an ulp and flip a greedy argmax across dispatch sizes.
    top_i, order = torch.sort(top_i, dim=-1)
    return top_i, top_w.gather(-1, order)


def expert_offsets(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Row offsets [E+1] int32 of each expert's group in the expert-sorted
    list of the experts flat_e [N], computed on the device."""
    sizes = torch.zeros(num_experts, dtype=torch.int32, device=flat_e.device)
    sizes.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    return F.pad(torch.cumsum(sizes, 0, dtype=torch.int32), (1, 0))


def moe_mlp(x: torch.Tensor, lp: dict, top_k: int, norm_topk_prob: bool,
            rank: int = 0) -> torch.Tensor:
    """Sparse MoE feed-forward of x [T, D] with the layer's router [D, E] and
    expert stacks moe_gate / moe_up [E, D, Im], moe_down [E, Im, D]. The
    T*k (token, expert) pairs are stable-sorted by expert (each token's rows
    stay in expert-index order), run through three grouped GEMMs with
    silu_mul between (bf16 rounds g, u and the product, as JAX's rdot), then
    put back in token order and summed over k in expert-index order. Int8
    expert stacks ([E, out, in] with scales [E, out], utils/quant.py) take
    the W8A16 kernel over the same groups (ops/linear.py; a sorted row
    takes its expert's scales, as JAX's int8 `rdot`), float ones the
    grouped GEMM. With a rank's share of the experts (rank `rank` holding
    El = moe_gate.shape[0] of the router's E), the rank's partial sum over
    its own experts (see the module's notes)."""
    T, D = x.shape
    E, El = lp["router"].shape[1], lp["moe_gate"].shape[0]
    top_i, top_w = route(x, lp["router"], top_k, norm_topk_prob)
    flat_e = top_i.reshape(-1)                                   # [T*k]
    if El != E:
        # Local expert ids; another rank's pairs take group El, sorted last
        # and never computed.
        flat_e = flat_e - rank * El
        mine = (flat_e >= 0) & (flat_e < El)
        flat_e = torch.where(mine, flat_e, El)
    order = torch.argsort(flat_e, stable=True)
    xs = x.index_select(0, order // top_k)                       # [T*k, D]
    offsets = expert_offsets(flat_e, El + (El != E))[:El + 1]
    if "moe_gate_scale" in lp:   # int8: gate and up in one launch over the same rows
        g, u = int8_linear_shared(xs, [lp["moe_gate"], lp["moe_up"]],
                                  [lp["moe_gate_scale"], lp["moe_up_scale"]],
                                  group_offsets=offsets)
    else:
        g, u = _experts(xs, lp, "moe_gate", offsets), _experts(xs, lp, "moe_up", offsets)
    d = _experts(silu_mul(g, u), lp, "moe_down", offsets)        # [T*k, D]
    if El != E:
        d = torch.where(mine.index_select(0, order)[:, None], d, 0)
    eo = torch.empty_like(d).index_copy_(0, order, d).reshape(T, top_k, D)
    return torch.einsum("tkd,tk->td", eo, top_w)


def _experts(x: torch.Tensor, lp: dict, name: str, offsets: torch.Tensor) -> torch.Tensor:
    scale = lp.get(name + "_scale")
    if scale is None:
        return grouped_gemm(x, lp[name], offsets)
    return int8_linear(x, lp[name], scale, group_offsets=offsets)


# ---------------------------------------------------------------------------
# Grouped GEMM
# ---------------------------------------------------------------------------


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                       group_offsets: torch.Tensor) -> torch.Tensor:
    """out[r] = x[r] @ w[e] for rows r in [group_offsets[e],
    group_offsets[e+1]), as fp32 products rounded once to x's dtype
    (megablox gmm(..., preferred_element_type=f32).astype(x.dtype)). x
    [N, K] with rows sorted by expert, w [E, K, Nout], group_offsets [E+1]
    from 0 to N. Reads the offsets on the host: the plain version of
    csrc/grouped_gemm.cu. Rows from group_offsets[E] on belong to no group
    and are left unwritten (expert parallelism's other ranks' rows)."""
    offs = group_offsets.tolist()
    if len(offs) != w.shape[0] + 1 or offs[0] != 0 or offs[-1] > x.shape[0] \
            or any(b < a for a, b in zip(offs, offs[1:])):
        raise ValueError(f"grouped_gemm: offsets must rise from 0 to at most "
                         f"N={x.shape[0]} over {w.shape[0]} groups, got {offs}")
    out = torch.empty(x.shape[0], w.shape[2], dtype=x.dtype, device=x.device)
    for e in range(w.shape[0]):
        lo, hi = offs[e], offs[e + 1]
        if hi > lo:
            out[lo:hi] = (x[lo:hi].float() @ w[e].float()).to(x.dtype)
    return out


def _check_cuda_args(x: torch.Tensor, w: torch.Tensor, group_offsets: torch.Tensor):
    if x.device.type != "cuda":
        raise RuntimeError(f"grouped_gemm: tensors must be on a CUDA device or "
                           f"the CPU, got {x.device}")
    if x.dtype not in cuda_lib.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"grouped_gemm: x and w must share dtype float32 or "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    if group_offsets.dtype != torch.int32:
        raise TypeError(f"grouped_gemm: group_offsets must be int32, got "
                        f"{group_offsets.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1] \
            or group_offsets.shape != (w.shape[0] + 1,):
        raise ValueError(f"grouped_gemm: inconsistent shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, offsets {tuple(group_offsets.shape)}")
    for label, t in (("x", x), ("w", w), ("group_offsets", group_offsets)):
        if t.device != x.device:
            raise RuntimeError(f"grouped_gemm: {label} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_gemm: {label} must be contiguous")
    for label, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"grouped_gemm: {label} must be 16-byte aligned")
    if x.shape[1] % 8 or w.shape[2] % 8:
        raise ValueError(f"grouped_gemm: the kernel takes K and Nout in multiples "
                         f"of 8 (16-byte rows), got K={x.shape[1]}, Nout={w.shape[2]}")


# The bf16 kernel's decode route takes dispatches of at most this many rows
# per expert on average (N <= GMM_DECODE_ROWS * E): there the groups hold a
# few rows each, and a 16-row tile streams each selected expert's weights
# once where the prefill route's 128-row tile would compute mostly padding.
# ssd_tpu_torch/bench/gmm_routes.py put the crossover at Qwen3-30B-A3B's
# shapes between 4 and 8 rows per expert from a seeded router (NVIDIA H100
# 80GB HBM3, 700 W: at 512 rows decode 0.1470 / 0.1490 ms against prefill
# 0.1489 / 0.1493 at the gate / down; at 1024 rows 0.1484 / 0.1543 against
# 0.1505 / 0.1510). When every token picks the same 8 experts, the prefill
# route is faster at the down shape from 8 tokens on (0.0223 against
# 0.0257 ms), as the decode route splits each large group into 16-row tiles.
GMM_DECODE_ROWS = 4


def grouped_gemm_route(dtype: torch.dtype, N: int, E: int) -> str:
    """The kernel route of csrc/grouped_gemm.cu for a dispatch of N rows over
    E experts, from the shapes alone (no device read): "simt" for fp32,
    "decode" for bf16 with N <= GMM_DECODE_ROWS * E, else "prefill"."""
    if dtype == torch.float32:
        return "simt"
    return "decode" if N <= GMM_DECODE_ROWS * E else "prefill"


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, group_offsets: torch.Tensor) -> torch.Tensor:
    """Grouped GEMM over expert-sorted rows: the plain version for CPU
    tensors, the CUDA kernel (csrc/grouped_gemm.cu) for CUDA tensors, on
    grouped_gemm_route's route. The kernel reads the offsets on the
    device; rows from group_offsets[E] (at most N) on are not written."""
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, group_offsets)
    _check_cuda_args(x, w, group_offsets)
    N, K = x.shape
    E, _, Nout = w.shape
    route = grouped_gemm_route(x.dtype, N, E)
    out = torch.empty(N, Nout, dtype=x.dtype, device=x.device)
    lib = cuda_lib.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (x.data_ptr(), w.data_ptr(), group_offsets.data_ptr(), out.data_ptr(),
                N, K, Nout, E, stream)
        if route == "decode":
            err = lib.cdll.ssd_grouped_gemm_decode(*args)
        else:
            err = lib.cdll.ssd_grouped_gemm(cuda_lib.DTYPE_CODES[x.dtype], *args)
    lib.check(err, "grouped_gemm kernel launch")
    cuda_lib.count_launch(grouped_gemm)
    return out


grouped_gemm.launches = 0
