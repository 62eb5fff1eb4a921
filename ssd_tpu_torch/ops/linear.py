"""Linear layers over int8 weights (quantization="int8") and their kernel.

`int8_linear` computes y = (x @ q^T) * s for int8 weights q [G, N, K] stored
[out, in] with float32 scales s [G, N] per output channel
(utils/quant.py), optionally over groups of rows (the experts of a
Qwen3-MoE layer, with the grouped GEMM's offsets). Given CPU tensors it
computes the plain version; given CUDA tensors it launches the W8A16 GEMM
(csrc/int8_weight_gemm.cu, K9) or raises, and counts the launch in
`int8_linear.launches`. It reads nothing on the host, so it runs inside a
CUDA graph capture.

K9 replaces no Pallas kernel: the JAX package leaves (x @ q.astype(x.dtype))
* s to XLA, which fuses the convert into the dot
(ssd_tpu/models/transformer.py:153-161, ssd_tpu/utils/quant.py:4-7).
Rounding: in bf16 the JAX package rounds the product to bf16 and then the
product times the scale; K9 and its plain version scale the fp32 sums and
round once, so the two can differ by a bf16 ulp. In fp32 both round the
product and then its scaled value to fp32, and differ by summation order
only.

`mm(x, params, name)` is the projection of models/transformer.py and
models/eagle3.py: through `int8_linear` when params holds `name + "_scale"`,
else x @ params[name]; `head_logits` their LM head, in fp32.
"""

from __future__ import annotations

import torch

from ssd_tpu_torch.ops import cuda_lib

# The bf16 kernel's two tile shapes (csrc/int8_weight_gemm.cu, w8::Small
# and w8::Large). The 16 x 16 tiles read the weights once per 16 rows; the
# 64 x 64 tiles once per 64, but make N/64 blocks a row tile, too few to
# stream narrow weights. ssd_tpu_torch/bench/int8_routes.py put the
# crossover (NVIDIA H100 80GB HBM3, 700 W): 64 x 64 wins from 24 rows at N
# = 8192 (gate/up 31.6 against 32.2 µs) and at the 128,256-wide LM head
# (269.4 against 347.1; at 80 rows 523.0 against 962.4), but at N = 2048
# only from 128 rows (q/o 32.4 against 34.0; at 80 rows 32.0 against
# 27.5), and never below 256 rows at N = 512 or over Qwen3-30B-A3B's
# expert groups (at 64 tokens 131.8 against 205.0).
INT8_ROUTES = {"small": 0, "large": 1}
INT8_SMALL_ROWS = 16          # rows per group that always take 16 x 16 tiles
INT8_NARROW_ROWS = 128        # ... and below INT8_WIDE_N outputs
INT8_WIDE_N = 8192


def int8_linear_route(dtype: torch.dtype, M: int, N: int, G: int) -> str:
    """K9's route for M rows over G groups into N outputs, from the shapes
    alone (no device read): "simt" for fp32 x; for bf16 "small" at up to
    INT8_SMALL_ROWS rows a group on average, or up to INT8_NARROW_ROWS
    when N < INT8_WIDE_N; else "large"."""
    if dtype == torch.float32:
        return "simt"
    rows = M / G
    if rows <= INT8_SMALL_ROWS or (rows <= INT8_NARROW_ROWS and N < INT8_WIDE_N):
        return "small"
    return "large"


def int8_linear_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype | None = None,
                      group_offsets: torch.Tensor | None = None) -> torch.Tensor:
    """out[rows of group g] = ((x.float() @ w[g].float().T) * scale[g])
    rounded once to out_dtype (default x's). Reads the offsets on the host:
    the plain version of csrc/int8_weight_gemm.cu."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if group_offsets is None:
        return ((x.float() @ w[0].float().T) * scale[0]).to(out_dtype)
    offs = group_offsets.tolist()
    if offs[0] != 0 or offs[-1] != x.shape[0] or any(b < a for a, b in zip(offs, offs[1:])):
        raise ValueError(f"int8_linear: offsets must rise from 0 to M={x.shape[0]}, got {offs}")
    out = torch.empty(x.shape[0], w.shape[1], dtype=out_dtype, device=x.device)
    for g, (lo, hi) in enumerate(zip(offs, offs[1:])):
        if hi > lo:
            out[lo:hi] = ((x[lo:hi].float() @ w[g].float().T) * scale[g]).to(out_dtype)
    return out


def _check_args(x, w, scale, out_dtype, group_offsets):
    if x.dtype not in cuda_lib.DTYPE_CODES or out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"int8_linear: x must be float32 or bfloat16 and the output x's "
                        f"dtype or float32, got {x.dtype} and {out_dtype}")
    if w.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8_linear: w must be int8 and scale float32, got {w.dtype} "
                        f"and {scale.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[2] != x.shape[1] \
            or scale.shape != w.shape[:2]:
        raise ValueError(f"int8_linear: inconsistent shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, scale {tuple(scale.shape)}")
    tensors = {"x": x, "w": w, "scale": scale}
    if group_offsets is None:
        if w.shape[0] != 1:
            raise ValueError(f"int8_linear: {w.shape[0]} groups need group_offsets")
    else:
        if group_offsets.dtype != torch.int32 or group_offsets.shape != (w.shape[0] + 1,):
            raise ValueError(f"int8_linear: group_offsets must be int32 [{w.shape[0] + 1}], "
                             f"got {group_offsets.dtype} {tuple(group_offsets.shape)}")
        tensors["group_offsets"] = group_offsets
    for label, t in tensors.items():
        if t.device != x.device:
            raise RuntimeError(f"int8_linear: {label} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_linear: {label} must be contiguous")


def int8_linear(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype | None = None,
                group_offsets: torch.Tensor | None = None) -> torch.Tensor:
    """(x [M, K] @ w[g] [N, K]^T) * scale[g] [N] for the rows of each group
    g (group_offsets [G+1] int32 on the device, running from 0 to M; None:
    G = 1), in out_dtype (x's, or float32): the plain version for CPU
    tensors, K9 (csrc/int8_weight_gemm.cu) for CUDA tensors, on
    int8_linear_route's route."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    _check_args(x, w, scale, out_dtype, group_offsets)
    if x.device.type == "cpu":
        return int8_linear_plain(x, w, scale, out_dtype, group_offsets)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_linear: tensors must be on a CUDA device or the CPU, "
                           f"got {x.device}")
    for label, t in (("x", x), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"int8_linear: {label} must be 16-byte aligned")
    M, K = x.shape
    G, N, _ = w.shape
    if K % 16:
        raise ValueError(f"int8_linear: the kernel takes K in multiples of 16, got {K}")
    route = int8_linear_route(x.dtype, M, N, G)
    out = torch.empty(M, N, dtype=out_dtype, device=x.device)
    lib = cuda_lib.load()
    with torch.cuda.device(x.device):
        err = lib.cdll.ssd_int8_linear(
            cuda_lib.DTYPE_CODES[x.dtype], int(out_dtype == torch.float32),
            INT8_ROUTES.get(route, 0), x.data_ptr(), w.data_ptr(), scale.data_ptr(),
            None if group_offsets is None else group_offsets.data_ptr(), out.data_ptr(),
            M, N, K, G, torch.cuda.current_stream().cuda_stream)
    lib.check(err, "int8_linear kernel launch")
    cuda_lib.count_launch(int8_linear)
    return out


int8_linear.launches = 0


def head_logits(h: torch.Tensor, params: dict) -> torch.Tensor:
    """h [T, D] times the LM head [V, D] transposed, in fp32, as the JAX
    package computes it: an int8 head through int8_linear with fp32 output
    (each product of a bf16 or fp32 value and an int8 one is exact in fp32),
    else the fp32 GEMM over the runner's fp32 copy of the head."""
    scale = params.get("lm_head_scale")
    if scale is None:
        return h.float() @ params["lm_head"].float().T
    return int8_linear(h, params["lm_head"][None], scale[None], out_dtype=torch.float32)


def mm(x: torch.Tensor, params: dict, name: str) -> torch.Tensor:
    """x @ params[name]: an int8 weight (its scales under name + "_scale",
    stored [out, in]) through int8_linear, else a float matmul over
    [in, out]; the counterpart of ssd_tpu's `_mm` / `_emm`."""
    scale = params.get(name + "_scale")
    if scale is None:
        return x @ params[name]
    return int8_linear(x, params[name][None], scale[None])
