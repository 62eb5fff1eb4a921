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

`int8_linear_shared` runs up to three products over one x (q/k/v,
gate/up, the experts' gate/up) in one launch, each output as int8_linear
computes it on that launch's route.

`mm(x, params, name)` is the projection of models/transformer.py and
models/eagle3.py: through `int8_linear` when params holds `name + "_scale"`,
else x @ params[name]; `mm_shared` the same for products that share x, in
one launch when their weights are int8; `head_logits` their LM head, in
fp32.
"""

from __future__ import annotations

import torch

from ssd_tpu_torch.ops import cuda_lib

# The bf16 kernel's routes (csrc/int8_weight_gemm.cu). Both run wgmma with
# the int8 weights as its A operand, widened to bf16 in registers, and x as
# its B: "decode" on x tiles of 8 to 128 rows (picked from the rows a group)
# with K split across a thread-block cluster, "prefill" on 128 x 256 tiles
# (128 x 192 over groups). ssd_tpu_torch/bench/int8_routes.py --baseline put
# the rule (NVIDIA H100 80GB HBM3, 700 W; ms): decode up to 128 rows a group,
# where it beats the first kernel's mma.sync routes (gate/up at 8 rows
# 0.0177 against 0.0196; down at 80 rows 0.0333 against 0.0841; the LM head
# at 80 rows 0.1780 against 0.5227) or comes within 2% of them (q/o at 1
# row 0.0119 against 0.0117, at 8 rows 0.0116 against 0.0118; a b1 expert
# gate 0.0170 both), except a lone k/v product past 64 rows (80 rows 0.0153
# against 0.0127), which no engine issues: k/v share q's launch (q/k/v at
# 80 rows 0.0165 against 0.0475); past 128 rows prefill from N = 8192
# (gate/up at 512 rows 0.0406 against decode's 0.0470; the LM head at 160
# rows 0.2866 against 0.3856) and decode below it up to 512 rows (down at
# 512 rows 0.0708 against 0.1187).
INT8_ROUTES = {"decode": 1, "prefill": 2}
INT8_DECODE_ROWS = 128        # rows a group up to which "decode" runs
INT8_WIDE_N = 8192            # past them, "decode" below this N up to:
INT8_DECODE_ROWS_NARROW = 512


def int8_linear_route(dtype: torch.dtype, M: int, N: int, G: int) -> str:
    """K9's route for M rows over G groups into N outputs, from the shapes
    alone (no device read): "simt" for fp32 x; for bf16 "decode" up to
    INT8_DECODE_ROWS rows a group, and for one group below INT8_WIDE_N
    outputs up to INT8_DECODE_ROWS_NARROW rows; else "prefill"."""
    if dtype == torch.float32:
        return "simt"
    if M <= INT8_DECODE_ROWS * G:
        return "decode"
    if G == 1 and N < INT8_WIDE_N and M <= INT8_DECODE_ROWS_NARROW:
        return "decode"
    return "prefill"


def int8_linear_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype | None = None,
                      group_offsets: torch.Tensor | None = None) -> torch.Tensor:
    """out[rows of group g] = ((x.float() @ w[g].float().T) * scale[g])
    rounded once to out_dtype (default x's); rows from the last offset on
    belong to no group and are left unwritten. Reads the offsets on the
    host: the plain version of csrc/int8_weight_gemm.cu."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if group_offsets is None:
        return ((x.float() @ w[0].float().T) * scale[0]).to(out_dtype)
    offs = group_offsets.tolist()
    if offs[0] != 0 or offs[-1] > x.shape[0] or any(b < a for a, b in zip(offs, offs[1:])):
        raise ValueError(f"int8_linear: offsets must rise from 0 to at most M={x.shape[0]}, "
                         f"got {offs}")
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


def _launch_checks(x: torch.Tensor, ws):
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_linear: tensors must be on a CUDA device or the CPU, "
                           f"got {x.device}")
    for label, t in [("x", x)] + [("w", w) for w in ws]:
        if t.data_ptr() % 16:
            raise ValueError(f"int8_linear: {label} must be 16-byte aligned")
    if x.shape[1] % 16:
        raise ValueError(f"int8_linear: the kernel takes K in multiples of 16, got {x.shape[1]}")


def int8_linear(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                out_dtype: torch.dtype | None = None,
                group_offsets: torch.Tensor | None = None) -> torch.Tensor:
    """(x [M, K] @ w[g] [N, K]^T) * scale[g] [N] for the rows of each group
    g (group_offsets [G+1] int32 on the device, rising from 0 to at most M,
    rows past the last offset not written; None: G = 1), in out_dtype (x's,
    or float32): the plain version for CPU tensors, K9
    (csrc/int8_weight_gemm.cu) for CUDA tensors, on int8_linear_route's
    route."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    _check_args(x, w, scale, out_dtype, group_offsets)
    if x.device.type == "cpu":
        return int8_linear_plain(x, w, scale, out_dtype, group_offsets)
    _launch_checks(x, [w])
    M, K = x.shape
    G, N, _ = w.shape
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


def int8_linear_shared_plain(x: torch.Tensor, ws, scales, out_dtype=None,
                             group_offsets=None) -> list[torch.Tensor]:
    """The plain version of int8_linear_shared: one int8_linear_plain per
    (w, scale) pair."""
    return [int8_linear_plain(x, w, s, out_dtype, group_offsets) for w, s in zip(ws, scales)]


def int8_linear_shared(x: torch.Tensor, ws, scales, out_dtype: torch.dtype | None = None,
                       group_offsets: torch.Tensor | None = None) -> list[torch.Tensor]:
    """int8_linear of x by each of up to three int8 weights ws[i] [G, N_i,
    K] with scales[i] [G, N_i], over the same groups: on the card in ONE
    launch of K9 when the route rule sends the first product to a wgmma
    route and every product takes the same K split there (each output is
    computed as int8_linear computes it on that route, bit for bit), else
    one int8_linear call each (the fp32 SIMT route, or splits that
    differ); the plain version for CPU tensors."""
    if not 1 <= len(ws) <= 3 or len(scales) != len(ws):
        raise ValueError(f"int8_linear_shared: 1-3 (w, scale) pairs, got {len(ws)} "
                         f"and {len(scales)}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    for w, s in zip(ws, scales):
        _check_args(x, w, s, out_dtype, group_offsets)
    if x.device.type == "cpu":
        return int8_linear_shared_plain(x, ws, scales, out_dtype, group_offsets)
    M, K = x.shape
    G = ws[0].shape[0]
    lib = cuda_lib.load()
    route = int8_linear_route(x.dtype, M, ws[0].shape[1], G)
    if route not in ("decode", "prefill") or len(
            {lib.cdll.ssd_int8_linear_split(INT8_ROUTES[route], M, w.shape[1], K, G)
             for w in ws}) > 1:
        return [int8_linear(x, w, s, out_dtype, group_offsets) for w, s in zip(ws, scales)]
    _launch_checks(x, ws)
    outs = [torch.empty(M, w.shape[1], dtype=out_dtype, device=x.device) for w in ws]
    pad = [None] * (3 - len(ws))
    with torch.cuda.device(x.device):
        err = lib.cdll.ssd_int8_linear_multi(
            int(out_dtype == torch.float32), INT8_ROUTES[route], x.data_ptr(), len(ws),
            *[w.data_ptr() for w in ws], *pad, *[s.data_ptr() for s in scales], *pad,
            *[o.data_ptr() for o in outs], *pad, *[w.shape[1] for w in ws], *[0] * len(pad),
            None if group_offsets is None else group_offsets.data_ptr(), M, K, G,
            torch.cuda.current_stream().cuda_stream)
    lib.check(err, "int8_linear_shared kernel launch")
    cuda_lib.count_launch(int8_linear)
    return outs


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


def mm_shared(x: torch.Tensor, params: dict, names) -> list[torch.Tensor]:
    """[mm(x, params, name) for name in names]: int8 weights in one launch
    through int8_linear_shared (q/k/v, gate/up), float ones as their own
    x @ W."""
    scales = [params.get(n + "_scale") for n in names]
    if any(s is None for s in scales):
        return [mm(x, params, n) for n in names]
    return int8_linear_shared(x, [params[n][None] for n in names], [s[None] for s in scales])


def mm(x: torch.Tensor, params: dict, name: str) -> torch.Tensor:
    """x @ params[name]: an int8 weight (its scales under name + "_scale",
    stored [out, in]) through int8_linear, else a float matmul over
    [in, out]; the counterpart of ssd_tpu's `_mm` / `_emm`."""
    scale = params.get(name + "_scale")
    if scale is None:
        return x @ params[name]
    return int8_linear(x, params[name][None], scale[None])
