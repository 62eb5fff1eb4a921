"""Weight-only int8 quantization.

The port's copy of ssd_tpu/utils/quant.py, on torch tensors. Each matmul
weight W [in, out] becomes int8 q and float32 scales s [out], one per output
channel: s = max(amax, 1e-8) / 127 with amax over the contraction dimension,
q = clip(round(W / s), -127, 127) with ties to even (as jnp.round). The
forward computes (x @ q) * s through the W8A16 kernel (ops/linear.py, K9),
which reads the int8 bytes and widens them in registers. The KV cache, the
norms and the MoE router stay unquantized.

Layout: q is stored K-contiguous, [out, in] (expert stacks [E, out, in]),
where the JAX package keeps [in, out]; that is the B operand of the kernel's
tensor-core product, and the layout the LM head already has ([V, D]). The
embedding and the head are [V, D] with one scale per vocabulary row; a tied
head stays one tensor, shared with the embedding. Keys: the int8 weight
under `name`, its scales under `name + "_scale"`, with the weight's leading
stack dimensions (an expert stack's scales are [E, out]).

Under tensor parallelism a tensor is quantized whole and then sharded
(`quantize_leaf`, then parallel/mesh.py), as the JAX package quantizes
before it shards: a row-parallel wo or down keeps the scales of its full
input axis, which a shard's own amax would change.
"""

from __future__ import annotations

import torch

# The matmul weights of a model's layer and of an EAGLE-3 head ([in, out]).
LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "gate", "up", "down",
                 "moe_gate", "moe_up", "moe_down")
EAGLE_WEIGHTS = ("wq", "wk", "wv", "wo", "gate", "up", "down", "fc")


def _quantize_leaf(w: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of w over its contraction dimension
    `axis`; returns (q with `axis` moved last, contiguous; scales with
    `axis` removed). [.., in, out] with axis -2 gives q [.., out, in] and
    s [.., out]; the embedding [V, D] with axis 1 gives q [V, D] and s [V]."""
    w32 = w.float().movedim(axis, -1)
    amax = w32.abs().amax(dim=-1, keepdim=True)
    s = amax.clamp(min=1e-8) / 127.0
    q = torch.round(w32 / s).clamp_(-127, 127).to(torch.int8).contiguous()
    return q, s.squeeze(-1)


def quantize_leaf(name: str, w: torch.Tensor) -> dict:
    """A model leaf as the int8 path holds it: {name: q, name_scale: s}
    for a layer's matmul weight, the embedding or the head, else {name: w}."""
    if name in LAYER_WEIGHTS:
        axis = w.dim() - 2
    elif name in ("embed", "lm_head"):
        axis = 1
    else:
        return {name: w}
    q, s = _quantize_leaf(w, axis)
    return {name: q, name + "_scale": s}


def _quantize_head(params: dict):
    """The embedding and the LM head, one scale per vocabulary row; a tied
    head (the same tensor as the embedding) stays shared."""
    tied = params["lm_head"] is params["embed"]
    params.update(quantize_leaf("embed", params["embed"]))
    if tied:
        params["lm_head"], params["lm_head_scale"] = params["embed"], params["embed_scale"]
    else:
        params.update(quantize_leaf("lm_head", params["lm_head"]))


def quantize_params(params: dict) -> dict:
    """Quantize a model's parameter dict (models/transformer.py layout) in
    place, leaf by leaf: each float weight is dropped as its int8 copy is
    made, so the device holds one float leaf's temporaries beyond the
    weights at any time. Returns the dict."""
    for lp in params["layers"]:
        for name in LAYER_WEIGHTS:
            if name in lp:
                lp.update(quantize_leaf(name, lp[name]))
    _quantize_head(params)
    return params


def quantize_eagle_params(params: dict) -> dict:
    """Quantize an EAGLE-3 head's flat dict (models/eagle3.py layout) in
    place: its projections, fc, the embedding and the LM head (the head's
    full-vocabulary LM head is most of its bytes a step). Returns the dict."""
    for name in EAGLE_WEIGHTS:
        params[name], params[name + "_scale"] = _quantize_leaf(params[name], 0)
    _quantize_head(params)
    return params
