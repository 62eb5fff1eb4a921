"""Decoder-only transformer (Llama-3, Qwen-3 and Qwen3-MoE families) as plain
functions over a parameter dict.

Counterpart of ssd_tpu/models/transformer.py. The JAX package stacks layers
along a leading axis and runs one `lax.scan`; here the layers are a list of
per-layer dicts and the forward is a Python loop over them. Weights are kept
as [in, out] (x @ W), as in JAX. The attention itself is a callable built by
the model runner for the phase (prefill or decode), which updates the layer's
KV cache in place and returns the attention output.

Parameter dict:
  embed [V, D], final_ln [D], lm_head [V, D] (the same tensor as embed when
  tied), layers: list of {input_ln [D], wq [D, Hq*hd], wk [D, Hkv*hd],
  wv [D, Hkv*hd], wo [Hq*hd, D], post_ln [D], the MLP, and q_norm/k_norm
  [hd] for Qwen-3}. The MLP is gate [D, I], up [D, I], down [I, D] for a
  dense model; for Qwen3-MoE it is router [D, E] and the expert stacks
  moe_gate / moe_up [E, D, Im] and moe_down [E, Im, D] of the layer (the JAX
  package stacks them [L, E, ...]), run by ops/moe.py::moe_mlp.
With `eagle_layers`, forward_hidden also returns the EAGLE-3 taps: the
residual stream entering each tapped layer, concatenated. Not ported yet:
int8 weights, the reduced vocabulary of a plain (non-EAGLE) draft (d2t).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ssd_tpu_torch.config import ModelConfig
from ssd_tpu_torch.ops.layers import (
    apply_rope, rms_norm, rms_norm_residual, rope_cos_sin, silu_mul)
from ssd_tpu_torch.ops.moe import moe_mlp

# attn_call(layer index, q [T,Hq,hd], k [T,Hkv,hd], v [T,Hkv,hd]) -> [T,Hq,hd]
AttnCall = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class Arch:
    """Static architecture descriptor."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rms_norm_eps: float
    rope_theta: float
    use_qk_norm: bool
    tie_embeddings: bool
    # Mixture-of-experts (Qwen3-MoE): 0 experts = dense MLP; with experts,
    # every layer is sparse (config.py refuses a non-uniform stack).
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = False

    @classmethod
    def from_model_config(cls, mc: ModelConfig) -> "Arch":
        return cls(
            vocab_size=mc.vocab_size,
            hidden_size=mc.hidden_size,
            intermediate_size=mc.intermediate_size,
            num_layers=mc.num_hidden_layers,
            num_heads=mc.num_attention_heads,
            num_kv_heads=mc.num_key_value_heads,
            head_dim=mc.head_dim_actual,
            rms_norm_eps=mc.rms_norm_eps,
            rope_theta=mc.rope_theta,
            use_qk_norm=mc.model_type in ("qwen3", "qwen3_moe"),
            tie_embeddings=mc.tie_word_embeddings,
            num_experts=mc.num_experts,
            num_experts_per_tok=mc.num_experts_per_tok,
            moe_intermediate_size=mc.moe_intermediate_size,
            norm_topk_prob=mc.norm_topk_prob,
        )


def init_params(arch: Arch, seed: int, dtype: torch.dtype,
                device: torch.device, scale: float = 0.02) -> dict:
    """Random-normal weights (norms at one) from a generator seeded with
    `seed` on `device`, one tensor at a time (an expert stack's fp32 draw is
    the largest temporary)."""
    D, I = arch.hidden_size, arch.intermediate_size
    E, Im = arch.num_experts, arch.moe_intermediate_size
    Hq, Hkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape):
        x = torch.randn(*shape, generator=gen, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    def ones(*shape):
        return torch.ones(*shape, dtype=dtype, device=device)

    layers = []
    for _ in range(arch.num_layers):
        lp = {
            "input_ln": ones(D), "wq": w(D, Hq * hd), "wk": w(D, Hkv * hd),
            "wv": w(D, Hkv * hd), "wo": w(Hq * hd, D), "post_ln": ones(D),
        }
        if E:
            lp.update(router=w(D, E), moe_gate=w(E, D, Im), moe_up=w(E, D, Im),
                      moe_down=w(E, Im, D))
        else:
            lp.update(gate=w(D, I), up=w(D, I), down=w(I, D))
        if arch.use_qk_norm:
            lp["q_norm"] = ones(hd)
            lp["k_norm"] = ones(hd)
        layers.append(lp)
    params = {"embed": w(arch.vocab_size, D), "layers": layers,
              "final_ln": ones(D)}
    params["lm_head"] = (params["embed"] if arch.tie_embeddings
                         else w(arch.vocab_size, D))
    return params


def param_bytes(arch: Arch, dtype: torch.dtype) -> int:
    """Device bytes of a model's parameters as the runner holds them: the
    weights in `dtype` plus the fp32 copy of the LM head."""
    D, I = arch.hidden_size, arch.intermediate_size
    E, Im = arch.num_experts, arch.moe_intermediate_size
    Hq, Hkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    mlp = D * E + 3 * E * D * Im if E else 3 * D * I
    per_layer = 2 * D * Hq * hd + 2 * D * Hkv * hd + mlp + 2 * D + 2 * hd
    elem = torch.finfo(dtype).bits // 8
    return (arch.vocab_size * D + arch.num_layers * per_layer + D) * elem \
        + arch.vocab_size * D * 4


def forward_hidden(
    params: dict,
    input_ids: torch.Tensor,   # [T]
    positions: torch.Tensor,   # [T] rope positions
    attn_call: AttnCall,
    arch: Arch,
    eagle_layers: tuple[int, ...] | None = None,
):
    """Embed -> L x (attention + MLP) -> pre-final-norm hidden states [T, D].
    With eagle_layers, returns (hidden, acts [T, len(eagle_layers) * D]):
    the residual-stream value entering each tapped layer (hidden + residual,
    summed in fp32 as the JAX package does), in ascending tap order with
    duplicates repeated (ssd_tpu/models/transformer.py::forward_hidden)."""
    T = input_ids.shape[0]
    Hq, Hkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    eps = arch.rms_norm_eps

    hidden = params["embed"][input_ids]
    cos, sin = rope_cos_sin(positions, hd, arch.rope_theta)
    residual = torch.zeros_like(hidden)
    taps = sorted(eagle_layers) if eagle_layers else []
    acts = []
    for li, lp in enumerate(params["layers"]):
        if li in taps:
            pre = (hidden.float() + residual.float()).to(hidden.dtype)
            acts += [pre] * taps.count(li)
        x, residual = rms_norm_residual(hidden, residual, lp["input_ln"], eps)
        q = (x @ lp["wq"]).reshape(T, Hq, hd)
        k = (x @ lp["wk"]).reshape(T, Hkv, hd)
        v = (x @ lp["wv"]).reshape(T, Hkv, hd)
        if arch.use_qk_norm:
            q = rms_norm(q, lp["q_norm"], eps)
            k = rms_norm(k, lp["k_norm"], eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = attn_call(li, q, k, v)
        hidden = o.reshape(T, Hq * hd) @ lp["wo"]

        x, residual = rms_norm_residual(hidden, residual, lp["post_ln"], eps)
        if arch.num_experts:
            hidden = moe_mlp(x, lp, arch.num_experts_per_tok, arch.norm_topk_prob)
        else:
            hidden = silu_mul(x @ lp["gate"], x @ lp["up"]) @ lp["down"]
    hidden = (hidden.float() + residual.float()).to(hidden.dtype)
    if eagle_layers:
        return hidden, torch.cat(acts, dim=-1)
    return hidden


def compute_logits(
    params: dict,
    hidden: torch.Tensor,   # [T, D] pre-final-norm
    arch: Arch,
    gather_idx: torch.Tensor | None = None,  # [B] token rows to project
) -> torch.Tensor:
    """Final RMSNorm + LM head in fp32, optionally on a gathered subset of
    rows (prefill projects only each sequence's last token)."""
    if gather_idx is not None:
        hidden = hidden[gather_idx]
    hidden = rms_norm(hidden, params["final_ln"], arch.rms_norm_eps)
    return hidden.float() @ params["lm_head"].float().T
