"""EAGLE-3 single-layer draft, conditioned on the target's activations.

Counterpart of ssd_tpu/models/eagle3.py, as plain functions over a parameter
dict:
- `fc` projects the target's tapped residual-stream activations
  [T, n_taps * D_target] to the draft width D (project_target_acts);
- one decoder layer whose attention input is the 2D-wide concat
  [norm(token embedding) | norm(conditioning)]; the conditioning (not the
  token embedding) is the residual stream (eagle_forward);
- `eagle_logits` maps the reduced draft vocabulary to the full target
  vocabulary through the `d2t` offsets, -inf elsewhere (skipped for a
  full-vocabulary head).
Weights are [in, out] (x @ W), as in models/transformer.py. The draft's KV
cache is the ordinary one-layer paged cache; the callers apply the EAGLE
position shift (canonical token p sits at draft position p - 1).

Parameter dict: embed [V, D], fc [n_taps*D_target, D], input_ln, cond_ln,
post_ln [D], wq [2D, Hq*hd], wk / wv [2D, Hkv*hd], wo [Hq*hd, D], gate / up
[D, I], down [I, D], final_ln [D], lm_head [Vd, D], d2t [Vd] int.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ssd_tpu_torch.config import ModelConfig
from ssd_tpu_torch.models.transformer import AttnCall
from ssd_tpu_torch.ops.layers import apply_rope, rms_norm, rope_cos_sin, silu_mul


@dataclass(frozen=True)
class EagleArch:
    vocab_size: int          # the full target vocabulary
    draft_vocab_size: int    # the LM head's reduced vocabulary
    hidden_size: int         # D of the draft
    intermediate_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rms_norm_eps: float
    rope_theta: float
    d_model_target: int
    num_eagle_layers: int    # taps of the target feeding fc

    @classmethod
    def from_model_config(cls, mc: ModelConfig, d_model_target: int,
                          num_eagle_layers: int = 3) -> "EagleArch":
        return cls(
            vocab_size=mc.vocab_size,
            draft_vocab_size=mc.draft_vocab_size or mc.vocab_size,
            hidden_size=mc.hidden_size,
            intermediate_size=mc.intermediate_size,
            num_heads=mc.num_attention_heads,
            num_kv_heads=mc.num_key_value_heads,
            head_dim=mc.head_dim_actual,
            rms_norm_eps=mc.rms_norm_eps,
            rope_theta=mc.rope_theta,
            d_model_target=d_model_target,
            num_eagle_layers=num_eagle_layers,
        )

    @property
    def num_layers(self) -> int:
        """One KV-cache layer (the runner sizes the pool from it)."""
        return 1

    @property
    def act_dim(self) -> int:
        return self.num_eagle_layers * self.d_model_target


def init_eagle_params(arch: EagleArch, seed: int, dtype: torch.dtype,
                      device: torch.device, scale: float = 0.02) -> dict:
    """Random-normal weights (norms at one, identity d2t) from a generator
    seeded with `seed` on `device`."""
    D, I = arch.hidden_size, arch.intermediate_size
    Hq, Hkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape):
        x = torch.randn(*shape, generator=gen, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    return {
        "embed": w(arch.vocab_size, D), "fc": w(arch.act_dim, D),
        "input_ln": ones(D), "cond_ln": ones(D), "post_ln": ones(D),
        "wq": w(2 * D, Hq * hd), "wk": w(2 * D, Hkv * hd), "wv": w(2 * D, Hkv * hd),
        "wo": w(Hq * hd, D), "gate": w(D, I), "up": w(D, I), "down": w(I, D),
        "final_ln": ones(D), "lm_head": w(arch.draft_vocab_size, D),
        "d2t": torch.zeros(arch.draft_vocab_size, dtype=torch.int64, device=device),
    }


def eagle_param_bytes(arch: EagleArch, dtype: torch.dtype) -> int:
    """Device bytes of the draft's parameters as the runner holds them: the
    weights in `dtype`, the LM head as its fp32 copy, and d2t."""
    D, I = arch.hidden_size, arch.intermediate_size
    Hq, Hkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    n = (arch.vocab_size * D + arch.act_dim * D + 2 * D * (Hq + 2 * Hkv) * hd
         + Hq * hd * D + 3 * D * I + 4 * D)
    return n * (torch.finfo(dtype).bits // 8) + arch.draft_vocab_size * (D * 4 + 8)


def project_target_acts(params: dict, acts: torch.Tensor) -> torch.Tensor:
    """fc: [T, n_taps * D_target] -> [T, D]."""
    return acts.to(params["fc"].dtype) @ params["fc"]


def eagle_forward(
    params: dict,
    input_ids: torch.Tensor,     # [T]
    conditioning: torch.Tensor,  # [T, D] (fc-projected acts or a prenorm)
    positions: torch.Tensor,     # [T] EAGLE-shifted rope positions
    attn_call: AttnCall,         # (0, q, k, v) -> o; stores the layer's KV
    arch: EagleArch,
) -> torch.Tensor:
    """The one decoder layer. Returns the prenorm hidden [T, D]: the next
    step's self-conditioning and eagle_logits' input."""
    T = input_ids.shape[0]
    Hq, Hkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    eps = arch.rms_norm_eps
    tok = params["embed"][input_ids]
    cond = conditioning.to(tok.dtype)
    x = torch.cat([rms_norm(tok, params["input_ln"], eps),
                   rms_norm(cond, params["cond_ln"], eps)], dim=-1)      # [T, 2D]
    cos, sin = rope_cos_sin(positions, hd, arch.rope_theta)
    q = apply_rope((x @ params["wq"]).reshape(T, Hq, hd), cos, sin)
    k = apply_rope((x @ params["wk"]).reshape(T, Hkv, hd), cos, sin)
    v = (x @ params["wv"]).reshape(T, Hkv, hd)
    o = attn_call(0, q, k, v)
    attn_out = o.reshape(T, Hq * hd) @ params["wo"]
    # The conditioning is the residual stream.
    resid = (attn_out.float() + cond.float()).to(tok.dtype)
    h = rms_norm(resid, params["post_ln"], eps)
    mlp = silu_mul(h @ params["gate"], h @ params["up"]) @ params["down"]
    return (mlp.float() + resid.float()).to(tok.dtype)


def eagle_logits(params: dict, prenorm: torch.Tensor, arch: EagleArch) -> torch.Tensor:
    """Final norm -> draft LM head in fp32 -> the d2t scatter into the full
    target vocabulary with -inf elsewhere. Returns [T, vocab_size] fp32. A
    full-vocabulary head (d2t the identity) skips the scatter."""
    h = rms_norm(prenorm, params["final_ln"], arch.rms_norm_eps)
    logits = h.float() @ params["lm_head"].float().T
    if arch.draft_vocab_size == arch.vocab_size:
        return logits
    target_idx = torch.arange(arch.draft_vocab_size, device=logits.device) \
        + params["d2t"].long()
    full = torch.full((logits.shape[0], arch.vocab_size), float("-inf"),
                      dtype=torch.float32, device=logits.device)
    full[:, target_idx] = logits
    return full
