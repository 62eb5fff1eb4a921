"""Elementwise transformer ops: RMSNorm, rotary embedding, SiLU-MLP glue.

Counterpart of ssd_tpu/ops/layers.py. Norms, rotary and the SiLU product run
in fp32 and cast back to the input dtype, as in the JAX package, so greedy
outputs stay comparable across the two.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rms_norm_residual(
    x: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused add-residual RMSNorm: returns (norm(x+residual), x+residual)."""
    r = (x.float() + residual.float()).to(x.dtype)
    return rms_norm(r, weight, eps), r


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin [T, hd/2] in fp32, computed on the fly (no table)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    angles = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF-Llama rotate-half convention. x: [T, H, hd], cos/sin: [T, hd/2]."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    c = cos[:, None, :]
    s = sin[:, None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    g = gate.float()
    return (g * (1.0 / (1.0 + torch.exp(-g))) * up.float()).to(gate.dtype)
