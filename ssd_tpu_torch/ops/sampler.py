"""Token sampling: greedy argmax, temperature sampling by exponential race,
optional top-p / top-k warp, and the tree mode's sampler_x rescaling.

Counterpart of ssd_tpu/ops/sampler.py. Randomness comes from an explicit
`torch.Generator` owned by the model runner; it gives other numbers than JAX's
keys from the same seed, so only greedy outputs compare exactly.
"""

from __future__ import annotations

import torch

from ssd_tpu_torch.ops.spec_math import apply_sampler_x_rescaling


def warp_top_probs(
    probs: torch.Tensor,   # [B, V]
    top_p: torch.Tensor,   # [B] in (0, 1]; 1 = off
    top_k: torch.Tensor,   # [B] int; <= 0 = off
) -> torch.Tensor:
    """Nucleus (top-p) + top-k filtering with renormalisation, HF processor
    semantics: top-k filters first, then top-p measures cumulative mass on the
    top-k-renormalised survivors and keeps the smallest descending prefix
    reaching top_p (the first token is always kept)."""
    V = probs.shape[-1]
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    rank = torch.arange(V, device=probs.device)[None, :]
    k = torch.where(top_k[:, None] > 0, top_k[:, None].long(),
                    torch.full_like(top_k[:, None].long(), V))
    keep_k = rank < k
    kept = torch.where(keep_k, sorted_p, torch.zeros_like(sorted_p))
    denom = kept.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    cum = torch.cumsum(kept, dim=-1) / denom
    keep_sorted = keep_k & ((cum - kept / denom) < top_p[:, None])
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    filtered = torch.where(keep, probs, torch.zeros_like(probs))
    return filtered / filtered.sum(dim=-1, keepdim=True).clamp(min=1e-30)


def sample(
    logits: torch.Tensor,        # [B, V]
    temperatures: torch.Tensor,  # [B] float32
    generator: torch.Generator | None,
    top_p: torch.Tensor | None = None,  # [B]; None = no warp
    top_k: torch.Tensor | None = None,  # [B]
    sampler_x: float | None = None,
    fan_out: int = 3,
    is_tree: bool = False,
    greedy: bool = False,
) -> torch.Tensor:
    """Rows with temperature 0 take the argmax; the others sample
    softmax(logits / T) by exponential race (argmax of probs / Exp(1), which
    is Categorical(probs)). In tree mode (the async draft) with sampler_x,
    the top-(fan_out+1) probabilities are boosted by sampler_x before the
    warp and the draw. `greedy` says that every row's temperature is 0, as
    the caller knows from its host copy of them: the draw is then skipped.
    The function reads nothing back from the device, so a CUDA graph can
    capture it. Returns [B] int64."""
    logits = logits.float()
    argmax = logits.argmax(dim=-1)
    if greedy:
        return argmax
    t = temperatures.clamp(min=1e-8)[:, None]
    probs = torch.softmax(logits / t, dim=-1)
    if sampler_x is not None and is_tree:
        probs = apply_sampler_x_rescaling(probs, sampler_x, fan_out)
    if top_p is not None:
        probs = warp_top_probs(probs, top_p, top_k)
    e = torch.empty_like(probs).exponential_(generator=generator)
    sampled = (probs / (e + 1e-10)).argmax(dim=-1)
    return torch.where(temperatures == 0, argmax, sampled)
