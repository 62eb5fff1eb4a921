"""Speculative-decoding verification: the exactness core.

Counterpart of ssd_tpu/ops/verify.py: greedy argmax compare; p/q-ratio
acceptance only on rows whose draft tokens really were sampled from q (cache
hits in async mode, every row with jit_speculate); recovery drawn from
norm(max(0, p - q)) on rejected ratio rows, else from p; greedy recovery at
temperature 0. Returns (accept_until [B], recovery [B]); the host assembles
the ragged accepted suffixes from tokens it already holds.

The random draws come from a torch.Generator. They cannot reproduce
jax.random's streams, so `noise` lets a caller pass the draws in (the tests
hand both packages the same uniforms and Gumbel noise).
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tpu_torch.ops.sampler import warp_top_probs
from ssd_tpu_torch.ops.spec_math import apply_sampler_x_rescaling


def _probs_with_greedy_onehot(logits: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
    """softmax(logits / T) on rows with T > 0, one-hot(argmax) on T == 0 rows.
    logits [B, S, V] (softmax in fp32), temps [B]."""
    V = logits.shape[-1]
    t = temps.clamp(min=1e-8)[:, None, None]
    soft = torch.softmax(logits.float() / t, dim=-1)
    onehot = torch.nn.functional.one_hot(logits.argmax(dim=-1), V).float()
    return torch.where((temps > 0)[:, None, None], soft, onehot)


def _categorical(probs: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Gumbel-max draw per row of probs [B, V] with the given noise."""
    logp = torch.log(probs.clamp(min=1e-30))
    return torch.where(probs > 0, logp + gumbel,
                       torch.full_like(logp, float("-inf"))).argmax(dim=-1)


def _gumbel(shape, generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=1e-20)))


def verify(
    logits_p: torch.Tensor,          # [B, K+1, V] target logits
    logits_q: torch.Tensor,          # [B, K, V] draft logits
    speculations: torch.Tensor,      # [B, K+1] = [recovery | draft tokens]
    temperatures_target: torch.Tensor,  # [B]
    temperatures_draft: torch.Tensor,   # [B]
    cache_hits: torch.Tensor | None,    # [B] {0,1} or None
    generator: torch.Generator | None,
    jit_speculate: bool = False,
    sampler_x: float | None = None,
    async_fan_out: int | None = None,
    top_p: torch.Tensor | None = None,  # [B]; warps both p and q
    top_k: torch.Tensor | None = None,  # [B]
    noise: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    greedy: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (accept_until [B] in [0, K], recovery token [B]). The
    accepted suffix of row b is [speculations[b, 0]] +
    draft_tokens[b, :accept_until[b]]. `noise` = (uniforms [B, K], Gumbel
    noise [B, V] for the adjusted recovery, Gumbel noise [B, V] for the
    recovery from p); drawn from `generator` when None. `greedy` says that
    no row samples: every target temperature is 0 and no row takes ratio
    acceptance (`all_greedy` computes it from the host's copies). The
    probabilities are then skipped. Nothing is read back from the device, so
    a CUDA graph can capture the function."""
    B, Kp1, V = logits_p.shape
    K = Kp1 - 1
    dev = logits_p.device
    draft_tokens = speculations[:, 1:].long()               # [B, K]
    batch = torch.arange(B, device=dev)

    # --- greedy ---
    preds_p = logits_p.argmax(dim=-1)                       # [B, K+1]
    mismatch = draft_tokens != preds_p[:, :-1]
    accept_greedy = torch.where(mismatch.any(dim=1), mismatch.int().argmax(dim=1),
                                torch.full((B,), K, device=dev))
    rec_greedy = preds_p[batch, accept_greedy]

    # --- ratio acceptance, only on rows whose tokens came from q ---
    temps_t, temps_q = temperatures_target, temperatures_draft
    base_ratio_rows = (temps_t > 0) | (temps_q > 0)
    if jit_speculate:
        ratio_rows = base_ratio_rows
    elif cache_hits is not None:
        ratio_rows = base_ratio_rows & cache_hits.bool()
    else:
        ratio_rows = torch.zeros_like(base_ratio_rows)
    if greedy:
        return accept_greedy, rec_greedy   # all greedy: no probabilities needed

    probs_p = _probs_with_greedy_onehot(logits_p, temps_t)  # [B, K+1, V]
    probs_q = _probs_with_greedy_onehot(logits_q, temps_q)  # [B, K, V]
    if sampler_x is not None:
        assert async_fan_out is not None
        probs_q = apply_sampler_x_rescaling(probs_q, sampler_x, async_fan_out)
    if top_p is not None:
        # Both sides warp, so rejection sampling stays exact with respect to
        # the warped target distribution (q is what the draft sampled from).
        probs_p = warp_top_probs(probs_p.reshape(-1, V), top_p.repeat_interleave(Kp1),
                                 top_k.repeat_interleave(Kp1)).reshape(B, Kp1, V)
        probs_q = warp_top_probs(probs_q.reshape(-1, V), top_p.repeat_interleave(K),
                                 top_k.repeat_interleave(K)).reshape(B, K, V)

    idx = draft_tokens[:, :, None]
    p_vals = torch.gather(probs_p[:, :K, :], 2, idx)[:, :, 0]
    q_vals = torch.gather(probs_q, 2, idx)[:, :, 0]
    accept_probs = (p_vals / (q_vals + 1e-10)).clamp(max=1.0)

    if noise is None:
        noise = (torch.rand((B, K), generator=generator, device=dev),
                 _gumbel((B, V), generator, dev), _gumbel((B, V), generator, dev))
    rand, g_adj, g_p = noise
    rejects = ~(rand <= accept_probs)
    accept_ratio = torch.where(rejects.any(dim=1), rejects.int().argmax(dim=1),
                               torch.full((B,), K, device=dev))
    accept_until = torch.where(ratio_rows, accept_ratio, accept_greedy)

    # --- recovery distribution ---
    p_fallback = probs_p[batch, accept_until]               # [B, V]
    fallback = p_fallback / p_fallback.sum(dim=1, keepdim=True).clamp(min=1e-30)
    q_slice = probs_q[batch, accept_until.clamp(max=K - 1)]
    adjust = (temps_t > 0) & (accept_until < K) & ratio_rows
    adj = (p_fallback - q_slice).clamp(min=0.0)
    sums = adj.sum(dim=1, keepdim=True)
    adj_norm = torch.where(sums > 0, adj / sums.clamp(min=1e-30), fallback)
    rec_ratio = torch.where(adjust, _categorical(adj_norm, g_adj),
                            _categorical(fallback, g_p))
    return accept_until, torch.where(temps_t > 0, rec_ratio, rec_greedy)


def all_greedy(temps_target, temps_draft, cache_hits=None,
               jit_speculate: bool = False) -> bool:
    """verify()'s `greedy` flag from the host's copies (numpy) of its inputs:
    no target temperature above 0 and no row that takes ratio acceptance."""
    sampled_t = np.asarray(temps_target) > 0
    ratio = sampled_t | (np.asarray(temps_draft) > 0)
    if not jit_speculate:
        ratio &= (np.zeros_like(ratio) if cache_hits is None
                  else np.asarray(cache_hits).astype(bool))
    return not sampled_t.any() and not ratio.any()


def build_suffixes(speculations, accept_until) -> tuple[list[list[int]], None]:
    """Ragged accepted suffixes on the host: [recovery] + the first
    accept_until[b] draft tokens of each row."""
    spec = np.asarray(speculations)
    acc = np.asarray(accept_until)
    return [[int(spec[b, 0])] + [int(x) for x in spec[b, 1:1 + int(acc[b])]]
            for b in range(spec.shape[0])], None
