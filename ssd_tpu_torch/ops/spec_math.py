"""Speculative-decoding math: lookahead sizing, fork selection, sampler_x
rescaling and the analytic tree-attention mask.

Counterpart of ssd_tpu/ops/spec_math.py, in PyTorch. The tree mask is
computed from four integers per row (prefix length, glue depth, step, row),
never materialised as a bitmask; csrc/tree_attention.cu evaluates the same
formula per position.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_megaspec_lookahead(MQ_LEN: int, K: int) -> int:
    """KV slots a single async spec step may consume beyond the trunk:
    glue (K+1) + tree (K steps x MQ_LEN rows)."""
    return K + 1 + K * MQ_LEN


def fan_index(fan_out_list: list[int]) -> np.ndarray:
    """Per-tree-row glue depth: row r descends from glue position
    fan_index[r], e.g. [2, 2] -> [0, 0, 1, 1]. Length MQ_LEN."""
    return np.repeat(np.arange(len(fan_out_list)), fan_out_list).astype(np.int32)


def stable_topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k indices of x [..., V] by one stable descending sort, which keeps
    equal values in index order: ties go to the lowest index first, as
    jax.lax.top_k orders them (torch.topk does not promise that order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def _small_topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k indices of x [..., V] in jax.lax.top_k's order. For small k, k
    passes of argmax (which returns the first maximal index) with the winner
    masked out; beyond k = 8, stable_topk_indices."""
    if k > 8:
        return stable_topk_indices(x, k)
    flat = x.reshape(-1, x.shape[-1]).clone()
    idxs = []
    for _ in range(k):
        i = flat.argmax(dim=-1)
        idxs.append(i)
        # A scatter of a scalar: no host tensor to copy, so a CUDA graph
        # can capture it (an indexed assignment of a Python float cannot).
        flat.scatter_(1, i[:, None], float("-inf"))
    return torch.stack(idxs, dim=-1).reshape(x.shape[:-1] + (k,))


class FanOut:
    """The tree's fan-out lists as device buffers, built once by their owner
    (the draft runner) so that a step uploads nothing: per glue depth the
    fork counts of a hit row and of a miss row, and per tree row its glue
    depth under each list (fan_index)."""

    def __init__(self, fan_out_list, fan_out_list_miss, device):
        self.hit_list, self.miss_list = tuple(fan_out_list), tuple(fan_out_list_miss)
        self.MQ = sum(self.hit_list)
        self.k_max = max(max(self.hit_list), max(self.miss_list))
        self.hit_counts = torch.tensor(self.hit_list, device=device)
        self.miss_counts = torch.tensor(self.miss_list, device=device)
        self.hit_index = torch.from_numpy(fan_index(self.hit_list)).to(device)
        self.miss_index = torch.from_numpy(fan_index(self.miss_list)).to(device)

    def rows(self, cache_hits: torch.Tensor) -> torch.Tensor:
        """Glue depth of each tree row [B, MQ] int32: the hit list's on hit
        rows, the miss list's on the others."""
        return torch.where(cache_hits.bool()[:, None], self.hit_index[None, :],
                           self.miss_index[None, :])


def get_forked_recovery_tokens(
    logits: torch.Tensor,           # [B, K+1, V] glue logits
    cache_hits: torch.Tensor,       # [B] {0,1}
    returned_tokens: torch.Tensor,  # [B, K+1] tokens already returned ([rec | spec])
    fan: FanOut,
) -> torch.Tensor:
    """Top-F fork tokens per glue depth, excluding the token already returned
    at that depth. Depth j gets fan.hit_list[j] forks on a hit row and
    fan.miss_list[j] on a miss row. Reads nothing back and uploads nothing.
    Returns [B, MQ_LEN] int64."""
    B, Kp1, V = logits.shape
    K = Kp1 - 1
    assert len(fan.hit_list) == Kp1
    dev = logits.device
    logits = logits.clone()
    logits[:, :K].scatter_(2, returned_tokens[:, 1:, None].long(), float("-inf"))

    k_max = fan.k_max
    topk_idx = _small_topk_indices(logits, k_max)                    # [B, K+1, k]
    counts = torch.where(cache_hits.bool()[:, None], fan.hit_counts[None, :],
                         fan.miss_counts[None, :])                  # [B, K+1]
    mask = torch.arange(k_max, device=dev)[None, None, :] < counts[:, :, None]
    # A fixed count per row at varying places: stable-sort the "not
    # selected" flag so the selected entries come first, in order.
    order = torch.argsort((~mask).reshape(B, -1).to(torch.int8), dim=1,
                          stable=True)[:, :fan.MQ]
    return torch.gather(topk_idx.reshape(B, -1), 1, order)


def apply_sampler_x_rescaling(probs: torch.Tensor, sampler_x: float, F: int) -> torch.Tensor:
    """Boost the top-(F+1) probabilities of each row by sampler_x, then
    renormalise. probs: [..., V]."""
    idx = _small_topk_indices(probs, F + 1)
    boost = torch.ones_like(probs).scatter(-1, idx, sampler_x)
    probs = probs * boost
    return probs / probs.sum(dim=-1, keepdim=True)


def tree_attention_mask(
    context_lens: torch.Tensor,  # [B] attended context length at this step
    step: int,                   # tree-decode depth s (0-based)
    fan_idx_rows: torch.Tensor,  # [B, MQ_LEN] glue depth per row
    K: int,
    MQ_LEN: int,
    ctx_pad: int,
) -> torch.Tensor:
    """Boolean mask [B, MQ_LEN, ctx_pad], True = attend. At step s a
    sequence's attended context is laid out as
      [ prefix (prefix_len) | glue (K+1) | step-0 rows (MQ_LEN) | ... | step-s rows ]
    with prefix_len = context_lens - (K+1) - (s+1)*MQ_LEN. Row r attends the
    whole prefix, glue offsets 0..fan_idx[r], and its own column r of every
    tree step so far."""
    dev = context_lens.device
    ctx = context_lens.long()[:, None, None]
    pfx = ctx - (K + 1) - (step + 1) * MQ_LEN
    pos = torch.arange(ctx_pad, device=dev)[None, None, :]
    in_prefix = pos < pfx
    glue_off = pos - pfx
    in_glue = (glue_off >= 0) & (glue_off <= fan_idx_rows.long()[:, :, None])
    tree_off = pos - pfx - (K + 1)
    rows = torch.arange(MQ_LEN, device=dev)[None, :, None]
    in_tree = ((tree_off >= 0) & (tree_off < (step + 1) * MQ_LEN)
               & (torch.remainder(tree_off, MQ_LEN) == rows))
    return (in_prefix | in_glue | in_tree) & (pos < ctx)
