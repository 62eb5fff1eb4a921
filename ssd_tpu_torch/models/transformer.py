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
residual stream entering each tapped layer, concatenated. With int8 weights
(utils/quant.py) every projection, expert stack, the embedding and the head
are int8 [out, in] beside their fp32 scales `name + "_scale"`, and run
through the W8A16 kernel (ops/linear.py); the router and the norms stay in
the model's dtype. A reduced-vocabulary draft (FR-Spec style, the
checkpoint's `d2t`) has lm_head [Vd, D] over a subset of the vocabulary,
d2t [Vd] (the offset of head row i's token from i) and head_ids [Vd] (its
token, arange(Vd) + d2t, made once at load by `set_reduced_head`);
compute_logits scatters its logits into the full vocabulary, -inf
elsewhere, as ssd_tpu/models/transformer.py::compute_logits does.

Tensor parallelism (parallel/): a rank's dict holds its shard
(parallel/mesh.py) and its Arch its own query and k/v heads and MLP width,
with the rank's Comm (parallel/comm.py). The forward then sums wo's and
the MLP's partial outputs over the ranks (all_reduce_sum: down, or the
experts' combine), looks a token up in the rank's vocabulary rows of the
embedding (zeros elsewhere, exact under the sum) and all-reduces it, and
gathers the head's fp32 vocabulary slices into the full [T, V] logits on
every rank, so sampling and verify see what one card computes. A
replicated embedding or head (tp does not divide its rows: V, or Vd for a
reduced head) needs neither. With a Comm of one rank only the two
all-reduces a layer run.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from ssd_tpu_torch.config import ModelConfig
from ssd_tpu_torch.ops.layers import (
    apply_rope, rms_norm, rms_norm_residual, rope_cos_sin, silu_mul)
from ssd_tpu_torch.ops.linear import head_logits, mm, mm_shared
from ssd_tpu_torch.ops.moe import moe_mlp
from ssd_tpu_torch.parallel.comm import all_reduce_sum, gather_vocab

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
    # Tensor parallelism (parallel/mesh.py::Sharding.rank_arch): the heads
    # and MLP width above are then the rank's; the vocabulary, the width
    # and the router's experts stay the model's. comm: the rank's
    # parallel/comm.py::Comm, or None (no collective).
    tp_size: int = 1
    tp_rank: int = 0
    comm: object = field(default=None, compare=False, repr=False)
    # Rows of a reduced LM head (a draft's d2t map; utils/loader.py), or
    # None: the head spans the vocabulary.
    head_vocab: int | None = None

    @property
    def head_rows(self) -> int:
        return self.head_vocab or self.vocab_size

    @property
    def head_parallel(self) -> bool:
        """The LM head is split over the ranks by rows (parallel/mesh.py):
        tp > 1 and tp divides its rows."""
        return self.tp_size > 1 and self.head_rows % self.tp_size == 0

    @classmethod
    def from_model_config(cls, mc: ModelConfig, head_vocab: int | None = None) -> "Arch":
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
            head_vocab=head_vocab,
        )


def init_params(arch: Arch, seed: int, dtype: torch.dtype,
                device: torch.device, scale: float = 0.02, place=None) -> dict:
    """Random-normal weights (norms at one) from a generator seeded with
    `seed` on `device`, one tensor at a time (an expert stack's fp32 draw is
    the largest temporary). arch is the whole model's: every tensor is
    drawn whole, in the same order on every rank, and `place(name, x)` (the
    runner's: quantize, then keep the rank's slice) turns it into the
    leaves it keeps, so a random model is the same model at any tp."""
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

    place = place or (lambda name, x: {name: x})
    attn = (("wq", (D, Hq * hd)), ("wk", (D, Hkv * hd)), ("wv", (D, Hkv * hd)),
            ("wo", (Hq * hd, D)))
    mlp = ((("router", (D, E)), ("moe_gate", (E, D, Im)), ("moe_up", (E, D, Im)),
            ("moe_down", (E, Im, D))) if E else
           (("gate", (D, I)), ("up", (D, I)), ("down", (I, D))))
    layers = []
    for _ in range(arch.num_layers):
        lp = {"input_ln": ones(D), "post_ln": ones(D)}
        for name, shape in attn + mlp:
            lp.update(place(name, w(*shape)))
        if arch.use_qk_norm:
            lp["q_norm"] = ones(hd)
            lp["k_norm"] = ones(hd)
        layers.append(lp)
    params = {**place("embed", w(arch.vocab_size, D)), "layers": layers,
              "final_ln": ones(D)}
    if arch.tie_embeddings:
        tie_head(params)
    else:
        params.update(place("lm_head", w(arch.vocab_size, D)))
    return params


def tie_head(params: dict):
    """A tied LM head: the embedding's tensor (and its int8 scales)."""
    params["lm_head"] = params["embed"]
    if "embed_scale" in params:
        params["lm_head_scale"] = params["embed_scale"]


def set_reduced_head(params: dict, d2t: torch.Tensor):
    """Install a reduced head's map: d2t [Vd] (head row i scores token
    i + d2t[i]) and head_ids, the token of each row, on the head's device,
    which compute_logits scatters into with no host work."""
    d2t = d2t.long().to(params["lm_head"].device)
    params["d2t"] = d2t
    params["head_ids"] = torch.arange(d2t.shape[0], device=d2t.device) + d2t


def param_bytes(arch: Arch, dtype: torch.dtype, quantization: str | None = None) -> int:
    """Device bytes of a model's parameters as the runner holds them: the
    weights in `dtype` plus the fp32 copy of the LM head; with
    quantization="int8" every matrix (the embedding and the head too) in
    int8 with an fp32 scale per output channel, a tied head shared with the
    embedding, and no fp32 copy. A rank's Arch gives the rank's bytes: its
    heads and MLP width, its experts, its vocabulary rows when tp divides
    the vocabulary (parallel/mesh.py)."""
    D, I = arch.hidden_size, arch.intermediate_size
    E, Im = arch.num_experts, arch.moe_intermediate_size
    El = E // arch.tp_size
    Hq, Hkv, hd = arch.num_heads, arch.num_kv_heads, arch.head_dim
    V, L = arch.vocab_size, arch.num_layers
    if V % arch.tp_size == 0:
        V //= arch.tp_size
    Vh = arch.head_rows // arch.tp_size if arch.head_parallel else arch.head_rows
    elem = torch.finfo(dtype).bits // 8
    # (elements, output channels) of a layer's matrices; the router and the
    # norms stay in dtype.
    mats = [(D * Hq * hd, Hq * hd), (2 * D * Hkv * hd, 2 * Hkv * hd), (Hq * hd * D, D)]
    mats += [(3 * El * D * Im, El * (2 * Im + D))] if E else [(3 * D * I, 2 * I + D)]
    other = (D * E if E else 0) + 2 * D + (2 * hd if arch.use_qk_norm else 0)
    if quantization is None:
        per_layer = sum(n for n, _ in mats) + other
        return (V * D + L * per_layer + D) * elem + Vh * D * 4
    per_layer = sum(n + 4 * c for n, c in mats) + other * elem
    head = 0 if arch.tie_embeddings else Vh * D + 4 * Vh
    return L * per_layer + V * D + 4 * V + head + D * elem


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

    hidden = embed(params, input_ids, arch)
    cos, sin = rope_cos_sin(positions, hd, arch.rope_theta)
    residual = torch.zeros_like(hidden)
    taps = sorted(eagle_layers) if eagle_layers else []
    acts = []
    for li, lp in enumerate(params["layers"]):
        if li in taps:
            pre = (hidden.float() + residual.float()).to(hidden.dtype)
            acts += [pre] * taps.count(li)
        x, residual = rms_norm_residual(hidden, residual, lp["input_ln"], eps)
        q, k, v = mm_shared(x, lp, ("wq", "wk", "wv"))
        q, k, v = q.reshape(T, Hq, hd), k.reshape(T, Hkv, hd), v.reshape(T, Hkv, hd)
        if arch.use_qk_norm:
            q = rms_norm(q, lp["q_norm"], eps)
            k = rms_norm(k, lp["k_norm"], eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = attn_call(li, q, k, v)
        hidden = _reduce(mm(o.reshape(T, Hq * hd), lp, "wo"), arch)

        x, residual = rms_norm_residual(hidden, residual, lp["post_ln"], eps)
        if arch.num_experts:
            hidden = moe_mlp(x, lp, arch.num_experts_per_tok, arch.norm_topk_prob,
                             rank=arch.tp_rank)
        else:
            hidden = mm(silu_mul(*mm_shared(x, lp, ("gate", "up"))), lp, "down")
        hidden = _reduce(hidden, arch)
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
    rows (prefill projects only each sequence's last token). A
    vocabulary-parallel head's rank slices are gathered first; a reduced
    head's [T, Vd] logits (int8 scales applied) are then scattered into
    [T, V] at head_ids, -inf elsewhere: a fixed-shape copy with no host
    work, so it runs inside the step graphs."""
    if gather_idx is not None:
        hidden = hidden[gather_idx]
    logits = head_logits(rms_norm(hidden, params["final_ln"], arch.rms_norm_eps), params)
    if arch.head_parallel:
        logits = gather_vocab(arch.comm, logits)
    if "head_ids" in params:
        full = logits.new_full((logits.shape[0], arch.vocab_size), float("-inf"))
        logits = full.index_copy_(1, params["head_ids"], logits)
    return logits


def _reduce(x: torch.Tensor, arch: Arch) -> torch.Tensor:
    """A row-parallel product's partial sums added over the ranks."""
    return x if arch.comm is None else all_reduce_sum(arch.comm, x)


def embed(params: dict, input_ids: torch.Tensor, arch: Arch,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    """The embedding rows of input_ids [T] in the compute dtype (`dtype`,
    else final_ln's; an int8 row times its scale). A vocabulary-parallel
    table holds rows [tp_rank * Vl, (tp_rank + 1) * Vl): a token outside
    them looks up zeros, and the sum over the ranks gives every rank the
    row. An EAGLE-3 head's EagleArch serves as the Arch."""
    table, scale = params["embed"], params.get("embed_scale")
    Vl = table.shape[0]
    sharded = Vl != arch.vocab_size
    if sharded:
        local = input_ids.long() - arch.tp_rank * Vl
        mine = (local >= 0) & (local < Vl)
        input_ids = local.clamp(0, Vl - 1)
    cdt = dtype or params["final_ln"].dtype
    hidden = table[input_ids].to(cdt)
    if scale is not None:
        hidden = hidden * scale[input_ids].to(cdt)[:, None]
    if sharded:
        hidden = all_reduce_sum(arch.comm, torch.where(mine[:, None], hidden, 0))
    return hidden
