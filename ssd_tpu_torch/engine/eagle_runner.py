"""EAGLE-3 draft execution for async SSD: the conditioned prefill, the
self-conditioned chain, and the glue, fork and tree build.

Counterpart of ssd_tpu/engine/eagle_runner.py (eagle_prefill_program,
eagle_chain_program, eagle_tree_build_program, EagleDraftRunner), as eager
steps over the draft's one-layer paged cache:
- the conditioned prefill is one flat forward for the whole batch, so its
  attention is one launch of the flat prefill kernel
  (csrc/flat_prefill_attention.cu) where the JAX package dispatches one
  padded program per sequence;
- the chain and the glue take the paged kernel (csrc/paged_attention.cu;
  the glue at Q = 2K+1 with a per-sequence qeff of n_ext+K+1, its padding
  rows writing nothing), the tree steps the tree kernel
  (csrc/tree_attention.cu); over the int8 cache their int8 kernels.

EAGLE position shift: canonical token p sits at draft position p - 1 (the
first prompt token is never fed to the draft), so `base` here is
num_tokens - 2 where the plain draft uses num_tokens - 1. The glue of a step
is W = 2K+1 rows per sequence, [extend | recovery | spec | padding]: the
n_ext tokens the last verify accepted (conditioned on the target's taps
through fc, their draft KV rewritten), the recovery token (fc of the
recovery taps) and the K spec tokens (conditioned on the draft's own
prenorms from the chain or the tree cache).
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.engine.draft_runner import DraftRunner, SpecRequest, SpecResponse
from ssd_tpu_torch.engine.model_runner import KVCache, _store_rows, layer_of
from ssd_tpu_torch.models.eagle3 import (
    EagleArch, eagle_forward, eagle_logits, init_eagle_params, project_target_acts)
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops.sampler import sample
from ssd_tpu_torch.ops.spec_math import fan_index, get_forked_recovery_tokens
from ssd_tpu_torch.utils.native import slot_of


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, non_blocking=True)


def _paged_call(kv_cache, slots_t, rows_t, bt, ctx, qeff, q_len, arch, block_size, s8):
    """attn_call of one paged step: store the rows' KV, then paged attention
    of q_len queries per sequence."""
    scale = arch.head_dim ** -0.5

    def attn_call(li, q, k, v):
        kv_layer = layer_of(kv_cache, li)
        att.store_kv(kv_layer, k, v, slots_t, rows_t)
        B = bt.shape[0]
        o = att.paged_attention(q.reshape(B, q_len, arch.num_heads, arch.head_dim),
                                kv_layer, bt, ctx, qeff, block_size, scale, s8=s8)
        return o.reshape(B * q_len, arch.num_heads, arch.head_dim)

    return attn_call


def eagle_chain_step(
    params: dict,
    kv_cache: KVCache,              # the draft's one-layer cache, in place
    first_tokens: torch.Tensor,     # [B] recovery tokens
    recovery_acts: torch.Tensor,    # [B, n_taps*D_target]
    base_positions: np.ndarray,     # [B] num_tokens - 2
    block_tables: np.ndarray,       # [B, M]
    temperatures: torch.Tensor,     # [B]
    generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    arch: EagleArch,
    block_size: int,
    K: int,
    sampler_x: float | None,
    F: int,
    s8: bool = False,
):
    """K conditioned decodes (eagle_chain_program): step 0 is conditioned on
    fc(recovery taps), step i > 0 on step i-1's prenorm. Returns (tokens
    [B, K], logits [B, K, V], prenorms [B, K, D])."""
    dev = first_tokens.device
    B = block_tables.shape[0]
    bt = _upload(block_tables, dev)
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    cond = project_target_acts(params, recovery_acts)
    tok = first_tokens
    toks, logits_all, prenorms = [], [], []
    for i in range(K):
        pos = (base_positions + i).astype(np.int32)
        slots = slot_of(block_tables, pos, np.arange(B), block_size)
        attn_call = _paged_call(kv_cache, _upload(slots, dev), _store_rows(slots, dev),
                                bt, _upload(pos + 1, dev), ones, 1, arch, block_size, s8)
        prenorm = eagle_forward(params, tok, cond, _upload(pos, dev), attn_call, arch)
        logits = eagle_logits(params, prenorm, arch)
        tok = sample(logits, temperatures, generator, top_ps, top_ks,
                     sampler_x=sampler_x, fan_out=F, is_tree=True)
        cond = prenorm
        toks.append(tok)
        logits_all.append(logits)
        prenorms.append(prenorm)
    return (torch.stack(toks, dim=1), torch.stack(logits_all, dim=1),
            torch.stack(prenorms, dim=1))


def eagle_tree_build_step(
    params: dict,
    kv_cache: KVCache,              # the draft's one-layer cache, in place
    glue_tokens: np.ndarray,        # [B, W] [extend | rec | spec | pad], W = 2K+1
    fc_acts: torch.Tensor,          # [B, W, n_taps*D_target] (rows j <= n_ext)
    prev_acts: torch.Tensor,        # [B, K, D] the spec rows' prenorms
    n_ext: np.ndarray,              # [B] extend rows
    base_positions: np.ndarray,     # [B] num_tokens - 2
    block_tables: np.ndarray,       # [B, M]
    cache_hits: np.ndarray,         # [B] {0,1}
    temperatures: torch.Tensor,     # [B]
    generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    arch: EagleArch,
    block_size: int,
    K: int,
    fan_out_list: list[int],
    fan_out_list_miss: list[int],
    sampler_x: float | None,
    F: int,
    s8: bool = False,
):
    """The glue forward, the top-F fork per glue depth and K tree steps
    (eagle_tree_build_program). Draft cache geometry, with base the
    recovery token's draft position:
      [ trunk | glue base-n_ext .. base+K | tree step s row r at
        base + (K+1) + s*MQ + r ]
    Returns (fork tokens [B, MQ], spec tokens [B, MQ, K], spec logits
    [B*MQ, K, V], spec prenorms [B*MQ, K, D])."""
    dev = prev_acts.device
    B, W = glue_tokens.shape
    Kp1 = K + 1
    MQ = sum(fan_out_list)
    D = arch.hidden_size
    bt = _upload(block_tables, dev)

    # ---- glue: W rows per sequence, qeff = n_ext + K + 1 true rows ----
    qeff = (n_ext + Kp1).astype(np.int32)
    b_glue = np.repeat(np.arange(B), W)
    j = np.tile(np.arange(W), B)
    pos = ((base_positions - n_ext)[b_glue] + j).astype(np.int32)
    slots = np.where(j < qeff[b_glue], slot_of(block_tables, pos, b_glue, block_size), -1)
    slots = slots.astype(np.int32)
    fc_rows = np.flatnonzero(j <= n_ext[b_glue])                 # extend + rec
    spec_b = np.repeat(np.arange(B), K)
    spec_rows = spec_b * W + (n_ext[spec_b] + 1 + np.tile(np.arange(K), B))
    cond = torch.zeros(B * W, D, dtype=prev_acts.dtype, device=dev)
    fc_rows = _upload(fc_rows, dev)
    cond[fc_rows] = project_target_acts(
        params, fc_acts.reshape(B * W, -1)[fc_rows]).to(cond.dtype)
    cond[_upload(spec_rows, dev)] = prev_acts.reshape(B * K, D).to(cond.dtype)
    attn_call = _paged_call(kv_cache, _upload(slots, dev), _store_rows(slots, dev), bt,
                            _upload((base_positions + Kp1).astype(np.int32), dev),
                            _upload(qeff, dev), W, arch, block_size, s8)
    prenorm = eagle_forward(params, _upload(glue_tokens.reshape(-1), dev), cond,
                            _upload(pos, dev), attn_call, arch)
    # The recovery and spec rows, j = n_ext + t for t in 0..K.
    extract = (np.arange(B)[:, None] * W + n_ext[:, None]
               + np.arange(Kp1)[None, :]).reshape(-1)
    glue_prenorm = prenorm[_upload(extract, dev)].reshape(B, Kp1, D)
    glue_logits = eagle_logits(params, glue_prenorm.reshape(B * Kp1, D), arch
                               ).reshape(B, Kp1, -1)
    returned = _upload(glue_tokens.reshape(-1)[extract].reshape(B, Kp1), dev)

    # ---- fork ----
    fork = get_forked_recovery_tokens(glue_logits, _upload(cache_hits, dev), returned,
                                      fan_out_list, fan_out_list_miss)   # [B, MQ]
    fan_rows = np.where(cache_hits.astype(bool)[:, None],
                        fan_index(fan_out_list)[None, :],
                        fan_index(fan_out_list_miss)[None, :]).astype(np.int32)
    fan_t = _upload(fan_rows, dev)

    # ---- K tree steps over N = B*MQ rows, prenorm self-conditioning ----
    scale = arch.head_dim ** -0.5
    b_flat = np.repeat(np.arange(B), MQ)
    r_flat = np.tile(np.arange(MQ), B)
    base_n = base_positions[b_flat]
    fan_n = fan_rows.reshape(-1)
    idx_n = _upload(b_flat, dev)
    temps_n = temperatures[idx_n]
    tp_n = None if top_ps is None else top_ps[idx_n]
    tk_n = None if top_ks is None else top_ks[idx_n]
    tcond = glue_prenorm[idx_n, _upload(fan_n.astype(np.int64), dev)]
    tok = fork.reshape(-1)
    toks, logits_all, prenorms = [], [], []
    for s in range(K):
        slots_s = slot_of(block_tables, base_n + Kp1 + s * MQ + r_flat, b_flat, block_size)
        slots_t, rows_t = _upload(slots_s, dev), _store_rows(slots_s, dev)
        ctx = _upload((base_positions + Kp1 + (s + 1) * MQ).astype(np.int32), dev)

        def tree_call(li, q, k, v, s=s, slots_t=slots_t, rows_t=rows_t, ctx=ctx):
            kv_layer = layer_of(kv_cache, li)
            att.store_kv(kv_layer, k, v, slots_t, rows_t)
            o = att.tree_attention(q.reshape(B, MQ, arch.num_heads, arch.head_dim),
                                   kv_layer, bt, ctx, fan_t, s, K, block_size, scale,
                                   s8=s8)
            return o.reshape(B * MQ, arch.num_heads, arch.head_dim)

        rope = _upload((base_n + fan_n + 1 + s).astype(np.int32), dev)
        tcond = eagle_forward(params, tok, tcond, rope, tree_call, arch)
        logits = eagle_logits(params, tcond, arch)
        tok = sample(logits, temps_n, generator, tp_n, tk_n,
                     sampler_x=sampler_x, fan_out=F, is_tree=True)
        toks.append(tok)
        logits_all.append(logits)
        prenorms.append(tcond)
    spec_tokens = torch.stack(toks, dim=1).reshape(B, MQ, K)
    return (fork, spec_tokens, torch.stack(logits_all, dim=1),
            torch.stack(prenorms, dim=1))


class EagleDraftRunner(DraftRunner):
    """DraftRunner whose model is the EAGLE-3 one-layer conditioned head.
    Its tree cache also keeps each tree row's prenorms, which condition the
    spec rows of the next glue on a cache hit."""

    def __init__(self, config: Config, init_random: bool = False):
        if not config.jit_speculate:
            raise ValueError("EAGLE requires jit_speculate=True (cache misses "
                             "need draft activations)")
        super().__init__(config, init_random=init_random)

    def _make_arch(self):
        return EagleArch.from_model_config(
            self.hf_config, self.config.d_model_target, len(self.config.eagle_layers))

    def _make_params(self, init_random: bool) -> dict:
        if init_random:
            return init_eagle_params(self.arch, self.config.seed + 7, self.dtype,
                                     self.device)
        from ssd_tpu_torch.utils.loader import load_eagle_params

        return load_eagle_params(
            self.config.model, self.hf_config, self.arch.d_model_target,
            self.arch.num_eagle_layers, self.dtype, self.device,
            target_path=self.config.tokenizer_path)

    @torch.no_grad()
    def prefill_from_payload(self, input_id_lists: list[list[int]],
                             block_tables: np.ndarray, acts_list=None):
        """The conditioned draft prefill of the whole batch as one flat
        forward: sequence i feeds tokens ids[1:] at draft positions
        0..n-2, conditioned on the target's taps of ids[:-1] (token j+1 on
        the taps of token j)."""
        if acts_list is None:
            raise ValueError("the EAGLE draft prefill needs the target's taps")
        rows, acts = [], []
        for i, ids in enumerate(input_id_lists):
            if len(ids) > 1:
                rows.append((ids[1:], block_tables[i], 0, len(ids) - 1))
                acts.append(acts_list[i][:len(ids) - 1])
        if not rows:
            return
        inp = self._flat_inputs(rows)
        cond = project_target_acts(self.params, torch.cat(acts))
        scale = self.arch.head_dim ** -0.5

        def attn_call(li, q, k, v):
            kv_layer = layer_of(self.kv_cache, li)
            att.store_kv(kv_layer, k, v, inp["slot_map"], inp["store_rows"])
            return att.flat_prefill_attention(q, kv_layer, inp["flat_pages"],
                                              inp["row_lo"], inp["row_hi"],
                                              self.block_size, scale)

        eagle_forward(self.params, inp["input_ids"], cond, inp["positions"],
                      attn_call, self.arch)

    def _jit_chain(self, req: SpecRequest):
        tp, tk = self._warp_args(req.top_ps, req.top_ks)
        tokens, logits, prenorms = eagle_chain_step(
            self.params, self.kv_cache, self._tensor(req.cache_keys[:, 2].copy()),
            req.recovery_acts, (req.num_tokens - 2).astype(np.int64),
            req.block_tables, self._tensor(req.temperatures.astype(np.float32)),
            self.generator, tp, tk, arch=self.arch, block_size=self.block_size,
            K=self.K, sampler_x=self.sampler_x, F=self.F, s8=self.s8)
        return tokens.cpu().numpy(), logits, prenorms

    @torch.no_grad()
    def build_tree(self, req: SpecRequest, resp: SpecResponse):
        B = req.cache_keys.shape[0]
        K = self.K
        W = 2 * K + 1
        n_ext = np.zeros(B, dtype=np.int64)
        if req.extend_counts is not None:
            n_ext[:] = req.extend_counts
        glue_tokens = np.zeros((B, W), dtype=np.int64)
        for b in range(B):
            ne = int(n_ext[b])
            glue_tokens[b, :ne] = req.extend_token_ids[b, :ne]
            glue_tokens[b, ne] = req.cache_keys[b, 2]
            glue_tokens[b, ne + 1:ne + 1 + K] = resp.tokens[b]
        # Glue row j takes extend row j's taps (j < n_ext), the recovery
        # taps (j = n_ext) or zeros: one gather on the device.
        A = req.recovery_acts.shape[-1]
        src = torch.cat([req.extend_acts.reshape(B * K, A), req.recovery_acts,
                         req.recovery_acts.new_zeros(1, A)])
        j, b = np.arange(W)[None, :], np.arange(B)[:, None]
        src_row = np.where(j < n_ext[:, None], b * K + np.minimum(j, K - 1),
                           np.where(j == n_ext[:, None], B * K + b, B * K + B))
        fc_acts = src[self._tensor(src_row)]
        tp, tk = self._warp_args(req.top_ps, req.top_ks)
        fork, spec, spec_logits, spec_acts = eagle_tree_build_step(
            self.params, self.kv_cache, glue_tokens, fc_acts, resp.activations, n_ext,
            (req.num_tokens - 2).astype(np.int64), req.block_tables, resp.cache_hits,
            self._tensor(req.temperatures.astype(np.float32)), self.generator, tp, tk,
            arch=self.arch, block_size=self.block_size, K=K,
            fan_out_list=self.fan_out_list, fan_out_list_miss=self.fan_out_list_miss,
            sampler_x=self.sampler_x, F=self.F, s8=self.s8)
        self.populate_tree_cache(req.cache_keys[:, 0], resp.cache_hits,
                                 fork.cpu().numpy(), spec.cpu().numpy(), spec_logits)
        self.tree_cache_acts = spec_acts
