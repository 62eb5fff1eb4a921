"""EAGLE-3 draft execution: the conditioned prefill, the self-conditioned
chain, and the glue, fork and tree build of async SSD; the sync runner of
the fused superstep.

Counterpart of ssd_tpu/engine/eagle_runner.py (eagle_prefill_program,
eagle_chain_program, eagle_tree_build_program, EagleRunnerMixin,
EagleDraftRunner, EagleModelRunner), over the draft's one-layer paged cache:
- the conditioned prefill is one flat forward for the whole batch, so its
  attention is one launch of the flat prefill kernel
  (csrc/flat_prefill_attention.cu) where the JAX package dispatches one
  padded program per sequence;
- the chain and the glue take the paged kernel (csrc/paged_attention.cu;
  the glue at Q = 2K+1 with a per-sequence qeff of n_ext+K+1, its padding
  rows writing nothing), the tree steps the tree kernel
  (csrc/tree_attention.cu); over the int8 cache their int8 kernels;
- the chain and the tree build are fixed-shape device steps (one CUDA graph
  per batch bucket, engine/graphs.py): positions, slots, contexts, the
  glue's conditioning rows and the rows it extracts are computed on the
  device from n_ext and the bases, and nothing is read back. A ghost row
  (table of -1, base 0, hits 0, n_ext 0) writes nothing.

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

from functools import partial

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.engine.draft_runner import DraftRunner, SpecRequest, SpecResponse
from ssd_tpu_torch.engine.model_runner import (
    KVCache, ModelRunner, device_slot_of, layer_of, next_pow2)
from ssd_tpu_torch.models.eagle3 import (
    EagleArch, compute_dtype, eagle_forward, eagle_logits, init_eagle_params,
    project_target_acts)
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops.sampler import sample
from ssd_tpu_torch.ops.spec_math import FanOut, get_forked_recovery_tokens
from ssd_tpu_torch.parallel.mesh import Sharding, shard_params
from ssd_tpu_torch.utils.quant import quantize_eagle_params


def _attend(fn, q, kv_layer, *args, **kwargs):
    """fn(q, kv_layer, ...) with q in the dtype of an fp cache: an int8 head
    computes in bf16 (models/eagle3.py::compute_dtype) over the engine's
    cache, fp32 in an fp32 engine, and the fp kernels take q in the cache's
    dtype. bf16 -> fp32 is exact, and the output returns to q's dtype, as
    the plain version computes it (fp32 arithmetic, the output in q's
    dtype)."""
    if isinstance(kv_layer, torch.Tensor) and kv_layer.dtype != q.dtype:
        return fn(q.to(kv_layer.dtype), kv_layer, *args, **kwargs).to(q.dtype)
    return fn(q, kv_layer, *args, **kwargs)


def _paged_call(kv_cache, slots, bt, ctx, qeff, q_len, arch, block_size, s8):
    """attn_call of one paged step: store the rows' KV, then paged attention
    of q_len queries per sequence."""
    scale = arch.head_dim ** -0.5

    def attn_call(li, q, k, v):
        kv_layer = layer_of(kv_cache, li)
        att.store_kv(kv_layer, k, v, slots)
        B = bt.shape[0]
        o = _attend(att.paged_attention,
                    q.reshape(B, q_len, arch.num_heads, arch.head_dim),
                    kv_layer, bt, ctx, qeff, block_size, scale, s8=s8)
        return o.reshape(B * q_len, arch.num_heads, arch.head_dim)

    return attn_call


def eagle_chain_step(
    params: dict,
    kv_cache: KVCache,              # the draft's one-layer cache, in place
    first_tokens: torch.Tensor,     # [B] recovery tokens
    recovery_acts: torch.Tensor,    # [B, n_taps*D_target]
    base_positions: torch.Tensor,   # [B] draft position of first_tokens
    block_tables: torch.Tensor,     # [B, M]
    temperatures: torch.Tensor,     # [B]
    generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    arch: EagleArch,
    block_size: int,
    K: int,
    extra_write: bool = False,
    sampler_x: float | None = None,
    fan_out: int = 3,
    tree_sampling: bool = True,
    s8: bool = False,
    greedy: bool = False,
):
    """K conditioned decodes (eagle_chain_program): step 0 is conditioned on
    fc(recovery taps), step i > 0 on step i-1's prenorm; step i writes its
    token's KV at base + i. With extra_write a (K+1)-th decode writes the
    K-th token's KV (the fused sync superstep's chain; the async miss chain
    leaves it to the glue). tree_sampling samples as the async draft does
    (sampler_x, fan_out). Returns (tokens [B, K], logits [B, K, V],
    prenorms [B, K, D])."""
    B = block_tables.shape[0]
    dev = block_tables.device
    rows = torch.arange(B, device=dev)
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    base = base_positions.long()
    cond = project_target_acts(params, recovery_acts)
    tok = first_tokens.long()
    toks, logits_all, prenorms = [], [], []
    for i in range(K + 1 if extra_write else K):
        pos = base + i
        attn_call = _paged_call(kv_cache, device_slot_of(block_tables, pos, rows, block_size),
                                block_tables, (pos + 1).int(), ones, 1, arch, block_size, s8)
        prenorm = eagle_forward(params, tok, cond, pos.int(), attn_call, arch)
        logits = eagle_logits(params, prenorm, arch)
        tok = sample(logits, temperatures, generator, top_ps, top_ks, sampler_x=sampler_x,
                     fan_out=fan_out, is_tree=tree_sampling, greedy=greedy)
        cond = prenorm
        toks.append(tok)
        logits_all.append(logits)
        prenorms.append(prenorm)
    return (torch.stack(toks[:K], dim=1), torch.stack(logits_all[:K], dim=1),
            torch.stack(prenorms[:K], dim=1))


def eagle_tree_build_step(
    params: dict,
    kv_cache: KVCache,              # the draft's one-layer cache, in place
    glue_tokens: torch.Tensor,      # [B, W] [extend | rec | spec | pad], W = 2K+1
    recovery_acts: torch.Tensor,    # [B, A] the recovery token's taps
    extend_acts: torch.Tensor,      # [B, K, A] the extend rows' taps (rows < n_ext)
    prev_acts: torch.Tensor,        # [B, K, D] the spec rows' prenorms
    n_ext: torch.Tensor,            # [B] extend rows
    base_positions: torch.Tensor,   # [B] num_tokens - 2
    block_tables: torch.Tensor,     # [B, M]
    cache_hits: torch.Tensor,       # [B] {0,1}
    temperatures: torch.Tensor,     # [B]
    generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    arch: EagleArch,
    block_size: int,
    K: int,
    fan: FanOut,
    sampler_x: float | None,
    F: int,
    s8: bool = False,
    greedy: bool = False,
):
    """The glue forward, the top-F fork per glue depth and K tree steps
    (eagle_tree_build_program). Draft cache geometry, with base the
    recovery token's draft position:
      [ trunk | glue base-n_ext .. base+K | tree step s row r at
        base + (K+1) + s*MQ + r ]
    Glue row j of sequence b is conditioned on fc of extend_acts[b, j]
    (j < n_ext) or of recovery_acts[b] (j = n_ext), and on
    prev_acts[b, j - n_ext - 1] for the spec rows. All B*W rows are
    projected through fc and selected on the mask j <= n_ext, so the step's
    shapes never depend on the data. Returns (tree tokens [B, MQ, K+1]: each
    tree row's fork token, then its K spec tokens; spec logits
    [B*MQ, K, V] and spec prenorms [B*MQ, K, D], row b*MQ + r for tree row
    r of sequence b)."""
    dev = block_tables.device
    B, W = glue_tokens.shape
    Kp1 = K + 1
    MQ = fan.MQ
    D = arch.hidden_size
    A = recovery_acts.shape[-1]
    cdt = compute_dtype(params)
    base = base_positions.long()
    ne = n_ext.long()[:, None]                                        # [B, 1]
    j = torch.arange(W, device=dev)[None, :]                          # [1, W]
    b = torch.arange(B, device=dev)[:, None]                          # [B, 1]

    # ---- glue conditioning: fc rows (extend, recovery), spec rows ----
    fc_src = torch.cat([extend_acts.reshape(B * K, A), recovery_acts,
                        recovery_acts.new_zeros(1, A)])
    fc_row = torch.where(j < ne, b * K + j.clamp(max=K - 1),
                         torch.where(j == ne, B * K + b, B * K + B))
    t = j - ne - 1                                                    # spec index
    prev_src = torch.cat([prev_acts.reshape(B * K, D).to(cdt),
                          prev_acts.new_zeros(1, D, dtype=cdt)])
    prev_row = torch.where((t >= 0) & (t < K), b * K + t.clamp(0, K - 1), B * K)
    cond = torch.where((j <= ne).reshape(-1, 1),
                       project_target_acts(params, fc_src[fc_row.reshape(-1)]).to(cdt),
                       prev_src[prev_row.reshape(-1)])

    # ---- glue: W rows per sequence, qeff = n_ext + K + 1 true rows ----
    qeff = ne[:, 0] + Kp1
    pos = (base[:, None] - ne + j).reshape(-1)
    b_glue = b.expand(B, W).reshape(-1)
    slots = torch.where((j < qeff[:, None]).reshape(-1),
                        device_slot_of(block_tables, pos, b_glue, block_size), -1).int()
    attn_call = _paged_call(kv_cache, slots, block_tables, (base + Kp1).int(), qeff.int(), W,
                            arch, block_size, s8)
    prenorm = eagle_forward(params, glue_tokens.reshape(-1), cond, pos.int(), attn_call, arch)
    # The recovery and spec rows, j = n_ext + t for t in 0..K.
    extract = (b * W + ne + torch.arange(Kp1, device=dev)[None, :]).reshape(-1)
    glue_prenorm = prenorm[extract].reshape(B, Kp1, D)
    glue_logits = eagle_logits(params, glue_prenorm.reshape(B * Kp1, D), arch
                               ).reshape(B, Kp1, -1)
    returned = glue_tokens.reshape(-1)[extract].reshape(B, Kp1)

    # ---- fork ----
    fork = get_forked_recovery_tokens(glue_logits, cache_hits, returned, fan)   # [B, MQ]
    fan_rows = fan.rows(cache_hits)                                            # [B, MQ]

    # ---- K tree steps over N = B*MQ rows, prenorm self-conditioning ----
    scale = arch.head_dim ** -0.5
    n_flat = torch.arange(B * MQ, device=dev)
    b_flat, r_flat = n_flat // MQ, n_flat % MQ
    base_n = base[b_flat]
    fan_n = fan_rows.reshape(-1).long()
    temps_n = temperatures[b_flat]
    tp_n = None if top_ps is None else top_ps[b_flat]
    tk_n = None if top_ks is None else top_ks[b_flat]
    tcond = glue_prenorm[b_flat, fan_n]
    tok = fork.reshape(-1)
    toks, logits_all, prenorms = [tok], [], []
    for s in range(K):
        slots_s = device_slot_of(block_tables, base_n + Kp1 + s * MQ + r_flat, b_flat,
                                 block_size)
        ctx = (base + Kp1 + (s + 1) * MQ).int()

        def tree_call(li, q, k, v, s=s, slots_s=slots_s, ctx=ctx):
            kv_layer = layer_of(kv_cache, li)
            att.store_kv(kv_layer, k, v, slots_s)
            o = _attend(att.tree_attention, q.reshape(B, MQ, arch.num_heads, arch.head_dim),
                        kv_layer, block_tables, ctx, fan_rows, s, K, block_size, scale, s8=s8)
            return o.reshape(B * MQ, arch.num_heads, arch.head_dim)

        tcond = eagle_forward(params, tok, tcond, (base_n + fan_n + 1 + s).int(), tree_call,
                              arch)
        logits = eagle_logits(params, tcond, arch)
        tok = sample(logits, temps_n, generator, tp_n, tk_n,
                     sampler_x=sampler_x, fan_out=F, is_tree=True, greedy=greedy)
        toks.append(tok)
        logits_all.append(logits)
        prenorms.append(tcond)
    tree_tokens = torch.stack(toks, dim=1).reshape(B, MQ, Kp1)
    return tree_tokens, torch.stack(logits_all, dim=1), torch.stack(prenorms, dim=1)


class EagleRunnerMixin:
    """The EAGLE-3 head's construction and its conditioned prefill, shared by
    the async draft's runner and the fused superstep's sync runner. Under
    tensor parallelism (a Comm, the fused superstep's head on the target's
    ranks) the runner holds its rank's shard (parallel/mesh.py: the head
    made or loaded whole, quantized whole under quantization="int8", then
    sliced), its EagleArch the rank's heads and MLP width, and its KV pool
    the rank's k/v heads."""

    def _make_arch(self):
        arch = EagleArch.from_model_config(
            self.hf_config, self.config.d_model_target, len(self.config.eagle_layers))
        if self.comm is None:
            return arch
        self.sharding = Sharding(arch, self.comm.rank, self.comm.size)
        return self.sharding.rank_arch(self.comm)

    def _make_params(self, init_random: bool) -> dict:
        if init_random:
            arch = self.sharding.arch if self.sharding is not None else self.arch
            params = init_eagle_params(arch, self.config.seed + 7, self.dtype, self.device)
        else:
            from ssd_tpu_torch.utils.loader import load_eagle_params

            params = load_eagle_params(
                self.config.model, self.hf_config, self.arch.d_model_target,
                self.arch.num_eagle_layers, self.dtype, self.device,
                target_path=self.config.tokenizer_path)
        if self.config.quantization == "int8":
            params = quantize_eagle_params(params)
        if self.sharding is not None:
            params = shard_params(params, self.sharding)
        return params

    def _save_debug_inputs(self, input_id_lists, acts_list):
        """Config.debug_mode: the first conditioned prefill's inputs, once,
        to debug_outputs/draft_prefill_inputs.npz under the working
        directory (ssd_tpu/engine/eagle_runner.py's capture, its keys and
        dtypes); under tensor parallelism from rank 0 only."""
        self._debug_saved = True
        if self.comm is not None and self.comm.rank != 0:
            return
        import os

        os.makedirs("debug_outputs", exist_ok=True)
        np.savez("debug_outputs/draft_prefill_inputs.npz",
                 input_ids=np.asarray(input_id_lists[0], dtype=np.int64),
                 target_hidden_states=acts_list[0].float().cpu().numpy(),
                 d_model_target=self.arch.d_model_target,
                 eagle_layers=np.asarray(self.config.eagle_layers))
        print("[DEBUG] saved debug_outputs/draft_prefill_inputs.npz", flush=True)

    @torch.no_grad()
    def prefill_from_payload(self, input_id_lists: list[list[int]],
                             block_tables: np.ndarray, acts_list=None):
        """The conditioned draft prefill of the whole batch as one flat
        forward: sequence i feeds tokens ids[1:] at draft positions
        0..n-2, conditioned on the target's taps of ids[:-1] (token j+1 on
        the taps of token j)."""
        if acts_list is None:
            raise ValueError("the EAGLE draft prefill needs the target's taps")
        if self.config.debug_mode and not getattr(self, "_debug_saved", False):
            self._save_debug_inputs(input_id_lists, acts_list)
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
            att.store_kv(kv_layer, k, v, inp["slot_map"])
            return _attend(att.flat_prefill_attention, q, kv_layer, inp["flat_pages"],
                           inp["row_lo"], inp["row_hi"], self.block_size, scale)

        eagle_forward(self.params, inp["input_ids"], cond, inp["positions"],
                      attn_call, self.arch)


class EagleModelRunner(EagleRunnerMixin, ModelRunner):
    """The EAGLE-3 head of the fused sync superstep (Config.use_eagle with
    spec_rounds > 1): its weights, its paged KV (sized with the target's,
    engine/model_runner.py::_decide_num_blocks) and the conditioned prefill,
    with no tree cache and no thread; engine/fused_sd.py::eagle_sd_superstep
    runs its chain. Under tensor parallelism (comm) it is the rank's shard
    of the head, on the target's ranks, as ssd_tpu/engine/llm_engine.py
    puts the head on the target's mesh."""

    def __init__(self, config: Config, init_random: bool = False, comm=None):
        super().__init__(config, init_random=init_random, is_draft=True, comm=comm)


class EagleDraftRunner(EagleRunnerMixin, DraftRunner):
    """DraftRunner whose model is the EAGLE-3 one-layer conditioned head.
    Its tree cache also keeps each tree row's prenorms, which condition the
    spec rows of the next glue on a cache hit: under a graph the graph's own
    buffer, kept as a view, which service() gathers from before the next
    replay writes it (as the spec logits)."""

    def __init__(self, config: Config, init_random: bool = False):
        if not config.jit_speculate:
            raise ValueError("EAGLE requires jit_speculate=True (cache misses "
                             "need draft activations)")
        super().__init__(config, init_random=init_random)

    def eagle_chain_call(self, B_pad: int, first=(), base=(), bt=None, temps=(),
                         top_ps=None, top_ks=None, recovery_acts=None):
        """The miss chain (eagle_chain_step, tree-sampled) as a step call
        (model_runner.py: key, fn, inputs, ghost) whose row b starts at token
        first[b] at draft position base[b], conditioned on recovery_acts[b];
        no rows: ghost rows only (token 0 at position 0, table -1, taps 0)."""
        A = self.arch.act_dim
        temps = np.asarray(temps, np.float32)
        greedy = not (temps > 0).any()

        def inputs(first, base, bt, temps, top_ps, top_ks, rec):
            return {**self._rows(B_pad, first_tokens=(np.asarray(first, np.int64), 0),
                                 base_positions=(np.asarray(base, np.int32), 0),
                                 block_tables=(bt, -1)),
                    **self._sampling_inputs(B_pad, temps, top_ps, top_ks),
                    "recovery_acts": self._device_rows(B_pad, rec, (A,), torch.float32)}

        no_rows = np.zeros((0, self.max_blocks), np.int32)
        fn = partial(eagle_chain_step, self.params, self.kv_cache, generator=self.generator,
                     arch=self.arch, block_size=self.block_size, K=self.K,
                     sampler_x=self.sampler_x, fan_out=self.F, s8=self.s8, greedy=greedy)
        return (("eagle_chain", B_pad, self.K, greedy), fn,
                inputs(first, base, no_rows if bt is None else bt, temps, top_ps, top_ks,
                       recovery_acts),
                lambda: inputs((), (), no_rows, temps[:0], None, None, None))

    def tree_build_call(self, B_pad: int, glue=None, recovery_acts=None, extend_acts=None,
                        prev_acts=None, n_ext=(), base=(), bt=None, hits=(), temps=(),
                        top_ps=None, top_ks=None):
        """The tree build (eagle_tree_build_step) as a step call over rows
        whose glue is glue[b] [2K+1] with n_ext[b] extend rows from draft
        position base[b] - n_ext[b]; no rows: ghost rows only (glue 0,
        n_ext 0, base 0, table -1, hits 0, taps and prenorms 0)."""
        K, W, A, D = self.K, 2 * self.K + 1, self.arch.act_dim, self.arch.hidden_size
        temps = np.asarray(temps, np.float32)
        greedy = not (temps > 0).any()

        def inputs(glue, n_ext, base, bt, hits, temps, top_ps, top_ks, rec, ext, prev):
            return {**self._rows(B_pad, glue_tokens=(np.asarray(glue, np.int64).reshape(-1, W), 0),
                                 n_ext=(np.asarray(n_ext, np.int32), 0),
                                 base_positions=(np.asarray(base, np.int32), 0),
                                 block_tables=(bt, -1),
                                 cache_hits=(np.asarray(hits, np.int32), 0)),
                    **self._sampling_inputs(B_pad, temps, top_ps, top_ks),
                    "recovery_acts": self._device_rows(B_pad, rec, (A,), torch.float32),
                    "extend_acts": self._device_rows(B_pad, ext, (K, A), torch.float32),
                    "prev_acts": self._device_rows(B_pad, prev, (K, D), self.dtype)}

        no_rows = np.zeros((0, self.max_blocks), np.int32)
        fn = partial(eagle_tree_build_step, self.params, self.kv_cache,
                     generator=self.generator, arch=self.arch, block_size=self.block_size,
                     K=K, fan=self.fan, sampler_x=self.sampler_x, F=self.F, s8=self.s8,
                     greedy=greedy)
        return (("eagle_tree", B_pad, greedy), fn,
                inputs(() if glue is None else glue, n_ext, base,
                       no_rows if bt is None else bt, hits, temps, top_ps, top_ks,
                       recovery_acts, extend_acts, prev_acts),
                lambda: inputs((), (), (), no_rows, (), temps[:0], None, None,
                               None, None, None))

    def capture(self, batch_pads: list[int]):
        """Capture the head's graphs per batch bucket: the tree build and
        the miss chain (greedy forms; a sampled form is captured on its
        first use)."""
        for B_pad in batch_pads:
            self.capture_step(*self.tree_build_call(B_pad))
            self.capture_step(*self.eagle_chain_call(B_pad))

    def _jit_chain(self, req: SpecRequest):
        B = req.cache_keys.shape[0]
        tokens, logits, prenorms = self.run_step(*self.eagle_chain_call(
            next_pow2(B), req.cache_keys[:, 2], req.num_tokens - 2, req.block_tables,
            req.temperatures, req.top_ps, req.top_ks, req.recovery_acts))
        logits = logits[:B]
        if self.graphs is not None:
            # The verify reads the logits after the tree build's replay.
            logits = logits.clone()
        # The prenorms are read by the tree build's input copy, which the
        # draft's stream runs before that replay.
        return tokens[:B].cpu().numpy(), logits, prenorms[:B]

    @torch.no_grad()
    def build_tree(self, req: SpecRequest, resp: SpecResponse):
        B = req.cache_keys.shape[0]
        K = self.K
        n_ext = np.zeros(B, dtype=np.int64)
        if req.extend_counts is not None:
            n_ext[:] = req.extend_counts
        glue = np.zeros((B, 2 * K + 1), dtype=np.int64)
        for b in range(B):
            ne = int(n_ext[b])
            glue[b, :ne] = req.extend_token_ids[b, :ne]
            glue[b, ne] = req.cache_keys[b, 2]
            glue[b, ne + 1:ne + 1 + K] = resp.tokens[b]
        tree, spec_logits, spec_acts = self.run_step(*self.tree_build_call(
            next_pow2(B), glue, req.recovery_acts, req.extend_acts, resp.activations, n_ext,
            req.num_tokens - 2, req.block_tables, resp.cache_hits, req.temperatures,
            req.top_ps, req.top_ks))
        tokens = tree[:B].cpu().numpy()       # one readback: fork and spec
        self.populate_tree_cache(req.cache_keys[:, 0], resp.cache_hits,
                                 tokens[..., 0], tokens[..., 1:], spec_logits)
        self.tree_cache_acts = spec_acts
