"""Fused asynchronous speculative decoding: the exchange and the superstep.

Counterpart of ssd_tpu/engine/async_fused.py. The draft is a DraftRunner
inline beside the target, with no thread (ssd_tpu/engine/llm_engine.py
makes it so for async_fused):

1. The exchange (`exchange_step`, `AsyncExchangeSpecDecodeStep`;
   async_fused with spec_rounds=1). Per decode step: the host's tree-cache
   service (DraftRunner.service, with its jit-speculate miss chain), then
   one step that runs the target's verify (the Q = K+1 forward and
   verify()) and the draft's tree build for the next step's keys, whose
   glue is the verify's own speculation; then one packed readback
   (accept_until, recovery, the tree's fork and spec tokens) and the tree
   cache's population.
2. The superstep (`async_ssd_superstep`, `FusedAsyncSpecDecodeStep`;
   spec_rounds = R > 1): a prime chain (the miss chain's K tree-sampled
   tokens, without the extra write), then R rounds of [tree build ->
   verify -> match] with the tree cache inside the step: the match of
   (accepted_len - 1, recovery) against the tree's (fan_idx, fork) rows is
   an argmax over the MQ rows, and the served row's K tokens and [K, V] q
   logits feed the next round. A miss round serves row 0's stale tokens
   with hits 0, which masks ratio acceptance, so greedy outputs stay exact.
   The round ladder, EOS truncation and metrics are FusedSpecDecodeStep's.

Verify(r) and the tree build read the same speculation and write disjoint
state: the target's cache and generator against the draft's. With a side
stream (`_branch`, a card engine under graphs) the tree build runs there,
forked from and joined to the main stream, so a replay of the step's CUDA
graph (engine/graphs.py: one per (B_pad[, R], greedy)) overlaps the two:
the graph form of the unfused path's two threads. Eager runs (the CPU,
enforce_eager) run them one after the other. Greedy outputs are token-exact
against the unfused path.

Not ported: the `*_packed` variants (a TPU upload workaround).
"""

from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

from ssd_tpu_torch.engine.draft_runner import DraftRunner, spec_request, tree_build_step
from ssd_tpu_torch.engine.fused_sd import _collect_rounds, _greedy, _superstep_rows
from ssd_tpu_torch.engine.model_runner import (
    ModelRunner, chain_decode_step, decode_forward, next_pow2)
from ssd_tpu_torch.engine.step import FusedSpecDecodeStep
from ssd_tpu_torch.models.transformer import Arch
from ssd_tpu_torch.ops.spec_math import FanOut
from ssd_tpu_torch.ops.verify import all_greedy, build_suffixes, verify


def _branch(side: torch.cuda.Stream | None, first, second):
    """(first(), second()): first on the side stream, forked from the
    current stream and joined back to it after second, which runs on the
    current stream, so the two overlap; one after the other where side is
    None. Neither may free what the other reads before the join: both read
    only their callers' tensors."""
    if side is None:
        return first(), second()
    main = torch.cuda.current_stream(side.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        a = first()
    b = second()
    main.wait_stream(side)
    return a, b


def exchange_step(
    t_params, target_kv,
    d_params, draft_kv,
    input_ids: torch.Tensor,      # [B*(K+1)] [recovery | spec] per sequence
    positions: torch.Tensor,      # [B*(K+1)]
    block_tables: torch.Tensor,   # [B, M] target tables
    context_lens: torch.Tensor,   # [B]
    logits_q: torch.Tensor,       # [B, K, V] the served speculation's q logits
    temps_t: torch.Tensor,        # [B]
    temps_q: torch.Tensor,        # [B] draft temperatures
    cache_hits: torch.Tensor,     # [B] {0,1}
    bt_draft: torch.Tensor,       # [B, M] draft tables
    t_generator: torch.Generator | None,
    d_generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    t_arch: Arch,
    d_arch: Arch,
    block_size: int,
    K: int,
    fan: FanOut,
    sampler_x: float | None,
    F: int,
    jit_speculate: bool = False,
    t_s8: bool = False,
    d_s8: bool = False,
    greedy: bool = False,
    greedy_tree: bool = False,
    side: torch.cuda.Stream | None = None,
):
    """The target's verify of the served speculation and the draft's tree
    build over it, for the next step's keys (async_exchange_packed). The
    tree's glue is the speculation and its base the recovery token's
    position. `greedy` is verify()'s flag (ops/verify.py::all_greedy),
    `greedy_tree` the tree sampler's (every draft temperature 0).

    Returns (packed [B, 2 + MQ*(K+1)] int64: accept_until, recovery, then
    each tree row's fork and K spec tokens; spec logits [B*MQ, K, V])."""
    B = block_tables.shape[0]
    Kp1 = K + 1
    spec = input_ids.reshape(B, Kp1)

    def tree():
        return tree_build_step(
            d_params, draft_kv, spec, positions.reshape(B, Kp1)[:, 0], bt_draft, cache_hits,
            temps_q, d_generator, top_ps, top_ks, arch=d_arch, block_size=block_size, K=K,
            fan=fan, sampler_x=sampler_x, F=F, s8=d_s8, greedy=greedy_tree)

    def target():
        logits_p = decode_forward(t_params, target_kv, input_ids, positions, block_tables,
                                  context_lens, arch=t_arch, block_size=block_size,
                                  q_len=Kp1, s8=t_s8)
        return verify(logits_p.reshape(B, Kp1, -1), logits_q, spec, temps_t, temps_q,
                      cache_hits, t_generator, jit_speculate=jit_speculate,
                      sampler_x=sampler_x,
                      async_fan_out=F if sampler_x is not None else None,
                      top_p=top_ps, top_k=top_ks, greedy=greedy)

    (tree_tokens, spec_logits, _), (acc, rec) = _branch(side, tree, target)
    packed = torch.cat([acc[:, None], rec[:, None], tree_tokens.reshape(B, -1)], dim=1)
    return packed, spec_logits


def async_ssd_superstep(
    t_params, target_kv,
    d_params, draft_kv,
    rec0: torch.Tensor,        # [B] current recovery token per sequence
    n0: torch.Tensor,          # [B] committed tokens (recovery not yet appended)
    bt_target: torch.Tensor,   # [B, M]
    bt_draft: torch.Tensor,    # [B, M]
    temps_t: torch.Tensor,     # [B]
    temps_d: torch.Tensor,     # [B]
    t_generator: torch.Generator | None,
    d_generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    t_arch: Arch,
    d_arch: Arch,
    block_size: int,
    K: int,
    R: int,
    fan: FanOut,
    sampler_x: float | None,
    F: int,
    jit_speculate: bool = False,
    t_s8: bool = False,
    d_s8: bool = False,
    greedy: bool = False,
    side: torch.cuda.Stream | None = None,
):
    """R rounds of the async exchange with the speculation-tree cache inside
    the step (see the module's notes). Returns rounds [R, B, K+4] int64: per
    round and row the speculation [K+1], accept_until, the recovery token
    and the cache hit the round's verify saw; round r of sequence b
    contributed rounds[r, b, :accept_until + 1]."""
    B = rec0.shape[0]
    Kp1 = K + 1
    dev = rec0.device
    b_idx = torch.arange(B, device=dev)
    ar = torch.arange(Kp1, device=dev)
    rec, n = rec0.long(), n0.long()
    # Prime: the first round's K tokens and q logits from a real chain.
    # Without the extra write: the round's glue rewrites all K+1 slots.
    spec_toks, logits_q = chain_decode_step(
        d_params, draft_kv, rec, n, bt_draft, n + 1, temps_d, d_generator, top_ps, top_ks,
        arch=d_arch, block_size=block_size, K=K, extra_write=False, sampler_x=sampler_x,
        fan_out=F, tree_sampling=True, s8=d_s8, greedy=greedy)
    hit = torch.ones(B, dtype=torch.int64, device=dev)   # the prime's tokens are samples of q
    rounds = []
    for _ in range(R):
        spec = torch.cat([rec[:, None], spec_toks], dim=1)           # [B, K+1]

        def tree():
            return tree_build_step(
                d_params, draft_kv, spec, n, bt_draft, hit, temps_d, d_generator, top_ps,
                top_ks, arch=d_arch, block_size=block_size, K=K, fan=fan,
                sampler_x=sampler_x, F=F, s8=d_s8, greedy=greedy)

        def target():
            logits_p = decode_forward(
                t_params, target_kv, spec.reshape(-1), (n[:, None] + ar).reshape(-1),
                bt_target, n + Kp1, arch=t_arch, block_size=block_size, q_len=Kp1, s8=t_s8)
            return verify(logits_p.reshape(B, Kp1, -1), logits_q, spec, temps_t, temps_d,
                          hit, t_generator, jit_speculate=jit_speculate,
                          sampler_x=sampler_x,
                          async_fan_out=F if sampler_x is not None else None,
                          top_p=top_ps, top_k=top_ks, greedy=greedy)

        (tree_tokens, spec_logits, _), (acc, rec_next) = _branch(side, tree, target)
        # The in-step cache service: (accepted_len - 1, recovery) against
        # the tree rows' (fan_idx, fork token) keys.
        match = (fan.rows(hit) == acc[:, None]) & (tree_tokens[:, :, 0] == rec_next[:, None])
        idx = match.int().argmax(dim=1)
        rounds.append(torch.cat([spec, acc[:, None], rec_next[:, None], hit[:, None]], dim=1))
        spec_toks = tree_tokens[b_idx, idx, 1:]
        logits_q = spec_logits.reshape(B, fan.MQ, K, -1)[b_idx, idx]
        hit = match.any(dim=1).long()
        rec, n = rec_next, n + acc + 1
    return torch.stack(rounds)


def _side(target_runner: ModelRunner, branch: bool) -> torch.cuda.Stream | None:
    """The tree build's stream: the graphs' side stream when the step
    branches under graphs, else none (eager steps run serially)."""
    graphs = target_runner.graphs
    return graphs.side if branch and graphs is not None else None


def exchange_call(t: ModelRunner, d: DraftRunner, B_pad: int, seqs=(), req=None, resp=None,
                  branch: bool = True):
    """The exchange as a step call (model_runner.py: key, fn, inputs,
    ghost) over seqs, which carry the served speculation as their last K+1
    tokens, with the service's request and response; no seqs: ghost rows
    only (the verify's ghosts, hits 0, draft tables of -1, q logits 0).
    branch=False captures the serial form (the card test's reference)."""
    K, V = d.K, t.arch.vocab_size

    def inputs(seqs, req, resp):
        B = len(seqs)
        inp = t._multi_query_inputs(seqs, K + 1, B_pad)
        inp.update(t._rows(
            B_pad, temps_t=(t._temperatures(seqs), 0.0),
            temps_q=(np.zeros(0, np.float32) if req is None else req.temperatures, 0.0),
            cache_hits=(np.zeros(0, np.int32) if resp is None
                        else resp.cache_hits.astype(np.int32), 0),
            bt_draft=(np.zeros((0, d.max_blocks), np.int32) if req is None
                      else req.block_tables, -1)))
        if t.use_warp:
            w = t._sampling_inputs(B_pad, np.zeros(B, np.float32), *t._seq_warp(seqs))
            inp.update(top_ps=w["top_ps"], top_ks=w["top_ks"])
        inp["logits_q"] = t._device_rows(B_pad, None if resp is None else resp.logits_q,
                                         (K, V), torch.float32)
        return inp

    inp = inputs(seqs, req, resp)
    greedy = all_greedy(inp["temps_t"], inp["temps_q"], inp["cache_hits"], d.jit_speculate)
    greedy_tree = not (inp["temps_q"] > 0).any()
    side = _side(t, branch)

    def fn(input_ids, positions, block_tables, context_lens, logits_q, temps_t, temps_q,
           cache_hits, bt_draft, top_ps=None, top_ks=None):
        return exchange_step(
            t.params, t.kv_cache, d.params, d.kv_cache, input_ids, positions, block_tables,
            context_lens, logits_q, temps_t, temps_q, cache_hits, bt_draft, t.generator,
            d.generator, top_ps, top_ks, t_arch=t.arch, d_arch=d.arch,
            block_size=t.block_size, K=K, fan=d.fan, sampler_x=d.sampler_x, F=d.F,
            jit_speculate=d.jit_speculate, t_s8=t.s8, d_s8=d.s8, greedy=greedy,
            greedy_tree=greedy_tree, side=side)

    return (("exchange", B_pad, greedy, greedy_tree, branch), fn, inp,
            lambda: inputs((), None, None))


def superstep_call(t: ModelRunner, d: DraftRunner, seqs, K: int, R: int, B_pad: int,
                   branch: bool = True):
    """The async superstep as a step call over seqs at bucket B_pad; no
    seqs: ghost rows only (fused_sd._superstep_rows). branch as in
    exchange_call."""
    inputs = _superstep_rows(seqs, t, d, B_pad)
    greedy = _greedy(inputs)
    side = _side(t, branch)

    def fn(rec0, n0, bt_target, bt_draft, temps_t, temps_d, top_ps=None, top_ks=None):
        return async_ssd_superstep(
            t.params, t.kv_cache, d.params, d.kv_cache, rec0, n0, bt_target, bt_draft,
            temps_t, temps_d, t.generator, d.generator, top_ps, top_ks, t_arch=t.arch,
            d_arch=d.arch, block_size=t.block_size, K=K, R=R, fan=d.fan,
            sampler_x=d.sampler_x, F=d.F, jit_speculate=d.jit_speculate, t_s8=t.s8,
            d_s8=d.s8, greedy=greedy, side=side)

    return (("fasync", B_pad, K, R, greedy, branch), fn, inputs,
            lambda: _superstep_rows([], t, d, B_pad))


def _hit_metrics(metrics: dict, hits: np.ndarray, lens: list[list[int]]):
    """The async METRICS of R verify rounds, in the JAX step's order: each
    round's mean cache hit (hits [R, B]), then each row's accepted length
    with recovery per round (lens[b][r]) under on_hit or on_miss."""
    for r in range(hits.shape[0]):
        metrics.setdefault("cache_hits", []).append(float(hits[r].mean()))
    for b, row in enumerate(lens):
        for r, n in enumerate(row):
            key = ("accepted_suffix_lens_on_hit" if hits[r, b] == 1
                   else "accepted_suffix_lens_on_miss")
            metrics.setdefault(key, []).append(n)


class AsyncExchangeSpecDecodeStep(FusedSpecDecodeStep):
    """Async SSD with the fused exchange (Config.async_fused, spec_rounds=1):
    per decode step the host's cache service, one verify + tree-build step
    (one graph replay on the card), one readback and the cache's
    population. Greedy outputs token-exact against the unfused async path;
    the same METRICS keys."""

    def __init__(self, scheduler, target_runner: ModelRunner, draft_runner: DraftRunner,
                 config, metrics: dict | None = None):
        super().__init__(scheduler, target_runner, draft_runner, K=config.speculate_k,
                         rounds=1, metrics=metrics)

    def capture(self, batch_pads: list[int]):
        t, d = self.target_runner, self.draft_runner
        for B_pad in batch_pads:
            t.capture_step(*exchange_call(t, d, B_pad))
            if d.jit_speculate:
                d.capture_step(*d.chain_call(B_pad, self.K, True, **d._tree_sampling()))

    def decode(self, seqs) -> int:
        if not seqs:
            return 0
        t, d = self.target_runner, self.draft_runner
        K, B = self.K, len(seqs)
        saved = [(len(s.token_ids), s.num_tokens, s.last_token) for s in seqs]

        # --- the host's cache service (SpeculatorAsync.speculate, inline) ---
        for seq in seqs:
            assert seq.recovery_token_id is not None
            seq.append_token(seq.recovery_token_id)
        req = spec_request(seqs, d.max_blocks, d.use_warp)
        resp = d.service(req)
        for i, seq in enumerate(seqs):
            for tok in resp.tokens[i].tolist():
                seq.append_token(int(tok))
        speculations = np.concatenate([req.cache_keys[:, 2:3], resp.tokens], axis=1)
        t0 = perf_counter()

        # --- the exchange: verify and the next tree in one step ---
        packed, spec_logits = t.run_step(*exchange_call(t, d, next_pow2(B), seqs, req, resp))
        out = packed[:B].cpu().numpy()      # the one readback
        accept_until, recovery = out[:, 0], out[:, 1]
        tree = out[:, 2:].reshape(B, d.fan.MQ, K + 1)
        d.reset_tree_cache()
        d.populate_tree_cache(req.cache_keys[:, 0], resp.cache_hits, tree[..., 0],
                              tree[..., 1:], spec_logits)
        t1 = perf_counter()

        new_suffixes, _ = build_suffixes(speculations, accept_until)
        for seq, (n_tok, nt, lt) in zip(seqs, saved):
            del seq.token_ids[n_tok:]
            seq.num_tokens = nt
            seq.last_token = lt
        self.scheduler.postprocess_speculate(seqs, new_suffixes, recovery.tolist())

        lens = [len(s) for s in new_suffixes]
        m = self.metrics
        m.setdefault("target_verify_times", []).append(t1 - t0)
        m.setdefault("accepted_suffix_lens_with_recovery", []).extend(lens)
        _hit_metrics(m, np.asarray(resp.cache_hits)[None, :], [[n] for n in lens])
        return sum(lens)


class FusedAsyncSpecDecodeStep(FusedSpecDecodeStep):
    """Async SSD through the R-round superstep (Config.async_fused with
    spec_rounds > 1): one graph replay and one readback per R exchanges.
    The round ladder and EOS truncation are FusedSpecDecodeStep's; adds the
    async cache-hit metrics of the in-step service."""

    def __init__(self, scheduler, target_runner: ModelRunner, draft_runner: DraftRunner,
                 config, metrics: dict | None = None):
        super().__init__(scheduler, target_runner, draft_runner, K=config.speculate_k,
                         rounds=config.spec_rounds, metrics=metrics)

    def capture(self, batch_pads: list[int]):
        t, d = self.target_runner, self.draft_runner
        for B_pad in batch_pads:
            for R in self.round_set:
                t.capture_step(*superstep_call(t, d, [], self.K, R, B_pad))

    def _run_superstep(self, seqs, rounds: int):
        t, d = self.target_runner, self.draft_runner
        B, K = len(seqs), self.K
        out = t.run_step(*superstep_call(t, d, seqs, K, rounds, next_pow2(B)))
        out = out[:, :B].cpu().numpy()      # the one readback, [R, B, K+4]
        suffixes, final_recs, per_round_lens = _collect_rounds(
            out[..., :K + 1], out[..., K + 1], out[..., K + 2], B, rounds)
        _hit_metrics(self.metrics, out[..., K + 3], per_round_lens)
        return suffixes, final_recs, per_round_lens
