"""Asynchronous draft server: tree speculation off the target's critical path.

Counterpart of ssd_tpu/engine/draft_runner.py (unfused async SSD, one draft
replica). The draft pre-speculates one K-token continuation for every likely
verification outcome (accepted depth x top-F recovery token), keyed
(seq_id, accepted_len - 1, recovery_token), so a cache hit costs the target
one queue round trip instead of K draft forwards.

Placement on one card: the draft shares the target's device and runs on its
own CUDA stream, driven by a controller thread (the `torch.cuda.stream`
context is entered inside that thread: the current stream is thread-local).
`service()` answers the target from the tree cache and the reply is handed
back before the next tree is built, so the tree build (glue forward, fork,
K tree steps through csrc/tree_attention.cu) runs on the draft stream while
the target verifies on its own. The reply's logits are made on the draft
stream: the reply carries an event recorded after them, and the target
waits on it and marks the tensor used by its stream before reading it.

A failure in the draft thread is parked in the response queue and raised in
the target thread as RuntimeError("draft server died"); it is never
swallowed. Not ported: draft data parallelism (draft_dp > 1) and the
multi-host union of replies.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import traceback
from dataclasses import dataclass
from time import perf_counter

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.engine.model_runner import (
    KVCache, ModelRunner, _store_rows, decode_forward, layer_of)
from ssd_tpu_torch.models.transformer import Arch, compute_logits, forward_hidden
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops.sampler import sample
from ssd_tpu_torch.ops.spec_math import fan_index, get_forked_recovery_tokens
from ssd_tpu_torch.utils.native import slot_of


def tree_build_step(
    params: dict,
    kv_cache: KVCache,               # [L, Hkv, S, 2*hd] | int8 pair, in place
    glue_ids: torch.Tensor,          # [B, K+1] [recovery | spec_0..spec_{K-1}]
    base_positions: np.ndarray,      # [B] position of the recovery token
    block_tables: np.ndarray,        # [B, M] draft tables
    cache_hits: np.ndarray,          # [B] {0,1}
    temperatures: torch.Tensor,      # [B]
    generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    arch: Arch,
    block_size: int,
    K: int,
    fan_out_list: list[int],
    fan_out_list_miss: list[int],
    sampler_x: float | None,
    F: int,
    s8: bool = False,
):
    """Build the next step's speculation tree: the glue forward (the K+1
    returned tokens, paged attention at Q = K+1), the top-F fork per glue
    depth, then K tree steps over the B*MQ fork rows (tree attention).
    Counterpart of ssd_tpu/engine/draft_runner.py::tree_build_program, as
    eager steps. Geometry, with base = num_tokens - 1: the draft cache holds
      [ trunk 0..base-1 | glue base..base+K | tree step s row r at
        base + (K+1) + s*MQ + r ]
    and tree row r (forked from glue depth fan_idx[r]) takes rope position
    base + fan_idx[r] + 1 + s at step s. Over the int8 cache the glue and
    the tree steps take its kernels (s8 for kv_quant="int8_mxu").

    Returns (fork tokens [B, MQ], spec tokens [B, MQ, K], spec logits
    [B*MQ, K, V] with row b*MQ + r for tree row r of sequence b, glue logits
    [B, K+1, V])."""
    dev = glue_ids.device
    B = block_tables.shape[0]
    Kp1 = K + 1
    MQ = sum(fan_out_list)
    scale = arch.head_dim ** -0.5

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, non_blocking=True)

    bt = upload(block_tables)
    # ---- glue: one K+1 multi-query forward per sequence ----
    glue_pos = (base_positions[:, None] + np.arange(Kp1)[None, :]).reshape(-1)
    glue_slots = slot_of(block_tables, glue_pos, np.repeat(np.arange(B), Kp1),
                         block_size)
    glue_logits = decode_forward(
        params, kv_cache, glue_ids.reshape(-1), upload(glue_pos.astype(np.int32)),
        upload(glue_slots), _store_rows(glue_slots, dev), bt,
        upload((base_positions + Kp1).astype(np.int32)),
        arch=arch, block_size=block_size, q_len=Kp1, s8=s8).reshape(B, Kp1, -1)

    # ---- fork: top-F per glue depth, excluding the returned token ----
    fork = get_forked_recovery_tokens(glue_logits, upload(cache_hits), glue_ids,
                                      fan_out_list, fan_out_list_miss)   # [B, MQ]
    fan_rows = np.where(cache_hits.astype(bool)[:, None],
                        fan_index(fan_out_list)[None, :],
                        fan_index(fan_out_list_miss)[None, :]).astype(np.int32)
    fan_t = upload(fan_rows)

    # ---- K tree steps over N = B*MQ rows ----
    b_flat = np.repeat(np.arange(B), MQ)
    r_flat = np.tile(np.arange(MQ), B)
    base_n = base_positions[b_flat]
    fan_n = fan_rows.reshape(-1)
    idx_n = upload(b_flat)
    temps_n = temperatures[idx_n]
    tp_n = None if top_ps is None else top_ps[idx_n]
    tk_n = None if top_ks is None else top_ks[idx_n]
    tok = fork.reshape(-1)
    toks, logits_all = [], []
    for s in range(K):
        slots = slot_of(block_tables, base_n + Kp1 + s * MQ + r_flat, b_flat,
                        block_size)
        slots_t, rows_t = upload(slots), _store_rows(slots, dev)
        ctx = upload((base_positions + Kp1 + (s + 1) * MQ).astype(np.int32))

        def attn_call(li, q, k, v, s=s, slots_t=slots_t, rows_t=rows_t, ctx=ctx):
            kv_layer = layer_of(kv_cache, li)
            att.store_kv(kv_layer, k, v, slots_t, rows_t)
            qr = q.reshape(B, MQ, arch.num_heads, arch.head_dim)
            o = att.tree_attention(qr, kv_layer, bt, ctx, fan_t, s, K, block_size,
                                   scale, s8=s8)
            return o.reshape(B * MQ, arch.num_heads, arch.head_dim)

        rope = upload((base_n + fan_n + 1 + s).astype(np.int32))
        hidden = forward_hidden(params, tok, rope, attn_call, arch)
        logits = compute_logits(params, hidden, arch)                  # [N, V]
        tok = sample(logits, temps_n, generator, tp_n, tk_n,
                     sampler_x=sampler_x, fan_out=F, is_tree=True)
        toks.append(tok)
        logits_all.append(logits)
    spec_tokens = torch.stack(toks, dim=1).reshape(B, MQ, K)
    spec_logits = torch.stack(logits_all, dim=1)                       # [N, K, V]
    return fork, spec_tokens, spec_logits, glue_logits


# ---------------------------------------------------------------------------
# Request/response payloads (the handshake)
# ---------------------------------------------------------------------------


@dataclass
class SpecRequest:
    """Target -> draft, one per decode step."""

    cache_keys: np.ndarray      # [B, 3] int64: (seq_id, accepted_len-1, rec_token)
    num_tokens: np.ndarray      # [B] int64, incl. the appended recovery token
    block_tables: np.ndarray    # [B, max_blocks] int32 draft tables
    temperatures: np.ndarray    # [B] float32 draft temperatures
    top_ps: np.ndarray | None = None   # [B] float32 (Config.enable_top_sampling)
    top_ks: np.ndarray | None = None   # [B] int32
    # EAGLE-3 conditioning payload (the taps: fp32 on the target's device,
    # made on its stream before acts_ready):
    recovery_acts: torch.Tensor | None = None   # [B, n_taps*D_target]
    extend_counts: np.ndarray | None = None     # [B] int64
    extend_acts: torch.Tensor | None = None     # [B, K, n_taps*D_target]
    extend_token_ids: np.ndarray | None = None  # [B, K] int64
    acts_ready: torch.cuda.Event | None = None  # (on a card)


@dataclass
class SpecResponse:
    """Draft -> target."""

    cache_hits: np.ndarray      # [B] int64 {0,1}
    tokens: np.ndarray          # [B, K] int64
    logits_q: torch.Tensor      # [B, K, V], made on the draft's stream
    ready: torch.cuda.Event | None = None  # recorded after logits_q (on a card)
    activations: torch.Tensor | None = None  # [B, K, D_draft] prenorms (EAGLE)


class DraftRunner(ModelRunner):
    """Draft-model execution plus the speculation tree cache."""

    def __init__(self, config: Config, init_random: bool = False):
        super().__init__(config, init_random=init_random, is_draft=True)
        self.K = config.speculate_k
        self.F = config.async_fan_out
        self.fan_out_list = list(config.fan_out_list)
        self.fan_out_list_miss = list(config.fan_out_list_miss)
        self.sampler_x = config.sampler_x
        self.jit_speculate = config.jit_speculate
        # Miss rows draw their tokens from the same numpy stream as the JAX
        # package, so hit and acceptance statistics compare row for row.
        self._rng = np.random.default_rng(config.seed + 17)
        self.reset_tree_cache()

    def reset_tree_cache(self):
        self.tree_cache_keys = np.zeros((0, 3), dtype=np.int64)
        self.tree_cache_tokens = None   # np [N, K]
        self.tree_cache_logits = None   # device [N, K, V]
        self.tree_cache_acts = None     # device [N, K, D] (EAGLE only)

    @torch.no_grad()
    def prefill_from_payload(self, input_id_lists: list[list[int]],
                             block_tables: np.ndarray):
        """Whole-prompt draft prefill of the batch in one flat forward (the
        flat prefill kernel, where the JAX package runs its grouped prefill).
        The sampled token is unused."""
        rows = [(ids, block_tables[i], 0, len(ids))
                for i, ids in enumerate(input_id_lists)]
        temps = torch.zeros(len(rows), dtype=torch.float32, device=self.device)
        self._flat_prefill(rows, temps)

    @torch.no_grad()
    def service(self, req: SpecRequest) -> SpecResponse:
        B = req.cache_keys.shape[0]
        K, V = self.K, self.arch.vocab_size
        hits = np.zeros(B, dtype=np.int64)
        idx = np.zeros(B, dtype=np.int64)
        if self.tree_cache_keys.shape[0] > 0:
            match = (req.cache_keys[:, None, :] == self.tree_cache_keys[None, :, :]).all(axis=2)
            hits = match.any(axis=1).astype(np.int64)
            idx = match.argmax(axis=1)

        all_hit = bool(hits.all()) and self.tree_cache_keys.shape[0] > 0
        if self.jit_speculate and not all_hit:
            # Any miss: recompute every row with real logits; cache_hits
            # keeps the match result for metrics and fan-out selection.
            tokens, logits_q, acts = self._jit_chain(req)
            return SpecResponse(hits, tokens.astype(np.int64), logits_q,
                                activations=acts)

        # Miss rows: random valid tokens and logits verify() never consults
        # (greedy acceptance there; ratio rows are masked by cache_hits).
        tokens = self._rng.integers(0, V, size=(B, K), dtype=np.int64)
        acts = None
        if hits.any():
            cached = self.tree_cache_tokens[idx]
            tokens = np.where(hits[:, None].astype(bool), cached, tokens)
            idx_t = self._tensor(idx)
            logits_q = self.tree_cache_logits[idx_t]
            if self.tree_cache_acts is not None:   # EAGLE, all rows hit
                acts = self.tree_cache_acts[idx_t]
        else:
            logits_q = torch.zeros((B, K, V), dtype=torch.float32, device=self.device)
        return SpecResponse(hits, tokens, logits_q, activations=acts)

    def _jit_chain(self, req: SpecRequest):
        """The miss path: K draft decodes and the K-th token's KV write,
        sampled in tree mode. Returns (tokens [B, K] numpy, logits
        [B, K, V], None: a plain draft has no activations)."""
        tokens, logits_q = self.run_chain(
            req.cache_keys[:, 2].copy(), (req.num_tokens - 1).astype(np.int32),
            req.block_tables, req.temperatures, self.K, extra_write=True,
            top_ps=req.top_ps, top_ks=req.top_ks, sampler_x=self.sampler_x,
            fan_out=self.F, tree_sampling=True)
        return tokens, logits_q, None

    @torch.no_grad()
    def build_tree(self, req: SpecRequest, resp: SpecResponse):
        B = req.cache_keys.shape[0]
        glue_ids = np.zeros((B, self.K + 1), dtype=np.int64)
        glue_ids[:, 0] = req.cache_keys[:, 2]
        glue_ids[:, 1:] = resp.tokens
        tp, tk = self._warp_args(req.top_ps, req.top_ks)
        fork, spec, spec_logits, _ = tree_build_step(
            self.params, self.kv_cache, self._tensor(glue_ids),
            (req.num_tokens - 1).astype(np.int64), req.block_tables,
            resp.cache_hits, self._tensor(req.temperatures.astype(np.float32)),
            self.generator, tp, tk,
            arch=self.arch, block_size=self.block_size, K=self.K,
            fan_out_list=self.fan_out_list, fan_out_list_miss=self.fan_out_list_miss,
            sampler_x=self.sampler_x, F=self.F, s8=self.s8)
        self.populate_tree_cache(req.cache_keys[:, 0], resp.cache_hits,
                                 fork.cpu().numpy(), spec.cpu().numpy(), spec_logits)

    def populate_tree_cache(self, seq_ids_B, hits_B, fork_np, spec_np, spec_logits):
        """Install a freshly built tree: host keys (seq_id, fan_idx,
        fork_token) and token matrix, device logits (row b*MQ + r)."""
        B, MQ = fork_np.shape
        fan = np.where(np.asarray(hits_B).astype(bool)[:, None],
                       fan_index(self.fan_out_list)[None, :],
                       fan_index(self.fan_out_list_miss)[None, :]).reshape(-1)
        self.tree_cache_keys = np.stack(
            [np.repeat(np.asarray(seq_ids_B, dtype=np.int64), MQ),
             fan.astype(np.int64), fork_np.reshape(-1).astype(np.int64)], axis=1)
        self.tree_cache_tokens = spec_np.reshape(B * MQ, -1)
        self.tree_cache_logits = spec_logits


class DraftServer:
    """The controller thread owning the draft runner: a request queue and a
    response queue stand in for the reference's separate draft process."""

    def __init__(self, draft_cfg: Config, init_random: bool = False):
        if draft_cfg.use_eagle:
            from ssd_tpu_torch.engine.eagle_runner import EagleDraftRunner

            self.runner = EagleDraftRunner(draft_cfg, init_random=init_random)
        else:
            self.runner = DraftRunner(draft_cfg, init_random=init_random)
        dev = self.runner.device
        self.stream = None
        if dev.type == "cuda":
            self.stream = torch.cuda.Stream(device=dev)
            # The weights and the zeroed cache were written on the current
            # stream; the draft stream starts after them.
            self.stream.wait_stream(torch.cuda.current_stream(dev))
        self._req_q: queue.Queue = queue.Queue()
        self._resp_q: queue.Queue = queue.Queue()
        self._step_times: list[float] = []
        self._dead = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ssd-draft-server")
        self._thread.start()

    def _loop(self):
        on_stream = (torch.cuda.stream(self.stream) if self.stream is not None
                     else contextlib.nullcontext())
        with on_stream, torch.no_grad():
            while True:
                cmd, payload = self._req_q.get()
                if cmd == "exit":
                    break
                if cmd == "sync":
                    payload.set()
                    continue
                try:
                    if cmd == "prefill":
                        args, ready = payload
                        self._receive(ready, args[2:])
                        self.runner.prefill_from_payload(*args)
                    elif cmd == "spec":
                        t0 = perf_counter()
                        self._receive(payload.acts_ready,
                                      (payload.recovery_acts, payload.extend_acts))
                        resp = self.runner.service(payload)
                        if self.stream is not None:
                            resp.ready = torch.cuda.Event()
                            resp.ready.record(self.stream)
                        # Unblock the target before building the next tree:
                        # the build overlaps the target's verify.
                        self._resp_q.put(resp)
                        self.runner.reset_tree_cache()
                        self.runner.build_tree(payload, resp)
                        self._step_times.append(perf_counter() - t0)
                except Exception as e:  # surfaced to the waiting target
                    traceback.print_exc()
                    self._dead = True
                    # Always park the exception: a speculate() blocked (or
                    # about to block) on the response queue must see it, even
                    # when the failing command was a prefill.
                    self._resp_q.put(e)
                    break

    def handoff(self) -> torch.cuda.Event | None:
        """An event recorded on the caller's (the target's) stream after the
        tensors it hands to the draft; None on the CPU."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.runner.device))
        return ev

    def _receive(self, ready, tensors):
        """Draft thread: the draft's stream waits for tensors the target
        made, and marks them as used by it, so the caching allocator cannot
        hand their memory back to the target while the draft reads them."""
        if ready is None:
            return
        self.stream.wait_event(ready)
        for t in tensors:
            for x in (t if isinstance(t, list) else [t]):
                if x is not None:
                    x.record_stream(self.stream)

    def prefill(self, input_id_lists: list[list[int]], block_tables: np.ndarray,
                acts_list: list[torch.Tensor] | None = None):
        """Queue the draft prefill; an EAGLE draft takes the target's
        per-sequence taps (tensors on the target's device)."""
        if self._dead:
            self._raise_dead()
        args = (input_id_lists, block_tables)
        if acts_list is not None:
            args += (acts_list,)
        self._req_q.put(("prefill", (args, self.handoff() if acts_list is not None else None)))

    def _raise_dead(self):
        try:
            resp = self._resp_q.get(timeout=1.0)
        except queue.Empty:
            resp = None
        if isinstance(resp, Exception):
            raise RuntimeError("draft server died") from resp
        raise RuntimeError("draft server died without replying")

    def speculate(self, req: SpecRequest) -> SpecResponse:
        if self._dead:
            self._raise_dead()
        self._req_q.put(("spec", req))
        # Poll, so that a thread that died without replying (in a prefill)
        # cannot strand the target.
        while True:
            try:
                resp = self._resp_q.get(timeout=10.0)
                break
            except queue.Empty:
                if self._dead:
                    self._raise_dead()
        if isinstance(resp, Exception):
            raise RuntimeError("draft server died") from resp
        return resp

    def drain(self, timeout: float = 120.0):
        """Block until every queued draft command has run (measurement and
        tests; the serving path never waits on the tree build). Raises if
        the draft thread died or did not get there within `timeout` s."""
        ev = threading.Event()
        self._req_q.put(("sync", ev))
        deadline = perf_counter() + timeout
        while not ev.wait(timeout=0.5):
            if self._dead or not self._thread.is_alive():
                self._raise_dead()
            if perf_counter() > deadline:
                raise TimeoutError(f"draft server did not drain within {timeout} s")

    def shutdown(self):
        if self._thread.is_alive():
            self._req_q.put(("exit", None))
            self._thread.join(timeout=30)
