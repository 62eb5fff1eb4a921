"""Continuous-batching scheduler with preemption and speculative postprocess.

Counterpart of ssd_tpu/engine/scheduler.py, ported whole: FCFS prefill
admission up to max_num_batched_tokens, chunked prefill, lookahead-aware
decode scheduling with preemption (preempted completions are absorbed into
the prompt and re-prefilled), the context-limit finish, AR postprocess with
EOS/max-token finish and block-hash finalization, and the speculative
postprocess (suffix truncation, KV rollback, metadata update, EAGLE carry).
All host-side.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.engine.block_manager import BlockManager
from ssd_tpu_torch.engine.sequence import Sequence, SequenceStatus
from ssd_tpu_torch.ops.spec_math import compute_megaspec_lookahead


class Scheduler:

    def __init__(self, config: Config, draft_cfg: Config | None = None):
        self.max_num_seqs = config.max_num_seqs
        self.fan_out_list = config.fan_out_list
        self.fan_out_list_miss = config.fan_out_list_miss
        if config.draft_async:
            self.MQ_LEN = sum(self.fan_out_list)
        self.max_num_batched_tokens = config.max_num_batched_tokens
        self.max_model_len = config.max_model_len
        self.chunked_prefill = config.chunked_prefill
        # True right after a chunk dispatch: the next schedule() yields one
        # decode step to the running batch before the next chunk.
        self._chunk_streak = False
        self.eos = config.eos
        self.speculate = config.speculate
        self.F = config.async_fan_out
        self.K = config.speculate_k
        self.block_size = config.kvcache_block_size
        self.verbose = config.verbose
        self.draft_async = config.draft_async
        self.async_fused = config.async_fused
        self.use_eagle = config.use_eagle
        self.multi_step = config.multi_step
        self.spec_rounds = config.spec_rounds
        # Model-free n-gram speculation: spec-style lookahead/postprocess on
        # the target side only (no draft allocator exists).
        self.ngram = config.ngram_speculate
        self.block_manager = BlockManager(
            config.num_kvcache_blocks,
            config.kvcache_block_size,
            is_draft=False,
            verbose=self.verbose,
            max_model_len=self.max_model_len,
        )
        if self.speculate:
            assert draft_cfg is not None
            # One allocator per draft replica; draft data parallelism
            # (`draft_dp` > 1 replicas) is not ported, so there is one.
            self.draft_dp = 1
            self.draft_block_managers = [
                BlockManager(
                    draft_cfg.num_kvcache_blocks,
                    draft_cfg.kvcache_block_size,
                    is_draft=True,
                    speculate_k=self.K,
                    verbose=self.verbose,
                    max_model_len=self.max_model_len,
                )
                for _ in range(self.draft_dp)
            ]

        self.waiting: deque[Sequence] = deque()
        self.running: deque[Sequence] = deque()
        # Sequences finished during schedule() (context-limit boundary);
        # drained by the engine so their outputs are still reported.
        self.newly_finished: list[Sequence] = []

    def _draft_bm(self, seq: Sequence) -> BlockManager:
        return self.draft_block_managers[seq.seq_id % self.draft_dp]

    def is_finished(self) -> bool:
        return not self.waiting and not self.running

    def add(self, seq: Sequence):
        self.waiting.append(seq)

    def abort(self, seq_id: int) -> bool:
        """Cancel a request (beyond reference — serving parity with
        vLLM's abort_request): frees its KV blocks and marks it FINISHED so
        generate() returns whatever it produced so far. Safe between engine
        steps. Stale draft tree-cache entries keyed by this seq_id are
        harmless: seq ids are never reused and the cache is rebuilt every
        spec round."""
        for seq in self.waiting:
            if seq.seq_id == seq_id:
                self.waiting.remove(seq)
                seq.prefill_chunk = None
                seq.defer_publish = False
                if seq.block_table:
                    self.block_manager.deallocate(seq)
                    if self.speculate:
                        self._draft_bm(seq).deallocate(seq)
                seq.status = SequenceStatus.FINISHED
                self.newly_finished.append(seq)
                return True
        for seq in self.running:
            if seq.seq_id == seq_id:
                self._finish(seq)
                self.newly_finished.append(seq)
                return True
        return False

    def bms_can_allocate(self, seq: Sequence) -> bool:
        if not self.block_manager.can_allocate(seq):
            return False
        return not self.speculate or self._draft_bm(seq).can_allocate(seq)

    def bms_can_append(
        self, seq: Sequence, target_lookahead_len: int, draft_lookahead_len: int | None = None
    ) -> bool:
        if self.speculate:
            return self.block_manager.can_append(
                seq, target_lookahead_len
            ) and self._draft_bm(seq).can_append(seq, draft_lookahead_len)
        assert draft_lookahead_len is None
        return self.block_manager.can_append(seq, target_lookahead_len)

    def schedule(self) -> tuple[list[Sequence], bool]:
        """One scheduling decision: a prefill batch if any request can be
        admitted, else a decode batch. Returns (seqs, is_prefill)."""
        admitted = self._admit_prefills()
        if admitted:
            return admitted, True
        return self._schedule_decode(), False

    def _admit_prefills(self) -> list[Sequence]:
        """FCFS admission from the waiting queue, bounded by the per-dispatch
        token budget AND max_num_seqs (one padded prefill program serves the
        whole batch, so both caps bound its compiled size)."""
        batch: list[Sequence] = []
        token_budget = self.max_num_batched_tokens
        while self.waiting and len(batch) < self.max_num_seqs:
            head = self.waiting[0]
            # cost <= len(seq) <= max_model_len <= max_num_batched_tokens
            # (Config asserts the last inequality unless chunked_prefill is
            # on), so a batch-head prefill — including a reprefill whose
            # prompt absorbed completions under preemption — always fits an
            # EMPTY budget and can never livelock at the queue head.
            cost = len(head) - head.num_cached_tokens
            if cost > token_budget:
                if self.chunked_prefill and not batch:
                    # Interleave: after each chunk dispatch, let the running
                    # sequences take one decode step before the next chunk,
                    # so a long prompt doesn't stall in-flight decodes for
                    # its whole length.
                    if self._chunk_streak and self.running:
                        self._chunk_streak = False
                        return []
                    return self._admit_chunk(head, token_budget)
                break
            if head.block_table:
                # Final chunk of a chunked prefill: blocks were allocated
                # with the first chunk; its hashes publish after this step.
                assert head.defer_publish
            else:
                if not self.bms_can_allocate(head):
                    break
                self.block_manager.allocate(head)
                if self.speculate:
                    self._draft_bm(head).allocate(head)
            token_budget -= cost
            head.status = SequenceStatus.RUNNING
            self.waiting.popleft()
            self.running.append(head)
            batch.append(head)
        return batch

    def _admit_chunk(self, head: Sequence, token_budget: int) -> list[Sequence]:
        """Partial prefill of the queue head (Config.chunked_prefill): the
        runner prefills `token_budget` prompt tokens this dispatch; the
        sequence stays in the waiting queue until the whole prompt is in KV.
        Blocks for the FULL prompt are allocated on the first chunk — only
        the dispatch is chunked — but their prefix-cache hashes stay
        unpublished until the KV is actually written."""
        if not head.block_table:
            if not self.bms_can_allocate(head):
                if not self.running:
                    raise RuntimeError(
                        f"prompt of {len(head)} tokens cannot fit the KV pool"
                    )
                return []  # decode on; blocks may free up later
            self.block_manager.allocate(head, publish=False)
            if self.speculate:
                self._draft_bm(head).allocate(head, publish=False)
            head.defer_publish = True
        remain = len(head) - head.num_cached_tokens
        if remain <= token_budget:
            # Prefix-cache hits inside allocate() shrank the remainder to
            # one dispatch: admit normally (hashes still publish at the end).
            head.status = SequenceStatus.RUNNING
            self.waiting.popleft()
            self.running.append(head)
            return [head]
        head.prefill_chunk = min(token_budget, remain)
        self._chunk_streak = True
        return [head]

    def _lookaheads(self) -> tuple[int, int | None]:
        """KV slots each mode may write beyond the committed trunk this step:
        (target, draft)."""
        if self.ngram:
            # The fused ngram superstep writes K+1 verify slots per round,
            # target side only.
            return self.spec_rounds * (self.K + 1), None
        if not self.speculate:
            return 1, None
        if self.draft_async:
            if self.async_fused and self.spec_rounds > 1:
                # Fused async superstep: R rounds advance the trunk by up to
                # (K+1) each, and every round's tree region extends the
                # megaspec lookahead beyond the current base.
                grow = self.spec_rounds * (self.K + 1)
                return grow, grow + compute_megaspec_lookahead(
                    self.MQ_LEN, self.K)
            return self.K + 1, compute_megaspec_lookahead(self.MQ_LEN, self.K)
        # Fused multi-round sync SD reserves every round's worst case up
        # front (one extra slot for the chain's trailing KV write).
        la = self.spec_rounds * (self.K + 1) + (1 if self.spec_rounds > 1 else 0)
        return la, la

    def _reserve(self, seq: Sequence, target_la: int, draft_la: int | None) -> bool:
        """Reserve this step's lookahead blocks for seq, evicting victims from
        the back of the running queue until they fit. False if seq itself had
        to be preempted (no victims left)."""
        while not self.bms_can_append(seq, target_la, draft_la):
            victim = self.running.pop() if self.running else seq
            self.preempt(victim)
            if victim is seq:
                return False
        self.block_manager.may_append(seq, target_la)
        if self.speculate:
            self._draft_bm(seq).may_append(seq, draft_la)
        return True

    def _schedule_decode(self) -> list[Sequence]:
        target_la, draft_la = self._lookaheads()
        horizon = max(target_la, draft_la or 0)
        # Sync non-EAGLE SD tolerates context-limit overshoot: positions past
        # the last table block map to ghost KV slots (dropped writes) and the
        # postprocess truncates the suffix at max_model_len, so near the limit
        # the lookahead CLAMPS to the remaining room instead of finishing the
        # sequence R*(K+1) tokens early. The fused-async SUPERSTEP clamps the
        # same way: its tree cache lives in the scan carry (discarded each
        # superstep), so garbage overshoot rounds cannot poison host state —
        # without this, a deep-context sequence within R*(K+1)+megaspec of
        # the limit would finish WITHOUT DECODING AT ALL (measured: prompt
        # 1900 at max_model_len 2048 emitted 0 tokens). Unfused async / the
        # fused exchange / EAGLE keep the boundary finish (their host-side
        # draft cache is keyed by committed outcomes and cannot absorb
        # garbage rounds).
        sync_spec = (
            self.speculate and not self.draft_async and not self.use_eagle
        ) or self.ngram or (
            self.draft_async and self.async_fused and self.spec_rounds > 1
        )
        batch: list[Sequence] = []
        while self.running and len(batch) < self.max_num_seqs:
            seq = self.running.popleft()
            room = self.max_model_len - seq.num_tokens
            if not sync_spec and seq.num_tokens + horizon > self.max_model_len:
                # Within lookahead of the context limit: no step of this mode
                # can ever run, so finish gracefully at the boundary instead
                # of preempt-looping forever (the reference livelocks here).
                self._finish(seq, remove_running=False)
                self.newly_finished.append(seq)
                continue
            la, dla = target_la, draft_la
            if not self.speculate and self.multi_step > 1:
                # AR multi-step: the chain writes multi_step+1 positions past
                # the trunk; clamp near max_model_len so boundary sequences
                # stay schedulable.
                la = max(1, min(self.multi_step, room))
            elif sync_spec:
                la = max(1, min(target_la, room))
                if draft_la is not None:
                    dla = max(1, min(draft_la, room))
            if self._reserve(seq, la, dla):
                batch.append(seq)
        self.running.extendleft(reversed(batch))

        if not batch and not self.running and self.waiting:
            # Nothing schedulable and the pool is idle: the head request can
            # never be served (needs more blocks than exist). Fail loudly
            # instead of spinning.
            head = self.waiting[0]
            if not self.bms_can_allocate(head) and not self.block_manager.used_block_ids:
                raise RuntimeError(
                    f"request seq {head.seq_id} needs {head.num_blocks} KV "
                    f"blocks but only {self.block_manager.num_free} exist"
                )
        return batch

    def _finish(self, seq: Sequence, remove_running: bool = True):
        seq.status = SequenceStatus.FINISHED
        self.block_manager.deallocate(seq)
        if self.speculate:
            self._draft_bm(seq).deallocate(seq)
        if remove_running:
            self.running.remove(seq)

    def preempt(self, seq: Sequence):
        """Evict seq: free both KV allocations, absorb its completions into
        the prompt (they re-cache on the next prefill), drop every spec/EAGLE
        carry, and push it to the FRONT of the waiting queue so FCFS order is
        preserved."""
        self.block_manager.deallocate(seq)
        if self.speculate:
            self._draft_bm(seq).deallocate(seq)
        seq.status = SequenceStatus.WAITING
        seq.num_prompt_tokens = seq.num_tokens
        seq.recovery_token_id = None
        seq.last_spec_step_accepted_len = -1
        seq.extend_count = 0
        seq.extend_eagle_acts = None
        seq.extend_token_ids = None
        self.waiting.appendleft(seq)

    # --- autoregressive postprocess ---
    def postprocess(self, seqs: list[Sequence], token_ids: list[int], is_prefill: bool):
        for seq, token_id in zip(seqs, token_ids):
            if is_prefill and seq.defer_publish:
                # Chunk-allocated prompt: its KV now fully exists — publish
                # the prompt blocks' hashes BEFORE appending the sampled
                # token, so the block the append may complete chains onto a
                # published predecessor (not a -1 placeholder).
                self._finalize_full_blocks(
                    self.block_manager, seq, seq.block_table
                )
                if self.speculate:
                    self._finalize_full_blocks(
                        self._draft_bm(seq), seq, seq.draft_block_table
                    )
                seq.defer_publish = False
            seq.append_token(token_id)
            if is_prefill:
                seq.num_cached_tokens = seq.num_prompt_tokens
            else:
                seq.num_cached_tokens += 1
            if (
                (not seq.ignore_eos and token_id == self.eos)
                or seq.num_completion_tokens == seq.max_new_tokens
                or seq.num_tokens >= self.max_model_len
            ):
                self._finish(seq)
            else:
                # If a block just completed, hash it into the prefix cache.
                block_table = seq.block_table
                last_block = self.block_manager.blocks[block_table[-1]]
                if seq.last_block_num_tokens == self.block_size:
                    ids = seq.block(seq.num_blocks - 1)
                    prefix = (
                        self.block_manager.blocks[block_table[-2]].hash
                        if len(block_table) > 1 else -1
                    )
                    h = self.block_manager.compute_hash(ids, prefix)
                    last_block.update(h, ids)
                    self.block_manager.hash_to_block_id[h] = last_block.block_id

    # --- AR multi-step postprocess -----------------------------------------
    def postprocess_multi(self, seqs: list[Sequence], suffixes: list[list[int]]):
        """Commit up to multi_step sampled tokens per sequence: truncate at
        EOS / max_new / max_model_len, roll back over-allocated blocks, and
        finalize full-block prefix hashes (the AR analogue of
        postprocess_speculate)."""
        for seq, suffix in zip(seqs, suffixes):
            new_suffix, finished = self._handle_eos_and_max_new_tokens(seq, suffix)
            n = len(new_suffix)
            self._rollback_table(self.block_manager, seq, "block_table",
                                 seq.num_tokens + n)

            seq.token_ids.extend(new_suffix)
            seq.num_tokens += n
            seq.last_token = new_suffix[-1]
            seq.num_cached_tokens += n

            self._finalize_full_blocks(self.block_manager, seq, seq.block_table)

            if finished:
                self._finish(seq)

    # --- speculative postprocess helpers ---
    def _handle_eos_and_max_new_tokens(
        self, seq: Sequence, new_suffix: list[int]
    ) -> tuple[list[int], bool]:
        finished = False
        if not seq.ignore_eos and self.eos in new_suffix:
            new_suffix = new_suffix[: new_suffix.index(self.eos) + 1]
        if seq.num_completion_tokens + len(new_suffix) >= seq.max_new_tokens:
            new_suffix = new_suffix[: seq.max_new_tokens - seq.num_completion_tokens]
        if seq.num_tokens + len(new_suffix) > self.max_model_len:
            new_suffix = new_suffix[: max(0, self.max_model_len - seq.num_tokens)]

        n = len(new_suffix)
        if (
            (not seq.ignore_eos and self.eos in new_suffix)
            or seq.num_completion_tokens + n == seq.max_new_tokens
            or seq.num_tokens + n >= self.max_model_len
        ):
            finished = True
        assert seq.num_completion_tokens <= seq.max_new_tokens
        return new_suffix, finished

    def _rollback_table(self, bm: BlockManager, seq: Sequence, table_name: str,
                        final_num_tokens: int):
        """Free blocks allocated beyond what final_num_tokens needs."""
        required = (final_num_tokens + self.block_size - 1) // self.block_size
        table = getattr(seq, table_name)
        if len(table) > required:
            excess = len(table) - required
            bm.deallocate_ids(table[-excess:])
            setattr(seq, table_name, table[:-excess])

    def _update_kv_caches(self, seq: Sequence, new_suffix: list[int]):
        """Roll back KV blocks over-allocated during speculation."""
        final = seq.num_tokens + len(new_suffix)
        self._rollback_table(self.block_manager, seq, "block_table", final)
        if self.speculate:
            self._rollback_table(
                self._draft_bm(seq), seq, "draft_block_table", final)

    def _finalize_block(self, bm: BlockManager, seq: Sequence, block_table: list[int], i: int):
        """Chain-hash completed block i into the prefix cache."""
        ids = seq.block(i)
        prefix = bm.blocks[block_table[i - 1]].hash if i > 0 else -1
        h = bm.compute_hash(ids, prefix)
        blk = bm.blocks[block_table[i]]
        blk.update(h, ids)
        bm.hash_to_block_id[h] = blk.block_id

    def _finalize_full_blocks(self, bm: BlockManager, seq: Sequence, block_table: list[int]):
        """Hash every token-complete block that is not yet in the prefix cache."""
        for i in range(len(block_table)):
            if (i + 1) * self.block_size <= seq.num_tokens:
                if bm.blocks[block_table[i]].hash == -1:
                    self._finalize_block(bm, seq, block_table, i)

    def _update_sequence_metadata(self, seq: Sequence, new_suffix: list[int], recovery_token: int):
        n = len(new_suffix)
        assert n >= 1, "new_suffix must be non-empty"
        seq.token_ids.extend(new_suffix)
        seq.num_tokens += n
        seq.last_token = new_suffix[-1]
        seq.num_cached_tokens += n
        seq.last_spec_step_accepted_len = n
        seq.recovery_token_id = recovery_token

        assert seq.block_table
        self._finalize_full_blocks(self.block_manager, seq, seq.block_table)
        if self.speculate:
            seq.num_draft_cached_tokens += n
            assert seq.last_block_num_tokens == seq.last_block_num_tokens_draft
            assert seq.draft_block_table
            self._finalize_full_blocks(
                self._draft_bm(seq), seq, seq.draft_block_table)

    def postprocess_speculate(
        self,
        seqs: list[Sequence],
        new_suffixes: list[list[int]],
        next_recovery_tokens: list[int],
        eagle_acts=None,  # tensor [B, K+1, 3*D_target] fp32, on the target's device
    ):
        for i, (seq, new_suffix, rec) in enumerate(
            zip(seqs, new_suffixes, next_recovery_tokens)
        ):
            new_suffix, finished = self._handle_eos_and_max_new_tokens(seq, new_suffix)
            self._update_kv_caches(seq, new_suffix)
            self._update_sequence_metadata(seq, new_suffix, rec)

            if eagle_acts is not None:
                accepted_len = len(new_suffix)
                idx = min(accepted_len - 1, eagle_acts.shape[1] - 1)
                seq.last_target_hidden_state = eagle_acts[i, idx]
                n_ext = min(accepted_len - 1, self.K)
                seq.extend_count = n_ext
                if n_ext > 0:
                    seq.extend_eagle_acts = eagle_acts[i, :n_ext]
                    seq.extend_token_ids = np.asarray(new_suffix[1:1 + n_ext], dtype=np.int64)
                else:
                    seq.extend_eagle_acts = None
                    seq.extend_token_ids = None

            if finished:
                self._finish(seq)
