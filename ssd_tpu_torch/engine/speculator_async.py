"""Target-side client of the asynchronous draft server.

Counterpart of ssd_tpu/engine/speculator_async.py (one draft replica, no
multi-host union): append the recovery token, send the speculation request
(cache keys [seq_id, accepted_len-1, rec_token], num_tokens, draft block
tables, draft temperatures), receive (cache_hits, [B, K] tokens, [B, K, V]
draft logits). On a card the logits were made on the draft's stream: the
target's stream waits on the reply's event and the tensor is marked as used
by it, so the caching allocator cannot hand its memory to the draft while
the verify still reads it.
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tpu_torch.engine.draft_runner import DraftServer, SpecRequest
from ssd_tpu_torch.engine.helpers.speculate_types import (
    SpeculateResult, SpeculatorBase, VerifyResult)
from ssd_tpu_torch.engine.sequence import Sequence


class SpeculatorAsync(SpeculatorBase):

    def __init__(self, lookahead: int, draft_server: DraftServer):
        super().__init__(lookahead)
        self.K = lookahead
        self.draft_server = draft_server
        self.max_blocks = draft_server.runner.max_blocks

    def _block_tables(self, seqs: list[Sequence]) -> np.ndarray:
        bt = np.full((len(seqs), self.max_blocks), -1, dtype=np.int32)
        for i, seq in enumerate(seqs):
            bt[i, : len(seq.draft_block_table)] = seq.draft_block_table
        return bt

    def prefill(self, seqs: list[Sequence], verify_result: VerifyResult) -> SpeculateResult:
        # Queued and returned at once: the draft prefill runs on the draft
        # thread while the target prefills.
        self.draft_server.prefill([list(seq.token_ids) for seq in seqs],
                                  self._block_tables(seqs))
        return SpeculateResult([], [])

    def speculate(self, seqs: list[Sequence], verify_result: VerifyResult) -> SpeculateResult:
        B = len(seqs)
        for seq in seqs:
            assert seq.recovery_token_id is not None
            seq.append_token(seq.recovery_token_id)

        keys = np.zeros((B, 3), dtype=np.int64)
        num_tokens = np.zeros(B, dtype=np.int64)
        temps = np.zeros(B, dtype=np.float32)
        for i, seq in enumerate(seqs):
            keys[i] = (seq.seq_id, seq.last_spec_step_accepted_len - 1,
                       seq.recovery_token_id)
            num_tokens[i] = seq.num_tokens
            temps[i] = (seq.draft_temperature if seq.draft_temperature is not None
                        else seq.temperature)
        tp = tk = None
        if self.draft_server.runner.use_warp:
            tp = np.asarray([s.top_p for s in seqs], dtype=np.float32)
            tk = np.asarray([s.top_k for s in seqs], dtype=np.int32)
        resp = self.draft_server.speculate(SpecRequest(
            cache_keys=keys, num_tokens=num_tokens,
            block_tables=self._block_tables(seqs), temperatures=temps,
            top_ps=tp, top_ks=tk))

        logits_q = resp.logits_q
        if resp.ready is not None:
            stream = torch.cuda.current_stream(logits_q.device)
            stream.wait_event(resp.ready)
            logits_q.record_stream(stream)

        speculations = np.concatenate([keys[:, 2:3], resp.tokens], axis=1)  # [B, K+1]
        for i, seq in enumerate(seqs):
            for t in resp.tokens[i].tolist():
                seq.append_token(int(t))
        return SpeculateResult(speculations=speculations, logits_q=logits_q,
                               cache_hits=resp.cache_hits)
