"""Target-side client of the asynchronous draft server.

Counterpart of ssd_tpu/engine/speculator_async.py (no multi-host union):
append the recovery token, send the speculation request (cache keys
[seq_id, accepted_len-1, rec_token], num_tokens, draft block tables, draft
temperatures), receive (cache_hits, [B, K] tokens, [B, K, V] draft logits).
The server answers with one part per draft replica that holds rows
(draft_dp > 1 routes rows by seq_id, engine/draft_runner.py; a draft rank
of its own answers through parallel/draft_rank.py); the parts are put back
together in request-row order, tokens and hits on the host and the logits
in one [B, K, V] tensor on the target's device. On a card the logits were
made on the draft's stream: the target's stream waits on each part's event
and the tensor is marked as used by it, so the caching allocator cannot
hand its memory to the draft while the verify still reads it. With an
EAGLE-3 draft the prefill carries the target's taps and each request the
conditioning payload (recovery taps, and the taps and tokens of the extend
rows: the tokens the last verify accepted, whose draft KV is rewritten
under the target's conditioning). The taps stay on the card: the payload
is made on the target's stream and the draft's stream waits on an event
recorded after it (the hand-off of the logits in the other direction).
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tpu_torch.engine.draft_runner import spec_request
from ssd_tpu_torch.engine.helpers.speculate_types import (
    SpeculateResult, SpeculatorBase, VerifyResult)
from ssd_tpu_torch.engine.sequence import Sequence


class SpeculatorAsync(SpeculatorBase):

    def __init__(self, lookahead: int, draft_server, eagle: bool = False):
        """draft_server: engine/draft_runner.py::DraftServer (the draft on
        the target's card) or parallel/draft_rank.py::DraftRanks (on ranks
        of its own)."""
        super().__init__(lookahead)
        self.K = lookahead
        self.draft_server = draft_server
        self.eagle = eagle
        self.max_blocks = draft_server.max_blocks

    def _block_tables(self, seqs: list[Sequence]) -> np.ndarray:
        bt = np.full((len(seqs), self.max_blocks), -1, dtype=np.int32)
        for i, seq in enumerate(seqs):
            bt[i, : len(seq.draft_block_table)] = seq.draft_block_table
        return bt

    def prefill(self, seqs: list[Sequence], verify_result: VerifyResult) -> SpeculateResult:
        # Queued and returned at once: the draft prefill runs on the draft
        # thread while the target prefills.
        self.draft_server.prefill([list(seq.token_ids) for seq in seqs],
                                  self._block_tables(seqs),
                                  np.asarray([seq.seq_id for seq in seqs], np.int64),
                                  acts_list=verify_result.eagle_acts)
        return SpeculateResult([], [])

    def speculate(self, seqs: list[Sequence], verify_result: VerifyResult) -> SpeculateResult:
        B = len(seqs)
        for seq in seqs:
            assert seq.recovery_token_id is not None
            seq.append_token(seq.recovery_token_id)

        eagle = {}
        if self.eagle:
            # The conditioning payload (ssd_tpu/engine/speculator_async.py),
            # made on the target's device in a fixed number of launches: the
            # recovery taps and the extend taps are one stack each (rows past
            # a sequence's extend count are never read).
            rec_acts = torch.stack([s.last_target_hidden_state for s in seqs])
            none = rec_acts.new_zeros((self.K, rec_acts.shape[-1]))
            ext_acts = torch.stack([none if s.extend_eagle_acts is None
                                    else s.extend_eagle_acts for s in seqs])
            ext_ids = np.zeros((B, self.K), dtype=np.int64)
            for i, seq in enumerate(seqs):
                if seq.extend_token_ids is not None:
                    ext_ids[i, :seq.extend_count] = seq.extend_token_ids[:seq.extend_count]
            eagle = dict(
                recovery_acts=rec_acts, extend_acts=ext_acts,
                extend_counts=np.asarray([s.extend_count for s in seqs], np.int64),
                extend_token_ids=ext_ids, acts_ready=self.draft_server.handoff())
        req = spec_request(seqs, self.max_blocks, self.draft_server.use_warp, **eagle)
        keys = req.cache_keys
        parts = self.draft_server.speculate(req)
        for _, resp in parts:
            if resp.ready is not None:
                stream = torch.cuda.current_stream(resp.logits_q.device)
                stream.wait_event(resp.ready)
                resp.logits_q.record_stream(stream)
        if len(parts) == 1:   # one replica holds every row, in order
            tokens, cache_hits, logits_q = (parts[0][1].tokens, parts[0][1].cache_hits,
                                            parts[0][1].logits_q)
        else:
            tokens = np.zeros((B, self.K), np.int64)
            cache_hits = np.zeros(B, np.int64)
            first = parts[0][1].logits_q
            logits_q = first.new_empty((B,) + tuple(first.shape[1:]))
            for rows, resp in parts:
                tokens[rows] = resp.tokens
                cache_hits[rows] = resp.cache_hits
                logits_q.index_copy_(0, torch.from_numpy(rows).to(first.device),
                                     resp.logits_q[:len(rows)])

        speculations = np.concatenate([keys[:, 2:3], tokens], axis=1)  # [B, K+1]
        for i, seq in enumerate(seqs):
            for t in tokens[i].tolist():
                seq.append_token(int(t))
        return SpeculateResult(speculations=speculations, logits_q=logits_q,
                               cache_hits=cache_hits)
