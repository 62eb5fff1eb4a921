"""Synchronous (colocated) draft speculator.

Counterpart of ssd_tpu/engine/speculator_sync.py: append the recovery token,
run the draft chain (K+1 single-token decodes, the last one writing the
K-th token's KV) and return [B, K] tokens with their [B, K, V] logits. The
chain (ModelRunner.run_chain) is one CUDA graph replay on the card, where
the JAX package scans it inside one program.
"""

from __future__ import annotations

import numpy as np

from ssd_tpu_torch.engine.helpers.speculate_types import (
    SpeculateResult, SpeculatorBase, VerifyResult)
from ssd_tpu_torch.engine.model_runner import ModelRunner
from ssd_tpu_torch.engine.sequence import Sequence


class SpeculatorSync(SpeculatorBase):

    def __init__(self, lookahead: int, draft_model_runner: ModelRunner):
        super().__init__(lookahead)
        self.draft_model_runner = draft_model_runner

    def prefill(self, seqs: list[Sequence], verify_result: VerifyResult) -> SpeculateResult:
        self.draft_model_runner.run(seqs, is_prefill=True)
        return SpeculateResult([], [])

    def speculate(self, seqs: list[Sequence], verify_result: VerifyResult) -> SpeculateResult:
        K = self.lookahead
        recovery = []
        for seq in seqs:
            if seq.recovery_token_id is None:
                raise ValueError("recovery_token_id is None")
            recovery.append(seq.recovery_token_id)
            seq.append_token(seq.recovery_token_id)

        runner = self.draft_model_runner
        tokens, logits_q = runner.run_chain(
            np.asarray(recovery, dtype=np.int64),
            np.asarray([seq.num_tokens - 1 for seq in seqs], dtype=np.int32),
            runner._block_table_array(seqs), runner._temperatures(seqs), K,
            extra_write=True, top_ps=[s.top_p for s in seqs],
            top_ks=[s.top_k for s in seqs])

        for i, seq in enumerate(seqs):
            for t in tokens[i].tolist():
                seq.append_token(int(t))

        speculations = np.concatenate(
            [np.asarray(recovery, dtype=np.int64)[:, None], tokens.astype(np.int64)],
            axis=1,
        )
        # Sync draft tokens are real samples of q, so verify() may
        # ratio-accept every row: mark them all hits, as the JAX package does
        # (at temperature > 0 the emitted tokens then follow the target's
        # distribution exactly).
        return SpeculateResult(
            speculations, logits_q,
            cache_hits=np.ones(len(seqs), dtype=np.int64),
        )
