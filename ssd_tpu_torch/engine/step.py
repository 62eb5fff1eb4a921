"""Inference-step strategies: autoregressive and speculative decode.

Counterpart of ssd_tpu/engine/step.py: AutoRegressiveStep runs the model and
the scheduler's postprocess; SpecDecodeStep composes a speculator (sync
draft chain or async draft server) and a verifier: save the sequences'
light state, speculate, verify, restore, postprocess_speculate. Not ported
yet: AR multi-step and the fused SD/SSD/EAGLE/ngram steps (Config refuses
them).
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from ssd_tpu_torch.engine.helpers.speculate_types import VerifyResult
from ssd_tpu_torch.engine.model_runner import ModelRunner
from ssd_tpu_torch.engine.scheduler import Scheduler
from ssd_tpu_torch.engine.sequence import Sequence


class InferenceStep(ABC):

    def __init__(self, scheduler: Scheduler):
        self.scheduler = scheduler

    @abstractmethod
    def decode(self, seqs: list[Sequence]) -> int: ...

    @abstractmethod
    def prefill(self, seqs: list[Sequence]) -> int: ...


class AutoRegressiveStep(InferenceStep):

    def __init__(self, scheduler: Scheduler, model_runner: ModelRunner):
        super().__init__(scheduler)
        self.model_runner = model_runner

    def step(self, seqs: list[Sequence], is_prefill: bool) -> int:
        token_ids = self.model_runner.run(seqs, is_prefill)
        self.scheduler.postprocess(seqs, token_ids, is_prefill)
        return len(seqs) if not is_prefill else sum(len(s) for s in seqs)

    def prefill(self, seqs: list[Sequence]) -> int:
        return self.step(seqs, is_prefill=True)

    def decode(self, seqs: list[Sequence]) -> int:
        if not seqs:
            return 0  # everything preempted this step; next step re-prefills
        return self.step(seqs, is_prefill=False)


class SpecDecodeStep(InferenceStep):

    def __init__(self, scheduler: Scheduler, speculator, verifier, async_spec: bool):
        super().__init__(scheduler)
        self.speculator = speculator
        self.verifier = verifier
        self.async_spec = async_spec

    def prefill(self, seqs: list[Sequence]) -> int:
        if self.async_spec:
            # The draft prefill is queued first, so it runs on the draft
            # thread while the target prefills.
            self.speculator.prefill(seqs, VerifyResult([], [], None))
            self.verifier.prefill(seqs)
        else:
            verify_result = self.verifier.prefill(seqs)
            self.speculator.prefill(seqs, verify_result)
        for seq in seqs:
            assert seq.recovery_token_id is not None
            seq.num_cached_tokens = seq.num_prompt_tokens
            seq.num_draft_cached_tokens = seq.num_prompt_tokens
        return sum(len(s) for s in seqs)

    def decode(self, seqs: list[Sequence]) -> int:
        if not seqs:
            return 0  # everything preempted this step; next step re-prefills
        # speculate() appends the recovery and draft tokens; the postprocess
        # needs the sequences as they were.
        saved = [(len(s.token_ids), s.num_tokens, s.last_token) for s in seqs]
        speculate_result = self.speculator.speculate(seqs, VerifyResult([], [], None))
        out_result = self.verifier.verify(seqs, speculate_result)
        for seq, (n_tok, nt, lt) in zip(seqs, saved):
            del seq.token_ids[n_tok:]
            seq.num_tokens = nt
            seq.last_token = lt
        self.scheduler.postprocess_speculate(
            seqs, out_result.new_suffixes, out_result.recovery_tokens)
        return sum(len(s) for s in out_result.new_suffixes)
