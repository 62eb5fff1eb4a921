"""Inference-step strategies.

Counterpart of ssd_tpu/engine/step.py, autoregressive subset: one model
forward per engine step, then the scheduler's postprocess. The speculative
steps and AR multi-step (one chained dispatch per M tokens) are not ported
yet; Config refuses them.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

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
