"""Inference-step strategies: autoregressive and speculative decode.

Counterpart of ssd_tpu/engine/step.py: AutoRegressiveStep runs the model and
the scheduler's postprocess, or with multi_step > 1 a chain of M decodes
and postprocess_multi; SpecDecodeStep composes a speculator (sync draft
chain or async draft server) and a verifier: save the sequences' light
state, speculate, verify, restore, postprocess_speculate. With an EAGLE-3
draft the draft prefill follows the target's (it is conditioned on the
target's taps) and the verify's taps flow to the scheduler.
FusedSpecDecodeStep runs spec_rounds whole sync-SD rounds per engine step
(engine/fused_sd.py), EagleFusedSpecDecodeStep the same with an EAGLE-3
head, NgramSpecDecodeStep the model-free form; the fused async steps are in
engine/async_fused.py. Each step's `capture` captures its CUDA graphs at
engine init (engine/graphs.py).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from time import perf_counter

from ssd_tpu_torch.engine.helpers.speculate_types import VerifyResult
from ssd_tpu_torch.engine.model_runner import ModelRunner
from ssd_tpu_torch.engine.scheduler import Scheduler
from ssd_tpu_torch.engine.sequence import Sequence


def round_choices(rounds: int) -> tuple[int, ...]:
    """The fused-SD round-count ladder for spec_rounds=R: R and its halvings
    down to 4 (ascending). The engine captures every rung at init, so the
    per-superstep pick never waits on a capture."""
    s = {rounds}
    r = rounds
    while r > 4:
        r //= 2
        s.add(max(r, 4))
    return tuple(sorted(s))


class InferenceStep(ABC):

    def __init__(self, scheduler: Scheduler):
        self.scheduler = scheduler

    def capture(self, batch_pads: list[int]):
        """Capture this step's CUDA graphs for each batch bucket (the
        engine's warm-up; engine/graphs.py)."""

    @abstractmethod
    def decode(self, seqs: list[Sequence]) -> int: ...

    @abstractmethod
    def prefill(self, seqs: list[Sequence]) -> int: ...


class AutoRegressiveStep(InferenceStep):

    def __init__(self, scheduler: Scheduler, model_runner: ModelRunner,
                 multi_step: int = 1):
        super().__init__(scheduler)
        self.model_runner = model_runner
        self.multi_step = multi_step

    def capture(self, batch_pads: list[int]):
        r = self.model_runner
        for B_pad in batch_pads:
            r.capture_step(*r.decode_call([], 1, B_pad))
            if self.multi_step > 1:
                r.capture_step(*r.chain_call(B_pad, self.multi_step, extra_write=False))

    def step(self, seqs: list[Sequence], is_prefill: bool) -> int:
        token_ids = self.model_runner.run(seqs, is_prefill)
        self.scheduler.postprocess(seqs, token_ids, is_prefill)
        return len(seqs) if not is_prefill else sum(len(s) for s in seqs)

    def prefill(self, seqs: list[Sequence]) -> int:
        return self.step(seqs, is_prefill=True)

    def decode(self, seqs: list[Sequence]) -> int:
        if not seqs:
            return 0  # everything preempted this step; next step re-prefills
        # Multi-step: M sampled tokens per step from one chain; EOS and
        # max-length overshoot is truncated and rolled back by the
        # scheduler, like a rejected speculation.
        M = max(1, min(self.multi_step,
                       self.scheduler.max_model_len - max(s.num_tokens for s in seqs)))
        if M <= 1:
            return self.step(seqs, is_prefill=False)
        suffixes = self.model_runner.run_multi_step(seqs, M)
        before = sum(s.num_tokens for s in seqs)
        self.scheduler.postprocess_multi(seqs, suffixes)
        return sum(s.num_tokens for s in seqs) - before


class FusedSpecDecodeStep(InferenceStep):
    """Sync SD with `spec_rounds` whole rounds per engine step
    (engine/fused_sd.py): one graph replay and one host sync per
    R * E[accepted+1] tokens. Greedy outputs are token-exact against the
    unfused path; EOS / max-token overshoot is truncated and rolled back
    like AR multi-step overshoot."""

    def __init__(self, scheduler: Scheduler, target_runner: ModelRunner,
                 draft_runner: ModelRunner | None, K: int, rounds: int,
                 metrics: dict | None = None):
        super().__init__(scheduler)
        self.target_runner = target_runner
        self.draft_runner = draft_runner
        self.K = K
        self.rounds = rounds
        self.round_set = round_choices(rounds)
        self.metrics = metrics if metrics is not None else {}

    def capture(self, batch_pads: list[int]):
        from ssd_tpu_torch.engine.fused_sd import sd_call

        for B_pad in batch_pads:
            for R in self.round_set:
                self.target_runner.capture_step(*sd_call(
                    self.target_runner, self.draft_runner, [], self.K, R, B_pad))

    def _pick_rounds(self, seqs: list[Sequence]) -> int:
        """Smallest captured round count that covers the remaining token
        budget at the observed acceptance rate (a static R wastes rounds
        near the horizon)."""
        rem = max(s.max_new_tokens - s.num_completion_tokens for s in seqs)
        recent = (self.metrics.get("accepted_suffix_lens_with_recovery") or [])[-512:]
        per_round = (sum(recent) / len(recent)) if recent else (self.K + 1)
        need = -(-rem // max(per_round, 1.0))  # ceil
        for r in self.round_set:
            if r >= need:
                return r
        return self.round_set[-1]

    def prefill(self, seqs: list[Sequence]) -> int:
        token_ids = self.target_runner.run(seqs, is_prefill=True)
        self.draft_runner.run(seqs, is_prefill=True)
        for seq, token_id in zip(seqs, token_ids):
            seq.recovery_token_id = token_id
            seq.num_cached_tokens = seq.num_prompt_tokens
            seq.num_draft_cached_tokens = seq.num_prompt_tokens
        return sum(len(s) for s in seqs)

    def _run_superstep(self, seqs: list[Sequence], rounds: int):
        """Mode hook: R fused rounds, returning (suffixes, final recoveries,
        per-round lengths); the ngram step overrides it."""
        from ssd_tpu_torch.engine.fused_sd import run_sd_superstep

        return run_sd_superstep(self.target_runner, self.draft_runner, seqs, self.K, rounds)

    def decode(self, seqs: list[Sequence]) -> int:
        if not seqs:
            return 0
        t0 = perf_counter()
        suffixes, final_recs, per_round_lens = self._run_superstep(
            seqs, self._pick_rounds(seqs))
        # The whole superstep gets its own key: it is not comparable to the
        # unfused path's per-round target_verify_times.
        self.metrics.setdefault("sd_superstep_times", []).append(perf_counter() - t0)
        before_each = [s.num_tokens for s in seqs]
        self.scheduler.postprocess_speculate(seqs, suffixes, final_recs)
        # Acceptance metrics count only rounds wholly inside the committed
        # suffix (EOS / max truncation invalidates the tail rounds).
        lens_out = self.metrics.setdefault("accepted_suffix_lens_with_recovery", [])
        for seq, before, lens in zip(seqs, before_each, per_round_lens):
            committed = seq.num_tokens - before
            used = 0
            for n in lens:
                if used + n > committed:
                    break
                lens_out.append(n)
                used += n
        return sum(s.num_tokens - b for s, b in zip(seqs, before_each))


class EagleFusedSpecDecodeStep(FusedSpecDecodeStep):
    """The EAGLE-3 head inside the fused sync superstep
    (fused_sd.eagle_sd_superstep): its conditioning stays on the device
    across the R rounds; the host seeds it at the prefill (the last prompt
    token's taps in seq.last_target_hidden_state), which a preempted
    sequence passes through again, and the superstep leaves its final taps
    there."""

    def capture(self, batch_pads: list[int]):
        from ssd_tpu_torch.engine.fused_sd import eagle_call

        for B_pad in batch_pads:
            for R in self.round_set:
                self.target_runner.capture_step(*eagle_call(
                    self.target_runner, self.draft_runner, [], self.K, R, B_pad))

    def prefill(self, seqs: list[Sequence]) -> int:
        # The target's prefill with taps, then the draft's prefill
        # conditioned on them (ssd_tpu/engine/step.py's EAGLE ordering).
        token_ids, _, acts_rows = self.target_runner.run_prefill(seqs, return_acts=True)
        for seq, token_id, acts in zip(seqs, token_ids, acts_rows):
            seq.recovery_token_id = token_id
            seq.last_target_hidden_state = acts[-1].float()
            seq.num_cached_tokens = seq.num_prompt_tokens
            seq.num_draft_cached_tokens = seq.num_prompt_tokens
        self.draft_runner.prefill_from_payload(
            [list(seq.token_ids) for seq in seqs],
            self.draft_runner._block_table_array(seqs), acts_list=acts_rows)
        return sum(len(s) for s in seqs)

    def _run_superstep(self, seqs: list[Sequence], rounds: int):
        from ssd_tpu_torch.engine.fused_sd import run_eagle_sd_superstep

        return run_eagle_sd_superstep(self.target_runner, self.draft_runner, seqs, self.K,
                                      rounds)


class NgramSpecDecodeStep(FusedSpecDecodeStep):
    """Model-free speculation (Config.ngram_speculate): prompt-lookup n-gram
    proposals verified by the fused multi-round superstep
    (fused_sd.ngram_superstep). No draft model and no draft KV: the token
    history lives on the device and the matcher runs in the step."""

    def __init__(self, scheduler: Scheduler, target_runner: ModelRunner,
                 K: int, rounds: int, N: int, metrics: dict | None = None):
        super().__init__(scheduler, target_runner, None, K=K, rounds=rounds,
                         metrics=metrics)
        self.N = N

    def capture(self, batch_pads: list[int]):
        from ssd_tpu_torch.engine.fused_sd import ngram_call

        for B_pad in batch_pads:
            for R in self.round_set:
                self.target_runner.capture_step(*ngram_call(
                    self.target_runner, [], self.N, self.K, R, B_pad))

    def prefill(self, seqs: list[Sequence]) -> int:
        token_ids = self.target_runner.run(seqs, is_prefill=True)
        for seq, token_id in zip(seqs, token_ids):
            seq.recovery_token_id = token_id
            seq.num_cached_tokens = seq.num_prompt_tokens
        return sum(len(s) for s in seqs)

    def _run_superstep(self, seqs: list[Sequence], rounds: int):
        from ssd_tpu_torch.engine.fused_sd import run_ngram_superstep

        return run_ngram_superstep(self.target_runner, seqs, self.N, self.K, rounds)


class SpecDecodeStep(InferenceStep):

    def __init__(self, scheduler: Scheduler, speculator, verifier, async_spec: bool,
                 eagle: bool = False):
        super().__init__(scheduler)
        self.speculator = speculator
        self.verifier = verifier
        self.async_spec = async_spec
        self.eagle = eagle

    def capture(self, batch_pads: list[int]):
        """The target's verify forward, and the sync draft's chain (the
        unfused async draft, a plain or an EAGLE-3 one, captures its own
        graphs, engine/draft_runner.py::DraftServer)."""
        K = self.speculator.lookahead
        target = self.verifier.target_model_runner
        for B_pad in batch_pads:
            if not self.async_spec:
                draft = self.speculator.draft_model_runner
                draft.capture_step(*draft.chain_call(B_pad, K, extra_write=True))
            target.capture_step(*target.verify_call([], K + 1, B_pad))

    def prefill(self, seqs: list[Sequence]) -> int:
        if self.async_spec and not self.eagle:
            # The draft prefill is queued first, so it runs on the draft
            # thread while the target prefills.
            self.speculator.prefill(seqs, VerifyResult([], [], None))
            self.verifier.prefill(seqs)
        else:
            verify_result = self.verifier.prefill(seqs, eagle=self.eagle)
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
        out_result = self.verifier.verify(seqs, speculate_result, eagle=self.eagle)
        for seq, (n_tok, nt, lt) in zip(seqs, saved):
            del seq.token_ids[n_tok:]
            seq.num_tokens = nt
            seq.last_token = lt
        self.scheduler.postprocess_speculate(
            seqs, out_result.new_suffixes, out_result.recovery_tokens,
            eagle_acts=out_result.eagle_acts)
        return sum(len(s) for s in out_result.new_suffixes)
