"""Target-side verification.

Counterpart of ssd_tpu/engine/verifier.py: one multi-query forward of the
target over each sequence's K+1 [recovery | draft] tokens (the paged
attention kernel at Q = K+1), then ops/verify.py::verify and the host-side
suffix assembly; it records the same acceptance METRICS. The JAX package
fuses the forward and verify() into one program fed by one packed int32
payload, a TPU round-trip workaround that is not ported: here the forward
and verify() run eagerly and one small readback returns the result.
With an EAGLE-3 draft the target's prefill and verify also return its taps
(the draft's conditioning), as fp32 tensors on the target's device: target
and draft share the card, so the taps never pass through the host. The
verify's taps are rounded to bf16 on the device, as the JAX package rounds
them for its readback, so both packages condition the draft on the same
values.
"""

from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

from ssd_tpu_torch.engine.helpers.speculate_types import (
    SpeculateResult, VerifierBase, VerifyResult)
from ssd_tpu_torch.engine.model_runner import ModelRunner
from ssd_tpu_torch.engine.sequence import Sequence
from ssd_tpu_torch.ops.verify import all_greedy, build_suffixes, verify


class Verifier(VerifierBase):

    def __init__(
        self,
        lookahead: int,
        target_model_runner: ModelRunner,
        sampler_x: float | None = None,
        async_fan_out: int | None = None,
        jit_speculate: bool = False,
        metrics: dict | None = None,
    ):
        super().__init__(lookahead)
        self.target_model_runner = target_model_runner
        self.sampler_x = sampler_x
        self.async_fan_out = async_fan_out
        self.jit_speculate = jit_speculate
        self.metrics = metrics if metrics is not None else {}

    def prefill(self, seqs: list[Sequence], eagle: bool = False) -> VerifyResult:
        """Target prefill; the sampled token becomes each sequence's
        recovery token. With eagle, also returns each sequence's taps
        [n, n_taps * D] and seeds last_target_hidden_state with the last
        row."""
        if eagle:
            token_ids, _, acts_rows = self.target_model_runner.run_prefill(
                seqs, return_acts=True)
            for seq, token_id, acts in zip(seqs, token_ids, acts_rows):
                seq.recovery_token_id = token_id
                seq.last_target_hidden_state = acts[-1].float()
            return VerifyResult([], list(token_ids), acts_rows)
        token_ids = self.target_model_runner.run(seqs, is_prefill=True)
        for seq, token_id in zip(seqs, token_ids):
            seq.recovery_token_id = token_id
        return VerifyResult([], [seq.recovery_token_id for seq in seqs], None)

    @torch.no_grad()
    def verify(self, seqs: list[Sequence], speculate_result: SpeculateResult,
               eagle: bool = False) -> VerifyResult:
        t0 = perf_counter()
        runner = self.target_model_runner
        K = self.lookahead
        # The sequences already carry [recovery | draft tokens] as their last
        # K+1 tokens (the speculator appended them).
        logits_p, acts = runner.verify_forward(seqs, K + 1)      # [B, K+1, V]
        eagle_acts = None
        if eagle and acts is not None:
            eagle_acts = acts.to(torch.bfloat16).float()
        temps_t = np.asarray([s.temperature for s in seqs], np.float32)
        temps_q = np.asarray([
            s.draft_temperature if s.draft_temperature is not None else s.temperature
            for s in seqs], np.float32)
        cache_hits = speculate_result.cache_hits
        hits = None if cache_hits is None else runner._tensor(
            np.asarray(cache_hits, dtype=np.int64))
        speculations = np.asarray(speculate_result.speculations, dtype=np.int64)
        top_p, top_k = runner._warp_args([s.top_p for s in seqs], [s.top_k for s in seqs])
        accept_until, recovery = verify(
            logits_p, speculate_result.logits_q, runner._tensor(speculations),
            runner._tensor(temps_t), runner._tensor(temps_q), hits, runner.generator,
            jit_speculate=self.jit_speculate, sampler_x=self.sampler_x,
            async_fan_out=self.async_fan_out if self.sampler_x is not None else None,
            top_p=top_p, top_k=top_k,
            greedy=all_greedy(temps_t, temps_q, cache_hits, self.jit_speculate))
        accept_np = accept_until.cpu().numpy()
        recovery_tokens = recovery.tolist()
        new_suffixes, _ = build_suffixes(speculations, accept_np)

        self.metrics.setdefault("target_verify_times", []).append(perf_counter() - t0)
        self.metrics.setdefault("accepted_suffix_lens_with_recovery", []).extend(
            [len(s) for s in new_suffixes])
        if cache_hits is not None:
            ch = np.asarray(cache_hits)
            self.metrics.setdefault("cache_hits", []).append(float(ch.mean()))
            for i, s in enumerate(new_suffixes):
                bucket = ("accepted_suffix_lens_on_hit" if ch[i] == 1
                          else "accepted_suffix_lens_on_miss")
                self.metrics.setdefault(bucket, []).append(len(s))
        return VerifyResult(new_suffixes=new_suffixes, recovery_tokens=recovery_tokens,
                            eagle_acts=eagle_acts)
