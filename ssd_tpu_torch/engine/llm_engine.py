"""Engine: request lifecycle, generate loop, metrics.

Counterpart of ssd_tpu/engine/llm_engine.py: the same module-global METRICS
dict with the same keys, `add_request`, `step`, `generate`, `abort_request`
and `exit`, serving AR, sync SD (a draft ModelRunner on the target's thread)
and async SSD (a DraftServer thread on its own CUDA stream of the same
card), with a plain or an EAGLE-3 draft (Config.use_eagle; the target's KV
pool is sized with the EAGLE head's bytes). The warm-up of compiled shape buckets has no counterpart (PyTorch
runs eagerly, so there is nothing to pre-compile).
"""

from __future__ import annotations

import atexit
import weakref
from dataclasses import fields
from time import perf_counter

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.engine.model_runner import ModelRunner
from ssd_tpu_torch.engine.scheduler import Scheduler
from ssd_tpu_torch.engine.sequence import Sequence
from ssd_tpu_torch.engine.step import AutoRegressiveStep, InferenceStep, SpecDecodeStep
from ssd_tpu_torch.sampling_params import SamplingParams
from ssd_tpu_torch.utils.misc import load_tokenizer

METRICS = {
    "cache_hits": [],
    "accepted_suffix_lens_with_recovery": [],
    "accepted_suffix_lens_on_hit": [],
    "accepted_suffix_lens_on_miss": [],
    "prefill_total_time": 0,
    "decode_total_time": 0,
    "prefill_total_tokens": 0,
    "decode_total_tokens": 0,
    "target_step_times": [],
    "target_verify_times": [],
    "sd_superstep_times": [],
}


class LLMEngine:

    def __init__(self, model: str, init_random: bool = False, **kwargs):
        """`model` is a checkpoint directory (config.json plus safetensors,
        or config.json alone with init_random=True, which makes seeded
        random weights). Other keyword arguments are Config fields; the
        engine runs on device="cuda" unless device="cpu" is passed."""
        config_fields = {f.name for f in fields(Config) if f.init}
        unknown = set(kwargs) - config_fields
        if unknown:
            raise TypeError(f"unknown engine arguments: {sorted(unknown)}")
        config = Config(model, **kwargs)
        self.config = config
        Sequence.block_size = config.kvcache_block_size

        self.model_runner = ModelRunner(config, init_random=init_random,
                                        partner=config.draft_hf_config)
        self.draft_runner = None
        self.draft_server = None
        self.draft_cfg = None
        self._exiting = False
        if config.speculate:
            # Made after the target runner: it inherits the block count that
            # sized both pools together.
            self.draft_cfg = config.create_draft_config()
            if config.draft_async:
                from ssd_tpu_torch.engine.draft_runner import DraftServer

                self.draft_server = DraftServer(self.draft_cfg, init_random=init_random)
            else:
                self.draft_runner = ModelRunner(self.draft_cfg, init_random=init_random,
                                                is_draft=True)
            # Stop the draft thread at interpreter exit if the caller did not.
            atexit.register(lambda ref=weakref.ref(self): ref() and ref().exit())
        self.tokenizer = load_tokenizer(config.model)
        if self.tokenizer is not None and self.tokenizer.eos_token_id is not None:
            config.eos = self.tokenizer.eos_token_id
        self.scheduler = Scheduler(config, draft_cfg=self.draft_cfg)

    def exit(self):
        """Stop the async draft thread (idempotent)."""
        if self._exiting:
            return
        self._exiting = True
        if self.draft_server is not None:
            self.draft_server.shutdown()

    def abort_request(self, seq_id: int) -> bool:
        """Cancel an in-flight or queued request by its seq_id; frees its KV
        blocks at once."""
        return self.scheduler.abort(seq_id)

    def add_request(self, prompt: str | list[int], sampling_params: SamplingParams):
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompts need a tokenizer in the "
                                 "checkpoint and the transformers package")
            prompt = self.tokenizer.encode(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.config.max_model_len:
            raise ValueError(
                f"prompt length {len(prompt)} leaves no room for generation "
                f"(max_model_len={self.config.max_model_len})"
            )
        if not (0.0 < sampling_params.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {sampling_params.top_p}")
        if sampling_params.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {sampling_params.top_k}")
        if ((sampling_params.top_p < 1.0 or sampling_params.top_k > 0)
                and not self.config.enable_top_sampling):
            raise ValueError(
                "top_p/top_k need an engine built with enable_top_sampling=True")
        if (len(prompt) > self.config.max_num_batched_tokens
                and not self.config.chunked_prefill):
            raise ValueError(
                f"prompt length {len(prompt)} exceeds max_num_batched_tokens="
                f"{self.config.max_num_batched_tokens} "
                f"(set chunked_prefill=True to admit it in chunks)"
            )
        seq = Sequence(prompt, sampling_params)
        self.scheduler.add(seq)
        return seq.seq_id

    def _run_prefill_chunk(self, seq) -> int:
        """One partial prefill dispatch (Config.chunked_prefill): write the
        chunk's KV, advance the cached-token boundary, and leave the sequence
        in the waiting queue. The sampled token is unused."""
        chunk = seq.prefill_chunk
        self.model_runner.run([seq], is_prefill=True)
        seq.num_cached_tokens += chunk
        seq.prefill_chunk = None
        return chunk

    def _publish_deferred_hashes(self, seqs):
        """Prefix-cache hashes of chunk-allocated prompts publish once the
        whole prompt's KV exists. The AR postprocess does it itself; this
        sweep covers the speculative modes, whose prefill bookkeeping never
        touches block hashes. Sequences that finished during the prefill are
        skipped."""
        sch = self.scheduler
        for seq in seqs:
            if seq.defer_publish and seq.block_table:
                sch._finalize_full_blocks(sch.block_manager, seq, seq.block_table)
                if sch.speculate:
                    sch._finalize_full_blocks(sch._draft_bm(seq), seq,
                                              seq.draft_block_table)
            seq.defer_publish = False

    def step(self, step: InferenceStep | None = None):
        if step is None:
            if not hasattr(self, "_default_step"):
                self._default_step = self.create_inference_step()
            step = self._default_step
        t = perf_counter()
        seqs, is_prefill = self.scheduler.schedule()
        if is_prefill and seqs and seqs[0].prefill_chunk is not None:
            ttl_tokens = self._run_prefill_chunk(seqs[0])
        else:
            ttl_tokens = step.prefill(seqs) if is_prefill else step.decode(seqs)
            if is_prefill:
                self._publish_deferred_hashes(seqs)
        time_taken = perf_counter() - t

        if is_prefill:
            METRICS["prefill_total_time"] += time_taken
            METRICS["prefill_total_tokens"] += ttl_tokens
        else:
            METRICS["decode_total_time"] += time_taken
            METRICS["decode_total_tokens"] += ttl_tokens

        finished = [seq for seq in seqs if seq.is_finished]
        finished.extend(self.scheduler.newly_finished)
        self.scheduler.newly_finished = []
        return [(seq.seq_id, seq.completion_token_ids) for seq in finished]

    def is_finished(self):
        return self.scheduler.is_finished()

    def create_inference_step(self) -> InferenceStep:
        config = self.config
        if not config.speculate:
            return AutoRegressiveStep(self.scheduler, self.model_runner)
        from ssd_tpu_torch.engine.verifier import Verifier

        if config.draft_async:
            from ssd_tpu_torch.engine.speculator_async import SpeculatorAsync

            speculator = SpeculatorAsync(config.speculate_k, self.draft_server,
                                         eagle=config.use_eagle)
        else:
            from ssd_tpu_torch.engine.speculator_sync import SpeculatorSync

            speculator = SpeculatorSync(config.speculate_k, self.draft_runner)
        verifier = Verifier(config.speculate_k, self.model_runner,
                            sampler_x=config.sampler_x,
                            async_fan_out=config.async_fan_out,
                            jit_speculate=config.jit_speculate, metrics=METRICS)
        return SpecDecodeStep(self.scheduler, speculator, verifier,
                              async_spec=config.draft_async, eagle=config.use_eagle)

    def log_metrics(self):
        if METRICS["prefill_total_time"] > 0:
            print(
                f"Final Prefill Throughput: "
                f"{int(METRICS['prefill_total_tokens'] / METRICS['prefill_total_time'])}tok/s",
                flush=True,
            )
        if METRICS["decode_total_time"] > 0:
            print(
                f"Final Decode Throughput: "
                f"{int(METRICS['decode_total_tokens'] / METRICS['decode_total_time'])}tok/s",
                flush=True,
            )
        lens = METRICS["accepted_suffix_lens_with_recovery"]
        if self.config.speculate and lens:
            ttl, n_steps = sum(lens), len(lens)
            print(f"[metrics] Avg Tokens per step (incl recovery): {ttl / n_steps:.2f}",
                  flush=True)
            rate = ((ttl - n_steps) / n_steps) / self.config.speculate_k
            print(f"[metrics] Avg Fraction of Speculated Tokens Accepted: {rate:.2f}",
                  flush=True)
            verify = METRICS["target_verify_times"]
            if verify:
                print(f"[metrics] Avg target verify time (ms): "
                      f"{sum(verify) * 1000 / len(verify):.2f}", flush=True)
            hits = METRICS["cache_hits"]
            if self.config.draft_async and hits:
                print(f"[metrics] Avg Cache Hits: {sum(hits) / len(hits):.2f}", flush=True)

    def generate(
        self,
        prompts: list[str] | list[list[int]],
        sampling_params: SamplingParams | list[SamplingParams],
        use_tqdm: bool = True,
    ):
        """Serve the prompts to completion. Returns (outputs in submission
        order, each {"text", "token_ids"}; METRICS)."""
        for k in METRICS:
            METRICS[k] = [] if isinstance(METRICS[k], list) else 0

        pbar = None
        if use_tqdm:
            try:
                from tqdm.auto import tqdm

                pbar = tqdm(total=len(prompts), desc="Generating", dynamic_ncols=True)
            except ImportError:
                pass
        if not isinstance(sampling_params, list):
            sampling_params = [sampling_params] * len(prompts)
        for prompt, sp in zip(prompts, sampling_params):
            self.add_request(prompt, sp)

        outputs = {}
        inference_step = self.create_inference_step()
        while not self.is_finished():
            t = perf_counter()
            output = self.step(inference_step)
            METRICS["target_step_times"].append(perf_counter() - t)
            for seq_id, token_ids in output:
                outputs[seq_id] = token_ids
                if pbar:
                    pbar.update(1)

        outputs = [outputs[seq_id] for seq_id in sorted(outputs)]
        outputs = [
            {
                "text": self.tokenizer.decode(ids) if self.tokenizer else "",
                "token_ids": ids,
            }
            for ids in outputs
        ]
        if pbar:
            pbar.close()
        self.log_metrics()
        return outputs, METRICS
