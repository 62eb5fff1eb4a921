"""Engine: request lifecycle, generate loop, metrics.

Counterpart of ssd_tpu/engine/llm_engine.py: the same module-global METRICS
dict with the same keys, `add_request`, `step`, `generate`, `abort_request`
and `exit`, serving AR, sync SD (a draft ModelRunner on the target's thread)
and async SSD (a DraftServer thread on its own CUDA stream of the same
card), with a plain or an EAGLE-3 draft (Config.use_eagle; the target's KV
pool is sized with the EAGLE head's bytes), AR multi-step, fused sync SD
(spec_rounds > 1, with a plain draft or an EAGLE-3 head), ngram
speculation and the fused async forms (engine/async_fused.py: async_fused,
with an inline draft runner and no thread). The JAX package's warm-up,
which compiles every decode-side shape bucket at init, becomes the capture
of one CUDA graph per decode-side step and batch bucket (engine/graphs.py)
on the card, for every mode unless Config.enforce_eager; the unfused async
draft captures its own graphs, into a StepGraphs of its thread, before the
thread starts.

Config.num_devices > 1 (or a caller's torch.distributed group) serves one
model sharded over that many processes (parallel/comm.py): every rank builds
this engine over its shard and runs the same scheduler on the same inputs,
the sync draft and the fused forms' inline draft sharded over the same
ranks (ssd_tpu/engine/llm_engine.py puts them on the target's mesh). When
the engine spawned its ranks, the caller's process is rank 0: it relays
add_request, step, generate, abort_request and exit to the others and is
the only one that returns outputs and METRICS. exit() checks that every
rank emitted the same tokens, then tears the group down.

The unfused async draft (draft_async without async_fused) serves draft_dp
replicas (Config.draft_dp): beside the target on its card
(engine/draft_runner.py::DraftServer, the target's pool sized with theirs),
or, when num_devices >= tp_size + draft_dp, each in a process of its own,
ranks tp_size.. of the engine's group (parallel/draft_rank.py): the target
then shards over tp_size ranks and talks to them through DraftRanks. At a
draft rank of a caller's group the constructor serves the draft replica
until the target's exit() and then returns an engine that serves nothing.
"""

from __future__ import annotations

import atexit
import functools
import weakref
from dataclasses import fields
from time import perf_counter

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.engine.model_runner import ModelRunner
from ssd_tpu_torch.engine.scheduler import Scheduler
from ssd_tpu_torch.engine.sequence import Sequence
from ssd_tpu_torch.engine.step import (
    AutoRegressiveStep, EagleFusedSpecDecodeStep, FusedSpecDecodeStep, InferenceStep,
    NgramSpecDecodeStep, SpecDecodeStep)
from ssd_tpu_torch.parallel import comm as tp_comm
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


def _relayed(method):
    """A public call that rank 0 of a spawned group runs on every rank
    (parallel/comm.py::Comm.relay); nested calls (generate's steps) and
    engines without spawned ranks run it here only."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        if self.draft_rank_launches is not None:
            raise RuntimeError("this process served a draft rank; its engine serves "
                               "no requests")
        comm = self.comm
        if comm is None or not comm.workers or self._relaying:
            return method(self, *args, **kwargs)
        self._relaying = True
        try:
            return comm.relay(method.__name__, args, kwargs,
                              lambda: method(self, *args, **kwargs))
        finally:
            self._relaying = False
    return call


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
        self._exiting = False
        self._relaying = False
        # Sequence ids of a tensor-parallel engine's own, alike on every
        # rank whatever each process served before.
        self._next_seq_id = 0
        # A draft rank's kernel launches since its last drain, reported at
        # exit (an engine built at a draft rank of a caller's group).
        self.draft_rank_launches = None
        self.comm = tp_comm.connect(config, model, init_random, kwargs)
        if self.comm is not None and self.comm.is_draft:
            from ssd_tpu_torch.parallel.draft_rank import serve

            self.draft_rank_launches = serve(self.comm, config, init_random)
            self._exiting = True
            return
        if self.comm is None or not self.comm.owned:
            self._build(init_random)
            return
        # Rank 0 of a spawned group: the other ranks build theirs meanwhile
        # (the collectives of the build pair them up), then reply.
        try:
            self.comm.relay(None, (), {}, lambda: self._build(init_random))
        except BaseException:
            if getattr(self, "draft_server", None) is not None:
                self.draft_server.shutdown()
            self.comm.close()
            raise
        atexit.register(lambda ref=weakref.ref(self): ref() and ref().exit())

    def _build(self, init_random: bool):
        config = self.config
        Sequence.block_size = config.kvcache_block_size
        # The comm of the models' collectives: none for a one-rank target
        # whose group exists for its draft ranks.
        comm = self.comm
        self.model_comm = None if comm is not None and comm.size == 1 and comm.draft_ranks \
            else comm
        self.draft_runner = None
        self.draft_server = None
        self.draft_cfg = None
        self.model_runner = ModelRunner(
            config, init_random=init_random, comm=self.model_comm,
            partner=config.draft_hf_config if config.draft_replicas_here else None)
        if config.speculate:
            # Made after the target runner: it inherits the block count that
            # sized both pools together.
            self.draft_cfg = config.create_draft_config()
            if config.draft_async and config.async_fused:
                # The fused forms run the draft inline, on the engine's
                # thread, as the JAX engine does.
                from ssd_tpu_torch.engine.draft_runner import DraftRunner

                self.draft_runner = DraftRunner(self.draft_cfg, init_random=init_random,
                                                comm=self.model_comm)
            elif config.draft_ranks:
                from ssd_tpu_torch.parallel.draft_rank import DraftRanks

                self.draft_server = DraftRanks(comm, self.draft_cfg)
                self.draft_cfg.num_kvcache_blocks = self.draft_server.num_kvcache_blocks
            elif config.draft_async:
                from ssd_tpu_torch.engine.draft_runner import DraftServer

                self.draft_server = DraftServer(
                    self.draft_cfg, init_random=init_random,
                    batch_pads=self._batch_pads() if self._use_graphs() else None)
            elif config.use_eagle:
                from ssd_tpu_torch.engine.eagle_runner import EagleModelRunner

                self.draft_runner = EagleModelRunner(self.draft_cfg, init_random=init_random)
            else:
                self.draft_runner = ModelRunner(self.draft_cfg, init_random=init_random,
                                                is_draft=True, comm=self.model_comm)
            # Stop the draft thread at interpreter exit if the caller did not.
            atexit.register(lambda ref=weakref.ref(self): ref() and ref().exit())
        self.tokenizer = load_tokenizer(config.model)
        if self.tokenizer is not None and self.tokenizer.eos_token_id is not None:
            config.eos = self.tokenizer.eos_token_id
        self.scheduler = Scheduler(config, draft_cfg=self.draft_cfg)
        self.graphs = None
        if self._use_graphs():
            self._capture_graphs()

    def _use_graphs(self) -> bool:
        """Every mode replays CUDA graphs on the card, unless enforce_eager."""
        return self.model_runner.device.type == "cuda" and not self.config.enforce_eager

    def _batch_pads(self) -> list[int]:
        """The batch buckets: the powers of two up to next_pow2(max_num_seqs)."""
        from ssd_tpu_torch.engine.model_runner import next_pow2

        return [1 << i for i in range(next_pow2(self.config.max_num_seqs).bit_length())]

    def _capture_graphs(self):
        """Capture the decode-side steps of this engine's thread for every
        batch bucket, greedy forms (a sampled form is captured on its first
        use), into one memory pool; the unfused async draft's graphs are in
        its own (DraftServer)."""
        from ssd_tpu_torch.engine.graphs import StepGraphs

        runners = [r for r in (self.model_runner, self.draft_runner) if r is not None]
        self.graphs = StepGraphs(self.model_runner.device, [r.generator for r in runners],
                                 comm=self.model_comm)
        for r in runners:
            r.graphs = self.graphs
        self._default_step = self.create_inference_step()
        self._default_step.capture(self._batch_pads())

    def exit(self):
        """Stop the async draft thread or the draft ranks; under tensor
        parallelism check that every rank emitted the same tokens (raising
        if not) and, at rank 0 of a spawned group, tear the group down and
        join the ranks (idempotent). A caller's group stays the caller's."""
        if self._exiting:
            return
        self._exiting = True
        if self.draft_server is not None:
            self.draft_server.shutdown()
        comm = self.comm
        if comm is None:
            return
        try:
            if comm.workers:
                comm.relay("exit", (), {}, comm.check_tokens)
            else:
                comm.check_tokens()
        finally:
            if comm.owned:
                comm.close()

    @_relayed
    def abort_request(self, seq_id: int) -> bool:
        """Cancel an in-flight or queued request by its seq_id; frees its KV
        blocks at once."""
        return self.scheduler.abort(seq_id)

    @_relayed
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
        if self.comm is not None:
            seq.seq_id = self._next_seq_id
            self._next_seq_id += 1
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

    @_relayed
    def step(self, step: InferenceStep | None = None):
        """One engine step: a prefill or a decode of the scheduled batch.
        Returns the sequences that finished, [(seq_id, completion token
        ids)]. A caller's own `step` object is not relayed to other ranks:
        rank 0 of a spawned group takes the default step only."""
        if step is not None and self.comm is not None and self.comm.workers \
                and not self._relaying:
            raise ValueError("a spawned tensor-parallel engine relays step() without "
                             "a step object only")
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
        outputs = [(seq.seq_id, seq.completion_token_ids) for seq in finished]
        if self.comm is not None:
            self.comm.record_tokens(outputs)
        return outputs

    def is_finished(self):
        return self.scheduler.is_finished()

    def create_inference_step(self) -> InferenceStep:
        config = self.config
        if config.ngram_speculate:
            return NgramSpecDecodeStep(self.scheduler, self.model_runner,
                                       K=config.speculate_k, rounds=config.spec_rounds,
                                       N=config.ngram_n, metrics=METRICS)
        if not config.speculate:
            return AutoRegressiveStep(self.scheduler, self.model_runner,
                                      multi_step=config.multi_step)
        if config.draft_async and config.async_fused:
            from ssd_tpu_torch.engine.async_fused import (
                AsyncExchangeSpecDecodeStep, FusedAsyncSpecDecodeStep)

            cls = (FusedAsyncSpecDecodeStep if config.spec_rounds > 1
                   else AsyncExchangeSpecDecodeStep)
            return cls(self.scheduler, self.model_runner, self.draft_runner, config,
                       metrics=METRICS)
        if not config.draft_async and config.spec_rounds > 1:
            cls = EagleFusedSpecDecodeStep if config.use_eagle else FusedSpecDecodeStep
            return cls(self.scheduler, self.model_runner, self.draft_runner,
                       K=config.speculate_k, rounds=config.spec_rounds, metrics=METRICS)
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
        if self.comm is not None and self.comm.rank != 0:
            return
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

    @_relayed
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
