"""Engine configuration.

Counterpart of ssd_tpu/config.py, cut to the fields of the ported modes:
autoregressive decoding (AR), sync speculative decoding (SD) and async tree
speculation (SSD), each plain and fused. Differences from the JAX package:

- there is no `use_pallas` knob: a CUDA tensor goes through the hand-written
  kernel and a CPU tensor through its plain PyTorch version
  (ssd_tpu_torch/ops/attention.py);
- `gpu_memory_utilization` replaces `hbm_memory_utilization`; the KV pool is
  sized from `torch.cuda.mem_get_info()` (engine/model_runner.py);
- `device` names where the engine runs: "cuda" unless the caller asks for
  "cpu". Without a GPU and without device="cpu" the engine raises;
- `draft` has no default checkpoint: speculate=True needs a draft path;
- Qwen3-MoE checkpoints are served with a uniform stack only (every layer
  sparse), as the JAX package asserts; a non-uniform one is refused here;
- `enforce_eager` is served: on "cuda" the decode-side steps of AR
  (multi_step included), sync SD (spec_rounds 1 and > 1), ngram
  speculation, async SSD (unfused, the fused exchange and the fused
  superstep) and EAGLE-3 (async, and the fused sync superstep) run as CUDA
  graphs captured at engine init (engine/graphs.py) unless it is True; on
  "cpu" every step runs eagerly;
- `quantization="int8"` (weight-only int8, utils/quant.py) serves every
  mode; the draft config inherits it, as in the JAX package;
- `num_devices` > 1 serves one model sharded over that many processes,
  one per card (parallel/: tensor parallelism of the attention and the
  MLP, expert parallelism of Qwen3-MoE, a vocabulary-parallel embedding
  and head), with the sync draft or the fused forms' inline draft sharded
  over the same ranks. The unfused async draft takes the last `draft_dp`
  devices, as in the JAX package: `tp_size` = max(1, num_devices -
  draft_dp) ranks hold the target and, when num_devices >= tp_size +
  draft_dp, each draft replica runs in a process of its own on a card of
  its own (parallel/draft_rank.py); with fewer devices the replicas share
  the target's card (engine/draft_runner.py::DraftServer);
- not ported yet, and refused here with the ROADMAP item: EAGLE-3 under
  tensor parallelism and `num_hosts` > 1; so is a speculative knob on an
  engine that does not use it, where it would be ignored.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace


@dataclass
class ModelConfig:
    """Subset of an HF `config.json` the engine needs, parsed without transformers."""

    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int | None = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    torch_dtype: str = "bfloat16"
    eos_token_id: int | list[int] | None = None
    bos_token_id: int | None = None
    attention_bias: bool = False
    # EAGLE-3 draft checkpoints carry a reduced LM-head vocabulary.
    draft_vocab_size: int | None = None
    # Mixture-of-experts (qwen3_moe): every decoder layer is sparse; the
    # router picks num_experts_per_tok of num_experts experts per token.
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = False
    decoder_sparse_step: int = 1
    mlp_only_layers: list[int] | None = None

    def __post_init__(self):
        if self.num_experts and (self.decoder_sparse_step != 1 or self.mlp_only_layers):
            raise NotImplementedError(
                "MoE needs a uniform layer stack (decoder_sparse_step=1 and no "
                f"mlp_only_layers), got decoder_sparse_step="
                f"{self.decoder_sparse_step}, mlp_only_layers={self.mlp_only_layers}")

    @property
    def head_dim_actual(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.hidden_size // self.num_attention_heads

    @property
    def eos(self) -> int:
        e = self.eos_token_id
        if isinstance(e, list):
            return e[0]
        return -1 if e is None else e

    @classmethod
    def from_pretrained(cls, model_path: str) -> "ModelConfig":
        with open(os.path.join(model_path, "config.json")) as f:
            raw = json.load(f)
        known = {f_.name for f_ in cls.__dataclass_fields__.values()}  # type: ignore[attr-defined]
        kwargs = {k: v for k, v in raw.items() if k in known}
        return cls(**kwargs)


@dataclass
class Config:
    model: str
    max_num_batched_tokens: int = 16384
    max_num_seqs: int = 1
    max_model_len: int = 4096
    gpu_memory_utilization: float = 0.7
    device: str = "cuda"
    # Tensor (and expert) parallelism: the model sharded over this many
    # processes, one per card (parallel/comm.py); 1 makes no process group.
    num_devices: int = 1
    num_hosts: int = 1
    hf_config: ModelConfig | None = None
    eos: int = -1
    kvcache_block_size: int = 256
    num_kvcache_blocks: int = -1
    dtype: str = "bfloat16"
    seed: int = 0
    # Nucleus / top-k warp at sampling; requests with top_p < 1 or top_k > 0
    # on an engine built without it are refused at add_request.
    enable_top_sampling: bool = False
    # Admit a prompt longer than the per-dispatch token budget in
    # budget-sized chunks, interleaving decode steps between chunks.
    chunked_prefill: bool = False
    # int8 KV cache: int8 rows plus one f32 scale per (token, head, K|V),
    # (hd + 4) bytes where bf16 takes 2 * hd (ops/attention.py). It is
    # approximate against the fp cache but deterministic: the same context
    # always quantizes to the same cache bytes, so AR, SD and SSD agree.
    # "int8": the kernels dequantize in fp32 arithmetic.
    # "int8_mxu": decode, verify and tree steps take the TPU's s8 arithmetic
    #   (q and the softmax weights quantized, integer dots); approximate
    #   against "int8" (csrc/paged_attention_int8.cu). Prefill is "int8"'s.
    # Both apply to the draft's cache too.
    kv_quant: str | None = None
    # Weight-only int8: "int8" quantizes every matmul weight, the embedding
    # and the LM head at load to int8 with fp32 scales per output channel
    # (utils/quant.py), in the target and the draft; their products run the
    # W8A16 kernel (ops/linear.py). None keeps the weights in `dtype`.
    quantization: str | None = None
    verbose: bool = False
    # Run the decode-side steps eagerly on the card instead of replaying
    # their CUDA graphs (engine/graphs.py). The CPU always runs eagerly.
    enforce_eager: bool = False
    # AR multi-step decoding: sample this many tokens per engine step from
    # one chain (one graph replay); EOS overshoot is truncated and rolled
    # back like a rejected speculation.
    multi_step: int = 1

    # Speculative decoding. speculate=True serves sync SD with the `draft`
    # checkpoint, spec_rounds > 1 of its rounds fused per engine step
    # (engine/fused_sd.py); draft_async=True serves async SSD (a draft
    # thread builds the speculation tree while the target verifies);
    # draft_async with async_fused=True runs the draft inline, verify and the
    # next tree build in one step (engine/async_fused.py): one exchange a
    # step, or with spec_rounds > 1 that many exchanges and the tree-cache
    # match in one superstep. draft_dp > 1 splits the unfused async
    # draft's rows by seq_id % draft_dp over that many replicas, each with
    # its own KV pool and tree cache. ngram_speculate=True
    # (without speculate) proposes speculate_k tokens a round by matching
    # the last ngram_n tokens against the sequence's own history, in
    # spec_rounds fused rounds, with no draft model. use_eagle=True serves
    # an EAGLE-3 draft in async SSD (draft_async with jit_speculate) or in
    # the fused sync superstep (spec_rounds > 1): it is conditioned on the
    # target's residual stream entering the layers `eagle_layers` (default
    # [2, L//2, L-3]); `d_model_target` is the target's width and
    # `tokenizer_path` the target checkpoint the draft borrows its
    # embeddings from when it ships none (both set by create_draft_config).
    draft_hf_config: ModelConfig | None = None
    speculate: bool = False
    draft: str | None = None
    speculate_k: int = 1
    draft_async: bool = False
    async_fan_out: int = 3
    fan_out_list: list[int] | None = None
    fan_out_list_miss: list[int] | None = None
    sampler_x: float | None = None
    jit_speculate: bool = False
    async_fused: bool = False
    spec_rounds: int = 1
    use_eagle: bool = False
    eagle_layers: list[int] | None = None
    d_model_target: int | None = None
    tokenizer_path: str | None = None
    ngram_speculate: bool = False
    ngram_n: int = 3
    draft_dp: int = 1

    MQ_LEN: int = field(default=0, init=False)

    @property
    def max_blocks(self) -> int:
        return (self.max_model_len + self.kvcache_block_size - 1) // self.kvcache_block_size

    @property
    def tp_size(self) -> int:
        """Ranks the target is sharded over: the unfused async draft takes
        the last draft_dp devices (ssd_tpu/config.py::tp_size); every other
        mode shards its draft beside the target on all of them."""
        if not self._unfused_async:
            return self.num_devices
        return max(1, self.num_devices - self.draft_dp)

    @property
    def draft_ranks(self) -> int:
        """Processes that each run one draft replica on a card of their own
        (ranks tp_size..tp_size + draft_dp - 1): draft_dp when num_devices
        holds the target's ranks and the replicas, else 0 (the replicas
        share the target's card, as ssd_tpu/engine/draft_runner.py puts
        them on the target's device)."""
        if not self._unfused_async:
            return 0
        return self.draft_dp if self.num_devices >= self.tp_size + self.draft_dp else 0

    @property
    def world_size(self) -> int:
        """Processes of the engine: the target's ranks and the draft ranks."""
        return self.tp_size + self.draft_ranks

    @property
    def draft_replicas_here(self) -> int:
        """Draft models beside the target on each of its cards: the
        unfused async draft's draft_dp replicas when they share it, none
        when they run on ranks of their own, else the one draft."""
        if self._unfused_async:
            return 0 if self.draft_ranks else self.draft_dp
        return 1

    @property
    def _unfused_async(self) -> bool:
        """The async draft with a server of its own (draft_dp replicas)."""
        return self.speculate and self.draft_async and not self.async_fused

    def __post_init__(self):
        if not os.path.isdir(self.model):
            raise ValueError(f"model path does not exist: {self.model}")
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype must be bfloat16 or float32, got {self.dtype!r}")
        if self.kv_quant not in (None, "int8", "int8_mxu"):
            raise ValueError(f"unknown kv_quant {self.kv_quant!r} "
                             "(None, 'int8' or 'int8_mxu')")
        if self.quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization {self.quantization!r} (None or 'int8')")
        if self.async_fused and self.speculate:
            # The JAX package's rules (ssd_tpu/config.py): the fused forms
            # run the draft inline beside the target, with one draft.
            if not self.draft_async:
                raise ValueError("async_fused requires draft_async=True")
            if self.use_eagle:
                raise ValueError("async_fused excludes use_eagle (EAGLE's fused form "
                                 "is the sync superstep)")
            if self.draft_dp > 1:
                raise ValueError("async_fused excludes draft_dp > 1 (the fused forms "
                                 "run one draft inline)")
        if self.use_eagle and self.draft_async and self.spec_rounds > 1:
            raise ValueError("spec_rounds > 1 with use_eagle runs the fused sync "
                             "superstep; it excludes draft_async")
        if self.speculate and self.draft_async and self.spec_rounds > 1 \
                and not self.async_fused:
            raise ValueError("spec_rounds > 1 with draft_async needs async_fused=True "
                             "(the async superstep)")
        self._refuse_unported_parallelism()
        for name in ("multi_step", "spec_rounds", "speculate_k", "ngram_n"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.ngram_speculate and self.speculate:
            raise ValueError("ngram_speculate is model-free; it excludes speculate "
                             "(pick one proposal source)")
        if self.multi_step > 1 and (self.speculate or self.ngram_speculate):
            raise ValueError("multi_step applies to AR decoding; it needs neither "
                             "speculate nor ngram_speculate")
        spec_only = {
            "draft": self.draft is not None,
            "draft_async": self.draft_async,
            "speculate_k": self.speculate_k != 1,
            "spec_rounds": self.spec_rounds != 1,
            "async_fan_out": self.async_fan_out != 3,
            "fan_out_list": self.fan_out_list is not None,
            "fan_out_list_miss": self.fan_out_list_miss is not None,
            "sampler_x": self.sampler_x is not None,
            "jit_speculate": self.jit_speculate,
            "async_fused": self.async_fused,
            "use_eagle": self.use_eagle,
            "draft_dp": self.draft_dp != 1,
        }
        if not self.speculate:
            # ngram speculation takes speculate_k and spec_rounds.
            ignored = [k for k, v in spec_only.items() if v and not (
                self.ngram_speculate and k in ("speculate_k", "spec_rounds"))]
            if ignored:
                raise ValueError(f"{', '.join(ignored)} need speculate=True")
        elif not self.draft_async:
            ignored = [k for k in ("async_fan_out", "fan_out_list",
                                   "fan_out_list_miss", "sampler_x",
                                   "jit_speculate", "draft_dp") if spec_only[k]]
            if ignored:
                raise ValueError(f"{', '.join(ignored)} need draft_async=True")
        if self.ngram_n != 3 and not self.ngram_speculate:
            raise ValueError("ngram_n needs ngram_speculate=True")

        self.hf_config = ModelConfig.from_pretrained(self.model)
        self.max_model_len = min(self.max_model_len, self.hf_config.max_position_embeddings)
        if self.speculate:
            self._derive_speculative()
        if self.use_eagle:
            self._derive_eagle()
        if self.eos == -1:
            self.eos = self.hf_config.eos
        # Without chunking, a batch-head prefill must fit one dispatch
        # (scheduler admission can never livelock at the queue head).
        if not (self.chunked_prefill
                or self.max_num_batched_tokens >= self.max_model_len):
            raise ValueError(
                "max_num_batched_tokens < max_model_len requires chunked_prefill")

    def _refuse_unported_parallelism(self):
        """The parallel forms of ROADMAP Queue 1 not ported yet."""
        if self.num_devices < 1 or self.num_hosts < 1 or self.draft_dp < 1:
            raise ValueError(f"num_devices, num_hosts and draft_dp must be >= 1, got "
                             f"{self.num_devices}, {self.num_hosts} and {self.draft_dp}")
        todo = "not ported to ssd_tpu_torch yet (ROADMAP Queue 1 item {}, Parallelism: {})"
        if self.num_devices > 1 and self.use_eagle:
            raise NotImplementedError(todo.format(1, "EAGLE-3 under tensor parallelism"))
        if self.num_hosts > 1:
            raise NotImplementedError(todo.format(
                3, "num_hosts > 1, and the multi-host union of draft replies"))

    def _derive_speculative(self):
        """Draft config and tree geometry, as ssd_tpu/config.py derives them,
        plus the block-size rule of ssd_tpu/engine/llm_engine.py."""
        if self.draft is None or not os.path.isdir(self.draft):
            raise ValueError(f"speculate=True needs an existing draft checkpoint "
                             f"directory, got draft={self.draft!r}")
        if self.speculate_k < 1:
            raise ValueError(f"speculate_k must be >= 1, got {self.speculate_k}")
        if self.kvcache_block_size < 2 * self.speculate_k + 2:
            raise ValueError("kvcache_block_size must be >= 2*speculate_k+2")
        self.draft_hf_config = ModelConfig.from_pretrained(self.draft)
        d = self.draft_hf_config
        # An EAGLE-3 head is written as a llama layer whatever its target.
        same_family = self.use_eagle or d.model_type == self.hf_config.model_type
        if not same_family or d.vocab_size != self.hf_config.vocab_size:
            raise ValueError("target and draft must share a model family and vocabulary, "
                             f"got {self.hf_config.model_type}/{self.hf_config.vocab_size} "
                             f"and {d.model_type}/{d.vocab_size}")
        self.max_model_len = min(self.max_model_len, d.max_position_embeddings)
        if self.draft_async:
            if self.fan_out_list is None:
                self.fan_out_list = [self.async_fan_out] * (self.speculate_k + 1)
            if self.fan_out_list_miss is None:
                self.fan_out_list_miss = list(self.fan_out_list)
            for name in ("fan_out_list", "fan_out_list_miss"):
                if len(getattr(self, name)) != self.speculate_k + 1:
                    raise ValueError(f"{name} needs speculate_k+1 entries")
            if sum(self.fan_out_list_miss) != sum(self.fan_out_list):
                raise ValueError("fan_out_list_miss must sum to the same MQ_LEN "
                                 "as fan_out_list")
            self.MQ_LEN = sum(self.fan_out_list)

    def _derive_eagle(self):
        """EAGLE-3 rules and defaults of ssd_tpu/config.py and
        ssd_tpu/engine/llm_engine.py: EAGLE runs async or in the fused sync
        superstep; the async form needs jit_speculate (a cache miss needs
        the draft's activations); the draft takes the target's rope and
        position limit."""
        if not (self.draft_async or self.spec_rounds > 1):
            raise ValueError("use_eagle runs either async (draft_async=True) or in "
                             "the fused sync superstep (spec_rounds > 1)")
        if self.draft_async and not self.jit_speculate:
            raise ValueError("EAGLE requires jit_speculate=True (cache misses "
                             "need draft activations)")
        if self.model == self.draft:
            return  # the draft's own config (create_draft_config)
        L = self.hf_config.num_hidden_layers
        if self.eagle_layers is None:
            self.eagle_layers = [2, L // 2, L - 3]
        if not all(0 <= t < L for t in self.eagle_layers):
            raise ValueError(f"eagle_layers {self.eagle_layers} outside the "
                             f"target's {L} layers")
        if self.d_model_target is None:
            self.d_model_target = self.hf_config.hidden_size
        self.draft_hf_config.rope_theta = self.hf_config.rope_theta
        self.draft_hf_config.max_position_embeddings = \
            self.hf_config.max_position_embeddings

    def create_draft_config(self) -> "Config":
        """Config of a draft model runner. Beside the target on its card
        (the sync and fused drafts, on every rank under num_devices > 1,
        and the unfused async draft's draft_dp replicas when they share the
        card) each draft pool keeps the target's block count: the engine
        sizes the pools together (engine/model_runner.py::
        _decide_num_blocks). A draft rank of its own sizes its pool from
        its card, as the JAX package's replica does on its chip, and the
        scheduler takes the smallest count over the ranks
        (parallel/draft_rank.py). An EAGLE draft's model config is the one
        derived here (the target's rope), and it borrows the target's
        embeddings when it has none."""
        if not self.use_eagle:
            return replace(self, model=self.draft)
        cfg = replace(self, model=self.draft, tokenizer_path=self.model)
        cfg.hf_config = self.draft_hf_config
        return cfg
