"""ssd_tpu_torch: the PyTorch/CUDA port of ssd_tpu for NVIDIA Hopper GPUs.

A second package beside the JAX one, which stays the reference. It imports
PyTorch and never JAX or anything of ssd_tpu. Ported so far: autoregressive
serving (also multi-step), sync speculative decoding (also with fused
rounds), ngram speculation and async tree speculation (unfused, with a plain
or an EAGLE-3 draft) of dense Llama-3 / Qwen-3 and of Qwen3-MoE checkpoints
through `LLM(...).generate`, with paged KV (bf16/fp32 or int8), prefix
caching, continuous batching, preemption and chunked prefill; attention and
the MoE experts' grouped GEMM run in hand-written CUDA kernels on the GPU
(ops/attention.py, ops/moe.py, csrc/) and in their plain PyTorch versions on
the CPU, and the sync modes' decode-side steps replay CUDA graphs
(engine/graphs.py). num_devices=N shards one model over N processes, one
per card (parallel/: tensor parallelism, expert parallelism of Qwen3-MoE,
a vocabulary-parallel embedding and head). The engine runs on "cuda"
unless the caller passes device="cpu".
"""

from ssd_tpu_torch.config import Config, ModelConfig
from ssd_tpu_torch.engine.sequence import Sequence, SequenceStatus
from ssd_tpu_torch.sampling_params import SamplingParams

__all__ = [
    "Config",
    "ModelConfig",
    "SamplingParams",
    "Sequence",
    "SequenceStatus",
    "LLM",
    "LLMEngine",
    "METRICS",
]


def __getattr__(name):
    # Lazy import: `import ssd_tpu_torch` stays light for host-only users.
    if name == "LLM":
        from ssd_tpu_torch.llm import LLM

        return LLM
    if name in ("LLMEngine", "METRICS"):
        from ssd_tpu_torch.engine import llm_engine

        return getattr(llm_engine, name)
    raise AttributeError(name)
