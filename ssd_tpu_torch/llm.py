"""Public entry point. Counterpart of ssd_tpu/llm.py."""

from ssd_tpu_torch.engine.llm_engine import LLMEngine


class LLM(LLMEngine):
    pass
