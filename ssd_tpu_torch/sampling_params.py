"""Per-request sampling parameters.

Counterpart of ssd_tpu/sampling_params.py (same fields). top-p / top-k
filtering needs an engine built with Config.enable_top_sampling.
"""

from dataclasses import dataclass


@dataclass
class SamplingParams:
    temperature: float = 1.0
    draft_temperature: float | None = None
    max_new_tokens: int = 256
    ignore_eos: bool = False
    top_p: float = 1.0   # nucleus filtering; 1.0 = off
    top_k: int = 0       # keep the k highest-probability tokens; 0 = off
