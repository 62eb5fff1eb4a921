"""Small host utilities. Counterpart of ssd_tpu/utils/misc.py."""

from __future__ import annotations

import os


def load_tokenizer(model_path: str):
    """Best-effort HF tokenizer load; returns None when the checkpoint has no
    tokenizer files (token-id workloads, tests, random-weight runs) or when
    `transformers` is not installed (the engine then takes token-id prompts
    only, and eos comes from config.json)."""
    has_files = any(
        os.path.exists(os.path.join(model_path, f))
        for f in ("tokenizer.json", "tokenizer_config.json", "tokenizer.model")
    )
    if not has_files:
        return None
    try:
        from transformers import AutoTokenizer
    except ImportError:
        return None

    return AutoTokenizer.from_pretrained(model_path, use_fast=True)
