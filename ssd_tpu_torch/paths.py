"""Paths read from environment variables.

The port's own copy of ssd_tpu/paths.py: the Hugging Face cache and the
dataset directory (SSD_HF_CACHE, SSD_DATASET_DIR), the default target and
draft checkpoints (SSD_DEFAULT_TARGET, SSD_DEFAULT_DRAFT, else the newest
snapshot of the default repositories in the cache, else the repository id)
and the datasets' paths. It reads the environment when imported, and
downloads nothing.
"""

import os
from pathlib import Path

HF_CACHE_DIR = os.environ.get(
    "SSD_HF_CACHE", os.path.expanduser("~/.cache/huggingface/hub")
)
DATASET_DIR = os.environ.get(
    "SSD_DATASET_DIR", os.path.expanduser("~/data/datasets")
)


def _snapshot(repo: str) -> str:
    """The newest snapshot directory of `repo` in HF_CACHE_DIR, else the
    repository id (Config then refuses a path that does not exist)."""
    base = Path(HF_CACHE_DIR) / f"models--{repo.replace('/', '--')}" / "snapshots"
    if base.is_dir():
        snaps = sorted(base.iterdir())
        if snaps:
            return str(snaps[-1])
    return repo


DEFAULT_TARGET = os.environ.get(
    "SSD_DEFAULT_TARGET", _snapshot("meta-llama/Llama-3.1-8B-Instruct")
)
DEFAULT_DRAFT = os.environ.get(
    "SSD_DEFAULT_DRAFT", _snapshot("meta-llama/Llama-3.2-1B-Instruct")
)

DATASET_PATHS = {
    name: os.path.join(DATASET_DIR, f"{name}.jsonl")
    for name in ("humaneval", "alpaca", "c4", "gsm8k", "ultrafeedback")
}
