"""The card's published peaks and its name and power limit, in one place for
chip_smoke.py and the bench tools.

The rates are NVIDIA's data sheet for the H100 SXM part (dense, without
sparsity) at its full power limit of 700 W; a card set below that limit runs
slower under load, so every tool prints the limit beside its numbers.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # fp32 outside the tensor cores
PEAK_OPS_INT8 = 1979e12            # dense int8 tensor-core rate (kv_quant int8_mxu)


def name_and_power_limit() -> str:
    """The first card's line of `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"), or
    "not read" where nvidia-smi is missing or fails."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    lines = smi.stdout.strip().splitlines()
    return lines[0].strip() if smi.returncode == 0 and lines else "not read"


def device_fields(device) -> dict:
    """{"device": the card's name (or "cpu"), "power_limit": its limit as
    nvidia-smi gives it (None on the CPU or where it was not read)}, the
    fields every tool adds to its JSON line."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    import torch

    line = name_and_power_limit()
    limit = line.rsplit(",", 1)[1].strip() if "," in line else None
    return {"device": torch.cuda.get_device_name(device), "power_limit": limit}
