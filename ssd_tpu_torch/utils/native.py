"""Host-side input preparation for the step programs.

Counterpart of the numpy branches of ssd_tpu/utils/native.py (the port has no
native host library; the module keeps its name so a reader finds the JAX
counterpart).
"""

from __future__ import annotations

import numpy as np


def prepare_multi_query(tail_tokens: np.ndarray, num_tokens: np.ndarray,
                        block_tables: np.ndarray, q_len: int, block_size: int):
    """Batched decode input prep, one row per sequence. Returns (input_ids,
    positions, slot_map, context_lens) int32 arrays."""
    pos = (num_tokens[:, None] - q_len + np.arange(q_len)[None, :])  # [B, q]
    blk = np.take_along_axis(block_tables, pos // block_size, axis=1)
    slots = np.where(blk < 0, -1, blk * block_size + pos % block_size)
    return (tail_tokens.reshape(-1).astype(np.int32), pos.reshape(-1).astype(np.int32),
            slots.reshape(-1).astype(np.int32), num_tokens.astype(np.int32))


def prepare_prefill(block_table: np.ndarray, cached: int, n_new: int,
                    block_size: int):
    """Single-sequence prefill positions and slots of its n_new new tokens."""
    p = cached + np.arange(n_new, dtype=np.int32)
    blk = block_table[p // block_size]
    return p, np.where(blk < 0, -1, blk * block_size + p % block_size).astype(np.int32)
