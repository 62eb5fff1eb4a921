"""Host-side input preparation for the step programs.

Counterpart of the numpy branches of ssd_tpu/utils/native.py (the port has no
native host library; the module keeps its name so a reader finds the JAX
counterpart).
"""

from __future__ import annotations

import numpy as np


def slot_of(block_tables: np.ndarray, positions: np.ndarray,
            b_of_row: np.ndarray, block_size: int) -> np.ndarray:
    """Flat cache slot of each (row, position), computed on the host; -1
    where the table entry is -1 (ghost rows, padding) or the position falls
    past the table (context-limit overshoot, which must not clamp onto the
    last real block). Counterpart of ssd_tpu/engine/model_runner.py::slot_of."""
    M = block_tables.shape[1]
    blk = positions // block_size
    blk_ids = block_tables[b_of_row, np.minimum(blk, M - 1)]
    slot = blk_ids * block_size + positions % block_size
    return np.where((blk_ids < 0) | (blk >= M), -1, slot).astype(np.int32)


def prepare_prefill(block_table: np.ndarray, cached: int, n_new: int,
                    block_size: int):
    """Single-sequence prefill positions and slots of its n_new new tokens."""
    p = cached + np.arange(n_new, dtype=np.int32)
    blk = block_table[p // block_size]
    return p, np.where(blk < 0, -1, blk * block_size + p % block_size).astype(np.int32)
