"""64-bit content hashing for the prefix cache.

Counterpart of ssd_tpu/utils/hashing.py with its blake2b path only: the port
carries no native library. Hashes only need to be deterministic within one
process.
"""

from __future__ import annotations

import hashlib

import numpy as np


def hash64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")


def hash_tokens(token_ids: list[int], prefix: int = -1) -> int:
    """Chain-hash a block of token ids onto the previous block's hash: the
    prefix hash is folded in as 8 little-endian bytes, then the token array
    bytes."""
    buf = b""
    if prefix != -1:
        buf += (prefix & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")
    buf += np.asarray(token_ids, dtype=np.int64).tobytes()
    return hash64(buf)
