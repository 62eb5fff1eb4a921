"""Speculation result containers and strategy base classes.

Counterpart of ssd_tpu/engine/helpers/speculate_types.py. Tensors are torch
tensors (or numpy arrays) instead of jax arrays.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any


@dataclass
class SpeculateResult:
    speculations: Any      # [B, K+1] = [recovery | K draft tokens]
    logits_q: Any          # [B, K, V] draft logits
    cache_hits: Any = None  # [B] {0,1} (async mode only)


@dataclass
class VerifyResult:
    new_suffixes: list[list[int]]
    recovery_tokens: list[int]
    eagle_acts: Any = None  # [B, K+1, 3*D_target] target activations


class SpeculatorBase(ABC):

    def __init__(self, lookahead: int):
        self.lookahead = lookahead

    @abstractmethod
    def speculate(self, seqs, verify_result) -> SpeculateResult: ...

    @abstractmethod
    def prefill(self, seqs, verify_result) -> SpeculateResult: ...


class VerifierBase(ABC):

    def __init__(self, lookahead: int):
        self.lookahead = lookahead

    @abstractmethod
    def verify(self, seqs, speculate_result, eagle: bool = False) -> VerifyResult: ...

    @abstractmethod
    def prefill(self, seqs, eagle: bool = False) -> VerifyResult: ...
