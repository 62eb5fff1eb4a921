"""Per-request sequence state.

Counterpart of ssd_tpu/engine/sequence.py, kept as its own copy so the port
imports nothing of the JAX package: dual target/draft block tables, spec-step
bookkeeping and EAGLE carries, as a plain attribute bag whose persistence and
cloning derive from ``vars()``. EAGLE activations are numpy arrays, so the
host engine stays framework-free.

Block-geometry note: ``last_block_num_tokens`` measures the fill of the last
*cached* block; the runner consults it between the cached prefix and freshly
appended tokens, which is why it is defined against ``num_cached_blocks``.
"""

from copy import copy
from enum import Enum, auto
from itertools import count

from ssd_tpu_torch.sampling_params import SamplingParams


class SequenceStatus(Enum):
    WAITING = auto()
    RUNNING = auto()
    FINISHED = auto()


def _blocks_needed(num_tokens: int, block_size: int) -> int:
    return -(-num_tokens // block_size)


class Sequence:
    counter = count()
    block_size = 256  # overwritten from Config at engine init

    def __init__(self, token_ids: list[int], sampling_params: SamplingParams | None = None):
        sp = sampling_params or SamplingParams()
        self.seq_id = next(Sequence.counter)
        self.status = SequenceStatus.WAITING

        # --- token state ---
        self.token_ids = list(token_ids)
        self.num_tokens = len(self.token_ids)
        self.last_token = self.token_ids[-1]
        # num_prompt_tokens is the scheduler's re-prefill boundary and moves
        # on preemption (completions are absorbed as "new prompt");
        # orig_num_prompt_tokens is the REQUEST's boundary and never moves, so
        # outputs and max_new_tokens accounting survive preemption (the
        # reference drops pre-preemption completions and over-generates).
        self.num_prompt_tokens = self.num_tokens
        self.orig_num_prompt_tokens = self.num_tokens

        # --- target-model KV state ---
        self.num_cached_tokens = 0
        self.block_table: list[int] = []

        # --- draft-model KV state (speculation) ---
        self.draft_block_table: list[int] = []
        self.num_draft_cached_tokens = 0
        # -1 on the first request forces a draft tree-cache miss.
        self.last_spec_step_accepted_len = -1
        self.recovery_token_id: int | None = None

        # --- chunked prefill (Config.chunked_prefill) ---
        # Non-None while a partial prefill dispatch is scheduled: the runner
        # prefills at most this many new tokens and the sequence stays in the
        # waiting queue until the whole prompt is in KV.
        self.prefill_chunk: int | None = None
        # Blocks were allocated without publishing prefix-cache hashes (their
        # KV is not written yet); published when the prompt completes.
        self.defer_publish = False

        # --- sampling knobs (flattened off SamplingParams) ---
        self.temperature = sp.temperature
        self.draft_temperature = sp.draft_temperature
        self.max_new_tokens = sp.max_new_tokens
        self.ignore_eos = sp.ignore_eos
        self.top_p = sp.top_p
        self.top_k = sp.top_k

        # --- EAGLE conditioning carries (taps: fp32 tensors on the target's
        # device; token ids: numpy) ---
        self.last_target_hidden_state = None  # [3*D_target]
        self.extend_eagle_acts = None         # [n_ext, 3*D_target]
        self.extend_token_ids = None          # [n_ext]
        self.extend_count = 0

    # --- container protocol ---

    def __len__(self):
        return self.num_tokens

    def __getitem__(self, key):
        return self.token_ids[key]

    # --- derived views ---

    @property
    def is_finished(self):
        return self.status == SequenceStatus.FINISHED

    @property
    def num_completion_tokens(self):
        return self.num_tokens - self.orig_num_prompt_tokens

    @property
    def prompt_token_ids(self):
        return self.token_ids[: self.orig_num_prompt_tokens]

    @property
    def completion_token_ids(self):
        return self.token_ids[self.orig_num_prompt_tokens:]

    # --- block geometry ---

    @property
    def num_blocks(self):
        return _blocks_needed(self.num_tokens, self.block_size)

    @property
    def num_cached_blocks(self):
        return _blocks_needed(self.num_cached_tokens, self.block_size)

    @property
    def num_draft_cached_blocks(self):
        return _blocks_needed(self.num_draft_cached_tokens, self.block_size)

    @property
    def last_block_num_tokens(self):
        return self.num_tokens - (self.num_cached_blocks - 1) * self.block_size

    @property
    def last_block_num_tokens_draft(self):
        return self.num_tokens - (self.num_draft_cached_blocks - 1) * self.block_size

    def block(self, i: int) -> list[int]:
        assert 0 <= i < self.num_blocks
        lo = i * self.block_size
        return self.token_ids[lo: lo + self.block_size]

    # --- mutation ---

    def append_token(self, token_id: int):
        self.token_ids.append(token_id)
        self.last_token = token_id
        self.num_tokens += 1

    # --- snapshot / clone (all state lives in instance attrs, so persistence
    # is just vars(); values are shallow-copied so the clone's lists/arrays
    # detach from the original) ---

    def _state(self) -> dict:
        return {name: copy(value) for name, value in vars(self).items()}

    def clone_spec(self) -> "Sequence":
        dup = object.__new__(Sequence)
        dup.__dict__.update(self._state())
        return dup

    def __getstate__(self):
        return self._state()

    def __setstate__(self, state):
        self.__dict__.update(state)
