"""Paged KV-cache block allocator with hash-based prefix caching.

Counterpart of ssd_tpu/engine/block_manager.py: free list and refcounts,
chained block hashing for prefix reuse, lookahead-aware can_append/may_append,
and the `is_draft` switch selecting which block table of a Sequence it
manages. The cache itself is one device tensor owned by the model runner;
this class only manages block ids on the host.
"""

from collections import deque

from ssd_tpu_torch.engine.sequence import Sequence
from ssd_tpu_torch.utils.hashing import hash_tokens


class Block:
    __slots__ = ("block_id", "ref_count", "hash", "token_ids")

    def __init__(self, block_id: int):
        self.block_id = block_id
        self.ref_count = 0
        self.hash = -1
        self.token_ids: list[int] = []

    def update(self, hash_: int, token_ids: list[int]):
        self.hash = hash_
        self.token_ids = token_ids

    def reset(self):
        self.ref_count = 1
        self.hash = -1
        self.token_ids = []


class BlockManager:

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        is_draft: bool = False,
        speculate_k: int = -1,
        max_model_len: int = -1,
        verbose: bool = False,
    ):
        assert num_blocks > 0
        self.block_size = block_size
        self.blocks = [Block(i) for i in range(num_blocks)]
        self.hash_to_block_id: dict[int, int] = {}
        # Free list with LAZY deletion: reactivating a specific free block on
        # a prefix-cache hit just marks it used; its stale deque entry is
        # skipped at pop time. This makes every allocator op O(1) amortised
        # where the reference's deque.remove (block_manager.py:68) is O(n).
        self.free_block_ids: deque[int] = deque(range(num_blocks))
        self.num_free = num_blocks
        self.used_block_ids: set[int] = set()
        self.is_draft = is_draft
        self.speculate_k = speculate_k
        self.verbose = verbose
        self.max_model_len = max_model_len

    @classmethod
    def compute_hash(cls, token_ids: list[int], prefix: int = -1) -> int:
        return hash_tokens(token_ids, prefix)

    def _table(self, seq: Sequence) -> list[int]:
        return seq.draft_block_table if self.is_draft else seq.block_table

    def _allocate_block(self, block_id: int) -> Block:
        block = self.blocks[block_id]
        assert block.ref_count == 0
        block.reset()
        self.used_block_ids.add(block_id)
        self.num_free -= 1
        return block

    def _pop_free_id(self) -> int:
        while True:
            block_id = self.free_block_ids.popleft()
            if block_id not in self.used_block_ids:
                return block_id  # skip stale entries (lazily deleted)

    def _allocate_n_blocks(self, n: int) -> list[Block]:
        if self.num_free < n:
            raise RuntimeError(
                f"Insufficient free blocks: need {n}, have {self.num_free}"
            )
        return [self._allocate_block(self._pop_free_id()) for _ in range(n)]

    def _deallocate_block(self, block_id: int):
        assert self.blocks[block_id].ref_count == 0
        self.used_block_ids.remove(block_id)
        self.free_block_ids.append(block_id)
        self.num_free += 1

    def deallocate_ids(self, block_ids: list[int]):
        """Drop one reference from each block; free those that hit zero."""
        for block_id in block_ids:
            block = self.blocks[block_id]
            block.ref_count -= 1
            if block.ref_count == 0:
                self._deallocate_block(block_id)

    def can_allocate(self, seq: Sequence) -> bool:
        return self.num_free >= seq.num_blocks

    def allocate(self, seq: Sequence, publish: bool = True):
        """Allocate (and prefix-cache match) blocks for the whole prompt.

        publish=False allocates without advertising the new blocks' hashes:
        a chunked prefill (Config.chunked_prefill) allocates its full prompt
        upfront but writes KV over several dispatches, and another sequence
        must not prefix-hit a block whose KV does not exist yet — the
        scheduler's _finalize_full_blocks publishes them once the prompt is
        fully prefilled (blocks keep hash == -1 until then)."""
        block_table = self._table(seq)
        assert not block_table
        h = -1
        cache_miss = False

        for i in range(seq.num_blocks):
            token_ids = seq.block(i)
            h = self.compute_hash(token_ids, h) if len(token_ids) == self.block_size else -1
            block_id = self.hash_to_block_id.get(h, -1)
            if block_id == -1 or self.blocks[block_id].token_ids != token_ids:
                cache_miss = True
            if cache_miss:
                block_id = self._pop_free_id()
                block = self._allocate_block(block_id)
            else:  # prefix-cache hit
                if self.is_draft:
                    seq.num_draft_cached_tokens += self.block_size
                else:
                    seq.num_cached_tokens += self.block_size
                if block_id in self.used_block_ids:
                    block = self.blocks[block_id]
                    block.ref_count += 1
                else:
                    block = self._allocate_block(block_id)
            if h != -1 and publish:
                block.update(h, token_ids)
                self.hash_to_block_id[h] = block_id
            block_table.append(block_id)

    def deallocate(self, seq: Sequence):
        block_table = self._table(seq)
        for block_id in reversed(block_table):
            block = self.blocks[block_id]
            block.ref_count -= 1
            if block.ref_count == 0:
                self._deallocate_block(block_id)

        if self.is_draft:
            seq.num_draft_cached_tokens = 0
        else:
            seq.num_cached_tokens = 0

        block_table.clear()

    def can_append(self, seq: Sequence, lookahead_num_tokens: int = 1) -> bool:
        block_table = self._table(seq)
        if seq.num_tokens + lookahead_num_tokens > self.max_model_len:
            return False
        target_blocks = (
            seq.num_tokens + lookahead_num_tokens + self.block_size - 1
        ) // self.block_size
        if target_blocks > len(block_table):
            return self.num_free >= target_blocks - len(block_table)
        return True

    def may_append(self, seq: Sequence, lookahead_num_tokens: int = 1):
        block_table = self._table(seq)
        target_blocks = (
            seq.num_tokens + lookahead_num_tokens + self.block_size - 1
        ) // self.block_size
        if target_blocks > len(block_table):
            needed = target_blocks - len(block_table)
            for block in self._allocate_n_blocks(needed):
                block_table.append(block.block_id)
