"""Per-model execution: weights, the paged KV cache, and the two step
functions of the autoregressive path.

Counterpart of ssd_tpu/engine/model_runner.py, AR subset:
- the KV cache is one [L, Hkv, S, 2*hd] tensor with K and V interleaved on
  the last axis, as in JAX, so caches compare 1:1; the steps update it in
  place;
- `flat_prefill_step` runs a whole mixed-length prefill batch as one forward
  whose attention is ops/attention.py::flat_prefill_attention;
- `decode_step` runs a batch of q_len-token decodes whose attention is
  ops/attention.py::paged_attention;
- host input prep stays in numpy; the JAX package's packed int32 payloads (a
  TPU transfer workaround) are not ported, each input is its own tensor.
Not ported yet: the grouped prefill (`batched_prefill_step`), the
multi-token chain (`chain_decode_step`), CUDA-graph capture.
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tpu_torch.config import Config
from ssd_tpu_torch.engine.sequence import Sequence
from ssd_tpu_torch.models.transformer import Arch, compute_logits, forward_hidden, init_params
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops.sampler import sample
from ssd_tpu_torch.utils.native import prepare_multi_query, prepare_prefill

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(name: str) -> torch.device:
    """The engine's device: "cuda" needs a visible GPU and raises without
    one; "cpu" only when the caller asks for it."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ssd_tpu_torch runs on a CUDA GPU and none is visible; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
    return device


def slot_of(block_tables: torch.Tensor, positions: torch.Tensor,
            b_of_row: torch.Tensor, block_size: int) -> torch.Tensor:
    """Flat cache slot of each (row, position); -1 where the table entry is
    -1 (ghost rows, padding) or the position falls past the table
    (context-limit overshoot, which must not clamp onto the last real block).
    Counterpart of ssd_tpu/engine/model_runner.py::slot_of."""
    M = block_tables.shape[1]
    blk = positions // block_size
    blk_ids = block_tables[b_of_row, blk.clamp(max=M - 1)]
    slot = blk_ids * block_size + positions % block_size
    return torch.where((blk_ids < 0) | (blk >= M), -1, slot).to(torch.int32)


def _store_rows(slot_map: np.ndarray, device: torch.device) -> torch.Tensor:
    """Indices of the rows whose slot is real, found on the host so that
    store_kv needs no device-to-host sync."""
    return torch.from_numpy(np.flatnonzero(slot_map >= 0)).to(device)


def flat_prefill_step(
    params: dict,
    kv_cache: torch.Tensor,      # [L, Hkv, S, 2*hd], updated in place
    input_ids: torch.Tensor,     # [T] all sequences' new tokens
    positions: torch.Tensor,     # [T]
    slot_map: torch.Tensor,      # [T] (-1 = no write)
    store_rows: torch.Tensor,    # rows of slot_map that are >= 0
    flat_pages: torch.Tensor,    # [P] per-sequence page runs
    row_lo: torch.Tensor,        # [T] flat-context interval start
    row_hi: torch.Tensor,        # [T] interval end (padding: lo == hi)
    gather_idx: torch.Tensor,    # [B] flat row of each sequence's last token
    temperatures: torch.Tensor,  # [B]
    generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    arch: Arch,
    block_size: int,
):
    """Mixed-length prefill as one forward. Returns (tokens [B], logits
    [B, V])."""
    scale = arch.head_dim ** -0.5

    def attn_call(li, q, k, v):
        kv_layer = kv_cache[li]
        att.store_kv(kv_layer, k, v, slot_map, store_rows)
        return att.flat_prefill_attention(q, kv_layer, flat_pages, row_lo,
                                          row_hi, block_size, scale)

    hidden = forward_hidden(params, input_ids, positions, attn_call, arch)
    logits = compute_logits(params, hidden, arch, gather_idx=gather_idx)
    return sample(logits, temperatures, generator, top_ps, top_ks), logits


def decode_step(
    params: dict,
    kv_cache: torch.Tensor,      # [L, Hkv, S, 2*hd], updated in place
    input_ids: torch.Tensor,     # [B*q_len]
    positions: torch.Tensor,     # [B*q_len]
    slot_map: torch.Tensor,      # [B*q_len]
    store_rows: torch.Tensor,    # rows of slot_map that are >= 0
    block_tables: torch.Tensor,  # [B, M]
    context_lens: torch.Tensor,  # [B]
    temperatures: torch.Tensor,  # [B]
    generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    arch: Arch,
    block_size: int,
    q_len: int,
):
    """Batched decode with q_len queries per sequence. Returns (tokens
    sampled from each sequence's last row [B], logits [B*q_len, V])."""
    B = block_tables.shape[0]
    scale = arch.head_dim ** -0.5
    qeff = torch.full((B,), q_len, dtype=torch.int32, device=block_tables.device)

    def attn_call(li, q, k, v):
        kv_layer = kv_cache[li]
        att.store_kv(kv_layer, k, v, slot_map, store_rows)
        qr = q.reshape(B, q_len, arch.num_heads, arch.head_dim)
        o = att.paged_attention(qr, kv_layer, block_tables, context_lens, qeff,
                                block_size, scale)
        return o.reshape(B * q_len, arch.num_heads, arch.head_dim)

    hidden = forward_hidden(params, input_ids, positions, attn_call, arch)
    logits = compute_logits(params, hidden, arch)
    last = logits.reshape(B, q_len, -1)[:, -1, :]
    return sample(last, temperatures, generator, top_ps, top_ks), logits


class ModelRunner:
    """Owns one model's weights and KV cache and serves the step functions
    to the engine."""

    def __init__(self, config: Config, init_random: bool = False):
        self.config = config
        self.device = resolve_device(config.device)
        self.hf_config = config.hf_config
        self.arch = Arch.from_model_config(self.hf_config)
        self.block_size = config.kvcache_block_size
        self.max_blocks = config.max_blocks
        self.dtype = _TORCH_DTYPES[config.dtype]
        self.use_warp = config.enable_top_sampling
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)

        with torch.no_grad():
            self.params = self._make_params(init_random)
        # The LM head runs in fp32, as in the JAX package; keeping an fp32
        # copy costs its memory once instead of a conversion every step.
        self.params["lm_head"] = self.params["lm_head"].float()

        self.num_kvcache_blocks = self._decide_num_blocks()
        config.num_kvcache_blocks = self.num_kvcache_blocks
        a = self.arch
        self.kv_cache = torch.zeros(
            a.num_layers, a.num_kv_heads, self.num_kvcache_blocks * self.block_size,
            2 * a.head_dim, dtype=self.dtype, device=self.device)

    def _make_params(self, init_random: bool) -> dict:
        if init_random:
            return init_params(self.arch, self.config.seed, self.dtype, self.device)
        from ssd_tpu_torch.utils.loader import load_params

        return load_params(self.config.model, self.hf_config, self.dtype, self.device)

    # --- memory sizing ---

    def _decide_num_blocks(self) -> int:
        cfg = self.config
        if cfg.num_kvcache_blocks != -1:
            return cfg.num_kvcache_blocks
        a = self.arch
        if self.device.type != "cuda":
            # Enough for max_num_seqs full-length sequences plus slack.
            return max(64, cfg.max_num_seqs * cfg.max_blocks * 2)
        elem = torch.finfo(self.dtype).bits // 8
        block_bytes = 2 * a.num_layers * self.block_size * a.num_kv_heads * a.head_dim * elem
        free, total = torch.cuda.mem_get_info(self.device)
        avail = int(total * cfg.gpu_memory_utilization) - (total - free)
        num = max(16, avail // block_bytes)
        # No point exceeding what max_num_seqs full-length sequences can use.
        cap = (cfg.max_num_seqs + 1) * (cfg.max_blocks + 2) * 4
        return min(num, cap)

    # --- host-side input prep ---

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _block_table_array(self, seqs: list[Sequence]) -> np.ndarray:
        out = np.full((len(seqs), self.max_blocks), -1, dtype=np.int32)
        for i, seq in enumerate(seqs):
            out[i, : len(seq.block_table)] = seq.block_table
        return out

    def _sampling_args(self, seqs: list[Sequence]):
        temps = np.asarray([seq.temperature for seq in seqs], dtype=np.float32)
        if not self.use_warp:
            return self._tensor(temps), None, None
        tp = np.asarray([seq.top_p for seq in seqs], dtype=np.float32)
        tk = np.asarray([seq.top_k for seq in seqs], dtype=np.int32)
        return self._tensor(temps), self._tensor(tp), self._tensor(tk)

    # --- phases ---

    @torch.no_grad()
    def run_prefill(self, seqs: list[Sequence]):
        """One flat-packed forward for the whole (mixed-length, possibly
        prefix-cached or chunked) prefill batch. Intra-batch prefix sharing
        is safe: every layer stores all sequences' KV before it attends.
        Returns (first sampled tokens [B], last-token logits [B, V])."""
        B = len(seqs)
        bs = self.block_size
        bt_rows = self._block_table_array(seqs)
        cached_list, n_new_list, pages_per = [], [], []
        for seq in seqs:
            # A fully cached prompt recomputes its last token, so real
            # last-token logits exist to sample the first output from.
            cached = min(seq.num_cached_tokens, seq.num_tokens - 1)
            n_new = seq.num_tokens - cached
            if seq.prefill_chunk is not None:
                n_new = min(n_new, seq.prefill_chunk)
            cached_list.append(cached)
            n_new_list.append(n_new)
            pages_per.append((cached + n_new + bs - 1) // bs)
        # No padding: the eager forward has no compiled shapes to reuse.
        T = sum(n_new_list)
        input_ids = np.zeros(T, dtype=np.int32)
        positions = np.zeros(T, dtype=np.int32)
        slot_map = np.full(T, -1, dtype=np.int32)
        flat_pages = np.full(sum(pages_per), -1, dtype=np.int32)
        row_lo = np.zeros(T, dtype=np.int32)
        row_hi = np.zeros(T, dtype=np.int32)
        gather_idx = np.zeros(B, dtype=np.int64)
        tok_off = page_off = 0
        for i, seq in enumerate(seqs):
            cached, n_new = cached_list[i], n_new_list[i]
            sl = slice(tok_off, tok_off + n_new)
            input_ids[sl] = seq.token_ids[cached:cached + n_new]
            pos_i, slots_i = prepare_prefill(bt_rows[i], cached, n_new, bs)
            positions[sl], slot_map[sl] = pos_i, slots_i
            flat_pages[page_off:page_off + pages_per[i]] = bt_rows[i][:pages_per[i]]
            base = page_off * bs
            # The token at prompt position p sees flat context [base, base+p+1).
            row_lo[sl] = base
            row_hi[sl] = base + pos_i + 1
            gather_idx[i] = tok_off + n_new - 1
            tok_off += n_new
            page_off += pages_per[i]

        temps, top_ps, top_ks = self._sampling_args(seqs)
        tokens, logits = flat_prefill_step(
            self.params, self.kv_cache,
            self._tensor(input_ids), self._tensor(positions),
            self._tensor(slot_map), _store_rows(slot_map, self.device),
            self._tensor(flat_pages), self._tensor(row_lo), self._tensor(row_hi),
            self._tensor(gather_idx), temps, self.generator, top_ps, top_ks,
            arch=self.arch, block_size=bs,
        )
        return tokens.tolist(), logits

    @torch.no_grad()
    def run_decode(self, seqs: list[Sequence], q_len: int = 1):
        """Batched decode forward over each sequence's last q_len tokens.
        Returns (tokens [B], logits [B, q_len, V])."""
        B = len(seqs)
        tails = np.asarray([seq.token_ids[-q_len:] for seq in seqs],
                           dtype=np.int32).reshape(B, q_len)
        num_tokens = np.asarray([seq.num_tokens for seq in seqs], dtype=np.int32)
        bt = self._block_table_array(seqs)
        input_ids, positions, slot_map, context_lens = prepare_multi_query(
            tails, num_tokens, bt, q_len, self.block_size)
        temps, top_ps, top_ks = self._sampling_args(seqs)
        tokens, logits = decode_step(
            self.params, self.kv_cache,
            self._tensor(input_ids), self._tensor(positions),
            self._tensor(slot_map), _store_rows(slot_map, self.device),
            self._tensor(bt), self._tensor(context_lens),
            temps, self.generator, top_ps, top_ks,
            arch=self.arch, block_size=self.block_size, q_len=q_len,
        )
        return tokens.tolist(), logits.reshape(B, q_len, -1)

    def run(self, seqs: list[Sequence], is_prefill: bool,
            return_logits: bool = False):
        """Engine entry: sampled tokens, plus each sequence's last-row logits
        [B, V] with return_logits."""
        if is_prefill:
            tokens, logits = self.run_prefill(seqs)
        else:
            tokens, logits = self.run_decode(seqs, q_len=1)
            logits = logits[:, -1, :]
        return (tokens, logits) if return_logits else tokens
