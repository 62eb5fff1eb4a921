"""Per-model execution: weights, the paged KV cache, and the step functions
of the AR, SD and SSD paths.

Counterpart of ssd_tpu/engine/model_runner.py:
- the KV cache is one [L, Hkv, S, 2*hd] tensor with K and V interleaved on
  the last axis, as in JAX, so caches compare 1:1; the steps update it in
  place. With Config.kv_quant it is the JAX package's pair (data int8
  [L, Hkv, S, 2*hd], scales f32 [L, Hkv, 2, S]), and "int8_mxu" passes
  s8=True to the decode, verify, chain and tree attention;
- `flat_prefill_step` runs a whole mixed-length prefill batch as one forward
  whose attention is ops/attention.py::flat_prefill_attention;
- `decode_step` runs a batch of q_len-token decodes whose attention is
  ops/attention.py::paged_attention (decode, the K+1 verify, the glue);
- `chain_decode_step` runs the draft's K(+1) single-token decodes as an
  eager loop (the JAX package scans them inside one program);
- host input prep stays in numpy; the JAX package's packed int32 payloads (a
  TPU transfer workaround) are not ported, each input is its own tensor.
A runner built with is_draft=True reads the sequences' draft block tables.
The target of an EAGLE engine taps its residual stream (Config.eagle_layers)
in the prefill and the verify. The JAX package prefills EAGLE batches through
its grouped, power-of-two padded prefill because it needs per-sequence
activation rows; the flat layout has them directly (token t of sequence i is
row off_i + t), so every prefill here is flat. Not ported yet: CUDA-graph
capture.
"""

from __future__ import annotations

import numpy as np
import torch

from ssd_tpu_torch.config import Config, ModelConfig
from ssd_tpu_torch.engine.sequence import Sequence
from ssd_tpu_torch.models.transformer import (
    Arch, compute_logits, forward_hidden, init_params, param_bytes)
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops.sampler import sample
from ssd_tpu_torch.utils.native import prepare_multi_query, prepare_prefill, slot_of

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


KVCache = torch.Tensor | tuple[torch.Tensor, torch.Tensor]


def layer_of(kv_cache: KVCache, li: int):
    """Layer li of the cache: a view of the tensor, or of both halves of the
    int8 pair."""
    if isinstance(kv_cache, tuple):
        return kv_cache[0][li], kv_cache[1][li]
    return kv_cache[li]


def _store_rows(slot_map: np.ndarray, device: torch.device) -> torch.Tensor:
    """Indices of the rows whose slot is real, found on the host so that
    store_kv needs no device-to-host sync."""
    return torch.from_numpy(np.flatnonzero(slot_map >= 0)).to(device)


def flat_prefill_step(
    params: dict,
    kv_cache: KVCache,           # [L, Hkv, S, 2*hd] | int8 pair, updated in place
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
    eagle_layers: tuple[int, ...] | None = None,
):
    """Mixed-length prefill as one forward. Returns (tokens [B], logits
    [B, V]), and with eagle_layers the taps [T, n_taps * D] as a third
    element."""
    scale = arch.head_dim ** -0.5

    def attn_call(li, q, k, v):
        kv_layer = layer_of(kv_cache, li)
        att.store_kv(kv_layer, k, v, slot_map, store_rows)
        return att.flat_prefill_attention(q, kv_layer, flat_pages, row_lo,
                                          row_hi, block_size, scale)

    out = forward_hidden(params, input_ids, positions, attn_call, arch, eagle_layers)
    hidden, acts = out if eagle_layers else (out, None)
    logits = compute_logits(params, hidden, arch, gather_idx=gather_idx)
    tokens = sample(logits, temperatures, generator, top_ps, top_ks)
    return (tokens, logits, acts) if eagle_layers else (tokens, logits)


def decode_forward(
    params: dict,
    kv_cache: KVCache,           # [L, Hkv, S, 2*hd] | int8 pair, updated in place
    input_ids: torch.Tensor,     # [B*q_len]
    positions: torch.Tensor,     # [B*q_len]
    slot_map: torch.Tensor,      # [B*q_len]
    store_rows: torch.Tensor,    # rows of slot_map that are >= 0
    block_tables: torch.Tensor,  # [B, M]
    context_lens: torch.Tensor,  # [B]
    *,
    arch: Arch,
    block_size: int,
    q_len: int,
    s8: bool = False,
    eagle_layers: tuple[int, ...] | None = None,
):
    """Batched forward of q_len queries per sequence; query i of sequence b
    attends positions up to context_lens[b] - q_len + i. Returns logits
    [B*q_len, V], or (logits, taps [B*q_len, n_taps * D]) with
    eagle_layers."""
    B = block_tables.shape[0]
    scale = arch.head_dim ** -0.5
    qeff = torch.full((B,), q_len, dtype=torch.int32, device=block_tables.device)

    def attn_call(li, q, k, v):
        kv_layer = layer_of(kv_cache, li)
        att.store_kv(kv_layer, k, v, slot_map, store_rows)
        qr = q.reshape(B, q_len, arch.num_heads, arch.head_dim)
        o = att.paged_attention(qr, kv_layer, block_tables, context_lens, qeff,
                                block_size, scale, s8=s8)
        return o.reshape(B * q_len, arch.num_heads, arch.head_dim)

    out = forward_hidden(params, input_ids, positions, attn_call, arch, eagle_layers)
    if eagle_layers:
        return compute_logits(params, out[0], arch), out[1]
    return compute_logits(params, out, arch)


def decode_step(
    params: dict,
    kv_cache: KVCache,           # [L, Hkv, S, 2*hd] | int8 pair, updated in place
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
    s8: bool = False,
):
    """Batched decode with q_len queries per sequence. Returns (tokens
    sampled from each sequence's last row [B], logits [B*q_len, V])."""
    B = block_tables.shape[0]
    logits = decode_forward(params, kv_cache, input_ids, positions, slot_map,
                            store_rows, block_tables, context_lens,
                            arch=arch, block_size=block_size, q_len=q_len, s8=s8)
    last = logits.reshape(B, q_len, -1)[:, -1, :]
    return sample(last, temperatures, generator, top_ps, top_ks), logits


def chain_decode_step(
    params: dict,
    kv_cache: KVCache,           # [L, Hkv, S, 2*hd] | int8 pair, updated in place
    first_tokens: torch.Tensor,  # [B] the recovery tokens
    positions: torch.Tensor,     # [n_steps, B] position of step i's input
    slot_maps: torch.Tensor,     # [n_steps, B]
    store_rows: list[torch.Tensor],  # per step, rows of slot_maps[i] >= 0
    block_tables: torch.Tensor,  # [B, M]
    context_lens: torch.Tensor,  # [n_steps, B] context incl. step i's input
    temperatures: torch.Tensor,  # [B]
    generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    arch: Arch,
    block_size: int,
    K: int,
    sampler_x: float | None = None,
    fan_out: int = 3,
    tree_sampling: bool = False,
    s8: bool = False,
):
    """The draft chain: n_steps (K, or K+1 to also write the K-th token's KV)
    single-token decodes in an eager loop, each step feeding its sampled
    token to the next. Returns (tokens [B, K], logits_q [B, K, V])."""
    tok = first_tokens
    toks, logits = [], []
    for i in range(positions.shape[0]):
        lg = decode_forward(params, kv_cache, tok, positions[i], slot_maps[i],
                            store_rows[i], block_tables, context_lens[i],
                            arch=arch, block_size=block_size, q_len=1, s8=s8)
        tok = sample(lg, temperatures, generator, top_ps, top_ks,
                     sampler_x=sampler_x, fan_out=fan_out, is_tree=tree_sampling)
        toks.append(tok)
        logits.append(lg)
    return torch.stack(toks[:K], dim=1), torch.stack(logits[:K], dim=1)


def kv_block_bytes(arch: Arch, block_size: int, dtype: torch.dtype,
                   kv_quant: str | None = None) -> int:
    """Bytes of one KV block across all layers ([K|V] rows of every head):
    per (token, head), hd values of dtype for each of K and V, or for the
    int8 cache hd int8 values and one f32 scale for each."""
    per_half = (arch.head_dim + 4 if kv_quant is not None
                else arch.head_dim * (torch.finfo(dtype).bits // 8))
    return 2 * arch.num_layers * block_size * arch.num_kv_heads * per_half


class ModelRunner:
    """Owns one model's weights and KV cache and serves the step functions
    to the engine. `partner` is the draft's model config when this is the
    target of a speculative engine: the two KV pools share one card and are
    sized together (see _decide_num_blocks)."""

    def __init__(self, config: Config, init_random: bool = False,
                 is_draft: bool = False, partner: ModelConfig | None = None):
        self.config = config
        self.is_draft = is_draft
        self.device = resolve_device(config.device)
        self.hf_config = config.hf_config
        self.arch = self._make_arch()
        self.eagle_layers = (tuple(config.eagle_layers)
                             if config.use_eagle and not is_draft else None)
        self.block_size = config.kvcache_block_size
        self.max_blocks = config.max_blocks
        self.dtype = _TORCH_DTYPES[config.dtype]
        self.kv_quant = config.kv_quant
        self.s8 = config.kv_quant == "int8_mxu"
        self.use_warp = config.enable_top_sampling
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed + (1 if is_draft else 0))

        with torch.no_grad():
            self.params = self._make_params(init_random)
        # The LM head runs in fp32, as in the JAX package; keeping an fp32
        # copy costs its memory once instead of a conversion every step.
        self.params["lm_head"] = self.params["lm_head"].float()

        self.pool_sizing = None   # set when the pool is sized from free memory
        self.num_kvcache_blocks = self._decide_num_blocks(partner)
        config.num_kvcache_blocks = self.num_kvcache_blocks
        a = self.arch
        shape = (a.num_layers, a.num_kv_heads, self.num_kvcache_blocks * self.block_size,
                 2 * a.head_dim)
        if self.kv_quant is None:
            self.kv_cache = torch.zeros(shape, dtype=self.dtype, device=self.device)
        else:
            # As the JAX package: scales start at 1e-10 so that slots never
            # written dequantize to zeros.
            self.kv_cache = (
                torch.zeros(shape, dtype=torch.int8, device=self.device),
                torch.full((a.num_layers, a.num_kv_heads, 2, shape[2]), 1e-10,
                           dtype=torch.float32, device=self.device))

    def _make_arch(self):
        return Arch.from_model_config(self.hf_config)

    def _make_params(self, init_random: bool) -> dict:
        if init_random:
            return init_params(self.arch, self.config.seed, self.dtype, self.device)
        from ssd_tpu_torch.utils.loader import load_params

        return load_params(self.config.model, self.hf_config, self.dtype, self.device)

    # --- memory sizing ---

    def _decide_num_blocks(self, partner: ModelConfig | None) -> int:
        """Blocks of this runner's pool. On the card, the pool takes the
        free memory up to gpu_memory_utilization. With a partner (the draft
        of a speculative engine, built after this runner on the same card),
        its weights are set aside first and every block is counted together
        with one partner block: the draft config then inherits the same
        block count, so both pools fit and neither starves the other."""
        cfg = self.config
        if cfg.num_kvcache_blocks != -1:
            return cfg.num_kvcache_blocks
        if self.device.type != "cuda":
            # Enough for max_num_seqs full-length sequences plus slack.
            return max(64, cfg.max_num_seqs * cfg.max_blocks * 2)
        block_bytes = kv_block_bytes(self.arch, self.block_size, self.dtype, self.kv_quant)
        reserve = 0
        if partner is not None and cfg.use_eagle:
            from ssd_tpu_torch.models.eagle3 import EagleArch, eagle_param_bytes

            d_arch = EagleArch.from_model_config(partner, cfg.d_model_target,
                                                 len(cfg.eagle_layers))
            block_bytes += kv_block_bytes(d_arch, self.block_size, self.dtype, self.kv_quant)
            reserve = eagle_param_bytes(d_arch, self.dtype)
        elif partner is not None:
            d_arch = Arch.from_model_config(partner)
            block_bytes += kv_block_bytes(d_arch, self.block_size, self.dtype, self.kv_quant)
            reserve = param_bytes(d_arch, self.dtype)
        free, total = torch.cuda.mem_get_info(self.device)
        avail = int(total * cfg.gpu_memory_utilization) - (total - free) - reserve
        num = max(16, avail // block_bytes)
        # No point exceeding what max_num_seqs full-length sequences can use.
        cap = (cfg.max_num_seqs + 1) * (cfg.max_blocks + 2) * 4
        self.pool_sizing = dict(block_bytes=block_bytes, avail_bytes=avail,
                                uncapped_blocks=num, cap_blocks=cap)
        return min(num, cap)

    # --- host-side input prep ---

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _block_table_array(self, seqs: list[Sequence]) -> np.ndarray:
        out = np.full((len(seqs), self.max_blocks), -1, dtype=np.int32)
        for i, seq in enumerate(seqs):
            table = seq.draft_block_table if self.is_draft else seq.block_table
            out[i, : len(table)] = table
        return out

    def _temperatures(self, seqs: list[Sequence]) -> np.ndarray:
        """Sampling temperatures: a draft runner takes the request's
        draft_temperature where it has one."""
        return np.asarray([
            seq.draft_temperature if self.is_draft and seq.draft_temperature is not None
            else seq.temperature for seq in seqs], dtype=np.float32)

    def _warp_args(self, top_ps, top_ks):
        if not self.use_warp or top_ps is None:
            return None, None
        return (self._tensor(np.asarray(top_ps, np.float32)),
                self._tensor(np.asarray(top_ks, np.int32)))

    def _sampling_args(self, seqs: list[Sequence]):
        tp, tk = self._warp_args([s.top_p for s in seqs], [s.top_k for s in seqs])
        return self._tensor(self._temperatures(seqs)), tp, tk

    def _prepare_multi_query(self, seqs: list[Sequence], q_len: int):
        """Numpy inputs of a q_len-per-sequence decode over each sequence's
        last q_len tokens: (input_ids, positions, slot_map, block_tables,
        context_lens)."""
        B = len(seqs)
        tails = np.asarray([seq.token_ids[-q_len:] for seq in seqs],
                           dtype=np.int32).reshape(B, q_len)
        num_tokens = np.asarray([seq.num_tokens for seq in seqs], dtype=np.int32)
        bt = self._block_table_array(seqs)
        input_ids, positions, slot_map, context_lens = prepare_multi_query(
            tails, num_tokens, bt, q_len, self.block_size)
        return input_ids, positions, slot_map, bt, context_lens

    # --- phases ---

    @torch.no_grad()
    def run_prefill(self, seqs: list[Sequence], return_acts: bool = False):
        """One flat-packed forward for the whole (mixed-length, possibly
        prefix-cached or chunked) prefill batch. Intra-batch prefix sharing
        is safe: every layer stores all sequences' KV before it attends.
        Returns (first sampled tokens [B], last-token logits [B, V]); with
        return_acts also each sequence's EAGLE taps, [n_new_i, n_taps * D]
        views of the flat rows on the device (the JAX package's
        _run_prefill_group rows)."""
        bt_rows = self._block_table_array(seqs)
        rows = []
        for i, seq in enumerate(seqs):
            cached = seq.num_draft_cached_tokens if self.is_draft else seq.num_cached_tokens
            if self.eagle_layers and seq.prefill_chunk is None:
                # The draft is conditioned on every prompt token's taps, so
                # a prefix-cached span is recomputed (rewriting its KV is
                # idempotent). A partial chunk only writes KV forward; the
                # last prefill of a chunked prompt recomputes it whole.
                cached = 0
            # A fully cached prompt recomputes its last token, so real
            # last-token logits exist to sample the first output from.
            cached = min(cached, seq.num_tokens - 1)
            n_new = seq.num_tokens - cached
            if seq.prefill_chunk is not None:
                n_new = min(n_new, seq.prefill_chunk)
            rows.append((seq.token_ids, bt_rows[i], cached, n_new))
        temps, top_ps, top_ks = self._sampling_args(seqs)
        out = self._flat_prefill(rows, temps, top_ps, top_ks)
        if not self.eagle_layers:
            return out[0].tolist(), out[1]
        tokens, logits, acts = out
        if return_acts:
            offs = np.cumsum([0] + [r[3] for r in rows])
            return tokens.tolist(), logits, [acts[offs[i]:offs[i + 1]]
                                             for i in range(len(rows))]
        return tokens.tolist(), logits

    def _flat_inputs(self, rows):
        """Flat-prefill inputs for rows of (token_ids, block-table row,
        cached tokens, new tokens): sequence i's new tokens sit at positions
        [cached, cached + n_new) and attend its own pages up to themselves.
        Returns a dict of device tensors (flat_prefill_step's arguments)."""
        bs = self.block_size
        n_new_list = [r[3] for r in rows]
        pages_per = [(r[2] + r[3] + bs - 1) // bs for r in rows]
        # No padding: the eager forward has no compiled shapes to reuse.
        T = sum(n_new_list)
        input_ids = np.zeros(T, dtype=np.int32)
        positions = np.zeros(T, dtype=np.int32)
        slot_map = np.full(T, -1, dtype=np.int32)
        flat_pages = np.full(sum(pages_per), -1, dtype=np.int32)
        row_lo = np.zeros(T, dtype=np.int32)
        row_hi = np.zeros(T, dtype=np.int32)
        gather_idx = np.zeros(len(rows), dtype=np.int64)
        tok_off = page_off = 0
        for i, (token_ids, bt_row, cached, n_new) in enumerate(rows):
            sl = slice(tok_off, tok_off + n_new)
            input_ids[sl] = token_ids[cached:cached + n_new]
            pos_i, slots_i = prepare_prefill(bt_row, cached, n_new, bs)
            positions[sl], slot_map[sl] = pos_i, slots_i
            flat_pages[page_off:page_off + pages_per[i]] = bt_row[:pages_per[i]]
            base = page_off * bs
            # The token at prompt position p sees flat context [base, base+p+1).
            row_lo[sl] = base
            row_hi[sl] = base + pos_i + 1
            gather_idx[i] = tok_off + n_new - 1
            tok_off += n_new
            page_off += pages_per[i]
        return dict(
            input_ids=self._tensor(input_ids), positions=self._tensor(positions),
            slot_map=self._tensor(slot_map),
            store_rows=_store_rows(slot_map, self.device),
            flat_pages=self._tensor(flat_pages), row_lo=self._tensor(row_lo),
            row_hi=self._tensor(row_hi), gather_idx=self._tensor(gather_idx))

    def _flat_prefill(self, rows, temps, top_ps=None, top_ks=None):
        """flat_prefill_step over rows (see _flat_inputs)."""
        return flat_prefill_step(
            self.params, self.kv_cache, **self._flat_inputs(rows),
            temperatures=temps, generator=self.generator, top_ps=top_ps,
            top_ks=top_ks, arch=self.arch, block_size=self.block_size,
            eagle_layers=self.eagle_layers)

    @torch.no_grad()
    def run_decode(self, seqs: list[Sequence], q_len: int = 1):
        """Batched decode forward over each sequence's last q_len tokens.
        Returns (tokens [B], logits [B, q_len, V])."""
        B = len(seqs)
        input_ids, positions, slot_map, bt, context_lens = self._prepare_multi_query(
            seqs, q_len)
        temps, top_ps, top_ks = self._sampling_args(seqs)
        tokens, logits = decode_step(
            self.params, self.kv_cache,
            self._tensor(input_ids), self._tensor(positions),
            self._tensor(slot_map), _store_rows(slot_map, self.device),
            self._tensor(bt), self._tensor(context_lens),
            temps, self.generator, top_ps, top_ks,
            arch=self.arch, block_size=self.block_size, q_len=q_len, s8=self.s8,
        )
        return tokens.tolist(), logits.reshape(B, q_len, -1)

    @torch.no_grad()
    def verify_forward(self, seqs: list[Sequence], q_len: int):
        """The target's verify forward over each sequence's last q_len tokens
        ([recovery | draft tokens]); no sampling. Returns (logits
        [B, q_len, V], the taps [B, q_len, n_taps * D] of an EAGLE target,
        else None)."""
        B = len(seqs)
        input_ids, positions, slot_map, bt, context_lens = self._prepare_multi_query(
            seqs, q_len)
        out = decode_forward(
            self.params, self.kv_cache,
            self._tensor(input_ids), self._tensor(positions),
            self._tensor(slot_map), _store_rows(slot_map, self.device),
            self._tensor(bt), self._tensor(context_lens),
            arch=self.arch, block_size=self.block_size, q_len=q_len, s8=self.s8,
            eagle_layers=self.eagle_layers)
        if self.eagle_layers:
            return out[0].reshape(B, q_len, -1), out[1].reshape(B, q_len, -1)
        return out.reshape(B, q_len, -1), None

    @torch.no_grad()
    def run_chain(self, first: np.ndarray, start_pos: np.ndarray, bt: np.ndarray,
              temps: np.ndarray, K: int, extra_write: bool, top_ps=None,
              top_ks=None, sampler_x: float | None = None, fan_out: int = 3,
              tree_sampling: bool = False):
        """The draft chain from host arrays, for the sync speculator and the
        async draft's jit-speculate path (the JAX package's run_chain and
        DraftRunner._jit_chain in one host entry): sequence b's chain starts at token
        first[b] at position start_pos[b]; extra_write runs a (K+1)-th
        decode that writes the K-th token's KV. Returns (tokens [B, K]
        numpy, logits_q [B, K, V] on the device)."""
        B = first.shape[0]
        n_steps = K + 1 if extra_write else K
        positions = start_pos[None, :] + np.arange(n_steps, dtype=np.int32)[:, None]
        rows = np.arange(B)
        slots = np.stack([slot_of(bt, positions[i], rows, self.block_size)
                          for i in range(n_steps)])
        tp, tk = self._warp_args(top_ps, top_ks)
        tokens, logits_q = chain_decode_step(
            self.params, self.kv_cache, self._tensor(first.astype(np.int64)),
            self._tensor(positions), self._tensor(slots),
            [_store_rows(s, self.device) for s in slots], self._tensor(bt),
            self._tensor((positions + 1).astype(np.int32)),
            self._tensor(temps.astype(np.float32)), self.generator, tp, tk,
            arch=self.arch, block_size=self.block_size, K=K,
            sampler_x=sampler_x, fan_out=fan_out, tree_sampling=tree_sampling,
            s8=self.s8)
        return tokens.cpu().numpy(), logits_q

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
