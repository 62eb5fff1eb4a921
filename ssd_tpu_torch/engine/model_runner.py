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
- `chain_decode_step` runs the draft's K(+1) single-token decodes (the JAX
  package scans them inside one program; here they are a loop of launches
  that engine/graphs.py captures into one CUDA graph);
- the decode-side steps take fixed-shape device inputs only (tokens,
  positions, block tables, context lengths, temperatures) at the batch
  bucket B_pad = next_pow2(B), compute their cache slots on the device
  (`device_slot_of`) and read nothing back, so each (step, B_pad) is one CUDA
  graph on the card (engine/graphs.py; Config.enforce_eager or the CPU run
  them eagerly). A ghost row has a table of -1 entries, context 1 and
  temperature 0;
- host input prep stays in numpy; the JAX package's packed int32 payloads (a
  TPU transfer workaround) are not ported, each input is its own tensor.
A runner built with is_draft=True reads the sequences' draft block tables.
Under tensor parallelism (a parallel/comm.py::Comm) the runner holds its
rank's shard (parallel/mesh.py: weights quantized whole, then sliced, one
tensor at a time), its Arch the rank's heads, and its KV pool the rank's
k/v heads; the pool's block count is the smallest over the ranks.
The target of an EAGLE engine taps its residual stream (Config.eagle_layers)
in the prefill and the verify. The JAX package prefills EAGLE batches through
its grouped, power-of-two padded prefill because it needs per-sequence
activation rows; the flat layout has them directly (token t of sequence i is
row off_i + t), so every prefill here is flat and eager (its T varies).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ssd_tpu_torch.config import Config, ModelConfig
from ssd_tpu_torch.engine.sequence import Sequence
from ssd_tpu_torch.models.transformer import (
    Arch, compute_logits, forward_hidden, init_params, param_bytes)
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops.sampler import sample
from ssd_tpu_torch.parallel.mesh import Sharding
from ssd_tpu_torch.utils.native import prepare_prefill, slot_of  # noqa: F401 (the host copy)
from ssd_tpu_torch.utils.quant import quantize_leaf

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


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def device_slot_of(block_tables: torch.Tensor, positions: torch.Tensor,
                   b_of_row: torch.Tensor, block_size: int) -> torch.Tensor:
    """Flat cache slot of each (row, position) on the device; -1 where the
    table entry is -1 (ghost rows, padding) or the position falls past the
    table (context-limit overshoot, which must not clamp onto the last real
    block). ssd_tpu/engine/model_runner.py::slot_of; utils/native.py holds
    the numpy copy of the eager host paths."""
    M = block_tables.shape[1]
    blk = positions.long() // block_size
    blk_ids = block_tables[b_of_row, blk.clamp(max=M - 1)].long()
    slot = blk_ids * block_size + positions.long() % block_size
    return torch.where((blk_ids < 0) | (blk >= M), -1, slot).int()


def flat_prefill_step(
    params: dict,
    kv_cache: KVCache,           # [L, Hkv, S, 2*hd] | int8 pair, updated in place
    input_ids: torch.Tensor,     # [T] all sequences' new tokens
    positions: torch.Tensor,     # [T]
    slot_map: torch.Tensor,      # [T] (-1 = no write)
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
    greedy: bool = False,
):
    """Mixed-length prefill as one forward. Returns (tokens [B], logits
    [B, V]), and with eagle_layers the taps [T, n_taps * D] as a third
    element."""
    scale = arch.head_dim ** -0.5

    def attn_call(li, q, k, v):
        kv_layer = layer_of(kv_cache, li)
        att.store_kv(kv_layer, k, v, slot_map)
        return att.flat_prefill_attention(q, kv_layer, flat_pages, row_lo,
                                          row_hi, block_size, scale)

    out = forward_hidden(params, input_ids, positions, attn_call, arch, eagle_layers)
    hidden, acts = out if eagle_layers else (out, None)
    logits = compute_logits(params, hidden, arch, gather_idx=gather_idx)
    tokens = sample(logits, temperatures, generator, top_ps, top_ks, greedy=greedy)
    return (tokens, logits, acts) if eagle_layers else (tokens, logits)


def decode_forward(
    params: dict,
    kv_cache: KVCache,           # [L, Hkv, S, 2*hd] | int8 pair, updated in place
    input_ids: torch.Tensor,     # [B*q_len]
    positions: torch.Tensor,     # [B*q_len]
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
    attends positions up to context_lens[b] - q_len + i and writes its KV at
    device_slot_of(positions). Returns logits [B*q_len, V], or (logits, taps
    [B*q_len, n_taps * D]) with eagle_layers."""
    B = block_tables.shape[0]
    dev = block_tables.device
    scale = arch.head_dim ** -0.5
    context_lens = context_lens.to(torch.int32)
    qeff = torch.full((B,), q_len, dtype=torch.int32, device=dev)
    b_of = torch.arange(B * q_len, device=dev) // q_len
    slot_map = device_slot_of(block_tables, positions, b_of, block_size)

    def attn_call(li, q, k, v):
        kv_layer = layer_of(kv_cache, li)
        att.store_kv(kv_layer, k, v, slot_map)
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
    greedy: bool = False,
):
    """Batched decode with q_len queries per sequence. Returns (tokens
    sampled from each sequence's last row [B], logits [B*q_len, V]);
    `greedy` as in ops/sampler.py::sample."""
    B = block_tables.shape[0]
    logits = decode_forward(params, kv_cache, input_ids, positions, block_tables,
                            context_lens, arch=arch, block_size=block_size,
                            q_len=q_len, s8=s8)
    last = logits.reshape(B, q_len, -1)[:, -1, :]
    return sample(last, temperatures, generator, top_ps, top_ks, greedy=greedy), logits


def chain_decode_step(
    params: dict,
    kv_cache: KVCache,                 # [L, Hkv, S, 2*hd] | int8 pair, updated in place
    first_tokens: torch.Tensor,        # [B] the recovery tokens
    start_positions: torch.Tensor,     # [B] position of first_tokens
    block_tables: torch.Tensor,        # [B, M]
    start_context_lens: torch.Tensor,  # [B] context incl. first_tokens
    temperatures: torch.Tensor,        # [B]
    generator: torch.Generator | None,
    top_ps: torch.Tensor | None = None,
    top_ks: torch.Tensor | None = None,
    *,
    arch: Arch,
    block_size: int,
    K: int,
    extra_write: bool = True,
    sampler_x: float | None = None,
    fan_out: int = 3,
    tree_sampling: bool = False,
    s8: bool = False,
    greedy: bool = False,
):
    """The chain: K single-token decodes, each feeding its sampled token to
    the next; with extra_write a (K+1)-th decode writes the K-th token's KV
    (the sync draft); AR multi-step skips it. Step i reads at position
    start + i with context start_context_lens + i. Returns (tokens [B, K],
    logits_q [B, K, V])."""
    tok = first_tokens
    toks, logits = [], []
    for i in range(K + 1 if extra_write else K):
        lg = decode_forward(params, kv_cache, tok, start_positions + i, block_tables,
                            start_context_lens + i, arch=arch, block_size=block_size,
                            q_len=1, s8=s8)
        tok = sample(lg, temperatures, generator, top_ps, top_ks, sampler_x=sampler_x,
                     fan_out=fan_out, is_tree=tree_sampling, greedy=greedy)
        toks.append(tok)
        logits.append(lg)
    return torch.stack(toks[:K], dim=1), torch.stack(logits[:K], dim=1)


def tensor_bytes(params: dict) -> int:
    """Bytes of the distinct tensors of a parameter dict (a tied head and
    embedding count once)."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            if x.data_ptr() not in seen:
                seen.add(x.data_ptr())
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    walk(params)
    return total


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
    sized together (see _decide_num_blocks). `comm` is the engine's
    parallel/comm.py::Comm under tensor parallelism (None: one process)."""

    def __init__(self, config: Config, init_random: bool = False,
                 is_draft: bool = False, partner: ModelConfig | None = None,
                 comm=None):
        self.config = config
        self.is_draft = is_draft
        self.comm = comm
        self.device = comm.device if comm is not None else resolve_device(config.device)
        self.hf_config = config.hf_config
        self.sharding = None
        self._init_random = init_random
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
        self.graphs = None   # engine/graphs.py::StepGraphs, set by the engine

        with torch.no_grad():
            self.params = self._make_params(init_random)
            if config.quantization == "int8":
                # Weight-only int8 at load, as ssd_tpu/engine/model_runner.py
                # does: a model's leaves as they load (_place), an EAGLE
                # head's dict leaf by leaf (engine/eagle_runner.py). The
                # freed float weights return to the card's free memory
                # before mem_get_info sizes the pool.
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
            else:
                # The LM head runs in fp32, as in the JAX package; keeping an
                # fp32 copy costs its memory once instead of a conversion
                # every step (an int8 head takes K9 with fp32 output).
                self.params["lm_head"] = self.params["lm_head"].float()
        self.weight_bytes = tensor_bytes(self.params)

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
        # A reduced-vocabulary draft's head rows (its checkpoint's d2t) shape
        # the head's sharding and bytes.
        from ssd_tpu_torch.utils.loader import reduced_head_rows

        head_vocab = None if self._init_random else reduced_head_rows(self.config.model)
        arch = Arch.from_model_config(self.hf_config, head_vocab)
        if self.comm is None:
            return arch
        self.sharding = Sharding(arch, self.comm.rank, self.comm.size)
        return self.sharding.rank_arch(self.comm)

    def _place(self, name: str, x: torch.Tensor) -> dict:
        """The leaves the runner keeps of the whole tensor `name`: int8 and
        its scales under quantization="int8", then the rank's slices."""
        leaves = quantize_leaf(name, x) if self.config.quantization == "int8" else {name: x}
        if self.sharding is None:
            return leaves
        return {k: self.sharding.leaf(k, v) for k, v in leaves.items()}

    def _make_params(self, init_random: bool) -> dict:
        arch = self.sharding.arch if self.sharding is not None else self.arch
        if init_random:
            return init_params(arch, self.config.seed, self.dtype, self.device,
                               place=self._place)
        from ssd_tpu_torch.utils.loader import load_params

        return load_params(self.config.model, self.hf_config, self.dtype, self.device,
                           place=self._place,
                           expert_span=self.sharding and self.sharding.span("moe_gate"))

    # --- memory sizing ---

    def _decide_num_blocks(self, partner: ModelConfig | None) -> int:
        """Blocks of this runner's pool. On the card, the pool takes the
        free memory up to gpu_memory_utilization. With a partner (the draft
        of a speculative engine, built after this runner on the same card),
        its weights are set aside first and every block is counted together
        with one partner block: the draft config then inherits the same
        block count, so both pools fit and neither starves the other. The
        unfused async draft's draft_dp replicas on this card
        (Config.draft_replicas_here) are that many partners, each with its
        weights and its pool of the same count."""
        cfg = self.config
        if cfg.num_kvcache_blocks != -1:
            return cfg.num_kvcache_blocks
        if self.device.type != "cuda":
            # Enough for max_num_seqs full-length sequences plus slack.
            return max(64, cfg.max_num_seqs * cfg.max_blocks * 2)
        block_bytes = kv_block_bytes(self.arch, self.block_size, self.dtype, self.kv_quant)
        reserve = 0
        if partner is not None:
            # The draft's rank shard: its heads, MLP width and vocabulary rows
            # (a plain draft's reduced head counted at the full vocabulary's
            # rows; an EAGLE head's at its draft vocabulary's).
            if cfg.use_eagle:
                from ssd_tpu_torch.models.eagle3 import EagleArch, eagle_param_bytes

                d_arch, nbytes = EagleArch.from_model_config(
                    partner, cfg.d_model_target, len(cfg.eagle_layers)), eagle_param_bytes
            else:
                d_arch, nbytes = Arch.from_model_config(partner), param_bytes
            if self.comm is not None and not (cfg.draft_async and not cfg.async_fused):
                # The unfused async draft's replicas beside the target are whole.
                d_arch = Sharding(d_arch, self.comm.rank, self.comm.size).rank_arch()
            reserve = nbytes(d_arch, self.dtype, cfg.quantization)
            n = cfg.draft_replicas_here
            block_bytes += n * kv_block_bytes(d_arch, self.block_size, self.dtype,
                                              self.kv_quant)
            reserve *= n
        free, total = torch.cuda.mem_get_info(self.device)
        avail = int(total * cfg.gpu_memory_utilization) - (total - free) - reserve
        num = max(16, avail // block_bytes)
        # No point exceeding what max_num_seqs full-length sequences can use.
        cap = (cfg.max_num_seqs + 1) * (cfg.max_blocks + 2) * 4
        blocks = min(num, cap)
        if self.comm is not None:
            # Every rank's scheduler runs on the same pool: the smallest.
            blocks = self.comm.min_over_ranks(blocks)
        self.pool_sizing = dict(block_bytes=block_bytes, avail_bytes=avail,
                                uncapped_blocks=num, cap_blocks=cap, blocks=blocks,
                                weight_bytes=self.weight_bytes, partner_reserve_bytes=reserve)
        return blocks

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

    # --- fixed-shape steps (eager, or one CUDA graph per key) ---
    #
    # A step call is (key, fn, inputs, ghost): fn takes the numpy inputs as
    # device tensors (an input that is a device tensor already passes as it
    # is); ghost() gives inputs of ghost rows only, from which a graph is
    # captured (engine/graphs.py).

    def run_step(self, key: tuple, fn, inputs: dict, ghost):
        """fn(**inputs as device tensors): eagerly, or through the CUDA graph
        of `key`, captured on first use. Returns fn's outputs; under a graph
        they are its own buffers, valid until the next replay of any graph."""
        if self.graphs is None:
            return fn(**{k: v if isinstance(v, torch.Tensor)
                         else self._tensor(np.ascontiguousarray(v)) for k, v in inputs.items()})
        return self.graphs.run(key, fn, inputs, ghost)

    def capture_step(self, key: tuple, fn, inputs: dict, ghost):
        """Capture a step call's graph (the engine's warm-up)."""
        self.graphs.capture(key, fn, ghost())

    def _rows(self, B_pad: int, **cols):
        """Numpy columns padded to B_pad rows: each keyword is (rows, fill),
        ghost rows taking fill."""
        out = {}
        for name, (a, fill) in cols.items():
            a = np.asarray(a)
            pad = np.full((B_pad,) + a.shape[1:], fill, dtype=a.dtype)
            pad[:len(a)] = a
            out[name] = pad
        return out

    def _sampling_inputs(self, B_pad: int, temps, top_ps=None, top_ks=None) -> dict:
        """temperatures (ghosts 0) and, with the top-p/top-k warp, top_ps and
        top_ks (ghosts 1.0, 0) at B_pad rows."""
        n = len(temps)
        cols = dict(temperatures=(np.asarray(temps, np.float32), 0.0))
        if self.use_warp:
            cols["top_ps"] = (np.asarray([1.0] * n if top_ps is None else top_ps,
                                         np.float32), 1.0)
            cols["top_ks"] = (np.asarray([0] * n if top_ks is None else top_ks, np.int32), 0)
        return self._rows(B_pad, **cols)

    def _device_rows(self, B_pad: int, x: torch.Tensor | None, shape: tuple,
                     dtype: torch.dtype) -> torch.Tensor:
        """A device-tensor input at B_pad rows: x's rows, then zeros (x None:
        ghost rows only). A replay copies x's rows into the leading rows of
        its buffer, so under graphs x passes as it is."""
        if x is None:
            return torch.zeros((B_pad,) + tuple(shape), dtype=dtype, device=self.device)
        if self.graphs is not None or x.shape[0] == B_pad:
            return x
        return torch.cat([x, x.new_zeros((B_pad - x.shape[0],) + tuple(shape))])

    def _seq_warp(self, seqs):
        return [s.top_p for s in seqs], [s.top_k for s in seqs]

    def _multi_query_inputs(self, seqs: list[Sequence], q_len: int, B_pad: int) -> dict:
        """Inputs of a q_len-per-sequence decode over each sequence's last
        q_len tokens, at B_pad rows (ghosts: tokens 0 at position 0, a table
        of -1, context 1)."""
        B = len(seqs)
        tails = np.asarray([seq.token_ids[-q_len:] for seq in seqs],
                           dtype=np.int32).reshape(B, q_len)
        n = np.asarray([seq.num_tokens for seq in seqs], dtype=np.int32)
        pos = (n[:, None] - q_len + np.arange(q_len, dtype=np.int32)[None, :]).astype(np.int32)
        inp = self._rows(B_pad, input_ids=(tails, 0), positions=(pos, 0),
                         block_tables=(self._block_table_array(seqs), -1),
                         context_lens=(n, 1))
        inp["input_ids"] = inp["input_ids"].reshape(-1)
        inp["positions"] = inp["positions"].reshape(-1)
        return inp

    def decode_call(self, seqs: list[Sequence], q_len: int, B_pad: int):
        """The decode step over each sequence's last q_len tokens, sampling
        the last row (decode_step)."""
        temps = self._temperatures(seqs)
        greedy = not (temps > 0).any()

        def inputs(seqs, temps):
            return {**self._multi_query_inputs(seqs, q_len, B_pad),
                    **self._sampling_inputs(B_pad, temps, *self._seq_warp(seqs))}

        fn = partial(decode_step, self.params, self.kv_cache, generator=self.generator,
                     arch=self.arch, block_size=self.block_size, q_len=q_len, s8=self.s8,
                     greedy=greedy)
        return (("decode", B_pad, q_len, greedy), fn, inputs(seqs, temps),
                lambda: inputs([], temps[:0]))

    def verify_call(self, seqs: list[Sequence], q_len: int, B_pad: int):
        """The verify forward over each sequence's last q_len tokens, no
        sampling (decode_forward)."""
        fn = partial(decode_forward, self.params, self.kv_cache, arch=self.arch,
                     block_size=self.block_size, q_len=q_len, s8=self.s8,
                     eagle_layers=self.eagle_layers)
        return (("verify", B_pad, q_len), fn, self._multi_query_inputs(seqs, q_len, B_pad),
                lambda: self._multi_query_inputs([], q_len, B_pad))

    def chain_call(self, B_pad: int, K: int, extra_write: bool, first=(), start_pos=(),
                   bt=None, temps=(), top_ps=None, top_ks=None, sampler_x: float | None = None,
                   fan_out: int = 3, tree_sampling: bool = False):
        """The chain (chain_decode_step) whose row b starts at token first[b]
        at position start_pos[b] (ghosts: token 0 at position 0, context 1);
        no rows given: ghost rows only. The key names the sampler, so the
        sync draft's chain and the async draft's tree-sampled one (the
        jit-speculate miss chain, sampler_x, fan_out) are separate graphs."""
        temps = np.asarray(temps, np.float32)
        greedy = not (temps > 0).any()

        def inputs(first, start_pos, bt, temps, top_ps, top_ks):
            start_pos = np.asarray(start_pos, np.int32)
            return {**self._rows(B_pad, first_tokens=(np.asarray(first, np.int32), 0),
                                 start_positions=(start_pos, 0), block_tables=(bt, -1),
                                 start_context_lens=(start_pos + 1, 1)),
                    **self._sampling_inputs(B_pad, temps, top_ps, top_ks)}

        no_rows = np.zeros((0, self.max_blocks), np.int32)
        fn = partial(chain_decode_step, self.params, self.kv_cache, generator=self.generator,
                     arch=self.arch, block_size=self.block_size, K=K,
                     extra_write=extra_write, sampler_x=sampler_x, fan_out=fan_out,
                     tree_sampling=tree_sampling, s8=self.s8, greedy=greedy)
        sampler = (sampler_x, fan_out) if tree_sampling else None
        return (("chain", B_pad, K, extra_write, greedy, sampler), fn,
                inputs(first, start_pos, no_rows if bt is None else bt, temps, top_ps, top_ks),
                lambda: inputs((), (), no_rows, temps[:0], None, None))

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
        temps = self._temperatures(seqs)
        top_ps, top_ks = self._warp_args(*self._seq_warp(seqs))
        out = self._flat_prefill(rows, self._tensor(temps), top_ps, top_ks,
                                 greedy=not (temps > 0).any())
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
            flat_pages=self._tensor(flat_pages), row_lo=self._tensor(row_lo),
            row_hi=self._tensor(row_hi), gather_idx=self._tensor(gather_idx))

    def _flat_prefill(self, rows, temps, top_ps=None, top_ks=None, greedy=False):
        """flat_prefill_step over rows (see _flat_inputs)."""
        return flat_prefill_step(
            self.params, self.kv_cache, **self._flat_inputs(rows),
            temperatures=temps, generator=self.generator, top_ps=top_ps,
            top_ks=top_ks, arch=self.arch, block_size=self.block_size,
            eagle_layers=self.eagle_layers, greedy=greedy)

    @torch.no_grad()
    def run_decode(self, seqs: list[Sequence], q_len: int = 1):
        """Batched decode forward over each sequence's last q_len tokens.
        Returns (tokens [B], logits [B, q_len, V])."""
        B, B_pad = len(seqs), next_pow2(len(seqs))
        tokens, logits = self.run_step(*self.decode_call(seqs, q_len, B_pad))
        return tokens[:B].tolist(), logits.reshape(B_pad, q_len, -1)[:B]

    @torch.no_grad()
    def verify_forward(self, seqs: list[Sequence], q_len: int):
        """The target's verify forward over each sequence's last q_len tokens
        ([recovery | draft tokens]); no sampling. Returns (logits
        [B, q_len, V], the taps [B, q_len, n_taps * D] of an EAGLE target,
        else None)."""
        B, B_pad = len(seqs), next_pow2(len(seqs))
        out = self.run_step(*self.verify_call(seqs, q_len, B_pad))
        if self.eagle_layers:
            return (out[0].reshape(B_pad, q_len, -1)[:B],
                    out[1].reshape(B_pad, q_len, -1)[:B])
        return out.reshape(B_pad, q_len, -1)[:B], None

    @torch.no_grad()
    def run_chain(self, first: np.ndarray, start_pos: np.ndarray, bt: np.ndarray,
                  temps: np.ndarray, K: int, extra_write: bool, top_ps=None,
                  top_ks=None, sampler_x: float | None = None, fan_out: int = 3,
                  tree_sampling: bool = False):
        """The draft chain from host arrays, for the sync speculator and the
        async draft's jit-speculate path (the JAX package's run_chain and
        DraftRunner._jit_chain in one host entry): sequence b's chain starts
        at token first[b] at position start_pos[b]; extra_write runs a
        (K+1)-th decode that writes the K-th token's KV. Returns (tokens
        [B, K] numpy, logits_q [B, K, V] on the device, a copy of the
        graph's own buffer under a graph, since the verify's replay comes
        before the caller reads it)."""
        B = first.shape[0]
        tokens, logits_q = self.run_step(*self.chain_call(
            next_pow2(B), K, extra_write, first, start_pos, bt, temps, top_ps, top_ks,
            sampler_x=sampler_x, fan_out=fan_out, tree_sampling=tree_sampling))
        logits_q = logits_q[:B]
        if self.graphs is not None:
            logits_q = logits_q.clone()
        return tokens[:B].cpu().numpy(), logits_q

    @torch.no_grad()
    def run_multi_step(self, seqs: list[Sequence], M: int) -> list[list[int]]:
        """AR multi-step: M tokens per sequence from one chain of M decodes
        from each sequence's last token (the JAX package's run_chain(seqs,
        K=M) on the target, without the extra write)."""
        B = len(seqs)
        n = np.asarray([s.num_tokens for s in seqs], np.int32)
        tokens, _ = self.run_step(*self.chain_call(
            next_pow2(B), M, False, [s.last_token for s in seqs], n - 1,
            self._block_table_array(seqs), self._temperatures(seqs), *self._seq_warp(seqs)))
        return tokens[:B].tolist()

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
