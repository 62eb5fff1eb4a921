"""Paged-KV attention: cache scatter, page gathers, and the three attention
contracts of the AR, SD and SSD paths, each as a plain PyTorch version and a
wrapper around its hand-written CUDA kernel.

Counterpart of ssd_tpu/ops/attention.py (plain versions) and of the Pallas
kernels in ssd_tpu/ops/pallas_attention.py that the AR path reaches:

- `paged_attention` (kernel csrc/paged_attention.cu) replaces
  `_paged_attn_v2_kernel` / `_paged_attn_v3_kernel` (decode and verify);
- `flat_prefill_attention` (kernel csrc/flat_prefill_attention.cu) replaces
  `_flat_prefill_kernel` (the one-launch ragged prefill);
- `tree_attention` (kernel csrc/tree_attention.cu, on the split-KV
  csrc/tree_split.cuh) replaces `_tree_attn_kernel`, `_tree_attn_v2_kernel`
  and `_tree_attn_v3_kernel` (the async draft's tree decode);
- over the int8 cache (Config.kv_quant), `paged_attention_int8` (kernel
  csrc/paged_attention_int8.cu) replaces `_paged_attn_v3_kernel_i8`,
  `tree_attention_int8` (csrc/tree_attention_int8.cu) replaces
  `_tree_attn_v3_kernel_i8`, and `flat_prefill_attention_int8` (K1's int8
  entry in csrc/flat_prefill_attention.cu) takes the place of the TPU's
  dequantizing `dense_pages` gather in front of `_flat_prefill_kernel`. The
  fp wrappers route an int8 layer to them.

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches the kernel or raises. It never falls back. Each wrapper counts its
kernel launches in its `launches` attribute (cuda_lib.count_launch, under a
lock: the async draft thread launches kernels too).

KV cache layout, as in the JAX package: per layer [Hkv, S, 2*hd] with
S = num_blocks * block_size flat slots and K in lanes [0, hd), V in
[hd, 2*hd) of each slot row, so caches compare 1:1 with the reference.
`store_kv` updates the layer in place (JAX returns a new array).

The int8 cache (kv_quant "int8" / "int8_mxu") is the pair of the JAX
pytree: data int8 [Hkv, S, 2*hd] and scales f32 [Hkv, 2, S], one symmetric
scale (amax / 127) per (slot, head, K|V). Every function here takes either
form of a layer. `s8=True` (kv_quant "int8_mxu") selects the integer-dot
arithmetic of the TPU's s8 kernels: q quantized per row, the softmax weights
per row and per tile of positions (PAGED_S8_TILE, TREE_S8_TILE: the kernels'
tiles, which their plain versions share).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ssd_tpu_torch.ops import cuda_lib
from ssd_tpu_torch.ops.spec_math import tree_attention_mask

KERNEL_HEAD_DIMS = (64, 128)
PAGED_S8_TILE = 32   # csrc/paged_split.cuh: one ring tile of the paged kernels
TREE_S8_TILE = 64    # csrc/tree_split.cuh: one tile of the tree kernels
# Positions one block of the paged kernels (K2, K4) walks, by (head_dim, int8
# cache): fixed absolute chunks [c * chunk, (c + 1) * chunk), multiples of
# the kernels' 64-position ring tile (two PAGED_S8_TILEs), so a row's result
# does not depend on the batch or on Q. Chosen on the card with
# `python -m ssd_tpu_torch.bench.kernel_diag --chunks` (times in PERF.md).
PAGED_CHUNK = {(64, False): 128, (64, True): 128, (128, False): 128, (128, True): 128}
# The same for the tree kernels (K3, K5; csrc/tree_split.cuh): multiples of
# TREE_S8_TILE, each held whole in a block's shared memory. Chosen on the
# card with `python -m ssd_tpu_torch.bench.kernel_diag --tree --chunks`
# (PERF.md); the fp cache at hd 128 stays at 128 because in fp32 a
# position's K|V there takes 1040 bytes and 256 positions would not fit.
TREE_CHUNK = {(64, False): 256, (64, True): 256, (128, False): 128, (128, True): 256}
SPLIT_MAX_SPAN = 512  # positions one block may walk (kMaxChunk of both headers)

KVLayer = torch.Tensor | tuple[torch.Tensor, torch.Tensor]


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """[T, H, hd] x2 -> (qk, qv int8 [T, H, hd], sk, sv f32 [T, H]): scale
    max(amax / 127, 1e-10), values round(x / scale) (half to even) clipped to
    +-127. The arithmetic of ssd_tpu/ops/attention.py::quantize_kv, step for
    step (a division, not a reciprocal), so the same k and v give the same
    bytes."""

    def q1(x):
        xf = x.float()
        s = (xf.abs().amax(dim=-1) / 127.0).clamp(min=1e-10)
        qx = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
        return qx, s

    qk, sk = q1(k)
    qv, sv = q1(v)
    return qk, qv, sk, sv


def store_kv(
    kv_layer: KVLayer,           # [Hkv, S, 2*hd] | (int8 data, scales), in place
    k: torch.Tensor,            # [T, Hkv, hd]
    v: torch.Tensor,            # [T, Hkv, hd]
    slot_mapping: torch.Tensor,  # [T] int; negative = ghost (dropped)
) -> KVLayer:
    """Write new [K|V] rows into their flat cache slots; negative slots are
    dropped (for the int8 pair, both the data and the scales). The store
    keeps its shapes whatever the slots hold and reads nothing back, as a
    CUDA graph needs: a ghost row writes what the first real row writes, to
    that row's slot, so the two writes agree and the result does not depend
    on their order; a call with no real row writes slot 0's own content
    back."""
    real = slot_mapping >= 0
    src = torch.where(real, torch.arange(real.shape[0], device=real.device),
                      real.int().argmax())
    any_real = real.any()
    slots = torch.where(any_real, slot_mapping[src], 0).long()

    def keep(new, old):   # slot 0's own content when no row is real
        return torch.where(any_real, new, old)

    if isinstance(kv_layer, tuple):
        data, scales = kv_layer
        qk, qv, sk, sv = quantize_kv(k[src], v[src])
        data.index_copy_(1, slots, keep(torch.cat([qk, qv], dim=-1).transpose(0, 1),
                                        data[:, :1]))
        scales.index_copy_(2, slots, keep(torch.stack([sk, sv], dim=-1).permute(1, 2, 0),
                                          scales[:, :, :1]))
        return kv_layer
    val = torch.cat([k[src], v[src]], dim=-1).transpose(0, 1)  # [Hkv, n, 2hd]
    kv_layer.index_copy_(1, slots, keep(val.to(kv_layer.dtype), kv_layer[:, :1]))
    return kv_layer


def _slots(block_tables: torch.Tensor, block_size: int, ctx_pad: int) -> torch.Tensor:
    """Flat cache slot of each of the first ctx_pad positions, [B, ctx_pad];
    a -1 table entry reads page 0."""
    pos = torch.arange(ctx_pad, device=block_tables.device)
    blk_ids = block_tables.long()[:, pos // block_size]
    return blk_ids.clamp(min=0) * block_size + pos % block_size


def gather_pages(
    kv_layer: KVLayer,           # [Hkv, S, 2*hd] | (int8 data, scales)
    block_tables: torch.Tensor,  # [B, M] int (-1 = no page)
    block_size: int,
    ctx_pad: int,                # gather length (multiple of block_size)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ctx_pad context slots of each sequence as (k, v), each
    [B, ctx_pad, Hkv, hd], dequantized to f32 for the int8 cache. A -1 table
    entry reads page 0; callers mask by context length."""
    data = kv_layer[0] if isinstance(kv_layer, tuple) else kv_layer
    hd = data.shape[-1] // 2
    kv = data[:, _slots(block_tables, block_size, ctx_pad)].permute(1, 2, 0, 3)
    if isinstance(kv_layer, tuple):
        s = gather_scales(kv_layer, block_tables, block_size, ctx_pad)
        s = s.permute(0, 3, 1, 2)                                # [B, C, Hkv, 2]
        kvf = kv.float()
        return kvf[..., :hd] * s[..., 0:1], kvf[..., hd:] * s[..., 1:2]
    return kv[..., :hd], kv[..., hd:]


def gather_scales(
    kv_layer: tuple[torch.Tensor, torch.Tensor],  # (int8 data, scales)
    block_tables: torch.Tensor,  # [B, M]
    block_size: int,
    ctx_pad: int,
) -> torch.Tensor:
    """Per-position scales [B, Hkv, 2, ctx_pad] f32 of the int8 cache (the
    kernels read them from the cache themselves)."""
    slots = _slots(block_tables, block_size, ctx_pad)
    return kv_layer[1][:, :, slots].permute(2, 0, 1, 3)


def dense_pages(
    kv_layer: KVLayer,       # [Hkv, S, 2*hd] | (int8 data, scales)
    pages: torch.Tensor,     # [P] flat page ids (may be -1)
    block_size: int,
) -> torch.Tensor:
    """Dense packed page stream [Hkv, P*block_size, 2*hd] (-1 reads page 0),
    dequantized to f32 for the int8 cache."""
    data = kv_layer[0] if isinstance(kv_layer, tuple) else kv_layer
    Hkv, S, hd2 = data.shape
    p = pages.long().clamp(min=0)
    n = pages.shape[0] * block_size
    dense = data.reshape(Hkv, S // block_size, block_size, hd2)[:, p].reshape(Hkv, n, hd2)
    if isinstance(kv_layer, tuple):
        hd = hd2 // 2
        s = kv_layer[1].reshape(Hkv, 2, S // block_size, block_size)[:, :, p].reshape(Hkv, 2, n)
        dense = dense.float()
        return torch.cat([dense[..., :hd] * s[:, 0, :, None],
                          dense[..., hd:] * s[:, 1, :, None]], dim=-1)
    return dense


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with a boolean mask (True = attend),
    computed in fp64 and returned in the scores' dtype. Fully masked rows
    give zeros, not NaN. fp64 because an fp32 exp on the CPU was seen to come
    out up to 1.8e-4 off (relative) on rare calls while JAX worked in the
    same process, which an fp32 plain version then passed on to its output;
    the plain paged and tree versions are the kernels' references and must
    repeat."""
    s64 = torch.where(mask, scores.double(), torch.full_like(scores, -1e30, dtype=torch.float64))
    m = s64.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s64 - m), torch.zeros_like(s64))
    return (e / e.sum(dim=-1, keepdim=True).clamp(min=1e-30)).to(scores.dtype)


def _s8_attention_plain(
    q: torch.Tensor,             # [B, Q, Hq, hd]
    kv_layer: tuple[torch.Tensor, torch.Tensor],  # (int8 data, scales)
    block_tables: torch.Tensor,  # [B, M]
    block_size: int,
    mask: torch.Tensor,          # [B, Q, M * block_size] bool, True = attend
    scale: float,
    tile: int,
) -> torch.Tensor:
    """Attention with the arithmetic of kv_quant="int8_mxu", the plain
    version of the int8 kernels' S8 mode (see csrc/paged_attention_int8.cu).
    Each query row quantizes once: qs = max(max|q|, 1e-30) * (1/127),
    q8 = round(q / qs), scores = (q8 . k_i8) * (qs * scale) * sk. The softmax
    weights quantize per row and per tile of `tile` positions, from the
    tile's own scores: with t the tile's largest, e = exp(s - t), pq = e * sv,
    ps = max(max pq, 1e-30) * (1/127), p8 = round(pq / ps); the output is
    sum_tiles (p8 . v_i8) ps exp(t - m) / sum_tiles sum(e) exp(t - m), m the
    largest score. The integer dots run as fp32 sums of integers below 2^24,
    which are exact. Rows that attend nothing give zeros."""
    data = kv_layer[0]
    B, Q, Hq, hd = q.shape
    Hkv = data.shape[0]
    G = Hq // Hkv
    C = block_tables.shape[1] * block_size
    nT = -(-C // tile)
    pad = nT * tile - C
    kv8 = data[:, _slots(block_tables, block_size, C)].permute(1, 2, 0, 3).float()
    sc = gather_scales(kv_layer, block_tables, block_size, C)       # [B, Hkv, 2, C]
    if pad:  # positions past the table, masked
        kv8 = torch.nn.functional.pad(kv8, (0, 0, 0, 0, 0, pad))
        sc = torch.nn.functional.pad(sc, (0, pad))
        mask = torch.cat([mask, mask.new_zeros(B, Q, pad)], dim=-1)
    qf = q.float().reshape(B, Q, Hkv, G, hd).permute(0, 2, 3, 1, 4)  # [B, Hkv, G, Q, hd]
    qs = qf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) * (1.0 / 127.0)
    q8 = torch.round(qf / qs)
    idot = torch.einsum("bhgqd,bchd->bhgqc", q8, kv8[..., :hd])
    s = idot * (qs * scale) * sc[:, :, 0][:, :, None, None, :]
    live_pos = mask[:, None, None]                                    # [B, 1, 1, Q, Cp]
    st = s.masked_fill(~live_pos, float("-inf")).reshape(B, Hkv, G, Q, nT, tile)
    tmax = st.amax(dim=-1, keepdim=True)                              # -inf: empty tile
    live = torch.isfinite(tmax)
    e = torch.where(live_pos.reshape(B, 1, 1, Q, nT, tile),
                    torch.exp(st - torch.where(live, tmax, 0.0)), 0.0)
    pq = e * sc[:, :, 1].reshape(B, Hkv, 1, 1, nT, tile)
    ps = pq.amax(dim=-1, keepdim=True).clamp(min=1e-30) * (1.0 / 127.0)
    p8 = torch.round(pq / ps)
    tdot = torch.einsum("bhgqtc,btchd->bhgqtd", p8,
                        kv8[..., hd:].reshape(B, nT, tile, Hkv, hd))
    m = tmax.amax(dim=-2, keepdim=True)
    c = torch.where(live, torch.exp(tmax - torch.where(torch.isfinite(m), m, 0.0)), 0.0)
    num = (tdot * (c * ps)).sum(dim=-2)                              # [B, Hkv, G, Q, hd]
    den = (c * e.sum(dim=-1, keepdim=True)).sum(dim=-2)
    out = num / den.clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Q, Hq, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged attention (decode / verify)
# ---------------------------------------------------------------------------


def paged_attention_plain(
    q: torch.Tensor,             # [B, Q, Hq, hd]
    kv_layer: KVLayer,           # [Hkv, S, 2*hd] | (int8 data, scales)
    block_tables: torch.Tensor,  # [B, M] int32 (-1 = no page)
    context_lens: torch.Tensor,  # [B] attended length incl. the new tokens
    qeff: torch.Tensor,          # [B] true queries per sequence
    block_size: int,
    scale: float,
    s8: bool = False,
) -> torch.Tensor:
    """Causal multi-query paged attention, by gather: query i of sequence b
    attends positions p <= ctx_b - qeff_b + i that are also below ctx_b and
    inside the table (p < M * block_size). The plain version of
    csrc/paged_attention.cu and, over the int8 pair, of
    csrc/paged_attention_int8.cu (dequantized, or with s8 the integer-dot
    arithmetic at tile PAGED_S8_TILE); ssd_tpu/ops/attention.py::
    paged_attention with ctx_pad = M * block_size."""
    B, Q, Hq, hd = q.shape
    M = block_tables.shape[1]
    C = M * block_size
    ctx = context_lens.long()
    pos = torch.arange(C, device=q.device)[None, None, :]
    limit = ctx[:, None] - qeff.long()[:, None] + torch.arange(Q, device=q.device)[None, :]
    mask = (pos <= limit[:, :, None]) & (pos < ctx[:, None, None])  # [B, Q, C]
    if s8:
        return _s8_attention_plain(q, kv_layer, block_tables, block_size, mask,
                                   scale, PAGED_S8_TILE)
    k, v = gather_pages(kv_layer, block_tables, block_size, C)
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Q, Hkv, G, hd)
    scores = torch.einsum("bqhgd,bchd->bhgqc", qf, k.float()) * scale
    scores = scores.reshape(B, Hq, Q, C)
    probs = masked_softmax(scores, mask[:, None, :, :])
    out = torch.einsum("bhgqc,bchd->bqhgd", probs.reshape(B, Hkv, G, Q, C), v.float())
    return out.reshape(B, Q, Hq, hd).to(q.dtype)


def _check_cuda_args(name: str, q: torch.Tensor, kv_layer: KVLayer,
                     int_args: dict[str, torch.Tensor]):
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: tensors must be on a CUDA device or the "
                           f"CPU, got {q.device}")
    quant = isinstance(kv_layer, tuple)
    data = kv_layer[0] if quant else kv_layer
    if q.dtype not in cuda_lib.DTYPE_CODES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if quant:
        if data.dtype != torch.int8 or kv_layer[1].dtype != torch.float32:
            raise TypeError(f"{name}: the int8 cache is (int8 data, float32 "
                            f"scales), got {data.dtype} and {kv_layer[1].dtype}")
        if data.dim() != 3 or kv_layer[1].shape != (data.shape[0], 2, data.shape[1]):
            raise ValueError(f"{name}: scales must be [Hkv, 2, S] for data "
                             f"{tuple(data.shape)}, got {tuple(kv_layer[1].shape)}")
    elif data.dtype != q.dtype:
        raise TypeError(f"{name}: q and kv must share dtype float32 or "
                        f"bfloat16, got {q.dtype} and {data.dtype}")
    tensors = {"q": q, "kv_layer": data, **int_args}
    if quant:
        tensors["scales"] = kv_layer[1]
    for label, t in tensors.items():
        if t.device != q.device:
            raise RuntimeError(f"{name}: {label} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    for label, t in int_args.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {t.dtype}")
    for label, t in (("q", q), ("kv_layer", data)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    hd = q.shape[-1]
    if hd not in KERNEL_HEAD_DIMS or data.shape[-1] != 2 * hd:
        raise ValueError(f"{name}: the kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS} with a [Hkv, S, 2*hd] layer, got "
                         f"hd={hd}, layer {tuple(data.shape)}")


def _check_paged_shapes(name, q, data, block_tables, context_lens, qeff, block_size):
    B, Hq = q.shape[0], q.shape[2]
    Hkv, S, _ = data.shape
    if Hq % Hkv or block_tables.shape[0] != B or context_lens.shape != (B,) \
            or qeff.shape != (B,) or S % block_size:
        raise ValueError(f"{name}: inconsistent shapes "
                         f"q {tuple(q.shape)}, kv {tuple(data.shape)}, "
                         f"tables {tuple(block_tables.shape)}, ctx "
                         f"{tuple(context_lens.shape)}, qeff {tuple(qeff.shape)}")


_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}
_COUNTERS_LOCK = threading.Lock()
_SCRATCH = threading.local()


class SplitScratch:
    """The split-KV workspace and counters of one captured step
    (engine/graphs.py), one pair per CUDA stream the step launches on (a
    step with two branches, engine/async_fused.py, runs the verify's K2 and
    the tree build's K3 at the same time, so they must not share counters
    or workspace): held for the life of its CUDA graph, so every replay
    finds them at the addresses the capture recorded, and shared by no
    other graph. They grow during the eager warm-up run that precedes the
    capture; a capture that would need more raises."""

    def __init__(self):
        self.buffers: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def counters(self) -> torch.Tensor:
        """Every stream's counters, concatenated (zero between calls)."""
        return torch.cat([c for _, c in self.buffers.values()])

    def take(self, ws_elems: int, n_counters: int, device: torch.device):
        stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else 0
        ws, counters = self.buffers.get(stream, (None, None))
        if ws is None or ws.numel() < ws_elems or counters.numel() < n_counters:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("split-KV scratch too small inside a CUDA graph "
                                   "capture: run the step eagerly under it first")
            ws = torch.empty(max(ws_elems, 0 if ws is None else ws.numel()),
                             dtype=torch.float32, device=device)
            counters = torch.zeros(max(n_counters, 1024), dtype=torch.int32, device=device)
            self.buffers[stream] = (ws, counters)
        return ws[:ws_elems], counters


@contextlib.contextmanager
def split_scratch(scratch: SplitScratch):
    """Split-KV launches of this thread inside the block take `scratch`'s
    workspace and counters for the stream they launch on."""
    _SCRATCH.current = scratch
    try:
        yield scratch
    finally:
        _SCRATCH.current = None


def split_buffers(q: torch.Tensor, Hkv: int, M: int, block_size: int, chunk: int):
    """What a split-KV kernel launch (paged or tree) needs beside its
    operands, on q's device and the current stream: (chunk, chunks per
    block, workspace, counters, stream handle). The workspace holds the
    blocks' partial softmax states (fp32 acc and (m, l) per row and chunk),
    fresh from the caching allocator on this stream, so no other stream can
    touch it while the call runs. The counters (B * Hkv ints) find the last
    block of each (sequence, KV head); they are zero between calls, since
    that block resets its own, and are kept per stream: the target's and the
    draft's streams run these kernels at the same time. Inside
    `split_scratch` (a captured step), both come from its SplitScratch."""
    B, Q, Hq, hd = q.shape
    n_chunks = -(-M * block_size // chunk)
    # Chunks per block: one, unless the table holds over 1024 chunks in all
    # (long contexts), where a block takes up to SPLIT_MAX_SPAN positions
    # and pays its fixed costs once; the chunks and results are the same.
    per_block = max(1, min(SPLIT_MAX_SPAN // chunk, B * Hkv * n_chunks // 1024))
    ws_elems = B * Hkv * n_chunks * Q * (Hq // Hkv) * (hd + 2)
    stream = torch.cuda.current_stream(q.device)
    scratch = getattr(_SCRATCH, "current", None)
    if scratch is not None:
        ws, counters = scratch.take(ws_elems, B * Hkv, q.device)
        return chunk, per_block, ws, counters, stream.cuda_stream
    ws = torch.empty(ws_elems, dtype=torch.float32, device=q.device)
    key = (q.device.index, stream.cuda_stream)
    with _COUNTERS_LOCK:
        counters = _COUNTERS.get(key)
        if counters is None or counters.numel() < B * Hkv:
            counters = torch.zeros(max(B * Hkv, 1024), dtype=torch.int32, device=q.device)
            _COUNTERS[key] = counters
    return chunk, per_block, ws, counters, stream.cuda_stream


def paged_attention(
    q: torch.Tensor,             # [B, Q, Hq, hd]
    kv_layer: KVLayer,           # [Hkv, S, 2*hd] | (int8 data, scales)
    block_tables: torch.Tensor,  # [B, M] int32
    context_lens: torch.Tensor,  # [B] int32
    qeff: torch.Tensor,          # [B] int32
    block_size: int,
    scale: float,
    s8: bool = False,
) -> torch.Tensor:
    """Causal paged attention: the plain version for CPU tensors, the CUDA
    kernel (csrc/paged_attention.cu) for CUDA tensors. An int8 layer goes to
    paged_attention_int8 (s8 only applies there)."""
    if isinstance(kv_layer, tuple):
        return paged_attention_int8(q, kv_layer, block_tables, context_lens,
                                    qeff, block_size, scale, s8=s8)
    if s8:
        raise ValueError("paged_attention: s8 needs the int8 cache")
    if q.device.type == "cpu":
        return paged_attention_plain(q, kv_layer, block_tables, context_lens,
                                     qeff, block_size, scale)
    B, Q, Hq, hd = q.shape
    Hkv, S, _ = kv_layer.shape
    _check_cuda_args("paged_attention", q, kv_layer, {
        "block_tables": block_tables, "context_lens": context_lens, "qeff": qeff})
    _check_paged_shapes("paged_attention", q, kv_layer, block_tables,
                        context_lens, qeff, block_size)
    out = torch.empty_like(q)
    lib = cuda_lib.load()
    with torch.cuda.device(q.device):
        chunk, per_block, ws, counters, stream = split_buffers(
            q, Hkv, block_tables.shape[1], block_size, PAGED_CHUNK[(hd, False)])
        err = lib.cdll.ssd_paged_attention(
            cuda_lib.DTYPE_CODES[q.dtype], q.data_ptr(), kv_layer.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), qeff.data_ptr(),
            out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, Q, Hq, Hkv, hd, S,
            block_tables.shape[1], block_size, chunk, per_block, float(scale), stream)
    lib.check(err, "paged_attention kernel launch")
    cuda_lib.count_launch(paged_attention)
    return out


paged_attention.launches = 0


def paged_attention_int8(
    q: torch.Tensor,             # [B, Q, Hq, hd]
    kv_layer: tuple[torch.Tensor, torch.Tensor],  # (int8 [Hkv, S, 2*hd], f32 [Hkv, 2, S])
    block_tables: torch.Tensor,  # [B, M] int32
    context_lens: torch.Tensor,  # [B] int32
    qeff: torch.Tensor,          # [B] int32
    block_size: int,
    scale: float,
    s8: bool = False,
) -> torch.Tensor:
    """Causal paged attention over the int8 cache: the plain version for CPU
    tensors, the CUDA kernel (csrc/paged_attention_int8.cu) for CUDA
    tensors; s8 selects kv_quant="int8_mxu"'s integer dots."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, kv_layer, block_tables, context_lens,
                                     qeff, block_size, scale, s8=s8)
    B, Q, Hq, hd = q.shape
    data, scales = kv_layer
    _check_cuda_args("paged_attention_int8", q, kv_layer, {
        "block_tables": block_tables, "context_lens": context_lens, "qeff": qeff})
    _check_paged_shapes("paged_attention_int8", q, data, block_tables,
                        context_lens, qeff, block_size)
    Hkv, S, _ = data.shape
    out = torch.empty_like(q)
    lib = cuda_lib.load()
    with torch.cuda.device(q.device):
        chunk, per_block, ws, counters, stream = split_buffers(
            q, Hkv, block_tables.shape[1], block_size, PAGED_CHUNK[(hd, True)])
        err = lib.cdll.ssd_paged_attention_int8(
            cuda_lib.DTYPE_CODES[q.dtype], int(s8), q.data_ptr(), data.data_ptr(),
            scales.data_ptr(), block_tables.data_ptr(), context_lens.data_ptr(),
            qeff.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, Q, Hq,
            Hkv, hd, S, block_tables.shape[1], block_size, chunk, per_block, float(scale),
            stream)
    lib.check(err, "paged_attention_int8 kernel launch")
    cuda_lib.count_launch(paged_attention_int8)
    return out


paged_attention_int8.launches = 0


# ---------------------------------------------------------------------------
# Flat ragged prefill
# ---------------------------------------------------------------------------


def flat_prefill_attention_plain(
    q: torch.Tensor,           # [T, Hq, hd] new tokens of the whole batch
    kv_layer: KVLayer,         # [Hkv, S, 2*hd] | (int8 data, scales)
    flat_pages: torch.Tensor,  # [P] per-sequence attended page runs (-1 pad)
    row_lo: torch.Tensor,      # [T] first flat context column each token sees
    row_hi: torch.Tensor,      # [T] one past its last (padding: lo == hi)
    block_size: int,
    scale: float,
) -> torch.Tensor:
    """Every token attends the half-open interval [row_lo, row_hi) of the
    packed page stream dense_pages(kv_layer, flat_pages) (dequantized for the
    int8 pair); the interval encodes the sequence's own run and causality.
    Padding tokens give zeros. The plain version of
    csrc/flat_prefill_attention.cu (both entries); the dense-stream math is
    ssd_tpu/ops/attention.py::flat_prefill_attention, taken one KV head at a
    time to bound its memory."""
    T, Hq, hd = q.shape
    dense = dense_pages(kv_layer, flat_pages, block_size)   # [Hkv, C, 2hd]
    Hkv, C, _ = dense.shape
    G = Hq // Hkv
    col = torch.arange(C, device=q.device)[None, :]
    mask = (col >= row_lo.long()[:, None]) & (col < row_hi.long()[:, None])  # [T, C]
    any_col = mask.any(dim=-1)[:, None, None]
    qg = q.float().reshape(T, Hkv, G, hd)
    out = torch.empty(T, Hkv, G, hd, dtype=torch.float32, device=q.device)
    for h in range(Hkv):
        k = dense[h, :, :hd].float()
        v = dense[h, :, hd:].float()
        s = torch.einsum("tgd,cd->tgc", qg[:, h], k) * scale      # [T, G, C]
        s = s.masked_fill(~mask[:, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        p = torch.where(any_col, p, torch.zeros_like(p))
        out[:, h] = torch.einsum("tgc,cd->tgd", p, v)
    return out.reshape(T, Hq, hd).to(q.dtype)


def _check_flat_shapes(name, q, data, flat_pages, row_lo, row_hi, block_size):
    T, Hq, _ = q.shape
    Hkv, S, _ = data.shape
    if Hq % Hkv or Hq // Hkv > 64 or row_lo.shape != (T,) \
            or row_hi.shape != (T,) or flat_pages.dim() != 1 or S % block_size:
        raise ValueError(f"{name}: inconsistent shapes "
                         f"q {tuple(q.shape)}, kv {tuple(data.shape)}, "
                         f"pages {tuple(flat_pages.shape)}, lo "
                         f"{tuple(row_lo.shape)}, hi {tuple(row_hi.shape)}")


def flat_prefill_attention(
    q: torch.Tensor,           # [T, Hq, hd]
    kv_layer: KVLayer,         # [Hkv, S, 2*hd] | (int8 data, scales)
    flat_pages: torch.Tensor,  # [P] int32
    row_lo: torch.Tensor,      # [T] int32
    row_hi: torch.Tensor,      # [T] int32
    block_size: int,
    scale: float,
) -> torch.Tensor:
    """Flat ragged prefill: the plain version for CPU tensors, the CUDA
    kernel (csrc/flat_prefill_attention.cu) for CUDA tensors. An int8 layer
    goes to flat_prefill_attention_int8."""
    if isinstance(kv_layer, tuple):
        return flat_prefill_attention_int8(q, kv_layer, flat_pages, row_lo,
                                           row_hi, block_size, scale)
    if q.device.type == "cpu":
        return flat_prefill_attention_plain(q, kv_layer, flat_pages, row_lo,
                                            row_hi, block_size, scale)
    T, Hq, hd = q.shape
    Hkv, S, _ = kv_layer.shape
    _check_cuda_args("flat_prefill_attention", q, kv_layer, {
        "flat_pages": flat_pages, "row_lo": row_lo, "row_hi": row_hi})
    _check_flat_shapes("flat_prefill_attention", q, kv_layer, flat_pages,
                       row_lo, row_hi, block_size)
    out = torch.empty_like(q)
    lib = cuda_lib.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cdll.ssd_flat_prefill_attention(
            cuda_lib.DTYPE_CODES[q.dtype], q.data_ptr(), kv_layer.data_ptr(),
            flat_pages.data_ptr(), row_lo.data_ptr(), row_hi.data_ptr(),
            out.data_ptr(), T, Hq, Hkv, hd, S, flat_pages.shape[0], block_size,
            float(scale), stream)
    lib.check(err, "flat_prefill_attention kernel launch")
    cuda_lib.count_launch(flat_prefill_attention)
    return out


flat_prefill_attention.launches = 0


def flat_prefill_attention_int8(
    q: torch.Tensor,           # [T, Hq, hd]
    kv_layer: tuple[torch.Tensor, torch.Tensor],  # (int8 [Hkv, S, 2*hd], f32 [Hkv, 2, S])
    flat_pages: torch.Tensor,  # [P] int32
    row_lo: torch.Tensor,      # [T] int32
    row_hi: torch.Tensor,      # [T] int32
    block_size: int,
    scale: float,
) -> torch.Tensor:
    """Flat ragged prefill over the int8 cache: the plain version for CPU
    tensors, K1's int8 entry (csrc/flat_prefill_attention.cu, dequantizing
    as it loads) for CUDA tensors."""
    if q.device.type == "cpu":
        return flat_prefill_attention_plain(q, kv_layer, flat_pages, row_lo,
                                            row_hi, block_size, scale)
    T, Hq, hd = q.shape
    data, scales = kv_layer
    _check_cuda_args("flat_prefill_attention_int8", q, kv_layer, {
        "flat_pages": flat_pages, "row_lo": row_lo, "row_hi": row_hi})
    _check_flat_shapes("flat_prefill_attention_int8", q, data, flat_pages,
                       row_lo, row_hi, block_size)
    Hkv, S, _ = data.shape
    out = torch.empty_like(q)
    lib = cuda_lib.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cdll.ssd_flat_prefill_attention_int8(
            cuda_lib.DTYPE_CODES[q.dtype], q.data_ptr(), data.data_ptr(),
            scales.data_ptr(), flat_pages.data_ptr(), row_lo.data_ptr(),
            row_hi.data_ptr(), out.data_ptr(), T, Hq, Hkv, hd, S,
            flat_pages.shape[0], block_size, float(scale), stream)
    lib.check(err, "flat_prefill_attention_int8 kernel launch")
    cuda_lib.count_launch(flat_prefill_attention_int8)
    return out


flat_prefill_attention_int8.launches = 0


# ---------------------------------------------------------------------------
# Tree attention (async draft tree decode)
# ---------------------------------------------------------------------------


def tree_attention_plain(
    q: torch.Tensor,             # [B, MQ, Hq, hd]
    kv_layer: KVLayer,           # [Hkv, S, 2*hd] | (int8 data, scales)
    block_tables: torch.Tensor,  # [B, M] int32 (-1 = no page)
    context_lens: torch.Tensor,  # [B] attended length at this step
    fan_idx_rows: torch.Tensor,  # [B, MQ] glue depth of each tree row
    step: int,
    K: int,
    block_size: int,
    scale: float,
    s8: bool = False,
) -> torch.Tensor:
    """Tree-decode attention of B*MQ fork rows over their shared prefix,
    masked by spec_math.tree_attention_mask and capped by the table
    (positions below M * block_size). The plain version of
    csrc/tree_attention.cu and, over the int8 pair, of
    csrc/tree_attention_int8.cu (dequantized, or with s8 the integer-dot
    arithmetic at tile TREE_S8_TILE); ssd_tpu/ops/attention.py::
    tree_attention with ctx_pad = M * block_size."""
    B, MQ, Hq, hd = q.shape
    C = block_tables.shape[1] * block_size
    mask = tree_attention_mask(context_lens, step, fan_idx_rows, K, MQ, C)
    if s8:
        return _s8_attention_plain(q, kv_layer, block_tables, block_size, mask,
                                   scale, TREE_S8_TILE)
    k, v = gather_pages(kv_layer, block_tables, block_size, C)
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, MQ, Hkv, G, hd)
    scores = torch.einsum("bqhgd,bchd->bhgqc", qf, k.float()) * scale
    probs = masked_softmax(scores.reshape(B, Hq, MQ, C), mask[:, None, :, :])
    out = torch.einsum("bhgqc,bchd->bqhgd", probs.reshape(B, Hkv, G, MQ, C), v.float())
    return out.reshape(B, MQ, Hq, hd).to(q.dtype)


def _check_tree_shapes(name, q, data, block_tables, context_lens, fan_idx_rows,
                       step, K, block_size):
    B, MQ, Hq, _ = q.shape
    Hkv, S, _ = data.shape
    if Hq % Hkv or block_tables.shape[0] != B or context_lens.shape != (B,) \
            or fan_idx_rows.shape != (B, MQ) or S % block_size \
            or not 0 <= step < K:
        raise ValueError(f"{name}: inconsistent shapes "
                         f"q {tuple(q.shape)}, kv {tuple(data.shape)}, "
                         f"tables {tuple(block_tables.shape)}, ctx "
                         f"{tuple(context_lens.shape)}, fan "
                         f"{tuple(fan_idx_rows.shape)}, step {step} of K={K}")


def tree_attention(
    q: torch.Tensor,             # [B, MQ, Hq, hd]
    kv_layer: KVLayer,           # [Hkv, S, 2*hd] | (int8 data, scales)
    block_tables: torch.Tensor,  # [B, M] int32
    context_lens: torch.Tensor,  # [B] int32
    fan_idx_rows: torch.Tensor,  # [B, MQ] int32
    step: int,
    K: int,
    block_size: int,
    scale: float,
    s8: bool = False,
) -> torch.Tensor:
    """Tree-decode attention: the plain version for CPU tensors, the CUDA
    kernel (csrc/tree_attention.cu) for CUDA tensors. An int8 layer goes to
    tree_attention_int8 (s8 only applies there)."""
    if isinstance(kv_layer, tuple):
        return tree_attention_int8(q, kv_layer, block_tables, context_lens,
                                   fan_idx_rows, step, K, block_size, scale, s8=s8)
    if s8:
        raise ValueError("tree_attention: s8 needs the int8 cache")
    if q.device.type == "cpu":
        return tree_attention_plain(q, kv_layer, block_tables, context_lens,
                                    fan_idx_rows, step, K, block_size, scale)
    B, MQ, Hq, hd = q.shape
    Hkv, S, _ = kv_layer.shape
    _check_cuda_args("tree_attention", q, kv_layer, {
        "block_tables": block_tables, "context_lens": context_lens,
        "fan_idx_rows": fan_idx_rows})
    _check_tree_shapes("tree_attention", q, kv_layer, block_tables,
                       context_lens, fan_idx_rows, step, K, block_size)
    out = torch.empty_like(q)
    lib = cuda_lib.load()
    with torch.cuda.device(q.device):
        chunk, per_block, ws, counters, stream = split_buffers(
            q, Hkv, block_tables.shape[1], block_size, TREE_CHUNK[(hd, False)])
        err = lib.cdll.ssd_tree_attention(
            cuda_lib.DTYPE_CODES[q.dtype], q.data_ptr(), kv_layer.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(),
            fan_idx_rows.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
            B, MQ, Hq, Hkv, hd, S, block_tables.shape[1], block_size, step, K, chunk,
            per_block, float(scale), stream)
    lib.check(err, "tree_attention kernel launch")
    cuda_lib.count_launch(tree_attention)
    return out


tree_attention.launches = 0


def tree_attention_int8(
    q: torch.Tensor,             # [B, MQ, Hq, hd]
    kv_layer: tuple[torch.Tensor, torch.Tensor],  # (int8 [Hkv, S, 2*hd], f32 [Hkv, 2, S])
    block_tables: torch.Tensor,  # [B, M] int32
    context_lens: torch.Tensor,  # [B] int32
    fan_idx_rows: torch.Tensor,  # [B, MQ] int32
    step: int,
    K: int,
    block_size: int,
    scale: float,
    s8: bool = False,
) -> torch.Tensor:
    """Tree-decode attention over the int8 cache: the plain version for CPU
    tensors, the CUDA kernel (csrc/tree_attention_int8.cu) for CUDA
    tensors; s8 selects kv_quant="int8_mxu"'s integer dots."""
    if q.device.type == "cpu":
        return tree_attention_plain(q, kv_layer, block_tables, context_lens,
                                    fan_idx_rows, step, K, block_size, scale, s8=s8)
    B, MQ, Hq, hd = q.shape
    data, scales = kv_layer
    _check_cuda_args("tree_attention_int8", q, kv_layer, {
        "block_tables": block_tables, "context_lens": context_lens,
        "fan_idx_rows": fan_idx_rows})
    _check_tree_shapes("tree_attention_int8", q, data, block_tables,
                       context_lens, fan_idx_rows, step, K, block_size)
    Hkv, S, _ = data.shape
    out = torch.empty_like(q)
    lib = cuda_lib.load()
    with torch.cuda.device(q.device):
        chunk, per_block, ws, counters, stream = split_buffers(
            q, Hkv, block_tables.shape[1], block_size, TREE_CHUNK[(hd, True)])
        err = lib.cdll.ssd_tree_attention_int8(
            cuda_lib.DTYPE_CODES[q.dtype], int(s8), q.data_ptr(), data.data_ptr(),
            scales.data_ptr(), block_tables.data_ptr(), context_lens.data_ptr(),
            fan_idx_rows.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
            B, MQ, Hq, Hkv, hd, S, block_tables.shape[1], block_size, step, K, chunk,
            per_block, float(scale), stream)
    lib.check(err, "tree_attention_int8 kernel launch")
    cuda_lib.count_launch(tree_attention_int8)
    return out


tree_attention_int8.launches = 0


# The kernel wrappers whose `launches` count the main path's kernel launches.
KERNEL_WRAPPERS = (paged_attention, flat_prefill_attention, tree_attention,
                   paged_attention_int8, flat_prefill_attention_int8,
                   tree_attention_int8)
