"""Paged-KV attention: cache scatter, page gathers, and the three attention
contracts of the AR, SD and SSD paths, each as a plain PyTorch version and a
wrapper around its hand-written CUDA kernel.

Counterpart of ssd_tpu/ops/attention.py (plain versions) and of the Pallas
kernels in ssd_tpu/ops/pallas_attention.py that the AR path reaches:

- `paged_attention` (kernel csrc/paged_attention.cu) replaces
  `_paged_attn_v2_kernel` / `_paged_attn_v3_kernel` (decode and verify);
- `flat_prefill_attention` (kernel csrc/flat_prefill_attention.cu) replaces
  `_flat_prefill_kernel` (the one-launch ragged prefill);
- `tree_attention` (kernel csrc/tree_attention.cu) replaces
  `_tree_attn_kernel`, `_tree_attn_v2_kernel` and `_tree_attn_v3_kernel`
  (the async draft's tree decode).

A wrapper given CPU tensors computes the plain version; given CUDA tensors it
launches the kernel or raises. It never falls back. Each wrapper counts its
kernel launches in its `launches` attribute (under a lock: the async draft
thread launches kernels too).

KV cache layout, as in the JAX package: per layer [Hkv, S, 2*hd] with
S = num_blocks * block_size flat slots and K in lanes [0, hd), V in
[hd, 2*hd) of each slot row, so caches compare 1:1 with the reference.
`store_kv` updates the layer in place (JAX returns a new array).
"""

from __future__ import annotations

import threading

import torch

from ssd_tpu_torch.ops import cuda_lib
from ssd_tpu_torch.ops.spec_math import tree_attention_mask

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)
_COUNT_LOCK = threading.Lock()


def _count_launch(wrapper):
    with _COUNT_LOCK:
        wrapper.launches += 1


def store_kv(
    kv_layer: torch.Tensor,     # [Hkv, S, 2*hd], updated in place
    k: torch.Tensor,            # [T, Hkv, hd]
    v: torch.Tensor,            # [T, Hkv, hd]
    slot_mapping: torch.Tensor,  # [T] int; negative = ghost (dropped)
    rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Write new [K|V] rows into their flat cache slots; negative slots are
    dropped. `rows` lists the indices of the non-negative slots when the
    caller already knows them (the runner computes them on the host, which
    spares a device-to-host sync per layer); otherwise they are found here."""
    if rows is None:
        rows = torch.nonzero(slot_mapping >= 0).flatten()
    val = torch.cat([k[rows], v[rows]], dim=-1).transpose(0, 1)  # [Hkv, n, 2hd]
    kv_layer.index_copy_(1, slot_mapping[rows].long(), val.to(kv_layer.dtype))
    return kv_layer


def gather_pages(
    kv_layer: torch.Tensor,      # [Hkv, S, 2*hd]
    block_tables: torch.Tensor,  # [B, M] int (-1 = no page)
    block_size: int,
    ctx_pad: int,                # gather length (multiple of block_size)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ctx_pad context slots of each sequence as (k, v), each
    [B, ctx_pad, Hkv, hd]. A -1 table entry reads page 0; callers mask by
    context length."""
    hd = kv_layer.shape[-1] // 2
    pos = torch.arange(ctx_pad, device=kv_layer.device)
    blk_ids = block_tables.long()[:, pos // block_size]          # [B, C]
    slots = blk_ids.clamp(min=0) * block_size + pos % block_size
    kv = kv_layer[:, slots].permute(1, 2, 0, 3)                  # [B, C, Hkv, 2hd]
    return kv[..., :hd], kv[..., hd:]


def dense_pages(
    kv_layer: torch.Tensor,  # [Hkv, S, 2*hd]
    pages: torch.Tensor,     # [P] flat page ids (may be -1)
    block_size: int,
) -> torch.Tensor:
    """Dense packed page stream [Hkv, P*block_size, 2*hd] (-1 reads page 0)."""
    Hkv, S, hd2 = kv_layer.shape
    paged = kv_layer.reshape(Hkv, S // block_size, block_size, hd2)
    return paged[:, pages.long().clamp(min=0)].reshape(
        Hkv, pages.shape[0] * block_size, hd2)


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with a boolean mask (True = attend), fp32.
    Fully masked rows give zeros, not NaN."""
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - m), torch.zeros_like(scores))
    s = e.sum(dim=-1, keepdim=True)
    return e / s.clamp(min=1e-30)


# ---------------------------------------------------------------------------
# Paged attention (decode / verify)
# ---------------------------------------------------------------------------


def paged_attention_plain(
    q: torch.Tensor,             # [B, Q, Hq, hd]
    kv_layer: torch.Tensor,      # [Hkv, S, 2*hd]
    block_tables: torch.Tensor,  # [B, M] int32 (-1 = no page)
    context_lens: torch.Tensor,  # [B] attended length incl. the new tokens
    qeff: torch.Tensor,          # [B] true queries per sequence
    block_size: int,
    scale: float,
) -> torch.Tensor:
    """Causal multi-query paged attention, by gather: query i of sequence b
    attends positions p <= ctx_b - qeff_b + i that are also below ctx_b and
    inside the table (p < M * block_size). The plain version of
    csrc/paged_attention.cu; ssd_tpu/ops/attention.py::paged_attention with
    ctx_pad = M * block_size."""
    B, Q, Hq, hd = q.shape
    M = block_tables.shape[1]
    Hkv = kv_layer.shape[0]
    G = Hq // Hkv
    C = M * block_size
    k, v = gather_pages(kv_layer, block_tables, block_size, C)
    qf = q.float().reshape(B, Q, Hkv, G, hd)
    scores = torch.einsum("bqhgd,bchd->bhgqc", qf, k.float()) * scale
    scores = scores.reshape(B, Hq, Q, C)

    ctx = context_lens.long()
    pos = torch.arange(C, device=q.device)[None, None, :]
    limit = ctx[:, None] - qeff.long()[:, None] + torch.arange(Q, device=q.device)[None, :]
    mask = (pos <= limit[:, :, None]) & (pos < ctx[:, None, None])  # [B, Q, C]
    probs = masked_softmax(scores, mask[:, None, :, :])
    out = torch.einsum("bhgqc,bchd->bqhgd", probs.reshape(B, Hkv, G, Q, C), v.float())
    return out.reshape(B, Q, Hq, hd).to(q.dtype)


def _check_cuda_args(name: str, q: torch.Tensor, kv_layer: torch.Tensor,
                     int_args: dict[str, torch.Tensor]):
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: tensors must be on a CUDA device or the "
                           f"CPU, got {q.device}")
    if q.dtype not in _DTYPE_CODES or kv_layer.dtype != q.dtype:
        raise TypeError(f"{name}: q and kv must share dtype float32 or "
                        f"bfloat16, got {q.dtype} and {kv_layer.dtype}")
    for label, t in {"q": q, "kv_layer": kv_layer, **int_args}.items():
        if t.device != q.device:
            raise RuntimeError(f"{name}: {label} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    for label, t in int_args.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {label} must be int32, got {t.dtype}")
    for label, t in (("q", q), ("kv_layer", kv_layer)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    hd = q.shape[-1]
    if hd not in KERNEL_HEAD_DIMS or kv_layer.shape[-1] != 2 * hd:
        raise ValueError(f"{name}: the kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS} with a [Hkv, S, 2*hd] layer, got "
                         f"hd={hd}, layer {tuple(kv_layer.shape)}")


def paged_attention(
    q: torch.Tensor,             # [B, Q, Hq, hd]
    kv_layer: torch.Tensor,      # [Hkv, S, 2*hd]
    block_tables: torch.Tensor,  # [B, M] int32
    context_lens: torch.Tensor,  # [B] int32
    qeff: torch.Tensor,          # [B] int32
    block_size: int,
    scale: float,
) -> torch.Tensor:
    """Causal paged attention: the plain version for CPU tensors, the CUDA
    kernel (csrc/paged_attention.cu) for CUDA tensors."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, kv_layer, block_tables, context_lens,
                                     qeff, block_size, scale)
    B, Q, Hq, hd = q.shape
    Hkv, S, _ = kv_layer.shape
    _check_cuda_args("paged_attention", q, kv_layer, {
        "block_tables": block_tables, "context_lens": context_lens, "qeff": qeff})
    if Hq % Hkv or block_tables.shape[0] != B or context_lens.shape != (B,) \
            or qeff.shape != (B,) or S % block_size:
        raise ValueError("paged_attention: inconsistent shapes "
                         f"q {tuple(q.shape)}, kv {tuple(kv_layer.shape)}, "
                         f"tables {tuple(block_tables.shape)}, ctx "
                         f"{tuple(context_lens.shape)}, qeff {tuple(qeff.shape)}")
    out = torch.empty_like(q)
    lib = cuda_lib.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cdll.ssd_paged_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), kv_layer.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), qeff.data_ptr(),
            out.data_ptr(), B, Q, Hq, Hkv, hd, S, block_tables.shape[1],
            block_size, float(scale), stream)
    lib.check(err, "paged_attention kernel launch")
    _count_launch(paged_attention)
    return out


paged_attention.launches = 0


# ---------------------------------------------------------------------------
# Flat ragged prefill
# ---------------------------------------------------------------------------


def flat_prefill_attention_plain(
    q: torch.Tensor,           # [T, Hq, hd] new tokens of the whole batch
    kv_layer: torch.Tensor,    # [Hkv, S, 2*hd]
    flat_pages: torch.Tensor,  # [P] per-sequence attended page runs (-1 pad)
    row_lo: torch.Tensor,      # [T] first flat context column each token sees
    row_hi: torch.Tensor,      # [T] one past its last (padding: lo == hi)
    block_size: int,
    scale: float,
) -> torch.Tensor:
    """Every token attends the half-open interval [row_lo, row_hi) of the
    packed page stream dense_pages(kv_layer, flat_pages); the interval
    encodes the sequence's own run and causality. Padding tokens give zeros.
    The plain version of csrc/flat_prefill_attention.cu; the dense-stream
    math is ssd_tpu/ops/attention.py::flat_prefill_attention, taken one KV
    head at a time to bound its memory."""
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


def flat_prefill_attention(
    q: torch.Tensor,           # [T, Hq, hd]
    kv_layer: torch.Tensor,    # [Hkv, S, 2*hd]
    flat_pages: torch.Tensor,  # [P] int32
    row_lo: torch.Tensor,      # [T] int32
    row_hi: torch.Tensor,      # [T] int32
    block_size: int,
    scale: float,
) -> torch.Tensor:
    """Flat ragged prefill: the plain version for CPU tensors, the CUDA
    kernel (csrc/flat_prefill_attention.cu) for CUDA tensors."""
    if q.device.type == "cpu":
        return flat_prefill_attention_plain(q, kv_layer, flat_pages, row_lo,
                                            row_hi, block_size, scale)
    T, Hq, hd = q.shape
    Hkv, S, _ = kv_layer.shape
    _check_cuda_args("flat_prefill_attention", q, kv_layer, {
        "flat_pages": flat_pages, "row_lo": row_lo, "row_hi": row_hi})
    if Hq % Hkv or Hq // Hkv > 64 or row_lo.shape != (T,) \
            or row_hi.shape != (T,) or flat_pages.dim() != 1 or S % block_size:
        raise ValueError("flat_prefill_attention: inconsistent shapes "
                         f"q {tuple(q.shape)}, kv {tuple(kv_layer.shape)}, "
                         f"pages {tuple(flat_pages.shape)}, lo "
                         f"{tuple(row_lo.shape)}, hi {tuple(row_hi.shape)}")
    out = torch.empty_like(q)
    lib = cuda_lib.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cdll.ssd_flat_prefill_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), kv_layer.data_ptr(),
            flat_pages.data_ptr(), row_lo.data_ptr(), row_hi.data_ptr(),
            out.data_ptr(), T, Hq, Hkv, hd, S, flat_pages.shape[0], block_size,
            float(scale), stream)
    lib.check(err, "flat_prefill_attention kernel launch")
    _count_launch(flat_prefill_attention)
    return out


flat_prefill_attention.launches = 0


# ---------------------------------------------------------------------------
# Tree attention (async draft tree decode)
# ---------------------------------------------------------------------------


def tree_attention_plain(
    q: torch.Tensor,             # [B, MQ, Hq, hd]
    kv_layer: torch.Tensor,      # [Hkv, S, 2*hd]
    block_tables: torch.Tensor,  # [B, M] int32 (-1 = no page)
    context_lens: torch.Tensor,  # [B] attended length at this step
    fan_idx_rows: torch.Tensor,  # [B, MQ] glue depth of each tree row
    step: int,
    K: int,
    block_size: int,
    scale: float,
) -> torch.Tensor:
    """Tree-decode attention of B*MQ fork rows over their shared prefix,
    masked by spec_math.tree_attention_mask and capped by the table
    (positions below M * block_size). The plain version of
    csrc/tree_attention.cu; ssd_tpu/ops/attention.py::tree_attention with
    ctx_pad = M * block_size."""
    B, MQ, Hq, hd = q.shape
    Hkv = kv_layer.shape[0]
    G = Hq // Hkv
    C = block_tables.shape[1] * block_size
    k, v = gather_pages(kv_layer, block_tables, block_size, C)
    qf = q.float().reshape(B, MQ, Hkv, G, hd)
    scores = torch.einsum("bqhgd,bchd->bhgqc", qf, k.float()) * scale
    mask = tree_attention_mask(context_lens, step, fan_idx_rows, K, MQ, C)
    probs = masked_softmax(scores.reshape(B, Hq, MQ, C), mask[:, None, :, :])
    out = torch.einsum("bhgqc,bchd->bqhgd", probs.reshape(B, Hkv, G, MQ, C), v.float())
    return out.reshape(B, MQ, Hq, hd).to(q.dtype)


def tree_attention(
    q: torch.Tensor,             # [B, MQ, Hq, hd]
    kv_layer: torch.Tensor,      # [Hkv, S, 2*hd]
    block_tables: torch.Tensor,  # [B, M] int32
    context_lens: torch.Tensor,  # [B] int32
    fan_idx_rows: torch.Tensor,  # [B, MQ] int32
    step: int,
    K: int,
    block_size: int,
    scale: float,
) -> torch.Tensor:
    """Tree-decode attention: the plain version for CPU tensors, the CUDA
    kernel (csrc/tree_attention.cu) for CUDA tensors."""
    if q.device.type == "cpu":
        return tree_attention_plain(q, kv_layer, block_tables, context_lens,
                                    fan_idx_rows, step, K, block_size, scale)
    B, MQ, Hq, hd = q.shape
    Hkv, S, _ = kv_layer.shape
    _check_cuda_args("tree_attention", q, kv_layer, {
        "block_tables": block_tables, "context_lens": context_lens,
        "fan_idx_rows": fan_idx_rows})
    if Hq % Hkv or block_tables.shape[0] != B or context_lens.shape != (B,) \
            or fan_idx_rows.shape != (B, MQ) or S % block_size \
            or not 0 <= step < K:
        raise ValueError("tree_attention: inconsistent shapes "
                         f"q {tuple(q.shape)}, kv {tuple(kv_layer.shape)}, "
                         f"tables {tuple(block_tables.shape)}, ctx "
                         f"{tuple(context_lens.shape)}, fan "
                         f"{tuple(fan_idx_rows.shape)}, step {step} of K={K}")
    out = torch.empty_like(q)
    lib = cuda_lib.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cdll.ssd_tree_attention(
            _DTYPE_CODES[q.dtype], q.data_ptr(), kv_layer.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(),
            fan_idx_rows.data_ptr(), out.data_ptr(), B, MQ, Hq, Hkv, hd, S,
            block_tables.shape[1], block_size, step, K, float(scale), stream)
    lib.check(err, "tree_attention kernel launch")
    _count_launch(tree_attention)
    return out


tree_attention.launches = 0
