"""The two measurement kernels of the JAX package's bench probes, each a
plain PyTorch version and a wrapper around its CUDA kernel:

- `s8_dot_mma`, `s8_dot_dp4a` and `s8_dot_bf16` (csrc/s8_probe.cu) replace
  bench/s8_probe.py::_kernel_s8 and ::_kernel_bf16: the batched dot
  out[n, r, l] = sum_d q[n, r, d] k[n, l, d] of int8 operands, as s8 x s8 ->
  s32 on the tensor cores or with __dp4a, and after a bf16 cast of k with
  fp32 accumulation;
- `paged_attention_diag` (csrc/paged_attention.cu and
  csrc/paged_attention_int8.cu built with a stage switch) replaces
  bench/kernel_diag.py::_diag_kernel: the paged decode with its page loads or
  its math compiled out, so a run can split the production kernel's time
  into its stages (STAGES).

The plain s8 versions compute in fp64, which is exact here (|q|, |k| <= 127
and D <= 128 keep every sum below 2^53), so the kernels must match them bit
for bit. Only the "full" stage computes attention; its plain version is
ops/attention.py::paged_attention_plain, and it must equal the production
kernel bit for bit. The other stages compute no defined function and run
only on a card. A wrapper given CPU tensors computes the plain version;
given CUDA tensors it launches the kernel or raises, and counts the launch.
"""

from __future__ import annotations

import torch

from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops import cuda_lib

# The variants of bench/kernel_diag.py, by its names: the production kernel,
# the page loads alone ("dma" there), the math alone ("compute"), neither.
STAGES = {"full": 0, "dma": 1, "compute": 2, "empty": 3}


def s8_dot_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[N, R, D] x [N, L, D] -> [N, R, L], summed in fp64 (exact at these
    magnitudes), as int32 for int8 q and fp32 for bf16 q."""
    out = torch.einsum("nrd,nld->nrl", q.double(), k.double())
    return out.to(torch.int32 if q.dtype == torch.int8 else torch.float32)


# The shapes csrc/s8_probe.cu takes: D is 64 or 128 (whole k-steps of both
# mma shapes), and its N * ceil(L / PROBE_TILE) tiles count in an int.
PROBE_DIMS = (64, 128)
PROBE_TILE = 64


def _check_probe_args(name, q, k, q_dtype):
    """Raise on what the s8 probe's kernels refuse, before a launch."""
    if q.dtype != q_dtype or k.dtype != torch.int8:
        raise TypeError(f"{name}: q must be {q_dtype} and k int8, got {q.dtype}, {k.dtype}")
    if q.dim() != 3 or k.dim() != 3 or q.shape[0] != k.shape[0] \
            or q.shape[2] != k.shape[2] or q.shape[1] != 8:
        raise ValueError(f"{name}: needs q [N, 8, D] and k [N, L, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    N, _, D = q.shape
    L = k.shape[1]
    if D not in PROBE_DIMS or N < 1 or L < 1 or N * -(-L // PROBE_TILE) > 2**31 - 1:
        raise ValueError(f"{name}: the kernel takes D in {PROBE_DIMS}, N >= 1, L >= 1 "
                         f"and N * ceil(L / {PROBE_TILE}) < 2^31 tiles, got N={N}, L={L}, D={D}")
    if k.device != q.device or not (q.is_contiguous() and k.is_contiguous()):
        raise ValueError(f"{name}: q and k must be contiguous on one device")
    if q.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError(f"{name}: q and k must start 16-byte aligned (the kernel "
                         "copies 16-byte pieces)")


def _s8_dot_cuda(wrapper, entry: str, q, k, out_dtype, q_dtype):
    _check_probe_args(wrapper.__name__, q, k, q_dtype)
    N, R, D = q.shape
    L = k.shape[1]
    out = torch.empty(N, R, L, dtype=out_dtype, device=q.device)
    lib = cuda_lib.load()
    with torch.cuda.device(q.device):
        err = getattr(lib.cdll, entry)(q.data_ptr(), k.data_ptr(), out.data_ptr(),
                                       N, R, L, D, torch.cuda.current_stream().cuda_stream)
    lib.check(err, f"{wrapper.__name__} kernel launch")
    cuda_lib.count_launch(wrapper)
    return out


def s8_dot_mma(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [N, 8, D] int8, k [N, L, D] int8 -> int32 [N, 8, L]: the plain
    version for CPU tensors, the mma.sync s8 kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return s8_dot_plain(q, k)
    return _s8_dot_cuda(s8_dot_mma, "ssd_s8_dot_mma", q, k, torch.int32, torch.int8)


def s8_dot_dp4a(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """As s8_dot_mma, on SIMT with __dp4a."""
    if q.device.type == "cpu":
        return s8_dot_plain(q, k)
    return _s8_dot_cuda(s8_dot_dp4a, "ssd_s8_dot_dp4a", q, k, torch.int32, torch.int8)


s8_dot_mma.launches = 0
s8_dot_dp4a.launches = 0


def s8_dot_bf16(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [N, 8, D] bf16, k [N, L, D] int8 -> fp32 [N, 8, L], k cast to bf16
    and the sums in fp32: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if q.device.type == "cpu":
        return s8_dot_plain(q, k)
    return _s8_dot_cuda(s8_dot_bf16, "ssd_s8_dot_bf16", q, k, torch.float32,
                        torch.bfloat16)


s8_dot_bf16.launches = 0


def paged_attention_diag(
    stage: str,
    q: torch.Tensor,             # [B, Q, Hq, hd]
    kv_layer: att.KVLayer,       # [Hkv, S, 2*hd] | (int8 data, scales)
    block_tables: torch.Tensor,  # [B, M] int32
    context_lens: torch.Tensor,  # [B] int32
    qeff: torch.Tensor,          # [B] int32
    block_size: int,
    scale: float,
) -> torch.Tensor:
    """The paged decode kernel (K2, or K4's "int8" mode for the int8 pair)
    built as stage `stage` of STAGES. "full" is the production kernel; the
    other stages take bf16 q. On CPU tensors only "full" runs, as
    paged_attention_plain."""
    if stage not in STAGES:
        raise ValueError(f"paged_attention_diag: stage must be one of {list(STAGES)}")
    if q.device.type == "cpu":
        if stage != "full":
            raise RuntimeError(f"paged_attention_diag: stage {stage!r} computes no "
                               "defined function and runs only on a CUDA device")
        return att.paged_attention_plain(q, kv_layer, block_tables, context_lens,
                                         qeff, block_size, scale)
    B, Q, Hq, hd = q.shape
    quant = isinstance(kv_layer, tuple)
    data = kv_layer[0] if quant else kv_layer
    att._check_cuda_args("paged_attention_diag", q, kv_layer, {
        "block_tables": block_tables, "context_lens": context_lens, "qeff": qeff})
    att._check_paged_shapes("paged_attention_diag", q, data, block_tables,
                            context_lens, qeff, block_size)
    Hkv, S, _ = data.shape
    out = torch.empty_like(q)
    lib = cuda_lib.load()
    with torch.cuda.device(q.device):
        chunk, per_block, ws, counters, stream = att.split_buffers(
            q, Hkv, block_tables.shape[1], block_size, att.PAGED_CHUNK[(hd, quant)])
        common = (q.data_ptr(), data.data_ptr())
        rest = (block_tables.data_ptr(), context_lens.data_ptr(), qeff.data_ptr(),
                out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, Q, Hq, Hkv, hd, S,
                block_tables.shape[1], block_size, chunk, per_block, float(scale))
        if quant:
            err = lib.cdll.ssd_paged_attention_int8_diag(
                STAGES[stage], cuda_lib.DTYPE_CODES[q.dtype], *common,
                kv_layer[1].data_ptr(), *rest, stream)
        else:
            err = lib.cdll.ssd_paged_attention_diag(
                STAGES[stage], cuda_lib.DTYPE_CODES[q.dtype], *common, *rest, stream)
    lib.check(err, f"paged_attention_diag ({stage}) kernel launch")
    cuda_lib.count_launch(paged_attention_diag)
    return out


paged_attention_diag.launches = 0

PROBE_WRAPPERS = (s8_dot_mma, s8_dot_dp4a, s8_dot_bf16, paged_attention_diag)
