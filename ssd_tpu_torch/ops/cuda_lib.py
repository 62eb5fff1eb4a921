"""Builds the port's CUDA kernels (ssd_tpu_torch/csrc/*.cu) into one shared
library at first use and loads it with ctypes.

Each source compiles with its own `nvcc` process, all started together, for
`sm_90a` (Hopper); the objects then link into
`csrc/build/libssd_tpu_torch_<hash>.so`, where `<hash>` covers the sources and
flags, so an edited source rebuilds. The library has a plain C interface:
pointers and the CUDA stream pass as `c_void_p`, and every entry point returns
a `cudaError_t`, on which the wrappers in ops/attention.py, ops/moe.py and
ops/linear.py raise. A failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo",
]


class KernelLibrary:
    """The loaded library, with how it was obtained."""

    def __init__(self, cdll: ctypes.CDLL, path: Path, build_seconds: float,
                 build_log: str):
        self.cdll = cdll
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when an existing build was reused
        self.build_log = build_log          # nvcc/ptxas output (registers, spills)

    def check(self, err: int, what: str):
        if err != 0:
            msg = self.cdll.ssd_error_string(err).decode()
            raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


# The `dtype` argument of the entry points: the element type of the
# floating-point operands.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIB: KernelLibrary | None = None
_LOAD_LOCK = threading.Lock()   # the async draft thread may load it first
_COUNT_LOCK = threading.Lock()


_RECORD = threading.local()


def count_launch(wrapper):
    """One more launch in `wrapper.launches` (the async draft thread
    launches kernels too, hence the lock). Inside `recording_launches` (a
    CUDA graph capture, which launches nothing) the launch goes to the
    record instead; the graph adds it at every replay (`add_launches`)."""
    record = getattr(_RECORD, "launches", None)
    if record is not None:
        record[wrapper] = record.get(wrapper, 0) + 1
        return
    with _COUNT_LOCK:
        wrapper.launches += 1


@contextlib.contextmanager
def recording_launches():
    """The launches this thread's wrappers make inside the block, as a dict
    {wrapper: count}, kept out of the wrappers' own counts."""
    record: dict = {}
    _RECORD.launches = record
    try:
        yield record
    finally:
        _RECORD.launches = None


def add_launches(record: dict):
    """Count the launches of one replay of a captured step."""
    with _COUNT_LOCK:
        for wrapper, n in record.items():
            wrapper.launches += n


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] if os.environ.get("CUDA_HOME") else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of ssd_tpu_torch need "
                       "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest(files: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build(sources: list[Path], so: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)
    return "\n".join(log)


def _bind(cdll: ctypes.CDLL):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    cdll.ssd_error_string.restype = ctypes.c_char_p
    cdll.ssd_error_string.argtypes = [i]
    cdll.ssd_paged_attention.restype = i
    # The paged kernels (csrc/paged_split.cuh) also take the chunk length,
    # a workspace for the blocks' partials and per-stream counters.
    cdll.ssd_paged_attention.argtypes = [
        i, p, p, p, p, p, p,     # dtype, q, kv, block_tables, context_lens, qeff, out
        p, p,                     # workspace, counters
        i, i, i, i, i, ll, i, i,  # B, Q, Hq, Hkv, hd, S, M, block_size
        i, i, f, p,               # chunk, chunks per block, scale, stream
    ]
    cdll.ssd_flat_prefill_attention.restype = i
    cdll.ssd_flat_prefill_attention.argtypes = [
        i, p, p, p, p, p, p,     # dtype, q, kv, flat_pages, row_lo, row_hi, out
        i, i, i, i, ll, i, i,    # T, Hq, Hkv, hd, S, P, block_size
        f, p,                     # scale, stream
    ]
    # The tree kernels (csrc/tree_split.cuh) take the same three as the
    # paged ones beside the tree step and depth.
    cdll.ssd_tree_attention.restype = i
    cdll.ssd_tree_attention.argtypes = [
        i, p, p, p, p, p, p,     # dtype, q, kv, block_tables, context_lens, fan_idx_rows, out
        p, p,                     # workspace, counters
        i, i, i, i, i, ll, i, i,  # B, MQ, Hq, Hkv, hd, S, M, block_size
        i, i, i, i, f, p,         # step, K, chunk, chunks per block, scale, stream
    ]
    # The int8 cache (kv_quant): an int8 layer plus its f32 scales [Hkv, 2, S];
    # `s8` selects the integer-dot arithmetic of kv_quant="int8_mxu".
    cdll.ssd_paged_attention_int8.restype = i
    cdll.ssd_paged_attention_int8.argtypes = [
        i, i, p, p, p,           # dtype, s8, q, kv, scales
        p, p, p, p,              # block_tables, context_lens, qeff, out
        p, p,                     # workspace, counters
        i, i, i, i, i, ll, i, i,  # B, Q, Hq, Hkv, hd, S, M, block_size
        i, i, f, p,               # chunk, chunks per block, scale, stream
    ]
    cdll.ssd_flat_prefill_attention_int8.restype = i
    cdll.ssd_flat_prefill_attention_int8.argtypes = [
        i, p, p, p,              # dtype, q, kv, scales
        p, p, p, p,              # flat_pages, row_lo, row_hi, out
        i, i, i, i, ll, i, i,    # T, Hq, Hkv, hd, S, P, block_size
        f, p,                     # scale, stream
    ]
    cdll.ssd_tree_attention_int8.restype = i
    cdll.ssd_tree_attention_int8.argtypes = [
        i, i, p, p, p,           # dtype, s8, q, kv, scales
        p, p, p, p,              # block_tables, context_lens, fan_idx_rows, out
        p, p,                     # workspace, counters
        i, i, i, i, i, ll, i, i,  # B, MQ, Hq, Hkv, hd, S, M, block_size
        i, i, i, i, f, p,         # step, K, chunk, chunks per block, scale, stream
    ]
    # Stage variants of the paged kernels (ops/probes.py): `stage` 0 full,
    # 1 page loads only, 2 math only, 3 neither; otherwise the production
    # entries' arguments (the int8 variant takes the "int8" mode); stages
    # 1-3 take bf16 q.
    cdll.ssd_paged_attention_diag.restype = i
    cdll.ssd_paged_attention_diag.argtypes = [i, *cdll.ssd_paged_attention.argtypes]
    cdll.ssd_paged_attention_int8_diag.restype = i
    cdll.ssd_paged_attention_int8_diag.argtypes = [
        i, i, p, p, p,           # stage, dtype, q, kv, scales
        p, p, p, p,              # block_tables, context_lens, qeff, out
        p, p,                     # workspace, counters
        i, i, i, i, i, ll, i, i,  # B, Q, Hq, Hkv, hd, S, M, block_size
        i, i, f, p,               # chunk, chunks per block, scale, stream
    ]
    cdll.ssd_paged_smem_bytes.restype = i
    cdll.ssd_paged_smem_bytes.argtypes = [i, i, i, i]   # kind, dtype, hd, row tiles
    cdll.ssd_tree_smem_bytes.restype = i
    cdll.ssd_tree_smem_bytes.argtypes = [i, i, i, i]    # kind, dtype, hd, chunk
    # The int8 dot-rate probe (csrc/s8_probe.cu): q [N, R, D], k [N, L, D].
    for name in ("ssd_s8_dot_mma", "ssd_s8_dot_dp4a", "ssd_s8_dot_bf16"):
        fn = getattr(cdll, name)
        fn.restype = i
        fn.argtypes = [p, p, p, i, i, i, i, p]   # q, k, out, N, R, L, D, stream
    # Grouped GEMM (Qwen3-MoE experts) over expert-sorted rows.
    cdll.ssd_grouped_gemm.restype = i
    cdll.ssd_grouped_gemm.argtypes = [
        i, p, p, p, p,           # dtype, x, w, group_offsets, out
        i, i, i, i, p,           # N, K, Nout, E, stream
    ]
    # Its bf16 decode route (a few rows per expert): the same arguments but dtype.
    cdll.ssd_grouped_gemm_decode.restype = i
    cdll.ssd_grouped_gemm_decode.argtypes = cdll.ssd_grouped_gemm.argtypes[1:]
    # Dynamic shared memory of the bf16 kernels of K6 (route: 0 prefill,
    # 1 decode) and K1 (int8 pages, head_dim).
    cdll.ssd_grouped_gemm_smem_bytes.restype = i
    cdll.ssd_grouped_gemm_smem_bytes.argtypes = [i]
    cdll.ssd_flat_prefill_smem_bytes.restype = i
    cdll.ssd_flat_prefill_smem_bytes.argtypes = [i, i]
    # W8A16 GEMM (int8 weights, csrc/int8_weight_gemm.cu): offsets may be
    # NULL (one group).
    cdll.ssd_int8_linear.restype = i
    cdll.ssd_int8_linear.argtypes = [
        i, i, i, p, p, p, p, p,  # dtype, out_fp32, route, x, w, scale, group_offsets, out
        i, i, i, i, p,           # M, N, K, G, stream
    ]
    # Up to three products over one bf16 x in one launch (wgmma routes).
    cdll.ssd_int8_linear_multi.restype = i
    cdll.ssd_int8_linear_multi.argtypes = [
        i, i, p, i,              # out_fp32, route, x, segments
        p, p, p, p, p, p, p, p, p,  # w0..2, scale0..2, out0..2
        i, i, i, p,              # N0..2, group_offsets
        i, i, i, p,              # M, K, G, stream
    ]
    cdll.ssd_int8_linear_split.restype = i
    cdll.ssd_int8_linear_split.argtypes = [i, i, i, i, i]  # route, M, N, K, G
    cdll.ssd_int8_linear_smem_bytes.restype = i
    cdll.ssd_int8_linear_smem_bytes.argtypes = [i, i, i]   # route, rows a group, groups


def load() -> KernelLibrary:
    """The kernel library, built on the first call of the process."""
    global _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            _LIB = _load()
    return _LIB


def _load() -> KernelLibrary:
    sources = sorted(CSRC.glob("*.cu"))
    so = BUILD_DIR / f"libssd_tpu_torch_{_digest(sources + sorted(CSRC.glob('*.cuh')))}.so"
    t0 = time.perf_counter()
    log = _build(sources, so) if not so.exists() else ""
    seconds = time.perf_counter() - t0 if log else 0.0
    cdll = ctypes.CDLL(str(so))
    _bind(cdll)
    return KernelLibrary(cdll, so, seconds, log)
