#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ssd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, as a release check
    python3 chip_smoke.py --phases env,kernels

Phases, each printing one JSON line ({"phase": ...}); any failure raises and
the script exits non-zero:

1. env      - the card's name and power limit (nvidia-smi), torch and CUDA
              versions, and the build of the CUDA kernels from the sources in
              ssd_tpu_torch/csrc (seconds, ptxas register/spill lines; for
              each instantiation of the split-KV paged kernels K2/K4, its
              registers, spills and shared memory).
2. kernels  - each kernel against its plain PyTorch version on the card, at
              the Llama-3.2-1B geometry (Hq/Hkv 32/8, head_dim 64, 64-token
              pages; the paged kernels at decode Q=1 and at the SD/SSD verify
              Q=K+1=5; the tree kernels at K=4, 10 tree rows; batches with a
              ghost row), over the fp cache and over the int8 cache in both
              kv_quant modes ("int8", and "int8_mxu" as the [s8] entries), in
              fp32 (|err| <= 1e-4) and bf16 (|err| <= 1e-4 + 2^-7 |ref|: one
              bf16 rounding of the fp32 result), with TF32 off for matmuls
              and cuDNN. In the s8 mode kernel and plain version round the
              same integers, so the same tolerance holds. Then their times:
              the kernel, the plain version, one library call computing the
              same function (scaled_dot_product_attention on the gathered
              dense K/V, dequantized for the int8 cache: a yardstick the port
              never calls), and the bound (bytes, scales included, over the
              HBM rate or operations over the peak of their type); the paged
              kernels also at B=8 x 8192 tokens. The attention kernels are
              held against their plain versions again at Qwen3-30B-A3B's
              attention geometry (Hq/Hkv 32/4, head_dim 128: K2 and K4 in
              all three cache modes at the b8 decode, the Qwen3-MoE verify
              Q=K+1 (40 rows a KV head) and the glue Q=2K+1 (72 rows)), and
              K1 and K2 timed there. K2 and K4 must be batch-invariant bit
              for bit: a repeated call, each sequence alone against the
              batch of 8, and a Q=1 call against query 0 of a Q=K+1 call. The grouped GEMM (K6) is held against its plain
              version at Qwen3-30B-A3B's expert shapes (gate/up 2048 -> 768,
              down 768 -> 2048; the serve prompts' prefill dispatch of
              5534 x 8 rows and a b8 decode dispatch of 64 rows, group sizes
              from a seeded router with an empty group) and timed there,
              beside torch._grouped_mm as its yardstick (a dense matmul of
              the same operations where that call is missing or refuses).
              At Llama-3.1-8B's heads (Hq/Hkv 32/8, hd 128): K1 at the EAGLE
              draft prefill of the 8 serve prompts; K2 and K4 (both int8
              modes) at the EAGLE glue shape Q = 2K+1 with per-sequence
              qeff, the b8 decode (Q=1), the verify (Q=K+1) and the head's
              chain step (Q=1); K3 and K5 at the last tree step; both
              dtypes, then K1 and the glue timed. The two bench probes: the s8 dot's three paths
              (csrc/s8_probe.cu: mma.sync s8, __dp4a, bf16 mma after a cast)
              at bench/s8_probe.py's shapes, exact against the fp64 plain
              version, and the paged kernels' stage variants (full, dma,
              compute, empty; K2 and K4's int8 mode) at the decode b8 batch
              and at B=8 x 8192, "full" bit for bit the production kernel;
              timed, then run once through their bench entry points
              (python -m ssd_tpu_torch.bench.s8_probe / .kernel_diag), whose
              launches the kernels line reports as the path "probe".
3. serve    - LLM(...).generate at the full Llama-3.2-1B width (16 layers,
              random bf16 weights from a seed): 128 greedy tokens for 8
              prompts of mixed length, then for 1 prompt (the AR path). The
              kernels' launch counts are zeroed just before and read just
              after; both must be above zero.
4. spec     - sync SD and async SSD (K=4, fan-out 2, so 10 tree rows per
              sequence) through LLM(target, draft=..., speculate=True, ...)
              at the same width: a target of 16 layers whose layers >= 4
              have o_proj = down = 0 and a 4-layer draft sharing its live
              layers (the construction of the JAX package's bench.py), bf16.
              128 greedy tokens at b8 and b1, with the draft exact (the hit
              path) and perturbed by a fixed noise level (the miss path),
              whose SSD cache-hit rate must land between 0.2 and 0.8. Per run: decode
              tok/s, accepted suffix length, hit rate, verify and draft step
              times, and the overlap on the card of the draft's tree builds
              (draft stream) with the target's verifies (target stream),
              from CUDA events. Launch counts are zeroed before and read
              after each run, with the draft thread drained on both sides
              so that a run counts its own tree builds whole; every kernel
              must launch on each path.
5. kvq      - the int8 KV cache at the same width: AR b8 (serve's engine)
              and SD and SSD b8 at noise 0 (spec's pair) with
              kv_quant="int8", then AR and SSD b8 with "int8_mxu". Per run
              as in spec, plus the KV pool's block bytes and uncapped block
              count; the int8 kernels of each path must launch and the
              fp-cache kernels must not.
6. moe      - Qwen3-30B-A3B (Qwen3-MoE: 48 layers, 128 experts, top-8,
              hd 128, random bf16 weights from a seed) at full width and
              depth through LLM(...).generate with
              gpu_memory_utilization=0.92 (the default 0.7 of the card is
              less than the 61 GB of weights): 128 greedy tokens for the 8
              serve prompts, then for one of 512. It fails if the free memory
              at its start is below the weights plus the capped KV pool, if
              the pool holds fewer blocks than the cap of 1224, or if K1, K2
              or the grouped GEMM never launched (counts zeroed just before,
              read just after).
7. eagle    - EAGLE-3 async SSD (K=4, fan-out 2) at Llama-3.1-8B's
              geometry (32 layers, rope theta 5e5 without the published
              rope scaling, which neither package reads) with its EAGLE-3
              head's (1 layer, draft vocab 32000, 2048 positions, which cap
              max_model_len; so serve's 1900-token prompt is cut to 1875),
              random bf16 weights from a seed: AR b8/b1, EAGLE SSD b8/b1
              over the fp cache and b8 over the int8 cache, 128 tokens. Then
              the constructed pair of bench.py::build_eagle_checkpoints
              (target cut to 8 layers): noise 0 must accept >= K tokens a
              step with a hit rate above 0.9, and one noise level of a
              fixed ladder must put the hit rate in [0.2, 0.8]. Per run as
              in spec, plus TTFT and the pools; K1 (target and draft
              prefill), K2 (verify, chain, glue) and K3 (tree), or over the
              int8 cache their int8 kernels, must launch.
8. exact    - the same width in fp32 from random checkpoints (init scale
              0.4): AR at 2 layers, greedy tokens on the card equal those of
              device="cpu", with the smallest top-1/top-2 logit margin seen;
              then a target of 8 layers and a noisy 2-layer draft: AR, sync
              SD and async SSD tokens on the card and on the CPU all equal
              the card's AR, over the fp32 cache and over the int8 cache;
              and two card runs of int8_mxu AR give the same tokens. Then
              Qwen3-30B-A3B's width at 2 layers: AR on the card equals the
              CPU's, and sync SD and async SSD on the card (self-draft) equal
              the card's AR, with the smallest top-1/top-2 logit margin and
              the smallest router gap between the k-th and (k+1)-th expert.
              Then the same width at 2 layers with the constructed EAGLE-3
              head (noise 0.028): AR on the card equals the CPU's, and EAGLE
              SSD on both devices equals the card's AR.
9. profile  - (only when asked for) the device's busy share and top kernels
              over a prefill step and a window of decode steps at b=8;
              moe_profile the same on the `moe` engine.
10. spec_profile - (only when asked for) the same for sync SD and async SSD
              at b=8: per step, the device time of each CUDA stream, their
              union, the time both streams ran kernels at once, the
              host-device copies and the verify's host time;
              eagle_profile the same for EAGLE SSD on the eagle engine.

Then the {"kernels": [...]} line, and last {"ok": true, "device": {...}}.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

PHASES = ("env", "kernels", "serve", "spec", "kvq", "moe", "eagle", "exact")
EXTRA_PHASES = ("profile", "moe_profile", "spec_profile", "eagle_profile")

# Llama-3.2-1B geometry (the JAX package's bench.py random-weight config).
LLAMA_1B = {
    "model_type": "llama",
    "vocab_size": 128256,
    "hidden_size": 2048,
    "intermediate_size": 8192,
    "num_hidden_layers": 16,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "head_dim": 64,
    "max_position_embeddings": 4096,
    "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0,
    "tie_word_embeddings": True,
    "eos_token_id": 128001,
}
LLAMA_HEADS = (32, 8, 64)   # Hq, Hkv, head_dim
# Qwen3-30B-A3B (huggingface.co/Qwen/Qwen3-30B-A3B, config.json): the MoE
# phase's model, at full width and depth.
QWEN3_30B_A3B = {
    "model_type": "qwen3_moe",
    "vocab_size": 151936,
    "hidden_size": 2048,
    "intermediate_size": 6144,
    "moe_intermediate_size": 768,
    "num_hidden_layers": 48,
    "num_attention_heads": 32,
    "num_key_value_heads": 4,
    "head_dim": 128,
    "num_experts": 128,
    "num_experts_per_tok": 8,
    "norm_topk_prob": True,
    "decoder_sparse_step": 1,
    "mlp_only_layers": [],
    "max_position_embeddings": 40960,
    "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0,
    "tie_word_embeddings": False,
    "bos_token_id": 151643,
    "eos_token_id": 151645,
}
MOE_GEOMETRY = "Qwen3-30B-A3B (48 layers, 128 experts, top-8, random bf16 weights)"
# Llama-3.1-8B (huggingface.co/meta-llama/Llama-3.1-8B, config.json) as both
# packages compute it: rope theta 5e5 without the published llama3
# rope_scaling, which neither ssd_tpu nor the port reads. The eagle phase's
# target, at full width and depth.
LLAMA_8B = {**LLAMA_1B, "hidden_size": 4096, "intermediate_size": 14336,
            "num_hidden_layers": 32, "head_dim": 128, "max_position_embeddings": 131072,
            "tie_word_embeddings": False}
LLAMA8B_HEADS = (32, 8, 128)
# Its EAGLE-3 head (huggingface.co/yuhuili/EAGLE3-LLaMA3.1-Instruct-8B,
# config.json): one layer at the target's width, a 32000-token draft vocab,
# 2048 positions (which cap max_model_len, as in ssd_tpu/config.py).
EAGLE3_8B = {"model_type": "llama", "vocab_size": 128256, "draft_vocab_size": 32000,
             "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 1,
             "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
             "max_position_embeddings": 2048, "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
             "tie_word_embeddings": False, "eos_token_id": 128001}
EAGLE_GEOMETRY = ("Llama-3.1-8B (32 layers, rope theta 5e5 unscaled) + EAGLE-3 head "
                  "(1 layer, draft vocab 32000), random bf16 weights")
EAGLE_MAX_LEN = 2048                # the head's max_position_embeddings
EAGLE_PAIR_LAYERS = 8               # the constructed pair's target depth (cut from 32)
EAGLE_NOISE_LADDER = (0.028, 0.032, 0.036, 0.04, 0.045)   # searched for the miss path
EXACT_EAGLE_NOISE = 0.028           # the exact phase's EAGLE head noise: the eagle phase's miss level on an H100
QWEN_HEADS = (32, 4, 128)
MOE_UTIL = 0.92   # gpu_memory_utilization: 0.7 of the card is less than the weights
BLOCK = 64
SERVE_LENS8 = [33, 111, 250, 400, 640, 900, 1300, 1900]  # serve phase, b8
SPEC_K, SPEC_F = 4, 2               # speculation depth, async fan-out
SPEC_MQ = SPEC_F * (SPEC_K + 1)     # tree rows per sequence
SPEC_LIVE = 4                       # draft layers = the target's live layers
SPEC_MAX_LEN = 2112                 # 1900 + 128 tokens + the tree lookahead
MISS_NOISE = 0.04                   # draft noise of the miss path
MISS_HIT_RATE = (0.2, 0.8)          # the range its SSD hit rate must land in
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # fp32 outside the tensor cores
PEAK_OPS_INT8 = 1979e12            # dense int8 tensor-core rate (kv_quant int8_mxu)
LONG_CTX = 8192                    # the long-context decode timing, tokens per sequence
# |got - want| <= ATOL + RTOL[dtype] * |want| elementwise. Both sides compute
# in fp32 and round the output once; 2^-7 |x| bounds one bf16 ulp at x.
ATOL = 1e-4
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one fn() call, by CUDA events around each call,
    with the 50 MB L2 cache flushed before each: on the main path every
    layer's attention finds its KV cold (the layer's weights streamed
    through L2 since its previous step). A spin kernel first holds the
    stream while the host enqueues every call, so the events time the
    device's work and not the host's launch gaps."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's ~2 GHz clock
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def sdpa(q, k, v, mask):
    """One scaled_dot_product_attention call over grouped K/V (q [N, Hq, L, hd],
    k/v [N, Hkv, C, hd], mask [N, 1, L, C] bool)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def _paged_split_resources(lib) -> list[dict]:
    """Registers, spills and shared memory of each instantiation of the
    split-KV paged kernels (csrc/paged_split.cuh), from ptxas's report of
    the build and the kernels' own shared-memory layout."""
    import re

    kinds = {0: "fp", 1: "int8", 2: "int8_mxu"}
    stages = {0: "full", 1: "loads", 2: "math", 3: "empty"}
    out, cur = [], None
    for ln in lib.build_log.splitlines():
        m = re.search(r"paged_split_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", ln)
        if m and "Compiling entry" in ln:
            dt = "bfloat16" if m.group(1) != "f" else "float32"
            hd, mt, kind, stage = (int(x) for x in m.groups()[1:])
            cur = {"dtype": dt, "hd": hd, "row_tiles": mt, "cache": kinds[kind],
                   "stage": stages[stage],
                   "smem_bytes": lib.cdll.ssd_paged_smem_bytes(kind, int(dt == "bfloat16"), hd, mt)}
            out.append(cur)
        elif cur is not None and "spill stores" in ln:
            cur["spill"] = ln.split("stack frame, ")[-1].strip()
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            cur = None
    return out


def phase_env() -> dict:
    import torch

    from ssd_tpu_torch.ops import cuda_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "not read"
    print(card, flush=True)
    lib = cuda_lib.load()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("env", card=card, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], build_seconds=lib.build_seconds,
         library=os.path.relpath(lib.path), ptxas=ptxas,
         paged_split=_paged_split_resources(lib),
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return {"card": card}


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


def _paged_case(B, Q, ctx_lens, M, ghosts, dtype, seed, heads=LLAMA_HEADS):
    """Random q and cache, disjoint shuffled page tables; `ghosts` trailing
    rows are batch padding (context 1, table all -1). `heads` is (Hq, Hkv,
    hd)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    Hq, Hkv, hd = heads
    n_pages = B * M + 1
    kv = torch.randn(Hkv, n_pages * BLOCK, 2 * hd, generator=g)
    q = torch.randn(B, Q, Hq, hd, generator=g)
    perm = torch.randperm(n_pages, generator=g)
    bt = torch.full((B, M), -1, dtype=torch.int32)
    ctx = torch.ones(B, dtype=torch.int32)
    for b in range(B - ghosts):
        ctx[b] = ctx_lens[b]
        n = min(-(-ctx_lens[b] // BLOCK), M)
        bt[b, :n] = perm[b * M: b * M + n].to(torch.int32)
    qeff = torch.full((B,), Q, dtype=torch.int32)
    dev = "cuda"
    return (q.to(dev, dtype), kv.to(dev, dtype), bt.to(dev), ctx.to(dev),
            qeff.to(dev))


def _flat_case(ctx_lens, cached, dtype, seed, pad_rows=0, pad_pages=0,
               heads=LLAMA_HEADS):
    """Mixed prefill batch: sequence s has ctx_lens[s] tokens of which
    cached[s] are already in the cache; its pages form one run of the flat
    page list, and each new token's window is an interval of that run. The
    serving path passes no padding; `pad_rows` rows with lo == hi and
    `pad_pages` -1 pages check the kernel's padding contract."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    Hq, Hkv, hd = heads
    pages_per = [-(-c // BLOCK) for c in ctx_lens]
    n_pages = sum(pages_per) + 1
    perm = rng.permutation(n_pages).astype(np.int32)
    T = sum(c - k for c, k in zip(ctx_lens, cached))
    T_pad, P_pad = T + pad_rows, sum(pages_per) + pad_pages
    lo = np.zeros(T_pad, np.int32)
    hi = np.zeros(T_pad, np.int32)
    pages = np.full(P_pad, -1, np.int32)
    t = p = 0
    for c, k, n in zip(ctx_lens, cached, pages_per):
        pages[p:p + n] = perm[p:p + n]
        lo[t:t + c - k] = p * BLOCK
        hi[t:t + c - k] = p * BLOCK + np.arange(k, c) + 1
        t += c - k
        p += n
    q = rng.standard_normal((T_pad, Hq, hd)).astype(np.float32)
    kv = rng.standard_normal((Hkv, n_pages * BLOCK, 2 * hd)).astype(np.float32)
    dev = "cuda"
    return (torch.from_numpy(q).to(dev, dtype), torch.from_numpy(kv).to(dev, dtype),
            torch.from_numpy(pages).to(dev), torch.from_numpy(lo).to(dev),
            torch.from_numpy(hi).to(dev), T)


def _tree_case(B, step, bases, ghosts, dtype, seed, heads=LLAMA_HEADS):
    """One tree step s of the async draft at K=4, fan-out 2: sequence b's
    recovery token sits at bases[b], so its context is bases[b] + (K+1) +
    (s+1)*MQ. Even rows take the hit fan-out list [2]*5, odd rows a miss
    list [3, 3, 2, 1, 1]; `ghosts` trailing rows are warm-up ghosts (table
    all -1, a prefix of -3). Returns (q, kv, tables, contexts, fan rows)."""
    import numpy as np
    import torch

    M = SPEC_MAX_LEN // BLOCK
    ctx_lens = [b + SPEC_K + 1 + (step + 1) * SPEC_MQ for b in bases]
    q, kv, bt, ctx, _ = _paged_case(B, SPEC_MQ, ctx_lens, M, ghosts, dtype, seed, heads)
    ctx[B - ghosts:] = SPEC_K + 1 + (step + 1) * SPEC_MQ - 3
    hit = np.repeat(np.arange(SPEC_K + 1), [SPEC_F] * (SPEC_K + 1))
    miss = np.repeat(np.arange(SPEC_K + 1), [3, 3, 2, 1, 1])
    fan = np.stack([hit if b % 2 == 0 else miss for b in range(B)]).astype(np.int32)
    return q, kv, bt, ctx, torch.from_numpy(fan).cuda()


def _int8_pair(kv):
    """The cache layer kv [Hkv, S, 2hd] quantized by store_kv into the int8
    pair (data int8 [Hkv, S, 2hd], scales f32 [Hkv, 2, S]), on the card."""
    import torch

    from ssd_tpu_torch.ops import attention as att

    Hkv, S, hd2 = kv.shape
    hd = hd2 // 2
    x = kv.transpose(0, 1)                                      # [S, Hkv, 2hd]
    pair = (torch.zeros(Hkv, S, hd2, dtype=torch.int8, device=kv.device),
            torch.full((Hkv, 2, S), 1e-10, device=kv.device))
    att.store_kv(pair, x[..., :hd], x[..., hd:],
                 torch.arange(S, dtype=torch.int32, device=kv.device))
    return pair


def _check(name, dtype, got, want, case):
    import torch

    if not torch.isfinite(got).all():
        fail(f"{name} {case} {dtype}: non-finite kernel output")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    # The worst element's error over its own tolerance; <= 1 passes.
    excess = (diff / (ATOL + RTOL[dtype] * want.float().abs())).max().item()
    emit("kernels", kernel=name, case=case, dtype=dtype, max_abs_err=err,
         atol=ATOL, rtol=RTOL[dtype], worst_err_over_tol=excess, ok=excess <= 1)
    if not excess <= 1:
        fail(f"{name} {case} {dtype}: max abs err {err}, worst element at "
             f"{excess} x its tolerance ({ATOL} + {RTOL[dtype]} |ref|)")
    return err


def _timing(shape, fn, plain_fn, library_fn, bytes_, ops, peak, iters=50,
            plain_iters=10):
    """One kernel's times at one shape: the kernel, its plain version, the
    library yardstick, and the bound (bytes over the HBM rate or operations
    over `peak`, whichever is larger)."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / peak
    return dict(shape=shape, ms=time_ms(fn, iters),
                plain_ms=time_ms(plain_fn, plain_iters, warmup=1),
                library_ms=time_ms(library_fn, iters) if library_fn else None,
                bytes=bytes_, flops=ops,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _moe_offsets(tokens: int, seed: int):
    """Group offsets [E+1] of `tokens` tokens' top-k experts at the
    Qwen3-30B-A3B geometry, from a seeded random router over random hidden
    states (the last expert masked out, so at least one group is empty), on
    the card: the grouped GEMM's N = tokens * k rows."""
    import torch

    from ssd_tpu_torch.ops import moe
    from ssd_tpu_torch.ops.spec_math import stable_topk_indices

    c = QWEN3_30B_A3B
    E, k, D = c["num_experts"], c["num_experts_per_tok"], c["hidden_size"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(tokens, D, generator=g, device="cuda")
    logits = x @ (torch.randn(D, E, generator=g, device="cuda") * 0.02)
    logits[:, E - 1] = float("-inf")
    return moe.expert_offsets(stable_topk_indices(logits, k).reshape(-1), E)


def _gmm_case(offs, K: int, Nout: int, dtype, seed: int):
    """Random rows x [N, K] (N = offs[-1]) and experts w [E, K, Nout] at the
    init scale 0.02, on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    N, E = int(offs[-1]), offs.numel() - 1
    x = torch.randn(N, K, generator=g, device="cuda").to(dtype)
    w = (torch.randn(E, K, Nout, generator=g, device="cuda") * 0.02).to(dtype)
    return x, w


def _grouped_mm_yardstick(x, w, offs, want):
    """The library yardstick of the grouped GEMM, never called by the port:
    torch._grouped_mm over the same groups where this torch has it and takes
    the operands (w as stored, else a column-major copy), checked against
    the plain version; else one dense matmul of the same operations
    (x @ w[0]). Returns (callable, label)."""
    import torch

    why = "torch has no _grouped_mm"
    if hasattr(torch, "_grouped_mm"):
        ends = offs[1:].contiguous()
        for label, wt in (("torch._grouped_mm", w),
                          ("torch._grouped_mm (w column-major)",
                           w.transpose(1, 2).contiguous().transpose(1, 2))):
            try:
                y = torch._grouped_mm(x, wt, offs=ends)
                torch.cuda.synchronize()
            except RuntimeError as e:
                why = f"torch._grouped_mm refused: {str(e)[:160]}"
                continue
            tol = ATOL + RTOL["bfloat16"] * want.float().abs()
            if bool(((y.float() - want.float()).abs() <= 2 * tol).all()):
                return (lambda: torch._grouped_mm(x, wt, offs=ends)), label
            why = f"{label} disagrees with the plain version"
    w0 = w[0]
    return (lambda: x @ w0), f"dense torch.matmul x @ w[0], the same operations ({why})"


def _sdpa_paged(q, kv_layer, bt, ctx, Q, C, dt):
    """The yardstick's inputs for a paged case: q [B, Hq, Q, hd] and the
    context gathered dense (dequantized for the int8 pair) in q's dtype,
    with the causal mask; the port never calls it."""
    import torch

    from ssd_tpu_torch.ops import attention as att

    k, v = att.gather_pages(kv_layer, bt, BLOCK, C)            # [B, C, Hkv, hd]
    k = k.to(dt).permute(0, 2, 1, 3).contiguous()
    v = v.to(dt).permute(0, 2, 1, 3).contiguous()
    qs = q.permute(0, 2, 1, 3).contiguous()
    rows = torch.arange(Q, device="cuda")[None, :]
    per_row = torch.clamp(ctx[:, None].long() - Q + rows + 1, min=0, max=C)
    pos = torch.arange(C, device="cuda")[None, None, :]
    mask = ((pos < per_row[:, :, None]) & (pos < ctx[:, None, None]))[:, None]
    return lambda: sdpa(qs, k, v, mask)


def _paged_work(q, ctx, bt, Q, C, Hkv, pos_bytes, elem):
    """(bytes, operations) of a paged call: each attended K|V position read
    once (pos_bytes per position and KV head, scales included), q read and
    the output written once, the tables and lengths read once; 4 * hd
    operations per (query head, attended position)."""
    import torch

    B, _, Hq, hd = q.shape
    rows = torch.arange(Q, device="cuda")[None, :]
    per_row = torch.clamp(ctx[:, None].long() - Q + rows + 1, min=0, max=C)
    kv_len = torch.clamp(ctx, max=C).long()
    bytes_ = (int(kv_len.sum()) * Hkv * pos_bytes + 2 * q.numel() * elem
              + bt.numel() * 4 + 2 * ctx.numel() * 4)
    return bytes_, 4 * Hq * hd * int(per_row.sum())


def _bmm_yardstick(qb, kb, want):
    """The bf16 dot's library yardstick, never called by the port: one
    torch.bmm of q by the bf16 copy of k (the cast is not timed), with fp32
    output where this torch takes out_dtype. Returns (callable, label)."""
    import torch

    kt = kb.transpose(1, 2)
    try:
        y = torch.bmm(qb, kt, out_dtype=torch.float32)
        if torch.equal(y.double(), want.double()):
            return (lambda: torch.bmm(qb, kt, out_dtype=torch.float32)), \
                "torch.bmm(q, bf16 k^T, out_dtype=float32)"
    except (TypeError, RuntimeError):
        pass
    return (lambda: torch.bmm(qb, kt)), "torch.bmm(q, bf16 k^T), bf16 output"


def _paged_batch_invariance(decode_ctx: list[int]):
    """The split-KV paged kernels' promise, bit for bit in bf16 over the fp
    cache and both int8 modes, at Llama-3.2-1B's and Qwen3-30B-A3B's heads:
    a call repeated gives the same bits; each sequence's rows alone equal
    its rows in the batch of 8; a Q=1 call equals query 0 of a Q=K+1 call
    whose contexts hold the K later queries (the same causal limit)."""
    import torch

    from ssd_tpu_torch.ops import attention as att

    Q = SPEC_K + 1
    M = SPEC_MAX_LEN // BLOCK
    ctx_lens = [n + Q for n in decode_ctx]
    checked = []
    for heads in (LLAMA_HEADS, QWEN_HEADS):
        scale = heads[2] ** -0.5
        q, kv, bt, ctx, qeff = _paged_case(8, Q, ctx_lens, M, 0, torch.bfloat16, seed=71,
                                           heads=heads)
        pair = _int8_pair(kv)
        for name, layer, s8 in (("paged_attention", kv, False),
                                ("paged_attention_int8", pair, False),
                                ("paged_attention_int8[s8]", pair, True)):
            full = att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, scale, s8=s8)
            same = torch.equal(full, att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, scale,
                                                         s8=s8))
            for b in range(8):
                alone = att.paged_attention(q[b:b + 1], layer, bt[b:b + 1], ctx[b:b + 1],
                                            qeff[:1], BLOCK, scale, s8=s8)
                same = same and torch.equal(alone[0], full[b])
            one = att.paged_attention(q[:, :1].contiguous(), layer, bt, ctx - (Q - 1),
                                      torch.ones_like(qeff), BLOCK, scale, s8=s8)
            same = same and torch.equal(one[:, 0], full[:, 0])
            checked.append(f"{name} hd {heads[2]} G {heads[0] // heads[1]}")
            if not same:
                fail(f"{name} at heads {heads}: not batch-invariant bit for bit")
    emit("kernels", batch_invariance={"bitwise": True, "checked": checked})


def _probe_kernels(record, decode_ctx: list[int]) -> dict:
    """Rows #11 and #12 of the kernel table: the s8 probe's three paths at
    bench/s8_probe.py's shapes, exact against the fp64 plain version; the
    paged kernels' stage variants (K2, and K4's int8 mode) at the decode b8
    batch and at B=8 x LONG_CTX, whose "full" stage must equal the
    production kernel bit for bit. Then both bench entry points run once
    (the probes' own path), with the probe launch counts zeroed just before
    and read just after each."""
    import torch

    from ssd_tpu_torch.bench import kernel_diag, s8_probe
    from ssd_tpu_torch.ops import attention as att
    from ssd_tpu_torch.ops import probes

    timings = {}
    q8, k8, qb = s8_probe.inputs("cuda")
    want = probes.s8_dot_plain(q8, k8)
    N, R, D = q8.shape
    L = k8.shape[1]
    ops = 2 * N * R * L * D
    bmm, bmm_label = _bmm_yardstick(qb, k8.to(torch.bfloat16), want)
    no_lib = "none: torch._int_mm is 2-D; no single call takes a batched s8 product"
    for name, fn, q, peak, lib, label in (
            ("s8_dot_mma", probes.s8_dot_mma, q8, PEAK_OPS_INT8, None, no_lib),
            ("s8_dot_dp4a", probes.s8_dot_dp4a, q8, PEAK_OPS_INT8, None, no_lib),
            ("s8_dot_bf16", probes.s8_dot_bf16, qb, PEAK_FLOPS["bfloat16"], bmm, bmm_label)):
        got = fn(q, k8)
        torch.cuda.synchronize()
        record(name, "s8_probe_shape", "float32", got, want)
        if not torch.equal(got.double(), want.double()):
            fail(f"{name}: differs from its exact plain version")
        bytes_ = q.numel() * q.element_size() + k8.numel() + got.numel() * 4
        tm = _timing(f"q [{N}, {R}, {D}] {q.dtype} . k [{N}, {L}, {D}] int8 -> "
                     f"[{N}, {R}, {L}] {got.dtype}",
                     lambda: fn(q, k8), lambda: probes.s8_dot_plain(q, k8), lib, bytes_, ops,
                     peak, iters=50, plain_iters=5)
        tm["library"] = label
        timings[name] = tm

    scale = 64 ** -0.5
    shapes = {"decode_b8": decode_ctx, f"b8_x_{LONG_CTX}": [LONG_CTX] * 8}
    for name, kvq in (("paged_attention_diag", None), ("paged_attention_int8_diag", "int8")):
        per_shape = {}
        for label, ctx_lens in shapes.items():
            q, layer, bt, ctx, qeff = kernel_diag.decode_case(
                8, 1, 32, 8, 64, BLOCK, ctx_lens, torch.bfloat16, kv_quant=kvq, seed=70)
            args = (q, layer, bt, ctx, qeff, BLOCK, scale)
            prod = att.paged_attention(*args)
            full = probes.paged_attention_diag("full", *args)
            torch.cuda.synchronize()
            record(name, label, "bfloat16", full, att.paged_attention_plain(*args))
            if not torch.equal(full, prod):
                fail(f"{name} {label}: the full stage differs from the production kernel")
            C = bt.shape[1] * BLOCK
            bytes_, ops_ = _paged_work(q, ctx, bt, 1, C, 8, 2 * 64 * 2 if kvq is None
                                       else 2 * 64 + 8, 2)
            tm = _timing(f"decode B=8 (ctx {ctx_lens if label == 'decode_b8' else '8 x %d' % LONG_CTX})"
                         f" Q=1 Hq/Hkv 32/8 hd 64 bf16" + (", int8 cache" if kvq else ""),
                         lambda: probes.paged_attention_diag("full", *args),
                         lambda: att.paged_attention_plain(*args),
                         _sdpa_paged(q, layer, bt, ctx, 1, C, torch.bfloat16), bytes_, ops_,
                         PEAK_FLOPS["bfloat16"], iters=20, plain_iters=3)
            tm["stages_ms"] = {st: time_ms(lambda st=st: probes.paged_attention_diag(st, *args), 20)
                               for st in probes.STAGES}
            # A split of the full time into loads and math is only read when
            # each stage alone takes no longer than the full kernel and the
            # two together no less.
            st = tm["stages_ms"]
            tm["stages_bracket_full"] = (max(st["dma"], st["compute"]) <= st["full"]
                                         <= st["dma"] + st["compute"])
            per_shape[label] = tm
            emit("kernels", kernel=name, stages=tm)
        timings[name] = dict(per_shape["decode_b8"], **{f"at_{k}": v for k, v in per_shape.items()
                                                       if k != "decode_b8"})

    # The probes' own path: their bench entry points, as `python -m` runs them.
    launches = {}
    ctx_arg = ",".join(map(str, decode_ctx))
    runs = (("s8", [], s8_probe.main, ["--iters", "20"]),
            ("paged_attention_diag", ["bf16"], kernel_diag.main, None),
            ("paged_attention_int8_diag", ["int8"], kernel_diag.main, None))
    for name, kv, main_fn, argv in runs:
        for w in probes.PROBE_WRAPPERS:
            w.launches = 0
        if argv is not None:
            main_fn(argv)
        else:
            for ctx_list in (ctx_arg, ",".join([str(LONG_CTX)] * 8)):
                main_fn(["--contexts", ctx_list, "--hd", "64", "--block", str(BLOCK),
                         "--iters", "20", "--kv", kv[0]])
        if name == "s8":
            launches.update({w.__name__: w.launches for w in probes.PROBE_WRAPPERS[:3]})
        else:
            launches[name] = probes.paged_attention_diag.launches
    emit("kernels", probe_launches=launches)
    return {"timings": timings, "launches": launches}


def phase_kernels() -> dict:
    import torch

    from ssd_tpu_torch.ops import attention as att
    from ssd_tpu_torch.ops import moe

    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    scale = 64 ** -0.5
    M = 2048 // BLOCK
    M_spec = SPEC_MAX_LEN // BLOCK
    decode8 = [2048, 1, 700, 1333, 64, 65, 1999]  # + one ghost row
    # SD/SSD verify and glue at Q = K+1 (G*Q = 20 rows per KV head: two full
    # 8-row passes and a partial one); contexts up to the spec engine's
    # table, down to Q itself, + one ghost row.
    verify8 = [SPEC_MAX_LEN, SPEC_K + 1, 700, 1333, 64, 65, 2047]
    # The serve phase's b8 batch halfway through its 128 decode steps.
    serve8 = [n + 64 for n in SERVE_LENS8]
    # decode at B = 1 and B = 8 (one ghost row), the overshoot case (a full
    # table with context beyond it, Q = 4), and the verify shape.
    paged_cases = {
        "decode_b1": (1, 1, [1500], M, 0),
        "decode_b8": (8, 1, decode8, M, 1),
        "overshoot_q4": (3, 4, [258, 100, 256], 4, 0),  # table holds 256
        "verify_b1": (1, SPEC_K + 1, [2090], M_spec, 0),
        "verify_b8": (8, SPEC_K + 1, verify8, M_spec, 1),
    }
    tree_cases = {"tree_b1": (1, [2048], 0),
                  "tree_b8": (8, [1500, 0, 700, 1333, 64, 65, 1999], 1)}
    flat_lens = [17, 100, 300, 600, 900, 1200, 1600, 2048]
    flat_cached = [0, 0, 0, 0, 512, 0, 0, 1024]
    c = QWEN3_30B_A3B
    D, Im = c["hidden_size"], c["moe_intermediate_size"]
    prefill_offs = _moe_offsets(sum(SERVE_LENS8), seed=1)   # N = 5534 * 8 rows
    decode_offs = _moe_offsets(8, seed=2)                   # N = 64 rows
    gmm_cases = {"prefill_gate": (prefill_offs, D, Im), "prefill_down": (prefill_offs, Im, D),
                 "decode_b8_gate": (decode_offs, D, Im), "decode_b8_down": (decode_offs, Im, D)}
    wrappers = _kernel_wrappers()
    results = {}

    def record(name, case, dname, got, want):
        results[(name, case, dname)] = {"max_abs_err": _check(name, dname, got, want, case)}

    for dname, dt in dts.items():
        # K-A (fp cache), then the int8 pair in both modes.
        for seed, (case, args) in enumerate(paged_cases.items()):
            q, kv, bt, ctx, qeff = _paged_case(*args, dt, seed=seed)
            pair = _int8_pair(kv)
            for name, layer, s8 in (("paged_attention", kv, False),
                                    ("paged_attention_int8", pair, False),
                                    ("paged_attention_int8[s8]", pair, True)):
                got = att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, scale, s8=s8)
                torch.cuda.synchronize()
                record(name, case, dname, got,
                       att.paged_attention_plain(q, layer, bt, ctx, qeff, BLOCK, scale, s8=s8))

        # K-B: 8 prompts of 17-2048 tokens, two of them prefix-cached; fp
        # cache and int8 pages.
        q, kv, pages, lo, hi, T = _flat_case(flat_lens, flat_cached, dt, seed=7,
                                             pad_rows=13, pad_pages=3)
        for name, layer in (("flat_prefill_attention", kv),
                            ("flat_prefill_attention_int8", _int8_pair(kv))):
            got = att.flat_prefill_attention(q, layer, pages, lo, hi, BLOCK, scale)
            torch.cuda.synchronize()
            record(name, "mixed8_cached2", dname, got,
                   att.flat_prefill_attention_plain(q, layer, pages, lo, hi, BLOCK, scale))
            if got[T:].abs().max().item() != 0.0:
                fail(f"{name}: padding rows are not zero")

        # K-C: tree steps 0 and K-1 at B = 1 and B = 8 (one warm-up ghost).
        for step in (0, SPEC_K - 1):
            for case, (B, bases, ghosts) in tree_cases.items():
                q, kv, bt, ctx, fan = _tree_case(B, step, bases, ghosts, dt, seed=20 + step)
                pair = _int8_pair(kv)
                for name, layer, s8 in (("tree_attention", kv, False),
                                        ("tree_attention_int8", pair, False),
                                        ("tree_attention_int8[s8]", pair, True)):
                    args = (bt, ctx, fan, step, SPEC_K, BLOCK, scale)
                    got = att.tree_attention(q, layer, *args, s8=s8)
                    torch.cuda.synchronize()
                    record(name, f"{case}_step{step}", dname, got,
                           att.tree_attention_plain(q, layer, *args, s8=s8))

        # The same kernels at Qwen3-30B-A3B's attention geometry (Hq/Hkv
        # 32/4, hd 128): the b8 decode and verify, the tree steps, the mixed
        # prefill; fp cache and int8 pairs.
        s128 = QWEN_HEADS[2] ** -0.5
        # The paged kernels at G 8: decode (8 rows), the Qwen3-MoE verify
        # (Q = K+1, 40 rows) and the glue Q = 2K+1 with per-sequence qeff
        # (72 rows: two row passes), in all three cache modes.
        glue8 = (8, 2 * SPEC_K + 1, [n + 64 + SPEC_K + 1 for n in SERVE_LENS8], M_spec, 0)
        for seed, (case, args) in enumerate((("decode_b8", paged_cases["decode_b8"]),
                                             ("verify_b8", paged_cases["verify_b8"]),
                                             (f"glue_q{2 * SPEC_K + 1}", glue8))):
            q, kv, bt, ctx, qeff = _paged_case(*args, dt, seed=40 + seed, heads=QWEN_HEADS)
            if case.startswith("glue"):
                qeff = torch.tensor([SPEC_K + 1 + b % (SPEC_K + 1) for b in range(8)],
                                    dtype=torch.int32, device="cuda")
            pair = _int8_pair(kv)
            for name, layer, s8 in (("paged_attention", kv, False),
                                    ("paged_attention_int8", pair, False),
                                    ("paged_attention_int8[s8]", pair, True)):
                got = att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, s128, s8=s8)
                torch.cuda.synchronize()
                record(name, f"{case}_hd128_g8", dname, got,
                       att.paged_attention_plain(q, layer, bt, ctx, qeff, BLOCK, s128, s8=s8))
        q, kv, pages, lo, hi, T = _flat_case(flat_lens, flat_cached, dt, seed=42, pad_rows=13,
                                             pad_pages=3, heads=QWEN_HEADS)
        for name, layer in (("flat_prefill_attention", kv),
                            ("flat_prefill_attention_int8", _int8_pair(kv))):
            got = att.flat_prefill_attention(q, layer, pages, lo, hi, BLOCK, s128)
            torch.cuda.synchronize()
            record(name, "mixed8_cached2_hd128", dname, got,
                   att.flat_prefill_attention_plain(q, layer, pages, lo, hi, BLOCK, s128))
            if got[T:].abs().max().item() != 0.0:
                fail(f"{name} hd 128: padding rows are not zero")
        B, bases, ghosts = tree_cases["tree_b8"]
        q, kv, bt, ctx, fan = _tree_case(B, SPEC_K - 1, bases, ghosts, dt, seed=43,
                                         heads=QWEN_HEADS)
        for name, layer in (("tree_attention", kv), ("tree_attention_int8", _int8_pair(kv))):
            args = (bt, ctx, fan, SPEC_K - 1, SPEC_K, BLOCK, s128)
            got = att.tree_attention(q, layer, *args)
            torch.cuda.synchronize()
            record(name, f"tree_b8_step{SPEC_K - 1}_hd128", dname, got,
                   att.tree_attention_plain(q, layer, *args))

        # K6: the grouped GEMM at the Qwen3-30B-A3B expert shapes, rows from
        # a seeded router: the prefill dispatch of the serve prompts and a
        # b8 decode dispatch, gate/up (D -> Im) and down (Im -> D).
        for case, (offs, K, Nout) in gmm_cases.items():
            x, w = _gmm_case(offs, K, Nout, dt, seed=50)
            got = moe.grouped_gemm(x, w, offs)
            torch.cuda.synchronize()
            record("grouped_gemm", case, dname, got, moe.grouped_gemm_plain(x, w, offs))
            del x, w, got

    _paged_batch_invariance(serve8)

    # Times at the main-path shapes in bf16 (the serving dtype).
    counts = [w.launches for w in wrappers]
    timings = {}
    dt, dname = torch.bfloat16, "bfloat16"
    elem = 2
    Hq, Hkv, hd = 32, 8, 64
    fp_pos, i8_pos = 2 * hd * elem, 2 * hd + 8   # bytes per (position, KV head)

    def time_paged(Q, ctx_lens, M, seed, shape, mode=None, iters=50, plain_iters=10):
        q, kv, bt, ctx, qeff = _paged_case(len(ctx_lens), Q, ctx_lens, M, 0, dt, seed=seed)
        C = M * BLOCK
        layer = kv if mode is None else _int8_pair(kv)
        s8 = mode == "int8_mxu"
        bytes_, ops = _paged_work(q, ctx, bt, Q, C, Hkv, fp_pos if mode is None else i8_pos, elem)
        peak = PEAK_OPS_INT8 if s8 else PEAK_FLOPS[dname]
        return _timing(
            shape + ("" if mode is None else f", {mode} cache"),
            lambda: att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, scale, s8=s8),
            lambda: att.paged_attention_plain(q, layer, bt, ctx, qeff, BLOCK, scale, s8=s8),
            _sdpa_paged(q, layer, bt, ctx, Q, C, dt), bytes_, ops, peak, iters, plain_iters)

    decode_shape = f"decode B=8 (ctx {serve8}) Q=1 Hq/Hkv 32/8 hd 64 bf16"
    # The SD/SSD b8 verify halfway through 128 tokens: the same batch with
    # the K+1 verified tokens in the context.
    verify_ctx = [n + SPEC_K + 1 for n in serve8]
    verify_shape = f"verify B=8 (ctx {verify_ctx}) Q={SPEC_K + 1} Hq/Hkv 32/8 hd 64 bf16"
    at_verify = {}
    for name, mode in (("paged_attention", None), ("paged_attention_int8", "int8"),
                       ("paged_attention_int8[s8]", "int8_mxu")):
        timings[name] = time_paged(1, serve8, M, 11, decode_shape, mode)
        at_verify[name] = time_paged(SPEC_K + 1, verify_ctx, M_spec, 12, verify_shape, mode)
        emit("kernels", kernel=name, timing=at_verify[name])
    # The regime the int8 cache exists for: B=8 at LONG_CTX tokens each.
    long_ctx = {}
    M_long = LONG_CTX // BLOCK
    for name, mode in (("paged_attention", None), ("paged_attention_int8", "int8"),
                       ("paged_attention_int8[s8]", "int8_mxu")):
        long_ctx[name] = time_paged(
            1, [LONG_CTX] * 8, M_long, 14,
            f"decode B=8 x {LONG_CTX} tokens Q=1 Hq/Hkv 32/8 hd 64 bf16", mode,
            iters=20, plain_iters=3)
        emit("kernels", kernel=name, long_context=long_ctx[name])

    def flat_timing(lens, cached, seed, shape, int8):
        q, kv, pages, lo, hi, T = _flat_case(lens, cached, dt, seed=seed)
        layer = _int8_pair(kv) if int8 else kv
        n_pages = sum(-(-c // BLOCK) for c in lens)
        bytes_ = (n_pages * BLOCK * Hkv * (i8_pos if int8 else fp_pos)
                  + 2 * T * Hq * hd * elem + pages.numel() * 4 + 2 * T * 4)
        ops = int(4 * Hq * hd * (hi - lo).long().sum())
        dense = att.dense_pages(layer, pages, BLOCK).to(dt)          # [Hkv, C, 2hd]
        kd, vd = dense[..., :hd][None].contiguous(), dense[..., hd:][None].contiguous()
        qs = q.permute(1, 0, 2)[None].contiguous()                  # [1, Hq, T, hd]
        col = torch.arange(dense.shape[1], device="cuda")
        mask = ((col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None]))[None, None]
        return _timing(
            shape.format(T=T) + (", int8 pages" if int8 else ""),
            lambda: att.flat_prefill_attention(q, layer, pages, lo, hi, BLOCK, scale),
            lambda: att.flat_prefill_attention_plain(q, layer, pages, lo, hi, BLOCK, scale),
            lambda: sdpa(qs, kd, vd, mask), bytes_, ops, PEAK_FLOPS[dname],
            iters=10, plain_iters=3)

    prefill_shape = (f"prefill 8 prompts ctx {flat_lens}, cached {flat_cached}, "
                     "T={T} Hq/Hkv 32/8 hd 64 bf16")
    timings["flat_prefill_attention"] = flat_timing(flat_lens, flat_cached, 13,
                                                    prefill_shape, False)
    timings["flat_prefill_attention_int8"] = flat_timing(flat_lens, flat_cached, 13,
                                                         prefill_shape, True)
    # Row #4 of the TPU kernel table (the JAX draft prefill's grouped
    # kernel) is computed here by K1: its time at the draft-prefill shape,
    # the serve b8 prompts with nothing cached.
    draft_prefill = flat_timing(
        SERVE_LENS8, [0] * 8, 17,
        f"draft prefill, 8 prompts {SERVE_LENS8}, nothing cached, T={{T}} Hq/Hkv 32/8 hd 64 bf16",
        False)
    emit("kernels", kernel="flat_prefill_attention", tpu_row="#4 _paged_attn_kernel "
         "(draft prefill)", timing=draft_prefill)

    # The tree build's last step at b8: the serve b8 batch after 64 steps.
    step = SPEC_K - 1
    q, kv, bt, ctx, fan = _tree_case(8, step, [n + 64 for n in SERVE_LENS8], 0, dt, seed=31)
    C = bt.shape[1] * BLOCK
    from ssd_tpu_torch.ops.spec_math import tree_attention_mask

    mask = tree_attention_mask(ctx, step, fan, SPEC_K, SPEC_MQ, C)      # [B, MQ, C]
    kv_len = int(torch.clamp(ctx, max=C).long().sum())
    ops = 4 * Hq * hd * int(mask.sum())
    qs = q.permute(0, 2, 1, 3).contiguous()                      # [B, Hq, MQ, hd]
    pair = _int8_pair(kv)
    for name, mode in (("tree_attention", None), ("tree_attention_int8", "int8"),
                       ("tree_attention_int8[s8]", "int8_mxu")):
        layer = kv if mode is None else pair
        s8 = mode == "int8_mxu"
        bytes_ = (kv_len * Hkv * (fp_pos if mode is None else i8_pos) + 2 * q.numel() * elem
                  + bt.numel() * 4 + ctx.numel() * 4 + fan.numel() * 4)
        args = (q, layer, bt, ctx, fan, step, SPEC_K, BLOCK, scale)
        k, v = att.gather_pages(layer, bt, BLOCK, C)             # [B, C, Hkv, hd]
        k = k.to(dt).permute(0, 2, 1, 3).contiguous()
        v = v.to(dt).permute(0, 2, 1, 3).contiguous()
        timings[name] = _timing(
            f"tree step {step} of K={SPEC_K}, B=8 (ctx {ctx.tolist()}) MQ={SPEC_MQ} "
            f"Hq/Hkv 32/8 hd 64 bf16" + ("" if mode is None else f", {mode} cache"),
            lambda: att.tree_attention(*args, s8=s8),
            lambda: att.tree_attention_plain(*args, s8=s8),
            lambda: sdpa(qs, k, v, mask[:, None]), bytes_, ops,
            PEAK_OPS_INT8 if s8 else PEAK_FLOPS[dname])

    # K1 and K2 at Qwen3-30B-A3B's attention geometry (Hq/Hkv 32/4, hd 128):
    # the moe phase's b8 decode halfway through and its b8 prefill.
    qwen = {}
    Hq, Hkv, hd = QWEN_HEADS
    s128, fp_pos = hd ** -0.5, 2 * hd * elem
    q, kv, bt, ctx, qeff = _paged_case(8, 1, serve8, M, 0, dt, seed=44, heads=QWEN_HEADS)
    bytes_, ops = _paged_work(q, ctx, bt, 1, M * BLOCK, Hkv, fp_pos, elem)
    qwen["paged_attention"] = _timing(
        f"decode B=8 (ctx {serve8}) Q=1 Hq/Hkv 32/4 hd 128 bf16",
        lambda: att.paged_attention(q, kv, bt, ctx, qeff, BLOCK, s128),
        lambda: att.paged_attention_plain(q, kv, bt, ctx, qeff, BLOCK, s128),
        _sdpa_paged(q, kv, bt, ctx, 1, M * BLOCK, dt), bytes_, ops, PEAK_FLOPS[dname])
    q, kv, pages, lo, hi, T = _flat_case(SERVE_LENS8, [0] * 8, dt, seed=45, heads=QWEN_HEADS)
    n_pages = sum(-(-n // BLOCK) for n in SERVE_LENS8)
    bytes_ = n_pages * BLOCK * Hkv * fp_pos + 2 * T * Hq * hd * elem + pages.numel() * 4 + 2 * T * 4
    ops = int(4 * Hq * hd * (hi - lo).long().sum())
    dense = att.dense_pages(kv, pages, BLOCK)
    kd, vd = dense[..., :hd][None].contiguous(), dense[..., hd:][None].contiguous()
    qs = q.permute(1, 0, 2)[None].contiguous()
    col = torch.arange(dense.shape[1], device="cuda")
    mask = ((col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None]))[None, None]
    qwen["flat_prefill_attention"] = _timing(
        f"prefill 8 prompts {SERVE_LENS8}, nothing cached, T={T} Hq/Hkv 32/4 hd 128 bf16",
        lambda: att.flat_prefill_attention(q, kv, pages, lo, hi, BLOCK, s128),
        lambda: att.flat_prefill_attention_plain(q, kv, pages, lo, hi, BLOCK, s128),
        lambda: sdpa(qs, kd, vd, mask), bytes_, ops, PEAK_FLOPS[dname], iters=10, plain_iters=3)
    del q, kv, kd, vd, dense
    for name, tm in qwen.items():
        emit("kernels", kernel=name, qwen3_moe_geometry=tm)

    # K6 at the four dispatch shapes; the prefill gate call is its headline.
    gmm_times = {}
    for case, (offs, K, Nout) in gmm_cases.items():
        x, w = _gmm_case(offs, K, Nout, dt, seed=51)
        want = moe.grouped_gemm_plain(x, w, offs)
        N = x.shape[0]
        active = int((offs[1:] > offs[:-1]).sum())
        bytes_ = (N * K + active * K * Nout + N * Nout) * elem + offs.numel() * 4
        library, label = _grouped_mm_yardstick(x, w, offs, want)
        tm = _timing(f"{case}: N={N} rows over {active} of {offs.numel() - 1} experts, "
                     f"K={K} -> Nout={Nout} bf16",
                     lambda: moe.grouped_gemm(x, w, offs),
                     lambda: moe.grouped_gemm_plain(x, w, offs),
                     library, bytes_, 2 * N * K * Nout, PEAK_FLOPS[dname],
                     iters=20, plain_iters=3)
        tm["library"] = label
        gmm_times[case] = tm
        emit("kernels", kernel="grouped_gemm", timing=tm)
        del x, w, want
    timings["grouped_gemm"] = gmm_times["prefill_gate"]

    # Llama-3.1-8B's attention (Hq/Hkv 32/8, hd 128, G 4: the eagle phase's
    # target and head): K1 at the EAGLE draft prefill of the 8 serve prompts
    # (each prompt's n-1 tokens at draft positions 0..n-2, nothing cached)
    # and K2 at the glue shape Q = 2K+1 with a per-sequence qeff of
    # n_ext + K + 1, held against their plain versions in both dtypes, then
    # timed in bf16.
    Hq, Hkv, hd = LLAMA8B_HEADS
    s8b, fp_pos = hd ** -0.5, 2 * hd * elem
    draft_lens = [n - 1 for n in _eagle_lens()]
    W = 2 * SPEC_K + 1
    glue_ctx = [n + 64 + SPEC_K + 1 for n in _eagle_lens()]   # base + 1 + K, 64 steps in
    glue_qeff = [SPEC_K + 1 + (b % (SPEC_K + 1)) for b in range(8)]  # n_ext 0..K

    def glue_case(dtc, seed):
        q, kv, bt, ctx, _ = _paged_case(8, W, glue_ctx, M_spec, 0, dtc, seed=seed,
                                        heads=LLAMA8B_HEADS)
        return q, kv, bt, ctx, torch.tensor(glue_qeff, dtype=torch.int32, device="cuda")

    # The other shapes of the eagle phase at G 4, where a Q=1 step takes
    # K2/K4's 4-row instantiation (Q*G = 4) and Q=K+1 the 8-row one: the
    # target's b8 decode 64 steps in, its verify, and the head's last chain
    # step (draft context base + K with base = num_tokens - 2), all over the
    # EAGLE_MAX_LEN table; then K3/K5 at the head's last tree step.
    M_e = EAGLE_MAX_LEN // BLOCK
    at64 = [n + 64 for n in _eagle_lens()]
    eagle_paged = {"decode_b8": (8, 1, at64, M_e, 0),
                   "verify_b8": (8, SPEC_K + 1, [n + SPEC_K + 1 for n in at64], M_e, 0),
                   "chain_b8": (8, 1, [n - 2 + SPEC_K for n in at64], M_e, 0)}
    paged_layers = (("paged_attention", False, False), ("paged_attention_int8", True, False),
                    ("paged_attention_int8[s8]", True, True))

    for dn, dtc in dts.items():
        q, kv, pages, lo, hi, T = _flat_case(draft_lens, [0] * 8, dtc, seed=60,
                                             heads=LLAMA8B_HEADS)
        got = att.flat_prefill_attention(q, kv, pages, lo, hi, BLOCK, s8b)
        torch.cuda.synchronize()
        record("flat_prefill_attention", "eagle_draft_prefill_hd128_g4", dn, got,
               att.flat_prefill_attention_plain(q, kv, pages, lo, hi, BLOCK, s8b))
        cases = [(f"eagle_glue_q{W}", glue_case(dtc, 61))]
        cases += [(f"eagle_{case}", _paged_case(*args, dtc, seed=64 + i, heads=LLAMA8B_HEADS))
                  for i, (case, args) in enumerate(eagle_paged.items())]
        for case, (q, kv, bt, ctx, qeff) in cases:
            pair = _int8_pair(kv)
            for name, int8, s8 in paged_layers:
                layer = pair if int8 else kv
                got = att.paged_attention(q, layer, bt, ctx, qeff, BLOCK, s8b, s8=s8)
                torch.cuda.synchronize()
                record(name, f"{case}_hd128_g4", dn, got,
                       att.paged_attention_plain(q, layer, bt, ctx, qeff, BLOCK, s8b, s8=s8))
        q, kv, bt, ctx, fan = _tree_case(8, SPEC_K - 1, [n - 2 for n in at64], 0, dtc,
                                         seed=67, heads=LLAMA8B_HEADS)
        pair = _int8_pair(kv)
        for name, int8, s8 in paged_layers:
            name = name.replace("paged", "tree")
            layer = pair if int8 else kv
            args = (bt, ctx, fan, SPEC_K - 1, SPEC_K, BLOCK, s8b)
            got = att.tree_attention(q, layer, *args, s8=s8)
            torch.cuda.synchronize()
            record(name, f"eagle_tree_b8_step{SPEC_K - 1}_hd128_g4", dn, got,
                   att.tree_attention_plain(q, layer, *args, s8=s8))
        del q, kv, pair, cases
    eagle_t = {}
    q, kv, pages, lo, hi, T = _flat_case(draft_lens, [0] * 8, dt, seed=62, heads=LLAMA8B_HEADS)
    n_pages = sum(-(-n // BLOCK) for n in draft_lens)
    bytes_ = n_pages * BLOCK * Hkv * fp_pos + 2 * T * Hq * hd * elem + pages.numel() * 4 + 2 * T * 4
    ops = int(4 * Hq * hd * (hi - lo).long().sum())
    dense = att.dense_pages(kv, pages, BLOCK)
    kd, vd = dense[..., :hd][None].contiguous(), dense[..., hd:][None].contiguous()
    qs = q.permute(1, 0, 2)[None].contiguous()
    col = torch.arange(dense.shape[1], device="cuda")
    mask = ((col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None]))[None, None]
    eagle_t["flat_prefill_attention"] = _timing(
        f"EAGLE draft prefill, 8 prompts {draft_lens}, nothing cached, T={T} "
        f"Hq/Hkv 32/8 hd 128 bf16",
        lambda: att.flat_prefill_attention(q, kv, pages, lo, hi, BLOCK, s8b),
        lambda: att.flat_prefill_attention_plain(q, kv, pages, lo, hi, BLOCK, s8b),
        lambda: sdpa(qs, kd, vd, mask), bytes_, ops, PEAK_FLOPS[dname], iters=10, plain_iters=3)
    del kd, vd, dense
    q, kv, bt, ctx, qeff = glue_case(dt, 63)
    C = M_spec * BLOCK
    rows = torch.arange(W, device="cuda")[None, :]
    limit = torch.minimum(ctx[:, None].long() - qeff[:, None].long() + rows + 1,
                          ctx[:, None].long())                        # attended per row
    bytes_ = (int(ctx.long().sum()) * Hkv * fp_pos + 2 * q.numel() * elem
              + bt.numel() * 4 + 2 * ctx.numel() * 4)
    k, v = att.gather_pages(kv, bt, BLOCK, C)
    k = k.permute(0, 2, 1, 3).contiguous()
    v = v.permute(0, 2, 1, 3).contiguous()
    pos = torch.arange(C, device="cuda")[None, None, :]
    gmask = (pos < limit[:, :, None])[:, None]
    qg = q.permute(0, 2, 1, 3).contiguous()
    eagle_t["paged_attention"] = _timing(
        f"EAGLE glue B=8 (ctx {glue_ctx}) Q={W} qeff {glue_qeff} Hq/Hkv 32/8 hd 128 bf16",
        lambda: att.paged_attention(q, kv, bt, ctx, qeff, BLOCK, s8b),
        lambda: att.paged_attention_plain(q, kv, bt, ctx, qeff, BLOCK, s8b),
        lambda: sdpa(qg, k, v, gmask), bytes_, 4 * Hq * hd * int(limit.sum()),
        PEAK_FLOPS[dname])
    del k, v
    for name, tm in eagle_t.items():
        emit("kernels", kernel=name, llama31_8b_eagle=tm)

    probes_out = _probe_kernels(record, serve8)
    timings.update(probes_out["timings"])

    for name, tm in timings.items():
        emit("kernels", kernel=name, timing=tm)
    for w, n in zip(wrappers, counts):
        w.launches = n
    return {"errors": results, "timings": timings, "at_verify": at_verify,
            "long_context": long_ctx, "qwen3_moe": qwen, "grouped_gemm": gmm_times,
            "llama31_8b_eagle": eagle_t, "probes": probes_out}


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------


def _write_config(d: str, base: dict = LLAMA_1B, **over):
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({**base, **over}, f)


def _serving_llm(**kw):
    """The full-width Llama-3.2-1B engine with random bf16 weights."""
    from ssd_tpu_torch import LLM

    with tempfile.TemporaryDirectory() as d:
        _write_config(d)
        return LLM(d, init_random=True, dtype="bfloat16", max_model_len=2048,
                   kvcache_block_size=BLOCK, max_num_seqs=8, **kw)


def _serving_prompts(V: int = LLAMA_1B["vocab_size"]):
    """8 prompts of mixed length (33-1900 tokens) and one of 512, token ids
    below V."""
    import numpy as np

    rng = np.random.default_rng(0)
    return ([rng.integers(3, V, size=n).tolist() for n in SERVE_LENS8],
            [rng.integers(3, V, size=512).tolist()])


def phase_serve() -> dict:
    import torch

    from ssd_tpu_torch import SamplingParams
    from ssd_tpu_torch.ops import attention as att

    V = LLAMA_1B["vocab_size"]
    t0 = time.perf_counter()
    llm = _serving_llm()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sp = SamplingParams(temperature=0.0, max_new_tokens=128, ignore_eos=True)
    prompts8, prompt1 = _serving_prompts()
    llm.generate([p[:40] for p in prompts8[:2]],
                 SamplingParams(temperature=0.0, max_new_tokens=4, ignore_eos=True),
                 use_tqdm=False)  # warm-up: cuBLAS handles, allocator

    att.paged_attention.launches = 0
    att.flat_prefill_attention.launches = 0
    runs = {}
    for name, prompts in (("b8", prompts8), ("b1", prompt1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, m = llm.generate(prompts, sp, use_tqdm=False)
        wall = time.perf_counter() - t0
        for o in outs:
            ids = o["token_ids"]
            if len(ids) != 128 or not all(0 <= t < V for t in ids):
                fail(f"serve {name}: bad output of {len(ids)} tokens")
        runs[name] = dict(
            prompts=len(prompts), prompt_tokens=sum(map(len, prompts)),
            new_tokens=128 * len(prompts), wall_s=wall,
            ttft_s=m["target_step_times"][0],
            prefill_tok_s=m["prefill_total_tokens"] / m["prefill_total_time"],
            decode_tok_s=m["decode_total_tokens"] / m["decode_total_time"],
            decode_step_ms=1e3 * m["decode_total_time"] / max(1, len(m["target_step_times"]) - 1),
        )
    launches = {"paged_attention": att.paged_attention.launches,
                "flat_prefill_attention": att.flat_prefill_attention.launches}
    pool = llm.model_runner.pool_sizing
    emit("serve", geometry="Llama-3.2-1B (16 layers, random bf16 weights)",
         init_s=init_s, kv_blocks=llm.model_runner.num_kvcache_blocks, pool=pool,
         runs=runs, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    if not all(n > 0 for n in launches.values()):
        fail(f"serve: a kernel of the main path never launched: {launches}")
    del llm
    torch.cuda.empty_cache()
    return {"launches": launches, "runs": runs, "pool": pool}


def phase_profile(moe: bool = False) -> dict:
    """Not run by default: where a serving step's time goes. The same engine
    and prompts as `serve` (with moe=True, as `moe`); one prefill step of the
    8 prompts, then a window of decode steps at b=8, each timed without and
    then with torch.profiler, which gives the device's busy time (sum of
    kernel times; one stream) and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ssd_tpu_torch import SamplingParams

    if moe:
        llm, _ = _moe_llm()
        prompts8, _ = _serving_prompts(QWEN3_30B_A3B["vocab_size"])
    else:
        llm = _serving_llm()
        prompts8, _ = _serving_prompts()
    llm.generate([p[:40] for p in prompts8[:2]],
                 SamplingParams(temperature=0.0, max_new_tokens=4, ignore_eos=True),
                 use_tqdm=False)  # warm-up

    def window(steps: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            llm.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    sp = SamplingParams(temperature=0.0, max_new_tokens=100, ignore_eos=True)
    out = {}
    for label, steps in (("prefill_b8", 1), ("decode_b8", 20)):
        if label == "prefill_b8":
            for p in prompts8:
                llm.add_request(p, sp)
            plain_s = None   # the prefill happens once
        else:
            plain_s = window(steps)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_s = window(steps)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        out[label] = dict(
            steps=steps, wall_ms_per_step=None if plain_s is None else plain_s * 1e3 / steps,
            profiled_wall_ms_per_step=prof_s * 1e3 / steps,
            device_busy_ms_per_step=busy_us / 1e3 / steps,
            device_busy_share=busy_us / 1e6 / (plain_s or prof_s),
            top_kernels=[dict(name=e.key[:90], ms_per_step=e.self_device_time_total / 1e3 / steps,
                              calls=e.count) for e in top])
    emit("moe_profile" if moe else "profile",
         geometry=MOE_GEOMETRY if moe else "Llama-3.2-1B (16 layers, random bf16 weights)", **out)
    llm.exit()
    del llm
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 4
# ---------------------------------------------------------------------------

PROJ = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def _spec_pair(d: str, layers: int, live: int, scale: float, dtype, seed: int):
    """Write a target/draft checkpoint pair with the construction of the JAX
    package's bench.py::build_spec_checkpoints: the target's layers >= live
    have o_proj = down = 0 (an exact residual pass-through) and the draft is
    the target's `live` layers with the same embeddings, so greedy tokens
    agree while the draft costs live/layers of the target. Random normal
    weights times `scale` from a generator seeded with `seed`, drawn on the
    card. Returns (target dir, draft dir)."""
    import torch

    from ssd_tpu_torch.utils.loader import save_safetensors

    c = LLAMA_1B
    D, I, hd = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    Hq, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape, zero=False):
        x = torch.randn(*shape, generator=g, device="cuda") * scale
        return (torch.zeros_like(x) if zero else x).to(dtype).cpu()

    def ones(n):
        return torch.ones(n, dtype=dtype)

    target = {"model.embed_tokens.weight": w(c["vocab_size"], D),
              "model.norm.weight": ones(D)}
    draft = dict(target)
    for i in range(layers):
        p = f"model.layers.{i}."
        dead = i >= live
        layer = {
            p + "input_layernorm.weight": ones(D),
            p + "post_attention_layernorm.weight": ones(D),
            p + "self_attn.q_proj.weight": w(Hq * hd, D),
            p + "self_attn.k_proj.weight": w(Hkv * hd, D),
            p + "self_attn.v_proj.weight": w(Hkv * hd, D),
            p + "self_attn.o_proj.weight": w(D, Hq * hd, zero=dead),
            p + "mlp.gate_proj.weight": w(I, D),
            p + "mlp.up_proj.weight": w(I, D),
            p + "mlp.down_proj.weight": w(D, I, zero=dead),
        }
        target.update(layer)
        if not dead:
            draft.update(layer)
    dirs = []
    for name, tensors, n in (("target", target, layers), ("draft", draft, live)):
        sub = os.path.join(d, name)
        os.makedirs(sub)
        save_safetensors(os.path.join(sub, "model.safetensors"), tensors)
        _write_config(sub, num_hidden_layers=n)
        dirs.append(sub)
    return tuple(dirs)


def _kernel_wrappers() -> tuple:
    """Every kernel wrapper whose `launches` a run zeroes and reads."""
    from ssd_tpu_torch.ops import attention as att
    from ssd_tpu_torch.ops import moe

    return att.KERNEL_WRAPPERS + (moe.grouped_gemm,)


def _draft_params(llm) -> dict:
    runner = llm.draft_server.runner if llm.draft_server is not None else llm.draft_runner
    return runner.params


def _perturb_draft(llm, noise: float, scale: float):
    """bench.py's draft_noise on the freshly loaded draft: every projection
    of the live layers becomes w + (scale * noise) * N(0, 1), drawn from a
    host generator seeded 1000 + layer."""
    import torch

    params = _draft_params(llm)
    for i, lp in enumerate(params["layers"]):
        # Drawn on the host, so the card's and the CPU's drafts are the same.
        g = torch.Generator().manual_seed(1000 + i)
        for k in PROJ:
            z = torch.randn(lp[k].shape, generator=g) * (scale * noise)
            lp[k].copy_(lp[k] + z.to(lp[k].device, lp[k].dtype))
    torch.cuda.synchronize()


class _Spans:
    """CUDA events around every call of cls.name, recorded on the stream
    that is current in the calling thread (the draft's own stream for the
    tree build, the target's for the verify)."""

    def __init__(self, cls, name):
        import torch

        self.cls, self.name, self.orig = cls, name, getattr(cls, name)
        self.pairs = []
        orig, pairs = self.orig, self.pairs

        def wrapped(obj, *args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(obj, *args, **kwargs)
            end.record()
            pairs.append((start, end))
            return out

        setattr(cls, name, wrapped)

    def restore(self):
        setattr(self.cls, self.name, self.orig)

    def intervals(self, ref) -> list[tuple[float, float]]:
        return [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in self.pairs]


def _overlap(builds, verifies) -> dict:
    """How much of the draft's tree-build time on the card fell inside the
    target's verify windows."""
    total = sum(e - s for s, e in builds)
    inside = sum(max(0.0, min(e, ve) - max(s, vs))
                 for s, e in builds for vs, ve in verifies)
    return dict(tree_builds=len(builds), tree_build_ms_total=total,
                verifies=len(verifies), verify_ms_total=sum(e - s for s, e in verifies),
                overlapped_ms=inside, overlap_share_of_build=inside / total if total else None)


def _spec_llm(tdir, ddir, mode, **kw):
    from ssd_tpu_torch import LLM

    extra = dict(draft_async=True, async_fan_out=SPEC_F) if mode == "ssd" else {}
    return LLM(tdir, draft=ddir, speculate=True, speculate_k=SPEC_K, **extra, **kw)


def _spec_run(llm, mode, prompts, n_new, V: int = LLAMA_1B["vocab_size"]):
    """One measured generate of a main path ("ar", "sd" or "ssd", the last
    with a plain or an EAGLE draft): launch counts zeroed just before and
    read just after; for SD and SSD the accepted lengths, tree-build/verify
    spans on the card, the draft's step and chain times."""
    import torch

    from ssd_tpu_torch import SamplingParams
    from ssd_tpu_torch.engine.draft_runner import DraftRunner
    from ssd_tpu_torch.engine.speculator_sync import SpeculatorSync
    from ssd_tpu_torch.engine.verifier import Verifier

    sp = SamplingParams(temperature=0.0, max_new_tokens=n_new, ignore_eos=True)
    n_steps0 = 0
    if mode == "ssd":
        # A tree build left running by an earlier generate (the warm-up)
        # must not launch into this run's counts or spans.
        llm.draft_server.drain()
        n_steps0 = len(llm.draft_server._step_times)
    verify_spans = _Spans(Verifier, "verify")
    build_spans = _Spans(type(llm.draft_server.runner) if mode == "ssd" else DraftRunner,
                         "build_tree")
    chain_spans = _Spans(SpeculatorSync, "speculate")
    torch.cuda.synchronize()
    ref = torch.cuda.Event(enable_timing=True)
    ref.record()
    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    try:
        outs, m = llm.generate(prompts, sp, use_tqdm=False)
        if mode == "ssd":
            # The tree build answering the last step runs on after generate
            # returns; it belongs to this run, so its launches count.
            llm.draft_server.drain()
    finally:
        launches = {w.__name__: w.launches for w in wrappers}
        for spans in (verify_spans, build_spans, chain_spans):
            spans.restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for o in outs:
        ids = o["token_ids"]
        if len(ids) != n_new or not all(0 <= t < V for t in ids):
            fail(f"spec {mode}: bad output of {len(ids)} tokens")
    run = dict(
        prompts=len(prompts), new_tokens=n_new * len(prompts), wall_s=wall,
        ttft_s=m["target_step_times"][0],
        decode_tok_s=m["decode_total_tokens"] / m["decode_total_time"],
        launches=launches)
    if mode == "ar":
        return run, [o["token_ids"] for o in outs]
    lens = m["accepted_suffix_lens_with_recovery"]
    run.update(spec_steps=len(m["target_verify_times"]),
               mean_accepted_suffix_len=sum(lens) / len(lens),
               target_verify_ms=1e3 * sum(m["target_verify_times"]) / len(m["target_verify_times"]))
    if mode == "ssd":
        steps = llm.draft_server._step_times[n_steps0:]
        run.update(cache_hit_rate=sum(m["cache_hits"]) / len(m["cache_hits"]),
                   draft_step_ms=1e3 * sum(steps) / len(steps),
                   overlap=_overlap(build_spans.intervals(ref), verify_spans.intervals(ref)))
    else:
        chain = chain_spans.intervals(ref)
        run.update(draft_chain_ms=sum(e - s for s, e in chain) / len(chain))
    return run, [o["token_ids"] for o in outs]


def phase_spec() -> dict:
    """Sync SD and async SSD at the full Llama-3.2-1B width (module
    docstring, phase 4)."""
    import torch

    from ssd_tpu_torch import SamplingParams

    prompts8, prompt1 = _serving_prompts()
    warm = SamplingParams(temperature=0.0, max_new_tokens=8, ignore_eos=True)
    out = {"runs": {}, "noise": MISS_NOISE}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        tdir, ddir = _spec_pair(d, layers=16, live=SPEC_LIVE, scale=0.02,
                                dtype=torch.bfloat16, seed=0)
        out["checkpoints_s"] = time.perf_counter() - t0
        engine = dict(dtype="bfloat16", max_model_len=SPEC_MAX_LEN,
                      kvcache_block_size=BLOCK, max_num_seqs=8)

        for level in (0.0, MISS_NOISE):
            for mode in ("sd", "ssd"):
                llm = _spec_llm(tdir, ddir, mode, **engine)
                if level:
                    _perturb_draft(llm, level, 0.02)
                llm.generate([p[:40] for p in prompts8[:2]], warm, use_tqdm=False)
                for name, prompts in (("b8", prompts8), ("b1", prompt1)):
                    run, _ = _spec_run(llm, mode, prompts, 128)
                    key = f"{mode}_{name}_noise{level:g}"
                    out["runs"][key] = run
                    emit("spec", run=key, draft_noise=level, **run)
                    need = ["paged_attention", "flat_prefill_attention"]
                    need += ["tree_attention"] if mode == "ssd" else []
                    if not all(run["launches"][k] > 0 for k in need):
                        fail(f"spec {key}: a kernel of the path never launched: "
                             f"{run['launches']}")
                    lo, hi = MISS_HIT_RATE
                    if mode == "ssd" and level and not lo <= run["cache_hit_rate"] <= hi:
                        fail(f"spec {key}: the miss path's cache-hit rate "
                             f"{run['cache_hit_rate']} is outside [{lo}, {hi}]")
                blocks = llm.model_runner.num_kvcache_blocks
                out["pool"] = llm.model_runner.pool_sizing
                llm.exit()
                del llm
                torch.cuda.empty_cache()
    emit("spec", geometry="Llama-3.2-1B width, target 16 layers (4 live), draft 4 layers, bf16",
         K=SPEC_K, async_fan_out=SPEC_F, kv_blocks_each_pool=blocks, pool=out["pool"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


def phase_kvq(serve: dict | None, spec: dict | None) -> dict:
    """The int8 KV cache at the full Llama-3.2-1B width (module docstring,
    phase 5): AR b8 on serve's engine and prompts, SD and SSD b8 (noise 0)
    on spec's checkpoint pair, with kv_quant="int8", then AR b8 and SSD b8
    with "int8_mxu". Every kernel launch count is zeroed before and read
    after each run; the int8 kernels of the run's path must launch and the
    fp-cache kernels must not."""
    import torch

    from ssd_tpu_torch import SamplingParams
    from ssd_tpu_torch.config import ModelConfig
    from ssd_tpu_torch.engine.model_runner import kv_block_bytes
    from ssd_tpu_torch.models.transformer import Arch

    prompts8, _ = _serving_prompts()
    warm = SamplingParams(temperature=0.0, max_new_tokens=8, ignore_eos=True)
    out = {"runs": {}, "pools": {}}
    need = {"ar": ("paged_attention_int8", "flat_prefill_attention_int8"),
            "sd": ("paged_attention_int8", "flat_prefill_attention_int8"),
            "ssd": ("paged_attention_int8", "flat_prefill_attention_int8",
                    "tree_attention_int8")}
    with tempfile.TemporaryDirectory() as d:
        tdir, ddir = _spec_pair(d, layers=16, live=SPEC_LIVE, scale=0.02,
                                dtype=torch.bfloat16, seed=0)
        engine = dict(dtype="bfloat16", max_model_len=SPEC_MAX_LEN,
                      kvcache_block_size=BLOCK, max_num_seqs=8)
        for kvq, mode in (("int8", "ar"), ("int8", "sd"), ("int8", "ssd"),
                          ("int8_mxu", "ar"), ("int8_mxu", "ssd")):
            if mode == "ar":
                llm = _serving_llm(kv_quant=kvq)
            else:
                llm = _spec_llm(tdir, ddir, mode, kv_quant=kvq, **engine)
            llm.generate([p[:40] for p in prompts8[:2]], warm, use_tqdm=False)
            run, _ = _spec_run(llm, mode, prompts8, 128)
            key = f"{kvq}_{mode}_b8"
            run["pool"] = llm.model_runner.pool_sizing
            out["runs"][key] = run
            emit("kvq", run=key, kv_quant=kvq, **run)
            missing = [k for k in need[mode] if run["launches"][k] <= 0]
            fp = [k for k in ("paged_attention", "flat_prefill_attention", "tree_attention")
                  if run["launches"][k]]
            if missing or fp:
                fail(f"kvq {key}: int8 kernels that never launched {missing}, "
                     f"fp-cache kernels that did {fp}: {run['launches']}")
            llm.exit()
            del llm
            torch.cuda.empty_cache()
    # Pool capacity, bf16 next to int8: one block's bytes (target + draft
    # for the speculative engines), and how many blocks the free memory
    # would hold before the engine's cap of (max_num_seqs+1)(max_blocks+2)*4.
    arch = Arch.from_model_config(ModelConfig(**LLAMA_1B))
    for dt_name, kvq in (("bfloat16", None), ("int8", "int8")):
        out["pools"][dt_name] = dict(
            block_bytes_per_layer_stack=kv_block_bytes(arch, BLOCK, torch.bfloat16, kvq),
            blocks_per_gib=2**30 / kv_block_bytes(arch, BLOCK, torch.bfloat16, kvq))
    measured = {"ar_bf16": (serve or {}).get("pool"), "spec_bf16": (spec or {}).get("pool"),
                "ar_int8": out["runs"]["int8_ar_b8"]["pool"],
                "spec_int8": out["runs"]["int8_sd_b8"]["pool"]}
    out["pools"]["measured"] = measured
    emit("kvq", geometry="Llama-3.2-1B width: AR 16 layers (serve's engine); SD/SSD target "
         "16 layers (4 live), draft 4 layers; bf16 weights", pools=out["pools"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


def _stream_busy(prof) -> dict:
    """Kernel time per CUDA stream in a profile, the union over streams, and
    the time two streams ran kernels at once (sum minus union), in ms."""
    from torch.autograd import DeviceType

    def merge(xs):
        out = []
        for a, b in sorted(xs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    per = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per.setdefault(str(getattr(e, "device_resource_id", 0)), []).append(
                (e.time_range.start, e.time_range.end))
    busy = {k: sum(b - a for a, b in merge(v)) / 1e3 for k, v in per.items()}
    union = sum(b - a for a, b in merge([x for v in per.values() for x in v])) / 1e3
    return dict(per_stream_ms=busy, union_ms=union, concurrent_ms=sum(busy.values()) - union)


def _profile_window(llm, steps: int = 8) -> dict:
    """`steps` decode steps of a warm engine, timed without and then with
    torch.profiler: wall ms per step, the device time of each CUDA stream,
    their union and the time two streams ran kernels at once, the
    host-device copies, and the target's verify time on the host (these
    four in the profiled window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ssd_tpu_torch.engine.llm_engine import METRICS

    def window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            llm.step()
        if llm.draft_server is not None:
            llm.draft_server.drain()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    wall = window()
    n_verify = len(METRICS["target_verify_times"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_wall = window()
    verify = METRICS["target_verify_times"][n_verify:]
    busy = _stream_busy(prof)
    copies = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and e.name.startswith("Memcpy")]
    return dict(steps=steps, wall_ms_per_step=wall, profiled_wall_ms_per_step=prof_wall,
                device_union_ms_per_step=busy["union_ms"] / steps,
                device_busy_share=busy["union_ms"] / steps / wall,
                per_stream_ms_per_step={k: v / steps for k, v in busy["per_stream_ms"].items()},
                concurrent_ms_per_step=busy["concurrent_ms"] / steps,
                memcpy_per_step=len(copies) / steps,
                memcpy_ms_per_step=sum(e.time_range.end - e.time_range.start
                                       for e in copies) / 1e3 / steps,
                verify_host_ms=1e3 * sum(verify) / len(verify) if verify else None)


def phase_spec_profile() -> dict:
    """Not run by default: SD and SSD decode steps at b=8 (noise 0), timed
    without and then with torch.profiler."""
    import torch

    from ssd_tpu_torch import SamplingParams

    prompts8, _ = _serving_prompts()
    sp = SamplingParams(temperature=0.0, max_new_tokens=128, ignore_eos=True)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        tdir, ddir = _spec_pair(d, layers=16, live=SPEC_LIVE, scale=0.02,
                                dtype=torch.bfloat16, seed=0)
        for mode in ("sd", "ssd"):
            llm = _spec_llm(tdir, ddir, mode, dtype="bfloat16", max_model_len=SPEC_MAX_LEN,
                            kvcache_block_size=BLOCK, max_num_seqs=8)
            for p in prompts8:
                llm.add_request(p, sp)
            for _ in range(4):   # the prefill, then warm decode steps
                llm.step()
            out[mode] = _profile_window(llm)
            llm.exit()
            del llm
            torch.cuda.empty_cache()
    emit("spec_profile", geometry="Llama-3.2-1B width, target 16 layers (4 live), "
         "draft 4 layers, bf16, b8, noise 0", **out)
    return out


def phase_eagle_profile() -> dict:
    """Not run by default: EAGLE-3 async SSD decode steps at b=8 on the eagle
    phase's Llama-3.1-8B engine (full depth, random bf16 weights), timed
    without and then with torch.profiler."""
    import torch

    from ssd_tpu_torch import SamplingParams

    p8, _ = _serving_prompts(LLAMA_8B["vocab_size"])
    sp = SamplingParams(temperature=0.0, max_new_tokens=128, ignore_eos=True)
    with tempfile.TemporaryDirectory() as d:
        tdir, edir = os.path.join(d, "t"), os.path.join(d, "e")
        os.makedirs(tdir)
        os.makedirs(edir)
        _write_config(tdir, LLAMA_8B)
        _eagle_config(edir)
        llm = _eagle_llm(tdir, edir, init_random=True, dtype="bfloat16",
                         max_model_len=EAGLE_MAX_LEN, kvcache_block_size=BLOCK, max_num_seqs=8)
        for p in _eagle_prompts(p8, 128):
            llm.add_request(p, sp)
        for _ in range(4):   # the prefill, then warm decode steps
            llm.step()
        out = {"eagle": _profile_window(llm)}
        llm.exit()
        del llm
        torch.cuda.empty_cache()
    emit("eagle_profile", geometry=EAGLE_GEOMETRY + ", b8", **out)
    return out


# ---------------------------------------------------------------------------
# Phase 6
# ---------------------------------------------------------------------------


def _moe_llm():
    """The full-depth Qwen3-30B-A3B engine with random bf16 weights, built
    after checking that the card's free memory holds its weights and its
    capped KV pool (less points to an earlier engine still alive), and
    checked to hold the capped pool. Returns (llm, facts of its sizing)."""
    import torch

    from ssd_tpu_torch import LLM
    from ssd_tpu_torch.config import ModelConfig
    from ssd_tpu_torch.engine.model_runner import kv_block_bytes
    from ssd_tpu_torch.models.transformer import Arch, param_bytes

    arch = Arch.from_model_config(ModelConfig(**QWEN3_30B_A3B))
    max_len, seqs = 2048, 8
    cap = (seqs + 1) * (max_len // BLOCK + 2) * 4          # the engine's pool cap
    weights = param_bytes(arch, torch.bfloat16)
    need = weights + cap * kv_block_bytes(arch, BLOCK, torch.bfloat16)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    if free < need:
        fail(f"moe: {free / 1e9:.2f} GB free at the start, but the weights and the "
             f"capped KV pool need {need / 1e9:.2f} GB: is an earlier phase's engine alive?")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        _write_config(d, QWEN3_30B_A3B)
        llm = LLM(d, init_random=True, dtype="bfloat16", gpu_memory_utilization=MOE_UTIL,
                  max_model_len=max_len, kvcache_block_size=BLOCK, max_num_seqs=seqs)
    torch.cuda.synchronize()
    facts = dict(init_s=time.perf_counter() - t0, weights_gb=weights / 1e9,
                 free_at_start_gb=free / 1e9, total_gb=total / 1e9,
                 gpu_memory_utilization=MOE_UTIL, kv_blocks=llm.model_runner.num_kvcache_blocks,
                 cap_blocks=cap, pool=llm.model_runner.pool_sizing)
    if facts["kv_blocks"] < cap:
        fail(f"moe: the KV pool holds {facts['kv_blocks']} blocks, fewer than the cap's "
             f"{cap}: {facts['pool']}")
    return llm, facts


def phase_moe() -> dict:
    """Qwen3-30B-A3B at full width and depth through LLM(...).generate
    (module docstring, phase 6)."""
    import torch

    from ssd_tpu_torch import SamplingParams

    V = QWEN3_30B_A3B["vocab_size"]
    llm, facts = _moe_llm()
    prompts8, prompt1 = _serving_prompts(V)
    llm.generate([p[:40] for p in prompts8[:2]],
                 SamplingParams(temperature=0.0, max_new_tokens=4, ignore_eos=True),
                 use_tqdm=False)  # warm-up: cuBLAS handles, allocator

    wrappers = _kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    sp = SamplingParams(temperature=0.0, max_new_tokens=128, ignore_eos=True)
    runs = {}
    for name, prompts in (("b8", prompts8), ("b1", prompt1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs, m = llm.generate(prompts, sp, use_tqdm=False)
        wall = time.perf_counter() - t0
        for o in outs:
            ids = o["token_ids"]
            if len(ids) != 128 or not all(0 <= t < V for t in ids):
                fail(f"moe {name}: bad output of {len(ids)} tokens")
        runs[name] = dict(
            prompts=len(prompts), prompt_tokens=sum(map(len, prompts)),
            new_tokens=128 * len(prompts), wall_s=wall,
            ttft_s=m["target_step_times"][0],
            prefill_tok_s=m["prefill_total_tokens"] / m["prefill_total_time"],
            decode_tok_s=m["decode_total_tokens"] / m["decode_total_time"],
            decode_step_ms=1e3 * m["decode_total_time"] / max(1, len(m["target_step_times"]) - 1),
        )
    launches = {w.__name__: w.launches for w in wrappers}
    emit("moe", geometry=MOE_GEOMETRY, **facts, runs=runs, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    need_k = ("paged_attention", "flat_prefill_attention", "grouped_gemm")
    if not all(launches[k] > 0 for k in need_k):
        fail(f"moe: a kernel of the path never launched: {launches}")
    llm.exit()
    del llm
    torch.cuda.empty_cache()
    return {"launches": launches, "runs": runs, **facts}


# ---------------------------------------------------------------------------
# Phase 7: EAGLE-3 async SSD at the Llama-3.1-8B geometry
# ---------------------------------------------------------------------------


def _eagle_config(d: str, **over):
    """An EAGLE-3 head's config.json (EAGLE3_8B, with `over`)."""
    _write_config(d, EAGLE3_8B, **over)


def _eagle_pair(d: str, layers: int, dtype, seed: int = 11, base: dict = LLAMA_8B):
    """bench.py::build_eagle_checkpoints at the width of `base`, in torch:
    a target whose layers are residual pass-throughs (o_proj = down = 0), so
    its last hidden state is the token's embedding, with unit-rms embeddings
    on the first Hkv*hd coordinates and an untied head that is the table
    rolled by one row (greedy walks t -> t-1); and a one-layer EAGLE head
    whose attention cancels the conditioning stream and replaces it with the
    token's normed embedding, so its logits equal the target's at every
    depth (noise 0 accepts ~K+1). Weights drawn on the card from a generator
    seeded with `seed`, stored in `dtype`. Returns (target dir, draft dir)."""
    import torch

    from ssd_tpu_torch.utils.loader import save_safetensors

    c = base
    D, I, V = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    Hq, Hkv, hd = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    G, S, beta = Hq // Hkv, Hkv * hd, 8.0
    g = torch.Generator(device="cuda").manual_seed(seed)

    def cpu(x):
        return x.to(dtype).cpu()

    def w(*shape):
        return cpu(torch.randn(*shape, generator=g, device="cuda") * 0.02)

    def ones(n):
        return torch.ones(n, dtype=dtype)

    e = torch.randn(V, S, generator=g, device="cuda")
    e *= D ** 0.5 / e.norm(dim=1, keepdim=True)
    emb = torch.zeros(V, D, device="cuda")
    emb[:, :S] = e
    head = torch.roll(emb, -1, dims=0)
    emb, head = cpu(emb), cpu(head)
    target = {"model.embed_tokens.weight": emb, "lm_head.weight": head,
              "model.norm.weight": ones(D)}
    for i in range(layers):
        p = f"model.layers.{i}."
        target.update({
            p + "input_layernorm.weight": ones(D),
            p + "post_attention_layernorm.weight": ones(D),
            p + "self_attn.q_proj.weight": w(Hq * hd, D),
            p + "self_attn.k_proj.weight": w(Hkv * hd, D),
            p + "self_attn.v_proj.weight": w(Hkv * hd, D),
            p + "self_attn.o_proj.weight": torch.zeros(D, Hq * hd, dtype=dtype),
            p + "mlp.gate_proj.weight": w(I, D),
            p + "mlp.up_proj.weight": w(I, D),
            p + "mlp.down_proj.weight": torch.zeros(D, I, dtype=dtype),
        })
    # The head's layer, HF [out, in]; its attention input is [norm(tok) | norm(cond)].
    r = torch.arange(Hq * hd)
    qw = torch.zeros(Hq * hd, 2 * D)
    qw[r, (r // hd // G) * hd + r % hd] = beta
    s = torch.arange(S)
    kw = torch.zeros(S, 2 * D)
    kw[s, s] = beta
    vw = torch.zeros(S, 2 * D)
    vw[s, s] = 1.0            # + the token's coordinates
    vw[s, D + s] = -1.0       # - the conditioning's (cancels the residual)
    ow = torch.zeros(D, Hq * hd)
    ow[s, (s // hd) * G * hd + s % hd] = 1.0   # one q head per group rebuilds v
    fc = torch.zeros(D, 3 * D)
    fc[torch.arange(D), torch.arange(D)] = 1.0  # the first tap
    draft = {
        "fc.weight": fc.to(dtype), "midlayer.self_attn.q_proj.weight": qw.to(dtype),
        "midlayer.self_attn.k_proj.weight": kw.to(dtype),
        "midlayer.self_attn.v_proj.weight": vw.to(dtype),
        "midlayer.self_attn.o_proj.weight": ow.to(dtype),
        "midlayer.mlp.gate_proj.weight": w(I, D), "midlayer.mlp.up_proj.weight": w(I, D),
        "midlayer.mlp.down_proj.weight": torch.zeros(D, I, dtype=dtype),
        "midlayer.input_layernorm.weight": ones(D), "midlayer.hidden_norm.weight": ones(D),
        "midlayer.post_attention_layernorm.weight": ones(D), "norm.weight": ones(D),
        "lm_head.weight": head, "embed_tokens.weight": emb,
    }
    dirs = []
    for name, tensors in (("target", target), ("draft", draft)):
        sub = os.path.join(d, name)
        os.makedirs(sub)
        save_safetensors(os.path.join(sub, "model.safetensors"), tensors)
        dirs.append(sub)
    _write_config(dirs[0], base, num_hidden_layers=layers, tie_word_embeddings=False)
    _eagle_config(dirs[1], draft_vocab_size=V, hidden_size=D, intermediate_size=I,
                  num_attention_heads=Hq, num_key_value_heads=Hkv, head_dim=hd)
    return tuple(dirs)


EAGLE_NOISE = ("fc", "wq", "wk", "wv", "wo")


def _perturb_eagle(llm, noise: float, originals: dict):
    """bench.py::build_eagle_checkpoints' draft_noise on the loaded head:
    each of fc, q, k, v, o becomes its constructed value plus noise times
    the rms of its nonzero entries times N(0, 1), drawn on the host from a
    generator seeded 2000 + index (so the card's and the CPU's heads are the
    same). `originals` keeps the constructed values across calls."""
    import torch

    params = llm.draft_server.runner.params
    for i, k in enumerate(EAGLE_NOISE):
        base = originals.setdefault(k, params[k].clone())
        nz = base.float()[base != 0]
        rms = float(nz.pow(2).mean().sqrt()) if nz.numel() else 1.0
        z = torch.randn(base.shape, generator=torch.Generator().manual_seed(2000 + i))
        params[k].copy_(base + (noise * rms * z).to(base.device, base.dtype))
    torch.cuda.synchronize()


def _eagle_llm(tdir, ddir, init_random=False, **kw):
    from ssd_tpu_torch import LLM

    return LLM(tdir, draft=ddir, speculate=True, draft_async=True, use_eagle=True,
               jit_speculate=True, speculate_k=SPEC_K, async_fan_out=SPEC_F,
               init_random=init_random, **kw)


def _eagle_room(n_new: int = 128) -> int:
    """The longest prompt the eagle phase serves: prompt + n_new + the tree
    lookahead (K+1 + K*MQ) fit the head's EAGLE_MAX_LEN positions."""
    return EAGLE_MAX_LEN - n_new - (SPEC_K + 1 + SPEC_K * SPEC_MQ)


def _eagle_lens() -> list[int]:
    """serve's b8 prompt lengths as the eagle phase serves them (only the
    1900-token prompt is cut, to _eagle_room())."""
    return [min(n, _eagle_room()) for n in SERVE_LENS8]


def _eagle_prompts(prompts: list[list[int]], n_new: int) -> list[list[int]]:
    return [p[:_eagle_room(n_new)] for p in prompts]


def phase_eagle() -> dict:
    """EAGLE-3 async SSD at the Llama-3.1-8B geometry (module docstring,
    phase 7)."""
    import torch

    from ssd_tpu_torch import SamplingParams

    V = LLAMA_8B["vocab_size"]
    p8, p1 = _serving_prompts(V)
    prompts = {"b8": _eagle_prompts(p8, 128), "b1": _eagle_prompts(p1, 128)}
    warm = SamplingParams(temperature=0.0, max_new_tokens=8, ignore_eos=True)
    engine = dict(dtype="bfloat16", max_model_len=EAGLE_MAX_LEN, kvcache_block_size=BLOCK,
                  max_num_seqs=8)
    out = {"runs": {}}
    need = {"ar": ("paged_attention", "flat_prefill_attention"),
            "eagle": ("paged_attention", "flat_prefill_attention", "tree_attention"),
            "eagle_int8": ("paged_attention_int8", "flat_prefill_attention_int8",
                           "tree_attention_int8")}

    def measured(llm, key, path, mode, ps, n_new=128):
        t0 = time.perf_counter()
        run, _ = _spec_run(llm, mode, ps, n_new, V=V)
        run["wall_incl_checks_s"] = time.perf_counter() - t0
        out["runs"][key] = run
        emit("eagle", run=key, **run)
        missing = [k for k in need[path] if run["launches"][k] <= 0]
        if missing:
            fail(f"eagle {key}: kernels of the path never launched {missing}: {run['launches']}")
        if path != "ar":
            # Each prefill step launches K1 once per target layer and once
            # for the head's conditioned prefill.
            per_step = llm.model_runner.arch.num_layers + 1
            if run["launches"][need[path][1]] % per_step:
                fail(f"eagle {key}: {run['launches'][need[path][1]]} prefill launches are "
                     f"not whole steps of {per_step} (target layers + the head)")
        return run

    with tempfile.TemporaryDirectory() as d:
        tdir, edir = os.path.join(d, "t"), os.path.join(d, "e")
        os.makedirs(tdir)
        os.makedirs(edir)
        _write_config(tdir, LLAMA_8B)
        _eagle_config(edir)
        # Full depth, random bf16 weights: AR, then EAGLE SSD over the fp and
        # the int8 cache (the same seeded target each time).
        for path, kvq in (("ar", None), ("eagle", None), ("eagle_int8", "int8")):
            t0 = time.perf_counter()
            if path == "ar":
                from ssd_tpu_torch import LLM

                llm = LLM(tdir, init_random=True, **engine)
            else:
                llm = _eagle_llm(tdir, edir, init_random=True, kv_quant=kvq, **engine)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            llm.generate([p[:40] for p in prompts["b8"][:2]], warm, use_tqdm=False)
            for name in (("b8", "b1") if path != "eagle_int8" else ("b8",)):
                run = measured(llm, f"{path}_{name}", path,
                               "ar" if path == "ar" else "ssd", prompts[name])
                run["init_s"] = init_s
            out.setdefault("pools", {})[path] = llm.model_runner.pool_sizing
            out.setdefault("kv_blocks", {})[path] = llm.model_runner.num_kvcache_blocks
            llm.exit()
            del llm
            torch.cuda.empty_cache()

    # The constructed pair (target cut to EAGLE_PAIR_LAYERS layers): noise 0
    # must accept near K+1 and hit the tree cache; one level of a fixed
    # ladder must land the hit rate in MISS_HIT_RATE.
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        tdir, edir = _eagle_pair(d, EAGLE_PAIR_LAYERS, torch.bfloat16)
        out["pair_checkpoints_s"] = time.perf_counter() - t0
        llm = _eagle_llm(tdir, edir, **engine)
        llm.generate([p[:40] for p in prompts["b8"][:2]], warm, use_tqdm=False)
        run = measured(llm, "pair_noise0_b8", "eagle", "ssd", prompts["b8"])
        if run["mean_accepted_suffix_len"] < SPEC_K or run["cache_hit_rate"] <= 0.9:
            fail(f"eagle: the constructed pair at noise 0 accepted "
                 f"{run['mean_accepted_suffix_len']} (K+1 = {SPEC_K + 1}) with hit rate "
                 f"{run['cache_hit_rate']}")
        originals, found = {}, None
        lo, hi = MISS_HIT_RATE
        for level in EAGLE_NOISE_LADDER:
            _perturb_eagle(llm, level, originals)
            run = measured(llm, f"pair_noise{level:g}_b8", "eagle", "ssd", prompts["b8"], 64)
            run["draft_noise"] = level
            if lo <= run["cache_hit_rate"] <= hi:
                found = level
                break
        if found is None:
            fail(f"eagle: no draft noise of {EAGLE_NOISE_LADDER} put the hit rate in "
                 f"[{lo}, {hi}]")
        out["miss_noise"] = found
        llm.exit()
        del llm
        torch.cuda.empty_cache()
    emit("eagle", geometry=EAGLE_GEOMETRY, K=SPEC_K, async_fan_out=SPEC_F,
         max_model_len=EAGLE_MAX_LEN, pair_layers=EAGLE_PAIR_LAYERS, miss_noise=found,
         pools=out["pools"], kv_blocks=out["kv_blocks"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return out


# ---------------------------------------------------------------------------
# Phase 8
# ---------------------------------------------------------------------------


def _random_checkpoint(d: str, layers: int, scale: float, seed: int):
    import torch

    from ssd_tpu_torch.utils.loader import save_safetensors

    c = LLAMA_1B
    D, I, hd = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    Hq, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=g) * scale

    t = {"model.embed_tokens.weight": w(c["vocab_size"], D),
         "model.norm.weight": torch.ones(D)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": torch.ones(D),
            p + "post_attention_layernorm.weight": torch.ones(D),
            p + "self_attn.q_proj.weight": w(Hq * hd, D),
            p + "self_attn.k_proj.weight": w(Hkv * hd, D),
            p + "self_attn.v_proj.weight": w(Hkv * hd, D),
            p + "self_attn.o_proj.weight": w(D, Hq * hd),
            p + "mlp.gate_proj.weight": w(I, D),
            p + "mlp.up_proj.weight": w(I, D),
            p + "mlp.down_proj.weight": w(D, I),
        })
    save_safetensors(os.path.join(d, "model.safetensors"), t)
    _write_config(d, num_hidden_layers=layers)


def _moe_checkpoint(d: str, layers: int, scale: float, seed: int):
    """A Qwen3-30B-A3B-width checkpoint of `layers` layers: weights
    N(0, 1) * scale drawn on the card from a generator seeded with `seed`,
    stored in bf16 (half the file; the engines load them as fp32), norms at
    one, an untied head."""
    import torch

    from ssd_tpu_torch.utils.loader import save_safetensors

    c = QWEN3_30B_A3B
    D, Im, E = c["hidden_size"], c["moe_intermediate_size"], c["num_experts"]
    Hq, Hkv, hd = QWEN_HEADS
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16).cpu()

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16)

    t = {"model.embed_tokens.weight": w(c["vocab_size"], D), "model.norm.weight": ones(D),
         "lm_head.weight": w(c["vocab_size"], D)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": ones(D),
            p + "post_attention_layernorm.weight": ones(D),
            p + "self_attn.q_proj.weight": w(Hq * hd, D),
            p + "self_attn.k_proj.weight": w(Hkv * hd, D),
            p + "self_attn.v_proj.weight": w(Hkv * hd, D),
            p + "self_attn.o_proj.weight": w(D, Hq * hd),
            p + "self_attn.q_norm.weight": ones(hd),
            p + "self_attn.k_norm.weight": ones(hd),
            p + "mlp.gate.weight": w(E, D),
        })
        for e in range(E):
            q = f"{p}mlp.experts.{e}."
            t.update({q + "gate_proj.weight": w(Im, D), q + "up_proj.weight": w(Im, D),
                      q + "down_proj.weight": w(D, Im)})
    save_safetensors(os.path.join(d, "model.safetensors"), t)
    _write_config(d, c, num_hidden_layers=layers)


def _record_router_margins(margins: list):
    """Until the returned undo is called, append to `margins` the smallest
    gap between the k-th and (k+1)-th router logit of every MoE layer call
    (how close the expert choice came to a tie)."""
    import torch

    from ssd_tpu_torch.ops import moe

    orig = moe.route

    def recording(x, router, top_k, norm_topk_prob):
        top = torch.sort((x @ router).float(), dim=-1, descending=True).values
        margins.append(float((top[:, top_k - 1] - top[:, top_k]).min()))
        return orig(x, router, top_k, norm_topk_prob)

    moe.route = recording
    return lambda: setattr(moe, "route", orig)


def _record_margins(llm, margins: list):
    """Append the smallest top-1/top-2 logit gap of every AR step's batch to
    `margins` (how close greedy decoding came to a tie)."""
    run = llm.model_runner.run

    def recording_run(seqs, is_prefill):
        toks, logits = run(seqs, is_prefill, return_logits=True)
        top2 = logits.float().topk(2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        return toks

    llm.model_runner.run = recording_run


def phase_exact() -> dict:
    import numpy as np
    import torch

    from ssd_tpu_torch import LLM, SamplingParams

    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, LLAMA_1B["vocab_size"], size=n).tolist()
               for n in (20, 77, 130)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=16, ignore_eos=True)
    tokens, margins = {}, []
    with tempfile.TemporaryDirectory() as d:
        _random_checkpoint(d, layers=2, scale=0.4, seed=3)
        for dev in ("cuda", "cpu"):
            llm = LLM(d, device=dev, dtype="float32", max_model_len=512,
                      kvcache_block_size=BLOCK, max_num_seqs=4,
                      num_kvcache_blocks=32)
            _record_margins(llm, margins)
            outs, _ = llm.generate(prompts, sp, use_tqdm=False)
            tokens[dev] = [o["token_ids"] for o in outs]
            del llm
    equal = tokens["cuda"] == tokens["cpu"]
    emit("exact", geometry="Llama-3.2-1B width, 2 layers, fp32, init scale 0.4",
         prompts=[len(p) for p in prompts], new_tokens=16, equal=equal,
         min_top2_margin=min(margins),
         first_diff=None if equal else [
             (i, a, b) for i, (a, b) in enumerate(zip(tokens["cuda"], tokens["cpu"])) if a != b][:1])
    if not equal:
        fail("exact: greedy tokens on the card differ from the CPU's")

    # Speculative modes: target 8 layers (2 live), a 2-layer draft with
    # noise, so steps both accept and reject; every mode on both devices
    # must give the card's AR tokens, over the fp32 cache and over the int8
    # cache (whose AR is the reference of its own modes; its AR
    # runs record their top-1/top-2 margins). Then two card runs of
    # int8_mxu AR must agree.
    spec_tokens, accepted, int8_margins = {}, {}, []
    engine = dict(dtype="float32", max_model_len=512, kvcache_block_size=BLOCK,
                  max_num_seqs=4, num_kvcache_blocks=32)
    with tempfile.TemporaryDirectory() as d:
        tdir, ddir = _spec_pair(d, layers=8, live=2, scale=0.4, dtype=torch.float32, seed=3)
        for kvq in (None, "int8"):
            for dev in ("cuda", "cpu"):
                for mode in ("ar", "sd", "ssd"):
                    if mode == "ar":
                        llm = LLM(tdir, device=dev, kv_quant=kvq, **engine)
                        if kvq:
                            _record_margins(llm, int8_margins)
                    else:
                        llm = _spec_llm(tdir, ddir, mode, device=dev, kv_quant=kvq, **engine)
                        _perturb_draft(llm, 0.01, 0.4)
                    outs, m = llm.generate(prompts, sp, use_tqdm=False)
                    llm.exit()
                    spec_tokens[(kvq or "fp32", dev, mode)] = [o["token_ids"] for o in outs]
                    lens = m["accepted_suffix_lens_with_recovery"]
                    accepted[f"{kvq or 'fp32'}_{dev}_{mode}"] = sum(lens) / len(lens) if lens else None
                    del llm
        mxu = []
        for _ in range(2):
            llm = LLM(tdir, device="cuda", kv_quant="int8_mxu", **engine)
            mxu.append([o["token_ids"] for o in llm.generate(prompts, sp, use_tqdm=False)[0]])
            del llm
    spec_equal = {f"{kvq}_{dev}_{mode}": toks == spec_tokens[(kvq, "cuda", "ar")]
                  for (kvq, dev, mode), toks in spec_tokens.items()}
    int8_vs_fp32 = sum(a == b for x, y in zip(spec_tokens[("int8", "cuda", "ar")],
                                              spec_tokens[("fp32", "cuda", "ar")])
                       for a, b in zip(x, y))
    emit("exact", geometry="Llama-3.2-1B width, target 8 layers (2 live), draft 2 layers "
         "(noise 0.01), fp32, init scale 0.4", K=SPEC_K, async_fan_out=SPEC_F,
         equal_to_card_ar_of_same_cache=spec_equal, mean_accepted_suffix_len=accepted,
         int8_min_top2_margin=min(int8_margins),
         int8_ar_tokens_equal_to_fp32_ar=int8_vs_fp32, tokens_per_run=16 * len(prompts),
         int8_mxu_two_card_runs_equal=mxu[0] == mxu[1])
    if not all(spec_equal.values()):
        fail(f"exact: greedy tokens differ from the card's AR of the same cache: {spec_equal}")
    if mxu[0] != mxu[1]:
        fail("exact: two card runs of int8_mxu gave different tokens")

    # Qwen3-MoE at the Qwen3-30B-A3B width, 2 layers, fp32: AR on the card
    # equals the CPU's; sync SD and async SSD on the card (self-draft) equal
    # the card's AR; the grouped GEMM launches in each card run.
    mprompts = [rng.integers(3, QWEN3_30B_A3B["vocab_size"], size=n).tolist()
                for n in (20, 77, 130)]
    moe_tokens, moe_margins, router_margins, moe_launches, moe_accepted = {}, [], [], {}, {}
    wrappers = _kernel_wrappers()
    with tempfile.TemporaryDirectory() as d:
        _moe_checkpoint(d, layers=2, scale=0.4, seed=5)
        undo = _record_router_margins(router_margins)
        try:
            for dev, mode in (("cuda", "ar"), ("cpu", "ar"), ("cuda", "sd"), ("cuda", "ssd")):
                if mode == "ar":
                    llm = LLM(d, device=dev, **engine)
                    _record_margins(llm, moe_margins)
                else:
                    llm = _spec_llm(d, d, mode, device=dev, **engine)
                for w in wrappers:
                    w.launches = 0
                outs, m = llm.generate(mprompts, sp, use_tqdm=False)
                if mode == "ssd":
                    llm.draft_server.drain()
                moe_launches[f"{dev}_{mode}"] = {w.__name__: w.launches for w in wrappers}
                llm.exit()
                moe_tokens[(dev, mode)] = [o["token_ids"] for o in outs]
                lens = m["accepted_suffix_lens_with_recovery"]
                moe_accepted[f"{dev}_{mode}"] = sum(lens) / len(lens) if lens else None
                del llm
        finally:
            undo()
    moe_equal = {f"{dev}_{mode}": toks == moe_tokens[("cuda", "ar")]
                 for (dev, mode), toks in moe_tokens.items()}
    emit("exact", geometry="Qwen3-30B-A3B width (128 experts, top-8, hd 128), 2 layers, "
         "fp32, init scale 0.4; SD/SSD self-draft", K=SPEC_K, async_fan_out=SPEC_F,
         equal_to_card_ar=moe_equal, mean_accepted_suffix_len=moe_accepted,
         min_top2_margin=min(moe_margins), min_router_kth_margin=min(router_margins),
         grouped_gemm_launches={k: v["grouped_gemm"] for k, v in moe_launches.items()},
         launches=moe_launches)
    if not all(moe_equal.values()):
        fail(f"exact: Qwen3-MoE greedy tokens differ from the card's AR: {moe_equal}")
    if not all(v["grouped_gemm"] > 0 for k, v in moe_launches.items() if k.startswith("cuda")):
        fail(f"exact: the grouped GEMM did not launch in a card run: {moe_launches}")

    # EAGLE-3 at the width of the checks above (Llama-3.2-1B), 2 layers,
    # fp32: the constructed pair (stored bf16, loaded fp32) with draft noise
    # EXACT_EAGLE_NOISE, so steps both accept and reject. AR on the card equals the CPU's, and
    # EAGLE SSD on both devices equals the card's AR. (EAGLE over the int8
    # cache is held to the int8 AR by the CPU tests; `eagle` runs it on the
    # card.)
    eprompts = [rng.integers(3, LLAMA_1B["vocab_size"], size=n).tolist() for n in (20, 77, 130)]
    e_tokens, e_accepted, e_hits, e_margins = {}, {}, {}, []
    with tempfile.TemporaryDirectory() as d:
        tdir, edir = _eagle_pair(d, 2, torch.bfloat16, seed=13, base=LLAMA_1B)
        for dev, mode in (("cuda", "ar"), ("cpu", "ar"), ("cuda", "eagle"), ("cpu", "eagle")):
            if mode == "ar":
                llm = LLM(tdir, device=dev, **engine)
                _record_margins(llm, e_margins)
            else:
                # Taps of the 2-layer target (its layers pass the embedding
                # through, so every tap is the embedding).
                llm = _eagle_llm(tdir, edir, device=dev, eagle_layers=[0, 1, 1], **engine)
                _perturb_eagle(llm, EXACT_EAGLE_NOISE, {})
            outs, m = llm.generate(eprompts, sp, use_tqdm=False)
            llm.exit()
            key = f"{dev}_{mode}"
            e_tokens[key] = [o["token_ids"] for o in outs]
            lens = m["accepted_suffix_lens_with_recovery"]
            e_accepted[key] = sum(lens) / len(lens) if lens else None
            e_hits[key] = sum(m["cache_hits"]) / len(m["cache_hits"]) if m["cache_hits"] else None
            del llm
    eagle_equal = {k: toks == e_tokens["cuda_ar"] for k, toks in e_tokens.items()}
    emit("exact", geometry="Llama-3.2-1B width, 2 layers, + the constructed EAGLE-3 head "
         f"(noise {EXACT_EAGLE_NOISE}), fp32", K=SPEC_K, async_fan_out=SPEC_F,
         equal_to_card_ar_of_same_cache=eagle_equal, mean_accepted_suffix_len=e_accepted,
         cache_hit_rate=e_hits, min_top2_margin=min(e_margins))
    if not all(eagle_equal.values()):
        fail(f"exact: EAGLE greedy tokens differ from the card's AR: {eagle_equal}")
    return {"equal": equal, "min_top2_margin": min(margins), "spec_equal": spec_equal,
            "moe_equal": moe_equal, "moe_launches": moe_launches, "eagle_equal": eagle_equal}


# ---------------------------------------------------------------------------


PALLAS = "ssd_tpu/ops/pallas_attention.py"
# name in the kernels line -> (source, the TPU kernel it replaces)
KERNEL_ROWS = {
    "paged_attention": ("ssd_tpu_torch/csrc/paged_attention.cu",
                        f"{PALLAS}:354 (_paged_attn_v2_kernel, B=1); :622 (_paged_attn_v3_kernel, B>1)"),
    "flat_prefill_attention": ("ssd_tpu_torch/csrc/flat_prefill_attention.cu",
                               f"{PALLAS}:1700 (_flat_prefill_kernel)"),
    "tree_attention": ("ssd_tpu_torch/csrc/tree_attention.cu",
                       f"{PALLAS}:1527 (_tree_attn_kernel); :1024 (_tree_attn_v2_kernel, B=1); "
                       ":1221 (_tree_attn_v3_kernel, B>1)"),
    "paged_attention_int8": ("ssd_tpu_torch/csrc/paged_attention_int8.cu",
                             f"{PALLAS}:632 (_paged_attn_v3_kernel_i8, s8=False: kv_quant int8)"),
    "paged_attention_int8[s8]": ("ssd_tpu_torch/csrc/paged_attention_int8.cu",
                                 f"{PALLAS}:632 (_paged_attn_v3_kernel_i8, s8=True: kv_quant int8_mxu)"),
    "flat_prefill_attention_int8": ("ssd_tpu_torch/csrc/flat_prefill_attention.cu",
                                    f"{PALLAS}:1700 (_flat_prefill_kernel) over the int8 pages that "
                                    "ssd_tpu/ops/attention.py:132 (dense_pages) dequantizes"),
    "tree_attention_int8": ("ssd_tpu_torch/csrc/tree_attention_int8.cu",
                            f"{PALLAS}:1231 (_tree_attn_v3_kernel_i8, s8=False: kv_quant int8)"),
    "tree_attention_int8[s8]": ("ssd_tpu_torch/csrc/tree_attention_int8.cu",
                                f"{PALLAS}:1231 (_tree_attn_v3_kernel_i8, s8=True: kv_quant int8_mxu)"),
    "grouped_gemm": ("ssd_tpu_torch/csrc/grouped_gemm.cu",
                     "ssd_tpu/models/transformer.py:268-273 (megablox gmm, called by _moe_mlp :164)"),
    "s8_dot_mma": ("ssd_tpu_torch/csrc/s8_probe.cu",
                   "bench/s8_probe.py:18 (_kernel_s8, pallas_call :36)"),
    "s8_dot_dp4a": ("ssd_tpu_torch/csrc/s8_probe.cu",
                    "bench/s8_probe.py:18 (_kernel_s8, pallas_call :36), on SIMT"),
    "s8_dot_bf16": ("ssd_tpu_torch/csrc/s8_probe.cu",
                    "bench/s8_probe.py:25 (_kernel_bf16, pallas_call :36)"),
    "paged_attention_diag": ("ssd_tpu_torch/csrc/paged_attention.cu (stage variants)",
                             "bench/kernel_diag.py:39 (_diag_kernel, pallas_call :171)"),
    "paged_attention_int8_diag": ("ssd_tpu_torch/csrc/paged_attention_int8.cu (stage variants)",
                                  "bench/kernel_diag.py:39 (_diag_kernel, pallas_call :171) "
                                  "over the int8 cache"),
}


def kernels_line(kern: dict, serve: dict | None, spec: dict | None,
                 kvq: dict | None, moe_run: dict | None, eagle: dict | None,
                 exact: dict | None) -> dict:
    """Launches per path, each read from runs whose counts were zeroed just
    before them: `serve` (AR) and `spec` (SD, SSD) for the fp-cache kernels,
    `kvq` for the int8 ones (its int8_mxu runs for the [s8] entries; the
    int8 prefill counts the runs of both modes), `moe` (Qwen3-30B-A3B AR)
    for K1, K2 and the grouped GEMM, `eagle` (Llama-3.1-8B AR, EAGLE SSD over
    the fp and the int8 cache, the constructed pair's runs), `exact`'s
    2-layer Qwen3-MoE SD and SSD card runs for the grouped GEMM, and the
    probes' bench entry points (path "probe") for rows #11 and #12."""
    by_path = {}

    def add(name, path, n):
        paths = by_path.setdefault(name, {})
        paths[path] = paths.get(path, 0) + n

    if serve:
        for name, n in serve["launches"].items():
            add(name, "ar", n)
    if spec:
        for key, run in spec["runs"].items():
            for name in ("paged_attention", "flat_prefill_attention", "tree_attention"):
                add(name, key.split("_")[0], run["launches"][name])
    if kvq:
        for key, run in kvq["runs"].items():
            mxu, path = key.startswith("int8_mxu"), key.split("_")[-2]
            for name in ("paged_attention_int8", "flat_prefill_attention_int8",
                         "tree_attention_int8"):
                tag = "[s8]" if mxu and name != "flat_prefill_attention_int8" else ""
                add(name + tag, path, run["launches"][name])
    if moe_run:
        for name in ("paged_attention", "flat_prefill_attention", "grouped_gemm"):
            add(name, "moe_ar", moe_run["launches"][name])
    if eagle:
        for key, run in eagle["runs"].items():
            path = ("llama8b_ar" if key.startswith("ar_") else
                    "eagle_int8" if key.startswith("eagle_int8") else
                    "eagle_pair" if key.startswith("pair") else "eagle")
            for name, n in run["launches"].items():
                if n:
                    add(name, path, n)
    for name, n in kern.get("probes", {}).get("launches", {}).items():
        add(name, "probe", n)
    if exact and "moe_launches" in exact:
        for mode in ("sd", "ssd"):
            add("grouped_gemm", f"moe_{mode}_2layer", exact["moe_launches"][f"cuda_{mode}"]["grouped_gemm"])
    out = []
    for name, tm in kern["timings"].items():
        err = max(v["max_abs_err"] for (k, _, _), v in kern["errors"].items() if k == name)
        paths = by_path.get(name)
        source, replaces = KERNEL_ROWS[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths.values()) if paths else None,
            "launches_by_path": paths or {},
            "max_abs_err": err, "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
        }
        # The paged kernels also run the SD/SSD verify and glue at Q = K+1,
        # and are timed at a long context.
        gmm = kern["grouped_gemm"]
        for label, table in (("at_verify_shape", kern["at_verify"]),
                             ("at_long_context", kern["long_context"]),
                             ("at_qwen3_moe_geometry", kern["qwen3_moe"]),
                             ("at_llama31_8b_eagle", kern["llama31_8b_eagle"]),
                             ("at_prefill_down", {"grouped_gemm": gmm["prefill_down"]}),
                             ("at_decode_b8_gate", {"grouped_gemm": gmm["decode_b8_gate"]}),
                             ("at_decode_b8_down", {"grouped_gemm": gmm["decode_b8_down"]})):
            if name in table:
                entry[label] = {k: table[name][k] for k in
                                ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if "library" in tm:
            entry["library"] = tm["library"]
        if "stages_ms" in tm:
            entry["stages_ms"] = tm["stages_ms"]
            entry[f"at_b8_x_{LONG_CTX}"] = {k: tm[f"at_b8_x_{LONG_CTX}"][k] for k in
                                            ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms", "stages_ms")}
        out.append(entry)
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES + EXTRA_PHASES}")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if set(phases) - set(PHASES + EXTRA_PHASES):
        ap.error(f"unknown phases {set(phases) - set(PHASES + EXTRA_PHASES)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        import ssd_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    seconds = {}

    def run(name, fn, *args):
        if name not in phases:
            return None
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    phase_env()   # always: the card's name and power limit
    kern = run("kernels", phase_kernels)
    serve = run("serve", phase_serve)
    spec = run("spec", phase_spec)
    kvq = run("kvq", phase_kvq, serve, spec)
    moe_run = run("moe", phase_moe)
    eagle = run("eagle", phase_eagle)
    exact = run("exact", phase_exact)
    run("profile", phase_profile)
    run("moe_profile", phase_profile, True)
    run("spec_profile", phase_spec_profile)
    run("eagle_profile", phase_eagle_profile)
    if kern is not None:
        print(json.dumps(kernels_line(kern, serve, spec, kvq, moe_run, eagle, exact)),
              flush=True)
    emit("done", seconds=time.perf_counter() - t0, phase_seconds=seconds, phases=phases)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
