"""Numpy-only input cases shared by the port's tests: paged decode batches
and flat prefill windows, and the constructed EAGLE-3 pair. Free of JAX, so
the card tests can use them on a machine without it."""

import importlib.util
import json
import os

import numpy as np


def eagle_pair(root: str, noise: float) -> tuple[str, str]:
    """bench.py::build_eagle_checkpoints on a tiny 4-layer config under root:
    a target of pass-through layers and an EAGLE-3 head whose logits track
    the target's, with `noise` on its projections (0 accepts every token).
    Returns (target dir, head dir); needs the safetensors package."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    d = os.path.join(root, "cfg")
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": 128, "hidden_size": 64,
                   "intermediate_size": 128, "num_hidden_layers": 4,
                   "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
                   "max_position_embeddings": 512, "rms_norm_eps": 1e-5,
                   "rope_theta": 1e4, "tie_word_embeddings": False,
                   "eos_token_id": 2}, f)
    return bench.build_eagle_checkpoints(d, draft_noise=noise)


def paged_case(seed, B, Q, Hq, Hkv, hd, block_size, max_blocks, ctx_lens,
               ghosts=0):
    """q, cache and disjoint shuffled page tables; `ghosts` trailing rows are
    batch padding (context 1, table all -1)."""
    rng = np.random.default_rng(seed)
    S = block_size * (max_blocks * B + 1)
    kv = rng.normal(size=(Hkv, S, 2 * hd)).astype(np.float32)
    q = rng.normal(size=(B, Q, Hq, hd)).astype(np.float32)
    pages = rng.permutation(S // block_size - 1) + 1
    bt = np.full((B, max_blocks), -1, np.int32)
    ctx = np.ones(B, np.int32)
    for b in range(B - ghosts):
        n = min(-(-ctx_lens[b] // block_size), max_blocks)
        bt[b, :n] = pages[b * max_blocks: b * max_blocks + n]
        ctx[b] = ctx_lens[b]
    return q, kv, bt, ctx


def flat_meta(ctx_lens, qeffs, block_size, T_pad):
    """Per-sequence page runs concatenated; each new token's half-open window
    in flat-context columns (the layout of test_pallas_kernels.py)."""
    pages_per = [-(-c // block_size) for c in ctx_lens]
    page_off = np.concatenate([[0], np.cumsum(pages_per)])[:-1]
    lo, hi = [], []
    for s, (c, qe) in enumerate(zip(ctx_lens, qeffs)):
        base = page_off[s] * block_size
        lo += [base] * qe
        hi += [base + c - qe + i + 1 for i in range(qe)]
    pad = T_pad - len(lo)
    return (np.asarray(lo + [0] * pad, np.int32),
            np.asarray(hi + [0] * pad, np.int32), pages_per)


def flat_batch(seed, lens, cached, Hq, Hkv, hd, bs, pad_rows=0):
    """A prefill batch over one shuffled cache: prompt s has lens[s] tokens
    of which cached[s] are in the cache already; its pages form one run of
    the flat page list. Returns q, kv (numpy), the flat pages, lo, hi, the
    tables and the new-token count."""
    q_new = [n - c for n, c in zip(lens, cached)]
    M = max(-(-n // bs) for n in lens)
    _, kv, bt, _ = paged_case(seed, len(lens), 1, Hq, Hkv, hd, bs, M, lens)
    T = sum(q_new)
    lo, hi, pages_per = flat_meta(lens, q_new, bs, T + pad_rows)
    pages = np.concatenate([bt[s, :pages_per[s]] for s in range(len(lens))]).astype(np.int32)
    q = np.random.default_rng(seed + 1).normal(size=(T + pad_rows, Hq, hd)).astype(np.float32)
    return q, kv, pages, lo, hi, bt, T


def tree_case(seed, B, K, fan_out_list, Hq, Hkv, hd, block_size, max_blocks,
              bases, step, ghosts=0):
    """One tree-decode step s of the async draft: sequence b's recovery token
    sits at position bases[b], so its context at step s is
    bases[b] + (K+1) + (s+1)*MQ. Even rows take the hit fan-out list, odd
    rows the miss list (its reverse). `ghosts` trailing rows are warm-up
    ghosts: context (K+1) + (s+1)*MQ - 3 (a negative prefix) and a table of
    -1 entries. Returns q, cache, tables, contexts and fan rows."""
    MQ = sum(fan_out_list)
    ctx_lens = [b + (K + 1) + (step + 1) * MQ for b in bases]
    q, kv, bt, ctx = paged_case(seed, B, MQ, Hq, Hkv, hd, block_size,
                                max_blocks, ctx_lens, ghosts)
    for b in range(B - ghosts, B):
        ctx[b] = (K + 1) + (step + 1) * MQ - 3
    hit = np.repeat(np.arange(K + 1), fan_out_list)
    miss = np.repeat(np.arange(K + 1), fan_out_list[::-1])
    fan = np.stack([hit if b % 2 == 0 else miss for b in range(B)]).astype(np.int32)
    return q, kv, bt, ctx, fan
