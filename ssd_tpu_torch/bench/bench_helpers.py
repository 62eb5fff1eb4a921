"""Benchmark input and path helpers of the port's CLIs.

The port's own copy of bench/bench_helpers.py: HF-cache snapshot
resolution for the size -> model tables, dataset jsonl tokenization with
chat-template support, random-token fallbacks, and the --all union loader.
It reads ssd_tpu_torch.paths; the same arguments and the same state of
Python's `random` give the same prompts as the JAX package's helper.
Tokenizing a dataset needs `transformers`; without it the loader warns and
returns None, and the caller falls back to random token ids.
"""

from __future__ import annotations

import json
import os
from random import randint

from ssd_tpu_torch.paths import DATASET_PATHS, HF_CACHE_DIR

LLAMA_SIZES = {
    "1": "Llama-3.2-1B-Instruct",
    "3": "Llama-3.2-3B-Instruct",
    "8": "Llama-3.1-8B-Instruct",
    "70": "Llama-3.1-70B-Instruct",
}
QWEN_SIZES = {
    "0.6": "Qwen3-0.6B",
    "1.7": "Qwen3-1.7B",
    "4": "Qwen3-4B",
    "8": "Qwen3-8B",
    "14": "Qwen3-14B",
    "32": "Qwen3-32B",
}
LLAMA_ORG, QWEN_ORG = "meta-llama", "Qwen"


def snapshot_path(base: str) -> str:
    """Resolve a model dir / HF-cache entry to a dir containing config.json."""
    if os.path.isdir(base):
        if os.path.exists(os.path.join(base, "config.json")):
            return base
        snaps = os.path.join(base, "snapshots")
        roots = [snaps] if os.path.isdir(snaps) else [base]
        for root in roots:
            for item in sorted(os.listdir(root)):
                cand = os.path.join(root, item)
                if os.path.isdir(cand) and os.path.exists(os.path.join(cand, "config.json")):
                    return cand
    raise FileNotFoundError(f"no model snapshot (config.json) under {base}")


def resolve_draft_path(draft: str, cache_dir: str = HF_CACHE_DIR) -> str:
    """Resolve a --draft value that is either a model dir or a size key."""
    if os.path.isdir(draft):
        return snapshot_path(draft)
    table = {**LLAMA_SIZES, **QWEN_SIZES}
    if draft in table:
        org = LLAMA_ORG if draft in LLAMA_SIZES else QWEN_ORG
        return snapshot_path(os.path.join(cache_dir, f"models--{org}--{table[draft]}"))
    raise ValueError(f"--draft {draft!r} is neither a directory nor a size in {sorted(table)}")


def get_model_paths(args, cache_dir: str = HF_CACHE_DIR):
    """Resolve (model_name, model_path, draft_path) from --size/--llama/--qwen."""
    if args.llama:
        table, org, default_draft = LLAMA_SIZES, LLAMA_ORG, ("meta-llama", "Llama-3.2-1B-Instruct")
    else:
        table, org, default_draft = QWEN_SIZES, QWEN_ORG, ("Qwen", "Qwen3-0.6B")
    if args.size not in table:
        raise ValueError(f"size {args.size} not in {sorted(table)}")
    model_name = table[args.size]
    model_path = snapshot_path(os.path.join(cache_dir, f"models--{org}--{model_name}"))

    if args.draft is not None:
        draft_path = resolve_draft_path(args.draft, cache_dir)
    else:
        dorg, dname = default_draft
        draft_path = snapshot_path(os.path.join(cache_dir, f"models--{dorg}--{dname}"))
    return model_name, model_path, draft_path


def load_dataset_token_ids(dataset_name, model_path, num_prompts, input_len,
                           use_chat_template=False, offset=0):
    """Tokenize num_prompts texts from a {"text": ...} jsonl dataset; None on
    any failure (caller falls back to random tokens)."""
    path = DATASET_PATHS.get(dataset_name)
    if path is None or not os.path.exists(path):
        print(f"Warning: dataset {dataset_name} not found at {path}", flush=True)
        return None
    try:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_path)
        prompts = []
        skipped = 0
        with open(path) as f:
            for line in f:
                if skipped < offset:
                    skipped += 1
                    continue
                if len(prompts) >= num_prompts:
                    break
                text = json.loads(line)["text"]
                if use_chat_template and hasattr(tokenizer, "apply_chat_template"):
                    toks = tokenizer.apply_chat_template(
                        [{"role": "system", "content": "You are a helpful assistant."},
                         {"role": "user", "content": text}],
                        add_generation_prompt=True,
                    )
                else:
                    toks = tokenizer.encode(text, add_special_tokens=False)
                if not toks:
                    continue  # empty text row
                prompts.append(toks[:input_len])
        return prompts
    except Exception as e:
        print(f"Warning: failed loading {dataset_name}: {e}", flush=True)
        return None


def random_token_prompts(num, input_len, hi=10000):
    return [[randint(10, hi) for _ in range(input_len)] for _ in range(num)]


def generate_benchmark_inputs(args, model_path):
    """Token-id prompts for the selected dataset flags (random fallback)."""
    chosen = [d for d in ("humaneval", "alpaca", "gsm8k", "c4", "ultrafeedback") if getattr(args, d)]
    # EAGLE drafts are trained on chat-formatted data; always wrap.
    chat = args.chat_template or getattr(args, "eagle", False)
    if args.all:
        prompts = []
        for name in ("humaneval", "alpaca", "gsm8k", "ultrafeedback"):
            got = load_dataset_token_ids(
                name, model_path, args.numseqs, args.input_len,
                chat, args.prompt_offset,
            )
            prompts.extend(got if got else random_token_prompts(args.numseqs, args.input_len))
        return prompts
    if args.random or not chosen and not os.path.exists(DATASET_PATHS.get("gsm8k", "")):
        return random_token_prompts(args.numseqs, args.input_len)
    name = chosen[0] if chosen else "gsm8k"
    got = load_dataset_token_ids(
        name, model_path, args.numseqs, args.input_len,
        chat, args.prompt_offset,
    )
    return got if got else random_token_prompts(args.numseqs, args.input_len)
