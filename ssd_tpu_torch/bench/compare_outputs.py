"""Greedy output-equivalence check across decode modes (and servers).

The port of bench/compare_outputs.py: SSD is exact, so temperature-0 output
must be identical across engines. The oracle is the port's own AR path (same
weights, a fresh LLM per mode: ar, sd, sd-fused with spec_rounds=8, ssd),
with an optional `--server` diff against any OpenAI-compatible endpoint.
The exit code is 0 only when every mode matches.

Usage:
  python -m ssd_tpu_torch.bench.compare_outputs --size 8 --draft 1 --k 6
  python -m ssd_tpu_torch.bench.compare_outputs --model-path /path/to/model \\
      --draft /path/to/draft --prompt-ids 3 17 42 9 55

Without `transformers` (or tokenizer files in the checkpoint) a text
--prompt cannot be encoded: pass --prompt-ids. The engines run on the
card; `main(argv, **engine)` passes `engine` (e.g. device="cpu",
dtype="float32") to every LLM it builds.
"""

from __future__ import annotations

import argparse
import sys

from ssd_tpu_torch.bench.bench_helpers import get_model_paths, resolve_draft_path


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description="Compare greedy outputs across modes")
    p.add_argument("--size", type=str, default="8")
    p.add_argument("--llama", action="store_true", default=True)
    p.add_argument("--qwen", action="store_true")
    p.add_argument("--draft", type=str, default=None)
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--chips", "--gpus", dest="chips", type=int, default=1)
    p.add_argument("--k", type=int, default=6)
    p.add_argument("--f", type=int, default=3)
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--max_model_len", type=int, default=4096)
    p.add_argument("--block_sz", type=int, default=256)
    p.add_argument("--prompt", type=str,
                   default="Explain the Chudnovsky algorithm to compute pi.")
    p.add_argument("--prompt-ids", type=int, nargs="+", default=None,
                   help="raw token ids instead of --prompt (no tokenizer needed)")
    p.add_argument("--server", type=str, default=None,
                   help="also diff against an OpenAI-compatible server")
    p.add_argument("--model-id", type=str, default=None)
    args = p.parse_args(argv)
    if args.qwen:
        args.llama = False
    return args


def mode_kwargs(mode: str, args, draft_path: str) -> dict:
    """The LLM arguments of one mode. The port refuses a draft or a
    speculative knob on an engine that does not speculate, so AR gets
    neither (the JAX CLI passes the draft to every mode, where AR ignores
    it)."""
    kw = dict(num_devices=args.chips, max_num_seqs=1, max_model_len=args.max_model_len,
              kvcache_block_size=args.block_sz)
    spec = dict(draft=draft_path, speculate=True, speculate_k=args.k)
    if mode == "sd":
        kw.update(spec)
    elif mode == "sd-fused":
        kw.update(spec, spec_rounds=8)
    elif mode == "ssd":
        kw.update(spec, draft_async=True, async_fan_out=args.f)
    return kw


def run_mode(model_path, draft_path, prompt, args, mode, engine=None):
    """Greedy (text, token ids) of one mode on a fresh engine."""
    from ssd_tpu_torch import SamplingParams
    from ssd_tpu_torch.llm import LLM

    llm = LLM(model_path, **mode_kwargs(mode, args, draft_path), **(engine or {}))
    try:
        ids = prompt
        if isinstance(prompt, str):
            if llm.tokenizer is None:
                raise ValueError("a text prompt needs the checkpoint's tokenizer and the "
                                 "transformers package; pass --prompt-ids instead")
            ids = llm.tokenizer.apply_chat_template(
                [{"role": "user", "content": prompt}], add_generation_prompt=True
            )
        outs, _ = llm.generate(
            [list(ids)],
            SamplingParams(temperature=0.0, max_new_tokens=args.max_new_tokens),
            use_tqdm=False,
        )
    finally:
        llm.exit()
    return outs[0]["text"], outs[0]["token_ids"]


def server_completion(args, prompt):
    import json
    import urllib.request

    body = json.dumps({
        "model": args.model_id or "default",
        "messages": [{"role": "user", "content": prompt}],
        "temperature": 0.0,
        "max_tokens": args.max_new_tokens,
    }).encode()
    req = urllib.request.Request(
        args.server.rstrip("/") + "/v1/chat/completions",
        data=body, headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req) as resp:
        return json.load(resp)["choices"][0]["message"]["content"]


def first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def main(argv=None, **engine):
    """Run every mode and print the comparisons; returns the exit code.
    `engine` goes to every LLM (e.g. device="cpu", dtype="float32")."""
    args = parse_arguments(argv)
    if args.model_path:
        model_path = args.model_path
        draft_path = resolve_draft_path(args.draft) if args.draft else model_path
    else:
        _, model_path, draft_path = get_model_paths(args)

    prompt = args.prompt_ids if args.prompt_ids is not None else args.prompt
    results = {}
    for mode in ("ar", "sd", "sd-fused", "ssd"):
        text, toks = run_mode(model_path, draft_path, prompt, args, mode, engine)
        results[mode] = toks
        print(f"[{mode}] {len(toks)} tokens: {text[:120]!r}...", flush=True)

    ok = True
    for mode in ("sd", "sd-fused", "ssd"):
        div = first_divergence(results["ar"], results[mode])
        if div is None:
            print(f"ar == {mode}: EXACT MATCH", flush=True)
        else:
            ok = False
            print(f"ar != {mode}: first divergence at token {div} "
                  f"({results['ar'][div:div+4]} vs {results[mode][div:div+4]})",
                  flush=True)

    if args.server:
        srv = server_completion(args, args.prompt)
        print(f"[server] {srv[:120]!r}...", flush=True)
        ar_text, _ = run_mode(model_path, draft_path, args.prompt, args, "ar", engine)
        if srv.strip() == ar_text.strip():
            print("ar == server: EXACT MATCH", flush=True)
        else:
            ok = False
            div = first_divergence(ar_text, srv)
            print(f"ar != server: first divergence at char {div}", flush=True)

    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
