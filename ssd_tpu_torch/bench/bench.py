"""Benchmark CLI: AR / sync-SD / async-SSD / ngram throughput on the card.

The port of bench/bench.py, with its flag surface: modes, k / f / fan-out
lists, datasets including --all, --sweep reusing one loaded engine,
--warm_passes, --example, and optional wandb logging. --chips (alias
--gpus) is the port's num_devices and --eager its enforce_eager (the
decode-side steps run eagerly instead of replaying CUDA graphs). The JAX
CLI's --ctx-bucket, a context-length compile-bucket policy of XLA
(ssd_tpu/config.py ctx_bucket_policy), has no counterpart here and is
dropped: the port captures one CUDA graph per batch bucket instead.

Usage:
  python -m ssd_tpu_torch.bench.bench --size 70 --gpus 4 --b 1 --output_len 512 --all
  python -m ssd_tpu_torch.bench.bench --size 70 --gpus 4 --spec --draft 1 --k 6
  python -m ssd_tpu_torch.bench.bench --size 70 --gpus 5 --spec --async --draft 1 --k 7 --f 3
  python -m ssd_tpu_torch.bench.bench --model-path DIR --random --b 8 --input_len 128

Without `transformers` the prompts are random token ids (--random, or the
fallback of a dataset flag). The engine runs on the card;
`main(argv, **engine)` passes `engine` (e.g. device="cpu",
dtype="float32") to the LLM.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from random import seed

from ssd_tpu_torch.bench.bench_helpers import (generate_benchmark_inputs, get_model_paths,
                                               resolve_draft_path)


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description="Benchmark ssd_tpu_torch performance")

    # Model configuration
    p.add_argument("--size", type=str, default="70",
                   choices=["0.6", "1.7", "4", "8", "14", "32", "1", "3", "70"])
    p.add_argument("--llama", action="store_true", default=True)
    p.add_argument("--qwen", action="store_true")
    p.add_argument("--draft", type=str, default=None,
                   help="draft size (1, 0.6, ...) or path to draft model dir")
    p.add_argument("--model-path", type=str, default=None,
                   help="explicit target model dir (overrides --size)")

    # Execution configuration
    p.add_argument("--eager", action="store_true",
                   help="run the decode-side steps eagerly (no CUDA graphs)")
    p.add_argument("--chips", "--gpus", dest="chips", type=int, default=1,
                   help="total number of GPUs (the unfused async draft takes the last)")

    # Speculative decoding
    p.add_argument("--spec", action="store_true")
    p.add_argument("--eagle", action="store_true")
    p.add_argument("--ngram", action="store_true",
                   help="model-free prompt-lookup speculation (no draft "
                        "model; use with --k/--rounds, --ngram_n)")
    p.add_argument("--ngram_n", type=int, default=3)
    p.add_argument("--k", type=int, default=6)
    p.add_argument("--rounds", type=int, default=1,
                   help="sync SD only: fuse this many speculation rounds "
                        "into one step (engine/fused_sd.py)")
    p.add_argument("--async", dest="draft_async", action="store_true")
    p.add_argument("--async-fused", dest="async_fused", action="store_true",
                   help="fuse the async exchange into one step (with "
                        "--rounds > 1: the whole R-round loop; "
                        "engine/async_fused.py); implies --async")
    p.add_argument("--ddp", type=int, default=1,
                   help="draft data parallelism (replicas)")
    p.add_argument("--f", type=int, default=3)
    p.add_argument("--fl", type=int, nargs="+", default=None,
                   help="fan-out list (alias of --flh; --flh wins if both)")
    p.add_argument("--flh", type=int, nargs="+", default=None)
    p.add_argument("--flm", type=int, nargs="+", default=None)
    p.add_argument("--backup", type=str, choices=["jit", "fast"], default="jit")

    # Memory / batching
    p.add_argument("--block_sz", type=int, default=256)
    p.add_argument("--b", type=int, default=1)
    p.add_argument("--max_model_len", type=int, default=8192)
    p.add_argument("--chunked_prefill", action="store_true",
                   help="admit prompts longer than the token budget in chunks")
    p.add_argument("--warm-passes", type=int, default=0,
                   help="untimed generate passes before the measured one "
                        "(graph capture and allocator warm-up for short runs)")

    # Generation
    p.add_argument("--input_len", type=int, default=128)
    p.add_argument("--output_len", type=int, default=512)
    p.add_argument("--numseqs", type=int, default=128)
    p.add_argument("--temp", type=float, default=0.0)
    p.add_argument("--dtemp", type=float, default=None)
    p.add_argument("--x", type=float, default=None, help="sampler_x coefficient")

    # Datasets
    p.add_argument("--example", action="store_true",
                   help="use a few real chat prompts and print the generations")
    p.add_argument("--humaneval", action="store_true")
    p.add_argument("--alpaca", action="store_true")
    p.add_argument("--gsm8k", action="store_true")
    p.add_argument("--c4", action="store_true")
    p.add_argument("--ultrafeedback", action="store_true")
    p.add_argument("--random", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--prompt_offset", type=int, default=0)
    p.add_argument("--chat_template", action="store_true")

    # Debug / logging
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="save draft prefill inputs for offline comparison")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--group", type=str, default=None)
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--sweep", type=str, default=None,
                   help="JSON list of override dicts (keys: temp, b, name)")

    args = p.parse_args(argv)
    if args.qwen:
        args.llama = False
    if args.eagle:
        args.spec = True
        if not (args.draft_async or args.rounds > 1):
            p.error("EAGLE runs async (--async) or inside the fused sync superstep "
                    "(--rounds > 1)")
    return args


def create_run_name(args):
    mode = ("spec_async" if args.draft_async else "spec") if args.spec else (
        "ngram" if args.ngram else "ar")
    fam = "llama" if args.llama else "qwen"
    return args.name or (
        f"{fam}{args.size}_{mode}_b{args.b}_k{args.k}_f{args.f}"
        f"_t{args.temp}{'_x' + str(args.x) if args.x else ''}"
    )


def create_llm_kwargs(args, draft_path):
    """The flags as the port's Config fields. The port refuses a draft or
    a speculative knob on an engine that does not use it (the JAX engine
    ignores them), so each goes only to the modes that take it: the draft,
    k, rounds and EAGLE to --spec; the async draft's fan-out, replicas,
    sampler_x and backup to --async; k, rounds and n to --ngram."""
    kw = dict(
        enforce_eager=args.eager,
        num_devices=args.chips,
        verbose=args.verbose,
        kvcache_block_size=args.block_sz,
        max_num_seqs=args.b,
        max_model_len=args.max_model_len,
        chunked_prefill=args.chunked_prefill,
        max_steps=args.max_steps,
    )
    if args.spec:
        draft_async = args.draft_async or args.async_fused
        kw.update(speculate=True, draft=draft_path, speculate_k=args.k,
                  spec_rounds=args.rounds, draft_async=draft_async,
                  async_fused=args.async_fused, use_eagle=args.eagle)
        if draft_async:
            kw.update(draft_dp=args.ddp, async_fan_out=args.f, sampler_x=args.x,
                      jit_speculate=(args.backup == "jit"))
            fl = args.flh if args.flh is not None else args.fl
            if fl is not None:
                kw["fan_out_list"] = fl
            if args.flm is not None:
                kw["fan_out_list_miss"] = args.flm
    elif args.ngram:
        kw.update(ngram_speculate=True, ngram_n=args.ngram_n, speculate_k=args.k,
                  spec_rounds=args.rounds)
    if args.debug:
        kw["debug_mode"] = True
    return kw


def log_wandb(args, run_name, metrics, total_tokens, total_time, tput):
    if not args.wandb:
        return
    try:
        import wandb
    except ImportError:
        print("Warning: wandb not installed, skipping logging", flush=True)
        return
    wandb.init(project="ssd_tpu_torch", name=run_name, group=args.group,
               config={k: v for k, v in vars(args).items()})
    out = {
        "official_total_tokens": total_tokens,
        "official_total_time": total_time,
        "official_end_to_end_throughput": tput,
    }
    if metrics.get("decode_total_time", 0) > 0:
        out["metrics_decode_throughput"] = (
            metrics["decode_total_tokens"] / metrics["decode_total_time"]
        )
    if metrics.get("cache_hits"):
        out["metrics_avg_cache_hits"] = sum(metrics["cache_hits"]) / len(metrics["cache_hits"])
    lens = metrics.get("accepted_suffix_lens_with_recovery")
    if lens:
        out["metrics_avg_tokens_per_step"] = sum(lens) / len(lens)
    wandb.log(out)
    wandb.finish()


def example_prompts(args, model_path):
    """A few real chat prompts through the checkpoint's tokenizer, else
    (no transformers or no tokenizer files) random ids."""
    texts = [
        "Explain the Chudnovsky algorithm to compute pi.",
        "Write a haiku about paged attention.",
        "List three ways to overlap communication with compute on GPUs.",
    ][: min(args.numseqs, 8)]
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(model_path)
        return [tok.apply_chat_template([{"role": "user", "content": t}],
                                        add_generation_prompt=True) for t in texts]
    except (ImportError, OSError, ValueError):
        print("Warning: no tokenizer; --example falling back to random ids", flush=True)
        return generate_benchmark_inputs(args, model_path)[: len(texts)]


def main(argv=None, **engine):
    """One engine, one measured generate per sweep entry. `engine` goes to
    the LLM (e.g. device="cpu", dtype="float32")."""
    args = parse_arguments(argv)
    seed(0)

    from ssd_tpu_torch import SamplingParams
    from ssd_tpu_torch.llm import LLM

    if args.model_path:
        model_name, model_path = args.model_path, args.model_path
        draft_path = resolve_draft_path(args.draft) if args.draft else model_path
    else:
        model_name, model_path, draft_path = get_model_paths(args)

    prompts = (example_prompts(args, model_path) if args.example
               else generate_benchmark_inputs(args, model_path))
    num_reqs = len(prompts)

    llm = LLM(model_path, **create_llm_kwargs(args, draft_path), **engine)
    try:
        sweep_configs = json.loads(args.sweep) if args.sweep else [{}]
        if not isinstance(sweep_configs, list):
            raise ValueError("--sweep takes a JSON list of override dicts")
        init_max_seqs = llm.config.max_num_seqs

        for si, cfg in enumerate(sweep_configs):
            temp = cfg.get("temp", args.temp)
            b = cfg.get("b", args.b)
            if b > init_max_seqs:
                raise ValueError(f"sweep b={b} exceeds the engine's max_num_seqs "
                                 f"{init_max_seqs}")
            llm.config.max_num_seqs = b
            llm.scheduler.max_num_seqs = b

            sp = [SamplingParams(temperature=temp, draft_temperature=args.dtemp,
                                 ignore_eos=True, max_new_tokens=args.output_len)
                  for _ in range(num_reqs)]

            run_name = cfg.get("name") or (
                f"{create_run_name(args)}_sweep{si}" if args.sweep else create_run_name(args)
            )
            for _ in range(args.warm_passes):
                # Untimed pass: allocator, cuBLAS handles and the prefix
                # cache's repeat prompts, as the measured pass will find them.
                llm.generate([list(pr) for pr in prompts], sp)
            t0 = time.time()
            outputs, metrics = llm.generate([list(pr) for pr in prompts], sp)
            total_time = time.time() - t0
            total_tokens = sum(len(o["token_ids"]) for o in outputs)
            tput = total_tokens / total_time

            mode = ("fasync" if args.async_fused else "ssd" if args.draft_async else
                    "sd" if args.spec else "ngram" if args.ngram else "ar")
            print(f"\n[{run_name}] model={model_name} mode={mode}", flush=True)
            print(f"Total: {total_tokens} tokens in {total_time:.2f}s "
                  f"= {tput:.1f} tok/s end-to-end", flush=True)
            if args.example:
                for o in outputs:
                    print(f"\n--- {o['text'][:400]}", flush=True)
            log_wandb(args, run_name, metrics, total_tokens, total_time, tput)
    finally:
        llm.exit()


if __name__ == "__main__":
    sys.exit(main())
