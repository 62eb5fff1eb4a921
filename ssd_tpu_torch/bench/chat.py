"""Streaming chat CLI with TTFT / tok/s metrics.

The port of bench/chat.py: interactive chat over the engine with per-turn
time to first token and decode throughput, streamed through
`generate(stream_callback=...)`, plus a `--server` mode that talks to any
OpenAI-compatible HTTP server, and `--launch-baseline` that starts a vLLM
or SGLang server itself, chats against it and stops the exact process it
started. Engine mode needs a tokenizer (the checkpoint's tokenizer files
and the `transformers` package) and says so where it has none.

Usage:
  python -m ssd_tpu_torch.bench.chat --size 8                      # AR chat
  python -m ssd_tpu_torch.bench.chat --size 70 --gpus 5 --spec --async --draft 1 --k 7
  python -m ssd_tpu_torch.bench.chat --server http://localhost:30000 \\
      --model-id meta-llama/Llama-3.1-8B-Instruct

The engine runs on the card; `main(argv, **engine)` passes `engine` (e.g.
device="cpu", dtype="float32") to the LLM.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

from ssd_tpu_torch.bench.bench_helpers import get_model_paths, resolve_draft_path


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description="Chat with ssd_tpu_torch")
    p.add_argument("--size", type=str, default="8")
    p.add_argument("--llama", action="store_true", default=True)
    p.add_argument("--qwen", action="store_true")
    p.add_argument("--draft", type=str, default=None)
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--chips", "--gpus", dest="chips", type=int, default=1)
    p.add_argument("--spec", action="store_true")
    p.add_argument("--eagle", action="store_true")
    p.add_argument("--k", type=int, default=6)
    p.add_argument("--rounds", type=int, default=1,
                   help="sync SD: fused speculation rounds per step")
    p.add_argument("--async", dest="draft_async", action="store_true")
    p.add_argument("--async-fused", dest="async_fused", action="store_true",
                   help="fused async exchange/superstep (implies --async)")
    p.add_argument("--f", type=int, default=3)
    p.add_argument("--temp", type=float, default=0.0)
    p.add_argument("--max_new_tokens", type=int, default=512)
    p.add_argument("--max_model_len", type=int, default=8192)
    p.add_argument("--block_sz", type=int, default=256)
    p.add_argument("--system", type=str, default="You are a helpful assistant.")
    # Baseline server comparison
    p.add_argument("--server", type=str, default=None,
                   help="OpenAI-compatible base URL to chat against instead")
    p.add_argument("--model-id", type=str, default=None,
                   help="model id for --server requests")
    p.add_argument("--launch-baseline", choices=["vllm", "sglang"],
                   default=None,
                   help="launch this baseline server, chat against it, and "
                        "kill it (the exact PID) on exit")
    p.add_argument("--baseline-model", type=str, default=None,
                   help="model the launched baseline serves "
                        "(default: --model-id)")
    p.add_argument("--port", type=int, default=30000)
    p.add_argument("--launch-timeout", type=int, default=600)
    args = p.parse_args(argv)
    if args.qwen:
        args.llama = False
    if args.eagle:
        args.spec = True
    return args


def server_chat(args):
    """Chat against an external OpenAI-compatible server (baseline mode)."""
    history = [{"role": "system", "content": args.system}]
    print(f"Chatting against {args.server} (ctrl-d to exit)", flush=True)
    while True:
        try:
            user = input("\nYou: ")
        except EOFError:
            break
        history.append({"role": "user", "content": user})
        body = json.dumps({
            "model": args.model_id or "default",
            "messages": history,
            "temperature": args.temp,
            "max_tokens": args.max_new_tokens,
            "stream": True,
        }).encode()
        req = urllib.request.Request(
            args.server.rstrip("/") + "/v1/chat/completions",
            data=body, headers={"Content-Type": "application/json"},
        )
        t0 = time.perf_counter()
        ttft, n_tok, text = None, 0, []
        with urllib.request.urlopen(req) as resp:
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data:") or line.endswith("[DONE]"):
                    continue
                delta = json.loads(line[5:])["choices"][0]["delta"].get("content", "")
                if delta:
                    if ttft is None:
                        ttft = time.perf_counter() - t0
                    n_tok += 1
                    text.append(delta)
                    print(delta, end="", flush=True)
        dt = time.perf_counter() - t0
        print(f"\n[ttft {ttft:.2f}s | {n_tok / max(dt, 1e-9):.1f} tok/s]", flush=True)
        history.append({"role": "assistant", "content": "".join(text)})


def llm_kwargs(args, draft_path: str) -> dict:
    """The engine's arguments. The port refuses a draft or a speculative
    knob on an engine that does not use it, so they go only to the modes
    that do (the JAX CLI passes them all and its engine ignores the rest)."""
    kw = dict(num_devices=args.chips, kvcache_block_size=args.block_sz,
              max_model_len=args.max_model_len, max_num_seqs=1)
    if args.spec:
        draft_async = args.draft_async or args.async_fused
        kw.update(speculate=True, draft=draft_path, speculate_k=args.k,
                  spec_rounds=args.rounds, draft_async=draft_async,
                  async_fused=args.async_fused, use_eagle=args.eagle)
        if draft_async:
            kw["async_fan_out"] = args.f
    return kw


def ssd_chat(args, engine=None):
    from ssd_tpu_torch import SamplingParams
    from ssd_tpu_torch.llm import LLM

    if args.model_path:
        model_path = args.model_path
        draft_path = resolve_draft_path(args.draft) if args.draft else model_path
    else:
        _, model_path, draft_path = get_model_paths(args)

    llm = LLM(model_path, **llm_kwargs(args, draft_path), **(engine or {}))
    try:
        tokenizer = llm.tokenizer
        if tokenizer is None:
            raise RuntimeError("chat needs a tokenizer: the checkpoint's tokenizer files "
                               "and the transformers package")
        history = [{"role": "system", "content": args.system}]
        print("Chat ready (ctrl-d to exit).", flush=True)
        while True:
            try:
                user = input("\nYou: ")
            except EOFError:
                break
            history.append({"role": "user", "content": user})
            ids = tokenizer.apply_chat_template(history, add_generation_prompt=True)

            state = {"t0": time.perf_counter(), "ttft": None, "n": 0, "ids": []}

            def on_tokens(seq_id, new_ids):
                if state["ttft"] is None:
                    state["ttft"] = time.perf_counter() - state["t0"]
                state["n"] += len(new_ids)
                state["ids"].extend(new_ids)
                print(tokenizer.decode(new_ids, skip_special_tokens=True),
                      end="", flush=True)

            print("Assistant: ", end="", flush=True)
            llm.generate(
                [ids],
                SamplingParams(temperature=args.temp, max_new_tokens=args.max_new_tokens),
                use_tqdm=False,
                stream_callback=on_tokens,
            )
            dt = time.perf_counter() - state["t0"]
            tps = state["n"] / max(dt - (state["ttft"] or 0), 1e-9)
            print(f"\n[ttft {state['ttft']:.2f}s | {tps:.1f} tok/s]", flush=True)
            history.append({
                "role": "assistant",
                "content": tokenizer.decode(state["ids"], skip_special_tokens=True),
            })
    finally:
        llm.exit()


# The port's own copies of bench/run_baseline_bench.py's server_command and
# wait_healthy: a baseline server's command line with a speculative config
# matched to ours, and a poll of its /health until it answers.
def server_command(args) -> list[str]:
    if args.engine == "vllm":
        cmd = ["vllm", "serve", args.model, "--port", str(args.port),
               "--tensor-parallel-size", str(args.tp)]
        if args.draft:
            spec = {"model": args.draft, "num_speculative_tokens": args.k,
                    "method": "draft_model"}
            cmd += ["--speculative-config", json.dumps(spec)]
        return cmd
    cmd = ["python", "-m", "sglang.launch_server", "--model-path", args.model,
           "--port", str(args.port), "--tp", str(args.tp)]
    if args.draft:
        cmd += ["--speculative-algorithm", "STANDALONE",
                "--speculative-draft-model-path", args.draft,
                "--speculative-num-steps", str(args.k),
                "--speculative-eagle-topk", "1",
                "--speculative-num-draft-tokens", str(args.k + 1)]
    return cmd


def wait_healthy(port: int, timeout: int) -> bool:
    deadline = time.time() + timeout
    url = f"http://localhost:{port}/health"
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                if r.status == 200:
                    return True
        except (urllib.error.URLError, OSError):
            time.sleep(2)
    return False


def launch_baseline(args):
    """Start the baseline server as a subprocess and poll /health until
    ready. Returns the Popen; the caller kills that exact PID on exit."""
    model = args.baseline_model or args.model_id
    if not model:
        raise ValueError("--launch-baseline needs --baseline-model or --model-id")
    cmd = server_command(SimpleNamespace(
        engine=args.launch_baseline, model=model, draft=args.draft,
        k=args.k, tp=args.chips, port=args.port,
    ))
    print("launching baseline:", " ".join(cmd), flush=True)
    proc = subprocess.Popen(cmd)
    if not wait_healthy(args.port, args.launch_timeout):
        proc.terminate()
        proc.wait(timeout=30)
        raise RuntimeError("baseline server did not become healthy in time")
    return proc


def main(argv=None, **engine):
    """Chat until end of input. `engine` goes to the LLM (e.g.
    device="cpu", dtype="float32")."""
    args = parse_arguments(argv)
    proc = None
    if args.launch_baseline:
        proc = launch_baseline(args)
        args.server = f"http://localhost:{args.port}"
    try:
        if args.server:
            server_chat(args)
        else:
            ssd_chat(args, engine)
    finally:
        if proc is not None:
            # Kill the exact PID we started (never by pattern).
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()


if __name__ == "__main__":
    sys.exit(main())
