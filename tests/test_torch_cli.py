"""The port's CLIs (ssd_tpu_torch/bench/: compare_outputs, chat, bench and
their helpers) on the CPU, on tiny fp32 checkpoints written without
transformers (tests/test_torch_tp.py::tiny_checkpoint), against the JAX
package's CLIs (bench/) where both run:

- compare_outputs: the port's and ssd_tpu's on the same target/draft pair
  and prompt ids each print three EXACT MATCH lines and return 0, and the
  port's token ids of every mode equal ssd_tpu's (exact: any differing
  token fails); its --server diff against a stub OpenAI-compatible server;
- chat: one scripted turn in engine mode with a stand-in tokenizer (token
  ids as text), streamed, with TTFT and tok/s; server mode against a stub
  stream, as tests/test_cli_surfaces.py drives the JAX CLI; engine mode
  without a tokenizer refuses;
- bench_helpers.generate_benchmark_inputs equals JAX's for the same
  arguments and seed (random ids; a dataset flag and --all falling back);
- bench.create_llm_kwargs of AR, SD, fused SD, SSD, ngram and EAGLE flags
  each build a port Config;
- bench.main's generated tokens (AR and async SSD) equal the port's
  LLM.generate on the same prompts.

Both packages run in fp32: the JAX CLIs through their LLM with
dtype="float32", the port's through main(argv, device="cpu",
dtype="float32").
"""

import argparse
import builtins
import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

import ssd_tpu.llm as jax_llm
from bench import bench_helpers as jax_helpers
from bench import compare_outputs as jax_compare
import ssd_tpu_torch
from ssd_tpu_torch import Config
from ssd_tpu_torch.bench import bench as port_bench
from ssd_tpu_torch.bench import bench_helpers as port_helpers
from ssd_tpu_torch.bench import chat as port_chat
from ssd_tpu_torch.bench import compare_outputs as port_compare
from ssd_tpu_torch.engine import llm_engine as port_engine
from tests.test_torch_tp import tiny_checkpoint

ENGINE = dict(device="cpu", dtype="float32")
PROMPT_IDS = ["3", "17", "42", "9", "55", "101", "7"]
COMMON = ["--max_model_len", "256", "--block_sz", "16"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker keeps its own count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A 2-layer target and a 1-layer draft of the same vocabulary (128
    tokens), and a 2-layer target of 10,240 tokens for bench's random ids
    (drawn in [10, 10000])."""
    out = {}
    for name, kw in (("target", dict(seed=0, scale=0.1)),
                     ("draft", dict(seed=7, scale=0.1, layers=1, hidden=32, intermediate=64,
                                    head_dim=8)),
                     ("wide", dict(seed=3, scale=0.1, vocab=10240)),
                     ("wide_draft", dict(seed=4, scale=0.1, layers=1, vocab=10240))):
        d = str(tmp_path_factory.mktemp(f"cli_{name}"))
        tiny_checkpoint(d, **kw)
        out[name] = d
    return out


def _recording(monkeypatch, module):
    """Wrap module.run_mode so each mode's token ids are kept."""
    tokens = {}
    run_mode = module.run_mode

    def rec(model_path, draft_path, prompt, args, mode, *rest):
        text, toks = run_mode(model_path, draft_path, prompt, args, mode, *rest)
        tokens[mode] = list(toks)
        return text, toks

    monkeypatch.setattr(module, "run_mode", rec)
    return tokens


def test_compare_outputs_port_equals_jax(ckpts, monkeypatch, capsys):
    """Both CLIs on the same pair and prompt ids: rc 0, three EXACT MATCH
    each, and the port's tokens of every mode equal ssd_tpu's."""
    argv = ["--model-path", ckpts["target"], "--draft", ckpts["draft"],
            "--prompt-ids", *PROMPT_IDS, "--max_new_tokens", "12", "--k", "3", "--f", "2",
            *COMMON]
    port_tokens = _recording(monkeypatch, port_compare)
    rc = port_compare.main(argv, **ENGINE)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("EXACT MATCH") == 3, out

    jax_tokens = _recording(monkeypatch, jax_compare)
    real = jax_llm.LLM
    monkeypatch.setattr(jax_llm, "LLM", lambda *a, **kw: real(*a, dtype="float32", **kw))
    monkeypatch.setattr("sys.argv", ["compare_outputs", *argv])
    rc = jax_compare.main()
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("EXACT MATCH") == 3, out
    assert set(port_tokens) == {"ar", "sd", "sd-fused", "ssd"}
    assert port_tokens == jax_tokens
    assert len(port_tokens["ar"]) == 12


class _DummyTokenizer:
    """Token ids as text; a chat history becomes a short deterministic
    prompt (tests/test_cli_surfaces.py's stand-in)."""
    eos_token_id = 2

    def apply_chat_template(self, history, add_generation_prompt=True):
        seed = sum(len(m["content"]) for m in history) % 40
        return [1, 3 + seed, 5, 7]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)

    def encode(self, text):
        return [1, 5, 9]


def _scripted_input(monkeypatch, lines):
    it = iter(lines)

    def fake_input(prompt=""):
        try:
            return next(it)
        except StopIteration:
            raise EOFError

    monkeypatch.setattr(builtins, "input", fake_input)


def test_chat_engine_mode_streams(ckpts, monkeypatch, capsys):
    """One scripted turn through the port's engine: the stream callback
    prints the tokens that LLM.generate gives the same prompt, TTFT and
    tok/s are reported, and the chat ends on EOF."""
    monkeypatch.setattr(port_engine, "load_tokenizer", lambda path: _DummyTokenizer())
    _scripted_input(monkeypatch, ["hello there"])
    port_chat.main(["--model-path", ckpts["target"], "--max_new_tokens", "8", *COMMON],
                   **ENGINE)
    out = capsys.readouterr().out
    assert "Chat ready" in out
    assert "[ttft" in out and "tok/s]" in out
    history = [{"role": "system", "content": "You are a helpful assistant."},
               {"role": "user", "content": "hello there"}]
    llm = ssd_tpu_torch.LLM(ckpts["target"], max_num_seqs=1, max_model_len=256,
                            kvcache_block_size=16, **ENGINE)
    try:
        outs, _ = llm.generate([_DummyTokenizer().apply_chat_template(history)],
                               ssd_tpu_torch.SamplingParams(temperature=0.0, max_new_tokens=8),
                               use_tqdm=False)
    finally:
        llm.exit()
    # Each step's new ids decode to their text, printed back to back.
    streamed = out.split("Assistant: ")[1].split("\n[ttft")[0]
    assert streamed == "".join(str(i) for i in outs[0]["token_ids"])
    assert len(outs[0]["token_ids"]) == 8


def test_chat_engine_mode_needs_a_tokenizer(ckpts, monkeypatch):
    """Without a tokenizer (no tokenizer files, or no transformers) engine
    mode says so, as the JAX CLI's does."""
    _scripted_input(monkeypatch, ["hi"])
    with pytest.raises(RuntimeError, match="chat needs a tokenizer"):
        port_chat.main(["--model-path", ckpts["target"], *COMMON], **ENGINE)


class _StubServer(BaseHTTPRequestHandler):
    """An OpenAI-compatible endpoint: a streamed chat reply, or a whole one
    whose text is `reply`."""
    reply = "hi from stub"

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        assert self.path == "/v1/chat/completions"
        self.send_response(200)
        if body.get("stream"):
            self.send_header("Content-Type", "text/event-stream")
            self.end_headers()
            for word in ("hi", " from", " stub"):
                chunk = {"choices": [{"delta": {"content": word}}]}
                self.wfile.write(f"data: {json.dumps(chunk)}\n".encode())
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n")
        else:
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(json.dumps(
                {"choices": [{"message": {"content": self.reply}}]}).encode())

    def log_message(self, *a):
        pass


@pytest.fixture
def stub_server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _StubServer)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        thread.join(timeout=10)
        assert not thread.is_alive()


def test_chat_server_mode_parses_stream(stub_server, monkeypatch, capsys):
    """Baseline mode: the SSE stream is parsed delta by delta and the
    turn's TTFT and tok/s are printed."""
    _scripted_input(monkeypatch, ["ping"])
    port_chat.main(["--server", stub_server])
    out = capsys.readouterr().out
    assert "hi from stub" in out
    assert "[ttft" in out


def test_compare_outputs_server_diff(ckpts, stub_server, monkeypatch, capsys):
    """--server: the AR engine's text for the text prompt against the
    server's, a match and a divergence (exit code 1)."""
    monkeypatch.setattr(port_engine, "load_tokenizer", lambda path: _DummyTokenizer())
    llm = ssd_tpu_torch.LLM(ckpts["target"], max_num_seqs=1, max_model_len=256,
                            kvcache_block_size=16, **ENGINE)
    try:
        outs, _ = llm.generate([[1, 3 + len("hi") % 40, 5, 7]],
                               ssd_tpu_torch.SamplingParams(temperature=0.0, max_new_tokens=6),
                               use_tqdm=False)
    finally:
        llm.exit()
    argv = ["--model-path", ckpts["target"], "--draft", ckpts["draft"], "--prompt", "hi",
            "--max_new_tokens", "6", "--k", "3", "--f", "2", "--server", stub_server, *COMMON]
    monkeypatch.setattr(_StubServer, "reply", outs[0]["text"])
    assert port_compare.main(argv, **ENGINE) == 0
    assert "ar == server: EXACT MATCH" in capsys.readouterr().out
    monkeypatch.setattr(_StubServer, "reply", outs[0]["text"] + " 9")
    assert port_compare.main(argv, **ENGINE) == 1
    assert "ar != server: first divergence" in capsys.readouterr().out


def _bench_args(**over):
    ns = dict(humaneval=False, alpaca=False, gsm8k=False, c4=False, ultrafeedback=False,
              random=False, all=False, chat_template=False, eagle=False, numseqs=3,
              input_len=9, prompt_offset=0)
    ns.update(over)
    return argparse.Namespace(**ns)


@pytest.mark.parametrize("flags", [dict(random=True), dict(gsm8k=True), dict(all=True),
                                   dict(random=True, numseqs=5, input_len=17)])
def test_generate_benchmark_inputs_equal_jax(flags, tmp_path, monkeypatch):
    """The same arguments and seed give the same prompts: random ids, and a
    dataset flag or --all whose datasets are missing (each falls back to
    random ids)."""
    for helpers in (jax_helpers, port_helpers):
        for name in list(helpers.DATASET_PATHS):
            monkeypatch.setitem(helpers.DATASET_PATHS, name, str(tmp_path / f"{name}.jsonl"))
    args = _bench_args(**flags)
    random.seed(0)
    want = jax_helpers.generate_benchmark_inputs(args, str(tmp_path))
    random.seed(0)
    got = port_helpers.generate_benchmark_inputs(args, str(tmp_path))
    assert got == want
    assert len(got) == args.numseqs * (4 if args.all else 1)
    assert all(len(p) == args.input_len for p in got)


def _config_dir(tmp_path, name, layers):
    d = tmp_path / name
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": 128, "hidden_size": 64,
        "intermediate_size": 128, "num_hidden_layers": layers, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "max_position_embeddings": 512,
        "eos_token_id": 2}))
    return str(d)


@pytest.mark.parametrize("flags,want", [
    ([], dict(speculate=False, ngram_speculate=False)),
    (["--spec", "--k", "4"], dict(speculate=True, speculate_k=4, draft_async=False)),
    (["--spec", "--rounds", "4"], dict(speculate=True, spec_rounds=4, draft_async=False)),
    (["--spec", "--async", "--f", "2", "--ddp", "2", "--eager"],
     dict(speculate=True, draft_async=True, async_fan_out=2, draft_dp=2, jit_speculate=True,
          enforce_eager=True)),
    (["--ngram", "--k", "3", "--rounds", "2", "--ngram_n", "2"],
     dict(ngram_speculate=True, speculate_k=3, spec_rounds=2, ngram_n=2)),
    (["--eagle", "--async", "--k", "3"],
     dict(speculate=True, use_eagle=True, draft_async=True, jit_speculate=True)),
])
def test_create_llm_kwargs_build_a_port_config(flags, want, tmp_path):
    """Each mode's flag set, with the draft resolved, builds a port Config
    (which refuses a knob its mode would ignore) with the flags' fields."""
    target = _config_dir(tmp_path, "target", layers=4)
    draft = _config_dir(tmp_path, "draft", layers=1)
    args = port_bench.parse_arguments(["--model-path", target, "--draft", draft, "--b", "4",
                                       *COMMON, *flags])
    kw = port_bench.create_llm_kwargs(args, draft)
    cfg = Config(target, **kw, **ENGINE)
    assert cfg.max_num_seqs == 4 and cfg.kvcache_block_size == 16
    assert cfg.num_devices == 1
    for name, value in want.items():
        assert getattr(cfg, name) == value, name
    assert port_bench.create_run_name(args)


@pytest.mark.parametrize("mode", ["ar", "ssd"])
def test_bench_main_tokens_equal_llm_generate(mode, ckpts, monkeypatch, capsys):
    """bench.main on random ids: its generated tokens equal LLM.generate's
    on the same prompts (random.seed(0), as main seeds), and it prints the
    end-to-end tok/s line."""
    argv = ["--model-path", ckpts["wide"], "--random", "--b", "2", "--numseqs", "2",
            "--input_len", "16", "--output_len", "8", *COMMON]
    if mode == "ssd":
        argv += ["--draft", ckpts["wide_draft"], "--spec", "--async", "--k", "3", "--f", "2"]
    seen = []

    class Recording(ssd_tpu_torch.LLM):
        def generate(self, *a, **kw):
            outputs, metrics = super().generate(*a, **kw)
            seen.append([o["token_ids"] for o in outputs])
            return outputs, metrics

    monkeypatch.setattr(ssd_tpu_torch.llm, "LLM", Recording)
    port_bench.main(argv, **ENGINE)
    out = capsys.readouterr().out
    assert "tok/s end-to-end" in out and f"mode={mode}" in out
    monkeypatch.undo()
    random.seed(0)
    prompts = port_helpers.random_token_prompts(2, 16)
    args = port_bench.parse_arguments(argv)
    llm = ssd_tpu_torch.LLM(ckpts["wide"], **port_bench.create_llm_kwargs(
        args, ckpts["wide_draft"] if mode == "ssd" else ckpts["wide"]), **ENGINE)
    try:
        outs, _ = llm.generate(prompts, ssd_tpu_torch.SamplingParams(
            temperature=0.0, ignore_eos=True, max_new_tokens=8), use_tqdm=False)
    finally:
        llm.exit()
    assert seen == [[o["token_ids"] for o in outs]]
    assert all(len(t) == 8 for t in seen[0])
