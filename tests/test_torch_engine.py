"""ssd_tpu_torch end to end on the CPU: `LLM(..., device="cpu").generate`
must be greedy token-exact against the JAX engine and against HF
transformers, through the flat prefill (mixed-length batches), prefix-cache
hits, preemption, chunked prefill and abort; and the package must stay free
of JAX and of the JAX package.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import ssd_tpu_torch
from ssd_tpu.engine.llm_engine import METRICS as JAX_METRICS
from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.engine import llm_engine
from ssd_tpu_torch.utils.misc import load_tokenizer
from tests.utils_models import hf_greedy, make_tiny_llama, make_tiny_qwen3, random_prompt, rng


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker (the HF oracle of the
    JAX package's tests) keeps its own thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


GREEDY = dict(temperature=0.0, ignore_eos=True)
ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024,
              kvcache_block_size=16, num_kvcache_blocks=64, max_num_seqs=4)
PKG = pathlib.Path(ssd_tpu_torch.__file__).parent


def port(path, **kw):
    return ssd_tpu_torch.LLM(path, device="cpu", dtype="float32", **{**ENGINE, **kw})


def run(llm, prompts, n):
    outs, _ = llm.generate([list(p) for p in prompts],
                           SamplingParams(max_new_tokens=n, **GREEDY), use_tqdm=False)
    return [o["token_ids"] for o in outs]


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_llama")
    make_tiny_llama(d)
    return str(d)


@pytest.fixture(scope="module")
def qwen_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_qwen3")
    make_tiny_qwen3(d)
    return str(d)


@pytest.mark.parametrize("family", ["llama", "qwen3"])
def test_mixed_batch_matches_jax_and_hf(family, llama_dir, qwen_dir):
    """A mixed-length batch (one flat prefill, then batched decode)."""
    d = llama_dir if family == "llama" else qwen_dir
    r = rng(2)
    prompts = [random_prompt(r, 5, 30) for _ in range(3)]
    got = run(port(d), prompts, 20)
    jax_outs, _ = JaxLLM(d, dtype="float32", **ENGINE).generate(
        [list(p) for p in prompts],
        SamplingParams(max_new_tokens=20, **GREEDY), use_tqdm=False)
    assert got == [o["token_ids"] for o in jax_outs]
    assert got == [hf_greedy(d, p, 20) for p in prompts]


def test_prefix_cache_hit_is_exact(llama_dir):
    """A prompt sharing two full blocks with an earlier one prefills only its
    new tokens, and stays exact."""
    llm = port(llama_dir)
    seen = []
    orig = llm.model_runner.run_prefill

    def spy(seqs):
        seen.append([s.num_cached_tokens for s in seqs])
        return orig(seqs)

    llm.model_runner.run_prefill = spy
    base = random_prompt(rng(4), 40, 41)
    p1, p2 = base + [7, 8], base + [9, 10]
    assert run(llm, [p1], 12) == [hf_greedy(llama_dir, p1, 12)]
    assert run(llm, [p2], 12) == [hf_greedy(llama_dir, p2, 12)]
    assert seen == [[0], [32]]


def test_preemption_under_pressure_is_exact(llama_dir):
    """4 sequences need ~288 slots at peak and the pool holds 224: the
    scheduler must preempt and re-prefill, and outputs stay exact."""
    llm = port(llama_dir, max_model_len=128, num_kvcache_blocks=14)
    preempted = []
    orig = llm.scheduler.preempt

    def spy(seq):
        preempted.append(seq.seq_id)
        return orig(seq)

    llm.scheduler.preempt = spy
    prompts = [random_prompt(rng(300 + i), 16, 24) for i in range(4)]
    assert run(llm, prompts, 48) == [hf_greedy(llama_dir, p, 48) for p in prompts]
    assert preempted


def test_chunked_prefill_is_exact(llama_dir, monkeypatch):
    """A 100-token prompt against a 32-token budget takes several chunk
    dispatches, interleaved with a short prompt's decode, and stays exact."""
    chunks = []
    orig = llm_engine.LLMEngine._run_prefill_chunk

    def spy(self, seq):
        chunks.append(seq.prefill_chunk)
        return orig(self, seq)

    monkeypatch.setattr(llm_engine.LLMEngine, "_run_prefill_chunk", spy)
    llm = port(llama_dir, chunked_prefill=True, max_num_batched_tokens=32,
               num_kvcache_blocks=96)
    prompts = [random_prompt(rng(42), 100, 101), random_prompt(rng(43), 8, 12)]
    assert run(llm, prompts, 12) == [hf_greedy(llama_dir, p, 12) for p in prompts]
    assert len(chunks) >= 2 and all(c == 32 for c in chunks), chunks


def test_abort_frees_blocks_and_survivor_is_exact(llama_dir):
    llm = port(llama_dir)
    sp = SamplingParams(max_new_tokens=24, **GREEDY)
    keep_prompt = random_prompt(rng(101), 8, 16)
    keep_id = llm.add_request(list(keep_prompt), sp)
    kill_id = llm.add_request(list(random_prompt(rng(102), 8, 16)), sp)
    llm.step()   # prefill both
    llm.step()   # one decode step
    assert llm.abort_request(kill_id) is True
    assert llm.abort_request(kill_id) is False
    queued_id = llm.add_request(list(random_prompt(rng(103), 8, 16)), sp)
    assert llm.abort_request(queued_id) is True
    outs = {}
    for _ in range(100):
        for sid, toks in llm.step():
            outs[sid] = toks
        if llm.is_finished():
            break
    assert outs[keep_id] == hf_greedy(llama_dir, keep_prompt, 24)
    assert not llm.scheduler.block_manager.used_block_ids


def test_metrics_keys_match_jax(llama_dir):
    _, metrics = port(llama_dir).generate(
        [[5, 6, 7]], SamplingParams(max_new_tokens=3, **GREEDY), use_tqdm=False)
    assert set(metrics) == set(JAX_METRICS)
    # As in the JAX engine, a prefill counts the sequence length after its
    # first sampled token is appended.
    assert metrics["prefill_total_tokens"] == 4 and metrics["decode_total_tokens"] == 2
    # The speculative modes fill the speculative keys (the model drafts for
    # itself here): sync SD its acceptance and verify times, async SSD also
    # the cache hits and the hit/miss split.
    spec = dict(draft=llama_dir, speculate=True, speculate_k=2)
    for extra, keys in (({}, ("accepted_suffix_lens_with_recovery", "target_verify_times")),
                        ({"draft_async": True, "async_fan_out": 2},
                         ("cache_hits", "accepted_suffix_lens_on_hit",
                          "accepted_suffix_lens_on_miss"))):
        llm = port(llama_dir, **spec, **extra)
        _, metrics = llm.generate([[5, 6, 7]], SamplingParams(max_new_tokens=12, **GREEDY),
                                  use_tqdm=False)
        llm.exit()
        assert set(metrics) == set(JAX_METRICS)
        assert all(metrics[k] for k in keys), {k: metrics[k] for k in keys}
        assert metrics["decode_total_tokens"] == sum(
            metrics["accepted_suffix_lens_with_recovery"])


def test_request_validation(llama_dir):
    llm = port(llama_dir)
    with pytest.raises(ValueError, match="enable_top_sampling"):
        llm.add_request([5, 6], SamplingParams(top_p=0.5))
    with pytest.raises(ValueError, match="tokenizer"):
        llm.add_request("hello", SamplingParams())
    with pytest.raises(ValueError, match="max_model_len"):
        llm.add_request([5] * 256, SamplingParams())
    with pytest.raises(TypeError, match="use_pallas"):
        port(llama_dir, use_pallas=True)
    with pytest.raises(ValueError, match="draft"):
        port(llama_dir, speculate=True)   # no default draft checkpoint


# Modes not ported yet, refused whatever else is asked for. use_eagle is
# served since the EAGLE-3 slice: without speculate=True it is an ignored
# knob, refused with a ValueError. ngram speculation and AR multi-step are
# served since the CUDA-graph slice, and spec_rounds without speculate is an
# ignored knob; async_fused since the fused-async slice, so without
# speculate=True it is an ignored knob too; draft_dp since the draft-topology
# slice, an ignored knob without the unfused async draft.
UNPORTED: set = set()
SERVED = {"ngram_speculate", "multi_step"}


@pytest.mark.parametrize("field,value", [
    ("speculate_k", 4), ("spec_rounds", 2), ("async_fan_out", 2),
    ("fan_out_list", [3, 1]), ("fan_out_list_miss", [3, 1]),
    ("draft_async", True), ("sampler_x", 1.5), ("jit_speculate", True),
    ("async_fused", True), ("use_eagle", True), ("ngram_speculate", True),
    ("multi_step", 2), ("draft_dp", 2)])
def test_unported_speculative_fields_refused(llama_dir, field, value):
    """A mode this slice does not port is refused (NotImplementedError); a
    speculative knob on an engine that does not speculate, where it would be
    silently ignored, is refused too (ValueError). The served modes among
    these fields give the AR engine's greedy tokens."""
    if field in SERVED:
        prompts = [random_prompt(rng(9), 5, 20) for _ in range(2)]
        assert run(port(llama_dir, **{field: value}), prompts, 12) == \
            run(port(llama_dir), prompts, 12)
        return
    exc = NotImplementedError if field in UNPORTED else ValueError
    with pytest.raises(exc, match=field):
        port(llama_dir, **{field: value})


FUSED = dict(speculate=True, speculate_k=2, draft_async=True)


@pytest.mark.parametrize("kw,msg", [
    (dict(speculate=True, async_fused=True, speculate_k=2), "requires draft_async"),
    (dict(FUSED, spec_rounds=2), "needs async_fused"),
    (dict(FUSED, async_fused=True, draft_dp=2), "excludes draft_dp"),
    (dict(FUSED, async_fused=True, use_eagle=True, jit_speculate=True), "excludes use_eagle"),
])
def test_fused_async_rules(llama_dir, kw, msg):
    """The JAX package's rules of the fused async forms, as ValueErrors:
    async_fused needs draft_async and excludes EAGLE and draft_dp > 1;
    spec_rounds > 1 with draft_async needs async_fused."""
    with pytest.raises(ValueError, match=msg):
        port(llama_dir, draft=llama_dir, kvcache_block_size=16, **kw)


def test_sampled_generation_with_top_warp(llama_dir):
    llm = port(llama_dir, enable_top_sampling=True, seed=3)
    sp = SamplingParams(temperature=0.8, top_p=0.9, top_k=20, max_new_tokens=16,
                        ignore_eos=True)
    outs, _ = llm.generate([[5, 6, 7, 8]] * 2, sp, use_tqdm=False)
    assert all(len(o["token_ids"]) == 16 for o in outs)
    assert all(0 <= t < 128 for o in outs for t in o["token_ids"])


def test_tokenizer_files_without_transformers(tmp_path, monkeypatch):
    """A checkpoint with tokenizer files still loads where `transformers` is
    not installed; the engine then takes token-id prompts only."""
    (tmp_path / "tokenizer.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert load_tokenizer(str(tmp_path)) is None


def test_no_gpu_and_no_device_raises(llama_dir, monkeypatch):
    """The engine runs on "cuda" unless asked for the CPU; with no GPU it
    raises instead of dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ssd_tpu_torch.LLM(llama_dir, dtype="float32", **ENGINE)


def _imported_modules(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


def test_package_imports_neither_jax_nor_ssd_tpu():
    """Statically: no file imports jax, the JAX package or the top-level
    `bench` package of its CLIs (a whole module name, so ssd_tpu_torch and
    ssd_tpu_torch.bench do not match). At run time: importing every module,
    the CLIs included, leaves all three out of sys.modules."""
    refused = ("jax", "jaxlib", "ssd_tpu", "bench")
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    for f in files:
        for m in _imported_modules(f):
            top = m.split(".")[0]
            assert top not in refused, f"{f}: imports {m}"
    mods = [".".join(p.relative_to(PKG.parent).with_suffix("").parts)
            for p in sorted(PKG.rglob("*.py"))]
    assert {"ssd_tpu_torch.models.eagle3", "ssd_tpu_torch.engine.eagle_runner",
            "ssd_tpu_torch.ops.probes", "ssd_tpu_torch.bench.s8_probe",
            "ssd_tpu_torch.bench.kernel_diag", "ssd_tpu_torch.bench.chat",
            "ssd_tpu_torch.bench.compare_outputs", "ssd_tpu_torch.bench.bench",
            "ssd_tpu_torch.bench.bench_helpers"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {refused!r}]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(PKG.parent)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
