"""ssd_tpu_torch's speculative modes end to end on the CPU, against the JAX
package on the tiny target/draft pair of tests/test_e2e_spec_async.py:

- sync SD and async SSD (with and without jit_speculate) give greedy tokens
  equal to the port's AR, to ssd_tpu's same mode and to HF transformers, in
  fp32; async SSD's per-step cache hits and accepted lengths equal JAX's
  (both packages draw the miss rows from the same numpy stream);
- the draft's tree build and chain against their JAX programs (tokens,
  logits, draft KV cache);
- a batch whose sequences finish mid-stream, preemption under a small pool,
  abort of a speculating sequence, and a draft-thread failure that must
  surface in generate().
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.engine import draft_runner as jdr
from ssd_tpu.engine import model_runner as jmr
from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu.models.transformer import Arch as JaxArch
from ssd_tpu.utils.loader import load_params as jax_load_params
from ssd_tpu import SamplingParams as JaxSamplingParams
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.config import Config
from ssd_tpu_torch.engine import draft_runner as dr
from ssd_tpu_torch.engine.model_runner import ModelRunner
from tests.utils_models import hf_greedy, make_tiny_llama, random_prompt, rng


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker (the HF oracle of the
    JAX package's tests) keeps its own thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024, kvcache_block_size=16,
              num_kvcache_blocks=96, max_num_seqs=4, dtype="float32")
K, F = 3, 2
N_NEW = 32
PROMPTS = [random_prompt(rng(20 + i), 8, 24) for i in range(3)]
MODES = {
    "sync": dict(speculate=True, speculate_k=K),
    "async": dict(speculate=True, speculate_k=K, draft_async=True, async_fan_out=F),
    "async_jit": dict(speculate=True, speculate_k=K, draft_async=True,
                      async_fan_out=F, jit_speculate=True),
}
SPEC_KEYS = ("cache_hits", "accepted_suffix_lens_with_recovery",
             "accepted_suffix_lens_on_hit", "accepted_suffix_lens_on_miss")


@pytest.fixture(scope="module")
def target_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spec_target")
    make_tiny_llama(d, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def draft_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spec_draft")
    make_tiny_llama(d, layers=1, hidden=32, intermediate=64, heads=4, kv_heads=2, seed=7)
    return str(d)


def port(target, **kw):
    return ssd_tpu_torch.LLM(target, device="cpu", **{**ENGINE, **kw})


def serve(llm, prompts, sps):
    """Generate to completion; returns (token lists, the metrics' lists)."""
    try:
        outs, m = llm.generate([list(p) for p in prompts], sps, use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs], {k: list(v) for k, v in m.items()
                                             if isinstance(v, list)}


def greedy(n=N_NEW):
    return SamplingParams(temperature=0.0, max_new_tokens=n, ignore_eos=True)


@pytest.fixture(scope="module")
def reference(target_dir):
    """The port's AR tokens and HF's on PROMPTS."""
    ar, _ = serve(port(target_dir), PROMPTS, greedy())
    return ar, [hf_greedy(target_dir, p, N_NEW) for p in PROMPTS]


@pytest.mark.parametrize("mode", list(MODES))
def test_spec_greedy_matches_ar_jax_and_hf(mode, target_dir, draft_dir, reference):
    got, m = serve(port(target_dir, draft=draft_dir, **MODES[mode]), PROMPTS, greedy())
    jax_engine = JaxLLM(target_dir, draft=draft_dir, **ENGINE, **MODES[mode])
    jouts, jm = jax_engine.generate(
        [list(p) for p in PROMPTS],
        JaxSamplingParams(temperature=0.0, max_new_tokens=N_NEW, ignore_eos=True),
        use_tqdm=False)
    jax_engine.exit()
    ar, hf = reference
    assert got == ar == hf
    assert got == [o["token_ids"] for o in jouts]
    assert m["accepted_suffix_lens_with_recovery"], "the spec path did not run"
    for key in SPEC_KEYS:
        assert m[key] == list(jm[key]), key
    if mode != "sync":
        assert m["cache_hits"] and 0 < sum(m["cache_hits"]) < len(m["cache_hits"])


def test_self_draft_hits_and_accepts_fully(target_dir):
    """With draft == target at temperature 0 the fork at every depth holds
    the target's argmax: after the first (cold) step every step hits and
    accepts all K+1 tokens."""
    _, m = serve(port(target_dir, draft=target_dir, **MODES["async"]), PROMPTS[:1],
                 greedy(48))
    hits = m["cache_hits"]
    assert sum(hits[1:]) == len(hits) - 1, hits
    assert m["accepted_suffix_lens_on_hit"] and set(m["accepted_suffix_lens_on_hit"]) == {K + 1}


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_batch_finishing_midstream(mode, target_dir, draft_dir):
    """Sequences with different max_new_tokens leave the batch at different
    steps (one stops inside an accepted suffix); the shrinking batch stays
    exact against AR."""
    prompts = [random_prompt(rng(800 + i), 8, 16) for i in range(3)]
    sps = [greedy(n) for n in (7, 20, 33)]
    want, _ = serve(port(target_dir), prompts, sps)
    got, _ = serve(port(target_dir, draft=draft_dir, **MODES[mode]), prompts, sps)
    assert got == want
    assert [len(g) for g in got] == [7, 20, 33]


def test_sync_sd_runs_to_context_limit(target_dir, draft_dir):
    """Sync SD keeps speculating within K+1 of max_model_len: the verify's
    positions past the page table get dropped writes instead of an index
    error, and the output is AR's, cut at the limit."""
    prompts = [random_prompt(rng(60), 50, 51)]
    kw = dict(max_model_len=64, num_kvcache_blocks=8)
    want, _ = serve(port(target_dir, **kw), prompts, greedy(40))
    got, _ = serve(port(target_dir, draft=draft_dir, **MODES["sync"], **kw), prompts,
                   greedy(40))
    assert got == want and len(got[0]) == 64 - 50


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_chunked_prefill_with_speculation(mode, target_dir, draft_dir):
    """A prompt admitted in chunks: the target prefills chunk by chunk, the
    draft once at admission; the prompt's full blocks publish their prefix
    hashes in both pools once its KV exists; tokens stay exact."""
    prompts = [random_prompt(rng(44), 70, 71), random_prompt(rng(45), 8, 12)]
    want, _ = serve(port(target_dir), prompts, greedy(12))
    llm = port(target_dir, draft=draft_dir, **MODES[mode], chunked_prefill=True,
               max_num_batched_tokens=32)
    got, _ = serve(llm, prompts, greedy(12))
    assert got == want
    sch = llm.scheduler
    for bm in (sch.block_manager, sch.draft_block_managers[0]):
        assert len(bm.hash_to_block_id) >= 70 // 16


def test_preemption_under_pressure_is_exact(target_dir, draft_dir):
    """Four async-speculating sequences in a pool too small for all of them
    (the draft also holds the tree region, K+1+K*MQ slots a step): the
    scheduler preempts and re-prefills both models, and tokens stay exact."""
    prompts = [random_prompt(rng(300 + i), 16, 24) for i in range(4)]
    want, _ = serve(port(target_dir), prompts, greedy(40))
    llm = port(target_dir, draft=draft_dir, **MODES["async"], max_model_len=128,
               num_kvcache_blocks=16)
    preempted = []
    orig = llm.scheduler.preempt

    def spy(seq):
        preempted.append(seq.seq_id)
        return orig(seq)

    llm.scheduler.preempt = spy
    got, _ = serve(llm, prompts, greedy(40))
    assert got == want
    assert preempted


def test_abort_speculating_sequence(target_dir, draft_dir):
    """Abort a sequence after it has speculated (its tree is in the draft's
    cache): both pools get its blocks back and the survivor stays exact."""
    llm = port(target_dir, draft=draft_dir, **MODES["async"])
    keep = random_prompt(rng(101), 8, 16)
    keep_id = llm.add_request(list(keep), greedy(24))
    kill_id = llm.add_request(list(random_prompt(rng(102), 8, 16)), greedy(24))
    llm.step()   # prefill both
    llm.step()   # one speculative step
    assert llm.abort_request(kill_id) is True
    outs = {}
    for _ in range(100):
        for sid, toks in llm.step():
            outs[sid] = toks
        if llm.is_finished():
            break
    llm.draft_server.drain(timeout=60)   # the last tree build has run
    llm.exit()
    assert not llm.draft_server._thread.is_alive()
    want, _ = serve(port(target_dir), [keep], greedy(24))
    assert outs[keep_id] == want[0]
    assert not llm.scheduler.block_manager.used_block_ids
    assert not llm.scheduler.draft_block_managers[0].used_block_ids


@pytest.mark.parametrize("where", ["build_tree", "prefill_from_payload"])
def test_draft_thread_failure_raises_in_generate(where, target_dir, draft_dir, monkeypatch):
    """An exception in the draft thread, in a tree build or in the draft
    prefill, fails generate() with "draft server died"; nothing swallows
    it."""
    def boom(self, *args, **kwargs):
        raise ValueError("injected draft failure")

    monkeypatch.setattr(dr.DraftRunner, where, boom)
    llm = port(target_dir, draft=draft_dir, **MODES["async"])
    with pytest.raises(RuntimeError, match="draft server died") as err:
        llm.generate([list(PROMPTS[0])], greedy(16), use_tqdm=False)
    assert "injected draft failure" in repr(err.value.__cause__)
    with pytest.raises(RuntimeError, match="draft server died"):
        llm.draft_server.drain(timeout=30)   # a dead thread never drains
    llm.exit()


def test_sampled_async_runs(target_dir, draft_dir):
    """temperature > 0 with sampler_x and a separate draft temperature:
    ratio acceptance on hit rows, valid tokens of the requested length."""
    sp = SamplingParams(temperature=0.8, draft_temperature=0.6, max_new_tokens=24,
                        ignore_eos=True)
    got, m = serve(port(target_dir, draft=draft_dir, **MODES["async"], sampler_x=2.0,
                        seed=3), PROMPTS[:2], sp)
    assert [len(g) for g in got] == [24, 24]
    assert all(0 <= t < 128 for g in got for t in g)
    assert m["cache_hits"]


def _runner(path, blocks=32):
    cfg = Config(path, device="cpu", dtype="float32", kvcache_block_size=16,
                 num_kvcache_blocks=blocks, max_model_len=256)
    return ModelRunner(cfg, is_draft=True)


def _jax_model(path):
    mc = JaxModelConfig.from_pretrained(path)
    return JaxArch.from_model_config(mc), jax_load_params(path, mc, jnp.float32)


def _cache_and_tables(runner, bases, seed):
    """A random draft cache (the trunk's KV) and disjoint page tables that
    cover each sequence's glue and tree region."""
    r = np.random.default_rng(seed)
    cache = r.normal(size=tuple(runner.kv_cache.shape)).astype(np.float32)
    bt = np.full((len(bases), runner.max_blocks), -1, np.int32)
    for b in range(len(bases)):
        bt[b, :6] = np.arange(6 * b, 6 * b + 6) + 1
    return cache, bt


def test_tree_build_step_matches_jax(target_dir):
    """Glue forward, fork selection and the K tree steps against
    ssd_tpu/engine/draft_runner.py::tree_build_program: fork and tree tokens,
    the spec and glue logits, and the draft cache after the build; one hit
    row and one miss row with different fan-out lists."""
    runner = _runner(target_dir)
    jarch, jparams = _jax_model(target_dir)
    bases = np.array([20, 9], np.int64)
    cache, bt = _cache_and_tables(runner, bases, 5)
    glue = np.random.default_rng(6).integers(3, 128, size=(2, K + 1)).astype(np.int64)
    hits = np.array([1, 0], np.int64)
    hit_list, miss_list = [2, 2, 1, 1], [1, 1, 2, 2]
    runner.kv_cache = torch.from_numpy(cache.copy())
    fork, spec, spec_logits, glue_logits = dr.tree_build_step(
        runner.params, runner.kv_cache, torch.from_numpy(glue), bases, bt, hits,
        torch.zeros(2), None, arch=runner.arch, block_size=16, K=K,
        fan_out_list=hit_list, fan_out_list_miss=miss_list, sampler_x=None, F=F)
    host_out, jspec_logits, jglue_logits, jcache = jdr.tree_build_program(
        jparams, jnp.asarray(cache), jnp.asarray(glue.reshape(-1), jnp.int32),
        jnp.asarray(bases, jnp.int32), jnp.asarray(bt), jnp.asarray(hits, jnp.int32),
        jnp.zeros(2, jnp.float32), None, None, jax.random.PRNGKey(0),
        arch=jarch, block_size=16, ctx_pad=runner.max_blocks * 16, K=K,
        MQ_LEN=6, fan_out_list=tuple(hit_list), fan_out_list_miss=tuple(miss_list),
        sampler_x=None, F=F)
    host_out = np.asarray(host_out)
    np.testing.assert_array_equal(fork.numpy(), host_out[:12].reshape(2, 6))
    np.testing.assert_array_equal(spec.numpy(), host_out[12:].reshape(2, 6, K))
    np.testing.assert_allclose(spec_logits.numpy(), np.asarray(jspec_logits), **TOL)
    np.testing.assert_allclose(glue_logits.numpy(), np.asarray(jglue_logits), **TOL)
    np.testing.assert_allclose(runner.kv_cache.numpy(), np.asarray(jcache), **TOL)


@pytest.mark.parametrize("extra_write", [True, False])
def test_chain_matches_jax(extra_write, target_dir):
    """The eager draft chain against ssd_tpu's chain_decode_step: tokens,
    logits and the cache (with and without the K-th token's KV write)."""
    runner = _runner(target_dir)
    jarch, jparams = _jax_model(target_dir)
    start = np.array([20, 9], np.int32)
    cache, bt = _cache_and_tables(runner, start, 7)
    first = np.array([17, 99], np.int64)
    runner.kv_cache = torch.from_numpy(cache.copy())
    toks, logits = runner.run_chain(first, start, bt, np.zeros(2, np.float32), K, extra_write)
    jtoks, jlogits, jcache = jmr.chain_decode_step(
        jparams, jnp.asarray(cache), jnp.asarray(first, jnp.int32), jnp.asarray(start),
        jnp.asarray(bt), jnp.asarray(start + 1), jnp.zeros(2, jnp.float32),
        jax.random.PRNGKey(0), arch=jarch, block_size=16,
        ctx_pad=runner.max_blocks * 16, K=K, extra_write=extra_write)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(runner.kv_cache.numpy(), np.asarray(jcache), **TOL)


def test_spec_config(target_dir, draft_dir):
    """Derived tree geometry, the draft config, and what a speculating
    engine refuses."""
    cfg = Config(target_dir, device="cpu", draft=draft_dir, **MODES["async"],
                 kvcache_block_size=16)
    assert cfg.fan_out_list == cfg.fan_out_list_miss == [F] * (K + 1)
    assert cfg.MQ_LEN == F * (K + 1)
    assert cfg.draft_hf_config.num_hidden_layers == 1
    cfg.num_kvcache_blocks = 40
    d = cfg.create_draft_config()
    assert d.model == draft_dir and d.hf_config.hidden_size == 32
    assert d.num_kvcache_blocks == 40 and d.MQ_LEN == cfg.MQ_LEN
    with pytest.raises(ValueError, match="draft"):
        Config(target_dir, device="cpu", speculate=True)
    with pytest.raises(ValueError, match="2\\*speculate_k\\+2"):
        Config(target_dir, device="cpu", draft=draft_dir, speculate=True,
               speculate_k=8, kvcache_block_size=16)
    with pytest.raises(ValueError, match="draft_async"):
        Config(target_dir, device="cpu", draft=draft_dir, speculate=True,
               speculate_k=2, async_fan_out=2, kvcache_block_size=16)
    with pytest.raises(ValueError, match="MQ_LEN"):
        Config(target_dir, device="cpu", draft=draft_dir, **MODES["async"],
               kvcache_block_size=16, fan_out_list_miss=[1, 1, 1, 1])
