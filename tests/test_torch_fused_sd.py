"""ssd_tpu_torch's fused sync SD (spec_rounds > 1) and ngram speculation on
the CPU, against the JAX package:

- ngram_propose against ssd_tpu's on seeded histories: exact integers;
- sd_superstep and ngram_superstep against ssd_tpu's on the same caches
  and inputs: speculations, accept_until and recoveries exact, both KV
  caches within the port's cache tolerance, 1e-4 absolute plus 1e-4
  relative (test_torch_spec_engine.py; fp32: the second layer's new K/V
  reach |12| and differ from JAX's by up to 1.8e-5);
- the engines' greedy tokens: fused SD at R in {2, 4} equal the port's
  unfused SD and ssd_tpu's fused SD; ngram equals the port's AR and
  ssd_tpu's ngram engine, accepted lengths included, and on a model that
  loops it accepts; fused SD over the int8 cache equals the int8 AR.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.engine import fused_sd as jfsd
from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu.models.transformer import Arch as JaxArch
from ssd_tpu.utils.loader import load_params as jax_load_params
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.engine import fused_sd
from ssd_tpu_torch.engine.model_runner import ModelRunner
from ssd_tpu_torch.config import Config
from tests.utils_models import make_tiny_llama, random_prompt, rng


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker (the HF oracle of the
    JAX package's tests) keeps its own thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024, kvcache_block_size=16,
              num_kvcache_blocks=96, max_num_seqs=4, dtype="float32")
K = 3
N_NEW = 24
PROMPTS = [random_prompt(rng(40 + i), 8, 24) for i in range(3)]
BS = 16
CACHE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def target_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fused_target")
    make_tiny_llama(d, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def draft_dir(tmp_path_factory):
    """A one-layer draft of the target's seed: it accepts often."""
    d = tmp_path_factory.mktemp("fused_draft")
    make_tiny_llama(d, layers=1, seed=0)
    return str(d)


def port(path, **kw):
    return ssd_tpu_torch.LLM(path, device="cpu", **{**ENGINE, **kw})


def serve(llm, prompts=PROMPTS, n=N_NEW):
    outs, m = llm.generate([list(p) for p in prompts],
                           SamplingParams(temperature=0.0, max_new_tokens=n, ignore_eos=True),
                           use_tqdm=False)
    return [o["token_ids"] for o in outs], list(m["accepted_suffix_lens_with_recovery"])


def jax_serve(path, prompts=PROMPTS, n=N_NEW, **kw):
    outs, m = JaxLLM(path, **ENGINE, **kw).generate(
        [list(p) for p in prompts],
        JaxSamplingParams(temperature=0.0, max_new_tokens=n, ignore_eos=True),
        use_tqdm=False)
    return [o["token_ids"] for o in outs], list(m["accepted_suffix_lens_with_recovery"])


# --- the matcher ---------------------------------------------------------------


@pytest.mark.parametrize("N", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_ngram_propose_matches_jax(N, seed):
    """Histories over a 5-token vocabulary (so the last N tokens recur), with
    junk past n, committed lengths below N, near H and in between."""
    r = np.random.default_rng(seed)
    B, H = 6, 48
    hist = r.integers(0, 5, size=(B, H)).astype(np.int32)
    n = np.array([0, N - 1, N, 17, H - 2, H - 1], np.int32)
    rec = hist[np.arange(B), n]
    got = fused_sd.ngram_propose(torch.from_numpy(hist), torch.from_numpy(n),
                                 torch.from_numpy(rec), N=N, K=4)
    want = jfsd.ngram_propose(jnp.asarray(hist), jnp.asarray(n), jnp.asarray(rec), N=N, K=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the supersteps against ssd_tpu's --------------------------------------------


def _runner(path, seed):
    """A CPU runner with a random cache (the trunk's KV)."""
    cfg = Config(path, device="cpu", dtype="float32", kvcache_block_size=BS,
                 num_kvcache_blocks=32, max_model_len=256)
    runner = ModelRunner(cfg)
    runner.kv_cache = torch.from_numpy(
        np.random.default_rng(seed).normal(size=tuple(runner.kv_cache.shape)).astype(np.float32))
    return runner


def _jax_model(path):
    mc = JaxModelConfig.from_pretrained(path)
    return JaxArch.from_model_config(mc), jax_load_params(path, mc, jnp.float32)


def _tables(runner, n0, R, shift=0):
    """Disjoint page tables covering each row's trunk and R rounds."""
    bt = np.full((len(n0), runner.max_blocks), -1, np.int32)
    for b, n in enumerate(n0):
        pages = -(-(int(n) + R * (K + 1) + 1) // BS)
        bt[b, :pages] = np.arange(pages) + 1 + 8 * b + shift
    return bt


@pytest.mark.parametrize("draft", ["self", "tiny"])
def test_sd_superstep_matches_jax(draft, target_dir, draft_dir):
    """R = 3 rounds, B = 3: the self-draft (the target and a copy of its
    cache) accepts every token, the one-layer draft some."""
    R = 3
    t = _runner(target_dir, 1)
    d = _runner(target_dir if draft == "self" else draft_dir, 2)
    if draft == "self":
        d.kv_cache = t.kv_cache.clone()
    n0 = np.array([20, 9, 33], np.int32)
    rec0 = np.array([17, 99, 5], np.int32)
    bt_t, bt_d = _tables(t, n0, R), _tables(d, n0, R, shift=0 if draft == "self" else 4)
    temps = np.zeros(3, np.float32)
    cache_t0, cache_d0 = t.kv_cache.numpy().copy(), d.kv_cache.numpy().copy()
    tt = torch.from_numpy
    specs, accs, recs = fused_sd.sd_superstep(
        t.params, t.kv_cache, d.params, d.kv_cache, tt(rec0), tt(n0), tt(bt_t), tt(bt_d),
        tt(temps), tt(temps), None, None, t_arch=t.arch, d_arch=d.arch, block_size=BS,
        K=K, R=R, greedy=True)
    jt_arch, jt_params = _jax_model(target_dir)
    jd_arch, jd_params = _jax_model(target_dir if draft == "self" else draft_dir)
    jspecs, jaccs, jrecs, jcache_t, jcache_d = jfsd.sd_superstep(
        jt_params, jnp.asarray(cache_t0), jd_params, jnp.asarray(cache_d0),
        jnp.asarray(rec0), jnp.asarray(n0), jnp.asarray(bt_t), jnp.asarray(bt_d),
        jnp.asarray(temps), jnp.asarray(temps), jax.random.PRNGKey(0),
        t_arch=jt_arch, d_arch=jd_arch, block_size=BS, ctx_pad_t=t.max_blocks * BS,
        ctx_pad_d=d.max_blocks * BS, K=K, R=R)
    np.testing.assert_array_equal(specs.numpy(), np.asarray(jspecs))
    np.testing.assert_array_equal(accs.numpy(), np.asarray(jaccs))
    np.testing.assert_array_equal(recs.numpy(), np.asarray(jrecs))
    np.testing.assert_allclose(t.kv_cache.numpy(), np.asarray(jcache_t), **CACHE_TOL)
    np.testing.assert_allclose(d.kv_cache.numpy(), np.asarray(jcache_d), **CACHE_TOL)
    if draft == "self":
        assert (accs.numpy() == K).all()


def test_ngram_superstep_matches_jax(target_dir):
    """R = 3 rounds, N = 2, B = 3 over histories that repeat (the matcher
    proposes continuations) and one that does not."""
    R, N = 3, 2
    t = _runner(target_dir, 3)
    n0 = np.array([20, 9, 33], np.int32)
    H = fused_sd.ngram_width(t, K, R)
    r = np.random.default_rng(4)
    hist = np.zeros((3, H), np.int32)
    hist[0, :20] = np.tile([7, 8, 9, 10, 11], 4)
    hist[1, :9] = r.integers(3, 128, size=9)
    hist[2, :33] = np.tile(r.integers(3, 128, size=11), 3)
    rec0 = hist[np.arange(3), n0 - 5].copy()
    bt = _tables(t, n0, R)
    temps = np.zeros(3, np.float32)
    cache0 = t.kv_cache.numpy().copy()
    tt = torch.from_numpy
    specs, accs, recs = fused_sd.ngram_superstep(
        t.params, t.kv_cache, tt(hist), tt(rec0), tt(n0), tt(bt), tt(temps), None,
        t_arch=t.arch, block_size=BS, N=N, K=K, R=R, greedy=True)
    jarch, jparams = _jax_model(target_dir)
    jspecs, jaccs, jrecs, jcache = jfsd.ngram_superstep(
        jparams, jnp.asarray(cache0), jnp.asarray(hist), jnp.asarray(rec0), jnp.asarray(n0),
        jnp.asarray(bt), jnp.asarray(temps), jax.random.PRNGKey(0), t_arch=jarch,
        block_size=BS, ctx_pad=H, N=N, K=K, R=R)
    np.testing.assert_array_equal(specs.numpy(), np.asarray(jspecs))
    np.testing.assert_array_equal(accs.numpy(), np.asarray(jaccs))
    np.testing.assert_array_equal(recs.numpy(), np.asarray(jrecs))
    np.testing.assert_allclose(t.kv_cache.numpy(), np.asarray(jcache), **CACHE_TOL)
    # The repeating rows propose from their history, not the fallback.
    assert (specs.numpy()[0, 0, 1:] != rec0[0]).any()


# --- engines ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def unfused(target_dir, draft_dir):
    """The port's unfused sync SD and AR tokens."""
    sd, _ = serve(port(target_dir, draft=draft_dir, speculate=True, speculate_k=K))
    ar, _ = serve(port(target_dir))
    assert sd == ar
    return sd


@pytest.mark.parametrize("R", [2, 4])
def test_fused_sd_engine_matches_unfused_and_jax(R, target_dir, draft_dir, unfused):
    kw = dict(draft=draft_dir, speculate=True, speculate_k=K, spec_rounds=R)
    got, lens = serve(port(target_dir, **kw))
    want, jlens = jax_serve(target_dir, **kw)
    assert got == unfused == want
    assert lens == jlens
    assert max(lens) > 1, "the draft never accepted"


def test_ngram_engine_matches_ar_and_jax(target_dir, unfused):
    kw = dict(ngram_speculate=True, speculate_k=K, spec_rounds=2, ngram_n=2)
    got, lens = serve(port(target_dir, **kw))
    want, jlens = jax_serve(target_dir, **kw)
    assert got == unfused == want
    assert lens == jlens


def test_ngram_engine_accepts_on_a_looping_model(tmp_path):
    """A weak-init model falls into a short cycle; once it has been emitted,
    the matcher locks on (mean accepted + 1 well above 1) and the tokens
    still equal AR's."""
    from safetensors.numpy import load_file, save_file

    d = str(tmp_path / "weak")
    make_tiny_llama(d, seed=1, vocab=64)
    f = os.path.join(d, "model.safetensors")
    save_file({k: (v * 0.05).astype(v.dtype) if v.ndim == 2 else v
               for k, v in load_file(f).items()}, f)
    prompt = [[5, 9, 13, 21, 34, 2, 44, 61]]
    ar, _ = serve(port(d), prompt, 48)
    got, lens = serve(port(d, ngram_speculate=True, speculate_k=4, spec_rounds=4,
                           ngram_n=2), prompt, 48)
    assert got == ar
    assert float(np.mean(lens)) > 1.5, lens


def test_fused_sd_int8_cache_matches_int8_ar(target_dir, draft_dir):
    """Over the int8 cache (target and draft) fused SD equals the int8 AR."""
    ar, _ = serve(port(target_dir, kv_quant="int8"))
    got, _ = serve(port(target_dir, draft=draft_dir, speculate=True, speculate_k=K,
                        spec_rounds=2, kv_quant="int8"))
    assert got == ar
