"""ssd_tpu_torch's fused sync EAGLE-3 superstep (use_eagle with
spec_rounds > 1, no draft_async) on the CPU, in fp32, against the JAX
package:

- eagle_sd_superstep against ssd_tpu's on the same seeded caches and
  inputs (R = 2, the plain attention path): speculations, accept_until
  and recoveries exact, the final taps within 1e-5 of their largest
  magnitude (the taps tolerance of test_torch_eagle.py), both KV caches within
  the fused-SD tests' tolerance (rtol = atol = 1e-4): on a random head
  (make_tiny_eagle over make_tiny_llama(layers=6), taps [0, 2, 4]) and on
  the constructed pair of bench.py::build_eagle_checkpoints, which accepts,
  so the taps of rows past the first carry to the next round;
- the engine: greedy tokens equal the port's AR, the port's async EAGLE
  and ssd_tpu's same fused engine, accepted lengths equal ssd_tpu's;
  preemption under a small pool (the carry re-seeded by the prefill)
  equals AR; over the int8 cache it equals the int8 AR;
- the config rules of both packages: sync EAGLE needs spec_rounds > 1 and
  excludes draft_async with spec_rounds > 1; the fused form needs no
  jit_speculate.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.engine import fused_sd as jfsd
from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu.models import eagle3 as je3
from ssd_tpu.models.transformer import Arch as JaxArch
from ssd_tpu.utils.loader import load_eagle_params as jax_load_eagle
from ssd_tpu.utils.loader import load_params as jax_load_params
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.config import Config
from ssd_tpu_torch.engine import fused_sd
from ssd_tpu_torch.engine.eagle_runner import EagleModelRunner
from ssd_tpu_torch.engine.model_runner import ModelRunner
from ssd_tpu_torch.engine.step import EagleFusedSpecDecodeStep
from ssd_tpu_torch.weights import params_from_jax
from tests.torch_cases import eagle_pair
from tests.utils_models import make_tiny_eagle, make_tiny_llama, random_prompt, rng


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker (the HF oracle of the
    JAX package's tests) keeps its own thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


BS, K = 16, 2
CACHE_TOL = dict(rtol=1e-4, atol=1e-4)
TAPS = {"random": [0, 2, 4], "pair": [1, 2, 3]}
ENGINE = dict(dtype="float32", max_model_len=256, max_num_batched_tokens=1024,
              kvcache_block_size=BS, num_kvcache_blocks=96, max_num_seqs=4)
FUSED = dict(speculate=True, use_eagle=True, speculate_k=K)
PAIR_NOISE = 0.08    # the head accepts some steps and misses others


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{"random": (make_tiny_llama(layers=6), make_tiny_eagle), "pair":
    the constructed pair}."""
    t = tmp_path_factory.mktemp("fused_eagle_target")
    e = tmp_path_factory.mktemp("fused_eagle_head")
    make_tiny_llama(t, layers=6, seed=0)
    make_tiny_eagle(e, seed=3)
    return {"random": (str(t), str(e)),
            "pair": eagle_pair(str(tmp_path_factory.mktemp("fused_eagle_pair")), PAIR_NOISE)}


def port(target, **kw):
    return ssd_tpu_torch.LLM(target, device="cpu", **{**ENGINE, **kw})


def serve(llm, prompts, n):
    try:
        outs, m = llm.generate([list(p) for p in prompts],
                               SamplingParams(temperature=0.0, max_new_tokens=n,
                                              ignore_eos=True), use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs], list(m["accepted_suffix_lens_with_recovery"])


# --- the superstep against ssd_tpu's -------------------------------------------


@pytest.mark.parametrize("which", ["random", "pair"])
def test_eagle_sd_superstep_matches_jax(which, models):
    """R = 2 rounds, B = 3 rows over seeded caches and taps; the pair's head
    accepts, the random one mostly not."""
    R = 2
    tdir, edir = models[which]
    taps = TAPS[which]
    cfg = Config(tdir, device="cpu", draft=edir, eagle_layers=taps, kvcache_block_size=BS,
                 num_kvcache_blocks=32, max_model_len=256, dtype="float32",
                 spec_rounds=R, **FUSED)
    t = ModelRunner(cfg)
    d = EagleModelRunner(cfg.create_draft_config())
    r = np.random.default_rng(21)
    t.kv_cache = torch.from_numpy(r.normal(size=tuple(t.kv_cache.shape)).astype(np.float32))
    d.kv_cache = torch.from_numpy(r.normal(size=tuple(d.kv_cache.shape)).astype(np.float32))
    n0 = np.array([20, 9, 33], np.int32)
    rec0 = np.array([17, 99, 5], np.int32)
    acts0 = r.normal(size=(3, d.arch.act_dim)).astype(np.float32)
    bt_t = np.full((3, t.max_blocks), -1, np.int32)
    bt_d = np.full((3, d.max_blocks), -1, np.int32)
    for b, n in enumerate(n0):
        pages = -(-(int(n) + R * (K + 1) + 1) // BS)
        bt_t[b, :pages] = np.arange(pages) + 1 + 8 * b
        bt_d[b, :pages] = np.arange(pages) + 5 + 8 * b
    temps = np.zeros(3, np.float32)
    cache_t0, cache_d0 = t.kv_cache.numpy().copy(), d.kv_cache.numpy().copy()
    tt = torch.from_numpy
    specs, accs, recs, acts = fused_sd.eagle_sd_superstep(
        t.params, t.kv_cache, d.params, d.kv_cache, tt(rec0), tt(acts0), tt(n0), tt(bt_t),
        tt(bt_d), tt(temps), tt(temps), None, None, t_arch=t.arch, d_arch=d.arch,
        block_size=BS, K=K, R=R, eagle_layers=tuple(taps), greedy=True)
    mc = JaxModelConfig.from_pretrained(tdir)
    jt_arch, jt_params = JaxArch.from_model_config(mc), jax_load_params(tdir, mc, jnp.float32)
    emc = JaxModelConfig.from_pretrained(edir)
    emc.rope_theta = mc.rope_theta            # the head takes the target's rope
    jd_arch = je3.EagleArch.from_model_config(emc, mc.hidden_size, len(taps))
    jd_params = jax_load_eagle(edir, emc, mc.hidden_size, len(taps), target_path=tdir,
                               dtype=jnp.float32)
    for k, v in params_from_jax(jax.device_get(jd_params)).items():
        assert torch.equal(v, d.params[k].to(v.dtype)), k
    jspecs, jaccs, jrecs, jacts, jcache_t, jcache_d = jfsd.eagle_sd_superstep(
        jt_params, jnp.asarray(cache_t0), jd_params, jnp.asarray(cache_d0),
        jnp.asarray(rec0), jnp.asarray(acts0), jnp.asarray(n0), jnp.asarray(bt_t),
        jnp.asarray(bt_d), jnp.asarray(temps), jnp.asarray(temps), jax.random.PRNGKey(0),
        t_arch=jt_arch, d_arch=jd_arch, block_size=BS, ctx_pad_t=t.max_blocks * BS,
        ctx_pad_d=d.max_blocks * BS, K=K, R=R, eagle_layers=tuple(taps), use_pallas=False)
    np.testing.assert_array_equal(specs.numpy(), np.asarray(jspecs))
    np.testing.assert_array_equal(accs.numpy(), np.asarray(jaccs))
    np.testing.assert_array_equal(recs.numpy(), np.asarray(jrecs))
    # The taps of the 6-layer model at init scale 0.4 reach |212|: they are
    # held within 1e-5 of their largest magnitude (test_torch_eagle.py's
    # tolerance for taps), where fp32 sums in another order land.
    jacts = np.asarray(jacts)
    assert np.abs(acts.numpy() - jacts).max() <= 1e-5 * np.abs(jacts).max()
    np.testing.assert_allclose(t.kv_cache.numpy(), np.asarray(jcache_t), **CACHE_TOL)
    np.testing.assert_allclose(d.kv_cache.numpy(), np.asarray(jcache_d), **CACHE_TOL)
    assert acts.dtype == torch.float32 and acts.shape == (3, d.arch.act_dim)
    if which == "pair":
        assert accs.numpy().max() > 0, "the pair's head never accepted"


# --- engines ------------------------------------------------------------------------


PROMPTS = [random_prompt(rng(600 + i), 6, 24) for i in range(3)]
N_NEW = 24


@pytest.fixture(scope="module")
def pair_ar(models):
    tdir, _ = models["pair"]
    return serve(port(tdir), PROMPTS, N_NEW)[0]


@pytest.mark.parametrize("R", [2, 4])
def test_fused_eagle_engine_matches_ar_async_and_jax(R, models, pair_ar):
    """On the constructed pair: fused EAGLE's greedy tokens equal the port's
    AR, the port's async EAGLE (R = 2) and ssd_tpu's fused engine, with
    ssd_tpu's accepted lengths."""
    tdir, edir = models["pair"]
    kw = dict(draft=edir, eagle_layers=TAPS["pair"], spec_rounds=R, **FUSED)
    got, lens = serve(port(tdir, **kw), PROMPTS, N_NEW)
    jax_engine = JaxLLM(tdir, **ENGINE, **kw)
    try:
        jouts, jm = jax_engine.generate(
            [list(p) for p in PROMPTS],
            JaxSamplingParams(temperature=0.0, max_new_tokens=N_NEW, ignore_eos=True),
            use_tqdm=False)
    finally:
        jax_engine.exit()
    assert got == pair_ar == [o["token_ids"] for o in jouts]
    assert lens == list(jm["accepted_suffix_lens_with_recovery"])
    assert max(lens) > 1 and min(lens) < K + 1, lens
    if R == 2:
        async_eagle, _ = serve(port(tdir, draft=edir, eagle_layers=TAPS["pair"],
                                    draft_async=True, jit_speculate=True, async_fan_out=2,
                                    **FUSED), PROMPTS, N_NEW)
        assert async_eagle == got


def test_fused_eagle_random_head_matches_jax(models):
    """A random head (mostly rejected): tokens equal AR's and ssd_tpu's fused
    engine's, accepted lengths ssd_tpu's."""
    tdir, edir = models["random"]
    kw = dict(draft=edir, eagle_layers=TAPS["random"], spec_rounds=2, **FUSED)
    prompts = PROMPTS[:2]
    got, lens = serve(port(tdir, **kw), prompts, 16)
    jax_engine = JaxLLM(tdir, **ENGINE, **kw)
    try:
        jouts, jm = jax_engine.generate(
            [list(p) for p in prompts],
            JaxSamplingParams(temperature=0.0, max_new_tokens=16, ignore_eos=True),
            use_tqdm=False)
    finally:
        jax_engine.exit()
    assert got == serve(port(tdir), prompts, 16)[0] == [o["token_ids"] for o in jouts]
    assert lens == list(jm["accepted_suffix_lens_with_recovery"])


def test_fused_eagle_preemption_equals_ar(models, monkeypatch):
    """A pool too small for both sequences: preemption drops the carry, the
    re-prefill seeds it again, and the tokens equal AR's."""
    tdir, edir = models["pair"]
    over = dict(max_model_len=160, num_kvcache_blocks=8, max_num_seqs=2)
    prompts = [random_prompt(rng(650 + i), 16, 24) for i in range(2)]
    prefills = []
    orig = EagleFusedSpecDecodeStep.prefill

    def prefill(self, seqs):
        prefills.append(len(seqs))
        return orig(self, seqs)

    monkeypatch.setattr(EagleFusedSpecDecodeStep, "prefill", prefill)
    want, _ = serve(port(tdir, **over), prompts, 40)
    got, lens = serve(port(tdir, draft=edir, eagle_layers=TAPS["pair"], spec_rounds=2,
                           **FUSED, **over), prompts, 40)
    assert got == want
    assert sum(prefills) > len(prompts), "no sequence was preempted"
    assert max(lens) > 1


def test_fused_eagle_int8_cache_equals_int8_ar(models):
    """Over the int8 KV cache (target and head) fused EAGLE gives the port's
    int8 AR tokens."""
    tdir, edir = models["pair"]
    want, _ = serve(port(tdir, kv_quant="int8"), PROMPTS[:2], 20)
    got, lens = serve(port(tdir, draft=edir, eagle_layers=TAPS["pair"], spec_rounds=2,
                           kv_quant="int8", **FUSED), PROMPTS[:2], 20)
    assert got == want
    assert max(lens) > 1


def test_fused_eagle_config_rules(models):
    """Sync EAGLE at spec_rounds 1 and draft_async with spec_rounds > 1 are
    refused (ValueError) as ssd_tpu refuses them; the fused form takes no
    jit_speculate, and its head's pool has the target's block count."""
    tdir, edir = models["random"]
    base = dict(device="cpu", draft=edir, kvcache_block_size=BS, **FUSED)
    with pytest.raises(ValueError, match="spec_rounds > 1"):
        Config(tdir, **base)
    with pytest.raises(ValueError, match="excludes draft_async"):
        Config(tdir, draft_async=True, jit_speculate=True, spec_rounds=2, **base)
    with pytest.raises(ValueError, match="draft_async"):
        Config(tdir, jit_speculate=True, spec_rounds=2, **base)
    cfg = Config(tdir, spec_rounds=2, num_kvcache_blocks=40, **base)
    assert cfg.eagle_layers == [2, 3, 3] and not cfg.jit_speculate
    llm = port(tdir, draft=edir, spec_rounds=2, **FUSED)
    assert isinstance(llm.draft_runner, EagleModelRunner) and llm.draft_server is None
    assert llm.draft_runner.num_kvcache_blocks == llm.model_runner.num_kvcache_blocks
    assert isinstance(llm.create_inference_step(), EagleFusedSpecDecodeStep)
    llm.exit()
