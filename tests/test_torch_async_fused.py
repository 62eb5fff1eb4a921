"""The port's fused async SSD (ssd_tpu_torch/engine/async_fused.py) and its
device tree build on the CPU, against the JAX package, in fp32:

- the draft's tree build as a step call (DraftRunner.tree_build_call)
  against ssd_tpu's tree_build_program: fork and greedy tree tokens exact,
  logits and the draft cache within the port's cache tolerance;
- the exchange step against async_exchange_packed and the superstep
  against async_ssd_superstep (R 2 and 4), greedy: speculations,
  accept_until, recoveries and hits exact, both caches within the
  tolerance;
- engines: the exchange and the superstep (R 2, 4) over prompts that
  finish at different lengths give the port's AR tokens, the port's
  unfused async SSD tokens and ssd_tpu's same engine's tokens, cache hits
  and accepted lengths; the superstep over the int8 cache gives the int8
  AR's tokens, and serves a sequence up to the context limit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.engine import async_fused as jaf
from ssd_tpu.engine import draft_runner as jdr
from ssd_tpu.engine.model_runner import pack_i32
from ssd_tpu.engine.model_runner import slot_of as jax_slot_of
from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu.models.transformer import Arch as JaxArch
from ssd_tpu.utils.loader import load_params as jax_load_params
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.config import Config
from ssd_tpu_torch.engine import async_fused as af
from ssd_tpu_torch.engine.draft_runner import DraftRunner
from ssd_tpu_torch.engine.model_runner import ModelRunner
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


# The port's cache tolerance (tests/test_torch_fused_sd.py): reduction order.
CACHE_TOL = dict(rtol=1e-4, atol=1e-4)
BS, K, F = 16, 3, 2
HIT, MISS = [2, 2, 1, 1], [1, 1, 2, 2]    # different lists for hit and miss rows
MQ = sum(HIT)
ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024, kvcache_block_size=BS,
              num_kvcache_blocks=96, max_num_seqs=4, dtype="float32")
PROMPTS = [random_prompt(rng(70 + i), 8, 24) for i in range(3)]
LENS = [8, 21, 32]   # the short ones finish mid-superstep


@pytest.fixture(scope="module")
def target_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("async_fused_target")
    make_tiny_llama(d, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def draft_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("async_fused_draft")
    make_tiny_llama(d, layers=1, hidden=32, intermediate=64, heads=4, kv_heads=2, seed=7)
    return str(d)


# --- the steps against JAX's programs ----------------------------------------------


def _pair(target_dir, draft_dir, seed):
    """A target runner and a draft runner with random caches (the same
    values when the draft is the target itself)."""
    cfg = Config(target_dir, device="cpu", dtype="float32", kvcache_block_size=BS,
                 num_kvcache_blocks=32, max_model_len=256, speculate=True,
                 draft=draft_dir, draft_async=True, speculate_k=K, async_fan_out=F,
                 fan_out_list=HIT, fan_out_list_miss=MISS)
    t = ModelRunner(cfg)
    d = DraftRunner(cfg.create_draft_config())
    r = np.random.default_rng(seed)
    t.kv_cache = torch.from_numpy(r.normal(size=tuple(t.kv_cache.shape)).astype(np.float32))
    d.kv_cache = (t.kv_cache.clone() if draft_dir == target_dir else torch.from_numpy(
        r.normal(size=tuple(d.kv_cache.shape)).astype(np.float32)))
    return t, d


def _jax(runner):
    mc = JaxModelConfig.from_pretrained(runner.config.model)
    return JaxArch.from_model_config(mc), jax_load_params(runner.config.model, mc, jnp.float32)


def _tables(n, R, shift=0):
    """Disjoint tables covering R rounds of verify and the last tree build."""
    bt = np.full((len(n), 16), -1, np.int32)
    for b, nb in enumerate(n):
        pages = -(-(int(nb) + R * (K + 1) + K + 1 + K * MQ) // BS)
        bt[b, :pages] = np.arange(pages) + 1 + 8 * b + shift
    return bt


JAX_GEOM = dict(block_size=BS, K=K, MQ_LEN=MQ, fan_out_list=tuple(HIT),
                fan_out_list_miss=tuple(MISS), sampler_x=None, F=F)


def test_tree_build_call_matches_jax(target_dir, draft_dir):
    """B = 3 in bucket 4 (a ghost row), hit and miss rows: fork and tree
    tokens exact against tree_build_program on the three rows; spec and
    glue logits and the draft cache within the tolerance."""
    _, d = _pair(target_dir, draft_dir, 1)
    jarch, jparams = _jax(d)
    base = np.array([20, 9, 33], np.int64)
    bt = _tables(base, 1)
    glue = np.random.default_rng(2).integers(3, 128, size=(3, K + 1)).astype(np.int64)
    hits = np.array([1, 0, 1], np.int64)
    cache = d.kv_cache.clone()
    tree, spec_logits, glue_logits = d.run_step(*d.tree_build_call(
        4, glue, base, bt, hits, np.zeros(3, np.float32)))
    host_out, jlogits, jglue, jcache = jdr.tree_build_program(
        jparams, jnp.asarray(cache.numpy()), jnp.asarray(glue.reshape(-1), jnp.int32),
        jnp.asarray(base, jnp.int32), jnp.asarray(bt), jnp.asarray(hits, jnp.int32),
        jnp.zeros(3, jnp.float32), None, None, jax.random.PRNGKey(0),
        arch=jarch, ctx_pad=16 * BS, **JAX_GEOM)
    host_out = np.asarray(host_out)
    np.testing.assert_array_equal(tree[:3, :, 0].numpy(), host_out[:3 * MQ].reshape(3, MQ))
    np.testing.assert_array_equal(tree[:3, :, 1:].numpy(),
                                  host_out[3 * MQ:].reshape(3, MQ, K))
    np.testing.assert_allclose(spec_logits[:3 * MQ].numpy(), np.asarray(jlogits), **CACHE_TOL)
    np.testing.assert_allclose(glue_logits[:3].numpy(), np.asarray(jglue), **CACHE_TOL)
    np.testing.assert_allclose(d.kv_cache.numpy(), np.asarray(jcache), **CACHE_TOL)


def test_exchange_step_matches_jax(target_dir, draft_dir):
    """The verify of a served speculation (one hit row, one miss row, q
    logits given) and the next tree build, against async_exchange_packed:
    accept_until, recoveries, fork and tree tokens exact; both caches
    within the tolerance."""
    t, d = _pair(target_dir, draft_dir, 3)
    jt_arch, jt_params = _jax(t)
    jd_arch, jd_params = _jax(d)
    B, Kp1 = 2, K + 1
    n = np.array([24, 13], np.int32)            # tokens incl. the speculation
    r = np.random.default_rng(4)
    spec = r.integers(3, 128, size=(B, Kp1)).astype(np.int32)
    pos = (n[:, None] - Kp1 + np.arange(Kp1)).astype(np.int32)
    bt_t, bt_d = _tables(n, 1), _tables(n, 1, shift=4)
    logits_q = r.normal(size=(B, K, t.arch.vocab_size)).astype(np.float32)
    hits = np.array([1, 0], np.int32)
    temps = np.zeros(B, np.float32)
    caches = [t.kv_cache.clone(), d.kv_cache.clone()]
    packed, spec_logits = af.exchange_step(
        t.params, t.kv_cache, d.params, d.kv_cache, torch.from_numpy(spec.reshape(-1)),
        torch.from_numpy(pos.reshape(-1)), torch.from_numpy(bt_t), torch.from_numpy(n),
        torch.from_numpy(logits_q), torch.zeros(B), torch.zeros(B), torch.from_numpy(hits),
        torch.from_numpy(bt_d), None, None, t_arch=t.arch, d_arch=d.arch, block_size=BS,
        K=K, fan=d.fan, sampler_x=None, F=F, greedy=True, greedy_tree=True)
    slots = np.asarray(jax_slot_of(jnp.asarray(bt_t), jnp.asarray(pos.reshape(-1)),
                                   jnp.repeat(jnp.arange(B), Kp1), BS))
    payload = pack_i32(spec, pos, slots, bt_t, n, temps, temps, hits, np.int32([0]),
                       bt_d, np.int32([1]))
    out, jlogits, _, jt_cache, jd_cache = jaf.async_exchange_packed(
        jt_params, jnp.asarray(caches[0].numpy()), jd_params, jnp.asarray(caches[1].numpy()),
        jnp.asarray(logits_q), jnp.asarray(payload), t_arch=jt_arch, d_arch=jd_arch,
        ctx_pad_t=16 * BS, ctx_pad_d=16 * BS, B_pad=B, M_t=16, M_d=16, **JAX_GEOM)
    out = np.asarray(out)
    got = packed.numpy()
    np.testing.assert_array_equal(got[:, 0], out[:B])
    np.testing.assert_array_equal(got[:, 1], out[B:2 * B])
    tree = got[:, 2:].reshape(B, MQ, Kp1)
    np.testing.assert_array_equal(tree[..., 0], out[2 * B:2 * B + B * MQ].reshape(B, MQ))
    np.testing.assert_array_equal(tree[..., 1:], out[2 * B + B * MQ:].reshape(B, MQ, K))
    np.testing.assert_allclose(spec_logits.numpy(), np.asarray(jlogits), **CACHE_TOL)
    np.testing.assert_allclose(t.kv_cache.numpy(), np.asarray(jt_cache), **CACHE_TOL)
    np.testing.assert_allclose(d.kv_cache.numpy(), np.asarray(jd_cache), **CACHE_TOL)


@pytest.mark.parametrize("R,draft", [(2, "small"), (4, "self")])
def test_superstep_matches_jax(R, draft, target_dir, draft_dir):
    """R rounds against async_ssd_superstep: with the one-layer draft the
    rounds mostly miss; with the target as its own draft (same cache) they
    hit and accept. Speculations, accept_until, recoveries and hits exact;
    both caches within the tolerance."""
    t, d = _pair(target_dir, target_dir if draft == "self" else draft_dir, 5)
    jt_arch, jt_params = _jax(t)
    jd_arch, jd_params = _jax(d)
    n0 = np.array([20, 9, 33], np.int32)
    rec0 = np.array([17, 99, 5], np.int32)
    # The self-draft reads the same trunk as the target: the same tables
    # into its copy of the cache.
    bt_t, bt_d = _tables(n0, R), _tables(n0, R, shift=0 if draft == "self" else 4)
    temps = np.zeros(3, np.float32)
    caches = [t.kv_cache.clone(), d.kv_cache.clone()]
    got = af.async_ssd_superstep(
        t.params, t.kv_cache, d.params, d.kv_cache, torch.from_numpy(rec0),
        torch.from_numpy(n0), torch.from_numpy(bt_t), torch.from_numpy(bt_d),
        torch.zeros(3), torch.zeros(3), None, None, t_arch=t.arch, d_arch=d.arch,
        block_size=BS, K=K, R=R, fan=d.fan, sampler_x=None, F=F, greedy=True).numpy()
    specs, accs, recs, hits, jt_cache, jd_cache = jaf.async_ssd_superstep(
        jt_params, jnp.asarray(caches[0].numpy()), jd_params, jnp.asarray(caches[1].numpy()),
        jnp.asarray(rec0), jnp.asarray(n0), jnp.asarray(bt_t), jnp.asarray(bt_d),
        jnp.asarray(temps), jnp.asarray(temps), jax.random.PRNGKey(0), t_arch=jt_arch,
        d_arch=jd_arch, ctx_pad_t=16 * BS, ctx_pad_d=16 * BS, R=R, **JAX_GEOM)
    np.testing.assert_array_equal(got[..., :K + 1], np.asarray(specs))
    np.testing.assert_array_equal(got[..., K + 1], np.asarray(accs))
    np.testing.assert_array_equal(got[..., K + 2], np.asarray(recs))
    np.testing.assert_array_equal(got[..., K + 3], np.asarray(hits))
    if draft == "self":
        assert got[1:, :, K + 3].all() and (got[..., K + 1] == K).any()
    np.testing.assert_allclose(t.kv_cache.numpy(), np.asarray(jt_cache), **CACHE_TOL)
    np.testing.assert_allclose(d.kv_cache.numpy(), np.asarray(jd_cache), **CACHE_TOL)


# --- engines -----------------------------------------------------------------------

FUSED = dict(speculate=True, speculate_k=K, draft_async=True, async_fan_out=F)
FORMS = {"exchange": dict(async_fused=True), "superstep_r2": dict(async_fused=True, spec_rounds=2),
         "superstep_r4": dict(async_fused=True, spec_rounds=4)}
SPEC_KEYS = ("cache_hits", "accepted_suffix_lens_with_recovery",
             "accepted_suffix_lens_on_hit", "accepted_suffix_lens_on_miss")


def _sps(cls):
    return [cls(temperature=0.0, max_new_tokens=n, ignore_eos=True) for n in LENS]


def serve(llm, cls=SamplingParams):
    try:
        outs, m = llm.generate([list(p) for p in PROMPTS], _sps(cls), use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs], {k: list(m[k]) for k in SPEC_KEYS}


@pytest.fixture(scope="module")
def reference(target_dir):
    """The port's AR tokens and its unfused async SSD's (the target drafts
    for itself, so the trees hit and accept)."""
    ar, _ = serve(ssd_tpu_torch.LLM(target_dir, device="cpu", **ENGINE))
    unfused, _ = serve(ssd_tpu_torch.LLM(target_dir, device="cpu", draft=target_dir,
                                         **ENGINE, **FUSED))
    assert unfused == ar
    return ar


@pytest.mark.parametrize("form", list(FORMS))
def test_fused_forms_match_ar_unfused_and_jax(form, target_dir, reference):
    got, m = serve(ssd_tpu_torch.LLM(target_dir, device="cpu", draft=target_dir,
                                     **ENGINE, **FUSED, **FORMS[form]))
    assert got == reference
    jgot, jm = serve(JaxLLM(target_dir, draft=target_dir, **ENGINE, **FUSED, **FORMS[form]),
                     JaxSamplingParams)
    assert got == jgot
    for k in SPEC_KEYS:
        assert m[k] == jm[k], k
    assert m["cache_hits"] and max(m["accepted_suffix_lens_with_recovery"]) == K + 1


def test_fused_superstep_on_int8_cache_matches_int8_ar(target_dir, draft_dir):
    cache = dict(kv_quant="int8")
    ar, _ = serve(ssd_tpu_torch.LLM(target_dir, device="cpu", **ENGINE, **cache))
    got, m = serve(ssd_tpu_torch.LLM(target_dir, device="cpu", draft=draft_dir, **ENGINE,
                                     **cache, **FUSED, async_fused=True, spec_rounds=2))
    assert got == ar and m["cache_hits"]


def test_fused_superstep_generates_to_context_limit(target_dir, draft_dir):
    """The superstep serves a sequence up to max_model_len, not stopping a
    superstep's lookahead early (ssd_tpu's test_edge_cases template), and
    its tokens are AR's."""
    engine = dict(ENGINE, max_model_len=64, max_num_seqs=2)
    prompt = random_prompt(rng(903), 20, 24)
    sp = SamplingParams(temperature=0.0, max_new_tokens=100, ignore_eos=True)

    def gen(llm):
        try:
            return llm.generate([list(prompt)], sp, use_tqdm=False)[0][0]["token_ids"]
        finally:
            llm.exit()

    got = gen(ssd_tpu_torch.LLM(target_dir, device="cpu", draft=draft_dir, **engine, **FUSED,
                                async_fused=True, spec_rounds=4))
    assert len(got) == 64 - len(prompt)
    assert got == gen(ssd_tpu_torch.LLM(target_dir, device="cpu", **engine))

