"""ssd_tpu_torch's EAGLE-3 async SSD against the JAX package on the CPU, in
fp32, stage by stage and end to end:

- the target's taps (forward_hidden with eagle_layers), the EAGLE layer
  (eagle_forward) and its logits (the d2t scatter of a sub-vocab head);
- load_eagle_params (bare keys, borrowed embeddings) and params_from_jax;
- the target's prefill activation rows (the flat layout) against
  ssd_tpu's _run_prefill_group rows, a prefix-cached prompt included;
- the draft's conditioned chain and its glue + fork + tree build against
  eagle_chain_program and eagle_tree_build_program;
- greedy tokens through LLM(...) equal to ssd_tpu's and HF's with the same
  per-step cache hits and accepted lengths: on the constructed pair of
  bench.py::build_eagle_checkpoints (a draft that accepts, with noise so
  steps also miss) and on a random sub-vocab head without embeddings;
- mixed lengths, preemption, a prefix-cache hit and chunked prefill against
  the port's AR, and EAGLE over the int8 cache against the port's int8 AR.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.config import Config as JaxConfig
from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.engine import eagle_runner as jer
from ssd_tpu.engine import model_runner as jmr
from ssd_tpu.engine.sequence import Sequence as JaxSequence
from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu.models import eagle3 as je3
from ssd_tpu.models import transformer as jtf
from ssd_tpu.utils.loader import load_eagle_params as jax_load_eagle
from ssd_tpu.utils.loader import load_params as jax_load_params
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.config import Config, ModelConfig
from ssd_tpu_torch.engine import eagle_runner as er
from ssd_tpu_torch.engine.model_runner import ModelRunner
from ssd_tpu_torch.engine.sequence import Sequence
from ssd_tpu_torch.models import eagle3, transformer
from ssd_tpu_torch.utils.loader import load_eagle_params, load_params
from ssd_tpu_torch.weights import params_from_jax
from tests.utils_models import (
    hf_greedy, make_tiny_eagle, make_tiny_llama, random_prompt, rng)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker (the HF oracle of the
    JAX package's tests) keeps its own thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
TAPS = [0, 2, 4]
K, F = 3, 2
BS = 16
ENGINE = dict(dtype="float32", max_model_len=256, max_num_batched_tokens=1024,
              kvcache_block_size=BS, num_kvcache_blocks=96, max_num_seqs=4)
EAGLE = dict(speculate=True, draft_async=True, use_eagle=True, jit_speculate=True,
             speculate_k=K, async_fan_out=F)
SPEC_KEYS = ("cache_hits", "accepted_suffix_lens_with_recovery",
             "accepted_suffix_lens_on_hit", "accepted_suffix_lens_on_miss")
PAIR_NOISE = 0.08    # the constructed head both hits and misses at this noise


@pytest.fixture(scope="module")
def target_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_eagle_target")
    make_tiny_llama(d, layers=6, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def eagle_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_eagle_draft")
    make_tiny_eagle(d, seed=3)
    return str(d)


@pytest.fixture(scope="module")
def subvocab_dir(tmp_path_factory):
    """A 64-of-128-token head without embeddings (borrowed from the target)."""
    d = tmp_path_factory.mktemp("torch_eagle_subvocab")
    make_tiny_eagle(d, draft_vocab=64, with_embed=False, seed=5)
    return str(d)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """bench.py::build_eagle_checkpoints on a tiny 4-layer config: a target
    of pass-through layers and a head whose logits track the target's, with
    PAIR_NOISE on its projections."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    d = str(tmp_path_factory.mktemp("torch_eagle_pair") / "cfg")
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": 128, "hidden_size": 64,
                   "intermediate_size": 128, "num_hidden_layers": 4,
                   "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
                   "max_position_embeddings": 512, "rms_norm_eps": 1e-5,
                   "rope_theta": 1e4, "tie_word_embeddings": False,
                   "eos_token_id": 2}, f)
    return bench.build_eagle_checkpoints(d, draft_noise=PAIR_NOISE)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


def close_scaled(got, want, rel=1e-5):
    """|got - want| <= rel * max|want| everywhere: fp32 activations of a
    deep tiny model reach ~1e2 (init scale 0.4), and two frameworks' sums
    differ in the last bits of the largest values."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


def greedy(n):
    return SamplingParams(temperature=0.0, max_new_tokens=n, ignore_eos=True)


def serve(llm, prompts, sps):
    try:
        outs, m = llm.generate([list(p) for p in prompts], sps, use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs], {k: list(v) for k, v in m.items()
                                             if isinstance(v, list)}


def port(target, **kw):
    return ssd_tpu_torch.LLM(target, device="cpu", **{**ENGINE, **kw})


def jax_eagle_params(eagle_path, target_path):
    mc = JaxModelConfig.from_pretrained(eagle_path)
    d_t = JaxModelConfig.from_pretrained(target_path).hidden_size
    arch = je3.EagleArch.from_model_config(mc, d_t, len(TAPS))
    return arch, jax_load_eagle(eagle_path, mc, d_t, len(TAPS), target_path=target_path,
                                dtype=jnp.float32)


def port_eagle_arch(eagle_path, target_path):
    d_t = ModelConfig.from_pretrained(target_path).hidden_size
    return eagle3.EagleArch.from_model_config(ModelConfig.from_pretrained(eagle_path), d_t,
                                              len(TAPS))


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def _causal_attn_torch(T, G):
    def call(li, q, k, v):
        s = torch.einsum("thd,shd->hts", q, k.repeat_interleave(G, dim=1)) * q.shape[-1] ** -0.5
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
        return torch.einsum("hts,shd->thd", torch.softmax(s, -1), v.repeat_interleave(G, dim=1))
    return call


def _causal_attn_jax(T, G):
    def call(q, k, v, kv_layer):
        s = jnp.einsum("thd,shd->hts", q, jnp.repeat(k, G, axis=1)) * q.shape[-1] ** -0.5
        s = jnp.where(jnp.triu(jnp.ones((T, T), bool), 1), -jnp.inf, s)
        o = jnp.einsum("hts,shd->thd", jax.nn.softmax(s, -1), jnp.repeat(v, G, axis=1))
        return o, kv_layer
    return call


@pytest.mark.parametrize("taps", [TAPS, [5, 1, 1]])
def test_taps_match_forward_hidden(target_dir, taps):
    """The residual stream entering each tapped layer, concatenated in
    ascending tap order (duplicates repeated), against ssd_tpu's
    forward_hidden acts to 1e-5 of their largest magnitude; and the hidden
    states unchanged by the taps."""
    mc = JaxModelConfig.from_pretrained(target_dir)
    jarch, jparams = jtf.Arch.from_model_config(mc), jax_load_params(target_dir, mc, jnp.float32)
    arch = transformer.Arch.from_model_config(ModelConfig.from_pretrained(target_dir))
    params = load_params(target_dir, ModelConfig.from_pretrained(target_dir), torch.float32,
                         torch.device("cpu"))
    T, G = 11, arch.num_heads // arch.num_kv_heads
    ids = np.random.default_rng(1).integers(3, 128, T)
    pos = np.arange(T)
    hidden, acts = transformer.forward_hidden(params, t(ids), t(pos), _causal_attn_torch(T, G),
                                              arch, tuple(taps))
    jcache = jnp.zeros((arch.num_layers, 1, 1, 1))
    jh, _, jacts = jtf.forward_hidden(jparams, jcache, jnp.asarray(ids), jnp.asarray(pos),
                                      _causal_attn_jax(T, G), jarch, eagle_layers=tuple(taps))
    assert acts.shape == (T, len(taps) * arch.hidden_size)
    close_scaled(acts, jacts)
    close_scaled(hidden, jh)
    plain = transformer.forward_hidden(params, t(ids), t(pos), _causal_attn_torch(T, G), arch)
    assert torch.equal(plain, hidden)


@pytest.mark.parametrize("which", ["full", "subvocab"])
def test_eagle_layer_and_logits_match_jax(which, target_dir, eagle_dir, subvocab_dir):
    """eagle_forward's prenorm (through fc-projected conditioning) and
    eagle_logits, the d2t scatter with -inf off the head's 64 tokens for the
    sub-vocab head, against ssd_tpu/models/eagle3.py on the same weights."""
    path = eagle_dir if which == "full" else subvocab_dir
    jarch, jparams = jax_eagle_params(path, target_dir)
    arch = port_eagle_arch(path, target_dir)
    params = params_from_jax(jax.device_get(jparams))
    T, G = 9, arch.num_heads // arch.num_kv_heads
    r = np.random.default_rng(2)
    ids = r.integers(3, 128, T)
    acts = r.normal(size=(T, arch.act_dim)).astype(np.float32)
    pos = np.arange(T)
    cond = eagle3.project_target_acts(params, t(acts))
    close(cond, je3.project_target_acts(jparams, jnp.asarray(acts)))
    pre = eagle3.eagle_forward(params, t(ids), cond, t(pos), _causal_attn_torch(T, G), arch)
    jpre, _ = je3.eagle_forward(jparams, jnp.zeros((1, 1, 1, 1)), jnp.asarray(ids),
                                je3.project_target_acts(jparams, jnp.asarray(acts)),
                                jnp.asarray(pos), _causal_attn_jax(T, G), jarch)
    close(pre, jpre)
    logits = eagle3.eagle_logits(params, pre, arch)
    jlogits = np.asarray(je3.eagle_logits(jparams, jpre, jarch))
    assert logits.shape == (T, 128)
    finite = np.isfinite(jlogits)
    np.testing.assert_array_equal(torch.isfinite(logits).numpy(), finite)
    close(logits.numpy()[finite], jlogits[finite])
    assert finite.all() == (which == "full")
    if which == "subvocab":
        assert finite.sum(axis=1).tolist() == [64] * T


@pytest.mark.parametrize("which", ["embedded", "borrowed"])
def test_load_eagle_params_and_params_from_jax(which, target_dir, eagle_dir, subvocab_dir):
    """The port's loader against ssd_tpu's, key for key (a head with its own
    embeddings, and one borrowing the target's), and params_from_jax of the
    JAX dict giving the same tensors."""
    path = eagle_dir if which == "embedded" else subvocab_dir
    _, jparams = jax_eagle_params(path, target_dir)
    mc = ModelConfig.from_pretrained(path)
    got = load_eagle_params(path, mc, 64, len(TAPS), torch.float32, torch.device("cpu"),
                            target_path=target_dir)
    conv = params_from_jax(jax.device_get(jparams))
    assert set(got) == set(jparams) == set(conv)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jparams[k]))
        assert torch.equal(got[k], conv[k])
    if which == "borrowed":
        emb = load_params(target_dir, ModelConfig.from_pretrained(target_dir), torch.float32,
                          torch.device("cpu"))["embed"]
        assert torch.equal(got["embed"], emb)
        assert got["d2t"].abs().sum() > 0
    with pytest.raises(ValueError, match="target"):
        load_eagle_params(subvocab_dir, ModelConfig.from_pretrained(subvocab_dir), 64,
                          len(TAPS), torch.float32, torch.device("cpu"))


def test_prefill_acts_rows_match_run_prefill_group(target_dir, eagle_dir):
    """The target's tapped prefill on the flat layout: one [n_i, n_taps*D]
    block per sequence (row t = token t, recomputed from position 0 when
    prefix-cached) against ssd_tpu's grouped _run_prefill_group rows; the
    first tokens too."""
    kw = dict(draft=eagle_dir, speculate=True, draft_async=True, use_eagle=True,
              jit_speculate=True, eagle_layers=TAPS, kvcache_block_size=BS,
              num_kvcache_blocks=48, max_model_len=256, dtype="float32")
    jrunner = jmr.ModelRunner(JaxConfig(target_dir, **kw))
    runner = ModelRunner(Config(target_dir, device="cpu", **kw))
    prompts = [random_prompt(rng(30 + i), n, n + 1) for i, n in enumerate((5, 37, 18))]
    seqs = {}
    for cls, sp in ((Sequence, greedy(1)),
                    (JaxSequence, JaxSamplingParams(temperature=0.0, max_new_tokens=1))):
        cls.block_size = BS
        made = []
        for i, p in enumerate(prompts):
            s = cls(list(p), sp)
            s.block_table = list(range(1 + 4 * i, 1 + 4 * i + -(-len(p) // BS)))
            made.append(s)
        made[1].num_cached_tokens = 16        # a prefix-cache hit: recomputed whole
        seqs[cls] = made
    toks, _, rows = runner.run_prefill(seqs[Sequence], return_acts=True)
    jtoks, jrows = jrunner.run_prefill(seqs[JaxSequence], return_acts=True)
    assert toks == jtoks
    for got, want, p in zip(rows, jrows, prompts):
        assert got.shape == (len(p), len(TAPS) * 64)
        close_scaled(got, want)


def _draft_cache(runner, bases, seed):
    r = np.random.default_rng(seed)
    cache = r.normal(size=tuple(runner.kv_cache.shape)).astype(np.float32)
    bt = np.full((len(bases), runner.max_blocks), -1, np.int32)
    for b in range(len(bases)):
        bt[b, :6] = np.arange(6 * b, 6 * b + 6) + 1
    return cache, bt


def _draft_runner(target_dir, eagle_dir):
    cfg = Config(target_dir, device="cpu", draft=eagle_dir, eagle_layers=TAPS,
                 kvcache_block_size=BS, num_kvcache_blocks=32, max_model_len=256,
                 dtype="float32", **EAGLE)
    return er.EagleDraftRunner(cfg.create_draft_config())


def test_chain_matches_jax(target_dir, eagle_dir):
    """The conditioned chain (fc of the recovery taps, then each step's
    prenorm) against eagle_chain_program: tokens, logits, prenorms, and the
    draft cache."""
    runner = _draft_runner(target_dir, eagle_dir)
    jarch, jparams = jax_eagle_params(eagle_dir, target_dir)
    base = np.array([20, 9], np.int64)
    cache, bt = _draft_cache(runner, base, 7)
    first = np.array([17, 99], np.int64)
    acts = np.random.default_rng(8).normal(size=(2, runner.arch.act_dim)).astype(np.float32)
    runner.kv_cache = t(cache)
    toks, logits, pre = er.eagle_chain_step(
        runner.params, runner.kv_cache, t(first), t(acts), base, bt, torch.zeros(2), None,
        arch=runner.arch, block_size=BS, K=K, sampler_x=None, F=F)
    jtoks, jlogits, jpre, jcache = jer.eagle_chain_program(
        jparams, jnp.asarray(cache), jnp.asarray(first, jnp.int32), jnp.asarray(acts),
        jnp.asarray(base, jnp.int32), jnp.asarray(bt), jnp.zeros(2, jnp.float32),
        jax.random.PRNGKey(0), arch=jarch, block_size=BS, ctx_pad=runner.max_blocks * BS,
        K=K, sampler_x=None, F=F, use_pallas=False)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    close(logits, jlogits, dict(rtol=1e-4, atol=1e-4))
    close(pre, jpre)
    close(runner.kv_cache, jcache)


def test_tree_build_matches_jax(target_dir, eagle_dir):
    """Glue (extend + recovery rows through fc, spec rows on their
    prenorms, padding rows writing nothing), fork and the K tree steps
    against eagle_tree_build_program: fork and tree tokens, spec logits and
    prenorms, the draft cache; a hit row with 2 extend rows and a miss row
    with none."""
    runner = _draft_runner(target_dir, eagle_dir)
    jarch, jparams = jax_eagle_params(eagle_dir, target_dir)
    base = np.array([20, 9], np.int64)
    n_ext = np.array([2, 0], np.int64)
    cache, bt = _draft_cache(runner, base, 5)
    W, A, D = 2 * K + 1, runner.arch.act_dim, runner.arch.hidden_size
    r = np.random.default_rng(6)
    glue = np.zeros((2, W), np.int64)
    fc_acts = np.zeros((2, W, A), np.float32)
    is_fc = np.zeros((2, W), np.int32)
    for b in range(2):
        n = n_ext[b] + 1 + K
        glue[b, :n] = r.integers(3, 128, n)
        fc_acts[b, :n_ext[b] + 1] = r.normal(size=(n_ext[b] + 1, A))
        is_fc[b, :n_ext[b] + 1] = 1
    prev = r.normal(size=(2, K, D)).astype(np.float32)
    hits = np.array([1, 0], np.int64)
    hit_list, miss_list = [2, 2, 1, 1], [1, 1, 2, 2]
    runner.kv_cache = t(cache)
    fork, spec, spec_logits, spec_acts = er.eagle_tree_build_step(
        runner.params, runner.kv_cache, glue, t(fc_acts), t(prev), n_ext, base, bt, hits,
        torch.zeros(2), None, arch=runner.arch, block_size=BS, K=K,
        fan_out_list=hit_list, fan_out_list_miss=miss_list, sampler_x=None, F=F)
    host, jlogits, jacts, jcache = jer.eagle_tree_build_program(
        jparams, jnp.asarray(cache), jnp.asarray(glue, jnp.int32), jnp.asarray(fc_acts),
        jnp.asarray(prev), jnp.asarray(is_fc.astype(bool)), jnp.asarray(n_ext, jnp.int32),
        jnp.asarray(base, jnp.int32), jnp.asarray(bt), jnp.asarray(hits, jnp.int32),
        jnp.zeros(2, jnp.float32), jax.random.PRNGKey(0), arch=jarch, block_size=BS,
        ctx_pad=runner.max_blocks * BS, K=K, MQ_LEN=sum(hit_list), fan_out_list=tuple(hit_list),
        fan_out_list_miss=tuple(miss_list), sampler_x=None, F=F, use_pallas=False)
    host = np.asarray(host)
    mq = sum(hit_list)
    np.testing.assert_array_equal(fork.numpy(), host[:2 * mq].reshape(2, mq))
    np.testing.assert_array_equal(spec.numpy(), host[2 * mq:].reshape(2, mq, K))
    close(spec_logits, jlogits, dict(rtol=1e-4, atol=1e-4))
    close(spec_acts, jacts)
    close(runner.kv_cache, jcache)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def _against_jax(target, draft, prompts, n_new, **kw):
    kw = {**EAGLE, **kw}
    got, m = serve(port(target, draft=draft, **kw), prompts, greedy(n_new))
    jax_engine = JaxLLM(target, draft=draft, **ENGINE, **kw)
    try:
        jouts, jm = jax_engine.generate(
            [list(p) for p in prompts],
            JaxSamplingParams(temperature=0.0, max_new_tokens=n_new, ignore_eos=True),
            use_tqdm=False)
    finally:
        jax_engine.exit()
    assert got == [o["token_ids"] for o in jouts]
    for key in SPEC_KEYS:
        assert m[key] == list(jm[key]), key
    return got, m


def test_constructed_pair_matches_jax_and_hf(pair):
    """The constructed head (noise PAIR_NOISE) both hits and misses the tree
    cache; tokens, hits and accepted lengths equal ssd_tpu's, tokens HF's."""
    tdir, ddir = pair
    prompts = [random_prompt(rng(300 + i), 6, 30) for i in range(3)]
    got, m = _against_jax(tdir, ddir, prompts, 40, eagle_layers=[1, 2, 3])
    assert got == [hf_greedy(tdir, p, 40) for p in prompts]
    hits = m["cache_hits"]
    assert 0 < sum(hits) < len(hits), hits
    assert max(m["accepted_suffix_lens_with_recovery"]) == K + 1


def test_subvocab_borrowed_head_matches_jax_and_hf(target_dir, subvocab_dir):
    """A random 64-token head that borrows the target's embeddings: tokens,
    hits and accepted lengths equal ssd_tpu's (fan-out 8 over 128 tokens so
    some steps hit), tokens HF's."""
    prompts = [random_prompt(rng(200 + i), 6, 16) for i in range(2)]
    got, m = _against_jax(target_dir, subvocab_dir, prompts, 24, eagle_layers=TAPS,
                          async_fan_out=8)
    assert got == [hf_greedy(target_dir, p, 24) for p in prompts]
    assert m["accepted_suffix_lens_with_recovery"]


CASES = {
    # name: (engine overrides, prompts, max_new per prompt)
    "mixed_lengths": (dict(), [random_prompt(rng(960 + i), 4, 40) for i in range(3)],
                      [12, 30, 21]),
    "preemption": (dict(max_model_len=160, num_kvcache_blocks=22, max_num_seqs=2),
                   [random_prompt(rng(950 + i), 16, 24) for i in range(2)], [32, 32]),
    "chunked_prefill": (dict(chunked_prefill=True, max_num_batched_tokens=32),
                        [random_prompt(rng(970), 70, 71), random_prompt(rng(971), 10, 20)],
                        [24, 24]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_serving_cases_equal_ar(case, pair):
    """Mixed lengths (sequences finishing at different steps), preemption
    under a small pool (the conditioning carries dropped and rebuilt), and a
    chunked prefill (the last chunk recomputes the prompt's taps): EAGLE SSD
    tokens equal the port's AR."""
    tdir, ddir = pair
    over, prompts, lens = CASES[case]
    sps = [greedy(n) for n in lens]
    want, _ = serve(port(tdir, **over), prompts, sps)
    got, m = serve(port(tdir, draft=ddir, **EAGLE, eagle_layers=[1, 2, 3], **over),
                   prompts, sps)
    assert got == want
    assert m["accepted_suffix_lens_with_recovery"]


def test_prefix_cache_hit_equal_ar(pair):
    """The same prompt twice on one engine: the second prefill hits the
    prefix cache, recomputes the prompt's taps, and stays equal to AR."""
    tdir, ddir = pair
    prompt = random_prompt(rng(980), 40, 41)       # 2.5 blocks: 2 cached
    want, _ = serve(port(tdir), [prompt], greedy(20))
    llm = port(tdir, draft=ddir, **EAGLE, eagle_layers=[1, 2, 3])
    try:
        first, _ = llm.generate([list(prompt)], greedy(20), use_tqdm=False)
        second, _ = llm.generate([list(prompt)], greedy(20), use_tqdm=False)
    finally:
        llm.exit()
    assert first[0]["token_ids"] == second[0]["token_ids"] == want[0]


def test_taps_reach_the_draft_as_device_tensors(pair, monkeypatch):
    """The target hands its taps to the draft thread as fp32 tensors on its
    own device (no host copy): the prefill's per-sequence rows and each
    request's recovery and extend taps, the verify's rounded to bf16."""
    from ssd_tpu_torch.engine.draft_runner import DraftServer

    tdir, ddir = pair
    seen = {"prefill": [], "spec": []}
    orig_prefill, orig_spec = DraftServer.prefill, DraftServer.speculate

    def prefill(self, ids, bt, acts_list=None):
        seen["prefill"].append(acts_list)
        return orig_prefill(self, ids, bt, acts_list)

    def speculate(self, req):
        seen["spec"].append(req)
        return orig_spec(self, req)

    monkeypatch.setattr(DraftServer, "prefill", prefill)
    monkeypatch.setattr(DraftServer, "speculate", speculate)
    prompts = [random_prompt(rng(995 + i), 6, 30) for i in range(2)]
    llm = port(tdir, draft=ddir, **EAGLE, eagle_layers=[1, 2, 3])
    dev = llm.model_runner.device
    _, m = serve(llm, prompts, greedy(16))
    assert max(m["accepted_suffix_lens_with_recovery"]) > 1      # extend rows occur
    (rows,) = seen["prefill"]
    assert [r.shape[0] for r in rows] == [len(p) for p in prompts]
    assert all(isinstance(r, torch.Tensor) and r.device == dev for r in rows)
    assert len(seen["spec"]) > 2
    for req in seen["spec"]:
        for x in (req.recovery_acts, req.extend_acts):
            assert isinstance(x, torch.Tensor) and x.device == dev and x.dtype == torch.float32
        assert isinstance(req.extend_counts, np.ndarray)
    assert any(r.extend_counts.max() > 0 for r in seen["spec"])
    for req in seen["spec"][1:]:          # after the first verify: bf16-rounded taps
        for x in (req.recovery_acts, req.extend_acts):
            assert torch.equal(x, x.to(torch.bfloat16).float())


@pytest.mark.parametrize("kv_quant", ["int8", "int8_mxu"])
def test_int8_cache_equal_int8_ar(kv_quant, pair):
    """EAGLE over the int8 KV cache (target and head) gives the port's int8
    AR tokens."""
    tdir, ddir = pair
    prompts = [random_prompt(rng(990 + i), 6, 30) for i in range(2)]
    want, _ = serve(port(tdir, kv_quant=kv_quant), prompts, greedy(24))
    got, m = serve(port(tdir, draft=ddir, **EAGLE, eagle_layers=[1, 2, 3],
                        kv_quant=kv_quant), prompts, greedy(24))
    assert got == want
    assert max(m["accepted_suffix_lens_with_recovery"]) > 1


def test_eagle_config_rules(target_dir, eagle_dir):
    """Default taps [2, L//2, L-3], the head takes the target's rope and
    position limit, and the async form needs jit_speculate; the fused sync
    form is not ported."""
    cfg = Config(target_dir, device="cpu", draft=eagle_dir, kvcache_block_size=BS, **EAGLE)
    assert cfg.eagle_layers == [2, 3, 3] and cfg.d_model_target == 64
    dcfg = cfg.create_draft_config()
    assert dcfg.hf_config.rope_theta == cfg.hf_config.rope_theta
    assert dcfg.tokenizer_path == target_dir
    with pytest.raises(ValueError, match="jit_speculate"):
        Config(target_dir, device="cpu", draft=eagle_dir, kvcache_block_size=BS,
               **{**EAGLE, "jit_speculate": False})
    with pytest.raises(NotImplementedError, match="async"):
        Config(target_dir, device="cpu", draft=eagle_dir, kvcache_block_size=BS,
               speculate=True, use_eagle=True, speculate_k=K)
    with pytest.raises(ValueError, match="eagle_layers"):
        Config(target_dir, device="cpu", draft=eagle_dir, kvcache_block_size=BS,
               eagle_layers=[0, 6, 1], **EAGLE)
