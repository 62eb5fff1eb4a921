"""Sampled serving in the port on the CPU, held to the JAX package at the
tiny size in fp32 (checkpoints written without transformers):

- BASELINE.md's gate 2: at temperature 0.7 the per-depth acceptance
  histograms of unfused SSD and the fused exchange (both jit_speculate:
  real draft logits on every row) and of fused SD R=4 equal sync SD's, and
  so do the fused superstep R=4's cache-hit rounds, over >= 300 rounds on a
  draft that is the target plus 5% noise, within tests/test_spec_stats.py's
  tolerance (ssd_tpu_torch.bench.spec_stats.histogram_gate), and the port's
  sync SD histogram equals ssd_tpu's on the same pair and prompts;
- the superstep with the target as its own draft (no jit_speculate): every
  hit round accepts K and every round that accepts nothing is a miss, in
  the port and in ssd_tpu alike. A miss round serves a stale tree row with
  hits 0, so it takes the greedy compare: it accepts only where a stale
  token equals the target's argmax, a few of its rounds;
- top_k=1 at temperature 0.8 gives ssd_tpu's greedy tokens in AR, fused SD,
  async SSD, the fused superstep and EAGLE-3 (tests/test_top_sampling.py);
- preemption under a small pool, token-exact against ssd_tpu, in fused SD
  and in the fused async superstep (tests/test_e2e_pressure.py).
"""

import os

import numpy as np
import pytest
import torch

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.llm import LLM as JaxLLM
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.utils.loader import SafetensorsIndex, save_safetensors
from ssd_tpu_torch.bench.spec_stats import accept_histogram, histogram_gate
from tests.test_torch_tp import tiny_checkpoint
from tests.utils_models import make_tiny_eagle, random_prompt, rng


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


K, F = 3, 2
ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024, kvcache_block_size=16,
              num_kvcache_blocks=192, max_num_seqs=8, dtype="float32")
SPEC = dict(speculate=True, speculate_k=K)
ASYNC = dict(SPEC, draft_async=True, async_fan_out=F)
MODES = {"sd": SPEC, "ssd": dict(ASYNC, jit_speculate=True),
         "fasync1": dict(ASYNC, async_fused=True, jit_speculate=True),
         "fused4": dict(SPEC, spec_rounds=4),
         "fasync4": dict(ASYNC, async_fused=True, jit_speculate=True, spec_rounds=4)}
GATE_PROMPTS = [random_prompt(rng(500 + i), 8, 16) for i in range(8)]
GATE_NEW = 128
TOP1_PROMPTS = [random_prompt(rng(81 + i), 8, 20) for i in range(2)]
PRESSURE_PROMPTS = [random_prompt(rng(600 + i), 16, 24) for i in range(3)]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The tiny target (init scale 0.4, as tests/utils_models.make_tiny_llama's
    initializer range), a draft that is the target with N(0, (0.05 * 0.4)^2)
    added to every projection, and an EAGLE-3 head."""
    t = str(tmp_path_factory.mktemp("sampled_target"))
    tiny_checkpoint(t, seed=0, scale=0.4)
    d = str(tmp_path_factory.mktemp("sampled_draft"))
    src = SafetensorsIndex(t)
    g = torch.Generator().manual_seed(5)
    tensors = {}
    for name in src.names():
        x = src.get(name)
        if name.endswith("_proj.weight"):
            x = x + 0.05 * 0.4 * torch.randn(x.shape, generator=g)
        tensors[name] = x
    save_safetensors(os.path.join(d, "model.safetensors"), tensors)
    with open(os.path.join(t, "config.json")) as f, \
            open(os.path.join(d, "config.json"), "w") as out:
        out.write(f.read())
    e = str(tmp_path_factory.mktemp("sampled_eagle"))
    make_tiny_eagle(e, seed=7)
    return {"target": t, "draft": d, "eagle": e}


def port_run(target, prompts, sp, **kw):
    llm = ssd_tpu_torch.LLM(target, device="cpu", **{**ENGINE, **kw})
    try:
        outs, m = llm.generate([list(p) for p in prompts], sp, use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs], m


def sampled(n, **kw):
    return SamplingParams(temperature=0.7, max_new_tokens=n, ignore_eos=True, **kw)


def histogram(m, hits_only=False):
    lens = m["accepted_suffix_lens_on_hit"] if hits_only else \
        m["accepted_suffix_lens_with_recovery"]
    return accept_histogram(lens, K)


@pytest.fixture(scope="module")
def sd_histogram(ckpts):
    _, m = port_run(ckpts["target"], GATE_PROMPTS, sampled(GATE_NEW), draft=ckpts["draft"],
                    **MODES["sd"])
    h, n = histogram(m)
    assert n >= 300, f"too few SD rounds ({n})"
    assert 0.25 * K <= float((h * np.arange(K + 1)).sum()) <= 0.75 * K, h
    return h, n


def test_sd_histogram_matches_jax_sd(ckpts, sd_histogram):
    """Gate 2's reference itself: the port's sync SD histogram against
    ssd_tpu's sync SD on the same pair and prompts, so an acceptance rule
    the port's modes shared would show here."""
    jax = JaxLLM(ckpts["target"], **ENGINE, draft=ckpts["draft"], **MODES["sd"])
    try:
        _, jm = jax.generate([list(p) for p in GATE_PROMPTS],
                             JaxSamplingParams(temperature=0.7, max_new_tokens=GATE_NEW,
                                               ignore_eos=True), use_tqdm=False)
    finally:
        jax.exit()
    h, n = histogram(jm)
    assert n >= 300, f"too few ssd_tpu SD rounds ({n})"
    g = histogram_gate(*sd_histogram, h, n)
    assert g["ok"], g


@pytest.mark.parametrize("mode", ["ssd", "fasync1", "fused4", "fasync4"])
def test_acceptance_histogram_matches_sd(ckpts, sd_histogram, mode):
    """Gate 2: the mode's per-depth acceptance histogram against sync SD's
    (the superstep's over its cache-hit rounds: a miss round verifies a
    stale tree row, whose proposals were drawn for another context)."""
    _, m = port_run(ckpts["target"], GATE_PROMPTS, sampled(GATE_NEW), draft=ckpts["draft"],
                    **MODES[mode])
    h, n = histogram(m, hits_only=mode == "fasync4")
    assert n >= (100 if mode == "fasync4" else 300), f"too few rounds ({n})"
    g = histogram_gate(*sd_histogram, h, n)
    assert g["ok"], g


def _superstep_rounds(m):
    """(hit rounds, miss rounds) as accepted-token counts."""
    return (np.asarray(m["accepted_suffix_lens_on_hit"]) - 1,
            np.asarray(m["accepted_suffix_lens_on_miss"]) - 1)


def test_self_draft_superstep_hit_and_miss_rounds_as_jax(ckpts):
    """The superstep R=4 with the target as its own draft at temperature
    0.7, in the port and in ssd_tpu: every hit round accepts K (p = q);
    every round that accepts nothing is a miss, so the zero-accept share is
    the share of misses that accept nothing, at most the miss share and
    within 0.05 of it (a stale token equal to the target's argmax is
    accepted by the greedy compare); the two packages' shares agree within
    the gate's tolerance."""
    kw = dict(ASYNC, async_fused=True, spec_rounds=4, draft=ckpts["target"])
    _, m = port_run(ckpts["target"], GATE_PROMPTS[:4], sampled(96), **kw)
    jax = JaxLLM(ckpts["target"], **ENGINE, **kw)
    _, jm = jax.generate([list(p) for p in GATE_PROMPTS[:4]],
                         JaxSamplingParams(temperature=0.7, max_new_tokens=96, ignore_eos=True),
                         use_tqdm=False)
    jax.exit()
    shares = {}
    for name, metrics in (("port", m), ("ssd_tpu", jm)):
        hit, miss = _superstep_rounds(metrics)
        n = len(hit) + len(miss)
        assert len(hit) and len(miss), name
        assert (hit == K).all(), (name, np.bincount(hit, minlength=K + 1))
        zero, miss_share = float((miss == 0).sum()) / n, len(miss) / n
        assert miss_share - 0.05 <= zero <= miss_share, (name, zero, miss_share)
        shares[name] = (zero, miss_share, n)
    zp, _, n_p = shares["port"]
    zj, _, n_j = shares["ssd_tpu"]
    g = histogram_gate([1 - zp, zp], n_p, [1 - zj, zj], n_j)
    assert all(d < t for d, t in zip(g["diff"], g["tol"])), (shares, g)


@pytest.fixture(scope="module")
def jax_greedy(ckpts):
    """ssd_tpu's greedy AR tokens of the top_k=1 and the pressure prompts."""
    jax = JaxLLM(ckpts["target"], **ENGINE)
    out = {}
    for name, prompts, n in (("top1", TOP1_PROMPTS, 20), ("pressure", PRESSURE_PROMPTS, 40)):
        outs, _ = jax.generate([list(p) for p in prompts],
                               JaxSamplingParams(temperature=0.0, max_new_tokens=n,
                                                 ignore_eos=True), use_tqdm=False)
        out[name] = [o["token_ids"] for o in outs]
    return out


TOP1_MODES = {
    "ar": {},
    "fused_sd": dict(SPEC, spec_rounds=2, draft="draft"),
    "async_ssd": dict(ASYNC, draft="draft"),
    "superstep": dict(ASYNC, async_fused=True, spec_rounds=2, draft="draft"),
    "eagle": dict(ASYNC, use_eagle=True, jit_speculate=True, eagle_layers=[0, 1, 1],
                  draft="eagle"),
}


@pytest.mark.parametrize("mode", list(TOP1_MODES))
def test_top_k1_equals_jax_greedy(ckpts, jax_greedy, mode):
    """temperature 0.8 with top_k=1 collapses every law (the draft's, the
    target's and the recovery's) to its argmax, so every mode gives
    ssd_tpu's greedy tokens."""
    kw = dict(TOP1_MODES[mode])
    if "draft" in kw:
        kw["draft"] = ckpts[kw["draft"]]
    sp = SamplingParams(temperature=0.8, top_k=1, max_new_tokens=20, ignore_eos=True)
    got, m = port_run(ckpts["target"], TOP1_PROMPTS, sp, enable_top_sampling=True, **kw)
    assert got == jax_greedy["top1"]
    if mode != "ar":
        assert m["accepted_suffix_lens_with_recovery"]


@pytest.mark.parametrize("mode,blocks", [("fused_sd", 10), ("superstep", 12)])
def test_preemption_under_pressure_equals_jax(ckpts, jax_greedy, mode, blocks):
    """Three sequences of 16-24 prompt and 40 new tokens in a pool too
    small for all of them with their lookahead (fused SD R=3, the
    superstep R=2): the scheduler preempts between supersteps and the
    tokens equal ssd_tpu's."""
    kw = (dict(SPEC, spec_rounds=3) if mode == "fused_sd" else
          dict(ASYNC, async_fused=True, spec_rounds=2))
    llm = ssd_tpu_torch.LLM(ckpts["target"], device="cpu",
                            **{**ENGINE, "max_model_len": 160, "num_kvcache_blocks": blocks,
                               "max_num_seqs": 3}, draft=ckpts["draft"], **kw)
    preempted = []
    orig = llm.scheduler.preempt

    def spy(seq):
        preempted.append(seq.seq_id)
        return orig(seq)

    llm.scheduler.preempt = spy
    try:
        outs, _ = llm.generate([list(p) for p in PRESSURE_PROMPTS],
                               SamplingParams(temperature=0.0, max_new_tokens=40,
                                              ignore_eos=True), use_tqdm=False)
    finally:
        llm.exit()
    assert [o["token_ids"] for o in outs] == jax_greedy["pressure"]
    assert preempted
