"""A reduced-vocabulary draft (FR-Spec style: the draft's LM head scores a
subset of the vocabulary, `d2t` maps its rows to token ids) through the
port, against the JAX package on the pair of tests/test_draft_vocab.py: a
tiny untied Llama (V 128) whose head rows in a 48-token subset are scaled
4x, and the same model with its head cut to those 48 rows plus d2t. The
checkpoints are written without transformers.

- compute_logits on the reduced head (fp32, bf16 and int8 heads) equals
  ssd_tpu's within 1e-6, -inf outside the subset;
- the loader reads d2t as ssd_tpu's does (and refuses what it refuses);
  params_from_jax carries the map across;
- sync SD (K 3), fused SD (4 rounds) and async SSD with the reduced draft
  give the port's AR tokens and ssd_tpu's same engine's (fp32, exact);
- the same draft at tp 2 over gloo (its 48 head rows split over the ranks)
  gives the port's tp-1 tokens.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu.models.transformer import Arch as JaxArch, compute_logits as jax_compute_logits
from ssd_tpu.utils.loader import load_params as jax_load_params
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.config import ModelConfig
from ssd_tpu_torch.models.transformer import Arch, compute_logits, set_reduced_head
from ssd_tpu_torch.utils.loader import SafetensorsIndex, load_params, save_safetensors
from ssd_tpu_torch.utils.quant import quantize_leaf
from ssd_tpu_torch.weights import params_from_jax
from tests.test_torch_tp import tiny_checkpoint
from tests.utils_models import random_prompt, rng

VOCAB, SUBSET = 128, 48
ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024, kvcache_block_size=16,
              num_kvcache_blocks=64, max_num_seqs=4, dtype="float32")
PROMPTS = [random_prompt(rng(21 + i), 8, 24, vocab=VOCAB) for i in range(2)]
GREEDY = dict(temperature=0.0, max_new_tokens=24, ignore_eos=True)
MODES = {
    "sd": dict(speculate=True, speculate_k=3),
    "fused_sd": dict(speculate=True, speculate_k=3, spec_rounds=4),
    "ssd": dict(speculate=True, speculate_k=3, draft_async=True, async_fan_out=2),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def subset() -> np.ndarray:
    """A non-contiguous subset, so the d2t offsets are non-trivial."""
    return np.sort(np.random.default_rng(5).permutation(VOCAB)[:SUBSET])


def write_pair(root: str) -> tuple[str, str]:
    """The target (head rows of the subset scaled 4x) and its reduced draft
    under root; returns (target dir, draft dir)."""
    target, draft = os.path.join(root, "target"), os.path.join(root, "draft")
    os.makedirs(target)
    os.makedirs(draft)
    tiny_checkpoint(target, seed=3, scale=0.1)
    index = SafetensorsIndex(target)
    t = {name: index.get(name) for name in index.names()}
    sub = subset()
    t["lm_head.weight"][sub] *= 4.0
    save_safetensors(os.path.join(target, "model.safetensors"), t)
    t["lm_head.weight"] = t["lm_head.weight"][sub].contiguous()
    t["d2t"] = torch.from_numpy((sub - np.arange(SUBSET)).astype(np.int32))
    save_safetensors(os.path.join(draft, "model.safetensors"), t)
    with open(os.path.join(target, "config.json")) as f, \
            open(os.path.join(draft, "config.json"), "w") as g:
        g.write(f.read())
    return target, draft


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return write_pair(str(tmp_path_factory.mktemp("draft_vocab")))


def port_tokens(target, **kw):
    llm = ssd_tpu_torch.LLM(target, device="cpu", **ENGINE, **kw)
    try:
        outs, metrics = llm.generate([list(p) for p in PROMPTS], SamplingParams(**GREEDY),
                                     use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs], metrics


@pytest.fixture(scope="module")
def ar_tokens(pair):
    return port_tokens(pair[0])[0]


@pytest.mark.parametrize("head", ["float32", "bfloat16", "int8"])
def test_reduced_head_logits_equal_jax(head):
    """Final norm, the [Vd, D] head (N(0, 0.1) weights, the scale of the
    pair's head) and the scatter into [T, V]: within 1e-6 of ssd_tpu's
    compute_logits on the same hidden states, and -inf at every token
    outside the subset."""
    r = np.random.default_rng(0)
    D, T = 64, 5
    hidden = r.normal(size=(T, D)).astype(np.float32)
    ln = (1 + 0.1 * r.normal(size=D)).astype(np.float32)
    w = torch.from_numpy((0.1 * r.normal(size=(SUBSET, D))).astype(np.float32))
    sub = subset()
    d2t = (sub - np.arange(SUBSET)).astype(np.int32)
    if head == "int8":
        q = quantize_leaf("lm_head", w)
        port = {"lm_head": q["lm_head"], "lm_head_scale": q["lm_head_scale"]}
        jhead = {"lm_head": jnp.asarray(q["lm_head"].numpy()),
                 "lm_head_scale": jnp.asarray(q["lm_head_scale"].numpy())}
    else:
        w = w.to(getattr(torch, head))
        port = {"lm_head": w}
        jhead = {"lm_head": jnp.asarray(w.float().numpy()).astype(getattr(jnp, head))}
    port["final_ln"] = torch.from_numpy(ln)
    set_reduced_head(port, torch.from_numpy(d2t))
    arch = Arch(vocab_size=VOCAB, hidden_size=D, intermediate_size=128, num_layers=1,
                num_heads=4, num_kv_heads=2, head_dim=16, rms_norm_eps=1e-5,
                rope_theta=1e4, use_qk_norm=False, tie_embeddings=False,
                head_vocab=SUBSET)
    got = compute_logits(port, torch.from_numpy(hidden), arch).numpy()
    jarch = JaxArch(vocab_size=VOCAB, hidden_size=D, intermediate_size=128, num_layers=1,
                    num_heads=4, num_kv_heads=2, head_dim=16, rms_norm_eps=1e-5,
                    rope_theta=1e4, use_qk_norm=False, tie_embeddings=False)
    want = np.asarray(jax_compute_logits(
        {"final_ln": jnp.asarray(ln), "d2t": jnp.asarray(d2t), **jhead},
        jnp.asarray(hidden), jarch))
    assert got.shape == (T, VOCAB)
    mask = np.zeros(VOCAB, bool)
    mask[sub] = True
    np.testing.assert_allclose(got[:, mask], want[:, mask], rtol=1e-6, atol=1e-6)
    assert np.isneginf(got[:, ~mask]).all() and np.isneginf(want[:, ~mask]).all()


def test_loader_reads_d2t_as_jax(pair, tmp_path):
    """The port's loader and params_from_jax of ssd_tpu's loaded tree give
    the same head, d2t and head ids; a d2t without an explicit head, or of
    another length than the head's rows, is refused."""
    draft = pair[1]
    mc = ModelConfig.from_pretrained(draft)
    got = load_params(draft, mc, torch.float32, torch.device("cpu"))
    jtree = jax_load_params(draft, JaxModelConfig.from_pretrained(draft), jnp.float32)
    want = params_from_jax({k: np.asarray(v) if k != "layers" else
                            {n: np.asarray(x) for n, x in v.items()} for k, v in jtree.items()})
    sub = subset()
    assert got["lm_head"].shape == (SUBSET, 64)
    for k in ("lm_head", "d2t", "head_ids"):
        assert torch.equal(got[k], want[k]), k
    assert got["d2t"].dtype == torch.int64 and torch.equal(got["head_ids"], torch.from_numpy(sub))
    index = SafetensorsIndex(draft)
    t = {name: index.get(name) for name in index.names()}
    for name, bad, msg in (("no_head", "lm_head.weight", "untied explicit lm_head"),
                           ("short", None, "lm_head rows")):
        d = tmp_path / name
        d.mkdir()
        bad_t = {k: v for k, v in t.items() if k != bad}
        if bad is None:
            bad_t["d2t"] = t["d2t"][:-1]
        save_safetensors(str(d / "model.safetensors"), bad_t)
        with pytest.raises(ValueError, match=msg):
            load_params(str(d), mc, torch.float32, torch.device("cpu"))


@pytest.mark.parametrize("mode", list(MODES))
def test_reduced_draft_modes_equal_ar_and_jax(pair, ar_tokens, mode):
    """Greedy fp32 tokens with the reduced draft equal the port's AR and
    ssd_tpu's same engine; the draft accepts (the subset covers most of the
    target's emissions)."""
    target, draft = pair
    got, metrics = port_tokens(target, draft=draft, **MODES[mode])
    assert got == ar_tokens
    lens = metrics["accepted_suffix_lens_with_recovery"] or metrics["sd_superstep_times"]
    assert lens
    jllm = JaxLLM(target, draft=draft, **ENGINE, **MODES[mode])
    outs, _ = jllm.generate([list(p) for p in PROMPTS], JaxSamplingParams(**GREEDY),
                            use_tqdm=False)
    if mode == "ssd":
        jllm.exit()
    assert [o["token_ids"] for o in outs] == got


def test_reduced_draft_tp2_sync_sd(pair, ar_tokens):
    """tp 2 over gloo: each rank holds 24 of the draft's 48 head rows and
    the whole map; sync SD gives the port's tp-1 tokens."""
    target, draft = pair
    llm = ssd_tpu_torch.LLM(target, device="cpu", num_devices=2, draft=draft,
                            **ENGINE, **MODES["sd"])
    try:
        assert llm.draft_runner.params["lm_head"].shape[0] == SUBSET // 2
        assert llm.draft_runner.params["head_ids"].shape[0] == SUBSET
        outs, _ = llm.generate([list(p) for p in PROMPTS], SamplingParams(**GREEDY),
                               use_tqdm=False)
    finally:
        llm.exit()
    assert [o["token_ids"] for o in outs] == ar_tokens
