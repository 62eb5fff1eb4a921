"""The port's Qwen3-MoE path against the JAX package on the same inputs:

- grouped_gemm's plain version against jax.lax.ragged_dot and the megablox
  gmm Pallas kernel (interpret mode), with empty groups, a one-row group and
  ragged row counts, at 1e-5 (fp32 reduction order);
- moe_mlp against ssd_tpu's _moe_mlp on all three of its dispatch paths
  (the per-row gather, the ragged grouped GEMM, the dense all-expert einsum),
  on both sides of MOE_GATHER_UNROLL_CAP, at k=3 (an order-sensitive sum),
  with and without renormalised weights, at 1e-5;
- the router's expert set under exact ties at the k-th place, against
  lax.top_k's;
- the loader and params_from_jax against the JAX loader, fp32 and bf16;
- end to end on the tiny Qwen3-MoE checkpoints of tests/utils_models.py
  (fp32, CPU): greedy AR tokens equal ssd_tpu's and HF's with continuous
  batching; self-draft sync SD accepts every token; sync SD and async SSD
  over an MoE pair give AR's tokens; the int8 KV cache's AR tokens equal
  ssd_tpu's int8 AR.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu.megablox import gmm

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu.models.transformer import MOE_GATHER_UNROLL_CAP, Arch as JaxArch, _moe_mlp
from ssd_tpu.utils.loader import load_params as jax_load_params
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.config import ModelConfig
from ssd_tpu_torch.models.transformer import Arch, init_params, param_bytes
from ssd_tpu_torch.ops import moe
from ssd_tpu_torch.utils.loader import load_params
from ssd_tpu_torch.weights import params_from_jax
from tests.utils_models import hf_greedy, make_tiny_qwen3_moe, random_prompt, rng


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker (the HF oracle of the
    JAX package's tests) keeps its own thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)   # fp32: summation order only
ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024, kvcache_block_size=16,
              num_kvcache_blocks=64, max_num_seqs=2, dtype="float32")
MODELS = {"e4k2": dict(seed=0), "e8k3": dict(num_experts=8, top_k=3, seed=9),
          "unnormed": dict(norm_topk_prob=False, seed=4)}
PROMPTS = [random_prompt(rng(60 + i), 8, 24) for i in range(3)]
N_NEW = [12, 20, 16]   # sequences leave the batch at different steps


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {}
    for name, kw in MODELS.items():
        d = tmp_path_factory.mktemp(f"qwen3_moe_{name}")
        make_tiny_qwen3_moe(d, **kw)
        out[name] = str(d)
    return out


# ---------------------------------------------------------------------------
# Grouped GEMM
# ---------------------------------------------------------------------------

# Group sizes over E=4 experts: empty groups, a one-row group, one group
# holding every row, and N=27, which megablox gmm cannot take (it needs N to
# be a multiple of its row tile).
GMM_SIZES = {"empty_and_one_row": [10, 0, 1, 13], "one_group": [0, 0, 24, 0],
             "no_empty": [5, 6, 7, 6], "ragged_n": [9, 0, 1, 17]}


@pytest.mark.parametrize("sizes", list(GMM_SIZES.values()), ids=list(GMM_SIZES))
def test_grouped_gemm_plain_matches_ragged_dot_and_gmm(sizes):
    r = np.random.default_rng(len(sizes) + sum(sizes))
    E, K, Nout, N = 4, 32, 48, sum(sizes)
    x = r.normal(size=(N, K)).astype(np.float32)
    w = r.normal(size=(E, K, Nout)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    got = moe.grouped_gemm(t(x), t(w), t(offsets))
    gs = jnp.asarray(sizes, jnp.int32)
    close(got, jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), gs))
    if N % 8 == 0:
        close(got, gmm(jnp.asarray(x), jnp.asarray(w), gs, tiling=(8, 32, 48),
                       interpret=True))
    # bf16: fp32 products rounded once, as gmm(...).astype(bf16).
    xb, wb = t(x).to(torch.bfloat16), t(w).to(torch.bfloat16)
    gotb = moe.grouped_gemm(xb, wb, t(offsets))
    assert gotb.dtype == torch.bfloat16
    want = jax.lax.ragged_dot(jnp.asarray(xb.float()), jnp.asarray(wb.float()), gs)
    assert torch.equal(gotb, t(want).to(torch.bfloat16))


def test_grouped_gemm_wrapper_refuses_bad_input():
    """Offsets that do not rise from 0 to at most N are refused on the CPU
    (offsets ending below N are expert parallelism's, whose rows past them
    belong to other ranks); a tensor on any device other than the CPU
    launches the kernel or raises."""
    x, w = torch.zeros(5, 16), torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="offsets"):
        moe.grouped_gemm(x, w, torch.tensor([0, 2, 6], dtype=torch.int32))
    with pytest.raises(ValueError, match="offsets"):
        moe.grouped_gemm(x, w, torch.tensor([0, 3, 2], dtype=torch.int32))
    xm, wm = x.to("meta"), w.to("meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        moe.grouped_gemm(xm, wm, torch.zeros(3, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# moe_mlp and the router
# ---------------------------------------------------------------------------


def _moe_layer(E, D, Im, seed):
    """Numpy router and expert stacks, scaled so outputs are O(1)."""
    r = np.random.default_rng(seed)
    return {"router": r.normal(size=(D, E)).astype(np.float32),
            "moe_gate": (r.normal(size=(E, D, Im)) * 0.3).astype(np.float32),
            "moe_up": (r.normal(size=(E, D, Im)) * 0.3).astype(np.float32),
            "moe_down": (r.normal(size=(E, Im, D)) * 0.3).astype(np.float32)}


@pytest.mark.parametrize("norm", [True, False], ids=["normed", "unnormed"])
def test_moe_mlp_matches_all_jax_paths(norm):
    """The port's one dispatch against JAX's gather (side=), ragged and dense
    paths, at T on both sides of the gather path's unroll cap."""
    E, k, D, Im = 8, 3, 32, 48
    arch = JaxArch(vocab_size=64, hidden_size=D, intermediate_size=Im, num_layers=1,
                   num_heads=2, num_kv_heads=1, head_dim=16, rms_norm_eps=1e-5,
                   rope_theta=1e4, use_qk_norm=True, tie_embeddings=False,
                   num_experts=E, num_experts_per_tok=k, moe_intermediate_size=Im,
                   norm_topk_prob=norm)
    layer = _moe_layer(E, D, Im, seed=5)
    lp = {n: jnp.asarray(a) for n, a in layer.items()}
    side = {n: v for n, v in lp.items() if n != "router"}   # one layer: [1*E, ...]
    port_lp = {n: t(a) for n, a in layer.items()}
    for T in (1, MOE_GATHER_UNROLL_CAP // k, MOE_GATHER_UNROLL_CAP // k + 1, 16):
        x = np.random.default_rng(T).normal(size=(T, D)).astype(np.float32)
        got = moe.moe_mlp(t(x), port_lp, k, norm)
        assert got.shape == (T, D) and got.abs().max() > 0.1
        paths = {"gather": _moe_mlp(jnp.asarray(x), lp, arch, side=side,
                                    layer=jnp.zeros((), jnp.int32)),
                 "ragged": _moe_mlp(jnp.asarray(x), lp, arch),
                 "dense": _moe_mlp(jnp.asarray(x), lp,
                                   dataclasses.replace(arch, moe_ragged=False))}
        for name, want in paths.items():
            np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"{name} T={T}",
                                       **TOL)


def test_router_ties_follow_lax_top_k():
    """Probabilities tied exactly across the k-th place: the selected experts
    are lax.top_k's (the lowest indices among the tied), and each token's
    experts come back in expert-index order with their weights."""
    k = 3
    x = np.array([[1, 3, 3, 3, 0, 2, 3, 1],     # four-way tie at the top
                  [5, 5, 5, 5, 5, 5, 5, 5],     # all tied
                  [0, 2, 2, 1, 2, 0, 9, 2],     # tie across ranks 2-5
                  [4, 0, 0, 7, 0, 0, 7, 4]], np.float32)
    router = np.eye(8, dtype=np.float32)
    top_i, top_w = moe.route(t(x), t(router), k, norm_topk_prob=True)
    probs = jax.nn.softmax(jnp.asarray(x @ router), axis=-1)
    jw, ji = jax.lax.top_k(probs, k)
    order = np.argsort(np.asarray(ji), axis=-1)
    np.testing.assert_array_equal(top_i.numpy(), np.take_along_axis(np.asarray(ji), order, -1))
    jw = np.asarray(jw) / np.asarray(jw).sum(-1, keepdims=True)
    close(top_w, np.take_along_axis(jw, order, -1))


# ---------------------------------------------------------------------------
# Weights and loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loader_and_params_from_jax_match_jax_loader(ckpts, dtype):
    """The port's safetensors reader and params_from_jax give the JAX
    loader's parameters: router [D, E], expert stacks [E, in, out] per
    layer (JAX stacks them [L, E, in, out])."""
    d = ckpts["e8k3"]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.device_get(jax_load_params(d, JaxModelConfig.from_pretrained(d), jdt))
    got = load_params(d, ModelConfig.from_pretrained(d), dtype, torch.device("cpu"))
    conv = params_from_jax(want)
    f32 = lambda a: np.asarray(a).astype(np.float32)  # noqa: E731
    assert {"router", "moe_gate", "moe_up", "moe_down"} <= set(want["layers"])
    assert got["layers"][0]["moe_down"].shape == (8, 96, 64)
    for params in (got, conv):
        for name in ("embed", "final_ln", "lm_head"):
            assert params[name].dtype == dtype
            np.testing.assert_array_equal(params[name].float().numpy(), f32(want[name]))
        for key, stacked in want["layers"].items():
            for i in range(len(params["layers"])):
                assert params["layers"][i][key].dtype == dtype
                np.testing.assert_array_equal(
                    params["layers"][i][key].float().numpy(), f32(stacked[i]), err_msg=key)


def test_moe_arch_init_params_and_param_bytes(ckpts):
    """Arch carries the MoE fields; init_params makes the router and expert
    stacks; param_bytes counts them (with the fp32 head the runner keeps);
    a non-uniform stack is refused."""
    mc = ModelConfig.from_pretrained(ckpts["e8k3"])
    arch = Arch.from_model_config(mc)
    assert (arch.num_experts, arch.num_experts_per_tok, arch.moe_intermediate_size,
            arch.norm_topk_prob) == (8, 3, 96, True)
    p = init_params(arch, 3, torch.float32, torch.device("cpu"))
    lp = p["layers"][1]
    assert lp["router"].shape == (64, 8) and lp["moe_gate"].shape == (8, 64, 96)
    assert "gate" not in lp
    held = sum(v.numel() for v in [p["embed"], p["final_ln"]]
               + [v for layer in p["layers"] for v in layer.values()]) * 4
    assert param_bytes(arch, torch.float32) == held + p["lm_head"].numel() * 4
    with pytest.raises(NotImplementedError, match="uniform"):
        ModelConfig(num_experts=8, mlp_only_layers=[1])
    with pytest.raises(NotImplementedError, match="uniform"):
        ModelConfig(num_experts=8, decoder_sparse_step=2)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def port(path, **kw):
    return ssd_tpu_torch.LLM(path, device="cpu", **{**ENGINE, **kw})


def serve(llm, prompts=PROMPTS, n_new=N_NEW):
    try:
        outs, m = llm.generate([list(p) for p in prompts],
                               [SamplingParams(temperature=0.0, max_new_tokens=n,
                                               ignore_eos=True) for n in n_new],
                               use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs], m


def jax_tokens(path, **kw):
    outs, _ = JaxLLM(path, use_pallas=False, **{**ENGINE, **kw}).generate(
        [list(p) for p in PROMPTS],
        [JaxSamplingParams(temperature=0.0, max_new_tokens=n, ignore_eos=True)
         for n in N_NEW], use_tqdm=False)
    return [o["token_ids"] for o in outs]


@pytest.mark.parametrize("name", list(MODELS))
def test_ar_greedy_matches_jax_and_hf(ckpts, name):
    """Two sequences at a time (max_num_seqs=2), so the third joins when
    the first leaves."""
    d = ckpts[name]
    got, _ = serve(port(d))
    assert got == jax_tokens(d)
    assert got == [hf_greedy(d, p, n) for p, n in zip(PROMPTS, N_NEW)]


def test_self_draft_sync_sd_accepts_every_token(ckpts):
    d = ckpts["e4k2"]
    got, m = serve(port(d, draft=d, speculate=True, speculate_k=2), PROMPTS[:1], [16])
    assert got == [hf_greedy(d, PROMPTS[0], 16)]
    lens = m["accepted_suffix_lens_with_recovery"]
    assert lens and np.mean(lens) == 3.0   # K+1


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_spec_over_moe_pair_matches_ar(ckpts, mode):
    """The E=8, k=3 target with the E=4 model as its draft: steps both
    accept and reject; tokens equal the target's AR."""
    target, draft = ckpts["e8k3"], ckpts["e4k2"]
    want, _ = serve(port(target))
    extra = dict(draft_async=True, async_fan_out=2) if mode == "async" else {}
    got, m = serve(port(target, draft=draft, speculate=True, speculate_k=3, **extra))
    assert got == want
    lens = m["accepted_suffix_lens_with_recovery"]
    assert lens and min(lens) < 4, lens   # some step rejected


def test_int8_kv_cache_ar_matches_jax(ckpts):
    d = ckpts["e8k3"]
    got, _ = serve(port(d, kv_quant="int8"))
    assert got == jax_tokens(d, kv_quant="int8")
