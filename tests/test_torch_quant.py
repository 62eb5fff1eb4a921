"""Weight-only int8 (quantization="int8") in ssd_tpu_torch against the JAX
package, on the CPU:

- quantization: from the same fp32 weights (a dense model with an untied and
  a tied head, Qwen3-MoE, an EAGLE-3 head), the port's int8 values equal
  ssd_tpu.utils.quant's exactly after the transpose to [out, in], the
  scales too, and a tied head stays one tensor;
- K9's plain version (ops/linear.py): (x @ q^T) * s against x @ the
  dequantized weight within fp32 roundoff, one group and four groups with
  an empty one, fp32 and bf16 output; the wrapper takes the plain version
  for CPU tensors and refuses bad arguments;
- one decode step of a quantized model (ssd_tpu's quantize_params carried
  across with params_from_jax; dense and MoE) against ssd_tpu's decode_step
  (tests/test_quant.py's case): logits within rtol = atol = 2e-5, equal
  tokens; an int8 EAGLE-3 head's eagle_forward and eagle_logits, which
  compute in bf16 in an fp32 engine on both sides, within the bf16
  tolerance stated there;
- the engines in fp32: greedy tokens of AR (and AR multi-step), fused SD,
  async SSD, and EAGLE-3 async and fused equal the port's own AR and
  ssd_tpu's engine under the same flags, over the fp cache and with
  kv_quant="int8";
- the config: an unknown quantization raises, the draft inherits it, and
  param_bytes counts what an int8 runner holds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.engine import model_runner as jmr
from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu.models import eagle3 as je3
from ssd_tpu.models.transformer import Arch as JaxArch
from ssd_tpu.models.transformer import init_params as jax_init_params
from ssd_tpu.utils import quant as jquant
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.config import Config, ModelConfig
from ssd_tpu_torch.engine import model_runner as mr
from ssd_tpu_torch.models import eagle3
from ssd_tpu_torch.models.transformer import Arch, param_bytes
from ssd_tpu_torch.ops import linear
from ssd_tpu_torch.utils import quant
from ssd_tpu_torch.weights import params_from_jax
from tests.utils_models import (
    make_tiny_eagle, make_tiny_llama, make_tiny_qwen3_moe, random_prompt, rng)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker (the HF oracle of the
    JAX package's tests) keeps its own thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-5, atol=2e-5)
BS = 16
ENGINE = dict(dtype="float32", quantization="int8", max_model_len=256,
              max_num_batched_tokens=1024, kvcache_block_size=BS, num_kvcache_blocks=96,
              max_num_seqs=4)
PROMPTS = [random_prompt(rng(61 + i), 8, 20) for i in range(2)]
N_NEW = 16


def t(a):
    return torch.from_numpy(np.array(a))


def _mc(moe: bool, tie: bool = False) -> dict:
    """tests/test_quant.py's geometry: hidden 64, head_dim 16, 2 layers."""
    return dict(model_type="qwen3_moe" if moe else "llama", vocab_size=256, hidden_size=64,
                intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16, tie_word_embeddings=tie,
                **(dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=96,
                        norm_topk_prob=True) if moe else {}),
                max_position_embeddings=256, rope_theta=10000.0)


def _jax_model(moe: bool, tie: bool = False):
    mc = _mc(moe, tie)
    jarch = JaxArch.from_model_config(JaxModelConfig(**mc))
    return jarch, jax_init_params(jarch, jax.random.PRNGKey(0), jnp.float32), \
        Arch.from_model_config(ModelConfig(**mc))


def _host(tree: dict) -> dict:
    """jax.device_get of a parameter tree, keeping a tied head (the same
    array as the embedding, and its scales the embedding's) one array, as
    params_from_jax reads a tie; device_get copies each leaf apart."""
    out = jax.device_get(tree)
    for k in ("lm_head", "lm_head_scale"):
        if k in tree and tree[k] is tree[k.replace("lm_head", "embed")]:
            out[k] = out[k.replace("lm_head", "embed")]
    return out


def _jax_eagle():
    mc = JaxModelConfig(model_type="llama", vocab_size=256, hidden_size=64,
                        intermediate_size=128, num_hidden_layers=1, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=16, max_position_embeddings=256,
                        rope_theta=10000.0)
    jarch = je3.EagleArch.from_model_config(mc, 64, 3)
    pmc = ModelConfig(**{k: getattr(mc, k) for k in (
        "model_type", "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
        "num_attention_heads", "num_key_value_heads", "head_dim", "max_position_embeddings",
        "rope_theta")})
    return jarch, je3.init_eagle_params(jarch, jax.random.PRNGKey(3), jnp.float32), \
        eagle3.EagleArch.from_model_config(pmc, 64, 3)


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


def _assert_same_int8(got: torch.Tensor, want, name: str):
    want = np.asarray(want)
    assert got.dtype == torch.int8 and got.shape == want.shape, (name, got.shape, want.shape)
    differ = int((got.numpy() != want).sum())
    assert differ == 0, f"{name}: {differ} of {want.size} int8 values differ from ssd_tpu's"


@pytest.mark.parametrize("kind", ["dense", "tied", "moe", "eagle"])
def test_quantize_matches_jax(kind):
    """The port's quantize_params / quantize_eagle_params of the same fp32
    weights equal ssd_tpu.utils.quant's: int8 values exactly (the layer
    matrices transposed to [out, in]), scales exactly."""
    if kind == "eagle":
        _, jparams, _ = _jax_eagle()
        jq = jax.device_get(jquant.quantize_eagle_params(jparams))
        params = quant.quantize_eagle_params(params_from_jax(jax.device_get(jparams)))
        mats = [(params, jq, name) for name in quant.EAGLE_WEIGHTS]
    else:
        _, jparams, _ = _jax_model(kind == "moe", tie=kind == "tied")
        jq = _host(jquant.quantize_params(jparams))
        params = quant.quantize_params(params_from_jax(_host(jparams)))
        mats = [(lp, {k: v[i] for k, v in jq["layers"].items()}, name)
                for i, lp in enumerate(params["layers"])
                for name in quant.LAYER_WEIGHTS if name in lp]
        kept = ("input_ln", "post_ln") + (("router",) if kind == "moe" else ())
        assert all(params["layers"][0][k].dtype == torch.float32 for k in kept)
    for got, want, name in mats:
        _assert_same_int8(got[name], np.swapaxes(want[name], -1, -2), name)
        np.testing.assert_array_equal(got[name + "_scale"].numpy(), want[name + "_scale"])
    for name in ("embed", "lm_head"):
        _assert_same_int8(params[name], jq[name], name)
        np.testing.assert_array_equal(params[name + "_scale"].numpy(), jq[name + "_scale"])
    assert (params["lm_head"] is params["embed"]) == (kind == "tied")
    assert (params["lm_head_scale"] is params["embed_scale"]) == (kind == "tied")


def test_params_from_jax_carries_quantized_trees():
    """params_from_jax of a quantized tree gives what the port's own
    quantization of the float tree gives, and still refuses unknown keys."""
    _, jparams, _ = _jax_model(True, tie=True)
    port = quant.quantize_params(params_from_jax(_host(jparams)))
    carried = params_from_jax(_host(jquant.quantize_params(jparams)))
    assert carried["lm_head"] is carried["embed"]
    for got, want in zip(carried["layers"], port["layers"]):
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), k
    with pytest.raises(NotImplementedError, match="wq_zero"):
        params_from_jax({**jax.device_get(jparams),
                         "layers": {**jax.device_get(jparams)["layers"],
                                    "wq_zero": np.zeros(2)}})


# ---------------------------------------------------------------------------
# K9's plain version and wrapper
# ---------------------------------------------------------------------------


def _k9_case(seed, M, N, K, G):
    r = np.random.default_rng(seed)
    x = t(r.normal(size=(M, K)).astype(np.float32))
    w = t(r.integers(-127, 128, size=(G, N, K)).astype(np.int8))
    s = t((r.uniform(0.5, 2.0, size=(G, N)) / 127).astype(np.float32))
    return x, w, s


@pytest.mark.parametrize("out", ["float32", "input"])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_int8_linear_plain_matches_dequantized(xdt, out):
    """One group, and four groups over 13 rows with group 2 empty: each
    row's output equals x @ (q * s)^T of its group within fp32 roundoff (and
    one bf16 rounding for a bf16 output)."""
    dt = getattr(torch, xdt)
    odt = torch.float32 if out == "float32" else dt
    for G, offs in ((1, None), (4, [0, 3, 7, 7, 13])):
        x, w, s = _k9_case(5, 13, 24, 48, G)
        x = x.to(dt)
        go = None if offs is None else torch.tensor(offs, dtype=torch.int32)
        got = linear.int8_linear(x, w, s, out_dtype=odt, group_offsets=go)
        assert torch.equal(got, linear.int8_linear_plain(x, w, s, odt, go))
        assert got.dtype == odt and got.shape == (13, 24)
        bounds = [0, 13] if offs is None else offs
        for g, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
            want = x[lo:hi].double() @ (w[g].double() * s[g].double()[:, None]).T
            rtol = 2e-6 if odt == torch.float32 else 2.0 ** -8
            np.testing.assert_allclose(got[lo:hi].double().numpy(), want.numpy(),
                                       rtol=rtol, atol=1e-5)


def test_int8_linear_refuses_bad_arguments():
    x, w, s = _k9_case(6, 4, 16, 32, 2)
    offs = torch.tensor([0, 1, 4], dtype=torch.int32)
    with pytest.raises(TypeError, match="int8"):
        linear.int8_linear(x, w.float(), s, group_offsets=offs)
    with pytest.raises(TypeError):
        linear.int8_linear(x.double(), w, s, group_offsets=offs)
    with pytest.raises(TypeError):
        linear.int8_linear(x, w, s, out_dtype=torch.bfloat16, group_offsets=offs)
    with pytest.raises(ValueError, match="group_offsets"):
        linear.int8_linear(x, w, s)
    with pytest.raises(ValueError, match="group_offsets"):
        linear.int8_linear(x, w, s, group_offsets=offs.long())
    with pytest.raises(ValueError, match="shapes"):
        linear.int8_linear(x[:, :16], w, s, group_offsets=offs)
    with pytest.raises(ValueError, match="contiguous"):
        linear.int8_linear(x.T.contiguous().T, w, s, group_offsets=offs)
    with pytest.raises(ValueError, match="offsets"):
        linear.int8_linear(x, w, s, group_offsets=torch.tensor([0, 3, 2], dtype=torch.int32))


def test_int8_linear_route():
    """The route rule at the main path's shapes: fp32 x takes the SIMT
    kernel; bf16 x the wgmma decode route up to INT8_DECODE_ROWS rows a
    group (AR, verify and tree rows at every width, the experts' decode
    dispatches), and up to 512 rows below N = 8192, and the prefill route
    past them."""
    route = linear.int8_linear_route
    assert route(torch.float32, 5000, 2048, 1) == "simt"
    for M, N, G in ((1, 2048, 1), (8, 128256, 1), (40, 8192, 1), (80, 2048, 1),
                    (64, 512, 1), (128, 8192, 1), (64, 768, 128), (320, 2048, 128),
                    (200, 2048, 1), (512, 512, 1), (80, 512, 1), (128, 512, 1),
                    (65, 136, 1)):
        assert route(torch.bfloat16, M, N, G) == "decode", (M, N, G)
    for M, N, G in ((129, 8192, 1), (513, 2048, 1), (5534, 512, 1), (5534, 128256, 1),
                    (44272, 768, 128)):
        assert route(torch.bfloat16, M, N, G) == "prefill", (M, N, G)


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_int8_linear_shared_plain_equals_separate_calls(xdt):
    """int8_linear_shared's plain version (CPU tensors) over three weights of
    different widths, one group and three groups with an empty one: each
    output equals its own int8_linear_plain call bit for bit; mm_shared over
    int8 params does too, and over float params equals x @ W; 0 or 4 pairs
    raise."""
    dt = getattr(torch, xdt)
    for G, offs in ((1, None), (3, [0, 4, 4, 9])):
        go = None if offs is None else torch.tensor(offs, dtype=torch.int32)
        cases = [_k9_case(60 + i, 9, N, 32, G) for i, N in enumerate((24, 8, 40))]
        x = cases[0][0].to(dt)
        ws, ss = [c[1] for c in cases], [c[2] for c in cases]
        for odt in {dt, torch.float32}:
            got = linear.int8_linear_shared(x, ws, ss, out_dtype=odt, group_offsets=go)
            for g, w, s in zip(got, ws, ss):
                assert torch.equal(g, linear.int8_linear_plain(x, w, s, odt, go))
    params = {n: w[0] for n, w in zip("abc", ws)} | {n + "_scale": s[0] for n, s in zip("abc", ss)}
    for g, n in zip(linear.mm_shared(x, params, "abc"), "abc"):
        assert torch.equal(g, linear.mm(x, params, n))
    fparams = {n: torch.randn(32, 16, dtype=dt) for n in "ab"}
    for g, n in zip(linear.mm_shared(x, fparams, "ab"), "ab"):
        assert torch.equal(g, x @ fparams[n])
    for bad in ([], ws + ws[:1]):
        with pytest.raises(ValueError, match="pairs"):
            linear.int8_linear_shared(x, bad, ss[:1] * len(bad))


# ---------------------------------------------------------------------------
# One step against ssd_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moe", [False, True])
def test_quantized_decode_step_matches_jax(moe):
    """tests/test_quant.py's decode step (two sequences, tokens 7 and 9 at
    position 0 in pages 0 and 1) on ssd_tpu's quantize_params output,
    through both packages: logits within 2e-5, equal tokens."""
    jarch, jparams, arch = _jax_model(moe)
    qp = jquant.quantize_params(jparams)
    params = params_from_jax(jax.device_get(qp))
    bt = np.pad([[0], [1]], ((0, 0), (0, 7)), constant_values=-1).astype(np.int32)
    jtok, jlogits, _, _ = jmr.decode_step(
        qp, jnp.zeros((2, 2, 256, 32), jnp.float32), jnp.array([7, 9], jnp.int32),
        jnp.array([0, 0], jnp.int32), jnp.array([0, 16], jnp.int32), jnp.asarray(bt),
        jnp.array([1, 1], jnp.int32), jnp.zeros(2, jnp.float32), jax.random.PRNGKey(1),
        arch=jarch, block_size=BS, ctx_pad=64, q_len=1)
    tok, logits = mr.decode_step(
        params, torch.zeros(2, 2, 256, 32), t([7, 9]), t([0, 0]), t(bt), t([1, 1]),
        torch.zeros(2), None, arch=arch, block_size=BS, q_len=1)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert tok.tolist() == np.asarray(jtok).tolist()


def _attn_fp32_torch(T, G):
    """Causal attention in fp32 arithmetic, the output in q's dtype (as the
    paged kernels and their plain versions compute it)."""
    def call(li, q, k, v):
        qf, kf, vf = q.float(), k.float().repeat_interleave(G, 1), v.float().repeat_interleave(G, 1)
        s = torch.einsum("thd,shd->hts", qf, kf) * q.shape[-1] ** -0.5
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
        return torch.einsum("hts,shd->thd", torch.softmax(s, -1), vf).to(q.dtype)
    return call


def _attn_fp32_jax(T, G):
    def call(q, k, v, kv_layer):
        qf = q.astype(jnp.float32)
        kf = jnp.repeat(k.astype(jnp.float32), G, axis=1)
        vf = jnp.repeat(v.astype(jnp.float32), G, axis=1)
        s = jnp.einsum("thd,shd->hts", qf, kf) * q.shape[-1] ** -0.5
        s = jnp.where(jnp.triu(jnp.ones((T, T), bool), 1), -jnp.inf, s)
        o = jnp.einsum("hts,shd->thd", jax.nn.softmax(s, -1), vf)
        return o.astype(q.dtype), kv_layer
    return call


def test_quantized_eagle_layer_and_logits_match_jax():
    """An int8 EAGLE-3 head (ssd_tpu's quantize_eagle_params carried across)
    computes in bf16 on both sides (its fc is int8), from fp32 taps.
    eagle_forward's prenorm and eagle_logits agree within 2^-6 of the
    largest magnitude: ssd_tpu rounds each projection to bf16 and then its
    product with the scale, the port the scaled fp32 sum once, so single
    values differ by bf16 roundings that the layer carries on. The greedy
    token of every row agrees."""
    jarch, jparams, arch = _jax_eagle()
    qp = jquant.quantize_eagle_params(jparams)
    params = params_from_jax(jax.device_get(qp))
    assert eagle3.compute_dtype(params) == torch.bfloat16
    T, G = 9, arch.num_heads // arch.num_kv_heads
    r = np.random.default_rng(2)
    ids = r.integers(3, 256, T)
    acts = r.normal(size=(T, arch.act_dim)).astype(np.float32)
    pos = np.arange(T)
    cond = eagle3.project_target_acts(params, t(acts))
    jcond = je3.project_target_acts(qp, jnp.asarray(acts))
    pre = eagle3.eagle_forward(params, t(ids), cond, t(pos), _attn_fp32_torch(T, G), arch)
    jpre, _ = je3.eagle_forward(qp, jnp.zeros((1, 1, 1, 1)), jnp.asarray(ids), jcond,
                                jnp.asarray(pos), _attn_fp32_jax(T, G), jarch)
    assert cond.dtype == pre.dtype == torch.bfloat16
    logits = eagle3.eagle_logits(params, pre, arch)
    jlogits = np.asarray(je3.eagle_logits(qp, jpre, jarch))
    assert logits.dtype == torch.float32
    for got, want in ((cond, jcond), (pre, jpre), (logits, jlogits)):
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), jlogits.argmax(-1))


# ---------------------------------------------------------------------------
# Engines against ssd_tpu and the port's AR
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("quant_llama")
    make_tiny_llama(d, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def moe_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("quant_moe")
    make_tiny_qwen3_moe(d, seed=0)
    return str(d)


@pytest.fixture(scope="module")
def eagle_dirs(tmp_path_factory):
    """make_tiny_llama(layers=6) (taps 0, 2, 4) and make_tiny_eagle."""
    t_dir, e_dir = tmp_path_factory.mktemp("quant_t6"), tmp_path_factory.mktemp("quant_e")
    make_tiny_llama(t_dir, layers=6, seed=0)
    make_tiny_eagle(e_dir, seed=3)
    return str(t_dir), str(e_dir)


def serve(llm, n=N_NEW):
    try:
        outs, _ = llm.generate([list(p) for p in PROMPTS],
                               SamplingParams(temperature=0.0, max_new_tokens=n,
                                              ignore_eos=True), use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs]


def serve_jax(path, n=N_NEW, **kw):
    llm = JaxLLM(path, **{**ENGINE, **kw})
    try:
        outs, _ = llm.generate([list(p) for p in PROMPTS],
                               JaxSamplingParams(temperature=0.0, max_new_tokens=n,
                                                 ignore_eos=True), use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs]


def port(path, **kw):
    return ssd_tpu_torch.LLM(path, device="cpu", **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def ar_tokens(llama_dir, moe_dir):
    """The port's int8 AR tokens of both models; the Llama's held to
    ssd_tpu's int8 AR (the MoE forward is held to ssd_tpu's in
    test_quantized_decode_step_matches_jax)."""
    out = {"llama": serve(port(llama_dir)), "moe": serve(port(moe_dir))}
    assert out["llama"] == serve_jax(llama_dir)
    return out


@pytest.mark.parametrize("model", ["llama", "moe"])
def test_int8_ar_and_multi_step(model, ar_tokens, llama_dir, moe_dir):
    """The runner holds int8 weights with no fp32 head; AR multi-step
    (M = 3) equals AR."""
    path = llama_dir if model == "llama" else moe_dir
    llm = port(path, multi_step=3)
    p = llm.model_runner.params
    assert p["lm_head"].dtype == torch.int8 and p["embed"].dtype == torch.int8
    assert all(v.dtype in (torch.int8, torch.float32) for v in p["layers"][0].values())
    assert serve(llm) == ar_tokens[model]


@pytest.mark.parametrize("model", ["llama", "moe"])
def test_int8_fused_sd_matches_ar_and_jax(model, ar_tokens, llama_dir, moe_dir):
    """Fused sync SD (R = 2, the model as its own int8 draft) equals AR and,
    for the Llama, ssd_tpu's same engine."""
    path = llama_dir if model == "llama" else moe_dir
    kw = dict(draft=path, speculate=True, speculate_k=2, spec_rounds=2)
    got = serve(port(path, **kw))
    assert got == ar_tokens[model]
    if model == "llama":
        assert got == serve_jax(path, **kw)


def test_int8_sync_modes_match_ar(ar_tokens, llama_dir):
    """Sync SD (R = 1, the model as its own int8 draft) and ngram
    speculation equal AR."""
    assert serve(port(llama_dir, draft=llama_dir, speculate=True, speculate_k=3)) \
        == ar_tokens["llama"]
    assert serve(port(llama_dir, ngram_speculate=True, speculate_k=3, spec_rounds=2)) \
        == ar_tokens["llama"]


def test_int8_async_ssd_matches_ar_and_jax(ar_tokens, llama_dir):
    """Async SSD (unfused, the draft thread) equals AR and ssd_tpu's same
    engine; the fused exchange and superstep equal AR."""
    kw = dict(draft=llama_dir, speculate=True, speculate_k=2, draft_async=True,
              async_fan_out=2)
    got = serve(port(llama_dir, **kw))
    assert got == ar_tokens["llama"]
    assert got == serve_jax(llama_dir, **kw)
    for rounds in (1, 2):
        assert serve(port(llama_dir, **kw, async_fused=True, spec_rounds=rounds)) \
            == ar_tokens["llama"], rounds


def test_int8_weights_with_int8_cache_match_jax(llama_dir):
    """quantization="int8" with kv_quant="int8": AR equals ssd_tpu's, and
    async SSD equals it."""
    want = serve_jax(llama_dir, kv_quant="int8")
    assert serve(port(llama_dir, kv_quant="int8")) == want
    assert serve(port(llama_dir, kv_quant="int8", draft=llama_dir, speculate=True,
                      speculate_k=2, draft_async=True, async_fan_out=2)) == want


@pytest.mark.parametrize("form", ["async", "fused"])
def test_int8_eagle_matches_ar_and_jax(form, eagle_dirs):
    """EAGLE-3 over an int8 target and an int8 head (bf16 compute in the
    fp32 engine), async SSD and the fused sync superstep: greedy tokens
    equal the int8 AR and ssd_tpu's same engine (tests/test_quant.py's
    EAGLE cases)."""
    t_dir, e_dir = eagle_dirs
    kw = dict(draft=e_dir, speculate=True, use_eagle=True, speculate_k=2,
              eagle_layers=[0, 2, 4])
    kw.update(dict(draft_async=True, jit_speculate=True, async_fan_out=3) if form == "async"
              else dict(spec_rounds=3))
    llm = port(t_dir, **kw)
    head = (llm.draft_server.runner if llm.draft_server is not None else llm.draft_runner).params
    assert head["fc"].dtype == head["lm_head"].dtype == torch.int8
    got = serve(llm, 20)
    assert got == serve(port(t_dir), 20)
    assert got == serve_jax(t_dir, 20, **kw)


# ---------------------------------------------------------------------------
# Config and sizing
# ---------------------------------------------------------------------------


def test_quantization_config(llama_dir):
    with pytest.raises(ValueError, match="quantization"):
        Config(llama_dir, device="cpu", quantization="int4")
    cfg = Config(llama_dir, device="cpu", quantization="int8", draft=llama_dir,
                 speculate=True, speculate_k=2)
    assert cfg.create_draft_config().quantization == "int8"


def test_param_bytes_counts_what_the_runners_hold(llama_dir, moe_dir, eagle_dirs):
    """param_bytes and eagle_param_bytes (the partner's reserve in the pool
    sizing) equal the bytes of the runners' tensors, bf16 and int8."""
    from ssd_tpu_torch.engine.eagle_runner import EagleModelRunner

    t_dir, e_dir = eagle_dirs
    common = dict(device="cpu", dtype="bfloat16", max_model_len=256, num_kvcache_blocks=8,
                  kvcache_block_size=BS)
    for q in (None, "int8"):
        for path in (llama_dir, moe_dir):
            r = mr.ModelRunner(Config(path, quantization=q, **common))
            assert r.weight_bytes == param_bytes(r.arch, torch.bfloat16, q), (path, q)
        cfg = Config(t_dir, quantization=q, draft=e_dir, speculate=True, use_eagle=True,
                     speculate_k=2, spec_rounds=2, eagle_layers=[0, 2, 4], **common)
        h = EagleModelRunner(cfg.create_draft_config())
        assert h.weight_bytes == eagle3.eagle_param_bytes(h.arch, torch.bfloat16, q), q
