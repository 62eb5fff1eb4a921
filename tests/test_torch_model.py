"""ssd_tpu_torch model and loader against the JAX package.

Weights are carried across with ssd_tpu_torch.weights.params_from_jax, so the
two packages compute the same function; logits and KV caches must agree
within 1e-4 (fp32 reduction-order noise), and sampled greedy tokens exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.engine import model_runner as jmr
from ssd_tpu.models.transformer import Arch as JaxArch
from ssd_tpu.utils.loader import load_params as jax_load_params
from ssd_tpu_torch.config import ModelConfig
from ssd_tpu_torch.engine import model_runner as mr
from ssd_tpu_torch.models.transformer import Arch, init_params
from ssd_tpu_torch.utils.loader import SafetensorsIndex, load_params, save_safetensors
from ssd_tpu_torch.weights import params_from_jax
from tests.utils_models import make_tiny_llama, make_tiny_qwen3


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
BS = 16


@pytest.fixture(scope="module", params=["llama", "qwen3"])
def model(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(f"tiny_{request.param}"))
    (make_tiny_llama if request.param == "llama" else make_tiny_qwen3)(d)
    jarch = JaxArch.from_model_config(JaxModelConfig.from_pretrained(d))
    jparams = jax_load_params(d, JaxModelConfig.from_pretrained(d), jnp.float32)
    params = params_from_jax(jax.device_get(jparams))
    arch = Arch.from_model_config(ModelConfig.from_pretrained(d))
    return d, jarch, jparams, arch, params


def _prefill_inputs(arch, prompts, cached, rng):
    """Flat prefill inputs for prompts whose first `cached` tokens are
    already in the cache (pages: sequence s owns pages 4s .. 4s+3)."""
    T = sum(len(p) - c for p, c in zip(prompts, cached))
    T_pad, P_pad, B_pad = 32, 8, 2
    ids, pos, slots = np.zeros(T_pad, np.int32), np.zeros(T_pad, np.int32), np.full(T_pad, -1, np.int32)
    lo, hi = np.zeros(T_pad, np.int32), np.zeros(T_pad, np.int32)
    pages = np.full(P_pad, -1, np.int32)
    gather = np.zeros(B_pad, np.int32)
    t = p = 0
    for s, (prompt, c) in enumerate(zip(prompts, cached)):
        n = len(prompt) - c
        table = np.arange(4 * s, 4 * s + 4, dtype=np.int32)
        npages = -(-len(prompt) // BS)
        ids[t:t + n] = prompt[c:]
        pos[t:t + n] = np.arange(c, len(prompt))
        slots[t:t + n] = table[pos[t:t + n] // BS] * BS + pos[t:t + n] % BS
        pages[p:p + npages] = table[:npages]
        lo[t:t + n] = p * BS
        hi[t:t + n] = p * BS + pos[t:t + n] + 1
        gather[s] = t + n - 1
        t, p = t + n, p + npages
    assert t == T
    return ids, pos, slots, pages, lo, hi, gather


def test_flat_prefill_and_decode_steps_match_jax(model):
    """One flat prefill (a fresh prompt and a prefix-cached one) and one
    decode step through both packages' step functions: logits, KV caches and
    greedy tokens."""
    d, jarch, jparams, arch, params = model
    rng = np.random.default_rng(0)
    L, Hkv, hd = arch.num_layers, arch.num_kv_heads, arch.head_dim
    S = 16 * BS
    cache0 = rng.normal(size=(L, Hkv, S, 2 * hd)).astype(np.float32)
    prompts = [rng.integers(3, 128, size=13).tolist(), rng.integers(3, 128, size=21).tolist()]
    cached = [0, 16]   # the second prompt's first page is already cached
    ids, pos, slots, pages, lo, hi, gather = _prefill_inputs(arch, prompts, cached, rng)
    temps = np.zeros(2, np.float32)

    jtok, jlogits, jcache = jmr.flat_prefill_step(
        jparams, jnp.asarray(cache0), ids, pos, slots, pages, lo, hi, gather,
        temps, jax.random.PRNGKey(0), arch=jarch, block_size=BS, use_pallas=False)
    cache = torch.from_numpy(cache0.copy())
    t = torch.from_numpy
    tok, logits = mr.flat_prefill_step(
        params, cache, t(ids), t(pos), t(slots),
        t(pages), t(lo), t(hi), t(gather).long(), t(temps), None,
        arch=arch, block_size=BS)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache), **TOL)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))

    # One decode step for both sequences on the caches just written.
    bt = np.full((2, 4), -1, np.int32)
    bt[0, :1], bt[1, :2] = [0], [4, 5]
    nxt = np.array(jtok, np.int32)   # a writable copy for torch.from_numpy
    ctx = np.array([len(p) + 1 for p in prompts], np.int32)
    dpos = ctx - 1
    dslots = np.array([bt[b, dpos[b] // BS] * BS + dpos[b] % BS for b in range(2)], np.int32)
    jtok2, jlogits2, _, jcache2 = jmr.decode_step(
        jparams, jcache, nxt, dpos, dslots, bt, ctx, temps, jax.random.PRNGKey(1),
        arch=jarch, block_size=BS, ctx_pad=64, q_len=1, use_pallas=False)
    tok2, logits2 = mr.decode_step(
        params, cache, t(nxt), t(dpos), t(bt), t(ctx), t(temps), None,
        arch=arch, block_size=BS, q_len=1)
    np.testing.assert_allclose(logits2.numpy(), np.asarray(jlogits2), **TOL)
    np.testing.assert_allclose(cache.numpy(), np.asarray(jcache2), **TOL)
    np.testing.assert_array_equal(tok2.numpy(), np.asarray(jtok2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loader_matches_jax_loader(model, dtype):
    """The port's own safetensors reader gives the JAX loader's parameters,
    including the dtype conversion."""
    d, _, _, arch, _ = model
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.device_get(jax_load_params(d, JaxModelConfig.from_pretrained(d), jdt))
    got = load_params(d, ModelConfig.from_pretrained(d), dtype, torch.device("cpu"))
    f32 = lambda a: np.asarray(a).astype(np.float32)  # noqa: E731
    for name in ("embed", "final_ln", "lm_head"):
        assert got[name].dtype == dtype
        np.testing.assert_array_equal(got[name].float().numpy(), f32(want[name]))
    for key, stacked in want["layers"].items():
        for i in range(arch.num_layers):
            np.testing.assert_array_equal(
                got["layers"][i][key].float().numpy(), f32(stacked[i]), err_msg=key)


def test_safetensors_writer_round_trips(tmp_path):
    """Files from save_safetensors read back through both the port's reader
    and the `safetensors` package the JAX loader uses."""
    from safetensors.numpy import load_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g),
               "b": torch.randn(7, generator=g).to(torch.bfloat16),
               "c": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    path = os.path.join(tmp_path, "model.safetensors")
    save_safetensors(path, tensors)
    idx = SafetensorsIndex(str(tmp_path))
    assert sorted(idx.names()) == ["a", "b", "c"]
    for k, v in tensors.items():
        assert torch.equal(idx.get(k), v)
    ref = load_file(path)
    np.testing.assert_array_equal(ref["a"], tensors["a"].numpy())
    np.testing.assert_array_equal(ref["c"], tensors["c"].numpy())


def test_safetensors_reader_dtypes_empty_and_short_file(tmp_path):
    """The reader gives every stored dtype back bit for bit, an empty
    tensor at its shape, and refuses a file cut inside a tensor."""
    tensors = {"f16": torch.arange(6, dtype=torch.float16).reshape(3, 2) / 3,
               "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
               "i64": torch.tensor([[1 << 40, -5]], dtype=torch.int64),
               "bool": torch.tensor([True, False, True]),
               "empty": torch.zeros(0, 4, dtype=torch.float32),
               "last": torch.arange(64, dtype=torch.float32)}
    path = os.path.join(tmp_path, "model.safetensors")
    save_safetensors(path, tensors)
    idx = SafetensorsIndex(str(tmp_path))
    for k, v in tensors.items():
        got = idx.get(k)
        assert got.dtype == v.dtype and got.shape == v.shape
        assert torch.equal(got, v)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 8)
    with pytest.raises(ValueError, match="cut short"):
        SafetensorsIndex(str(tmp_path)).get("last")


def test_init_params_seeded_and_tied(model):
    _, _, _, arch, _ = model
    tied = Arch(**{**arch.__dict__, "tie_embeddings": True})
    p1 = init_params(tied, 5, torch.float32, torch.device("cpu"))
    p2 = init_params(tied, 5, torch.float32, torch.device("cpu"))
    assert p1["lm_head"] is p1["embed"]
    assert len(p1["layers"]) == arch.num_layers
    assert torch.equal(p1["layers"][1]["wq"], p2["layers"][1]["wq"])
    assert p1["layers"][0]["wq"].shape == (arch.hidden_size, arch.num_heads * arch.head_dim)
