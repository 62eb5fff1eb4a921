"""ssd_tpu_torch ops against the JAX package on the same numpy inputs.

The plain PyTorch versions (what the CPU runs, and what the CUDA kernels are
held to on the card) must match the JAX oracles in ssd_tpu/ops/attention.py
and the Pallas kernels of ssd_tpu/ops/pallas_attention.py run in interpret
mode, within 1e-4 (fp32 reduction-order noise between XLA:CPU and ATen).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssd_tpu.engine.model_runner import slot_of as jax_slot_of
from ssd_tpu.ops import attention as jatt
from ssd_tpu.ops import layers as jlayers
from ssd_tpu.ops import pallas_attention as patt
from ssd_tpu.ops import sampler as jsampler
from ssd_tpu_torch.engine.model_runner import slot_of
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops import layers, sampler
from tests.torch_cases import flat_meta, paged_case


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


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **{**TOL, **kw})


@pytest.mark.parametrize("op", ["rms_norm", "rms_norm_residual", "rope", "silu_mul"])
def test_layers_match_jax(op):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 4, 16)).astype(np.float32)
    r = rng.normal(size=(7, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    if op == "rms_norm":
        close(layers.rms_norm(t(x), t(w), 1e-5), jlayers.rms_norm(x, w, 1e-5))
    elif op == "rms_norm_residual":
        got = layers.rms_norm_residual(t(x), t(r), t(w), 1e-5)
        want = jlayers.rms_norm_residual(jnp.asarray(x), jnp.asarray(r), w, 1e-5)
        for g, wt in zip(got, want):
            close(g, wt)
    elif op == "rope":
        pos = np.array([0, 1, 5, 17, 300, 1023, 4095], np.int32)
        cos, sin = layers.rope_cos_sin(t(pos), 16, 500000.0)
        jcos, jsin = jlayers.rope_cos_sin(jnp.asarray(pos), 16, 500000.0)
        close(cos, jcos)
        close(sin, jsin)
        close(layers.apply_rope(t(x), cos, sin), jlayers.apply_rope(x, jcos, jsin))
    else:
        close(layers.silu_mul(t(x), t(r)), jlayers.silu_mul(x, r))


def test_store_kv_matches_jax_with_ghost_slots():
    rng = np.random.default_rng(1)
    Hkv, S, hd, T = 2, 64, 8, 6
    cache = rng.normal(size=(Hkv, S, 2 * hd)).astype(np.float32)
    k = rng.normal(size=(T, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(T, Hkv, hd)).astype(np.float32)
    slots = np.array([5, -1, 63, 0, -1, 17], np.int32)
    want = jatt.store_kv(jnp.asarray(cache), k, v, jnp.asarray(slots))
    got = att.store_kv(t(cache.copy()), t(k), t(v), t(slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = t(np.flatnonzero(slots >= 0))
    got_rows = att.store_kv(t(cache.copy()), t(k), t(v), t(slots), rows)
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want))


def test_page_gathers_match_jax():
    q, kv, bt, ctx = paged_case(2, 3, 1, 4, 2, 8, 16, 4, [5, 40, 64], ghosts=1)
    k, v = att.gather_pages(t(kv), t(bt), 16, 64)
    jk, jv = jatt.gather_pages(jnp.asarray(kv), jnp.asarray(bt), 16, 64)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    pages = np.array([3, 1, -1, 7], np.int32)
    np.testing.assert_array_equal(
        att.dense_pages(t(kv), t(pages), 16).numpy(),
        np.asarray(jatt.dense_pages(jnp.asarray(kv), jnp.asarray(pages), 16)))


@pytest.mark.parametrize("B,Q", [(1, 1), (1, 5), (3, 1), (3, 5)])
def test_paged_attention_matches_jax_and_pallas(B, Q):
    """Plain paged attention vs the jnp oracle and the Pallas kernel the JAX
    router takes for that batch (v2 at B=1, v3 at B>1), at the production
    head_dim 64 with 64-token pages."""
    Hq, Hkv, hd, bs, M = 8, 2, 64, 64, 8
    q, kv, bt, ctx = paged_case(10 + B + Q, B, Q, Hq, Hkv, hd, bs, M,
                                [200, 64, 333][:B])
    qeff = np.full(B, Q, np.int32)
    scale = hd ** -0.5
    got = att.paged_attention(t(q), t(kv), t(bt), t(ctx), t(qeff), bs, scale)
    want = jatt.paged_attention(q, kv, bt, ctx, bs, M * bs, scale)
    close(got, want)
    kern = patt.paged_attention_v2 if B == 1 else patt.paged_attention_v3
    close(got, kern(q, kv, bt, ctx, qeff, bs, M * bs, scale, interpret=True))


@pytest.mark.parametrize("kernel_name", ["v2", "v3"])
def test_paged_attention_overshoot_matches_pallas(kernel_name):
    """Context beyond a full table (context-limit overshoot): only the
    table's positions are attended, as in test_pallas_kernels.py."""
    B, Q, Hq, Hkv, hd, bs, M = 3, 4, 8, 2, 64, 64, 4
    ctx_lens = [258, 100, 256]
    q, kv, bt, _ = paged_case(41, B, Q, Hq, Hkv, hd, bs, M, ctx_lens)
    ctx = np.asarray(ctx_lens, np.int32)
    qeff = np.full(B, Q, np.int32)
    scale = hd ** -0.5
    got = att.paged_attention(t(q), t(kv), t(bt), t(ctx), t(qeff), bs, scale)
    fn = patt.paged_attention_v2 if kernel_name == "v2" else patt.paged_attention_v3
    close(got, fn(q, kv, bt, ctx, qeff, bs, M * bs, scale, interpret=True))
    close(got, jatt.paged_attention(q, kv, bt, ctx, bs, M * bs, scale,
                                    qeff=jnp.asarray(qeff)))


def test_paged_attention_ghost_rows_and_masked_rows():
    """Ghost batch rows (context 1, table all -1) read page 0 like the
    oracle, and rows that attend nothing (qeff > context) give zeros."""
    Hq, Hkv, hd, bs, M = 4, 2, 16, 16, 4
    q, kv, bt, ctx = paged_case(5, 3, 2, Hq, Hkv, hd, bs, M, [30, 1], ghosts=1)
    qeff = np.array([2, 3, 2], np.int32)   # row 0 of seq 1 sees position -1
    got = att.paged_attention(t(q), t(kv), t(bt), t(ctx), t(qeff), bs, 0.25)
    want = jatt.paged_attention(q, kv, bt, ctx, bs, M * bs, 0.25,
                                qeff=jnp.asarray(qeff))
    close(got, want)
    assert torch.isfinite(got).all()
    assert got[1, 0].abs().max() == 0


def test_flat_prefill_matches_pallas_and_oracles():
    """The mixed prefix-cached/fresh case of test_pallas_kernels.py: plain
    flat prefill vs the Pallas kernel (interpret mode), the jnp interval
    oracle on the dense stream, and per-sequence paged attention."""
    B, Hq, Hkv, hd, bs, M = 3, 8, 2, 64, 16, 8
    ctx_lens, qeffs = [9, 12, 19], [5, 12, 3]   # seqs 0 and 2 prefix-cached
    _, kv, bt, ctx = paged_case(51, B, 1, Hq, Hkv, hd, bs, M, ctx_lens)
    T_pad, P_pad = 32, 8
    q = np.random.default_rng(52).normal(size=(T_pad, Hq, hd)).astype(np.float32)
    lo, hi, pages_per = flat_meta(ctx_lens, qeffs, bs, T_pad)
    pages = np.concatenate([bt[s, :pages_per[s]] for s in range(B)])
    pages = np.pad(pages, (0, P_pad - len(pages)), constant_values=-1).astype(np.int32)
    scale = hd ** -0.5

    got = att.flat_prefill_attention(t(q), t(kv), t(pages), t(lo), t(hi), bs, scale)
    close(got, patt.flat_prefill_attention(
        q, kv, jnp.asarray(pages), jnp.asarray(lo), jnp.asarray(hi), bs, scale,
        tq=16, tk=32, interpret=True))
    dense = jatt.dense_pages(jnp.asarray(kv), jnp.asarray(pages), bs)
    close(got, jatt.flat_prefill_attention(q, dense, jnp.asarray(lo),
                                           jnp.asarray(hi), scale))
    T = sum(qeffs)
    assert got[T:].abs().max() == 0   # padding rows
    off = 0
    for s, qe in enumerate(qeffs):
        want_s = att.paged_attention_plain(
            t(q[None, off:off + qe]), t(kv), t(bt[s:s + 1]), t(ctx[s:s + 1]),
            t(np.array([qe], np.int32)), bs, scale)
        close(got[off:off + qe], want_s[0])
        off += qe


def test_slot_of_matches_jax():
    bt = np.array([[3, 5, -1], [-1, -1, -1], [2, 0, 4]], np.int32)
    pos = np.array([0, 17, 33, 5, 47, 48, 60], np.int32)   # 48+ overshoots
    rows = np.array([0, 0, 0, 1, 2, 2, 2], np.int32)
    got = slot_of(bt, pos, rows, 16)
    want = jax_slot_of(jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(rows), 16)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_greedy_sampling_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(5, 300)).astype(np.float32)
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1  # tie: lowest index wins
    temps = np.zeros(5, np.float32)
    got = sampler.sample(t(logits), t(temps), torch.Generator().manual_seed(0))
    want = jsampler.sample(jnp.asarray(logits), jnp.asarray(temps),
                           jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2] == 7


def test_top_warp_matches_jax():
    rng = np.random.default_rng(4)
    probs = rng.dirichlet(np.ones(50), size=4).astype(np.float32)
    top_p = np.array([1.0, 0.5, 0.9, 0.3], np.float32)
    top_k = np.array([0, 0, 5, 3], np.int32)
    close(sampler.warp_top_probs(t(probs), t(top_p), t(top_k)),
          jsampler.warp_top_probs(jnp.asarray(probs), jnp.asarray(top_p),
                                  jnp.asarray(top_k)), atol=1e-6)


def test_temperature_sampling_follows_softmax():
    """Exponential race with a torch.Generator: reproducible from its seed,
    and the draw frequencies follow softmax(logits / T)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(4000, 1)
    temps = torch.full((4000,), 0.7)
    a = sampler.sample(logits, temps, torch.Generator().manual_seed(1))
    b = sampler.sample(logits, temps, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    freq = torch.bincount(a, minlength=4).float() / 4000
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits[0] / 0.7, -1).numpy(),
                               atol=0.03)


def test_wrappers_refuse_non_cuda_devices():
    """A wrapper takes the plain version only for CPU tensors; any other
    device launches the kernel or raises."""
    q = torch.zeros(1, 1, 4, 64, device="meta")
    kv = torch.zeros(2, 64, 128, device="meta")
    i32 = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        att.paged_attention(q, kv, i32, i32[0], i32[0], 64, 0.125)
    with pytest.raises(RuntimeError, match="CUDA"):
        att.flat_prefill_attention(q[0], kv, i32[0], i32[0], i32[0], 64, 0.125)
