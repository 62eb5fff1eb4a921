"""ssd_tpu_torch's speculative-decoding ops against the JAX package on the
same numpy inputs: tree attention (the plain version of
csrc/tree_attention.cu) against the jnp oracle and the three Pallas tree
kernels in interpret mode, the fork and rescaling math of spec_math (tie
order included), and verify() greedy and sampled. fp32 tolerance 1e-4
(reduction-order noise between XLA:CPU and ATen).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssd_tpu.ops import attention as jatt
from ssd_tpu.ops import pallas_attention as patt
from ssd_tpu.ops import spec_math as jsm
from ssd_tpu.ops import verify as jverify
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops import sampler, spec_math
from ssd_tpu_torch.ops import verify as tverify
from tests.torch_cases import tree_case


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
    return torch.from_numpy(np.array(a))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("kernel,step", [("v1", 0), ("v1", 2), ("v2", 0),
                                         ("v2", 2), ("v3", 0), ("v3", 2)])
def test_tree_attention_matches_jax_and_pallas(kernel, step):
    """Plain tree attention vs the jnp oracle (every row, a warm-up ghost
    row with a negative prefix included) and vs the Pallas tree kernel in
    interpret mode (live rows): v1 at a small head size, v2 at B=1 and v3 at
    B>1 at the production head size their router requires. Even rows take
    the hit fan-out list, odd rows the miss list."""
    K, fans = 3, [3, 2, 2, 1]
    if kernel == "v1":
        B, Hq, Hkv, hd, bs, M, bases, ghosts = 3, 4, 2, 16, 16, 16, [20, 7], 1
    elif kernel == "v2":
        B, Hq, Hkv, hd, bs, M, bases, ghosts = 1, 8, 2, 64, 64, 8, [120], 0
    else:
        B, Hq, Hkv, hd, bs, M, bases, ghosts = 4, 8, 2, 64, 64, 8, [120, 77, 30], 1
    q, kv, bt, ctx, fan = tree_case(30 + step, B, K, fans, Hq, Hkv, hd, bs, M,
                                    bases, step, ghosts)
    scale = hd ** -0.5
    got = att.tree_attention(t(q), t(kv), t(bt), t(ctx), t(fan), step, K, bs, scale)
    close(got, jatt.tree_attention(q, kv, bt, ctx, fan, step, K, bs, M * bs, scale))
    assert torch.isfinite(got).all()
    live = B - ghosts
    if kernel == "v1":
        want = patt.tree_attention(q, kv, bt, ctx, fan, jnp.int32(step), K, bs,
                                   M * bs, scale, interpret=True)
    elif kernel == "v2":
        want = patt.tree_attention_v2(q, kv, bt, ctx, fan, jnp.int32(step), K, bs,
                                      M * bs, scale, interpret=True)
    else:
        want = patt.tree_attention_v3(q, kv, bt, ctx, fan, jnp.int32(step), K, bs,
                                      M * bs, scale, seqs_per_step=2, interpret=True)
    close(got[:live], np.asarray(want)[:live])


def test_tree_mask_matches_jax():
    K, MQ, C = 3, 6, 64
    ctx = np.array([40, 22, 9], np.int32)       # the last has a negative prefix
    fan = np.stack([jsm.fan_index([2, 2, 1, 1]), jsm.fan_index([1, 1, 2, 2]),
                    jsm.fan_index([2, 2, 1, 1])])
    assert (spec_math.fan_index([2, 2, 1, 1]) == fan[0]).all()
    for step in range(K):
        got = spec_math.tree_attention_mask(t(ctx), step, t(fan), K, MQ, C)
        want = jsm.tree_attention_mask(jnp.asarray(ctx), step, jnp.asarray(fan), K, MQ, C)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 3, 8, 11])
def test_small_topk_keeps_lax_tie_order(k):
    """Heavy ties: lowest index first, as jax.lax.top_k (k <= 8 by argmax
    passes, larger k by a stable sort)."""
    x = np.random.default_rng(k).integers(0, 4, size=(6, 40)).astype(np.float32)
    got = spec_math._small_topk_indices(t(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1]))


def test_forked_recovery_tokens_match_jax():
    """Fork selection with ties in the logits, hit and miss rows, and
    different hit/miss fan-out lists."""
    rng = np.random.default_rng(5)
    B, K, V = 4, 3, 50
    logits = rng.integers(0, 6, size=(B, K + 1, V)).astype(np.float32)
    returned = rng.integers(0, V, size=(B, K + 1)).astype(np.int32)
    hits = np.array([1, 0, 1, 0], np.int32)
    hit_list, miss_list = [3, 2, 2, 1], [1, 2, 2, 3]
    got = spec_math.get_forked_recovery_tokens(t(logits), t(hits), t(returned),
                                               hit_list, miss_list)
    want = jsm.get_forked_recovery_tokens(jnp.asarray(logits), jnp.asarray(hits),
                                          jnp.asarray(returned), hit_list, miss_list)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampler_x_rescaling_matches_jax():
    probs = np.random.default_rng(6).dirichlet(np.ones(30), size=(3, 2)).astype(np.float32)
    close(spec_math.apply_sampler_x_rescaling(t(probs), 1.7, 2),
          jsm.apply_sampler_x_rescaling(jnp.asarray(probs), 1.7, 2))


def test_tree_sampling_boosts_top_fan_out():
    """Tree mode with sampler_x draws from the rescaled distribution; greedy
    rows still take the argmax."""
    logits = torch.tensor([[1.0, 0.5, 0.0, -0.5]]).repeat(6000, 1)
    temps = torch.ones(6000)
    got = sampler.sample(logits, temps, torch.Generator().manual_seed(0),
                         sampler_x=3.0, fan_out=1, is_tree=True)
    want = spec_math.apply_sampler_x_rescaling(torch.softmax(logits[:1], -1), 3.0, 1)[0]
    freq = torch.bincount(got, minlength=4).float() / 6000
    np.testing.assert_allclose(freq.numpy(), want.numpy(), atol=0.03)
    greedy = sampler.sample(logits[:2], torch.zeros(2), None, sampler_x=3.0,
                            fan_out=1, is_tree=True)
    assert greedy.tolist() == [0, 0]


def _verify_inputs(seed, B=5, K=3, V=40):
    rng = np.random.default_rng(seed)
    logits_p = rng.normal(size=(B, K + 1, V)).astype(np.float32) * 3
    logits_q = rng.normal(size=(B, K, V)).astype(np.float32) * 3
    spec = np.zeros((B, K + 1), np.int32)
    spec[:, 0] = rng.integers(0, V, size=B)
    # Rows accept 0..K draft tokens greedily: copy the target's argmax.
    preds = logits_p.argmax(-1)
    for b in range(B):
        n = b % (K + 1)
        spec[b, 1:1 + n] = preds[b, :n]
        spec[b, 1 + n:] = (preds[b, n:K] + 1) % V
    return logits_p, logits_q, spec


def test_verify_greedy_matches_jax():
    lp, lq, spec = _verify_inputs(7)
    B = spec.shape[0]
    temps = np.zeros(B, np.float32)
    for hits in (None, np.array([1, 0, 1, 0, 1], np.int32)):
        got = tverify.verify(t(lp), t(lq), t(spec), t(temps), t(temps),
                             None if hits is None else t(hits), None)
        want = jverify.verify(jnp.asarray(lp), jnp.asarray(lq), jnp.asarray(spec),
                              jnp.asarray(temps), jnp.asarray(temps),
                              None if hits is None else jnp.asarray(hits),
                              jax.random.PRNGKey(0))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    suffixes, _ = tverify.build_suffixes(spec, got[0].numpy())
    assert [len(s) for s in suffixes] == [1, 2, 3, 4, 1]
    assert [s[1:] for s in suffixes] == [spec[b, 1:len(s)].tolist()
                                         for b, s in enumerate(suffixes)]


@pytest.mark.parametrize("mode", ["hits", "jit", "sampler_x", "top_p"])
def test_verify_sampled_matches_jax_with_same_noise(mode):
    """temp > 0: the port's verify fed JAX's own uniforms and Gumbel noise
    (re-drawn here from JAX's key split) gives JAX's acceptance lengths and
    recovery tokens exactly. Rows mix greedy and sampled temperatures."""
    lp, lq, spec = _verify_inputs(8)
    B, Kp1, V = lp.shape
    K = Kp1 - 1
    tt = np.array([0.8, 1.0, 0.0, 0.6, 1.3], np.float32)
    tq = np.array([0.9, 1.0, 0.7, 0.0, 1.3], np.float32)
    hits = np.array([1, 0, 1, 1, 0], np.int32)
    kw = dict(jit_speculate=mode == "jit")
    if mode == "sampler_x":
        kw.update(sampler_x=1.5, async_fan_out=2)
    warp = {}
    if mode == "top_p":
        warp = dict(top_p=np.array([0.9, 1.0, 0.5, 0.8, 0.95], np.float32),
                    top_k=np.array([0, 5, 0, 3, 10], np.int32))
    key = jax.random.PRNGKey(11)
    _, k_acc, k_adj, k_p = jax.random.split(key, 4)
    noise = (np.asarray(jax.random.uniform(k_acc, (B, K), dtype=jnp.float32)),
             np.asarray(jax.random.gumbel(k_adj, (B, V), dtype=jnp.float32)),
             np.asarray(jax.random.gumbel(k_p, (B, V), dtype=jnp.float32)))
    got = tverify.verify(t(lp), t(lq), t(spec), t(tt), t(tq), t(hits), None,
                         noise=tuple(t(n) for n in noise),
                         **{k: t(v) for k, v in warp.items()}, **kw)
    want = jverify.verify(jnp.asarray(lp), jnp.asarray(lq), jnp.asarray(spec),
                          jnp.asarray(tt), jnp.asarray(tq), jnp.asarray(hits), key,
                          **{k: jnp.asarray(v) for k, v in warp.items()}, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_launch_counter_is_thread_safe():
    """The target and the draft thread both count kernel launches: 8
    threads, with a tiny switch interval, lose no increment."""
    import sys
    import threading

    from ssd_tpu_torch.ops import cuda_lib

    before, interval = att.tree_attention.launches, sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [cuda_lib.count_launch(att.tree_attention)
                                                    for _ in range(2000)])
                   for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert att.tree_attention.launches - before == 8 * 2000
    finally:
        sys.setswitchinterval(interval)
        att.tree_attention.launches = before


def test_tree_wrapper_refuses_non_cuda_devices():
    q = torch.zeros(1, 4, 4, 64, device="meta")
    kv = torch.zeros(2, 64, 128, device="meta")
    i32 = torch.zeros(1, 4, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        att.tree_attention(q, kv, i32[:, :1], i32[0, :1], i32, 0, 1, 64, 0.125)
