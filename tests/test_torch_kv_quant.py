"""The port's int8 KV cache (Config.kv_quant "int8" / "int8_mxu") against the
JAX package on the same numpy inputs:

- store_kv writes the same int8 bytes and f32 scales as ssd_tpu's
  (quantize_kv divides, rounds half to even, clips, floors the scale);
- the plain paged, tree and flat-prefill versions over the int8 pair match
  ssd_tpu's jnp oracle and its int8 Pallas kernels (interpret mode) in fp32
  at 1e-5; the s8 plain versions (kv_quant="int8_mxu") match the Pallas s8
  kernels at tests/test_kv_quant.py's tolerance, rtol 0.05 / atol 0.03,
  because the two quantize the softmax weights over different tiles of
  positions (the port's kernel tile against the TPU's KV chunk);
- end to end on the tiny Llama of tests/test_kv_quant.py (hidden 256, head
  dim 64, 2 layers, fp32): AR greedy tokens and the cache after prefill
  against ssd_tpu, sync SD and async SSD against the port's AR, chunked
  prefill, a prefix-cache hit and preemption against AR, and int8_mxu's
  determinism.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu.ops import attention as jatt
from ssd_tpu.ops import pallas_attention as patt
from ssd_tpu import SamplingParams as JaxSamplingParams
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.config import Config
from ssd_tpu_torch.engine.model_runner import kv_block_bytes
from ssd_tpu_torch.models.transformer import Arch
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops.spec_math import tree_attention_mask
from tests.torch_cases import flat_meta, paged_case, tree_case
from tests.utils_models import make_tiny_llama, random_prompt, rng

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)       # fp32: reduction order and dequant order
S8_TOL = dict(rtol=0.05, atol=0.03)    # the s8 tiles differ (module docstring)
PROMPTS = [[1, 5, 9, 2, 7, 3, 11, 4], [4, 4, 8, 1], [2, 9, 9, 3, 6]]
ENGINE = dict(max_model_len=128, max_num_batched_tokens=512, kvcache_block_size=16,
              num_kvcache_blocks=48, max_num_seqs=4, seed=0)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


def quant_layer(kv, fill, v_scale=3.0):
    """An int8 layer holding kv's first `fill` slots (V times v_scale, as in
    tests/test_kv_quant.py), quantized by ssd_tpu's store_kv, as numpy (data
    [Hkv, S, 2hd] int8, scales [Hkv, 2, S] f32)."""
    Hkv, S, hd2 = kv.shape
    hd = hd2 // 2
    layer = (jnp.zeros((Hkv, S, hd2), jnp.int8), jnp.full((Hkv, 2, S), 1e-10, jnp.float32))
    x = kv[:, :fill].transpose(1, 0, 2)                     # [fill, Hkv, 2hd]
    layer = jatt.store_kv(layer, jnp.asarray(x[..., :hd]), jnp.asarray(x[..., hd:] * v_scale),
                          jnp.arange(fill, dtype=jnp.int32))
    return tuple(np.asarray(a) for a in layer)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_kv_bytes_equal_jax(dtype):
    """Same k and v, same int8 bytes and scales, ghost slots dropped from
    both halves; a zero row takes the 1e-10 floor."""
    r = np.random.default_rng(0)
    T, Hkv, hd, S = 24, 2, 64, 64
    k = (r.normal(size=(T, Hkv, hd)) * r.uniform(0.01, 5, size=(T, Hkv, 1))).astype(np.float32)
    v = r.normal(size=(T, Hkv, hd)).astype(np.float32) * 3
    k[3] = 0.0
    k[5, :, :4] = [0.5, -0.5, 1.5, 127.0]     # exact halves after scaling
    slots = r.permutation(S)[:T].astype(np.int32)
    dropped = slots[[2, 7, 11]].copy()        # slots no row writes
    slots[[2, 7, 11]] = -1
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    layer = (torch.zeros(Hkv, S, 2 * hd, dtype=torch.int8),
             torch.full((Hkv, 2, S), 1e-10))
    att.store_kv(layer, t(k).to(tdt), t(v).to(tdt), t(slots))
    jlayer = jatt.store_kv(
        (jnp.zeros((Hkv, S, 2 * hd), jnp.int8), jnp.full((Hkv, 2, S), 1e-10, jnp.float32)),
        jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(slots))
    np.testing.assert_array_equal(layer[0].numpy(), np.asarray(jlayer[0]))
    np.testing.assert_array_equal(layer[1].numpy(), np.asarray(jlayer[1]))
    assert (layer[0].numpy()[:, dropped] == 0).all()        # ghosts wrote nothing
    assert (layer[1].numpy()[:, :, dropped] == np.float32(1e-10)).all()
    assert layer[1][0, 0, slots[3]].item() == np.float32(1e-10)   # the zero row


def _paged(Q, B, ctx_lens, ghosts, seed, v_scale=3.0):
    q, kv, bt, ctx = paged_case(seed, B, Q, 8, 2, 64, 16, 8, ctx_lens, ghosts)
    return (q, quant_layer(kv, kv.shape[1] - 16, v_scale), bt, ctx,
            np.full(B, Q, np.int32))


@pytest.mark.parametrize("Q", [1, 5])
def test_int8_paged_plain_matches_jax(Q):
    """Q=1 decode and Q=5 verify, one ghost row: the plain version against
    the jnp oracle (every row) and the int8 v3 kernel in interpret mode
    (live rows)."""
    B, ghosts = 3, 1
    q, layer, bt, ctx, qeff = _paged(Q, B, [120, 37], ghosts, 40 + Q)
    scale, C = 64 ** -0.5, 8 * 16
    got = att.paged_attention(t(q), tuple(t(a) for a in layer), t(bt), t(ctx), t(qeff),
                              16, scale)
    jl = tuple(jnp.asarray(a) for a in layer)
    close(got, jatt.paged_attention(q, jl, bt, ctx, 16, C, scale, qeff=qeff))
    want = patt.paged_attention_v3(q, jl, bt, ctx, qeff, 16, C, scale, seqs_per_step=2,
                                   interpret=True)
    close(got[:B - ghosts], np.asarray(want)[:B - ghosts])
    assert got.abs().max() > 0


def _paged_mask(ctx, Q, C):
    ctx = t(ctx).long()
    limit = ctx[:, None] - Q + torch.arange(Q)[None, :]
    pos = torch.arange(C)[None, None, :]
    return (pos <= limit[:, :, None]) & (pos < ctx[:, None, None])


@pytest.mark.parametrize("Q", [1, 5])
def test_int8_s8_paged_plain_matches_jax_s8(Q):
    """kv_quant="int8_mxu" against the Pallas s8 kernel, whose chunk here
    is the whole 128-position table: the s8 arithmetic at that tile gives
    its output to fp32 rounding (the same integers), and the port's own tile
    (PAGED_S8_TILE) stays within the s8 tolerance. K and V standard normal."""
    B, ghosts = 3, 1
    q, layer, bt, ctx, qeff = _paged(Q, B, [120, 37], ghosts, 50 + Q, v_scale=1.0)
    scale, C, live = 64 ** -0.5, 8 * 16, B - ghosts
    tl, jl = tuple(t(a) for a in layer), tuple(jnp.asarray(a) for a in layer)
    want = np.asarray(patt.paged_attention_v3(q, jl, bt, ctx, qeff, 16, C, scale,
                                              seqs_per_step=2, interpret=True, s8=True))
    same_tile = att._s8_attention_plain(t(q), tl, t(bt), 16, _paged_mask(ctx, Q, C), scale, C)
    close(same_tile[:live], want[:live])
    got = att.paged_attention(t(q), tl, t(bt), t(ctx), t(qeff), 16, scale, s8=True)
    close(got[:live], want[:live], S8_TOL)
    assert torch.isfinite(got).all() and got[:live].abs().max() > 0


@pytest.mark.parametrize("step", [0, 2])
def test_int8_tree_plain_matches_jax(step):
    """Tree step 0 and K-1 with a warm-up ghost row: the plain version against
    the jnp oracle and the int8 tree v3 kernel (interpret); its s8 form
    against the Pallas s8 kernel, as in the paged test."""
    K, fans, B, ghosts = 3, [3, 2, 2, 1], 3, 1
    q, kv, bt, ctx, fan = tree_case(60 + step, B, K, fans, 8, 2, 64, 16, 8, [70, 30],
                                    step, ghosts)
    layer = quant_layer(kv, kv.shape[1] - 16, v_scale=1.0)
    scale, C, live = 64 ** -0.5, 8 * 16, B - ghosts
    tl, jl = tuple(t(a) for a in layer), tuple(jnp.asarray(a) for a in layer)
    got = att.tree_attention(t(q), tl, t(bt), t(ctx), t(fan), step, K, 16, scale)
    close(got, jatt.tree_attention(q, jl, bt, ctx, fan, step, K, 16, C, scale))
    assert torch.isfinite(got).all()
    for s8, tol in ((False, TOL), (True, S8_TOL)):
        want = np.asarray(patt.tree_attention_v3(
            q, jl, bt, ctx, fan, jnp.int32(step), K, 16, C, scale, seqs_per_step=2,
            interpret=True, s8=s8))
        got = att.tree_attention(t(q), tl, t(bt), t(ctx), t(fan), step, K, 16, scale, s8=s8)
        close(got[:live], want[:live], tol)
    mask = tree_attention_mask(t(ctx), step, t(fan), K, sum(fans), C)
    same_tile = att._s8_attention_plain(t(q), tl, t(bt), 16, mask, scale, C)
    close(same_tile[:live], want[:live])   # the Pallas chunk is the whole table


def test_int8_flat_prefill_plain_matches_jax():
    """Three prompts, two prefix-cached, padding rows and pages: the plain
    version against dense_pages (dequantizing) + the jnp flat prefill."""
    _, kv, bt, _ = paged_case(70, 3, 1, 8, 2, 64, 16, 8, [40, 9, 77])
    layer = quant_layer(kv, kv.shape[1])
    lo, hi, pages_per = flat_meta([40, 9, 77], [40, 3, 20], 16, 70)
    pages = np.concatenate([bt[s, :pages_per[s]] for s in range(3)])
    pages = np.pad(pages, (0, 2), constant_values=-1).astype(np.int32)
    q = np.random.default_rng(71).normal(size=(70, 8, 64)).astype(np.float32)
    scale = 64 ** -0.5
    got = att.flat_prefill_attention(t(q), tuple(t(a) for a in layer), t(pages), t(lo),
                                     t(hi), 16, scale)
    dense = jatt.dense_pages(tuple(jnp.asarray(a) for a in layer), jnp.asarray(pages), 16)
    close(got, jatt.flat_prefill_attention(q, dense, lo, hi, scale))
    assert got[63:].abs().max() == 0


def test_s8_plain_close_to_dequant():
    """The s8 plain version tracks the dequantizing one within the s8
    tolerance (q and the weights carry about 1/254 of their row's or tile's
    largest value), as the TPU's s8 kernel tracks its dequant kernel."""
    q, layer, bt, ctx, qeff = _paged(5, 2, [120, 64], 0, 80)
    tl = tuple(t(a) for a in layer)
    s8 = att.paged_attention_plain(t(q), tl, t(bt), t(ctx), t(qeff), 16, 0.125, s8=True)
    deq = att.paged_attention_plain(t(q), tl, t(bt), t(ctx), t(qeff), 16, 0.125)
    close(s8, deq, S8_TOL)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_kvq")
    make_tiny_llama(d, hidden=256, layers=2, seed=0)
    return str(d)


def port(model, **kw):
    return ssd_tpu_torch.LLM(model, device="cpu", dtype="float32",
                             **{**ENGINE, "kv_quant": "int8", **kw})


def greedy(n):
    return SamplingParams(temperature=0.0, max_new_tokens=n, ignore_eos=True)


def serve(llm, prompts, n):
    try:
        outs, m = llm.generate([list(p) for p in prompts], greedy(n), use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs], m


@pytest.fixture(scope="module")
def ar_int8(ckpt):
    return serve(port(ckpt), PROMPTS, 16)[0]


def test_int8_ar_matches_jax_tokens_and_cache(ckpt, ar_int8):
    """Greedy tokens equal ssd_tpu's int8 engine (jnp path). After one
    prefill of the three prompts the caches agree: scales within fp32
    rounding, int8 values within one step, and at most 0.1% of them off by
    that step (the K/V projections differ in their last bits between XLA
    and ATen, which moves a value across a rounding boundary now and then)."""
    jax_engine = JaxLLM(ckpt, dtype="float32", kv_quant="int8", use_pallas=False, **ENGINE)
    jouts, _ = jax_engine.generate(
        [list(p) for p in PROMPTS],
        JaxSamplingParams(temperature=0.0, max_new_tokens=16, ignore_eos=True),
        use_tqdm=False)
    assert ar_int8 == [o["token_ids"] for o in jouts]

    llm = port(ckpt)
    jax_engine = JaxLLM(ckpt, dtype="float32", kv_quant="int8", use_pallas=False, **ENGINE)
    for eng, sp in ((llm, greedy(4)), (jax_engine, JaxSamplingParams(
            temperature=0.0, max_new_tokens=4, ignore_eos=True))):
        for p in PROMPTS:
            eng.add_request(list(p), sp)
        eng.step()                                       # the prefill
    data, scales = (a.numpy() for a in llm.model_runner.kv_cache)
    jdata, jscales = (np.asarray(a) for a in jax_engine.model_runner.kv_cache)
    assert data.dtype == jdata.dtype == np.int8 and data.shape == jdata.shape
    np.testing.assert_allclose(scales, jscales, rtol=1e-5, atol=0)
    diff = np.abs(data.astype(np.int32) - jdata.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert (scales > 1e-10).sum() == sum(map(len, PROMPTS)) * 2 * 2 * 2  # L * Hkv * (K, V)


@pytest.mark.parametrize("mode", [
    dict(speculate=True, speculate_k=2),
    dict(speculate=True, speculate_k=2, draft_async=True, async_fan_out=2),
], ids=["sync", "async"])
def test_int8_spec_matches_ar(mode, ckpt, ar_int8):
    """Cross-mode determinism over the int8 cache (self-draft, as
    tests/test_kv_quant.py): sync SD and async SSD give the AR tokens, and
    the draft accepts fully."""
    got, m = serve(port(ckpt, draft=ckpt, **mode), PROMPTS, 16)
    assert got == ar_int8
    lens = m["accepted_suffix_lens_with_recovery"]
    assert lens and max(lens) == 3


@pytest.mark.parametrize("case", ["chunked", "prefix", "preempt"])
def test_int8_engine_features_match_ar(case, ckpt):
    """Chunked prefill, a prefix-cache hit (the second prompt prefills only
    its new tokens over the first one's int8 blocks) and preemption give the
    tokens of plain AR int8 runs, one prompt per engine."""
    n = 12
    if case == "chunked":
        prompts = [random_prompt(rng(5), 70, 71), random_prompt(rng(6), 8, 12)]
        got, _ = serve(port(ckpt, chunked_prefill=True, max_num_batched_tokens=32),
                       prompts, n)
    elif case == "prefix":
        base = random_prompt(rng(7), 40, 41)
        prompts = [base + [3, 4, 5], base + [9, 8]]
        llm = port(ckpt)
        seen, orig = [], llm.model_runner.run_prefill
        llm.model_runner.run_prefill = lambda seqs: (
            seen.append([s.num_cached_tokens for s in seqs]), orig(seqs))[1]
        got = [llm.generate([list(p)], greedy(n), use_tqdm=False)[0][0]["token_ids"]
               for p in prompts]
        assert seen == [[0], [32]]
    else:
        n = 40
        prompts = [random_prompt(rng(300 + i), 16, 24) for i in range(4)]
        llm = port(ckpt, num_kvcache_blocks=10)
        preempted, orig = [], llm.scheduler.preempt
        llm.scheduler.preempt = lambda seq: (preempted.append(seq.seq_id), orig(seq))[1]
        got, _ = serve(llm, prompts, n)
        assert preempted
    assert got == [serve(port(ckpt), [p], n)[0][0] for p in prompts]


def test_int8_mxu_engines_are_deterministic(ckpt, ar_int8):
    """Two int8_mxu engines give the same tokens; s8 arithmetic moves the
    attention by ~1/127 of a weight, so the tokens stay near int8's."""
    outs = [serve(port(ckpt, kv_quant="int8_mxu"), PROMPTS, 16)[0] for _ in range(2)]
    assert outs[0] == outs[1]
    assert all(len(o) == 16 for o in outs[0])
    agree = np.mean([a == b for x, y in zip(outs[0], ar_int8) for a, b in zip(x, y)])
    assert agree >= 0.5


def test_kv_quant_config_and_block_bytes(ckpt):
    """Config refuses an unknown kv_quant; an int8 block costs (hd + 4) bytes
    per (token, head, K|V), as ssd_tpu's _decide_num_blocks counts it; the
    pool is the (int8 data, f32 scales) pair with scales at 1e-10."""
    with pytest.raises(ValueError, match="kv_quant"):
        Config(ckpt, device="cpu", kv_quant="fp8")
    arch = Arch.from_model_config(Config(ckpt, device="cpu").hf_config)
    assert kv_block_bytes(arch, 16, torch.bfloat16, "int8") == 2 * 2 * 16 * 2 * (64 + 4)
    assert kv_block_bytes(arch, 16, torch.bfloat16) == 2 * 2 * 16 * 2 * 64 * 2
    llm = port(ckpt, kv_quant="int8_mxu")
    data, scales = llm.model_runner.kv_cache
    assert data.dtype == torch.int8 and data.shape == (2, 2, 48 * 16, 128)
    assert scales.shape == (2, 2, 2, 48 * 16) and (scales == np.float32(1e-10)).all()
    assert llm.model_runner.s8
