"""The port's attention at every head dim the kernels take (even hd in
[16, 256], ops/attention.py::kernel_width), against the JAX package on the
same numpy inputs:

- the width rule: which hd the wrappers take or refuse, and each one's
  padded width, chunks and copy granules;
- the plain versions of K1-K5 at hd 48, 100 and 192 against the TPU's row
  #4 (`paged_attention`, `paged_attention_prefill`), row #1
  (`flat_prefill_attention`) and row #6 (`tree_attention`) in interpret
  mode, and at hd 192 against v2/v3 (rows #2, #3, #5, #8, #9) in fp32 and
  in the s8 mode; fp32 at 1e-4 (PERF.md §2), the s8 mode at
  tests/test_torch_kv_quant.py's s8 tolerance (the two quantize p over
  different tiles);
- kv_quant="int8_mxu" takes the s8 arithmetic only where JAX's router
  does ((2 hd) % 128 == 0 and Hkv * Q * G <= 512): at hd 100, or above 512
  rows at hd 64, it equals the int8 result and JAX's routed one;
- end to end on a tiny OpenLLaMA-shaped checkpoint (hd 100, 4/4 heads so
  G = 1, 2 layers, eps 1e-6, rope theta 1e4, no head_dim in its config,
  written without transformers): AR, sync SD and async SSD greedy tokens
  in fp32 equal ssd_tpu's, and so do the int8 cache's AR tokens, with
  int8_mxu giving int8's.
"""

import json
import os

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
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.utils.loader import save_safetensors
from tests.torch_cases import flat_meta, paged_case, tree_case
from tests.utils_models import random_prompt, rng


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker keeps its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)       # fp32: reduction order
S8_TOL = dict(rtol=0.05, atol=0.03)    # the s8 tiles differ (module docstring)
BS = 16
HDS = [48, 100, 192]


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


def quant_layer(kv):
    """The int8 pair of a cache [Hkv, S, 2hd] (V x 3), by ssd_tpu's store_kv."""
    Hkv, S, hd2 = kv.shape
    hd = hd2 // 2
    x = kv.transpose(1, 0, 2)
    layer = jatt.store_kv((jnp.zeros((Hkv, S, hd2), jnp.int8), jnp.full((Hkv, 2, S), 1e-10, jnp.float32)),
                          jnp.asarray(x[..., :hd]), jnp.asarray(x[..., hd:] * 3.0),
                          jnp.arange(S, dtype=jnp.int32))
    return tuple(np.asarray(a) for a in layer)


# ---------------------------------------------------------------------------
# The width rule
# ---------------------------------------------------------------------------


def test_width_rule():
    """Every even hd in [16, 256] is taken at the next of 64/128/192/256;
    odd, smaller and larger ones raise. Chunks: the paged kernels' 128
    everywhere, the tree kernels' the longest that fits a block's shared
    memory (at hd 64 and 128 the values chosen on the card), each a whole
    number of 64-position tiles. Copy pieces: 16 bytes at hd 64/128, 8 for
    hd 100's bf16 rows (the V half starts at byte 200), 4 for its int8
    rows, 2 for an int8 row of hd 2 mod 4."""
    assert att.KERNEL_HEAD_DIMS == tuple(range(16, 257, 2))
    for hd, hp in ((16, 64), (48, 64), (64, 64), (66, 128), (80, 128), (100, 128),
                   (128, 128), (130, 192), (192, 192), (194, 256), (256, 256)):
        assert att.kernel_width(hd) == hp, hd
    for hd in (0, 14, 15, 99, 101, 257, 258, 512):
        with pytest.raises(ValueError, match="even head_dim in \\[16, 256\\]"):
            att.kernel_width(hd)
    assert set(att.PAGED_CHUNK) == set(att.TREE_CHUNK) == {
        (hd, q8) for hd in att.KERNEL_HEAD_DIMS for q8 in (False, True)}
    assert set(att.PAGED_CHUNK.values()) == {128}
    for (hd, q8), chunk in att.TREE_CHUNK.items():
        kinds = (1, 2) if q8 else (0,)
        assert chunk % att.TREE_S8_TILE == 0 and chunk <= att.SPLIT_MAX_SPAN
        assert all(att.tree_smem_bytes(hd, k, qb, chunk) <= att.SMEM_MAX
                   for k in kinds for qb in (2, 4)), (hd, q8)
    assert [att.TREE_CHUNK[(hd, False)] for hd in (64, 100, 128, 192, 256)] == [256, 128, 128, 64, 64]
    assert [att.TREE_CHUNK[(hd, True)] for hd in (64, 100, 128, 192, 256)] == [256] * 5
    assert [att.copy_granule(100 * e) for e in (4, 2, 1)] == [16, 8, 4]
    assert [att.copy_granule(hd * 2) for hd in (64, 128, 48, 98)] == [16, 16, 16, 4]
    assert att.copy_granule(50) == 2


def test_s8_route_rule():
    """kv_quant="int8_mxu" takes the s8 arithmetic where JAX's router sends
    it to its s8 kernel: hd a multiple of 64 and Hkv * rows <= 512."""
    assert att.takes_s8(64, 8, 5 * 4) and att.takes_s8(192, 2, 256)
    assert not att.takes_s8(100, 32, 1)          # OpenLLaMA-3B's decode
    assert not att.takes_s8(96, 8, 4)
    assert not att.takes_s8(128, 8, 10 * 8)      # 640 rows: a tp rank's tree step at G 8


# ---------------------------------------------------------------------------
# The plain versions against the TPU kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", HDS)
def test_paged_plain_matches_row4(hd):
    """K2's plain version (verify, qeff < Q on one row, a ghost row) against
    row #4, `paged_attention`, in interpret mode; K4's over the int8 pair
    against JAX's int8 oracle."""
    B, Q, Hq, Hkv, M = 3, 5, 4, 2, 6
    q, kv, bt, ctx = paged_case(hd, B, Q, Hq, Hkv, hd, BS, M, [70, 33], ghosts=1)
    qeff = np.asarray([5, 3, 5], np.int32)
    scale, C = hd ** -0.5, M * BS
    got = att.paged_attention(t(q), t(kv), t(bt), t(ctx), t(qeff), BS, scale)
    want = patt.paged_attention(q, kv, bt, ctx, qeff, BS, C, scale, interpret=True)
    close(got[0], np.asarray(want)[0])
    close(got[1, :3], np.asarray(want)[1, :3])   # row 1's live queries
    layer = quant_layer(kv)
    got8 = att.paged_attention(t(q), tuple(t(a) for a in layer), t(bt), t(ctx), t(qeff), BS, scale)
    close(got8, jatt.paged_attention(q, tuple(jnp.asarray(a) for a in layer), bt, ctx, BS, C,
                                     scale, qeff=qeff))


@pytest.mark.parametrize("hd", HDS)
def test_prefill_plain_matches_row4_prefill_and_row1(hd):
    """A ragged, prefix-cached prefill: K1's plain version over the flat
    page stream against row #4's prefill wrapper (`paged_attention_prefill`,
    its live rows) and row #1 (`flat_prefill_attention`), in interpret mode."""
    Hq, Hkv, M, Q = 4, 2, 6, 48
    lens, new = [70, 40], [48, 23]
    q, kv, bt, ctx = paged_case(10 + hd, 2, Q, Hq, Hkv, hd, BS, M, lens)
    scale, C = hd ** -0.5, M * BS
    qeff = np.asarray(new, np.int32)
    lo, hi, pages_per = flat_meta(lens, new, BS, sum(new))
    pages = np.concatenate([bt[s, :pages_per[s]] for s in range(2)]).astype(np.int32)
    q_flat = np.concatenate([q[s, :new[s]] for s in range(2)])
    got = att.flat_prefill_attention(t(q_flat), t(kv), t(pages), t(lo), t(hi), BS, scale)
    want = np.asarray(patt.paged_attention_prefill(q, kv, bt, ctx, qeff, BS, C, scale,
                                                   interpret=True))
    close(got, np.concatenate([want[s, :new[s]] for s in range(2)]))
    flat = patt.flat_prefill_attention(q_flat, kv, pages, lo, hi, BS, scale, tq=64, tk=64,
                                       interpret=True)
    close(got, flat)


@pytest.mark.parametrize("hd", HDS)
def test_tree_plain_matches_row6(hd):
    """K3's plain version (a miss row, a ghost row) against row #6,
    `tree_attention`, in interpret mode; K5's over the int8 pair against
    JAX's int8 oracle."""
    K, fans, Hq, Hkv, M, step = 3, [2, 2, 1, 1], 4, 2, 8, 1
    q, kv, bt, ctx, fan = tree_case(20 + hd, 3, K, fans, Hq, Hkv, hd, BS, M, [50, 21], step,
                                    ghosts=1)
    scale, C = hd ** -0.5, M * BS
    got = att.tree_attention(t(q), t(kv), t(bt), t(ctx), t(fan), step, K, BS, scale)
    want = patt.tree_attention(q, kv, bt, ctx, fan, jnp.int32(step), K, BS, C, scale,
                               interpret=True)
    close(got[:2], np.asarray(want)[:2])
    layer = quant_layer(kv)
    got8 = att.tree_attention(t(q), tuple(t(a) for a in layer), t(bt), t(ctx), t(fan), step, K,
                              BS, scale)
    close(got8, jatt.tree_attention(q, tuple(jnp.asarray(a) for a in layer), bt, ctx, fan, step,
                                    K, BS, C, scale))


def test_v2_v3_at_hd192():
    """At hd 192 JAX's router takes v2 (B = 1) and v3 (B > 1, the int8
    cache): the port's plain versions against them in interpret mode: the
    paged v2 in fp32 and v3 over the int8 cache ("int8" at TOL, int8_mxu's
    s8 arithmetic at S8_TOL), the tree step's v3 in fp32 and in the s8
    mode."""
    hd, Hq, Hkv, M = 192, 4, 2, 4
    C, scale = M * BS, hd ** -0.5
    q, kv, bt, ctx = paged_case(7, 2, 5, Hq, Hkv, hd, BS, M, [60, 29])
    qeff = np.full(2, 5, np.int32)
    v2 = patt.paged_attention_v2(q[:1], kv, bt[:1], ctx[:1], qeff[:1], BS, C, scale, interpret=True)
    close(att.paged_attention(t(q[:1]), t(kv), t(bt[:1]), t(ctx[:1]), t(qeff[:1]), BS, scale), v2)
    layer = quant_layer(kv)
    jl, pl = tuple(jnp.asarray(a) for a in layer), tuple(t(a) for a in layer)
    for s8, tol in ((False, TOL), (True, S8_TOL)):
        want = patt.paged_attention_v3(q, jl, bt, ctx, qeff, BS, C, scale, seqs_per_step=2,
                                       interpret=True, s8=s8)
        close(att.paged_attention(t(q), pl, t(bt), t(ctx), t(qeff), BS, scale, s8=s8), want, tol)

    K, fans, step = 3, [2, 2, 1, 1], 2
    q, kv, bt, ctx, fan = tree_case(8, 2, K, fans, Hq, Hkv, hd, BS, M, [20, 9], step)
    got = att.tree_attention(t(q), t(kv), t(bt), t(ctx), t(fan), step, K, BS, scale)
    close(got, patt.tree_attention_v3(q, kv, bt, ctx, fan, jnp.int32(step), K, BS, C, scale,
                                      seqs_per_step=2, interpret=True))
    layer = quant_layer(kv)
    jl, pl = tuple(jnp.asarray(a) for a in layer), tuple(t(a) for a in layer)
    want = patt.tree_attention_v3(q, jl, bt, ctx, fan, jnp.int32(step), K, BS, C, scale,
                                  seqs_per_step=2, interpret=True, s8=True)
    close(att.tree_attention(t(q), pl, t(bt), t(ctx), t(fan), step, K, BS, scale, s8=True),
          want, S8_TOL)


@pytest.mark.parametrize("hd,Hq,Hkv,Q", [(100, 4, 4, 1), (100, 8, 2, 5), (64, 64, 8, 9)])
def test_int8_mxu_where_jax_drops_s8(hd, Hq, Hkv, Q):
    """Where JAX's router does not take its s8 kernel (hd 100; or 576 rows
    at hd 64) kv_quant="int8_mxu" computes the int8 result: the port's
    wrappers with s8 give int8's bits, and match JAX's routed
    `paged_attention_best(..., s8=True)` / `tree_attention_best` in
    interpret mode."""
    M = 4
    C, scale = M * BS, hd ** -0.5
    q, kv, bt, ctx = paged_case(hd + Q, 2, Q, Hq, Hkv, hd, BS, M, [50, 21])
    qeff = np.full(2, Q, np.int32)
    layer = quant_layer(kv)
    jl, pl = tuple(jnp.asarray(a) for a in layer), tuple(t(a) for a in layer)
    args = (t(q), pl, t(bt), t(ctx), t(qeff), BS, scale)
    mxu = att.paged_attention(*args, s8=True)
    assert torch.equal(mxu, att.paged_attention(*args))
    close(mxu, patt.paged_attention_best(q, jl, bt, ctx, qeff, BS, C, scale, interpret=True,
                                         s8=True))
    if Q == 1:
        return
    K, fans, step = Q - 1, [2] + [1] * (Q - 1), 0
    MQ = sum(fans)
    q, kv, bt, ctx, fan = tree_case(hd, 2, K, fans, Hq, Hkv, hd, BS, M, [30, 11], step)
    layer = quant_layer(kv)
    jl, pl = tuple(jnp.asarray(a) for a in layer), tuple(t(a) for a in layer)
    assert att.takes_s8(hd, Hkv, MQ * Hq // Hkv) is False
    targs = (t(q), pl, t(bt), t(ctx), t(fan), step, K, BS, scale)
    mxu = att.tree_attention(*targs, s8=True)
    assert torch.equal(mxu, att.tree_attention(*targs))
    close(mxu, patt.tree_attention_best(q, jl, bt, ctx, fan, jnp.int32(step), K, BS, C, scale,
                                        interpret=True, s8=True))


# ---------------------------------------------------------------------------
# End to end: OpenLLaMA-3B's geometry at a tiny width
# ---------------------------------------------------------------------------

ENGINE = dict(max_model_len=256, max_num_batched_tokens=512, kvcache_block_size=16,
              num_kvcache_blocks=64, max_num_seqs=3, dtype="float32")
PROMPTS = [random_prompt(rng(180 + i), 8, 20) for i in range(3)]
N_NEW = 16
SPEC = {"sd": dict(speculate=True, speculate_k=3),
        "ssd": dict(speculate=True, speculate_k=3, draft_async=True, async_fan_out=2)}


def open_llama_checkpoint(d, seed, layers, hidden=400, heads=4, intermediate=256, vocab=128,
                          scale=0.08):
    """A tiny checkpoint of OpenLLaMA-3B's form (LlamaForCausalLM, hd 100,
    as many KV heads as query heads, eps 1e-6, no head_dim in the config;
    num_key_value_heads and rope_theta stated, since both packages' defaults
    differ from HF's): N(0, scale) fp32 weights, norms at one."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=g) * scale

    D = hidden
    tensors = {"model.embed_tokens.weight": w(vocab, D), "model.norm.weight": torch.ones(D),
               "lm_head.weight": w(vocab, D)}
    for i in range(layers):
        p = f"model.layers.{i}."
        tensors.update({
            p + "input_layernorm.weight": torch.ones(D),
            p + "post_attention_layernorm.weight": torch.ones(D),
            p + "self_attn.q_proj.weight": w(D, D), p + "self_attn.k_proj.weight": w(D, D),
            p + "self_attn.v_proj.weight": w(D, D), p + "self_attn.o_proj.weight": w(D, D),
            p + "mlp.gate_proj.weight": w(intermediate, D),
            p + "mlp.up_proj.weight": w(intermediate, D),
            p + "mlp.down_proj.weight": w(D, intermediate)})
    save_safetensors(os.path.join(d, "model.safetensors"), tensors)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                   "vocab_size": vocab, "hidden_size": D, "intermediate_size": intermediate,
                   "num_hidden_layers": layers, "num_attention_heads": heads,
                   "num_key_value_heads": heads, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
                   "max_position_embeddings": 2048, "tie_word_embeddings": False,
                   "torch_dtype": "float32", "eos_token_id": 2, "bos_token_id": 1}, f)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(target, draft): 2 layers, and a 1-layer draft of the same geometry."""
    out = []
    for name, seed, layers in (("target", 0, 2), ("draft", 5, 1)):
        d = str(tmp_path_factory.mktemp(f"open_llama_{name}"))
        open_llama_checkpoint(d, seed, layers)
        out.append(d)
    return tuple(out)


def port_run(path, **kw):
    llm = ssd_tpu_torch.LLM(path, device="cpu", **ENGINE, **kw)
    try:
        assert llm.model_runner.arch.head_dim == 100
        outs, m = llm.generate([list(p) for p in PROMPTS],
                               SamplingParams(temperature=0.0, max_new_tokens=N_NEW,
                                              ignore_eos=True), use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs], m


def jax_run(path, **kw):
    llm = JaxLLM(path, use_pallas=False, **ENGINE, **kw)
    try:
        outs, m = llm.generate([list(p) for p in PROMPTS],
                               JaxSamplingParams(temperature=0.0, max_new_tokens=N_NEW,
                                                 ignore_eos=True), use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs], m


@pytest.fixture(scope="module")
def ar(pair):
    return port_run(pair[0])[0]


def test_open_llama_ar_matches_jax(pair, ar):
    """fp32 AR greedy tokens at hd 100, G = 1 equal ssd_tpu's; so do the
    int8 cache's, and int8_mxu gives int8's (no s8 kernel at hd 100)."""
    assert ar == jax_run(pair[0])[0]
    int8 = port_run(pair[0], kv_quant="int8")[0]
    assert int8 == jax_run(pair[0], kv_quant="int8")[0]
    assert port_run(pair[0], kv_quant="int8_mxu")[0] == int8


@pytest.mark.parametrize("mode", list(SPEC))
def test_open_llama_spec_matches_jax_and_ar(pair, ar, mode):
    """Sync SD and async SSD (K=3, fan-out 2) with a 1-layer hd-100 draft:
    greedy tokens equal the port's AR and ssd_tpu's same engine, with the
    same accepted lengths."""
    got, m = port_run(pair[0], draft=pair[1], **SPEC[mode])
    want, jm = jax_run(pair[0], draft=pair[1], **SPEC[mode])
    assert got == ar == want
    key = "accepted_suffix_lens_with_recovery"
    assert m[key] and list(m[key]) == list(jm[key])
