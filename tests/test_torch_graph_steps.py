"""The port's fixed-shape decode-side steps on the CPU: what lets one CUDA
graph per (step, batch bucket) replay them (engine/graphs.py).

- AR multi-step (M in {2, 4}) gives the port's and ssd_tpu's AR greedy
  tokens, through EOS truncation too;
- a padded bucket (B = 3 run at B_pad = 4 with a ghost row) gives the
  unpadded step's tokens exactly, the real rows' cache slots within fp32
  rounding, and leaves every other cache slot bit for bit as it was: the
  decode (Q = 1 and Q = K+1), the chain, both sync supersteps, the draft's
  tree build and the fused async superstep;
- ghost rows alone (a capture's warm-up) write nothing, in the fp and the
  int8 cache: the decode and the draft's tree build;
- the step functions read nothing back to the host: under a guard that
  makes Tensor.item / tolist / __bool__ / cpu / numpy raise they run
  greedy and sampled, the async tree build, exchange and superstep too;
- the same for the EAGLE-3 head's steps (engine/eagle_runner.py,
  engine/fused_sd.py): its chain, its tree build (hit and miss rows, with
  and without extend rows) and the fused sync superstep at B_pad 4 with a
  ghost row give the unpadded steps' outputs exactly and write nothing
  else, a ghost-only tree build writes nothing in the fp and the int8
  cache, and none of them reads back, greedy or sampled;
- the chain's graph key names its sampler;
- the launch record of a capture (ops/cuda_lib.py), the split-KV scratch
  and the fused-SD round ladder.
"""

import contextlib

import numpy as np
import pytest
import torch

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.llm import LLM as JaxLLM
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.config import Config
from ssd_tpu_torch.engine import async_fused, fused_sd
from ssd_tpu_torch.engine import eagle_runner as er
from ssd_tpu_torch.engine import model_runner as mr
from ssd_tpu_torch.engine.step import round_choices
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops import cuda_lib
from ssd_tpu_torch.ops.spec_math import FanOut
from tests.utils_models import make_tiny_eagle, make_tiny_llama, random_prompt, rng


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker (the HF oracle of the
    JAX package's tests) keeps its own thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024, kvcache_block_size=16,
              num_kvcache_blocks=64, max_num_seqs=4, dtype="float32")
BS, K = 16, 3
TOL = dict(rtol=1e-4, atol=1e-4)
PROMPTS = [random_prompt(rng(60 + i), 8, 24) for i in range(3)]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("graph_steps_llama")
    make_tiny_llama(d, seed=0)
    return str(d)


def generate(llm, n, ignore_eos=True):
    outs, _ = llm.generate([list(p) for p in PROMPTS],
                           SamplingParams(temperature=0.0, max_new_tokens=n,
                                          ignore_eos=ignore_eos), use_tqdm=False)
    return [o["token_ids"] for o in outs]


@pytest.fixture(scope="module")
def ar_tokens(model_dir):
    got = generate(ssd_tpu_torch.LLM(model_dir, device="cpu", **ENGINE), 30)
    jouts, _ = JaxLLM(model_dir, **ENGINE).generate(
        [list(p) for p in PROMPTS],
        JaxSamplingParams(temperature=0.0, max_new_tokens=30, ignore_eos=True),
        use_tqdm=False)
    assert got == [o["token_ids"] for o in jouts]
    return got


@pytest.mark.parametrize("M", [2, 4])
def test_multi_step_matches_ar_and_jax(M, model_dir, ar_tokens):
    """30 new tokens (not a multiple of M): the last chain overshoots and
    is truncated."""
    llm = ssd_tpu_torch.LLM(model_dir, device="cpu", multi_step=M, **ENGINE)
    assert generate(llm, 30) == ar_tokens


def test_multi_step_eos_truncation(model_dir, ar_tokens):
    """Without ignore_eos the output stops at the first EOS even mid-chain:
    with the EOS set to the sixth token AR emits for the first prompt,
    multi-step gives AR's outputs."""
    eos = ar_tokens[0][5]
    ar = generate(ssd_tpu_torch.LLM(model_dir, device="cpu", eos=eos, **ENGINE), 30,
                  ignore_eos=False)
    got = generate(ssd_tpu_torch.LLM(model_dir, device="cpu", eos=eos, multi_step=4,
                                     **ENGINE), 30, ignore_eos=False)
    assert got == ar
    assert len(got[0]) == ar_tokens[0].index(eos) + 1


def test_device_slot_of_matches_jax():
    """The slots a step computes on the device: ghost tables and positions
    past the table give -1."""
    import jax.numpy as jnp

    from ssd_tpu.engine.model_runner import slot_of as jax_slot_of

    bt = np.array([[3, 5, -1], [-1, -1, -1], [2, 0, 4]], np.int32)
    pos = np.array([0, 17, 33, 5, 47, 48, 60], np.int32)   # 48+ overshoots
    rows = np.array([0, 0, 0, 1, 2, 2, 2], np.int64)
    got = mr.device_slot_of(torch.from_numpy(bt), torch.from_numpy(pos),
                            torch.from_numpy(rows), 16)
    want = jax_slot_of(jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(rows), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- padded buckets ----------------------------------------------------------------


def _runner(path, seed, kv_quant=None, quantization=None):
    cfg = Config(path, device="cpu", dtype="float32", kvcache_block_size=BS,
                 num_kvcache_blocks=32, max_model_len=256, kv_quant=kv_quant,
                 quantization=quantization)
    runner = mr.ModelRunner(cfg)
    if kv_quant is None:
        runner.kv_cache = torch.from_numpy(np.random.default_rng(seed).normal(
            size=tuple(runner.kv_cache.shape)).astype(np.float32))
    return runner


def _cache(runner):
    c = runner.kv_cache
    return tuple(x.clone() for x in c) if isinstance(c, tuple) else c.clone()


N0 = np.array([20, 9, 33], np.int32)


def _tables(B_pad, R=1, shift=0):
    bt = np.full((B_pad, 16), -1, np.int32)
    for b, n in enumerate(N0):
        pages = -(-(int(n) + R * (K + 1) + 1) // BS)
        bt[b, :pages] = np.arange(pages) + 1 + 8 * b + shift
    return bt


def _pad(a, B_pad, fill):
    out = np.full((B_pad,) + a.shape[1:], fill, a.dtype)
    out[:len(a)] = a
    return torch.from_numpy(out)


def _check_bucket(run, runners, n_out):
    """run(B_pad) -> outputs (tensors with the batch on axis n_out's dim);
    B=3 and B_pad=4 from the same caches: real rows' outputs equal, the
    real rows' slots close, every other slot bit for bit unchanged."""
    before = [_cache(r) for r in runners]
    out3 = run(3)
    after3 = [_cache(r) for r in runners]
    for r, c in zip(runners, before):
        r.kv_cache.copy_(c)
    out4 = run(4)
    for a, b in zip(out3, out4):
        torch.testing.assert_close(b.narrow(n_out, 0, 3), a, rtol=0, atol=0)
    for r, c0, c3 in zip(runners, before, after3):
        touched = (c3 != c0).any(dim=-1)               # slots the real rows wrote
        np.testing.assert_allclose(r.kv_cache[touched].numpy(), c3[touched].numpy(), **TOL)
        torch.testing.assert_close(r.kv_cache[~touched], c0[~touched], rtol=0, atol=0)
        assert touched.any()


@pytest.mark.parametrize("q_len", [1, K + 1])
def test_padded_decode_matches_unpadded(q_len, model_dir):
    r = _runner(model_dir, 1)
    n = N0 + q_len
    ids = np.random.default_rng(2).integers(3, 128, size=(3, q_len)).astype(np.int32)
    pos = (n[:, None] - q_len + np.arange(q_len)).astype(np.int32)

    def run(B_pad):
        tok, logits = mr.decode_step(
            r.params, r.kv_cache, _pad(ids, B_pad, 0).reshape(-1),
            _pad(pos, B_pad, 0).reshape(-1), _pad(_tables(4)[:3], B_pad, -1),
            _pad(n, B_pad, 1), _pad(np.zeros(3, np.float32), B_pad, 0.0), None,
            arch=r.arch, block_size=BS, q_len=q_len, greedy=True)
        return tok, logits.reshape(B_pad, q_len, -1)

    _check_bucket(run, [r], 0)


def test_int8_weight_padded_decode_matches_unpadded(model_dir):
    """The decode over int8 weights (quantization="int8": every projection
    and the head through ops/linear.py) at B_pad 4 with a ghost row against
    B = 3."""
    r = _runner(model_dir, 1, quantization="int8")
    assert r.params["lm_head"].dtype == torch.int8
    n = N0 + 1
    ids = np.random.default_rng(2).integers(3, 128, size=(3, 1)).astype(np.int32)

    def run(B_pad):
        tok, logits = mr.decode_step(
            r.params, r.kv_cache, _pad(ids, B_pad, 0).reshape(-1),
            _pad(n - 1, B_pad, 0), _pad(_tables(4)[:3], B_pad, -1), _pad(n, B_pad, 1),
            _pad(np.zeros(3, np.float32), B_pad, 0.0), None,
            arch=r.arch, block_size=BS, q_len=1, greedy=True)
        return tok, logits

    _check_bucket(run, [r], 0)


def test_padded_chain_matches_unpadded(model_dir):
    r = _runner(model_dir, 3)
    first = np.array([17, 99, 5], np.int32)

    def run(B_pad):
        return mr.chain_decode_step(
            r.params, r.kv_cache, _pad(first, B_pad, 0), _pad(N0, B_pad, 0),
            _pad(_tables(4)[:3], B_pad, -1), _pad(N0 + 1, B_pad, 1),
            _pad(np.zeros(3, np.float32), B_pad, 0.0), None, arch=r.arch,
            block_size=BS, K=K, extra_write=True, greedy=True)

    _check_bucket(run, [r], 0)


@pytest.mark.parametrize("kind", ["sd", "ngram"])
def test_padded_superstep_matches_unpadded(kind, model_dir):
    R = 2
    t, d = _runner(model_dir, 4), _runner(model_dir, 5)
    rec0 = np.array([17, 99, 5], np.int32)
    temps = np.zeros(3, np.float32)
    H = fused_sd.ngram_width(t, K, R)
    hist = np.zeros((3, H), np.int32)
    hist[:, :40] = np.tile([7, 8, 9, 10], 10)

    def run(B_pad):
        args = dict(rec0=_pad(rec0, B_pad, 0), n0=_pad(N0, B_pad, 1),
                    bt_target=_pad(_tables(4, R)[:3], B_pad, -1),
                    temps_t=_pad(temps, B_pad, 0.0))
        if kind == "ngram":
            return fused_sd.ngram_superstep(
                t.params, t.kv_cache, hist0=_pad(hist, B_pad, 0), **args, generator=None,
                t_arch=t.arch, block_size=BS, N=2, K=K, R=R, greedy=True)
        return fused_sd.sd_superstep(
            t.params, t.kv_cache, d.params, d.kv_cache, **args,
            bt_draft=_pad(_tables(4, R, shift=4)[:3], B_pad, -1),
            temps_d=_pad(temps, B_pad, 0.0), t_generator=None, d_generator=None,
            t_arch=t.arch, d_arch=d.arch, block_size=BS, K=K, R=R, greedy=True)

    _check_bucket(run, [t] if kind == "ngram" else [t, d], 1)


FAN = FanOut([2, 2, 1, 1], [1, 1, 2, 2], "cpu")   # MQ 6; hit and miss lists differ


def _draft_tables(B_pad, R, shift):
    """Tables that cover R rounds and the last tree build (K+1 + K*MQ
    slots past the base)."""
    bt = np.full((B_pad, 16), -1, np.int32)
    for b, n in enumerate(N0):
        pages = -(-(int(n) + R * (K + 1) + K + 1 + K * FAN.MQ) // BS)
        bt[b, :pages] = np.arange(pages) + 1 + 8 * b + shift
    return bt


def test_padded_tree_build_matches_unpadded(model_dir):
    """The draft's tree build (hit and miss rows) at B_pad 4 with a ghost
    row (table -1, base 0, hits 0) against B = 3."""
    d = _runner(model_dir, 9)
    glue = np.random.default_rng(10).integers(3, 128, size=(3, K + 1)).astype(np.int64)
    hits = np.array([1, 0, 1], np.int64)

    def run(B_pad):
        tree, spec_logits, glue_logits = async_fused.tree_build_step(
            d.params, d.kv_cache, _pad(glue, B_pad, 0), _pad(N0, B_pad, 0),
            _pad(_draft_tables(4, 1, 0)[:3], B_pad, -1), _pad(hits, B_pad, 0),
            _pad(np.zeros(3, np.float32), B_pad, 0.0), None, arch=d.arch, block_size=BS,
            K=K, fan=FAN, sampler_x=None, F=2, greedy=True)
        return tree, spec_logits.reshape(B_pad, FAN.MQ, K, -1), glue_logits

    _check_bucket(run, [d], 0)


def test_padded_async_superstep_matches_unpadded(model_dir):
    """The fused async superstep (R = 2, the target drafting for itself
    over its own copy of the cache, so rounds hit) at B_pad 4 against B = 3:
    every round's outputs exact, both caches as for the other steps."""
    R = 2
    t, d = _runner(model_dir, 11), _runner(model_dir, 11)
    zeros = np.zeros(3, np.float32)

    def run(B_pad):
        bt = _pad(_draft_tables(4, R, 0)[:3], B_pad, -1)
        return (async_fused.async_ssd_superstep(
            t.params, t.kv_cache, d.params, d.kv_cache,
            _pad(np.array([17, 99, 5], np.int32), B_pad, 0), _pad(N0, B_pad, 1), bt, bt,
            _pad(zeros, B_pad, 0.0), _pad(zeros, B_pad, 0.0), None, None, t_arch=t.arch,
            d_arch=d.arch, block_size=BS, K=K, R=R, fan=FAN, sampler_x=None, F=2,
            greedy=True),)

    _check_bucket(run, [t, d], 1)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_ghost_rows_write_nothing(kv_quant, model_dir):
    """A step of ghost rows only (what a capture's eager warm-up runs) leaves
    the cache bit for bit as it was, in the fp cache and the int8 pair."""
    r = _runner(model_dir, 6, kv_quant)
    if kv_quant:
        data, scales = r.kv_cache
        data.copy_(torch.randint(-127, 128, data.shape, dtype=torch.int8))
        scales.uniform_(0.01, 0.1)
    before = _cache(r)
    tok, _ = mr.decode_step(
        r.params, r.kv_cache, torch.zeros(4 * (K + 1), dtype=torch.int32),
        torch.zeros(4 * (K + 1), dtype=torch.int32),
        torch.full((4, 16), -1, dtype=torch.int32), torch.ones(4, dtype=torch.int32),
        torch.zeros(4), None, arch=r.arch, block_size=BS, q_len=K + 1, greedy=True)
    after = r.kv_cache if kv_quant else (r.kv_cache,)
    for a, b in zip(after, before if kv_quant else (before,)):
        assert torch.equal(a, b)
    assert tok.shape == (4,)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_ghost_tree_build_writes_nothing(kv_quant, model_dir):
    """A tree build of ghost rows only (table -1, base 0, hits 0: a
    capture's warm-up) leaves the draft cache bit for bit as it was, in the
    fp cache and the int8 pair."""
    d = _runner(model_dir, 15, kv_quant)
    if kv_quant:
        data, scales = d.kv_cache
        data.copy_(torch.randint(-127, 128, data.shape, dtype=torch.int8))
        scales.uniform_(0.01, 0.1)
    before = _cache(d)
    async_fused.tree_build_step(
        d.params, d.kv_cache, torch.zeros(4, K + 1, dtype=torch.int64),
        torch.zeros(4, dtype=torch.int32), torch.full((4, 16), -1, dtype=torch.int32),
        torch.zeros(4, dtype=torch.int32), torch.zeros(4), None, arch=d.arch, block_size=BS,
        K=K, fan=FAN, sampler_x=None, F=2, greedy=True)
    after = d.kv_cache if kv_quant else (d.kv_cache,)
    for a, b in zip(after, before if kv_quant else (before,)):
        assert torch.equal(a, b)


# --- the EAGLE-3 head's steps ---------------------------------------------------------


@pytest.fixture(scope="module")
def eagle_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("graph_steps_eagle")
    make_tiny_eagle(d, seed=3)
    return str(d)


def _eagle_runners(model_dir, eagle_dir, seed, kv_quant=None, quantization=None):
    """The target (tapping layers 0, 1, 1) and the fused form's EAGLE head,
    each over a random cache (the fp cache)."""
    cfg = Config(model_dir, device="cpu", dtype="float32", kvcache_block_size=BS,
                 num_kvcache_blocks=32, max_model_len=256, kv_quant=kv_quant, draft=eagle_dir,
                 speculate=True, use_eagle=True, speculate_k=K, spec_rounds=2,
                 eagle_layers=[0, 1, 1], quantization=quantization)
    t, d = mr.ModelRunner(cfg), er.EagleModelRunner(cfg.create_draft_config())
    if kv_quant is None:
        r = np.random.default_rng(seed)
        for x in (t, d):
            x.kv_cache = torch.from_numpy(r.normal(size=tuple(x.kv_cache.shape))
                                          .astype(np.float32))
    return t, d


def _eagle_inputs(d, B_pad, seed=16):
    """Seeded EAGLE inputs of 3 rows at B_pad (ghost rows 0): first tokens,
    recovery and extend taps, spec prenorms, glue with 2, 0 and 1 extend
    rows, hits 1, 0, 1, bases N0 - 2."""
    r = np.random.default_rng(seed)
    A, D, W = d.arch.act_dim, d.arch.hidden_size, 2 * K + 1
    n_ext = np.array([2, 0, 1], np.int32)
    return dict(
        first=_pad(np.array([17, 99, 5], np.int64), B_pad, 0),
        rec_acts=_pad(r.normal(size=(3, A)).astype(np.float32), B_pad, 0.0),
        ext_acts=_pad(r.normal(size=(3, K, A)).astype(np.float32), B_pad, 0.0),
        prev=_pad(r.normal(size=(3, K, D)).astype(np.float32), B_pad, 0.0),
        glue=_pad(r.integers(3, 128, size=(3, W)).astype(np.int64), B_pad, 0),
        n_ext=_pad(n_ext, B_pad, 0), base=_pad(N0 - 2, B_pad, 0),
        hits=_pad(np.array([1, 0, 1], np.int64), B_pad, 0),
        temps=_pad(np.zeros(3, np.float32), B_pad, 0.0))


def _eagle_step(kind, t, d, x, bt, gen=None, greedy=True, temps=None):
    """One EAGLE step of `kind` on the inputs x, outputs with the batch on
    axis 1 (the superstep's) or 0."""
    temps = x["temps"] if temps is None else temps
    if kind == "chain":
        return er.eagle_chain_step(d.params, d.kv_cache, x["first"], x["rec_acts"], x["base"],
                                   bt, temps, gen, arch=d.arch, block_size=BS, K=K,
                                   sampler_x=1.5, fan_out=2, greedy=greedy)
    if kind == "tree":
        B_pad = bt.shape[0]
        tree, logits, acts = er.eagle_tree_build_step(
            d.params, d.kv_cache, x["glue"], x["rec_acts"], x["ext_acts"], x["prev"],
            x["n_ext"], x["base"], bt, x["hits"], temps, gen, arch=d.arch, block_size=BS, K=K,
            fan=FAN, sampler_x=1.5, F=2, greedy=greedy)
        return tree, logits.reshape(B_pad, FAN.MQ, K, -1), acts.reshape(B_pad, FAN.MQ, K, -1)
    specs, accs, recs, acts = fused_sd.eagle_sd_superstep(
        t.params, t.kv_cache, d.params, d.kv_cache, x["first"], x["rec_acts"], x["base"] + 2,
        bt, torch.roll(bt, 1, dims=1), temps, temps, gen, gen, t_arch=t.arch, d_arch=d.arch,
        block_size=BS, K=K, R=2, eagle_layers=(0, 1, 1), greedy=greedy)
    return specs, accs, recs, acts.T


@pytest.mark.parametrize("kind", ["chain", "tree", "superstep"])
def test_padded_eagle_steps_match_unpadded(kind, model_dir, eagle_dir):
    """The head's chain, its tree build and the fused superstep (R = 2; the
    draft's table is the target's rolled by one page) at B_pad 4 with a
    ghost row (table -1, base 0, n_ext 0, hits 0, taps 0) against B = 3."""
    t, d = _eagle_runners(model_dir, eagle_dir, 17)

    def run(B_pad):
        x = {k: v[:B_pad] for k, v in _eagle_inputs(d, 4).items()}
        return _eagle_step(kind, t, d, x, _pad(_draft_tables(4, 2, 0)[:3], B_pad, -1))

    _check_bucket(run, [t, d] if kind == "superstep" else [d], 1 if kind == "superstep" else 0)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_ghost_eagle_tree_build_writes_nothing(kv_quant, model_dir, eagle_dir):
    """The head's tree build over ghost rows only (a capture's warm-up)
    leaves its cache bit for bit as it was, fp and int8."""
    _, d = _eagle_runners(model_dir, eagle_dir, 18, kv_quant)
    if kv_quant:
        data, scales = d.kv_cache
        data.copy_(torch.randint(-127, 128, data.shape, dtype=torch.int8))
        scales.uniform_(0.01, 0.1)
    before = _cache(d)
    x = {k: torch.zeros_like(v) for k, v in _eagle_inputs(d, 4).items()}
    for kind in ("chain", "tree"):
        _eagle_step(kind, None, d, x, torch.full((4, 16), -1, dtype=torch.int32))
    after = d.kv_cache if kv_quant else (d.kv_cache,)
    for a, b in zip(after, before if kv_quant else (before,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("greedy", [True, False])
def test_eagle_steps_read_nothing_back(greedy, model_dir, eagle_dir):
    """The head's chain and tree build and the fused superstep, greedy and
    sampled (sampler_x in the chain and the tree), under the guard."""
    t, d = _eagle_runners(model_dir, eagle_dir, 19)
    gen = torch.Generator().manual_seed(0)
    x = _eagle_inputs(d, 4)
    temps = torch.zeros(4) if greedy else torch.tensor([0.0, 0.7, 1.0, 0.0])
    bt = _pad(_draft_tables(4, 2, 0)[:3], 4, -1)
    with no_host_reads():
        for kind in ("chain", "tree", "superstep"):
            _eagle_step(kind, t, d, x, bt, gen, greedy, temps)


def test_int8_weight_eagle_steps_read_nothing_back(model_dir, eagle_dir):
    """Over an int8 target and an int8 head (bf16 compute in the fp32
    engine), the head's chain and tree build and the fused superstep read
    nothing back, and the padded bucket gives the unpadded chain's
    outputs."""
    t, d = _eagle_runners(model_dir, eagle_dir, 20, quantization="int8")
    assert d.params["fc"].dtype == t.params["lm_head"].dtype == torch.int8
    x = _eagle_inputs(d, 4)
    bt = _pad(_draft_tables(4, 2, 0)[:3], 4, -1)
    with no_host_reads():
        for kind in ("chain", "tree", "superstep"):
            _eagle_step(kind, t, d, x, bt)

    def run(B_pad):
        xb = {k: v[:B_pad] for k, v in x.items()}
        return _eagle_step("chain", t, d, xb, _pad(_draft_tables(4, 2, 0)[:3], B_pad, -1))

    _check_bucket(run, [d], 0)


# --- no host reads ----------------------------------------------------------------


@contextlib.contextmanager
def no_host_reads():
    """Tensor.item / tolist / __bool__ / cpu / numpy raise inside the block."""
    names = ("item", "tolist", "__bool__", "cpu", "numpy")
    saved = {n: getattr(torch.Tensor, n) for n in names}

    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"host read inside a step: Tensor.{name}")
        return f

    for n in names:
        setattr(torch.Tensor, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@pytest.mark.parametrize("greedy", [True, False])
def test_steps_read_nothing_back(greedy, model_dir):
    r, d = _runner(model_dir, 7), _runner(model_dir, 8)
    gen = torch.Generator().manual_seed(0)
    B_pad, R = 4, 2
    temps = torch.tensor([0.0, 0.7, 1.0, 0.0]) if not greedy else torch.zeros(B_pad)
    bt = _pad(_tables(4, R)[:3], B_pad, -1)
    n0 = _pad(N0, B_pad, 1)
    rec0 = _pad(np.array([17, 99, 5], np.int32), B_pad, 0)
    hist = torch.zeros(B_pad, fused_sd.ngram_width(r, K, R), dtype=torch.int32)
    with no_host_reads():
        mr.decode_step(r.params, r.kv_cache, rec0, n0, bt, n0 + 1, temps, gen,
                       arch=r.arch, block_size=BS, q_len=1, greedy=greedy)
        mr.chain_decode_step(r.params, r.kv_cache, rec0, n0, bt, n0 + 1, temps, gen,
                             arch=r.arch, block_size=BS, K=K, greedy=greedy)
        fused_sd.sd_superstep(r.params, r.kv_cache, d.params, d.kv_cache, rec0, n0, bt,
                              _pad(_tables(4, R, shift=4)[:3], B_pad, -1), temps, temps,
                              gen, gen, t_arch=r.arch, d_arch=d.arch, block_size=BS,
                              K=K, R=R, greedy=greedy)
        fused_sd.ngram_superstep(r.params, r.kv_cache, hist, rec0, n0, bt, temps, gen,
                                 t_arch=r.arch, block_size=BS, N=2, K=K, R=R,
                                 greedy=greedy)
    with pytest.raises(AssertionError, match="host read"), no_host_reads():
        bool(temps.any())


def test_int8_weight_steps_read_nothing_back(model_dir):
    """The decode, the chain and both sync supersteps over int8 weights,
    sampled, under the guard."""
    r = _runner(model_dir, 9, quantization="int8")
    d = _runner(model_dir, 10, quantization="int8")
    gen = torch.Generator().manual_seed(0)
    B_pad, R = 4, 2
    temps = torch.tensor([0.0, 0.7, 1.0, 0.0])
    bt = _pad(_tables(4, R)[:3], B_pad, -1)
    n0 = _pad(N0, B_pad, 1)
    rec0 = _pad(np.array([17, 99, 5], np.int32), B_pad, 0)
    hist = torch.zeros(B_pad, fused_sd.ngram_width(r, K, R), dtype=torch.int32)
    with no_host_reads():
        mr.decode_step(r.params, r.kv_cache, rec0, n0, bt, n0 + 1, temps, gen,
                       arch=r.arch, block_size=BS, q_len=1)
        mr.chain_decode_step(r.params, r.kv_cache, rec0, n0, bt, n0 + 1, temps, gen,
                             arch=r.arch, block_size=BS, K=K)
        fused_sd.sd_superstep(r.params, r.kv_cache, d.params, d.kv_cache, rec0, n0, bt,
                              _pad(_tables(4, R, shift=4)[:3], B_pad, -1), temps, temps,
                              gen, gen, t_arch=r.arch, d_arch=d.arch, block_size=BS,
                              K=K, R=R)
        fused_sd.ngram_superstep(r.params, r.kv_cache, hist, rec0, n0, bt, temps, gen,
                                 t_arch=r.arch, block_size=BS, N=2, K=K, R=R)


@pytest.mark.parametrize("greedy", [True, False])
def test_async_steps_read_nothing_back(greedy, model_dir):
    """The tree build, the fused exchange and the fused async superstep,
    greedy and sampled (sampler_x in the tree), under the guard."""
    t, d = _runner(model_dir, 12), _runner(model_dir, 13)
    gen = torch.Generator().manual_seed(0)
    B_pad, R = 4, 2
    temps = torch.tensor([0.0, 0.7, 1.0, 0.0]) if not greedy else torch.zeros(B_pad)
    bt = _pad(_draft_tables(4, R, 0)[:3], B_pad, -1)
    n0 = _pad(N0, B_pad, 1)
    rec0 = _pad(np.array([17, 99, 5], np.int32), B_pad, 0)
    hits = torch.tensor([1, 0, 1, 0])
    spec = torch.randint(3, 128, (B_pad, K + 1))
    pos = n0[:, None].long() + torch.arange(K + 1)
    geom = dict(block_size=BS, K=K, fan=FAN, sampler_x=1.5, F=2)
    with no_host_reads():
        async_fused.tree_build_step(d.params, d.kv_cache, spec, n0, bt, hits, temps, gen,
                                    arch=d.arch, greedy=greedy, **geom)
        async_fused.exchange_step(
            t.params, t.kv_cache, d.params, d.kv_cache, spec.reshape(-1), pos.reshape(-1),
            bt, n0 + K + 1, torch.randn(B_pad, K, t.arch.vocab_size), temps, temps, hits,
            bt, gen, gen, t_arch=t.arch, d_arch=d.arch, greedy=greedy, greedy_tree=greedy,
            **geom)
        async_fused.async_ssd_superstep(
            t.params, t.kv_cache, d.params, d.kv_cache, rec0, n0, bt, bt, temps, temps, gen,
            gen, t_arch=t.arch, d_arch=d.arch, R=R, greedy=greedy, **geom)


def test_chain_keys_name_the_sampler(model_dir):
    """The sync draft's chain and the async draft's tree-sampled chain
    (sampler_x, fan-out) are separate graphs."""
    r = _runner(model_dir, 14)
    keys = {r.chain_call(4, K, True)[0],
            r.chain_call(4, K, True, sampler_x=None, fan_out=2, tree_sampling=True)[0],
            r.chain_call(4, K, True, sampler_x=1.5, fan_out=2, tree_sampling=True)[0]}
    assert len(keys) == 3
    assert r.chain_call(4, K, True)[0] == r.chain_call(4, K, True, fan_out=2)[0]


# --- capture bookkeeping ------------------------------------------------------------


def test_launch_record_counts_at_replay():
    """Inside recording_launches a wrapper's launch goes to the record, not
    to its count; add_launches adds one replay's launches."""
    def wrapper():
        pass

    wrapper.launches = 0
    cuda_lib.count_launch(wrapper)
    with cuda_lib.recording_launches() as record:
        for _ in range(3):
            cuda_lib.count_launch(wrapper)
    assert wrapper.launches == 1 and record == {wrapper: 3}
    for _ in range(2):
        cuda_lib.add_launches(record)
    assert wrapper.launches == 7


def test_split_scratch_grows_outside_capture_only():
    s = att.SplitScratch()
    ws, counters = s.take(100, 8, torch.device("cpu"))
    assert ws.numel() == 100 and counters.numel() >= 1024 and not counters.any()
    big, _ = s.take(300, 8, torch.device("cpu"))
    small, _ = s.take(50, 8, torch.device("cpu"))
    assert big.numel() == 300 and small.data_ptr() == big.data_ptr()


def test_round_choices_ladder():
    assert round_choices(1) == (1,)
    assert round_choices(4) == (4,)
    assert round_choices(8) == (4, 8)
    assert round_choices(32) == (4, 8, 16, 32)
    assert round_choices(6) == (4, 6)
