"""EAGLE-3 under tensor parallelism in the port (use_eagle with
num_devices > 1) on the CPU, over gloo, against the JAX package on the same
tiny checkpoints (a 4-layer Llama written by test_torch_tp.py's writer,
taps [0, 2, 3], and make_tiny_eagle heads with a 64-token draft vocabulary
over its 128):

- sharding rules: at tp 2 and 4, bf16 and int8, every leaf of the port's
  EAGLE rank shard (params_from_jax with a Sharding over the EagleArch)
  equals, bit for bit, what ssd_tpu/parallel/mesh.py::shard_params puts on
  that rank's virtual CPU device (a head of 4 k/v heads, so that JAX's
  split falls on whole heads); on a head of 2 k/v heads each tp-4 rank
  holds whole the k/v head its query head reads;
- one chain step and one tree build of the port's head over a
  caller-launched two-rank gloo group (tests/torch_tp_ranks.py) give the
  tokens of JAX's eagle_chain_program and eagle_tree_build_program on
  params and a cache sharded over make_mesh(tp_size=2), and their logits
  within 1e-4 (fp32 reduction order, as test_torch_tp.py states);
- greedy fp32 tokens of the fused superstep (R=3) at num_devices 2 and 4,
  and of async EAGLE at num_devices=3 (a tp-2 target and the head on a
  draft rank of its own), equal the port's num_devices=1 engine's and
  ssd_tpu.LLM(...)'s with the same arguments, exactly; so do the fused
  superstep's with int8 weights at tp 2 and a seeded sampled run at tp 2
  against tp 1; no rank is left after exit().
"""

import multiprocessing as mp

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.engine import eagle_runner as jer
from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu.models import eagle3 as je3
from ssd_tpu.parallel.mesh import kv_sharding, make_mesh, shard_params as jax_shard_params
from ssd_tpu.utils import quant as jquant
from ssd_tpu.utils.loader import load_eagle_params as jax_load_eagle
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.config import ModelConfig
from ssd_tpu_torch.models.eagle3 import EagleArch
from ssd_tpu_torch.parallel import comm as tp_comm
from ssd_tpu_torch.parallel.mesh import Sharding
from ssd_tpu_torch.weights import params_from_jax
from tests.test_torch_tp import tiny_checkpoint
from tests.torch_tp_ranks import eagle_step_rank
from tests.utils_models import make_tiny_eagle, random_prompt, rng


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


BS, K, F = 16, 2, 2
TAPS = [0, 2, 3]
ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024, kvcache_block_size=BS,
              num_kvcache_blocks=64, max_num_seqs=2, dtype="float32")
PROMPTS = [random_prompt(rng(90 + i), 8, 20) for i in range(2)]
GREEDY = dict(temperature=0.0, max_new_tokens=12, ignore_eos=True)
EAGLE = dict(speculate=True, use_eagle=True, speculate_k=K, eagle_layers=TAPS)
FORMS = {"fused": dict(EAGLE, spec_rounds=3),
         "async": dict(EAGLE, draft_async=True, jit_speculate=True, async_fan_out=F)}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The target, the engines' head (2 k/v heads) and the shard test's
    head (4 k/v heads)."""
    out = {k: str(tmp_path_factory.mktemp(f"eagle_tp_{k}")) for k in ("target", "head", "mha")}
    tiny_checkpoint(out["target"], seed=0, scale=0.1, layers=4)
    make_tiny_eagle(out["head"], draft_vocab=64, seed=3)
    make_tiny_eagle(out["mha"], kv_heads=4, draft_vocab=64, seed=4)
    return out


def port_tokens(ckpts, form, sp=None, **kw):
    llm = ssd_tpu_torch.LLM(ckpts["target"], device="cpu", draft=ckpts["head"], **ENGINE,
                            **FORMS[form], **kw)
    try:
        outs, _ = llm.generate([list(p) for p in PROMPTS], sp or SamplingParams(**GREEDY),
                               use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs]


def jax_tokens(ckpts, form, **kw):
    llm = JaxLLM(ckpts["target"], draft=ckpts["head"], **ENGINE, **FORMS[form], **kw)
    try:
        outs, _ = llm.generate([list(p) for p in PROMPTS], JaxSamplingParams(**GREEDY),
                               use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs]


def no_ranks_left():
    """No process group in this process, and no spawned rank alive."""
    return (not dist.is_initialized() and tp_comm._spawned is None
            and not [p for p in mp.active_children() if p.name.startswith("ssd-")])


def jax_head(ckpts, which, dtype=jnp.float32):
    d_t = JaxModelConfig.from_pretrained(ckpts["target"]).hidden_size
    mc = JaxModelConfig.from_pretrained(ckpts[which])
    return (je3.EagleArch.from_model_config(mc, d_t, len(TAPS)),
            jax_load_eagle(ckpts[which], mc, d_t, len(TAPS), target_path=ckpts["target"],
                           dtype=dtype))


def port_arch(ckpts, which):
    d_t = ModelConfig.from_pretrained(ckpts["target"]).hidden_size
    return EagleArch.from_model_config(ModelConfig.from_pretrained(ckpts[which]), d_t,
                                       len(TAPS))


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp,int8", [(2, False), (4, False), (2, True), (4, True)],
                         ids=["tp2", "tp4", "tp2_int8", "tp4_int8"])
def test_eagle_rank_shards_equal_jax_shards(ckpts, tp, int8):
    """Bit for bit, every leaf of each rank (the int8 dicts quantized whole,
    then sharded, on both sides); the embedding and the head split by rows,
    fc and d2t whole."""
    _, jparams = jax_head(ckpts, "mha", jnp.bfloat16)
    if int8:
        jparams = jquant.quantize_eagle_params(jparams)
    mesh = make_mesh(tp_size=tp)
    sharded = jax_shard_params(jparams, mesh)
    whole = _host(jparams)
    arch = port_arch(ckpts, "mha")
    for rank in range(tp):
        dev = mesh.devices.flat[rank]
        want = params_from_jax({k: np.asarray(next(s for s in x.addressable_shards
                                                   if s.device == dev).data)
                                for k, x in sharded.items()})
        got = params_from_jax(whole, Sharding(arch, rank, tp))
        assert set(got) == set(want)
        for k in got:
            assert torch.equal(got[k], want[k]), (rank, k)
        assert got["embed"].shape[0] == arch.vocab_size // tp
        assert got["lm_head"].shape[0] == arch.draft_vocab_size // tp
        assert got["fc"].shape == params_from_jax(whole)["fc"].shape
        assert got["fc"].dtype == (torch.int8 if int8 else torch.bfloat16)


def test_eagle_tp4_ranks_hold_the_kv_heads_their_queries_read(ckpts):
    """tp 4 > 2 k/v heads: rank r's one query head reads k/v head r // 2,
    which it holds whole, as its KV pool does."""
    _, jparams = jax_head(ckpts, "head")
    whole = params_from_jax(_host(jparams))
    arch = port_arch(ckpts, "head")
    hd = arch.head_dim
    for rank in range(4):
        sh = Sharding(arch, rank, 4)
        ra = sh.rank_arch()
        assert (ra.num_heads, ra.num_kv_heads, ra.intermediate_size) == (
            1, 1, arch.intermediate_size // 4)
        got = params_from_jax(_host(jparams), sh)
        for name in ("wk", "wv"):
            assert torch.equal(got[name], whole[name][:, (rank // 2) * hd:(rank // 2 + 1) * hd])
        assert torch.equal(got["wq"], whole["wq"][:, rank * hd:(rank + 1) * hd])


# ---------------------------------------------------------------------------
# One chain step and one tree build over a two-rank group
# ---------------------------------------------------------------------------


def test_eagle_steps_equal_jax_tp2(ckpts, tmp_path):
    """B 2 over a seeded draft cache: the chain (fc of the recovery taps,
    then each step's prenorm) and the tree build (a hit row with 2 extend
    rows, a miss row with none); tokens exact, logits within 1e-4 of JAX's
    tp-2 programs (use_pallas=False, as its CPU tests run them)."""
    jarch, jparams = jax_head(ckpts, "head")
    arch = port_arch(ckpts, "head")
    Hkv, hd, A, D = arch.num_kv_heads, arch.head_dim, arch.act_dim, arch.hidden_size
    M, W = 256 // BS, 2 * K + 1
    r = np.random.default_rng(11)
    cache = r.normal(size=(1, Hkv, 32 * BS, 2 * hd)).astype(np.float32)
    bt = np.full((2, M), -1, np.int32)
    bt[0, :6], bt[1, :6] = np.arange(1, 7), np.arange(7, 13)
    base = np.array([20, 9], np.int64)
    first = np.array([17, 99], np.int64)
    acts = r.normal(size=(2, A)).astype(np.float32)
    n_ext = np.array([2, 0], np.int64)
    glue = np.zeros((2, W), np.int64)
    rec_acts = r.normal(size=(2, A)).astype(np.float32)
    ext_acts = r.normal(size=(2, K, A)).astype(np.float32)
    fc_acts = np.zeros((2, W, A), np.float32)
    is_fc = np.zeros((2, W), bool)
    for b in range(2):
        n = n_ext[b] + 1 + K
        glue[b, :n] = r.integers(3, 128, n)
        fc_acts[b, :n_ext[b]] = ext_acts[b, :n_ext[b]]
        fc_acts[b, n_ext[b]] = rec_acts[b]
        is_fc[b, :n_ext[b] + 1] = True
    prev = r.normal(size=(2, K, D)).astype(np.float32)
    hits = np.array([1, 0], np.int64)
    fan = ((2, 2, 1), (1, 1, 3))
    np.savez(tmp_path / "in.npz", cache=cache, bt=bt, base=base, first=first, acts=acts,
             n_ext=n_ext, glue=glue, rec_acts=rec_acts, ext_acts=ext_acts, prev=prev, hits=hits)

    ctx = mp.get_context("spawn")
    out = str(tmp_path / "out.npz")
    procs = [ctx.Process(target=eagle_step_rank, args=(
        rank, 2, str(tmp_path / "store"), ckpts["target"], ckpts["head"], TAPS,
        str(tmp_path / "in.npz"), out, BS, K, fan, F)) for rank in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
        assert p.exitcode == 0
    got = np.load(out)

    mesh = make_mesh(tp_size=2)
    jp = jax_shard_params(jparams, mesh)

    def jcache():
        return jax.device_put(jnp.asarray(cache), kv_sharding(mesh, Hkv))

    common = dict(arch=jarch, block_size=BS, ctx_pad=M * BS, K=K, sampler_x=None, F=F,
                  use_pallas=False)
    jtoks, jlogits, _, _ = jer.eagle_chain_program(
        jp, jcache(), jnp.asarray(first, jnp.int32), jnp.asarray(acts),
        jnp.asarray(base, jnp.int32), jnp.asarray(bt), jnp.zeros(2, jnp.float32),
        jax.random.PRNGKey(0), **common)
    np.testing.assert_array_equal(got["chain_tokens"], np.asarray(jtoks))
    np.testing.assert_allclose(got["chain_logits"], np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    host, jspec, _, _ = jer.eagle_tree_build_program(
        jp, jcache(), jnp.asarray(glue, jnp.int32), jnp.asarray(fc_acts), jnp.asarray(prev),
        jnp.asarray(is_fc), jnp.asarray(n_ext, jnp.int32), jnp.asarray(base, jnp.int32),
        jnp.asarray(bt), jnp.asarray(hits, jnp.int32), jnp.zeros(2, jnp.float32),
        jax.random.PRNGKey(0), MQ_LEN=sum(fan[0]), fan_out_list=fan[0],
        fan_out_list_miss=fan[1], **common)
    host, mq = np.asarray(host), sum(fan[0])
    np.testing.assert_array_equal(got["tree"][..., 0], host[:2 * mq].reshape(2, mq))
    np.testing.assert_array_equal(got["tree"][..., 1:], host[2 * mq:].reshape(2, mq, K))
    np.testing.assert_allclose(got["spec_logits"], np.asarray(jspec), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tp1_tokens(ckpts):
    """The port's one-process tokens of each form, computed once."""
    return {"fused": port_tokens(ckpts, "fused"), "async": port_tokens(ckpts, "async"),
            "fused_int8": port_tokens(ckpts, "fused", quantization="int8")}


@pytest.mark.parametrize("form,n", [("fused", 2), ("fused", 4), ("async", 3)],
                         ids=["fused_tp2", "fused_tp4", "async_tp2_draft_rank"])
def test_greedy_tokens_equal_jax_and_tp1(ckpts, tp1_tokens, form, n):
    got = port_tokens(ckpts, form, num_devices=n)
    assert no_ranks_left()
    assert got == tp1_tokens[form]
    assert got == jax_tokens(ckpts, form, num_devices=n)


def test_fused_int8_and_sampled_tp2_equal_tp1(ckpts, tp1_tokens):
    """int8 weights (the head quantized whole, then sharded) give tp 1's
    int8 tokens; a seeded sampled run (temperature 0.8) gives tp 1's: the
    gathered logits and the generators' draws are the same on every
    rank."""
    assert port_tokens(ckpts, "fused", num_devices=2, quantization="int8") \
        == tp1_tokens["fused_int8"]
    sp = SamplingParams(temperature=0.8, max_new_tokens=12, ignore_eos=True)
    assert port_tokens(ckpts, "fused", sp, num_devices=2, seed=5) \
        == port_tokens(ckpts, "fused", sp, seed=5)
    assert no_ranks_left()
