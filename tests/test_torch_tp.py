"""Tensor and expert parallelism of the port (num_devices > 1) on the CPU,
over gloo, against the JAX package on the same checkpoints:

- sharding rules: at tp 2 every leaf of the port's rank shard
  (params_from_jax with a Sharding) equals, bit for bit, the JAX shard
  that ssd_tpu/parallel/mesh.py::shard_params puts on that rank's device
  (make_mesh(tp_size=2), read through addressable_shards on conftest's
  virtual CPU devices) once turned into the port's layout, for a tiny
  Llama, a tiny Qwen3-MoE and both quantized to int8; at tp 4 (> the 2 k/v
  heads) each rank holds whole the k/v head its query heads read;
- greedy fp32 tokens of LLM(..., num_devices=N, device="cpu") equal the JAX
  package's LLM(..., num_devices=N) and the port's N=1, for AR at N 2 and
  4, Qwen3-MoE (expert-parallel) at 2 and 4, int8 weights at 2 (exact:
  any token that differs fails); the tp-2 AR engine also serves a sampled
  run (temperature 0.8, seeded) with the tp-1 engine's tokens, every
  rank's token hash equal to rank 0's at exit(), and relayed
  add_request / abort_request / step calls;
- one verify forward (q_len K+1 = 4) over a caller-launched two-rank gloo
  group gives the logits of JAX's tp-2 decode_step within 1e-4 (fp32
  reduction order, the tolerance of tests/test_torch_model.py);
- fused SD (R=3), ngram and the fused async exchange at tp 2 give the
  port's tp-1 tokens (exact);
- the num-devices refusal; a caller's one-rank group is served (tokens
  equal the engine without a group); after exit() no group is left and no
  spawned rank is alive.
Spawned ranks take 2 torch threads and rendezvous through a FileStore in
a temporary directory (parallel/comm.py).
"""

import dataclasses
import json
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.engine import model_runner as jmr
from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu.models.transformer import Arch as JaxArch
from ssd_tpu.parallel.mesh import kv_sharding, make_mesh, shard_params as jax_shard_params
from ssd_tpu.utils import quant as jquant
from ssd_tpu.utils.loader import load_params as jax_load_params
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.config import ModelConfig
from ssd_tpu_torch.models.transformer import Arch
from ssd_tpu_torch.ops.moe import moe_mlp
from ssd_tpu_torch.parallel import comm as tp_comm
from ssd_tpu_torch.parallel.mesh import Sharding
from ssd_tpu_torch.utils.loader import save_safetensors
from ssd_tpu_torch.weights import params_from_jax
from tests.torch_tp_ranks import verify_rank
from tests.utils_models import random_prompt, rng


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024, kvcache_block_size=16,
              num_kvcache_blocks=64, max_num_seqs=2, dtype="float32")
PROMPTS = [random_prompt(rng(70 + i), 8, 20) for i in range(2)]
GREEDY = dict(temperature=0.0, max_new_tokens=16, ignore_eos=True)


def tiny_checkpoint(d, seed, scale, layers=2, hidden=64, heads=4, kv_heads=2, head_dim=16,
                    intermediate=128, experts=0, top_k=0, moe_intermediate=96, vocab=128):
    """A tiny HF-layout checkpoint (config.json and one safetensors file of
    N(0, scale) fp32 weights, norms at one) of a Llama or, with experts, a
    Qwen3-MoE, written without transformers (whose import takes tens of
    seconds here)."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=g) * scale

    D, V = hidden, vocab
    t = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": torch.ones(D),
         "lm_head.weight": w(V, D)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": torch.ones(D),
                  p + "post_attention_layernorm.weight": torch.ones(D),
                  p + "self_attn.q_proj.weight": w(heads * head_dim, D),
                  p + "self_attn.k_proj.weight": w(kv_heads * head_dim, D),
                  p + "self_attn.v_proj.weight": w(kv_heads * head_dim, D),
                  p + "self_attn.o_proj.weight": w(D, heads * head_dim)})
        if experts:
            t.update({p + "self_attn.q_norm.weight": torch.ones(head_dim),
                      p + "self_attn.k_norm.weight": torch.ones(head_dim),
                      p + "mlp.gate.weight": w(experts, D)})
            for e in range(experts):
                q = f"{p}mlp.experts.{e}."
                t.update({q + "gate_proj.weight": w(moe_intermediate, D),
                          q + "up_proj.weight": w(moe_intermediate, D),
                          q + "down_proj.weight": w(D, moe_intermediate)})
        else:
            t.update({p + "mlp.gate_proj.weight": w(intermediate, D),
                      p + "mlp.up_proj.weight": w(intermediate, D),
                      p + "mlp.down_proj.weight": w(D, intermediate)})
    save_safetensors(os.path.join(d, "model.safetensors"), t)
    cfg = {"model_type": "qwen3_moe" if experts else "llama", "vocab_size": V,
           "hidden_size": D, "intermediate_size": intermediate, "num_hidden_layers": layers,
           "num_attention_heads": heads, "num_key_value_heads": kv_heads,
           "head_dim": head_dim, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
           "max_position_embeddings": 512, "tie_word_embeddings": False,
           "torch_dtype": "float32", "eos_token_id": 2, "bos_token_id": 1}
    if experts:
        cfg.update(num_experts=experts, num_experts_per_tok=top_k,
                   moe_intermediate_size=moe_intermediate, norm_topk_prob=True,
                   decoder_sparse_step=1, mlp_only_layers=[])
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {}
    for name, kw in (("llama", dict(seed=0, scale=0.1)),
                     ("moe", dict(seed=9, scale=0.4, experts=8, top_k=3)),
                     ("draft", dict(seed=7, scale=0.1, layers=1, hidden=32, intermediate=64,
                                    head_dim=8))):
        d = str(tmp_path_factory.mktemp(f"tp_{name}"))
        tiny_checkpoint(d, **kw)
        out[name] = d
    return out


def port_tokens(path, **kw):
    llm = ssd_tpu_torch.LLM(path, device="cpu", **ENGINE, **kw)
    try:
        outs, _ = llm.generate([list(p) for p in PROMPTS], SamplingParams(**GREEDY),
                               use_tqdm=False)
    finally:
        llm.exit()
    return [o["token_ids"] for o in outs]


def jax_tokens(path, **kw):
    llm = JaxLLM(path, **ENGINE, **kw)
    outs, _ = llm.generate([list(p) for p in PROMPTS], JaxSamplingParams(**GREEDY),
                           use_tqdm=False)
    return [o["token_ids"] for o in outs]


def no_ranks_left():
    """No process group in this process, and no spawned rank alive."""
    return (not dist.is_initialized() and tp_comm._spawned is None
            and not [p for p in mp.active_children() if p.name.startswith("ssd-tp-rank")])


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _jax_rank_tree(sharded, mesh, rank):
    """The numpy tree of what rank `rank`'s device holds of a sharded JAX
    tree: its shard of each leaf."""
    dev = mesh.devices.flat[rank]

    def mine(x):
        shard = next(s for s in x.addressable_shards if s.device == dev)
        return np.asarray(shard.data)

    out = jax.tree.map(mine, sharded)
    if sharded["lm_head"] is sharded["embed"]:
        out["lm_head"] = out["embed"]
    return out


@pytest.mark.parametrize("model,int8", [("llama", False), ("moe", False),
                                        ("llama", True), ("moe", True)],
                         ids=["llama", "moe", "llama_int8", "moe_int8"])
def test_rank_shards_equal_jax_shards(ckpts, model, int8):
    """Bit for bit, every leaf of each rank at tp 2 (the int8 trees
    quantized whole, then sharded, on both sides)."""
    d = ckpts[model]
    jparams = jax_load_params(d, JaxModelConfig.from_pretrained(d), jnp.float32)
    if int8:
        jparams = jquant.quantize_params(jparams)
    mesh = make_mesh(tp_size=2)
    sharded = jax_shard_params(jparams, mesh)
    whole = _host(jparams)
    arch = Arch.from_model_config(ModelConfig.from_pretrained(d))
    for rank in range(2):
        got = params_from_jax(whole, Sharding(arch, rank, 2))
        want = params_from_jax(_jax_rank_tree(sharded, mesh, rank))
        assert set(got) == set(want)
        for k in got:
            if k != "layers":
                assert torch.equal(got[k], want[k]), (rank, k)
        for li, (g, w) in enumerate(zip(got["layers"], want["layers"])):
            assert set(g) == set(w)
            for k in g:
                assert torch.equal(g[k], w[k]), (rank, li, k)
        # The rank's half of the vocabulary, not the whole table.
        assert got["embed"].shape[0] == arch.vocab_size // 2


def test_tp4_ranks_hold_the_kv_heads_their_queries_read(ckpts):
    """tp 4 > 2 k/v heads: rank r's one query head reads k/v head r // 2,
    which it holds whole (replicated over ranks 2h, 2h+1), as its cache
    does; the other leaves split four ways."""
    d = ckpts["llama"]
    jparams = jax_load_params(d, JaxModelConfig.from_pretrained(d), jnp.float32)
    whole = params_from_jax(_host(jparams))
    arch = Arch.from_model_config(ModelConfig.from_pretrained(d))
    hd = arch.head_dim
    for rank in range(4):
        sh = Sharding(arch, rank, 4)
        assert sh.kv_heads == (rank // 2, 1)
        assert sh.rank_arch().num_heads == 1 and sh.rank_arch().num_kv_heads == 1
        got = params_from_jax(_host(jparams), sh)
        for name in ("wk", "wv"):
            want = whole["layers"][0][name][:, (rank // 2) * hd:(rank // 2 + 1) * hd]
            assert torch.equal(got["layers"][0][name], want)
        assert torch.equal(got["layers"][0]["wq"],
                           whole["layers"][0]["wq"][:, rank * hd:(rank + 1) * hd])
        assert got["embed"].shape[0] == arch.vocab_size // 4


def test_unsplittable_geometries_refused(ckpts):
    """tp must divide the query heads (and the experts); a replicated
    vocabulary (tp does not divide it) is kept whole on every rank."""
    arch = Arch.from_model_config(ModelConfig.from_pretrained(ckpts["llama"]))
    with pytest.raises(ValueError, match="query heads"):
        Sharding(arch, 0, 3)
    moe = Arch.from_model_config(ModelConfig.from_pretrained(ckpts["moe"]))
    with pytest.raises(ValueError, match="experts"):
        Sharding(dataclasses.replace(moe, num_experts=6), 0, 4)
    odd = Sharding(dataclasses.replace(arch, vocab_size=129), 1, 2)
    assert not odd.vocab_sharded and odd.span("embed") is None


@pytest.mark.parametrize("tp", [2, 4])
def test_moe_mlp_rank_partials_sum_to_the_layer(tp):
    """Expert parallelism of one layer without the engine: each rank's
    moe_mlp over its E/tp experts (the router whole, top-k global; its
    groups' offsets ending at its own pairs) summed over the ranks equals
    the whole layer's output, fp32 within 1e-5 (the order of the k terms'
    sum), at k 3 of 8 experts."""
    r = np.random.default_rng(tp)
    T, D, E, Im, k = 11, 32, 8, 24, 3
    lp = {"router": torch.from_numpy(r.normal(size=(D, E))).float(),
          "moe_gate": torch.from_numpy(r.normal(size=(E, D, Im)) * 0.3).float(),
          "moe_up": torch.from_numpy(r.normal(size=(E, D, Im)) * 0.3).float(),
          "moe_down": torch.from_numpy(r.normal(size=(E, Im, D)) * 0.3).float()}
    x = torch.from_numpy(r.normal(size=(T, D))).float()
    El = E // tp
    got = sum(moe_mlp(x, {**lp, **{n: lp[n][i * El:(i + 1) * El] for n in
                                   ("moe_gate", "moe_up", "moe_down")}}, k, True, rank=i)
              for i in range(tp))
    torch.testing.assert_close(got, moe_mlp(x, lp, k, True), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp1_tokens(ckpts):
    """The port's one-process tokens of each model, computed once."""
    return {"llama": port_tokens(ckpts["llama"]), "moe": port_tokens(ckpts["moe"]),
            "llama_int8": port_tokens(ckpts["llama"], quantization="int8")}


@pytest.mark.parametrize("case,n", [("llama", 4), ("moe", 2), ("moe", 4), ("llama_int8", 2)])
def test_greedy_tokens_equal_jax_and_tp1(ckpts, tp1_tokens, case, n):
    model, kw = case.split("_")[0], ({"quantization": "int8"} if "int8" in case else {})
    got = port_tokens(ckpts[model], num_devices=n, **kw)
    assert no_ranks_left()
    assert got == tp1_tokens[case]
    assert got == jax_tokens(ckpts[model], num_devices=n, **kw)


def test_verify_logits_equal_jax_tp(ckpts, tmp_path):
    """One verify forward (B 2, q_len 4, ragged contexts over shuffled
    pages) through a caller-launched gloo group of two spawned ranks
    (tests/torch_tp_ranks.py), against jax's decode_step on params and a
    cache sharded over make_mesh(tp_size=2): logits within 1e-4."""
    d, BS, Q = ckpts["llama"], 16, 4
    mc = JaxModelConfig.from_pretrained(d)
    jarch = JaxArch.from_model_config(mc)
    r = np.random.default_rng(3)
    L, Hkv, hd = jarch.num_layers, jarch.num_kv_heads, jarch.head_dim
    cache = r.normal(size=(L, Hkv, 16 * BS, 2 * hd)).astype(np.float32)
    bt = np.full((2, 4), -1, np.int32)
    bt[0, :2], bt[1, :3] = [5, 2], [9, 0, 12]
    ctx = np.array([29, 41], np.int32)
    pos = (ctx[:, None] - Q + np.arange(Q)[None, :]).astype(np.int32)
    ids = r.integers(3, 128, size=(2, Q)).astype(np.int32)
    slots = np.array([bt[b, p // BS] * BS + p % BS for b in range(2) for p in pos[b]], np.int32)
    np.savez(tmp_path / "in.npz", cache=cache, ids=ids.reshape(-1), pos=pos.reshape(-1),
             bt=bt, ctx=ctx)

    ctx_mp = mp.get_context("spawn")
    store, out = str(tmp_path / "store"), str(tmp_path / "logits.npy")
    procs = [ctx_mp.Process(target=verify_rank, args=(rank, 2, store, d,
                                                      str(tmp_path / "in.npz"), out, BS, Q))
             for rank in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
        assert p.exitcode == 0
    got = np.load(out)

    mesh = make_mesh(tp_size=2)
    jparams = jax_shard_params(jax_load_params(d, mc, jnp.float32), mesh)
    jcache = jax.device_put(jnp.asarray(cache), kv_sharding(mesh, Hkv))
    _, want, _, _ = jmr.decode_step(
        jparams, jcache, ids.reshape(-1), pos.reshape(-1), slots, bt, ctx,
        np.zeros(2, np.float32), jax.random.PRNGKey(0), arch=jarch, block_size=BS,
        ctx_pad=64, q_len=Q, use_pallas=False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


SPEC = {
    "fused_sd": dict(speculate=True, speculate_k=3, spec_rounds=3),
    "ngram": dict(ngram_speculate=True, speculate_k=3, spec_rounds=2),
    "fused_exchange": dict(speculate=True, draft_async=True, async_fused=True,
                           speculate_k=3, async_fan_out=2),
}


@pytest.mark.parametrize("mode", list(SPEC))
def test_speculative_modes_tp2_equal_tp1(ckpts, tp1_tokens, mode):
    """The sync draft and the fused exchange's inline draft sharded with the
    target; ngram has no draft. Greedy tokens equal the tp-1 AR engine's
    (every speculative mode's equal AR's on one process)."""
    kw = dict(SPEC[mode])
    if kw.get("speculate"):
        kw["draft"] = ckpts["draft"]
    assert port_tokens(ckpts["llama"], num_devices=2, **kw) == tp1_tokens["llama"]
    assert no_ranks_left()


def test_llama_tp2_greedy_sampled_and_relayed_calls(ckpts, tp1_tokens):
    """One tp-2 engine: greedy tokens equal the port's tp 1 and ssd_tpu's
    num_devices=2 engine; a sampled run (temperature 0.8, seed 5) gives the
    tp-1 engine's tokens (the gathered logits and the generators' draws
    are the same on every rank and at tp 1); relayed add_request,
    abort_request and step serve the greedy tokens (the aborted request
    finishes with none); exit() compares every rank's token hash with rank
    0's (it raises on a mismatch) and leaves no group or rank."""
    prompts = [list(p) for p in PROMPTS]
    sp = SamplingParams(temperature=0.8, max_new_tokens=16, ignore_eos=True)
    one = ssd_tpu_torch.LLM(ckpts["llama"], device="cpu", seed=5, **ENGINE)
    want = [o["token_ids"] for o in one.generate(prompts, sp, use_tqdm=False)[0]]
    llm = ssd_tpu_torch.LLM(ckpts["llama"], device="cpu", seed=5, num_devices=2, **ENGINE)
    assert dist.is_initialized() and llm.comm.size == 2
    greedy = llm.generate(prompts, SamplingParams(**GREEDY), use_tqdm=False)[0]
    assert [o["token_ids"] for o in greedy] == tp1_tokens["llama"]
    assert [o["token_ids"] for o in llm.generate(prompts, sp, use_tqdm=False)[0]] == want
    ids = [llm.add_request(p, SamplingParams(**GREEDY)) for p in prompts]
    assert llm.abort_request(ids[1])
    done = {}
    while not llm.is_finished():
        done.update(llm.step())
    assert done == {ids[0]: tp1_tokens["llama"][0], ids[1]: []}
    llm.exit()
    assert no_ranks_left()
    assert tp1_tokens["llama"] == jax_tokens(ckpts["llama"], num_devices=2)


def test_refusals(ckpts):
    """num_devices above the visible cards raises, and no rank is left.
    (Every parallel form is served: the unfused async draft on ranks of its
    own and draft_dp in tests/test_torch_draft_dp.py, EAGLE-3 under tensor
    parallelism in tests/test_torch_eagle_tp.py, num_hosts > 1 and its
    refusals in tests/test_torch_multihost.py.)"""
    d = ckpts["llama"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="2 visible CUDA devices"):
            ssd_tpu_torch.LLM(d, num_devices=2, **ENGINE)
    assert no_ranks_left()


def test_caller_group_of_one_rank_is_served(ckpts, tmp_path, tp1_tokens):
    """A caller's one-rank gloo group: the engine serves over it (its two
    all-reduces a layer run, the vocabulary is whole) and gives the tokens
    of the engine without a group; the group stays the caller's after
    exit(). Without a group, num_devices=1 makes none."""
    tp_comm.all_reduce_sum.launches = 0
    port_tokens(ckpts["llama"])
    assert tp_comm.all_reduce_sum.launches == 0 and not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        assert port_tokens(ckpts["llama"]) == tp1_tokens["llama"]
        assert tp_comm.all_reduce_sum.launches > 0
        assert tp_comm.gather_vocab.launches >= 0
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    assert no_ranks_left()
