"""Multi-host serving in the port (num_hosts > 1) on the CPU, over gloo,
against the JAX package and the port's single-process engine, on tiny fp32
checkpoints written without transformers (test_torch_tp.py's writer, a
4-layer target, a 1-layer draft, make_tiny_eagle's head):

- two "host" processes (HOST below, each importing torch once) rendezvous
  over tcp://127.0.0.1 on a free port chosen per case, with gloo and
  device="cpu", and serve one engine after another with
  LLM(target, num_hosts=2, coordinator_address=..., host_id=h, ...):
  (a) AR with max_num_seqs=2 over 4 prompts at 1 rank a host
  (num_devices=2) and at 2 ranks a host (num_devices=4: each host spawns
  its second rank, global ranks h*2 + r), (b) fused SD (spec_rounds=2),
  (c) async SSD at draft_dp=1, (d) EAGLE-3 async, (e) async SSD at
  draft_dp=2 (each host owns one replica; the replies are unioned). Every
  host's greedy tokens equal ssd_tpu's AR tokens on the same checkpoint
  (greedy speculation gives AR's tokens, which the JAX package's own tests
  pin) and the port's single-process engine of the same mode, whose cache
  hits and accepted lengths they equal too (a wrong union would miss or
  reject where one process hits and accepts: the SSD cases' draft is the
  target itself, so they hit and accept);
- (f) num_hosts=2 with neither a coordinator nor a group spawns every rank
  here and gives (a)'s and (e)'s results;
- a host whose partner never joins raises within the rendezvous timeout;
- `union_parts` equals JAX's `_union_parts` on the same parts;
- the new ValueErrors;
- at Llama-70B's geometry every rank's parameter and KV shapes at 2 hosts x
  4 ranks equal JAX's per-device shapes under `_compatible_spec` and
  `kv_sharding` over a ("dcn", "tp") = (2, 4) mesh of conftest's eight
  virtual devices (the port's counterpart of test_multihost.py::
  test_70b_geometry_sharded_step_compiles).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.engine.speculator_async import SpeculatorAsync as JaxSpeculatorAsync
from ssd_tpu.llm import LLM as JaxLLM
from ssd_tpu.models.transformer import Arch as JaxArch, init_params as jax_init_params
from ssd_tpu.parallel.mesh import _compatible_spec, kv_sharding, param_specs
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.config import ModelConfig
from ssd_tpu_torch.engine.draft_runner import SpecResponse
from ssd_tpu_torch.engine.speculator_async import partial_reply
from ssd_tpu_torch.models.transformer import Arch
from ssd_tpu_torch.parallel import comm as tp_comm
from ssd_tpu_torch.parallel.mesh import Sharding
from tests.test_torch_tp import tiny_checkpoint
from tests.utils_models import make_tiny_eagle, random_prompt, rng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024, kvcache_block_size=16,
              num_kvcache_blocks=64, max_num_seqs=2, dtype="float32")
PROMPTS = [random_prompt(rng(120 + i), 5, 12) for i in range(4)]
GREEDY = dict(temperature=0.0, max_new_tokens=12, ignore_eos=True)
SSD = dict(speculate=True, speculate_k=2, draft_async=True, async_fan_out=2)
# name -> (num_devices, the mode's engine arguments; "target"/"draft"/"head"
# name a checkpoint).
CASES = {
    "ar_1": (2, {}),
    "ar_2": (4, {}),
    "sd_fused": (2, dict(draft="draft", speculate=True, speculate_k=2, spec_rounds=2)),
    "ssd_dp1": (2, dict(SSD, draft="target")),
    "eagle": (2, dict(SSD, draft="head", use_eagle=True, jit_speculate=True,
                      eagle_layers=[0, 2, 3])),
    "ssd_dp2": (2, dict(SSD, draft="target", draft_dp=2)),
}
TIMEOUT = 150

# One host: every case in turn (one engine after another), then a rendezvous
# that its partner never joins, with a 3 s timeout.
HOST = textwrap.dedent("""
    import json, sys, time
    from datetime import timedelta
    import torch
    torch.set_num_threads(1)
    import ssd_tpu_torch
    from ssd_tpu_torch import SamplingParams
    from ssd_tpu_torch.parallel import comm as tp_comm

    host, spec = int(sys.argv[1]), json.loads(sys.argv[2])
    sp = SamplingParams(**spec["greedy"])
    for name, port, n, kw in spec["cases"]:
        llm = ssd_tpu_torch.LLM(spec["target"], device="cpu", num_hosts=2, num_devices=n,
                                coordinator_address=f"127.0.0.1:{port}", host_id=host,
                                **spec["engine"], **kw)
        outs, metrics = llm.generate(spec["prompts"], sp, use_tqdm=False)
        llm.exit()
        print("CASE", json.dumps(dict(
            name=name, tokens=[o["token_ids"] for o in outs],
            hits=list(map(int, metrics["cache_hits"])),
            accepted=list(map(int, metrics["accepted_suffix_lens_with_recovery"])))),
            flush=True)
    tp_comm.TIMEOUT = timedelta(seconds=3)
    t = time.perf_counter()
    try:
        ssd_tpu_torch.LLM(spec["target"], device="cpu", num_hosts=2, num_devices=2,
                          coordinator_address=f"127.0.0.1:{spec['alone'][host]}",
                          host_id=host, **spec["engine"])
        alone = dict(raised=None)
    except Exception as e:
        alone = dict(raised=type(e).__name__)
    print("ALONE", json.dumps(dict(alone, seconds=time.perf_counter() - t)), flush=True)
""")


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def engine_kw(ckpts, kw: dict) -> dict:
    kw = dict(kw)
    if "draft" in kw:
        kw["draft"] = ckpts[kw["draft"]]
    return kw


def serve(llm) -> dict:
    try:
        outs, metrics = llm.generate([list(p) for p in PROMPTS], SamplingParams(**GREEDY),
                                     use_tqdm=False)
        return dict(tokens=[o["token_ids"] for o in outs],
                    hits=list(map(int, metrics["cache_hits"])),
                    accepted=list(map(int, metrics["accepted_suffix_lens_with_recovery"])))
    finally:
        llm.exit()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {k: str(tmp_path_factory.mktemp(f"mh_{k}")) for k in ("target", "draft", "head")}
    tiny_checkpoint(out["target"], seed=0, scale=0.1, layers=4)
    tiny_checkpoint(out["draft"], seed=7, scale=0.1, layers=1, hidden=32, intermediate=64,
                    head_dim=8)
    make_tiny_eagle(out["head"], draft_vocab=64, seed=3)
    return out


@pytest.fixture(scope="module")
def runs(ckpts):
    """Every case on the two host processes and, meanwhile in this process,
    the references: the port's single-process engines, JAX's AR engine, and
    (f) the engines that spawn every rank here."""
    ports = free_ports(len(CASES) + 2)
    spec = dict(target=ckpts["target"], engine=ENGINE, greedy=GREEDY,
                prompts=[list(p) for p in PROMPTS], alone=ports[-2:],
                cases=[(name, port, n, engine_kw(ckpts, kw))
                       for (name, (n, kw)), port in zip(CASES.items(), ports)])
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", HOST, str(h), json.dumps(spec)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO, env=env)
             for h in range(2)]
    out = {"single": {}, "hosts": [{}, {}], "alone": [None, None]}
    try:
        for name, (_, kw) in CASES.items():
            if name != "ar_2":
                out["single"][name] = serve(ssd_tpu_torch.LLM(
                    ckpts["target"], device="cpu", **ENGINE, **engine_kw(ckpts, kw)))
        out["spawned"] = {name: serve(ssd_tpu_torch.LLM(
            ckpts["target"], device="cpu", num_hosts=2, num_devices=2, **ENGINE,
            **engine_kw(ckpts, CASES[name][1]))) for name in ("ar_1", "ssd_dp2")}
        jllm = JaxLLM(ckpts["target"], **ENGINE)
        try:
            jouts, _ = jllm.generate([list(p) for p in PROMPTS], JaxSamplingParams(**GREEDY),
                                     use_tqdm=False)
        finally:
            jllm.exit()
        out["jax"] = [o["token_ids"] for o in jouts]
        for h, proc in enumerate(procs):
            text, _ = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, text[-4000:]
            for line in text.splitlines():
                if line.startswith("CASE "):
                    case = json.loads(line[5:])
                    out["hosts"][h][case.pop("name")] = case
                elif line.startswith("ALONE "):
                    out["alone"][h] = json.loads(line[6:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_hosts_give_single_process_tokens(runs, name):
    """Both hosts return the tokens of ssd_tpu's AR engine and of the
    port's single-process engine of the same mode, with its cache hits and
    accepted lengths (ar_2 is AR at 2 ranks a host: ar_1's reference)."""
    want = runs["single"]["ar_1" if name == "ar_2" else name]
    assert want["tokens"] == runs["jax"]
    for h in range(2):
        assert runs["hosts"][h][name] == want, f"host {h}"
    if name.startswith("ssd"):
        assert sum(want["hits"]) > 0 and max(want["accepted"]) > 1


@pytest.mark.parametrize("name", ["ar_1", "ssd_dp2"])
def test_spawned_hosts_give_the_hosts_results(runs, name):
    """(f): num_hosts=2 without a coordinator or a group spawns every rank
    in this process and gives the two hosts' results."""
    assert runs["spawned"][name] == runs["hosts"][0][name] == runs["single"][name]


@pytest.mark.parametrize("host", [0, 1])
def test_missing_host_raises(runs, host):
    """A host whose partner never joins raises within the rendezvous
    timeout (3 s): host 0 serving the store, host 1 finding none."""
    alone = runs["alone"][host]
    assert alone["raised"] is not None and alone["seconds"] < 30, alone


def test_union_parts_matches_jax():
    """The union of two hosts' partial replies (each host's partial_reply,
    summed as union_sum sums them) equals JAX's _union_parts over all the
    parts on one host (one process: its psum over a dcn axis of one adds
    nothing), with a ghost row, and rows routed as seq_id % draft_dp."""
    B, K, V, dp = 5, 3, 11, 4
    g = np.random.default_rng(0)
    seq_ids = np.array([4, 1, -1, 6, 3])
    parts = []
    for r in range(dp):
        rows = np.nonzero(np.maximum(seq_ids, 0) % dp == r)[0]
        if len(rows):
            parts.append((r, rows, SpecResponse(
                cache_hits=g.integers(0, 2, len(rows)),
                tokens=g.integers(0, V, (len(rows), K)),
                logits_q=torch.from_numpy(g.standard_normal((len(rows), K, V))
                                          .astype(np.float32)))))
    host_parts = [[(rows, resp) for r, rows, resp in parts if r // 2 == h] for h in range(2)]
    sums = [sum(x) for x in zip(*(partial_reply(p, B, K, V, "cpu") for p in host_parts))]
    ints, logits = sums

    jspec = JaxSpeculatorAsync.__new__(JaxSpeculatorAsync)
    jspec._union_jit = None
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8), ("dcn", "tp"))
    jspec.target_sharding = NamedSharding(mesh, P())
    jparts = [(rows, type("R", (), dict(tokens=resp.tokens, cache_hits=resp.cache_hits,
                                        logits_q=resp.logits_q.numpy())))
              for _, rows, resp in parts]
    jtok, jhits, jlogits = jspec._union_parts(jparts, B, K)
    np.testing.assert_array_equal(ints[:, :K].numpy(), jtok)
    np.testing.assert_array_equal(ints[:, K].numpy(), jhits)
    np.testing.assert_array_equal(logits.numpy(), np.asarray(jlogits)[:B])


REFUSALS = [
    (dict(num_hosts=2, num_devices=3), "divide by num_hosts"),
    (dict(num_hosts=2, num_devices=2, speculate=True, draft_async=True, async_fused=True),
     "async_fused"),
    (dict(num_hosts=2, num_devices=2, speculate=True, draft_async=True, draft_dp=3),
     "divisible by num_hosts"),
    (dict(num_hosts=2, num_devices=2, coordinator_address="127.0.0.1:1"), "host_id"),
    (dict(num_hosts=2, num_devices=2, coordinator_address="127.0.0.1:1", host_id=2),
     "host_id"),
    (dict(num_hosts=2, num_devices=2, coordinator_address="localhost", host_id=0),
     "host:port"),
    (dict(coordinator_address="127.0.0.1:1", host_id=0), "num_hosts > 1"),
    (dict(num_hosts=2, num_devices=2, host_id=1), "host_id needs coordinator_address"),
]


@pytest.mark.parametrize("kw,msg", REFUSALS, ids=[m for _, m in REFUSALS])
def test_refusals(ckpts, kw, msg):
    """Inconsistent settings raise ValueError before any rank is spawned."""
    if kw.get("speculate"):
        kw = dict(kw, draft=ckpts["target"])
    with pytest.raises(ValueError, match=msg):
        ssd_tpu_torch.LLM(ckpts["target"], device="cpu", **ENGINE, **kw)
    assert not dist.is_initialized() and tp_comm._spawned is None


def test_coordinator_over_a_callers_group_is_refused(ckpts, tmp_path):
    """A coordinator makes the engine join the hosts itself: over a
    caller's group it is refused, and the group stays the caller's."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="caller's process group"):
            ssd_tpu_torch.LLM(ckpts["target"], device="cpu", num_hosts=2, num_devices=2,
                              coordinator_address="127.0.0.1:1", host_id=0, **ENGINE)
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


L70 = dict(model_type="llama", vocab_size=128256, hidden_size=8192,
           intermediate_size=28672, num_hidden_layers=80, num_attention_heads=64,
           num_key_value_heads=8, head_dim=128, max_position_embeddings=8192)


def test_70b_shards_over_two_hosts_match_jax():
    """Llama-70B over 2 hosts x 4 ranks: each global rank h*4 + l holds, on
    the meta device, the shapes JAX puts on mesh device (h, l) of a
    ("dcn", "tp") = (2, 4) mesh (every axis divides by 8, so each is
    sharded over both), and its KV cache's k/v heads equal kv_sharding's."""
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("dcn", "tp"))
    jarch = JaxArch.from_model_config(JaxModelConfig(**L70))
    shapes = jax.eval_shape(lambda: jax_init_params(jarch, jax.random.PRNGKey(0),
                                                    jnp.bfloat16))
    specs = param_specs(shapes)

    def per_device(x, spec):
        return NamedSharding(mesh, _compatible_spec(x, spec, mesh)).shard_shape(x.shape)

    want = {k: per_device(v, specs[k]) for k, v in shapes.items() if k != "layers"}
    want_layer = {k: per_device(v, specs["layers"][k])[1:]
                  for k, v in shapes["layers"].items()}
    kv = jax.ShapeDtypeStruct((80, 8, 4096, 256), jnp.bfloat16)
    want_kv = kv_sharding(mesh, 8).shard_shape(kv.shape)[1]

    arch = Arch.from_model_config(ModelConfig(**L70))
    whole = {k: v.shape for k, v in shapes.items() if k != "layers"}
    whole_layer = {k: v.shape[1:] for k, v in shapes["layers"].items()}
    assert set(want_layer) == {"input_ln", "wq", "wk", "wv", "wo", "post_ln", "gate", "up",
                               "down"}
    for rank in range(8):
        sh = Sharding(arch, rank, 8)
        got = {k: tuple(sh.leaf(k, torch.empty(s, device="meta")).shape)
               for k, s in whole.items()}
        got_layer = {k: tuple(sh.leaf(k, torch.empty(s, device="meta")).shape)
                     for k, s in whole_layer.items()}
        assert got == want and got_layer == want_layer, rank
        assert sh.rank_arch().num_kv_heads == want_kv == 1
