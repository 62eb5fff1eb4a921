"""The unfused async draft's topology in the port: draft data parallelism
(draft_dp replicas beside the target) and the draft on ranks of its own
(num_devices >= tp_size + draft_dp), on the CPU over gloo, against the JAX
package's DraftServer on the same checkpoints (the reduced-vocabulary pair
of tests/test_torch_draft_vocab.py, whose draft both hits and misses):

- draft_dp=2 on the target's device: two runners, each serving the rows
  seq_id % 2 of three prompts (an uneven split); greedy fp32 tokens equal
  draft_dp=1's and ssd_tpu's LLM(draft_dp=2, num_devices=3);
- num_devices=2: a tp-1 target and the draft in a spawned process; tokens
  equal the single-process SSD's and ssd_tpu's num_devices=2 engine;
- num_devices=3, draft_dp=1: a tp-2 target (its collectives over the
  target's two ranks only) and a draft rank, with the same tokens; and
  num_devices=3, draft_dp=2: two draft ranks;
- a draft rank that fails at start-up, and one killed while serving, raise
  RuntimeError("draft server died") in the target; after exit() no group
  is left and no spawned process is alive;
- the refusals: draft_dp not divisible by num_hosts (the replicas split
  over the hosts), async_fused with draft_dp > 1, draft_dp without
  draft_async.
"""

import multiprocessing as mp
import os
import signal

import pytest
import torch
import torch.distributed as dist

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu.llm import LLM as JaxLLM
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.parallel import comm as tp_comm
from ssd_tpu_torch.parallel.draft_rank import DraftRanks
from ssd_tpu_torch.utils.loader import SafetensorsIndex, save_safetensors
from tests.test_torch_draft_vocab import VOCAB, write_pair
from tests.utils_models import random_prompt, rng

ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024, kvcache_block_size=16,
              num_kvcache_blocks=64, max_num_seqs=4, dtype="float32")
SSD = dict(speculate=True, speculate_k=3, draft_async=True, async_fan_out=2)
PROMPTS = [random_prompt(rng(40 + i), 8, 20, vocab=VOCAB) for i in range(3)]
GREEDY = dict(temperature=0.0, max_new_tokens=20, ignore_eos=True)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return write_pair(str(tmp_path_factory.mktemp("draft_dp")))


def serve(llm):
    outs, metrics = llm.generate([list(p) for p in PROMPTS], SamplingParams(**GREEDY),
                                 use_tqdm=False)
    return [o["token_ids"] for o in outs], metrics


def jax_tokens(target, draft, **kw):
    llm = JaxLLM(target, draft=draft, **ENGINE, **SSD, **kw)
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


@pytest.fixture(scope="module")
def ssd_tokens(pair):
    """The single-process SSD engine's tokens (draft_dp=1)."""
    llm = ssd_tpu_torch.LLM(pair[0], device="cpu", draft=pair[1], **ENGINE, **SSD)
    try:
        return serve(llm)[0]
    finally:
        llm.exit()


def test_draft_dp2_shared_device(pair, ssd_tokens):
    target, draft = pair
    llm = ssd_tpu_torch.LLM(target, device="cpu", draft=draft, draft_dp=2, **ENGINE, **SSD)
    try:
        assert llm.config.tp_size == 1 and llm.config.draft_ranks == 0
        assert len(llm.draft_server.runners) == 2
        assert len(llm.scheduler.draft_block_managers) == 2
        got, metrics = serve(llm)
        llm.draft_server.drain()
        served = [{int(k) for k in r.tree_cache_keys[:, 0]} for r in llm.draft_server.runners]
    finally:
        llm.exit()
    # Each replica built its last tree over its own rows, and both had some.
    assert all(served) and all(s % 2 == r for r, ids in enumerate(served) for s in ids)
    assert metrics["cache_hits"]
    assert got == ssd_tokens
    assert got == jax_tokens(target, draft, draft_dp=2, num_devices=3)


def test_draft_rank_beside_tp1_target(pair, ssd_tokens):
    """num_devices=2: the target on rank 0 (no collectives), the draft
    replica in the spawned rank 1."""
    target, draft = pair
    llm = ssd_tpu_torch.LLM(target, device="cpu", draft=draft, num_devices=2,
                            **ENGINE, **SSD)
    try:
        assert llm.config.tp_size == 1 and llm.config.draft_ranks == 1
        assert isinstance(llm.draft_server, DraftRanks) and llm.model_comm is None
        (proc, _), = llm.comm.draft_procs
        assert proc.is_alive() and proc.pid != os.getpid()
        got, metrics = serve(llm)
        assert metrics["cache_hits"] and llm.draft_server.exchange_s
    finally:
        llm.exit()
    assert no_ranks_left()
    assert got == ssd_tokens
    assert got == jax_tokens(target, draft, num_devices=2)


@pytest.mark.parametrize("dp", [1, 2])
def test_draft_ranks_beside_tp2_target(pair, ssd_tokens, dp):
    """num_devices=3: a tp-2 target and one draft rank (dp 1), or a tp-1
    target and two draft ranks (dp 2); the tokens of the one-process SSD."""
    target, draft = pair
    llm = ssd_tpu_torch.LLM(target, device="cpu", draft=draft, num_devices=3, draft_dp=dp,
                            **ENGINE, **SSD)
    try:
        assert llm.config.tp_size == 3 - dp and llm.config.draft_ranks == dp
        assert llm.model_runner.arch.num_heads == 4 // (3 - dp)
        assert len(llm.comm.draft_procs) == dp and len(llm.comm.workers) == 2 - dp
        got, _ = serve(llm)
    finally:
        llm.exit()
    assert no_ranks_left()
    assert got == ssd_tokens


def test_draft_rank_failures_raise_in_target(pair, tmp_path):
    """A draft checkpoint the draft rank cannot load (a missing tensor; the
    target reads only its config) fails the engine's construction with
    RuntimeError("draft server died"); a draft rank killed while the engine
    serves fails the next step the same way. No rank is left after
    either."""
    target, draft = pair
    broken = tmp_path / "broken"
    broken.mkdir()
    index = SafetensorsIndex(draft)
    save_safetensors(str(broken / "model.safetensors"),
                     {n: index.get(n) for n in index.names() if "layers.1." not in n})
    with open(os.path.join(draft, "config.json")) as f:
        (broken / "config.json").write_text(f.read())
    with pytest.raises(RuntimeError, match="draft server died"):
        ssd_tpu_torch.LLM(target, device="cpu", draft=str(broken), num_devices=2,
                          **ENGINE, **SSD)
    assert no_ranks_left()

    llm = ssd_tpu_torch.LLM(target, device="cpu", draft=draft, num_devices=2, **ENGINE, **SSD)
    try:
        (proc, _), = llm.comm.draft_procs
        os.kill(proc.pid, signal.SIGKILL)
        proc.join(timeout=30)
        with pytest.raises(RuntimeError, match="draft server died"):
            serve(llm)
    finally:
        llm.exit()
    assert no_ranks_left()


def test_refusals(pair):
    """What is refused names the JAX package's rule, before any rank is
    spawned."""
    target, draft = pair
    cases = [
        (dict(num_hosts=2, num_devices=2, draft_dp=3, **SSD), ValueError,
         "divisible by num_hosts"),
        (dict(async_fused=True, draft_dp=2, **SSD), ValueError, "draft_dp"),
        (dict(draft_dp=2, speculate=True, speculate_k=2), ValueError, "draft_dp"),
    ]
    for kw, err, msg in cases:
        with pytest.raises(err, match=msg):
            ssd_tpu_torch.LLM(target, device="cpu", draft=draft, **ENGINE, **kw)
    assert no_ranks_left()
