"""The engine surface the port shares with the JAX package, on the CPU, in
fp32, on the same tiny checkpoints (test_torch_tp.py's writer; the EAGLE-3
head of make_tiny_eagle):

- generate(stream_callback=...): per sequence, the chunks concatenate to
  the returned token_ids, and the sequence of calls (sequence, chunk)
  equals ssd_tpu's on the same engine, for AR and sync SD (sequence ids
  compared by submission order: each package numbers its own);
- Config.max_steps=n returns what ssd_tpu's returns (the sequences that
  finished within n engine steps);
- Config.debug_mode writes debug_outputs/draft_prefill_inputs.npz with the
  arrays, keys and dtypes of ssd_tpu's (the fused EAGLE superstep);
- ssd_tpu_torch.paths equals ssd_tpu.paths under the same environment.
"""

import importlib

import numpy as np
import pytest
import torch

from ssd_tpu import SamplingParams as JaxSamplingParams
from ssd_tpu import paths as jax_paths
from ssd_tpu.llm import LLM as JaxLLM
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams, paths
from tests.test_torch_tp import tiny_checkpoint
from tests.utils_models import make_tiny_eagle, random_prompt, rng


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ENGINE = dict(max_model_len=256, max_num_batched_tokens=1024, kvcache_block_size=16,
              num_kvcache_blocks=64, max_num_seqs=3, dtype="float32")
PROMPTS = [random_prompt(rng(110 + i), 6, 16) for i in range(3)]
# Different lengths, so that sequences finish at different steps.
SAMPLING = [dict(temperature=0.0, max_new_tokens=n, ignore_eos=True) for n in (7, 12, 4)]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {k: str(tmp_path_factory.mktemp(f"surface_{k}")) for k in ("target", "draft", "head")}
    tiny_checkpoint(out["target"], seed=0, scale=0.1, layers=4)
    tiny_checkpoint(out["draft"], seed=7, scale=0.1, layers=1, hidden=32, intermediate=64,
                    head_dim=8)
    make_tiny_eagle(out["head"], seed=3)
    return out


MODES = {"ar": {}, "sd": dict(speculate=True, speculate_k=3)}


def _engine_kw(ckpts, mode):
    return dict(ENGINE, **MODES[mode], **({"draft": ckpts["draft"]} if mode != "ar" else {}))


def _generate(llm, sp_cls, stream=False):
    """(token ids by submission order, [(submission index, chunk)])."""
    calls = []
    cb = (lambda seq_id, ids: calls.append((seq_id, list(ids)))) if stream else None
    try:
        outs, _ = llm.generate([list(p) for p in PROMPTS], [sp_cls(**s) for s in SAMPLING],
                               use_tqdm=False, stream_callback=cb)
    finally:
        llm.exit()
    order = {s: i for i, s in enumerate(sorted({s for s, _ in calls}))}
    return [o["token_ids"] for o in outs], [(order[s], ids) for s, ids in calls]


@pytest.mark.parametrize("mode", list(MODES))
def test_stream_callback_equals_jax(ckpts, mode):
    kw = _engine_kw(ckpts, mode)
    got, calls = _generate(ssd_tpu_torch.LLM(ckpts["target"], device="cpu", **kw),
                           SamplingParams, stream=True)
    want, jcalls = _generate(JaxLLM(ckpts["target"], **kw), JaxSamplingParams, stream=True)
    assert calls == jcalls
    assert got == want
    for i, ids in enumerate(got):
        assert sum((c for s, c in calls if s == i), []) == ids
    assert len(calls) > len(PROMPTS)   # streamed in steps, not only at the end


@pytest.mark.parametrize("mode,steps", [("ar", 5), ("sd", 5)])
def test_max_steps_equals_jax(ckpts, mode, steps):
    kw = dict(_engine_kw(ckpts, mode), max_steps=steps)
    got, _ = _generate(ssd_tpu_torch.LLM(ckpts["target"], device="cpu", **kw), SamplingParams)
    want, _ = _generate(JaxLLM(ckpts["target"], **kw), JaxSamplingParams)
    assert got == want
    assert 0 < len(got) < len(PROMPTS)   # the loop ended with sequences unfinished


def test_debug_mode_npz_equals_jax(ckpts, tmp_path, monkeypatch):
    kw = dict(ENGINE, draft=ckpts["head"], speculate=True, use_eagle=True, speculate_k=2,
              spec_rounds=2, eagle_layers=[0, 2, 3], debug_mode=True)
    files = {}
    for name, make, sp_cls in (("port", lambda: ssd_tpu_torch.LLM(ckpts["target"],
                                                                   device="cpu", **kw),
                                SamplingParams),
                               ("jax", lambda: JaxLLM(ckpts["target"], **kw), JaxSamplingParams)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        _generate(make(), sp_cls)
        files[name] = np.load(d / "debug_outputs" / "draft_prefill_inputs.npz")
    got, want = files["port"], files["jax"]
    assert set(got.files) == set(want.files) == {
        "input_ids", "target_hidden_states", "d_model_target", "eagle_layers"}
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["input_ids"], PROMPTS[0])


def test_paths_equal_jax(tmp_path, monkeypatch):
    """The cache's newest snapshot, or the variables that name the paths."""
    snaps = tmp_path / "hub" / "models--meta-llama--Llama-3.1-8B-Instruct" / "snapshots"
    for s in ("a1", "b2"):
        (snaps / s).mkdir(parents=True)
    names = ("HF_CACHE_DIR", "DATASET_DIR", "DEFAULT_TARGET", "DEFAULT_DRAFT", "DATASET_PATHS")
    cases = [{"SSD_HF_CACHE": str(tmp_path / "hub"), "SSD_DATASET_DIR": str(tmp_path / "data")},
             {"SSD_DEFAULT_TARGET": "/t", "SSD_DEFAULT_DRAFT": "/d"}]
    try:
        for env in cases:
            with monkeypatch.context() as m:
                for k in ("SSD_HF_CACHE", "SSD_DATASET_DIR", "SSD_DEFAULT_TARGET",
                          "SSD_DEFAULT_DRAFT"):
                    m.delenv(k, raising=False)
                for k, v in env.items():
                    m.setenv(k, v)
                importlib.reload(paths)
                importlib.reload(jax_paths)
                for n in names:
                    assert getattr(paths, n) == getattr(jax_paths, n), n
        assert paths.DEFAULT_TARGET == "/t"
    finally:
        importlib.reload(paths)
        importlib.reload(jax_paths)
    assert paths.DATASET_PATHS == jax_paths.DATASET_PATHS
