"""The step-decomposition tools of the port (ssd_tpu_torch/bench/sd_diag.py,
fasync_diag.py, prefill_diag.py) on the CPU, at the tiny geometry in fp32:

- every variant of every tool, at R = 2, against the same composition of
  ssd_tpu's public functions (sd_superstep, eagle_sd_superstep,
  chain_decode_step, eagle_chain_program, decode_step, async_ssd_superstep,
  tree_build_program, verify, get_forked_recovery_tokens,
  flat_prefill_step with the plain attention, forward_hidden and
  compute_logits with the same identity attention) on the same weights
  (ssd_tpu's init_params / init_eagle_params, carried across with
  weights.py::params_from_jax) and inputs: greedy tokens, accepted lengths
  and fork tokens exact; logits, taps, activations and both KV caches
  within 1e-5 + 1e-5 |ref|;
- each main([... "--tiny", "--device", "cpu"]) (the tools' bf16) prints
  one JSON line with the JAX script's keys;
- without a card, --device cuda (the default) raises.

The graph replay of each tool's full variant against its eager call is a
card test (tests/test_torch_cuda.py).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssd_tpu.config import ModelConfig as JaxModelConfig
from ssd_tpu.engine import async_fused as jaf
from ssd_tpu.engine import draft_runner as jdr
from ssd_tpu.engine import eagle_runner as jer
from ssd_tpu.engine import fused_sd as jfsd
from ssd_tpu.engine import model_runner as jmr
from ssd_tpu.models import eagle3 as je3
from ssd_tpu.models import transformer as jtf
from ssd_tpu.ops import attention as jatt
from ssd_tpu.ops.layers import silu_mul as jsilu_mul
from ssd_tpu.ops.sampler import sample as jsample
from ssd_tpu.ops.spec_math import get_forked_recovery_tokens as jfork
from ssd_tpu.ops.verify import verify as jverify
from ssd_tpu_torch.bench import diag_timing as dt
from ssd_tpu_torch.bench import fasync_diag, prefill_diag, sd_diag
from ssd_tpu_torch.engine.model_runner import served_params
from ssd_tpu_torch.weights import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


R, K, F, B, CTX, BS = 2, 4, 2, 2, 256, dt.BLOCK
TOL = dict(rtol=1e-5, atol=1e-5)
KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _jax_config(layers):
    return JaxModelConfig(num_hidden_layers=layers, **dt.TINY_WIDTH)


def _port(jparams):
    return served_params(params_from_jax(jax.device_get(jparams)), None)


@pytest.fixture(scope="module")
def models():
    """The tiny target (2 layers), plain draft (1) and EAGLE-3 head, each
    as ssd_tpu's (arch, params) and the port's params."""
    Lt, Ld = sd_diag.LAYERS[True]
    t_arch = jtf.Arch.from_model_config(_jax_config(Lt))
    d_arch = jtf.Arch.from_model_config(_jax_config(Ld))
    e_arch = je3.EagleArch.from_model_config(_jax_config(Lt), d_model_target=t_arch.hidden_size,
                                             num_eagle_layers=3)
    jt = jtf.init_params(t_arch, jax.random.PRNGKey(0), jnp.float32)
    jd = jtf.init_params(d_arch, jax.random.PRNGKey(1), jnp.float32)
    je = je3.init_eagle_params(e_arch, jax.random.PRNGKey(1), jnp.float32)
    return {"target": (t_arch, jt, _port(jt)), "draft": (d_arch, jd, _port(jd)),
            "eagle": (e_arch, je, _port(je))}


def _sd_case(models, eagle, tool=sd_diag, **kw):
    """The port's case and the JAX side's (arches, params, taps)."""
    t_arch, d_arch, taps = sd_diag.archs(True, eagle)
    jt_arch, jt, pt = models["target"]
    jd_arch, jd, pd = models["eagle" if eagle else "draft"]
    c = tool.make_case(pt, pd, t_arch, d_arch, K=K, R=R, ctx_pad=CTX, device=CPU, B=B,
                       **({"eagle_layers": taps} if tool is sd_diag else kw))
    return c, (jt_arch, jt, jd_arch, jd, taps)


def _np(c):
    """The case's inputs as JAX arrays."""
    return {k: jnp.asarray(getattr(c, k).numpy()) for k in ("rec0", "n0", "bt", "temps")}


def _zeros(kv):
    return jnp.zeros(tuple(kv.shape), jnp.float32)


# --- sd_diag --------------------------------------------------------------------------


@pytest.mark.parametrize("eagle", [False, True], ids=["plain", "eagle"])
@pytest.mark.parametrize("variant", ["full", "draft", "verify"])
def test_sd_diag_variant_matches_jax(models, variant, eagle):
    c, (jt_arch, jt, jd_arch, jd, taps) = _sd_case(models, eagle)
    got = sd_diag.VARIANTS[variant](c)()
    x = _np(c)
    tkv, dkv = _zeros(c.t_kv), _zeros(c.d_kv)
    Kp1 = K + 1
    if variant == "full":
        if eagle:
            specs, accs, recs, acts, tkv, dkv = jfsd.eagle_sd_superstep(
                jt, tkv, jd, dkv, x["rec0"], jnp.asarray(c.acts0.numpy()), x["n0"], x["bt"],
                x["bt"], x["temps"], x["temps"], KEY, t_arch=jt_arch, d_arch=jd_arch,
                block_size=BS, ctx_pad_t=CTX, ctx_pad_d=CTX, K=K, R=R, eagle_layers=taps,
                use_pallas=False)
            close(got[3], acts)
        else:
            specs, accs, recs, tkv, dkv = jfsd.sd_superstep(
                jt, tkv, jd, dkv, x["rec0"], x["n0"], x["bt"], x["bt"], x["temps"],
                x["temps"], KEY, t_arch=jt_arch, d_arch=jd_arch, block_size=BS,
                ctx_pad_t=CTX, ctx_pad_d=CTX, K=K, R=R)
        for g, w in zip(got[:3], (specs, accs, recs)):
            exact(g, w)
    elif variant == "draft":
        rec, n, last = x["rec0"], x["n0"], []
        acts = jnp.zeros((B, jd_arch.num_eagle_layers * jd_arch.d_model_target), jnp.float32) \
            if eagle else None
        for _ in range(R):
            if eagle:
                toks, _, _, dkv = jer.eagle_chain_program(
                    jd, dkv, rec, acts, n - 1, x["bt"], x["temps"], KEY, arch=jd_arch,
                    block_size=BS, ctx_pad=CTX, K=K + 1, sampler_x=None, F=2,
                    use_pallas=False)
            else:
                toks, _, dkv = jmr.chain_decode_step(
                    jd, dkv, rec, n, x["bt"], n + 1, x["temps"], KEY, arch=jd_arch,
                    block_size=BS, ctx_pad=CTX, K=K, extra_write=True)
            rec, n = toks[:, -1], n + Kp1
            last.append(rec)
        exact(got, jnp.stack(last))
    else:
        n, toks, logits = x["n0"], [], []
        spec = jnp.repeat(x["rec0"], Kp1)
        for _ in range(R):
            pos = (n[:, None] + jnp.arange(Kp1)[None]).reshape(-1)
            slots = jmr.slot_of(x["bt"], pos, jnp.repeat(jnp.arange(B), Kp1), BS)
            tok, lg, _, tkv = jmr.decode_step(
                jt, tkv, spec, pos, slots, x["bt"], n + Kp1, x["temps"], KEY, arch=jt_arch,
                block_size=BS, ctx_pad=CTX, q_len=Kp1, eagle_layers=taps)
            n = n + Kp1
            toks.append(tok)
            logits.append(lg)
        exact(got[0], jnp.stack(toks))
        close(got[1], logits[-1])
    close(c.t_kv, tkv)
    close(c.d_kv, dkv)


# --- fasync_diag ------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["full", "build", "verify", "fork", "sync"])
def test_fasync_diag_variant_matches_jax(models, variant):
    c, (jt_arch, jt, jd_arch, jd, _) = _sd_case(models, False, tool=fasync_diag, F=F)
    got = fasync_diag.VARIANTS[variant](c)()
    x = _np(c)
    tkv, dkv = _zeros(c.t_kv), _zeros(c.d_kv)
    fan = (F,) * (K + 1)
    MQ = sum(fan)
    V = jt_arch.vocab_size
    glue = jnp.tile(jnp.arange(K + 1, dtype=jnp.int32)[None], (B, 1))
    ones = jnp.ones(B, jnp.int32)
    if variant == "full":
        specs, accs, recs, hits, tkv, dkv = jaf.async_ssd_superstep(
            jt, tkv, jd, dkv, x["rec0"], x["n0"], x["bt"], x["bt"], x["temps"], x["temps"],
            KEY, t_arch=jt_arch, d_arch=jd_arch, block_size=BS, ctx_pad_t=CTX, ctx_pad_d=CTX,
            K=K, MQ_LEN=MQ, R=R, fan_out_list=fan, fan_out_list_miss=fan, sampler_x=None, F=F)
        for i, w in enumerate((accs, recs, hits)):
            exact(got[..., K + 1 + i], w)
        exact(got[..., :K + 1], specs)
    elif variant == "build":
        n, outs, logits = x["n0"], [], []
        for _ in range(R):
            host_out, spec_logits, _, dkv = jdr.tree_build_program(
                jd, dkv, glue.reshape(-1), n, x["bt"], ones, x["temps"], None, None, KEY,
                arch=jd_arch, block_size=BS, ctx_pad=CTX, K=K, MQ_LEN=MQ, fan_out_list=fan,
                fan_out_list_miss=fan, sampler_x=None, F=F)
            n = n + K + 1
            outs.append(host_out)
            logits.append(spec_logits)
        trees, spec_logits = got
        for r in range(R):
            exact(trees[r, :, :, 0].reshape(-1), outs[r][:B * MQ])
            exact(trees[r, :, :, 1:].reshape(-1), outs[r][B * MQ:])
        close(spec_logits, logits[-1].reshape(B * MQ, K, V))
    elif variant == "verify":
        n, accs, recs = x["n0"], [], []
        for _ in range(R):
            pos = (n[:, None] + jnp.arange(K + 1)[None]).reshape(-1)
            slots = jmr.slot_of(x["bt"], pos, jnp.repeat(jnp.arange(B), K + 1), BS)
            _, logits_p, _, tkv = jmr.decode_step(
                jt, tkv, glue.reshape(-1), pos, slots, x["bt"], n + K + 1, x["temps"], KEY,
                arch=jt_arch, block_size=BS, ctx_pad=CTX, q_len=K + 1)
            acc, rec = jverify(logits_p.reshape(B, K + 1, V), jnp.zeros((B, K, V)), glue,
                               x["temps"], x["temps"], ones, KEY)
            n = n + acc + 1
            accs.append(acc)
            recs.append(rec)
        exact(got[0], jnp.stack(accs))
        exact(got[1], jnp.stack(recs))
    elif variant == "fork":
        forks = jfork(jnp.asarray(c.glue_logits.numpy()), ones, glue, list(fan), list(fan))
        exact(got, jnp.stack([forks] * R))
    else:
        specs, accs, recs, tkv, dkv = jfsd.sd_superstep(
            jt, tkv, jd, dkv, x["rec0"], x["n0"], x["bt"], x["bt"], x["temps"], x["temps"],
            KEY, t_arch=jt_arch, d_arch=jd_arch, block_size=BS, ctx_pad_t=CTX, ctx_pad_d=CTX,
            K=K, R=R)
        for g, w in zip(got, (specs, accs, recs)):
            exact(g, w)
    close(c.t_kv, tkv)
    close(c.d_kv, dkv)


# --- prefill_diag ------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["full", "no_kernel", "no_attn", "matmul", "head"])
def test_prefill_diag_variant_matches_jax(models, variant):
    jarch, jp, pp = models["target"]
    port_arch = prefill_diag.Arch.from_model_config(dt.model_config(True, jarch.num_layers))
    T = prefill_diag.TINY_MAX_T
    c = prefill_diag.make_case(pp, port_arch, T=T, R=R, device=CPU)
    got = prefill_diag.VARIANTS[variant](c)()
    j = {k: jnp.asarray(getattr(c, k).numpy()) for k in (
        "ids", "positions", "pages", "row_lo", "row_hi", "gather_idx", "temps", "x0")}
    kv = _zeros(c.kv)
    V = jarch.vocab_size

    def ids_at(i):
        return (j["ids"] + i) % V

    toks, logits = [], []
    if variant == "full":
        for i in range(R):
            tok, lg, kv = jmr.flat_prefill_step(
                jp, kv, ids_at(i), j["positions"], j["positions"], j["pages"], j["row_lo"],
                j["row_hi"], j["gather_idx"], j["temps"], KEY, arch=jarch, block_size=BS,
                use_pallas=False)
            toks.append(tok)
            logits.append(lg)
    elif variant in ("no_kernel", "no_attn"):
        def attn_call(q, k, v, kv_layer):
            if variant == "no_kernel":
                kv_layer = jatt.store_kv(kv_layer, k, v, j["positions"])
            return q, kv_layer

        for i in range(R):
            hidden, kv = jtf.forward_hidden(jp, kv, ids_at(i), j["positions"], attn_call, jarch)
            lg = jtf.compute_logits(jp, hidden, jarch, gather_idx=j["gather_idx"])
            toks.append(jsample(lg, j["temps"], KEY))
            logits.append(lg)
    elif variant == "matmul":
        x = j["x0"]
        for _ in range(R):
            for li in range(jarch.num_layers):
                lp = {k: v[li] for k, v in jp["layers"].items()}
                q, k, v = x @ lp["wq"], x @ lp["wk"], x @ lp["wv"]
                pad = ((0, 0), (0, q.shape[1] - k.shape[1]))
                h = (q + jnp.pad(k, pad) + jnp.pad(v, pad)) @ lp["wo"]
                x = jsilu_mul(h @ lp["gate"], h @ lp["up"]) @ lp["down"]
        close(got, x)
        return
    else:
        for _ in range(R):
            lg = jtf.compute_logits(jp, j["x0"], jarch, gather_idx=j["gather_idx"])
            toks.append(jsample(lg, j["temps"], KEY))
            logits.append(lg)
    exact(got[0], jnp.stack(toks))
    close(got[1], jnp.stack(logits))
    close(c.kv, kv)


# --- the entry points ----------------------------------------------------------------------


KEYS = {"sd": {"metric", "full", "draft", "verify", "residual_ms"},
        "fasync": {"metric", "full", "build", "verify", "fork", "sync", "residual_ms"},
        "prefill": {"metric", "t", "full", "no_kernel", "no_attn", "matmul", "head",
                    "matmul_floor_ms", "kernel_ms", "kv_store_ms", "non_matmul_ms",
                    "mxu_pct_full"}}
TOOLS = {"sd": sd_diag, "fasync": fasync_diag, "prefill": prefill_diag}
SMALL = {"sd": ["--rounds", "2", "--ctx-pad", "256"],
         "fasync": ["--rounds", "2", "--ctx-pad", "256", "--batch", "2"],
         "prefill": ["--r", "2"]}


@pytest.mark.parametrize("tool,extra", [("sd", []), ("sd", ["--eagle"]), ("fasync", []),
                                        ("prefill", [])], ids=["sd", "sd_eagle", "fasync",
                                                               "prefill"])
def test_main_prints_one_json_line(tool, extra, capsys):
    out = TOOLS[tool].main(["--tiny", "--device", "cpu", "--reps", "1", *SMALL[tool],
                            *extra])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert KEYS[tool] <= set(line)
    assert line == json.loads(json.dumps(out))
    assert line["device"] == "cpu" and line["full_replay_equals_eager"] is None
    assert all(np.isfinite(line[v]) and line[v] > 0 for v in line["launches"])


@pytest.mark.parametrize("tool", list(TOOLS))
def test_cuda_without_a_card_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TOOLS[tool].main(["--tiny", *SMALL[tool]])
