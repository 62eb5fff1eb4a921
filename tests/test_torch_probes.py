"""The plain versions of the port's two bench probes against the JAX
package's probe kernels, run as its own tests run Pallas on the CPU
(interpret mode), on the same numpy inputs:

- ops/probes.py::s8_dot_plain (the plain version of csrc/s8_probe.cu's
  three paths) against bench/s8_probe.py's _kernel_s8 and _kernel_bf16 through
  pl.pallas_call(interpret=True), bit for bit, and against its `run` entry
  point's checksum;
- paged_attention_diag's "full" stage on CPU tensors (the plain paged
  attention) against bench/kernel_diag.py::diag_attention(do_dma=True,
  do_compute=True, interpret=True), in fp32 to 1e-5; the other stages compute
  no defined function and are refused on the CPU;
- the bench entry points' CPU forms.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from bench import kernel_diag as jdiag
from bench import s8_probe as js8
from ssd_tpu_torch.bench import s8_probe
from ssd_tpu_torch.ops import probes


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker (the HF oracle of the
    JAX package's tests) keeps its own thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pallas_product(kernel, q, k, out_dtype):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((q.shape[0], q.shape[1], k.shape[1]), out_dtype),
        interpret=True)(q, k))


@pytest.mark.parametrize("mode", ["s8", "bf16"])
def test_s8_probe_plain_matches_pallas(mode):
    """The probe's shapes at a quarter of its batch (16 row blocks of 8
    rows, 512 positions, D = 128): the fp64 plain product equals the Pallas
    kernel's s32 (or fp32) product exactly, and run()'s checksum (an int32
    sum, which wraps)."""
    q8, k8, qb = s8_probe.inputs("cpu")
    q8, k8, qb = q8[:16], k8[:16], qb[:16]
    jq8, jk8 = jnp.asarray(q8.numpy()), jnp.asarray(k8.numpy())
    if mode == "s8":
        got = probes.s8_dot_plain(q8, k8)
        want = _pallas_product(js8._kernel_s8, jq8, jk8, jnp.int32)
        assert got.dtype == torch.int32
        check = int(np.asarray(js8.run(jq8, jk8, mode="s8", interpret=True, iters=1)))
        wrapped = int(got.to(torch.int64).sum()) & 0xFFFFFFFF
        assert check & 0xFFFFFFFF == wrapped
    else:
        got = probes.s8_dot_plain(qb, k8)
        jqb = jq8.astype(jnp.bfloat16)
        want = _pallas_product(js8._kernel_bf16, jqb, jk8, jnp.float32)
        assert got.dtype == torch.float32
        check = float(np.asarray(js8.run(jqb, jk8, mode="bf16", interpret=True, iters=1)))
        assert check == pytest.approx(float(got.double().sum()), rel=1e-6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_s8_probe_wrappers_on_cpu_take_the_plain_version():
    """Each path's wrapper on CPU tensors is the plain version; the probe's
    entry point runs its CPU form."""
    q8, k8, qb = s8_probe.inputs("cpu")
    q8, k8, qb = q8[:4], k8[:4, :64], qb[:4]
    want = probes.s8_dot_plain(q8, k8)
    for fn, q in ((probes.s8_dot_mma, q8), (probes.s8_dot_dp4a, q8), (probes.s8_dot_bf16, qb)):
        assert torch.equal(fn(q, k8).double(), want.double())
    s8_probe.main(["--interpret"])


def test_diag_full_stage_matches_kernel_diag():
    """The diag's production stage on the CPU against the JAX diag kernel
    with its DMA and compute both on (interpret mode): the V half of its
    [q | 0] output, regrouped, at B=2 with contexts 64 and 37."""
    B, Q, Hq, Hkv, hd, bs = 2, 1, 8, 2, 64, 16
    ctx_lens = [64, 37]
    M = 4
    r = np.random.default_rng(0)
    kv = r.normal(size=(Hkv, B * M * bs + bs, 2 * hd)).astype(np.float32)
    q = r.normal(size=(B, Q, Hq, hd)).astype(np.float32)
    bt = (r.permutation(B * M).reshape(B, M) + 1).astype(np.int32)
    ctx = np.asarray(ctx_lens, np.int32)
    qeff = np.full(B, Q, np.int32)
    out = np.asarray(jdiag.diag_attention(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(bt), jnp.asarray(ctx), jnp.asarray(qeff),
        bs, M * bs, hd ** -0.5, 2, True, True, interpret=True))
    G = Hq // Hkv
    want = out[..., hd:].reshape(B, Hkv, Q, G, hd).transpose(0, 2, 1, 3, 4).reshape(B, Q, Hq, hd)
    got = probes.paged_attention_diag(
        "full", torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(bt),
        torch.from_numpy(ctx), torch.from_numpy(qeff), bs, hd ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stage", ["dma", "compute", "empty"])
def test_diag_other_stages_need_a_card(stage):
    q = torch.zeros(1, 1, 8, 64)
    kv = torch.zeros(2, 32, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        probes.paged_attention_diag(stage, q, kv, torch.ones(1, 2, dtype=torch.int32),
                                    torch.ones(1, dtype=torch.int32),
                                    torch.ones(1, dtype=torch.int32), 16, 0.125)
    with pytest.raises(ValueError, match="stage"):
        probes.paged_attention_diag("loads", q, kv, torch.ones(1, 2, dtype=torch.int32),
                                    torch.ones(1, dtype=torch.int32),
                                    torch.ones(1, dtype=torch.int32), 16, 0.125)
