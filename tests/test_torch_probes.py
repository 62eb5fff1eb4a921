"""The plain versions of the port's two bench probes against the JAX
package's probe kernels, run as its own tests run Pallas on the CPU
(interpret mode), on the same numpy inputs:

- ops/probes.py::s8_dot_plain (the plain version of csrc/s8_probe.cu's
  three paths) against bench/s8_probe.py's _kernel_s8 and _kernel_bf16 through
  pl.pallas_call(interpret=True), bit for bit, and against its `run` entry
  point's checksum, at the probe's shapes and the card checks' (4096
  positions, one row block, D = 64, tails); the argument checks refuse
  every shape the kernels refuse;
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


# The probe's shape keeps its cases' ids ("s8", "bf16"); the others carry
# theirs.
_PROBE_CASES = [pytest.param(mode, N, L, D, id=f"{mode}-N{N}-L{L}-D{D}" if i else mode)
                for i, (N, L, D) in enumerate([(16, 512, 128), (4, 4096, 128), (1, 512, 128),
                                               (8, 512, 64), (3, 517, 128), (5, 1000, 64)])
                for mode in ("s8", "bf16")]


@pytest.mark.parametrize("mode,N,L,D", _PROBE_CASES)
def test_s8_probe_plain_matches_pallas(mode, N, L, D):
    """The probe's shapes at a quarter of its batch (16 row blocks of 8
    rows, 512 positions, D = 128), and the shapes the card checks hold the
    kernels to (s8_probe.CHECK_SHAPES) at fewer row blocks: 4096 positions,
    one row block, D = 64, lengths past a whole number of 64-position tiles
    (517, 1000): the fp64 plain product equals the Pallas kernel's s32 (or
    fp32) product exactly, and run()'s checksum (an int32 sum, which
    wraps)."""
    q8, k8, qb = s8_probe.inputs("cpu", N=N, L=L, D=D)
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


def _misaligned(shape):
    """A contiguous int8 tensor of `shape` that starts 1 byte past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 16, dtype=torch.int8)[1:n + 1].view(shape)


@pytest.mark.parametrize("case", ["D96", "D32", "L0", "N0", "R4", "strided", "misaligned"])
def test_check_probe_args_refuses_what_the_kernel_refuses(case):
    """_check_probe_args (run before every launch) raises on each shape or
    layout csrc/s8_probe.cu refuses: D outside {64, 128}, no positions or
    row blocks, R != 8, a non-contiguous or misaligned operand; it passes
    the shapes the kernel takes."""
    N, L, D = 2, 70, 128
    q, k = torch.zeros(N, 8, D, dtype=torch.int8), torch.zeros(N, L, D, dtype=torch.int8)
    if case.startswith("D"):
        D = int(case[1:])
        q, k = q[..., :D].contiguous(), k[..., :D].contiguous()
    elif case == "L0":
        k = k[:, :0]
    elif case == "N0":
        q, k = q[:0], k[:0]
    elif case == "R4":
        q = q[:, :4].contiguous()
    elif case == "strided":
        k = torch.zeros(N, 2 * L, D, dtype=torch.int8)[:, ::2]
    else:
        k = _misaligned((N, L, D))
    with pytest.raises(ValueError):
        probes._check_probe_args("s8_dot_mma", q, k, torch.int8)
    for N, L, D in ((1, 1, 64), (3, 517, 128), (2, 4096, 64)):
        probes._check_probe_args("s8_dot_mma", torch.zeros(N, 8, D, dtype=torch.int8),
                                 torch.zeros(N, L, D, dtype=torch.int8), torch.int8)
    with pytest.raises(TypeError):
        probes._check_probe_args("s8_dot_bf16", torch.zeros(1, 8, 64, dtype=torch.int8),
                                 torch.zeros(1, 8, 64, dtype=torch.int8), torch.bfloat16)


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
