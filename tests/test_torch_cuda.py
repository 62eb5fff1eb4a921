"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the fp cache and over the int8 cache (kv_quant "int8" and "int8_mxu"),
and the MoE grouped GEMM.

Needs an NVIDIA GPU (the kernels have no CPU mode) and skips without one.
The file imports neither JAX nor the JAX package, so on a GPU machine
without JAX it runs with the JAX-forcing conftest turned off:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops import moe
from tests.torch_cases import flat_meta, paged_case, tree_case


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, dtype):
    """Elementwise |got - want| <= 1e-4 + rtol |want|, where rtol is 0 in fp32
    and 2^-7 in bf16: both sides compute in fp32 and round the output once,
    and one bf16 ulp at x is at most 2^-7 |x|."""
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    want = want.float()
    return bool(((got.float() - want).abs() <= 1e-4 + rtol * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,hd", [(8, 2, 64), (6, 2, 128), (32, 4, 128)])  # G = 4, 3, 8
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(dtype, Hq, Hkv, hd):
    """The CUDA kernels against their plain versions on the card: decode with
    a ghost row, overshoot at Q=4 (Q*G query rows take several passes), the
    SD/SSD verify at Q=K+1=5 with a ghost row (a partial last row pass), and
    a mixed prefix-cached prefill, at both head sizes the kernels take
    (hd 128 also at Qwen3-30B-A3B's 32/4 heads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    dev = "cuda"
    scale = hd ** -0.5
    for (B, Q, ctx_lens, M, ghosts) in [(4, 1, [300, 64, 129], 8, 1),
                                        (3, 4, [258, 100, 256], 4, 0),
                                        (3, 5, [400, 5], 8, 1)]:
        q, kv, bt, ctx = paged_case(7, B, Q, Hq, Hkv, hd, 64, M, ctx_lens, ghosts)
        if M == 4:
            ctx = np.asarray(ctx_lens, np.int32)   # beyond the full table
        args = [t(a).to(dev) for a in (q, kv, bt, ctx, np.full(B, Q, np.int32))]
        args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
        got = att.paged_attention(*args, 64, scale)
        want = att.paged_attention_plain(*args, 64, scale)
        assert close(got, want, dtype)
    _, kv, bt, _ = paged_case(51, 3, 1, Hq, Hkv, hd, 16, 8, [9, 12, 19])
    lo, hi, pages_per = flat_meta([9, 12, 19], [5, 12, 3], 16, 32)
    pages = np.concatenate([bt[s, :pages_per[s]] for s in range(3)])
    pages = np.pad(pages, (0, 8 - len(pages)), constant_values=-1).astype(np.int32)
    q = np.random.default_rng(52).normal(size=(32, Hq, hd)).astype(np.float32)
    args = [t(q).to(dev, dtype), t(kv).to(dev, dtype)] + [t(a).to(dev) for a in (pages, lo, hi)]
    got = att.flat_prefill_attention(*args, 16, scale)
    want = att.flat_prefill_attention_plain(*args, 16, scale)
    assert close(got, want, dtype)
    assert got[sum([5, 12, 3]):].abs().max() == 0   # padding rows


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,hd", [(32, 8, 64), (6, 2, 128)])  # G = 4 and 3
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_kernel_matches_plain_on_card(dtype, Hq, Hkv, hd):
    """The tree kernel against its plain version on the card: B=1 and B=3
    with a warm-up ghost row, the first and last step, hit and miss fan
    rows, MQ=10 (K=4, fan-out 2) and an MQ*G above one block's 64 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    scale = hd ** -0.5
    for K, fans, B, bases, ghosts in [(4, [2] * 5, 1, [300], 0),
                                      (4, [2] * 5, 3, [130, 7], 1),
                                      (3, [7, 5, 3, 2], 2, [64, 200], 0)]:
        for step in (0, K - 1):
            q, kv, bt, ctx, fan = tree_case(3 + step, B, K, fans, Hq, Hkv, hd,
                                            64, 8, bases, step, ghosts)
            args = [t(a).to("cuda") for a in (q, kv, bt, ctx, fan)]
            args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
            got = att.tree_attention(*args, step, K, 64, scale)
            want = att.tree_attention_plain(*args, step, K, 64, scale)
            assert close(got, want, dtype), (K, B, step)


def int8_layer(kv, seed):
    """The cache `kv` [Hkv, S, 2hd] quantized by store_kv into the int8 pair,
    on the card (scales of never-written slots would be 1e-10; here every
    slot is written)."""
    Hkv, S, hd2 = kv.shape
    hd = hd2 // 2
    x = t(kv).transpose(0, 1).cuda()                          # [S, Hkv, 2hd]
    layer = (torch.zeros(Hkv, S, hd2, dtype=torch.int8, device="cuda"),
             torch.full((Hkv, 2, S), 1e-10, device="cuda"))
    scale = torch.from_numpy(np.random.default_rng(seed).uniform(0.2, 3.0, size=(S, Hkv, 1)))
    att.store_kv(layer, x[..., :hd] * scale.cuda().float(), x[..., hd:],
                 torch.arange(S, dtype=torch.int32, device="cuda"))
    return layer


@pytest.mark.cuda
@pytest.mark.parametrize("s8", [False, True], ids=["int8", "int8_mxu"])
@pytest.mark.parametrize("Hq,Hkv,hd", [(8, 2, 64), (6, 2, 128)])  # G = 4 and 3
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_kernels_match_plain_on_card(dtype, Hq, Hkv, hd, s8):
    """The int8 paged and tree kernels (both modes) and K1's int8 entry
    against their plain versions on the card, at the shapes of the fp tests
    above. Tolerance: that of the fp kernels (close()). In the s8 mode the
    kernel and its plain version round the same integers (q8 from the same
    fp32 steps, p8 from each tile's own scores), so they too differ by fp32
    rounding only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    scale = hd ** -0.5
    for (B, Q, ctx_lens, M, ghosts) in [(4, 1, [300, 64, 129], 8, 1),
                                        (3, 4, [258, 100, 256], 4, 0),
                                        (3, 5, [400, 5], 8, 1)]:
        q, kv, bt, ctx = paged_case(7, B, Q, Hq, Hkv, hd, 64, M, ctx_lens, ghosts)
        if M == 4:
            ctx = np.asarray(ctx_lens, np.int32)   # beyond the full table
        layer = int8_layer(kv, 8)
        args = [t(a).cuda() for a in (bt, ctx, np.full(B, Q, np.int32))]
        qd = t(q).to("cuda", dtype)
        got = att.paged_attention(qd, layer, *args, 64, scale, s8=s8)
        want = att.paged_attention_plain(qd, layer, *args, 64, scale, s8=s8)
        assert close(got, want, dtype), (B, Q, s8)
    for K, fans, B, bases, ghosts in [(4, [2] * 5, 3, [130, 7], 1),
                                      (3, [7, 5, 3, 2], 2, [64, 200], 0)]:
        for step in (0, K - 1):
            q, kv, bt, ctx, fan = tree_case(3 + step, B, K, fans, Hq, Hkv, hd,
                                            64, 8, bases, step, ghosts)
            layer = int8_layer(kv, 9)
            args = [t(a).cuda() for a in (bt, ctx, fan)]
            qd = t(q).to("cuda", dtype)
            got = att.tree_attention(qd, layer, *args, step, K, 64, scale, s8=s8)
            want = att.tree_attention_plain(qd, layer, *args, step, K, 64, scale, s8=s8)
            assert close(got, want, dtype), (K, B, step, s8)
    _, kv, bt, _ = paged_case(51, 3, 1, Hq, Hkv, hd, 16, 8, [9, 12, 19])
    lo, hi, pages_per = flat_meta([9, 12, 19], [5, 12, 3], 16, 32)
    pages = np.concatenate([bt[s, :pages_per[s]] for s in range(3)])
    pages = np.pad(pages, (0, 8 - len(pages)), constant_values=-1).astype(np.int32)
    q = t(np.random.default_rng(52).normal(size=(32, Hq, hd)).astype(np.float32))
    args = [q.to("cuda", dtype), int8_layer(kv, 10)] + [t(a).cuda() for a in (pages, lo, hi)]
    got = att.flat_prefill_attention(*args, 16, scale)
    want = att.flat_prefill_attention_plain(*args, 16, scale)
    assert close(got, want, dtype)
    assert got[sum([5, 12, 3]):].abs().max() == 0   # padding rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_gemm_matches_plain_on_card(dtype):
    """The grouped GEMM against its plain version on the card: empty groups
    (first, inner and last), one-row groups, N = 1, one group holding every
    row, N and Nout that are not multiples of either dtype's tile, K not a
    multiple of the K slice, and a decode-sized dispatch over 128 experts.
    Tolerance: close() (both sides accumulate in fp32 and round once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    r = np.random.default_rng(3)
    decode = np.zeros(128, np.int64)
    decode[r.choice(128, 50, replace=False)] = 1
    decode[r.choice(np.flatnonzero(decode), 14, replace=False)] += 1    # 64 rows
    cases = [([0, 130, 1, 0, 64, 3, 0], 40, 200),    # K, Nout
             ([1], 32, 48), ([0, 0, 300, 0], 96, 136), ([5, 6, 7, 6], 2048, 768),
             (list(decode), 256, 136)]
    for sizes, K, Nout in cases:
        N, E = sum(sizes), len(sizes)
        x = torch.from_numpy(r.normal(size=(N, K))).float().to("cuda", dtype)
        w = (torch.from_numpy(r.normal(size=(E, K, Nout))).float() * 0.05).to("cuda", dtype)
        offs = t(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)).cuda()
        got = moe.grouped_gemm(x, w, offs)
        torch.cuda.synchronize()
        want = moe.grouped_gemm_plain(x, w, offs)
        assert got.dtype == dtype and got.shape == (N, Nout)
        assert close(got, want, dtype), (sizes[:8], K, Nout)
