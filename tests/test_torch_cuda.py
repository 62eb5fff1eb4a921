"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the fp cache and over the int8 cache (kv_quant "int8" and "int8_mxu"),
the MoE grouped GEMM, the W8A16 GEMM of int8 weights, and the two bench
probes (the s8 dot paths and the paged kernels' stage variants).

Needs an NVIDIA GPU (the kernels have no CPU mode) and skips without one.
The file imports neither JAX nor the JAX package, so on a GPU machine
without JAX it runs with the JAX-forcing conftest turned off:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ssd_tpu_torch.bench import kernel_diag, s8_probe
from ssd_tpu_torch.ops import attention as att
from ssd_tpu_torch.ops import linear, moe, probes
from tests.torch_cases import flat_batch, flat_meta, paged_case, tree_case


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
@pytest.mark.parametrize("Hq,Hkv,hd", [(8, 2, 64), (6, 2, 128), (32, 4, 128),
                                      (32, 8, 128)])  # G = 4, 3, 8, 4
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(dtype, Hq, Hkv, hd):
    """The CUDA kernels against their plain versions on the card: decode with
    a ghost row, overshoot at Q=4 (Q*G query rows take several passes), the
    SD/SSD verify at Q=K+1=5 with a ghost row (a partial last row pass), and
    a mixed prefix-cached prefill, at both head sizes the kernels take
    (hd 128 also at Qwen3-30B-A3B's 32/4 heads and Llama-3.1-8B's 32/8)."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 50, 100, 160, 192, 226, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_every_head_width_on_card(dtype, hd):
    """K1-K5 at head dims the kernels pad (ops/attention.py::kernel_width):
    hd 32 and 50 at width 64 (50: int8 rows in 2-byte pieces), 100 at 128
    with G = 1 (bf16 V halves in 8-byte pieces, int8 rows in 4-byte ones),
    160 at 192 and 226 at 256 (2-byte int8 pieces again), 192 and 256
    unpadded, the s8 mode where JAX's router takes it: the paged decode and
    verify with a ghost row, the tree's last step, a mixed prefill, over the
    fp and the int8 cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    Hq, Hkv = (4, 4) if hd in (50, 100, 226) else (8, 2)
    scale = hd ** -0.5
    for B, Q, ctx_lens, ghosts in [(4, 1, [300, 64, 129], 1), (3, 5, [400, 5], 1)]:
        q, kv, bt, ctx = paged_case(9, B, Q, Hq, Hkv, hd, 64, 8, ctx_lens, ghosts)
        qd, kvd = t(q).cuda().to(dtype), t(kv).cuda().to(dtype)
        rest = [t(a).cuda() for a in (bt, ctx, np.full(B, Q, np.int32))]
        for layer, s8 in ((kvd, False), (int8_layer(kv, 5), False), (int8_layer(kv, 5), True)):
            got = att.paged_attention(qd, layer, *rest, 64, scale, s8=s8)
            want = att.paged_attention_plain(qd, layer, *rest, 64, scale, s8=s8)
            assert close(got, want, dtype), (B, Q, s8)
    q, kv, bt, ctx, fan = tree_case(4, 3, 4, [2] * 5, Hq, Hkv, hd, 64, 8, [200, 9], 3, 1)
    qd, kvd = t(q).cuda().to(dtype), t(kv).cuda().to(dtype)
    rest = [t(a).cuda() for a in (bt, ctx, fan)]
    for layer, s8 in ((kvd, False), (int8_layer(kv, 6), False), (int8_layer(kv, 6), True)):
        got = att.tree_attention(qd, layer, *rest, 3, 4, 64, scale, s8=s8)
        assert close(got, att.tree_attention_plain(qd, layer, *rest, 3, 4, 64, scale, s8=s8),
                     dtype), s8
    q, kv, pages, lo, hi, _, T = flat_batch(8, [40, 130, 77], [0, 64, 0], Hq, Hkv, hd, 16,
                                            pad_rows=5)
    for layer in (t(kv).cuda().to(dtype), int8_layer(kv, 7)):
        args = [t(q).cuda().to(dtype), layer] + [t(a).cuda() for a in (pages, lo, hi)]
        got = att.flat_prefill_attention(*args, 16, scale)
        assert close(got, att.flat_prefill_attention_plain(*args, 16, scale), dtype)
        assert got[T:].abs().max() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [14, 99, 258])
def test_untaken_head_dims_raise_on_card(hd):
    """An odd head dim, or one outside [16, 256], raises on CUDA tensors in
    every wrapper; nothing runs the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    q, kv, bt, ctx = paged_case(3, 2, 1, 4, 2, hd, 16, 4, [40, 9])
    qd, kvd = t(q).cuda(), t(kv).cuda()
    rest = [t(a).cuda() for a in (bt, ctx, np.ones(2, np.int32))]
    with pytest.raises(ValueError, match="head_dim"):
        att.paged_attention(qd, kvd, *rest, 16, 0.1)
    with pytest.raises(ValueError, match="head_dim"):
        att.paged_attention(qd, int8_layer(kv, 1), *rest, 16, 0.1)
    fan = torch.zeros(2, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        att.tree_attention(qd, kvd, rest[0], rest[1] + 2, fan, 0, 1, 16, 0.1)
    pages, lo, hi = (torch.zeros(1, dtype=torch.int32, device="cuda"),
                     torch.zeros(2, dtype=torch.int32, device="cuda"),
                     torch.ones(2, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="head_dim"):
        att.flat_prefill_attention(qd[:, 0], kvd, pages, lo, hi, 16, 0.1)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eagle_glue_and_draft_prefill_on_card(dtype):
    """The EAGLE path's shapes at Llama-3.1-8B's heads (32/8, hd 128): the
    glue at Q = 2K+1 = 9 with a per-sequence qeff of n_ext + K + 1 (5..9),
    over the fp and the int8 cache, and the draft prefill (each prompt's n-1
    tokens, nothing cached) through the flat kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    Hq, Hkv, hd, scale = 32, 8, 128, 128 ** -0.5
    q, kv, bt, ctx = paged_case(61, 4, 9, Hq, Hkv, hd, 64, 8, [300, 77, 129, 400])
    qeff = np.array([5, 9, 7, 6], np.int32)
    args = [t(a).to("cuda") for a in (q, kv, bt, ctx, qeff)]
    args[0], args[1] = args[0].to(dtype), args[1].to(dtype)
    assert close(att.paged_attention(*args, 64, scale),
                 att.paged_attention_plain(*args, 64, scale), dtype)
    pair = (torch.zeros(args[1].shape, dtype=torch.int8, device="cuda"),
            torch.full((Hkv, 2, args[1].shape[1]), 1e-10, device="cuda"))
    att.store_kv(pair, args[1][:, :, :hd].transpose(0, 1), args[1][:, :, hd:].transpose(0, 1),
                 torch.arange(args[1].shape[1], dtype=torch.int32, device="cuda"))
    iargs = [args[0], pair] + args[2:]
    assert close(att.paged_attention(*iargs, 64, scale),
                 att.paged_attention_plain(*iargs, 64, scale), dtype)
    lens = [33 - 1, 250 - 1, 400 - 1]
    _, kv, bt, _ = paged_case(62, 3, 1, Hq, Hkv, hd, 64, 8, lens)
    lo, hi, pages_per = flat_meta(lens, lens, 64, sum(lens))
    pages = np.concatenate([bt[s, :pages_per[s]] for s in range(3)]).astype(np.int32)
    q = np.random.default_rng(63).normal(size=(sum(lens), Hq, hd)).astype(np.float32)
    fargs = [t(q).to("cuda", dtype), t(kv).to("cuda", dtype)] + \
        [t(a).to("cuda") for a in (pages, lo, hi)]
    assert close(att.flat_prefill_attention(*fargs, 64, scale),
                 att.flat_prefill_attention_plain(*fargs, 64, scale), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("N,L,D", s8_probe.CHECK_SHAPES)
def test_s8_probe_paths_exact_on_card(N, L, D):
    """The three s8 probe kernels equal their fp64 plain version bit for
    bit at bench/s8_probe.py's shapes, at 4096 positions, at one row block,
    at D = 64, and at lengths with a tail past the last whole block of
    positions (L % 4 != 0 too); each launch is counted, and a shape the
    kernel refuses raises before a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    q8, k8, qb = s8_probe.inputs("cuda", N=N, L=L, D=D)
    want = probes.s8_dot_plain(q8, k8)
    for fn, q in ((probes.s8_dot_mma, q8), (probes.s8_dot_dp4a, q8), (probes.s8_dot_bf16, qb)):
        n = fn.launches
        got = fn(q, k8)
        torch.cuda.synchronize()
        assert torch.equal(got.double(), want.double()), fn.__name__
        assert fn.launches == n + 1
        with pytest.raises(ValueError, match="D in"):
            fn(q[..., :32].contiguous(), k8[..., :32].contiguous())
        assert fn.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_diag_stages_on_card(kv_quant):
    """The paged kernels' stage variants: "full" equals the production
    kernel bit for bit; "empty" writes zeros; every stage launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    q, layer, bt, ctx, qeff = kernel_diag.decode_case(3, 1, 8, 2, 64, 64, [300, 5, 129],
                                                      torch.bfloat16, kv_quant=kv_quant)
    args = (q, layer, bt, ctx, qeff, 64, 0.125)
    assert torch.equal(probes.paged_attention_diag("full", *args), att.paged_attention(*args))
    assert probes.paged_attention_diag("empty", *args).abs().max() == 0
    for stage in ("dma", "compute"):
        assert torch.isfinite(probes.paged_attention_diag(stage, *args)).all()
    torch.cuda.synchronize()


def _split_layer(kv, kind, dtype):
    """The numpy cache kv as the paged kernel of `kind` reads it on the card:
    in `dtype` for the fp cache, else the int8 pair ("int8", "int8_mxu")."""
    return t(kv).to("cuda", dtype) if kind == "fp" else int8_layer(kv, 11)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp", "int8", "int8_mxu"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_paged_kernels_match_plain_on_card(dtype, hd, kind):
    """The split-KV K2/K4 against their plain versions at R = Q * G of 4, 20,
    36, 40 and 72 rows (decode, verify and glue at G 4 and 8; 72 takes two
    row passes), with contexts across several chunks, one at a chunk
    boundary, one of 0 and a ghost row; the glue with per-sequence qeff."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    scale = hd ** -0.5
    for Q, G in ((1, 4), (5, 4), (9, 4), (5, 8), (9, 8)):
        Hkv = 2
        ctx_lens = [700, 0, 128, 333, 9]
        q, kv, bt, ctx = paged_case(80 + Q + G, 6, Q, G * Hkv, Hkv, hd, 64, 12, ctx_lens, 1)
        qeff = np.full(6, Q, np.int32)
        if Q == 9:
            qeff[:5] = [5, 9, 7, 6, 9]
        layer = _split_layer(kv, kind, dtype)
        args = [t(a).cuda() for a in (bt, ctx, qeff)]
        qd = t(q).to("cuda", dtype)
        got = att.paged_attention(qd, layer, *args, 64, scale, s8=kind == "int8_mxu")
        torch.cuda.synchronize()
        want = att.paged_attention_plain(qd, layer, *args, 64, scale, s8=kind == "int8_mxu")
        assert close(got, want, dtype), (Q, G)
        assert got[1].abs().max() == 0   # context 0 attends nothing


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp", "int8", "int8_mxu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_paged_kernels_are_batch_invariant_on_card(dtype, kind):
    """Bitwise: repeated calls; each sequence's rows alone equal its rows in
    a batch of 8; a Q=1 call equals query 0 of a Q=5 call whose context
    holds the 4 later queries (the same causal limit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    s8 = kind == "int8_mxu"
    for Hq, Hkv, hd in ((8, 2, 64), (32, 4, 128)):
        scale = hd ** -0.5
        ctx_lens = [97, 175, 640, 1, 964, 1364, 64, 1964]
        q, kv, bt, ctx = paged_case(90 + hd, 8, 5, Hq, Hkv, hd, 64, 32, ctx_lens)
        layer = _split_layer(kv, kind, dtype)
        qd, btd, ctxd = t(q).to("cuda", dtype), t(bt).cuda(), t(ctx).cuda()
        five = torch.full((8,), 5, dtype=torch.int32, device="cuda")
        full = att.paged_attention(qd, layer, btd, ctxd, five, 64, scale, s8=s8)
        again = att.paged_attention(qd, layer, btd, ctxd, five, 64, scale, s8=s8)
        assert torch.equal(full, again)
        for b in (0, 4, 7):
            alone = att.paged_attention(qd[b:b + 1], layer, btd[b:b + 1], ctxd[b:b + 1],
                                        five[:1], 64, scale, s8=s8)
            assert torch.equal(alone[0], full[b]), (hd, b)
        one = torch.ones(8, dtype=torch.int32, device="cuda")
        q1 = att.paged_attention(qd[:, :1].contiguous(), layer, btd, (ctxd - 4).clamp(min=0),
                                 one, 64, scale, s8=s8)
        live = ctxd >= 5
        assert torch.equal(q1[live, 0], full[live, 0]), hd


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp", "int8", "int8_mxu"])
def test_split_paged_kernels_on_two_streams(kind):
    """Two streams running the paged kernel at once (as SSD's target and
    draft streams do) give what the same calls give one after the other:
    neither the workspace nor the counters are shared."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    s8 = kind == "int8_mxu"
    calls = []
    for seed, Q in ((1, 1), (2, 5), (3, 9)):
        ctx_lens = [1500, 300, 2000, 64, 777, 1024, 1, 1800]
        q, kv, bt, ctx = paged_case(seed, 8, Q, 32, 8, 64, 64, 32, ctx_lens)
        layer = _split_layer(kv, kind, torch.bfloat16)
        calls.append((t(q).to("cuda", torch.bfloat16), layer, t(bt).cuda(), t(ctx).cuda(),
                      torch.full((8,), Q, dtype=torch.int32, device="cuda")))
    serial = [att.paged_attention(*c, 64, 0.125, s8=s8) for c in calls]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                for c in (calls if i == 0 else calls[::-1]):
                    outs[i].append(att.paged_attention(*c, 64, 0.125, s8=s8))
    torch.cuda.synchronize()
    for k, got in enumerate(outs[0]):
        assert torch.equal(got, serial[k % 3]), k
    for k, got in enumerate(outs[1]):
        assert torch.equal(got, serial[2 - k % 3]), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp", "int8", "int8_mxu"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_tree_kernels_match_plain_on_card(dtype, hd, kind):
    """The split-KV K3/K5 against their plain versions at R = MQ * G of 20,
    40 and 80 rows (MQ 5 and 10, hit and miss fan-out lists, G 4 and 8; 80
    takes two row groups), at steps 0 and K-1, with contexts over several
    chunks, ending exactly on a chunk boundary (128, 256, 512), tails across
    a chunk boundary, a context past the full table and a ghost row (a
    negative prefix, a table of -1 entries)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    scale, K = hd ** -0.5, 4
    for fans, G in (([1] * 5, 4), ([2] * 5, 4), ([2] * 5, 8), ([3, 3, 2, 1, 1], 8)):
        MQ = sum(fans)
        for step in (0, K - 1):
            tail = K + 1 + (step + 1) * MQ
            # 1500: past the 1024-slot table
            bases = [700, 128 - tail, 256 - tail, 512 - tail, 100, 240, 1500]
            q, kv, bt, ctx, fan = tree_case(110 + MQ + G + step, 8, K, fans, 2 * G, 2, hd, 64, 16,
                                            bases, step, 1)
            layer = _split_layer(kv, kind, dtype)
            args = [t(a).cuda() for a in (bt, ctx, fan)]
            qd = t(q).to("cuda", dtype)
            got = att.tree_attention(qd, layer, *args, step, K, 64, scale, s8=kind == "int8_mxu")
            torch.cuda.synchronize()
            want = att.tree_attention_plain(qd, layer, *args, step, K, 64, scale,
                                            s8=kind == "int8_mxu")
            assert close(got, want, dtype), (fans, G, step)
            assert torch.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp", "int8", "int8_mxu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_tree_kernels_are_batch_invariant_on_card(dtype, kind):
    """Bitwise: a repeated call; each sequence's rows alone equal its rows
    in a batch of 8 with other contexts (at G 4 and, two row groups, G 8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    s8 = kind == "int8_mxu"
    for Hq, Hkv, hd in ((32, 8, 64), (32, 4, 128)):
        scale = hd ** -0.5
        bases = [97, 175, 640, 1, 964, 1364, 64, 1964]
        q, kv, bt, ctx, fan = tree_case(95 + hd, 8, 4, [2] * 5, Hq, Hkv, hd, 64, 32, bases, 3)
        layer = _split_layer(kv, kind, dtype)
        qd, btd, ctxd, fand = t(q).to("cuda", dtype), t(bt).cuda(), t(ctx).cuda(), t(fan).cuda()
        full = att.tree_attention(qd, layer, btd, ctxd, fand, 3, 4, 64, scale, s8=s8)
        again = att.tree_attention(qd, layer, btd, ctxd, fand, 3, 4, 64, scale, s8=s8)
        assert torch.equal(full, again)
        for b in (0, 4, 7):
            alone = att.tree_attention(qd[b:b + 1], layer, btd[b:b + 1], ctxd[b:b + 1],
                                       fand[b:b + 1], 3, 4, 64, scale, s8=s8)
            assert torch.equal(alone[0], full[b]), (hd, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp", "int8", "int8_mxu"])
def test_split_tree_kernels_on_two_streams(kind):
    """Two streams running the tree kernel at once (as SSD's draft stream
    runs it beside the target's paged kernels) give what the same calls give
    one after the other: neither the workspace nor the counters are
    shared."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    s8 = kind == "int8_mxu"
    calls = []
    for seed, (fans, step) in enumerate((([2] * 5, 0), ([3, 3, 2, 1, 1], 3), ([1] * 5, 2))):
        bases = [1500, 300, 2000, 64, 777, 1024, 1, 1800]
        q, kv, bt, ctx, fan = tree_case(seed, 8, 4, fans, 32, 8, 64, 64, 40, bases, step)
        layer = _split_layer(kv, kind, torch.bfloat16)
        calls.append((t(q).to("cuda", torch.bfloat16), layer, t(bt).cuda(), t(ctx).cuda(),
                      t(fan).cuda(), step))
    run = lambda c: att.tree_attention(*c[:5], c[5], 4, 64, 0.125, s8=s8)  # noqa: E731
    serial = [run(c) for c in calls]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                for c in (calls if i == 0 else calls[::-1]):
                    outs[i].append(run(c))
    torch.cuda.synchronize()
    for k, got in enumerate(outs[0]):
        assert torch.equal(got, serial[k % 3]), k
    for k, got in enumerate(outs[1]):
        assert torch.equal(got, serial[2 - k % 3]), k


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["prefill", "decode"])
def test_grouped_gemm_routes_match_plain_on_card(route, monkeypatch):
    """Both bf16 routes of the grouped GEMM (wgmma on TMA tiles; the decode
    route with the product turned around) against the plain version, each
    forced on every case: empty groups first, inside and last, one-row
    groups, N below one tile, a group larger than a tile, Nout that is not
    a multiple of the column tile, K that is not a multiple of the 64-wide
    K slice, and the Qwen3-30B-A3B gate and down shapes at a b8 decode
    dispatch (64 rows in 1-2 row groups over 128 experts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    monkeypatch.setattr(moe, "grouped_gemm_route", lambda *shape: route)
    r = np.random.default_rng(33)
    decode = np.zeros(128, np.int64)
    decode[r.choice(128, 50, replace=False)] = 1
    decode[r.choice(np.flatnonzero(decode), 14, replace=False)] += 1    # 64 rows
    cases = [([0, 130, 1, 0, 64, 3, 0], 40, 200),    # K, Nout
             ([5], 64, 72), ([0, 1, 0], 136, 8), ([17, 0, 2, 1], 2048, 768),
             ([0, 0, 300, 0], 96, 264), (list(decode), 2048, 768), (list(decode), 768, 2048)]
    for sizes, K, Nout in cases:
        N, E = sum(sizes), len(sizes)
        x = torch.from_numpy(r.normal(size=(N, K))).float().to("cuda", torch.bfloat16)
        w = (torch.from_numpy(r.normal(size=(E, K, Nout))).float() * 0.05).to("cuda", torch.bfloat16)
        offs = t(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)).cuda()
        got = moe.grouped_gemm(x, w, offs)
        torch.cuda.synchronize()
        want = moe.grouped_gemm_plain(x, w, offs)
        assert got.shape == (N, Nout)
        assert close(got, want, torch.bfloat16), (route, sizes[:8], K, Nout)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bs", [16, 64])
def test_flat_prefill_tc_matches_plain_on_card(bs, hd, G, kind):
    """K1's bf16 kernel (tensor cores, page ring) over the fp cache and the
    int8 pair against the plain version: a prefix-cached prompt whose new
    rows start mid-tile, a one-token prompt, prompts across several 64-column
    tiles, a fully cached prompt but its last token, and padding rows
    (zeros). Tolerance: close() in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    Hkv = 2
    lens, cached = [37, 1, 300, 130, 77], [20, 0, 0, 129, 13]
    q, kv, pages, lo, hi, _, T = flat_batch(70 + hd + G, lens, cached, G * Hkv, Hkv, hd, bs,
                                             pad_rows=5)
    layer = int8_layer(kv, 11) if kind == "int8" else t(kv).to("cuda", torch.bfloat16)
    args = [t(q).to("cuda", torch.bfloat16), layer] + [t(a).cuda() for a in (pages, lo, hi)]
    got = att.flat_prefill_attention(*args, bs, hd ** -0.5)
    torch.cuda.synchronize()
    want = att.flat_prefill_attention_plain(*args, bs, hd ** -0.5)
    assert close(got, want, torch.bfloat16), (bs, hd, G, kind)
    assert got[T:].abs().max() == 0   # padding rows


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("hd,G", [(64, 4), (128, 8)])
def test_flat_prefill_tc_is_batch_invariant_on_card(hd, G, kind):
    """Bitwise, at the serving block size 64: each prompt run alone (its own
    pages, columns from 0) equals its rows in the batch of 8, and a repeated
    call equals the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    Hkv, bs, scale = 4, 64, hd ** -0.5
    lens = [33, 111, 250, 400, 64, 900, 1, 190]
    q, kv, pages, lo, hi, bt, T = flat_batch(80 + hd, lens, [0] * 8, G * Hkv, Hkv, hd, bs)
    layer = int8_layer(kv, 12) if kind == "int8" else t(kv).to("cuda", torch.bfloat16)
    qd = t(q).to("cuda", torch.bfloat16)
    args = [t(a).cuda() for a in (pages, lo, hi)]
    full = att.flat_prefill_attention(qd, layer, *args, bs, scale)
    assert torch.equal(full, att.flat_prefill_attention(qd, layer, *args, bs, scale))
    off = 0
    for s, n in enumerate(lens):
        npages = -(-n // bs)
        alone = att.flat_prefill_attention(
            qd[off:off + n].contiguous(), layer, t(bt[s, :npages]).cuda(),
            torch.zeros(n, dtype=torch.int32, device="cuda"),
            torch.arange(1, n + 1, dtype=torch.int32, device="cuda"), bs, scale)
        assert torch.equal(alone, full[off:off + n]), (hd, kind, s)
        off += n


# --- CUDA graphs of the decode-side steps (engine/graphs.py) ---------------------

TINY_LLAMA = {"model_type": "llama", "vocab_size": 512, "hidden_size": 256,
              "intermediate_size": 512, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 64, "max_position_embeddings": 512,
              "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "tie_word_embeddings": False}
TINY_MOE = {**TINY_LLAMA, "model_type": "qwen3_moe", "num_experts": 8,
            "num_experts_per_tok": 2, "moe_intermediate_size": 128, "head_dim": 64,
            "norm_topk_prob": True}
GRAPH_K, GRAPH_R, GRAPH_BS = 4, 2, 16


def _tiny_engine(tmp_path, base=TINY_LLAMA, **kw):
    """A random bf16 engine on the card that runs eagerly, with graphs of
    its own attached by the test."""
    import json

    from ssd_tpu_torch import LLM
    from ssd_tpu_torch.engine.graphs import StepGraphs

    d = tmp_path / base["model_type"]
    d.mkdir(exist_ok=True)
    (d / "config.json").write_text(json.dumps(base))
    llm = LLM(str(d), init_random=True, device="cuda", dtype="bfloat16", enforce_eager=True,
              max_model_len=256, kvcache_block_size=GRAPH_BS, num_kvcache_blocks=64,
              max_num_seqs=4, **kw)
    runner = llm.model_runner
    graphs = StepGraphs(runner.device, [runner.generator])
    return runner, graphs


def _graph_case(runner, kind, B_pad=4, B=3, greedy=True):
    """(key, fn, inputs, ghost) of one step kind at B rows in bucket B_pad:
    disjoint tables, contexts 33-70, the ngram history repeating; only the
    decode takes greedy=False."""
    from functools import partial

    from ssd_tpu_torch.engine import fused_sd
    from ssd_tpu_torch.engine import model_runner as mr

    r = np.random.default_rng(5)
    K, R, M = GRAPH_K, GRAPH_R, runner.max_blocks
    n = np.array([40, 57, 70, 33][:B], np.int32)
    bt = np.full((B, M), -1, np.int32)
    for b in range(B):
        bt[b, :8] = np.arange(8) + 1 + 8 * b
    temps = np.zeros(B, np.float32) if greedy else np.ones(B, np.float32)
    tok = r.integers(3, 512, size=B).astype(np.int32)
    if kind == "chain":
        return runner.chain_call(B_pad, K, True, tok, n - 1, bt, temps)
    if kind in ("decode", "verify"):
        q = 1 if kind == "decode" else K + 1
        pos = (n[:, None] - q + np.arange(q)).astype(np.int32)
        ids = r.integers(3, 512, size=(B, q)).astype(np.int32)

        def build(rows):
            inp = runner._rows(B_pad, input_ids=(ids[:rows], 0), positions=(pos[:rows], 0),
                               block_tables=(bt[:rows], -1), context_lens=(n[:rows], 1))
            inp["input_ids"] = inp["input_ids"].reshape(-1)
            inp["positions"] = inp["positions"].reshape(-1)
            if kind == "decode":
                inp.update(runner._sampling_inputs(B_pad, temps[:rows]))
            return inp
        if kind == "verify":
            key, fn, _, _ = runner.verify_call([], q, B_pad)
        else:
            key = ("decode", B_pad, q, greedy)
            fn = partial(mr.decode_step, runner.params, runner.kv_cache,
                         generator=runner.generator, arch=runner.arch,
                         block_size=runner.block_size, q_len=q, greedy=greedy)
        return key, fn, build(B), lambda: build(0)
    H = fused_sd.ngram_width(runner, K, R)
    hist = np.tile(r.integers(3, 512, size=(B, 11)), H // 11 + 1)[:, :H].astype(np.int32)

    def build(rows):
        inp = runner._rows(B_pad, rec0=(tok[:rows], 0), n0=(n[:rows], 1),
                           bt_target=(bt[:rows], -1), temps_t=(temps[:rows], 0.0))
        if kind == "sd":
            inp.update(runner._rows(B_pad, bt_draft=(bt[:rows], -1),
                                    temps_d=(temps[:rows], 0.0)))
        else:
            inp["hist0"] = runner._rows(B_pad, h=(hist[:rows], 0))["h"]
        return inp
    # The sd case's runner drafts for itself, on its own cache.
    key, fn, _, _ = (fused_sd.sd_call(runner, runner, [], K, R, B_pad) if kind == "sd" else
                     fused_sd.ngram_call(runner, [], 3, K, R, B_pad))
    return key, fn, build(B), lambda: build(0)


def _cpu(out):
    return [x.detach().clone().cpu() for x in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "verify", "chain", "sd", "ngram", "moe"])
def test_graph_replay_equals_eager_on_card(kind, tmp_path):
    """A step's graph replay against the same step run eagerly on the same
    inputs (B = 3 in bucket 4): integer outputs exact, logits within close()
    in bf16; the Qwen3-MoE case runs K6 inside the graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    base = TINY_MOE if kind == "moe" else TINY_LLAMA
    runner, graphs = _tiny_engine(tmp_path, base)
    runner.graphs = graphs
    key, fn, inputs, ghost = _graph_case(runner, "decode" if kind == "moe" else kind)
    eager = _cpu(fn(**{k: torch.from_numpy(v).cuda() for k, v in inputs.items()}))
    replay = _cpu(graphs.run(key, fn, inputs, ghost))
    for e, g in zip(eager, replay):
        if e.is_floating_point():
            assert close(g, e, torch.bfloat16), kind
        else:
            assert torch.equal(g, e), kind
    if kind == "moe":
        assert graphs.steps[key].launches.get(moe.grouped_gemm) == 3 * base["num_hidden_layers"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "sd"])
def test_graph_split_counters_read_zero_after_replays_on_card(kind, tmp_path):
    """After 100 replays the step's own split-KV counters are all zero and
    the outputs still equal the first replay's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    runner, graphs = _tiny_engine(tmp_path)
    key, fn, inputs, ghost = _graph_case(runner, kind)
    first = _cpu(graphs.run(key, fn, inputs, ghost))
    for _ in range(99):
        graphs.run(key, fn, inputs, ghost)
    last = _cpu(graphs.run(key, fn, inputs, ghost))
    torch.cuda.synchronize()
    assert not graphs.steps[key].scratch.counters.any()
    for a, b in zip(first, last):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graph_launches_counted_per_replay_on_card(tmp_path):
    """The paged kernel's launch count grows by its launches in the capture
    at every replay: L a decode, (K+1) L a chain with the extra write."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    runner, graphs = _tiny_engine(tmp_path)
    L = TINY_LLAMA["num_hidden_layers"]
    for kind, per in (("decode", L), ("chain", (GRAPH_K + 1) * L)):
        key, fn, inputs, ghost = _graph_case(runner, kind)
        graphs.capture(key, fn, ghost())
        att.paged_attention.launches = 0
        for _ in range(5):
            graphs.run(key, fn, inputs, ghost)
        assert att.paged_attention.launches == 5 * per, kind
        assert graphs.steps[key].launches == {att.paged_attention: per}


@pytest.mark.cuda
def test_sampled_graph_advances_its_generator_on_card(tmp_path):
    """A sampled decode graph draws anew at each replay (the runner's
    generator is registered with the graph): eight replays on the same
    inputs at temperature 1 do not all give the same tokens. And its draws
    follow the law (the card's counterpart of tests/test_torch_ops.py::
    test_temperature_sampling_follows_softmax): 2,000 replays on one input
    at temperature 0.7 give each row's token frequencies within TV 0.03 of
    softmax(logits / 0.7). The LM head is first scaled so that each row's
    law has few outcomes (sum of sqrt(p) <= 1.4), which keeps the expected
    TV of 2,000 draws from their own law below 0.013."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    runner, graphs = _tiny_engine(tmp_path)
    key, fn, inputs, ghost = _graph_case(runner, "decode", greedy=False)
    draws = {tuple(graphs.run(key, fn, inputs, ghost)[0][:3].tolist()) for _ in range(8)}
    assert len(draws) > 1

    T, N, rows = 0.7, 2000, 3
    inputs["temperatures"][:rows] = T
    logits = graphs.run(key, fn, inputs, ghost)[1][:rows].float().clone()

    def spread(c):
        return float(torch.softmax(c * logits / T, -1).sqrt().sum(-1).max())

    lo, hi = 1.0, 1.0
    while spread(hi) > 1.4:
        lo, hi = hi, 2 * hi
    for _ in range(30):
        mid = (lo + hi) / 2
        lo, hi = (lo, mid) if spread(mid) <= 1.4 else (mid, hi)
    runner.params["lm_head"].mul_(hi)
    toks = torch.stack([graphs.run(key, fn, inputs, ghost)[0][:rows].clone()
                        for _ in range(N)]).cpu()
    want = torch.softmax(graphs.run(key, fn, inputs, ghost)[1][:rows].float() / T, -1).cpu()
    V = want.shape[-1]
    for b in range(rows):
        freq = torch.bincount(toks[:, b], minlength=V).double() / N
        tv = 0.5 * (freq - want[b].double()).abs().sum().item()
        assert tv < 0.03, (b, tv)


# --- async SSD under graphs (engine/draft_runner.py, engine/async_fused.py) -----------

def _async_pair(tmp_path):
    """A random bf16 fused-async engine on the card that runs eagerly (the
    target drafts for itself), with one StepGraphs of the test's attached
    to both runners."""
    import json

    from ssd_tpu_torch import LLM
    from ssd_tpu_torch.engine.graphs import StepGraphs

    d = tmp_path / "async_llama"
    d.mkdir(exist_ok=True)
    (d / "config.json").write_text(json.dumps(TINY_LLAMA))
    llm = LLM(str(d), init_random=True, device="cuda", dtype="bfloat16", enforce_eager=True,
              max_model_len=256, kvcache_block_size=GRAPH_BS, num_kvcache_blocks=96,
              max_num_seqs=4, draft=str(d), speculate=True, speculate_k=GRAPH_K,
              draft_async=True, async_fused=True)
    t, dr = llm.model_runner, llm.draft_runner
    graphs = StepGraphs(t.device, [t.generator, dr.generator])
    t.graphs = dr.graphs = graphs
    return t, dr, graphs


def _async_case(t, dr, kind, B_pad=4, B=3, branch=True, page0=33):
    """(key, fn, inputs, ghost) of an async step at B rows in bucket B_pad:
    the tree build (hit and miss rows), the tree-sampled miss chain, the
    exchange (verify + tree build) and the superstep; disjoint tables of 10
    blocks from page0 (past those of _graph_case), contexts 40-70."""
    from ssd_tpu_torch.engine import async_fused as af

    r = np.random.default_rng(9)
    K, R, M = GRAPH_K, GRAPH_R, t.max_blocks
    n = np.array([40, 57, 70, 33][:B], np.int32)
    bt = np.full((B, M), -1, np.int32)
    for b in range(B):
        bt[b, :10] = np.arange(10) + page0 + 10 * b
    temps = np.zeros(B, np.float32)
    tok = r.integers(3, 512, size=B).astype(np.int32)
    glue = r.integers(3, 512, size=(B, K + 1)).astype(np.int64)
    hits = np.array([1, 0, 1, 0][:B], np.int32)
    if kind == "tree":
        return dr.tree_build_call(B_pad, glue, n - 1, bt, hits, temps)
    if kind == "chain_tree":
        return dr.chain_call(B_pad, K, True, tok, n - 1, bt, temps, **dr._tree_sampling())
    if kind == "exchange":
        key, fn, _, ghost = af.exchange_call(t, dr, B_pad, branch=branch)
        pos = (n[:, None] - K - 1 + np.arange(K + 1)).astype(np.int32)
        inp = t._rows(B_pad, input_ids=(glue.astype(np.int32), 0), positions=(pos, 0),
                      block_tables=(bt, -1), context_lens=(n, 1), temps_t=(temps, 0.0),
                      temps_q=(temps, 0.0), cache_hits=(hits, 0), bt_draft=(bt, -1))
        inp["input_ids"] = inp["input_ids"].reshape(-1)
        inp["positions"] = inp["positions"].reshape(-1)
        inp["logits_q"] = torch.from_numpy(r.normal(size=(B_pad, K, TINY_LLAMA["vocab_size"]))
                                           .astype(np.float32)).cuda()
        return key, fn, inp, ghost
    key, fn, _, ghost = af.superstep_call(t, dr, [], K, R, B_pad, branch=branch)
    inp = t._rows(B_pad, rec0=(tok, 0), n0=(n, 1), bt_target=(bt, -1), temps_t=(temps, 0.0),
                  bt_draft=(bt, -1), temps_d=(temps, 0.0))
    return key, fn, inp, ghost


def _dev(inputs):
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v).cuda()
            for k, v in inputs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tree", "chain_tree", "exchange", "superstep"])
def test_async_graph_replay_equals_eager_on_card(kind, tmp_path):
    """Each async graph's replay against the same step run eagerly on the
    same inputs (B = 3 in bucket 4): tokens exact, logits within close() in
    bf16; the tree kernel K3 launches inside the tree build's graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    t, dr, graphs = _async_pair(tmp_path)
    key, fn, inputs, ghost = _async_case(t, dr, kind)
    eager = _cpu(fn(**_dev(inputs)))
    replay = _cpu(graphs.run(key, fn, inputs, ghost))
    for e, g in zip(eager, replay):
        if e.is_floating_point():
            assert close(g, e, torch.bfloat16), kind
        else:
            assert torch.equal(g, e), kind
    if kind != "chain_tree":
        assert graphs.steps[key].launches.get(att.tree_attention, 0) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["exchange", "superstep"])
def test_branched_graph_equals_serial_graph_on_card(kind, tmp_path):
    """The two-branch capture (tree build on the side stream) against the
    serial capture of the same step: every output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    t, dr, graphs = _async_pair(tmp_path)
    outs = []
    for branch in (True, False):
        key, fn, inputs, ghost = _async_case(t, dr, kind, branch=branch)
        outs.append(_cpu(graphs.run(key, fn, inputs, ghost)))
    for a, b in zip(*outs):
        assert torch.equal(a, b), kind


@pytest.mark.cuda
def test_async_split_counters_read_zero_after_interleaved_replays_on_card(tmp_path):
    """The target's verify graph and the draft's tree-build graph (each in
    its own StepGraphs) replayed 100 times in turns on two streams, and the
    two-branch exchange 100 times: every split-KV counter reads zero and the
    outputs equal the first replays'."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from ssd_tpu_torch.engine.graphs import StepGraphs

    t, dr, graphs = _async_pair(tmp_path)
    dr.graphs = StepGraphs(t.device, [dr.generator])
    target_case = _graph_case(t, "verify")
    tree_case = _async_case(t, dr, "tree")
    exchange_case = _async_case(t, dr, "exchange", page0=63)   # pages of its own
    s_t, s_d = torch.cuda.Stream(), torch.cuda.Stream()
    runs = [(graphs, target_case, s_t), (dr.graphs, tree_case, s_d),
            (graphs, exchange_case, s_t)]
    first, last = [], []
    for i in range(100):
        for g, case, s in runs:
            with torch.cuda.stream(s):
                out = g.run(*case)
                if i in (0, 99):
                    (first if i == 0 else last).append(_cpu(out))
    torch.cuda.synchronize()
    for g, case, _ in runs:
        assert not g.steps[case[0]].scratch.counters.any()
    for a, b in zip(first, last):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_draft_thread_replay_beside_target_replay_on_card(tmp_path):
    """A draft thread replaying its tree build on its stream while the main
    thread replays the target's verify on another: each result equals its
    serial replay's, bit for bit, at every one of 50 replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    import threading

    from ssd_tpu_torch.engine.graphs import StepGraphs

    t, dr, graphs = _async_pair(tmp_path)
    dr.graphs = StepGraphs(t.device, [dr.generator])
    target_case = _graph_case(t, "verify")
    tree_case = _async_case(t, dr, "tree")
    want_t = _cpu(graphs.run(*target_case))
    want_d = _cpu(dr.graphs.run(*tree_case))
    got_d, errors = [], []

    def draft_loop():
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(50):
                    got_d.append(_cpu(dr.graphs.run(*tree_case)))
        except Exception as e:    # surfaced below
            errors.append(e)

    th = threading.Thread(target=draft_loop)
    with torch.cuda.stream(torch.cuda.Stream()):
        th.start()
        got_t = [_cpu(graphs.run(*target_case)) for _ in range(50)]
    th.join()
    assert not errors, errors
    for got, want in ((got_t, want_t), (got_d, want_d)):
        assert len(got) == 50
        for out in got:
            for x, y in zip(out, want):
                assert torch.equal(x, y)


# --- EAGLE-3 under graphs (engine/eagle_runner.py, engine/fused_sd.py) ---------------

TINY_EAGLE = {"model_type": "llama", "vocab_size": 512, "hidden_size": 256,
              "intermediate_size": 512, "num_hidden_layers": 1, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 64, "max_position_embeddings": 512,
              "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "tie_word_embeddings": False}
EAGLE_TAPS = [0, 1, 1]


def _eagle_runners(tmp_path, **kw):
    """Random bf16 runners on the card: the tapped target, the async form's
    EAGLE-3 head (EagleDraftRunner, fan-out 2) and the fused form's
    (EagleModelRunner), with one StepGraphs of the test's attached to all
    three; `kw` adds to their config."""
    import json

    from ssd_tpu_torch.config import Config
    from ssd_tpu_torch.engine.eagle_runner import EagleDraftRunner, EagleModelRunner
    from ssd_tpu_torch.engine.graphs import StepGraphs
    from ssd_tpu_torch.engine.model_runner import ModelRunner

    dirs = []
    for name, cfg in (("target", TINY_LLAMA), ("eagle", TINY_EAGLE)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        (d / "config.json").write_text(json.dumps(cfg))
        dirs.append(str(d))
    common = dict(device="cuda", dtype="bfloat16", max_model_len=256,
                  kvcache_block_size=GRAPH_BS, num_kvcache_blocks=96, max_num_seqs=4,
                  draft=dirs[1], speculate=True, use_eagle=True, speculate_k=GRAPH_K,
                  eagle_layers=EAGLE_TAPS, **kw)
    t = ModelRunner(Config(dirs[0], spec_rounds=GRAPH_R, **common), init_random=True)
    fused = EagleModelRunner(Config(dirs[0], spec_rounds=GRAPH_R, **common)
                             .create_draft_config(), init_random=True)
    head = EagleDraftRunner(Config(dirs[0], draft_async=True, jit_speculate=True,
                                   async_fan_out=2, **common).create_draft_config(),
                            init_random=True)
    graphs = StepGraphs(t.device, [t.generator, fused.generator, head.generator])
    t.graphs = fused.graphs = head.graphs = graphs
    return t, fused, head, graphs


def _eagle_case(t, fused, head, kind, B_pad=4, B=3):
    """(key, fn, inputs, ghost) of an EAGLE step at B rows in bucket B_pad,
    device-tensor inputs at B_pad rows: the head's miss chain, its tree
    build (hit and miss rows, 2, 0 and 1 extend rows) and the fused
    superstep; disjoint tables of 10 blocks, contexts 33-70."""
    from ssd_tpu_torch.engine import fused_sd

    r = np.random.default_rng(13)
    K, R, M = GRAPH_K, GRAPH_R, t.max_blocks
    A, D = head.arch.act_dim, head.arch.hidden_size
    n = np.array([40, 57, 70, 33][:B], np.int32)
    bt = np.full((B, M), -1, np.int32)
    for b in range(B):
        bt[b, :10] = np.arange(10) + 1 + 10 * b
    temps = np.zeros(B, np.float32)
    tok = r.integers(3, 512, size=B).astype(np.int64)

    def dev(*shape, dtype=torch.float32):
        x = torch.zeros((B_pad,) + shape, dtype=dtype, device="cuda")
        x[:B] = torch.from_numpy(r.normal(size=(B,) + shape).astype(np.float32)).to(dtype)
        return x

    rec = dev(A)
    if kind == "eagle_chain":
        return head.eagle_chain_call(B_pad, tok, n - 2, bt, temps, recovery_acts=rec)
    if kind == "eagle_tree":
        glue = r.integers(3, 512, size=(B, 2 * K + 1)).astype(np.int64)
        return head.tree_build_call(B_pad, glue, rec, dev(K, A), dev(K, D, dtype=torch.bfloat16),
                                    np.array([2, 0, 1, 0][:B]), n - 2, bt,
                                    np.array([1, 0, 1, 0][:B]), temps)
    key, fn, _, ghost = fused_sd.eagle_call(t, fused, [], K, R, B_pad)
    inp = t._rows(B_pad, rec0=(tok.astype(np.int32), 0), n0=(n, 1), bt_target=(bt, -1),
                  temps_t=(temps, 0.0), bt_draft=(bt, -1), temps_d=(temps, 0.0))
    inp["acts0"] = rec
    return key, fn, inp, ghost


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["eagle_chain", "eagle_tree", "eagle_sd"])
def test_eagle_graph_replay_equals_eager_on_card(kind, tmp_path):
    """Each EAGLE graph's replay against the same step run eagerly on the
    same inputs (B = 3 in bucket 4): every output bit for bit; the tree
    build launches K3, the fused superstep K2 and not K3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    t, fused, head, graphs = _eagle_runners(tmp_path)
    key, fn, inputs, ghost = _eagle_case(t, fused, head, kind)
    eager = _cpu(fn(**_dev(inputs)))
    replay = _cpu(graphs.run(key, fn, inputs, ghost))
    for e, g in zip(eager, replay):
        assert torch.equal(g, e), kind
    launches = graphs.steps[key].launches
    assert launches.get(att.paged_attention, 0) > 0
    assert (launches.get(att.tree_attention, 0) > 0) == (kind == "eagle_tree")


@pytest.mark.cuda
def test_eagle_graph_launches_counted_per_replay_on_card(tmp_path):
    """The kernels' launch counts grow by their launches in the capture at
    every replay: the miss chain K paged launches (one layer), the tree
    build one (the glue) and K tree launches, the fused superstep R rounds
    of K+1 chain steps and the verify's L layers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    t, fused, head, graphs = _eagle_runners(tmp_path)
    K, R, L = GRAPH_K, GRAPH_R, TINY_LLAMA["num_hidden_layers"]
    per = {"eagle_chain": {att.paged_attention: K},
           "eagle_tree": {att.paged_attention: 1, att.tree_attention: K},
           "eagle_sd": {att.paged_attention: R * (K + 1 + L)}}
    for kind, want in per.items():
        key, fn, inputs, ghost = _eagle_case(t, fused, head, kind)
        graphs.capture(key, fn, ghost())
        for w in want:
            w.launches = 0
        for _ in range(5):
            graphs.run(key, fn, inputs, ghost)
        assert graphs.steps[key].launches == want, kind
        assert {w: w.launches for w in want} == {w: 5 * n for w, n in want.items()}, kind


@pytest.mark.cuda
def test_eagle_graph_counters_read_zero_after_replays_on_card(tmp_path):
    """100 replays each of the head's tree build and the fused superstep:
    every split-KV counter reads zero and the outputs equal the first
    replay's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    t, fused, head, graphs = _eagle_runners(tmp_path)
    for kind in ("eagle_tree", "eagle_sd"):
        key, fn, inputs, ghost = _eagle_case(t, fused, head, kind)
        first = _cpu(graphs.run(key, fn, inputs, ghost))
        for _ in range(98):
            graphs.run(key, fn, inputs, ghost)
        last = _cpu(graphs.run(key, fn, inputs, ghost))
        torch.cuda.synchronize()
        assert not graphs.steps[key].scratch.counters.any(), kind
        for a, b in zip(first, last):
            assert torch.equal(a, b), kind


# --- int8 weights: the W8A16 GEMM (K9, csrc/int8_weight_gemm.cu) ---------------

# (M, N, K, group sizes, "ghost" or None): the chip_smoke kernels phase's
# shapes (Llama-3.2-1B's qkv, o, gate/up and down at 8, 40, 80 and 128 rows;
# its LM head at 8 and 80 rows; prefill at 5534 rows; Qwen3-30B-A3B's expert
# gate and down at a b8 decode dispatch, 64 rows over 53 of 128 experts, and
# at b1's 8 one-row groups) and edge cases: one row, 16 rows, a batch whose
# last row is a ghost (zeros, as a padded graph bucket holds), K = 768 (the
# experts' down) on one group, N not a multiple of the 64-wide column tile,
# K not a multiple of a K stage, empty groups first, inside and last, a
# group larger than a tile, and K = 3072 (Llama-3.2-3B's q/o and k/v, whose
# K / 512 = 6 splits are cut to a power of two).
K9_DECODE = np.zeros(128, np.int64)
_r = np.random.default_rng(34)
K9_DECODE[_r.choice(128, 53, replace=False)] = 1
K9_DECODE[_r.choice(np.flatnonzero(K9_DECODE), 11, replace=False)] += 1     # 64 rows
K9_B1 = np.zeros(128, np.int64)
K9_B1[_r.choice(128, 8, replace=False)] = 1
K9_CASES = ([(m, n, k, None) for m in (8, 40, 80, 128)
             for n, k in ((2048, 2048), (512, 2048), (8192, 2048), (2048, 8192))]
            + [(m, 128256, 2048, None) for m in (8, 80)]
            + [(5534, 2048, 2048, None), (5534, 8192, 2048, None), (1, 2048, 2048, None),
               (16, 512, 2048, None), (8, 2048, 2048, "ghost"), (8, 2048, 768, None),
               (1, 72, 48, None), (37, 200, 784, None), (8, 3072, 3072, None),
               (8, 1024, 3072, None)]
            + [(None, 768, 2048, K9_DECODE), (None, 2048, 768, K9_DECODE),
               (None, 768, 2048, K9_B1), (None, 136, 96, [0, 130, 1, 0, 64, 3, 0])])


def _k9_case(M, N, K, sizes, dtype, seed):
    r = np.random.default_rng(seed)
    ghost = isinstance(sizes, str)
    if ghost:
        sizes = None
    if sizes is not None:
        M = int(sum(sizes))
    G = 1 if sizes is None else len(sizes)
    xn = r.normal(size=(M, K)).astype(np.float32)
    if ghost:
        xn[-1] = 0.0
    x = torch.from_numpy(xn).to("cuda", dtype)
    w = torch.from_numpy(r.integers(-127, 128, size=(G, N, K)).astype(np.int8)).cuda()
    s = torch.from_numpy((r.uniform(0.5, 2.0, size=(G, N)) * 0.02 / 127).astype(np.float32)).cuda()
    offs = None if sizes is None else t(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)).cuda()
    return x, w, s, offs


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["decode", "prefill", "simt"])
def test_int8_linear_matches_plain_on_card(route, monkeypatch):
    """K9 against its plain version at every case of K9_CASES, each bf16
    route forced on every case (bf16 x, bf16 and fp32 output), and the fp32
    route (fp32 x, fp32 output): within close() of the output dtype; a
    ghost row's outputs are zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    dtype = torch.float32 if route == "simt" else torch.bfloat16
    monkeypatch.setattr(linear, "int8_linear_route", lambda *shape: route)
    for i, (M, N, K, sizes) in enumerate(K9_CASES):
        x, w, s, offs = _k9_case(M, N, K, sizes, dtype, seed=40 + i)
        for out in {dtype, torch.float32}:
            got = linear.int8_linear(x, w, s, out_dtype=out, group_offsets=offs)
            torch.cuda.synchronize()
            want = linear.int8_linear_plain(x, w, s, out, offs)
            assert got.dtype == out and got.shape == want.shape
            assert close(got, want, out), (route, M, N, K, out)
            if isinstance(sizes, str):
                assert not got[-1].any()


# (M, widths, K, group sizes): products over one x that the engines launch
# together (q/k/v, gate/up, the experts' gate/up), at decode, verify, tree
# and prefill rows, Llama-3.2-3B's q/k/v at K = 3072, and the split-K
# products on their own.
K9_SHARED = [(m, (2048, 512, 512), 2048, None) for m in (1, 8, 40, 80, 128)] + [
    (8, (8192, 8192), 2048, None), (80, (8192, 8192), 2048, None),
    (8, (3072, 1024, 1024), 3072, None),
    (5534, (2048, 512, 512), 2048, None), (None, (768, 768), 2048, K9_DECODE),
    (None, (768, 768), 2048, K9_B1)]


@pytest.mark.cuda
def test_int8_linear_bits_repeat_on_card(monkeypatch):
    """K9's sums add K splits in a fixed order: two calls, and a CUDA graph
    replay against eager, give equal bits (q/o and down at 8 and 80 rows,
    and Llama-3.2-3B's q/o at K = 3072, split across a cluster; an expert
    dispatch); the shared-x launch
    (int8_linear_shared: one launch, on its first product's route) equals
    the separate int8_linear calls on that route bit for bit at every
    K9_SHARED case, and its graph replay its eager call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")

    def replayed(fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        return out

    for i, (M, N, K, sizes) in enumerate([(8, 2048, 2048, None), (80, 2048, 8192, None),
                                          (8, 2048, 8192, None), (8, 3072, 3072, None),
                                          (None, 768, 2048, K9_DECODE)]):
        x, w, s, offs = _k9_case(M, N, K, sizes, torch.bfloat16, seed=80 + i)
        fn = lambda: linear.int8_linear(x, w, s, group_offsets=offs)
        first, second = fn(), fn()
        assert torch.equal(first, second), (M, N, K)
        assert torch.equal(replayed(fn), first), (M, N, K)
    for i, (M, Ns, K, sizes) in enumerate(K9_SHARED):
        cases = [_k9_case(M, N, K, sizes, torch.bfloat16, seed=90 + 3 * i + j)
                 for j, N in enumerate(Ns)]
        x, offs = cases[0][0], cases[0][3]
        ws, ss = [c[1] for c in cases], [c[2] for c in cases]
        launches = linear.int8_linear.launches
        got = linear.int8_linear_shared(x, ws, ss, group_offsets=offs)
        assert linear.int8_linear.launches == launches + 1, (M, Ns)
        route = linear.int8_linear_route(x.dtype, x.shape[0], Ns[0], ws[0].shape[0])
        with monkeypatch.context() as m:
            m.setattr(linear, "int8_linear_route", lambda *shape: route)
            sep = [linear.int8_linear(x, w, s, group_offsets=offs) for w, s in zip(ws, ss)]
        assert all(torch.equal(a, b) for a, b in zip(got, sep)), (M, Ns, K)
        if i in (1, len(K9_SHARED) - 2):
            again = replayed(lambda: linear.int8_linear_shared(x, ws, ss, group_offsets=offs))
            assert all(torch.equal(a, b) for a, b in zip(again, got)), (M, Ns, K)


@pytest.mark.cuda
def test_int8_linear_arguments_on_card():
    """CPU tensors take the plain version; on the card a wrong dtype, a
    tensor on another device, a misaligned view and K off a multiple of 16
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    x, w, s, _ = _k9_case(8, 64, 64, None, torch.bfloat16, seed=3)
    cpu = [a.cpu() for a in (x, w, s)]
    assert torch.equal(linear.int8_linear(*cpu), linear.int8_linear_plain(*cpu))
    launches = linear.int8_linear.launches
    with pytest.raises(TypeError):
        linear.int8_linear(x.half(), w, s)
    with pytest.raises(TypeError):
        linear.int8_linear(x, w.to(torch.bfloat16), s)
    with pytest.raises(RuntimeError, match="is on"):
        linear.int8_linear(x, w.cpu(), s)
    with pytest.raises(ValueError, match="aligned"):
        linear.int8_linear(x.view(-1)[4:4 + 7 * 64].view(7, 64), w, s)
    x2, w2, s2, _ = _k9_case(8, 64, 40, None, torch.bfloat16, seed=4)
    with pytest.raises(ValueError, match="multiples of 16"):
        linear.int8_linear(x2, w2, s2)
    assert linear.int8_linear.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode", "moe", "eagle_chain"])
def test_int8_weight_graph_replay_equals_eager_on_card(kind, tmp_path):
    """An int8-weight step's graph replay against the same step run eagerly
    (B = 3 in bucket 4), every output bit for bit: the AR decode, the
    Qwen3-MoE decode (K9 over the experts, K6 never) and the int8 EAGLE
    head's chain; K9 launches in each capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    if kind == "eagle_chain":
        tr, fused, head, graphs = _eagle_runners(tmp_path, quantization="int8")
        assert head.params["fc"].dtype == torch.int8
        key, fn, inputs, ghost = _eagle_case(tr, fused, head, kind)
        eager = _cpu(fn(**_dev(inputs)))
    else:
        runner, graphs = _tiny_engine(tmp_path, TINY_MOE if kind == "moe" else TINY_LLAMA,
                                      quantization="int8")
        assert runner.params["lm_head"].dtype == torch.int8
        runner.graphs = graphs
        key, fn, inputs, ghost = _graph_case(runner, "decode")
        eager = _cpu(fn(**{k: torch.from_numpy(v).cuda() for k, v in inputs.items()}))
    replay = _cpu(graphs.run(key, fn, inputs, ghost))
    for e, g in zip(eager, replay):
        assert torch.equal(g, e), kind
    launches = graphs.steps[key].launches
    assert launches.get(linear.int8_linear, 0) > 0
    assert moe.grouped_gemm not in launches


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["simt", "prefill", "decode"])
def test_expert_parallel_groups_match_plain_on_card(route, monkeypatch):
    """One expert-parallel rank's dispatch (ops/moe.py): the offsets end
    before N, at the rank's own rows, and the rows past them (another
    rank's pairs) are not computed. K6 and K9 (int8 experts) on every
    route (simt: fp32 x) against their plain versions over the rows the
    groups own; close() as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    monkeypatch.setattr(moe, "grouped_gemm_route", lambda *shape: route)
    dtype = torch.float32 if route == "simt" else torch.bfloat16
    r = np.random.default_rng(41)
    for sizes, tail, K, Nout in [([0, 3, 1, 0, 2], 7, 64, 72), ([1] * 32 + [2] * 16, 64, 2048, 768),
                                 ([0, 130, 0, 5], 40, 96, 136)]:
        n, E = sum(sizes), len(sizes)
        x = torch.from_numpy(r.normal(size=(n + tail, K))).float().to("cuda", dtype)
        w = (torch.from_numpy(r.normal(size=(E, K, Nout))).float() * 0.05).to("cuda", dtype)
        offs = t(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)).cuda()
        got = moe.grouped_gemm(x, w, offs)
        torch.cuda.synchronize()
        assert close(got[:n], moe.grouped_gemm_plain(x, w, offs)[:n], dtype), (sizes[:6], K)
        wq = torch.from_numpy(r.integers(-127, 128, size=(E, Nout, K))).to("cuda", torch.int8)
        # Scales of a 0.02-scale weight, so outputs are O(1) as in a model.
        s = (torch.from_numpy(r.random((E, Nout))).float() * (0.04 / 127) + 0.01 / 127).cuda()
        monkeypatch.setattr(linear, "int8_linear_route",
                            lambda *shape: "simt" if route == "simt" else route)
        got = linear.int8_linear(x, wq, s, group_offsets=offs)
        torch.cuda.synchronize()
        assert close(got[:n], linear.int8_linear_plain(x, wq, s, dtype, offs)[:n], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_moe_mlp_expert_parallel_shards_sum_on_card(tp):
    """moe_mlp over each rank's experts (the router whole) summed over the
    ranks gives the whole layer's output on the card: bf16 within 2^-6
    |ref| + 2e-3 (each rank rounds its partial sum to bf16 once more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(5)
    T, D, E, Im, k = 24, 256, 16, 128, 4
    lp = {"router": torch.randn(D, E, generator=g, device="cuda").bfloat16() * 0.1,
          "moe_gate": torch.randn(E, D, Im, generator=g, device="cuda").bfloat16() * 0.05,
          "moe_up": torch.randn(E, D, Im, generator=g, device="cuda").bfloat16() * 0.05,
          "moe_down": torch.randn(E, Im, D, generator=g, device="cuda").bfloat16() * 0.05}
    x = torch.randn(T, D, generator=g, device="cuda").bfloat16()
    want = moe.moe_mlp(x, lp, k, True).float()
    El = E // tp
    got = sum(moe.moe_mlp(x, {**lp, **{n: lp[n][r * El:(r + 1) * El].contiguous()
                                       for n in ("moe_gate", "moe_up", "moe_down")}},
                          k, True, rank=r).float() for r in range(tp))
    assert ((got - want).abs() <= 2e-3 + 2.0 ** -6 * want.abs()).all()


def _write_checkpoint(d: str, experts: int):
    """A tiny HF-layout checkpoint of fp32 N(0, 0.1) weights (a Llama, or
    with experts a Qwen3-MoE), written by the port's own writer."""
    import json
    import os

    from ssd_tpu_torch.utils.loader import save_safetensors

    g = torch.Generator().manual_seed(11)
    D, V, H, Hkv, hd, I, Im = 64, 96, 4, 2, 16, 128, 48

    def w(*shape):
        return torch.randn(*shape, generator=g) * 0.1

    t = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D),
         "lm_head.weight": w(V, D)}
    for i in range(2):
        p = f"model.layers.{i}."
        t.update({p + "input_layernorm.weight": 1 + w(D),
                  p + "post_attention_layernorm.weight": 1 + w(D),
                  p + "self_attn.q_proj.weight": w(H * hd, D),
                  p + "self_attn.k_proj.weight": w(Hkv * hd, D),
                  p + "self_attn.v_proj.weight": w(Hkv * hd, D),
                  p + "self_attn.o_proj.weight": w(D, H * hd)})
        if experts:
            t.update({p + "self_attn.q_norm.weight": 1 + w(hd),
                      p + "self_attn.k_norm.weight": 1 + w(hd),
                      p + "mlp.gate.weight": w(experts, D)})
            for e in range(experts):
                q = f"{p}mlp.experts.{e}."
                t.update({q + "gate_proj.weight": w(Im, D), q + "up_proj.weight": w(Im, D),
                          q + "down_proj.weight": w(D, Im)})
        else:
            t.update({p + "mlp.gate_proj.weight": w(I, D), p + "mlp.up_proj.weight": w(I, D),
                      p + "mlp.down_proj.weight": w(D, I)})
    save_safetensors(os.path.join(d, "model.safetensors"), t)
    cfg = {"model_type": "qwen3_moe" if experts else "llama", "vocab_size": V,
           "hidden_size": D, "intermediate_size": I, "num_hidden_layers": 2,
           "num_attention_heads": H, "num_key_value_heads": Hkv, "head_dim": hd,
           "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "max_position_embeddings": 256,
           "tie_word_embeddings": False, "eos_token_id": 2, "bos_token_id": 1}
    if experts:
        cfg.update(num_experts=experts, num_experts_per_tok=2, moe_intermediate_size=Im,
                   norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[])
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)


@pytest.mark.cuda
@pytest.mark.parametrize("experts", [0, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_params_on_card_equal_host(tmp_path, dtype, experts):
    """utils/loader.py stages each tensor through page-locked memory and
    converts and transposes it on the card: the card's parameters equal the
    host's bit for bit (fp32 stored, loaded as fp32 and as bf16; a Llama
    and a Qwen3-MoE with its expert stacks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from ssd_tpu_torch.config import ModelConfig
    from ssd_tpu_torch.utils.loader import load_params

    _write_checkpoint(str(tmp_path), experts)
    mc = ModelConfig.from_pretrained(str(tmp_path))
    host = load_params(str(tmp_path), mc, dtype, torch.device("cpu"))
    card = load_params(str(tmp_path), mc, dtype, torch.device("cuda"))

    def leaves(p, prefix=""):
        if isinstance(p, dict):
            for k, v in p.items():
                yield from leaves(v, f"{prefix}.{k}")
        elif isinstance(p, list):
            for i, v in enumerate(p):
                yield from leaves(v, f"{prefix}.{i}")
        else:
            yield prefix, p

    a, b = dict(leaves(host)), dict(leaves(card))
    assert a.keys() == b.keys() and any("moe_gate" in k for k in a) == bool(experts)
    for k, x in a.items():
        y = b[k]
        assert y.is_cuda and y.is_contiguous() and y.dtype == x.dtype, k
        assert torch.equal(y.cpu(), x), k


# --- multi-host serving on one card (parallel/comm.py) ------------------------

# One "host" on cuda:0: AR and async SSD at draft_dp=2 (the target its own
# draft; one replica a host, the replies unioned), each joining through the
# TCP rendezvous at its own port, eagerly; prints each mode's tokens and
# the kernels' launches.
HOST_ON_CARD = """
import json, sys
import torch
import ssd_tpu_torch
from ssd_tpu_torch import SamplingParams
from ssd_tpu_torch.ops import attention as att

host, d, ports, prompts, kw = sys.argv[1], sys.argv[2], *map(json.loads, sys.argv[3:6])
host = int(host)
kernels = (att.flat_prefill_attention, att.paged_attention, att.tree_attention)
for mode, port in zip(("ar", "ssd_dp2"), ports):
    extra = {} if mode == "ar" else dict(draft=d, speculate=True, speculate_k=3,
                                         draft_async=True, async_fan_out=2, draft_dp=2)
    llm = ssd_tpu_torch.LLM(d, num_hosts=2, num_devices=2, coordinator_address=f"127.0.0.1:{port}",
                            host_id=host, device="cuda", enforce_eager=True, **kw, **extra)
    for k in kernels:
        k.launches = 0
    outs, m = llm.generate(prompts, SamplingParams(temperature=0.0, max_new_tokens=16,
                                                   ignore_eos=True), use_tqdm=False)
    print("HOST", json.dumps(dict(mode=mode, backend=llm.comm.backend,
                                  tokens=[o["token_ids"] for o in outs],
                                  hits=[float(x) for x in m["cache_hits"]],
                                  launches={k.__name__: k.launches for k in kernels})), flush=True)
    llm.exit()
"""


@pytest.mark.cuda
def test_two_hosts_on_one_card_equal_tp1(tmp_path):
    """Two "host" processes with one rank each on cuda:0 join through the TCP
    rendezvous, which picks gloo (they share the card), and serve a random
    fp32 model eagerly: AR with continuous batching and async SSD at
    draft_dp=2 (each host owns one replica). Each host's greedy tokens and
    cache hits equal the card's single-process engine (tp 1), and K1, K2
    (and in SSD K3) launch on both hosts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import json
    import os
    import socket
    import subprocess
    import sys

    from ssd_tpu_torch import LLM, SamplingParams

    d = tmp_path / "llama"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(TINY_LLAMA))
    kw = dict(init_random=True, dtype="float32", max_model_len=256,
              kvcache_block_size=GRAPH_BS, num_kvcache_blocks=64, max_num_seqs=2)
    g = np.random.default_rng(5)
    prompts = [g.integers(3, 512, size=n).tolist() for n in (9, 40, 17, 70)]
    socks = [socket.socket() for _ in range(2)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", HOST_ON_CARD, str(h), str(d), json.dumps(ports),
         json.dumps(prompts), json.dumps(kw)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=root, env=dict(os.environ, PYTHONPATH=root))
        for h in range(2)]
    want = {}
    try:
        for mode in ("ar", "ssd_dp2"):
            extra = {} if mode == "ar" else dict(draft=str(d), speculate=True, speculate_k=3,
                                                 draft_async=True, async_fan_out=2, draft_dp=2)
            llm = LLM(str(d), device="cuda", enforce_eager=True, **kw, **extra)
            outs, m = llm.generate(prompts, SamplingParams(temperature=0.0, max_new_tokens=16,
                                                           ignore_eos=True), use_tqdm=False)
            want[mode] = ([o["token_ids"] for o in outs], [float(x) for x in m["cache_hits"]])
            llm.exit()
        texts = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert sum(want["ssd_dp2"][1]) > 0
    for h, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, text[-4000:]
        runs = {r["mode"]: r for r in (json.loads(line[5:]) for line in text.splitlines()
                                       if line.startswith("HOST "))}
        for mode, (tokens, hits) in want.items():
            run = runs[mode]
            assert run["backend"] == "gloo" and run["tokens"] == tokens, (h, mode)
            assert run["hits"] == hits, (h, mode)
            need = ["flat_prefill_attention", "paged_attention"] + (
                ["tree_attention"] if mode == "ssd_dp2" else [])
            assert all(run["launches"][k] for k in need), (h, mode, run["launches"])


@pytest.mark.cuda
@pytest.mark.parametrize("tool,argv", [
    ("sd_diag", ["--profile"]), ("sd_diag", ["--eagle"]), ("fasync_diag", ["--batch", "1"]),
    ("fasync_diag", ["--batch", "3"]), ("prefill_diag", [])],
    ids=["sd", "sd_eagle", "fasync_b1", "fasync_b3", "prefill"])
def test_diag_full_replay_equals_eager_on_card(tool, argv):
    """Each step-decomposition tool (ssd_tpu_torch/bench/) at its tiny
    geometry in bf16: its full variant replayed from the CUDA graph equals
    the production function called eagerly, bit for bit; every variant's
    ms is above 0; and the launches a replay follow the decomposition
    (K1 once a layer a prefill and none in the stripped prefills, K2 and no
    K3 in the sd round, its chain and verify, K2 and K3 in the async
    superstep, K2 in its sync form, K3 in the tree build, no attention
    kernel in the fork); --profile's replay under torch.profiler sees the
    variant's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    import importlib

    mod = importlib.import_module(f"ssd_tpu_torch.bench.{tool}")
    small = ["--r", "2"] if tool == "prefill_diag" else ["--rounds", "3", "--ctx-pad", "512"]
    out = mod.main(["--tiny", "--reps", "2", *small, *argv])
    assert out["full_replay_equals_eager"] is True
    n = out["launches"]
    assert all(out[v] > 0 for v in n)
    if tool == "prefill_diag":
        assert n["full"] == {"K1": out["layers"] * out["r"], "K2": 0, "K3": 0}
        assert all(n[v]["K1"] == n[v]["K2"] == 0 for v in ("no_kernel", "no_attn", "matmul",
                                                            "head"))
    elif tool == "sd_diag":
        assert all(n[v]["K2"] > 0 and n[v]["K3"] == 0 for v in ("full", "draft", "verify"))
        for v, prof in out.get("profile", {}).items():
            assert prof["union_ms"] > 0 and prof["kernels"] > 0, v
    else:
        assert n["build"]["K3"] > 0 and n["full"]["K2"] > 0 and n["full"]["K3"] > 0
        assert n["sync"]["K2"] > 0
        assert not any(n["fork"].values())
