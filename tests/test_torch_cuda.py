"""The port's CUDA kernels against their plain PyTorch versions on the card,
over the fp cache and over the int8 cache (kv_quant "int8" and "int8_mxu"),
the MoE grouped GEMM, and the two bench probes (the s8 dot paths and the
paged kernels' stage variants).

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
from ssd_tpu_torch.ops import moe, probes
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
    rows = torch.arange(args[1].shape[1], device="cuda")
    att.store_kv(pair, args[1][:, :, :hd].transpose(0, 1), args[1][:, :, hd:].transpose(0, 1),
                 rows.int(), rows)
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
def test_s8_probe_paths_exact_on_card():
    """The three s8 probe kernels at bench/s8_probe.py's shapes equal their
    fp64 plain version bit for bit, and each launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    q8, k8, qb = s8_probe.inputs("cuda")
    want = probes.s8_dot_plain(q8, k8)
    for fn, q in ((probes.s8_dot_mma, q8), (probes.s8_dot_dp4a, q8), (probes.s8_dot_bf16, qb)):
        n = fn.launches
        got = fn(q, k8)
        torch.cuda.synchronize()
        assert torch.equal(got.double(), want.double()), fn.__name__
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
