"""The algorithm of the split-KV paged kernels (K2 and K4,
ssd_tpu_torch/csrc/paged_split.cuh), written out in PyTorch and held to the
port's plain versions and to the JAX package.

`split_model` below follows the kernels' split: the positions of each
(sequence, KV head) cut into fixed absolute chunks of
att.PAGED_CHUNK[(hd, int8)] positions, each chunk reduced to a partial
(m, l, acc) in fp32 by an online softmax over 32-position tiles (in the
int8_mxu mode each tile's weights quantized from its own scores, as the
kernel does), and the partials merged in chunk order, a chunk in which a
row attends nothing skipped. (Inside a chunk the bf16 kernels keep one
online state per warp over 16 of every 64 positions and merge the four;
that changes rounding only.) It must equal paged_attention_plain within
1e-5 (fp32 rounding of a different summation order) over the fp cache and
the int8 pair in both modes, at the edges the kernel has to handle:
contexts 0 and 1, a context exactly at a chunk boundary, rows whose causal
window ends before the call's last chunk, -1 table entries, a context past
a full table, and R = Q * G = 72 rows (several row passes). The fp cache
and the "int8" mode are also held to ssd_tpu's jnp oracle, and one hd-64
case to its Pallas v3 kernel in interpret mode; the int8_mxu mode only to
the port's plain version, since the TPU quantizes p per chunk of its grid
and not per 32-position tile.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssd_tpu.ops import attention as jatt
from ssd_tpu.ops import pallas_attention as patt
from ssd_tpu_torch.ops import attention as att
from tests.torch_cases import paged_case


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker (the HF oracle of the
    JAX package's tests) keeps its own thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
TILE = att.PAGED_S8_TILE
BS = 16


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **TOL)


def split_model(q, kv_layer, block_tables, context_lens, qeff, block_size, scale,
                s8=False, chunk=None):
    """The kernels' split on CPU tensors (module docstring); returns
    (out [B, Q, Hq, hd] f32, live chunks per sequence)."""
    quant = isinstance(kv_layer, tuple)
    data = kv_layer[0] if quant else kv_layer
    B, Q, Hq, hd = q.shape
    Hkv = data.shape[0]
    G, R = Hq // Hkv, Q * (Hq // Hkv)
    chunk = chunk or att.PAGED_CHUNK[(hd, quant)]
    assert chunk % TILE == 0
    C = block_tables.shape[1] * block_size
    n_chunks = -(-C // chunk)
    Cp = n_chunks * chunk
    slots = att._slots(block_tables, block_size, C)                       # [B, C]
    kv = data[:, slots].permute(1, 0, 2, 3).float()                       # [B, Hkv, C, 2hd]
    kv = torch.nn.functional.pad(kv, (0, 0, 0, Cp - C))
    k, v = kv[..., :hd], kv[..., hd:]
    if quant:
        sc = torch.nn.functional.pad(kv_layer[1][:, :, slots].permute(2, 0, 1, 3), (0, Cp - C))
        sk, sv = sc[:, :, 0], sc[:, :, 1]                                 # [B, Hkv, Cp]
    # Rows r = i * G + g of each KV head, as the kernel orders them.
    qr = q.float().reshape(B, Q, Hkv, G, hd).permute(0, 2, 1, 3, 4).reshape(B, Hkv, R, hd)
    ctx = context_lens.long()
    kv_len = ctx.clamp(max=C)
    limit = (ctx - qeff.long())[:, None] + torch.arange(R)[None, :] // G  # [B, R]
    pos = torch.arange(Cp)
    attend = (pos[None, None, :] <= limit[:, :, None]) & (pos[None, None, :] < kv_len[:, None, None])
    if s8:
        qs = qr.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) * np.float32(1 / 127)
        q8 = torch.round(qr / qs)
        raw = torch.einsum("bhrd,bhcd->bhrc", q8, k)        # exact integers
        scores = raw * (qs * scale) * sk[:, :, None, :]
    else:
        scores = torch.einsum("bhrd,bhcd->bhrc", qr, k) * scale
        if quant:
            scores = scores * sk[:, :, None, :]
    neg = torch.tensor(float("-inf"))
    ms, ls, accs = [], [], []
    for c in range(n_chunks):
        m = torch.full((B, Hkv, R), float("-inf"))
        l = torch.zeros(B, Hkv, R)
        acc = torch.zeros(B, Hkv, R, hd)
        for t0 in range(c * chunk, (c + 1) * chunk, TILE):
            sl = slice(t0, t0 + TILE)
            ok = attend[:, None, :, sl]                                   # [B, 1, R, T]
            s = torch.where(ok, scores[..., sl], neg)
            vt = v[:, :, sl]
            if s8:
                tmax = s.amax(dim=-1)
                m_new = torch.maximum(m, tmax)
                e = torch.where(ok, torch.exp(s - torch.where(tmax.isfinite(), tmax, 0.0)[..., None]), 0.0)
                pq = e * sv[:, :, None, sl]
                ps = pq.amax(dim=-1).clamp(min=1e-30) * np.float32(1 / 127)
                p8 = torch.round(pq / ps[..., None])
                alpha = torch.where(m.isfinite(), torch.exp(m - torch.where(m_new.isfinite(), m_new, 0.0)), 0.0)
                cf = torch.where(tmax.isfinite(), torch.exp(tmax - torch.where(m_new.isfinite(), m_new, 0.0)), 0.0)
                l = l * alpha + cf * e.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum("bhrt,bhtd->bhrd", p8, vt) * (cf * ps)[..., None]
            else:
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.where(ok, torch.exp(s - torch.where(m_new.isfinite(), m_new, 0.0)[..., None]), 0.0)
                alpha = torch.where(m.isfinite(), torch.exp(m - torch.where(m_new.isfinite(), m_new, 0.0)), 0.0)
                l = l * alpha + p.sum(dim=-1)
                w = p * sv[:, :, None, sl] if quant else p
                acc = acc * alpha[..., None] + torch.einsum("bhrt,bhtd->bhrd", w, vt)
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    # Merge in chunk order; a chunk where a row attends nothing is skipped.
    mx = torch.stack(ms).amax(dim=0)
    L = torch.zeros(B, Hkv, R)
    A = torch.zeros(B, Hkv, R, hd)
    for m, l, acc in zip(ms, ls, accs):
        live = m.isfinite()
        f = torch.where(live, torch.exp(m - torch.where(live, mx, 0.0)), 0.0)
        L = L + l * f
        A = A + acc * f[..., None]
    out = torch.where(L[..., None] > 0, A / L.clamp(min=1e-30)[..., None], 0.0)
    out = out.reshape(B, Hkv, Q, G, hd).permute(0, 2, 1, 3, 4).reshape(B, Q, Hq, hd)
    n_pos = (kv_len.clamp(max=(ctx - qeff.long() + Q).clamp(min=0)))
    return out, -(-n_pos // chunk)


def quant_layer(kv):
    """The int8 pair of a cache [Hkv, S, 2hd] (V x 3, every slot written),
    quantized by ssd_tpu's store_kv, as numpy."""
    Hkv, S, hd2 = kv.shape
    hd = hd2 // 2
    x = kv.transpose(1, 0, 2)
    layer = jatt.store_kv((jnp.zeros((Hkv, S, hd2), jnp.int8), jnp.full((Hkv, 2, S), 1e-10, jnp.float32)),
                          jnp.asarray(x[..., :hd]), jnp.asarray(x[..., hd:] * 3.0),
                          jnp.arange(S, dtype=jnp.int32))
    return tuple(np.asarray(a) for a in layer)


# name -> (B, Q, Hq, Hkv, hd, M, contexts, qeff or None (= Q), ghost rows)
CASES = {
    "ctx0_ctx1": (3, 1, 8, 2, 64, 8, [0, 1, 70], None, 0),
    "chunk_boundary": (2, 1, 8, 2, 64, 16, [128, 256], None, 0),
    "window_ends_before_last_chunk": (2, 5, 8, 2, 64, 16, [130, 258], None, 0),
    "ghost_rows_minus1_tables": (3, 5, 8, 2, 64, 16, [150, 5], None, 1),
    "overshoot": (3, 4, 8, 2, 64, 4, [70, 30, 64], None, 0),   # table holds 64
    "glue_qeff": (3, 9, 8, 2, 64, 8, [40, 90, 127], [5, 9, 7], 0),
    "r72_two_passes": (2, 9, 16, 2, 64, 16, [200, 37], None, 0),
    "hd128_two_chunks": (2, 5, 8, 2, 128, 16, [200, 129], None, 0),
}


def _case(name, seed):
    B, Q, Hq, Hkv, hd, M, ctx_lens, qeff, ghosts = CASES[name]
    q, kv, bt, ctx = paged_case(seed, B, Q, Hq, Hkv, hd, BS, M, ctx_lens, ghosts)
    ctx[:B - ghosts] = ctx_lens[:B - ghosts]   # past a full table where asked
    qe = np.full(B, Q, np.int32) if qeff is None else np.asarray(qeff, np.int32)
    return q, kv, bt, ctx, qe


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("kind", ["fp", "int8", "int8_mxu"])
def test_split_model_matches_plain(name, kind):
    """The kernel's algorithm equals the port's plain version (fp32, 1e-5)."""
    q, kv, bt, ctx, qeff = _case(name, 100 + list(CASES).index(name))
    layer = t(kv) if kind == "fp" else tuple(t(a) for a in quant_layer(kv))
    hd = q.shape[-1]
    scale = hd ** -0.5
    args = (t(q), layer, t(bt), t(ctx), t(qeff), BS, scale)
    got, live = split_model(*args, s8=kind == "int8_mxu")
    want = att.paged_attention_plain(*args, s8=kind == "int8_mxu")
    close(got, want)
    assert torch.isfinite(got).all()
    if name == "ctx0_ctx1":
        assert got[0].abs().max() == 0 and live[0] == 0   # nothing to attend
    if name in ("window_ends_before_last_chunk", "hd128_two_chunks", "r72_two_passes"):
        assert live.max() >= 2   # several chunks are merged


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_split_model_matches_jax_oracle(name, kind):
    """The fp cache and the "int8" mode against ssd_tpu's jnp oracle; rows
    that attend nothing (context 0) give zeros in both."""
    q, kv, bt, ctx, qeff = _case(name, 200 + list(CASES).index(name))
    layer = kv if kind == "fp" else quant_layer(kv)
    M = bt.shape[1]
    scale = q.shape[-1] ** -0.5
    tl = t(layer) if kind == "fp" else tuple(t(a) for a in layer)
    got, _ = split_model(t(q), tl, t(bt), t(ctx), t(qeff), BS, scale)
    jl = jnp.asarray(layer) if kind == "fp" else tuple(jnp.asarray(a) for a in layer)
    want = jatt.paged_attention(q, jl, bt, ctx, BS, M * BS, scale, qeff=jnp.asarray(qeff))
    close(got, want)


@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_split_model_matches_pallas_v3(kind):
    """One hd-64 verify batch (two chunks, -1 table entries, a ghost row)
    against the Pallas v3 kernel in interpret mode (its live rows)."""
    q, kv, bt, ctx, qeff = _case("ghost_rows_minus1_tables", 300)
    layer = kv if kind == "fp" else quant_layer(kv)
    M = bt.shape[1]
    scale = 64 ** -0.5
    tl = t(layer) if kind == "fp" else tuple(t(a) for a in layer)
    got, live = split_model(t(q), tl, t(bt), t(ctx), t(qeff), BS, scale)
    assert live[0] == 2
    jl = jnp.asarray(layer) if kind == "fp" else tuple(jnp.asarray(a) for a in layer)
    want = patt.paged_attention_v3(q, jl, bt, ctx, qeff, BS, M * BS, scale, seqs_per_step=2,
                                   interpret=True)
    close(got[:2], np.asarray(want)[:2])


def test_chunk_rule():
    """Every chunk length is a whole number of the kernels' 64-position ring
    tiles (two s8 tiles) and at most their 512 positions; the rule covers
    every head dim the kernels take (each even hd in [16, 256],
    att.kernel_width) and both caches."""
    assert set(att.PAGED_CHUNK) == {(hd, q8) for hd in range(16, 257, 2) for q8 in (False, True)}
    for (hd, _), chunk in att.PAGED_CHUNK.items():
        assert att.kernel_width(hd) in (64, 128, 192, 256)
        assert chunk % (2 * att.PAGED_S8_TILE) == 0 and 0 < chunk <= 512
