"""The algorithm of K1's bf16 kernel (flat_prefill_tc_kernel in
ssd_tpu_torch/csrc/flat_prefill_attention.cu), written out in PyTorch and
held to the port's plain version and to the JAX package.

`flat_prefill_model` below follows the kernel: per KV head, query tiles of
64 rows (64 / G tokens times the G heads), four warps of 16 rows; the
block's 64-column tiles at absolute multiples of 64 from the tile holding
its rows' smallest `lo` to their largest `hi`, each column's slot resolved
through flat_pages (columns past the page list read zeros); per warp a tile
is skipped when it misses all the warp's rows, and masked only when it is
not inside every row's interval; S = Q.K^T in fp32 (for int8 pages the
integer scores times scale * sk), the online softmax, and P.V with the
weights (p, or p * sv) split into hi = bf16(w) and lo = bf16(w - hi), both
against V. Rows that attend nothing give zeros.

Inputs are bf16 values held in fp32 (the kernel's operands), so products are
exact and the model differs from the plain version by fp32 summation order
and by the weights' hi + lo representation, which is off by at most 2^-18
of each weight (two roundings to 8 bits), so by at most 2^-18 max|V| in a
row's output. It must equal flat_prefill_attention_plain within
1e-5 + 2^-18 max|V| + 1e-5 |ref| (the tolerance of `_tol`), over the fp
cache and the int8 pair, at hd 64 and 128, G 4 and 8, block sizes 16 and 64:
a prefix-cached prompt, a one-token prompt, a prompt cached but for its last
token, padding rows, and (at block size 16) rows whose hull starts inside a
64-column tile. It is also held to ssd_tpu's jnp oracle
(ssd_tpu/ops/attention.py::flat_prefill_attention on the dense stream) and,
at one small case, to the Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssd_tpu.ops import attention as jatt
from ssd_tpu.ops import pallas_attention as patt
from ssd_tpu_torch.ops import attention as att
from tests.test_torch_paged_split import quant_layer
from tests.torch_cases import flat_batch


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this module's tests, restored after it, so the
    other modules' torch code in the same xdist worker keeps its own."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ROWS, TILE, WARP_ROWS = 64, 64, 16   # the kernel's tc::kRows, tc::kTile, rows a warp
LENS, CACHED = [37, 1, 100, 70, 77], [20, 0, 0, 69, 13]
PAD_ROWS = 5


def t(a):
    return torch.from_numpy(np.array(a))


def bf16(x):
    return x.to(torch.bfloat16).float()


def _tol(layer):
    """fp32 summation order, plus the hi + lo weights' error bound
    2^-18 max|V| (module docstring)."""
    if isinstance(layer, tuple):
        hd = layer[0].shape[-1] // 2
        vmax = (layer[0][..., hd:].float() * layer[1][:, 1, :, None]).abs().max()
    else:
        vmax = layer[..., layer.shape[-1] // 2:].abs().max()
    return dict(rtol=1e-5, atol=1e-5 + 2.0 ** -18 * float(vmax))


def close(got, want, layer):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **_tol(layer))


def _exp(x):
    """exp in fp64 rounded to fp32 once (see test_torch_tree_split._exp)."""
    return torch.exp(x.double()).float()


def flat_prefill_model(q, kv_layer, flat_pages, row_lo, row_hi, block_size, scale):
    """The kernel's tiles on CPU tensors (module docstring). Returns (out
    [T, Hq, hd] f32, counts of tile visits by warps: computed with the mask,
    computed without it, skipped)."""
    int8 = isinstance(kv_layer, tuple)
    data = kv_layer[0] if int8 else kv_layer
    T, Hq, hd = q.shape
    Hkv = data.shape[0]
    G = Hq // Hkv
    tokens = ROWS // G
    n_cols = flat_pages.shape[0] * block_size
    lo_all, hi_all = row_lo.long(), row_hi.long()
    out = torch.zeros(T, Hq, hd)
    counts = dict(masked=0, unmasked=0, skipped=0)
    r = torch.arange(ROWS)
    for h in range(Hkv):
        kvh = data[h].float()
        for qt in range(-(-T // tokens)):
            tok = qt * tokens + r // G
            valid = (r < tokens * G) & (tok < T)
            tokc = tok.clamp(max=T - 1)
            lo = torch.where(valid, lo_all[tokc], 0)
            hi = torch.where(valid, hi_all[tokc], 0)
            heads = h * G + r % G
            Q = torch.where(valid[:, None], q[tokc, heads].float(), 0.0)
            live_row = lo < hi
            if not live_row.any():
                continue
            c_begin = int(lo[live_row].min()) // TILE * TILE
            n_tiles = -(-(int(hi[live_row].max()) - c_begin) // TILE)
            m = torch.full((ROWS,), float("-inf"))
            l = torch.zeros(ROWS)
            acc = torch.zeros(ROWS, hd)
            for it in range(n_tiles):
                c0 = c_begin + it * TILE
                cols = c0 + torch.arange(TILE)
                live = cols < n_cols
                page = flat_pages.long()[cols.clamp(max=n_cols - 1) // block_size].clamp(min=0)
                slot = torch.where(live, page * block_size + cols % block_size, 0)
                K = torch.where(live[:, None], kvh[slot, :hd], 0.0)
                V = torch.where(live[:, None], kvh[slot, hd:], 0.0)
                if int8:
                    sk = torch.where(live, kv_layer[1][h, 0, slot], 0.0)
                    sv = torch.where(live, kv_layer[1][h, 1, slot], 0.0)
                for w in range(ROWS // WARP_ROWS):
                    rows = slice(WARP_ROWS * w, WARP_ROWS * (w + 1))
                    wlo, whi, wlive = lo[rows], hi[rows], live_row[rows]
                    if not wlive.any() or c0 >= int(whi[wlive].max()) \
                            or c0 + TILE <= int(wlo[wlive].min()):
                        counts["skipped"] += 1
                        continue
                    x = (Q[rows] @ K.T) * scale
                    if int8:
                        x = x * sk
                    if not (c0 >= int(wlo.max()) and c0 + TILE <= int(whi.min())):
                        ok = (cols >= wlo[:, None]) & (cols < whi[:, None])
                        x = torch.where(ok, x, float("-inf"))
                        counts["masked"] += 1
                    else:
                        counts["unmasked"] += 1
                    m_old = m[rows]
                    m_new = torch.maximum(m_old, x.max(dim=1).values)
                    alpha = torch.where(m_old == float("-inf"), 0.0, _exp(m_old - m_new))
                    p = torch.where(x == float("-inf"), 0.0, _exp(x - m_new[:, None]))
                    l[rows] = l[rows] * alpha + p.sum(dim=1)
                    m[rows] = m_new
                    wgt = p * sv if int8 else p
                    w_hi = bf16(wgt)
                    w_lo = bf16(wgt - w_hi)
                    acc[rows] = acc[rows] * alpha[:, None] + w_hi @ V + w_lo @ V
            o = torch.where(l[:, None] > 0, acc / l.clamp(min=1e-30)[:, None], 0.0)
            out[tok[valid], heads[valid]] = o[valid]
    return out, counts


def _case(hd, G, bs, kind, seed=5):
    """The module docstring's batch (+ PAD_ROWS padding rows) at Hkv 2, as
    bf16 values in fp32; the int8 pair quantized from the fp cache by
    ssd_tpu's store_kv (V x 3)."""
    q, kv, pages, lo, hi, _, T = flat_batch(seed + hd + G + bs, LENS, CACHED, 2 * G, 2, hd, bs,
                                            pad_rows=PAD_ROWS)
    kv = bf16(t(kv))
    layer = tuple(t(a) for a in quant_layer(kv.numpy())) if kind == "int8" else kv
    return bf16(t(q)), layer, t(pages), t(lo), t(hi), T


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("G", [4, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("bs", [16, 64])
def test_flat_prefill_model_matches_plain(bs, hd, G, kind):
    q, layer, pages, lo, hi, T = _case(hd, G, bs, kind)
    scale = hd ** -0.5
    got, counts = flat_prefill_model(q, layer, pages, lo, hi, bs, scale)
    close(got, att.flat_prefill_attention_plain(q, layer, pages, lo, hi, bs, scale), layer)
    assert got[T:].abs().max() == 0   # padding rows
    # The batch takes all three of the kernel's paths.
    assert min(counts.values()) > 0, counts


@pytest.mark.parametrize("kind", ["fp", "int8"])
@pytest.mark.parametrize("hd,G", [(64, 4), (128, 8)])
def test_flat_prefill_model_matches_jax_oracle(hd, G, kind):
    """Against ssd_tpu's jnp oracle on the dense page stream (dequantized by
    ssd_tpu's dense_pages for the int8 pair)."""
    bs = 16
    q, layer, pages, lo, hi, T = _case(hd, G, bs, kind, seed=9)
    scale = hd ** -0.5
    got, _ = flat_prefill_model(q, layer, pages, lo, hi, bs, scale)
    jlayer = tuple(jnp.asarray(x.numpy()) for x in layer) if kind == "int8" else jnp.asarray(layer.numpy())
    dense = jatt.dense_pages(jlayer, jnp.asarray(pages.numpy()), bs)
    want = jatt.flat_prefill_attention(jnp.asarray(q.numpy()), dense, jnp.asarray(lo.numpy()),
                                       jnp.asarray(hi.numpy()), scale)
    close(got, np.asarray(want), layer)


def test_flat_prefill_model_matches_pallas_interpret():
    """One small case against the TPU kernel itself (interpret mode): two
    prompts, one prefix-cached, at hd 64, G 4, block size 16."""
    bs, hd, G = 16, 64, 4
    q, kv, pages, lo, hi, _, T = flat_batch(21, [40, 23], [17, 0], 2 * G, 2, hd, bs, pad_rows=2)
    q, kv = bf16(t(q)), bf16(t(kv))
    got, _ = flat_prefill_model(q, kv, t(pages), t(lo), t(hi), bs, hd ** -0.5)
    want = patt.flat_prefill_attention(q.numpy(), kv.numpy(), jnp.asarray(pages), jnp.asarray(lo),
                                       jnp.asarray(hi), bs, hd ** -0.5, tq=16, tk=32,
                                       interpret=True)
    close(got, np.asarray(want), kv)
