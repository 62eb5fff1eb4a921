"""The algorithm of the split-KV tree kernels (K3 and K5,
ssd_tpu_torch/csrc/tree_split.cuh), written out in PyTorch and held to the
port's plain version and to the JAX package.

`tree_split_model` below follows the kernels: the positions of each
(sequence, KV head) cut into fixed absolute chunks of
att.TREE_CHUNK[(hd, int8)] positions, each chunk reduced to a partial
(m, l, acc) in fp32 by an online softmax over 64-position tiles (in the
int8_mxu mode each tile's weights quantized from its own scores, as the
kernel does), the mask taken from the integers only where a tile reaches
the tail [prefix, ctx), and the partials merged in chunk order, a chunk in
which a row attends nothing skipped. The rows r * G + g of a KV head go in
groups of 64, as the kernel's four 16-row warp tiles take them; a row's
arithmetic does not depend on its group. The model must equal
tree_attention_plain within 1e-5 (fp32 rounding of a different summation
order) over the fp cache and the int8 pair in both modes, at the edges the
kernel has to handle: steps 0 and K-1, hit and miss fan-out lists, a ghost
row with a negative prefix and a table of -1 entries, a context ending
exactly on a chunk boundary, a tail straddling two chunks, a context past a
full table, MQ 5 and 10, and R = MQ * G = 80 rows (two row groups). The fp
cache and the "int8" mode are also held to ssd_tpu's jnp oracle, and one
hd-64 int8 case to its Pallas tree_attention_v3 in interpret mode; the
int8_mxu mode only to the port's plain version, since the TPU quantizes p
per chunk of its grid and not per 64-position tile.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssd_tpu.ops import attention as jatt
from ssd_tpu.ops import pallas_attention as patt
from ssd_tpu_torch.bench import kernel_diag
from ssd_tpu_torch.ops import attention as att
from tests.test_torch_paged_split import quant_layer
from tests.torch_cases import tree_case


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
TILE = att.TREE_S8_TILE
BS = 16


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **TOL)


def _exp(x):
    """exp in fp64, rounded to fp32 once: an fp32 torch.exp on the CPU was
    seen to come out up to 1.8e-4 off on the first call of a process (see
    ops/attention.py::masked_softmax), and the model must repeat."""
    return torch.exp(x.double()).float()


def tree_split_model(q, kv_layer, block_tables, context_lens, fan_idx_rows, step, K,
                     block_size, scale, s8=False, chunk=None):
    """The kernels' split on CPU tensors (module docstring); returns
    (out [B, MQ, Hq, hd] f32, live chunks per sequence)."""
    quant = isinstance(kv_layer, tuple)
    data = kv_layer[0] if quant else kv_layer
    B, MQ, Hq, hd = q.shape
    Hkv = data.shape[0]
    G, R = Hq // Hkv, MQ * (Hq // Hkv)
    chunk = chunk or att.TREE_CHUNK[(hd, quant)]
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
    qr = q.float().reshape(B, MQ, Hkv, G, hd).permute(0, 2, 1, 3, 4).reshape(B, Hkv, R, hd)
    ctx = context_lens.long()
    n_pos = ctx.clamp(min=0, max=C)
    prefix = ctx - (K + 1) - (step + 1) * MQ
    full_end = torch.minimum(prefix, n_pos).clamp(min=0)                  # [B]
    # The mask from the integers: below full_end every row attends; from
    # there on a row attends its glue ancestors and its own tree column.
    pos = torch.arange(Cp)[None, None, :]
    tree_row = (torch.arange(R) // G)[None, :, None]                       # [1, R, 1]
    fan = fan_idx_rows.long()[:, torch.arange(R) // G][:, :, None]         # [B, R, 1]
    glue = pos - prefix[:, None, None]
    tt = glue - (K + 1)
    tail = (glue >= 0) & ((glue <= fan) | ((tt >= 0) & (tt < (step + 1) * MQ)
                                           & (torch.remainder(tt, MQ) == tree_row)))
    attend = (pos < full_end[:, None, None]) | ((pos < n_pos[:, None, None]) & tail)  # [B, R, Cp]
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
    out = torch.zeros(B, Hkv, R, hd)
    for r0 in range(0, R, 64):   # the kernel's row groups
        rows = slice(r0, min(r0 + 64, R))
        nr = rows.stop - r0
        ms, ls, accs = [], [], []
        for c in range(n_chunks):
            m = torch.full((B, Hkv, nr), float("-inf"))
            l = torch.zeros(B, Hkv, nr)
            acc = torch.zeros(B, Hkv, nr, hd)
            for t0 in range(c * chunk, (c + 1) * chunk, TILE):
                sl = slice(t0, t0 + TILE)
                ok = attend[:, None, rows, sl]                              # [B, 1, nr, T]
                s = torch.where(ok, scores[:, :, rows, sl], neg)
                vt = v[:, :, sl]
                if s8:
                    tmax = s.amax(dim=-1)
                    m_new = torch.maximum(m, tmax)
                    # fp32, as the plain version computes the e it quantizes
                    e = torch.where(ok, torch.exp(s - torch.where(tmax.isfinite(), tmax, 0.0)[..., None]), 0.0)
                    pq = e * sv[:, :, None, sl]
                    ps = pq.amax(dim=-1).clamp(min=1e-30) * np.float32(1 / 127)
                    p8 = torch.round(pq / ps[..., None])
                    alpha = torch.where(m.isfinite(), _exp(m - torch.where(m_new.isfinite(), m_new, 0.0)), 0.0)
                    cf = torch.where(tmax.isfinite(), _exp(tmax - torch.where(m_new.isfinite(), m_new, 0.0)), 0.0)
                    l = l * alpha + cf * e.sum(dim=-1)
                    acc = acc * alpha[..., None] + torch.einsum("bhrt,bhtd->bhrd", p8, vt) * (cf * ps)[..., None]
                else:
                    m_new = torch.maximum(m, s.amax(dim=-1))
                    p = torch.where(ok, _exp(s - torch.where(m_new.isfinite(), m_new, 0.0)[..., None]), 0.0)
                    alpha = torch.where(m.isfinite(), _exp(m - torch.where(m_new.isfinite(), m_new, 0.0)), 0.0)
                    l = l * alpha + p.sum(dim=-1)
                    w = p * sv[:, :, None, sl] if quant else p
                    acc = acc * alpha[..., None] + torch.einsum("bhrt,bhtd->bhrd", w, vt)
                m = m_new
            ms.append(m)
            ls.append(l)
            accs.append(acc)
        # Merge in chunk order; a chunk where a row attends nothing is skipped.
        mx = torch.stack(ms).amax(dim=0)
        L = torch.zeros(B, Hkv, nr)
        A = torch.zeros(B, Hkv, nr, hd)
        for m, l, acc in zip(ms, ls, accs):
            live = m.isfinite()
            f = torch.where(live, _exp(m - torch.where(live, mx, 0.0)), 0.0)
            L = L + l * f
            A = A + acc * f[..., None]
        out[:, :, rows] = torch.where(L[..., None] > 0, A / L.clamp(min=1e-30)[..., None], 0.0)
    out = out.reshape(B, Hkv, MQ, G, hd).permute(0, 2, 1, 3, 4).reshape(B, MQ, Hq, hd)
    return out, -(-n_pos // chunk)


# name -> (B, K, fan-out list, Hq, Hkv, hd, M (None: enough pages), bases,
# step, ghost rows); a base (k, off) is k chunks of the kernel's
# TREE_CHUNK plus off positions, and a sequence's context is base + (K+1)
# + (step+1) * MQ, so its tail is [base, ctx). Odd sequences take the miss
# list (the hit list reversed).
CASES = {
    "step0_ghost_minus1_table": (3, 4, [2] * 5, 8, 2, 64, None, [(1, 22), (0, 40)], 0, 1),
    "last_step_miss_list": (2, 4, [3, 3, 2, 1, 1], 8, 2, 64, None, [(1, 2), (0, 7)], 3, 0),
    "ctx_on_chunk_boundary": (2, 4, [2] * 5, 8, 2, 64, None, [(1, -25), (2, -25)], 1, 0),
    "tail_straddles_chunks": (2, 4, [2] * 5, 8, 2, 64, None, [(1, -28), (2, -16)], 3, 0),
    "ctx_past_full_table": (2, 4, [2] * 5, 8, 2, 64, 4, [(0, 80), (0, 20)], 1, 0),  # table holds 64
    "mq5": (2, 4, [1] * 5, 8, 2, 64, None, [(0, 90), (0, 10)], 2, 0),
    "r80_two_row_groups": (3, 4, [2] * 5, 16, 2, 64, None, [(1, 22), (0, 33)], 2, 1),
    "hd128_two_chunks": (2, 4, [2] * 5, 8, 2, 128, None, [(1, 72), (0, 60)], 3, 0),
}


def _case(name, seed, kind="fp"):
    B, K, fans, Hq, Hkv, hd, M, bases, step, ghosts = CASES[name]
    chunk = att.TREE_CHUNK[(hd, kind != "fp")]
    bases = [k * chunk + off for k, off in bases]
    M = M or -(-(2 * chunk + 64) // BS)
    q, kv, bt, ctx, fan = tree_case(seed, B, K, fans, Hq, Hkv, hd, BS, M, bases, step, ghosts)
    return q, kv, bt, ctx, fan, step, K


def _layer(kv, kind):
    return t(kv) if kind == "fp" else tuple(t(a) for a in quant_layer(kv))


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("kind", ["fp", "int8", "int8_mxu"])
def test_tree_split_model_matches_plain(name, kind):
    """The kernel's algorithm equals the port's plain version (fp32, 1e-5)."""
    q, kv, bt, ctx, fan, step, K = _case(name, 400 + list(CASES).index(name), kind)
    hd = q.shape[-1]
    args = (t(q), _layer(kv, kind), t(bt), t(ctx), t(fan), step, K, BS, hd ** -0.5)
    got, live = tree_split_model(*args, s8=kind == "int8_mxu")
    want = att.tree_attention_plain(*args, s8=kind == "int8_mxu")
    close(got, want)
    assert torch.isfinite(got).all()
    if name in ("step0_ghost_minus1_table", "tail_straddles_chunks", "r80_two_row_groups",
                "hd128_two_chunks"):
        assert live.max() >= 2   # several chunks are merged
    if name == "ctx_on_chunk_boundary":
        assert live.tolist() == [1, 2]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("kind", ["fp", "int8"])
def test_tree_split_model_matches_jax_oracle(name, kind):
    """The fp cache and the "int8" mode against ssd_tpu's jnp oracle."""
    q, kv, bt, ctx, fan, step, K = _case(name, 500 + list(CASES).index(name), kind)
    layer = kv if kind == "fp" else quant_layer(kv)
    tl = t(layer) if kind == "fp" else tuple(t(a) for a in layer)
    jl = jnp.asarray(layer) if kind == "fp" else tuple(jnp.asarray(a) for a in layer)
    scale = q.shape[-1] ** -0.5
    got, _ = tree_split_model(t(q), tl, t(bt), t(ctx), t(fan), step, K, BS, scale)
    want = jatt.tree_attention(q, jl, bt, ctx, fan, step, K, BS, bt.shape[1] * BS, scale)
    close(got, want)


def test_tree_split_model_matches_pallas_v3():
    """One hd-64 int8 tree step (two chunks, a ghost row with a -1 table)
    against the Pallas tree_attention_v3 kernel in interpret mode (its live
    rows)."""
    q, kv, bt, ctx, fan, step, K = _case("step0_ghost_minus1_table", 600, "int8")
    layer = quant_layer(kv)
    scale = 64 ** -0.5
    got, live = tree_split_model(t(q), tuple(t(a) for a in layer), t(bt), t(ctx), t(fan),
                                 step, K, BS, scale)
    assert live[0] == 2
    want = patt.tree_attention_v3(q, tuple(jnp.asarray(a) for a in layer), bt, ctx, fan,
                                  jnp.int32(step), K, BS, bt.shape[1] * BS, scale,
                                  seqs_per_step=2, interpret=True)
    close(got[:2], np.asarray(want)[:2])


def test_tree_chunk_rule():
    """Every tree chunk length is a whole number of the kernels' 64-position
    tiles (TREE_S8_TILE) and at most their 512 positions, and the chunk of
    every cache mode and q dtype fits one block's shared memory; the rule
    covers every head dim the kernels take (each even hd in [16, 256]) and
    both caches."""
    assert set(att.TREE_CHUNK) == {(hd, q8) for hd in range(16, 257, 2) for q8 in (False, True)}
    for (hd, q8), chunk in att.TREE_CHUNK.items():
        assert chunk % att.TREE_S8_TILE == 0 and 0 < chunk <= att.SPLIT_MAX_SPAN
        assert all(att.tree_smem_bytes(hd, kind, qb, chunk) <= att.SMEM_MAX
                   for kind in ((1, 2) if q8 else (0,)) for qb in (2, 4))


def test_kernel_diag_tree_case():
    """The tree step that `kernel_diag --tree` times: the last step of K=4 at
    fan-out 2 (MQ 10) over the given prefixes, whose plain output the model
    repeats."""
    q, layer, bt, ctx, fan, step, K = kernel_diag.tree_case(8, 2, 64, 16, [40, 300],
                                                            torch.float32, device="cpu")
    assert (step, K, q.shape[1]) == (3, 4, 10) and ctx.tolist() == [85, 345]
    got, live = tree_split_model(q, layer, bt, ctx, fan, step, K, 16, 0.125)
    close(got, att.tree_attention_plain(q, layer, bt, ctx, fan, step, K, 16, 0.125))
    assert live.tolist() == [1, -(-345 // att.TREE_CHUNK[(64, False)])]
