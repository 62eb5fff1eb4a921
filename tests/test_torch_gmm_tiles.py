"""The algorithm of the grouped GEMM K6 (ssd_tpu_torch/csrc/grouped_gemm.cu),
written out in PyTorch and held to the port's plain version and to the JAX
package.

`row_tiles` repeats the kernel's device-side tile lookup (find_row_tile_at):
the row tiles of all experts numbered expert after expert, ceil(n_e / BM) of
them for expert e, within the static bound that sizes the grid
(ceil(N / BM) + min(E, N) on the bf16 routes, + E on the SIMT one). `grouped_gemm_model` runs each route's tiling on those tiles: the
prefill route's 128 x 256 output tiles and the decode route's 16-row tiles
of 64 columns, whose product it forms turned around (out^T = w^T . x^T), as
the kernel's wgmma does, and the fp32 SIMT route's 64 x 64 tiles. A tile
reads a full box of x rows from row0 (rows of the next expert, and zeros
past N, as TMA reads them) and K in 64-wide slices (16 for SIMT) with zeros
past K and past Nout, and stores only its group's rows and the columns
below Nout. The tests check the route rule, that every output element is
stored exactly once (empty groups, one-row groups, N below one tile, a
group spanning several tiles, a decode dispatch over 128 experts), that a
box runs past its group's end without storing there, and that the model
equals grouped_gemm_plain, jax.lax.ragged_dot and the megablox gmm Pallas
kernel (interpret mode) at fp32 within 1e-5 (summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu.megablox import gmm

from ssd_tpu_torch.ops import moe

TOL = dict(rtol=1e-5, atol=1e-5)
# route -> rows, columns and K slice of one tile
ROUTES = {"prefill": (128, 256, 64), "decode": (16, 64, 64), "simt": (64, 64, 16)}
r_ = np.random.default_rng(8)
_decode = np.zeros(128, np.int64)
_decode[r_.choice(128, 50, replace=False)] = 1
_decode[r_.choice(np.flatnonzero(_decode), 14, replace=False)] += 1
# name -> (group sizes, K, Nout)
CASES = {
    "empty_first_inner_last": ([0, 130, 1, 0, 64, 3, 0], 40, 200),
    "n_below_one_tile": ([5], 64, 72),
    "one_row_groups": ([0, 1, 0, 1, 1], 136, 8),
    "group_over_tiles": ([17, 0, 300, 2], 96, 136),
    "decode_128_experts": (list(_decode), 64, 72),
}


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **TOL)


def row_tiles(offs, route):
    """Tile number -> (expert, row0, row_end), or None past the last tile,
    for every tile number below the route's grid bound: ceil(N / bm) +
    min(E, N) on the bf16 routes (at most N groups hold a row), + E on
    the SIMT one."""
    bm = ROUTES[route][0]
    offs = [int(o) for o in offs]
    E, N = len(offs) - 1, offs[-1]
    n_tiles = [-(-(offs[e + 1] - offs[e]) // bm) for e in range(E)]
    start = np.concatenate([[0], np.cumsum(n_tiles)])
    out = []
    for target in range(-(-N // bm) + (E if route == "simt" else min(E, N))):
        e = int(np.searchsorted(start, target, side="right")) - 1
        if e >= E:
            out.append(None)
            continue
        row0 = offs[e] + (target - int(start[e])) * bm
        out.append((e, row0, min(row0 + bm, offs[e + 1])))
    return out


def grouped_gemm_model(x, w, offs, route):
    """The route's tiling (module docstring) on CPU tensors. Returns (out
    [N, Nout] in x's dtype, stores per output element, rows read past their
    tile's group)."""
    bm, bn, bk = ROUTES[route]
    N, K = x.shape
    E, _, Nout = w.shape
    Kp = -(-K // bk) * bk
    out = torch.full((N, Nout), float("nan"))
    stores = torch.zeros(N, Nout, dtype=torch.int64)
    past_end = 0
    for tile in row_tiles(offs, route):
        if tile is None:
            continue
        e, row0, row_end = tile
        n_in = min(row0 + bm, N) - row0
        xa = torch.zeros(bm, Kp)
        xa[:n_in, :K] = x[row0:row0 + n_in].float()
        past_end += n_in - (row_end - row0)
        for n0 in range(0, Nout, bn):
            ncols = min(bn, Nout - n0)
            wb = torch.zeros(Kp, bn)
            wb[:K, :ncols] = w[e, :, n0:n0 + ncols].float()
            acc = torch.zeros(bn, bm) if route == "decode" else torch.zeros(bm, bn)
            for k0 in range(0, Kp, bk):
                if route == "decode":
                    acc += wb[k0:k0 + bk].T @ xa[:, k0:k0 + bk].T
                else:
                    acc += xa[:, k0:k0 + bk] @ wb[k0:k0 + bk]
            if route == "decode":
                acc = acc.T
            out[row0:row_end, n0:n0 + ncols] = acc[:row_end - row0, :ncols]
            stores[row0:row_end, n0:n0 + ncols] += 1
    return out.to(x.dtype), stores, past_end


def _case(name, seed=0):
    sizes, K, Nout = CASES[name]
    r = np.random.default_rng(seed + len(sizes) + K)
    N, E = sum(sizes), len(sizes)
    x = r.normal(size=(N, K)).astype(np.float32)
    w = r.normal(size=(E, K, Nout)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return x, w, offs, sizes


def test_route_rule():
    """fp32 takes the SIMT kernel; bf16 the decode route up to
    GMM_DECODE_ROWS rows per expert on average (the b1 and b8 decode and
    SD/SSD verify dispatches of Qwen3-30B-A3B), the prefill route above."""
    E = 128
    assert moe.grouped_gemm_route(torch.float32, 8, E) == "simt"
    assert moe.grouped_gemm_route(torch.float32, 44272, E) == "simt"
    for n in (1, 8, 64, 8 * 5 * 8, moe.GMM_DECODE_ROWS * E):
        assert moe.grouped_gemm_route(torch.bfloat16, n, E) == "decode", n
    for n in (moe.GMM_DECODE_ROWS * E + 1, 5534 * 8):
        assert moe.grouped_gemm_route(torch.bfloat16, n, E) == "prefill", n
    assert moe.grouped_gemm_route(torch.bfloat16, 27, 4) == "prefill"


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", list(CASES))
def test_row_tiles_cover_each_row_once(name, route):
    """The tiles below the grid's bound cover [0, N) once, each inside one
    group, a group's tiles in row order, and every tile number past the last
    real one finds no tile (its block returns)."""
    bm = ROUTES[route][0]
    _, _, offs, sizes = _case(name)
    tiles = row_tiles(offs, route)
    real = [tl for tl in tiles if tl is not None]
    assert tiles[:len(real)] == real and len(real) == sum(-(-n // bm) for n in sizes)
    covered = np.zeros(int(offs[-1]), np.int64)
    for e, row0, row_end in real:
        assert offs[e] <= row0 < row_end <= offs[e + 1] and row_end - row0 <= bm
        covered[row0:row_end] += 1
    assert (covered == 1).all()
    assert [row0 for _, row0, _ in real] == sorted(row0 for _, row0, _ in real)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", list(CASES))
def test_gmm_model_matches_plain_and_jax(name, route):
    x, w, offs, sizes = _case(name, seed=1)
    got, stores, past_end = grouped_gemm_model(t(x), t(w), offs, route)
    assert (stores == 1).all()
    if name == "empty_first_inner_last":
        assert past_end > 0   # boxes ran into the next group's rows
    close(got, moe.grouped_gemm_plain(t(x), t(w), t(offs)))
    gs = jnp.asarray(sizes, jnp.int32)
    close(got, jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), gs))
    if name == "group_over_tiles" and route == "prefill":
        # megablox gmm needs N to be a multiple of its row tile: pad the last group.
        pad = -len(x) % 8
        xp = np.concatenate([x, np.zeros((pad, x.shape[1]), np.float32)])
        gp = jnp.asarray(sizes[:-1] + [sizes[-1] + pad], jnp.int32)
        want = gmm(jnp.asarray(xp), jnp.asarray(w), gp, tiling=(8, 8, 8), interpret=True)
        close(got, np.asarray(want)[:len(x)])


def test_gmm_model_rounds_once_in_bf16():
    """bf16 rows and experts: the model's fp32 sums rounded once, within one
    bf16 ulp (2^-7 |ref|) of the plain version's, on both bf16 routes."""
    x, w, offs, _ = _case("empty_first_inner_last", seed=2)
    xb, wb = t(x).to(torch.bfloat16), t(w).to(torch.bfloat16)
    want = moe.grouped_gemm_plain(xb, wb, t(offs)).float()
    for route in ("prefill", "decode"):
        got, _, _ = grouped_gemm_model(xb, wb, offs, route)
        assert got.dtype == torch.bfloat16
        assert ((got.float() - want).abs() <= 1e-4 + 2.0 ** -7 * want.abs()).all(), route
