"""Parity of the port's selection funnels and XLA blend with the JAX
package, on the CPU: `_select_per_tile` (topk with and without
superblocks, the sub-block level, dupsort, dupsort_tile) and
`_blend_tiles`. tests/test_torch_raster_paths.py holds `rasterize_tiled`
end to end.

Ranks, counts and every overflow count must be exactly equal.
`_blend_tiles` is the same float32 formula in both packages, summed in
another order by another matrix library: images atol 1e-5; gradients
rtol 1e-3 with atol 1e-6 of each leaf's largest value. Each JAX
computation is compiled at XLA's optimization level 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3ga_tpu.raster.tiles as jtiles
from d3ga_tpu_torch.raster import tiles as ttiles
from test_torch_raster_bwd import rel_close
from torch_parity import jit_o0

# tests/test_raster.py::TestTiledMatchesOracle::test_funnel_variants_match's
# ten configurations, dupsort_tile at dup 4, and caps that overflow
FUNNELS = [
    dict(super_factor=1),
    dict(super_factor=1, sub_block=4, sub_cap=256),
    dict(super_factor=2, sub_block=4, sub_cap=256),
    dict(super_factor=2, sub_block=2, sub_cap=256),
    dict(block_cap=512, super_factor=2, sub_block=4, sub_cap=256),
    dict(coarse="dupsort"),
    dict(coarse="dupsort", dup=3),
    dict(coarse="dupsort", sub_block=4, sub_cap=256),
    dict(coarse="dupsort_tile"),
    dict(coarse="dupsort_tile", dup=2),
    dict(coarse="dupsort_tile", dup=4),
    dict(block_cap=96, super_factor=2, sub_block=4, sub_cap=40),
    dict(coarse="dupsort", block_cap=80, sub_block=4, sub_cap=40),
]


@pytest.fixture(scope="module")
def funnel_inputs():
    """600 rank-ordered tile rects on a 16x12 grid, 1-5 tiles a side (past
    dup 2-4 windows), a third of them in a hotspot that overfills the
    caps, and 5% invalid."""
    rng = np.random.default_rng(3)
    n, ntx, nty = 600, 16, 12
    x0 = rng.integers(0, ntx, n)
    y0 = rng.integers(0, nty, n)
    x0[: n // 3] = rng.integers(4, 7, n // 3)
    y0[: n // 3] = rng.integers(4, 7, n // 3)
    x1 = np.minimum(x0 + rng.integers(1, 6, n), ntx)
    y1 = np.minimum(y0 + rng.integers(1, 6, n), nty)
    rects = [a.astype(np.int32) for a in (x0, x1, y0, y1)]
    return rects, rng.uniform(size=n) > 0.05, ntx, nty


@pytest.mark.parametrize("kw", FUNNELS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_select_per_tile_matches_jax(funnel_inputs, kw):
    rects, valid, ntx, nty = funnel_inputs
    K = 64
    args = (tuple(jnp.asarray(r) for r in rects), jnp.asarray(valid))
    j = jit_o0(lambda r, v: jtiles._select_per_tile(r, v, ntx, nty, K, **kw), *args)(*args)
    t = ttiles._select_per_tile(
        tuple(torch.from_numpy(r) for r in rects), torch.from_numpy(valid), ntx, nty, K, **kw)
    for a, b in zip(t, j):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy(), np.asarray(b))
    small_caps = kw.get("block_cap", 4096) < 100
    if small_caps or kw.get("coarse") == "dupsort_tile":
        assert int(j[2]) > 0  # the small caps, or the tile span clamps, dropped entries
    if not small_caps:
        assert int(j[1].max()) > K  # tiles over the cap


def blend_tiles_inputs(seed, ntx=3, nty=2, K=64, n=200, c=4):
    """Per-tile gathered records for `_blend_tiles`: tile-global centres
    around the grid, conics of 2-10 px sigmas, live slots a prefix of
    random length (empty, partial and full tiles), a quarter opaque."""
    rng = np.random.default_rng(seed)
    T = ntx * nty
    xy = rng.uniform(-8, 16 * np.array([ntx, nty]) + 8, (n, 2))
    s = rng.uniform(2.0, 10.0, (n, 2))
    th = rng.uniform(0, np.pi, n)
    R = np.stack([np.cos(th), -np.sin(th), np.sin(th), np.cos(th)], -1).reshape(n, 2, 2)
    inv = np.linalg.inv(R @ (np.eye(2) * (s**2)[:, None, :]) @ np.swapaxes(R, -1, -2))
    conic = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1)
    opac = rng.uniform(0.5, 0.999, n)
    opac[::4] = 1.0
    colors = rng.uniform(0, 1, (n, c))
    counts = rng.integers(0, K + 1, T)
    counts[0], counts[1] = 0, K
    ids = np.stack([rng.choice(n, K, replace=False) for _ in range(T)])
    live = np.arange(K)[None] < counts[:, None]
    tids = np.arange(T)
    origin = np.stack([(tids % ntx) * 16, (tids // ntx) * 16], -1).astype(np.int32)
    f = np.float32
    return (xy[ids].astype(f), conic[ids].astype(f), colors[ids].astype(f), opac[ids].astype(f),
            live, rng.uniform(0, 1, c).astype(f), origin)


def test_blend_tiles_matches_jax():
    xy, conic, color, opac, live, bg, origin = blend_tiles_inputs(4)
    g = np.random.default_rng(5).normal(size=(6, 256, 5)).astype(np.float32)

    def fwd_bwd(x, cn, cl, o, gg):
        out, vjp = jax.vjp(
            lambda *a: jtiles._blend_tiles(*a[:4], jnp.asarray(live), jnp.asarray(bg),
                                           jnp.asarray(origin)), x, cn, cl, o)
        return out, vjp(gg)

    args = tuple(jnp.asarray(a) for a in (xy, conic, color, opac, g))
    j_out, j_grads = jit_o0(fwd_bwd, *args)(*args)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (xy, conic, color, opac)]
    out = ttiles._blend_tiles(*leaves, torch.from_numpy(live), torch.from_numpy(bg),
                              torch.from_numpy(origin), blend_chunk=4)
    out.backward(torch.from_numpy(g))
    assert out.shape == (6, 256, 5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=1e-5)
    assert float(out[..., 4].detach().max()) > 1.0 - 1e-3  # pixels stopped at T < 1e-4
    for t, j in zip(leaves, j_grads):
        rel_close(t.grad.numpy(), np.asarray(j), rel=1e-6, rtol=1e-3)
