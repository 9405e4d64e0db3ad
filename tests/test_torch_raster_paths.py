"""Parity of the port's `rasterize_tiled` with the JAX package's, end to
end on the CPU, in three configurations: the default call (the topk
funnel and the XLA blend, `_blend_tiles`), and the dupsort_tile funnel at
dup 4 blended by the kernels in the ct layout (K2/K3) and in the rec
layout (K7), with `BLEND_LAYOUT` set alike in both packages. Image,
alpha, every RasterAux counter and the gradients of means, covariances,
opacities and colours.

Counters must be exactly equal. Floats, each with its reason:
- with the XLA blend: images and alpha atol 1e-5 (the same float32
  formula, summed in another order);
- with the kernels: images and alpha atol 1e-4 (the JAX kernels' bf16
  hi/lo split matmuls, ~2^-17 relative);
- gradients, after the projection's chain (terms up to 1e4: 1 / det of
  small footprints), within 2e-4 of each leaf's largest value, rtol 1e-3.

The JAX side's Pallas kernels run in interpret mode with the short
traces of tests/test_torch_raster_bwd.py (16 blend tiles a program), each
computation compiled at XLA's optimization level 0.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3ga_tpu.raster.tiles as jtiles
from d3ga_tpu.raster import pallas_blend_ct as jbct
from d3ga_tpu_torch.raster import blend_ct, blend_rec, extract, segsum
from d3ga_tpu_torch.raster import tiles as ttiles
from test_torch_raster import cameras, random_scene
from test_torch_raster_bwd import rel_close
from torch_parity import jit_o0

# (coarse, use_pallas, BLEND_LAYOUT); the first is the call with neither given
RASTER_CASES = [("topk", False, "ct"), ("dupsort_tile", True, "ct"), ("dupsort_tile", True, "rec")]
W, H, K, C = 64, 48, 128, 6


@pytest.fixture(scope="module")
def scene():
    """300 Gaussians on a 64x48 frame, a seventh fully opaque; a hotspot
    overfills K = 128 in a few tiles."""
    means, cov6, opac, colors = random_scene(6, 300, W, H)
    means[:120, :2] *= 0.15
    opac[::7] = 1.0
    return means, cov6, opac, colors


@pytest.mark.parametrize("coarse,use_pallas,layout", RASTER_CASES)
def test_rasterize_tiled_matches_jax(scene, monkeypatch, coarse, use_pallas, layout):
    monkeypatch.setattr(jtiles, "BLEND_LAYOUT", layout)
    monkeypatch.setattr(ttiles, "BLEND_LAYOUT", layout)
    monkeypatch.setattr(jbct, "G_CT", 16)
    # the default call is the topk funnel with the XLA blend in both packages
    kw = {} if coarse == "topk" else dict(coarse=coarse, dup=4, use_pallas=True)
    jcam, tcam = cameras(W, H)
    bg = np.linspace(0.2, 0.9, C).astype(np.float32)
    g_img = np.random.default_rng(1).normal(size=(C, H, W)).astype(np.float32)
    g_alpha = np.random.default_rng(2).normal(size=(H, W)).astype(np.float32)

    def jfwd(m, c, o, col):
        return jtiles.rasterize_tiled(m, jcam, jnp.asarray(bg), cov3d=c, opacities=o, colors=col,
                                      max_per_tile=K, return_alpha=True, **kw)

    def j_all(*leaves):
        def f(*a):
            img, alpha, aux = jfwd(*a)
            return (img, alpha), aux

        out, vjp, aux = jax.vjp(f, *leaves, has_aux=True)
        return out, aux, vjp((jnp.asarray(g_img), jnp.asarray(g_alpha)))

    args = tuple(jnp.asarray(a) for a in scene)
    (j_img, j_alpha), j_aux, j_grads = jit_o0(j_all, *args)(*args)

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in scene]
    counters = (extract.launches, blend_ct.launches, blend_ct.bwd_launches,
                blend_rec.img_launches, blend_rec.img_bwd_launches, segsum.launches)
    img, alpha, aux = ttiles.rasterize_tiled(
        leaves[0], tcam, torch.from_numpy(bg), cov3d=leaves[1], opacities=leaves[2],
        colors=leaves[3], max_per_tile=K, return_alpha=True, **kw)
    torch.autograd.backward((img, alpha), (torch.from_numpy(g_img), torch.from_numpy(g_alpha)))
    assert counters == (extract.launches, blend_ct.launches, blend_ct.bwd_launches,
                        blend_rec.img_launches, blend_rec.img_bwd_launches, segsum.launches)

    atol = 1e-4 if use_pallas else 1e-5
    assert img.shape == (C, H, W) and alpha.shape == (H, W)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(j_img), rtol=0, atol=atol)
    np.testing.assert_allclose(alpha.detach().numpy(), np.asarray(j_alpha), rtol=0, atol=atol)
    assert aux._fields == j_aux._fields
    for f in j_aux._fields:
        assert int(getattr(aux, f)) == int(getattr(j_aux, f)), f
    assert int(j_aux.overflow) > 0 and int(j_aux.depth_ties) == -1
    for t, j in zip(leaves, j_grads):
        assert bool(torch.isfinite(t.grad).all())
        rel_close(t.grad.numpy(), np.asarray(j), rel=2e-4, rtol=1e-3)


def test_defaults_match_jax():
    """The same call means the same thing in both packages: every keyword
    the port's rasterize_tiled shares with the JAX package's has the same
    default (coarse "topk", dup 2, use_pallas False, ...)."""
    jp = inspect.signature(jtiles.rasterize_tiled).parameters
    tp = inspect.signature(ttiles.rasterize_tiled).parameters
    shared = [k for k in tp if k in jp]
    assert set(tp) - set(shared) == {"plain"}
    assert set(jp) - set(shared) == {"pallas_interpret"}
    assert list(jp)[: len(shared)] == shared  # the same order, for positional callers
    for k in shared:
        assert tp[k].default == jp[k].default, k
    assert tp["coarse"].default == "topk" and tp["use_pallas"].default is False
    assert ttiles.BLEND_LAYOUT == jtiles.BLEND_LAYOUT == "ct"
