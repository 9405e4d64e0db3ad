"""Parity of the port's fused backend with the JAX package, on the CPU:
`rasterize_tiled_fused` (projection, depth argsort, the topk funnel's
block lists, then K9's plain versions) against the JAX function (its
default variant 2, the butterfly kernel, in interpret mode), forward and
backward, with 6 colour channels and `return_alpha`, at a 112 x 96 frame
(7 x 6 tiles: one 8x8-tile block, with tiles outside the image) and
K = 16, so the per-tile cap overflows; both of the port's variants. Then
`api.rasterize(backend="fused")`, and the fused path against
`rasterize_tiled`'s topk funnel with the XLA blend.

Tolerances, each with its reason: RasterAux counters exactly equal
(integer work). Image and alpha by their p999 absolute error (<= 1e-5)
and the share of pixels off by more than 1e-3 (<= 1e-3), as in
tests/test_torch_fused.py: the JAX kernel sums in another order and
threshold flips (T < 1e-4, alpha >= 1/255) can move a pixel. The
gradients wrt the Gaussian inputs, after the projection's chain (terms
up to 1e4: 1 / det of small footprints), as in
tests/test_torch_raster_paths.py: within 2e-4 of each leaf's largest
value, rtol 1e-3, and relative L2 <= 1e-4. The port's
two variants run one plain version: equal to the last bit. Against the
port's XLA blend on the same selection the image is held at atol 1e-5
(two float32 formulas of one blend); against its oracle at 2e-5 where
no cap overflows (tests/test_torch_api.py's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3ga_tpu.raster.tiles as jtiles
from d3ga_tpu_torch.raster import api as tapi
from d3ga_tpu_torch.raster import fused
from d3ga_tpu_torch.raster import tiles as ttiles
from d3ga_tpu_torch.raster.oracle import rasterize_oracle
from test_torch_api import cameras as api_cameras
from test_torch_api import scene  # noqa: F401  (the API scene fixture)
from test_torch_fused import image_close
from test_torch_raster import cameras, random_scene
from test_torch_raster_bwd import rel_close
from test_torch_train import rel_l2
from torch_parity import jit_o0

W, H, K, N = 112, 96, 16, 300
BG6 = np.array([0.2, 0.4, 0.6, 0.0, 0.0, 0.0], np.float32)
LEAVES = ("means", "cov6", "opac", "colors")


@pytest.fixture(scope="module")
def gaussians():
    means, cov6, opac, colors = random_scene(5, N, W, H)
    rng = np.random.default_rng(6)
    g_img = rng.normal(size=(6, H, W)).astype(np.float32)
    g_alpha = rng.normal(size=(H, W)).astype(np.float32)
    return dict(means=means, cov6=cov6, opac=opac, colors=colors, g_img=g_img, g_alpha=g_alpha)


@pytest.fixture(scope="module")
def jax_fused(gaussians):
    """The JAX rasterize_tiled_fused's image, alpha, counters and the
    gradients of <g_img, image> + <g_alpha, alpha>."""
    jcam, _ = cameras(W, H)
    ga = gaussians

    def fwd_bwd(m, c6, o, col, gi, gal):
        def f(*leaves):
            img, alpha, aux = jtiles.rasterize_tiled_fused(
                leaves[0], jcam, jnp.asarray(BG6), cov3d=leaves[1], opacities=leaves[2],
                colors=leaves[3], max_per_tile=K, return_alpha=True, interpret=True)
            return (img, alpha), aux

        (img, alpha), vjp, aux = jax.vjp(f, m, c6, o, col, has_aux=True)
        return img, alpha, aux, vjp((gi, gal))

    args = tuple(jnp.asarray(ga[k]) for k in LEAVES + ("g_img", "g_alpha"))
    img, alpha, aux, grads = jit_o0(fwd_bwd, *args)(*args)
    return dict(img=np.asarray(img), alpha=np.asarray(alpha),
                aux={f: int(getattr(aux, f)) for f in aux._fields},
                grads=[np.asarray(x) for x in grads])


def port_fused(ga, variant, **kw):
    _, tcam = cameras(W, H)
    leaves = [torch.from_numpy(ga[k]).requires_grad_(True) for k in LEAVES]
    img, alpha, aux = ttiles.rasterize_tiled_fused(
        leaves[0], tcam, torch.from_numpy(BG6), cov3d=leaves[1], opacities=leaves[2],
        colors=leaves[3], max_per_tile=K, return_alpha=True, variant=variant, **kw)
    torch.autograd.backward((img, alpha), (torch.from_numpy(ga["g_img"]),
                                           torch.from_numpy(ga["g_alpha"])))
    return img.detach(), alpha.detach(), aux, [t.grad for t in leaves]


@pytest.mark.parametrize("variant", [1, 2])
def test_rasterize_tiled_fused_matches_jax(gaussians, jax_fused, variant):
    before = (fused.launches, fused.bwd_launches)
    img, alpha, aux, grads = port_fused(gaussians, variant)
    assert (fused.launches, fused.bwd_launches) == before
    assert img.shape == (6, H, W) and alpha.shape == (H, W)
    image_close(img.numpy(), jax_fused["img"])
    image_close(alpha.numpy(), jax_fused["alpha"])
    assert {f: int(getattr(aux, f)) for f in aux._fields} == jax_fused["aux"]
    assert jax_fused["aux"]["overflow"] > 0  # the K cap is exercised
    for t, j in zip(grads, jax_fused["grads"]):
        assert rel_l2(t, j) <= 1e-4
        rel_close(t.numpy(), j, rel=2e-4, rtol=1e-3)


def test_variants_and_plain_flag_agree(gaussians):
    """Both layouts, and plain=True, run the same plain version on the CPU."""
    out1, out2 = port_fused(gaussians, 1), port_fused(gaussians, 2, plain=True)
    for a, b in zip(out1[:2] + tuple(out1[3]), out2[:2] + tuple(out2[3])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="variant"):
        port_fused(gaussians, 3)


def test_fused_is_the_topk_path(gaussians):
    """rasterize_tiled_fused against rasterize_tiled's topk funnel (block
    lists through 2x2 superblocks, as the fused path makes them) and XLA
    blend: counters equal, image within 1e-5."""
    _, tcam = cameras(W, H)
    ga = {k: torch.from_numpy(gaussians[k]) for k in LEAVES}
    kw = dict(cov3d=ga["cov6"], opacities=ga["opac"], colors=ga["colors"], max_per_tile=K)
    img_f, aux_f = ttiles.rasterize_tiled_fused(ga["means"], tcam, torch.from_numpy(BG6), **kw)
    img_t, aux_t = ttiles.rasterize_tiled(ga["means"], tcam, torch.from_numpy(BG6),
                                          coarse="topk", super_factor=2, **kw)
    np.testing.assert_allclose(img_f.detach().numpy(), img_t.detach().numpy(), rtol=0, atol=1e-5)
    for f in ("overflow", "max_per_tile", "n_contrib"):
        assert int(getattr(aux_f, f)) == int(getattr(aux_t, f)), f


def test_api_fused_backend(scene):  # noqa: F811
    """backend "fused" is rasterize_tiled_fused with the settings' K; it
    drops scale_modifier and antialiasing, as the JAX package does; it
    agrees with the oracle where no cap overflows."""
    _, tcam = api_cameras()
    t = {k: torch.from_numpy(v) for k, v in scene.items()}
    kw = dict(scales=t["scales"], rotations=t["rotations"], colors=t["colors"])
    img, aux = tapi.rasterize(tcam, t["means"], t["opacities"], t["bg"],
                              settings=tapi.RasterSettings(backend="fused", max_per_tile=128), **kw)
    ref, aux_ref = ttiles.rasterize_tiled_fused(t["means"], tcam, t["bg"], max_per_tile=128,
                                                opacities=t["opacities"], **kw)
    assert torch.equal(img, ref) and aux == aux_ref
    quirk = tapi.RasterSettings(backend="fused", max_per_tile=128, scale_modifier=2.0,
                                antialiasing=True)
    img_q, _ = tapi.rasterize(tcam, t["means"], t["opacities"], t["bg"], settings=quirk, **kw)
    assert torch.equal(img_q, img)
    assert int(aux.overflow) == 0
    oracle = rasterize_oracle(t["means"], tcam, t["bg"], opacities=t["opacities"], **kw)
    np.testing.assert_allclose(img.numpy(), oracle.numpy(), rtol=0, atol=2e-5)
