"""Parity of the port's public rasterizer API and oracle with the JAX
package, on the CPU: `rasterize_oracle` (image and gradients),
`api.rasterize` with the backends tiled, pallas (ct and rec layouts) and
oracle, with packed covariances or scales + rotations and with colours
or SH coefficients, `render` with a crop and a detached input, `paste`
and `paste_from_canvas`.

Tolerances, each with its reason: images of the oracle and of the tiled
(XLA) blend atol 1e-5 (the same float32 formulas, summed in another
order); of the pallas backend atol 1e-4 (the JAX kernels' bf16 hi/lo
split matmuls, ~2^-17 relative); RasterAux counters exactly equal; the
oracle's gradients within 1e-5 of each leaf's largest value, rtol 1e-4
(float32 chains through the projection, terms up to 1e4). The port's own
backends agree with its oracle within 2e-5 where no cap overflows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3ga_tpu.raster.api as japi
import d3ga_tpu.raster.tiles as jtiles
from d3ga_tpu.raster import pallas_blend_ct as jbct
from d3ga_tpu.raster.oracle import rasterize_oracle as j_oracle
from d3ga_tpu.raster.camera import focal2fov, make_camera as j_make_camera
from d3ga_tpu_torch.raster import api as tapi
from d3ga_tpu_torch.raster import tiles as ttiles
from d3ga_tpu_torch.raster.camera import make_camera as t_make_camera
from d3ga_tpu_torch.raster.oracle import rasterize_oracle
from torch_parity import jit_o0

W, H = 80, 56  # not multiples of 16


def cameras():
    args = (np.eye(3), np.zeros(3), focal2fov(60.0, W), focal2fov(60.0, H), W, H)
    return j_make_camera(*args), t_make_camera(*args, device="cpu")


@pytest.fixture(scope="module")
def scene():
    """tests/test_raster.py's scene drawn with numpy: 120 Gaussians in
    front of the camera, scales + unit quaternions and their packed
    covariances, colours and degree-1 SH coefficients."""
    rng = np.random.default_rng(0)
    n = 120
    means = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)), rng.uniform(4.0, 6.0, (n, 1))], -1)
    scales = np.exp(rng.uniform(-3.5, -2.2, (n, 3)))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)
    L = R * scales[:, None, :]
    cov = L @ np.swapaxes(L, -1, -2)
    f = np.float32
    return {
        "means": means.astype(f),
        "scales": scales.astype(f),
        "rotations": q.astype(f),
        "cov3d": cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].astype(f),
        "opacities": rng.uniform(0.3, 0.95, (n, 1)).astype(f),
        "colors": rng.uniform(0, 1, (n, 3)).astype(f),
        "shs": rng.normal(0, 0.5, (n, 4, 3)).astype(f),
        "bg": np.array([0.1, 0.2, 0.3], f),
    }


def test_oracle_matches_jax(scene):
    jcam, tcam = cameras()
    names = ("means", "scales", "rotations", "opacities", "colors")
    g = np.random.default_rng(1).normal(size=(3, H, W)).astype(np.float32)

    def fwd_bwd(m, s, r, o, c, gg):
        out, vjp = jax.vjp(lambda *a: j_oracle(a[0], jcam, jnp.asarray(scene["bg"]), scales=a[1],
                                               rotations=a[2], opacities=a[3], colors=a[4],
                                               row_chunk=H), m, s, r, o, c)
        return out, vjp(gg)

    args = tuple(jnp.asarray(scene[k]) for k in names) + (jnp.asarray(g),)
    j_img, j_grads = jit_o0(fwd_bwd, *args)(*args)
    leaves = [torch.from_numpy(scene[k]).requires_grad_(True) for k in names]
    img = rasterize_oracle(leaves[0], tcam, torch.from_numpy(scene["bg"]), scales=leaves[1],
                           rotations=leaves[2], opacities=leaves[3], colors=leaves[4],
                           row_chunk=H)
    img.backward(torch.from_numpy(g))
    assert img.shape == (3, H, W)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(j_img), rtol=0, atol=1e-5)
    for t, j in zip(leaves, j_grads):
        j = np.asarray(j)
        np.testing.assert_allclose(t.grad.numpy(), j, rtol=1e-4, atol=1e-5 * np.abs(j).max())


# (backend, blend layout, covariance input, colour input)
API_CASES = [
    ("tiled", "ct", "cov3d", "colors"),
    ("pallas", "ct", "scales", "shs"),
    ("pallas", "rec", "cov3d", "colors"),
    ("oracle", "ct", "cov3d", "shs"),
]


@pytest.mark.parametrize("backend,layout,geom,colour", API_CASES)
def test_rasterize_matches_jax(scene, monkeypatch, backend, layout, geom, colour):
    monkeypatch.setattr(jtiles, "BLEND_LAYOUT", layout)
    monkeypatch.setattr(ttiles, "BLEND_LAYOUT", layout)
    monkeypatch.setattr(jbct, "G_CT", 16)
    jcam, tcam = cameras()
    geom_keys = ("cov3d",) if geom == "cov3d" else ("scales", "rotations")
    sh_degree = 1 if colour == "shs" else 0
    settings = dict(backend=backend, max_per_tile=128, sh_degree=sh_degree)

    def inputs(to):
        kw = {k: to(scene[k]) for k in geom_keys + (colour,)}
        return to(scene["means"]), to(scene["opacities"]), to(scene["bg"]), kw

    jm, jo, jbg, jkw = inputs(jnp.asarray)
    j_img, j_aux = jit_o0(
        lambda m, o, b, kw: japi.rasterize(jcam, m, o, b, settings=japi.RasterSettings(**settings),
                                           **kw), jm, jo, jbg, jkw)(jm, jo, jbg, jkw)
    tm, to, tbg, tkw = inputs(torch.from_numpy)
    img, aux = tapi.rasterize(tcam, tm, to, tbg, settings=tapi.RasterSettings(**settings), **tkw)
    np.testing.assert_allclose(img.numpy(), np.asarray(j_img), rtol=0,
                               atol=1e-4 if backend == "pallas" else 1e-5)
    if backend == "oracle":
        assert aux is None and j_aux is None
        return
    for f in j_aux._fields:
        assert int(getattr(aux, f)) == int(getattr(j_aux, f)), f
    assert int(aux.overflow) == 0
    ref, _ = tapi.rasterize(tcam, tm, to, tbg, settings=tapi.RasterSettings(
        backend="oracle", sh_degree=sh_degree), **tkw)
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=0, atol=2e-5)


def test_render_with_crop_matches_jax(scene):
    """`render` of a garment package with a crop and the position
    detached: the image as the JAX package's, no gradient to the means."""
    jcam, tcam = cameras()
    crop = [30.0, 50.0, 20.0, 36.0, 64, 40]
    pkg_keys = {"means3D": "means", "cov3D_precomp": "cov3d", "rgb": "colors",
                "opacities": "opacities"}
    jpkg = {k: jnp.asarray(scene[v]) for k, v in pkg_keys.items()}
    args = (jpkg, jnp.asarray(scene["bg"]))
    j = jit_o0(lambda p, b: japi.render({"camera": jcam, "crop": crop}, p, b,
                                        detach=("position",)), *args)(*args)
    tpkg = {k: torch.from_numpy(scene[v]).requires_grad_(True) for k, v in pkg_keys.items()}
    t = tapi.render({"camera": tcam, "crop": crop}, tpkg, torch.from_numpy(scene["bg"]),
                    detach=("position",))
    assert t["render"].shape == (3, 40, 64)
    np.testing.assert_allclose(t["render"].detach().numpy(), np.asarray(j["render"]), rtol=0,
                               atol=1e-5)
    for f in j["aux"]._fields:
        assert int(getattr(t["aux"], f)) == int(getattr(j["aux"], f)), f
    t["render"].sum().backward()
    assert tpkg["means3D"].grad is None and float(tpkg["rgb"].grad.abs().max()) > 0


@pytest.mark.parametrize("crop", [[30, 50, 20, 36, 64, 40], [50, 30, 36, 20, 70, 50],
                                  [10, 10, 5, 7, 12, 11]])
def test_paste_matches_jax(crop):
    img = np.random.default_rng(2).normal(size=(3, 56, 80)).astype(np.float32)
    t = torch.from_numpy(img)
    assert np.array_equal(tapi.paste(t, crop).numpy(), np.asarray(japi.paste(img, crop)))
    assert np.array_equal(tapi.paste_from_canvas(t, crop).numpy(),
                          np.asarray(japi.paste_from_canvas(img, crop)))


def test_rasterize_checks_inputs(scene):
    _, tcam = cameras()
    m, o, bg, cov, col = (torch.from_numpy(scene[k])
                          for k in ("means", "opacities", "bg", "cov3d", "colors"))
    with pytest.raises(ValueError, match="cov3d"):
        tapi.rasterize(tcam, m, o, bg, colors=col)
    with pytest.raises(ValueError, match="colors"):
        tapi.rasterize(tcam, m, o, bg, cov3d=cov)
    with pytest.raises(ValueError, match="unknown backend"):
        tapi.rasterize(tcam, m, o, bg, cov3d=cov, colors=col,
                       settings=tapi.RasterSettings(backend="cuda"))
