"""Parity of the port's spherical harmonics with the JAX package, on the
CPU: `rgb_to_sh` / `sh_to_rgb`, `rotate_sh` (bands 0-2 rotated, bands >= 3
passed through) at K 1, 4, 9 and 16 with one rotation and one a
Gaussian, and `rasterize_tiled` colouring from SH coefficients at degrees
0-3, image and every input's gradient.

Tolerances, each with its reason:
- the conversions: rtol 1e-6 (one multiply and one add in float32);
- `rotate_sh`: atol 2e-5 on unit-scale coefficients. Band 2's matrix
  inverts a 5 x 5 basis matrix in float32 (`jnp.linalg.inv` and
  `torch.linalg.inv` round apart, ~1e-6 relative at its condition number)
  and sums 5-term products in another order;
- the SH raster: image atol 1e-4 (the XLA blend's float32 sums in
  another order: on this scene the same call with precomputed colours
  differs by 2.4e-5, the SH colours themselves by 6e-8), each input's
  gradient rel L2 <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3ga_tpu.ops import sh as jsh
from d3ga_tpu.ops.quaternion import quat_to_matrix as j_quat_to_matrix
from d3ga_tpu.raster.tiles import rasterize_tiled as j_rasterize_tiled
from d3ga_tpu_torch.ops import sh as tsh
from d3ga_tpu_torch.raster.tiles import rasterize_tiled
from test_torch_raster import cameras, random_scene

W, H, N, K = 64, 48, 48, 64
ROT_ATOL, IMG_ATOL, GRAD_REL = 2e-5, 1e-4, 1e-4


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def rotations(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return np.asarray(j_quat_to_matrix(jnp.asarray(q / np.linalg.norm(q, axis=-1, keepdims=True))))


def test_rgb_sh_round_trip():
    rgb = np.random.default_rng(0).uniform(size=(20, 3)).astype(np.float32)
    t = tsh.rgb_to_sh(torch.from_numpy(rgb))
    np.testing.assert_allclose(t.numpy(), np.asarray(jsh.rgb_to_sh(rgb)), rtol=1e-6)
    np.testing.assert_allclose(tsh.sh_to_rgb(t).numpy(), np.asarray(jsh.sh_to_rgb(jnp.asarray(t))),
                               rtol=1e-6)


@pytest.mark.parametrize("per_gaussian", [False, True])
@pytest.mark.parametrize("k", [1, 4, 9, 16])
def test_rotate_sh_matches_jax(k, per_gaussian):
    n = 12
    sh = np.random.default_rng(k).normal(size=(n, k, 3)).astype(np.float32)
    R = np.array(rotations(n, 1) if per_gaussian else rotations(1, 2)[0])
    t = tsh.rotate_sh(torch.from_numpy(sh), torch.from_numpy(R)).numpy()
    j = np.asarray(jax.jit(jsh.rotate_sh)(jnp.asarray(sh), jnp.asarray(R)))
    assert t.shape == j.shape == sh.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=ROT_ATOL)
    # band 0 and the bands past 2 pass through unchanged
    assert np.array_equal(t[:, :1], sh[:, :1]) and np.array_equal(t[:, 9:], sh[:, 9:])
    if k > 1:  # a rotation keeps each band's norm
        for lo, hi in ((1, 4), (4, min(k, 9))):
            np.testing.assert_allclose(np.linalg.norm(t[:, lo:hi], axis=1),
                                       np.linalg.norm(sh[:, lo:hi], axis=1), rtol=1e-4)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_rasterize_tiled_sh_matches_jax(degree):
    """The first port test to colour the raster from SH: each Gaussian's
    colour is its SH coefficients evaluated along the view direction,
    +0.5, clamped at 0 (7, 26 and 32 of the 144 channels are at degrees
    1, 2 and 3, so the clamp's gradient mask counts)."""
    means, cov6, opac, _ = random_scene(3, N, W, H)
    shs = (np.random.default_rng(4).normal(size=(N, 16, 3)) * 0.6).astype(np.float32)
    cot = np.random.default_rng(5).normal(size=(3, H, W)).astype(np.float32)
    jcam, tcam = cameras(W, H)
    bg = np.array([0.1, 0.2, 0.3], np.float32)

    def jloss(m, c, o, s):
        img, _ = j_rasterize_tiled(m, jcam, jnp.asarray(bg), cov3d=c, opacities=o, shs=s,
                                   sh_degree=degree, max_per_tile=K)
        return jnp.sum(img * cot), img

    (_, jimg), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(
        *map(jnp.asarray, (means, cov6, opac, shs)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (means, cov6, opac, shs)]
    img, _ = rasterize_tiled(ins[0], tcam, torch.from_numpy(bg), cov3d=ins[1], opacities=ins[2],
                             shs=ins[3], sh_degree=degree, max_per_tile=K)
    tg = torch.autograd.grad(torch.sum(img * torch.from_numpy(cot)), ins)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), rtol=0, atol=IMG_ATOL)
    for name, t, j in zip(("means", "cov6", "opacities", "shs"), tg, jg):
        assert rel_l2(t, j) <= GRAD_REL, (name, rel_l2(t, j))
    # only the active degree's coefficients get a gradient
    assert np.all(tg[3].numpy()[:, (degree + 1) ** 2:] == 0)
    assert np.abs(tg[3].numpy()[:, : (degree + 1) ** 2]).max() > 0
