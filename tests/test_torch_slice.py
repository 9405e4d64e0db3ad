"""The whole serving slice against the JAX package, on the CPU: the
eval-mode avatar forward of a small synthetic avatar (2 garments, 300
Gaussians) into the champion raster forward (6 channels, 64x48 px,
K = 128, dup = 3, depth_exact), with weights and geometry carried across.

Images: atol 1e-4 (the JAX blend's bf16 hi/lo split matmuls, ~2^-17
relative); RasterAux: every counter equal.

The weights are the port's own initialization, carried across to the JAX
package, and the JAX blend runs 16 tiles a program (`pallas_blend_ct.G_CT`,
8 by default), which iterates the tiles in an in-kernel loop traced once
instead of an 8-way static unroll: the same per-tile math, half the
interpret-mode compile (tests/test_pallas_blend.py covers that path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3ga_tpu.data.synthetic as jsyn
from d3ga_tpu.model.avatar import avatar_forward as j_avatar_forward
from d3ga_tpu.raster import pallas_blend_ct as jbct
from d3ga_tpu.raster.tiles import rasterize_tiled as j_rasterize_tiled
from d3ga_tpu_torch.data import synthetic as tsyn
from d3ga_tpu_torch import convert
from d3ga_tpu_torch.model.avatar import avatar_forward, init_avatar
from d3ga_tpu_torch.raster import blend_ct, extract
from d3ga_tpu_torch.raster.tiles import rasterize_tiled
from torch_parity import port_model

W, H, K = 64, 48, 128
BG6 = np.array([1, 1, 1, 0, 0, 0], np.float32)
IMG_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def tile_loop():
    mp = pytest.MonkeyPatch()
    mp.setattr(jbct, "G_CT", 16)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def slice_pair():
    jmodel, _, lbs_dim = jsyn.build_synthetic_avatar(n_garments=2, n_gaussians=150)
    tmodel = port_model(jmodel, 2)
    tparams = init_avatar(torch.Generator().manual_seed(0), tmodel)
    jparams = jax.tree_util.tree_map(jnp.asarray, convert.params_to_numpy(tparams))
    jcam = jsyn.orbit_camera(0.3, W, H)

    @jax.jit
    def jax_frame(params, lbs):
        pkg = j_avatar_forward(
            params, jmodel,
            {"camera": jcam, "lbs": lbs, "frame_idx": jnp.int32(0), "camera_idx": jnp.int32(0)},
            training=False,
        )
        return j_rasterize_tiled(
            pkg["means3D"], jcam, jnp.asarray(BG6), cov3d=pkg["cov3D_precomp"],
            opacities=pkg["opacities"],
            colors=jnp.concatenate([pkg["rgb"], pkg["silhouette_rgb"]], -1),
            max_per_tile=K, use_pallas=True, coarse="dupsort_depth", dup=3,
        )

    tcam = tsyn.orbit_camera(0.3, W, H, device="cpu")

    def port_frame(lbs):
        with torch.no_grad():
            pkg = avatar_forward(
                tparams, tmodel, {"camera": tcam, "lbs": torch.from_numpy(lbs), "camera_idx": 0},
                training=False,
            )
            return rasterize_tiled(
                pkg["means3D"], tcam, torch.from_numpy(BG6), cov3d=pkg["cov3D_precomp"],
                opacities=pkg["opacities"],
                colors=torch.cat([pkg["rgb"], pkg["silhouette_rgb"]], -1),
                max_per_tile=K, use_pallas=True, coarse="dupsort_depth", dup=3,
            )

    return lambda lbs: jax_frame(jparams, jnp.asarray(lbs)), port_frame, lbs_dim


def pose(i, lbs_dim):
    """Frame i of a serving run: per-joint sinusoids around the rest pose."""
    return (0.05 * np.sin(i * 0.37 + np.arange(lbs_dim) * 0.61)).astype(np.float32)


@pytest.mark.parametrize("frame", [0, 7])
def test_slice_matches_jax(slice_pair, frame):
    jax_frame, port_frame, lbs_dim = slice_pair
    lbs = pose(frame, lbs_dim)
    jimg, jaux = jax_frame(lbs)
    before = (extract.launches, blend_ct.launches)
    timg, taux = port_frame(lbs)
    assert (extract.launches, blend_ct.launches) == before  # CPU: plain versions
    assert timg.shape == (6, H, W) and bool(torch.isfinite(timg).all())
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0, atol=IMG_ATOL)
    for f in jaux._fields:
        assert int(getattr(taux, f)) == int(getattr(jaux, f)), f
    # the scene overfills the K = 128 cap in some tiles
    assert int(jaux.overflow) > 0 and int(jaux.max_per_tile) > K
