"""The training step's raster settings against the JAX package, on the
CPU: `render_frame`'s loss terms and every parameter leaf's gradient
under the ActorsHQ actor's settings (`configs/actorshq_actor02.yml`:
raster_backend pallas_blend, raster_opts {coarse: dupsort_tile, dup: 4})
with `BLEND_LAYOUT` "rec" in both packages, the image-layout blend (K7)
and its backward, summed per Gaussian by the combine (K4) in the port and
by the gather's scatter-add in the JAX package; and how the model
config's raster settings map to `rasterize_tiled` keywords.

The small synthetic avatar of tests/test_torch_train.py (2 garments x
150 Gaussians, 64x48 px, K 128), its weights the port's own
initialization carried across; the JAX step compiled at XLA's
optimization level 0 with the Pallas kernels in interpret mode, its K7
one tile a program (`pallas_blend_rec.IMG_G_CAP` = 1, the D3GA_IMG_G
setting; 8 by default): the same per-tile math, a shorter trace.
Tolerances as there: loss terms rtol 1e-5, each leaf's gradient relative
L2 <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3ga_tpu.data.synthetic as jsyn
import d3ga_tpu.raster.tiles as jtiles
from d3ga_tpu.raster import pallas_blend_rec as jbrec
from d3ga_tpu.train.step import LossWeights as JLossWeights
from d3ga_tpu.train.step import render_frame as j_render_frame
from d3ga_tpu.train.step import total_loss as j_total_loss
from d3ga_tpu_torch import convert
from d3ga_tpu_torch.data import synthetic as tsyn
from d3ga_tpu_torch.model.avatar import init_avatar
from d3ga_tpu_torch.raster import tiles as ttiles
from d3ga_tpu_torch.train import step as tstep
from d3ga_tpu_torch.train.optim import lr_tree_from_config, make_optimizer
from d3ga_tpu_torch.utils.tree import tree_leaves
from test_torch_train import rel_l2
from torch_parity import jit_o0, port_model

W, H, K = 64, 48, 128
ACTORSHQ = {"raster_backend": "pallas_blend", "raster_opts": {"coarse": "dupsort_tile", "dup": 4}}


def test_render_frame_actorshq_settings_match_jax(monkeypatch):
    monkeypatch.setattr(jtiles, "BLEND_LAYOUT", "rec")
    monkeypatch.setattr(ttiles, "BLEND_LAYOUT", "rec")
    monkeypatch.setattr(jbrec, "IMG_G_CAP", 1)
    jmodel, _, lbs_dim = jsyn.build_synthetic_avatar(
        n_garments=2, n_gaussians=150, config_overrides=ACTORSHQ)
    tmodel = port_model(jmodel, 2, config_overrides=ACTORSHQ)
    tparams = init_avatar(torch.Generator().manual_seed(0), tmodel)
    jparams = jax.tree_util.tree_map(jnp.asarray, convert.params_to_numpy(tparams))
    rng = np.random.default_rng(8)
    data = {
        "lbs": (rng.normal(size=lbs_dim) * 0.1).astype(np.float32),
        "image": rng.uniform(size=(3, H, W)).astype(np.float32),
        "alpha": (rng.uniform(size=(1, H, W)) > 0.3).astype(np.float32),
        "silhouette": np.full((3, H, W), 0.5, np.float32),
    }
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    jbatch.update(camera=jsyn.orbit_camera(0.3, W, H), frame_idx=jnp.int32(0),
                  camera_idx=jnp.int32(0))
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    tbatch.update(camera=tsyn.orbit_camera(0.3, W, H, device="cpu"), frame_idx=0, camera_idx=0)

    def jloss(params, key):
        terms, aux = j_render_frame(params, jmodel, jbatch, key, max_per_tile=K,
                                    loss_weights=JLossWeights(enable_vgg_from=0))
        return j_total_loss(terms), (terms, aux["raster_overflow"])

    key = jax.random.PRNGKey(3)
    (_, (jterms, j_overflow)), jgrads = jit_o0(
        jax.value_and_grad(jloss, has_aux=True), jparams, key)(jparams, key)

    tx = make_optimizer(tparams, lr_tree_from_config(tparams))
    step = tstep.make_train_step(tmodel, tx, max_per_tile=K,
                                 loss_weights=tstep.LossWeights(enable_vgg_from=0))
    bg = torch.from_numpy(np.asarray(jax.random.uniform(key, (3,))))
    _, terms, aux, grads = step.loss_and_grads(tparams, tbatch, bg, 0)
    assert set(terms) == set(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(float(terms[k].detach()), float(v), rtol=1e-5, err_msg=k)
    assert int(aux["raster_overflow"]) == int(j_overflow)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads) == len(tree_leaves(tparams))
    for i, (t, j) in enumerate(zip(grads, jleaves)):
        assert rel_l2(t, j) <= 1e-4, (i, t.shape, rel_l2(t, j))


def test_raster_opts_map_to_rasterize_tiled():
    """raster_backend and raster_opts as the JAX package reads them: the
    xla default takes the XLA blend with rasterize_tiled's own defaults,
    pallas_blend the kernels with the given funnel; fused takes
    rasterize_tiled_fused and ignores raster_opts; an option
    rasterize_tiled does not take is refused."""
    assert tstep._raster_opts({}) == {"use_pallas": False}
    assert tstep._raster_opts(ACTORSHQ) == {"coarse": "dupsort_tile", "dup": 4,
                                            "use_pallas": True}
    full = {"coarse": "dupsort", "dup": 3, "depth_exact": False, "block_cap": 512,
            "sub_block": 4, "sub_cap": 256, "super_factor": 2}
    assert tstep._raster_opts({"raster_backend": "xla", "raster_opts": full}) == dict(
        full, use_pallas=False)
    fused = {"raster_backend": "fused", "raster_opts": {"max_per_tile": 64}}
    assert tstep._raster_opts(fused) == {}
    assert tstep._rasterizer(fused) == (ttiles.rasterize_tiled_fused, {})
    assert tstep._rasterizer(ACTORSHQ)[0] is ttiles.rasterize_tiled
    with pytest.raises(ValueError, match="max_per_tile"):
        tstep._raster_opts({"raster_opts": {"max_per_tile": 64}})
    with pytest.raises(ValueError, match="raster_backend"):
        tstep._raster_opts({"raster_backend": "cuda"})
