"""The training step under `raster_backend: fused` against the JAX
package, on the CPU: `render_frame`'s loss terms and every parameter
leaf's gradient, the raster through `rasterize_tiled_fused` (K9's plain
versions in the port; in the JAX package its v1 kernel, the banded
one-hot compaction, in interpret mode), on the small synthetic avatar of
tests/test_torch_train.py (2 garments x 150 Gaussians, 64x48 px: one
8x8-tile block; K 128), its weights the port's own initialization carried
across, the JAX step compiled at XLA's optimization level 0. As in the
JAX package, the fused backend takes no `raster_opts` (the config below
gives one it would refuse elsewhere).

The JAX step's `rasterize_tiled_fused` is patched to variant 1, a
configuration the JAX package runs: its two kernels compute one function
(tests/test_torch_fused.py holds the port against each of them, and
tests/test_torch_fused_raster.py against the default v2 end to end), and
v1's interpret-mode run is a fraction of v2's butterfly at this width.

Tolerances as tests/test_torch_train_variants.py's: loss terms rtol 1e-5
(float32 sums over the image in another order), each leaf's gradient
relative L2 <= 1e-4 (threshold flips of the raster's rules can move one
pixel's share of a record's gradient).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import d3ga_tpu.data.synthetic as jsyn
import d3ga_tpu.raster.tiles as jtiles
from d3ga_tpu.train.step import LossWeights as JLossWeights
from d3ga_tpu.train.step import render_frame as j_render_frame
from d3ga_tpu.train.step import total_loss as j_total_loss
from d3ga_tpu_torch import convert
from d3ga_tpu_torch.data import synthetic as tsyn
from d3ga_tpu_torch.model.avatar import init_avatar
from d3ga_tpu_torch.raster import fused
from d3ga_tpu_torch.train import step as tstep
from d3ga_tpu_torch.train.optim import lr_tree_from_config, make_optimizer
from d3ga_tpu_torch.utils.tree import tree_leaves
from test_torch_train import rel_l2
from torch_parity import jit_o0, port_model

W, H, K = 64, 48, 128
FUSED = {"raster_backend": "fused", "raster_opts": {"coarse": "dupsort_tile", "max_per_tile": 1}}


def test_render_frame_fused_backend_matches_jax(monkeypatch):
    monkeypatch.setattr(jtiles, "rasterize_tiled_fused",
                        functools.partial(jtiles.rasterize_tiled_fused, variant=1))
    jmodel, _, lbs_dim = jsyn.build_synthetic_avatar(
        n_garments=2, n_gaussians=150, config_overrides=FUSED)
    tmodel = port_model(jmodel, 2, config_overrides=FUSED)
    tparams = init_avatar(torch.Generator().manual_seed(0), tmodel)
    jparams = jax.tree_util.tree_map(jnp.asarray, convert.params_to_numpy(tparams))
    rng = np.random.default_rng(9)
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

    key = jax.random.PRNGKey(4)
    (_, (jterms, j_overflow)), jgrads = jit_o0(
        jax.value_and_grad(jloss, has_aux=True), jparams, key)(jparams, key)

    tx = make_optimizer(tparams, lr_tree_from_config(tparams))
    step = tstep.make_train_step(tmodel, tx, max_per_tile=K,
                                 loss_weights=tstep.LossWeights(enable_vgg_from=0))
    bg = torch.from_numpy(np.asarray(jax.random.uniform(key, (3,))))
    before = (fused.launches, fused.bwd_launches)
    _, terms, aux, grads = step.loss_and_grads(tparams, tbatch, bg, 0)
    assert (fused.launches, fused.bwd_launches) == before  # the CPU runs the plain versions
    assert set(terms) == set(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(float(terms[k].detach()), float(v), rtol=1e-5, err_msg=k)
    assert int(aux["raster_overflow"]) == int(j_overflow)
    # the fused path computes only overflow, max_per_tile and n_contrib
    assert int(aux["raster_visible_overflow"]) == int(aux["raster_clamp_overflow"]) == -1
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads) == len(tree_leaves(tparams))
    for i, (t, j) in enumerate(zip(grads, jleaves)):
        assert rel_l2(t, j) <= 1e-4, (i, t.shape, rel_l2(t, j))
