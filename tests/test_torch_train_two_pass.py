"""`render_frame`'s two-pass branch against the JAX package, on the CPU:
an image pass and a silhouette pass (on a zero background) instead of
one fused 6-channel pass, taken where `detach_silhouette` names inputs
or the package has SH colours. Every loss term and every parameter
leaf's gradient, on a small synthetic avatar (1 garment x 64 Gaussians,
2 joints, 48 x 48 px, K 32); the port's weights carried to JAX (SH
coefficients moved off their near-constant init, so every band's
gradient is exercised).

- "none" (`detach_silhouette=("none",)`: two passes, nothing detached,
  as tests/test_e2e.py uses it), on the XLA blend;
- "detach": position, covariance and opacity detached in the silhouette
  pass (so only the image pass carries gradient), blended by the
  hand-written kernels' path (raster_backend pallas_blend, dupsort_depth,
  dup 3; the JAX kernels interpreted with tests/test_torch_train.py's
  short traces);
- "sh0", "sh2" (tests/test_torch_train_sh.py, which runs this file's
  case on them; two files, each under 20 s): SH colours (`use_shs`, max
  degree 2) evaluated at degree 0 and 2 in the image pass, on the XLA
  blend.

Tolerances: loss terms rel 1e-5 (float32 sums in another order); each
gradient leaf rel L2 <= 1e-3 (PERF.md section 2's gradient agreement).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3ga_tpu.data.synthetic as jsyn
from d3ga_tpu.raster import pallas_blend_ct as jbct
from d3ga_tpu.raster import pallas_segsum as jseg
from d3ga_tpu.train.step import LossWeights as JLossWeights
from d3ga_tpu.train.step import render_frame as j_render_frame
from d3ga_tpu.train.step import total_loss as j_total_loss
from d3ga_tpu_torch import convert
from d3ga_tpu_torch.data import synthetic as tsyn
from d3ga_tpu_torch.model.avatar import init_avatar
from d3ga_tpu_torch.train.optim import lr_tree_from_config, make_optimizer
from d3ga_tpu_torch.train.step import LossWeights, make_train_step
from d3ga_tpu_torch.utils.tree import tree_leaves
from torch_parity import jit_o0, port_model

W = H = 48
K = 32
FRAME_IDX, CAMERA_IDX = 1, 1
TERM_RTOL, GRAD_REL = 1e-5, 1e-3
PALLAS = {"raster_backend": "pallas_blend", "raster_opts": {"coarse": "dupsort_depth", "dup": 3}}
SH = {"use_shs": True, "max_sh_degree": 2}
# name: (config, detach_silhouette, sh_degree)
CASES = {
    "none": ({}, ("none",), 0),
    "detach": (PALLAS, ("position", "covariance", "opacity"), 0),
    "sh0": (SH, (), 0),
    "sh2": (SH, (), 2),
}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def avatar():
    """The JAX synthetic avatar and its port, built once; each case sets
    its config."""
    jmodel, _, lbs_dim = jsyn.build_synthetic_avatar(n_garments=1, n_gaussians=64, n_frames=4,
                                                     n_cameras=2, n_joints=2)
    return jmodel, port_model(jmodel, 1)._replace(cond_dim=jmodel.cond_dim), lbs_dim


@pytest.mark.parametrize("name", ["none", "detach"])
def test_render_frame_two_pass_matches_jax(name, avatar, monkeypatch):
    run_case(name, avatar, monkeypatch)


def run_case(name, avatar, monkeypatch):
    config, detach, degree = CASES[name]
    monkeypatch.setattr(jseg, "W", 1280)
    monkeypatch.setattr(jbct, "G_CT", 16)
    jbase, tbase, lbs_dim = avatar
    jmodel = jbase._replace(config=dict(jbase.config, **config))
    tmodel = tbase._replace(config=dict(tbase.config, **config))
    rng = np.random.default_rng(3)
    tparams = init_avatar(torch.Generator().manual_seed(0), tmodel)
    with torch.no_grad():
        for g in tparams["garments"].values():
            for key, scale in (("features_dc", 0.5), ("features_rest", 0.3)):
                if key in g:
                    g[key] += torch.from_numpy(rng.normal(0, scale, tuple(g[key].shape))
                                               .astype(np.float32))
    jparams = jax.tree_util.tree_map(jnp.asarray, convert.params_to_numpy(tparams))
    data = {
        "lbs": (rng.normal(size=lbs_dim) * 0.1).astype(np.float32),
        "image": rng.uniform(size=(3, H, W)).astype(np.float32),
        "alpha": (rng.uniform(size=(1, H, W)) > 0.3).astype(np.float32),
        "silhouette": np.full((3, H, W), 0.5, np.float32),
    }
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    jbatch.update(camera=jsyn.orbit_camera(0.4, W, H), frame_idx=jnp.int32(FRAME_IDX),
                  camera_idx=jnp.int32(CAMERA_IDX))
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    tbatch.update(camera=tsyn.orbit_camera(0.4, W, H, device="cpu"), frame_idx=FRAME_IDX,
                  camera_idx=CAMERA_IDX)
    key = jax.random.PRNGKey(7)

    def jloss(params):
        terms, _ = j_render_frame(params, jmodel, jbatch, key, max_per_tile=K,
                                  detach_silhouette=detach, sh_degree=degree,
                                  loss_weights=JLossWeights(enable_vgg_from=0))
        return j_total_loss(terms), terms

    (_, jterms), jgrads = jit_o0(jax.value_and_grad(jloss, has_aux=True), jparams)(jparams)
    tx = make_optimizer(tparams, lr_tree_from_config(tparams))
    step = make_train_step(tmodel, tx, max_per_tile=K, detach_silhouette=detach,
                           loss_weights=LossWeights(enable_vgg_from=0), sh_degree=degree)
    bg = torch.from_numpy(np.asarray(jax.random.uniform(key, (3,))))
    _, terms, aux, grads = step.loss_and_grads(tparams, tbatch, bg, 0)
    assert set(terms) == set(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(float(terms[k].detach()), float(v), rtol=TERM_RTOL,
                                   err_msg=k)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads) == len(tree_leaves(tparams))
    for i, (t, j) in enumerate(zip(grads, jleaves)):
        assert t.shape == j.shape and rel_l2(t, j) <= GRAD_REL, (i, t.shape, rel_l2(t, j))
    assert aux["pred_silhouette"].shape == aux["pred_image"].shape == (3, H, W)
    if name.startswith("sh"):
        g = tparams["garments"]["body"]
        by_id = {id(p): d for p, d in zip(tx.leaves, grads)}
        rest = by_id[id(g["features_rest"])]
        assert float(by_id[id(g["features_dc"])].abs().max()) > 0
        # only the active degree's bands get a gradient
        assert bool((rest[:, (degree + 1) ** 2 - 1:] == 0).all())
        assert (float(rest.abs().max()) > 0) == (degree > 0)
