"""`render_frame` under the capture configs' training options against the
JAX package, on the CPU: every loss term and every parameter leaf's
gradient, on a small synthetic avatar (1 garment x 64 Gaussians, 2
joints, 48 x 48 px, K 32). Both packages start from JAX's `init_avatar` (perturbed where
its init is a constant, so each option's gradient is exercised),
carried across with `d3ga_tpu_torch.convert`. The JAX step draws its
background colour and its noise target's uniform draw from its rng; the
test computes those draws and hands them to the port.

- "goliath" (tests/test_torch_train_blur.py): `configs/goliath_axe184.yml`'s
  options: learnable blur on the hand-written kernels' path
  (raster_backend pallas_blend, dupsort_depth, dup 3), the JAX kernels
  interpreted (test_torch_train.py's short traces);
- "every" (this file): every new option at once, on the XLA blend:
  blur, the pixel bias, a bg net with enable_bg above the iteration (the
  noise target live), optimizable poses and global rotation /
  translation with the capture extrinsics `cam_rt` (the camera rebuilt
  in the graph), and the port's random VGG stack carried to the JAX
  package (an argument of its program, not a constant: ~5 s less
  compile) with enable_vgg_from 1 at iteration 2. At 48 x 48 no VGG
  crop is cut; tests/test_torch_vgg.py runs the crop.

Tolerances: loss terms rel 1e-5 (float32 sums in another order); each
gradient leaf rel L2 <= 1e-3 (PERF.md section 2's gradient agreement: the
camera rebuild's float32 4x4 inverses round apart between LAPACK builds,
~1e-7 relative, and the raster's threshold rules can move a pixel's
share under the two roundings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3ga_tpu.data.synthetic as jsyn
from d3ga_tpu.model.avatar import init_avatar as j_init_avatar
from d3ga_tpu.raster import pallas_blend_ct as jbct
from d3ga_tpu.raster import pallas_segsum as jseg
from d3ga_tpu.train.step import LossWeights as JLossWeights
from d3ga_tpu.train.step import render_frame as j_render_frame
from d3ga_tpu.train.step import total_loss as j_total_loss
from d3ga_tpu_torch import convert
from d3ga_tpu_torch.data import synthetic as tsyn
from d3ga_tpu_torch.train.optim import lr_tree_from_config, make_optimizer
from d3ga_tpu_torch.train.losses import init_vgg19_features
from d3ga_tpu_torch.train.step import LossWeights, make_train_step, needs_noise
from d3ga_tpu_torch.utils.tree import tree_leaves
from torch_parity import jit_o0, port_model

W = H = 48
K = 32
N_FRAMES, FRAME_IDX, CAMERA_IDX = 4, 1, 1
TERM_RTOL, GRAD_REL = 1e-5, 1e-3
SIZE = {"image_height": H, "image_width": W}
# name: (config, iteration, enable_vgg_from: 0 without the VGG term)
CONFIGS = {
    "goliath": ({"use_blur": True, "raster_backend": "pallas_blend",
                 "raster_opts": {"coarse": "dupsort_depth", "dup": 3}}, 0, 0),
    "every": ({"use_blur": True, "use_pixel_cal": True, "use_bg_network": True, "enable_bg": 5,
               "use_opt_smplx": True, **SIZE}, 2, 1),
}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def perturb(params, rng):
    """JAX params with the constant inits (blur weights, pixel bias, bg
    map) moved off their constants."""
    p = jax.tree_util.tree_map(np.asarray, params)
    for key, sub, scale in (("learnable_blur", "weights_raw", 0.3), ("pixel_cal", "bias", 0.05),
                            ("bg_net", "bg", 0.2)):
        if key in p:
            v = p[key][sub]
            p[key][sub] = (v + rng.normal(0, scale, v.shape)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def avatar():
    """The JAX synthetic avatar, built once; each case sets its config."""
    return jsyn.build_synthetic_avatar(n_garments=1, n_gaussians=64, n_frames=N_FRAMES,
                                       n_cameras=2, n_joints=2)


@pytest.fixture(scope="module", params=["every"])
def case(request, avatar):
    """This file holds the "every" config; tests/test_torch_train_blur.py
    runs the same tests on "goliath" (two files, each well under 20 s)."""
    yield from run_case(request.param, avatar)


def run_case(name, avatar):
    config, iteration, vgg_from = CONFIGS[name]
    mp = pytest.MonkeyPatch()
    mp.setattr(jseg, "W", 1280)
    mp.setattr(jbct, "G_CT", 16)
    base, _, lbs_dim = avatar
    jmodel = base._replace(config=dict(base.config, **config))
    rng = np.random.default_rng(3)
    opt = {}
    if config.get("use_opt_smplx"):
        opt = dict(init_smplx_poses=(rng.normal(size=(N_FRAMES, lbs_dim)) * 0.1).astype(np.float32),
                   init_smplx_rh=(rng.normal(size=(N_FRAMES, 3)) * 0.05).astype(np.float32),
                   init_smplx_th=(rng.normal(size=(N_FRAMES, 3)) * 0.05).astype(np.float32))
    # jitted: one compile instead of one per eager op
    jinit = jax.jit(lambda key, opt: j_init_avatar(key, jmodel, **opt))
    jp = perturb(jinit(jax.random.PRNGKey(0), opt), rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    tmodel = port_model(jmodel, 1, config_overrides=config)._replace(cond_dim=jmodel.cond_dim)
    tparams = convert.params_from_numpy(jp, device="cpu")
    data = {
        "lbs": (rng.normal(size=lbs_dim) * 0.1).astype(np.float32),
        "image": rng.uniform(size=(3, H, W)).astype(np.float32),
        "alpha": (rng.uniform(size=(1, H, W)) > 0.3).astype(np.float32),
        "silhouette": np.full((3, H, W), 0.5, np.float32),
    }
    jcam = jsyn.orbit_camera(0.4, W, H)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    jbatch.update(camera=jcam, frame_idx=jnp.int32(FRAME_IDX), camera_idx=jnp.int32(CAMERA_IDX))
    tbatch = {k: torch.from_numpy(v) for k, v in data.items()}
    tbatch.update(camera=tsyn.orbit_camera(0.4, W, H, device="cpu"), frame_idx=FRAME_IDX,
                  camera_idx=CAMERA_IDX)
    if config.get("use_opt_smplx"):
        jbatch["cam_rt"] = jcam.world_view
        tbatch["cam_rt"] = torch.from_numpy(np.asarray(jcam.world_view))
    key = jax.random.PRNGKey(7)
    tvgg = jvgg = None
    if vgg_from:
        tvgg = init_vgg19_features(torch.Generator().manual_seed(4), allow_random=True,
                                   device="cpu")
        jvgg = {"convs": jax.tree_util.tree_map(jnp.asarray,
                                                convert.params_to_numpy(tvgg["convs"]))}

    def jloss(params, vgg):
        terms, _ = j_render_frame(params, jmodel, jbatch, key, max_per_tile=K, vgg_params=vgg,
                                  loss_weights=JLossWeights(enable_vgg_from=vgg_from),
                                  iteration=iteration)
        return j_total_loss(terms), terms

    # the VGG stack an argument of the program, not a constant (~5 s less)
    (_, jterms), jgrads = jit_o0(jax.value_and_grad(jloss, has_aux=True), jparams, jvgg)(
        jparams, jvgg)
    # the JAX step's draws: bg from the key, the noise from fold_in(key, 2)
    draws = {"bg": torch.from_numpy(np.asarray(jax.random.uniform(key, (3,))))}
    if needs_noise(tparams, tmodel.config):
        draws["noise"] = torch.from_numpy(np.asarray(
            jax.random.uniform(jax.random.fold_in(key, 2), (3, H, W))))
    tx = make_optimizer(tparams, lr_tree_from_config(tparams), milestones=(1, 2))
    step = make_train_step(tmodel, tx, max_per_tile=K, vgg_params=tvgg,
                           loss_weights=LossWeights(enable_vgg_from=vgg_from))
    _, terms, aux, grads = step.loss_and_grads(tparams, tbatch, draws.pop("bg"), iteration,
                                               **draws)
    yield dict(name=name, jterms=jterms, jgrads=jgrads, terms=terms, grads=grads, aux=aux,
               tparams=tparams, tmodel=tmodel, tbatch=tbatch, tx=tx, step=step)
    mp.undo()


def test_loss_terms_match_jax(case):
    jterms, terms = case["jterms"], case["terms"]
    assert set(terms) == set(jterms) and "blur_loss" in terms
    if case["name"] == "every":
        assert float(terms["vgg_loss"].detach()) > 0  # counted: iteration 2 > enable_vgg_from 1
    for k, v in jterms.items():
        np.testing.assert_allclose(float(terms[k].detach()), float(v), rtol=TERM_RTOL, err_msg=k)
    assert case["aux"]["pred_image"].shape == (3, H, W)


def test_gradients_match_jax(case):
    jleaves, _ = jax.tree_util.tree_flatten_with_path(case["jgrads"])
    grads = case["grads"]
    assert len(jleaves) == len(grads) == len(tree_leaves(case["tparams"]))
    for (path, j), t in zip(jleaves, grads):
        name = jax.tree_util.keystr(path)
        assert t.shape == j.shape, name
        assert rel_l2(t, j) <= GRAD_REL, (name, rel_l2(t, j))


def test_new_leaves_have_gradients(case):
    """Every new option's leaf gets a finite, nonzero gradient, on the
    frame's and camera's rows only."""
    leaves = {jax.tree_util.keystr(p): i for i, (p, _) in
              enumerate(jax.tree_util.tree_flatten_with_path(case["jgrads"])[0])}
    new = ["['learnable_blur']['weights_raw']"]
    if case["name"] == "every":
        new += ["['pixel_cal']['bias']", "['bg_net']['bg']", "['optimizable_poses']",
                "['optimizable_rotations']", "['optimizable_translations']"]
    for name in new:
        g = case["grads"][leaves[name]]
        assert bool(torch.isfinite(g).all()), name
        row = FRAME_IDX if name.startswith("['optimizable") else CAMERA_IDX
        assert float(g[row].abs().max()) > 0, name
        assert float(torch.cat([g[:row], g[row + 1:]]).abs().max()) == 0, name


def test_step_draws_what_the_config_needs(case):
    """The whole step from a generator: the noise draw where the config
    builds the noise target, finite metrics, every term in the total."""
    tparams = convert.params_from_numpy(convert.params_to_numpy(case["tparams"]), device="cpu")
    tx = make_optimizer(tparams, lr_tree_from_config(tparams), milestones=(1, 2))
    cfg = case["tmodel"].config
    assert needs_noise(tparams, cfg) == (case["name"] == "every")
    step = make_train_step(case["tmodel"], tx, max_per_tile=K)
    _, m = step(tparams, case["tbatch"], torch.Generator().manual_seed(3), 0)
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    terms = [k for k in m if k.endswith("_loss") and k != "total_loss"] + ["codes_reg"]
    assert float(m["total_loss"]) == pytest.approx(sum(float(m[k]) for k in terms), rel=1e-6)
    assert tx.count == 1
