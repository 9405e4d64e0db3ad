"""The optimizable global pose (Rh / Th) through the in-graph camera
rebuild against the JAX package on the CPU: `smplx_camera_to_world` and
`camera_from_c2w` (values and Jacobians), `_freeze_after` either side of
400k, `resolve_camera` with Rh = Th = 0 reproducing the camera, and dL/dRh
and dL/dTh of `render_frame` on tests/test_opt_camera.py's synthetic
avatar (1 garment x 64 Gaussians, 4 frames, 3 joints, 48 x 48, K 32),
JAX's parameters carried across, JAX's background draw handed over.

Tolerances: the 4x4 float32 inverses (`jnp.linalg.inv` and
`torch.linalg.inv` factor in other orders) within 1e-6 abs, their
Jacobians rel L2 1e-5; the camera at Rh = Th = 0 as
tests/test_opt_camera.py holds it (world_view 1e-5, full_proj 1e-4
abs); the loss rel 1e-5 and dL/dRh, dL/dTh rel L2 1e-3 (PERF.md section
2's gradient agreement).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3ga_tpu.data.synthetic as jsyn
from d3ga_tpu.body.drivers import smplx_camera_to_world as j_c2w
from d3ga_tpu.model.avatar import _freeze_after as j_freeze_after
from d3ga_tpu.model.avatar import init_avatar as j_init_avatar
from d3ga_tpu.model.avatar import resolve_camera as j_resolve_camera
from d3ga_tpu.raster.camera import camera_from_c2w as j_camera_from_c2w
from d3ga_tpu.train.step import render_frame as j_render_frame
from d3ga_tpu.train.step import total_loss as j_total_loss
from d3ga_tpu_torch import convert
from d3ga_tpu_torch.body.drivers import smplx_camera_to_world
from d3ga_tpu_torch.data import synthetic as tsyn
from d3ga_tpu_torch.model.avatar import FREEZE_AFTER, _freeze_after, resolve_camera
from d3ga_tpu_torch.raster.camera import camera_from_c2w
from d3ga_tpu_torch.train.step import render_frame, total_loss
from torch_parity import jit_o0, port_model

H = W = 48
ATOL, JAC_REL, GRAD_REL = 1e-6, 1e-5, 1e-3


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def pose(seed):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=3) * s).astype(np.float32) for s in (0.3, 0.2))


W2C = np.asarray(jsyn.orbit_camera(0.4, W, H).world_view)


@pytest.mark.parametrize("mocap", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_smplx_camera_to_world_matches_jax(seed, mocap):
    rh, th = pose(seed)
    want = np.asarray(j_c2w(jnp.asarray(rh), jnp.asarray(th), jnp.asarray(W2C), mocap=mocap))
    got = smplx_camera_to_world(torch.from_numpy(rh), torch.from_numpy(th), torch.from_numpy(W2C),
                                mocap=mocap)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)


def test_smplx_camera_to_world_jacobian():
    rh, th = pose(0)
    jj = jax.jit(jax.jacobian(lambda r, t: j_c2w(r, t, jnp.asarray(W2C)), (0, 1)))(
        jnp.asarray(rh), jnp.asarray(th))
    tj = torch.autograd.functional.jacobian(
        lambda r, t: smplx_camera_to_world(r, t, torch.from_numpy(W2C)),
        (torch.from_numpy(rh), torch.from_numpy(th)))
    for t, j in zip(tj, jj):
        assert rel_l2(t, j) <= JAC_REL


def test_camera_from_c2w_matches_jax():
    rh, th = pose(2)
    c2w = np.asarray(j_c2w(jnp.asarray(rh), jnp.asarray(th), jnp.asarray(W2C)))
    cam0 = jsyn.orbit_camera(0.4, W, H)
    g = np.random.default_rng(3).normal(size=(2, 4, 4)).astype(np.float32)

    def jf(c):
        cam = j_camera_from_c2w(c, cam0.tanfovx, cam0.tanfovy, W, H)
        return jnp.sum(cam.world_view * g[0]) + jnp.sum(cam.full_proj * g[1]), cam

    (jv, jcam), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jnp.asarray(c2w))
    tc = torch.from_numpy(c2w).requires_grad_(True)
    tcam = camera_from_c2w(tc, float(cam0.tanfovx), float(cam0.tanfovy), W, H)
    for k in ("world_view", "full_proj", "camera_center", "tanfovx", "tanfovy"):
        np.testing.assert_allclose(getattr(tcam, k).detach().numpy(), np.asarray(getattr(jcam, k)),
                                   rtol=0, atol=ATOL, err_msg=k)
    assert (tcam.width, tcam.height) == (W, H)
    tv = torch.sum(tcam.world_view * torch.from_numpy(g[0])) + torch.sum(
        tcam.full_proj * torch.from_numpy(g[1]))
    (tg,) = torch.autograd.grad(tv, tc)
    assert rel_l2(tg, jg) <= JAC_REL


@pytest.mark.parametrize("iteration", [FREEZE_AFTER - 1, FREEZE_AFTER, FREEZE_AFTER + 1])
def test_freeze_after(iteration):
    """Gradient through until iteration > 400k, none after; the value kept."""
    p = np.arange(3, dtype=np.float32)
    jg = np.asarray(jax.grad(lambda v: jnp.sum(j_freeze_after(v, iteration) * 2.0))(
        jnp.asarray(p)))
    tp = torch.from_numpy(p).requires_grad_(True)
    out = _freeze_after(tp, iteration)
    assert torch.equal(out.detach(), tp.detach())
    tg = (torch.autograd.grad(torch.sum(out * 2.0), tp)[0] if out.requires_grad
          else torch.zeros_like(tp))
    assert np.array_equal(tg.numpy(), jg)
    assert np.all(jg == (0.0 if iteration > FREEZE_AFTER else 2.0))


@pytest.fixture(scope="module")
def opt_avatar():
    """tests/test_opt_camera.py's setup, in both packages."""
    jmodel, _, lbs_dim = jsyn.build_synthetic_avatar(
        n_garments=1, n_gaussians=64, n_frames=4, n_cameras=2, n_joints=3,
        config_overrides={"use_opt_smplx": True})
    init_poses = jax.random.normal(jax.random.PRNGKey(5), (4, lbs_dim)) * 0.1
    # a nonzero global pose of frame 1, so the rebuilt camera moves
    rh = jnp.zeros((4, 3)).at[1].set(jnp.asarray([0.02, -0.03, 0.01]))
    th = jnp.zeros((4, 3)).at[1].set(jnp.asarray([0.01, 0.02, -0.02]))
    jparams = jax.jit(lambda k: j_init_avatar(k, jmodel, init_smplx_poses=init_poses,
                                              init_smplx_rh=rh, init_smplx_th=th))(
        jax.random.PRNGKey(0))
    cam = jsyn.orbit_camera(0.4, W, H)
    lbs = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (lbs_dim,)) * 0.1)
    jbatch = {"camera": cam, "cam_rt": cam.world_view, "lbs": jnp.asarray(lbs),
              "frame_idx": jnp.int32(1), "camera_idx": jnp.int32(0),
              "image": jnp.full((3, H, W), 0.5), "alpha": jnp.ones((1, H, W)),
              "silhouette": jnp.full((3, H, W), 0.5)}
    tmodel = port_model(jmodel, 1, config_overrides={"use_opt_smplx": True})._replace(
        cond_dim=jmodel.cond_dim)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tcam = tsyn.orbit_camera(0.4, W, H, device="cpu")
    tbatch = {"camera": tcam, "cam_rt": tcam.world_view, "lbs": torch.from_numpy(lbs),
              "frame_idx": 1, "camera_idx": 0, "image": torch.full((3, H, W), 0.5),
              "alpha": torch.ones(1, H, W), "silhouette": torch.full((3, H, W), 0.5)}
    return jmodel, jparams, jbatch, tmodel, tparams, tbatch


def test_resolve_camera_identity(opt_avatar):
    """Frame 0's Rh = Th = 0 reproduce the capture camera, as JAX's do."""
    jmodel, jparams, jbatch, tmodel, tparams, tbatch = opt_avatar
    jb = j_resolve_camera(jparams, jmodel, dict(jbatch, frame_idx=jnp.int32(0)), training=True)
    tb = resolve_camera(tparams, tmodel, dict(tbatch, frame_idx=0), training=True)
    cam = tbatch["camera"]
    np.testing.assert_allclose(tb["camera"].world_view.numpy(), cam.world_view.numpy(), atol=1e-5)
    np.testing.assert_allclose(tb["camera"].full_proj.numpy(), cam.full_proj.numpy(), atol=1e-4)
    for k in ("world_view", "full_proj", "camera_center"):
        np.testing.assert_allclose(getattr(tb["camera"], k).numpy(),
                                   np.asarray(getattr(jb["camera"], k)), rtol=0, atol=ATOL)
    assert resolve_camera(tparams, tmodel, tbatch, training=False) is tbatch
    no_rt = {k: v for k, v in tbatch.items() if k != "cam_rt"}
    assert resolve_camera(tparams, tmodel, no_rt, training=True) is no_rt


def test_dl_drh_dth_match_jax(opt_avatar):
    jmodel, jparams, jbatch, tmodel, tparams, tbatch = opt_avatar
    key = jax.random.PRNGKey(2)

    def jloss(p):
        terms, _ = j_render_frame(p, jmodel, jbatch, key, max_per_tile=32)
        return j_total_loss(terms)

    jv, jg = jit_o0(jax.value_and_grad(jloss), jparams)(jparams)
    bg = torch.from_numpy(np.asarray(jax.random.uniform(key, (3,))))
    rt = [tparams[k].requires_grad_(True)
          for k in ("optimizable_rotations", "optimizable_translations")]
    for iteration in (0, FREEZE_AFTER + 1):
        terms, _ = render_frame(tparams, tmodel, tbatch, bg, max_per_tile=32, iteration=iteration)
        if iteration:  # frozen after 400k: the loss no longer reaches Rh / Th
            assert not total_loss(terms).requires_grad
            continue
        tg = torch.autograd.grad(total_loss(terms), rt)
        np.testing.assert_allclose(float(total_loss(terms)), float(jv), rtol=1e-5)
        for g, k in zip(tg, ("optimizable_rotations", "optimizable_translations")):
            j = np.asarray(jg[k])
            assert np.abs(g[1].numpy()).max() > 0, k  # the frame's row: real
            assert not np.delete(g.numpy(), 1, 0).any(), k  # the others: none
            assert rel_l2(g, j) <= GRAD_REL, (k, rel_l2(g, j))
