"""Parity of the PyTorch port's cage model, avatar forward (eval mode)
and synthetic scene builders with the JAX package, on the CPU.

Geometry is carried across with `d3ga_tpu_torch.convert` (the JAX
geometry may come from its native tet embedding, which the port does not
have); the weights are the port's own initialization carried to the JAX
package, whose initializer is held by structure and shapes. Float
outputs: rtol 1e-5, atol 1e-6, as for the ops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import d3ga_tpu.data.synthetic as jsyn
from d3ga_tpu.model.avatar import avatar_forward as j_avatar_forward
from d3ga_tpu.model.avatar import init_avatar as j_init_avatar
from d3ga_tpu.model.cage_model import cage_forward as j_cage_forward
from d3ga_tpu_torch import convert
from d3ga_tpu_torch.data import synthetic as tsyn
from d3ga_tpu_torch.model.avatar import avatar_forward, init_avatar
from d3ga_tpu_torch.utils.tree import tree_leaves
from d3ga_tpu_torch.model.cage_model import cage_forward
from torch_parity import bound_skeleton, close, port_model

N_GAUSS = 150


@pytest.fixture(scope="module")
def avatar_pair():
    jmodel, _, lbs_dim = jsyn.build_synthetic_avatar(n_garments=2, n_gaussians=N_GAUSS)
    tmodel = port_model(jmodel, 2)
    tparams = init_avatar(torch.Generator().manual_seed(0), tmodel)
    # a non-identity colour calibration for camera 1
    tparams["camera_calib"]["corrections"][1] = torch.tensor([0.9, 1.1, 0.8, 0.05, -0.02, 0.01])
    jparams = jax.tree_util.tree_map(jnp.asarray, convert.params_to_numpy(tparams))
    return jmodel, jparams, tmodel, tparams, lbs_dim


class TestSyntheticBuilders:
    @pytest.mark.parametrize("res", [1, 2, 3])
    def test_subdivided_cube_exact(self, res):
        for a, b in zip(tsyn.subdivided_cube((0.1, 0.2, 5.0), 1.2, res),
                        jsyn.subdivided_cube((0.1, 0.2, 5.0), 1.2, res)):
            assert np.array_equal(a, b)

    def test_toy_skeleton_and_binding(self, avatar_pair):
        jmodel = avatar_pair[0]
        jskel = jsyn.toy_skeleton(4, 0)
        tskel = tsyn.toy_skeleton(4, 0, device="cpu")
        close(tskel.bind_state, jskel.bind_state)
        close(tskel.joint_offset, jskel.joint_offset)
        # binding the JAX cage to the JAX skeleton's bind state gives the
        # JAX closure's skin weights
        geom, _ = convert.geometry_from_numpy(
            {k: None if v is None else np.asarray(v)
             for k, v in jmodel.garments[1].geometry._asdict().items()},
            device="cpu",
        )
        skel_np = {k: np.asarray(v) for k, v in jskel._asdict().items()}
        _, tj = convert.geometry_from_numpy({"cage_points": np.zeros((1, 3))}, skel_np, device="cpu")
        bound = tsyn.bind_cage_skeleton(geom, tj)
        ref = bound_skeleton(jmodel.garments[1].pose_nodes)
        close(bound.skin_weights, ref.skin_weights)
        assert np.array_equal(bound.skin_indices.numpy(), np.asarray(ref.skin_indices))

    def test_orbit_camera(self):
        t = tsyn.orbit_camera(0.3, 64, 48, device="cpu")
        j = jsyn.orbit_camera(0.3, 64, 48)
        for f in ("world_view", "full_proj", "camera_center", "tanfovx", "tanfovy"):
            close(getattr(t, f), getattr(j, f))

    def test_port_init_matches_structure(self, avatar_pair):
        jmodel, _, tmodel, _, _ = avatar_pair
        tparams = init_avatar(torch.Generator().manual_seed(0), tmodel)
        jparams = jax.eval_shape(lambda k: j_init_avatar(k, jmodel), jax.random.PRNGKey(0))
        jl, jdef = jax.tree_util.tree_flatten(jparams)
        tl, tdef = jax.tree_util.tree_flatten(tparams)
        assert jdef == tdef
        assert [np.shape(x) for x in jl] == [tuple(x.shape) for x in tl]


class TestCageForward:
    def test_cage_forward_identity_pose(self, avatar_pair):
        jmodel, jparams, tmodel, tparams, lbs_dim = avatar_pair
        jg, tg = jmodel.garments[1], tmodel.garments[1]
        cond = np.random.default_rng(3).normal(size=lbs_dim).astype(np.float32) * 0.1
        center = np.array([0.2, -0.1, 0.0], np.float32)
        frame = np.random.default_rng(4).normal(size=32).astype(np.float32) * 0.1

        def j_pose(delta):
            v = jg.geometry.cage_points
            return v if delta is None else v + delta

        def t_pose(delta):
            v = tg.geometry.cage_points
            return v if delta is None else v + delta

        jout = jax.jit(
            lambda p, c, cc, f: j_cage_forward(
                p, jg.geometry, j_pose, c, c, c, cc, frame_encoding=f, node_scale=0.2
            )
        )(jparams["garments"][jg.name], jnp.asarray(cond), jnp.asarray(center), jnp.asarray(frame))
        c = torch.from_numpy(cond)
        tout = cage_forward(tparams["garments"][tg.name], tg.geometry, t_pose, c, c, c,
                            torch.from_numpy(center), frame_encoding=torch.from_numpy(frame),
                            node_scale=0.2)
        for k in ("rgb", "opacities", "cov3D_precomp", "means3D", "canonical_means3D",
                  "fm_energy", "scale_energy", "silhouette_rgb"):
            close(tout[k], jout[k])
        close(tout["geometry"]["deformed_tetpoints"], jout["geometry"]["deformed_tetpoints"])


class TestAvatarForward:
    @pytest.mark.parametrize("camera_idx", [0, 1])
    def test_eval_forward(self, avatar_pair, camera_idx):
        jmodel, jparams, tmodel, tparams, lbs_dim = avatar_pair
        lbs = np.random.default_rng(camera_idx).normal(size=lbs_dim).astype(np.float32) * 0.1
        jcam = jsyn.orbit_camera(0.3, 64, 48)
        tcam = tsyn.orbit_camera(0.3, 64, 48, device="cpu")

        @jax.jit
        def jfwd(p, lbs):
            out = j_avatar_forward(
                p, jmodel,
                {"camera": jcam, "lbs": lbs, "frame_idx": jnp.int32(0),
                 "camera_idx": jnp.int32(camera_idx)},
                training=False,
            )
            return {k: out[k] for k in ("rgb", "opacities", "cov3D_precomp", "means3D",
                                        "silhouette_rgb", "fm_energy", "frame_encoding")}

        jout = jfwd(jparams, jnp.asarray(lbs))
        with torch.no_grad():
            tout = avatar_forward(
                tparams, tmodel,
                {"camera": tcam, "lbs": torch.from_numpy(lbs), "camera_idx": camera_idx},
            )
        for k, v in jout.items():
            close(tout[k], v)

    def test_unported_options_raise(self, avatar_pair):
        tmodel = avatar_pair[2]
        for key in ("use_ao", "use_shs", "use_face_emb"):
            m = tmodel._replace(config=dict(tmodel.config, **{key: True}))
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                init_avatar(torch.Generator(), m)
        mesh = tmodel._replace(garments=(tmodel.garments[0]._replace(primitive="mesh"),))
        with pytest.raises(NotImplementedError, match="mesh"):
            avatar_forward(avatar_pair[3], mesh, {})

    def test_capture_options_init_like_jax(self, avatar_pair):
        """use_blur, use_pixel_cal, use_bg_network and use_opt_smplx build:
        the same leaves and constant inits as JAX's `init_avatar`, the
        optimizable poses / Rh / Th the tables handed in."""
        jmodel, _, tmodel, _, lbs_dim = avatar_pair
        opts = {"use_blur": True, "use_pixel_cal": True, "use_bg_network": True,
                "use_opt_smplx": True, "image_height": 48, "image_width": 64}
        rng = np.random.default_rng(4)
        tables = dict(init_smplx_poses=rng.normal(size=(8, lbs_dim)).astype(np.float32),
                      init_smplx_rh=rng.normal(size=(8, 3)).astype(np.float32),
                      init_smplx_th=rng.normal(size=(8, 3)).astype(np.float32))
        tp = init_avatar(torch.Generator().manual_seed(0),
                         tmodel._replace(config=dict(tmodel.config, **opts)),
                         **{k: torch.from_numpy(v) for k, v in tables.items()})
        jm = jmodel._replace(config=dict(jmodel.config, **opts))
        jp = jax.jit(lambda k, t: j_init_avatar(k, jm, **t))(jax.random.PRNGKey(0), tables)
        assert sorted(tp) == sorted(jp)
        for key in ("learnable_blur", "pixel_cal", "bg_net", "optimizable_poses",
                    "optimizable_rotations", "optimizable_translations"):
            for t, j in zip(tree_leaves(tp[key]), jax.tree_util.tree_leaves(jp[key])):
                assert np.array_equal(t.numpy(), np.asarray(j)), key

    @pytest.mark.parametrize("iteration", [0, 400_001])
    def test_optimizable_poses_forward(self, avatar_pair, iteration):
        """Training conditions on the frame's optimizable pose, frozen after
        400k iterations, as JAX's forward does; the package carries it for
        the pose regularizer."""
        jmodel, jparams, tmodel, tparams, lbs_dim = avatar_pair
        poses = np.random.default_rng(6).normal(size=(8, lbs_dim)).astype(np.float32) * 0.1
        jp = dict(jparams, optimizable_poses=jnp.asarray(poses))
        tp = dict(tparams, optimizable_poses=torch.from_numpy(poses).requires_grad_(True))
        lbs = np.random.default_rng(7).normal(size=lbs_dim).astype(np.float32) * 0.1
        jcam = jsyn.orbit_camera(0.3, 64, 48)
        keys = ("rgb", "means3D", "cov3D_precomp", "optimizable_poses")

        def jfwd(p):
            out = j_avatar_forward(
                p, jmodel, {"camera": jcam, "lbs": jnp.asarray(lbs), "frame_idx": jnp.int32(3),
                            "camera_idx": jnp.int32(1), "iteration": jnp.int32(iteration)},
                training=True)
            return jnp.sum(out["means3D"]), {k: out[k] for k in keys}

        (_, jout), jg = jax.jit(jax.value_and_grad(jfwd, has_aux=True))(jp)
        jg = jg["optimizable_poses"]
        tout = avatar_forward(
            tp, tmodel, {"camera": tsyn.orbit_camera(0.3, 64, 48, device="cpu"),
                         "lbs": torch.from_numpy(lbs), "frame_idx": 3, "camera_idx": 1,
                         "iteration": iteration}, training=True)
        for k in keys:
            close(tout[k].detach(), jout[k])
        tg = (torch.autograd.grad(torch.sum(tout["means3D"]), tp["optimizable_poses"])[0]
              if tout["means3D"].requires_grad else torch.zeros(poses.shape))
        close(tg, jg, rtol=1e-4, atol=1e-5)
        assert (float(tg.abs().max()) > 0) == (iteration == 0)
