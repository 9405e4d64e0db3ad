"""Shared pieces of the avatar model options' parity tests
(tests/test_torch_model_options.py, test_torch_model_decoders.py,
test_torch_mesh_model.py): the JAX avatar with each option and its port
on the same geometry, their batches, and `hold`, which holds the two
packages' values, images and every parameter leaf's gradient.

Tolerances: package values rtol 1e-5, atol 1e-6 (tests/test_torch_model.py's);
images atol 1e-5 (the XLA blend's float32 sums in another order); each
gradient leaf rel L2 <= 1e-4 (tests/test_torch_train.py's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import d3ga_tpu.data.synthetic as jsyn
from d3ga_tpu.model.avatar import AvatarModel as JAvatarModel
from d3ga_tpu.model.avatar import GarmentSpec as JGarmentSpec
from d3ga_tpu.model.avatar import avatar_forward as j_avatar_forward
from d3ga_tpu.model.avatar import init_avatar as j_init_avatar
from d3ga_tpu.ops.posenc import positional_encoding as j_posenc
from d3ga_tpu.raster.tiles import rasterize_tiled as j_rasterize_tiled
from d3ga_tpu_torch import convert
from d3ga_tpu_torch.data import synthetic as tsyn
from d3ga_tpu_torch.model.avatar import AvatarModel, GarmentSpec, avatar_forward
from d3ga_tpu_torch.raster.tiles import rasterize_tiled
from d3ga_tpu_torch.utils.tree import tree_leaves
from torch_parity import bound_skeleton, close, jit_o0, port_model

W, H, K, N_GAUSS = 64, 48, 64, 40
IMG_ATOL, GRAD_REL = 1e-5, 1e-4
FRAME_IDX, CAMERA_IDX = 2, 1
BG = np.array([0.1, 0.2, 0.3], np.float32)
# Goliath's momentum pose: 104 values, the MLPs conditioned on the 98
# past the root; the toy skeleton's pose closures read its first 28
LBS_WIDE, COND_WIDE = 104, 98
N_KPTS = 10
KEYS = ("rgb", "shs", "opacities", "cov3D_precomp", "scales", "rotations", "means3D",
        "canonical_means3D", "silhouette_rgb", "fm_energy", "scale_energy")


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def narrow(pose_nodes, width):
    """A pose closure that reads the first `width` values of the batch's lbs."""
    return lambda batch, delta=None: pose_nodes(dict(batch, lbs=batch["lbs"][:width]), delta)


@functools.lru_cache(maxsize=1)
def base_pair():
    """The 2-garment synthetic cage avatar, built once: (JAX model, port
    model on its geometry, lbs width)."""
    jmodel, _, lbs_dim = jsyn.build_synthetic_avatar(n_garments=2, n_gaussians=N_GAUSS)
    return jmodel, port_model(jmodel, 2), lbs_dim


def cage_pair(option):
    """(JAX model, port model, lbs width) for the 2-garment cage avatar
    with `option`'s config: "rgb" (none), "sh" (SH colours of degree 2),
    "ao_face" (the AO shadow decoder on each cage's nodes, mapped one to
    one onto a body template, and the face decoder conditioning garment 1,
    named "face"; Goliath's 104-wide pose, cond_dim 98)."""
    cfg = {"sh": {"use_shs": True, "max_sh_degree": 2},
           "ao_face": {"use_ao": True, "use_face_emb": True, "n_valid_kpts": N_KPTS,
                       "face_embed_dim": COND_WIDE},
           "rgb": {}}[option]
    jmodel, tmodel, lbs_dim = base_pair()
    jmodel = jmodel._replace(config=dict(jmodel.config, **cfg))
    tmodel = tmodel._replace(config=dict(tmodel.config, **cfg))
    if option != "ao_face":
        return jmodel, tmodel, lbs_dim
    pairs = []
    for i, (j, t) in enumerate(zip(jmodel.garments, tmodel.garments)):
        name = "face" if i == 1 else j.name
        jg = j.geometry._replace(cage_to_body_vertex=jnp.arange(j.geometry.cage_points.shape[0]))
        tg = t.geometry._replace(cage_to_body_vertex=torch.arange(t.geometry.cage_points.shape[0]))
        pairs.append((j._replace(name=name, geometry=jg, pose_nodes=narrow(j.pose_nodes, lbs_dim)),
                      t._replace(name=name, geometry=tg, pose_nodes=narrow(t.pose_nodes, lbs_dim))))
    jg, tg = zip(*pairs)
    return (jmodel._replace(garments=jg, cond_dim=COND_WIDE),
            tmodel._replace(garments=tg, cond_dim=COND_WIDE), LBS_WIDE)


def mesh_pair():
    """Two mesh garments (JAX's `mesh_garment_from_cube`) on a 3-joint
    skeleton, carried across."""
    skel = jsyn.toy_skeleton(3, 0)
    jg, tg = [], []
    for i in range(2):
        geom, pose_verts, _ = jsyn.mesh_garment_from_cube(
            n_gaussians=N_GAUSS, seed=i, center=(0.15 * i, 0.1 * i, 5.0 + 0.3 * i),
            size=1.0 + 0.2 * i, skel=skel)
        jg.append(JGarmentSpec(name=("body", "upper")[i], geometry=geom, pose_nodes=pose_verts,
                               silhouette_color=(0.0, 0.0, 1.0), primitive="mesh"))
        tgeom, tskel = convert.mesh_geometry_from_numpy(
            {k: None if v is None else np.asarray(v) for k, v in geom._asdict().items()},
            {k: np.asarray(v) for k, v in bound_skeleton(pose_verts)._asdict().items()},
            device="cpu")
        tg.append(GarmentSpec(name=jg[-1].name, geometry=tgeom,
                              pose_nodes=tsyn.skinned_pose_fn(tskel),
                              silhouette_color=(0.0, 0.0, 1.0), primitive="mesh"))
    cfg = {"frame_embed_dim": 32, "use_color_calib": True}
    return (JAvatarModel(garments=tuple(jg), cond_dim=21, n_frames=4, n_cameras=2, config=cfg),
            AvatarModel(garments=tuple(tg), cond_dim=21, n_frames=4, n_cameras=2, config=cfg), 21)


def batches(jmodel, lbs_dim):
    rng = np.random.default_rng(8)
    data = {"lbs": (rng.normal(size=lbs_dim) * 0.1).astype(np.float32)}
    if jmodel.config.get("use_ao"):
        template = rng.normal(size=(8, 3)).astype(np.float32)
        data["template_pe"] = np.asarray(j_posenc(jnp.asarray(template), 7))
    if jmodel.config.get("use_face_emb"):
        data["face_kpt_canonical"] = rng.normal(size=(N_KPTS, 3)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in data.items()}
    jb.update(camera=jsyn.orbit_camera(0.3, W, H), frame_idx=jnp.int32(FRAME_IDX),
              camera_idx=jnp.int32(CAMERA_IDX))
    tb = {k: torch.from_numpy(v) for k, v in data.items()}
    tb.update(camera=tsyn.orbit_camera(0.3, W, H, device="cpu"), frame_idx=FRAME_IDX,
              camera_idx=CAMERA_IDX)
    return jb, tb


def draw(rasterize, pkg, camera, bg, sh_degree, **kw):
    return rasterize(pkg["means3D"], camera, bg, cov3d=pkg["cov3D_precomp"],
                     scales=pkg["scales"], rotations=pkg["rotations"],
                     opacities=pkg["opacities"], colors=pkg["rgb"],
                     shs=pkg["shs"] if pkg["rgb"] is None else None, sh_degree=sh_degree,
                     max_per_tile=K, **kw)[0]


def hold(jmodel, tmodel, lbs_dim, forwards=((j_avatar_forward, avatar_forward),), sh_degree=0):
    """Each (JAX, port) forward's package values and rendered image, and
    every parameter leaf's gradient of the sum of their images' weighted
    sums. Both start from JAX's `init_avatar`. Returns the port's
    parameters, their gradients (in `tree_leaves` order) and packages."""
    key = jax.random.PRNGKey(0)
    jparams = jit_o0(lambda k: j_init_avatar(k, jmodel), key)(key)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jb, tb = batches(jmodel, lbs_dim)
    cots = np.random.default_rng(9).normal(size=(len(forwards), 3, H, W)).astype(np.float32)

    def jloss(p):
        loss, out = 0.0, []
        for (fwd, _), cot in zip(forwards, cots):
            pkg = fwd(p, jmodel, jb)
            img = draw(j_rasterize_tiled, pkg, jb["camera"], jnp.asarray(BG), sh_degree)
            loss = loss + jnp.sum(img * cot)
            out.append(({k: pkg[k] for k in KEYS if pkg[k] is not None}, img))
        return loss, out

    (_, jout), jg = jit_o0(jax.value_and_grad(jloss, has_aux=True), jparams)(jparams)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, pkgs = 0.0, []
    for (_, fwd), cot, (jpkg, jimg) in zip(forwards, cots, jout):
        pkg = fwd(tparams, tmodel, tb)
        img = draw(rasterize_tiled, pkg, tb["camera"], torch.from_numpy(BG), sh_degree)
        loss = loss + torch.sum(img * torch.from_numpy(cot))
        assert {k for k in KEYS if pkg[k] is not None} == set(jpkg)
        for k, v in jpkg.items():
            close(pkg[k].detach(), v)
        np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), rtol=0, atol=IMG_ATOL)
        pkgs.append(pkg)
    tg = torch.autograd.grad(loss, leaves, materialize_grads=True)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    for i, (t, j) in enumerate(zip(tg, jleaves)):
        assert t.shape == j.shape and rel_l2(t, j) <= GRAD_REL, (i, t.shape, rel_l2(t, j))
    return tparams, tg, pkgs


def max_grad(tparams, tg, subtree):
    """The largest |gradient| over the leaves of `subtree` of tparams."""
    ids = {id(t) for t in tree_leaves(subtree)}
    return max(float(g.abs().max()) for t, g in zip(tree_leaves(tparams), tg) if id(t) in ids)
