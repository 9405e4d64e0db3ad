"""Synthetic scenes: tetrahedralized-cube cages (or cube-surface meshes)
skinned by a toy chain skeleton, and checkerboard targets (counterpart
of d3ga_tpu/data/synthetic.py) — the avatar the serving smoke run and
the tests render, no capture data needed.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from d3ga_tpu_torch.body.lbs import MomentumSkeleton, skin_points, solve_skeleton_states
from d3ga_tpu_torch.geometry.sampling import sample_initial_gaussians
from d3ga_tpu_torch.model.avatar import AvatarModel, GarmentSpec
from d3ga_tpu_torch.model.cage_model import CageGeometry, build_cage_geometry
from d3ga_tpu_torch.model.mesh_model import MeshGeometry
from d3ga_tpu_torch.ops.quaternion import matrix_to_quat
from d3ga_tpu_torch.raster.camera import focal2fov, make_camera

CUBE_TETS = np.array(
    [(1, 0, 3, 5), (2, 0, 3, 6), (4, 0, 5, 6), (7, 3, 5, 6), (0, 3, 5, 6)],
    dtype=np.int32,
)
CUBE_FACES = np.array(
    [
        [0, 1, 3], [0, 3, 2], [4, 6, 5], [5, 6, 7],
        [0, 4, 1], [1, 4, 5], [2, 3, 6], [3, 7, 6],
        [0, 2, 4], [2, 6, 4], [1, 5, 3], [3, 5, 7],
    ],
    dtype=np.int32,
)


def subdivided_cube(center, size=1.0, res: int = 1):
    """A res^3 grid of cubes, each split into 5 tets -> (verts, tets,
    surface faces); res=1 gives the plain 8-vertex cube."""
    c = np.asarray(center, np.float64)
    if res == 1:
        verts = np.array(
            [[(i & 1), (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], dtype=np.float64
        )
        return (verts - 0.5) * size + c, CUBE_TETS.copy(), CUBE_FACES.copy()

    lin = np.linspace(-0.5, 0.5, res + 1)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3) * size + c

    def vid(i, j, k):
        return (i * (res + 1) + j) * (res + 1) + k

    # odd cells take the x-mirrored split so shared faces conform
    odd = (CUBE_TETS ^ 1)[:, [0, 1, 3, 2]]
    tets = []
    for i in range(res):
        for j in range(res):
            for k in range(res):
                corner = [
                    vid(i, j, k), vid(i + 1, j, k), vid(i, j + 1, k),
                    vid(i + 1, j + 1, k), vid(i, j, k + 1), vid(i + 1, j, k + 1),
                    vid(i, j + 1, k + 1), vid(i + 1, j + 1, k + 1),
                ]
                base = CUBE_TETS if (i + j + k) % 2 == 0 else odd
                for t in base:
                    tets.append([corner[x] for x in t])
    tets = np.asarray(tets, np.int32)

    faces = []
    for i in range(res):
        for j in range(res):
            faces += [
                [vid(0, i, j), vid(0, i + 1, j), vid(0, i, j + 1)],
                [vid(0, i + 1, j), vid(0, i + 1, j + 1), vid(0, i, j + 1)],
                [vid(res, i, j), vid(res, i, j + 1), vid(res, i + 1, j)],
                [vid(res, i + 1, j), vid(res, i, j + 1), vid(res, i + 1, j + 1)],
                [vid(i, 0, j), vid(i, 0, j + 1), vid(i + 1, 0, j)],
                [vid(i + 1, 0, j), vid(i, 0, j + 1), vid(i + 1, 0, j + 1)],
                [vid(i, res, j), vid(i + 1, res, j), vid(i, res, j + 1)],
                [vid(i + 1, res, j), vid(i + 1, res, j + 1), vid(i, res, j + 1)],
                [vid(i, j, 0), vid(i + 1, j, 0), vid(i, j + 1, 0)],
                [vid(i + 1, j, 0), vid(i + 1, j + 1, 0), vid(i, j + 1, 0)],
                [vid(i, j, res), vid(i, j + 1, res), vid(i + 1, j, res)],
                [vid(i + 1, j, res), vid(i, j + 1, res), vid(i + 1, j + 1, res)],
            ]
    return verts, tets, np.asarray(faces, np.int32)


def cube_cage_geometry(
    n_gaussians=64, seed=0, center=(0.0, 0.0, 5.0), size=1.0, res: int = 1, device="cuda"
) -> CageGeometry:
    verts, tets, faces = subdivided_cube(center, size, res)
    c = np.asarray(center, np.float64)
    inner = (verts - c) * 0.92 + c
    samples = sample_initial_gaussians(inner, faces, n_gaussians, seed=seed)
    return build_cage_geometry(
        cage_points=verts.astype(np.float32),
        tetras=tets,
        triangles=faces,
        sample_points=samples["points"],
        sample_rotations=samples["rotations"],
        device=device,
    )


def toy_skeleton(n_joints=4, seed=0, device="cuda") -> MomentumSkeleton:
    """A chain skeleton with identity parameter transform (7 raw params
    per joint), bind state solved at zero pose."""
    J = n_joints
    rng = np.random.default_rng(seed)
    offs = np.concatenate([[[0, 0, 0]], rng.normal(0, 0.2, (J - 1, 3))]).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    skel = MomentumSkeleton(
        joint_parents=torch.as_tensor(np.concatenate([[-1], np.arange(J - 1)]), dtype=torch.int32),
        joint_offset=torch.as_tensor(offs, **f32),
        joint_rotation=torch.tensor([1.0, 0, 0, 0], **f32).repeat(J, 1),
        transform=torch.eye(7 * J, **f32),
        transform_offsets=torch.zeros(7 * J, **f32),
        skin_weights=torch.zeros(1, 8, **f32),
        skin_indices=torch.zeros(1, 8, dtype=torch.int64, device=device),
        bind_state=torch.zeros(J, 8, **f32),
        template_verts=torch.zeros(1, 3, **f32),
    )
    bind = solve_skeleton_states(skel, torch.zeros(1, 7 * J, **f32))[0]
    return skel._replace(bind_state=bind)


def bind_cage_skeleton(geometry: CageGeometry, skel: MomentumSkeleton, n_weights=8) -> MomentumSkeleton:
    """Bind the cage nodes to the skeleton with inverse-square distance
    weights over the nearest joints (host numpy, float64)."""
    return bind_points_skeleton(geometry.cage_points, skel, n_weights)


def bind_points_skeleton(points: torch.Tensor, skel: MomentumSkeleton, n_weights=8):
    """Bind points [V, 3] (cage nodes, mesh vertices) to the skeleton with
    inverse-square distance weights over the nearest joints; the points
    become its template."""
    device = points.device
    nodes = points.cpu().numpy()
    joints = skel.bind_state[:, 0:3].cpu().numpy()
    d = np.linalg.norm(nodes[:, None] - joints[None], axis=-1) + 1e-4
    k = min(n_weights, joints.shape[0])
    idx = np.argsort(d, axis=1)[:, :k]
    w = 1.0 / np.take_along_axis(d, idx, axis=1) ** 2
    w = w / w.sum(axis=1, keepdims=True)
    pad = n_weights - k
    return skel._replace(
        skin_weights=torch.as_tensor(np.pad(w, ((0, 0), (0, pad))).astype(np.float32), device=device),
        skin_indices=torch.as_tensor(np.pad(idx, ((0, 0), (0, pad))), dtype=torch.int64, device=device),
        template_verts=points,
    )


def skinned_pose_fn(skel_cage: MomentumSkeleton):
    """pose_nodes(batch, delta) closure over a skeleton bound to a cage
    (delta is the pre-LBS node offset)."""

    def pose_nodes(batch, delta=None):
        verts = skel_cage.template_verts
        if delta is not None:
            verts = verts + delta
        return skin_points(skel_cage, batch["lbs"][None], verts[None])[0]

    return pose_nodes


def skinned_cage_pose_fn(geometry: CageGeometry, skel: MomentumSkeleton, n_weights=8):
    return skinned_pose_fn(bind_cage_skeleton(geometry, skel, n_weights))


def build_synthetic_avatar(
    n_garments=2,
    n_gaussians=256,
    n_frames=8,
    n_cameras=4,
    n_joints=4,
    cage_res=1,
    seed=0,
    config_overrides=None,
    device="cuda",
    parts: Optional[Sequence[Tuple[CageGeometry, MomentumSkeleton]]] = None,
):
    """A drivable synthetic multi-garment avatar -> (model, skeleton,
    lbs_dim). `parts` optionally gives each garment's (geometry, bound
    skeleton) carried across from elsewhere (`convert.geometry_from_numpy`)
    instead of building them from the seed."""
    skel = toy_skeleton(n_joints, seed, device=device)
    colors = [(0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.5, 0.5, 0.5)]
    names = ["body", "upper", "lower", "extra"]
    garments = []
    for i in range(n_garments):
        if parts is not None:
            geom, skel_cage = parts[i]
        else:
            geom = cube_cage_geometry(
                n_gaussians=n_gaussians,
                seed=seed + i,
                center=(0.15 * i, 0.1 * i, 5.0 + 0.3 * i),
                size=1.0 + 0.2 * i,
                res=cage_res,
                device=device,
            )
            skel_cage = bind_cage_skeleton(geom, skel)
        garments.append(
            GarmentSpec(
                name=names[i],
                geometry=geom,
                pose_nodes=skinned_pose_fn(skel_cage),
                silhouette_color=colors[i],
                node_scale=0.07 if i == 0 else 0.2,
            )
        )
    lbs_dim = 7 * n_joints
    config = {
        "frame_embed_dim": 32,
        "use_color_calib": True,
        "use_blur": False,
        "n_color_features": 64,
    }
    config.update(config_overrides or {})
    model = AvatarModel(
        garments=tuple(garments),
        cond_dim=lbs_dim,
        n_frames=n_frames,
        n_cameras=n_cameras,
        config=config,
    )
    return model, skel, lbs_dim


def serving_scene(
    n_garments=3, n_gaussians=45000, cage_res=3, width=667, height=1024, device="cuda"
):
    """The serving scene -> (model, camera, pose): the synthetic avatar
    (defaults: full width, 135,000 Gaussians at 1024 x 667), the orbit
    camera at angle 0.3, and pose(i), frame i's pose vector — a per-joint
    sinusoid 0.05 sin(0.37 i + 0.61 j) around the rest pose."""
    model, _, lbs_dim = build_synthetic_avatar(
        n_garments=n_garments, n_gaussians=n_gaussians, cage_res=cage_res, device=device
    )
    camera = orbit_camera(0.3, width, height, device=device)
    phase = torch.arange(lbs_dim, device=device, dtype=torch.float32) * 0.61

    def pose(i):
        return 0.05 * torch.sin(i * 0.37 + phase)

    return model, camera, pose


def orbit_camera(angle, w, h, radius=5.0, focal=None, center=(0.0, 0.0, 5.0), device="cuda"):
    """Camera orbiting the synthetic scene centre."""
    focal = focal or max(w, h)
    c = np.asarray(center)
    eye = c + radius * np.array([np.sin(angle), 0.0, -np.cos(angle)])
    fwd = c - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], axis=1)  # camera-to-world
    T = -R.T @ eye
    return make_camera(R, T, focal2fov(focal, w), focal2fov(focal, h), w, h, device=device)


def checkerboard(h, w, cells=8, device="cuda"):
    """A [3, h, w] target: a cells x cells checkerboard, its complement and
    a constant 0.5."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    board = ((ys // (h // cells) + xs // (w // cells)) % 2).astype(np.float32)
    img = np.stack([board, 1.0 - board, 0.5 * np.ones_like(board)], axis=0)
    return torch.as_tensor(img, device=device)


def synthetic_batch(camera, lbs_dim, h, w, frame_idx=0, camera_idx=0, gen=None):
    """A training batch on the camera's device: a pose drawn from `gen`
    (default: a generator seeded with frame_idx), N(0, 0.1^2) a value, the
    checkerboard target, full alpha, a 0.5 silhouette."""
    gen = gen if gen is not None else torch.Generator().manual_seed(frame_idx)
    device = camera.world_view.device
    return {
        "camera": camera,
        "lbs": (torch.randn(lbs_dim, generator=gen) * 0.1).to(device),
        "frame_idx": frame_idx,
        "camera_idx": camera_idx,
        "image": checkerboard(h, w, device=device),
        "alpha": torch.ones((1, h, w), device=device),
        "silhouette": torch.full((3, h, w), 0.5, device=device),
    }


def mesh_garment_from_cube(
    n_gaussians=64, seed=0, center=(0.0, 0.0, 5.0), size=1.0, res=2,
    skel: Optional[MomentumSkeleton] = None, device="cuda",
):
    """A mesh-primitive garment: Gaussians on the subdivided cube's
    surface triangles with 3-vertex barycentrics, the vertices skinned
    by `skel` (default: a 3-joint toy skeleton from the seed) ->
    (MeshGeometry, pose_verts(batch, delta) closure, skeleton)."""
    verts, _, faces = subdivided_cube(center, size, res)
    samples = sample_initial_gaussians(verts, faces, n_gaussians, seed=seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    geom = MeshGeometry(
        template_verts=f32(verts),
        faces=torch.as_tensor(faces.astype(np.int64), device=device),
        init_face_ids=torch.as_tensor(samples["face_ids"].astype(np.int64), device=device),
        init_barys=f32(samples["tri_barys"]),
        init_points=f32(samples["points"]),
        init_rotations=matrix_to_quat(f32(samples["rotations"])),
    )
    skel = skel if skel is not None else toy_skeleton(3, seed, device=device)
    return geom, skinned_pose_fn(bind_points_skeleton(geom.template_verts, skel)), skel
