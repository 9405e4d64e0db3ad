"""Mesh-primitive garment model, `primitive: "mesh"` (counterpart of
d3ga_tpu/model/mesh_model.py): Gaussians ride on the triangles of a
(subdivided) mesh through 3-vertex barycentrics; the rasterizer takes
scales + quaternions instead of a transported covariance, and there is no
FEM energy (fm_energy = 0).
"""

from typing import Callable, NamedTuple, Optional

import torch

from d3ga_tpu_torch.fields import mlp as F
from d3ga_tpu_torch.ops.knn import knn_mean_sq_dist
from d3ga_tpu_torch.ops.quaternion import quat_normalize


class MeshGeometry(NamedTuple):
    template_verts: torch.Tensor  # [V, 3] canonical (subdivided) mesh
    faces: torch.Tensor           # [F, 3] int64
    init_face_ids: torch.Tensor   # [N] int64 face per Gaussian
    init_barys: torch.Tensor      # [N, 3] triangle barycentrics
    init_points: torch.Tensor     # [N, 3]
    init_rotations: torch.Tensor  # [N, 4]
    gaussian_valid: Optional[torch.Tensor] = None


def init_mesh_params(
    gen, geometry: MeshGeometry, cond_dim: int, n_color_features: int = 64,
    color_in_dim=None, deform_cfg=None, canon_cfg=None, color_cfg=None,
):
    """Learned per-garment parameters, drawn from the host generator `gen`
    and placed on the geometry's device: the cage garment's, with a
    canonical field over 3 barycentrics."""
    deform_cfg = deform_cfg or {}
    canon_cfg = canon_cfg or {}
    color_cfg = color_cfg or {}
    device = geometry.init_points.device
    n = geometry.init_points.shape[0]
    dist2 = knn_mean_sq_dist(geometry.init_points, k=3)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    return {
        "colors_feat": (torch.rand(n, n_color_features, generator=gen) * 0.33).to(device),
        "rotation": geometry.init_rotations.clone(),
        "scaling": scales,
        "deformation_field": F.init_deformation_field(
            gen, cond_dim,
            n_hidden=deform_cfg.get("n_nodes", 128),
            n_layers=deform_cfg.get("n_layers", 3),
            device=device,
        ),
        "canonical_field": F.init_canonical_field(
            gen, cond_dim,
            n_hidden=canon_cfg.get("n_nodes", 128),
            n_layers=canon_cfg.get("n_layers", 3),
            bary_size=3,
            device=device,
        ),
        "color_field": F.init_color_field(
            gen,
            color_in_dim
            if color_in_dim is not None
            else F.color_field_input_dim(n_color_features, cond_dim),
            n_hidden=color_cfg.get("n_nodes", 128),
            n_layers=color_cfg.get("n_layers", 4),
            device=device,
        ),
    }


def mesh_forward(
    params,
    geometry: MeshGeometry,
    pose_verts: Callable[[Optional[torch.Tensor]], torch.Tensor],
    cond_deform,
    cond_canon,
    cond_color,
    camera_center,
    frame_encoding=None,
    camera_encoding=None,
    silhouette_color=(0.5, 0.5, 0.5),
    node_scale: float = 0.2,
    scale_bary: float = 0.25,
    use_pose: bool = True,
    use_view_enc: bool = True,
):
    """One mesh garment forward. pose_verts(delta) -> [V, 3] posed mesh
    vertices (delta applied before LBS; None poses the raw template).
    Returns the garment package dict: scales + rotations, no
    cov3D_precomp. Its canonical_means3D blends the POSED triangles with
    the initial barycentrics, as the JAX package's does."""
    input_points = pose_verts(None)

    delta_node = F.deformation_field(
        params["deformation_field"], geometry.template_verts, cond_deform, node_scale
    )
    rot_act = quat_normalize(params["rotation"])
    scales_act = torch.exp(params["scaling"])
    d_bary, d_rot, d_scale = F.canonical_field(
        params["canonical_field"], rot_act, scales_act, geometry.init_barys,
        cond_canon, scale_bary, bary_size=3,
    )

    points = pose_verts(delta_node)
    canon_barys = geometry.init_barys + d_bary
    scales = torch.exp(params["scaling"] + d_scale)
    rotations = quat_normalize(params["rotation"] + d_rot)

    tri = points[geometry.faces[geometry.init_face_ids]]  # [N, 3, 3]
    means3d = torch.einsum("nkj,nk->nj", tri, canon_barys)

    dirs = means3d - camera_center.detach()[None]
    viewdirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)

    rgb, opacities = F.color_field(
        params["color_field"],
        params["colors_feat"],
        pose=cond_color,
        viewdirs=viewdirs,
        frame_encoding=frame_encoding,
        camera_encoding=camera_encoding,
        use_pose=use_pose,
        use_view_enc=use_view_enc,
    )
    if geometry.gaussian_valid is not None:
        opacities = opacities * geometry.gaussian_valid[:, None]

    n = means3d.shape[0]
    return {
        "shs": None,
        "rgb": rgb,
        "scales": scales,
        "rotations": rotations,
        "opacities": opacities,
        "cov3D_precomp": None,
        "silhouette_rgb": means3d.new_tensor(silhouette_color).expand(n, 3),
        "means3D": means3d,
        "canonical_means3D": torch.einsum("nkj,nk->nj", tri, geometry.init_barys),
        "color_feat": params["colors_feat"],
        "fm_energy": means3d.new_zeros(1),
        "scale_energy": torch.mean(torch.mean(scales**2, dim=1))[None],
        "geometry": {
            "input_tetpoints": input_points,
            "canon_tetpoints": geometry.template_verts,
            "delta_node": delta_node.detach(),
            "deformed_tetpoints": points,
            "faces": geometry.faces,
        },
    }
