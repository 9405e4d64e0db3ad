"""Cage garment model: tet-cage-embedded Gaussians with MLP fields
(counterpart of d3ga_tpu/model/cage_model.py).

  pose the cage (LBS, through a caller-supplied pose function) ->
  DeformationField node offsets (pre- or post-LBS) ->
  CanonicalField corrections of (barys, quats, scales) ->
  deformation gradient J = grad(deformed) @ grad(canonical)^-1 ->
  cov3D = J (R S S^T R^T) J^T ->
  Gaussian positions = barycentric blend of the deformed tet corners ->
  ColorField RGB/opacity (or SH coefficients) + Neo-Hookean / scale
  regularizers.
"""

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from d3ga_tpu_torch.fields import mlp as F
from d3ga_tpu_torch.geometry.tet import barycentric_blend, fem_energy, tet_gradient
from d3ga_tpu_torch.ops.covariance import (covariance_from_scaling_rotation, inverse_sigmoid,
                                           strip_symmetric)
from d3ga_tpu_torch.ops.knn import knn_mean_sq_dist
from d3ga_tpu_torch.ops.quaternion import matrix_to_quat, quat_normalize

SILHOUETTE_COLORS = {
    "red": (1.0, 0.0, 0.0),
    "green": (0.0, 1.0, 0.0),
    "blue": (0.0, 0.0, 1.0),
    "gray": (0.5, 0.5, 0.5),
}


class CageGeometry(NamedTuple):
    """Static per-cage buffers."""

    cage_points: torch.Tensor         # [V, 3] canonical tet nodes
    tetras: torch.Tensor              # [T, 4] int64
    triangles: torch.Tensor           # [F, 3] int64 surface triangles
    barys: torch.Tensor               # [N, 4] Gaussian tet barycentrics
    tetra_id: torch.Tensor            # [N] int64 containing tet
    canonical_grad_inv: torch.Tensor  # [N, 3, 3] inverse edge matrix at bind
    dn_inv: torch.Tensor              # [T, 3, 3] inverse template edge matrix
    init_points: torch.Tensor         # [N, 3]
    init_rotations: torch.Tensor      # [N, 4] TBN-frame init quats
    cage_to_body_vertex: Optional[torch.Tensor] = None  # [V] (AO path)
    gaussian_valid: Optional[torch.Tensor] = None       # [N] 0/1 padding mask


def build_cage_geometry(
    cage_points, tetras, triangles, sample_points, sample_rotations, cage_to_body_vertex=None,
    device="cuda",
) -> CageGeometry:
    """Host-side assembly: embeds the sampled Gaussians into tets and
    caches the inverse canonical gradients."""
    from d3ga_tpu_torch.geometry.embed import embed_points_in_tets

    barys, tetra_id, _ = embed_points_in_tets(
        np.asarray(sample_points), np.asarray(cage_points), np.asarray(tetras)
    )
    corners = np.asarray(cage_points, np.float32)[np.asarray(tetras)]
    grads = tet_gradient(torch.from_numpy(corners)).numpy()
    dn_inv = np.linalg.inv(grads)
    rots = torch.as_tensor(np.asarray(sample_rotations, np.float32))
    if rots.ndim == 3:
        rots = matrix_to_quat(rots)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return CageGeometry(
        cage_points=f32(cage_points),
        tetras=i64(tetras),
        triangles=i64(triangles),
        barys=f32(barys),
        tetra_id=i64(tetra_id),
        canonical_grad_inv=f32(dn_inv[tetra_id]),
        dn_inv=f32(dn_inv),
        init_points=f32(sample_points),
        init_rotations=rots.to(device),
        cage_to_body_vertex=None if cage_to_body_vertex is None else i64(cage_to_body_vertex),
    )


def init_cage_params(
    gen,
    geometry: CageGeometry,
    cond_dim: int,
    n_color_features: int = 64,
    use_shs: bool = False,
    max_sh_degree: int = 3,
    color_in_dim: Optional[int] = None,
    deform_cfg=None,
    canon_cfg=None,
    color_cfg=None,
):
    """Learned per-cage parameters, drawn from the host generator `gen`
    and placed on the geometry's device; with use_shs also the SH
    colours' coefficients (degree max_sh_degree) and opacities."""
    deform_cfg = deform_cfg or {}
    canon_cfg = canon_cfg or {}
    color_cfg = color_cfg or {}
    device = geometry.init_points.device
    n = geometry.init_points.shape[0]

    dist2 = knn_mean_sq_dist(geometry.init_points, k=3)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    params = {
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
    if use_shs:
        shs0 = torch.rand(n, 3, generator=gen) / 255.0
        k_sh = (max_sh_degree + 1) ** 2
        params["opacities"] = inverse_sigmoid(0.2 * torch.ones(n, 1)).to(device)
        params["features_dc"] = shs0[:, None, :].to(device)  # [N, 1, 3]
        params["features_rest"] = torch.zeros(n, k_sh - 1, 3, device=device)
    return params


def cage_forward(
    params,
    geometry: CageGeometry,
    pose_nodes: Callable[[Optional[torch.Tensor]], torch.Tensor],
    cond_deform: torch.Tensor,
    cond_canon: torch.Tensor,
    cond_color: torch.Tensor,
    camera_center: torch.Tensor,
    frame_encoding=None,
    camera_encoding=None,
    pred_ao=None,
    silhouette_color=(0.5, 0.5, 0.5),
    node_scale: float = 0.2,
    scale_bary: float = 0.25,
    tet_offset_pre_lbs: bool = True,
    use_shs: bool = False,
    use_pose: bool = True,
    use_view_enc: bool = True,
):
    """One garment forward. pose_nodes(delta) -> [V, 3] posed cage nodes
    (delta applied before LBS; None poses the raw template). pred_ao: [B]
    per-body-vertex AO, blended to the Gaussians through the cage's
    `cage_to_body_vertex` as the colour field's shadow input. use_shs
    returns SH coefficients ("shs") and learned opacities, and no "rgb".
    Returns the garment package dict."""
    input_nodes = pose_nodes(None)

    delta_node = F.deformation_field(
        params["deformation_field"], geometry.cage_points, cond_deform, node_scale
    )
    rot_act = quat_normalize(params["rotation"])
    scales_act = torch.exp(params["scaling"])
    d_bary, d_rot, d_scale = F.canonical_field(
        params["canonical_field"], rot_act, scales_act, geometry.barys,
        cond_canon, scale_bary,
    )

    if tet_offset_pre_lbs:
        nodes = pose_nodes(delta_node)
    else:
        nodes = input_nodes + delta_node

    canon_barys = geometry.barys + d_bary
    scales = torch.exp(params["scaling"] + d_scale)
    rotation = quat_normalize(params["rotation"] + d_rot)

    per_g = nodes[geometry.tetras][geometry.tetra_id]  # [N, 4, 3]
    J = tet_gradient(per_g) @ geometry.canonical_grad_inv
    sigma = covariance_from_scaling_rotation(scales, rotation)
    cov3d = J @ sigma @ J.transpose(-1, -2)

    fm = fem_energy(nodes, geometry.tetras, geometry.dn_inv)
    scale_energy = torch.mean(torch.mean(scales**2, dim=1))[None]

    means3d = barycentric_blend(per_g, canon_barys)
    dirs = means3d - camera_center.detach()[None]
    viewdirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)

    shadow = None
    if pred_ao is not None and geometry.cage_to_body_vertex is not None:
        ao_nodes = pred_ao[geometry.cage_to_body_vertex][:, None]  # [V, 1]
        ao_per_g = ao_nodes[geometry.tetras][geometry.tetra_id]  # [N, 4, 1]
        shadow = torch.einsum("nkj,nk->nj", ao_per_g, canon_barys)

    n = means3d.shape[0]
    sil = means3d.new_tensor(silhouette_color).expand(n, 3)
    shs = rgb = None
    if use_shs:
        shs = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
        opacities = torch.sigmoid(params["opacities"])
    else:
        rgb, opacities = F.color_field(
            params["color_field"],
            params["colors_feat"],
            pose=cond_color,
            viewdirs=viewdirs,
            frame_encoding=frame_encoding,
            camera_encoding=camera_encoding,
            shadow=shadow,
            use_pose=use_pose,
            use_view_enc=use_view_enc,
        )
    if geometry.gaussian_valid is not None:
        opacities = opacities * geometry.gaussian_valid[:, None]

    canon_per_g = geometry.cage_points[geometry.tetras][geometry.tetra_id]
    return {
        "shs": shs,
        "rgb": rgb,
        "opacities": opacities,
        "cov3D_precomp": strip_symmetric(cov3d),
        "silhouette_rgb": sil,
        "means3D": means3d,
        "canonical_means3D": barycentric_blend(canon_per_g, geometry.barys),
        "color_feat": params["colors_feat"],
        "fm_energy": torch.mean(fm)[None],
        "scale_energy": scale_energy,
        "geometry": {
            "input_tetpoints": input_nodes,
            "canon_tetpoints": geometry.cage_points,
            "delta_node": delta_node.detach(),
            "deformed_tetpoints": nodes,
            "faces": geometry.triangles,
        },
    }
