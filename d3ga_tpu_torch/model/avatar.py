"""Composite avatar model: several cage garments + shared conditioners
(counterpart of d3ga_tpu/model/avatar.py), eval and training paths.

A static description (AvatarModel: geometries, pose closures, config)
plus a parameter tree (init_avatar, or one carried across from the JAX
package with `d3ga_tpu_torch.convert.params_from_numpy`);
`avatar_forward` is a plain function of both.

Options of the JAX model that are not ported yet raise
NotImplementedError naming their ROADMAP item instead of doing something
else: the mesh primitive, AO, the face decoder, optimizable poses and
global rotations / translations (and so `resolve_camera`'s camera
rebuild), SH colours, learnable blur / pixel bias / background network.
"""

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from d3ga_tpu_torch.fields import (
    apply_camera_calibration,
    embedding_average,
    embedding_lookup,
    init_camera_calibration,
    init_embedding,
)
from d3ga_tpu_torch.fields import mlp as F
from d3ga_tpu_torch.model.cage_model import cage_forward, init_cage_params

MERGE_KEYS = (
    "shs", "rgb", "opacities", "cov3D_precomp", "scales", "rotations",
    "silhouette_rgb", "means3D", "canonical_means3D", "color_feat",
    "fm_energy", "scale_energy",
)

MODEL_TODO = "not ported yet (ROADMAP.md, queue 1: 'Model forward, the rest')"

# config switches whose feature is not ported yet, with the item it waits for
_UNPORTED = {
    "use_shs": MODEL_TODO,
    "use_ao": MODEL_TODO,
    "use_face_emb": MODEL_TODO,
    "use_opt_smplx": MODEL_TODO,
    "use_blur": MODEL_TODO,
    "use_pixel_cal": MODEL_TODO,
    "use_bg_network": MODEL_TODO,
}
# per-frame optimizable pose / global rotation / translation tables
_OPTIMIZABLE = ("optimizable_poses", "optimizable_rotations", "optimizable_translations")


class GarmentSpec(NamedTuple):
    name: str
    geometry: Any  # CageGeometry
    # pose_nodes(batch, delta) -> [V, 3] posed cage nodes
    pose_nodes: Callable[[Dict[str, Any], Optional[torch.Tensor]], torch.Tensor]
    silhouette_color: tuple
    node_scale: float = 0.2
    primitive: str = "cage"


class AvatarModel(NamedTuple):
    garments: tuple
    cond_dim: int
    n_frames: int
    n_cameras: int
    config: Dict[str, Any]


def check_ported(model: AvatarModel):
    """Raise NotImplementedError for a configured feature the port lacks."""
    for g in model.garments:
        if g.primitive != "cage":
            raise NotImplementedError(f"{g.primitive} primitive: {MODEL_TODO}")
    for key, item in _UNPORTED.items():
        if model.config.get(key, False):
            raise NotImplementedError(f"{key}: {item}")


def init_avatar(gen: torch.Generator, model: AvatarModel):
    """Parameters drawn from the host generator `gen`, on the device of
    the garments' geometry."""
    check_ported(model)
    cfg = model.config
    device = model.garments[0].geometry.init_points.device
    params: Dict[str, Any] = {"garments": {}}
    for g in model.garments:
        params["garments"][g.name] = init_cage_params(
            gen,
            g.geometry,
            model.cond_dim,
            n_color_features=cfg.get("n_color_features", 64),
            color_in_dim=F.color_field_input_dim(
                cfg.get("n_color_features", 64),
                model.cond_dim,
                use_pose=cfg.get("use_pose", True),
                use_view_enc=cfg.get("use_view_enc", True),
                frame_dim=cfg.get("frame_embed_dim", 0),
                camera_dim=cfg.get("camera_embed_dim", 0),
            ),
            deform_cfg=cfg.get("deform_mlp"),
            canon_cfg=cfg.get("canon_mlp"),
            color_cfg=cfg.get("color_mlp"),
        )
    if cfg.get("frame_embed_dim", 0) > 0:
        params["frame_embeddings"] = init_embedding(
            gen, model.n_frames, cfg["frame_embed_dim"], device=device
        )
    if cfg.get("camera_embed_dim", 0) > 0:
        params["camera_embeddings"] = init_embedding(
            gen, model.n_cameras, cfg["camera_embed_dim"], device=device
        )
    if cfg.get("use_color_calib", True):
        params["camera_calib"] = init_camera_calibration(model.n_cameras, device=device)
    return params


def _merge(pkgs):
    """Concatenate per-garment packages."""
    out = {}
    for key in MERGE_KEYS:
        vals = [p[key] for _, p in pkgs if p.get(key) is not None]
        out[key] = torch.cat(vals, dim=0) if vals else None
    out["geometry"] = [dict(p["geometry"], name=name) for name, p in pkgs]
    return out


def avatar_forward(params, model: AvatarModel, batch, training: bool = False):
    """batch: dict with "lbs" [P] momentum pose params (or "smplx_poses"),
    "camera" (Camera), an int "camera_idx" and, in training, an int
    "frame_idx". Training looks up the frame's and camera's embedding
    codes and scales the calibration's gradient by 0.1; eval uses the mean
    codes. Returns the merged garment package."""
    check_ported(model)
    if training and any(k in params for k in _OPTIMIZABLE):
        raise NotImplementedError(f"optimizable poses / rotations / translations: {MODEL_TODO}")
    cfg = model.config
    camera = batch["camera"]

    if "smplx_poses" in batch:
        cond = batch["smplx_poses"][:87]
    else:
        cond = batch["lbs"][6:] if batch["lbs"].shape[-1] == 104 else batch["lbs"]

    frame_enc = camera_enc = None
    if "frame_embeddings" in params:
        frame_enc = (
            embedding_lookup(params["frame_embeddings"], batch["frame_idx"])
            if training
            else embedding_average(params["frame_embeddings"])
        )
    if "camera_embeddings" in params:
        camera_enc = (
            embedding_lookup(params["camera_embeddings"], batch["camera_idx"])
            if training
            else embedding_average(params["camera_embeddings"])
        )

    pkgs = []
    for g in model.garments:
        pkg = cage_forward(
            params["garments"][g.name],
            g.geometry,
            lambda delta, g=g: g.pose_nodes(batch, delta),
            cond_deform=cond,
            cond_canon=cond,
            cond_color=cond,
            camera_center=camera.camera_center,
            frame_encoding=frame_enc,
            camera_encoding=camera_enc,
            silhouette_color=g.silhouette_color,
            node_scale=g.node_scale,
            scale_bary=cfg.get("scale_bary", 0.25),
            tet_offset_pre_lbs=cfg.get("tet_offset_pre_lbs", True),
            use_pose=cfg.get("use_pose", True),
            use_view_enc=cfg.get("use_view_enc", True),
        )
        pkgs.append((g.name, pkg))

    merged = _merge(pkgs)
    merged["frame_encoding"] = (
        frame_enc if frame_enc is not None else camera.world_view.new_zeros(1)
    )
    merged["optimizable_poses"] = None
    if "camera_calib" in params and merged["rgb"] is not None:
        merged["rgb"] = apply_camera_calibration(
            params["camera_calib"], merged["rgb"], batch["camera_idx"],
            identity_idx=cfg.get("identity_camera_idx", 0),
            training=training,
        )
    return merged


def resolve_camera(params, model: AvatarModel, batch, training: bool = True):
    """The batch, with the camera rebuilt from the per-frame optimizable
    global rotation / translation when training has them and the batch
    carries the capture extrinsics ("cam_rt"); that rebuild is not ported
    yet and raises. Otherwise the batch unchanged."""
    if not training or "optimizable_rotations" not in params or "cam_rt" not in batch:
        return batch
    raise NotImplementedError(f"resolve_camera with optimizable Rh/Th: {MODEL_TODO}")
