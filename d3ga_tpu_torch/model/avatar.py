"""Composite avatar model: several cage (or mesh) garments + shared
conditioners (counterpart of d3ga_tpu/model/avatar.py), eval and
training paths.

A static description (AvatarModel: geometries, pose closures, config)
plus a parameter tree (init_avatar, or one carried across from the JAX
package with `d3ga_tpu_torch.convert.params_from_numpy`);
`avatar_forward` is a plain function of both.

Every option of the JAX model is ported: SH colours (`use_shs`), the AO
shadow decoder (`use_ao`), the face-keypoint embedding (`use_face_emb`,
conditioning the garment named "face"), the mesh primitive, the colour
calibration, frame and camera embeddings, learnable blur, pixel bias and
background network (their parameters here, applied by
`train/step.py::render_frame`), and the optimizable per-frame poses and
global rotations / translations, with `resolve_camera`'s differentiable
camera rebuild.
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
from d3ga_tpu_torch.body.drivers import smplx_camera_to_world
from d3ga_tpu_torch.fields import mlp as F
from d3ga_tpu_torch.fields.background import init_background_model
from d3ga_tpu_torch.fields.blur import init_learnable_blur
from d3ga_tpu_torch.fields.pixel_bias import init_pixel_bias
from d3ga_tpu_torch.model.cage_model import cage_forward, init_cage_params
from d3ga_tpu_torch.model.mesh_model import init_mesh_params, mesh_forward
from d3ga_tpu_torch.raster.camera import camera_from_c2w

MERGE_KEYS = (
    "shs", "rgb", "opacities", "cov3D_precomp", "scales", "rotations",
    "silhouette_rgb", "means3D", "canonical_means3D", "color_feat",
    "fm_energy", "scale_energy",
)

PRIMITIVES = ("cage", "mesh")
# the optimizable poses and global pose are frozen after this many iterations
FREEZE_AFTER = 400_000


class GarmentSpec(NamedTuple):
    name: str
    geometry: Any  # CageGeometry or MeshGeometry
    # pose_nodes(batch, delta) -> [V, 3] posed cage nodes / mesh vertices
    pose_nodes: Callable[[Dict[str, Any], Optional[torch.Tensor]], torch.Tensor]
    silhouette_color: tuple
    node_scale: float = 0.2
    primitive: str = "cage"  # or "mesh"


class AvatarModel(NamedTuple):
    garments: tuple
    cond_dim: int
    n_frames: int
    n_cameras: int
    config: Dict[str, Any]


def check_ported(model: AvatarModel):
    """Raise ValueError unless every garment has one primitive of
    PRIMITIVES, the same for all: cage and mesh packages carry different
    covariance inputs and cannot share one rasterization."""
    prims = {g.primitive for g in model.garments}
    if len(prims) != 1 or not prims <= set(PRIMITIVES):
        raise ValueError(f"all garments must share one primitive of {PRIMITIVES}, got {prims}")


def init_avatar(gen: torch.Generator, model: AvatarModel, init_smplx_poses=None,
                init_smplx_rh=None, init_smplx_th=None):
    """Parameters drawn from the host generator `gen`, on the device of
    the garments' geometry. With `use_opt_smplx`, init_smplx_poses
    [n_frames, P] become the optimizable per-frame poses, and
    init_smplx_rh / _th [n_frames, 3] the optimizable global rotation
    (axis-angle) and translation that `resolve_camera` rebuilds the
    camera from."""
    cfg = model.config
    device = model.garments[0].geometry.init_points.device
    params: Dict[str, Any] = {"garments": {}}
    if cfg.get("use_opt_smplx", False) and init_smplx_poses is not None:
        for key, v in (("optimizable_poses", init_smplx_poses),
                       ("optimizable_rotations", init_smplx_rh),
                       ("optimizable_translations", init_smplx_th)):
            if v is not None:
                params[key] = torch.as_tensor(v, dtype=torch.float32, device=device).clone()
    color_in_dim = F.color_field_input_dim(
        cfg.get("n_color_features", 64),
        model.cond_dim,
        use_pose=cfg.get("use_pose", True),
        use_view_enc=cfg.get("use_view_enc", True),
        frame_dim=cfg.get("frame_embed_dim", 0),
        camera_dim=cfg.get("camera_embed_dim", 0),
    )
    mlp_cfgs = dict(deform_cfg=cfg.get("deform_mlp"), canon_cfg=cfg.get("canon_mlp"),
                    color_cfg=cfg.get("color_mlp"))
    for g in model.garments:
        if g.primitive == "mesh":
            params["garments"][g.name] = init_mesh_params(
                gen, g.geometry, model.cond_dim, n_color_features=cfg.get("n_color_features", 64),
                color_in_dim=color_in_dim, **mlp_cfgs,
            )
            continue
        params["garments"][g.name] = init_cage_params(
            gen,
            g.geometry,
            model.cond_dim,
            n_color_features=cfg.get("n_color_features", 64),
            use_shs=cfg.get("use_shs", False),
            max_sh_degree=cfg.get("max_sh_degree", 3),
            # the AO shadow is one more input of the cage's colour field
            color_in_dim=color_in_dim + (1 if cfg.get("use_ao", False) else 0),
            **mlp_cfgs,
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
    size = (cfg.get("image_height", 1024), cfg.get("image_width", 667))
    if cfg.get("use_blur", False):
        params["learnable_blur"] = init_learnable_blur(model.n_cameras, device=device)
    if cfg.get("use_pixel_cal", False):
        params["pixel_cal"] = init_pixel_bias(model.n_cameras, *size, device=device)
    if cfg.get("use_bg_network", False):
        params["bg_net"] = init_background_model(model.n_cameras, *size, device=device)
    if cfg.get("use_ao", False):
        params["shadow_decoder"] = F.init_shadow_decoder(gen, device=device)
    if cfg.get("use_face_emb", False):
        params["face_decoder"] = F.init_face_decoder(
            gen, cfg["n_valid_kpts"], n_output=cfg.get("face_embed_dim", 128), device=device
        )
    return params


def _merge(pkgs):
    """Concatenate per-garment packages."""
    out = {}
    for key in MERGE_KEYS:
        vals = [p[key] for p in pkgs if p.get(key) is not None]
        out[key] = torch.cat(vals, dim=0) if vals else None
    out["geometry"] = [dict(p["geometry"], name=name) for name, p in pkgs_named(pkgs)]
    return out


def pkgs_named(pkgs):
    """(garment name, package) of each package `avatar_forward` made."""
    return [(p["__name__"], p) for p in pkgs]


def eval_layer(params, model: AvatarModel, batch, names, training=False):
    """The merged package of the named garment layers only."""
    sub = model._replace(garments=tuple(g for g in model.garments if g.name in names))
    return avatar_forward(params, sub, batch, training=training)


def _freeze_after(p, iteration, limit=FREEZE_AFTER):
    """p, without its gradient once iteration > limit."""
    return p.detach() if int(iteration) > limit else p


def avatar_forward(params, model: AvatarModel, batch, training: bool = True):
    """batch: dict with "lbs" [P] momentum pose params (or "smplx_poses"),
    "camera" (Camera), an int "camera_idx" and, in training, an int
    "frame_idx" (and "iteration"); with the AO decoder "template_pe"
    (the body template's positional encoding), with the face decoder
    "face_kpt_canonical" [n_valid_kpts, 3]. Training (the default, as the
    JAX package's) looks up the frame's and camera's embedding codes,
    scales the calibration's gradient by 0.1 and, with optimizable poses,
    conditions on the frame's pose (frozen after FREEZE_AFTER
    iterations); eval (training=False) uses the mean codes and the
    batch's pose. Returns the merged garment package."""
    check_ported(model)
    cfg = model.config
    camera = batch["camera"]

    opt_poses = None
    if "optimizable_poses" in params and training:
        opt_poses = _freeze_after(params["optimizable_poses"][int(batch["frame_idx"])],
                                  batch.get("iteration", 0))
        batch = dict(batch, smplx_poses=opt_poses)

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

    pred_ao = None
    if "shadow_decoder" in params and "template_pe" in batch:
        pred_ao = F.shadow_decoder(params["shadow_decoder"], batch["lbs"],
                                   batch["template_pe"])[:, 0]

    face_embs = None
    if "face_decoder" in params and "face_kpt_canonical" in batch:
        face_embs = F.face_decoder(params["face_decoder"], batch["face_kpt_canonical"])

    pkgs = []
    for g in model.garments:
        gcond = face_embs if g.name == "face" and face_embs is not None else cond
        common = dict(
            cond_deform=gcond,
            cond_canon=gcond,
            cond_color=gcond,
            camera_center=camera.camera_center,
            frame_encoding=frame_enc,
            camera_encoding=camera_enc,
            silhouette_color=g.silhouette_color,
            node_scale=g.node_scale,
            scale_bary=cfg.get("scale_bary", 0.25),
            use_pose=cfg.get("use_pose", True),
            use_view_enc=cfg.get("use_view_enc", True),
        )
        pose = lambda delta, g=g: g.pose_nodes(batch, delta)  # noqa: E731
        if g.primitive == "mesh":
            pkg = mesh_forward(params["garments"][g.name], g.geometry, pose, **common)
        else:
            pkg = cage_forward(
                params["garments"][g.name], g.geometry, pose, pred_ao=pred_ao,
                tet_offset_pre_lbs=cfg.get("tet_offset_pre_lbs", True),
                use_shs=cfg.get("use_shs", False), **common,
            )
        pkg["__name__"] = g.name
        pkgs.append(pkg)

    merged = _merge(pkgs)
    merged["frame_encoding"] = (
        frame_enc if frame_enc is not None else camera.world_view.new_zeros(1)
    )
    merged["optimizable_poses"] = opt_poses
    if "camera_calib" in params and merged["rgb"] is not None:
        merged["rgb"] = apply_camera_calibration(
            params["camera_calib"], merged["rgb"], batch["camera_idx"],
            identity_idx=cfg.get("identity_camera_idx", 0),
            training=training,
        )
    return merged


def resolve_camera(params, model: AvatarModel, batch, training: bool = True):
    """The batch, with the camera rebuilt from the frame's optimizable
    global rotation / translation when training has them and the batch
    carries the capture extrinsics ("cam_rt", world -> capture camera):
    `smplx_camera_to_world` then `camera_from_c2w`, so dL/dRh and dL/dTh
    reach them through the rasterizer (frozen after FREEZE_AFTER
    iterations). Otherwise the batch unchanged."""
    if not training or "optimizable_rotations" not in params or "cam_rt" not in batch:
        return batch
    fi, it = int(batch["frame_idx"]), batch.get("iteration", 0)
    rh = _freeze_after(params["optimizable_rotations"][fi], it)
    th = _freeze_after(params["optimizable_translations"][fi], it)
    c2w = smplx_camera_to_world(rh, th, batch["cam_rt"], mocap=model.config.get("mocap", True))
    cam0 = batch["camera"]
    cam = camera_from_c2w(c2w, cam0.tanfovx, cam0.tanfovy, cam0.width, cam0.height)
    return dict(batch, camera=cam)
