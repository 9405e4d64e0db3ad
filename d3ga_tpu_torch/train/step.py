"""The training step (counterpart of d3ga_tpu/train/step.py): forward,
one fused RGB + silhouette rasterization, loss assembly, optimizer update.

Loss assembly (the reference's `train.py:190-258` and
`models/trainer.py:91-140`):

  color = (1 - lambda_dssim) L1 + lambda_dssim (1 - SSIM)    * rgb_weight
  sil   = L1(pred_sil, coloured gt sil)                      * sil_weight
  code  = mean(frame_enc^2) * 1e-3
  scale = scale_energy * 175
  fme   = (mean fem + 3.0) * fme_weight

with a random background colour per step, drawn from the caller's
`torch.Generator` and handed to `render_frame`.

Ported: the fused branch (RGB and silhouette share one 6-channel raster
pass, with the model config's `raster_backend` and `raster_opts`: the
XLA blend or the hand-written kernels, any selection funnel, or the
fused select + blend kernel) and the gt composition,
with canvas padding (`pixel_valid`) and `boundary_fg`. Not ported yet,
each raising NotImplementedError naming its ROADMAP item: the non-fused
`detach_silhouette` branch, the background network, learnable blur,
pixel calibration, the random-noise background, the banded (sharded)
losses and the VGG term. `make_chained_step` (several steps in one
dispatch) is not ported yet either (same item).
"""

from typing import Dict, NamedTuple

import torch

from d3ga_tpu_torch.model.avatar import MODEL_TODO as TRAIN_TODO
from d3ga_tpu_torch.model.avatar import AvatarModel, avatar_forward, resolve_camera
from d3ga_tpu_torch.raster.tiles import rasterize_tiled, rasterize_tiled_fused
from d3ga_tpu_torch.train.losses import full_float32, l1_loss, masked_psnr, masked_ssim, ssim

# the model config's raster_opts that reach rasterize_tiled: the funnel
# and its knobs
RASTER_OPTS = ("coarse", "dup", "depth_exact", "block_cap", "sub_block", "sub_cap", "super_factor")


class LossWeights(NamedTuple):
    rgb_weight: float = 10.0
    sil_weight: float = 5.0
    fme_weight: float = 0.0025
    vgg_weight: float = 0.05
    blur_weight: float = 1e-5
    lambda_dssim: float = 0.2
    enable_vgg_from: int = 60_000


def _raster_opts(cfg):
    """The model config's rasterizer options as keywords of its rasterizer
    (`_rasterizer`), as the JAX package reads them: raster_backend "xla"
    (the default) blends with `_blend_tiles`, "pallas_blend" with the
    hand-written kernels, each with raster_opts' funnel (coarse "topk"
    and dup 2 unless given); "fused" takes none (the JAX package ignores
    raster_opts there, ROADMAP queue 3)."""
    backend = cfg.get("raster_backend", "xla")
    if backend == "fused":
        return {}
    if backend not in ("xla", "pallas_blend"):
        raise ValueError(f"raster_backend={backend!r}: expected 'xla', 'pallas_blend' or 'fused'")
    opts = dict(cfg.get("raster_opts", {}))
    unknown = set(opts) - set(RASTER_OPTS)
    if unknown:
        raise ValueError(f"raster_opts {sorted(unknown)}: expected a subset of {RASTER_OPTS}")
    return dict(opts, use_pallas=backend == "pallas_blend")


def _rasterizer(cfg):
    """(the rasterize function, its keywords) of the model config:
    `rasterize_tiled_fused` for raster_backend "fused", else
    `rasterize_tiled`."""
    fn = rasterize_tiled_fused if cfg.get("raster_backend") == "fused" else rasterize_tiled
    return fn, _raster_opts(cfg)


def render_frame(
    params,
    model: AvatarModel,
    batch,
    bg=None,
    training=True,
    max_per_tile=256,
    detach_silhouette=(),
    vgg_params=None,
    loss_weights: LossWeights = LossWeights(),
    iteration=0,
    band_ctx=None,
    plain=False,
):
    """Forward + one fused 6-channel rasterization + per-frame loss terms.

    bg: [3] background colour, required in training (the JAX package
    draws it from its rng here; the port's caller draws it). plain=True
    runs the raster kernels' plain versions, forward and backward.
    Returns (loss terms dict, aux dict with the images and counters)."""
    cfg = model.config
    for key in ("bg_net", "learnable_blur", "pixel_cal"):
        if key in params:
            raise NotImplementedError(f"{key}: {TRAIN_TODO}")
    if band_ctx is not None:
        raise NotImplementedError(f"banded losses: {TRAIN_TODO}")
    if cfg.get("use_random_bg", False):
        raise NotImplementedError(f"use_random_bg: {TRAIN_TODO}")
    if vgg_params is not None and loss_weights.enable_vgg_from > 0:
        raise NotImplementedError(f"the VGG term: {TRAIN_TODO}")
    rasterize, opts = _rasterizer(cfg)

    batch = dict(batch, iteration=iteration)
    batch = resolve_camera(params, model, batch, training=training)
    camera = batch["camera"]
    pkg = avatar_forward(params, model, batch, training=training)
    dev = pkg["means3D"].device

    if training:
        if bg is None:
            raise ValueError("render_frame(training=True) needs the background colour bg")
        bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    else:
        white = cfg.get("background", "white") == "white"
        bg = torch.full((3,), 1.0 if white else 0.0, device=dev)

    if detach_silhouette or pkg.get("rgb") is None:
        raise NotImplementedError(f"the non-fused silhouette pass: {TRAIN_TODO}")
    # one fused rasterization with 6 colour channels (RGB + silhouette)
    colors6 = torch.cat([pkg["rgb"], pkg["silhouette_rgb"]], -1)
    bg6 = torch.cat([bg, bg.new_zeros(3)])
    both, aux_rgb = rasterize(
        pkg["means3D"], camera, bg6, cov3d=pkg.get("cov3D_precomp"), scales=pkg.get("scales"),
        rotations=pkg.get("rotations"), opacities=pkg["opacities"], colors=colors6,
        max_per_tile=max_per_tile, plain=plain, **opts,
    )
    pred_image = both[:3]
    pred_sil = both[3:]

    # ground-truth composition (`train.py:181-189`)
    gt_alpha = batch["alpha"]
    if gt_alpha.ndim == 2:
        gt_alpha = gt_alpha[None]
    gt_alpha = torch.broadcast_to(gt_alpha, batch["image"].shape)
    if cfg.get("use_background", False) and "orig_image" in batch:
        gt_image = batch["orig_image"]
    else:
        gt_image = batch["image"] * gt_alpha + (1.0 - gt_alpha) * bg[:, None, None]
    gt_sil = batch["silhouette"] * gt_alpha
    if "boundary_fg" in batch:
        b = 1.0 - batch["boundary_fg"]
        gt_image = gt_image * b + (1.0 - b) * bg[:, None, None]
        gt_sil = gt_sil * b

    # canvas padding: padded pixels zeroed on both sides, means over the
    # real pixels
    pix_scale = 1.0
    valid_mask = batch.get("pixel_valid")
    if valid_mask is not None:
        m = valid_mask
        pred_image = pred_image * m
        gt_image = gt_image * m
        pred_sil = pred_sil * m
        gt_sil = gt_sil * m
        pix_scale = m.numel() / torch.clamp(torch.sum(m), min=1.0)

    lw = loss_weights
    rgb_l1 = l1_loss(pred_image, gt_image) * pix_scale
    if valid_mask is not None:
        rgb_ssim = masked_ssim(pred_image, gt_image, valid_mask)
    else:
        rgb_ssim = ssim(pred_image, gt_image)
    color = (1.0 - lw.lambda_dssim) * rgb_l1 + lw.lambda_dssim * (1.0 - rgb_ssim)
    sil_l1 = l1_loss(pred_sil, gt_sil) * pix_scale

    terms = {
        "color_loss": color * lw.rgb_weight,
        "sil_loss": sil_l1 * lw.sil_weight,
    }
    terms.update(_pkg_terms(pkg, lw))
    aux = {
        "pred_image": pred_image,
        "gt_image": gt_image,
        "pred_silhouette": pred_sil,
        "gt_silhouette": gt_sil,
        "raster_overflow": aux_rgb.overflow,
        "raster_visible_overflow": aux_rgb.visible_overflow,
        "raster_depth_ties": aux_rgb.depth_ties,
        "raster_clamp_overflow": aux_rgb.clamp_overflow,
        "psnr": masked_psnr(pred_image.detach(), gt_image.detach(), valid_mask),
    }
    return terms, aux


def _pkg_terms(pkg, lw: LossWeights) -> Dict[str, torch.Tensor]:
    """Loss terms of the garment package: the code regularizer
    (`train.py:205-212`), scale energy x175 (`train.py:219`), FEM + 3.0
    (`train.py:214-217`)."""
    code_reg = torch.mean(pkg["frame_encoding"] ** 2) * 0.001
    if pkg.get("optimizable_poses") is not None:
        code_reg = code_reg + torch.mean(pkg["optimizable_poses"] ** 2) * 0.0075
    return {
        "codes_reg": code_reg,
        "scale_loss": pkg["scale_energy"].mean() * 175.0,
        "fme_loss": (pkg["fm_energy"].mean() + 3.0) * lw.fme_weight,
    }


def total_loss(terms: Dict[str, torch.Tensor]) -> torch.Tensor:
    return sum(terms.values())


def random_bg(gen: torch.Generator, device) -> torch.Tensor:
    """The step's random background colour, [3] uniform in [0, 1)."""
    return torch.rand(3, generator=gen).to(device)


def make_train_step(
    model: AvatarModel,
    tx,
    max_per_tile: int = 256,
    detach_silhouette=(),
    vgg_params=None,
    loss_weights: LossWeights = LossWeights(),
    plain: bool = False,
):
    """The single-device training step over the parameters `tx` (a
    `train.optim.TreeAdam`) was made for:

        step(params, batch, gen, iteration) -> (params, metrics)

    draws the background from `gen`, renders, differentiates the total
    loss and updates the parameters in place; metrics are tensors (no
    host sync). `step.loss_and_grads(params, batch, bg, iteration) ->
    (loss, terms, aux, grads)` is the step without the draw and the
    update (grads in `tx.leaves` order, zeros for unused leaves).
    plain=True runs the raster kernels' plain versions."""

    def loss_and_grads(params, batch, bg, iteration):
        with full_float32():
            terms, aux = render_frame(
                params, model, batch, bg,
                training=True,
                max_per_tile=max_per_tile,
                detach_silhouette=detach_silhouette,
                vgg_params=vgg_params,
                loss_weights=loss_weights,
                iteration=iteration,
                plain=plain,
            )
            loss = total_loss(terms)
            grads = torch.autograd.grad(loss, tx.leaves, materialize_grads=True)
        return loss, terms, aux, grads

    def step(params, batch, gen, iteration):
        bg = random_bg(gen, tx.leaves[0].device)
        loss, terms, aux, grads = loss_and_grads(params, batch, bg, iteration)
        tx.step(grads)
        metrics = {k: v.detach() for k, v in terms.items()}
        metrics["total_loss"] = loss.detach()
        for k in ("psnr", "raster_overflow", "raster_visible_overflow",
                  "raster_depth_ties", "raster_clamp_overflow"):
            metrics[k] = aux[k]
        return params, metrics

    step.loss_and_grads = loss_and_grads
    return step
