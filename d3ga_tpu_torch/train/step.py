"""The training step (counterpart of d3ga_tpu/train/step.py): forward,
one fused RGB + silhouette rasterization, loss assembly, optimizer update.

Loss assembly (the reference's `train.py:190-258` and
`models/trainer.py:91-140`):

  color = (1 - lambda_dssim) L1 + lambda_dssim (1 - SSIM)    * rgb_weight
  sil   = L1(pred_sil, coloured gt sil)                      * sil_weight
  code  = mean(frame_enc^2) * 1e-3 + mean(opt_poses^2) * 7.5e-3
  scale = scale_energy * 175
  fme   = (mean fem + 3.0) * fme_weight
  blur  = |blur_raw - 1|.mean() * blur_weight
  vgg   = VGG19 perceptual * vgg_weight          (after enable_vgg_from)

with a random background colour per step. The JAX package draws its
randomness here from its rng; the port's caller draws it (`make_train_step`
from its `torch.Generator`) and hands it to `render_frame`: the
background colour, the uniform noise of the blurred-noise background
target and the VGG crop's offsets.

Ported: the fused branch (RGB and silhouette share one 6-channel raster
pass, with the model config's `raster_backend` and `raster_opts`: the
XLA blend or the hand-written kernels, any selection funnel, or the
fused select + blend kernel) and the two-pass branch (an image pass, SH
colours at `sh_degree` where the package has no RGB, then a silhouette
pass on a zero background with the inputs `detach_silhouette` names
detached; `("none",)` forces it without detaching), the gt composition
with canvas padding (`pixel_valid`) and `boundary_fg`, the background
network (composited through the raster's alpha), learnable blur, the
pixel bias, the blurred-noise background target (`use_random_bg`, or a
bg net before `enable_bg`), the optimizable poses and global pose
(through `resolve_camera`) and the VGG term. The banded (sharded)
losses (`band_ctx`) raise NotImplementedError naming their ROADMAP item;
`make_chained_step` (several steps in one dispatch) is not ported.
"""

from typing import Dict, NamedTuple

import torch

from d3ga_tpu_torch.fields.background import (apply_background, blur_noise,
                                              composite_background)
from d3ga_tpu_torch.fields.blur import apply_learnable_blur, blur_reg
from d3ga_tpu_torch.fields.pixel_bias import apply_pixel_bias
from d3ga_tpu_torch.model.avatar import AvatarModel, avatar_forward, resolve_camera
from d3ga_tpu_torch.raster.tiles import rasterize_tiled, rasterize_tiled_fused
from d3ga_tpu_torch.train.losses import (full_float32, l1_loss, masked_psnr, masked_ssim, ssim,
                                         vgg_crop, vgg_loss)

# the model config's raster_opts that reach rasterize_tiled: the funnel
# and its knobs
RASTER_OPTS = ("coarse", "dup", "depth_exact", "block_cap", "sub_block", "sub_cap", "super_factor")
BAND_TODO = "not ported yet (ROADMAP.md, queue 1: 'The sharded training step')"


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


def needs_noise(params, cfg) -> bool:
    """Whether `render_frame` builds the blurred-noise background target
    (and so takes a noise draw): under use_random_bg, or with a bg net and
    enable_bg > 0."""
    return cfg.get("use_random_bg", False) or (
        "bg_net" in params and int(cfg.get("enable_bg", 0)) > 0)


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
    sh_degree: int = 0,
    band_ctx=None,
    plain=False,
    noise=None,
    crop=None,
):
    """Forward + rasterization (one fused 6-channel pass, or an image pass
    and a silhouette pass where `detach_silhouette` names inputs or the
    package has SH colours, evaluated at sh_degree) + per-frame loss
    terms.

    bg: [3] background colour, required in training. noise: [3, H, W]
    uniform in [0, 1), required where `needs_noise` (blurred here, as
    the JAX package blurs its draw). crop: the VGG crop's (row, column)
    offsets (`train.losses.vgg_crop`'s ranges), None for no crop. The
    JAX package draws all three from its rng here; the port's caller
    draws them. plain=True runs the raster kernels' plain versions,
    forward and backward. Returns (loss terms dict, aux dict with the
    images and counters)."""
    cfg = model.config
    if band_ctx is not None:
        raise NotImplementedError(f"banded losses: {BAND_TODO}")
    rasterize, opts = _rasterizer(cfg)

    batch = dict(batch, iteration=iteration)
    batch = resolve_camera(params, model, batch, training=training)
    camera = batch["camera"]
    pkg = avatar_forward(params, model, batch, training=training)
    dev = pkg["means3D"].device
    cam_idx = batch["camera_idx"]

    if training:
        if bg is None:
            raise ValueError("render_frame(training=True) needs the background colour bg")
        bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    else:
        white = cfg.get("background", "white") == "white"
        bg = torch.full((3,), 1.0 if white else 0.0, device=dev)

    # the per-camera learnable background, composited through the
    # raster's background transmittance
    bg_map = None
    if "bg_net" in params:
        bg_map = apply_background(params["bg_net"], cam_idx, camera.height, camera.width)

    kw = dict(max_per_tile=max_per_tile, plain=plain, **opts)
    if not detach_silhouette and pkg.get("rgb") is not None:
        # one fused rasterization with 6 colour channels (RGB + silhouette)
        colors6 = torch.cat([pkg["rgb"], pkg["silhouette_rgb"]], -1)
        bg6 = torch.cat([bg, bg.new_zeros(3)])
        out = rasterize(
            pkg["means3D"], camera, bg6, cov3d=pkg.get("cov3D_precomp"),
            scales=pkg.get("scales"), rotations=pkg.get("rotations"), opacities=pkg["opacities"],
            colors=colors6, return_alpha=bg_map is not None, **kw,
        )
        pred_image, pred_sil = out[0][:3], out[0][3:]
    else:
        out = rasterize(
            pkg["means3D"], camera, bg, cov3d=pkg.get("cov3D_precomp"), scales=pkg.get("scales"),
            rotations=pkg.get("rotations"), opacities=pkg["opacities"], colors=pkg["rgb"],
            shs=pkg["shs"] if pkg.get("rgb") is None else None, sh_degree=sh_degree,
            return_alpha=bg_map is not None, **kw,
        )
        pred_image = out[0]
        # the silhouette pass, with the named inputs detached (the JAX
        # package detaches neither scales nor rotations)
        sil_means, sil_cov, sil_opac = pkg["means3D"], pkg.get("cov3D_precomp"), pkg["opacities"]
        if "position" in detach_silhouette:
            sil_means = sil_means.detach()
        if "covariance" in detach_silhouette and sil_cov is not None:
            sil_cov = sil_cov.detach()
        if "opacity" in detach_silhouette:
            sil_opac = sil_opac.detach()
        pred_sil = rasterize(
            sil_means, camera, bg.new_zeros(3), cov3d=sil_cov, scales=pkg.get("scales"),
            rotations=pkg.get("rotations"), opacities=sil_opac, colors=pkg["silhouette_rgb"], **kw,
        )[0]
    aux_rgb = out[-1]
    if bg_map is not None:
        pred_image = composite_background(pred_image, 1.0 - out[1], bg_map, bg)

    blur_weights = None
    if "learnable_blur" in params:
        pred_image = apply_learnable_blur(params["learnable_blur"], pred_image, cam_idx)
        blur_weights = blur_reg(params["learnable_blur"], cam_idx)
    if "pixel_cal" in params:
        pred_image = pred_image + apply_pixel_bias(params["pixel_cal"], cam_idx,
                                                   pred_image.shape[1], pred_image.shape[2])

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

    # the blurred-noise background target while the bg net warms up or
    # under use_random_bg: the gt's background region becomes blurred
    # noise, composited with the original image's foreground
    if needs_noise(params, cfg):
        if noise is None:
            raise ValueError("render_frame: this config's noise target needs its uniform draw, "
                             "noise")
        with torch.no_grad():
            n = blur_noise(torch.as_tensor(noise, dtype=torch.float32, device=dev))
            if "learnable_blur" in params:
                n = apply_learnable_blur(params["learnable_blur"], n, cam_idx)
        orig = batch.get("orig_image", batch["image"])
        active = cfg.get("use_random_bg", False) or (
            bg_map is not None and iteration < int(cfg.get("enable_bg", 0)))
        if active:
            gt_image = (1.0 - gt_alpha) * n + gt_alpha * orig

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
    if blur_weights is not None:
        terms["blur_loss"] = torch.mean(torch.abs(blur_weights - 1.0)) * lw.blur_weight
    if vgg_params is not None and lw.enable_vgg_from > 0:
        # counted once iteration > enable_vgg_from (JAX computes it and
        # multiplies by 0 before; the value and gradient are the same)
        terms["vgg_loss"] = (vgg_loss(vgg_params, pred_image, gt_image, crop=crop) * lw.vgg_weight
                             if iteration > lw.enable_vgg_from else pred_image.new_zeros(()))
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


def random_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    """The step's uniform draw for the blurred-noise background target,
    `shape` [3, H, W] in [0, 1), on the generator's device."""
    return torch.rand(tuple(shape), generator=gen, device=gen.device).to(device)


def random_crop(gen: torch.Generator, shape, crop_size=512):
    """The VGG crop's (row, column) offsets for an image of `shape`,
    uniform over `vgg_crop`'s ranges; None where no crop is cut."""
    ranges = vgg_crop(shape, crop_size)
    if ranges is None:
        return None
    return tuple(int(torch.randint(0, n + 1, (1,), generator=gen)) for n in ranges)


def make_train_step(
    model: AvatarModel,
    tx,
    max_per_tile: int = 256,
    detach_silhouette=(),
    vgg_params=None,
    loss_weights: LossWeights = LossWeights(),
    plain: bool = False,
    sh_degree: int = 0,
):
    """The single-device training step over the parameters `tx` (a
    `train.optim.TreeAdam`) was made for, with SH colours evaluated at
    sh_degree (a step is made per degree, as the JAX package rebuilds its
    step for `train.py`'s ramp min(iteration // 1000, max_sh_degree)):

        step(params, batch, gen, iteration) -> (params, metrics)

    draws the background colour, and where the config needs them the
    noise target's uniform draw (`needs_noise`) and the VGG crop's
    offsets (`vgg_params` given), from `gen`; renders, differentiates
    the total loss and updates the parameters in place; metrics are
    tensors (no host sync). `step.loss_and_grads(params, batch, bg,
    iteration, noise=None, crop=None) -> (loss, terms, aux, grads)` is
    the step without the draws and the update (grads in `tx.leaves`
    order, zeros for unused leaves); `step.loss_and_aux(...) -> (loss,
    terms, aux)` the same without the gradients, its graph kept (aux's
    images are the ones the image losses read). plain=True runs the
    raster kernels' plain versions."""

    def loss_and_aux(params, batch, bg, iteration, noise=None, crop=None):
        terms, aux = render_frame(
            params, model, batch, bg,
            training=True,
            max_per_tile=max_per_tile,
            detach_silhouette=detach_silhouette,
            vgg_params=vgg_params,
            loss_weights=loss_weights,
            iteration=iteration,
            sh_degree=sh_degree,
            plain=plain,
            noise=noise,
            crop=crop,
        )
        return total_loss(terms), terms, aux

    def loss_and_grads(params, batch, bg, iteration, noise=None, crop=None):
        with full_float32():
            loss, terms, aux = loss_and_aux(params, batch, bg, iteration, noise, crop)
            grads = torch.autograd.grad(loss, tx.leaves, materialize_grads=True)
        return loss, terms, aux, grads

    def step(params, batch, gen, iteration):
        dev = tx.leaves[0].device
        bg = random_bg(gen, dev)
        shape = batch["image"].shape
        noise = random_noise(gen, shape, dev) if needs_noise(params, model.config) else None
        crop = random_crop(gen, shape) if vgg_params is not None else None
        loss, terms, aux, grads = loss_and_grads(params, batch, bg, iteration, noise, crop)
        tx.step(grads)
        metrics = {k: v.detach() for k, v in terms.items()}
        metrics["total_loss"] = loss.detach()
        for k in ("psnr", "raster_overflow", "raster_visible_overflow",
                  "raster_depth_ties", "raster_clamp_overflow"):
            metrics[k] = aux[k]
        return params, metrics

    step.loss_and_grads = loss_and_grads
    step.loss_and_aux = loss_and_aux
    return step
