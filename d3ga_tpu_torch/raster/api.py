"""Public rasterizer API (counterpart of d3ga_tpu/raster/api.py): the
reference rasterizer's settings-and-call contract. Either packed 3D
covariances (the cage path) or scales + quaternions (the mesh path),
either SH coefficients or precomputed colours, a background colour, and
gradients from the pixels back to every Gaussian input.
"""

import dataclasses
from typing import Optional

import torch

from d3ga_tpu_torch.raster.camera import Camera
from d3ga_tpu_torch.raster.oracle import rasterize_oracle
from d3ga_tpu_torch.raster.tiles import rasterize_tiled, rasterize_tiled_fused

BACKENDS = ("tiled", "pallas", "fused", "oracle")


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    """Static rasterization knobs."""

    sh_degree: int = 0
    scale_modifier: float = 1.0
    antialiasing: bool = False
    max_per_tile: int = 256
    # "tiled" (the XLA blend), "pallas" (the hand-written blend kernels),
    # "fused" (the fused select + blend kernel K9), "oracle"
    backend: str = "tiled"
    # selection-funnel knobs (see tiles._select_per_tile)
    block_cap: int = 4096
    sub_block: int = 0
    sub_cap: int = 1024
    super_factor: int = 1
    coarse: str = "topk"
    dup: int = 2
    # dupsort_depth only: exact float32 depth order
    depth_exact: bool = True


def rasterize(
    camera: Camera,
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    bg_color: torch.Tensor,
    cov3d: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
    rotations: Optional[torch.Tensor] = None,
    colors: Optional[torch.Tensor] = None,
    shs: Optional[torch.Tensor] = None,
    settings: RasterSettings = RasterSettings(),
):
    """Render [C, H, W] and the RasterAux counters (None for the oracle).
    Exactly one of cov3d or (scales, rotations), and one of colors or
    shs."""
    if (cov3d is None) == (scales is None):
        raise ValueError("provide exactly one of cov3d or (scales, rotations)")
    if (colors is None) == (shs is None):
        raise ValueError("provide exactly one of colors or shs")
    if settings.backend not in BACKENDS:
        raise ValueError(f"unknown backend {settings.backend!r}")

    kwargs = dict(
        cov3d=cov3d, scales=scales, rotations=rotations, opacities=opacities, colors=colors,
        shs=shs, sh_degree=settings.sh_degree, scale_modifier=settings.scale_modifier,
        antialiasing=settings.antialiasing,
    )
    if settings.backend == "oracle":
        return rasterize_oracle(means3d, camera, bg_color, **kwargs), None
    if settings.backend == "fused":
        # as the JAX package: the fused path takes neither scale_modifier
        # nor antialiasing, and drops them silently (ROADMAP queue 3)
        kwargs.pop("scale_modifier")
        kwargs.pop("antialiasing")
        return rasterize_tiled_fused(
            means3d, camera, bg_color, max_per_tile=settings.max_per_tile, **kwargs
        )
    return rasterize_tiled(
        means3d, camera, bg_color, max_per_tile=settings.max_per_tile,
        use_pallas=settings.backend == "pallas", block_cap=settings.block_cap,
        sub_block=settings.sub_block, sub_cap=settings.sub_cap,
        super_factor=settings.super_factor, coarse=settings.coarse, dup=settings.dup,
        depth_exact=settings.depth_exact, **kwargs,
    )


def render(batch, pkg, bg_color, colors_precomp=None, detach=(), settings=None):
    """The reference's `render`: batch holds "camera" and "crop" (or
    None); pkg is a garment package with means3D, cov3D_precomp or scales
    + rotations, rgb or shs, opacities. detach names the inputs whose
    gradient stops ("position", "covariance", "opacity"). Returns
    {"render": [C, H', W'] cropped by `paste`, "aux": RasterAux}."""
    camera: Camera = batch["camera"]
    settings = settings or RasterSettings(sh_degree=int(pkg.get("sh_degree", 0)))

    means3d = pkg["means3D"]
    cov3d = pkg.get("cov3D_precomp")
    opacities = pkg["opacities"]
    shs = pkg.get("shs")
    if "position" in detach:
        means3d = means3d.detach()
    if "covariance" in detach and cov3d is not None:
        cov3d = cov3d.detach()
    if "opacity" in detach:
        opacities = opacities.detach()

    if colors_precomp is None:
        colors_precomp = pkg.get("rgb")
        if shs is not None:
            colors_precomp = None
    else:
        shs = None

    img, aux = rasterize(
        camera, means3d, opacities, bg_color, cov3d=cov3d, scales=pkg.get("scales"),
        rotations=pkg.get("rotations"), colors=colors_precomp, shs=shs, settings=settings,
    )
    crop = batch.get("crop")
    if crop is not None:
        img = paste(img, crop)
    return {"render": img, "aux": aux}


def paste(img, crop):
    """Crop a principal-point-centred render back to the original image;
    crop = [left, right, top, bottom, W, H] (Python numbers)."""
    left_w, right_w, top_h, bottom_h, W, H = crop
    W, H = int(W), int(H)
    img = img[:, :, :W] if left_w > right_w else img[:, :, -W:]
    return img[:, :H, :] if top_h > bottom_h else img[:, -H:, :]


def paste_from_canvas(img, crop):
    """`paste` for any principal-point-centred canvas: the principal point
    sits at the canvas centre, so the image occupies [centre - left,
    centre - left + W) x [centre - top, centre - top + H). Equals `paste`
    when the canvas is the frame's own 2 max(l, r) by 2 max(t, b)."""
    left_w, _, top_h, _, W, H = [int(v) for v in crop]
    rh, rw = img.shape[-2:]
    x0 = rw // 2 - left_w
    y0 = rh // 2 - top_h
    return img[..., y0 : y0 + H, x0 : x0 + W]
