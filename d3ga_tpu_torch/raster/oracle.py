"""Reference ("oracle") Gaussian-splat rasterizer in plain PyTorch
(counterpart of d3ga_tpu/raster/oracle.py).

Slow but exact: per pixel, every Gaussian in depth order (a stable depth
sort, invalid ones last), with the CUDA rasterizer's rules: the tile-rect
gating of the tile-binned renderer, alpha = min(0.99, opacity *
exp(power)) used where power <= 0 and alpha >= 1/255, and front-to-back
blending that stops before the Gaussian that would take the
transmittance below 1e-4. The blend is an exclusive cumulative product
over the depth-sorted Gaussians, so autograd gives the pixel-to-Gaussian
backward. The port's small-scene ground truth: memory is [pixels of
`row_chunk` rows, N] per chunk.
"""

import torch

from d3ga_tpu_torch.raster.camera import Camera
from d3ga_tpu_torch.raster.project import Projected, project_gaussians, tile_rect

TILE = 16
ALPHA_SKIP = 1.0 / 255.0
T_EPS = 1e-4
ALPHA_MAX = 0.99


def blend_weights(alpha: torch.Tensor):
    """alpha [..., K] effective alphas in depth order -> (w [..., K],
    T_bg [...]): w_k = T_before_k * alpha_k where the transmittance after
    it stays >= 1e-4 (0 from there on), T_bg the transmittance left for
    the background."""
    t_after = torch.cumprod(1.0 - alpha, dim=-1)
    t_before = torch.cat([torch.ones_like(t_after[..., :1]), t_after[..., :-1]], dim=-1)
    accept = t_after >= T_EPS
    w = t_before * alpha * accept
    t_bg = torch.prod(1.0 - alpha * accept, dim=-1)
    return w, t_bg


def _pixel_alphas(proj: Projected, order, px, py, n_tiles_x, n_tiles_y):
    """Effective alpha of each depth-sorted Gaussian at pixels (px, py)
    [P] -> [P, N] (0 where skipped)."""
    xy = proj.xy[order]
    conic = proj.conic[order]
    opac = proj.opacity[order]
    valid = proj.valid[order] & (proj.radius[order] > 0)
    rects = tile_rect(proj.xy, proj.radius, TILE, n_tiles_x, n_tiles_y)
    xmin, xmax, ymin, ymax = (r[order] for r in rects)

    tx = px // TILE
    ty = py // TILE
    in_rect = (
        (tx[:, None] >= xmin[None, :])
        & (tx[:, None] < xmax[None, :])
        & (ty[:, None] >= ymin[None, :])
        & (ty[:, None] < ymax[None, :])
    )
    dx = xy[None, :, 0] - px[:, None].to(xy.dtype)
    dy = xy[None, :, 1] - py[:, None].to(xy.dtype)
    power = (
        -0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy)
        - conic[None, :, 1] * dx * dy
    )
    alpha = torch.minimum(xy.new_tensor(ALPHA_MAX), opac[None, :] * torch.exp(power))
    use = in_rect & valid[None, :] & (power <= 0.0) & (alpha >= ALPHA_SKIP)
    return torch.where(use, alpha, 0.0)


def rasterize_oracle(
    means3d,
    camera: Camera,
    bg_color,
    cov3d=None,
    scales=None,
    rotations=None,
    opacities=None,
    colors=None,
    shs=None,
    sh_degree: int = 0,
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
    row_chunk: int = 16,
):
    """Render [C, H, W], differentiable in every Gaussian input; bg_color
    [C]. Pixels go `row_chunk` image rows at a time."""
    H, W = camera.height, camera.width
    proj = project_gaussians(
        means3d, camera, cov3d=cov3d, scales=scales, rotations=rotations, opacities=opacities,
        colors=colors, shs=shs, sh_degree=sh_degree, scale_modifier=scale_modifier,
        antialiasing=antialiasing,
    )
    n_tiles_x = -(-W // TILE)
    n_tiles_y = -(-H // TILE)
    dev = proj.xy.device
    bg = torch.as_tensor(bg_color, dtype=proj.xy.dtype, device=dev)

    sort_depth = torch.where(proj.valid, proj.depth.detach(), torch.inf)
    order = torch.argsort(sort_depth, stable=True)
    color_sorted = proj.color[order]  # [N, C]

    p = torch.arange(H * W, device=dev)
    px, py = p % W, p // W
    step = max(1, row_chunk * W)
    chunks = []
    for start in range(0, H * W, step):
        sl = slice(start, start + step)
        w, t_bg = blend_weights(_pixel_alphas(proj, order, px[sl], py[sl], n_tiles_x, n_tiles_y))
        chunks.append(w @ color_sorted + t_bg[:, None] * bg[None, :])
    return torch.cat(chunks, 0).reshape(H, W, -1).permute(2, 0, 1)
