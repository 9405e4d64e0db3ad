"""Gaussian preprocessing: 3D -> screen-space projection (EWA splatting),
counterpart of d3ga_tpu/raster/project.py.

Dense over N Gaussians, 3DGS `preprocess` semantics: frustum cull at view
z <= 0.2, clip-space projection with 1/(w + 1e-7), EWA cov2D = A Vrk A^T
with fov clamping, +0.3 dilation (with `antialiasing`, the opacity
scaled by sqrt(det / det_dilated), the dr_aa variant), conic = inverse
2D covariance, radius = ceil(3 sqrt(lambda_max)). The 3D covariance comes
packed (`cov3d`) or from `scales` x `scale_modifier` and `rotations`;
colours come per Gaussian (`colors`) or from SH coefficients (`shs`,
evaluated along the view direction and clamped at 0).

Gradients follow JAX's AD where the two frameworks could split them
differently: the fov clamp gives half the gradient at a tie with either
bound, as `jnp.clip` does (`torch.clamp` would give all of it). The
maxima under the radius's square roots need nothing: the radius and the
valid mask leave as integers and booleans, so no gradient flows back
through them in either framework, even where the radius is NaN.
"""

from typing import NamedTuple

import torch

from d3ga_tpu_torch.ops.covariance import covariance_from_scaling_rotation, unstrip_symmetric
from d3ga_tpu_torch.ops.sh import eval_sh
from d3ga_tpu_torch.raster.camera import Camera, ndc2pix

NEAR_CULL_Z = 0.2
DILATION = 0.3


class Projected(NamedTuple):
    xy: torch.Tensor       # [N, 2] pixel-space centre
    depth: torch.Tensor    # [N] view-space z
    conic: torch.Tensor    # [N, 3] inverse 2D covariance (a, b, c)
    color: torch.Tensor    # [N, C]
    opacity: torch.Tensor  # [N]
    radius: torch.Tensor   # [N] int32 pixel radius (0 = culled)
    valid: torch.Tensor    # [N] bool


def _clip(v, lo, hi):
    """`jnp.clip` with its gradient at the bounds (half at a tie)."""
    lo, hi = (torch.as_tensor(b, dtype=v.dtype, device=v.device) for b in (lo, hi))
    return torch.minimum(torch.maximum(v, lo), hi)


def project_gaussians(
    means3d: torch.Tensor,
    camera: Camera,
    cov3d: torch.Tensor = None,
    scales: torch.Tensor = None,
    rotations: torch.Tensor = None,
    opacities: torch.Tensor = None,
    colors: torch.Tensor = None,
    shs: torch.Tensor = None,
    sh_degree: int = 0,
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
) -> Projected:
    """means3d: [N, 3]; cov3d: [N, 6] packed or None (then scales [N, 3]
    and rotations [N, 4]); opacities: [N] or [N, 1]; colors: [N, C] or
    None (then shs: [N, (sh_degree + 1)^2 or more, C])."""
    n = means3d.shape[0]
    p_hom = torch.cat([means3d, means3d.new_ones(n, 1)], dim=-1)
    p_view = p_hom @ camera.world_view.T
    p_clip = p_hom @ camera.full_proj.T

    in_front = p_view[:, 2] > NEAR_CULL_Z
    w_safe = torch.where(in_front, p_clip[:, 3], 1.0)
    p_w = 1.0 / (w_safe + 1e-7)
    p_proj = p_clip[:, :3] * p_w[:, None]

    if cov3d is None:
        Vrk = covariance_from_scaling_rotation(scales * scale_modifier, rotations)
    else:
        Vrk = unstrip_symmetric(cov3d)

    focal_x = camera.width / (2.0 * camera.tanfovx)
    focal_y = camera.height / (2.0 * camera.tanfovy)
    tz = torch.where(in_front, p_view[:, 2], 1.0)
    limx = 1.3 * camera.tanfovx
    limy = 1.3 * camera.tanfovy
    tx = _clip(p_view[:, 0] / tz, -limx, limx) * tz
    ty = _clip(p_view[:, 1] / tz, -limy, limy) * tz

    Rwv = camera.world_view[:3, :3]
    j00 = focal_x / tz
    j02 = -(focal_x * tx) / (tz * tz)
    j11 = focal_y / tz
    j12 = -(focal_y * ty) / (tz * tz)
    zero = torch.zeros_like(tz)
    J = torch.stack(
        [torch.stack([j00, zero, j02], -1), torch.stack([zero, j11, j12], -1)],
        dim=-2,
    )  # [N, 2, 3]
    A = J @ Rwv
    cov2d = A @ Vrk @ A.transpose(-1, -2)

    c00 = cov2d[:, 0, 0]
    c01 = cov2d[:, 0, 1]
    c11 = cov2d[:, 1, 1]
    det_orig = c00 * c11 - c01 * c01
    c00d = c00 + DILATION
    c11d = c11 + DILATION
    det = c00d * c11d - c01 * c01

    opac = opacities.reshape(n)
    if antialiasing:
        # the dr_aa energy-preserving opacity scale, clamped at the CUDA
        # kernel's 0.000025
        det_dil_safe = torch.where(det > 0, det, 1.0)
        opac = opac * torch.sqrt(torch.maximum(det.new_tensor(0.000025), det_orig / det_dil_safe))

    det_ok = det > 0
    det_safe = torch.where(det_ok, det, 1.0)
    inv_det = torch.where(det_ok, 1.0 / det_safe, 0.0)
    conic = torch.stack([c11d * inv_det, -c01 * inv_det, c00d * inv_det], dim=-1)

    mid = 0.5 * (c00d + c11d)
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - disc)))

    xy = torch.stack(
        [ndc2pix(p_proj[:, 0], camera.width), ndc2pix(p_proj[:, 1], camera.height)],
        dim=-1,
    )
    if colors is None:
        dirs = means3d - camera.camera_center[None]
        norm = torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        dirs = dirs / torch.maximum(norm, norm.new_tensor(1e-12))
        sh_rgb = eval_sh(shs, dirs, sh_degree)
        colors = torch.maximum(sh_rgb, sh_rgb.new_tensor(0.0))

    valid = in_front & det_ok & (radius_f > 0)
    radius = torch.where(valid, radius_f, 0.0).to(torch.int32)
    return Projected(
        xy=xy,
        depth=p_view[:, 2],
        conic=conic,
        color=colors,
        opacity=opac,
        radius=radius,
        valid=valid,
    )


def tile_rect(xy, radius, tile_size: int, n_tiles_x: int, n_tiles_y: int):
    """Per-Gaussian touched tile rectangle [xmin, xmax), [ymin, ymax)
    (CUDA getRect semantics). xy: [N, 2], radius: [N] int."""
    r = radius.to(xy.dtype)

    def cell(v, n):
        # float -> int32 truncates toward zero like XLA's convert; the
        # float clamp keeps culled Gaussians' far-off centres in range
        q = torch.clamp(v / tile_size, -(2.0**30), 2.0**30)
        return torch.clamp(q.to(torch.int32), 0, n)

    xmin = cell(xy[:, 0] - r, n_tiles_x)
    ymin = cell(xy[:, 1] - r, n_tiles_y)
    xmax = cell(xy[:, 0] + r + tile_size - 1, n_tiles_x)
    ymax = cell(xy[:, 1] + r + tile_size - 1, n_tiles_y)
    return xmin, xmax, ymin, ymax
