"""Banded (image-row-sharded) loss terms with a halo exchange (counterpart
of d3ga_tpu/dist/banded.py).

With `raster_shard.rasterize_collective(banded=True)` each rank of the
"model" group owns a horizontal band of the image. The window losses then
run band-locally:

  * L1 / PSNR: local masked sums, psum'd;
  * SSIM: the 11x11 window needs 5 rows of context across band edges —
    one `ppermute` halo exchange per neighbour direction. Interior values
    equal the full-image SSIM map exactly; the global top/bottom edges see
    the zero padding the full-image convolution uses (ppermute fills
    unsourced halos with zeros).

The means returned are replicated over the group (every rank holds the
same value). Before a backward, mark the final loss with
`collectives.replicated`, as `banded_l1_ssim` does: that is the JAX
package's `out_specs=P()` rule (see `collectives.py`).
"""

import torch
import torch.distributed as dist

from d3ga_tpu_torch.dist.collectives import ppermute, psum, replicated
from d3ga_tpu_torch.train.losses import ssim_map

HALO = 5  # (11 // 2) rows of context for the 11x11 SSIM window


def band_rows(H: int, band_h: int, group, device=None):
    """Global row indices of this rank's band [bh]."""
    return dist.get_rank(group) * band_h + torch.arange(band_h, device=device)


def halo_exchange(band, group, m: int, halo: int = HALO):
    """band [C, bh, W] -> [C, bh + 2*halo, W] with the neighbours' rows.
    Ranks at the group's edges receive zeros (the zero same-padding the
    full-image convolution applies at the image border)."""
    up_perm = [(i, i + 1) for i in range(m - 1)]     # my bottom rows -> next rank's top halo
    down_perm = [(i, i - 1) for i in range(1, m)]    # my top rows -> previous rank's bottom halo
    from_above = ppermute(band[:, -halo:], group, up_perm)
    from_below = ppermute(band[:, :halo], group, down_perm)
    return torch.cat([from_above, band, from_below], dim=1)


def banded_mean(x_band, valid_band, group):
    """Masked mean over the full image from band-local values; x_band and
    valid_band broadcast together. Returns the replicated mean."""
    v = torch.broadcast_to(valid_band, x_band.shape)
    s = psum(torch.sum(x_band * v, dtype=torch.float32), group)
    n = psum(torch.sum(v, dtype=torch.float32), group)
    return s / torch.clamp(n, min=1.0)


def banded_ssim(pred_band, gt_band, valid_band, group, m: int):
    """Full-image (masked) mean SSIM from [C, bh, W] bands — equal to
    `losses.masked_ssim` on the gathered image."""
    pe = halo_exchange(pred_band, group, m)
    ge = halo_exchange(gt_band, group, m)
    s = ssim_map(pe, ge)[:, HALO:-HALO]
    return banded_mean(s, valid_band, group)


def banded_psnr(pred_band, gt_band, valid_band, group, eps=1e-12):
    mse = banded_mean((pred_band - gt_band) ** 2, valid_band, group) + eps
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def banded_l1_ssim(img_band, target, group, m: int, ssim_weight: float = 0.2):
    """The banded training objective of the JAX package's scaling benchmark
    (bench_scaling.py): (1 - w) * L1 + w * (1 - SSIM) over the full image,
    from this rank's band img_band [C, bh, W] of a row-banded
    `rasterize_collective(banded=True)` and the full target [C, H, W] that
    every rank holds. Rows past the image are masked out. Returns the loss
    marked `replicated`, ready for backward on every rank."""
    C, bh, W = img_band.shape
    H = target.shape[1]
    rows = band_rows(H, bh, group, img_band.device)
    valid = (rows < H).to(img_band.dtype)[None, :, None]
    tgt = torch.nn.functional.pad(target, (0, 0, 0, max(m * bh - H, 0)))
    r = dist.get_rank(group)
    tgt = tgt[:, r * bh : (r + 1) * bh]
    l1 = banded_mean(torch.abs(img_band - tgt) * valid, valid, group)
    s = banded_ssim(img_band * valid, tgt * valid, valid, group, m)
    return replicated((1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - s), group)
