"""Training losses (counterpart of d3ga_tpu/train/losses.py): L1, PSNR
and 11x11 Gaussian-window SSIM (sigma 1.5, zero same-padding), with the
masked variants for canvas-padded frames. The VGG19 perceptual loss is
not ported yet (ROADMAP.md, queue 1: 'Model forward, the rest').

SSIM must run in true float32: its variance terms blur(x^2) - mu^2
cancel catastrophically at TF32's ~3 decimal digits, which cuDNN uses for
float32 convolutions by default on the card. `full_float32()` turns TF32
off around the convolutions; the training step holds it across the
backward as well.
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as Fn


@contextlib.contextmanager
def full_float32():
    """TF32 off for convolutions and matrix products, restored after."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def l1_loss(pred, gt):
    return torch.mean(torch.abs(pred - gt))


def psnr(pred, gt):
    mse = torch.mean((pred - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def masked_psnr(pred, gt, mask=None, eps=1e-12):
    """PSNR over the valid pixels only (mask broadcasts against pred);
    mask=None is plain PSNR with eps added to the MSE."""
    if mask is None:
        mse = torch.mean((pred - gt) ** 2) + eps
    else:
        m = torch.broadcast_to(mask, pred.shape)
        mse = torch.sum((pred - gt) ** 2 * m) / torch.clamp(torch.sum(m), min=1.0) + eps
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _gauss_blur_separable(img, g1):
    """img [C, H, W]; g1 [k] 1-D taps. Depthwise blur with outer(g1, g1)
    under zero same-padding, as two k-tap passes (rows, then columns)."""
    k = g1.shape[0]
    C = img.shape[0]
    x = img[None]
    with full_float32():
        x = Fn.conv2d(x, g1.reshape(1, 1, k, 1).repeat(C, 1, 1, 1), padding=(k // 2, 0), groups=C)
        x = Fn.conv2d(x, g1.reshape(1, 1, 1, k).repeat(C, 1, 1, 1), padding=(0, k // 2), groups=C)
    return x[0]


def ssim_map(img1, img2, window_size: int = 11):
    """Per-pixel SSIM map over [C, H, W] images in [0, 1]; the five window
    means (x, y, x^2, y^2, xy) go through one stacked separable blur."""
    g1 = torch.as_tensor(_gaussian_window(window_size, 1.5), device=img1.device)
    C = img1.shape[0]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], 0)
    blurred = _gauss_blur_separable(stacked, g1)
    mu1, mu2 = blurred[:C], blurred[C : 2 * C]
    mu1_sq = mu1**2
    mu2_sq = mu2**2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = blurred[2 * C : 3 * C] - mu1_sq
    sigma2_sq = blurred[3 * C : 4 * C] - mu2_sq
    sigma12 = blurred[4 * C :] - mu1_mu2
    c1 = 0.01**2
    c2 = 0.03**2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )


def ssim(img1, img2, window_size: int = 11):
    """Mean SSIM over [C, H, W] images in [0, 1]."""
    return torch.mean(ssim_map(img1, img2, window_size))


def masked_ssim(img1, img2, mask, window_size: int = 11):
    """Mean SSIM over the valid pixels only (mask broadcasts against the
    images, e.g. [1, H, W])."""
    m = torch.broadcast_to(mask, img1.shape)
    s = ssim_map(img1, img2, window_size)
    return torch.sum(s * m) / torch.clamp(torch.sum(m), min=1.0)
