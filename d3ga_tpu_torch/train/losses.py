"""Training losses (counterpart of d3ga_tpu/train/losses.py): L1, L2,
BCE, PSNR and 11x11 Gaussian-window SSIM (sigma 1.5, zero same-padding),
with the masked variants for canvas-padded frames, and the VGG19
perceptual loss (5 feature levels, the x0.5 + 512-crop protocol; its
weights from a .npz, or a random stack for tests and experiments).

SSIM and the VGG convolutions run in true float32 (the JAX package asks
XLA for HIGHEST and HIGH, both full float32 on its CPU). SSIM's variance
terms blur(x^2) - mu^2 cancel catastrophically at TF32's ~3 decimal
digits, which cuDNN uses for float32 convolutions by default on the
card. `full_float32()` turns TF32 off around the convolutions; the
training step holds it across the backward as well.
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as Fn

from d3ga_tpu_torch.ops.resize import resize_bilinear


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


def l2_loss(pred, gt):
    return torch.mean((pred - gt) ** 2)


def bce_loss(pred, gt, eps=1e-7):
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -torch.mean(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))


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


# ----------------------------------------------------------------------------
# VGG19 perceptual loss

VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
# torchvision feature indices: the outputs after flat indices 1, 6, 11, 20
# and 29 of its features Sequential (relu1_1 ... relu5_1)
FEATURE_LAYERS = (2, 7, 12, 21, 30)


def init_vgg19_features(gen=None, weights_path=None, allow_random=False, device="cuda"):
    """The conv stack up to torchvision's features[30]: {"convs": [{"w"
    [out, in, 3, 3], "b" [out]}, ...], "pretrained": bool}. weights_path:
    a .npz of w0, b0, w1, ... in torchvision order. Without one the term
    is disabled and this returns None, as in the JAX package, unless
    allow_random: then He-normal weights drawn from the host generator
    `gen` (seed 1234 when None) and zero biases."""
    if weights_path is None and not allow_random:
        return None
    loaded = np.load(weights_path) if weights_path is not None else None
    if loaded is None and gen is None:
        gen = torch.Generator().manual_seed(1234)
    convs, in_ch = [], 3
    for v in VGG19_CFG:
        if v == "M":
            continue
        i = len(convs)
        if loaded is not None:
            w = torch.as_tensor(np.asarray(loaded[f"w{i}"], np.float32))
            b = torch.as_tensor(np.asarray(loaded[f"b{i}"], np.float32))
        else:
            w = torch.randn((v, in_ch, 3, 3), generator=gen) * math.sqrt(2.0 / (in_ch * 9))
            b = torch.zeros(v)
        convs.append({"w": w.to(device), "b": b.to(device)})
        in_ch = v
    return {"convs": convs, "pretrained": loaded is not None}


def _vgg_forward_features(params, x):
    """x [B, 3, H, W] -> the feature maps after flat indices 1, 6, 11, 20
    and 29 of torchvision's features (convs padded by 1, 2x2 max pools)."""
    taps = {f - 1 for f in FEATURE_LAYERS}
    feats, flat, conv, h = [], 0, 0, x
    with full_float32():
        for v in VGG19_CFG:
            if v == "M":
                h = Fn.max_pool2d(h, 2, 2)
                flat += 1
            else:
                c = params["convs"][conv]
                h = torch.relu(Fn.conv2d(h, c["w"], padding=1) + c["b"][None, :, None, None])
                conv += 1
                if flat + 1 in taps:
                    feats.append(h)
                flat += 2
            if flat > max(taps):
                break
    return feats


def vgg_crop(shape, crop_size=512):
    """(rows, columns) of the 512 crop of an image of `shape` [C, H, W]
    after the x0.5 downsample: the window's size and the ranges its
    offsets are drawn from ([0, n] each), or None when no crop is cut."""
    _, h, w = shape
    if not (h == crop_size and w == crop_size):
        h, w = h // 2, w // 2
    if h <= crop_size and w <= crop_size:
        return None
    return (max(h - crop_size, 0), max(w - crop_size, 0))


def vgg_loss(params, pred, gt, crop=None, crop_size=512):
    """Perceptual L1 between the VGG features of pred and gt ([C, H, W]):
    x0.5 bilinear downsample (unless already 512 x 512, `ops/resize.py`),
    the 512 crop at offsets crop = (i, j) (drawn by the caller within
    `vgg_crop`'s ranges; None cuts none), L1 per feature level, unit
    weights, no gradient through gt."""
    def downsize(img):
        c, h, w = img.shape
        if h == crop_size and w == crop_size:
            return img
        return resize_bilinear(img, (c, h // 2, w // 2))

    with full_float32():
        p, g = downsize(pred), downsize(gt.detach())
    c, h, w = p.shape
    if (h > crop_size or w > crop_size) and crop is not None:
        ch, cw = min(crop_size, h), min(crop_size, w)
        i = min(max(int(crop[0]), 0), h - ch)
        j = min(max(int(crop[1]), 0), w - cw)
        p, g = p[:, i : i + ch, j : j + cw], g[:, i : i + ch, j : j + cw]
    pf = _vgg_forward_features(params, p[None])
    with torch.no_grad():
        gf = _vgg_forward_features(params, g[None])
    loss = 0.0
    for a, b in zip(pf, gf):
        loss = loss + torch.mean(torch.abs(a - b))
    return loss
