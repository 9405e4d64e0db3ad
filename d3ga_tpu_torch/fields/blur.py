"""Per-camera learnable defocus blur (counterpart of
d3ga_tpu/fields/blur.py): a softmax over {identity, 3x3 Gaussian, 7x7
Gaussian} of the rendered image, one raw weight triple per camera,
regularized toward the raw weights being 1. The Gaussians take
torchvision's default sigma for their size, 0.3 ((k - 1) / 2 - 1) + 0.8,
with reflect padding, separable: along H, then along W, each pass a sum
of k shifted copies in the JAX package's order.
"""

import numpy as np
import torch
import torch.nn.functional as Fn


def init_learnable_blur(n_cameras: int, device="cuda"):
    return {"weights_raw": torch.ones((n_cameras, 3), device=device)}


def _gauss_kernel1d(k: int) -> np.ndarray:
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    x = np.arange(k) - (k - 1) / 2.0
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


def _sep_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """Separable Gaussian blur of [C, H, W] with reflect padding."""
    g = [float(v) for v in _gauss_kernel1d(k)]
    pad = k // 2
    H, W = img.shape[1], img.shape[2]
    x = Fn.pad(img[None], (0, 0, pad, pad), mode="reflect")[0]
    x = sum(g[i] * x[:, i : i + H, :] for i in range(k))
    y = Fn.pad(x[None], (pad, pad, 0, 0), mode="reflect")[0]
    return sum(g[i] * y[:, :, i : i + W] for i in range(k))


def apply_learnable_blur(params, img, camera_idx: int):
    """img: [C, H, W]; camera_idx: int."""
    w = torch.softmax(params["weights_raw"][int(camera_idx)], dim=-1)
    return w[0] * img + w[1] * _sep_blur(img, 3) + w[2] * _sep_blur(img, 7)


def blur_reg(params, camera_idx: int):
    """The raw weights of the |w - 1| regularizer."""
    return params["weights_raw"][int(camera_idx)]
