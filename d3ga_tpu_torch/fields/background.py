"""Per-camera learnable background and the blurred-noise background
target (counterpart of d3ga_tpu/fields/background.py).

- `bg_net`: a per-camera low-resolution [3, H/ds, W/ds] map, mid-grey at
  init, resized bilinearly to the image (`ops/resize.py`) and composited
  behind the splats with the rasterizer's background transmittance.
- the blurred-noise target: while the bg net warms up (iteration <
  enable_bg) or under `use_random_bg`, the ground truth's background
  region becomes 7x7-blurred uniform noise. The uniform draw comes from
  the caller (the JAX package draws it from its rng here); `blur_noise`
  blurs it as the JAX package does: reflect padding, then a 7-tap
  Gaussian along H and along W (sigma 1.4, torchvision's default for
  7), each a convolution in full float32.
"""

import torch
import torch.nn.functional as Fn

from d3ga_tpu_torch.ops.resize import resize_bilinear
from d3ga_tpu_torch.train.losses import full_float32


def init_background_model(n_cameras: int, image_height: int, image_width: int,
                          ds_rate: int = 8, device="cuda"):
    return {"bg": torch.full((n_cameras, 3, image_height // ds_rate, image_width // ds_rate), 0.5,
                             dtype=torch.float32, device=device)}


def apply_background(params, camera_idx: int, image_height: int, image_width: int):
    """-> [3, H, W] background map for the given camera."""
    return resize_bilinear(params["bg"][int(camera_idx)], (3, image_height, image_width))


def composite_background(pred_image, t_bg, bg_map, bg_color):
    """pred_image was rendered over the solid bg_color: raw + T_bg bg_color.
    Returns raw + T_bg bg_map = pred + T_bg (bg_map - bg_color). t_bg [H,
    W]; bg_map [3, H, W]; bg_color [3]."""
    return pred_image + t_bg[None] * (bg_map - bg_color[:, None, None])


def _gaussian_kernel1d(ksize: int, sigma: float, device):
    x = torch.arange(ksize, dtype=torch.float32, device=device) - (ksize - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def blur_noise(noise, ksize: int = 7):
    """The JAX package's `blurred_noise` given its uniform draw: noise [C,
    H, W] in [0, 1), blurred by a ksize x ksize separable Gaussian with
    reflect padding."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8
    k = _gaussian_kernel1d(ksize, sigma, noise.device)
    pad = ksize // 2
    x = Fn.pad(noise[None], (pad, pad, pad, pad), mode="reflect")[0][:, None]  # [C, 1, ., .]
    with full_float32():
        x = Fn.conv2d(x, k.reshape(1, 1, ksize, 1))
        x = Fn.conv2d(x, k.reshape(1, 1, 1, ksize))
    return x[:, 0]
