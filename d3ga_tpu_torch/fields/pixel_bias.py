"""Per-camera low-resolution learnable screen-space bias (counterpart of
d3ga_tpu/fields/pixel_bias.py): a zeros-initialized [n_cameras, 1, H/ds,
W/ds] map, resized bilinearly to the full image (as `jax.image.resize`
does, `ops/resize.py`) and added to the predicted image.
"""

import torch

from d3ga_tpu_torch.ops.resize import resize_bilinear


def init_pixel_bias(n_cameras: int, image_height: int, image_width: int, ds_rate: int = 8,
                    device="cuda"):
    return {"bias": torch.zeros((n_cameras, 1, image_height // ds_rate, image_width // ds_rate),
                                device=device)}


def apply_pixel_bias(params, camera_idx: int, image_height: int, image_width: int):
    """-> [1, H, W] bias for the given camera."""
    return resize_bilinear(params["bias"][int(camera_idx)], (1, image_height, image_width))
