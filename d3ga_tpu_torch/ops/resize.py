"""Bilinear resize, as `jax.image.resize(x, shape, method="bilinear")`
computes it (antialias on, its default).

JAX resamples each axis whose size changes with a weight matrix
[in, out] (`jax._src.image.scale.compute_weight_mat`): output pixel j
samples the input at (j + 0.5) / scale - 0.5 (half-pixel centres), the
triangle kernel max(0, 1 - |d|) is widened by 1 / scale when
downsampling (the antialias), each column is divided by its sum, and a
sample outside [-0.5, in - 0.5] gets no weight. The matrices are built
here in float32 with the same operations, so they hold the same values,
and applied as two small matmuls (an einsum in JAX). `F.interpolate`'s
bilinear mode is another function at ratios like 667 -> 333: it takes
two taps whatever the ratio.
"""

import functools

import numpy as np
import torch

from d3ga_tpu_torch.ops.flog import fma32


@functools.lru_cache(maxsize=32)
def _weights(in_size: int, out_size: int, device: str) -> torch.Tensor:
    """The [in_size, out_size] float32 weight matrix of one axis."""
    f32 = torch.float32
    # JAX takes the scale's reciprocal in double (Python floats) and
    # rounds it to float32 where it meets the float32 arrays
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    # XLA-CPU contracts (j + 0.5) * inv_scale - 0.5 into one fma
    sample_f = fma32(torch.arange(out_size, dtype=f32) + 0.5, inv_scale, torch.tensor(-0.5))
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def resize_weights(in_size: int, out_size: int, device="cpu") -> torch.Tensor:
    """The weight matrix JAX's bilinear resize applies along an axis of
    in_size samples to give out_size."""
    return _weights(int(in_size), int(out_size), str(torch.device(device)))


def resize_bilinear(x: torch.Tensor, shape) -> torch.Tensor:
    """x [C, H, W] -> `shape` (C, H', W'): each of the last two axes whose
    size changes resampled by its weight matrix (float32 matmuls: on the
    card hold TF32 off around it, as `train.losses.full_float32` does).
    Differentiable in x."""
    if x.ndim != 3 or len(shape) != 3 or shape[0] != x.shape[0]:
        raise ValueError(f"resize_bilinear: x {tuple(x.shape)} -> {tuple(shape)}: expected "
                         "[C, H, W] to [C, H', W']")
    _, h, w = x.shape
    _, oh, ow = shape
    if oh != h:
        x = torch.matmul(resize_weights(h, oh, x.device).T, x)
    if ow != w:
        x = torch.matmul(x, resize_weights(w, ow, x.device))
    return x
