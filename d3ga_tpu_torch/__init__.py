"""d3ga_tpu_torch — the PyTorch / CUDA (Hopper) port of d3ga_tpu.

Drivable 3D Gaussian avatars: tetrahedral-cage-embedded Gaussians
driven by LBS skeletons and pose-conditioned MLP fields, rendered with a
tile-binned Gaussian-splat rasterizer. The subpackages mirror
`d3ga_tpu/` module for module (ops, raster, geometry, body, fields,
model, train, data) so each module's counterpart is easy to find; the
JAX package stays the reference every module is tested against.

Ported so far: the eval-mode serving path — `model.avatar.avatar_forward
(training=False)` followed by `raster.tiles.rasterize_tiled` with the
`dupsort_depth` selection — the training step of that configuration
(`train.step.make_train_step`: the training-mode forward, the fused
RGB + silhouette raster, L1 + SSIM + regularizer losses, clipped Adam),
and the sharded rasterizer on `torch.distributed` (`dist/`: mesh,
collectives, `raster_shard.rasterize_sharded` / `rasterize_collective`,
banded losses), with five kernels written by hand in CUDA C++ for sm_90a
(`csrc/`): the front-K extraction (`raster/extract.py`), the gather +
blend forward and its backward (`raster/blend_ct.py`), the per-Gaussian
combine of the backward's per-slot cotangents (`raster/segsum.py`), and
the sharded path's flat-tiles blend, forward and backward
(`raster/blend_rec.py`).

Entry points take a `device` argument that defaults to "cuda"; pass
device="cpu" to run everything through the kernels' plain PyTorch
versions (the CPU tests do).
"""

__version__ = "0.1.0"
