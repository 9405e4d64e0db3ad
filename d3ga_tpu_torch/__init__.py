"""d3ga_tpu_torch — the PyTorch / CUDA (Hopper) port of d3ga_tpu.

Drivable 3D Gaussian avatars: tetrahedral-cage-embedded Gaussians
driven by LBS skeletons and pose-conditioned MLP fields, rendered with a
tile-binned Gaussian-splat rasterizer. The subpackages mirror
`d3ga_tpu/` module for module (ops, raster, geometry, body, fields,
model, train, data) so each module's counterpart is easy to find; the
JAX package stays the reference every module is tested against.

Ported so far: the eval-mode serving path — `model.avatar.avatar_forward
(training=False)` followed by `raster.tiles.rasterize_tiled` with the
`dupsort_depth` selection — the training step (`train.step.
make_train_step`: the training-mode forward, the fused RGB + silhouette
raster, L1 + SSIM + regularizer losses, clipped Adam) under any
`raster_backend` (xla, pallas_blend, fused) and `raster_opts`, every
single-device rasterizer configuration (`raster/tiles.py`: the topk,
dupsort, dupsort_tile and dupsort_depth funnels, the XLA blend, the ct and
rec kernel layouts, `rasterize_tiled_fused`; `raster/api.py`,
`raster/oracle.py`), the sharded rasterizer on `torch.distributed`
(`dist/`: mesh, collectives, `raster_shard.rasterize_sharded` /
`rasterize_collective`, banded losses) and the stage bench
(`bench_stages.py`), with twelve kernels written by hand in CUDA C++ for
sm_90a in seven sources (`csrc/`): K1 the front-K extraction
(`raster/extract.py`); K2 the gather + blend and K3 its backward
(`raster/blend_ct.py`); K4 the per-Gaussian combine of the backward's
per-slot cotangents (`raster/segsum.py`); K5 the sharded path's
flat-tiles blend and K7 the image-layout blend, each forward and backward
(`raster/blend_rec.py`); K8 the blend over precomputed falloff
coefficients, forward and backward (`raster/blend.py`); K9 the fused
per-tile select + blend, forward and backward (`raster/fused.py`).

Entry points take a `device` argument that defaults to "cuda"; pass
device="cpu" to run everything through the kernels' plain PyTorch
versions (the CPU tests do).
"""

__version__ = "0.1.0"
