"""Per-stage breakdown of the tiled rasterizer on the card (the port's
counterpart of tools/bench_stages.py).

The scene is bench.py's `build_scene` distribution drawn from a
`torch.Generator`: 135,000 Gaussians in a 1.8 m x 0.6 m volume 3.5 m in
front of an identity camera (focal 1100 px), scales exp(U(-6, -4.6)),
random unit quaternions, opacities U(0.3, 0.95), RGB colours U(0, 1), at
1024 x 667 with K 256. The stages, each timed alone on inputs computed
once:

  project               `project_gaussians` (packed covariances, colours)
  argsort               the stable depth argsort
  record_pack_gather    [xy | conic | opacity | colour] packed, reordered
  select                `_select_per_tile` (topk funnel, the defaults)
  tile_gather           the per-tile record gather [T, K, 9]
  blend_xla_fwd         `_blend_tiles` (plain PyTorch)
  blend_xla_fwdbwd      the same, with the gradient wrt xy and colours
  blend_k8_fwd          K8 (`raster/blend.py::blend_tiles_pallas`) on
                        `falloff_coeffs` of the same records
  blend_k8_fwdbwd       the same, with K8's backward
  full_fwd              `rasterize_tiled`'s defaults (topk, XLA blend)
  full_fwdbwd_xla       the same, with the gradient wrt the means
  full_fwdbwd_kernels   `rasterize_tiled(use_pallas=True)` in the ct
                        layout: K2, K3 and K4

Each time is CUDA events around `--iters` calls after two warm-up calls,
in milliseconds a call.

    python3 -m d3ga_tpu_torch.bench_stages [--iters 10] [--out run_out]

Prints one JSON line (the card's name and power limit from nvidia-smi,
the stage times) and writes it to <out>/bench_stages.json. Needs a CUDA
device. `prepare` and `run` also take CPU tensors (host times), which is
how chip_smoke.py's CPU rehearsal drives them at a small size.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from d3ga_tpu_torch.ops.covariance import covariance_from_scaling_rotation, strip_symmetric
from d3ga_tpu_torch.ops.quaternion import quat_normalize
from d3ga_tpu_torch.raster import tiles
from d3ga_tpu_torch.raster.blend import blend_tiles_pallas, falloff_coeffs
from d3ga_tpu_torch.raster.camera import focal2fov, make_camera
from d3ga_tpu_torch.raster.project import project_gaussians, tile_rect
from d3ga_tpu_torch.train.losses import full_float32

N_GAUSS, WIDTH, HEIGHT, K = 135_000, 667, 1024, 256
FOCAL = 1100.0


def build_scene(gen, n, device):
    """bench.py's scene: (means [n, 3], scales, rotations, opacities
    [n, 1], colours [n, 3]), drawn on the CPU from `gen`."""
    means = torch.cat([
        torch.randn(n, 1, generator=gen) * 0.25,
        torch.randn(n, 1, generator=gen) * 0.6,
        3.5 + torch.randn(n, 1, generator=gen) * 0.15,
    ], -1)
    scales = torch.exp(torch.rand(n, 3, generator=gen) * 1.4 - 6.0)
    rots = quat_normalize(torch.randn(n, 4, generator=gen))
    opac = 0.3 + torch.rand(n, 1, generator=gen) * 0.65
    colors = torch.rand(n, 3, generator=gen)
    return tuple(t.to(device) for t in (means, scales, rots, opac, colors))


def prepare(device, n=N_GAUSS, width=WIDTH, height=HEIGHT, k=K, seed=0):
    """The scene, its camera and every stage's inputs, computed once."""
    camera = make_camera(np.eye(3), np.zeros(3), focal2fov(FOCAL, width), focal2fov(FOCAL, height),
                         width, height, device=device)
    means, scales, rots, opac, colors = build_scene(torch.Generator().manual_seed(seed), n, device)
    cov6 = strip_symmetric(covariance_from_scaling_rotation(scales, rots))
    ntx, nty = -(-width // tiles.TILE), -(-height // tiles.TILE)
    with torch.no_grad():
        proj = project_gaussians(means, camera, cov3d=cov6, opacities=opac, colors=colors)
        valid = proj.valid & (proj.radius > 0)
        depth_key = torch.where(valid, proj.depth, torch.inf)
        order = torch.argsort(depth_key, stable=True)
        records = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], proj.color], -1)[order]
        radius_s, valid_s = proj.radius[order], valid[order]
        rects = tile_rect(records[:, 0:2], radius_s, tiles.TILE, ntx, nty)
        ranks, counts, _ = tiles._select_per_tile(rects, valid_s, ntx, nty, k)
        sel_valid = ranks < tiles.BIG_RANK
        safe = torch.where(sel_valid, ranks, 0).long()
        tids = torch.arange(ntx * nty, device=device)
        origin = torch.stack([(tids % ntx) * tiles.TILE, (tids // ntx) * tiles.TILE], -1)
        rec_t = records[safe]
        xy_t, conic_t, opac_t, color_t = (rec_t[..., 0:2], rec_t[..., 2:5], rec_t[..., 5],
                                          rec_t[..., 6:])
        coeffs = falloff_coeffs(xy_t - origin[:, None, :].float(), conic_t).contiguous()
        opac_in = torch.where(sel_valid, opac_t, 0.0)[:, None, :].contiguous()
    return dict(
        camera=camera, means=means, cov6=cov6, opac=opac, colors=colors, proj=proj,
        valid=valid, depth_key=depth_key, order=order, records=records, rects=rects,
        valid_s=valid_s, ntx=ntx, nty=nty, k=k, sel_valid=sel_valid, safe=safe, origin=origin,
        xy_t=xy_t.contiguous(), conic_t=conic_t.contiguous(), opac_t=opac_t.contiguous(),
        color_t=color_t.contiguous(), coeffs=coeffs, opac_in=opac_in,
        n_contrib=int(torch.clamp(counts, max=k).sum()),
    )


def time_ms(fn, iters, device, warmup=2):
    """Milliseconds a call: CUDA events around `iters` calls on the card,
    the host clock after a synchronize on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def stages(inp):
    """{name: a call of the stage} on the prepared inputs."""
    cam, k, ntx, nty = inp["camera"], inp["k"], inp["ntx"], inp["nty"]
    proj, bg = inp["proj"], torch.zeros(3, device=inp["means"].device)
    raster = dict(cov3d=inp["cov6"], opacities=inp["opac"], colors=inp["colors"], max_per_tile=k)

    def blend_xla(xy, col):
        return tiles._blend_tiles(xy, inp["conic_t"], col, inp["opac_t"], inp["sel_valid"], bg,
                                  inp["origin"])

    def blend_xla_fwdbwd():
        xy = inp["xy_t"].detach().requires_grad_(True)
        col = inp["color_t"].detach().requires_grad_(True)
        return torch.autograd.grad(blend_xla(xy, col).sum(), (xy, col))

    def blend_k8_fwdbwd():
        co = inp["coeffs"].detach().requires_grad_(True)
        col = inp["color_t"].detach().requires_grad_(True)
        return torch.autograd.grad(blend_tiles_pallas(co, col, inp["opac_in"]).sum(), (co, col))

    def full_fwdbwd(use_pallas):
        means = inp["means"].detach().requires_grad_(True)
        img, _ = tiles.rasterize_tiled(means, cam, bg, use_pallas=use_pallas, **raster)
        return torch.autograd.grad(img.abs().mean(), means)

    with_grad = {"blend_xla_fwdbwd", "blend_k8_fwdbwd", "full_fwdbwd_xla", "full_fwdbwd_kernels"}
    calls = {
        "project": lambda: project_gaussians(inp["means"], cam, cov3d=inp["cov6"],
                                             opacities=inp["opac"], colors=inp["colors"]).xy,
        "argsort": lambda: torch.argsort(inp["depth_key"], stable=True),
        "record_pack_gather": lambda: torch.cat(
            [proj.xy, proj.conic, proj.opacity[:, None], proj.color], -1)[inp["order"]],
        "select": lambda: tiles._select_per_tile(inp["rects"], inp["valid_s"], ntx, nty, k),
        "tile_gather": lambda: inp["records"][inp["safe"]],
        "blend_xla_fwd": lambda: blend_xla(inp["xy_t"], inp["color_t"]),
        "blend_xla_fwdbwd": blend_xla_fwdbwd,
        "blend_k8_fwd": lambda: blend_tiles_pallas(inp["coeffs"], inp["color_t"], inp["opac_in"]),
        "blend_k8_fwdbwd": blend_k8_fwdbwd,
        "full_fwd": lambda: tiles.rasterize_tiled(inp["means"], cam, bg, **raster),
        "full_fwdbwd_xla": lambda: full_fwdbwd(False),
        "full_fwdbwd_kernels": lambda: full_fwdbwd(True),
    }
    return calls, with_grad


def run(inp, iters=10):
    """Every stage's milliseconds a call, in the docstring's order."""
    dev = inp["means"].device
    calls, with_grad = stages(inp)
    out = {}
    saved = tiles.BLEND_LAYOUT
    tiles.BLEND_LAYOUT = "ct"  # the kernels' stage: K2 / K3
    try:
        with full_float32():
            for name, fn in calls.items():
                with torch.set_grad_enabled(name in with_grad):
                    out[name] = time_ms(fn, iters, dev)
    finally:
        tiles.BLEND_LAYOUT = saved
    return out


def card():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default="run_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_stages: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    inp = prepare(dev)
    ms = run(inp, args.iters)
    result = {
        "card": card(), "device": torch.cuda.get_device_name(dev), "n_gaussians": N_GAUSS,
        "width": WIDTH, "height": HEIGHT, "k": K, "tiles": inp["ntx"] * inp["nty"],
        "n_contrib": inp["n_contrib"], "iters": args.iters, "ms": ms,
    }
    if not all(math.isfinite(v) for v in ms.values()):
        raise RuntimeError(f"bench_stages: a stage time is not finite: {ms}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "bench_stages.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
