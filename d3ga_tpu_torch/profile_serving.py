"""Where the serving path's time goes on the card.

Builds the full-width synthetic avatar (3 garments x 45,000 Gaussians,
1024 x 667, K 256, dup 3; random weights from seed 0) and renders frames
through the serving path, three ways:

  1. stage wall times, with a synchronize after each stage: the avatar
     forward, the binning (projection + selection, with K1), the blend
     (K2) + composite;
  2. torch.profiler over a few frames: device busy time per frame, the
     device's idle share, kernels by device time, host ops by self time;
  3. the plain frame rate, unprofiled.

    python3 -m d3ga_tpu_torch.profile_serving [--frames 10]

Prints one JSON summary line; the tables go to
run_out/serving_profile.txt. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from d3ga_tpu_torch.data.synthetic import serving_scene
from d3ga_tpu_torch.model.avatar import avatar_forward, init_avatar
from d3ga_tpu_torch.raster.blend_ct import blend_gather_ct
from d3ga_tpu_torch.raster.tiles import bin_gaussians, rasterize_tiled

BG6 = (1.0, 1.0, 1.0, 0.0, 0.0, 0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default="run_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    model, camera, pose = serving_scene(device=dev)
    params = init_avatar(torch.Generator().manual_seed(0), model)
    bg = torch.tensor(BG6, device=dev)

    def batch(i):
        return {"camera": camera, "lbs": pose(i), "camera_idx": 0}

    def frame(i):
        pkg = avatar_forward(params, model, batch(i), training=False)
        colors = torch.cat([pkg["rgb"], pkg["silhouette_rgb"]], -1)
        return rasterize_tiled(
            pkg["means3D"], camera, bg, cov3d=pkg["cov3D_precomp"],
            opacities=pkg["opacities"], colors=colors, max_per_tile=256, use_pallas=True,
            coarse="dupsort_depth", dup=3,
        )

    with torch.no_grad():
        for i in range(3):  # warm-up
            frame(i)
        torch.cuda.synchronize()

        # 1. stage walls, synchronized
        stages = {"avatar_forward": 0.0, "bin_gaussians": 0.0, "blend_composite": 0.0}
        for i in range(args.frames):
            t0 = time.perf_counter()
            pkg = avatar_forward(params, model, batch(i), training=False)
            colors = torch.cat([pkg["rgb"], pkg["silhouette_rgb"]], -1).contiguous()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            b = bin_gaussians(pkg["means3D"], camera, pkg["cov3D_precomp"], pkg["opacities"],
                              colors, 256, 3)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out = blend_gather_ct(b.records_ext, b.idx, torch.clamp(b.counts, max=256),
                                  b.ntx, b.nty, 6)
            img = (out[:6] + out[6:] * bg[:, None, None])[:, :1024, :667]
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
                stages[k] += dt * 1e3 / args.frames
        del img

        # 2. profiler window
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(args.frames):
                frame(i)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / args.frames
        ka = prof.key_averages()
        kernels = sorted(
            (e for e in ka if e.device_type == DeviceType.CUDA),
            key=lambda e: e.self_device_time_total, reverse=True,
        )
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / args.frames
        n_kernels = sum(e.count for e in kernels) / args.frames

        # 3. plain rate
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(args.frames):
            frame(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.frames

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "serving_profile.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
        f.write("\n\n")
        f.write(ka.table(sort_by="self_cpu_time_total", row_limit=40))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    summary = {
        "card": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None,
        "device": torch.cuda.get_device_name(0),
        "frames": args.frames,
        "ms_per_frame": wall,
        "frames_per_s": 1e3 / wall,
        "stage_ms_synchronized": stages,
        "profiled_ms_per_frame": prof_wall,
        "device_busy_ms_per_frame": busy,
        "device_idle_share": 1.0 - busy / prof_wall if prof_wall > 0 else None,
        "kernel_launches_per_frame": n_kernels,
        "top_kernels_ms_per_frame": {
            e.key[:80]: e.self_device_time_total / 1e3 / args.frames for e in kernels[:12]
        },
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
