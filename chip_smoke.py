#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (d3ga_tpu_torch) on one NVIDIA GPU.

Builds the hand-written kernels from `d3ga_tpu_torch/csrc/` and holds
each against its plain PyTorch version at full width: K1 front-K
extraction and K2 gather + blend on the serving path's selection, K3
(the blend backward) and K4 (the per-Gaussian combine) on the same
selection with a seeded random image cotangent, K5 (the sharded path's
flat-tiles blend, forward and backward) on the whole grid and on the
tile slices of the ranks of a 4-way banded split, K7 (the image-layout
blend, forward and backward) on the serving selection, K9 (the fused
select + blend, forward and backward, through both of its input layouts)
on frame 0's Gaussians, K8 (the blend over precomputed coefficients,
forward and backward) at the stage bench's shapes, and the card probes
P1-P3 (the port of the TPU tools mxu_probe, widerow_probe and fused_bisect:
matmuls in FP32 SIMT, TF32 and 3xTF32, a roll + select chain, a
passthrough over narrow and wide rows, K9's forward cut at four stages;
P1's roll in every design of `mxu.ROLL_DESIGNS`, each bit-equal to plain
and timed in turns against the design before, with its sync floor,
registers and cluster occupancy).
K1 and K4 are also held bit-equal to their plain versions and to their
baseline designs (the designs before, kept as `*_baseline` entry points
that no path of the port calls) on edge inputs and on the main path's own
inputs (K1: the selection's lo_s stream, starts and counts, as the
selection calls it; K4: frame 0's drec through the int64 sort
permutation into n + 1 rows), and timed against them in turns (old, new,
new, old), with their callers before and after the epilogues were folded
in, K1's launch floor (an empty kernel on either design's grid) and the
id sort before K4; the training step's kernels a call are reported
against its count before the two epilogues were folded in. K3 is held
within its tolerances of its plain version and of its baseline design
on edge inputs (`k3_edge_cases`) and at full width, bit-equal across two
launches and to its own walk with the band cull off, and timed in turns
against the baseline and its own walk at 1 and 4 pixels a thread, with
both designs cut at five stages. K2 is held within the image tolerances
of its plain version on the same edge inputs (`check_k2_edges`) and, to
the bit, to its baseline design (the design before) there and at full
width, across two launches, and to its own walk at 1, 2 and 4 records a
batch; it is timed in turns against them and cut at three stages, and
diagnostic builds of both designs record each block's SM and clocks
(full tiles and busy cycles an SM). K9's backward is held on its own
edge inputs (`k9_edge_cases`, both layouts) within its tolerances of its
plain version and its baseline design (the design before), bit-equal
across launches and to its own build with the band cull off, and timed
in turns against the baseline and at 1 and 4 pixels a thread, cut at
five stages. K9's forward and K8's, which walk with
`csrc/coeff_walk_fwd.cuh` (K2's batched walk on their rule) and write
each tile's block as 16-byte stores, are held on their edge inputs
(`k9_edge_cases`, both layouts; `k8_edge_cases`: K9's tile inputs at C 3
and 6 and whole-K tiles with opacity-0 padding) within the image
tolerances of plain and bit-equal to their baseline designs (the designs
before), across launches, to their own builds with the band cull off and
at C 6 to their walks at 1, 2 and 4 slots a batch; at full width too
(frame 0 and the stage bench's shapes), K8 on frame 0's K9 tile inputs
within the image tolerances of K9's tiles; both are timed in turns
against their baselines with the batch sizes beside them, cut at three
stages, with ptxas' registers. K9's route (the backward's second
kernel, the per-lane sum of the slots' rows) is held bit-equal to its
design before, to its plain version, across launches and at 2, 4, 8, 16
and 32 threads a lane on its own edge inputs (`route_edge_cases`), on kernel
1's scratch of every `k9_edge_cases` case and at frame 0, and timed alone
in turns by CUDA events behind a spin against its design before and the
plain path's `scatter_add_`. K5's and K7's backwards, which walk with
K3's walk, are
held bit-equal to K3's drec given K3's cotangent in their layouts, on
K3's edge inputs (`check_rec_bwd_edges`), at K5's four tile offsets and
at full width, within K3's tolerances of their plain versions and their
baseline designs, and timed in turns against the baselines and K3. K5's
and K7's forwards, which walk with K2's walk and write their tiles' rows
as 16-byte stores, are held bit-equal to K2's image of the same tiles and
to their baseline designs (the designs before) on K2's edge inputs
(`check_rec_fwd_edges`), at K5's four tile offsets and at full width,
within the image tolerances of their plain versions, and timed in turns
against the baselines and K2, with ptxas' registers. Then it
drives the paths of the full-width synthetic avatar (3 garments x 45,000
Gaussians, 1024 x 667 pixels, random weights from seed 0):

- serving: eval-mode `avatar_forward` + champion `rasterize_tiled` (6
  channels, dupsort_depth, dup 3, K 256) for 20 frames;
- training: bench_train.py's step (fused RGB + silhouette raster, L1 +
  SSIM + regularizers, clipped Adam): one step's loss terms and every
  parameter leaf's gradient with the kernels against the plain versions,
  then 10 steps;
- capture: the capture configs' training options on the same step
  (`CAPTURE_CONFIGS`): configs/goliath_axe184.yml's learnable blur, then
  every option the port added for them at once (blur, the pixel bias, a
  bg net with the blurred-noise target live, optimizable poses and
  global rotation / translation through the rebuilt camera, the random
  VGG stack's term), each with one step's terms and gradients kernels
  vs plain, every added leaf's gradient finite and nonzero, then 5 steps
  with K1-K4 once a step, ms/step and a profile;
- sharded: on a NCCL world of one process (one card; NCCL puts no two
  ranks on one GPU), `rasterize_sharded` on frame 0's Gaussians against
  the single-device `rasterize_tiled`, then bench_scaling.py's banded
  objective (`rasterize_collective(banded=True)`, 0.8 L1 + 0.2 (1 -
  SSIM)): its gradients with the kernels against the plain versions,
  then 10 forward+backward calls;
- variants: the training step under the ActorsHQ actor's raster settings
  (dupsort_tile, dup 4) in the rec layout (K7) and the ct layout (K2/K3),
  each with one step's gradients kernels vs plain and then 5 steps; the
  xla backend (topk funnel, `_blend_tiles`) forward + backward against
  the same selection blended by K2, with its peak memory; the public
  API's backends against the oracle on a small scene;
- fused: `rasterize_tiled_fused` (K9) against `rasterize_tiled`'s topk
  funnel at the same block cap; the training step with `raster_backend:
  fused`, one step's gradients kernels vs plain, then 5 steps; the stage
  bench (`d3ga_tpu_torch/bench_stages.py`, bench.py's 135,000-Gaussian
  scene: per-stage times, K8 forward and backward among them), its JSON
  in run_out/bench_stages.json;
- probes: P1's matmuls (TF32 and 3xTF32 on `wgmma`, whose SASS must
  hold GMMA instructions; FP32 SIMT) and P2's passthrough against their
  plain versions and their designs before; K2, K3, K9 and K9's backward
  against the JAX kernels' outputs on the two cases on the alpha
  threshold (`ON_THRESHOLD_FIXTURE`, a report); the probes' own runs
  (`d3ga_tpu_torch/probes/`: P1's 15 matmul cases on one CTA and on one
  CTA per SM, its 4 roll cases, P2's passthroughs and gathers, P3's
  stages (cuts of K9's forward) on frame 0's K9 inputs and K9's
  backward's two kernels apart), one JSON line each; P1, P2 and P3 timed
  in turns against their designs before;

and checks that the kernels carried every frame, step, call and probe.

    python3 chip_smoke.py

Prints the card (nvidia-smi name, power limit), the checks, timings (a
profile that recorded fewer calls than it ran on a line of its own), a
`{"kernels": [...]}` JSON line and, last, `{"ok": true, "device": ...}`.
Details go to run_out/chip_smoke.json. Exits non-zero, before any
result line, without a CUDA device or on any failed phase; a failure is
also printed, with its traceback, to standard error.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from d3ga_tpu_torch.data.synthetic import serving_scene
from d3ga_tpu_torch.dist.banded import banded_l1_ssim
from d3ga_tpu_torch.dist.mesh import initialize_distributed, local_mesh
from d3ga_tpu_torch.dist.raster_shard import rasterize_collective, rasterize_sharded
from d3ga_tpu_torch.model.avatar import avatar_forward, init_avatar
from d3ga_tpu_torch import bench_stages, probes
from d3ga_tpu_torch.probes import (COEFF_BWD_SFU_PER_PAIR, FP32_OPS_PER_S, HBM_BYTES_PER_S,
                                    SFU_OPS_PER_S, coeff_bound, coeff_bwd_ops, coeff_fwd_ops,
                                    device_events, fused_bisect, mxu, widerow)
from d3ga_tpu_torch.raster import api, blend, blend_ct, blend_rec, extract, fused, segsum, tiles
from d3ga_tpu_torch.raster.camera import focal2fov, make_camera
from d3ga_tpu_torch.raster.project import project_gaussians
from d3ga_tpu_torch.raster.tiles import bin_gaussians, rasterize_tiled
from d3ga_tpu_torch.train.losses import full_float32, init_vgg19_features
from d3ga_tpu_torch.train.optim import lr_tree_from_config, make_optimizer
from d3ga_tpu_torch.train.step import (LossWeights, make_train_step, needs_noise, random_bg,
                                       random_noise)
from d3ga_tpu_torch.utils import cuda_build
from d3ga_tpu_torch.utils.tree import tree_leaves

# serving width: the scene of the JAX package's serving benchmark
# (data/synthetic.py::serving_scene's defaults)
N_GARMENTS, N_PER_GARMENT, CAGE_RES = 3, 45000, 3
WIDTH, HEIGHT, K, DUP = 667, 1024, 256, 3
FRAMES = 20
STEPS = 10
SHARD_CALLS = 10  # forward+backward calls of the banded objective
SHARD_EMULATE = 4  # K5 is held at the tile offsets of the ranks of a 4-way banded split
BG6 = (1.0, 1.0, 1.0, 0.0, 0.0, 0.0)
DUP2 = DUP * DUP
# bench_train.py's raster configuration
TRAIN_CONFIG = {
    "raster_backend": "pallas_blend", "raster_opts": {"coarse": "dupsort_depth", "dup": DUP},
}
# the small cross-device check: the CPU tests' slice size
SMALL = dict(n_garments=2, n_gaussians=150, width=64, height=48, k=128)
# the ActorsHQ actor's raster settings (configs/actorshq_actor02.yml)
ACTORSHQ_CONFIG = {
    "raster_backend": "pallas_blend", "raster_opts": {"coarse": "dupsort_tile", "dup": 4},
}
VARIANT_STEPS = 5  # training steps under those settings, in each blend layout
# the capture configs' training options (configs/goliath_axe184.yml:
# use_blur, on bench_train.py's raster configuration), then every option
# the port added for them at once: blur, the pixel bias, a bg net whose
# warm-up (enable_bg) is still on (the blurred-noise target live),
# optimizable poses and global rotation / translation with the capture
# extrinsics (the camera rebuilt in the graph), the random VGG stack
# counted from iteration 1 (run at iteration 2)
CAPTURE_CONFIGS = {
    "goliath": dict(TRAIN_CONFIG, use_blur=True),
    "every": dict(TRAIN_CONFIG, use_blur=True, use_pixel_cal=True, use_bg_network=True,
                  enable_bg=1000, use_opt_smplx=True, image_height=HEIGHT, image_width=WIDTH),
}
CAPTURE_ITERATION, CAPTURE_VGG_FROM = 2, 1
CAPTURE_STEPS = 5  # training steps of each capture config
# the leaves each config adds, whose gradients must be finite and nonzero
CAPTURE_LEAVES = {
    "goliath": ("learnable_blur",),
    "every": ("learnable_blur", "pixel_cal", "bg_net", "optimizable_poses",
              "optimizable_rotations", "optimizable_translations"),
}
FUSED_CONFIG = {"raster_backend": "fused"}  # the JAX package's fused backend
FUSED_STEPS = 5  # training steps under it
BLOCK_CAP = 4096  # rasterize_tiled_fused's default candidates a block
STAGE_ITERS = 10  # calls per stage of the stage bench
# the stage bench's scene: bench.py's (135,000 Gaussians, 1024 x 667, K 256)
STAGE_SCENE = dict(n=bench_stages.N_GAUSS, width=bench_stages.WIDTH,
                   height=bench_stages.HEIGHT, k=bench_stages.K)
# the probes phase (P1-P3): the loop probes' longer timed launch, the
# calls each passthrough and stage is timed over, the matmul and roll
# cases (the TPU tools' lists), widerow's size divisor (1: full size)
PROBE_TARGET_MS = 10.0
PROBE_ITERS = 10
PROBE_MATMUL_CASES = mxu.CASES
PROBE_ROLL_CASES = mxu.ROLL_CASES
PROBE_SCALE = 1
# P1 tolerances: each kernel against its plain version at the same
# precision (float32 sums in another order; TF32 products are exact in
# float32), and TF32 / 3xTF32 against float64 (TF32 keeps 10 mantissa bits;
# 3xTF32 drops only the small x small term)
MATMUL_REL_L2 = 1e-6
MATMUL_FP64_REL_L2 = {"default": 2e-3, "high": 1e-5}
# P3 stage 2 against plain: sums of up to K records in another order, each
# channel's error relative to its largest |value|
STAGE2_REL = 1e-5
# tools/fused_bisect.py's shapes: K 256, C 3, 2 blocks of 4 chunks of 128
BISECT_K, BISECT_C, BISECT_NB, BISECT_NC = 256, 3, 2, 4
# the API's backends against the oracle: tests/test_torch_api.py's scene
# (120 Gaussians, 80 x 56 pixels; the oracle holds [rows x W, N] per chunk)
API_N, API_W, API_H = 120, 80, 56

# image tolerances (PALLAS_PARITY.json's columns): threshold flips of the
# alpha >= 1/255 and T < 1e-4 rules dominate max-abs, so p999 and the
# share of pixels off by more than 1e-2 are held instead
P999_MAX, FLIP_AT, FLIP_MAX = 5e-4, 1e-2, 1e-3
# K3's per-slot cotangents against the plain version: the same threshold
# flips move a record's cotangent by one pixel's share, so the p999 error
# (as a share of the largest |value|: sums of up to 256 float32 terms in
# another order) and the relative L2 over all slots are held
K3_P999_REL, K3_REL_L2 = 1e-5, 1e-3
# K4 against its plain version: the same sums in the same order; only a
# compiler's reassociation could move them (relative to the largest)
K4_REL = 1e-6
# the training step's kernels a call before K1's and K4's callers folded
# their epilogues into the kernels (PERF.md section 5), and the launches
# they gave up: K1's live mask (arange, clamp, compare) and its where (a
# fill of the scalar -1, the select); K4's perm conversion, new_zeros and cat
STEP_KERNELS_BEFORE = 5591
K1_LAUNCHES_FOLDED, K4_LAUNCHES_FOLDED = 5, 3
STEP_LAUNCHES_FOLDED = K1_LAUNCHES_FOLDED + K4_LAUNCHES_FOLDED
# one training step, kernels against plain: loss terms (image means of
# float32 sums) and each parameter leaf's gradient (relative L2; the
# threshold flips above reach every upstream leaf)
TERM_RTOL, GRAD_REL_L2 = 1e-5, 1e-3

# The blends' operations bounds count the (pixel, record) pairs a walk
# visits (`blend_work`: before each pixel's stop) in two kinds. A used
# pair (power <= 0 and alpha >= 1/255) costs the forward the falloff
# polynomial, the alpha rules, the T update and C = 6 colour FMAs, and
# one exp:
BLEND_FP32_OPS_PER_PAIR = 25
BLEND_SFU_PER_PAIR = 1
# a pair that is not used only the polynomial (a multiply and four FMAs,
# FMAs as two), the power's add and its test, and the exp that decides
# alpha >= 1/255 (needed wherever power <= 0; charged to every unused
# pair, so the bound stays a little above the least work)
BLEND_TEST_FP32_OPS_PER_PAIR = 10
BLEND_TEST_SFU_PER_PAIR = 1
# backward: a used pair costs the forward recompute (25), then dw (12),
# the suffix and dalpha (8), and the 12 per-pixel contributions to the
# per-record sums, with an exp in each walk and one division; an unused
# one the polynomial, its test and the exp in each walk
BLEND_BWD_FP32_OPS_PER_PAIR = 60
BLEND_BWD_SFU_PER_PAIR = 3
BLEND_BWD_TEST_FP32_OPS_PER_PAIR = 20
BLEND_BWD_TEST_SFU_PER_PAIR = 2


OUT_DIR = "run_out"
# the JAX kernels' outputs on K3_ON_THRESHOLD and K9_ON_THRESHOLD
# (tests/test_torch_on_threshold.py writes and holds it)
ON_THRESHOLD_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "d3ga_tpu_torch",
                                    "fixtures", "on_threshold.npz")


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def timer_ms(fn, iters, dev, warmup=2):
    """Mean wall milliseconds per call: CUDA events around `iters` calls
    on the card, so a call whose host side outlasts its kernels measures
    the host side."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
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


def device_ms(fn, iters, dev):
    """Device milliseconds per call: the summed duration of the kernels
    `fn` launches, from torch.profiler (CUPTI, `probes.device_ms`); None
    where it records no device activity."""
    d = probes.device_ms(fn, iters, dev)
    return None if d is None else d["total"]


def profile_calls(fn, calls, dev):
    """torch.profiler over `calls` calls (`probes.profiled`: after an
    unprofiled call and a warm-up one): wall and device-busy milliseconds
    per call, the device's idle share, kernels launched per call, host
    time in cudaLaunchKernel per call, and the kernels by device time;
    None off the card."""
    run = probes.profiled(fn, calls, dev)
    if run is None:
        return None
    from torch.autograd import DeviceType

    prof, wall, rec, attempts = run
    rec = max(rec, 1)
    events = prof.key_averages()
    kern = sorted(((e.key, *probes.per_call(e, rec)) for e in device_events(prof, DeviceType)),
                  key=lambda k: -k[1])
    busy = sum(ms for _, ms, _ in kern)
    launch = sum(e.self_cpu_time_total for e in events if e.key == "cudaLaunchKernel")
    return {
        "calls": calls, "recorded_calls": rec, "attempts": attempts, "wall_ms": wall,
        "device_busy_ms": busy, "idle_share": 1 - busy / wall,
        "kernels_per_call": sum(n for _, _, n in kern), "launch_host_ms": launch / 1e3 / calls,
        "top": kern[:12],
    }


def profile_summary(prof, unprofiled_ms):
    """One line of profile_calls' result, the idle share also against the
    unprofiled wall time of a call."""
    return (f"wall {prof['wall_ms']:.3f} ms, device busy {prof['device_busy_ms']:.3f} ms over "
            f"{prof['recorded_calls']} recorded of {prof['calls']} calls (idle "
            f"share {prof['idle_share']:.3f}; against the unprofiled call "
            f"{1 - prof['device_busy_ms'] / unprofiled_ms:.3f}), {prof['kernels_per_call']:.0f} "
            f"kernels and {prof['launch_host_ms']:.3f} ms of cudaLaunchKernel a call; top kernels "
            + "; ".join(f"{k[:60]} {ms:.3f} ms x{n:g}" for k, ms, n in prof["top"][:6]))


def measure(fn, iters, dev, warmup=2):
    """{"call_ms": wall per call (events), "device_ms": kernel time per
    call (profiler), "ms": device_ms where recorded, else call_ms}."""
    call = timer_ms(fn, iters, dev, warmup)
    devt = device_ms(fn, iters, dev)
    return {"call_ms": call, "device_ms": devt, "ms": devt if devt is not None else call}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def in_turns(fns, iters, dev, kernel=None, profiler=True):
    """Each of `fns` ({name: fn}) timed twice, in turns: the names in order,
    then in reverse (old, new, new, old), each turn by `probes.device_ms`
    (device ms a call, torch.profiler; with `kernel`, only the launches of
    the kernels whose name holds it; not with profiler=False) and
    `probes.queued_ms` (CUDA events around calls queued behind a spin:
    every launch of the call). Returns {name: {"device_ms": [two turns]
    (with the profiler), "queued_ms": [two turns], "ms": the mean of the
    device turns recorded, else of the queued ones}}."""
    out = {k: {"device_ms": [], "queued_ms": []} if profiler else {"queued_ms": []} for k in fns}
    for k in list(fns) + list(reversed(fns)):
        if profiler and kernel is None:
            out[k]["device_ms"].append(device_ms(fns[k], iters, dev))
        elif profiler:
            d = probes.device_ms(fns[k], iters, dev, (kernel,))
            out[k]["device_ms"].append(None if d is None else d[kernel]["ms"])
        out[k]["queued_ms"].append(probes.queued_ms(fns[k], iters, dev))
    for v in out.values():
        got = [t for t in v.get("device_ms", []) if t is not None] or [
            t for t in v["queued_ms"] if t is not None]
        v["ms"] = float(np.mean(got)) if got else None
    return out


def turns_summary(turns):
    def ms(ts):
        return "/".join("-" if t is None else f"{t:.5f}" for t in ts)

    return "; ".join(
        f"{k} " + ("-" if v["ms"] is None else f"{v['ms']:.5f}") + " ms ("
        + ", ".join(f"{w} {ms(v[w + '_ms'])}" for w in ("device", "queued") if w + "_ms" in v)
        + ")" for k, v in turns.items())


def folded_launches(callers):
    """(kernels a call before, after) of a caller's two profiles
    (`profile_calls`); None where either recorded nothing."""
    if any(v is None for v in callers.values()):
        return None
    return tuple(round(callers[k]["kernels_per_call"]) for k in ("before", "after"))


def bits(t):
    """A 32-bit tensor's bit patterns (float32 viewed as int32)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def k1_edge_cases(dev):
    """K1's edge inputs, made from seed 12 on `dev`: (name, stream, starts,
    kk, counts or None, fill) for int32 and float32 streams, kk in {1, 3,
    37, 256}, starts not a multiple of 4 and windows that cross m, counts
    0 and > kk, a stream 4 bytes past a 16-byte boundary, and one shorter
    than a 16-byte group."""
    rng = np.random.default_rng(12)
    m = 1000
    full = {
        "int32": torch.from_numpy(rng.integers(-2**31, 2**31, m + 1).astype(np.int32)).to(dev),
        "float32": torch.from_numpy(rng.normal(size=m + 1).astype(np.float32)).to(dev),
    }
    fills = {"int32": -1, "float32": float("inf")}
    cases = []
    for dt, stream in full.items():
        for kk in (1, 3, 37, 256):
            for off in (0, 1):  # off 1: the view starts 4 bytes past the allocation's start
                starts = np.sort(np.concatenate([
                    [0, 1, 2, 3, 5, m - kk // 2 - 1, m - 3, m - 1, m],
                    rng.integers(0, m + 1, 40)])).astype(np.int32)
                counts = rng.integers(0, kk + 8, starts.size).astype(np.int32)
                counts[:4] = (0, kk, kk + 5, 1)
                counts[-3:] = (kk + 5, 3, 0)
                st, ct = (torch.from_numpy(a).to(dev) for a in (starts, counts))
                name = f"{dt} kk={kk} offset={off}"
                cases.append((name, stream[off : off + m], st, kk, None, 0))
                cases.append((name + " counts", stream[off : off + m], st, kk, ct, fills[dt]))
    st = torch.tensor([0, 1, 2, 3], dtype=torch.int32, device=dev)
    ct = torch.tensor([3, 0, 300, 1], dtype=torch.int32, device=dev)
    cases.append(("int32 m=3 kk=256", full["int32"][:3], st, 256, None, 0))
    cases.append(("int32 m=3 kk=256 counts", full["int32"][:3], st, 256, ct, -1))
    return cases


def k4_edge_cases(dev):
    """K4's edge inputs, made from seed 11 on `dev`: (name, ids_sorted [m]
    int32, g [CR, m'], n, perm [m] int64 or None, dup2) with n not a
    multiple of 32; Gaussians with empty runs at the start, the middle and
    the end; a warp of runs of exactly dup^2 = 9; only sentinels; m < 32;
    n = 0; runs longer than a 32-id chunk; a deep search (m ~ 190 K); the
    slot-row layout (rows of CR floats read through perm, 16-byte vectors)
    and the column layout and CR 9 (scalar reads)."""
    rng = np.random.default_rng(11)

    def case(name, runs, sentinels, CR=12, layout="rows", dup2=DUP2):
        n = len(runs)
        ids = np.concatenate([np.repeat(np.arange(n), runs), np.full(sentinels, n)])
        m = ids.size
        vals = rng.normal(size=(m, CR)).astype(np.float32)
        if layout == "rows":  # combine_from_slots' layout: slot rows, read through perm
            perm = rng.permutation(m)
            rows = np.empty_like(vals)
            rows[perm] = vals
            g, p = torch.from_numpy(rows).to(dev).T, torch.from_numpy(perm).to(dev)
        else:  # contiguous [CR, m] columns in sorted order
            g, p = torch.from_numpy(np.ascontiguousarray(vals.T)).to(dev), None
        return (name, torch.from_numpy(ids.astype(np.int32)).to(dev), g, n, p, dup2)

    runs = rng.integers(0, DUP2 + 1, 1007)
    runs[:40], runs[500:540], runs[-45:] = 0, 0, 0
    runs[96:128] = DUP2
    long = np.ones(70, np.int64)
    long[5], long[6] = 70, 33
    return [
        case("n=1007, empty runs at start/middle/end, a warp of 9s", runs, 300),
        case("the same, columns", runs, 300, layout="columns"),
        case("the same, CR=9", runs, 300, CR=9),
        case("only sentinels", np.zeros(100, np.int64), 500),
        case("m < 32", np.array([2, 0, 0, 1, 0, 0, 0, 3] + [0] * 31 + [1]), 2),
        case("n = 0", np.zeros(0, np.int64), 40),
        case("runs over 32-id chunks", long, 5, dup2=None),
        case("deep search", rng.integers(0, DUP2 + 1, 20000), 100000),
    ]


K3_EDGE_K = 256  # K3's edge inputs' slots a tile: the champion K


def k3_edge_cases(dev):
    """K3's edge inputs, made from seed 13 on `dev`: (name, records_ext
    [n+1, CR] (zero sentinel row last; columns past 6 + C hold noise),
    idx [T, K] int32, counts [T] int32, g [(C+1), nty*16, ntx*16], ntx,
    nty, C) with K = K3_EDGE_K: counts 0, 1, 63, 64, 65, 255, 256, > K and
    < 0 (the last with real ids in every slot, the rest with the sentinel
    n past each count); sentinel ids inside the count; opaque wide records
    that stop every pixel at the third record; opaque records (raw >=
    0.99, where dp is 0); opacity 0; records wholly off the tile; C in
    {1, 3, 6, 8} with CR in {6 + C, 16}; grids of 1x1 and 3x2 tiles; and
    faint records (`band_edge_records`) whose ellipse reaches each row of
    the tile from beyond it, just inside the alpha threshold there and, in
    K3_ON_THRESHOLD, on it."""
    rng = np.random.default_rng(13)
    K = K3_EDGE_K

    def records(n, ntx, nty, C, CR, sigma=(1.5, 8.0), opac=(0.3, 0.95)):
        xy = rng.uniform(-8, 16 * np.array([ntx, nty]) + 8, (n, 2))
        s = rng.uniform(*sigma, (n, 2))
        th = rng.uniform(0, np.pi, n)
        R = np.stack([np.cos(th), -np.sin(th), np.sin(th), np.cos(th)], -1).reshape(n, 2, 2)
        inv = np.linalg.inv(R @ (np.eye(2) * (s**2)[:, None, :]) @ np.swapaxes(R, -1, -2))
        conic = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1)
        rec = np.concatenate([xy, conic, rng.uniform(*opac, (n, 1)), rng.uniform(0, 1, (n, C)),
                              rng.normal(size=(n, CR - 6 - C))], -1)
        return np.concatenate([rec, np.zeros((1, CR))]).astype(np.float32)

    def ids(n, counts, junk=False, pick=None):
        """Distinct ids of [0, pick or n) in each tile's live slots (every
        slot with junk), the sentinel n past them."""
        idx = np.full((len(counts), K), n, np.int64)
        for t, c in enumerate(counts):
            live = K if junk else min(max(int(c), 0), K)
            idx[t, :live] = rng.choice(pick or n, live, replace=False)
        return idx

    def case(name, rec, idx, counts, ntx, nty, C):
        g = rng.normal(size=(C + 1, nty * 16, ntx * 16)).astype(np.float32)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            rec, idx.astype(np.int32), np.asarray(counts, np.int32), g)]
        return (name, *t, ntx, nty, C)

    cases = []
    rec = records(600, 3, 2, 6, 12)
    counts = [0, 1, 63, 64, 65, 255]
    cases.append(case("counts 0/1/63/64/65/255", rec, ids(600, counts), counts, 3, 2, 6))
    counts = [256, 256, 128, 200, 256, 64]
    cases.append(case("counts 256", rec, ids(600, counts), counts, 3, 2, 6))
    counts = [300, -5, 257, -1, 2**31 - 1, -(2**31)]
    cases.append(case("counts > K and < 0, real ids in every slot", rec,
                      ids(600, counts, junk=True), counts, 3, 2, 6))
    idx = ids(300, [200])
    idx[0, rng.choice(200, 70, replace=False)] = 300
    cases.append(case("sentinel ids inside the count", records(300, 1, 1, 6, 12), idx, [200],
                      1, 1, 6))
    # three opaque wide records first in every tile (opacity 0.985-0.989,
    # sigma 100 px, centred within 2 px of the tile's centre): T stays
    # above 1.2e-4 after two and falls under 2.3e-5 at the third at every
    # pixel, so each tile's walk stops at its third record
    rec = records(400, 3, 2, 6, 12)
    wide = 400 - 3 * 6 + np.arange(18)
    tiles = np.repeat(np.arange(6), 3)
    rec[wide, 0] = 16 * (tiles % 3) + 7.5 + rng.uniform(-2, 2, 18)
    rec[wide, 1] = 16 * (tiles // 3) + 7.5 + rng.uniform(-2, 2, 18)
    rec[wide, 2:5] = (1e-4, 0.0, 1e-4)
    rec[wide, 5] = rng.uniform(0.985, 0.989, 18)
    counts = [100, 256, 3, 40, 200, 64]
    idx = ids(400, counts, pick=400 - 18)
    idx[:, :3] = wide.reshape(6, 3)
    cases.append(case("every pixel stopped at the third record", rec, idx, counts, 3, 2, 6))
    # a quarter opaque (opacity 1) and wide (sigma 20 px): raw >= 0.99
    # within ~2.8 px of their centres
    rec = records(600, 3, 2, 6, 12)
    rec[:-1:4, 2:5] = (1 / 400, 0.0, 1 / 400)
    rec[:-1:4, 5] = 1.0
    counts = [256, 180, 256, 90, 256, 30]
    cases.append(case("raw >= 0.99", rec, ids(600, counts), counts, 3, 2, 6))
    rec = records(300, 1, 1, 6, 12)
    rec[:-1:3, 5] = 0.0
    cases.append(case("opacity 0", rec, ids(300, [150]), [150], 1, 1, 6))
    # half the records 40-200 px from the tile in x and in y (at least 32
    # px from its pixels in each), sigma <= 8 px: their falloff at every
    # pixel of the tile is below exp(-16)
    rec = records(300, 1, 1, 6, 12)
    off = rng.uniform(40, 200, (150, 2)) * rng.choice([-1, 1], (150, 2))
    rec[:300:2, :2] = 8 + off
    cases.append(case("records wholly off the tile", rec, ids(300, [120]), [120], 1, 1, 6))
    for C in (1, 3, 6, 8):
        for CR in (6 + C, 16):
            ntx, nty = (1, 1) if CR == 16 else (3, 2)
            counts = rng.integers(0, K + 1, ntx * nty)
            rec = records(500, ntx, nty, C, CR)
            cases.append(case(f"C={C} CR={CR} {ntx}x{nty}", rec, ids(500, counts), counts,
                              ntx, nty, C))
    # each tile: 32 faint records reaching its 16 rows (two each) among 96
    # faint-opacity background records, shuffled; so that no pixel stops
    for name, q in ((K3_INSIDE_THRESHOLD, 0.9), (K3_ON_THRESHOLD, 1.0)):
        back = records(6 * 96, 3, 2, 6, 12, opac=(0.02, 0.1))[:-1]
        faint = band_edge_records(rng, 3, 2, 2, q, CR=12, C=6)
        rec = np.concatenate([back, faint, np.zeros((1, 12), np.float32)])
        n = len(rec) - 1
        idx = np.full((6, K), n, np.int64)
        for t in range(6):
            idx[t, :128] = rng.permutation(np.concatenate(
                [np.arange(96 * t, 96 * t + 96), 6 * 96 + np.arange(32 * t, 32 * t + 32)]))
        cases.append(case(name, rec, idx, [128] * 6, 3, 2, 6))
    return cases


# the faint records' cases: the pixel where each record's ellipse reaches
# a row lies just inside the alpha >= 1/255 threshold (at 0.9 of the
# ellipse's Q), or on it (the alpha test there decides by rounding: the
# kernel and the plain version may take it apart, so that case is held
# bit for bit against the kernel with the band cull off, not against the
# plain version's sums)
K3_INSIDE_THRESHOLD = "faint records inside the band edges"
K3_ON_THRESHOLD = "faint records on the band edges"


def band_edge_records(rng, ntx, nty, per_row, q, CR, C):
    """Faint records for each tile of an ntx x nty grid, tile-major, 16
    x per_row a tile: opacity in (1, 1.02) / 255 (on the threshold, down
    to a few float32 ulps above 1/255; (1.01, 1.02) / 255 inside it, where
    the power's margin is 1e-3), so that
    alpha >= 1/255 holds only in the ellipse Q <= q r2, r2 = 2 log(255
    op), which shrinks to the centre; sigma 0.5-200 px (log-uniform, the
    two axes within 2x, any angle). Record j of row r is placed so that
    its ellipse's extreme in y lies on pixel (col, r) of its tile, col
    random: for even r the ellipse reaches down into row r (the first of
    its 2-row band) from a centre above it, for odd r up into row r (the
    band's last) from below, so every band boundary and both tile edges
    are crossed, as K3's band cull must allow for."""
    out = []
    for t in range(ntx * nty):
        ox, oy = 16.0 * (t % ntx), 16.0 * (t // ntx)
        for r in range(16):
            for _ in range(per_row):
                sx = np.exp(rng.uniform(np.log(0.5), np.log(200.0)))
                sy = sx * np.exp(rng.uniform(-np.log(2.0), np.log(2.0)))
                th = rng.uniform(0, np.pi)
                R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
                A, B, Cc = (lambda m: (m[0, 0], m[0, 1], m[1, 1]))(
                    np.linalg.inv(R @ np.diag([sx * sx, sy * sy]) @ R.T))
                if q == 1.0:  # excess from 3e-7 (a few float32 ulps) to 0.02, log-uniform
                    op = max(np.float32((1.0 + 10.0 ** rng.uniform(-6.5, np.log10(0.02))) / 255.0),
                             np.nextafter(np.float32(1.0 / 255.0), np.float32(1.0)))
                else:
                    op = np.float32(rng.uniform(1.01, 1.02) / 255.0)
                r2 = 2.0 * np.log(255.0 * np.float64(op))
                dy = np.sqrt(q * r2 * A / (A * Cc - B * B)) * (1.0 if r % 2 == 0 else -1.0)
                col = rng.integers(0, 16)
                # the extreme in y of Q = q r2 is at dx = -B dy / A
                xy = (ox + col + B / A * dy, oy + r - dy)
                out.append([*xy, A, B, Cc, op, *rng.uniform(0, 1, C),
                            *rng.normal(size=CR - 6 - C)])
    return np.asarray(out, np.float32)


K9_EDGE_K, K9_EDGE_KB = 256, 384  # K9's edge inputs: the champion K, three 128-lane chunks a block
# the faint candidates' cases of K9 (band_edge_records' placement, one
# tile each, in the 8 tiles of a block's first row): the one on the
# threshold is held bit for bit against the kernel with the band cull off,
# not against the plain version's sums (its alpha tests decide by rounding)
K9_INSIDE_THRESHOLD = "faint candidates inside the band edges"
K9_ON_THRESHOLD = "faint candidates on the band edges"


def k9_edge_cases(dev):
    """K9's edge inputs, made from seed 17 on `dev`: (name, vals [NB, kb,
    16] records-major float32 (block-local pixels; the padding channels
    hold noise), rects [NB, kb] int32, g [NB, 64, 256, C+1], C) with K =
    K9_EDGE_K, kb = K9_EDGE_KB, lanes in random order: tiles whose
    uncapped count is 0, 1, 255, 256 and 300 (> K) among candidates whose
    rect misses them, and candidates whose rect holds a tile their
    Gaussian lies 40-100 px from; three opaque wide candidates first in
    each tile of a row, which stop every pixel there at the third slot;
    opaque wide candidates (raw >= 0.99); opacity 0; invalid candidates
    (rect 0, opacity 0, noise elsewhere); faint candidates whose ellipse
    reaches each row of their tile from beyond it, just inside the alpha
    threshold op * exp(power) >= 1/255 there and, in K9_ON_THRESHOLD, on
    it; C in {1, 3, 6, 8}, two blocks at C 3."""
    rng = np.random.default_rng(17)
    kb = K9_EDGE_KB

    def cands(n, C, lo, hi, sigma=(1.5, 8.0), opac=(0.3, 0.95)):
        """(n candidates [n, 16] centred in the block-local box lo-hi, their
        3-sigma radii)."""
        xy = rng.uniform(lo, hi, (n, 2))
        s = rng.uniform(*sigma, (n, 2))
        th = rng.uniform(0, np.pi, n)
        R = np.stack([np.cos(th), -np.sin(th), np.sin(th), np.cos(th)], -1).reshape(n, 2, 2)
        inv = np.linalg.inv(R @ (np.eye(2) * (s**2)[:, None, :]) @ np.swapaxes(R, -1, -2))
        conic = np.stack([inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]], -1)
        v = np.concatenate([xy, conic, rng.uniform(*opac, (n, 1)), rng.uniform(0, 1, (n, C)),
                            rng.normal(size=(n, 16 - 6 - C))], -1)
        return v, np.ceil(3 * s.max(-1))

    def rect(x0, x1, y0, y1):
        return np.asarray(x0 | (x1 << 8) | (y0 << 16) | (y1 << 24), np.int64)

    def cover(v, radius, min_ty=0):
        """Each candidate's rect of the tiles its 3-sigma box touches (rows
        from min_ty)."""
        lo = np.clip(np.floor((v[:, :2] - radius[:, None]) / 16), 0, 8).astype(np.int64)
        hi = np.clip(np.floor((v[:, :2] + radius[:, None] + 15) / 16), 0, 8).astype(np.int64)
        lo[:, 1] = np.maximum(lo[:, 1], min_ty)
        r = rect(lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1])
        return np.where((hi[:, 0] > lo[:, 0]) & (hi[:, 1] > lo[:, 1]), r, 0)

    def invalid(v, r, n):
        """The last n candidates invalid: rect 0, opacity 0, noise elsewhere."""
        r[-n:] = 0
        v[-n:, 5] = 0.0
        v[-n:, 6:] = rng.normal(size=(n, 10))

    def block(v, r, first=0):
        """One block, lanes first.. in random order."""
        order = np.concatenate([np.arange(first), first + rng.permutation(len(v) - first)])
        return v[order].astype(np.float32), r[order]

    def random_block(C):
        v, rad = cands(kb, C, -24, 152)
        wide = rng.uniform(size=kb) < 0.08
        v[wide, 2:6] = (1 / 400, 0.0, 1 / 400, 1.0)
        rad[wide] = 60
        r = cover(v, rad)
        invalid(v, r, 40)
        return block(v, r)

    def case(name, blocks, C):
        vals = np.stack([b[0] for b in blocks])
        rects = np.stack([b[1] for b in blocks]).astype(np.int32)
        g = rng.normal(size=(len(blocks), 64, 256, C + 1)).astype(np.float32)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (vals, rects, g)]
        return (name, *t, C)

    cases = []
    # row 0's tiles 0-4 hold 0, 1, 255, 256 and 300 candidates (tiles 2-4
    # share 255, 3-4 one more, 4 another 44); the other 83 cover rows 1-7
    parts = []
    for n, (x0, x1), box in ((255, (2, 5), (32, 80)), (1, (3, 5), (48, 80)),
                             (44, (4, 5), (64, 80)), (1, (1, 2), (16, 32))):
        v, _ = cands(n, 6, 0, 16)
        v[:, 0] = rng.uniform(*box, n)
        parts.append((v, np.full(n, int(rect(x0, x1, 0, 1)))))
    far = rng.choice(255, 30, replace=False)  # rect on row 0, Gaussian 40-100 px below it
    parts[0][0][far, 1] = rng.uniform(56, 116, 30)
    v, rad = cands(83, 6, -8, 136)
    v[:, 1] = rng.uniform(24, 136, 83)
    r = cover(v, rad, min_ty=1)
    invalid(v, r, 20)
    parts.append((v, r))
    cases.append(case("counts 0/1/255/256/300, rects that miss the tile",
                      [block(np.concatenate([p[0] for p in parts]),
                             np.concatenate([p[1] for p in parts]))], 6))
    # three opaque wide candidates (opacity 0.985-0.989, sigma 100 px,
    # centred within 2 px of the tile's centre) first in each tile of row
    # 0: T stays above 1e-4 after two and falls under it at the third
    v, rad = cands(kb, 6, -8, 136)
    r = cover(v, rad)
    t = np.repeat(np.arange(8), 3)
    v[:24, 0] = 16 * t + 7.5 + rng.uniform(-2, 2, 24)
    v[:24, 1] = 7.5 + rng.uniform(-2, 2, 24)
    v[:24, 2:5] = (1e-4, 0.0, 1e-4)
    v[:24, 5] = rng.uniform(0.985, 0.989, 24)
    r[:24] = rect(t, t + 1, 0, 1)
    cases.append(case("every pixel of row 0 stopped at the third slot", [block(v, r, first=24)],
                      6))
    # a quarter opaque (opacity 1) and wide (sigma 20 px): raw >= 0.99
    # within ~2.8 px of their centres
    v, rad = cands(kb, 6, -8, 136)
    v[::4, 2:6] = (1 / 400, 0.0, 1 / 400, 1.0)
    rad[::4] = 60
    cases.append(case("raw >= 0.99", [block(v, cover(v, rad))], 6))
    v, rad = cands(kb, 6, -8, 136)
    v[::3, 5] = 0.0
    r = cover(v, rad)
    invalid(v, r, 30)
    cases.append(case("opacity 0 and invalid candidates", [block(v, r)], 6))
    # each tile of row 0: 32 faint candidates reaching its 16 rows (two
    # each, rect on that tile) among 128 faint-opacity ones over the row,
    # so that no pixel stops
    for name, q in ((K9_INSIDE_THRESHOLD, 0.9), (K9_ON_THRESHOLD, 1.0)):
        faint = band_edge_records(rng, 8, 1, 2, q, CR=16, C=6)
        tiles = np.repeat(np.arange(8), 32)
        back, rad = cands(kb - len(faint), 6, 0, 128, opac=(0.02, 0.1))
        back[:, 1] = rng.uniform(0, 16, len(back))
        v = np.concatenate([faint, back])
        r = np.concatenate([rect(tiles, tiles + 1, 0, 1), cover(back, rad)])
        r[len(faint):] = np.where(r[len(faint):] != 0, (r[len(faint):] & 0xFFFF) | (1 << 24), 0)
        cases.append(case(name, [block(v, r)], 6))
    for C, nb in ((1, 1), (3, 2), (6, 1), (8, 1)):
        cases.append(case(f"C={C}, {nb} block{'s' * (nb > 1)}",
                          [random_block(C) for _ in range(nb)], C))
    return cases


K8_PADDING = "whole-K tiles, opacity-0 padding"


def k8_edge_cases(dev):
    """K8's edge inputs on `dev`: (name, coeffs [T, K, 8], colors [T, K, C],
    opacs [T, 1, K], C), K = K9_EDGE_K. At C 3 and 6: each K9 edge case
    (`k9_edge_cases`) as `fused._tile_inputs` makes K8's inputs of it (the
    tiles' first K selected candidates, zero rows past each count; a C-1
    case's colour channels past its first are its noise channels), and
    K8_PADDING (seed 23): 64 tiles of counts 0, K and between, every slot
    past a tile's count holding finite random coefficients and opacity 0
    (the stage bench's padding), and among the live slots wide opaque ones
    (raw >= 0.99), faint ones, and slots whose falloff is not concave in dx
    (c3 >= 0: the band bound keeps every band)."""
    rng = np.random.default_rng(23)
    cases = []
    k9 = k9_edge_cases(torch.device("cpu"))
    for C in (3, 6):
        for name, vals, rects, _, _ in k9:
            co, col, op, *_ = fused._tile_inputs(vals, rects, K9_EDGE_K, C)
            cases.append((f"{name} at C={C}", co, col, op, C))
        T, K = 64, K9_EDGE_K
        xy = rng.uniform(-24, 40, (T, K, 2))
        s = rng.uniform(1.5, 10.0, (T, K, 2))
        th = rng.uniform(0, np.pi, (T, K))
        c, sn = np.cos(th), np.sin(th)
        a, b = 1 / s[..., 0] ** 2, 1 / s[..., 1] ** 2
        conic = np.stack([c * c * a + sn * sn * b, c * sn * (a - b), sn * sn * a + c * c * b], -1)
        op = rng.uniform(0.05, 0.95, (T, K))
        wide = rng.uniform(size=(T, K)) < 0.05
        conic[wide], op[wide] = (1 / 400, 0.0, 1 / 400), 1.0
        op[rng.uniform(size=(T, K)) < 0.1] = rng.uniform(0.004, 0.01)  # faint
        co = blend.falloff_coeffs(torch.from_numpy(xy).float(), torch.from_numpy(conic).float())
        flat = rng.uniform(size=(T, K)) < 0.03  # not concave in dx
        co[..., 3][torch.from_numpy(flat)] = 0.01
        co[..., 0][torch.from_numpy(flat)] = -3.0
        counts = rng.integers(0, K + 1, T)
        counts[:8] = (0, K, K, 1, 127, 128, 129, K - 1)
        dead = np.arange(K)[None] >= counts[:, None]
        junk = torch.from_numpy(rng.normal(scale=3.0, size=(T, K, 6))).float()
        co[..., :6] = torch.where(torch.from_numpy(dead)[..., None], junk, co[..., :6])
        op[dead] = 0.0
        col = rng.uniform(0, 1, (T, K, C))
        cases.append((f"{K8_PADDING} at C={C}", co,
                      torch.from_numpy(col).float(), torch.from_numpy(op).float()[:, None, :], C))
    return [(n, *(t.contiguous().to(dev) for t in ts), C) for n, *ts, C in cases]


def check_kernel_edges(dev, line):
    """K1 and K4 on their edge inputs: bit-equal to their plain versions
    and, on the card, to their baseline designs. Returns the cases held."""
    n1 = 0
    for name, stream, starts, kk, counts, fill in k1_edge_cases(dev):
        out = extract.extract_slices(stream, starts, kk, counts, fill)
        ref = extract.extract_slices_plain(stream, starts, kk, counts, fill)
        check(torch.equal(bits(out), bits(ref)), f"K1 edge case {name}: differs from plain")
        if dev.type == "cuda":
            base = extract.extract_slices_baseline(stream, starts, kk)
            if counts is not None:
                live = torch.arange(kk, device=dev)[None] < torch.clamp(counts, max=kk)[:, None]
                base = torch.where(live, base, fill)
            check(torch.equal(bits(out), bits(base)), f"K1 edge case {name}: differs from baseline")
        n1 += 1
    n4 = 0
    for name, ids, g, n, perm, dup2 in k4_edge_cases(dev):
        for p in ([None] if perm is None else [perm, perm.to(torch.int32)]):
            for rows in (n, n + 1):
                out = segsum.combine_sorted(ids, g, n, perm=p, rows=rows)
                ref = segsum.combine_sorted_plain(ids, g, n, dup2, p, rows=rows)
                check(out.shape == (rows, g.shape[0]) and torch.equal(out, ref),
                      f"K4 edge case {name} (perm {p is not None and p.dtype}, rows {rows}): "
                      "differs from plain")
                n4 += 1
            if dev.type == "cuda" and n > 0:
                base = segsum.combine_sorted_baseline(
                    ids, g, n, None if p is None else p.to(torch.int32))
                check(torch.equal(out[:n], base), f"K4 edge case {name}: differs from baseline")
    sync(dev)
    line(f"K1 and K4 edge inputs: K1 {n1} cases, K4 {n4} cases bit-equal to plain"
         + (" and to the baseline designs" if dev.type == "cuda" else ""))
    return n1, n4


def check_k3_edges(dev, line):
    """K3 on its edge inputs (`k3_edge_cases`): finite, zero in the slots
    past min(max(counts, 0), K), within K3's tolerances of its plain
    version and, on the card, of its baseline design (but K3_ON_THRESHOLD,
    whose alpha tests decide by rounding), bit-equal across two launches
    and to K3 with its band cull off. Returns the cases held."""
    n = 0
    for name, rec, idx, counts, g, ntx, nty, C in k3_edge_cases(dev):
        args = (rec, idx, counts, g, ntx, nty, C)
        out = blend_ct.blend_gather_ct_bwd(*args)
        live = (torch.arange(idx.shape[1], device=dev)[None]
                < torch.clamp(counts, 0, idx.shape[1])[:, None])
        check(bool(torch.isfinite(out).all()), f"K3 edge case {name}: non-finite cotangents")
        check(bool((out[~live] == 0).all()), f"K3 edge case {name}: a dead slot has a cotangent")
        if name != K3_ON_THRESHOLD:
            ref = blend_ct.blend_gather_ct_bwd_plain(*args)
            check(slot_ok(slot_err(out, ref)), f"K3 edge case {name}: differs from plain")
        if dev.type == "cuda":
            check(torch.equal(bits(out), bits(blend_ct.blend_gather_ct_bwd(*args))),
                  f"K3 edge case {name}: two launches differ")
            no_cull = blend_ct.blend_gather_ct_bwd_stage(*args, 4, design="kernel_no_cull")
            check(torch.equal(bits(out), bits(no_cull)),
                  f"K3 edge case {name}: the band cull changes the bits")
            if name != K3_ON_THRESHOLD:
                base = blend_ct.blend_gather_ct_bwd_baseline(*args)
                check(slot_ok(slot_err(out, base)),
                      f"K3 edge case {name}: differs from the baseline")
        n += 1
    sync(dev)
    line(f"K3 edge inputs: {n} cases within p999 <= {K3_P999_REL} x max|drec| / rel_l2 <= "
         f"{K3_REL_L2} of plain (but {K3_ON_THRESHOLD!r})"
         + (", of the baseline design, and bit-equal across two launches and to the walk "
            "without the band cull" if dev.type == "cuda" else ""))
    return n


def rec_bwd_calls(rec, idx, counts, g, ntx, nty, C, slices):
    """K7's backward and K5's on each (offset, tiles) of `slices`, on K3's
    inputs with K3's planar cotangent g [C+1, H, W] carried into their
    layouts (K7's image [H, W, C+1], K5's tile-major [T, 256, C+1]):
    {label: (the rows of K3's drec those tiles are, {"kernel", "plain",
    "baseline": a call})}."""
    img = g.permute(1, 2, 0).contiguous()
    g_tiles = blend_rec._tiles_from_image(img, ntx, nty)
    a7 = (rec, idx, counts, img, ntx, nty, C)
    calls = {"K7": (slice(0, idx.shape[0]), {
        "kernel": lambda: blend_rec.blend_gather_img_bwd(*a7),
        "plain": lambda: blend_rec.blend_gather_img_bwd_plain(*a7),
        "baseline": lambda: blend_rec.blend_gather_img_bwd_baseline(*a7)})}
    for off, n in slices:
        a5 = (rec, idx[off : off + n].contiguous(), counts[off : off + n].contiguous(), off,
              g_tiles[off : off + n].contiguous(), ntx, C)
        calls[f"K5 at offset {off}, {n} tiles"] = (slice(off, off + n), {
            "kernel": lambda a5=a5: blend_rec.blend_gather_rec_bwd(*a5),
            "plain": lambda a5=a5: blend_rec.blend_gather_rec_bwd_plain(*a5),
            "baseline": lambda a5=a5: blend_rec.blend_gather_rec_bwd_baseline(*a5)})
    return calls


def check_rec_bwd_edges(dev, line):
    """K7's and K5's backwards on K3's edge inputs (`k3_edge_cases`), given
    K3's cotangent in their layouts, K5 on the whole grid and on each tile
    of it alone: finite; on the card each drec equals K3's rows of the
    same tiles bit for bit on every case, and but on K3_ON_THRESHOLD
    (whose alpha tests decide by rounding) is within K3's tolerances of
    its plain version and of its baseline design. Off the card (the plain
    versions) each is held within K3's tolerances of K3's plain rows, but
    on K3_ON_THRESHOLD. Returns the (case, call) pairs held."""
    n = 0
    for name, rec, idx, counts, g, ntx, nty, C in k3_edge_cases(dev):
        T = idx.shape[0]
        k3 = blend_ct.blend_gather_ct_bwd(rec, idx, counts, g, ntx, nty, C)
        slices = [(0, T)] + ([(t, 1) for t in range(T)] if T > 1 else [])
        for label, (rows, fns) in rec_bwd_calls(rec, idx, counts, g, ntx, nty, C,
                                                slices).items():
            out = fns["kernel"]()
            where = f"{label} backward, edge case {name}"
            check(bool(torch.isfinite(out).all()), f"{where}: non-finite cotangents")
            if dev.type == "cuda":
                check(torch.equal(bits(out), bits(k3[rows])), f"{where}: differs from K3's bits")
                if name != K3_ON_THRESHOLD:
                    check(slot_ok(slot_err(out, fns["plain"]())), f"{where}: differs from plain")
                    check(slot_ok(slot_err(out, fns["baseline"]())),
                          f"{where}: differs from the baseline")
            elif name != K3_ON_THRESHOLD:
                check(slot_ok(slot_err(out, k3[rows])), f"{where}: differs from K3's rows")
            n += 1
    sync(dev)
    line(f"K7 and K5 backward edge inputs: {n} (case, call) pairs (K5 on the whole grid and "
         "each tile alone) " + (
             f"bit-equal to K3's drec on every case, and within p999 <= {K3_P999_REL} x "
             f"max|drec| / rel_l2 <= {K3_REL_L2} of plain and of the baseline designs (but "
             f"{K3_ON_THRESHOLD!r})" if dev.type == "cuda" else
             f"within p999 <= {K3_P999_REL} x max|drec| / rel_l2 <= {K3_REL_L2} of K3's plain "
             f"rows (but {K3_ON_THRESHOLD!r})"))
    return n


def rec_fwd_calls(rec, idx, counts, ntx, nty, C, slices):
    """K7's forward and K5's on each (offset, tiles) of `slices`, on K2's
    inputs, each call's values tile-major ([T, 256, C+1]; K7's image
    carried over): {label: (the tiles of the grid it blends, {"kernel",
    "plain", "baseline": a call})}."""
    def tiled(fn):
        return lambda: blend_rec._tiles_from_image(fn(), ntx, nty)

    a7 = (rec, idx, counts, ntx, nty, C)
    calls = {"K7": (slice(0, idx.shape[0]), {
        "kernel": tiled(lambda: blend_rec.blend_gather_img(*a7)),
        "plain": tiled(lambda: blend_rec.blend_gather_img_plain(*a7)),
        "baseline": tiled(lambda: blend_rec.blend_gather_img_baseline(*a7))})}
    for off, n in slices:
        a5 = (rec, idx[off : off + n].contiguous(), counts[off : off + n].contiguous(), off, ntx,
              C)
        calls[f"K5 at offset {off}, {n} tiles"] = (slice(off, off + n), {
            "kernel": lambda a5=a5: blend_rec.blend_gather_rec(*a5),
            "plain": lambda a5=a5: blend_rec.blend_gather_rec_plain(*a5),
            "baseline": lambda a5=a5: blend_rec.blend_gather_rec_baseline(*a5)})
    return calls


def k2_tiles(rec, idx, counts, ntx, nty, C):
    """K2's planar image of the grid, tile-major [T, 256, C+1]."""
    img = blend_ct.blend_gather_ct(rec, idx, counts, ntx, nty, C)
    return blend_rec._tiles_from_image(img.permute(1, 2, 0), ntx, nty)


def check_rec_fwd_edges(dev, line):
    """K7's and K5's forwards on K2's edge inputs (`k3_edge_cases`), K5 on
    the whole grid and on each tile of it alone: finite; on the card
    bit-equal to K2's image of the same tiles and to their baseline
    designs on every case and, but on K3_ON_THRESHOLD (whose alpha tests
    decide by rounding), within the image tolerances of their plain
    versions. Off the card (the plain versions) each whole-grid call is
    K2's plain image to the bit, and each tile alone within the image
    tolerances of K2's rows (the plain einsum over one tile rounds apart
    from a batch of tiles: up to 3e-7 at C 1). Returns the (case, call)
    pairs held."""
    n = 0
    for name, rec, idx, counts, _, ntx, nty, C in k3_edge_cases(dev):
        T = idx.shape[0]
        k2 = k2_tiles(rec, idx, counts, ntx, nty, C)
        slices = [(0, T)] + ([(t, 1) for t in range(T)] if T > 1 else [])
        for label, (rows, fns) in rec_fwd_calls(rec, idx, counts, ntx, nty, C, slices).items():
            out = fns["kernel"]()
            where = f"{label} forward, edge case {name}"
            check(bool(torch.isfinite(out).all()), f"{where}: non-finite values")
            if dev.type == "cuda" or rows == slice(0, T):
                check(torch.equal(bits(out), bits(k2[rows])), f"{where}: differs from K2's bits")
            else:
                e = image_err(out, k2[rows])
                check(image_ok(e), f"{where}: differs from K2's rows ({e})")
            if dev.type == "cuda":
                check(torch.equal(bits(out), bits(fns["baseline"]())),
                      f"{where}: differs from the baseline design")
                if name != K3_ON_THRESHOLD:
                    e = image_err(out, fns["plain"]())
                    check(image_ok(e), f"{where}: differs from plain ({e})")
            n += 1
    sync(dev)
    line(f"K7 and K5 forward edge inputs: {n} (case, call) pairs (K5 on the whole grid and each "
         "tile alone) " + (
             "bit-equal to K2's image of the same tiles and to the baseline designs on every "
             f"case, and within p999 <= {P999_MAX} / flips <= {FLIP_MAX} of plain (but "
             f"{K3_ON_THRESHOLD!r})" if dev.type == "cuda" else
             "bit-equal to K2's plain image on the whole grid, each tile alone within p999 <= "
             f"{P999_MAX} / flips <= {FLIP_MAX} of K2's plain rows"))
    return n


def check_k9_edges(dev, line):
    """K9's backward on its edge inputs (`k9_edge_cases`), through both
    input layouts (the forward and its autograd backward): finite, zero in
    the padding channels and for the candidates no tile selects, and but
    on K9_ON_THRESHOLD (whose alpha tests decide by rounding) within K3's
    tolerances of the plain version and, on the card, of the baseline
    design; on the card bit-equal across two launches and to the kernel
    with its band cull off. Returns the cases held."""
    n = 0
    for name, vals, rects, g, C in k9_edge_cases(dev):
        NB, kb = rects.shape
        ref = fused.select_blend_bwd_plain(vals, rects, g, K9_EDGE_K, C)
        lanes, _ = fused._select(rects, K9_EDGE_K)
        picked = torch.zeros(NB, kb + 1, dtype=torch.bool, device=dev).scatter_(
            1, lanes.reshape(NB, -1), True)[:, :kb]
        outs = []
        for variant in (1, 2):
            if variant == 1:
                v = vals.reshape(NB, kb // fused.CHUNK, fused.CHUNK, fused.NCH).permute(0, 1, 3, 2)
                r = rects.reshape(NB, kb // fused.CHUNK, fused.CHUNK)
                fn = fused.fused_select_blend
            else:
                v, r, fn = vals.permute(0, 2, 1), rects[:, None, :], fused.fused_select_blend2
            v = v.contiguous().requires_grad_(True)
            with torch.enable_grad():
                tiles_v, _ = fn(v, r.contiguous(), K9_EDGE_K, C)
                tiles_v.backward(g)
            out = fused._records(v.grad)
            where = f"K9 edge case {name} (v{variant} layout)"
            check(bool(torch.isfinite(out).all()), f"{where}: non-finite d(vals)")
            check(bool((out[..., 6 + C :] == 0).all()) and bool((out[~picked] == 0).all()),
                  f"{where}: a cotangent in the padding or for an unselected candidate")
            if name != K9_ON_THRESHOLD:
                check(slot_ok(slot_err(out, ref)), f"{where}: differs from plain")
            elif variant == 1:
                on_threshold = {"plain": slot_err(out, ref)["rel_l2"]}
            outs.append(out)
        check(torch.equal(bits(outs[0]), bits(outs[1])), f"K9 edge case {name}: layouts differ")
        if dev.type == "cuda":
            args = (vals, rects, g, K9_EDGE_K, C)
            out = fused.select_blend_bwd(*args)
            check(torch.equal(bits(out), bits(outs[0])) and torch.equal(
                bits(out), bits(fused.select_blend_bwd(*args))),
                f"K9 edge case {name}: launches differ")
            check(torch.equal(bits(out), bits(fused.select_blend_bwd_stage(
                *args, 4, design="kernel_no_cull"))),
                f"K9 edge case {name}: the band cull changes the bits")
            base = slot_err(out, fused.select_blend_bwd_baseline(*args))
            if name != K9_ON_THRESHOLD:
                check(slot_ok(base), f"K9 edge case {name}: differs from the baseline")
            else:
                on_threshold["baseline"] = base["rel_l2"]
        n += 1
    sync(dev)
    line(f"K9 backward edge inputs: {n} cases in both layouts within p999 <= {K3_P999_REL} x "
         f"max|dvals| / rel_l2 <= {K3_REL_L2} of plain (but {K9_ON_THRESHOLD!r}, where the "
         f"alpha tests decide by rounding: rel_l2 {on_threshold})"
         + (", of the baseline design, and bit-equal across layouts and launches and to the "
            "kernel without the band cull" if dev.type == "cuda" else ""))
    return n


def route_edge_cases(dev):
    """K9's route's edge inputs, made from seed 19 on `dev`: (name, rects
    [NB, kb] int32, drec [NB * 64, K, 6 + C] float32, sel [NB * 64, K] and
    live [NB * 64] int32, K, C), sel and live the selection of the rects
    (`fused._select`, live = min(count, K)); the rows and ids past each
    tile's live count hold NaN and -7, which the route must not read.
    Lanes of 1-tile and 64-tile rects, of rects past the block's edge
    (clamped to it) and of rect 0; tiles whose count is 0, K and over K,
    so that some lanes no tile selects; kb 1001, not a multiple of any
    group size; C 3, whose rows are not 16-byte aligned; K above kb."""
    rng = np.random.default_rng(19)

    def rect(x0, x1, y0, y1):
        return (np.asarray(x0, np.int64) | (np.asarray(x1, np.int64) << 8)
                | (np.asarray(y0, np.int64) << 16) | (np.asarray(y1, np.int64) << 24))

    def small(n, lo=0, hi=8, edge=8, big=3):
        """n rects of 1 to big x big tiles, corners in [lo, hi), the far
        edges up to `edge` (past 8: clamped by the route)."""
        x0, y0 = rng.integers(lo, hi, n), rng.integers(lo, hi, n)
        return rect(x0, np.minimum(x0 + rng.integers(1, big + 1, n), edge), y0,
                    np.minimum(y0 + rng.integers(1, big + 1, n), edge))

    def case(name, rects, K, C):
        NB, kb = rects.shape
        rects = torch.from_numpy(rects.astype(np.int32))
        lanes, counts = fused._select(rects, K)
        Kk = lanes.shape[-1]
        live = torch.clamp(counts, max=K).reshape(-1)
        sel = torch.full((NB * fused.TB, K), -7, dtype=torch.int32)
        sel[:, :Kk] = torch.where(lanes < kb, lanes, -7).reshape(-1, Kk).int()
        drec = torch.from_numpy(rng.normal(size=(NB * fused.TB, K, 6 + C)).astype(np.float32))
        drec[torch.arange(K)[None] >= live[:, None]] = float("nan")
        return (name, *(t.contiguous().to(dev) for t in (rects, drec, sel, live)), K, C)

    cases = []
    # block 0: 10 lanes of the whole block, 40 of tile (0, 0) (count 50 >
    # K: 34 of them no tile selects), 6 of tile (7, 7) (count K), 300
    # small rects off row and column 7, 28 of rect 0; block 1: small rects
    # in rows 0-3 only, so that rows 4-7 have count 0
    K = 16
    b0 = np.concatenate([np.full(10, rect(0, 8, 0, 8)), np.full(40, rect(0, 1, 0, 1)),
                         np.full(6, rect(7, 8, 7, 8)), small(300, hi=7, edge=7),
                         np.zeros(28, np.int64)])
    b1 = np.concatenate([small(300, hi=4, edge=4, big=2), np.zeros(84, np.int64)])
    cases.append(case("1- and 64-tile rects, counts 0, K and > K, lanes no tile selects",
                      np.stack([rng.permutation(b0), rng.permutation(b1)]), K, 6))
    wide = np.concatenate([small(900, edge=12, big=8), np.full(3, rect(0, 8, 0, 8)),
                           np.zeros(98, np.int64)])
    cases.append(case("kb 1001, rects past the block's edge", rng.permutation(wide)[None], 64, 6))
    cases.append(case("C 3 (rows not 16-byte aligned)",
                      rng.permutation(np.concatenate([small(230, big=5),
                                                      np.zeros(26, np.int64)]))[None], 32, 3))
    cases.append(case("K above kb", small(100, big=8)[None], 128, 6))
    return cases


def route_holds(where, rects, drec, sel, live, K, C):
    """The route on kernel 1's scratch (or `route_edge_cases`' stand-in):
    the plain version (`fused.route_plain` on CPU copies, which sums in
    index order) finite and zero past the used channels; on the card the
    design before bit-equal to it, and every design (at C = STAGE_C the
    group sizes too) bit-equal to the design before and across two
    launches. Returns the plain d(vals) on the CPU."""
    kb = rects.shape[1]
    ref = fused.route_plain(drec.cpu().reshape(-1, fused.TB, K, 6 + C),
                            fused.scratch_lanes(sel.cpu(), live.cpu(), kb), kb)
    check(bool(torch.isfinite(ref).all()) and bool((ref[..., 6 + C:] == 0).all()),
          f"{where}: the plain route is not finite or not zero past the used channels")
    if drec.device.type != "cuda":
        return ref
    args = (rects, drec, sel, live, K, C)
    base = fused.route(*args, design="baseline")
    check(torch.equal(bits(base.cpu()), bits(ref)),
          f"{where}: the route's design before differs from the plain route")
    for d in fused.ROUTE_DESIGNS:
        if d.startswith("kernel_g") and C != fused.STAGE_C:
            continue
        out = fused.route(*args, design=d)
        check(torch.equal(bits(out), bits(base)), f"{where}: route {d} differs from its "
                                                  "design before")
        check(torch.equal(bits(out), bits(fused.route(*args, design=d))),
              f"{where}: two launches of route {d} differ")
    return ref


def check_route_edges(dev, line):
    """K9's route (`route_holds`) on `route_edge_cases` and, on the card,
    on every `k9_edge_cases` case from kernel 1's scratch
    (`fused.select_blend_bwd_tiles`), where the backward's d(vals) must
    be the route's. Returns the cases held."""
    n = 0
    for name, *args in route_edge_cases(dev):
        route_holds(f"route edge case {name}", *args)
        n += 1
    if dev.type == "cuda":
        for name, vals, rects, g, C in k9_edge_cases(dev):
            scratch = fused.select_blend_bwd_tiles(vals, rects, g, K9_EDGE_K, C)
            where = f"route on K9 edge case {name}"
            route_holds(where, rects, *scratch, K9_EDGE_K, C)
            check(torch.equal(bits(fused.select_blend_bwd(vals, rects, g, K9_EDGE_K, C)),
                              bits(fused.route(rects, *scratch, K9_EDGE_K, C))),
                  f"{where}: the backward's d(vals) is not the route's")
            n += 1
    sync(dev)
    line(f"K9 route edge inputs: {n} cases" + (
        " (the route's own and K9's), the design before bit-equal to the plain route, every "
        f"design ({', '.join(fused.ROUTE_DESIGNS)}) bit-equal to it and across launches, the "
        "backward's d(vals) the route's" if dev.type == "cuda" else ", the plain route"))
    return n


def rect_areas(rects):
    """Each lane's rect area in tiles, clamped to the block as the route
    clamps it: int64 [NB, kb]."""
    r = rects.long()
    w = (torch.clamp((r >> 8) & 0xFF, max=fused.BLOCK) - (r & 0xFF)).clamp(min=0)
    h = (torch.clamp((r >> 24) & 0xFF, max=fused.BLOCK) - ((r >> 16) & 0xFF)).clamp(min=0)
    return w * h


def route_work(rects, live, C):
    """What the route moves and where its time could go: the rect-area
    histogram of the lanes, the tiles the lanes visit, the warps' largest
    rects (the design before's warp is 32 lanes; a group's G threads take
    G tiles a round), Σ live, and the bytes each input read once and
    d(vals) written once (the live slots' rows and ids, the live counts,
    the rects, d(vals))."""
    NB, kb = rects.shape
    area = rect_areas(rects)
    edges = (0, 1, 2, 4, 8, 16, 32, 64)
    hist = {f"{lo + 1}-{hi}" if hi > lo + 1 else str(hi): int(((area > lo) & (area <= hi)).sum())
            for lo, hi in zip(edges[:-1], edges[1:])}
    hist = {"0": int((area == 0).sum()), **hist}
    def warps(lanes):  # [NB, warps, lanes a warp]
        return torch.nn.functional.pad(area, (0, (-kb) % lanes)).reshape(NB, -1, lanes)

    groups = {G: int((-(-warps(32 // G) // G)).amax(-1).sum()) for G in (2, 4, 8, 16, 32)}
    n_live = int(live.long().sum())
    nbytes = (4 * (n_live * (6 + C) + n_live + live.numel() + rects.numel())
              + 4 * NB * kb * fused.NCH)
    return {"area_hist": hist, "tiles_visited": int(area.sum()), "lanes": NB * kb,
            "lanes_with_a_rect": int((area > 0).sum()),
            "v1_warp_max_tiles": int(warps(32).amax(-1).sum()), "rounds_by_group": groups,
            "live_slots": n_live,
            "bytes": nbytes}


def k9_fwd_designs(vals, rects, K, C):
    """K9's forward in its other whole designs (the unculled build; at
    fused.STAGE_C the batch sizes) and its baseline design, by name: each
    should give the kernel's tiles and counts to the bit."""
    whole = len(fused.FWD_STAGES) - 1
    names = ["kernel_no_cull"] + (["kernel_r1", "kernel_r2", "kernel_r4"]
                                  if C == fused.STAGE_C else [])
    out = {d: fused.select_blend_stage(vals, rects, K, C, whole, design=d) for d in names}
    out["baseline"] = fused.select_blend_baseline(vals, rects, K, C)
    return out


def check_k9_fwd_edges(dev, line):
    """K9's forward on its edge inputs (`k9_edge_cases`), through both
    input layouts: finite, counts equal to plain's, bit-equal across the
    layouts, within the image tolerances of plain (but K9_ON_THRESHOLD,
    whose alpha tests decide by rounding) and, on the card, bit-equal to a
    second launch, to its baseline design (the design before), to its own
    build with the band cull off and, at fused.STAGE_C, to its walk at 1,
    2 and 4 slots a batch. Returns the cases held."""
    n = 0
    for name, vals, rects, _, C in k9_edge_cases(dev):
        NB, kb = rects.shape
        ref, ref_counts = fused.select_blend_plain(vals, rects, K9_EDGE_K, C)
        outs = []
        for variant in (1, 2):
            if variant == 1:
                v = vals.reshape(NB, kb // fused.CHUNK, fused.CHUNK, fused.NCH).permute(0, 1, 3, 2)
                r = rects.reshape(NB, kb // fused.CHUNK, fused.CHUNK)
                fn = fused.fused_select_blend
            else:
                v, r, fn = vals.permute(0, 2, 1), rects[:, None, :], fused.fused_select_blend2
            out, counts = fn(v.contiguous(), r.contiguous(), K9_EDGE_K, C)
            where = f"K9 forward edge case {name} (v{variant} layout)"
            check(bool(torch.isfinite(out).all()), f"{where}: non-finite tiles")
            check(torch.equal(counts, ref_counts), f"{where}: counts differ from plain")
            if name != K9_ON_THRESHOLD:
                e = image_err(out, ref)
                check(image_ok(e), f"{where}: differs from plain ({e})")
            outs.append(out)
        check(torch.equal(bits(outs[0]), bits(outs[1])), f"K9 forward edge case {name}: layouts "
                                                         "differ")
        if dev.type == "cuda":
            out, counts = fused.select_blend(vals, rects, K9_EDGE_K, C)
            check(torch.equal(bits(out), bits(outs[0])), f"K9 forward edge case {name}: launches "
                                                         "differ")
            for d, (o, c) in k9_fwd_designs(vals, rects, K9_EDGE_K, C).items():
                check(torch.equal(bits(o), bits(out)) and torch.equal(c, counts),
                      f"K9 forward edge case {name}: {d} differs from the kernel")
        n += 1
    sync(dev)
    line(f"K9 forward edge inputs: {n} cases in both layouts, counts equal to plain, within p999 "
         f"<= {P999_MAX} / flips <= {FLIP_MAX} of plain (but {K9_ON_THRESHOLD!r})"
         + (", bit-equal across layouts and launches, to the baseline design and to the kernel "
            f"without the band cull, at C={fused.STAGE_C} to R = 1, 2, 4"
            if dev.type == "cuda" else ", bit-equal across layouts"))
    return n


def k8_fwd_designs(co, col, op):
    """K8's forward in its other whole designs and its baseline design, by
    name (as `k9_fwd_designs`)."""
    whole = len(blend.FWD_STAGES) - 1
    names = ["kernel_no_cull"] + (["kernel_r1", "kernel_r2", "kernel_r4"]
                                  if col.shape[-1] == blend.STAGE_C else [])
    out = {d: blend.blend_tiles_coeffs_stage(co, col, op, whole, design=d) for d in names}
    out["baseline"] = blend.blend_tiles_coeffs_baseline(co, col, op)
    return out


def check_k8_edges(dev, line):
    """K8's forward on its edge inputs (`k8_edge_cases`): finite, within
    the image tolerances of plain (but K9_ON_THRESHOLD's tiles) and, on
    the card, bit-equal to a second launch, to its baseline design, to its
    own build with the band cull off and, at blend.STAGE_C, to its walk at
    1, 2 and 4 slots a batch. Returns the cases held."""
    n = 0
    for name, co, col, op, C in k8_edge_cases(dev):
        out = blend.blend_tiles_coeffs(co, col, op)
        where = f"K8 forward edge case {name}"
        check(bool(torch.isfinite(out).all()), f"{where}: non-finite values")
        if not name.startswith(K9_ON_THRESHOLD):
            e = image_err(out, blend.blend_tiles_coeffs_plain(co, col, op))
            check(image_ok(e), f"{where}: differs from plain ({e})")
        if dev.type == "cuda":
            check(torch.equal(bits(out), bits(blend.blend_tiles_coeffs(co, col, op))),
                  f"{where}: two launches differ")
            for d, o in k8_fwd_designs(co, col, op).items():
                check(torch.equal(bits(o), bits(out)), f"{where}: {d} differs from the kernel")
        n += 1
    sync(dev)
    line(f"K8 forward edge inputs: {n} cases within p999 <= {P999_MAX} / flips <= {FLIP_MAX} of "
         f"plain (but the tiles of {K9_ON_THRESHOLD!r})"
         + (", bit-equal across two launches, to the baseline design and to the kernel without "
            f"the band cull, at C={blend.STAGE_C} to R = 1, 2, 4" if dev.type == "cuda" else ""))
    return n


K8_BWD_OUTPUTS = ("coeffs", "colors", "opacs")


def k8_cotangent(co, C, seed):
    """A cotangent [T, 256, C+1] of K8's forward for coeffs co, from `seed`."""
    g = np.random.default_rng(seed).normal(size=(co.shape[0], 256, C + 1)).astype(np.float32)
    return torch.from_numpy(g).to(co.device)


def k8_bwd_holds(where, args, dev, plain=True):
    """K8's backward on args = (coeffs, colors, opacs, g): finite; zero in
    dcoeffs[..., 6:] and in all three outputs for every opacity-0 slot;
    with `plain`, within K3's tolerances of the plain version where that
    is not NaN (its dense sums take dalpha exp(power) = 0 x inf at the
    pixels where exp(power) overflows and the slot is not taken, as the
    JAX kernel's do: those values are left out on both sides); on the card
    within K3_REL_L2 of its `_v1` (the same power, so the same pairs: only
    the sums' order differs) and bit-equal across two launches and to the
    kernel with its band cull off. Off the card the backward is the plain
    version, its NaNs zeroed. Returns {"plain": {output: slot_err},
    "baseline": {output: rel L2}} (what was held)."""
    out = blend.blend_tiles_coeffs_bwd(*args)
    dead = args[2][:, 0, :] == 0
    if dev.type != "cuda":
        out = tuple(torch.nan_to_num(o, nan=0.0) for o in out)
    check(all(bool(torch.isfinite(o).all()) for o in out), f"{where}: non-finite cotangents")
    dco, dcol, dop = out
    check(bool((dco[..., 6:] == 0).all()), f"{where}: a cotangent in the padding columns")
    check(bool((dco[dead] == 0).all()) and bool((dcol[dead] == 0).all())
          and bool((dop[:, 0, :][dead] == 0).all()), f"{where}: an opacity-0 slot has a cotangent")
    res = {}
    if plain:
        ref = blend.blend_tiles_coeffs_bwd_plain(*args)
        res["plain"] = {n: slot_err(torch.where(r.isnan(), 0.0, a), torch.nan_to_num(r, nan=0.0))
                        for n, a, r in zip(K8_BWD_OUTPUTS, out, ref)}
        for n, e in res["plain"].items():
            check(slot_ok(e), f"{where}: d{n} differs from plain ({e})")
    if dev.type == "cuda":
        again = blend.blend_tiles_coeffs_bwd(*args)
        check(all(torch.equal(bits(a), bits(b)) for a, b in zip(out, again)),
              f"{where}: two launches differ")
        no_cull = blend.blend_tiles_coeffs_bwd_stage(*args, len(blend.BWD_STAGES) - 1,
                                                     design="kernel_no_cull")
        check(all(torch.equal(bits(a), bits(b)) for a, b in zip(out, no_cull)),
              f"{where}: the band cull changes the bits")
        base = blend.blend_tiles_coeffs_bwd_baseline(*args)
        res["baseline"] = {n: rel_l2(a, b) for n, a, b in zip(K8_BWD_OUTPUTS, out, base)}
        check(all(e <= K3_REL_L2 for e in res["baseline"].values()),
              f"{where}: differs from the baseline design ({res['baseline']})")
    return res


def check_k8_bwd_edges(dev, line):
    """K8's backward on its edge inputs (`k8_edge_cases`), a cotangent from
    a seed each: `k8_bwd_holds`, the plain version held on every case but
    K9_ON_THRESHOLD's tiles (whose alpha tests decide by rounding), the
    `_v1` on every case; prints the largest rel L2 against the `_v1`.
    Returns the cases held."""
    n, worst = 0, (-1.0, None, None)
    for name, co, col, op, C in k8_edge_cases(dev):
        res = k8_bwd_holds(f"K8 backward edge case {name}",
                           (co, col, op, k8_cotangent(co, C, 40 + n)), dev,
                           plain=not name.startswith(K9_ON_THRESHOLD))
        for out, e in res.get("baseline", {}).items():
            worst = max(worst, (e, name, out), key=lambda w: w[0])
        n += 1
    sync(dev)
    line(f"K8 backward edge inputs: {n} cases finite, zero in the padding columns and for every "
         f"opacity-0 slot, within p999 <= {K3_P999_REL} x max|d| / rel_l2 <= {K3_REL_L2} of plain "
         f"(but the tiles of {K9_ON_THRESHOLD!r})"
         + (f", within rel_l2 <= {K3_REL_L2} of the baseline design on every case (largest "
            f"{worst[0]:.3e}: d{worst[2]} of {worst[1]!r}), bit-equal across two launches and to "
            "the kernel without the band cull" if dev.type == "cuda" else ""))
    return n


def ptxas_usage(log, marker):
    """Registers, shared memory and spills that `-Xptxas -v` reports for
    the entry functions whose mangled names contain `marker`, by name."""
    out, name = {}, None
    for ln in (log or "").splitlines():
        if "Function properties for" in ln:
            name = ln.split("for", 1)[1].strip()
        elif name and marker in name and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[name] = {"stack": nums[0], "spill_stores": nums[1], "spill_loads": nums[2]}
        elif name and marker in name and "registers" in ln:
            words = ln.replace(",", " ").split()
            out.setdefault(name, {}).update(
                registers=int(words[words.index("registers") - 1]),
                smem=int(words[words.index("smem") - 2]) if "smem" in words else 0)
    return out


def rec_ptxas(report, layout, C, backward):
    """ptxas' usage of K5's (layout "rec") or K7's ("img") forward or
    backward and its baseline design at C, from blend_rec's build log,
    and its summary."""
    logs = report.get("build_logs", {}).get("blend_rec")
    kind = "bwd_" if backward else ""
    usage = {d: ptxas_usage(logs, f"blend_gather_{layout}_{kind}{m}ILi{C}E")
             for d, m in (("kernel", "kernel"), ("baseline", "v1_kernel"))}
    return usage, (f"ptxas at C={C} (registers, static smem bytes, spill stores): " + "; ".join(
        f"{d} {u.get('registers')}, {u.get('smem')}, {u.get('spill_stores')}"
        for d, us in usage.items() for u in us.values()))


def image_err(a, b):
    err = (a.float() - b.float()).abs().flatten()
    k = max(1, int(np.ceil(0.999 * err.numel())))
    return {
        "max_abs": float(err.max()),
        "p999_abs": float(err.kthvalue(k).values),
        "flip_frac": float((err > FLIP_AT).float().mean()),
    }


def image_ok(e):
    return e["p999_abs"] <= P999_MAX and e["flip_frac"] <= FLIP_MAX


def slot_err(a, b):
    """Per-slot cotangents a against the plain b: max and p999 abs error,
    relative L2, and b's largest |value| (the scale the p999 is held to)."""
    err = (a - b).abs().flatten()
    k = max(1, int(np.ceil(0.999 * err.numel())))
    return {"max_abs": float(err.max()), "p999_abs": float(err.kthvalue(k).values),
            "rel_l2": rel_l2(a, b), "scale": float(b.abs().max())}


def slot_ok(e):
    return e["p999_abs"] <= K3_P999_REL * e["scale"] and e["rel_l2"] <= K3_REL_L2


def aux_ints(aux):
    return {f: int(getattr(aux, f)) for f in aux._fields}


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


def render(params, model, camera, lbs, k, plain=False):
    pkg = avatar_forward(params, model, {"camera": camera, "lbs": lbs, "camera_idx": 0})
    colors = torch.cat([pkg["rgb"], pkg["silhouette_rgb"]], -1)
    img, aux = rasterize_tiled(
        pkg["means3D"], camera, torch.tensor(BG6, device=colors.device),
        cov3d=pkg["cov3D_precomp"], opacities=pkg["opacities"], colors=colors,
        max_per_tile=k, use_pallas=True, coarse="dupsort_depth", dup=DUP, plain=plain,
    )
    return pkg, img, aux


def reset_launch_counts():
    """Every kernel's launch counter to 0."""
    extract.launches = blend_ct.launches = blend_ct.bwd_launches = segsum.launches = 0
    extract.baseline_launches = segsum.baseline_launches = blend_ct.baseline_launches = 0
    blend_ct.fwd_baseline_launches = 0
    for counts in (blend_ct.stage_launches, blend_ct.fwd_stage_launches):
        for k in counts:
            counts[k] = 0
    blend_rec.launches = blend_rec.bwd_launches = 0
    blend_rec.img_launches = blend_rec.img_bwd_launches = 0
    blend_rec.fwd_baseline_launches = blend_rec.img_fwd_baseline_launches = 0
    blend_rec.bwd_baseline_launches = blend_rec.img_bwd_baseline_launches = 0
    blend.launches = blend.bwd_launches = fused.launches = fused.bwd_launches = 0
    fused.baseline_launches = fused.fwd_baseline_launches = blend.baseline_launches = 0
    blend.bwd_baseline_launches = 0
    fused.route_launches = fused.tiles_launches = 0
    for counts in (fused.stage_launches, fused.fwd_stage_launches, blend.stage_launches,
                   blend.bwd_stage_launches, fused.route_design_launches):
        for k in counts:
            counts[k] = 0
    probes.reset_launches()


def off_path_launches():
    """Launches, since the counts were reset, of what no path of the port
    calls: the baseline designs of K1, K2, K3, K4, of K5's, K7's, K8's
    and K9's forwards and backwards and of the probes P1's matmul, P2's
    passthrough, roll and P3's cuts, P1's roll designs named other than
    "kernel" and their sync floors, the stage entry points of K2, K3 and K8's
    and K9's forwards and backwards (their cuts, other designs and
    diagnostic builds), and K9's route and per-tile kernel launched alone.
    Each main-path window must see 0."""
    return (extract.baseline_launches + segsum.baseline_launches + blend_ct.baseline_launches
            + blend_ct.fwd_baseline_launches + sum(blend_ct.stage_launches.values())
            + sum(blend_ct.fwd_stage_launches.values()) + blend_rec.fwd_baseline_launches
            + blend_rec.img_fwd_baseline_launches + blend_rec.bwd_baseline_launches
            + blend_rec.img_bwd_baseline_launches + fused.baseline_launches
            + sum(fused.stage_launches.values()) + fused.fwd_baseline_launches
            + sum(fused.fwd_stage_launches.values()) + blend.baseline_launches
            + sum(blend.stage_launches.values()) + blend.bwd_baseline_launches
            + sum(blend.bwd_stage_launches.values()) + sum(mxu.v1_launches.values())
            + sum(mxu.roll_design_launches.values()) + widerow.v1_launches
            + sum(fused_bisect.v1_launches.values())
            + sum(fused.route_design_launches.values()) + fused.tiles_launches)


def blend_bound(work, nbytes, backward=False):
    """(bound ms, "bytes" or "operations", both times in s) of a blend
    walk over `blend_work`'s pairs that moves `nbytes`: used and unused
    pairs counted apart."""
    used, unused = work["used"], work["visited"] - work["used"]
    if backward:
        fp32 = used * BLEND_BWD_FP32_OPS_PER_PAIR + unused * BLEND_BWD_TEST_FP32_OPS_PER_PAIR
        sfu = used * BLEND_BWD_SFU_PER_PAIR + unused * BLEND_BWD_TEST_SFU_PER_PAIR
    else:
        fp32 = used * BLEND_FP32_OPS_PER_PAIR + unused * BLEND_TEST_FP32_OPS_PER_PAIR
        sfu = used * BLEND_SFU_PER_PAIR + unused * BLEND_TEST_SFU_PER_PAIR
    times = {"bytes": nbytes / HBM_BYTES_PER_S,
             "operations": max(fp32 / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by, times


def rel_l2(a, b):
    return float(torch.linalg.vector_norm((a - b).double()) /
                 torch.clamp(torch.linalg.vector_norm(b.double()), min=1e-30))


def run(dev, report):
    """Every phase; raises PhaseFailed (or any error) on a failure.
    Returns the kernels' entries for the `{"kernels": [...]}` line."""
    with torch.no_grad():
        kernels, scene = serve(dev, report)
    kernels = kernels + train(dev, report, scene)
    capture(dev, report, scene)
    kernels = kernels + sharded(dev, report, scene)
    kernels = kernels + variants(dev, report, scene)
    kernels = kernels + fused_phase(dev, report, scene)
    return kernels + probes_phase(dev, report, scene)


def logger(report):
    say = report.setdefault("log", []).append

    def line(msg):
        print(msg, flush=True)
        say(msg)

    return line


def serve(dev, report):
    """Build, K1 and K2 at full width (K2 with `k2_phase`), the small
    cross-device check and the 20-frame serving path. Returns the K1/K2
    entries and the scene."""
    line = logger(report)

    # -- build ---------------------------------------------------------
    t0 = time.perf_counter()
    if dev.type == "cuda":
        logs = cuda_build.build_all()
        report["build_logs"] = logs
    line(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(cuda_build.KERNEL_SOURCES)}")

    # -- full-width scene ----------------------------------------------
    t0 = time.perf_counter()
    model, camera, pose = serving_scene(N_GARMENTS, N_PER_GARMENT, CAGE_RES, WIDTH, HEIGHT, dev)
    params = init_avatar(torch.Generator().manual_seed(0), model)
    n_gauss = sum(g.geometry.init_points.shape[0] for g in model.garments)
    sync(dev)
    line(f"scene: {n_gauss} Gaussians, {WIDTH}x{HEIGHT}, K={K}, dup={DUP} "
         f"({time.perf_counter() - t0:.1f} s to build)")

    # -- K1 and K4 on their edge inputs -----------------------------------
    k1_edges, k4_edges = check_kernel_edges(dev, line)

    pkg = avatar_forward(params, model, {"camera": camera, "lbs": pose(0), "camera_idx": 0})
    colors = torch.cat([pkg["rgb"], pkg["silhouette_rgb"]], -1).contiguous()
    C = colors.shape[-1]
    bin_args = (pkg["means3D"], camera, pkg["cov3D_precomp"], pkg["opacities"], colors, K, DUP)
    # the selection's K1 call, as the main path makes it: the sorted lo_s
    # stream, the tiles' starts and counts, the fill -1
    k1_calls, k1_wrapper = [], tiles.extract_slices
    tiles.extract_slices = lambda *a: k1_calls.append(a) or k1_wrapper(*a)
    try:
        binned = bin_gaussians(*bin_args)
    finally:
        tiles.extract_slices = k1_wrapper
    binned_plain = bin_gaussians(*bin_args, plain=True)
    sync(dev)
    T, ntx, nty = binned.idx.shape[0], binned.ntx, binned.nty
    check(len(k1_calls) == 1, f"K1: the selection made {len(k1_calls)} calls, not 1")
    lo_s, starts, kk, counts, fill = k1_calls[0]
    m = lo_s.numel()
    check(m == DUP * DUP * n_gauss and kk == K and tuple(starts.shape) == (T,) and fill == -1,
          f"K1: the selection's call (m={m}, kk={kk}, T={starts.shape[0]}, fill={fill})")

    # -- K1: extraction, bit-exact ---------------------------------------
    check(torch.equal(binned.idx, binned_plain.idx), "K1: selection idx differs from the plain version")
    check(torch.equal(binned.counts, binned_plain.counts), "K1: selection counts differ")
    check(torch.equal(counts, binned.counts), "K1: the call's counts are not the selection's")
    g = torch.Generator(device=dev).manual_seed(1)
    streams = {
        "lo_s": lo_s,
        "int32": torch.randint(0, 2**30, (m,), generator=g, device=dev, dtype=torch.int32),
        "float32": torch.randn(m, generator=g, device=dev),
    }
    live = torch.arange(kk, device=dev)[None] < torch.clamp(counts, max=kk)[:, None]
    k1_err = 0.0
    for name, stream in streams.items():
        fl = -1 if stream.dtype == torch.int32 else float("inf")
        for cnt in (None, counts):
            out = extract.extract_slices(stream, starts, kk, cnt, fl)
            ref = extract.extract_slices_plain(stream, starts, kk, cnt, fl)
            sync(dev)
            check(torch.equal(bits(out), bits(ref)),
                  f"K1: {name} output (counts {cnt is not None}) not bit-exact with plain")
            if dev.type == "cuda":
                base = extract.extract_slices_baseline(stream, starts, kk)
                if cnt is not None:
                    base = torch.where(live, base, fl)
                check(torch.equal(bits(out), bits(base)),
                      f"K1: {name} output (counts {cnt is not None}) differs from the baseline")
            diff = torch.where(out == ref, 0.0, (out.double() - ref.double()).abs())
            k1_err = max(k1_err, float(diff.max()))
    line(f"K1 extract_slices: bit-exact with plain and the baseline design on the scene's "
         f"selection (lo_s) and on int32/float32 streams, with and without counts/fill "
         f"(m={m}, T={T}, kk={kk})")

    def k1_caller_before():  # the baseline design and the epilogue the caller ran
        seg = extract.extract_slices_baseline(lo_s, starts, kk)
        lv = torch.arange(kk, device=dev)[None] < torch.clamp(counts, max=kk)[:, None]
        return torch.where(lv, seg, -1)

    k1_turns = k1_floor = k1_callers = None
    if dev.type == "cuda":
        k1_turns = in_turns({
            "caller_before": k1_caller_before,
            "baseline": lambda: extract.extract_slices_baseline(lo_s, starts, kk),
            "kernel_no_counts": lambda: extract.extract_slices(lo_s, starts, kk),
            "kernel": lambda: extract.extract_slices(lo_s, starts, kk, counts, -1),
        }, 200, dev)
        k1_floor = in_turns({
            "floor_baseline": lambda: extract.launch_floor(T, kk, dev, baseline=True),
            "floor": lambda: extract.launch_floor(T, kk, dev),
        }, 200, dev)
        k1_callers = {k: profile_calls(f, 3, dev) for k, f in (
            ("before", k1_caller_before),
            ("after", lambda: extract.extract_slices(lo_s, starts, kk, counts, -1)))}
        line(f"K1 in turns (T={T}, kk={kk}, the scene's lo_s): {turns_summary(k1_turns)}")
        line(f"K1 launch floor (an empty kernel on each design's grid): "
             f"{turns_summary(k1_floor)}")
        k1_folded = folded_launches(k1_callers)
        line(f"K1's caller, kernels a call: before and after {k1_folded}")
        check(k1_folded is None or k1_folded[0] - k1_folded[1] == K1_LAUNCHES_FOLDED,
              f"K1's caller: {k1_folded} kernels a call, not {K1_LAUNCHES_FOLDED} fewer")
    k1_t = measure(lambda: extract.extract_slices(lo_s, starts, kk, counts, -1), 200, dev)
    k1_plain_t = measure(lambda: extract.extract_slices_plain(lo_s, starts, kk, counts, -1), 50,
                         dev)
    padded = torch.nn.functional.pad(lo_s, (0, kk))
    index = starts.long()[:, None] + torch.arange(kk, device=dev)
    k1_lib_t = measure(lambda: padded[index], 200, dev)
    # the live words read once, the starts and counts, the output written
    k1_live = int(torch.clamp(counts, 0, kk).sum())
    k1_bytes = 4 * (k1_live + 2 * T + T * kk)
    k1_bound_ms = k1_bytes / HBM_BYTES_PER_S * 1e3

    # -- K2: gather + blend ----------------------------------------------
    cnt = torch.clamp(counts, max=K).contiguous()
    blend_args = (binned.records_ext, binned.idx, cnt, ntx, nty, C)
    out_k = blend_ct.blend_gather_ct(*blend_args)
    out_p, pairs = blend_ct.blend_gather_ct_plain(*blend_args, count_pairs=True)
    sync(dev)
    k2 = image_err(out_k, out_p)
    line(f"K2 blend_gather_ct vs plain at full width: max_abs={k2['max_abs']:.3e} "
         f"p999_abs={k2['p999_abs']:.3e} frac(|err|>{FLIP_AT})={k2['flip_frac']:.3e}")
    check(bool(torch.isfinite(out_k).all()), "K2: non-finite output")
    check(image_ok(k2), f"K2: outside p999 <= {P999_MAX} / flips <= {FLIP_MAX}")
    k2r = k2_phase(dev, report, dict(binned=binned, cnt=cnt, C=C))
    k2_t = measure(lambda: blend_ct.blend_gather_ct(*blend_args), 20, dev)
    k2_plain_t = measure(lambda: blend_ct.blend_gather_ct_plain(*blend_args), 3, dev, warmup=1)
    n_contrib = int(cnt.sum())
    live = torch.arange(K, device=dev)[None] < cnt[:, None]
    uniq = int(torch.unique(binned.idx[live]).numel())
    CR = binned.records_ext.shape[1]
    work = blend_work(binned, cnt)
    k2_bytes = 4 * (uniq * CR + n_contrib + T) + 4 * out_k.numel()
    k2_bound_ms, k2_bound_by, k2_times = blend_bound(work, k2_bytes)
    line(f"K2 work: n_contrib={n_contrib}, unique records={uniq}, bytes={k2_bytes}; tiles "
         f"{work['tiles']}; (pixel, record) pairs visited {work['visited']} (of "
         f"{256 * n_contrib}), used {work['used']}; (record, 2-row band) pairs {work['bands']}, "
         f"with a used pixel {work['bands_used']}; (record, warp) pairs {work['warp_records']}, "
         f"taken by the band cull {work['warp_records_taken']}")
    line(f"K2 bound: bytes {k2_times['bytes'] * 1e3:.5f} ms, operations "
         f"{k2_times['operations'] * 1e3:.5f} ms ({work['used']} used and "
         f"{work['visited'] - work['used']} unused pairs)")

    # -- small input: the card's kernels against the CPU port ------------
    # (the CPU port is held against the JAX package by tests/test_torch_slice.py)
    s = SMALL
    cpu = torch.device("cpu")
    small_args = (s["n_garments"], s["n_gaussians"], 1, s["width"], s["height"])
    s_model_c, s_cam_c, s_pose_c = serving_scene(*small_args, device=cpu)
    s_model_d, s_cam_d, s_pose_d = serving_scene(*small_args, device=dev)
    s_params = init_avatar(torch.Generator().manual_seed(0), s_model_c)
    _, s_img_c, s_aux_c = render(s_params, s_model_c, s_cam_c, s_pose_c(3), s["k"])
    _, s_img_d, s_aux_d = render(tree_to(s_params, dev), s_model_d, s_cam_d, s_pose_d(3), s["k"])
    small = image_err(s_img_d.cpu(), s_img_c)
    line(f"small scene ({s['width']}x{s['height']}, K={s['k']}): card vs CPU port "
         f"p999_abs={small['p999_abs']:.3e} frac={small['flip_frac']:.3e}; "
         f"aux card {aux_ints(s_aux_d)} cpu {aux_ints(s_aux_c)}")
    check(image_ok(small), "small scene: card and CPU port disagree")

    # -- the serving path: 20 frames --------------------------------------
    render(params, model, camera, pose(0), K)  # warm-up
    sync(dev)
    reset_launch_counts()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    t0 = time.perf_counter()
    per_frame = []
    for i in range(FRAMES):
        _, img, aux = render(params, model, camera, pose(i), K)
        finite &= torch.isfinite(img).all()
        per_frame.append((extract.launches, blend_ct.launches))
        if i == 0:
            img0, aux0 = img, aux
    sync(dev)
    frame_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    launches = {"extract_slices": extract.launches, "blend_gather_ct": blend_ct.launches}
    line(f"serving path: {FRAMES} frames, {frame_ms:.3f} ms/frame, {1e3 / frame_ms:.2f} frames/s; "
         f"launches {launches}")
    check(bool(finite), "serving path: non-finite image")
    check(tuple(img0.shape) == (C, HEIGHT, WIDTH), f"serving path: image shape {tuple(img0.shape)}")
    check(per_frame == [(i + 1, i + 1) for i in range(FRAMES)],
          f"launch counts after each frame {per_frame}: not one per kernel per frame")
    check(off_path_launches() == 0,
          "serving path: a baseline design or a K2/K3 stage cut was launched")

    _, img_p, aux_p = render(params, model, camera, pose(0), K, plain=True)
    fr = image_err(img0, img_p)
    a_k, a_p = aux_ints(aux0), aux_ints(aux_p)
    line(f"frame 0, kernels vs plain: p999_abs={fr['p999_abs']:.3e} frac={fr['flip_frac']:.3e} "
         f"max_abs={fr['max_abs']:.3e}; aux {a_k}")
    check(image_ok(fr), "frame 0: kernels and plain versions disagree")
    for f in a_k:
        if f != "visible_overflow":
            check(a_k[f] == a_p[f], f"frame 0: RasterAux.{f} {a_k[f]} != plain {a_p[f]}")

    kernels = [
        {
            "name": "extract_slices", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/extract.cu",
            "replaces": "d3ga_tpu/raster/pallas_extract.py:68",
            "launches": launches["extract_slices"], "max_abs_err": k1_err,
            "ms": k1_turns["kernel"]["ms"] if k1_turns else k1_t["ms"],
            "plain_ms": k1_plain_t["ms"], "bound_ms": k1_bound_ms,
            "bound_by": "bytes", "library_ms": k1_lib_t["ms"],
            "baseline_ms": k1_turns and k1_turns["baseline"]["ms"],
            "floor_ms": k1_floor and k1_floor["floor"]["ms"],
            "baseline_floor_ms": k1_floor and k1_floor["floor_baseline"]["ms"],
        },
        {
            "name": "blend_gather_ct", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/blend_ct.cu",
            "replaces": "d3ga_tpu/raster/pallas_blend_ct.py:312",
            "launches": launches["blend_gather_ct"], "max_abs_err": k2["max_abs"],
            "ms": k2r["k2_turns"]["kernel"]["ms"] if k2r["k2_turns"] else k2_t["ms"],
            "plain_ms": k2_plain_t["ms"], "bound_ms": k2_bound_ms,
            "bound_by": k2_bound_by, "library_ms": None,
            "baseline_ms": k2r["k2_turns"] and k2r["k2_turns"]["baseline"]["ms"],
            "designs_ms": k2r["k2_turns"] and {d: v["ms"] for d, v in k2r["k2_turns"].items()},
            "stages_ms": k2r["k2_stages"] and [k2r["k2_stages"][f"stage{st}"]["ms"]
                                               for st in range(len(blend_ct.FWD_STAGES))],
            "sm_load": k2r["k2_sm_load"],
        },
    ]
    timings = {
        "extract_slices": {"kernel": k1_t, "plain": k1_plain_t, "library": k1_lib_t},
        "blend_gather_ct": {"kernel": k2_t, "plain": k2_plain_t},
    }
    for k in kernels:
        t = timings[k["name"]]
        line(f"{k['name']}: ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
             f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) library_ms={k['library_ms']} "
             f"launches_per_frame={k['launches'] / FRAMES:g}; wall per call "
             + ", ".join(f"{n}={v['call_ms']:.4f}" for n, v in t.items()))
    report.update(
        frame_ms=frame_ms, fps=1e3 / frame_ms, n_gaussians=n_gauss, k2_full_width=k2,
        k2_pairs=pairs, n_contrib=n_contrib, small=small, frame0=fr, aux_frame0=a_k,
        k1_turns=k1_turns, k1_floor=k1_floor, k1_callers=k1_callers, k1_bytes=k1_bytes,
        k1_live=k1_live, edge_cases={"K1": k1_edges, "K4": k4_edges, "K2": k2r["k2_edges"]},
        k2_turns=k2r["k2_turns"], k2_stages=k2r["k2_stages"], k2_ptxas=k2r["k2_ptxas"],
        k2_sm_load=k2r["k2_sm_load"], k2_bytes=k2_bytes, blend_work=work,
        aux_frame0_plain=a_p, kernels=kernels, timings=timings,
    )
    gauss = tuple(t.detach() for t in (
        pkg["means3D"], pkg["cov3D_precomp"], pkg["opacities"], colors))
    scene = dict(model=model, camera=camera, binned=binned, cnt=cnt, C=C, pairs=pairs, uniq=uniq,
                 gauss=gauss, aux_frame0=a_k, work=work)
    return kernels, scene


# the band cull's bound (csrc/blend_walk_bwd.cuh::bw_stage): log(255), the
# margin in r2 past its 1%, the quarter pixel
CULL_LOG255, CULL_R2_SLACK, CULL_PAD = 5.54126354, 1e-3, 0.25


def cull_bands(rec, org):
    """[..., 8] the 2-row bands of a tile that the band cull lets each
    gathered record rec [..., CR] reach, from tile origins org (bw_stage's
    bound in float32; nvcc's contractions may move an edge by a rounding)."""
    y = rec[..., 1] - org[..., 1]
    A, B, Cc = rec[..., 2], rec[..., 3], rec[..., 4]
    r2 = 2.0 * (torch.log(torch.clamp(rec[..., 5], min=blend_ct.OP_EPS)) + CULL_LOG255)
    det = A * Cc - B * B
    ext = torch.sqrt((torch.clamp(r2, min=0.0) * 1.01 + CULL_R2_SLACK) * A / det) + CULL_PAD
    bound = ((A > 0) & (Cc > 0) & (det > 1e-3 * A * Cc) & (ext < 1e30) & (y - ext < 1e30)
             & (y + ext > -1e30))
    b = torch.arange(8, device=rec.device, dtype=rec.dtype)
    reach = (2 * b + 1 >= (y - ext)[..., None]) & (2 * b <= (y + ext)[..., None])
    return torch.where(bound[..., None], reach, True)


K8_REL_SLACK, K8_ABS_SLACK = 1e-5, 1e-3  # blend_coeffs.cu's band bound margins


def coeff_cull_bands(coeffs, opacs):
    """[T, K, 8] the 2-row bands of a tile that K8's band cull lets each
    slot reach, from coeffs [T, K, 8] and opacs [T, 1, K]
    (blend_coeffs.cu::k8_bands in float32: per row dy the largest power
    over real dx, c0 + c2 dy + c4 dy^2 - (c1 + c5 dy)^2 / (4 c3), plus
    log(255 opacity) and the margin, must reach 0 on one of the band's two
    rows; none at opacity <= 0, every band where a value is not finite or
    c3 >= 0; nvcc's contractions may move an edge by a rounding)."""
    c = coeffs[..., :6].unbind(-1)
    op = opacs[:, 0, :]
    lop = torch.log(op) + CULL_LOG255
    inv = 1.0 / (-4.0 * c[3])
    fy = torch.arange(16, dtype=coeffs.dtype, device=coeffs.device)[:, None, None]
    q = c[1] + c[5] * fy
    u = c[1].abs() + c[5].abs() * fy
    top = c[0] + c[2] * fy + c[4] * fy * fy + q * q * inv
    mag = (c[0].abs() + 15.0 * c[1].abs() + c[2].abs() * fy + 225.0 * c[3].abs()
           + c[4].abs() * fy * fy + 15.0 * c[5].abs() * fy + u * u * inv + lop.abs())
    rows = ~(top + lop + K8_REL_SLACK * mag + K8_ABS_SLACK < 0.0)  # [16, T, K]
    bands = rows.reshape(8, 2, *rows.shape[1:]).any(1).permute(1, 2, 0)
    finite = torch.isfinite(coeffs[..., :6]).all(-1) & torch.isfinite(op)
    every = (~finite | ~(c[3] < 0.0))[..., None]
    return torch.where((op <= 0.0)[..., None], False, bands | every)


def blend_work(b, cnt, tile_chunk=128):
    """What the blend walks face at a selection: tiles by live count, the
    (pixel, record) pairs visited (before each pixel's stop) and used
    there (power <= 0 and alpha >= 1/255), the (record, 2-row band) pairs
    of live slots and those with a used pixel (what K3's band cull can
    skip), and the (record, warp of 4 rows) pairs of live slots and those
    the cull lets K2's warps take (`cull_bands`)."""
    T, K = b.idx.shape
    dev = b.idx.device
    origin = blend_ct._tile_origins(T, b.ntx, dev)
    basis = blend_ct._pixel_basis(dev)
    slot = torch.arange(K, device=dev)
    w = dict(visited=0, used=0, bands=0, bands_used=0, warp_records=0, warp_records_taken=0)
    for c0 in range(0, T, tile_chunk):
        rec = b.records_ext[b.idx[c0 : c0 + tile_chunk].long()]
        org = origin[c0 : c0 + tile_chunk]
        live = slot[None] < cnt[c0 : c0 + tile_chunk, None]
        f = blend_ct._blend_chunk(rec, org, live, basis)
        visited = live[:, None, :] & (f["t_before"] >= blend_ct.T_EPS)
        used = f["use"] & visited
        w["visited"] += int(visited.sum())
        w["used"] += int(used.sum())
        w["bands"] += int(live.sum()) * (blend_ct.NPIX // 32)
        w["bands_used"] += int(used.reshape(rec.shape[0], -1, 32, K).any(2).sum())
        warps = cull_bands(rec, org[:, None, :]).reshape(*live.shape, 4, 2).any(-1)
        w["warp_records"] += int(live.sum()) * 4
        w["warp_records_taken"] += int((warps & live[..., None]).sum())
    hist = torch.bincount(torch.clamp(cnt, 0, K), minlength=K + 1)
    w["tiles"] = {"empty": int(hist[0]), "full": int(hist[K]), "between": int(hist[1:K].sum())}
    return w


def coeff_work(coeffs, opacs, tile_chunk=128, cull=True):
    """What K8's and K9's polynomial walks face: the (pixel, slot) pairs
    visited (before each pixel's stop; a slot of opacity 0 is inert) and
    used there (power <= 0 and raw >= 1/255), for coeffs [T, K, 8] and
    opacs [T, 1, K]; with `cull`, also the (slot, warp of 4 rows) pairs of
    live slots and those K8's band cull lets its warps take
    (`coeff_cull_bands`)."""
    T, K, _ = coeffs.shape
    dev = coeffs.device
    basis = blend._pixel_basis(dev)
    U = torch.triu(torch.ones((K, K), device=dev))
    w = dict(visited=0, used=0, **(dict(warp_slots=0, warp_slots_taken=0) if cull else {}))
    with full_float32():
        for c0 in range(0, T, tile_chunk):
            sl = slice(c0, c0 + tile_chunk)
            f = blend._forward_chunk(coeffs[sl], opacs[sl], basis, U)
            visited = (opacs[sl] > 0) & (f["t_before"] >= blend.T_EPS)
            w["visited"] += int(visited.sum())
            w["used"] += int((f["use"] & visited).sum())
            if cull:
                live = opacs[sl, 0] > 0
                warps = coeff_cull_bands(coeffs[sl], opacs[sl]).reshape(*live.shape, 4, 2).any(-1)
                w["warp_slots"] += int(live.sum()) * 4
                w["warp_slots_taken"] += int(warps.sum())
    return w


def fused_work(vals, rects, K, C, block_chunk=8):
    """K9's `coeff_work` at a selection of records-major vals [NB, kb, 16]
    and rects [NB, kb], and the (slot, warp of 4 rows) pairs of live slots
    and those the backward's band cull lets its warps take (`cull_bands`
    on tile-local coordinates: coeff_walk_bwd.cuh's bound is K3's)."""
    w = dict(visited=0, used=0, warp_slots=0, warp_slots_taken=0)
    sx, sy = fused._tile_origins(vals.device)
    org = torch.stack([sx, sy], -1)[None, :, None, :]
    for b0 in range(0, vals.shape[0], block_chunk):
        sl = slice(b0, b0 + block_chunk)
        coeffs, _, opacs, slot, _, hit, _ = fused._tile_inputs(vals[sl], rects[sl], K, C)
        for k, v in coeff_work(coeffs, opacs, cull=False).items():
            w[k] += v
        warps = cull_bands(slot, org).reshape(*hit.shape, 4, 2).any(-1)
        w["warp_slots"] += int(hit.sum()) * 4
        w["warp_slots_taken"] += int((warps & hit[..., None]).sum())
    return w


def check_k2_edges(dev, line):
    """K2 on the edge inputs (`k3_edge_cases`): finite, within image_ok of
    its plain version (but K3_ON_THRESHOLD, whose alpha tests decide by
    rounding) and, on the card, bit-equal to its baseline design and
    across two launches, and at STAGE_C its other batch sizes, its
    diagnostic build and its stage 2 bit-equal to it. Returns the cases
    held."""
    n = 0
    for name, rec, idx, counts, _, ntx, nty, C in k3_edge_cases(dev):
        args = (rec, idx, counts, ntx, nty, C)
        out = blend_ct.blend_gather_ct(*args)
        check(bool(torch.isfinite(out).all()), f"K2 edge case {name}: non-finite image")
        if name != K3_ON_THRESHOLD:
            e = image_err(out, blend_ct.blend_gather_ct_plain(*args))
            check(image_ok(e), f"K2 edge case {name}: differs from plain ({e})")
        if dev.type == "cuda":
            check(torch.equal(bits(out), bits(blend_ct.blend_gather_ct_baseline(*args))),
                  f"K2 edge case {name}: differs from the baseline design")
            check(torch.equal(bits(out), bits(blend_ct.blend_gather_ct(*args))),
                  f"K2 edge case {name}: two launches differ")
            if C == blend_ct.STAGE_C:
                for d, img in k2_designs(args).items():
                    check(torch.equal(bits(out), bits(img)),
                          f"K2 edge case {name}: {d} differs from the kernel")
        n += 1
    sync(dev)
    line(f"K2 edge inputs: {n} cases within p999 <= {P999_MAX} / flips <= {FLIP_MAX} of plain "
         f"(but {K3_ON_THRESHOLD!r})"
         + (", bit-equal to the baseline design and across two launches; at C="
            f"{blend_ct.STAGE_C} the batch sizes, the diagnostic build and stage 2 bit-equal to "
            "the kernel" if dev.type == "cuda" else ""))
    return n


def k2_designs(args):
    """K2's other whole designs at STAGE_C (the batch sizes, the
    diagnostic build) and its stage 2, by name: each should be the
    kernel's image to the bit."""
    whole = len(blend_ct.FWD_STAGES) - 1
    out = {d: blend_ct.blend_gather_ct_stage(*args, whole, design=d)
           for d in ("kernel_r1", "kernel_r2", "kernel_r4", "kernel_diag")}
    out["kernel_diag"] = out["kernel_diag"][0]
    out["stage 2"] = blend_ct.blend_gather_ct_stage(*args, whole)
    return out


def sm_load(diag, cnt, K):
    """Each SM's share of a launch from a diagnostic build's diag [T, 3]
    (SM, clock64 at a block's start and end): full tiles (K records) per
    SM, and the cycles from an SM's first block start to its last block
    end (its busy span) and a full tile's cycles, max and mean."""
    d = diag.cpu().numpy()
    full = cnt.cpu().numpy() >= K
    sm = d[:, 0]
    n = int(sm.max()) + 1
    fulls = np.bincount(sm[full], minlength=n)
    span = np.array([d[sm == i, 2].max() - d[sm == i, 1].min() for i in range(n) if (sm == i).any()])
    tile = d[full, 2] - d[full, 1]
    return {"sms": n, "full_tiles_max": int(fulls.max()), "full_tiles_mean": float(fulls.mean()),
            "busy_cycles_max": int(span.max()), "busy_cycles_mean": float(span.mean()),
            "full_tile_cycles_max": int(tile.max()) if full.any() else 0,
            "full_tile_cycles_mean": float(tile.mean()) if full.any() else 0.0}


def k2_phase(dev, report, scene):
    """K2 on its edge inputs (`check_k2_edges`), then on the card at the
    scene's selection: bit-equal to its baseline design and across two
    launches, its other designs and stage 2 bit-equal to it; the baseline,
    K2 and its batch sizes timed in turns, its stage cuts in turns, ptxas'
    registers per design, and each SM's load from the diagnostic builds.
    Returns the results."""
    line = logger(report)
    b, cnt, C = scene["binned"], scene["cnt"], scene["C"]
    T, K = b.idx.shape
    args = (b.records_ext, b.idx, cnt, b.ntx, b.nty, C)
    k2_edges = check_k2_edges(dev, line)
    res = dict(k2_edges=k2_edges, k2_turns=None, k2_stages=None, k2_ptxas=None, k2_sm_load=None)
    if dev.type != "cuda":
        return res
    out = blend_ct.blend_gather_ct(*args)
    check(torch.equal(bits(out), bits(blend_ct.blend_gather_ct_baseline(*args))),
          "K2: differs from the baseline design at full width")
    check(torch.equal(bits(out), bits(blend_ct.blend_gather_ct(*args))), "K2: two launches differ")
    for d, img in k2_designs(args).items():
        check(torch.equal(bits(out), bits(img)), f"K2: {d} differs from the kernel at full width")
    for st in range(len(blend_ct.FWD_STAGES)):
        check(bool(torch.isfinite(blend_ct.blend_gather_ct_stage(*args, st)).all()),
              f"K2 stage {st}: non-finite output")
    line(f"K2 at full width (T={T}, K={K}, C={C}, the scene's selection): bit-equal to the "
         "baseline design and across two launches; R = 1, 2, 4, the diagnostic build and stage 2 "
         "bit-equal to the kernel")
    whole = len(blend_ct.FWD_STAGES) - 1
    res["k2_turns"] = in_turns({
        "baseline": lambda: blend_ct.blend_gather_ct_baseline(*args),
        "kernel": lambda: blend_ct.blend_gather_ct(*args),
        **{d: (lambda d=d: blend_ct.blend_gather_ct_stage(*args, whole, design=d))
           for d in ("kernel_r1", "kernel_r2", "kernel_r4")},
    }, 20, dev)
    res["k2_stages"] = in_turns({
        f"stage{st}": (lambda st=st: blend_ct.blend_gather_ct_stage(*args, st))
        for st in range(len(blend_ct.FWD_STAGES))}, 20, dev)
    line(f"K2 in turns (kernel: R = {blend_ct.FWD_BATCH} records a batch; kernel_rN: R = N): "
         f"{turns_summary(res['k2_turns'])}")
    ms = [res["k2_stages"][f"stage{st}"]["ms"] for st in range(len(blend_ct.FWD_STAGES))]
    line("K2 stages (ms a call; delta): " + ", ".join(
        f"{st} {nm} {m:.5f} ({m - (ms[st - 1] if st else 0.0):+.5f})"
        for st, (nm, m) in enumerate(zip(blend_ct.FWD_STAGES, ms))))
    logs = report.get("build_logs", {}).get("blend_ct")
    # mangled template arguments: <C, R, STAGE, DIAG> and, baseline, <C, DIAG>
    res["k2_ptxas"] = {d: ptxas_usage(logs, m) for d, m in (
        ("kernel", f"blend_gather_ct_kernelILi{C}ELi{blend_ct.FWD_BATCH}ELi2ELb0E"),
        ("kernel_r1", f"blend_gather_ct_kernelILi{C}ELi1ELi2ELb0E"),
        ("kernel_r2", f"blend_gather_ct_kernelILi{C}ELi2ELi2ELb0E"),
        ("kernel_r4", f"blend_gather_ct_kernelILi{C}ELi4ELi2ELb0E"),
        ("baseline", f"blend_gather_ct_v1_kernelILi{C}ELb0E"))}
    line(f"K2 ptxas at C={C}, whole kernel (registers, static smem bytes, spill stores): "
         + "; ".join(f"{d} {u.get('registers')}, {u.get('smem')}, {u.get('spill_stores')}"
                     for d, us in res["k2_ptxas"].items() for u in us.values()))
    res["k2_sm_load"] = {}
    for d in blend_ct.FWD_DIAG:
        _, diag = blend_ct.blend_gather_ct_stage(*args, whole, design=d)
        res["k2_sm_load"][d] = sm_load(diag, cnt, K)
    line("K2 SM load (full tiles an SM max/mean; busy cycles an SM, first block start to last "
         "block end, max/mean; a full tile's cycles max/mean): " + "; ".join(
             f"{d} {v['full_tiles_max']}/{v['full_tiles_mean']:.2f}, {v['busy_cycles_max']}/"
             f"{v['busy_cycles_mean']:.0f}, {v['full_tile_cycles_max']}/"
             f"{v['full_tile_cycles_mean']:.0f}" for d, v in res["k2_sm_load"].items())
         + f" over {next(iter(res['k2_sm_load'].values()))['sms']} SMs")
    return res


def k3_phase(dev, report, scene):
    """K3 on its edge inputs, then on the scene's selection with a seeded
    cotangent: against its plain version, and on the card bit-equal across
    two launches, against its baseline design, each design's stage 4
    bit-equal to its kernel; the two designs and their stage cuts timed in
    turns. Returns the results, drec (the kernel's) among them."""
    line = logger(report)
    b, cnt, C = scene["binned"], scene["cnt"], scene["C"]
    T, CR = b.idx.shape[0], b.records_ext.shape[1]
    n_contrib = int(cnt.sum())
    with torch.no_grad():
        k3_edges = check_k3_edges(dev, line)
    gen = torch.Generator(device=dev).manual_seed(4)
    g = torch.randn((C + 1, b.nty * 16, b.ntx * 16), generator=gen, device=dev)
    bwd_args = (b.records_ext, b.idx, cnt, g, b.ntx, b.nty, C)
    with torch.no_grad():
        drec = blend_ct.blend_gather_ct_bwd(*bwd_args)
        drec_p = blend_ct.blend_gather_ct_bwd_plain(*bwd_args)
        sync(dev)
        check(bool(torch.isfinite(drec).all()), "K3: non-finite cotangents")
        k3 = slot_err(drec, drec_p)
        line(f"K3 blend_gather_ct_bwd vs plain at full width: max_abs={k3['max_abs']:.3e} "
             f"p999_abs={k3['p999_abs']:.3e} rel_l2={k3['rel_l2']:.3e} "
             f"(max |drec| {k3['scale']:.3e})")
        check(slot_ok(k3), f"K3: outside p999 <= {K3_P999_REL} x max|drec| / rel_l2 <= {K3_REL_L2}")
        work = scene["work"]  # blend_work's, in serve
        k3_turns = k3_stages = k3_base = k3_ptxas = None
        if dev.type == "cuda":
            check(torch.equal(bits(drec), bits(blend_ct.blend_gather_ct_bwd(*bwd_args))),
                  "K3: two launches differ")
            drec_b = blend_ct.blend_gather_ct_bwd_baseline(*bwd_args)
            k3_base = slot_err(drec, drec_b)
            line(f"K3 vs its baseline design at full width: max_abs={k3_base['max_abs']:.3e} "
                 f"p999_abs={k3_base['p999_abs']:.3e} rel_l2={k3_base['rel_l2']:.3e}; two "
                 "launches bit-equal, and equal to the walk without the band cull")
            check(slot_ok(k3_base), f"K3 vs the baseline: outside p999 <= {K3_P999_REL} x "
                                    f"max|drec| / rel_l2 <= {K3_REL_L2}")
            check(torch.equal(bits(drec), bits(blend_ct.blend_gather_ct_bwd_stage(
                *bwd_args, 4, design="kernel_no_cull"))), "K3: the band cull changes the bits")
            # the stage cuts: stage 4 is each design's kernel to the bit
            for d, ref in (("kernel", drec), ("baseline", drec_b)):
                for st in range(len(blend_ct.STAGES)):
                    out = blend_ct.blend_gather_ct_bwd_stage(*bwd_args, st, design=d)
                    check(bool(torch.isfinite(out).all()), f"K3 {d} stage {st}: non-finite output")
                check(torch.equal(bits(out), bits(ref)), f"K3 {d} stage 4: not the kernel's output")
            # K3's walk at 1 and 4 pixels a thread: the same sums in another order
            k3_px = {}
            for d in ("kernel_p1", "kernel_p4"):
                k3_px[d] = slot_err(blend_ct.blend_gather_ct_bwd_stage(*bwd_args, 4, design=d),
                                    drec_p)
                check(slot_ok(k3_px[d]), f"K3 {d} vs plain: outside p999 <= {K3_P999_REL} x "
                                         f"max|drec| / rel_l2 <= {K3_REL_L2}")
            del drec_b, out
            k3_turns = in_turns({
                "baseline": lambda: blend_ct.blend_gather_ct_bwd_baseline(*bwd_args),
                "kernel": lambda: blend_ct.blend_gather_ct_bwd(*bwd_args),
                **{d: (lambda d=d: blend_ct.blend_gather_ct_bwd_stage(*bwd_args, 4, design=d))
                   for d in ("kernel_p1", "kernel_p4")},
            }, 20, dev)
            k3_stages = in_turns({
                f"{d}_stage{st}": (lambda st=st, d=d: blend_ct.blend_gather_ct_bwd_stage(
                    *bwd_args, st, design=d))
                for st in range(len(blend_ct.STAGES)) for d in ("baseline", "kernel")}, 20, dev)
            line(f"K3 in turns (T={T}, K={b.idx.shape[1]}, C={C}, the scene's selection; "
                 f"kernel_p1/p4: K3's walk at 1/4 pixels a thread): {turns_summary(k3_turns)}; "
                 "p1/p4 vs plain rel_l2 " + ", ".join(f"{e['rel_l2']:.3e}" for e in k3_px.values()))
            for d in ("baseline", "kernel"):
                ms = [k3_stages[f"{d}_stage{st}"]["ms"] for st in range(len(blend_ct.STAGES))]
                line(f"K3 {d} stages (ms a call; delta): " + ", ".join(
                    f"{st} {nm} {m:.5f} ({m - (ms[st - 1] if st else 0.0):+.5f})"
                    for st, (nm, m) in enumerate(zip(blend_ct.STAGES, ms))))
            logs = report.get("build_logs", {}).get("blend_ct_bwd")
            # mangled template arguments: <C, P, STAGE> and, baseline, <C, STAGE>
            k3_ptxas = {d: ptxas_usage(logs, m) for d, m in (
                ("kernel", f"blend_gather_ct_bwd_kernelILi{C}ELi2ELi4E"),
                ("kernel_p1", f"blend_gather_ct_bwd_kernelILi{C}ELi1ELi4E"),
                ("kernel_p4", f"blend_gather_ct_bwd_kernelILi{C}ELi4ELi4E"),
                ("baseline", f"blend_gather_ct_bwd_v1_kernelILi{C}ELi4E"))}
            line(f"K3 ptxas at C={C}, whole kernel (registers, static smem bytes, spill stores): "
                 + "; ".join(f"{d} {u.get('registers')}, {u.get('smem')}, {u.get('spill_stores')}"
                             for d, us in k3_ptxas.items() for u in us.values()))
        k3_t = measure(lambda: blend_ct.blend_gather_ct_bwd(*bwd_args), 20, dev)
        k3_plain_t = measure(
            lambda: blend_ct.blend_gather_ct_bwd_plain(*bwd_args), 3, dev, warmup=1
        )
    k3_bytes = 4 * (scene["uniq"] * CR + n_contrib + T) + 4 * g.numel() + 4 * drec.numel()
    k3_bound_ms, k3_bound_by, k3_times = blend_bound(work, k3_bytes, backward=True)
    line(f"K3 bound: bytes {k3_times['bytes'] * 1e3:.5f} ms, operations "
         f"{k3_times['operations'] * 1e3:.5f} ms ({work['used']} used and "
         f"{work['visited'] - work['used']} unused pairs)")
    return dict(drec=drec, k3=k3, k3_edges=k3_edges, k3_base=k3_base, k3_turns=k3_turns,
                k3_stages=k3_stages, k3_ptxas=k3_ptxas, k3_t=k3_t, k3_plain_t=k3_plain_t,
                k3_bytes=k3_bytes, k3_bound_ms=k3_bound_ms, k3_bound_by=k3_bound_by)


def train(dev, report, scene):
    """K3 (`k3_phase`) and K4 at full width against their plain versions,
    one training step's gradients with the kernels against the plain
    versions, then the training path: 10 steps of bench_train.py's
    configuration, each launching every kernel once. Returns the K3/K4
    entries."""
    line = logger(report)
    b, cnt, C = scene["binned"], scene["cnt"], scene["C"]
    T = b.idx.shape[0]
    CR = b.records_ext.shape[1]
    n = b.records_ext.shape[0] - 1
    n_contrib = int(cnt.sum())

    # -- K3: blend backward, on its edge inputs and the scene's selection ----
    k3r = k3_phase(dev, report, scene)
    drec = k3r["drec"]

    # -- K4: per-Gaussian combine of the kernel's cotangents ---------------
    with torch.no_grad():
        # as combine_from_slots calls it: the slot rows read in place
        # through the sort's int64 permutation, the sentinel row written
        ids_sorted, perm = torch.sort(b.idx.reshape(-1), stable=True)
        perm32 = perm.to(torch.int32)
        g_slots = drec.reshape(-1, CR).T
        comb = segsum.combine_sorted(ids_sorted, g_slots, n, perm=perm, rows=n + 1)
        comb_p = segsum.combine_sorted_plain(ids_sorted, g_slots, n, DUP2, perm, rows=n + 1)
        comb32 = segsum.combine_sorted(ids_sorted, g_slots, n, perm=perm32, rows=n + 1)
        from_slots = segsum.combine_from_slots(drec, b.idx, n, DUP2)
        comb_v1 = (segsum.combine_sorted_baseline(ids_sorted, g_slots, n, perm32)
                   if dev.type == "cuda" else comb_p[:n])
        sync(dev)
        k4 = {"max_abs": float((comb - comb_p).abs().max()),
              "bit_exact": bool(torch.equal(comb, comb_p)), "scale": float(comb_p.abs().max()),
              "int32_perm_equal": bool(torch.equal(comb32, comb)),
              "from_slots_equal": bool(torch.equal(from_slots, comb)),
              "baseline_equal": bool(torch.equal(comb[:n], comb_v1)),
              "sentinel_row_zero": bool((comb[n] == 0).all())}
        line(f"K4 combine_sorted vs plain at full width: max_abs={k4['max_abs']:.3e} "
             f"bit_exact={k4['bit_exact']}; int32 perm equal {k4['int32_perm_equal']}, "
             f"combine_from_slots equal {k4['from_slots_equal']}, baseline design equal "
             f"{k4['baseline_equal']}, sentinel row zero {k4['sentinel_row_zero']} "
             f"(n={n}, m={ids_sorted.numel()})")
        check(k4["max_abs"] <= K4_REL * k4["scale"], f"K4: max_abs > {K4_REL} x max|out|")
        for k in ("bit_exact", "int32_perm_equal", "from_slots_equal", "baseline_equal",
                  "sentinel_row_zero"):
            check(k4[k], f"K4: {k} fails")

        def k4_caller_before():  # the conversion, the baseline design, the appended row
            dg = segsum.combine_sorted_baseline(ids_sorted, g_slots, n, perm.to(torch.int32))
            return torch.cat([dg, dg.new_zeros(1, CR)], 0)

        k4_turns = k4_sort = k4_callers = None
        if dev.type == "cuda":
            k4_turns = in_turns({
                "caller_before": k4_caller_before,
                "baseline": lambda: segsum.combine_sorted_baseline(ids_sorted, g_slots, n, perm32),
                "kernel": lambda: segsum.combine_sorted(ids_sorted, g_slots, n, perm=perm,
                                                        rows=n + 1),
            }, 50, dev)
            flat = b.idx.reshape(-1)
            k4_sort = in_turns({"sort": lambda: torch.sort(flat, stable=True)}, 50, dev)
            k4_callers = {k: profile_calls(f, 3, dev) for k, f in (
                ("before", k4_caller_before),
                ("after", lambda: segsum.combine_sorted(ids_sorted, g_slots, n, perm=perm,
                                                        rows=n + 1)))}
            line(f"K4 in turns (n={n}, m={ids_sorted.numel()}, frame 0's drec): "
                 f"{turns_summary(k4_turns)}; the id sort before it: {turns_summary(k4_sort)}")
            k4_folded = folded_launches(k4_callers)
            line(f"K4's caller, kernels a call: before and after {k4_folded}")
            check(k4_folded is None or k4_folded[0] - k4_folded[1] == K4_LAUNCHES_FOLDED,
                  f"K4's caller: {k4_folded} kernels a call, not {K4_LAUNCHES_FOLDED} fewer")
        k4_t = measure(lambda: segsum.combine_sorted(ids_sorted, g_slots, n, perm=perm, rows=n + 1),
                       50, dev)
        k4_plain_t = measure(
            lambda: segsum.combine_sorted_plain(ids_sorted, g_slots, n, DUP2, perm, rows=n + 1), 5,
            dev)
        flat_idx, flat_drec = b.idx.reshape(-1).long(), drec.reshape(-1, CR)
        k4_lib_t = measure(
            lambda: torch.zeros(n + 1, CR, device=dev).index_add_(0, flat_idx, flat_drec), 50, dev
        )
    # the live slots' ids, permutation entries (int64, as the sort gives
    # them) and rows (the sentinels sort to the tail, past the search), and
    # the n + 1 output rows
    k4_live = int((ids_sorted < n).sum())
    k4_bytes = 4 * (k4_live * (CR + 1) + (n + 1) * CR) + perm.element_size() * k4_live
    k4_bound_ms = k4_bytes / HBM_BYTES_PER_S * 1e3

    # -- one step's gradients: kernels against plain -----------------------
    model = scene["model"]._replace(config=dict(scene["model"].config, **TRAIN_CONFIG))
    params = init_avatar(torch.Generator().manual_seed(0), model)
    tx = make_optimizer(params, lr_tree_from_config(params))
    weights = LossWeights(enable_vgg_from=0)
    step = make_train_step(model, tx, max_per_tile=K, loss_weights=weights)
    step_plain = make_train_step(model, tx, max_per_tile=K, loss_weights=weights, plain=True)
    hg = torch.Generator().manual_seed(1)
    lbs_dim = model.cond_dim
    batch = {
        "camera": scene["camera"],
        "lbs": (torch.randn(lbs_dim, generator=hg) * 0.1).to(dev),
        "frame_idx": 0,
        "camera_idx": 0,
        "image": torch.rand((3, HEIGHT, WIDTH), generator=hg).to(dev),
        "alpha": torch.ones((1, HEIGHT, WIDTH), device=dev),
        "silhouette": torch.full((3, HEIGHT, WIDTH), 0.5, device=dev),
    }
    bg = random_bg(torch.Generator().manual_seed(2), dev)
    scene.update(batch=batch, bg=bg)
    _, terms_k, _, grads_k = step.loss_and_grads(params, batch, bg, 0)
    _, terms_p, _, grads_p = step_plain.loss_and_grads(params, batch, bg, 0)
    sync(dev)
    term_err = {}
    for k, v in terms_p.items():
        a, c = float(terms_k[k].detach()), float(v.detach())
        term_err[k] = abs(a - c) / max(abs(c), 1e-30)
    leaf_err = [rel_l2(a, c) for a, c in zip(grads_k, grads_p)]
    worst = int(np.argmax(leaf_err))
    line(f"one step, kernels vs plain at full width: terms rel {term_err}; gradients over "
         f"{len(leaf_err)} leaves rel_l2 max {leaf_err[worst]:.3e} (leaf {worst}, "
         f"{tuple(grads_p[worst].shape)}), median {float(np.median(leaf_err)):.3e}")
    check(all(e <= TERM_RTOL for e in term_err.values()), f"step: a loss term off by > {TERM_RTOL}")
    check(all(bool(torch.isfinite(gk).all()) for gk in grads_k), "step: non-finite gradient")
    check(leaf_err[worst] <= GRAD_REL_L2, f"step: a gradient leaf off by rel L2 > {GRAD_REL_L2}")
    del grads_k, grads_p, step_plain

    # -- the training path: 10 steps ---------------------------------------
    gen = torch.Generator().manual_seed(3)
    step(params, batch, gen, 0)  # warm-up
    sync(dev)
    start = [p.detach().clone() for p in tree_leaves(params)]
    reset_launch_counts()
    per_step, finite = [], torch.ones((), dtype=torch.bool, device=dev)
    t0 = time.perf_counter()
    for i in range(STEPS):
        _, m = step(params, batch, gen, i + 1)
        for v in m.values():
            finite &= torch.isfinite(torch.as_tensor(v, device=dev)).all()
        per_step.append(
            (extract.launches, blend_ct.launches, blend_ct.bwd_launches, segsum.launches)
        )
    sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    launches = {"blend_gather_ct_bwd": blend_ct.bwd_launches, "combine_sorted": segsum.launches,
                "extract_slices": extract.launches, "blend_gather_ct": blend_ct.launches}
    moved = sum(float((p.detach() - q).abs().sum()) for p, q in zip(tree_leaves(params), start))
    line(f"training path: {STEPS} steps, {step_ms:.3f} ms/step, {1e3 / step_ms:.3f} steps/s; "
         f"launches {launches}; last losses "
         + ", ".join(f"{k}={float(v):.5f}" for k, v in m.items() if k.endswith("loss")))
    check(bool(finite), "training path: a non-finite loss term")
    check(per_step == [(i + 1,) * 4 for i in range(STEPS)],
          f"launch counts after each step {per_step}: not one per kernel per step")
    check(moved > 0.0, "training path: the parameters did not change")
    check(off_path_launches() == 0,
          "training path: a baseline design or a K2/K3 stage cut was launched")
    step_prof = profile_calls(lambda: step(params, batch, gen, STEPS + 1), 3, dev)
    if step_prof is not None:
        line(f"training step, profiled ({step_prof['calls']} steps): "
             f"{profile_summary(step_prof, step_ms)}")
        line(f"training step kernels a call: {step_prof['kernels_per_call']:.0f} against "
             f"{STEP_KERNELS_BEFORE} before the K1 and K4 epilogues were folded in "
             f"({step_prof['kernels_per_call'] - STEP_KERNELS_BEFORE:+.0f}; the callers gave up "
             f"{STEP_LAUNCHES_FOLDED})")

    def stage_ms(design):  # K3's stage cuts, ms a call in turns
        return k3r["k3_stages"] and [k3r["k3_stages"][f"{design}_stage{st}"]["ms"]
                                     for st in range(len(blend_ct.STAGES))]

    kernels = [
        {
            "name": "blend_gather_ct_bwd", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/blend_ct_bwd.cu",
            "replaces": "d3ga_tpu/raster/pallas_blend_ct.py:357",
            "launches": launches["blend_gather_ct_bwd"], "max_abs_err": k3r["k3"]["max_abs"],
            "ms": k3r["k3_turns"]["kernel"]["ms"] if k3r["k3_turns"] else k3r["k3_t"]["ms"],
            "plain_ms": k3r["k3_plain_t"]["ms"], "bound_ms": k3r["k3_bound_ms"],
            "bound_by": k3r["k3_bound_by"], "library_ms": None,
            "baseline_ms": k3r["k3_turns"] and k3r["k3_turns"]["baseline"]["ms"],
            "designs_ms": k3r["k3_turns"] and {d: v["ms"] for d, v in k3r["k3_turns"].items()},
            "stages_ms": stage_ms("kernel"), "baseline_stages_ms": stage_ms("baseline"),
        },
        {
            "name": "combine_sorted", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/segsum.cu",
            "replaces": "d3ga_tpu/raster/pallas_segsum.py:101",
            "launches": launches["combine_sorted"], "max_abs_err": k4["max_abs"],
            "ms": k4_turns["kernel"]["ms"] if k4_turns else k4_t["ms"],
            "plain_ms": k4_plain_t["ms"], "bound_ms": k4_bound_ms,
            "bound_by": "bytes", "library_ms": k4_lib_t["ms"],
            "baseline_ms": k4_turns and k4_turns["baseline"]["ms"],
            "sort_ms": k4_sort and k4_sort["sort"]["ms"],
        },
    ]
    timings = {
        "blend_gather_ct_bwd": {"kernel": k3r["k3_t"], "plain": k3r["k3_plain_t"]},
        "combine_sorted": {"kernel": k4_t, "plain": k4_plain_t, "library": k4_lib_t},
    }
    for k in kernels:
        t = timings[k["name"]]
        line(f"{k['name']}: ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
             f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) library_ms={k['library_ms']} "
             f"launches_per_step={k['launches'] / STEPS:g}; wall per call "
             + ", ".join(f"{nm}={v['call_ms']:.4f}" for nm, v in t.items()))
    report.update(
        k3_full_width=k3r["k3"], k3_bytes=k3r["k3_bytes"], k3_edge_cases=k3r["k3_edges"],
        k3_vs_baseline=k3r["k3_base"], k3_turns=k3r["k3_turns"], k3_stages=k3r["k3_stages"],
        k3_ptxas=k3r["k3_ptxas"], k4_full_width=k4, k4_bytes=k4_bytes, k4_live=k4_live,
        k4_turns=k4_turns, k4_sort=k4_sort, k4_callers=k4_callers,
        step_terms_rel=term_err, step_grad_rel_l2=leaf_err, step_ms=step_ms,
        steps_per_s=1e3 / step_ms, train_launches=launches, step_profiled=step_prof,
        train_timings=timings,
    )
    report["kernels"] = report.get("kernels", []) + kernels
    return kernels


def capture(dev, report, scene):
    """The capture configs' training options at full width (the serving
    scene, 1024 x 667; `CAPTURE_CONFIGS`): for each config one step's
    loss terms and every gradient leaf with the kernels against the
    plain versions (TERM_RTOL, GRAD_REL_L2), every leaf the config adds
    finite and nonzero, then CAPTURE_STEPS steps with the launch counts
    reset just before (K1-K4 once a step, no design before), ms/step,
    and a profile (device busy ms, kernels a step)."""
    line = logger(report)
    base = scene["model"]
    n_frames, lbs_dim = base.n_frames, base.cond_dim
    hg = torch.Generator().manual_seed(11)
    batch = dict(scene["batch"], frame_idx=1, camera_idx=1,
                 cam_rt=scene["camera"].world_view)
    out = {}
    for name, config in CAPTURE_CONFIGS.items():
        model = base._replace(config=dict(base.config, **config))
        opt = {}
        if config.get("use_opt_smplx"):
            opt = {"init_smplx_poses": torch.randn((n_frames, lbs_dim), generator=hg) * 0.1,
                   "init_smplx_rh": torch.randn((n_frames, 3), generator=hg) * 0.02,
                   "init_smplx_th": torch.randn((n_frames, 3), generator=hg) * 0.02}
        params = init_avatar(torch.Generator().manual_seed(0), model, **opt)
        # off their constant inits, so each option's gradient is exercised
        with torch.no_grad():
            for key in ("learnable_blur", "pixel_cal", "bg_net"):
                for t in tree_leaves(params.get(key)):
                    t.add_(torch.randn(t.shape, generator=hg).to(dev) * 0.05)
        vgg = None
        if name == "every":
            vgg = init_vgg19_features(torch.Generator().manual_seed(4), allow_random=True,
                                      device=dev)
        weights = LossWeights(enable_vgg_from=CAPTURE_VGG_FROM if vgg else 0)
        tx = make_optimizer(params, lr_tree_from_config(params))
        step = make_train_step(model, tx, max_per_tile=K, vgg_params=vgg, loss_weights=weights)
        step_plain = make_train_step(model, tx, max_per_tile=K, vgg_params=vgg,
                                     loss_weights=weights, plain=True)
        gen = torch.Generator().manual_seed(12)
        bg = random_bg(gen, dev)
        noise = (random_noise(gen, batch["image"].shape, dev)
                 if needs_noise(params, model.config) else None)
        it = CAPTURE_ITERATION
        _, terms_k, _, grads_k = step.loss_and_grads(params, batch, bg, it, noise)
        _, terms_p, _, grads_p = step_plain.loss_and_grads(params, batch, bg, it, noise)
        sync(dev)
        term_err = {k: abs(float(terms_k[k].detach()) - float(v.detach()))
                    / max(abs(float(v.detach())), 1e-30) for k, v in terms_p.items()}
        leaf_err = [rel_l2(a, c) for a, c in zip(grads_k, grads_p)]
        worst = int(np.argmax(leaf_err))
        # the leaves the config adds: finite and nonzero
        new = {}
        for key in CAPTURE_LEAVES[name]:
            idx = [i for i, t in enumerate(tx.leaves)
                   if any(t is u for u in tree_leaves(params[key]))]
            new[key] = max(float(grads_k[i].abs().max()) for i in idx)
            check(all(bool(torch.isfinite(grads_k[i]).all()) for i in idx),
                  f"capture {name}: non-finite gradient in {key}")
        h, w = batch["image"].shape[1:]
        line(f"capture {name}, one step kernels vs plain ({h} x {w}, iteration {it}): terms "
             + ", ".join(f"{k} {float(terms_k[k].detach()):.6g} (rel {e:.2e})"
                         for k, e in term_err.items())
             + f"; gradients over {len(leaf_err)} leaves rel_l2 max {leaf_err[worst]:.3e} (leaf "
             f"{worst}, {tuple(grads_p[worst].shape)}), median {float(np.median(leaf_err)):.3e}; "
             f"new leaves' max |grad| {new}")
        check(set(terms_k) == set(terms_p), f"capture {name}: the term sets differ")
        check(all(e <= TERM_RTOL for e in term_err.values()),
              f"capture {name}: a loss term off by > {TERM_RTOL}: {term_err}")
        check(all(bool(torch.isfinite(g).all()) for g in grads_k),
              f"capture {name}: non-finite gradient")
        check(leaf_err[worst] <= GRAD_REL_L2,
              f"capture {name}: a gradient leaf off by rel L2 {leaf_err[worst]:.3e} > "
              f"{GRAD_REL_L2}")
        check(all(v > 0 for v in new.values()),
              f"capture {name}: a new leaf's gradient is 0: {new}")
        check(name != "every" or float(terms_k["vgg_loss"].detach()) > 0,
              "capture every: the VGG term was not counted")
        del grads_k, grads_p, step_plain

        # -- CAPTURE_STEPS steps on the kernels -------------------------------
        step(params, batch, gen, it)  # warm-up
        sync(dev)
        reset_launch_counts()
        finite = torch.ones((), dtype=torch.bool, device=dev)
        t0 = time.perf_counter()
        for i in range(CAPTURE_STEPS):
            _, m = step(params, batch, gen, it + 1 + i)
            for v in m.values():
                finite &= torch.isfinite(torch.as_tensor(v, device=dev)).all()
        sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3 / CAPTURE_STEPS
        counts = (extract.launches, blend_ct.launches, blend_ct.bwd_launches, segsum.launches)
        check(bool(finite), f"capture {name}: a non-finite loss term")
        check(counts == (CAPTURE_STEPS,) * 4,
              f"capture {name}: K1-K4 launches {counts}, not one each a step")
        check(off_path_launches() == 0, f"capture {name}: a design before was launched")
        prof = profile_calls(lambda: step(params, batch, gen, it + CAPTURE_STEPS + 1), 3, dev)
        line(f"capture {name}: {CAPTURE_STEPS} steps, {step_ms:.3f} ms/step; K1-K4 launches "
             f"{counts} ({report['card']})"
             + (f"; profiled: {profile_summary(prof, step_ms)}" if prof else ""))
        out[name] = {"terms": {k: float(v.detach()) for k, v in terms_k.items()},
                     "terms_rel": term_err, "grad_rel_l2": leaf_err, "new_leaf_max_grad": new,
                     "step_ms": step_ms, "launches": counts, "profiled": prof}
        del params, tx, step
    report["capture"] = out
    return out


def sharded(dev, report, scene):
    """The sharded raster on a NCCL world of one: K5's and K7's forwards
    and backwards on K3's edge inputs (`check_rec_fwd_edges`,
    `check_rec_bwd_edges`); K5 forward and backward against their plain
    versions at full width (the whole grid, and the slices of emulated
    ranks of a 4-way banded split), on the card the forward bit-equal to
    K2's rows of the same tiles and to its baseline design, the backward
    bit-equal to K3's rows and within tolerance of its baseline design,
    each timed in turns against its baseline and K2 or K3; rasterize_sharded
    against the single-device rasterize_tiled on frame 0's Gaussians, the
    banded objective's gradients with the kernels against the plain
    versions, then 10 forward+backward calls of it, each launching K1
    twice, K5 forward, K5 backward and K4 once. Returns the K5 entries."""
    line = logger(report)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.makedirs(OUT_DIR, exist_ok=True)
    store = os.path.abspath(os.path.join(OUT_DIR, f"nccl_store_{os.getpid()}"))
    if os.path.exists(store):
        os.remove(store)
    initialize_distributed(f"file://{store}", 1, 0, device=dev)
    try:
        mesh = local_mesh()
        line(f"sharded: {dist.get_backend()} world of {dist.get_world_size()} "
             f"(one card), mesh data={mesh.data} x model={mesh.model}")
        return _sharded_phases(dev, report, scene, mesh, line)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)


def _sharded_phases(dev, report, scene, mesh, line):
    group = mesh.model_group
    b, cnt, C = scene["binned"], scene["cnt"], scene["C"]
    T, ntx, nty = b.idx.shape[0], b.ntx, b.nty
    CR = b.records_ext.shape[1]
    n_contrib = int(cnt.sum())

    # -- K5: flat-tiles blend, forward and backward, vs plain ---------------
    with torch.no_grad():
        rec_fwd_edges = check_rec_fwd_edges(dev, line)
        rec_bwd_edges = check_rec_bwd_edges(dev, line)
    tps = -(-nty // SHARD_EMULATE) * ntx  # tiles of one band of a 4-way split
    slices = [(0, T)] + [(r * tps, min(tps, T - r * tps)) for r in range(SHARD_EMULATE)
                         if r * tps < T]
    gen = torch.Generator(device=dev).manual_seed(5)
    g_full = torch.randn((T, 256, C + 1), generator=gen, device=dev)
    # the same cotangent in K3's planar layout: K5's drec at each offset
    # is K3's rows of those tiles, to the bit
    g_planar = blend_rec._image_from_tiles(g_full, ntx, nty).permute(2, 0, 1).contiguous()
    k3_args = (b.records_ext, b.idx, cnt, g_planar, ntx, nty, C)
    k5 = {"fwd": [], "bwd": [], "bwd_vs_baseline": []}
    with torch.no_grad():
        drec_k3 = blend_ct.blend_gather_ct_bwd(*k3_args)
        # K2's image, tile-major: K5's values at each offset are its rows
        # of those tiles, to the bit
        k2_t = k2_tiles(b.records_ext, b.idx, cnt, ntx, nty, C)
        for off, n in slices:
            args = (b.records_ext, b.idx[off : off + n].contiguous(), cnt[off : off + n].contiguous(),
                    off, ntx, C)
            g = g_full[off : off + n].contiguous()
            out_k = blend_rec.blend_gather_rec(*args)
            out_p = blend_rec.blend_gather_rec_plain(*args)
            drec_k = blend_rec.blend_gather_rec_bwd(*args[:4], g, ntx, C)
            drec_p = blend_rec.blend_gather_rec_bwd_plain(*args[:4], g, ntx, C)
            sync(dev)
            check(bool(torch.isfinite(out_k).all() and torch.isfinite(drec_k).all()),
                  f"K5 at offset {off}: non-finite output")
            e = image_err(out_k, out_p)
            d = slot_err(drec_k, drec_p)
            k5["fwd"].append(dict(e, offset=off, tiles=n))
            k5["bwd"].append(dict(d, offset=off, tiles=n))
            line(f"K5 at tile offset {off} ({n} tiles) vs plain: forward p999_abs="
                 f"{e['p999_abs']:.3e} frac={e['flip_frac']:.3e} max_abs={e['max_abs']:.3e}; "
                 f"backward p999_abs={d['p999_abs']:.3e} rel_l2={d['rel_l2']:.3e} "
                 f"(max |drec| {d['scale']:.3e})")
            check(image_ok(e), f"K5 forward at offset {off}: outside p999 <= {P999_MAX} / "
                               f"flips <= {FLIP_MAX}")
            check(slot_ok(d),
                  f"K5 backward at offset {off}: outside p999 <= {K3_P999_REL} x max|drec| / "
                  f"rel_l2 <= {K3_REL_L2}")
            if dev.type == "cuda":
                check(torch.equal(bits(out_k), bits(k2_t[off : off + n])),
                      f"K5 forward at offset {off}: differs from K2's rows of its tiles")
                check(torch.equal(bits(out_k), bits(blend_rec.blend_gather_rec_baseline(*args))),
                      f"K5 forward at offset {off}: differs from its baseline design")
                check(torch.equal(bits(drec_k), bits(drec_k3[off : off + n])),
                      f"K5 backward at offset {off}: differs from K3's rows of its tiles")
                db = slot_err(drec_k, blend_rec.blend_gather_rec_bwd_baseline(*args[:4], g, ntx, C))
                k5["bwd_vs_baseline"].append(dict(db, offset=off, tiles=n))
                line(f"K5 at tile offset {off}: forward bit-equal to K2's rows of its tiles and to "
                     "its baseline design; backward bit-equal to K3's rows of its tiles, vs its "
                     f"baseline design p999_abs={db['p999_abs']:.3e} rel_l2={db['rel_l2']:.3e}")
                check(slot_ok(db), f"K5 backward at offset {off}: outside p999 <= {K3_P999_REL} "
                                   f"x max|drec| / rel_l2 <= {K3_REL_L2} of the baseline")
        # the whole grid at offset 0 is K2's image, tile-major, to the bit
        full = blend_rec.blend_gather_rec(b.records_ext, b.idx, cnt, 0, ntx, C)
        sync(dev)
        k5_vs_k2 = float((full - k2_t).abs().max())
        k5_is_k2 = bool(torch.equal(bits(full), bits(k2_t)))
        line(f"K5 whole grid vs K2's image (tile-major): max_abs={k5_vs_k2:.3e}, equal to the "
             f"last bit: {k5_is_k2}")
        check(k5_is_k2, "K5 and K2 disagree on the whole grid")
        del k2_t
        # timing at the main path's shapes: the whole grid (world size 1)
        fargs = (b.records_ext, b.idx, cnt, 0, ntx, C)
        _, pairs = blend_rec.blend_gather_rec_plain(*fargs, count_pairs=True)
        k5_t = measure(lambda: blend_rec.blend_gather_rec(*fargs), 20, dev)
        k5_plain_t = measure(lambda: blend_rec.blend_gather_rec_plain(*fargs), 3, dev, warmup=1)
        k5b_t = measure(lambda: blend_rec.blend_gather_rec_bwd(*fargs[:4], g_full, ntx, C), 20, dev)
        k5b_plain_t = measure(
            lambda: blend_rec.blend_gather_rec_bwd_plain(*fargs[:4], g_full, ntx, C), 3, dev,
            warmup=1)
        k5_turns = k5_ptxas = k5b_turns = k5b_ptxas = None
        if dev.type == "cuda":
            k5_turns = in_turns({
                "baseline": lambda: blend_rec.blend_gather_rec_baseline(*fargs),
                "kernel": lambda: blend_rec.blend_gather_rec(*fargs),
                "k2": lambda: blend_ct.blend_gather_ct(b.records_ext, b.idx, cnt, ntx, nty, C),
            }, 20, dev)
            k5_ptxas, said = rec_ptxas(report, "rec", C, False)
            line(f"K5 forward in turns (the whole grid, offset 0; k2: K2 on the same selection): "
                 f"{turns_summary(k5_turns)}; {said}")
            k5b_turns = in_turns({
                "baseline": lambda: blend_rec.blend_gather_rec_bwd_baseline(
                    *fargs[:4], g_full, ntx, C),
                "kernel": lambda: blend_rec.blend_gather_rec_bwd(*fargs[:4], g_full, ntx, C),
                "k3": lambda: blend_ct.blend_gather_ct_bwd(*k3_args),
            }, 20, dev)
            k5b_ptxas, said = rec_ptxas(report, "rec", C, True)
            line(f"K5 backward in turns (the whole grid, offset 0; k3: K3 on the same selection "
                 f"and cotangent): {turns_summary(k5b_turns)}; {said}")
        del drec_k3
    in_bytes = 4 * (scene["uniq"] * CR + n_contrib + T)
    k5_bytes = in_bytes + 4 * T * 256 * (C + 1)
    k5b_bytes = in_bytes + 4 * g_full.numel() + 4 * T * b.idx.shape[1] * CR
    # the whole grid at offset 0 blends the champion selection: the scene's
    # used and unused pairs (blend_work) are K5's
    k5_bound_ms, k5_by, _ = blend_bound(scene["work"], k5_bytes)
    k5b_bound_ms, k5b_by, _ = blend_bound(scene["work"], k5b_bytes, backward=True)
    line(f"K5 work: pixel-record pairs visited={pairs}, bytes forward={k5_bytes} "
         f"backward={k5b_bytes}; bound forward {k5_bound_ms:.5f} ms ({k5_by}), backward "
         f"{k5b_bound_ms:.5f} ms ({k5b_by})")

    # -- rasterize_sharded vs the single-device rasterize_tiled ---------------
    means, cov3d, opac, colors = scene["gauss"]
    bg = torch.tensor(BG6, device=dev)
    with torch.no_grad():
        img_s, aux_s = rasterize_sharded(
            mesh, means, scene["camera"], bg, cov3d=cov3d, opacities=opac, colors=colors,
            max_per_tile=K, dup=DUP, use_pallas=True, shard_select=True)
        img_1, aux_1 = rasterize_tiled(
            means, scene["camera"], bg, cov3d=cov3d, opacities=opac, colors=colors,
            max_per_tile=K, use_pallas=True, coarse="dupsort_depth", dup=DUP, depth_exact=True)
        sync(dev)
    # The local selection orders a tile's candidates by quantized depth
    # (index tie-breaks, as the JAX package's sharded path does), the
    # single-device one here by exact depth: where a tile holds more than K
    # candidates, the two can cut different entries at the K-th place. The
    # image is held on the tiles whose candidates are all selected.
    sh = image_err(img_s, img_1)
    full_tiles = (b.counts <= K).reshape(nty, ntx)
    px = full_tiles.repeat_interleave(16, 0).repeat_interleave(16, 1)[:HEIGHT, :WIDTH]
    sh_in = image_err(img_s[:, px], img_1[:, px])
    a_s, a_1 = aux_ints(aux_s), aux_ints(aux_1)
    line(f"rasterize_sharded (world of 1) vs rasterize_tiled, frame 0, on the "
         f"{int(full_tiles.sum())} of {T} tiles within K: p999_abs={sh_in['p999_abs']:.3e} "
         f"frac={sh_in['flip_frac']:.3e} max_abs={sh_in['max_abs']:.3e}; on all tiles: "
         f"p999_abs={sh['p999_abs']:.3e} frac={sh['flip_frac']:.3e} max_abs={sh['max_abs']:.3e}; "
         f"aux sharded {a_s} single {a_1}")
    check(tuple(img_s.shape) == (C, HEIGHT, WIDTH), f"sharded image shape {tuple(img_s.shape)}")
    check(bool(torch.isfinite(img_s).all()), "sharded image: non-finite values")
    check(image_ok(sh_in), "rasterize_sharded and rasterize_tiled disagree on the tiles within K")
    for f in ("overflow", "max_per_tile", "n_contrib"):
        check(a_s[f] == a_1[f], f"sharded RasterAux.{f} {a_s[f]} != single-device {a_1[f]}")
    check(a_s["merge_overflow"] == -1, "merge_overflow computed without a front margin")

    # -- the banded objective's gradients: kernels vs plain --------------------
    tgen = torch.Generator(device=dev).manual_seed(6)
    target = torch.rand((C, HEIGHT, WIDTH), generator=tgen, device=dev)

    def objective(leaves, plain=False):
        band, _ = rasterize_collective(
            leaves[0], scene["camera"], bg, group, mesh.model, cov3d=leaves[1],
            opacities=leaves[2], colors=leaves[3], max_per_tile=K, dup=DUP, use_pallas=True,
            banded=True, shard_select=True, plain=plain)
        loss = banded_l1_ssim(band, target, group, mesh.model)
        loss.backward()
        return loss

    def grads(plain):
        leaves = [t.clone().requires_grad_(True) for t in scene["gauss"]]
        loss = objective(leaves, plain)
        return float(loss.detach()), [t.grad for t in leaves]

    loss_k, g_k = grads(False)
    loss_p, g_p = grads(True)
    sync(dev)
    obj_err = [rel_l2(a, c) for a, c in zip(g_k, g_p)]
    names = ("means", "cov3d", "opacities", "colors")
    line(f"banded objective, kernels vs plain: loss {loss_k:.7f} vs {loss_p:.7f}; gradients "
         f"rel_l2 " + ", ".join(f"{n}={e:.3e}" for n, e in zip(names, obj_err)))
    check(abs(loss_k - loss_p) <= TERM_RTOL * abs(loss_p), "banded objective: loss off")
    check(all(bool(torch.isfinite(gk).all()) for gk in g_k), "banded objective: non-finite grad")
    check(max(obj_err) <= GRAD_REL_L2, f"banded objective: a gradient off by rel L2 > {GRAD_REL_L2}")

    # -- the sharded path: 10 forward+backward calls ---------------------------
    leaves = [t.clone().requires_grad_(True) for t in scene["gauss"]]

    def call():
        for t in leaves:
            t.grad = None
        return objective(leaves)

    call()  # warm-up
    sync(dev)
    reset_launch_counts()
    per_call = []
    t0 = time.perf_counter()
    for _ in range(SHARD_CALLS):
        loss = call()
        per_call.append((extract.launches, blend_rec.launches, blend_rec.bwd_launches,
                         segsum.launches, blend_ct.launches + blend_ct.bwd_launches))
    sync(dev)
    call_ms = (time.perf_counter() - t0) * 1e3 / SHARD_CALLS
    launches = {"extract_slices": extract.launches, "blend_gather_rec": blend_rec.launches,
                "blend_gather_rec_bwd": blend_rec.bwd_launches, "combine_sorted": segsum.launches}
    line(f"sharded path: {SHARD_CALLS} objective forward+backward calls, {call_ms:.3f} ms/call; "
         f"launches {launches}; last loss {float(loss.detach()):.6f}")
    check(bool(torch.isfinite(loss).all()), "sharded path: non-finite loss")
    check(per_call == [(2 * (i + 1), i + 1, i + 1, i + 1, 0) for i in range(SHARD_CALLS)],
          f"launch counts after each call {per_call}: not K1 x2, K5, K5 backward, K4 x1 a call")
    check(off_path_launches() == 0,
          "sharded path: a baseline design or a K2/K3 stage cut was launched")
    prof = profile_calls(call, 3, dev)
    if prof is not None:
        line(f"sharded objective, profiled ({prof['calls']} calls): "
             f"{profile_summary(prof, call_ms)}")

    kernels = [
        {
            "name": "blend_gather_rec", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/blend_rec.cu",
            "replaces": "d3ga_tpu/raster/pallas_blend_rec.py:283",
            "launches": launches["blend_gather_rec"],
            "max_abs_err": max(e["max_abs"] for e in k5["fwd"]),
            "ms": k5_t["ms"], "plain_ms": k5_plain_t["ms"], "bound_ms": k5_bound_ms,
            "bound_by": k5_by, "library_ms": None,
            "baseline_ms": k5_turns and k5_turns["baseline"]["ms"],
            "designs_ms": k5_turns and {d: v["ms"] for d, v in k5_turns.items()},
        },
        {
            "name": "blend_gather_rec_bwd", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/blend_rec.cu",
            "replaces": "d3ga_tpu/raster/pallas_blend_rec.py:306",
            "launches": launches["blend_gather_rec_bwd"],
            "max_abs_err": max(e["max_abs"] for e in k5["bwd"]),
            "ms": k5b_t["ms"], "plain_ms": k5b_plain_t["ms"], "bound_ms": k5b_bound_ms,
            "bound_by": k5b_by, "library_ms": None,
            "baseline_ms": k5b_turns and k5b_turns["baseline"]["ms"],
            "designs_ms": k5b_turns and {d: v["ms"] for d, v in k5b_turns.items()},
        },
    ]
    timings = {"blend_gather_rec": {"kernel": k5_t, "plain": k5_plain_t},
               "blend_gather_rec_bwd": {"kernel": k5b_t, "plain": k5b_plain_t}}
    for k in kernels:
        t = timings[k["name"]]
        line(f"{k['name']}: ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
             f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) library_ms={k['library_ms']} "
             f"launches_per_call={k['launches'] / SHARD_CALLS:g}; wall per call "
             + ", ".join(f"{nm}={v['call_ms']:.4f}" for nm, v in t.items()))
    report.update(
        k5=k5, k5_vs_k2=k5_vs_k2, k5_is_k2=k5_is_k2, k5_pairs=pairs, k5_bytes=k5_bytes,
        k5b_bytes=k5b_bytes, rec_fwd_edges=rec_fwd_edges, rec_bwd_edges=rec_bwd_edges,
        k5_turns=k5_turns, k5_ptxas=k5_ptxas, k5b_turns=k5b_turns, k5b_ptxas=k5b_ptxas,
        sharded_vs_single=sh, sharded_vs_single_within_k=sh_in, aux_sharded=a_s, aux_single=a_1,
        objective_grad_rel_l2=obj_err,
        sharded_call_ms=call_ms, sharded_launches=launches, sharded_profiled=prof,
        sharded_timings=timings,
    )
    report["kernels"] = report.get("kernels", []) + kernels
    return kernels


KERNEL_NAMES = ("extract_slices", "blend_gather_ct", "blend_gather_ct_bwd", "combine_sorted",
                "blend_gather_rec", "blend_gather_rec_bwd", "blend_gather_img",
                "blend_gather_img_bwd", "blend_tiles_coeffs", "blend_tiles_coeffs_bwd",
                "fused_select_blend", "fused_select_blend_bwd")


def launch_counts():
    """Every kernel's launches so far, in KERNEL_NAMES' order: K1, K2, K3,
    K4, K5, K5 backward, K7, K7 backward, K8, K8 backward, K9, K9
    backward."""
    return (extract.launches, blend_ct.launches, blend_ct.bwd_launches, segsum.launches,
            blend_rec.launches, blend_rec.bwd_launches, blend_rec.img_launches,
            blend_rec.img_bwd_launches, blend.launches, blend.bwd_launches, fused.launches,
            fused.bwd_launches)


def variants(dev, report, scene):
    """The rest of the single-device rasterizer: K7 (the image-layout
    blend) forward and backward against the plain versions, its image
    bit-equal to K2's and, on the card, to its baseline design, its
    backward bit-equal to K3's drec, each timed in turns against its
    baseline design and K2 or K3, on the champion selection; the
    training step under the ActorsHQ actor's raster settings
    (dupsort_tile, dup 4) in the rec layout (K7) and in the ct layout
    (K2/K3), each with one step's gradients kernels vs plain, then 5
    steps; the xla backend (the topk
    funnel and `_blend_tiles`), forward + backward, against the same
    selection blended by K2; the public API's backends against the oracle
    on a small scene. Returns the K7 entries."""
    line = logger(report)
    b, cnt, C = scene["binned"], scene["cnt"], scene["C"]
    T, ntx, nty = b.idx.shape[0], b.ntx, b.nty
    CR = b.records_ext.shape[1]
    n_contrib = int(cnt.sum())

    # -- K7: image-layout blend, forward and backward, vs plain and K2 -------
    gen = torch.Generator(device=dev).manual_seed(7)
    g = torch.randn((nty * 16, ntx * 16, C + 1), generator=gen, device=dev)
    args = (b.records_ext, b.idx, cnt, ntx, nty, C)
    with torch.no_grad():
        out_k = blend_rec.blend_gather_img(*args)
        out_p, pairs = blend_rec.blend_gather_img_plain(*args, count_pairs=True)
        planar = blend_ct.blend_gather_ct(*args)
        drec_k = blend_rec.blend_gather_img_bwd(*args[:3], g, ntx, nty, C)
        drec_p = blend_rec.blend_gather_img_bwd_plain(*args[:3], g, ntx, nty, C)
        sync(dev)
        check(bool(torch.isfinite(out_k).all() and torch.isfinite(drec_k).all()),
              "K7: non-finite output")
        k7 = image_err(out_k, out_p)
        k7_is_k2 = bool(torch.equal(bits(out_k), bits(planar.permute(1, 2, 0))))
        k7b = slot_err(drec_k, drec_p)
        line(f"K7 blend_gather_img vs plain at full width: max_abs={k7['max_abs']:.3e} "
             f"p999_abs={k7['p999_abs']:.3e} frac={k7['flip_frac']:.3e}; equals K2's image "
             f"(channels last) to the last bit: {k7_is_k2}; backward p999_abs="
             f"{k7b['p999_abs']:.3e} rel_l2={k7b['rel_l2']:.3e} (max |drec| {k7b['scale']:.3e})")
        check(image_ok(k7), f"K7 forward: outside p999 <= {P999_MAX} / flips <= {FLIP_MAX}")
        check(k7_is_k2, "K7's image differs from K2's")
        check(slot_ok(k7b), f"K7 backward: outside p999 <= {K3_P999_REL} x max|drec| / "
                            f"rel_l2 <= {K3_REL_L2}")
        # the same cotangent in K3's planar layout
        k3_args = (*args[:3], g.permute(2, 0, 1).contiguous(), ntx, nty, C)
        k7b_base = k7_turns = k7_ptxas = k7b_turns = k7b_ptxas = None
        if dev.type == "cuda":
            check(torch.equal(bits(out_k), bits(blend_rec.blend_gather_img_baseline(*args))),
                  "K7: differs from its baseline design")
            check(torch.equal(bits(drec_k), bits(blend_ct.blend_gather_ct_bwd(*k3_args))),
                  "K7 backward: differs from K3's drec")
            k7b_base = slot_err(drec_k, blend_rec.blend_gather_img_bwd_baseline(
                *args[:3], g, ntx, nty, C))
            line(f"K7: forward bit-equal to its baseline design; backward bit-equal to K3's "
                 f"drec, vs its baseline design p999_abs="
                 f"{k7b_base['p999_abs']:.3e} rel_l2={k7b_base['rel_l2']:.3e}")
            check(slot_ok(k7b_base), f"K7 backward: outside p999 <= {K3_P999_REL} x max|drec| / "
                                     f"rel_l2 <= {K3_REL_L2} of the baseline")
        k7_t = measure(lambda: blend_rec.blend_gather_img(*args), 20, dev)
        k7_plain_t = measure(lambda: blend_rec.blend_gather_img_plain(*args), 3, dev, warmup=1)
        k7b_t = measure(lambda: blend_rec.blend_gather_img_bwd(*args[:3], g, ntx, nty, C), 20, dev)
        k7b_plain_t = measure(
            lambda: blend_rec.blend_gather_img_bwd_plain(*args[:3], g, ntx, nty, C), 3, dev,
            warmup=1)
        if dev.type == "cuda":
            k7_turns = in_turns({
                "baseline": lambda: blend_rec.blend_gather_img_baseline(*args),
                "kernel": lambda: blend_rec.blend_gather_img(*args),
                "k2": lambda: blend_ct.blend_gather_ct(*args),
            }, 20, dev)
            k7_ptxas, said = rec_ptxas(report, "img", C, False)
            line(f"K7 forward in turns (k2: K2 on the same selection): "
                 f"{turns_summary(k7_turns)}; {said}")
            k7b_turns = in_turns({
                "baseline": lambda: blend_rec.blend_gather_img_bwd_baseline(
                    *args[:3], g, ntx, nty, C),
                "kernel": lambda: blend_rec.blend_gather_img_bwd(*args[:3], g, ntx, nty, C),
                "k3": lambda: blend_ct.blend_gather_ct_bwd(*k3_args),
            }, 20, dev)
            k7b_ptxas, said = rec_ptxas(report, "img", C, True)
            line(f"K7 backward in turns (k3: K3 on the same selection and cotangent): "
                 f"{turns_summary(k7b_turns)}; {said}")
    del out_p, planar, drec_k, drec_p, k3_args
    in_bytes = 4 * (scene["uniq"] * CR + n_contrib + T)
    k7_bytes = in_bytes + 4 * out_k.numel()
    k7b_bytes = in_bytes + 4 * g.numel() + 4 * T * b.idx.shape[1] * CR
    # K7 blends the champion selection: the scene's used and unused pairs
    k7_bound_ms, k7_by, _ = blend_bound(scene["work"], k7_bytes)
    k7b_bound_ms, k7b_by, _ = blend_bound(scene["work"], k7b_bytes, backward=True)
    line(f"K7 work: pixel-record pairs visited={pairs}, bytes forward={k7_bytes} "
         f"backward={k7b_bytes}; bound forward {k7_bound_ms:.5f} ms ({k7_by}), backward "
         f"{k7b_bound_ms:.5f} ms ({k7b_by})")

    # -- the ActorsHQ raster settings, rec and ct layouts -------------------------
    model = scene["model"]._replace(config=dict(scene["model"].config, **ACTORSHQ_CONFIG))
    batch, bg = scene["batch"], scene["bg"]
    weights = LossWeights(enable_vgg_from=0)
    expect = {  # launch_counts() after step i
        "rec": lambda i: (0, 0, 0, i, 0, 0, i, i, 0, 0, 0, 0),
        "ct": lambda i: (0, i, i, i, 0, 0, 0, 0, 0, 0, 0, 0),
    }
    actorshq = {}
    saved_layout = tiles.BLEND_LAYOUT
    try:
        for layout in ("rec", "ct"):
            tiles.BLEND_LAYOUT = layout  # the module constant, as the tests set it
            params = init_avatar(torch.Generator().manual_seed(0), model)
            tx = make_optimizer(params, lr_tree_from_config(params))
            step = make_train_step(model, tx, max_per_tile=K, loss_weights=weights)
            step_plain = make_train_step(model, tx, max_per_tile=K, loss_weights=weights,
                                         plain=True)
            _, terms_k, aux_k, grads_k = step.loss_and_grads(params, batch, bg, 0)
            _, terms_p, _, grads_p = step_plain.loss_and_grads(params, batch, bg, 0)
            sync(dev)
            term_err = {k: abs(float(terms_k[k].detach()) - float(v.detach()))
                        / max(abs(float(v.detach())), 1e-30) for k, v in terms_p.items()}
            leaf_err = [rel_l2(a, c) for a, c in zip(grads_k, grads_p)]
            worst = int(np.argmax(leaf_err))
            counters = {k: int(aux_k[k]) for k in ("raster_overflow", "raster_visible_overflow",
                                                   "raster_clamp_overflow")}
            line(f"ActorsHQ raster settings ({layout} layout), one step kernels vs plain: terms "
                 f"rel max {max(term_err.values()):.3e}; gradients over {len(leaf_err)} leaves "
                 f"rel_l2 max {leaf_err[worst]:.3e} (leaf {worst}), median "
                 f"{float(np.median(leaf_err)):.3e}; {counters}")
            check(all(e <= TERM_RTOL for e in term_err.values()),
                  f"ActorsHQ {layout}: a loss term off by > {TERM_RTOL}")
            check(all(bool(torch.isfinite(gk).all()) for gk in grads_k),
                  f"ActorsHQ {layout}: non-finite gradient")
            check(leaf_err[worst] <= GRAD_REL_L2,
                  f"ActorsHQ {layout}: a gradient leaf off by rel L2 > {GRAD_REL_L2}")
            del grads_k, grads_p, step_plain

            gen = torch.Generator().manual_seed(3)
            step(params, batch, gen, 0)  # warm-up
            sync(dev)
            reset_launch_counts()
            per_step, finite = [], torch.ones((), dtype=torch.bool, device=dev)
            t0 = time.perf_counter()
            for i in range(VARIANT_STEPS):
                _, m = step(params, batch, gen, i + 1)
                for v in m.values():
                    finite &= torch.isfinite(torch.as_tensor(v, device=dev)).all()
                per_step.append(launch_counts())
            sync(dev)
            step_ms = (time.perf_counter() - t0) * 1e3 / VARIANT_STEPS
            launches = dict(zip(KERNEL_NAMES, launch_counts()))
            line(f"ActorsHQ raster settings ({layout} layout): {VARIANT_STEPS} steps, "
                 f"{step_ms:.3f} ms/step; launches {launches}; last losses "
                 + ", ".join(f"{k}={float(v):.5f}" for k, v in m.items() if k.endswith("loss")))
            check(bool(finite), f"ActorsHQ {layout}: a non-finite loss term")
            check(per_step == [expect[layout](i + 1) for i in range(VARIANT_STEPS)],
                  f"ActorsHQ {layout}: launch counts after each step {per_step}")
            check(off_path_launches() == 0,
                  f"ActorsHQ {layout}: a baseline design or a K2/K3 stage cut was launched")
            prof = profile_calls(lambda: step(params, batch, gen, VARIANT_STEPS + 1), 3, dev)
            if prof is not None:
                line(f"ActorsHQ raster settings ({layout} layout), profiled ({prof['calls']} "
                     f"steps): {profile_summary(prof, step_ms)}")
            actorshq[layout] = dict(terms_rel=term_err, grad_rel_l2=leaf_err, counters=counters,
                                    step_ms=step_ms, launches=launches, profiled=prof)
            del step, tx, params
    finally:
        tiles.BLEND_LAYOUT = saved_layout

    # -- the xla backend: topk funnel + _blend_tiles, forward + backward --------
    cam = scene["camera"]
    bg6 = torch.tensor(BG6, device=dev)
    leaves = [t.clone().requires_grad_(True) for t in scene["gauss"]]
    g_img = torch.randn((C, HEIGHT, WIDTH), generator=torch.Generator(device=dev).manual_seed(8),
                        device=dev)

    def xla_call():
        for t in leaves:
            t.grad = None
        img, aux = rasterize_tiled(leaves[0], cam, bg6, cov3d=leaves[1], opacities=leaves[2],
                                   colors=leaves[3], max_per_tile=K)
        img.backward(g_img)
        return img.detach(), aux

    sync(dev)
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    img_x, aux_x = xla_call()
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base if dev.type == "cuda" else None
    means, cov3d, opac, colors = scene["gauss"]
    with torch.no_grad():
        img_c, aux_c = rasterize_tiled(means, cam, bg6, cov3d=cov3d, opacities=opac,
                                       colors=colors, max_per_tile=K, use_pallas=True,
                                       coarse="topk")
        sync(dev)
    xe = image_err(img_x, img_c)
    a_x, a_c = aux_ints(aux_x), aux_ints(aux_c)
    xla_ms = timer_ms(xla_call, 3, dev, warmup=1)
    xla_prof = profile_calls(xla_call, 2, dev)
    if xla_prof is not None:
        line(f"xla backend forward + backward, profiled ({xla_prof['calls']} calls): "
             f"{profile_summary(xla_prof, xla_ms)}")
    line(f"xla backend (topk, _blend_tiles) vs the same selection blended by K2: p999_abs="
         f"{xe['p999_abs']:.3e} frac={xe['flip_frac']:.3e} max_abs={xe['max_abs']:.3e}; aux "
         f"{a_x}; forward + backward {xla_ms:.3f} ms/call, peak memory "
         f"{'not measured' if peak is None else f'{peak / 2**30:.3f} GiB'} above the "
         f"{base / 2**30:.3f} GiB held before the call")
    check(image_ok(xe), "xla backend and K2 disagree on the topk selection")
    check(a_x == a_c, f"xla backend counters {a_x} != K2's {a_c}")
    check(all(bool(torch.isfinite(t.grad).all()) and float(t.grad.abs().max()) > 0
              for t in leaves), "xla backend: gradients non-finite or all zero")
    del leaves, img_x, img_c

    # -- the public API's backends against the oracle, small scene ---------------
    s = api_scene(dev)
    small_cam = make_camera(np.eye(3), np.zeros(3), focal2fov(60.0, API_W),
                            focal2fov(60.0, API_H), API_W, API_H, device=dev)
    kw = dict(scales=s["scales"], rotations=s["rotations"], colors=s["colors"])
    ref, _ = api.rasterize(small_cam, s["means"], s["opacities"], s["bg"],
                           settings=api.RasterSettings(backend="oracle"), **kw)
    api_err = {}
    try:
        for backend, layout in (("tiled", "ct"), ("pallas", "ct"), ("pallas", "rec")):
            tiles.BLEND_LAYOUT = layout
            img, aux = api.rasterize(
                small_cam, s["means"], s["opacities"], s["bg"],
                settings=api.RasterSettings(backend=backend, max_per_tile=128), **kw)
            sync(dev)
            api_err[f"{backend}/{layout}"] = e = image_err(img, ref)
            check(int(aux.overflow) == 0, f"api {backend}/{layout}: the small scene overflowed")
            check(image_ok(e), f"api {backend}/{layout} and the oracle disagree")
    finally:
        tiles.BLEND_LAYOUT = saved_layout
    line(f"api.rasterize vs the oracle ({API_N} Gaussians, {API_W}x{API_H}): "
         + "; ".join(f"{k} p999_abs={e['p999_abs']:.3e} max_abs={e['max_abs']:.3e}"
                     for k, e in api_err.items()))

    rec_launches = actorshq["rec"]["launches"]
    kernels = [
        {
            "name": "blend_gather_img", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/blend_rec.cu",
            "replaces": "d3ga_tpu/raster/pallas_blend_rec.py:457",
            "launches": rec_launches["blend_gather_img"], "max_abs_err": k7["max_abs"],
            "ms": k7_t["ms"], "plain_ms": k7_plain_t["ms"], "bound_ms": k7_bound_ms,
            "bound_by": k7_by, "library_ms": None,
            "baseline_ms": k7_turns and k7_turns["baseline"]["ms"],
            "designs_ms": k7_turns and {d: v["ms"] for d, v in k7_turns.items()},
        },
        {
            "name": "blend_gather_img_bwd", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/blend_rec.cu",
            "replaces": "d3ga_tpu/raster/pallas_blend_rec.py:481",
            "launches": rec_launches["blend_gather_img_bwd"], "max_abs_err": k7b["max_abs"],
            "ms": k7b_t["ms"], "plain_ms": k7b_plain_t["ms"],
            "bound_ms": k7b_bound_ms, "bound_by": k7b_by, "library_ms": None,
            "baseline_ms": k7b_turns and k7b_turns["baseline"]["ms"],
            "designs_ms": k7b_turns and {d: v["ms"] for d, v in k7b_turns.items()},
        },
    ]
    timings = {"blend_gather_img": {"kernel": k7_t, "plain": k7_plain_t},
               "blend_gather_img_bwd": {"kernel": k7b_t, "plain": k7b_plain_t}}
    for k in kernels:
        t = timings[k["name"]]
        line(f"{k['name']}: ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
             f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) library_ms={k['library_ms']} "
             f"launches_per_step={k['launches'] / VARIANT_STEPS:g}; wall per call "
             + ", ".join(f"{nm}={v['call_ms']:.4f}" for nm, v in t.items()))
    report.update(
        k7=k7, k7_is_k2=k7_is_k2, k7b=k7b, k7b_vs_baseline=k7b_base, k7_turns=k7_turns,
        k7_ptxas=k7_ptxas, k7b_turns=k7b_turns, k7b_ptxas=k7b_ptxas, k7_pairs=pairs,
        k7_bytes=k7_bytes, k7b_bytes=k7b_bytes, actorshq=actorshq, xla_vs_k2=xe, xla_aux=a_x,
        xla_ms=xla_ms,
        xla_profiled=xla_prof,
        xla_peak_bytes=peak, xla_base_bytes=base, api_vs_oracle=api_err,
        variant_timings=timings,
    )
    report["kernels"] = report.get("kernels", []) + kernels
    return kernels


def fwd_ptxas(report, source, marks):
    """ptxas' usage of a forward's designs ({name: mangled-name marker})
    from `source`'s build log, and its summary line."""
    logs = report.get("build_logs", {}).get(source)
    usage = {d: ptxas_usage(logs, m) for d, m in marks.items()}
    return usage, "; ".join(f"{d} {u.get('registers')}, {u.get('smem')}, {u.get('spill_stores')}"
                            for d, us in usage.items() for u in us.values())


def k9_forward_designs(dev, report, line, vals, rects, K, C):
    """K9's forward at frame 0 on the card: bit-equal across launches, to
    its baseline design and its other designs; K8 on the same tiles'
    inputs (its coefficients made apart: image tolerances) against it; the
    baseline, the kernel and its batch sizes in turns, its stage cuts in
    turns, ptxas' registers. Returns the results (turns None off the
    card)."""
    res = dict(turns=None, stages=None, ptxas=None)
    tiles_k9, counts_k9 = fused.select_blend(vals, rects, K, C)
    co, col, op, *_ = fused._tile_inputs(vals, rects, K, C)
    k8_tiles = blend.blend_tiles_coeffs(co.contiguous(), col.contiguous(), op.contiguous())
    res["k8_vs_k9"] = image_err(k8_tiles.reshape(tiles_k9.shape), tiles_k9)
    line(f"K8 on frame 0's K9 tile inputs vs K9's tiles: p999_abs="
         f"{res['k8_vs_k9']['p999_abs']:.3e} frac={res['k8_vs_k9']['flip_frac']:.3e} "
         f"max_abs={res['k8_vs_k9']['max_abs']:.3e}")
    check(image_ok(res["k8_vs_k9"]), "K8 on K9's tile inputs: outside the image tolerances of K9")
    del co, col, op, k8_tiles
    if dev.type != "cuda":
        return res
    check(torch.equal(bits(tiles_k9), bits(fused.select_blend(vals, rects, K, C)[0])),
          "K9 forward: two launches differ")
    for d, (o, c) in k9_fwd_designs(vals, rects, K, C).items():
        check(torch.equal(bits(o), bits(tiles_k9)) and torch.equal(c, counts_k9),
              f"K9 forward: {d} differs from the kernel at full width")
    whole = len(fused.FWD_STAGES) - 1
    for st in range(whole):
        check(bool(torch.isfinite(fused.select_blend_stage(vals, rects, K, C, st)[0]).all()),
              f"K9 forward stage {st}: non-finite output")
    line(f"K9 forward at full width (NB={vals.shape[0]}, kb={vals.shape[1]}, K={K}, C={C}): "
         "bit-equal across two launches, to the baseline design and to the kernel without the "
         "band cull" + (", R = 1, 2, 4 bit-equal to the kernel" if C == fused.STAGE_C else ""))
    del tiles_k9, counts_k9
    if C != fused.STAGE_C:
        return res
    res["turns"] = in_turns({
        "baseline": lambda: fused.select_blend_baseline(vals, rects, K, C),
        "kernel": lambda: fused.select_blend(vals, rects, K, C),
        **{d: (lambda d=d: fused.select_blend_stage(vals, rects, K, C, whole, design=d))
           for d in ("kernel_r1", "kernel_r2", "kernel_r4")},
    }, 20, dev)
    res["stages"] = in_turns({
        f"stage{st}": (lambda st=st: fused.select_blend_stage(vals, rects, K, C, st))
        for st in range(len(fused.FWD_STAGES))}, 20, dev)
    line(f"K9 forward in turns (kernel: R = {fused.FWD_BATCH} slots a batch; kernel_rN: R = N): "
         f"{turns_summary(res['turns'])}")
    ms = [res["stages"][f"stage{st}"]["ms"] for st in range(len(fused.FWD_STAGES))]
    line("K9 forward stages (ms a call; delta): " + ", ".join(
        f"{st} {nm} {m:.5f} ({m - (ms[st - 1] if st else 0.0):+.5f})"
        for st, (nm, m) in enumerate(zip(fused.FWD_STAGES, ms))))
    # mangled template arguments: <C, P, R, STAGE> and, baseline, <C, STAGE>
    res["ptxas"], summary = fwd_ptxas(report, "fused", {
        "kernel": f"fused_fwd_kernelILi{C}ELi2ELi{fused.FWD_BATCH}ELi2E",
        **{f"kernel_r{r}": f"fused_fwd_kernelILi{C}ELi2ELi{r}ELi2E" for r in (1, 2, 4)},
        "baseline": f"fused_kernel_v1ILi{C}ELi3E"})
    line(f"K9 forward ptxas at C={C} (registers, static smem bytes, spill stores): {summary}")
    return res


def k8_forward_designs(dev, report, line, bench_args, frame_args):
    """K8's forward on the card at the stage bench's shapes (bench_args,
    C 3) and on frame 0's K9 tile inputs (frame_args, C 6): bit-equal
    across launches, to its baseline design and to its other designs; the
    baseline and the kernel in turns at the stage bench's shapes, and at
    frame 0's with the batch sizes, the stage cuts in turns there, ptxas'
    registers at both C. Returns the results (None off the card)."""
    if dev.type != "cuda":
        return None
    res = {}
    whole = len(blend.FWD_STAGES) - 1
    for where, args in (("stage bench", bench_args), ("frame 0", frame_args)):
        out = blend.blend_tiles_coeffs(*args)
        check(torch.equal(bits(out), bits(blend.blend_tiles_coeffs(*args))),
              f"K8 forward ({where}): two launches differ")
        for d, o in k8_fwd_designs(*args).items():
            check(torch.equal(bits(o), bits(out)), f"K8 forward ({where}): {d} differs from the "
                                                   "kernel")
        del out
        designs = {"baseline": lambda args=args: blend.blend_tiles_coeffs_baseline(*args),
                   "kernel": lambda args=args: blend.blend_tiles_coeffs(*args)}
        if args[1].shape[-1] == blend.STAGE_C:
            designs.update({d: (lambda d=d, args=args: blend.blend_tiles_coeffs_stage(
                *args, whole, design=d)) for d in ("kernel_r1", "kernel_r2", "kernel_r4")})
        res[where] = in_turns(designs, 20, dev)
        line(f"K8 forward in turns ({where}: T={args[0].shape[0]}, K={args[0].shape[1]}, "
             f"C={args[1].shape[-1]}): {turns_summary(res[where])}")
    co, col, op = frame_args
    for st in range(whole):
        check(bool(torch.isfinite(blend.blend_tiles_coeffs_stage(co, col, op, st)).all()),
              f"K8 forward stage {st}: non-finite output")
    res["stages"] = in_turns({
        f"stage{st}": (lambda st=st: blend.blend_tiles_coeffs_stage(co, col, op, st))
        for st in range(len(blend.FWD_STAGES))}, 20, dev)
    ms = [res["stages"][f"stage{st}"]["ms"] for st in range(len(blend.FWD_STAGES))]
    line("K8 forward stages at frame 0 (ms a call; delta): " + ", ".join(
        f"{st} {nm} {m:.5f} ({m - (ms[st - 1] if st else 0.0):+.5f})"
        for st, (nm, m) in enumerate(zip(blend.FWD_STAGES, ms))))
    marks = {}
    for C in sorted({bench_args[1].shape[-1], col.shape[-1]}):
        marks[f"kernel C{C}"] = f"blend_coeffs_kernelILi{C}ELi2ELi{blend.FWD_BATCH}ELi2E"
        if C == blend.STAGE_C:
            marks.update({f"kernel_r{r} C{C}": f"blend_coeffs_kernelILi{C}ELi2ELi{r}ELi2E"
                          for r in (1, 2, 4)})
        marks[f"baseline C{C}"] = f"blend_coeffs_v1_kernelILi{C}E"
    res["ptxas"], summary = fwd_ptxas(report, "blend_coeffs", marks)
    line(f"K8 forward ptxas (registers, static smem bytes, spill stores): {summary}")
    return res


def k8_backward_designs(dev, report, line, bench_args, frame_args):
    """K8's backward at the stage bench's shapes (bench_args = (coeffs,
    colors, opacs, g), C 3) and on frame 0's K9 tile inputs (frame_args,
    C 6): `k8_bwd_holds` at both; on the card the baseline design and the
    kernel in turns at both, the stage cuts in turns at frame 0 (device ms
    of blend_coeffs_bwd_kernel alone), ptxas' registers at both C. Returns
    the results (turns None off the card)."""
    res = dict(holds={}, turns=None, stages=None, ptxas=None)
    wheres = {"stage bench": bench_args, "frame 0": frame_args}
    for where, args in wheres.items():
        h = res["holds"][where] = k8_bwd_holds(f"K8 backward ({where})", args, dev)
        line(f"K8 backward ({where}: T={args[0].shape[0]}, K={args[0].shape[1]}, "
             f"C={args[1].shape[-1]}) vs plain: " + ", ".join(
                 f"d{n} rel_l2={e['rel_l2']:.3e} p999_abs={e['p999_abs']:.3e} (max {e['scale']:.3e})"
                 for n, e in h["plain"].items())
             + ("; vs the baseline design rel_l2 " + ", ".join(
                 f"d{n}={e:.3e}" for n, e in h["baseline"].items()) if "baseline" in h else ""))
    if dev.type != "cuda":
        return res
    res["turns"] = {}
    for where, args in wheres.items():
        res["turns"][where] = in_turns({
            "baseline": lambda args=args: blend.blend_tiles_coeffs_bwd_baseline(*args),
            "kernel": lambda args=args: blend.blend_tiles_coeffs_bwd(*args)}, 20, dev)
        line(f"K8 backward in turns ({where}): {turns_summary(res['turns'][where])}")
    whole = len(blend.BWD_STAGES) - 1
    for st in range(whole):
        check(all(bool(torch.isfinite(o).all())
                  for o in blend.blend_tiles_coeffs_bwd_stage(*frame_args, st)),
              f"K8 backward stage {st}: non-finite output")
    res["stages"] = in_turns({
        f"stage{st}": (lambda st=st: blend.blend_tiles_coeffs_bwd_stage(*frame_args, st))
        for st in range(len(blend.BWD_STAGES))}, 20, dev, kernel="blend_coeffs_bwd_kernel")
    ms = [res["stages"][f"stage{st}"]["ms"] for st in range(len(blend.BWD_STAGES))]
    line("K8 backward stages at frame 0 (device ms a call of blend_coeffs_bwd_kernel; delta): "
         + ", ".join(f"{st} {nm} {m:.5f} ({m - (ms[st - 1] if st else 0.0):+.5f})"
                     for st, (nm, m) in enumerate(zip(blend.BWD_STAGES, ms))))
    marks = {}
    for C in sorted({bench_args[1].shape[-1], frame_args[1].shape[-1]}):
        # mangled template arguments: <C, STAGE> and, baseline, <C>
        marks[f"kernel C{C}"] = f"blend_coeffs_bwd_kernelILi{C}ELi4E"
        marks[f"baseline C{C}"] = f"blend_coeffs_bwd_v1_kernelILi{C}E"
    res["ptxas"], summary = fwd_ptxas(report, "blend_coeffs", marks)
    line(f"K8 backward ptxas (registers, static smem bytes, spill stores): {summary}")
    return res


ROUTE_ITERS = 40  # calls a turn of the route's designs (queued behind a spin)


def route_phase(dev, report, line, vals, rects, g, K, C):
    """K9's route at frame 0 (48 blocks x 4,096 lanes, K 256, C 6), on
    kernel 1's scratch (off the card a stand-in: the selection's ids and
    zero rows): `route_holds` and, on the card, the backward's d(vals)
    the route's; what it moves (`route_work`) and its bound; the plain
    route's ms (`route_plain`), the plain path's one `scatter_add_` (the
    library call) and every design of `fused.ROUTE_DESIGNS` in turns, by
    `probes.queued_ms`; ptxas' registers and spills."""
    NB, kb = rects.shape
    on_card = dev.type == "cuda"
    if on_card:
        drec, sel, live = fused.select_blend_bwd_tiles(vals, rects, g, K, C)
    else:
        lanes, counts = fused._select(rects, K)
        live = torch.clamp(counts, max=K).reshape(-1).int()
        sel = torch.where(lanes < kb, lanes, -7).reshape(-1, lanes.shape[-1]).int()
        sel = torch.nn.functional.pad(sel, (0, K - sel.shape[1]), value=-7).contiguous()
        drec = torch.zeros((NB * fused.TB, K, 6 + C), device=dev)
    ref = route_holds("route at frame 0", rects, drec, sel, live, K, C)
    work = route_work(rects, live, C)
    times = {"bytes": work["bytes"] / HBM_BYTES_PER_S,
             "operations": work["live_slots"] * (6 + C) / FP32_OPS_PER_S}
    by = max(times, key=times.get)
    out = {"work": work, "bound_ms": times[by] * 1e3, "bound_by": by,
           "bound_s": times, "max_abs_err": 0.0, "library_ms": None, "turns": None,
           "ptxas": None}
    lanes = fused.scratch_lanes(sel, live, kb)
    d4 = drec.reshape(NB, fused.TB, K, 6 + C)
    out["plain_ms"] = probes.time_ms(lambda: fused.route_plain(d4, lanes, kb), 3, dev, warmup=1)
    if on_card:
        dv = fused.route(rects, drec, sel, live, K, C)
        check(torch.equal(bits(fused.select_blend_bwd(vals, rects, g, K, C)), bits(dv)),
              "route at frame 0: the backward's d(vals) is not the route's")
        out["max_abs_err"] = float((dv.cpu() - ref).abs().max())
        # the plain path's one library call: scatter_add_ of the masked rows
        hit = lanes < kb
        src = torch.where(hit[..., None], d4, 0.0).reshape(NB, -1, 6 + C)
        idx = torch.where(hit, lanes, kb).reshape(NB, -1, 1).expand(-1, -1, 6 + C)
        dst = src.new_zeros((NB, kb + 1, 6 + C))
        out["library_ms"] = probes.queued_ms(lambda: dst.scatter_add_(1, idx, src), ROUTE_ITERS,
                                             dev)
        out["turns"] = in_turns({
            d: (lambda d=d: fused.route(rects, drec, sel, live, K, C, design=d))
            for d in fused.ROUTE_DESIGNS}, ROUTE_ITERS, dev, profiler=False)
        logs = report.get("build_logs", {}).get("fused")
        out["ptxas"] = {"baseline": ptxas_usage(logs, f"fused_route_kernel_v1ILi{C}EE"),
                        **{f"kernel_g{G}": ptxas_usage(logs, f"fused_route_kernelILi{C}ELi{G}EE")
                           for G in (2, 4, 8, 16, 32)}}
        del dv, src, idx, dst
    line(f"K9 route at frame 0 (NB={NB}, kb={kb}, K={K}, C={C}): lanes by rect area (tiles) "
         f"{work['area_hist']}, {work['tiles_visited']} tiles visited, {work['live_slots']} live "
         f"slots; a warp's largest rect summed over warps {work['v1_warp_max_tiles']} (one "
         f"thread a lane), rounds by group size {work['rounds_by_group']}; bound "
         f"{out['bound_ms']:.5f} ms ({by}; {work['bytes']} bytes); plain "
         f"{out['plain_ms']:.4f} ms" + ("" if not on_card else
         f", library (scatter_add_) {out['library_ms']}, max abs vs plain "
         f"{out['max_abs_err']:.3e}; in turns (ms a call, queued): "
         f"{turns_summary(out['turns'])}; ptxas (registers, spill stores): " + "; ".join(
             f"{d} {u.get('registers')}, {u.get('spill_stores')}"
             for d, us in out["ptxas"].items() for u in us.values())))
    del drec, sel, live, lanes, d4
    return out


def fused_phase(dev, report, scene):
    """K9 (the fused select + blend) forward and backward against its plain
    versions through both input layouts, on frame 0's Gaussians at the
    default block cap; `rasterize_tiled_fused` against `rasterize_tiled`'s
    topk funnel; the training step with `raster_backend: fused`, one
    step's gradients kernels vs plain, then 5 steps with K9 and its
    backward launched once a step; K8's forward and backward on their edge
    inputs, at the stage bench's shapes and on frame 0's K9 tile inputs
    (against plain and their baseline designs, timed in turns), then the
    stage bench, its JSON in run_out/bench_stages.json. Returns the K8
    and K9 entries."""
    line = logger(report)
    means, cov3d, opac, colors = scene["gauss"]
    cam, C = scene["camera"], scene["C"]
    ntx, nty = -(-WIDTH // 16), -(-HEIGHT // 16)

    # -- K9 against its plain version, both layouts ------------------------
    with torch.no_grad():
        proj = project_gaussians(means, cam, cov3d=cov3d, opacities=opac, colors=colors)
        vals, rects, _, _, _ = tiles.fused_candidates(proj, ntx, nty, BLOCK_CAP)
        NB, kb = rects.shape
        NC = kb // fused.CHUNK
        layouts = {
            1: (vals.reshape(NB, NC, fused.CHUNK, fused.NCH).permute(0, 1, 3, 2).contiguous(),
                rects.reshape(NB, NC, fused.CHUNK).contiguous()),
            2: (vals.permute(0, 2, 1).contiguous(), rects[:, None, :].contiguous()),
        }
        ref, ref_counts, pairs = fused.select_blend_plain(vals, rects, K, C, count_pairs=True)
        g = torch.randn(ref.shape, generator=torch.Generator(device=dev).manual_seed(9),
                        device=dev)
        dref = fused.select_blend_bwd_plain(vals, rects, g, K, C)
        # the candidates some tile selects: all the kernels must read of vals
        lanes, _ = fused._select(rects, K)
        n_sel = int(torch.zeros(NB, kb + 1, dtype=torch.bool, device=dev)
                    .scatter_(1, lanes.reshape(NB, -1), True)[:, :kb].sum())
    k9_edges = check_k9_edges(dev, line)
    route_edges = check_route_edges(dev, line)
    k9f_edges = check_k9_fwd_edges(dev, line)
    k8_edges = check_k8_edges(dev, line)
    k8b_edges = check_k8_bwd_edges(dev, line)
    k9, k9b = {}, {}
    for variant, (v, r) in layouts.items():
        fn = fused.fused_select_blend if variant == 1 else fused.fused_select_blend2
        v = v.clone().requires_grad_(True)
        out, counts = fn(v, r, K, C)
        out.backward(g)  # the one Function's backward, back to this layout
        out = out.detach()
        dv = fused._records(v.grad)
        sync(dev)
        check(bool(torch.isfinite(out).all() and torch.isfinite(dv).all()),
              f"K9 v{variant}: non-finite output")
        check(torch.equal(counts, ref_counts), f"K9 v{variant}: counts differ from plain")
        k9[variant] = image_err(out, ref)
        k9b[variant] = slot_err(dv, dref)
        line(f"K9 v{variant} layout vs plain (NB={NB}, kb={kb}, K={K}, C={C}): counts equal; "
             f"forward p999_abs={k9[variant]['p999_abs']:.3e} "
             f"frac={k9[variant]['flip_frac']:.3e} max_abs={k9[variant]['max_abs']:.3e}; "
             f"backward rel_l2={k9b[variant]['rel_l2']:.3e} "
             f"p999_abs={k9b[variant]['p999_abs']:.3e} (max |dvals| "
             f"{k9b[variant]['scale']:.3e})")
        check(image_ok(k9[variant]),
              f"K9 v{variant} forward: outside p999 <= {P999_MAX} / flips <= {FLIP_MAX}")
        check(k9b[variant]["rel_l2"] <= K3_REL_L2,
              f"K9 v{variant} backward: d(vals) rel L2 > {K3_REL_L2}")
        del v, out, dv
    bwd_args = (vals, rects, g, K, C)
    k9b_base = k9b_px = k9b_turns = k9b_split = k9b_stages = k9b_ptxas = None
    with torch.no_grad():
        work9 = fused_work(vals, rects, K, C)
        if dev.type == "cuda":
            dk = fused.select_blend_bwd(*bwd_args)
            check(torch.equal(bits(dk), bits(fused.select_blend_bwd(*bwd_args))),
                  "K9 backward: two launches differ")
            no_cull = fused.select_blend_bwd_stage(*bwd_args, 4, design="kernel_no_cull")
            check(torch.equal(bits(dk), bits(no_cull)), "K9 backward: the band cull changes the bits")
            k9b_base = slot_err(dk, fused.select_blend_bwd_baseline(*bwd_args))
            line(f"K9 backward vs its baseline design at full width: max_abs="
                 f"{k9b_base['max_abs']:.3e} p999_abs={k9b_base['p999_abs']:.3e} "
                 f"rel_l2={k9b_base['rel_l2']:.3e}; two launches bit-equal, and equal to the "
                 "kernel without the band cull")
            check(slot_ok(k9b_base), f"K9 backward vs the baseline: outside p999 <= "
                                     f"{K3_P999_REL} x max|dvals| / rel_l2 <= {K3_REL_L2}")
        if dev.type == "cuda" and C == fused.STAGE_C:
            for st in range(len(fused.BWD_STAGES)):
                out = fused.select_blend_bwd_stage(*bwd_args, st)
                check(bool(torch.isfinite(out).all()), f"K9 backward stage {st}: non-finite")
            check(torch.equal(bits(out), bits(dk)), "K9 backward stage 4: not the kernel's output")
            # the walk at 1 and 4 pixels a thread: the same sums in another order
            k9b_px = {d: slot_err(fused.select_blend_bwd_stage(*bwd_args, 4, design=d), dref)
                      for d in ("kernel_p1", "kernel_p4")}
            for d, e in k9b_px.items():
                check(slot_ok(e), f"K9 backward {d} vs plain: outside p999 <= {K3_P999_REL} x "
                                  f"max|dvals| / rel_l2 <= {K3_REL_L2}")
            del dk, out, no_cull
            designs = {
                "baseline": lambda: fused.select_blend_bwd_baseline(*bwd_args),
                "kernel": lambda: fused.select_blend_bwd(*bwd_args),
                **{d: (lambda d=d: fused.select_blend_bwd_stage(*bwd_args, 4, design=d))
                   for d in ("kernel_p1", "kernel_p4")},
            }
            k9b_turns = in_turns(designs, 20, dev)
            k9b_split = fused_bisect.backward_split(*bwd_args, iters=20)
            k9b_stages = in_turns({
                f"stage{st}": (lambda st=st: fused.select_blend_bwd_stage(*bwd_args, st))
                for st in range(len(fused.BWD_STAGES))}, 20, dev, kernel="fused_bwd_kernel")
            line(f"K9 backward in turns (NB={NB}, kb={kb}, K={K}, C={C}, frame 0; both kernels "
                 f"a call; kernel_p1/p4: the walk at 1/4 pixels a thread): "
                 f"{turns_summary(k9b_turns)}; p1/p4 vs plain rel_l2 "
                 + ", ".join(f"{e['rel_l2']:.3e}" for e in k9b_px.values()))
            line("K9 backward and its kernels alone (device ms a call, queued behind a "
                 "spin): " + ", ".join(f"{k} {v}" for k, v in k9b_split.items()))
            ms = [k9b_stages[f"stage{st}"]["ms"] for st in range(len(fused.BWD_STAGES))]
            line("K9 backward per-tile kernel stages (device ms a call of fused_bwd_kernel; "
                 "delta): " + ", ".join(
                     f"{st} {nm} {m:.5f} ({m - (ms[st - 1] if st else 0.0):+.5f})"
                     for st, (nm, m) in enumerate(zip(fused.BWD_STAGES, ms))))
            logs = report.get("build_logs", {}).get("fused")
            # mangled template arguments: <C, P, STAGE> and, baseline, <C>
            k9b_ptxas = {d: ptxas_usage(logs, m) for d, m in (
                ("kernel", f"fused_bwd_kernelILi{C}ELi2ELi4E"),
                ("kernel_p1", f"fused_bwd_kernelILi{C}ELi1ELi4E"),
                ("kernel_p4", f"fused_bwd_kernelILi{C}ELi4ELi4E"),
                ("baseline", f"fused_bwd_kernel_v1ILi{C}E"))}
            line(f"K9 backward ptxas at C={C} (registers, static smem bytes, spill stores): "
                 + "; ".join(f"{d} {u.get('registers')}, {u.get('smem')}, {u.get('spill_stores')}"
                             for d, us in k9b_ptxas.items() for u in us.values()))
        k9r = route_phase(dev, report, line, vals, rects, g, K, C)
        k9f = k9_forward_designs(dev, report, line, vals, rects, K, C)
        k9_t = measure(lambda: fused.select_blend(vals, rects, K, C), 20, dev)
        k9_plain_t = measure(lambda: fused.select_blend_plain(vals, rects, K, C), 3, dev,
                             warmup=1)
        k9b_t = measure(lambda: fused.select_blend_bwd(*bwd_args), 20, dev)
        k9b_plain_t = measure(lambda: fused.select_blend_bwd_plain(*bwd_args), 3, dev, warmup=1)
    # bytes: the used channels (6 + C) of the selected candidates, every
    # rect; the tiles and counts out. Backward: the cotangent of the tiles
    # that hold a slot in, all of d(vals) out. Operations: the walk's used
    # and unused pairs apart (`fused_work`)
    in_bytes = 4 * (n_sel * (6 + C) + rects.numel())
    live_tiles = int((ref_counts > 0).sum())
    used9, unused9 = work9["used"], work9["visited"] - work9["used"]
    k9_bound = coeff_bound(in_bytes + 4 * (ref.numel() + ref_counts.numel()), used9, unused9,
                           coeff_fwd_ops(C), 1)
    k9b_bound = coeff_bound(in_bytes + 4 * (live_tiles * fused.NPIX * (C + 1) + vals.numel()),
                            used9, unused9, coeff_bwd_ops(C), COEFF_BWD_SFU_PER_PAIR)
    line(f"K9 work: NB={NB} blocks, kb={kb}, {n_sel} candidates selected, {live_tiles} tiles "
         f"with a slot, pixel-slot pairs visited={work9['visited']} (count_pairs {pairs}), "
         f"used={used9}; (slot, warp) pairs the backward's cull takes "
         f"{work9['warp_slots_taken']} of {work9['warp_slots']}; in-image tiles with counts "
         f"over K={int((ref_counts > K).sum())}; bounds (ms): forward bytes "
         f"{k9_bound[2]['bytes'] * 1e3:.5f} operations {k9_bound[2]['operations'] * 1e3:.5f}, "
         f"backward bytes {k9b_bound[2]['bytes'] * 1e3:.5f} operations "
         f"{k9b_bound[2]['operations'] * 1e3:.5f}")
    del ref, dref, g, layouts, lanes, bwd_args

    # -- rasterize_tiled_fused against rasterize_tiled's topk funnel --------
    bg = torch.tensor(BG6, device=dev)
    kw = dict(cov3d=cov3d, opacities=opac, colors=colors, max_per_tile=K)
    with torch.no_grad():
        img_f, aux_f = tiles.rasterize_tiled_fused(means, cam, bg, block_cap=BLOCK_CAP, **kw)
        img_t, aux_t = rasterize_tiled(means, cam, bg, coarse="topk", block_cap=BLOCK_CAP,
                                       super_factor=2, use_pallas=True, **kw)
        sync(dev)
    fe = image_err(img_f, img_t)
    a_f, a_t = aux_ints(aux_f), aux_ints(aux_t)
    line(f"rasterize_tiled_fused vs rasterize_tiled (topk, block cap {BLOCK_CAP}, K2) on frame "
         f"0: p999_abs={fe['p999_abs']:.3e} frac={fe['flip_frac']:.3e} "
         f"max_abs={fe['max_abs']:.3e}; aux fused {a_f} topk {a_t}")
    check(tuple(img_f.shape) == (C, HEIGHT, WIDTH), f"fused image shape {tuple(img_f.shape)}")
    check(image_ok(fe), "rasterize_tiled_fused and rasterize_tiled disagree")
    for f in ("overflow", "max_per_tile", "n_contrib"):
        check(a_f[f] == a_t[f], f"fused RasterAux.{f} {a_f[f]} != topk path's {a_t[f]}")
    del img_f, img_t

    # -- the training step, raster_backend: fused ---------------------------
    model = scene["model"]._replace(config=dict(scene["model"].config, **FUSED_CONFIG))
    batch, bgc = scene["batch"], scene["bg"]
    weights = LossWeights(enable_vgg_from=0)
    params = init_avatar(torch.Generator().manual_seed(0), model)
    tx = make_optimizer(params, lr_tree_from_config(params))
    step = make_train_step(model, tx, max_per_tile=K, loss_weights=weights)
    step_plain = make_train_step(model, tx, max_per_tile=K, loss_weights=weights, plain=True)
    _, terms_k, aux_k, grads_k = step.loss_and_grads(params, batch, bgc, 0)
    _, terms_p, _, grads_p = step_plain.loss_and_grads(params, batch, bgc, 0)
    sync(dev)
    term_err = {k: abs(float(terms_k[k].detach()) - float(v.detach()))
                / max(abs(float(v.detach())), 1e-30) for k, v in terms_p.items()}
    leaf_err = [rel_l2(a, c) for a, c in zip(grads_k, grads_p)]
    worst = int(np.argmax(leaf_err))
    line(f"fused backend, one step kernels vs plain: terms rel max {max(term_err.values()):.3e}; "
         f"gradients over {len(leaf_err)} leaves rel_l2 max {leaf_err[worst]:.3e} (leaf {worst}), "
         f"median {float(np.median(leaf_err)):.3e}; overflow {int(aux_k['raster_overflow'])}")
    check(all(e <= TERM_RTOL for e in term_err.values()), f"fused step: a loss term off by > {TERM_RTOL}")
    check(all(bool(torch.isfinite(gk).all()) for gk in grads_k), "fused step: non-finite gradient")
    check(leaf_err[worst] <= GRAD_REL_L2, f"fused step: a gradient leaf off by rel L2 > {GRAD_REL_L2}")
    del grads_k, grads_p, step_plain

    gen = torch.Generator().manual_seed(3)
    step(params, batch, gen, 0)  # warm-up
    sync(dev)
    reset_launch_counts()
    per_step, finite = [], torch.ones((), dtype=torch.bool, device=dev)
    t0 = time.perf_counter()
    for i in range(FUSED_STEPS):
        _, m = step(params, batch, gen, i + 1)
        for v in m.values():
            finite &= torch.isfinite(torch.as_tensor(v, device=dev)).all()
        per_step.append(launch_counts())
    sync(dev)
    step_ms = (time.perf_counter() - t0) * 1e3 / FUSED_STEPS
    k9_launches = {"fused_select_blend": fused.launches,
                   "fused_select_blend_bwd": fused.bwd_launches,
                   "fused_route": fused.route_launches}
    line(f"fused backend: {FUSED_STEPS} steps, {step_ms:.3f} ms/step; launches {k9_launches}; "
         "last losses " + ", ".join(f"{k}={float(v):.5f}" for k, v in m.items()
                                    if k.endswith("loss")))
    check(bool(finite), "fused step: a non-finite loss term")
    expect = [(0,) * 10 + (i + 1, i + 1) for i in range(FUSED_STEPS)]
    check(per_step == expect, f"fused backend: launch counts after each step {per_step}: not K9 "
                              "and its backward once a step, and no other kernel")
    check(fused.route_launches == FUSED_STEPS,
          f"fused backend: the route launched {fused.route_launches} times in {FUSED_STEPS} steps")
    check(off_path_launches() == 0,
          "fused backend: a baseline design or a K2/K3 stage cut was launched")
    fused_prof = profile_calls(lambda: step(params, batch, gen, FUSED_STEPS + 1), 3, dev)
    if fused_prof is not None:
        line(f"fused backend, profiled ({fused_prof['calls']} steps): "
             f"{profile_summary(fused_prof, step_ms)}")
    del step, tx, params

    # -- K8 against its plain version at the stage bench's shapes ------------
    inp = bench_stages.prepare(dev, **STAGE_SCENE)
    co, col, op = inp["coeffs"], inp["color_t"], inp["opac_in"]
    T8, K8K = co.shape[:2]
    with torch.no_grad():
        out8 = blend.blend_tiles_coeffs(co, col, op)
        ref8, pairs8 = blend.blend_tiles_coeffs_plain(co, col, op, count_pairs=True)
        g8 = torch.randn(out8.shape, generator=torch.Generator(device=dev).manual_seed(10),
                         device=dev)
        sync(dev)
        check(bool(torch.isfinite(out8).all()), "K8: non-finite output")
        k8 = image_err(out8, ref8)
        line(f"K8 blend_tiles_coeffs vs plain (T={T8}, K={K8K}, C={col.shape[-1]}): forward "
             f"p999_abs={k8['p999_abs']:.3e} frac={k8['flip_frac']:.3e} "
             f"max_abs={k8['max_abs']:.3e}")
        check(image_ok(k8), f"K8 forward: outside p999 <= {P999_MAX} / flips <= {FLIP_MAX}")
        f_co, f_col, f_op, *_ = fused._tile_inputs(vals, rects, K, C)
        f_args = (f_co.contiguous(), f_col.contiguous(), f_op.contiguous())
        k8f = k8_forward_designs(dev, report, line, (co, col, op), f_args)
        k8bf = k8_backward_designs(dev, report, line, (co, col, op, g8),
                                   (*f_args, k8_cotangent(f_args[0], C, 11)))
        k8b = k8bf["holds"]["stage bench"]["plain"]
        del f_co, f_col, f_op, f_args
        k8_t = measure(lambda: blend.blend_tiles_coeffs(co, col, op), 20, dev)
        k8_plain_t = measure(lambda: blend.blend_tiles_coeffs_plain(co, col, op), 3, dev, warmup=1)
        # on the card K8's backward is timed once, in turns with its `_v1`
        k8b_t = (None if k8bf["turns"] else
                 measure(lambda: blend.blend_tiles_coeffs_bwd(co, col, op, g8), 20, dev))
        k8b_plain_t = measure(lambda: blend.blend_tiles_coeffs_bwd_plain(co, col, op, g8), 3, dev,
                              warmup=1)
    C8 = col.shape[-1]
    k8_in = 4 * T8 * K8K * (6 + 1 + C8)  # the six used coefficients, opacity, colours
    with torch.no_grad():
        work8 = coeff_work(co, op)
    used8, unused8 = work8["used"], work8["visited"] - work8["used"]
    k8_bound = coeff_bound(k8_in + 4 * out8.numel(), used8, unused8, coeff_fwd_ops(C8), 1)
    k8b_bound = coeff_bound(k8_in + 4 * g8.numel() + 4 * T8 * K8K * (8 + C8 + 1), used8, unused8,
                            coeff_bwd_ops(C8), COEFF_BWD_SFU_PER_PAIR)
    line(f"K8 work: pixel-slot pairs visited={work8['visited']} (count_pairs {pairs8}), "
         f"used={used8}, on {inp['n_contrib']} live slots; (slot, warp) pairs the forward's "
         f"cull takes {work8['warp_slots_taken']} of {work8['warp_slots']}; bounds (ms): "
         "forward bytes "
         f"{k8_bound[2]['bytes'] * 1e3:.5f} operations {k8_bound[2]['operations'] * 1e3:.5f}, "
         f"backward bytes {k8b_bound[2]['bytes'] * 1e3:.5f} operations "
         f"{k8b_bound[2]['operations'] * 1e3:.5f}")
    del out8, ref8, g8

    # -- the stage bench: K8's main path -------------------------------------
    sync(dev)
    reset_launch_counts()
    stage_ms = bench_stages.run(inp, STAGE_ITERS)
    sync(dev)
    k8_launches = {"blend_tiles_coeffs": blend.launches,
                   "blend_tiles_coeffs_bwd": blend.bwd_launches}
    bench = {"card": report.get("card"), "device": torch.cuda.get_device_name(dev)
             if dev.type == "cuda" else "cpu", "n_gaussians": STAGE_SCENE["n"],
             "width": STAGE_SCENE["width"], "height": STAGE_SCENE["height"],
             "k": STAGE_SCENE["k"], "tiles": inp["ntx"] * inp["nty"],
             "n_contrib": inp["n_contrib"], "iters": STAGE_ITERS, "ms": stage_ms}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "bench_stages.json"), "w") as f:
        json.dump(bench, f, indent=1)
    line("stage bench (bench.py's scene, ms a call): "
         + ", ".join(f"{k}={v:.4f}" for k, v in stage_ms.items()) + f"; launches {k8_launches}")
    check(all(np.isfinite(v) for v in stage_ms.values()), "stage bench: a time is not finite")
    check(k8_launches["blend_tiles_coeffs"] > 0 and k8_launches["blend_tiles_coeffs_bwd"] > 0,
          f"stage bench: K8 not launched {k8_launches}")
    check(off_path_launches() == 0, "stage bench: a baseline design or a stage cut was launched")
    del inp

    kernels = [
        {
            "name": "blend_tiles_coeffs", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/blend_coeffs.cu",
            "replaces": "d3ga_tpu/raster/pallas_blend.py:238",
            "launches": k8_launches["blend_tiles_coeffs"], "max_abs_err": k8["max_abs"],
            "ms": k8f["stage bench"]["kernel"]["ms"] if k8f else k8_t["ms"],
            "plain_ms": k8_plain_t["ms"], "bound_ms": k8_bound[0],
            "bound_by": k8_bound[1], "library_ms": None,
            "baseline_ms": k8f and k8f["stage bench"]["baseline"]["ms"],
            "designs_ms": k8f and {d: v["ms"] for d, v in k8f["frame 0"].items()},
            "stages_ms": k8f and [k8f["stages"][f"stage{st}"]["ms"]
                                  for st in range(len(blend.FWD_STAGES))],
        },
        {
            "name": "blend_tiles_coeffs_bwd", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/blend_coeffs.cu",
            "replaces": "d3ga_tpu/raster/pallas_blend.py:264",
            "launches": k8_launches["blend_tiles_coeffs_bwd"],
            "max_abs_err": max(e["max_abs"] for e in k8b.values()),
            "ms": k8bf["turns"]["stage bench"]["kernel"]["ms"] if k8bf["turns"] else k8b_t["ms"],
            "plain_ms": k8b_plain_t["ms"], "bound_ms": k8b_bound[0],
            "bound_by": k8b_bound[1], "library_ms": None,
            "baseline_ms": k8bf["turns"] and k8bf["turns"]["stage bench"]["baseline"]["ms"],
            "designs_ms": k8bf["turns"] and {w: {d: v["ms"] for d, v in t.items()}
                                             for w, t in k8bf["turns"].items()},
            "stages_ms": k8bf["stages"] and [k8bf["stages"][f"stage{st}"]["ms"]
                                             for st in range(len(blend.BWD_STAGES))],
        },
        {
            "name": "fused_select_blend", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/fused.cu",
            "replaces": "d3ga_tpu/raster/attic/pallas_fused2.py:376",
            "launches": k9_launches["fused_select_blend"],
            "max_abs_err": max(e["max_abs"] for e in k9.values()),
            "ms": k9f["turns"]["kernel"]["ms"] if k9f["turns"] else k9_t["ms"],
            "plain_ms": k9_plain_t["ms"], "bound_ms": k9_bound[0],
            "bound_by": k9_bound[1], "library_ms": None,
            "baseline_ms": k9f["turns"] and k9f["turns"]["baseline"]["ms"],
            "designs_ms": k9f["turns"] and {d: v["ms"] for d, v in k9f["turns"].items()},
            "stages_ms": k9f["stages"] and [k9f["stages"][f"stage{st}"]["ms"]
                                            for st in range(len(fused.FWD_STAGES))],
        },
        {
            "name": "fused_select_blend_bwd", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/fused.cu",
            "replaces": "d3ga_tpu/raster/attic/pallas_fused2.py:407",
            "launches": k9_launches["fused_select_blend_bwd"],
            "max_abs_err": max(e["max_abs"] for e in k9b.values()),
            "ms": k9b_turns["kernel"]["ms"] if k9b_turns else k9b_t["ms"],
            "plain_ms": k9b_plain_t["ms"], "bound_ms": k9b_bound[0],
            "bound_by": k9b_bound[1], "library_ms": None,
            "baseline_ms": k9b_turns and k9b_turns["baseline"]["ms"],
            "designs_ms": k9b_turns and {d: v["ms"] for d, v in k9b_turns.items()},
            "stages_ms": k9b_stages and [k9b_stages[f"stage{st}"]["ms"]
                                         for st in range(len(fused.BWD_STAGES))],
        },
        {
            "name": "fused_route", "route": "cuda", "source": "d3ga_tpu_torch/csrc/fused.cu",
            "replaces": "d3ga_tpu/raster/attic/pallas_fused.py:431",
            "launches": k9_launches["fused_route"], "max_abs_err": k9r["max_abs_err"],
            "ms": k9r["turns"]["kernel"]["ms"] if k9r["turns"] else k9r["plain_ms"],
            "plain_ms": k9r["plain_ms"], "bound_ms": k9r["bound_ms"], "bound_by": k9r["bound_by"],
            "library_ms": k9r["library_ms"],
            "baseline_ms": k9r["turns"] and k9r["turns"]["baseline"]["ms"],
            "designs_ms": k9r["turns"] and {d: v["ms"] for d, v in k9r["turns"].items()},
        },
    ]
    timings = {"blend_tiles_coeffs": {"kernel": k8_t, "plain": k8_plain_t},
               "blend_tiles_coeffs_bwd": {"plain": k8b_plain_t, **({"kernel": k8b_t} if k8b_t
                                                                    else {})},
               "fused_select_blend": {"kernel": k9_t, "plain": k9_plain_t},
               "fused_select_blend_bwd": {"kernel": k9b_t, "plain": k9b_plain_t},
               "fused_route": {}}
    for k in kernels:
        t = timings[k["name"]]
        line(f"{k['name']}: ms={k['ms']:.4f} plain_ms={k['plain_ms']:.4f} "
             f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) library_ms={k['library_ms']} "
             f"launches={k['launches']}; wall per call "
             + ", ".join(f"{nm}={v['call_ms']:.4f}" for nm, v in t.items()))
    report.update(
        k9=k9, k9b=k9b, k9_pairs=pairs, k9_work=work9, k9_edges=k9_edges, k9b_base=k9b_base,
        route_edges=route_edges, k9_route=k9r,
        k9b_px=k9b_px, k9b_turns=k9b_turns, k9b_split=k9b_split, k9b_stages=k9b_stages,
        k9b_ptxas=k9b_ptxas, k9f_edges=k9f_edges, k8_edges=k8_edges, k8b_edges=k8b_edges,
        k9f=k9f, k8f=k8f, k8bf=k8bf,
        k8_work=work8, k9_blocks=NB, k9_kb=kb, fused_vs_topk=fe, aux_fused=a_f,
        aux_topk=a_t, fused_terms_rel=term_err, fused_grad_rel_l2=leaf_err, fused_step_ms=step_ms,
        fused_launches=k9_launches, fused_profiled=fused_prof, k8=k8, k8b=k8b, k8_pairs=pairs8,
        stage_bench=bench, fused_timings=timings,
    )
    report["kernels"] = report.get("kernels", []) + kernels
    return kernels


def stage_err(a, b):
    """P3 stage 2: the largest error of each channel relative to that
    channel's largest |value| in b."""
    scale = b.abs().amax(dim=(0, 1, 2)).clamp(min=1e-30)
    return float(((a - b).abs().amax(dim=(0, 1, 2)) / scale).max())


def hold_stages(vals, rects, K, C, where, line):
    """P3's four stages against their plain versions (0-1 exactly, 2 by
    STAGE2_REL, 3 bit-equal to K9's tiles and within the image tolerance
    of plain), the cuts of K9's forward and, on the card, those of its
    design before (`fused_bisect.stage_v1`) alike; returns each of the
    forward's stages' max abs error against plain."""
    k9_tiles, _ = fused.select_blend(vals, rects, K, C)
    designs = {"kernel": fused_bisect.stage}
    if vals.device.type == "cuda":
        designs["design before"] = fused_bisect.stage_v1
    errs = {d: [] for d in designs}
    for s in range(len(fused_bisect.STAGES)):
        ref = fused_bisect.stage_plain(vals, rects, K, C, s)
        for d, fn in designs.items():
            out = fn(vals, rects, K, C, s)
            sync(vals.device)
            at = f"P3 stage {s} of the {d} ({where})"
            check(bool(torch.isfinite(out).all()), f"{at}: non-finite output")
            errs[d].append(float((out - ref).abs().max()))
            if s < 2:
                check(torch.equal(out, ref), f"{at}: differs from plain")
            elif s == 2:
                e = stage_err(out, ref)
                check(e <= STAGE2_REL, f"{at}: rel {e:.3e} > {STAGE2_REL}")
            else:
                check(torch.equal(out, k9_tiles), f"{at}: not K9's tiles to the bit")
                check(image_ok(image_err(out, ref)), f"{at}: outside the image tolerance of plain")
    line(f"P3 stages vs plain ({where}: NB={vals.shape[0]}, kb={vals.shape[1]}, K={K}, C={C}; "
         f"{' and '.join(designs)}): 0-1 equal, 2 rel <= {STAGE2_REL}, 3 bit-equal to K9; max abs "
         + "; ".join(f"{d} " + ", ".join(f"{e:.3e}" for e in v) for d, v in errs.items()))
    return errs["kernel"]


PROBE_TURN_MS = 5.0  # the longer timed launch of each of P1's turns (slope)


def mxu_code(report, line):
    """ptxas' registers and spills of P1's matmul kernels (both designs),
    and the GMMA instructions in the SASS of the new design's tensor-core
    instantiations (`cuobjdump -sass` of the built library): each of the
    six (TF32 and 3xTF32 at 8, 16 and 128 columns) must hold some."""
    usage = ptxas_usage(report.get("build_logs", {}).get("probes_mxu"), "matmul_kernel")
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(cuda_build.lib_path("probes_mxu"))],
                          capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"P1: cuobjdump -sass failed: {sass.stderr[-400:]}")
    gmma, fn = {}, None
    for ln in sass.stdout.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            gmma[fn] = 0
        elif fn is not None and "GMMA" in ln:
            gmma[fn] += 1
    tc = {k: v for k, v in gmma.items() if "wgmma_matmul_kernel" in k}
    check(len(tc) == 6 and all(v > 0 for v in tc.values()),
          f"P1: a tensor-core instantiation has no GMMA instruction in its SASS: {tc}")
    line("P1 SASS: GMMA instructions a tensor-core instantiation "
         + ", ".join(f"{k}: {v}" for k, v in tc.items())
         + "; ptxas (registers/spill stores): "
         + ", ".join(f"{k}: {u.get('registers')}/{u.get('spill_stores')}" for k, u in usage.items()))
    report["p1_code"] = {"ptxas": usage, "gmma": gmma}


ROLL_CHECK_TRIPS = 2  # trips of each roll design's check


def check_roll_designs(dev, line):
    """P1's roll: every design of `mxu.ROLL_DESIGNS` (on the CPU "kernel"
    alone, the plain version) bit-equal to `roll_plain` on the four
    cases, and to itself across two launches. Returns the largest
    |kernel - plain| of the "kernel" design (0 when it holds)."""
    designs = mxu.ROLL_DESIGNS if dev.type == "cuda" else ("kernel",)
    err = 0.0
    for name, R, L, axis, shifts in PROBE_ROLL_CASES:
        x = mxu.roll_input(R, L, device=dev)
        ref = mxu.roll_plain(x, ROLL_CHECK_TRIPS, shifts, axis)
        for d in designs:
            out = [mxu.roll(x, ROLL_CHECK_TRIPS, shifts, axis, d) for _ in range(2)]
            sync(dev)
            if d == "kernel":
                err = max(err, float((out[0] - ref).abs().max()))
            check(torch.equal(bits(out[0]), bits(ref)),
                  f"P1 roll {name}: design {d} is not bit-equal to plain")
            check(torch.equal(bits(out[1]), bits(out[0])),
                  f"P1 roll {name}: design {d} differs across launches")
    line(f"P1 roll vs plain: designs {', '.join(designs)} (kernel = {mxu.ROLL_KERNEL}) bit-equal "
         f"on {len(PROBE_ROLL_CASES)} cases ({ROLL_CHECK_TRIPS} trips), across two launches")
    return err


def roll_turns(dev, report, line):
    """P1's roll designs on the card, each case: every new design in turns
    against the design before (old, new, new, old) by slope (ns a step:
    one roll + select of the whole array), each design's sync floor (its
    barriers alone) by slope, ptxas' registers and the clusters the card
    holds at once (`mxu.roll_occupancy`). Returns the report's entry."""
    new = [d for d in mxu.ROLL_G if d != "baseline"]
    out = {"cases": {}, "kernel": mxu.ROLL_KERNEL}
    for name, R, L, axis, shifts in PROBE_ROLL_CASES:
        x = mxu.roll_input(R, L, device=dev)

        def ns(fn):
            return probes.slope(fn, dev, PROBE_TURN_MS,
                                mxu.roll_trips(fn, dev, PROBE_TURN_MS))["ns_per_op"]

        case = {"bound_ns": mxu.roll_bound_ns(R, L),
                "bound_v1_ns": mxu.roll_bound_v1_ns(R, L, axis), "designs": {}}
        for d in new:
            t = {"baseline": [], d: []}
            for k in ("baseline", d, d, "baseline"):
                t[k].append(ns(lambda n, k=k: mxu.roll(x, n, shifts, axis, k)))
            case["designs"][d] = {
                "turns": t, "ns": float(np.mean(t[d])),
                "baseline_ns": float(np.mean(t["baseline"])),
                "floor_ns": ns(lambda n, d=d: mxu.roll_floor(x, n, shifts, axis, d)),
                "occupancy": mxu.roll_occupancy(R, L, axis, d),
                "threads": mxu.roll_threads(R, L, axis, d)}
        case["fastest"] = min(new, key=lambda d: case["designs"][d]["ns"])
        out["cases"][name] = case
    usage = ptxas_usage(report.get("build_logs", {}).get("probes_mxu"), "roll_")
    out["ptxas"] = usage
    line("P1 roll in turns, ns a step (the design before -> design; its sync floor; occupancy) "
         "and the card-wide bound: " + "; ".join(
             f"{n}: " + ", ".join(f"{d} {v['baseline_ns']:.2f} -> {v['ns']:.2f} "
                                  f"(floor {v['floor_ns']:.2f}, occ {v['occupancy']})"
                                  for d, v in c["designs"].items())
             + f", bound {c['bound_ns']:.3f} (before {c['bound_v1_ns']:.3f}), fastest "
             f"{c['fastest']}" for n, c in out["cases"].items()))
    line("P1 roll ptxas (registers/spill stores): " + ", ".join(
        f"{k}: {u.get('registers')}/{u.get('spill_stores')}" for k, u in usage.items()))
    report["roll_turns"] = out
    return out


def probe_turns(dev, report, line):
    """P1's and P2's designs against their designs before, in turns (old,
    new, new, old): P1 by slope (ms an op) on one CTA and on one CTA per
    SM, each case; P2 by CUDA events around back-to-back calls
    (`probes.time_ms`, the protocol `widerow.run` times torch.mul by) and
    around calls queued behind a spin (`probes.queued_ms`: no host launch
    cost), with one torch.mul a turn under both."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    order = ("v1", "new", "new", "v1")
    p1 = {}
    for name, M, K_, N, prec, cl in PROBE_MATMUL_CASES:
        a, b = mxu.operands(M, K_, N, cl, device=dev)
        stacked = (a.expand(sms, -1, -1).contiguous(), b.expand(sms, -1, -1).contiguous())
        fns = {"v1": mxu.matmul_v1, "new": mxu.matmul}
        p1[name] = {}
        for mode, (x, y) in (("one_cta", (a, b)), ("per_sm", stacked)):
            t = {"v1": [], "new": []}
            for k in order:
                t[k].append(probes.slope(lambda n: fns[k](x, y, n, prec, cl), dev,
                                         PROBE_TURN_MS)["ns_per_op"] * 1e-6)
            p1[name][mode] = {k: {"turns": v, "ms": float(np.mean(v))} for k, v in t.items()}
        del stacked
    line("P1 in turns, ms an op (the design before -> new; one CTA | one CTA per SM): "
         + "; ".join(f"{n}: {r['one_cta']['v1']['ms']:.5f} -> {r['one_cta']['new']['ms']:.5f} | "
                     f"{r['per_sm']['v1']['ms']:.5f} -> {r['per_sm']['new']['ms']:.5f}"
                     for n, r in p1.items()))
    p2 = {}
    for name, shape, bs in widerow.PASS_CASES:
        x = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
        fns = {"v1": lambda: widerow.passthrough_v1(x, bs), "new": lambda: widerow.passthrough(x, bs)}
        fns["torch.mul"] = lambda: torch.mul(x, widerow.SCALE)
        t = {k: {"ms": [], "queued_ms": []} for k in fns}
        for k in order:
            for w in (k, "torch.mul"):
                t[w]["ms"].append(probes.time_ms(fns[w], PROBE_ITERS, dev))
                t[w]["queued_ms"].append(probes.queued_ms(fns[w], PROBE_ITERS, dev))
        p2[name] = {k: {"turns": v, "ms": float(np.mean(v["ms"])),
                        "queued_ms": float(np.mean([q for q in v["queued_ms"] if q is not None]))}
                    for k, v in t.items()}
        del x
    line("P2 in turns, ms a call (the design before -> new; torch.mul), back to back | queued "
         "behind a spin: " + "; ".join(
             f"{n}: " + " | ".join(f"{r['v1'][w]:.5f} -> {r['new'][w]:.5f}; {r['torch.mul'][w]:.5f}"
                                   for w in ("ms", "queued_ms"))
             for n, r in p2.items()))
    report["probe_turns"] = {"p1": p1, "p2": p2}
    return report["probe_turns"]


def parity(out, ref):
    """PALLAS_PARITY.json's metrics of `out` against the JAX kernel's `ref`
    (numpy): the largest and p999 absolute error, the p999 relative to
    ref's largest |value|, and the share of values off by more than 1e-3
    of it (threshold flips)."""
    err = (out.detach().double().cpu().flatten() - torch.from_numpy(ref).double().flatten()).abs()
    scale = float(np.abs(ref).max())
    k = max(1, int(np.ceil(0.999 * err.numel())))
    p999 = float(err.kthvalue(k).values)
    return {"max_abs": float(err.max()), "p999_abs": p999, "p999_rel": p999 / scale,
            "flip_share": float((err > 1e-3 * scale).double().mean())}


def on_threshold_report(dev, line):
    """K2, K3, K9 and K9's backward, and their plain versions, on the two
    cases on the alpha threshold (K3_ON_THRESHOLD, K9_ON_THRESHOLD) against
    the JAX kernels' outputs kept in ON_THRESHOLD_FIXTURE, by `parity`:
    which side the kernels' roundings fall on there. A report, no check."""
    fx = np.load(ON_THRESHOLD_FIXTURE)
    _, rec, idx, counts, g, ntx, nty, C = {c[0]: c for c in k3_edge_cases(dev)}[K3_ON_THRESHOLD]
    _, vals, rects, g9, C9 = {c[0]: c for c in k9_edge_cases(dev)}[K9_ON_THRESHOLD]
    K9 = K9_EDGE_K
    k2, k3 = (rec, idx, counts, ntx, nty, C), (rec, idx, counts, g, ntx, nty, C)
    runs = {
        "K2": ("k3_image", blend_ct.blend_gather_ct(*k2), blend_ct.blend_gather_ct_plain(*k2)),
        "K3": ("k3_drec", blend_ct.blend_gather_ct_bwd(*k3), blend_ct.blend_gather_ct_bwd_plain(*k3)),
        "K9": ("k9_tiles", fused.select_blend(vals, rects, K9, C9)[0],
               fused.select_blend_plain(vals, rects, K9, C9)[0]),
        "K9 backward": ("k9_dvals", fused.select_blend_bwd(vals, rects, g9, K9, C9),
                        fused.select_blend_bwd_plain(vals, rects, g9, K9, C9)),
    }
    out = {}
    for name, (key, kern, plain) in runs.items():
        out[name] = {"kernel": parity(kern, fx[key]), "plain": parity(plain, fx[key])}
    line("on the alpha threshold, against the JAX kernels (p999 abs / p999 rel / flip share; "
         "kernel | plain): " + "; ".join(
             f"{n}: " + " | ".join(f"{e[w]['p999_abs']:.3g} / {e[w]['p999_rel']:.3g} / "
                                   f"{e[w]['flip_share']:.3g}" for w in ("kernel", "plain"))
             for n, e in out.items()))
    return out


def probes_phase(dev, report, scene):
    """P1-P3, the card probes: each probe kernel against its plain version
    (P2's passthrough and the roll bit-equal; P1's matmuls by relative L2
    against their plain versions and TF32 / 3xTF32 against float64, the
    one-CTA-per-SM launch equal to the one-CTA one; on the card P1 and P2
    against their designs before too, and P1's SASS and ptxas
    (`mxu_code`); P3's stages at the TPU bisect's shapes and at frame 0's
    K9 shapes), the on-threshold report (`on_threshold_report`), then with
    the launch counts at 0 the probes' runs (`mxu.run_matmul`,
    `mxu.run_roll`, `widerow.run`, `fused_bisect.run` on frame 0), one
    JSON line each, P1 and P2 in turns against their designs before
    (`probe_turns`), and the kernels' entries (P1's times per op, the
    rest per call)."""
    line = logger(report)
    gen = torch.Generator(device=dev)

    # -- P2: the passthrough and its design before, bit-equal ---------------
    on_card = dev.type == "cuda"
    for name, shape, bs in widerow.PASS_CASES:
        x = torch.randn(shape, generator=gen.manual_seed(4), device=dev)
        ref = widerow.passthrough_plain(x)
        check(torch.equal(widerow.passthrough(x, bs), ref), f"P2 {name}: not bit-equal to plain")
        if on_card:
            check(torch.equal(widerow.passthrough_v1(x, bs), ref),
                  f"P2 {name}: the design before is not bit-equal to plain")
    line(f"P2 passthrough vs plain: bit-equal on {len(widerow.PASS_CASES)} operands"
         + (", the design before too" if on_card else ""))

    # -- P1: the matmuls at each case's shape, one CTA and one per SM -------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if on_card else 1
    mm_err, mm_abs = {}, {p: 0.0 for p in mxu.PRECISIONS}
    for name, M, K_, N, prec, cl in PROBE_MATMUL_CASES:
        a, b = mxu.operands(M, K_, N, cl, device=dev)
        out = mxu.matmul(a, b, 1, prec, cl)
        many = mxu.matmul(a.expand(sms, -1, -1).contiguous(), b.expand(sms, -1, -1).contiguous(),
                          1, prec, cl)
        ref = mxu.matmul_plain(a, b, 1, prec, cl)
        ref64 = a.double() @ (b.double().t() if cl else b.double())
        sync(dev)
        check(bool(torch.isfinite(out).all()), f"P1 {name}: non-finite output")
        check(torch.equal(many, out.expand_as(many)), f"P1 {name}: one CTA per SM differs from one CTA")
        e = {"plain": rel_l2(out, ref), "fp64": rel_l2(out, ref64)}
        if on_card:
            old = mxu.matmul_v1(a, b, 1, prec, cl)
            e["v1"], e["v1_plain"] = rel_l2(out, old), rel_l2(old, ref)
            check(e["v1"] <= MATMUL_REL_L2, f"P1 {name}: rel L2 {e['v1']:.3e} against the design "
                                            f"before > {MATMUL_REL_L2}")
        mm_err[name] = e
        mm_abs[prec] = max(mm_abs[prec], float((out - ref).abs().max()))
        check(e["plain"] <= MATMUL_REL_L2, f"P1 {name}: rel L2 {e['plain']:.3e} against plain "
                                           f"> {MATMUL_REL_L2}")
        if prec in MATMUL_FP64_REL_L2:
            check(e["fp64"] <= MATMUL_FP64_REL_L2[prec], f"P1 {name}: rel L2 {e['fp64']:.3e} "
                                                         f"against float64 > {MATMUL_FP64_REL_L2[prec]}")
        del many
    line("P1 matmuls (rel L2) vs plain / float64 / the design before: "
         + "; ".join(f"{n}: {e['plain']:.2e} / {e['fp64']:.2e} / {e.get('v1', float('nan')):.2e}"
                     for n, e in mm_err.items()))
    if on_card:
        mxu_code(report, line)

    # -- P1: the roll, every design bit-equal -------------------------------
    roll_abs = check_roll_designs(dev, line)
    report["on_threshold"] = on_threshold_report(dev, line)

    # -- P3: the stages at the bisect's shapes, then at frame 0's -----------
    bv, br = (torch.from_numpy(t).to(dev)
              for t in fused_bisect.make_inputs(BISECT_NB, BISECT_NC, BISECT_C))
    hold_stages(bv, br, BISECT_K, BISECT_C, "the bisect's shapes", line)
    means, cov3d, opac, colors = scene["gauss"]
    cam, C = scene["camera"], scene["C"]
    with torch.no_grad():
        proj = project_gaussians(means, cam, cov3d=cov3d, opacities=opac, colors=colors)
        vals, rects, _, _, _ = tiles.fused_candidates(proj, -(-WIDTH // 16), -(-HEIGHT // 16),
                                                      BLOCK_CAP)
        stage_abs = hold_stages(vals, rects, K, C, "frame 0", line)
    del proj

    # -- the probes' runs ----------------------------------------------------
    sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        mm_rows = mxu.run_matmul(dev, PROBE_MATMUL_CASES, target_ms=PROBE_TARGET_MS)
        roll_rows = mxu.run_roll(dev, PROBE_ROLL_CASES, target_ms=PROBE_TARGET_MS)
        wr_rows = widerow.run(dev, iters=PROBE_ITERS, scale=PROBE_SCALE)
        # the fused phase's cotangent, so the backward's split adds up to its time
        g = torch.randn((vals.shape[0], fused.TB, fused.NPIX, C + 1),
                        generator=torch.Generator(device=dev).manual_seed(9), device=dev)
        st_rows, pairs = fused_bisect.run(vals, rects, K, C, iters=PROBE_ITERS, g=g)
    sync(dev)
    run_s = time.perf_counter() - t0
    # P3's backward split launches K9's per-tile kernel and route alone
    split = {"bwd_tiles": fused.tiles_launches, "route": fused.route_design_launches["kernel"]}
    counts = {**{(k if k == "roll" else f"matmul_{k}"): n for k, n in mxu.launches.items()},
              "passthrough": widerow.launches,
              **{f"stage{s}": n for s, n in fused_bisect.launches.items()},
              **(split if on_card else {})}
    lines = [probes.emit("mxu_matmul", dev, mm_rows), probes.emit("mxu_roll", dev, roll_rows),
             probes.emit("widerow", dev, wr_rows),
             probes.emit("fused_bisect", dev, [dict(r, blocks=vals.shape[0], kb=vals.shape[1],
                                                    K=K, C=C, pairs=pairs) for r in st_rows])]
    for ln in lines:
        report.setdefault("log", []).append(json.dumps(ln))
    bwd = st_rows[-1]["device_ms"]
    check(all(r["ms"] is not None for r in st_rows[:-1]),
          "P3: a stage's launches did not queue behind the spin")
    check(dev.type != "cuda"
          or all(bwd[k] is not None for k in ("total", *fused_bisect.BWD_KERNELS)),
          f"P3: K9's backward or one of its kernels did not queue behind the spin: {bwd}")
    line(f"probes run: {run_s:.1f} s; launches {counts}; K9 forward stages (ms a call, "
         f"{st_rows[0]['clock']}; delta): "
         + ", ".join(f"{r['stage']} {r['ms']:.4f} ({r['delta_ms']:+.4f})" for r in st_rows[:-1])
         + f"; K9 backward kernels {bwd}")
    check(all(n > 0 for n in counts.values()), f"probes: a probe kernel was not launched {counts}")
    check(off_path_launches() == sum(split.values()),
          "probes' run: a design before was launched")
    check(all(np.isfinite(r["one_cta"]["ns_per_op"]) for r in mm_rows), "P1: a time is not finite")
    turns = probe_turns(dev, report, line) if on_card else {}
    rturns = roll_turns(dev, report, line) if on_card else None
    # P3: the kernel's cuts against the design before's, in turns
    p3_turns = None
    if on_card:
        with torch.no_grad():
            p3_turns = [in_turns({
                "design before": lambda s=s: fused_bisect.stage_v1(vals, rects, K, C, s),
                "kernel": lambda s=s: fused_bisect.stage(vals, rects, K, C, s)}, PROBE_ITERS, dev,
                profiler=False) for s in range(len(fused_bisect.STAGES))]
        line("P3 stages in turns at frame 0 (ms a call, queued; the design before -> the "
             "kernel's cuts): " + "; ".join(f"{s} {turns_summary(t)}"
                                            for s, t in enumerate(p3_turns)))
        report["p3_turns"] = p3_turns

    # -- the kernels' entries ------------------------------------------------
    def case_row(prec):
        """The matmul entries' case: the largest product at this precision."""
        return max((r for r in mm_rows if r["precision"] == prec),
                   key=lambda r: r["M"] * r["K"] * r["N"])

    kernels = []
    for prec, label in (("highest", "fp32"), ("default", "tf32"), ("high", "3xtf32")):
        r = case_row(prec)
        a, b = mxu.operands(r["M"], r["K"], r["N"], r["contract_last"], device=dev)
        plain = probes.time_ms(lambda: mxu.matmul_plain(a, b, 1, prec, r["contract_last"]), 3,
                               dev, warmup=1) / probes.UNROLL
        kernels.append({
            "name": f"probe_matmul_{label}", "route": "cuda",
            "source": "d3ga_tpu_torch/csrc/probes_mxu.cu", "replaces": "tools/mxu_probe.py:56",
            "launches": mxu.launches[prec], "max_abs_err": mm_abs[prec],
            "ms": r["one_cta"]["ns_per_op"] * 1e-6, "plain_ms": plain,
            "bound_ms": r["bound_ns"] * 1e-6, "bound_by": "operations",
            "library_ms": r["library_ms"],
        })
    r = roll_rows[0]
    x = mxu.roll_input(r["rows"], r["lanes"], device=dev)
    plain = probes.time_ms(lambda: mxu.roll_plain(x, 2, r["shifts"], r["axis"]), 3, dev,
                           warmup=1) / (2 * probes.UNROLL)
    rt = rturns and rturns["cases"][r["case"]]["designs"][mxu.ROLL_KERNEL]
    kernels.append({
        "name": "probe_roll", "route": "cuda", "source": "d3ga_tpu_torch/csrc/probes_mxu.cu",
        "replaces": "tools/mxu_probe.py:96", "design": mxu.ROLL_KERNEL,
        "launches": mxu.launches["roll"], "max_abs_err": roll_abs,
        "ms": r["ns_per_op"] * 1e-6, "plain_ms": plain,
        "bound_ms": r["bound_ns"] * 1e-6, "bound_by": "operations", "library_ms": None,
        "baseline_ms": rt and rt["baseline_ns"] * 1e-6,
        "sync_floor_ms": rt and rt["floor_ns"] * 1e-6,
    })
    r = wr_rows[0]
    kernels.append({
        "name": "probe_passthrough", "route": "cuda",
        "source": "d3ga_tpu_torch/csrc/probes_widerow.cu", "replaces": "tools/widerow_probe.py:65",
        "launches": widerow.launches, "max_abs_err": 0.0, "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
        "library_ms": r["library_ms"],
    })
    for s, r in enumerate(st_rows[:-1]):
        plain = probes.time_ms(lambda: fused_bisect.stage_plain(vals, rects, K, C, s), 2, dev,
                               warmup=1)
        kernels.append({
            "name": f"fused_stage{s}", "route": "cuda", "source": "d3ga_tpu_torch/csrc/fused.cu",
            "replaces": fused_bisect.REPLACES[s], "launches": counts[f"stage{s}"],
            "max_abs_err": stage_abs[s],
            "ms": p3_turns[s]["kernel"]["ms"] if p3_turns else r["ms"], "plain_ms": plain,
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "baseline_ms": p3_turns and p3_turns[s]["design before"]["ms"],
        })
    for k in kernels:
        line(f"{k['name']}: ms={k['ms']:.6f} plain_ms={k['plain_ms']:.6f} "
             f"bound_ms={k['bound_ms']:.6f} ({k['bound_by']}) library_ms={k['library_ms']} "
             f"launches={k['launches']}")
    report.update(probe_matmul_err=mm_err, probe_launches=counts, probe_run_s=run_s,
                  probe_rows={"mxu_matmul": mm_rows, "mxu_roll": roll_rows, "widerow": wr_rows,
                              "fused_bisect": st_rows})
    report["kernels"] = report.get("kernels", []) + kernels
    return kernels


def api_scene(dev):
    """tests/test_torch_api.py's scene: API_N Gaussians in front of an
    identity camera, scales + unit quaternions, colours, from seed 0."""
    rng = np.random.default_rng(0)
    n = API_N
    means = np.concatenate([rng.uniform(-0.8, 0.8, (n, 2)), rng.uniform(4.0, 6.0, (n, 1))], -1)
    scales = np.exp(rng.uniform(-3.5, -2.2, (n, 3)))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, (n, 1))
    colors = rng.uniform(0, 1, (n, 3))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    return {"means": t(means), "scales": t(scales), "rotations": t(q), "opacities": t(opac),
            "colors": t(colors), "bg": t([0.1, 0.2, 0.3])}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr}", file=sys.stderr)
        return 1
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    dev = torch.device("cuda", 0)
    say = logger(report)
    probes.on_short_profile = lambda p: say(
        f"profiler: a profile at {p['where']} recorded {p['recorded']} of its {p['calls']} calls "
        f"(attempts {p['attempts']}; the calls each attempt lost {p['lost']})")
    report["short_profiles"] = probes.SHORT_PROFILES
    try:
        kernels = run(dev, report)
    except Exception as e:  # report, on both streams, then fail the run
        report["failed"] = f"{type(e).__name__}: {e}"
        report["traceback"] = traceback.format_exc()
        print(f"chip_smoke: FAILED: {report['failed']}", flush=True)
        print(f"{report['traceback']}chip_smoke: FAILED: {report['failed']}", file=sys.stderr,
              flush=True)
        return 1
    finally:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
