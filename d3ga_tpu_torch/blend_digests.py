"""Digests of the blend kernels' outputs on one NVIDIA GPU, to hold two
trees' kernels to the same bits.

Builds the blend kernels and prints one line, "DIGESTS <label> {section:
{case: [digests]}}" (the first 16 hex digits of each output's SHA-256):

- "K2/K3": K3's drec (`blend_ct.blend_gather_ct_bwd`) and K2's image
  (`blend_ct.blend_gather_ct`) on every case of `chip_smoke.k3_edge_cases`
  and on chip_smoke.py's full-width selection (frame 0 of the serving
  scene, K 256, dup 3, the cotangent from seed 4; there also the records'
  and ids');
- "K9 backward": K9's backward (`fused.select_blend_bwd`) on every case of
  `chip_smoke.k9_edge_cases` (their own cotangents) and on frame 0's fused
  inputs (`tiles.fused_candidates` at the default block cap, the cotangent
  from seed 9; there also the candidates' and rects');
- "K8 backward": K8's backward (`blend.blend_tiles_coeffs_bwd`: dcoeffs,
  dcolors, dopacs) on every case of `chip_smoke.k8_edge_cases`, a
  cotangent from `chip_smoke.k8_cotangent` at seed 40 + the case's
  position each (trees whose chip_smoke.py has no `k8_cotangent`, from
  before K8's backward on coeff_walk_bwd.cuh, have no such section);

then "SASS <label> {opcode: count}", the instruction counts of
`fused_bwd_kernel<6, 2, 4>` in `cuobjdump -sass` of the fused library.
With `--against ROOT`, then "K9BWD_TURNS <label> {...}": K9's backward at
frame 0 through the fused library built from ROOT's csrc/fused.cu
("other") and through this tree's ("this"), in one process, the same
inputs: the device ms a call of `fused_bwd_kernel` alone, timed in turns
(other, this, this, other; `chip_smoke.in_turns`), each turn's ms, and
whether the two libraries' d(vals) are bit-equal. Run from the root of a
checkout, with that tree's package and chip_smoke.py on the path:

    PYTHONPATH=. python3 -m d3ga_tpu_torch.blend_digests change --against <the parent tree>
    cd <the parent tree> && PYTHONPATH=. python3 <this file> parent
"""

import argparse
import collections
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

import chip_smoke as cs
from d3ga_tpu_torch.data.synthetic import serving_scene
from d3ga_tpu_torch.model.avatar import avatar_forward, init_avatar
from d3ga_tpu_torch.raster import blend, blend_ct, fused, tiles
from d3ga_tpu_torch.raster.project import project_gaussians
from d3ga_tpu_torch.raster.tiles import bin_gaussians
from d3ga_tpu_torch.utils import cuda_build

SASS_KERNEL = "fused_bwd_kernelILi6ELi2ELi4E"  # fused_bwd_kernel<6, 2, 4>, mangled


def digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def frame0(dev):
    """Frame 0 of chip_smoke.py's serving scene: (camera, means, cov3d,
    opacities, colours)."""
    model, camera, pose = serving_scene(cs.N_GARMENTS, cs.N_PER_GARMENT, cs.CAGE_RES, cs.WIDTH,
                                        cs.HEIGHT, dev)
    params = init_avatar(torch.Generator().manual_seed(0), model)
    pkg = avatar_forward(params, model, {"camera": camera, "lbs": pose(0), "camera_idx": 0},
                         training=False)
    colors = torch.cat([pkg["rgb"], pkg["silhouette_rgb"]], -1).contiguous()
    return camera, pkg["means3D"], pkg["cov3D_precomp"], pkg["opacities"], colors


def k3_digests(dev, scene):
    out = {}
    for name, rec, idx, counts, g, ntx, nty, C in cs.k3_edge_cases(dev):
        out[name] = [digest(blend_ct.blend_gather_ct_bwd(rec, idx, counts, g, ntx, nty, C)),
                     digest(blend_ct.blend_gather_ct(rec, idx, counts, ntx, nty, C))]
    camera, means, cov3d, opac, colors = scene
    b = bin_gaussians(means, camera, cov3d, opac, colors, cs.K, cs.DUP)
    C = colors.shape[-1]
    cnt = torch.clamp(b.counts, max=cs.K).contiguous()
    gen = torch.Generator(device=dev).manual_seed(4)
    g = torch.randn((C + 1, b.nty * 16, b.ntx * 16), generator=gen, device=dev)
    out["full width"] = [
        digest(blend_ct.blend_gather_ct_bwd(b.records_ext, b.idx, cnt, g, b.ntx, b.nty, C)),
        digest(blend_ct.blend_gather_ct(b.records_ext, b.idx, cnt, b.ntx, b.nty, C)),
        digest(b.records_ext), digest(b.idx)]
    return out


def frame0_fused(dev, scene):
    """Frame 0's fused inputs at the default block cap and a cotangent
    from seed 9: (vals, rects, g, C)."""
    camera, means, cov3d, opac, colors = scene
    C = colors.shape[-1]
    proj = project_gaussians(means, camera, cov3d=cov3d, opacities=opac, colors=colors)
    vals, rects, *_ = tiles.fused_candidates(proj, -(-cs.WIDTH // 16), -(-cs.HEIGHT // 16),
                                             cs.BLOCK_CAP)
    g = torch.randn((vals.shape[0], fused.TB, fused.NPIX, C + 1),
                    generator=torch.Generator(device=dev).manual_seed(9), device=dev)
    return vals, rects, g, C


def k9_digests(dev, scene):
    out = {}
    for name, vals, rects, g, C in cs.k9_edge_cases(dev):
        out[name] = [digest(fused.select_blend_bwd(vals, rects, g, cs.K9_EDGE_K, C))]
    vals, rects, g, C = frame0_fused(dev, scene)
    out["frame 0"] = [digest(fused.select_blend_bwd(vals, rects, g, cs.K, C)), digest(vals),
                      digest(rects)]
    return out


def k8_digests(dev):
    out = {}
    for i, (name, co, col, op, C) in enumerate(cs.k8_edge_cases(dev)):
        g = cs.k8_cotangent(co, C, 40 + i)
        out[name] = [digest(d) for d in blend.blend_tiles_coeffs_bwd(co, col, op, g)]
    return out


def other_fused_lib(root):
    """csrc/fused.cu of the checkout at `root`, built with the port's nvcc
    flags into build/kernels/ and loaded, its entry points declared."""
    src = Path(root).resolve() / "d3ga_tpu_torch" / "csrc" / "fused.cu"
    out = cuda_build.BUILD_DIR / "libfused-other.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)],
                   capture_output=True, text=True, check=True)
    return fused.bind(ctypes.CDLL(str(out)))


def k9_bwd_turns(dev, scene, root, iters=20):
    """K9's backward at frame 0 through ROOT's fused library ("other") and
    this tree's ("this"), timed in turns by the device ms of
    fused_bwd_kernel; whether their d(vals) are bit-equal."""
    vals, rects, g, C = frame0_fused(dev, scene)
    libs = {"other": other_fused_lib(root), "this": fused._kernels()}

    def call(lib):
        with mock.patch.object(fused, "_kernels", lambda: lib):
            return fused.select_blend_bwd(vals, rects, g, cs.K, C)

    same = torch.equal(cs.bits(call(libs["other"])), cs.bits(call(libs["this"])))
    turns = cs.in_turns({k: (lambda lib=lib: call(lib)) for k, lib in libs.items()}, iters, dev,
                        kernel="fused_bwd_kernel")
    return {"bit_equal": same, "turns": turns}


def sass_ops(kernel=SASS_KERNEL):
    """{opcode: count} of `kernel` (a mangled-name fragment) in the fused
    library's SASS; empty where cuobjdump is missing."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(cuda_build.lib_path("fused"))], capture_output=True,
                          text=True, check=True).stdout
    ops, inside = collections.Counter(), False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside and ln.strip().startswith("/*") and "*/" in ln:
            words = ln.split("*/", 1)[1].split()
            if words and words[0].startswith("@"):  # a predicate
                words = words[1:]
            if words and not words[0].startswith("/*"):
                ops[words[0].split(".")[0]] += 1
    return dict(sorted(ops.items()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default="tree")
    ap.add_argument("--against", metavar="ROOT",
                    help="time K9's backward in turns against ROOT's csrc/fused.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("blend_digests: needs an NVIDIA GPU")
    cuda_build.build_all(["extract", "blend_ct", "blend_ct_bwd", "blend_coeffs", "fused"])
    dev = torch.device("cuda")
    with torch.no_grad():
        scene = frame0(dev)
        out = {"K2/K3": k3_digests(dev, scene), "K9 backward": k9_digests(dev, scene)}
        if hasattr(cs, "k8_cotangent"):
            out["K8 backward"] = k8_digests(dev)
    torch.cuda.synchronize()
    print(f"DIGESTS {args.label} {json.dumps(out)}")
    print(f"SASS {args.label} {json.dumps(sass_ops())}")
    if args.against:
        with torch.no_grad():
            turns = k9_bwd_turns(dev, scene, args.against)
        print(f"K9BWD_TURNS {args.label} {json.dumps(turns)}")


if __name__ == "__main__":
    main()
