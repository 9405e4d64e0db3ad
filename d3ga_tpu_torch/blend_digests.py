"""Digests of K2's image and K3's drec on one NVIDIA GPU, to hold two trees'
kernels to the same bits.

Builds K1-K3, runs K2 (`blend_ct.blend_gather_ct`) and K3
(`blend_ct.blend_gather_ct_bwd`) on every case of
`chip_smoke.k3_edge_cases` and on chip_smoke.py's full-width selection
(frame 0 of the serving scene, K 256, dup 3, the cotangent from seed 4),
and prints one line: "DIGESTS <label> {case: [K3's drec, K2's image], ...}"
(the first 16 hex digits of each output's SHA-256; at full width also the
records' and ids'). Run from the root of a checkout, with that tree's
package and chip_smoke.py on the path:

    PYTHONPATH=. python3 -m d3ga_tpu_torch.blend_digests change
    cd <the parent tree> && PYTHONPATH=. python3 <this file> parent
"""

import hashlib
import json
import sys

import torch

import chip_smoke as cs
from d3ga_tpu_torch.data.synthetic import serving_scene
from d3ga_tpu_torch.model.avatar import avatar_forward, init_avatar
from d3ga_tpu_torch.raster import blend_ct
from d3ga_tpu_torch.raster.tiles import bin_gaussians
from d3ga_tpu_torch.utils import cuda_build


def digest(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def digests(dev):
    out = {}
    for name, rec, idx, counts, g, ntx, nty, C in cs.k3_edge_cases(dev):
        out[name] = [digest(blend_ct.blend_gather_ct_bwd(rec, idx, counts, g, ntx, nty, C)),
                     digest(blend_ct.blend_gather_ct(rec, idx, counts, ntx, nty, C))]
    model, camera, pose = serving_scene(cs.N_GARMENTS, cs.N_PER_GARMENT, cs.CAGE_RES, cs.WIDTH,
                                        cs.HEIGHT, dev)
    params = init_avatar(torch.Generator().manual_seed(0), model)
    pkg = avatar_forward(params, model, {"camera": camera, "lbs": pose(0), "camera_idx": 0})
    colors = torch.cat([pkg["rgb"], pkg["silhouette_rgb"]], -1).contiguous()
    b = bin_gaussians(pkg["means3D"], camera, pkg["cov3D_precomp"], pkg["opacities"], colors,
                      cs.K, cs.DUP)
    C = colors.shape[-1]
    cnt = torch.clamp(b.counts, max=cs.K).contiguous()
    gen = torch.Generator(device=dev).manual_seed(4)
    g = torch.randn((C + 1, b.nty * 16, b.ntx * 16), generator=gen, device=dev)
    out["full width"] = [
        digest(blend_ct.blend_gather_ct_bwd(b.records_ext, b.idx, cnt, g, b.ntx, b.nty, C)),
        digest(blend_ct.blend_gather_ct(b.records_ext, b.idx, cnt, b.ntx, b.nty, C)),
        digest(b.records_ext), digest(b.idx)]
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("blend_digests: needs an NVIDIA GPU")
    cuda_build.build_all(["extract", "blend_ct", "blend_ct_bwd"])
    with torch.no_grad():
        out = digests(torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"DIGESTS {sys.argv[1] if len(sys.argv) > 1 else 'tree'} {json.dumps(out)}")


if __name__ == "__main__":
    main()
