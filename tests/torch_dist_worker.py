"""One rank of the PyTorch port's sharded-raster parity runs
(tests/test_torch_dist.py): a Gloo rank on the CPU that runs every case
of its world size and writes its results to `<out_dir>/rank<r>.npz`.
Imports no JAX: the ranks are started with the spawn method and import
only this module and the port.

Cases, by world size (the scene arrays come from `<in_path>`, made by
the test from a seed with numpy):
  * "gathered" — `rasterize_sharded` on the full arrays; the image, the
    aggregated counters and the gradients of sum(img**2); the
    single-device `rasterize_tiled` of the same scene beside it;
  * "banded" — `rasterize_collective(banded=True)` on this rank's shard of
    the padded arrays; the band, the counters, and the banded objective
    (`banded_l1_ssim`) with its gradients;
  * "skew" — `rasterize_sharded` with a front margin on a scene whose
    nearest Gaussians all sit on shard 0 (forward only);
  * "ties" — `rasterize_sharded` on a scene whose depths share a few
    depth quanta, beside the single-device `rasterize_tiled` (exact depth
    order) and the per-tile candidate counts;
  * "halo" — banded SSIM, L1 and PSNR of random bands against the
    full-image losses (the margin is unused);
  * "mesh" — a 2 x 2 mesh of 4 ranks: coordinates and group sums.
"""

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

K, DUP = 16, 3
GRADS = ("means", "cov3d", "opacities", "colors")


def _camera(d, prefix):
    from d3ga_tpu_torch.raster.camera import make_camera

    w, h = (int(v) for v in d[prefix + "wh"])
    fx, fy = (float(v) for v in d[prefix + "fov"])
    return make_camera(np.eye(3), np.zeros(3), fx, fy, w, h, device="cpu")


def _aux(prefix, aux, out):
    for f in aux._fields:
        out[f"{prefix}.aux.{f}"] = np.asarray(int(getattr(aux, f)))


def _leaves(d, prefix, lo=0, hi=None):
    return {
        k: torch.from_numpy(d[f"{prefix}{k}"][lo:hi].copy()).requires_grad_(True) for k in GRADS
    }


def gathered(mesh, d, out, margin):
    from d3ga_tpu_torch.dist.raster_shard import rasterize_sharded
    from d3ga_tpu_torch.raster.tiles import rasterize_tiled

    cam, bg = _camera(d, "scene."), torch.from_numpy(d["scene.bg"])
    x = _leaves(d, "scene.")
    img, aux = rasterize_sharded(
        mesh, x["means"], cam, bg, cov3d=x["cov3d"], opacities=x["opacities"],
        colors=x["colors"], max_per_tile=K, dup=DUP, use_pallas=True, shard_select=True,
        front_margin=margin,
    )
    (img**2).sum().backward()
    out["gathered.img"] = img.detach().numpy()
    _aux("gathered", aux, out)
    for k in GRADS:
        out[f"gathered.grad.{k}"] = x[k].grad.numpy()
    # the single-device port on the same scene
    y = _leaves(d, "scene.")
    ref, raux = rasterize_tiled(
        y["means"], cam, bg, cov3d=y["cov3d"], opacities=y["opacities"], colors=y["colors"],
        max_per_tile=K, use_pallas=True, coarse="dupsort_depth", dup=DUP,
    )
    (ref**2).sum().backward()
    out["single.img"] = ref.detach().numpy()
    _aux("single", raux, out)
    for k in GRADS:
        out[f"single.grad.{k}"] = y[k].grad.numpy()


def banded(mesh, d, out, margin):
    from d3ga_tpu_torch.dist.banded import banded_l1_ssim
    from d3ga_tpu_torch.dist.raster_shard import aggregate_aux, rasterize_collective

    group, m = mesh.model_group, mesh.model
    n_loc = d["padded.means"].shape[0] // m
    r = mesh.model_index
    x = _leaves(d, "padded.", r * n_loc, (r + 1) * n_loc)
    band, aux = rasterize_collective(
        x["means"], _camera(d, "scene."), torch.from_numpy(d["scene.bg"]), group, m,
        cov3d=x["cov3d"], opacities=x["opacities"], colors=x["colors"], max_per_tile=K,
        dup=DUP, use_pallas=True, banded=True, shard_select=True, front_margin=margin,
    )
    loss = banded_l1_ssim(band, torch.from_numpy(d["scene.target"]), group, m)
    loss.backward()
    out["banded.band"] = band.detach().numpy()
    out["banded.loss"] = loss.detach().numpy()
    _aux("banded", aggregate_aux(aux, group), out)
    for k in GRADS:
        out[f"banded.grad.{k}"] = x[k].grad.numpy()


def _forward(mesh, d, out, margin, scene):
    """rasterize_sharded's image and counters for the arrays `<scene>.*`."""
    from d3ga_tpu_torch.dist.raster_shard import rasterize_sharded

    x = {k: torch.from_numpy(d[f"{scene}.{k}"]) for k in GRADS}
    img, aux = rasterize_sharded(
        mesh, x["means"], _camera(d, scene + "."), torch.from_numpy(d[scene + ".bg"]),
        cov3d=x["cov3d"], opacities=x["opacities"], colors=x["colors"], max_per_tile=K,
        dup=DUP, use_pallas=True, shard_select=True, front_margin=margin,
    )
    out[scene + ".img"] = img.numpy()
    _aux(scene, aux, out)
    return x


def skew(mesh, d, out, margin):
    _forward(mesh, d, out, margin, "skew")


def ties(mesh, d, out, margin):
    """The sharded image beside the single-device one (exact depth order)
    and the per-tile candidate counts."""
    from d3ga_tpu_torch.raster.tiles import bin_gaussians, rasterize_tiled

    x = _forward(mesh, d, out, margin, "ties")
    cam, bg = _camera(d, "ties."), torch.from_numpy(d["ties.bg"])
    leaves = (x["cov3d"], x["opacities"], x["colors"])
    out["ties.single"] = rasterize_tiled(
        x["means"], cam, bg, cov3d=leaves[0], opacities=leaves[1], colors=leaves[2],
        max_per_tile=K, use_pallas=True, coarse="dupsort_depth", dup=DUP,
        depth_exact=True)[0].numpy()
    out["ties.counts"] = bin_gaussians(x["means"], cam, *leaves, K, DUP).counts.numpy()


def halo(mesh, d, out, margin=None):
    from d3ga_tpu_torch.dist.banded import banded_mean, banded_psnr, banded_ssim
    from d3ga_tpu_torch.train.losses import masked_psnr, masked_ssim

    group, m, r = mesh.model_group, mesh.model, mesh.model_index
    pred, gt, mask = (torch.from_numpy(d["halo." + k]) for k in ("pred", "gt", "mask"))
    H = pred.shape[1]
    bh = -(-H // m)

    def band(img):
        return torch.nn.functional.pad(img, (0, 0, 0, m * bh - H))[:, r * bh : (r + 1) * bh]

    rows = r * bh + torch.arange(bh)
    valid = band(mask) * (rows < H).float()[None, :, None]
    pb, gb = band(pred) * valid, band(gt) * valid
    out["halo.banded"] = np.array([
        float(banded_ssim(pb, gb, valid, group, m)),
        float(banded_mean(torch.abs(pb - gb), valid, group)),
        float(banded_psnr(pb, gb, valid, group)),
    ])
    mfull = torch.broadcast_to(mask, pred.shape)
    out["halo.full"] = np.array([
        float(masked_ssim(pred * mask, gt * mask, mask)),
        float(torch.sum(torch.abs(pred - gt) * mfull) / torch.sum(mfull)),
        float(masked_psnr(pred * mask, gt * mask, mask)),
    ])


def mesh2x2(mesh, d, out, margin=None):
    """A 2 x 2 ("data", "model") mesh of the 4 ranks: this rank's
    coordinates and the sums of each rank's id over its two groups."""
    from d3ga_tpu_torch.dist.collectives import psum
    from d3ga_tpu_torch.dist.mesh import make_mesh

    m2 = make_mesh(2, 2)
    r = torch.tensor([float(dist.get_rank())])
    out["mesh.coords"] = np.array([m2.data_index, m2.model_index])
    out["mesh.sums"] = np.array([float(psum(r, m2.model_group)), float(psum(r, m2.data_group))])


CASES = {"gathered": gathered, "banded": banded, "skew": skew, "ties": ties, "halo": halo,
         "mesh": mesh2x2}


def run(rank, world, store, in_path, out_dir, cases):
    """Join the Gloo world through the file store, run `cases` (names with
    their front margins), write this rank's results."""
    warnings.filterwarnings("ignore", category=FutureWarning)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    from d3ga_tpu_torch.dist.mesh import initialize_distributed, make_mesh

    initialize_distributed(f"file://{store}", world, rank, device="cpu", timeout_s=120)
    try:
        mesh = make_mesh(1, world)
        d = dict(np.load(in_path))
        out = {}
        for name, margin in cases:
            CASES[name](mesh, d, out, margin)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
