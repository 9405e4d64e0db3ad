"""Parity of the PyTorch port's sharded rasterizer (`d3ga_tpu_torch/dist/`)
with the JAX package's, on the CPU.

The port runs on Gloo process groups of 2, 3 and 4 ranks, started with
the spawn method (`torch_dist_worker.py`, which imports no JAX); the JAX
package runs `rasterize_sharded` and `shard_map(rasterize_collective)` on
the conftest's virtual CPU devices. Both get the same numpy scene. One
group per world size runs all of that size's cases while the JAX
references compile, and hands its results back in .npz files.

  * world size 2: the gathered image with the full front-K exchange, the
    banded objective with a front margin, and a scene of tied depths
    beside the single-device raster; 3: the other way round
    (3 ranks pad both the Gaussians and the tiles: 20 tiles in bands of
    2 tile rows leave the third rank only padding tiles); 4: the skewed
    scene of tests/test_dist.py whose front-F exchange must trip
    `merge_overflow`, and a 2 x 2 ("data", "model") mesh; each: the halo
    SSIM, L1 and PSNR of random bands.

Tolerances. Integer counters are equal, -1 sentinels included;
`visible_overflow` is a float threshold (a tile's max T_bg > 1/255), so
the two packages could differ by a tile sitting at that threshold — none
does in these scenes, and it is compared exactly. Images: the sharded
port against the single-device port within atol 1e-5 (as
tests/test_dist.py holds the JAX package's); against the JAX package's
K5, whose bf16 hi/lo split matmuls are good to about 2^-17 relative and
which composites in the log domain, within the atol 1e-4 of the port's
other blend tests (tests/test_torch_raster.py); they differ by 1.8e-5 here.
Gradients of sum(img**2) and of the banded objective: rtol 1e-3 as
tests/test_dist.py:740 holds the JAX package's sharded gradients, with
its atol 2e-4 taken relative to each leaf's largest |gradient|: the
leaves span 1e-3 (the banded objective's colours) to 1e4 (the cov3d
gradient of sum(img**2), through 1/det of pixel-sized footprints), and
sums of float32 terms in another order (the reduce-scatter, the JAX
kernels' split matmuls) err in proportion to the largest terms, not to
each element (up to 5e-5 of the largest here). The scene's opacities
stay under 0.9, so raw = opacity * falloff never reaches the 0.99 clamp,
where the gradient jumps: a 1-ulp difference in a record would move a
pixel's whole share there (the K3/K5 tests exercise the clamp). The halo
SSIM equals the full-image SSIM within rtol 1e-5.

JAX side, each a configuration the JAX package itself runs, to keep
interpret-mode traces short: SELEXT "slice" (bit-identical to its
default "pallas" extraction, whose `pltpu.roll` has no JAX gradient —
ROADMAP.md, queue 3), `pallas_segsum.W` = 1280 lanes, K5 at one tile a
program (`pallas_blend_rec.TILES_PER_BLOCK`, a tiling choice), XLA
optimization level 0 (`torch_parity.jit_o0`).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import PartitionSpec as P

import d3ga_tpu.raster.pallas_blend_rec as jbrec
import d3ga_tpu.raster.pallas_segsum as jseg
import d3ga_tpu.raster.tiles as jtiles
import torch_dist_worker as worker
from d3ga_tpu.dist.banded import banded_mean, banded_ssim
from d3ga_tpu.dist.mesh import make_mesh
from d3ga_tpu.dist.raster_shard import rasterize_collective, rasterize_sharded
from d3ga_tpu.raster.camera import focal2fov
from d3ga_tpu_torch.dist.raster_shard import rasterize_collective as t_rasterize_collective
from d3ga_tpu_torch.raster import tiles as ttiles
from test_torch_raster import cameras, random_scene, selection_inputs
from torch_parity import jit_o0

W, H, N, C = 80, 64, 203, 6
K, DUP = worker.K, worker.DUP
MARGIN = 2  # F = 8 + 2 of K = 16 over 2 ranks: merge_overflow > 0 here
BG = np.array([0.3, 0.2, 0.1, 1.0, 0.0, 0.5], np.float32)
RUNS = {
    2: [("gathered", None), ("banded", MARGIN), ("ties", None), ("halo", None)],
    3: [("gathered", 8), ("banded", None), ("halo", None)],
    4: [("skew", 0), ("halo", None), ("mesh", None)],
}
GATHERED_GRADS = (2,)  # the banded objective's gradients are held at 2 and 3
JOIN_S = 150  # a hung collective fails the test instead of stalling the suite
IMG_ATOL, PORT_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 2e-4
SSIM_RTOL = 1e-5


def scene_inputs():
    """The scene (with its padded copy: one Gaussian behind the camera
    makes 204 = a multiple of 2, 3 and 4), the banded objective's target,
    the skewed scene and the halo test's images, as numpy arrays."""
    means, cov6, opac, colors = random_scene(11, N, W, H, c=C)
    opac *= 0.9  # raw = opacity * falloff stays under the 0.99 clamp
    rng = np.random.default_rng(12)
    d = {"scene.means": means, "scene.cov3d": cov6, "scene.opacities": opac,
         "scene.colors": colors, "scene.bg": BG,
         "scene.target": rng.uniform(0, 1, (C, H, W)).astype(np.float32),
         "scene.wh": np.array([W, H]),
         "scene.fov": np.array([focal2fov(max(W, H), W), focal2fov(max(W, H), H)])}
    behind = np.array([[0.0, 0.0, -100.0]], np.float32)  # camera_center - 100 * view z
    for k, fill in (("means", behind), ("cov3d", 0.0), ("opacities", 0.0), ("colors", 0.0)):
        a = d["scene." + k]
        d["padded." + k] = np.concatenate([a, np.broadcast_to(fill, (1,) + a.shape[1:])]).astype(
            np.float32)
    # tests/test_dist.py's skewed shards: 64 Gaussians near the centre,
    # ordered in depth along the shard axis, translucent
    n = 64
    d["skew.means"] = np.concatenate(
        [rng.uniform(-0.05, 0.05, (n, 2)), 4.0 + 0.001 * np.arange(n)[:, None]], -1
    ).astype(np.float32)
    d["skew.cov3d"] = np.tile(np.array([0.0025, 0, 0, 0.0025, 0, 0.0025], np.float32), (n, 1))
    d["skew.opacities"] = np.full((n, 1), 0.02, np.float32)
    d["skew.colors"] = rng.uniform(0, 1, (n, C)).astype(np.float32)
    d["skew.bg"] = np.zeros(C, np.float32)
    d["skew.wh"] = np.array([48, 32])
    d["skew.fov"] = np.array([focal2fov(60.0, 48), focal2fov(60.0, 32)])
    # 400 Gaussians within 0.0015 of depth 4 (a few quanta of the local
    # selection's 22-bit depth keys), translucent, 340 of them squeezed
    # into the middle columns: over-K tiles there tie, the edges stay within K
    means, cov6, opac, colors = random_scene(1, 400, W, H, c=C)
    means = means / means[:, 2:3] * np.float32(4.0)
    means[:340, 0] *= 0.3
    means[:, 2] += np.random.default_rng(1).uniform(0, 0.0015, 400).astype(np.float32)
    d.update({"ties.means": means, "ties.cov3d": cov6, "ties.opacities": opac * 0.5,
              "ties.colors": colors, "ties.bg": np.ones(C, np.float32),
              "ties.wh": d["scene.wh"], "ties.fov": d["scene.fov"]})
    # tests/test_dist.py's halo test: H not divisible by the bands
    d["halo.pred"] = rng.uniform(0, 1, (3, 61, 40)).astype(np.float32)
    d["halo.gt"] = rng.uniform(0, 1, (3, 61, 40)).astype(np.float32)
    d["halo.mask"] = (rng.uniform(0, 1, (1, 61, 40)) > 0.2).astype(np.float32)
    return d


def jax_camera(d, prefix):
    from d3ga_tpu.raster.camera import make_camera

    w, h = (int(v) for v in d[prefix + "wh"])
    fx, fy = (float(v) for v in d[prefix + "fov"])
    return make_camera(np.eye(3), np.zeros(3), fx, fy, w, h)


def jax_gathered(d, m, margin):
    """rasterize_sharded's image and counters, with the gradients of
    sum(img**2) at the world sizes of GATHERED_GRADS."""
    mesh, cam = make_mesh(1, m), jax_camera(d, "scene.")

    def loss(means, cov, op, col):
        img, aux = rasterize_sharded(
            mesh, means, cam, jnp.asarray(BG), cov3d=cov, opacities=op, colors=col,
            max_per_tile=K, dup=DUP, use_pallas=True, shard_select=True, front_margin=margin,
        )
        return jnp.sum(img**2), (img, aux)

    args = tuple(jnp.asarray(d["scene." + k]) for k in worker.GRADS)
    if m not in GATHERED_GRADS:
        _, (img, aux) = jit_o0(loss, *args)(*args)
        return {"img": np.asarray(img), "aux": aux}
    fn = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)
    (_, (img, aux)), grads = jit_o0(fn, *args)(*args)
    return {"img": np.asarray(img), "aux": aux, "grads": [np.asarray(g) for g in grads]}


def jax_banded(d, m, margin):
    """shard_map(rasterize_collective(banded=True)) and bench_scaling.py's
    banded objective (0.8 L1 + 0.2 (1 - SSIM)): the bands, counters, loss
    and gradients."""
    mesh, cam = make_mesh(1, m), jax_camera(d, "scene.")
    nty = -(-H // 16)
    bh = -(-nty // m) * 16  # tile rows per band, in pixels
    target = jnp.pad(jnp.asarray(d["scene.target"]), ((0, 0), (0, m * bh - H), (0, 0)))

    def body(means, cov, op, col):
        band, aux = rasterize_collective(
            means, cam, jnp.asarray(BG), axis="model", n_shards=m, cov3d=cov, opacities=op,
            colors=col, max_per_tile=K, dup=DUP, use_pallas=True, banded=True,
            shard_select=True, front_margin=margin,
        )
        my = jax.lax.axis_index("model")
        rows = my * bh + jnp.arange(bh)
        valid = (rows < H).astype(jnp.float32)[None, :, None]
        tgt = jax.lax.dynamic_slice_in_dim(target, my * bh, bh, axis=1)
        l1 = banded_mean(jnp.abs(band - tgt) * valid, valid, "model")
        s = banded_ssim(band * valid, tgt * valid, valid, "model", m)

        def agg(x, reduce=jax.lax.psum):
            x = jnp.asarray(x)
            return jnp.where(x < 0, x, reduce(jnp.maximum(x, 0), "model"))

        aux = {f: agg(getattr(aux, f), jax.lax.pmax if f == "max_per_tile" else jax.lax.psum)
               for f in aux._fields}
        return 0.8 * l1 + 0.2 * (1.0 - s), (band, aux)

    sharded = jax.shard_map(
        body, mesh=mesh, in_specs=(P("model"),) * 4,
        out_specs=(P(), (P(None, "model"), P())), check_vma=False,
    )
    fn = jax.value_and_grad(sharded, argnums=(0, 1, 2, 3), has_aux=True)
    args = tuple(jnp.asarray(d["padded." + k]) for k in worker.GRADS)
    (loss, (bands, aux)), grads = jit_o0(fn, *args)(*args)
    return {"bands": np.asarray(bands), "aux": aux, "loss": float(loss),
            "grads": [np.asarray(g) for g in grads]}


def jax_forward(d, m, margin, scene):
    """rasterize_sharded's image and counters for the arrays `<scene>.*`."""
    mesh, cam = make_mesh(1, m), jax_camera(d, scene + ".")

    def fwd(means, cov, op, col):
        return rasterize_sharded(
            mesh, means, cam, jnp.asarray(d[scene + ".bg"]), cov3d=cov, opacities=op,
            colors=col, max_per_tile=K, dup=DUP, use_pallas=True, shard_select=True,
            front_margin=margin,
        )

    args = tuple(jnp.asarray(d[f"{scene}.{k}"]) for k in worker.GRADS)
    img, aux = jit_o0(fwd, *args)(*args)
    return {"img": np.asarray(img), "aux": aux}


JAX_CASES = {
    "gathered": jax_gathered, "banded": jax_banded,
    "skew": lambda d, m, margin: jax_forward(d, m, margin, "skew"),
    "ties": lambda d, m, margin: jax_forward(d, m, margin, "ties"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{m: (the port's per-rank results, {case: JAX reference})}."""
    tmpdir = tmp_path_factory.mktemp("dist")
    d = scene_inputs()
    in_path = str(tmpdir / "inputs.npz")
    np.savez(in_path, **d)
    ctx = tmp.get_context("spawn")
    procs = {}
    for m, cases in RUNS.items():
        (tmpdir / f"m{m}").mkdir()
        procs[m] = [
            ctx.Process(target=worker.run, daemon=True, args=(
                r, m, str(tmpdir / f"store{m}"), in_path, str(tmpdir / f"m{m}"), cases))
            for r in range(m)
        ]
        for p in procs[m]:
            p.start()
    mp = pytest.MonkeyPatch()
    mp.setattr(jtiles, "SELEXT", "slice")
    mp.setattr(jseg, "W", 1280)
    mp.setattr(jbrec, "TILES_PER_BLOCK", 1)
    try:
        refs = {
            m: {name: JAX_CASES[name](d, m, margin) for name, margin in cases if name in JAX_CASES}
            for m, cases in RUNS.items()
        }
    finally:
        mp.undo()
    deadline = time.monotonic() + JOIN_S
    for ps in procs.values():
        for p in ps:
            p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for ps in procs.values() for p in ps if p.is_alive()]
    for p in hung:
        p.terminate()
    assert not hung, f"{len(hung)} ranks did not finish within {JOIN_S} s"
    assert all(p.exitcode == 0 for ps in procs.values() for p in ps), "a rank failed"
    out = {}
    for m in RUNS:
        ranks = [dict(np.load(tmpdir / f"m{m}" / f"rank{r}.npz")) for r in range(m)]
        out[m] = (ranks, refs[m])
    return out


def grad_close(g, ref, name):
    """rtol 1e-3 with atol 2e-4 of the leaf's largest |gradient| (see the
    module docstring)."""
    scale = float(np.abs(ref).max())
    assert scale > 0.0, name
    np.testing.assert_allclose(g, ref, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * scale, err_msg=name)


def aux_of(ranks, case, field):
    vals = {int(r[f"{case}.aux.{field}"]) for r in ranks}
    assert len(vals) == 1, (case, field, vals)  # the same on every rank
    return vals.pop()


def check_aux(ranks, case, jaux):
    jaux = jaux if isinstance(jaux, dict) else jaux._asdict()
    assert len(jaux) == 7
    for f, v in jaux.items():
        assert aux_of(ranks, case, f) == int(v), f


def same_on_ranks(ranks, key):
    for r in ranks[1:]:
        assert np.array_equal(r[key], ranks[0][key]), key
    return ranks[0][key]


@pytest.mark.parametrize("m", [2, 3])
def test_gathered_image_and_counters_match_jax(runs, m):
    ranks, refs = runs[m]
    img = same_on_ranks(ranks, "gathered.img")
    assert img.shape == (C, H, W)
    np.testing.assert_allclose(img, refs["gathered"]["img"], rtol=0, atol=IMG_ATOL)
    check_aux(ranks, "gathered", refs["gathered"]["aux"])
    assert aux_of(ranks, "gathered", "overflow") > 0  # the K cap is exercised
    # computed only with a front margin (world size 3 here)
    assert (aux_of(ranks, "gathered", "merge_overflow") >= 0) == (m == 3)


@pytest.mark.parametrize("m", [2, 3])
def test_gathered_matches_single_device_port(runs, m):
    """Exact whenever merge_overflow reports no possible miss."""
    ranks, _ = runs[m]
    assert aux_of(ranks, "gathered", "merge_overflow") <= 0
    img = same_on_ranks(ranks, "gathered.img")
    np.testing.assert_allclose(img, ranks[0]["single.img"], rtol=0, atol=PORT_ATOL)
    for f in ("overflow", "max_per_tile", "n_contrib", "visible_overflow"):
        assert aux_of(ranks, "gathered", f) == aux_of(ranks, "single", f), f
    for k in worker.GRADS:
        grad_close(ranks[0][f"gathered.grad.{k}"], ranks[0][f"single.grad.{k}"], k)


@pytest.mark.parametrize("m", GATHERED_GRADS)
def test_gathered_gradients_match_jax(runs, m):
    ranks, refs = runs[m]
    for k, jg in zip(worker.GRADS, refs["gathered"]["grads"]):
        grad_close(same_on_ranks(ranks, f"gathered.grad.{k}"), jg, k)


@pytest.mark.parametrize("m", [2, 3])
def test_banded_bands_and_counters_match_jax(runs, m):
    ranks, refs = runs[m]
    bands = np.concatenate([r["banded.band"] for r in ranks], axis=1)
    assert bands.shape == refs["banded"]["bands"].shape
    np.testing.assert_allclose(bands, refs["banded"]["bands"], rtol=0, atol=IMG_ATOL)
    check_aux(ranks, "banded", refs["banded"]["aux"])
    assert (aux_of(ranks, "banded", "merge_overflow") >= 0) == (m == 2)


@pytest.mark.parametrize("m", [2, 3])
def test_banded_objective_and_gradients_match_jax(runs, m):
    ranks, refs = runs[m]
    loss = float(same_on_ranks(ranks, "banded.loss"))
    np.testing.assert_allclose(loss, refs["banded"]["loss"], rtol=1e-5)
    for k, jg in zip(worker.GRADS, refs["banded"]["grads"]):
        grad_close(np.concatenate([r[f"banded.grad.{k}"] for r in ranks]), jg, k)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_halo_ssim_equals_full_ssim(runs, m):
    ranks, _ = runs[m]
    for r in ranks:
        np.testing.assert_allclose(r["halo.banded"], r["halo.full"], rtol=SSIM_RTOL)


def test_mesh_2x2_lays_out_ranks_like_jax(runs):
    """make_mesh(2, 2) on 4 ranks: rank r sits where the JAX package's
    make_mesh(2, 2) puts device r; psum over the "model" group sums the
    ranks of its row, over the "data" group those of its column."""
    ranks, _ = runs[4]
    jdev = np.vectorize(lambda dv: dv.id)(make_mesh(2, 2).devices)
    ids = np.arange(4).reshape(2, 2)
    for r, res in enumerate(ranks):
        d_i, m_i = (int(v) for v in res["mesh.coords"])
        assert jdev[d_i, m_i] == jax.devices()[r].id
        assert list(res["mesh.sums"]) == [ids[d_i].sum(), ids[:, m_i].sum()]


def test_front_margin_trips_on_skewed_shards(runs):
    """K 16 over 4 ranks with margin 0 ships F = 4 entries a shard, but the
    front 16 of the central tiles are all shard 0's."""
    ranks, refs = runs[4]
    check_aux(ranks, "skew", refs["skew"]["aux"])
    assert aux_of(ranks, "skew", "merge_overflow") > 0
    img = same_on_ranks(ranks, "skew.img")
    np.testing.assert_allclose(img, refs["skew"]["img"], rtol=0, atol=IMG_ATOL)


def test_over_k_tiles_cut_by_depth_quantum(runs):
    """The local selection orders candidates by quantized depth with index
    tie-breaks (so does the JAX package's); where a tile holds more than K
    candidates, it can cut a different K-th entry than the single-device
    exact depth order. The port matches the JAX package everywhere, and
    the single-device port on every tile within K."""
    ranks, refs = runs[2]
    img = same_on_ranks(ranks, "ties.img")
    np.testing.assert_allclose(img, refs["ties"]["img"], rtol=0, atol=IMG_ATOL)
    check_aux(ranks, "ties", refs["ties"]["aux"])
    counts = ranks[0]["ties.counts"].reshape(-(-H // 16), -(-W // 16))
    within = np.repeat(np.repeat(counts <= K, 16, 0), 16, 1)[:H, :W]
    assert 0 < within.mean() < 1
    err = np.abs(img - ranks[0]["ties.single"])
    assert float(err[:, within].max()) <= PORT_ATOL
    assert float(err[:, ~within].max()) > 1e-2  # a tie cut differently, visibly


@pytest.mark.parametrize("depth_exact", [False, True])
def test_select_returns_depths_like_jax(depth_exact):
    """_select_per_tile_depthkey(return_depth=True): ids, counts, counters
    and the depth payload's windows (inf past counts) equal to the JAX
    package's."""
    ntx, nty = 6, 5
    rects, valid, depth = selection_inputs(4, 500, ntx, nty)
    args = (tuple(jnp.asarray(r) for r in rects), jnp.asarray(valid), jnp.asarray(depth))
    j = jit_o0(lambda r, v, dp: jtiles._select_per_tile_depthkey(
        r, v, dp, ntx, nty, 24, dup=DUP, return_depth=True, depth_exact=depth_exact), *args)(*args)
    t = ttiles._select_per_tile_depthkey(
        tuple(torch.from_numpy(r) for r in rects), torch.from_numpy(valid),
        torch.from_numpy(depth), ntx, nty, 24, dup=DUP, return_depth=True,
        depth_exact=depth_exact,
    )
    assert len(t) == len(j) == 5
    for a, b in zip(t, j):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.isinf(t[4].numpy()[t[0].numpy() < 0]).all()


def test_unported_options_raise():
    _, tcam = cameras(32, 32)
    x = torch.zeros(4, 3)
    for kw in (dict(use_pallas=False, shard_select=True), dict(use_pallas=True)):
        with pytest.raises(NotImplementedError, match="Non-champion raster variants"):
            t_rasterize_collective(x, tcam, torch.ones(3), None, 1, cov3d=torch.zeros(4, 6),
                                   opacities=torch.ones(4, 1), colors=torch.ones(4, 3), **kw)
