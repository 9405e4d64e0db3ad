"""K9's and K8's forwards on the batched walk (`csrc/coeff_walk_fwd.cuh`):
what the CPU can hold of them.

- K8's plain forward on `chip_smoke.k8_edge_cases` (K9's edge inputs as
  `fused._tile_inputs` makes K8's inputs of them, and whole-K tiles with
  opacity-0 padding, at C 3 and 6) against the JAX package's
  `pallas_blend.py::_run_forward` in interpret mode: the image within
  test_torch_blend_coeffs.py's tolerances (p999 abs <= 1e-5, at most 0.1%
  of values off by 1e-3: the JAX kernel's bf16 hi/lo split matmuls and the
  threshold flips), and on K9_ON_THRESHOLD's tiles, whose alpha tests
  decide by rounding, by `flip_close` (p999 within 1e-5 of the largest
  value, the same flip share).
- K8's band cull: `chip_smoke.coeff_cull_bands`, blend_coeffs.cu's bound
  from the coefficients in float32, keeps every 2-row band where the plain
  forward would take a (pixel, slot) pair, on the faint cases and on
  seeded random tiles; it drops opacity-0 slots and keeps every band of a
  slot not concave in dx.
- K9's forward, whose staging is its backward's (coeff_walk_bwd.cuh::
  cb_stage): the plain forward's used pairs on every `k9_edge_cases` case
  lie inside the bands `chip_smoke.cull_bands` computes for that staging.
- The new entry points (the `_v1` baselines and the stage cuts) refuse
  CPU tensors, and the cuts and batch variants take C 6 only.

The kernels run only on the card: the test marked `cuda` runs
chip_smoke.py's checks (bit-equal to the `_v1`s and to the unculled
builds) and skips without a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from d3ga_tpu.raster import pallas_blend as jpb
from d3ga_tpu_torch.raster import blend, fused
from test_torch_blend_coeffs import image_close
from test_torch_raster_bwd import flip_close
from torch_parity import jit_o0

K = chip_smoke.K9_EDGE_K
K8_CASES = {c[0]: c for c in chip_smoke.k8_edge_cases(torch.device("cpu"))}
K9_CASES = {c[0]: c for c in chip_smoke.k9_edge_cases(torch.device("cpu"))}
FAINT = [n for n in K8_CASES if "faint" in n or n.startswith(chip_smoke.K8_PADDING)]


@pytest.fixture(scope="module")
def jax_fwd():
    """The JAX kernel's [T, 256, C+1] for every K8 case: the cases of one C
    concatenated along the tiles, one interpret call each."""
    out = {}
    for C in (3, 6):
        names = [n for n in K8_CASES if K8_CASES[n][4] == C]
        args = [jnp.asarray(np.concatenate([K8_CASES[n][i].numpy() for n in names]))
                for i in (1, 2, 3)]
        run = jit_o0(lambda co, col, op: jpb._run_forward(co, col, op, interpret=True), *args)
        o = np.asarray(run(*args))
        t = 0
        for n in names:
            T = K8_CASES[n][1].shape[0]
            out[n] = o[t : t + T]
            t += T
    return out


def test_k8_cases_cover_the_edges():
    """Every K9 edge case at C 3 and 6, and the padding case: tiles of
    count 0 and K, padding slots with coefficients but no opacity, slots
    not concave in dx."""
    assert len(K8_CASES) == 2 * (len(K9_CASES) + 1)
    assert {c[4] for c in K8_CASES.values()} == {3, 6}
    _, co, _, op, _ = K8_CASES[f"{chip_smoke.K8_PADDING} at C=6"]
    live = (op[:, 0] > 0).sum(-1)
    assert int(live.min()) == 0 and int(live.max()) == K
    dead = op[:, 0] == 0
    assert bool((co[dead][:, :6] != 0).any(-1).all())
    assert bool(((co[..., 3] >= 0) & ~dead).any())


@pytest.mark.parametrize("name", list(K8_CASES))
def test_k8_plain_matches_pallas_kernel(name, jax_fwd):
    _, co, col, op, C = K8_CASES[name]
    out = blend.blend_tiles_coeffs_plain(co, col, op).numpy()
    assert out.shape == jax_fwd[name].shape == (co.shape[0], 256, C + 1)
    if name.startswith(chip_smoke.K9_ON_THRESHOLD):
        flip_close(out, jax_fwd[name])
    else:
        image_close(out, jax_fwd[name])


def taken_bands(co, op, visited_only=False):
    """[T, K, 8] the 2-row bands where the plain forward takes each slot at
    some pixel (power <= 0 and raw >= 1/255; with visited_only, before the
    pixel's stop)."""
    Kk = co.shape[1]
    f = blend._forward_chunk(co, op, blend._pixel_basis("cpu"), torch.triu(torch.ones((Kk, Kk))))
    use = f["use"] & (op > 0)
    if visited_only:
        use = use & (f["t_before"] >= blend.T_EPS)
    return use.reshape(-1, 8, 32, Kk).any(2).permute(0, 2, 1)


@pytest.mark.parametrize("name", FAINT)
def test_k8_band_bound_keeps_every_taken_band(name):
    _, co, _, op, _ = K8_CASES[name]
    taken = taken_bands(co, op)
    bands = chip_smoke.coeff_cull_bands(co, op)
    live = op[:, 0] > 0
    assert not bool((taken & ~bands).any())
    assert bool(taken.any()) and not bool(bands[live].all())
    assert not bool(bands[~live].any())


@pytest.mark.parametrize("seed", range(4))
def test_k8_band_bound_on_random_tiles(seed):
    """Seeded random tiles: Gaussians of 0.5-20 px, centres around and off
    the tile, opacities log-uniform in [1e-3, 1] (faint ones whose edge
    crosses the tile), a few slots not concave in dx and a few of opacity
    0."""
    rng = np.random.default_rng(100 + seed)
    T, Kk = 32, 64
    xy = rng.uniform(-40, 56, (T, Kk, 2))
    s = np.exp(rng.uniform(np.log(0.5), np.log(20.0), (T, Kk, 2)))
    th = rng.uniform(0, np.pi, (T, Kk))
    c, sn = np.cos(th), np.sin(th)
    a, b = 1 / s[..., 0] ** 2, 1 / s[..., 1] ** 2
    conic = np.stack([c * c * a + sn * sn * b, c * sn * (a - b), sn * sn * a + c * c * b], -1)
    co = blend.falloff_coeffs(torch.from_numpy(xy).float(), torch.from_numpy(conic).float())
    flat = torch.from_numpy(rng.uniform(size=(T, Kk)) < 0.05)
    co[..., 3][flat] = float(rng.uniform(0.0, 0.05))
    co[..., 0][flat] = -4.0
    op = np.exp(rng.uniform(np.log(1e-3), 0.0, (T, Kk)))
    op[rng.uniform(size=(T, Kk)) < 0.05] = 0.0
    op = torch.from_numpy(op).float()[:, None, :]
    taken = taken_bands(co, op)
    bands = chip_smoke.coeff_cull_bands(co, op)
    assert not bool((taken & ~bands).any())
    assert bool(bands[flat & (op[:, 0] > 0)].all())
    assert bool(taken.any()) and not bool(bands.all())


@pytest.mark.parametrize("name", list(K9_CASES))
def test_k9_forward_pairs_inside_staged_bands(name):
    """The plain forward's used pairs (before each pixel's stop) lie in the
    bands of K9's staging (cb_stage's bound, `chip_smoke.cull_bands`)."""
    _, vals, rects, _, C = K9_CASES[name]
    co, _, op, slot, _, hit, _ = fused._tile_inputs(vals, rects, K, C)
    nb = vals.shape[0]
    taken = taken_bands(co, op, visited_only=True).reshape(nb, 64, -1, 8) & hit[..., None]
    sx, sy = fused._tile_origins("cpu")
    bands = chip_smoke.cull_bands(slot, torch.stack([sx, sy], -1)[None, :, None, :])
    assert not bool((taken & ~bands).any())
    assert bool(taken.any()) or name.startswith("opacity 0")


def test_k8_work_counts_the_cull():
    """`chip_smoke.coeff_work`'s (slot, warp) pairs: four a live slot, those
    the cull takes fewer; K9's `fused_work` counts its own cull apart."""
    _, co, _, op, _ = K8_CASES[f"{chip_smoke.K8_PADDING} at C=3"]
    w = chip_smoke.coeff_work(co, op)
    assert w["warp_slots"] == 4 * int((op > 0).sum())
    assert 0 < w["warp_slots_taken"] < w["warp_slots"]
    assert set(chip_smoke.coeff_work(co, op, cull=False)) == {"visited", "used"}


@pytest.mark.parametrize("kernel", ["K9", "K8"])
def test_baselines_and_stages_need_the_card(kernel):
    """The `_v1` baseline and every (design, stage) cut raise on CPU
    tensors; unknown designs and stages, the cuts of the designs built
    whole only, and the cuts and batch variants at another C than
    STAGE_C, raise."""
    if kernel == "K9":
        mod = fused
        _, vals, rects, _, C = K9_CASES["C=6, 1 block"]
        base = lambda: fused.select_blend_baseline(vals, rects, K, C)  # noqa: E731
        cut = lambda st, d: fused.select_blend_stage(vals, rects, K, C, st, design=d)  # noqa: E731
        _, vals8, rects8, _, C8 = K9_CASES["C=8, 1 block"]
        cut8 = lambda st, d: fused.select_blend_stage(  # noqa: E731
            vals8, rects8, K, C8, st, design=d)
        counts = (fused.fwd_baseline_launches, fused.fwd_stage_launches)
    else:
        mod = blend
        _, co, col, op, C = K8_CASES[f"{chip_smoke.K8_PADDING} at C=6"]
        base = lambda: blend.blend_tiles_coeffs_baseline(co, col, op)  # noqa: E731
        cut = lambda st, d: blend.blend_tiles_coeffs_stage(co, col, op, st, design=d)  # noqa: E731
        _, co3, col3, op3, _ = K8_CASES[f"{chip_smoke.K8_PADDING} at C=3"]
        cut8 = lambda st, d: blend.blend_tiles_coeffs_stage(  # noqa: E731
            co3, col3, op3, st, design=d)
        counts = (blend.baseline_launches, blend.stage_launches)
    assert C == mod.STAGE_C
    whole = len(mod.FWD_STAGES) - 1
    with pytest.raises(ValueError, match="CUDA"):
        base()
    for d in mod.FWD_DESIGNS:
        for st in range(len(mod.FWD_STAGES)):
            cut_short = d != "kernel" and st < whole
            with pytest.raises(ValueError, match=f"stage {whole}" if cut_short else "CUDA"):
                cut(st, d)
    for st, d in ((3, "kernel"), (-1, "kernel"), (whole, "kernel_r3"), (whole, "baseline")):
        with pytest.raises(ValueError, match="stage"):
            cut(st, d)
    for st, d in ((0, "kernel"), (1, "kernel"), (whole, "kernel_r1"), (whole, "kernel_r4")):
        with pytest.raises(ValueError, match=f"C = {mod.STAGE_C} only"):
            cut8(st, d)
    for d in ("kernel", "kernel_no_cull"):  # whole, at any C: refused as CPU tensors only
        with pytest.raises(ValueError, match="CUDA"):
            cut8(whole, d)
    assert counts[0] == 0 and not any(counts[1].values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_forward_edges_on_card(cuda_device):
    """chip_smoke.py's forward checks on the card: K9's and K8's tiles
    bit-equal across launches, to their `_v1`s, to their unculled builds
    and (at C 6) to R = 1, 2, 4; within the image tolerances of plain."""
    assert chip_smoke.check_k9_fwd_edges(cuda_device, lambda msg: None) == len(K9_CASES)
    assert chip_smoke.check_k8_edges(cuda_device, lambda msg: None) == len(K8_CASES)
