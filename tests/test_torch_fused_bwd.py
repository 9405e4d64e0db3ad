"""K9's backward (`raster/fused.py::select_blend_bwd`) on its edge inputs,
`chip_smoke.k9_edge_cases` (K 256, 384 candidates a block: tiles whose
uncapped count is 0, 1, 255, 256 and 300 among candidates whose rect
misses them; every pixel of a row stopped at the third slot; raw >= 0.99;
opacity 0 and invalid candidates; faint candidates whose ellipse reaches
each row of their tile, inside the alpha threshold op * exp(power) >=
1/255 there and on it; C in {1, 3, 6, 8}).

On the CPU the plain backward is held against the JAX package's two
kernels in interpret mode: `attic/pallas_fused.py::_run_backward` (v1) on
every case, the one on the threshold too (the cases of one C go as the
blocks of one call), and `attic/pallas_fused2.py::_run_backward` (v2) on
the counts case, whose compaction is v2's own. Both are compiled at
XLA's default level (at level 0 v2's interpret run takes ~9 s a block at
this K, at the default 0.15 s). Tolerance, as test_torch_fused.py's:
`flip_close` (p999 error within 1e-5 of the largest |d(vals)|, at most
0.1% of the values off by more than 1e-3 of it): the JAX kernels sum in
another order (matmuls over the basis and the triangular ones matrix),
and the alpha >= 1/255 and T < 1e-4 tests flip where a pixel lies on
them. On the threshold case, whose alpha tests decide by rounding, the
plain backward agrees with v1 because it rounds as v1's backward does:
its tile-local coefficients as XLA-CPU contracts them there
(`fused._bwd_coeffs`), its power as one float32 product, and exp(power)
near the thresholds as XLA-CPU's (`ops/fexp.py`). The card holds the
kernel there bit for bit against itself with the band cull off.

The CUDA kernels run only on the card: the test marked `cuda` runs
chip_smoke.py's K9 edge checks and skips without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from d3ga_tpu.raster.attic import pallas_fused as jf1
from d3ga_tpu.raster.attic import pallas_fused2 as jf2
from d3ga_tpu_torch import probes
from d3ga_tpu_torch.raster import blend, fused
from test_torch_raster_bwd import flip_close

CASES = {c[0]: c for c in chip_smoke.k9_edge_cases(torch.device("cpu"))}
K = chip_smoke.K9_EDGE_K
COUNTS = "counts 0/1/255/256/300, rects that miss the tile"
JAX_CASES = list(CASES)

_PLAIN = {}


def plain_dvals(name):
    """The plain backward's d(vals) [NB, kb, 16] on case `name` (once)."""
    if name not in _PLAIN:
        _, vals, rects, g, C = CASES[name]
        _PLAIN[name] = fused.select_blend_bwd_plain(vals, rects, g, K, C).numpy()
    return _PLAIN[name]


def v1_layout(vals, rects):
    nb, kb, _ = vals.shape
    return (np.ascontiguousarray(vals.reshape(nb, kb // 128, 128, 16).transpose(0, 1, 3, 2)),
            np.ascontiguousarray(rects.reshape(nb, kb // 128, 128)))


@pytest.fixture(scope="module")
def jax_v1():
    """v1's d(vals), records-major, for every JAX-held case: the cases of
    one C concatenated along the blocks, one interpret call each."""
    out = {}
    for C in sorted({CASES[n][4] for n in JAX_CASES}):
        names = [n for n in JAX_CASES if CASES[n][4] == C]
        vals, rects = v1_layout(np.concatenate([CASES[n][1].numpy() for n in names]),
                                np.concatenate([CASES[n][2].numpy() for n in names]))
        g = np.concatenate([CASES[n][3].numpy() for n in names])
        args = tuple(jnp.asarray(a) for a in (vals, rects, g))
        run = jax.jit(lambda v, r, gg, C=C: jf1._run_backward(v, r, gg, K, C, True))
        dv = fused._records(torch.from_numpy(np.array(run(*args)))).numpy()
        b = 0
        for n in names:
            nb = CASES[n][1].shape[0]
            out[n] = dv[b : b + nb]
            b += nb
    return out


def test_cases_cover_the_edges():
    """The counts case's first row holds 0, 1, 255, 256 and 300 (> K);
    every C of {1, 3, 6, 8}; every named kind is JAX-held, the case on the
    threshold too."""
    _, _, rects, _, _ = CASES[COUNTS]
    _, counts = fused._select(rects, K)
    assert counts[0, :5].tolist() == [0, 1, 255, 256, 300]
    assert {c[4] for c in CASES.values()} == {1, 3, 6, 8}
    for kind in ("third slot", "raw >= 0.99", "opacity 0", "inside the band edges", "2 blocks"):
        assert any(kind in n for n in JAX_CASES), kind
    assert chip_smoke.K9_ON_THRESHOLD in JAX_CASES and set(JAX_CASES) == set(CASES)


@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_bwd_matches_v1_kernel(name, jax_v1):
    t = plain_dvals(name)
    assert t.shape == jax_v1[name].shape
    flip_close(t, jax_v1[name])


def test_plain_bwd_matches_v2_kernel():
    """v2 (butterfly compaction) on the counts case."""
    _, vals, rects, g, C = CASES[COUNTS]
    v2 = (np.ascontiguousarray(vals.numpy().transpose(0, 2, 1)), rects.numpy()[:, None, :])
    args = tuple(jnp.asarray(a) for a in (*v2, g.numpy()))
    run = jax.jit(lambda v, r, gg: jf2._run_backward(v, r, gg, K, C, True))
    dv = np.asarray(run(*args)).transpose(0, 2, 1)
    flip_close(plain_dvals(COUNTS), dv)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_bwd_structure(name):
    """Every case: finite; no cotangent in the padding channels or for
    the candidates no tile selects (among them every invalid one)."""
    _, vals, rects, _, C = CASES[name]
    d = torch.from_numpy(plain_dvals(name))
    assert bool(torch.isfinite(d).all())
    assert float(d[..., 6 + C :].abs().max()) == 0.0
    lanes, _ = fused._select(rects, K)
    nb, kb = rects.shape
    picked = torch.zeros(nb, kb + 1, dtype=torch.bool).scatter_(
        1, lanes.reshape(nb, -1), True)[:, :kb]
    assert bool((d[~picked] == 0).all())
    assert float(d[picked].abs().max()) > 0.0


def test_third_slot_stops_every_pixel():
    """The opaque wide candidates stop every pixel of row 0 at its tile's
    third slot: T_bg is the transmittance after two of them."""
    _, vals, rects, _, C = CASES["every pixel of row 0 stopped at the third slot"]
    tiles, _ = fused.select_blend_plain(vals, rects, K, C)
    t_bg = tiles[0, :8, :, C]
    assert float(t_bg.max()) < 1e-3 and float(t_bg.min()) > 1e-4


@pytest.mark.parametrize("name", [chip_smoke.K9_INSIDE_THRESHOLD, chip_smoke.K9_ON_THRESHOLD])
def test_cull_bound_keeps_every_used_band(name):
    """The backward's band cull (coeff_walk_bwd.cuh's bound, as
    chip_smoke.cull_bands computes it in float32) marks every 2-row band
    where the plain forward uses a faint candidate; the faint candidates
    are used in every band of their tiles and skipped in some."""
    _, vals, rects, _, C = CASES[name]
    coeffs, _, opacs, slot, _, hit, _ = fused._tile_inputs(vals, rects, K, C)
    U = torch.triu(torch.ones((K, K)))
    f = blend._forward_chunk(coeffs, opacs, blend._pixel_basis("cpu"), U)
    used = (f["use"] & (f["t_before"] >= blend.T_EPS)).reshape(1, 64, 8, 32, K).any(3)
    used = used.permute(0, 1, 3, 2) & hit[..., None]  # [1, 64, K, 8]
    sx, sy = fused._tile_origins("cpu")
    bands = chip_smoke.cull_bands(slot, torch.stack([sx, sy], -1)[None, :, None, :])
    assert not bool((used & ~bands).any())
    assert bool(used[0, :8].any(1).all()) and not bool(bands[hit].all())


def test_work_counts_used_pairs_apart():
    """chip_smoke's `fused_work`, which K9's bounds charge: its visited
    pairs are the plain forward's count, its used ones fewer; the cull's
    (slot, warp) pairs lie within the live slots'. `probes.coeff_bound`
    charges the unused pairs the test's cost only."""
    _, vals, rects, _, C = CASES["C=6, 1 block"]
    w = chip_smoke.fused_work(vals, rects, K, C)
    _, _, pairs = fused.select_blend_plain(vals, rects, K, C, count_pairs=True)
    assert w["visited"] == pairs and 0 < w["used"] < w["visited"]
    assert 0 < w["warp_slots_taken"] < w["warp_slots"]
    ms, by, t = probes.coeff_bound(0, w["used"], w["visited"] - w["used"], 59, 2)
    assert by == "operations" and t["bytes"] == 0
    fp32 = (w["used"] * 59 + (w["visited"] - w["used"]) * probes.COEFF_TEST_FP32_OPS_PER_PAIR)
    sfu = w["used"] * 2 + (w["visited"] - w["used"]) * probes.COEFF_TEST_SFU_PER_PAIR
    assert ms == pytest.approx(1e3 * max(fp32 / probes.FP32_OPS_PER_S, sfu / probes.SFU_OPS_PER_S))


def test_baseline_and_stages_need_the_card():
    """The baseline and every (design, stage) cut raise on CPU tensors;
    unknown designs and stages, the cuts of the designs built whole only,
    and the cuts and pixel variants at another C than STAGE_C, raise."""
    _, vals, rects, g, C = CASES["C=6, 1 block"]
    assert C == fused.STAGE_C
    whole = len(fused.BWD_STAGES) - 1
    with pytest.raises(ValueError, match="CUDA"):
        fused.select_blend_bwd_baseline(vals, rects, g, K, C)
    for d in fused.BWD_DESIGNS:
        for st in range(len(fused.BWD_STAGES)):
            cut_short = d != "kernel" and st < whole
            with pytest.raises(ValueError, match=f"stage {whole}" if cut_short else "CUDA"):
                fused.select_blend_bwd_stage(vals, rects, g, K, C, st, design=d)
    for st, d in ((5, "kernel"), (-1, "kernel"), (whole, "kernel_p3"), (whole, "baseline")):
        with pytest.raises(ValueError, match="stage"):
            fused.select_blend_bwd_stage(vals, rects, g, K, C, st, design=d)
    _, vals, rects, g, C = CASES["C=8, 1 block"]
    for st, d in ((0, "kernel"), (3, "kernel"), (whole, "kernel_p1"), (whole, "kernel_p4")):
        with pytest.raises(ValueError, match=f"C = {fused.STAGE_C} only"):
            fused.select_blend_bwd_stage(vals, rects, g, K, C, st, design=d)
    assert fused.baseline_launches == 0 and not any(fused.stage_launches.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_edges_on_card(cuda_device):
    """chip_smoke.py's K9 edge checks: in both layouts the kernel's
    d(vals) within K3_REL_L2 of plain (but on the threshold), bit-equal
    across two launches and to the kernel with the band cull off."""
    assert chip_smoke.check_k9_edges(cuda_device, lambda msg: None) == len(CASES)
