"""K2 (the blend forward, `blend_ct.blend_gather_ct`) on the edge inputs
that K3's tests use, `chip_smoke.k3_edge_cases` (counts 0, 1, 63, 64, 65,
255, 256, > K and < 0; sentinel ids inside the count; every pixel stopped
at the third record; raw >= 0.99; opacity 0; records off the tile; C in
{1, 3, 6, 8} with CR in {6 + C, 16}; grids of 1x1 and 3x2 tiles; faint
records whose ellipse reaches each row of the tile, inside the alpha
threshold and on it).

On the CPU the plain version is held against the JAX package's
`pallas_blend_ct._run_forward_ct` in interpret mode, on the cases whose
counts lie in [0, K] at C 3 and 6 (the JAX kernel takes the sentinel
column past each count as its padding), to test_torch_raster.py's
IMG_ATOL (the JAX kernel's bf16 hi/lo split matmuls and log-domain
compositing against the port's float32 cumsum). On the faint records on
the threshold, whose alpha tests decide by rounding, the two are held by
the share of values a threshold flip moves (`flip_close`). Counts > K and
< 0 are held against the plain version's own clamp, and the empty tiles
to zeros and T_bg = 1. `pallas_blend_ct.G_CT` is patched to 16, the
in-kernel tile loop, as in test_torch_raster.py, and each JAX
computation compiled at XLA's level 0.

The CUDA kernel, its baseline design and its stage entry point run only
on the card: the test marked `cuda` runs chip_smoke.py's K2 edge checks
(the kernel bit for bit against its baseline design, across two launches
and against its other batch sizes) and skips without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from d3ga_tpu.raster import pallas_blend as jbl
from d3ga_tpu.raster import pallas_blend_ct as jbct
from d3ga_tpu_torch.raster import blend_ct
from test_torch_raster import IMG_ATOL
from test_torch_raster_bwd import flip_close
from torch_parity import jit_o0

CASES = {c[0]: c for c in chip_smoke.k3_edge_cases(torch.device("cpu"))}
CLAMPED = "counts > K and < 0, real ids in every slot"
IN_RANGE = [n for n, c in CASES.items()
            if c[7] in (3, 6) and bool(((c[3] >= 0) & (c[3] <= c[2].shape[1])).all())]
JAX_CASES = [n for n in IN_RANGE if n != chip_smoke.K3_ON_THRESHOLD]


@pytest.fixture(scope="module", autouse=True)
def tile_loop():
    mp = pytest.MonkeyPatch()
    mp.setattr(jbct, "G_CT", 16)
    yield
    mp.undo()


_COMPILED = {}  # the JAX kernel compiled once per (grid, C, CR): cases share it


def jax_image(name):
    """`_run_forward_ct` (interpret) on case `name`'s records gathered
    into the [T, CR, K] layout it takes."""
    _, rec, idx, counts, _, ntx, nty, C = CASES[name]
    rec_ct = jnp.swapaxes(jnp.asarray(rec.numpy())[jnp.asarray(idx.numpy())], 1, 2)
    cnt = jnp.asarray(counts.numpy())
    key = (ntx, nty, C, rec_ct.shape)
    if key not in _COMPILED:
        _COMPILED[key] = jit_o0(
            lambda r, c: jbct._run_forward_ct(r, c, ntx, nty, C, interpret=True), rec_ct, cnt)
    return np.asarray(_COMPILED[key](rec_ct, cnt))


def plain_image(name, **kw):
    _, rec, idx, counts, _, ntx, nty, C = CASES[name]
    return blend_ct.blend_gather_ct_plain(rec, idx, counts, ntx, nty, C, tile_chunk=4, **kw)


def test_jax_cases_cover_the_edges():
    """The JAX-held cases take every count in [0, K] the edge list names,
    both grids, both CR kinds at C 3, and the named record kinds; with
    the case on the threshold, every in-range case at C 3 and 6."""
    counts = set()
    for n in JAX_CASES:
        counts |= set(CASES[n][3].tolist())
    assert {0, 1, 63, 64, 65, 255, 256} <= counts
    assert {(CASES[n][5], CASES[n][6]) for n in JAX_CASES} == {(1, 1), (3, 2)}
    assert {CASES[n][1].shape[1] for n in JAX_CASES if CASES[n][7] == 3} == {9, 16}
    for kind in ("sentinel", "third record", "raw >= 0.99", "opacity 0", "off the tile",
                 "inside the band edges"):
        assert any(kind in n for n in JAX_CASES), kind
    assert set(IN_RANGE) - set(JAX_CASES) == {chip_smoke.K3_ON_THRESHOLD}


@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_matches_pallas_kernel(name):
    C, ntx, nty = CASES[name][7], CASES[name][5], CASES[name][6]
    t = plain_image(name)
    j = jax_image(name)
    assert t.shape == j.shape == (C + 1, nty * 16, ntx * 16)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=IMG_ATOL)


def test_plain_on_threshold_matches_pallas_kernel():
    """The faint records on the alpha threshold: the two roundings may
    take a record at a pixel apart, which moves the pixel by that
    record's share; the p999 error and the share of values off by more
    than 1e-3 of the largest are held (`flip_close`'s defaults)."""
    name = chip_smoke.K3_ON_THRESHOLD
    flip_close(plain_image(name).numpy(), jax_image(name))


def test_split_power_matches_pallas_on_threshold():
    """Given the JAX kernel's own coefficients (`_coeffs_ct`) on the faint
    records on the threshold, the port's falloff power and log raw
    (`blend_ct.split_power`, which `_blend_chunk` computes them by) equal
    `pallas_blend._dot_split_b`'s bit for bit, and so do the alpha
    decisions (power <= 0 and min(0.99, raw) >= 1/255)."""
    _, rec, idx, counts, _, ntx, nty, C = CASES[chip_smoke.K3_ON_THRESHOLD]
    basis_j = jbl._pixel_basis()  # [256, 8], two zero columns
    basis_t = blend_ct._pixel_basis("cpu")
    org = blend_ct._tile_origins(idx.shape[0], ntx, "cpu").numpy()
    split = jax.jit(lambda c: jbl._dot_split_b(basis_j, c, jbct.C_NK))
    coeffs_of = jax.jit(jbct._coeffs_ct)

    def port(c):  # [8, K] -> the port's [256, K]
        return blend_ct.split_power(basis_t, torch.from_numpy(np.array(c[:6].T))[None])[0].numpy()

    decided = 0
    for t in range(idx.shape[0]):
        rec_ct = jnp.asarray(rec.numpy()[idx[t].numpy()].T)  # [CR, K]
        for_t = [np.asarray(c) for c in coeffs_of(rec_ct, org[t, 0], org[t, 1])]
        power, log_raw = (np.asarray(split(jnp.asarray(c))) for c in for_t)
        p_t, l_t = (port(c) for c in for_t)
        assert np.array_equal(p_t, power) and np.array_equal(l_t, log_raw)
        use_j = (power <= 0) & (np.minimum(np.asarray(jnp.exp(log_raw)), jbct.ALPHA_MAX)
                                >= jbct.ALPHA_SKIP)
        use_t = (torch.from_numpy(p_t) <= 0) & (torch.clamp(
            torch.exp(torch.from_numpy(l_t)), max=blend_ct.ALPHA_MAX) >= blend_ct.ALPHA_SKIP)
        assert np.array_equal(use_t.numpy(), use_j)
        decided += int(use_j.sum())
    assert decided > 0


def test_plain_clamps_counts():
    """Counts > K and < 0 (real ids in every slot, as a kernel must not
    read past its clamp): the image of the counts clamped to [0, K], bit
    for bit; the tiles with counts < 0 are empty."""
    _, rec, idx, counts, _, ntx, nty, C = CASES[CLAMPED]
    K = idx.shape[1]
    assert bool((counts > K).any() and (counts < 0).any())
    t = plain_image(CLAMPED)
    ref = blend_ct.blend_gather_ct_plain(rec, idx, torch.clamp(counts, 0, K), ntx, nty, C)
    assert torch.equal(t, ref)
    tiles = t.reshape(C + 1, nty, 16, ntx, 16).permute(1, 3, 0, 2, 4).reshape(ntx * nty, C + 1, -1)
    assert bool((tiles[counts < 0, :C] == 0).all() and (tiles[counts < 0, C] == 1).all())
    assert float(tiles[counts > K, C].min()) < 1.0


@pytest.mark.parametrize("name", list(CASES))
def test_plain_empty_tiles_and_counts(name):
    """Every case: finite; each tile with no live slot has no colour and
    T_bg = 1 at every pixel; the pairs a walk visits are at most 256 a
    live slot."""
    _, rec, idx, counts, _, ntx, nty, C = CASES[name]
    t, pairs = plain_image(name, count_pairs=True)
    assert bool(torch.isfinite(t).all())
    tiles = t.reshape(C + 1, nty, 16, ntx, 16).permute(1, 3, 0, 2, 4).reshape(ntx * nty, C + 1, -1)
    empty = torch.clamp(counts, 0, idx.shape[1]) == 0
    assert bool((tiles[empty, :C] == 0).all() and (tiles[empty, C] == 1).all())
    assert pairs <= 256 * int(torch.clamp(counts, 0, idx.shape[1]).sum())


def test_baseline_and_stages_need_the_card():
    """The baseline and every (design, stage) cut raise on CPU tensors;
    unknown stages and designs, cuts of the designs built whole only, and
    any stage at another C than STAGE_C, raise."""
    _, rec, idx, counts, _, ntx, nty, C = CASES["counts 256"]
    assert C == blend_ct.STAGE_C
    args = (rec, idx, counts, ntx, nty, C)
    whole = len(blend_ct.FWD_STAGES) - 1
    with pytest.raises(ValueError, match="CUDA"):
        blend_ct.blend_gather_ct_baseline(*args)
    for d in blend_ct.FWD_DESIGNS:
        for st in range(len(blend_ct.FWD_STAGES)):
            cut_short = d != "kernel" and st < whole
            with pytest.raises(ValueError, match=f"stage {whole}" if cut_short else "CUDA"):
                blend_ct.blend_gather_ct_stage(*args, st, design=d)
    for st, d in ((3, "kernel"), (-1, "baseline"), (whole, "kernel_r3")):
        with pytest.raises(ValueError, match="stage"):
            blend_ct.blend_gather_ct_stage(*args, st, design=d)
    _, rec, idx, counts, _, ntx, nty, C = CASES["C=3 CR=9 3x2"]
    for st, d in ((0, "kernel"), (1, "kernel"), (whole, "kernel"), (whole, "baseline"),
                  (whole, "kernel_r1"), (whole, "kernel_diag")):
        with pytest.raises(ValueError, match=f"C = {blend_ct.STAGE_C} only"):
            blend_ct.blend_gather_ct_stage(rec, idx, counts, ntx, nty, C, st, design=d)
    assert blend_ct.fwd_baseline_launches == 0 and not any(blend_ct.fwd_stage_launches.values())


def test_wrapper_takes_plain_on_cpu():
    """On CPU tensors the wrapper is the plain version and counts no
    launch."""
    _, rec, idx, counts, _, ntx, nty, C = CASES["counts 0/1/63/64/65/255"]
    before = blend_ct.launches
    out = blend_ct.blend_gather_ct(rec, idx, counts, ntx, nty, C)
    assert torch.equal(out, blend_ct.blend_gather_ct_plain(rec, idx, counts, ntx, nty, C))
    assert blend_ct.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_edges_on_card(cuda_device):
    """chip_smoke.py's K2 edge checks: every case within the image
    tolerances of the plain version (but the faint records on the
    threshold), bit-equal to the baseline design and across two launches,
    and at STAGE_C the batch sizes, the diagnostic build and stage 2
    bit-equal to the kernel."""
    assert chip_smoke.check_k2_edges(cuda_device, lambda msg: None) == len(CASES)
