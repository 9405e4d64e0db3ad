"""K3 (the blend backward, `blend_ct.blend_gather_ct_bwd`) on its edge
inputs, `chip_smoke.k3_edge_cases` (counts 0, 1, 63, 64, 65, 255, 256, > K
and < 0; sentinel ids inside the count; every pixel stopped at the third
record; raw >= 0.99; opacity 0; records off the tile; C in {1, 3, 6, 8}
with CR in {6 + C, 16}; grids of 1x1 and 3x2 tiles; faint records whose
ellipse reaches each row of the tile, inside the alpha threshold and on
it).

On the CPU the plain version is held against the JAX package's
`pallas_blend_ct._run_backward_ct` in interpret mode, on the cases whose
counts lie in [0, K] at C 3 and 6 (the JAX kernel takes the sentinel
column past each count as its padding and needs no clamp), the faint
records on the threshold, whose alpha tests decide by rounding, in a test
of their own; the counts > K and < 0 against the plain version's own
clamp. `pallas_blend_ct.G_CT` is
patched to 16, the in-kernel tile loop, as in test_torch_raster_bwd.py,
and each JAX computation compiled at XLA's level 0. Tolerances as there:
the p999 error within 1e-5 of the largest |value| and at most a 1e-3
share of elements off by more than 1e-3 of it (threshold flips between
the JAX kernel's split matmuls and the port's float32).

The CUDA kernel, its baseline design and its stage cuts run only on the
card: the test marked `cuda` holds them against the plain version on the
same inputs, and the kernel bit for bit against itself with its band cull
off, and skips without a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from d3ga_tpu.raster import pallas_blend_ct as jbct
from d3ga_tpu_torch.raster import blend_ct
from test_torch_raster_bwd import flip_close
from torch_parity import jit_o0

CASES = {c[0]: c for c in chip_smoke.k3_edge_cases(torch.device("cpu"))}
CLAMPED = "counts > K and < 0, real ids in every slot"
JAX_CASES = [n for n, c in CASES.items()
             if c[7] in (3, 6) and bool(((c[3] >= 0) & (c[3] <= c[2].shape[1])).all())
             and n != chip_smoke.K3_ON_THRESHOLD]
FAINT = (chip_smoke.K3_INSIDE_THRESHOLD, chip_smoke.K3_ON_THRESHOLD)


@pytest.fixture(scope="module", autouse=True)
def tile_loop():
    mp = pytest.MonkeyPatch()
    mp.setattr(jbct, "G_CT", 16)
    yield
    mp.undo()


def live_slots(idx, counts):
    K = idx.shape[1]
    return np.arange(K)[None] < np.clip(counts.numpy(), 0, K)[:, None]


def test_jax_cases_cover_the_edges():
    """The JAX-held cases take every count in [0, K] the edge list names,
    both grids, both CR kinds at C 3, and the named record kinds."""
    counts = set()
    for n in JAX_CASES:
        counts |= set(CASES[n][3].tolist())
    assert {0, 1, 63, 64, 65, 255, 256} <= counts
    assert {(CASES[n][5], CASES[n][6]) for n in JAX_CASES} == {(1, 1), (3, 2)}
    assert {CASES[n][1].shape[1] for n in JAX_CASES if CASES[n][7] == 3} == {9, 16}
    for kind in ("sentinel", "third record", "raw >= 0.99", "opacity 0", "off the tile",
                 "inside the band edges"):
        assert any(kind in n for n in JAX_CASES), kind


_COMPILED = {}  # the JAX kernel compiled once per (grid, C, CR): cases share it


def plain_and_pallas(name):
    """Case `name`'s cotangents [T, K, CR] from the plain version and
    from `_run_backward_ct` (interpret), as numpy."""
    _, rec, idx, counts, g, ntx, nty, C = CASES[name]
    rec_ct = jnp.swapaxes(jnp.asarray(rec.numpy())[jnp.asarray(idx.numpy())], 1, 2)
    args = (rec_ct, jnp.asarray(counts.numpy()), jnp.asarray(g.numpy()))
    key = (ntx, nty, C, rec_ct.shape)
    if key not in _COMPILED:
        _COMPILED[key] = jit_o0(
            lambda r, c, gg: jbct._run_backward_ct(r, c, gg, ntx, nty, C, interpret=True), *args)
    j = _COMPILED[key](*args)
    t = blend_ct.blend_gather_ct_bwd_plain(rec, idx, counts, g, ntx, nty, C, tile_chunk=4)
    assert t.shape == (ntx * nty, idx.shape[1], rec.shape[1])
    return t.numpy(), np.swapaxes(np.asarray(j), 1, 2)


@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_matches_pallas_kernel(name):
    flip_close(*plain_and_pallas(name))


def test_plain_on_threshold_matches_pallas_kernel():
    """The faint records on the alpha threshold, left out of the cases
    above: the two roundings may take a record at a pixel apart, which
    moves that record's cotangent by the pixel's share; held by the same
    p999 error and share of flipped values (`flip_close`'s defaults)."""
    flip_close(*plain_and_pallas(chip_smoke.K3_ON_THRESHOLD))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_zero_past_counts_and_columns(name):
    """Every case: finite, zero in the slots past min(max(counts, 0), K)
    and in the columns past 6 + C; some live slot carries a cotangent
    where any slot is live."""
    _, rec, idx, counts, g, ntx, nty, C = CASES[name]
    t = blend_ct.blend_gather_ct_bwd_plain(rec, idx, counts, g, ntx, nty, C).numpy()
    live = live_slots(idx, counts)
    assert np.isfinite(t).all()
    assert np.all(t[~live] == 0.0)
    assert np.all(t[..., 6 + C:] == 0.0)
    if live.any():
        assert np.abs(t[live]).max() > 0.0


def test_plain_clamps_counts():
    """Counts > K and < 0 (real ids in every slot, as a kernel must not
    read past its clamp): the same cotangents as the counts clamped to
    [0, K], bit for bit."""
    _, rec, idx, counts, g, ntx, nty, C = CASES[CLAMPED]
    K = idx.shape[1]
    assert bool((counts > K).any() and (counts < 0).any())
    t = blend_ct.blend_gather_ct_bwd_plain(rec, idx, counts, g, ntx, nty, C)
    ref = blend_ct.blend_gather_ct_bwd_plain(rec, idx, torch.clamp(counts, 0, K), g, ntx, nty, C)
    assert torch.equal(t, ref)
    assert np.all(t.numpy()[counts.numpy() < 0] == 0.0)
    assert float(t[counts > K].abs().max()) > 0.0


def test_third_record_stops_every_pixel():
    """The opaque wide case does what its name says: in each tile the
    plain walk accepts the first two records at every pixel and nothing
    from the third on."""
    _, rec, idx, counts, g, ntx, nty, C = CASES["every pixel stopped at the third record"]
    origin = blend_ct._tile_origins(ntx * nty, ntx, rec.device)
    slot = torch.arange(idx.shape[1])
    f = blend_ct._blend_chunk(rec[idx.long()], origin, slot[None] < counts[:, None],
                              blend_ct._pixel_basis(rec.device))
    assert bool(f["accept"][:, :, :2].all())
    assert not bool(f["accept"][:, :, 2:].any())


@pytest.mark.parametrize("name", FAINT)
def test_faint_records_reach_every_row(name):
    """The faint records do what `band_edge_records` says: in float64,
    each one's ellipse (at 0.9 of its threshold's Q inside, at it on the
    threshold) has its extreme in y on a pixel of its tile, every row of
    every tile is reached twice, from above for even rows and from below
    for odd ones; inside the threshold the plain walk takes each record at
    that pixel, so a band cull that drops it changes the cotangents."""
    _, rec, idx, counts, g, ntx, nty, C = CASES[name]
    q = 0.9 if name == chip_smoke.K3_INSIDE_THRESHOLD else 1.0
    r = rec.double().numpy()
    faint = np.nonzero(r[:-1, 5] < 1.03 / 255)[0]
    assert len(faint) == 32 * ntx * nty
    A, B, Cc = r[faint, 2], r[faint, 3], r[faint, 4]
    ext = np.sqrt(q * 2 * np.log(255 * r[faint, 5]) * A / (A * Cc - B * B))
    t = (faint - 96 * ntx * nty) // 32  # band_edge_records: tile-major, 32 a tile
    row = np.arange(len(faint)) % 32 // 2
    dy = np.where(row % 2 == 0, ext, -ext)
    py = r[faint, 1] + dy - 16 * (t // ntx)
    px = r[faint, 0] - B / A * dy - 16 * (t % ntx)
    np.testing.assert_allclose(py, row, atol=1e-3)
    np.testing.assert_allclose(px, np.round(px), atol=1e-3)
    assert ((np.round(px) >= 0) & (np.round(px) <= 15)).all()
    # each faint record is among its own tile's live slots
    slots = idx.numpy()[t]
    assert (slots == faint[:, None]).any(1).all()
    if q == 0.9:
        f = blend_ct._blend_chunk(rec[idx.long()], blend_ct._tile_origins(ntx * nty, ntx, "cpu"),
                                  torch.arange(idx.shape[1])[None] < counts[:, None],
                                  blend_ct._pixel_basis("cpu"))
        pix = (row * 16 + np.round(px)).astype(int)
        slot = (slots == faint[:, None]).argmax(1)
        assert bool(f["accept"][t, pix, slot].all())


def test_baseline_and_stages_need_the_card():
    """The baseline and every (design, stage) cut raise on CPU tensors;
    unknown stages and designs, cuts of the designs built whole only, and
    the cuts and pixel variants at another C than STAGE_C, raise."""
    _, rec, idx, counts, g, ntx, nty, C = CASES["counts 256"]
    assert C == blend_ct.STAGE_C
    args = (rec, idx, counts, g, ntx, nty, C)
    whole = len(blend_ct.STAGES) - 1
    with pytest.raises(ValueError, match="CUDA"):
        blend_ct.blend_gather_ct_bwd_baseline(*args)
    for d in blend_ct.DESIGNS:
        for st in range(len(blend_ct.STAGES)):
            cut_short = d not in ("baseline", "kernel") and st < whole
            with pytest.raises(ValueError, match="stage 4" if cut_short else "CUDA"):
                blend_ct.blend_gather_ct_bwd_stage(*args, st, design=d)
    for st, d in ((5, "kernel"), (-1, "baseline"), (4, "kernel_p3")):
        with pytest.raises(ValueError, match="stage"):
            blend_ct.blend_gather_ct_bwd_stage(*args, st, design=d)
    _, rec, idx, counts, g, ntx, nty, C = CASES["C=3 CR=9 3x2"]
    args = (rec, idx, counts, g, ntx, nty, C)
    for st, d in ((0, "kernel"), (3, "baseline"), (whole, "kernel_p1"), (whole, "kernel_p4")):
        with pytest.raises(ValueError, match=f"C = {blend_ct.STAGE_C} only"):
            blend_ct.blend_gather_ct_bwd_stage(*args, st, design=d)
    for d in ("baseline", "kernel", "kernel_no_cull"):
        with pytest.raises(ValueError, match="CUDA"):
            blend_ct.blend_gather_ct_bwd_stage(*args, whole, design=d)
    assert blend_ct.baseline_launches == 0 and not any(blend_ct.stage_launches.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_edges_on_card(cuda_device):
    """Every edge case on the card: the kernel within K3's tolerances of
    the plain version and of the baseline design (but the faint records on
    the threshold), bit-equal across two launches and to itself with the
    band cull off, zero past the counts; stage 4 of either design is that
    design's kernel; at STAGE_C the pixel variants within tolerance."""
    for name, *args in chip_smoke.k3_edge_cases(cuda_device):
        out = blend_ct.blend_gather_ct_bwd(*args)
        ref = blend_ct.blend_gather_ct_bwd_plain(*args)
        base = blend_ct.blend_gather_ct_bwd_baseline(*args)
        again = blend_ct.blend_gather_ct_bwd(*args)
        no_cull = blend_ct.blend_gather_ct_bwd_stage(*args, 4, design="kernel_no_cull")
        torch.cuda.synchronize()
        if name != chip_smoke.K3_ON_THRESHOLD:
            assert chip_smoke.slot_ok(chip_smoke.slot_err(out, ref)), name
            assert chip_smoke.slot_ok(chip_smoke.slot_err(out, base)), name
        assert torch.equal(out, again), name
        assert torch.equal(out.view(torch.int32), no_cull.view(torch.int32)), name
        live = torch.from_numpy(live_slots(args[1].cpu(), args[2].cpu())).to(cuda_device)
        assert bool((out[~live] == 0).all()), name
        for design, kernel_out in (("kernel", out), ("baseline", base)):
            cut = blend_ct.blend_gather_ct_bwd_stage(*args, 4, design=design)
            assert torch.equal(cut, kernel_out), (name, design)
        if args[-1] == blend_ct.STAGE_C and name != chip_smoke.K3_ON_THRESHOLD:
            for design in ("kernel_p1", "kernel_p4"):
                px = blend_ct.blend_gather_ct_bwd_stage(*args, 4, design=design)
                assert chip_smoke.slot_ok(chip_smoke.slot_err(px, ref)), (name, design)
