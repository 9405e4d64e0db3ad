"""K5's and K7's forwards (`raster/blend_rec.py`) on K2's edge inputs
(`chip_smoke.k3_edge_cases`), and their baseline designs' entry points.

The forwards walk a tile with K2's own walk, so that given K2's records,
ids and counts their values are K2's image of the same tiles (K7's image
and K5's tile-major blocks carried over). On the CPU the plain versions
are held against K2's plain image through `chip_smoke.check_rec_fwd_edges`
(K5 on the whole grid and on each tile alone): bit for bit on the whole
grid, within the image tolerances on one tile alone, whose einsum rounds
apart from a batch of tiles. K7's plain forward is held against the JAX
package's `pallas_blend_rec._run_forward_img` in interpret mode on the
cases whose counts lie in [0, K] at C 3 and 6, to test_torch_raster.py's
IMG_ATOL, and on the faint records on the threshold by `flip_close`, as
the ct tests hold K2's; `pallas_blend_rec.IMG_G_CAP` is patched to 1 (one
tile a program, a tiling choice), each JAX computation compiled at XLA's
level 0. The baselines (the designs before) refuse CPU tensors. The test
marked `cuda` runs the same check on the card, where each kernel's values
equal K2's image and its baseline's to the bit on every case, and skips
without a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from d3ga_tpu.raster import pallas_blend_rec as jbrec
from d3ga_tpu_torch.raster import blend_rec
from test_torch_raster import IMG_ATOL
from test_torch_raster_bwd import flip_close
from torch_parity import jit_o0

CASES = {c[0]: c for c in chip_smoke.k3_edge_cases(torch.device("cpu"))}
IN_RANGE = [n for n, c in CASES.items()
            if c[7] in (3, 6) and bool(((c[3] >= 0) & (c[3] <= c[2].shape[1])).all())]


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions' small ops on one intra-op thread: faster alone
    than on eight, and the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def one_tile_a_program():
    mp = pytest.MonkeyPatch()
    mp.setattr(jbrec, "IMG_G_CAP", 1)
    yield
    mp.undo()


def calls(name):
    _, rec, idx, counts, _, ntx, nty, C = CASES[name]
    T = idx.shape[0]
    return chip_smoke.rec_fwd_calls(rec, idx, counts, ntx, nty, C,
                                    [(0, T)] + [(t, 1) for t in range(T)])


def test_plain_forwards_match_k2_on_the_edges():
    said = []
    n = chip_smoke.check_rec_fwd_edges(torch.device("cpu"), said.append)
    # K7 and K5 on the whole grid, and K5 on each tile of the 3x2 grids
    grids = [CASES[c][5] * CASES[c][6] for c in CASES]
    assert n == sum(2 + (t if t > 1 else 0) for t in grids)
    assert len(said) == 1 and "K2's plain image" in said[0]


@pytest.mark.parametrize("name", ["counts 256", "C=3 CR=9 3x2", "C=8 CR=16 1x1"])
def test_calls_cover_every_tile_once(name):
    """K7's tiles are the whole grid and K5's slices each tile once, in
    order, each call's values tile-major."""
    _, rec, idx, counts, _, ntx, nty, C = CASES[name]
    got = calls(name)
    T = idx.shape[0]
    assert got["K7"][0] == slice(0, T)
    assert got[f"K5 at offset 0, {T} tiles"][0] == slice(0, T)
    assert [got[f"K5 at offset {t}, 1 tiles"][0] for t in range(T)] == [
        slice(t, t + 1) for t in range(T)]
    for label, (rows, fns) in got.items():
        assert fns["kernel"]().shape == (rows.stop - rows.start, 256, C + 1), label


@pytest.mark.parametrize("name", IN_RANGE)
def test_img_plain_matches_pallas_kernel(name):
    """K7's plain forward against `_run_forward_img` (interpret) on K2's
    edge cases whose counts lie in [0, K] at C 3 and 6; on the faint
    records on the threshold, whose alpha tests decide by rounding, by
    `flip_close`."""
    _, rec, idx, counts, _, ntx, nty, C = CASES[name]
    r = jnp.asarray(rec.numpy())[jnp.asarray(idx.numpy())]
    c = jnp.asarray(counts.numpy())
    j = np.asarray(jit_o0(
        lambda rr, cc: jbrec._run_forward_img(rr, cc, ntx, nty, C, interpret=True), r, c)(r, c))
    t = blend_rec.blend_gather_img_plain(rec, idx, counts, ntx, nty, C, tile_chunk=4).numpy()
    assert t.shape == j.shape == (nty * 16, ntx * 16, C + 1)
    if name == chip_smoke.K3_ON_THRESHOLD:
        flip_close(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=IMG_ATOL)


def test_baselines_need_the_card():
    """K5's and K7's forward baseline designs raise on CPU tensors, and
    their counters do not move."""
    for name in ("counts 256", "C=3 CR=9 3x2"):
        for label, (_, fns) in calls(name).items():
            with pytest.raises(ValueError, match="CUDA"):
                fns["baseline"]()
    assert blend_rec.fwd_baseline_launches == 0 and blend_rec.img_fwd_baseline_launches == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_forwards_equal_k2_on_card(cuda_device):
    """chip_smoke's check on the card: K7's and K5's values bit-equal to
    K2's image of the same tiles and to their baseline designs on every
    edge case, and within the image tolerances of their plain versions
    (but on the threshold)."""
    with torch.no_grad():
        assert chip_smoke.check_rec_fwd_edges(cuda_device, print) > 0
