"""K5's and K7's backwards (`raster/blend_rec.py`) on K3's edge inputs
(`chip_smoke.k3_edge_cases`), and their baseline designs' entry points.

The backwards walk a tile with K3's own walk, so that given K3's records,
ids, counts and cotangent (carried into K7's image layout and K5's
tile-major one) their drec is K3's rows of the same tiles. On the CPU the
plain versions are held within K3's tolerances of K3's plain version
through `chip_smoke.check_rec_bwd_edges` (K5 on the whole grid and on each
tile alone), but on the faint records on the threshold. The baselines
(the designs before) refuse CPU tensors. The test marked `cuda` runs the
same check on the card, where each kernel's drec equals K3's to the bit
on every case, and skips without a GPU.
"""

import pytest
import torch

import chip_smoke
from d3ga_tpu_torch.raster import blend_rec

CASES = {c[0]: c for c in chip_smoke.k3_edge_cases(torch.device("cpu"))}


@pytest.fixture(autouse=True)
def one_thread():
    """The plain versions' small ops on one intra-op thread: faster alone
    than on eight, and the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def calls(name):
    _, rec, idx, counts, g, ntx, nty, C = CASES[name]
    T = idx.shape[0]
    return chip_smoke.rec_bwd_calls(rec, idx, counts, g, ntx, nty, C,
                                    [(0, T)] + [(t, 1) for t in range(T)])


def test_plain_backwards_match_k3_on_the_edges():
    said = []
    n = chip_smoke.check_rec_bwd_edges(torch.device("cpu"), said.append)
    # K7 and K5 on the whole grid, and K5 on each tile of the 3x2 grids
    grids = [CASES[c][5] * CASES[c][6] for c in CASES]
    assert n == sum(2 + (t if t > 1 else 0) for t in grids)
    assert len(said) == 1 and "K3's plain rows" in said[0]


@pytest.mark.parametrize("name", ["counts 256", "C=3 CR=9 3x2", "C=8 CR=16 1x1"])
def test_calls_cover_every_tile_once(name):
    """K7's rows are the whole grid and K5's slices its tiles, each with
    its own slice of the cotangent."""
    _, rec, idx, counts, g, ntx, nty, C = CASES[name]
    got = calls(name)
    T = idx.shape[0]
    assert got["K7"][0] == slice(0, T)
    assert got[f"K5 at offset 0, {T} tiles"][0] == slice(0, T)
    assert [got[f"K5 at offset {t}, 1 tiles"][0] for t in range(T)] == [
        slice(t, t + 1) for t in range(T)]
    for label, (rows, fns) in got.items():
        assert fns["kernel"]().shape == (rows.stop - rows.start, idx.shape[1], rec.shape[1]), label


def test_baselines_need_the_card():
    """K5's and K7's baseline designs raise on CPU tensors, and their
    counters do not move."""
    for name in ("counts 256", "C=3 CR=9 3x2"):
        for label, (_, fns) in calls(name).items():
            with pytest.raises(ValueError, match="CUDA"):
                fns["baseline"]()
    assert blend_rec.bwd_baseline_launches == 0 and blend_rec.img_bwd_baseline_launches == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_backwards_equal_k3_on_card(cuda_device):
    """chip_smoke's check on the card: K7's and K5's drec bit-equal to
    K3's on every edge case, and within K3's tolerances of their plain
    versions and baseline designs (but on the threshold)."""
    with torch.no_grad():
        assert chip_smoke.check_rec_bwd_edges(cuda_device, print) > 0
