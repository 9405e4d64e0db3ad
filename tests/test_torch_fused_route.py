"""K9's route (the backward's second kernel: each lane's d(vals) row, the
sum of its slots' cotangent rows over the tiles of its rect, in tile
order) and its plain version `raster/fused.py::route_plain`.

`route_plain` is the scatter_add_ that `select_blend_bwd_plain` ended
with, factored out: held here bit for bit to that code (a copy of it, on
the inputs the plain backward hands over) and to the design before's
walk (a float32 loop over each lane's rect, ty then tx, a binary search
in each tile's ascending lane list: `fused.cu::fused_route_kernel_v1`)
on `chip_smoke.route_edge_cases`: lanes of 1- and 64-tile rects and of
rect 0, rects past the block's edge, tiles of count 0, K and over K (so
lanes no tile selects), kb 1001 (a multiple of no group size), C 3 (rows
not 16-byte aligned), K above kb; the rows and ids past each tile's live
count hold NaN and -7 and must not be read. The plain backward stays held
against JAX's K9 backward by `test_torch_fused_bwd.py`.

The route's CUDA kernels run only on the card: here their entry points
(`fused.route`, `fused.select_blend_bwd_tiles`, P3's `stage_v1`) must
refuse CPU tensors and unsupported C; the test marked `cuda` runs
chip_smoke.py's route checks and skips without a GPU.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

import chip_smoke
from d3ga_tpu_torch.probes import fused_bisect
from d3ga_tpu_torch.raster import fused

CPU = torch.device("cpu")
CASES = {c[0]: c[1:] for c in chip_smoke.route_edge_cases(CPU)}


def lanes_of(case):
    """(kb, drec [NB, 64, K, 6 + C], route_plain's lanes) of a route case."""
    rects, drec, sel, live, K, C = CASES[case]
    kb = rects.shape[1]
    return kb, drec.reshape(-1, fused.TB, K, 6 + C), fused.scratch_lanes(sel, live, kb)


def route_loop(rects, drec, sel, live, K, C):
    """The design before's walk in numpy float32: per lane, the tiles of
    its rect (clamped to the block) in ty-then-tx order, its slot found by
    a binary search in the tile's first live ids, the slot's row added."""
    r, d, se, li = (t.numpy() for t in (rects.long(), drec, sel, live))
    NB, kb = r.shape
    out = np.zeros((NB, kb, fused.NCH), np.float32)
    for b in range(NB):
        for j in range(kb):
            x0, x1 = r[b, j] & 0xFF, min((r[b, j] >> 8) & 0xFF, 8)
            y0, y1 = (r[b, j] >> 16) & 0xFF, min((r[b, j] >> 24) & 0xFF, 8)
            acc = np.zeros(6 + C, np.float32)
            for ty in range(y0, y1):
                for tx in range(x0, x1):
                    bt = b * fused.TB + ty * fused.BLOCK + tx
                    st = se[bt, :li[bt]]
                    k = int(np.searchsorted(st, j))
                    if k < len(st) and st[k] == j:
                        acc = acc + d[bt, k]
            out[b, j, :6 + C] = acc
    return torch.from_numpy(out)


@pytest.mark.parametrize("case", list(CASES))
def test_route_plain_is_the_design_before(case):
    rects, drec, sel, live, K, C = CASES[case]
    kb, d4, lanes = lanes_of(case)
    got = fused.route_plain(d4, lanes, kb)
    assert got.shape == (rects.shape[0], kb, fused.NCH)
    assert torch.isfinite(got).all() and (got[..., 6 + C:] == 0).all()
    want = route_loop(rects, drec, sel, live, K, C)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_route_plain_zero_where_no_tile_selects(case):
    """Lanes whose rect is empty, and lanes of a rect that no tile's first
    K ids hold, get zero rows; every other lane's row is its slots' sum."""
    rects, drec, sel, live, K, C = CASES[case]
    kb, d4, lanes = lanes_of(case)
    got = fused.route_plain(d4, lanes, kb)
    picked = torch.zeros(rects.shape[0], kb + 1, dtype=torch.bool).scatter_(
        1, lanes.reshape(rects.shape[0], -1).long(), True)[:, :kb]
    assert (got[~picked] == 0).all()
    empty = chip_smoke.rect_areas(rects) == 0
    assert not (picked & empty).any()


def old_route(drec, lanes, kb):
    """`select_blend_bwd_plain`'s route before it was factored out."""
    nb, _, Kk, CR = drec.shape
    hit = lanes < kb
    drec = torch.where(hit[..., None], drec, 0.0).reshape(nb, fused.TB * Kk, CR)
    idx = torch.where(hit, lanes, kb).reshape(nb, fused.TB * Kk, 1).expand(-1, -1, CR)
    dv = drec.new_zeros((nb, kb + 1, CR)).scatter_add_(1, idx, drec)
    return Fn.pad(dv[:, :kb], (0, fused.NCH - CR))


def test_route_plain_is_the_plain_backwards_route(monkeypatch):
    """On the plain backward's own inputs (two K9 edge cases, C 6 and 3),
    route_plain gives what the inline code before gave, to the bit."""
    seen = []
    real = fused.route_plain

    def spy(drec, lanes, kb):
        seen.append((drec, lanes, kb))
        return real(drec, lanes, kb)

    monkeypatch.setattr(fused, "route_plain", spy)
    cases = {c[0]: c for c in chip_smoke.k9_edge_cases(CPU)}
    for name in ("raw >= 0.99", "C=3, 2 blocks"):
        _, vals, rects, g, C = cases[name]
        fused.select_blend_bwd_plain(vals, rects, g, chip_smoke.K9_EDGE_K, C)
    assert len(seen) == 2
    for drec, lanes, kb in seen:
        assert torch.equal(real(drec, lanes, kb).view(torch.int32),
                           old_route(drec, lanes, kb).view(torch.int32))


def test_scratch_lanes():
    sel = torch.tensor([[3, 5, 9], [1, -7, -7]] * 32, dtype=torch.int32)
    live = torch.tensor([2, 1] * 32, dtype=torch.int32)
    lanes = fused.scratch_lanes(sel, live, 12)
    assert lanes.shape == (1, 64, 3)
    assert lanes[0, :2].tolist() == [[3, 5, 12], [1, 12, 12]]


def test_route_work_counts():
    """route_work's bytes: every live slot's row and id, the live counts and
    the rects read once, d(vals) written once; its area histogram covers
    every lane."""
    rects, drec, sel, live, K, C = CASES["kb 1001, rects past the block's edge"]
    w = chip_smoke.route_work(rects, live, C)
    n = int(live.sum())
    assert w["live_slots"] == n and w["lanes"] == rects.numel()
    assert w["bytes"] == 4 * (n * (6 + C) + n + live.numel() + rects.numel()) + 64 * rects.numel()
    assert sum(w["area_hist"].values()) == rects.numel()
    assert w["tiles_visited"] == int(chip_smoke.rect_areas(rects).sum())
    area = chip_smoke.rect_areas(rects)[0].tolist()
    for G, rounds in w["rounds_by_group"].items():
        per = 32 // G  # lanes a warp
        assert rounds == sum(max(-(-a // G) for a in area[i:i + per])
                             for i in range(0, len(area), per))


def test_entry_points_refuse_cpu_tensors_and_bad_c():
    rects, drec, sel, live, K, C = CASES["C 3 (rows not 16-byte aligned)"]
    with pytest.raises(ValueError, match="CUDA"):
        fused.route(rects, drec, sel, live, K, C)
    with pytest.raises(ValueError, match="CUDA"):
        fused.route(rects, drec, sel, live, K, C, design="baseline")
    with pytest.raises(ValueError, match="built for C = 6"):
        fused.route(rects, drec, sel, live, K, C, design="kernel_g4")
    with pytest.raises(ValueError, match="design"):
        fused.route(rects, drec, sel, live, K, C, design="kernel_g64")
    with pytest.raises(ValueError, match="unsupported"):
        fused.route(rects, drec, sel, live, K, 11)
    vals = torch.zeros((1, 128, fused.NCH))
    r = torch.zeros((1, 128), dtype=torch.int32)
    g = torch.zeros((1, fused.TB, fused.NPIX, 4))
    with pytest.raises(ValueError, match="CUDA"):
        fused.select_blend_bwd_tiles(vals, r, g, 16, 3)
    with pytest.raises(ValueError, match="CUDA"):
        fused_bisect.stage_v1(vals, r, 16, 3, 0)
    assert not any(fused.route_design_launches.values()) and fused.tiles_launches == 0
    assert not any(fused_bisect.v1_launches.values())


@pytest.mark.cuda
def test_route_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    assert chip_smoke.check_route_edges(torch.device("cuda"), print) > 0
