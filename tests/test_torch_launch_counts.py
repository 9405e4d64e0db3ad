"""The blend wrappers' launch counters count launches only.

`chip_smoke.py` reads the counters of `raster/blend.py` (K8),
`raster/fused.py` (K9, its route and per-tile kernel alone among them),
`raster/blend_ct.py` (K2, K3), `raster/blend_rec.py` (K5) and
`probes/fused_bisect.py` (P3's cuts and their design before) to show that
a path went through its kernels and that no design before ran on it. A
wrapper adds to its counter where its kernel launches and nowhere else: a
call on empty inputs (no tile, or K8's backward with no slot) returns its
zeros and launches nothing. K9's backward launches the per-tile kernel
and the route, and counts in both `bwd_launches` and `route_launches`.

The kernel libraries stand in here for a fake whose every entry point
returns 0 (a launch that succeeded), and the card-only wrappers take CPU
tensors, so the counting is held without a card.
"""

import pytest
import torch

from d3ga_tpu_torch.probes import fused_bisect
from d3ga_tpu_torch.raster import blend, blend_ct, blend_rec, fused
from d3ga_tpu_torch.utils import cuda_build

COUNTERS = {
    blend: ("launches", "bwd_launches", "baseline_launches", "stage_launches",
            "bwd_baseline_launches", "bwd_stage_launches"),
    fused: ("launches", "bwd_launches", "fwd_baseline_launches", "fwd_stage_launches",
            "baseline_launches", "stage_launches", "route_launches", "route_design_launches",
            "tiles_launches"),
    blend_ct: ("launches", "bwd_launches", "fwd_baseline_launches", "fwd_stage_launches",
               "baseline_launches", "stage_launches"),
    blend_rec: ("launches", "bwd_launches", "fwd_baseline_launches", "bwd_baseline_launches"),
    fused_bisect: ("launches", "v1_launches"),
}


class FakeLib:
    """Every entry point launches and succeeds."""

    def __getattr__(self, entry):
        return lambda *args: 0


@pytest.fixture
def fake_card(monkeypatch):
    """The four modules with the fake library, the card-only check off and
    their counters fresh."""
    lib = FakeLib()
    for mod, names in COUNTERS.items():
        for loader in ("_kernels", "_lib", "_bwd_lib"):
            if hasattr(mod, loader):
                monkeypatch.setattr(mod, loader, lambda: lib)
        if hasattr(mod, "_card_only"):
            monkeypatch.setattr(mod, "_card_only", lambda name, t: None)
        for name in names:
            v = getattr(mod, name)
            monkeypatch.setattr(mod, name, dict.fromkeys(v, 0) if isinstance(v, dict) else 0)
    monkeypatch.setattr(cuda_build, "stream_handle", lambda device: 0)


def k8_calls(T, K):
    C = 3
    co, col = torch.zeros((T, K, 8)), torch.zeros((T, K, C))
    op, g = torch.zeros((T, 1, K)), torch.zeros((T, blend.NPIX, C + 1))
    fwd, bwd = T > 0, T > 0 and K > 0
    wf, wb = len(blend.FWD_STAGES) - 1, len(blend.BWD_STAGES) - 1
    return [
        (lambda: blend._launch(co, col, op), "launches", None, fwd),
        (lambda: blend.blend_tiles_coeffs_baseline(co, col, op), "baseline_launches", None, fwd),
        (lambda: blend.blend_tiles_coeffs_stage(co, col, op, wf), "stage_launches",
         ("kernel", wf), fwd),
        (lambda: blend._launch_bwd(co, col, op, g), "bwd_launches", None, bwd),
        (lambda: blend.blend_tiles_coeffs_bwd_baseline(co, col, op, g), "bwd_baseline_launches",
         None, bwd),
        (lambda: blend.blend_tiles_coeffs_bwd_stage(co, col, op, g, wb), "bwd_stage_launches",
         ("kernel", wb), bwd),
    ]


def k9_calls(NB):
    C, K, kb = fused.STAGE_C, 8, 4
    vals, rects = torch.zeros((NB, kb, fused.NCH)), torch.zeros((NB, kb), dtype=torch.int32)
    g = torch.zeros((NB, fused.TB, fused.NPIX, C + 1))
    wf, wb = len(fused.FWD_STAGES) - 1, len(fused.BWD_STAGES) - 1
    drec, sel, live = route_scratch(NB, K, C)
    run = NB > 0
    return [
        (lambda: fused._launch(vals, rects, K, C), "launches", None, run),
        (lambda: fused.select_blend_baseline(vals, rects, K, C), "fwd_baseline_launches", None,
         run),
        (lambda: fused.select_blend_stage(vals, rects, K, C, wf), "fwd_stage_launches",
         ("kernel", wf), run),
        (lambda: fused._launch_k9_bwd(vals, rects, g, K, C), ("bwd_launches", "route_launches"),
         None, run),
        (lambda: fused.select_blend_bwd_baseline(vals, rects, g, K, C), "baseline_launches", None,
         run),
        (lambda: fused.select_blend_bwd_stage(vals, rects, g, K, C, wb), "stage_launches",
         ("kernel", wb), run),
        (lambda: fused.select_blend_bwd_tiles(vals, rects, g, K, C), "tiles_launches", None, run),
    ] + [
        (lambda d=d: fused.route(rects, drec, sel, live, K, C, design=d), "route_design_launches",
         d, run) for d in fused.ROUTE_DESIGNS
    ]


def route_scratch(NB, K, C):
    """The route's inputs of NB blocks (zeros: the fake launches read
    nothing)."""
    T = NB * fused.TB
    return (torch.zeros((T, K, 6 + C)), torch.zeros((T, K), dtype=torch.int32),
            torch.zeros((T,), dtype=torch.int32))


def p3_calls(NB):
    C, K, kb = 3, 8, 4
    vals, rects = torch.zeros((NB, kb, fused.NCH)), torch.zeros((NB, kb), dtype=torch.int32)
    run = NB > 0
    return [
        (lambda s=s: fused_bisect._launch(vals, rects, K, C, s), "launches", s, run)
        for s in range(len(fused_bisect.STAGES))
    ] + [
        (lambda s=s: fused_bisect.stage_v1(vals, rects, K, C, s), "v1_launches", s, run)
        for s in range(len(fused_bisect.STAGES))
    ]


def k2_k3_calls(ntx):
    C, K, nty = blend_ct.STAGE_C, 4, 1 if ntx else 0
    T = ntx * nty
    rec = torch.zeros((3, 6 + C + 2))
    idx, cnt = torch.zeros((T, K), dtype=torch.int32), torch.zeros((T,), dtype=torch.int32)
    g = torch.zeros((C + 1, nty * 16, ntx * 16))
    wf, wb = len(blend_ct.FWD_STAGES) - 1, len(blend_ct.STAGES) - 1
    run = T > 0
    return [
        (lambda: blend_ct._launch(rec, idx, cnt, ntx, nty, C), "launches", None, run),
        (lambda: blend_ct.blend_gather_ct_baseline(rec, idx, cnt, ntx, nty, C),
         "fwd_baseline_launches", None, run),
        (lambda: blend_ct.blend_gather_ct_stage(rec, idx, cnt, ntx, nty, C, wf),
         "fwd_stage_launches", ("kernel", wf), run),
        (lambda: blend_ct._launch_k3(rec, idx, cnt, g, ntx, nty, C), "bwd_launches", None, run),
        (lambda: blend_ct.blend_gather_ct_bwd_baseline(rec, idx, cnt, g, ntx, nty, C),
         "baseline_launches", None, run),
        (lambda: blend_ct.blend_gather_ct_bwd_stage(rec, idx, cnt, g, ntx, nty, C, wb),
         "stage_launches", ("kernel", wb), run),
    ]


def k5_calls(T):
    C, K, ntx = 3, 4, 2
    rec = torch.zeros((3, 6 + C + 2))
    idx, cnt = torch.zeros((T, K), dtype=torch.int32), torch.zeros((T,), dtype=torch.int32)
    g = torch.zeros((T, blend_rec.NPIX, C + 1))
    run = T > 0
    return [
        (lambda: blend_rec._launch(rec, idx, cnt, 0, ntx, C), "launches", None, run),
        (lambda: blend_rec.blend_gather_rec_baseline(rec, idx, cnt, 0, ntx, C),
         "fwd_baseline_launches", None, run),
        (lambda: blend_rec._launch_k5_bwd(rec, idx, cnt, 0, g, ntx, C), "bwd_launches", None,
         run),
        (lambda: blend_rec.blend_gather_rec_bwd_baseline(rec, idx, cnt, 0, g, ntx, C),
         "bwd_baseline_launches", None, run),
    ]


CASES = {
    "K8, no tile": (blend, lambda: k8_calls(0, 4)),
    "K8, no slot": (blend, lambda: k8_calls(2, 0)),
    "K8": (blend, lambda: k8_calls(2, 4)),
    "K9, no block": (fused, lambda: k9_calls(0)),
    "K9": (fused, lambda: k9_calls(1)),
    "K2/K3, no tile": (blend_ct, lambda: k2_k3_calls(0)),
    "K2/K3": (blend_ct, lambda: k2_k3_calls(2)),
    "K5, no tile": (blend_rec, lambda: k5_calls(0)),
    "K5": (blend_rec, lambda: k5_calls(2)),
    "P3, no block": (fused_bisect, lambda: p3_calls(0)),
    "P3": (fused_bisect, lambda: p3_calls(1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_wrappers_count_launches_only(fake_card, case):
    """Each wrapper, called once, adds one to its own counter (or
    counters) where it launched its kernel and nothing where its inputs
    were empty; no other counter moves."""
    mod, calls = CASES[case]
    for call, name, key, launched in calls():
        names = name if isinstance(name, tuple) else (name,)
        before = {n: dict(v) if isinstance(v, dict) else v
                  for n in COUNTERS[mod] for v in (getattr(mod, n),)}
        call()
        for n in COUNTERS[mod]:
            now = getattr(mod, n)
            want = before[n]
            if n in names and launched:
                want = want + 1 if key is None else {**want, key: want[key] + 1}
            assert now == want, (case, name, n)
