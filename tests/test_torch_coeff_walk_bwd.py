"""K8's backward around its kernel (`raster/blend.py`,
`csrc/blend_coeffs.cu::blend_coeffs_bwd_kernel` on
`csrc/coeff_walk_bwd.cuh`'s walk): what the CPU can hold of it.

- The baseline design (`blend_tiles_coeffs_bwd_baseline`, the `_v1`) and
  the stage entry point (`blend_tiles_coeffs_bwd_stage`) refuse CPU
  tensors; unknown designs and stages, cuts of the design built whole
  only, and cuts at another C than STAGE_C raise.
- The plain backward on `chip_smoke.k8_edge_cases` gives exactly zero in
  all three outputs for every opacity-0 slot, but for NaN where
  exp(power) overflows at a pixel of the tile (dalpha exp(power) = 0 x inf
  in its dense sums, as in the JAX kernel, `test_torch_coeff_bwd.py`):
  only in d(coeffs) and d(opacs), never in d(colors). The card's check
  (`chip_smoke.k8_bwd_holds`) holds the kernel to exact zeros there and
  leaves plain's NaNs out of the comparison.
- A `cuda` test running that check on the card.
"""

import pytest
import torch

import chip_smoke
from d3ga_tpu_torch.raster import blend
from d3ga_tpu_torch.raster.blend_ct import split_power

CASES = {c[0]: c for c in chip_smoke.k8_edge_cases(torch.device("cpu"))}


def cotangent(name):
    _, co, _, _, C = CASES[name]
    return chip_smoke.k8_cotangent(co, C, 40 + list(CASES).index(name))


def test_baseline_and_stages_need_the_card():
    """The `_v1` and every (design, stage) cut raise on CPU tensors;
    unknown designs and stages, the cuts of the design built whole only,
    and the cuts at another C than STAGE_C, raise; no counter moves."""
    name = f"{chip_smoke.K8_PADDING} at C={blend.STAGE_C}"
    _, co, col, op, C = CASES[name]
    g = cotangent(name)
    whole = len(blend.BWD_STAGES) - 1
    with pytest.raises(ValueError, match="CUDA"):
        blend.blend_tiles_coeffs_bwd_baseline(co, col, op, g)
    for d in blend.BWD_DESIGNS:
        for st in range(len(blend.BWD_STAGES)):
            cut_short = d != "kernel" and st < whole
            with pytest.raises(ValueError, match=f"stage {whole}" if cut_short else "CUDA"):
                blend.blend_tiles_coeffs_bwd_stage(co, col, op, g, st, design=d)
    for st, d in ((whole + 1, "kernel"), (-1, "kernel"), (whole, "kernel_p1"),
                  (whole, "baseline")):
        with pytest.raises(ValueError, match="stage"):
            blend.blend_tiles_coeffs_bwd_stage(co, col, op, g, st, design=d)
    name3 = f"{chip_smoke.K8_PADDING} at C=3"
    _, co3, col3, op3, _ = CASES[name3]
    for st in range(whole):
        with pytest.raises(ValueError, match=f"C = {blend.STAGE_C} only"):
            blend.blend_tiles_coeffs_bwd_stage(co3, col3, op3, cotangent(name3), st)
    for d in blend.BWD_DESIGNS:  # whole, at any C: refused as CPU tensors only
        with pytest.raises(ValueError, match="CUDA"):
            blend.blend_tiles_coeffs_bwd_stage(co3, col3, op3, cotangent(name3), whole, design=d)
    assert blend.bwd_baseline_launches == 0 and not any(blend.bwd_stage_launches.values())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_bwd_zero_on_opacity_0_slots(name):
    _, co, col, op, C = CASES[name]
    dco, dcol, dop = blend.blend_tiles_coeffs_bwd_plain(co, col, op, cotangent(name))
    dead = op[:, 0, :] == 0
    assert bool(dead.any()) or name.startswith("C=")
    # the slots where exp(power) overflows at some pixel of the tile
    e = torch.exp(split_power(blend._pixel_basis(co.device), co[..., :6]))  # [T, 256, K]
    overflow = torch.isinf(e).any(1)
    for d in (dco[dead], dop[:, 0, :][dead], dcol[dead]):
        assert bool((torch.nan_to_num(d, nan=0.0) == 0).all())
    assert not bool(dcol.isnan().any())
    nan_slots = dco.isnan().any(-1) | dop[:, 0, :].isnan()
    assert not bool((nan_slots & ~overflow).any())
    assert bool((nan_slots & dead).any()) == name.startswith(chip_smoke.K8_PADDING)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_backward_edges_on_card(cuda_device):
    """chip_smoke.py's K8 backward check on the card: finite, zero in the
    padding columns and for every opacity-0 slot, within K3's tolerances
    of plain (but the on-threshold tiles), within K3_REL_L2 of its `_v1`
    on every case, bit-equal across launches and to its unculled build."""
    assert chip_smoke.check_k8_bwd_edges(cuda_device, lambda msg: None) == len(CASES)
