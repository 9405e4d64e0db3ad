"""Parity of K9, the port's fused select + blend (`raster/fused.py`),
with the JAX package's two kernels in interpret mode on the CPU:
`attic/pallas_fused.py` (v1, banded one-hot compaction) on two 8x8-tile
blocks and `attic/pallas_fused2.py` (v2, butterfly compaction) on the
first of them, kb = 256 candidates a block, K = 32, C = 3 (v1) and 6
(v2). Both layouts reach one `torch.autograd.Function` and one plain
version: per tile, the rect mask, the first K overlapping lanes in rank
order, the tile-local falloff coefficients and K8's plain blend.

The candidates are drawn from a seed: block-local centres around and in
the block, conics of 2-8 px standard deviations with their 3-sigma tile
rects, 8% fully opaque and wide (raw reaches the 0.99 clamp, pixels stop
early), and a tail of invalid candidates
(rect 0, opacity 0, the rest of their channels garbage). Some tiles hold
more than K candidates, so the first-K cut and the uncapped counts are
exercised.

Tolerances, each with its reason: counts exactly equal (integer work).
The JAX kernels run in float32 here (interpret mode, "highest" matmul
precision), in another summation order (matmuls over the basis, the
triangular ones matrix, the compaction's one-hot products); so the image
is held by its p999 absolute error (<= 1e-5) and the share of elements
off by more than 1e-3 (<= 1e-3: threshold flips of the T < 1e-4 stop and
the alpha >= 1/255 skip), and d(vals) by its p999 error within 1e-5 of
its largest |value| with the same flip share at 1e-3 of it
(PALLAS_PARITY.json's columns).

The CUDA kernels run only on the card: the test marked `cuda` holds them
against the plain versions in both layouts and skips without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3ga_tpu.raster.attic import pallas_fused as jf1
from d3ga_tpu.raster.attic import pallas_fused2 as jf2
from d3ga_tpu_torch.raster import fused
from test_torch_raster_bwd import flip_close
from torch_parity import jit_o0

KB, K = 256, 32
P999_ABS = 1e-5


def candidates(seed, nb, kb, C, n_invalid=40):
    """Records-major vals [nb, kb, 16] and packed rects [nb, kb] (numpy),
    in rank order."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-24, 152, (nb, kb, 2))
    s = rng.uniform(2.0, 8.0, (nb, kb, 2))
    th = rng.uniform(0, np.pi, (nb, kb))
    c, si = np.cos(th), np.sin(th)
    R = np.stack([c, -si, si, c], -1).reshape(nb, kb, 2, 2)
    cov = R @ (np.eye(2) * (s**2)[..., None, :]) @ np.swapaxes(R, -1, -2)
    inv = np.linalg.inv(cov)
    conic = np.stack([inv[..., 0, 0], inv[..., 0, 1], inv[..., 1, 1]], -1)
    radius = np.ceil(3 * s.max(-1))
    opac = rng.uniform(0.3, 0.99, (nb, kb))
    wide = rng.uniform(size=(nb, kb)) < 0.08
    conic[wide] = (1 / 400, 0.0, 1 / 400)
    opac[wide] = 1.0
    radius[wide] = 60
    vals = np.zeros((nb, kb, 16), np.float32)
    vals[..., 0:2], vals[..., 2:5], vals[..., 5] = xy, conic, opac
    vals[..., 6 : 6 + C] = rng.uniform(0, 1, (nb, kb, C))
    lo = np.clip(np.floor((xy - radius[..., None]) / 16), 0, 8).astype(np.int64)
    hi = np.clip(np.floor((xy + radius[..., None] + 15) / 16), 0, 8).astype(np.int64)
    rects = lo[..., 0] | (hi[..., 0] << 8) | (lo[..., 1] << 16) | (hi[..., 1] << 24)
    # the invalid tail: never overlaps, no opacity, garbage elsewhere
    rects[:, kb - n_invalid :] = 0
    vals[:, kb - n_invalid :, 5] = 0.0
    vals[:, kb - n_invalid :, 6:] = rng.normal(size=(nb, n_invalid, 10))
    return vals, rects.astype(np.int32)


def v1_layout(vals, rects):
    nb, kb, _ = vals.shape
    return (np.ascontiguousarray(vals.reshape(nb, kb // 128, 128, 16).transpose(0, 1, 3, 2)),
            rects.reshape(nb, kb // 128, 128))


def v2_layout(vals, rects):
    return np.ascontiguousarray(vals.transpose(0, 2, 1)), rects[:, None, :]


def image_close(a, b):
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    assert np.quantile(err, 0.999) <= P999_ABS
    assert np.mean(err > 1e-3) <= 1e-3


CASES = {  # variant: (blocks, C, layout, JAX forward, JAX backward)
    1: (2, 3, v1_layout, jf1._run_forward, jf1._run_backward),
    2: (1, 6, v2_layout, jf2._run_forward, jf2._run_backward),
}


@pytest.fixture(scope="module", params=[1, 2])
def case(request):
    """One variant's inputs (in its layout), a seeded cotangent, and the
    JAX kernel's tiles, counts and d(vals)."""
    variant = request.param
    nb, C, layout, jfwd, jbwd = CASES[variant]
    vals, rects = layout(*candidates(variant, nb, KB, C))
    g = np.random.default_rng(10 + variant).normal(size=(nb, 64, 256, C + 1)).astype(np.float32)
    args = tuple(jnp.asarray(a) for a in (vals, rects, g))
    run = jit_o0(lambda v, r, gg: (jfwd(v, r, K, C, True), jbwd(v, r, gg, K, C, True)), *args)
    (tiles, counts), dvals = run(*args)
    return dict(variant=variant, C=C, vals=vals, rects=rects, g=g, j_tiles=np.asarray(tiles),
                j_counts=np.asarray(counts), j_dvals=np.asarray(dvals))


def port_fn(variant):
    return fused.fused_select_blend if variant == 1 else fused.fused_select_blend2


def test_plain_matches_jax_kernel(case):
    C, nb = case["C"], case["vals"].shape[0]
    vals = torch.from_numpy(case["vals"]).requires_grad_(True)
    before = (fused.launches, fused.bwd_launches)
    tiles, counts = port_fn(case["variant"])(vals, torch.from_numpy(case["rects"]), K, C)
    assert type(tiles.grad_fn).__name__ == "_FusedSelectBlendBackward"
    assert tiles.shape == case["j_tiles"].shape == (nb, 64, 256, C + 1)
    assert counts.dtype == torch.int32 and counts.shape == (nb, 64)
    assert np.array_equal(counts.numpy(), case["j_counts"])
    image_close(tiles.detach().numpy(), case["j_tiles"])
    # the cap is exercised: tiles over K and under it
    cnt = case["j_counts"]
    assert (cnt > K).any() and ((cnt > 0) & (cnt < K)).any()
    tiles.backward(torch.from_numpy(case["g"]))
    assert (fused.launches, fused.bwd_launches) == before
    assert vals.grad.shape == vals.shape
    flip_close(vals.grad.numpy(), case["j_dvals"])
    # the padding channels and the invalid candidates get no cotangent
    rec = fused._records(vals.grad)
    assert float(rec[..., 6 + C :].abs().max()) == 0.0
    invalid = torch.from_numpy(case["rects"]).reshape(nb, -1) == 0
    assert float(rec[invalid].abs().max()) == 0.0


def test_layouts_reach_one_function(case):
    """v1, v2 and the records-major entry on the same candidates give the
    same tiles, counts and d(vals) (each in its own layout), and the
    autograd backward is the plain backward."""
    C = case["C"]
    vals_r = fused._records(torch.from_numpy(case["vals"])).contiguous()
    rects_r = torch.from_numpy(case["rects"]).reshape(vals_r.shape[0], -1)
    g = torch.from_numpy(case["g"])
    outs = []
    for variant, layout in ((1, v1_layout), (2, v2_layout)):
        v, r = (torch.from_numpy(a) for a in layout(vals_r.numpy(), rects_r.numpy()))
        v.requires_grad_(True)
        tiles, counts = port_fn(variant)(v, r, K, C)
        tiles.backward(g)
        outs.append((tiles.detach(), counts, fused._records(v.grad)))
    tiles, counts = fused.select_blend(vals_r, rects_r, K, C)
    outs.append((tiles, counts, fused.select_blend_bwd(vals_r, rects_r, g, K, C)))
    for a, b, c in zip(*outs):
        assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(ValueError, match="v2 layout"):
        fused.fused_select_blend2(
            *(torch.from_numpy(a) for a in v1_layout(vals_r.numpy(), rects_r.numpy())), K, C)


def test_plain_block_chunks(case):
    """The plain versions step through the blocks BLOCK_CHUNK at a time;
    one block a step gives the same tiles, counts and d(vals)."""
    C = case["C"]
    vals = fused._records(torch.from_numpy(case["vals"])).contiguous()
    rects = torch.from_numpy(case["rects"]).reshape(vals.shape[0], -1)
    g = torch.from_numpy(case["g"])
    whole = (*fused.select_blend_plain(vals, rects, K, C),
             fused.select_blend_bwd_plain(vals, rects, g, K, C))
    one = (*fused.select_blend_plain(vals, rects, K, C, block_chunk=1),
           fused.select_blend_bwd_plain(vals, rects, g, K, C, block_chunk=1))
    for a, b in zip(whole, one):
        assert torch.equal(a, b)


def test_wrappers_check_their_inputs():
    meta = torch.empty(1, 16, 128, device="meta")
    rmeta = torch.empty(1, 1, 128, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        fused.fused_select_blend2(meta, rmeta, 8, 3)
    with pytest.raises(ValueError, match="device"):
        fused.select_blend_bwd(meta.permute(0, 2, 1), rmeta[:, 0],
                               torch.empty(1, 64, 256, 4, device="meta"), 8, 3)
    vals, rects = torch.zeros(1, 128, 16), torch.zeros(1, 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="C=11"):
        fused._check("k9", vals, rects, 8, 11)
    with pytest.raises(ValueError, match="K=2048"):
        fused._check("k9", vals, rects, 2048, 3)
    with pytest.raises(ValueError, match=r"expected \[NB, kb, 16\]"):
        fused._check("k9", vals, torch.zeros(1, 256, dtype=torch.int32), 8, 3)
    with pytest.raises(ValueError, match="expected"):
        fused.fused_select_blend(torch.zeros(16, 128), rects, 8, 3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain(case, cuda_device):
    C = case["C"]
    vals, rects, g = (torch.from_numpy(case[k]).to(cuda_device) for k in ("vals", "rects", "g"))
    with torch.no_grad():
        tiles, counts = port_fn(case["variant"])(vals, rects, K, C)
    rec, rr = fused._records(vals).contiguous(), rects.reshape(rects.shape[0], -1)
    ref, ref_counts = fused.select_blend_plain(rec, rr, K, C)
    dvals = fused.select_blend_bwd(rec, rr, g, K, C)
    dref = fused.select_blend_bwd_plain(rec, rr, g, K, C)
    torch.cuda.synchronize()
    assert torch.equal(counts, ref_counts)
    image_close(tiles.cpu().numpy(), ref.cpu().numpy())
    flip_close(dvals.cpu().numpy(), dref.cpu().numpy())
