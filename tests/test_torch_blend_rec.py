"""Parity of K5, the port's flat-tiles record blend (`raster/blend_rec.py`),
with the JAX package's `pallas_blend_rec._run_forward` / `_run_backward`
(interpret mode) on the CPU, at tile offset 0 and past it, and of
`blend_gather_rec`'s VJP (K5 backward + the per-Gaussian combine) with
`pallas_segsum.blend_gather_segsum_rec`'s.

An 80x64 frame is a 5x4 grid of tiles; the blends cover one half of it,
tiles 0-9 or 10-19, as two ranks of a row-banded shard would. K = 256
drives both of the Pallas kernel's branches (its count-adaptive half
width for tiles with <= 128 records, the full width above).

Tolerances, as for K2/K3 (tests/test_torch_raster.py,
tests/test_torch_raster_bwd.py), whose math K5 shares: the tiles within
atol 1e-4 (the JAX kernel's bf16 hi/lo split matmuls are good to about
2^-17 relative, and it composites in the log domain); the per-slot
cotangents' p999 error within 1e-5 of the largest and at most a 1e-3
share off by more than 1e-3 of it (threshold flips at the 0.99 clamp and
the T < 1e-4 stop); the per-Gaussian gradients within 1e-5 of the
largest, rtol 1e-4.

The segsum combine runs with `pallas_segsum.W` = 1280 lanes (16384 by
default), the same kernel and sums with a 13x shorter trace; its window
then covers 128 Gaussians of up to dup^2 = 9 slots each, so the
selection uses dup 3 (at dup 8, block_width(64) = 0 would send the JAX
path down its non-segsum branch).

The CUDA kernels run only on the card: the tests marked `cuda` hold
them against the plain versions and skip without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3ga_tpu.raster import pallas_blend_rec as jbrec
from d3ga_tpu.raster import pallas_segsum as jseg
from d3ga_tpu_torch.raster import blend_ct, blend_rec, segsum
from d3ga_tpu_torch.raster import tiles as ttiles
from test_torch_raster import IMG_ATOL, blend_inputs, cameras, random_scene
from test_torch_raster_bwd import flip_close, rel_close
from torch_parity import jit_o0

NTX, NTY, C = 5, 4, 6
T_LOC = 10  # two tile rows: one band of a 2-rank split
OFFSETS = (0, T_LOC)
K = 256
DUP = 3
DUP2 = DUP * DUP


@pytest.fixture(scope="module")
def records():
    """Records over the whole 80x64 frame, front-to-back ids and counts
    for its 20 tiles (empty, partial and full tiles); a quarter of the
    records fully opaque and wide (sigma 20 px), so raw reaches the 0.99
    clamp near their centres and many pixels stop early."""
    records_ext, idx, counts = blend_inputs(21, NTX, NTY, K, n=400)
    records_ext[:-1:4, 2:5] = (1 / 400, 0.0, 1 / 400)
    records_ext[:-1:4, 5] = 1.0
    counts[T_LOC + 1] = 0
    counts[T_LOC + 2] = K
    idx[T_LOC + 1] = 400
    return records_ext, idx, counts


@pytest.fixture(scope="module")
def jax_kernels():
    """K5 forward and backward (interpret mode), compiled once: the
    tile offset is an argument."""
    rec = jax.ShapeDtypeStruct((T_LOC, K, 6 + C), jnp.float32)
    cnt = jax.ShapeDtypeStruct((T_LOC,), jnp.int32)
    off = jax.ShapeDtypeStruct((), jnp.int32)
    g = jax.ShapeDtypeStruct((T_LOC, 256, C + 1), jnp.float32)
    fwd = jit_o0(lambda r, c, o: jbrec._run_forward(r, c, o, NTX, C, interpret=True), rec, cnt, off)
    bwd = jit_o0(lambda r, c, o, gg: jbrec._run_backward(r, c, o, gg, NTX, C, interpret=True),
                 rec, cnt, off, g)
    return fwd, bwd


def local(records, off):
    records_ext, idx, counts = records
    return records_ext, idx[off : off + T_LOC], counts[off : off + T_LOC]


@pytest.mark.parametrize("off", OFFSETS)
def test_fwd_plain_matches_pallas_kernel(records, jax_kernels, off):
    records_ext, idx, counts = local(records, off)
    j = jax_kernels[0](jnp.asarray(records_ext)[jnp.asarray(idx)], jnp.asarray(counts),
                       jnp.int32(off))
    t, pairs = blend_rec.blend_gather_rec_plain(
        *map(torch.from_numpy, (records_ext, idx, counts)), off, NTX, C, tile_chunk=4,
        count_pairs=True,
    )
    assert t.shape == j.shape == (T_LOC, 256, C + 1)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=IMG_ATOL)
    assert 0 < pairs < 256 * int(counts.sum())
    assert float(t[..., C].min()) < 1e-3  # pixels stopped early
    if off:  # the empty tile: no colour, T_bg = 1
        assert float(t[1, :, :C].abs().max()) == 0.0 and float(t[1, :, C].min()) == 1.0


@pytest.mark.parametrize("off", OFFSETS)
def test_fwd_plain_is_the_ct_blend_of_its_tiles(records, off):
    """K5's tiles are K2's image, cut to the same tiles: the offset
    places each tile's origin."""
    records_ext, idx, counts = (torch.from_numpy(a) for a in records)
    img = blend_ct.blend_gather_ct_plain(records_ext, idx, counts, NTX, NTY, C)
    tiles = img.reshape(C + 1, NTY, 16, NTX, 16).permute(1, 3, 2, 4, 0).reshape(-1, 256, C + 1)
    out = blend_rec.blend_gather_rec_plain(
        records_ext, idx[off : off + T_LOC], counts[off : off + T_LOC], off, NTX, C)
    assert torch.equal(out, tiles[off : off + T_LOC])


@pytest.mark.parametrize("off", OFFSETS)
def test_bwd_plain_matches_pallas_kernel(records, jax_kernels, off):
    records_ext, idx, counts = local(records, off)
    g = np.random.default_rng(off).normal(size=(T_LOC, 256, C + 1)).astype(np.float32)
    j = jax_kernels[1](jnp.asarray(records_ext)[jnp.asarray(idx)], jnp.asarray(counts),
                       jnp.int32(off), jnp.asarray(g))
    t = blend_rec.blend_gather_rec_bwd(
        *map(torch.from_numpy, (records_ext, idx, counts)), off, torch.from_numpy(g), NTX, C)
    assert t.shape == (T_LOC, K, 6 + C)
    flip_close(t.numpy(), np.asarray(j))
    dead = np.arange(K)[None] >= counts[:, None]
    assert np.all(t.numpy()[dead] == 0.0)


@pytest.fixture(scope="module")
def selection():
    """A real dup-3 selection of an 80x64 frame (300 Gaussians, K 64),
    cut to tiles 10-19, and a cotangent for them."""
    means, cov6, opac, colors = random_scene(8, 300, 80, 64)
    opac[::7] = 1.0
    _, tcam = cameras(80, 64)
    b = ttiles.bin_gaussians(
        torch.from_numpy(means), tcam, torch.from_numpy(cov6), torch.from_numpy(opac),
        torch.from_numpy(colors), 64, DUP, plain=True,
    )
    idx = b.idx[T_LOC:].contiguous()
    cnt = torch.clamp(b.counts[T_LOC:], max=64).contiguous()
    g = np.random.default_rng(2).normal(size=(T_LOC, 256, C + 1)).astype(np.float32)
    return b.records_ext, idx, cnt, torch.from_numpy(g)


def test_vjp_matches_jax(selection):
    """The gradient wrt the packed records through the autograd.Function
    (CPU route: plain K5 forward and backward, sort, K4) against jax.vjp
    of blend_gather_segsum_rec (K5 and the segsum combine)."""
    records_ext, idx, cnt, g = selection

    def fwd_bwd(r, i, c, gg):
        out, vjp = jax.vjp(
            lambda rr: jseg.blend_gather_segsum_rec(rr, i, c, T_LOC, NTX, C, DUP2, True), r)
        return out, vjp(gg)[0]

    mp = pytest.MonkeyPatch()
    mp.setattr(jseg, "W", 1280)
    try:
        args = tuple(jnp.asarray(t.numpy()) for t in (records_ext, idx, cnt, g))
        j_out, j_grad = jit_o0(fwd_bwd, *args)(*args)
    finally:
        mp.undo()
    rec = records_ext.clone().requires_grad_(True)
    before = (blend_rec.launches, blend_rec.bwd_launches, segsum.launches)
    out = blend_rec.blend_gather_rec(rec, idx, cnt, T_LOC, NTX, C, dup2=DUP2)
    assert type(out.grad_fn).__name__ == "_BlendGatherRecBackward"
    out.backward(g)
    assert (blend_rec.launches, blend_rec.bwd_launches, segsum.launches) == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=IMG_ATOL)
    rel_close(rec.grad.numpy(), np.asarray(j_grad), rtol=1e-4)
    # the Function's backward is exactly the plain K5 backward + combine
    drec = blend_rec.blend_gather_rec_bwd_plain(records_ext, idx, cnt, T_LOC, g, NTX, C)
    n = records_ext.shape[0] - 1
    assert torch.equal(rec.grad, segsum.combine_from_slots(drec, idx, n, DUP2, plain=True))


def test_wrapper_uses_plain_on_cpu(records):
    records_ext, idx, counts = (torch.from_numpy(a) for a in local(records, T_LOC))
    before = blend_rec.launches
    out = blend_rec.blend_gather_rec(records_ext, idx, counts, T_LOC, NTX, C)
    assert torch.equal(out, blend_rec.blend_gather_rec_plain(records_ext, idx, counts, T_LOC,
                                                             NTX, C))
    assert blend_rec.launches == before


def test_wrappers_raise_off_cpu_and_cuda():
    meta = torch.empty(10, dtype=torch.int32, device="meta")
    rec = torch.empty(5, 12, device="meta")
    with pytest.raises(ValueError, match="device"):
        blend_rec.blend_gather_rec(rec, meta.reshape(1, 10), meta[:1], 0, 1, 6)
    with pytest.raises(ValueError, match="device"):
        blend_rec.blend_gather_rec_bwd(rec, meta.reshape(1, 10), meta[:1], 0,
                                       torch.empty(1, 256, 7, device="meta"), 1, 6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("off", OFFSETS)
def test_kernels_match_plain(records, cuda_device, off):
    records_ext, idx, counts = local(records, off)
    args = [torch.from_numpy(a).to(cuda_device) for a in (records_ext, idx, counts)]
    g = torch.randn(T_LOC, 256, C + 1, device=cuda_device)
    out = blend_rec.blend_gather_rec(*args, off, NTX, C)
    ref = blend_rec.blend_gather_rec_plain(*args, off, NTX, C)
    drec = blend_rec.blend_gather_rec_bwd(*args, off, g, NTX, C)
    drec_ref = blend_rec.blend_gather_rec_bwd_plain(*args, off, g, NTX, C)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=IMG_ATOL)
    flip_close(drec.cpu().numpy(), drec_ref.cpu().numpy())
