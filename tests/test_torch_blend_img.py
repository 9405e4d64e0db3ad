"""Parity of K7, the port's image-layout record blend
(`raster/blend_rec.py::blend_gather_img`), with the JAX package's
`pallas_blend_rec._run_forward_img` / `_run_backward_img` (interpret
mode) on the CPU, and of `blend_gather_img`'s VJP (K7 backward + the
per-Gaussian combine) with `jax.vjp` of `blend_image_rec` on a gathered
record tensor (the JAX package's XLA scatter-add sums the slots).

A 32x48 frame is a 2x3 grid of tiles, K = 128: the JAX kernel then blends
two tiles a program (`_img_group`) at its full width, a short
interpret-mode trace; its tile groups and half width are tiling choices,
not semantics.

Tolerances, as for K2/K3/K5, whose math K7 shares (tests/
test_torch_raster.py, tests/test_torch_raster_bwd.py,
tests/test_torch_blend_rec.py): the image within atol 1e-4 (the JAX
kernel's bf16 hi/lo split matmuls are good to about 2^-17 relative, and
it composites in the log domain); the per-slot cotangents' p999 error
within 1e-5 of the largest and at most a 1e-3 share off by more than 1e-3
of it (threshold flips at the 0.99 clamp and the T < 1e-4 stop); the
per-Gaussian gradients within 1e-5 of the largest, rtol 1e-4.

The CUDA kernels run only on the card: the test marked `cuda` holds them
against the plain versions and skips without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3ga_tpu.raster import pallas_blend_rec as jbrec
from d3ga_tpu_torch.raster import blend_ct, blend_rec, segsum
from test_torch_raster import IMG_ATOL, blend_inputs
from test_torch_raster_bwd import flip_close, rel_close
from torch_parity import jit_o0

NTX, NTY, C, K = 2, 3, 6, 128


@pytest.fixture(scope="module")
def records():
    """Records over the 32x48 frame with empty, partial and full tiles; a
    quarter fully opaque and wide (sigma 20 px), so raw reaches the 0.99
    clamp near their centres and many pixels stop early; each record used
    by up to three tiles."""
    records_ext, idx, counts = blend_inputs(31, NTX, NTY, K, n=150)
    records_ext[:-1:4, 2:5] = (1 / 400, 0.0, 1 / 400)
    records_ext[:-1:4, 5] = 1.0
    return records_ext, idx, counts


def test_fwd_plain_matches_pallas_kernel(records):
    records_ext, idx, counts = records
    rec = jnp.asarray(records_ext)[jnp.asarray(idx)]
    args = (rec, jnp.asarray(counts))
    j = jit_o0(lambda r, c: jbrec._run_forward_img(r, c, NTX, NTY, C, interpret=True), *args)(*args)
    t, pairs = blend_rec.blend_gather_img_plain(
        *map(torch.from_numpy, records), NTX, NTY, C, tile_chunk=4, count_pairs=True)
    assert t.shape == j.shape == (NTY * 16, NTX * 16, C + 1)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=IMG_ATOL)
    assert 0 < pairs < 256 * int(counts.sum())
    assert float(t[..., C].min()) < 1e-3  # pixels stopped early
    # tile 0 is empty: no colour, T_bg = 1
    assert float(t[:16, :16, :C].abs().max()) == 0.0 and float(t[:16, :16, C].min()) == 1.0


def test_fwd_plain_is_the_ct_image_transposed(records):
    """K7's image is K2's planar image with the channels moved last, to
    the last bit: the same walk in the same order."""
    args = tuple(torch.from_numpy(a) for a in records)
    img = blend_rec.blend_gather_img_plain(*args, NTX, NTY, C)
    planar = blend_ct.blend_gather_ct_plain(*args, NTX, NTY, C)
    assert torch.equal(img, planar.permute(1, 2, 0))


def test_vjp_matches_jax(records):
    """The gradient wrt the packed records through the autograd.Function
    (CPU route: plain K7 forward and backward, sort, K4) against jax.vjp
    of the gather + blend_image_rec (K7 forward and backward, the
    gather's scatter-add); K7's per-slot cotangents against
    `_run_backward_img`."""
    records_ext, idx, counts = records
    g = np.random.default_rng(3).normal(size=(NTY * 16, NTX * 16, C + 1)).astype(np.float32)

    def fwd_bwd(r, i, c, gg):
        out, vjp = jax.vjp(lambda rr: jbrec.blend_image_rec(rr[i], c, NTX, NTY, C, True), r)
        drec = jbrec._run_backward_img(r[i], c, gg, NTX, NTY, C, interpret=True)
        return out, vjp(gg)[0], drec

    args = tuple(jnp.asarray(a) for a in (records_ext, idx, counts, g))
    j_out, j_grad, j_drec = jit_o0(fwd_bwd, *args)(*args)

    t_idx, t_cnt, t_g = (torch.from_numpy(a) for a in (idx, counts, g))
    drec = blend_rec.blend_gather_img_bwd(torch.from_numpy(records_ext), t_idx, t_cnt, t_g,
                                          NTX, NTY, C)
    assert drec.shape == (NTX * NTY, K, 6 + C)
    flip_close(drec.numpy(), np.asarray(j_drec))
    dead = np.arange(K)[None] >= counts[:, None]
    assert np.all(drec.numpy()[dead] == 0.0)

    rec = torch.from_numpy(records_ext).requires_grad_(True)
    before = (blend_rec.img_launches, blend_rec.img_bwd_launches, segsum.launches)
    out = blend_rec.blend_gather_img(rec, t_idx, t_cnt, NTX, NTY, C)
    assert type(out.grad_fn).__name__ == "_BlendGatherImgBackward"
    out.backward(t_g)
    assert (blend_rec.img_launches, blend_rec.img_bwd_launches, segsum.launches) == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=IMG_ATOL)
    rel_close(rec.grad.numpy(), np.asarray(j_grad), rtol=1e-4)
    # the Function's backward is exactly the plain K7 backward + combine
    n = records_ext.shape[0] - 1
    assert torch.equal(rec.grad, segsum.combine_from_slots(drec, t_idx, n, plain=True))


def test_wrapper_uses_plain_on_cpu(records):
    args = tuple(torch.from_numpy(a) for a in records)
    before = blend_rec.img_launches
    out = blend_rec.blend_gather_img(*args, NTX, NTY, C)
    assert torch.equal(out, blend_rec.blend_gather_img_plain(*args, NTX, NTY, C))
    assert blend_rec.img_launches == before


def test_wrappers_raise_off_cpu_and_cuda():
    meta = torch.empty(10, dtype=torch.int32, device="meta")
    rec = torch.empty(5, 12, device="meta")
    with pytest.raises(ValueError, match="device"):
        blend_rec.blend_gather_img(rec, meta.reshape(1, 10), meta[:1], 1, 1, 6)
    with pytest.raises(ValueError, match="device"):
        blend_rec.blend_gather_img_bwd(rec, meta.reshape(1, 10), meta[:1],
                                       torch.empty(16, 16, 7, device="meta"), 1, 1, 6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain(records, cuda_device):
    args = [torch.from_numpy(a).to(cuda_device) for a in records]
    g = torch.randn(NTY * 16, NTX * 16, C + 1, device=cuda_device)
    out = blend_rec.blend_gather_img(*args, NTX, NTY, C)
    ref = blend_rec.blend_gather_img_plain(*args, NTX, NTY, C)
    planar = blend_ct.blend_gather_ct(*args, NTX, NTY, C)
    drec = blend_rec.blend_gather_img_bwd(*args, g, NTX, NTY, C)
    drec_ref = blend_rec.blend_gather_img_bwd_plain(*args, g, NTX, NTY, C)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=IMG_ATOL)
    assert torch.equal(out, planar.permute(1, 2, 0))  # K7 is K2's image, to the last bit
    flip_close(drec.cpu().numpy(), drec_ref.cpu().numpy())
