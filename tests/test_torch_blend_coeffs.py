"""Parity of K8, the port's blend over precomputed falloff coefficients
(`raster/blend.py`), with the JAX package's `pallas_blend._run_forward`
/ `_run_backward` (interpret mode) on the CPU, at 8 tiles of K = 32 slots
with C = 3 and C = 6; and of `falloff_coeffs` with the JAX function.

The slots are gathered records of `test_torch_raster.blend_inputs` (a
quarter of them fully opaque and wide, so raw reaches the 0.99 clamp and
many pixels stop early), shifted to tile-local coordinates; slots past a
tile's count have opacity 0, as the stage bench's `opac_in`.

Tolerances, each with its reason: `falloff_coeffs` exactly equal (the
same float32 expressions). The JAX kernel contracts in bf16 hi/lo split
matmuls, good to about 2^-17 relative per sum, also in interpret mode;
the port sums in float32. So the image is held, as PALLAS_PARITY.json's
columns are, by its p999 absolute error (<= 1e-5) and the share of
pixels off by more than 1e-3 (<= 1e-3: the T < 1e-4 stop and the
alpha >= 1/255 skip can flip where a pixel sits at the threshold), and
each cotangent (d(coeffs), d(colors), d(opacs)) by its p999 error within
1e-5 of its largest |value| and the same flip share at 1e-3 of it.

The CUDA kernels run only on the card: the test marked `cuda` holds them
against the plain versions and skips without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3ga_tpu.raster import pallas_blend as jpb
from d3ga_tpu_torch.raster import blend
from test_torch_raster import blend_inputs
from test_torch_raster_bwd import flip_close
from torch_parity import jit_o0

NTX, NTY, K = 4, 2, 32
P999_ABS = 1e-5


def slots(C):
    """(xy_local [T, K, 2], conic [T, K, 3], colors [T, K, C], opacs
    [T, 1, K]) float32 numpy, from blend_inputs' records and ids."""
    records_ext, idx, counts = blend_inputs(11 + C, NTX, NTY, K, n=80, c=C)
    records_ext[:-1:4, 2:5] = (1 / 400, 0.0, 1 / 400)
    records_ext[:-1:4, 5] = 1.0
    rec = records_ext[idx]  # [T, K, 6+C]
    t = np.arange(NTX * NTY)
    origin = np.stack([t % NTX * 16, t // NTX * 16], -1).astype(np.float32)
    live = np.arange(K)[None] < counts[:, None]
    xy_local = (rec[..., 0:2] - origin[:, None, :]).astype(np.float32)
    opacs = np.where(live, rec[..., 5], 0.0).astype(np.float32)[:, None, :]
    return xy_local, rec[..., 2:5], np.ascontiguousarray(rec[..., 6:]), opacs


def image_close(a, b):
    err = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel()
    assert np.quantile(err, 0.999) <= P999_ABS
    assert np.mean(err > 1e-3) <= 1e-3


@pytest.fixture(scope="module", params=[3, 6])
def case(request):
    """The inputs at C colours, their JAX coefficients, and the JAX
    kernels' forward and backward for a seeded cotangent."""
    C = request.param
    xy_local, conic, colors, opacs = slots(C)
    j_coeffs = np.asarray(jpb.falloff_coeffs(jnp.asarray(xy_local), jnp.asarray(conic)))
    g = np.random.default_rng(C).normal(size=(NTX * NTY, 256, C + 1)).astype(np.float32)
    args = tuple(jnp.asarray(a) for a in (j_coeffs, colors, opacs, g))
    fwd_bwd = jit_o0(lambda co, col, op, gg: (jpb._run_forward(co, col, op, interpret=True),
                                              jpb._run_backward(co, col, op, gg, interpret=True)),
                     *args)
    out, grads = fwd_bwd(*args)
    return dict(C=C, xy_local=xy_local, conic=conic, colors=colors, opacs=opacs, g=g,
                j_coeffs=j_coeffs, j_out=np.asarray(out), j_grads=[np.asarray(x) for x in grads])


def port_inputs(case):
    coeffs = blend.falloff_coeffs(torch.from_numpy(case["xy_local"]),
                                  torch.from_numpy(case["conic"]))
    return coeffs, torch.from_numpy(case["colors"]), torch.from_numpy(case["opacs"])


def test_falloff_coeffs_exact(case):
    coeffs, _, _ = port_inputs(case)
    assert coeffs.shape == (NTX * NTY, K, 8)
    assert np.array_equal(coeffs.numpy(), case["j_coeffs"])


def test_fwd_plain_matches_pallas_kernel(case):
    C = case["C"]
    out, pairs = blend.blend_tiles_coeffs_plain(*port_inputs(case), tile_chunk=3, count_pairs=True)
    assert out.shape == case["j_out"].shape == (NTX * NTY, 256, C + 1)
    image_close(out.numpy(), case["j_out"])
    live = int((case["opacs"] > 0).sum())
    assert 0 < pairs < 256 * live
    assert float(out[..., C].min()) < 1e-3  # pixels stopped early
    # a tile with no live slot: no colour, T_bg = 1
    empty = np.flatnonzero((case["opacs"] > 0).sum((1, 2)) == 0)
    assert empty.size and float(out[empty[0], :, :C].abs().max()) == 0.0
    assert float(out[empty[0], :, C].min()) == 1.0


def test_bwd_plain_matches_pallas_kernel(case):
    coeffs, colors, opacs = port_inputs(case)
    grads = blend.blend_tiles_coeffs_bwd_plain(coeffs, colors, opacs,
                                               torch.from_numpy(case["g"]), tile_chunk=3)
    for t, j, shape in zip(grads, case["j_grads"], (coeffs.shape, colors.shape, opacs.shape)):
        assert t.shape == j.shape == shape
        flip_close(t.numpy(), j)
    # the padding coefficients and the dead slots carry no cotangent
    assert np.all(grads[0].numpy()[..., 6:] == 0.0)
    dead = case["opacs"][:, 0, :] == 0
    assert np.all(grads[0].numpy()[dead] == 0.0) and np.all(grads[2].numpy()[:, 0][dead] == 0.0)
    # the 0.99 clamp is reached: some live slots get no d(opacity)
    assert np.any((grads[2].numpy() == 0.0) & (case["opacs"] > 0))


def test_function_is_the_plain_versions_on_cpu(case):
    coeffs, colors, opacs = (t.clone().requires_grad_(True) for t in port_inputs(case))
    g = torch.from_numpy(case["g"])
    before = (blend.launches, blend.bwd_launches)
    out = blend.blend_tiles_pallas(coeffs, colors, opacs)
    assert type(out.grad_fn).__name__ == "_BlendTilesCoeffsBackward"
    out.backward(g)
    assert (blend.launches, blend.bwd_launches) == before
    plain = blend.blend_tiles_coeffs_plain(coeffs.detach(), colors.detach(), opacs.detach())
    assert torch.equal(out.detach(), plain)
    ref = blend.blend_tiles_coeffs_bwd_plain(coeffs.detach(), colors.detach(), opacs.detach(), g)
    for t, r in zip((coeffs.grad, colors.grad, opacs.grad), ref):
        assert torch.equal(t, r)
    assert torch.equal(blend.blend_tiles_coeffs(coeffs.detach(), colors.detach(), opacs.detach()),
                       plain)


def test_wrappers_check_their_inputs():
    meta = torch.empty(2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        blend.blend_tiles_pallas(meta, torch.empty(2, 4, 3, device="meta"),
                                 torch.empty(2, 1, 4, device="meta"))
    with pytest.raises(ValueError, match="device"):
        blend.blend_tiles_coeffs_bwd(meta, torch.empty(2, 4, 3, device="meta"),
                                     torch.empty(2, 1, 4, device="meta"),
                                     torch.empty(2, 256, 4, device="meta"))
    co, col, op = torch.zeros(2, 4, 8), torch.zeros(2, 4, 11), torch.zeros(2, 1, 4)
    with pytest.raises(ValueError, match="C=11"):
        blend._check("k8", co, col, op)
    with pytest.raises(ValueError, match="expected coeffs"):
        blend._check("k8", torch.zeros(2, 4, 6), torch.zeros(2, 4, 3), op)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain(case, cuda_device):
    coeffs, colors, opacs = (t.to(cuda_device) for t in port_inputs(case))
    g = torch.from_numpy(case["g"]).to(cuda_device)
    out = blend.blend_tiles_coeffs(coeffs, colors, opacs)
    ref = blend.blend_tiles_coeffs_plain(coeffs, colors, opacs)
    grads = blend.blend_tiles_coeffs_bwd(coeffs, colors, opacs, g)
    grads_ref = blend.blend_tiles_coeffs_bwd_plain(coeffs, colors, opacs, g)
    torch.cuda.synchronize()
    image_close(out.cpu().numpy(), ref.cpu().numpy())
    for t, r in zip(grads, grads_ref):
        flip_close(t.cpu().numpy(), r.cpu().numpy())
