"""K8's plain backward (`raster/blend.py::blend_tiles_coeffs_bwd_plain`) on
its edge inputs, `chip_smoke.k8_edge_cases` (K9's edge inputs as
`fused._tile_inputs` makes K8's inputs of them, and whole-K tiles with
opacity-0 padding, at C 3 and 6), against the JAX package's
`pallas_blend.py::_run_backward` in interpret mode, for a cotangent made
from a seed.

Tolerance, as test_torch_blend_coeffs.py's for the backward: `flip_close`
on each cotangent (d(coeffs), d(colors), d(opacs); p999 error within 1e-5
of its largest |value|, at most 0.1% of the values off by more than 1e-3
of it): the JAX kernel sums in bf16 hi/lo split matmuls, the port in
float32, and the alpha >= 1/255 and T < 1e-4 tests flip where a pixel sits
on them. The tiles of K9_ON_THRESHOLD, whose alpha tests decide by
rounding, are held by the same metric: the plain power rounds as the JAX
kernel's split does (`blend_ct.split_power`) and its exp as XLA-CPU's
(`ops/fexp.py`). d(coeffs) is held on its 6 coefficient channels (the
plain version writes 0 in the padding). In K8_PADDING's dead slots the
random coefficients put exp(power) at +inf and opacity 0 makes it NaN in
both versions: the NaNs are held to the same places, the rest as above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from d3ga_tpu.raster import pallas_blend as jpb
from d3ga_tpu_torch.raster import blend
from test_torch_raster_bwd import flip_close
from torch_parity import jit_o0

CASES = {c[0]: c for c in chip_smoke.k8_edge_cases(torch.device("cpu"))}


def cotangent(name):
    """g [T, 256, C+1] for case `name`, from a seed of its C and position."""
    _, co, _, _, C = CASES[name]
    seed = 31 * C + list(CASES).index(name)
    return np.random.default_rng(seed).normal(size=(co.shape[0], 256, C + 1)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_bwd():
    """The JAX kernel's (d(coeffs), d(colors), d(opacs)) for every case:
    the cases of one C concatenated along the tiles, one interpret call
    each."""
    out = {}
    for C in (3, 6):
        names = [n for n in CASES if CASES[n][4] == C]
        args = [jnp.asarray(np.concatenate([CASES[n][i].numpy() for n in names]))
                for i in (1, 2, 3)]
        args.append(jnp.asarray(np.concatenate([cotangent(n) for n in names])))
        run = jit_o0(lambda co, col, op, g: jpb._run_backward(co, col, op, g, interpret=True),
                     *args)
        grads = [np.asarray(x) for x in run(*args)]
        t = 0
        for n in names:
            T = CASES[n][1].shape[0]
            out[n] = [x[t : t + T] for x in grads]
            t += T
    return out


def test_cases_hold_the_threshold_tiles():
    """Both Cs carry K9_ON_THRESHOLD's tiles and the padding case."""
    for C in (3, 6):
        assert f"{chip_smoke.K9_ON_THRESHOLD} at C={C}" in CASES
        assert f"{chip_smoke.K8_PADDING} at C={C}" in CASES


@pytest.mark.parametrize("name", list(CASES))
def test_k8_plain_bwd_matches_pallas_kernel(name, jax_bwd):
    _, co, col, op, C = CASES[name]
    grads = blend.blend_tiles_coeffs_bwd_plain(co, col, op, torch.from_numpy(cotangent(name)))
    for t, j, shape in zip(grads, jax_bwd[name], (co.shape, col.shape, op.shape)):
        assert t.shape == j.shape == shape
        t = t.numpy()
        if shape == co.shape:
            assert np.all(t[..., 6:] == 0.0)
            t, j = t[..., :6], j[..., :6]
        nan = np.isnan(j)
        assert np.array_equal(np.isnan(t), nan)
        assert nan.any() == name.startswith(chip_smoke.K8_PADDING) or shape == col.shape
        flip_close(np.where(nan, 0.0, t), np.where(nan, 0.0, j))
