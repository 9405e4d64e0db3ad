"""The pixel bias (`fields/pixel_bias.py`) and the background network
(`fields/background.py`: init, the resized map, the composite over the
rasterizer's transmittance) against the JAX package on the CPU, values
and `jax.grad`, at the capture width's ratio (83 x 128 maps up to 667 x
1024 at ds 8) and at a small 40 x 27 image.

Tolerances: values within 1e-6 abs; gradients of the maps within 1e-5
rel L2 (each low-resolution pixel sums the cotangent over the full-size
pixels it reaches, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3ga_tpu.fields import background as jbg
from d3ga_tpu.fields import pixel_bias as jpb
from d3ga_tpu_torch.fields import background as tbg
from d3ga_tpu_torch.fields import pixel_bias as tpb

ATOL, GRAD_REL = 1e-6, 1e-5
SIZES = {"small": (40, 27), "capture": (1024, 667)}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_inits_match_jax():
    for (h, w) in SIZES.values():
        assert np.array_equal(tpb.init_pixel_bias(3, h, w, device="cpu")["bias"].numpy(),
                              np.asarray(jpb.init_pixel_bias(3, h, w)["bias"]))
        assert np.array_equal(tbg.init_background_model(3, h, w, device="cpu")["bg"].numpy(),
                              np.asarray(jbg.init_background_model(3, h, w)["bg"]))


@pytest.mark.parametrize("size", list(SIZES))
def test_pixel_bias_matches_jax(size):
    h, w = SIZES[size]
    rng = np.random.default_rng(1)
    bias = rng.normal(0, 0.05, (2, 1, h // 8, w // 8)).astype(np.float32)
    g = rng.normal(size=(1, h, w)).astype(np.float32)
    jf = lambda b: jpb.apply_pixel_bias({"bias": b}, 1, h, w)  # noqa: E731
    want = np.asarray(jf(jnp.asarray(bias)))
    jg = np.asarray(jax.grad(lambda b: jnp.sum(jf(b) * g))(jnp.asarray(bias)))
    tb = torch.from_numpy(bias).requires_grad_(True)
    got = tpb.apply_pixel_bias({"bias": tb}, 1, h, w)
    assert got.shape == (1, h, w)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)
    (tg,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(g)), tb)
    assert rel_l2(tg, jg) <= GRAD_REL and np.all(tg.numpy()[0] == 0)


@pytest.mark.parametrize("size", list(SIZES))
def test_background_matches_jax(size):
    h, w = SIZES[size]
    rng = np.random.default_rng(2)
    bg = rng.uniform(size=(2, 3, h // 8, w // 8)).astype(np.float32)
    pred = rng.uniform(size=(3, h, w)).astype(np.float32)
    t_bg = rng.uniform(size=(h, w)).astype(np.float32)
    color = rng.uniform(size=3).astype(np.float32)
    g = rng.normal(size=(3, h, w)).astype(np.float32)

    def jf(b, p, t):
        m = jbg.apply_background({"bg": b}, 0, h, w)
        return jbg.composite_background(p, t, m, jnp.asarray(color))

    args = [jnp.asarray(v) for v in (bg, pred, t_bg)]
    want = np.asarray(jf(*args))
    jgrads = jax.grad(lambda *a: jnp.sum(jf(*a) * g), (0, 1, 2))(*args)
    targs = [torch.from_numpy(v).requires_grad_(True) for v in (bg, pred, t_bg)]
    bg_map = tbg.apply_background({"bg": targs[0]}, 0, h, w)
    np.testing.assert_allclose(bg_map.detach().numpy(),
                               np.asarray(jbg.apply_background({"bg": args[0]}, 0, h, w)),
                               rtol=0, atol=ATOL)
    got = tbg.composite_background(targs[1], targs[2], bg_map, torch.from_numpy(color))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=ATOL)
    tgrads = torch.autograd.grad(torch.sum(got * torch.from_numpy(g)), targs)
    for t, j in zip(tgrads, jgrads):
        assert rel_l2(t, j) <= GRAD_REL
