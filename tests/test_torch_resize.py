"""`ops/resize.py` against `jax.image.resize(..., method="bilinear")` on the
CPU, at the ratios the port meets: 83 -> 667 (a pixel bias or bg map at
ds 8 up to a 667-wide image), 667 -> 333 (the VGG term's x0.5 at a
non-integer ratio, where JAX's antialias widens the kernel) and 128 ->
1024, each with the other axis resized too, and its gradient.

Tolerances: values within 1e-6 abs; the weight matrices (read off
`jax.image.resize` of an identity) within 1 ulp of 1 (JAX sums and
divides them in an order of XLA's choosing). `F.interpolate`'s bilinear
mode is shown to be another function at 667 -> 333.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from d3ga_tpu_torch.ops.resize import resize_bilinear, resize_weights

ATOL = 1e-6
# (input [C, H, W], output (H', W'))
CASES = {
    "83->667": ((1, 83, 10), (667, 17)),
    "667->333": ((3, 667, 40), (333, 20)),
    "128->1024": ((1, 128, 83), (1024, 667)),
    "small": ((3, 5, 3), (40, 27)),
}


def jax_weights(m, n):
    """JAX's weight matrix [m, n], read off the resize of an identity."""
    eye = jnp.eye(m, dtype=jnp.float32)[None]
    return np.asarray(jax.image.resize(eye, (1, n, m), method="bilinear"))[0].T


@pytest.mark.parametrize("m,n", [(83, 667), (667, 333), (128, 1024), (40, 20), (27, 13)])
def test_weights_match_jax(m, n):
    np.testing.assert_allclose(resize_weights(m, n).numpy(), jax_weights(m, n), rtol=0,
                               atol=np.finfo(np.float32).eps)


@pytest.mark.parametrize("case", list(CASES))
def test_resize_matches_jax(case):
    shape, (oh, ow) = CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.uniform(size=shape).astype(np.float32)
    out = (shape[0], oh, ow)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x), out)
    assert got.shape == out
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_resize_gradient_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(3, 67, 40)).astype(np.float32)
    g = rng.normal(size=(3, 33, 20)).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(jax.image.resize(v, (3, 33, 20), method="bilinear") * g))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(torch.sum(resize_bilinear(tx, (3, 33, 20)) * torch.from_numpy(g)),
                                tx)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=ATOL)


def test_same_size_and_refusals():
    x = torch.rand(3, 8, 8)
    assert torch.equal(resize_bilinear(x, (3, 8, 8)), x)
    with pytest.raises(ValueError, match="C, H, W"):
        resize_bilinear(torch.rand(8, 8), (8, 8))
    with pytest.raises(ValueError, match="C, H, W"):
        resize_bilinear(x, (2, 8, 8))


def test_interpolate_is_another_function():
    """`F.interpolate(..., "bilinear")` takes two taps whatever the ratio;
    JAX's antialias at 667 -> 333 does not, so they differ by far more
    than rounding."""
    x = torch.from_numpy(np.random.default_rng(1).uniform(size=(3, 667, 40)).astype(np.float32))
    ours = resize_bilinear(x, (3, 333, 20))
    theirs = Fn.interpolate(x[None], size=(333, 20), mode="bilinear", align_corners=False)[0]
    assert float((ours - theirs).abs().max()) > 1e-2
