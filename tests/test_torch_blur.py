"""The learnable blur (`fields/blur.py`) and the noise target's blur
(`fields/background.py::blur_noise`) against the JAX package on the CPU:
values and `jax.grad`, on 3 x 40 x 27 images.

Tolerances: values within 1e-6 abs (the same float32 shifted sums, in
JAX's order; the noise blur's convolutions sum in another order); the
image's gradient within 1e-6 abs; the raw weights' gradient rel L2
2e-4 (each a float32 sum over the 3240 pixels of products with the
cotangent, partial sums up to ~30 whose ulps add up in another order:
~6e-5 abs on entries of ~0.5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3ga_tpu.fields import background as jbg
from d3ga_tpu.fields import blur as jblur
from d3ga_tpu_torch.fields import background as tbg
from d3ga_tpu_torch.fields import blur as tblur

SHAPE = (3, 40, 27)
ATOL, WEIGHT_GRAD_REL = 1e-6, 2e-4


def image(seed):
    return np.random.default_rng(seed).uniform(size=SHAPE).astype(np.float32)


def raw_weights(seed):
    return np.random.default_rng(seed).normal(size=(4, 3)).astype(np.float32)


@pytest.mark.parametrize("k", [3, 7])
def test_gauss_kernel_and_sep_blur(k):
    assert np.array_equal(tblur._gauss_kernel1d(k), jblur._gauss_kernel1d(k))
    x = image(k)
    np.testing.assert_allclose(tblur._sep_blur(torch.from_numpy(x), k).numpy(),
                               np.asarray(jblur._sep_blur(jnp.asarray(x), k)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("camera_idx", [0, 2])
def test_apply_learnable_blur_and_grad(camera_idx):
    x, raw = image(1), raw_weights(2)
    g = image(3)  # a cotangent

    def jf(raw, x):
        return jnp.sum(jblur.apply_learnable_blur({"weights_raw": raw}, x, camera_idx) * g)

    jv, jgrads = jax.value_and_grad(jf, (0, 1))(jnp.asarray(raw), jnp.asarray(x))
    tr = torch.from_numpy(raw).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tblur.apply_learnable_blur({"weights_raw": tr}, tx, camera_idx)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jblur.apply_learnable_blur({"weights_raw": jnp.asarray(raw)}, jnp.asarray(x),
                                              camera_idx)), rtol=0, atol=ATOL)
    tgrads = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)), (tr, tx))
    np.testing.assert_allclose(float(torch.sum(out * torch.from_numpy(g))), float(jv), rtol=1e-6)
    jw = np.asarray(jgrads[0], np.float64)
    assert np.linalg.norm(tgrads[0].numpy() - jw) <= WEIGHT_GRAD_REL * np.linalg.norm(jw)
    np.testing.assert_allclose(tgrads[1].numpy(), np.asarray(jgrads[1]), rtol=0, atol=ATOL)
    # only the camera's row of the weights gets a gradient
    assert np.all(np.delete(tgrads[0].numpy(), camera_idx, 0) == 0)


def test_blur_reg_and_init():
    raw = raw_weights(4)
    assert np.array_equal(tblur.blur_reg({"weights_raw": torch.from_numpy(raw)}, 3).numpy(),
                          np.asarray(jblur.blur_reg({"weights_raw": jnp.asarray(raw)}, 3)))
    assert np.array_equal(tblur.init_learnable_blur(5, device="cpu")["weights_raw"].numpy(),
                          np.asarray(jblur.init_learnable_blur(5)["weights_raw"]))


@pytest.mark.parametrize("seed", [0, 5])
def test_noise_blur_matches_blurred_noise(seed):
    """`blur_noise` of JAX's own uniform draw is JAX's `blurred_noise`."""
    key = jax.random.PRNGKey(seed)
    u = np.asarray(jax.random.uniform(key, SHAPE))
    np.testing.assert_allclose(tbg.blur_noise(torch.from_numpy(u.copy())).numpy(),
                               np.asarray(jbg.blurred_noise(key, SHAPE)), rtol=0, atol=ATOL)
