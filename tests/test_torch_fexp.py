"""The port's float32 exp (`d3ga_tpu_torch/ops/fexp.py`) against XLA-CPU's
`jnp.exp`, bit for bit: on every float32 of the binades [-8, -2] (the
powers where opacity * exp(power) meets 1/255 for opacities above 0.13;
about 17 M values), on a seeded sample over [-100, 100], and on zeros,
subnormals, the clamp's ends, infinities and NaN. The plain coefficient
blend (`raster/blend.py::_forward_chunk`) takes it where opacity *
exp(power) lies near 1/255 or 0.99: held there too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3ga_tpu_torch.ops.fexp import fexp
from d3ga_tpu_torch.raster import blend

CHUNK = 1 << 21
_jexp = jax.jit(jnp.exp)


def differing(x):
    """The number of float32 values x on which fexp and jnp.exp differ in
    any bit."""
    a = torch.cat([fexp(torch.from_numpy(x[i : i + CHUNK])) for i in range(0, len(x), CHUNK)])
    return int(np.count_nonzero(a.numpy().view(np.uint32) != np.asarray(_jexp(x)).view(np.uint32)))


def test_every_float_in_minus_8_to_minus_2():
    lo, hi = (int(np.float32(v).view(np.uint32)) for v in (-2.0, -8.0))
    assert differing(np.arange(lo, hi + 1, dtype=np.uint32).view(np.float32)) == 0


def test_sample_and_special_values():
    x = np.random.default_rng(3).uniform(-100, 100, 1 << 20).astype(np.float32)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38, 1.0, -1.0, 88.7, 88.8, 89.0,
                        -87.3, -87.8, -88.0, -104.0, np.inf, -np.inf, np.nan], np.float32)
    assert differing(x) == 0 and differing(special) == 0


def test_float32_only():
    with pytest.raises(TypeError, match="float32"):
        fexp(torch.zeros(3, dtype=torch.float64))


def test_forward_chunk_takes_it_near_the_thresholds():
    """Slots whose opacity puts opacity * exp(power) on 1/255 or 0.99 at
    some pixel: there the chunk's exp is fexp's, elsewhere torch.exp's."""
    rng = np.random.default_rng(8)
    T, K = 2, 64
    co = torch.from_numpy(rng.normal(scale=0.05, size=(T, K, 8)).astype(np.float32))
    co[..., 3:5] = -torch.from_numpy(rng.uniform(0.01, 0.2, (T, K, 2)).astype(np.float32))
    co[..., 6:] = 0.0
    basis = blend._pixel_basis("cpu")
    power = blend.split_power(basis, co[..., :6])
    # each slot's opacity puts one of its pixels exactly on a threshold
    p = torch.from_numpy(rng.integers(0, 256, (T, K)))
    e_at = torch.exp(torch.gather(power, 1, p[:, None, :]))[:, 0, :]
    target = torch.where(torch.arange(K) % 2 == 0, blend.ALPHA_SKIP, blend.ALPHA_MAX)
    op = (target / e_at).float()[:, None, :]
    f = blend._forward_chunk(co, op, basis, torch.triu(torch.ones((K, K))))
    raw = op * torch.exp(power)
    near = ((raw - blend.ALPHA_SKIP).abs() <= blend.EXP_NEAR * blend.ALPHA_SKIP) | (
        (raw - blend.ALPHA_MAX).abs() <= blend.EXP_NEAR * blend.ALPHA_MAX)
    assert int(near.sum()) >= T * K
    assert torch.equal(f["e"][near], fexp(power[near]))
    assert torch.equal(f["e"][~near], torch.exp(power)[~near])
