"""The port's float32 log (`d3ga_tpu_torch/ops/flog.py`) against XLA-CPU's
`jnp.log`, bit for bit: on every float32 of the binades [2^-9, 1] (about
75 M values, in chunks), on a seeded sample over [OP_EPS, 1], and on 0,
subnormals, 1, OP_EPS, infinities and NaN. Its exact fused multiply-add
(`fma32`) is held against exact rational arithmetic on sums that land on
a float32 rounding midpoint.

Run as a script (`PYTHONPATH=. python tests/test_torch_flog.py`) it checks every
float32 in [OP_EPS, 1] (about 335 M values, about half a minute on the CPU) and
prints the number that differ.
"""

import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3ga_tpu_torch.ops.flog import flog, fma32
from d3ga_tpu_torch.raster.blend_ct import OP_EPS

CHUNK = 1 << 22  # values a JAX call
SUB = 1 << 16  # values a flog call (its float64 temporaries stay in cache)
_jlog = jax.jit(jnp.log)


@pytest.fixture(autouse=True)
def one_thread():
    """flog's many small float64 ops on one intra-op thread: as fast alone,
    and the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_log(x):
    """flog over a float32 numpy array, SUB values at a time."""
    t = torch.from_numpy(x)
    return torch.cat([flog(t[i : i + SUB]) for i in range(0, len(t), SUB)]).numpy()


def differing(x):
    """The number of float32 values x on which flog and jnp.log differ in
    any bit."""
    a = port_log(x).view(np.uint32)
    b = np.asarray(_jlog(x)).view(np.uint32)
    return int(np.count_nonzero(a != b))


def differing_in_bits(lo, hi):
    """The number of float32 values with bit patterns in [lo, hi] on which
    flog and jnp.log differ."""
    n = 0
    for start in range(lo, hi + 1, CHUNK):
        bits = np.arange(start, min(start + CHUNK, hi + 1), dtype=np.uint32)
        n += differing(bits.view(np.float32))
    return n


def f32_bits(v):
    return int(np.array(v, np.float32).view(np.uint32))


def test_every_float32_in_the_binades_from_2e_minus_9_to_1():
    lo, hi = f32_bits(2.0**-9), f32_bits(1.0)
    assert hi - lo + 1 == 9 * 2**23 + 1
    assert differing_in_bits(lo, hi) == 0


def test_seeded_sample_over_op_eps_to_1():
    rng = np.random.default_rng(0)
    x = (10.0 ** rng.uniform(np.log10(OP_EPS), 0.0, 1 << 20)).astype(np.float32)
    x = np.concatenate([x, rng.uniform(1 / 255, 1.02 / 255, 1 << 18).astype(np.float32)])
    assert differing(x) == 0


def test_special_values():
    x = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, np.nextafter(np.float32(2**-126), 0),
                  2**-126, OP_EPS, np.nextafter(np.float32(OP_EPS), 1), 1.0,
                  np.nextafter(np.float32(1), 0), np.nextafter(np.float32(1), 2), 2.0, 3e38,
                  np.inf, -np.inf, -1.0, np.nan], np.float32)
    a, b = port_log(x), np.asarray(_jlog(x))
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert np.isneginf(a[:7]).all() and a[10] == 0.0 and np.isnan(a[-3:]).all()


def nearest_f32(exact):
    """The float32 nearest a Fraction, ties to the even bit pattern."""
    lo = np.float32(float(exact))
    cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
    errs = [abs(Fraction(float(v)) - exact) for v in cands]
    near = [v for v, e in zip(cands, errs) if e == min(errs)]
    return near[0] if len(near) == 1 else next(
        v for v in near if int(np.array(v).view(np.uint32)) % 2 == 0)


def test_fma32_rounds_once_on_midpoints():
    """a * b + c rounded to the float32 nearest the exact rational value
    (ties to even), where the sum lies on a float32 rounding midpoint or
    next to one: (1) c puts an exact float64 sum on a midpoint, plus a
    tail of -1, 0 or 1 times 2^-40; (2) a * b is itself a midpoint
    ((1 + i 2^-12)(1 + j 2^-12), i and j odd) and c = -2^-60, 0 or 2^-60
    is lost when the float64 sum rounds, so that only the nudge by its
    rounding error decides."""
    rng = np.random.default_rng(1)
    n = 2048
    a = rng.uniform(1, 2, n).astype(np.float32)
    b = rng.uniform(1, 2, n).astype(np.float32)
    p = a.astype(np.float64) * b.astype(np.float64)  # exact
    ulp = np.ldexp(1.0, np.frexp(p)[1] - 24)  # float32 ulp at p
    tail = np.ldexp(rng.choice([-1.0, 0.0, 1.0], n), -40)
    c = ((np.floor(p / ulp) + 0.5) * ulp - p + tail).astype(np.float32)
    i, j = (2 * rng.integers(0, 1 << 10, (2, n)) + 1)
    a2 = (1 + i * 2.0**-12).astype(np.float32)
    b2 = (1 + j * 2.0**-12).astype(np.float32)
    c2 = (rng.choice([-1.0, 0.0, 1.0], n) * 2.0**-60).astype(np.float32)
    a, b, c = (np.concatenate(v) for v in ((a, a2), (b, b2), (c, c2)))
    got = fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for ai, bi, ci, gi in zip(a, b, c, got):
        want = nearest_f32(Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci)))
        assert gi.view(np.uint32) == want.view(np.uint32), (ai, bi, ci, gi, want)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    lo, hi = f32_bits(OP_EPS), f32_bits(1.0)
    n = differing_in_bits(lo, hi)
    print(f"float32 in [OP_EPS, 1]: {hi - lo + 1} values, {n} differ from jnp.log")
    sys.exit(1 if n else 0)
