"""A float32 exp that rounds as XLA's CPU backend does.

XLA compiles `exp` on the CPU into Cephes' approximation: the input
clamped to [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped to
[-127, 127], r = x - n ln 2 with ln 2 in two parts, a degree-5 Horner
polynomial p(r), e^r = 1 + (p(r) r^2 + r), and 2^n built from its
exponent bits. LLVM fuses every multiply-add of it; `fexp` fuses the same
ones (`flog.fma32`) and flushes subnormal results to 0 as the CPU does.
It is bit-equal to `jax.numpy.exp` on the CPU on every float32 in
[-16, -2^-9], on a sample over [-100, 100] and on the special values, and
about 1 ulp from `torch.exp` on one input in ten, which decides the alpha
tests of slots on the 1/255 threshold.

The port's plain coefficient blend (`raster/blend.py::_forward_chunk`,
K8's and K9's plain versions) takes exp(power) from here where opacity *
exp(power) lies near 1/255 or 0.99 (it is far slower than torch.exp), so
that it decides those tests as the JAX kernels do in the CPU tests. The
CUDA kernels keep their own `expf`.
"""

import torch

from d3ga_tpu_torch.ops.flog import fma32

# float32 constants, as XLA's code rounds them
_LOG2E = 1.44269504088896341
_C1 = 0.693359375  # ln 2's high part: n * _C1 is exact
_C2 = -2.12194440e-4
_MIN_NORMAL = 1.1754943508222875e-38  # 2^-126
_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1,
      5.0000001201e-1)


def fexp(x):
    """exp of a float32 tensor, bit-equal to XLA-CPU's: 0 where the result
    would be subnormal (the CPU flushes them; below about -87.34), +inf
    from 88.8, NaN at NaN."""
    if x.dtype != torch.float32:
        raise TypeError(f"fexp: float32 only, got {x.dtype}")
    c = lambda v: torch.full_like(x, v)  # noqa: E731  (a float32 constant)
    xc = torch.clamp(x, -87.8, 88.8)
    n = torch.clamp(torch.floor(fma32(xc, c(_LOG2E), c(0.5))), -127.0, 127.0)
    r = fma32(-c(_C1), n, xc)
    r = fma32(-c(_C2), n, r)
    z = fma32(r, c(_P[0]), c(_P[1]))
    for p in _P[2:]:
        z = fma32(z, r, c(p))
    z = 1.0 + fma32(z, r * r, r)
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * two_n
    return torch.where(out < _MIN_NORMAL, 0.0, out)  # the CPU flushes subnormal results
