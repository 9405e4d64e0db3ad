"""A float32 natural log that rounds as XLA's CPU backend does.

XLA compiles `log` on the CPU into a Cephes-style approximation (the one
Eigen's `plog_float` uses): the mantissa reduced to [sqrt(1/2), sqrt(2)),
a degree-8 polynomial in m = mantissa - 1 evaluated as three interleaved
Horner chains, and e * ln 2 added in two parts. LLVM contracts its
multiply-adds into fused ones, so the last bit depends on which of them
are fused; `flog` fuses the ones XLA's code fuses and is bit-equal to
`jax.numpy.log` on the CPU on every float32 in [1e-12, 1]. It is about 1
ulp from a correctly rounded log (`torch.log`) on a few percent of the
inputs, which decides the alpha tests of records on the 1/255 threshold.
The CPU flushes subnormal inputs to zero there, so they give -inf.

The port's plain blend (`raster/blend_ct.py::_blend_chunk`) takes
log(opacity) from here so that it decides those tests as the JAX kernels
do in the CPU tests. The CUDA kernels keep their own `logf`.
"""

import torch

# float32 constants, as XLA's code rounds them
_P = torch.tensor([7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
                   1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
                   3.3333331174e-1], dtype=torch.float32)
_Q1 = torch.tensor(-2.12194440e-4, dtype=torch.float32)
_Q2 = torch.tensor(0.693359375, dtype=torch.float32)  # 355 / 512: e * _Q2 is exact
_SQRTHF = torch.tensor(0.707106781186547524, dtype=torch.float32)
_MIN_NORMAL = 1.1754943508222875e-38  # 2^-126
_NAN = torch.tensor(-1, dtype=torch.int32).view(torch.float32)  # XLA's NaN: all bits set


def fma32(a, b, c):
    """a * b + c for float32 tensors, rounded once to float32. The product
    of two float32 values is exact in float64, so only the float64 sum
    rounds; where it lands on a float32 rounding midpoint (rare), it is
    nudged off it by the sign of its own rounding error (TwoSum), so that
    rounding it to float32 rounds the exact value."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    if bool(mid.any()):
        bp = s - cd
        err = (p - bp) + (cd - (s - bp))
        away = torch.where(err > 0, float("inf"), float("-inf")).to(torch.float64)
        s = torch.where(mid & (err != 0), torch.nextafter(s, away), s)
    return s.float()


def flog(x):
    """Natural log of a float32 tensor, bit-equal to XLA-CPU's: -inf at 0
    and at subnormals of either sign, +inf at +inf, and below 0 and at
    NaN XLA's NaN (every bit set)."""
    if x.dtype != torch.float32:
        raise TypeError(f"flog: float32 only, got {x.dtype}")
    P, q1, q2 = _P.to(x.device), _Q1.to(x.device), _Q2.to(x.device)
    bits = torch.clamp(x, min=_MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    low = m < _SQRTHF.to(x.device)
    e = e - low.float()
    m = (m - 1.0) + torch.where(low, m, 0.0)  # in [sqrt(1/2) - 1, sqrt(2) - 1)
    x2 = m * m
    x3 = x2 * m
    y = fma32(fma32(m, P[0], P[1]), m, P[2])
    y1 = fma32(fma32(m, P[3], P[4]), m, P[5])
    y2 = fma32(fma32(m, P[6], P[7]), m, P[8])
    y = fma32(fma32(y, x3, y1), x3, y2)
    y = fma32(y, x3, e * q1)
    out = ((m - 0.5 * x2) + y) + e * q2  # 0.5 * x2 and e * _Q2 are exact
    out = torch.where(x.abs() < _MIN_NORMAL, float("-inf"), out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where((x < 0) & (x.abs() >= _MIN_NORMAL) | torch.isnan(x), _NAN.to(x.device), out)
