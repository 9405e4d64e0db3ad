"""P1: matmul and roll probes (counterpart of tools/mxu_probe.py).

`matmul(a, b, n, precision, contract_last)` runs n trips of UNROLL
data-dependent products in one launch: acc = aa @ b (b^T with
contract_last), then aa = aa + acc[0, 0] * 1e-30, from aa = a; it returns
the last acc, which is a @ b at that precision (1e-30 of the corner is
far below half an ulp of a). a [M, K] runs as one CTA, the TPU kernel's
one program on one core (a per-SM rate); a stacked [S, M, K] with b
[S, K, N] runs one CTA per copy (S = the SM count: the chip's rate).
Precisions map a TPU's onto the card: "highest" FP32 SIMT, "default" one
TF32 pass on the tensor cores (`wgmma`), "high" 3xTF32 (`csrc/probes_mxu.cu`;
`plan` picks the tile and whether the product runs transposed).
`matmul_v1` is the design before (`mma.sync`, 4x4 FP32 blocks), launched
only by chip_smoke.py's comparisons.

`roll(x, n, shifts, axis)` runs n trips of 8 steps of m = roll(x, s, axis);
x = where(m > x, m, x * 0.999999) (np.roll's direction) on [R, L] float32,
L a power of two (R too for a roll along rows).

Plain versions: `matmul_plain` repeats the chain with float32 products
(TF32 off), TF32 and 3xTF32 emulated by rounding the operands as
cvt.rna.tf32.f32 does (`tf32_round`: to nearest, ties away from zero, 10
mantissa bits); `roll_plain` with torch.roll and torch.where (bit-equal to
the kernel).

    python3 -m d3ga_tpu_torch.probes.mxu [--target-ms 200] [--device cuda]

prints one JSON line for the matmul cases (ns/op and real TFLOP/s on one
CTA and on one CTA per SM, the bound at the per-SM peak, cuBLAS's time for
one product and for the stacked product of the per-SM launch) and one for
the roll cases, each with the card's name and power limit.
"""

import argparse
import contextlib
import ctypes
import functools
import sys

import numpy as np
import torch

from d3ga_tpu_torch import probes
from d3ga_tpu_torch.probes import UNROLL
from d3ga_tpu_torch.utils import cuda_build

PRECISIONS = {"highest": 0, "default": 1, "high": 2}
CHAIN = 1e-30
ROLL_SCALE = 0.999999
# tools/mxu_probe.py:129-147: (name, M, K, N, precision, contract_last)
CASES = (
    ("banded oh@vals [128,128]@[128,16] HIGHEST", 128, 128, 16, "highest", False),
    ("banded oh@vals [128,128]@[128,16] DEFAULT", 128, 128, 16, "default", False),
    ("valsT@ohT [16,128]@[128,256] HIGHEST", 16, 128, 256, "highest", False),
    ("valsT@ohT [16,4096]@[4096,256] HIGHEST", 16, 4096, 256, "highest", False),
    ("valsT@ohT [16,4096]@[4096,256] HIGH", 16, 4096, 256, "high", False),
    ("power [256,8]@[8,256] HIGHEST", 256, 8, 256, "highest", False),
    ("power [256,8]@[8,256] DEFAULT", 256, 8, 256, "default", False),
    ("cum triK [256,256]@[256,256] DEFAULT", 256, 256, 256, "default", False),
    ("cum triK [256,256]@[256,256] HIGH", 256, 256, 256, "high", False),
    ("cum triK [256,256]@[256,256] HIGHEST", 256, 256, 256, "highest", False),
    ("rgb w@colT [256,256]x[3,256]c HIGHEST", 256, 256, 3, "highest", True),
    ("rgb w@colT [256,256]x[3,256]c DEFAULT", 256, 256, 3, "default", True),
    ("[512,512]@[512,512] DEFAULT", 512, 512, 512, "default", False),
    ("[512,512]@[512,512] HIGH", 512, 512, 512, "high", False),
    ("[512,512]@[512,512] HIGHEST", 512, 512, 512, "highest", False),
)
SMALL_SHIFTS = (1, 2, 4, 8, 16, 32, 64, 128)
BIG_SHIFTS = (256, 512, 1024, 2048, 3072, 3584, 3840, 3968)
# tools/mxu_probe.py:152-155: (name, rows, lanes, axis, shifts)
ROLL_CASES = (
    ("lane roll [19,4096]", 19, 4096, 1, SMALL_SHIFTS),
    ("lane roll [19,4096] big-shift", 19, 4096, 1, BIG_SHIFTS),
    ("lane roll [8,4096]", 8, 4096, 1, SMALL_SHIFTS),
    ("sublane roll [4096,8]", 4096, 8, 0, SMALL_SHIFTS),
)

# one per launch of a kernel (never for the plain versions)
launches = {"highest": 0, "default": 0, "high": 0, "roll": 0}
# one per launch of the matmul's design before (chip_smoke.py's comparisons only)
v1_launches = {"highest": 0, "default": 0, "high": 0}
# the new design's output tile: 128 rows (two warpgroups of 64) x BN columns
TILE_M = 128
TILE_NS = (8, 16, 128)  # BN; 8 only on the tensor cores (TF32, 3xTF32)


@contextlib.contextmanager
def _fp32_matmul(allow_tf32=False):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def tf32_round(x):
    """x float32 rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties
    away from zero, the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """(big, small), both TF32: big = tf32(x), small = tf32(x - big)."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


def product_plain(aa, b, precision="highest", contract_last=False):
    """One product aa @ b (b^T with contract_last) as the kernel's precision
    computes it, in float32 matmuls of the (rounded) operands."""
    bt = b.transpose(-1, -2) if contract_last else b
    with _fp32_matmul():
        if precision == "highest":
            return aa @ bt
        if precision == "default":
            return tf32_round(aa) @ tf32_round(bt)
        if precision == "high":
            ab, as_ = tf32_split(aa)
            bb, bs = tf32_split(bt)
            return (as_ @ bb + ab @ bs) + ab @ bb
    raise ValueError(f"unknown precision {precision!r} (one of {tuple(PRECISIONS)})")


def matmul_plain(a, b, n, precision="highest", contract_last=False):
    """Plain version of `matmul`: the chain of n * UNROLL products."""
    aa, acc = a, None
    for _ in range(n * UNROLL):
        acc = product_plain(aa, b, precision, contract_last)
        aa = aa + acc[..., :1, :1] * CHAIN
    return acc


def roll_plain(x, n, shifts, axis):
    """Plain version of `roll`."""
    for _ in range(n):
        for s in shifts[:UNROLL]:
            m = torch.roll(x, s, axis)
            x = torch.where(m > x, m, x * ROLL_SCALE)
    return x


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = cuda_build.load("probes_mxu")
    p, i = ctypes.c_void_p, ctypes.c_int
    mm, rl, v1 = lib.probes_matmul, lib.probes_roll, lib.probes_matmul_v1
    mm.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
    v1.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    rl.argtypes = [p, p, i, i, i, i, p, p]
    mm.restype = rl.restype = v1.restype = ctypes.c_int
    return mm, rl, v1


def _shapes(a, b, contract_last):
    """(copies, M, K, N) of a [.., M, K] and b [.., K, N] (or [.., N, K])."""
    if a.ndim not in (2, 3) or b.ndim != a.ndim or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"matmul: a {tuple(a.shape)} and b {tuple(b.shape)}: expected "
                         "[M, K] and [K, N], or both stacked [S, ...]")
    M, K = a.shape[-2:]
    N, Kb = (b.shape[-2], b.shape[-1]) if contract_last else (b.shape[-1], b.shape[-2])
    if Kb != K:
        raise ValueError(f"matmul: contraction sizes differ ({K} and {Kb})")
    return (a.shape[0] if a.ndim == 3 else 1), M, K, N


def plan(M, K, N, precision):
    """The new design's launch plan for a product [M, K] @ [K, N]: {"trans":
    whether it runs as out^T = b^T a^T (M <= 16 < N: the 64-row tiles fill
    with N's rows), "rows"/"cols": the product's sides as the kernel takes
    them, "bn": the tile's columns (the smallest of TILE_NS that holds
    them; 16 at least for FP32), "tiles": the output tiles a product,
    "k_tiles": k-tiles of 32 a tile}."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (one of {tuple(PRECISIONS)})")
    if K % 4:
        raise ValueError(f"matmul: K {K} is not a multiple of 4 (the kernel reads 4 k at once)")
    trans = M <= 16 < N
    rows, cols = (N, M) if trans else (M, N)
    sizes = TILE_NS if precision != "highest" else TILE_NS[1:]
    bn = next((t for t in sizes if cols <= t), sizes[-1])
    return {"trans": trans, "rows": rows, "cols": cols, "bn": bn,
            "tiles": -(-rows // TILE_M) * -(-cols // bn), "k_tiles": -(-K // 32)}


def _launch(a, b, n, precision, contract_last, name):
    """Checks the operands; None on the CPU, else (a, b, out, copies, M,
    K, N) for a launch."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (one of {tuple(PRECISIONS)})")
    copies, M, K, N = _shapes(a, b, contract_last)
    if a.device.type == "cpu":
        return None
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{name}: operands must be float32")
    if n < 1:
        raise ValueError(f"{name}: n={n} trips")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(a.shape[:-2] + (M, N), dtype=torch.float32, device=a.device)
    return a, b, out, copies, M, K, N


def matmul(a, b, n, precision="highest", contract_last=False):
    """n trips of the chain (module docstring) in one launch; returns the
    last product [.., M, N]. CPU tensors take `matmul_plain`."""
    run = _launch(a, b, n, precision, contract_last, "matmul")
    if run is None:
        plan(a.shape[-2], a.shape[-1], b.shape[-2] if contract_last else b.shape[-1], precision)
        return matmul_plain(a, b, n, precision, contract_last)
    a, b, out, copies, M, K, N = run
    p = plan(M, K, N, precision)
    err = _kernels()[0](a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N, int(contract_last),
                        PRECISIONS[precision], int(p["trans"]), p["bn"], n * UNROLL, copies,
                        cuda_build.stream_handle(a.device))
    if err != 0:
        raise RuntimeError(f"matmul: kernel launch failed (error {err})")
    launches[precision] += 1
    return out


def matmul_v1(a, b, n, precision="highest", contract_last=False):
    """`matmul` on the design before (`probes_matmul_v1`: mma.sync, 4x4 FP32
    blocks, operands resident in shared memory where they fit). CUDA
    tensors only: chip_smoke.py holds and times the design against it."""
    run = _launch(a, b, n, precision, contract_last, "matmul_v1")
    if run is None:
        raise ValueError("matmul_v1: the design before runs on CUDA tensors only")
    a, b, out, copies, M, K, N = run
    err = _kernels()[2](a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N, int(contract_last),
                        PRECISIONS[precision], n * UNROLL, copies,
                        cuda_build.stream_handle(a.device))
    if err != 0:
        raise RuntimeError(f"matmul_v1: kernel launch failed (error {err})")
    v1_launches[precision] += 1
    return out


def _log2(v, what):
    if v < 1 or v & (v - 1):
        raise ValueError(f"roll: {what} {v} is not a power of two")
    return v.bit_length() - 1


def roll(x, n, shifts, axis):
    """n trips of the roll + select chain on x [R, L] float32 in one launch.
    CPU tensors take `roll_plain`."""
    if x.ndim != 2 or axis not in (0, 1) or len(shifts) < UNROLL:
        raise ValueError(f"roll: x {tuple(x.shape)}, axis {axis}, {len(shifts)} shifts: "
                         f"expected [R, L], axis 0 or 1, {UNROLL} shifts")
    if not all(0 <= s < x.shape[axis] for s in shifts[:UNROLL]):
        raise ValueError(f"roll: shifts {shifts} outside [0, {x.shape[axis]})")
    if x.device.type == "cpu":
        return roll_plain(x, n, shifts, axis)
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"roll: x must be a float32 CUDA or CPU tensor, not {x.dtype} on {x.device}")
    if axis == 0:
        _log2(x.shape[0], "rows")
    ll = _log2(x.shape[1], "lanes")
    x = x.contiguous()
    out = torch.empty_like(x)
    sh = (ctypes.c_int * UNROLL)(*shifts[:UNROLL])
    err = _kernels()[1](x.data_ptr(), out.data_ptr(), x.shape[0], ll, axis, n,
                        ctypes.addressof(sh), cuda_build.stream_handle(x.device))
    if err != 0:
        raise RuntimeError(f"roll: kernel launch failed (error {err}; a CTA holds a row along "
                           "lanes, the whole array along rows: 512 to 32768 floats)")
    launches["roll"] += 1
    return out


def operands(M, K, N, contract_last=False, seed=0, device="cpu"):
    """tools/mxu_probe.py's operands: numpy normal * 0.01 as float32, a
    [M, K] from seed, b [K, N] (or [N, K]) from seed + 1."""
    a = np.random.default_rng(seed).normal(size=(M, K)) * 0.01
    b = np.random.default_rng(seed + 1).normal(size=(N, K) if contract_last else (K, N)) * 0.01
    return tuple(torch.from_numpy(v.astype(np.float32)).to(device) for v in (a, b))


def matmul_bound_ns(M, K, N, precision, sms=1):
    """The least ns one product can take on `sms` SMs: 2 M K N operations
    (three TF32 passes for "high") at the type's peak share of those SMs."""
    rate = probes.FP32_OPS_PER_S if precision == "highest" else probes.TF32_OPS_PER_S
    passes = 3 if precision == "high" else 1
    return passes * 2 * M * K * N / (rate * sms / probes.SMS) * 1e9



def run_matmul(device="cuda", cases=CASES, target_ms=20.0, trips=None):
    """One row a case: ns/op and real TFLOP/s on one CTA and on one CTA per
    SM with replicated operands, the one-CTA bound, the new design's plan,
    and cuBLAS's ms for one product (torch.matmul at the case's TF32
    setting) and for the per-SM launch's stacked product (torch.bmm of the
    [SMs, M, K] operands: the like-for-like yardstick of its rate)."""
    device = torch.device(device)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else 1)
    rows = []
    for name, M, K, N, prec, cl in cases:
        a, b = operands(M, K, N, cl, device=device)
        flops = 2 * M * K * N
        one = probes.slope(lambda n: matmul(a, b, n, prec, cl), device, target_ms, trips)
        row = {"case": name, "M": M, "K": K, "N": N, "precision": prec, "contract_last": cl,
               "plan": plan(M, K, N, prec),
               "one_cta": dict(one, tflops=flops / one["ns_per_op"] / 1e3),
               "bound_ns": matmul_bound_ns(M, K, N, prec)}
        ar, br = a.expand(sms, -1, -1).contiguous(), b.expand(sms, -1, -1).contiguous()
        many = probes.slope(lambda n: matmul(ar, br, n, prec, cl), device, target_ms, trips)
        row["per_sm"] = dict(many, ctas=sms, tflops=sms * flops / many["ns_per_op"] / 1e3)
        bt, brt = (b.t(), br.transpose(1, 2)) if cl else (b, br)
        with _fp32_matmul(allow_tf32=prec == "default"):
            row["library_ms"] = probes.time_ms(lambda: torch.matmul(a, bt), 20, device)
            row["library_per_sm_ms"] = probes.time_ms(lambda: torch.bmm(ar, brt), 20, device)
        row["library"] = "torch.matmul / torch.bmm, TF32 " + ("on" if prec == "default" else "off")
        del ar, br, brt
        rows.append(row)
    return rows


def roll_bound_ns(rows, lanes, axis):
    """Three FP32-pipe instructions an element a step over the SMs the
    launch occupies (one CTA a row along lanes, one CTA along rows)."""
    ctas = rows if axis == 1 else 1
    return 3 * rows * lanes / (probes.FP32_INSTR_PER_S_PER_SM * min(ctas, probes.SMS)) * 1e9


def roll_input(rows, lanes, seed=0, device="cpu"):
    """tools/mxu_probe.py's roll operand: numpy normal as float32."""
    x = np.random.default_rng(seed).normal(size=(rows, lanes)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def run_roll(device="cuda", cases=ROLL_CASES, target_ms=20.0, trips=None):
    """One row a case: ns a step (roll + select of the whole array), its
    bound, the CTAs the launch occupies."""
    device = torch.device(device)
    rows = []
    for name, R, L, axis, shifts in cases:
        x = roll_input(R, L, device=device)
        s = probes.slope(lambda n: roll(x, n, shifts, axis), device, target_ms, trips)
        rows.append({"case": name, "rows": R, "lanes": L, "axis": axis, "shifts": list(shifts),
                     "ctas": R if axis == 1 else 1, **s,
                     "bound_ns": roll_bound_ns(R, L, axis)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target-ms", type=float, default=200.0,
                    help="the longer timed launch of each case takes about this long")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = probes.cli_device(args.device)
    probes.emit("mxu_matmul", device, run_matmul(device, target_ms=args.target_ms))
    probes.emit("mxu_roll", device, run_roll(device, target_ms=args.target_ms))
    return 0


if __name__ == "__main__":
    sys.exit(main())
