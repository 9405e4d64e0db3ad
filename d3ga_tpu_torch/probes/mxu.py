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

`roll(x, n, shifts, axis, design)` runs n trips of 8 steps of m = roll(x,
s, axis); x = where(m > x, m, x * 0.999999) (np.roll's direction) on [R,
L] float32, L a power of two (R too for a roll along rows). Each line
along the roll's axis is one thread block cluster of G CTAs, values in
registers, one barrier a step (`csrc/probes_mxu.cu`); `ROLL_DESIGNS`
names G ("cta" 1, "cluster2/4/8"), "baseline" the design before (one CTA
a row, or one for the whole array along rows; chip_smoke.py's
comparisons only) and "kernel" the design the card showed fastest
(`ROLL_KERNEL`). `roll_floor` runs a design's barriers alone, its sync
floor.

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

# the roll's designs: the CTAs a line's cluster holds (None: the design before)
ROLL_G = {"baseline": None, "cta": 1, "cluster2": 2, "cluster4": 4, "cluster8": 8}
ROLL_KERNEL = "cta"  # the design `roll` launches: the card's fastest (PERF.md, P1 roll)
ROLL_DESIGNS = (*ROLL_G, "kernel")
ROLL_PER = 4  # elements a thread holds in the new designs
ROLL_CAL_TRIPS = 64  # trips of the launch `roll_trips` sizes the timed ones from

# one per launch of a kernel (never for the plain versions)
launches = {"highest": 0, "default": 0, "high": 0, "roll": 0}
# one per launch of the designs before (chip_smoke.py's comparisons only)
v1_launches = {"highest": 0, "default": 0, "high": 0, "roll": 0}
# one per launch of a roll design named other than "kernel", and of the sync
# floors (chip_smoke.py's comparisons only)
roll_design_launches = {**{d: 0 for d in ROLL_G if d != "baseline"}, "floor": 0}
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
    rl1, occ = lib.probes_roll_v1, lib.probes_roll_occupancy
    mm.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
    v1.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    rl.argtypes = [p, p, i, i, i, i, p, i, i, p]
    rl1.argtypes = [p, p, i, i, i, i, p, p]
    occ.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
    for f in (mm, rl, v1, rl1, occ):
        f.restype = ctypes.c_int
    return {"matmul": mm, "roll": rl, "matmul_v1": v1, "roll_v1": rl1, "roll_occupancy": occ}


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
    err = _kernels()["matmul"](a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
                               int(contract_last), PRECISIONS[precision], int(p["trans"]),
                               p["bn"], n * UNROLL, copies, cuda_build.stream_handle(a.device))
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
    err = _kernels()["matmul_v1"](a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
                                  int(contract_last), PRECISIONS[precision], n * UNROLL, copies,
                                  cuda_build.stream_handle(a.device))
    if err != 0:
        raise RuntimeError(f"matmul_v1: kernel launch failed (error {err})")
    v1_launches[precision] += 1
    return out


def _log2(v, what):
    if v < 1 or v & (v - 1):
        raise ValueError(f"roll: {what} {v} is not a power of two")
    return v.bit_length() - 1


def roll_line(rows, lanes, axis):
    """(lines, elements a line) of the roll of [rows, lanes] along `axis`:
    the rows along lanes, the columns along rows."""
    return (rows, lanes) if axis == 1 else (lanes, rows)


def roll_threads(rows, lanes, axis, design):
    """Threads a CTA of a new design (ROLL_PER elements each, the line
    spread over G CTAs); raises for a line the design does not take."""
    g = ROLL_G[_design(design)]
    n = roll_line(rows, lanes, axis)[1]
    t = n // (g * ROLL_PER)
    if t < 32 or t > 1024 // g:
        raise ValueError(f"roll: design {design!r} takes lines of {128 * g} to 4096 elements, "
                         f"not {n}")
    return t


def _design(design):
    if design not in ROLL_DESIGNS:
        raise ValueError(f"roll: unknown design {design!r} (one of {ROLL_DESIGNS})")
    return ROLL_KERNEL if design == "kernel" else design


def _roll_args(x, n, shifts, axis, design, name):
    """Checks the operand; None on the CPU, else (x, out, log2 lanes, the
    8 shifts) for a launch."""
    if x.ndim != 2 or axis not in (0, 1) or len(shifts) < UNROLL:
        raise ValueError(f"{name}: x {tuple(x.shape)}, axis {axis}, {len(shifts)} shifts: "
                         f"expected [R, L], axis 0 or 1, {UNROLL} shifts")
    if not all(0 <= s < x.shape[axis] for s in shifts[:UNROLL]):
        raise ValueError(f"{name}: shifts {shifts} outside [0, {x.shape[axis]})")
    _design(design)
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be a float32 CUDA or CPU tensor, not {x.dtype} on "
                         f"{x.device}")
    if n < 1:
        raise ValueError(f"{name}: n={n} trips")
    if axis == 0:
        _log2(x.shape[0], "rows")
    ll = _log2(x.shape[1], "lanes")
    if ROLL_G[_design(design)] is not None:
        roll_threads(x.shape[0], x.shape[1], axis, design)
    x = x.contiguous()
    return x, torch.empty_like(x), ll, (ctypes.c_int * UNROLL)(*shifts[:UNROLL])


def _launch_roll(x, n, shifts, axis, design, floor):
    """One launch of a design (its sync floor with floor=True); raises
    with the CUDA error if it fails."""
    x, out, ll, sh = _roll_args(x, n, shifts, axis, design, "roll")
    d = _design(design)
    k = _kernels()
    stream = cuda_build.stream_handle(x.device)
    if ROLL_G[d] is None:
        err = k["roll_v1"](x.data_ptr(), out.data_ptr(), x.shape[0], ll, axis, n,
                           ctypes.addressof(sh), stream)
    else:
        err = k["roll"](x.data_ptr(), out.data_ptr(), x.shape[0], ll, axis, n,
                        ctypes.addressof(sh), ROLL_G[d], int(floor), stream)
    if err != 0:
        raise RuntimeError(f"roll: design {d!r} launch failed (CUDA error {err})")
    return out


def roll(x, n, shifts, axis, design="kernel"):
    """n trips of the roll + select chain on x [R, L] float32 in one launch
    of `design` (ROLL_DESIGNS). CPU tensors take `roll_plain` (the
    "kernel" design only: the others are chip_smoke.py's comparisons and
    run on CUDA tensors only); on the card a design that fails to launch
    raises, with no fallback."""
    if _roll_args(x, n, shifts, axis, design, "roll") is None:
        if design != "kernel":
            raise ValueError(f"roll: design {design!r} runs on CUDA tensors only")
        return roll_plain(x, n, shifts, axis)
    out = _launch_roll(x, n, shifts, axis, design, floor=False)
    if design == "kernel":
        launches["roll"] += 1
    elif design == "baseline":
        v1_launches["roll"] += 1
    else:
        roll_design_launches[design] += 1
    return out


def roll_floor(x, n, shifts, axis, design="kernel"):
    """A new design's sync floor: the same launch with the loads, selects
    and stores taken out, 8 n barriers alone (the output is x). CUDA
    tensors only."""
    if ROLL_G[_design(design)] is None:
        raise ValueError("roll_floor: the design before has no sync floor build")
    if _roll_args(x, n, shifts, axis, design, "roll_floor") is None:
        raise ValueError("roll_floor: a sync floor is a time on the card; CUDA tensors only")
    out = _launch_roll(x, n, shifts, axis, design, floor=True)
    roll_design_launches["floor"] += 1
    return out


def roll_occupancy(rows, lanes, axis, design):
    """The launch's occupancy on the current card, launching nothing:
    clusters resident at once for a cluster design
    (cudaOccupancyMaxActiveClusters), CTAs an SM for "cta"."""
    g = ROLL_G[_design(design)]
    if g is None:
        raise ValueError("roll_occupancy: the design before is not a cluster launch")
    roll_threads(rows, lanes, axis, design)
    out = ctypes.c_int(0)
    err = _kernels()["roll_occupancy"](rows, _log2(lanes, "lanes"), axis, g, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"roll_occupancy: design {design!r}: CUDA error {err}")
    return out.value


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


def roll_bound_ns(rows, lanes, sms=probes.SMS):
    """The least ns a step can take: three FP32-pipe instructions an
    element (multiply, compare, select) over `sms` SMs, all of the card's
    by default."""
    return 3 * rows * lanes / (probes.FP32_INSTR_PER_S_PER_SM * sms) * 1e9


def roll_bound_v1_ns(rows, lanes, axis):
    """The bound the table gave before: over the SMs the design before
    occupies (one CTA a row along lanes, one CTA along rows)."""
    return roll_bound_ns(rows, lanes, min(rows if axis == 1 else 1, probes.SMS))


def roll_input(rows, lanes, seed=0, device="cpu"):
    """tools/mxu_probe.py's roll operand: numpy normal as float32."""
    x = np.random.default_rng(seed).normal(size=(rows, lanes)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def roll_trips(launch, device, target_ms):
    """(n1, n2) trips for `probes.slope` of a roll launch(n): n2 so that
    a launch takes about target_ms, read off a launch of ROLL_CAL_TRIPS
    trips (one trip is mostly the launch's own overhead, which would
    cut n2 short and leave the slope to the timer's jitter)."""
    t = min(probes.time_ms(lambda: launch(ROLL_CAL_TRIPS), 1, device, warmup=1)
            for _ in range(probes.REPS))
    n2 = int(min(max(ROLL_CAL_TRIPS * target_ms / max(t, 1e-3), 8), 1 << 16))
    return max(1, n2 // 4), n2


def run_roll(device="cuda", cases=ROLL_CASES, target_ms=20.0, trips=None):
    """One row a case: ns a step (roll + select of the whole array) of
    the kernel's design, the card-wide bound and the one over the SMs the
    design before occupies, the CTAs the launch occupies."""
    device = torch.device(device)
    rows = []
    for name, R, L, axis, shifts in cases:
        x = roll_input(R, L, device=device)

        def launch(n):
            return roll(x, n, shifts, axis)

        s = probes.slope(launch, device, target_ms, trips or roll_trips(launch, device, target_ms))
        rows.append({"case": name, "rows": R, "lanes": L, "axis": axis, "shifts": list(shifts),
                     "design": ROLL_KERNEL, "ctas": roll_line(R, L, axis)[0] * ROLL_G[ROLL_KERNEL],
                     **s, "bound_ns": roll_bound_ns(R, L),
                     "bound_v1_ns": roll_bound_v1_ns(R, L, axis)})
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
