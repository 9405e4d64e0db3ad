"""K8: the per-tile alpha blend over precomputed quadratic-falloff
coefficients, forward and backward (counterpart of
d3ga_tpu/raster/pallas_blend.py).

K8 replaces the TPU kernels `pallas_blend.py::_run_forward` and
`::_run_backward` (`_forward_body`, `_backward_body`) behind
`blend_tiles_pallas` with the hand-written CUDA kernels of
`csrc/blend_coeffs.cu` (its header gives the bound and the design). The
forward walks with `csrc/coeff_walk_fwd.cuh`, as K9's forward does: two
pixels a thread, a band cull from the coefficients, batches of 8 listed
slots, the tile's block written as 16-byte stores, its image its design
before's to the bit. That design (one thread a pixel, `coeff_walk.cuh`'s
walk) stays as `d3ga_blend_coeffs_v1`, reached only by
`blend_tiles_coeffs_baseline`; `blend_tiles_coeffs_stage` launches one of
the `FWD_DESIGNS` (the kernel with the cull off among them) or, at C =
STAGE_C only, a cut at one of the `FWD_STAGES`, with their own counters
(chip_smoke.py's comparisons only). The backward walks with
`csrc/coeff_walk_bwd.cuh`, as K9's backward does (two pixels a thread,
the forward's band cull and power, per-slot sums by a warp
reduce-scatter), and writes its three outputs as 16-byte stores; its
design before stays as `d3ga_blend_coeffs_bwd_v1`
(`blend_tiles_coeffs_bwd_baseline`), and `blend_tiles_coeffs_bwd_stage`
launches one of the `BWD_DESIGNS` or, at C = STAGE_C only, a cut at one
of the `BWD_STAGES`, with their own counters. Its inputs are
per-tile gathered slots: coeffs [T, K, 8] from `falloff_coeffs` (six
used, two padding), colors [T, K, C], opacs [T, 1, K] (0 for dead
slots); it returns [T, 256, C+1], pixel p = dy * 16 + dx, T_bg last (the
caller composites the background). Its callers are the stage benches
(`tools/bench_stages.py`, `tools/profile_raster_stages.py`; the port's
`bench_stages.py`).

The plain versions are the JAX kernel's formula in float32: the falloff
as a [256, 6] x [6, K] product over the quadratic pixel basis (the
coefficients split into their bfloat16 part and the rest, as the JAX
kernel splits them, so that the alpha tests decide as there), alpha =
min(0.99, opacity * exp(power)) where power <= 0 and alpha >= 1/255, the
log1p(-alpha) prefix sums as a product with the triangular ones matrix,
and the T_after >= 1e-4 accept. The JAX kernel's bf16 hi/lo split
matmuls are a TPU precision workaround, not semantics (ROADMAP queue 2):
the kernels compute in float32, TF32 off; the plain power alone follows
the split, whose sums of exact products round apart from a float32 FMA
chain only in the last bits.

`blend_tiles_pallas` is one `torch.autograd.Function` for both devices:
the kernels on CUDA tensors, the plain versions on CPU tensors (or with
plain=True); its gradients are d(coeffs, colors, opacs) as the JAX
custom VJP defines them. There is no fallback between the two.
"""

import ctypes
import functools

import torch

from d3ga_tpu_torch.ops.fexp import fexp
from d3ga_tpu_torch.raster.blend_ct import split_power
from d3ga_tpu_torch.train.losses import full_float32
from d3ga_tpu_torch.utils import cuda_build

TILE = 16
NPIX = TILE * TILE
ALPHA_SKIP = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
MAX_C = 10  # colour channels the kernels are instantiated for

# one per launch of the CUDA kernel (never for the plain versions)
launches = 0
bwd_launches = 0
# the forward's stage cuts (csrc/coeff_walk_fwd.cuh); stage 2 is the kernel
FWD_STAGES = ("staging + stores", "lists + polynomials + exps", "transmittance chain")
# the designs the forward's stage entry point launches: the kernel, the
# kernel with the band cull off, and its walk at 1, 2 or 4 slots a batch
# (it takes FWD_BATCH); the cuts before stage 2 and the batch variants are
# built for C = STAGE_C only
FWD_DESIGNS = {"kernel": 1, "kernel_no_cull": 2, "kernel_r1": 3, "kernel_r2": 4, "kernel_r4": 5}
FWD_BATCH = 8
STAGE_C = 6
# one per launch of the forward's baseline design and of each (design,
# stage) cut (chip_smoke.py's comparisons only)
baseline_launches = 0
stage_launches = {(d, s): 0 for d in FWD_DESIGNS for s in range(len(FWD_STAGES))}
# the backward's stage cuts (csrc/coeff_walk_bwd.cuh); stage 4 is the kernel
BWD_STAGES = ("staging", "walk 1", "walk 2 per pixel", "per-slot sums", "stores")
# the designs the backward's stage entry point launches: the kernel and the
# kernel with the band cull off; the cuts before stage 4 are built for
# C = STAGE_C only
BWD_DESIGNS = {"kernel": 1, "kernel_no_cull": 2}
# one per launch of the backward's baseline design and of each (design,
# stage) cut (chip_smoke.py's comparisons only)
bwd_baseline_launches = 0
bwd_stage_launches = {(d, s): 0 for d in BWD_DESIGNS for s in range(len(BWD_STAGES))}


def falloff_coeffs(xy_local, conic):
    """Per-record quadratic coefficients in tile-local pixel coordinates.
    xy_local: [..., 2] Gaussian centre minus tile origin; conic [..., 3].
    Returns [..., 8] (6 coefficients + 2 zero padding)."""
    A, B, C = conic.unbind(-1)
    x, y = xy_local.unbind(-1)
    z = torch.zeros_like(A)
    return torch.stack(
        [-0.5 * (A * x * x + C * y * y) - B * x * y, A * x + B * y, C * y + B * x,
         -0.5 * A, -0.5 * C, -B, z, z],
        -1,
    )


def _pixel_basis(device):
    """[256, 6] (1, dx, dy, dx^2, dy^2, dx dy) at the tile-local integer
    pixel offsets, pixel p = dy * 16 + dx."""
    p = torch.arange(NPIX, device=device)
    dx = (p % TILE).float()
    dy = (p // TILE).float()
    return torch.stack([torch.ones_like(dx), dx, dy, dx * dx, dy * dy, dx * dy], -1)


# the relative distance from a threshold within which the plain forward
# takes XLA-CPU's exp (some 60 float32 ulps; the two exps differ by one)
EXP_NEAR = 4e-6


def _forward_chunk(coeffs, opacs, basis, U, split=True):
    """`_forward_body`'s intermediates for a chunk of tiles: coeffs
    [B, K, 8], opacs [B, 1, K]. The power is rounded as the JAX kernel's
    bf16 hi/lo split rounds it (`blend_ct.split_power`; split=False: as
    one float32 product, K9's JAX kernels' `dot_general`), and where
    opacity * exp(power) lies within EXP_NEAR of 1/255 or 0.99 its exp as
    XLA-CPU's (`ops/fexp.py`, far slower than torch.exp, which is within
    an ulp of it), so that a slot on those thresholds is decided as there."""
    if split:
        power = split_power(basis, coeffs[..., :6])  # [B, 256, K]
    else:
        power = torch.einsum("pc,bkc->bpk", basis, coeffs[..., :6])
    e = torch.exp(power)
    raw = opacs * e
    near = ((raw - ALPHA_SKIP).abs() <= EXP_NEAR * ALPHA_SKIP) | ((raw - ALPHA_MAX).abs()
                                                                  <= EXP_NEAR * ALPHA_MAX)
    if bool(near.any()):
        e[near] = fexp(power[near])
        raw = opacs * e
    alpha = torch.minimum(raw, torch.tensor(ALPHA_MAX, device=raw.device))
    use = (power <= 0.0) & (alpha >= ALPHA_SKIP)
    alpha = torch.where(use, alpha, 0.0)
    lg = torch.log1p(-alpha)
    K = lg.shape[-1]
    cum = (lg.reshape(-1, K) @ U).reshape(lg.shape)  # inclusive log-transmittance
    t_before = torch.exp(cum - lg)  # one exp: t_after = t_before * (1 - alpha)
    accept = t_before * (1.0 - alpha) >= T_EPS
    w = torch.where(accept, alpha * t_before, 0.0)
    t_bg = torch.exp(torch.sum(torch.where(accept, lg, 0.0), -1, keepdim=True))  # [B, 256, 1]
    return dict(e=e, raw=raw, alpha=alpha, use=use, t_before=t_before, accept=accept, w=w,
                t_bg=t_bg)


def blend_tiles_coeffs_plain(coeffs, colors, opacs, tile_chunk=256, count_pairs=False):
    """Plain PyTorch version of K8's forward: [T, 256, C+1], T_bg last.
    Tiles go `tile_chunk` at a time. count_pairs=True also returns the
    (pixel, live slot) pairs a front-to-back walk visits (the kernel's
    work on this data; a slot of opacity 0 is inert)."""
    T, K, _ = coeffs.shape
    dev = coeffs.device
    basis = _pixel_basis(dev)
    U = torch.triu(torch.ones((K, K), device=dev))
    out, pairs = [], 0
    with full_float32():
        for c0 in range(0, T, tile_chunk):
            sl = slice(c0, c0 + tile_chunk)
            f = _forward_chunk(coeffs[sl], opacs[sl], basis, U)
            rgb = torch.einsum("bpk,bkc->bpc", f["w"], colors[sl])
            out.append(torch.cat([rgb, f["t_bg"]], -1))
            if count_pairs:
                pairs += int(((opacs[sl] > 0) & (f["t_before"] >= T_EPS)).sum())
    out = torch.cat(out, 0) if out else coeffs.new_zeros((0, NPIX, colors.shape[-1] + 1))
    return (out, pairs) if count_pairs else out


def blend_tiles_coeffs_bwd_plain(coeffs, colors, opacs, g, tile_chunk=256, split=True):
    """Plain PyTorch version of K8's backward, `_backward_body` written out
    in float32: the cotangent g [T, 256, C+1] of the forward's output to
    (dcoeffs [T, K, 8] with the padding's 0, dcolors [T, K, C], dopacs
    [T, 1, K]). `split`: the power's rounding (`_forward_chunk`; K9's plain
    backward takes split=False, as its JAX kernel)."""
    T, K, _ = coeffs.shape
    C = colors.shape[-1]
    dev = coeffs.device
    basis = _pixel_basis(dev)
    U = torch.triu(torch.ones((K, K), device=dev))
    dco, dcol, dop = [], [], []
    with full_float32():
        for c0 in range(0, T, tile_chunk):
            sl = slice(c0, c0 + tile_chunk)
            f = _forward_chunk(coeffs[sl], opacs[sl], basis, U, split)
            g_rgb, g_tbg = g[sl, :, :C], g[sl, :, C:]
            w, accept, alpha = f["w"], f["accept"], f["alpha"]
            dw = torch.einsum("bpc,bkc->bpk", g_rgb, colors[sl])
            dcol.append(torch.einsum("bpk,bpc->bkc", w, g_rgb))
            ds = dw * w
            dalpha = torch.where(accept, dw * f["t_before"], 0.0)
            dsum = g_tbg * f["t_bg"]  # [B, 256, 1]
            # ds @ U^T: the sum over the slot and those behind it
            dlg = (ds.reshape(-1, K) @ U.T).reshape(ds.shape) - ds + torch.where(accept, dsum, 0.0)
            dalpha = dalpha + dlg * (-1.0 / (1.0 - alpha))
            live = f["use"] & (f["raw"] < ALPHA_MAX)
            dalpha = torch.where(live, dalpha, 0.0)
            dop.append(torch.sum(dalpha * f["e"], 1, keepdim=True))  # [B, 1, K]
            d6 = torch.einsum("bpk,pc->bkc", dalpha * f["raw"], basis)  # [B, K, 6]
            dco.append(torch.nn.functional.pad(d6, (0, 2)))
    if T == 0:
        return torch.zeros_like(coeffs), torch.zeros_like(colors), torch.zeros_like(opacs)
    return torch.cat(dco, 0), torch.cat(dcol, 0), torch.cat(dop, 0)


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = cuda_build.load("blend_coeffs")
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd = [p, p, p, i, i, i, p]
    bwd = [p, p, p, p, i, i, i, p, p, p]
    for name, args in (("d3ga_blend_coeffs", fwd + [p]), ("d3ga_blend_coeffs_v1", fwd + [p]),
                       ("d3ga_blend_coeffs_stage", fwd + [i, i, p]),
                       ("d3ga_blend_coeffs_bwd", bwd + [p]), ("d3ga_blend_coeffs_bwd_v1", bwd + [p]),
                       ("d3ga_blend_coeffs_bwd_stage", bwd + [i, i, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check(name, coeffs, colors, opacs):
    for t in (coeffs, colors, opacs):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: inputs must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.device != coeffs.device:
            raise ValueError(f"{name}: inputs on different devices")
    T, K = coeffs.shape[:2]
    C = colors.shape[-1]
    if (tuple(coeffs.shape) != (T, K, 8) or tuple(colors.shape) != (T, K, C)
            or tuple(opacs.shape) != (T, 1, K)):
        raise ValueError(f"{name}: expected coeffs [T, K, 8], colors [T, K, C], opacs [T, 1, K]; "
                         f"got {tuple(coeffs.shape)}, {tuple(colors.shape)}, {tuple(opacs.shape)}")
    if not 1 <= C <= MAX_C:
        raise ValueError(f"{name}: C={C} unsupported (1..{MAX_C})")
    return T, K, C


def _launch_fwd(coeffs, colors, opacs, name, entry, extra=()):
    """Checks, allocates the output and launches the forward entry point
    `entry` of csrc/blend_coeffs.cu (with `extra` int arguments): (out,
    1 if it launched the kernel else 0), the caller adding the latter to
    its count."""
    T, K, C = _check(name, coeffs, colors, opacs)
    out = torch.empty((T, NPIX, C + 1), dtype=torch.float32, device=coeffs.device)
    if T == 0:
        return out, 0
    err = getattr(_kernels(), entry)(coeffs.data_ptr(), colors.data_ptr(), opacs.data_ptr(), T,
                                     K, C, out.data_ptr(), *extra,
                                     cuda_build.stream_handle(coeffs.device))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
    return out, 1


def _launch(coeffs, colors, opacs):
    global launches
    out, n = _launch_fwd(coeffs, colors, opacs, "blend_tiles_pallas", "d3ga_blend_coeffs")
    launches += n
    return out


def _launch_bwd_entry(coeffs, colors, opacs, g, name, entry, extra=(), zero=False):
    """Checks, allocates the three cotangents (zeroed with `zero`) and
    launches the backward entry point `entry` of csrc/blend_coeffs.cu
    (with `extra` int arguments): (grads, 1 if it launched the kernel
    else 0), the caller adding the latter to its count."""
    T, K, C = _check(name, coeffs, colors, opacs)
    if g.dtype != torch.float32 or tuple(g.shape) != (T, NPIX, C + 1) or not g.is_contiguous():
        raise ValueError(f"{name}: cotangent {g.dtype} {tuple(g.shape)}")
    if g.device != coeffs.device:
        raise ValueError(f"{name}: cotangent on another device")
    dco, dcol, dop = ((torch.zeros_like if zero else torch.empty_like)(t)
                      for t in (coeffs, colors, opacs))
    if T == 0 or K == 0:
        return (dco, dcol, dop), 0
    err = getattr(_kernels(), entry)(
        coeffs.data_ptr(), colors.data_ptr(), opacs.data_ptr(), g.data_ptr(), T, K, C,
        dco.data_ptr(), dcol.data_ptr(), dop.data_ptr(), *extra,
        cuda_build.stream_handle(coeffs.device))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
    return (dco, dcol, dop), 1


def _launch_bwd(coeffs, colors, opacs, g):
    global bwd_launches
    grads, n = _launch_bwd_entry(coeffs, colors, opacs, g, "blend_tiles_pallas_bwd",
                                 "d3ga_blend_coeffs_bwd")
    bwd_launches += n
    return grads


def blend_tiles_coeffs(coeffs, colors, opacs):
    """K8's forward without autograd: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if coeffs.device.type == "cpu":
        return blend_tiles_coeffs_plain(coeffs, colors, opacs)
    if coeffs.device.type != "cuda":
        raise ValueError(f"blend_tiles_coeffs: unsupported device {coeffs.device}")
    return _launch(coeffs, colors, opacs)


def blend_tiles_coeffs_bwd(coeffs, colors, opacs, g):
    """K8's backward: (dcoeffs, dcolors, dopacs); the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if coeffs.device.type == "cpu":
        return blend_tiles_coeffs_bwd_plain(coeffs, colors, opacs, g)
    if coeffs.device.type != "cuda":
        raise ValueError(f"blend_tiles_coeffs_bwd: unsupported device {coeffs.device}")
    return _launch_bwd(coeffs, colors, opacs, g.contiguous())


def _card_only(name, coeffs):
    if coeffs.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors only, got {coeffs.device}")


def blend_tiles_coeffs_baseline(coeffs, colors, opacs):
    """K8's forward in its design before (`d3ga_blend_coeffs_v1`: one
    thread a pixel, coeff_walk.cuh's walk, each thread storing its pixel)
    on CUDA tensors: the bit reference and the timing baseline of
    `blend_tiles_coeffs`' kernel."""
    global baseline_launches
    _card_only("blend_tiles_coeffs_baseline", coeffs)
    out, n = _launch_fwd(coeffs, colors, opacs, "blend_tiles_coeffs_baseline",
                         "d3ga_blend_coeffs_v1")
    baseline_launches += n
    return out


def blend_tiles_coeffs_stage(coeffs, colors, opacs, stage, design="kernel"):
    """One of FWD_DESIGNS ("kernel": K8's forward; "kernel_no_cull": the
    same with the band cull off, the same bits; "kernel_r1" / "kernel_r2"
    / "kernel_r4": its walk at 1, 2 or 4 slots a batch) cut after `stage`
    of FWD_STAGES, on CUDA tensors: [T, 256, C+1] of what the cut computed
    (stage 2 is the whole forward). Only "kernel" is cut before stage 2;
    those cuts and the batch variants take C = STAGE_C only."""
    whole = len(FWD_STAGES) - 1
    C = colors.shape[-1]
    if stage not in range(len(FWD_STAGES)) or design not in FWD_DESIGNS:
        raise ValueError(f"blend_tiles_coeffs_stage: stage {stage} of design {design!r}")
    if design != "kernel" and stage != whole:
        raise ValueError(f"blend_tiles_coeffs_stage: {design} runs whole (stage {whole}) only")
    if (stage != whole or design.startswith("kernel_r")) and C != STAGE_C:
        raise ValueError(f"blend_tiles_coeffs_stage: stage {stage} of {design} is built for "
                         f"C = {STAGE_C} only, not {C}")
    _card_only("blend_tiles_coeffs_stage", coeffs)
    out, n = _launch_fwd(coeffs, colors, opacs, "blend_tiles_coeffs_stage",
                         "d3ga_blend_coeffs_stage", (FWD_DESIGNS[design], stage))
    stage_launches[design, stage] += n
    return out


def blend_tiles_coeffs_bwd_baseline(coeffs, colors, opacs, g):
    """K8's backward in its design before (`d3ga_blend_coeffs_bwd_v1`: one
    thread a pixel, coeff_walk.cuh's walk, each slot's row stored by one
    thread) on CUDA tensors: the tolerance reference and the timing
    baseline of `blend_tiles_coeffs_bwd`' kernel."""
    global bwd_baseline_launches
    _card_only("blend_tiles_coeffs_bwd_baseline", coeffs)
    grads, n = _launch_bwd_entry(coeffs, colors, opacs, g.contiguous(),
                                 "blend_tiles_coeffs_bwd_baseline", "d3ga_blend_coeffs_bwd_v1")
    bwd_baseline_launches += n
    return grads


def blend_tiles_coeffs_bwd_stage(coeffs, colors, opacs, g, stage, design="kernel"):
    """One of BWD_DESIGNS ("kernel": K8's backward; "kernel_no_cull": the
    same with the band cull off, the same bits) cut after `stage` of
    BWD_STAGES, on CUDA tensors: (dcoeffs, dcolors, dopacs) of what the cut
    computed (stage 4 is the whole backward; a cut before it writes one
    value a thread into the tile's first dcoeffs floats, the outputs zeroed
    first). Only "kernel" is cut before stage 4; those cuts take
    C = STAGE_C only."""
    whole = len(BWD_STAGES) - 1
    C = colors.shape[-1]
    if stage not in range(len(BWD_STAGES)) or design not in BWD_DESIGNS:
        raise ValueError(f"blend_tiles_coeffs_bwd_stage: stage {stage} of design {design!r}")
    if design != "kernel" and stage != whole:
        raise ValueError(f"blend_tiles_coeffs_bwd_stage: {design} runs whole (stage {whole}) only")
    if stage != whole and C != STAGE_C:
        raise ValueError(f"blend_tiles_coeffs_bwd_stage: stage {stage} of {design} is built for "
                         f"C = {STAGE_C} only, not {C}")
    _card_only("blend_tiles_coeffs_bwd_stage", coeffs)
    grads, n = _launch_bwd_entry(coeffs, colors, opacs, g.contiguous(),
                                 "blend_tiles_coeffs_bwd_stage", "d3ga_blend_coeffs_bwd_stage",
                                 (BWD_DESIGNS[design], stage), zero=stage != whole)
    bwd_stage_launches[design, stage] += n
    return grads


class _BlendTilesCoeffs(torch.autograd.Function):
    """K8 with the JAX package's custom VJP; saves the inputs only."""

    @staticmethod
    def forward(ctx, coeffs, colors, opacs, plain):
        ctx.save_for_backward(coeffs, colors, opacs)
        ctx.plain = plain
        if plain:
            return blend_tiles_coeffs_plain(coeffs, colors, opacs)
        return _launch(coeffs, colors, opacs)

    @staticmethod
    def backward(ctx, g):
        coeffs, colors, opacs = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        if ctx.plain:
            grads = blend_tiles_coeffs_bwd_plain(coeffs, colors, opacs, g)
        else:
            grads = _launch_bwd(coeffs, colors, opacs, g)
        return (*grads, None)


def blend_tiles_pallas(coeffs, colors, opacs, plain=False):
    """coeffs [T, K, 8] quadratic falloff coefficients (6 used + 2
    padding), colors [T, K, C], opacs [T, 1, K] float32. Returns
    [T, 256, C+1] (last channel T_bg; the caller composites the
    background), differentiable in all three. CPU tensors, or
    plain=True, take the plain versions forward and backward."""
    dev = coeffs.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"blend_tiles_pallas: unsupported device {coeffs.device}")
    return _BlendTilesCoeffs.apply(
        coeffs.contiguous(), colors.contiguous(), opacs.contiguous(), plain or dev == "cpu"
    )
