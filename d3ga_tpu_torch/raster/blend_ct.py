"""K2 and K3: record gather + front-to-back alpha blend, forward and
backward.

K2 replaces the TPU kernel `d3ga_tpu/raster/pallas_blend_ct.py::_run_forward_ct`
as reached from `pallas_segsum.py::blend_gather_segsum_ct`'s primal, with
the hand-written CUDA kernel `csrc/blend_ct.cu`. K3 replaces
`_run_backward_ct` (`_backward_body_ct`, `_blend_bwd_ct`,
`_coeffs_transpose_ct`) with `csrc/blend_ct_bwd.cu`: the recompute-forward
VJP from the image cotangent to per-slot record cotangents. The sources'
headers give each kernel's bound and design. The record gather is fused
into both kernels, so the [T, CR, K] record tensor is never materialized;
the per-slot cotangents go to the per-Gaussian combine (K4, `segsum.py`).

`blend_gather_ct` is one `torch.autograd.Function` for both devices: on
CUDA tensors K2 forward and K3 + K4 backward, on CPU tensors (or with
plain=True) the plain PyTorch versions of all three. There is no fallback
between the two.

K2 walks a tile with 128 threads of two pixels each, skips the records a
warp's rows cannot take (K3's band cull), and takes the rest in batches
whose polynomials and exps run ahead of the transmittance chain
(`csrc/blend_walk_fwd.cuh`); its image equals the design before's to the
bit. That design (one thread a pixel, `blend_walk.cuh::blend_walk_fwd`,
which K5's and K7's forward baselines also use) stays in the source as
`d3ga_blend_gather_ct_v1`, reached only by `blend_gather_ct_baseline`;
`blend_gather_ct_stage` launches, at C = STAGE_C only, one of the
`FWD_DESIGNS` (K2 at other batch sizes, and diagnostic builds that
record each block's SM and clocks) or K2 cut at one of the
`FWD_STAGES`.

K3 walks a tile with 128 threads of two pixels each, skips the records
a warp's rows cannot take (the band cull), and sums each record's
cotangents by a warp reduce-scatter (`csrc/blend_walk_bwd.cuh`; K5's
and K7's backwards walk with it too). The design before (one thread a
pixel, `blend_walk.cuh::blend_walk_bwd`, which K5's and K7's backward
baselines also use) stays in the source as
`d3ga_blend_gather_ct_bwd_v1`, reached only by
`blend_gather_ct_bwd_baseline`; `blend_gather_ct_bwd_stage` launches one
of the `DESIGNS` whole (K3 with the band cull off among them, the
reference for the cull's bits) or, at C = STAGE_C only, cut at one of
the `STAGES` (the walks' STAGE parameter), with its own counters.
chip_smoke.py uses the baselines and the stage entry points to check the
designs' bits and to time the designs and split them in turns; none is
on any path of the port.
"""

import ctypes
import functools

import torch

from d3ga_tpu_torch.ops.flog import flog, fma32
from d3ga_tpu_torch.raster import segsum
from d3ga_tpu_torch.utils import cuda_build

TILE = 16
NPIX = TILE * TILE
ALPHA_SKIP = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
OP_EPS = 1e-12
MAX_C = 8  # colour channels the kernels are instantiated for

# one per launch of the CUDA kernel (never for the plain version)
launches = 0
bwd_launches = 0
# K3's stage cuts (csrc/blend_ct_bwd.cu): each writes what it computed, so
# the differences of their device times split the kernel; stage 4 is K3
STAGES = ("staging + stores", "walk 1", "walk 2 per pixel", "per-record sums", "epilogue")
# the designs the stage entry point launches: the baseline (the design
# before), K3, K3 with the band cull off, and K3's walk at 1 or 4 pixels a
# thread (it takes 2); the cuts before stage 4 and the pixel variants are
# built for C = STAGE_C (the champion's) only
DESIGNS = {"baseline": 0, "kernel": 1, "kernel_no_cull": 2, "kernel_p1": 3, "kernel_p4": 4}
STAGE_C = 6
# one per launch of K3's baseline design and of each (design, stage) cut
# (chip_smoke.py's comparisons only)
baseline_launches = 0
stage_launches = {(d, s): 0 for d in DESIGNS for s in range(len(STAGES))}
# K2's stage cuts (csrc/blend_ct.cu, csrc/blend_walk_fwd.cuh): stage 2 is K2
FWD_STAGES = ("staging + stores", "batch polynomials + exps", "transmittance chain")
# the designs K2's stage entry point launches, all at C = STAGE_C only: the
# baseline (the design before), K2, K2's walk at 1, 2 or 4 records a batch
# (it takes FWD_BATCH), and the baseline and K2 writing each block's SM
# and clock64 at start and end (FWD_DIAG); only "kernel" is cut before
# stage 2
FWD_DESIGNS = {"baseline": 0, "kernel": 1, "kernel_r1": 2, "kernel_r2": 3, "kernel_r4": 4,
               "baseline_diag": 5, "kernel_diag": 6}
FWD_DIAG = ("baseline_diag", "kernel_diag")
FWD_BATCH = 8
# one per launch of K2's baseline design and of each (design, stage) cut
fwd_baseline_launches = 0
fwd_stage_launches = {(d, s): 0 for d in FWD_DESIGNS for s in range(len(FWD_STAGES))}


def _pixel_basis(device):
    """[256, 6] quadratic basis (1, dx, dy, dx^2, dy^2, dx dy) at the
    tile-local integer pixel offsets, pixel p = dy * 16 + dx."""
    p = torch.arange(NPIX, device=device)
    dx = (p % TILE).float()
    dy = (p // TILE).float()
    return torch.stack([torch.ones_like(dx), dx, dy, dx * dx, dy * dy, dx * dy], -1)


def _tile_origins(T, ntx, device, offset=0):
    """[T, 2] pixel origins of tiles offset .. offset + T - 1 of a
    row-major grid ntx tiles wide."""
    tids = offset + torch.arange(T, device=device)
    return torch.stack([(tids % ntx) * TILE, (tids // ntx) * TILE], -1).float()


def split_power(basis, coeffs):
    """basis [256, 6] times coeffs [B, K, 6] -> [B, 256, K], as the JAX
    kernel's `pallas_blend.py::_dot_split_b` rounds it: the coefficients
    split into their bfloat16 part hi and the float32 rest lo = c - hi,
    the two products summed. The basis is small integers, so every
    product is exact and only the sums round."""
    hi = coeffs.to(torch.bfloat16).float()
    return (torch.einsum("pc,bkc->bpk", basis, hi)
            + torch.einsum("pc,bkc->bpk", basis, coeffs - hi))


def _blend_chunk(rec, org, live, basis):
    """The forward of `_blend_fwd_ct` for a chunk of tiles: rec [B, K, CR]
    gathered records, org [B, 2] tile origins, live [B, K] slot mask.
    Returns the per-(tile, pixel, slot) intermediates the backward reuses."""
    x = rec[..., 0] - org[:, 0:1]
    y = rec[..., 1] - org[:, 1:2]
    A, B, Cc = rec[..., 2], rec[..., 3], rec[..., 4]
    logop = flog(torch.clamp(rec[..., 5], min=OP_EPS))
    c0 = -0.5 * (A * x * x + Cc * y * y) - B * x * y
    # the constant row of coeffs2 as XLA-CPU computes it in the JAX
    # kernel, whose alpha tests it decides on the 1/255 threshold: the log
    # its own (ops/flog.py), A x^2 + C y^2 contracted to one fma
    c0_fma = -0.5 * fma32(A * x, x, Cc * y * y) - B * x * y
    rest = [A * x + B * y, Cc * y + B * x, -0.5 * A, -0.5 * Cc, -B]
    coeffs = torch.stack([c0] + rest, -1)  # [B, K, 6]
    coeffs2 = torch.stack([c0_fma + logop] + rest, -1)
    power = split_power(basis, coeffs)  # [B, 256, K]
    raw = torch.exp(split_power(basis, coeffs2))
    alpha = torch.clamp(raw, max=ALPHA_MAX)
    use = live[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_SKIP)
    alpha = torch.where(use, alpha, 0.0)
    lg = torch.log1p(-alpha)
    t_before = torch.exp(torch.cumsum(lg, -1) - lg)
    accept = t_before * (1.0 - alpha) >= T_EPS
    w = torch.where(accept, alpha * t_before, 0.0)
    t_bg = torch.exp(torch.sum(torch.where(accept, lg, 0.0), -1))  # [B, 256]
    return dict(x=x, y=y, raw=raw, alpha=alpha, use=use, t_before=t_before,
                accept=accept, w=w, t_bg=t_bg)


def blend_tiles_plain(records_ext, idx, counts, origin, C, tile_chunk=256):
    """Gather + blend of each tile's records, tile-major: [T, 256, C+1]
    (pixel p = dy * 16 + dx, T_bg last) for tiles with pixel origins
    origin [T, 2], and the number of (pixel, record) pairs a front-to-back
    walk visits (the kernels' work on this data). Tiles go in chunks of
    `tile_chunk` so the [chunk, 256, K] intermediates stay bounded."""
    T, K = idx.shape
    dev = records_ext.device
    basis = _pixel_basis(dev)
    slot = torch.arange(K, device=dev)
    tiles, pairs = [], 0
    for c0 in range(0, T, tile_chunk):
        rec = records_ext[idx[c0 : c0 + tile_chunk].long()]  # [B, K, CR]
        live = slot[None] < counts[c0 : c0 + tile_chunk, None]  # [B, K]
        f = _blend_chunk(rec, origin[c0 : c0 + tile_chunk], live, basis)
        rgb = torch.einsum("bpk,bkc->bpc", f["w"], rec[..., 6 : 6 + C])
        tiles.append(torch.cat([rgb, f["t_bg"][..., None]], -1))
        pairs += (live[:, None, :] & (f["t_before"] >= T_EPS)).sum()
    return torch.cat(tiles, 0), int(pairs)


def blend_tiles_bwd_plain(records_ext, idx, counts, origin, g_t, C, tile_chunk=256):
    """`_blend_bwd_ct` + `_coeffs_transpose_ct` written out in float32
    (not autograd of the plain forward, whose gradient differs at the 0.99
    clamp and in the opacity term), for tiles with pixel origins origin
    [T, 2] and the tile-major cotangent g_t [T, 256, C+1]. Returns drec
    [T, K, CR], the cotangent of each slot's gathered record (zero for
    slots past counts[t])."""
    T, K = idx.shape
    CR = records_ext.shape[1]
    dev = records_ext.device
    basis = _pixel_basis(dev)
    slot = torch.arange(K, device=dev)
    out = []
    for c0 in range(0, T, tile_chunk):
        rec = records_ext[idx[c0 : c0 + tile_chunk].long()]  # [B, K, CR]
        live = slot[None] < counts[c0 : c0 + tile_chunk, None]
        f = _blend_chunk(rec, origin[c0 : c0 + tile_chunk], live, basis)
        g_rgb = g_t[c0 : c0 + tile_chunk, :, :C]  # [B, 256, C]
        g_tbg = g_t[c0 : c0 + tile_chunk, :, C]  # [B, 256]
        w, accept, alpha, raw = f["w"], f["accept"], f["alpha"], f["raw"]
        dw = torch.einsum("bpc,bkc->bpk", g_rgb, rec[..., 6 : 6 + C])
        dcolors = torch.einsum("bpc,bpk->bkc", g_rgb, w)
        ds = dw * w
        # sum over the records behind each one: total - inclusive prefix
        dlg = torch.sum(ds, -1, keepdim=True) - torch.cumsum(ds, -1)
        dlg = dlg + torch.where(accept, (g_tbg * f["t_bg"])[..., None], 0.0)
        dalpha = torch.where(accept, dw * f["t_before"], 0.0) - dlg / (1.0 - alpha)
        live_px = f["use"] & (raw < ALPHA_MAX)
        dpower2 = torch.where(live_px, dalpha * raw, 0.0)
        d = torch.einsum("pc,bpk->bkc", basis, dpower2)  # [B, K, 6]
        d0, d1, d2, d3, d4, d5 = d.unbind(-1)
        x, y = f["x"], f["y"]
        A, B, Cc, op = rec[..., 2], rec[..., 3], rec[..., 4], rec[..., 5]
        parts = [
            -d0 * (A * x + B * y) + d1 * A + d2 * B,
            -d0 * (Cc * y + B * x) + d1 * B + d2 * Cc,
            -0.5 * d0 * x * x + d1 * x - 0.5 * d3,
            -d0 * x * y + d1 * y + d2 * x - d5,
            -0.5 * d0 * y * y + d2 * y - 0.5 * d4,
            torch.where(op > 0.0, d0 / torch.clamp(op, min=OP_EPS), 0.0),
        ]
        drec = torch.cat([torch.stack(parts, -1), dcolors], -1)
        drec = torch.nn.functional.pad(drec, (0, CR - 6 - C))
        out.append(torch.where(live[..., None], drec, 0.0))
    return torch.cat(out, 0)


def blend_gather_ct_plain(
    records_ext, idx, counts, ntx, nty, C, tile_chunk=256, count_pairs=False
):
    """Plain PyTorch version of K2, mirroring `_blend_fwd_ct` in float32:
    gather, falloff polynomial, alpha rules, then log-transmittance cumsum
    over K (`blend_tiles_plain`), assembled into the planar image.
    count_pairs=True also returns the number of (pixel, record) pairs a
    front-to-back walk visits (the kernel's work on this data)."""
    T = idx.shape[0]
    origin = _tile_origins(T, ntx, records_ext.device)
    out, pairs = blend_tiles_plain(records_ext, idx, counts, origin, C, tile_chunk)
    out = (
        out.reshape(nty, ntx, TILE, TILE, C + 1)
        .permute(4, 0, 2, 1, 3)
        .reshape(C + 1, nty * TILE, ntx * TILE)
    )
    return (out, pairs) if count_pairs else out


def blend_gather_ct_bwd_plain(records_ext, idx, counts, g, ntx, nty, C, tile_chunk=256):
    """Plain PyTorch version of K3 (`blend_tiles_bwd_plain` on the planar
    image cotangent g: [(C+1), nty*16, ntx*16], T_bg plane last).
    Returns drec [T, K, CR]."""
    T = idx.shape[0]
    # planar image -> [T, 256, C+1], the forward's assembly undone
    g_t = (
        g.reshape(C + 1, nty, TILE, ntx, TILE)
        .permute(1, 3, 2, 4, 0)
        .reshape(T, NPIX, C + 1)
    )
    origin = _tile_origins(T, ntx, records_ext.device)
    return blend_tiles_bwd_plain(records_ext, idx, counts, origin, g_t, C, tile_chunk)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("blend_ct")
    p, i = ctypes.c_void_p, ctypes.c_int
    args = [p, i, i, p, i, p, i, i, i, p]
    for name, extra in (("d3ga_blend_gather_ct", [p]), ("d3ga_blend_gather_ct_v1", [p]),
                        ("d3ga_blend_gather_ct_stage", [i, i, p, p])):
        fn = getattr(lib, name)
        fn.argtypes = args + extra
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = cuda_build.load("blend_ct_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    args = [p, i, i, p, i, p, i, i, i, p, p]
    for name, extra in (("d3ga_blend_gather_ct_bwd", [p]), ("d3ga_blend_gather_ct_bwd_v1", [p]),
                        ("d3ga_blend_gather_ct_bwd_stage", [i, i, p])):
        fn = getattr(lib, name)
        fn.argtypes = args + extra
        fn.restype = ctypes.c_int
    return lib


def _check(name, records_ext, idx, counts, ntx, nty, C):
    if records_ext.dtype != torch.float32:
        raise TypeError(f"{name}: records must be float32, got {records_ext.dtype}")
    if idx.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError(f"{name}: idx and counts must be int32")
    if records_ext.ndim != 2 or idx.ndim != 2 or counts.ndim != 1:
        raise ValueError(f"{name}: expected records [N+1, CR], idx [T, K], counts [T]")
    T = idx.shape[0]
    if T != ntx * nty or counts.shape[0] != T:
        raise ValueError(f"{name}: {T} tiles for a {ntx}x{nty} grid, {counts.shape[0]} counts")
    if not 1 <= C <= MAX_C or records_ext.shape[1] < 6 + C:
        raise ValueError(f"{name}: C={C} with {records_ext.shape[1]} record columns unsupported")
    if not (idx.device == counts.device == records_ext.device):
        raise ValueError(f"{name}: inputs on different devices")
    if not (records_ext.is_contiguous() and idx.is_contiguous() and counts.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def _launch_fwd(records_ext, idx, counts, ntx, nty, C, name="blend_gather_ct",
                entry="d3ga_blend_gather_ct", extra=()):
    """Checks, allocates the planar image and launches the K2 entry point
    `entry` of csrc/blend_ct.cu (with `extra` arguments): (out, 1 if it
    launched the kernel else 0), the caller adding the latter to its
    count."""
    _check(name, records_ext, idx, counts, ntx, nty, C)
    n_ext, CR = records_ext.shape
    T, K = idx.shape
    out = torch.empty((C + 1, nty * TILE, ntx * TILE), dtype=torch.float32,
                      device=records_ext.device)
    if T == 0:
        return out, 0
    err = getattr(_lib(), entry)(
        records_ext.data_ptr(), n_ext, CR, idx.data_ptr(), K, counts.data_ptr(), ntx, nty, C,
        out.data_ptr(), *extra, cuda_build.stream_handle(records_ext.device))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
    return out, 1


def _launch(records_ext, idx, counts, ntx, nty, C):
    global launches
    out, n = _launch_fwd(records_ext, idx, counts, ntx, nty, C)
    launches += n
    return out


def _launch_bwd(records_ext, idx, counts, g, ntx, nty, C, name="blend_gather_ct_bwd",
                entry="d3ga_blend_gather_ct_bwd", extra=()):
    """Checks, allocates drec [T, K, CR] and launches the K3 entry point
    `entry` of csrc/blend_ct_bwd.cu (with `extra` int arguments): (drec,
    1 if it launched the kernel else 0), the caller adding the latter to
    its count."""
    _check(name, records_ext, idx, counts, ntx, nty, C)
    if g.dtype != torch.float32 or tuple(g.shape) != (C + 1, nty * TILE, ntx * TILE):
        raise ValueError(f"{name}: cotangent {g.dtype} {tuple(g.shape)}")
    if g.device != records_ext.device or not g.is_contiguous():
        raise ValueError(f"{name}: cotangent on another device or not contiguous")
    n_ext, CR = records_ext.shape
    T, K = idx.shape
    drec = torch.empty((T, K, CR), dtype=torch.float32, device=records_ext.device)
    if T == 0:
        return drec, 0
    err = getattr(_bwd_lib(), entry)(
        records_ext.data_ptr(), n_ext, CR, idx.data_ptr(), K, counts.data_ptr(), ntx, nty, C,
        g.data_ptr(), drec.data_ptr(), *extra, cuda_build.stream_handle(records_ext.device))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
    return drec, 1


def _launch_k3(records_ext, idx, counts, g, ntx, nty, C):
    global bwd_launches
    drec, n = _launch_bwd(records_ext, idx, counts, g, ntx, nty, C)
    bwd_launches += n
    return drec


def blend_gather_ct_bwd(records_ext, idx, counts, g, ntx, nty, C):
    """K3: drec [T, K, CR] per-slot record cotangents of the blend for the
    image cotangent g [(C+1), nty*16, ntx*16]; the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if records_ext.device.type == "cpu":
        return blend_gather_ct_bwd_plain(records_ext, idx, counts, g, ntx, nty, C)
    if records_ext.device.type != "cuda":
        raise ValueError(f"blend_gather_ct_bwd: unsupported device {records_ext.device}")
    return _launch_k3(records_ext, idx, counts, g.contiguous(), ntx, nty, C)


def _card_only(name, records_ext):
    if records_ext.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors only, got {records_ext.device}")


def blend_gather_ct_baseline(records_ext, idx, counts, ntx, nty, C):
    """K2's design before (`d3ga_blend_gather_ct_v1`: one thread a pixel,
    blend_walk.cuh's walk) on CUDA tensors: the bit reference and the
    timing baseline of `blend_gather_ct`'s kernel."""
    global fwd_baseline_launches
    _card_only("blend_gather_ct_baseline", records_ext)
    out, n = _launch_fwd(records_ext, idx, counts, ntx, nty, C, "blend_gather_ct_baseline",
                         "d3ga_blend_gather_ct_v1")
    fwd_baseline_launches += n
    return out


def blend_gather_ct_stage(records_ext, idx, counts, ntx, nty, C, stage, design="kernel"):
    """One of FWD_DESIGNS ("kernel": K2; "baseline": its design before;
    "kernel_r1" / "kernel_r2" / "kernel_r4": K2's walk at 1, 2 or 4
    records a batch; FWD_DIAG: the baseline or K2 recording each block's
    SM) cut after `stage` of FWD_STAGES, on CUDA tensors at C = STAGE_C:
    the planar image of what the cut computed (stage 2 is the whole
    kernel). Only "kernel" is cut before stage 2. A FWD_DIAG design
    returns (image, diag): diag [T, 3] int64, each block's SM id and its
    clock64 at start and at end (the SM's own clock)."""
    whole = len(FWD_STAGES) - 1
    if stage not in range(len(FWD_STAGES)) or design not in FWD_DESIGNS:
        raise ValueError(f"blend_gather_ct_stage: stage {stage} of design {design!r}")
    if design != "kernel" and stage != whole:
        raise ValueError(f"blend_gather_ct_stage: {design} runs whole (stage {whole}) only")
    if C != STAGE_C:
        raise ValueError(f"blend_gather_ct_stage: built for C = {STAGE_C} only, not {C}")
    _card_only("blend_gather_ct_stage", records_ext)
    # allocated for the diagnostic builds only: a fill would add a launch
    # to the timed calls of the others
    diag = (torch.zeros((idx.shape[0], 3), dtype=torch.int64, device=records_ext.device)
            if design in FWD_DIAG else None)
    out, n = _launch_fwd(records_ext, idx, counts, ntx, nty, C, "blend_gather_ct_stage",
                         "d3ga_blend_gather_ct_stage",
                         (FWD_DESIGNS[design], stage, None if diag is None else diag.data_ptr()))
    fwd_stage_launches[design, stage] += n
    return out if diag is None else (out, diag)


def blend_gather_ct_bwd_baseline(records_ext, idx, counts, g, ntx, nty, C):
    """K3's design before (`d3ga_blend_gather_ct_bwd_v1`: one thread a
    pixel, blend_walk.cuh's walk) on CUDA tensors, for timing against
    `blend_gather_ct_bwd`."""
    global baseline_launches
    _card_only("blend_gather_ct_bwd_baseline", records_ext)
    drec, n = _launch_bwd(records_ext, idx, counts, g.contiguous(), ntx, nty, C,
                          "blend_gather_ct_bwd_baseline", "d3ga_blend_gather_ct_bwd_v1")
    baseline_launches += n
    return drec


def blend_gather_ct_bwd_stage(records_ext, idx, counts, g, ntx, nty, C, stage, design="kernel"):
    """One of DESIGNS ("kernel": K3; "baseline": its design before;
    "kernel_no_cull": K3 with the band cull off, the same bits; "kernel_p1"
    / "kernel_p4": K3's walk at 1 or 4 pixels a thread) cut after `stage`
    of STAGES, on CUDA tensors: drec-shaped rows of what the cut computed
    (stage 4 is the whole kernel). Only the baseline and K3 are cut before
    stage 4; those cuts and the pixel variants take C = STAGE_C only."""
    whole = len(STAGES) - 1
    if stage not in range(len(STAGES)) or design not in DESIGNS:
        raise ValueError(f"blend_gather_ct_bwd_stage: stage {stage} of design {design!r}")
    if design not in ("baseline", "kernel") and stage != whole:
        raise ValueError(f"blend_gather_ct_bwd_stage: {design} runs whole (stage 4) only")
    if (stage != whole or design.startswith("kernel_p")) and C != STAGE_C:
        raise ValueError(f"blend_gather_ct_bwd_stage: stage {stage} of {design} is built for "
                         f"C = {STAGE_C} only, not {C}")
    _card_only("blend_gather_ct_bwd_stage", records_ext)
    drec, n = _launch_bwd(records_ext, idx, counts, g.contiguous(), ntx, nty, C,
                          "blend_gather_ct_bwd_stage", "d3ga_blend_gather_ct_bwd_stage",
                          (DESIGNS[design], stage))
    stage_launches[design, stage] += n
    return drec


class _BlendGatherCT(torch.autograd.Function):
    """Gather + blend with the JAX package's custom VJP: the backward is
    K3 (per-slot cotangents) then the id sort + K4 (per-Gaussian sums),
    or their plain versions. Saves the inputs only, no [T, CR, K] records."""

    @staticmethod
    def forward(ctx, records_ext, idx, counts, ntx, nty, C, dup2, plain):
        ctx.save_for_backward(records_ext, idx, counts)
        ctx.meta = (ntx, nty, C, dup2, plain)
        if plain:
            return blend_gather_ct_plain(records_ext, idx, counts, ntx, nty, C)
        return _launch(records_ext, idx, counts, ntx, nty, C)

    @staticmethod
    def backward(ctx, g):
        records_ext, idx, counts = ctx.saved_tensors
        ntx, nty, C, dup2, plain = ctx.meta
        g = g.to(torch.float32).contiguous()
        n = records_ext.shape[0] - 1
        if plain:
            drec = blend_gather_ct_bwd_plain(records_ext, idx, counts, g, ntx, nty, C)
        else:
            drec = _launch_k3(records_ext, idx, counts, g, ntx, nty, C)
        dre = segsum.combine_from_slots(drec, idx, n, dup2, plain=plain)
        return dre, None, None, None, None, None, None, None


def blend_gather_ct(records_ext, idx, counts, ntx, nty, C, dup2=None, plain=False):
    """records_ext [N+1, CR] float32 packed records (x, y, conic a/b/c,
    opacity, C colours; xy in global pixel coordinates) with a zero
    sentinel row; idx [T, K] int32 record ids in front-to-back order (N
    for empty slots); counts [T] int32 live slots per tile (<= K).
    Returns the planar image [(C+1), nty*16, ntx*16], T_bg last,
    differentiable in records_ext. dup2 bounds the occurrences of one id
    in idx (the dupsort selection's dup^2), checked by the plain combine.
    CPU tensors, or plain=True, take the plain versions forward and
    backward."""
    dev = records_ext.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"blend_gather_ct: unsupported device {records_ext.device}")
    return _BlendGatherCT.apply(
        records_ext, idx, counts, ntx, nty, C, dup2, plain or dev == "cpu"
    )
