"""K9: fused per-tile selection + compaction + alpha blend over 8x8-tile
blocks of candidates, forward and backward (counterpart of
d3ga_tpu/raster/attic/pallas_fused.py and attic/pallas_fused2.py).

The two JAX variants compute one function: per 8x8-tile block, each
tile's first K overlapping candidates in rank order, then the blend of
`pallas_blend.py` over their tile-local falloff coefficients. They differ
only in how a TPU compacts lanes (v1: banded one-hot matmuls, v2: masked
lane-roll butterflies), and in their input layouts:

- `fused_select_blend` (v1): vals [NB, NC, 16, 128], rects [NB, NC, 128];
- `fused_select_blend2` (v2): vals [NB, 16, KB], rects [NB, 1, KB];

kb = NC * 128 = KB candidates a block, in depth-rank order. The 16
channels are (x, y in block-local pixels, conic A, B, C, opacity, C
colours, zero padding); rects pack each candidate's block-local tile rect
(xmin | xmax << 8 | ymin << 16 | ymax << 24). Invalid candidates have
rect 0 and opacity 0. C <= 10. Both return (tiles [NB, 64, 256, C+1]
with T_bg last, counts [NB, 64] int32, the uncapped overlap counts). Both
hand their inputs over as records-major vals [NB, kb, 16] and rects
[NB, kb] (a view where the caller's tensor allows it: the fused raster
builds that layout, so its calls copy nothing) to `select_blend`, one
`torch.autograd.Function`; autograd carries d(vals) back to the caller's
layout. On CUDA tensors that Function runs the hand-written kernels of
`csrc/fused.cu` (its header gives the bound and the design); on CPU
tensors (or with plain=True) the plain versions below. There is no
fallback between the two.

The forward (`csrc/fused.cu::fused_fwd_kernel`) selects with two rects a
thread a round and walks a tile with 128 threads of two pixels each,
skipping the slots a warp's rows cannot take (a band cull), in batches
of 8 listed slots, and writes each tile's block as 16-byte stores
(`csrc/coeff_walk_fwd.cuh`); its tiles are its design before's to the
bit. That design (one thread a pixel, `coeff_walk.cuh`'s walk) stays in
the source as `d3ga_fused_v1`, reached only by `select_blend_baseline`
(and, cut, by probe P3); `select_blend_stage` launches one of the
`FWD_DESIGNS` whole (the kernel with the band cull off, the reference for
the cull's bits, among them) or, at C = STAGE_C only, the kernel cut at
one of the `FWD_STAGES`, with its own counters.

The backward's per-tile kernel walks a tile with 128 threads of two
pixels each, skips the slots a warp's rows cannot take (a band cull) and
sums each slot's cotangents by a warp reduce-scatter
(`csrc/coeff_walk_bwd.cuh`). Its design before (one thread a pixel,
`coeff_walk.cuh`'s walk) stays in the source as `d3ga_fused_bwd_v1`,
reached only by `select_blend_bwd_baseline`; `select_blend_bwd_stage`
launches one of the `BWD_DESIGNS` whole (the kernel with the band cull
off among them, the reference for the cull's bits) or, at C = STAGE_C
only, the kernel cut at one of the `BWD_STAGES`, with its own counters.
The backward's second kernel, the route, sums each lane's slot rows over
its rect's tiles in tile order: a group of ROUTE_GROUP threads a lane
searches the tiles side by side and adds the rows in the design before's
order, so d(vals) keeps its bits. `select_blend_bwd_tiles` launches the
per-tile kernel alone and `route` one of the `ROUTE_DESIGNS` on its
scratch (the design before, one thread a lane, among them; `route_plain`
on `scratch_lanes` is the plain version). chip_smoke.py uses these entry
points to check the culls' and the route's bits and to time the designs
and the stages in turns; none is on any path of the port.

The plain versions work block by block: per tile the rect mask, the
first K overlapping lanes in rank order (the inclusive position cumsum's
first K), the records gathered and shifted from block-local to
tile-local coordinates, the falloff coefficients, then K8's plain blend
(`blend.py`). The backward routes each slot's cotangent back to its
lane, summed in tile order.
"""

import ctypes
import functools

import torch
import torch.nn.functional as Fn

from d3ga_tpu_torch.ops.flog import fma32
from d3ga_tpu_torch.raster import blend
from d3ga_tpu_torch.utils import cuda_build

TILE = 16
NPIX = TILE * TILE
BLOCK = 8
TB = BLOCK * BLOCK  # tiles a block
CHUNK = 128
NCH = 16  # record channels
MAX_C = NCH - 6
MAX_K = 1024  # the kernels keep a tile's K lane ids in shared memory
BLOCK_CHUNK = 8  # blocks a step of the plain versions: [8 * 64, 256, K] intermediates

# one per launch of the CUDA kernels (never for the plain versions); the
# backward's two kernels (per tile, then the route, per block and lane)
# count once in bwd_launches, and the route again in route_launches
launches = 0
bwd_launches = 0
route_launches = 0
# the route's designs (`route`): its design before, the route at
# ROUTE_GROUP threads a lane (every C), and at STAGE_C the route at 2, 4,
# 8, 16 and 32 threads a lane; each has the same bits
ROUTE_DESIGNS = {"baseline": 0, "kernel": 1, "kernel_g2": 2, "kernel_g4": 3, "kernel_g8": 4,
                 "kernel_g16": 5, "kernel_g32": 6}
ROUTE_GROUP = 4
# one per launch of the route alone and of the per-tile kernel alone
# (chip_smoke.py's comparisons and P3's timing only)
route_design_launches = dict.fromkeys(ROUTE_DESIGNS, 0)
tiles_launches = 0
# the backward's stage cuts (csrc/coeff_walk_bwd.cuh): each writes what it
# computed, so the differences of their device times split the per-tile
# kernel; stage 4 is the kernel
BWD_STAGES = ("selection + staging", "walk 1", "walk 2 per pixel", "per-slot sums", "stores")
# the designs the stage entry point launches: the kernel, the kernel with
# the band cull off, and its walk at 1 or 4 pixels a thread (it takes 2);
# the cuts before stage 4 and the pixel variants are built for C = STAGE_C
# (the champion's) only
BWD_DESIGNS = {"kernel": 1, "kernel_no_cull": 2, "kernel_p1": 3, "kernel_p4": 4}
STAGE_C = 6
# one per launch of the backward's baseline design and of each (design,
# stage) cut (chip_smoke.py's comparisons only)
baseline_launches = 0
stage_launches = {(d, s): 0 for d in BWD_DESIGNS for s in range(len(BWD_STAGES))}
# the forward's stage cuts (csrc/coeff_walk_fwd.cuh); stage 2 is the kernel
FWD_STAGES = ("selection + staging + stores", "lists + polynomials + exps", "transmittance chain")
# the designs the forward's stage entry point launches: the kernel, the
# kernel with the band cull off, and its walk at 1, 2 or 4 slots a batch
# (it takes FWD_BATCH); the cuts before stage 2 and the batch variants are
# built for C = STAGE_C only
FWD_DESIGNS = {"kernel": 1, "kernel_no_cull": 2, "kernel_r1": 3, "kernel_r2": 4, "kernel_r4": 5}
FWD_BATCH = 8
# one per launch of the forward's baseline design and of each (design,
# stage) cut (chip_smoke.py's comparisons only)
fwd_baseline_launches = 0
fwd_stage_launches = {(d, s): 0 for d in FWD_DESIGNS for s in range(len(FWD_STAGES))}


def _layout(vals):
    if vals.ndim == 4:
        return 1
    if vals.ndim == 3:
        return 2
    raise ValueError(f"fused_select_blend: vals of shape {tuple(vals.shape)}: expected "
                     "[NB, NC, 16, 128] (v1) or [NB, 16, KB] (v2)")


def _records(vals):
    """The caller's layout -> records-major [NB, kb, 16] (a view)."""
    if _layout(vals) == 1:
        NB, NC = vals.shape[:2]
        return vals.permute(0, 1, 3, 2).reshape(NB, NC * CHUNK, NCH)
    return vals.permute(0, 2, 1)


def _tile_origins(device):
    """[64] x and y pixel origins of a block's tiles, tile t = ty * 8 + tx."""
    t = torch.arange(TB, device=device)
    return (t % BLOCK * TILE).float(), (t // BLOCK * TILE).float()


def _select(rects, K):
    """rects [nb, kb] packed -> (lanes [nb, 64, min(K, kb)] the first
    overlapping lanes of each tile, ascending, kb past its count; counts
    [nb, 64] int32, uncapped)."""
    kb = rects.shape[1]
    r = rects[:, None, :]
    t = torch.arange(TB, device=rects.device)[None, :, None]
    tx, ty = t % BLOCK, t // BLOCK
    m = ((tx >= (r & 0xFF)) & (tx < ((r >> 8) & 0xFF))
         & (ty >= ((r >> 16) & 0xFF)) & (ty < ((r >> 24) & 0xFF)))  # [nb, 64, kb]
    j = torch.arange(kb, device=rects.device)
    lanes = torch.topk(torch.where(m, j, kb), min(K, kb), dim=-1, largest=False,
                       sorted=True).values
    return lanes, m.sum(-1).to(torch.int32)


def _bwd_coeffs(x, y, A, B, Cc):
    """K9's tile-local falloff coefficients [..., 8] (`blend.falloff_coeffs`'
    function) rounded as XLA-CPU rounds `attic/pallas_fused.py::
    _coeffs_from_rec` inside the JAX backward kernel, whose alpha tests
    they decide on the 1/255 threshold: A x^2 + C y^2, A x + B y and
    C y + B x each contracted into one fma (its forward kernel fuses them
    otherwise: B y + A x there, C y + B x not at all)."""
    z = torch.zeros_like(A)
    return torch.stack([-0.5 * fma32(A * x, x, Cc * y * y) - B * x * y, fma32(A, x, B * y),
                        fma32(Cc, y, B * x), -0.5 * A, -0.5 * Cc, -B, z, z], -1)


def _tile_inputs(rec, rects, K, C, backward=False):
    """K8's inputs for a chunk of blocks: rec [nb, kb, 16] records-major
    (with `backward`, the coefficients rounded as K9's JAX backward rounds
    them, `_bwd_coeffs`). Returns (coeffs [nb*64, Kk, 8], colors
    [nb*64, Kk, C], opacs [nb*64, 1, Kk], the slots' records [nb, 64, Kk,
    16] (0 past each tile's count), lanes, hit mask, counts)."""
    nb, kb, _ = rec.shape
    lanes, counts = _select(rects, K)
    hit = lanes < kb
    Kk = lanes.shape[-1]
    idx = torch.where(hit, lanes, 0).reshape(nb, TB * Kk, 1).expand(-1, -1, NCH)
    slot = torch.gather(rec, 1, idx).reshape(nb, TB, Kk, NCH)
    slot = torch.where(hit[..., None], slot, 0.0)
    sx, sy = _tile_origins(rec.device)
    x, y = slot[..., 0] - sx[:, None], slot[..., 1] - sy[:, None]
    if backward:
        coeffs = _bwd_coeffs(x, y, slot[..., 2], slot[..., 3], slot[..., 4])
    else:
        coeffs = blend.falloff_coeffs(torch.stack([x, y], -1), slot[..., 2:5])
    coeffs = coeffs.reshape(nb * TB, Kk, 8)
    colors = slot[..., 6 : 6 + C].reshape(nb * TB, Kk, C)
    opacs = slot[..., 5].reshape(nb * TB, 1, Kk)
    return coeffs, colors, opacs, slot, lanes, hit, counts


def select_blend_plain(vals, rects, K, C, block_chunk=BLOCK_CHUNK, count_pairs=False):
    """Plain PyTorch version of K9's forward on records-major vals
    [NB, kb, 16] and rects [NB, kb]: (tiles [NB, 64, 256, C+1], counts
    [NB, 64] int32); count_pairs=True also returns the (pixel, slot) pairs
    a front-to-back walk visits. Blocks go `block_chunk` at a time so the
    [chunk * 64, 256, K] intermediates stay bounded."""
    NB = vals.shape[0]
    tiles, counts, pairs = [], [], 0
    for b0 in range(0, NB, block_chunk):
        sl = slice(b0, b0 + block_chunk)
        coeffs, colors, opacs, *_, cnt = _tile_inputs(vals[sl], rects[sl], K, C)
        out, p = blend.blend_tiles_coeffs_plain(coeffs, colors, opacs, count_pairs=True)
        tiles.append(out.reshape(-1, TB, NPIX, C + 1))
        counts.append(cnt)
        pairs += p
    tiles, counts = torch.cat(tiles, 0), torch.cat(counts, 0)
    return (tiles, counts, pairs) if count_pairs else (tiles, counts)


def select_blend_bwd_plain(vals, rects, g, K, C, block_chunk=BLOCK_CHUNK):
    """Plain PyTorch version of K9's backward: the cotangent g
    [NB, 64, 256, C+1] of the tiles to d(vals) [NB, kb, 16] — K8's plain
    backward per tile, the transpose of the tile-local coefficients
    (`_coeffs_transpose`), and each slot's (x, y, A, B, C, opacity,
    colours) cotangent added to its lane in tile order; 0 in the padding
    channels and for lanes no tile selected."""
    NB, kb, _ = vals.shape
    out = []
    for b0 in range(0, NB, block_chunk):
        sl = slice(b0, b0 + block_chunk)
        coeffs, colors, opacs, slot, lanes, hit, _ = _tile_inputs(vals[sl], rects[sl], K, C,
                                                                  backward=True)
        nb, Kk = slot.shape[0], slot.shape[2]
        dco, dcol, dop = blend.blend_tiles_coeffs_bwd_plain(
            coeffs, colors, opacs, g[sl].reshape(nb * TB, NPIX, C + 1), split=False)
        d0, d1, d2, d3, d4, d5 = dco.reshape(nb, TB, Kk, 8)[..., :6].unbind(-1)
        sx, sy = _tile_origins(vals.device)
        x, y = slot[..., 0] - sx[:, None], slot[..., 1] - sy[:, None]
        A, B, Cc = slot[..., 2], slot[..., 3], slot[..., 4]
        drec = torch.stack([
            -d0 * (A * x + B * y) + d1 * A + d2 * B,
            -d0 * (Cc * y + B * x) + d1 * B + d2 * Cc,
            -0.5 * d0 * x * x + d1 * x - 0.5 * d3,
            -d0 * x * y + d1 * y + d2 * x - d5,
            -0.5 * d0 * y * y + d2 * y - 0.5 * d4,
            dop.reshape(nb, TB, Kk),
        ], -1)
        out.append(route_plain(torch.cat([drec, dcol.reshape(nb, TB, Kk, C)], -1), lanes, kb))
    return torch.cat(out, 0)


def route_plain(drec, lanes, kb):
    """Plain PyTorch version of K9's route (the backward's kernel 2): each
    slot's row of drec [nb, 64, Kk, 6 + C] added to its lane lanes
    [nb, 64, Kk] (kb or more: no slot, its row not read), summed in tile
    order; d(vals) [nb, kb, 16], 0 in the padding channels and for lanes
    no tile selected."""
    nb, _, Kk, CR = drec.shape
    hit = lanes < kb
    drec = torch.where(hit[..., None], drec, 0.0).reshape(nb, TB * Kk, CR)
    # tile order: slot rows are tile-major, scatter_add_ sums in index order
    idx = torch.where(hit, lanes, kb).reshape(nb, TB * Kk, 1).expand(-1, -1, CR)
    dv = drec.new_zeros((nb, kb + 1, CR)).scatter_add_(1, idx, drec)
    return Fn.pad(dv[:, :kb], (0, NCH - CR))


def scratch_lanes(sel, live, kb):
    """The backward's kernel-1 scratch sel [NB * 64, K] and live [NB * 64]
    as `route_plain`'s lanes [NB, 64, K]: kb past each tile's live count."""
    K = sel.shape[1]
    keep = torch.arange(K, device=sel.device)[None] < live[:, None]
    return torch.where(keep, sel, kb).reshape(-1, TB, K)


@functools.lru_cache(maxsize=None)
def _kernels():
    return bind(cuda_build.load("fused"))


def bind(lib):
    """Declares the entry points' C signatures on `lib`, a loaded build
    of csrc/fused.cu (another tree's may lack the newer ones); returns
    it."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fwd_args = [p, p, i, i, i, i, p, p]
    bwd_args = [p, p, p, i, i, i, i, p, p, p, p]
    cut_args = [p, p, i, i, i, i, i, p, p, p]
    for name, args in (("d3ga_fused", fwd_args + [p]), ("d3ga_fused_v1", fwd_args + [p]),
                       ("d3ga_fused_fwd_stage", fwd_args + [i, i, p]),
                       ("d3ga_fused_stage", cut_args), ("d3ga_fused_p3", cut_args),
                       ("d3ga_fused_bwd", bwd_args + [p]), ("d3ga_fused_bwd_v1", bwd_args + [p]),
                       ("d3ga_fused_bwd_stage", bwd_args + [i, i, p]),
                       ("d3ga_fused_bwd_tiles", bwd_args + [p]),
                       ("d3ga_fused_route", [p, i, i, i, i, p, p, p, p, i, p])):
        try:
            fn = getattr(lib, name)
        except AttributeError:
            continue
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check(name, vals, rects, K, C):
    """Checks the kernels' records-major inputs; returns (NB, kb)."""
    if vals.dtype != torch.float32 or rects.dtype != torch.int32:
        raise TypeError(f"{name}: vals must be float32 and rects int32")
    if not (vals.is_contiguous() and rects.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if vals.device != rects.device:
        raise ValueError(f"{name}: inputs on different devices")
    if vals.ndim != 3 or vals.shape[2] != NCH or tuple(rects.shape) != tuple(vals.shape[:2]):
        raise ValueError(f"{name}: vals {tuple(vals.shape)} and rects {tuple(rects.shape)}: "
                         f"expected [NB, kb, {NCH}] and [NB, kb]")
    if not 1 <= C <= MAX_C:
        raise ValueError(f"{name}: C={C} unsupported (1..{MAX_C})")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{name}: K={K} unsupported (1..{MAX_K})")
    return vals.shape[:2]


def _launch_fwd(vals, rects, K, C, name, entry, extra=()):
    """Checks, allocates the tiles and counts and launches the forward
    entry point `entry` of csrc/fused.cu (with `extra` int arguments):
    ((tiles, counts), 1 if it launched the kernel else 0), the caller
    adding the latter to its count."""
    NB, kb = _check(name, vals, rects, K, C)
    dev = vals.device
    tiles = torch.empty((NB, TB, NPIX, C + 1), dtype=torch.float32, device=dev)
    counts = torch.empty((NB, TB), dtype=torch.int32, device=dev)
    if NB == 0:
        return (tiles, counts), 0
    err = getattr(_kernels(), entry)(vals.data_ptr(), rects.data_ptr(), NB, kb, K, C,
                                     tiles.data_ptr(), counts.data_ptr(), *extra,
                                     cuda_build.stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
    return (tiles, counts), 1


def _launch(vals, rects, K, C):
    global launches
    out, n = _launch_fwd(vals, rects, K, C, "select_blend", "d3ga_fused")
    launches += n
    return out


def _launch_bwd(vals, rects, g, K, C, name="select_blend_bwd", entry="d3ga_fused_bwd",
                extra=(), zero=False):
    """Checks, allocates d(vals) and the per-tile kernel's scratch (zeroed
    with `zero`), and launches the backward entry point `entry` of
    csrc/fused.cu (with `extra` int arguments): (dvals, 1 if it launched
    the kernels else 0), the caller adding the latter to its count."""
    NB, kb = _check(name, vals, rects, K, C)
    dev = vals.device
    if (g.dtype != torch.float32 or tuple(g.shape) != (NB, TB, NPIX, C + 1)
            or not g.is_contiguous() or g.device != dev):
        raise ValueError(f"{name}: cotangent {g.dtype} {tuple(g.shape)} on {g.device}")
    dvals = torch.empty_like(vals)
    if NB == 0:
        return dvals, 0
    # the per-tile kernel's slot rows, lane ids and live-slot counts
    drec = (torch.zeros if zero else torch.empty)((NB * TB, K, 6 + C), dtype=torch.float32,
                                                  device=dev)
    sel = torch.empty((NB * TB, K), dtype=torch.int32, device=dev)
    live = torch.empty((NB * TB,), dtype=torch.int32, device=dev)
    err = getattr(_kernels(), entry)(
        vals.data_ptr(), rects.data_ptr(), g.data_ptr(), NB, kb, K, C, drec.data_ptr(),
        sel.data_ptr(), live.data_ptr(), dvals.data_ptr(), *extra, cuda_build.stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
    return dvals, 1


def _launch_k9_bwd(vals, rects, g, K, C):
    global bwd_launches, route_launches
    dvals, n = _launch_bwd(vals, rects, g, K, C)
    bwd_launches += n
    route_launches += n
    return dvals


def _device(name, vals):
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {vals.device}")
    return vals.device.type


def select_blend_bwd(vals, rects, g, K, C):
    """K9's backward without autograd: d(vals) [NB, kb, 16] for the
    tiles' cotangent g [NB, 64, 256, C+1]; the kernels on CUDA tensors,
    the plain version on CPU tensors."""
    if _device("select_blend_bwd", vals) == "cpu":
        return select_blend_bwd_plain(vals, rects, g, K, C)
    return _launch_k9_bwd(vals, rects, g.contiguous(), K, C)


def _card_only(name, vals):
    if vals.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors only, got {vals.device}")


def select_blend_baseline(vals, rects, K, C):
    """K9's forward in its design before (`d3ga_fused_v1`: one thread a
    pixel, coeff_walk.cuh's walk, each thread storing its pixel) on CUDA
    tensors: the bit reference and the timing baseline of `select_blend`'s
    kernel. (tiles, counts)."""
    global fwd_baseline_launches
    _card_only("select_blend_baseline", vals)
    out, n = _launch_fwd(vals, rects, K, C, "select_blend_baseline", "d3ga_fused_v1")
    fwd_baseline_launches += n
    return out


def select_blend_stage(vals, rects, K, C, stage, design="kernel"):
    """One of FWD_DESIGNS ("kernel": K9's forward; "kernel_no_cull": the
    same with the band cull off, the same bits; "kernel_r1" / "kernel_r2"
    / "kernel_r4": its walk at 1, 2 or 4 slots a batch) cut after `stage`
    of FWD_STAGES, on CUDA tensors: (tiles of what the cut computed,
    counts); stage 2 is the whole forward. Only "kernel" is cut before
    stage 2; those cuts and the batch variants take C = STAGE_C only."""
    whole = len(FWD_STAGES) - 1
    if stage not in range(len(FWD_STAGES)) or design not in FWD_DESIGNS:
        raise ValueError(f"select_blend_stage: stage {stage} of design {design!r}")
    if design != "kernel" and stage != whole:
        raise ValueError(f"select_blend_stage: {design} runs whole (stage {whole}) only")
    if (stage != whole or design.startswith("kernel_r")) and C != STAGE_C:
        raise ValueError(f"select_blend_stage: stage {stage} of {design} is built for "
                         f"C = {STAGE_C} only, not {C}")
    _card_only("select_blend_stage", vals)
    out, n = _launch_fwd(vals, rects, K, C, "select_blend_stage", "d3ga_fused_fwd_stage",
                         (FWD_DESIGNS[design], stage))
    fwd_stage_launches[design, stage] += n
    return out


def select_blend_bwd_baseline(vals, rects, g, K, C):
    """K9's backward in its design before (`d3ga_fused_bwd_v1`: one
    thread a pixel, coeff_walk.cuh's walk, then the route's design before)
    on CUDA tensors, for timing against `select_blend_bwd`."""
    global baseline_launches
    _card_only("select_blend_bwd_baseline", vals)
    dvals, n = _launch_bwd(vals, rects, g.contiguous(), K, C, "select_blend_bwd_baseline",
                           "d3ga_fused_bwd_v1")
    baseline_launches += n
    return dvals


def select_blend_bwd_stage(vals, rects, g, K, C, stage, design="kernel"):
    """One of BWD_DESIGNS ("kernel": K9's backward; "kernel_no_cull": the
    same with the band cull off, the same bits; "kernel_p1" / "kernel_p4":
    its walk at 1 or 4 pixels a thread) with its per-tile kernel cut after
    `stage` of BWD_STAGES, then the route kernel, on CUDA tensors: d(vals)
    of what the cut computed (stage 4 is the whole backward; a cut before
    it writes one value a thread into the tile's first slot rows, zeroed
    first). Only "kernel" is cut before stage 4; those cuts and the pixel
    variants take C = STAGE_C only."""
    whole = len(BWD_STAGES) - 1
    if stage not in range(len(BWD_STAGES)) or design not in BWD_DESIGNS:
        raise ValueError(f"select_blend_bwd_stage: stage {stage} of design {design!r}")
    if design != "kernel" and stage != whole:
        raise ValueError(f"select_blend_bwd_stage: {design} runs whole (stage {whole}) only")
    if (stage != whole or design.startswith("kernel_p")) and C != STAGE_C:
        raise ValueError(f"select_blend_bwd_stage: stage {stage} of {design} is built for "
                         f"C = {STAGE_C} only, not {C}")
    _card_only("select_blend_bwd_stage", vals)
    dvals, n = _launch_bwd(vals, rects, g.contiguous(), K, C, "select_blend_bwd_stage",
                           "d3ga_fused_bwd_stage", (BWD_DESIGNS[design], stage),
                           zero=stage != whole)
    stage_launches[design, stage] += n
    return dvals


def select_blend_bwd_tiles(vals, rects, g, K, C):
    """The backward's per-tile kernel alone (`d3ga_fused_bwd_tiles`) on
    CUDA tensors: its scratch (drec [NB * 64, K, 6 + C] float32, sel
    [NB * 64, K] int32, live [NB * 64] int32; rows and ids past each
    tile's live count unwritten), the route's inputs."""
    global tiles_launches
    name = "select_blend_bwd_tiles"
    _card_only(name, vals)
    NB, kb = _check(name, vals, rects, K, C)
    dev = vals.device
    g = g.contiguous()
    if (g.dtype != torch.float32 or tuple(g.shape) != (NB, TB, NPIX, C + 1)
            or g.device != dev):
        raise ValueError(f"{name}: cotangent {g.dtype} {tuple(g.shape)} on {g.device}")
    drec = torch.empty((NB * TB, K, 6 + C), dtype=torch.float32, device=dev)
    sel = torch.empty((NB * TB, K), dtype=torch.int32, device=dev)
    live = torch.empty((NB * TB,), dtype=torch.int32, device=dev)
    if NB == 0:
        return drec, sel, live
    err = _kernels().d3ga_fused_bwd_tiles(
        vals.data_ptr(), rects.data_ptr(), g.data_ptr(), NB, kb, K, C, drec.data_ptr(),
        sel.data_ptr(), live.data_ptr(), 0, cuda_build.stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
    tiles_launches += 1
    return drec, sel, live


def route(rects, drec, sel, live, K, C, design="kernel"):
    """K9's route alone (`d3ga_fused_route`), one of ROUTE_DESIGNS, on CUDA
    tensors: d(vals) [NB, kb, 16] from the per-tile kernel's scratch (drec
    [NB * 64, K, 6 + C] float32, sel [NB * 64, K] and live [NB * 64]
    int32, each tile's ids ascending, of lanes whose rects [NB, kb] hold
    it). The designs other than "kernel" and "baseline" take C = STAGE_C
    only. `route_plain` on `scratch_lanes` is its plain version."""
    name = "route"
    if design not in ROUTE_DESIGNS:
        raise ValueError(f"{name}: design {design!r}")
    if design.startswith("kernel_g") and C != STAGE_C:
        raise ValueError(f"{name}: {design} is built for C = {STAGE_C} only, not {C}")
    if not 1 <= C <= MAX_C:
        raise ValueError(f"{name}: C={C} unsupported (1..{MAX_C})")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{name}: K={K} unsupported (1..{MAX_K})")
    _card_only(name, drec)
    if rects.dtype != torch.int32 or rects.ndim != 2:
        raise ValueError(f"{name}: rects must be [NB, kb] int32")
    NB, kb = rects.shape
    want = {"drec": (drec, torch.float32, (NB * TB, K, 6 + C)),
            "sel": (sel, torch.int32, (NB * TB, K)), "live": (live, torch.int32, (NB * TB,))}
    for k, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape or t.device != drec.device:
            raise ValueError(f"{name}: {k} {t.dtype} {tuple(t.shape)} on {t.device}: expected "
                             f"{dt} {shape}")
    if rects.device != drec.device or not all(
            t.is_contiguous() for t in (rects, drec, sel, live)):
        raise ValueError(f"{name}: inputs must be contiguous and on one device")
    dvals = torch.empty((NB, kb, NCH), dtype=torch.float32, device=drec.device)
    if NB == 0:
        return dvals
    err = _kernels().d3ga_fused_route(rects.data_ptr(), NB, kb, K, C, drec.data_ptr(),
                                      sel.data_ptr(), live.data_ptr(), dvals.data_ptr(),
                                      ROUTE_DESIGNS[design], cuda_build.stream_handle(drec.device))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
    route_design_launches[design] += 1
    return dvals


class _FusedSelectBlend(torch.autograd.Function):
    """K9 with the JAX package's custom VJP (the backward recomputes the
    selection); saves the inputs only."""

    @staticmethod
    def forward(ctx, vals, rects, K, C, plain):
        ctx.save_for_backward(vals, rects)
        ctx.meta = (K, C, plain)
        if plain:
            tiles, counts = select_blend_plain(vals, rects, K, C)
        else:
            tiles, counts = _launch(vals, rects, K, C)
        ctx.mark_non_differentiable(counts)
        return tiles, counts

    @staticmethod
    def backward(ctx, g, _g_counts):
        vals, rects = ctx.saved_tensors
        K, C, plain = ctx.meta
        g = g.to(torch.float32).contiguous()
        if plain:
            dvals = select_blend_bwd_plain(vals, rects, g, K, C)
        else:
            dvals = _launch_k9_bwd(vals, rects, g, K, C)
        return dvals, None, None, None, None


def select_blend(vals, rects, K, C, plain=False):
    """K9 on records-major vals [NB, kb, 16] float32 and rects [NB, kb]
    int32: (tiles [NB, 64, 256, C+1] with T_bg last, counts [NB, 64]
    int32), differentiable in vals. CPU tensors, or plain=True, take the
    plain versions forward and backward."""
    dev = _device("select_blend", vals)
    return _FusedSelectBlend.apply(vals.contiguous(), rects.contiguous(), K, C,
                                   plain or dev == "cpu")


def _apply(vals, rects, K, C, plain, layout):
    if _layout(vals) != layout:
        raise ValueError(f"fused_select_blend{'' if layout == 1 else '2'}: vals of shape "
                         f"{tuple(vals.shape)} is not the v{layout} layout")
    return select_blend(_records(vals), rects.reshape(rects.shape[0], -1), K, C, plain)


def fused_select_blend(vals, rects, K, C, plain=False):
    """v1 layout: vals [NB, NC, 16, 128] float32 (kb = NC * 128
    candidates a block, chunked channels-first records), rects
    [NB, NC, 128] int32. Returns (tiles [NB, 64, 256, C+1] with T_bg
    last, counts [NB, 64] int32), differentiable in vals. CPU tensors,
    or plain=True, take the plain versions forward and backward."""
    return _apply(vals, rects, K, C, plain, 1)


def fused_select_blend2(vals, rects, K, C, plain=False):
    """v2 layout: vals [NB, 16, KB] float32 (channels-major records),
    rects [NB, 1, KB] int32; otherwise as `fused_select_blend`."""
    return _apply(vals, rects, K, C, plain, 2)
