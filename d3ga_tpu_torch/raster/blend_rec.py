"""K5 and K7: record gather + front-to-back alpha blend in the record
layouts, forward and backward.

K5, the sharded rasterizer's blend on a flat run of tiles, replaces the
TPU kernels `d3ga_tpu/raster/pallas_blend_rec.py::_run_forward` and
`::_run_backward` (`_forward_body`, `_blend_fwd`, `_backward_body`,
`_blend_bwd`, `_coeffs_from_rec`, `_coeffs_transpose`) as reached from
`pallas_segsum.py::blend_gather_segsum_rec`. K7, the image-layout blend
over the whole tile grid (`rasterize_tiled(use_pallas=True)` under
D3GA_BLEND_LAYOUT=rec), replaces `::_run_forward_img` and
`::_run_backward_img` (`_forward_body_img`, `_backward_body_img`) behind
`blend_image_rec`. Both are hand-written CUDA kernels in `csrc/blend_rec.cu`
(its header gives the bound and the design). The math is K2/K3's
(`blend_ct.py`): the forwards walk a tile with K2's own walk
(`csrc/blend_walk_fwd.cuh`), so that given the same records, ids and
counts their values equal K2's image of the same tiles to the bit, and
write each tile's 16 rows as 16-byte stores; the backwards walk with
K3's (`csrc/blend_walk_bwd.cuh`), so that given the same cotangent
values their drec equals K3's to the bit. What differs is where each
tile sits and the layout:

- K5: the T_loc tiles are tiles `tile_offset .. tile_offset + T_loc - 1`
  of the row-major grid `ntx` tiles wide: tile t has its pixel origin at
  ((off + t) % ntx, (off + t) // ntx) * 16 (`_tile_origin`), so one
  shard's contiguous slice of tiles blends without the rest; the output
  is tile-major [T_loc, 256, C+1], pixel p = dy * 16 + dx, T_bg last, and
  the cotangent comes in the same layout;
- K7: the T = ntx * nty tiles of the grid; the output is the padded image
  [nty*16, ntx*16, C+1] (channels adjacent per pixel, T_bg last) and the
  cotangent comes in the same layout.

The record gather is fused into every kernel as in K2/K3: records_ext
[N+1, CR] with a zero sentinel row, idx [T, K] int32. The backwards
write drec [T, K, CR] (zero for dead slots), which goes straight to the
per-Gaussian combine (K4, `segsum.combine_from_slots`).

`blend_gather_rec` and `blend_gather_img` are each one
`torch.autograd.Function` for both devices: on CUDA tensors the kernel
forward and the kernel backward + K4, on CPU tensors (or with plain=True)
the plain PyTorch versions. There is no fallback between the two. The
TPU kernels' count-adaptive half width (`_khalf`), `TILES_PER_BLOCK` and
`_img_group` (D3GA_TPB, D3GA_IMG_G) are tiling choices, not semantics:
the walk stops at each tile's count, past which every slot holds the
inert sentinel.

The designs before (one thread a pixel, `blend_walk.cuh`'s walks) stay
in the source as `d3ga_blend_gather_rec_v1`, `d3ga_blend_gather_img_v1`,
`d3ga_blend_gather_rec_bwd_v1` and `d3ga_blend_gather_img_bwd_v1`,
reached only by `blend_gather_rec_baseline`, `blend_gather_img_baseline`,
`blend_gather_rec_bwd_baseline` and `blend_gather_img_bwd_baseline`
(CUDA tensors only, with their own counters): chip_smoke.py holds the
kernels to them and times them in turns; no path of the port calls them.
"""

import ctypes
import functools

import torch

from d3ga_tpu_torch.raster import segsum
from d3ga_tpu_torch.raster.blend_ct import (
    MAX_C,
    NPIX,
    TILE,
    _card_only,
    _tile_origins,
    blend_tiles_bwd_plain,
    blend_tiles_plain,
)
from d3ga_tpu_torch.utils import cuda_build

# one per launch of a CUDA kernel (never for the plain versions): K5
# forward and backward, K7 forward and backward
launches = 0
bwd_launches = 0
img_launches = 0
img_bwd_launches = 0
# one per launch of K5's and K7's baseline designs, forward and backward
# (chip_smoke.py's comparisons only)
fwd_baseline_launches = 0
img_fwd_baseline_launches = 0
bwd_baseline_launches = 0
img_bwd_baseline_launches = 0


def blend_gather_rec_plain(records_ext, idx, counts, tile_offset, ntx, C, tile_chunk=256,
                           count_pairs=False):
    """Plain PyTorch version of K5's forward: [T_loc, 256, C+1]; with
    count_pairs=True also the (pixel, record) pairs a front-to-back walk
    visits."""
    origin = _tile_origins(idx.shape[0], ntx, records_ext.device, int(tile_offset))
    out, pairs = blend_tiles_plain(records_ext, idx, counts, origin, C, tile_chunk)
    return (out, pairs) if count_pairs else out


def blend_gather_rec_bwd_plain(records_ext, idx, counts, tile_offset, g, ntx, C,
                               tile_chunk=256):
    """Plain PyTorch version of K5's backward: drec [T_loc, K, CR] for the
    tile-major cotangent g [T_loc, 256, C+1]."""
    origin = _tile_origins(idx.shape[0], ntx, records_ext.device, int(tile_offset))
    return blend_tiles_bwd_plain(records_ext, idx, counts, origin, g, C, tile_chunk)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("blend_rec")
    common = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.d3ga_blend_gather_rec.argtypes = common + [ctypes.c_void_p, ctypes.c_void_p]
    lib.d3ga_blend_gather_rec_v1.argtypes = lib.d3ga_blend_gather_rec.argtypes
    lib.d3ga_blend_gather_rec_bwd.argtypes = common + [ctypes.c_void_p, ctypes.c_void_p,
                                                       ctypes.c_void_p]
    lib.d3ga_blend_gather_rec_bwd_v1.argtypes = lib.d3ga_blend_gather_rec_bwd.argtypes
    img = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.d3ga_blend_gather_img.argtypes = img + [ctypes.c_void_p, ctypes.c_void_p]
    lib.d3ga_blend_gather_img_v1.argtypes = lib.d3ga_blend_gather_img.argtypes
    lib.d3ga_blend_gather_img_bwd.argtypes = img + [ctypes.c_void_p, ctypes.c_void_p,
                                                    ctypes.c_void_p]
    lib.d3ga_blend_gather_img_bwd_v1.argtypes = lib.d3ga_blend_gather_img_bwd.argtypes
    for fn in (lib.d3ga_blend_gather_rec, lib.d3ga_blend_gather_rec_v1,
               lib.d3ga_blend_gather_rec_bwd, lib.d3ga_blend_gather_rec_bwd_v1,
               lib.d3ga_blend_gather_img, lib.d3ga_blend_gather_img_v1,
               lib.d3ga_blend_gather_img_bwd, lib.d3ga_blend_gather_img_bwd_v1):
        fn.restype = ctypes.c_int
    return lib


def _check(name, records_ext, idx, counts, tile_offset, ntx, C):
    if records_ext.dtype != torch.float32:
        raise TypeError(f"{name}: records must be float32, got {records_ext.dtype}")
    if idx.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError(f"{name}: idx and counts must be int32")
    if records_ext.ndim != 2 or idx.ndim != 2 or counts.shape != idx.shape[:1]:
        raise ValueError(f"{name}: expected records [N+1, CR], idx [T, K], counts [T]")
    if not 1 <= C <= MAX_C or records_ext.shape[1] < 6 + C:
        raise ValueError(f"{name}: C={C} with {records_ext.shape[1]} record columns unsupported")
    if ntx < 1 or tile_offset < 0 or tile_offset + idx.shape[0] >= 2**31:
        raise ValueError(f"{name}: ntx={ntx}, tile_offset={tile_offset} out of range")
    if not (idx.device == counts.device == records_ext.device):
        raise ValueError(f"{name}: inputs on different devices")
    if not (records_ext.is_contiguous() and idx.is_contiguous() and counts.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def _launch_fwd(records_ext, idx, counts, tile_offset, ntx, C, name="blend_gather_rec",
                entry="d3ga_blend_gather_rec"):
    """Launch K5's forward (or, by `entry`, its baseline design) into a
    new 16-byte-aligned [T_loc, 256, C+1]: (out, 1 if it launched the
    kernel else 0), the caller adding the latter to its count."""
    _check(name, records_ext, idx, counts, tile_offset, ntx, C)
    n_ext, CR = records_ext.shape
    T, K = idx.shape
    out = torch.empty((T, NPIX, C + 1), dtype=torch.float32, device=records_ext.device)
    if T == 0:
        return out, 0
    err = getattr(_lib(), entry)(
        records_ext.data_ptr(), n_ext, CR, idx.data_ptr(), T, K, counts.data_ptr(),
        int(tile_offset), ntx, C, out.data_ptr(), cuda_build.stream_handle(records_ext.device),
    )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
    return out, 1


def _launch(records_ext, idx, counts, tile_offset, ntx, C):
    global launches
    out, n = _launch_fwd(records_ext, idx, counts, tile_offset, ntx, C)
    launches += n
    return out


def blend_gather_rec_baseline(records_ext, idx, counts, tile_offset, ntx, C):
    """K5's forward design before (`d3ga_blend_gather_rec_v1`: one thread
    a pixel, blend_walk.cuh's walk) on CUDA tensors, for holding and
    timing `blend_gather_rec`'s kernel against it."""
    global fwd_baseline_launches
    _card_only("blend_gather_rec_baseline", records_ext)
    out, n = _launch_fwd(records_ext, idx, counts, tile_offset, ntx, C,
                         "blend_gather_rec_baseline", "d3ga_blend_gather_rec_v1")
    fwd_baseline_launches += n
    return out


def _launch_bwd(records_ext, idx, counts, tile_offset, g, ntx, C,
                name="blend_gather_rec_bwd", entry="d3ga_blend_gather_rec_bwd"):
    """Launch K5's backward (or, by `entry`, its baseline design): (drec,
    1 if it launched the kernel else 0), the caller adding the latter to
    its count."""
    _check(name, records_ext, idx, counts, tile_offset, ntx, C)
    T, K = idx.shape
    if g.dtype != torch.float32 or tuple(g.shape) != (T, NPIX, C + 1):
        raise ValueError(f"{name}: cotangent {g.dtype} {tuple(g.shape)}")
    if g.device != records_ext.device or not g.is_contiguous():
        raise ValueError(f"{name}: cotangent on another device or not contiguous")
    n_ext, CR = records_ext.shape
    drec = torch.empty((T, K, CR), dtype=torch.float32, device=records_ext.device)
    if T == 0:
        return drec, 0
    err = getattr(_lib(), entry)(
        records_ext.data_ptr(), n_ext, CR, idx.data_ptr(), T, K, counts.data_ptr(),
        int(tile_offset), ntx, C, g.data_ptr(), drec.data_ptr(),
        cuda_build.stream_handle(records_ext.device),
    )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
    return drec, 1


def _launch_k5_bwd(records_ext, idx, counts, tile_offset, g, ntx, C):
    global bwd_launches
    drec, n = _launch_bwd(records_ext, idx, counts, tile_offset, g, ntx, C)
    bwd_launches += n
    return drec


def blend_gather_rec_bwd(records_ext, idx, counts, tile_offset, g, ntx, C):
    """K5's backward alone: drec [T_loc, K, CR] for the cotangent g
    [T_loc, 256, C+1]; the CUDA kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if records_ext.device.type == "cpu":
        return blend_gather_rec_bwd_plain(records_ext, idx, counts, tile_offset, g, ntx, C)
    if records_ext.device.type != "cuda":
        raise ValueError(f"blend_gather_rec_bwd: unsupported device {records_ext.device}")
    return _launch_k5_bwd(records_ext, idx, counts, tile_offset, g.contiguous(), ntx, C)


def blend_gather_rec_bwd_baseline(records_ext, idx, counts, tile_offset, g, ntx, C):
    """K5's backward design before (`d3ga_blend_gather_rec_bwd_v1`: one
    thread a pixel, blend_walk.cuh's walk) on CUDA tensors, for timing
    against `blend_gather_rec_bwd`."""
    global bwd_baseline_launches
    _card_only("blend_gather_rec_bwd_baseline", records_ext)
    drec, n = _launch_bwd(records_ext, idx, counts, tile_offset, g.contiguous(), ntx, C,
                          "blend_gather_rec_bwd_baseline", "d3ga_blend_gather_rec_bwd_v1")
    bwd_baseline_launches += n
    return drec


class _BlendGatherRec(torch.autograd.Function):
    """Gather + flat-tiles blend with the JAX package's custom VJP
    (`blend_gather_segsum_rec`): the backward is K5's (per-slot
    cotangents) then the id sort + K4 (per-Gaussian sums), or their plain
    versions. Saves the inputs only."""

    @staticmethod
    def forward(ctx, records_ext, idx, counts, tile_offset, ntx, C, dup2, plain):
        ctx.save_for_backward(records_ext, idx, counts)
        ctx.meta = (tile_offset, ntx, C, dup2, plain)
        if plain:
            return blend_gather_rec_plain(records_ext, idx, counts, tile_offset, ntx, C)
        return _launch(records_ext, idx, counts, tile_offset, ntx, C)

    @staticmethod
    def backward(ctx, g):
        records_ext, idx, counts = ctx.saved_tensors
        tile_offset, ntx, C, dup2, plain = ctx.meta
        g = g.to(torch.float32).contiguous()
        if plain:
            drec = blend_gather_rec_bwd_plain(records_ext, idx, counts, tile_offset, g, ntx, C)
        else:
            drec = _launch_k5_bwd(records_ext, idx, counts, tile_offset, g, ntx, C)
        n = records_ext.shape[0] - 1
        dre = segsum.combine_from_slots(drec, idx, n, dup2, plain=plain)
        return dre, None, None, None, None, None, None, None


def blend_gather_rec(records_ext, idx, counts, tile_offset, ntx, C, dup2=None, plain=False):
    """records_ext [N+1, CR] float32 packed records (x, y, conic a/b/c,
    opacity, C colours; xy in global pixel coordinates) with a zero
    sentinel row; idx [T_loc, K] int32 record ids in front-to-back order
    (N for empty slots); counts [T_loc] int32 live slots per tile (<= K);
    tile_offset the grid index of the first tile. Returns [T_loc, 256,
    C+1] (T_bg last), differentiable in records_ext. dup2 bounds the
    occurrences of one id in idx, checked by the plain combine. CPU
    tensors, or plain=True, take the plain versions forward and
    backward."""
    dev = records_ext.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"blend_gather_rec: unsupported device {records_ext.device}")
    return _BlendGatherRec.apply(
        records_ext, idx, counts, int(tile_offset), ntx, C, dup2, plain or dev == "cpu"
    )


def _image_from_tiles(tiles, ntx, nty):
    """Tile-major [T, 256, C+1] -> the padded image [nty*16, ntx*16, C+1]."""
    c1 = tiles.shape[-1]
    return (tiles.reshape(nty, ntx, TILE, TILE, c1).permute(0, 2, 1, 3, 4)
            .reshape(nty * TILE, ntx * TILE, c1))


def _tiles_from_image(img, ntx, nty):
    """The padded image [nty*16, ntx*16, C+1] -> tile-major [T, 256, C+1]."""
    c1 = img.shape[-1]
    return (img.reshape(nty, TILE, ntx, TILE, c1).permute(0, 2, 1, 3, 4)
            .reshape(ntx * nty, NPIX, c1))


def blend_gather_img_plain(records_ext, idx, counts, ntx, nty, C, tile_chunk=256,
                           count_pairs=False):
    """Plain PyTorch version of K7's forward: the padded image [nty*16,
    ntx*16, C+1] (T_bg last); with count_pairs=True also the (pixel,
    record) pairs a front-to-back walk visits."""
    origin = _tile_origins(idx.shape[0], ntx, records_ext.device)
    out, pairs = blend_tiles_plain(records_ext, idx, counts, origin, C, tile_chunk)
    img = _image_from_tiles(out, ntx, nty)
    return (img, pairs) if count_pairs else img


def blend_gather_img_bwd_plain(records_ext, idx, counts, g, ntx, nty, C, tile_chunk=256):
    """Plain PyTorch version of K7's backward: drec [T, K, CR] for the
    image-layout cotangent g [nty*16, ntx*16, C+1]."""
    origin = _tile_origins(idx.shape[0], ntx, records_ext.device)
    return blend_tiles_bwd_plain(records_ext, idx, counts, origin,
                                 _tiles_from_image(g, ntx, nty), C, tile_chunk)


def _check_img(name, records_ext, idx, counts, ntx, nty, C):
    _check(name, records_ext, idx, counts, 0, ntx, C)
    if nty < 1 or idx.shape[0] != ntx * nty:
        raise ValueError(f"{name}: {idx.shape[0]} tiles for a {ntx}x{nty} grid")


def _launch_img_fwd(records_ext, idx, counts, ntx, nty, C, name="blend_gather_img",
                    entry="d3ga_blend_gather_img"):
    """Launch K7's forward (or, by `entry`, its baseline design) into a
    new 16-byte-aligned padded image; the caller counts the launch."""
    _check_img(name, records_ext, idx, counts, ntx, nty, C)
    n_ext, CR = records_ext.shape
    T, K = idx.shape
    out = torch.empty((nty * TILE, ntx * TILE, C + 1), dtype=torch.float32,
                      device=records_ext.device)
    err = getattr(_lib(), entry)(
        records_ext.data_ptr(), n_ext, CR, idx.data_ptr(), T, K, counts.data_ptr(), ntx, C,
        out.data_ptr(), cuda_build.stream_handle(records_ext.device),
    )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
    return out


def _launch_img(records_ext, idx, counts, ntx, nty, C):
    global img_launches
    out = _launch_img_fwd(records_ext, idx, counts, ntx, nty, C)
    img_launches += 1
    return out


def blend_gather_img_baseline(records_ext, idx, counts, ntx, nty, C):
    """K7's forward design before (`d3ga_blend_gather_img_v1`: one thread
    a pixel, blend_walk.cuh's walk) on CUDA tensors, for holding and
    timing `blend_gather_img`'s kernel against it."""
    global img_fwd_baseline_launches
    _card_only("blend_gather_img_baseline", records_ext)
    out = _launch_img_fwd(records_ext, idx, counts, ntx, nty, C, "blend_gather_img_baseline",
                          "d3ga_blend_gather_img_v1")
    img_fwd_baseline_launches += 1
    return out


def _launch_img_bwd(records_ext, idx, counts, g, ntx, nty, C,
                    name="blend_gather_img_bwd", entry="d3ga_blend_gather_img_bwd"):
    """Launch K7's backward (or, by `entry`, its baseline design); the
    caller counts the launch."""
    _check_img(name, records_ext, idx, counts, ntx, nty, C)
    if g.dtype != torch.float32 or tuple(g.shape) != (nty * TILE, ntx * TILE, C + 1):
        raise ValueError(f"{name}: cotangent {g.dtype} {tuple(g.shape)}")
    if g.device != records_ext.device or not g.is_contiguous():
        raise ValueError(f"{name}: cotangent on another device or not contiguous")
    n_ext, CR = records_ext.shape
    T, K = idx.shape
    drec = torch.empty((T, K, CR), dtype=torch.float32, device=records_ext.device)
    err = getattr(_lib(), entry)(
        records_ext.data_ptr(), n_ext, CR, idx.data_ptr(), T, K, counts.data_ptr(), ntx, C,
        g.data_ptr(), drec.data_ptr(), cuda_build.stream_handle(records_ext.device),
    )
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")
    return drec


def _launch_k7_bwd(records_ext, idx, counts, g, ntx, nty, C):
    global img_bwd_launches
    drec = _launch_img_bwd(records_ext, idx, counts, g, ntx, nty, C)
    img_bwd_launches += 1
    return drec


def blend_gather_img_bwd(records_ext, idx, counts, g, ntx, nty, C):
    """K7's backward alone: drec [T, K, CR] for the image-layout cotangent
    g [nty*16, ntx*16, C+1]; the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if records_ext.device.type == "cpu":
        return blend_gather_img_bwd_plain(records_ext, idx, counts, g, ntx, nty, C)
    if records_ext.device.type != "cuda":
        raise ValueError(f"blend_gather_img_bwd: unsupported device {records_ext.device}")
    return _launch_k7_bwd(records_ext, idx, counts, g.contiguous(), ntx, nty, C)


def blend_gather_img_bwd_baseline(records_ext, idx, counts, g, ntx, nty, C):
    """K7's backward design before (`d3ga_blend_gather_img_bwd_v1`: one
    thread a pixel, blend_walk.cuh's walk) on CUDA tensors, for timing
    against `blend_gather_img_bwd`."""
    global img_bwd_baseline_launches
    _card_only("blend_gather_img_bwd_baseline", records_ext)
    drec = _launch_img_bwd(records_ext, idx, counts, g.contiguous(), ntx, nty, C,
                           "blend_gather_img_bwd_baseline", "d3ga_blend_gather_img_bwd_v1")
    img_bwd_baseline_launches += 1
    return drec


class _BlendGatherImg(torch.autograd.Function):
    """Gather + image-layout blend with the JAX package's custom VJP
    (`blend_image_rec`): the backward is K7's (per-slot cotangents), then
    the id sort + K4 (per-Gaussian sums), as the JAX package's XLA
    scatter-add of the gather sums them; or their plain versions. Saves
    the inputs only."""

    @staticmethod
    def forward(ctx, records_ext, idx, counts, ntx, nty, C, dup2, plain):
        ctx.save_for_backward(records_ext, idx, counts)
        ctx.meta = (ntx, nty, C, dup2, plain)
        if plain:
            return blend_gather_img_plain(records_ext, idx, counts, ntx, nty, C)
        return _launch_img(records_ext, idx, counts, ntx, nty, C)

    @staticmethod
    def backward(ctx, g):
        records_ext, idx, counts = ctx.saved_tensors
        ntx, nty, C, dup2, plain = ctx.meta
        g = g.to(torch.float32).contiguous()
        if plain:
            drec = blend_gather_img_bwd_plain(records_ext, idx, counts, g, ntx, nty, C)
        else:
            drec = _launch_k7_bwd(records_ext, idx, counts, g, ntx, nty, C)
        n = records_ext.shape[0] - 1
        dre = segsum.combine_from_slots(drec, idx, n, dup2, plain=plain)
        return dre, None, None, None, None, None, None, None


def blend_gather_img(records_ext, idx, counts, ntx, nty, C, dup2=None, plain=False):
    """records_ext [N+1, CR] float32 packed records (x, y, conic a/b/c,
    opacity, C colours; xy in global pixel coordinates) with a zero
    sentinel row; idx [T, K] int32 record ids in front-to-back order (N
    for empty slots) for the T = ntx * nty tiles of the row-major grid;
    counts [T] int32 live slots per tile (<= K). Returns the padded image
    [nty*16, ntx*16, C+1] (T_bg last), differentiable in records_ext.
    dup2, when given, bounds the occurrences of one id in idx, checked by
    the plain combine. CPU tensors, or plain=True, take the plain versions
    forward and backward."""
    dev = records_ext.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"blend_gather_img: unsupported device {records_ext.device}")
    return _BlendGatherImg.apply(records_ext, idx, counts, ntx, nty, C, dup2,
                                 plain or dev == "cpu")
