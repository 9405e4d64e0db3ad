"""Tile-binned Gaussian-splat rasterizer, champion path (counterpart of
d3ga_tpu/raster/tiles.py restricted to `coarse="dupsort_depth"` with the
channels-transposed gather + blend).

  1. project all N Gaussians densely (`project.py`);
  2. per-tile selection of the front-most K overlapping Gaussians: each
     Gaussian emits up to dup x dup (tile | depth, index) keys, ONE sort
     of an int64 key orders every tile's candidates front to back, a
     searchsorted gives the tile segments, and kernel K1
     (`extract.py`) cuts each tile's front-K window;
  3. kernel K2 (`blend_ct.py`) gathers each tile's records and blends
     them front to back (CUDA alpha >= 1/255 skip, T < 1e-4 stop); its
     backward is kernel K3 (per-slot record cotangents) then the id sort
     and kernel K4 (`segsum.py`, per-Gaussian sums), so the image is
     differentiable in means3d, cov3d, opacities and colors.

Overflow counters make every cap visible (`RasterAux`). Selection
outputs and counters are bit-identical to the JAX package's.
"""

from typing import NamedTuple

import torch

from d3ga_tpu_torch.raster.blend_ct import blend_gather_ct
from d3ga_tpu_torch.raster.camera import Camera
from d3ga_tpu_torch.raster.extract import extract_slices, extract_slices_plain
from d3ga_tpu_torch.raster.project import project_gaussians, tile_rect

TILE = 16
ALPHA_SKIP = 1.0 / 255.0


class RasterAux(NamedTuple):
    overflow: torch.Tensor      # [] Gaussians dropped past the K cap
    max_per_tile: torch.Tensor  # [] max overlap count over tiles
    n_contrib: torch.Tensor     # [] total selected entries
    # per-tile-cap drops in tiles whose max T_bg is above 1/255 (drops in
    # other tiles are provably invisible), plus the span-clamp drops
    visible_overflow: torch.Tensor = -1
    # adjacent same-(tile, depth quantum) live pairs; 0 with depth_exact
    depth_ties: torch.Tensor = -1
    # span-clamp drops alone (the dup-window part of `overflow`)
    clamp_overflow: torch.Tensor = -1
    # sharded selection only; -1 = not computed
    merge_overflow: torch.Tensor = -1


def visible_cap_drops(t_bg_max, counts, K):
    """Per-tile-cap drops that could have been seen: the dropped entries
    are the deepest, so a tile whose max final transmittance is below
    1/255 renders like the uncapped blend. t_bg_max, counts: [T]."""
    dropped = torch.clamp(counts - K, min=0)
    return torch.sum(torch.where(t_bg_max > ALPHA_SKIP, dropped, 0)).to(torch.int32)


def _select_per_tile_depthkey(
    rects, valid, depth, n_tiles_x, n_tiles_y, K, dup=4, depth_exact=False, plain=False,
    return_depth=False,
):
    """Per-tile front-K selection by (tile | depth, index) keys.

    hi = tile << depth_bits | top depth_bits of the f32 depth bit pattern
    (order-preserving for positive depths). With depth_exact the
    remaining low depth bits break ties before the index (exactly the
    f32-depth order); without, same-quantum pairs break by index and are
    counted in `ties`. The JAX package's multi-operand `lax.sort` becomes
    ONE stable `torch.sort` of an int64 key:

      - index tie-break (depth_exact False): (hi << 31) | index;
      - pack_exact (the low depth bits and the index share one int31):
        (hi << 31) | (dlo << rank_bits | index);
      - otherwise (3 keys): (hi << (31 - depth_bits)) | dlo, with the
        entries laid out Gaussian-major so the stable sort breaks equal
        keys by index.

    Inputs are in original Gaussian order. Returns (idx [T, K] int32
    original indices with -1 padding, counts [T] int32, clamp-dropped []
    int32, ties [] int32). plain=True cuts the windows with K1's plain
    version whatever the device.

    return_depth=True also returns the selected entries' depths [T, K]
    float32 (inf past counts), for the sharded merge: where(valid, depth,
    inf) rides the sort as a payload (entry e reads Gaussian e // dup^2)
    and K1 cuts its windows too, a second launch on the float32 stream.
    The depths are detached: the selection is integer work.
    """
    xmin, xmax, ymin, ymax = (r.to(torch.int64) for r in rects)
    dev = xmin.device
    n = xmin.shape[0]
    T = n_tiles_x * n_tiles_y
    depth_bits = min(22, 31 - int(T + 1).bit_length())
    if depth_bits < 8:
        raise ValueError(f"{n_tiles_x}x{n_tiles_y} tiles: grid too large for the depth keys")
    low_bits = 31 - depth_bits

    empty = ~valid | (xmax <= xmin) | (ymax <= ymin)
    xc = torch.minimum(xmax - 1, xmin + (dup - 1))
    yc = torch.minimum(ymax - 1, ymin + (dup - 1))
    clamp_dropped = torch.sum(
        torch.where(
            empty, 0, (xmax - 1 - xc) * (yc - ymin + 1) + (ymax - 1 - yc) * (xmax - xmin)
        )
    ).to(torch.int32)

    d32 = depth.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    dq = (d32 >> low_bits) & ((1 << depth_bits) - 1)
    dlo = d32 & ((1 << low_bits) - 1)
    gidx = torch.arange(n, device=dev)
    sentinel = T << depth_bits
    rank_bits = max(int(n - 1).bit_length(), 1)
    pack_exact = depth_exact and low_bits + rank_bits <= 31

    if depth_exact and not pack_exact:
        shift, lo = low_bits, dlo
    else:
        shift = 31
        lo = (dlo << rank_bits) | gidx if pack_exact else gidx

    keys = []
    for dy in range(dup):
        for dx in range(dup):
            ok = (~empty) & (xmin + dx <= xc) & (ymin + dy <= yc)
            tid = (ymin + dy) * n_tiles_x + (xmin + dx)
            hi = torch.where(ok, (tid << depth_bits) | dq, sentinel)
            keys.append((hi << shift) | lo)
    dup2 = dup * dup
    # Gaussian-major layout: entry e belongs to Gaussian e // dup2
    key_s, perm = torch.sort(torch.stack(keys, 1).reshape(-1), stable=True)
    lo_s = (perm // dup2).to(torch.int32)
    m = key_s.shape[0]

    if depth_exact:
        ties = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        hi_s = key_s >> shift
        ties = torch.sum((hi_s[1:] == hi_s[:-1]) & (hi_s[1:] < sentinel)).to(torch.int32)

    bounds = (torch.arange(T + 1, device=dev) << depth_bits) << shift
    starts = torch.searchsorted(key_s, bounds, right=False).to(torch.int32)
    counts = starts[1:] - starts[:-1]
    kk = min(K, m)
    extract = extract_slices_plain if plain else extract_slices
    seg_starts = starts[:-1].contiguous()
    seg = extract(lo_s, seg_starts, kk)
    live = torch.arange(kk, device=dev)[None] < torch.clamp(counts, max=kk)[:, None]
    out = torch.where(live, seg, -1)
    if K > kk:
        out = torch.nn.functional.pad(out, (0, K - kk), value=-1)
    if not return_depth:
        return out, counts, clamp_dropped, ties
    payload = torch.where(valid, depth.detach().to(torch.float32), torch.inf)[perm // dup2]
    dsel = torch.where(live, extract(payload.contiguous(), seg_starts, kk), torch.inf)
    if K > kk:
        dsel = torch.nn.functional.pad(dsel, (0, K - kk), value=torch.inf)
    return out, counts, clamp_dropped, ties, dsel


class Binned(NamedTuple):
    """The selection's output, as the blend kernel takes it."""

    records_ext: torch.Tensor     # [N+1, 6+C] packed records, zero sentinel row last
    idx: torch.Tensor             # [T, K] int32 record ids front to back, N = empty
    counts: torch.Tensor          # [T] int32 candidates per tile (uncapped)
    clamp_overflow: torch.Tensor  # [] span-clamp drops
    depth_ties: torch.Tensor      # [] same-quantum ties (0 with depth_exact)
    ntx: int
    nty: int


def bin_gaussians(
    means3d, camera: Camera, cov3d, opacities, colors,
    max_per_tile: int = 256, dup: int = 3, depth_exact: bool = True, plain: bool = False,
) -> Binned:
    """Project the Gaussians and select every tile's front-K records (the
    part of `rasterize_tiled` before the blend)."""
    ntx = -(-camera.width // TILE)
    nty = -(-camera.height // TILE)
    proj = project_gaussians(means3d, camera, cov3d=cov3d, opacities=opacities, colors=colors)
    valid = proj.valid & (proj.radius > 0)
    records = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], proj.color], dim=-1)
    # the selection is integer work: no gradient flows through it
    rects = tile_rect(proj.xy.detach(), proj.radius, TILE, ntx, nty)
    ranks, counts, clamp_overflow, depth_ties = _select_per_tile_depthkey(
        rects, valid, proj.depth.detach(), ntx, nty, max_per_tile, dup=dup,
        depth_exact=depth_exact, plain=plain,
    )
    n = records.shape[0]
    return Binned(
        records_ext=torch.cat([records, records.new_zeros(1, records.shape[1])], 0).contiguous(),
        idx=torch.where(ranks >= 0, ranks, n).to(torch.int32).contiguous(),
        counts=counts,
        clamp_overflow=clamp_overflow,
        depth_ties=depth_ties,
        ntx=ntx,
        nty=nty,
    )


def rasterize_tiled(
    means3d,
    camera: Camera,
    bg_color,
    cov3d,
    opacities,
    colors,
    max_per_tile: int = 256,
    coarse: str = "dupsort_depth",
    dup: int = 3,
    depth_exact: bool = True,
    plain: bool = False,
):
    """Render [C, H, W] and RasterAux.

    The JAX package's `rasterize_tiled(..., use_pallas=True,
    coarse="dupsort_depth")`, differentiable in means3d [N, 3], cov3d
    [N, 6] packed, opacities [N, 1] and colors [N, C]; bg_color [C].
    plain=True runs the kernels' plain PyTorch versions, forward and
    backward, whatever the device (a reference to hold the kernels
    against)."""
    if coarse != "dupsort_depth":
        raise NotImplementedError(
            f"coarse={coarse!r}: only 'dupsort_depth' is ported "
            "(ROADMAP.md, queue 1: 'Non-champion raster variants')"
        )
    H, W = camera.height, camera.width
    K = max_per_tile
    C = colors.shape[-1]
    b = bin_gaussians(means3d, camera, cov3d, opacities, colors, K, dup, depth_exact, plain)
    cnt = torch.clamp(b.counts, max=K).contiguous()
    out = blend_gather_ct(
        b.records_ext, b.idx, cnt, b.ntx, b.nty, C, dup2=dup * dup, plain=plain
    )  # [(C+1), nty*16, ntx*16]

    bg = torch.as_tensor(bg_color, dtype=out.dtype, device=out.device)
    image = (out[:C] + out[C:] * bg[:, None, None])[:, :H, :W]
    tbg_tiles = out[C].detach().reshape(b.nty, TILE, b.ntx, TILE).amax(dim=(1, 3)).reshape(-1)
    aux = RasterAux(
        overflow=(torch.sum(torch.clamp(b.counts - K, min=0)) + b.clamp_overflow).to(torch.int32),
        max_per_tile=torch.max(b.counts),
        n_contrib=torch.sum(cnt).to(torch.int32),
        visible_overflow=visible_cap_drops(tbg_tiles, b.counts, K) + b.clamp_overflow,
        depth_ties=b.depth_ties,
        clamp_overflow=b.clamp_overflow,
    )
    return image, aux
