"""Tile-binned Gaussian-splat rasterizer (counterpart of
d3ga_tpu/raster/tiles.py): every single-device configuration of the JAX
package.

  1. project all N Gaussians densely (`project.py`);
  2. per-tile selection of the front-most K overlapping Gaussians by one
     of four funnels (`coarse`), all integer work, bit-identical with the
     JAX package's:
       - "topk": a stable depth argsort and one row gather of the records
         (`reorder_records`), then `block` x `block`-tile candidate lists
         by masked top-k over the rank-ascending Gaussians (through
         superblocks when `super_factor` > 1), an optional sub-block
         level, and each tile's first K (`_select_per_tile`);
       - "dupsort": the same, with the block lists made by
         duplicate-sort-segment: each Gaussian emits dup x dup (block |
         rank) keys, one sort, searchsorted segments;
       - "dupsort_tile": (tile | rank) keys straight to the tiles;
       - "dupsort_depth": (tile | depth, index) keys and no depth argsort;
         kernel K1 (`extract.py`) cuts each tile's front-K window;
  3. the blend of each tile's records front to back (CUDA alpha >= 1/255
     skip, T < 1e-4 stop):
       - use_pallas=False: `_blend_tiles`, the JAX package's XLA blend in
         plain PyTorch, differentiated by autograd;
       - use_pallas=True, BLEND_LAYOUT "ct": kernel K2 (`blend_ct.py`)
         gathers and blends into the planar image; its backward is kernel
         K3, then the id sort and kernel K4 (`segsum.py`);
       - use_pallas=True, BLEND_LAYOUT "rec": kernel K7
         (`blend_rec.py::blend_gather_img`) into the image layout; its
         backward is K7's, then K4.

`rasterize_tiled_fused` (the `fused` backend) runs the projection, the
depth argsort and the topk funnel's 8x8-tile block lists, then one kernel
for the rest: K9 (`fused.py`) selects each tile's first K candidates from
its block's list and blends them, and its backward routes the
cotangents back to the block's candidates.

Overflow counters make every cap visible (`RasterAux`).
"""

import os
from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from d3ga_tpu_torch.raster.blend_ct import blend_gather_ct
from d3ga_tpu_torch.raster import fused
from d3ga_tpu_torch.raster.blend_rec import blend_gather_img
from d3ga_tpu_torch.raster.camera import Camera
from d3ga_tpu_torch.raster.extract import extract_slices, extract_slices_plain
from d3ga_tpu_torch.raster.project import project_gaussians, tile_rect
from d3ga_tpu_torch.train.losses import full_float32

# The blend layout of use_pallas=True, read once at import as the JAX
# package reads it: "ct" (K2/K3, the planar image) or "rec" (K7, the
# image layout [nty*16, ntx*16, C+1]).
BLEND_LAYOUT = os.environ.get("D3GA_BLEND_LAYOUT", "ct")

TILE = 16
ALPHA_SKIP = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
BIG_RANK = 2**30
COARSE = ("topk", "dupsort", "dupsort_tile", "dupsort_depth")
# The JAX package's TPU-only routes to the same results (its tests hold
# them bit-identical), with the defaults the port implements.
TPU_ROUTES = {"D3GA_REC_GRAD": "segsum", "D3GA_REORDER": "argsort", "D3GA_SELEXT": "pallas"}
ROUTES_TODO = "not ported (ROADMAP.md, queue 1: 'Non-champion raster variants')"


class RasterAux(NamedTuple):
    overflow: torch.Tensor      # [] Gaussians dropped past the K cap
    max_per_tile: torch.Tensor  # [] max overlap count over tiles
    n_contrib: torch.Tensor     # [] total selected entries
    # per-tile-cap drops in tiles whose max T_bg is above 1/255 (drops in
    # other tiles are provably invisible), plus the span-clamp drops
    visible_overflow: torch.Tensor = -1
    # adjacent same-(tile, depth quantum) live pairs; 0 with depth_exact,
    # -1 for the funnels other than dupsort_depth (exact by construction)
    depth_ties: torch.Tensor = -1
    # the selection's own drops: span clamps past the dup window, or the
    # block / sub-block caps of the topk and dupsort funnels
    clamp_overflow: torch.Tensor = -1
    # sharded selection only; -1 = not computed
    merge_overflow: torch.Tensor = -1


def visible_cap_drops(t_bg_max, counts, K):
    """Per-tile-cap drops that could have been seen: the dropped entries
    are the deepest, so a tile whose max final transmittance is below
    1/255 renders like the uncapped blend. t_bg_max, counts: [T]."""
    dropped = torch.clamp(counts - K, min=0)
    return torch.sum(torch.where(t_bg_max > ALPHA_SKIP, dropped, 0)).to(torch.int32)


def check_tpu_routes():
    """Raise for a TPU-only route of the JAX package set in the
    environment to anything but its default."""
    for name, default in TPU_ROUTES.items():
        value = os.environ.get(name, default)
        if value != default:
            raise NotImplementedError(f"{name}={value}: a TPU-only route, {ROUTES_TODO}")


def reorder_records(records, radius, valid, order):
    """Depth-reorder records, radius and valid with one row gather of
    [records | radius | valid] (radius is an integer pixel count, exact
    in float32). Returns (records_s, radius_s as float, valid_s)."""
    nc = records.shape[-1]
    aug = torch.cat(
        [records, radius.to(records.dtype)[:, None], valid.to(records.dtype)[:, None]], -1
    )[order]
    return aug[:, :nc], aug[:, nc], aug[:, nc + 1] > 0


def _first_k(key, k):
    """The k smallest entries of each row, ascending: the JAX package's
    `-lax.top_k(-key, k)[0]`. Values only: every tie is between equal
    sentinels, so the values match bit for bit."""
    return torch.topk(key, k, dim=-1, largest=False, sorted=True).values


def _unpack(packed):
    """(xmin, xmax, ymin, ymax) of rects packed one byte each."""
    return packed & 0xFF, (packed >> 8) & 0xFF, (packed >> 16) & 0xFF, (packed >> 24) & 0xFF


def _refine_lists(parent_ranks, parent_packed, parent_of_child, cx0, cy0, csize, cap):
    """One funnel level: each child region takes the first `cap`
    (rank-ascending) candidates overlapping it from its parent's list.

    parent_ranks / parent_packed: [P, kp] rank-ascending lists (BIG_RANK /
    0 padding) with the packed tile rects alongside; parent_of_child [C];
    cx0, cy0: [C] child origins in tiles; csize: child extent in tiles.
    Returns (child_ranks [C, cap], child_packed [C, cap], child_counts
    [C], overflow [])."""
    kp = parent_ranks.shape[1]
    cand = parent_ranks[parent_of_child]
    cpacked = parent_packed[parent_of_child]
    cxmin, cxmax, cymin, cymax = _unpack(cpacked)
    ov = (
        (cand < BIG_RANK)
        & (cx0[:, None] < cxmax)
        & (cx0[:, None] + csize > cxmin)
        & (cy0[:, None] < cymax)
        & (cy0[:, None] + csize > cymin)
    )
    j = torch.arange(kp, device=cand.device)
    first = _first_k(torch.where(ov, j, kp), min(cap, kp))  # ascending positions
    hit = first < kp
    safe = torch.where(hit, first, 0)
    child_ranks = torch.where(hit, torch.gather(cand, 1, safe), BIG_RANK)
    child_packed = torch.where(hit, torch.gather(cpacked, 1, safe), 0)
    if cap > kp:
        child_ranks = Fn.pad(child_ranks, (0, cap - kp), value=BIG_RANK)
        child_packed = Fn.pad(child_packed, (0, cap - kp))
    counts = ov.sum(-1)
    return child_ranks, child_packed, counts, torch.clamp(counts - cap, min=0).sum()


def _segments(keys, n_seg, rank_bits, kk):
    """Sorted (segment << rank_bits | rank) keys -> (the first kk ranks of
    every segment [n_seg, kk] with BIG_RANK past its count, counts
    [n_seg]): searchsorted on the left of each boundary (the JAX package's
    scan_unrolled), then one strided gather."""
    m = keys.shape[0]
    bounds = torch.arange(n_seg + 1, device=keys.device) << rank_bits
    starts = torch.searchsorted(keys, bounds)
    counts = starts[1:] - starts[:-1]
    j = torch.arange(kk, device=keys.device)
    seg = keys[torch.clamp(starts[:-1, None] + j, max=m - 1)]
    live = j < torch.clamp(counts, max=kk)[:, None]
    return torch.where(live, seg & ((1 << rank_bits) - 1), BIG_RANK), counts


def _dup_keys(lo_x, hi_x, lo_y, hi_y, empty, dup, stride, n_cells, rank_bits):
    """The dup x dup (cell << rank_bits | rank) keys of every Gaussian over
    the cells [lo, hi] (inclusive) of its clamped span, sentinel
    n_cells << rank_bits where a cell is outside it; sorted."""
    n = lo_x.shape[0]
    ranks = torch.arange(n, device=lo_x.device)
    keys = []
    for dy in range(dup):
        for dx in range(dup):
            cx, cy = lo_x + dx, lo_y + dy
            ok = ~empty & (cx <= hi_x) & (cy <= hi_y)
            keys.append(torch.where(ok, ((cy * stride + cx) << rank_bits) | ranks,
                                    n_cells << rank_bits))
    return torch.sort(torch.cat(keys)).values


def _coarse_block_lists_dupsort(rects, valid_sorted, nbx, nby, block, kb, packed, dup=2):
    """Block candidate lists by duplicate-sort-segment: each Gaussian
    emits dup x dup (block | rank) keys over the blocks its rect touches,
    one sort, per-block segments. Spans past `dup` blocks a side are
    clamped and their dropped (block, Gaussian) pairs counted. Returns
    (block_ranks [NB, kb], block_packed [NB, kb], block_counts [NB],
    overflow [])."""
    xmin, xmax, ymin, ymax = rects
    n = xmin.shape[0]
    n_blocks = nbx * nby
    rank_bits = max(int(n - 1).bit_length(), 1)
    if (n_blocks + 1) << rank_bits >= 2**31:
        raise ValueError("dup-sort key would overflow int32; use the top_k coarse path")
    bxmin, bxmax = xmin // block, (xmax - 1) // block  # inclusive; xmax is exclusive
    bymin, bymax = ymin // block, (ymax - 1) // block
    empty = ~valid_sorted | (xmax <= xmin) | (ymax <= ymin)
    bxc = torch.minimum(bxmax, bxmin + (dup - 1))
    byc = torch.minimum(bymax, bymin + (dup - 1))
    clamp_dropped = torch.where(
        empty, 0, (bxmax - bxc) * (byc - bymin + 1) + (bymax - byc) * (bxmax - bxmin + 1)
    ).sum()
    # keys only for blocks inside the grid
    keys = _dup_keys(bxmin, torch.minimum(bxc, torch.full_like(bxc, nbx - 1)), bymin,
                     torch.minimum(byc, torch.full_like(byc, nby - 1)), empty, dup, nbx,
                     n_blocks, rank_bits)
    block_ranks, block_counts = _segments(keys, n_blocks, rank_bits, kb)
    live = block_ranks < BIG_RANK
    block_packed = torch.where(live, packed[torch.where(live, block_ranks, 0)], 0)
    overflow = torch.clamp(block_counts - kb, min=0).sum() + clamp_dropped
    return block_ranks, block_packed, block_counts, overflow


def _select_per_tile_dupsort(rects, valid_sorted, n_tiles_x, n_tiles_y, K, dup=4):
    """Per-tile selection in one duplicate-sort-segment pass (no block
    funnel): each Gaussian emits dup x dup (tile | rank) keys over its
    tile rect, one sort, per-tile segments. Spans past `dup` tiles are
    clamped and counted. Returns (ranks [T, K] BIG_RANK-padded, counts
    [T], clamp-dropped [])."""
    xmin, xmax, ymin, ymax = rects
    n = xmin.shape[0]
    T = n_tiles_x * n_tiles_y
    rank_bits = max(int(n - 1).bit_length(), 1)
    if (T + 1) << rank_bits >= 2**31:
        raise ValueError("tile dup-sort key would overflow int32; use the funnel path")
    empty = ~valid_sorted | (xmax <= xmin) | (ymax <= ymin)
    xc = torch.minimum(xmax - 1, xmin + (dup - 1))
    yc = torch.minimum(ymax - 1, ymin + (dup - 1))
    clamp_dropped = torch.where(
        empty, 0, (xmax - 1 - xc) * (yc - ymin + 1) + (ymax - 1 - yc) * (xmax - xmin)
    ).sum()
    keys = _dup_keys(xmin, xc, ymin, yc, empty, dup, n_tiles_x, T, rank_bits)
    out, counts = _segments(keys, T, rank_bits, min(K, keys.shape[0]))
    if K > out.shape[1]:
        out = Fn.pad(out, (0, K - out.shape[1]), value=BIG_RANK)
    return out, counts, clamp_dropped


def _coarse_block_lists(rects, valid_sorted, ranks, nbx, nby, block, kb, super_factor=2,
                        packed=None):
    """Rank-ascending candidate lists per `block` x `block`-tile block: a
    masked top-k over all N per block (super_factor <= 1), or per
    superblock of super_factor x super_factor blocks first, each block
    then refining its superblock's list. Drops past either cap are
    counted. Returns (block_ranks [NB, kb] with BIG_RANK padding,
    block_packed [NB, kb], block_counts [NB], block_overflow [])."""
    xmin, xmax, ymin, ymax = rects
    n = xmin.shape[0]
    dev = xmin.device
    bids = torch.arange(nbx * nby, device=dev)
    bx0 = (bids % nbx) * block
    by0 = (bids // nbx) * block
    if packed is None:
        packed = xmin | (xmax << 8) | (ymin << 16) | (ymax << 24)

    def lists(x0, y0, size, cap):
        overlap = (
            valid_sorted[None, :]
            & (x0[:, None] < xmax[None, :])
            & (x0[:, None] + size > xmin[None, :])
            & (y0[:, None] < ymax[None, :])
            & (y0[:, None] + size > ymin[None, :])
        )  # [regions, N]
        out = _first_k(torch.where(overlap, ranks[None, :], BIG_RANK), cap)
        live = out < BIG_RANK
        out_packed = torch.where(live, packed[torch.where(live, out, 0)], 0)
        counts = overlap.sum(-1)
        return out, out_packed, counts, torch.clamp(counts - cap, min=0).sum()

    if super_factor <= 1:
        return lists(bx0, by0, block, kb)
    sb = block * super_factor
    nsx = -(-nbx // super_factor)
    nsy = -(-nby // super_factor)
    sids = torch.arange(nsx * nsy, device=dev)
    super_ranks, super_packed, _, super_overflow = lists(
        (sids % nsx) * sb, (sids // nsx) * sb, sb, min(kb * super_factor * super_factor, n)
    )
    super_of_block = (by0 // sb) * nsx + (bx0 // sb)
    block_ranks, block_packed, block_counts, b_overflow = _refine_lists(
        super_ranks, super_packed, super_of_block, bx0, by0, block, kb
    )
    return block_ranks, block_packed, block_counts, super_overflow + b_overflow


def _select_per_tile(
    rects_sorted, valid_sorted, n_tiles_x, n_tiles_y, K, block=8, block_cap=4096,
    sub_block=0, sub_cap=1024, super_factor=1, coarse="topk", dup=2,
):
    """Funnel tile binning, all inputs in depth-rank order: coarse
    `block` x `block`-tile candidate lists (`_coarse_block_lists` for
    "topk", `_coarse_block_lists_dupsort` for "dupsort"), an optional
    sub-block level (`sub_block` tiles a side, cap `sub_cap`), then each
    tile's first K among its (sub-)block's candidates; or, for
    "dupsort_tile", `_select_per_tile_dupsort`. The four tile-rect bounds
    ride the funnel packed into one integer.

    rects_sorted: (xmin, xmax, ymin, ymax) [N] in rank order;
    valid_sorted: [N] bool in rank order. Returns (ranks [T, K] int32 with
    BIG_RANK padding, counts [T] int32, overflow [] int32 — Gaussians
    dropped past any funnel cap or span clamp)."""
    if n_tiles_x >= 256 or n_tiles_y >= 256:
        raise ValueError(
            f"tile grid {n_tiles_x}x{n_tiles_y} exceeds the 255-per-side rect packing limit"
        )
    xmin, xmax, ymin, ymax = rects = tuple(r.to(torch.int64) for r in rects_sorted)
    n = xmin.shape[0]
    dev = xmin.device
    if coarse == "dupsort_tile":
        out, counts, overflow = _select_per_tile_dupsort(
            rects, valid_sorted, n_tiles_x, n_tiles_y, K, dup=dup
        )
        return out.to(torch.int32), counts.to(torch.int32), overflow.to(torch.int32)

    nbx = -(-n_tiles_x // block)
    nby = -(-n_tiles_y // block)
    kb = min(block_cap, n)
    packed = xmin | (xmax << 8) | (ymin << 16) | (ymax << 24)
    if coarse == "dupsort":
        parent_ranks, parent_packed, _, overflow = _coarse_block_lists_dupsort(
            rects, valid_sorted, nbx, nby, block, kb, packed, dup=dup
        )
    else:
        parent_ranks, parent_packed, _, overflow = _coarse_block_lists(
            rects, valid_sorted, torch.arange(n, device=dev), nbx, nby, block, kb,
            super_factor=super_factor, packed=packed,
        )
    pblock, npx = block, nbx
    if sub_block and sub_block < block and sub_cap < kb:
        nsbx = -(-n_tiles_x // sub_block)
        nsby = -(-n_tiles_y // sub_block)
        sbids = torch.arange(nsbx * nsby, device=dev)
        sbx0 = (sbids % nsbx) * sub_block
        sby0 = (sbids // nsbx) * sub_block
        parent_ranks, parent_packed, _, sub_overflow = _refine_lists(
            parent_ranks, parent_packed, (sby0 // block) * nbx + (sbx0 // block), sbx0, sby0,
            sub_block, sub_cap,
        )
        overflow = overflow + sub_overflow
        pblock, npx = sub_block, nsbx

    # fine: each tile's first K among its (sub-)block's candidates
    tile_ids = torch.arange(n_tiles_x * n_tiles_y, device=dev)
    txs, tys = tile_ids % n_tiles_x, tile_ids // n_tiles_x
    block_of_tile = (tys // pblock) * npx + (txs // pblock)
    kb = parent_ranks.shape[1]
    cand = parent_ranks[block_of_tile]
    cxmin, cxmax, cymin, cymax = _unpack(parent_packed[block_of_tile])
    overlap = (
        (cand < BIG_RANK)
        & (txs[:, None] >= cxmin)
        & (txs[:, None] < cxmax)
        & (tys[:, None] >= cymin)
        & (tys[:, None] < cymax)
    )
    j = torch.arange(kb, device=dev)
    first = _first_k(torch.where(overlap, j, kb), min(K, kb))  # ascending positions
    hit = first < kb
    out = torch.where(hit, torch.gather(cand, 1, torch.where(hit, first, 0)), BIG_RANK)
    if K > kb:
        out = Fn.pad(out, (0, K - kb), value=BIG_RANK)
    counts = overlap.sum(1)
    return out.to(torch.int32), counts.to(torch.int32), overflow.to(torch.int32)


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
    # the live mask (j < counts) and its fill in the extraction's launch
    out = extract(lo_s, seg_starts, kk, counts, -1)
    if K > kk:
        out = torch.nn.functional.pad(out, (0, K - kk), value=-1)
    if not return_depth:
        return out, counts, clamp_dropped, ties
    payload = torch.where(valid, depth.detach().to(torch.float32), torch.inf)[perm // dup2]
    dsel = extract(payload.contiguous(), seg_starts, kk, counts, torch.inf)
    if K > kk:
        dsel = torch.nn.functional.pad(dsel, (0, K - kk), value=torch.inf)
    return out, counts, clamp_dropped, ties, dsel


class Binned(NamedTuple):
    """The selection's output, as the blend kernels take it."""

    records_ext: torch.Tensor     # [N+1, 6+C] packed records, zero sentinel row last
    idx: torch.Tensor             # [T, K] int32 record ids front to back, N = empty
    counts: torch.Tensor          # [T] int32 candidates per tile (uncapped)
    clamp_overflow: torch.Tensor  # [] the selection's own drops (RasterAux.clamp_overflow)
    depth_ties: torch.Tensor      # [] same-quantum ties (0 with depth_exact, -1 off dupsort_depth)
    ntx: int
    nty: int


def _bin(proj, ntx, nty, K, coarse, dup, depth_exact, plain, **funnel) -> Binned:
    """Select every tile's front-K records of the projected Gaussians.
    For every funnel but dupsort_depth the records are reordered by depth
    first (the ids then point into that order, and the gradient goes back
    through the reorder's row gather)."""
    valid = proj.valid & (proj.radius > 0)
    records = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], proj.color], dim=-1)
    n = records.shape[0]
    # the selection is integer work: no gradient flows through it
    if coarse == "dupsort_depth":
        rects = tile_rect(proj.xy.detach(), proj.radius, TILE, ntx, nty)
        ranks, counts, overflow, ties = _select_per_tile_depthkey(
            rects, valid, proj.depth.detach(), ntx, nty, K, dup=dup, depth_exact=depth_exact,
            plain=plain,
        )
        live = ranks >= 0
    else:
        order = torch.argsort(torch.where(valid, proj.depth.detach(), torch.inf), stable=True)
        records, radius_s, valid_s = reorder_records(records, proj.radius, valid, order)
        rects = tile_rect(records[:, 0:2].detach(), radius_s, TILE, ntx, nty)
        ranks, counts, overflow = _select_per_tile(
            rects, valid_s, ntx, nty, K, coarse=coarse, dup=dup, **funnel
        )
        live = ranks < BIG_RANK
        ties = torch.full((), -1, dtype=torch.int32, device=counts.device)
    return Binned(
        records_ext=torch.cat([records, records.new_zeros(1, records.shape[1])], 0).contiguous(),
        idx=torch.where(live, ranks, n).to(torch.int32).contiguous(),
        counts=counts,
        clamp_overflow=overflow,
        depth_ties=ties,
        ntx=ntx,
        nty=nty,
    )


def bin_gaussians(
    means3d, camera: Camera, cov3d, opacities, colors,
    max_per_tile: int = 256, dup: int = 3, depth_exact: bool = True, plain: bool = False,
) -> Binned:
    """Project the Gaussians and select every tile's front-K records with
    the dupsort_depth funnel (the part of the champion `rasterize_tiled`
    before the blend)."""
    ntx = -(-camera.width // TILE)
    nty = -(-camera.height // TILE)
    proj = project_gaussians(means3d, camera, cov3d=cov3d, opacities=opacities, colors=colors)
    return _bin(proj, ntx, nty, max_per_tile, "dupsort_depth", dup, depth_exact, plain)


def _pixel_basis(dtype, device):
    """[256, 6] (1, dx, dy, dx^2, dy^2, dx dy) at the tile-local pixel
    offsets, pixel p = dy * 16 + dx."""
    p = torch.arange(TILE * TILE, device=device)
    dx = (p % TILE).to(dtype)
    dy = (p // TILE).to(dtype)
    return torch.stack([torch.ones_like(dx), dx, dy, dx * dx, dy * dy, dx * dy], -1)


def _blend_tiles(xy_t, conic_t, color_t, opac_t, sel_valid, bg_color, tile_origin,
                 blend_chunk=128):
    """The JAX package's XLA blend, in plain PyTorch and differentiated by
    autograd. Inputs are per-tile gathered records: xy_t [T, K, 2],
    conic_t [T, K, 3], color_t [T, K, C], opac_t [T, K], sel_valid [T, K]
    bool, tile_origin [T, 2] (pixel x, y of each tile's corner). Returns
    tiles [T, 256, C+1] with the background composited and alpha = 1 -
    T_bg last.

    Its formula, not the oracle's: the falloff as [256, 6] x [6, K]
    products over a quadratic pixel basis, alpha = min(0.99, opacity *
    exp(power)), and the transmittance as exp of the log1p(-alpha) prefix
    sums, taken as a product with the upper-triangular ones matrix (T <
    1e-4 decisions depend on that rounding). Tiles go `blend_chunk` at a
    time, as the JAX package's lax.map does; autograd keeps about ten
    [blend_chunk, 256, K] float32 intermediates of every chunk. TF32 is
    off for the products."""
    T, K = xy_t.shape[:2]
    dtype, dev = xy_t.dtype, xy_t.device
    basis = _pixel_basis(dtype, dev)
    U_incl = torch.triu(torch.ones((K, K), dtype=dtype, device=dev))
    a_max = torch.tensor(ALPHA_MAX, dtype=dtype, device=dev)
    bg_color = torch.as_tensor(bg_color, dtype=dtype, device=dev)
    out = []
    with full_float32():
        for c0 in range(0, T, blend_chunk):
            sl = slice(c0, c0 + blend_chunk)
            d0 = xy_t[sl] - tile_origin[sl, None, :].to(dtype)
            A, Bc, C2 = conic_t[sl].unbind(-1)
            d0x, d0y = d0.unbind(-1)
            coeffs = torch.stack(
                [
                    -0.5 * (A * d0x * d0x + C2 * d0y * d0y) - Bc * d0x * d0y,
                    A * d0x + Bc * d0y,
                    C2 * d0y + Bc * d0x,
                    -0.5 * A,
                    -0.5 * C2,
                    -Bc,
                ],
                -1,
            )  # [B, K, 6]
            power = torch.einsum("pc,bkc->bpk", basis, coeffs)  # [B, 256, K]
            alpha = torch.minimum(a_max, opac_t[sl, None, :] * torch.exp(power))
            use = sel_valid[sl, None, :] & (power <= 0.0) & (alpha >= ALPHA_SKIP)
            alpha = torch.where(use, alpha, 0.0)
            lg = torch.log1p(-alpha)
            cum_incl = (lg.reshape(-1, K) @ U_incl).reshape(lg.shape)
            # one exp for both transmittances: t_after = t_before (1 - alpha)
            t_before = torch.exp(cum_incl - lg)
            accept = t_before * (1.0 - alpha) >= T_EPS
            w = torch.where(accept, t_before * alpha, 0.0)
            t_bg = torch.exp(torch.sum(torch.where(accept, lg, 0.0), -1))
            rgb = torch.einsum("bpk,bkc->bpc", w, color_t[sl]) + t_bg[..., None] * bg_color
            out.append(torch.cat([rgb, 1.0 - t_bg[..., None]], -1))
    return torch.cat(out, 0)


def rasterize_tiled(
    means3d,
    camera: Camera,
    bg_color,
    cov3d=None,
    scales=None,
    rotations=None,
    opacities=None,
    colors=None,
    shs=None,
    sh_degree: int = 0,
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
    max_per_tile: int = 256,
    block_cap: int = 4096,
    sub_block: int = 0,
    sub_cap: int = 1024,
    super_factor: int = 1,
    coarse: str = "topk",
    dup: int = 2,
    depth_exact: bool = True,
    return_alpha: bool = False,
    use_pallas: bool = False,
    plain: bool = False,
):
    """Render [C, H, W] (and, with return_alpha, alpha [H, W]) and
    RasterAux: the JAX package's `rasterize_tiled`, with its signature
    and defaults, differentiable in every Gaussian input.

    coarse picks the selection funnel and dup, depth_exact, block_cap,
    sub_block, sub_cap, super_factor tune it (module docstring).
    use_pallas=True blends with the hand-written kernels in the
    BLEND_LAYOUT layout, False with `_blend_tiles`. plain=True runs the
    kernels' plain PyTorch versions, forward and backward, whatever the
    device (a reference to hold the kernels against); CPU tensors always
    take them. The JAX package's TPU-only routes (D3GA_REC_GRAD,
    D3GA_REORDER, D3GA_SELEXT) raise when set to other than their
    defaults."""
    if coarse not in COARSE:
        raise ValueError(f"coarse={coarse!r}: expected one of {COARSE}")
    if use_pallas and BLEND_LAYOUT not in ("ct", "rec"):
        raise ValueError(f"D3GA_BLEND_LAYOUT={BLEND_LAYOUT!r}: expected 'ct' or 'rec'")
    check_tpu_routes()
    H, W = camera.height, camera.width
    ntx = -(-W // TILE)
    nty = -(-H // TILE)
    K = max_per_tile
    proj = project_gaussians(
        means3d, camera, cov3d=cov3d, scales=scales, rotations=rotations, opacities=opacities,
        colors=colors, shs=shs, sh_degree=sh_degree, scale_modifier=scale_modifier,
        antialiasing=antialiasing,
    )
    C = proj.color.shape[-1]
    b = _bin(proj, ntx, nty, K, coarse, dup, depth_exact, plain, block_cap=block_cap,
             sub_block=sub_block, sub_cap=sub_cap, super_factor=super_factor)
    cnt = torch.clamp(b.counts, max=K).contiguous()
    bg = torch.as_tensor(bg_color, dtype=b.records_ext.dtype, device=b.records_ext.device)

    if use_pallas:
        # a Gaussian lands in at most dup^2 tiles of the dup-sort funnels;
        # the other funnels do not bound it (the CUDA combine needs no bound)
        dup2 = dup * dup if coarse in ("dupsort_depth", "dupsort_tile") else None
        if BLEND_LAYOUT == "ct":
            out = blend_gather_ct(b.records_ext, b.idx, cnt, ntx, nty, C, dup2=dup2, plain=plain)
            image = (out[:C] + out[C:] * bg[:, None, None])[:, :H, :W]
            alpha_img = 1.0 - out[C, :H, :W]
            t_bg = out[C]
        else:
            out = blend_gather_img(b.records_ext, b.idx, cnt, ntx, nty, C, dup2=dup2, plain=plain)
            rgb = out[..., :C] + out[..., C:] * bg
            img = torch.cat([rgb, 1.0 - out[..., C:]], -1)[:H, :W]
            image = img[..., :C].permute(2, 0, 1)
            alpha_img = img[..., C]
            t_bg = out[..., C]
        tbg_tiles = t_bg.detach().reshape(nty, TILE, ntx, TILE).amax(dim=(1, 3)).reshape(-1)
    else:
        n = b.records_ext.shape[0] - 1
        # dead slots gather the zero sentinel row and are masked. The gather
        # is an embedding lookup for its backward: each record's slots are
        # summed by sorted segments, in parallel and in a fixed order, and
        # the sentinel's long run is skipped (padding_idx); an indexing
        # gather's backward sums that run serially (156 ms at full width)
        rec_t = Fn.embedding(b.idx.long(), b.records_ext, padding_idx=n)  # [T, K, 6+C]
        tids = torch.arange(ntx * nty, device=rec_t.device)
        tile_origin = torch.stack([(tids % ntx) * TILE, (tids // ntx) * TILE], -1)
        tiles = _blend_tiles(
            rec_t[..., 0:2], rec_t[..., 2:5], rec_t[..., 6:], rec_t[..., 5], b.idx < n, bg,
            tile_origin,
        )  # [T, 256, C+1]
        img = (
            tiles.reshape(nty, ntx, TILE, TILE, C + 1)
            .permute(0, 2, 1, 3, 4)
            .reshape(nty * TILE, ntx * TILE, C + 1)[:H, :W]
        )
        image = img[..., :C].permute(2, 0, 1)
        alpha_img = img[..., C]
        # the last channel is alpha = 1 - T_bg
        tbg_tiles = 1.0 - tiles[..., C].detach().amin(dim=1)

    aux = RasterAux(
        overflow=(torch.sum(torch.clamp(b.counts - K, min=0)) + b.clamp_overflow).to(torch.int32),
        max_per_tile=torch.max(b.counts),
        n_contrib=torch.sum(cnt).to(torch.int32),
        visible_overflow=visible_cap_drops(tbg_tiles, b.counts, K) + b.clamp_overflow,
        depth_ties=b.depth_ties,
        clamp_overflow=b.clamp_overflow,
    )
    if return_alpha:
        return image, alpha_img, aux
    return image, aux


def fused_candidates(proj, ntx, nty, block_cap=4096):
    """K9's inputs from the projected Gaussians: the stable depth argsort,
    the reorder and the topk funnel's 8x8-tile block lists (superblocks of
    2x2 blocks, `block_cap` candidates a block, padded to whole 128-lane
    chunks). Returns (vals [NB, kb, 16] records-major: x, y in block-local
    pixels, conic, opacity, colours, zero padding; rects [NB, kb] int32
    block-local packed tile rects, 0 for invalid candidates; the block
    lists' overflow; nbx; nby). Differentiable in the projected records."""
    BLOCK = fused.BLOCK
    if ntx >= 256 or nty >= 256:
        raise ValueError(f"tile grid {ntx}x{nty} exceeds the 255-per-side rect packing limit")
    nbx = -(-ntx // BLOCK)
    nby = -(-nty // BLOCK)
    n_blocks = nbx * nby
    valid = proj.valid & (proj.radius > 0)
    order = torch.argsort(torch.where(valid, proj.depth.detach(), torch.inf), stable=True)
    C = proj.color.shape[-1]
    records = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], proj.color], -1)
    records, radius_s, valid_s = reorder_records(records, proj.radius, valid, order)
    n = records.shape[0]
    kb = min(block_cap, n)
    dev = records.device

    rects = tuple(r.to(torch.int64) for r in tile_rect(records[:, 0:2].detach(), radius_s, TILE,
                                                         ntx, nty))
    block_ranks, _, _, block_overflow = _coarse_block_lists(
        rects, valid_s, torch.arange(n, device=dev), nbx, nby, BLOCK, kb
    )
    # the kernel consumes whole 128-lane chunks
    kb_pad = (-kb) % fused.CHUNK
    if kb_pad:
        block_ranks = Fn.pad(block_ranks, (0, kb_pad), value=BIG_RANK)
        kb += kb_pad
    cand_ok = block_ranks < BIG_RANK
    safe = torch.where(cand_ok, block_ranks, 0)

    # per-block candidate records. Invalid candidates read the zero
    # sentinel row: the gather's backward then sums by sorted segments and
    # skips that run (an indexing gather's backward sums it serially)
    records_ext = torch.cat([records, records.new_zeros(1, records.shape[1])], 0)
    rec_b = Fn.embedding(torch.where(cand_ok, block_ranks, n), records_ext, padding_idx=n)
    bids = torch.arange(n_blocks, device=dev)
    bx0 = (bids % nbx) * BLOCK
    by0 = (bids // nbx) * BLOCK
    block_px = torch.stack([bx0 * TILE, by0 * TILE], -1).to(rec_b.dtype)
    vals = torch.cat(
        [rec_b[..., 0:2] - block_px[:, None, :], rec_b[..., 2 : 6 + C],
         rec_b.new_zeros(n_blocks, kb, fused.NCH - 6 - C)], -1,
    )

    # block-local clamped rects (invalid -> 0 = never overlaps)
    xmin, xmax, ymin, ymax = (r[safe] for r in rects)
    lxmin = torch.clamp(xmin - bx0[:, None], 0, BLOCK)
    lxmax = torch.clamp(xmax - bx0[:, None], 0, BLOCK)
    lymin = torch.clamp(ymin - by0[:, None], 0, BLOCK)
    lymax = torch.clamp(ymax - by0[:, None], 0, BLOCK)
    rects_l = torch.where(
        cand_ok, lxmin | (lxmax << 8) | (lymin << 16) | (lymax << 24), 0
    ).to(torch.int32)
    return vals, rects_l, block_overflow, nbx, nby


def rasterize_tiled_fused(
    means3d,
    camera: Camera,
    bg_color,
    cov3d=None,
    scales=None,
    rotations=None,
    opacities=None,
    colors=None,
    shs=None,
    sh_degree: int = 0,
    max_per_tile: int = 256,
    block_cap: int = 4096,
    return_alpha: bool = False,
    interpret: bool = False,
    variant: int = 2,
    plain: bool = False,
):
    """Render [C, H, W] (and, with return_alpha, alpha [H, W]) and
    RasterAux through the fused select + blend kernel K9: the JAX
    package's `rasterize_tiled_fused`, with its signature and defaults,
    differentiable in every Gaussian input. The projection, the stable
    depth argsort and the topk funnel's block lists (superblocks of 2x2
    blocks, `block_cap` candidates a block) come first; K9 then selects
    each tile's first `max_per_tile` and blends them. Same semantics as
    `rasterize_tiled(coarse="topk", super_factor=2)`.

    variant 1 or 2 picks the JAX kernel's input layout (v1 [NB, NC, 16,
    128], v2 [NB, 16, kb]); both reach the same kernels. `interpret` is
    the JAX kernels' and is ignored. plain=True runs K9's plain versions,
    forward and backward, whatever the device. Only the in-image tiles
    count in overflow, max_per_tile and n_contrib; visible_overflow,
    depth_ties and clamp_overflow are -1, as in the JAX package."""
    if variant not in (1, 2):
        raise ValueError(f"variant={variant!r}: expected 1 or 2")
    BLOCK = fused.BLOCK
    H, W = camera.height, camera.width
    ntx = -(-W // TILE)
    nty = -(-H // TILE)
    proj = project_gaussians(
        means3d, camera, cov3d=cov3d, scales=scales, rotations=rotations, opacities=opacities,
        colors=colors, shs=shs, sh_degree=sh_degree,
    )
    C = proj.color.shape[-1]
    vals, rects_l, block_overflow, nbx, nby = fused_candidates(proj, ntx, nty, block_cap)
    n_blocks, kb = rects_l.shape
    dev = vals.device

    if variant == 2:
        tiles, counts = fused.fused_select_blend2(
            vals.permute(0, 2, 1), rects_l[:, None, :], max_per_tile, C, plain=plain)
    else:
        NC = kb // fused.CHUNK
        tiles, counts = fused.fused_select_blend(
            vals.reshape(n_blocks, NC, fused.CHUNK, fused.NCH).permute(0, 1, 3, 2),
            rects_l.reshape(n_blocks, NC, fused.CHUNK), max_per_tile, C, plain=plain)
    # tiles [NB, 64, 256, C+1]; T_bg in the last channel

    # untile (padded block grid, then crop)
    img = (
        tiles.reshape(nby, nbx, BLOCK, BLOCK, TILE, TILE, C + 1)
        .permute(0, 2, 4, 1, 3, 5, 6)
        .reshape(nby * BLOCK * TILE, nbx * BLOCK * TILE, C + 1)[:H, :W]
    )
    t_bg = img[..., C]
    bg = torch.as_tensor(bg_color, dtype=img.dtype, device=dev)
    image = img[..., :C].permute(2, 0, 1) + t_bg[None] * bg[:, None, None]

    # only tiles inside the image count
    cnt = counts.reshape(nby, nbx, BLOCK, BLOCK)
    tile_in_x = torch.arange(nbx * BLOCK, device=dev) < ntx
    tile_in_y = torch.arange(nby * BLOCK, device=dev) < nty
    inside = tile_in_y.reshape(nby, 1, BLOCK, 1) & tile_in_x.reshape(1, nbx, 1, BLOCK)
    cnt = torch.where(inside, cnt, 0)
    aux = RasterAux(
        overflow=(torch.sum(torch.clamp(cnt - max_per_tile, min=0)) + block_overflow).to(
            torch.int32),
        max_per_tile=torch.max(cnt).to(torch.int32),
        n_contrib=torch.sum(torch.clamp(cnt, max=max_per_tile)).to(torch.int32),
    )
    if return_alpha:
        return image, 1.0 - t_bg, aux
    return image, aux
