"""Collective rasterization: Gaussian-parallel geometry, tile-parallel
blend (counterpart of d3ga_tpu/dist/raster_shard.py), on a
`torch.distributed` process group.

Within a "model" group of m ranks, at the production defaults
(shard_select=True, use_pallas=True):

  1. each rank projects its N/m Gaussian shard,
  2. the packed screen-space records are all-gathered over the group
     (the transpose of this gather is the reduce-scatter that routes the
     record gradients back to their Gaussian shards),
  3. sharded selection (`_rasterize_shard_select`): each rank builds
     per-tile front-F lists (with depths) from its OWN shard only, three
     all_to_alls route each tile's m partial lists to the tile's owner,
     and a batched (depth, global index) merge gives the final front-K,
  4. each rank blends only its slice of tiles (K5, `raster/blend_rec.py`,
     at tile offset rank * tiles_per_shard) and the image either stays
     sharded in row bands (banded=True; losses run banded, `banded.py`)
     or is all-gathered (banded=False).

`rasterize_collective` takes this rank's shard; `rasterize_sharded` takes
the full arrays on every rank, pads them to a multiple of m (padding
Gaussians sit behind the camera), shards them, and aggregates the
counters. The selection is integer work: no gradient flows through it.

Not ported: shard_select=False (every rank selects from the full gathered
set) and use_pallas=False (the XLA `_blend_tiles`): `ROUTES_TODO`, ROADMAP.md's queue
1 item "Non-champion raster variants".
"""

import torch
import torch.distributed as dist

from d3ga_tpu_torch.dist import collectives as col
from d3ga_tpu_torch.raster.blend_rec import blend_gather_rec
from d3ga_tpu_torch.raster.camera import Camera
from d3ga_tpu_torch.raster.project import project_gaussians, tile_rect
from d3ga_tpu_torch.raster.tiles import (
    ROUTES_TODO,
    TILE,
    RasterAux,
    _select_per_tile_depthkey,
    visible_cap_drops,
)


def rasterize_collective(
    local_means,
    camera: Camera,
    bg_color,
    group,
    n_shards: int,
    cov3d=None,
    opacities=None,
    colors=None,
    max_per_tile: int = 256,
    dup: int = 2,
    use_pallas: bool = False,
    banded: bool = False,
    shard_select: bool = False,
    front_margin=None,
    plain: bool = False,
):
    """Rasterize from this rank's Gaussian shard; returns (image, aux) with
    tile-LOCAL counters (`aggregate_aux` gives the group's).

    Every rank of `group` (n_shards ranks) calls it with its N/m shard of
    local_means [n, 3], cov3d [n, 6], opacities [n, 1], colors [n, C].
    banded=False returns the full [C, H, W] image, the same on every rank
    (mark it `collectives.replicated` before a backward, as
    `rasterize_sharded` does); banded=True returns this rank's band [C,
    band_h, W] of ceil(nty/m) tile rows (rows past the image zeroed).
    front_margin=None exchanges full front-K lists; an int ships only
    F = ceil(K/m) + margin entries per shard and tile, and
    `aux.merge_overflow` conservatively counts entries that might have
    been missed. plain=True runs the kernels' plain versions whatever the
    device."""
    if not (use_pallas and shard_select):
        raise NotImplementedError(
            f"use_pallas={use_pallas}, shard_select={shard_select}: only use_pallas=True "
            f"with shard_select=True is ported; the rest is {ROUTES_TODO}"
        )
    if n_shards != dist.get_world_size(group):
        raise ValueError(f"n_shards={n_shards} for a group of {dist.get_world_size(group)}")
    H, W = camera.height, camera.width
    n_tiles_x = -(-W // TILE)
    n_tiles_y = -(-H // TILE)
    n_tiles = n_tiles_x * n_tiles_y
    if banded:
        # row-aligned bands so each rank's tiles form whole pixel rows
        tiles_per_shard = -(-n_tiles_y // n_shards) * n_tiles_x
    else:
        tiles_per_shard = -(-n_tiles // n_shards)

    proj = project_gaussians(local_means, camera, cov3d=cov3d, opacities=opacities, colors=colors)
    # the packed records [n, 6 + C], gathered across the Gaussian shards
    records_l = torch.cat([proj.xy, proj.conic, proj.opacity[:, None], proj.color], dim=-1)
    records0 = col.all_gather(records_l, group)
    return _rasterize_shard_select(
        proj, records0, camera, bg_color, group, n_shards, n_tiles_x, n_tiles_y,
        tiles_per_shard, max_per_tile, dup, banded, front_margin, plain,
    )


def _assemble_image(my_tiles, my, group, tiles_per_shard, n_tiles_x, n_tiles_y, H, W, banded):
    """Shard tile blocks [tps, 256, C+1] -> image: the local band [C, bh, W]
    (banded) or the all-gathered full [C, H, W], padding tiles dropped."""
    C = my_tiles.shape[-1] - 1
    if banded:
        rows_per_shard = tiles_per_shard // n_tiles_x
        bh = rows_per_shard * TILE
        band = (
            my_tiles.reshape(rows_per_shard, n_tiles_x, TILE, TILE, C + 1)
            .permute(0, 2, 1, 3, 4)
            .reshape(bh, n_tiles_x * TILE, C + 1)[:, :W]
        )
        # rows outside the image zeroed (padding tiles blend nothing there)
        rows = my * bh + torch.arange(bh, device=band.device)
        band = torch.where((rows < H)[:, None, None], band, 0.0)
        return band[..., :C].permute(2, 0, 1)
    # the padding tiles sit at the end of the shards' run: keep the grid's
    all_tiles = col.all_gather(my_tiles, group)[: n_tiles_x * n_tiles_y]
    img = (
        all_tiles.reshape(n_tiles_y, n_tiles_x, TILE, TILE, C + 1)
        .permute(0, 2, 1, 3, 4)
        .reshape(n_tiles_y * TILE, n_tiles_x * TILE, C + 1)[:H, :W]
    )
    return img[..., :C].permute(2, 0, 1)


def _depth_quantum(x, depth_bits):
    """The local key sort's depth quantum of float32 depths (inf stays
    maximal; depths are positive, so bit 31 is clear)."""
    return x.to(torch.float32).contiguous().view(torch.int32) >> (31 - depth_bits)


def _rasterize_shard_select(
    proj, records0, camera, bg_color, group, n_shards, n_tiles_x, n_tiles_y,
    tiles_per_shard, max_per_tile, dup, banded, front_margin, plain,
):
    """Local front-F per tile from the N/m shard, the exchange of the
    per-tile lists, one batched (depth, global index) merge; records stay
    in original global order and the blend reads them through the merged
    indices (no global sort, no record reorder)."""
    H, W = camera.height, camera.width
    K = max_per_tile
    F = K if front_margin is None else min(K, -(-K // n_shards) + int(front_margin))
    n_tiles = n_tiles_x * n_tiles_y
    n_global = records0.shape[0]
    n_loc = proj.xy.shape[0]
    C0 = records0.shape[1] - 6
    my = dist.get_rank(group)
    dev = records0.device

    # -- local per-tile front-F over all tiles (keys: dup^2 * N/m) ----------
    valid_l = proj.valid & (proj.radius > 0)
    rects_l = tile_rect(proj.xy.detach(), proj.radius, TILE, n_tiles_x, n_tiles_y)
    idx_l, counts_l, drop_l, _ties, dep_l = _select_per_tile_depthkey(
        rects_l, valid_l, proj.depth.detach(), n_tiles_x, n_tiles_y, F, dup=dup,
        plain=plain, return_depth=True,
    )  # [T, F] local ids (-1 pad), [T], [], [], [T, F] depths (inf pad)

    # -- exchange: every tile owner gets all shards' lists --------------------
    t_pad = n_shards * tiles_per_shard - n_tiles
    if t_pad:
        idx_l = torch.nn.functional.pad(idx_l, (0, 0, 0, t_pad), value=-1)
        dep_l = torch.nn.functional.pad(dep_l, (0, 0, 0, t_pad), value=torch.inf)
        counts_l = torch.nn.functional.pad(counts_l, (0, t_pad))
    rows_l = torch.where(idx_l >= 0, idx_l + my * n_loc, n_global).to(torch.int32)
    split = (n_shards, tiles_per_shard, F)
    rows_x = col.all_to_all(rows_l, group).reshape(split)      # [m, tps, F]
    dep_x = col.all_to_all(dep_l, group).reshape(split)
    cnt_x = col.all_to_all(counts_l.to(torch.int32), group).reshape(n_shards, tiles_per_shard)

    # -- merge: one batched (depth, global index) sort ----------------------
    # one int64 key (float32 depth bits << 32 | row): depths are positive
    # or inf, so their bit patterns order as the depths do
    mF = n_shards * F
    dep_m = dep_x.permute(1, 0, 2).reshape(tiles_per_shard, mF)
    rows_m = rows_x.permute(1, 0, 2).reshape(tiles_per_shard, mF)
    key = (dep_m.contiguous().view(torch.int32).to(torch.int64) << 32) | rows_m.to(torch.int64)
    key_s, _ = torch.sort(key, dim=-1, stable=True)
    kk = min(K, mF)
    rows_k = (key_s[:, :kk] & 0xFFFFFFFF).to(torch.int32)
    if kk < K:
        rows_k = torch.nn.functional.pad(rows_k, (0, K - kk), value=n_global)
    counts = cnt_x.sum(0)                                        # [tps] true totals
    eff = torch.clamp(counts, max=K).to(torch.int32)
    live = torch.arange(K, device=dev)[None] < eff[:, None]
    idx = torch.where(live, rows_k, n_global).to(torch.int32).contiguous()

    merge_overflow = torch.tensor(-1, dtype=torch.int32, device=dev)
    if F < K:
        # Could a shard's unsent (F+1)-th entry have made the merged
        # front-K? Conservative trip at the local key sort's depth-quantum
        # granularity: unsent entries are >= the last shipped entry's
        # quantized depth, so compare quanta.
        depth_bits = min(22, 31 - int(n_tiles + 1).bit_length())
        kth_dep = (key_s[:, kk - 1] >> 32).to(torch.int32).view(torch.float32)
        # tiles with fewer than K live entries keep every candidate: any
        # unsent entry belongs in the image (kth quantum = +inf)
        kth_q = torch.where(counts > K, _depth_quantum(kth_dep, depth_bits), 2**30)
        last_q = _depth_quantum(dep_x[:, :, F - 1], depth_bits)  # [m, tps]
        trip = (cnt_x > F) & (last_q <= kth_q[None, :])
        merge_overflow = torch.sum(torch.where(trip, cnt_x - F, 0)).to(torch.int32)

    # -- blend (records in original order; the K axis is depth-ordered) -----
    records_ext = torch.cat([records0, records0.new_zeros(1, records0.shape[1])], 0)
    out = blend_gather_rec(
        records_ext.contiguous(), idx, eff, my * tiles_per_shard, n_tiles_x, C0,
        dup2=dup * dup, plain=plain,
    )  # [tps, 256, C0 + 1]
    bg = torch.as_tensor(bg_color, dtype=out.dtype, device=out.device)
    rgb = out[..., :-1] + out[..., -1:] * bg
    my_tiles = torch.cat([rgb, 1.0 - out[..., -1:]], dim=-1)

    tbg_tiles = 1.0 - my_tiles[..., -1].detach().amin(dim=1)
    drop_l = drop_l.to(torch.int32)
    aux = RasterAux(
        overflow=(torch.sum(torch.clamp(counts - K, min=0)) + drop_l).to(torch.int32),
        max_per_tile=torch.max(counts).to(torch.int32),
        n_contrib=torch.sum(eff).to(torch.int32),
        visible_overflow=(visible_cap_drops(tbg_tiles, counts, K) + drop_l).to(torch.int32),
        merge_overflow=merge_overflow,
    )
    image = _assemble_image(
        my_tiles, my, group, tiles_per_shard, n_tiles_x, n_tiles_y, H, W, banded,
    )
    return image, aux


def aggregate_aux(aux, group):
    """Group-wide counters of `rasterize_collective`'s tile-local
    RasterAux: sums (max for max_per_tile); the -1 sentinel of a counter
    not computed stays -1 (it is the same on every rank)."""
    def agg(x, reduce):
        x = torch.as_tensor(x, dtype=torch.int32, device=aux.overflow.device)
        return torch.where(x < 0, x, reduce(torch.clamp(x, min=0), group))

    return RasterAux(**{
        f: agg(getattr(aux, f), col.pmax if f == "max_per_tile" else col.psum)
        for f in aux._fields
    })


def rasterize_sharded(
    mesh,
    means3d,
    camera: Camera,
    bg_color,
    cov3d=None,
    opacities=None,
    colors=None,
    max_per_tile: int = 256,
    dup: int = 2,
    use_pallas: bool = False,
    shard_select: bool = False,
    front_margin=None,
    plain: bool = False,
):
    """Every rank of the mesh's "model" group calls it with the full
    arrays; each rasterizes its N/m shard collectively and gets the full
    image [C, H, W] (replicated over the group) and the group-wide
    RasterAux. Differentiable in means3d, cov3d, opacities and colors:
    their gradients come back whole on every rank. For eval, benchmarks
    and holding sharded == single-device."""
    group = mesh.model_group
    m = mesh.model
    n = means3d.shape[0]
    pad = (-n) % m

    def padded(x):
        if x is None or pad == 0:
            return x
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], 0)

    means_p = means3d
    if pad:
        # padding Gaussians sit behind the camera -> culled
        behind = camera.camera_center - 100.0 * camera.world_view[2, :3]
        means_p = torch.cat([means3d, behind.to(means3d.dtype).expand(pad, 3)], 0)
    local = {
        k: None if v is None else col.shard(v, group)
        for k, v in dict(
            means=means_p, cov3d=padded(cov3d), opacities=padded(opacities),
            colors=padded(colors),
        ).items()
    }
    img, aux = rasterize_collective(
        local["means"], camera, bg_color, group, m, cov3d=local["cov3d"],
        opacities=local["opacities"], colors=local["colors"], max_per_tile=max_per_tile,
        dup=dup, use_pallas=use_pallas, banded=False, shard_select=shard_select,
        front_margin=front_margin, plain=plain,
    )
    return col.replicated(img, group), aggregate_aux(aux, group)
