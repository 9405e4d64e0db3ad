"""P3: K9's forward cut at four stages, and its backward's two kernels
timed apart (counterpart of tools/fused_bisect.py).

The TPU tool cut K9 v1's body (attic/pallas_fused.py) into four kernels to
find the stage a compiler refused. Here the cut is the CUT parameter of
`csrc/fused.cu::fused_fwd_kernel`, K9's forward (`d3ga_fused_p3`), so each
stage runs the kernel's own code and stops, writing through its 16-byte
row stores:

  0  writes only: 1.0 to every output
  1  mask + positions: the selection, the tile's count to every pixel
  2  compaction: the selection, the staging of the first min(count, K)
     selected candidates' records and the sum of their channels [0, C]
     (in a fixed order), plus the count
  3  blend: K9's forward tiles (`d3ga_fused` itself)

The deltas between the stages' times split the kernel. The same four cuts
of K9's forward design before (`fused_kernel_v1<C, STAGE>`, one thread a
pixel, `d3ga_fused_stage`) stay as P3's baseline, `stage_v1`, on CUDA
tensors only. K9's backward is two launches (`fused_bwd_kernel` per tile,
`fused_route_kernel` per block and lane); `backward_split` times each
alone (`fused.select_blend_bwd_tiles`, `fused.route`) and the whole call,
by CUDA events around calls queued behind a spin (`probes.queued_ms`).

`stage(vals, rects, K, C, s)` takes K9's records-major inputs (vals
[NB, kb, 16] float32, rects [NB, kb] int32) and returns [NB, 64, 256,
C+1]; CPU tensors take `stage_plain` (from `raster/fused.py`'s `_select`
and `select_blend_plain`).

    python3 -m d3ga_tpu_torch.probes.fused_bisect [--iters 20] [--device cuda]

prints one JSON line (with the card's name and power limit): the stages'
device ms a call, their deltas and bounds, and the backward's two
kernels, on `make_inputs` at K9's full-width shape (48 blocks x 4,096
candidates, K 256, C 6).
"""

import argparse
import sys

import numpy as np
import torch

from d3ga_tpu_torch import probes
from d3ga_tpu_torch.raster import fused
from d3ga_tpu_torch.utils import cuda_build

STAGES = ("writes only", "mask + positions", "compaction", "blend")
BWD_KERNELS = ("fused_bwd_kernel", "fused_route_kernel")
# the TPU tool's stage kernels (tools/fused_bisect.py)
REPLACES = ("tools/fused_bisect.py:50", "tools/fused_bisect.py:59", "tools/fused_bisect.py:80",
            "tools/fused_bisect.py:104")

# one per launch of a stage (never for the plain versions), and of a
# stage of the design before
launches = {s: 0 for s in range(len(STAGES))}
v1_launches = {s: 0 for s in range(len(STAGES))}


def make_inputs(NB, NC, C, seed=0):
    """tools/fused_probe.py::make_inputs (the same draws), records-major:
    (vals [NB, kb, 16] float32, rects [NB, kb] int32) numpy, kb = NC * 128."""
    rng = np.random.default_rng(seed)
    kb = NC * fused.CHUNK
    x = rng.uniform(0, 128, size=(NB, kb)).astype(np.float32)
    y = rng.uniform(0, 128, size=(NB, kb)).astype(np.float32)
    A = rng.uniform(0.02, 0.3, size=(NB, kb)).astype(np.float32)
    B = rng.uniform(-0.01, 0.01, size=(NB, kb)).astype(np.float32)
    Cc = rng.uniform(0.02, 0.3, size=(NB, kb)).astype(np.float32)
    op = rng.uniform(0.3, 0.95, size=(NB, kb)).astype(np.float32)
    cols = rng.uniform(size=(NB, kb, C)).astype(np.float32)
    vals = np.concatenate([np.stack([x, y, A, B, Cc, op], -1), cols,
                           np.zeros((NB, kb, fused.NCH - 6 - C), np.float32)], -1)
    # ~2x2-tile footprints
    xm, ym = (x // 16).astype(np.int32), (y // 16).astype(np.int32)
    rects = xm | (np.minimum(xm + 2, 8) << 8) | (ym << 16) | (np.minimum(ym + 2, 8) << 24)
    return vals, rects.astype(np.int32)


def stage_plain(vals, rects, K, C, s):
    """Plain version of `stage` s."""
    NB, kb, _ = vals.shape
    shape = (NB, fused.TB, fused.NPIX, C + 1)
    if s == 0:
        return vals.new_ones(shape)
    if s == 3:
        return fused.select_blend_plain(vals, rects, K, C)[0]
    lanes, counts = fused._select(rects, K)
    per_tile = counts.to(torch.float32)[..., None].expand(NB, fused.TB, C + 1)
    if s == 2:
        hit = lanes < kb
        idx = torch.where(hit, lanes, 0).reshape(NB, -1, 1).expand(-1, -1, C + 1)
        slot = torch.gather(vals[..., : C + 1], 1, idx).reshape(NB, fused.TB, -1, C + 1)
        per_tile = torch.where(hit[..., None], slot, 0.0).sum(2) + per_tile
    elif s != 1:
        raise ValueError(f"stage {s}: one of 0-3")
    return per_tile[:, :, None, :].expand(shape).contiguous()


def _launch_stage(vals, rects, K, C, s, entry):
    """Launches stage s through `entry` of csrc/fused.cu ("d3ga_fused_p3"
    the kernel's cuts, "d3ga_fused_stage" the design before's): (out, 1 if
    it launched else 0)."""
    if s not in launches:
        raise ValueError(f"stage {s}: one of 0-3")
    NB, kb = fused._check("stage", vals, rects, K, C)
    out = torch.empty((NB, fused.TB, fused.NPIX, C + 1), dtype=torch.float32, device=vals.device)
    counts = torch.empty((NB, fused.TB), dtype=torch.int32, device=vals.device)
    if NB == 0:
        return out, 0
    err = getattr(fused._kernels(), entry)(vals.data_ptr(), rects.data_ptr(), NB, kb, K, C, s,
                                           out.data_ptr(), counts.data_ptr(),
                                           cuda_build.stream_handle(vals.device))
    if err != 0:
        raise RuntimeError(f"stage {s}: kernel launch failed (error {err})")
    return out, 1


def _launch(vals, rects, K, C, s):
    out, n = _launch_stage(vals, rects, K, C, s, "d3ga_fused_p3")
    launches[s] += n
    return out


def stage(vals, rects, K, C, s):
    """K9's forward cut after stage s (module docstring): [NB, 64, 256, C+1].
    CPU tensors take `stage_plain`."""
    if s not in launches:
        raise ValueError(f"stage {s}: one of 0-3")
    fused._check("stage", vals, rects, K, C)
    if vals.device.type == "cpu":
        return stage_plain(vals, rects, K, C, s)
    if vals.device.type != "cuda":
        raise ValueError(f"stage: unsupported device {vals.device}")
    return _launch(vals, rects, K, C, s)


def stage_v1(vals, rects, K, C, s):
    """Stage s of K9's forward design before (`fused_kernel_v1`, the
    baseline P3's cuts are timed against), on CUDA tensors only."""
    fused._card_only("stage_v1", vals)
    out, n = _launch_stage(vals, rects, K, C, s, "d3ga_fused_stage")
    v1_launches[s] += n
    return out


def backward_split(vals, rects, g, K, C, iters=10):
    """Device ms a call of K9's backward (`fused.select_blend_bwd`, "total")
    and of its two kernels alone (BWD_KERNELS: the per-tile kernel by
    `fused.select_blend_bwd_tiles`, the route by `fused.route` on that
    kernel's scratch), each by `probes.queued_ms` (no profiler; None where
    the launches did not queue behind the spin). None off the card."""
    if vals.device.type != "cuda":
        return None
    scratch = fused.select_blend_bwd_tiles(vals, rects, g, K, C)
    fns = {"total": lambda: fused.select_blend_bwd(vals, rects, g, K, C),
           BWD_KERNELS[0]: lambda: fused.select_blend_bwd_tiles(vals, rects, g, K, C),
           BWD_KERNELS[1]: lambda: fused.route(rects, *scratch, K, C)}
    out = {k: probes.queued_ms(fn, iters, vals.device) for k, fn in fns.items()}
    out["clock"] = "device (queued CUDA events)"
    return out


def bounds(vals, rects, K, C, pairs):
    """[(bound ms, "bytes" or "operations")] of each stage on these inputs:
    every stage writes its [NB, 64, 256, C+1] output; 1-3 read every rect
    once; 2 the first C+1 channels of the candidates some tile selects, 3
    their 6 + C used channels, the counts out and the walk's `pairs`
    (pixel, slot) pairs (`probes.coeff_fwd_ops` and one exp a pair)."""
    NB, kb, _ = vals.shape
    lanes, _ = fused._select(rects, K)
    n_sel = int(torch.zeros(NB, kb + 1, dtype=torch.bool, device=vals.device)
                .scatter_(1, lanes.reshape(NB, -1), True)[:, :kb].sum())
    out = 4 * NB * fused.TB * fused.NPIX * (C + 1)
    nbytes = (out, out + 4 * rects.numel(), out + 4 * (rects.numel() + n_sel * (C + 1)),
              out + 4 * (rects.numel() + n_sel * (6 + C) + NB * fused.TB))
    b = [probes.bound(n, 0, 0, 0) for n in nbytes[:3]]
    return b + [probes.bound(nbytes[3], pairs, probes.coeff_fwd_ops(C), 1)]


def run(vals, rects, K, C, iters=20, g=None):
    """Rows on these inputs: each stage's ms a call (`probes.queued_ms`:
    device time on the card, the host clock on the CPU: "clock"), the delta
    from the stage before, its bound; then K9's backward and its kernels
    apart (`backward_split`) for the cotangent g (seeded normal where
    None). Returns (rows, the walk's pixel-slot pairs)."""
    device = vals.device
    _, _, pairs = fused.select_blend_plain(vals, rects, K, C, count_pairs=True)
    rows, prev = [], 0.0
    clock = "device (queued CUDA events)" if device.type == "cuda" else "host"
    for s, (b_ms, by) in enumerate(bounds(vals, rects, K, C, pairs)):
        ms = probes.queued_ms(lambda: stage(vals, rects, K, C, s), iters, device)
        rows.append({"stage": s, "name": STAGES[s], "ms": ms, "clock": clock,
                     "delta_ms": None if ms is None or prev is None else ms - prev,
                     "bound_ms": b_ms, "bound_by": by})
        prev = ms
    if g is None:
        g = torch.randn((vals.shape[0], fused.TB, fused.NPIX, C + 1),
                        generator=torch.Generator().manual_seed(1)).to(device)
    rows.append({"stage": "backward", "device_ms": backward_split(vals, rects, g, K, C, iters)})
    return rows, pairs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--blocks", type=int, default=48)
    ap.add_argument("--chunks", type=int, default=32, help="kb = 128 x chunks candidates a block")
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--c", type=int, default=6)
    args = ap.parse_args(argv)
    device = probes.cli_device(args.device)
    vals, rects = (torch.from_numpy(a).to(device)
                   for a in make_inputs(args.blocks, args.chunks, args.c))
    rows, pairs = run(vals, rects, args.k, args.c, args.iters)
    probes.emit("fused_bisect", device, [dict(r, blocks=args.blocks, kb=vals.shape[1], K=args.k,
                                              C=args.c, pairs=pairs) for r in rows])
    return 0


if __name__ == "__main__":
    sys.exit(main())
