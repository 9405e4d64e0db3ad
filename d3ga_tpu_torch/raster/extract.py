"""K1: per-tile front-K extraction from the sorted selection stream.

Replaces the TPU kernel `d3ga_tpu/raster/pallas_extract.py::extract_slices`
with the hand-written CUDA kernel `csrc/extract.cu`:

    out[t, j] = stream[starts[t] + j] for j < kk, 0 past the end;
    with counts: fill where j >= min(counts[t], kk) (not read).

Any kk is accepted (the TPU kernel needed a multiple of 128). The
`counts`/`fill` option is the caller's epilogue (the selection's live
mask and `where`, which the JAX package runs after `extract_slices`)
folded into the same launch. The kernel writes 16 bytes a thread over a
flat grid of several tiles a block, reads each window as aligned 16-byte
groups shifted into place, and does not read what it fills; its bound is
the bytes it must move, 4 * (live words + 2T + T kk) (see the source's
header). `extract_slices` runs the kernel on CUDA tensors and the plain
PyTorch version on CPU tensors; there is no fallback between the two.

The design before (one block per tile, 4-byte words, no counts) stays in
the source as `d3ga_extract_slices_v1`, reached only by
`extract_slices_baseline`, and `launch_floor` launches an empty kernel on
either design's grid: chip_smoke.py uses both to time the designs in turns
and the floor a launch of that shape costs. Neither is on any path of the
port.
"""

import ctypes
import functools
import struct

import torch
import torch.nn.functional as Fn

from d3ga_tpu_torch.utils import cuda_build

# one per launch of the CUDA kernel (never for the plain version)
launches = 0
# one per launch of the baseline design (chip_smoke.py's comparison only)
baseline_launches = 0


def extract_slices_plain(stream: torch.Tensor, starts: torch.Tensor, kk: int,
                         counts: torch.Tensor = None, fill=0) -> torch.Tensor:
    """Plain PyTorch version: one advanced-indexing gather over the
    zero-padded stream, then, with counts, the live mask and `where`."""
    ar = torch.arange(kk, device=stream.device)
    out = Fn.pad(stream, (0, kk))[starts.long()[:, None] + ar]
    if counts is None:
        return out
    live = ar[None] < torch.clamp(counts, max=kk)[:, None]
    return torch.where(live, out, fill)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("extract")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("d3ga_extract_slices", [p, i, p, p, i, i, ctypes.c_uint, p, p]),
                       ("d3ga_extract_slices_v1", [p, i, p, i, i, p, p]),
                       ("d3ga_extract_floor", [i, i, i, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _fill_bits(fill, dtype) -> int:
    """fill as the 32-bit pattern of `dtype`, as `torch.where` converts it."""
    if dtype == torch.int32:
        if int(fill) != fill or not -(2**31) <= int(fill) < 2**31:
            raise ValueError(f"extract_slices: fill {fill} is no int32")
        return int(fill) & 0xFFFFFFFF
    return struct.unpack("<I", struct.pack("<f", float(fill)))[0]


def _check(stream, starts, kk, counts=None):
    if stream.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"extract_slices: stream must be int32 or float32, got {stream.dtype}")
    if starts.dtype != torch.int32:
        raise TypeError(f"extract_slices: starts must be int32, got {starts.dtype}")
    if stream.ndim != 1 or starts.ndim != 1:
        raise ValueError("extract_slices: stream and starts must be 1-D")
    if starts.device != stream.device:
        raise ValueError("extract_slices: stream and starts on different devices")
    if not (stream.is_contiguous() and starts.is_contiguous()):
        raise ValueError("extract_slices: inputs must be contiguous")
    if not (0 < kk and stream.numel() < 2**31):
        raise ValueError(f"extract_slices: kk={kk}, m={stream.numel()} out of range")
    if counts is not None and (counts.dtype != torch.int32 or counts.shape != starts.shape
                               or not counts.is_contiguous() or counts.device != stream.device):
        raise ValueError("extract_slices: counts must be a contiguous int32 [T] beside starts")


def _launch(stream, starts, kk, counts, fill) -> torch.Tensor:
    global launches
    _check(stream, starts, kk, counts)
    bits = _fill_bits(fill, stream.dtype) if counts is not None else 0
    n_tiles = starts.shape[0]
    out = torch.empty((n_tiles, kk), dtype=stream.dtype, device=stream.device)
    if n_tiles == 0:
        return out
    err = _lib().d3ga_extract_slices(
        stream.data_ptr(), stream.numel(), starts.data_ptr(),
        None if counts is None else counts.data_ptr(), n_tiles, kk, bits, out.data_ptr(),
        cuda_build.stream_handle(stream.device))
    if err != 0:
        raise RuntimeError(f"extract_slices: kernel launch failed (cudaError {err})")
    launches += 1
    return out


def extract_slices(stream: torch.Tensor, starts: torch.Tensor, kk: int,
                   counts: torch.Tensor = None, fill=0) -> torch.Tensor:
    """stream [m] int32/float32, starts [T] int32 (0 <= starts <= m) ->
    [T, kk]: each tile's kk-window of the stream, zeros past m; with
    counts [T] int32, `fill` (converted to the stream's dtype) where
    j >= min(counts[t], kk)."""
    if stream.device.type == "cpu":
        return extract_slices_plain(stream, starts, kk, counts, fill)
    if stream.device.type != "cuda":
        raise ValueError(f"extract_slices: unsupported device {stream.device}")
    return _launch(stream, starts, kk, counts, fill)


def extract_slices_baseline(stream: torch.Tensor, starts: torch.Tensor, kk: int) -> torch.Tensor:
    """The design before (`d3ga_extract_slices_v1`: a block per tile, no
    counts) on CUDA tensors, for timing against `extract_slices`."""
    global baseline_launches
    if stream.device.type != "cuda":
        raise ValueError(f"extract_slices_baseline: CUDA tensors only, got {stream.device}")
    _check(stream, starts, kk)
    out = torch.empty((starts.shape[0], kk), dtype=stream.dtype, device=stream.device)
    err = _lib().d3ga_extract_slices_v1(stream.data_ptr(), stream.numel(), starts.data_ptr(),
                                        starts.shape[0], kk, out.data_ptr(),
                                        cuda_build.stream_handle(stream.device))
    if err != 0:
        raise RuntimeError(f"extract_slices_baseline: kernel launch failed (cudaError {err})")
    baseline_launches += 1
    return out


def launch_floor(n_tiles: int, kk: int, device, baseline: bool = False) -> None:
    """Launch an empty kernel on the grid `extract_slices` (or, with
    baseline, `extract_slices_baseline`) launches for n_tiles x kk."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"launch_floor: a CUDA device only, got {device}")
    err = _lib().d3ga_extract_floor(n_tiles, kk, int(baseline), cuda_build.stream_handle(device))
    if err != 0:
        raise RuntimeError(f"launch_floor: kernel launch failed (cudaError {err})")
