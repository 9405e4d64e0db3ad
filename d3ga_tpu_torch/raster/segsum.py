"""K4: per-Gaussian sums of the blend backward's per-slot cotangents.

Replaces the TPU kernel `d3ga_tpu/raster/pallas_segsum.py::combine_sorted`
(`_segsum_body`, the windowed one-hot MXU contraction) with the
hand-written CUDA kernel `csrc/segsum.cu`: one warp per 32 consecutive
Gaussians finds its range of the id-sorted stream by a lane-parallel
32-ary search, reads the range in coalesced chunks with every lane
loading one slot row at a time (all of a chunk's random rows in flight),
sums each Gaussian's run in sorted order from 0.0f, and writes the warp's
rows as coalesced 16-byte stores. The result is deterministic, needs no
atomics and equals the plain version's to the bit. Its bound is the
bytes it must move: the live slots' ids, permutation entries and rows,
and the output (see the source's header).

`combine_from_slots` sorts the ids outside the kernel (one stable
`torch.sort`), as `lax.sort` is outside it in JAX, and the kernel reads
the slot rows through the sort's permutation as `torch.sort` returns it
(int64; JAX sorts the 12 cotangent columns along with the ids instead)
and writes the [n + 1, CR] result whose sentinel row n is zero: one
launch, no conversion of the permutation and no appended row.

`combine_sorted` runs the CUDA kernel on CUDA tensors and the plain
PyTorch version on CPU tensors; there is no fallback between the two.
The design before (one thread per Gaussian, a binary search over all m
ids, int32 perm, n rows) stays in the source as `d3ga_combine_sorted_v1`,
reached only by `combine_sorted_baseline`, which chip_smoke.py times
against the kernel; no path of the port calls it.
"""

import ctypes
import functools

import torch

from d3ga_tpu_torch.utils import cuda_build

# one per launch of the CUDA kernel (never for the plain version)
launches = 0
# one per launch of the baseline design (chip_smoke.py's comparison only)
baseline_launches = 0


def combine_sorted_plain(ids_sorted, g, n, dup2=None, perm=None, rows=None):
    """Plain PyTorch version, summing each run in sorted order as the
    kernel does: occurrence r of every id is added in round r.

    ids_sorted: [m] int32, ascending; entries >= n are sentinels.
    g:          [CR, m'] float32; column perm[j] (j without perm, m' = m)
                belongs to ids_sorted[j].
    perm:       [m] int32 or int64, or None, e.g. the sort's permutation,
                so that the columns are read in place instead of gathered
                first.
    rows:       output rows (>= n; None: n); rows n.. are zero.
    Returns [rows, CR] with row i = the sum of the columns of id i.
    Raises if an id occurs more than dup2 times (the dupsort selection's
    dup^2 bound, which the TPU kernel's windows rely on)."""
    CR, m = g.shape[0], ids_sorted.shape[0]
    ar = torch.arange(n, device=ids_sorted.device, dtype=ids_sorted.dtype)
    start = torch.searchsorted(ids_sorted, ar)
    runs = torch.searchsorted(ids_sorted, ar, right=True) - start
    longest = int(runs.max()) if n else 0
    if dup2 is not None and longest > dup2:
        raise ValueError(f"combine_sorted: an id occurs {longest} times, more than dup2={dup2}")
    acc = g.new_zeros(CR, n)
    for r in range(longest):
        j = torch.clamp(start + r, max=m - 1)
        col = j if perm is None else perm[j]
        acc = acc + torch.where(r < runs, g[:, col], 0.0)
    if rows is None or rows == n:
        return acc.T
    return torch.cat([acc.T, acc.new_zeros(rows - n, CR)], 0)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("segsum")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (("d3ga_combine_sorted", [p, p, i, i, p, ll, ll, i, i, i, p, p]),
                       ("d3ga_combine_sorted_v1", [p, p, i, p, ll, ll, i, i, p, p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _check(ids_sorted, g, n, perm, perm_dtypes):
    if ids_sorted.dtype != torch.int32 or g.dtype != torch.float32:
        raise TypeError("combine_sorted: ids must be int32 and cotangents float32")
    m = ids_sorted.shape[0]
    if ids_sorted.ndim != 1 or g.ndim != 2 or (perm is None and g.shape[1] != m):
        raise ValueError("combine_sorted: expected ids [m] and cotangents [CR, m]")
    if perm is not None and (perm.dtype not in perm_dtypes or perm.shape != ids_sorted.shape
                             or not perm.is_contiguous() or perm.device != g.device):
        names = " or ".join(str(d).split(".")[1] for d in perm_dtypes)
        raise ValueError(f"combine_sorted: perm must be a contiguous {names} [m] beside g")
    if ids_sorted.device != g.device:
        raise ValueError("combine_sorted: inputs on different devices")
    if not ids_sorted.is_contiguous():
        raise ValueError("combine_sorted: ids must be contiguous")
    if m >= 2**31 or n >= 2**31 - 64:
        raise ValueError(f"combine_sorted: m={m}, n={n} out of range")


def _launch(ids_sorted, g, n, perm, rows):
    global launches
    _check(ids_sorted, g, n, perm, (torch.int32, torch.int64))
    rows = n if rows is None else rows
    if not n <= rows < 2**31 - 64:
        raise ValueError(f"combine_sorted: rows={rows} must be at least n={n}")
    CR = g.shape[0]
    out = torch.empty((rows, CR), dtype=torch.float32, device=g.device)
    if rows == 0:
        return out
    err = _lib().d3ga_combine_sorted(
        ids_sorted.data_ptr(), None if perm is None else perm.data_ptr(),
        0 if perm is None else perm.element_size(), ids_sorted.shape[0], g.data_ptr(),
        g.stride(0), g.stride(1), CR, n, rows, out.data_ptr(), cuda_build.stream_handle(g.device))
    if err != 0:
        raise RuntimeError(f"combine_sorted: kernel launch failed (cudaError {err})")
    launches += 1
    return out


def combine_sorted(ids_sorted, g, n, dup2=None, perm=None, rows=None):
    """The contract of `combine_sorted_plain`; the CUDA kernel on CUDA
    tensors (which does not check dup2 and reads g through its strides),
    the plain version on CPU tensors."""
    if g.device.type == "cpu":
        return combine_sorted_plain(ids_sorted, g, n, dup2, perm, rows)
    if g.device.type != "cuda":
        raise ValueError(f"combine_sorted: unsupported device {g.device}")
    return _launch(ids_sorted, g, n, perm, rows)


def combine_sorted_baseline(ids_sorted, g, n, perm=None):
    """The design before (`d3ga_combine_sorted_v1`: a thread per Gaussian,
    int32 perm, [n, CR]) on CUDA tensors, for timing against
    `combine_sorted`."""
    global baseline_launches
    if g.device.type != "cuda":
        raise ValueError(f"combine_sorted_baseline: CUDA tensors only, got {g.device}")
    _check(ids_sorted, g, n, perm, (torch.int32,))
    CR = g.shape[0]
    out = torch.empty((n, CR), dtype=torch.float32, device=g.device)
    err = _lib().d3ga_combine_sorted_v1(
        ids_sorted.data_ptr(), None if perm is None else perm.data_ptr(), ids_sorted.shape[0],
        g.data_ptr(), g.stride(0), g.stride(1), CR, n, out.data_ptr(),
        cuda_build.stream_handle(g.device))
    if err != 0:
        raise RuntimeError(f"combine_sorted_baseline: kernel launch failed (cudaError {err})")
    baseline_launches += 1
    return out


def combine_from_slots(drec, idx, n, dup2=None, plain=False):
    """Per-slot cotangents drec [T, K, CR] + idx [T, K] Gaussian ids (n =
    sentinel) -> [n + 1, CR] per-Gaussian gradient rows (sentinel row
    zero): one stable sort of the ids, then `combine_sorted` (its plain
    version with plain=True) reading the slot rows in place through the
    sort's int64 permutation and writing the sentinel row itself."""
    CR = drec.shape[-1]
    ids_sorted, perm = torch.sort(idx.reshape(-1), stable=True)
    g = drec.reshape(-1, CR).T  # [CR, m], a view in slot order
    combine = combine_sorted_plain if plain else combine_sorted
    return combine(ids_sorted, g, n, dup2, perm, rows=n + 1)
