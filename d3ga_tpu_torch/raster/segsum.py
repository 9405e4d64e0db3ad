"""K4: per-Gaussian sums of the blend backward's per-slot cotangents.

Replaces the TPU kernel `d3ga_tpu/raster/pallas_segsum.py::combine_sorted`
(`_segsum_body`, the windowed one-hot MXU contraction) with the
hand-written CUDA kernel `csrc/segsum.cu` (see its header for the bound
and the design): one thread per Gaussian finds its run in the id-sorted
stream and sums the run in sorted order, so the result is deterministic
and needs no atomics. `combine_from_slots` sorts the ids outside the
kernel (one stable `torch.sort`), as `lax.sort` is outside it in JAX,
and the kernel reads the slot rows through the sort's permutation (JAX
sorts the 12 cotangent columns along with the ids instead).

`combine_sorted` runs the CUDA kernel on CUDA tensors and the plain
PyTorch version on CPU tensors; there is no fallback between the two.
"""

import ctypes
import functools

import torch

from d3ga_tpu_torch.utils import cuda_build

# one per launch of the CUDA kernel (never for the plain version)
launches = 0


def combine_sorted_plain(ids_sorted, g, n, dup2=None, perm=None):
    """Plain PyTorch version, summing each run in sorted order as the
    kernel does: occurrence r of every id is added in round r.

    ids_sorted: [m] int32, ascending; entries >= n are sentinels.
    g:          [CR, m'] float32; column perm[j] (j without perm, m' = m)
                belongs to ids_sorted[j].
    perm:       [m] int32 or None, e.g. the sort's permutation, so that
                the columns are read in place instead of gathered first.
    Returns [n, CR] with row i = the sum of the columns of id i.
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
    return acc.T


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cuda_build.load("segsum").d3ga_combine_sorted
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(ids_sorted, g, n, perm):
    global launches
    if ids_sorted.dtype != torch.int32 or g.dtype != torch.float32:
        raise TypeError("combine_sorted: ids must be int32 and cotangents float32")
    m = ids_sorted.shape[0]
    if ids_sorted.ndim != 1 or g.ndim != 2 or (perm is None and g.shape[1] != m):
        raise ValueError("combine_sorted: expected ids [m] and cotangents [CR, m]")
    if perm is not None and (perm.dtype != torch.int32 or perm.shape != ids_sorted.shape
                             or not perm.is_contiguous() or perm.device != g.device):
        raise ValueError("combine_sorted: perm must be a contiguous int32 [m] beside g")
    if ids_sorted.device != g.device:
        raise ValueError("combine_sorted: inputs on different devices")
    if not ids_sorted.is_contiguous():
        raise ValueError("combine_sorted: ids must be contiguous")
    CR = g.shape[0]
    if m >= 2**31 or n >= 2**31:
        raise ValueError(f"combine_sorted: m={m}, n={n} out of range")
    out = torch.empty((n, CR), dtype=torch.float32, device=g.device)
    if n == 0:
        return out
    err = _kernel()(ids_sorted.data_ptr(), None if perm is None else perm.data_ptr(), m,
                    g.data_ptr(), g.stride(0), g.stride(1), CR, n, out.data_ptr(),
                    cuda_build.stream_handle(g.device))
    if err != 0:
        raise RuntimeError(f"combine_sorted: kernel launch failed (cudaError {err})")
    launches += 1
    return out


def combine_sorted(ids_sorted, g, n, dup2=None, perm=None):
    """The contract of `combine_sorted_plain`; the CUDA kernel on CUDA
    tensors (which does not check dup2 and reads g through its strides),
    the plain version on CPU tensors."""
    if g.device.type == "cpu":
        return combine_sorted_plain(ids_sorted, g, n, dup2, perm)
    if g.device.type != "cuda":
        raise ValueError(f"combine_sorted: unsupported device {g.device}")
    return _launch(ids_sorted, g, n, perm)


def combine_from_slots(drec, idx, n, dup2=None, plain=False):
    """Per-slot cotangents drec [T, K, CR] + idx [T, K] Gaussian ids (n =
    sentinel) -> [n + 1, CR] per-Gaussian gradient rows (sentinel row
    zero): one stable sort of the ids, then `combine_sorted` (its plain
    version with plain=True) reading the slot rows in place through the
    sort's permutation."""
    CR = drec.shape[-1]
    ids_sorted, perm = torch.sort(idx.reshape(-1), stable=True)
    g = drec.reshape(-1, CR).T  # [CR, m], a view in slot order
    combine = combine_sorted_plain if plain else combine_sorted
    dg = combine(ids_sorted, g, n, dup2, perm.to(torch.int32))
    return torch.cat([dg, dg.new_zeros(1, CR)], 0)
