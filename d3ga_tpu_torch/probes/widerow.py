"""P2: the wide-row probe (counterpart of tools/widerow_probe.py).

Does an operand cost per row or per byte? The same bytes in narrow and
wide rows:

  A  passthrough  records [2688, 256, 16]  (688 K rows of 16 floats), bs 4
  B  passthrough  records [2688, 32, 128]  (86 K rows of 128), bs 4
  C  passthrough  image [1024, 672, 4]     (688 K rows of 4), bs 16
  D  passthrough  image [1024, 2688]       (1 K rows of 2688), bs 16
  E  row gather   688 K x [16] of 135,001 records
  F  row gather   86 K x [128] (runs of 32 consecutive rows)
  G  torch.searchsorted, 2,689 queries in 2.16 M sorted keys
  H  a binary search of the same queries, 23 steps of gathers

`passthrough(x, bs)` is o = x * 1.000001 (`csrc/probes_widerow.cu`): a
flat walk of 16-byte loads on a grid sized to the card (`bs`, the TPU
grid's block of leading entries, is checked and reported, no unit of the
card); its plain version `passthrough_plain` is the same multiply in
PyTorch, and the kernel's output is bit-equal to it. `passthrough_v1` is
the design before (one CUDA block a tile of `bs` leading entries), launched
only by chip_smoke.py's comparisons. E-H are PyTorch ops, as they were XLA
ops in the TPU tool: no kernel of their own.

    python3 -m d3ga_tpu_torch.probes.widerow [--iters 20] [--device cuda]

prints one JSON line (with the card's name and power limit): each case's
ms a call (CUDA events, the mean of `iters` calls), its bytes and bytes
bound, and for A-D the plain version's and one torch.mul's ms, and the
kernel's and torch.mul's ms with the calls queued behind a spin
(`probes.queued_ms`: no host launch cost).
"""

import argparse
import ctypes
import functools
import math
import sys

import numpy as np
import torch

from d3ga_tpu_torch import probes
from d3ga_tpu_torch.utils import cuda_build

SCALE = 1.000001
T, K, CR = 2688, 256, 16
H, W = 1024, 672
N_RECORDS = 135001
M = 4 * 4 * 135000  # sorted keys (and wide-row records x 8)
# (name, shape, bs)
PASS_CASES = (
    ("A pass rec [T,K,16]", (T, K, CR), 4),
    ("B pass rec [T,32,128]", (T, K * CR // 128, 128), 4),
    ("C pass img [H,W,4]", (H, W, 4), 16),
    ("D pass img [H,W*4]", (H, W * 4), 16),
)

# one per launch of the kernel (never for the plain version)
launches = 0
# one per launch of the design before (chip_smoke.py's comparisons only)
v1_launches = 0


def passthrough_plain(x):
    """Plain version of `passthrough`."""
    return x * SCALE


@functools.lru_cache(maxsize=None)
def _kernels():
    lib = cuda_build.load("probes_widerow")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    new, v1 = lib.probes_passthrough, lib.probes_passthrough_v1
    new.argtypes = [p, p, ll, i, p]
    v1.argtypes = [p, p, ll, i, i, p]
    new.restype = v1.restype = ctypes.c_int
    return new, v1


def _check(x, bs, name):
    """The operand as a launch takes it (contiguous), None on the CPU."""
    if x.ndim < 2 or bs < 1 or x.shape[0] % bs:
        raise ValueError(f"{name}: x {tuple(x.shape)} with bs {bs}: expected [L0, ..., W] "
                         "with L0 a multiple of bs")
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be float32 on CUDA or the CPU, not {x.dtype} on "
                         f"{x.device}")
    if x.shape[-1] % 4:
        raise ValueError(f"{name}: row width {x.shape[-1]} is not a multiple of 4")
    return x.contiguous()


def passthrough(x, bs):
    """x * 1.000001 over x [L0, ..., W] float32 (L0 a multiple of the TPU
    block's bs leading entries), a flat walk on a grid sized to the card.
    CPU tensors take `passthrough_plain`."""
    global launches
    xc = _check(x, bs, "passthrough")
    if xc is None:
        return passthrough_plain(x)
    out = torch.empty_like(xc)
    err = _kernels()[0](xc.data_ptr(), out.data_ptr(), xc.numel(), xc.shape[-1],
                        cuda_build.stream_handle(xc.device))
    if err != 0:
        raise RuntimeError(f"passthrough: kernel launch failed (error {err})")
    launches += 1
    return out


def passthrough_v1(x, bs):
    """`passthrough` on the design before: one CUDA block a tile of bs
    leading entries. CUDA tensors only (chip_smoke.py's comparisons)."""
    global v1_launches
    xc = _check(x, bs, "passthrough_v1")
    if xc is None:
        raise ValueError("passthrough_v1: the design before runs on CUDA tensors only")
    out = torch.empty_like(xc)
    width = xc.shape[-1]
    rows = xc.numel() // width
    err = _kernels()[1](xc.data_ptr(), out.data_ptr(), rows, width, bs * (rows // xc.shape[0]),
                        cuda_build.stream_handle(xc.device))
    if err != 0:
        raise RuntimeError(f"passthrough_v1: kernel launch failed (error {err})")
    v1_launches += 1
    return out


def _gather_inputs(device, scale=1, seed=0):
    """E-H's operands, from numpy seeds; scale > 1 divides their sizes."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    n, m, nt = N_RECORDS // scale, M // scale, T // scale
    records = t(rng.normal(size=(n, CR)).astype(np.float32))
    idx = t(rng.integers(0, n, (nt, K)).astype(np.int64))
    rec_sorted = t(rng.normal(size=(m // 8 + 64, 128)).astype(np.float32))
    idxw = t((rng.integers(0, m // 8, (nt, 1)) + np.arange(K * CR // 128)[None, :]).astype(np.int64))
    keys = t(np.sort(rng.integers(0, 2**30, m)).astype(np.int32))
    queries = t((np.arange(nt + 1) * (2**30 // (nt + 1))).astype(np.int32))
    return records, idx, rec_sorted, idxw, keys, queries


def binary_search(keys, q):
    """The first index whose key is >= q (searchsorted, left), by
    ceil(log2 n) + 1 halvings of gathers, as the TPU tool wrote it (its
    extra halving takes a query above every key to n + 1)."""
    n = keys.shape[0]
    lo = torch.zeros_like(q)
    hi = torch.full_like(q, n)
    for _ in range(int(np.ceil(np.log2(n))) + 1):
        mid = (lo + hi) // 2
        go = keys[torch.clamp(mid, max=n - 1)] < q
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    return lo


def bytes_bound_ms(nbytes):
    return nbytes / probes.HBM_BYTES_PER_S * 1e3


def run(device="cuda", iters=20, scale=1):
    """One row a case (the module docstring's A-H). scale > 1 divides the
    leading axes, the record and key counts (a rehearsal on the CPU)."""
    device = torch.device(device)
    rows = []
    gen = torch.Generator().manual_seed(0)
    for name, shape, bs in PASS_CASES:
        shape = (max(shape[0] // scale // bs, 1) * bs,) + shape[1:]
        x = torch.randn(shape, generator=gen).to(device)
        nbytes = 2 * 4 * x.numel()
        rows.append({
            "case": name, "shape": list(shape), "bs": bs, "bytes": nbytes,
            "ms": probes.time_ms(lambda: passthrough(x, bs), iters, device),
            "plain_ms": probes.time_ms(lambda: passthrough_plain(x), iters, device),
            "library_ms": probes.time_ms(lambda: torch.mul(x, SCALE), iters, device),
            # the same calls queued behind a spin: device time without the
            # host's launch cost, which back-to-back calls of C and D expose
            "queued_ms": probes.queued_ms(lambda: passthrough(x, bs), iters, device),
            "library_queued_ms": probes.queued_ms(lambda: torch.mul(x, SCALE), iters, device),
            "bound_ms": bytes_bound_ms(nbytes),
        })
        del x
    records, idx, rec_sorted, idxw, keys, queries = _gather_inputs(device, scale)
    steps = int(np.ceil(np.log2(keys.shape[0]))) + 1
    ops = (
        # (name, call, bytes it must move)
        ("E gather 688k x [16] rows", lambda: records[idx].sum(),
         idx.numel() * (CR * 4 + 8)),
        ("F gather 86k x [128] rows (runs of 32)", lambda: rec_sorted[idxw].sum(),
         idxw.numel() * (128 * 4 + 8)),
        ("G searchsorted 2689/2.16M", lambda: torch.searchsorted(keys, queries).sum(),
         queries.numel() * (4 + 8 + 4 * math.ceil(math.log2(keys.shape[0])))),
        (f"H binary search 2689/2.16M ({steps} steps)", lambda: binary_search(keys, queries).sum(),
         queries.numel() * (4 + 4 + 4 * steps)),
    )
    for name, fn, nbytes in ops:
        rows.append({"case": name, "bytes": nbytes, "ms": probes.time_ms(fn, iters, device),
                     "bound_ms": bytes_bound_ms(nbytes)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = probes.cli_device(args.device)
    probes.emit("widerow", device, run(device, args.iters))
    return 0


if __name__ == "__main__":
    sys.exit(main())
