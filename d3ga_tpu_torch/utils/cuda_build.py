"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

Each source is compiled on its own by `nvcc` for sm_90a into a shared
library with a plain C interface, loaded with ctypes: no PyTorch headers,
so a build takes seconds. Libraries go to `build/kernels/` at the root of
the checkout (git-ignored), named by a hash of the source, the shared
headers (`csrc/*.cuh`) and the flags, so a changed source is rebuilt and
an unchanged one is reused. The first call of a kernel builds it;
`build_all` builds every source in parallel.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("extract", "blend_ct", "blend_ct_bwd", "segsum", "blend_rec", "blend_coeffs", "fused",
                  "probes_mxu", "probes_widerow")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    # the source, the shared headers it may include, and the flags
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, final) or None
    when the library is already built."""
    final = lib_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def build_all(names=KERNEL_SOURCES) -> dict:
    """Build every named source in parallel (one nvcc each, all started
    together). Returns {name: compiler log}; raises if any build fails."""
    jobs = {name: _start(name) for name in names}
    logs, failed = {}, []
    for name, job in jobs.items():
        if job is None:
            logs[name] = "(already built)"
            continue
        proc, tmp, final = job
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
        else:
            os.replace(tmp, final)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build_all((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
