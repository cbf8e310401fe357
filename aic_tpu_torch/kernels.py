"""Build and load the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into a shared library under `_build/`, then loaded
with `ctypes`. The build runs at first use and is keyed by a hash of the
source and the flags, so a fresh checkout builds everything it runs and
a rebuilt source never loads a stale library. A failed build raises with
the compiler's output; nothing falls back.

Every C entry point takes its tensors as device pointers and the launch
stream as `void*`, and returns `cudaGetLastError()` after the launch;
`check_launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: nvcc flags. `-fmad=false` keeps every multiply and add separately
#: rounded, as PyTorch's elementwise ops are, so a kernel and its plain
#: twin agree on the knife-edge comparisons of the DDA.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
#: name → (seconds, ptxas report) of builds made by this process.
BUILD_INFO: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names: str) -> None:
    """Compile the named `csrc/<name>.cu` sources that have no library for
    their current hash yet: one nvcc process per source, all started
    together."""
    jobs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{stdout}\n{stderr}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[name] = (time.perf_counter() - t0, stderr)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load `csrc/<name>.cu`."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build(name)
    lib = ctypes.CDLL(str(_target(name)))
    _LIBS[name] = lib
    return lib


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(t, name: str, dtype, shape, device) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape, layout."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
