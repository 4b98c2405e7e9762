"""Build and load the hand-written CUDA kernels of `mqdet_torch/csrc/`.

The sources are compiled with `nvcc` for `sm_90a` into one shared library
with a plain C interface, at first use, into `mqdet_torch/_build/`. The file
name carries a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads the library already built. Each C entry point takes
device pointers and the CUDA stream as `void*` and returns
`cudaGetLastError()` after its launches; `check()` turns a non-zero code into
an exception.

Nothing here runs at import time: the CPU tests import every module, and a
CPU-only machine has neither `nvcc` nor a card.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libmqdet_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if no library of this hash exists; return its path.
    The compiler's output (ptxas register and shared-memory report included)
    is kept next to it as `<library>.log`."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()],
        capture_output=True, text=True,
    )
    with open(path + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        so = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        so.mqdet_dcn_forward.argtypes = [p] * 6 + [i] * 8 + [p]
        so.mqdet_dcn_forward.restype = i
        so.mqdet_bi_attention_forward.argtypes = [p] * 7 + [i] * 5 + [p]
        so.mqdet_bi_attention_forward.restype = i
        _lib = so
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} after launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
