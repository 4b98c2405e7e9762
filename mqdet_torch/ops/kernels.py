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

`plain_versions()` opens the explicit reference route: inside it, every
kernel wrapper given a CUDA tensor runs its kernel's plain PyTorch version on
the card (the same function, the same dispatch rule) instead of launching,
and counts no launch. It exists for checks that hold a whole path against
itself without the kernels (an fp32 training step, the test-time
augmentation); no wrapper takes it on its own.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from contextlib import contextmanager
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_lib: Optional[ctypes.CDLL] = None


def sources():
    """The translation units, one nvcc each."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers():
    """The shared headers the sources include: part of the library's hash."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sources() + headers():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libmqdet_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if no library of this hash exists; return its path.
    One nvcc per source, all started together, then one link. The compilers'
    output (ptxas register and shared-memory report included) is kept next to
    the library as `<library>.log`."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in sources()]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources(), objs)
    ]
    steps = []
    for src, proc in zip(sources(), procs):
        out, _ = proc.communicate()
        steps.append((os.path.basename(src), proc.returncode, out))
    if all(rc == 0 for _, rc, _ in steps):
        tmp = f"{path}.{tag}"
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        steps.append(("link", link.returncode, link.stdout))
    with open(path + ".log", "w") as f:
        f.write("".join(f"== {name} (rc {rc})\n{out}" for name, rc, out in steps))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    bad = [(name, rc, out) for name, rc, out in steps if rc != 0]
    if bad:
        name, rc, out = bad[0]
        raise RuntimeError(f"nvcc failed on {name} ({rc}):\n{out[-4000:]}")
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        so = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        so.mqdet_dcn_forward.argtypes = [p] * 6 + [i] * 9 + [p]
        so.mqdet_dcn_forward.restype = i
        so.mqdet_dcn_band_forward.argtypes = [p] * 6 + [i] * 15 + [p]
        so.mqdet_dcn_band_forward.restype = i
        so.mqdet_bi_attention_forward.argtypes = [p] * 10 + [i] * 6 + [p]
        so.mqdet_bi_attention_forward.restype = i
        so.mqdet_bi_attention_dual_forward.argtypes = [p] * 10 + [i] * 6 + [p]
        so.mqdet_bi_attention_dual_forward.restype = i
        so.mqdet_bi_attention_carry_forward.argtypes = [p] * 13 + [i] * 7 + [p]
        so.mqdet_bi_attention_carry_forward.restype = i
        so.mqdet_ms_deform_attn_forward.argtypes = [p] * 4 + [ctypes.POINTER(i)] * 3 + [i] * 8 + [p]
        so.mqdet_ms_deform_attn_forward.restype = i
        _lib = so
    return _lib


def ptxas_reports(kernel: str) -> list:
    """The build log's ptxas report of every entry function whose mangled
    name contains `kernel` (each instantiation of a template): a list of
    {"registers", "spill_stores", "spill_loads", "stack"} (bytes; registers
    as ptxas allocated them at launch). Raises if the log has no such
    function."""
    import re

    with open(library_path() + ".log") as f:
        lines = f.read().splitlines()
    reports = []
    for i, line in enumerate(lines):
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if not entry or kernel not in entry.group(1):
            continue
        out = {}
        for follow in lines[i + 1:]:
            if "Compiling entry function" in follow:
                break
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                              follow)
            if frame:
                out.update(stack=int(frame.group(1)), spill_stores=int(frame.group(2)),
                           spill_loads=int(frame.group(3)))
            used = re.search(r"Used (\d+) registers", follow)
            if used:
                out["registers"] = int(used.group(1))
        if len(out) == 4:
            reports.append(out)
    if not reports:
        raise RuntimeError(f"no ptxas report of an entry function named like {kernel!r}")
    return reports


def ptxas_report(kernel: str) -> dict:
    """The first of `ptxas_reports(kernel)`."""
    return ptxas_reports(kernel)[0]


def ptxas_notes(code: str = "C75") -> list:
    """The build log's lines that carry a ptxas note of this code prefix
    (C75xx: wgmma serialised, and why)."""
    with open(library_path() + ".log") as f:
        return [line for line in f.read().splitlines() if f"({code}" in line]


_plain_route = False


@contextmanager
def plain_versions():
    """The explicit reference route (module docstring)."""
    global _plain_route
    before, _plain_route = _plain_route, True
    try:
        yield
    finally:
        _plain_route = before


def runs_plain(x) -> bool:
    """Whether a wrapper runs its plain version for `x`: a CPU tensor, or
    any tensor inside `plain_versions()`; raises for a device that has no
    kernel (neither the CPU nor CUDA)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return x.device.type == "cpu" or _plain_route


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a call on these tensors."""
    import torch

    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record a launch: a launcher fills its
    output through ctypes, so the output has no `grad_fn` and a training
    step through it would get no gradient and no error."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{name}: the kernel's output has no gradient; call it through its autograd "
                           "Function or under torch.no_grad()")


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} after launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
