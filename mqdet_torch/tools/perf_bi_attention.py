"""Where the flat bi-attention kernel (K3, K3b) spends its time, on one
NVIDIA GPU.

    python -m mqdet_torch.tools.perf_bi_attention

Times `flash_bi_attention` (the wgmma kernel and the combine) at MQ-GLIP-T's
(4, 22400, 2048) with 8 heads and MQ-GroundingDINO-T's (4, 22323, 1024) with
4 heads, T 256, and four diagnostic builds of `csrc/bi_attention.cu`, each a
copy of the source with one part of the work cut out (built with nvcc into
`mqdet_torch/_build/diag/`, loaded with ctypes; the port never loads them):

  load_only     no wgmma: the TMA loads, the softmax and the stores remain
  compute_only  K / V loaded for each block's first two chunks only: the
                tensor work and the softmax remain, on stale chunks
  l_only        the v blocks return at once (the l side and the combine)
  v_only        the l blocks return at once (the v side; the combine reads
                unwritten partials)

One JSON line per (variant, shape), the variants in turn and then in reverse
order: the median of ITERS CUDA-event-timed calls after WARMUP, and the
card's name and power limit. A diagnostic's outputs are meaningless; only its
time is read. It exits non-zero on a machine without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

from mqdet_torch.tools import card, cuda_time_ms

ITERS, WARMUP = 20, 2
SHAPES = ((4, 22400, 256, 8), (4, 22323, 256, 4))  # (B, N, T, heads), head width 256
ROLE = "  const int b = (int)(idx / args.heads);\n"
VARIANTS = {  # name: [(text of csrc/bi_attention.cu, its replacement)]
    "load_only": [
        ("#pragma unroll\n      for (int kk = 0; kk < D / 16; ++kk) wgmma_s(sc, kmajor_desc(qc, kk), "
         "kmajor_desc(kb, kk), kk > 0);\n", "      (void)qc;\n"),
        ("#pragma unroll\n      for (int kk = 0; kk < FA_CHUNK / 16; ++kk) wgmma_o(o, pa[kk], "
         "mnmajor_desc(vb, kk));\n", "      (void)pa;\n      (void)vb;\n"),
    ],
    "compute_only": [
        ("        mbar_expect_tx(fk, HALF_BYTES);\n        for (int pn = 0; pn < D / BOX; ++pn)",
         "        mbar_expect_tx(fk, j < 2 ? HALF_BYTES : 0);\n        for (int pn = 0; pn < D / BOX && j < 2; ++pn)"),
        ("        mbar_expect_tx(fv, HALF_BYTES);\n        for (int pn = 0; pn < D / BOX; ++pn)",
         "        mbar_expect_tx(fv, j < 2 ? HALF_BYTES : 0);\n        for (int pn = 0; pn < D / BOX && j < 2; ++pn)"),
    ],
    "l_only": [(ROLE, ROLE + "  if (!l_role) return;\n")],
    "v_only": [(ROLE, ROLE + "  if (l_role) return;\n")],
}


def variant_source(name: str) -> str:
    """csrc/bi_attention.cu with the variant's cuts; raises if the source
    no longer holds a text the variant replaces."""
    from mqdet_torch.ops import kernels

    with open(os.path.join(kernels.CSRC, "bi_attention.cu")) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"perf_bi_attention: variant {name} does not apply to bi_attention.cu: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """{name: loaded library}, every variant compiled in parallel."""
    from mqdet_torch.ops import kernels

    out = os.path.join(kernels.BUILD_DIR, "diag")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        src = os.path.join(out, f"{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(name))
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-shared", "-o",
             os.path.join(out, f"{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log[-3000:]}")
        so = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        so.mqdet_bi_attention_forward.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        so.mqdet_bi_attention_forward.restype = ctypes.c_int
        libs[name] = so
    return libs


def inputs(b, n, t, heads, dev, seed=0):
    """chip_smoke's bi-attention inputs: q scaled by D^-0.5, a masked text tail."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    e = 256 * heads
    q = (torch.randn(b, n, e, generator=g, device=dev) * 256 ** -0.5).bfloat16()
    k, vl = (torch.randn(b, t, e, generator=g, device=dev).bfloat16() for _ in range(2))
    vv = torch.randn(b, n, e, generator=g, device=dev).bfloat16()
    keep = torch.ones(b, t, dtype=torch.bool, device=dev)
    keep[:, 200:] = False
    return q, k, vv, vl, torch.where(keep, 0.0, -9e15).float()


def call(so, args, heads):
    """One launch of a diagnostic library's entry point, with the wrapper's
    allocations and split count."""
    import torch

    from mqdet_torch.ops import bi_attention as ba
    from mqdet_torch.ops import kernels

    q, k, vv, vl, bias = args
    b, n, e = q.shape
    t = k.shape[1]
    s = ba.l_splits(b, heads, t, n)
    out_v, out_l = torch.empty_like(q), torch.empty_like(k)
    part = (torch.empty(s, b, heads, t, ba.HEAD_DIM, dtype=torch.float32, device=q.device),
            torch.empty(s, b, heads, t, dtype=torch.float32, device=q.device),
            torch.empty(s, b, heads, t, dtype=torch.float32, device=q.device))
    p = ctypes.c_void_p
    code = so.mqdet_bi_attention_forward(
        *(p(x.data_ptr()) for x in (q, k, vv, vl, bias, out_v, out_l, *part)), b, n, t, e, heads, s,
        p(kernels.stream_ptr(q.device)))
    kernels.check(code, "mqdet_bi_attention_forward")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("perf_bi_attention: no CUDA device; it measures only on a GPU", file=sys.stderr)
        return 1
    from mqdet_torch.ops import bi_attention as ba

    dev = torch.device("cuda")
    libs = build_variants()
    runs = {"kernel": lambda args, heads: ba.flash_bi_attention(*args, heads, dual_scores=False)}
    runs.update({name: (lambda args, heads, _so=so: call(_so, args, heads)) for name, so in libs.items()})
    name = card()
    data = {shape: inputs(*shape, dev) for shape in SHAPES}
    order = list(runs) + list(runs)[::-1]
    for variant in order:
        for shape, args in data.items():
            ms = cuda_time_ms(lambda: runs[variant](args, shape[3]), ITERS, WARMUP)
            print(json.dumps({"variant": variant, "shape": list(shape), "ms": ms, "card": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
