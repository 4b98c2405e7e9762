"""Where the clipped MSDA kernel (`msda_band_kernel`, K5's function) spends
its time, on one NVIDIA GPU.

    python -m mqdet_torch.tools.perf_msda_band

Times `ms_deform_attn` at MQ-GroundingDINO-T's encoder shape (B 4, the
800x1344 pyramid, Q = S = 22323, 8 heads of 32, 4 levels x 4 points; encoder
queries sampling around their own cells with N(0, 2 cells) offsets) on:

  kernel          the clipped mode as the port runs it
  exact           the exact mode (`MQDET_MSDA_IMPL=gather`) on the same inputs
  whole_gathered  the kernel with every WHOLE pair (a small level staged
                  whole) gathered from device memory instead
  all_gathered    the kernel with no pair staged: the clipped function gathered
                  from device memory in the band kernel's thread layout

(the last two hand the kernel another band table; the function is the same),
and on diagnostic builds of `csrc/ms_deform_attn.cu`, each a copy of the
source with one part of the work cut out (built with nvcc into
`mqdet_torch/_build/diag/`, loaded with ctypes; the port never loads them):

  no_tma          no band is loaded (the barrier completes at once): the
                  gathers read stale shared memory
  no_band_reads   the shared-memory reads of the bands replaced by a value
                  made from the address: the loads, the coordinates, the
                  conversions and the multiply-adds remain
  no_point_loads  the staged levels' locations and weights made from the
                  thread index instead of read from device memory
  no_gather       GATHER levels (FINER pairs, large exact levels) skipped

One JSON line per variant, the variants in turn and then in reverse order:
the mean device time of one call over ITERS calls issued back to back
between two CUDA events (so the host's launch work overlaps the device's),
after WARMUP, and the card's name and power limit. A diagnostic's outputs
are meaningless; only its time is read. It exits non-zero on a machine
without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

from mqdet_torch.tools import card, loop_ms

ITERS, WARMUP = 20, 3
SHAPES = [(100, 168), (50, 84), (25, 42), (13, 21)]  # the 800x1344 pyramid
VARIANTS = {  # name: [(text of csrc/ms_deform_attn.cu, its replacement)]
    "no_tma": [
        ("      mbar_expect_tx(bar, (uint32_t)staged_bytes);\n      for (int l = 0; l < L; ++l) {",
         "      mbar_arrive(bar);\n      for (int l = 0; l < 0; ++l) {"),
    ],
    "no_band_reads": [
        ("for (int c = 0; c < HD / 8; ++c) accumulate8(acc, 8 * c, cw[k], lds128(pix | ((16u * c) ^ sw)));",
         "for (int c = 0; c < HD / 8; ++c) accumulate8(acc, 8 * c, cw[k], make_uint4(pix + c, pix ^ sw, pix + 7u * c, band));"),
    ],
    "no_point_loads": [
        ("      const float4 a4 = *reinterpret_cast<const float4*>(ap + p0);\n"
         "      const float4 l01 = *reinterpret_cast<const float4*>(lp + 2 * p0);\n"
         "      const float4 l23 = *reinterpret_cast<const float4*>(lp + 2 * p0 + 4);\n",
         "      const float t = 0.001f * (threadIdx.x & 63);\n"
         "      const float4 a4 = make_float4(0.25f, 0.25f, 0.25f, 0.25f);\n"
         "      const float4 l01 = make_float4(0.3f + t, 0.4f, 0.5f - t, 0.6f);\n"
         "      const float4 l23 = make_float4(0.7f, 0.2f + t, 0.45f, 0.55f - t);\n"),
    ],
    "no_gather": [
        ("    if (stage == GATHER) {\n      gather_level<HD / 8>(",
         "    if (stage == GATHER) {\n      if (stage == GATHER) continue;\n      gather_level<HD / 8>("),
    ],
}


def variant_source(name: str) -> str:
    """csrc/ms_deform_attn.cu with the variant's cuts; raises if the source
    no longer holds a text the variant replaces."""
    from mqdet_torch.ops import kernels

    with open(os.path.join(kernels.CSRC, "ms_deform_attn.cu")) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"perf_msda_band: variant {name} does not apply to ms_deform_attn.cu: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """{name: loaded library}, every variant compiled in parallel."""
    from mqdet_torch.ops import kernels

    out = os.path.join(kernels.BUILD_DIR, "diag")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        src = os.path.join(out, f"msda_{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(name))
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-shared", "-o",
             os.path.join(out, f"msda_{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log[-3000:]}")
        so = ctypes.CDLL(os.path.join(out, f"msda_{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        so.mqdet_ms_deform_attn_forward.argtypes = [p] * 4 + [ctypes.POINTER(i)] * 3 + [i] * 8 + [p]
        so.mqdet_ms_deform_attn_forward.restype = i
        libs[name] = so
    return libs


def inputs(dev, seed=0, b=4, nh=8, hd=32, p=4, scale=2.0):
    """chip_smoke's encoder case: value, locations around each query's own
    cell with N(0, `scale` cells) offsets, normalised weights."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    s = sum(h * w for h, w in SHAPES)
    value = torch.randn(b, s, nh, hd, generator=g, device=dev).bfloat16()
    centre = torch.cat([
        torch.stack(torch.meshgrid((torch.arange(w, device=dev) + 0.5) / w, (torch.arange(h, device=dev) + 0.5) / h,
                                   indexing="xy"), -1).reshape(-1, 2) for h, w in SHAPES])
    wh = torch.tensor([[w, h] for h, w in SHAPES], dtype=torch.float32, device=dev)
    off = torch.randn(b, s, nh, len(SHAPES), p, 2, generator=g, device=dev) * scale
    loc = centre[None, :, None, None, None, :] + off / wh[None, None, None, :, None, :]
    attn = torch.rand(b, s, nh, len(SHAPES), p, generator=g, device=dev)
    return value, loc, attn / attn.sum(dim=(3, 4), keepdim=True)


def call(so, args, route=None):
    """One clipped launch through a library's entry point with the port's
    tables; `route` maps each staged stage of the band table to another
    (GATHER to gather the pair from device memory instead)."""
    import torch

    from mqdet_torch.ops import kernels
    from mqdet_torch.ops import ms_deform_attn as ms

    value, loc, attn = args
    b, s, nh, hd = value.shape
    n = len(SHAPES)
    out = torch.empty(b, s, nh * hd, dtype=value.dtype, device=value.device)
    grid = [(lq, lv) for lq in range(n) for lv in range(n)]
    rule, geometry = ms.clip_pairs(SHAPES), ms.msda_band_geometry(SHAPES, hd)
    if route:
        geometry = {k: (ms.GATHER, 0, 0) if route.get(v[0]) == ms.GATHER else v for k, v in geometry.items()}
    table = ctypes.c_int * (3 * n * n)
    hw = (ctypes.c_int * (2 * n))(*[v for hw_ in SHAPES for v in hw_])
    p = ctypes.c_void_p
    code = so.mqdet_ms_deform_attn_forward(
        p(value.data_ptr()), p(loc.data_ptr()), p(attn.data_ptr()), p(out.data_ptr()), hw,
        table(*[v for key in grid for v in rule[key]]), table(*[v for key in grid for v in geometry[key]]),
        b, s, s, nh, hd, n, loc.shape[4], 1, p(kernels.stream_ptr(value.device)))
    kernels.check(code, "mqdet_ms_deform_attn_forward")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("perf_msda_band: no CUDA device; it measures only on a GPU", file=sys.stderr)
        return 1
    from mqdet_torch.ops import kernels
    from mqdet_torch.ops import ms_deform_attn as ms

    dev = torch.device("cuda")
    args = inputs(dev)
    port = kernels.lib()
    libs = build_variants()

    def exact():
        os.environ["MQDET_MSDA_IMPL"] = "gather"
        try:
            return ms.ms_deform_attn(args[0], SHAPES, args[1], args[2])
        finally:
            os.environ.pop("MQDET_MSDA_IMPL")

    runs = {
        "kernel": lambda: call(port, args),
        "exact": exact,
        "whole_gathered": lambda: call(port, args, {ms.WHOLE: ms.GATHER}),
        "all_gathered": lambda: call(port, args, {ms.WHOLE: ms.GATHER, ms.BAND: ms.GATHER}),
    }
    runs.update({name: (lambda _so=so: call(_so, args)) for name, so in libs.items()})
    name = card()
    order = list(runs) + list(runs)[::-1]
    for variant in order:
        print(json.dumps({"variant": variant, "ms": loop_ms(runs[variant], ITERS, WARMUP), "card": name}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
