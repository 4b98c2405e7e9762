"""Where the DCN kernels spend their time, on one NVIDIA GPU: the band
kernel (K1, `dcn_band_kernel<2>`) and the gather kernel (K2 and the exact
route, `dcn_gather_kernel`).

    python -m mqdet_torch.tools.perf_dcn_band

Times, at MQ-GLIP-T's level-0 shape x (4, 100, 168, 256) at strides 1 and 2
with offsets x3, and at stride 1 with perf_dcn_sweep's smooth offsets
(neighbouring positions sample neighbouring pixels), radius 2:
`modulated_deform_conv_pallas` (version 2, the
model's block rows); the gather kernel in its clipped and exact modes; and
builds of `csrc/deform_conv.cu`, each a copy of the source with one change
(built with nvcc into `mqdet_torch/_build/diag/`, loaded with ctypes; the
port never loads them). The band kernel's diagnostics, each with one part of
the work cut out:

  no_product    no wgmma: the blends still run (their fragments feed one
                accumulator register), the loads and barriers remain
  no_blend      each A fragment is a constant: the products, the loads and
                the barriers remain
  no_weights    weight slabs loaded for the ring's first pass only: the
                products read stale slabs
  no_band       the band loaded for the first chunk only: the blends read a
                stale band
  product_only  no_blend, no_weights and no_band together: the products, the
                tables and the barriers

The gather kernel's (clipped mode):

  gather_stages2     a weight and A ring of 2 stages (the kernel's is 3)
  gather_stages4     a ring of 4 stages
  gather_skip_zero   a corner of weight 0 not loaded (the kernel loads every
                     corner in the image, as its plain versions read it)

  gather_no_gather   each corner load replaced by a constant: the table
                     reads, the blends, the A stores, the products and the
                     weight loads remain
  gather_no_fill     the A stages not written at all (only the arrivals):
                     the products, the weight loads, the table and the
                     barriers
  gather_no_product  no wgmma: the gather and the weight loads remain
  gather_no_weights  the weight loaded for the ring's first pass only

One JSON line per (variant, case), the variants in turn and then in reverse
order: `ms`, the median of ITERS CUDA-event-timed single calls after
WARMUP (the wrapper's host work included), `device_ms`, the mean device
time of one call over ITERS calls issued back to back, and the card's name
and power limit. A diagnostic's outputs are meaningless; only its
time is read. It exits non-zero on a machine without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

from mqdet_torch.tools import card, cuda_time_ms, loop_ms

ITERS, WARMUP = 20, 2
CASES = ((1, 16, "x3"), (2, 8, "x3"), (1, 16, "smooth"))  # (stride, block rows: the model's, offsets)

_PRODUCT = ("      wgmma_o(acc, frag, sw128_desc(base + lay.ring + cur.slot * SLAB_BYTES, PANEL_BYTES, 1024));\n",
            "      acc[0] += __uint_as_float((frag[0] ^ frag[1] ^ frag[2] ^ frag[3]) & 0x3FFFFFu);\n")
_BLEND = ("      bl.fragment(cur.gl, cur.tap, frag);\n",
          "      frag[0] = frag[1] = frag[2] = frag[3] = 0x3C003C00u + (uint32_t)cur.tap;\n")
_WEIGHTS = [
    ("          mbar_expect_tx(full_w + 8 * slot, SLAB_BYTES);\n",
     "          const bool first = k == 0 && j < a.stages;\n"
     "          mbar_expect_tx(full_w + 8 * slot, first ? SLAB_BYTES : 0);\n"),
    ("          for (int pn = 0; pn < BAND_N / 64; ++pn)\n            tma_load_2d(",
     "          for (int pn = 0; pn < BAND_N / 64 && first; ++pn)\n            tma_load_2d("),
]
_BAND = [
    ("        mbar_expect_tx(full_band + 8 * i, band_tx);\n"
     "        tma_load_4d(",
     "        mbar_expect_tx(full_band + 8 * i, k < NBUF ? band_tx : 0);\n"
     "        if (k < NBUF) tma_load_4d("),
]
_G_GATHER = ("                cv[u][q] = __ldg(reinterpret_cast<const uint4*>(a.x + (pix + dq[q]) * a.C + c));\n",
             "                cv[u][q] = make_uint4(0x3F803F80u + q, 0x3F803F80u, 0x3F803F80u, (uint32_t)pix);\n")
_G_FILL = ("        for (int h = 0; h < 8; h += 4) {\n", "        for (int h = 0; h < 0; h += 4) {\n")
_G_PRODUCT = ("        wgmma_ss(acc, sw128_desc(st + cw * 64 * 128 + kk * 32, 0, 1024),\n"
              "                 sw128_desc(st + A_BYTES + kk * GROUP * 128, W_PANEL_BYTES, 1024));\n",
              "        acc[kk] += 1.0f;\n")
_G_WEIGHTS = [
    ("          mbar_expect_tx(full + 8 * slot, W_BYTES);\n",
     "          const bool first = tap * nchunks + k < GATHER_STAGES;\n"
     "          mbar_expect_tx(full + 8 * slot, first ? W_BYTES : 0);\n"),
    ("          for (int pn = 0; pn < BAND_N / 64; ++pn)\n            tma_load(",
     "          for (int pn = 0; pn < BAND_N / 64 && first; ++pn)\n            tma_load("),
]
_G_STAGES = "constexpr int GATHER_STAGES = 3;"
_G_SKIP = ("              if (live_c && (in >> q & 1u))  // every corner in the image, whatever its weight\n",
           "              if (live_c && wq[u][q] != 0.f)\n")
VARIANTS = {  # name: [(text of csrc/deform_conv.cu, its replacement)]
    "no_product": [_PRODUCT],
    "no_blend": [_BLEND],
    "no_weights": _WEIGHTS,
    "no_band": _BAND,
    "product_only": [_BLEND] + _WEIGHTS + _BAND,
    "gather_no_gather": [_G_GATHER],
    "gather_no_fill": [_G_FILL],
    "gather_no_product": [_G_PRODUCT],
    "gather_no_weights": _G_WEIGHTS,
    "gather_stages2": [(_G_STAGES, _G_STAGES.replace("3", "2"))],
    "gather_stages4": [(_G_STAGES, _G_STAGES.replace("3", "4"))],
    "gather_skip_zero": [_G_SKIP],
}


def variant_source(name: str) -> str:
    """csrc/deform_conv.cu with the variant's cuts; raises if the source no
    longer holds a text the variant replaces."""
    from mqdet_torch.ops import kernels

    with open(os.path.join(kernels.CSRC, "deform_conv.cu")) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"perf_dcn_band: variant {name} does not apply to deform_conv.cu: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """{name: loaded library}, every variant compiled in parallel."""
    from mqdet_torch.ops import kernels

    out = os.path.join(kernels.BUILD_DIR, "diag")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        src = os.path.join(out, f"dcn_{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(name))
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-shared", "-o",
             os.path.join(out, f"dcn_{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log[-3000:]}")
        so = ctypes.CDLL(os.path.join(out, f"dcn_{name}.so"))
        so.mqdet_dcn_band_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
        so.mqdet_dcn_band_forward.restype = ctypes.c_int
        so.mqdet_dcn_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        so.mqdet_dcn_forward.restype = ctypes.c_int
        libs[name] = so
    return libs


def call(so, args, stride, block_rows):
    """One launch of a diagnostic library's band entry point (version 2,
    radius 2), with the wrapper's geometry and allocation."""
    import torch

    from mqdet_torch.ops import deform_conv as dc
    from mqdet_torch.ops import kernels

    x, off, mask, wt, bias = args
    b, h, w, c = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    br, bw, bk, stages, nbytes = dc.band_geometry(c, stride, 2, block_rows, 2)
    out = torch.empty(b, ho, wo, wt.shape[-1], dtype=x.dtype, device=x.device)
    p = ctypes.c_void_p
    code = so.mqdet_dcn_band_forward(
        *(p(t.data_ptr()) for t in (x, off, mask, wt, bias, out)), b, h, w, c, ho, wo, wt.shape[-1], stride, 2,
        br, bw, 2, bk, stages, nbytes, p(kernels.stream_ptr(x.device)))
    kernels.check(code, "mqdet_dcn_band_forward")


def call_gather(so, args, stride):
    """One launch of a diagnostic library's gather entry point (clipped,
    radius 2)."""
    import torch

    from mqdet_torch.ops import kernels

    x, off, mask, wt, bias = args
    b, h, w, c = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    out = torch.empty(b, ho, wo, wt.shape[-1], dtype=x.dtype, device=x.device)
    p = ctypes.c_void_p
    code = so.mqdet_dcn_forward(
        *(p(t.data_ptr()) for t in (x, off, mask, wt, bias, out)), b, h, w, c, ho, wo, wt.shape[-1], stride, 2,
        p(kernels.stream_ptr(x.device)))
    kernels.check(code, "mqdet_dcn_forward")


def inputs(stride, dev, offsets="x3", seed=0):
    """chip_smoke's DCN inputs at level 0: offsets x3 (the +-2 clip binds);
    or perf_dcn_sweep's level-0 inputs with its smooth offsets."""
    import torch

    if offsets == "smooth":
        from mqdet_torch.tools.perf_dcn_sweep import sweep_inputs

        x0, offs, m0, wt, bs = sweep_inputs(dev)
        return x0, offs["smooth"], m0, wt, bs

    g = torch.Generator(device=dev).manual_seed(seed)
    ho, wo = -(-100 // stride), -(-168 // stride)
    x = torch.randn(4, 100, 168, 256, generator=g, device=dev).bfloat16()
    off = (torch.randn(4, ho, wo, 18, generator=g, device=dev) * 3.0).bfloat16()
    mask = torch.rand(4, ho, wo, 9, generator=g, device=dev).bfloat16()
    wt = (torch.randn(3, 3, 256, 256, generator=g, device=dev) * 0.03).bfloat16()
    bias = (torch.randn(256, generator=g, device=dev) * 0.1).bfloat16()
    return x, off, mask, wt, bias


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("perf_dcn_band: no CUDA device; it measures only on a GPU", file=sys.stderr)
        return 1
    from mqdet_torch.ops import deform_conv as dc

    dev = torch.device("cuda")
    libs = build_variants()
    runs = {"kernel": lambda args, s, br: dc.modulated_deform_conv_pallas(*args, stride=s, radius=2, block_rows=br),
            "gather": lambda args, s, br: dc._launch(*args, s, 2),
            "gather_exact": lambda args, s, br: dc._launch(*args, s, None)}
    runs.update({name: (lambda args, s, br, _so=so, _g=name.startswith("gather"):
                        call_gather(_so, args, s) if _g else call(_so, args, s, br)) for name, so in libs.items()})
    name = card()
    data = {case: inputs(case[0], dev, case[2]) for case in CASES}
    order = list(runs) + list(runs)[::-1]
    for variant in order:
        for (stride, br, offsets), args in data.items():
            ms = cuda_time_ms(lambda: runs[variant](args, stride, br), ITERS, WARMUP)
            device_ms = loop_ms(lambda: runs[variant](args, stride, br), ITERS, WARMUP)
            print(json.dumps({"variant": variant, "x": [4, 100, 168, 256], "stride": stride, "block_rows": br,
                              "offsets": offsets, "ms": ms, "device_ms": device_ms, "card": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
