#!/usr/bin/env python3
"""Smoke run of the mqdet_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N] [--runs N]

Run from the root of a checkout. It needs a CUDA device and the CUDA toolkit
(`nvcc`); it imports nothing of JAX. It drives both evaluation paths of the
port, MQ-GLIP-T and MQ-GroundingDINO-T. Phases, each printing lines:

  1. the card (`nvidia-smi` name and power limit) and the kernels' build from
     `mqdet_torch/csrc/` with nvcc for sm_90a (one nvcc per source, in
     parallel);
  2. each hand-written kernel against its plain PyTorch version (run in fp32)
     at the main paths' shapes, bf16 inputs from the seed: max abs error
     against the bound 2e-2 * max|ref|, the median time of 10 runs of the
     kernel and of the plain version (bf16, same inputs), CUDA events, and
     the bound (the least time the card could take: bytes moved over
     3.35 TB/s or operations over their peak rate, whichever is larger).
     DCN at the GLIP levels (offsets x3, so the +-2 clip bites): the gather
     kernel (`dcn_gather_kernel`, on wgmma and TMA) in its exact mode and its
     clipped mode (K2), and the band kernel (K1, version 2, on wgmma and
     TMA), each beside `conv_ms`, one cuDNN 3x3 convolution at the shape (the
     yardstick of the product alone, not of DCN's function);
     at the level-0 shape under perf_dcn_sweep's two offset regimes, versions
     1, 3 and 5 against the plain version, 5 and 6 and x_tiles 2 and 3
     bitwise equal to version 2, and version 5's fast-path share; the band at
     radius 8, stride 2 (the largest band); then the sweep path itself
     (mqdet_torch.tools.perf_dcn_sweep, versions 1, 2, 3, 5, 6 at block rows
     8 and 16), its launches counted; the band and gather kernels' ptxas
     reports (no spill, no stack frame for the gather kernel, and no C75xx
     note in the build: a serialised wgmma fails the run). Bi-attention, K3
     and K3b (one wgmma kernel and the combine behind both entry points),
     at GLIP's (4, 22400, 2048) with 8 heads and GroundingDINO's (4, 22323,
     1024) with 4 heads, T 256, with the l side's split count S, the
     kernel's registers and spill bytes from the ptxas report, its TFLOP/s
     on the 8 B N T E it computes,
     its share of the bound, and `library_ms`: two scaled_dot_product_attention
     calls (v side with the bias as attn_mask, l side), timed only, as the
     yardstick; K3 also against `bi_attention_tiled_plain` (the plain model of
     its decomposition) at the kernel's S; K3 and K3b must be bitwise equal;
     the streamed (per-level,
     carried-state) bi-attention (K4: per level the wgmma kernel, then the
     combine merging its partials with the carried state) at GLIP's 800x1344
     pyramid (16800, 4200, 1050, 273 and 77 rows), also against
     `bi_attention_levels_tiled_plain` (the plain model of its
     decomposition), with the same two calls over the concatenated levels as
     its `library_ms`; MSDA at the 800x1344 GroundingDINO pyramid
     (100x168, 50x84, 25x42, 13x21; 8 heads of 32, 4 levels x 4 points, B 4):
     encoder queries (Q = S) on the default route, the clipped mode
     (`ms_deform_attn_clip`, K5's window-clipped function on the band
     kernel) against `ms_deform_attn_clipped_plain`, near their cells, 12
     cells out and on their windows' edges (the share of sample points the
     clip moves printed; the band kernel's ptxas reports without a spill or
     a stack frame), and under
     MQDET_MSDA_IMPL=gather on the exact mode; decoder queries (Q = 900) and
     locations far off the image on the exact mode;
  3. per model, a small-input reference check: the full-width model on a
     256x256 image, one chunk, on the card (bf16, kernels) against the same
     weights in fp32 on the CPU (plain versions), by relative L2 error within
     twice the drift of the plain path run in bf16 on the CPU (or 1e-2 where
     that is larger). MQ-GLIP-T: FPN features and dot-product logits, the
     card run under each fusion switch (default, MQDET_FLASH_LEVELS=stream,
     MQDET_FLASH_SCORES=dual) and under MQDET_DEFORM_IMPL unset (the band
     kernel), window (K2) and gather (exact), each against the CPU plain
     path of the same DCN route, with its launches counted; the max |offset|
     of the random-init model is printed (whether the clip binds).
     MQ-GroundingDINO-T: the encoder's memory and text and the two-stage
     logits (`enc_logits`), taken before the top-900 selection, whose
     overlap with the fp32 selection is printed; the CPU side under
     MQDET_MSDA_IMPL=pallas_interpret (the clipped function the card's
     default route computes), the share of encoder sample points the clip
     moves printed, the card's 6 clipped and 6 exact MSDA launches counted;
  4. per model, the LVIS protocol as bench.py runs it: full width from
     init_params(seed), one 800x1344 image, 8 groups x CP 4 chunks of 40
     labels x 5 queries, T = 256, through make_protocol_fn. The launch
     counters, set to 0 just before one protocol run, must equal the
     prediction: MQ-GLIP-T 624 band DCN (dcn_band) and 48 bi-attention
     launches (13 DCN calls and one bi-attention per head stage, 6 stages, 8
     groups);
     MQ-GroundingDINO-T 48 clipped MSDA (ms_deform_attn_clip, 6 encoder
     layers x 8 groups), 48 exact MSDA (6 decoder layers) and 48
     bi-attention (one per encoder layer). Every output must be finite and
     of the right shape. Then p50 over --runs timed runs and the peak device
     memory of the protocol. The same runs first under the switches, with
     phase 5 for each: MQ-GLIP-T under stream (240 level launches, 5 per
     stage, and no pair launch), under dual (48 dual launches), under
     MQDET_DEFORM_IMPL=window (624 K2 launches) and under
     MQDET_DEFORM_IMPL=gather (624 exact launches), MQ-GroundingDINO-T under
     dual (48; its fusion takes one flattened tensor, so stream does not
     apply);
  5. per protocol run, one run under torch.profiler: device busy time,
     idle share, kernel time by family and the time and launches of each
     hand-written kernel;
  6. per model, last (default switches), one protocol run with a device
     synchronise at the boundaries of its main modules (forward hooks):
     host-clock ms per module.

The line before the last is a JSON object with one entry per kernel (its
launches summed over the counted paths: the protocols, phase 3's card runs
and the sweep path); the last line is {"ok": true, "device": {...}}. Any
failure exits non-zero without those lines.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ERR_BOUND = 2e-2      # kernel vs fp32 plain, relative to max|ref| (bf16 in/out)
E2E_FLOOR = 1e-2      # whole network: floor of the bf16-vs-fp32 relative L2 bound
HBM_BYTES_S = 3.35e12  # H100 SXM: device memory rate, bf16 dense tensor-core and fp32 peaks
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
DCN_SRC = "mqdet_torch/csrc/deform_conv.cu"
K1 = "mqdet_tpu/ops/pallas/deform_conv_pallas.py"
KERNELS = (  # name, source, the TPU kernel (or XLA composite) it replaces; the order of ops.COUNTERS
    ("dcn", DCN_SRC, "mqdet_tpu/ops/deform_conv.py:62"),
    ("dcn_gather_clip", DCN_SRC, "mqdet_tpu/ops/pallas/deform_conv_gather_pallas.py:220"),
    ("dcn_band", DCN_SRC, f"{K1}:561"),
    ("dcn_band_v1", DCN_SRC, f"{K1}:59"),
    ("dcn_band_v3", DCN_SRC, f"{K1}:535"),
    ("dcn_band_v5", DCN_SRC, f"{K1}:262"),
    ("dcn_band_v6", DCN_SRC, f"{K1}:540"),
    ("bi_attention", "mqdet_torch/csrc/bi_attention.cu", "mqdet_tpu/ops/pallas/bi_attention_pallas.py:384"),
    ("bi_attention_dual", "mqdet_torch/csrc/bi_attention.cu", "mqdet_tpu/ops/pallas/bi_attention_pallas.py:107"),
    ("bi_attention_levels", "mqdet_torch/csrc/bi_attention.cu", "mqdet_tpu/ops/pallas/bi_attention_pallas.py:252"),
    ("ms_deform_attn", "mqdet_torch/csrc/ms_deform_attn.cu", "mqdet_tpu/ops/ms_deform_attn.py:47"),
    ("ms_deform_attn_clip", "mqdet_torch/csrc/ms_deform_attn.cu", "mqdet_tpu/ops/pallas/msda_pallas.py:455"),
)
GDINO_800 = [(100, 168), (50, 84), (25, 42), (13, 21)]  # the 800x1344 pyramid
GLIP_800 = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
SWITCHES = {"default": {}, "stream": {"MQDET_FLASH_LEVELS": "stream"}, "dual": {"MQDET_FLASH_SCORES": "dual"}}
# MQDET_DEFORM_IMPL -> the DCN kernel of the route at C = 256 (None: unset, the default)
DEFORM_ROUTES = {None: "dcn_band", "window": "dcn_gather_clip", "gather": "dcn"}
SWEEP_VERSIONS, SWEEP_BLOCK_ROWS = (2, 1, 3, 5, 6), (8, 16)  # version 2 first: the sweep's reference


@contextlib.contextmanager
def switched(name: str, deform=None, msda=None):
    """Sets the fusion switches of SWITCHES[name], MQDET_DEFORM_IMPL and
    MQDET_MSDA_IMPL (None: unset) for the block."""
    keys = ("MQDET_FLASH_LEVELS", "MQDET_FLASH_SCORES", "MQDET_DEFORM_IMPL", "MQDET_MSDA_IMPL")
    old = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(SWITCHES[name])
    if deform is not None:
        os.environ["MQDET_DEFORM_IMPL"] = deform
    if msda is not None:
        os.environ["MQDET_MSDA_IMPL"] = msda
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def max_err(got, ref) -> tuple:
    """(max |got - ref|, max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, ref.abs().max().item()


def bound(nbytes: float, tensor_flops: float = 0.0, fp32_flops: float = 0.0) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for the work,
    the larger of the bytes over the memory rate and the operations over the
    peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(tensor_flops / PEAK_BF16, fp32_flops / PEAK_FP32)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def dcn_bound(b, h, w, c, ho, wo, cout) -> tuple:
    """bf16 x, offset, mask, weight, bias read once, out written once; the
    (M, 9C) x (9C, Cout) product on the tensor cores, the 4-corner blend
    (8 flops per sample and channel) in fp32."""
    m = b * ho * wo
    nbytes = 2 * (b * h * w * c + m * 27 + 9 * c * cout + cout + m * cout)
    return bound(nbytes, 2.0 * m * 9 * c * cout, 8.0 * m * 9 * c)


def bi_bound(b, n, t, e) -> tuple:
    """q, vv (B, N, E), k, vl (B, T, E) bf16 and the fp32 bias read once,
    out_v and out_l written once; the function's least tensor work, one
    score product that serves both sides and the two output products: 6 B N
    T E flops, in either formulation (the port's kernels make 8, their l side
    recomputing its scores)."""
    nbytes = 2 * (3 * b * n * e + 3 * b * t * e) + 4 * b * t
    return bound(nbytes, 6.0 * b * n * t * e)


def msda_bound(b, s, q, nh, hd, levels, p) -> tuple:
    """value bf16, fp32 locations and weights read once, the bf16 output
    written once; per sample point 4 corners x hd multiply-adds and the
    weighted sum, in fp32."""
    pts = b * q * nh * levels * p
    nbytes = 2 * b * s * nh * hd + 12 * pts + 2 * b * q * nh * hd
    return bound(nbytes, 0.0, 10.0 * pts * hd)


def conv_yardstick_ms(torch, x, cout, stride) -> float:
    """One F.conv2d (cuDNN, bf16, channels_last) of x (B, H, W, C) with a 3x3
    kernel, pad 1, at the stride: the yardstick of the band kernel's product
    alone (not of DCN's function: no sampling, no clip). Timed only: the
    port never calls it."""
    from mqdet_torch.tools import cuda_time_ms

    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
    wc = torch.zeros(cout, x.shape[-1], 3, 3, dtype=x.dtype, device=x.device).to(memory_format=torch.channels_last)
    return cuda_time_ms(lambda: torch.nn.functional.conv2d(xc, wc, stride=stride, padding=1))


def clip_share(torch, spatial_shapes, loc) -> float:
    """Share of the sample points of encoder queries whose pixel the MSDA
    clip moves (the clipped function's windows, `window_bounds`)."""
    from mqdet_torch.ops import ms_deform_attn as ms

    bnd = ms.window_bounds(spatial_shapes, loc.device)
    moved = total = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x = loc[:, :, :, lvl, :, 0].float() * w - 0.5  # (B, Q, nh, P)
        y = loc[:, :, :, lvl, :, 1].float() * h - 0.5
        lo_y, hi_y, lo_x, hi_x = (t[None, :, None, None] for t in bnd[lvl])
        out = (y < lo_y) | (y > hi_y) | (x < lo_x) | (x > hi_x)
        moved += int(out.sum())
        total += out.numel()
    return moved / total


def phase_kernels(torch, seed):
    """Returns ({kernel: [case dict, ...]}, main case first, and the launch
    counts of the sweep path)."""
    from mqdet_torch.ops import bi_attention as ba
    from mqdet_torch.ops import deform_conv as dc
    from mqdet_torch.ops import kernels, launch_counts
    from mqdet_torch.ops import ms_deform_attn as ms
    from mqdet_torch.tools import cuda_time_ms, perf_dcn_sweep

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    results = {name: [] for name, _, _ in KERNELS}

    def record(name, case, err, ms_, plain_ms, bnd, library_ms=None):
        results[name].append({"case": case, "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms,
                              "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms})

    def check(label, got, ref, tag=None):
        err, scale = max_err(got, ref)
        ok = bool(torch.isfinite(got).all()) and err <= ERR_BOUND * scale
        say(f"phase 2: {label}: max_abs_err {err!r} (bound {ERR_BOUND * scale!r} = {ERR_BOUND} * max|ref| "
            f"{scale!r}){tag or ''}; {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{label}: kernel disagrees with its plain version")
        return err

    def dcn_inputs(b, h, w, c, stride, scale):
        ho, wo = -(-h // stride), -(-w // stride)
        x = torch.randn(b, h, w, c, generator=g, device=dev).bfloat16()
        off = (torch.randn(b, ho, wo, 18, generator=g, device=dev) * scale).bfloat16()
        mask = torch.rand(b, ho, wo, 9, generator=g, device=dev).bfloat16()
        wt = (torch.randn(3, 3, c, c, generator=g, device=dev) * 0.03).bfloat16()
        bias = (torch.randn(c, generator=g, device=dev) * 0.1).bfloat16()
        return (x, off, mask, wt, bias)

    def dcn_case(b, h, w, c, stride):
        """The exact kernel, K2 and band v2 at one level of the pyramid;
        offsets x3 reach well beyond the +-2 clip."""
        ho, wo = -(-h // stride), -(-w // stride)
        args = dcn_inputs(b, h, w, c, stride, 3.0)
        br = 16 if h // stride >= 100 else 8  # the model's block rows
        routes = (
            ("dcn", lambda a: dc.modulated_deform_conv(*a, stride=stride),
             lambda a: dc.modulated_deform_conv_plain(*a, stride=stride)),
            ("dcn_gather_clip", lambda a: dc.modulated_deform_conv_window(*a, stride=stride, radius=2),
             lambda a: dc.modulated_deform_conv_clipped_plain(*a, stride=stride, radius=2)),
            ("dcn_band", lambda a: dc.modulated_deform_conv_pallas(*a, stride=stride, radius=2, block_rows=br),
             lambda a: dc.modulated_deform_conv_clipped_plain(*a, stride=stride, radius=2)),
        )
        for name, fn, plain in routes:
            got = fn(args)
            torch.cuda.synchronize()
            ref = plain(tuple(a.float() for a in args))
            ms_ = cuda_time_ms(lambda: fn(args))
            plain_ms = cuda_time_ms(lambda: plain(args))
            bnd = dcn_bound(b, h, w, c, ho, wo, c)
            conv = conv_yardstick_ms(torch, args[0], c, stride)
            err = check(f"{name} x{(b, h, w, c)} stride {stride} -> {(ho, wo)}", got, ref,
                        f"; kernel {ms_!r} ms, plain bf16 {plain_ms!r} ms, bound {bnd[0]!r} ms ({bnd[1]})"
                        + f"; conv_ms {conv!r} (one cuDNN 3x3 conv at the shape: the product's yardstick, "
                        f"not DCN's function)")
            del ref, got
            record(name, f"x{(b, h, w, c)} s{stride}", err, ms_, plain_ms, bnd)
            results[name][-1]["conv_ms"] = conv
        torch.cuda.empty_cache()

    dcn_case(4, 100, 168, 256, 1)
    dcn_case(4, 100, 168, 256, 2)
    dcn_case(4, 7, 11, 256, 1)

    # the band kernel's versions at the level-0 shape, under the sweep's two offset regimes
    x0, offs, m0, wt0, bs0 = perf_dcn_sweep.sweep_inputs(dev)
    regime_err = {}  # (version, regime) -> max abs error against the plain version
    for regime, off0 in offs.items():
        args = (x0, off0, m0, wt0, bs0)
        ref = dc.modulated_deform_conv_clipped_plain(*(a.float() for a in args), stride=1, radius=2)
        v2 = dc.modulated_deform_conv_pallas(*args, stride=1, radius=2, block_rows=16, version=2)
        for version in SWEEP_VERSIONS:
            got = dc.modulated_deform_conv_pallas(*args, stride=1, radius=2, block_rows=16, version=version)
            torch.cuda.synchronize()
            regime_err[version, regime] = check(
                f"dcn_band version {version}, level 0 (4, 100, 168, 256), {regime} offsets", got, ref)
        same = {}
        for version, tiles in ((5, 1), (6, 1), (2, 2), (2, 3)):
            got = dc.modulated_deform_conv_pallas(*args, stride=1, radius=2, block_rows=16, version=version,
                                                  x_tiles=tiles)
            same[f"v{version} x_tiles {tiles}"] = torch.equal(got, v2)
        share = dc.band_fast_share(off0, 1, 2, 16)
        say(f"phase 2: dcn_band level 0, {regime} offsets: bitwise equal to version 2: {same}; version 5's "
            f"fast path takes {share!r} of the (tile, tap) pairs (block rows 16)")
        if not all(same.values()):
            fail(f"dcn_band variants differ from version 2 ({regime} offsets): {same}")
        del ref, v2, got
    torch.cuda.empty_cache()

    # the largest band: radius 8 at stride 2 (offsets x6, so the clip bites at 8)
    args = dcn_inputs(4, 100, 168, 256, 2, 6.0)
    ref = dc.modulated_deform_conv_clipped_plain(*(a.float() for a in args), stride=2, radius=8)
    for version in (2, 6):
        got = dc.modulated_deform_conv_pallas(*args, stride=2, radius=8, block_rows=16, version=version)
        torch.cuda.synchronize()
        r8_ms = cuda_time_ms(lambda: dc.modulated_deform_conv_pallas(*args, stride=2, radius=8, block_rows=16,
                                                                      version=version))
        check(f"dcn_band version {version}, radius 8, stride 2, x (4, 100, 168, 256) -> (50, 84)", got, ref,
              f"; kernel {r8_ms!r} ms (geometry {dc.band_geometry(256, 2, 8, 16, version)}: rows, cols, "
              f"chunk, stages, bytes)")
    del ref, got, args
    torch.cuda.empty_cache()

    # the sweep path (perf_dcn_sweep's entry), counted: every version at block rows 8 and 16
    launch_counts(reset=True)
    recs = list(perf_dcn_sweep.sweep(SWEEP_VERSIONS, SWEEP_BLOCK_ROWS, dev))
    sweep_launches = launch_counts()
    for rec in recs:
        say(f"phase 2: perf_dcn_sweep {json.dumps(rec)}")
    per_case = 1 + perf_dcn_sweep.WARMUP + perf_dcn_sweep.ITERS
    names = {1: "dcn_band_v1", 2: "dcn_band", 3: "dcn_band_v3", 5: "dcn_band_v5", 6: "dcn_band_v6"}
    want = predicted(**{names[v]: len(offs) * len(SWEEP_BLOCK_ROWS) * per_case for v in SWEEP_VERSIONS})
    say(f"phase 2: perf_dcn_sweep path launches {sweep_launches} (predicted {want})")
    if sweep_launches != want or any("error" in r for r in recs):
        fail("perf_dcn_sweep path: a case failed or the launches differ from the prediction")
    plain_ms = {3: cuda_time_ms(lambda: dc.modulated_deform_conv_v3_plain(x0, offs["rand"], m0, wt0, bs0))}
    plain_ms[1] = cuda_time_ms(lambda: dc.modulated_deform_conv_clipped_plain(x0, offs["rand"], m0, wt0, bs0))
    bnd = dcn_bound(4, 100, 168, 256, 100, 168, 256)
    conv0 = conv_yardstick_ms(torch, x0, 256, 1)
    for rec in recs:
        v = rec["version"]
        if v != 2:
            record(names[v], f"perf_dcn_sweep {rec['regime']} block rows {rec['block_rows']}",
                   regime_err[v, rec["regime"]], rec["ms"], plain_ms[3 if v == 3 else 1], bnd)
            results[names[v]][-1]["conv_ms"] = conv0
    for rows in results.values():  # the sweep's rand regime at the model's block rows first
        rows.sort(key=lambda r: not r["case"].startswith("perf_dcn_sweep rand block rows 16"))
    del x0, offs, m0, wt0, bs0
    torch.cuda.empty_cache()

    def bi_inputs(b, n, t, e, heads):
        q = (torch.randn(b, n, e, generator=g, device=dev) * (e // heads) ** -0.5).bfloat16()
        k = torch.randn(b, t, e, generator=g, device=dev).bfloat16()
        vv = torch.randn(b, n, e, generator=g, device=dev).bfloat16()
        vl = torch.randn(b, t, e, generator=g, device=dev).bfloat16()
        keep = torch.ones(b, t, dtype=torch.bool, device=dev)
        keep[:, 200:] = False  # padded text tail
        keep[1, 120:] = False
        return q, k, vv, vl, torch.where(keep, 0.0, -9e15).float()

    def bi_check(name, case, outs, refs, ms_, plain_ms, bnd, library_ms=None, extra=""):
        errs = [max_err(o, r) for o, r in zip(outs, refs)]
        ok = all(err <= ERR_BOUND * scale for err, scale in errs) and all(
            bool(torch.isfinite(o).all()) for o in outs
        )
        say(
            f"phase 2: {name} {case}: max_abs_err out_v {errs[0][0]!r} (bound "
            f"{ERR_BOUND * errs[0][1]!r}), out_l {errs[-1][0]!r} (bound {ERR_BOUND * errs[-1][1]!r}); "
            f"kernel {ms_!r} ms, plain bf16 {plain_ms!r} ms, bound {bnd[0]!r} ms ({bnd[1]}){extra}; "
            f"{'ok' if ok else 'FAIL'}"
        )
        if not ok:
            fail(f"{name} kernel disagrees with its plain version at {case}")
        record(name, case, max(e for e, _ in errs), ms_, plain_ms, bnd, library_ms)
        torch.cuda.empty_cache()

    def sdpa_pair(q, k, vv, vl, bias, heads):
        """The yardstick of K3 and K3b: two scaled_dot_product_attention
        calls, the v side (q over k and vl, the bias as attn_mask) and the l
        side (k over q and vv), scale 1. Timed only: the port never calls it."""
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qh, kh, vvh, vlh = (ba._heads(x, heads) for x in (q, k, vv, vl))
        sdpa(qh, kh, vlh, attn_mask=bias[:, None, None, :].to(q.dtype), scale=1.0)
        sdpa(kh, qh, vvh, scale=1.0)

    band_regs = kernels.ptxas_reports("dcn_band_kernel")
    gather_regs = kernels.ptxas_report("dcn_gather_kernel")
    notes = kernels.ptxas_notes()
    say(f"phase 2: dcn_band_kernel ptxas reports (one per version, as built) {band_regs}; dcn_gather_kernel "
        f"{gather_regs}; ptxas C75xx notes (wgmma serialised) in the build: {notes}")
    if any(r["spill_stores"] or r["spill_loads"] for r in band_regs + [gather_regs]) or notes:
        fail("dcn_band_kernel or dcn_gather_kernel spills registers, or ptxas serialises a wgmma")
    if gather_regs["stack"]:
        fail("dcn_gather_kernel has a stack frame")
    wgmma_regs = kernels.ptxas_report("bi_attn_wgmma_kernel")
    say(f"phase 2: bi_attn_wgmma_kernel ptxas report {wgmma_regs} (registers at launch; setmaxnreg gives "
        f"the consumer warpgroups 240)")
    if wgmma_regs["spill_stores"] or wgmma_regs["spill_loads"]:
        fail("bi_attn_wgmma_kernel spills registers (ptxas serialises its wgmma then)")

    def bi_case(b, n, t, e, heads, dual):
        """K3 (dual False) or K3b against its plain version; K3b's outputs
        must be K3's bits (one kernel behind both entry points)."""
        name = "bi_attention_dual" if dual else "bi_attention"
        plain = ba.bi_attention_dual_plain if dual else ba.bi_attention_plain
        args = bi_inputs(b, n, t, e, heads)
        ov, ol = ba.flash_bi_attention(*args, num_heads=heads, dual_scores=dual)
        if dual:
            k3 = ba.flash_bi_attention(*args, num_heads=heads, dual_scores=False)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip((ov, ol), k3)):
                fail(f"K3b's outputs differ from K3's at {(b, n, t, e, heads)}")
            del k3
        torch.cuda.synchronize()
        refs = plain(*(a.float() for a in args[:4]), args[4], num_heads=heads)
        splits = ba.l_splits(b, heads, t, n)
        if not dual:  # the plain model of the kernel's decomposition, at the kernel's S
            tiled = ba.bi_attention_tiled_plain(*(a.float() for a in args[:4]), args[4], heads, splits)
            errs = [max_err(o, r) for o, r in zip((ov, ol), tiled)]
            ok = all(err <= ERR_BOUND * scale for err, scale in errs)
            say(f"phase 2: {name} q/vv {(b, n, e)} against bi_attention_tiled_plain (fp32, S "
                f"{splits}): max_abs_err out_v {errs[0][0]!r}, out_l {errs[1][0]!r} "
                f"(bounds {ERR_BOUND * errs[0][1]!r}, {ERR_BOUND * errs[1][1]!r}); {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} disagrees with the plain model of its decomposition at {(b, n, t, e, heads)}")
            del tiled
        ms_ = cuda_time_ms(lambda: ba.flash_bi_attention(*args, num_heads=heads, dual_scores=dual))
        plain_ms = cuda_time_ms(lambda: plain(*args, num_heads=heads))
        try:
            library_ms = cuda_time_ms(lambda: sdpa_pair(*args, heads))
        except RuntimeError as exc:  # no SDPA kernel for these inputs: no yardstick
            say(f"phase 2: {name} yardstick (two scaled_dot_product_attention calls) failed: {exc}")
            library_ms = None
        bnd = bi_bound(b, n, t, e)
        extra = (f"; S {splits}, {8.0 * b * n * t * e / ms_ / 1e9!r} TFLOP/s on "
                 f"8 B N T E, {bnd[0] / ms_!r} of the bound; library (two scaled_dot_product_attention "
                 f"calls) {library_ms!r} ms; ptxas {wgmma_regs}")
        bi_check(name, f"q/vv {(b, n, e)} T {t} heads {heads}", (ov, ol), refs, ms_, plain_ms, bnd,
                 library_ms, extra)
        results[name][-1].update(splits=splits, ptxas=wgmma_regs,
                                 tflops=8.0 * b * n * t * e / ms_ / 1e9)

    def levels_case(b, shapes, t, e, heads):
        """The streamed form, one launch per level, at a pyramid's levels."""
        sizes = [h * w for h, w in shapes]
        q, k, vv, vl, bias = bi_inputs(b, sum(sizes), t, e, heads)
        library_ms = cuda_time_ms(lambda: sdpa_pair(q, k, vv, vl, bias, heads))  # over the concatenated levels
        qs = [x.contiguous() for x in q.split(sizes, 1)]
        vvs = [x.contiguous() for x in vv.split(sizes, 1)]
        del q, vv
        ovs, ol = ba.flash_bi_attention_levels(qs, k, vvs, vl, bias, heads)
        torch.cuda.synchronize()
        rvs, rl = ba.bi_attention_levels_plain(
            [x.float() for x in qs], k.float(), [x.float() for x in vvs], vl.float(), bias, heads
        )
        # one bound over all levels' out_v, as for the flat form
        outs = (torch.cat(ovs, 1), ol)
        refs = (torch.cat(rvs, 1), rl)
        del rvs
        tvs, tl = ba.bi_attention_levels_tiled_plain(
            [x.float() for x in qs], k.float(), [x.float() for x in vvs], vl.float(), bias, heads
        )
        errs = [max_err(o, r) for o, r in zip(outs, (torch.cat(tvs, 1), tl))]
        splits = [ba.l_splits(b, heads, t, n) for n in sizes]
        ok = all(err <= ERR_BOUND * scale for err, scale in errs)
        say(f"phase 2: bi_attention_levels against bi_attention_levels_tiled_plain (fp32, S {splits} per "
            f"level): max_abs_err out_v {errs[0][0]!r}, out_l {errs[1][0]!r} (bounds {ERR_BOUND * errs[0][1]!r}, "
            f"{ERR_BOUND * errs[1][1]!r}); {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("bi_attention_levels disagrees with the plain model of its decomposition")
        del tvs, tl
        ms_ = cuda_time_ms(lambda: ba.flash_bi_attention_levels(qs, k, vvs, vl, bias, heads))
        plain_ms = cuda_time_ms(lambda: ba.bi_attention_levels_plain(qs, k, vvs, vl, bias, heads))
        bi_check("bi_attention_levels", f"levels {sizes} x (B {b}, E {e}) T {t} heads {heads}",
                 outs, refs, ms_, plain_ms, bi_bound(b, sum(sizes), t, e), library_ms,
                 f"; library (two scaled_dot_product_attention calls over the concatenated levels) "
                 f"{library_ms!r} ms; S {splits} per level")
        results["bi_attention_levels"][-1]["splits"] = splits

    for dual in (False, True):
        bi_case(4, 22400, 256, 2048, 8, dual)   # MQ-GLIP-T's VLFuse at 800x1344
        bi_case(4, 22323, 256, 1024, 4, dual)   # MQ-GroundingDINO-T's encoder fusion at 800x1344
    levels_case(4, GLIP_800, 256, 2048, 8)      # MQ-GLIP-T's VLFuse under MQDET_FLASH_LEVELS=stream

    band_regs = kernels.ptxas_reports("msda_band_kernel")
    say(f"phase 2: msda_band_kernel ptxas reports (one per head width, as built) {band_regs}")
    if any(r["spill_stores"] or r["spill_loads"] or r["stack"] for r in band_regs):
        fail("msda_band_kernel spills registers or has a stack frame")

    def msda_case(name, b, q, lo, hi, nh=8, hd=32, p=4, impl=None, scale=2.0):
        """q None: encoder queries (Q = S), each sampling every level around
        its own cell centre with N(0, `scale` cells) offsets, so samples leave
        the image near the borders; q "edge": encoder queries whose samples
        lie on their windows' edges (exactly c - R or c + R + 1, or 0.25
        past them, clamped onto them; pairs without a window anywhere within
        2 pixels of the map); else Q decoder queries at uniform locations in
        [lo, hi) of every level. Under MQDET_MSDA_IMPL `impl` (None: unset):
        encoder queries take the clipped mode unless `gather`, against
        `ms_deform_attn_clipped_plain`; the rest the exact mode."""
        shapes = GDINO_800
        s = sum(h * w for h, w in shapes)
        value = torch.randn(b, s, nh, hd, generator=g, device=dev).bfloat16()
        if q == "edge":
            q = s
            bnd = ms.window_bounds(shapes, dev)
            loc = torch.empty(b, q, nh, len(shapes), p, 2, device=dev)
            past = 0.25 * (torch.arange(p, device=dev) % 2)
            for lv, (h, w) in enumerate(shapes):
                for axis, size, lo_, hi_ in ((0, w, bnd[lv, 2], bnd[lv, 3]), (1, h, bnd[lv, 0], bnd[lv, 1])):
                    side = torch.rand(b, q, nh, p, generator=g, device=dev) < 0.5
                    edge = torch.where(side, lo_[None, :, None, None] - past, hi_[None, :, None, None] + past)
                    anywhere = torch.rand(b, q, nh, p, generator=g, device=dev) * (size + 4) - 2
                    loc[:, :, :, lv, :, axis] = (torch.where(torch.isfinite(edge), edge, anywhere) + 0.5) / size
            where = "on the window edges"
        elif q is None:
            q = s
            ref = torch.cat([
                torch.stack(torch.meshgrid((torch.arange(w, device=dev) + 0.5) / w,
                                           (torch.arange(h, device=dev) + 0.5) / h, indexing="xy"), -1)
                .reshape(-1, 2) for h, w in shapes
            ])
            wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
            off = torch.randn(b, q, nh, len(shapes), p, 2, generator=g, device=dev) * scale
            loc = ref[None, :, None, None, None, :] + off / wh[None, None, None, :, None, :]
            where = f"own cell + N(0, {scale} cells)"
        else:
            loc = torch.rand(b, q, nh, len(shapes), p, 2, generator=g, device=dev) * (hi - lo) + lo
            where = f"uniform in [{lo}, {hi})"
        attn = torch.rand(b, q, nh, len(shapes), p, generator=g, device=dev)
        attn = attn / attn.sum(dim=(3, 4), keepdim=True)
        with switched("default", msda=impl):
            clip = ms.clips(value, shapes, loc)
            plain = ms.ms_deform_attn_clipped_plain if clip else ms.ms_deform_attn_plain
            counts = launch_counts()
            got = ms.ms_deform_attn(value, shapes, loc, attn)
            torch.cuda.synchronize()
            kernel = "ms_deform_attn_clip" if clip else "ms_deform_attn"
            if launch_counts()[kernel] != counts[kernel] + 1:
                fail(f"msda {name}: the call did not launch {kernel}")
            ref_out = plain(value.float(), shapes, loc, attn)
            err, scale = max_err(got, ref_out)
            del ref_out
            ms_ = cuda_time_ms(lambda: ms.ms_deform_attn(value, shapes, loc, attn))
            plain_ms = cuda_time_ms(lambda: plain(value, shapes, loc, attn))
        bnd = msda_bound(b, s, q, nh, hd, len(shapes), p)
        ok = bool(torch.isfinite(got).all()) and err <= ERR_BOUND * scale
        moved = f", the clip moves {clip_share(torch, shapes, loc)!r} of the sample points" if q == s else ""
        say(
            f"phase 2: msda {name} ({kernel}, MQDET_MSDA_IMPL {impl or 'unset'}): value {(b, s, nh, hd)} Q {q} "
            f"levels {shapes} P {p}, locations {where}{moved}: max_abs_err {err!r} (bound "
            f"{ERR_BOUND * scale!r} = {ERR_BOUND} * max|ref| {scale!r}); kernel {ms_!r} ms, plain bf16 "
            f"{plain_ms!r} ms, bound {bnd[0]!r} ms ({bnd[1]}); {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            fail(f"msda kernel disagrees with its plain version ({name})")
        record(kernel, f"{name} Q {q}", err, ms_, plain_ms, bnd)
        del value, loc, attn, got
        torch.cuda.empty_cache()

    msda_case("encoder", 4, None, None, None)                  # the clipped mode, the encoder's default
    msda_case("encoder far", 4, None, None, None, scale=12.0)  # the clip moves most points
    msda_case("encoder edge", 4, "edge", None, None)             # every sample on a window edge
    msda_case("decoder", 4, 900, 0.0, 1.0)                     # the exact mode, the decoder's
    # far: up to a whole map beyond each border, hundreds of cells from any
    # query, far past the TPU kernel's +-4 cell window
    msda_case("decoder far", 4, 900, -1.0, 2.0)
    msda_case("encoder", 4, None, None, None, impl="gather")   # the exact mode on encoder queries
    return results, sweep_launches


def compare_to_reference(torch, label, names, ref, plain16, card):
    """Relative L2 error of each card tensor against the fp32 reference,
    bounded by twice the plain bf16 path's error (floor E2E_FLOOR). Entries
    that are not finite in the reference (masked logits) must be so on the
    card too and are left out of the norms."""
    worst = (0.0, "", 0.0, 0.0)
    for name, r, p, c in zip(names, ref, plain16, card):
        fin = torch.isfinite(r)
        if not (torch.equal(torch.isfinite(c), fin) and torch.equal(torch.isfinite(p), fin)):
            fail(f"{label} {name}: non-finite entries differ from the fp32 reference")
        r, p, c = (torch.where(fin, x, torch.zeros_like(x)) for x in (r, p, c))
        err_plain = ((p - r).norm() / r.norm()).item()
        err_card = ((c - r).norm() / r.norm()).item()
        bound = max(2.0 * err_plain, E2E_FLOOR)
        worst = max(worst, (err_card / bound, name, err_card, err_plain))
        if not err_card <= bound:
            fail(f"{label} {name}: card vs fp32 relative L2 err {err_card!r} > bound {bound!r} "
                 f"(plain bf16 err {err_plain!r})")
    return worst


def phase_reference_glip(torch, cfg, model_cpu, model_gpu, seed):
    """Small input, same weights: the card's bf16 kernel path against the
    CPU's fp32 plain path, by relative L2 error ||x - ref|| / ||ref|| per
    FPN level and per level of dot-product logits. bf16 drifts from fp32
    through 12 BERT layers and 6 head stages whatever the kernels do, so the
    bound is calibrated by the CPU's plain path run in bf16: the card's error
    may be at most twice the plain bf16 error, or E2E_FLOOR, whichever is
    larger. A wrong kernel or layout gives errors of order 1. The card runs
    once under each fusion switch of SWITCHES (the concatenated pair, the
    streamed levels, the dual-score kernel) with MQDET_DEFORM_IMPL unset,
    and under the default fusion switches with MQDET_DEFORM_IMPL window and
    gather; each against the CPU reference of its DCN route (clipped, or
    exact for gather), taken under the default fusion switches. Where the
    fp32 model's offsets stay inside the radius, the clip changes nothing
    and the two routes' CPU references are the same computation, so it is
    taken once. Returns the launch counts of each card run."""
    from mqdet_torch.models.vldyhead import DyConv
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import synthetic_batch

    hw = (256, 256)
    batch = synthetic_batch(cfg, batch=1, image_hw=hw, num_labels=40, k_shot=5, seed=seed + 1)
    image = torch.from_numpy(batch["images"]).permute(0, 3, 1, 2).contiguous()
    text = [torch.from_numpy(batch[k]) for k in ("input_ids", "attention_mask", "queries", "query_mask")]

    def run(model, dev):
        """(FPN levels and logit levels, max |offset| of the DyConv offset convs)."""
        seen = []
        hooks = [m.offset.register_forward_hook(lambda mod, a, out: seen.append(out[:, :18].abs().amax()))
                 for m in model.modules() if isinstance(m, DyConv)]
        try:
            with torch.inference_mode():
                feats = model.encode_image(image.to(dev))
                out = model.forward_head(feats, *(t.to(dev) for t in text))
        finally:
            for h in hooks:
                h.remove()
        outs = [f.float().cpu() for f in feats] + [d.float().cpu() for d in out["dot_product_logits"]]
        return outs, float(torch.stack(seen).max())

    def reference():
        (ref, off32), (plain16, off16) = run(model_cpu, "cpu"), run(copy.deepcopy(model_cpu).to(torch.bfloat16), "cpu")
        return ref, plain16, max(off32, off16)

    radius = cfg.TPU.DEFORM_RADIUS
    with switched("default"):
        refs = {"clipped": reference()}
    max_off = refs["clipped"][2]
    if max_off <= radius:
        refs["exact"] = refs["clipped"]
    else:
        with switched("default", "gather"):
            refs["exact"] = reference()
    say(f"phase 3: MQ-GLIP-T full width, random init (seed {seed}) at {hw}: max |offset| {max_off!r} "
        f"(CPU, fp32 and bf16) against TPU.DEFORM_RADIUS {radius}: the clip "
        f"{'binds' if max_off > radius else 'does not bind; the exact and clipped CPU references are one run'}")
    names = [f"fpn{i}" for i in range(5)] + [f"logits{i}" for i in range(5)]
    # one VLFuse per head stage (under stream one launch per level); 3 * levels - 2 DCN calls per stage
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    fusion = {"default": {"bi_attention": stages}, "stream": {"bi_attention_levels": stages * levels},
              "dual": {"bi_attention_dual": stages}}
    launches = {}
    for switch, deform in [(sw, None) for sw in SWITCHES] + [("default", "window"), ("default", "gather")]:
        with switched(switch, deform):
            launch_counts(reset=True)
            card, _ = run(model_gpu, torch.device("cuda"))
            used = launch_counts()
        want = predicted(**fusion[switch], **{DEFORM_ROUTES[deform]: stages * (3 * levels - 2)})
        label = f"MQ-GLIP-T ({switch} fusion switches, MQDET_DEFORM_IMPL {deform or 'unset'})"
        if used != want:
            fail(f"{label}: launches {used} != predicted {want}")
        launches[f"MQ-GLIP-T reference {switch} {deform or 'unset'}"] = used
        ref, plain16, _ = refs["exact" if deform == "gather" else "clipped"]
        worst = compare_to_reference(torch, label, names, ref, plain16, card)
        said = {k: v for k, v in used.items() if v}
        say(
            f"phase 3: reference check, {label} full width at {hw}, card bf16 kernels vs CPU fp32 "
            f"plain on 5 FPN levels and 5 logit levels: worst err / bound {worst[0]!r} at {worst[1]} "
            f"(card relative L2 err {worst[2]!r}, plain bf16 {worst[3]!r}; bound max(2 * plain, "
            f"{E2E_FLOOR})); launches {said}; ok"
        )
    return launches


def phase_reference_gdino(torch, cfg, model_cpu, model_gpu, seed):
    """As phase_reference_glip for MQ-GroundingDINO-T, on the encoder's
    memory and text and on enc_logits (through `debug_outputs`): tensors
    before the top-900 selection, which bf16 may legitimately change. The
    overlap of the card's selection with the fp32 one is printed. The CPU
    runs under MQDET_MSDA_IMPL=pallas_interpret, so its encoder computes the
    clipped function that the card's default route (unset) launches; the
    share of encoder sample points the clip moves is printed. Returns the
    card run's launch counts."""
    import mqdet_torch.models.gdino as tg
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.ops import ms_deform_attn as ms
    from mqdet_torch.utils.builders import synthetic_caption_batch

    hw = (256, 256)
    batch = synthetic_caption_batch(cfg, batch=1, image_hw=hw, num_labels=40, k_shot=5, seed=seed + 1)
    image = torch.from_numpy(batch["images"]).permute(0, 3, 1, 2).contiguous()
    text = [torch.from_numpy(batch[k]) for k in ("input_ids", "attention_mask", "queries", "query_mask")]

    def run(model, dev):
        model.debug_outputs = True
        try:
            with torch.inference_mode():
                srcs = model.encode_image(image.to(dev))
                out = model.forward_head(srcs, *(t.to(dev) for t in text))
        finally:
            model.debug_outputs = False
        tensors = [out[k].float().cpu() for k in ("dbg_memory", "dbg_text", "enc_logits")]
        return tensors, out["dbg_topk_idx"].cpu()

    shares, sample = [], tg.ms_deform_attn

    def watched(value, shapes, loc, attn):
        if ms.is_encoder(value, shapes, loc):
            shares.append(clip_share(torch, shapes, loc))
        return sample(value, shapes, loc, attn)

    tg.ms_deform_attn = watched
    try:
        with switched("default", msda="pallas_interpret"):
            ref, ref_idx = run(model_cpu, "cpu")
            moved = list(shares)
            plain16, _ = run(copy.deepcopy(model_cpu).to(torch.bfloat16), "cpu")
    finally:
        tg.ms_deform_attn = sample
    g = cfg.GROUNDINGDINO
    with switched("default"):
        launch_counts(reset=True)
        card, card_idx = run(model_gpu, torch.device("cuda"))
        used = launch_counts()
    if (used["ms_deform_attn_clip"], used["ms_deform_attn"]) != (g.enc_layers, g.dec_layers):
        fail(f"MQ-GroundingDINO-T reference run: MSDA launches {used} (predicted {g.enc_layers} clipped, "
             f"{g.dec_layers} exact)")
    say(f"phase 3: MQ-GroundingDINO-T at {hw}, CPU under MQDET_MSDA_IMPL=pallas_interpret: the clip moves "
        f"{moved!r} of the encoder's sample points, layer by layer (fp32 run); card launches "
        f"{ {k: v for k, v in used.items() if v} }")
    worst = compare_to_reference(torch, "MQ-GroundingDINO-T", ("memory", "text", "enc_logits"),
                                 ref, plain16, card)
    overlap = len(set(ref_idx[0].tolist()) & set(card_idx[0].tolist()))
    say(
        f"phase 3: reference check, MQ-GroundingDINO-T full width at {hw}, card bf16 kernels vs CPU "
        f"fp32 plain on the encoder's memory and text and enc_logits: worst err / bound {worst[0]!r} "
        f"at {worst[1]} (card relative L2 err {worst[2]!r}, plain bf16 {worst[3]!r}; bound max(2 * "
        f"plain, {E2E_FLOOR})); top-{ref_idx.shape[1]} selections share {overlap} of "
        f"{ref_idx.shape[1]} indices; ok"
    )
    return used


FAMILIES = (
    ("dcn kernels", ("dcn_gather_kernel", "dcn_band_kernel")),
    ("bi-attention kernels", ("bi_attn_wgmma_kernel", "bi_attn_combine_kernel")),
    ("msda kernels", ("msda_forward_kernel", "msda_band_kernel")),
    ("convolutions", ("conv", "fprop", "implicit")),
    ("matmuls", ("gemm", "nvjet", "cutlass", "xmma")),
    ("copies", ("copy",)),
    ("norms", ("norm", "Moments")),
)


def phase_profile(torch, label, protocol, image, text):
    """One protocol run under torch.profiler: the device's busy time (union
    of kernel intervals), its share of the window from the first kernel's
    start to the last one's end, and kernel time by family. The profiler
    slows the host, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        protocol(image, *text)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        say(f"phase 5: {label}: the profiler recorded no device kernels; breakdown not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    fam = {}
    for e in kernels:
        key = next((f for f, pats in FAMILIES if any(p in e.name for p in pats)), "other")
        fam[key] = fam.get(key, 0.0) + e.time_range.end - e.time_range.start
    parts = ", ".join(f"{k} {v / 1000.0:.1f}" for k, v in sorted(fam.items(), key=lambda kv: -kv[1]))
    say(f"phase 5: {label} profiled protocol: device busy {busy / 1000.0!r} ms in a "
        f"{window / 1000.0!r} ms window (idle share {1.0 - busy / window!r}, profiler on); "
        f"{len(kernels)} kernels; kernel ms by family: {parts}")
    own = []
    for pat in (p for f, pats in FAMILIES[:3] for p in pats):
        us = [e.time_range.end - e.time_range.start for e in kernels if pat in e.name]
        if us:
            own.append(f"{pat} {sum(us) / 1000.0!r} ms in {len(us)} launches ({sum(us) / len(us) / 1000.0!r} each)")
    say(f"phase 5: {label} hand-written kernels: {'; '.join(own)}")


def phase_split(torch, label, protocol, image, text, parts):
    """One protocol run with a device synchronise before and after each
    module of `parts` ({name: [modules]}, none inside another): host-clock ms
    per name, and the rest (glue, heads and postprocess outside those
    modules). The synchronisations stop the host running ahead of the
    device, so the total exceeds the p50: the split says where the time
    goes, not how long the protocol takes."""
    spent = {name: 0.0 for name in parts}
    calls = {name: 0 for name in parts}
    start = {}

    def pre(mod, args):
        torch.cuda.synchronize()
        start[id(mod)] = time.perf_counter()

    def post(name):
        def hook(mod, args, out):
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - start[id(mod)]
            calls[name] += 1
        return hook

    handles = []
    for name, mods in parts.items():
        for m in mods:
            handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post(name))]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        protocol(image, *text)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for h in handles:
            h.remove()
    if not all(calls.values()):
        fail(f"{label}: split hooks on modules the protocol never called: {calls}")
    split = ", ".join(f"{k} {v * 1000.0!r} ({calls[k]} calls)" for k, v in spent.items())
    say(f"phase 6: {label} split by module (host clock, synchronised at module boundaries): total "
        f"{total * 1000.0!r} ms; ms by module: {split}, rest {(total - sum(spent.values())) * 1000.0!r}")


def predicted(**counts) -> dict:
    """Launch counts of one protocol run: `counts`, and 0 for every other kernel."""
    from mqdet_torch.ops import COUNTERS

    return {name: counts.get(name, 0) for name, _, _ in COUNTERS}


def phase_protocol(torch, label, model, cfg, make_batch, slots, want, runs, seed, parts=None,
                   switch="default", deform=None):
    """Phase 4 and 5 for one model under the fusion switches SWITCHES[switch]
    and MQDET_DEFORM_IMPL `deform` (None: unset), and phase 6 where `parts`
    is given; returns the launch counts of the counted protocol run (a name
    of `mqdet_torch.ops.COUNTERS` each)."""
    from mqdet_torch.engine.predict import make_protocol_fn
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import protocol_inputs

    label = label if switch == "default" else f"{label} {switch}"
    label = label if deform is None else f"{label} MQDET_DEFORM_IMPL={deform}"
    dev = torch.device("cuda")
    hw = (800, 1344)
    cp, groups = 4, -(-31 // 4)
    image, text = protocol_inputs(cfg, make_batch, groups, cp, hw, seed)
    image, text = image.to(dev), [t.to(dev) for t in text]
    protocol = make_protocol_fn(model, hw, cfg)
    with switched(switch, deform):
        torch.cuda.reset_peak_memory_stats()
        protocol(image, *text)  # warm-up
        torch.cuda.synchronize()

        launch_counts(reset=True)
        dets = protocol(image, *text)
        torch.cuda.synchronize()
        launches = launch_counts()
        shapes_ok = (
            tuple(dets.boxes.shape) == (groups, cp, slots, 4)
            and tuple(dets.scores.shape) == tuple(dets.labels.shape) == tuple(dets.valid.shape)
            == (groups, cp, slots)
        )
        finite = all(bool(torch.isfinite(t).all()) for t in (dets.boxes, dets.scores))
        n_valid = int(dets.valid.sum())
        labels_ok = bool(((dets.labels >= 0) & (dets.labels <= 40)).all())
        say(f"phase 4: {label} protocol launches {launches} (predicted {want}); shapes ok {shapes_ok}; "
            f"finite {finite}; labels in range {labels_ok}; valid detections {n_valid} of "
            f"{groups * cp * slots}")
        if launches != want:
            fail(f"{label}: launch counts {launches} != predicted {want}")
        if not (shapes_ok and finite and labels_ok):
            fail(f"{label}: protocol output malformed")

        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            protocol(image, *text)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        p50 = statistics.median(times)
        say(f"phase 4: {label} protocol p50 {p50 * 1000.0!r} ms over {runs} runs "
            f"(min {min(times) * 1000.0!r}, max {max(times) * 1000.0!r}); {1.0 / p50!r} img/s; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB")
        phase_profile(torch, label, protocol, image, text)
        if parts is not None:
            phase_split(torch, label, protocol, image, text, parts)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5, help="timed protocol runs per model")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a GPU")
    if not os.path.isdir(os.path.join(REPO, "mqdet_torch", "csrc")):
        fail("run from a checkout of the repository: mqdet_torch/ not found")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False

    from mqdet_torch.ops import kernels
    from mqdet_torch.tools import card
    from mqdet_torch.utils.builders import (
        build_model, init_params, mq_glip_t_config, mq_groundingdino_t_config, synthetic_batch,
        synthetic_caption_batch,
    )

    smi = card()
    t0 = time.perf_counter()
    kernels.lib()
    build_s = time.perf_counter() - t0
    say(smi)
    say(f"phase 1: card {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{len(kernels.sources())} kernel sources built from mqdet_torch/csrc for sm_90a in "
        f"{build_s!r} s ({os.path.basename(kernels.library_path())})")

    kres, sweep_launches = phase_kernels(torch, args.seed)
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    torch.set_num_threads(os.cpu_count() or 1)
    launches = {"perf_dcn_sweep": sweep_launches}

    # ---- MQ-GLIP-T -------------------------------------------------------
    cfg = mq_glip_t_config()
    cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 300
    model_cpu = init_params(build_model(cfg), seed=args.seed).eval()
    model = copy.deepcopy(model_cpu).to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    launches.update(phase_reference_glip(torch, cfg, model_cpu, model, args.seed))
    del model_cpu
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    groups = -(-31 // 4)
    dcn, fuse = groups * stages * (3 * levels - 2), groups * stages
    tower = model.rpn.head.dyhead_tower
    parts = {"image tower": [model.backbone.body, model.backbone.fpn], "language tower": [model.language_backbone],
             "VLFuse": list(tower[0::3]), "head BERT layers": list(tower[1::3]), "DyConv": list(tower[2::3])}
    # default last: its phase 6 (synchronised split) ends a model's runs, because
    # protocols timed right after it read 7-24% slower with the same device busy time
    for switch, deform, want in (
        ("stream", None, predicted(dcn_band=dcn, bi_attention_levels=fuse * levels)),  # one launch per level
        ("dual", None, predicted(dcn_band=dcn, bi_attention_dual=fuse)),
        ("default", "window", predicted(dcn_gather_clip=dcn, bi_attention=fuse)),  # K2 in the protocol
        ("default", "gather", predicted(dcn=dcn, bi_attention=fuse)),  # the exact mode in the protocol
        ("default", None, predicted(dcn_band=dcn, bi_attention=fuse)),
    ):
        launches[f"MQ-GLIP-T {switch}{' ' + deform if deform else ''}"] = phase_protocol(
            torch, "MQ-GLIP-T", model, cfg, synthetic_batch, 300, want, args.runs, args.seed,
            parts if switch == "default" and deform is None else None, switch, deform,
        )
    del model, tower, parts  # nothing of MQ-GLIP-T may stay on the card
    torch.cuda.empty_cache()

    # ---- MQ-GroundingDINO-T ----------------------------------------------
    cfg = mq_groundingdino_t_config()
    g = cfg.GROUNDINGDINO
    model_cpu = init_params(build_model(cfg), seed=args.seed).eval()
    model = copy.deepcopy(model_cpu).to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    launches["MQ-GroundingDINO-T reference"] = phase_reference_gdino(torch, cfg, model_cpu, model, args.seed)
    del model_cpu
    enc, dec, fuse = groups * g.enc_layers, groups * g.dec_layers, groups * g.enc_layers
    tr = model.transformer
    parts = {"image tower": [model.backbone[0], *model.input_proj], "BERT": [model.bert],
             "fusion": list(tr.encoder.fusion_layers), "text enhancer": list(tr.encoder.text_layers),
             "encoder deformable layers": list(tr.encoder.layers), "decoder layers": list(tr.decoder.layers),
             "bbox heads": list(model.bbox_embed),
             "two-stage heads": [tr.enc_output, tr.enc_output_norm, tr.enc_out_bbox_embed]}
    # the fusion takes one flattened tensor, so MQDET_FLASH_LEVELS does not apply
    for switch, want in (
        ("dual", predicted(ms_deform_attn_clip=enc, ms_deform_attn=dec, bi_attention_dual=fuse)),
        ("default", predicted(ms_deform_attn_clip=enc, ms_deform_attn=dec, bi_attention=fuse)),
    ):
        launches[f"MQ-GroundingDINO-T {switch}"] = phase_protocol(
            torch, "MQ-GroundingDINO-T", model, cfg, synthetic_caption_batch, g.num_queries, want,
            args.runs, args.seed, parts if switch == "default" else None, switch,
        )
    del model, tr, parts

    say(f"wall time {time.perf_counter() - t_start!r} s (build included)")
    entries = []
    for name, source, replaces in KERNELS:
        cases = kres[name]
        main_case = cases[0]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(per_path[name] for per_path in launches.values()),
            "launches_by_path": {path: per_path[name] for path, per_path in launches.items() if per_path[name]},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "cases": cases,
        })
        if not entries[-1]["launches"]:
            fail(f"{name}: no counted path launched it")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
