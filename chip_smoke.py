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
     against the bound 2e-2 * max|ref|, and the median time of 10 runs of
     the kernel and of the plain version (bf16, same inputs), CUDA events.
     DCN at the GLIP levels; bi-attention at GLIP's (4, 22400, 2048) with 8
     heads and GroundingDINO's (4, 22323, 1024) with 4 heads, T 256; MSDA at
     the 800x1344 GroundingDINO pyramid (100x168, 50x84, 25x42, 13x21; 8
     heads of 32, 4 levels x 4 points, B 4) for encoder queries (Q = S),
     decoder queries (Q = 900) and locations far outside the TPU kernel's
     +-4 cell window and off the image;
  3. per model, a small-input reference check: the full-width model on a
     256x256 image, one chunk, on the card (bf16, kernels) against the same
     weights in fp32 on the CPU (plain versions), by relative L2 error within
     twice the drift of the plain path run in bf16 on the CPU (or 1e-2 where
     that is larger). MQ-GLIP-T: FPN features and dot-product logits.
     MQ-GroundingDINO-T: the encoder's memory and text and the two-stage
     logits (`enc_logits`), taken before the top-900 selection, whose
     overlap with the fp32 selection is printed;
  4. per model, the LVIS protocol as bench.py runs it: full width from
     init_params(seed), one 800x1344 image, 8 groups x CP 4 chunks of 40
     labels x 5 queries, T = 256, through make_protocol_fn. The launch
     counters, set to 0 just before one protocol run, must equal the
     prediction: MQ-GLIP-T 624 DCN and 48 bi-attention launches (13 DCN
     calls and one bi-attention per head stage, 6 stages, 8 groups);
     MQ-GroundingDINO-T 96 MSDA (6 encoder + 6 decoder layers, 8 groups) and
     48 bi-attention (one per encoder layer). Every output must be finite
     and of the right shape. Then p50 over --runs timed runs and the peak
     device memory of the protocol;
  5. per model, one protocol run under torch.profiler: device busy time,
     idle share, kernel time by family and the time and launches of each
     hand-written kernel;
  6. per model, one protocol run with a device synchronise at the
     boundaries of its main modules (forward hooks): host-clock ms per
     module.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
without those lines.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ERR_BOUND = 2e-2      # kernel vs fp32 plain, relative to max|ref| (bf16 in/out)
E2E_FLOOR = 1e-2      # whole network: floor of the bf16-vs-fp32 relative L2 bound
KERNELS = (  # name, source, the TPU kernel it replaces
    ("dcn", "mqdet_torch/csrc/deform_conv.cu", "mqdet_tpu/ops/pallas/deform_conv_pallas.py:561"),
    ("bi_attention", "mqdet_torch/csrc/bi_attention.cu", "mqdet_tpu/ops/pallas/bi_attention_pallas.py:384"),
    ("ms_deform_attn", "mqdet_torch/csrc/ms_deform_attn.cu", "mqdet_tpu/ops/pallas/msda_pallas.py:455"),
)
GDINO_800 = [(100, 168), (50, 84), (25, 42), (13, 21)]  # the 800x1344 pyramid


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, ref) -> tuple:
    """(max |got - ref|, max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, ref.abs().max().item()


def phase_kernels(torch, seed):
    """Returns {kernel: [(case, max_abs_err, ms, plain_ms), ...]}, main case first."""
    from mqdet_torch.ops import bi_attention as ba
    from mqdet_torch.ops import deform_conv as dc
    from mqdet_torch.ops import ms_deform_attn as ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    results = {"dcn": [], "bi_attention": [], "ms_deform_attn": []}

    def dcn_case(b, h, w, c, stride):
        ho, wo = -(-h // stride), -(-w // stride)
        x = torch.randn(b, h, w, c, generator=g, device=dev).bfloat16()
        # offsets reach well beyond the TPU kernel's +-2 px window
        off = (torch.randn(b, ho, wo, 18, generator=g, device=dev) * 3.0).bfloat16()
        mask = torch.rand(b, ho, wo, 9, generator=g, device=dev).bfloat16()
        wt = (torch.randn(3, 3, c, c, generator=g, device=dev) * 0.03).bfloat16()
        bias = (torch.randn(c, generator=g, device=dev) * 0.1).bfloat16()
        args = (x, off, mask, wt, bias)
        got = dc.modulated_deform_conv(*args, stride=stride)
        torch.cuda.synchronize()
        ref = dc.modulated_deform_conv_plain(*(a.float() for a in args), stride=stride)
        err, scale = max_err(got, ref)
        del ref
        ms_ = cuda_time_ms(lambda: dc.modulated_deform_conv(*args, stride=stride))
        plain_ms = cuda_time_ms(lambda: dc.modulated_deform_conv_plain(*args, stride=stride))
        ok = bool(torch.isfinite(got).all()) and err <= ERR_BOUND * scale
        say(
            f"phase 2: dcn x{(b, h, w, c)} stride {stride} -> {(ho, wo)}: max_abs_err {err!r} "
            f"(bound {ERR_BOUND * scale!r} = {ERR_BOUND} * max|ref| {scale!r}); "
            f"kernel {ms_!r} ms, plain bf16 {plain_ms!r} ms; {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            fail(f"dcn kernel disagrees with its plain version at {(b, h, w, c, stride)}")
        results["dcn"].append((f"x{(b, h, w, c)} s{stride}", err, ms_, plain_ms))

    dcn_case(4, 100, 168, 256, 1)
    dcn_case(4, 100, 168, 256, 2)
    dcn_case(4, 7, 11, 256, 1)

    def bi_case(b, n, t, e, heads):
        q = (torch.randn(b, n, e, generator=g, device=dev) * (e // heads) ** -0.5).bfloat16()
        k = torch.randn(b, t, e, generator=g, device=dev).bfloat16()
        vv = torch.randn(b, n, e, generator=g, device=dev).bfloat16()
        vl = torch.randn(b, t, e, generator=g, device=dev).bfloat16()
        keep = torch.ones(b, t, dtype=torch.bool, device=dev)
        keep[:, 200:] = False  # padded text tail
        keep[1, 120:] = False
        bias = torch.where(keep, 0.0, -9e15).float()
        args = (q, k, vv, vl, bias)
        ov, ol = ba.flash_bi_attention(*args, num_heads=heads)
        torch.cuda.synchronize()
        rv, rl = ba.bi_attention_plain(*(a.float() for a in args[:4]), bias, num_heads=heads)
        errs = [max_err(ov, rv), max_err(ol, rl)]
        del rv, rl
        ms_ = cuda_time_ms(lambda: ba.flash_bi_attention(*args, num_heads=heads))
        plain_ms = cuda_time_ms(lambda: ba.bi_attention_plain(*args, num_heads=heads))
        ok = all(err <= ERR_BOUND * scale for err, scale in errs) and bool(
            torch.isfinite(ov).all() and torch.isfinite(ol).all()
        )
        say(
            f"phase 2: bi-attention q/vv {(b, n, e)} T {t} heads {heads}: max_abs_err out_v "
            f"{errs[0][0]!r} (bound {ERR_BOUND * errs[0][1]!r}), out_l {errs[1][0]!r} "
            f"(bound {ERR_BOUND * errs[1][1]!r}); kernel {ms_!r} ms, plain bf16 {plain_ms!r} ms; "
            f"{'ok' if ok else 'FAIL'}"
        )
        if not ok:
            fail(f"bi-attention kernel disagrees with its plain version at {(b, n, t, e, heads)}")
        results["bi_attention"].append(
            (f"q/vv {(b, n, e)} T {t} heads {heads}", max(errs[0][0], errs[1][0]), ms_, plain_ms)
        )
        del q, k, vv, vl, ov, ol
        torch.cuda.empty_cache()

    bi_case(4, 22400, 256, 2048, 8)   # MQ-GLIP-T's VLFuse at 800x1344
    bi_case(4, 22323, 256, 1024, 4)   # MQ-GroundingDINO-T's encoder fusion at 800x1344

    def msda_case(name, b, q, lo, hi, nh=8, hd=32, p=4):
        """q None: encoder queries (Q = S), each sampling every level around
        its own cell centre with N(0, 2 cells) offsets, so samples leave the
        image near the borders; else Q decoder queries at uniform locations
        in [lo, hi) of every level."""
        shapes = GDINO_800
        s = sum(h * w for h, w in shapes)
        value = torch.randn(b, s, nh, hd, generator=g, device=dev).bfloat16()
        if q is None:
            q = s
            ref = torch.cat([
                torch.stack(torch.meshgrid((torch.arange(w, device=dev) + 0.5) / w,
                                           (torch.arange(h, device=dev) + 0.5) / h, indexing="xy"), -1)
                .reshape(-1, 2) for h, w in shapes
            ])
            wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
            off = torch.randn(b, q, nh, len(shapes), p, 2, generator=g, device=dev) * 2.0
            loc = ref[None, :, None, None, None, :] + off / wh[None, None, None, :, None, :]
            where = "own cell + N(0, 2 cells)"
        else:
            loc = torch.rand(b, q, nh, len(shapes), p, 2, generator=g, device=dev) * (hi - lo) + lo
            where = f"uniform in [{lo}, {hi})"
        attn = torch.rand(b, q, nh, len(shapes), p, generator=g, device=dev)
        attn = attn / attn.sum(dim=(3, 4), keepdim=True)
        got = ms.ms_deform_attn(value, shapes, loc, attn)
        torch.cuda.synchronize()
        ref_out = ms.ms_deform_attn_plain(value.float(), shapes, loc, attn)
        err, scale = max_err(got, ref_out)
        del ref_out
        ms_ = cuda_time_ms(lambda: ms.ms_deform_attn(value, shapes, loc, attn))
        plain_ms = cuda_time_ms(lambda: ms.ms_deform_attn_plain(value, shapes, loc, attn))
        ok = bool(torch.isfinite(got).all()) and err <= ERR_BOUND * scale
        say(
            f"phase 2: msda {name}: value {(b, s, nh, hd)} Q {q} levels {shapes} P {p}, locations "
            f"{where}: max_abs_err {err!r} (bound {ERR_BOUND * scale!r} = {ERR_BOUND} * max|ref| "
            f"{scale!r}); kernel {ms_!r} ms, plain bf16 {plain_ms!r} ms; {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            fail(f"msda kernel disagrees with its plain version ({name})")
        results["ms_deform_attn"].append((f"{name} Q {q}", err, ms_, plain_ms))
        del value, loc, attn, got
        torch.cuda.empty_cache()

    msda_case("encoder", 4, None, None, None)
    msda_case("decoder", 4, 900, 0.0, 1.0)
    # far: up to a whole map beyond each border, hundreds of cells from any
    # query, far past the TPU kernel's +-4 cell window
    msda_case("decoder far", 4, 900, -1.0, 2.0)
    return results


def make_text(torch, make_batch, cfg, groups, cp, hw, seed):
    batch = make_batch(cfg, batch=cp, image_hw=hw, num_labels=40, k_shot=5, seed=seed)
    image = torch.from_numpy(batch["images"][:1]).permute(0, 3, 1, 2).contiguous()

    def grp(key):  # the same chunk inputs in every group, as bench.py does
        x = torch.from_numpy(batch[key])
        return x[None].expand(groups, *x.shape).contiguous()

    keys = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map", "image_sizes")
    return image, [grp(k) for k in keys]


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
    larger. A wrong kernel or layout gives errors of order 1."""
    from mqdet_torch.utils.builders import synthetic_batch

    hw = (256, 256)
    batch = synthetic_batch(cfg, batch=1, image_hw=hw, num_labels=40, k_shot=5, seed=seed + 1)
    image = torch.from_numpy(batch["images"]).permute(0, 3, 1, 2).contiguous()
    text = [torch.from_numpy(batch[k]) for k in ("input_ids", "attention_mask", "queries", "query_mask")]

    def run(model, dev):
        with torch.inference_mode():
            feats = model.encode_image(image.to(dev))
            out = model.forward_head(feats, *(t.to(dev) for t in text))
        return [f.float().cpu() for f in feats] + [d.float().cpu() for d in out["dot_product_logits"]]

    ref = run(model_cpu, "cpu")
    plain16 = run(copy.deepcopy(model_cpu).to(torch.bfloat16), "cpu")
    card = run(model_gpu, torch.device("cuda"))
    names = [f"fpn{i}" for i in range(5)] + [f"logits{i}" for i in range(5)]
    worst = compare_to_reference(torch, "MQ-GLIP-T", names, ref, plain16, card)
    say(
        f"phase 3: reference check, MQ-GLIP-T full width at {hw}, card bf16 kernels vs CPU fp32 "
        f"plain on 5 FPN levels and 5 logit levels: worst err / bound {worst[0]!r} at {worst[1]} "
        f"(card relative L2 err {worst[2]!r}, plain bf16 {worst[3]!r}; bound max(2 * plain, "
        f"{E2E_FLOOR})); ok"
    )


def phase_reference_gdino(torch, cfg, model_cpu, model_gpu, seed):
    """As phase_reference_glip for MQ-GroundingDINO-T, on the encoder's
    memory and text and on enc_logits (through `debug_outputs`): tensors
    before the top-900 selection, which bf16 may legitimately change. The
    overlap of the card's selection with the fp32 one is printed."""
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

    ref, ref_idx = run(model_cpu, "cpu")
    plain16, _ = run(copy.deepcopy(model_cpu).to(torch.bfloat16), "cpu")
    card, card_idx = run(model_gpu, torch.device("cuda"))
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


FAMILIES = (
    ("dcn kernel", ("dcn_forward_kernel",)),
    ("bi-attention kernels", ("bi_attn_v_kernel", "bi_attn_l_kernel")),
    ("msda kernel", ("msda_forward_kernel",)),
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


def phase_protocol(torch, label, model, cfg, make_batch, slots, want, runs, seed, parts):
    """Phases 4, 5 and 6 for one model; returns the launch counts of the
    counted protocol run."""
    from mqdet_torch.engine.predict import make_protocol_fn
    from mqdet_torch.ops import bi_attention, deform_conv, ms_deform_attn

    counters = {"dcn": deform_conv, "bi_attention": bi_attention, "ms_deform_attn": ms_deform_attn}
    dev = torch.device("cuda")
    hw = (800, 1344)
    cp, groups = 4, -(-31 // 4)
    image, text = make_text(torch, make_batch, cfg, groups, cp, hw, seed)
    image, text = image.to(dev), [t.to(dev) for t in text]
    protocol = make_protocol_fn(model, hw, cfg)
    torch.cuda.reset_peak_memory_stats()
    protocol(image, *text)  # warm-up
    torch.cuda.synchronize()

    for mod in counters.values():
        mod.launch_count = 0
    dets = protocol(image, *text)
    torch.cuda.synchronize()
    launches = {k: mod.launch_count for k, mod in counters.items()}
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
    from mqdet_torch.utils.builders import (
        build_model, init_params, mq_glip_t_config, mq_groundingdino_t_config, synthetic_batch,
        synthetic_caption_batch,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernels.lib()
    build_s = time.perf_counter() - t0
    say(smi)
    say(f"phase 1: card {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{len(kernels.sources())} kernel sources built from mqdet_torch/csrc for sm_90a in "
        f"{build_s!r} s ({os.path.basename(kernels.library_path())})")

    kres = phase_kernels(torch, args.seed)
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    torch.set_num_threads(os.cpu_count() or 1)
    launches = {}

    # ---- MQ-GLIP-T -------------------------------------------------------
    cfg = mq_glip_t_config()
    cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 300
    model_cpu = init_params(build_model(cfg), seed=args.seed).eval()
    model = copy.deepcopy(model_cpu).to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    phase_reference_glip(torch, cfg, model_cpu, model, args.seed)
    del model_cpu
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    groups = -(-31 // 4)
    want = {"dcn": groups * stages * (3 * levels - 2), "bi_attention": groups * stages, "ms_deform_attn": 0}
    tower = model.rpn.head.dyhead_tower
    parts = {"image tower": [model.backbone.body, model.backbone.fpn], "language tower": [model.language_backbone],
             "VLFuse": list(tower[0::3]), "head BERT layers": list(tower[1::3]), "DyConv": list(tower[2::3])}
    launches["MQ-GLIP-T"] = phase_protocol(
        torch, "MQ-GLIP-T", model, cfg, synthetic_batch, 300, want, args.runs, args.seed, parts
    )
    del model, tower, parts  # nothing of MQ-GLIP-T may stay on the card
    torch.cuda.empty_cache()

    # ---- MQ-GroundingDINO-T ----------------------------------------------
    cfg = mq_groundingdino_t_config()
    g = cfg.GROUNDINGDINO
    model_cpu = init_params(build_model(cfg), seed=args.seed).eval()
    model = copy.deepcopy(model_cpu).to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    phase_reference_gdino(torch, cfg, model_cpu, model, args.seed)
    del model_cpu
    want = {"dcn": 0, "bi_attention": groups * g.enc_layers,
            "ms_deform_attn": groups * (g.enc_layers + g.dec_layers)}
    tr = model.transformer
    parts = {"image tower": [model.backbone[0], *model.input_proj], "BERT": [model.bert],
             "fusion": list(tr.encoder.fusion_layers), "text enhancer": list(tr.encoder.text_layers),
             "encoder deformable layers": list(tr.encoder.layers), "decoder layers": list(tr.decoder.layers),
             "bbox heads": list(model.bbox_embed),
             "two-stage heads": [tr.enc_output, tr.enc_output_norm, tr.enc_out_bbox_embed]}
    launches["MQ-GroundingDINO-T"] = phase_protocol(
        torch, "MQ-GroundingDINO-T", model, cfg, synthetic_caption_batch, g.num_queries, want,
        args.runs, args.seed, parts,
    )
    del model, tr, parts

    say(f"wall time {time.perf_counter() - t_start!r} s (build included)")
    entries = []
    for name, source, replaces in KERNELS:
        cases = kres[name]
        _, _, ms, plain_ms = cases[0]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(per_path[name] for per_path in launches.values()),
            "launches_by_path": {path: per_path[name] for path, per_path in launches.items()},
            "max_abs_err": max(c[1] for c in cases), "ms": ms, "plain_ms": plain_ms,
            "cases": [{"case": c, "max_abs_err": e, "ms": t, "plain_ms": pt} for c, e, t, pt in cases],
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
