#!/usr/bin/env python3
"""Smoke run of the mqdet_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N] [--runs N]

Run from the root of a checkout. It needs a CUDA device and the CUDA toolkit
(`nvcc`); it imports nothing of JAX. Phases, each printing one line:

  1. the card (`nvidia-smi` name and power limit) and the kernels' build from
     `mqdet_torch/csrc/` with nvcc for sm_90a;
  2. each hand-written kernel against its plain PyTorch version (run in fp32)
     at the main path's shapes, bf16 inputs from the seed: max abs error
     against the bound 2e-2 * max|ref|, and the median time of 10 runs of
     the kernel and of the plain version (bf16, same inputs), CUDA events;
  3. a small-input reference check: MQ-GLIP-T at full width on a 256x256
     image, one chunk, on the card (bf16, kernels) against the same weights
     in fp32 on the CPU (plain versions): FPN features and dot-product
     logits within twice the relative L2 drift of the plain path run in
     bf16 on the CPU (or 1e-2 where that is larger);
  4. the LVIS protocol as bench.py runs it: MQ-GLIP-T at full width from
     init_params(seed), one 800x1344 image, 8 groups x CP 4 chunks of 40
     labels x 5 queries, T = 256, DETECTIONS_PER_IMG = 300, through
     make_protocol_fn. The launch counters, reset just before one protocol
     run, must show 624 DCN and 48 bi-attention launches (13 DCN calls and
     one bi-attention per stage, 6 stages, 8 groups); every output must be
     finite and of the right shape. Then p50 over --runs timed runs;
  5. one protocol run under torch.profiler: device busy time, idle share
     and kernel time by family.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
without that line.
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
DCN_REPLACES = "mqdet_tpu/ops/pallas/deform_conv_pallas.py:561"
BI_REPLACES = "mqdet_tpu/ops/pallas/bi_attention_pallas.py:384"


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
    from mqdet_torch.ops import bi_attention as ba
    from mqdet_torch.ops import deform_conv as dc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    results = {}

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
        ms = cuda_time_ms(lambda: dc.modulated_deform_conv(*args, stride=stride))
        plain_ms = cuda_time_ms(lambda: dc.modulated_deform_conv_plain(*args, stride=stride))
        ok = bool(torch.isfinite(got).all()) and err <= ERR_BOUND * scale
        say(
            f"phase 2: dcn x{(b, h, w, c)} stride {stride} -> {(ho, wo)}: max_abs_err {err!r} "
            f"(bound {ERR_BOUND * scale!r} = {ERR_BOUND} * max|ref| {scale!r}); "
            f"kernel {ms!r} ms, plain bf16 {plain_ms!r} ms; {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            fail(f"dcn kernel disagrees with its plain version at {(b, h, w, c, stride)}")
        return err, ms, plain_ms

    dcn = [dcn_case(4, 100, 168, 256, 1), dcn_case(4, 100, 168, 256, 2), dcn_case(4, 7, 11, 256, 1)]
    results["dcn"] = (max(d[0] for d in dcn), dcn[0][1], dcn[0][2])

    b, n, t, e, heads = 4, 22400, 256, 2048, 8
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
    ms = cuda_time_ms(lambda: ba.flash_bi_attention(*args, num_heads=heads))
    plain_ms = cuda_time_ms(lambda: ba.bi_attention_plain(*args, num_heads=heads))
    ok = all(err <= ERR_BOUND * scale for err, scale in errs) and bool(
        torch.isfinite(ov).all() and torch.isfinite(ol).all()
    )
    say(
        f"phase 2: bi-attention q/vv {(b, n, e)} T {t} heads {heads}: max_abs_err out_v "
        f"{errs[0][0]!r} (bound {ERR_BOUND * errs[0][1]!r}), out_l {errs[1][0]!r} "
        f"(bound {ERR_BOUND * errs[1][1]!r}); kernel {ms!r} ms, plain bf16 {plain_ms!r} ms; "
        f"{'ok' if ok else 'FAIL'}"
    )
    if not ok:
        fail("bi-attention kernel disagrees with its plain version")
    results["bi_attention"] = (max(errs[0][0], errs[1][0]), ms, plain_ms)
    return results


def make_text(torch, cfg, groups, cp, hw, seed):
    from mqdet_torch.utils.builders import synthetic_batch

    batch = synthetic_batch(cfg, batch=cp, image_hw=hw, num_labels=40, k_shot=5, seed=seed)
    image = torch.from_numpy(batch["images"][:1]).permute(0, 3, 1, 2).contiguous()

    def grp(key):  # the same chunk inputs in every group, as bench.py does
        x = torch.from_numpy(batch[key])
        return x[None].expand(groups, *x.shape).contiguous()

    keys = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map", "image_sizes")
    return image, [grp(k) for k in keys]


def phase_reference(torch, cfg, model_cpu, model_gpu, seed):
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
    worst = (0.0, "", 0.0, 0.0)
    for name, r, p, c in zip(names, ref, plain16, card):
        err_plain = ((p - r).norm() / r.norm()).item()
        err_card = ((c - r).norm() / r.norm()).item()
        bound = max(2.0 * err_plain, E2E_FLOOR)
        worst = max(worst, (err_card / bound, name, err_card, err_plain))
        if not (err_card <= bound and bool(torch.isfinite(c).all())):
            fail(f"{name}: card vs fp32 relative L2 err {err_card!r} > bound {bound!r} "
                 f"(plain bf16 err {err_plain!r})")
    say(
        f"phase 3: reference check, MQ-GLIP-T full width at {hw}, card bf16 kernels vs CPU fp32 "
        f"plain on 5 FPN levels and 5 logit levels: worst err / bound {worst[0]!r} at {worst[1]} "
        f"(card relative L2 err {worst[2]!r}, plain bf16 {worst[3]!r}; bound max(2 * plain, "
        f"{E2E_FLOOR})); ok"
    )


FAMILIES = (
    ("dcn kernel", ("dcn_forward_kernel",)),
    ("bi-attention kernels", ("bi_attn_v_kernel", "bi_attn_l_kernel")),
    ("convolutions", ("conv", "fprop", "implicit")),
    ("matmuls", ("gemm", "nvjet", "cutlass", "xmma")),
    ("copies", ("copy",)),
    ("norms", ("norm", "Moments")),
)


def phase_profile(torch, protocol, image, text):
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
        say("phase 5: the profiler recorded no device kernels; breakdown not measured")
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
    say(f"phase 5: profiled protocol: device busy {busy / 1000.0!r} ms in a {window / 1000.0!r} ms "
        f"window (idle share {1.0 - busy / window!r}, profiler on); {len(kernels)} kernels; "
        f"kernel ms by family: {parts}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5, help="timed protocol runs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a GPU")
    if not os.path.isdir(os.path.join(REPO, "mqdet_torch", "csrc")):
        fail("run from a checkout of the repository: mqdet_torch/ not found")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False

    from mqdet_torch.engine.predict import make_protocol_fn
    from mqdet_torch.ops import bi_attention as ba
    from mqdet_torch.ops import deform_conv as dc
    from mqdet_torch.ops import kernels
    from mqdet_torch.utils.builders import build_model, init_params, mq_glip_t_config

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernels.lib()
    build_s = time.perf_counter() - t0
    say(smi)
    say(f"phase 1: card {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"kernels built from mqdet_torch/csrc for sm_90a in {build_s!r} s "
        f"({os.path.basename(kernels.library_path())})")

    kres = phase_kernels(torch, args.seed)
    torch.cuda.empty_cache()

    cfg = mq_glip_t_config()
    cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 300
    model_cpu = init_params(build_model(cfg), seed=args.seed).eval()
    dev = torch.device("cuda")
    model = copy.deepcopy(model_cpu).to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    torch.set_num_threads(os.cpu_count() or 1)
    phase_reference(torch, cfg, model_cpu, model, args.seed)
    del model_cpu

    hw = (800, 1344)
    cp, groups = 4, -(-31 // 4)
    image, text = make_text(torch, cfg, groups, cp, hw, args.seed)
    image, text = image.to(dev), [t.to(dev) for t in text]
    protocol = make_protocol_fn(model, hw, cfg)
    protocol(image, *text)  # warm-up
    torch.cuda.synchronize()

    dc.launch_count = 0
    ba.launch_count = 0
    dets = protocol(image, *text)
    torch.cuda.synchronize()
    launches = {"dcn": dc.launch_count, "bi_attention": ba.launch_count}
    stages = cfg.MODEL.DYHEAD.NUM_CONVS
    levels = len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    want = {"dcn": groups * stages * (3 * levels - 2), "bi_attention": groups * stages}
    shapes_ok = (
        tuple(dets.boxes.shape) == (groups, cp, 300, 4)
        and tuple(dets.scores.shape) == tuple(dets.labels.shape) == tuple(dets.valid.shape) == (groups, cp, 300)
    )
    finite = all(bool(torch.isfinite(t).all()) for t in (dets.boxes, dets.scores))
    n_valid = int(dets.valid.sum())
    labels_ok = bool(((dets.labels >= 0) & (dets.labels <= 40)).all())
    say(f"phase 4: protocol launches {launches} (predicted {want}); shapes ok {shapes_ok}; "
        f"finite {finite}; labels in range {labels_ok}; valid detections {n_valid} of {groups * cp * 300}")
    if launches != want:
        fail(f"launch counts {launches} != predicted {want}")
    if not (shapes_ok and finite and labels_ok):
        fail("protocol output malformed")

    times = []
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        protocol(image, *text)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    say(f"phase 4: protocol p50 {p50 * 1000.0!r} ms over {args.runs} runs "
        f"(min {min(times) * 1000.0!r}, max {max(times) * 1000.0!r}); {1.0 / p50!r} img/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB")

    phase_profile(torch, protocol, image, text)

    entries = []
    for name, source, replaces in (
        ("dcn", "mqdet_torch/csrc/deform_conv.cu", DCN_REPLACES),
        ("bi_attention", "mqdet_torch/csrc/bi_attention.cu", BI_REPLACES),
    ):
        err, ms, plain_ms = kres[name]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
