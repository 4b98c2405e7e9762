"""Device time of the MQ-GLIP-T LVIS protocol by kernel, from a profiler
trace (the port of `tools/perf_trace.py`).

    python -m mqdet_torch.tools.perf_trace [--cp CP] [--iters ITERS]
    python -m mqdet_torch.tools.perf_trace --device cpu --tiny

It builds the protocol as bench.py does (`tools.glip_t`: one 800x1344 image,
ceil(31 / CP) groups of CP chunks of 40 labels x 5 queries, seed 0), runs it
twice to warm up, then ITERS times (default 3) under `torch.profiler` with
the CUDA activity alone (the CPU ops' events cost ~20 s of host time a run
and nothing reads them; on the CPU, `--device cpu`, the CPU ops instead).
Each kernel's device time goes to its family: the kernel's name without
`void `, `(anonymous namespace)::`, template arguments, call arguments and
trailing numbering. It
prints one JSON line per family for the 30 largest (`op`, `total_ms`,
`per_call_ms` (per protocol run), `count`, `hint`: the first full name), one
per kernel instance for the 25 largest (`instance`, `per_call_ms`, `count`),
and a summary: `device_total_ms` (the sum of every kernel's time, which the
families' totals sum to), `per_protocol_ms`, `iters`, and the window's
`busy_ms` (the union of the kernels' intervals), `window_ms` (first kernel's
start to last one's end) and `idle_share` (profiler on, so an upper bound).

`trace(fn, iters, cuda)` profiles any call; `report(events, iters)` is the
aggregation; chip_smoke.py's phase 5 calls both on both families'
protocols. `CLASSES` groups the families into phase 5's classes (the
hand-written kernels, convolutions, matmuls, ...).

    python -m mqdet_torch.tools.perf_trace --spans SECONDS [--batch B]

runs the protocol (with `--batch`, the image-batched one at B images) with
the program's tracer on (`utils.profiling`) for SECONDS of calls back to
back and prints one line per call (`span_window`: host ms to the call's
fence, each span's host ms and self ms, the counters), then profiles ITERS
calls with the tracer on and splits the device's idle time across the
spans open during it (`span_trace`, `idle_by_span`: one line), and on a
card lists the places where one call makes the host wait for the device,
as CUDA's sync debug mode reports them (`sync_sites`: one line).
"""
from __future__ import annotations

import re
import sys
from typing import Callable, Dict, List, Sequence, Tuple

TOP_FAMILIES, TOP_INSTANCES = 30, 25

CLASSES = (  # phase 5's classes: a kernel name holding one of the patterns
    ("dcn kernels", ("dcn_gather_kernel", "dcn_band_kernel")),
    ("bi-attention kernels", ("bi_attn_wgmma_kernel", "bi_attn_combine_kernel")),
    ("msda kernels", ("msda_forward_kernel", "msda_band_kernel")),
    ("convolutions", ("conv", "fprop", "implicit")),
    ("matmuls", ("gemm", "nvjet", "cutlass", "xmma")),
    ("copies", ("copy",)),
    ("norms", ("norm", "Moments")),
)
OWN_KERNELS = tuple(p for _, pats in CLASSES[:3] for p in pats)


def family(name: str) -> str:
    """A kernel's name without `void `, `(anonymous namespace)::`, template
    arguments, call arguments and trailing numbering (`_12`, `.3`)."""
    base = name[5:] if name.startswith("void ") else name
    base = re.split(r"[<(]", base.replace("(anonymous namespace)::", ""), maxsplit=1)[0].strip()
    return re.sub(r"([._]\d+)+$", "", base) or name


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    total, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + cur_e - cur_s


def trace(fn: Callable, iters: int = 1, cuda: bool = True) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every kernel that `iters` calls of fn run
    under torch.profiler (CUDA activity alone; with cuda False the CPU ops)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mqdet_torch.utils.profiling import device_fence

    kind = DeviceType.CUDA if cuda else DeviceType.CPU
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            device_fence(fn())
        if cuda:
            torch.cuda.synchronize()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == kind]


def report(events: Sequence[Tuple[str, float, float]], iters: int) -> Dict:
    """The aggregation of `trace`'s events over `iters` protocol runs:
    {"families": [(family, total ms, count, hint)] largest first,
    "instances": [(name, total ms, count)] largest first, "classes":
    {phase 5's class or "other": ms}, "own": {hand-written kernel pattern:
    (ms, launches)}, "device_total_ms", "per_protocol_ms", "iters",
    "kernels", "busy_ms", "window_ms", "idle_share"}."""
    fams: Dict[str, list] = {}
    inst: Dict[str, list] = {}
    classes: Dict[str, float] = {}
    total = 0.0
    for name, s, e in events:
        ms = (e - s) / 1000.0
        total += ms
        f = fams.setdefault(family(name), [0.0, 0, name])
        f[0] += ms
        f[1] += 1
        i = inst.setdefault(name, [0.0, 0])
        i[0] += ms
        i[1] += 1
        cls = next((c for c, pats in CLASSES if any(p in name for p in pats)), "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    own = {}
    for pat in OWN_KERNELS:
        durs = [(e - s) / 1000.0 for name, s, e in events if pat in name]
        if durs:
            own[pat] = (sum(durs), len(durs))
    spans = sorted((s, e) for _, s, e in events)
    busy = union_us(spans) / 1000.0
    window = (spans[-1][1] - spans[0][0]) / 1000.0 if spans else 0.0
    return {
        "families": sorted(((k, v[0], v[1], v[2]) for k, v in fams.items()), key=lambda r: -r[1]),
        "instances": sorted(((k, v[0], v[1]) for k, v in inst.items()), key=lambda r: -r[1]),
        "classes": dict(sorted(classes.items(), key=lambda kv: -kv[1])), "own": own,
        "device_total_ms": total, "per_protocol_ms": total / iters, "iters": iters, "kernels": len(events),
        "busy_ms": busy, "window_ms": window, "idle_share": 1.0 - busy / window if window > 0 else None,
    }


def lines(rep: Dict) -> List[Dict]:
    """The tool's JSON lines of a `report`: the top families, the top
    instances, the summary."""
    it = rep["iters"]
    out = [{"op": f, "total_ms": ms, "per_call_ms": ms / it, "count": n, "hint": hint[:140]}
           for f, ms, n, hint in rep["families"][:TOP_FAMILIES]]
    out += [{"instance": name[:200], "per_call_ms": ms / it, "count": n}
            for name, ms, n in rep["instances"][:TOP_INSTANCES]]
    out.append({k: rep[k] for k in ("device_total_ms", "per_protocol_ms", "iters", "kernels", "busy_ms",
                                    "window_ms", "idle_share")})
    return out


POSTPROCESS_SPANS = ("postprocess", "atss_candidates", "nms")
FORWARD_SPANS = ("encode", "head_group", "language_tower", "glip_head", "gdino_encoder", "gdino_decoder")


def span_trace(fn: Callable, calls: int = 1, cuda: bool = True) -> Tuple[Dict, List[Tuple[str, int, int]]]:
    """(the tracer's export, kernels): `calls` calls of fn, each ending in a
    device fence, under torch.profiler (the CUDA activity alone; with cuda
    False the CPU ops) with the program's tracer on. Kernels are (name,
    start ns, end ns) on the spans' clock (`time.time_ns`), the spans' own
    `record_function` ranges left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mqdet_torch.utils.profiling import device_fence, tracer

    kind = DeviceType.CUDA if cuda else DeviceType.CPU
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        with tracer(cuda=cuda) as tr:
            for _ in range(calls):
                device_fence(fn())
    exported = tr.export()
    names = {s["name"] for s in exported["spans"]}
    start = prof.profiler.kineto_results.trace_start_ns()
    kernels = [(e.name, start + round(e.time_range.start * 1000), start + round(e.time_range.end * 1000))
               for e in prof.events()
               if e.device_type == kind and not getattr(e, "is_user_annotation", False) and e.name not in names]
    return exported, kernels


def self_segments(spans: Sequence[Dict]) -> List[Tuple[int, int, str]]:
    """(start, end, name) of each span's self time: the time it is the
    innermost open span (spans nest, as the tracer records them on one
    thread); disjoint, in order."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Dict] = []
    cursor = 0
    for s in sorted(spans, key=lambda s: (s["t0_ns"], -s["t1_ns"])):
        while stack and stack[-1]["t1_ns"] <= s["t0_ns"]:
            top = stack.pop()
            out.append((cursor, top["t1_ns"], top["name"]))
            cursor = top["t1_ns"]
        if stack:
            out.append((cursor, s["t0_ns"], stack[-1]["name"]))
        stack.append(s)
        cursor = s["t0_ns"]
    while stack:
        top = stack.pop()
        out.append((cursor, top["t1_ns"], top["name"]))
        cursor = top["t1_ns"]
    return [seg for seg in out if seg[1] > seg[0]]


def idle_intervals(kernels: Sequence[Tuple[str, float, float]]) -> List[Tuple[float, float]]:
    """The gaps between the union of the kernels' intervals, from the first
    kernel's start to the last one's end."""
    gaps, reach = [], None
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if reach is not None and s > reach:
            gaps.append((reach, s))
        reach = e if reach is None else max(reach, e)
    return gaps


def idle_by_span(spans: Sequence[Dict], kernels: Sequence[Tuple[str, int, int]]) -> Dict:
    """The device's idle time in the kernels' window split across the host
    spans: each idle interval goes, by overlap, to the self time of the
    spans open during it (the innermost wins); what no span covers is
    `outside_ns` (the caller between calls, Python outside the program).
    {"window_ns", "idle_ns", "by_span": {name: ns}, "outside_ns",
    "postprocess_ns", "forward_ns"} (the last two: `POSTPROCESS_SPANS` and
    `FORWARD_SPANS` summed)."""
    if not kernels:
        return {"window_ns": 0, "idle_ns": 0, "by_span": {}, "outside_ns": 0, "postprocess_ns": 0, "forward_ns": 0}
    gaps = idle_intervals(kernels)
    segs = self_segments(spans)
    by_span: Dict[str, float] = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            overlap = min(g1, segs[k][1]) - max(g0, segs[k][0])
            if overlap > 0:
                by_span[segs[k][2]] = by_span.get(segs[k][2], 0) + overlap
            k += 1
    idle = sum(g1 - g0 for g0, g1 in gaps)
    window = max(e for _, _, e in kernels) - min(s for _, s, _ in kernels)
    return {"window_ns": window, "idle_ns": idle, "by_span": by_span, "outside_ns": idle - sum(by_span.values()),
            "postprocess_ns": sum(by_span.get(n, 0) for n in POSTPROCESS_SPANS),
            "forward_ns": sum(by_span.get(n, 0) for n in FORWARD_SPANS)}


def span_window(fn: Callable, seconds: float) -> List[Dict]:
    """Calls of fn back to back for `seconds` with the program's tracer on
    (host times only: no CUDA events), each ending in a device fence. Per call: {"call_ms" (host, start to the
    fence's return), "fence_ms" (the last span's end to the fence's
    return), "host_ms" and "self_ms" ({span name: host ms summed over its
    occurrences}, with and without its children), "counters"}."""
    import time

    from mqdet_torch.utils.profiling import device_fence, tracer

    bounds = []
    with tracer(cuda=False) as tr:
        start = time.perf_counter()
        while not bounds or time.perf_counter() - start < seconds:
            t0 = time.time_ns()
            device_fence(fn())
            bounds.append((t0, time.time_ns()))
    exported = tr.export()
    calls = [{"call_ms": (t1 - t0) / 1e6, "host_ms": {}, "self_ms": {}, "counters": c, "last_ns": t0}
             for (t0, t1), c in zip(bounds, exported["counters"])]
    child_ns: Dict[int, int] = {}
    for s in exported["spans"]:
        if s["parent"] is not None:
            child_ns[s["parent"]] = child_ns.get(s["parent"], 0) + s["t1_ns"] - s["t0_ns"]
    for s in exported["spans"]:
        c = calls[s["call"]]
        ns = s["t1_ns"] - s["t0_ns"]
        c["host_ms"][s["name"]] = c["host_ms"].get(s["name"], 0.0) + ns / 1e6
        c["self_ms"][s["name"]] = c["self_ms"].get(s["name"], 0.0) + (ns - child_ns.get(s["id"], 0)) / 1e6
        c["last_ns"] = max(c["last_ns"], s["t1_ns"])
    for c, (_, t1) in zip(calls, bounds):
        c["fence_ms"] = (t1 - c.pop("last_ns")) / 1e6
    return calls


def sync_sites(fn: Callable) -> Dict[str, int]:
    """{"file:line": count} of the places where one call of fn makes the
    host wait for the device, as CUDA's sync debug mode warns of them."""
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sites: Dict[str, int] = {}
    for w in caught:
        key = f"{w.filename}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1
    return sites


def main(argv=None) -> int:
    from mqdet_torch.engine.predict import make_batched_protocol_fn, make_protocol_fn
    from mqdet_torch.tools import device_name, emit, glip_t, tool_args
    from mqdet_torch.utils.builders import protocol_inputs, synthetic_batch

    def extra(ap):
        ap.add_argument("--cp", type=int, default=4)
        ap.add_argument("--iters", type=int, default=3)
        ap.add_argument("--spans", type=float, default=0.0, help="seconds of calls with the program's tracer on")
        ap.add_argument("--batch", type=int, default=0, help="the image-batched protocol at this many images")

    args, dev = tool_args(__doc__.split("\n")[0], argv, extra)
    model, cfg, hw = glip_t(args.tiny, dev)
    image, text = protocol_inputs(cfg, synthetic_batch, -(-31 // args.cp), args.cp, hw)
    image, text = image.to(dev), [t.to(dev) for t in text]
    if args.batch:
        batched = make_batched_protocol_fn(model, hw, cfg, args.batch)
        images = image.expand(args.batch, -1, -1, -1).contiguous()

        def call():
            return batched(images, text[5][0, :1].expand(args.batch, 2), *text[:5])
    else:
        protocol = make_protocol_fn(model, hw, cfg)

        def call():
            return protocol(image, *text)

    for _ in range(2):
        call()
    cuda = dev.type == "cuda"
    if args.spans:
        for k, line in enumerate(span_window(call, args.spans)):
            emit({"call": k, **line})
        exported, kernels = span_trace(call, args.iters, cuda)
        idle = idle_by_span(exported["spans"], kernels)
        emit({"iters": args.iters, "counters": exported["counters"], **idle})
        if cuda:
            emit({"sync_sites": sync_sites(call)})
        emit({"cp": args.cp, "batch": args.batch, "device": device_name(dev)})
        return 0
    rep = report(trace(call, args.iters, cuda), args.iters)
    for line in lines(rep):
        emit(line)
    emit({"cp": args.cp, "device": device_name(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
