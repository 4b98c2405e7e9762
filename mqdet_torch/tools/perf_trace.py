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


def main(argv=None) -> int:
    from mqdet_torch.engine.predict import make_protocol_fn
    from mqdet_torch.tools import device_name, emit, glip_t, tool_args
    from mqdet_torch.utils.builders import protocol_inputs, synthetic_batch

    def extra(ap):
        ap.add_argument("--cp", type=int, default=4)
        ap.add_argument("--iters", type=int, default=3)

    args, dev = tool_args(__doc__.split("\n")[0], argv, extra)
    model, cfg, hw = glip_t(args.tiny, dev)
    image, text = protocol_inputs(cfg, synthetic_batch, -(-31 // args.cp), args.cp, hw)
    image, text = image.to(dev), [t.to(dev) for t in text]
    protocol = make_protocol_fn(model, hw, cfg)
    for _ in range(2):
        protocol(image, *text)
    rep = report(trace(lambda: protocol(image, *text), args.iters, dev.type == "cuda"), args.iters)
    for line in lines(rep):
        emit(line)
    emit({"cp": args.cp, "device": device_name(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
