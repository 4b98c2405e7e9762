"""The device trace of a `--trace 1` run and its reduction.

`profile` runs calls under `torch.profiler` with the CUDA activity alone
(the CPU ops' events cost tens of seconds of host time a protocol call) and
keeps every kernel's (name, start, end). `reduce` gives the busy time (the
union of the kernels' intervals), the traced window (first kernel's start
to the last one's end) and each kernel family's device time; `breakdown`
the result line's largest families and longest idle gaps, each gap named by
the kernel the device waited to start.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

Event = Tuple[str, float, float]  # name, start us, end us


def family(name: str) -> str:
    """A kernel's name without `void `, `(anonymous namespace)::`, template
    arguments, call arguments and trailing numbering."""
    base = name[5:] if name.startswith("void ") else name
    base = re.split(r"[<(]", base.replace("(anonymous namespace)::", ""), maxsplit=1)[0].strip()
    return re.sub(r"([._]\d+)+$", "", base) or name


def union_us(spans) -> float:
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


def profile(torch, fn: Callable, calls: int, cuda: bool = True) -> List[Event]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    kind = DeviceType.CUDA if cuda else DeviceType.CPU
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with torch.profiler.profile(activities=[activity]) as prof:
        for _ in range(calls):
            fn()
            if cuda:
                torch.cuda.synchronize()
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == kind]


def reduce(events: List[Event]) -> Dict:
    """{"busy_s", "window_s", "families": {family: seconds}, "kernels": {name: seconds}}."""
    fams: Dict[str, float] = {}
    names: Dict[str, float] = {}
    for name, s, e in events:
        fams[family(name)] = fams.get(family(name), 0.0) + (e - s) * 1e-6
        names[name] = names.get(name, 0.0) + (e - s) * 1e-6
    spans = [(s, e) for _, s, e in events]
    window = (max(e for _, e in spans) - min(s for s, _ in spans)) * 1e-6 if spans else 0.0
    return {"busy_s": union_us(spans) * 1e-6, "window_s": window, "families": fams, "kernels": names,
            "count": len(events)}


def kernel_seconds(trace: Dict, patterns) -> float:
    """Device seconds of the kernels whose name holds one of `patterns`."""
    return sum(t for name, t in trace["kernels"].items() if any(p in name for p in patterns))


def breakdown(events: List[Event], top: int = 10) -> Dict:
    fams: Dict[str, float] = {}
    for name, s, e in events:
        fams[family(name)] = fams.get(family(name), 0.0) + (e - s) * 1e-6
    ops = sorted(fams.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    ordered = sorted(events, key=lambda ev: ev[1])
    reach = ordered[0][2] if ordered else 0.0
    for name, s, e in ordered[1:]:
        if s > reach:
            gaps.append((f"before {family(name)}", (s - reach) * 1e-6))
        reach = max(reach, e)
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": [[n, t] for n, t in gaps[:top]]}
