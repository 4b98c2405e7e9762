"""Profiling hooks (counterpart of `mqdet_tpu/utils/profiling.py`).

  * `trace(logdir)`: a profiler trace of a region into a directory (JAX
    writes a jax.profiler trace; the port writes torch.profiler's chrome
    trace, host and, on a card, CUDA activity). The CLIs' `--profile-dir`
    wraps their loop in it; the program's spans show in it by name.
  * `annotate(name, **attrs)`: a span of the program. With the tracer off
    (the default) it costs one check of the module-level `_TRACER`: no
    span, no CUDA event, no `record_function`. With it on (`tracer()`)
    the span is kept: name, id, parent id, the call it belongs to (a span
    opened with none open starts a call), `attrs` (small ints), its host
    start and end in `time.time_ns()`'s epoch nanoseconds (the clock
    `torch.profiler` stamps its events with: `prof.profiler.kineto_results.
    trace_start_ns()` turns one into the profiler's relative microseconds),
    the counters added inside it and, on a card, a CUDA event pair for its
    device milliseconds, read at `Tracer.export()` with no synchronise
    inside the span. It also enters `torch.profiler.record_function(name)`.
  * `count(name, n)`: add n to a named counter of the innermost open span
    (nothing with the tracer off).
  * `StepTimer`: wall-clock step timing with a device fence (`device_fence`:
    wait for the devices of a nest of tensors) and a warmup skip.

The spans of the LVIS protocols (`engine/predict.py`): `protocol` (one a
call), under it `encode` and one `head_group` a group (attribute `g`),
under which `language_tower`, then `glip_head` (MQ-GLIP) or
`gdino_encoder` and `gdino_decoder` (MQ-GroundingDINO), and
`postprocess`; MQ-GLIP's holds `atss_candidates` and `nms`. Counters:
`nms_rounds` (`class_aware_nms`'s fixed-point rounds) and `host_syncs`
(each place on that path where the host waits for the device: the NMS
round's `torch.equal`).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional

_TRACER: Optional["Tracer"] = None  # the tracer: None is off


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write `trace_<time>.json` (chrome://tracing or
    Perfetto) into `logdir`. The tracer is on inside (unless one already
    is), so the program's spans appear by name; their records are dropped."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(profile(activities=activities))
        if _TRACER is None:
            stack.enter_context(tracer(cuda=False))
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json"))


class _Off:
    """The one context a span returns with the tracer off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def annotate(name: str, **attrs):
    """A span named `name` (see the module's docstring); `with annotate(...)
    as span` gives the kept span, or None with the tracer off."""
    if _TRACER is None:
        return _OFF
    return _Span(_TRACER, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the innermost open span (with the
    tracer on, one must be open); nothing with the tracer off."""
    if _TRACER is not None:
        _TRACER.add(name, n)


class _Span:
    __slots__ = ("tracer", "name", "attrs", "id", "parent", "call", "counters", "t0", "t1", "events", "rf")

    def __init__(self, tr: "Tracer", name: str, attrs: Dict[str, int]):
        self.tracer, self.name, self.attrs = tr, name, attrs
        self.counters: Dict[str, int] = {}
        self.t0 = self.t1 = None
        self.events = None

    def __enter__(self):
        import torch

        tr = self.tracer
        parent = tr.stack[-1] if tr.stack else None
        if parent is None:
            tr.calls += 1
        self.parent = None if parent is None else parent.id
        self.call = tr.calls - 1
        self.id = len(tr.spans)
        tr.spans.append(self)
        tr.stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if tr.cuda:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.time_ns()  # the host times leave the tracer's own work out
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        self.rf.__exit__(*exc)
        self.rf = None
        self.tracer.stack.pop()
        return False


class Tracer:
    """The kept spans and counters of the program while the tracer is on.
    `cuda` (default: a CUDA device is available) records each span's CUDA
    event pair on the current stream."""

    def __init__(self, cuda: Optional[bool] = None):
        import torch

        self.cuda = torch.cuda.is_available() if cuda is None else bool(cuda)
        self.spans: List[_Span] = []
        self.stack: List[_Span] = []
        self.calls = 0

    def add(self, name: str, n: int) -> None:
        if not self.stack:
            raise RuntimeError(f"counter {name!r} added with no span open")
        counters = self.stack[-1].counters
        counters[name] = counters.get(name, 0) + int(n)

    def export(self) -> Dict:
        """Plain lists and dicts: {"clock": "time_ns", "calls": number of
        calls, "spans": [{"name", "id", "parent", "call", "attrs",
        "counters" (added inside it, not in its children), "t0_ns", "t1_ns",
        "device_ms" (None without CUDA events)}] in opening order,
        "counters": [{name: total}] per call}. Waits for the device where
        spans hold CUDA events."""
        import torch

        if self.stack:
            raise RuntimeError(f"spans still open: {[s.name for s in self.stack]}")
        if any(s.events is not None for s in self.spans):
            torch.cuda.synchronize()
        per_call: List[Dict[str, int]] = [{} for _ in range(self.calls)]
        spans = []
        for s in self.spans:
            for k, v in s.counters.items():
                per_call[s.call][k] = per_call[s.call].get(k, 0) + v
            spans.append({"name": s.name, "id": s.id, "parent": s.parent, "call": s.call, "attrs": dict(s.attrs),
                          "counters": dict(s.counters), "t0_ns": s.t0, "t1_ns": s.t1,
                          "device_ms": None if s.events is None else s.events[0].elapsed_time(s.events[1])})
        return {"clock": "time_ns", "calls": self.calls, "spans": spans, "counters": per_call}


@contextlib.contextmanager
def tracer(cuda: Optional[bool] = None):
    """Turn the tracer on for the block; yields the `Tracer` (read it with
    `export()`). One tracer at a time."""
    global _TRACER
    if _TRACER is not None:
        raise RuntimeError("the tracer is already on")
    _TRACER = Tracer(cuda)
    try:
        yield _TRACER
    finally:
        _TRACER = None


def _tensors(tree: Any):
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, k))


def device_fence(tree: Any) -> None:
    """Block until the work on every CUDA device holding a tensor of `tree`
    (tensors in dicts, lists, tuples and dataclasses) is done; CPU tensors
    need no wait."""
    import torch

    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class StepTimer:
    """Wall-clock step timing with device fences and a warmup skip.

        timer = StepTimer(warmup=2)
        for batch in data:
            out = step(batch)
            timer.tick(out)          # fences on `out`
        stats = timer.summary()      # {"steps", "mean_s", "p50_s", "rate"}
    """

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._seen = 0
        self._t_last: Optional[float] = None
        self.durations: List[float] = []

    def tick(self, probe: Any = None) -> Optional[float]:
        if probe is not None:
            device_fence(probe)
        now = time.perf_counter()
        dt = None
        if self._t_last is not None:
            self._seen += 1
            if self._seen > self.warmup:
                dt = now - self._t_last
                self.durations.append(dt)
        self._t_last = now
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {"steps": 0, "mean_s": 0.0, "p50_s": 0.0, "rate": 0.0}
        d = sorted(self.durations)
        n = len(d)
        mean = sum(d) / n
        return {"steps": n, "mean_s": mean, "p50_s": d[n // 2], "rate": (1.0 / mean) if mean > 0 else 0.0}
