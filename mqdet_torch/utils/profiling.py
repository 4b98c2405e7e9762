"""Profiling hooks (counterpart of `mqdet_tpu/utils/profiling.py`).

  * `trace(logdir)`: a profiler trace of a region into a directory (JAX
    writes a jax.profiler trace; the port writes torch.profiler's chrome
    trace, host and, on a card, CUDA activity). The CLIs' `--profile-dir`
    wraps their loop in it.
  * `annotate(name)`: a named range in the profiler's timeline
    (`torch.profiler.record_function`).
  * `StepTimer`: wall-clock step timing with a device fence (`device_fence`:
    wait for the devices of a nest of tensors) and a warmup skip.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Optional


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write `trace_<time>.json` (chrome://tracing or
    Perfetto) into `logdir`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Name a region in the profiler's timeline."""
    import torch

    with torch.profiler.record_function(name):
        yield


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
