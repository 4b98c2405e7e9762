"""`trace(logdir)`: a profiler trace of a region into a directory (the
counterpart of `mqdet_tpu/utils/profiling.py::trace`, which writes a
jax.profiler trace; the port writes torch.profiler's chrome trace, host and,
on a card, CUDA activity). The CLIs' `--profile-dir` wraps their loop in it.
"""
from __future__ import annotations

import contextlib
import os
import time


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
