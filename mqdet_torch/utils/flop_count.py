"""Analytic flop registry for the hand-written kernels (counterpart of
`mqdet_tpu/utils/flop_count.py`).

The port's kernels are ctypes launches, so no counter of PyTorch operators
(`torch.utils.flop_counter`) sees their work. Each kernel wrapper reports the
ALGORITHMIC flops of its call (the JAX package's family names and formulas:
the math a perfect implementation must do, not a kernel's overcompute) into
this registry, on every route: the CUDA kernel, its plain version on the CPU
and `ops.kernels.plain_versions()`. So a count is the same work whatever
computes it. `utils/stats.py::flops_of` adds the registry to the operator
counter's total; the wrappers report through `kernel()`, which also tells that
counter to skip the plain version's own products, so a kernel's work is counted
once.

Counts are per call: the port runs eagerly, so a wrapper inside a loop
reports once per iteration. (The JAX registry counts per trace: an op inside
`lax.map` is traced once, and its callers multiply by the trip count.)
Thread-local, as the JAX module.
"""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from typing import Dict, Iterator

_state = threading.local()


def add(name: str, flops: float) -> None:
    """Record `flops` for kernel family `name` (no-op outside measure())."""
    acc = getattr(_state, "acc", None)
    if acc is not None:
        acc[name] += float(flops)


def inside_kernel() -> bool:
    """Whether this thread is inside a wrapper's `kernel()` block."""
    return getattr(_state, "depth", 0) > 0


@contextlib.contextmanager
def kernel(**flops: float) -> Iterator[None]:
    """A kernel wrapper's call: report each family's flops (`name=flops`),
    then run the block (the launch or the plain version) as inside the
    kernel."""
    for name, n in flops.items():
        add(name, n)
    _state.depth = getattr(_state, "depth", 0) + 1
    try:
        yield
    finally:
        _state.depth -= 1


class _Measurement:
    def __init__(self, acc: Dict[str, float]):
        self._acc = acc

    def total(self) -> float:
        return float(sum(self._acc.values()))

    def by_kernel(self) -> Dict[str, float]:
        return dict(self._acc)


@contextlib.contextmanager
def measure() -> Iterator[_Measurement]:
    """Collect the kernels' flop reports of the calls made inside the block.
    Nests: an inner block collects its own calls and restores the outer."""
    prev = getattr(_state, "acc", None)
    _state.acc = defaultdict(float)
    try:
        yield _Measurement(_state.acc)
    finally:
        _state.acc = prev
