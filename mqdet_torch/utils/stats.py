"""Model complexity statistics (counterpart of `mqdet_tpu/utils/stats.py`;
the reference's ptflops-derived `get_model_complexity_info`): parameter
counts from the module, flops from running the function once.

`flops_of` adds two counts: `torch.utils.flop_counter`'s count of the PyTorch
operators the call runs (products and convolutions) and the kernels' own
reports (`utils/flop_count.py`), which that counter cannot see inside a ctypes
launch. The operators a kernel wrapper runs inside its `flop_count.kernel`
block (its plain version's products, on the CPU or under
`ops.kernels.plain_versions()`) are left out of the first count, so a kernel's
work is counted once, by its report, on every route. (JAX's `flops_of` lowers
and reads the compiler's cost analysis without running anything; this one
runs the call.)
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from mqdet_torch.utils import flop_count


def count_params(model: torch.nn.Module) -> int:
    return int(sum(p.numel() for p in model.parameters()))


def count_params_by_prefix(model: torch.nn.Module, depth: int = 2) -> Dict[str, int]:
    """Parameter counts by the first `depth` parts of the port's dotted
    names, largest first."""
    out: Dict[str, int] = {}
    for name, p in model.named_parameters():
        key = ".".join(name.split(".")[:depth])
        out[key] = out.get(key, 0) + p.numel()
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


class _GlobalOnly:
    """A module tracker that attributes every operator to "Global" alone.
    FlopCounterMode's own (`torch.utils.module_tracker.ModuleTracker`)
    registers gradient hooks on a module's inputs that need a gradient,
    which fails under `torch.inference_mode()` where a parameter is a
    module's input (MQ-GroundingDINO's decoder layers); `flops_of` reads
    the total alone."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return None


class _OperatorCounter(FlopCounterMode):
    """FlopCounterMode that counts nothing inside a kernel wrapper's block,
    by no module."""

    def __init__(self):
        super().__init__(display=False)
        self.mod_tracker = _GlobalOnly()

    def _count_flops(self, func_packet, out, args, kwargs):
        if flop_count.inside_kernel():
            return out
        return super()._count_flops(func_packet, out, args, kwargs)


def flops_with_kernels(fn: Callable, *args) -> Tuple[float, float, Dict[str, float]]:
    """(total, operator flops, {kernel family: flops}) of one call fn(*args)."""
    with flop_count.measure() as m, _OperatorCounter() as counter:
        fn(*args)
    ops = float(counter.get_total_flops())
    return ops + m.total(), ops, m.by_kernel()


def flops_of(fn: Callable, *args) -> float:
    """Flops of one call fn(*args): the operator counter's plus the kernels'
    reports (module docstring)."""
    return flops_with_kernels(fn, *args)[0]


def model_complexity(model: torch.nn.Module, *example_args) -> Tuple[int, float]:
    """(num_params, forward_flops); the flops are nan where the forward fails."""
    n = count_params(model)
    try:
        with torch.inference_mode():
            f = flops_of(model, *example_args)
    except Exception:
        f = float("nan")
    return n, f
