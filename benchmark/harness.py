"""The benchmark's harness: one cell, one run.

A cell of BENCHMARK.json names a configuration (`configs/<name>.json`: the
program's builder and overrides, the weight law, the reference's sizes, the
flop count, the comparison's limits) and a traffic mix
(`traffic/<name>.json`), whose "entry" names the program's entry point:
`entries/<entry>.py` builds the program with weights drawn from the seed,
makes the mix's inputs and the call, names the end-to-end rate, the layers
a traced run times, and the judge. An unknown entry is refused. The harness
warms up, runs calls back to back for the measured window, reads the peak,
lets the entry take what its judge needs, frees the program, then checks a
sample of what the window produced against the plain reference
(`reference/`) and returns the result line. Per-layer metrics are read by
the readers of `metrics/`, one file each, from what a `--trace 1` run
records.

Nothing here imports JAX or the JAX package; the program is `mqdet_torch`.
"""
from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mqdet_tpu")
GIB = 2.0**30


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, spec: Optional[Dict] = None) -> Dict:
    """The cell's workload entry with its configuration file and traffic mix
    attached: {"workload", "config", "mix", "spec"}."""
    spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == work["config"])
    return {
        "workload": work,
        "config": load_json(ROOT / entry["file"]),
        "mix": load_json(BENCH / "traffic" / f"{work['traffic']}.json"),
        "spec": spec,
    }


_ENTRIES: Dict[str, object] = {}


def entry_module(mix: Dict):
    """The module `entries/<mix["entry"]>.py`; an unknown entry is refused."""
    import importlib.util

    name = mix.get("entry")
    path = BENCH / "entries" / f"{name}.py"
    if not isinstance(name, str) or not path.is_file():
        raise SystemExit(f"unknown entry {name!r}: no benchmark/entries/{name}.py")
    if name not in _ENTRIES:
        spec = importlib.util.spec_from_file_location(f"benchmark_entry_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _ENTRIES[name] = mod
    return _ENTRIES[name]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


# --- the program ---------------------------------------------------------------------


def program_config(config: Dict):
    from mqdet_torch.utils import builders

    prog = config["program"]
    cfg = getattr(builders, prog["builder"])()
    for key, value in prog["overrides"].items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


def build_program(config: Dict, device, dtype):
    """The program's model for a configuration, built on `device` (its own
    initialisation, overwritten by `fill_weights`)."""
    import torch

    from mqdet_torch.utils.builders import build_model

    cfg = program_config(config)
    with torch.device(device):
        model = build_model(cfg)
    return cfg, model.to(device, dtype).eval()


def reference_model(config: Dict, device):
    import torch

    from benchmark.reference.gdino import MQGroundingDINO
    from benchmark.reference.glip import MQGLIP

    cls = MQGLIP if config["family"] == "glip" else MQGroundingDINO
    with torch.device(device):
        return cls(config["sizes"]).eval().requires_grad_(False)


def weight_table(config: Dict, device) -> List:
    """[(name, shape, rule)] of the reference's parameters in name order:
    rule "one" (norm scales, layer scales, scalar scales), "zero" (biases) or
    "normal" (drawn by the configuration's weight law). The reference is
    built on `device` and dropped; on the card that takes under a second,
    where the meta device's first `normal_` imports some 800 modules (11.8 s
    on the card's host)."""
    from benchmark.reference.glip import Norm
    from benchmark.reference.towers import LayerNorm

    ref = reference_model(config, device)
    ones = {f"{name}.weight" for name, mod in ref.named_modules() if isinstance(mod, (LayerNorm, Norm))}
    table = []
    for name, p in sorted(ref.named_parameters()):
        if name in ones or name.endswith(("gamma_v", "gamma_l", "scale")):
            rule = "one"
        elif name.endswith((".bias", "in_proj_bias")):
            rule = "zero"
        else:
            rule = "normal"
        table.append((name, tuple(p.shape), rule))
    return table


def normal_std(name: str, shape, config: Dict) -> float:
    """The standard deviation of a "normal" weight under the configuration's
    law: {"law": "normal", "std": s} gives s to every weight; {"law":
    "fan_in", "std": s} gives a matrix or convolution kernel 1 / sqrt(its
    fan-in, the product of all but its first dimension) and a vector s.
    "scaled" ({name part: factor}) multiplies the weights whose names hold
    that part: residual branches scaled down keep each token's identity
    through a deep random stack, as trained weights do."""
    law = config["weights"]
    if law["law"] not in ("normal", "fan_in"):
        raise SystemExit(f"unknown weight law {law['law']!r}")
    std = 1.0 / math.sqrt(math.prod(shape[1:])) if law["law"] == "fan_in" and len(shape) >= 2 else float(law["std"])
    for part, factor in law.get("scaled", {}).items():
        if part in name:
            std *= factor
    return std


def seeded_weights(table, seed: int, device, dtype, config: Dict):
    """{name: tensor} for `weight_table`'s entries: the normal ones cut from
    ONE draw of a generator on `device` seeded with `seed`, in `dtype`, each
    scaled by its law's standard deviation."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    n = sum(math.prod(s) for _, s, r in table if r == "normal")
    flat = torch.randn(n, generator=g, device=device, dtype=dtype)
    out, start = {}, 0
    for name, shape, rule in table:
        if rule == "normal":
            k = math.prod(shape)
            out[name] = flat[start:start + k].view(shape).mul_(normal_std(name, shape, config))
            start += k
        else:
            out[name] = torch.full(shape, 1.0 if rule == "one" else 0.0, device=device, dtype=dtype)
    return out


def fill_weights(model, weights: Dict, seed: int, config: Dict) -> List[str]:
    """Copy `weights` into the model by name; parameters the reference does
    not hold (no output the comparison reads depends on them) are drawn from
    the seed's second stream by the same law. Returns their names."""
    import torch

    own = dict(model.named_parameters())
    missing = [k for k in weights if k not in own or tuple(own[k].shape) != tuple(weights[k].shape)]
    if missing:
        raise SystemExit(f"the program lacks the reference's parameters {missing[:5]} ({len(missing)})")
    extra = sorted(k for k in own if k not in weights)
    g = torch.Generator(device=next(iter(own.values())).device)
    g.manual_seed((int(seed) + 1) % 2**63)
    with torch.no_grad():
        for k, v in weights.items():
            own[k].copy_(v)
        for k in extra:
            p = own[k]
            p.copy_(torch.randn(p.shape, generator=g, device=p.device, dtype=p.dtype) * normal_std(k, p.shape, config))
    return extra


# --- one run -------------------------------------------------------------------------


class LayerClock:
    """CUDA events at the harness's own hooks around the program's layers:
    device ms between a layer's first pre-hook and its last hook, per
    occurrence, with no synchronisation (read after the window)."""

    def __init__(self, torch):
        self.torch = torch
        self.marks: Dict[str, List] = {}
        self.handles = []

    def span(self, name, first_module, last_module):
        open_ = {}

        def pre(_m, _a):
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            open_["e"] = ev

        def post(_m, _a, _o):
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.setdefault(name, []).append((open_.pop("e"), ev))

        self.handles.append(first_module.register_forward_pre_hook(pre))
        self.handles.append(last_module.register_forward_hook(post))

    def ms(self) -> Dict[str, List[float]]:
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.marks.items()}

    def close(self):
        for h in self.handles:
            h.remove()
        self.handles = []


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", dtype_name: str = "bfloat16",
        check_devices: bool = True, t0: Optional[float] = None, cell_data: Optional[Dict] = None,
        protocol_wrap=None) -> Dict:
    """One run of a cell; returns the result line's object, with "checks"
    ({number: [value, limit]}) and "_extra" (the run's timings) for the
    caller to print. `protocol_wrap(fn)` replaces the program's call (the
    fault tests)."""
    t0 = time.perf_counter() if t0 is None else t0
    early = [("run", time.perf_counter() - t0)]
    import torch

    early.append(("torch", time.perf_counter() - t0))
    c = cell_data if cell_data is not None else cell(workload)
    work, config, mix = c["workload"], c["config"], c["mix"]
    entry = entry_module(mix)
    if check_devices:
        if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
            raise SystemExit(f"{workload} needs {work['chips']} CUDA device(s); found "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = torch.device(device)
    dtype = getattr(torch, dtype_name)
    if dev.type == "cuda":
        torch.cuda.init()
    early.append(("cuda", time.perf_counter() - t0))
    table = weight_table(config, dev) if config.get("weights") else None  # an entry with no reference needs none
    early.append(("table", time.perf_counter() - t0))
    timed = _timed(torch, entry, config, mix, seed, seconds, trace, dev, dtype, table, protocol_wrap, t0)
    timed["setup_marks"] = early + timed["setup_marks"]
    # the window has closed, the peak is read and the program is freed: check
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    got = entry.numbers(config, mix, timed["inputs"], timed["outputs"], timed["captured"], seed, dev, table, dtype)
    checks = {k: {"value": got.get(k, float("inf")), "limit": lim} for k, lim in config["limits"].items()}
    check_s = time.perf_counter() - t_check
    n_calls, peak, setup_s = timed["calls"], timed["peak"], timed["setup_s"]
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": work["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        device_info["busy_s"] = timed["record"]["trace"]["busy_s"]
        device_info["window_s"] = timed["record"]["trace"]["window_s"]

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: {found}")

    if trace:
        metrics = read_per_layer(c["spec"], work["name"], timed["record"])
    else:
        metrics = {entry.RATE["name"]: {"value": timed["rate"], "unit": entry.RATE["unit"]},
                   "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {k: v for k, v in metrics.items() if k in end_to_end_names(c["spec"], work["name"])}
    result = {"correct": all(v["value"] <= v["limit"] for v in checks.values()),
              "attempted": n_calls * timed["units"], "failed": 0, "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = timed["breakdown"]
    result["checks"] = {k: [v["value"], v["limit"]] for k, v in checks.items()}
    result["_extra"] = {"check_s": check_s, "calls": n_calls, "window_s": timed["window_s"],
                        "power": timed["record"]["power"], "setup_s": setup_s, "setup_marks": timed["setup_marks"],
                        "call_s": timed["call_s"], "numbers": got}
    return result


def _timed(torch, entry, config, mix, seed, seconds, trace, dev, dtype, table, protocol_wrap, t0) -> Dict:
    """Build the program (by the entry), warm up, run the window and, with
    `trace`, the profiled calls; then let the entry take what its judge
    needs. Returns the window's outputs and readings; the program is garbage
    once this returns."""
    marks = [("imports", time.perf_counter() - t0)]

    def mark(name):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        marks.append((name, time.perf_counter() - t0))

    state = entry.build(config, mix, seed, dev, dtype, table, mark, protocol_wrap)
    call = state["call"]
    for k in range(mix["warmup_calls"]):
        call(-1 - k)
        mark(f"warm-up {k}")
    clock = None
    if trace:
        clock = LayerClock(torch)
        for name, (first, last) in entry.spans(config, state).items():
            clock.span(name, first, last)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    outputs, ends = [], []
    start = time.perf_counter()
    while True:
        outputs.append(call(len(outputs)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ends.append(time.perf_counter() - start)
        if ends[-1] >= seconds:
            break
    window_s = ends[-1]
    n_calls = len(outputs)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    record = {"img_per_s": n_calls * state["units"] / window_s, "calls": n_calls, "window_s": window_s,
              "config": config, "mix": mix, "family": config["family"],
              "power": power_limit() if dev.type == "cuda" else "cpu"}
    breakdown = None
    if trace:
        from benchmark import tracing

        record["layer_ms"] = clock.ms()
        clock.close()
        extra = {"n": n_calls}

        def traced_call():
            out = call(extra["n"])
            extra["n"] += 1
            return out

        events = tracing.profile(torch, traced_call, mix["trace_calls"], dev.type == "cuda")
        record["trace"] = tracing.reduce(events)
        breakdown = tracing.breakdown(events)
    captured = entry.after_window(config, mix, state, n_calls, seed)
    return {"inputs": state["inputs"], "outputs": outputs, "captured": captured, "calls": n_calls, "peak": peak,
            "units": state["units"], "setup_s": setup_s, "window_s": window_s, "rate": record["img_per_s"],
            "record": record, "breakdown": breakdown, "setup_marks": marks,
            "call_s": [b - a for a, b in zip([0.0] + ends[:-1], ends)]}


def end_to_end_names(spec: Dict, workload: str) -> List[str]:
    return [m["name"] for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]


def read_per_layer(spec: Dict, workload: str, record: Dict) -> Dict:
    """Every per-layer metric of this cell that its reader finds."""
    import importlib.util

    out = {}
    for m in spec["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        path = BENCH / "metrics" / f"{m['name']}.py"
        mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        value = mod.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
