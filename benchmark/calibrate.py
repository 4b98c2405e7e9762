"""The readings that a cell's limits are set from, in one process: the
program's compared numbers over several seeds (each a short run of the
harness, window and all) and the control's (the reference in fp8 put in the
program's place) over others. One JSON line a seed.

    python3 -m benchmark.calibrate --workload <name> --program-seeds 1 2 ... --control-seeds 7 8 9 [--seconds 3]

Not part of a benchmark run; the limits it informs live in the
configuration files (`"limits"`), and PERF.md gives the readings.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import harness, traffic


def control_numbers(c, seed: int, device: str = "cuda", dtype_name: str = "bfloat16", calls: int = 4):
    """The control's numbers on the sample a run of `calls` calls would draw."""
    import torch

    dev = torch.device(device)
    dtype = getattr(torch, dtype_name)
    config, mix = c["config"], c["mix"]
    table = harness.weight_table(config, dev)
    inputs = traffic.lvis_protocol(mix, config["sizes"]["channels"], seed, dev)
    return harness.entry_module(mix).numbers(config, mix, inputs, [None] * calls, {}, seed, dev, table, dtype,
                                             control=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args(argv)
    from benchmark.run import cache_dirs

    cache_dirs()
    c = harness.cell(a.workload)
    for seed in a.program_seeds:
        t = time.perf_counter()
        r = harness.run(a.workload, seed, a.seconds, False, cell_data=c)
        print(json.dumps({"who": "program", "seed": seed, "correct": r["correct"], "numbers": r["_extra"]["numbers"],
                          "metrics": r["metrics"], "extra": r["_extra"], "s": time.perf_counter() - t}), flush=True)
    for seed in a.control_seeds:
        t = time.perf_counter()
        got = control_numbers(c, seed)
        limits = c["config"]["limits"]
        print(json.dumps({"who": "control", "seed": seed, "numbers": got,
                          "fails": [k for k, v in got.items() if k in limits and v > limits[k]],
                          "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
