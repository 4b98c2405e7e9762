"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Exits non-zero, printing no result, without
enough CUDA devices for the cell, or if JAX or the JAX package was loaded.
The last lines of standard error, and the result line's last key
("checks"), give each number that decided `correct` beside its limit.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's nvcc library keeps its own, `mqdet_torch/_build/`)."""
    cache = BENCH / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    torch.set_num_threads(1)  # one host thread: the protocol's work is on the card
    from benchmark import harness

    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    extra = result.pop("_extra")
    checks = result.pop("checks")
    print(f"run: {args.workload} seed {args.seed} trace {args.trace}: {extra['calls']} calls in "
          f"{extra['window_s']!r} s, set-up {extra['setup_s']!r} s, check {extra['check_s']!r} s; "
          f"{result['device']['kind']} ({extra['power']}); set-up marks {extra['setup_marks']}; call seconds "
          f"{extra['call_s']}", file=sys.stderr)
    print(f"numbers (those with a limit are compared): {extra['numbers']}", file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
