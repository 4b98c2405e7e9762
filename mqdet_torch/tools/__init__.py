"""Command-line tools of the port (run with `python -m mqdet_torch.tools.<name>`),
and the measurement helpers they share with `chip_smoke.py`."""
import contextlib
import os
import statistics
import subprocess


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of `iters` single calls of fn, each between two CUDA events,
    after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def loop_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms of one call of fn over `iters` calls issued back to
    back between two CUDA events, after `warmup` calls: the device's time,
    without the host's work between single calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 10, warmup: int = 2) -> list:
    """Host-clock ms of `iters` calls of fn, each ending in a device fence
    on its result (`utils.profiling.device_fence`), after `warmup` calls."""
    import time

    from mqdet_torch.utils.profiling import device_fence

    for _ in range(warmup):
        device_fence(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        device_fence(fn())
        times.append((time.perf_counter() - t0) * 1000.0)
    return times


def emit(record: dict) -> dict:
    """Print one JSON line of a tool's report; returns the record."""
    import json

    print(json.dumps(record), flush=True)
    return record


@contextlib.contextmanager
def env(**values):
    """Environment variables set for a block (None: unset), restored after."""
    saved = {k: os.environ.get(k) for k in values}

    def put(vals):
        for k, v in vals.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    put(values)
    try:
        yield
    finally:
        put(saved)


def tool_args(description: str, argv=None, extra=None):
    """The perf tools' command line: --device (default cuda) and --tiny (the
    tiny test config at its 64x64 bucket, a CPU rehearsal), plus the
    options `extra(parser)` adds. Returns (args, device); exits 2 where no
    CUDA device is visible and --device is not cpu: the tools measure a
    card and never fall back to the CPU."""
    import argparse
    import sys

    import torch

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="the tiny test config at 64x64 (a CPU rehearsal)")
    if extra is not None:
        extra(ap)
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device: run on a GPU, or with --device cpu", file=sys.stderr)
        raise SystemExit(2)
    return args, torch.device(args.device)


def glip_t(tiny: bool, device, seed: int = 0):
    """(model, cfg, image_hw) as bench.py builds them: MQ-GLIP-T with 300
    detections from init_params(seed) at 800x1344, in bf16 channels_last on
    a card (fp32 on the CPU); with `tiny`, the tiny test config at its 64x64
    bucket with 64 pre-NMS candidates a level and 64 detections (the CPU's
    exact NMS over 300 x 5 random-init candidates takes ~0.5 s a group)."""
    import torch

    from mqdet_torch.utils.builders import build_model, init_params, mq_glip_t_config, tiny_test_config

    cfg = tiny_test_config() if tiny else mq_glip_t_config()
    cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 300
    if tiny:
        cfg.MODEL.ATSS.PRE_NMS_TOP_N = cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 64
    hw = tuple(cfg.TPU.IMAGE_BUCKETS[0]) if tiny else (800, 1344)
    model = init_params(build_model(cfg), seed=seed).eval()
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return model.to(device, dtype).to(memory_format=torch.channels_last), cfg, hw


def device_name(device) -> str:
    """The card's name and power limit, or "cpu"."""
    return card() if device.type == "cuda" else "cpu"
