"""A/B of VLFuse's bi-attention formulations on one NVIDIA GPU (the port of
`tools/perf_fusion_ab.py`).

    [AB_ITERS=N] python -m mqdet_torch.tools.perf_fusion_ab <levels> <scores>

  levels = concat | stream   MQDET_FLASH_LEVELS: one kernel over the
                             concatenated pyramid, or one carried-state
                             launch per FPN level without concatenating
  scores = single | dual     MQDET_FLASH_SCORES: the two-launch kernel pair,
                             or the one-launch dual-score kernel

It drives the MQ-GLIP-T LVIS protocol as bench.py does: `mq_glip_t_config`
with 300 detections, random weights from seed 0 in bf16 on the card, one
800x1344 image, 8 groups x CP 4 chunks of 40 labels x 5 queries, through
`make_protocol_fn`. Two warm-up runs, then AB_ITERS timed runs (default 12),
host clock around work that ends in a device synchronise. It prints one JSON
line: levels, scores, p50_ms, min_ms, iters, the card's name and power limit
(nvidia-smi) and the kernel launches of one protocol run. (stream, dual)
prints a `skipped` record instead: the streamed form has only the
single-score formulation. It exits non-zero on a machine without a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

SEED = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("levels", choices=("concat", "stream"))
    ap.add_argument("scores", choices=("single", "dual"))
    args = ap.parse_args(argv)
    if args.levels == "stream" and args.scores == "dual":
        print(json.dumps({
            "levels": args.levels, "scores": args.scores,
            "skipped": "stream path has no dual-score variant; identical to (stream, single)",
        }))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("perf_fusion_ab: no CUDA device; it measures only on a GPU", file=sys.stderr)
        return 1
    os.environ["MQDET_FLASH_LEVELS"] = args.levels
    os.environ["MQDET_FLASH_SCORES"] = args.scores

    from mqdet_torch.engine.predict import make_protocol_fn
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.tools import card
    from mqdet_torch.utils.builders import (
        build_model, init_params, mq_glip_t_config, protocol_inputs, synthetic_batch,
    )

    dev = torch.device("cuda")
    cfg = mq_glip_t_config()
    cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 300
    hw, cp = (800, 1344), 4
    groups = -(-31 // cp)
    model = init_params(build_model(cfg), seed=SEED).eval()
    model = model.to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    image, text = protocol_inputs(cfg, synthetic_batch, groups, cp, hw, seed=SEED)
    image, text = image.to(dev), [t.to(dev) for t in text]
    protocol = make_protocol_fn(model, hw, cfg)

    def run():
        dets = protocol(image, *text)
        torch.cuda.synchronize()
        return dets

    for _ in range(2):
        run()
    launch_counts(reset=True)
    dets = run()
    launches = launch_counts()
    if not bool(torch.isfinite(dets.scores).all()):
        print("perf_fusion_ab: non-finite scores", file=sys.stderr)
        return 1
    times = []
    for _ in range(int(os.environ.get("AB_ITERS", "12"))):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    print(json.dumps({
        "levels": args.levels, "scores": args.scores,
        "p50_ms": statistics.median(times) * 1000.0, "min_ms": min(times) * 1000.0,
        "iters": len(times), "device": torch.cuda.get_device_name(0), "card": card(),
        "launches": launches,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
