"""The chunk-batch (CP) operating point of the whole MQ-GLIP-T LVIS protocol
(the port of `tools/perf_protocol_sweep.py`).

    python -m mqdet_torch.tools.perf_protocol_sweep [--cps 4,8,16] [--runs 10]
    python -m mqdet_torch.tools.perf_protocol_sweep --device cpu --tiny

MQ-GLIP-T as bench.py builds it (`tools.glip_t`, 300 detections, one
800x1344 image, seed 0); at each CP the 31 prompt chunks run as ceil(31 /
CP) groups of CP chunks (the head at batch CP) through `make_protocol_fn`:
2 warm-up runs, then RUNS timed on the host clock, each ending in a device
synchronise. One JSON line per CP: `cp`, `groups`, `protocol_p50_ms`,
`img_per_sec`, and the kernel launches of one run. Every CP takes the same
image and the same 4 chunks of 40 labels x 5 queries (`protocol_inputs` at
CP 4, tiled to CP; the JAX tool draws CP new chunks, of the same shapes),
so entry (g, c) of any CP scores the chunk of entry (0, c % 4) at CP 4.
"""
from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Sequence, Tuple

CHUNKS = 31


def sweep_inputs(cfg, cp: int, hw, seed: int = 0):
    """(image, text) of the protocol at `cp`: `protocol_inputs` at CP 4
    (one group), its 4 chunks tiled to `cp`, repeated over ceil(31 / cp)
    groups."""
    from mqdet_torch.utils.builders import protocol_inputs, synthetic_batch

    image, text = protocol_inputs(cfg, synthetic_batch, 1, 4, hw, seed)
    pick = [c % 4 for c in range(cp)]
    groups = -(-CHUNKS // cp)
    return image, [t[0, pick][None].expand(groups, cp, *t.shape[2:]).contiguous() for t in text]


def sweep(model, cfg, hw, cps: Sequence[int] = (4, 8, 16), runs: int = 10, warmup: int = 2, seed: int = 0,
          emit=None) -> Tuple[List[Dict], Dict]:
    """(the module docstring's records, {cp: detections of the counted
    run}) for `model` (MQ-GLIP) at bucket `hw` on its device."""
    from mqdet_torch.engine.predict import make_protocol_fn
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.tools import host_ms
    from mqdet_torch.utils.profiling import device_fence

    dev = next(model.parameters()).device
    protocol = make_protocol_fn(model, hw, cfg)
    records, dets = [], {}
    for cp in cps:
        image, text = sweep_inputs(cfg, cp, hw, seed)
        image, text = image.to(dev), [t.to(dev) for t in text]
        times = host_ms(lambda: protocol(image, *text), runs, warmup)
        launch_counts(reset=True)
        dets[cp] = protocol(image, *text)
        device_fence(dets[cp])
        p50 = statistics.median(times)
        rec = {"cp": cp, "groups": text[0].shape[0], "protocol_p50_ms": p50, "img_per_sec": 1000.0 / p50,
               "launches": {k: v for k, v in launch_counts().items() if v}}
        records.append(rec)
        if emit is not None:
            emit(rec)
    return records, dets


def main(argv=None) -> int:
    from mqdet_torch.tools import device_name, emit, glip_t, tool_args

    def extra(ap):
        ap.add_argument("--cps", default="4,8,16")
        ap.add_argument("--runs", type=int, default=10)

    args, dev = tool_args(__doc__.split("\n")[0], argv, extra)
    model, cfg, hw = glip_t(args.tiny, dev)
    sweep(model, cfg, hw, [int(c) for c in args.cps.split(",")], args.runs, emit=emit)
    emit({"device": device_name(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
