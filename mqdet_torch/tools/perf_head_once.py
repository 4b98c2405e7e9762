"""Head-only timing of the MQ-GLIP-T LVIS protocol at its operating point
(CP 4, 800x1344), for A/B-ing tower changes without a full protocol run
(the port of `tools/perf_head_once.py`).

    python -m mqdet_torch.tools.perf_head_once
    python -m mqdet_torch.tools.perf_head_once --device cpu --tiny

On MQ-GLIP-T as bench.py builds it (`tools.glip_t`), the image tower runs
once, then one group's head function (language tower, VLDyHead, ATSS, NMS)
runs 3 times to warm up and 12 times timed on the host clock, each ending in
a device synchronise. It prints one JSON line: `head_ms_per_group` (p50 and
min), the runs, and the kernel launches of one head call.
"""
from __future__ import annotations

import statistics
import sys
from typing import Dict


def head_once(model, cfg, hw, image, text, runs: int = 12, warmup: int = 3) -> Dict:
    """The module docstring's record for `model` (MQ-GLIP) at bucket `hw`,
    `image` and `text` as `perf_bisect.bisect` takes them (group 0)."""
    from mqdet_torch.engine.predict import make_split_predict_fns
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.tools import host_ms
    from mqdet_torch.utils.profiling import device_fence

    encode_fn, head_fn = make_split_predict_fns(model, hw, cfg)
    feats = encode_fn(image)
    group = [t[0] for t in text]
    times = host_ms(lambda: head_fn(feats, *group), runs, warmup)
    launch_counts(reset=True)
    device_fence(head_fn(feats, *group))
    launches = {k: v for k, v in launch_counts().items() if v}
    return {"head_ms_per_group": {"p50": statistics.median(times), "min": min(times)}, "runs": runs,
            "launches_per_group": launches}


def main(argv=None) -> int:
    from mqdet_torch.tools import device_name, emit, glip_t, tool_args
    from mqdet_torch.utils.builders import protocol_inputs, synthetic_batch

    args, dev = tool_args(__doc__.split("\n")[0], argv)
    model, cfg, hw = glip_t(args.tiny, dev)
    image, text = protocol_inputs(cfg, synthetic_batch, 1, 4, hw)
    rec = head_once(model, cfg, hw, image.to(dev), [t.to(dev) for t in text])
    emit(dict(rec, device=device_name(dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
