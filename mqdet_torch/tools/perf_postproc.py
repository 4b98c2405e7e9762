"""ATSS post-processing split into its candidate top-k and its NMS (the port
of `tools/perf_postproc.py`).

    python -m mqdet_torch.tools.perf_postproc
    python -m mqdet_torch.tools.perf_postproc --device cpu --tiny

Head outputs as the JAX tool draws them from default_rng(0) in fp32, at CP 4
and the 800x1344 pyramid (100x168, 50x84, 25x42, 13x21, 7x11; strides 8 to
128), T 256 tokens, 40 classes of 2 tokens each (aggregation 0.5), dot
logits N(0, 1) - 3; the JAX tool's parameters (pre_nms_thresh 0.05, top-n
1000, NMS 0.6, 300 detections). Each time is the median of 10 calls after 2
warm-ups, host clock around work that ends in a device synchronise:

  postproc_full_ms     `atss_postprocess`
  candidates_only_ms   `atss_candidates`: per level the scores, the
                       threshold and the exact top-k, decoded and clipped
  nms_only_ms          `atss_select` on those candidates: `ops/nms.py::
                       class_aware_nms` (JAX's `class_aware_nms_matrix`) and
                       the gather of the kept detections

`--tiny`: the tiny bucket (64x64), T 16, 7 classes.
"""
from __future__ import annotations

import statistics
import sys
from typing import Dict

import numpy as np

STRIDES = (8, 16, 32, 64, 128)
PARAMS = dict(pre_nms_thresh=0.05, pre_nms_top_n=1000, nms_thresh=0.6, detections_per_img=300)


def postproc_inputs(device, hw=(800, 1344), cp: int = 4, tokens: int = 256, classes: int = 40, seed: int = 0):
    """(head_out, anchors, agg_map, image_sizes, PostprocessParams) as the
    JAX tool draws them (module docstring), on `device`."""
    import torch

    from mqdet_torch.models.postprocess import PostprocessParams
    from mqdet_torch.ops.anchors import anchors_for_fpn

    shapes = [(-(-hw[0] // s), -(-hw[1] // s)) for s in STRIDES]
    rng = np.random.default_rng(seed)
    bbox = [rng.standard_normal((cp, h * w, 4)).astype(np.float32) for h, w in shapes]
    ctr = [rng.standard_normal((cp, h * w)).astype(np.float32) for h, w in shapes]
    dot = [(rng.standard_normal((cp, h * w, tokens)) - 3.0).astype(np.float32) for h, w in shapes]
    agg = np.zeros((cp, classes, tokens), np.float32)
    for j in range(classes):
        agg[:, j, 2 * j + 1: 2 * j + 3] = 0.5

    def t(a):
        return torch.from_numpy(a).to(device)

    head_out = {  # the head's layout: boxes and centerness as (B, C, H, W) maps, logits (B, HW, T)
        "bbox_reg": [t(b.reshape(cp, h, w, 4)).permute(0, 3, 1, 2) for b, (h, w) in zip(bbox, shapes)],
        "centerness": [t(c.reshape(cp, 1, h, w)) for c, (h, w) in zip(ctr, shapes)],
        "dot_product_logits": [t(d) for d in dot],
    }
    anchors = [t(a) for a in anchors_for_fpn(tuple(hw), strides=STRIDES, sizes=(64, 128, 256, 512, 1024),
                                             aspect_ratios=(1.0,))]
    sizes = t(np.tile(np.asarray([hw], np.float32), (cp, 1)))
    return head_out, anchors, t(agg), sizes, PostprocessParams(**PARAMS)


def postproc(device, hw=(800, 1344), tokens: int = 256, classes: int = 40, iters: int = 10, warmup: int = 2,
             emit=None) -> Dict[str, float]:
    """The module docstring's report on `device`."""
    import torch

    from mqdet_torch.models.postprocess import atss_candidates, atss_postprocess, atss_select
    from mqdet_torch.tools import host_ms

    head_out, anchors, agg, sizes, p = postproc_inputs(device, hw, tokens=tokens, classes=classes)
    cands = atss_candidates(head_out, anchors, agg, sizes, p)
    rep = {}
    for key, fn in (("postproc_full_ms", lambda: atss_postprocess(head_out, anchors, agg, sizes, p)),
                    ("candidates_only_ms", lambda: atss_candidates(head_out, anchors, agg, sizes, p)),
                    ("nms_only_ms", lambda: atss_select(*cands, p))):
        rep[key] = statistics.median(host_ms(torch.inference_mode()(fn), iters, warmup))
        if emit is not None:
            emit({key: rep[key]})
    return rep


def main(argv=None) -> int:
    from mqdet_torch.tools import device_name, emit, tool_args

    args, dev = tool_args(__doc__.split("\n")[0], argv)
    shape = dict(hw=(64, 64), tokens=16, classes=7) if args.tiny else {}
    postproc(dev, emit=emit, **shape)
    emit({"device": device_name(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
