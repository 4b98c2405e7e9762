"""Where the MQ-GLIP-T LVIS protocol's time goes, component by component
(the port of `tools/perf_bisect.py`).

    python -m mqdet_torch.tools.perf_bisect
    python -m mqdet_torch.tools.perf_bisect --device cpu --tiny

On MQ-GLIP-T as bench.py builds it (`tools.glip_t`, one 800x1344 image, CP
4 chunks of 40 labels x 5 queries, seed 0) it times, each as the median of
ITERS calls (default 10, after 2 warm-ups) on the host clock around work
that ends in a device synchronise:

  encode_b1_ms              the image tower (Swin + FPN) on one image
  head_postproc_cp4_ms      the protocol's head function of one group: the
                            language tower, the VLDyHead, ATSS decoding and NMS
  head_raw_cp4_ms           `forward_head` alone (no post-processing)
  lang_cp4_ms               the GCP-BERT language tower alone
  postproc_cp4_ms           `atss_postprocess` alone on the head's outputs
  head_raw_nodeform_cp4_ms  `forward_head` of the same model under
                            MODEL.DYHEAD.USE_DFCONV off (plain GN convs; the
                            weights the two models share copied over)
  dcn_l0_pallas_ms          one DCN at the level-0 shape (CP, 100, 168, 256),
                            inputs from default_rng(0) as the JAX tool draws
                            them, by `modulated_deform_conv_pallas`: the band
                            kernel K1 (MQDET_DEFORM_IMPL unset or `pallas`)
  dcn_l0_window_ms          the same by `modulated_deform_conv_window`: the
                            gather kernel K2 (MQDET_DEFORM_IMPL=window)
  conv3x3_l0_plain_ms       one cuDNN 3x3 convolution at that shape

Each key prints as a JSON line when measured, and the whole report as the
last line. `bisect(...)` takes a model the caller built; `split_by_module`
is chip_smoke.py's phase 6 (a protocol run with a synchronise at the
boundaries of named modules).
"""
from __future__ import annotations

import statistics
import sys
import time
from typing import Callable, Dict, List

import numpy as np


def split_by_module(protocol: Callable, args, parts: Dict[str, List]):
    """One protocol(*args) run with a device synchronise before and after
    each module of `parts` ({name: [modules]}, none inside another):
    (total s, {name: s}, {name: calls}). The synchronisations stop the host
    running ahead of the device, so the total exceeds the protocol's p50:
    the split says where the time goes, not how long the protocol takes."""
    import torch

    spent = {name: 0.0 for name in parts}
    calls = {name: 0 for name in parts}
    start = {}

    def pre(mod, args):
        torch.cuda.synchronize()
        start[id(mod)] = time.perf_counter()

    def post(name):
        def hook(mod, args, out):
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - start[id(mod)]
            calls[name] += 1
        return hook

    handles = []
    for name, mods in parts.items():
        for m in mods:
            handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post(name))]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        protocol(*args)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for h in handles:
            h.remove()
    return total, spent, calls


def level0_inputs(cp: int, h: int, w: int, c: int, device, dtype, seed: int = 0):
    """(x, offset, mask, weight, bias) at one pyramid level as the JAX tool
    draws them: x N(0, 1), offsets N(0, 0.5), mask U(0, 1), weight N(0, 0.02)
    HWIO, bias 0."""
    import torch

    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((cp, h, w, c)), rng.standard_normal((cp, h, w, 18)) * 0.5,
              rng.uniform(0, 1, (cp, h, w, 9)), rng.standard_normal((3, 3, c, c)) * 0.02, np.zeros(c))
    return tuple(torch.from_numpy(a).to(device, dtype) for a in arrays)


def nodeform_like(model, cfg):
    """MQ-GLIP under MODEL.DYHEAD.USE_DFCONV off on `model`'s device and
    dtype, built there, with every tensor the two models share copied from
    `model` (the plain convs keep torch's init: the timing does not read
    the values)."""
    import torch

    from mqdet_torch.utils.builders import build_model

    p = next(model.parameters())
    nd_cfg = cfg.clone()
    nd_cfg.MODEL.DYHEAD.USE_DFCONV = False
    with torch.device(p.device):
        nd = build_model(nd_cfg)
    nd = nd.to(p.device, p.dtype).to(memory_format=torch.channels_last).eval()
    own, theirs = nd.state_dict(), model.state_dict()
    nd.load_state_dict({k: v for k, v in theirs.items() if k in own and own[k].shape == v.shape}, strict=False)
    return nd


def dcn_routes(cfg, x, off, mask, wt, bias):
    """{name: call} of one DCN at a level-0 shape: the band kernel, the
    gather kernel, and one cuDNN 3x3 convolution (bf16, channels_last)."""
    import torch

    from mqdet_torch.ops import deform_conv as dc

    r = cfg.TPU.DEFORM_RADIUS
    rows = 16 if x.shape[1] >= 100 else 8  # the model's block rows at this level
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
    wc = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return {
        "pallas": lambda: dc.modulated_deform_conv_pallas(x, off, mask, wt, bias, stride=1, radius=r,
                                                          block_rows=rows),
        "window": lambda: dc.modulated_deform_conv_window(x, off, mask, wt, bias, stride=1, radius=r),
        "conv": lambda: torch.nn.functional.conv2d(xc, wc, padding=1),
    }


def bisect(model, cfg, hw, image, text, iters: int = 10, warmup: int = 2, emit=None) -> Dict[str, float]:
    """The module docstring's report for `model` (MQ-GLIP) at bucket `hw`:
    `image` (1, 3, H, W) and `text` (protocol_inputs' list, (G, CP, ...)
    each; group 0 is timed), on the model's device. `emit(record)` is called
    with each {key: ms} as it is measured."""
    import torch

    from mqdet_torch.engine.predict import glip_postprocess_setup, make_split_predict_fns
    from mqdet_torch.models.mq_glip import flatten_fpn_features
    from mqdet_torch.models.postprocess import atss_postprocess
    from mqdet_torch.tools import host_ms

    rep = {}

    def put(key, fn):
        rep[key] = statistics.median(host_ms(fn, iters, warmup))
        if emit is not None:
            emit({key: rep[key]})

    p = next(model.parameters())
    dev, dtype = p.device, p.dtype
    ids, am, q, qm, agg, sizes = (t[0] for t in text)
    cp = ids.shape[0]
    encode_fn, head_fn = make_split_predict_fns(model, hw, cfg)
    put("encode_b1_ms", lambda: encode_fn(image))
    feats = encode_fn(image)
    put("head_postproc_cp4_ms", lambda: head_fn(feats, ids, am, q, qm, agg, sizes))

    def raw(m):
        @torch.inference_mode()
        def run():
            return m.forward_head(feats, ids, am, q, qm)
        return run

    put("head_raw_cp4_ms", raw(model))
    with torch.inference_mode():
        tokens = flatten_fpn_features([f.expand(cp, *f.shape[1:]) for f in feats])
    lang = torch.inference_mode()(lambda: model.language_backbone(ids, am, queries=q.to(dtype), query_mask=qm,
                                                                   image_tokens=tokens))
    put("lang_cp4_ms", lang)
    anchors, pp = glip_postprocess_setup(cfg, hw, dev)
    out = raw(model)()
    put("postproc_cp4_ms", torch.inference_mode()(lambda: atss_postprocess(out, anchors, agg, sizes, pp)))
    del out
    nd = nodeform_like(model, cfg)
    put("head_raw_nodeform_cp4_ms", raw(nd))
    del nd
    c = cfg.MODEL.BACKBONE.OUT_CHANNELS
    args = level0_inputs(cp, -(-hw[0] // 8), -(-hw[1] // 8), c, dev, dtype)
    routes = dcn_routes(cfg, *args)
    for name, key in (("pallas", "dcn_l0_pallas_ms"), ("window", "dcn_l0_window_ms"),
                      ("conv", "conv3x3_l0_plain_ms")):
        put(key, torch.inference_mode()(routes[name]))
    return rep


def main(argv=None) -> int:
    import json

    from mqdet_torch.tools import device_name, emit, glip_t, tool_args
    from mqdet_torch.utils.builders import protocol_inputs, synthetic_batch

    def extra(ap):
        ap.add_argument("--iters", type=int, default=10)

    args, dev = tool_args(__doc__.split("\n")[0], argv, extra)
    model, cfg, hw = glip_t(args.tiny, dev)
    image, text = protocol_inputs(cfg, synthetic_batch, 1, 4, hw)
    image, text = image.to(dev), [t.to(dev) for t in text]
    rep = bisect(model, cfg, hw, image, text, args.iters, emit=emit)
    print(json.dumps(dict(rep, device=device_name(dev))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
