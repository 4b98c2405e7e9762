"""Single-image demo CLI: the port's counterpart of the JAX package's
`tools/demo.py` (reference GLIPDemo usage, predictor_glip.py:28). One image
and a list of category names (or a caption) through the model; the
detections printed as json and, with --output, written.

    python -m mqdet_torch.tools.demo --config-file configs/pretrain/mq-glip-t.yaml \\
        --weight MODEL/mq-glip-t.pth --image cat.jpg \\
        --categories "cat. remote control" [--threshold 0.5] [--output out.json] [--device cpu] [KEY VALUE ...]

The image is read with PIL, as in JAX. The model is `init_params(SOLVER.SEED)`
of the config with --weight (or MODEL.WEIGHT) loaded over it (a reference
`.pth` through the family's rule table, or an `.npz`), and the bank of
VISION_QUERY.QUERY_BANK_PATH when VISION_QUERY.ENABLED. It runs on the card
unless --device cpu.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="MQ-Det single-image demo")
    p.add_argument("--config-file", required=True)
    p.add_argument("--weight", default=None)
    p.add_argument("--image", required=True, help="path to an RGB image")
    p.add_argument("--categories", required=True, help="'. '-separated category names, e.g. 'cat. remote control'")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--output", default=None, help="write detections json here")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> list:
    args = parse_args(argv)
    args.task_config = None
    args.additional_model_config = None
    from PIL import Image

    from mqdet_torch.tools.train import load_config

    from mqdet_torch.engine.demo import MQDetDemo
    from mqdet_torch.mq.selector import QuerySelector
    from mqdet_torch.tools.train import build_cli_model, load_bank, load_weights

    cfg = load_config(args)
    if args.weight:
        cfg.MODEL.WEIGHT = args.weight
    device = torch.device(args.device)
    model = build_cli_model(cfg)
    if cfg.MODEL.WEIGHT:
        load_weights(cfg, model, cfg.MODEL.WEIGHT)
    dtype = getattr(torch, cfg.TPU.COMPUTE_DTYPE) if device.type == "cuda" else torch.float32
    model = model.to(device, dtype).to(memory_format=torch.channels_last).eval()
    bank, selector = load_bank(cfg), None
    if bank is not None:
        vq = cfg.VISION_QUERY
        selector = QuerySelector(bank, num_query_per_class=vq.NUM_QUERY_PER_CLASS, max_labels=vq.MAX_CLASSES_PER_PROMPT)
    demo = MQDetDemo(cfg, model, selector, confidence_threshold=args.threshold)
    image = np.asarray(Image.open(args.image).convert("RGB"))
    categories = [c.strip() for c in args.categories.split(".") if c.strip()]
    out = demo(image, categories)
    dets = [{"box": [float(v) for v in b], "score": float(s), "label": n}
            for b, s, n in zip(out["boxes"], out["scores"], out["names"])]
    print(json.dumps(dets, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(dets, f)
    return dets


if __name__ == "__main__":
    main()
