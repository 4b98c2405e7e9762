"""Single-image demo predictor (counterpart of `mqdet_tpu/engine/demo.py`;
reference GLIPDemo, maskrcnn_benchmark/engine/predictor_glip.py:28): an RGB
numpy image and a list of category names in, the detections above a
confidence threshold out, with vision queries from a bank when a selector
is given. It wraps `engine/predict.py::make_split_predict_fns`, built for
the first TPU.IMAGE_BUCKETS entry as in JAX, so it serves the families that
dispatches to: MQ-GLIP and MQ-GroundingDINO. The model runs where its
parameters are (the card unless it was left on the CPU).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mqdet_torch.data import grounding as G
from mqdet_torch.data.tokenizer import get_tokenizer
from mqdet_torch.data.transforms import EvalTransform
from mqdet_torch.engine.predict import make_split_predict_fns
from mqdet_torch.mq.selector import QuerySelector


class MQDetDemo:
    def __init__(self, cfg, model, selector: Optional[QuerySelector] = None, confidence_threshold: float = 0.5,
                 tokenizer=None):
        """`tokenizer`: the prompt's (by default `get_tokenizer` of the
        config's TOKENIZER_TYPE, as JAX's demo builds it)."""
        self.cfg = cfg
        self.model = model
        self.selector = selector
        self.threshold = confidence_threshold
        self.device = next(model.parameters()).device
        self.tokenizer = tokenizer or get_tokenizer(cfg.MODEL.LANGUAGE_BACKBONE.TOKENIZER_TYPE)
        self.transform = EvalTransform(cfg)
        self.encode_fn, self.head_fn = make_split_predict_fns(model, tuple(cfg.TPU.IMAGE_BUCKETS[0]), cfg)

    def __call__(self, image: np.ndarray, categories: Sequence[str]):
        """image: (H, W, 3) uint8 RGB; categories: the class names. Returns
        {boxes (N, 4) xyxy in the image's coordinates, scores (N,), labels
        (N,) 1-based into `categories`, names}."""
        ind_to_class = {i + 1: name for i, name in enumerate(categories)}
        bundle = G.build_prompt(
            sorted(ind_to_class), ind_to_class, self.tokenizer,
            max_text_len=self.cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN,
            separation_tokens=self.cfg.DATASETS.SEPARATION_TOKENS,
        )
        _, agg_map, _ = G.pad_prompt_maps(bundle, self.cfg.VISION_QUERY.MAX_CLASSES_PER_PROMPT)
        padded, (oh, ow), (sy, sx) = self.transform(image, device=self.device)
        feats = self.encode_fn(padded)
        if self.selector is not None and self.selector.bank is not None:
            q, qm, _ = self.selector.select(bundle.label_ids, bundle.all_map, False)
            queries, query_mask = torch.from_numpy(q[None]), torch.from_numpy(qm[None])
        else:
            queries = torch.zeros(1, 1, self.cfg.MODEL.BACKBONE.OUT_CHANNELS)
            query_mask = torch.zeros(1, 1, self.cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN)
        dets = self.head_fn(
            feats, torch.from_numpy(np.asarray(bundle.input_ids)[None]),
            torch.from_numpy(np.asarray(bundle.attention_mask)[None]), queries, query_mask,
            torch.from_numpy(np.asarray(agg_map)[None]), torch.tensor([[oh, ow]], dtype=torch.float32),
        )
        scores = dets.scores[0].float().cpu().numpy()
        labels = dets.labels[0].cpu().numpy()
        keep = scores >= self.threshold
        boxes = dets.boxes[0].float().cpu().numpy()[keep] * np.array([sx, sy, sx, sy], np.float32)
        return {
            "boxes": boxes,
            "scores": scores[keep],
            "labels": labels[keep],
            "names": [ind_to_class[int(lab)] for lab in labels[keep]],
        }
