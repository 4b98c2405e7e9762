"""Inference entry points for chunked evaluation (counterpart of
`mqdet_tpu/engine/predict.py`): the image tower runs once per image, then the
text-conditioned head (GCP-BERT + VLDyHead + ATSS decoding + class-aware
NMS) runs once per group of CP prompt chunks.

PyTorch runs eagerly, so the JAX package's single jitted dispatch becomes a
Python loop over the groups under `torch.inference_mode()`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from mqdet_torch.core.detections import Detections
from mqdet_torch.models.postprocess import PostprocessParams, atss_postprocess
from mqdet_torch.ops.anchors import anchors_for_fpn


def make_split_predict_fns(model, image_hw: Tuple[int, int], cfg):
    """Returns (encode_fn, head_fn):
      encode_fn(images (1, 3, H, W)) -> fpn_feats (list of 5 NCHW maps)
      head_fn(fpn_feats, input_ids (CP, T), attention_mask (CP, T),
              queries (CP, V, C), query_mask (CP, V, T), agg_map (CP, Cls, T),
              image_sizes (CP, 2)) -> Detections with a leading CP dim
    Inputs are moved to the model's device."""
    if cfg.MODEL.DYHEAD.SCORE_AGG != "MEAN":
        raise NotImplementedError("only MEAN score aggregation is ported")
    dev = next(model.parameters()).device
    anchors = [
        torch.from_numpy(a).to(dev)
        for a in anchors_for_fpn(
            image_hw,
            strides=tuple(cfg.MODEL.RPN.ANCHOR_STRIDE),
            sizes=tuple(cfg.MODEL.RPN.ANCHOR_SIZES),
            aspect_ratios=tuple(cfg.MODEL.RPN.ASPECT_RATIOS),
        )
    ]
    p = PostprocessParams(
        pre_nms_thresh=cfg.MODEL.ATSS.INFERENCE_TH,
        pre_nms_top_n=cfg.MODEL.ATSS.PRE_NMS_TOP_N,
        nms_thresh=cfg.MODEL.ATSS.NMS_TH,
        detections_per_img=cfg.MODEL.ATSS.DETECTIONS_PER_IMG,
    )
    use_queries = cfg.VISION_QUERY.ENABLED

    @torch.inference_mode()
    def encode_fn(images):
        return model.encode_image(images.to(dev))

    @torch.inference_mode()
    def head_fn(fpn_feats, input_ids, attention_mask, queries, query_mask, agg_map, image_sizes):
        out = model.forward_head(
            fpn_feats,
            input_ids.to(dev),
            attention_mask.to(dev),
            queries.to(dev) if use_queries else None,
            query_mask.to(dev) if use_queries else None,
        )
        return atss_postprocess(out, anchors, agg_map.to(dev), image_sizes.to(dev), p)

    return encode_fn, head_fn


def make_protocol_fn(model, image_hw: Tuple[int, int], cfg):
    """Whole LVIS-protocol function for one image:

      protocol_fn(image (1, 3, H, W), input_ids (G, CP, T),
                  attention_mask (G, CP, T), queries (G, CP, V, C),
                  query_mask (G, CP, V, T), agg_map (G, CP, Cls, T),
                  image_sizes (G, CP, 2)) -> Detections with leading (G, CP) dims

    The backbone runs once; the head runs once per group."""
    encode_fn, head_fn = make_split_predict_fns(model, image_hw, cfg)

    @torch.inference_mode()
    def protocol_fn(image, input_ids, attention_mask, queries, query_mask, agg_map, image_sizes):
        feats = encode_fn(image)
        return Detections.stack([
            head_fn(feats, input_ids[g], attention_mask[g], queries[g], query_mask[g],
                    agg_map[g], image_sizes[g])
            for g in range(input_ids.shape[0])
        ])

    return protocol_fn
