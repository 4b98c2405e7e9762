"""Inference entry points for chunked evaluation (counterpart of
`mqdet_tpu/engine/predict.py`): the image tower runs once per image, then the
text-conditioned head runs once per group of CP prompt chunks. For MQ-GLIP
the head is GCP-BERT + VLDyHead + ATSS decoding + class-aware NMS; for
MQ-GroundingDINO it is GCP-BERT + the deformable encoder and decoder +
`gdino_postprocess`, behind the same signatures.

PyTorch runs eagerly, so the JAX package's single jitted dispatch becomes a
Python loop over the groups under `torch.inference_mode()`.

    make_predict_fn           encode + head in one call, any batch
    make_protocol_fn          one image x G groups of CP chunks
    make_batched_protocol_fn  B images x G groups: the head at batch B * CP
    pad_image_to_bucket       host-side zero padding to the bucket

Each runs on the model's device: the card, unless the caller left the model on
the CPU.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mqdet_torch.core.detections import Detections
from mqdet_torch.models.gdino import MQGroundingDINO, gdino_postprocess
from mqdet_torch.models.layers import cl
from mqdet_torch.models.postprocess import PostprocessParams, atss_postprocess
from mqdet_torch.ops.anchors import anchors_for_fpn
from mqdet_torch.utils.profiling import annotate


def _make_gdino_split_fns(model, cfg):
    """MQ-GroundingDINO's (encode_fn, head_fn): encode_fn gives the
    input_proj levels; head_fn runs `forward_head` and `gdino_postprocess`
    (one detection slot per query)."""
    dev = next(model.parameters()).device
    box_threshold = cfg.GROUNDINGDINO.box_threshold
    use_queries = cfg.VISION_QUERY.ENABLED

    @torch.inference_mode()
    def encode_fn(images):
        with annotate("encode"):
            return model.encode_image(images.to(dev))

    @torch.inference_mode()
    def head_fn(srcs, input_ids, attention_mask, queries, query_mask, agg_map, image_sizes):
        out = model.forward_head(
            srcs,
            input_ids.to(dev),
            attention_mask.to(dev),
            queries.to(dev) if use_queries else None,
            query_mask.to(dev) if use_queries else None,
        )
        with annotate("postprocess"):
            return gdino_postprocess(out["pred_logits"], out["pred_boxes"], agg_map.to(dev),
                                     image_sizes.to(dev), box_threshold)

    return encode_fn, head_fn


def glip_postprocess_setup(cfg, image_hw: Tuple[int, int], device):
    """MQ-GLIP's ATSS decoding inputs at one bucket: (the anchors of each
    level on `device`, PostprocessParams from cfg.MODEL.ATSS).
    MODEL.DYHEAD.SCORE_AGG: JAX stores it in PostprocessParams and reads it
    nowhere; its post-processor always takes the MEAN through the
    aggregation matrix, and so does this one, whatever the key says."""
    anchors = [
        torch.from_numpy(a).to(device)
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
    return anchors, p


def make_split_predict_fns(model, image_hw: Tuple[int, int], cfg):
    """Returns (encode_fn, head_fn):
      encode_fn(images (1, 3, H, W)) -> image features (list of NCHW maps:
                5 FPN levels for MQ-GLIP, GROUNDINGDINO.num_feature_levels
                for MQ-GroundingDINO)
      head_fn(features, input_ids (CP, T), attention_mask (CP, T),
              queries (CP, V, C), query_mask (CP, V, T), agg_map (CP, Cls, T),
              image_sizes (CP, 2)) -> Detections with a leading CP dim
    Dispatches on the model family. Inputs are moved to the model's device."""
    if isinstance(model, MQGroundingDINO):
        return _make_gdino_split_fns(model, cfg)
    dev = next(model.parameters()).device
    anchors, p = glip_postprocess_setup(cfg, image_hw, dev)
    use_queries = cfg.VISION_QUERY.ENABLED

    @torch.inference_mode()
    def encode_fn(images):
        with annotate("encode"):
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
        with annotate("postprocess"):
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
        with annotate("protocol"):
            feats = encode_fn(image)
            dets = []
            for g in range(input_ids.shape[0]):
                with annotate("head_group", g=g):
                    dets.append(head_fn(feats, input_ids[g], attention_mask[g], queries[g], query_mask[g],
                                        agg_map[g], image_sizes[g]))
            return Detections.stack(dets)

    return protocol_fn


def make_predict_fn(model, image_hw: Tuple[int, int], cfg):
    """One call from pixels to detections for one image bucket, at any batch
    (the JAX package's `make_predict_fn`):

      predict(images (B, 3, H, W), input_ids (B, T), attention_mask (B, T),
              queries (B, V, C), query_mask (B, V, T), agg_map (B, Cls, T),
              image_sizes (B, 2)) -> Detections with a leading B dim

    Image b is scored against prompt b. MQ-GLIP: the forward, then ATSS
    decoding and class-aware NMS; MQ-GroundingDINO: its forward and
    `gdino_postprocess`."""
    encode_fn, head_fn = make_split_predict_fns(model, image_hw, cfg)

    @torch.inference_mode()
    def predict(images, input_ids, attention_mask, queries, query_mask, agg_map, image_sizes):
        return head_fn(encode_fn(images), input_ids, attention_mask, queries, query_mask, agg_map, image_sizes)

    return predict


def pad_image_to_bucket(image: np.ndarray, bucket_hw: Tuple[int, int]) -> np.ndarray:
    """Host-side: zero-pad an (H, W, 3) image to the static bucket size."""
    h, w = bucket_hw
    out = np.zeros((h, w, image.shape[-1]), image.dtype)
    out[: image.shape[0], : image.shape[1]] = image
    return out


def make_batched_protocol_fn(model, image_hw: Tuple[int, int], cfg, image_batch: int):
    """B images x G chunk groups (the JAX package's
    `make_batched_protocol_fn`):

      protocol_fn(images (B, 3, H, W), image_sizes (B, 2),
                  input_ids (G, CP, T), attention_mask (G, CP, T),
                  queries (G, CP, V, C), query_mask (G, CP, V, T),
                  agg_map (G, CP, Cls, T))
        -> Detections with leading (G, B * CP) dims; within a group, entry
           i * CP + c is image i scored against chunk c (image-major).

    Every image meets the same prompts, so the (image, chunk) grid is a cross
    product: the image tower runs once on the B images, and each group's head
    runs at batch B * CP on the features repeated image-major (each level of
    the list) and the prompts tiled B times. Both families."""
    encode_fn, head_fn = make_split_predict_fns(model, image_hw, cfg)
    b = int(image_batch)

    @torch.inference_mode()
    def protocol_fn(images, image_sizes, input_ids, attention_mask, queries, query_mask, agg_map):
        if images.shape[0] != b:
            raise ValueError(f"built for {b} images, got {images.shape[0]}")
        cp = input_ids.shape[1]

        def tile(x):
            return None if x is None else x.repeat(b, *(1,) * (x.dim() - 1))

        with annotate("protocol"):
            feats = [cl(f.repeat_interleave(cp, dim=0)) for f in encode_fn(images)]
            sizes = image_sizes.repeat_interleave(cp, dim=0)
            dets = []
            for g in range(input_ids.shape[0]):
                with annotate("head_group", g=g):
                    dets.append(head_fn(feats, tile(input_ids[g]), tile(attention_mask[g]), tile(queries[g]),
                                        tile(query_mask[g]), tile(agg_map[g]), sizes))
            return Detections.stack(dets)

    return protocol_fn
