"""MQ-GLIP meta-architecture (counterpart of `mqdet_tpu/models/mq_glip.py`;
reference modeling/detector/generalized_vl_rcnn_new.py).

Swin -> FPN -> [vision queries -> PreSelect -> GCP-BERT] -> VLDyHead, with the
reference's module tree (`backbone.body`, `backbone.fpn`,
`language_backbone.body.model`, `rpn.head`). `encode_image` (text
independent) runs once per image; `forward_head` (text dependent) runs once
per group of prompt chunks. Only the bert language backbone and the
non-learnable query bank are built.

Images are NCHW. The compute dtype is the parameters' dtype: move the model
with `.to(device, torch.bfloat16)` for the card, keep fp32 for parity tests.

`deterministic` is the JAX package's switch: False runs the training forward,
Swin's stochastic depth and the fusion's composite with attention dropout,
drawing from `generator` (required then); True (the default) runs neither.

`TPU.REMAT`, `MODEL.DYHEAD.USE_CHECKPOINT` or
`MODEL.LANGUAGE_BACKBONE.USE_CHECKPOINT` (any of them, as JAX's
`mq_glip.py`) checkpoints the language tower's BertLayers and each head
stage's VLFuse, BertLayer and DyConv (`layers.remat`): the same forward and
gradients, fewer live activations, one more forward of those segments in the
backward. Under `no_grad` / `inference_mode` it runs nothing more.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from mqdet_torch.models.bert import LanguageBackbone
from mqdet_torch.models.fpn import FPN
from mqdet_torch.models.layers import avg_pool_2x, cl, training_draws
from mqdet_torch.models.swin import SwinTransformer
from mqdet_torch.models.vldyhead import VLDyHead


def flatten_fpn_features(feats: List[torch.Tensor]) -> torch.Tensor:
    """AvgPool2d(2) + flatten + concat -> (B, sum(H_l/2 * W_l/2), C) tokens."""
    parts = []
    for f in feats:
        p = avg_pool_2x(f)
        parts.append(p.permute(0, 2, 3, 1).reshape(p.shape[0], -1, p.shape[1]))
    return torch.cat(parts, dim=1)


class _Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        sw = cfg.MODEL.SWINT
        self.body = SwinTransformer(
            sw.EMBED_DIM, tuple(sw.DEPTHS), tuple(sw.NUM_HEADS), sw.WINDOW_SIZE, sw.MLP_RATIO,
            sw.DROP_PATH_RATE,
        )
        e = sw.EMBED_DIM
        self.fpn = FPN([2 * e, 4 * e, 8 * e], cfg.MODEL.BACKBONE.OUT_CHANNELS)


class _RPN(nn.Module):
    def __init__(self, cfg, remat: bool = False):
        super().__init__()
        self.head = VLDyHead(cfg, remat)


class MQGLIP(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        vq = cfg.VISION_QUERY
        mq_det = dict(CONDITION_GATE=True, NONLINEAR_GATE=True, NO_CAT=True, FIX_ATTN_GATE=-1.0,
                      ADD_ADAPT_LAYER=False, SHARE_KV=False, AUGMENT_IMAGE_WITH_QUERY=False,
                      NEW_MASK_TOKEN=False, LEARNABLE_BANK=False, ADD_VISION_LAYER=False,
                      QUERY_FUSION=False)
        other = [k for k, v in mq_det.items() if vq[k] != v]
        if other:
            raise NotImplementedError(f"VISION_QUERY options not ported: {other}")
        if cfg.MODEL.LANGUAGE_BACKBONE.MODEL_TYPE != "bert-base-uncased":
            raise NotImplementedError("only the bert language backbone is ported")
        if cfg.MODEL.SWINT.VERSION != "v1":
            raise NotImplementedError("only Swin v1 is ported")
        # activation checkpointing of the text layers and head stages (JAX's rule)
        remat = bool(cfg.TPU.REMAT or cfg.MODEL.DYHEAD.USE_CHECKPOINT or cfg.MODEL.LANGUAGE_BACKBONE.USE_CHECKPOINT)
        self.backbone = _Backbone(cfg)
        self.language_backbone = LanguageBackbone(cfg, remat)
        self.rpn = _RPN(cfg, remat)

    @property
    def dtype(self) -> torch.dtype:
        return self.rpn.head.bias_lang.dtype

    def encode_image(self, images: torch.Tensor, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        """Swin + FPN on (B, 3, H, W) -> 5 pyramid levels (B, C, H_l, W_l)."""
        feats = self.backbone.body(cl(images.to(self.dtype)), training_draws(deterministic, generator))
        return self.backbone.fpn(feats[1:4])

    def forward_head(
        self,
        fpn_feats: List[torch.Tensor],
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        queries: Optional[torch.Tensor] = None,
        query_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        """GCP-BERT + VLDyHead. fpn_feats may have batch 1 while the text has
        batch CP (chunk parallelism): features are broadcast to the text batch."""
        b_text = input_ids.shape[0]
        if fpn_feats[0].shape[0] == 1 and b_text > 1:
            fpn_feats = [cl(f.expand(b_text, *f.shape[1:])) for f in fpn_feats]
        image_tokens = flatten_fpn_features(fpn_feats) if queries is not None else None
        lang = self.language_backbone(
            input_ids,
            attention_mask,
            queries=queries.to(self.dtype) if queries is not None else None,
            query_mask=query_mask,
            image_tokens=image_tokens,
        )
        out = self.rpn.head(fpn_feats, lang["hidden"], lang["masks"], training_draws(deterministic, generator))
        out["lang"] = lang
        return out

    def forward(self, images, input_ids, attention_mask, queries=None, query_mask=None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        fpn_feats = self.encode_image(images, deterministic, generator)
        out = self.forward_head(fpn_feats, input_ids, attention_mask, queries, query_mask,
                                deterministic, generator)
        out["fpn_feats"] = fpn_feats
        return out
