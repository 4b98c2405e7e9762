"""MQ-GLIP meta-architecture (counterpart of `mqdet_tpu/models/mq_glip.py`;
reference modeling/detector/generalized_vl_rcnn_new.py).

Swin -> FPN -> [vision queries -> PreSelect -> GCP-BERT] -> VLDyHead, with the
reference's module tree (`backbone.body`, `backbone.fpn`,
`language_backbone.body.model`, `rpn.head`). `encode_image` (text
independent) runs once per image; `forward_head` (text dependent) runs once
per group of prompt chunks.

MODEL.LANGUAGE_BACKBONE.MODEL_TYPE picks the language tower by its base name,
as JAX's `MQGLIP.setup` does: `clip` the CLIP text transformer (width
LANG_DIM, HIDDEN_LAYERS blocks, NUM_HEADS heads), `rnn` the bidirectional
LSTM encoder (LANG_DIM // 2 a direction), anything else the GCP-BERT tower
(`models/text_towers.py`, `models/bert.py`). The CLIP and RNN towers take no
vision queries (VISION_QUERY.ENABLED off): `forward_head` raises if given
some. MODEL.SWINT.VERSION picks Swin v1 / v2 / vl / v2_vl
(`models/swin.py`); no text reaches the backbone, as in JAX, so vl and v2_vl
compute v1's function.

MQ-Det's model switches are the JAX module's: the GCP variants
(`models/bert.py`), the head's (`models/vldyhead.py`), and two on the
queries: LEARNABLE_BANK makes the bank a zero-init parameter
`qv_layer_learnable_bank` (rows, slots, C), sized by `bank_shape`
(`QuerySelector.bank_table_shape()`; `utils.builders.install_learnable_bank`
writes the bank's values), and `queries` then carries int (row, slot)
indices, gathered from it; ADD_VISION_LAYER adds the zero-init prompt
`tunable_vision_linear` (1000, C) to the first V query rows.

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

import os
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from mqdet_torch.models.bert import LanguageBackbone
from mqdet_torch.models.fpn import FPN
from mqdet_torch.models.layers import avg_pool_2x, cl, training_draws
from mqdet_torch.models.swin import SwinTransformer
from mqdet_torch.models.text_towers import CLIPTextTransformer, RNNEncoder
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
            sw.DROP_PATH_RATE, sw.VERSION,
        )
        e = sw.EMBED_DIM
        self.fpn = FPN([2 * e, 4 * e, 8 * e], cfg.MODEL.BACKBONE.OUT_CHANNELS, bool(cfg.MODEL.FPN.USE_GN),
                       bool(cfg.MODEL.FPN.USE_RELU))


class _Tower(nn.Module):
    """The CLIP or RNN language tower under the reference's `body`."""

    def __init__(self, body: nn.Module):
        super().__init__()
        self.body = body

    def forward(self, input_ids, attention_mask, generator=None):
        if isinstance(self.body, RNNEncoder):
            return self.body(input_ids, attention_mask, generator)
        return self.body(input_ids, attention_mask)


def language_tower(cfg, remat: bool = False) -> nn.Module:
    """MODEL.LANGUAGE_BACKBONE.MODEL_TYPE's tower, by its base name (JAX's
    `MQGLIP.setup`, mq_glip.py:213-231)."""
    lb = cfg.MODEL.LANGUAGE_BACKBONE
    kind = os.path.basename(lb.MODEL_TYPE)
    if kind == "clip":
        return _Tower(CLIPTextTransformer(width=lb.LANG_DIM, layers=lb.HIDDEN_LAYERS, heads=lb.NUM_HEADS))
    if kind == "rnn":  # the bidirectional output is 2 x hidden (reference rnn_model.py:54)
        return _Tower(RNNEncoder(hidden_size=lb.LANG_DIM // 2))
    return LanguageBackbone(cfg, remat)


class _RPN(nn.Module):
    def __init__(self, cfg, remat: bool = False):
        super().__init__()
        self.head = VLDyHead(cfg, remat)


class MQGLIP(nn.Module):
    def __init__(self, cfg, bank_shape: Optional[Tuple[int, int, int]] = None):
        super().__init__()
        vq = cfg.VISION_QUERY
        # activation checkpointing of the text layers and head stages (JAX's rule)
        remat = bool(cfg.TPU.REMAT or cfg.MODEL.DYHEAD.USE_CHECKPOINT or cfg.MODEL.LANGUAGE_BACKBONE.USE_CHECKPOINT)
        c = cfg.MODEL.BACKBONE.OUT_CHANNELS
        if vq.LEARNABLE_BANK and bank_shape is None:
            raise ValueError("LEARNABLE_BANK needs the bank's (rows, slots, C): build_model(cfg, "
                             "bank_shape=selector.bank_table_shape())")
        self.qv_layer_learnable_bank = (
            nn.Parameter(torch.zeros(bank_shape[0], bank_shape[1], c)) if vq.LEARNABLE_BANK else None
        )
        self.tunable_vision_linear = nn.Parameter(torch.zeros(1000, c)) if vq.ADD_VISION_LAYER else None
        self.query_fusion = bool(vq.QUERY_FUSION)
        self.backbone = _Backbone(cfg)
        self.language_backbone = language_tower(cfg, remat)
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
        batch CP (chunk parallelism): features are broadcast to the text batch.
        Integer `queries` (..., 2) are (row, slot) indices into the learnable
        bank."""
        b_text = input_ids.shape[0]
        if fpn_feats[0].shape[0] == 1 and b_text > 1:
            fpn_feats = [cl(f.expand(b_text, *f.shape[1:])) for f in fpn_feats]
        if queries is not None and not queries.is_floating_point():
            if self.qv_layer_learnable_bank is None:
                raise ValueError("integer queries index the learnable bank: VISION_QUERY.LEARNABLE_BANK is off")
            queries = self.qv_layer_learnable_bank[queries[..., 0].long(), queries[..., 1].long()]
        if queries is not None and self.tunable_vision_linear is not None:
            queries = queries + self.tunable_vision_linear[None, :queries.shape[1]].to(queries.dtype)
        if isinstance(self.language_backbone, _Tower):
            if queries is not None:  # no GCP pathway in these towers
                raise ValueError("vision queries require the bert language backbone: set VISION_QUERY.ENABLED off")
            lang = self.language_backbone(input_ids, attention_mask, training_draws(deterministic, generator))
        else:
            lang = self.language_backbone(
                input_ids,
                attention_mask,
                queries=queries.to(self.dtype) if queries is not None else None,
                query_mask=query_mask,
                image_tokens=flatten_fpn_features(fpn_feats) if queries is not None else None,
            )
        out = self.rpn.head(
            fpn_feats, lang["hidden"], lang["masks"], training_draws(deterministic, generator),
            embedding=lang["embedded"],
            augmented_vision=lang.get("augmented_vision") if self.query_fusion else None,
            query_mask=query_mask if self.query_fusion else None,
            lang_aggregate=lang["aggregate"],
        )
        out["lang"] = lang
        return out

    def forward(self, images, input_ids, attention_mask, queries=None, query_mask=None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        fpn_feats = self.encode_image(images, deterministic, generator)
        out = self.forward_head(fpn_feats, input_ids, attention_mask, queries, query_mask,
                                deterministic, generator)
        out["fpn_feats"] = fpn_feats
        return out
