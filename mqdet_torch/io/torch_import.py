"""Reference-checkpoint names: the rule tables that map the JAX package's flax
parameter paths onto the reference's torch state_dict keys, with their layout
transforms, and the `.pth` loading helpers.

The port's own copy of what it takes from `mqdet_tpu/io/torch_import.py`
(`build_rule_table`, `build_gdino_rule_table` and their `_*_rules`, the
transforms, `load_torch_state_dict`, `strip_prefixes`), so that no module of
the port imports the JAX package. `tests/test_torch_port_dcn.py` pins the
tables and the transforms to the JAX package's. The flax paths name the
parameter leaves of the JAX modules; the port's modules carry the reference
names, so `io/from_jax.py` reads the tables backwards.

  torch Conv2d  (O, I, kH, kW) -> flax Conv   (kH, kW, I, O)
  torch Linear  (O, I)         -> flax Dense  (I, O)
  torch LayerNorm weight       -> flax LayerNorm scale
  torch GroupNorm weight       -> flax GroupNorm scale
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np


def _t_conv(w):
    return np.transpose(w, (2, 3, 1, 0))


def _t_linear(w):
    return np.transpose(w, (1, 0))


def _ident(w):
    return w


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a reference-layout .pth into a flat numpy dict.

    Released MQ-Det checkpoints are DetectronCheckpointer saves
    (reference utils/checkpoint.py:190-205): {"model": state_dict,
    "model_ema": ema_state_dict, "optimizer": ..., "scheduler": ...} where
    model_ema is a TOP-LEVEL SIBLING of "model" (trainer.py:214) and the
    eval path prefers it (utils/ema.py:23-31). Keys may carry "module."
    DataParallel prefixes; strip_prefixes handles those.
    """
    import torch

    raw = torch.load(path, map_location="cpu", weights_only=False)
    if (
        isinstance(raw, dict)
        and isinstance(raw.get("model_ema"), dict)
        and raw["model_ema"]
    ):
        raw = raw["model_ema"]
    elif isinstance(raw, dict) and "model" in raw:
        raw = raw["model"]
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    out = {}
    for k, v in raw.items():
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
    return out


def strip_prefixes(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop 'module.' wrappers; prefer EMA weights when present
    (released MQ-Det checkpoints store model_ema alongside)."""
    ema = {k[len("model_ema."):]: v for k, v in state.items() if k.startswith("model_ema.")}
    if ema:
        state = ema
    return {re.sub(r"^module\.", "", k): v for k, v in state.items()}


# ---------------------------------------------------------------------------
# mapping rules: (regex on our flax path, template for reference key, transform)
# our paths use '/' separators under params/...
# ---------------------------------------------------------------------------


def _t_inproj_w(i):
    """Slice q/k/v (i=0/1/2) out of a torch MultiheadAttention in_proj_weight
    (3C, C) and transpose to a flax Dense kernel."""

    def tf(w):
        c = w.shape[0] // 3
        return np.transpose(w[i * c : (i + 1) * c], (1, 0))

    return tf


def _t_inproj_b(i):
    def tf(b):
        c = b.shape[0] // 3
        return b[i * c : (i + 1) * c]

    return tf


def _swin_rules(our: str = "backbone", b: str = "backbone.body") -> List[Tuple[str, str, object]]:
    r = []
    r += [
        (rf"{our}/patch_embed_proj/kernel", f"{b}.patch_embed.proj.weight", _t_conv),
        (rf"{our}/patch_embed_proj/bias", f"{b}.patch_embed.proj.bias", _ident),
        (rf"{our}/patch_embed_norm/scale", f"{b}.patch_embed.norm.weight", _ident),
        (rf"{our}/patch_embed_norm/bias", f"{b}.patch_embed.norm.bias", _ident),
    ]
    # blocks: our name layers_{i}_blocks_{j}
    def blk(i, j, ours, theirs, tf):
        return (
            rf"{our}/layers_{i}_blocks_{j}/{ours}",
            f"{b}.layers.{i}.blocks.{j}.{theirs}",
            tf,
        )

    for i in range(4):
        for j in range(24):  # upper bound; unmatched rules are skipped
            r += [
                blk(i, j, "norm1/scale", "norm1.weight", _ident),
                blk(i, j, "norm1/bias", "norm1.bias", _ident),
                blk(i, j, "attn/qkv/kernel", "attn.qkv.weight", _t_linear),
                blk(i, j, "attn/qkv/bias", "attn.qkv.bias", _ident),
                blk(i, j, "attn/proj/kernel", "attn.proj.weight", _t_linear),
                blk(i, j, "attn/proj/bias", "attn.proj.bias", _ident),
                blk(i, j, "attn/relative_position_bias_table",
                    "attn.relative_position_bias_table", _ident),
                blk(i, j, "norm2/scale", "norm2.weight", _ident),
                blk(i, j, "norm2/bias", "norm2.bias", _ident),
                blk(i, j, "mlp/fc1/kernel", "mlp.fc1.weight", _t_linear),
                blk(i, j, "mlp/fc1/bias", "mlp.fc1.bias", _ident),
                blk(i, j, "mlp/fc2/kernel", "mlp.fc2.weight", _t_linear),
                blk(i, j, "mlp/fc2/bias", "mlp.fc2.bias", _ident),
            ]
        r += [
            (rf"{our}/layers_{i}_downsample/norm/scale",
             f"{b}.layers.{i}.downsample.norm.weight", _ident),
            (rf"{our}/layers_{i}_downsample/norm/bias",
             f"{b}.layers.{i}.downsample.norm.bias", _ident),
            (rf"{our}/layers_{i}_downsample/reduction/kernel",
             f"{b}.layers.{i}.downsample.reduction.weight", _t_linear),
            (rf"{our}/norm{i}/scale", f"{b}.norm{i}.weight", _ident),
            (rf"{our}/norm{i}/bias", f"{b}.norm{i}.bias", _ident),
        ]
    return r


def _fpn_rules():
    b = "backbone.fpn"
    r = []
    for lvl in (2, 3, 4):
        r += [
            (rf"fpn/fpn_inner{lvl}/kernel", f"{b}.fpn_inner{lvl}.weight", _t_conv),
            (rf"fpn/fpn_inner{lvl}/bias", f"{b}.fpn_inner{lvl}.bias", _ident),
            (rf"fpn/fpn_layer{lvl}/kernel", f"{b}.fpn_layer{lvl}.weight", _t_conv),
            (rf"fpn/fpn_layer{lvl}/bias", f"{b}.fpn_layer{lvl}.bias", _ident),
        ]
    r += [
        (r"fpn/p6/kernel", f"{b}.top_blocks.p6.weight", _t_conv),
        (r"fpn/p6/bias", f"{b}.top_blocks.p6.bias", _ident),
        (r"fpn/p7/kernel", f"{b}.top_blocks.p7.weight", _t_conv),
        (r"fpn/p7/bias", f"{b}.top_blocks.p7.bias", _ident),
    ]
    return r


def _bert_rules(ob: str = "language_backbone/bert", lb: str = "language_backbone.body.model"):
    r = [
        (rf"{ob}/embeddings/word_embeddings/embedding",
         f"{lb}.embeddings.word_embeddings.weight", _ident),
        (rf"{ob}/embeddings/position_embeddings/embedding",
         f"{lb}.embeddings.position_embeddings.weight", _ident),
        (rf"{ob}/embeddings/token_type_embeddings/embedding",
         f"{lb}.embeddings.token_type_embeddings.weight", _ident),
        (rf"{ob}/embeddings/ln/scale",
         f"{lb}.embeddings.LayerNorm.weight", _ident),
        (rf"{ob}/embeddings/ln/bias",
         f"{lb}.embeddings.LayerNorm.bias", _ident),
    ]
    for i in range(12):
        p = rf"{ob}/layer_{i}"
        q = f"{lb}.encoder.layer.{i}"
        r += [
            (p + r"/attention_self/query/kernel", q + ".attention.self.query.weight", _t_linear),
            (p + r"/attention_self/query/bias", q + ".attention.self.query.bias", _ident),
            (p + r"/attention_self/key/kernel", q + ".attention.self.key.weight", _t_linear),
            (p + r"/attention_self/key/bias", q + ".attention.self.key.bias", _ident),
            (p + r"/attention_self/value/kernel", q + ".attention.self.value.weight", _t_linear),
            (p + r"/attention_self/value/bias", q + ".attention.self.value.bias", _ident),
            (p + r"/attention_output_dense/kernel", q + ".attention.output.dense.weight", _t_linear),
            (p + r"/attention_output_dense/bias", q + ".attention.output.dense.bias", _ident),
            (p + r"/attention_output_ln/scale", q + ".attention.output.LayerNorm.weight", _ident),
            (p + r"/attention_output_ln/bias", q + ".attention.output.LayerNorm.bias", _ident),
            (p + r"/intermediate_dense/kernel", q + ".intermediate.dense.weight", _t_linear),
            (p + r"/intermediate_dense/bias", q + ".intermediate.dense.bias", _ident),
            (p + r"/output_dense/kernel", q + ".output.dense.weight", _t_linear),
            (p + r"/output_dense/bias", q + ".output.dense.bias", _ident),
            (p + r"/output_ln/scale", q + ".output.LayerNorm.weight", _ident),
            (p + r"/output_ln/bias", q + ".output.LayerNorm.bias", _ident),
        ]
    # GCP qv layers + pre-select
    def gcp(our_prefix, their_prefix):
        rr = []
        for ours, theirs, tf in [
            ("attn/norm/scale", "attn.norm.weight", _ident),
            ("attn/norm/bias", "attn.norm.bias", _ident),
            ("attn/norm_kv_ln/scale", "attn.norm_kv.weight", _ident),
            ("attn/norm_kv_ln/bias", "attn.norm_kv.bias", _ident),
            ("attn/to_q/kernel", "attn.to_q.weight", _t_linear),
            ("attn/to_kv/kernel", "attn.to_kv.weight", _t_linear),
            ("attn/to_out/kernel", "attn.to_out.weight", _t_linear),
            ("attn_gate/norm/scale", "attn_gate.norm.weight", _ident),
            ("attn_gate/norm/bias", "attn_gate.norm.bias", _ident),
            ("attn_gate/linear1/kernel", "attn_gate.linear1.weight", _t_linear),
            ("attn_gate/linear2/kernel", "attn_gate.linear2.weight", _t_linear),
            ("ff/norm/scale", "ff.norm.weight", _ident),
            ("ff/norm/bias", "ff.norm.bias", _ident),
            ("ff/linear1/kernel", "ff.linear1.weight", _t_linear),
            ("ff/linear2/kernel", "ff.linear2.weight", _t_linear),
            ("ff_gate", "ff_gate", lambda w: np.asarray(w).reshape(())),
        ]:
            rr.append((our_prefix + "/" + ours, their_prefix + "." + theirs, tf))
        return rr

    for i in range(6):
        r += gcp(
            rf"{ob}/qv_layer_{i}",
            f"{lb}.encoder.qv_layer.{i}",
        )
    for i in range(2):
        p = rf"{ob}/pre_select/layers_{i}"
        q = f"{lb}.pre_select.layers.{i}"
        r += [
            (p + r"/image_condition/norm/scale", q + ".image_condition.norm.weight", _ident),
            (p + r"/image_condition/norm/bias", q + ".image_condition.norm.bias", _ident),
            (p + r"/image_condition/norm_kv_ln/scale", q + ".image_condition.norm_kv.weight", _ident),
            (p + r"/image_condition/norm_kv_ln/bias", q + ".image_condition.norm_kv.bias", _ident),
            (p + r"/image_condition/to_q/kernel", q + ".image_condition.to_q.weight", _t_linear),
            (p + r"/image_condition/to_kv/kernel", q + ".image_condition.to_kv.weight", _t_linear),
            (p + r"/image_condition/to_out/kernel", q + ".image_condition.to_out.weight", _t_linear),
            (p + r"/ff/norm/scale", q + ".ff.norm.weight", _ident),
            (p + r"/ff/norm/bias", q + ".ff.norm.bias", _ident),
            (p + r"/ff/linear1/kernel", q + ".ff.linear1.weight", _t_linear),
            (p + r"/ff/linear2/kernel", q + ".ff.linear2.weight", _t_linear),
            (p + r"/res_mapping/kernel", q + ".res_mapping.weight", _t_linear),
        ]
    return r


def _head_rules():
    h = "rpn.head"
    r = []
    for i in range(8):  # up to NUM_CONVS=8 (GLIP-L)
        # tower ordering per stage: VLFuse (3i), BertEncoderLayer (3i+1),
        # DyConv (3i+2) — vldyhead.py dyhead_tower construction
        fuse = f"{h}.dyhead_tower.{3 * i}.b_attn"
        ours_f = rf"rpn/fuse_{i}/b_attn"
        r += [
            (ours_f + r"/layer_norm_v/scale", fuse + ".layer_norm_v.weight", _ident),
            (ours_f + r"/layer_norm_v/bias", fuse + ".layer_norm_v.bias", _ident),
            (ours_f + r"/layer_norm_l/scale", fuse + ".layer_norm_l.weight", _ident),
            (ours_f + r"/layer_norm_l/bias", fuse + ".layer_norm_l.bias", _ident),
            (ours_f + r"/gamma_v", fuse + ".gamma_v", _ident),
            (ours_f + r"/gamma_l", fuse + ".gamma_l", _ident),
        ]
        for proj in ("v_proj", "l_proj", "values_v_proj", "values_l_proj",
                     "out_v_proj", "out_l_proj"):
            r += [
                (ours_f + rf"/attn/{proj}/kernel", fuse + f".attn.{proj}.weight", _t_linear),
                (ours_f + rf"/attn/{proj}/bias", fuse + f".attn.{proj}.bias", _ident),
            ]
        lang = f"{h}.dyhead_tower.{3 * i + 1}"
        ours_l = rf"rpn/lang_layer_{i}"
        r += [
            (ours_l + r"/attention_self/query/kernel", lang + ".attention.self.query.weight", _t_linear),
            (ours_l + r"/attention_self/query/bias", lang + ".attention.self.query.bias", _ident),
            (ours_l + r"/attention_self/key/kernel", lang + ".attention.self.key.weight", _t_linear),
            (ours_l + r"/attention_self/key/bias", lang + ".attention.self.key.bias", _ident),
            (ours_l + r"/attention_self/value/kernel", lang + ".attention.self.value.weight", _t_linear),
            (ours_l + r"/attention_self/value/bias", lang + ".attention.self.value.bias", _ident),
            (ours_l + r"/attention_output_dense/kernel", lang + ".attention.output.dense.weight", _t_linear),
            (ours_l + r"/attention_output_dense/bias", lang + ".attention.output.dense.bias", _ident),
            (ours_l + r"/attention_output_ln/scale", lang + ".attention.output.LayerNorm.weight", _ident),
            (ours_l + r"/attention_output_ln/bias", lang + ".attention.output.LayerNorm.bias", _ident),
            (ours_l + r"/intermediate_dense/kernel", lang + ".intermediate.dense.weight", _t_linear),
            (ours_l + r"/intermediate_dense/bias", lang + ".intermediate.dense.bias", _ident),
            (ours_l + r"/output_dense/kernel", lang + ".output.dense.weight", _t_linear),
            (ours_l + r"/output_dense/bias", lang + ".output.dense.bias", _ident),
            (ours_l + r"/output_ln/scale", lang + ".output.LayerNorm.weight", _ident),
            (ours_l + r"/output_ln/bias", lang + ".output.LayerNorm.bias", _ident),
        ]
        dy = f"{h}.dyhead_tower.{3 * i + 2}"
        ours_d = rf"rpn/dyconv_tower_{i}"
        for c in range(3):
            r += [
                (ours_d + rf"/dyconv_{c}/kernel", dy + f".DyConv.{c}.conv.weight", _t_conv),
                (ours_d + rf"/dyconv_{c}/bias", dy + f".DyConv.{c}.conv.bias", _ident),
                # USE_DFCONV=False variant: plain conv nests one level deeper
                # on our side (reference Conv3x3Norm keeps `conv` either way)
                (ours_d + rf"/dyconv_{c}/conv/kernel", dy + f".DyConv.{c}.conv.weight", _t_conv),
                (ours_d + rf"/dyconv_{c}/conv/bias", dy + f".DyConv.{c}.conv.bias", _ident),
                (ours_d + rf"/dyconv_{c}/gn/scale", dy + f".DyConv.{c}.bn.weight", _ident),
                (ours_d + rf"/dyconv_{c}/gn/bias", dy + f".DyConv.{c}.bn.bias", _ident),
            ]
        r += [
            (ours_d + r"/attn_conv/kernel", dy + ".AttnConv.1.weight", _t_conv),
            (ours_d + r"/attn_conv/bias", dy + ".AttnConv.1.bias", _ident),
            (ours_d + r"/offset/kernel", dy + ".offset.weight", _t_conv),
            (ours_d + r"/offset/bias", dy + ".offset.bias", _ident),
            (ours_d + r"/dyrelu/fc1/kernel", dy + ".relu.fc.0.weight", _t_linear),
            (ours_d + r"/dyrelu/fc1/bias", dy + ".relu.fc.0.bias", _ident),
            (ours_d + r"/dyrelu/fc2/kernel", dy + ".relu.fc.2.weight", _t_linear),
            (ours_d + r"/dyrelu/fc2/bias", dy + ".relu.fc.2.bias", _ident),
        ]
        r += [
            (rf"rpn/scale_{i}/scale", f"{h}.scales.{i}.scale",
             lambda w: np.asarray(w).reshape(())),
        ]
    r += [
        (r"rpn/cls_logits/kernel", f"{h}.cls_logits.weight", _t_conv),
        (r"rpn/cls_logits/bias", f"{h}.cls_logits.bias", _ident),
        (r"rpn/bbox_pred/kernel", f"{h}.bbox_pred.weight", _t_conv),
        (r"rpn/bbox_pred/bias", f"{h}.bbox_pred.bias", _ident),
        (r"rpn/centerness/kernel", f"{h}.centerness.weight", _t_conv),
        (r"rpn/centerness/bias", f"{h}.centerness.bias", _ident),
        (r"rpn/dot_product_projection_text/kernel",
         f"{h}.dot_product_projection_text.weight", _t_linear),
        (r"rpn/dot_product_projection_text/bias",
         f"{h}.dot_product_projection_text.bias", _ident),
        (r"rpn/log_scale", f"{h}.log_scale", lambda w: np.asarray(w).reshape(1)),
        (r"rpn/bias_lang", f"{h}.bias_lang", _ident),
        (r"rpn/bias0", f"{h}.bias0", lambda w: np.asarray(w).reshape(1)),
    ]
    # MLM head (FUSE_CONFIG.MLM_LOSS; BertLMPredictionHead,
    # utils/fuse_helper.py:27-44 — decoder bias is the tied `mlm_head.bias`)
    r += [
        (r"rpn/mlm_head/transform_dense/kernel",
         f"{h}.mlm_head.transform.dense.weight", _t_linear),
        (r"rpn/mlm_head/transform_dense/bias",
         f"{h}.mlm_head.transform.dense.bias", _ident),
        (r"rpn/mlm_head/transform_ln/scale",
         f"{h}.mlm_head.transform.LayerNorm.weight", _ident),
        (r"rpn/mlm_head/transform_ln/bias",
         f"{h}.mlm_head.transform.LayerNorm.bias", _ident),
        (r"rpn/mlm_head/decoder/kernel",
         f"{h}.mlm_head.decoder.weight", _t_linear),
        (r"rpn/mlm_head/decoder/bias", f"{h}.mlm_head.bias", _ident),
    ]
    return r


def build_rule_table():
    rules = _swin_rules() + _fpn_rules() + _bert_rules() + _head_rules()
    return {our: (theirs, tf) for our, theirs, tf in rules}


def _gdino_rules(enc_layers: int = 6, dec_layers: int = 6):
    """Rule table for `groundingdino_swint_ogc.pth` / MQ-GroundingDINO naming
    (groundingdino_new/models/GroundingDINO/groundingdino.py:130-288,
    transformer.py:157-845, bertwarper.py:26-46):

      backbone.0.*                    Joiner[0] = Swin (swin_transformer.py)
      bert.*                          BertModelWarper re-attaches embeddings/
                                      encoder/pre_select under the same names
      feat_map.*                      text projection (groundingdino.py:191)
      input_proj.{i}.{0,1}.*          1x1/3x3 conv + GroupNorm (:199-229)
      transformer.level_embed / tgt_embed / enc_output(_norm) /
        enc_out_bbox_embed            (transformer.py:157-178,:267)
      transformer.encoder.{layers,text_layers,fusion_layers}.{i}.*
      transformer.decoder.layers.{i}.* / norm / ref_point_head
      bbox_embed.{i}.layers.{j}.*     per-layer box MLPs (shared when
                                      dec_pred_bbox_embed_share, :247-254)

    torch MultiheadAttention in_proj weights are split into our separate
    q/k/v Dense kernels. Rule values may be a tuple of candidate reference
    keys; the first one present in the state dict wins.
    """
    r = []
    r += _swin_rules(our="backbone", b="backbone.0")
    r += _bert_rules(ob="language_backbone/bert", lb="bert")
    r += [
        (r"feat_map/kernel", "feat_map.weight", _t_linear),
        (r"feat_map/bias", "feat_map.bias", _ident),
        (r"level_embed", "transformer.level_embed", _ident),
        (r"tgt_embed", "transformer.tgt_embed.weight", _ident),
        (r"enc_output/kernel", "transformer.enc_output.weight", _t_linear),
        (r"enc_output/bias", "transformer.enc_output.bias", _ident),
        (r"enc_output_norm/scale", "transformer.enc_output_norm.weight", _ident),
        (r"enc_output_norm/bias", "transformer.enc_output_norm.bias", _ident),
        (r"ref_point_head/layers_0/kernel",
         "transformer.decoder.ref_point_head.layers.0.weight", _t_linear),
        (r"ref_point_head/layers_0/bias",
         "transformer.decoder.ref_point_head.layers.0.bias", _ident),
        (r"ref_point_head/layers_1/kernel",
         "transformer.decoder.ref_point_head.layers.1.weight", _t_linear),
        (r"ref_point_head/layers_1/bias",
         "transformer.decoder.ref_point_head.layers.1.bias", _ident),
        (r"dec_norm/scale", "transformer.decoder.norm.weight", _ident),
        (r"dec_norm/bias", "transformer.decoder.norm.bias", _ident),
    ]
    for i in range(4):
        r += [
            (rf"input_proj_{i}_conv/kernel", f"input_proj.{i}.0.weight", _t_conv),
            (rf"input_proj_{i}_conv/bias", f"input_proj.{i}.0.bias", _ident),
            (rf"input_proj_{i}_gn/scale", f"input_proj.{i}.1.weight", _ident),
            (rf"input_proj_{i}_gn/bias", f"input_proj.{i}.1.bias", _ident),
        ]
    for j in range(3):
        r += [
            (rf"enc_out_bbox_embed/layers_{j}/kernel",
             f"transformer.enc_out_bbox_embed.layers.{j}.weight", _t_linear),
            (rf"enc_out_bbox_embed/layers_{j}/bias",
             f"transformer.enc_out_bbox_embed.layers.{j}.bias", _ident),
        ]

    def msda(our_prefix, their_prefix):
        rr = []
        for mod in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
            rr += [
                (f"{our_prefix}/{mod}/kernel", f"{their_prefix}.{mod}.weight", _t_linear),
                (f"{our_prefix}/{mod}/bias", f"{their_prefix}.{mod}.bias", _ident),
            ]
        return rr

    def mha(our_prefix, their_prefix, names=("q", "k", "v", "out")):
        rr = []
        for idx, n in enumerate(names[:3]):
            rr += [
                (f"{our_prefix}/{n}/kernel", f"{their_prefix}.in_proj_weight", _t_inproj_w(idx)),
                (f"{our_prefix}/{n}/bias", f"{their_prefix}.in_proj_bias", _t_inproj_b(idx)),
            ]
        rr += [
            (f"{our_prefix}/{names[3]}/kernel", f"{their_prefix}.out_proj.weight", _t_linear),
            (f"{our_prefix}/{names[3]}/bias", f"{their_prefix}.out_proj.bias", _ident),
        ]
        return rr

    def ln_ffn(our_prefix, their_prefix, norms):
        rr = []
        for n in norms:
            rr += [
                (f"{our_prefix}/{n}/scale", f"{their_prefix}.{n}.weight", _ident),
                (f"{our_prefix}/{n}/bias", f"{their_prefix}.{n}.bias", _ident),
            ]
        for lin in ("linear1", "linear2"):
            rr += [
                (f"{our_prefix}/{lin}/kernel", f"{their_prefix}.{lin}.weight", _t_linear),
                (f"{our_prefix}/{lin}/bias", f"{their_prefix}.{lin}.bias", _ident),
            ]
        return rr

    for i in range(enc_layers):
        enc = f"transformer.encoder.layers.{i}"
        r += msda(f"enc_layer_{i}/self_attn", f"{enc}.self_attn")
        r += ln_ffn(f"enc_layer_{i}", enc, ("norm1", "norm2"))

        txt = f"transformer.encoder.text_layers.{i}"
        r += mha(f"enc_text_{i}", f"{txt}.self_attn")
        r += ln_ffn(f"enc_text_{i}", txt, ("norm1", "norm2"))

        fus = f"transformer.encoder.fusion_layers.{i}"
        r += [
            (rf"enc_fusion_{i}/gamma_v", f"{fus}.gamma_v", _ident),
            (rf"enc_fusion_{i}/gamma_l", f"{fus}.gamma_l", _ident),
            (rf"enc_fusion_{i}/layer_norm_v/scale", f"{fus}.layer_norm_v.weight", _ident),
            (rf"enc_fusion_{i}/layer_norm_v/bias", f"{fus}.layer_norm_v.bias", _ident),
            (rf"enc_fusion_{i}/layer_norm_l/scale", f"{fus}.layer_norm_l.weight", _ident),
            (rf"enc_fusion_{i}/layer_norm_l/bias", f"{fus}.layer_norm_l.bias", _ident),
        ]
        for proj in ("v_proj", "l_proj", "values_v_proj", "values_l_proj",
                     "out_v_proj", "out_l_proj"):
            r += [
                (rf"enc_fusion_{i}/attn/{proj}/kernel", f"{fus}.attn.{proj}.weight", _t_linear),
                (rf"enc_fusion_{i}/attn/{proj}/bias", f"{fus}.attn.{proj}.bias", _ident),
            ]

    for i in range(dec_layers):
        dec = f"transformer.decoder.layers.{i}"
        r += mha(f"dec_layer_{i}", f"{dec}.self_attn",
                 ("sa_q", "sa_k", "sa_v", "sa_out"))
        r += mha(f"dec_layer_{i}", f"{dec}.ca_text",
                 ("ca_text_q", "ca_text_k", "ca_text_v", "ca_text_out"))
        r += msda(f"dec_layer_{i}/cross_attn", f"{dec}.cross_attn")
        r += ln_ffn(f"dec_layer_{i}", dec, ("norm1", "norm2", "norm3", "catext_norm"))
        for j in range(3):
            r += [
                (rf"bbox_embed_{i}/layers_{j}/kernel",
                 (f"bbox_embed.{i}.layers.{j}.weight", f"bbox_embed.0.layers.{j}.weight"),
                 _t_linear),
                (rf"bbox_embed_{i}/layers_{j}/bias",
                 (f"bbox_embed.{i}.layers.{j}.bias", f"bbox_embed.0.layers.{j}.bias"),
                 _ident),
            ]
    return r


def build_gdino_rule_table(enc_layers: int = 6, dec_layers: int = 6):
    return {our: (theirs, tf) for our, theirs, tf in _gdino_rules(enc_layers, dec_layers)}


# ---------------------------------------------------------------------------
# importing a reference checkpoint into the port's model, with the JAX
# package's report (`_import_with_rules` / `import_glip_checkpoint` /
# `import_gdino_checkpoint`)
# ---------------------------------------------------------------------------


def _flax_leaves(model, table) -> List[Tuple[str, str, Optional[int]]]:
    """(flax path, the port's key, in-proj third or None) for every leaf the
    JAX package's tree of the same model holds: one per key, or three (q, k,
    v) for an in-proj tensor, which the JAX tree keeps as three leaves."""
    from mqdet_torch.io.from_jax import IN_PROJ, _inproj_slot, reference_rules

    keys = list(model.state_dict())
    first = {k: reference_rules(model)[k][0] for k in keys if not k.endswith(IN_PROJ)}
    inproj: Dict[str, List[Tuple[int, str]]] = {}
    for name, (ref, tf) in table.items():
        ref = ref[0] if isinstance(ref, tuple) else ref
        if ref.endswith(IN_PROJ):
            inproj.setdefault(ref, []).append((_inproj_slot(ref, tf), name))
    out = []
    for k in keys:
        if k in first:
            out.append((first[k], k, None))
        else:
            out += [(name, k, slot) for slot, name in sorted(inproj[k])]
    return out


def _import_with_rules(model, state: Dict[str, np.ndarray], table, strict: bool = False) -> Dict[str, List[str]]:
    """Fill `model` (in place) from a reference state dict by the rule table,
    leaf by leaf as the JAX package fills its flax tree: a rule's candidate
    keys are tried in order, the first present wins; a shape other than the
    leaf's counts as missing, and so does a leaf the table has no rule for,
    as in JAX. The values are loaded in fp32, then cast to the model's dtype
    by `load_state_dict`. Returns {"matched", "missing",
    "unused"}: flax paths, flax paths (with the shapes where they differ),
    reference keys."""
    import torch

    from mqdet_torch.io.from_jax import inverse_transform

    state = strip_prefixes(state)
    current = {k: v.detach().to("cpu", torch.float32).clone() for k, v in model.state_dict().items()}
    matched, missing, used = [], [], set()
    for name, key, slot in _flax_leaves(model, table):
        if name not in table:  # a leaf the JAX package's table does not name (`from_jax.port_rules`)
            missing.append(name)
            continue
        refs, tf = table[name]
        refs = (refs,) if isinstance(refs, str) else refs
        ref = next((r for r in refs if r in state), None)
        if ref is None:
            missing.append(name)
            continue
        val = np.asarray(tf(np.asarray(state[ref], np.float32)))
        want = np.shape(tf(current[key].numpy()))
        if val.shape != want:
            missing.append(f"{name} (shape {val.shape} vs {want})")
            continue
        used.add(ref)
        matched.append(name)
        if slot is None:
            current[key] = torch.from_numpy(inverse_transform(tf, val, tuple(current[key].shape)).copy())
        else:
            rows = np.asarray(state[ref], np.float32)
            c = rows.shape[0] // 3
            current[key][slot * c : (slot + 1) * c] = torch.from_numpy(rows[slot * c : (slot + 1) * c].copy())
    report = {"matched": matched, "missing": missing, "unused": [k for k in state if k not in used]}
    if strict and missing:
        raise KeyError(f"{len(missing)} parameters not found: {missing[:20]}")
    model.load_state_dict(current)
    return report


def import_glip_checkpoint(model, state: Dict[str, np.ndarray], strict: bool = False) -> Dict[str, List[str]]:
    """A GLIP / MQ-GLIP .pth's state dict -> the port's MQ-GLIP model (in
    place); the JAX package's report."""
    return _import_with_rules(model, state, build_rule_table(), strict)


def import_gdino_checkpoint(model, state: Dict[str, np.ndarray], strict: bool = False) -> Dict[str, List[str]]:
    """groundingdino_swint_ogc.pth / an MQ-GroundingDINO .pth -> the port's
    MQ-GroundingDINO model (in place), at the model's depth; the JAX
    package's report. The reference registers one box MLP both as
    `bbox_embed` and as `transformer.decoder.bbox_embed` (and the class
    embedding likewise), so the decoder's aliases are consumed by proxy and
    are not reported unused."""
    tr = model.transformer
    report = _import_with_rules(
        model, state, build_gdino_rule_table(len(tr.encoder.layers), len(tr.decoder.layers)), strict
    )
    report["unused"] = [
        k for k in report["unused"]
        if not k.startswith(("transformer.decoder.bbox_embed.", "transformer.decoder.class_embed."))
    ]
    return report
