"""Weight bridge: a flat flax parameter dict -> this package's state_dict.

The port's modules carry the reference's torch attribute names, so its
`state_dict()` keys are the reference keys of the rule tables
(`mqdet_torch/io/torch_import.py`, the port's copy of the JAX package's
`mqdet_tpu/io/torch_import.py`: `build_rule_table` for MQ-GLIP,
`build_gdino_rule_table` for MQ-GroundingDINO; flax path -> (reference key,
transform)). The bridge is that table read backwards: HWIO -> OIHW for
`_t_conv`, a transpose for `_t_linear`, identity, the scalar reshape back to
the reference's 1-element tensors, and, for GroundingDINO's attentions, the
torch `in_proj_weight` (3C, C) / `in_proj_bias` (3C,) assembled from the
three flax q/k/v leaves that `_t_inproj_w(i)` / `_t_inproj_b(i)` slice out of
it. Where a rule names several candidate reference keys, the first is the
port's. MQ-GLIP's table is the JAX package's plus `port_rules()`, `tower_rules()`
and `swin_version_rules()`: the parameters of MQ-Det's switches, of the
CLIP / RNN language towers and of Swin v2 / vl, which the JAX package's
table (and so its `.pth` import) does not name, and the BatchNorm running
statistics of the SCAN / FILM fusions, whose flax leaves are in the `batch_stats` collection
(keys `batch_stats/...` in the flat dict; the `params` leaves carry no
prefix). A released GLIP / MQ-Det / GroundingDINO `.pth` therefore loads
directly:

    state = strip_prefixes(load_torch_state_dict(path))   # mqdet_torch.io.torch_import
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items() if k in model.state_dict()})
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mqdet_torch.io import torch_import as TI

IN_PROJ = ("in_proj_weight", "in_proj_bias")
PLAIN_DYCONV = "glip, USE_DFCONV off"  # the MQ-GLIP family whose DyConvs hold plain convs


def _scalar(w):
    return np.asarray(w).reshape(())


def _gcp_attn_rules(ours: str, theirs: str):
    """A GCP block's cross-attention and conditional gate (no FFN)."""
    r = _norm_rules(f"{ours}/attn/norm", f"{theirs}.attn.norm")
    r += _norm_rules(f"{ours}/attn/norm_kv_ln", f"{theirs}.attn.norm_kv")
    r += [(f"{ours}/attn/{n}/kernel", f"{theirs}.attn.{n}.weight", TI._t_linear) for n in ("to_q", "to_kv", "to_out")]
    return r + _ff_rules(f"{ours}/attn_gate", f"{theirs}.attn_gate")


def _norm_rules(ours: str, theirs: str):
    """A LayerNorm (or a BatchNorm's parameters): scale and bias."""
    return [(f"{ours}/scale", f"{theirs}.weight", TI._ident), (f"{ours}/bias", f"{theirs}.bias", TI._ident)]


def _ff_rules(ours: str, theirs: str):
    """A GCPFeedForward: LayerNorm, two bias-free Linears."""
    return _norm_rules(f"{ours}/norm", f"{theirs}.norm") + [
        (f"{ours}/linear1/kernel", f"{theirs}.linear1.weight", TI._t_linear),
        (f"{ours}/linear2/kernel", f"{theirs}.linear2.weight", TI._t_linear)]


def _bn_rules(ours: str, theirs: str):
    """An evaluation BatchNorm: scale / bias params and running statistics."""
    return _norm_rules(ours, theirs) + [(f"batch_stats/{ours}/mean", f"{theirs}.running_mean", TI._ident),
                                         (f"batch_stats/{ours}/var", f"{theirs}.running_var", TI._ident)]


def _dense_rules(ours: str, theirs: str, conv: bool = False):
    return [(f"{ours}/kernel", f"{theirs}.weight", TI._t_conv if conv else TI._t_linear),
            (f"{ours}/bias", f"{theirs}.bias", TI._ident)]


def port_rules(stages: int = 8, levels: int = 5, qv_layers: int = 12):
    """(flax path, port key, transform) of MQ-GLIP's parameters beyond the
    JAX package's rule table: LEARNABLE_BANK, ADD_VISION_LAYER,
    NEW_MASK_TOKEN, ADD_LINEAR_LAYER, ADD_ADAPT_LAYER, the 0-d (CONDITION_GATE
    off) and linear (NONLINEAR_GATE off) attention gates, QUERY_FUSION's
    block, and the MHA-S / SCAN / FILM fusions of each head stage."""
    ob, lb = "language_backbone/bert", "language_backbone.body.model"
    r = [("qv_layer_learnable_bank", "qv_layer_learnable_bank", TI._ident),
         ("tunable_vision_linear", "tunable_vision_linear", TI._ident),
         (f"{ob}/mask_token", f"{lb}.mask_token", TI._ident),
         ("rpn/tunable_linear", "rpn.head.tunable_linear.weight", TI._ident)]
    for i in range(qv_layers):
        p, q = f"{ob}/qv_layer_{i}", f"{lb}.encoder.qv_layer.{i}"
        r += [(f"{p}/attn_gate", f"{q}.attn_gate", _scalar),
              (f"{p}/attn_gate/kernel", f"{q}.attn_gate.weight", TI._t_linear)]
        r += _ff_rules(f"{p}/adaptor", f"{q}.adaptor")
    r += _gcp_attn_rules("rpn/query_fuse_qv_layer", "rpn.head.query_fuse_qv_layer")
    for i in range(stages):
        p, q = f"rpn/fuse_{i}", f"rpn.head.dyhead_tower.{3 * i}"
        t2i = f"{q}.t2i_attn"
        for n in ("layer_norm_q_1", "layer_norm_k_1"):
            r += _norm_rules(f"{p}/{n}", f"{t2i}.{n}")
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            r += _dense_rules(f"{p}/attn/{n}", f"{t2i}.attn.{n}")
        r.append((f"{p}/gamma", f"{t2i}.gamma", TI._ident))
        r += _dense_rules(f"{p}/mapping_lang/fc1", f"{q}.mapping_lang.0")
        r += _bn_rules(f"{p}/mapping_lang/bn1", f"{q}.mapping_lang.1")
        r += _dense_rules(f"{p}/mapping_lang/fc2", f"{q}.mapping_lang.4")
        r += _bn_rules(f"{p}/mapping_lang/bn2", f"{q}.mapping_lang.5")
        for lvl in range(levels):
            r += _dense_rules(f"{p}/joint_fusion_{lvl}", f"{q}.joint_fusion.{lvl}.0", conv=True)
            r += _bn_rules(f"{p}/joint_bn_{lvl}", f"{q}.joint_fusion.{lvl}.1")
            r += _dense_rules(f"{p}/gamma_{lvl}", f"{q}.gamma.{lvl}")
            r += _dense_rules(f"{p}/beta_{lvl}", f"{q}.beta.{lvl}")
    return r


def tower_rules(layers: int = 24, ob: str = "language_backbone", lb: str = "language_backbone.body"):
    """(flax path, port key, transform) of the CLIP and RNN language towers
    (`models/text_towers.py`), which the JAX package's table does not name:
    one port tensor for each flax leaf; the RNN's two cells are flax's
    `OptimizedLSTMCell_0` / `GRUCell_0` (forward) and `_1` (reversed)."""
    r = [(f"{ob}/token_embedding/embedding", f"{lb}.token_embedding.weight", TI._ident),
         (f"{ob}/positional_embedding", f"{lb}.positional_embedding", TI._ident)]
    r += _norm_rules(f"{ob}/ln_final", f"{lb}.ln_final")
    for i in range(layers):
        p, q = f"{ob}/resblock_{i}", f"{lb}.resblocks.{i}"
        r += _norm_rules(f"{p}/ln_1", f"{q}.ln_1") + _norm_rules(f"{p}/ln_2", f"{q}.ln_2")
        for n in ("query", "key", "value", "out"):
            r += [(f"{p}/attn/{n}/{leaf}", f"{q}.attn.{n}.{leaf}", TI._ident) for leaf in ("kernel", "bias")]
        r += _dense_rules(f"{p}/mlp_fc", f"{q}.mlp_fc") + _dense_rules(f"{p}/mlp_proj", f"{q}.mlp_proj")
    r += [(f"{ob}/embedding/embedding", f"{lb}.embedding.weight", TI._ident)] + _dense_rules(f"{ob}/mlp", f"{lb}.mlp")
    for cell, gates in (("OptimizedLSTMCell", "ifgo"), ("GRUCell", "rzn")):
        for k, side in enumerate(("fwd", "bwd")):
            for g in gates:
                for n in ("i", "h"):
                    r += _dense_rules(f"{ob}/{cell}_{k}/{n}{g}", f"{lb}.cell_{side}.{n}{g}")
    return r


def swin_version_rules(our: str = "backbone", b: str = "backbone.body"):
    """(flax path, port key, transform) of Swin v2's and vl's parameters
    beyond v1's (`models/swin.py`): v2's `logit_scale` and CPB MLP, the vl
    text stream of the last stage's blocks."""
    r = []
    for i in range(4):
        for j in range(24):  # an upper bound, as the JAX package's Swin rules
            p, q = f"{our}/layers_{i}_blocks_{j}", f"{b}.layers.{i}.blocks.{j}"
            r += [(f"{p}/attn/logit_scale", f"{q}.attn.logit_scale", TI._ident),
                  (f"{p}/attn/cpb_mlp_fc2/kernel", f"{q}.attn.cpb_mlp.2.weight", TI._t_linear)]
            r += _dense_rules(f"{p}/attn/cpb_mlp_fc1", f"{q}.attn.cpb_mlp.0")
            r += [(f"{p}/attn/{n}", f"{q}.attn.{n}", TI._ident)
                  for n in ("i2t_relative_position_bias", "t2t_relative_position_bias")]
            for n in ("attn/qkv_text", "attn/proj_text", "mlp_text/fc1", "mlp_text/fc2"):
                r += _dense_rules(f"{p}/{n}", f"{q}.{n.replace('/', '.')}")
            r += _norm_rules(f"{p}/norm1_text", f"{q}.norm1_text") + _norm_rules(f"{p}/norm2_text", f"{q}.norm2_text")
    return r


def reference_rules(model: Optional[torch.nn.Module] = None) -> Dict[str, Tuple[str, Callable]]:
    """Reference key -> (flax path, forward transform reference->flax) of
    `model`'s family (`rule_table`; MQ-GLIP without a model). Where several
    flax paths share a reference key, the first rule wins: for MQ-GLIP's
    DyConv conv with and without DCN the deformable one this package builds,
    for a GroundingDINO in-proj tensor its q leaf (its k and v leaves sit in
    the same module, so every path rule of the JAX package groups the three
    alike). A rule naming candidate keys maps the first, the port's."""
    return _reference_rules(_family(model))


def _family(model: Optional[torch.nn.Module]):
    """None for MQ-GLIP (and no model), PLAIN_DYCONV for MQ-GLIP without
    DCN; (encoder, decoder) depth for GroundingDINO."""
    from mqdet_torch.models.gdino import MQGroundingDINO
    from mqdet_torch.models.mq_glip import MQGLIP

    if isinstance(model, MQGroundingDINO):
        tr = model.transformer
        return len(tr.encoder.layers), len(tr.decoder.layers)
    if isinstance(model, MQGLIP) and not model.rpn.head.dyhead_tower[2].use_deform:
        return PLAIN_DYCONV
    return None


@functools.lru_cache(maxsize=8)
def _reference_rules(family) -> Dict[str, Tuple[str, Callable]]:
    items = list(_table(family).items())
    if family == PLAIN_DYCONV:  # a DyConv conv's flax leaf is `dyconv_c/conv/*` there
        items.sort(key=lambda kv: "/dyconv_" in kv[0] and "/conv/" not in kv[0])
    out = {}
    for flax_name, (ref, tf) in items:
        ref = ref[0] if isinstance(ref, tuple) else ref
        if ref not in out:
            out[ref] = (flax_name, tf)
    return out


@functools.lru_cache(maxsize=8)
def _table(family) -> Dict:
    if isinstance(family, tuple):
        return TI.build_gdino_rule_table(*family)
    extra = port_rules() + tower_rules() + swin_version_rules()
    return {**TI.build_rule_table(), **{ours: (theirs, tf) for ours, theirs, tf in extra}}


def rule_table(model: Optional[torch.nn.Module] = None) -> Dict:
    """The rule table for `model`'s family: the GroundingDINO
    table at the model's depth, else (and without a model) MQ-GLIP's with
    `port_rules()`."""
    return _table(_family(model))


def inverse_transform(tf: Callable, val: np.ndarray, torch_shape: Optional[tuple] = None) -> np.ndarray:
    """Undo a rule's reference->flax transform (not the in-proj slices:
    `params_from_jax` assembles those)."""
    val = np.asarray(val, np.float32)
    if tf is TI._t_conv:
        return np.ascontiguousarray(np.transpose(val, (3, 2, 0, 1)))
    if tf is TI._t_linear:
        return np.ascontiguousarray(np.transpose(val, (1, 0)))
    if tf is TI._ident:
        return val
    # the scalar reshape rules (ff_gate, Scale, log_scale, bias0): the
    # reference stores these as 1-element tensors
    return val.reshape(torch_shape if torch_shape is not None else (1,))


def _inproj_slot(ref: str, tf: Callable) -> int:
    """Which third (q 0, k 1, v 2) of an in-proj tensor a rule slices out:
    the transform applied to a probe holding each row's index."""
    probe = np.arange(3, dtype=np.float32)
    return int(np.asarray(tf(probe[:, None] if ref.endswith("weight") else probe)).reshape(-1)[0])


def _assemble_inproj(ref: str, parts: Dict[int, Tuple[str, Callable, np.ndarray]]) -> np.ndarray:
    """Stack the q/k/v leaves back into the torch tensor; check that each
    rule's transform gives its leaf back."""
    if sorted(parts) != [0, 1, 2]:
        raise KeyError(f"{ref}: q/k/v leaves {sorted(parts)} of 3")
    is_weight = ref.endswith("weight")
    full = np.concatenate([
        np.asarray(parts[i][2], np.float32).T if is_weight else np.asarray(parts[i][2], np.float32)
        for i in range(3)
    ])
    for name, tf, val in parts.values():
        back = np.asarray(tf(full))
        if back.shape != np.shape(val) or not np.array_equal(back, np.asarray(val, np.float32)):
            raise ValueError(f"{name}: transform does not invert")
    return np.ascontiguousarray(full)


def params_from_jax(
    flat: Dict[str, np.ndarray], model: Optional[torch.nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """flat: {flax path without the leading 'params/': array}. Returns a
    state_dict of fp32 tensors. Raises on a leaf without a rule, on a
    transform that does not invert, and, given `model`, on a shape mismatch
    or on a model key that no leaf fills."""
    rules = rule_table(model)
    expected = model.state_dict() if model is not None else None
    arrays: Dict[str, np.ndarray] = {}
    inproj: Dict[str, Dict[int, Tuple[str, Callable, np.ndarray]]] = {}
    for name, val in flat.items():
        if name not in rules:
            raise KeyError(f"no rule for flax leaf {name}")
        ref, tf = rules[name]
        if isinstance(ref, tuple):  # candidate keys: the first is the port's
            ref = ref[0]
        if ref.endswith(IN_PROJ):
            inproj.setdefault(ref, {})[_inproj_slot(ref, tf)] = (name, tf, val)
            continue
        shape = tuple(expected[ref].shape) if expected is not None and ref in expected else None
        t = inverse_transform(tf, val, shape)
        back = np.asarray(tf(t))
        if back.shape != np.shape(val) or not np.array_equal(back, np.asarray(val, np.float32)):
            raise ValueError(f"{name}: transform does not invert")
        arrays[ref] = t
    for ref, parts in inproj.items():
        arrays[ref] = _assemble_inproj(ref, parts)
    out: Dict[str, torch.Tensor] = {}
    for ref, t in arrays.items():
        if expected is not None:
            if ref not in expected:
                raise KeyError(f"{ref} is not a key of the model")
            if tuple(expected[ref].shape) != t.shape:
                raise ValueError(f"{ref}: shape {t.shape} vs model {tuple(expected[ref].shape)}")
        out[ref] = torch.from_numpy(t.copy())
    if expected is not None:
        missing = sorted(set(expected) - set(out))
        if missing:
            raise KeyError(f"{len(missing)} model keys not filled: {missing[:10]}")
    return out
