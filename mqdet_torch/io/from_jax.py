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
port's. A released GLIP / MQ-Det / GroundingDINO `.pth` therefore loads
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


@functools.lru_cache(maxsize=1)
def reference_rules() -> Dict[str, Tuple[str, Callable]]:
    """MQ-GLIP: reference key -> (flax path, forward transform
    reference->flax). Where two flax paths share a reference key (the DyConv
    conv with and without DCN), the first rule, the deformable one this
    package builds, wins."""
    out = {}
    for flax_name, (ref, tf) in TI.build_rule_table().items():
        if isinstance(ref, str) and ref not in out:
            out[ref] = (flax_name, tf)
    return out


def rule_table(model: Optional[torch.nn.Module] = None) -> Dict:
    """The rule table for `model`'s family: the GroundingDINO
    table at the model's depth, else (and without a model) MQ-GLIP's."""
    from mqdet_torch.models.gdino import MQGroundingDINO

    if isinstance(model, MQGroundingDINO):
        tr = model.transformer
        return TI.build_gdino_rule_table(len(tr.encoder.layers), len(tr.decoder.layers))
    return TI.build_rule_table()


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
