"""Weight bridge: a flat flax parameter dict -> this package's state_dict.

The port's modules carry the reference's torch attribute names, so its
`state_dict()` keys are the reference keys of the JAX package's GLIP rule
table (`mqdet_tpu/io/torch_import.py::build_rule_table`, flax path ->
(reference key, transform)). The bridge is that table read backwards:
HWIO -> OIHW for `_t_conv`, a transpose for `_t_linear`, identity, or the
scalar reshape back to the reference's 1-element tensors. A released GLIP /
MQ-Det `.pth` therefore loads directly:

    state = strip_prefixes(load_torch_state_dict(path))   # mqdet_tpu.io.torch_import
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items() if k in model.state_dict()})
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mqdet_tpu.io import torch_import as TI


@functools.lru_cache(maxsize=1)
def reference_rules() -> Dict[str, Tuple[str, Callable]]:
    """reference key -> (flax path, forward transform reference->flax). Where
    two flax paths share a reference key (the DyConv conv with and without
    DCN), the first rule, the deformable one this package builds, wins."""
    out = {}
    for flax_name, (ref, tf) in TI.build_rule_table().items():
        if isinstance(ref, str) and ref not in out:
            out[ref] = (flax_name, tf)
    return out


def inverse_transform(tf: Callable, val: np.ndarray, torch_shape: Optional[tuple] = None) -> np.ndarray:
    """Undo a rule's reference->flax transform."""
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


def params_from_jax(
    flat: Dict[str, np.ndarray], model: Optional[torch.nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """flat: {flax path without the leading 'params/': array}. Returns a
    state_dict of fp32 tensors. Raises on a leaf without a rule, and, given
    `model`, on a shape mismatch or on a model key that no leaf fills."""
    rules = TI.build_rule_table()
    expected = model.state_dict() if model is not None else None
    out: Dict[str, torch.Tensor] = {}
    for name, val in flat.items():
        if name not in rules:
            raise KeyError(f"no rule for flax leaf {name}")
        ref, tf = rules[name]
        if not isinstance(ref, str):
            raise KeyError(f"flax leaf {name} maps to several reference keys")
        shape = tuple(expected[ref].shape) if expected is not None and ref in expected else None
        t = inverse_transform(tf, val, shape)
        back = np.asarray(tf(t))
        if back.shape != np.shape(val) or not np.array_equal(back, np.asarray(val, np.float32)):
            raise ValueError(f"{name}: transform does not invert")
        if expected is not None:
            if ref not in expected:
                raise KeyError(f"{ref} (from {name}) is not a key of the model")
            if tuple(expected[ref].shape) != t.shape:
                raise ValueError(f"{ref}: shape {t.shape} vs model {tuple(expected[ref].shape)}")
        out[ref] = torch.from_numpy(t.copy())
    if expected is not None:
        missing = sorted(set(expected) - set(out))
        if missing:
            raise KeyError(f"{len(missing)} model keys not filled: {missing[:10]}")
    return out
