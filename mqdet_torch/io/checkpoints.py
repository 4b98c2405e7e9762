"""Training checkpoints on `torch.save` (counterpart of
`mqdet_tpu/io/checkpoints.py`; reference utils/checkpoint.py
DetectronCheckpointer).

The contract of the JAX module: `save(step, state, arguments)` writes the
train state (the trainable fp32 masters, the optimizer state, the EMA, the
step and `lr_scale`; the frozen parameters stay with the model and its
weight file) under `output_dir/ckpts/`, a `last_checkpoint` tag file and the
arguments as JSON, and keeps the newest `max_to_keep` checkpoints;
`restore(template, step=None)` returns (state, step) on the template's
devices; `has_checkpoint`, `last_step`, `load_arguments`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch


def _to(obj, device_of):
    """obj's tensors moved to the device of the template's matching tensor."""
    if isinstance(obj, dict):
        return {k: _to(v, device_of[k] if isinstance(device_of, dict) else device_of) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.to(device_of.device if isinstance(device_of, torch.Tensor) else device_of)
    return obj


class Checkpointer:
    def __init__(self, output_dir: str, max_to_keep: int = 4):
        self.output_dir = output_dir
        self.max_to_keep = max_to_keep
        self.ckpt_dir = os.path.join(output_dir, "ckpts")
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"{int(step)}.pt")

    def steps(self):
        return sorted(int(f[:-3]) for f in os.listdir(self.ckpt_dir) if f.endswith(".pt") and f[:-3].isdigit())

    def save(self, step: int, state, arguments: Optional[Dict[str, Any]] = None) -> str:
        path = self._path(step)
        torch.save({f.name: getattr(state, f.name) for f in dataclasses.fields(state)}, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(os.path.join(self.output_dir, "last_checkpoint"), "w") as f:
            f.write(str(step))
        if arguments:
            with open(os.path.join(self.output_dir, f"arguments_{step}.json"), "w") as f:
                json.dump(arguments, f, default=str)
        for old in self.steps()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            os.remove(self._path(old))
        return path

    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.output_dir, "last_checkpoint"))

    def last_step(self) -> Optional[int]:
        tag = os.path.join(self.output_dir, "last_checkpoint")
        if not os.path.exists(tag):
            return None
        with open(tag) as f:
            return int(f.read().strip())

    def restore(self, state_template, step: Optional[int] = None):
        """(state of the template's type on its devices, step)."""
        step = step if step is not None else self.last_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.output_dir}")
        saved = torch.load(self._path(step), map_location="cpu", weights_only=False)
        fields = {}
        for f in dataclasses.fields(state_template):
            tmpl = getattr(state_template, f.name)
            fields[f.name] = _to(saved[f.name], tmpl) if tmpl is not None else saved[f.name]
        return type(state_template)(**fields), step

    def load_arguments(self, step: int) -> Dict[str, Any]:
        path = os.path.join(self.output_dir, f"arguments_{step}.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {}


def load_params_npz(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a JAX package `save_params_npz` file (its flax tree flattened,
    paths joined by '/') into `model` through the weight bridge
    (`io/from_jax.params_from_jax`: every leaf must have a rule, every
    model key must be filled, shapes must agree); the fp32 values are cast
    to the model's dtype. Returns the model."""
    import numpy as np

    from mqdet_torch.io.from_jax import params_from_jax

    with np.load(path) as data:
        flat = {(k[len("params/"):] if k.startswith("params/") else k): data[k] for k in data.files}
    model.load_state_dict(params_from_jax(flat, model))
    return model
