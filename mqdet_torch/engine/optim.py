"""The optimizer and its schedules (counterpart of `mqdet_tpu/engine/optim.py`;
reference solver/build.py and solver/lr_scheduler.py).

The JAX package keys every rule off a parameter's flax path. The port's
parameters carry the reference's torch names, so each is mapped to its flax
counterpart's path through the weight bridge's rule table
(`io/from_jax.py::reference_rules`) and given that path's group:
  * trainable iff a recipe pattern is a substring of the path and no freeze
    pattern is (`partition_params`, which also sets `requires_grad`);
  * LR: language_backbone -> LANG_LR, attn_gate/ff_gate -> GATE_LR,
    pre_select/qv_layer -> QUERY_LR (later rules win), bias x BIAS_LR_FACTOR;
  * WD: norm-layer paths x WEIGHT_DECAY_NORM_FACTOR.

`AdamW` is the optax chain the JAX package builds, written out: clip by the
global norm, `scale_by_adam`, `+ wd_leaf * wd_schedule(count) * p`,
`x -lr_leaf * lr_schedule(count)`; each count starts at 0 and advances once
per update. It is not `torch.optim.AdamW`, whose decay is multiplied by the
LR and applied to the parameter before the Adam step. Every state tensor is
fp32, on the parameters' device.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mqdet_torch.io.from_jax import reference_rules

_NORM_MARKERS = ("norm", "_ln", "ln_", "/gn", "bn1", "bn2", "layernorm")


def lr_group_for(name: str, cfg) -> float:
    lr = cfg.SOLVER.BASE_LR
    if "language_backbone" in name:
        lr = cfg.SOLVER.LANG_LR
    if "attn_gate" in name or "ff_gate" in name:
        lr = cfg.SOLVER.GATE_LR
    if "pre_select" in name or "qv_layer" in name:
        lr = cfg.SOLVER.QUERY_LR
    if "bias" in name:
        lr *= cfg.SOLVER.BIAS_LR_FACTOR
    return lr


def wd_group_for(name: str, cfg) -> float:
    wd = cfg.SOLVER.WEIGHT_DECAY
    if any(m in name.lower() for m in _NORM_MARKERS):
        wd *= cfg.SOLVER.WEIGHT_DECAY_NORM_FACTOR
    return wd


def is_trainable(name: str, patterns: Sequence[str]) -> bool:
    return any(p in name for p in patterns)


def _milestones(cfg) -> List[int]:
    max_iter = max(int(cfg.SOLVER.MAX_ITER), 1)
    return sorted(round(s * max_iter) if s < 1 else int(s) for s in cfg.SOLVER.STEPS)


def _warm(step: np.float32, cfg) -> np.float32:
    w = cfg.SOLVER.WARMUP_ITERS
    alpha = np.clip(step / np.float32(max(w, 1)), np.float32(0), np.float32(1))
    return np.float32(cfg.SOLVER.WARMUP_FACTOR) * (np.float32(1) - alpha) + alpha


def warmup_multistep_schedule(cfg) -> Callable[[int], float]:
    """Multiplicative LR factor of WarmupMultiStepLR, in fp32 as XLA takes it."""
    milestones = _milestones(cfg)

    def factor(step: int) -> float:
        s = np.float32(step)
        warm = _warm(s, cfg) if s < cfg.SOLVER.WARMUP_ITERS else np.float32(1)
        decays = np.float32(sum(s >= m for m in milestones))
        return float(warm * np.float32(cfg.SOLVER.GAMMA) ** decays)

    return factor


def cosine_schedule(cfg) -> Callable[[int], float]:
    """WarmupCosineAnnealingLR factor."""
    max_iter = max(int(cfg.SOLVER.MAX_ITER), 1)
    w = cfg.SOLVER.WARMUP_ITERS

    def factor(step: int) -> float:
        s = np.float32(step)
        if s < w:
            return float(_warm(s, cfg))
        progress = np.clip((s - np.float32(w)) / np.float32(max(max_iter - w, 1)), np.float32(0), np.float32(1))
        return float(np.float32(0.5) * (np.float32(1) + np.cos(np.float32(math.pi) * progress)))

    return factor


def wd_schedule(cfg) -> Callable[[int], float]:
    """SOLVER.WEIGHT_DECAY_SCHEDULE: the decay drops by GAMMA past each
    milestone x SCHEDULE_RATIO."""
    if not cfg.SOLVER.WEIGHT_DECAY_SCHEDULE:
        return lambda step: 1.0
    milestones = _milestones(cfg)
    ratio = cfg.SOLVER.WEIGHT_DECAY_SCHEDULE_RATIO

    def factor(step: int) -> float:
        decays = np.float32(sum(float(step) >= m * ratio for m in milestones))
        return float(np.float32(cfg.SOLVER.GAMMA) ** decays)

    return factor


def flax_path(name: str, model: Optional[torch.nn.Module] = None) -> str:
    """The flax path of the port parameter `name` (a reference key) in the
    rule table of `model`'s family (MQ-GLIP's without a model)."""
    rules = reference_rules(model)
    if name not in rules:
        raise KeyError(f"{name}: no flax counterpart in the rule table")
    return rules[name][0]


def flax_is_scalar(name: str, shape, model: Optional[torch.nn.Module] = None) -> bool:
    """Whether the flax leaf of port parameter `name` is 0-d (the rule's
    transform applied to a tensor of the port's shape)."""
    return np.ndim(reference_rules(model)[name][1](np.zeros(tuple(shape), np.float32))) == 0


def partition_params(model: torch.nn.Module, trainable_patterns: Sequence[str],
                     frozen_patterns: Sequence[str] = ()) -> Tuple[List[str], List[str]]:
    """(trainable names, frozen names) by the JAX rule on each parameter's
    flax path; sets `requires_grad` to match."""
    trainable, frozen = [], []
    for name, p in model.named_parameters():
        path = flax_path(name, model)
        ok = not any(fp in path for fp in frozen_patterns) and is_trainable(path, trainable_patterns)
        p.requires_grad_(ok)
        (trainable if ok else frozen).append(name)
    return trainable, frozen


def ema_update(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor], decay: float = 0.999):
    """ModelEma: ema <- decay * ema + (1 - decay) * new, in place."""
    for k, e in ema.items():
        e.mul_(decay).add_(new[k], alpha=1.0 - decay)
    return ema


class AdamW:
    """The JAX package's optax chain over a dict of fp32 tensors (see the
    module docstring). `SOLVER.OPTIMIZER = "SGD"` takes `optax.trace(0.9)` in
    place of Adam, as there. `model` picks the rule table of the names
    (MQ-GLIP's without one)."""

    def __init__(self, cfg, names: Sequence[str], model: Optional[torch.nn.Module] = None):
        sol = cfg.SOLVER
        if sol.OPTIMIZER not in ("ADAMW", "SGD"):
            raise ValueError(sol.OPTIMIZER)
        self.sgd = sol.OPTIMIZER == "SGD"
        paths = {n: flax_path(n, model) for n in names}
        self.lr = {n: lr_group_for(p, cfg) for n, p in paths.items()}
        self.wd = {n: wd_group_for(p, cfg) for n, p in paths.items()}
        self.schedule = cosine_schedule(cfg) if sol.get("USE_COSINE", False) else warmup_multistep_schedule(cfg)
        self.wd_schedule = wd_schedule(cfg)
        cg = sol.CLIP_GRADIENTS
        self.clip = cg.CLIP_VALUE if cg.ENABLED and cg.CLIP_TYPE == "full_model" else None

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        zeros = lambda: {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}  # noqa: E731
        state = {"count": 0, "mu": zeros()}
        if not self.sgd:
            state["nu"] = zeros()
        return state

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict, params: Dict[str, torch.Tensor]):
        """(updates, new state); the updates are added to the parameters by
        the caller (times `lr_scale`). `state` is updated in place."""
        count = state["count"]
        g = {k: v.float() for k, v in grads.items()}
        if self.clip is not None:
            norm = torch.sqrt(sum(torch.sum(v * v) for v in g.values()))
            keep = norm < self.clip
            g = {k: torch.where(keep, v, v / norm * self.clip) for k, v in g.items()}
        mu = state["mu"]
        if self.sgd:
            for k in g:
                mu[k].mul_(0.9).add_(g[k])
            u = {k: mu[k].clone() for k in g}
        else:
            nu = state["nu"]
            for k in g:
                mu[k].mul_(0.9).add_(g[k], alpha=0.1)
                nu[k].mul_(0.999).add_(g[k] * g[k], alpha=0.001)
            c1 = 1.0 - float(np.float32(0.9) ** np.float32(count + 1))
            c2 = 1.0 - float(np.float32(0.999) ** np.float32(count + 1))
            u = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + 1e-8) for k in g}
        f_wd = self.wd_schedule(count)
        f_lr = self.schedule(count)
        for k in u:
            u[k] = -self.lr[k] * f_lr * (u[k] + self.wd[k] * f_wd * params[k].float())
        state["count"] = count + 1
        return u, state
