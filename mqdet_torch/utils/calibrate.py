"""DCNv2 offset-range calibration (counterpart of `mqdet_tpu/utils/calibrate.py`).

The clipped DCN routes (the band kernel of `MQDET_DEFORM_IMPL=pallas`, the
default, and the gather kernel's clipped mode) clip learned sampling offsets
to [-R, R] around each tap, R = `TPU.DEFORM_RADIUS`. They are exact for
|offset| <= R and silently differ from the reference's unbounded sampling
beyond it. This module measures the offsets a model produces on sample
inputs and recommends a configuration:

  * measure_max_deform_offset -- forward hooks on every DyConv `offset` conv;
    the max |offset| over their first 18 channels.
  * calibrate_deform_radius -- keep the configured radius, raise it (up to
    MAX_WINDOW_RADIUS), or fall back to the exact gather route.
  * apply_calibration -- set `TPU.DEFORM_RADIUS` or `MQDET_DEFORM_IMPL=gather`.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Optional, Tuple

import torch

from mqdet_torch.ops.deform_conv import MAX_WINDOW_RADIUS


def measure_max_deform_offset(
    model,
    images: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    queries: Optional[torch.Tensor] = None,
    query_mask: Optional[torch.Tensor] = None,
) -> float:
    """Max |offset| (feature-map pixels) over every DyConv level of one
    `encode_image` + `forward_head` of an MQ-GLIP model; images (B, 3, H, W)."""
    from mqdet_torch.models.vldyhead import DyConv

    seen = []

    def hook(mod, args, out):
        seen.append(out[:, :18].abs().amax().float())

    handles = [m.offset.register_forward_hook(hook) for m in model.modules() if isinstance(m, DyConv)]
    try:
        with torch.no_grad():
            feats = model.encode_image(images)
            model.forward_head(feats, input_ids, attention_mask, queries, query_mask)
    finally:
        for h in handles:
            h.remove()
    return float(torch.stack(seen).max()) if seen else 0.0


@dataclasses.dataclass
class DeformCalibration:
    max_offset: float  # measured max |offset| in feature-map pixels
    radius: int        # recommended TPU.DEFORM_RADIUS
    impl: str          # "pallas" (the radius suffices) or "gather"
    changed: bool      # whether the recommendation differs from cfg


def calibrate_deform_radius(
    cfg, model, batch_args: Tuple[Any, ...], margin: float = 1.0
) -> DeformCalibration:
    """Measure offsets on one batch and recommend (radius, impl). margin:
    pixels of headroom over the observed max (other images can produce
    slightly larger offsets than the calibration batch)."""
    max_off = measure_max_deform_offset(model, *batch_args)
    needed = int(math.ceil(max_off + margin))
    configured = int(cfg.TPU.DEFORM_RADIUS)
    if needed <= configured:
        return DeformCalibration(max_off, configured, "pallas", False)
    if needed <= MAX_WINDOW_RADIUS:
        return DeformCalibration(max_off, needed, "pallas", True)
    return DeformCalibration(max_off, configured, "gather", True)


def apply_calibration(cfg, calib: DeformCalibration) -> bool:
    """Set cfg / the environment per the calibration. Returns True when the
    model must be rebuilt (DeformConvGN takes its radius at construction)."""
    if not calib.changed:
        return False
    if calib.impl == "gather":
        os.environ["MQDET_DEFORM_IMPL"] = "gather"
        return True
    cfg.TPU.DEFORM_RADIUS = calib.radius
    return True
