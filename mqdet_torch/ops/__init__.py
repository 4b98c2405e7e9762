"""Operators of the port. `launch_counts` reads, and sets to 0, the launch
counters of the hand-written kernels' wrappers."""
from __future__ import annotations

import importlib

COUNTERS = (  # kernel name, module of this package, attribute of its launch count
    ("dcn", "deform_conv", "launch_count"),
    ("dcn_gather_clip", "deform_conv", "clip_launch_count"),
    ("dcn_band", "deform_conv", "band_launch_count"),
    ("dcn_band_v1", "deform_conv", "band_v1_launch_count"),
    ("dcn_band_v3", "deform_conv", "band_v3_launch_count"),
    ("dcn_band_v5", "deform_conv", "band_v5_launch_count"),
    ("dcn_band_v6", "deform_conv", "band_v6_launch_count"),
    ("bi_attention", "bi_attention", "launch_count"),
    ("bi_attention_dual", "bi_attention", "dual_launch_count"),
    ("bi_attention_levels", "bi_attention", "levels_launch_count"),
    ("ms_deform_attn", "ms_deform_attn", "launch_count"),
    ("ms_deform_attn_clip", "ms_deform_attn", "clip_launch_count"),
)


def launch_counts(reset: bool = False) -> dict:
    """{kernel name of COUNTERS: launches since its last reset}; with
    `reset`, every count is set to 0 first."""
    out = {}
    for name, mod, attr in COUNTERS:
        module = importlib.import_module(f"{__name__}.{mod}")
        if reset:
            setattr(module, attr, 0)
        out[name] = getattr(module, attr)
    return out
