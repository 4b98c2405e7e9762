"""Tiny cells for the CPU tests: the program's tiny configurations
(`tiny_test_config`, `tiny_gdino_config`) with the reference's sizes to
match, and a small LVIS-shaped mix (128 x 128 images: no pyramid level is
1 x 1, where a GroupNorm group would hold one value).

The tiny cells carry their own limits, set by the cells' rule from tiny
readings on the CPU: the program computes in fp32 there and reads 0 to
1e-7; the fp8 control reads 2e-3 to 2e-2 (GLIP's means and counts) and
1e-5 to 1.9 (GDINO's numbers); the faults read 4e-3 and more, a cut set
0.5 (GLIP's `rank_gap_mean`) or 21 slots (GDINO's `valid_mismatch`). The full-size limits sit above
the bf16 program's readings at 800x1344, which a tiny model's outputs,
varying far less from image to image, never reach."""
from __future__ import annotations

import copy

from benchmark import harness

TINY_LIMITS = {
    "glip": {"score_gap_mean": 1e-5, "box_gap_med": 1e-5, "score_gap": 1e-5, "rank_gap_mean": 1e-5, "count_gap": 1e-5,
             "nms_overlaps": 0},
    "gdino": {"match_gap": 1e-6, "select_gap": 1e-2, "score_gap": 1e-4, "box_gap": 1e-6, "box_gap_mean": 1e-7,
              "valid_mismatch": 0},
}


def tiny_cell(family: str):
    mix = harness.load_json(harness.BENCH / "traffic" / "lvis_b4_cp4.json")
    mix.update(image_hw=[128, 128], image_batch=2, image_pool=4, classes=10, chunk_size=3, chunk_parallelism=2,
               queries_per_class=2, text_len=16, warmup_calls=1, trace_calls=1)
    tiny = dict(swin_dim=16, swin_depths=[1, 1, 1, 1], swin_heads=[1, 2, 4, 8], swin_window=4, channels=16,
                hidden=32, heads=2, intermediate=64, layers=2, start_qv_layer=1)
    if family == "glip":
        config = copy.deepcopy(harness.load_json(harness.BENCH / "configs" / "mq_glip_t.json"))
        config["program"] = {"builder": "tiny_test_config", "overrides": {"MODEL.ATSS.DETECTIONS_PER_IMG": 50}}
        config["sizes"].update(tiny, head_stages=1)
        config["postprocess"]["detections_per_img"] = 50
    else:
        config = copy.deepcopy(harness.load_json(harness.BENCH / "configs" / "mq_gdino_t.json"))
        config["program"] = {"builder": "tiny_gdino_config", "overrides": {}}
        config["sizes"].update(tiny, ffn=32, nheads=2, enc_layers=1, dec_layers=2, num_queries=12)
    config["limits"] = dict(TINY_LIMITS[family])
    work = {"name": "tiny", "config": config["name"], "traffic": "tiny", "chips": 1}
    spec = {"workloads": [work], "per_layer": [],
            "end_to_end": [{"name": n} for n in ("eval_img_per_s", "peak_mem_gib", "setup_s")]}
    return {"workload": work, "config": config, "mix": mix, "spec": spec}
