"""The flops a protocol image needs, from the plain reference: the image
tower on one image plus every chunk group's head at CP chunks, under
`torch.utils.flop_counter.FlopCounterMode`, plus the gathers that counter
does not see (`work.dcn_gather_flops`, `work.msda_gather_flops`). Prints
the count to write into the configuration file's "flops".

    python3 -m benchmark.count_flops --config mq_glip_t [--traffic lvis_b4_cp4] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys

from benchmark import harness, work


def count(config, mix, device: str) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import traffic

    ref = harness.reference_model(config, device)
    inputs = traffic.lvis_protocol(mix, config["sizes"]["channels"], 0, torch.device(device))
    groups = inputs["input_ids"].shape[0]
    cp = mix["chunk_parallelism"]
    s = config["sizes"]
    with torch.no_grad():
        with FlopCounterMode(display=False) as enc:
            feats = ref.encode_image(inputs["images"][:1])
        feats = [f.expand(cp, *f.shape[1:]) for f in feats]
        args = [inputs[k][0] for k in ("input_ids", "attention_mask", "queries", "query_mask")]
        with FlopCounterMode(display=False) as head:
            if config["family"] == "glip":
                ref.forward_head(feats, *args)
            else:
                memory, text, shapes, scores, boxes = ref.proposals(feats, *args)
                order = torch.sort(scores, -1, descending=True).indices[:, :s["num_queries"]]
                ref.decode(memory, text, args[1], shapes, boxes, order)
    gathers = 0.0
    if config["family"] == "glip":
        levels = work.glip_levels(mix["image_hw"], s["anchor_strides"])
        for b, h, w, c, _, stride in work.glip_dcn_calls(levels, s["channels"], cp):
            gathers += s["head_stages"] * work.dcn_gather_flops(b, work.conv_out(h, stride), work.conv_out(w, stride), c)
    else:
        levels = work.gdino_levels(mix["image_hw"], s["levels"])
        n = sum(h * w for h, w in levels)
        hd = s["channels"] // s["nheads"]
        gathers += s["enc_layers"] * work.msda_gather_flops(cp, n, s["nheads"], hd, len(levels), s["points"])
        gathers += s["dec_layers"] * work.msda_gather_flops(cp, s["num_queries"], s["nheads"], hd, len(levels),
                                                            s["points"])
    per_group = head.get_total_flops() + gathers
    return {"per_image": enc.get_total_flops() + groups * per_group, "image_tower": enc.get_total_flops(),
            "head_group_counted": head.get_total_flops(), "head_group_gathers": gathers, "groups": groups}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", default="lvis_b4_cp4")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    config = harness.load_json(harness.BENCH / "configs" / f"{a.config}.json")
    mix = harness.load_json(harness.BENCH / "traffic" / f"{a.traffic}.json")
    print(json.dumps({"config": a.config, "traffic": a.traffic, **count(config, mix, a.device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
