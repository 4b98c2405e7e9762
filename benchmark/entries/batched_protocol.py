"""Entry `batched_protocol`: the program's image-batched LVIS protocol
(`mqdet_torch.engine.predict.make_batched_protocol_fn`), both families.

A call is B images against every chunk group of the mix (traffic.py); the
end-to-end rate is images a second. The harness (harness.py) finds this
file by the mix's "entry" and calls, in order: `build` (the program with the
seeded weights, the inputs, the call), `spans` (the layers a traced run
times), `after_window` (what the judge needs from the program, taken after
the window closed) and `numbers` (the window's detections against the plain
reference, judge.py).
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark import harness, judge, traffic
from benchmark.reference import gdino as rgdino
from benchmark.reference import ops

RATE = {"name": "eval_img_per_s", "unit": "img/s"}
TEXT = ("input_ids", "attention_mask", "queries", "query_mask", "agg_map")


def build(config: Dict, mix: Dict, seed: int, dev, dtype, table, mark, protocol_wrap=None) -> Dict:
    """The program's model with the seeded weights, the mix's inputs, and
    `call(k)`: the k-th protocol call of the run (k < 0: warm-up)."""
    from mqdet_torch.engine.predict import make_batched_protocol_fn

    cfg, model = harness.build_program(config, dev, dtype)
    mark("build")
    harness.fill_weights(model, harness.seeded_weights(table, seed, dev, dtype, config), seed, config)
    mark("weights")
    inputs = traffic.lvis_protocol(mix, config["sizes"]["channels"], seed, dev)
    mark("inputs")
    hw = tuple(mix["image_hw"])
    protocol = make_batched_protocol_fn(model, hw, cfg, mix["image_batch"])
    timed = protocol_wrap(protocol) if protocol_wrap is not None else protocol
    images = inputs["images"].to(dtype)
    sizes = torch.tensor([hw] * mix["image_batch"], dtype=torch.float32, device=dev)
    text = [inputs[k] for k in TEXT]

    def call(k):
        return timed(images[traffic.call_images(mix, k)], sizes, *text)

    return {"model": model, "protocol": protocol, "images": images, "sizes": sizes, "text": text,
            "inputs": inputs, "call": call, "units": mix["image_batch"]}


def spans(config: Dict, state: Dict) -> Dict[str, tuple]:
    """{layer name: (first module, last module)} of the program's layers, by
    the module tree the released checkpoints share."""
    model = state["model"]
    if config["family"] == "glip":
        return {
            "image_tower": (model.backbone.body, model.backbone.fpn),
            "language_tower": (model.language_backbone, model.language_backbone),
            "glip_head": (model.rpn.head, model.rpn.head),
        }
    enc, dec = model.transformer.encoder, model.transformer.decoder
    return {
        "image_tower": (model.backbone[0], model.input_proj[-1]),
        "language_tower": (model.bert, model.feat_map),
        "gdino_encoder": (enc.fusion_layers[0], enc.layers[-1]),
        "gdino_decoder": (dec.layers[0], model.bbox_embed[-1]),
    }


@torch.no_grad()
def after_window(config: Dict, mix: Dict, state: Dict, n_calls: int, seed: int) -> Dict:
    """MQ-GroundingDINO: the program's proposal selection (each query's
    initial box, the model's `dbg_init_ref`) for the judged sample's
    (call, group) pairs, from the untouched protocol run again on those
    inputs after the window; its detections are kept beside, to show that
    the run again is the window's computation. MQ-GLIP: nothing."""
    if config["family"] != "gdino":
        return {}
    model, kept = state["model"], []
    head = model.forward_head

    def keep(*args, **kwargs):
        out = head(*args, **kwargs)
        kept.append(out["dbg_init_ref"])
        return out

    groups = state["inputs"]["input_ids"].shape[0]
    captured = {}
    model.debug_outputs, model.forward_head = True, keep
    try:
        for call, _, g in judge.sample(n_calls, mix["image_batch"], groups, seed):
            if (call, g) not in captured:
                dets = state["protocol"](state["images"][traffic.call_images(mix, call)], state["sizes"],
                                         *(t[g:g + 1] for t in state["text"]))
                captured[(call, g)] = {"init_ref": kept[-1], "scores": dets.scores[0]}
    finally:
        del model.forward_head
        model.debug_outputs = False
    return captured


@torch.no_grad()
def numbers(config: Dict, mix: Dict, inputs, outputs, captured, seed: int, device, table, dtype,
            control: bool = False) -> Dict[str, float]:
    """The compared numbers of one run's sample; with `control`, of the
    reference in fp8 put in the program's place on the same sample."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = judge.reference(config, table, seed, device, dtype)
    cp, b = mix["chunk_parallelism"], mix["image_batch"]
    groups = inputs["input_ids"].shape[0]
    images = inputs["images"].to(dtype)
    post = config["postprocess"]
    rows = []
    for call, i, g in judge.sample(len(outputs), b, groups, seed):
        image = images[traffic.call_images(mix, call)[i]]
        entries = slice(i * cp, (i + 1) * cp)
        if config["family"] == "glip":
            boxes, scores, probs, lv = judge.glip_dense(ref, config, mix, inputs, g, image)
            if control:
                with ops.precision("fp8"):
                    cb, cs, cpr, _ = judge.glip_dense(ref, config, mix, inputs, g, image)
            for c in range(cp):
                if control:
                    det = judge.glip_control_entry(cb[c], cs[c], cpr[c], lv, post)
                else:
                    det = {k: v[c] for k, v in judge.entries(outputs[call], g, entries).items()}
                rows.append(judge.glip_entry_gaps(det, boxes[c], scores[c], probs[c], lv, post))
        else:
            props = judge.gdino_reference(ref, config, mix, inputs, g, image)
            rerun = None
            if control:
                with ops.precision("fp8"):
                    cprops = judge.gdino_reference(ref, config, mix, inputs, g, image)
                    order, init_ref = judge.gdino_control(ref, config, mix, cprops)
                    logits, cboxes = ref.decode(cprops[0], cprops[1], inputs["attention_mask"][g], cprops[2],
                                                cprops[4], order)
                cls = rgdino.class_scores(logits, inputs["agg_map"][g])
                best, lab = cls.max(-1)
                dets = {"scores": best, "labels": lab + 1, "boxes": rgdino.to_xyxy(cboxes, mix["image_hw"]),
                        "valid": best > post["box_threshold"]}
            else:
                kept = captured[(call, g)]
                init_ref = kept["init_ref"][entries]
                dets = judge.entries(outputs[call], g, entries)
                rerun = float((kept["scores"][entries].float() - dets["scores"].float()).abs().max())
            row = judge.gdino_gaps(ref, mix, inputs, g, props, init_ref, dets, post)
            if rerun is not None:
                row["rerun_gap"] = rerun
            rows.append(row)
    return judge.combine(rows)
