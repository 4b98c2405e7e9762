"""What decides `correct`: the window's detections against the plain
reference (`reference/`), on a sample drawn from the seed.

The sample is one (call, image, chunk group) triplet for each of a call's
image slots; each covers the CP entries (image x chunk) that one head call
of the program produced, at the timed sizes. The reference runs in float32
with TF32 off, on the same weights and inputs, after the program is freed.
A configuration's "limits" name the numbers compared; the others are
computed for `calibrate.py`'s readings (PERF.md gives why they are not
compared). Means and medians pool every detection (or slot) of the sample.

MQ-GLIP (answers checked one by one): every detection the program returned
says "box b, class c, score s". Its anchor is the one whose reference box
is nearest b (box distance over the box's size); anchors whose boxes lie
within BOX_SLACK of the nearest are told apart by the gap to class c's
reference score. `score_gap` / `score_gap_mean` are the largest
/ mean |s - reference score|, `box_gap` / `box_gap_mean` / `box_gap_med`
the largest / mean / median box distance over the box's size. The set is
held to the reference's own post-processing (top-k, class-aware NMS, the
cap): `rank_gap` / `rank_gap_mean` compare the sorted scores rank by rank,
a detection missing on either side counting its full score, and
`count_gap` is the largest departure of an entry's count of detections
from the reference's, over the reference's (`ref_short`: whether an
entry of the reference fell short of the cap). `class_gap_mean` /
`class_gap_med` give the class contrast (where it is computed).
`nms_overlaps` counts pairs of returned detections of one class that
overlap by more than the NMS threshold: an invariant of the output, exact
(limit 0).

MQ-GroundingDINO: the decoder's queries are the top proposals, in score
order, and each slot's decoder input depends on its rank, so the reference
follows the program's selection: each query's initial box, which the entry
takes from the program after the window (`entries/batched_protocol.py`),
is matched to a reference proposal (`match_slots`; `match_gap` is the
largest distance to the nearest, in normalised coordinates), and the
selection is checked on its own: `select_gap` is how far the program's
order departs from the reference's proposal scores (a later slot scoring
above an earlier one, or the selected scores, sorted, apart from the
reference's own best Q rank by rank). Then the reference decodes those
proposals in that order, and per slot `score_gap` (and its mean) compares
the program's score with the reference's score of the program's class,
`label_gap` how far that class lies below the reference's best, and
`box_gap` (and its mean) the boxes over the image's longer side.
`valid_mismatch` counts slots returned or withheld against their own score
and the threshold: exact (limit 0).
"""
from __future__ import annotations

import random
from typing import Dict, List

import torch

from benchmark.reference import glip as rglip
from benchmark.reference import gdino as rgdino
from benchmark.reference import ops

IOU_SLACK = 1e-4  # two computations of one IoU may differ in the last bits
BOX_SLACK = 0.02  # boxes this close are one match (a sound run's box gaps reach ~0.01; a neighbour anchor lies ~0.12 away)
MATCH_SLACK = 5e-4  # proposals whose boxes lie this close to a query's are one match (the match noise is ~2e-4)


def sample(n_calls: int, images: int, groups: int, seed: int) -> List[tuple]:
    """One (call, image, group) triplet for every image slot of a call, the
    call and the group drawn from the seed: a fault confined to some of a
    call's images cannot escape the sample."""
    rng = random.Random(int(seed) * 7919 + 17)
    return [(rng.randrange(n_calls), i, rng.randrange(groups)) for i in range(images)]


def reference(config: Dict, table, seed: int, device, dtype):
    """The reference model on the weights the program got (drawn in the
    program's dtype, held in float32)."""
    from benchmark.harness import reference_model, seeded_weights

    ref = reference_model(config, device)
    weights = seeded_weights(table, seed, device, dtype, config)
    ref.load_state_dict({k: v.float() for k, v in weights.items()})
    return ref


def entries(dets, g: int, rows):
    return {f: getattr(dets, f)[g, rows] for f in ("boxes", "scores", "labels", "valid")}


# --- MQ-GLIP ---------------------------------------------------------------------------


def glip_dense(ref, config, mix, inputs, g: int, image):
    """The reference's dense outputs for one image against group g's chunks."""
    cp = mix["chunk_parallelism"]
    s = config["sizes"]
    feats = ref.encode_image(image[None].float())
    feats = [f.expand(cp, *f.shape[1:]) for f in feats]
    head = ref.forward_head(feats, inputs["input_ids"][g], inputs["attention_mask"][g], inputs["queries"][g],
                            inputs["query_mask"][g])
    anchors = ops.fpn_anchors(mix["image_hw"], s["anchor_strides"], s["anchor_sizes"], image.device)
    boxes, scores, probs = rglip.dense_scores(head, anchors, inputs["agg_map"][g], mix["image_hw"])
    return boxes, scores, probs, [a.shape[0] for a in anchors]


def glip_entry_gaps(det: Dict, boxes, scores, probs, level_sizes, post: Dict) -> Dict:
    """One entry's numbers: det holds the program's (N, 4) boxes, scores,
    labels (1-based), valid; boxes (A, 4), scores / probs (A, C) the
    reference's dense outputs. Largest gaps as floats; the per-detection and
    per-rank gaps as tensors (keys starting "_"), which `combine` pools over
    the sample."""
    valid = det["valid"]
    b, s, lab = det["boxes"][valid].float(), det["scores"][valid].float(), det["labels"][valid].long()
    none = boxes.new_zeros(0)
    out = {"score_gap": 0.0, "box_gap": 0.0, "_score": none, "_dist": none, "_contrast": none}
    if b.shape[0]:
        size = (boxes[:, 2:] - boxes[:, :2] + 1).amax(-1).clamp(min=1.0)  # (A,)
        dist = (boxes[:, None, :] - b[None]).abs().amax(-1) / size[:, None]  # (A, N)
        ref_s = scores[:, lab - 1]  # (A, N): every anchor at each det's class
        gap_s = (ref_s - s[None]).abs()
        # the anchor is the one whose box is nearest; anchors within BOX_SLACK of
        # that (boxes clipped to one edge) are told apart by the score of the class
        near = dist <= dist.amin(0, keepdim=True) + BOX_SLACK
        best = gap_s.masked_fill(~near, float("inf")).argmin(0)
        cols = torch.arange(b.shape[0], device=b.device)
        gaps, dists = gap_s[best, cols], dist[best, cols]
        out.update(score_gap=float(gaps.max()), box_gap=float(dists.max()), _score=gaps, _dist=dists)
        # the class contrast: at an anchor that returned several classes, each
        # score's departure from the anchor's mean, against the reference's
        # (the anchor's common error cancels; a class swapped for another does not)
        ref_at = ref_s[best, cols]
        _, inv, counts = torch.unique(best, return_inverse=True, return_counts=True)
        mean = lambda x: torch.zeros(counts.shape, device=x.device).index_add_(0, inv, x)[inv] / counts[inv]  # noqa: E731
        out["_contrast"] = ((s - mean(s)) - (ref_at - mean(ref_at))).abs()[counts[inv] > 1]
    # the returned set against the reference's own post-processing (top-k,
    # class-aware NMS, the cap): the scores rank by rank, a detection missing
    # on either side counting its full score, and the count
    _, want_s, _ = rglip.postprocess(boxes, scores, probs, level_sizes, post)
    got_s = torch.sort(s, descending=True).values
    n = max(got_s.numel(), want_s.numel())
    pad = lambda x: torch.cat([x, x.new_zeros(n - x.numel())])  # noqa: E731
    rank = (pad(got_s) - pad(want_s)).abs() if n else boxes.new_zeros(1)
    out.update(rank_gap=float(rank.max()), _rank=rank,
               count_gap=abs(got_s.numel() - want_s.numel()) / max(want_s.numel(), 1),
               ref_short=float(want_s.numel() < post["detections_per_img"]))
    same = lab[:, None] == lab[None, :]
    over = torch.triu(same & (ops.iou_matrix(b, b) > post["nms_thresh"] + IOU_SLACK), diagonal=1)
    out["nms_overlaps"] = float(over.sum())
    return out


def glip_control_entry(boxes, scores, probs, level_sizes, post: Dict) -> Dict:
    """Detections the reference itself returns for one entry (the control's)."""
    b, s, lab = rglip.postprocess(boxes, scores, probs, level_sizes, post)
    return {"boxes": b, "scores": s, "labels": lab, "valid": torch.ones_like(s, dtype=torch.bool)}


# --- MQ-GroundingDINO --------------------------------------------------------------------


def gdino_reference(ref, config, mix, inputs, g: int, image):
    cp = mix["chunk_parallelism"]
    srcs = [f.expand(cp, *f.shape[1:]) for f in ref.encode_image(image[None].float())]
    return ref.proposals(srcs, inputs["input_ids"][g], inputs["attention_mask"][g], inputs["queries"][g],
                         inputs["query_mask"][g])


def match_slots(d, scores):
    """The proposal of each query slot, from d (Q, S), the distances of the
    slots' initial boxes to the proposals' boxes: the nearest, except that
    proposals within MATCH_SLACK of the nearest count as one match (two boxes
    can lie within rounding of each other). Slots are taken in their order,
    as the selection ranked them, each the best scored of its near
    proposals not yet taken."""
    m = d.min(-1).values
    near = (d <= m[:, None] + MATCH_SLACK).nonzero().tolist()
    cands: Dict[int, List[int]] = {}
    for q, s in near:
        cands.setdefault(q, []).append(s)
    score = scores.tolist()
    taken, out = set(), []
    for q in range(d.shape[0]):
        ranked = sorted(cands[q], key=lambda s: -score[s])
        pick = next((s for s in ranked if s not in taken), ranked[0])
        taken.add(pick)
        out.append(pick)
    return torch.tensor(out, device=d.device)


def gdino_gaps(ref, mix, inputs, g: int, props, init_ref, dets: Dict, post: Dict) -> Dict:
    """The numbers of one head call's CP entries: init_ref (CP, Q, 4) the
    program's initial query boxes, dets its (CP, Q, ...) detections."""
    memory, text, shapes, scores, boxes = props
    prop_boxes = boxes.sigmoid()  # (CP, S, 4)
    order, match = [], 0.0
    for e in range(init_ref.shape[0]):
        d = torch.cdist(init_ref[e].float(), prop_boxes[e], p=float("inf"))  # (Q, S)
        order.append(match_slots(d, scores[e]))
        match = max(match, float(d.min(-1).values.max()))
    order = torch.stack(order)
    sel = torch.gather(scores, 1, order)  # (CP, Q): the reference's scores in the program's order
    later_above = (sel - torch.cummin(sel, 1).values).amax()
    # the selected set against the reference's own top Q, rank by rank (by value:
    # proposals with equal boxes, such as the invalid ones, may match one index)
    top = torch.sort(scores, -1, descending=True).values[:, :sel.shape[1]]
    set_gap = (torch.sort(sel, -1, descending=True).values - top).abs().amax()
    logits, ref_boxes = ref.decode(memory, text, inputs["attention_mask"][g], shapes, boxes, order)
    cls = rgdino.class_scores(logits, inputs["agg_map"][g])  # (CP, Q, C)
    xyxy = rgdino.to_xyxy(ref_boxes, mix["image_hw"])
    lab = dets["labels"].long() - 1
    at_lab = torch.gather(cls, 2, lab[..., None])[..., 0]
    score = (dets["scores"].float() - at_lab).abs()
    box = (dets["boxes"].float() - xyxy).abs().amax(-1) / max(mix["image_hw"])
    # a slot is returned exactly when its score passes the threshold
    valid_mismatch = dets["valid"].bool() != (dets["scores"].float() > post["box_threshold"])
    return {
        "match_gap": match,
        "select_gap": float(torch.maximum(later_above, set_gap)),
        "score_gap": float(score.max()),
        "label_gap": float((cls.amax(-1) - at_lab).max()),
        "box_gap": float(box.max()),
        "valid_mismatch": float(valid_mismatch.sum()),
        "_score": score.reshape(-1),
        "_dist": box.reshape(-1),
    }


def gdino_control(ref, config, mix, props) -> tuple:
    """The reference's own selection and detections (the control's): its
    initial query boxes (CP, Q, 4) and detections."""
    memory, text, shapes, scores, boxes = props
    order = rgdino.top_queries(scores, config["sizes"]["num_queries"])
    init_ref = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).sigmoid()
    return order, init_ref


# --- the check -----------------------------------------------------------------------------


def combine(rows: List[Dict]) -> Dict[str, float]:
    """The sample's numbers: the largest of each float over the entries, and
    the means and medians of the gaps pooled over all the sample's
    detections or slots (an entry with none adds nothing)."""
    out: Dict[str, float] = {k: max(r[k] for r in rows) for k in rows[0] if not k.startswith("_")}
    pooled = {k: torch.cat([r[k].reshape(-1).float() for r in rows]) for k in rows[0] if k.startswith("_")}

    def stat(key, fn):
        x = pooled.get(key)
        return float(fn(x)) if x is not None and x.numel() else 0.0

    out.update(score_gap_mean=stat("_score", torch.mean), box_gap_mean=stat("_dist", torch.mean),
               box_gap_med=stat("_dist", torch.median))
    if "_rank" in pooled:
        out.update(rank_gap_mean=stat("_rank", torch.mean), class_gap_mean=stat("_contrast", torch.mean),
                   class_gap_med=stat("_contrast", torch.median))
    return out
