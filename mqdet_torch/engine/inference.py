"""Finetuning-free evaluation and the test-time online update (counterpart of
`mqdet_tpu/engine/inference.py`; reference maskrcnn_benchmark/engine/
inference.py:39-763):
  * `ChunkedEvaluationPlan` builds every class chunk's prompt, maps and
    queries once (CHUNKED_EVALUATION, :165-283), on the host in numpy;
  * `run_inference` runs the detector over every (image, chunk) pair, maps
    chunk-local labels back to the dataset's labels and boxes back to the
    image, and feeds a `DetectionEvaluator` (COCO mAP or LVIS fixed AP);
  * `online_update` pools the detections above SCORE_THRESHOLD back into the
    query bank (:383-499).

The image tower runs once per image; the head runs once per group of
CHUNK_PARALLELISM chunks, each image in the bucket `EvalTransform` picks
(`make_split_predict_fns`, built once per bucket). The groups' arrays move to
the model's device once. Every group of an image is queued before the
detections are fetched, in one wait: the same detections as the JAX
module's fetch per group, and the same order of bank additions.

Across processes (`parallel/comm.py`), `run_inference` scores the strided
shard `ids[rank::world]` on each rank, gathers every rank's evaluator state
and merges it before `summarize`, as the JAX module does: every rank returns
the single-process summary, and `images_per_second` is the rank's own.
`online_update` runs whole on each process, as in JAX.

Refused with NotImplementedError, each naming its ROADMAP item:
TEST.USE_MULTISCALE (test-time augmentation, `engine/box_aug.py`),
VISION_QUERY.RETURN_ATTN_GATE_VALUE (gate telemetry), GLIPKNOW.KNOWLEDGE_FILE
(`data/knowledge.py`).
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mqdet_torch.core.detections import Detections
from mqdet_torch.data import grounding as G
from mqdet_torch.data.transforms import EvalTransform
from mqdet_torch.engine.evaluator import DetectionEvaluator
from mqdet_torch.engine.predict import make_split_predict_fns
from mqdet_torch.mq.selector import QuerySelector
from mqdet_torch.parallel import comm


class ChunkedEvaluationPlan:
    """Prompts, maps and queries of every class chunk (static over images).

    Arrays (N chunks, L = max labels per chunk, T tokens, V queries, C):
    input_ids and attention_mask (N, T); all_map and agg_map (N, L, T);
    slot_to_label (N, L), chunk-local slot -> dataset label; queries
    (N, V, C) and query_mask (N, V, T), or None without a bank."""

    def __init__(self, cfg, dataset, tokenizer, selector: Optional[QuerySelector]):
        chunk_size = cfg.TEST.CHUNKED_EVALUATION
        max_labels = cfg.VISION_QUERY.MAX_CLASSES_PER_PROMPT
        t_len = cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN

        all_labels = sorted(dataset.ind_to_class.keys())
        # TEST.SELECT_CLASSES: restrict evaluation to a category subset
        if cfg.TEST.SELECT_CLASSES:
            keep = set(int(c) for c in cfg.TEST.SELECT_CLASSES)
            all_labels = [l for l in all_labels if l in keep]
        # DATASETS.CAPTION_PROMPT (ODinW prefix/name/suffix prompts,
        # engine/inference.py:212-283): a json string, a list of dicts in
        # caption (chunk-local) order, or a dict {class name: prompt}
        cap_prompt = cfg.DATASETS.CAPTION_PROMPT
        if isinstance(cap_prompt, str):
            cap_prompt = json.loads(cap_prompt) if cap_prompt else None
        if isinstance(cap_prompt, dict):
            cap_prompt = [
                cap_prompt.get(dataset.ind_to_class[l])
                or {"prefix": "", "name": dataset.ind_to_class[l], "suffix": ""}
                for l in all_labels
            ]
        if cap_prompt is None and cfg.GLIPKNOW.KNOWLEDGE_FILE:
            raise NotImplementedError(
                "GLIPKNOW.KNOWLEDGE_FILE prompts need data/knowledge.py, which reads yaml: not ported "
                "(ROADMAP Queue A 5)"
            )
        self.chunks = G.chunk_classes(all_labels, chunk_size)
        label_pos = {l: i for i, l in enumerate(all_labels)}
        self.bundles = [
            G.build_prompt(
                chunk, dataset.ind_to_class, tokenizer, max_text_len=t_len,
                separation_tokens=cfg.DATASETS.SEPARATION_TOKENS,
                caption_prompt=[cap_prompt[label_pos[l]] for l in chunk] if cap_prompt is not None else None,
            )
            for chunk in self.chunks
        ]
        self.max_labels = max(max_labels, max(b.num_labels for b in self.bundles))

        n = len(self.bundles)
        vocab = cfg.MODEL.LANGUAGE_BACKBONE.VOCAB_SIZE
        top = max(int(b.input_ids.max(initial=0)) for b in self.bundles)
        if top >= vocab:
            raise ValueError(
                f"tokenizer produced id {top} >= VOCAB_SIZE {vocab}: the embedding table would be read "
                "out of range. Align MODEL.LANGUAGE_BACKBONE.VOCAB_SIZE with the tokenizer."
            )
        self.input_ids = np.stack([b.input_ids for b in self.bundles])
        self.attention_mask = np.stack([b.attention_mask for b in self.bundles])
        padded = [G.pad_prompt_maps(b, self.max_labels) for b in self.bundles]
        self.all_map = np.stack([p[0] for p in padded])      # (N, L, T)
        self.agg_map = np.stack([p[1] for p in padded])      # (N, L, T)
        self.slot_to_label = np.zeros((n, self.max_labels), np.int32)
        for i, b in enumerate(self.bundles):
            self.slot_to_label[i, : b.num_labels] = b.label_ids

        if selector is not None and selector.bank is not None:
            qs, qms = [], []
            for b in self.bundles:
                q, qm, _ = selector.select(b.label_ids, b.all_map, training=False)
                qs.append(q)
                qms.append(qm)
            self.queries = np.stack(qs)          # (N, V, C)
            self.query_mask = np.stack(qms)      # (N, V, T)
        else:
            self.queries = None
            self.query_mask = None

    def __len__(self):
        return len(self.bundles)


def refuse_unported(cfg) -> None:
    """Raise for the options of the JAX loop that the port does not have."""
    if cfg.TEST.USE_MULTISCALE:
        raise NotImplementedError(
            "TEST.USE_MULTISCALE (test-time augmentation, engine/box_aug.py) is not ported (ROADMAP Queue A 5)"
        )
    if cfg.VISION_QUERY.RETURN_ATTN_GATE_VALUE:
        raise NotImplementedError(
            "VISION_QUERY.RETURN_ATTN_GATE_VALUE needs the head's intermediates: not ported (ROADMAP Queue A 5)"
        )


def chunk_groups(plan: ChunkedEvaluationPlan, cp: int) -> List[List[int]]:
    """The chunk indices of each group of `cp`; the last group is padded with
    the last chunk (evaluated again, its detections counted again, as in the
    JAX loop)."""
    order = list(range(len(plan)))
    while len(order) % cp:
        order.append(len(plan) - 1)
    return [order[g : g + cp] for g in range(0, len(order), cp)]


def group_inputs(cfg, plan: ChunkedEvaluationPlan, groups: List[List[int]], device,
                 input_ids: Optional[List[np.ndarray]] = None) -> List[Dict[str, torch.Tensor]]:
    """Each group's head inputs as tensors on `device` (queries fp32; zeros
    (CP, 1, .) without a bank), moved once; `input_ids` replaces the plan's
    per group (the masked ids of MASK_DURING_INFERENCE)."""
    cp = len(groups[0])
    c, t = cfg.MODEL.BACKBONE.OUT_CHANNELS, cfg.MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN
    use_q = plan.queries is not None
    out = []
    for i, sel in enumerate(groups):
        arrays = {
            "input_ids": plan.input_ids[sel] if input_ids is None else input_ids[i],
            "attention_mask": plan.attention_mask[sel],
            "queries": plan.queries[sel] if use_q else np.zeros((cp, 1, c), np.float32),
            "query_mask": plan.query_mask[sel] if use_q else np.zeros((cp, 1, t), np.float32),
            "agg_map": plan.agg_map[sel],
        }
        out.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()})
    return out


def masked_input_ids(cfg, plan: ChunkedEvaluationPlan, groups: List[List[int]], mask_id: int):
    """MASK_DURING_INFERENCE (generalized_vl_rcnn_new.py:397-407): each
    class-name span whose class has a vision query becomes [MASK] with
    probability TEXT_DROPOUT, drawn from RandomState(SOLVER.SEED) in the JAX
    loop's order (group, row, slot). Returns each group's ids (CP, T)."""
    if cfg.VISION_QUERY.PURE_TEXT_RATE != 0.0:
        raise ValueError("MASK_DURING_INFERENCE requires PURE_TEXT_RATE == 0 (generalized_vl_rcnn_new.py:399)")
    rng = np.random.RandomState(cfg.SOLVER.SEED)
    out = []
    for sel in groups:
        ids = plan.input_ids[sel].copy()
        allm = plan.all_map[sel]           # (cp, L, T)
        qm = plan.query_mask[sel]          # (cp, V, T)
        for i in range(ids.shape[0]):
            tok_has_q = qm[i].any(axis=0)  # (T,)
            for j in range(allm.shape[1]):
                span = allm[i, j] > 0
                if not span.any() or not tok_has_q[span].any():
                    continue
                if rng.random_sample() < cfg.VISION_QUERY.TEXT_DROPOUT:
                    ids[i, span] = mask_id
        out.append(ids)
    return out


def _mark(device):
    """A point in the device's stream order: a recorded CUDA event, or the
    host clock where work is synchronous (the CPU)."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _seconds(a, b) -> float:
    return b - a if isinstance(a, float) else a.elapsed_time(b) / 1e3


class _ImageRunner:
    """The per-image pass both loops share: transform, the image tower once,
    every group's head queued, then one fetch. `seconds` sums per stage:
    transform, encode and head (the stream's time between marks, read after
    the fetch), fetch (host clock of the copies, which wait for the queue)."""

    def __init__(self, cfg, model, groups: List[Dict[str, torch.Tensor]], device):
        self.cfg, self.model, self.groups, self.device = cfg, model, groups, device
        self.cp = groups[0]["input_ids"].shape[0]
        self.transform = EvalTransform(cfg)
        self.fns = {}
        self.seconds = {"transform": 0.0, "encode": 0.0, "head": 0.0, "fetch": 0.0}

    def __call__(self, img: np.ndarray):
        """-> (image (1, 3, bh, bw) on the device, (oh, ow), (sy, sx), numpy
        boxes (G, CP, N, 4), scores, labels and valid (G, CP, N))."""
        m0 = _mark(self.device)
        image, (oh, ow), scale = self.transform(img, self.device)
        bucket = tuple(image.shape[-2:])
        if bucket not in self.fns:
            self.fns[bucket] = make_split_predict_fns(self.model, bucket, self.cfg)
        encode_fn, head_fn = self.fns[bucket]
        sizes = torch.tensor([[oh, ow]] * self.cp, dtype=torch.float32, device=self.device)
        m1 = _mark(self.device)
        feats = encode_fn(image)
        m2 = _mark(self.device)
        dets = Detections.stack([
            head_fn(feats, g["input_ids"], g["attention_mask"], g["queries"], g["query_mask"], g["agg_map"], sizes)
            for g in self.groups
        ])
        m3 = _mark(self.device)
        t0 = time.perf_counter()
        out = [t.cpu().numpy() for t in (dets.boxes, dets.scores, dets.labels, dets.valid)]
        self.seconds["fetch"] += time.perf_counter() - t0
        for stage, a, b in (("transform", m0, m1), ("encode", m1, m2), ("head", m2, m3)):
            self.seconds[stage] += _seconds(a, b)
        return (image, (oh, ow), scale, *out)


def run_inference(
    cfg,
    model,
    dataset,
    tokenizer,
    selector: Optional[QuerySelector] = None,
    evaluator: Optional[DetectionEvaluator] = None,
    max_images: Optional[int] = None,
    verbose: bool = True,
) -> Dict[str, float]:
    """Full finetuning-free evaluation over a dataset on the model's device:
    the evaluator's summary, `images_per_second`, and `seconds` per stage
    (`_ImageRunner`'s, and `evaluator`: host clock of the evaluator)."""
    refuse_unported(cfg)
    device = next(model.parameters()).device
    plan = ChunkedEvaluationPlan(cfg, dataset, tokenizer, selector)
    groups = chunk_groups(plan, max(1, cfg.TEST.CHUNK_PARALLELISM))
    ids_per_group = None
    vq = cfg.VISION_QUERY
    if vq.ENABLED and vq.MASK_DURING_INFERENCE and vq.TEXT_DROPOUT > 0 and plan.queries is not None:
        ids_per_group = masked_input_ids(cfg, plan, groups, getattr(tokenizer, "mask_token_id", None) or 103)
    runner = _ImageRunner(cfg, model, group_inputs(cfg, plan, groups, device, ids_per_group), device)

    if evaluator is None:
        evaluator = DetectionEvaluator(style="coco")
    evaluator.register_categories(dataset.ind_to_class.keys())
    ids = dataset.ids[:max_images] if max_images else dataset.ids
    if vq.DEBUG:  # engine/inference.py:578-580: a couple of images for smoke runs
        ids = ids[:2]
    world, rank = comm.get_world_size(), comm.get_rank()
    ids = ids[rank::world]  # each rank its strided shard (the reference's DistributedSampler)
    t_eval = 0.0
    t0 = time.time()
    for count, img_id in enumerate(ids):
        _, _, (sy, sx), boxes, scores, labels, valid = runner(dataset.load_image(img_id))
        det_boxes, det_scores, det_labels = [], [], []
        for g, sel in enumerate(groups):
            for row, ci in enumerate(sel):
                v = valid[g, row]
                if not v.any():
                    continue
                # chunk-local 1-based slot -> dataset label
                det_labels.append(plan.slot_to_label[ci][labels[g, row][v] - 1])
                det_boxes.append(boxes[g, row][v] * np.array([sx, sy, sx, sy], np.float32))
                det_scores.append(scores[g, row][v])
        if det_boxes:
            db, ds, dl = np.concatenate(det_boxes), np.concatenate(det_scores), np.concatenate(det_labels)
        else:
            db, ds, dl = np.zeros((0, 4), np.float32), np.zeros((0,), np.float32), np.zeros((0,), np.int32)
        t1 = time.perf_counter()
        gt_boxes, gt_labels = dataset.annotations(img_id)
        neg = [dataset.cat_id_to_contiguous[c] for c in dataset.img_neg_cats.get(img_id, ())
               if c in dataset.cat_id_to_contiguous]
        evaluator.add_image(img_id, gt_boxes, gt_labels, db, ds, dl, neg_category_ids=neg)
        t_eval += time.perf_counter() - t1
        if verbose and (count + 1) % 50 == 0:
            print(f"[inference] {count + 1}/{len(ids)} images, {(count + 1) / (time.time() - t0):.3f} img/s")

    t1 = time.perf_counter()
    if world > 1:  # every rank's records, merged before scoring (engine/inference.py:293-312)
        for r, st in enumerate(comm.all_gather(evaluator.state_dict())):
            if r != rank:
                evaluator.merge_state(st)
    results = evaluator.summarize()
    t_eval += time.perf_counter() - t1
    results["images_per_second"] = len(ids) / max(time.time() - t0, 1e-6)
    results["seconds"] = dict(runner.seconds, evaluator=t_eval)
    return results


def online_update(
    cfg,
    model,
    dataset,
    tokenizer,
    selector: QuerySelector,
    extract_fn: Callable,
    num_turns: Optional[int] = None,
    max_images: Optional[int] = None,
) -> QuerySelector:
    """Test-time online query update (engine/inference.py:383-499): NUM_TURNS
    passes over the images; each detection above SCORE_THRESHOLD is pooled
    by `extract_fn` (`mq.extract.make_extract_fn`, which runs the image tower
    again) from the transformed image and added to the selector's bank with
    exclude_similar, capped at MAX_TEST_QUERY_NUMBER; the next turn's plan
    selects from the grown bank. Additions follow the JAX loop's order
    (image, group, row)."""
    refuse_unported(cfg)
    device = next(model.parameters()).device
    turns = num_turns or cfg.VISION_QUERY.NUM_TURNS
    thresh = cfg.VISION_QUERY.SCORE_THRESHOLD
    cap = cfg.VISION_QUERY.MAX_TEST_QUERY_NUMBER
    for _ in range(turns):
        plan = ChunkedEvaluationPlan(cfg, dataset, tokenizer, selector)
        groups = chunk_groups(plan, max(1, cfg.TEST.CHUNK_PARALLELISM))
        runner = _ImageRunner(cfg, model, group_inputs(cfg, plan, groups, device), device)
        for img_id in dataset.ids[:max_images] if max_images else dataset.ids:
            image, (oh, ow), _, boxes, scores, labels, valid = runner(dataset.load_image(img_id))
            for g, sel in enumerate(groups):
                for row, ci in enumerate(sel):
                    keep = valid[g, row] & (scores[g, row] > thresh)
                    if not keep.any():
                        continue
                    glob = plan.slot_to_label[ci][labels[g, row][keep] - 1]
                    pooled = extract_fn(image, boxes[g, row][keep], float(oh), float(ow)).cpu().numpy()
                    for feat, lab in zip(pooled, glob):
                        selector.bank.add(int(lab), feat[None], exclude_similar=True, capacity=cap)
    return selector
