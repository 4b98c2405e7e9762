"""The training steps, MQ-GLIP's and MQ-GroundingDINO's (counterpart of
`mqdet_tpu/engine/train.py`; reference engine/trainer.py,
generalized_vl_rcnn_new.py and groundingdino.py's training branch).

One step: the fp32 master copies of the trainable parameters are cast into
the model (whose frozen parameters and activations stay in the compute
dtype, bf16 on the card, as flax computes in `TPU.COMPUTE_DTYPE` from fp32
parameters), vision-conditioned text dropout, the training forward
(`deterministic=False`: stochastic depth, the fusion's composite with
attention dropout), the family's losses (GLIP: ATSS, token focal, GIoU,
centerness; GroundingDINO: the Hungarian set criterion over the final and
auxiliary decoder layers, `engine/gdino_losses.py`) plus the gate loss, then
one shared tail (`_finish_train_step`, JAX's): NaN/Inf zeroing of the loss
and of the gradients, the optax chain of `engine/optim.py` times
`lr_scale`, and the EMA. Gradients reach only the trainable set
(`requires_grad`); where the image tower holds no trainable parameter it runs
under `torch.no_grad()`, as JAX stops gradients at the frozen leaves.

`TPU.REMAT` is the model's (`models/mq_glip.py`: the text layers and head
stages checkpointed, their draws replayed in the recompute); the step is the
same either way. MQ-GroundingDINO has no remat, as in JAX.

Every draw comes from the generator the caller passes, which `do_train`
makes from `(SOLVER.SEED, iteration)` alone (`step_generator`), as JAX's
`fold_in(rng, iteration)`: a resumed run replays the same stream.

Data parallel (`parallel/comm.py`; one process per card, launched by
torchrun): N ranks of B/N images each compute the step one process computes
on the global batch of B, as the JAX step does under its mesh. The losses'
normalisers are summed over the ranks (`engine/losses.py`,
`engine/gdino_losses.py`), so each rank's loss is its share of the global
loss; the gate loss, the same on every rank, counts 1/N on each; the fp32
gradients of the masters are summed over the ranks in one flat all-reduce
(not DDP's, which would reduce the model's bf16 gradients) before the NaN/Inf
zeroing; the NaN guard takes the global verdict; the logged losses are the
sums over the ranks. Text dropout draws the global batch's (B, L) uniforms
and takes the rank's rows, so N ranks mask the images one process would; the
model's own draws (drop path, dropout) come from the step's generator folded
with the rank (`rank_generator`; rank 0 keeps the step's stream), where JAX
draws one global mask. In one process nothing of this runs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mqdet_torch.engine import gdino_losses as G
from mqdet_torch.engine import losses as L
from mqdet_torch.engine import optim as O
from mqdet_torch.ops.anchors import anchors_for_fpn
from mqdet_torch.parallel import comm

MASK_TOKEN_ID = 103  # bert-base-uncased [MASK]
PAD_TOKEN_ID = 0     # bert-base-uncased [PAD]


@dataclass
class TrainState:
    step: int
    trainable: Dict[str, torch.Tensor]    # fp32 masters, by the model's parameter names
    frozen: List[str]                     # the names of the frozen parameters (held by the model)
    opt_state: Dict
    ema: Optional[Dict[str, torch.Tensor]]  # EMA of the trainable set (None without MODEL_EMA)
    lr_scale: float = 1.0                 # the autostep plateau multiplier


def init_train_state(model: torch.nn.Module, cfg, trainable_patterns: Sequence[str],
                     frozen_patterns: Sequence[str] = ()) -> Tuple[TrainState, O.AdamW]:
    """(state, optimizer). Sets the model's `requires_grad` flags by the
    partition and copies the trainable parameters into fp32 masters."""
    names, frozen = O.partition_params(model, trainable_patterns, frozen_patterns)
    params = dict(model.named_parameters())
    trainable = {n: params[n].detach().float().clone() for n in names}
    tx = O.AdamW(cfg, names, model)
    ema = {n: t.clone() for n, t in trainable.items()} if cfg.SOLVER.MODEL_EMA > 0 else None
    return TrainState(0, trainable, frozen, tx.init(trainable), ema), tx


@torch.no_grad()
def load_trainable(model: torch.nn.Module, trainable: Dict[str, torch.Tensor]) -> None:
    """Cast the masters (or the EMA) into the model's parameters."""
    params = dict(model.named_parameters())
    for n, t in trainable.items():
        params[n].copy_(t)


def step_generator(seed: int, iteration: int, device) -> torch.Generator:
    """The generator of one step: a pure function of (seed, iteration)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([int(seed), int(iteration)]).generate_state(1, np.uint64)[0] >> 1))
    return g


def rank_generator(generator: Optional[torch.Generator], rank: int) -> Optional[torch.Generator]:
    """The generator of the model's own draws on `rank`: the step's own on
    rank 0, else a new one seeded from (the step's seed, rank)."""
    if rank == 0 or generator is None:
        return generator
    g = torch.Generator(device=generator.device)
    g.manual_seed(int(np.random.SeedSequence([generator.initial_seed(), rank]).generate_state(1, np.uint64)[0] >> 1))
    return g


def apply_text_dropout(input_ids: torch.Tensor, pos_category_map: torch.Tensor, has_query: torch.Tensor,
                       dropout: float, generator: Optional[torch.Generator] = None,
                       draws: Optional[torch.Tensor] = None, mask_token_id: int = MASK_TOKEN_ID) -> torch.Tensor:
    """Vision-conditioned masked language prediction: the tokens of a caption
    label that has a vision query become [MASK] with probability `dropout`,
    drawn per (image, label) as uniform < dropout (`jax.random.bernoulli`).
    `draws` (B, L) uniforms replace the generator's."""
    if dropout <= 0:
        return input_ids
    b, l, _ = pos_category_map.shape
    if draws is None:
        draws = torch.rand((b, l), generator=generator, device=input_ids.device)
    drop = (draws < dropout) & (has_query > 0)
    token_masked = torch.einsum("bl,blt->bt", drop.float(), pos_category_map.float())
    return torch.where(token_masked > 0, torch.full_like(input_ids, mask_token_id), input_ids)


def random_word_mask(input_ids: torch.Tensor, greenlight: torch.Tensor, vocab_size: int,
                     generator: Optional[torch.Generator] = None, draws=None, mask_token_id: int = MASK_TOKEN_ID,
                     pad_token_id: int = PAD_TOKEN_ID, prob: float = 0.15):
    """GLIP's random_word: a non-pad token whose greenlight is not -1 is
    picked with probability `prob`, then becomes [MASK] (80%), a random id
    (10%) or stays (10%); its label is the original id where greenlight is 1,
    else -100. `draws` = (pick uniforms, action uniforms, random ids)
    replaces the generator's. Returns (new ids, labels)."""
    if draws is None:
        shape, dev = input_ids.shape, input_ids.device
        draws = (torch.rand(shape, generator=generator, device=dev), torch.rand(shape, generator=generator, device=dev),
                 torch.randint(0, vocab_size, shape, generator=generator, device=dev))
    u_pick, u_action, random_ids = draws
    pick = (u_pick < prob) & (input_ids != pad_token_id) & (greenlight != -1)
    masked = torch.where(u_action < 0.8, torch.full_like(input_ids, mask_token_id),
                         torch.where(u_action < 0.9, random_ids.to(input_ids.dtype), input_ids))
    new_ids = torch.where(pick, masked, input_ids)
    labels = torch.where(pick & (greenlight == 1), input_ids, torch.full_like(input_ids, -100))
    return new_ids, labels


def glip_anchors(cfg, bucket, device) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(all levels' anchors (N, 4) on `device`, per-level counts)."""
    per_level = anchors_for_fpn(tuple(bucket), tuple(cfg.MODEL.RPN.ANCHOR_STRIDE),
                                tuple(cfg.MODEL.RPN.ANCHOR_SIZES), tuple(cfg.MODEL.RPN.ASPECT_RATIOS))
    return torch.from_numpy(np.concatenate(per_level)).to(device), tuple(a.shape[0] for a in per_level)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The loader's numpy batch on `device`: images NHWC -> NCHW, token ids
    as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if k == "images":
            t = t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        elif k == "input_ids":
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def _refuse_unported(cfg) -> None:
    if cfg.MODEL.DYHEAD.FUSE_CONFIG.MLM_LOSS:
        raise NotImplementedError("MODEL.DYHEAD.FUSE_CONFIG.MLM_LOSS: the MLM head is not ported (ROADMAP Queue A 4.2)")


def _clock(times, device, key=None, t0=0.0):
    """With a dict `times`: synchronise `device`, add the seconds since t0
    under `key`, return now; without: t0."""
    if times is None:
        return t0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    if key is not None:
        times[key] = times.get(key, 0.0) + now - t0
    return now


def _text_and_queries(batch, cfg, generator):
    """(input ids after the vision-conditioned text dropout, queries, query
    mask, the generator of the model's draws). Across ranks the dropout's
    uniforms are the global batch's, of which the rank takes its rows."""
    input_ids = batch["input_ids"]
    vq = cfg.VISION_QUERY
    world, rank = comm.get_world_size(), comm.get_rank()
    if vq.ENABLED and vq.TEXT_DROPOUT > 0:
        draws = None
        if world > 1:
            b, l = batch["pos_category_map"].shape[:2]
            draws = torch.rand((b * world, l), generator=generator, device=input_ids.device)[rank * b:(rank + 1) * b]
        input_ids = apply_text_dropout(input_ids, batch["pos_category_map"], batch["has_query"], vq.TEXT_DROPOUT,
                                       generator, draws=draws)
    generator = rank_generator(generator, rank)
    if not vq.ENABLED:
        return input_ids, None, None, generator
    return input_ids, batch.get("queries"), batch.get("query_mask"), generator


def _gate_loss(model, tx, cfg, device):
    """The gate loss over the trainable set's gates (the JAX package takes
    it over the trainable leaves), on `device`; 1/N of it on each of N
    ranks, which hold the same gates."""
    params = dict(model.named_parameters())
    gates = [n for n in L.gate_parameters(model.named_parameters(), model) if n in tx.lr]
    vq = cfg.VISION_QUERY

    def loss():
        out = L.gate_loss_from_params(((n, params[n]) for n in gates), scale=vq.GATE_REGULARIZATION_SCALE,
                                      regularize=vq.GATE_REGULARIZATION, model=model).to(device)
        world = comm.get_world_size()
        return out / world if world > 1 else out

    return loss


def make_train_step(model: torch.nn.Module, tx: O.AdamW, cfg):
    """MQ-GLIP's step. Returns train_step(state, batch, generator,
    times=None) -> (state, metrics), `batch` from `batch_to_device`. The
    anchors are those of the batch's bucket (its images' padded (H, W)),
    built once per bucket by `glip_anchors`: a portrait batch trains against
    the rotated bucket's anchors (ROADMAP Queue C 1; the JAX module takes
    the first declared bucket's). The state's tensors are updated in place.
    Given a dict `times`, the step synchronises the device at the boundaries
    of its forward, backward and update and adds each one's seconds there."""
    _refuse_unported(cfg)
    device = next(model.parameters()).device
    tower_trains = any(n.startswith("backbone.") for n in tx.lr)
    gate_loss = _gate_loss(model, tx, cfg, device)
    anchors_of: Dict[Tuple[int, int], Tuple[torch.Tensor, Tuple[int, ...]]] = {}

    def loss_fn(batch, generator, times, t0):
        bucket = tuple(batch["images"].shape[-2:])
        if bucket not in anchors_of:
            anchors_of[bucket] = glip_anchors(cfg, bucket, device)
        anchors, level_sizes = anchors_of[bucket]
        input_ids, queries, query_mask, generator = _text_and_queries(batch, cfg, generator)
        with torch.set_grad_enabled(tower_trains):
            feats = model.encode_image(batch["images"], deterministic=False, generator=generator)
        head_out = model.forward_head(feats, input_ids, batch["attention_mask"], queries, query_mask,
                                      deterministic=False, generator=generator)
        losses = L.glip_losses(
            head_out, anchors, level_sizes, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"],
            batch["gt_token_map"], batch["attention_mask"], topk=cfg.MODEL.ATSS.TOPK,
            reg_loss_weight=cfg.MODEL.ATSS.REG_LOSS_WEIGHT,
        )
        losses["loss_gate"] = gate_loss()
        return losses, t0

    return _finish_train_step(model, tx, loss_fn, cfg.SOLVER.MODEL_EMA, device)


def gdino_targets(batch, num_queries: int):
    """(gt cxcywh normalised by `image_sizes` (B, 2) = (h, w), gt_valid,
    gt_token_map), cut to G <= num_queries: the loader's gt boxes are pixel
    xyxy in the resized frame (the reference's `normed_cxcy_boxes`)."""
    sizes = batch["image_sizes"].float()
    wh = torch.stack([sizes[:, 1], sizes[:, 0]], -1)[:, None, :]
    b = batch["gt_boxes"].float()
    cxcy = (b[..., :2] + b[..., 2:]) / 2
    gt = torch.cat([cxcy, b[..., 2:] - b[..., :2]], -1) / torch.cat([wh, wh], -1)
    # 1-to-1 matching needs G <= num_queries (the reference's ragged targets always do)
    return gt[:, :num_queries], batch["gt_valid"][:, :num_queries], batch["gt_token_map"][:, :num_queries]


def make_gdino_train_step(model: torch.nn.Module, tx: O.AdamW, cfg):
    """MQ-GroundingDINO's step (JAX's `make_gdino_train_step`): text dropout,
    the training forward, the ground truth normalised (`gdino_targets`),
    `gdino_set_loss` with the config's coefficients and matcher costs, the
    gate loss, then the shared tail. Returns train_step(state, batch,
    generator, times=None, assignment=None) -> (state, metrics); `batch`
    carries `image_sizes`. `times` adds the matcher's host seconds apart
    (`matcher`: the cost's transfer, which waits for the forward's device
    work, and scipy). `assignment` fixes the matching (`gdino_set_loss`: for
    comparing runs, never in training); `train_step.assignment` holds the
    one the last step used, (L, B, G)."""
    _refuse_unported(cfg)
    g = cfg.GROUNDINGDINO
    device = next(model.parameters()).device
    tower_trains = any(n.startswith(("backbone.", "input_proj.")) for n in tx.lr)
    gate_loss = _gate_loss(model, tx, cfg, device)
    costs = dict(cost_class=g.matcher.set_cost_class, cost_bbox=g.matcher.set_cost_bbox,
                 cost_giou=g.matcher.set_cost_giou, alpha=g.matcher.focal_alpha)

    def loss_fn(batch, generator, times, t0, assignment=None):
        input_ids, queries, query_mask, generator = _text_and_queries(batch, cfg, generator)
        with torch.set_grad_enabled(tower_trains):
            srcs = model.encode_image(batch["images"], deterministic=False, generator=generator)
        out = model.forward_head(srcs, input_ids, batch["attention_mask"], queries, query_mask,
                                 deterministic=False, generator=generator)
        gt, valid, token_map = gdino_targets(batch, g.num_queries)
        if assignment is None:
            t0 = _clock(times, device, "forward", t0)
            assignment = G.match_layers(out, gt, valid, token_map, **costs)
            t0 = _clock(times, device, "matcher", t0)
        train_step.assignment = assignment
        losses = G.gdino_set_loss(out, gt, valid, token_map, batch["attention_mask"], **costs,
                                  loss_ce_coef=g.loss_ce_coef, loss_bbox_coef=g.loss_bbox_coef,
                                  loss_giou_coef=g.loss_giou_coef, assignment=assignment)
        losses["loss_gate"] = gate_loss()
        return losses, t0

    train_step = _finish_train_step(model, tx, loss_fn, cfg.SOLVER.MODEL_EMA, device)
    train_step.assignment = None
    return train_step


def _sum_over_ranks(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The gradients summed over the ranks by one all-reduce of a flat fp32
    buffer; views of it, by name."""
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    comm.all_reduce_sum(flat)
    out, at = {}, 0
    for n, g in grads.items():
        out[n] = flat[at:at + g.numel()].view_as(g)
        at += g.numel()
    return out


def _finish_train_step(model: torch.nn.Module, tx: O.AdamW, loss_fn, ema_decay: float, device):
    """The shared tail of both steps (JAX's `_finish_train_step`): the
    masters into the model, `loss_fn(batch, generator, times, t0, **kw) ->
    (losses, t0)`, the NaN/Inf guard on the total, the backward, across
    ranks the gradients' sum (`allreduce` in `times`), the gradients' NaN/Inf
    zeroing, the optimizer times `lr_scale`, the EMA. `grads_out`, a dict,
    receives the gradients the optimizer takes."""
    params = dict(model.named_parameters())

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator, times=None,
                   grads_out: Optional[Dict[str, torch.Tensor]] = None, **kw):
        world = comm.get_world_size()
        t0 = _clock(times, device)
        load_trainable(model, state.trainable)
        for n in state.trainable:
            params[n].grad = None
        losses, t0 = loss_fn(batch, generator, times, t0, **kw)
        total = sum(losses.values())
        # NaN/Inf zeroing (trainer.py:150-152): the step's loss, and so its gradients, become 0; across
        # ranks on the global verdict, as JAX's guard on the global total
        finite = torch.isfinite(total)
        if world > 1:
            finite = comm.all_reduce_sum((~finite).float()) == 0
        total = torch.where(finite, total, torch.zeros_like(total))
        t0 = _clock(times, device, "forward", t0)
        total.backward()
        t0 = _clock(times, device, "backward", t0)
        grads = {}
        for n, master in state.trainable.items():
            gr = params[n].grad
            grads[n] = torch.zeros_like(master) if gr is None else gr.float()
        if world > 1:
            grads = _sum_over_ranks(grads)  # SUM: the losses carry the global normalisers
            t0 = _clock(times, device, "allreduce", t0)
        grads = {n: torch.where(torch.isfinite(g), g, torch.zeros_like(g)) for n, g in grads.items()}
        if grads_out is not None:
            grads_out.update(grads)
        updates, state.opt_state = tx.update(grads, state.opt_state, state.trainable)
        with torch.no_grad():
            for n, u in updates.items():
                state.trainable[n].add_(u, alpha=state.lr_scale)
            if state.ema is not None:
                O.ema_update(state.ema, state.trainable, ema_decay)
        state.step += 1
        _clock(times, device, "update", t0)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss_total"] = total.detach()
        return state, comm.reduce_dict(metrics)

    return train_step
