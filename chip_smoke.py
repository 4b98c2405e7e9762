#!/usr/bin/env python3
"""Smoke run of the mqdet_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N] [--runs N] [--cards N]

Run from the root of a checkout. It needs a CUDA device and the CUDA toolkit
(`nvcc`); it imports nothing of JAX, and neither PyYAML nor PIL. It drives
both evaluation paths of the port, MQ-GLIP-T and MQ-GroundingDINO-T, the
modulated pre-training of both, the evaluation CLI, MQ-GLIP-L through the
same entry points (with TPU.REMAT in training) and the few-shot finetuning
CLI. Phases, each printing lines:

  1. the card (`nvidia-smi` name and power limit) and the kernels' build from
     `mqdet_torch/csrc/` with nvcc for sm_90a (one nvcc per source, in
     parallel);
  2. each hand-written kernel against its plain PyTorch version (run in fp32)
     at the main paths' shapes, bf16 inputs from the seed: max abs error
     against the bound 2e-2 * max|ref|, the median time of 10 runs of the
     kernel and of the plain version (bf16, same inputs), CUDA events, and
     the bound (the least time the card could take: bytes moved over
     3.35 TB/s or operations over their peak rate, whichever is larger).
     DCN at the GLIP levels (offsets x3, so the +-2 clip bites): the gather
     kernel (`dcn_gather_kernel`, on wgmma and TMA) in its exact mode and its
     clipped mode (K2), and the band kernel (K1, version 2, on wgmma and
     TMA), each beside `conv_ms`, one cuDNN 3x3 convolution at the shape (the
     yardstick of the product alone, not of DCN's function);
     at the level-0 shape under perf_dcn_sweep's two offset regimes, versions
     1, 3 and 5 against the plain version, 5 and 6 and x_tiles 2 and 3
     bitwise equal to version 2, and version 5's fast-path share; the band at
     radius 8, stride 2 (the largest band); then the sweep path itself
     (mqdet_torch.tools.perf_dcn_sweep, versions 1, 2, 3, 5, 6 at block rows
     8 and 16), its launches counted; the band and gather kernels' ptxas
     reports (no spill, no stack frame for the gather kernel, and no C75xx
     note in the build: a serialised wgmma fails the run). Bi-attention, K3
     and K3b (one wgmma kernel and the combine behind both entry points),
     at GLIP's (4, 22400, 2048) with 8 heads and GroundingDINO's (4, 22323,
     1024) with 4 heads, T 256, with the l side's split count S, the
     kernel's registers and spill bytes from the ptxas report, its TFLOP/s
     on the 8 B N T E it computes,
     its share of the bound, and `library_ms`: two scaled_dot_product_attention
     calls (v side with the bias as attn_mask, l side), timed only, as the
     yardstick; K3 also against `bi_attention_tiled_plain` (the plain model of
     its decomposition) at the kernel's S; K3 and K3b must be bitwise equal;
     the streamed (per-level,
     carried-state) bi-attention (K4: per level the wgmma kernel, then the
     combine merging its partials with the carried state) at GLIP's 800x1344
     pyramid (16800, 4200, 1050, 273 and 77 rows), also against
     `bi_attention_levels_tiled_plain` (the plain model of its
     decomposition), with the same two calls over the concatenated levels as
     its `library_ms`; MSDA at the 800x1344 GroundingDINO pyramid
     (100x168, 50x84, 25x42, 13x21; 8 heads of 32, 4 levels x 4 points, B 4):
     encoder queries (Q = S) on the default route, the clipped mode
     (`ms_deform_attn_clip`, K5's window-clipped function on the band
     kernel) against `ms_deform_attn_clipped_plain`, near their cells, 12
     cells out and on their windows' edges (the share of sample points the
     clip moves printed; the band kernel's ptxas reports without a spill or
     a stack frame), and under
     MQDET_MSDA_IMPL=gather on the exact mode; decoder queries (Q = 900) and
     locations far off the image on the exact mode;
  3. per model, a small-input reference check: the full-width model on a
     256x256 image, one chunk, on the card (bf16, kernels) against the same
     weights in fp32 on the CPU (plain versions), by relative L2 error within
     twice the drift of the plain path run in bf16 on the CPU (or 1e-2 where
     that is larger). MQ-GLIP-T: FPN features and dot-product logits, the
     card run under each fusion switch (default, MQDET_FLASH_LEVELS=stream,
     MQDET_FLASH_SCORES=dual) and under MQDET_DEFORM_IMPL unset (the band
     kernel), window (K2) and gather (exact), each against the CPU plain
     path of the same DCN route, with its launches counted; the max |offset|
     of the random-init model is printed (whether the clip binds).
     MQ-GroundingDINO-T: the encoder's memory and text and the two-stage
     logits (`enc_logits`), taken before the top-900 selection, whose
     overlap with the fp32 selection is printed; the CPU side under
     MQDET_MSDA_IMPL=pallas_interpret (the clipped function the card's
     default route computes), the share of encoder sample points the clip
     moves printed, the card's 6 clipped and 6 exact MSDA launches counted.
     Then per model the vision-query extraction (`make_extract_fn`) of one
     256x256 image with 6 seeded boxes, card against CPU by the same rule on
     the pooled (N, S, C) features: MQ-GLIP-T with SELECT_FPN_LEVEL True
     (S = 1) and False (S = 5), MQ-GroundingDINO-T with True; no
     hand-written kernel may launch;
  4. per model, the LVIS protocol as bench.py runs it: full width from
     init_params(seed), one 800x1344 image, 8 groups x CP 4 chunks of 40
     labels x 5 queries, T = 256, through make_protocol_fn. The launch
     counters, set to 0 just before one protocol run, must equal the
     prediction: MQ-GLIP-T 624 band DCN (dcn_band) and 48 bi-attention
     launches (13 DCN calls and one bi-attention per head stage, 6 stages, 8
     groups);
     MQ-GroundingDINO-T 48 clipped MSDA (ms_deform_attn_clip, 6 encoder
     layers x 8 groups), 48 exact MSDA (6 decoder layers) and 48
     bi-attention (one per encoder layer). Every output must be finite and
     of the right shape. Then p50 over --runs timed runs and the peak device
     memory of the protocol. The same runs first under the switches, with
     phase 5 for each: MQ-GLIP-T under stream (240 level launches, 5 per
     stage, and no pair launch), under dual (48 dual launches), under
     MQDET_DEFORM_IMPL=window (624 K2 launches) and under
     MQDET_DEFORM_IMPL=gather (624 exact launches), MQ-GroundingDINO-T under
     dual (48; its fusion takes one flattened tensor, so stream does not
     apply);
  5. per protocol run, one run under torch.profiler: device busy time,
     idle share, kernel time by family and the time and launches of each
     hand-written kernel;
  6. per model, last of its protocol runs (default switches), one protocol
     run with a device synchronise at the boundaries of its main modules
     (forward hooks): host-clock ms per module;
  7. per model, after its phase 6, the vision-query path as a user runs it,
     at full width, with the settings of
     configs/vision_query_5shot/lvis_minival.yaml and the detection and
     update thresholds at 0, on an LVIS-shaped dataset written from the seed
     (1203 categories with r/c/f frequencies, 8 images: 6 of 480x640 and 2
     of 640x480, so both orientations of the 800x1344 bucket run; the images
     are seeded pixels served by a `CocoDetectionDataset` subclass, because
     the card machine has no PIL): query extraction into a bank (ms per
     image, the banked classes exactly those with GT, no kernel launched;
     the image tower's and ROIAlign's shares), the `ChunkedEvaluationPlan`
     (31 chunks, shapes, build time), `run_inference` with the LVIS fixed-AP
     evaluator (img/s, seconds by stage, launches 8 x one protocol's,
     detections finite and inside their images, AP, APr, APc, APf finite)
     and one `online_update` turn over 2 images from an empty bank (launches
     2 x one protocol's, queries added > 0, seconds);
  8. MQ-GLIP-T modulated pre-training at full width (`mq_glip_t_pretrain_config`:
     the settings of configs/pretrain/mq-glip-t.yaml, batch 2 at 800x1344,
     the warmup cut to 0) from init_params(seed), through the port's train
     entry (`mqdet_torch.tools.train.build_training`) on phase 7's synthetic
     dataset (its 6 landscape images) and phase 7's MQ-GLIP-T bank. First,
     one step at 256x256, dropout off, card (bf16, kernels) against the CPU
     in fp32: the loss and every trainable gradient within phase 3's rule,
     the bf16 drift taken as the largest of three CPU bf16 runs (images
     scaled by 1 and 1 +- 1e-3), and the concatenated gradient within twice
     the unscaled run's drift; each DCN Function's backward (band, K2,
     exact) at GLIP's level-0 and level-1 shapes, B 2, offsets x3, against
     the fp32 plain VJP within 2e-2 * max|ref|, with the level-0 backward's
     time. Then 2 warm-up and 8 timed steps: ms per step, train img/s, peak
     memory, launches (gated: 78 `dcn_band` a forward, no bi-attention
     kernel: the fusion's training composite); one step split at forward /
     backward / update; one profiled step (device busy, idle share, the DCN
     backward's device time and share); one timed step on phase 7's 2
     portrait images, batched in the rotated bucket 1344x800 and trained
     against that bucket's anchors (ROADMAP Queue C 1; loss finite, 78
     `dcn_band` launches); gates: every loss term finite, the
     frozen parameters bitwise unchanged, every trainable tensor moved and
     its EMA apart from it, a checkpoint saved and restored equal;
  9. last, MQ-GroundingDINO-T modulated pre-training at full width
     (`train_config_gdino`: configs/pretrain/mq-groundingdino-t.yaml's
     settings with phase 8's cuts) from init_params(seed), through the same
     train entry, on phase 7's dataset (its landscape images) and phase 7's
     MQ-GroundingDINO-T bank. The reference step at 256x256 as phase 8's,
     the CPU under MQDET_MSDA_IMPL=pallas_interpret (K5's clipped function,
     as the card's default), every run on the fp32 run's Hungarian
     assignment (an argmin: bf16 noise may flip a near-tied pair), the pairs
     the card's own matcher would choose otherwise counted; the MSDA
     Function's backward at the encoder shape (2, 22323, 8, 32), clipped
     forward with locations past their windows, and at decoder queries (Q
     900, exact), against the fp32 exact VJP within 2e-2 * max|ref|, with ms
     per backward; then phase 8's steps, split (the matcher's host time
     apart), profile (the `msda_backward` spans' device time and share) and
     gates, launches gated at 6 `ms_deform_attn_clip` + 6 `ms_deform_attn` a
     forward and no bi-attention kernel;
 10. last, the evaluation CLI (`mqdet_torch.tools.eval.evaluate`, the body
     of `python -m mqdet_torch.tools.eval`): first every yaml under
     configs/ merged into the port's tree by its own reader (this machine
     has no PyYAML), counted and timed; then per model the shipped
     configs/vision_query_5shot yaml (lvis_minival.yaml,
     lvis_minival_groundingdino-T.yaml) with a user's overrides
     (DATA_ROOT, QUERY_BANK_PATH, MODEL.WEIGHT) and those that give it
     phase 7's settings (thresholds 0; MQ-GLIP-T's NUM_CLASSES 81, the
     saved classifier's; GDINO's 800x1344 bucket), the weights phase 7's
     model saved as a reference-layout .pth (`module.` keys), the bank
     phase 7's saved and read back, the dataset phase 7's: gated on the
     import report (0 missing, 0 unused), the AP fields and every image's
     detections bitwise equal to phase 7's `run_inference` (same weights,
     bank, images), the launches (as phase 7's run_inference) and bbox.csv; img/s and the seconds of the config,
     import and evaluation stages printed. For MQ-GLIP-T also the VOC and
     phrase-grounding styles on 2 synthetic images each (XML / caption
     json written from the seed, seeded pixels), one head group an image,
     launches gated;
 11. MQ-GLIP-L (`mq_glip_l_config`: Swin-L 192 / (2, 2, 18, 2) / window 12,
     8 head stages) at full width from init_params(seed), built once on the
     host and reused by every part: phase 3's reference check at 256x256
     (default route; the bound twice the CPU bf16 drift, floor 1e-2); phase
     4's LVIS protocol with phases 5 and 6, launches gated at 832
     `dcn_band` (13 a stage x 8 stages x 8 groups) and 64 `bi_attention`;
     phase 7's route on phase 7's dataset (the GLIP-L bank extracted,
     `run_inference` with launches 8 x one protocol's, the online update);
     the evaluation CLI (`evaluate`) on configs/pretrain/mq-glip-l.yaml +
     configs/vision_query_5shot/lvis_minival_L.yaml with phase 10's
     overrides, the model saved as a reference .pth and that GLIP-L bank:
     import 0 missing and 0 unused, launches 8 x one protocol's, the AP
     fields finite and every image's detections bitwise the direct
     `run_inference`'s; then modulated pre-training with mq-glip-l.yaml's
     settings and phase 8's cuts (`train_config_l`), TPU.REMAT off and on:
     the 256x256 step, dropout on, REMAT against five plain runs on one
     generator seed (the loss within twice their spread; the median over
     the gradients of the REMAT step's distance from them within twice the
     median plain spread, and each gradient's within twice its own spread
     or 4 bf16 units), then
     `train_steps` for each (launches 104 / 208 `dcn_band` a step: the
     REMAT recompute runs DyConv's forward again; no bi-attention kernel;
     phase 8's gates), the REMAT peak memory gated below the plain one;
 12. few-shot finetuning: `mqdet_torch.tools.finetune.main` in process at
     MQ-GLIP-L full width (phase 11's model and .pth) on an ODinW-shaped
     task written from the seed (2 categories renamed by
     OVERRIDE_CATEGORY, train and val splits as COCO json, seeded pixels; a
     task yaml with an odinw_13 task's keys and odinw.yaml's settings, so
     the bank is extracted), shot 1, 1 epoch, copies 1: gated on the CLI
     returning, a temporary bank of exactly the 2 classes, finite printed
     AP lines, and the launches predicted from the step count and the
     evaluations (104 `dcn_band` a step; 104 `dcn_band` + 8 `bi_attention`
     per val image and head group);
 13. data parallelism on the one card (`phase_data_parallel`): two rank
     processes of this script (`--rank-worker`, torchrun's variables set
     by the parent, LOCAL_RANK 0 for both) join a gloo group through
     `mqdet_torch.parallel.comm.init_distributed` (NCCL refuses two ranks on
     one device; each rank within its timeout, one failing ends the run;
     the kernels the parent built in phase 1 are loaded, not rebuilt).
     MQ-GLIP-T training, phase 8's recipe at full width, 2 steps of 1 image
     a rank against one process at batch 2 on the same global batches,
     weights and generator (dropout off), and MQ-GroundingDINO-T, phase 9's,
     1 step on the one process's assignment: the summed loss and the
     summed gradients (each and concatenated) within the larger of phase
     8's (9's) reference bounds (twice the largest of three CPU bf16
     drifts, at 256x256) and twice the card's own bf16 noise at these
     shapes (the one process on the images scaled by 1 +- 1e-3), the
     masters' update from the initial masters (concatenated) within twice
     that noise of the one process's (floor 1e-2; a step that moved nothing
     is 1 from it), the masters bitwise equal across the ranks, the frozen
     parameters unchanged, launches 78
     `dcn_band` a step a rank (6 + 6 MSDA); `run_inference` over phase 7's
     8 images, 4 a rank: every detection bitwise phase 7's, the merged AP
     dict equal to phase 7's, launches 624 `dcn_band` and 48
     `bi_attention` an image a rank; extraction over the same images: rank
     0's saved bank equal to `QueryBank.merge` of the ranks' stores in rank
     order, no other rank saving. Then one rank over NCCL, a world of one:
     one GLIP step against the one process's first by the same rule (the
     step is not bitwise repeatable on the card: its backward's atomic
     adds sum in varying order). Each
     rank's step ms, split and peak memory are printed.

    python3 chip_smoke.py --cards N

runs instead the one check that needs N >= 2 cards of one host
(`multi_card`): phase 13's MQ-GLIP-T training over NCCL, one rank a card
(LOCAL_RANK r on `cuda:r`), 2 steps of 1 image a rank against one process
at batch N on card 0, gated by phase 13's rule with E2E_FLOOR in place of
phase 8's bounds (twice the card's own noise, floor 1e-2); its last line is
{"ok": true, "cards": N, ...}.

The line before the last is a JSON object with one entry per kernel (its
launches summed over the counted paths: the protocols, phase 3's card runs,
the sweep path, phase 7's evaluation and update, phases 8 and 9's timed
training steps, phase 10's CLI runs, phases 11 and 12's paths and phase
13's, summed over its ranks); the last
line is {"ok": true, "device": {...}}. Any failure exits non-zero without
those lines.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ERR_BOUND = 2e-2      # kernel vs fp32 plain, relative to max|ref| (bf16 in/out)
E2E_FLOOR = 1e-2      # whole network: floor of the bf16-vs-fp32 relative L2 bound
HBM_BYTES_S = 3.35e12  # H100 SXM: device memory rate, bf16 dense tensor-core and fp32 peaks
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
DCN_SRC = "mqdet_torch/csrc/deform_conv.cu"
K1 = "mqdet_tpu/ops/pallas/deform_conv_pallas.py"
KERNELS = (  # name, source, the TPU kernel (or XLA composite) it replaces; the order of ops.COUNTERS
    ("dcn", DCN_SRC, "mqdet_tpu/ops/deform_conv.py:62"),
    ("dcn_gather_clip", DCN_SRC, "mqdet_tpu/ops/pallas/deform_conv_gather_pallas.py:220"),
    ("dcn_band", DCN_SRC, f"{K1}:561"),
    ("dcn_band_v1", DCN_SRC, f"{K1}:59"),
    ("dcn_band_v3", DCN_SRC, f"{K1}:535"),
    ("dcn_band_v5", DCN_SRC, f"{K1}:262"),
    ("dcn_band_v6", DCN_SRC, f"{K1}:540"),
    ("bi_attention", "mqdet_torch/csrc/bi_attention.cu", "mqdet_tpu/ops/pallas/bi_attention_pallas.py:384"),
    ("bi_attention_dual", "mqdet_torch/csrc/bi_attention.cu", "mqdet_tpu/ops/pallas/bi_attention_pallas.py:107"),
    ("bi_attention_levels", "mqdet_torch/csrc/bi_attention.cu", "mqdet_tpu/ops/pallas/bi_attention_pallas.py:252"),
    ("ms_deform_attn", "mqdet_torch/csrc/ms_deform_attn.cu", "mqdet_tpu/ops/ms_deform_attn.py:47"),
    ("ms_deform_attn_clip", "mqdet_torch/csrc/ms_deform_attn.cu", "mqdet_tpu/ops/pallas/msda_pallas.py:455"),
)
L_YAML = os.path.join(REPO, "configs", "pretrain", "mq-glip-l.yaml")
LVIS_L_YAML = os.path.join(REPO, "configs", "vision_query_5shot", "lvis_minival_L.yaml")
GDINO_800 = [(100, 168), (50, 84), (25, 42), (13, 21)]  # the 800x1344 pyramid
GLIP_800 = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
SWITCHES = {"default": {}, "stream": {"MQDET_FLASH_LEVELS": "stream"}, "dual": {"MQDET_FLASH_SCORES": "dual"}}
# MQDET_DEFORM_IMPL -> the DCN kernel of the route at C = 256 (None: unset, the default)
DEFORM_ROUTES = {None: "dcn_band", "window": "dcn_gather_clip", "gather": "dcn"}
SWEEP_VERSIONS, SWEEP_BLOCK_ROWS = (2, 1, 3, 5, 6), (8, 16)  # version 2 first: the sweep's reference


@contextlib.contextmanager
def switched(name: str, deform=None, msda=None):
    """Sets the fusion switches of SWITCHES[name], MQDET_DEFORM_IMPL and
    MQDET_MSDA_IMPL (None: unset) for the block."""
    keys = ("MQDET_FLASH_LEVELS", "MQDET_FLASH_SCORES", "MQDET_DEFORM_IMPL", "MQDET_MSDA_IMPL")
    old = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(SWITCHES[name])
    if deform is not None:
        os.environ["MQDET_DEFORM_IMPL"] = deform
    if msda is not None:
        os.environ["MQDET_MSDA_IMPL"] = msda
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def max_err(got, ref) -> tuple:
    """(max |got - ref|, max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, ref.abs().max().item()


def bound(nbytes: float, tensor_flops: float = 0.0, fp32_flops: float = 0.0) -> tuple:
    """(bound_ms, bound_by): the least time the card could take for the work,
    the larger of the bytes over the memory rate and the operations over the
    peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = max(tensor_flops / PEAK_BF16, fp32_flops / PEAK_FP32)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def dcn_bound(b, h, w, c, ho, wo, cout) -> tuple:
    """bf16 x, offset, mask, weight, bias read once, out written once; the
    (M, 9C) x (9C, Cout) product on the tensor cores, the 4-corner blend
    (8 flops per sample and channel) in fp32."""
    m = b * ho * wo
    nbytes = 2 * (b * h * w * c + m * 27 + 9 * c * cout + cout + m * cout)
    return bound(nbytes, 2.0 * m * 9 * c * cout, 8.0 * m * 9 * c)


def bi_bound(b, n, t, e) -> tuple:
    """q, vv (B, N, E), k, vl (B, T, E) bf16 and the fp32 bias read once,
    out_v and out_l written once; the function's least tensor work, one
    score product that serves both sides and the two output products: 6 B N
    T E flops, in either formulation (the port's kernels make 8, their l side
    recomputing its scores)."""
    nbytes = 2 * (3 * b * n * e + 3 * b * t * e) + 4 * b * t
    return bound(nbytes, 6.0 * b * n * t * e)


def msda_bound(b, s, q, nh, hd, levels, p) -> tuple:
    """value bf16, fp32 locations and weights read once, the bf16 output
    written once; per sample point 4 corners x hd multiply-adds and the
    weighted sum, in fp32."""
    pts = b * q * nh * levels * p
    nbytes = 2 * b * s * nh * hd + 12 * pts + 2 * b * q * nh * hd
    return bound(nbytes, 0.0, 10.0 * pts * hd)


def conv_yardstick_ms(torch, x, cout, stride) -> float:
    """One F.conv2d (cuDNN, bf16, channels_last) of x (B, H, W, C) with a 3x3
    kernel, pad 1, at the stride: the yardstick of the band kernel's product
    alone (not of DCN's function: no sampling, no clip). Timed only: the
    port never calls it."""
    from mqdet_torch.tools import cuda_time_ms

    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
    wc = torch.zeros(cout, x.shape[-1], 3, 3, dtype=x.dtype, device=x.device).to(memory_format=torch.channels_last)
    return cuda_time_ms(lambda: torch.nn.functional.conv2d(xc, wc, stride=stride, padding=1))


def clip_share(torch, spatial_shapes, loc) -> float:
    """Share of the sample points of encoder queries whose pixel the MSDA
    clip moves (the clipped function's windows, `window_bounds`)."""
    from mqdet_torch.ops import ms_deform_attn as ms

    bnd = ms.window_bounds(spatial_shapes, loc.device)
    moved = total = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x = loc[:, :, :, lvl, :, 0].float() * w - 0.5  # (B, Q, nh, P)
        y = loc[:, :, :, lvl, :, 1].float() * h - 0.5
        lo_y, hi_y, lo_x, hi_x = (t[None, :, None, None] for t in bnd[lvl])
        out = (y < lo_y) | (y > hi_y) | (x < lo_x) | (x > hi_x)
        moved += int(out.sum())
        total += out.numel()
    return moved / total


def phase_kernels(torch, seed):
    """Returns ({kernel: [case dict, ...]}, main case first, and the launch
    counts of the sweep path)."""
    from mqdet_torch.ops import bi_attention as ba
    from mqdet_torch.ops import deform_conv as dc
    from mqdet_torch.ops import kernels, launch_counts
    from mqdet_torch.ops import ms_deform_attn as ms
    from mqdet_torch.tools import cuda_time_ms, perf_dcn_sweep

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    results = {name: [] for name, _, _ in KERNELS}

    def record(name, case, err, ms_, plain_ms, bnd, library_ms=None):
        results[name].append({"case": case, "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms,
                              "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms})

    def check(label, got, ref, tag=None):
        err, scale = max_err(got, ref)
        ok = bool(torch.isfinite(got).all()) and err <= ERR_BOUND * scale
        say(f"phase 2: {label}: max_abs_err {err!r} (bound {ERR_BOUND * scale!r} = {ERR_BOUND} * max|ref| "
            f"{scale!r}){tag or ''}; {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{label}: kernel disagrees with its plain version")
        return err

    def dcn_inputs(b, h, w, c, stride, scale):
        ho, wo = -(-h // stride), -(-w // stride)
        x = torch.randn(b, h, w, c, generator=g, device=dev).bfloat16()
        off = (torch.randn(b, ho, wo, 18, generator=g, device=dev) * scale).bfloat16()
        mask = torch.rand(b, ho, wo, 9, generator=g, device=dev).bfloat16()
        wt = (torch.randn(3, 3, c, c, generator=g, device=dev) * 0.03).bfloat16()
        bias = (torch.randn(c, generator=g, device=dev) * 0.1).bfloat16()
        return (x, off, mask, wt, bias)

    def dcn_case(b, h, w, c, stride):
        """The exact kernel, K2 and band v2 at one level of the pyramid;
        offsets x3 reach well beyond the +-2 clip."""
        ho, wo = -(-h // stride), -(-w // stride)
        args = dcn_inputs(b, h, w, c, stride, 3.0)
        br = 16 if h // stride >= 100 else 8  # the model's block rows
        routes = (
            ("dcn", lambda a: dc.modulated_deform_conv(*a, stride=stride),
             lambda a: dc.modulated_deform_conv_plain(*a, stride=stride)),
            ("dcn_gather_clip", lambda a: dc.modulated_deform_conv_window(*a, stride=stride, radius=2),
             lambda a: dc.modulated_deform_conv_clipped_plain(*a, stride=stride, radius=2)),
            ("dcn_band", lambda a: dc.modulated_deform_conv_pallas(*a, stride=stride, radius=2, block_rows=br),
             lambda a: dc.modulated_deform_conv_clipped_plain(*a, stride=stride, radius=2)),
        )
        for name, fn, plain in routes:
            got = fn(args)
            torch.cuda.synchronize()
            ref = plain(tuple(a.float() for a in args))
            ms_ = cuda_time_ms(lambda: fn(args))
            plain_ms = cuda_time_ms(lambda: plain(args))
            bnd = dcn_bound(b, h, w, c, ho, wo, c)
            conv = conv_yardstick_ms(torch, args[0], c, stride)
            err = check(f"{name} x{(b, h, w, c)} stride {stride} -> {(ho, wo)}", got, ref,
                        f"; kernel {ms_!r} ms, plain bf16 {plain_ms!r} ms, bound {bnd[0]!r} ms ({bnd[1]})"
                        + f"; conv_ms {conv!r} (one cuDNN 3x3 conv at the shape: the product's yardstick, "
                        f"not DCN's function)")
            del ref, got
            record(name, f"x{(b, h, w, c)} s{stride}", err, ms_, plain_ms, bnd)
            results[name][-1]["conv_ms"] = conv
        torch.cuda.empty_cache()

    dcn_case(4, 100, 168, 256, 1)
    dcn_case(4, 100, 168, 256, 2)
    dcn_case(4, 7, 11, 256, 1)

    # the band kernel's versions at the level-0 shape, under the sweep's two offset regimes
    x0, offs, m0, wt0, bs0 = perf_dcn_sweep.sweep_inputs(dev)
    regime_err = {}  # (version, regime) -> max abs error against the plain version
    for regime, off0 in offs.items():
        args = (x0, off0, m0, wt0, bs0)
        ref = dc.modulated_deform_conv_clipped_plain(*(a.float() for a in args), stride=1, radius=2)
        v2 = dc.modulated_deform_conv_pallas(*args, stride=1, radius=2, block_rows=16, version=2)
        for version in SWEEP_VERSIONS:
            got = dc.modulated_deform_conv_pallas(*args, stride=1, radius=2, block_rows=16, version=version)
            torch.cuda.synchronize()
            regime_err[version, regime] = check(
                f"dcn_band version {version}, level 0 (4, 100, 168, 256), {regime} offsets", got, ref)
        same = {}
        for version, tiles in ((5, 1), (6, 1), (2, 2), (2, 3)):
            got = dc.modulated_deform_conv_pallas(*args, stride=1, radius=2, block_rows=16, version=version,
                                                  x_tiles=tiles)
            same[f"v{version} x_tiles {tiles}"] = torch.equal(got, v2)
        share = dc.band_fast_share(off0, 1, 2, 16)
        say(f"phase 2: dcn_band level 0, {regime} offsets: bitwise equal to version 2: {same}; version 5's "
            f"fast path takes {share!r} of the (tile, tap) pairs (block rows 16)")
        if not all(same.values()):
            fail(f"dcn_band variants differ from version 2 ({regime} offsets): {same}")
        del ref, v2, got
    torch.cuda.empty_cache()

    # the largest band: radius 8 at stride 2 (offsets x6, so the clip bites at 8)
    args = dcn_inputs(4, 100, 168, 256, 2, 6.0)
    ref = dc.modulated_deform_conv_clipped_plain(*(a.float() for a in args), stride=2, radius=8)
    for version in (2, 6):
        got = dc.modulated_deform_conv_pallas(*args, stride=2, radius=8, block_rows=16, version=version)
        torch.cuda.synchronize()
        r8_ms = cuda_time_ms(lambda: dc.modulated_deform_conv_pallas(*args, stride=2, radius=8, block_rows=16,
                                                                      version=version))
        check(f"dcn_band version {version}, radius 8, stride 2, x (4, 100, 168, 256) -> (50, 84)", got, ref,
              f"; kernel {r8_ms!r} ms (geometry {dc.band_geometry(256, 2, 8, 16, version)}: rows, cols, "
              f"chunk, stages, bytes)")
    del ref, got, args
    torch.cuda.empty_cache()

    # the sweep path (perf_dcn_sweep's entry), counted: every version at block rows 8 and 16
    launch_counts(reset=True)
    recs = list(perf_dcn_sweep.sweep(SWEEP_VERSIONS, SWEEP_BLOCK_ROWS, dev))
    sweep_launches = launch_counts()
    for rec in recs:
        say(f"phase 2: perf_dcn_sweep {json.dumps(rec)}")
    per_case = 1 + perf_dcn_sweep.WARMUP + perf_dcn_sweep.ITERS
    names = {1: "dcn_band_v1", 2: "dcn_band", 3: "dcn_band_v3", 5: "dcn_band_v5", 6: "dcn_band_v6"}
    want = predicted(**{names[v]: len(offs) * len(SWEEP_BLOCK_ROWS) * per_case for v in SWEEP_VERSIONS})
    say(f"phase 2: perf_dcn_sweep path launches {sweep_launches} (predicted {want})")
    if sweep_launches != want or any("error" in r for r in recs):
        fail("perf_dcn_sweep path: a case failed or the launches differ from the prediction")
    plain_ms = {3: cuda_time_ms(lambda: dc.modulated_deform_conv_v3_plain(x0, offs["rand"], m0, wt0, bs0))}
    plain_ms[1] = cuda_time_ms(lambda: dc.modulated_deform_conv_clipped_plain(x0, offs["rand"], m0, wt0, bs0))
    bnd = dcn_bound(4, 100, 168, 256, 100, 168, 256)
    conv0 = conv_yardstick_ms(torch, x0, 256, 1)
    for rec in recs:
        v = rec["version"]
        if v != 2:
            record(names[v], f"perf_dcn_sweep {rec['regime']} block rows {rec['block_rows']}",
                   regime_err[v, rec["regime"]], rec["ms"], plain_ms[3 if v == 3 else 1], bnd)
            results[names[v]][-1]["conv_ms"] = conv0
    for rows in results.values():  # the sweep's rand regime at the model's block rows first
        rows.sort(key=lambda r: not r["case"].startswith("perf_dcn_sweep rand block rows 16"))
    del x0, offs, m0, wt0, bs0
    torch.cuda.empty_cache()

    def bi_inputs(b, n, t, e, heads):
        q = (torch.randn(b, n, e, generator=g, device=dev) * (e // heads) ** -0.5).bfloat16()
        k = torch.randn(b, t, e, generator=g, device=dev).bfloat16()
        vv = torch.randn(b, n, e, generator=g, device=dev).bfloat16()
        vl = torch.randn(b, t, e, generator=g, device=dev).bfloat16()
        keep = torch.ones(b, t, dtype=torch.bool, device=dev)
        keep[:, 200:] = False  # padded text tail
        keep[1, 120:] = False
        return q, k, vv, vl, torch.where(keep, 0.0, -9e15).float()

    def bi_check(name, case, outs, refs, ms_, plain_ms, bnd, library_ms=None, extra=""):
        errs = [max_err(o, r) for o, r in zip(outs, refs)]
        ok = all(err <= ERR_BOUND * scale for err, scale in errs) and all(
            bool(torch.isfinite(o).all()) for o in outs
        )
        say(
            f"phase 2: {name} {case}: max_abs_err out_v {errs[0][0]!r} (bound "
            f"{ERR_BOUND * errs[0][1]!r}), out_l {errs[-1][0]!r} (bound {ERR_BOUND * errs[-1][1]!r}); "
            f"kernel {ms_!r} ms, plain bf16 {plain_ms!r} ms, bound {bnd[0]!r} ms ({bnd[1]}){extra}; "
            f"{'ok' if ok else 'FAIL'}"
        )
        if not ok:
            fail(f"{name} kernel disagrees with its plain version at {case}")
        record(name, case, max(e for e, _ in errs), ms_, plain_ms, bnd, library_ms)
        torch.cuda.empty_cache()

    def sdpa_pair(q, k, vv, vl, bias, heads):
        """The yardstick of K3 and K3b: two scaled_dot_product_attention
        calls, the v side (q over k and vl, the bias as attn_mask) and the l
        side (k over q and vv), scale 1. Timed only: the port never calls it."""
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qh, kh, vvh, vlh = (ba._heads(x, heads) for x in (q, k, vv, vl))
        sdpa(qh, kh, vlh, attn_mask=bias[:, None, None, :].to(q.dtype), scale=1.0)
        sdpa(kh, qh, vvh, scale=1.0)

    band_regs = kernels.ptxas_reports("dcn_band_kernel")
    gather_regs = kernels.ptxas_report("dcn_gather_kernel")
    notes = kernels.ptxas_notes()
    say(f"phase 2: dcn_band_kernel ptxas reports (one per version, as built) {band_regs}; dcn_gather_kernel "
        f"{gather_regs}; ptxas C75xx notes (wgmma serialised) in the build: {notes}")
    if any(r["spill_stores"] or r["spill_loads"] for r in band_regs + [gather_regs]) or notes:
        fail("dcn_band_kernel or dcn_gather_kernel spills registers, or ptxas serialises a wgmma")
    if gather_regs["stack"]:
        fail("dcn_gather_kernel has a stack frame")
    wgmma_regs = kernels.ptxas_report("bi_attn_wgmma_kernel")
    say(f"phase 2: bi_attn_wgmma_kernel ptxas report {wgmma_regs} (registers at launch; setmaxnreg gives "
        f"the consumer warpgroups 240)")
    if wgmma_regs["spill_stores"] or wgmma_regs["spill_loads"]:
        fail("bi_attn_wgmma_kernel spills registers (ptxas serialises its wgmma then)")

    def bi_case(b, n, t, e, heads, dual):
        """K3 (dual False) or K3b against its plain version; K3b's outputs
        must be K3's bits (one kernel behind both entry points)."""
        name = "bi_attention_dual" if dual else "bi_attention"
        plain = ba.bi_attention_dual_plain if dual else ba.bi_attention_plain
        args = bi_inputs(b, n, t, e, heads)
        ov, ol = ba.flash_bi_attention(*args, num_heads=heads, dual_scores=dual)
        if dual:
            k3 = ba.flash_bi_attention(*args, num_heads=heads, dual_scores=False)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip((ov, ol), k3)):
                fail(f"K3b's outputs differ from K3's at {(b, n, t, e, heads)}")
            del k3
        torch.cuda.synchronize()
        refs = plain(*(a.float() for a in args[:4]), args[4], num_heads=heads)
        splits = ba.l_splits(b, heads, t, n)
        if not dual:  # the plain model of the kernel's decomposition, at the kernel's S
            tiled = ba.bi_attention_tiled_plain(*(a.float() for a in args[:4]), args[4], heads, splits)
            errs = [max_err(o, r) for o, r in zip((ov, ol), tiled)]
            ok = all(err <= ERR_BOUND * scale for err, scale in errs)
            say(f"phase 2: {name} q/vv {(b, n, e)} against bi_attention_tiled_plain (fp32, S "
                f"{splits}): max_abs_err out_v {errs[0][0]!r}, out_l {errs[1][0]!r} "
                f"(bounds {ERR_BOUND * errs[0][1]!r}, {ERR_BOUND * errs[1][1]!r}); {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"{name} disagrees with the plain model of its decomposition at {(b, n, t, e, heads)}")
            del tiled
        ms_ = cuda_time_ms(lambda: ba.flash_bi_attention(*args, num_heads=heads, dual_scores=dual))
        plain_ms = cuda_time_ms(lambda: plain(*args, num_heads=heads))
        try:
            library_ms = cuda_time_ms(lambda: sdpa_pair(*args, heads))
        except RuntimeError as exc:  # no SDPA kernel for these inputs: no yardstick
            say(f"phase 2: {name} yardstick (two scaled_dot_product_attention calls) failed: {exc}")
            library_ms = None
        bnd = bi_bound(b, n, t, e)
        extra = (f"; S {splits}, {8.0 * b * n * t * e / ms_ / 1e9!r} TFLOP/s on "
                 f"8 B N T E, {bnd[0] / ms_!r} of the bound; library (two scaled_dot_product_attention "
                 f"calls) {library_ms!r} ms; ptxas {wgmma_regs}")
        bi_check(name, f"q/vv {(b, n, e)} T {t} heads {heads}", (ov, ol), refs, ms_, plain_ms, bnd,
                 library_ms, extra)
        results[name][-1].update(splits=splits, ptxas=wgmma_regs,
                                 tflops=8.0 * b * n * t * e / ms_ / 1e9)

    def levels_case(b, shapes, t, e, heads):
        """The streamed form, one launch per level, at a pyramid's levels."""
        sizes = [h * w for h, w in shapes]
        q, k, vv, vl, bias = bi_inputs(b, sum(sizes), t, e, heads)
        library_ms = cuda_time_ms(lambda: sdpa_pair(q, k, vv, vl, bias, heads))  # over the concatenated levels
        qs = [x.contiguous() for x in q.split(sizes, 1)]
        vvs = [x.contiguous() for x in vv.split(sizes, 1)]
        del q, vv
        ovs, ol = ba.flash_bi_attention_levels(qs, k, vvs, vl, bias, heads)
        torch.cuda.synchronize()
        rvs, rl = ba.bi_attention_levels_plain(
            [x.float() for x in qs], k.float(), [x.float() for x in vvs], vl.float(), bias, heads
        )
        # one bound over all levels' out_v, as for the flat form
        outs = (torch.cat(ovs, 1), ol)
        refs = (torch.cat(rvs, 1), rl)
        del rvs
        tvs, tl = ba.bi_attention_levels_tiled_plain(
            [x.float() for x in qs], k.float(), [x.float() for x in vvs], vl.float(), bias, heads
        )
        errs = [max_err(o, r) for o, r in zip(outs, (torch.cat(tvs, 1), tl))]
        splits = [ba.l_splits(b, heads, t, n) for n in sizes]
        ok = all(err <= ERR_BOUND * scale for err, scale in errs)
        say(f"phase 2: bi_attention_levels against bi_attention_levels_tiled_plain (fp32, S {splits} per "
            f"level): max_abs_err out_v {errs[0][0]!r}, out_l {errs[1][0]!r} (bounds {ERR_BOUND * errs[0][1]!r}, "
            f"{ERR_BOUND * errs[1][1]!r}); {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("bi_attention_levels disagrees with the plain model of its decomposition")
        del tvs, tl
        ms_ = cuda_time_ms(lambda: ba.flash_bi_attention_levels(qs, k, vvs, vl, bias, heads))
        plain_ms = cuda_time_ms(lambda: ba.bi_attention_levels_plain(qs, k, vvs, vl, bias, heads))
        bi_check("bi_attention_levels", f"levels {sizes} x (B {b}, E {e}) T {t} heads {heads}",
                 outs, refs, ms_, plain_ms, bi_bound(b, sum(sizes), t, e), library_ms,
                 f"; library (two scaled_dot_product_attention calls over the concatenated levels) "
                 f"{library_ms!r} ms; S {splits} per level")
        results["bi_attention_levels"][-1]["splits"] = splits

    for dual in (False, True):
        bi_case(4, 22400, 256, 2048, 8, dual)   # MQ-GLIP-T's VLFuse at 800x1344
        bi_case(4, 22323, 256, 1024, 4, dual)   # MQ-GroundingDINO-T's encoder fusion at 800x1344
    levels_case(4, GLIP_800, 256, 2048, 8)      # MQ-GLIP-T's VLFuse under MQDET_FLASH_LEVELS=stream

    band_regs = kernels.ptxas_reports("msda_band_kernel")
    say(f"phase 2: msda_band_kernel ptxas reports (one per head width, as built) {band_regs}")
    if any(r["spill_stores"] or r["spill_loads"] or r["stack"] for r in band_regs):
        fail("msda_band_kernel spills registers or has a stack frame")

    def msda_case(name, b, q, lo, hi, nh=8, hd=32, p=4, impl=None, scale=2.0):
        """q None: encoder queries (Q = S), each sampling every level around
        its own cell centre with N(0, `scale` cells) offsets, so samples leave
        the image near the borders; q "edge": encoder queries whose samples
        lie on their windows' edges (exactly c - R or c + R + 1, or 0.25
        past them, clamped onto them; pairs without a window anywhere within
        2 pixels of the map); else Q decoder queries at uniform locations in
        [lo, hi) of every level. Under MQDET_MSDA_IMPL `impl` (None: unset):
        encoder queries take the clipped mode unless `gather`, against
        `ms_deform_attn_clipped_plain`; the rest the exact mode."""
        shapes = GDINO_800
        s = sum(h * w for h, w in shapes)
        value = torch.randn(b, s, nh, hd, generator=g, device=dev).bfloat16()
        if q == "edge":
            q = s
            bnd = ms.window_bounds(shapes, dev)
            loc = torch.empty(b, q, nh, len(shapes), p, 2, device=dev)
            past = 0.25 * (torch.arange(p, device=dev) % 2)
            for lv, (h, w) in enumerate(shapes):
                for axis, size, lo_, hi_ in ((0, w, bnd[lv, 2], bnd[lv, 3]), (1, h, bnd[lv, 0], bnd[lv, 1])):
                    side = torch.rand(b, q, nh, p, generator=g, device=dev) < 0.5
                    edge = torch.where(side, lo_[None, :, None, None] - past, hi_[None, :, None, None] + past)
                    anywhere = torch.rand(b, q, nh, p, generator=g, device=dev) * (size + 4) - 2
                    loc[:, :, :, lv, :, axis] = (torch.where(torch.isfinite(edge), edge, anywhere) + 0.5) / size
            where = "on the window edges"
        elif q is None:
            q = s
            ref = torch.cat([
                torch.stack(torch.meshgrid((torch.arange(w, device=dev) + 0.5) / w,
                                           (torch.arange(h, device=dev) + 0.5) / h, indexing="xy"), -1)
                .reshape(-1, 2) for h, w in shapes
            ])
            wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
            off = torch.randn(b, q, nh, len(shapes), p, 2, generator=g, device=dev) * scale
            loc = ref[None, :, None, None, None, :] + off / wh[None, None, None, :, None, :]
            where = f"own cell + N(0, {scale} cells)"
        else:
            loc = torch.rand(b, q, nh, len(shapes), p, 2, generator=g, device=dev) * (hi - lo) + lo
            where = f"uniform in [{lo}, {hi})"
        attn = torch.rand(b, q, nh, len(shapes), p, generator=g, device=dev)
        attn = attn / attn.sum(dim=(3, 4), keepdim=True)
        with switched("default", msda=impl):
            clip = ms.clips(value, shapes, loc)
            plain = ms.ms_deform_attn_clipped_plain if clip else ms.ms_deform_attn_plain
            counts = launch_counts()
            got = ms.ms_deform_attn(value, shapes, loc, attn)
            torch.cuda.synchronize()
            kernel = "ms_deform_attn_clip" if clip else "ms_deform_attn"
            if launch_counts()[kernel] != counts[kernel] + 1:
                fail(f"msda {name}: the call did not launch {kernel}")
            ref_out = plain(value.float(), shapes, loc, attn)
            err, scale = max_err(got, ref_out)
            del ref_out
            ms_ = cuda_time_ms(lambda: ms.ms_deform_attn(value, shapes, loc, attn))
            plain_ms = cuda_time_ms(lambda: plain(value, shapes, loc, attn))
        bnd = msda_bound(b, s, q, nh, hd, len(shapes), p)
        ok = bool(torch.isfinite(got).all()) and err <= ERR_BOUND * scale
        moved = f", the clip moves {clip_share(torch, shapes, loc)!r} of the sample points" if q == s else ""
        say(
            f"phase 2: msda {name} ({kernel}, MQDET_MSDA_IMPL {impl or 'unset'}): value {(b, s, nh, hd)} Q {q} "
            f"levels {shapes} P {p}, locations {where}{moved}: max_abs_err {err!r} (bound "
            f"{ERR_BOUND * scale!r} = {ERR_BOUND} * max|ref| {scale!r}); kernel {ms_!r} ms, plain bf16 "
            f"{plain_ms!r} ms, bound {bnd[0]!r} ms ({bnd[1]}); {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            fail(f"msda kernel disagrees with its plain version ({name})")
        record(kernel, f"{name} Q {q}", err, ms_, plain_ms, bnd)
        del value, loc, attn, got
        torch.cuda.empty_cache()

    msda_case("encoder", 4, None, None, None)                  # the clipped mode, the encoder's default
    msda_case("encoder far", 4, None, None, None, scale=12.0)  # the clip moves most points
    msda_case("encoder edge", 4, "edge", None, None)             # every sample on a window edge
    msda_case("decoder", 4, 900, 0.0, 1.0)                     # the exact mode, the decoder's
    # far: up to a whole map beyond each border, hundreds of cells from any
    # query, far past the TPU kernel's +-4 cell window
    msda_case("decoder far", 4, 900, -1.0, 2.0)
    msda_case("encoder", 4, None, None, None, impl="gather")   # the exact mode on encoder queries
    return results, sweep_launches


def compare_to_reference(torch, label, names, ref, plain16, card):
    """Relative L2 error of each card tensor against the fp32 reference,
    bounded by twice the plain bf16 path's error (floor E2E_FLOOR). Entries
    that are not finite in the reference (masked logits) must be so on the
    card too and are left out of the norms."""
    worst = (0.0, "", 0.0, 0.0)
    for name, r, p, c in zip(names, ref, plain16, card):
        fin = torch.isfinite(r)
        if not (torch.equal(torch.isfinite(c), fin) and torch.equal(torch.isfinite(p), fin)):
            fail(f"{label} {name}: non-finite entries differ from the fp32 reference")
        r, p, c = (torch.where(fin, x, torch.zeros_like(x)) for x in (r, p, c))
        err_plain = ((p - r).norm() / r.norm()).item()
        err_card = ((c - r).norm() / r.norm()).item()
        bound = max(2.0 * err_plain, E2E_FLOOR)
        worst = max(worst, (err_card / bound, name, err_card, err_plain))
        if not err_card <= bound:
            fail(f"{label} {name}: card vs fp32 relative L2 err {err_card!r} > bound {bound!r} "
                 f"(plain bf16 err {err_plain!r})")
    return worst


def phase_reference_glip(torch, cfg, model_cpu, model_gpu, seed, label="MQ-GLIP-T", routes=None):
    """Small input, same weights: the card's bf16 kernel path against the
    CPU's fp32 plain path, by relative L2 error ||x - ref|| / ||ref|| per
    FPN level and per level of dot-product logits. bf16 drifts from fp32
    through 12 BERT layers and 6 head stages whatever the kernels do, so the
    bound is calibrated by the CPU's plain path run in bf16: the card's error
    may be at most twice the plain bf16 error, or E2E_FLOOR, whichever is
    larger. A wrong kernel or layout gives errors of order 1. The card runs
    once under each fusion switch of SWITCHES (the concatenated pair, the
    streamed levels, the dual-score kernel) with MQDET_DEFORM_IMPL unset,
    and under the default fusion switches with MQDET_DEFORM_IMPL window and
    gather; each against the CPU reference of its DCN route (clipped, or
    exact for gather), taken under the default fusion switches. Where the
    fp32 model's offsets stay inside the radius, the clip changes nothing
    and the two routes' CPU references are the same computation, so it is
    taken once. `routes`, [(fusion switch, MQDET_DEFORM_IMPL)], limits the
    card runs (default: all five). Returns the launch counts of each card
    run."""
    from mqdet_torch.models.vldyhead import DyConv
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import synthetic_batch

    hw = (256, 256)
    batch = synthetic_batch(cfg, batch=1, image_hw=hw, num_labels=40, k_shot=5, seed=seed + 1)
    image = torch.from_numpy(batch["images"]).permute(0, 3, 1, 2).contiguous()
    text = [torch.from_numpy(batch[k]) for k in ("input_ids", "attention_mask", "queries", "query_mask")]

    def run(model, dev):
        """(FPN levels and logit levels, max |offset| of the DyConv offset convs)."""
        seen = []
        hooks = [m.offset.register_forward_hook(lambda mod, a, out: seen.append(out[:, :18].abs().amax()))
                 for m in model.modules() if isinstance(m, DyConv)]
        try:
            with torch.inference_mode():
                feats = model.encode_image(image.to(dev))
                out = model.forward_head(feats, *(t.to(dev) for t in text))
        finally:
            for h in hooks:
                h.remove()
        outs = [f.float().cpu() for f in feats] + [d.float().cpu() for d in out["dot_product_logits"]]
        return outs, float(torch.stack(seen).max())

    def reference():
        (ref, off32), (plain16, off16) = run(model_cpu, "cpu"), run(copy.deepcopy(model_cpu).to(torch.bfloat16), "cpu")
        return ref, plain16, max(off32, off16)

    routes = routes or [(sw, None) for sw in SWITCHES] + [("default", "window"), ("default", "gather")]
    radius = cfg.TPU.DEFORM_RADIUS
    with switched("default"):
        refs = {"clipped": reference()}
    max_off = refs["clipped"][2]
    if max_off <= radius:
        refs["exact"] = refs["clipped"]
    elif any(deform == "gather" for _, deform in routes):
        with switched("default", "gather"):
            refs["exact"] = reference()
    say(f"phase 3: {label} full width, random init (seed {seed}) at {hw}: max |offset| {max_off!r} "
        f"(CPU, fp32 and bf16) against TPU.DEFORM_RADIUS {radius}: the clip "
        f"{'binds' if max_off > radius else 'does not bind; the exact and clipped CPU references are one run'}")
    names = [f"fpn{i}" for i in range(5)] + [f"logits{i}" for i in range(5)]
    # one VLFuse per head stage (under stream one launch per level); 3 * levels - 2 DCN calls per stage
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    fusion = {"default": {"bi_attention": stages}, "stream": {"bi_attention_levels": stages * levels},
              "dual": {"bi_attention_dual": stages}}
    launches = {}
    for switch, deform in routes:
        with switched(switch, deform):
            launch_counts(reset=True)
            card, _ = run(model_gpu, torch.device("cuda"))
            used = launch_counts()
        want = predicted(**fusion[switch], **{DEFORM_ROUTES[deform]: stages * (3 * levels - 2)})
        run_label = f"{label} ({switch} fusion switches, MQDET_DEFORM_IMPL {deform or 'unset'})"
        if used != want:
            fail(f"{run_label}: launches {used} != predicted {want}")
        launches[f"{label} reference {switch} {deform or 'unset'}"] = used
        ref, plain16, _ = refs["exact" if deform == "gather" else "clipped"]
        worst = compare_to_reference(torch, run_label, names, ref, plain16, card)
        said = {k: v for k, v in used.items() if v}
        say(
            f"phase 3: reference check, {run_label} full width at {hw}, card bf16 kernels vs CPU fp32 "
            f"plain on 5 FPN levels and 5 logit levels: worst err / bound {worst[0]!r} at {worst[1]} "
            f"(card relative L2 err {worst[2]!r}, plain bf16 {worst[3]!r}; bound max(2 * plain, "
            f"{E2E_FLOOR})); launches {said}; ok"
        )
    return launches


def phase_reference_gdino(torch, cfg, model_cpu, model_gpu, seed):
    """As phase_reference_glip for MQ-GroundingDINO-T, on the encoder's
    memory and text and on enc_logits (through `debug_outputs`): tensors
    before the top-900 selection, which bf16 may legitimately change. The
    overlap of the card's selection with the fp32 one is printed. The CPU
    runs under MQDET_MSDA_IMPL=pallas_interpret, so its encoder computes the
    clipped function that the card's default route (unset) launches; the
    share of encoder sample points the clip moves is printed. Returns the
    card run's launch counts."""
    import mqdet_torch.models.gdino as tg
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.ops import ms_deform_attn as ms
    from mqdet_torch.utils.builders import synthetic_caption_batch

    hw = (256, 256)
    batch = synthetic_caption_batch(cfg, batch=1, image_hw=hw, num_labels=40, k_shot=5, seed=seed + 1)
    image = torch.from_numpy(batch["images"]).permute(0, 3, 1, 2).contiguous()
    text = [torch.from_numpy(batch[k]) for k in ("input_ids", "attention_mask", "queries", "query_mask")]

    def run(model, dev):
        model.debug_outputs = True
        try:
            with torch.inference_mode():
                srcs = model.encode_image(image.to(dev))
                out = model.forward_head(srcs, *(t.to(dev) for t in text))
        finally:
            model.debug_outputs = False
        tensors = [out[k].float().cpu() for k in ("dbg_memory", "dbg_text", "enc_logits")]
        return tensors, out["dbg_topk_idx"].cpu()

    shares, sample = [], tg.ms_deform_attn

    def watched(value, shapes, loc, attn):
        if ms.is_encoder(value, shapes, loc):
            shares.append(clip_share(torch, shapes, loc))
        return sample(value, shapes, loc, attn)

    tg.ms_deform_attn = watched
    try:
        with switched("default", msda="pallas_interpret"):
            ref, ref_idx = run(model_cpu, "cpu")
            moved = list(shares)
            plain16, _ = run(copy.deepcopy(model_cpu).to(torch.bfloat16), "cpu")
    finally:
        tg.ms_deform_attn = sample
    g = cfg.GROUNDINGDINO
    with switched("default"):
        launch_counts(reset=True)
        card, card_idx = run(model_gpu, torch.device("cuda"))
        used = launch_counts()
    if (used["ms_deform_attn_clip"], used["ms_deform_attn"]) != (g.enc_layers, g.dec_layers):
        fail(f"MQ-GroundingDINO-T reference run: MSDA launches {used} (predicted {g.enc_layers} clipped, "
             f"{g.dec_layers} exact)")
    say(f"phase 3: MQ-GroundingDINO-T at {hw}, CPU under MQDET_MSDA_IMPL=pallas_interpret: the clip moves "
        f"{moved!r} of the encoder's sample points, layer by layer (fp32 run); card launches "
        f"{ {k: v for k, v in used.items() if v} }")
    worst = compare_to_reference(torch, "MQ-GroundingDINO-T", ("memory", "text", "enc_logits"),
                                 ref, plain16, card)
    overlap = len(set(ref_idx[0].tolist()) & set(card_idx[0].tolist()))
    say(
        f"phase 3: reference check, MQ-GroundingDINO-T full width at {hw}, card bf16 kernels vs CPU "
        f"fp32 plain on the encoder's memory and text and enc_logits: worst err / bound {worst[0]!r} "
        f"at {worst[1]} (card relative L2 err {worst[2]!r}, plain bf16 {worst[3]!r}; bound max(2 * "
        f"plain, {E2E_FLOOR})); top-{ref_idx.shape[1]} selections share {overlap} of "
        f"{ref_idx.shape[1]} indices; ok"
    )
    return used


def phase_reference_extract(torch, label, cfg, model_cpu, model_gpu, seed, select_levels):
    """Phase 3's extraction check: `make_extract_fn` of the card model (bf16)
    against the CPU model (fp32) on one 256x256 image with 6 seeded boxes,
    the pooled (N, S, C) features by relative L2 under phase 3's rule (within
    twice the plain bf16 CPU path's drift, floor E2E_FLOOR), for each
    SELECT_FPN_LEVEL of `select_levels`. Extraction runs the image tower and
    ROIAlign, no hand-written kernel: the card run must launch none."""
    import numpy as np

    from mqdet_torch.mq.extract import make_extract_fn
    from mqdet_torch.ops import launch_counts

    rng = np.random.default_rng(seed + 2)
    image = torch.from_numpy(rng.standard_normal((1, 3, 256, 256)).astype(np.float32))
    xy = rng.uniform(0, 200, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 56, (6, 2))], 1).astype(np.float32)
    model16 = copy.deepcopy(model_cpu).to(torch.bfloat16)
    for select in select_levels:
        c = cfg.clone()
        c.VISION_QUERY.SELECT_FPN_LEVEL = select
        ref = make_extract_fn(model_cpu, c)(image, boxes, 256.0, 256.0)
        plain16 = make_extract_fn(model16, c)(image, boxes, 256.0, 256.0)
        launch_counts(reset=True)
        card = make_extract_fn(model_gpu, c)(image, boxes, 256.0, 256.0).cpu()
        used = {k: v for k, v in launch_counts().items() if v}
        if used:
            fail(f"{label} extraction launched hand-written kernels: {used}")
        if card.shape != ref.shape or card.dtype != torch.float32:
            fail(f"{label} extraction: card features {tuple(card.shape)} {card.dtype}, CPU {tuple(ref.shape)}")
        worst = compare_to_reference(torch, f"{label} extraction", ["pooled"], [ref], [plain16], [card])
        say(f"phase 3: extraction check, {label} full width at (256, 256), SELECT_FPN_LEVEL {select}: pooled "
            f"features {tuple(card.shape)} (6 boxes), card bf16 model vs CPU fp32: relative L2 err {worst[2]!r} "
            f"(plain bf16 {worst[3]!r}; bound max(2 * plain, {E2E_FLOOR})); no kernel launched; ok")
    del model16


FAMILIES = (
    ("dcn kernels", ("dcn_gather_kernel", "dcn_band_kernel")),
    ("bi-attention kernels", ("bi_attn_wgmma_kernel", "bi_attn_combine_kernel")),
    ("msda kernels", ("msda_forward_kernel", "msda_band_kernel")),
    ("convolutions", ("conv", "fprop", "implicit")),
    ("matmuls", ("gemm", "nvjet", "cutlass", "xmma")),
    ("copies", ("copy",)),
    ("norms", ("norm", "Moments")),
)


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    total, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + cur_e - cur_s


def phase_profile(torch, label, protocol, image, text):
    """One protocol run under torch.profiler: the device's busy time (union
    of kernel intervals), its share of the window from the first kernel's
    start to the last one's end, and kernel time by family. The profiler
    slows the host, so the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        protocol(image, *text)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        say(f"phase 5: {label}: the profiler recorded no device kernels; breakdown not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy = union_us(spans)
    window = spans[-1][1] - spans[0][0]
    fam = {}
    for e in kernels:
        key = next((f for f, pats in FAMILIES if any(p in e.name for p in pats)), "other")
        fam[key] = fam.get(key, 0.0) + e.time_range.end - e.time_range.start
    parts = ", ".join(f"{k} {v / 1000.0:.1f}" for k, v in sorted(fam.items(), key=lambda kv: -kv[1]))
    say(f"phase 5: {label} profiled protocol: device busy {busy / 1000.0!r} ms in a "
        f"{window / 1000.0!r} ms window (idle share {1.0 - busy / window!r}, profiler on); "
        f"{len(kernels)} kernels; kernel ms by family: {parts}")
    own = []
    for pat in (p for f, pats in FAMILIES[:3] for p in pats):
        us = [e.time_range.end - e.time_range.start for e in kernels if pat in e.name]
        if us:
            own.append(f"{pat} {sum(us) / 1000.0!r} ms in {len(us)} launches ({sum(us) / len(us) / 1000.0!r} each)")
    say(f"phase 5: {label} hand-written kernels: {'; '.join(own)}")


def phase_split(torch, label, protocol, image, text, parts):
    """One protocol run with a device synchronise before and after each
    module of `parts` ({name: [modules]}, none inside another): host-clock ms
    per name, and the rest (glue, heads and postprocess outside those
    modules). The synchronisations stop the host running ahead of the
    device, so the total exceeds the p50: the split says where the time
    goes, not how long the protocol takes."""
    spent = {name: 0.0 for name in parts}
    calls = {name: 0 for name in parts}
    start = {}

    def pre(mod, args):
        torch.cuda.synchronize()
        start[id(mod)] = time.perf_counter()

    def post(name):
        def hook(mod, args, out):
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - start[id(mod)]
            calls[name] += 1
        return hook

    handles = []
    for name, mods in parts.items():
        for m in mods:
            handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post(name))]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        protocol(image, *text)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for h in handles:
            h.remove()
    if not all(calls.values()):
        fail(f"{label}: split hooks on modules the protocol never called: {calls}")
    split = ", ".join(f"{k} {v * 1000.0!r} ({calls[k]} calls)" for k, v in spent.items())
    say(f"phase 6: {label} split by module (host clock, synchronised at module boundaries): total "
        f"{total * 1000.0!r} ms; ms by module: {split}, rest {(total - sum(spent.values())) * 1000.0!r}")


def predicted(**counts) -> dict:
    """Launch counts of one protocol run: `counts`, and 0 for every other kernel."""
    from mqdet_torch.ops import COUNTERS

    return {name: counts.get(name, 0) for name, _, _ in COUNTERS}


def phase_protocol(torch, label, model, cfg, make_batch, slots, want, runs, seed, parts=None,
                   switch="default", deform=None):
    """Phase 4 and 5 for one model under the fusion switches SWITCHES[switch]
    and MQDET_DEFORM_IMPL `deform` (None: unset), and phase 6 where `parts`
    is given; returns the launch counts of the counted protocol run (a name
    of `mqdet_torch.ops.COUNTERS` each)."""
    from mqdet_torch.engine.predict import make_protocol_fn
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import protocol_inputs

    label = label if switch == "default" else f"{label} {switch}"
    label = label if deform is None else f"{label} MQDET_DEFORM_IMPL={deform}"
    dev = torch.device("cuda")
    hw = (800, 1344)
    cp, groups = 4, -(-31 // 4)
    image, text = protocol_inputs(cfg, make_batch, groups, cp, hw, seed)
    image, text = image.to(dev), [t.to(dev) for t in text]
    protocol = make_protocol_fn(model, hw, cfg)
    with switched(switch, deform):
        torch.cuda.reset_peak_memory_stats()
        protocol(image, *text)  # warm-up
        torch.cuda.synchronize()

        launch_counts(reset=True)
        dets = protocol(image, *text)
        torch.cuda.synchronize()
        launches = launch_counts()
        shapes_ok = (
            tuple(dets.boxes.shape) == (groups, cp, slots, 4)
            and tuple(dets.scores.shape) == tuple(dets.labels.shape) == tuple(dets.valid.shape)
            == (groups, cp, slots)
        )
        finite = all(bool(torch.isfinite(t).all()) for t in (dets.boxes, dets.scores))
        n_valid = int(dets.valid.sum())
        labels_ok = bool(((dets.labels >= 0) & (dets.labels <= 40)).all())
        say(f"phase 4: {label} protocol launches {launches} (predicted {want}); shapes ok {shapes_ok}; "
            f"finite {finite}; labels in range {labels_ok}; valid detections {n_valid} of "
            f"{groups * cp * slots}")
        if launches != want:
            fail(f"{label}: launch counts {launches} != predicted {want}")
        if not (shapes_ok and finite and labels_ok):
            fail(f"{label}: protocol output malformed")

        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            protocol(image, *text)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        p50 = statistics.median(times)
        say(f"phase 4: {label} protocol p50 {p50 * 1000.0!r} ms over {runs} runs "
            f"(min {min(times) * 1000.0!r}, max {max(times) * 1000.0!r}); {1.0 / p50!r} img/s; "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB")
        phase_profile(torch, label, protocol, image, text)
        if parts is not None:
            phase_split(torch, label, protocol, image, text, parts)
    return launches


def synced_seconds(torch, fn, reps=1):
    """Host-clock seconds of `reps` calls of fn, synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def vq_settings(cfg):
    """A copy of `cfg` with phase 7's settings: lvis_minival.yaml's (300
    detections an image, chunks of 40 classes, CP 4, 5 queries a class,
    MAX_QUERY_NUMBER 5, no text dropout), the thresholds at 0."""
    c = cfg.clone()
    c.MODEL.ATSS.DETECTIONS_PER_IMG = 300
    c.TEST.CHUNKED_EVALUATION, c.TEST.CHUNK_PARALLELISM = 40, 4
    c.VISION_QUERY.NUM_QUERY_PER_CLASS = c.VISION_QUERY.MAX_QUERY_NUMBER = 5
    c.VISION_QUERY.TEXT_DROPOUT = 0.0
    c.MODEL.ATSS.INFERENCE_TH = c.GROUNDINGDINO.box_threshold = c.VISION_QUERY.SCORE_THRESHOLD = 0.0
    return c


def phase_vision_query(torch, label, cfg, model, seed, per_image, root, slots, keep=None, phase="phase 7"):
    """Phase 7, per model after its phase 6: the vision-query path on the
    card at full width, with the settings of
    configs/vision_query_5shot/lvis_minival.yaml (300 detections an image,
    chunks of 40 classes, CP 4, 5 queries a class, MAX_QUERY_NUMBER 5, no text
    dropout) and the detection and update thresholds at 0, so random-init
    scores reach the evaluator and the update. `per_image`: the predicted
    launches of one image's 8 head groups; `slots`: detection slots per
    chunk row. Returns the launch counts of the evaluation and the update;
    `keep`, a dict, receives the dataset, the extracted bank, the results
    and the detections; `phase` prefixes the lines."""
    import numpy as np

    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.data.transforms import EvalTransform
    from mqdet_torch.engine.evaluator import DetectionEvaluator
    from mqdet_torch.engine.inference import ChunkedEvaluationPlan, online_update, run_inference
    from mqdet_torch.mq.bank import QueryBank
    from mqdet_torch.mq.extract import (
        dataset_extraction_iter, extract_queries_into_bank, make_extract_fn, pool_queries,
    )
    from mqdet_torch.mq.selector import QuerySelector
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import synthetic_lvis

    dev = next(model.parameters()).device
    c = vq_settings(cfg)
    ds, freq = synthetic_lvis(root, seed)
    tok = WordPieceTokenizer()  # the hash vocab: no vocab file or download on this machine
    n_img = len(ds.ids)
    with_gt = {int(l) for i in ds.ids for l in ds.annotations(i)[1]}

    # 1. extraction into a bank
    extract_fn = make_extract_fn(model, c)
    bank = QueryBank(channels=c.MODEL.BACKBONE.OUT_CHANNELS)
    launch_counts(reset=True)
    ext_s = synced_seconds(torch, lambda: extract_queries_into_bank(
        extract_fn, dataset_extraction_iter(ds, EvalTransform(c), dev), bank,
        max_query_number=c.VISION_QUERY.MAX_QUERY_NUMBER))
    used = {k: v for k, v in launch_counts().items() if v}
    queries = sum(bank.count(l) for l in bank.labels)
    say(f"{phase}: {label} extraction over {n_img} images: {ext_s * 1000.0 / n_img!r} ms per image (host clock, "
        f"synchronised; transform, image tower, ROIAlign, bank); {len(bank)} classes, {queries} queries banked; "
        f"hand-written kernel launches {used}")
    if set(bank.labels) != with_gt:
        fail(f"{label} extraction: banked classes {sorted(bank.labels)} != the classes with GT {sorted(with_gt)}")
    if keep is not None:
        keep.update(dataset=ds, bank=bank)
    if used:
        fail(f"{label} extraction launched hand-written kernels: {used}")
    batch = next(dataset_extraction_iter(ds, EvalTransform(c), dev))
    h, w = batch["image_size"]
    xy = np.random.default_rng(seed).uniform(0, min(h, w) - 40, (slots, 2))
    boxes = {"its GT": torch.from_numpy(batch["boxes"]).to(dev),
             "an online-update row's": torch.from_numpy(np.concatenate([xy, xy + 32.0], 1).astype(np.float32)).to(dev)}
    with torch.inference_mode():
        feats = model.encode_image(batch["image"])
        enc_ms = synced_seconds(torch, lambda: model.encode_image(batch["image"]), 20) * 1000.0
        pool_ms = {k: synced_seconds(torch, lambda: pool_queries(c, feats, b, h, w), 20) * 1000.0
                   for k, b in boxes.items()}
    say(f"{phase}: {label} extraction split (first image, mean of 20 synchronised calls each): image tower "
        f"{enc_ms!r} ms; ROIAlign with box expansion and means (`pool_queries`) of "
        + "; of ".join(f"{k} {len(boxes[k])} boxes {v!r} ms, a share {v / (v + enc_ms)!r}" for k, v in pool_ms.items()))

    # 2. the plan
    selector = QuerySelector(bank, num_query_per_class=c.VISION_QUERY.NUM_QUERY_PER_CLASS,
                             max_labels=c.VISION_QUERY.MAX_CLASSES_PER_PROMPT)
    t0 = time.perf_counter()
    plan = ChunkedEvaluationPlan(c, ds, tok, selector)
    plan_s = time.perf_counter() - t0
    shapes = {k: tuple(getattr(plan, k).shape) for k in
              ("input_ids", "attention_mask", "all_map", "agg_map", "slot_to_label", "queries", "query_mask")}
    say(f"{phase}: {label} ChunkedEvaluationPlan: {len(plan)} chunks, arrays {shapes}; built in {plan_s!r} s "
        f"(host)")

    # 3. run_inference with the LVIS evaluator
    class Checked(DetectionEvaluator):
        """Every detection finite and inside its image."""
        def add_image(self, image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **kw):
            ih, iw = ds.image_size(image_id)
            ok = (np.isfinite(det_boxes).all() and np.isfinite(det_scores).all() and (det_boxes >= 0).all()
                  and (det_boxes[:, 0::2] <= iw).all() and (det_boxes[:, 1::2] <= ih).all())
            if not ok:
                fail(f"{label} run_inference: image {image_id} has a detection not finite or outside {(ih, iw)}")
            self.n_dets = getattr(self, "n_dets", 0) + len(det_scores)
            self.dets[image_id] = (det_boxes.copy(), det_scores.copy(), det_labels.copy())
            super().add_image(image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **kw)

    evaluator = Checked(style="lvis_fixed", max_dets=300, category_frequency=freq)
    evaluator.dets = {}
    torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    res = run_inference(c, model, ds, tok, selector, evaluator=evaluator, verbose=False)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = launch_counts()
    want = {k: v * n_img for k, v in per_image.items()}
    aps = {k: res.get(k) for k in ("AP", "AP50", "AP75", "APr", "APc", "APf")}
    say(f"{phase}: {label} run_inference over {n_img} images (6 landscape, 2 portrait; LVIS fixed AP, 300 "
        f"detections): {res['images_per_second']!r} img/s ({eval_s!r} s host clock); {evaluator.n_dets} "
        f"detections; {aps}; seconds by stage {res['seconds']} (transform, encode, head: the stream's time "
        f"between marks; fetch: host clock of the copies, waiting for the queue; evaluator: host); launches "
        f"{eval_launches} (predicted {want})")
    if eval_launches != want:
        fail(f"{label} run_inference: launches {eval_launches} != predicted {want}")
    if not all(v is not None and np.isfinite(v) for v in aps.values()):
        fail(f"{label} run_inference: AP fields not all finite: {aps}")
    if keep is not None:
        keep.update(results=res, detections=evaluator.dets)

    # 4. one online-update turn over 2 images from an empty bank
    update_bank = QueryBank(channels=c.MODEL.BACKBONE.OUT_CHANNELS)
    spent = {"extract_fn": 0.0, "calls": 0}

    def timed_extract(*a):
        t = time.perf_counter()
        out = extract_fn(*a)
        torch.cuda.synchronize()
        spent["extract_fn"] += time.perf_counter() - t
        spent["calls"] += 1
        return out

    torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    online_update(c, model, ds, tok, QuerySelector(update_bank, num_query_per_class=c.VISION_QUERY.NUM_QUERY_PER_CLASS,
                                                   max_labels=c.VISION_QUERY.MAX_CLASSES_PER_PROMPT),
                  timed_extract, max_images=2)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    update_launches = launch_counts()
    want = {k: v * 2 for k, v in per_image.items()}
    added = sum(update_bank.count(l) for l in update_bank.labels)
    say(f"{phase}: {label} online_update, one turn over 2 images (MAX_TEST_QUERY_NUMBER "
        f"{c.VISION_QUERY.MAX_TEST_QUERY_NUMBER}, SCORE_THRESHOLD 0): {added} queries added over "
        f"{len(update_bank)} classes in {update_s!r} s ({update_s / 2!r} s per image; extract_fn "
        f"{spent['extract_fn']!r} s in {spent['calls']} calls, each re-encoding the image); launches "
        f"{update_launches} (predicted {want})")
    if update_launches != want:
        fail(f"{label} online_update: launches {update_launches} != predicted {want}")
    if not added:
        fail(f"{label} online_update added no query")
    return {f"{label} vision-query eval": eval_launches, f"{label} online update": update_launches}


def dropout_off(model):
    """The model with its training dropout rates at 0 (the fusion's attention
    dropout, Swin's stochastic depth): the training forward, deterministic."""
    from mqdet_torch.models.fusion import BiMultiHeadAttention
    from mqdet_torch.models.swin import SwinBlock

    for m in model.modules():
        if isinstance(m, BiMultiHeadAttention):
            m.dropout = 0.0
        if isinstance(m, SwinBlock):
            m.drop_path = 0.0
    return model


def reference_batch(cfg, seed, hw=(256, 256)):
    """The reference steps' batch: `synthetic_batch` of 2 images at `hw`,
    40 labels x 5 queries, 8 seeded ground-truth boxes an image on the
    labels' token spans, every label with a query (numpy)."""
    import numpy as np

    from mqdet_torch.utils.builders import synthetic_batch

    b = synthetic_batch(cfg, batch=2, image_hw=hw, num_labels=40, k_shot=5, seed=seed + 2)
    rng = np.random.default_rng(seed + 2)
    g_max = 8
    boxes = np.zeros((2, g_max, 4), np.float32)
    labels = rng.integers(0, 40, (2, g_max))
    for i in range(2):
        xy = rng.uniform(0, hw[0] * 0.625, (g_max, 2))
        boxes[i] = np.concatenate([xy, xy + rng.uniform(24, 96, (g_max, 2))], 1).clip(0, hw[0] - 1)
    batch = {k: b[k] for k in ("images", "input_ids", "attention_mask", "queries", "query_mask")}
    batch.update(gt_boxes=boxes, gt_labels=(labels + 1).astype(np.int32), gt_valid=np.ones((2, g_max), bool),
                 gt_token_map=np.take_along_axis(b["agg_map"], labels[..., None], 1).astype(np.float32),
                 pos_category_map=(b["agg_map"] > 0).astype(np.float32), has_query=np.ones((2, 40), np.int32))
    return batch


def phase_train_reference(torch, cfg, model_cpu, seed, bounds=None):
    """One training step at 256x256, full width, batch 2, dropout off: the
    card (bf16, kernels) against the same step on the CPU in fp32 (plain
    versions), same weights and batch, by relative L2 on the loss and on
    every trainable gradient, under phase 3's rule: within twice the CPU
    plain path's own bf16 drift, or E2E_FLOOR. A gradient's bf16 drift is
    noise (bf16 rounding through 12 BERT layers and 6 head stages), so one
    bf16 run samples it once: a gate ff_gate's drift read 0.0093 in one run
    and 0.235 with the images scaled by 1 + 1e-3, which moves the fp32
    gradients by < 1e-3 (measured on one H100). The drift is therefore taken as the
    larger of three CPU bf16 runs, on the images scaled by 1 and 1 +- 1e-3,
    each against the fp32 step on the same images; the concatenated
    gradient is also held to twice the unscaled run's drift. Returns the
    card step's launch counts."""
    import numpy as np

    from mqdet_torch.core.config import trainable_patterns
    from mqdet_torch.engine.train import batch_to_device, init_train_state, make_train_step
    from mqdet_torch.ops import launch_counts

    hw = (256, 256)
    c = cfg.clone()
    c.VISION_QUERY.TEXT_DROPOUT = 0.0
    batch = reference_batch(c, seed, hw)

    def step(model, dev, scale=1.0):
        state, tx = init_train_state(model, c, trainable_patterns(c))
        run = make_train_step(model, tx, c)
        inputs = dict(batch, images=(batch["images"] * np.float32(scale)).astype(np.float32))
        _, metrics = run(state, batch_to_device(inputs, dev), torch.Generator(device=dev).manual_seed(seed))
        params = dict(model.named_parameters())
        return float(metrics["loss_total"]), {n: params[n].grad.float().cpu() for n in state.trainable}

    t0 = time.perf_counter()
    scales = (1.0, 1.0 + 1e-3, 1.0 - 1e-3)
    ref32 = {s: step(dropout_off(copy.deepcopy(model_cpu)), torch.device("cpu"), s) for s in scales}
    run16 = {s: step(dropout_off(copy.deepcopy(model_cpu).to(torch.bfloat16)), torch.device("cpu"), s) for s in scales}
    cpu_s = time.perf_counter() - t0
    gpu = dropout_off(copy.deepcopy(model_cpu)).to("cuda", torch.bfloat16).to(memory_format=torch.channels_last)
    launch_counts(reset=True)
    card = step(gpu, torch.device("cuda"))
    used = launch_counts()
    del gpu
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    want = predicted(dcn_band=stages * (3 * levels - 2))
    if used != want:
        fail(f"phase 8 reference step: launches {used} != predicted {want}")
    reference_verdict(torch, "phase 8", f"MQ-GLIP-T full width at {hw}", card, ref32, run16, scales,
                      f"CPU steps {cpu_s!r} s; launches {({k: v for k, v in used.items() if v})}", bounds)
    return used


def reference_verdict(torch, phase, what, card, ref32, run16, scales, tail, bounds=None) -> None:
    """Phase 3's rule on a training step: the card's loss and every
    trainable gradient (`card`: (loss, {name: grad})) against the fp32 CPU
    step (`ref32[1.0]`), each within twice the largest drift of the CPU bf16
    runs (`run16[s]` against `ref32[s]`, s in `scales`), floor E2E_FLOOR; the
    concatenated gradient within twice the unscaled run's drift; and the
    scaled fp32 runs within 1e-2 of the unscaled one (the scaling is no
    larger change than the drift it samples). Prints the line; fails
    outside the rule. `bounds`, a dict, receives the rule's bound of the
    loss ("loss"), of each gradient (by name) and of the concatenated
    gradient ("concatenated")."""
    def rel(a, ref):
        return float(torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref).clamp(min=1e-30))

    def errs(got, ref):
        """[(name, relative L2)]: the loss, then each trainable gradient."""
        return [("loss", abs(got[0] - ref[0]) / abs(ref[0]))] + [(n, rel(got[1][n], ref[1][n])) for n in ref[1]]

    plain = [errs(run16[s], ref32[s]) for s in scales]
    moved = max(e for _, e in errs(ref32[scales[1]], ref32[1.0])[1:])
    card_errs = errs(card, ref32[1.0])
    rows = [(n, e, max(p[i][1] for p in plain), plain[0][i][1]) for i, (n, e) in enumerate(card_errs)]
    ratio = lambda r: r[1] / max(2 * r[2], E2E_FLOOR)  # noqa: E731
    worst = max(rows, key=ratio)
    bad = [r for r in rows if not (math.isfinite(r[1]) and ratio(r) <= 1.0)]
    flat = lambda grads: torch.cat([g.reshape(-1) for g in grads.values()])  # noqa: E731
    g_card, g_plain = rel(flat(card[1]), flat(ref32[1.0][1])), rel(flat(run16[1.0][1]), flat(ref32[1.0][1]))
    ok = not bad and g_card <= max(2 * g_plain, E2E_FLOOR) and moved < 1e-2
    if bounds is not None:
        bounds.update({n: max(2 * b, E2E_FLOOR) for n, _, b, _ in rows}, concatenated=max(2 * g_plain, E2E_FLOOR))
    say(f"{phase}: reference step, {what}, batch 2, dropout off, card bf16 kernels vs CPU fp32 plain: loss "
        f"{card[0]!r} vs {ref32[1.0][0]!r}; {len(rows) - 1} trainable gradients; worst err / bound {ratio(worst)!r} "
        f"at {worst[0]} (card relative L2 {worst[1]!r}; plain bf16 {worst[3]!r}, the largest of the three CPU bf16 "
        f"runs {worst[2]!r}; bound max(2 * largest, {E2E_FLOOR})); the concatenated gradient: card {g_card!r}, "
        f"plain bf16 {g_plain!r} (bound max(2 * plain, {E2E_FLOOR})); the 1e-3 image scaling moves the fp32 "
        f"gradients by at most {moved!r}; {tail}; {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{phase} reference step: {len(bad)} of {len(rows)} outside the bound, e.g. {bad[:3]}; concatenated "
             f"{g_card!r} vs plain {g_plain!r}; fp32 moved {moved!r}")


def phase_dcn_backward(torch, seed, smi):
    """Each DCN Function's backward on the card (bf16 inputs, the fp32 VJP
    recomputed from them) against the plain VJP in fp32 on the same inputs
    at GLIP's level-0 and level-1 shapes, B = 2, offsets x3 (the clip
    binds): every gradient within ERR_BOUND * max|ref|. Returns
    {route: level-0 stride-1 backward ms} (CUDA events, median of 5)."""
    from mqdet_torch.ops import deform_conv as dc
    from mqdet_torch.tools import cuda_time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 8)
    routes = {
        "band (K1)": (lambda *a, s: dc.modulated_deform_conv_pallas(*a, stride=s, radius=2, block_rows=16),
                      lambda *a, s: dc.modulated_deform_conv_window_vjp(*a, stride=s, radius=2)),
        "window (K2)": (lambda *a, s: dc.modulated_deform_conv_window(*a, stride=s, radius=2),
                        lambda *a, s: dc.modulated_deform_conv_window_vjp(*a, stride=s, radius=2)),
        "exact": (lambda *a, s: dc.modulated_deform_conv(*a, stride=s),
                  lambda *a, s: dc.modulated_deform_conv_exact_vjp(*a, stride=s)),
    }
    times = {}
    for (h, w), stride in (((100, 168), 1), ((50, 84), 1), ((100, 168), 2)):
        ho, wo = -(-h // stride), -(-w // stride)
        ins = [torch.randn(2, h, w, 256, generator=g, device=dev), torch.randn(2, ho, wo, 18, generator=g, device=dev) * 3,
               torch.rand(2, ho, wo, 9, generator=g, device=dev), torch.randn(3, 3, 256, 256, generator=g, device=dev) * 0.03,
               torch.randn(256, generator=g, device=dev) * 0.1]
        ins = [t.bfloat16() for t in ins]
        gout = torch.randn(2, ho, wo, 256, generator=g, device=dev).bfloat16()
        for name, (fwd, vjp) in routes.items():
            leaves = [t.clone().requires_grad_(True) for t in ins]
            fwd(*leaves, s=stride).backward(gout)
            refs = vjp(*(t.float() for t in ins), gout.float(), s=stride)
            errs = []
            for label, leaf, ref in zip(("x", "offset", "mask", "weight", "bias"), leaves, refs):
                err, scale = max_err(leaf.grad, ref)
                errs.append((label, err / max(scale, 1e-30)))
                if not (bool(torch.isfinite(leaf.grad).all()) and err <= ERR_BOUND * scale):
                    fail(f"phase 8: DCN backward {name} at {(2, h, w, 256)} s{stride}: {label} gradient err {err!r} "
                         f"> {ERR_BOUND} * max|ref| {scale!r}")
            ms_ = None
            if (h, stride) == (100, 1):
                def once():
                    leaves2 = [t.clone().requires_grad_(True) for t in ins]
                    fwd(*leaves2, s=stride).backward(gout)
                fwd_ms = cuda_time_ms(lambda: fwd(*ins, s=stride), iters=5, warmup=1)
                ms_ = cuda_time_ms(once, iters=5, warmup=1) - fwd_ms
                times[name] = ms_
            say(f"phase 8: DCN backward, {name} Function at {(2, h, w, 256)} stride {stride}, offsets x3: "
                f"gradients against the fp32 plain VJP, max err / max|ref| "
                f"{', '.join(f'{k} {v!r}' for k, v in errs)} (bound {ERR_BOUND})"
                + (f"; backward {ms_!r} ms (CUDA events: forward+backward minus forward, median of 5; {smi})"
                   if ms_ is not None else "") + "; ok")
    return times


def phase_train(torch, seed, dataset, bank, smi, bounds=None):
    """Phase 8: MQ-GLIP-T modulated pre-training at full width on the card
    (`mq_glip_t_pretrain_config`) on phase 7's synthetic LVIS-shaped dataset and
    phase 7's extracted MQ-GLIP-T bank: the reference step, each DCN
    Function's backward, then `train_steps` on the landscape images.
    Returns the launch counts of the timed steps; `bounds`, a dict,
    receives the reference step's bounds."""
    from mqdet_torch.utils.builders import build_model, init_params, landscape, mq_glip_t_pretrain_config

    cfg = mq_glip_t_pretrain_config()
    model_cpu = init_params(build_model(cfg), seed=seed)
    phase_train_reference(torch, cfg, model_cpu, seed, bounds)
    bwd_ms = phase_dcn_backward(torch, seed, smi)
    torch.cuda.empty_cache()
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    return train_steps(torch, "phase 8", "MQ-GLIP-T", cfg, model_cpu, landscape(dataset), bank, smi,
                       predicted(dcn_band=stages * (3 * levels - 2)),  # 78 a forward; no bi-attention kernel
                       "dcn_backward", "`DeformConvFunction`", ("dcn_band_kernel",),
                       f"level-0 backward alone (CUDA events) {bwd_ms}",
                       portrait=landscape(dataset, portrait=True))


def train_steps(torch, phase, label, cfg, model_cpu, ds, bank, smi, per_step, span, function, fwd_kernels, note,
                portrait=None, out=None):
    """The timed part of a training phase, through the port's train entry
    (`tools.train.build_training`: model, selector, loader, state, step,
    checkpointer): two warm-up steps, 8 timed steps (launches gated at
    `per_step` a step), one step split by a synchronise at forward /
    backward / update (and the matcher's host time, where the step has
    one), one profiled step (device busy, idle share, the kernels inside
    the `span` annotations of the `function` backwards, the forward kernels
    named like `fwd_kernels`), where `portrait` (a dataset of portrait
    images) is given one step on a batch of them in the rotated bucket
    (ROADMAP Queue C 1: its own anchors; loss finite, launches as a step's),
    a checkpoint save and restore; then the gates (losses finite, frozen
    bitwise, every trainable tensor and its EMA, where MODEL_EMA keeps one,
    moved). Returns the launch counts of the timed steps; `out`, a dict,
    receives the median ms per step and the peak memory in GiB."""
    import numpy as np

    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.engine.train import batch_to_device, step_generator
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.tools.train import build_training

    timed = 8
    dev = torch.device("cuda")
    out_dir = tempfile.mkdtemp(prefix="mqdet_train_")
    model, loader, state, step, ckpt = build_training(cfg, ds, bank, out_dir, dev, model=model_cpu,
                                                      tokenizer=WordPieceTokenizer())
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n in state.frozen}
    start = {n: t.clone() for n, t in state.trainable.items()}

    def batches():
        while True:
            yield from loader

    stream = batches()
    losses, step_ms, data_ms = [], [], []

    def one(times=None):
        t0 = time.perf_counter()
        b = next(stream)
        b.pop("num_positive")
        data_ms.append((time.perf_counter() - t0) * 1000.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, batch_to_device(b, dev), step_generator(cfg.SOLVER.SEED, state.step, dev), times)
        values = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1000.0)
        losses.append(values)

    for _ in range(2):
        one()
    torch.cuda.reset_peak_memory_stats()
    step_ms.clear()
    launch_counts(reset=True)
    for _ in range(timed):
        one()
    used = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: v * timed for k, v in per_step.items()}
    p50 = statistics.median(step_ms)
    say(f"{phase}: {label} training (vision_query, batch 2, 800x1344, seed {cfg.SOLVER.SEED}; {smi}): {p50!r} ms per "
        f"step (median of {timed}; min {min(step_ms)!r}, max {max(step_ms)!r}; host clock, synchronised; the "
        f"loader's host time apart: median {statistics.median(data_ms)!r} ms), {2 * 1000.0 / p50!r} train img/s; "
        f"peak {peak!r} GiB; launches {({k: v for k, v in used.items() if v})} (predicted {want})")
    if used != want:
        fail(f"{phase}: training launches {used} != predicted {want}")
    if out is not None:
        out.update(ms=p50, peak=peak)

    times = {}
    one(times)
    say(f"{phase}: one step split by a synchronise at each boundary ({smi}): "
        + ", ".join(f"{k} {v * 1000.0!r} ms" for k, v in times.items()) + f" (step {step_ms[-1]!r} ms)")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    marks = [(e.time_range.start, e.time_range.end) for e in device if e.name == span]
    kernels = [(e.time_range.start, e.time_range.end, e.name) for e in device if e.name != span]
    if kernels:
        busy = union_us([k[:2] for k in kernels]) / 1000.0
        window = (max(k[1] for k in kernels) - min(k[0] for k in kernels)) / 1000.0
        # the kernels inside the device-side spans of the annotation
        bwd = union_us([k[:2] for k in kernels if any(s0 <= k[0] and k[1] <= s1 for s0, s1 in marks)]) / 1000.0
        fwd = sum(k[1] - k[0] for k in kernels if any(n in k[2] for n in fwd_kernels)) / 1000.0
        said = (f"{bwd!r} ms, a share {bwd / busy!r} of busy" if marks
                else f"not measured (the profiler recorded no device-side `{span}` span)")
        say(f"{phase}: profiled step ({smi}): device busy {busy!r} ms in a {window!r} ms window (idle share "
            f"{1.0 - busy / window!r}, profiler on); the backward (the kernels inside the {len(marks)} `{span}` "
            f"spans of the {function} backwards) {said}; the forward kernels ({', '.join(fwd_kernels)}) "
            f"{fwd!r} ms; {note}")
    else:
        say(f"{phase}: the profiler recorded no device kernels; the backward's device share not measured")

    if portrait is not None:
        from mqdet_torch.data.loader import GroundingTrainLoader

        pcfg = cfg.clone()
        pcfg.AUGMENT.MULT_MIN_SIZE_TRAIN = (800,)  # 640x480 -> 1066x800: only the rotated bucket holds it
        pb = next(iter(GroundingTrainLoader(portrait, pcfg, loader.tokenizer, loader.selector)))
        pb.pop("num_positive")
        launch_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, batch_to_device(pb, dev), step_generator(cfg.SOLVER.SEED, state.step, dev))
        values = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1000.0
        plaunch = launch_counts()
        say(f"{phase}: one step on phase 7's {len(portrait.ids)} portrait images (ROADMAP Queue C 1): batch "
            f"{tuple(pb['images'].shape)}, the rotated bucket's anchors, in {ms!r} ms (host clock, synchronised; "
            f"{smi}); losses {values}; launches {({k: v for k, v in plaunch.items() if v})} (predicted {per_step})")
        if tuple(pb["images"].shape[1:3]) != tuple(cfg.TPU.IMAGE_BUCKETS[0])[::-1]:
            fail(f"{phase}: the portrait batch is not in the rotated bucket: {tuple(pb['images'].shape)}")
        if not all(np.isfinite(v) for v in values.values()):
            fail(f"{phase}: the portrait step's loss is not finite: {values}")
        if plaunch != per_step:
            fail(f"{phase}: the portrait step's launches {plaunch} != predicted {per_step}")

    for rec in losses:
        if not all(np.isfinite(v) for v in rec.values()):
            fail(f"{phase}: a loss term is not finite: {rec}")
    say(f"{phase}: losses of the last step {losses[-1]}")
    params = dict(model.named_parameters())
    changed = [n for n in frozen if not torch.equal(params[n], frozen[n])]
    if changed:
        fail(f"{phase}: frozen parameters changed: {changed[:5]}")
    still = [n for n, t in state.trainable.items() if torch.equal(t, start[n])]
    same_ema = [n for n, t in state.trainable.items() if state.ema is not None and torch.equal(t, state.ema[n])]
    if still or same_ema:
        fail(f"{phase}: trainable tensors unchanged {still[:5]}; EMA equal to the parameters {same_ema[:5]}")

    t0 = time.perf_counter()
    path = ckpt.save(state.step, state, {"iteration": state.step})
    restored, at = ckpt.restore(state)
    same = (at == state.step and restored.opt_state["count"] == state.opt_state["count"]
            and (restored.ema is None) == (state.ema is None)
            and all(torch.equal(restored.trainable[n], t)
                    and (state.ema is None or torch.equal(restored.ema[n], state.ema[n]))
                    and torch.equal(restored.opt_state["nu"][n], state.opt_state["nu"][n])
                    for n, t in state.trainable.items()))
    ema = "their EMA apart from them" if state.ema is not None else "no EMA (SOLVER.MODEL_EMA 0)"
    say(f"{phase}: {len(frozen)} frozen tensors bitwise unchanged; all {len(start)} trainable tensors moved, "
        f"{ema}; checkpoint of step {state.step} saved ({os.path.getsize(path) / 2**20!r} MiB) "
        f"and restored in {time.perf_counter() - t0!r} s, equal: {same}")
    if not same:
        fail(f"{phase}: the restored checkpoint differs from the saved state")
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)
    del model, state, step, loader, ckpt, frozen, start
    torch.cuda.empty_cache()
    return used


def train_config_gdino():
    """MQ-GroundingDINO-T with the training settings of
    configs/pretrain/mq-groundingdino-t.yaml: recipe vision_query (the GCP
    pieces train), BASE_LR 1e-4 (the other LRs the defaults: GATE 5e-3,
    QUERY 1e-5, LANG 1e-5), text dropout 0.4, 5 queries a class, the
    800x1344 bucket; phase 8's cuts for the same reasons: batch 2
    (one card), the warmup at 0 and MAX_ITER 1000 (a step's time does not
    depend on the LR). MODEL_EMA 0.999, as mq-glip-t.yaml sets it: the yaml
    leaves the default 0 (no EMA), so the EMA path and its gate would not
    run."""
    from mqdet_torch.utils.builders import mq_groundingdino_t_config

    cfg = mq_groundingdino_t_config()
    s, vq = cfg.SOLVER, cfg.VISION_QUERY
    s.TUNING_HIGHLEVEL_OVERRIDE, s.BASE_LR = "vision_query", 1e-4
    s.MODEL_EMA, s.IMS_PER_BATCH, s.WARMUP_ITERS, s.MAX_TO_KEEP, s.MAX_ITER = 0.999, 2, 0, 4, 1000
    vq.TEXT_DROPOUT, vq.NUM_QUERY_PER_CLASS = 0.4, 5
    return cfg


def phase_train_reference_gdino(torch, cfg, model_cpu, seed, bounds=None):
    """Phase 9's reference step: one MQ-GroundingDINO-T training step at
    256x256, full width, batch 2 (40 labels, 8 gt boxes an image), dropout
    off, the card (bf16, kernels) against the CPU in fp32 (plain versions,
    under MQDET_MSDA_IMPL=pallas_interpret, so the encoder computes K5's
    clipped function as the card's default route does), by phase 8's rule
    (`reference_verdict`). The Hungarian assignment is an argmin: bf16 noise
    can flip a near-tied pair, which moves the loss by order 1, not by a
    drift. So the fp32 unscaled run's assignment is given to every other run
    (`assignment=`, a keyword the training path never passes), and the card's
    own matcher is run once to count the pairs it would have chosen
    otherwise. Returns the launch counts of the fixed-assignment card step."""
    import numpy as np

    from mqdet_torch.core.config import trainable_patterns
    from mqdet_torch.engine.train import batch_to_device, init_train_state, make_gdino_train_step
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import synthetic_caption_batch

    hw = (256, 256)
    c = cfg.clone()
    c.VISION_QUERY.TEXT_DROPOUT = 0.0
    b = synthetic_caption_batch(c, batch=2, image_hw=hw, num_labels=40, k_shot=5, seed=seed + 3)
    rng = np.random.default_rng(seed + 3)
    g_max = 8
    boxes = np.zeros((2, g_max, 4), np.float32)
    labels = rng.integers(0, 40, (2, g_max))
    for i in range(2):
        xy = rng.uniform(0, 160, (g_max, 2))
        boxes[i] = np.concatenate([xy, xy + rng.uniform(24, 96, (g_max, 2))], 1).clip(0, 255)
    batch = {k: b[k] for k in ("images", "input_ids", "attention_mask", "queries", "query_mask")}
    batch.update(gt_boxes=boxes, gt_labels=(labels + 1).astype(np.int32), gt_valid=np.ones((2, g_max), bool),
                 gt_token_map=np.take_along_axis(b["agg_map"], labels[..., None], 1).astype(np.float32),
                 pos_category_map=(b["agg_map"] > 0).astype(np.float32), has_query=np.ones((2, 40), np.int32),
                 image_sizes=np.array([hw, hw], np.float32))

    def step(model, dev, scale=1.0, assignment=None):
        state, tx = init_train_state(model, c, trainable_patterns(c))
        run = make_gdino_train_step(model, tx, c)
        inputs = dict(batch, images=(batch["images"] * np.float32(scale)).astype(np.float32))
        _, metrics = run(state, batch_to_device(inputs, dev), torch.Generator(device=dev).manual_seed(seed),
                         assignment=assignment)
        params = dict(model.named_parameters())
        return float(metrics["loss_total"]), {n: params[n].grad.float().cpu() for n in state.trainable}, run.assignment

    t0 = time.perf_counter()
    scales = (1.0, 1.0 + 1e-3, 1.0 - 1e-3)
    cpu = torch.device("cpu")
    with switched("default", msda="pallas_interpret"):
        first = step(dropout_off(copy.deepcopy(model_cpu)), cpu)
        fixed = first[2]
        ref32 = {s: first[:2] if s == 1.0 else step(dropout_off(copy.deepcopy(model_cpu)), cpu, s, fixed)[:2]
                 for s in scales}
        run16 = {s: step(dropout_off(copy.deepcopy(model_cpu).to(torch.bfloat16)), cpu, s, fixed)[:2]
                 for s in scales}
    cpu_s = time.perf_counter() - t0
    gpu = dropout_off(copy.deepcopy(model_cpu)).to("cuda", torch.bfloat16).to(memory_format=torch.channels_last)
    with switched("default"):
        own = step(gpu, torch.device("cuda"))[2]
        launch_counts(reset=True)
        card = step(gpu, torch.device("cuda"), assignment=fixed)[:2]
        used = launch_counts()
    del gpu
    g = cfg.GROUNDINGDINO
    want = predicted(ms_deform_attn_clip=g.enc_layers, ms_deform_attn=g.dec_layers)
    if used != want:
        fail(f"phase 9 reference step: launches {used} != predicted {want}")
    flips = int((own != fixed).sum())
    reference_verdict(torch, "phase 9", f"MQ-GroundingDINO-T full width at {hw}, MSDA clipped on both sides", card,
                      ref32, run16, scales,
                      f"every run on the fp32 run's assignment ({int((fixed >= 0).sum())} pairs over "
                      f"{fixed.shape[0]} decoder layers); the card's own matcher would choose {flips} of them "
                      f"differently; CPU steps {cpu_s!r} s; launches {({k: v for k, v in used.items() if v})}",
                      bounds)
    return used


def phase_msda_backward(torch, seed, smi):
    """The MSDA Function's backward on the card (bf16 value, fp32 locations
    and weights saved; the exact composite's fp32 VJP recomputed from them)
    against `ms_deform_attn_vjp` in fp32 on the same inputs, at the 800x1344
    pyramid, B = 2: encoder queries (Q = S = 22323) on the clipped forward
    with locations 12 cells around their own cell (most points past their
    windows: the backward takes them unclipped) and decoder queries (Q =
    900) on the exact forward; every gradient within ERR_BOUND * max|ref|.
    Returns {case: backward ms} (CUDA events: forward + backward minus
    forward, median of 5)."""
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.ops import ms_deform_attn as ms
    from mqdet_torch.tools import cuda_time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    shapes = GDINO_800
    s = sum(h * w for h, w in shapes)
    nh, hd, p = 8, 32, 4
    times = {}
    for name, q in (("encoder, clipped forward", None), ("decoder, exact forward", 900)):
        value = torch.randn(2, s, nh, hd, generator=g, device=dev).bfloat16()
        if q is None:
            q = s
            ref = torch.cat([
                torch.stack(torch.meshgrid((torch.arange(w, device=dev) + 0.5) / w,
                                           (torch.arange(h, device=dev) + 0.5) / h, indexing="xy"), -1)
                .reshape(-1, 2) for h, w in shapes
            ])
            wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
            off = torch.randn(2, q, nh, len(shapes), p, 2, generator=g, device=dev) * 12.0
            loc = ref[None, :, None, None, None, :] + off / wh[None, None, None, :, None, :]
            where = f"own cell + N(0, 12 cells), the clip moves {clip_share(torch, shapes, loc)!r} of the points"
        else:
            loc = torch.rand(2, q, nh, len(shapes), p, 2, generator=g, device=dev) * 1.4 - 0.2
            where = "uniform in [-0.2, 1.2)"
        attn = torch.rand(2, q, nh, len(shapes), p, generator=g, device=dev)
        attn = attn / attn.sum(dim=(3, 4), keepdim=True)
        gout = torch.randn(2, q, nh * hd, generator=g, device=dev).bfloat16()
        with switched("default"):
            leaves = [t.clone().requires_grad_(True) for t in (value, loc, attn)]
            launch_counts(reset=True)
            y = ms.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
            counts = {k: v for k, v in launch_counts().items() if v}
            y.backward(gout)
            refs = ms.ms_deform_attn_vjp(value.float(), shapes, loc, attn, gout.float())
            errs = []
            for label, leaf, r in zip(("value", "loc", "attn"), leaves, refs):
                err, scale = max_err(leaf.grad, r)
                errs.append((label, err / max(scale, 1e-30)))
                if not (bool(torch.isfinite(leaf.grad).all()) and err <= ERR_BOUND * scale):
                    fail(f"phase 9: MSDA backward, {name}: {label} gradient err {err!r} > {ERR_BOUND} * max|ref| "
                         f"{scale!r}")
            del leaves, y, refs

            def once():
                ins = [t.clone().requires_grad_(True) for t in (value, loc, attn)]
                ms.ms_deform_attn(ins[0], shapes, ins[1], ins[2]).backward(gout)

            fwd_ms = cuda_time_ms(lambda: ms.ms_deform_attn(value, shapes, loc, attn), iters=5, warmup=1)
            times[name] = cuda_time_ms(once, iters=5, warmup=1) - fwd_ms
        say(f"phase 9: MSDA backward, the Function at value {(2, s, nh, hd)} Q {q} ({name}; locations {where}; "
            f"launches {counts}): gradients against the fp32 exact VJP, max err / max|ref| "
            f"{', '.join(f'{k} {v!r}' for k, v in errs)} (bound {ERR_BOUND}); backward {times[name]!r} ms, forward "
            f"{fwd_ms!r} ms (CUDA events, median of 5; {smi}); ok")
        del value, loc, attn, gout
        torch.cuda.empty_cache()
    return times


def phase_train_gdino(torch, seed, dataset, bank, smi, bounds=None):
    """Phase 9: MQ-GroundingDINO-T modulated pre-training at full width on
    the card (`train_config_gdino`) on phase 7's dataset and phase 7's
    extracted MQ-GroundingDINO-T bank: the reference step, the MSDA
    Function's backward, then `train_steps` (6 clipped + 6 exact MSDA
    launches a forward, no bi-attention kernel: the fusion's training
    composite). Returns the launch counts of the timed steps; `bounds`, a
    dict, receives the reference step's bounds."""
    from mqdet_torch.utils.builders import build_model, init_params, landscape

    cfg = train_config_gdino()
    model_cpu = init_params(build_model(cfg), seed=seed)
    phase_train_reference_gdino(torch, cfg, model_cpu, seed, bounds)
    bwd_ms = phase_msda_backward(torch, seed, smi)
    g = cfg.GROUNDINGDINO
    return train_steps(torch, "phase 9", "MQ-GroundingDINO-T", cfg, model_cpu, landscape(dataset), bank,
                       smi,
                       predicted(ms_deform_attn_clip=g.enc_layers, ms_deform_attn=g.dec_layers),
                       "msda_backward", "`MSDeformAttnFunction`", ("msda_band_kernel", "msda_forward_kernel"),
                       f"one MSDA backward alone (CUDA events) {bwd_ms}")


def merge_shipped_configs():
    """Phase 10, first: every yaml under configs/ merged into the port's
    default tree by its own reader (this machine has no PyYAML). Returns
    (count, seconds)."""
    import glob

    from mqdet_torch.core.config import default_config

    paths = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
    t0 = time.perf_counter()
    for path in paths:
        default_config().merge_from_file(path)
    return len(paths), time.perf_counter() - t0


def save_reference_pth(torch, model, path):
    """The model's weights as a reference-layout .pth: its state dict (the
    reference's key names) under DataParallel's `module.` prefix, in a
    DetectronCheckpointer-like {"model": ...} file."""
    torch.save({"model": {f"module.{k}": v for k, v in model.state_dict().items()}, "iteration": 0}, path)
    return path


def synthetic_voc(root, seed):
    """A PascalVOC-format dataset of 2 images written from `seed` (XML
    annotations of 2-4 objects, ImageSets/Main/test.txt); `load_image` serves
    seeded pixels (this machine has no PIL)."""
    import xml.etree.ElementTree as ET

    import numpy as np

    from mqdet_torch.data.datasets_extra import VOC_CLASSES, PascalVOCDataset

    rng = np.random.default_rng(seed + 11)
    for d in ("Annotations", "ImageSets/Main"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    sizes = {"voc0": (375, 500), "voc1": (333, 500)}
    for name, (h, w) in sizes.items():
        ann = ET.Element("annotation")
        for _ in range(int(rng.integers(2, 5))):
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = VOC_CLASSES[1 + int(rng.integers(0, 20))]
            ET.SubElement(obj, "difficult").text = "0"
            bb = ET.SubElement(obj, "bndbox")
            x0, y0 = rng.uniform(1, w * 0.5), rng.uniform(1, h * 0.5)
            corners = (("xmin", x0), ("ymin", y0), ("xmax", rng.uniform(x0 + 20, w)), ("ymax", rng.uniform(y0 + 20, h)))
            for k, v in corners:
                ET.SubElement(bb, k).text = f"{v:.1f}"
        ET.ElementTree(ann).write(os.path.join(root, "Annotations", f"{name}.xml"))
    with open(os.path.join(root, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(sizes) + "\n")

    class SeededVOC(PascalVOCDataset):
        def load_image(self, img_id):
            return seeded_pixels(seed, sum(map(ord, img_id)), *sizes[img_id])

    return SeededVOC(root, "test")


def synthetic_grounding(root, seed):
    """A phrase-grounding (ModulatedDataset) json of 2 images from `seed`:
    per image a caption and per box the character span of its phrase;
    `load_image` serves seeded pixels."""
    import numpy as np

    from mqdet_torch.data.datasets_extra import GroundingCaptionDataset

    rng = np.random.default_rng(seed + 13)
    captions = ["a brown dog chases a red ball across the grass", "two people ride bicycles past a parked car"]
    phrases = [["a brown dog", "a red ball", "the grass"], ["two people", "bicycles", "a parked car"]]
    images, anns = [], []
    for i, (cap, ph) in enumerate(zip(captions, phrases)):
        h, w = 480, 640
        images.append({"id": i + 1, "file_name": f"{i + 1}.jpg", "height": h, "width": w, "caption": cap})
        for p in ph:
            beg = cap.index(p)
            for _ in range(int(rng.integers(1, 3))):
                x0, y0 = rng.uniform(0, w * 0.6), rng.uniform(0, h * 0.6)
                anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": 1, "iscrowd": 0,
                             "bbox": [x0, y0, rng.uniform(20, w - x0), rng.uniform(20, h - y0)],
                             "tokens_positive": [[beg, beg + len(p)]]})
    path = os.path.join(root, "grounding_synthetic.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [{"id": 1, "name": "object"}]}, f)

    class SeededGrounding(GroundingCaptionDataset):
        def load_image(self, img_id):
            im = self.images[img_id]
            return seeded_pixels(seed, 100 + img_id, im["height"], im["width"])

    return SeededGrounding(path, root)


def seeded_pixels(seed, key, h, w):
    """uint8 (h, w, 3) smooth noise from (seed, key), as phase 7's images."""
    import torch

    g = torch.Generator().manual_seed(seed * 1000 + key)
    low = torch.rand(1, 3, max(1, h // 32), max(1, w // 32), generator=g) * 255.0
    img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear")
    return img[0].permute(1, 2, 0).round().to(torch.uint8).numpy()


def phase_cli(torch, label, cfg, seed, keep, per_image, per_group, root, smi, configs, other_styles=False,
              yamls=None, weights=None, phase="phase 10"):
    """Phase 10, per model: the evaluation CLI's body
    (`mqdet_torch.tools.eval.evaluate`) on the shipped
    configs/vision_query_5shot yaml of the family, with the overrides a user
    passes (DATA_ROOT, QUERY_BANK_PATH, MODEL.WEIGHT) and those that give it
    phase 7's settings (thresholds 0; MQ-GLIP-T's NUM_CLASSES 81, the saved
    classifier's; GDINO's bucket 800x1344, the port's); the weights: phase 7's
    model (init_params(seed) again) saved as a reference-layout .pth; the
    bank: phase 7's, saved and read back; the dataset: phase 7's. Gates: the
    import report (0 missing, 0 unused), the AP fields and every image's
    detections (boxes, scores, labels) equal to phase 7's `run_inference`,
    bitwise, the launches (phase 7's), bbox.csv written. `per_image`: the predicted launches of one image's
    head groups; `per_group`: of one group; `configs`: (count, seconds) of
    the shipped configs' merge. With `other_styles`, the VOC and
    phrase-grounding styles on 2 synthetic images each, their launches
    predicted (one head group an image). `yamls` (config file, task
    config) replaces the family's shipped yaml; `weights`, a model of `cfg`
    on the CPU, is the model saved (and a copy of it is what `evaluate`
    imports into) instead of a fresh init_params(seed). Returns the launch
    counts by path."""
    import argparse

    import numpy as np

    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.tools.eval import evaluate
    from mqdet_torch.tools.train import load_config
    from mqdet_torch.utils.builders import build_model, init_params

    gdino = cfg.GROUNDINGDINO.enabled
    yml, task_yml = yamls or (os.path.join(REPO, "configs", "vision_query_5shot",
                                           "lvis_minival_groundingdino-T.yaml" if gdino else "lvis_minival.yaml"), None)
    ds, bank, want_res = keep["dataset"], keep["bank"], keep["results"]
    tag = label.lower().replace("-", "_")
    t0 = time.perf_counter()
    saved = weights if weights is not None else init_params(build_model(cfg), seed=seed)
    weight = save_reference_pth(torch, saved, os.path.join(root, f"{tag}.pth"))
    keep["weight"] = weight
    bank_path = os.path.join(root, f"{tag}_bank.npz")
    bank.save(bank_path)
    save_s = time.perf_counter() - t0
    opts = ["DATASETS.DATA_ROOT", root, "VISION_QUERY.QUERY_BANK_PATH", bank_path, "MODEL.WEIGHT", weight,
            "OUTPUT_DIR", os.path.join(root, f"{tag}_out")]
    opts += (["GROUNDINGDINO.box_threshold", "0.0", "TPU.IMAGE_BUCKETS", "[[800, 1344]]"] if gdino else
             ["MODEL.ATSS.INFERENCE_TH", "0.0", "MODEL.DYHEAD.NUM_CLASSES", "81"])
    t0 = time.perf_counter()
    c = load_config(argparse.Namespace(config_file=yml, task_config=task_yml, additional_model_config=None,
                                       opts=opts))
    config_s = time.perf_counter() - t0
    tok = WordPieceTokenizer()  # phase 7's: the hash vocab
    n_img = len(ds.ids)
    from mqdet_torch.engine import eval_dispatch
    from mqdet_torch.engine.evaluator import DetectionEvaluator

    class Recording(DetectionEvaluator):
        dets = {}

        def add_image(self, image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **kw):
            self.dets[image_id] = (det_boxes.copy(), det_scores.copy(), det_labels.copy())
            super().add_image(image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **kw)

    record = {}
    torch.cuda.synchronize()
    launch_counts(reset=True)
    build_evaluator = eval_dispatch.build_evaluator
    eval_dispatch.build_evaluator = lambda cfg_, style: Recording(style, max_dets=cfg_.MODEL.ATSS.DETECTIONS_PER_IMG)
    try:
        res = evaluate(c, dataset=ds, device="cuda", tokenizer=tok, log=lambda m: None, record=record,
                       model=copy.deepcopy(weights) if weights is not None else None)
    finally:
        eval_dispatch.build_evaluator = build_evaluator
    torch.cuda.synchronize()
    used = launch_counts()
    want_dets = keep["detections"]
    same_dets = set(Recording.dets) == set(want_dets) and all(
        all(np.array_equal(a, b) for a, b in zip(Recording.dets[i], want_dets[i])) for i in want_dets)
    n_dets = sum(len(d[1]) for d in Recording.dets.values())
    want = {k: v * n_img for k, v in per_image.items()}
    report = record["import_report"]
    keys = [k for k in ("AP", "AP50", "AP75", "APs", "APm", "APl", "APr", "APc", "APf") if k in res]
    differ = {k: (res[k], want_res.get(k)) for k in keys if not (res[k] == want_res.get(k)
                                                                  or (np.isnan(res[k]) and np.isnan(want_res.get(k))))}
    csv_path = os.path.join(c.OUTPUT_DIR, "bbox.csv")
    header = open(csv_path).readline().strip() if os.path.exists(csv_path) else None
    said_yml = os.path.relpath(yml, REPO) + (f" + {os.path.relpath(task_yml, REPO)}" if task_yml else "")
    say(f"{phase}: {label} through mqdet_torch.tools.eval.evaluate on {said_yml} with "
        f"{len(opts) // 2} overrides ({smi}): {configs[0]} shipped configs merged without PyYAML in "
        f"{configs[1]!r} s; this config in {config_s!r} s; weights and bank saved in {save_s!r} s; "
        f"seconds by stage {record['seconds']}; import report {len(report['matched'])} matched, "
        f"{len(report['missing'])} missing, {len(report['unused'])} unused; {res['images_per_second']!r} img/s over "
        f"{n_img} images (phase 7's run_inference {want_res['images_per_second']!r}); AP fields {keys} equal to "
        f"phase 7's: {not differ} {differ or ''}; {({k: res[k] for k in keys})}; {n_dets} detections, every "
        f"image's boxes, scores and labels bitwise phase 7's: {same_dets}; launches "
        f"{({k: v for k, v in used.items() if v})} (predicted {({k: v for k, v in want.items() if v})}); "
        f"bbox.csv header {header!r}")
    if report["missing"] or report["unused"]:
        fail(f"{label} CLI: import report missing {report['missing'][:5]}, unused {report['unused'][:5]}")
    if differ or not same_dets:
        fail(f"{label} CLI: AP fields {differ} or detections (equal: {same_dets}) differ from phase 7's run_inference")
    if used != want:
        fail(f"{label} CLI: launches {used} != predicted {want}")
    if header is None or not header.startswith("AP"):
        fail(f"{label} CLI: bbox.csv not written in {c.OUTPUT_DIR}")
    out = {f"{label} CLI lvis": used}
    if not other_styles:
        return out
    for style, make, name, metric in (("voc", synthetic_voc, "voc_synthetic", "mAP"),
                                      ("grounding", synthetic_grounding, "flickr_synthetic", "recall@1")):
        sub = os.path.join(root, style)
        os.makedirs(sub, exist_ok=True)
        sds = make(sub, seed)
        sc = c.clone()
        sc.DATASETS.TEST = (name,)
        sc.OUTPUT_DIR = os.path.join(root, f"{tag}_{style}_out")
        rec = {}
        torch.cuda.synchronize()
        launch_counts(reset=True)
        sres = evaluate(sc, dataset=sds, device="cuda", tokenizer=tok, log=lambda m: None, record=rec)
        torch.cuda.synchronize()
        sused = launch_counts()
        swant = {k: v * len(sds.ids) for k, v in per_group.items()}  # one head group an image
        vals = {k: v for k, v in sres.items() if not isinstance(v, dict)}
        say(f"phase 10: {label} {style} style on {len(sds.ids)} synthetic images ({smi}): "
            f"{sres['images_per_second']!r} img/s, seconds by stage {rec['seconds']}; {vals}; launches "
            f"{({k: v for k, v in sused.items() if v})} (predicted {({k: v for k, v in swant.items() if v})})")
        if sused != swant:
            fail(f"{label} CLI {style}: launches {sused} != predicted {swant}")
        if metric not in sres or not np.isfinite(sres[metric]):
            fail(f"{label} CLI {style}: {metric} missing or not finite: {vals}")
        out[f"{label} CLI {style}"] = sused
    return out


def train_config_l():
    """MQ-GLIP-L's training config through the port's config entry
    (`mqdet_torch.tools.train.load_config`): configs/pretrain/mq-glip-l.yaml
    (recipe vision_query, the default LRs and no EMA, text dropout 0.4, 5
    queries a class, the 800-1333 resize, RANDOM_SAMPLE_NEG -1) with phase
    8's cuts: batch 2 (the default 16 over 8 GPUs), warmup 0, MAX_ITER 1000."""
    from mqdet_torch.tools.train import load_config

    return load_config(argparse.Namespace(
        config_file=L_YAML, task_config=None, additional_model_config=None,
        opts=["SOLVER.IMS_PER_BATCH", "2", "SOLVER.WARMUP_ITERS", "0", "SOLVER.MAX_ITER", "1000"]))


def phase_remat_reference(torch, cfg, model_off, model_on, seed, smi):
    """Phase 11: one training step at 256x256 on the card (bf16, kernels),
    MQ-GLIP-L with TPU.REMAT off (run 5 times) and on, the same batch and
    generator seed, dropout on (text dropout, the fusion's attention
    dropout, stochastic depth). Gates: the REMAT step's loss within twice
    the spread of the plain runs (0: equal); the median over the trainable
    gradients of the REMAT step's median distance (relative L2) from the 5
    plain runs within twice the median of their largest pairwise
    distances; and every gradient's distance within twice its own spread,
    or 4 bf16 units in the last place (2^-5). The backward is not bitwise
    repeatable (the DCN VJP's scatter-adds, the bilinear upsampling's
    backward), and the REMAT graph sums the text layers' gradients in
    another order in bf16: a scalar gate's gradient, a sum with
    cancellation, sat 2 units from all 5 plain runs while they spread by
    0.7 units, and the median REMAT distance (0.0091) below the median
    plain spread (0.0120) (measured on one H100). A recompute that drew other
    dropout masks errs by order 1 (the CPU test's control: 2.9 of the
    gradient's largest value). Launches 104 `dcn_band` a plain step and 208
    a REMAT step (the recompute runs DyConv's forward again). Returns the
    REMAT step's launch counts."""
    from mqdet_torch.core.config import trainable_patterns
    from mqdet_torch.engine.train import batch_to_device, init_train_state, make_train_step
    from mqdet_torch.ops import launch_counts

    dev = torch.device("cuda")
    batch = batch_to_device(reference_batch(cfg, seed), dev)

    def step(model):
        state, tx = init_train_state(model, cfg, trainable_patterns(cfg))
        run = make_train_step(model, tx, cfg)
        torch.cuda.synchronize()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        _, metrics = run(state, batch, torch.Generator(device=dev).manual_seed(seed))
        loss = float(metrics["loss_total"])
        ms = (time.perf_counter() - t0) * 1000.0
        params = dict(model.named_parameters())
        return loss, {n: params[n].grad.float().clone() for n in state.trainable}, launch_counts(), ms

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))

    plain = [step(model_off) for _ in range(5)]
    l0, g0, u0, ms0 = plain[0]
    lr, gr, ur, msr = step(model_on)
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    per = stages * (3 * levels - 2)
    if u0 != predicted(dcn_band=per) or ur != predicted(dcn_band=2 * per):
        fail(f"phase 11 REMAT reference step: launches {u0} / {ur} != predicted {per} / {2 * per} dcn_band")
    grads = [p[1] for p in plain]
    pairs = [(a, b) for i, a in enumerate(grads) for b in grads[i + 1:]]
    rows = [(n, statistics.median(rel(gr[n], g[n]) for g in grads), max(rel(a[n], b[n]) for a, b in pairs))
            for n in g0]
    bound = lambda r: max(2 * r[2], 2.0 ** -5)  # noqa: E731
    bad = [r for r in rows if not r[1] <= bound(r)]
    worst = max(rows, key=lambda r: r[1] / bound(r))
    medians = (statistics.median(r[1] for r in rows), statistics.median(r[2] for r in rows))
    losses = [p[0] for p in plain]
    loss_ok = abs(lr - l0) <= 2 * (max(losses) - min(losses)) and medians[0] <= 2 * medians[1]
    say(f"phase 11: REMAT reference step, MQ-GLIP-L full width at (256, 256), batch 2, dropout on, one generator "
        f"seed ({smi}): loss REMAT {lr!r}, plain {losses}; {len(rows)} trainable gradients, "
        f"{sum(r[2] == 0.0 for r in rows)} bitwise equal across the plain runs, {sum(r[1] == 0.0 for r in rows)} "
        f"bitwise equal REMAT to plain; worst REMAT err / bound {worst[1] / bound(worst)!r} at {worst[0]} (REMAT "
        f"relative L2 {worst[1]!r}, plain spread {worst[2]!r}; bound max(2 * spread, 2^-5)); the median REMAT err "
        f"{medians[0]!r} and plain spread {medians[1]!r} (bound: twice the latter); launches plain "
        f"{({k: v for k, v in u0.items() if v})}, REMAT {({k: v for k, v in ur.items() if v})}; step {ms0!r} ms "
        f"plain, {msr!r} ms REMAT (first calls, host clock); {'ok' if loss_ok and not bad else 'FAIL'}")
    if not loss_ok or bad:
        fail(f"phase 11 REMAT reference step: loss {lr!r} vs {losses}; medians {medians}; {len(bad)} gradients "
             f"outside the bound, e.g. {bad[:3]}")
    return ur


def phase_glip_l(torch, seed, runs, smi, root, configs, keep):
    """Phase 11: MQ-GLIP-L at full width from init_params(seed), built once
    on the host: phase 3's reference check at 256x256 (default route), phase
    4's LVIS protocol with phases 5 and 6, phase 7's route (the GLIP-L bank
    extracted, run_inference, the online update), the evaluation CLI on
    mq-glip-l.yaml + lvis_minival_L.yaml (phase 10's overrides, the model
    saved as a reference .pth), then modulated pre-training with
    mq-glip-l.yaml's settings, REMAT off and on (the reference step, then
    `train_steps` for each; the REMAT peak must be below the plain one).
    Returns the launch counts by path; `keep` receives the model on the CPU,
    the .pth and phase 7's dataset."""
    from mqdet_torch.utils.builders import build_model, init_params, landscape, mq_glip_l_config, synthetic_batch

    dev = torch.device("cuda")
    cfg = mq_glip_l_config()
    cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 300
    t0 = time.perf_counter()
    model_cpu = init_params(build_model(cfg), seed=seed).eval()
    n_params = sum(p.numel() for p in model_cpu.parameters())
    say(f"phase 11: MQ-GLIP-L (Swin-L 192, depths {tuple(cfg.MODEL.SWINT.DEPTHS)}, window "
        f"{cfg.MODEL.SWINT.WINDOW_SIZE}, {cfg.MODEL.DYHEAD.NUM_CONVS} head stages) built from init_params({seed}) "
        f"in {time.perf_counter() - t0!r} s (host): {n_params} parameters")
    model = copy.deepcopy(model_cpu).to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    launches = phase_reference_glip(torch, cfg, model_cpu, model, seed, "MQ-GLIP-L", [("default", None)])

    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    groups = -(-31 // 4)
    per_image = predicted(dcn_band=groups * stages * (3 * levels - 2), bi_attention=groups * stages)  # 832, 64
    tower = model.rpn.head.dyhead_tower
    parts = {"image tower": [model.backbone.body, model.backbone.fpn], "language tower": [model.language_backbone],
             "VLFuse": list(tower[0::3]), "head BERT layers": list(tower[1::3]), "DyConv": list(tower[2::3])}
    launches["MQ-GLIP-L default"] = phase_protocol(torch, "MQ-GLIP-L", model, cfg, synthetic_batch, 300, per_image,
                                                   runs, seed, parts)
    vq = {}
    launches.update(phase_vision_query(torch, "MQ-GLIP-L", cfg, model, seed, per_image, root, 300, vq, "phase 11"))
    del model, tower, parts
    torch.cuda.empty_cache()
    launches.update(phase_cli(torch, "MQ-GLIP-L", cfg, seed, vq, per_image, None, root, smi, configs,
                              yamls=(L_YAML, LVIS_L_YAML), weights=model_cpu, phase="phase 11"))
    torch.cuda.empty_cache()

    tcfg = train_config_l()
    rcfg = tcfg.clone()
    rcfg.TPU.REMAT = True
    model_on = build_model(rcfg)
    model_on.load_state_dict(model_cpu.state_dict())
    off_gpu = copy.deepcopy(model_cpu).to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    on_gpu = copy.deepcopy(model_on).to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    launches["MQ-GLIP-L REMAT reference step"] = phase_remat_reference(torch, tcfg, off_gpu, on_gpu, seed, smi)
    del off_gpu, on_gpu
    torch.cuda.empty_cache()
    per_step = stages * (3 * levels - 2)
    runs_out = {}
    for remat in (False, True):
        run_model = model_on if remat else copy.deepcopy(model_cpu)  # build_training moves it to the card
        out = runs_out[remat] = {}
        launches[f"MQ-GLIP-L training{' REMAT' if remat else ''}"] = train_steps(
            torch, "phase 11", f"MQ-GLIP-L (TPU.REMAT {remat})", rcfg if remat else tcfg, run_model,
            landscape(vq["dataset"]), vq["bank"], smi, predicted(dcn_band=per_step * (2 if remat else 1)),
            "dcn_backward", "`DeformConvFunction`", ("dcn_band_kernel",),
            "the DCN forward runs twice a step under REMAT" if remat else "REMAT off", out=out)
        del run_model
        torch.cuda.empty_cache()
    del model_on
    off, on = runs_out[False], runs_out[True]
    say(f"phase 11: MQ-GLIP-L training, TPU.REMAT off / on ({smi}): {off['ms']!r} / {on['ms']!r} ms per step, "
        f"{2000.0 / off['ms']!r} / {2000.0 / on['ms']!r} train img/s, peak {off['peak']!r} / {on['peak']!r} GiB")
    if not on["peak"] < off["peak"]:
        fail(f"phase 11: the REMAT peak {on['peak']!r} GiB is not below the plain peak {off['peak']!r} GiB")
    keep.update(model_cpu=model_cpu, weight=vq["weight"], per_step=per_step, stages=stages)
    return launches


def phase_finetune(torch, seed, keep, root, smi):
    """Phase 12: few-shot finetuning, `mqdet_torch.tools.finetune.main` in
    process at MQ-GLIP-L full width on an ODinW-shaped task written from the
    seed: 2 categories renamed through OVERRIDE_CATEGORY, 4 train images (one
    category each) and 2 val images (COCO json; seeded pixels, this machine
    has no PIL), a task yaml with an odinw_13 task's keys and odinw.yaml's
    settings (QUERY_BANK_PATH "", so the bank is extracted), over
    configs/pretrain/mq-glip-l.yaml; shot 1, 1 epoch, copies 1, phase 11's
    .pth as --weight (NUM_CLASSES 81, its classifier's; thresholds 0; batch
    2, warmup 0). The model is a copy of phase 11's (`model_fn`: the import
    overwrites every weight). Gates: main returns (rc 0); the temporary bank
    holds exactly the 2 classes; the AP lines printed and finite; the
    launches equal the prediction from the step count and the evaluations
    (104 `dcn_band` a step; 104 `dcn_band` + 8 `bi_attention` per val image
    and head group). Returns the launch counts."""
    import io

    import numpy as np

    from mqdet_torch.core import yaml_lite
    from mqdet_torch.engine.inference import ChunkedEvaluationPlan, chunk_groups
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.tools import finetune as ft
    from mqdet_torch.tools.train import build_dataset

    rng = np.random.default_rng(seed + 17)
    raw = [{"id": 1, "name": "raw_a"}, {"id": 2, "name": "raw_b"}]
    override = [{"id": 1, "name": "fish", "supercategory": "creatures"},
                {"id": 2, "name": "shark", "supercategory": "creatures"}]
    register = {}
    for split, labels in (("train", [1, 2, 1, 2]), ("valid", [1, 2])):
        images, anns = [], []
        for i, lab in enumerate(labels):
            h, w = 480, 640
            images.append({"id": i + 1, "file_name": f"{split}{i}.jpg", "height": h, "width": w})
            for _ in range(int(rng.integers(1, 3))):
                bw, bh = rng.uniform(40, w * 0.5), rng.uniform(40, h * 0.5)
                x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                anns.append({"id": len(anns) + 1, "image_id": i + 1, "category_id": lab, "bbox": [x0, y0, bw, bh],
                             "area": bw * bh, "iscrowd": 0})
        path = os.path.join(root, f"odinw_{split}.json")
        with open(path, "w") as f:
            json.dump({"images": images, "annotations": anns, "categories": raw}, f)
        register["train" if split == "train" else "val"] = {"ann_file": os.path.basename(path), "img_dir": "."}
    task = {  # an odinw_13 task's keys and configs/vision_query_5shot/odinw.yaml's settings
        "DATASETS": {"GENERAL_COPY": 16, "OVERRIDE_CATEGORY": json.dumps(override), "USE_OVERRIDE_CATEGORY": True,
                     "REGISTER": register, "TRAIN": ["train"], "TEST": ["val"], "FEW_SHOT": 5},
        "MODEL": {"ATSS": {"NUM_CLASSES": 3}, "DYHEAD": {"NUM_CLASSES": 3}},
        "SOLVER": {"AUTOTERMINATE_PATIENCE": 8, "MAX_EPOCH": 12, "TEST_WITH_INFERENCE": True, "USE_AUTOSTEP": True,
                   "WEIGHT_DECAY": 0.05},
        "VISION_QUERY": {"ENABLED": True, "DATASET_NAME": "Fishes", "NUM_QUERY_PER_CLASS": 5,
                         "QUERY_BANK_PATH": "", "TEXT_DROPOUT": 0.0},
        "TPU": {"IMAGE_BUCKETS": [[800, 1344]]},
    }
    task_yml = os.path.join(root, "Fishes.yaml")
    with open(task_yml, "w") as f:
        f.write(yaml_lite.dump(task))
    argv = ["--config-file", L_YAML, "--ft-tasks", task_yml, "--custom_shot_and_epoch_and_general_copy", "1_1_1",
            "--weight", keep["weight"], "--seeds", "0", "--device", "cuda",
            "DATASETS.DATA_ROOT", root, "MODEL.DYHEAD.NUM_CLASSES", "81", "MODEL.ATSS.NUM_CLASSES", "81",
            "MODEL.ATSS.INFERENCE_TH", "0.0", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.WARMUP_ITERS", "0",
            "OUTPUT_DIR", os.path.join(root, "finetune_out")]

    def dataset_fn(cfg, name, train):
        ds = build_dataset(cfg, name, train)
        ds.load_image = lambda img_id: seeded_pixels(seed, 300 + 10 * int(train) + img_id, *ds.image_size(img_id))
        return ds

    seen = {"banks": [], "evals": [], "states": []}
    real = {k: getattr(ft, k) for k in ("extract_queries_into_bank", "run_inference", "do_train")}

    def extract(*a, **kw):
        seen["banks"].append(real["extract_queries_into_bank"](*a, **kw))
        return seen["banks"][-1]

    def run_inference(cfg, model, dataset, tokenizer, selector, **kw):
        seen["evals"].append((cfg, dataset, tokenizer, selector))
        return real["run_inference"](cfg, model, dataset, tokenizer, selector, **kw)

    def do_train(*a, **kw):
        state, best = real["do_train"](*a, **kw)
        seen["states"].append(state)
        return state, best

    printed = io.StringIO()
    torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    ft.extract_queries_into_bank, ft.run_inference, ft.do_train = extract, run_inference, do_train
    try:
        with contextlib.redirect_stdout(printed):
            results = ft.main(argv, model_fn=lambda cfg: copy.deepcopy(keep["model_cpu"]), dataset_fn=dataset_fn,
                              log=lambda m: None)
    except Exception as exc:  # noqa: BLE001 - the phase fails with the CLI's error
        fail(f"phase 12: mqdet_torch.tools.finetune.main raised {type(exc).__name__}: {exc}")
    finally:
        ft.extract_queries_into_bank, ft.run_inference, ft.do_train = (
            real["extract_queries_into_bank"], real["run_inference"], real["do_train"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    used = launch_counts()
    lines = [l for l in printed.getvalue().splitlines() if l.startswith("[finetune]")]
    steps = sum(st.step for st in seen["states"])
    images_groups = 0
    for cfg, ds, tok, sel in seen["evals"]:
        plan = ChunkedEvaluationPlan(cfg, ds, tok, sel)
        images_groups += len(ds.ids) * len(chunk_groups(plan, max(1, cfg.TEST.CHUNK_PARALLELISM)))
    per_step = keep["per_step"]  # a forward's DCN calls: one training step's, one head group's
    want = predicted(dcn_band=per_step * (steps + images_groups), bi_attention=keep["stages"] * images_groups)
    banks = [sorted(b.labels) for b in seen["banks"]]
    aps = [float(l.rsplit("AP=", 1)[1]) for l in lines if "AP=" in l]
    say(f"phase 12: MQ-GLIP-L few-shot finetuning through mqdet_torch.tools.finetune.main (shot 1, 1 epoch, "
        f"copies 1; {smi}): {seconds!r} s; {steps} training steps, {len(seen['evals'])} evaluations over "
        f"{images_groups} val image-groups; temporary bank classes {banks}; printed {lines}; launches "
        f"{({k: v for k, v in used.items() if v})} (predicted {({k: v for k, v in want.items() if v})})")
    if list(results) != [(task_yml, 0)] or not lines:
        fail(f"phase 12: finetune returned {results} and printed {lines}")
    if banks != [[1, 2]]:
        fail(f"phase 12: the temporary bank's classes {banks} != [[1, 2]]")
    if not aps or not all(np.isfinite(a) for a in aps):
        fail(f"phase 12: AP lines missing or not finite: {lines}")
    if used != want:
        fail(f"phase 12: launches {used} != predicted {want}")
    return used


# ---- phase 13: data parallel on the one card -------------------------------

DP_RANKS = 2            # phase 13's ranks, sharing the one card over gloo
DP_RANK_TIMEOUT_S = 600  # each rank process
DP_GLOO_TIMEOUT_S = 300  # a collective that waits longer raises


def digest(tensors) -> str:
    """sha1 of the tensors' bytes in name order (fp32)."""
    import hashlib

    h = hashlib.sha1()
    for n in sorted(tensors):
        h.update(n.encode())
        h.update(tensors[n].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_step(torch, cfg, model_cpu, dev):
    """(model, state, step) as the train entry builds them
    (`tools.train.build_training`) for a copy of `model_cpu`, dropout off:
    N ranks then draw what one process draws."""
    from mqdet_torch.core.config import frozen_patterns, trainable_patterns
    from mqdet_torch.engine.train import init_train_state, make_gdino_train_step, make_train_step

    dtype = getattr(torch, cfg.TPU.COMPUTE_DTYPE)
    model = dropout_off(copy.deepcopy(model_cpu)).to(dev, dtype).to(memory_format=torch.channels_last)
    state, tx = init_train_state(model, cfg, trainable_patterns(cfg), frozen_patterns(cfg))
    step = (make_gdino_train_step if cfg.GROUNDINGDINO.enabled else make_train_step)(model, tx, cfg)
    return model, state, step


def dp_train(torch, cfg, model_cpu, batches, dev, rank=0, world=1, assignment=None, save=None, timing=False):
    """The steps of `dp_step` on this rank's rows of the global `batches`
    (numpy), each on `step_generator(seed, iteration)`; `assignment` (L, B,
    G) fixes the GDINO matching (the rank's rows). Returns per step the
    summed metrics and the masters' digest; the peak memory, the launches,
    whether the frozen parameters are bitwise unchanged, the matching of a
    GDINO step. With `save`, a path prefix, the initial masters go to
    `{save}init.pt` and each step's gradients and masters to `{save}{it}.pt`,
    on the CPU. With `timing`, two more steps
    on the last batch: one warm (`warm_ms`, host clock, synchronised), one
    split at its boundaries (`times`). No profile: a trace of one process
    cannot give the card's idle share under two contexts (its kernels'
    spans include the other context's time slices: two ranks' busy
    summed came to more than their window)."""
    from mqdet_torch.engine.train import batch_to_device, step_generator
    from mqdet_torch.ops import launch_counts

    model, state, step = dp_step(torch, cfg, model_cpu, dev)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n in state.frozen}
    b = len(batches[0]["images"]) // world
    kw = {} if assignment is None else {"assignment": assignment[:, rank * b:(rank + 1) * b]}
    out = {"metrics": [], "digest": []}

    def run(it, gb, times=None, grads=None):
        rows = {k: v[rank * b:(rank + 1) * b] for k, v in gb.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, batch_to_device(rows, dev), step_generator(cfg.SOLVER.SEED, it, dev), times,
                          grads_out=grads, **kw)
        values = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        return values, (time.perf_counter() - t0) * 1000.0

    if save:
        torch.save({n: t.cpu() for n, t in state.trainable.items()}, f"{save}init.pt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    for it, gb in enumerate(batches):
        grads = {}
        values, _ = run(it, gb, grads=grads)
        out["metrics"].append(values)
        out["digest"].append(digest(state.trainable))
        if save:
            torch.save({"grads": {n: g.cpu() for n, g in grads.items()},
                        "masters": {n: t.cpu() for n, t in state.trainable.items()}}, f"{save}{it}.pt")
    out["launches"] = launch_counts()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    params = dict(model.named_parameters())
    out["frozen_same"] = all(torch.equal(params[n], t) for n, t in frozen.items())
    out["assignment"] = getattr(step, "assignment", None)
    if timing:
        out["warm_ms"] = run(len(batches), batches[-1])[1]
        out["times"] = {}
        run(len(batches) + 1, batches[-1], out["times"])
    return out


def dp_eval_model(torch, seed, dev):
    """Phase 7's MQ-GLIP-T on the card (bf16, channels last) and its config."""
    from mqdet_torch.utils.builders import build_model, init_params, mq_glip_t_config

    cfg = mq_glip_t_config()
    cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 300
    model = init_params(build_model(cfg), seed=seed).eval()
    return cfg, model.to(dev, torch.bfloat16).to(memory_format=torch.channels_last)


def rank_part_train(torch, spec, dev, rank, world, name):
    """A rank's training part: `name` glip (phase 8's recipe) or gdino
    (phase 9's), on the global batches the parent saved."""
    import numpy as np

    from mqdet_torch.utils.builders import build_model, init_params, mq_glip_t_pretrain_config

    cfg = mq_glip_t_pretrain_config() if name == "glip" else train_config_gdino()
    model_cpu = init_params(build_model(cfg), seed=spec["seed"])
    batches = torch.load(spec[f"{name}_batches"], weights_only=False)[:spec.get("steps", 99)]
    assignment = np.load(spec["gdino_assignment"]) if name == "gdino" else None
    save = os.path.join(spec["dir"], f"{spec['tag']}_{name}_rank0_step") if rank == 0 else None
    return dp_train(torch, cfg, model_cpu, batches, dev, rank, world, assignment, save, timing=spec["timing"])


def rank_part_eval(torch, spec, dev, rank, world):
    """A rank's evaluation and extraction part: `run_inference` over its
    shard of phase 7's dataset with phase 7's bank (the evaluators merged),
    then `extract_bank` over its shard (the banks merged, rank 0 saving)."""
    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.engine.evaluator import DetectionEvaluator
    from mqdet_torch.engine.inference import run_inference
    from mqdet_torch.mq.bank import QueryBank
    from mqdet_torch.mq.selector import QuerySelector
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.tools.train import extract_bank
    from mqdet_torch.utils.builders import synthetic_lvis

    cfg, model = dp_eval_model(torch, spec["seed"], dev)
    c = vq_settings(cfg)
    root = os.path.join(spec["dir"], f"{spec['tag']}_rank{rank}_data")  # the parent removes spec["dir"]
    os.makedirs(root)
    ds, freq = synthetic_lvis(root, spec["seed"])

    class Recording(DetectionEvaluator):
        def add_image(self, image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **kw):
            self.dets[image_id] = (det_boxes.copy(), det_scores.copy(), det_labels.copy())
            super().add_image(image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **kw)

    ev = Recording(style="lvis_fixed", max_dets=300, category_frequency=freq)
    ev.dets = {}
    selector = QuerySelector(QueryBank.load(spec["glip_bank"]), num_query_per_class=c.VISION_QUERY.NUM_QUERY_PER_CLASS,
                             max_labels=c.VISION_QUERY.MAX_CLASSES_PER_PROMPT)
    torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    res = run_inference(c, model, ds, WordPieceTokenizer(), selector, evaluator=ev, verbose=False)
    torch.cuda.synchronize()
    out = {"eval_s": time.perf_counter() - t0, "eval_launches": launch_counts(), "dets": ev.dets,
           "results": {k: v for k, v in res.items() if k != "seconds"}, "stages": res["seconds"]}

    c.VISION_QUERY.QUERY_BANK_SAVE_PATH = spec["bank_path"]
    own, saves = {}, []
    real_save, real_merge = QueryBank.save, QueryBank.allgather_merge

    def save(bank, path):
        saves.append(path)
        real_save(bank, path)

    def merge(bank, capacity=None):
        own.update({k: v.copy() for k, v in bank._store.items()})
        real_merge(bank, capacity)

    QueryBank.save, QueryBank.allgather_merge = save, merge
    launch_counts(reset=True)
    t0 = time.perf_counter()
    try:
        extract_bank(c, model, ds, dev, log=lambda m: None)
    finally:
        QueryBank.save, QueryBank.allgather_merge = real_save, real_merge
    torch.cuda.synchronize()
    out.update(extract_s=time.perf_counter() - t0, extract_launches=launch_counts(), store=own, saves=saves,
               capacity=c.VISION_QUERY.MAX_QUERY_NUMBER)
    return out


def rank_worker(spec_path: str) -> int:
    """One rank of phase 13 (run as `chip_smoke.py --rank-worker SPEC`, with
    torchrun's variables in the environment): joins the group over the
    spec's backend, runs its parts, saves what they return."""
    import torch

    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mqdet_torch.parallel import comm

    dev = comm.init_distributed("cuda", spec["backend"], timeout_s=DP_GLOO_TIMEOUT_S)
    rank, world = comm.get_rank(), comm.get_world_size()
    say(f"rank {rank} of {world}: backend {torch.distributed.get_backend()} on {dev}")
    out = {"rank": rank, "world": world, "backend": torch.distributed.get_backend(), "seconds": {}}
    for part in spec["parts"]:
        t0 = time.perf_counter()
        if part == "eval":
            out[part] = rank_part_eval(torch, spec, dev, rank, world)
        else:
            out[part] = rank_part_train(torch, spec, dev, rank, world, part)
        out["seconds"][part] = time.perf_counter() - t0
        comm.synchronize()
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(spec["dir"], f"{spec['tag']}_rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def spawn_ranks(torch, spec, world, root):
    """Run `world` rank processes of this script over `spec` (RANK, WORLD_SIZE,
    MASTER_* on localhost; LOCAL_RANK 0, every rank on the one card, over
    gloo, and LOCAL_RANK r, a card a rank, over NCCL, which refuses two
    ranks on one device), each within DP_RANK_TIMEOUT_S; one failing ends
    the others and the run. Returns their results in rank order."""
    import socket
    import subprocess

    spec = dict(spec, dir=root)
    path = os.path.join(root, f"{spec['tag']}_spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world))
    logs = [open(os.path.join(root, f"{spec['tag']}_rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank-worker", path],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r if spec["backend"] == "nccl" else 0)),
                              cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    t0 = time.perf_counter()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.perf_counter() - t0 > DP_RANK_TIMEOUT_S:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[r].name) as f:
                tail = f.read()[-4000:]
            fail(f"phase 13 ({spec['tag']}): rank {r} of {world} exited {p.returncode} after "
                 f"{time.perf_counter() - t0!r} s:\n{tail}")
    return [torch.load(os.path.join(root, f"{spec['tag']}_rank{r}.pt"), weights_only=False) for r in range(world)]


def loader_batches(cfg, dataset, bank, n):
    """The first `n` global batches (numpy) of the train entry's loader over
    `dataset` with `bank`, one process (batch SOLVER.IMS_PER_BATCH), across
    epochs."""
    from mqdet_torch.data.loader import GroundingTrainLoader
    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.mq.selector import QuerySelector

    vq = cfg.VISION_QUERY
    selector = QuerySelector(bank, num_query_per_class=vq.NUM_QUERY_PER_CLASS, pure_text_rate=vq.PURE_TEXT_RATE,
                             random_kshot=vq.RANDOM_KSHOT, max_labels=vq.MAX_CLASSES_PER_PROMPT)
    loader = GroundingTrainLoader(dataset, cfg, WordPieceTokenizer(), selector)

    def epochs():
        while True:
            yield from loader

    it = epochs()
    batches = [next(it) for _ in range(n)]
    for b in batches:
        b.pop("num_positive")
    return batches


def dp_verdict(torch, label, ref, got, root, tag, name, bounds, smi):
    """Phase 13's training gates for `name` on the ranks' results `got`
    against the one-process steps `ref` on the same global batches, per
    step: the summed loss, the summed gradients (each, and concatenated)
    and the masters' update from the initial masters (concatenated), each
    within the larger of its reference bound (`bounds`: phase 8's (9's),
    twice the largest of three CPU bf16 drifts at 256x256; E2E_FLOOR where
    `bounds` has none, as for the update) and twice the card's own bf16
    noise at these shapes (`ref["noise"]`: the one process on the images
    scaled by 1 +- 1e-3; GDINO's two-stage top-900 selection may flip
    under bf16 rounding at 800x1344, a noise the 256x256 bound does not
    see); the ranks' masters bitwise equal; the frozen parameters unchanged
    on every rank. A step that moved no master is 1 from the one process's
    update. Each tensor's update is printed against the one process's,
    ungated: the first Adam steps move an element by about lr *
    sign(gradient), so a zero-initialised bias whose small gradients flip
    sign under bf16 noise differs by up to 2 lr there (the one process's
    own step is not bitwise repeatable on the card: its backward's atomic
    adds sum in varying order)."""
    lines, bad = [], []
    for it, want in enumerate(ref["steps"][:len(got[0][name]["metrics"])]):
        mine = torch.load(os.path.join(root, f"{tag}_{name}_rank0_step{it}.pt"), weights_only=False)
        loss = got[0][name]["metrics"][it]["loss_total"]
        dist = step_distances(torch, mine, want, loss, want["loss"])
        noise = ref["noise"][it]
        rows = [(k, d, max(bounds.get(k, E2E_FLOOR), 2 * noise[k])) for k, d in dist.items()]
        out = [r for r in rows if not (math.isfinite(r[1]) and r[1] <= r[2])]
        bad += [(it + 1, *r) for r in out]
        w = max(rows, key=lambda r: r[1] / r[2])
        by_noise = sum(2 * noise[k] > bounds.get(k, E2E_FLOOR) for k in dist)
        init = want["init"]
        per_master = max(((n, rel_l2(torch, t - init[n], want["masters"][n] - init[n]))
                          for n, t in mine["masters"].items()), key=lambda r: r[1])
        same = len({r[name]["digest"][it] for r in got}) == 1
        bitwise = got[0][name]["digest"][it] == ref["digest"][it]
        up = [r for r in rows if r[0] == "update"][0]
        lines.append(f"step {it + 1}: loss {loss!r} vs {want['loss']!r}; gradients concatenated "
                     f"{dist['concatenated']!r} (the card's noise {noise['concatenated']!r}); the masters' update "
                     f"concatenated {up[1]!r} (the card's noise {noise['update']!r}, bound {up[2]!r}); worst err / "
                     f"bound {w[1] / w[2]!r} at {w[0]} ({w[1]!r} / {w[2]!r}); {len(out)} of {len(rows)} outside; "
                     f"{by_noise} bounds set by the card's noise; the most distant tensor's update (ungated) "
                     f"{per_master[0]} {per_master[1]!r}; masters bitwise equal across the ranks: {same}, bitwise "
                     f"the one process's: {bitwise}")
        bad += [] if same else [(it + 1, "the ranks' masters differ")]
    b = len(ref["batch_rows"]) // len(got)
    say(f"phase 13: {label}, {len(got)} rank(s) of {b} image(s) over {got[0]['backend']} ({smi}) against one process "
        f"at batch {len(ref['batch_rows'])} on the same global batches, weights and generator: {'; '.join(lines)}")
    if bad:
        fail(f"phase 13 {label}: {len(bad)} outside, e.g. {bad[:4]}")
    if not all(r[name]["frozen_same"] for r in got):
        fail(f"phase 13 {label}: frozen parameters changed on a rank")
    if "warm_ms" not in got[0][name]:
        return
    per_rank = "; ".join(f"rank {r['rank']}: warm step {r[name]['warm_ms']!r} ms, peak {r[name]['peak_gib']!r} GiB, "
                         f"split {({k: v * 1000.0 for k, v in r[name]['times'].items()})} ms" for r in got)
    say(f"phase 13: {label} ({smi}; host clock, synchronised; the split synchronised at each boundary): frozen "
        f"parameters unchanged on every rank; {per_rank}; one process at batch {len(ref['batch_rows'])}: warm step "
        f"{ref['warm_ms']!r} ms, peak {ref['peak_gib']!r} GiB, split "
        f"{({k: v * 1000.0 for k, v in ref['times'].items()})} ms")


def rel_l2(torch, a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def step_distances(torch, mine, want, loss, want_loss) -> dict:
    """{"loss", "concatenated", each trainable name: the relative
    distance of one step's loss and gradients (saved dicts) from another's;
    "update": that of the masters' change from `want["init"]`, all tensors
    concatenated}."""
    def flat(d, sub=None):
        return torch.cat([(t - sub[n] if sub else t).reshape(-1) for n, t in d.items()])

    out = {n: rel_l2(torch, g, want["grads"][n]) for n, g in mine["grads"].items()}
    out.update(loss=abs(loss - want_loss) / abs(want_loss), concatenated=rel_l2(torch, flat(mine["grads"]),
                                                                                flat(want["grads"])),
               update=rel_l2(torch, flat(mine["masters"], want["init"]), flat(want["masters"], want["init"])))
    return out


def dp_reference(torch, cfg, model_cpu, batches, dev, root, tag):
    """The one-process steps on the global batches (`dp_train`, timed),
    their gradients and masters kept on the host, and the initial masters
    (`init`); then the card's own bf16 noise at these shapes, phase 8's rule
    measured here: the same steps on the images scaled by 1 +- 1e-3, each
    step's distances (`step_distances`, the masters' update from `init`
    among them) from the unscaled run's, the larger of the two kept per
    step (`noise`)."""
    import numpy as np

    rec = dp_train(torch, cfg, model_cpu, batches, dev, save=os.path.join(root, f"{tag}_one_step"), timing=True)
    init = torch.load(os.path.join(root, f"{tag}_one_stepinit.pt"), weights_only=False)
    steps = [dict(torch.load(os.path.join(root, f"{tag}_one_step{it}.pt"), weights_only=False),
                  loss=rec["metrics"][it]["loss_total"], init=init) for it in range(len(batches))]
    noise = [{} for _ in batches]
    for scale in (1.0 + 1e-3, 1.0 - 1e-3):
        scaled = [dict(b, images=(b["images"] * np.float32(scale)).astype(np.float32)) for b in batches]
        run = dp_train(torch, cfg, model_cpu, scaled, dev, assignment=rec["assignment"],
                       save=os.path.join(root, f"{tag}_noise_step"))
        for it, want in enumerate(steps):
            mine = torch.load(os.path.join(root, f"{tag}_noise_step{it}.pt"), weights_only=False)
            d = step_distances(torch, mine, want, run["metrics"][it]["loss_total"], want["loss"])
            noise[it] = {k: max(v, noise[it].get(k, 0.0)) for k, v in d.items()}
    return dict(rec, steps=steps, noise=noise, batch_rows=list(range(len(batches[0]["images"]))))


def phase_data_parallel(torch, seed, smi, glip_vq, gdino_vq, glip_bounds, gdino_bounds):
    """Phase 13: data parallelism on the one card. Two rank processes over
    gloo (NCCL refuses two ranks on one device), each on the card with its
    shard: MQ-GLIP-T training, 2 steps of phase 8's recipe at full width (1
    image a rank, against one process at batch 2 on the same global
    batches, weights and generator; dropout off, so both draw alike),
    MQ-GroundingDINO-T 1 step of phase 9's (the assignment the one
    process's), each gated by `dp_verdict` and on launches (78 `dcn_band` a
    step a rank; 6 + 6 MSDA); `run_inference` over phase 7's 8 images, 4 a
    rank, every detection bitwise phase 7's and the merged AP dict equal
    (launches 624 `dcn_band` + 48 `bi_attention` an image a rank); the
    extraction over the same images, rank 0's saved bank equal to phase 7's
    `QueryBank.merge` of the ranks' stores in JAX's order, no other rank
    saving. Then one rank over NCCL (a world of one, through
    `init_distributed`): one GLIP step against the one process's first by
    the same rule. Returns the launch counts, each path's summed over its
    ranks."""
    import numpy as np

    from mqdet_torch.mq.bank import QueryBank
    from mqdet_torch.utils.builders import build_model, init_params, landscape, mq_glip_t_pretrain_config

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="mqdet_dp_")
    ds = landscape(glip_vq["dataset"])

    glip_cfg = mq_glip_t_pretrain_config()
    glip_batches = loader_batches(glip_cfg, ds, glip_vq["bank"], 2)
    torch.save(glip_batches, os.path.join(root, "glip_batches.pt"))
    glip_ref = dp_reference(torch, glip_cfg, init_params(build_model(glip_cfg), seed=seed), glip_batches, dev, root,
                            "one_glip")
    torch.cuda.empty_cache()
    gdino_cfg = train_config_gdino()
    gdino_batches = loader_batches(gdino_cfg, ds, gdino_vq["bank"], 1)
    torch.save(gdino_batches, os.path.join(root, "gdino_batches.pt"))
    gdino_ref = dp_reference(torch, gdino_cfg, init_params(build_model(gdino_cfg), seed=seed), gdino_batches, dev,
                             root, "one_gdino")
    np.save(os.path.join(root, "gdino_assignment.npy"), gdino_ref["assignment"])
    glip_vq["bank"].save(os.path.join(root, "glip_bank.npz"))
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_phase

    spec = {"seed": seed, "backend": "gloo", "tag": "gloo", "parts": ["glip", "gdino", "eval"], "timing": True,
            "glip_batches": os.path.join(root, "glip_batches.pt"), "gdino_batches": os.path.join(root,
                                                                                              "gdino_batches.pt"),
            "gdino_assignment": os.path.join(root, "gdino_assignment.npy"),
            "glip_bank": os.path.join(root, "glip_bank.npz"), "bank_path": os.path.join(root, "extracted.npz")}
    t0 = time.perf_counter()
    got = spawn_ranks(torch, spec, DP_RANKS, root)
    ranks_s = time.perf_counter() - t0
    if any(r["backend"] != "gloo" or r["world"] != DP_RANKS for r in got):
        fail(f"phase 13: ranks report {[(r['backend'], r['world']) for r in got]}")
    say(f"phase 13: {DP_RANKS} rank processes over gloo on the one card ({smi}), LOCAL_RANK 0 for both; "
        f"{ranks_s!r} s; seconds by part {[r['seconds'] for r in got]}")
    dp_verdict(torch, "MQ-GLIP-T training", glip_ref, got, root, "gloo", "glip", glip_bounds, smi)
    dp_verdict(torch, "MQ-GroundingDINO-T training", gdino_ref, got, root, "gloo", "gdino", gdino_bounds, smi)

    stages, levels = glip_cfg.MODEL.DYHEAD.NUM_CONVS, len(glip_cfg.MODEL.RPN.ANCHOR_STRIDE)
    per_step = predicted(dcn_band=stages * (3 * levels - 2))
    g = gdino_cfg.GROUNDINGDINO
    per_gdino = predicted(ms_deform_attn_clip=g.enc_layers, ms_deform_attn=g.dec_layers)
    groups = -(-31 // 4)
    per_image = predicted(dcn_band=groups * stages * (3 * levels - 2), bi_attention=groups * stages)
    n_img = len(glip_vq["detections"])
    for r in got:
        want = {"glip": {k: 2 * v for k, v in per_step.items()}, "gdino": per_gdino}
        for part, w in want.items():
            if r[part]["launches"] != w:
                fail(f"phase 13: rank {r['rank']} {part} launches {r[part]['launches']} != predicted {w}")
        w = {k: v * n_img // DP_RANKS for k, v in per_image.items()}
        if r["eval"]["eval_launches"] != w:
            fail(f"phase 13: rank {r['rank']} run_inference launches {r['eval']['eval_launches']} != predicted {w}")
        if any(r["eval"]["extract_launches"].values()):
            fail(f"phase 13: rank {r['rank']} extraction launched {r['eval']['extract_launches']}")

    # evaluation: each rank's detections bitwise phase 7's, the merged AP dicts phase 7's
    want_dets, seen = glip_vq["detections"], {}
    for r in got:
        for img, d in r["eval"]["dets"].items():
            if img in seen:
                fail(f"phase 13: image {img} scored on two ranks")
            seen[img] = d
            if not all(np.array_equal(a, b) for a, b in zip(d, want_dets[img])):
                fail(f"phase 13: rank {r['rank']} image {img}: detections differ from phase 7's")
    if sorted(seen) != sorted(want_dets):
        fail(f"phase 13: images scored {sorted(seen)} != phase 7's {sorted(want_dets)}")
    want_res = {k: v for k, v in glip_vq["results"].items() if k not in ("seconds", "images_per_second")}
    for r in got:
        res = {k: v for k, v in r["eval"]["results"].items() if k != "images_per_second"}
        if res != want_res:
            fail(f"phase 13: rank {r['rank']}'s merged AP dict differs from phase 7's: "
                 f"{({k: (res.get(k), want_res.get(k)) for k in want_res if k != 'per_category_AP'})}")
    n_dets = sum(len(d[1]) for d in seen.values())
    say(f"phase 13: run_inference over phase 7's {n_img} images on {DP_RANKS} ranks "
        f"({[len(r['eval']['dets']) for r in got]} a rank): all {n_dets} detections bitwise phase 7's; the merged "
        f"AP dict on every rank equal to phase 7's (AP {want_res['AP']!r}); img/s per rank "
        f"{[r['eval']['results']['images_per_second'] for r in got]} (phase 7, one process: "
        f"{glip_vq['results']['images_per_second']!r}); seconds per rank {[r['eval']['eval_s'] for r in got]}; "
        f"launches per rank {[{k: v for k, v in r['eval']['eval_launches'].items() if v} for r in got]}")

    # extraction: rank 0's saved bank is JAX's merge of the ranks' stores
    stores = [r["eval"]["store"] for r in got]
    cap = got[0]["eval"]["capacity"]
    saved = QueryBank.load(spec["bank_path"])
    want_bank = QueryBank(channels=saved.channels, num_scales=saved.num_scales)
    want_bank._store = {k: v.copy() for k, v in stores[0].items()}
    for store in stores[1:]:
        other = QueryBank(channels=saved.channels, num_scales=saved.num_scales)
        other._store = store
        want_bank.merge(other, capacity=cap)
    same = saved.labels == want_bank.labels and all(np.array_equal(saved.get(k), want_bank.get(k))
                                                     for k in saved.labels)
    saves = [r["eval"]["saves"] for r in got]
    say(f"phase 13: extraction over the {n_img} images on {DP_RANKS} ranks: stores of "
        f"{[sum(len(v) for v in s.values()) for s in stores]} queries; rank 0's saved bank {len(saved)} classes, "
        f"{sum(saved.count(k) for k in saved.labels)} queries, equal to `QueryBank.merge` of the ranks' stores in "
        f"rank order under MAX_QUERY_NUMBER {cap}: {same}; saves per rank {[len(s) for s in saves]}; seconds per "
        f"rank {[r['eval']['extract_s'] for r in got]}")
    if not same or len(saves[0]) != 1 or any(saves[1:]):
        fail("phase 13: the extracted bank is not the merge of the ranks' stores, or not rank 0 alone saved it")

    # NCCL at world 1: one GLIP step through init_distributed, the one process's first under the same rule
    t0 = time.perf_counter()
    (one,) = spawn_ranks(torch, dict(spec, backend="nccl", tag="nccl", parts=["glip"], steps=1, timing=False), 1, root)
    if one["backend"] != "nccl" or one["world"] != 1:
        fail(f"phase 13: the NCCL rank reports backend {one['backend']}, world {one['world']}")
    dp_verdict(torch, "MQ-GLIP-T training through init_distributed('cuda', 'nccl')", glip_ref, [one], root, "nccl",
               "glip", glip_bounds, smi)
    say(f"phase 13: the NCCL rank: launches {({k: v for k, v in one['glip']['launches'].items() if v})} "
        f"(predicted {({k: v for k, v in per_step.items() if v})}); {time.perf_counter() - t0!r} s")
    if one["glip"]["launches"] != per_step:
        fail("phase 13: the NCCL rank's launches differ from a step's")

    summed = {}
    for part, key in (("glip", None), ("gdino", None), ("eval", "eval_launches")):
        counts = {}
        for r in got:
            for k, v in (r[part][key] if key else r[part]["launches"]).items():
                counts[k] = counts.get(k, 0) + v
        summed[f"phase 13 {part}"] = counts
    summed["phase 13 NCCL step"] = one["glip"]["launches"]
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    say(f"phase 13: {time.perf_counter() - t_phase!r} s in all (one-process references {ref_s!r} s)")
    return summed


def multi_card(torch, cards, seed) -> int:
    """`--cards N`: phase 13's MQ-GLIP-T training check over NCCL across N
    cards of one host. The bank is pooled over phase 7's dataset by
    `tools.train.extract_bank` with phase 7's model and settings; the
    global batches are the train loader's at batch N over the landscape
    images; the one process on card 0 gives the reference and the card's
    noise (`dp_reference`); N ranks, one a card, take 1 image each
    (`spawn_ranks` over NCCL) and `dp_verdict` gates them with E2E_FLOOR in
    place of phase 8's bounds (those come from CPU bf16 runs this mode does
    not make). Launches: 78 `dcn_band` a step a rank."""
    import shutil

    from mqdet_torch.ops import kernels
    from mqdet_torch.tools import card
    from mqdet_torch.tools.train import extract_bank
    from mqdet_torch.utils.builders import (
        build_model, init_params, landscape, mq_glip_t_pretrain_config, synthetic_lvis,
    )

    if torch.cuda.device_count() < cards:
        fail(f"--cards {cards}: {torch.cuda.device_count()} CUDA device(s) visible")
    t0 = time.perf_counter()
    smi = card()
    kernels.lib()  # built once here: the ranks load it
    say(smi)
    dev = torch.device("cuda", 0)
    root = tempfile.mkdtemp(prefix="mqdet_cards_")
    ds, _ = synthetic_lvis(root, seed)
    cfg, model = dp_eval_model(torch, seed, dev)
    c = vq_settings(cfg)
    c.VISION_QUERY.QUERY_BANK_SAVE_PATH = os.path.join(root, "bank.npz")
    bank, _ = extract_bank(c, model, ds, dev, log=lambda m: None)
    del model
    torch.cuda.empty_cache()
    glip_cfg = mq_glip_t_pretrain_config()
    glip_cfg.SOLVER.IMS_PER_BATCH = cards
    batches = loader_batches(glip_cfg, landscape(ds), bank, 2)
    torch.save(batches, os.path.join(root, "glip_batches.pt"))
    ref = dp_reference(torch, glip_cfg, init_params(build_model(glip_cfg), seed=seed), batches, dev, root,
                       "one_glip")
    torch.cuda.empty_cache()
    spec = {"seed": seed, "backend": "nccl", "tag": "cards", "parts": ["glip"], "timing": True,
            "glip_batches": os.path.join(root, "glip_batches.pt")}
    t1 = time.perf_counter()
    got = spawn_ranks(torch, spec, cards, root)
    if any(r["backend"] != "nccl" or r["world"] != cards for r in got):
        fail(f"--cards: ranks report {[(r['backend'], r['world']) for r in got]}")
    say(f"--cards {cards}: {cards} rank processes over NCCL, one a card; {time.perf_counter() - t1!r} s")
    dp_verdict(torch, f"MQ-GLIP-T training over NCCL on {cards} cards", ref, got, root, "cards", "glip", {}, smi)
    stages, levels = glip_cfg.MODEL.DYHEAD.NUM_CONVS, len(glip_cfg.MODEL.RPN.ANCHOR_STRIDE)
    want = {k: 2 * v for k, v in predicted(dcn_band=stages * (3 * levels - 2)).items()}
    for r in got:
        if r["glip"]["launches"] != want:
            fail(f"--cards: rank {r['rank']} launches {r['glip']['launches']} != predicted {want}")
    shutil.rmtree(root, ignore_errors=True)
    say(f"--cards {cards}: launches {want['dcn_band']} `dcn_band` on every rank, as predicted; "
        f"{time.perf_counter() - t0!r} s in all")
    print(json.dumps({"ok": True, "cards": cards, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--rank-worker"]:  # one of phase 13's rank processes
        return rank_worker(sys.argv[2])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=5, help="timed protocol runs per model")
    ap.add_argument("--cards", type=int, default=0, help="run only the check across N >= 2 cards (`multi_card`)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a GPU")
    if not os.path.isdir(os.path.join(REPO, "mqdet_torch", "csrc")):
        fail("run from a checkout of the repository: mqdet_torch/ not found")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False
    if args.cards:
        return multi_card(torch, args.cards, args.seed)

    from mqdet_torch.ops import kernels
    from mqdet_torch.tools import card
    from mqdet_torch.utils.builders import (
        build_model, init_params, mq_glip_t_config, mq_groundingdino_t_config, synthetic_batch,
        synthetic_caption_batch,
    )

    smi = card()
    t0 = time.perf_counter()
    kernels.lib()
    build_s = time.perf_counter() - t0
    say(smi)
    say(f"phase 1: card {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{len(kernels.sources())} kernel sources built from mqdet_torch/csrc for sm_90a in "
        f"{build_s!r} s ({os.path.basename(kernels.library_path())})")

    tmp = tempfile.TemporaryDirectory()  # phase 7's synthetic dataset; removed at exit
    kres, sweep_launches = phase_kernels(torch, args.seed)
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    torch.set_num_threads(os.cpu_count() or 1)
    launches = {"perf_dcn_sweep": sweep_launches}

    # ---- MQ-GLIP-T -------------------------------------------------------
    cfg = mq_glip_t_config()
    cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 300
    model_cpu = init_params(build_model(cfg), seed=args.seed).eval()
    model = copy.deepcopy(model_cpu).to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    launches.update(phase_reference_glip(torch, cfg, model_cpu, model, args.seed))
    phase_reference_extract(torch, "MQ-GLIP-T", cfg, model_cpu, model, args.seed, (True, False))
    del model_cpu
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    groups = -(-31 // 4)
    dcn, fuse = groups * stages * (3 * levels - 2), groups * stages
    tower = model.rpn.head.dyhead_tower
    parts = {"image tower": [model.backbone.body, model.backbone.fpn], "language tower": [model.language_backbone],
             "VLFuse": list(tower[0::3]), "head BERT layers": list(tower[1::3]), "DyConv": list(tower[2::3])}
    # default last: its phase 6 (synchronised split) ends a model's runs, because
    # protocols timed right after it read 7-24% slower with the same device busy time
    for switch, deform, want in (
        ("stream", None, predicted(dcn_band=dcn, bi_attention_levels=fuse * levels)),  # one launch per level
        ("dual", None, predicted(dcn_band=dcn, bi_attention_dual=fuse)),
        ("default", "window", predicted(dcn_gather_clip=dcn, bi_attention=fuse)),  # K2 in the protocol
        ("default", "gather", predicted(dcn=dcn, bi_attention=fuse)),  # the exact mode in the protocol
        ("default", None, predicted(dcn_band=dcn, bi_attention=fuse)),
    ):
        launches[f"MQ-GLIP-T {switch}{' ' + deform if deform else ''}"] = phase_protocol(
            torch, "MQ-GLIP-T", model, cfg, synthetic_batch, 300, want, args.runs, args.seed,
            parts if switch == "default" and deform is None else None, switch, deform,
        )
    glip_vq = {}  # phase 7's dataset and bank, for phase 8
    launches.update(phase_vision_query(torch, "MQ-GLIP-T", cfg, model, args.seed,
                                       predicted(dcn_band=dcn, bi_attention=fuse), tmp.name, 300, glip_vq))
    del model, tower, parts  # nothing of MQ-GLIP-T may stay on the card
    torch.cuda.empty_cache()

    # ---- MQ-GroundingDINO-T ----------------------------------------------
    cfg = mq_groundingdino_t_config()
    g = cfg.GROUNDINGDINO
    model_cpu = init_params(build_model(cfg), seed=args.seed).eval()
    model = copy.deepcopy(model_cpu).to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    launches["MQ-GroundingDINO-T reference"] = phase_reference_gdino(torch, cfg, model_cpu, model, args.seed)
    phase_reference_extract(torch, "MQ-GroundingDINO-T", cfg, model_cpu, model, args.seed, (True,))
    del model_cpu
    enc, dec, fuse = groups * g.enc_layers, groups * g.dec_layers, groups * g.enc_layers
    tr = model.transformer
    parts = {"image tower": [model.backbone[0], *model.input_proj], "BERT": [model.bert],
             "fusion": list(tr.encoder.fusion_layers), "text enhancer": list(tr.encoder.text_layers),
             "encoder deformable layers": list(tr.encoder.layers), "decoder layers": list(tr.decoder.layers),
             "bbox heads": list(model.bbox_embed),
             "two-stage heads": [tr.enc_output, tr.enc_output_norm, tr.enc_out_bbox_embed]}
    # the fusion takes one flattened tensor, so MQDET_FLASH_LEVELS does not apply
    for switch, want in (
        ("dual", predicted(ms_deform_attn_clip=enc, ms_deform_attn=dec, bi_attention_dual=fuse)),
        ("default", predicted(ms_deform_attn_clip=enc, ms_deform_attn=dec, bi_attention=fuse)),
    ):
        launches[f"MQ-GroundingDINO-T {switch}"] = phase_protocol(
            torch, "MQ-GroundingDINO-T", model, cfg, synthetic_caption_batch, g.num_queries, want,
            args.runs, args.seed, parts if switch == "default" else None, switch,
        )
    gdino_vq = {}  # phase 7's dataset and bank, for phase 9
    launches.update(phase_vision_query(
        torch, "MQ-GroundingDINO-T", cfg, model, args.seed,
        predicted(ms_deform_attn_clip=enc, ms_deform_attn=dec, bi_attention=fuse), tmp.name, g.num_queries,
        gdino_vq))
    del model, tr, parts
    torch.cuda.empty_cache()

    # ---- phases 8 and 9: modulated pre-training -------------------------
    glip_bounds, gdino_bounds = {}, {}  # the reference steps' bounds, for phase 13
    launches["MQ-GLIP-T training"] = phase_train(torch, args.seed, glip_vq["dataset"], glip_vq["bank"], smi,
                                                 glip_bounds)
    launches["MQ-GroundingDINO-T training"] = phase_train_gdino(torch, args.seed, gdino_vq["dataset"],
                                                                gdino_vq["bank"], smi, gdino_bounds)

    # ---- phase 10: the evaluation CLI ------------------------------------
    configs = merge_shipped_configs()
    cli_root = os.path.join(tmp.name, "cli")
    os.makedirs(cli_root)
    glip_cfg = mq_glip_t_config()
    stages = glip_cfg.MODEL.DYHEAD.NUM_CONVS
    per_group = predicted(dcn_band=stages * (3 * levels - 2), bi_attention=stages)
    launches.update(phase_cli(torch, "MQ-GLIP-T", glip_cfg, args.seed, glip_vq,
                              predicted(dcn_band=dcn, bi_attention=groups * stages), per_group, cli_root, smi,
                              configs, other_styles=True))
    torch.cuda.empty_cache()
    launches.update(phase_cli(torch, "MQ-GroundingDINO-T", mq_groundingdino_t_config(), args.seed, gdino_vq,
                              predicted(ms_deform_attn_clip=enc, ms_deform_attn=dec, bi_attention=fuse), None,
                              cli_root, smi, configs))
    torch.cuda.empty_cache()

    # ---- phases 11 and 12: MQ-GLIP-L --------------------------------------
    l_root = os.path.join(tmp.name, "glip_l")
    os.makedirs(l_root)
    glip_l = {}  # phase 11's model on the CPU and .pth, for phase 12
    launches.update(phase_glip_l(torch, args.seed, args.runs, smi, l_root, configs, glip_l))
    launches["MQ-GLIP-L finetune"] = phase_finetune(torch, args.seed, glip_l, l_root, smi)
    del glip_l
    torch.cuda.empty_cache()

    # ---- phase 13: data parallel on the one card ------------------------
    launches.update(phase_data_parallel(torch, args.seed, smi, glip_vq, gdino_vq, glip_bounds, gdino_bounds))

    say(f"wall time {time.perf_counter() - t_start!r} s (build included)")
    entries = []
    for name, source, replaces in KERNELS:
        cases = kres[name]
        main_case = cases[0]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(per_path[name] for per_path in launches.values()),
            "launches_by_path": {path: per_path[name] for path, per_path in launches.items() if per_path[name]},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "cases": cases,
        })
        if not entries[-1]["launches"]:
            fail(f"{name}: no counted path launched it")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
