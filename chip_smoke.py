#!/usr/bin/env python3
"""Smoke run of the mqdet_torch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N] [--runs N] [--cards N]

Run from the root of a checkout. It needs a CUDA device and the CUDA toolkit
(`nvcc`); it imports nothing of JAX, and neither PyYAML nor PIL. It drives
both evaluation paths of the port, MQ-GLIP-T and MQ-GroundingDINO-T, the
modulated pre-training of both, the evaluation CLI, MQ-GLIP-L through the
same entry points (with TPU.REMAT in training), the few-shot finetuning
CLI, data parallelism, MQ-Det's model switches, test-time augmentation,
knowledge prompts, the CLIP / RNN towers and Swin v2 / vl, GDINO at 3
feature levels, DyConv's merged canvas, MQDET_FUSION_IMPL, the demo, the
legacy detector family (ResNet / EfficientNet / BiFPN with the FCOS /
RetinaNet / ATSS heads), pooling, the image-batched protocol with the
flop accounting, and the measurement tools. Phases, each printing lines:

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
     locations far off the image on the exact mode; then phase 16.1's cases
     (below);
  3. per model, a small-input reference check: the full-width model on a
     256x256 image, one chunk, on the card (bf16, kernels) against the same
     weights in fp32 on the CPU (plain versions), by relative L2 error within
     twice the drift of the plain path run in bf16 on the CPU (or 1e-2 where
     that is larger). MQ-GLIP-T: FPN features and dot-product logits, the
     card run under each fusion switch (default, MQDET_FLASH_LEVELS=stream,
     MQDET_FLASH_SCORES=dual, MQDET_FUSION_IMPL=xla: no bi-attention
     launch) and under MQDET_DEFORM_IMPL unset (the band
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
  5. per model, its default protocol run once more under torch.profiler
     (`mqdet_torch.tools.perf_trace`; the switches' runs are not profiled:
     their kernels' times are phase 2's): device busy time, idle share,
     kernel time by family and the time and launches of each hand-written
     kernel;
  6. per model, last of its protocol runs (default switches), one protocol
     run with a device synchronise at the boundaries of its main modules
     (forward hooks, `mqdet_torch.tools.perf_bisect.split_by_module`):
     host-clock ms per module;
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
     the unscaled run's drift, the card step taken twice and both gated
     (atomic adds: the two readings show the card's own spread); each DCN
     Function's backward (band, K2, exact) at GLIP's level-0 and level-1
     shapes, B 2, offsets x3, against
     the fp32 plain VJP within 2e-2 * max|ref|, with the level-0 backward's
     time. Then 2 warm-up and 4 timed steps: ms per step, train img/s, peak
     memory, launches (gated: 78 `dcn_band` a forward, no bi-attention
     kernel: the fusion's training composite); one step split at forward /
     backward / update; one profiled step (device busy, idle share, the
     device time of the kernels inside the `dcn_backward` spans; ~20 s of
     host time, phase 8 alone); one timed step on phase 7's 2
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
     apart) and gates, launches gated at 6 `ms_deform_attn_clip` + 6 `ms_deform_attn` a
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
     4's LVIS protocol with phase 6 (no profile), launches gated at 832
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
     shapes (the elementwise largest over 4 runs of the one process on the
     images scaled by 1 +- 1e-3 and 1 +- 2e-3; the worst reading under the
     first 2 runs' noise printed beside it), the
     masters' update from the initial masters (concatenated) within twice
     that noise of the one process's (floor 1e-2; a step that moved nothing
     is 1 from it), the masters bitwise equal across the ranks, the frozen
     parameters unchanged, launches 78
     `dcn_band` a step a rank (6 + 6 MSDA); `run_inference` over phase 7's
     8 images, 4 a rank: every detection bitwise phase 7's, the merged AP
     dict equal to phase 7's, launches 624 `dcn_band` and 48
     `bi_attention` an image a rank; extraction over the same images: rank
     0's saved bank equal to `QueryBank.merge` of the ranks' stores in rank
     order, no other rank saving. Then one rank over NCCL, a world of one
     (rank 0's process after the gloo group, on the models it built):
     one GLIP step against the one process's first by the same rule (the
     step is not bitwise repeatable on the card: its backward's atomic
     adds sum in varying order). Each
     rank's step ms, split and peak memory are printed;
 14. last, MQ-Det's model switches (`phase_switches`), MQ-GLIP-T at full
     width, S1 and MHA-S from init_params(seed), the others sharing MHA-S's
     weights (`init_like`): S1 (`switch_config`: NO_CAT off,
     ADD_ADAPT_LAYER, SHARE_KV, AUGMENT_IMAGE_WITH_QUERY, NEW_MASK_TOKEN,
     ADD_VISION_LAYER, QUERY_FUSION, LEARNABLE_BANK filled from phase 7's
     bank, ADD_LINEAR_LAYER, MLM_LOSS), MHA-S, SCAN, FILM, S8
     (EARLY_FUSE_ON, USE_FUSED_FEATURES_DOT_PRODUCT, USE_DFCONV,
     USE_DYFUSE, USE_DYRELU off) and the default model under
     MODEL.FPN.USE_GN and USE_RELU, each a whole model checked at 256x256 by
     phase 3's rule (logits, boxes, S1's `mlm_logits`; launches 78
     `dcn_band`, 0 under S8, and 6 `bi_attention` under S1 and the FPN
     switches alone; two card forwards each, both gated);
     CONDITION_GATE off, NONLINEAR_GATE off and FIX_ATTN_GATE 0.25 on the
     full-width language tower alone; phase 4's protocol (without phase
     5) under S1 (the learnable bank's indices), MHA-S and FILM, launches
     624 `dcn_band` in all three and 48 `bi_attention` under S1 alone;
     `run_inference` under RETURN_ATTN_GATE_VALUE on 2 of phase 7's images
     (`attn_gate_value` within 1e-2 of the CPU's, the detections bitwise
     the run's without the flag); S1 training under `vision_query_v5`
     (phase 8's reference step, 3 steps at batch 2 and 800x1344 with 78
     `dcn_band` each, `loss_mlm` finite, the bank entries with a query
     moved and every entry no batch names bitwise, the frozen parameters
     bitwise; ms a step, peak memory, the MLM head's share);
 15. test-time augmentation, knowledge prompts, the other language towers
     and Swin versions, run per model right after its phase 7: the kernels
     at the augmentation's buckets (608x1024, 800x1344, 1216x2016), one
     chunk group of the protocol each, the first launch of each kernel at
     each shape held against its plain version in fp32 on the card by
     phase 2's rule (K1 at every level and stride, K3, and for
     MQ-GroundingDINO-T K5 and the exact MSDA; the cases join the kernel
     JSON line), K5's band geometry per level pair printed;
     `run_inference` under TEST.USE_MULTISCALE on 1 of phase 7's images
     (TEST.SCALES' 8 scales x flip under MAX_SIZE 2000, one chunk group of
     160 classes), launches gated at 16 passes x one group's, the merged
     detections against the same call on the kernels' plain versions on
     the card (`ops.kernels.plain_versions`, no launch: the top 300 scores
     sorted within 2e-2 * the largest), the seconds an image;
     MQ-GLIP-T alone: `run_inference` with a GLIPKNOW.KNOWLEDGE_FILE
     written here (the token ids the card's language tower received equal
     to the host plan's, and unlike the plan without it), and MQ-GLIP-T
     with MODEL_TYPE clip and rnn and Swin v2 and vl (`init_like` the
     default model): phase 14's reference check at 256x256 and one timed
     chunk group at 800x1344, launches gated;
 16. the legacy family and the remainders:
     16.1 (the end of phase 2) K1 on DyConv's merged canvas (GLIP's levels
     of at most 600 output positions at 800x1344 zero-padded onto one
     canvas at batch 2B, offsets edge-padded, x3 past the clip) at strides
     1 and 2, and K5 and the exact MSDA kernel with a 3-level table at
     GDINO's 800x1344 levels, by phase 2's rule; 16.2 MQ-GroundingDINO-T at
     GROUNDINGDINO.num_feature_levels 3, 6 + 6 layers (`init_like` the
     4-level model): phase 3's reference check, one protocol group (CP 4)
     at 800x1344 with launches 6 + 6 MSDA + 6 bi-attention and each
     kernel's first launch
     held to its plain version, one training step by phase 9's rule; 16.3
     the first head stage's DyConv on MQ-GLIP-T's own P3..P7 with its
     DeformConvGNs' `merge_max_positions` 600 against 0: outputs within
     phase 2's rule, one `dcn_band` launch fewer for each of its three
     convs; 16.4 one MQ-GLIP-T chunk group under
     MQDET_FUSION_IMPL=xla: 0 bi-attention launches, its sorted top 300
     scores within 2e-2 of the default's; 16.6 the demo (`MQDetDemo`) per
     model on a numpy image: its head's detections bitwise those of the
     split functions it wraps, launches gated (these run after each model's
     phase 15, GDINO at 3 levels after GDINO's); last, 16.5 the legacy
     family: a reference forward at 256x256 of R-50-RETINANET + ATSS,
     R-101-C4 (the body), EFFICIENT3-FPN-RETINANET + RETINA,
     EFFICIENT3-BIFPN-FCOS + FCOS and EFFICIENT-DET (compound 0) + ATSS by
     phase 3's rule; for FCOS, RETINA and ATSS on R-50-RETINANET a
     reference SGD step at 256x256 by phase 8's rule and 1 + 3 SGD steps at
     800x1344, batch 2, bf16 autocast (ms a step, peak memory; losses
     finite, the body, FPN and head moved, post-processed detections at
     pre-NMS threshold 0 at least one an image, finite and inside the
     image); no hand-written kernel launched anywhere in it;
     16.7 `deform_psroi_pool` and `roi_pool` on the card against the CPU;
 17. the image-batched LVIS protocol (`make_batched_protocol_fn`), per
     model right after its phase 16 parts, at full width and 800x1344: B 4
     seeded images of distinct content and true sizes x 8 groups x CP 4
     (the head at batch 16). 17.1 each kernel at the batched shapes, on the
     model's own activations (one group's first launch at each shape, as
     phase 15), held to its plain version in fp32 by phase 2's rule on
     batch items 0 and last (the plain versions cannot hold the whole
     batch): K1 at every level and stride, K3, K5 and the exact MSDA at
     head batch 16, K1 and K3 also at 32 (B 8); their ms and bounds join
     the kernel JSON line. 17.2 one warm-up and 3 timed calls (ms a call by
     CUDA events and the host clock, img/s, peak memory), launches gated
     on every call at the per-image protocol's (MQ-GLIP-T 624 `dcn_band` +
     48 `bi_attention`; MQ-GroundingDINO-T 48 `ms_deform_attn_clip` + 48
     `ms_deform_attn` + 48 `bi_attention`); every entry i * CP + c against
     `make_protocol_fn` on image i by phase 16.4's rule (the sorted top 300
     scores within 2e-2 * the largest, of the valid slots and of all slots:
     random-init MQ-GroundingDINO-T has no score over its box threshold),
     the bitwise-equal entries counted.
     17.3 (MQ-GLIP-T) `make_predict_fn` at batch 4, image i against chunk
     i, launches gated, each image within the same rule of its batched
     entry. 17.4 `utils/stats.flops_with_kernels` on one per-image and one
     batched call: the operator counter, the kernels' registry by family
     (gated: equal to the sum of each launch's own formula, and the
     batched call's B times the per-image call's, exactly), TFLOP/s at the
     p50 and the share of 989 TFLOP/s (printed, not gated);
 18. the measurement tools of `mqdet_torch/tools/` through their
     functions, at reduced repetitions, each JSON line printed (`phase_tools`,
     MQ-GLIP-T right after its phase 17, on phase 4's model;
     `phase_tools_train` after phase 8, on phase 8's model): perf_trace
     (phase 5's report; its families sum to its device total), perf_bisect,
     perf_bisect2, perf_head_once (launches 78 `dcn_band` + 6 `bi_attention`
     a group), perf_postproc, perf_fusion (one `bi_attention` a stage under
     `pallas`, none under `xla`), perf_protocol_sweep at CP 8 and 16
     (launches 78 + 6 a group; every entry within phase 16.4's rule of phase
     4's entry for its chunk), perf_bucket_churn (one timed run a pixel
     count) and perf_train_step at batch 4 (2 timed steps, 78 `dcn_band`
     a step); every number finite and every time above 0.

The CPU runs of the training reference steps of phases 16.2, 8, 9 and
16.5 need only the seed and the configs (phase 14's S1 step phase 7's bank
too, saved for it): a worker process of this script
(`--cpu-references DIR SEED THREADS`, `CpuReferences`) makes them while the
card runs phases 1-7 and 15-17, at this process's thread count (the CPU's
sums depend on it), stopped while this process makes the CPU references of
phases 3, 15 and 16.2's forward; each phase waits for its own and holds the
worker's weights to its own by their digest. The run prints the seconds of
each part of it and how long each phase waited for the worker.

The training reference steps (phases 8, 13 and 14's S1) also take ROADMAP
Queue C 4's second gate (`fp32_verdict`): the step in fp32 on the card's
plain versions (cuDNN off) against the CPU's fp32 step, within 1e-1
relative L2 (reduction order alone moves the gates' cancelling sums by up
to ~4e-2; a zeroed gradient reads 1) on every tensor whose bf16 bound is 1
or more and every 0-d or 1-element tensor; phase 13's ranks take it on the first global batch
against one process at batch 2, both fp32 on the card.

    python3 chip_smoke.py --cards N

runs instead the one check that needs N >= 2 cards of one host
(`multi_card`): phase 13's MQ-GLIP-T training over NCCL, one rank a card
(LOCAL_RANK r on `cuda:r`), 2 steps of 1 image a rank against one process
at batch N on card 0, gated by phase 13's rule: each tensor's bound the
larger of phase 8's CPU bound (`phase_train_reference` on this host) and
twice the card's own noise, taken over 4 perturbed runs of the one process
(images x(1 +- 1e-3) and x(1 +- 2e-3)); the line counts the bounds at 1 or
more, which pass a zero gradient; its last line is
{"ok": true, "cards": N, ...}.

The line before the last is a JSON object with one entry per kernel (its
launches summed over the counted paths: the protocols, phase 3's card runs,
the sweep path, phase 7's evaluation and update, phases 8 and 9's timed
training steps, phase 10's CLI runs, phases 11 and 12's paths, phase
13's, summed over its ranks, phase 14's, phase 15's, phase 16's and phase
17's batched, per-image, flop-counted and predict calls); the last
line is {"ok": true, "device": {...}}. Any failure exits non-zero without
those lines.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import copy
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ERR_BOUND = 2e-2      # kernel vs fp32 plain, relative to max|ref| (bf16 in/out)
E2E_FLOOR = 1e-2      # whole network: floor of the bf16-vs-fp32 relative L2 bound
FP32_BOUND = 1e-1     # training step, fp32 on the card's plain versions vs fp32 on the CPU: relative L2 (the
                      # card's cuDNN off; reduction order alone moved phase 14's S1 gate tensors by up to 4.0e-2)
FP32_SCALE_FLOOR = 1e-3  # its norm floor: this share of the step's per-element gradient scale
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
SWITCHES = {"default": {}, "stream": {"MQDET_FLASH_LEVELS": "stream"}, "dual": {"MQDET_FLASH_SCORES": "dual"},
            "xla": {"MQDET_FUSION_IMPL": "xla"}}  # xla: the fusion's composite, no bi-attention kernel
# MQDET_DEFORM_IMPL -> the DCN kernel of the route at C = 256 (None: unset, the default)
DEFORM_ROUTES = {None: "dcn_band", "window": "dcn_gather_clip", "gather": "dcn"}
SWEEP_VERSIONS, SWEEP_BLOCK_ROWS = (2, 1, 3, 5, 6), (8, 16)  # version 2 first: the sweep's reference


def switched(name: str, deform=None, msda=None):
    """Sets the fusion switches of SWITCHES[name], MQDET_DEFORM_IMPL and
    MQDET_MSDA_IMPL (None: unset) for the block, the others of those keys
    unset."""
    from mqdet_torch.tools import env

    keys = ("MQDET_FLASH_LEVELS", "MQDET_FLASH_SCORES", "MQDET_FUSION_IMPL")
    return env(**{**dict.fromkeys(keys), **SWITCHES[name]}, MQDET_DEFORM_IMPL=deform, MQDET_MSDA_IMPL=msda)


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
        say(f"{'' if label.startswith('phase ') else 'phase 2: '}{label}: max_abs_err {err!r} (bound "
            f"{ERR_BOUND * scale!r} = {ERR_BOUND} * max|ref| "
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

    def msda_case(name, b, q, lo, hi, nh=8, hd=32, p=4, impl=None, scale=2.0, shapes=GDINO_800, tag="phase 2"):
        """q None: encoder queries (Q = S), each sampling every level around
        its own cell centre with N(0, `scale` cells) offsets, so samples leave
        the image near the borders; q "edge": encoder queries whose samples
        lie on their windows' edges (exactly c - R or c + R + 1, or 0.25
        past them, clamped onto them; pairs without a window anywhere within
        2 pixels of the map); else Q decoder queries at uniform locations in
        [lo, hi) of every level. Under MQDET_MSDA_IMPL `impl` (None: unset):
        encoder queries take the clipped mode unless `gather`, against
        `ms_deform_attn_clipped_plain`; the rest the exact mode. `shapes`:
        the level table (GDINO's 800x1344 pyramid); `tag` names the line."""
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
            f"{tag}: msda {name} ({kernel}, MQDET_MSDA_IMPL {impl or 'unset'}): value {(b, s, nh, hd)} Q {q} "
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

    # phase 16.1: the slice's new shapes. K1 on DyConv's merged canvas (the
    # levels of at most 600 output positions at 800x1344, zero-padded onto one
    # canvas at batch 2B, offsets edge-padded), offsets x3 past the +-2 clip
    from mqdet_torch.models.vldyhead import merge_onto_canvas

    for stride, levels in ((1, GLIP_800[3:]), (2, GLIP_800[2:4])):
        parts = []
        for h, w in levels:
            x, off, mask, wt, bias = dcn_inputs(4, h, w, 256, stride, 3.0)
            parts.append((x.permute(0, 3, 1, 2), off, mask))
        xc, offc, maskc = merge_onto_canvas(parts, stride)
        args = (xc.permute(0, 2, 3, 1).contiguous(), offc, maskc, wt, bias)
        b, h, w, c = args[0].shape
        ho, wo = offc.shape[1:3]
        got = dc.modulated_deform_conv_pallas(*args, stride=stride, radius=2, block_rows=8)
        torch.cuda.synchronize()
        ref = dc.modulated_deform_conv_clipped_plain(*(a.float() for a in args), stride=stride, radius=2)
        ms_ = cuda_time_ms(lambda: dc.modulated_deform_conv_pallas(*args, stride=stride, radius=2, block_rows=8))
        plain_ms = cuda_time_ms(lambda: dc.modulated_deform_conv_clipped_plain(*args, stride=stride, radius=2))
        bnd = dcn_bound(b, h, w, c, ho, wo, c)
        err = check(f"phase 16: dcn_band on the merged canvas of levels {levels} at stride {stride}, x{(b, h, w, c)} "
                    f"-> {(ho, wo)}", got, ref, f"; kernel {ms_!r} ms, plain bf16 {plain_ms!r} ms, bound {bnd[0]!r} ms "
                    f"({bnd[1]})")
        record("dcn_band", f"merged canvas x{(b, h, w, c)} s{stride}", err, ms_, plain_ms, bnd)
        del parts, args, got, ref
    # K5 and the exact kernel with a 3-level table (GDINO at 3 feature levels)
    g3 = GDINO_800[:3]
    msda_case("encoder, 3 levels", 4, None, None, None, shapes=g3, tag="phase 16")
    msda_case("encoder far, 3 levels", 4, None, None, None, scale=12.0, shapes=g3, tag="phase 16")
    msda_case("decoder, 3 levels", 4, 900, 0.0, 1.0, shapes=g3, tag="phase 16")
    msda_case("encoder, 3 levels", 4, None, None, None, impl="gather", shapes=g3, tag="phase 16")
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
              "dual": {"bi_attention_dual": stages}, "xla": {}}
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


def phase_reference_gdino(torch, cfg, model_cpu, model_gpu, seed, label="MQ-GroundingDINO-T", phase="phase 3"):
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
        fail(f"{label} reference run: MSDA launches {used} (predicted {g.enc_layers} clipped, "
             f"{g.dec_layers} exact)")
    say(f"{phase}: {label} at {hw}, CPU under MQDET_MSDA_IMPL=pallas_interpret: the clip moves "
        f"{moved!r} of the encoder's sample points, layer by layer (fp32 run); card launches "
        f"{ {k: v for k, v in used.items() if v} }")
    worst = compare_to_reference(torch, label, ("memory", "text", "enc_logits"),
                                 ref, plain16, card)
    overlap = len(set(ref_idx[0].tolist()) & set(card_idx[0].tolist()))
    say(
        f"{phase}: reference check, {label} full width at {hw}, card bf16 kernels vs CPU "
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


def phase_profile(torch, label, protocol, image, text):
    """Phase 5: one protocol run under torch.profiler through
    `mqdet_torch.tools.perf_trace` (the CUDA activity alone: the CPU ops'
    events, which nothing here reads, cost ~20 s of host time a profile):
    the device's busy time (union of kernel intervals), its share of the
    window from the first kernel's start to the last one's end, and kernel
    time by class (`perf_trace.CLASSES`). The profiler slows the host, so
    the idle share is an upper bound. Returns the trace's report."""
    from mqdet_torch.tools import perf_trace

    rep = perf_trace.report(perf_trace.trace(lambda: protocol(image, *text), 1), 1)
    if not rep["kernels"]:
        say(f"phase 5: {label}: the profiler recorded no device kernels; breakdown not measured")
        return rep
    parts = ", ".join(f"{k} {v:.1f}" for k, v in rep["classes"].items())
    say(f"phase 5: {label} profiled protocol: device busy {rep['busy_ms']!r} ms in a {rep['window_ms']!r} ms "
        f"window (idle share {rep['idle_share']!r}, profiler on); {rep['kernels']} kernels; kernel ms by family: "
        f"{parts}")
    own = [f"{pat} {ms!r} ms in {n} launches ({ms / n!r} each)" for pat, (ms, n) in rep["own"].items()]
    say(f"phase 5: {label} hand-written kernels: {'; '.join(own)}")
    return rep


def phase_split(torch, label, protocol, image, text, parts):
    """Phase 6: one protocol run with a device synchronise before and after
    each module of `parts` ({name: [modules]}, none inside another),
    `mqdet_torch.tools.perf_bisect.split_by_module`: host-clock ms per name,
    and the rest (glue, heads and postprocess outside those modules). The
    total exceeds the p50: the split says where the time goes, not how long
    the protocol takes."""
    from mqdet_torch.tools.perf_bisect import split_by_module

    total, spent, calls = split_by_module(protocol, (image, *text), parts)
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
                   switch="default", deform=None, profile=True, phase="phase 4", keep=None):
    """Phase 4 and (with `profile`) 5 for one model under the fusion
    switches SWITCHES[switch] and MQDET_DEFORM_IMPL `deform` (None: unset),
    and phase 6 where `parts` is given; returns the launch counts of the
    counted protocol run (a name of `mqdet_torch.ops.COUNTERS` each).
    `phase` names the lines; `keep`, a dict, receives the counted run's
    detections ("dets") and phase 5's trace report ("trace")."""
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
        say(f"{phase}: {label} protocol launches {launches} (predicted {want}); shapes ok {shapes_ok}; "
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
        if times:
            p50 = statistics.median(times)
            say(f"{phase}: {label} protocol p50 {p50 * 1000.0!r} ms over {runs} runs "
                f"(min {min(times) * 1000.0!r}, max {max(times) * 1000.0!r}); {1.0 / p50!r} img/s; "
                f"peak memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB")
        if keep is not None:
            keep["dets"] = dets
        if profile:
            rep = phase_profile(torch, label, protocol, image, text)
            if keep is not None:
                keep["trace"] = rep
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


REFERENCE_SCALES = (1.0, 1.0 + 1e-3, 1.0 - 1e-3)  # the reference steps' image scalings (phase 8's rule)


def reference_step(torch, cfg, seed, edit=None):
    """step(model, dev, scale=1.0) -> (loss, {trainable name: fp32 gradient
    on the CPU}): one training step of phase 8's reference at 256x256, batch
    2, text dropout 0, on the images scaled by `scale` (`phase_train_reference`)."""
    import numpy as np

    from mqdet_torch.core.config import trainable_patterns
    from mqdet_torch.engine.train import batch_to_device, init_train_state, make_train_step

    c = cfg.clone()
    c.VISION_QUERY.TEXT_DROPOUT = 0.0
    batch = reference_batch(c, seed, (256, 256))
    if edit is not None:
        edit(batch)
    mlm = None
    if c.MODEL.DYHEAD.FUSE_CONFIG.MLM_LOSS:  # one random_word mask for every run: the CPU's and the card's
        rng, shape = np.random.default_rng(seed + 5), batch["input_ids"].shape  # generators draw apart
        mlm = (rng.random(shape, np.float32), rng.random(shape, np.float32),
               rng.integers(0, c.MODEL.LANGUAGE_BACKBONE.VOCAB_SIZE, shape))

    def step(model, dev, scale=1.0):
        state, tx = init_train_state(model, c, trainable_patterns(c))
        run = make_train_step(model, tx, c)
        inputs = dict(batch, images=(batch["images"] * np.float32(scale)).astype(np.float32))
        kw = {} if mlm is None else {"mlm_draws": tuple(torch.from_numpy(d).to(dev) for d in mlm)}
        _, metrics = run(state, batch_to_device(inputs, dev), torch.Generator(device=dev).manual_seed(seed), **kw)
        params = dict(model.named_parameters())
        return float(metrics["loss_total"]), {n: params[n].grad.float().cpu() for n in state.trainable}

    return step


def train_reference_cpu(torch, cfg, model_cpu, seed, edit=None):
    """The CPU runs of `phase_train_reference`: (the fp32 steps, the bf16
    steps, each {scale: (loss, gradients)} over REFERENCE_SCALES, seconds)."""
    step = reference_step(torch, cfg, seed, edit)
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    ref32 = {s: step(dropout_off(copy.deepcopy(model_cpu)), cpu, s) for s in REFERENCE_SCALES}
    run16 = {s: step(dropout_off(copy.deepcopy(model_cpu).to(torch.bfloat16)), cpu, s) for s in REFERENCE_SCALES}
    return ref32, run16, time.perf_counter() - t0


def phase_train_reference(torch, cfg, model_cpu, seed, bounds=None, phase="phase 8", label="MQ-GLIP-T", edit=None,
                          card=True, cpu=None):
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
    gradient is also held to twice the unscaled run's drift. `edit(batch)`
    changes the numpy batch first (phase 14: the learnable bank's indices);
    under MLM_LOSS every run takes one random_word mask drawn from the seed
    with numpy (the CPU's and the card's generators draw apart); `phase`
    and `label` name the lines. The card takes the step twice, each gated
    and printed: its backward sums by atomic adds, so the two readings show
    how far the card alone moves a gate's reading. Then the second gate
    of ROADMAP Queue C 4 (`fp32_verdict`): the step in fp32 on the card
    through the kernels' plain versions (no launch) and without cuDNN (its
    fp32 convolution algorithms moved the gradients by up to 7e-2 against
    the CPU's, 9.1e-3 without it) against the CPU's fp32 step, on every
    tensor whose bound here is 1 or more and every 0-d or 1-element tensor.
    With `card` False only the CPU runs are made, for
    `bounds` (`--cards`: phase 8 itself gates the card step). `cpu`: the
    CPU runs (`train_reference_cpu`) where the caller has them, made by the
    worker process (`CpuReferences`), else made here. Returns one card
    step's launch counts."""
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.ops.kernels import plain_versions

    hw = (256, 256)
    step = reference_step(torch, cfg, seed, edit)
    ref32, run16, cpu_s = cpu if cpu is not None else train_reference_cpu(torch, cfg, model_cpu, seed, edit)
    scales = tuple(ref32)
    if not card:
        bounds.update(reference_bounds(torch, ref32, run16, scales))
        say(f"{phase}: the reference step's CPU runs at {hw} for the bounds ({cpu_s!r} s): concatenated "
            f"{bounds['concatenated']!r}, the loss {bounds['loss']!r}, per tensor {min(bounds.values())!r} to "
            f"{max(bounds.values())!r}")
        return {}
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    want = predicted(dcn_band=stages * (3 * levels - 2))
    cards = []
    for _ in range(2):
        gpu = dropout_off(copy.deepcopy(model_cpu)).to("cuda", torch.bfloat16).to(memory_format=torch.channels_last)
        launch_counts(reset=True)
        cards.append(step(gpu, torch.device("cuda")))
        used = launch_counts()
        del gpu
        if used != want:
            fail(f"{phase} reference step: launches {used} != predicted {want}")
    own = {}
    reference_verdict(torch, phase, f"{label} full width at {hw}", cards, ref32, run16, scales,
                      f"CPU steps {cpu_s!r} s; launches {({k: v for k, v in used.items() if v})} a card step", own)
    if bounds is not None:
        bounds.update(own)
    gpu = dropout_off(copy.deepcopy(model_cpu)).to("cuda").to(memory_format=torch.channels_last)
    launch_counts(reset=True)
    with plain_versions(), torch.backends.cudnn.flags(enabled=False):  # fp32 convolutions without cuDNN's algorithms
        card32 = step(gpu, torch.device("cuda"))
    del gpu
    if any(launch_counts().values()):
        fail(f"{phase} fp32 gate: the plain route launched {launch_counts()}")
    fp32_verdict(torch, phase, f"{label} full width at {hw}, batch 2", card32, ref32[1.0], own)
    return used


def _rel(torch, a, ref) -> float:
    return float(torch.linalg.vector_norm(a - ref) / torch.linalg.vector_norm(ref).clamp(min=1e-30))


def _step_errs(torch, got, ref):
    """[(name, relative L2)]: a step's loss, then each trainable gradient
    (`got`, `ref`: (loss, {name: grad}))."""
    return [("loss", abs(got[0] - ref[0]) / abs(ref[0]))] + [(n, _rel(torch, got[1][n], ref[1][n])) for n in ref[1]]


def _flat(torch, grads):
    return torch.cat([g.reshape(-1) for g in grads.values()])


def reference_bounds(torch, ref32, run16, scales) -> dict:
    """Phase 3's rule's bounds on a training step: the loss and each
    gradient (by name) twice the largest drift of the CPU bf16 runs
    (`run16[s]` against `ref32[s]`), floor E2E_FLOOR; the concatenated
    gradient twice the unscaled run's drift."""
    plain = [_step_errs(torch, run16[s], ref32[s]) for s in scales]
    out = {n: max(2 * max(p[i][1] for p in plain), E2E_FLOOR) for i, (n, _) in enumerate(plain[0])}
    out["concatenated"] = max(2 * _rel(torch, _flat(torch, run16[1.0][1]), _flat(torch, ref32[1.0][1])), E2E_FLOOR)
    return out


def reference_verdict(torch, phase, what, cards, ref32, run16, scales, tail, bounds=None) -> None:
    """Phase 3's rule on a training step: each card step's loss and every
    trainable gradient (`cards`: [(loss, {name: grad})]) against the fp32
    CPU step (`ref32[1.0]`), each within twice the largest drift of the CPU
    bf16 runs (`run16[s]` against `ref32[s]`, s in `scales`), floor
    E2E_FLOOR; the concatenated gradient within twice the unscaled run's
    drift; and the scaled fp32 runs within 1e-2 of the unscaled one (the
    scaling is no larger change than the drift it samples). Prints the
    line, the first card step in full and the worst reading of each other;
    fails outside the rule. `bounds`, a dict, receives the rule's bound of
    the loss ("loss"), of each gradient (by name) and of the concatenated
    gradient ("concatenated")."""
    plain = [_step_errs(torch, run16[s], ref32[s]) for s in scales]
    moved = max(e for _, e in _step_errs(torch, ref32[scales[1]], ref32[1.0])[1:])
    ratio = lambda r: r[1] / max(2 * r[2], E2E_FLOOR)  # noqa: E731
    ref_flat = _flat(torch, ref32[1.0][1])
    g_plain = _rel(torch, _flat(torch, run16[1.0][1]), ref_flat)
    readings, bad = [], []
    for card in cards:
        card_errs = _step_errs(torch, card, ref32[1.0])
        rows = [(n, e, max(p[i][1] for p in plain), plain[0][i][1]) for i, (n, e) in enumerate(card_errs)]
        bad += [r for r in rows if not (math.isfinite(r[1]) and ratio(r) <= 1.0)]
        readings.append((max(rows, key=ratio), _rel(torch, _flat(torch, card[1]), ref_flat), card[0]))
    ok = not bad and all(g <= max(2 * g_plain, E2E_FLOOR) for _, g, _ in readings) and moved < 1e-2
    if bounds is not None:
        bounds.update(reference_bounds(torch, ref32, run16, scales))
    (worst, g_card, loss), others = readings[0], readings[1:]
    again = "".join(f"; card step {i + 2}: loss {lo!r}, worst err / bound {ratio(w)!r} at {w[0]} (card relative L2 "
                    f"{w[1]!r}), the concatenated gradient {g!r}" for i, (w, g, lo) in enumerate(others))
    say(f"{phase}: reference step, {what}, batch 2, dropout off, card bf16 kernels vs CPU fp32 plain: loss "
        f"{loss!r} vs {ref32[1.0][0]!r}; {len(rows) - 1} trainable gradients; worst err / bound {ratio(worst)!r} "
        f"at {worst[0]} (card relative L2 {worst[1]!r}; plain bf16 {worst[3]!r}, the largest of the three CPU bf16 "
        f"runs {worst[2]!r}; bound max(2 * largest, {E2E_FLOOR})); the concatenated gradient: card {g_card!r}, "
        f"plain bf16 {g_plain!r} (bound max(2 * plain, {E2E_FLOOR})){again}; the {scales[1] - 1.0:.0e} image scaling moves the "
        f"fp32 gradients by at most {moved!r}; {tail}; {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{phase} reference step: {len(bad)} readings outside the bound over {len(cards)} card step(s), e.g. "
             f"{bad[:3]}; concatenated {[g for _, g, _ in readings]!r} vs plain {g_plain!r}; fp32 moved {moved!r}")


def fp32_covered(grads, bounds) -> list:
    """The trainable tensors whose bf16 bound cannot tell noise from a fault
    (ROADMAP Queue C 4): a bound of 1 or more (it passes a zero gradient),
    and every 0-d or 1-element tensor (a gate, whose bf16 drift is one noisy
    sample)."""
    return [n for n, g in grads.items() if bounds.get(n, 0.0) >= 1.0 or g.numel() <= 1]


def fp32_errors(torch, got, ref, names) -> dict:
    """{name: ||got - ref|| / max(||ref||, floor)} over `names`; the floor is
    FP32_SCALE_FLOOR of the norm the tensor would have at the step's
    per-element gradient scale (the RMS over every gradient of `ref`), so a
    gradient that is 0 in exact arithmetic, whose fp32 values are rounding
    noise on both sides, is held at the model's scale."""
    flat = _flat(torch, ref)
    rms = float(torch.linalg.vector_norm(flat)) / math.sqrt(flat.numel())
    out = {}
    for n in names:
        floor = FP32_SCALE_FLOOR * rms * math.sqrt(ref[n].numel())
        out[n] = float(torch.linalg.vector_norm(got[n].float() - ref[n].float())) / max(
            float(torch.linalg.vector_norm(ref[n].float())), floor, 1e-30)
    return out


def fp32_verdict(torch, phase, what, got, ref, bounds, against="the CPU fp32 step") -> int:
    """The second gate of ROADMAP Queue C 4: a training step in fp32 on the
    card through the kernels' plain versions (`ops.kernels.plain_versions`,
    the explicit reference route) against the same step in fp32 elsewhere
    (`against`: on the CPU, or one process where ranks split the batch;
    `got`, `ref`: (loss, {name: gradient})). No bf16 rounding is left, only
    reduction order (the gates' gradients are sums that cancel, so it moves
    them by up to ~4e-2, not fp32's 1e-7) and the backward's atomic adds:
    each tensor of `fp32_covered(ref, bounds)` and the loss must agree
    within FP32_BOUND relative L2 (`fp32_errors`), where a zeroed gradient
    reads 1. Prints the coverage and every reading; fails outside. Returns
    how many tensors it covers."""
    names = fp32_covered(ref[1], bounds)
    errs = fp32_errors(torch, got[1], ref[1], names)
    loss = abs(got[0] - ref[0]) / abs(ref[0])
    bad = [(n, e) for n, e in errs.items() if not (math.isfinite(e) and e <= FP32_BOUND)]
    worst = max(errs.items(), key=lambda kv: kv[1]) if errs else ("none", 0.0)
    loose = sum(bounds.get(n, 0.0) >= 1.0 for n in names)
    say(f"{phase}: fp32 gate (ROADMAP Queue C 4), {what}: the step in fp32 on the card's plain versions vs "
        f"{against}: loss {loss!r}; {len(names)} of {len(ref[1])} trainable tensors covered ({loose} whose bf16 "
        f"bound is 1 or more, {len(names) - loose} more 0-d or 1-element); worst {worst[1]!r} at {worst[0]}; bound "
        f"{FP32_BOUND} relative L2; {'ok' if not bad and loss <= FP32_BOUND else 'FAIL'}; each: "
        + ", ".join(f"{n.split('.', 4)[-1]} {e:.3g}" for n, e in errs.items()))
    if bad or not loss <= FP32_BOUND:
        fail(f"{phase} fp32 gate: {len(bad)} of {len(names)} outside {FP32_BOUND}, e.g. {bad[:4]}; loss {loss!r}")
    return len(names)


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


def phase_train(torch, seed, dataset, bank, smi, bounds=None, model_cpu=None, cpu=None, keep=None):
    """Phase 8: MQ-GLIP-T modulated pre-training at full width on the card
    (`mq_glip_t_pretrain_config`) on phase 7's synthetic LVIS-shaped dataset and
    phase 7's extracted MQ-GLIP-T bank: the reference step, each DCN
    Function's backward, then `train_steps` on the landscape images.
    Returns the launch counts of the timed steps; `bounds`, a dict,
    receives the reference step's bounds. `model_cpu`: the model of
    init_params(seed) where the caller holds one (the train entry takes it
    over), else drawn here. `cpu`: the reference step's CPU runs
    (`train_reference_cpu`) where the caller has them. `keep`, a dict,
    receives the trained model on the card and its config."""
    from mqdet_torch.utils.builders import build_model, init_params, landscape, mq_glip_t_pretrain_config

    cfg = mq_glip_t_pretrain_config()
    model_cpu = init_params(build_model(cfg), seed=seed) if model_cpu is None else model_cpu
    phase_train_reference(torch, cfg, model_cpu, seed, bounds, cpu=cpu)
    bwd_ms = phase_dcn_backward(torch, seed, smi)
    torch.cuda.empty_cache()
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    return train_steps(torch, "phase 8", "MQ-GLIP-T", cfg, model_cpu, landscape(dataset), bank, smi,
                       predicted(dcn_band=stages * (3 * levels - 2)),  # 78 a forward; no bi-attention kernel
                       portrait=landscape(dataset, portrait=True),
                       profiled=("dcn_backward", "`DeformConvFunction`", ("dcn_band_kernel",),
                                 f"level-0 backward alone (CUDA events) {bwd_ms}"), keep=keep)


def train_steps(torch, phase, label, cfg, model_cpu, ds, bank, smi, per_step, portrait=None, out=None,
                profiled=None, keep=None):
    """The timed part of a training phase, through the port's train entry
    (`tools.train.build_training`: model, selector, loader, state, step,
    checkpointer): two warm-up steps, 4 timed steps (launches gated at
    `per_step` a step), one step split by a synchronise at forward /
    backward / update (and the matcher's host time, where the step has
    one), where `profiled` (span, function, fwd_kernels, note) is given
    one profiled step (device busy, idle share, the kernels inside the
    `span` annotations of the `function` backwards, the forward kernels
    named like `fwd_kernels`; phase 8 alone, for the script's time), where
    `portrait` (a dataset of portrait
    images) is given one step on a batch of them in the rotated bucket
    (ROADMAP Queue C 1: its own anchors; loss finite, launches as a step's),
    a checkpoint save and restore; then the gates (losses finite, frozen
    bitwise, every trainable tensor and its EMA, where MODEL_EMA keeps one,
    moved). Returns the launch counts of the timed steps; `out`, a dict,
    receives the median ms per step and the peak memory in GiB; `keep`, a
    dict, the model ("model", on the card) and `cfg` ("cfg")."""
    import numpy as np

    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.engine.train import batch_to_device, step_generator
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.tools.train import build_training

    timed = 4  # 8 before phase 14 joined the script: its time limit
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

    if profiled is not None:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from mqdet_torch.tools.perf_trace import union_us

        span, function, fwd_kernels, note = profiled
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
    if keep is not None:
        keep.update(model=model, cfg=cfg)
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


def gdino_reference_step(torch, cfg, seed):
    """step(model, dev, scale=1.0, assignment=None) -> (loss, {trainable
    name: fp32 gradient on the CPU}, the Hungarian assignment): one
    MQ-GroundingDINO-T training step of phase 9's reference at 256x256,
    batch 2 (40 labels, 8 gt boxes an image), text dropout 0, on the images
    scaled by `scale`, on `assignment` where given."""
    import numpy as np

    from mqdet_torch.core.config import trainable_patterns
    from mqdet_torch.engine.train import batch_to_device, init_train_state, make_gdino_train_step
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

    return step


def gdino_reference_cpu(torch, cfg, model_cpu, seed):
    """The CPU runs of `phase_train_reference_gdino`, under
    MQDET_MSDA_IMPL=pallas_interpret: (the fp32 steps, the bf16 steps, each
    {scale: (loss, gradients)}, every run but the first on the first's
    Hungarian assignment, that assignment, seconds)."""
    step = gdino_reference_step(torch, cfg, seed)
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    with switched("default", msda="pallas_interpret"):
        first = step(dropout_off(copy.deepcopy(model_cpu)), cpu)
        fixed = first[2]
        ref32 = {s: first[:2] if s == 1.0 else step(dropout_off(copy.deepcopy(model_cpu)), cpu, s, fixed)[:2]
                 for s in REFERENCE_SCALES}
        run16 = {s: step(dropout_off(copy.deepcopy(model_cpu).to(torch.bfloat16)), cpu, s, fixed)[:2]
                 for s in REFERENCE_SCALES}
    return ref32, run16, fixed, time.perf_counter() - t0


def phase_train_reference_gdino(torch, cfg, model_cpu, seed, bounds=None, phase="phase 9",
                                label="MQ-GroundingDINO-T", cpu=None):
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
    otherwise. `cpu`: the CPU runs (`gdino_reference_cpu`) where the caller
    has them, else made here. Returns the launch counts of the
    fixed-assignment card step."""
    from mqdet_torch.ops import launch_counts

    hw = (256, 256)
    step = gdino_reference_step(torch, cfg, seed)
    ref32, run16, fixed, cpu_s = cpu if cpu is not None else gdino_reference_cpu(torch, cfg, model_cpu, seed)
    scales = tuple(ref32)
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
        fail(f"{phase} reference step: launches {used} != predicted {want}")
    flips = int((own != fixed).sum())
    reference_verdict(torch, phase, f"{label} full width at {hw}, MSDA clipped on both sides", [card],
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


def phase_train_gdino(torch, seed, dataset, bank, smi, bounds=None, model_cpu=None, cpu=None):
    """Phase 9: MQ-GroundingDINO-T modulated pre-training at full width on
    the card (`train_config_gdino`) on phase 7's dataset and phase 7's
    extracted MQ-GroundingDINO-T bank: the reference step, the MSDA
    Function's backward, then `train_steps` (6 clipped + 6 exact MSDA
    launches a forward, no bi-attention kernel: the fusion's training
    composite). Returns the launch counts of the timed steps; `bounds`, a
    dict, receives the reference step's bounds. `model_cpu`: the model of init_params(seed) where the caller
    holds one (the train entry takes it over), else drawn here. `cpu`: the
    reference step's CPU runs (`gdino_reference_cpu`) where the caller has
    them."""
    from mqdet_torch.utils.builders import build_model, init_params, landscape

    cfg = train_config_gdino()
    model_cpu = init_params(build_model(cfg), seed=seed) if model_cpu is None else model_cpu
    phase_train_reference_gdino(torch, cfg, model_cpu, seed, bounds, cpu=cpu)
    phase_msda_backward(torch, seed, smi)
    g = cfg.GROUNDINGDINO
    return train_steps(torch, "phase 9", "MQ-GroundingDINO-T", cfg, model_cpu, landscape(dataset), bank,
                       smi, predicted(ms_deform_attn_clip=g.enc_layers, ms_deform_attn=g.dec_layers))


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
    4's LVIS protocol with phase 6, phase 7's route (the GLIP-L bank
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
                                                   runs, seed, parts, profile=False)
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
            landscape(vq["dataset"]), vq["bank"], smi, predicted(dcn_band=per_step * (2 if remat else 1)), out=out)
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
    """Phase 7's MQ-GLIP-T on the card (bf16, channels last) and its config:
    a copy of the rank's training model where it holds one (the pretraining
    config builds the same tensors, so init_params(seed) draws the same
    weights)."""
    from mqdet_torch.utils.builders import build_model, init_params, mq_glip_t_config

    cfg = mq_glip_t_config()
    cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 300
    held = _RANK_MODELS.get("glip")
    model = (copy.deepcopy(held) if held is not None else init_params(build_model(cfg), seed=seed)).eval()
    return cfg, model.to(dev, torch.bfloat16).to(memory_format=torch.channels_last)


_RANK_MODELS = {}  # a rank's models on the host, built once for its parts


def fp32_config(cfg):
    """A copy of `cfg` computing in fp32 (phase 13's fp32 gate)."""
    c = cfg.clone()
    c.TPU.COMPUTE_DTYPE = "float32"
    return c


def rank_part_train(torch, spec, dev, rank, world, name):
    """A rank's training part: `name` glip (phase 8's recipe) or gdino
    (phase 9's), on the global batches the parent saved; glip32, the glip
    part's first step in fp32 through the kernels' plain versions (the
    fp32 gate of ROADMAP Queue C 4), on the glip part's model."""
    import numpy as np

    from mqdet_torch.ops.kernels import plain_versions
    from mqdet_torch.utils.builders import build_model, init_params, mq_glip_t_pretrain_config

    base = "gdino" if name == "gdino" else "glip"
    cfg = mq_glip_t_pretrain_config() if base == "glip" else train_config_gdino()
    if base not in _RANK_MODELS:
        _RANK_MODELS[base] = init_params(build_model(cfg), seed=spec["seed"])
    batches = torch.load(spec[f"{base}_batches"], weights_only=False)[:spec.get("steps", 99)]
    assignment = np.load(spec["gdino_assignment"]) if name == "gdino" else None
    save = os.path.join(spec["dir"], f"{spec['tag']}_{name}_rank0_step") if rank == 0 else None
    if name == "glip32":
        with plain_versions():
            return dp_train(torch, fp32_config(cfg), _RANK_MODELS[base], batches[:1], dev, rank, world, save=save)
    return dp_train(torch, cfg, _RANK_MODELS[base], batches, dev, rank, world, assignment, save, timing=spec["timing"])


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
    spec's backend, runs its parts, saves what they return. Where the spec
    has `then` (a spec's changes), rank 0 then joins a world of one over
    that spec's backend on its port and runs its parts too, on the models
    it holds."""
    import torch

    with open(spec_path) as f:
        spec = json.load(f)
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = rank_parts(torch, spec)
    if spec.get("then") and rank == 0:
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_PORT=str(spec["then"]["port"]))
        rank_parts(torch, dict(spec, **spec["then"]))
    return 0


def rank_parts(torch, spec) -> int:
    """`rank_worker`'s group: init, the spec's parts, the result saved,
    the group destroyed; returns the rank."""
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
    return rank


def free_port() -> int:
    """A free TCP port on localhost."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(torch, spec, world, root):
    """Run `world` rank processes of this script over `spec` (RANK, WORLD_SIZE,
    MASTER_* on localhost; LOCAL_RANK 0, every rank on the one card, over
    gloo, and LOCAL_RANK r, a card a rank, over NCCL, which refuses two
    ranks on one device), each within DP_RANK_TIMEOUT_S; one failing ends
    the others and the run. Returns their results in rank order."""
    import subprocess

    spec = dict(spec, dir=root)
    path = os.path.join(root, f"{spec['tag']}_spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(world))
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
    scaled by each of NOISE_SCALES; GDINO's two-stage top-900 selection may flip
    under bf16 rounding at 800x1344, a noise the 256x256 bound does not
    see); the ranks' masters bitwise equal; the frozen parameters unchanged
    on every rank. A step that moved no master is 1 from the one process's
    update. Each tensor's update is printed against the one process's,
    ungated: the first Adam steps move an element by about lr *
    sign(gradient), so a zero-initialised bias whose small gradients flip
    sign under bf16 noise differs by up to 2 lr there (the one process's
    own step is not bitwise repeatable on the card: its backward's atomic
    adds sum in varying order). Returns each tensor's bound, the largest
    over the steps."""
    lines, bad, used = [], [], {}
    for it, want in enumerate(ref["steps"][:len(got[0][name]["metrics"])]):
        mine = torch.load(os.path.join(root, f"{tag}_{name}_rank0_step{it}.pt"), weights_only=False)
        loss = got[0][name]["metrics"][it]["loss_total"]
        dist = step_distances(torch, mine, want, loss, want["loss"])
        noise, noise2 = ref["noise"][it], ref["noise2"][it]
        rows = [(k, d, max(bounds.get(k, E2E_FLOOR), 2 * noise[k])) for k, d in dist.items()]
        w2 = max(d / max(bounds.get(k, E2E_FLOOR), 2 * noise2[k]) for k, d in dist.items())
        used.update({k: max(b, used.get(k, 0.0)) for k, _, b in rows})
        out = [r for r in rows if not (math.isfinite(r[1]) and r[1] <= r[2])]
        bad += [(it + 1, *r) for r in out]
        w = max(rows, key=lambda r: r[1] / r[2])
        by_noise = sum(2 * noise[k] > bounds.get(k, E2E_FLOOR) for k in dist)
        loose = sum(r[2] >= 1.0 for r in rows)  # a relative L2 bound of 1 or more passes a zero gradient
        init = want["init"]
        per_master = max(((n, rel_l2(torch, t - init[n], want["masters"][n] - init[n]))
                          for n, t in mine["masters"].items()), key=lambda r: r[1])
        same = len({r[name]["digest"][it] for r in got}) == 1
        bitwise = got[0][name]["digest"][it] == ref["digest"][it]
        up = [r for r in rows if r[0] == "update"][0]
        lines.append(f"step {it + 1}: loss {loss!r} vs {want['loss']!r}; gradients concatenated "
                     f"{dist['concatenated']!r} (the card's noise {noise['concatenated']!r}); the masters' update "
                     f"concatenated {up[1]!r} (the card's noise {noise['update']!r}, bound {up[2]!r}); worst err / "
                     f"bound {w[1] / w[2]!r} at {w[0]} ({w[1]!r} / {w[2]!r}; with the noise of the first 2 of the "
                     f"{len(NOISE_SCALES)} runs alone {w2!r}); {len(out)} of {len(rows)} outside; "
                     f"{by_noise} bounds set by the card's noise; {loose} bounds at 1 or more (they pass a zero "
                     f"gradient); the most distant tensor's update (ungated) "
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
        return used
    per_rank = "; ".join(f"rank {r['rank']}: warm step {r[name]['warm_ms']!r} ms, peak {r[name]['peak_gib']!r} GiB, "
                         f"split {({k: v * 1000.0 for k, v in r[name]['times'].items()})} ms" for r in got)
    say(f"phase 13: {label} ({smi}; host clock, synchronised; the split synchronised at each boundary): frozen "
        f"parameters unchanged on every rank; {per_rank}; one process at batch {len(ref['batch_rows'])}: warm step "
        f"{ref['warm_ms']!r} ms, peak {ref['peak_gib']!r} GiB, split "
        f"{({k: v * 1000.0 for k, v in ref['times'].items()})} ms")
    return used


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


# the one process's perturbed runs (phase 13, `--cards`): a 2-run estimate of the card's noise read low, on
# `--cards` and on one card (a 0-d gate at 1.134 of its bound), so 4 runs
NOISE_SCALES = (1.0 + 1e-3, 1.0 - 1e-3, 1.0 + 2e-3, 1.0 - 2e-3)


def dp_reference(torch, cfg, model_cpu, batches, dev, root, tag, scales=NOISE_SCALES):
    """The one-process steps on the global batches (`dp_train`, timed),
    their gradients and masters kept on the host, and the initial masters
    (`init`); then the card's own bf16 noise at these shapes, phase 8's rule
    measured here: the same steps on the images scaled by each of `scales`,
    each step's distances (`step_distances`, the masters' update from `init`
    among them) from the unscaled run's, the elementwise largest kept per
    step (`noise`; `noise2`: over the first two scales alone, which
    `dp_verdict` reads beside it)."""
    import numpy as np

    rec = dp_train(torch, cfg, model_cpu, batches, dev, save=os.path.join(root, f"{tag}_one_step"), timing=True)
    init = torch.load(os.path.join(root, f"{tag}_one_stepinit.pt"), weights_only=False)
    steps = [dict(torch.load(os.path.join(root, f"{tag}_one_step{it}.pt"), weights_only=False),
                  loss=rec["metrics"][it]["loss_total"], init=init) for it in range(len(batches))]
    noise, noise2 = [{} for _ in batches], None
    for n, scale in enumerate(scales):
        if n == 2:
            noise2 = [dict(d) for d in noise]
        scaled = [dict(b, images=(b["images"] * np.float32(scale)).astype(np.float32)) for b in batches]
        run = dp_train(torch, cfg, model_cpu, scaled, dev, assignment=rec["assignment"],
                       save=os.path.join(root, f"{tag}_noise_step"))
        for it, want in enumerate(steps):
            mine = torch.load(os.path.join(root, f"{tag}_noise_step{it}.pt"), weights_only=False)
            d = step_distances(torch, mine, want, run["metrics"][it]["loss_total"], want["loss"])
            noise[it] = {k: max(v, noise[it].get(k, 0.0)) for k, v in d.items()}
    return dict(rec, steps=steps, noise=noise, noise2=noise2 or noise,
                batch_rows=list(range(len(batches[0]["images"]))))


def phase_data_parallel(torch, seed, smi, glip_vq, gdino_vq, glip_bounds, gdino_bounds, glip_model=None,
                        gdino_model=None):
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
    `init_distributed`, in rank 0's process once its gloo group is
    destroyed: its models are built): one GLIP step against the one process's first by
    the same rule. Returns the launch counts, each path's summed over its
    ranks. `glip_model`, `gdino_model`: the models of init_params(seed)
    where the caller holds them (not changed), else drawn here."""
    import numpy as np

    from mqdet_torch.mq.bank import QueryBank
    from mqdet_torch.ops.kernels import plain_versions
    from mqdet_torch.utils.builders import build_model, init_params, landscape, mq_glip_t_pretrain_config

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="mqdet_dp_")
    ds = landscape(glip_vq["dataset"])

    glip_cfg = mq_glip_t_pretrain_config()
    glip_batches = loader_batches(glip_cfg, ds, glip_vq["bank"], 2)
    torch.save(glip_batches, os.path.join(root, "glip_batches.pt"))
    glip_model = glip_model if glip_model is not None else init_params(build_model(glip_cfg), seed=seed)
    glip_ref = dp_reference(torch, glip_cfg, glip_model, glip_batches, dev, root, "one_glip")
    with plain_versions():  # the fp32 gate's one process: the first global batch, fp32, no launch
        one32 = dp_train(torch, fp32_config(glip_cfg), glip_model, glip_batches[:1], dev,
                         save=os.path.join(root, "one_glip32_step"))
    del glip_model
    torch.cuda.empty_cache()
    gdino_cfg = train_config_gdino()
    gdino_batches = loader_batches(gdino_cfg, ds, gdino_vq["bank"], 1)
    torch.save(gdino_batches, os.path.join(root, "gdino_batches.pt"))
    if gdino_model is None:
        gdino_model = init_params(build_model(gdino_cfg), seed=seed)
    gdino_ref = dp_reference(torch, gdino_cfg, gdino_model, gdino_batches, dev,
                             root, "one_gdino")
    np.save(os.path.join(root, "gdino_assignment.npy"), gdino_ref["assignment"])
    glip_vq["bank"].save(os.path.join(root, "glip_bank.npz"))
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_phase

    spec = {"seed": seed, "backend": "gloo", "tag": "gloo", "parts": ["glip", "glip32", "gdino", "eval"],
            "timing": True,
            "glip_batches": os.path.join(root, "glip_batches.pt"), "gdino_batches": os.path.join(root,
                                                                                              "gdino_batches.pt"),
            "gdino_assignment": os.path.join(root, "gdino_assignment.npy"),
            "glip_bank": os.path.join(root, "glip_bank.npz"), "bank_path": os.path.join(root, "extracted.npz"),
            # then NCCL at world 1 in rank 0's process, on the models it holds: one GLIP step
            "then": {"backend": "nccl", "tag": "nccl", "parts": ["glip"], "steps": 1, "timing": False,
                     "port": free_port()}}
    t0 = time.perf_counter()
    got = spawn_ranks(torch, spec, DP_RANKS, root)
    ranks_s = time.perf_counter() - t0
    if any(r["backend"] != "gloo" or r["world"] != DP_RANKS for r in got):
        fail(f"phase 13: ranks report {[(r['backend'], r['world']) for r in got]}")
    say(f"phase 13: {DP_RANKS} rank processes over gloo on the one card ({smi}), LOCAL_RANK 0 for both; "
        f"{ranks_s!r} s; seconds by part {[r['seconds'] for r in got]}")
    used = dp_verdict(torch, "MQ-GLIP-T training", glip_ref, got, root, "gloo", "glip", glip_bounds, smi)
    mine, want = (torch.load(os.path.join(root, f), weights_only=False)
                  for f in ("gloo_glip32_rank0_step0.pt", "one_glip32_step0.pt"))
    if any(any(r["glip32"]["launches"].values()) for r in got) or any(one32["launches"].values()):
        fail("phase 13 fp32 gate: the plain route launched a kernel")
    fp32_verdict(torch, "phase 13", f"MQ-GLIP-T, {DP_RANKS} ranks of 1 image over gloo against one process at batch "
                 f"{DP_RANKS}, the first global batch at 800x1344, covering phase 13's bounds",
                 (got[0]["glip32"]["metrics"][0]["loss_total"], mine["grads"]),
                 (one32["metrics"][0]["loss_total"], want["grads"]), used,
                 against=f"one process's fp32 step on the card at batch {DP_RANKS}")
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

    # NCCL at world 1 (rank 0's process after the gloo group): one GLIP step through init_distributed, the one
    # process's first under the same rule
    one = torch.load(os.path.join(root, "nccl_rank0.pt"), weights_only=False)
    if one["backend"] != "nccl" or one["world"] != 1:
        fail(f"phase 13: the NCCL rank reports backend {one['backend']}, world {one['world']}")
    dp_verdict(torch, "MQ-GLIP-T training through init_distributed('cuda', 'nccl')", glip_ref, [one], root, "nccl",
               "glip", glip_bounds, smi)
    say(f"phase 13: the NCCL rank: launches {({k: v for k, v in one['glip']['launches'].items() if v})} "
        f"(predicted {({k: v for k, v in per_step.items() if v})}); {one['seconds']['glip']!r} s")
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


# ---- phase 14: MQ-Det's model switches --------------------------------------

S1_VISION_QUERY = dict(NO_CAT=False, ADD_ADAPT_LAYER=True, SHARE_KV=True, AUGMENT_IMAGE_WITH_QUERY=True,
                       NEW_MASK_TOKEN=True, ADD_VISION_LAYER=True, QUERY_FUSION=True, LEARNABLE_BANK=True)
GATE_SWITCHES = {"CONDITION_GATE off": ("CONDITION_GATE", False), "NONLINEAR_GATE off": ("NONLINEAR_GATE", False),
                 "FIX_ATTN_GATE 0.25": ("FIX_ATTN_GATE", 0.25)}


def switch_config(cfg, name):
    """A copy of `cfg` under phase 14's switch set `name`: "S1" (every
    switch of S1_VISION_QUERY, ADD_LINEAR_LAYER and MLM_LOSS), a fuse type
    ("MHA-S", "SCAN", "FILM"), "S8" (EARLY_FUSE_ON,
    USE_FUSED_FEATURES_DOT_PRODUCT, USE_DFCONV, USE_DYFUSE and USE_DYRELU
    off) or "FPN GN+ReLU" (MODEL.FPN.USE_GN and USE_RELU on)."""
    c = cfg.clone()
    dy = c.MODEL.DYHEAD
    fc = dy.FUSE_CONFIG
    if name == "S1":
        for k, v in S1_VISION_QUERY.items():
            c.VISION_QUERY[k] = v
        fc.ADD_LINEAR_LAYER = fc.MLM_LOSS = True
    elif name == "S8":
        fc.EARLY_FUSE_ON = fc.USE_FUSED_FEATURES_DOT_PRODUCT = False
        dy.USE_DFCONV = dy.USE_DYFUSE = dy.USE_DYRELU = False
    elif name == "FPN GN+ReLU":
        c.MODEL.FPN.USE_GN = c.MODEL.FPN.USE_RELU = True
    else:
        fc.TYPE = name
    return c


def bank_indices(bank, shape, seed):
    """`shape` (B, V) of seeded int32 (row, slot) indices into the learnable
    bank of `bank` (`QuerySelector.bank_table`'s rows: the labels sorted),
    each a slot its class holds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    held = np.asarray([bank.count(lab) * bank.num_scales for lab in sorted(bank.labels)])
    rows = rng.integers(0, len(held), shape)
    slots = (rng.random(shape) * held[rows]).astype(np.int64)
    return np.stack([rows, slots], -1).astype(np.int32)


def init_like(model, donor, seed):
    """`model` with every tensor that `donor` holds under the same name and
    shape copied from it, and the others filled by init_params' rule from
    `seed` (a generator of their own): a switch's model takes the weights
    it shares with one built before it (the towers, most of the head)
    without drawing them again; `init_params` of a full-width MQ-GLIP-T
    draws 277M normals on the host, ~7 s."""
    from mqdet_torch.utils.builders import init_params

    theirs, own = donor.state_dict(), model.state_dict()
    shared = {k: theirs[k] for k, t in own.items() if k in theirs and theirs[k].shape == t.shape}
    model.load_state_dict(shared, strict=False)
    return init_params(model, seed=seed, keys=set(own) - set(shared))


def switch_model(torch, cfg, seed, selector, donor=None):
    """MQ-GLIP under `cfg`, on the CPU in fp32, eval: init_params(seed), or
    with `donor` `init_like` it; under LEARNABLE_BANK the bank sized and
    filled from `selector` (`install_learnable_bank`)."""
    from mqdet_torch.utils.builders import build_model, init_params, install_learnable_bank

    learnable = cfg.VISION_QUERY.LEARNABLE_BANK
    model = build_model(cfg, bank_shape=selector.bank_table_shape() if learnable else None)
    model = init_params(model, seed=seed) if donor is None else init_like(model, donor, seed)
    if learnable:
        install_learnable_bank(model, selector)
    return model.eval()


def on_card(torch, model):
    return copy.deepcopy(model).to("cuda", torch.bfloat16).to(memory_format=torch.channels_last)


def phase_switch_reference(torch, label, cfg, model_cpu, model_gpu, seed, want, bank=None, phase="phase 14"):
    """Phase 14's reference check, phase 3's rule: one forward at 256x256,
    one chunk of 40 labels x 5 queries (the learnable bank's indices where
    `bank` is given; no queries where VISION_QUERY.ENABLED is off, as for
    the CLIP and RNN towers), the card (bf16, kernels) against the CPU fp32
    plain path by relative L2 within twice the CPU bf16 drift (floor
    E2E_FLOOR), on the 5 dot-product logit levels, the 5 box-regression
    levels and, under MLM_LOSS, `mlm_logits`; the launches gated at `want`.
    The card runs the forward twice, each gated, and the line gives both
    readings and whether they are bitwise equal (a reading near its bound
    is safe only if the card repeats it); `phase` names the lines. Returns
    the first forward's launches."""
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import synthetic_batch

    hw = (256, 256)
    batch = synthetic_batch(cfg, batch=1, image_hw=hw, num_labels=40, k_shot=5, seed=seed + 1)
    if bank is not None:
        batch["queries"] = bank_indices(bank, batch["queries"].shape[:2], seed)
    image = torch.from_numpy(batch["images"]).permute(0, 3, 1, 2).contiguous()
    keys = ("input_ids", "attention_mask") + (("queries", "query_mask") if cfg.VISION_QUERY.ENABLED else ())
    text = [torch.from_numpy(batch[k]) for k in keys]

    def run(model, dev):
        with torch.inference_mode():
            out = model(image.to(dev), *(t.to(dev) for t in text))
        outs = [d.float().cpu() for d in out["dot_product_logits"]] + [b.float().cpu() for b in out["bbox_reg"]]
        return outs + ([out["mlm_logits"].float().cpu()] if "mlm_logits" in out else [])

    t0 = time.perf_counter()
    ref, plain16 = run(model_cpu, "cpu"), run(copy.deepcopy(model_cpu).to(torch.bfloat16), "cpu")
    cpu_s = time.perf_counter() - t0
    launch_counts(reset=True)
    card = run(model_gpu, torch.device("cuda"))
    used = launch_counts()
    if used != want:
        fail(f"{phase} {label}: reference forward launches {used} != predicted {want}")
    again = run(model_gpu, torch.device("cuda"))
    names = [f"logits{i}" for i in range(5)] + [f"bbox{i}" for i in range(5)] + ["mlm_logits"][:len(ref) - 10]
    worst = compare_to_reference(torch, f"{phase} {label}", names, ref, plain16, card)
    second = compare_to_reference(torch, f"{phase} {label} (second card forward)", names, ref, plain16, again)
    same = all(torch.equal(a, b) for a, b in zip(card, again))
    say(f"{phase}: reference check, MQ-GLIP-T under {label}, full width at {hw}, card bf16 kernels vs CPU fp32 "
        f"plain on 5 logit and 5 box levels{' and mlm_logits' if len(names) > 10 else ''}: worst err / bound "
        f"{worst[0]!r} at {worst[1]} (card relative L2 {worst[2]!r}, "
        f"plain bf16 {worst[3]!r}; bound max(2 * plain, {E2E_FLOOR})); a second card forward {second[0]!r} at "
        f"{second[1]}, bitwise the first: {same}; CPU runs {cpu_s!r} s; launches "
        f"{({k: v for k, v in used.items() if v})} (predicted {({k: v for k, v in want.items() if v})}); ok")
    return used


def phase_gate_switches(torch, seed, donor):
    """Phase 14: CONDITION_GATE off, NONLINEAR_GATE off and FIX_ATTN_GATE
    0.25, each on the full-width language tower alone (BERT-base, 6 GCP
    blocks, PreSelect), the weights it shares with `donor` (the language
    tower of a model under the default gates) taken from it, its gate drawn
    from `seed` (`init_like`): 256 tokens, 200 queries, the 341 image tokens
    of a 256x256 image, by phase 3's rule on the hidden states and the
    aggregate. No hand-written kernel may launch."""
    import numpy as np

    from mqdet_torch.models.bert import LanguageBackbone, gate_telemetry
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import mq_glip_t_config, synthetic_batch

    base = mq_glip_t_config()
    b = synthetic_batch(base, batch=1, image_hw=(256, 256), num_labels=40, k_shot=5, seed=seed + 3)
    width = base.MODEL.BACKBONE.OUT_CHANNELS
    image_tokens = np.random.default_rng(seed + 3).standard_normal((1, 341, width)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (b["input_ids"], b["attention_mask"], b["queries"], b["query_mask"],
                                          image_tokens)]

    def run(tower, dev):
        dtype = next(tower.parameters()).dtype  # the queries and image tokens in the compute dtype, as MQGLIP's
        with torch.inference_mode(), gate_telemetry() as gates:
            out = tower(*(a.to(dev, dtype) if a.is_floating_point() else a.to(dev) for a in args))
        return [out["hidden"].float().cpu(), out["aggregate"].float().cpu()], [float(g) for g in gates]

    for name, (key, value) in GATE_SWITCHES.items():
        c = base.clone()
        c.VISION_QUERY[key] = value
        t0 = time.perf_counter()
        tower = init_like(LanguageBackbone(c), donor, seed).eval()
        build_s = time.perf_counter() - t0
        (ref, gates), (plain16, _) = run(tower, "cpu"), run(copy.deepcopy(tower).to(torch.bfloat16), "cpu")
        launch_counts(reset=True)
        card, card_gates = run(tower.to("cuda", torch.bfloat16), torch.device("cuda"))
        used = {k: v for k, v in launch_counts().items() if v}
        worst = compare_to_reference(torch, f"phase 14 {name}", ["hidden", "aggregate"], ref, plain16, card)
        say(f"phase 14: reference check, the language tower under {name}, full width: worst err / bound "
            f"{worst[0]!r} at {worst[1]} (card relative L2 {worst[2]!r}, plain bf16 {worst[3]!r}); gate "
            f"telemetry, mean |gate| per block, CPU fp32 {gates!r}, card {card_gates!r}; hand-written kernel "
            f"launches {used}; built in {build_s!r} s; ok")
        if used:
            fail(f"phase 14 {name}: the language tower launched {used}")
        del tower


def indexed(make_batch, bank):
    """`make_batch` with its queries replaced by the learnable bank's indices."""
    def make(cfg, batch, image_hw, num_labels=40, k_shot=5, seed=0):
        out = make_batch(cfg, batch, image_hw, num_labels, k_shot, seed)
        out["queries"] = bank_indices(bank, out["queries"].shape[:2], seed)
        return out

    return make


def recording_evaluator(**kw):
    """A DetectionEvaluator(**kw) that keeps every image's detections (`dets`)."""
    from mqdet_torch.engine.evaluator import DetectionEvaluator

    class Recording(DetectionEvaluator):
        def add_image(self, image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **k):
            self.dets[image_id] = (det_boxes.copy(), det_scores.copy(), det_labels.copy())
            super().add_image(image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **k)

    ev = Recording(**kw)
    ev.dets = {}
    return ev


def phase_switch_telemetry(torch, cfg, model_cpu, model_gpu, selector, dataset, freq, per_image):
    """Phase 14: `run_inference` under RETURN_ATTN_GATE_VALUE on 2 of phase
    7's images, the S1 model with the learnable bank (its plan carries the
    int32 indices), phase 7's settings: `attn_gate_value` within 1e-2
    relative of the same model's on the CPU in fp32 (group 0 on image 0,
    the representative forward, with the head's stages cut: every GCP block
    runs before them), the detections bitwise those of the same run without
    the flag, launches 2 images' plus the one representative forward's."""
    import numpy as np

    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.data.transforms import EvalTransform
    from mqdet_torch.engine.inference import ChunkedEvaluationPlan, chunk_groups, group_inputs, run_inference
    from mqdet_torch.models.bert import gate_telemetry
    from mqdet_torch.ops import launch_counts

    c = vq_settings(cfg)
    tok = WordPieceTokenizer()
    runs = {}
    for flag in (True, False):
        c.VISION_QUERY.RETURN_ATTN_GATE_VALUE = flag
        ev = recording_evaluator(style="lvis_fixed", max_dets=300, category_frequency=freq)
        torch.cuda.synchronize()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        res = run_inference(c, model_gpu, dataset, tok, selector, evaluator=ev, max_images=2, verbose=False)
        torch.cuda.synchronize()
        runs[flag] = (res, ev.dets, launch_counts(), time.perf_counter() - t0)
    plan = ChunkedEvaluationPlan(c, dataset, tok, selector)
    g0 = group_inputs(c, plan, chunk_groups(plan, c.TEST.CHUNK_PARALLELISM)[:1], "cpu")[0]
    image, _, _ = EvalTransform(c)(dataset.load_image(dataset.ids[0]), torch.device("cpu"))
    head = model_cpu.rpn.head
    stages, head.num_convs = head.num_convs, 0
    try:
        with torch.inference_mode(), gate_telemetry() as gates:
            model_cpu.forward_head(model_cpu.encode_image(image), g0["input_ids"], g0["attention_mask"],
                                   g0["queries"], g0["query_mask"])
    finally:
        head.num_convs = stages
    cpu_gate = float(np.mean([float(g) for g in gates]))
    (res, dets, used, secs), (res_off, dets_off, used_off, secs_off) = runs[True], runs[False]
    gate = res.get("attn_gate_value")
    same = dets.keys() == dets_off.keys() and all(
        all(np.array_equal(a, b) for a, b in zip(d, dets_off[k])) for k, d in dets.items())
    want = {k: 2 * v for k, v in per_image.items()}
    want_flag = {k: v + per_image[k] // 8 for k, v in want.items()}  # + group 0's forward (8 groups an image)
    say(f"phase 14: run_inference under RETURN_ATTN_GATE_VALUE, S1 with the learnable bank (plan queries "
        f"{plan.queries.dtype} {plan.queries.shape}), 2 of phase 7's images: attn_gate_value card {gate!r}, CPU fp32 "
        f"{cpu_gate!r} ({len(gates)} GCP blocks; relative {abs(gate - cpu_gate) / abs(cpu_gate)!r}, bound 1e-2); "
        f"{sum(len(d[1]) for d in dets.values())} detections bitwise those of the run without the flag: {same}; "
        f"AP {res.get('AP')!r} / {res_off.get('AP')!r}; {secs!r} s / {secs_off!r} s; launches "
        f"{({k: v for k, v in used.items() if v})} (predicted {({k: v for k, v in want_flag.items() if v})}) and "
        f"{({k: v for k, v in used_off.items() if v})}")
    if gate is None or not abs(gate - cpu_gate) <= 1e-2 * abs(cpu_gate):
        fail(f"phase 14: attn_gate_value {gate!r} vs the CPU's {cpu_gate!r}")
    if not same or "attn_gate_value" in res_off:
        fail("phase 14: the flag changed the detections, or the run without it reports a gate value")
    if used != want_flag or used_off != want:
        fail(f"phase 14 run_inference: launches {used} / {used_off} != predicted {want_flag} / {want}")
    return {"phase 14 run_inference": used}


def s1_train_config(bank, seed):
    """(phase 14's S1 training config: recipe vision_query_v5 on phase 8's,
    `edit`: the reference step's batch with the learnable bank's indices of
    `bank` as its queries)."""
    from mqdet_torch.utils.builders import mq_glip_t_pretrain_config

    cfg = switch_config(mq_glip_t_pretrain_config(), "S1")
    cfg.SOLVER.TUNING_HIGHLEVEL_OVERRIDE = "vision_query_v5"

    def edit(batch):
        batch["queries"] = bank_indices(bank, batch["queries"].shape[:2], seed)

    return cfg, edit


def s1_selector(bank):
    """Phase 14's selector over `bank`: 5 queries, 40 labels, indices into
    the learnable bank."""
    from mqdet_torch.mq.selector import QuerySelector

    return QuerySelector(bank, num_query_per_class=5, max_labels=40, emit_indices=True)


def phase_switch_train(torch, seed, smi, dataset, bank, model_cpu, cpu=None):
    """Phase 14: S1 training with recipe vision_query_v5 (phase 8's recipe
    otherwise) on phase 7's dataset (its landscape images) and bank, the
    learnable bank filled from it and the loader's selector emitting its
    indices. The reference step at 256x256 under phase 8's rule (the batch's
    queries the bank's indices); then 3 steps at batch 2, 800x1344, each
    timed (host clock, synchronised), launches gated at 78 `dcn_band` a
    step; gates: every loss term (`loss_mlm` among them) finite, the bank
    entries with a query moved, every entry no batch names bitwise
    unchanged (under AUGMENT_IMAGE_WITH_QUERY the padded slots, index
    (0, 0), condition the image tokens, so that entry may move too), the
    frozen parameters bitwise unchanged. The MLM head's share: its forward,
    `mlm_loss` and their backward at the step's shapes (B 2, T 256), CUDA
    events, over the step's time. `model_cpu`: the S1 model of the
    reference checks (the training settings change no parameter), on the
    CPU in fp32. `cpu`: the reference step's CPU runs where the CPU
    reference worker made them. Returns the launches of the 3 steps."""
    import numpy as np

    from mqdet_torch.core.config import frozen_patterns, trainable_patterns
    from mqdet_torch.data.loader import GroundingTrainLoader
    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.engine.losses import mlm_loss
    from mqdet_torch.engine.train import batch_to_device, init_train_state, make_train_step, step_generator
    from mqdet_torch.mq.selector import QuerySelector
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import landscape

    cfg, edit = s1_train_config(bank, seed)
    vq = cfg.VISION_QUERY
    selector = QuerySelector(bank, num_query_per_class=vq.NUM_QUERY_PER_CLASS, pure_text_rate=vq.PURE_TEXT_RATE,
                             random_kshot=vq.RANDOM_KSHOT, max_labels=vq.MAX_CLASSES_PER_PROMPT, emit_indices=True)
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    per_step = predicted(dcn_band=stages * (3 * levels - 2))

    phase_train_reference(torch, cfg, model_cpu, seed, phase="phase 14", label="MQ-GLIP-T under S1, vision_query_v5",
                          edit=edit, cpu=cpu)
    dev = torch.device("cuda")
    model = on_card(torch, model_cpu)
    loader = GroundingTrainLoader(landscape(dataset), cfg, WordPieceTokenizer(), selector)
    state, tx = init_train_state(model, cfg, trainable_patterns(cfg), frozen_patterns(cfg))
    step = make_train_step(model, tx, cfg)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if n in state.frozen}
    bank0 = state.trainable["qv_layer_learnable_bank"].clone()
    named, with_query, losses, ms, used = set(), set(), [], [], {k: 0 for k in per_step}
    torch.cuda.reset_peak_memory_stats()
    batches = iter(loader)
    for _ in range(3):
        b = next(batches)
        b.pop("num_positive")
        q = b["queries"].reshape(-1, 2)
        qm = b["query_mask"].reshape(len(q), -1)
        named |= {tuple(int(i) for i in r) for r in q}
        with_query |= {tuple(int(i) for i in r) for r, m in zip(q, qm) if m.any()}
        launch_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, batch_to_device(b, dev), step_generator(cfg.SOLVER.SEED, state.step, dev))
        losses.append({k: float(v) for k, v in metrics.items()})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1000.0)
        counts = launch_counts()
        if counts != per_step:
            fail(f"phase 14 S1 training: step launches {counts} != predicted {per_step}")
        used = {k: used[k] + v for k, v in counts.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30

    head, lb = model.rpn.head.mlm_head, cfg.MODEL.LANGUAGE_BACKBONE
    x = torch.randn(2, lb.MAX_QUERY_LEN, lb.LANG_DIM, device=dev, dtype=torch.bfloat16, requires_grad=True)
    shape = tuple(x.shape[:2])
    labels = torch.where(torch.rand(shape, device=dev) < 0.15, torch.randint(0, lb.VOCAB_SIZE, shape, device=dev),
                         torch.full(shape, -100, device=dev))
    mlm_times = []
    for _ in range(6):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        mlm_loss(head(x), labels).backward()
        e1.record()
        torch.cuda.synchronize()
        mlm_times.append(e0.elapsed_time(e1))
    mlm_ms = statistics.median(mlm_times[1:])

    bank1 = state.trainable["qv_layer_learnable_bank"]
    rows, slots = bank1.shape[:2]
    unnamed = [(r, s) for r in range(rows) for s in range(slots) if (r, s) not in named]
    moved = [ix for ix in with_query if not torch.equal(bank1[ix], bank0[ix])]
    still = [ix for ix in unnamed if torch.equal(bank1[ix], bank0[ix])]
    params = dict(model.named_parameters())
    changed = [n for n in frozen if not torch.equal(params[n], frozen[n])]
    say(f"phase 14: S1 training, vision_query_v5 ({len(state.trainable)} trainable tensors: the GCP pieces, "
        f"tunable_linear, the learnable bank {tuple(bank1.shape)}), batch 2, 800x1344 ({smi}): ms per step "
        f"{ms!r} (host clock, synchronised; the first includes its warm-up), peak {peak!r} GiB; the MLM head's "
        f"forward, loss and backward at (2, 256) {mlm_ms!r} ms (CUDA events, median of 5), a share "
        f"{mlm_ms / statistics.median(ms[1:])!r} of the median later step; losses of the last step {losses[-1]}; "
        f"bank entries named by the batches {len(named)} (with a query {len(with_query)}, moved {len(moved)}); "
        f"entries named by no batch {len(unnamed)}, bitwise unchanged {len(still)}; frozen tensors "
        f"{len(frozen)}, changed {len(changed)}; launches {({k: v for k, v in used.items() if v})}")
    if not all(np.isfinite(v) for rec in losses for v in rec.values()) or "loss_mlm" not in losses[-1]:
        fail(f"phase 14 S1 training: a loss term is not finite or loss_mlm is missing: {losses}")
    if len(moved) != len(with_query) or not with_query:
        fail(f"phase 14 S1 training: {len(with_query) - len(moved)} bank entries with a query did not move")
    if len(still) != len(unnamed):
        fail(f"phase 14 S1 training: {len(unnamed) - len(still)} bank entries no batch named moved")
    if changed:
        fail(f"phase 14 S1 training: frozen parameters changed: {changed[:5]}")
    del model, state, step, loader, frozen
    torch.cuda.empty_cache()
    return used


def phase_switches(torch, seed, runs, smi, glip_vq, cpu=None):
    """Phase 14: MQ-Det's model switches on the card, MQ-GLIP-T at full
    width, S1 and MHA-S from init_params(seed), SCAN, FILM, S8, the FPN
    under MODEL.FPN.USE_GN and USE_RELU and the gate switches' language
    towers `init_like` the MHA-S model (their shared weights copied, not
    drawn again). The reference checks (phase 3's rule) at 256x256 of S1
    (`switch_config`; the learnable bank from phase 7's bank), MHA-S, SCAN,
    FILM, S8 and "FPN GN+ReLU", each a whole model, and of the three gate
    switches on the language tower alone; the LVIS protocol (phase 4,
    without phase 5's profile) under S1, MHA-S and FILM, launches gated
    (624 `dcn_band` in all three; 48 `bi_attention` under S1, 0 under
    MHA-S and FILM); `run_inference` under RETURN_ATTN_GATE_VALUE
    (`phase_switch_telemetry`); S1 training (`phase_switch_train`; `cpu(S1
    model)`: its reference step's CPU runs from the CPU reference worker,
    else made here). Returns the launch counts of its counted paths."""
    from mqdet_torch.utils.builders import mq_glip_t_config, synthetic_batch

    t_phase = time.perf_counter()
    bank = glip_vq["bank"]
    base = mq_glip_t_config()
    base.MODEL.ATSS.DETECTIONS_PER_IMG = 300
    selector = s1_selector(bank)
    stages, levels = base.MODEL.DYHEAD.NUM_CONVS, len(base.MODEL.RPN.ANCHOR_STRIDE)
    dcn = stages * (3 * levels - 2)
    launches, keep, donor = {}, {}, None
    for name in ("S1", "MHA-S", "SCAN", "FILM", "S8", "FPN GN+ReLU"):  # the last four init_like MHA-S
        cfg = switch_config(base, name)
        t0 = time.perf_counter()
        model_cpu = switch_model(torch, cfg, seed, selector, donor)
        say(f"phase 14: MQ-GLIP-T under {name} built on the host in {time.perf_counter() - t0!r} s"
            f"{' (init_like the MHA-S model)' if donor is not None else ''}")
        model = on_card(torch, model_cpu)
        want = predicted(dcn_band=0 if name == "S8" else dcn,
                         bi_attention=stages if name in ("S1", "FPN GN+ReLU") else 0)
        launches[f"phase 14 {name} reference"] = phase_switch_reference(
            torch, name, cfg, model_cpu, model, seed, want, bank if name == "S1" else None)
        if name in ("S1", "MHA-S", "FILM"):
            keep[name] = (cfg, model, model_cpu if name == "S1" else None)
        else:
            del model
        if name == "MHA-S":
            donor = model_cpu
        del model_cpu
    phase_gate_switches(torch, seed, donor.language_backbone)
    del donor
    torch.cuda.empty_cache()
    groups = -(-31 // 4)
    for name, (cfg, model, _) in keep.items():
        want = predicted(dcn_band=groups * dcn, bi_attention=groups * stages if name == "S1" else 0)
        make = indexed(synthetic_batch, bank) if name == "S1" else synthetic_batch
        launches[f"phase 14 {name} protocol"] = phase_protocol(
            torch, f"MQ-GLIP-T under {name}", model, cfg, make, 300, want, runs, seed, profile=False,
            phase="phase 14")
    cfg, model, model_cpu = keep.pop("S1")
    keep.clear()
    torch.cuda.empty_cache()
    ds = glip_vq["dataset"]
    freq = {ds.cat_id_to_contiguous[c["id"]]: c["frequency"] for c in ds.categories}
    launches.update(phase_switch_telemetry(torch, cfg, model_cpu, model, selector, ds, freq,
                                           predicted(dcn_band=groups * dcn, bi_attention=groups * stages)))
    del model
    torch.cuda.empty_cache()
    launches["phase 14 S1 training"] = phase_switch_train(torch, seed, smi, ds, bank, model_cpu,
                                                          cpu(model_cpu) if cpu else None)
    say(f"phase 14: {time.perf_counter() - t_phase!r} s in all")
    return launches


# ---- phase 15: test-time augmentation, knowledge prompts, towers, Swin versions

TTA_BUCKETS = ((608, 1024), (800, 1344), (1216, 2016))  # the buckets TEST.SCALES' 480x640 images resize into
TTA_CLASSES = 160  # one chunk group: 4 chunks of 40 at CP 4


@contextlib.contextmanager
def launches_seen(seen):
    """Inside the block, seen(kernel, args, kw, output) after every launch of
    the band DCN, the bi-attention and the MSDA kernels: the ops modules'
    launchers (`_launch_band`, the bi-attention `_launch`, the MSDA
    `_launch`) are wrapped, every launch still counted by its own counter."""
    from mqdet_torch.ops import bi_attention as ba
    from mqdet_torch.ops import deform_conv as dc
    from mqdet_torch.ops import ms_deform_attn as ms

    def msda(v, shapes, loc, attn, clip=False):
        return "ms_deform_attn_clip" if clip else "ms_deform_attn"

    rules = ((dc, "_launch_band", lambda *a, **kw: "dcn_band"), (ba, "_launch", lambda *a, **kw: "bi_attention"),
             (ms, "_launch", msda))
    saved = []
    for mod, attr, name_of in rules:
        original = getattr(mod, attr)

        def launcher(*args, _original=original, _name_of=name_of, **kw):
            out = _original(*args, **kw)
            seen(_name_of(*args, **kw), args, kw, out)
            return out

        saved.append((mod, attr, original))
        setattr(mod, attr, launcher)
    try:
        yield
    finally:
        for mod, attr, original in saved:
            setattr(mod, attr, original)


def first_launches(keep):
    """Inside the block, the first launch of each kernel at each input shape
    is kept in `keep`, {(kernel, shapes...): (args, output)} (`launches_seen`)."""
    def shape(t):
        return tuple(t.shape)

    def seen(name, args, kw, out):
        if name == "dcn_band":
            key = (name, shape(args[0]), args[5])  # x, stride
        else:  # bi-attention q, k; MSDA value, sampling locations
            key = (name, shape(args[0]), shape(args[2] if name.startswith("ms_") else args[1]))
        keep.setdefault(key, (args, out))

    return launches_seen(seen)


def kept_launch_check(torch, label, where, key, args, out, phase="phase 15", tag="TTA", items=None):
    """One kept launch (`first_launches`) against its plain version in fp32
    on the card on the same inputs, by phase 2's rule; with `items` (batch
    indices) on those items of the batch alone, the plain version run on
    them (phase 17: the plain versions cannot hold a head batch of 16 or
    32), its bf16 time taken on them too. Returns (the kernel's case record,
    the line)."""
    from mqdet_torch.ops import bi_attention as ba
    from mqdet_torch.ops import deform_conv as dc
    from mqdet_torch.ops import ms_deform_attn as ms
    from mqdet_torch.tools import cuda_time_ms

    name = key[0]
    if name == "dcn_band":
        x, off, m, w, b, stride, radius = args[:7]
        ins, outs, launcher = (x, off, m, w, b), (out,), dc._launch_band  # b may be None
        per_item = (True, True, True, False, False)

        def plain(*a):
            return dc.modulated_deform_conv_clipped_plain(*a, stride=stride, radius=radius)

        bnd = dcn_bound(x.shape[0], *x.shape[1:], *off.shape[1:3], w.shape[-1])
        case = f"x{tuple(x.shape)} s{stride}"
    elif name == "bi_attention":
        q, k, vv, vl, bias_l, heads = args[:6]
        ins, outs, launcher = (q, k, vv, vl, bias_l), out, ba._launch
        per_item = (True,) * 5

        def plain(*a):
            return ba.bi_attention_plain(*a, heads)

        bnd = bi_bound(q.shape[0], q.shape[1], k.shape[1], q.shape[2])
        case = f"q/vv {tuple(q.shape)} T {k.shape[1]} heads {heads}"
    else:
        value, shapes, loc, attn = args[:4]
        ins, outs, launcher = (value, loc, attn), (out,), ms._launch
        per_item = (True,) * 3
        fn = ms.ms_deform_attn_clipped_plain if name == "ms_deform_attn_clip" else ms.ms_deform_attn_plain

        def plain(v, lo, at):
            return fn(v, shapes, lo, at)

        bnd = msda_bound(value.shape[0], value.shape[1], loc.shape[1], value.shape[2], value.shape[3], len(shapes),
                         loc.shape[4])
        case = f"Q {loc.shape[1]} levels {[tuple(s) for s in shapes]}"
    ms_ = cuda_time_ms(lambda: launcher(*args))
    if items is not None:
        idx = torch.tensor(items, device=outs[0].device)
        ins = tuple(a[idx] if a is not None and batched else a for a, batched in zip(ins, per_item))
        outs = tuple(o[idx] for o in outs)
        case += f", items {list(items)}"
    refs = plain(*(a.float() if a is not None else None for a in ins))
    errs = [max_err(o, r) for o, r in zip(outs, refs if isinstance(refs, tuple) else (refs,))]
    del refs
    ok = all(e <= ERR_BOUND * sc for e, sc in errs) and all(bool(torch.isfinite(o).all()) for o in outs)
    if not ok:
        fail(f"{phase} {label} {name} at {where} {case}: the kernel disagrees with its plain version")
    plain_ms = cuda_time_ms(lambda: plain(*ins), iters=3, warmup=1)
    err = max(e for e, _ in errs)
    record = {"case": f"{tag} {where} {case}", "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms,
              "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}
    return record, (f"{name} {case}: max_abs_err {err!r} (bound {ERR_BOUND * max(sc for _, sc in errs)!r}), "
                    f"kernel {ms_!r} ms, plain bf16 {plain_ms!r} ms{' on the items' if items else ''}, "
                    f"bound {bnd[0]!r} ms; ok")


def phase_tta_kernels(torch, label, model, cfg, make_batch, seed, kres):
    """Phase 15.1: the kernels at the test-time augmentation's buckets
    (TTA_BUCKETS), on the model's own activations. Per bucket, one chunk
    group (CP 4) of the protocol (`make_protocol_fn`) is run with the first
    launch of each kernel at each shape kept (`first_launches`); each kept
    launch is held against its plain version on the card in fp32
    (`kept_launch_check`, phase 2's rule, 2e-2 * max|ref|): K1 `dcn_band`
    at every level and stride, K3 `bi_attention`, K5 `ms_deform_attn_clip`
    and the exact `ms_deform_attn`; the kernel's and the plain version's
    (bf16) ms and the bound join the kernel's cases. K5's band geometry
    (`msda_band_geometry`: GATHER, BAND or WHOLE per (query level, value
    level) pair) is printed per bucket. Counted nowhere: these launches
    serve the comparison."""
    from mqdet_torch.engine.predict import make_protocol_fn
    from mqdet_torch.ops import ms_deform_attn as ms
    from mqdet_torch.utils.builders import protocol_inputs

    dev = torch.device("cuda")
    stage = {ms.GATHER: "GATHER", ms.BAND: "BAND", ms.WHOLE: "WHOLE"}
    for bucket in TTA_BUCKETS:
        image, text = protocol_inputs(cfg, make_batch, 1, 4, bucket, seed)
        keep = {}
        with first_launches(keep):
            make_protocol_fn(model, bucket, cfg)(image.to(dev), *(t.to(dev) for t in text))
        lines = []
        with torch.no_grad():  # the kept weights are parameters: the launchers refuse them under grad
            for key, (args, out) in sorted(keep.items(), key=lambda kv: str(kv[0])):
                record, line = kept_launch_check(torch, label, bucket, key, args, out)
                kres[key[0]].append(record)
                lines.append(line)
        geometry = ""
        clipped = [k for k in keep if k[0] == "ms_deform_attn_clip"]
        if clipped:
            value, shapes = keep[clipped[0]][0][:2]
            geo = ms.msda_band_geometry(shapes, value.shape[3])
            geometry = f"; K5 band geometry per (query level, value level) at levels {[tuple(x) for x in shapes]}: " + \
                ", ".join(f"{lq}{lv} {stage[g[0]]}" + ("" if g[0] == ms.GATHER else f" {g[1]}x{g[2]}")
                          for (lq, lv), g in geo.items())
        say(f"phase 15: {label} kernels at the bucket {bucket}, one chunk group's first launch at each shape "
            f"against the plain version in fp32 on the card (phase 2's rule, {ERR_BOUND} * max|ref|): "
            f"{'; '.join(lines)}{geometry}")
        del keep
        torch.cuda.empty_cache()


def tta_config(cfg, dataset, image_id):
    """Phase 7's settings (`vq_settings`) under TEST.USE_MULTISCALE: the
    config's 8 TEST.SCALES (400-1200) with flip under TEST.MAX_SIZE 2000,
    the three TTA_BUCKETS, one chunk group (TEST.SELECT_CLASSES: the image's
    GT classes, then the first others, TTA_CLASSES in all)."""
    c = vq_settings(cfg)
    c.TEST.USE_MULTISCALE, c.TEST.FLIP, c.TEST.MAX_SIZE = True, True, 2000
    c.TPU.IMAGE_BUCKETS = TTA_BUCKETS
    gt = sorted({int(l) for l in dataset.annotations(image_id)[1]})
    rest = [l for l in sorted(dataset.ind_to_class) if l not in gt]
    c.TEST.SELECT_CLASSES = tuple(gt + rest[:TTA_CLASSES - len(gt)])
    return c


def phase_tta(torch, label, cfg, model, vq, per_pass):
    """Phase 15.2: `run_inference` under TEST.USE_MULTISCALE on 1 image of
    phase 7's dataset with phase 7's bank (`tta_config`: 8 scales x 2 flips
    = 16 passes, one chunk group each), launches gated at 16 x `per_pass`;
    then the same call on the kernels' plain versions on the card
    (`ops.kernels.plain_versions`, the explicit reference route: no launch),
    the merged detections held against it: each run at least the cap
    (DETECTIONS_PER_IMG; the merge keeps the cap's ties too), the top cap
    scores sorted within 2e-2 * the largest, and the share of the kernel
    run's detections that the plain run has with the same label at IoU >=
    0.5 printed (ungated: random-init scores lie close, so near-equal
    detections trade ranks under rounding). Detections finite and inside
    the image; the card's peak memory printed. Returns the launches."""
    import numpy as np

    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.engine.box_aug import _iou_matrix
    from mqdet_torch.engine.evaluator import DetectionEvaluator
    from mqdet_torch.engine.inference import run_inference
    from mqdet_torch.mq.selector import QuerySelector
    from mqdet_torch.ops import kernels, launch_counts

    ds, img_id = vq["dataset"], vq["dataset"].ids[0]
    c = tta_config(cfg, ds, img_id)
    passes = len(c.TEST.SCALES) * 2
    ih, iw = ds.image_size(img_id)

    def once():
        seen = {}

        class Rec(DetectionEvaluator):
            def add_image(self, image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **kw):
                seen[image_id] = (det_boxes, det_scores, det_labels)
                super().add_image(image_id, gt_boxes, gt_labels, det_boxes, det_scores, det_labels, **kw)

        selector = QuerySelector(vq["bank"], num_query_per_class=5, max_labels=40)
        torch.cuda.synchronize()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        res = run_inference(c, model, ds, WordPieceTokenizer(), selector, evaluator=Rec(style="coco"), max_images=1,
                            verbose=False)
        torch.cuda.synchronize()
        return seen[img_id], time.perf_counter() - t0, launch_counts(), res["seconds"]

    torch.cuda.reset_peak_memory_stats()
    (b, s, l), secs, used, stages = once()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: v * passes for k, v in per_pass.items()}
    if used != want:
        fail(f"phase 15 {label} TTA: launches {used} != predicted {want}")
    with kernels.plain_versions():
        (pb, ps, pl), plain_s, plain_used, _ = once()
    if any(plain_used.values()):
        fail(f"phase 15 {label} TTA: the plain route launched {plain_used}")
    for bx, sx in ((b, s), (pb, ps)):
        if not (np.isfinite(bx).all() and np.isfinite(sx).all() and (bx >= 0).all() and (bx[:, 0::2] <= iw).all()
                and (bx[:, 1::2] <= ih).all()):
            fail(f"phase 15 {label} TTA: a detection not finite or outside {(ih, iw)}")
    # the cap keeps every detection tied with the cap-th score (JAX's rule): where scores saturate (GDINO's
    # random init) the count past the cap moves with the rounding, so the gate reads the top `cap` of each
    cap = c.MODEL.ATSS.DETECTIONS_PER_IMG
    enough = min(len(s), len(ps)) >= cap
    sorted_err = float(np.abs(np.sort(s)[::-1][:cap] - np.sort(ps)[::-1][:cap]).max()) if enough else math.inf
    top = float(max(ps.max(initial=0.0), 1e-30))
    iou = _iou_matrix(b, pb) if len(b) and len(pb) else np.zeros((len(b), len(pb)))
    matched = float(((iou >= 0.5) & (l[:, None] == pl[None, :])).any(1).mean()) if len(b) else 0.0
    ok = sorted_err <= ERR_BOUND * top
    say(f"phase 15: {label} run_inference under TEST.USE_MULTISCALE, 1 image {(ih, iw)}, scales {tuple(c.TEST.SCALES)} "
        f"x flip under MAX_SIZE {c.TEST.MAX_SIZE} ({passes} passes, one chunk group of {len(c.TEST.SELECT_CLASSES)} "
        f"classes each, SPECIAL_NMS {c.TEST.SPECIAL_NMS}): {secs!r} s an image (host clock; seconds by stage "
        f"{stages}); peak memory {peak!r} GiB (the 1216x2016 passes at CP 4); launches "
        f"{({k: v for k, v in used.items() if v})} (predicted {({k: v for k, v in want.items() if v})}); the plain "
        f"versions on the card (`plain_versions`, no launch): {plain_s!r} s; merged detections {len(s)} vs "
        f"{len(ps)} (the cap {cap} and its ties), the top {cap} sorted scores max abs diff {sorted_err!r} (bound "
        f"{ERR_BOUND * top!r} = {ERR_BOUND} * max score {top!r}), {matched!r} of the kernel run's detections found "
        f"in the plain run (same label, IoU >= 0.5); {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"phase 15 {label} TTA: the merged detections disagree with the plain route's")
    return {f"{label} TTA": used}


def knowledge_yaml(path, names) -> None:
    """A GLIPKNOW knowledge file for `names`, in PyYAML's block style (no
    PyYAML here): per class clean_name, def_wiki (a sentence long enough to
    wrap over two lines, as PyYAML's dump wraps it) and three gpt3 lines."""
    lines = []
    for i, n in enumerate(names):
        clean = n.replace("_", " ")
        lines += [f"{n}:", f"  clean_name: {clean}",
                  f"  def_wiki: a seeded description of {clean} number {i}, long enough that a yaml writer wraps",
                  "    it onto a second line as plain text.",
                  "  gpt3:", f"  - {clean} is an object", f"  - a {clean} has parts", f"  - seen in scene {i}"]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def phase_knowledge(torch, cfg, model, vq, root, per_group):
    """Phase 15.3: MQ-GLIP-T's `run_inference` on 1 image with
    GLIPKNOW.KNOWLEDGE_FILE (a yaml written here, `knowledge_yaml`; read by
    `core/yaml_lite.py`), KNOWLEDGE_TYPE def_wiki, one chunk group: the token
    ids the language tower received on the card equal to those of the same
    plan built on the host, and different from the plan without the file;
    launches gated at one group's. Returns the launches."""
    import numpy as np

    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.engine.inference import ChunkedEvaluationPlan, run_inference
    from mqdet_torch.mq.selector import QuerySelector
    from mqdet_torch.ops import launch_counts

    ds = vq["dataset"]
    c = tta_config(cfg, ds, ds.ids[0])
    c.TEST.USE_MULTISCALE = False
    path = os.path.join(root, "knowledge.yaml")
    knowledge_yaml(path, [ds.ind_to_class[l] for l in c.TEST.SELECT_CLASSES])
    c.GLIPKNOW.KNOWLEDGE_FILE, c.GLIPKNOW.KNOWLEDGE_TYPE = path, "def_wiki"
    seen = []
    hook = model.language_backbone.register_forward_pre_hook(lambda m, a: seen.append(a[0].cpu().numpy()))
    try:
        launch_counts(reset=True)
        t0 = time.perf_counter()
        run_inference(c, model, ds, WordPieceTokenizer(), QuerySelector(vq["bank"], num_query_per_class=5,
                                                                        max_labels=40), max_images=1, verbose=False)
        torch.cuda.synchronize()
        secs, used = time.perf_counter() - t0, launch_counts()
    finally:
        hook.remove()
    plan = ChunkedEvaluationPlan(c, ds, WordPieceTokenizer(), None)
    c.GLIPKNOW.KNOWLEDGE_FILE = ""
    bare = ChunkedEvaluationPlan(c, ds, WordPieceTokenizer(), None)
    same = len(seen) == 1 and np.array_equal(seen[0], plan.input_ids)
    differs = not np.array_equal(plan.input_ids, bare.input_ids)
    say(f"phase 15: MQ-GLIP-T run_inference with GLIPKNOW.KNOWLEDGE_FILE (def_wiki; {len(plan)} chunks, one "
        f"group) on 1 image: {secs!r} s; the card's token ids (CP, T) {seen[0].shape if seen else None} equal to "
        f"the plan built on the host: {same}; different from the plan without knowledge: {differs}; tokens in "
        f"use {int(plan.attention_mask.sum())} vs {int(bare.attention_mask.sum())} without; launches "
        f"{({k: v for k, v in used.items() if v})} (predicted {({k: v for k, v in per_group.items() if v})})")
    if not (same and differs) or used != per_group:
        fail("phase 15: the knowledge prompts did not reach the card as planned")
    return {"MQ-GLIP-T knowledge": used}


TOWER_VARIANTS = {  # name -> (config key, value)
    "clip": ("MODEL.LANGUAGE_BACKBONE.MODEL_TYPE", "clip"),
    "rnn": ("MODEL.LANGUAGE_BACKBONE.MODEL_TYPE", "rnn"),
    "Swin v2": ("MODEL.SWINT.VERSION", "v2"),
    "Swin vl": ("MODEL.SWINT.VERSION", "vl"),
}


def phase_towers(torch, cfg, donor, seed, per_group):
    """Phase 15.4: MQ-GLIP-T at full width with the CLIP and RNN (LSTM)
    language towers (VISION_QUERY off: they take no queries) and Swin v2 and
    vl, each `init_like` the default model (the weights it shares by name
    and shape copied, the rest drawn): phase 3's rule at 256x256
    (`phase_switch_reference`: logits and boxes, card bf16 against CPU fp32
    plain, twice) and one chunk group (CP 4, 40 labels) at 800x1344
    through the split functions, the encode and head ms (host clock,
    synchronised, median of 3 after one warm-up); launches gated at one
    group's. Returns the launches of the reference forwards and groups."""
    from mqdet_torch.engine.predict import make_split_predict_fns
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import build_model, protocol_inputs, synthetic_batch

    dev = torch.device("cuda")
    launches = {}
    for name, (key, value) in TOWER_VARIANTS.items():
        c = cfg.clone()
        node, leaf = key.rsplit(".", 1)
        parent = c
        for part in node.split("."):
            parent = parent[part]
        parent[leaf] = value
        c.VISION_QUERY.ENABLED = node != "MODEL.LANGUAGE_BACKBONE"
        t0 = time.perf_counter()
        model_cpu = init_like(build_model(c), donor, seed).eval()
        built = time.perf_counter() - t0
        model = on_card(torch, model_cpu)
        launches[f"phase 15 {name} reference"] = phase_switch_reference(torch, name, c, model_cpu, model, seed,
                                                                         per_group, phase="phase 15")
        del model_cpu
        hw = (800, 1344)
        image, text = protocol_inputs(c, synthetic_batch, 1, 4, hw, seed)
        encode_fn, head_fn = make_split_predict_fns(model, hw, c)
        image, text = image.to(dev), [t[0].to(dev) for t in text]
        with torch.inference_mode():
            feats = encode_fn(image)
            head_fn(feats, *text)  # warm-up
            launch_counts(reset=True)
            head_fn(feats, *text)
            torch.cuda.synchronize()
            used = launch_counts()
            enc_ms = statistics.median(synced_seconds(torch, lambda: encode_fn(image)) for _ in range(3)) * 1e3
            head_ms = statistics.median(synced_seconds(torch, lambda: head_fn(feats, *text)) for _ in range(3)) * 1e3
        say(f"phase 15: MQ-GLIP-T with {key} {value} full width: built on the host in {built!r} s (init_like the "
            f"default model); one chunk group (CP 4) at {hw}: encode {enc_ms!r} ms, head {head_ms!r} ms (host "
            f"clock, synchronised, median of 3); launches {({k: v for k, v in used.items() if v})} (predicted "
            f"{({k: v for k, v in per_group.items() if v})})")
        if used != per_group:
            fail(f"phase 15 {name}: a chunk group's launches {used} != predicted {per_group}")
        launches[f"phase 15 {name} group"] = used
        del model, feats, encode_fn, head_fn
        torch.cuda.empty_cache()
    return launches


# ---- phase 16: GDINO at 3 levels, the merged canvas, MQDET_FUSION_IMPL, the legacy family, the demo, pooling ----

LEGACY_FAMILIES = (  # (CONV_BODY, RPN_ARCHITECTURE; None: the body alone): phase 16.5's reference forwards
    ("R-50-RETINANET", "ATSS"), ("R-101-C4", None), ("EFFICIENT3-FPN-RETINANET", "RETINA"),
    ("EFFICIENT3-BIFPN-FCOS", "FCOS"), ("EFFICIENT-DET", "ATSS"),
)
LEGACY_HEADS = ("FCOS", "RETINA", "ATSS")  # trained on R-50-RETINANET
LEGACY_STEPS = (1, 3)  # warm-up and timed SGD steps at 800x1344, batch 2
LEGACY_LR = 1e-3


def legacy_config(body, arch):
    """The default config with CONV_BODY `body` and RPN_ARCHITECTURE `arch`
    (80 COCO classes, 100 detections, TPU.COMPUTE_DTYPE bf16)."""
    from mqdet_torch.core.config import default_config

    cfg = default_config()
    cfg.MODEL.BACKBONE.CONV_BODY = body
    if arch:
        cfg.MODEL.RPN_ARCHITECTURE = arch
    return cfg


def legacy_model(torch, cfg, seed, gain=1.0, perturb=True):
    """The detector of `cfg` (or, for a body-only CONV_BODY, the backbone)
    on the CPU in fp32 with seeded weights that keep a deep trunk's
    activations O(1): conv kernels normal with std gain * sqrt(1 / fan in)
    (init_params' 0.02 would shrink ResNet-101's maps to nothing), the
    classifier's bias at the prior probability 0.01; with `perturb`,
    FrozenBatchNorm and GroupNorm near identity and biases and BiFPN blends
    perturbed, else the norms at identity and the biases at 0."""
    import numpy as np

    from mqdet_torch.models.backbones import build_backbone
    from mqdet_torch.models.legacy_heads import build_legacy_detector

    model = build_legacy_detector(cfg) if cfg.MODEL.RPN_ARCHITECTURE != "VLDYHEAD" else build_backbone(cfg)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            n = torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))
            if t.dim() == 4:
                t.copy_(n * gain / math.sqrt(t[0].numel()))
            elif not perturb:
                t.fill_(1.0 if name.endswith(("var", "scale", "weight", "_w1", "_w2")) else 0.0)
            elif name.endswith(("var",)):
                t.copy_(1.0 + 0.2 * n.abs())
            elif name.endswith(("scale", "weight", "_w1", "_w2")):
                t.copy_(1.0 + 0.1 * n)
            else:
                t.copy_(0.1 * n)
        if hasattr(model, "head"):  # the classifier's prior-probability bias, as the heads initialise it
            model.head.cls_logits.bias.fill_(-math.log((1 - 0.01) / 0.01))
    return model.eval()


def legacy_outputs(out):
    """A head's dict (or a body's list) of maps -> (names, fp32 CPU tensors)."""
    if isinstance(out, dict):
        items = [(f"{k}{i}", t) for k in sorted(out) for i, t in enumerate(out[k])]
    else:
        items = [(f"C{i + 2}", t) for i, t in enumerate(out)]
    return [n for n, _ in items], [t.float().cpu() for _, t in items]


def phase_legacy_reference(torch, seed):
    """Phase 16.5's reference forwards: each family of LEGACY_FAMILIES at
    256x256, batch 2, card bf16 against the CPU in fp32 by phase 3's rule
    (every map within twice the CPU bf16 path's drift, floor E2E_FLOOR); no
    hand-written kernel may launch."""
    import numpy as np

    from mqdet_torch.ops import launch_counts

    x = torch.from_numpy(np.random.default_rng(seed + 16).standard_normal((2, 3, 256, 256)).astype(np.float32))
    for body, arch in LEGACY_FAMILIES:
        cfg = legacy_config(body, arch)
        t0 = time.perf_counter()
        model = legacy_model(torch, cfg, seed)
        with torch.inference_mode():
            names, ref = legacy_outputs(model(x))
            _, plain16 = legacy_outputs(copy.deepcopy(model).to(torch.bfloat16)(x.bfloat16()))
            gpu = copy.deepcopy(model).to("cuda", torch.bfloat16).to(memory_format=torch.channels_last)
            launch_counts(reset=True)
            _, card = legacy_outputs(gpu(x.to("cuda", torch.bfloat16)))
            torch.cuda.synchronize()
        used = {k: v for k, v in launch_counts().items() if v}
        del gpu
        what = f"{body}{' + ' + arch if arch else ' (body)'}"
        if used:
            fail(f"phase 16 {what}: launched {used}; the legacy family runs no hand-written kernel")
        worst = compare_to_reference(torch, f"phase 16 {what}", names, ref, plain16, card)
        say(f"phase 16: reference check, {what} ({sum(p.numel() for p in model.parameters())} parameters) at "
            f"(256, 256), batch 2, card bf16 vs CPU fp32 on {len(names)} maps: worst err / bound {worst[0]!r} at "
            f"{worst[1]} (card relative L2 {worst[2]!r}, plain bf16 {worst[3]!r}); no kernel launched; "
            f"{time.perf_counter() - t0!r} s; ok")
        torch.cuda.empty_cache()


def legacy_batch(torch, hw, seed):
    """Batch 2 at `hw` with 6 seeded ground-truth boxes an image (one padded row)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = hw
    images = rng.standard_normal((2, 3, h, w)).astype(np.float32)
    xy = rng.uniform(0, 0.6, (2, 6, 2)) * np.array([w, h])
    boxes = np.concatenate([xy, xy + rng.uniform(0.1, 0.35, (2, 6, 2)) * np.array([w, h])], -1).astype(np.float32)
    labels = rng.integers(1, 81, (2, 6)).astype(np.int32)
    valid = np.ones((2, 6), bool)
    valid[1, 5] = False
    return [torch.from_numpy(a) for a in (images, boxes.clip(0, min(h, w) - 1), labels, valid)]


def legacy_step(torch, model, cfg, batch, dev, compute_dtype, lr=LEGACY_LR):
    """One SGD step (`make_legacy_train_step`) of `model` on `dev`; returns
    (loss, {name: gradient, fp32 on the CPU}, losses)."""
    from mqdet_torch.engine.legacy_losses import build_legacy_machinery, make_legacy_train_step

    hw = tuple(batch[0].shape[2:])
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    step = make_legacy_train_step(model, build_legacy_machinery(cfg, hw)[0], opt, compute_dtype)
    loss, losses = step(*(t.to(dev) for t in batch))
    grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
    return float(loss), grads, {k: float(v) for k, v in losses.items()}


LEGACY_SCALES = (1.0, 1.0 + 1e-4, 1.0 - 1e-4)  # phase 16.5's reference steps' image scalings


def legacy_reference_cpu(torch, arch, seed):
    """The CPU runs of phase 16.5's reference step for head `arch` on
    R-50-RETINANET (`phase_legacy_train`): (the fp32 steps, the bf16-autocast
    steps, each {scale: (loss, gradients)} over LEGACY_SCALES, seconds)."""
    import numpy as np

    cfg = legacy_config("R-50-RETINANET", arch)
    model = legacy_model(torch, cfg, seed, gain=0.5, perturb=False)
    batch = legacy_batch(torch, (256, 256), seed + 1)
    t0 = time.perf_counter()

    def scaled(s):
        return [batch[0] * np.float32(s)] + batch[1:]

    ref32 = {s: legacy_step(torch, copy.deepcopy(model).train(), cfg, scaled(s), "cpu", None)[:2]
             for s in LEGACY_SCALES}
    run16 = {s: legacy_step(torch, copy.deepcopy(model).train(), cfg, scaled(s), "cpu", torch.bfloat16)[:2]
             for s in LEGACY_SCALES}
    return ref32, run16, time.perf_counter() - t0


def phase_legacy_train(torch, seed, smi, cpu=None):
    """Phase 16.5's training: for each head of LEGACY_HEADS on
    R-50-RETINANET, the reference step at 256x256 by phase 8's rule (the
    card's step, fp32 parameters under bf16 autocast as TPU.COMPUTE_DTYPE
    computes, against the CPU's fp32 step; bound twice the largest drift of
    three CPU bf16-autocast steps on the images scaled by 1 and 1 +- 1e-4),
    on `legacy_model` at gain 0.5 with its norms at identity: the rule needs
    the scaled fp32 steps within 1e-2 of the unscaled, and a random ReLU
    trunk is not that smooth at phase 8's 1e-3 (measured on the CPU: units
    crossing 0 moved the FPN's and towers' bias gradients by 1-5% at gain 1
    with perturbed norms, and by 1.1% at 1e-3 even at gain 0.5; at 1e-4 and
    gain 0.5 by at most 2.4e-3),
    then SGD steps at 800x1344, batch 2, on the card: ms a step and peak
    memory; gates: every loss finite, tensors of the body, the FPN and the
    head moved, the post-processed detections of the last forward (at
    pre-NMS threshold 0) at least one an image, finite and inside the
    image, no hand-written kernel launched. `cpu(arch)`: the reference
    step's CPU runs (`legacy_reference_cpu`) where the caller has them, else
    made here."""
    from mqdet_torch.engine.legacy_losses import build_legacy_machinery
    from mqdet_torch.ops import launch_counts

    dev = torch.device("cuda")
    for arch in LEGACY_HEADS:
        cfg = legacy_config("R-50-RETINANET", arch)
        model = legacy_model(torch, cfg, seed, gain=0.5, perturb=False)
        batch = legacy_batch(torch, (256, 256), seed + 1)
        ref32, run16, cpu_s = cpu(arch) if cpu is not None else legacy_reference_cpu(torch, arch, seed)
        scales = tuple(ref32)
        launch_counts(reset=True)
        cards = [legacy_step(torch, copy.deepcopy(model).to(dev).to(memory_format=torch.channels_last).train(),
                             cfg, batch, dev, torch.bfloat16)[:2] for _ in range(2)]
        reference_verdict(torch, "phase 16", f"{arch} on R-50-RETINANET at (256, 256)", cards, ref32, run16, scales,
                          f"SGD lr {LEGACY_LR}; CPU steps {cpu_s!r} s")

        hw = (800, 1344)
        full = legacy_batch(torch, hw, seed + 2)
        gpu = copy.deepcopy(model).to(dev).to(memory_format=torch.channels_last).train()
        before = {n: p.detach().clone() for n, p in gpu.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(sum(LEGACY_STEPS)):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss, _, parts = legacy_step(torch, gpu, cfg, full, dev, torch.bfloat16)
            torch.cuda.synchronize()
            if i >= LEGACY_STEPS[0]:
                times.append(time.perf_counter() - t1)
            losses.append((loss, parts))
        peak = torch.cuda.max_memory_allocated() / 2**30
        moved = {n for n, p in gpu.named_parameters() if not torch.equal(p, before[n])}
        groups = {g: [n for n in before if n.startswith(g)] for g in ("backbone.body.", "backbone.fpn.", "head.")}
        # post-processed at pre-NMS threshold 0: a few steps from random weights leave FCOS's and RETINA's
        # scores under the config's 0.05, and the gate needs detections through the top-k, decode and NMS
        pcfg = cfg.clone()
        pcfg.MODEL.ATSS.INFERENCE_TH = 0.0
        _, post = build_legacy_machinery(pcfg, hw)
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            head_out = gpu(full[0].to(dev))
        dets = [post(head_out, hw[0], hw[1], item) for item in (0, 1)]
        used = {k: v for k, v in launch_counts().items() if v}
        finite = all(math.isfinite(lo) and all(math.isfinite(v) for v in parts.values()) for lo, parts in losses)
        dets_ok = all(bool(d.valid.any()) for d in dets) and all(
            bool(torch.isfinite(d.boxes).all() and torch.isfinite(d.scores).all()) for d in dets) and all(
            bool((d.boxes[..., 2] <= hw[1] - 1).all() and (d.boxes[..., 3] <= hw[0] - 1).all()) for d in dets)
        say(f"phase 16: {arch} on R-50-RETINANET at {hw}, batch 2, bf16 autocast, SGD lr {LEGACY_LR}: "
            f"{statistics.median(times) * 1000.0!r} ms a step (median of {len(times)}; "
            f"{[round(t * 1000.0, 3) for t in times]}), {2.0 / statistics.median(times)!r} train img/s, peak memory "
            f"{peak!r} GiB; losses {losses[-1][1]}; {len(moved)} of {len(before)} tensors moved (body "
            f"{len(moved & set(groups['backbone.body.']))}, FPN {len(moved & set(groups['backbone.fpn.']))}, head "
            f"{len(moved & set(groups['head.']))}); detections {[int(d.valid.sum()) for d in dets]} valid of "
            f"{dets[0].valid.shape[0]} an image, finite and inside {dets_ok}; launches {used}; {smi}")
        if not (finite and dets_ok and all(moved & set(v) for v in groups.values())) or used:
            fail(f"phase 16 {arch} training: losses finite {finite}, detections {dets_ok}, moved "
                 f"{ {g: len(moved & set(v)) for g, v in groups.items()} }, launches {used}")
        del gpu, before, head_out
        torch.cuda.empty_cache()


def phase_merged_canvas(torch, model, cfg, seed):
    """Phase 16.3: DyConv's merged canvas through the model. The first head
    stage's DyConv on P3..P7 of two 800x1344 images, its three DeformConvGNs
    with merge_max_positions 600 (the two smallest output grids of each
    conv, 273 and 77 positions, on one canvas) and with 0 (one call a
    level): each level's output within phase 2's rule of the other's, and
    one K1 launch fewer for each conv (13 launches a stage per level, 10
    merged). Returns the merged run's launch counts."""
    from mqdet_torch.models.vldyhead import DeformConvGN
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import synthetic_batch

    dev = torch.device("cuda")
    images = torch.from_numpy(synthetic_batch(cfg, batch=2, image_hw=(800, 1344), num_labels=4, k_shot=1,
                                              seed=seed + 16)["images"]).permute(0, 3, 1, 2).contiguous()
    dy = model.rpn.head.dyhead_tower[2]
    convs = [m for m in dy.modules() if isinstance(m, DeformConvGN)]
    total = predicted()
    with torch.inference_mode(), switched("default"):
        feats = model.encode_image(images.to(dev))
        runs = {}
        for merge in (600, 0):
            for conv in convs:
                conv.merge_max_positions = merge
            launch_counts(reset=True)
            runs[merge] = (dy(list(feats)), launch_counts()["dcn_band"])
        (merged, n_merged), (one, n_one) = runs[600], runs[0]
        n = len(feats)
        want_one, want_merged = 3 * n - 2, 3 * n - 2 - len(convs)
        errs = [max_err(a, b) for a, b in zip(merged, one)]
        same = [torch.equal(a, b) for a, b in zip(merged, one)]
        ok = all(e <= ERR_BOUND * sc for e, sc in errs) and n_one == want_one and n_merged == want_merged
        say(f"phase 16: the model's DyConv (head stage 0) over {[tuple(f.shape[2:]) for f in feats]}, batch 2: "
            f"merge_max_positions 600 {n_merged} dcn_band launches, 0 {n_one} (predicted {want_merged} and "
            f"{want_one}); per level max_abs_err merged vs one call {[e for e, _ in errs]!r} (bound {ERR_BOUND} * "
            f"max|ref| {[sc for _, sc in errs]!r}), bitwise {same}; {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"phase 16 merged canvas: launches {n_merged} / {n_one} or outputs apart")
        total["dcn_band"] += n_merged
    return total


def phase_fusion_impl(torch, model, cfg, seed):
    """Phase 16.4: MQDET_FUSION_IMPL=xla on one MQ-GLIP-T chunk group (CP 4,
    40 labels x 5 queries) at 800x1344: 0 bi-attention launches (78
    `dcn_band`), against the same group under the default: the same launches
    but 6 `bi_attention`, and the sorted top 300 detection scores of each
    chunk within 2e-2 * the largest (phase 15's rule on detections; phase 3
    holds the xla route's features and logits to the CPU). Returns the xla
    run's launch counts."""
    from mqdet_torch.engine.predict import make_protocol_fn
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import protocol_inputs, synthetic_batch

    dev = torch.device("cuda")
    hw = (800, 1344)
    image, text = protocol_inputs(cfg, synthetic_batch, 1, 4, hw, seed)
    image, text = image.to(dev), [t.to(dev) for t in text]
    protocol = make_protocol_fn(model, hw, cfg)
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    out = {}
    for switch, want in (("default", predicted(dcn_band=stages * (3 * levels - 2), bi_attention=stages)),
                         ("xla", predicted(dcn_band=stages * (3 * levels - 2)))):
        with switched(switch):
            protocol(image, *text)
            torch.cuda.synchronize()
            launch_counts(reset=True)
            t0 = time.perf_counter()
            dets = protocol(image, *text)
            torch.cuda.synchronize()
            ms_ = (time.perf_counter() - t0) * 1000.0
            used = launch_counts()
        if used != want:
            fail(f"phase 16 MQDET_FUSION_IMPL={SWITCHES[switch].get('MQDET_FUSION_IMPL', 'pallas')}: launches {used} "
                 f"!= predicted {want}")
        out[switch] = (dets, used, ms_)
    a, b = out["default"][0], out["xla"][0]
    top_a = torch.sort(torch.where(a.valid, a.scores, 0.0), -1, descending=True).values[..., :300]
    top_b = torch.sort(torch.where(b.valid, b.scores, 0.0), -1, descending=True).values[..., :300]
    diff, scale = max_err(top_b, top_a)
    finite = bool(torch.isfinite(b.boxes).all() and torch.isfinite(b.scores).all())
    ok = finite and diff <= ERR_BOUND * scale
    say(f"phase 16: MQ-GLIP-T one chunk group at {hw} under MQDET_FUSION_IMPL=xla: launches "
        f"{ {k: v for k, v in out['xla'][1].items() if v} } (default: "
        f"{ {k: v for k, v in out['default'][1].items() if v} }); {out['xla'][2]!r} ms vs {out['default'][2]!r} ms "
        f"(host clock, one run each); valid {int(b.valid.sum())} vs {int(a.valid.sum())}; the sorted top 300 scores "
        f"a chunk max |diff| {diff!r} (bound {ERR_BOUND * scale!r}); finite {finite}; {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("phase 16 MQDET_FUSION_IMPL=xla: detections apart from the default's")
    return out["xla"][1]


def demo_categories(n=40):
    """n seeded pseudo-word category names."""
    import numpy as np

    rng = np.random.default_rng(n)
    syll = ["ka", "lo", "mi", "ne", "ru", "ta", "vo", "zi", "pe", "sa"]
    return [" ".join("".join(rng.choice(syll, 2)) for _ in range(1 + i % 2)) for i in range(n)]


def phase_demo(torch, label, model, cfg, seed, want):
    """Phase 16.6: `MQDetDemo` (the demo CLI's predictor) on a 480x640 numpy
    image with 40 category names, no bank: its head call's detections
    bitwise those of `make_split_predict_fns` called on the same inputs,
    the thresholded result those detections' (boxes scaled back to the
    image), launches `want`. Returns them."""
    import numpy as np

    from mqdet_torch.data.tokenizer import WordPieceTokenizer
    from mqdet_torch.engine.demo import MQDetDemo
    from mqdet_torch.engine.predict import make_split_predict_fns
    from mqdet_torch.ops import launch_counts

    c = cfg.clone()
    c.TPU.IMAGE_BUCKETS = ((800, 1344),)
    demo = MQDetDemo(c, model, confidence_threshold=0.05, tokenizer=WordPieceTokenizer())  # phase 7's hash vocab
    seen = {}
    head = demo.head_fn

    def watch(*a):
        seen["args"], seen["out"] = a, head(*a)
        return seen["out"]

    demo.head_fn = watch
    image = (np.random.default_rng(seed + 16).uniform(0, 255, (480, 640, 3))).astype(np.uint8)
    names = demo_categories()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out = demo(image, names)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    used = launch_counts()
    enc, hd = make_split_predict_fns(model, (800, 1344), c)
    feats, *rest = seen["args"]
    direct = hd(enc(demo.transform(image, device=feats[0].device)[0]), *rest)
    same = all(torch.equal(getattr(direct, f), getattr(seen["out"], f)) for f in ("boxes", "scores", "labels", "valid"))
    scores = seen["out"].scores[0].float().cpu().numpy()
    keep = scores >= 0.05
    ok = same and used == want and np.array_equal(out["scores"], scores[keep]) and bool(np.isfinite(out["boxes"]).all())
    say(f"phase 16: {label} demo (MQDetDemo) on a 480x640 numpy image, 40 names: {len(out['scores'])} detections "
        f"at threshold 0.05, {sec!r} s; the head's detections bitwise make_split_predict_fns' {same}; launches "
        f"{ {k: v for k, v in used.items() if v} } (predicted { {k: v for k, v in want.items() if v} }); "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"phase 16 {label} demo: bitwise {same}, launches {used}")
    return used


def gdino3_models(torch, donor, seed):
    """Phase 16.2's configs and model: (MQ-GroundingDINO-T at 3 feature
    levels, its training config, the model on the CPU, `init_like` the
    4-level `donor`)."""
    from mqdet_torch.utils.builders import build_model, mq_groundingdino_t_config

    cfg = mq_groundingdino_t_config()
    cfg.GROUNDINGDINO.num_feature_levels = 3
    tcfg = train_config_gdino()
    tcfg.GROUNDINGDINO.num_feature_levels = 3
    return cfg, tcfg, init_like(build_model(cfg), donor, seed).eval()


def phase_gdino3(torch, donor, seed, kres, refs):
    """Phase 16.2: MQ-GroundingDINO-T at GROUNDINGDINO.num_feature_levels 3,
    at the model's full depth, 6 encoder and 6 decoder layers (`init_like`
    the 4-level model: its weights, the MSDA projections and level_embed
    drawn anew): phase 3's reference check at 256x256; one protocol group
    (CP 4) at 800x1344 with launches 6 clipped + 6 exact MSDA + 6
    bi-attention, each kernel's first launch at each shape held against its
    plain version in fp32 (phase 2's rule; the cases join `kres`, the kernel
    line's); one training step by phase 9's rule, its CPU runs the worker's
    (`refs`, `CpuReferences`). Returns {path: launch counts}."""
    from mqdet_torch.engine.predict import make_protocol_fn
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils.builders import protocol_inputs, synthetic_caption_batch

    t0 = time.perf_counter()
    with refs.paused():  # the reference forward's CPU runs
        cfg, tcfg, model_cpu = gdino3_models(torch, donor, seed)
        g = cfg.GROUNDINGDINO
        model = copy.deepcopy(model_cpu).to("cuda", torch.bfloat16).to(memory_format=torch.channels_last)
        launches = {"GDINO 3 levels reference": phase_reference_gdino(
            torch, cfg, model_cpu, model, seed, "MQ-GroundingDINO-T at 3 levels", "phase 16")}
    hw = (800, 1344)
    image, text = protocol_inputs(cfg, synthetic_caption_batch, 1, 4, hw, seed)
    image, text = image.to("cuda"), [t.to("cuda") for t in text]
    protocol = make_protocol_fn(model, hw, cfg)
    protocol(image, *text)
    torch.cuda.synchronize()
    want = predicted(ms_deform_attn_clip=g.enc_layers, ms_deform_attn=g.dec_layers, bi_attention=g.enc_layers)
    launch_counts(reset=True)
    t1 = time.perf_counter()
    dets = protocol(image, *text)
    torch.cuda.synchronize()
    ms_ = (time.perf_counter() - t1) * 1000.0
    used = launch_counts()
    finite = bool(torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all())
    say(f"phase 16: MQ-GroundingDINO-T at 3 levels, one protocol group (CP 4) at {hw}: launches "
        f"{ {k: v for k, v in used.items() if v} } (predicted { {k: v for k, v in want.items() if v} }); "
        f"{ms_!r} ms (host clock); valid {int(dets.valid.sum())} of {dets.valid.numel()}; finite {finite}")
    if used != want or not finite:
        fail("phase 16 GDINO at 3 levels: protocol group launches or outputs")
    launches["GDINO 3 levels group"] = used
    keep = {}
    with first_launches(keep):
        protocol(image, *text)
    lines = []
    with torch.no_grad():
        for key, (args, out) in sorted(keep.items(), key=lambda kv: str(kv[0])):
            record, line = kept_launch_check(torch, "MQ-GroundingDINO-T at 3 levels", hw, key, args, out,
                                             "phase 16", "GDINO 3 levels")
            kres[key[0]].append(record)
            lines.append(line)
    say(f"phase 16: MQ-GroundingDINO-T at 3 levels, the group's first launch of each kernel at each shape against "
        f"the plain version in fp32 on the card (phase 2's rule): {'; '.join(lines)}")
    del model, protocol, keep
    torch.cuda.empty_cache()
    launches["GDINO 3 levels reference step"] = phase_train_reference_gdino(
        torch, tcfg, model_cpu, seed, phase="phase 16", label="MQ-GroundingDINO-T at 3 levels",
        cpu=checked_weights(torch, "phase 16.2", refs.get("phase 16 GDINO-3"), model_cpu))
    say(f"phase 16: MQ-GroundingDINO-T at 3 levels done in {time.perf_counter() - t0!r} s")
    return launches


def phase_pools(torch, seed):
    """Phase 16.7: `deform_psroi_pool` (3x3 position-sensitive groups, 2
    classes of offsets, ROIs partly off the map) and `roi_pool` on the card
    against the CPU, fp32, within 1e-5 * max|ref|."""
    import numpy as np

    from mqdet_torch.ops.deform_pool import deform_psroi_pool
    from mqdet_torch.ops.roi_align import roi_pool

    rng = np.random.default_rng(seed + 16)
    feats = torch.from_numpy(rng.standard_normal((2, 50, 84, 8 * 9)).astype(np.float32))
    rois = torch.from_numpy(np.array([[0, 10.3, 20.5, 300.1, 180.7], [1, -40.0, -12.0, 90.0, 70.0],
                                      [1, 500.0, 300.0, 700.0, 420.0], [0, 33.0, 44.0, 37.0, 50.0]], np.float32))
    trans = torch.from_numpy(rng.standard_normal((4, 2, 2, 3, 3)).astype(np.float32))
    kw = dict(spatial_scale=1.0 / 8, output_dim=8, pooled_size=7, group_size=3, part_size=3, sample_per_part=4)
    ref = deform_psroi_pool(feats, rois, trans, **kw)
    got = deform_psroi_pool(feats.cuda(), rois.cuda(), trans.cuda(), **kw).cpu()
    e1, s1 = max_err(got, ref)
    fmap = feats[0, :, :, :16]
    boxes = rois[:, 1:]
    ref2 = roi_pool(fmap, boxes, 1.0 / 8, 7)
    got2 = roi_pool(fmap.cuda(), boxes.cuda(), 1.0 / 8, 7).cpu()
    e2, s2 = max_err(got2, ref2)
    ok = e1 <= 1e-5 * s1 and e2 <= 1e-5 * s2
    say(f"phase 16: deform_psroi_pool (N 4, 7x7, groups 3, 2 offset classes) card vs CPU fp32 max_abs_err {e1!r} "
        f"(max|ref| {s1!r}); roi_pool (7x7, 16 channels) {e2!r} (max|ref| {s2!r}); bound 1e-5 * max|ref|; "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("phase 16 pooling: card and CPU apart")


P17_B, P17_B_WIDE, P17_CP, P17_GROUPS = 4, 8, 4, 8  # phase 17: images, the wider check's images, chunks, groups


def batched_images(torch, seed, b, hw=(800, 1344)):
    """(images (b, 3, H, W), true sizes (b, 2)): b seeded images of distinct
    content, image i's true size (H - 80 i, W - 96 i) (a user's images are
    resized into the bucket, and smaller ones zero-padded), zero outside it."""
    import numpy as np

    rng = np.random.default_rng(seed + 17)
    images = rng.standard_normal((b, 3) + tuple(hw)).astype(np.float32)
    sizes = np.array([(hw[0] - 80 * i, hw[1] - 96 * i) for i in range(b)], np.float32)
    for i, (h, w) in enumerate(sizes.astype(int)):
        images[i, :, h:] = 0.0
        images[i, :, :, w:] = 0.0
    return torch.from_numpy(images), torch.from_numpy(sizes)


def launch_flops(acc):
    """Inside the block, every launch of the band DCN, the bi-attention and
    the MSDA kernels adds its own formula's flops (`dcn_flops`,
    `bi_attention_flops`, `msda_flops`, at the launch's shapes) to
    acc[family]: what the wrappers' reports must sum to (`launches_seen`)."""
    from mqdet_torch.ops import bi_attention as ba
    from mqdet_torch.ops import deform_conv as dc
    from mqdet_torch.ops import ms_deform_attn as ms

    def seen(name, args, kw, out):
        if name == "dcn_band":
            x, off, _, w = args[:4]
            counts = {"dcn_pallas": dc.dcn_flops(off, x, w)}
        elif name == "bi_attention":
            q, k, dual = args[0], args[1], args[6]
            counts = {"flash_bi_attention": ba.bi_attention_flops(q.shape, k.shape[1], dual)}
        else:
            value, shapes, loc = args[:3]
            b, q, nh, _, p, _ = loc.shape
            counts = ms.msda_flops(shapes, b, q, nh, p, value.shape[-1], name == "ms_deform_attn_clip")
        for family, flops in counts.items():
            acc[family] = acc.get(family, 0.0) + flops

    return launches_seen(seen)


def entry_verdict(torch, got, want) -> tuple:
    """Phase 16.4's rule on one (group, image, chunk) entry, on the valid
    scores and on all the slots' scores (random-init MQ-GroundingDINO-T has
    no score over its box threshold, so the valid ones alone would compare
    nothing): (the larger max |diff| / bound of the sorted top 300 of each,
    the bound 2e-2 * their largest, that max |diff|, bitwise equal in every
    field)."""
    worst = (0.0, 0.0, 0.0)
    for masked in (True, False):
        top = [torch.sort(torch.where(d.valid, d.scores, 0.0) if masked else d.scores, -1,
                          descending=True).values[..., :300] for d in (got, want)]
        diff, scale = max_err(top[0], top[1])
        ratio = diff / (ERR_BOUND * scale) if scale > 0 else (0.0 if diff == 0 else math.inf)
        if ratio >= worst[0]:
            worst = (ratio, ERR_BOUND * scale, diff)
    same = all(torch.equal(getattr(got, f), getattr(want, f)) for f in ("boxes", "scores", "labels", "valid"))
    return worst + (same,)


def phase_batched(torch, label, model, cfg, make_batch, slots, per_group, seed, kres, predict=False):
    """Phase 17 for one model (module docstring): the image-batched LVIS
    protocol (`make_batched_protocol_fn`) at 800x1344, B = P17_B seeded
    images x 8 groups of CP 4 chunks, head batch 16. Returns the launch
    counts of its counted calls (the batched and per-image protocols, the
    flop-counted calls, `make_predict_fn`)."""
    from mqdet_torch.core.detections import Detections
    from mqdet_torch.engine.predict import make_batched_protocol_fn, make_predict_fn, make_protocol_fn
    from mqdet_torch.ops import launch_counts
    from mqdet_torch.utils import stats
    from mqdet_torch.utils.builders import protocol_inputs

    dev = torch.device("cuda")
    hw = (800, 1344)
    b, cp, groups = P17_B, P17_CP, P17_GROUPS
    _, text = protocol_inputs(cfg, make_batch, groups, cp, hw, seed)
    text = [t.to(dev) for t in text[:5]]  # input_ids, attention_mask, queries, query_mask, agg_map (G, CP, ...)
    wide_images, wide_sizes = batched_images(torch, seed, P17_B_WIDE, hw)
    images, sizes = wide_images[:b].to(dev), wide_sizes[:b].to(dev)
    want_call = {k: v * groups for k, v in per_group.items()}
    total = {k: 0 for k in per_group}

    def counted(fn, want, what):
        launch_counts(reset=True)
        out = fn()
        torch.cuda.synchronize()
        used = launch_counts()
        if want is not None and used != want:
            fail(f"phase 17 {label} {what}: launches {used} != predicted {want}")
        for k, v in used.items():
            total[k] += v
        return out

    # 17.1: each kernel at the batched shapes, on the model's activations, items 0 and last
    t0 = time.perf_counter()
    lines = []
    for n_img, kernels_ in ((b, ("dcn_band", "bi_attention", "ms_deform_attn_clip", "ms_deform_attn")),
                            (P17_B_WIDE, ("dcn_band", "bi_attention"))):
        keep = {}
        one_group = [t[:1] for t in text]
        with first_launches(keep):
            make_batched_protocol_fn(model, hw, cfg, n_img)(wide_images[:n_img].to(dev), wide_sizes[:n_img].to(dev),
                                                            *one_group)
        with torch.no_grad():
            for key, (args, out) in sorted(keep.items(), key=lambda kv: str(kv[0])):
                if key[0] in kernels_:
                    record, line = kept_launch_check(torch, label, f"B {n_img} x CP {cp}", key, args, out,
                                                     phase="phase 17", tag="batched", items=(0, n_img * cp - 1))
                    kres[key[0]].append(record)
                    lines.append(line)
        del keep
        torch.cuda.empty_cache()
    say(f"phase 17: {label} kernels at the batched protocol's shapes (head batch {b * cp} and {P17_B_WIDE * cp}), "
        f"one chunk group's first launch at each shape, items 0 and last against the plain version in fp32 on the "
        f"card (phase 2's rule, {ERR_BOUND} * max|ref|): {'; '.join(lines)} ({time.perf_counter() - t0!r} s)")

    # 17.2: the batched protocol, launches gated per call; then each image alone through the per-image protocol
    protocol = make_batched_protocol_fn(model, hw, cfg, b)
    torch.cuda.reset_peak_memory_stats()
    counted(lambda: protocol(images, sizes, *text), want_call, "batched protocol, warm-up")
    wall, events = [], []
    for i in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        dets = counted(lambda: protocol(images, sizes, *text), want_call, f"batched protocol, timed call {i}")
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1000.0)
        events.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    shapes_ok = tuple(dets.boxes.shape) == (groups, b * cp, slots, 4) and tuple(dets.valid.shape) == (
        groups, b * cp, slots)
    finite = bool(torch.isfinite(dets.boxes).all() and torch.isfinite(dets.scores).all())
    if not (shapes_ok and finite):
        fail(f"phase 17 {label}: batched output malformed (shapes {shapes_ok}, finite {finite})")
    p50 = statistics.median(wall)
    say(f"phase 17: {label} batched protocol, B {b} images x {groups} groups x CP {cp} (head batch {b * cp}) at "
        f"{hw}: {p50!r} ms a call p50 of 3 (host clock {[round(t, 3) for t in wall]}; CUDA events "
        f"{[round(t, 3) for t in events]}), {b * 1000.0 / p50!r} img/s, peak memory {peak!r} GiB; launches a call "
        f"{ {k: v for k, v in want_call.items() if v} } (= the per-image protocol's), gated on every call")

    single = make_protocol_fn(model, hw, cfg)
    worst, equal, valid, single_ms, per_image = (0.0, 0.0, 0.0), 0, 0, [], {}
    for i in range(b):
        sz = sizes[i].expand(groups, cp, 2).contiguous()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = counted(lambda: single(images[i:i + 1], *text, sz), want_call, f"per-image protocol, image {i}")
        single_ms.append((time.perf_counter() - t0) * 1000.0)
        per_image[i] = one
        for g in range(groups):
            for c in range(cp):
                got = Detections(**{f: getattr(dets, f)[g, i * cp + c] for f in ("boxes", "scores", "labels", "valid")})
                ref = Detections(**{f: getattr(one, f)[g, c] for f in ("boxes", "scores", "labels", "valid")})
                ratio, bnd, diff, same = entry_verdict(torch, got, ref)
                equal += same
                valid += int(ref.valid.sum())
                if ratio > 1.0:
                    fail(f"phase 17 {label}: entry (group {g}, image {i}, chunk {c}) apart from the per-image "
                         f"protocol: top-300 scores max |diff| {diff!r} > {bnd!r}")
                worst = max(worst, (ratio, diff, bnd))
    say(f"phase 17: {label} every entry (group, image i, chunk c) of the batched call against the per-image "
        f"protocol on image i (phase 16.4's rule: the sorted top 300 scores, of the valid slots and of all, within "
        f"{ERR_BOUND} * the largest): {groups * b * cp} entries ok ({valid} valid slots in the per-image runs), "
        f"worst max |diff| / bound {worst[0]!r} ({worst[1]!r} against {worst[2]!r}), {equal} bitwise equal; the "
        f"per-image calls {[round(t, 3) for t in single_ms]} ms (host clock)")

    if predict:  # 17.3: the one-call predict at batch 4, image i against chunk i of group 0
        fn = make_predict_fn(model, hw, cfg)
        prompts = [t[0] for t in text]  # (CP = 4, ...): prompt i for image i
        out = counted(lambda: fn(images, *prompts, sizes), per_group, "make_predict_fn at batch 4")
        worst_p = 0.0
        for i in range(b):
            got = Detections(**{f: getattr(out, f)[i] for f in ("boxes", "scores", "labels", "valid")})
            ref = Detections(**{f: getattr(dets, f)[0, i * cp + i] for f in ("boxes", "scores", "labels", "valid")})
            ratio, bnd, diff, _ = entry_verdict(torch, got, ref)
            if ratio > 1.0:
                fail(f"phase 17 {label}: make_predict_fn image {i} apart from the batched entry: {diff!r} > {bnd!r}")
            worst_p = max(worst_p, ratio)
        say(f"phase 17: {label} make_predict_fn at batch {b} (image i against chunk i): launches "
            f"{ {k: v for k, v in per_group.items() if v} } (gated), each image within phase 16.4's rule of the "
            f"batched call's entry (worst diff / bound {worst_p!r})")

    # 17.4: flops of one per-image call and one batched call: the operator counter plus the kernels' registry
    readings = {}
    for what, fn, n_img, ms_ in (
            ("per-image", lambda: single(images[:1], *text, sizes[0].expand(groups, cp, 2).contiguous()), 1,
             statistics.median(single_ms)),
            ("batched", lambda: protocol(images, sizes, *text), b, p50)):
        per_launch = {}
        with launch_flops(per_launch):
            flops = counted(lambda: stats.flops_with_kernels(fn), want_call, f"{what} call under flops_of")
        total_f, ops, registry = flops
        if registry != per_launch:
            fail(f"phase 17 {label} {what}: the registry {registry} != the launches' formulas {per_launch}")
        readings[what] = registry
        tflops = total_f / (ms_ / 1000.0) / 1e12
        say(f"phase 17: {label} {what} call ({n_img} image(s)): flops_of {total_f!r} = the operator counter "
            f"{ops!r} + the kernels' registry {registry} (each entry = its launches x the per-launch formula, "
            f"gated); {tflops!r} TFLOP/s at the p50 {ms_!r} ms, {tflops * 1e12 / PEAK_BF16!r} of {PEAK_BF16 / 1e12} "
            f"TFLOP/s")
    one, many = readings["per-image"], readings["batched"]
    if set(one) != set(many) or any(many[k] != b * one[k] for k in one):
        fail(f"phase 17 {label}: the batched registry {many} is not {b} x the per-image one {one}")
    say(f"phase 17: {label} the batched call's registry is {b} x the per-image call's, entry by entry (exact); "
        f"launches counted in phase 17 { {k: v for k, v in total.items() if v} }")
    del protocol, single, dets, per_image
    torch.cuda.empty_cache()
    return total


# ---- phase 18: the measurement tools ------------------------------------------


def tool_numbers(x):
    """The numbers of a tool's JSON record (nested dicts and lists), with
    their keys."""
    if isinstance(x, dict):
        for k, v in x.items():
            if isinstance(v, (dict, list)):
                yield from ((f"{k}.{kk}", vv) for kk, vv in tool_numbers(v))
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                yield k, float(v)
    elif isinstance(x, list):
        for v in x:
            yield from tool_numbers(v)


def tool_gate(records) -> None:
    """Phase 18's gate on every (tool, record): each number finite, each
    time (a key holding `_ms` or ending in `_s`) above 0."""
    for tool, rec in records:
        for k, v in tool_numbers(rec):
            if not math.isfinite(v) or (("_ms" in k or k.endswith("_s")) and v <= 0):
                fail(f"phase 18 {tool}: {k} = {v!r} in {rec}")


def phase_tools(torch, model, cfg, seed, ref, smi):
    """Phase 18 (MQ-GLIP-T, right after its phase 17): every measurement tool
    of `mqdet_torch/tools/` that evaluates, through its function, on phase
    4's model at reduced repetitions, each JSON line printed: perf_trace's
    lines from phase 5's report of the default protocol (`ref["trace"]`;
    gated: the families' totals sum to `device_total_ms`); perf_bisect (1 +
    3 calls a key), perf_bisect2, perf_head_once (1 + 4 runs; launches 78
    `dcn_band` + 6 `bi_attention` a group), perf_postproc, perf_fusion (1 +
    2 runs; one `bi_attention` a stage under `pallas`, none under `xla`),
    perf_protocol_sweep at CP 8 and 16 (1 + 2 runs; launches 78 + 6 a
    group, each entry (g, c) within phase 16.4's rule of phase 4's entry
    (0, c % 4), `ref["dets"]`: the same image and chunks) and
    perf_bucket_churn (one timed run a pixel count; the 800x1344 geometry's
    first call is warm: phase 4 ran it). Every number finite, every time
    above 0 (`tool_gate`). The launches are the tools' own, counted in no
    path of the kernel line."""
    from mqdet_torch.core.detections import Detections
    from mqdet_torch.tools import (
        perf_bisect, perf_bisect2, perf_bucket_churn, perf_fusion, perf_head_once, perf_postproc,
        perf_protocol_sweep, perf_trace,
    )
    from mqdet_torch.utils.builders import protocol_inputs, synthetic_batch

    t_phase = time.perf_counter()
    dev, hw = torch.device("cuda"), (800, 1344)
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    group = {k: v for k, v in predicted(dcn_band=stages * (3 * levels - 2), bi_attention=stages).items() if v}
    records, seconds = [], {}

    def show(tool):
        def emit(rec):
            records.append((tool, rec))
            say(f"phase 18: {tool} {json.dumps(rec)}")
        return emit

    def timed(tool, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[tool] = time.perf_counter() - t0
        return out

    rep = ref["trace"]
    for line in perf_trace.lines(rep):
        show("perf_trace")(line)
    fam = sum(ms for _, ms, _, _ in rep["families"])
    if not (rep["kernels"] and math.isclose(fam, rep["device_total_ms"], rel_tol=1e-9)):
        fail(f"phase 18 perf_trace: the families sum to {fam!r} ms, device_total_ms {rep['device_total_ms']!r}")
    image, text = protocol_inputs(cfg, synthetic_batch, 1, 4, hw, seed)
    image, text = image.to(dev), [t.to(dev) for t in text]
    timed("perf_bisect", lambda: perf_bisect.bisect(model, cfg, hw, image, text, 3, 1, emit=show("perf_bisect")))
    timed("perf_bisect2", lambda: perf_bisect2.bisect2(model, cfg, hw, image, text, 3, emit=show("perf_bisect2")))
    rec = timed("perf_head_once", lambda: perf_head_once.head_once(model, cfg, hw, image, text, 4, 1))
    show("perf_head_once")(rec)
    if rec["launches_per_group"] != group:
        fail(f"phase 18 perf_head_once: launches {rec['launches_per_group']} != predicted {group}")
    timed("perf_postproc", lambda: perf_postproc.postproc(dev, iters=3, warmup=1, emit=show("perf_postproc")))
    fus = timed("perf_fusion", lambda: perf_fusion.fusion(dev, reps=2, warmup=1, emit=show("perf_fusion")))
    if [r["launches_per_stage"] for r in fus] != [{"bi_attention": 1}, {}]:
        fail(f"phase 18 perf_fusion: launches a stage {[r['launches_per_stage'] for r in fus]} != "
             f"[{{'bi_attention': 1}}, {{}}]")
    recs, dets = timed("perf_protocol_sweep", lambda: perf_protocol_sweep.sweep(
        model, cfg, hw, (8, 16), runs=2, warmup=1, seed=seed, emit=show("perf_protocol_sweep")))
    worst = (0.0, 0.0, 0.0)
    fields = ("boxes", "scores", "labels", "valid")
    for r in recs:
        want = {k: v * r["groups"] for k, v in group.items()}
        if r["launches"] != want:
            fail(f"phase 18 perf_protocol_sweep CP {r['cp']}: launches {r['launches']} != predicted {want}")
        d = dets[r["cp"]]
        for g in range(r["groups"]):
            for c in range(r["cp"]):
                got = Detections(**{f: getattr(d, f)[g, c] for f in fields})
                base = Detections(**{f: getattr(ref["dets"], f)[0, c % 4] for f in fields})
                ratio, bnd, diff, _ = entry_verdict(torch, got, base)
                if not (ratio <= 1.0 and bool(torch.isfinite(got.boxes).all())):
                    fail(f"phase 18 perf_protocol_sweep CP {r['cp']}: entry ({g}, {c}) apart from phase 4's "
                         f"(0, {c % 4}): top-300 scores max |diff| {diff!r} > {bnd!r}")
                worst = max(worst, (ratio, diff, bnd))
    say(f"phase 18: perf_protocol_sweep: every entry at CP 8 and 16 within phase 16.4's rule of phase 4's "
        f"(worst max |diff| / bound {worst[0]!r}: {worst[1]!r} against {worst[2]!r})")
    del dets
    timed("perf_bucket_churn", lambda: perf_bucket_churn.churn(model, cfg, runs=1,
                                                               emit=show("perf_bucket_churn")))
    tool_gate(records)
    say(f"phase 18: the evaluation tools on MQ-GLIP-T ({smi}): {len(records)} lines, every number finite and every "
        f"time above 0; seconds by tool { {k: round(v, 3) for k, v in seconds.items()} }; "
        f"{time.perf_counter() - t_phase!r} s in all")


def phase_tools_train(torch, model, cfg, smi):
    """Phase 18 (after phase 8): perf_train_step on phase 8's model (its
    training config; TPU.REMAT as phase 8 built it) at batch 4, 1 warm-up and
    2 timed steps: launches 78 `dcn_band` a step, every number finite, every
    time above 0, the batch held (no out-of-memory record)."""
    from mqdet_torch.tools import perf_train_step

    t0 = time.perf_counter()
    records = []
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    (rec,) = perf_train_step.train_points(model, cfg, [4], tuple(cfg.TPU.IMAGE_BUCKETS[0]), warm=1, timed=2,
                                          emit=lambda r: records.append(("perf_train_step", r)))
    say(f"phase 18: perf_train_step {json.dumps(rec)}")
    if "error" in rec:
        fail(f"phase 18 perf_train_step: batch 4 did not run: {rec['error']}")
    if rec["launches_per_step"] != {"dcn_band": stages * (3 * levels - 2)}:
        fail(f"phase 18 perf_train_step: launches a step {rec['launches_per_step']}")
    tool_gate(records)
    say(f"phase 18: perf_train_step on phase 8's model ({smi}): {time.perf_counter() - t0!r} s")


CPU_JOBS = ("phase 16 GDINO-3", "phase 8", "phase 9") + tuple(f"phase 16 {arch}" for arch in LEGACY_HEADS) + (
    "phase 14 S1",)  # by need
S1_BANK = "glip_bank.npz"  # phase 7's MQ-GLIP-T bank, saved for the worker's phase 14 S1 job


def cpu_reference_job(torch, name, seed, out_dir):
    """One CPU_JOBS entry, from the seed and the configs alone: the CPU runs
    of phase 8's, 9's or 16.2's reference step (with the weights' `digest`)
    or of phase 16.5's reference step for one head; or, once phase 7's
    MQ-GLIP-T bank is in out_dir/S1_BANK, of phase 14's S1 reference step
    (with the S1 model's `digest`)."""
    from mqdet_torch.utils.builders import build_model, init_params, mq_glip_t_config, mq_glip_t_pretrain_config, \
        mq_groundingdino_t_config

    if name == "phase 14 S1":
        from mqdet_torch.mq.bank import QueryBank

        path = os.path.join(out_dir, S1_BANK)
        while not os.path.exists(path):
            time.sleep(0.5)
        bank = QueryBank.load(path)
        model = switch_model(torch, switch_config(mq_glip_t_config(), "S1"), seed, s1_selector(bank))
        cfg, edit = s1_train_config(bank, seed)
        return train_reference_cpu(torch, cfg, model, seed, edit), digest(dict(model.named_parameters()))
    if name == "phase 16 GDINO-3":
        _, cfg, model = gdino3_models(torch, init_params(build_model(mq_groundingdino_t_config()), seed=seed), seed)
        runs = gdino_reference_cpu(torch, cfg, model, seed)
    elif name.startswith("phase 16 "):
        return legacy_reference_cpu(torch, name.split()[-1], seed)
    else:
        cfg = mq_glip_t_pretrain_config() if name == "phase 8" else train_config_gdino()
        model = init_params(build_model(cfg), seed=seed)
        runs = (train_reference_cpu if name == "phase 8" else gdino_reference_cpu)(torch, cfg, model, seed)
    return runs, digest(dict(model.named_parameters()))


def cpu_reference_worker(out_dir: str, seed: int, threads: int) -> int:
    """The worker process (`CpuReferences`): every CPU_JOBS entry in order,
    each saved to out_dir/<job>.pt when done."""
    import torch

    sys.path.insert(0, REPO)
    torch.set_num_threads(threads)
    for name in CPU_JOBS:
        t0 = time.perf_counter()
        result = cpu_reference_job(torch, name, seed, out_dir)
        path = os.path.join(out_dir, name.replace(" ", "_") + ".pt")
        torch.save(result, path + ".tmp")
        os.replace(path + ".tmp", path)
        say(f"cpu reference worker: {name} done in {time.perf_counter() - t0!r} s")
    return 0


class PhaseClock:
    """Seconds by part of the run: `lap(name)` books the time since the last lap."""

    def __init__(self):
        self.last, self.laps = time.perf_counter(), {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = self.laps.get(name, 0.0) + now - self.last
        self.last = now

    def line(self) -> str:
        return "; ".join(f"{k} {v!r}" for k, v in self.laps.items())


class CpuReferences:
    """The training reference steps' CPU runs (CPU_JOBS: phases 16.2, 8, 9
    and 16.5, which need only the seed and the configs, and phase 14's S1,
    which waits for phase 7's bank in out_dir/S1_BANK), made by a worker
    process of this script (`--cpu-references`) while the card runs the
    earlier phases; `get(job)` waits for one and loads it. The worker takes as many
    threads as this process (`os.cpu_count()`): the CPU's sums, and so the
    gates' readings, depend on the thread count (phase 16.2's reference step
    read 0.96 of its bound at 8 threads, 1.88 at 4), so each run stays the
    one it was in this process. `paused()` stops it while this process
    makes CPU references of its own (two sets of threads on the cores slowed
    both), so it runs while this one drives the card. The worker is killed
    at exit."""

    def __init__(self, torch, seed: int, out_dir: str):
        self.torch, self.dir = torch, out_dir
        self.threads = os.cpu_count() or 1
        self.log = open(os.path.join(out_dir, "cpu_references.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-references", out_dir, str(seed), str(self.threads)],
            stdout=self.log, stderr=subprocess.STDOUT, cwd=REPO, env=dict(os.environ, OMP_WAIT_POLICY="PASSIVE"))
        self.waited = {}
        atexit.register(self.stop)

    @contextlib.contextmanager
    def paused(self):
        """The worker stopped (SIGSTOP) for the block, continued after it."""
        running = self.proc.poll() is None
        if running:
            os.kill(self.proc.pid, signal.SIGSTOP)
        try:
            yield
        finally:
            if running and self.proc.poll() is None:
                os.kill(self.proc.pid, signal.SIGCONT)

    def get(self, name: str):
        path = os.path.join(self.dir, name.replace(" ", "_") + ".pt")
        t0 = time.perf_counter()
        while not os.path.exists(path):
            if self.proc.poll() is not None:
                self.log.flush()
                with open(self.log.name) as f:
                    tail = f.read()[-4000:]
                fail(f"the CPU reference worker exited {self.proc.returncode} before {name}:\n{tail}")
            time.sleep(0.5)
        self.waited[name] = time.perf_counter() - t0
        return self.torch.load(path, weights_only=False)

    def summary(self) -> str:
        with open(self.log.name) as f:
            done = [line.strip() for line in f if line.startswith("cpu reference worker")]
        return (f"the CPU reference worker ({self.threads} threads): {'; '.join(done)}; the phases waited for it "
                f"{ {k: round(v, 3) for k, v in self.waited.items()} } s")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


def checked_weights(torch, name, result, model_cpu):
    """`result` of a phase 8 / 9 job without its weights' `digest`, after
    holding it to `model_cpu`'s: the worker drew the same weights."""
    runs, weights = result
    if weights != digest(dict(model_cpu.named_parameters())):
        fail(f"{name}: the CPU reference worker's weights differ from this process's")
    return runs


def multi_card(torch, cards, seed) -> int:
    """`--cards N`: phase 13's MQ-GLIP-T training check over NCCL across N
    cards of one host. The bank is pooled over phase 7's dataset by
    `tools.train.extract_bank` with phase 7's model and settings; the
    global batches are the train loader's at batch N over the landscape
    images; phase 8's reference step's CPU runs (`phase_train_reference`
    on this host, without its card step, which phase 8 gates) give each
    tensor's bound, as phase 13 takes them; the one process on card 0 gives the reference and the card's
    noise (`dp_reference` over 4 perturbed runs, images x(1 +- 1e-3) and
    x(1 +- 2e-3), the elementwise largest); N ranks, one a card, take 1
    image each (`spawn_ranks` over NCCL) and `dp_verdict` gates them by
    phase 13's rule: each bound the larger of phase 8's CPU bound for the
    tensor and twice the card's noise. Launches: 78 `dcn_band` a step a
    rank."""
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
    torch.set_num_threads(os.cpu_count() or 1)
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
    model_cpu = init_params(build_model(glip_cfg), seed=seed)
    bounds = {}
    phase_train_reference(torch, glip_cfg, model_cpu, seed, bounds, card=False)
    torch.cuda.empty_cache()
    batches = loader_batches(glip_cfg, landscape(ds), bank, 2)
    torch.save(batches, os.path.join(root, "glip_batches.pt"))
    ref = dp_reference(torch, glip_cfg, model_cpu, batches, dev, root, "one_glip")
    torch.cuda.empty_cache()
    spec = {"seed": seed, "backend": "nccl", "tag": "cards", "parts": ["glip"], "timing": True,
            "glip_batches": os.path.join(root, "glip_batches.pt")}
    t1 = time.perf_counter()
    got = spawn_ranks(torch, spec, cards, root)
    if any(r["backend"] != "nccl" or r["world"] != cards for r in got):
        fail(f"--cards: ranks report {[(r['backend'], r['world']) for r in got]}")
    say(f"--cards {cards}: {cards} rank processes over NCCL, one a card; {time.perf_counter() - t1!r} s")
    gates = [n for n in bounds if re.fullmatch(r".*qv_layer\.\d+\.attn_gate\.norm\.bias", n)]
    say(f"--cards {cards}: phase 8's CPU bounds of the GCP attention gates' norm biases (ROADMAP Queue C 3): "
        + "; ".join(f"{n} {bounds[n]!r}, the card's noise x2 {[2 * nz[n] for nz in ref['noise']]!r}" for n in gates))
    dp_verdict(torch, f"MQ-GLIP-T training over NCCL on {cards} cards", ref, got, root, "cards", "glip", bounds, smi)
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
    if sys.argv[1:2] == ["--cpu-references"]:  # the CPU reference worker (`CpuReferences`)
        return cpu_reference_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=2, help="timed protocol runs per model")
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
    tmp = tempfile.TemporaryDirectory()  # phase 7's synthetic dataset and the CPU references; removed at exit
    refs = CpuReferences(torch, args.seed, tmp.name)  # phases 8, 9 and 16.5's CPU runs, made meanwhile
    clock = PhaseClock()

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

    kres, sweep_launches = phase_kernels(torch, args.seed)
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    torch.set_num_threads(os.cpu_count() or 1)
    launches = {"perf_dcn_sweep": sweep_launches}
    clock.lap("1-2 (build, kernels)")

    # ---- MQ-GLIP-T -------------------------------------------------------
    cfg = mq_glip_t_config()
    cfg.MODEL.ATSS.DETECTIONS_PER_IMG = 300
    model_cpu = init_params(build_model(cfg), seed=args.seed).eval()
    model = copy.deepcopy(model_cpu).to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    with refs.paused():  # the CPU references of phase 3
        launches.update(phase_reference_glip(torch, cfg, model_cpu, model, args.seed))
        phase_reference_extract(torch, "MQ-GLIP-T", cfg, model_cpu, model, args.seed, (True, False))
    glip_cpu = model_cpu  # phase 15's towers share its weights; phases 8 and 13 train copies of it
    del model_cpu
    stages, levels = cfg.MODEL.DYHEAD.NUM_CONVS, len(cfg.MODEL.RPN.ANCHOR_STRIDE)
    groups = -(-31 // 4)
    dcn, fuse = groups * stages * (3 * levels - 2), groups * stages
    tower = model.rpn.head.dyhead_tower
    parts = {"image tower": [model.backbone.body, model.backbone.fpn], "language tower": [model.language_backbone],
             "VLFuse": list(tower[0::3]), "head BERT layers": list(tower[1::3]), "DyConv": list(tower[2::3])}
    # default last: its phase 6 (synchronised split) ends a model's runs, because
    # protocols timed right after it read 7-24% slower with the same device busy time
    glip_ref = {}  # phase 4's default run's detections and phase 5's trace, for phase 18
    for switch, deform, want in (
        ("stream", None, predicted(dcn_band=dcn, bi_attention_levels=fuse * levels)),  # one launch per level
        ("dual", None, predicted(dcn_band=dcn, bi_attention_dual=fuse)),
        ("default", "window", predicted(dcn_gather_clip=dcn, bi_attention=fuse)),  # K2 in the protocol
        ("default", "gather", predicted(dcn=dcn, bi_attention=fuse)),  # the exact mode in the protocol
        ("default", None, predicted(dcn_band=dcn, bi_attention=fuse)),
    ):
        main_run = switch == "default" and deform is None  # phase 5 profiles the default runs alone
        launches[f"MQ-GLIP-T {switch}{' ' + deform if deform else ''}"] = phase_protocol(
            torch, "MQ-GLIP-T", model, cfg, synthetic_batch, 300, want, args.runs if main_run else 0, args.seed,
            parts if main_run else None, switch, deform, profile=main_run, keep=glip_ref if main_run else None,
        )
    glip_vq = {}  # phase 7's dataset and bank, for phase 8
    launches.update(phase_vision_query(torch, "MQ-GLIP-T", cfg, model, args.seed,
                                       predicted(dcn_band=dcn, bi_attention=fuse), tmp.name, 300, glip_vq))
    glip_vq["bank"].save(os.path.join(tmp.name, "bank.tmp.npz"))  # for the worker's phase 14 S1 job
    os.replace(os.path.join(tmp.name, "bank.tmp.npz"), os.path.join(tmp.name, S1_BANK))
    del tower, parts
    clock.lap("GLIP-T 3-7")
    # phase 15 for MQ-GLIP-T: the TTA buckets, TTA, knowledge (the towers and Swin versions after phase 17)
    per_group = predicted(dcn_band=stages * (3 * levels - 2), bi_attention=stages)
    phase_tta_kernels(torch, "MQ-GLIP-T", model, cfg, synthetic_batch, args.seed, kres)
    launches.update(phase_tta(torch, "MQ-GLIP-T", cfg, model, glip_vq, per_group))
    launches.update(phase_knowledge(torch, cfg, model, glip_vq, tmp.name, per_group))
    clock.lap("GLIP-T 15")
    launches["MQ-GLIP-T merged canvas"] = phase_merged_canvas(torch, model, cfg, args.seed)
    launches["MQ-GLIP-T MQDET_FUSION_IMPL=xla group"] = phase_fusion_impl(torch, model, cfg, args.seed)
    launches["MQ-GLIP-T demo"] = phase_demo(torch, "MQ-GLIP-T", model, cfg, args.seed, per_group)
    clock.lap("GLIP-T 16")
    launches["MQ-GLIP-T batched protocol"] = phase_batched(torch, "MQ-GLIP-T", model, cfg, synthetic_batch, 300,
                                                           per_group, args.seed, kres, predict=True)
    clock.lap("GLIP-T 17")
    phase_tools(torch, model, cfg, args.seed, glip_ref, smi)
    clock.lap("GLIP-T 18")
    del model, glip_ref  # nothing of MQ-GLIP-T may stay on the card
    torch.cuda.empty_cache()
    with refs.paused():  # the towers' CPU references
        launches.update(phase_towers(torch, cfg, glip_cpu, args.seed, per_group))
    torch.cuda.empty_cache()
    clock.lap("GLIP-T 15")

    # ---- MQ-GroundingDINO-T ----------------------------------------------
    cfg = mq_groundingdino_t_config()
    g = cfg.GROUNDINGDINO
    model_cpu = init_params(build_model(cfg), seed=args.seed).eval()
    model = copy.deepcopy(model_cpu).to(dev, torch.bfloat16).to(memory_format=torch.channels_last)
    with refs.paused():
        launches["MQ-GroundingDINO-T reference"] = phase_reference_gdino(torch, cfg, model_cpu, model, args.seed)
        phase_reference_extract(torch, "MQ-GroundingDINO-T", cfg, model_cpu, model, args.seed, (True,))
    gdino_cpu = model_cpu  # phases 9 and 13 train copies of it (the training config builds the same tensors)
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
            args.runs if switch == "default" else 0, args.seed, parts if switch == "default" else None, switch,
            profile=switch == "default",
        )
    gdino_vq = {}  # phase 7's dataset and bank, for phase 9
    launches.update(phase_vision_query(
        torch, "MQ-GroundingDINO-T", cfg, model, args.seed,
        predicted(ms_deform_attn_clip=enc, ms_deform_attn=dec, bi_attention=fuse), tmp.name, g.num_queries,
        gdino_vq))
    del tr, parts
    clock.lap("GDINO-T 3-7")
    gdino_group = predicted(ms_deform_attn_clip=g.enc_layers, ms_deform_attn=g.dec_layers, bi_attention=g.enc_layers)
    phase_tta_kernels(torch, "MQ-GroundingDINO-T", model, cfg, synthetic_caption_batch, args.seed, kres)
    launches.update(phase_tta(torch, "MQ-GroundingDINO-T", cfg, model, gdino_vq, gdino_group))
    clock.lap("GDINO-T 15")
    launches["MQ-GroundingDINO-T demo"] = phase_demo(torch, "MQ-GroundingDINO-T", model, cfg, args.seed, gdino_group)
    clock.lap("GDINO-T 16")
    launches["MQ-GroundingDINO-T batched protocol"] = phase_batched(
        torch, "MQ-GroundingDINO-T", model, cfg, synthetic_caption_batch, g.num_queries, gdino_group, args.seed, kres)
    clock.lap("GDINO-T 17")
    del model
    torch.cuda.empty_cache()
    launches.update(phase_gdino3(torch, gdino_cpu, args.seed, kres, refs))  # phase 16: the model at 3 levels
    torch.cuda.empty_cache()
    clock.lap("GDINO-T 16")

    say(f"phases 1-7 and 15-17 (its model paths) done {time.perf_counter() - t_start!r} s after the start")

    # ---- phases 8 and 9: modulated pre-training -------------------------
    glip_bounds, gdino_bounds = {}, {}  # the reference steps' bounds, for phase 13
    cpu = checked_weights(torch, "phase 8", refs.get("phase 8"), glip_cpu)
    clock.lap("waiting for phase 8's CPU runs")
    trained = {}  # phase 8's model, for phase 18's training step
    launches["MQ-GLIP-T training"] = phase_train(torch, args.seed, glip_vq["dataset"], glip_vq["bank"], smi,
                                                 glip_bounds, copy.deepcopy(glip_cpu), cpu=cpu, keep=trained)
    clock.lap("8")
    phase_tools_train(torch, trained["model"], trained["cfg"], smi)
    del trained
    torch.cuda.empty_cache()
    clock.lap("18 (training step)")
    cpu = checked_weights(torch, "phase 9", refs.get("phase 9"), gdino_cpu)
    clock.lap("waiting for phase 9's CPU runs")
    launches["MQ-GroundingDINO-T training"] = phase_train_gdino(torch, args.seed, gdino_vq["dataset"],
                                                                gdino_vq["bank"], smi, gdino_bounds,
                                                                copy.deepcopy(gdino_cpu), cpu=cpu)
    del cpu
    clock.lap("9")
    say(f"phases 1-9 done {time.perf_counter() - t_start!r} s after the start")

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
    clock.lap("10")

    say(f"phases 1-10 done {time.perf_counter() - t_start!r} s after the start")

    # ---- phases 11 and 12: MQ-GLIP-L --------------------------------------
    l_root = os.path.join(tmp.name, "glip_l")
    os.makedirs(l_root)
    glip_l = {}  # phase 11's model on the CPU and .pth, for phase 12
    launches.update(phase_glip_l(torch, args.seed, args.runs, smi, l_root, configs, glip_l))
    launches["MQ-GLIP-L finetune"] = phase_finetune(torch, args.seed, glip_l, l_root, smi)
    del glip_l
    torch.cuda.empty_cache()
    clock.lap("11-12")

    # ---- phase 13: data parallel on the one card ------------------------
    launches.update(phase_data_parallel(torch, args.seed, smi, glip_vq, gdino_vq, glip_bounds, gdino_bounds,
                                        glip_cpu, gdino_cpu))
    del glip_cpu, gdino_cpu
    clock.lap("13")
    say(f"phases 1-13 done {time.perf_counter() - t_start!r} s after the start")

    # ---- phase 14: MQ-Det's model switches ------------------------------
    launches.update(phase_switches(torch, args.seed, args.runs, smi, glip_vq,
                                   cpu=lambda m: checked_weights(torch, "phase 14", refs.get("phase 14 S1"), m)))
    clock.lap("14")
    say(f"phases 1-14 done {time.perf_counter() - t_start!r} s after the start")

    # ---- phase 16: the legacy detector family, pooling ------------------
    phase_legacy_reference(torch, args.seed)
    phase_legacy_train(torch, args.seed, smi, cpu=lambda arch: refs.get(f"phase 16 {arch}"))
    phase_pools(torch, args.seed)
    clock.lap("16 (legacy, pooling)")
    say(refs.summary())
    refs.stop()
    say(f"seconds by phase: {clock.line()}")

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
