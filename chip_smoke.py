#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from quber_tpu_torch/ops/csrc into build/kernels/,
     and time a kernel that does nothing through the same launch path: the
     floor of every kernel time below (printed as floor_ms);
  3. hold each kernel against its plain torch version on the card at the
     main path's shapes (instance statistics and encode: 64 masks at
     480x640; group: K = 32 and K = 200 and an all-invalid table) -- areas,
     centroids and ids exact, encode within 1e-6 -- and time kernel and
     plain version with CUDA events (median of 30, L2 flushed before each);
     then the shapes that the kernels treat specially, untimed: a 359x477
     frame and views that are not 16-byte aligned (the scalar variants), a
     361x400 frame (ragged tiles), 300 ok instances (owners above 255), no
     instance and one, K = 1, K = 33, K = 4096 with the only valid centre
     last, and B = 8 at 359x477;
  4. serve 8 seeded synthetic 480x640 frames through
     MaskRefinerPredictor(device="cuda").predict with the in-repo int8
     flagship weights, and check that the three kernels were launched;
  5. run the first frame again on the CPU and require the same instance
     count and >= 99.5% panoptic agreement;
  6. hold the batched kernels against their plain versions at B = 8 and
     480x640 in every frame (instance statistics and encode: 64 slots, a different number of ok
     instances per frame, empty and invalid slots, a frame with none valid;
     group: K = 32 and K = 200, a different valid count per frame, a frame
     with none valid) -- statistics and ids exact, encode within 1e-6 -- and
     time them as in phase 3;
  7. serve 20 seeded frames through predict_batch in batches of 8 (the last
     one padded with copies of its first frame), require one launch of each
     batched kernel and of the statistics kernel per batch and none of the
     single-frame ones, and per
     frame the single-frame predict's instance count and >= 99.5% of its
     panoptic labels;
  8. serve the same frames through stage_frames + predict_batch_stream_staged
     and through predict_batch_stream(prefetch=2); both must give
     predict_batch's panoptic maps and counts exactly and its scores within
     rtol 1e-6. Frames per second of the three paths (median of 3 passes
     after a warm one), and the device time the per-batch host sync leaves
     the compute stream idle;
  9. refine one 360x480 frame through MultiScalePredictor (480x640 bucket):
     finite outputs of the input's size, all three kernels launched;
 10. training targets on the card: pack 8 seeded rendered scenes at 480x640
     with 32 instance slots, build_targets on the card and on the CPU (plain
     versions): sem_seg, the weights, eee_mask and eee_boundary exact,
     center, offset and offset_enc within 1e-5; the batched statistics kernel
     launched twice and the batched encode kernel once, no single-frame
     launch; both kernels timed against floor and bound at this shape;
 11. train steps at full width: the flagship config at 480x640, batch 8,
     from the int8 weights, a device pool of 16 scenes, 12 device-target
     steps: every loss finite at every step, FrozenBN tensors bit-equal
     before and after, every trainable tensor changed, the loss over the
     whole pool (eval mode) lower after the steps than before, two
     statistics launches and one encode launch a step; per-step ms (median
     of steps 3-12), the breakdown and the peak device memory;
 12. card against CPU: one step at batch 2, 128x160, full depth, dropout 0,
     from the same state: each loss within rtol 1e-3, the gradient of every
     trainable tensor with cosine similarity >= 0.999 (but the conv biases
     ahead of a batch-statistics BatchNorm: their gradient is exactly zero,
     and must come back as noise below 1e-3 of their weight's);
 13. checkpoint: save_state after step 12, restore_state into a fresh state,
     step 13 from both gives the same losses within rtol 1e-6;
 14. evaluation: write the first 16 frames of the synthetic-OSD anchor
     protocol (seed 1000, depth range 250-1500 mm, 0.2% depth dropout) with
     data/make_synthetic_dataset.py into a temporary directory, read them
     back through the OSD walker, and run the port's run_eval with the
     PerturbedGT base and the unfiltered refiner on the card, per image
     (one statistics, encode and group launch per frame, no batched launch)
     and streamed in batches of 8 (one launch of each batched kernel per
     batch), each pass reading its frames: per frame the same instance
     count and >= 99.5% of the refined labels, aggregate means within 0.005;
     the per-image means against the JAX package's float32 ones on the CPU
     (quber_tpu_torch/evaluation/reference_synth_osd16.json): Objects and
     Boundary F of the initial stage exactly, of the refined stage within
     2e-4, tight enough to catch bf16 or TF32 convolutions; the kernels held
     against their plain versions at the evaluation frames' shapes; then the
     foreground filter:
     two frames through LMFFNet and one through CGNet (random init from a
     fixed generator), finite logits, a [480, 640] bool foreground and >= 99%
     of the argmax equal to the same net's on the CPU; seconds per frame by
     stage. The frames the per-image pass read are kept for phases 16-19;
 15. the kernels at the shapes of the bfloat16 serving configuration and the
     benchmark: single-frame statistics and encode at N = 24 and group at
     K = 24 (below fast_top_k: no fast path); at B = 16, statistics and
     encode at N = 24 and N = 64 and group at K = 24 and K = 200 -- exact,
     encode within 1e-6 -- timed as in phase 3;
 16. bfloat16 evaluation: the 16 frames of phase 14 through run_eval with a
     MaskRefinerConfig(dtype="bfloat16") refiner, per image: the initial
     stage exactly the JAX package's; per frame the labels against phase
     14's float32 pass: at most 5 frames moved (another count or < 99.9% of
     the labels; the JAX package's own bf16 moves 5); on frames 1 and 6,
     each output's mean |bf16 - float32| within 0.5-2x the JAX package's own
     on that frame, where a float32 forward (0) and a float16 one, both run
     as controls, must fall outside; printed, not gated: the refined means
     against the JAX package's float32 and bfloat16 means;
 17. checkpoint evaluation: the state saved after phase 11's steps,
     evaluated on 4 frames through run_eval_torch.py's main from its
     checkpoint directory, must give the CSV rows of run_eval on the same
     weights held in memory, exactly;
 18. the CLIs on the card, in two subprocesses at once, with the
     bfloat16 serving config (24 candidates): predict_torch.py on one
     written frame and demo_torch.py on 2 (GT base model, one batch); each
     frame's instance count equal to the same predictor's in this process,
     whose single-frame and batched launches are counted;
 19. bench_torch.py at 32 frames (phase 14's 16 frames twice), one pass of
     each configuration: its JSON line, and the launches of the batched
     kernels at B = 16;
 20. the ablation variants at full width (480x640, float32, TF32 off):
     nohf, noeee, rgbd_add_l3, rgb_only, depth only and the
     Panoptic-DeepLab config as MaskRefiners, and the PanopticDeepLab
     module, each from one seeded init (the flagship beside them as the
     control), on the first frame of phase 14 on the card and on the CPU:
     every output's max |card - CPU| within ABLATION_RTOL of its max |CPU|;
     each MaskRefiner variant once through predict() on the card with one
     statistics, encode and group launch; one rgb_only train step card
     against CPU as in phase 12;
 21. UCN: (a) train_zoo_torch's steps at 480x640 on a pool of two rendered
     scenes, card against CPU from the same init (losses rtol 1e-3, first
     gradients cosine >= 0.999, weights and BatchNorm statistics within 2.1
     learning rates a step), then 40 more steps on the card (ms a step,
     peak memory), the weights saved as train_zoo_torch saves them;
     (b) cluster_embeddings on the card and the CPU on the card's
     embeddings of phase 14's 16 frames: the same instance count and
     >= 99.5% of the labels on every frame, the frames below 100% listed;
     (c) those frames through run_eval with base model "ucn" (the weights
     through $QUBER_UCN_CKPT) and the flagship int8 refiner, per image (one
     statistics, encode and group launch a frame) and streamed at B = 8
     (one batched launch a batch): the base masks equal, the refined ones
     as in phase 14; the means printed; (d) two frames of ucn-zoomin, card
     against CPU (count equal, >= 99.5% of the labels);
 22. training from files: (a) phase 14's 16 frames made a UOAIS-Sim-layout
     panoptic set by the port's detection2panoptic, perturbate_masks
     (Felzenszwalb-seeded) and panoptic2eee (data/make_uoais_sim.py) and
     registered; (b) 4 device-target steps of the flagship at batch 8 and
     480x640 from the int8 weights, the batches read from those files by
     PackedMapper with SSD colour and Perlin on: finite losses, two
     statistics launches and one batched encode launch a step, no
     single-frame launch, and the first file-packed batch's targets on the
     card against the CPU as in phase 10; (c) two host-target steps through
     the multi-scale PerturbedPanopticMapper (min_size_train 384 and 480):
     one bucket a batch, zero loss weights in every margin; (d) the worker
     loader with 2 processes gives the in-process loader's first 2 batches
     byte for byte (augmentation off); (e) CGNet and LMFFNet, 10 steps each
     at batch 8 on phase 14's frames (train_fg_torch's samples): finite
     losses, the pool's loss lower after than before, one step at batch 2
     on the card against the CPU (loss rtol 1e-4, gradient cosine >=
     0.999), and the CGNet saved as train_fg_torch saves it filtering a
     frame through $QUBER_CGNET_CKPT;
 23. the base-segmenter zoo: (a) MSMFormer and UOAIS-Net at 480x640 from
     one seeded init, float32 (TF32 off) on the card against the CPU (every
     output within ZOO_RTOL of max |CPU|, the selections equal; a TF32
     forward of UOAIS-Net must fail its gate), then
     bfloat16 on the card (finite, the distance to float32 printed); (b)
     train_zoo_torch's msmformer and uoaisnet steps at 480x640 on two
     rendered scenes, card against CPU from the same init in float32, the
     second step from the CPU's state after the first (losses rtol 1e-3, at
     MSMFormer's second step those that tied queries do not move: dice and
     objectness; each MSMFormer step's losses, the mask loss included,
     rtol 1e-3 of the CPU's criterion on the card's own forward; first
     gradients cosine >= 0.999 tensor by tensor), then 40 of the
     recipes' own steps each on the card (MSMFormer's in bfloat16)
     (ms a step, peak memory), the weights saved as train_zoo_torch saves
     them; (c) phase 14's frames through run_eval with base msmformer and
     uoaisnet (those weights through $QUBER_MSMFORMER_NATIVE_CKPT, its
     objectness bias raised so that every query is accepted and its mask
     logits moved by their median on a training scene, and
     $QUBER_UOAISNET_CKPT at $QUBER_UOAISNET_THRESH 0, its RPN and box
     deltas zeroed and its visible-mask bias raised by its median logit)
     and the flagship int8 refiner, per image
     and streamed at B = 8, as in phase 21(c), some base mask with a pixel
     required, and each wrapper's own device seconds a frame on 4
     frames (read and inpaint excluded); (d) two frames of msmformer-zoomin
     (its float32 model, the crop stage's copy accepting every query) and
     one of msmformer-pretrained (its random init)
     and uoaisnet-pretrained (torch's default init, seeded), their class and
     mask biases moved so that they segment, card against CPU (count equal,
     >= 99.5% of the labels, some mask with a pixel), and nms_fixed's ms a
     frame at 1000 boxes;
 24. UOIS-Net-3D and the CascadePSP and RICE refiner baselines: (a) the
     native DSN and RRN, the released architectures' DSN and RRN (width
     64), PSPNetUOAIS and the NodeScorer at the wrappers' shapes from one
     seeded init, float32 (TF32 off) on the card against the CPU (every
     output within ZOO2_RTOL of max |CPU|), then the UOIS-Net-3D nets in
     bfloat16 on the card (finite, the distance to float32 printed); (b)
     train_zoo_torch's uoisnet3d, cascadepsp and rice steps on two rendered
     scenes (cascadepsp on their crops), card against CPU from the same
     init with the random draws handed over (the second step from the
     CPU's state; losses rtol 1e-3, first gradients cosine >= 0.999), then
     40 of each recipe's own steps on the card (ms a step, peak memory), the
     weights saved as train_zoo_torch saves them; (c) phase 14's frames
     through run_eval with base uoisnet3d (those weights, the DSN's offset
     rows zeroed, the foreground and refinement biases moved to a training
     scene's medians) and the flagship int8
     refiner per image and streamed at B = 8 (launches added to each kernel
     row as zoo_eval["uoisnet3d"]), the frames through perturbed-gt ->
     cascadepsp and perturbed-gt -> rice (greedy) with (b)'s weights, card
     against CPU on ZOO2_CPU_FRAMES frames of each (the count equal, >=
     99.5% of the labels; uoisnet3d with its float32 models on the first
     frame the card segments), rice CEM on
     two frames (the CPU's Gumbel noise handed to the card), each wrapper's
     device seconds a frame; (d) uoisnet3d-pretrained at its random init,
     its centre head zeroed and its object class taking every pixel, float32
     card against CPU on the first frame the card segments;
 25. SAM-HQ: (a) hq-sam-pretrained's ViT-H at 1024 (one encode and a
     frame's 16 mask-prompt decodes) and ViT-B at 1024 (the automatic
     generator's 64 point decodes, multimask, and a box decode), from seeded
     inits on the first anchor frame, float32 (TF32 off) on the card
     against the CPU (every output within SAM_RTOL of max |CPU|; a TF32
     forward printed beside it), then bfloat16 on the card (finite, the
     distance to float32 printed); (b) train_zoo_torch's samhq steps card
     against CPU (the second from the CPU's state; losses rtol 1e-3, first
     gradients cosine >= 0.999), then 40 timed (ms a step, peak memory),
     the weights saved with arch.json; (c) phase 14's frames through
     perturbed-gt -> sam, hq-sam ((b)'s weights through $QUBER_SAMHQ_CKPT)
     and hq-sam-pretrained (the ViT-H in bfloat16), each built by its name,
     some refined mask with a pixel; base sam and sam-depth (seeded inits,
     iou_head's bias raised by SAM_IOU_SHIFT) -> the flagship per image and
     streamed at B = 8 (launches added to each kernel row as
     zoo_eval["sam"] and ["sam-depth"]); each wrapper's device seconds a
     frame; (d) the float32 ViT-B refiners (sam, hq-sam) and the automatic
     generator (sam, sam-depth, bias raised in both copies) card against CPU
     on the first anchor frame the card segments (the count equal, >=
     SAM_AGREEMENT of the labels);
 26. the open-vocabulary base segmenters and the late-fusion study: (a)
     from seeded inits, float32 (TF32 off) card against CPU (each float
     output within OPENVOCAB_RTOL of max |CPU|, the selections equal; a
     TF32 forward printed beside it), then the wrappers' modules in
     bfloat16 on the card (finite, the distance to float32 printed): the
     hash text tower and DeticDetector (128 proposals, 32 detections) over
     the OSD names on the first anchor frame with detectron2's pixel mean
     and std taken out (and, printed, not gated, the gap and whether the
     selections agree over DETECTOR_SURVEY_SEEDS' inits, each on its own
     frame, normalised and raw), on the first anchor frame CLIP's text tower at ViT-B width (the committed
     mini merges file) and GroundedSAM's pipeline (its grounder on the
     normalised frame) with a ViT-B SAM at 512 and its 16 box decodes; (b) train_zoo_torch's
     detic and gsam steps card against CPU in float32 (the second from the
     CPU's state; losses rtol 1e-3, first gradients cosine >= 0.999), then
     40 of each recipe's own steps timed (ms a step, peak memory), the
     weights saved with vocab.json / arch.json; (c) phase 14's frames
     through run_eval with base detic and grounded-sam ((b)'s evaluated
     copies through $QUBER_DETIC_CKPT / $QUBER_GSAM_CKPT, OPENVOCAB_THRESH's
     comment) and the flagship refiner per image and streamed at B = 8
     (launches added to each kernel row as zoo_eval["detic"] and
     ["grounded-sam"]), each wrapper's device seconds a frame; (d) the
     float32 wrappers card against CPU on the first anchor frame the card
     segments (the count equal, >= 99.5% of the labels); (e) the late-fusion
     encoder-decoder at 480x640 (batch 2) card against CPU, two train_eee
     steps card against CPU, 20 timed; the phase's seconds;
 27. the reference-checkpoint seam: (a) the int8 flagship exported with
     models/import_torch.export_mask_refiner to a detectron2 .pth, imported
     by `python3 -m quber_tpu_torch.tools.import_checkpoint` in a subprocess
     (its seconds), loaded through $QUBER_WEIGHTS (the state dict equal to
     the archive's bit for bit), phase 4's 8 frames served through
     predict() (per frame the same instance count and >= 99.5% of phase 4's
     labels; one statistics, encode and group launch a frame, added to each
     kernel row as `import`), then the quantize CLI on the imported
     checkpoint: every array equal to weights/flagship_synth_int8.npz's;
     (b) the activation-parity tool at 480x640 on those weights, float32
     with TF32 off: >= 20 stages, each within 3e-4 of its peak, the worst
     printed; (c) the parity drill on 4 rendered 480x640 frames (perturbed
     GT -> the unfiltered refiner): an ok report, its Objects and Boundary F
     and avg_refine_ms; (d) seeded CGNet, LMFFNet and UCN state dicts in the
     reference layouts (tests/reference_twins.py) through the import CLI
     (three subprocesses at once), loaded by name through
     $QUBER_CGNET_CKPT / $QUBER_LMFFNET_CKPT (the filtered refiner's
     foreground net) and $QUBER_UCN_CKPT (base ucn), on the first anchor
     frame card against CPU in float32 (the foreground nets' argmax >= 99%
     equal, as phase 14; UCN's count equal and >= 99.5% of the labels, as
     phase 21(d)); TF32 restored after; the phase's seconds;
 28. data parallelism: (a) two gloo ranks sharing cuda:0 (torchrun, this
     script's --dp-worker mode; NCCL refuses two ranks on one device), the
     flagship at 480x640 from the int8 weights with dropout 0 on a pool of
     rendered scenes, DP_STEPS device-target steps at a global batch of
     BATCH (half a rank), against one process on the whole batch on the
     card from the same state: each loss within DP_LOSS_RTOL at every step,
     the two ranks' losses equal and their states (parameters, statistics,
     Adam's moments) bit-equal after every step by checksums of the bits,
     each trainable tensor's update (the conv biases ahead of a BatchNorm
     aside, as in phase 12) and each BatchNorm statistic's with cosine >=
     0.999 against one process's, two statistics launches and one batched
     encode launch a rank a step; ms a step printed, not gated; (b)
     train_net_torch.py --synthetic --device-targets from the int8 weights
     at 240x320 under torchrun with NCCL at world size 1 against its main()
     in this process, DP_CLI_STEPS steps and then --resume for one more:
     every loss step by step within DP_CLI_RTOL; (c) predict_batch_stream
     and stage_frames + predict_batch_stream_staged on a two-replica mesh on
     cuda:0 over phase 7's frames at B = BATCH: panoptic maps, counts and
     scores (rtol 1e-6) of predict_batch on the replicas' sub-batches, the
     counts and >= 99.5% of the labels of phase 7's predict_batch at B =
     BATCH, one launch of each batched kernel per replica per batch;
     frames/s printed beside phase 8's, not gated; (d) DP_EEE_STEPS
     train_eee steps of the late-fusion model on the two ranks against one
     process on the whole batch: losses within DP_LOSS_RTOL; the phase's
     seconds;
 29. print a JSON line of the kernels' numbers (each row with the launches
     of phases 20-28 beside those of earlier paths), the frame time,
     and as the last line {"ok": true, "device": {...}}.
Needs CUDA; it has no CPU mode.

    python3 chip_smoke.py --dp-worker DIR

is phase 28's rank, launched by the phase itself through torchrun.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, W = 480, 640
N_MASKS = 64
N_FRAMES = 8
BATCH = 8
N_SERVE = 20
ENCODE_ATOL = 1e-6
PANOPTIC_AGREEMENT = 0.995
SCORES_RTOL = 1e-6
TRAIN_SLOTS = 32
TRAIN_POOL = 16
TRAIN_STEPS = 12
TARGET_ATOL = 1e-5
CPU_LOSS_RTOL = 1e-3
GRAD_COSINE = 0.999
# a gradient that is exactly zero comes back as float noise: its norm stays
# below this share of the norm of its conv weight's gradient
ZERO_GRAD_SHARE = 1e-3
CHECKPOINT_RTOL = 1e-6
EVAL_FRAMES = 16
EVAL_MEANS_ATOL = 0.005  # streamed against per-image aggregate means
# the per-image refined means against the JAX package's float32 ones on the
# CPU: above the card's float32 summation order (1e-6), below the
# 0.001-0.005 that bf16 or TF32 convolutions move them by; the initial stage
# needs no model and must be exact
EVAL_REFERENCE_ATOL = 2e-4
# the bf16 forward's mean |bf16 - float32| of each output over the JAX
# package's own on the same frame (reference_synth_osd16.json): the port's on
# the CPU reads 1.02-1.31; a float32 forward reads 0, a float16 one ~0.2
BF16_ERR_LOW, BF16_ERR_HIGH = 0.5, 2.0
# bf16 moves an anchor frame off float32 (its count, or > 0.1% of its labels)
# where an instance sits on a knife edge, each bf16 forward its own few: the
# JAX package's own bf16 on the CPU moves 5 of the 16 (frames 1, 2, 8, 12, 14;
# tests/bf16_anchor_frames.py), and no more may move here
BF16_AGREEMENT = 0.999
BF16_MOVED_FRAMES = 5
TUNED_K = TUNED_SLOTS = 24  # bench.py's tuned serving configuration
BENCH_BATCH = 16
BENCH_FRAMES = 32
CKPT_EVAL_FRAMES = 4
DEMO_FRAMES = 2
FG_AGREEMENT = 0.99
# the ablation study's variants of the flagship config: the model sections of
# configs/mask_refiner_{nohf,noeee,rgbd_add_l3,rgb_only}.yaml and
# configs/panoptic_deeplab.yaml, restated (this script reads no YAML;
# tests/test_torch_ablation.py holds them equal), and depth only
ABLATION_CONFIGS = {
    "nohf": {"hierarchical_fusion_on": False},
    "noeee": {"eee_mask_on": False, "eee_boundary_on": False, "hierarchical_fusion_on": False},
    "rgbd_add_l3": {"fusion_strategy": "add", "num_backbone_fusion_layers": 3},
    "rgb_only": {"depth_on": False},
    "depth_only": {"rgb_on": False},
    "panoptic_deeplab": {"fusion_strategy": "add", "num_backbone_fusion_layers": 3,
                         "offset_input_on": False, "eee_mask_on": False,
                         "eee_boundary_on": False, "hierarchical_fusion_on": False},
}
ABLATION_SEED = 5
# max |card - CPU| over max |CPU| of each output of a float32 forward (TF32
# off): measured up to 3.0e-5 for the variants and 2.6e-5 for the flagship
# beside them (H100, one run); a bf16 convolution moves it by ~1e-2
ABLATION_RTOL = 2e-4
UCN_POOL = 2
UCN_LR = 1e-4  # train_zoo_torch's default
UCN_CPU_STEPS = 2  # card against CPU
UCN_CARD_STEPS = 40  # then on the card alone, timed
ZOOM_FRAMES = 2
FILE_STEPS = 4  # phase 22(b)
FG_STEPS = 10  # phase 22(e)
FG_LOSS_RTOL = 1e-4
FG_CPU_BATCH = 2  # phase 22(e)'s step on the card against the CPU
ZOO_SEED = 9  # phase 23's inits and scene
# phase 23(a)'s float32 forward, card against CPU, as phase 20's: MSMFormer
# (GroupNorm throughout) read 3.66e-6 (H100, one run). UOAIS-Net's FrozenBN is
# the identity at init, so its trunks run unnormalised on the raw 0-255
# input and its heads read up to 2.95e-4 there; FrozenBN given the scene's
# statistics instead brought the RPN's scores within a rounding of each
# other and the card and the CPU kept other proposals. Its gate is 1e-3,
# held discriminating by a TF32 forward on the card, which must fail it
ZOO_RTOL = {"MSMFormer": ABLATION_RTOL, "UOAISNet": 1e-3}
ZOO_POOL = 2
ZOO_CPU_STEPS = 2  # card against CPU
ZOO_CARD_STEPS = 40  # then on the card alone, timed
NMS_BOXES = 1000  # the released UOAIS-Net's RPN keeps 1000 proposals a level
BASE_TIMED_FRAMES = 4  # phase 23(c)'s wrapper-only timing
# phase 23(c): after 40 steps on two scenes no MSMFormer query passes the
# wrapper's 0.5 objectness on the anchor frames, and its masks pass 0.5 on
# 0-16 of them from run to run (the steps are not deterministic on the
# card); UOAIS-Net's detections score below 0.5 with masks that cover no
# pixel, most of their boxes clipped to no area. The evaluated copies accept
# every MSMFormer query and move its mask logits, and UOAIS-Net's
# visible-mask bias, by the median logit on a training scene; UOAIS-Net's
# boxes are its anchors (deltas zeroed) and it keeps every valid detection
# ($QUBER_UOAISNET_THRESH)
ZOO_OBJECTNESS_SHIFT = 40.0
ZOO_UOAISNET_THRESH = "0"
# phase 23(d): the released-checkpoint twins' class and mask biases moved as
# tests/test_torch_zoo_base_pretrained.py moves them, so that they segment
MSM_CLASS_SHIFT = 4.0
UOAIS_CLASS_SHIFT, UOAIS_MASK_SHIFT = 4.0, 2.0
ZOO2_SEED = 11  # phase 24's inits and scenes
# phase 24(a)'s float32 forwards, card against CPU: the GroupNorm nets as
# phase 20's; PSPNetUOAIS's BatchNorms are the identity at init, so its
# trunk runs unnormalised three times over, as UOAIS-Net's did in phase 23
ZOO2_RTOL = {"uoisnet3d DSN": ABLATION_RTOL, "uoisnet3d RRN": ABLATION_RTOL,
             "released DSN": ABLATION_RTOL, "released RRN": ABLATION_RTOL,
             "PSPNetUOAIS": 1e-3, "NodeScorer": ABLATION_RTOL}
ZOO2_CROPS = 8  # cascadepsp's pool in 24(b): 4 scenes' whole-frame and ROI crops
ZOO2_CPU_CROP = 112  # the crop side of 24(b)'s cascadepsp steps against the CPU
ZOO2_CPU_FRAMES = 2  # 24(c)'s refiners card against CPU
ZOO2_BASE_CPU_FRAMES = 1  # 24(c)'s uoisnet3d and 24(d)'s twin card against CPU
SAM_SEED = 13  # phase 25(a)'s inits
# phase 25(a)'s float32 forwards, card against CPU (TF32 off): max |card -
# CPU| over max |CPU| of each output; the ViT-H read 2.9e-6 (H100, one run),
# and a TF32 forward is printed beside it
SAM_RTOL = 1e-4
SAM_PROMPTS = 16  # the refiner's mask-prompt slots
SAM_GRID = 8  # the automatic generator's point grid
# phase 25(d): the float32 ViT-B wrappers, card against CPU, on the first
# frames that hold a mask, label agreement
SAM_AGREEMENT = 0.999
SAM_PARITY_FRAMES = 1
# phase 25(c)-(d): at its seeded random init the automatic generator
# predicts IoUs of 0.20-0.52 (two synthetic frames on the CPU), below its
# 0.5 threshold on nearly every point, and keeps 0-1 masks a frame; the
# evaluated and compared copies (both alike) have iou_head's last bias
# raised by this, so that they segment
SAM_IOU_SHIFT = 0.5
OPENVOCAB_SEED = 15  # phase 26's inits
# phase 26(a)'s float32 forwards, card against CPU (TF32 off): max |card -
# CPU| over max |CPU| of each output. The detector's FrozenBN is the
# identity at init, so its trunk runs unnormalised on the raw 0-255 frame,
# as UOAIS-Net's does in phase 23; the selections (classes, valid,
# det_index) must be equal. On the raw frame the gap reaches half the
# tolerance: the detector's and the grounder's gated checks take the frame
# with detectron2's pixel mean and std taken out, in both copies. A
# float32 rounding can still reorder two proposals or detections whose
# scores nearly tie: a survey over these further inits, each on its own
# anchor frame, normalised and raw, prints how often (not gated)
# (each init costs two CPU forwards of the detector at 480x640)
DETECTOR_SURVEY_SEEDS = tuple(range(16, 22))
DETECTOR_PIXEL_MEAN = np.asarray([103.53, 116.28, 123.675], np.float32)  # BGR
DETECTOR_PIXEL_STD = np.asarray([57.375, 57.12, 58.395], np.float32)
OPENVOCAB_RTOL = {"detector": 1e-3, "clip": SAM_RTOL, "grounded-sam": 1e-3,
                  "late fusion": ABLATION_RTOL}
CLIP_MINI_MERGES = os.path.join("tests", "fixtures", "clip_mini_merges.txt")
# phase 26(c): the evaluated copies of the 40-step weights keep every valid
# detection ($QUBER_DETIC_THRESH, $QUBER_GSAM_THRESH), their boxes are their
# anchors (RPN and box deltas zeroed: 40 steps clip boxes to no area, and
# Detic pastes a mask only inside its box), Detic's mask bias moves by the
# median logit of a training scene's detections; GroundedSAM's SAM, where
# its HQ masks hold no pixel on that scene, gets a constant channel in the
# HQ features whose weight is the negated median logit
OPENVOCAB_THRESH = "0"
LATE_FUSION_BATCH = 2
LATE_FUSION_STEPS = 20
# phase 27: the activation-parity tool's float32 tolerance (of each stage's
# peak) and its stage count at 480x640; the drill's rendered frames; the
# seeds of the CGNet / LMFFNet / UCN state dicts in the reference layouts
SEAM_PARITY_ATOL = 3e-4
SEAM_PARITY_STAGES = 20
SEAM_DRILL_FRAMES = 4
SEAM_SEED = 17
# phase 28: data parallelism. Two gloo ranks share cuda:0 (NCCL refuses two
# ranks on one device); the flagship at 480x640 from the int8 weights with
# dropout 0 (the ranks draw their own dropout masks, one process draws one
# over the batch), a global batch of BATCH (BATCH / DP_RANKS a rank)
DP_RANKS = 2
DP_POOL = 8
DP_STEPS = 3
DP_LOSS_RTOL = 1e-4
DP_EEE_BATCH = 4
DP_EEE_STEPS = 2
# 28(b): the CLI under torchrun (NCCL, world size 1) against the CLI alone,
# at 240x320 (the weights do not depend on the size) on 8 rendered scenes
DP_CLI_RTOL = 1e-5
DP_CLI_STEPS = 2
DP_CLI_SIZE = (240, 320)
DP_TIMEOUT = 300
WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights",
                       "flagship_synth_int8.npz")
# H100 SXM data sheet: HBM3 rate and fp32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def _bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(fn, flush: torch.Tensor, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` runs, each after an L2 flush.
    A spin on the stream before each start event lets the host enqueue fn()
    ahead of the device."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _ellipse_masks(rng, n, h, w):
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    out = np.zeros((n, h, w), bool)
    for i in range(n):
        a, b = rng.uniform(10, 70, 2)
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        out[i] = ((ys - cy) / a) ** 2 + ((xs - cx) / b) ** 2 <= 1.0
    return out


def _check_stats(tag, masks, valid):
    """The statistics kernel against its plain version, exactly; returns the
    kernel's (areas, centers, ok)."""
    from quber_tpu_torch.ops import encoding, kernels

    got = kernels.instance_stats(masks, valid, return_ok=True)
    areas, centers = encoding.instance_stats(masks, valid)
    want = (areas, centers, valid & (areas > 0))
    torch.cuda.synchronize()
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    print(f"instance_stats {tag}: areas, centroids, ok equal to the plain version's: {same} "
          f"(tolerance 0)")
    if not all(same):
        raise AssertionError(f"instance_stats kernel disagrees with its plain version ({tag})")
    return got


def _stats_case(masks, valid, flush):
    """Times of the statistics kernel and its plain version, and its bound:
    every valid row read once."""
    from quber_tpu_torch.ops import encoding, kernels

    hw = masks.shape[-2] * masks.shape[-1]
    slots, n_valid = valid.numel(), int(valid.sum())
    bound_ms, bound_by = _bound(n_valid * hw + slots * (1 + 13), n_valid * hw * 3)
    return {
        "shape": f"masks {list(masks.shape)} bool, {n_valid} valid",
        "ms": _time_ms(lambda: kernels.instance_stats(masks, valid, return_ok=True), flush),
        "plain_ms": _time_ms(lambda: encoding.instance_stats(masks, valid), flush),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def _check_encode(tag, masks, valid):
    """Statistics and encode kernels against their plain versions for a frame
    [N, H, W] or a batch [B, N, H, W]."""
    from quber_tpu_torch.ops import encoding, kernels

    _, centers, ok = _check_stats(tag, masks, valid)
    if masks.dim() == 4:
        got = kernels.encode_initial_masks_batched(masks, ok, centers)
        want = encoding.encode_from_stats_batched(masks, ok, centers)
    else:
        got = kernels.encode_initial_masks(masks, ok, centers)
        want = encoding.encode_from_stats(masks, ok, centers)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"encode_initial_masks {tag}, {int(ok.sum())} ok: max |kernel - plain| = {err:.3g} "
          f"(tolerance {ENCODE_ATOL})")
    if got.shape != want.shape or not err <= ENCODE_ATOL:
        raise AssertionError(f"encode kernel disagrees with its plain version ({tag})")


def _check_group(tag, cen, val, offsets):
    from quber_tpu_torch.ops import grouping, kernels

    if offsets.dim() == 4:
        got = kernels.group_pixels_batched(cen, val, offsets)
        want = grouping.group_pixels_batched(cen, val, offsets)
    else:
        got = kernels.group_pixels(cen, val, offsets)
        want = grouping.group_pixels(cen, val, offsets)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    print(f"group_pixels {tag}, {int(val.sum())} valid: {mismatches} ids differ (tolerance 0)")
    if got.shape != want.shape or mismatches:
        raise AssertionError(f"group kernel disagrees with its plain version ({tag})")


def _unaligned(t):
    """A contiguous copy of `t` whose storage starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def check_edge_cases(dev):
    """The shapes the kernels treat specially, each against its plain version
    with the tolerances of phase 3 (no timing)."""
    rng = np.random.RandomState(7)
    h2, w2 = 359, 477  # H * W is odd: scalar variants

    def stack(n, h, w, invalid=()):
        valid = np.ones(n, bool)
        valid[list(invalid)] = False
        return (torch.from_numpy(_ellipse_masks(rng, n, h, w)).to(dev),
                torch.from_numpy(valid).to(dev))

    masks, valid = stack(12, h2, w2, invalid=(3,))
    _check_encode(f"N=12 {h2}x{w2}", masks, valid)
    # a stack sliced off by one instance from a buffer whose H * W is odd
    _check_encode(f"N=11 {h2}x{w2}, sliced view", masks[1:], valid[1:])
    masks, valid = stack(12, H, W, invalid=(5,))
    _check_encode(f"N=12 {H}x{W}, unaligned view", _unaligned(masks), valid)
    masks, valid = stack(9, 361, 400, invalid=(0,))
    _check_encode("N=9 361x400 (ragged tiles)", masks, valid)
    masks, valid = stack(330, H, W, invalid=range(0, 330, 11))
    _check_encode(f"N=330 {H}x{W}", masks, valid)
    del masks
    _check_encode(f"N=0 {H}x{W}", torch.zeros((0, H, W), dtype=torch.bool, device=dev),
                  torch.zeros((0,), dtype=torch.bool, device=dev))
    _check_encode(f"N=1 {H}x{W}", *stack(1, H, W))
    masks_np = np.stack([_ellipse_masks(rng, 12, h2, w2) for _ in range(BATCH)])
    valid_np = np.arange(12)[None] < np.array((12, 9, 1, 0, 5, 12, 7, 3))[:, None]
    _check_encode(f"B={BATCH} N=12 {h2}x{w2}", torch.from_numpy(masks_np).to(dev),
                  torch.from_numpy(valid_np).to(dev))

    def table(k, valid_idx, h, w, lead=()):
        cen = np.stack([rng.randint(0, h, lead + (k,)), rng.randint(0, w, lead + (k,))], -1)
        val = np.zeros(lead + (k,), bool)
        val[..., list(valid_idx)] = True
        return (torch.from_numpy(cen.astype(np.int32)).to(dev), torch.from_numpy(val).to(dev))

    def field(h, w, lead=()):
        return torch.from_numpy(rng.randn(*lead, 2, h, w).astype(np.float32) * 20).to(dev)

    offsets = field(H, W)
    _check_group(f"K=1 {H}x{W}", *table(1, (0,), H, W), offsets)
    _check_group(f"K=33 {H}x{W}", *table(33, range(0, 33, 2), H, W), offsets)
    _check_group(f"K=4096 {H}x{W}, last valid", *table(4096, (4095,), H, W), offsets)
    _check_group(f"K=33 {H}x{W}, unaligned view", *table(33, range(20), H, W),
                 _unaligned(offsets))
    _check_group("K=4096 120x160, every third valid",
                 *table(4096, range(0, 4096, 3), 120, 160), field(120, 160))
    _check_group(f"K=33 {h2}x{w2}", *table(33, range(20), h2, w2), field(h2, w2))
    cen, val = table(33, range(33), h2, w2, lead=(BATCH,))
    val &= torch.from_numpy(np.arange(33)[None] < np.array(
        (33, 20, 1, 0, 5, 33, 7, 3))[:, None]).to(dev)
    _check_group(f"B={BATCH} K=33 {h2}x{w2}", cen, val, field(h2, w2, lead=(BATCH,)))


def check_kernels(dev, flush):
    from quber_tpu_torch.ops import encoding, grouping, kernels

    rows = []
    rng = np.random.RandomState(0)
    hw = H * W

    # --- encode: 64 slots, overlapping blobs, two empty and two invalid ---
    masks_np = _ellipse_masks(rng, N_MASKS, H, W)
    masks_np[[10, 40]] = False
    valid_np = np.ones(N_MASKS, bool)
    valid_np[[20, 50]] = False
    masks = torch.from_numpy(masks_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    _, centers, ok = _check_stats(f"N={N_MASKS} {H}x{W}", masks, valid)
    stats_row = {
        "name": "instance_stats", "route": "cuda",
        "source": "quber_tpu_torch/ops/csrc/kernels.cu",
        "replaces": "quber_tpu/ops/encoding.py:30",
        **_stats_case(masks, valid, flush), "max_abs_err": 0.0, "tolerance": 0,
        "library_ms": None,
    }
    got = kernels.encode_initial_masks(masks, ok, centers)
    want = encoding.encode_from_stats(masks, ok, centers)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"encode_initial_masks N={N_MASKS} {H}x{W}: max |kernel - plain| = {err:.3g} "
          f"(tolerance {ENCODE_ATOL})")
    if not err <= ENCODE_ATOL:
        raise AssertionError("encode kernel disagrees with its plain version")
    n_ok = int(ok.sum())
    bound_ms, bound_by = _bound(n_ok * hw + N_MASKS * 9 + 3 * hw * 4, hw * n_ok * 8 + hw * 20)
    rows.append({
        "name": "encode_initial_masks", "route": "cuda",
        "source": "quber_tpu_torch/ops/csrc/kernels.cu",
        "replaces": "quber_tpu/ops/pallas_kernels.py:154",
        "shape": f"masks [{N_MASKS},{H},{W}] bool, {n_ok} ok",
        "max_abs_err": err, "tolerance": ENCODE_ATOL,
        "ms": _time_ms(lambda: kernels.encode_initial_masks(masks, ok, centers), flush),
        "plain_ms": _time_ms(lambda: encoding.encode_from_stats(masks, ok, centers), flush),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    })

    # --- group: K = 32 (fast path) and K = 200, plus an all-invalid table ---
    offsets = (torch.randn((2, H, W), generator=torch.Generator().manual_seed(1)) * 20).to(dev)
    cases = {}
    for k, n_valid in ((32, 8), (200, 120), (32, 0)):
        cy = rng.randint(0, H, k)
        cx = rng.randint(0, W, k)
        cen = torch.from_numpy(np.stack([cy, cx], -1).astype(np.int32)).to(dev)
        val = torch.from_numpy(np.arange(k) < n_valid).to(dev)
        got = kernels.group_pixels(cen, val, offsets)
        want = grouping.group_pixels(cen, val, offsets)
        mismatches = int((got != want).sum())
        print(f"group_pixels K={k} valid={n_valid}: {mismatches} ids differ (tolerance 0)")
        if mismatches:
            raise AssertionError("group kernel disagrees with its plain version")
        if n_valid:
            bound_ms, bound_by = _bound(3 * hw * 4 + k * 9, hw * n_valid * 6 + hw * 2)
            cases[k] = {
                "shape": f"centers [{k},2], {n_valid} valid, offsets [2,{H},{W}]",
                "ms": _time_ms(lambda: kernels.group_pixels(cen, val, offsets), flush),
                "plain_ms": _time_ms(lambda: grouping.group_pixels(cen, val, offsets), flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
    rows.append({
        "name": "group_pixels", "route": "cuda",
        "source": "quber_tpu_torch/ops/csrc/kernels.cu",
        "replaces": "quber_tpu/ops/pallas_kernels.py:37",
        **cases[32], "max_abs_err": 0.0, "tolerance": 0,
        "library_ms": None,
        "k200": cases[200],
    })
    return rows, stats_row


def serve_frames(dev):
    from quber_tpu_torch.data.synthetic import blob_scene
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.predictor import MaskRefinerPredictor
    from quber_tpu_torch.train.checkpoint import load_default_params

    params = load_default_params()
    if params is None:
        raise FileNotFoundError("weights/flagship_synth_int8.npz is missing")
    predictor = MaskRefinerPredictor(params=params, device=dev)
    frames = []
    for i in range(N_FRAMES):
        rng = np.random.RandomState(100 + i)
        frames.append(blob_scene(rng, H, W, rng.randint(3, 9)))

    kernels.reset_launch_counts()
    times, results = [], []
    for rgb, depth, masks in frames:
        t0 = time.perf_counter()
        out = predictor.predict(rgb, depth, list(masks))[0]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        results.append(out)
    launches = {"encode_initial_masks": kernels.encode_initial_masks.launches,
                "group_pixels": kernels.group_pixels.launches,
                "instance_stats": kernels.instance_stats.launches}
    counts = [len(r.get("instances", {}).get("scores", [])) for r in results]
    print(f"main path: {N_FRAMES} frames, initial masks "
          f"{[len(f[2]) for f in frames]}, refined instances {counts}, launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} kernel was not launched on the main path")
    if launches["instance_stats"] != N_FRAMES:
        raise AssertionError("instance_stats was not launched once per frame")
    if not any(counts):
        raise AssertionError("no frame produced an instance")
    for r in results:
        if r["sem_seg"].shape != (H, W) or not np.isfinite(r["sem_seg"]).all():
            raise AssertionError("sem_seg is not a finite [H, W] map")
        if r["eee_mask"].shape != (2, H, W) or not np.isfinite(r["eee_mask"]).all():
            raise AssertionError("eee_mask is not a finite [2, H, W] map")
    return params, frames, results, times, launches


def cpu_parity(params, frame, gpu_result):
    from quber_tpu_torch.predictor import MaskRefinerPredictor

    rgb, depth, masks = frame
    cpu = MaskRefinerPredictor(params=params, device="cpu").predict(rgb, depth, list(masks))[0]
    n_gpu = len(gpu_result.get("instances", {}).get("scores", []))
    n_cpu = len(cpu.get("instances", {}).get("scores", []))
    agree = float((cpu["panoptic_seg"][0] == gpu_result["panoptic_seg"][0]).mean())
    sem = float(np.abs(cpu["sem_seg"] - gpu_result["sem_seg"]).max())
    print(f"cpu parity: instances gpu {n_gpu} cpu {n_cpu}, panoptic agreement {agree:.6f} "
          f"(need >= {PANOPTIC_AGREEMENT}), max |sem_seg gpu - cpu| = {sem:.3g}")
    if n_gpu != n_cpu or agree < PANOPTIC_AGREEMENT:
        raise AssertionError("the card and the CPU disagree on the first frame")


def check_batched_kernels(dev, flush):
    from quber_tpu_torch.ops import encoding, grouping, kernels

    rows = []
    rng = np.random.RandomState(1)
    hw = H * W

    # --- encode: B frames of 64 slots, a different number valid in each,
    # one empty and one invalid slot, and a frame with no valid slot ---
    n_valid = (64, 48, 33, 16, 8, 60, 1, 0)
    masks_np = np.stack([_ellipse_masks(rng, N_MASKS, H, W) for _ in range(BATCH)])
    masks_np[:, 10] = False
    valid_np = np.arange(N_MASKS)[None] < np.array(n_valid)[:, None]
    valid_np[:, 20] = False
    masks = torch.from_numpy(masks_np).to(dev)
    valid = torch.from_numpy(valid_np).to(dev)
    _, centers, ok = _check_stats(f"B={BATCH} N={N_MASKS} {H}x{W}", masks, valid)
    stats_b8 = _stats_case(masks, valid, flush)
    got = kernels.encode_initial_masks_batched(masks, ok, centers)
    want = encoding.encode_from_stats_batched(masks, ok, centers)
    torch.cuda.synchronize()
    errs = [float((got[b] - want[b]).abs().max()) for b in range(BATCH)]
    print(f"encode_initial_masks_batched B={BATCH} N={N_MASKS} {H}x{W}, ok per frame "
          f"{ok.sum(dim=1).tolist()}: max |kernel - plain| per frame {errs} "
          f"(tolerance {ENCODE_ATOL})")
    if not max(errs) <= ENCODE_ATOL:
        raise AssertionError("batched encode kernel disagrees with its plain version")
    n_ok = int(ok.sum())
    bound_ms, bound_by = _bound(n_ok * hw + BATCH * N_MASKS * 9 + BATCH * 3 * hw * 4,
                                hw * n_ok * 8 + BATCH * hw * 20)
    rows.append({
        "name": "encode_initial_masks_batched", "route": "cuda",
        "source": "quber_tpu_torch/ops/csrc/kernels.cu",
        "replaces": "quber_tpu/ops/pallas_kernels.py:252",
        "shape": f"masks [{BATCH},{N_MASKS},{H},{W}] bool, {n_ok} ok",
        "max_abs_err": max(errs), "tolerance": ENCODE_ATOL,
        "ms": _time_ms(lambda: kernels.encode_initial_masks_batched(masks, ok, centers), flush),
        "plain_ms": _time_ms(lambda: encoding.encode_from_stats_batched(masks, ok, centers),
                             flush),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    })
    del masks, got, want

    # --- group: K = 32 and K = 200, a different valid count per frame and a
    # frame with every centre invalid ---
    offsets = (torch.randn((BATCH, 2, H, W), generator=torch.Generator().manual_seed(2))
               * 20).to(dev)
    cases = {}
    for k, n_valid in ((32, (8, 32, 1, 16, 0, 24, 5, 12)),
                       (200, (120, 200, 3, 60, 0, 150, 90, 30))):
        cen_np = np.stack([rng.randint(0, H, (BATCH, k)), rng.randint(0, W, (BATCH, k))], -1)
        cen = torch.from_numpy(cen_np.astype(np.int32)).to(dev)
        val = torch.from_numpy(np.arange(k)[None] < np.array(n_valid)[:, None]).to(dev)
        got = kernels.group_pixels_batched(cen, val, offsets)
        want = grouping.group_pixels_batched(cen, val, offsets)
        mismatches = [int((got[b] != want[b]).sum()) for b in range(BATCH)]
        print(f"group_pixels_batched B={BATCH} K={k} valid per frame {list(n_valid)}: "
              f"ids differing per frame {mismatches} (tolerance 0)")
        if any(mismatches):
            raise AssertionError("batched group kernel disagrees with its plain version")
        bound_ms, bound_by = _bound(BATCH * 3 * hw * 4 + BATCH * k * 9,
                                    hw * sum(n_valid) * 6 + BATCH * hw * 2)
        cases[k] = {
            "shape": f"centers [{BATCH},{k},2], {sum(n_valid)} valid, offsets "
                     f"[{BATCH},2,{H},{W}]",
            "ms": _time_ms(lambda: kernels.group_pixels_batched(cen, val, offsets), flush),
            "plain_ms": _time_ms(lambda: grouping.group_pixels_batched(cen, val, offsets),
                                 flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    rows.append({
        "name": "group_pixels_batched", "route": "cuda",
        "source": "quber_tpu_torch/ops/csrc/kernels.cu",
        "replaces": "quber_tpu/ops/pallas_kernels.py:98",
        **cases[32], "max_abs_err": 0.0, "tolerance": 0,
        "library_ms": None,
        "k200": cases[200],
    })
    return rows, stats_b8


def _launch_counts():
    from quber_tpu_torch.ops import kernels

    return {name: getattr(kernels, name).launches for name in (
        "encode_initial_masks", "group_pixels",
        "encode_initial_masks_batched", "group_pixels_batched", "instance_stats")}


def _check_launches(path, launches, n_batches):
    print(f"{path}: launches {launches}")
    for name in ("encode_initial_masks_batched", "group_pixels_batched", "instance_stats"):
        if launches[name] != n_batches:
            raise AssertionError(f"{path}: {name} launched {launches[name]} times "
                                 f"for {n_batches} batches")
    for name in ("encode_initial_masks", "group_pixels"):
        if launches[name]:
            raise AssertionError(f"{path}: single-frame {name} was launched")


def _same_outputs(path, got, want):
    if len(got) != len(want):
        raise AssertionError(f"{path}: {len(got)} results for {len(want)} frames")
    for i, ((gp, gc, gs), (wp, wc, ws)) in enumerate(zip(got, want)):
        if gc != wc or not np.array_equal(gp, wp):
            raise AssertionError(f"{path}: frame {i} differs from predict_batch")
        np.testing.assert_allclose(gs, ws, rtol=SCORES_RTOL, atol=0,
                                   err_msg=f"{path}: frame {i} scores")
    print(f"{path}: panoptic maps and counts identical to predict_batch's, scores within "
          f"rtol {SCORES_RTOL}, {len(got)} frames")


def serve_batched(params, card):
    from quber_tpu_torch.data.synthetic import blob_scene
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.predictor import MaskRefinerPredictor

    predictor = MaskRefinerPredictor(params=params, device="cuda")
    frames = []
    for i in range(N_SERVE):
        rng = np.random.RandomState(200 + i)
        frames.append(blob_scene(rng, H, W, rng.randint(3, 9)))
    batches = [frames[i:i + BATCH] for i in range(0, N_SERVE, BATCH)]

    def run_batches():
        out = []
        for b in batches:  # a partial batch is padded with copies of its first frame
            out += predictor.predict_batch(b + [b[0]] * (BATCH - len(b)))[:len(b)]
        return out

    def run_staged(staged):
        return list(predictor.predict_batch_stream_staged(staged, prefetch=2))

    def run_stream():
        return list(predictor.predict_batch_stream(iter(frames), BATCH, prefetch=2))

    kernels.reset_launch_counts()
    batch_out = run_batches()
    launches = _launch_counts()
    _check_launches("predict_batch", launches, len(batches))
    counts = [c for _, c, _ in batch_out]
    print(f"predict_batch: {N_SERVE} frames in batches of {BATCH}, initial masks "
          f"{[len(f[2]) for f in frames]}, refined instances {counts}")
    if not any(counts):
        raise AssertionError("no frame produced an instance")

    agreements = []
    for i, (rgb, depth, masks) in enumerate(frames):
        single = predictor.predict(rgb, depth, list(masks))[0]
        n = len(single.get("instances", {}).get("scores", []))
        agreements.append(float((single["panoptic_seg"][0] == batch_out[i][0]).mean()))
        if n != counts[i] or agreements[-1] < PANOPTIC_AGREEMENT:
            raise AssertionError(f"frame {i}: predict_batch gives {counts[i]} instances and "
                                 f"{agreements[-1]:.6f} agreement, predict gives {n}")
    print(f"predict_batch against single-frame predict: same counts, panoptic agreement "
          f"min {min(agreements):.6f} (need >= {PANOPTIC_AGREEMENT})")

    kernels.reset_launch_counts()
    staged = predictor.stage_frames(frames, BATCH)
    staged_out = run_staged(staged)
    _check_launches("stage_frames + predict_batch_stream_staged", _launch_counts(),
                    len(batches))
    _same_outputs("predict_batch_stream_staged", staged_out, batch_out)
    kernels.reset_launch_counts()
    stream_out = run_stream()
    _check_launches("predict_batch_stream(prefetch=2)", _launch_counts(), len(batches))
    _same_outputs("predict_batch_stream", stream_out, batch_out)

    def fps(fn):
        fn()  # warm pass
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return N_SERVE / statistics.median(times), [round(t * 1e3, 3) for t in times]

    rates = {"predict_batch": fps(run_batches),
             "staged": fps(lambda: run_staged(staged)),
             "stream": fps(run_stream)}
    for name, (rate, times) in rates.items():
        print(f"{name}: {rate:.3f} frames/s ({N_SERVE} frames, batches of {BATCH}, pass ms "
              f"{times}) on {card}")

    # device time the compute stream idles while the host reads the largest
    # survivor count (the batch-wide fast-K branch), on a staged pass
    predictor.sync_events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_staged(staged)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    gaps = [a.elapsed_time(b) for a, b in predictor.sync_events]
    predictor.sync_events = None
    print(f"per-batch host sync: compute stream idle {[round(g, 4) for g in gaps]} ms per "
          f"batch, {sum(gaps):.4f} ms of a {wall_ms:.3f} ms staged pass on {card}")
    return launches, rates, frames, batch_out


def multiscale(params):
    from quber_tpu_torch.data.synthetic import blob_scene
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.predictor import MultiScalePredictor

    ms = MultiScalePredictor(params=params, device="cuda")
    h0, w0 = 360, 480
    rgb, depth, masks = blob_scene(np.random.RandomState(300), h0, w0, 5)
    kernels.reset_launch_counts()
    out = ms.predict(rgb, depth, list(masks))[0]
    torch.cuda.synchronize()
    launches = _launch_counts()
    n = len(out.get("instances", {}).get("scores", []))
    print(f"MultiScalePredictor: {h0}x{w0} frame -> buckets {list(ms._cache)}, "
          f"{len(masks)} initial masks, {n} refined instances, launches {launches}")
    if out["panoptic_seg"][0].shape != (h0, w0):
        raise AssertionError("panoptic map is not of the input's size")
    if out["sem_seg"].shape != (h0, w0) or not np.isfinite(out["sem_seg"]).all():
        raise AssertionError("sem_seg is not a finite map of the input's size")
    if out["eee_mask"].shape != (2, h0, w0) or not np.isfinite(out["eee_mask"]).all():
        raise AssertionError("eee_mask is not a finite map of the input's size")
    if list(ms._cache) != [(H, W)]:
        raise AssertionError("the frame did not go into the 480x640 bucket")
    for name in ("encode_initial_masks", "group_pixels", "instance_stats"):
        if not launches[name]:
            raise AssertionError(f"MultiScalePredictor did not launch {name}")


def _train_launch_counts(path, launches, steps):
    print(f"{path}: launches {launches}")
    if launches["instance_stats"] != 2 * steps or \
            launches["encode_initial_masks_batched"] != steps:
        raise AssertionError(f"{path}: expected two statistics launches and one batched "
                             f"encode launch a step over {steps} steps")
    for name in ("encode_initial_masks", "group_pixels", "group_pixels_batched"):
        if launches[name]:
            raise AssertionError(f"{path}: {name} was launched")


def _targets_against_cpu(tag, bufs, model_cfg, train_cfg, dev):
    """build_targets of packed samples `bufs` (uint8 [B, bytes], on the host)
    on the card and on the CPU: the binary maps and weights exact, center,
    offset and offset_enc within TARGET_ATOL; the card's pass launches the
    statistics kernel twice and the batched encode once. Returns the card's
    unpacked stacks (gt, gv, pert, pv)."""
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.train.device_targets import build_targets, unpack_train_sample

    _, gt, gv, pert, pv = unpack_train_sample(bufs.to(dev), H, W, TRAIN_SLOTS)
    kernels.reset_launch_counts()
    got = build_targets(gt, gv, pert, pv, model_cfg, train_cfg)
    torch.cuda.synchronize()
    _train_launch_counts(f"{tag}: build_targets on the card", _launch_counts(), 1)
    _, *stacks_cpu = unpack_train_sample(bufs, H, W, TRAIN_SLOTS)
    want = build_targets(*stacks_cpu, model_cfg, train_cfg)
    errs = {}
    for key, tol in (("sem_seg", 0), ("sem_seg_weights", 0), ("center_weights", 0),
                     ("offset_weights", 0), ("eee_mask", 0), ("eee_boundary", 0),
                     ("center", TARGET_ATOL), ("offset", TARGET_ATOL),
                     ("offset_enc", TARGET_ATOL)):
        g, w = got[key].cpu(), want[key]
        errs[key] = float((g - w).abs().max())
        if g.shape != w.shape or not errs[key] <= tol:
            raise AssertionError(f"{tag}: build_targets' {key} differs between card and CPU "
                                 f"by {errs[key]} (tolerance {tol})")
    print(f"{tag}: build_targets B={len(bufs)} N={TRAIN_SLOTS} {H}x{W}, valid GT per scene "
          f"{gv.sum(dim=1).tolist()}, perturbed {pv.sum(dim=1).tolist()}: max |card - cpu| "
          f"{errs} (tolerance 0, and {TARGET_ATOL} for center, offset, offset_enc)")
    return gt, gv, pert, pv


def check_targets(packed, model_cfg, train_cfg, dev, flush):
    """Phase 10: build_targets on the card against the CPU, and the two
    kernels' times at the training shape."""
    from quber_tpu_torch.ops import encoding, kernels

    bufs = torch.from_numpy(packed[:BATCH])
    gt, gv, pert, pv = _targets_against_cpu("phase 10", bufs, model_cfg, train_cfg, dev)

    hw = H * W
    _, centers, ok = kernels.instance_stats(pert, pv, return_ok=True)
    n_ok = int(ok.sum())
    bound_ms, bound_by = _bound(n_ok * hw + BATCH * TRAIN_SLOTS * 9 + BATCH * 3 * hw * 4,
                                hw * n_ok * 8 + BATCH * hw * 20)
    encode_train = {
        "shape": f"masks [{BATCH},{TRAIN_SLOTS},{H},{W}] bool, {n_ok} ok, normalize",
        "launches_per_step": 1,
        "ms": _time_ms(lambda: kernels.encode_initial_masks_batched(pert, ok, centers), flush),
        "plain_ms": _time_ms(lambda: encoding.encode_from_stats_batched(pert, ok, centers),
                             flush),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    stats_train = {"launches_per_step": 2, "gt": _stats_case(gt, gv, flush),
                   "perturbed": _stats_case(pert, pv, flush)}
    return encode_train, stats_train


def _pool_loss(state, packed, model_cfg, train_cfg, dev):
    """Mean total loss over the whole pool in eval mode (no dropout, running
    BatchNorm statistics), batch by batch."""
    from quber_tpu_torch.models.mask_refiner import compute_losses
    from quber_tpu_torch.train.device_targets import build_targets, unpack_train_sample

    state.model.eval()
    totals = []
    with torch.no_grad():
        for i in range(0, len(packed), BATCH):
            bufs = torch.from_numpy(packed[i:i + BATCH]).to(dev)
            image, *stacks = unpack_train_sample(bufs, H, W, TRAIN_SLOTS)
            batch = build_targets(*stacks, model_cfg, train_cfg)
            out = state.model(image, batch["offset_enc"], full_res=False)
            totals.append(float(sum(compute_losses(out, batch, model_cfg).values())))
    return statistics.mean(totals)


def train_full_width(params, packed, model_cfg, train_cfg, dev, card):
    """Phase 11: the flagship train step at full width on a device pool."""
    from quber_tpu_torch.models.from_jax import state_dict_from_jax
    from quber_tpu_torch.models.layers import FrozenBatchNorm
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.profiling import TRAIN_PHASES, timed_train_steps
    from quber_tpu_torch.train.device_targets import DevicePool, make_device_target_step
    from quber_tpu_torch.train.loop import create_train_state

    state = create_train_state(model_cfg, train_cfg, device=dev)
    state.model.load_state_dict(state_dict_from_jax(params), strict=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    frozen = {f"{name}.{leaf}" for name, mod in state.model.named_modules()
              if isinstance(mod, FrozenBatchNorm) for leaf, _ in mod.named_buffers()}
    trainable = {name for name, p in state.model.named_parameters() if p.requires_grad}
    if not frozen or len(frozen) + len(trainable) + 32 != len(before):
        raise AssertionError("the state is not FrozenBN tensors + trainable parameters + "
                             "32 BatchNorm statistics")
    loss_before = _pool_loss(state, packed, model_cfg, train_cfg, dev)

    pool = DevicePool(packed, BATCH, train_cfg.seed, dev)
    train_step = make_device_target_step(model_cfg, train_cfg, TRAIN_SLOTS)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rows = timed_train_steps(state, train_step, pool.next_batch, TRAIN_STEPS)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _train_launch_counts(f"{TRAIN_STEPS} train steps", launches, TRAIN_STEPS)
    for i, row in enumerate(rows):
        print(f"train step {i + 1}: {row['ms']:.3f} ms, "
              + " ".join(f"{k}={v:.6f}" for k, v in sorted(row["losses"].items())))
        if not all(np.isfinite(v) for v in row["losses"].values()):
            raise AssertionError(f"train step {i + 1}: a loss is not finite")

    after = state.model.state_dict()
    for name in frozen:
        if not torch.equal(before[name], after[name]):
            raise AssertionError(f"FrozenBN tensor {name} changed")
    unchanged = [n for n in trainable if torch.equal(before[n], after[n])]
    if unchanged:
        raise AssertionError(f"{len(unchanged)} trainable tensors did not change: "
                             f"{unchanged[:5]}")
    loss_after = _pool_loss(state, packed, model_cfg, train_cfg, dev)
    print(f"{len(frozen)} FrozenBN tensors bit-equal, {len(trainable)} trainable tensors all "
          f"changed; mean total loss over the pool of {len(packed)} scenes (eval mode) "
          f"{loss_before:.6f} before -> {loss_after:.6f} after {TRAIN_STEPS} steps")
    if not loss_after < loss_before:
        raise AssertionError("the loss over the pool did not fall")

    steady = rows[2:]
    step_ms = statistics.median(r["ms"] for r in steady)
    phases = {p: statistics.median(r["phases"][p] for r in steady) for p in TRAIN_PHASES}
    print(f"train step at {H}x{W}, batch {BATCH}, {TRAIN_SLOTS} slots, flagship config, float32, "
          f"remat_backbone={model_cfg.remat_backbone}: median {step_ms:.3f} ms/step over steps "
          f"3-{TRAIN_STEPS} ({BATCH * 1e3 / step_ms:.3f} frames/s), first step "
          f"{rows[0]['ms']:.1f} ms, device ms by phase "
          f"{ {k: round(v, 3) for k, v in phases.items()} }, peak device memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes) on {card}")
    return state, train_step, pool, launches


def card_against_cpu(dev, model_cfg, params=None, what="full depth"):
    """Phase 12 (and phase 20 for rgb-only): one train step from the same
    state on the card and the CPU, at batch 2 and 128x160: `params` (the
    int8 weights) or else the train state's seeded init."""
    import dataclasses

    from quber_tpu_torch.config import TrainConfig
    from quber_tpu_torch.models.from_jax import state_dict_from_jax
    from quber_tpu_torch.models.layers import BatchNorm, ConvNorm
    from quber_tpu_torch.profiling import packed_scene_pool
    from quber_tpu_torch.train.device_targets import make_device_target_step
    from quber_tpu_torch.train.loop import create_train_state

    model_cfg = dataclasses.replace(model_cfg, height=128, width=160, aspp_dropout=0.0)
    train_cfg = TrainConfig(batch_size=2, warmup_iters=2)
    packed = torch.from_numpy(packed_scene_pool(model_cfg, train_cfg, 2, TRAIN_SLOTS, seed=21))
    sd = None if params is None else state_dict_from_jax(params)
    results = {}
    for device in (dev, torch.device("cpu")):
        state = create_train_state(model_cfg, train_cfg, device=device)
        if sd is not None:
            state.model.load_state_dict(sd, strict=True)
        step = make_device_target_step(model_cfg, train_cfg, TRAIN_SLOTS)
        _, metrics = step(state, packed.to(device))
        grads = {n: p.grad.detach().cpu().double()
                 for n, p in state.model.named_parameters() if p.requires_grad}
        results[device.type] = ({k: float(v) for k, v in metrics.items()}, grads)
    (loss_gpu, grad_gpu), (loss_cpu, grad_cpu) = results["cuda"], results["cpu"]
    for k, v in loss_cpu.items():
        if not abs(loss_gpu[k] - v) <= CPU_LOSS_RTOL * abs(v):
            raise AssertionError(f"card against CPU: {k} {loss_gpu[k]} on the card, {v} on the CPU")
    # a conv bias ahead of a BatchNorm that normalises with the batch's
    # statistics has an exactly zero gradient: what autograd returns for it is
    # float noise, with no direction to compare
    zero_grad = {f"{name}.conv.bias" for name, mod in state.model.named_modules()
                 if isinstance(mod, ConvNorm) and isinstance(mod.norm, BatchNorm)
                 and mod.conv.bias is not None}
    worst, largest_zero = (1.0, None), 0.0
    for name, g in grad_cpu.items():
        if name in zero_grad:
            weight = name[:-len("bias")] + "weight"
            largest_zero = max(largest_zero, float(g.norm() / grad_cpu[weight].norm()),
                               float(grad_gpu[name].norm() / grad_gpu[weight].norm()))
            continue
        cos = float(torch.nn.functional.cosine_similarity(g.flatten(), grad_gpu[name].flatten(),
                                                          dim=0))
        worst = min(worst, (cos, name))
    print(f"card against CPU, one step at batch 2, 128x160, {what}: losses card {loss_gpu} "
          f"cpu {loss_cpu} (rtol {CPU_LOSS_RTOL}); gradient cosine of "
          f"{len(grad_cpu) - len(zero_grad)} trainable tensors min {worst[0]:.6f} at {worst[1]} "
          f"(need >= {GRAD_COSINE}); {len(zero_grad)} biases ahead of a batch-statistics "
          f"BatchNorm have a zero gradient: largest norm {largest_zero:.3g} of their conv "
          f"weight's (need < {ZERO_GRAD_SHARE})")
    if worst[0] < GRAD_COSINE:
        raise AssertionError("card and CPU disagree on a gradient")
    if not zero_grad <= set(grad_cpu) or not largest_zero < ZERO_GRAD_SHARE:
        raise AssertionError("a bias ahead of a batch-statistics BatchNorm has a gradient")


def checkpoint_roundtrip(state, train_step, bufs, model_cfg, train_cfg, dev):
    """Phase 13: a restored checkpoint takes the same next step."""
    from quber_tpu_torch.train.checkpoint import restore_state, save_state
    from quber_tpu_torch.train.loop import create_train_state

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        save_state(ckpt, state)
        size = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(ckpt) for f in fs)
        fresh = create_train_state(model_cfg, train_cfg, device=dev)
        if restore_state(ckpt, fresh) is None:
            raise AssertionError("restore_state found no finished checkpoint")
    if fresh.step != state.step:
        raise AssertionError(f"restored step {fresh.step}, saved {state.step}")
    _, want = train_step(state, bufs)
    _, got = train_step(fresh, bufs)
    want = {k: float(v) for k, v in want.items()}
    got = {k: float(v) for k, v in got.items()}
    print(f"checkpoint of step {fresh.step - 1} ({size} bytes): step {fresh.step} losses from "
          f"the live state {want}, from the restored one {got} (rtol {CHECKPOINT_RTOL})")
    for k, v in want.items():
        if not abs(got[k] - v) <= CHECKPOINT_RTOL * abs(v):
            raise AssertionError(f"checkpoint: {k} differs after restore")


def train_phases(params, rows, floor_ms, dev, card, work):
    """Phases 10-13; adds the training-shape numbers to the kernels' rows.
    Saves the state after phase 11's steps under `work`/trained (phase 17)
    and returns (that directory, a copy of the state dict it holds)."""
    from quber_tpu_torch.config import TrainConfig
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
    from quber_tpu_torch.profiling import packed_scene_pool
    from quber_tpu_torch.train.checkpoint import save_state

    model_cfg = MaskRefinerConfig()
    # a warm-up of two steps: the rate is the base rate from the third step on
    train_cfg = TrainConfig(batch_size=BATCH, warmup_iters=2)
    t0 = time.perf_counter()
    packed = packed_scene_pool(model_cfg, train_cfg, TRAIN_POOL, TRAIN_SLOTS, seed=11)
    print(f"{TRAIN_POOL} scenes rendered, perturbed and packed on the host in "
          f"{time.perf_counter() - t0:.1f} s ({packed.shape[1]} bytes a scene)")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    encode_train, stats_train = check_targets(packed, model_cfg, train_cfg, dev, flush)
    del flush
    state, train_step, pool, launches = train_full_width(params, packed, model_cfg, train_cfg,
                                                         dev, card)
    by_name = {row["name"]: row for row in rows}
    encode_train["launches"] = launches["encode_initial_masks_batched"]
    stats_train["launches"] = launches["instance_stats"]
    encode_train["floor_ms"] = stats_train["floor_ms"] = floor_ms
    by_name["encode_initial_masks_batched"]["train"] = encode_train
    by_name["instance_stats"]["train"] = stats_train
    trained_dir = os.path.join(work, "trained")
    save_state(trained_dir, state)
    trained = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    checkpoint_roundtrip(state, train_step, pool.next_batch(), model_cfg, train_cfg, dev)
    del state, pool
    torch.cuda.empty_cache()
    card_against_cpu(dev, model_cfg, params)
    return trained_dir, trained


class _Recording:
    """A refiner for run_eval that keeps each frame's initial and refined
    masks."""

    def __init__(self, inner):
        self.inner, self.initial, self.masks = inner, [], []
        self.seconds = inner.seconds

    def predict(self, rgb_path, depth_path, initial_masks, fg_mask):
        out = self.inner.predict(rgb_path, depth_path, initial_masks, fg_mask)
        self.initial.append(initial_masks)
        self.masks.append(out[0])
        return out

    def predict_stream(self, items, batch_size):
        def recorded():
            for item in items:
                self.initial.append(item[2])
                yield item

        for out in self.inner.predict_stream(recorded(), batch_size):
            self.masks.append(out[0])
            yield out


def _check_eval_kernels(dev, base_masks):
    """The statistics and encode kernels, single-frame and batched, at the
    evaluation frames' shapes (their perturbed initial masks)."""
    frames = [torch.from_numpy(np.asarray(m) > 0) for m in base_masks]
    _check_encode(f"eval frame 1, N={len(frames[0])}", frames[0].to(dev),
                  torch.ones(len(frames[0]), dtype=torch.bool, device=dev))
    n = max(len(f) for f in frames[:BATCH])
    masks = torch.zeros((BATCH, n, H, W), dtype=torch.bool)
    valid = torch.zeros((BATCH, n), dtype=torch.bool)
    for b, f in enumerate(frames[:BATCH]):
        masks[b, :len(f)] = f
        valid[b, :len(f)] = True
    _check_encode(f"eval frames 1-{BATCH}, B={BATCH} N={n}", masks.to(dev), valid.to(dev))


def _fg_phase(rgb_paths, depth_paths, params, card):
    """Two frames refined with the LMFFNet filter and one with CGNet on the
    card; each net's logits and argmax against the same net on the CPU."""
    from quber_tpu_torch.evaluation.base_models import GT
    from quber_tpu_torch.evaluation.refiner_models import QuBERRefiner
    from quber_tpu_torch.models.fg_predictor import CGNetPredictor, LMFFNetPredictor
    from quber_tpu_torch.ops.preprocess import load_rgbd

    seconds = {}
    for fg_model, cls, n in (("lmffnet", LMFFNetPredictor, 2), ("cgnet", CGNetPredictor, 1)):
        refiner = QuBERRefiner(params=params, fg_model=fg_model, device="cuda")
        cpu = cls(seed=0, device="cpu")
        for rgb, depth in list(zip(rgb_paths, depth_paths))[:n]:
            masks = GT("OSD").predict(rgb, depth)[0]
            refined, _, _, fg = refiner.predict(rgb, depth, masks, None)
            x = refiner.fg_predictor.inputs(*load_rgbd(rgb, depth, cls.size)[:2])
            logits = refiner.fg_predictor.logits(x)
            torch.cuda.synchronize()
            agree = float((logits.argmax(dim=0).cpu() == cpu.logits(x).argmax(dim=0)).float()
                          .mean())
            finite = bool(torch.isfinite(logits).all())
            print(f"{fg_model} on the card: logits {list(logits.shape)} finite {finite}, "
                  f"foreground {fg.shape} {fg.dtype} ({fg.mean():.4f} of the pixels), "
                  f"argmax equal to the CPU's on {agree:.6f} (need >= {FG_AGREEMENT}), "
                  f"{len(refined)} refined instances kept of {len(masks)} GT masks handed in")
            if not finite or fg.shape != (H, W) or fg.dtype != bool or agree < FG_AGREEMENT:
                raise AssertionError(f"{fg_model}: the foreground filter failed on the card")
        seconds[fg_model] = refiner.seconds["fg"] / n
    print(f"foreground net s/frame (LMFFNet: forward on the refiner's frame; CGNet: its own "
          f"320x240 read + inpaint + forward): "
          f"{ {k: round(v, 4) for k, v in seconds.items()} } on {card}")
    return seconds


def _reference():
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "quber_tpu_torch",
                           "evaluation", "reference_synth_osd16.json")) as f:
        return json.load(f)


def _eval_refiner(config, params, frames, replay=False):
    """A QuBERRefiner without the foreground filter on the card that keeps
    each frame it reads in `frames` ({(rgb path, depth path): what
    load_rgbd gave}), or, with `replay`, reads none and refines those."""
    from quber_tpu_torch.evaluation.refiner_models import QuBERRefiner

    class Refiner(QuBERRefiner):
        def _load(self, rgb_path, depth_path):
            if replay:
                return frames[rgb_path, depth_path]
            frames[rgb_path, depth_path] = super()._load(rgb_path, depth_path)
            return frames[rgb_path, depth_path]

    return Refiner(config, params, use_fg_filter=False, device="cuda")


def evaluation_phase(params, rows, card, work):
    """Phase 14: the evaluation entry point on the card (run_eval per image
    and streamed, each pass reading its frames) on the first frames of the
    synthetic-OSD anchor, written under `work`. Returns (dataset root, the
    per-image pass's refined masks, the frames it read, their initial
    masks)."""
    from quber_tpu_torch.data.make_synthetic_dataset import main as make_dataset
    from quber_tpu_torch.evaluation.datasets import build_file_lists
    from quber_tpu_torch.evaluation.harness import PRINT_KEYS, masks_to_label_image, run_eval
    from quber_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    reference = _reference()
    tmp = os.path.join(work, "phase14")
    root = os.path.join(work, "synth_osd")
    t0 = time.perf_counter()
    make_dataset(["--out", root, "--n", str(EVAL_FRAMES), "--seed", "1000",
                  "--depth-range", "250", "1500"])
    rgb_paths, depth_paths, anno_paths = build_file_lists("OSD", root)
    print(f"{len(rgb_paths)} frames written and listed in {time.perf_counter() - t0:.1f} s")
    if len(rgb_paths) != EVAL_FRAMES:
        raise AssertionError("the OSD walker did not find the frames written")

    frames = {}
    refiner = _Recording(_eval_refiner(None, params, frames))
    passes = {}
    for name, batch in (("per-image", 0), ("streamed", BATCH)):
        refiner.inner.seconds.clear()
        refiner.initial, refiner.masks = [], []
        os.makedirs(os.path.join(tmp, name))
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_eval(base_model="perturbed-gt", refiner_model=refiner,
                       test_dataset="OSD", dataset_path=root, refine_batch=batch,
                       csv_path=os.path.join(tmp, name, "eval.csv"), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        passes[name] = (res, _launch_counts(), list(refiner.masks), wall)
    _check_eval_kernels(dev, refiner.initial)
    fg_seconds = _fg_phase(rgb_paths, depth_paths, params, card)

    (res1, launches1, masks1, wall1), (res2, launches2, masks2, wall2) = passes.values()
    print(f"evaluation per image: launches {launches1}; streamed (B={BATCH}): {launches2}")
    n_batches = -(-EVAL_FRAMES // BATCH)
    for name in ("instance_stats", "encode_initial_masks", "group_pixels"):
        if launches1[name] != EVAL_FRAMES:
            raise AssertionError(f"per-image evaluation: {name} launched {launches1[name]} "
                                 f"times for {EVAL_FRAMES} frames")
    for name in ("encode_initial_masks_batched", "group_pixels_batched"):
        if launches1[name]:
            raise AssertionError(f"per-image evaluation: {name} was launched")
    _check_launches("streamed evaluation", launches2, n_batches)

    agreements = []
    for i, (a, b) in enumerate(zip(masks1, masks2)):
        la = masks_to_label_image(a, np.zeros((H, W), np.int32))
        lb = masks_to_label_image(b, np.zeros((H, W), np.int32))
        agreements.append(float((la == lb).mean()))
        if len(a) != len(b) or agreements[-1] < PANOPTIC_AGREEMENT:
            raise AssertionError(f"evaluation frame {i}: per image {len(a)} instances, streamed "
                                 f"{len(b)}, label agreement {agreements[-1]:.6f}")
    if len(masks1) != EVAL_FRAMES or len(masks2) != EVAL_FRAMES:
        raise AssertionError("a pass did not refine every frame")
    print(f"streamed against per image: instances per frame {[len(m) for m in masks1]} equal, "
          f"label agreement min {min(agreements):.6f} (need >= {PANOPTIC_AGREEMENT})")
    worst = max(abs(res2[s][k] - res1[s][k]) for s in ("initial", "refined") for k in PRINT_KEYS)
    print(f"streamed against per image: largest difference of an aggregate mean {worst:.3g} "
          f"(tolerance {EVAL_MEANS_ATOL})")
    if not worst <= EVAL_MEANS_ATOL:
        raise AssertionError("streamed and per-image evaluation disagree")

    for key in ("Objects F-measure", "Boundary F-measure"):
        for stage, tol in (("initial", 0.0), ("refined", EVAL_REFERENCE_ATOL)):
            got, want = res1[stage][key], reference[stage][key]
            print(f"{stage} {key}: card {got:.6f}, JAX package on the CPU {want:.6f}, "
                  f"difference {got - want:+.6f} (tolerance {tol})")
            if not abs(got - want) <= tol:
                raise AssertionError(f"{stage} {key} is off the JAX package's")

    sec = res1["seconds"]
    per_frame = {"read, normalise and inpaint": sec["read"], "annotation": sec["annotation"],
                 "base model": sec["base"], "refine": sec["refine"], "metrics": sec["metrics"]}
    per_frame = {k: round(v / EVAL_FRAMES, 4) for k, v in per_frame.items()}
    print(f"evaluation seconds per frame by stage, per-image pass: {per_frame}, foreground "
          f"net {fg_seconds}; pass wall {wall1:.2f} s per image, {wall2:.2f} s streamed "
          f"({EVAL_FRAMES} frames) on {card}")
    for row in rows:
        name = row["name"]
        if name in launches1:
            row["eval"] = {"launches_per_image": launches1[name],
                           "launches_streamed": launches2[name]}
    return root, masks1, frames, refiner.initial


def _stack(rng, b, n, n_valid, dev):
    """Ellipse masks [b, n, H, W] (or [n, H, W] for b = 0) with the first
    n_valid[i] slots valid and slot 5 empty."""
    lead = (b,) if b else ()
    masks = np.stack([_ellipse_masks(rng, n, H, W) for _ in range(max(b, 1))])
    masks[:, 5] = False
    valid = np.arange(n)[None] < np.array(n_valid).reshape(-1, 1)
    masks, valid = masks.reshape(lead + masks.shape[1:]), valid.reshape(lead + (n,))
    return torch.from_numpy(masks).to(dev), torch.from_numpy(valid).to(dev)


def _encode_case(tag, masks, valid, flush):
    """Statistics and encode kernels against their plain versions, and both
    timed with their bounds: (stats entry, encode entry)."""
    from quber_tpu_torch.ops import encoding, kernels

    batched = masks.dim() == 4
    _, centers, ok = _check_stats(tag, masks, valid)
    kernel = kernels.encode_initial_masks_batched if batched else kernels.encode_initial_masks
    plain = encoding.encode_from_stats_batched if batched else encoding.encode_from_stats
    got, want = kernel(masks, ok, centers), plain(masks, ok, centers)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"encode {tag}, {int(ok.sum())} ok: max |kernel - plain| = {err:.3g} "
          f"(tolerance {ENCODE_ATOL})")
    if not err <= ENCODE_ATOL:
        raise AssertionError(f"encode kernel disagrees with its plain version ({tag})")
    hw, frames, slots = H * W, (masks.shape[0] if batched else 1), masks.shape[-3]
    n_ok = int(ok.sum())
    bound_ms, bound_by = _bound(n_ok * hw + frames * slots * 9 + frames * 3 * hw * 4,
                                hw * n_ok * 8 + frames * hw * 20)
    encode = {"shape": f"masks {list(masks.shape)} bool, {n_ok} ok", "max_abs_err": err,
              "ms": _time_ms(lambda: kernel(masks, ok, centers), flush),
              "plain_ms": _time_ms(lambda: plain(masks, ok, centers), flush),
              "bound_ms": bound_ms, "bound_by": bound_by}
    return {**_stats_case(masks, valid, flush), "max_abs_err": 0.0}, encode


def _group_case(tag, k, n_valid, offsets, rng, flush):
    from quber_tpu_torch.ops import grouping, kernels

    batched = offsets.dim() == 4
    frames = offsets.shape[0] if batched else 1
    lead = (frames,) if batched else ()
    cen = np.stack([rng.randint(0, H, lead + (k,)), rng.randint(0, W, lead + (k,))], -1)
    cen = torch.from_numpy(cen.astype(np.int32)).to(offsets.device)
    val = torch.from_numpy((np.arange(k)[None] < np.array(n_valid).reshape(-1, 1))
                           .reshape(lead + (k,))).to(offsets.device)
    kernel = kernels.group_pixels_batched if batched else kernels.group_pixels
    plain = grouping.group_pixels_batched if batched else grouping.group_pixels
    _check_group(tag, cen, val, offsets)
    hw = H * W
    bound_ms, bound_by = _bound(frames * 3 * hw * 4 + frames * k * 9,
                                hw * int(val.sum()) * 6 + frames * hw * 2)
    return {"shape": f"centers {list(cen.shape)}, {int(val.sum())} valid, offsets "
                     f"{list(offsets.shape)}", "max_abs_err": 0.0,
            "ms": _time_ms(lambda: kernel(cen, val, offsets), flush),
            "plain_ms": _time_ms(lambda: plain(cen, val, offsets), flush),
            "bound_ms": bound_ms, "bound_by": bound_by}


def check_serving_kernels(dev, flush):
    """Phase 15: the kernels at the shapes of the bfloat16 serving config
    (24 candidates, 24 slots) and of the benchmark's batches of 16. Returns
    {kernel name: {case: entry}}."""
    rng = np.random.RandomState(15)
    cases = {name: {} for name in ("instance_stats", "encode_initial_masks", "group_pixels",
                                   "encode_initial_masks_batched", "group_pixels_batched")}
    masks, valid = _stack(rng, 0, TUNED_SLOTS, [20], dev)
    stats, encode = _encode_case(f"N={TUNED_SLOTS} {H}x{W}", masks, valid, flush)
    cases["instance_stats"]["n24"], cases["encode_initial_masks"]["n24"] = stats, encode
    offsets = (torch.randn((2, H, W), generator=torch.Generator().manual_seed(15)) * 20).to(dev)
    cases["group_pixels"]["k24"] = _group_case(f"K={TUNED_K} (no fast path)", TUNED_K, [18],
                                               offsets, rng, flush)
    b = BENCH_BATCH
    for n in (TUNED_SLOTS, N_MASKS):
        n_valid = [min(n, v) for v in (3, 8, 5, 24, 7, 0, 6, 4, 8, 3, 5, 64, 6, 7, 1, 4)]
        masks, valid = _stack(rng, b, n, n_valid, dev)
        stats, encode = _encode_case(f"B={b} N={n} {H}x{W}", masks, valid, flush)
        cases["instance_stats"][f"b{b}_n{n}"] = stats
        cases["encode_initial_masks_batched"][f"b{b}_n{n}"] = encode
        del masks
    offsets = (torch.randn((b, 2, H, W), generator=torch.Generator().manual_seed(16))
               * 20).to(dev)
    for k in (TUNED_K, 200):
        n_valid = [min(k, v) for v in (5, 8, 3, 24, 7, 0, 6, 4, 8, 3, 5, 30, 6, 7, 1, 4)]
        cases["group_pixels_batched"][f"b{b}_k{k}"] = _group_case(
            f"B={b} K={k}", k, n_valid, offsets, rng, flush)
    return cases


def _bf16_error_ratios(got, f32, jax_err):
    """mean |got - float32| of each output over the JAX package's own mean
    |bfloat16 - float32| on the same frame."""
    return {k: float((got[k] - f32[k]).abs().mean()) / e for k, e in jax_err.items()}


def bf16_evaluation(params, root, masks_f32, frames, card):
    """Phase 16: the 16 anchor frames (as phase 14 read them) through run_eval
    with a bfloat16 refiner, per image; its labels against phase 14's float32
    pass, and its forward's error against the JAX package's on two frames,
    with two controls the error gate must refuse."""
    from quber_tpu_torch.evaluation.harness import masks_to_label_image, run_eval
    from quber_tpu_torch.models.layers import Conv2d
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.predictor import MaskRefinerPredictor

    reference = _reference()
    bf16 = MaskRefinerConfig(dtype="bfloat16")
    refiner = _Recording(_eval_refiner(bf16, params, frames, replay=True))
    csv_dir = os.path.join(os.path.dirname(root), "phase16")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_eval(base_model="perturbed-gt", refiner_model=refiner, test_dataset="OSD",
                   dataset_path=root, csv_path=os.path.join(csv_dir, "eval.csv"), device="cuda")
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    print(f"bfloat16 evaluation, {EVAL_FRAMES} frames per image (read in phase 14): launches "
          f"{launches}, pass wall {wall:.2f} s, refine "
          f"{refiner.inner.seconds['refine'] / EVAL_FRAMES:.4f} s/frame on {card}")
    for name in ("instance_stats", "encode_initial_masks", "group_pixels"):
        if launches[name] != EVAL_FRAMES:
            raise AssertionError(f"bfloat16 evaluation: {name} launched {launches[name]} times")

    agree, moved = [], []
    for i, (a, b) in enumerate(zip(masks_f32, refiner.masks)):
        la = masks_to_label_image(a, np.zeros((H, W), np.int32))
        lb = masks_to_label_image(b, np.zeros((H, W), np.int32))
        agree.append(float((la == lb).mean()))
        if len(a) != len(b) or agree[-1] < BF16_AGREEMENT:
            moved.append(i + 1)
    print(f"bfloat16 against float32 on the card, per frame: label agreement "
          f"{[round(a, 6) for a in agree]}, instances float32 {[len(m) for m in masks_f32]}, "
          f"bfloat16 {[len(m) for m in refiner.masks]}; frames that moved {moved} (at most "
          f"{BF16_MOVED_FRAMES} may: a count or < {BF16_AGREEMENT} of the labels)")
    if len(refiner.masks) != EVAL_FRAMES or len(moved) > BF16_MOVED_FRAMES:
        raise AssertionError("bfloat16 moved more frames off float32 than a knife edge explains")
    for key in ("Objects F-measure", "Boundary F-measure"):
        got, want = res["initial"][key], reference["initial"][key]
        print(f"bfloat16 initial {key}: card {got:.6f}, JAX package on the CPU {want:.6f}, "
              f"difference {got - want:+.6f} (tolerance 0)")
        if got != want:
            raise AssertionError(f"bfloat16 initial {key} is off the JAX package's")
        got, jax16, f32 = (res["refined"][key], reference["refined_bfloat16"][key],
                           reference["refined"][key])
        print(f"bfloat16 refined {key}: card {got:.6f}, JAX package on the CPU in float32 "
              f"{f32:.6f} (card {got - f32:+.6f}) and in bfloat16 {jax16:.6f} (JAX "
              f"{jax16 - f32:+.6f}, card against it {got - jax16:+.6f}); not gated")

    # the forward: its error against the JAX package's own, with two controls
    f32_predictor = MaskRefinerPredictor(params=params, device="cuda")
    fp16_predictor = MaskRefinerPredictor(bf16, params, device="cuda")
    for mod in fp16_predictor.model.modules():
        if isinstance(mod, Conv2d):
            mod.compute_dtype = torch.float16
    keys = list(frames)  # in run_eval's order, as refiner.initial
    for frame, jax_err in reference["bfloat16_mean_abs_err"].items():
        i = int(frame) - 1
        inputs = (*frames[keys[i]][:2], refiner.initial[i])
        f32 = f32_predictor.predict_raw(*inputs)
        for name, predictor, passes in (("bfloat16", refiner.inner.predictor, True),
                                        ("control: float32", f32_predictor, False),
                                        ("control: float16", fp16_predictor, False)):
            ratios = _bf16_error_ratios(predictor.predict_raw(*inputs), f32, jax_err)
            inside = all(BF16_ERR_LOW <= r <= BF16_ERR_HIGH for r in ratios.values())
            where = {True: "inside", False: "outside"}
            print(f"frame {frame}, {name}: mean |out - float32| over the JAX package's "
                  f"bfloat16 error {({k: round(r, 4) for k, r in ratios.items()})} "
                  f"(gate [{BF16_ERR_LOW}, {BF16_ERR_HIGH}] on every output: "
                  f"{where[inside]}, must be {where[passes]})")
            if inside != passes:
                raise AssertionError(f"frame {frame}: {name} forward "
                                     f"{'fails' if passes else 'passes'} the bfloat16 gate")
    return res


def checkpoint_evaluation(trained_dir, trained, root):
    """Phase 17: run_eval_torch.py's main on the training checkpoint against
    run_eval on the same weights in memory."""
    import csv

    import run_eval_torch
    from quber_tpu_torch.evaluation.harness import run_eval

    out = os.path.join(os.path.dirname(root), "phase17")
    common = dict(base_model="perturbed-gt", refiner_model="maskrefiner-nofilter",
                  test_dataset="OSD", dataset_path=root, limit=CKPT_EVAL_FRAMES, tag="same")
    run_eval(params=trained, csv_path=os.path.join(out, "memory", "eval.csv"),
             device="cuda", **common)
    rc = run_eval_torch.main(["--base-model", "perturbed-gt", "--test-dataset", "OSD",
                              "--dataset-path", root, "--weights-file", trained_dir,
                              "--limit", str(CKPT_EVAL_FRAMES), "--tag", "same",
                              "--csv", os.path.join(out, "checkpoint", "eval.csv")])
    if rc != 0:
        raise AssertionError(f"run_eval_torch.py exited with {rc}")
    rows, means = {}, {}
    for name in ("memory", "checkpoint"):
        with open(os.path.join(out, name, "eval.csv")) as f:
            rows[name] = [{k: v for k, v in r.items() if k != "avg_ms"}
                          for r in csv.DictReader(f)]
        means[name] = [(r["stage"], r["Objects F-measure"], r["Boundary F-measure"])
                       for r in rows[name]]
    print(f"checkpoint evaluation, {CKPT_EVAL_FRAMES} frames: from the directory "
          f"{means['checkpoint']}, in memory {means['memory']} (tolerance 0)")
    if len(rows["memory"]) != 2 or rows["memory"] != rows["checkpoint"]:
        raise AssertionError("the checkpoint directory evaluates unlike the state it holds")


def _run_clis(commands, cwd):
    """Run the repo's CLIs on the card (each command the interpreter's
    arguments: a script's path, or -m and a module), each in a subprocess of
    its own, all at once: their outputs."""
    procs = [subprocess.Popen([sys.executable, *args], cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for args in commands]
    try:
        outs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for args, proc, out in zip(commands, procs, outs):
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(args[:2])} exited with {proc.returncode}: "
                                 f"{out[-2000:]}")
    return outs


def cli_phase(params, root, frames, card):
    """Phase 18: predict_torch.py on one written frame and demo_torch.py on
    DEMO_FRAMES, in two subprocesses on the card at once, with the bfloat16
    serving config (24 candidates); each frame's count held against this
    process's predictor with the same config (on the frames phase 14 read),
    whose single-frame and batched launches are counted. Returns both
    counts."""
    import glob
    import shutil

    from quber_tpu_torch.config import load_config
    from quber_tpu_torch.evaluation.base_models import GT, PerturbedGT
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.ops.preprocess import resize_nearest
    from quber_tpu_torch.predictor import MaskRefinerPredictor

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(os.path.dirname(root), "phase18")
    os.makedirs(work)
    cfg_path = os.path.join(work, "serving.yaml")
    base = os.path.join(here, "configs",
                        "mask_refiner_rgbd_concat_l2_gn_hf_m_b_f_c_o_l3_e2_b8.yaml")
    with open(cfg_path, "w") as f:
        f.write(f"_BASE_: {base}\nmodel:\n  dtype: bfloat16\n  top_k_instances: {TUNED_K}\n")
    rgb_paths = sorted(glob.glob(os.path.join(root, "image_color", "*.png")))
    rgb_path = rgb_paths[0]
    depth_path = rgb_path.replace("image_color", "disparity")
    masks = PerturbedGT("OSD").predict(rgb_path, depth_path)[0]
    np.save(os.path.join(work, "masks.npy"), masks.astype(np.uint8))
    demo = os.path.join(work, "demo")
    for sub in ("image_color", "disparity", "annotation"):
        os.makedirs(os.path.join(demo, sub))
        for p in sorted(glob.glob(os.path.join(root, sub, "*.png")))[:DEMO_FRAMES]:
            shutil.copy(p, os.path.join(demo, sub))

    t0 = time.perf_counter()
    out, demo_out = _run_clis([
        [os.path.join(here, "predict_torch.py"), "--rgb", rgb_path, "--depth", depth_path,
         "--masks", os.path.join(work, "masks.npy"), "--out", os.path.join(work, "refined.png"),
         "--config-file", cfg_path],
        [os.path.join(here, "demo_torch.py"),
         "--input", os.path.join(demo, "image_color", "*.png"),
         "--depth-dir", os.path.join(demo, "disparity"), "--base-model", "gt",
         "--output", os.path.join(work, "vis"), "--config-file", cfg_path]], work)
    cli_s = time.perf_counter() - t0
    line = next(l for l in out.splitlines() if l.startswith("refined "))
    cli_count = int(line.split("-> ")[1].split()[0])
    cfg, _ = load_config(cfg_path)
    predictor = MaskRefinerPredictor(cfg, params, device="cuda")
    size = (cfg.height, cfg.width)
    read = {os.path.basename(rgb): frame for (rgb, _), frame in frames.items()}
    rgb, depth, _ = read[os.path.basename(rgb_path)]
    kernels.reset_launch_counts()
    result = predictor.predict(rgb, depth, [resize_nearest(m.astype(np.uint8), size)
                                            for m in masks])[0]
    torch.cuda.synchronize()
    single = _launch_counts()
    count = len(result.get("instances", {}).get("scores", []))
    print(f"predict_torch.py (subprocess): '{line}'; the predictor here "
          f"{count} instances, launches {single}")
    if cli_count != count or not count:
        raise AssertionError("predict_torch.py and the predictor disagree")
    if any(single[n] != 1 for n in ("instance_stats", "encode_initial_masks", "group_pixels")):
        raise AssertionError("the single-frame path did not launch each kernel once")

    cli_counts = [int(l.split(": ")[1].split()[0]) for l in demo_out.splitlines()
                  if " instances -> " in l]
    items = []
    for p in rgb_paths[:DEMO_FRAMES]:
        d = p.replace("image_color", "disparity")
        items.append((*read[os.path.basename(p)][:2], list(GT("OSD").predict(p, d)[0])))
    kernels.reset_launch_counts()
    counts = [c for _, c, _ in predictor.predict_batch_stream(iter(items), batch_size=4)]
    batched = _launch_counts()
    print(f"demo_torch.py (subprocess): counts {cli_counts}; the predictor's stream here "
          f"{counts}, launches {batched}; both CLIs ran at once, {cli_s:.1f} s on {card}")
    if cli_counts != counts or len(counts) != DEMO_FRAMES:
        raise AssertionError("demo_torch.py and the predictor disagree")
    _check_launches("demo stream (B=4)", batched, 1)
    return single, batched


def bench_phase(frames, initial):
    """Phase 19: bench_torch.py shortened, its JSON line on a line of its
    own, on the frames phase 14 read (each twice) with their initial masks."""
    import bench_torch
    from quber_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    scenes = [(rgb, depth[..., 0], [np.asarray(m) > 0 for m in masks])
              for (rgb, depth, _), masks in zip(frames.values(), initial)]
    scenes = (scenes * -(-BENCH_FRAMES // len(scenes)))[:BENCH_FRAMES]
    line = bench_torch.run(BENCH_FRAMES, trials=1, frames=scenes)
    launches = _launch_counts()
    print(json.dumps(line))
    print(f"bench_torch ({BENCH_FRAMES} frames, one pass a configuration): "
          f"{time.perf_counter() - t0:.1f} s, launches {launches}")
    rates = [line[k] for k in ("value", "fps_default_config", "fps_k200_n24", "fps_k24_n64",
                               "fps_float32", "streaming_fps")]
    if not all(np.isfinite(r) and r > 0 for r in rates) or not line["flops_forward"] > 0:
        raise AssertionError("bench_torch reported a rate that is not positive")
    for name in ("instance_stats", "encode_initial_masks_batched", "group_pixels_batched"):
        if not launches[name]:
            raise AssertionError(f"bench_torch did not launch {name}")
    return launches


def _variant_models():
    """The flagship (the control), the six ablation configs as MaskRefiners
    and the Panoptic-DeepLab module, each from the same seeded init, in
    eval mode on the CPU: {name: (model, config or None)}."""
    import dataclasses

    from quber_tpu_torch.models.mask_refiner import MaskRefiner, MaskRefinerConfig
    from quber_tpu_torch.models.panoptic_deeplab import PanopticDeepLab

    models = {}
    for name, overrides in {"flagship": {}, **ABLATION_CONFIGS}.items():
        cfg = dataclasses.replace(MaskRefinerConfig(), **overrides)
        models[name] = (MaskRefiner(cfg), cfg)
    models["PanopticDeepLab"] = (PanopticDeepLab(), None)
    for model, _ in models.values():
        model.reset_parameters(torch.Generator().manual_seed(ABLATION_SEED))
        model.eval()
    return models


def ablation_phase(frames, initial, dev, card):
    """Phase 20: every ablation variant at full width on one of phase 14's
    frames, card against CPU; each MaskRefiner variant once through
    predict() with its launches counted; one rgb-only train step card
    against CPU. Returns the launches of the predict() calls, summed."""
    import dataclasses

    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.predictor import MaskRefinerPredictor

    rgb, depth = frames[list(frames)[0]][:2]
    masks = torch.from_numpy(np.asarray(initial[0]) > 0)
    image = torch.from_numpy(np.concatenate([rgb, depth], -1).astype(np.float32))
    image = image.permute(2, 0, 1)[None]
    # the encoding of the frame's initial masks, by the plain versions
    _, centers, ok = kernels.instance_stats(masks, torch.ones(len(masks), dtype=torch.bool),
                                            return_ok=True)
    enc = kernels.encode_initial_masks(masks, ok, centers, sigma=10, normalize=True)[None]
    gaps = {}
    total = dict.fromkeys(_launch_counts(), 0)
    for name, (model, cfg) in _variant_models().items():
        args = (image,) if cfg is None else (image, enc)
        t0 = time.perf_counter()
        with torch.no_grad():
            cpu = model(*args)
            cpu_s = time.perf_counter() - t0
            model.to(dev)
            got = model(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        rel = {k: float((got[k].cpu() - v).abs().max() / v.abs().max()) for k, v in cpu.items()}
        finite = all(bool(torch.isfinite(v).all()) for v in got.values())
        gaps[name] = max(rel.values())
        print(f"{name}: outputs {sorted(got)} of {list(got['offset'].shape[2:])}, max |card - "
              f"CPU| over max |CPU| {({k: float(f'{r:.3g}') for k, r in rel.items()})} "
              f"(tolerance {ABLATION_RTOL}; CPU forward {cpu_s:.2f} s)")
        if not finite or gaps[name] > ABLATION_RTOL:
            raise AssertionError(f"{name}: the card and the CPU disagree on the forward")
        if name in ("flagship", "PanopticDeepLab"):
            continue
        predictor = MaskRefinerPredictor(cfg, model.state_dict(), device="cuda")
        kernels.reset_launch_counts()
        out = predictor.predict(rgb, depth, list(np.asarray(initial[0])))[0]
        torch.cuda.synchronize()
        launches = _launch_counts()
        print(f"{name}: predict() on the card, "
              f"{len(out.get('instances', {}).get('scores', []))} instances, keys "
              f"{sorted(out)}, launches {launches}")
        for k in ("instance_stats", "encode_initial_masks", "group_pixels"):
            if launches[k] != 1:
                raise AssertionError(f"{name}: {k} launched {launches[k]} times for one frame")
        if launches["encode_initial_masks_batched"] or launches["group_pixels_batched"]:
            raise AssertionError(f"{name}: a batched kernel was launched")
        total = {k: total[k] + v for k, v in launches.items()}
        del predictor
    print(f"ablation variants, card against CPU at {H}x{W} float32: largest relative gap "
          f"{max(v for k, v in gaps.items() if k != 'flagship'):.3g}, the flagship's own "
          f"{gaps['flagship']:.3g} (tolerance {ABLATION_RTOL}) on {card}")
    card_against_cpu(dev, dataclasses.replace(MaskRefinerConfig(), **ABLATION_CONFIGS["rgb_only"]),
                     what="rgb_only, seeded init")
    return total


def _segmented(masks):
    """The number of masks of a frame that hold a pixel."""
    return sum(int(np.asarray(m).any()) for m in masks)


def _label_agreement(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def ucn_training(dev, card, work):
    """Phase 21(a): train_zoo_torch's UCN steps at 480x640 on a pool of two
    rendered scenes, card against CPU from the same init; then more steps
    on the card alone, timed. Saves the card's weights under `work` as
    train_zoo_torch does and returns (that checkpoint directory, the state
    dict)."""
    import train_zoo_torch as zoo
    from quber_tpu_torch.models.from_jax import state_dict_to_jax
    from quber_tpu_torch.train.checkpoint import save_params

    t0 = time.perf_counter()
    scenes = zoo.make_labeled_scenes(UCN_POOL, H, W, 7, (250, 1500))
    print(f"{UCN_POOL} UCN scenes rendered in {time.perf_counter() - t0:.1f} s")
    runs = {}
    for device in (dev, torch.device("cpu")):
        model, optimizer = zoo.make_ucn(7, UCN_LR, device)
        step = zoo.make_ucn_step(model, optimizer)
        pool = zoo.stage(scenes, device)
        losses, grads = [], None
        for i in range(UCN_CPU_STEPS):
            loss, _ = step(pool, i % UCN_POOL)
            losses.append(float(loss))
            if grads is None:
                grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}
        runs[device.type] = (losses, grads, {k: v.detach().cpu()
                                             for k, v in model.state_dict().items()})
        if device.type == "cuda":
            on_card = (model, step, pool)
    (loss_gpu, grad_gpu, sd_gpu), (loss_cpu, grad_cpu, sd_cpu) = runs["cuda"], runs["cpu"]
    cos = min((float(torch.nn.functional.cosine_similarity(g.flatten(), grad_gpu[n].flatten(),
                                                           dim=0)), n)
              for n, g in grad_cpu.items())
    diff = max((float((sd_gpu[k] - v).abs().max()), k) for k, v in sd_cpu.items())
    moved = max(float(v.abs().max()) for k, v in sd_gpu.items() if k.endswith("running_mean"))
    print(f"UCN, {UCN_CPU_STEPS} steps at {H}x{W} card against CPU: losses card {loss_gpu} cpu "
          f"{loss_cpu} (rtol {CPU_LOSS_RTOL}); first gradient cosine min {cos[0]:.6f} at "
          f"{cos[1]} (need >= {GRAD_COSINE}); weights and BatchNorm statistics after the steps "
          f"max |card - CPU| {diff[0]:.3g} at {diff[1]} (need <= {2.1 * UCN_LR * UCN_CPU_STEPS:.3g}, "
          f"2.1 learning rates a step); running means moved up to {moved:.3g} from 0")
    for a, b in zip(loss_gpu, loss_cpu):
        if not abs(a - b) <= CPU_LOSS_RTOL * abs(b):
            raise AssertionError("UCN: the card and the CPU disagree on a loss")
    if cos[0] < GRAD_COSINE or diff[0] > 2.1 * UCN_LR * UCN_CPU_STEPS or not moved > 0:
        raise AssertionError("UCN: the card and the CPU disagree on a step")
    model, step, pool = on_card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(UCN_CARD_STEPS):
        t0 = time.perf_counter()
        loss, _ = step(pool, i % UCN_POOL)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"UCN train step on the card: {statistics.median(times):.3f} ms median of "
          f"{UCN_CARD_STEPS} (batch 1, {H}x{W}), loss {float(loss):.4f}, peak "
          f"{peak:.3f} GiB on {card}")
    ckpt = os.path.join(work, "ucn", "ckpt")
    save_params(ckpt, state_dict_to_jax(model), step=UCN_CPU_STEPS + UCN_CARD_STEPS)
    return ckpt, {k: v.detach().clone() for k, v in model.state_dict().items()}


def ucn_clustering(state, frames, card):
    """Phase 21(b): cluster_embeddings on the card and the CPU on the same
    embeddings of phase 14's frames."""
    from quber_tpu_torch.models.ucn import UCNBaseModel
    from quber_tpu_torch.ops.meanshift import cluster_embeddings

    base = UCNBaseModel(params=state, device="cuda")
    counts, agree = [], []
    for rgb_path, depth_path in frames:
        rgb, xyz = (torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1))).cuda()
                    for a in base.read_frame(rgb_path, depth_path))
        with torch.inference_mode():
            emb = base.model(rgb[None], xyz[None])[0].permute(1, 2, 0)
            got = cluster_embeddings(emb)
        want = cluster_embeddings(emb.cpu())
        counts.append((int(got["num_instances"]), int(want["num_instances"])))
        agree.append(_label_agreement(got["labels"].cpu(), want["labels"]))
    edge = [i + 1 for i, a in enumerate(agree) if a < 1.0]
    print(f"UCN clustering, card against CPU on the card's embeddings of {len(agree)} frames: "
          f"instances (card, CPU) {counts}, label agreement min {min(agree):.6f} (need "
          f">= {PANOPTIC_AGREEMENT} and equal counts); knife-edge frames (< 100% equal) {edge}")
    if any(a != b for a, b in counts) or min(agree) < PANOPTIC_AGREEMENT:
        raise AssertionError("UCN: the card and the CPU cluster the same embeddings differently")
    if not any(a for a, _ in counts):
        raise AssertionError("UCN: no frame gave an instance")


def base_evaluation(base, env, ckpt, root, params, frames, card, label, model=None):
    """Phase 14's frames through run_eval with a learned base model (its
    weights through $`env` = `ckpt`, or `model`, the wrapper built for
    `base`) and the flagship refiner, per image and streamed: one
    single-frame launch of each kernel a frame per image, one batched
    launch a batch streamed, the base masks equal between the passes, the
    refined ones as in phase 14. Returns the launches of both passes."""
    from quber_tpu_torch.evaluation.harness import PRINT_KEYS, masks_to_label_image, run_eval
    from quber_tpu_torch.ops import kernels

    if env:
        os.environ[env] = ckpt
    refiner = _Recording(_eval_refiner(None, params, frames, replay=True))
    passes = {}
    for name, batch in (("per-image", 0), ("streamed", BATCH)):
        refiner.inner.seconds.clear()
        refiner.initial, refiner.masks = [], []
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_eval(base_model=model or base, refiner_model=refiner, test_dataset="OSD",
                       dataset_path=root, refine_batch=batch, device="cuda",
                       csv_path=os.path.join(os.path.dirname(root), f"eval_{base}", name,
                                             "eval.csv"))
        torch.cuda.synchronize()
        passes[name] = (res, _launch_counts(), list(refiner.initial), list(refiner.masks),
                        time.perf_counter() - t0)
    (res1, launches1, init1, masks1, wall1), (res2, launches2, init2, masks2, wall2) = \
        passes.values()
    if not sum(_segmented(m) for m in init1):
        raise AssertionError(f"{label} evaluation: the base model segmented no pixel")
    print(f"{label} evaluation per image: launches {launches1}; streamed (B={BATCH}): {launches2}")
    for name in ("instance_stats", "encode_initial_masks", "group_pixels"):
        if launches1[name] != EVAL_FRAMES:
            raise AssertionError(f"{label} evaluation: {name} launched {launches1[name]} times "
                                 f"for {EVAL_FRAMES} frames")
    if launches1["encode_initial_masks_batched"] or launches1["group_pixels_batched"]:
        raise AssertionError(f"{label} evaluation per image: a batched kernel was launched")
    _check_launches(f"{label} evaluation, streamed", launches2, -(-EVAL_FRAMES // BATCH))
    label_image = lambda m: masks_to_label_image(m, np.zeros((H, W), np.int32))  # noqa: E731
    for i in range(EVAL_FRAMES):
        if len(init1[i]) != len(init2[i]) or not np.array_equal(label_image(init1[i]),
                                                                label_image(init2[i])):
            raise AssertionError(f"{label} evaluation frame {i}: the base model's masks differ "
                                 "between the passes")
        agree = _label_agreement(label_image(masks1[i]), label_image(masks2[i]))
        if len(masks1[i]) != len(masks2[i]) or agree < PANOPTIC_AGREEMENT:
            raise AssertionError(f"{label} evaluation frame {i}: per image and streamed disagree")
    if len(masks1) != EVAL_FRAMES or len(masks2) != EVAL_FRAMES:
        raise AssertionError(f"a {label} evaluation pass did not refine every frame")
    # a stage with no instance in any frame has no obj_mIOU
    if any(set(res1[s]) != set(res2[s]) for s in ("initial", "refined")):
        raise AssertionError(f"{label} evaluation: the passes report other metrics")
    worst = max(abs(res2[s][k] - res1[s][k]) for s in ("initial", "refined") for k in PRINT_KEYS
                if k in res1[s])
    if not worst <= EVAL_MEANS_ATOL:
        raise AssertionError(f"{label} evaluation: streamed and per-image means disagree")
    means = {s: {k: round(res1[s][k], 6) for k in ("Objects F-measure", "Boundary F-measure")}
             for s in ("initial", "refined")}
    sec = {k: round(v / EVAL_FRAMES, 4) for k, v in res1["seconds"].items()}
    print(f"{label} base -> flagship int8 refiner, {EVAL_FRAMES} frames: "
          f"instances per frame {[len(m) for m in init1]} (with a pixel "
          f"{[_segmented(m) for m in init1]}) -> {[len(m) for m in masks1]}, "
          f"means {means}, largest streamed difference {worst:.3g}; s/frame {sec}; pass wall "
          f"{wall1:.2f} / {wall2:.2f} s on {card}")
    return launches1, launches2


def base_device_seconds(base, frames, card, model=None):
    """The wrapper's own seconds a frame (its device work and the copy of
    its masks to the host, not the host's reading and inpainting) on the
    first BASE_TIMED_FRAMES frames, after one untimed frame; `model` the
    wrapper built for `base` (else built by name)."""
    from quber_tpu_torch.evaluation.base_models import build_base_model

    model = model or build_base_model(base, "OSD", device="cuda")
    keys = list(frames)[:BASE_TIMED_FRAMES]
    model.predict(*keys[0])
    seconds = [model.predict(*key)[2] for key in keys]
    print(f"{base} wrapper's device seconds a frame (read and inpaint excluded): median "
          f"{statistics.median(seconds):.4f} of {len(keys)} frames on {card}")


def ucn_evaluation(ckpt, root, params, frames, card):
    """Phase 21(c): phase 14's frames through run_eval with the UCN base
    model (from $QUBER_UCN_CKPT, phase 21(a)'s weights) and the flagship
    refiner, per image and streamed."""
    return base_evaluation("ucn", "QUBER_UCN_CKPT", ckpt, root, params, frames, card,
                           "UCN (phase 21(a)'s weights)")


def ucn_zoom(state, frames, card):
    """Phase 21(d): the zoom-in wrapper on two frames, card against CPU."""
    from quber_tpu_torch.evaluation.harness import masks_to_label_image
    from quber_tpu_torch.models.ucn import UCNBaseModel

    results = {}
    for device in ("cuda", "cpu"):
        base = UCNBaseModel(params=state, zoom_in=True, device=device)
        results[device] = [base.predict(*key) for key in list(frames)[:ZOOM_FRAMES]]
    for i, (g, c) in enumerate(zip(results["cuda"], results["cpu"])):
        agree = _label_agreement(masks_to_label_image(g[0], np.zeros((H, W), np.int32)),
                                 masks_to_label_image(c[0], np.zeros((H, W), np.int32)))
        print(f"ucn-zoomin frame {i + 1}: instances card {len(g[0])} CPU {len(c[0])}, label "
              f"agreement {agree:.6f} (need >= {PANOPTIC_AGREEMENT}), card {g[2]:.3f} s, CPU "
              f"{c[2]:.3f} s on {card}")
        if len(g[0]) != len(c[0]) or agree < PANOPTIC_AGREEMENT:
            raise AssertionError("ucn-zoomin: the card and the CPU disagree")


def ucn_phase(root, params, frames, dev, card, work):
    """Phase 21: UCN on the card. Returns the launches of 21(c)'s passes."""
    ckpt, state = ucn_training(dev, card, work)
    ucn_clustering(state, frames, card)
    launches = ucn_evaluation(ckpt, root, params, frames, card)
    ucn_zoom(state, frames, card)
    return launches


def _file_configs(**train):
    from quber_tpu_torch.config import TrainConfig
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig

    # the anchor's depth range, a warm-up of two steps
    return MaskRefinerConfig(), TrainConfig(batch_size=BATCH, warmup_iters=2,
                                            depth_range=(250, 1500), **train)


def _file_state(params, model_cfg, train_cfg, dev):
    from quber_tpu_torch.models.from_jax import state_dict_from_jax
    from quber_tpu_torch.train.loop import create_train_state

    state = create_train_state(model_cfg, train_cfg, device=dev)
    state.model.load_state_dict(state_dict_from_jax(params), strict=True)
    return state


def file_device_targets(params, dev, card):
    """Phase 22(b): device-target steps from the files, SSD colour and Perlin
    on; the first batch's targets on the card against the CPU. Returns the
    launches of the steps."""
    from quber_tpu_torch.data.datasets import get_dataset
    from quber_tpu_torch.data.mappers import batch_iterator
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.train.device_targets import PackedMapper, make_device_target_step

    model_cfg, train_cfg = _file_configs()
    records = get_dataset("uoais_sim_train_panoptic")
    batches = batch_iterator(records, PackedMapper(train_cfg, model_cfg, TRAIN_SLOTS),
                             BATCH, seed=train_cfg.seed)
    t0 = time.perf_counter()
    first = torch.from_numpy(next(batches)["packed"])
    host_s = time.perf_counter() - t0
    _targets_against_cpu("phase 22(b), files with SSD colour and Perlin", first, model_cfg,
                         train_cfg, dev)
    state = _file_state(params, model_cfg, train_cfg, dev)
    step = make_device_target_step(model_cfg, train_cfg, TRAIN_SLOTS)
    kernels.reset_launch_counts()
    losses = []
    for i in range(FILE_STEPS):
        if i:
            t0 = time.perf_counter()
            bufs = torch.from_numpy(next(batches)["packed"])
            host_s += time.perf_counter() - t0
        else:
            bufs = first
        _, metrics = step(state, bufs.to(dev))
        losses.append({k: float(v) for k, v in metrics.items()})
    launches = _launch_counts()
    _train_launch_counts(f"phase 22(b): {FILE_STEPS} device-target steps from files",
                         launches, FILE_STEPS)
    totals = [round(m["total_loss"], 6) for m in losses]
    print(f"phase 22(b): {FILE_STEPS} flagship steps at batch {BATCH}, {H}x{W} from "
          f"{len(records)} UOAIS-Sim-layout records: total loss {totals}; host read + augment "
          f"+ pack {host_s / FILE_STEPS:.3f} s a batch on {card}")
    if not all(np.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError("phase 22(b): a loss is not finite")
    del state
    torch.cuda.empty_cache()
    return launches


def file_host_targets(params, dev, card):
    """Phase 22(c): host-target steps, multi-scale (min_size_train 384 and
    480): every batch one bucket, zero loss weights in every margin."""
    from quber_tpu_torch.data.datasets import get_dataset
    from quber_tpu_torch.data.mappers import (PerturbedPanopticMapper, batch_iterator,
                                              resize_shortest_edge, to_step_layout)
    from quber_tpu_torch.train.loop import make_train_step

    model_cfg, train_cfg = _file_configs(min_size_train=(384, 480))
    mapper = PerturbedPanopticMapper(train_cfg, model_cfg)
    if not mapper.multiscale:
        raise AssertionError("phase 22(c): the mapper is not multi-scale")
    batches = batch_iterator(get_dataset("uoais_sim_train_panoptic"), mapper, BATCH,
                             seed=train_cfg.seed)
    state = _file_state(params, model_cfg, train_cfg, dev)
    step = make_train_step(model_cfg)
    shapes, margins = [], []
    for i in range(2):
        batch = next(batches)
        ph, pw = batch["image"].shape[1:3]
        shapes.append((ph, pw))
        # each sample's resized extent: the non-zero rows and columns of its
        # colour image sit inside it, its weights must vanish outside
        for b in range(BATCH):
            rows = np.nonzero(batch["image"][b, :, :, :3].any(axis=(1, 2)))[0]
            cols = np.nonzero(batch["image"][b, :, :, :3].any(axis=(0, 2)))[0]
            rh, rw = rows.max() + 1, cols.max() + 1
            margins.append((ph - rh) * pw + (pw - rw) * rh)
            for key in ("sem_seg_weights", "center_weights", "offset_weights"):
                w = batch[key][b]
                if w[rh:].any() or w[:, rw:].any():
                    raise AssertionError(f"phase 22(c): {key} is not zero in the margin")
        _, metrics = step(state, to_step_layout(batch, dev))
        total = float(metrics["total_loss"])
        if not np.isfinite(total):
            raise AssertionError("phase 22(c): the loss is not finite")
        print(f"phase 22(c): host-target step {i + 1} at bucket {ph}x{pw}: total loss "
              f"{total:.6f}")
    expected = {resize_shortest_edge(H, W, s, train_cfg.max_size_train) for s in (384, 480)}
    print(f"phase 22(c): buckets {shapes} (resized shapes of the grid {sorted(expected)}), "
          f"zero weights in every margin (margin pixels per sample {sorted(set(margins))}) "
          f"on {card}")
    del state
    torch.cuda.empty_cache()


def file_workers(card):
    """Phase 22(d): two worker processes give the in-process loader's first
    batches (augmentation off)."""
    from quber_tpu_torch.data.datasets import get_dataset
    from quber_tpu_torch.data.pipeline import make_dataloader
    from quber_tpu_torch.train.device_targets import PackedMapper

    model_cfg, train_cfg = _file_configs(color_aug_ssd=False, perlin_distortion=False)
    records = get_dataset("uoais_sim_train_panoptic")
    mapper = PackedMapper(train_cfg, model_cfg, TRAIN_SLOTS)
    inline = make_dataloader(records, mapper, BATCH, seed=train_cfg.seed, worker_count=0)
    want = [next(inline)["packed"] for _ in range(2)]
    t0 = time.perf_counter()
    with make_dataloader(records, mapper, BATCH, seed=train_cfg.seed, worker_count=2) as workers:
        got = [next(workers)["packed"] for _ in range(2)]
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("phase 22(d): --workers 2 gives other batches than --workers 0")
    print(f"phase 22(d): 2 workers give the first 2 batches of the in-process loader byte for "
          f"byte ({time.perf_counter() - t0:.1f} s with the workers' start) on {card}")


def _fg_pool(root, model):
    """Phase 14's frames as (x [N, C, h, w], y [N, h, w]) through
    train_fg_torch's sample assembly (one flip draw each, seed 7)."""
    import train_fg_torch

    load = train_fg_torch.SampleCache(model)
    rng = np.random.default_rng(7)
    xs, ys = zip(*(load(p, rng) for p in train_fg_torch.list_samples(root)))
    return torch.from_numpy(np.stack(xs)).permute(0, 3, 1, 2), torch.from_numpy(np.stack(ys))


def _fg_pool_loss(model, xs, ys, dev):
    """Mean training-mode loss over the pool (batch statistics), the running
    statistics left as they were."""
    import copy

    from quber_tpu_torch.train.fg_train import weighted_ce_loss

    probe = copy.deepcopy(model).train()
    with torch.no_grad():
        return statistics.mean(
            float(weighted_ce_loss(probe(xs[i:i + BATCH].to(dev)), ys[i:i + BATCH].to(dev)))
            for i in range(0, len(xs), BATCH))


def fg_training(root, params, dev, card, work):
    """Phase 22(e): CGNet and LMFFNet trained for FG_STEPS steps each at
    batch 8 on phase 14's frames; one step on the card against the CPU; a
    saved CGNet checkpoint through $QUBER_CGNET_CKPT into a filtered frame."""
    import train_fg_torch

    from quber_tpu_torch.evaluation.base_models import GT
    from quber_tpu_torch.evaluation.datasets import build_file_lists
    from quber_tpu_torch.evaluation.refiner_models import build_refiner_model
    from quber_tpu_torch.models.cgnet import CGNet
    from quber_tpu_torch.models.from_jax import state_dict_to_jax
    from quber_tpu_torch.train.checkpoint import save_params
    from quber_tpu_torch.train.fg_train import create_fg_train_state, fg_train_step

    ckpt = os.path.join(work, "fg_cgnet")
    for name in ("cgnet", "lmffnet"):
        t0 = time.perf_counter()
        xs, ys = _fg_pool(root, name)
        read_s = time.perf_counter() - t0
        # one step from the same init on the card and on the CPU
        grads, loss = {}, {}
        for device in (dev, torch.device("cpu")):
            state = create_fg_train_state(train_fg_torch.build_model(name), seed=3,
                                          device=device)
            loss[device.type] = float(fg_train_step(state, xs[:FG_CPU_BATCH].to(device),
                                                    ys[:FG_CPU_BATCH].to(device))["loss"])
            grads[device.type] = {n: p.grad.detach().cpu().double()
                                  for n, p in state.model.named_parameters()}
        worst = min((float(torch.nn.functional.cosine_similarity(
            g.flatten(), grads["cuda"][n].flatten(), dim=0)), n) for n, g in grads["cpu"].items())
        print(f"phase 22(e): {name} one step at batch {FG_CPU_BATCH} card against CPU: loss {loss['cuda']:.6f} / "
              f"{loss['cpu']:.6f} (rtol {FG_LOSS_RTOL}), gradient cosine min {worst[0]:.6f} at "
              f"{worst[1]} (need >= {GRAD_COSINE})")
        if not abs(loss["cuda"] - loss["cpu"]) <= FG_LOSS_RTOL * abs(loss["cpu"]) \
                or worst[0] < GRAD_COSINE:
            raise AssertionError(f"phase 22(e): {name} card and CPU disagree")

        state = create_fg_train_state(train_fg_torch.build_model(name), seed=7, device=dev)
        before = _fg_pool_loss(state.model, xs, ys, dev)
        order = np.random.RandomState(7)
        times, losses = [], []
        for _ in range(FG_STEPS):
            idx = torch.from_numpy(order.permutation(len(xs))[:BATCH])
            t0 = time.perf_counter()
            losses.append(float(fg_train_step(state, xs[idx].to(dev), ys[idx].to(dev))["loss"]))
            times.append(time.perf_counter() - t0)
        after = _fg_pool_loss(state.model, xs, ys, dev)
        print(f"phase 22(e): {name} {FG_STEPS} steps at batch {BATCH}, {tuple(xs.shape[2:])}: "
              f"losses {[round(v, 4) for v in losses]}, pool loss {before:.6f} -> {after:.6f}; "
              f"{statistics.median(times[2:]) * 1e3:.1f} ms a step (median of steps 3-"
              f"{FG_STEPS}, synchronised), pool of {len(xs)} read in {read_s:.1f} s on {card}")
        if not all(np.isfinite(losses)) or not after < before:
            raise AssertionError(f"phase 22(e): {name}'s loss did not fall over the pool")
        if name == "cgnet":
            save_params(ckpt, state_dict_to_jax(state.model), step=FG_STEPS)
        del state
    os.environ["QUBER_CGNET_CKPT"] = ckpt
    os.environ.pop("QUBER_LMFFNET_CKPT", None)
    try:
        refiner = build_refiner_model("maskrefiner", "OSD", params=params, device="cuda")
        rgb, depth, _ = build_file_lists("OSD", root)
        masks = GT("OSD").predict(rgb[0], depth[0])[0]
        refined, _, _, fg = refiner.predict(rgb[0], depth[0], masks, None)
    finally:
        del os.environ["QUBER_CGNET_CKPT"]
    if not isinstance(refiner.fg_predictor.model, CGNet) or fg.shape != (H, W) \
            or fg.dtype != bool:
        raise AssertionError("phase 22(e): the saved CGNet did not filter the frame")
    print(f"phase 22(e): the saved CGNet through $QUBER_CGNET_CKPT filtered frame 1: foreground "
          f"{fg.mean():.4f} of the pixels, {len(refined)} of {len(masks)} instances kept")


def file_phase(root, params, dev, card, work):
    """Phase 22: training from files. Returns the launches of 22(b)."""
    from quber_tpu_torch.data.datasets import register_standard_datasets
    from quber_tpu_torch.data.make_uoais_sim import make

    t0 = time.perf_counter()
    data_root = os.path.join(work, "uoais")
    make(root, data_root)
    register_standard_datasets(data_root)
    print(f"phase 22(a): {EVAL_FRAMES} frames to a UOAIS-Sim panoptic set (detection2panoptic, "
          f"Felzenszwalb-seeded perturbate_masks, panoptic2eee) in "
          f"{time.perf_counter() - t0:.1f} s")
    launches = file_device_targets(params, dev, card)
    file_host_targets(params, dev, card)
    file_workers(card)
    fg_training(root, params, dev, card, work)
    return launches


_T0 = time.perf_counter()


def _zoo_models(dtype=torch.float32):
    """MSMFormer and UOAIS-Net at full width from one seeded init, in eval
    mode on the CPU: {name: model}."""
    from quber_tpu_torch.models.msmformer import MSMFormer
    from quber_tpu_torch.models.uoais_net import UOAISNet

    models = {"MSMFormer": MSMFormer(dtype=dtype), "UOAISNet": UOAISNet(dtype=dtype)}
    for model in models.values():
        model.reset_parameters(torch.Generator().manual_seed(ZOO_SEED))
        model.eval()
    return models


def _zoo_inputs():
    """One rendered 480x640 scene as each model's evaluation wrapper feeds
    it: standardised RGB and XYZ for MSMFormer, raw BGR and the normalised
    depth for UOAIS-Net ({name: (input, input)}, [1, 3, H, W] on the CPU)."""
    import train_zoo_torch as zoo

    lab = zoo.stage(zoo.make_labeled_scenes(1, H, W, ZOO_SEED, (250, 1500)), "cpu")
    det = zoo.stage(zoo.make_scenes(1, H, W, ZOO_SEED, (250, 1500)), "cpu")
    return {"MSMFormer": (lab["rgb"], lab["xyz"]), "UOAISNet": (det["rgb"], det["depth"])}


def _float_outputs(out):
    return {k: v for k, v in out.items() if torch.is_floating_point(v)}


def _forward_gaps(got, cpu):
    """({float output: max |card - CPU| over max |CPU|}, {integer output:
    equal}) of a forward on the card against the CPU's."""
    same = {k: bool(torch.equal(got[k].cpu(), v)) for k, v in cpu.items()
            if not torch.is_floating_point(v)}
    rel = {k: float((got[k].cpu() - v).nan_to_num(0, 0, 0).abs().max()
                    / v.nan_to_num(0, 0, 0).abs().max().clamp_min(1e-30))
           for k, v in _float_outputs(cpu).items()}
    return rel, same


def zoo_forwards(dev, card):
    """Phase 23(a): MSMFormer and UOAIS-Net at 480x640 from one seeded init,
    float32 (TF32 off) on the card against the CPU (UOAIS-Net's looser gate
    failed by a TF32 forward), then bfloat16 on the card (finite, its
    distance to float32 printed)."""
    inputs = _zoo_inputs()
    f32 = {}
    for name, model in _zoo_models().items():
        args = inputs[name]
        t0 = time.perf_counter()
        with torch.no_grad():
            cpu = model(*args)
            cpu_s = time.perf_counter() - t0
            model.to(dev)
            got = model(*(a.to(dev) for a in args))
        torch.cuda.synchronize()
        rel, same = _forward_gaps(got, cpu)
        finite = all(bool(torch.isfinite(v).all()) for v in _float_outputs(got).values())
        print(f"{name} at {H}x{W} float32, card against CPU: max |card - CPU| over max |CPU| "
              f"{({k: float(f'{r:.3g}') for k, r in rel.items()})} (tolerance {ZOO_RTOL[name]}); "
              f"selections equal {same}; CPU forward {cpu_s:.2f} s")
        if not finite or not all(same.values()) or max(rel.values()) > ZOO_RTOL[name]:
            raise AssertionError(f"{name}: the card and the CPU disagree on the forward")
        if ZOO_RTOL[name] > ABLATION_RTOL:  # the control: TF32 convolutions must fail the gate
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            with torch.no_grad():
                tf32 = model(*(a.to(dev) for a in args))
            torch.cuda.synchronize()
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            rel, same = _forward_gaps(tf32, cpu)
            print(f"{name} control, TF32 on the card against the CPU: max |card - CPU| over "
                  f"max |CPU| {({k: float(f'{r:.3g}') for k, r in rel.items()})}; selections "
                  f"equal {same} (must fail the tolerance {ZOO_RTOL[name]})")
            if all(same.values()) and max(rel.values()) <= ZOO_RTOL[name]:
                raise AssertionError(f"{name}: a TF32 forward passes the float32 gate")
        f32[name] = got
        del model
    for name, model in _zoo_models(torch.bfloat16).items():
        model.to(dev)
        with torch.no_grad():
            got = model(*(a.to(dev) for a in inputs[name]))
        torch.cuda.synchronize()
        dist = {k: float((v.float() - f32[name][k]).abs().mean() / f32[name][k].abs().mean())
                for k, v in _float_outputs(got).items()
                if k in ("mask_logits", "objectness", "rpn_objectness", "rpn_deltas")}
        if not all(bool(torch.isfinite(v).all()) for v in _float_outputs(got).values()):
            raise AssertionError(f"{name}: a bfloat16 output on the card is not finite")
        print(f"{name} bfloat16 on the card: finite; mean |bf16 - float32| over mean |float32| "
              f"{({k: float(f'{d:.3g}') for k, d in dist.items()})} on {card}")


def _msmformer_criterion(out, pool, scene):
    """The msmformer recipe's set loss on the CPU, on forward outputs `out`
    (on the host) against scene `scene` of the staged CPU pool, as the
    recipe's step builds its targets: {"total", each part} as floats."""
    import train_zoo_torch as zoo
    from quber_tpu_torch.models.msmformer import msmformer_set_loss

    labels = pool["labels"][scene]
    gt = (labels[::4, ::4][None] == 1 + torch.arange(zoo.SLOTS)[:, None, None]).float()
    parts = msmformer_set_loss(out, gt[None], pool["valid"][scene][None])
    return {"total": float(sum(parts.values())), **{k: float(v) for k, v in parts.items()}}


def zoo_training(dev, card, work):
    """Phase 23(b): train_zoo_torch's msmformer and uoaisnet steps at
    480x640 on two rendered scenes, card against CPU from the same init in
    float32 (MSMFormer's recipe runs bfloat16, whose roundings differ
    between the card's and the CPU's kernels by ~1e-3 of the loss); then the
    recipes' own steps on the card alone, timed, the weights saved as
    train_zoo_torch saves them. Returns {model: the checkpoint directory
    that 23(c) evaluates} (MSMFormer's with its objectness bias raised by
    ZOO_OBJECTNESS_SHIFT and its per-pixel largest mask logit's median
    moved to 0, UOAIS-Net's with its RPN and box deltas zeroed and its
    visible masks' median logit moved to 0)."""
    import train_zoo_torch as zoo
    from quber_tpu_torch.models.from_jax import state_dict_to_jax
    from quber_tpu_torch.train.checkpoint import save_params

    ckpts = {}
    for name in ("msmformer", "uoaisnet"):
        make_pool, make_model, make_step = zoo.RECIPES[name]
        t0 = time.perf_counter()
        scenes = make_pool(ZOO_POOL, H, W, 7, (250, 1500))
        render_s = time.perf_counter() - t0
        f32 = {"dtype": torch.float32} if name == "msmformer" else {}
        runs = {}
        for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
            model, optimizer = make_model(7, UCN_LR, device, **f32)
            runs[key] = {"model": model, "opt": optimizer, "step": make_step(model, optimizer),
                         "pool": zoo.stage(scenes, device), "losses": [], "s": 0.0}
        card_out, criterion = {}, []
        if name == "msmformer":  # the card's forward outputs of each step, on the host
            runs["card"]["model"].register_forward_hook(lambda mod, args, out: card_out.update(
                {k: v.detach().cpu() for k, v in out.items()}))
        for i in range(ZOO_CPU_STEPS):
            if i:  # each later step from the CPU's own state, as the CPU tests take it
                runs["card"]["model"].load_state_dict(runs["cpu"]["model"].state_dict())
                runs["card"]["opt"].load_state_dict(runs["cpu"]["opt"].state_dict())
            for run in runs.values():
                t1 = time.perf_counter()
                loss, parts = run["step"](run["pool"], i % ZOO_POOL)
                run["losses"].append({"total": float(loss),
                                      **{k: float(v) for k, v in parts.items()}})
                run["s"] += time.perf_counter() - t1
                if i == 0:
                    run["grads"] = {n: p.grad.detach().cpu().double()
                                    for n, p in run["model"].named_parameters()
                                    if p.grad is not None}
            if card_out:
                criterion.append(_msmformer_criterion(card_out, runs["cpu"]["pool"],
                                                      i % ZOO_POOL))
        loss_gpu, grad_gpu = runs["card"]["losses"], runs["card"]["grads"]
        loss_cpu, grad_cpu, cpu_s = runs["cpu"]["losses"], runs["cpu"]["grads"], runs["cpu"]["s"]
        pool = runs["card"]["pool"]
        del runs
        norm = {n: float(g.norm()) for n, g in grad_cpu.items()}
        top = max(norm.values())
        # a gradient that is zero on both or float noise beside the largest
        # is not compared
        cos = min((float(torch.nn.functional.cosine_similarity(
            g.flatten(), grad_gpu[n].flatten(), dim=0)), n)
            for n, g in grad_cpu.items() if norm[n] > ZERO_GRAD_SHARE * top)
        gaps = [{k: float(f"{abs(a[k] - b[k]) / max(abs(b[k]), 1e-12):.3g}") for k in b}
                for a, b in zip(loss_gpu, loss_cpu)]
        print(f"{name}, {ZOO_CPU_STEPS} train_zoo_torch steps at {H}x{W} in float32 card against "
              f"CPU: total losses card {[a['total'] for a in loss_gpu]} cpu "
              f"{[b['total'] for b in loss_cpu]}, relative gaps by part {gaps} (rtol "
              f"{CPU_LOSS_RTOL}); first "
              f"gradient cosine min {cos[0]:.6f} at {cos[1]} (need >= {GRAD_COSINE}); CPU steps "
              f"{cpu_s:.1f} s; scenes rendered in {render_s:.1f} s")
        for i, (a, b) in enumerate(zip(loss_gpu, loss_cpu)):
            # after a step MSMFormer's masks saturate and queries tie on the
            # matching cost; a forward's last bits decide which tied query
            # takes a target, which moves the mask loss (and so the total)
            # but not the dice and objectness losses of the tied queries
            # (tests/test_torch_zoo_train_msmformer.py)
            gated = [k for k in b if not (i and name == "msmformer" and k in ("total", "loss_mask"))]
            if not all(abs(a[k] - b[k]) <= CPU_LOSS_RTOL * abs(b[k]) + 1e-6 for k in gated):
                raise AssertionError(f"{name}: the card and the CPU disagree on a loss")
        if criterion:
            # the card's criterion, its mask loss included, on the card's own
            # forward against the CPU's criterion on the same outputs
            gaps = [{k: float(f"{abs(a[k] - b[k]) / max(abs(b[k]), 1e-12):.3g}") for k in b}
                    for a, b in zip(loss_gpu, criterion)]
            print(f"{name}: the CPU's criterion on the card's forward outputs, total "
                  f"{[b['total'] for b in criterion]}, relative gaps of the card's losses by "
                  f"part {gaps} (rtol {CPU_LOSS_RTOL})")
            if not all(abs(a[k] - b[k]) <= CPU_LOSS_RTOL * abs(b[k]) + 1e-6
                       for a, b in zip(loss_gpu, criterion) for k in b):
                raise AssertionError(f"{name}: the card's criterion disagrees with the CPU's")
        if cos[0] < GRAD_COSINE:
            raise AssertionError(f"{name}: the card and the CPU disagree on a gradient")
        model, optimizer = make_model(7, UCN_LR, dev)
        step = make_step(model, optimizer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for i in range(ZOO_CARD_STEPS):
            t0 = time.perf_counter()
            loss, _ = step(pool, i % ZOO_POOL)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"{name} train step on the card ({next(model.parameters()).dtype} weights, "
              f"{model.dtype} compute): {statistics.median(times):.3f} ms median of "
              f"{ZOO_CARD_STEPS} (batch 1, {H}x{W}), first {times[0]:.1f} ms, loss "
              f"{float(loss):.4f}, peak {peak:.3f} GiB on {card}")
        if not np.isfinite(float(loss)):
            raise AssertionError(f"{name}: a loss on the card is not finite")
        ckpts[name] = os.path.join(work, name, "ckpt")
        save_params(ckpts[name], state_dict_to_jax(model), step=ZOO_CARD_STEPS)
        if name == "msmformer":  # the copy that 23(c) evaluates: every query accepted,
            # and the mask logits moved by one constant (channel 0 of the mask
            # features made 1, of every mask embedding the shift): half the
            # pixels of a training scene above 0.5, whatever the 40 steps left
            with torch.no_grad():
                model.objectness.bias += ZOO_OBJECTNESS_SHIFT
                model.mask_features.norm.weight[0], model.mask_features.norm.bias[0] = 0.0, 1.0
                model.mask_embed.weight[0], model.mask_embed.bias[0] = 0.0, 0.0
                out = model(pool["rgb"][0][None], pool["xyz"][0][None])
                shift = -float(out["mask_logits"][0].amax(0).median())
                model.mask_embed.bias[0] = shift
            print(f"msmformer: the evaluated copy's mask logits moved by {shift:.4f}, the "
                  f"negated median of a training scene's per-pixel largest")
            ckpts[name] = os.path.join(work, name, "eval_ckpt")
            save_params(ckpts[name], state_dict_to_jax(model), step=ZOO_CARD_STEPS)
        if name == "uoaisnet":  # the copy that 23(c) evaluates: masks that cover pixels
            with torch.no_grad():
                # the detections' boxes as their anchors: the 40 steps leave box
                # deltas that clip most boxes to no area (a CPU run of the same
                # steps: every detection of the 16 anchor frames), and a mask
                # is pasted only inside its box
                for layer in (model.rpn.deltas, model.box_deltas):
                    layer.weight.zero_()
                    layer.bias.zero_()
                out = model(pool["rgb"][0][None], pool["depth"][0][None])
                shift = -float(out["visible_masks"][out["valid"]].median())
                model.visible_head.predictor.bias += shift
            print(f"uoaisnet: the evaluated copy's box deltas zeroed and its visible-mask bias "
                  f"raised by {shift:.4f}, the negated median logit of its "
                  f"{int(out['valid'].sum())} detections on a training scene")
            ckpts[name] = os.path.join(work, name, "eval_ckpt")
            save_params(ckpts[name], state_dict_to_jax(model), step=ZOO_CARD_STEPS)
        del model, optimizer, step, pool
        torch.cuda.empty_cache()
    return ckpts


def _mask_parity(label, pairs, card, seconds=None):
    """(card masks, CPU masks) pairs of frames: the same count and >= 99.5%
    of the labels each; `seconds` (card, CPU) pairs are printed beside."""
    from quber_tpu_torch.evaluation.harness import masks_to_label_image

    for i, (g, c) in enumerate(pairs):
        agree = _label_agreement(masks_to_label_image(g, np.zeros((H, W), np.int32)),
                                 masks_to_label_image(c, np.zeros((H, W), np.int32)))
        times = f", card {seconds[i][0]:.3f} s, CPU {seconds[i][1]:.3f} s" if seconds else ""
        print(f"{label} frame {i + 1}: masks card {len(g)} CPU {len(c)} (with a pixel "
              f"{_segmented(g)} / {_segmented(c)}), label agreement {agree:.6f} (need >= "
              f"{PANOPTIC_AGREEMENT}){times} on {card}")
        if len(g) != len(c) or agree < PANOPTIC_AGREEMENT:
            raise AssertionError(f"{label}: the card and the CPU disagree")


def _wrapper_parity(label, make, keys, card):
    """A base-model wrapper on the card against the CPU on `keys` (frames):
    the same count and >= 99.5% of the labels, some mask with a pixel."""
    results = {}
    for device in ("cuda", "cpu"):
        base = make(device)
        results[device] = [base.predict(*key) for key in keys]
        del base
    _mask_parity(label, [(g[0], c[0]) for g, c in zip(results["cuda"], results["cpu"])], card,
                 [(g[2], c[2]) for g, c in zip(results["cuda"], results["cpu"])])
    if not sum(_segmented(g[0]) for g in results["cuda"]):
        raise AssertionError(f"{label}: the wrapper segmented no pixel")


def _segmenting_frames(label, make, keys, n):
    """The first `n` of `keys` on which the wrapper on the card keeps a mask
    with a pixel, so that a parity check compares masks and not two empty
    frames; fails if fewer than `n` do."""
    base = make("cuda")
    found = []
    for i, key in enumerate(keys):
        if _segmented(base.predict(*key)[0]):
            found.append((i + 1, key))
            if len(found) == n:
                break
    del base
    print(f"{label}: anchor frames {[i for i, _ in found]} of {len(keys)} are the first with a "
          f"mask holding a pixel on the card")
    if len(found) < n:
        raise AssertionError(f"{label}: the wrapper segmented no pixel on {len(keys)} frames")
    return [key for _, key in found]


def zoo_rest(frames, dev, card):
    """Phase 23(d): msmformer-zoomin on two frames and msmformer-pretrained
    and uoaisnet-pretrained on one, at random inits with the twins' class
    and mask biases moved, card against CPU; the ms a frame of nms_fixed at
    1000 boxes."""
    from quber_tpu_torch.models.msmformer import MSMFormerBaseModel
    from quber_tpu_torch.models.msmformer_pretrained import PretrainedMSMFormerBaseModel
    from quber_tpu_torch.models.uoais_net_pretrained import UOAISNetPretrainedBaseModel
    from quber_tpu_torch.ops.boxes import nms_fixed

    from quber_tpu_torch.models.msmformer import set_compute_dtype

    keys = list(frames)

    def zoomin(device):
        # the wrapper's seed-0 init (no checkpoint), which finds instances on
        # these frames, with its float32 model: at a random init the queries'
        # bfloat16 scores lie within a rounding of each other, and the card's
        # and the CPU's bfloat16 kernels round in other places
        # and the CPU's bfloat16 kernels round in other places. The crop
        # stage is a copy with every query accepted: at this init no query
        # of a crop passes 0.5 and the refined masks would be empty
        base = MSMFormerBaseModel(zoom_in=True, device=device)
        set_compute_dtype(base.model, torch.float32)
        base.model.dtype = torch.float32
        base.model_crop = copy.deepcopy(base.model)
        with torch.no_grad():
            base.model_crop.objectness.bias += ZOO_OBJECTNESS_SHIFT
        return base

    _wrapper_parity("msmformer-zoomin, seed-0 init, float32, crop stage every query",
                    zoomin, keys[:ZOOM_FRAMES], card)
    # the twins' class and mask biases moved as the CPU tests move them, so
    # that the wrappers keep detections; UOAIS-Net from torch's default init
    # (seeded), whose box deltas leave boxes that are not empty, as the
    # synthesised reference state of tests/test_uoais_pretrained.py does
    msm = PretrainedMSMFormerBaseModel(device="cpu").model
    with torch.no_grad():
        msm.predictor.class_embed.bias[1] += MSM_CLASS_SHIFT
    msm = msm.state_dict()
    uoais = UOAISNetPretrainedBaseModel(device="cpu").model
    torch.manual_seed(ZOO_SEED)
    with torch.no_grad():
        for mod in uoais.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                mod.reset_parameters()
        uoais.cls_score.bias[0] += UOAIS_CLASS_SHIFT
        uoais.visible_mask_head.predictor.conv.bias[0] += UOAIS_MASK_SHIFT
    uoais = uoais.state_dict()
    _wrapper_parity("msmformer-pretrained, random init, class bias moved",
                    lambda d: PretrainedMSMFormerBaseModel(params=msm, device=d), keys[:1], card)
    _wrapper_parity("uoaisnet-pretrained, seeded init, class and mask biases moved",
                    lambda d: UOAISNetPretrainedBaseModel(params=uoais, device=d), keys[:1], card)
    g = torch.Generator().manual_seed(ZOO_SEED)
    xy = torch.rand(NMS_BOXES, 2, generator=g) * torch.tensor([W, H])
    wh = torch.rand(NMS_BOXES, 2, generator=g) * 120 + 8
    boxes = torch.cat([xy, xy + wh], dim=1).to(dev)
    scores = torch.rand(NMS_BOXES, generator=g).to(dev)
    keep_cpu = nms_fixed(boxes.cpu(), scores.cpu(), 0.7)
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep = nms_fixed(boxes, scores, 0.7)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(keep.cpu(), keep_cpu):
        raise AssertionError("nms_fixed: the card and the CPU keep other boxes")
    print(f"nms_fixed at {NMS_BOXES} boxes (IoU 0.7, {int(keep.sum())} kept, equal to the CPU's): "
          f"{statistics.median(times):.3f} ms median of 20 (host clock around the call, its "
          f"one device-to-host copy included) on {card}")


def zoo_phase(root, params, frames, dev, card, work):
    """Phase 23: the MSMFormer and UOAIS-Net base segmenters on the card.
    Returns {base: the launches of 23(c)'s passes}."""
    zoo_forwards(dev, card)
    torch.cuda.empty_cache()
    ckpts = zoo_training(dev, card, work)
    launches = {}
    os.environ["QUBER_UOAISNET_THRESH"] = ZOO_UOAISNET_THRESH
    for base, env, label in (
            ("msmformer", "QUBER_MSMFORMER_NATIVE_CKPT",
             f"msmformer (phase 23(b)'s weights, objectness bias +{ZOO_OBJECTNESS_SHIFT})"),
            ("uoaisnet", "QUBER_UOAISNET_CKPT",
             f"uoaisnet (phase 23(b)'s weights, score threshold {ZOO_UOAISNET_THRESH})")):
        launches[base] = base_evaluation(base, env, ckpts[base], root, params, frames, card,
                                         label)
        base_device_seconds(base, frames, card)
        torch.cuda.empty_cache()
    del os.environ["QUBER_UOAISNET_THRESH"]
    zoo_rest(frames, dev, card)
    return launches


def _zoo2_inputs():
    """Phase 24(a)'s models (float32, from ZOO2_SEED, eval mode, on the CPU)
    and their inputs at the wrappers' shapes: {name: (model, inputs)}."""
    import train_zoo_torch as zoo
    from quber_tpu_torch.models.cascadepsp import PSPNetUOAIS
    from quber_tpu_torch.models.rice import NodeScorer, hypothesis_node_crops
    from quber_tpu_torch.models.uois_net import DepthSeedingNetwork, RegionRefinementNetwork
    from quber_tpu_torch.models.uois_net_pretrained import PretrainedDSN, PretrainedRRN
    from quber_tpu_torch.ops.boxes import roi_align, roi_align_each
    from quber_tpu_torch.ops.zoom import instance_boxes_from_labels

    lab = zoo.stage(zoo.make_labeled_scenes(1, H, W, ZOO2_SEED, (250, 1500)), "cpu")
    rgb, xyz, labels = lab["rgb"][0], lab["xyz"][0], lab["labels"][0]
    mask = (labels == 1).float()
    boxes, _ = instance_boxes_from_labels(labels, 2, pad_ratio=0.25)
    crops = torch.cat([roi_align(rgb, boxes, out_size=224),
                       (roi_align_each((labels[None] == torch.tensor([[[1]], [[2]]])).float(),
                                       boxes, 224) > 0.5).float()[:, None]], dim=1)
    psp = zoo.stage(zoo.make_refine_crops(2, H, W, ZOO2_SEED, (250, 1500)), "cpu")
    rice = zoo.stage(zoo.make_rice_scenes(1, H, W, ZOO2_SEED, (250, 1500)), "cpu")
    nodes, _ = hypothesis_node_crops(rice["image6"][0], rice["good"][0] > 0, rice["gvalid"][0])
    out = {
        "uoisnet3d DSN": (DepthSeedingNetwork(), (xyz[None],)),
        "uoisnet3d RRN": (RegionRefinementNetwork(), (torch.cat([rgb, mask[None]])[None],)),
        "released DSN": (PretrainedDSN(), (xyz[None],)),
        "released RRN": (PretrainedRRN(), (crops,)),
        "PSPNetUOAIS": (PSPNetUOAIS(), (psp["rgbd"][:, :3], psp["rgbd"][:, 3:4],
                                        (psp["seg"][:, None] - 0.5) / 0.5)),
        "NodeScorer": (NodeScorer(), (nodes,)),
    }
    for model, _ in out.values():
        model.reset_parameters(torch.Generator().manual_seed(ZOO2_SEED))
        model.eval()
    return out


def _as_dict(out):
    if isinstance(out, dict):
        return out
    return {f"out{i}": o for i, o in enumerate(out if isinstance(out, tuple) else (out,))}


def zoo2_forwards(dev, card):
    """Phase 24(a): each model of the slice at its wrapper's shapes, float32
    (TF32 off) on the card against the CPU, then the UOIS-Net-3D nets in
    bfloat16 on the card (finite, the distance to float32 printed)."""
    from quber_tpu_torch.models.layers import set_compute_dtype
    from quber_tpu_torch.models.uois_net_pretrained import set_dtype

    for name, (model, args) in _zoo2_inputs().items():
        t0 = time.perf_counter()
        with torch.no_grad():
            cpu = _as_dict(model(*args))
            cpu_s = time.perf_counter() - t0
            model.to(dev)
            got = _as_dict(model(*(a.to(dev) for a in args)))
        torch.cuda.synchronize()
        rel, _ = _forward_gaps(got, cpu)
        finite = all(bool(torch.isfinite(v).all()) for v in got.values())
        shapes = [tuple(a.shape) for a in args]
        print(f"{name} {shapes} float32, card against CPU: max |card - CPU| over max |CPU| "
              f"{({k: float(f'{r:.3g}') for k, r in rel.items()})} (tolerance "
              f"{ZOO2_RTOL[name]}); CPU forward {cpu_s:.2f} s")
        if not finite or max(rel.values()) > ZOO2_RTOL[name]:
            raise AssertionError(f"{name}: the card and the CPU disagree on the forward")
        if name.startswith(("uoisnet3d", "released")):
            (set_compute_dtype if name.startswith("uoisnet3d") else set_dtype)(model, torch.bfloat16)
            with torch.no_grad():
                bf16 = _as_dict(model(*(a.to(dev) for a in args)))
            torch.cuda.synchronize()
            if not all(bool(torch.isfinite(v).all()) for v in bf16.values()):
                raise AssertionError(f"{name}: a bfloat16 output on the card is not finite")
            dist = {k: float(f"{float((v.float() - got[k]).abs().mean() / got[k].abs().mean()):.3g}")
                    for k, v in bf16.items()}
            print(f"{name} bfloat16 on the card: finite; mean |bf16 - float32| over mean "
                  f"|float32| {dist} on {card}")
        del model
        torch.cuda.empty_cache()


OPEN_VOCAB_RECIPES = ("detic", "gsam")  # their detector runs bfloat16


def _zoo2_recipe(name, seed, device):
    """(model, optimizer, step) of train_zoo_torch's recipe `name`, its own
    draws from `seed` (the command line's)."""
    import train_zoo_torch as zoo

    _, make_model, make_step = zoo.RECIPES[name]
    model, optimizer = make_model(seed, UCN_LR, device)
    opts = {"uoisnet3d": {"generator": torch.Generator(device).manual_seed(seed)},
            "cascadepsp": {"size": ZOO2_CROPS, "seed": seed},
            "gsam": {"size": ZOO_POOL, "seed": seed}}.get(name, {})
    return model, optimizer, make_step(model, optimizer, **opts)


def zoo2_training(dev, card, work, names=("uoisnet3d", "cascadepsp", "rice")):
    """Phase 24(b) (and 25(b), `names` ("samhq",), and 26(b), ("detic",
    "gsam")): train_zoo_torch's recipes' steps, card against CPU from the
    same init with the draws handed over (the second step from the CPU's
    state; the open-vocabulary recipes' detector in float32, their own runs
    bfloat16), then 40 of each recipe's own steps on the card, timed, the
    weights saved as train_zoo_torch saves them. Returns {recipe:
    {checkpoint directory name: path}}; the open-vocabulary recipes' also
    name their evaluated copy ("eval")."""
    import train_zoo_torch as zoo
    from quber_tpu_torch.models.layers import set_compute_dtype
    from quber_tpu_torch.train.checkpoint import save_params

    ckpts = {}
    for name in names:
        make_pool = zoo.RECIPES[name][0]
        n_pool = ZOO2_CROPS if name == "cascadepsp" else ZOO_POOL
        t0 = time.perf_counter()
        scenes = make_pool(n_pool, H, W, 7, (250, 1500))
        # cascadepsp's steps against the CPU on crops of half the side (a CPU
        # step at 224x224 takes ~15 s); the timed steps below take the recipe's
        small = zoo.make_refine_crops(n_pool, H, W, 7, (250, 1500), crop=ZOO2_CPU_CROP) \
            if name == "cascadepsp" else scenes
        render_s = time.perf_counter() - t0
        runs = {}
        for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
            model, optimizer, step = _zoo2_recipe(name, 7, device)
            if name in OPEN_VOCAB_RECIPES:  # held against the CPU in float32
                set_compute_dtype(model["detector" if name == "detic" else "grounder"],
                                  torch.float32)
            runs[key] = {"model": model, "opt": optimizer, "step": step,
                         "pool": zoo.stage(small, device), "losses": [], "s": 0.0}
        draw_g = torch.Generator().manual_seed(ZOO2_SEED)
        batch_rng = np.random.default_rng(ZOO2_SEED)
        for i in range(ZOO_CPU_STEPS):
            if i:
                runs["card"]["model"].load_state_dict(runs["cpu"]["model"].state_dict())
                runs["card"]["opt"].load_state_dict(runs["cpu"]["opt"].state_dict())
            scene = i % n_pool
            extra = {}
            if name == "uoisnet3d":  # one set of draws, on the CPU, for both
                pool = runs["cpu"]["pool"]
                extra = {"draws": zoo.draw_uoisnet3d(pool["labels"][scene], pool["valid"][scene],
                                                     draw_g)}
            elif name == "cascadepsp":
                extra = {"batch": batch_rng.integers(0, n_pool, zoo.CASCADEPSP_BATCH - 1).tolist()
                         + [scene]}
            elif name == "gsam":
                extra = {"sam_scene": (i + 1) % n_pool}
            for key, run in runs.items():
                kw = dict(extra)
                if "draws" in kw and key == "card":
                    kw["draws"] = {k: v.to(dev) if torch.is_tensor(v) else v
                                   for k, v in kw["draws"].items()}
                t1 = time.perf_counter()
                loss, parts = run["step"](run["pool"], scene, **kw)
                run["losses"].append({"total": float(loss),
                                      **{k: float(v) for k, v in parts.items()}})
                run["s"] += time.perf_counter() - t1
                if i == 0:
                    run["grads"] = {n: p.grad.detach().cpu().double()
                                    for n, p in run["model"].named_parameters()
                                    if p.grad is not None}
        loss_gpu, grad_gpu = runs["card"]["losses"], runs["card"]["grads"]
        loss_cpu, grad_cpu, cpu_s = runs["cpu"]["losses"], runs["cpu"]["grads"], runs["cpu"]["s"]
        del runs
        pool = zoo.stage(scenes, dev)
        norm = {n: float(g.norm()) for n, g in grad_cpu.items()}
        top = max(norm.values())
        cos = min((float(torch.nn.functional.cosine_similarity(
            g.flatten(), grad_gpu[n].flatten(), dim=0)), n)
            for n, g in grad_cpu.items() if norm[n] > ZERO_GRAD_SHARE * top)
        gaps = [{k: float(f"{abs(a[k] - b[k]) / max(abs(b[k]), 1e-12):.3g}") for k in b}
                for a, b in zip(loss_gpu, loss_cpu)]
        shape = (f"{ZOO2_CPU_CROP}x{ZOO2_CPU_CROP} crops, batch {zoo.CASCADEPSP_BATCH}"
                 if name == "cascadepsp" else f"{H}x{W} scenes")
        print(f"{name}, {ZOO_CPU_STEPS} train_zoo_torch steps on {shape} card against CPU (draws "
              f"handed over): total losses card {[a['total'] for a in loss_gpu]} cpu "
              f"{[b['total'] for b in loss_cpu]}, relative gaps by part {gaps} (rtol "
              f"{CPU_LOSS_RTOL}); first gradient cosine min {cos[0]:.6f} at {cos[1]} (need >= "
              f"{GRAD_COSINE}); CPU steps {cpu_s:.1f} s; pool made in {render_s:.1f} s")
        if not all(abs(a[k] - b[k]) <= CPU_LOSS_RTOL * abs(b[k]) + 1e-6
                   for a, b in zip(loss_gpu, loss_cpu) for k in b):
            raise AssertionError(f"{name}: the card and the CPU disagree on a loss")
        if cos[0] < GRAD_COSINE:
            raise AssertionError(f"{name}: the card and the CPU disagree on a gradient")
        model, optimizer, step = _zoo2_recipe(name, 7, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for i in range(ZOO_CARD_STEPS):
            t0 = time.perf_counter()
            loss, _ = step(pool, i % n_pool)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        kind = "bfloat16 detector" if name in OPEN_VOCAB_RECIPES else "float32"
        print(f"{name} train step on the card ({kind}): {statistics.median(times):.3f} ms median "
              f"of {ZOO_CARD_STEPS} ({'batch 4, 224x224 crops' if name == 'cascadepsp' else f'one {H}x{W} scene'}), "
              f"first {times[0]:.1f} ms, loss {float(loss):.4f}, peak {peak:.3f} GiB on {card}")
        if not np.isfinite(float(loss)):
            raise AssertionError(f"{name}: a loss on the card is not finite")
        args = type("Args", (), {"model": name, "output_dir": os.path.join(work, name)})
        ckpts[name] = {}
        for dirname, module in zoo.saved_modules(args, model).items():
            ckpts[name][dirname] = os.path.join(work, name, dirname)
            save_params(ckpts[name][dirname], zoo.jax_tree(module), step=ZOO_CARD_STEPS)
        zoo.write_sidecars(args)
        if name == "uoisnet3d":
            ckpts[name] = _uoisnet3d_eval_copy(model, pool, work)
        if name == "cascadepsp":
            ckpts[name] = _cascadepsp_eval_copy(model, pool, ckpts[name], work)
        if name in OPEN_VOCAB_RECIPES:
            ckpts[name]["eval"] = _openvocab_eval_copy(name, model, pool, work)
        del model, optimizer, step, pool
        torch.cuda.empty_cache()
    return ckpts


def _uoisnet3d_eval_copy(model, pool, work):
    """The weights 24(c) evaluates: (b)'s with the DSN's offset rows zeroed
    (the votes are the cloud itself), its foreground bias moved by the
    median margin of a training scene's pixels and the RRN's bias by the
    median refinement logit inside the largest closed mask. After 40 steps
    the DSN's foreground lies at the edge of its argmax: the steps are not
    deterministic on the card, and from run to run the wrapper kept one
    instance or none on the first anchor frames, float32 and bfloat16
    apart."""
    from quber_tpu_torch.models.from_jax import state_dict_to_jax
    from quber_tpu_torch.models.uois_net import UOISNet3DBaseModel, open_close
    from quber_tpu_torch.ops.meanshift import cluster_points_euclidean
    from quber_tpu_torch.train.checkpoint import save_params

    def segments(dsn, rrn):
        base = UOISNet3DBaseModel(dsn.state_dict(), rrn.state_dict(), device=pool["rgb"].device)
        refined, n = base.segment(pool["rgb"][0], pool["xyz"][0])
        return int(n), int(refined.sum())

    n, pixels = segments(model.dsn, model.rrn)
    print(f"uoisnet3d after {ZOO_CARD_STEPS} steps on a training scene: {n} instances, "
          f"{pixels} refined pixels")
    with torch.no_grad():
        xyz = pool["xyz"][0]
        head = model.dsn.unet.head
        head.weight[2:], head.bias[2:] = 0.0, 0.0  # the votes are the cloud itself
        fg_logits, _ = model.dsn(xyz[None])
        margin = fg_logits[0, 1] - fg_logits[0, 0]
        head.bias[1] -= float(margin.median())
        fg = (margin > margin.median()).float()
        labels = cluster_points_euclidean(xyz.permute(1, 2, 0), fg)["labels"]
        ids = torch.arange(1, 33, device=labels.device)
        closed = open_close((labels[None] == ids[:, None, None]).float(), 1)
        slot = int(closed.flatten(1).sum(1).argmax())
        logit = model.rrn(torch.cat([pool["rgb"][0], closed[slot][None]])[None])[0, 0]
        model.rrn.unet.head.bias[0] -= float(logit[closed[slot] > 0].median())
    n, pixels = segments(model.dsn, model.rrn)
    print(f"uoisnet3d: the evaluated copy's foreground bias and refinement bias moved by the "
          f"medians of a training scene: {n} instances, {pixels} refined pixels there")
    out = {}
    for dirname, module in (("ckpt_dsn", model.dsn), ("ckpt_rrn", model.rrn)):
        out[dirname] = os.path.join(work, "uoisnet3d_eval", dirname)
        save_params(out[dirname], state_dict_to_jax(module), step=ZOO_CARD_STEPS)
    return out


def _cascadepsp_eval_copy(model, pool, ckpts, work):
    """The weights 24(c) evaluates: (b)'s, unless their final prediction on
    the pool's first crop holds no pixel above 0.5; then a copy with the
    final bias moved by the median logit there."""
    from quber_tpu_torch.models.from_jax import state_dict_to_jax
    from quber_tpu_torch.train.checkpoint import save_params

    with torch.no_grad():
        rgbd, seg = pool["rgbd"][:1], (pool["seg"][:1, None] - 0.5) / 0.5
        logit = model(rgbd[:, :3], rgbd[:, 3:4], seg)["out_224"]
        pixels = int((logit > 0).sum())
        print(f"cascadepsp after {ZOO_CARD_STEPS} steps: {pixels} pixels above 0.5 on a "
              f"training crop")
        if pixels:
            return ckpts
        shift = float(logit.median())
        model.final_21.bias -= shift
    print(f"cascadepsp: the evaluated copy's final bias moved by {-shift:.4f}, the negated "
          f"median logit of a training crop")
    out = {"ckpt": os.path.join(work, "cascadepsp_eval", "ckpt")}
    save_params(out["ckpt"], state_dict_to_jax(model), step=ZOO_CARD_STEPS)
    return out


class _Timed:
    """A refiner for run_eval that records each frame's key, initial and
    refined masks and the wrapper's own seconds."""

    def __init__(self, inner):
        self.inner, self.records = inner, []

    def predict(self, rgb_path, depth_path, initial_masks, fg_mask, **kw):
        out = self.inner.predict(rgb_path, depth_path, initial_masks, fg_mask, **kw)
        self.records.append(((rgb_path, depth_path), initial_masks, out[0], out[2]))
        return out


class _Replaying(_Timed):
    """A zoo refiner for run_eval (_Timed) that reads its frames from
    `frames` (as phase 14 read them)."""

    def __init__(self, inner, frames):
        super().__init__(inner)
        inner._load = lambda rgb_path, depth_path: frames[rgb_path, depth_path]


def zoo2_refiners(root, frames, ckpts, card):
    """Phase 24(c)'s refiners: phase 14's frames through perturbed-gt ->
    cascadepsp and -> rice (greedy), card against CPU on ZOO2_CPU_FRAMES
    frames, rice CEM on two frames with the CPU's noise handed over."""
    from quber_tpu_torch.evaluation.harness import run_eval
    from quber_tpu_torch.models.cascadepsp import CascadePSPRefiner
    from quber_tpu_torch.models.rice import RICERefiner, draw_cem_noise
    from quber_tpu_torch.train.checkpoint import load_eval_params

    weights = {"cascadepsp": load_eval_params(ckpts["cascadepsp"]["ckpt"]),
               "rice": load_eval_params(ckpts["rice"]["ckpt"])}
    make = {"cascadepsp": lambda d: CascadePSPRefiner(weights["cascadepsp"], device=d),
            "rice": lambda d: RICERefiner(weights["rice"], search="greedy", device=d)}
    for name in ("cascadepsp", "rice"):
        refiner = _Replaying(make[name]("cuda"), frames)
        t0 = time.perf_counter()
        res = run_eval(base_model="perturbed-gt", refiner_model=refiner, test_dataset="OSD",
                       dataset_path=root, device="cuda",
                       csv_path=os.path.join(os.path.dirname(root), f"eval_{name}", "eval.csv"))
        wall = time.perf_counter() - t0
        means = {s: {k: round(res[s][k], 6) for k in ("Objects F-measure", "Boundary F-measure")}
                 for s in ("initial", "refined")}
        seconds = [r[3] for r in refiner.records]
        print(f"perturbed-gt -> {name} ({'greedy, ' if name == 'rice' else ''}phase 24(b)'s "
              f"weights), {len(seconds)} frames: masks per frame "
              f"{[len(r[2]) for r in refiner.records]}, means {means}; the wrapper's device "
              f"seconds a frame median {statistics.median(seconds[1:]):.4f} (frame 1: "
              f"{seconds[0]:.3f}); pass wall {wall:.2f} s on {card}")
        if len(seconds) != EVAL_FRAMES:
            raise AssertionError(f"{name}: run_eval did not refine every frame")
        cpu = _Replaying(make[name]("cpu"), frames)
        pairs = []
        for key, initial, got, _ in refiner.records[:ZOO2_CPU_FRAMES]:
            pairs.append((got, cpu.predict(*key, initial, None)[0]))
        _mask_parity(f"perturbed-gt -> {name}, card against CPU", pairs, card)
        if name == "rice":
            pairs, seconds = [], []
            for i, (key, initial, _, _) in enumerate(refiner.records[:2]):
                noise = draw_cem_noise(torch.Generator().manual_seed(ZOO2_SEED + i),
                                       RICERefiner.MAX_INST, RICERefiner.CEM_ROUNDS,
                                       RICERefiner.SAMPLES, RICERefiner.DEPTH)
                for r in (refiner, cpu):
                    r.inner.search_mode = "cem"
                out = refiner.inner.predict(*key, initial, None,
                                            noise={k: v.cuda() for k, v in noise.items()})
                seconds.append(out[2])
                pairs.append((out[0], cpu.inner.predict(*key, initial, None, noise=noise)[0]))
            _mask_parity("perturbed-gt -> rice CEM (the CPU's noise), card against CPU", pairs,
                         card)
            print(f"rice CEM: the wrapper's device seconds a frame {[round(t, 4) for t in seconds]} "
                  f"on {card}")
        del refiner, cpu
        torch.cuda.empty_cache()


def zoo2_bases(frames, ckpts, card):
    """Phase 24(c)'s uoisnet3d (its float32 models) and 24(d)'s
    uoisnet3d-pretrained at its random init (centre head zeroed, object
    class taking every pixel, float32), card against CPU on the first
    anchor frames the card segments."""
    from quber_tpu_torch.models.layers import set_compute_dtype
    from quber_tpu_torch.models.uois_net import UOISNet3DBaseModel
    from quber_tpu_torch.models.uois_net_pretrained import (
        UOISNet3DPretrainedBaseModel, set_dtype)
    from quber_tpu_torch.train.checkpoint import load_eval_params

    dsn, rrn = (load_eval_params(ckpts["uoisnet3d"][k]) for k in ("ckpt_dsn", "ckpt_rrn"))

    def native(device):
        base = UOISNet3DBaseModel(dsn, rrn, device=device)
        set_compute_dtype(base.dsn, torch.float32)
        set_compute_dtype(base.rrn, torch.float32)
        return base

    keys = list(frames)
    label = "uoisnet3d, phase 24(b)'s weights, float32"
    _wrapper_parity(label, native,
                    _segmenting_frames(label, native, keys, ZOO2_BASE_CPU_FRAMES), card)
    twin = UOISNet3DPretrainedBaseModel(device="cpu")
    sd = {k: v.clone() for k, v in twin.dsn.state_dict().items()}
    sd["cd_module.weight"].zero_()
    sd["fg_module.weight"].zero_()
    sd["fg_module.weight"][2] = 1.0
    sd["decoder.last_conv.bias"] += 3.0
    rrn_sd = twin.rrn.state_dict()

    def pretrained(device):
        base = UOISNet3DPretrainedBaseModel(sd, rrn_sd, device=device)
        set_dtype(base.dsn, torch.float32)
        set_dtype(base.rrn, torch.float32)
        return base

    label = "uoisnet3d-pretrained, random init, centre head zeroed, float32"
    _wrapper_parity(label, pretrained,
                    _segmenting_frames(label, pretrained, keys, ZOO2_BASE_CPU_FRAMES), card)


def zoo2_phase(root, params, frames, dev, card, work):
    """Phase 24: UOIS-Net-3D, CascadePSP and RICE on the card. Returns the
    launches of 24(c)'s uoisnet3d passes."""
    zoo2_forwards(dev, card)
    ckpts = zoo2_training(dev, card, work)
    os.environ["QUBER_UOIS3D_RRN_CKPT"] = ckpts["uoisnet3d"]["ckpt_rrn"]
    launches = base_evaluation("uoisnet3d", "QUBER_UOIS3D_DSN_CKPT",
                               ckpts["uoisnet3d"]["ckpt_dsn"], root, params, frames, card,
                               "uoisnet3d (phase 24(b)'s weights)")
    base_device_seconds("uoisnet3d", frames, card)
    torch.cuda.empty_cache()
    zoo2_refiners(root, frames, ckpts, card)
    zoo2_bases(frames, ckpts, card)
    return launches


def _sam_prompts(masks, q, n=SAM_PROMPTS):
    """`n` mask prompts [n, q, q] (the refiner's encoding, * 20 - 10) from a
    frame's initial masks, repeated to fill the slots."""
    from quber_tpu_torch.ops.preprocess import resize_nearest

    out = np.zeros((n, q, q), np.float32)
    for i in range(n):
        m = np.asarray(masks[i % len(masks)]).astype(np.uint8)
        out[i] = resize_nearest(m, (q, q)) * 20.0 - 10.0
    return torch.from_numpy(out)


def _card_against_cpu(label, model, run, dev, card, rtol=SAM_RTOL, bf16=None):
    """`run(model, device)` -> {output: tensor} on the CPU, then on the card
    (the model moved there), float32 with TF32 off: each float output's max
    |card - CPU| over max |CPU| within `rtol`, each integer output equal;
    then with `bf16` (the model's submodules to set; the model by default;
    () for none) computing in bfloat16 on the card, its float outputs
    finite and their mean distance from float32 printed (not gated).
    Returns the largest float32 gap."""
    from quber_tpu_torch.models.layers import set_compute_dtype

    t0 = time.perf_counter()
    with torch.no_grad():
        cpu = run(model, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    model.to(dev)
    with torch.no_grad():
        run(model, dev)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(model, dev)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
    rel, same = _forward_gaps(got, cpu)
    print(f"{label} float32, card against CPU: max |card - CPU| over max |CPU| "
          f"{({k: float(f'{r:.3g}') for k, r in rel.items()})} (tolerance {rtol}), integer "
          f"outputs equal {same}; CPU {cpu_s:.2f} s, card {card_ms:.1f} ms (TF32 off)")
    if not all(bool(torch.isfinite(v).all()) for v in _float_outputs(got).values()) or \
            max(rel.values()) > rtol or not all(same.values()):
        raise AssertionError(f"{label}: the card and the CPU disagree")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    with torch.no_grad():
        tf32, _ = _forward_gaps(run(model, dev), cpu)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    print(f"{label} with TF32 on (a control, not gated): max |card - CPU| over max |CPU| "
          f"{max(tf32.values()):.3g}")
    if bf16 == ():
        return max(rel.values())
    for mod in bf16 or [model]:
        set_compute_dtype(mod, torch.bfloat16)
    with torch.no_grad():
        run(model, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        half = _float_outputs(run(model, dev))
        torch.cuda.synchronize()
        bf16_ms = (time.perf_counter() - t0) * 1e3
    if not all(bool(torch.isfinite(v).all()) for v in half.values()):
        raise AssertionError(f"{label}: a bfloat16 output on the card is not finite")
    dist = {k: float(f"{float((v.float() - got[k]).abs().mean() / got[k].abs().mean()):.3g}")
            for k, v in half.items()}
    print(f"{label} bfloat16 on the card: finite, {bf16_ms:.1f} ms; mean |bf16 - float32| over "
          f"mean |float32| {dist} on {card}")
    return max(rel.values())


def sam_forwards(frames, initial, dev, card):
    """Phase 25(a): hq-sam-pretrained's ViT-H at 1024 (one encode, one
    frame's 16 mask-prompt decodes) and ViT-B at 1024 (the automatic
    generator's 64 point decodes, multimask, and one box decode), from
    seeded inits, on the first anchor frame."""
    from quber_tpu_torch.models.sam_hq import SAMHQ
    from quber_tpu_torch.models.sam_refiner import sam_input

    key = next(iter(frames))
    image = torch.from_numpy(sam_input(frames[key][0], 1024))[None]
    prompts = _sam_prompts(initial[0], 256)[..., None]

    def refine(model, device):
        e, i = model.encode(image.to(device))
        masks, iou, all_masks = model.decode(e, i, prompts.to(device), False, True)
        return {"embed": e, "interm": i, "masks": masks, "iou": iou, "all_masks": all_masks}

    t0 = time.perf_counter()
    vit_h = SAMHQ.preset("vit_h").eval()
    vit_h.reset_parameters(torch.Generator().manual_seed(SAM_SEED))
    n_params = sum(p.numel() for p in vit_h.parameters())
    print(f"ViT-H SAM-HQ ({n_params / 1e6:.1f}M parameters) built and initialised on the host in "
          f"{time.perf_counter() - t0:.1f} s")
    _card_against_cpu(f"hq-sam-pretrained ViT-H at 1024, encode + {SAM_PROMPTS} mask "
                      "decodes", vit_h, refine, dev, card)
    del vit_h
    torch.cuda.empty_cache()

    g = SAM_GRID
    pts = (np.stack(np.meshgrid(np.arange(g), np.arange(g)), -1).reshape(-1, 2)
           .astype(np.float32) + 0.5) / g * 1024
    ys, xs = np.nonzero(np.asarray(initial[0][0]))
    box = torch.tensor([[xs.min() * 1024 / W, ys.min() * 1024 / H,
                         (xs.max() + 1) * 1024 / W, (ys.max() + 1) * 1024 / H]],
                       dtype=torch.float32)

    def decode(model, device):
        e, i = model.encode(image.to(device))
        out = {"embed": e, "interm": i}
        masks, iou, _ = model.decode_points(e, i, torch.from_numpy(pts)[:, None].to(device),
                                            torch.ones(g * g, 1, dtype=torch.int32,
                                                       device=device), True)
        out.update(point_masks=masks, point_iou=iou)
        masks, iou, _ = model.decode_box(e, i, box.to(device), True)
        return dict(out, box_masks=masks, box_iou=iou)

    vit_b = SAMHQ().eval()
    vit_b.reset_parameters(torch.Generator().manual_seed(SAM_SEED))
    _card_against_cpu(f"ViT-B at 1024, encode + {g * g} point decodes (multimask) + a "
                      "box decode", vit_b, decode, dev, card)
    del vit_b
    torch.cuda.empty_cache()


def sam_refiners(root, ckpt, card):
    """Phase 25(c)'s refiners: phase 14's frames through perturbed-gt ->
    sam, hq-sam ((b)'s weights through $QUBER_SAMHQ_CKPT and arch.json) and
    hq-sam-pretrained (ViT-H, bfloat16), each built by its name."""
    from quber_tpu_torch.evaluation.harness import run_eval
    from quber_tpu_torch.evaluation.refiner_models import build_refiner_model

    os.environ["QUBER_SAMHQ_CKPT"] = ckpt
    for name in ("sam", "hq-sam", "hq-sam-pretrained"):
        t0 = time.perf_counter()
        refiner = _Timed(build_refiner_model(name, "OSD", device="cuda"))
        built = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = run_eval(base_model="perturbed-gt", refiner_model=refiner, test_dataset="OSD",
                       dataset_path=root, device="cuda",
                       csv_path=os.path.join(os.path.dirname(root), f"eval_{name}", "eval.csv"))
        wall = time.perf_counter() - t0
        means = {s: {k: round(res[s][k], 6) for k in ("Objects F-measure", "Boundary F-measure")}
                 for s in ("initial", "refined")}
        seconds = [r[3] for r in refiner.records]
        model = refiner.inner.model
        print(f"perturbed-gt -> {name} ({model.image_encoder.patch_embed.out_channels} wide, "
              f"{model.image_encoder.depth} blocks at {refiner.inner.img_size}, "
              f"{model.mask_decoder.up_0.compute_dtype}), {len(seconds)} frames: masks per frame "
              f"{[len(r[2]) for r in refiner.records]} (with a pixel "
              f"{[_segmented(r[2]) for r in refiner.records]}), means {means}; the wrapper's "
              f"device seconds a frame median {statistics.median(seconds[1:]):.4f} (frame 1: "
              f"{seconds[0]:.3f}); built in {built:.1f} s, pass wall {wall:.2f} s on {card}")
        if len(seconds) != EVAL_FRAMES:
            raise AssertionError(f"{name}: run_eval did not refine every frame")
        if not sum(_segmented(r[2]) for r in refiner.records):
            raise AssertionError(f"{name}: no refined mask holds a pixel")
        del refiner, model
        torch.cuda.empty_cache()
    del os.environ["QUBER_SAMHQ_CKPT"]


def _sam_base(name, device):
    """The `sam` / `sam-depth` wrapper built by its name, iou_head's last
    bias raised by SAM_IOU_SHIFT."""
    from quber_tpu_torch.evaluation.base_models import build_base_model

    base = build_base_model(name, "OSD", device=device)
    with torch.no_grad():
        base.model.mask_decoder.iou_head.layers_2.bias += SAM_IOU_SHIFT
    return base


def sam_bases(root, params, frames, card):
    """Phase 25(c)'s bases: phase 14's frames through run_eval with base
    sam and sam-depth (their seeded inits, IoU bias raised) and the flagship
    refiner, per image and streamed. Returns {base: the launches of both
    passes}."""
    launches = {}
    for name in ("sam", "sam-depth"):
        base = _sam_base(name, "cuda")
        launches[name] = base_evaluation(
            name, None, None, root, params, frames, card,
            f"{name} (seeded init, iou_head bias +{SAM_IOU_SHIFT})", model=base)
        base_device_seconds(name, frames, card, model=base)
        del base
        torch.cuda.empty_cache()
    return launches


def _same_labels(label, got, want, card):
    from quber_tpu_torch.evaluation.harness import masks_to_label_image

    agree = _label_agreement(masks_to_label_image(got, np.zeros((H, W), np.int32)),
                             masks_to_label_image(want, np.zeros((H, W), np.int32)))
    print(f"{label}: masks card {len(got)} CPU {len(want)} (with a pixel {_segmented(got)} / "
          f"{_segmented(want)}), label agreement {agree:.6f} (need >= {SAM_AGREEMENT}) on {card}")
    if len(got) != len(want) or agree < SAM_AGREEMENT or not _segmented(want):
        raise AssertionError(f"{label}: the card and the CPU disagree")


def sam_parity(frames, initial, card):
    """Phase 25(d): the float32 ViT-B refiners (sam, hq-sam at their seeded
    inits) and the automatic generator (sam, sam-depth, IoU bias raised),
    card against CPU on the first anchor frames on which the card keeps a
    mask with a pixel."""
    from quber_tpu_torch.models.layers import set_compute_dtype
    from quber_tpu_torch.models.sam_refiner import SAMHQRefiner

    keys = list(frames)

    def compare(label, make, call):
        models = {d: make(d) for d in ("cuda", "cpu")}
        for m in models.values():
            set_compute_dtype(m.model, torch.float32)
        found = 0
        for i, key in enumerate(keys):
            got = call(models["cuda"], i, key)
            if not _segmented(got):
                continue
            _same_labels(f"{label}, anchor frame {i + 1}", got, call(models["cpu"], i, key), card)
            found += 1
            if found == SAM_PARITY_FRAMES:
                break
        if not found:
            raise AssertionError(f"{label}: the card kept no mask with a pixel")
        del models
        torch.cuda.empty_cache()

    for name, hq in (("sam", False), ("hq-sam", True)):
        compare(f"{name} refiner (ViT-B at 1024, seeded init, float32)",
                lambda d, hq=hq: SAMHQRefiner(hq=hq, device=d),
                lambda m, i, key: m.predict(*key, initial[i], None)[0])
    for name in ("sam", "sam-depth"):
        compare(f"{name} base (seeded init, iou_head bias +{SAM_IOU_SHIFT}, float32)",
                lambda d, name=name: _sam_base(name, d),
                lambda m, i, key: m.predict(*key)[0])


def sam_phase(root, params, frames, initial, dev, card, work):
    """Phase 25: SAM-HQ on the card. Returns the launches of 25(c)'s base
    evaluations."""
    sam_forwards(frames, initial, dev, card)
    ckpt = zoo2_training(dev, card, work, names=("samhq",))["samhq"]["ckpt"]
    sam_refiners(root, ckpt, card)
    launches = sam_bases(root, params, frames, card)
    sam_parity(frames, initial, card)
    return launches


def _detector_frame(bgr):
    """A BGR uint8 frame as the [1, 3, H, W] float32 input of phase 26(a)'s
    parity checks: detectron2's BGR pixel mean and std taken out
    (DETECTOR_PIXEL_MEAN / _STD)."""
    x = (bgr.astype(np.float32) - DETECTOR_PIXEL_MEAN) / DETECTOR_PIXEL_STD
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)))[None]


def _card_cpu_gap(model, run, dev):
    """(largest float gap, every integer output equal) of `run(model,
    device)` on the card against the CPU, float32; `model` is left on the
    CPU."""
    with torch.no_grad():
        cpu = run(model, torch.device("cpu"))
        rel, same = _forward_gaps(run(model.to(dev), dev), cpu)
    model.to("cpu")
    return float(f"{max(rel.values()):.3g}"), all(same.values())


def detector_parity(images, dev, card):
    """Phase 26(a)'s detector: the hash text tower and DeticDetector (480x640,
    128 proposals, 32 detections) over the OSD vocabulary. Gated: from
    OPENVOCAB_SEED's init on the first of the BGR `images` normalised
    (_detector_frame), _card_against_cpu in float32 (TF32 off) and in
    bfloat16. Then a survey (printed, not gated): from each of
    DETECTOR_SURVEY_SEEDS' inits on its own frame, normalised and raw, the
    largest gap and whether every selection is equal. Returns the survey,
    {seed: {"normalised" | "raw": (gap, selections equal)}}."""
    from torch import nn

    from quber_tpu_torch.models.open_vocab import (
        VOCABULARIES, DeticDetector, TextEncoder, hash_tokenize)

    vocab = VOCABULARIES["OSD"]
    ids, mask = (torch.from_numpy(a) for a in hash_tokenize(vocab))

    def init(seed):
        generator = torch.Generator().manual_seed(seed)
        detic = nn.ModuleDict({"text": TextEncoder(), "detector": DeticDetector()}).eval()
        detic["text"].reset_parameters(generator)
        detic["detector"].reset_parameters(generator)
        return detic

    def detect(image):
        def run(model, device):
            embeds = model["text"](ids.to(device), mask.to(device))
            return dict(model["detector"](image.to(device), embeds), text_embeds=embeds)
        return run

    detic = init(OPENVOCAB_SEED)
    _card_against_cpu(f"DeticDetector at {H}x{W} (128 proposals, 32 detections) with the hash "
                      f"tower over the {len(vocab)} OSD names on the normalised frame", detic,
                      detect(_detector_frame(images[0])), dev, card,
                      OPENVOCAB_RTOL["detector"], bf16=[detic["detector"]])
    del detic
    survey = {}
    for seed, bgr in zip(DETECTOR_SURVEY_SEEDS, images[1:]):
        detic = init(seed)
        raw = torch.from_numpy(np.ascontiguousarray(bgr.transpose(2, 0, 1), np.float32))[None]
        survey[seed] = {"normalised": _card_cpu_gap(detic, detect(_detector_frame(bgr)), dev),
                        "raw": _card_cpu_gap(detic, detect(raw), dev)}
        del detic
    flips = {k: sum(not v[k][1] for v in survey.values()) for k in ("normalised", "raw")}
    agree = {k: max((v[k][0] for v in survey.values() if v[k][1]), default=None)
             for k in ("normalised", "raw")}
    print(f"DeticDetector survey (not gated), float32 card against CPU, seeds "
          f"{DETECTOR_SURVEY_SEEDS[0]}-{DETECTOR_SURVEY_SEEDS[-1]} each on its own anchor frame "
          f"(largest gap, every selection equal): {survey}; selections differ on {flips} of "
          f"{len(survey)}; largest gap where they agree {agree} on {card}")
    return survey


def openvocab_forwards(frames, dev, card):
    """Phase 26(a): from seeded inits, float32 (TF32 off) card against CPU,
    then the wrappers' modules in bfloat16 on the card: the detector on the
    first anchor frame normalised, and its survey (detector_parity), and on
    the first anchor frame CLIP's text tower at ViT-B width over the
    OSD vocabulary (the committed mini merges file), and GroundedSAM's
    pipeline (grounder on the normalised frame, SAM ViT-B at 512 encoding
    SAM's frame once, the 16 grounded boxes decoded, the HQ logits resized
    to 480x640)."""
    from torch import nn

    from quber_tpu_torch.models.clip_text import CLIPTextEncoder, CLIPTokenizer
    from quber_tpu_torch.models.layers import resize_bilinear, set_compute_dtype
    from quber_tpu_torch.models.open_vocab import (
        VOCABULARIES, GroundedSAMBaseModel, hash_tokenize, sam_frame)

    keys = list(frames)
    detector_parity([frames[k][0] for k in keys], dev, card)
    bgr = frames[keys[0]][0]
    image = _detector_frame(bgr)
    vocab = VOCABULARIES["OSD"]
    generator = torch.Generator().manual_seed(OPENVOCAB_SEED)
    tokenizer = CLIPTokenizer(CLIP_MINI_MERGES, context_length=77)
    clip_ids = torch.from_numpy(tokenizer([t.replace("_", " ") for t in vocab]))
    clip = CLIPTextEncoder().eval()
    clip.reset_parameters(generator)
    _card_against_cpu("CLIP text tower at ViT-B width (12 blocks of 512, context 77) over "
                      "the OSD names, the mini merges", clip,
                      lambda m, d: {"embeds": m(clip_ids.to(d))}, dev, card,
                      OPENVOCAB_RTOL["clip"], bf16=())
    del clip

    wrapper = GroundedSAMBaseModel(seed=OPENVOCAB_SEED, device="cpu")
    gsam = nn.ModuleDict({"text": wrapper.text_encoder, "grounder": wrapper.grounder,
                          "sam": wrapper.sam})
    for mod in (gsam["grounder"], gsam["sam"]):
        set_compute_dtype(mod, torch.float32)
    g_ids, g_mask = (torch.from_numpy(a) for a in hash_tokenize([wrapper.text_prompt]))
    s = wrapper.sam_size
    sam_img = torch.from_numpy(np.ascontiguousarray(sam_frame(bgr.astype(np.float32), s)))
    scale = torch.tensor([W, H, W, H], dtype=torch.float32)

    def ground(model, device):
        embeds = model["text"](g_ids.to(device), g_mask.to(device))
        out = model["grounder"](image.to(device), embeds)
        embed, interm = model["sam"].encode(sam_img[None].to(device))
        masks, iou, _ = model["sam"].decode_box(embed, interm,
                                                out["boxes"] / scale.to(device) * s, False, True)
        return {"boxes": out["boxes"], "scores": out["scores"], "valid": out["valid"],
                "det_index": out["det_index"], "embed": embed, "interm": interm,
                "masks_lr": masks, "iou": iou, "masks": resize_bilinear(masks[:, 0], (H, W))}

    _card_against_cpu(f"GroundedSAM pipeline (grounder on the normalised frame, SAM ViT-B at {s}, "
                      f"{wrapper.grounder.max_detections} box decodes)", gsam, ground, dev,
                      card, OPENVOCAB_RTOL["grounded-sam"],
                      bf16=[gsam["grounder"], gsam["sam"]])
    del gsam, wrapper
    torch.cuda.empty_cache()


def _force_hq_pixels(sam, embed, interm, boxes):
    """Give the SAM's HQ features a constant channel (channel 0 of the mask
    feature conv a bias of 1, of the two feature branches 0) and its HQ
    token's hypernetwork a constant weight on it, the negated median of the
    box decodes' HQ logits. Returns the weight."""
    dec = sam.mask_decoder
    for conv in (dec.enc_3, dec.compress_vit_3):
        conv.weight[0] = 0.0
        conv.bias[0] = 0.0
    dec.maskfeat_3.weight[0] = 0.0
    dec.maskfeat_3.bias[0] = 1.0
    last = dec.hf_mlp.layers_2
    last.weight[0] = 0.0
    last.bias[0] = 0.0
    logits = sam.decode_box(embed, interm, boxes, False, True)[0]
    shift = -float(logits.median())
    last.bias[0] = shift
    return shift


def _openvocab_eval_copy(name, model, pool, work):
    """The weights 26(c) evaluates (OPENVOCAB_THRESH's comment): (b)'s 40
    steps with the detector's RPN and box deltas zeroed and Detic's mask
    bias, or GroundedSAM's HQ channel, moved on training scene 0. Saved with
    the recipe's sidecars; returns the checkpoint directory."""
    import train_zoo_torch as zoo
    from quber_tpu_torch.train.checkpoint import save_params

    detector = model["detector" if name == "detic" else "grounder"]
    with torch.no_grad():
        for layer in (detector.rpn.deltas, detector.box_deltas):
            layer.weight.zero_()
            layer.bias.zero_()
        out = detector(pool["bgr"][0][None], model["text"](model.text_ids, model.text_mask))
        valid = out["valid"]
        if name == "detic":
            shift = -float(out["masks"][valid].median())
            detector.mask_pred.bias += shift
            note = f"mask bias moved by {shift:.4f}"
        else:
            sam = model["sam"]
            s = sam.img_size
            scale = torch.tensor([W, H, W, H], dtype=torch.float32, device=valid.device)
            embed, interm = sam.encode(pool["sam_img"][0][None])
            boxes = out["boxes"][valid] / scale * s
            held = int((sam.decode_box(embed, interm, boxes, False, True)[0] > 0).sum())
            note = f"the 40-step SAM's HQ masks hold {held} pixels on the scene's boxes"
            if not held:
                note += (f"; HQ channel weight "
                         f"{_force_hq_pixels(sam, embed, interm, boxes):.4f}")
    print(f"{name}: the evaluated copy's deltas zeroed, {int(valid.sum())} valid detections on "
          f"a training scene, {note}")
    out_dir = os.path.join(work, name, "eval")
    save_params(os.path.join(out_dir, "ckpt"), zoo.jax_tree(model), step=ZOO_CARD_STEPS)
    zoo.write_sidecars(type("Args", (), {"model": name, "output_dir": out_dir}))
    return os.path.join(out_dir, "ckpt")


# base name: (its recipe, checkpoint and threshold variables)
_OPENVOCAB_BASES = {"detic": ("detic", "QUBER_DETIC_CKPT", "QUBER_DETIC_THRESH"),
                    "grounded-sam": ("gsam", "QUBER_GSAM_CKPT", "QUBER_GSAM_THRESH")}


def _float32_base(name):
    """build(device): the `name` wrapper built by its name, its detector and
    SAM set to float32."""
    from quber_tpu_torch.evaluation.base_models import build_base_model
    from quber_tpu_torch.models.layers import set_compute_dtype

    def build(device):
        base = build_base_model(name, "OSD", device=device)
        for mod in ((base.detector,) if name == "detic" else (base.grounder, base.sam)):
            set_compute_dtype(mod, torch.float32)
        return base

    return build


def openvocab_phase(root, params, frames, dev, card, work):
    """Phase 26: the open-vocabulary base segmenters and the late-fusion
    study on the card. Returns the launches of 26(c)'s evaluations."""
    t0 = time.perf_counter()
    openvocab_forwards(frames, dev, card)
    ckpts = zoo2_training(dev, card, work, names=OPEN_VOCAB_RECIPES)
    launches = {}
    for base, (recipe, ckpt_env, thresh_env) in _OPENVOCAB_BASES.items():
        os.environ[thresh_env] = OPENVOCAB_THRESH
        launches[base] = base_evaluation(
            base, ckpt_env, ckpts[recipe]["eval"], root, params, frames, card,
            f"{base} (26(b)'s 40 steps, the evaluated copy, threshold {OPENVOCAB_THRESH})")
        base_device_seconds(base, frames, card)
        torch.cuda.empty_cache()
    for base, (_, ckpt_env, thresh_env) in _OPENVOCAB_BASES.items():
        # (d) the float32 wrappers, card against CPU
        keys = _segmenting_frames(f"{base} (float32)", _float32_base(base), list(frames), 1)
        _wrapper_parity(f"{base} wrapper (float32), card against CPU", _float32_base(base),
                        keys, card)
        del os.environ[ckpt_env], os.environ[thresh_env]
    torch.cuda.empty_cache()
    late_fusion(dev, card)
    print(f"phase 26: {time.perf_counter() - t0:.1f} s on {card}")
    return launches


def late_fusion(dev, card):
    """Phase 26(e): the late-fusion encoder-decoder at 480x640 (batch 2,
    seeded inputs and one-hot error maps) from a seeded init, float32 card
    against CPU; two train_eee steps (Adam, focal) card against CPU, the
    second from the CPU's state; then LATE_FUSION_STEPS timed on the card."""
    from quber_tpu_torch.models.late_fusion import MODALITIES, LateFusionEncoderDecoder
    from quber_tpu_torch.train.eee_train import create_eee_state, make_eee_train_step

    g = torch.Generator().manual_seed(OPENVOCAB_SEED)
    b = LATE_FUSION_BATCH
    batch = {k: torch.randn(b, c, H, W, generator=g) for k, c in MODALITIES}
    for k in ("mask_target", "boundary_target"):
        batch[k] = torch.nn.functional.one_hot(torch.randint(0, 3, (b, H, W), generator=g),
                                               3).permute(0, 3, 1, 2).float()
    inputs = [k for k, _ in MODALITIES]
    model = LateFusionEncoderDecoder().eval()
    model.reset_parameters(torch.Generator().manual_seed(OPENVOCAB_SEED))
    _card_against_cpu(f"LateFusionEncoderDecoder at {H}x{W}, batch {b}", model,
                      lambda m, d: m({k: batch[k].to(d) for k in inputs}), dev, card,
                      OPENVOCAB_RTOL["late fusion"], bf16=())
    del model
    runs = {}
    for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
        model = LateFusionEncoderDecoder()
        optimizer = create_eee_state(model, seed=OPENVOCAB_SEED, device=device)
        runs[key] = {"model": model, "opt": optimizer, "losses": [],
                     "step": make_eee_train_step(model, optimizer, "focal"),
                     "batch": {k: v.to(device) for k, v in batch.items()}}
    for i in range(ZOO_CPU_STEPS):
        if i:
            runs["card"]["model"].load_state_dict(runs["cpu"]["model"].state_dict())
            runs["card"]["opt"].load_state_dict(runs["cpu"]["opt"].state_dict())
        for run in runs.values():
            run["losses"].append({k: float(v) for k, v in run["step"](run["batch"]).items()})
            if i == 0:
                run["grads"] = {n: p.grad.detach().cpu().double()
                                for n, p in run["model"].named_parameters()}
    grad_cpu, grad_gpu = runs["cpu"]["grads"], runs["card"]["grads"]
    norm = {n: float(g.norm()) for n, g in grad_cpu.items()}
    top = max(norm.values())
    cos = min((float(torch.nn.functional.cosine_similarity(
        g.flatten(), grad_gpu[n].flatten(), dim=0)), n)
        for n, g in grad_cpu.items() if norm[n] > ZERO_GRAD_SHARE * top)
    pairs = list(zip(runs["card"]["losses"], runs["cpu"]["losses"]))
    print(f"late fusion, {ZOO_CPU_STEPS} train_eee steps card against CPU: losses card "
          f"{[a['total_loss'] for a, _ in pairs]} cpu {[c['total_loss'] for _, c in pairs]} "
          f"(rtol {CPU_LOSS_RTOL}); first gradient cosine min {cos[0]:.6f} at {cos[1]}")
    if not all(abs(a[k] - c[k]) <= CPU_LOSS_RTOL * abs(c[k]) + 1e-6 for a, c in pairs for k in c):
        raise AssertionError("late fusion: the card and the CPU disagree on a loss")
    if cos[0] < GRAD_COSINE:
        raise AssertionError("late fusion: the card and the CPU disagree on a gradient")
    run = runs["card"]
    del runs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(LATE_FUSION_STEPS):
        t0 = time.perf_counter()
        metrics = run["step"](run["batch"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"late fusion train_eee step on the card (float32, batch {b} at {H}x{W}): "
          f"{statistics.median(times):.3f} ms median of {LATE_FUSION_STEPS}, loss "
          f"{float(metrics['total_loss']):.4f}, peak {peak:.3f} GiB on {card}")
    if not np.isfinite(float(metrics["total_loss"])):
        raise AssertionError("late fusion: a loss on the card is not finite")


def seam_round_trip(params, served, seam, card):
    """Phase 27(a): the int8 flagship exported to a detectron2 .pth, imported
    by the CLI, loaded through $QUBER_WEIGHTS, served on phase 4's frames and
    quantized back. Returns (the launches of the serving, the .pth)."""
    from quber_tpu_torch.models.from_jax import as_state_dict
    from quber_tpu_torch.models.import_torch import export_mask_refiner
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.predictor import MaskRefinerPredictor
    from quber_tpu_torch.tools import quantize_checkpoint
    from quber_tpu_torch.train.checkpoint import _BUNDLED, load_default_params

    here = os.path.dirname(os.path.abspath(__file__))
    archive = as_state_dict(params)
    pth = os.path.join(seam, "model_final.pth")
    torch.save(export_mask_refiner(archive), pth)
    out = os.path.join(seam, "imported")
    t0 = time.perf_counter()
    (log,) = _run_clis([["-m", "quber_tpu_torch.tools.import_checkpoint", "--model",
                         "mask_refiner", "--torch", pth, "--out", out]], here)
    seconds = time.perf_counter() - t0
    print(f"phase 27(a): import CLI on the card in {seconds:.2f} s (process included): "
          f"{log.strip().splitlines()[-1]} on {card}")
    os.environ["QUBER_WEIGHTS"] = os.path.join(out, "ckpt")
    try:
        imported = load_default_params()
    finally:
        del os.environ["QUBER_WEIGHTS"]
    got = as_state_dict(imported)
    if set(got) != set(archive) or not all(torch.equal(got[k], archive[k]) for k in archive):
        raise AssertionError("phase 27(a): the imported state dict is not the archive's")

    frames, want = served
    predictor = MaskRefinerPredictor(params=imported, device="cuda")
    kernels.reset_launch_counts()
    results = [predictor.predict(rgb, depth, list(masks))[0] for rgb, depth, masks in frames]
    torch.cuda.synchronize()
    launches = _launch_counts()
    counts = [len(r.get("instances", {}).get("scores", [])) for r in results]
    agree = [_label_agreement(r["panoptic_seg"][0], w["panoptic_seg"][0])
             for r, w in zip(results, want)]
    print(f"phase 27(a): the imported flagship through $QUBER_WEIGHTS served phase 4's "
          f"{len(frames)} frames: instances {counts} (phase 4: "
          f"{[len(w.get('instances', {}).get('scores', [])) for w in want]}), label agreement "
          f"min {min(agree):.6f} (need >= {PANOPTIC_AGREEMENT}), launches {launches}")
    for r, w, a in zip(results, want, agree):
        if len(r.get("instances", {}).get("scores", [])) != \
                len(w.get("instances", {}).get("scores", [])) or a < PANOPTIC_AGREEMENT:
            raise AssertionError("phase 27(a): the imported flagship serves otherwise")
    for name in ("instance_stats", "encode_initial_masks", "group_pixels"):
        if launches[name] != len(frames):
            raise AssertionError(f"phase 27(a): {name} launched {launches[name]} times for "
                                 f"{len(frames)} frames")

    npz = os.path.join(seam, "flagship_int8.npz")
    t0 = time.perf_counter()
    quantize_checkpoint.main([os.path.join(out, "ckpt"), npz])
    quantize_s = time.perf_counter() - t0
    with np.load(_BUNDLED) as ref, np.load(npz) as got:
        same = sorted(ref.files) == sorted(got.files) and all(
            got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]) for k in ref.files)
        n = len(ref.files)
    print(f"phase 27(a): quantize CLI in {quantize_s:.2f} s: {n} arrays, every one equal to "
          f"weights/flagship_synth_int8.npz's: {same}")
    if not same:
        raise AssertionError("phase 27(a): the re-quantized archive differs")
    return launches, pth


def seam_parity(pth, card):
    """Phase 27(b): the activation-parity tool at 480x640 on the flagship's
    weights, float32 with TF32 off, on the card."""
    from quber_tpu_torch.models.import_torch import load_torch_checkpoint
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig
    from quber_tpu_torch.tools.activation_parity import parity

    rng = np.random.RandomState(0)
    images = (rng.rand(1, H, W, 6) * 255).astype(np.float32)
    offset = rng.rand(1, H, W, 3).astype(np.float32)
    t0 = time.perf_counter()
    report = parity(load_torch_checkpoint(pth), MaskRefinerConfig(), images, offset,
                    SEAM_PARITY_ATOL, torch.device("cuda", 0))
    seconds = time.perf_counter() - t0
    bad = [k for k, v in report.items() if v["status"] != "ok"]
    worst = max(report, key=lambda k: report[k].get("max_abs", float("inf")) /
                max(1.0, report[k].get("ref_max_abs", 1.0)))
    w = report[worst]
    print(f"phase 27(b): activation parity at {H}x{W} on the card (float32, TF32 off): "
          f"{len(report) - len(bad)}/{len(report)} stages within {SEAM_PARITY_ATOL} of their "
          f"peak; worst {worst}: max |d| {w.get('max_abs', float('nan')):.3e} at peak "
          f"{w.get('ref_max_abs', float('nan')):.3e}; {seconds:.2f} s on {card}")
    if bad or len(report) < SEAM_PARITY_STAGES:
        raise AssertionError(f"phase 27(b): activation parity failed: {bad}")


def seam_drill(pth, seam, card):
    """Phase 27(c): the parity drill on the card, SEAM_DRILL_FRAMES rendered
    480x640 frames, base perturbed-gt, refiner maskrefiner-nofilter."""
    from quber_tpu_torch.tools import parity_drill

    out = os.path.join(seam, "drill.json")
    t0 = time.perf_counter()
    rc = parity_drill.main(["--torch", pth, "--synthetic-n", str(SEAM_DRILL_FRAMES), "--limit",
                            str(SEAM_DRILL_FRAMES), "--workdir", os.path.join(seam, "drill"),
                            "--out", out])
    seconds = time.perf_counter() - t0
    with open(out) as f:
        report = json.load(f)
    ev = report["eval"]
    print(f"phase 27(c): parity drill on the card: ok {report['ok']}, "
          f"{report['parity']['n_stages']} stages (worst {report['parity']['worst_stage']}, "
          f"max |d| {report['parity']['worst_max_abs']:.3e}); {SEAM_DRILL_FRAMES} frames: "
          + ", ".join(f"{stage} Objects F {ev[stage]['Objects F-measure']:.4f} Boundary F "
                      f"{ev[stage]['Boundary F-measure']:.4f}" for stage in ("initial", "refined"))
          + f"; avg_refine_ms {ev['avg_refine_ms']:.3f}; {seconds:.2f} s on {card}")
    if rc != 0 or not report["ok"]:
        raise AssertionError("phase 27(c): the parity drill failed")


def _reference_twins():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "reference_twins", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                        "reference_twins.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def seam_zoo(anchor, seam, card):
    """Phase 27(d): CGNet, LMFFNet and UCN state dicts in the reference
    layouts through the import CLI, loaded by name from their variables and
    run on the first anchor frame, card against CPU."""
    from quber_tpu_torch.evaluation.base_models import build_base_model
    from quber_tpu_torch.evaluation.harness import masks_to_label_image
    from quber_tpu_torch.evaluation.refiner_models import build_refiner_model
    from quber_tpu_torch.ops.preprocess import load_rgbd

    twins = _reference_twins()
    made = {"cgnet": twins.cgnet_twin(), "lmffnet": twins.lmffnet_twin(),
            "ucn": twins.ucn_twin(embed=64)}
    commands = []
    for i, (name, module) in enumerate(made.items()):
        path = os.path.join(seam, f"{name}.pth")
        torch.save({"model": {k: torch.from_numpy(v) for k, v in
                              twins.seeded_state(module, SEAM_SEED + i).items()}}, path)
        commands.append(["-m", "quber_tpu_torch.tools.import_checkpoint", "--model", name,
                         "--torch", path, "--out", os.path.join(seam, name)])
    t0 = time.perf_counter()
    _run_clis(commands, os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    print(f"phase 27(d): {len(commands)} import CLIs at once on the card in {seconds:.2f} s")
    rgb, depth = anchor
    for name, env in (("cgnet", "QUBER_CGNET_CKPT"), ("lmffnet", "QUBER_LMFFNET_CKPT")):
        os.environ[env] = os.path.join(seam, name, "ckpt")
        try:
            fg = {device: build_refiner_model("maskrefiner", "OSD", device=device).fg_predictor
                  for device in ("cuda", "cpu")}
        finally:
            del os.environ[env]
        x = fg["cuda"].inputs(*load_rgbd(rgb, depth, fg["cuda"].size)[:2])
        got, want = (fg[d].logits(x).float().cpu() for d in ("cuda", "cpu"))
        agree = float((got.argmax(dim=0) == want.argmax(dim=0)).float().mean())
        gap = float((got - want).abs().max() / want.abs().max())
        print(f"phase 27(d): {name} through ${env} ({type(fg['cuda'].model).__name__}) on "
              f"anchor frame 1, float32: argmax equal to the CPU's on {agree:.6f} (need >= "
              f"{FG_AGREEMENT}), max |card - CPU| {gap:.3g} of max |CPU|")
        if not bool(torch.isfinite(got).all()) or agree < FG_AGREEMENT:
            raise AssertionError(f"phase 27(d): {name} card and CPU disagree")
    os.environ["QUBER_UCN_CKPT"] = os.path.join(seam, "ucn", "ckpt")
    try:
        out = {device: build_base_model("ucn", "OSD", device=device).predict(rgb, depth)[0]
               for device in ("cuda", "cpu")}
    finally:
        del os.environ["QUBER_UCN_CKPT"]
    zero = np.zeros((H, W), np.int32)
    agree = _label_agreement(masks_to_label_image(out["cuda"], zero),
                             masks_to_label_image(out["cpu"], zero))
    print(f"phase 27(d): ucn through $QUBER_UCN_CKPT on anchor frame 1: instances card "
          f"{len(out['cuda'])} CPU {len(out['cpu'])}, label agreement {agree:.6f} (need >= "
          f"{PANOPTIC_AGREEMENT})")
    if len(out["cuda"]) != len(out["cpu"]) or agree < PANOPTIC_AGREEMENT:
        raise AssertionError("phase 27(d): ucn card and CPU disagree")


def seam_phase(params, served, frames, card, work):
    """Phase 27: the reference-checkpoint seam on the card. Returns the
    launches of 27(a)'s serving."""
    t0 = time.perf_counter()
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    seam = os.path.join(work, "seam")
    os.makedirs(seam)
    try:
        launches, pth = seam_round_trip(params, served, seam, card)
        seam_parity(pth, card)
        seam_drill(pth, seam, card)
        seam_zoo(next(iter(frames)), seam, card)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"phase 27: {time.perf_counter() - t0:.1f} s on {card}")
    return launches


def _dp_configs():
    from quber_tpu_torch.config import TrainConfig
    from quber_tpu_torch.models.mask_refiner import MaskRefinerConfig

    return MaskRefinerConfig(aspp_dropout=0.0), TrainConfig(batch_size=BATCH, warmup_iters=2)


def _dp_eee_batch():
    """Phase 28(d)'s global batch: seeded inputs and one-hot error maps."""
    from quber_tpu_torch.models.late_fusion import MODALITIES

    g = torch.Generator().manual_seed(OPENVOCAB_SEED + 28)
    batch = {k: torch.randn(DP_EEE_BATCH, c, H, W, generator=g) for k, c in MODALITIES}
    for k in ("mask_target", "boundary_target"):
        batch[k] = torch.nn.functional.one_hot(
            torch.randint(0, 3, (DP_EEE_BATCH, H, W), generator=g), 3).permute(0, 3, 1, 2).float()
    return batch


def _dp_eee_losses(dev, mesh):
    """DP_EEE_STEPS train_eee steps (Adam, focal) of the late-fusion model
    from its seeded init: on this rank's slice under a mesh, else on the
    whole batch."""
    from quber_tpu_torch.models.late_fusion import LateFusionEncoderDecoder
    from quber_tpu_torch.parallel.mesh import put_batch
    from quber_tpu_torch.train.eee_train import create_eee_state, make_eee_train_step

    model = LateFusionEncoderDecoder()
    optimizer = create_eee_state(model, seed=OPENVOCAB_SEED, device=dev, mesh=mesh)
    step = make_eee_train_step(model, optimizer, "focal", mesh)
    batch = _dp_eee_batch()
    batch = put_batch(batch, mesh) if mesh is not None else {k: v.to(dev) for k, v in
                                                             batch.items()}
    return [{k: float(v) for k, v in step(batch).items()} for _ in range(DP_EEE_STEPS)]


def _bit_checksums(tensors) -> torch.Tensor:
    """An int64 checksum of each float32 tensor's bits (exact: integer sums
    do not depend on their order)."""
    sums = []
    for t in tensors:
        bits = t.detach().contiguous().view(-1).view(torch.int32).long()
        weights = torch.arange(1, 2 * bits.numel() + 1, 2, dtype=torch.int64, device=t.device)
        sums.append((bits * weights).sum())
    return torch.stack(sums).cpu()


def _dp_steps(state, step, pool, dev):
    """DP_STEPS steps: losses, ms, launches and (for the ranks) the state's
    checksums after each."""
    from quber_tpu_torch.ops import kernels

    out = {"losses": [], "ms": [], "launches": [], "checksums": []}
    for _ in range(DP_STEPS):
        bufs = pool.next_batch()
        kernels.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, metrics = step(state, bufs)
        torch.cuda.synchronize(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(_launch_counts())
        out["losses"].append({k: float(v) for k, v in metrics.items()})
        moments = [s[k] for s in state.optimizer.state.values() for k in ("exp_avg", "exp_avg_sq")]
        out["checksums"].append(_bit_checksums(list(state.model.state_dict().values()) + moments))
    return out


def dp_worker(work) -> int:
    """Phase 28(a) and (d) on one of DP_RANKS gloo ranks sharing cuda:0,
    launched by torchrun: DP_STEPS device-target steps of the flagship on
    the rank's slice of each global batch, then DP_EEE_STEPS late-fusion
    steps; the results go to `work`/dp_rank<rank>.pt."""
    from quber_tpu_torch.models.from_jax import state_dict_from_jax
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.parallel import mesh as pmesh
    from quber_tpu_torch.train.checkpoint import load_eval_params
    from quber_tpu_torch.train.device_targets import DevicePool, make_device_target_step
    from quber_tpu_torch.train.loop import create_train_state

    dev = torch.device("cuda", 0)
    pmesh.initialize_multihost(backend="gloo", device=dev)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load_library()
    mesh = pmesh.make_mesh(dev)
    model_cfg, train_cfg = _dp_configs()
    state = create_train_state(model_cfg, train_cfg, mesh=mesh)
    state.model.load_state_dict(state_dict_from_jax(load_eval_params(WEIGHTS)), strict=True)
    pool = DevicePool(np.load(os.path.join(work, "dp_pool.npy")), BATCH, train_cfg.seed, dev,
                      mesh=mesh)
    out = _dp_steps(state, make_device_target_step(model_cfg, train_cfg, TRAIN_SLOTS,
                                                   mesh=mesh), pool, dev)
    if mesh.rank == 0:
        out["state"] = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    del state, pool
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out["eee"] = _dp_eee_losses(dev, mesh)
    out["eee_ms"] = (time.perf_counter() - t0) * 1e3 / DP_EEE_STEPS
    torch.save(out, os.path.join(work, f"dp_rank{mesh.rank}.pt"))
    pmesh.shutdown()
    return 0


def _torchrun(nproc, args, log):
    """A torchrun --standalone launch of `args` (a script and its arguments)
    from the root of the checkout, its output to `log`."""
    f = open(log, "w")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), *args]
    return subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=f,
                            stderr=subprocess.STDOUT), f


def _wait(procs, what):
    """Waits for (Popen, log file) pairs; kills them all on a timeout."""
    try:
        for p, _ in procs:
            p.wait(timeout=DP_TIMEOUT)
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    for p, f in procs:
        if p.returncode:
            with open(f.name) as log:
                tail = log.read()[-4000:]
            raise AssertionError(f"{what}: a process exited with {p.returncode}:\n{tail}")


def _update_cosines(before, after_a, after_b, names):
    """min over `names` of the cosine between the two states' updates."""
    worst = (1.0, None)
    for n in names:
        da = (after_a[n].double() - before[n].double()).flatten()
        db = (after_b[n].double() - before[n].double()).flatten()
        cos = float(torch.nn.functional.cosine_similarity(da, db, dim=0))
        worst = min(worst, (cos, n))
    return worst


def dp_train(params, dev, card, work, meanwhile):
    """Phase 28(a) and (d): the ranks (torchrun, gloo on cuda:0) against
    one process on the whole batch, which runs while the ranks start up
    (their imports, weights and initialisation), and so does `meanwhile()`
    after it. Returns each rank's launches."""
    from quber_tpu_torch.models.from_jax import state_dict_from_jax
    from quber_tpu_torch.models.layers import BatchNorm, ConvNorm
    from quber_tpu_torch.profiling import packed_scene_pool
    from quber_tpu_torch.train.device_targets import DevicePool, make_device_target_step
    from quber_tpu_torch.train.loop import create_train_state

    model_cfg, train_cfg = _dp_configs()
    packed = packed_scene_pool(model_cfg, train_cfg, DP_POOL, TRAIN_SLOTS, seed=28)
    np.save(os.path.join(work, "dp_pool.npy"), packed)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks_proc = _torchrun(DP_RANKS, [os.path.basename(__file__), "--dp-worker", work],
                           os.path.join(work, "dp_ranks.log"))
    try:
        before = state_dict_from_jax(params)
        state = create_train_state(model_cfg, train_cfg, device=dev)
        state.model.load_state_dict(before, strict=True)
        one = _dp_steps(state, make_device_target_step(model_cfg, train_cfg, TRAIN_SLOTS),
                        DevicePool(packed, BATCH, train_cfg.seed, dev), dev)
        after = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
        zero_grad = {f"{name}.conv.bias" for name, mod in state.model.named_modules()
                     if isinstance(mod, ConvNorm) and isinstance(mod.norm, BatchNorm)
                     and mod.conv.bias is not None}
        stats = {f"{name}.{leaf}" for name, mod in state.model.named_modules()
                 if isinstance(mod, BatchNorm) for leaf in ("running_mean", "running_var")}
        del state
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        t_eee = time.perf_counter()
        eee_want = _dp_eee_losses(dev, None)
        eee_ms = (time.perf_counter() - t_eee) * 1e3 / DP_EEE_STEPS
        torch.cuda.empty_cache()
        meanwhile()
    finally:
        _wait([ranks_proc], "28(a) ranks")
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"dp_rank{r}.pt"), weights_only=False)
             for r in range(DP_RANKS)]

    for i, want in enumerate(one["losses"]):
        got = [r["losses"][i] for r in ranks]
        print(f"28(a) step {i + 1}: total loss {DP_RANKS} ranks {got[0]['total_loss']:.6f}, "
              f"one process {want['total_loss']:.6f}; ms a step, ranks "
              f"{[round(r['ms'][i], 1) for r in ranks]}, one process {one['ms'][i]:.1f}")
        if any(g != got[0] for g in got):
            raise AssertionError(f"28(a) step {i + 1}: the ranks report different losses")
        for k, v in want.items():
            if not abs(got[0][k] - v) <= DP_LOSS_RTOL * abs(v):
                raise AssertionError(f"28(a) step {i + 1}: {k} {got[0][k]} on {DP_RANKS} "
                                     f"ranks, {v} in one process (rtol {DP_LOSS_RTOL})")
        if any(not torch.equal(r["checksums"][i], ranks[0]["checksums"][i]) for r in ranks):
            raise AssertionError(f"28(a) step {i + 1}: the ranks' states are not bit-equal")
    for r, res in enumerate(ranks):
        for i, n in enumerate(res["launches"]):
            if n["instance_stats"] != 2 or n["encode_initial_masks_batched"] != 1 or \
                    n["encode_initial_masks"] or n["group_pixels"] or n["group_pixels_batched"]:
                raise AssertionError(f"28(a) rank {r} step {i + 1}: launches {n}, expected two "
                                     f"statistics and one batched encode launch")
    cos_w = _update_cosines(before, ranks[0]["state"], after, sorted(trainable - zero_grad))
    cos_s = _update_cosines(before, ranks[0]["state"], after, sorted(stats))
    print(f"28(a): {DP_RANKS} gloo ranks on cuda:0, flagship {H}x{W}, global batch {BATCH}, "
          f"{DP_STEPS} device-target steps from the int8 weights: losses within rtol "
          f"{DP_LOSS_RTOL} of one process on the whole batch at every step; states bit-equal "
          f"across ranks after every step ({len(ranks[0]['checksums'][0])} tensors and "
          f"moments); update cosine against one process: {len(trainable - zero_grad)} "
          f"trainable tensors min {cos_w[0]:.6f} at {cos_w[1]}, {len(stats)} BatchNorm "
          f"statistics min {cos_s[0]:.6f} at {cos_s[1]} (need >= {GRAD_COSINE}); launches a "
          f"rank a step {ranks[0]['launches'][0]}; ms a step (median of {DP_STEPS}) "
          f"{DP_RANKS} ranks {statistics.median(ranks[0]['ms']):.1f}, one process "
          f"{statistics.median(one['ms']):.1f} (both ranks share one card: no scaling figure; "
          f"the one process ran while the ranks started up); the ranks' launch {ranks_s:.1f} s "
          f"on {card}")
    if cos_w[0] < GRAD_COSINE or cos_s[0] < GRAD_COSINE:
        raise AssertionError("28(a): an update disagrees with one process's")

    want = eee_want
    got = ranks[0]["eee"]
    print(f"28(d): train_eee on {DP_RANKS} ranks {[g['total_loss'] for g in got]}, one process "
          f"{[w['total_loss'] for w in want]} (rtol {DP_LOSS_RTOL}), batch {DP_EEE_BATCH} at "
          f"{H}x{W}; ms a step, the first included: {ranks[0]['eee_ms']:.1f} on the ranks, "
          f"{eee_ms:.1f} in one process")
    if any(r["eee"] != got for r in ranks):
        raise AssertionError("28(d): the ranks report different losses")
    for g, w in zip(got, want):
        for k, v in w.items():
            if not abs(g[k] - v) <= DP_LOSS_RTOL * abs(v):
                raise AssertionError(f"28(d): {k} {g[k]} on {DP_RANKS} ranks, {v} in one process")
    return [{name: sum(n[name] for n in r["launches"]) for name in r["launches"][0]}
            for r in ranks]


def _dp_cli_args(work, name, resume):
    h, w = DP_CLI_SIZE
    return ["--synthetic", "--device-targets", "--synthetic-size", "8", "--height", str(h),
            "--width", str(w), "--log-period", "1", "--weights-file", WEIGHTS,
            "--max-iter", str(DP_CLI_STEPS + resume), "--output-dir",
            os.path.join(work, f"dp_cli_{name}")] + (["--resume"] if resume else [])


def _dp_cli_torchrun(work, resume):
    """Starts 28(b)'s run of train_net_torch.py under torchrun (NCCL at world
    size 1): DP_CLI_STEPS steps, or with `resume` one more from its
    checkpoint."""
    log = os.path.join(work, f"dp_cli_torchrun{'_resume' if resume else ''}.log")
    return _torchrun(1, ["train_net_torch.py", *_dp_cli_args(work, "torchrun", resume)], log)


def _dp_cli_alone(work, resume):
    """The same run of train_net_torch.main in this process."""
    import train_net_torch

    train_net_torch.main(_dp_cli_args(work, "alone", resume))


def dp_cli_check(work, card):
    """Phase 28(b): the CLI's losses under torchrun against its losses alone,
    step by step, the resumed step included."""
    with open(os.path.join(work, "dp_cli_torchrun.log")) as f:
        if "world size 1" not in f.read():
            raise AssertionError("28(b): the torchrun run did not train in a process group")
    with open(os.path.join(work, "dp_cli_torchrun_resume.log")) as f:
        if f"resumed at step {DP_CLI_STEPS}" not in f.read():
            raise AssertionError(f"28(b): the torchrun run did not resume at step "
                                 f"{DP_CLI_STEPS}")
    metrics = {}
    for name in ("alone", "torchrun"):
        with open(os.path.join(work, f"dp_cli_{name}", "metrics.jsonl")) as f:
            metrics[name] = [json.loads(line) for line in f]
    got, want = metrics["torchrun"], metrics["alone"]
    if [m["iter"] for m in got] != list(range(1, DP_CLI_STEPS + 2)) or \
            [m["iter"] for m in want] != [m["iter"] for m in got]:
        raise AssertionError(f"28(b): logged steps {[m['iter'] for m in got]}")
    for g, m in zip(got, want):
        for k, v in m.items():
            if k != "iter" and not abs(g[k] - v) <= DP_CLI_RTOL * abs(v):
                raise AssertionError(f"28(b) step {m['iter']}: {k} {g[k]} under torchrun, {v} "
                                     f"alone (rtol {DP_CLI_RTOL})")
    h, w = DP_CLI_SIZE
    print(f"28(b): train_net_torch.py under torchrun (NCCL, world size 1) and alone (main() in "
          f"this process), {h}x{w}, batch {BATCH}, {DP_CLI_STEPS} steps then --resume for one "
          f"more: total loss {[round(m['total_loss'], 6) for m in got]} both, within rtol "
          f"{DP_CLI_RTOL} on {card}")


def dp_serve(params, frames, batch_out, card):
    """Phase 28(c): predict_batch_stream and _staged on a two-replica mesh on
    cuda:0 over phase 7's frames at B = BATCH. Returns the launches and a
    function that prints the frames/s of the two paths."""
    from quber_tpu_torch.ops import kernels
    from quber_tpu_torch.parallel.mesh import make_mesh
    from quber_tpu_torch.predictor import MaskRefinerPredictor

    predictor = MaskRefinerPredictor(params=params, device="cuda")
    mesh = make_mesh(["cuda:0"] * DP_RANKS)
    sub = BATCH // DP_RANKS
    # what each replica computes: predict_batch on its sub-batch of each
    # (padded) batch
    want = []
    for i in range(0, len(frames), BATCH):
        b = frames[i:i + BATCH]
        b = b + [b[0]] * (BATCH - len(b))
        out = sum((predictor.predict_batch(b[j:j + sub]) for j in range(0, BATCH, sub)), [])
        want += out[:min(BATCH, len(frames) - i)]
    n_batches = -(-len(frames) // BATCH)

    def staged_run(staged):
        return list(predictor.predict_batch_stream_staged(staged, prefetch=2, mesh=mesh))

    def stream_run():
        return list(predictor.predict_batch_stream(iter(frames), BATCH, prefetch=2, mesh=mesh))

    kernels.reset_launch_counts()
    staged = predictor.stage_frames(frames, BATCH, mesh=mesh)
    got_staged = staged_run(staged)
    launches = _launch_counts()
    _check_launches("28(c) staged on the mesh", launches, n_batches * DP_RANKS)
    kernels.reset_launch_counts()
    got_stream = stream_run()
    _check_launches("28(c) streamed on the mesh", _launch_counts(), n_batches * DP_RANKS)
    for path, got in (("mesh staged", got_staged), ("mesh streamed", got_stream)):
        _same_outputs(f"28(c) {path} against predict_batch on the replicas' sub-batches",
                      got, want)
        agree = [float((g[0] == b[0]).mean()) for g, b in zip(got, batch_out)]
        counts = all(g[1] == b[1] for g, b in zip(got, batch_out))
        print(f"28(c) {path} against phase 7's predict_batch at B = {BATCH}: counts equal "
              f"{counts}, panoptic agreement min {min(agree):.6f}, max |score difference| "
              f"{max(float(np.abs(g[2] - b[2]).max()) for g, b in zip(got, batch_out)):.3g}")
        if not counts or min(agree) < PANOPTIC_AGREEMENT:
            raise AssertionError(f"28(c) {path}: the outputs differ from predict_batch's")

    def fps(fn):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return len(frames) / statistics.median(times)

    def rates():
        print(f"28(c): {DP_RANKS} replicas on cuda:0, {len(frames)} frames at B = {BATCH} "
              f"({sub} a replica): staged {fps(lambda: staged_run(staged)):.3f} frames/s, "
              f"streamed {fps(stream_run):.3f} frames/s (phase 8's lines above: one replica "
              f"at B = {BATCH}) on {card}")

    return launches, rates


def dp_phase(params, frames, batch_out, dev, card, work):
    """Phase 28: data parallelism on the card. 28(b)'s first torchrun run
    starts beside 28(a)'s ranks, and its run alone goes while they start up
    (the CLI's GPU work is 2 steps at 240x320); 28(c)'s frames/s are taken
    last, on a card that serves nothing else."""
    t0 = time.perf_counter()
    cli = _dp_cli_torchrun(work, resume=False)
    try:
        train_launches = dp_train(params, dev, card, work,
                                  meanwhile=lambda: _dp_cli_alone(work, resume=False))
    finally:
        _wait([cli], "28(b) the CLI under torchrun")
    serve_launches, rates = dp_serve(params, frames, batch_out, card)
    cli = _dp_cli_torchrun(work, resume=True)
    try:
        _dp_cli_alone(work, resume=True)
    finally:
        _wait([cli], "28(b) the CLI under torchrun, resumed")
    dp_cli_check(work, card)
    rates()
    print(f"phase 28: {time.perf_counter() - t0:.1f} s on {card}")
    return train_launches, serve_launches


def _elapsed(what):
    print(f"[{time.perf_counter() - _T0:.1f} s] {what} done", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from quber_tpu_torch.ops import kernels  # fails outside a checkout of the repo

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    card = f"{torch.cuda.get_device_name(0)} ({smi.splitlines()[0].split(',')[-1].strip()} limit)"

    t0 = time.perf_counter()
    kernels.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({kernels.library_path().name})")

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    floor_ms = _time_ms(lambda: kernels.empty_launch(dev), flush)
    print(f"floor_ms {floor_ms:.6f}: an empty kernel through the same launch path and timing "
          f"(median of 30) on {card}")
    rows, stats_row = check_kernels(dev, flush)
    del flush
    check_edge_cases(dev)

    params, frames, results, times, launches = serve_frames(dev)
    served = (frames, results)
    for row in rows + [stats_row]:
        row["launches"] = launches[row["name"]]
        row["kernel_ms"] = row["ms"]
        row["bound_us"] = row["bound_ms"] * 1e3
    cpu_parity(params, frames[0], results[0])

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    batched_rows, stats_b8 = check_batched_kernels(dev, flush)
    del flush
    batched_launches, _, batched_frames, batched_out = serve_batched(params, card)
    for row in batched_rows:
        row["launches"] = batched_launches[row["name"]]
        row["kernel_ms"] = row["ms"]
        row["bound_us"] = row["bound_ms"] * 1e3
    # one statistics wrapper serves both paths: its row holds B = 1 and B = 8
    stats_b8["launches"] = batched_launches["instance_stats"]
    stats_row["b8"] = stats_b8
    rows += batched_rows + [stats_row]
    for row in rows:
        row["floor_ms"] = floor_ms
    multiscale(params)
    _elapsed("phases 1-9")
    with tempfile.TemporaryDirectory() as work:
        trained_dir, trained = train_phases(params, rows, floor_ms, dev, card, work)
        torch.cuda.empty_cache()
        _elapsed("phases 10-13")
        root, masks_f32, frames, initial = evaluation_phase(params, rows, card, work)
        _elapsed("phase 14")
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        serving_cases = check_serving_kernels(dev, flush)
        del flush
        _elapsed("phase 15")
        bf16_evaluation(params, root, masks_f32, frames, card)
        _elapsed("phase 16")
        checkpoint_evaluation(trained_dir, trained, root)
        del trained
        _elapsed("phase 17")
        single, batched = cli_phase(params, root, frames, card)
        _elapsed("phase 18")
        torch.cuda.empty_cache()
        bench_launches = bench_phase(frames, initial)
        _elapsed("phase 19")
        torch.cuda.empty_cache()
        ablation_launches = ablation_phase(frames, initial, dev, card)
        _elapsed("phase 20")
        torch.cuda.empty_cache()
        ucn_launches = ucn_phase(root, params, frames, dev, card, work)
        _elapsed("phase 21")
        torch.cuda.empty_cache()
        file_launches = file_phase(root, params, dev, card, work)
        _elapsed("phase 22")
        torch.cuda.empty_cache()
        zoo_launches = zoo_phase(root, params, frames, dev, card, work)
        _elapsed("phase 23")
        torch.cuda.empty_cache()
        zoo_launches["uoisnet3d"] = zoo2_phase(root, params, frames, dev, card, work)
        _elapsed("phase 24")
        torch.cuda.empty_cache()
        zoo_launches.update(sam_phase(root, params, frames, initial, dev, card, work))
        _elapsed("phase 25")
        torch.cuda.empty_cache()
        zoo_launches.update(openvocab_phase(root, params, frames, dev, card, work))
        _elapsed("phase 26")
        torch.cuda.empty_cache()
        import_launches = seam_phase(params, served, frames, card, work)
        _elapsed("phase 27")
        torch.cuda.empty_cache()
        dp_train_launches, dp_serve_launches = dp_phase(params, batched_frames, batched_out,
                                                        dev, card, work)
        _elapsed("phase 28")
    # the serving shapes' entries: launches on the single-frame CLI path
    # (predict, K = 24) and on the benchmark's batches of 16
    for row in rows:
        entries = serving_cases.get(row["name"], {})
        for case, entry in entries.items():
            single_frame = not case.startswith("b")
            entry["launches"] = (single if single_frame else bench_launches)[row["name"]]
            entry["path"] = "predict_torch config, predict()" if single_frame else \
                f"bench_torch, {BENCH_FRAMES} frames in batches of {BENCH_BATCH}"
            entry["floor_ms"] = floor_ms
        if entries:
            row["serving"] = entries
        # the launches of the ablation variants' predict() (phase 20) and of
        # the UCN -> refiner evaluation per image and streamed (phase 21)
        name = row["name"]
        row["ablation"] = {"launches": ablation_launches[name],
                           "path": f"predict() of {len(ABLATION_CONFIGS)} variants, 1 frame each"}
        row["ucn_eval"] = {"launches_per_image": ucn_launches[0][name],
                           "launches_streamed": ucn_launches[1][name],
                           "path": f"run_eval, base ucn, {EVAL_FRAMES} frames"}
        # the launches of the device-target steps from files (phase 22(b))
        row["file_train"] = {"launches": file_launches[name],
                             "path": f"{FILE_STEPS} device-target steps from UOAIS-Sim files"}
        # the MSMFormer / UOAIS-Net / UOIS-Net-3D / SAM / Detic /
        # GroundedSAM -> refiner evaluations (phases 23(c)-26(c))
        # predict() of phase 4's frames with the flagship imported from a
        # detectron2 .pth (phase 27(a))
        row["import"] = {"launches": import_launches[name],
                         "path": f"predict() of {N_FRAMES} frames, flagship from the import CLI"}
        # the data-parallel launches of phase 28: each rank's over its
        # device-target steps (a process counts its own), and the serving
        # mesh's over its replicas' sub-batches
        row["dp_train"] = {"launches_per_rank": [n[name] for n in dp_train_launches],
                           "path": f"{DP_STEPS} device-target steps on {DP_RANKS} gloo ranks "
                                   f"sharing cuda:0, global batch {BATCH}"}
        row["dp_serve"] = {"launches": dp_serve_launches[name],
                           "path": f"predict_batch_stream_staged on a {DP_RANKS}-replica mesh, "
                                   f"{N_SERVE} frames at B = {BATCH}"}
        row["zoo_eval"] = {base: {"launches_per_image": n[0][name],
                                  "launches_streamed": n[1][name],
                                  "path": f"run_eval, base {base}, {EVAL_FRAMES} frames"}
                           for base, n in zoo_launches.items()}

    steady = times[1:]
    med = statistics.median(steady)
    print(f"frame times ms: {[round(t, 3) for t in times]}")
    print(f"end-to-end predict() at {H}x{W}, int8 flagship weights: median {med:.3f} ms/frame "
          f"over frames 2-{N_FRAMES} ({1e3 / med:.2f} FPS) on {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2]))
    sys.exit(main())
