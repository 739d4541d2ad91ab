#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``cvssl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card. Builds the kernels from the CUDA sources in this
checkout with ``nvcc`` into ``build/kernels`` (one ``nvcc`` per source, all
started at once in the background), then runs, in order; any failure ends
the run with a non-zero exit:

1. device: CUDA must be available; prints the card's name and power limit,
   and whether ``h5py`` and ``PIL`` are installed (the fit phase needs no
   ``h5py``; CTAugment's ops are PIL's);
2. kernels against their plain version: the fused CE+Dice forward and
   backward (``csrc/fused_ce_dice.cu``) on the card at the main-path shape
   (12, 4, 256, 256), the CNN+ViT methods' (8, 4, 224, 224), a ragged
   (3, 4, 37, 41), the main shape at an
   unaligned storage offset, and 2 and 16 classes (3, 2, 37, 41) and
   (2, 16, 64, 64); f32 and bf16 logits, int32 and uint8 labels,
   cotangents 0.3 / 1.7, held against ``ce_dice_plain`` run on the card in
   float64, and each kernel bit-equal across two calls; then each kernel's
   time beside its plain version's and its bound (also from a clean and a
   warm L2), the event timer's floor (an empty kernel) and the host's time
   per call;
3. the main path at full width: mean-teacher UNet (1,813,764 parameters),
   batch 24 = 12 labeled + 12 unlabeled at 256^2, 4 classes, dtype auto
   (bf16), from a device-resident store of 1312 synthetic ACDC-shaped
   slices; 10 steps from step 0 and 10 from step 1000 with every kernel's
   launch count rising by exactly one per step; then slices/s and peak
   memory, one more step's FLOPs (``utils/mfu.py::per_step_flops``,
   ``FlopCounterMode``) and its MFU against the card's dense bf16 peak at
   the timed step time, a short profile of where the step's device time
   goes, and a
   ``torch.profiler`` trace of kernel #1 that must count one device kernel
   per forward and per backward call (no profiler runs before the step
   loop's throughput: a session slows later launches on the host);
4. eval forward: ``predict_fn`` on a batch, and the eval-mode forward in
   float32 on the card against the same model on the CPU;
5. the other 2D methods at full width on phase 3's store (batch 24 =
   12 + 12, 256^2, dtype auto: bf16 for the plain UNet, float32 for the
   UNet variants and the discriminator, as in JAX): first where the
   mean-teacher step makes the host wait (``torch.cuda``'s sync debug
   mode, "warn"); then for each of uamt, ict, deep_co_training, cps, cct,
   urpc, fixmatch (on its own ``weak_strong`` store over the same slices),
   adversarial, exam_student_teacher and contrastive_cross's CNN variant
   (two UNets and four contrastive heads, on its own ``weak`` store) its
   models' parameter counts (UNet 1,813,764, UNetCCT 3,713,664, UNetURPC
   1,821,840, FCDiscriminator 2,762,754, Projector 1,512, Classifier
   7,272), 5 steps from step 0 and 5 from step 1000 with kernel #1
   launched 1, 1, 1, 2, 4, 4, 1, 1, 1, 2 times a step (forward and
   backward),
   finite losses, a live consistency term after step 1000 (for cps: its
   pseudo-supervision term, recomputed from the other model's argmax; for
   fixmatch its unsupervised term), the teachers (uamt, ict, fixmatch,
   exam), both models (cps, contrastive_cross) and the discriminators
   moved, the heads' weights not (they are in no optimizer) and their
   BatchNorm statistics moved, slices/s and
   peak memory over 20 steps, and a short profile of each method's step
   (device busy time per step); every method's checked steps run under the
   sync debug mode "error" if the mean-teacher step made no synchronising
   call. uamt's output conv is scaled by 8 so that its MC teacher is sure
   somewhere;
5b. north-star config 4's CNN+ViT methods, cross_teaching, cnn_meet_vit,
   tripleview, adversarial_consistency and contrastive_cross: a UNet and
   SwinUnet-tiny (27,168,420 parameters; two UNets for tripleview;
   SwinUnet alone as ``model`` with the float32 FCDiscriminator for
   adversarial_consistency; the four heads beside the two models for
   contrastive_cross) at full width, batch 16 = 8 + 8 at 224^2, dtype auto
   (bf16 for both), from their own store of the same synthetic slices at
   224^2 (contrastive_cross: a ``weak`` store of them); the same checks and
   numbers as phase 5 for each, kernel #1 launched 2, 2, 3, 1 and 2 times a
   step, every model (and the teachers) moved, the Dice pseudo-supervision
   after step 1000 recomputed from the other model's argmax with a plain
   float64 Dice; then the SwinUnet's predictions and its eval forward in
   float32 on the card against the CPU; then north-star config 3:
   SwinUnet-tiny (27,168,228 parameters at 2 classes) fully supervised and
   with uamt (T = 8), batch 16 = 8 + 8 at 224^2, from a 2-class store of
   the synthetic slices, the same checks and numbers, kernel #1 once each
   way a step, uamt's teacher moved and its masked consistency live (its
   output projection scaled by 8), and its Monte-Carlo teacher counted:
   one pass over the T * u tiled batch a step, no scan;
6. the pixel-packed conv kernels (``ops/conv3x3_p8.py``, CUDA): each of the
   three against the plain version run on the card in float64 at
   (24, 256, 256, 16) f32 and bf16 input (tile_h 32), at the JAX tests'
   (2, 32, 32, 16) and (1, 64, 48, 16) f32 (tile_h = H/2), and at a ragged
   (2, 32, 40, 16) f32 and bf16 (tile_h 16; W % 16 = 8) and (1, 45, 40,
   16) f32 (tile_h 3: an odd number of odd row tiles), within 1e-5 of
   the output's largest element, and each kernel bit-equal across two
   calls at the full shape, f32 and bf16 input; then
   each one's time (f32 and bf16 input) beside the plain version's, the
   bound (bytes against operations at the dense TF32 rate, for each input
   type) and ``F.conv2d``'s time (channels-last f32, TF32 off); then their
   own path: each function once at each of those cases, launch counts
   from 0. ``--conv-only`` builds the conv source alone and runs only this
   phase;
7. ``fit`` at full width through the port's API: mean-teacher UNet, batch
   24 = 12 + 12, 256^2, 4 classes, dtype auto, on in-memory blob data of
   ACDC's geometry (1312 train slices, 136 labeled; 20 val volumes of
   10 x 256^2, so validation runs resident on the card); 200 iterations
   with val and checkpoints every 100 into a temporary snapshot
   directory, then a second ``fit`` to 300 that must resume from 200; the
   checkpoint files, the val table, the fused kernel's launches (one per
   iteration), slices/s including validation and checkpoints, the val
   pass's time and the EDT's peak memory; then ``fit`` of cps on the same
   data, 100 iterations with val and checkpoints every 50: the dual-model
   checkpoint files (``model1_``/``model2_`` prefixes,
   ``unet_best_model1.ckpt``, no EMA files), two launches of each kernel an
   iteration; then ``fit`` of fixmatch, 100 iterations with one
   validation and one checkpoint, through the store's ``weak_strong``
   mode; then ``fit`` of cross_teaching at config 4's size on the same
   train slices and val volumes at 224^2, 100 iterations with val and
   checkpoints every 50: both slots validated (model2 at ``patch_size2``),
   the dual-model files, two launches of each kernel an iteration; then the
   host data path: the host's time to transform and collate a batch, a
   few mean-teacher steps from the host pipeline's pinned batches (under
   the sync debug mode "error" where phase 5 ran so), and a 100-iteration
   mean-teacher ``fit`` with ``device_data=False`` on cell 2's data (one
   validation, one checkpoint, its slices/s beside the store path's);
   then ``fit`` of contrastive_cross at config 4's size, 100 iterations,
   both slots validated, its files; then contrastive_consistency on the
   host CTA path at the reference's recipe (two SwinUnet-tiny and four
   projector heads, batch 16 = 8 + 8 at 224^2, CTAugment on the host): the
   host's time to transform and collate a CTA batch, a few steps from the
   pipeline with the method's policies, through ``fit``'s own iteration
   (``cta_iteration``: the hooks in JAX's order; under sync debug mode
   "error" where phase 5 ran so) and their ms/step, then a 68-iteration
   ``fit`` (4 epochs, one validation of both slots, one checkpoint):
   kernel #1 twice each
   way an iteration, the policy refreshes, the CTA rates moved,
   projector1/2 tracking projector3/4, whose weights stay, peak memory
   and slices/s;
8. the 3D path, north-star config 5 (UAMT-3D on unet_3D, batch 4 = 2 + 2
   at 96^3, 2 classes, dtype auto): kernel #1 at (2, 2, 96, 96, 96) and a
   ragged (2, 2, 17, 19, 23), f32 and bf16 logits, int32 and uint8
   labels, against float64 and bit-equal on repeat, and its time at
   config 5's shape beside its plain version and bound; a device store
   (``DeviceVolumeStore``) of 250 volumes of 140 x 180 x 180 (BraTS2019's
   train count) drawn on the card; UAMT-3D (5,884,050 parameters), 10
   steps from step 0 and 10 from step 1000 under the sync debug mode
   "error" where phase 5 ran so, kernel #1 once each way a step, exactly
   one teacher pass over the (T + 1) * u = 18 volumes a step (counted),
   the teacher moved, the masked consistency live (output conv x8), then
   volumes/s over 30 steps, peak memory, one more step's FLOPs and MFU
   (as phase 3's) and a one-step profile; the same
   for supervised, mean_teacher, cps, ict, adversarial and
   exam_student_teacher (FC3DDiscriminator, 11,024,386 parameters; kernel
   #1 launched 1, 1, 2, 1, 1, 1 times a step, none in the discriminator
   phase), 5 + 5 checked steps and 10 timed each; UNet3DDeepSup's f32
   eval heads on the card against the CPU; the sliding window on 5
   volumes of 140 x 180 x 180 (18 windows each, pipelined; volumes/s, and
   the MFU of a volume's ``last_flops`` at that rate), and
   a net that thresholds each voxel through it, exactly; a UAMT-3D
   ``fit`` of 100 iterations (one validation of 4 volumes of mixed shapes,
   one under the patch; one checkpoint), then a resume to 150: files, the
   val table, kernel #1's launches, volumes/s, the val pass and the
   host's HD95 share of it; and the 3D host path (``device_data=False``:
   the host's time per batch, 3 steps from pinned batches). Each part's
   seconds are printed. ``--3d-only`` builds the CE+Dice source alone and
   runs only this phase (its steps under "error");
9. the held-out test path and the 3D CNN zoo: the 2D test CLI
   (``eval/test_2d.py``, ``--full_metrics``) with phase 7's
   ``unet_best_model.ckpt`` on 40 ACDC-shaped volumes of 10 slices at
   mixed in-plane sizes (232 x 256, 256 x 216, 154 x 224, 428 x 512),
   exports to a temporary directory, one case's three files read back
   with ``load_nifti`` (the prediction equal to the predictor's), the
   seconds a volume in zoom in, predict, zoom out, metrics and export;
   the 3D test CLI (``eval/test_3d.py``) with the UAMT-3D fit's weights
   on 10 volumes of 140 x 180 x 180 (patch 96^3, stride 64, full metrics,
   export): ``metrics.txt`` parsed, one case's files read back,
   volumes/s and the host's share in metrics and export; kernel #1 at
   nnUNet's (2, 2, 96, 128, 128) float32 with int32 labels against
   float64, bit-equal on repeat, and its time there; then mean_teacher at
   config 5's recipe (batch 4 = 2 + 2, 2 classes, float32) on VNet
   (9,448,866 parameters), VoxResNet (1,992,578) and AttentionUNet3D
   (6,469,328) at 96^3 from a store of the 250 volumes, and nnUNet
   (30,444,656) at 96 x 128 x 128 from the host pipeline (the store's
   rot90 follows the crop and needs the patch's first two sides equal;
   ``fit`` takes the host path for it too): 5 + 5 checked steps
   (kernel #1 once each way a step; under "error" where phase 5 ran so),
   10 timed, a one-step profile, its eval softmax summing to 1, the
   sliding window over one volume, and its float32 eval forward on the
   card against the CPU on one window; then 2D nnUNet (7,388,496
   parameters) with mean_teacher at config 2 (batch 24 = 12 + 12 at
   256^2, 4 classes, float32), 5 + 5 checked and 10 timed. Each part's
   seconds are printed. ``--test-zoo-only`` builds the CE+Dice source
   alone and runs this phase on the weights of two short fits;
10. the 3D ViTs at ``train_fully_supervised_3D_ViT``'s recipe
   (supervised, batch 4, 2 classes, float32): kernel #1 at UNETR's (4, 2,
   96, 96, 96) and SwinUNETR's (4, 2, 64, 64, 64) float32 with int32
   labels against float64, bit-equal on repeat, and its times there;
   UNETR (92,783,842 parameters) at 96^3 and SwinUNETR (62,186,708) at
   64^3 from a store of the 250 volumes (batches of the 25 labeled): 5 + 5
   checked steps (kernel #1 once each way a step; under "error" where
   phase 5 ran so), 10 timed, a one-step profile, the eval softmax
   summing to 1, the sliding window over one volume and the float32 eval
   forward on one window against the CPU; then a supervised UNETR
   ``fit`` of 40 iterations (one validation over 2 volumes, one
   checkpoint) and the 3D test CLI with ``--model unetr`` on its weights
   over 2 volumes (``metrics.txt`` parsed, the exports present). Each
   part's seconds are printed. ``--vit3d-only`` builds the CE+Dice source
   alone and runs only this phase;
11. the rest of the 2D zoo at north-star config 2's recipe
   (mean_teacher, batch 24 = 12 + 12 at 256^2, 4 classes, float32, as
   JAX's ``model_kwargs`` gives these nets no dtype): ENet (349,284
   parameters), PNet2D (486,596), EffiUNet-B3 (12,566,060) and PreUNet
   on Res2Net-101 (55,581,692) from a store of 1312 ACDC-shaped slices:
   5 + 5 checked steps (kernel #1 once each way a step; under "error"
   where phase 5 ran so), 10 timed, a one-step profile, the eval softmax
   summing to 1 and the float32 eval forward on the card against the CPU;
   then ``--pretrained_ckpt`` through the CLI's config and ``fit`` on
   files written from a seed under the published schemas (PreUNet with a
   Res2Net-101 v1b file and EffiUNet with an EfficientNet-B3 file at
   config 2, cross_teaching's UNet + ``ViT_Seg`` with a Swin-tiny file at
   config 4): after init the encoders of the student and of its teacher
   are the file's and cross_teaching's UNet is as without the file; a fit
   of 20 iterations (one validation, one checkpoint) with kernel #1's
   launches counted; then ``test_2d --model efficient_unet`` on the
   EffiUNet fit's weights over 4 of phase 9a's volumes (the per-class
   table, the exports present). Each part's seconds are printed.
   ``--zoo2d-only`` builds the CE+Dice source alone and runs only this
   phase;
12. the step-window profiler on the main path, last, since a profiler
   session slows every later launch on the host: ``fit`` at config 2 on
   the store for 25 iterations with ``profile_dir`` in a temporary
   directory (no validation, no checkpoint), one ``*.pt.trace.json``
   written there, kernel #1's forward and backward device kernels in it
   once each for every step of the window (steps 11-20), the window's
   device time a step from the trace and the fit's slices/s (profiled,
   not a throughput); then ``measure_fp_bp_time`` on the config-2 UNet.
   ``--profile-only`` builds the CE+Dice source alone and runs only this
   phase;
13. data parallelism across processes (``parallel/``; run before phase
   12, which must come last), every rank on the one card: (a) two gloo
   ranks (NCCL refuses two ranks on one card) run config 2's mean-teacher
   steps at full width (batch 24 split 12 + 12 in every model call, the
   outputs gathered; kernel #1 once each way a step in each rank, on the
   gathered (12, 4, 256, 256) labeled logits), 5 steps from step 1000 in
   float32 (TF32 off), each step's metrics within rel 1e-4 and every
   parameter, buffer and EMA teacher leaf within 1e-4 of one process's
   on the same card from the same seed, and 5 in bf16 with the largest
   differences printed (cuDNN may pick other bf16 algorithms at batch 12
   than at 24); each rank's ms/step, which is a correctness run of two
   ranks sharing one card and not a scaling number; (b) ``torchrun
   --nproc_per_node 1`` of this script's ``--par-cli-fit`` child, which
   runs the CLI (``train/cli.py::main``) with ``--distributed`` on nccl
   on in-memory data (the card machine has no ``h5py``): config 2's
   mean-teacher fit of 20 iterations, validated at 10 and 20 and
   checkpointed at 20, against the same fit without ``--distributed``
   (with one rank every collective is the identity) and a second plain
   fit: the same files, every non-floating checkpoint tensor (the
   generator's state among them) equal, the floating ones within 10x the
   two plain fits' largest difference (bit-equal where they are; the
   card's step is not bit-reproducible: the bilinear upsample's backward
   adds with atomics); (c) ``ShardedSlidingWindowEvaluator`` on the two
   ranks over one volume of config 5's 140 x 180 x 180 (96^3 windows, 18 of
   them, stride 64; config 5's UNet3D from seed 0, float32 softmax)
   against the single-rank ``SlidingWindowEvaluator``: at most 1e-5 of
   the voxels may differ (an exact tie summed in another order); (d)
   ``sharded_unet3d_forward`` on the two ranks at (1, 1, 96, 192, 96)
   float32 against the whole eval forward, max abs error 1e-4; (e)
   ``dryrun_multichip(2, "cuda")`` (JAX's six checks). A failed rank or
   child fails the smoke. ``--parallel-only`` builds the CE+Dice source
   alone and runs only this phase;
14. K steps a call as CUDA graphs (``Engine.train_steps_scan`` on the
   store, ``train_steps_fixed`` on one batch; run before phase 12): each
   graphed run starts from a copy of one state, beside three eager runs
   from the same copy, in chunks that each start at a given step (every
   run jumps alike); step, optimizer counts and the generator's state
   bit-equal to eager; the parameters and the buffers of the models and
   of the teachers, and the losses, of the graphed run each within 10x
   the largest difference between two eager
   runs (the card's step is not bit-reproducible), or within 5e-5 of the
   largest value (the eager runs at the reduced size often agree and
   then differ sporadically by up to 5.7e-6 of it), kernel #1's host
   launches printed (warm-ups and captures only). (a) config 2's
   mean_teacher at full width, 2 chunks of K = 10 from step 995, so the
   chunks cross its step-1000 graph key (2 graphs); (b) config 4's
   cross_teaching (a UNet and SwinUnet-tiny, batch 16 at 224^2), one
   chunk of 10; (c) UAMT-3D at config 5 through ``train_steps_fixed``
   with K = 10 on one random batch (``bench.py:296-336``'s record); each
   timed graphed and eager in calls of 10 (slices/s or volumes/s,
   ms/step, peak memory), then, after all three timed windows, one call
   of each profiled: the busy share, and kernel #1's device kernels in
   the graphed call exactly K + K (2K + 2K for cross_teaching); (d) the
   14 other 2D store-path methods (batch 8 = 4 + 4 at 64^2, SwinUnet
   thinned) and the 6 other 3D ones (batch 4 = 2 + 2 at 32^3), with a
   consistency ramp of one epoch, in chunks where the step's host values
   turn: from step 0 (the EMA decay 0, 1/2, 2/3, ...), across 150 (the
   ramp's staircase, uamt's threshold) and across 1000 (the graph key);
   (e) config 2's mean_teacher ``fit`` with the CLI's flags and
   ``--scan_steps 10`` over 30 iterations, validated every 15 and
   checkpointed every 10 (chunks of 10, 5, 5, 10), stopped at 20 and
   resumed on the same engine (graphs and pool dropped, captured anew),
   against two ``cli.main`` fits with ``--scan_steps 1``: the same step,
   counts, generator and files, the checkpoints within 10x the plain
   fits' spread, kernel #1 2 + 2 host launches a capture and one device
   kernel each way a step in the trace of steps 11-20. Every graphed
   call of (a)-(d) runs under sync debug mode "error" (warm-up and
   capture included: the capture does not synchronise).
   ``--graph-only`` builds the CE+Dice source alone and runs only this
   phase;
15. the library modules no training path calls, float32 with TF32 off
   (run after phase 14, before phase 12): (a) ``define_g(1, 64,
   "resnet_9blocks")`` (11,657,601 parameters), ``define_g(1, 64,
   "unet_256")`` (54,407,809) and ``define_d(64, "basic")`` (2,763,585)
   from seed 15; 5 timed LSGAN steps (after one warm-up) of each
   generator against the discriminator at batch 4, 256^2 (G forward, D
   on the fake and on the real, ``gan_loss`` both ways, backward, a
   ``DiscriminatorAdam`` each), finite losses and both nets moved, ms/step
   and peak memory; then each net's eval forward on the card against the
   same weights on the CPU on two samples, within 1e-4 of the largest
   output; (b) ``SCSEModule(16)`` on the card against the CPU at (24, 16,
   256, 256) and (2, 16, 96, 96, 96), within 1e-5; (c) ``init_weights``
   of each type (xavier, kaiming, orthogonal, normal) on config 2's UNet
   with a CUDA generator: every bias exactly 0, each BatchNorm scale's
   mean within 0.05 of 1, each kernel of 2,000 elements or more at JAX's
   std (normal within 0.005 of 0.02, the others within 10%, fans on the
   Flax shape) or orthonormal to 1e-4; then 5 mean-teacher steps at
   config 2 from the "normal" re-init (the teacher a copy of it): finite
   losses, kernel #1 1 + 1 a step by its counts and in a one-step
   profile; (d) the host ms per 256^2 sample of ``RandomGeneratorStrong``
   and ``RandomGenerator`` from a synthetic ACDC slice (median of 20).
   Each part's seconds are printed, and the phase's against its 45 s
   bound. ``--gan-only`` builds the CE+Dice source alone and runs only
   this phase;
16. the program's spans and step phases (``utils/tracing.py``), run after
   phase 15, before phase 12: (a) config 2's mean_teacher from the slice
   store and (b) UAMT-3D at config 5 from the volume store of 250
   volumes, each from step 25000: a graphed call of 10 steps, then the
   phases (``gather``, ``forward``, ``teacher``, ``backward``,
   ``update``) read from the last replay's event nodes, each positive;
   an eager step's phases; a profiled graphed call whose last replay's
   ``gather + forward + backward + update`` lies within 5% of a replay's
   device time (the call's busy time over its replays); no device
   operation of either trace named as a phase; (c) UNet3D's sliding
   window as ``Engine.validate`` builds it, 6 hand-overs of 140 x 180 x
   180 volumes at depth 2 under the profiler, each in a user annotation:
   one ``val3d.predict`` span a volume covering 95% of its hand-over,
   one ``val3d.forward`` and two ``val3d.accumulate`` a batch of
   windows, none on the device; host ms a volume of each. A graph's
   events that ``elapsed_time`` cannot read end the phase.
   ``--tracing-only`` builds the CE+Dice source alone and runs only this
   phase;
17. one JSON line of the kernels (kernel #1's with its launches in each
   method's run of phases 5, 5b, 8, 9, 10 and 11, in each rank of phase
   13a (``mean_teacher_rank{r}_of_2``, its 10 steps), in each graphed
   call profiled in phase 14 (``mean_teacher_graphed``,
   ``cross_teaching_graphed``, ``uamt_3d_graphed``: device kernels of 10
   replays) and in the trace of 14e's graphed fit
   (``mean_teacher_graphed_fit``), in phase 15c's steps
   (``mean_teacher_init_weights``), and in the
   contrastive_consistency, UAMT-3D, UNETR, pretrained and profiled
   (``mean_teacher_profiled_fit``) ``fit``s; phase
   5b's
   contrastive_cross as ``contrastive_cross_vit``, config 3's methods as
   ``supervised_swin`` and ``uamt_swin``, phase 8's with ``_3d``, phase
   9's as ``mean_teacher_vnet_3d`` ... ``mean_teacher_nnunet_2d``, phase
   10's as ``supervised_unetr_3d``, ``supervised_swinunetr_3d`` and
   ``unetr_fit``, phase 11's as ``mean_teacher_enet`` ...
   ``mean_teacher_preunet`` and ``mean_teacher_preunet_pretrained_fit``,
   ``mean_teacher_efficient_unet_pretrained_fit`` and
   ``cross_teaching_vit_seg_pretrained_fit``; under ``at_5d`` its error
   and times at config 5's shape, under ``at_nnunet`` at nnUNet's, under
   ``at_unetr`` and ``at_swinunetr`` at the ViTs'), then the result line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import glob
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ACDC_TRAIN_SLICES = 1312
ACDC_LABELED_SLICES = 136
BATCH, LABELED_BS, PATCH, CLASSES = 24, 12, 256, 4
MAIN_SHAPE = (LABELED_BS, CLASSES, PATCH, PATCH)
RAGGED_SHAPE = (3, CLASSES, 37, 41)
# the 2-class datasets, and the most classes the kernels take
OTHER_CLASSES = (((3, 2, 37, 41), "float32", "int32"),
                 ((2, 16, 64, 64), "bfloat16", "uint8"))
COTANGENTS = (0.3, 1.7)
FWD_REL_TOL = 1e-5
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
# near-zero gradient elements need an absolute floor: 1e-5 of the largest
GRAD_ATOL_OF_MAX = 1e-5
# timed steps of phases 3, 5 and 5b (20, so that the whole smoke keeps
# well inside its time limit)
MEASURE_STEPS = 20
CONV_CASES = (((24, 256, 256, 16), "float32", 32),
              ((24, 256, 256, 16), "bfloat16", 32),
              ((2, 32, 32, 16), "float32", 16),
              ((1, 64, 48, 16), "float32", 32),
              # W % 16 = 8: the last 16-pixel strip is half outside
              ((2, 32, 40, 16), "float32", 16),
              ((2, 32, 40, 16), "bfloat16", 16),
              # 15 row tiles of 3 rows: an odd count, and an odd tile_h
              ((1, 45, 40, 16), "float32", 3))
CONV_REL_TOL = 1e-5        # of the float64 output's largest element
FIT_VAL_VOLUMES, FIT_VAL_SLICES = 20, 10
FIT_STEPS, FIT_RESUME_STEPS, FIT_EVERY = 200, 300, 100
# the other UNet-family 2D methods: kernel #1's forward (and backward)
# launches per step of each
METHOD_LAUNCHES = {"uamt": 1, "ict": 1, "deep_co_training": 1, "cps": 2,
                   "cct": 4, "urpc": 4, "fixmatch": 1, "adversarial": 1,
                   "exam_student_teacher": 1, "contrastive_cross": 2}
# config fields of a method beyond method_config's: contrastive_cross's
# CNN variant
METHOD_KW = {"contrastive_cross": {"model2": "unet"}}
METHOD_STEPS = 5               # from step 0, and again from step 1000
MODEL_PARAMS = {"unet": 1_813_764, "unet_cct": 3_713_664,
                "unet_urpc": 1_821_840, "discriminator": 2_762_754,
                "swin_unet": 27_168_420, "projector": 1_512,
                "classifier": 7_272, "nnUNet": 7_388_496}
# the metric that carries each method's unsupervised term
CONSISTENCY_KEY = {"fixmatch": "unsup_loss",
                   "adversarial_consistency": "ict_loss",
                   "supervised": None}
# uamt's output conv (student and teacher) scaled up, so that the MC
# teacher of a freshly initialised UNet is sure at some sites and the
# masked consistency term is live (random init alone: every site's entropy
# is above the threshold)
UAMT_LOGIT_SCALE = 8.0
CPS_FIT_STEPS, CPS_FIT_EVERY = 100, 50
# north-star config 4 (bench.py:176-178): a UNet and SwinUnet-tiny, batch
# 16 = 8 labeled + 8 unlabeled at 224^2; kernel #1's launches a step of
# each CNN+ViT method (one per model, forward and backward)
VIT_BATCH, VIT_LABELED_BS, VIT_PATCH = 16, 8, 224
VIT_SHAPE = (VIT_LABELED_BS, CLASSES, VIT_PATCH, VIT_PATCH)
VIT_METHOD_LAUNCHES = {"cross_teaching": 2, "cnn_meet_vit": 2,
                       "tripleview": 3, "adversarial_consistency": 1,
                       "contrastive_cross": 2}
# adversarial_consistency trains SwinUnet as its ``model``
VIT_KW = {"adversarial_consistency": {"model": "swin_unet"}}
VIT_FIT_STEPS, VIT_FIT_EVERY = 100, 50
# each method's pseudo-supervision term, and its calls in a step, in
# order: (i, j) is model i's input with model j's argmax as labels
PSEUDO_TERM = {"cps": "_pseudo_ce", "cross_teaching": "_pseudo_dice",
               "cnn_meet_vit": "_pseudo_dice", "tripleview": "_pseudo_dice",
               "contrastive_cross": "_pseudo_dice"}
PSEUDO_PAIRS = {"cps": ((0, 1), (1, 0)),
                "cross_teaching": ((0, 1), (1, 0)),
                "contrastive_cross": ((0, 1), (1, 0)),
                "cnn_meet_vit": ((0, 1), (1, 0)),
                "tripleview": ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0),
                               (2, 1))}
FIXMATCH_FIT_STEPS = 100       # one validation, one checkpoint
# the host data path: batches timed on the host, steps checked for
# synchronising calls, fit iterations (one validation, one checkpoint)
HOST_TIMED_BATCHES, HOST_CHECKED_STEPS, HOST_FIT_STEPS = 20, 3, 100
CC_FIT_STEPS = 100             # contrastive_cross at 224^2: one of each
# north-star config 3 (BASELINE.md): SwinUnet-tiny on Prostate's 2
# classes, fully supervised and uamt, batch 16 = 8 + 8 at 224^2; kernel
# #1's launches a step of each (the labeled logits, forward and backward)
CONFIG3_CLASSES = 2
CONFIG3_SHAPE = (VIT_LABELED_BS, CONFIG3_CLASSES, VIT_PATCH, VIT_PATCH)
CONFIG3_LAUNCHES = {"supervised": 1, "uamt": 1}
MODEL_PARAMS_2 = {"swin_unet": 27_168_228}
# contrastive_consistency's fit on the host CTA path (the reference's
# dual SwinUnet-tiny, batch 16 = 8 + 8 at 224^2): iterations (4 epochs of
# 17, one validation, one checkpoint), CTA batches timed on the host,
# steps checked for synchronising calls and steps timed from the CTA
# pipeline
CCONS_FIT_STEPS, CTA_TIMED_BATCHES = 68, 20
CTA_CHECKED_STEPS, CTA_TIMED_STEPS = 3, 5
# one profiled step: the profiler took 22.4 s of the phase over three of
# these steps (two SwinUnet-tiny and four heads; NVIDIA H100 80GB HBM3,
# 700 W), and their device time varies by under 1.5% from step to step
CTA_PROFILED_STEPS = 1

# north-star config 5 (BASELINE.md:19, bench.py:291-336): UAMT-3D on
# unet_3D, batch 4 = 2 labeled + 2 unlabeled at 96^3, 2 classes, T = 8;
# the train set BraTS2019's 250 volumes at bench.py:259's 140 x 180 x 180
# (25 labeled, the reference's 10%), drawn on the card
BATCH_3D, LABELED_BS_3D, PATCH_3D, CLASSES_3D = 4, 2, 96, 2
SHAPE_3D = (LABELED_BS_3D, CLASSES_3D, PATCH_3D, PATCH_3D, PATCH_3D)
RAGGED_3D = (2, CLASSES_3D, 17, 19, 23)
BRATS_TRAIN, BRATS_LABELED, BRATS_VOLUME = 250, 25, (140, 180, 180)
# kernel #1's launches a step (forward, and backward) of the 3D methods
METHOD_LAUNCHES_3D = {"supervised": 1, "mean_teacher": 1, "cps": 2,
                      "ict": 1, "adversarial": 1,
                      "exam_student_teacher": 1}
MODEL_PARAMS_3D = {"unet_3D": 5_884_050, "discriminator": 11_024_386,
                   "vnet": 9_448_866, "voxresnet": 1_992_578,
                   "attention_unet": 6_469_328, "nnUNet": 30_444_656,
                   "unetr": 92_783_842, "swinunetr": 62_186_708}
UAMT_3D_CHECKED, UAMT_3D_TIMED = 10, 30
METHOD_3D_CHECKED, METHOD_3D_TIMED = 5, 10
# the sliding window: 5 volumes of bench.py:237-288's shape, 18 windows
# each at stride 64; the fit: 100 iterations (one validation, one
# checkpoint), a resume to 150, on 4 val volumes of mixed shapes (one
# under the patch on its first axis, so that the padding runs)
SW_VOLUMES, SW_WINDOWS = 5, 18
FIT_3D_STEPS, FIT_3D_RESUME = 100, 150
VAL_3D_SHAPES = ((140, 180, 180), (120, 160, 150), (90, 130, 140),
                 (100, 100, 100))
HOST_3D_VOLUMES, HOST_3D_TIMED, HOST_3D_STEPS = 8, 10, 3

# phase 9: the held-out test CLIs and the 3D CNN zoo. test_2d on ACDC's
# test count of volumes (SURVEY.md:69), ~10 slices each at ACDC's mixed
# in-plane sizes; test_3d on 10 volumes of bench.py:259's shape
# (BraTS2019's test set has 60: cut for time)
TEST_2D_VOLUMES, TEST_2D_SLICES = 40, 10
TEST_2D_SHAPES = ((232, 256), (256, 216), (154, 224), (428, 512))
TEST_3D_VOLUMES = 10
# the zoo at config 5's recipe (mean_teacher, batch 4 = 2 + 2, 2 classes,
# float32): each net's patch (nnUNet's pools need depth % 4 and the plane
# % 64) and an eval window for the card-against-CPU check
ZOO_3D = {"vnet": ((96, 96, 96), (64, 64, 64)),
          "voxresnet": ((96, 96, 96), (64, 64, 64)),
          "attention_unet": ((96, 96, 96), (64, 64, 64)),
          "nnUNet": ((96, 128, 128), (32, 64, 64))}
ZOO_CHECKED, ZOO_TIMED = 5, 10
NNUNET_SHAPE = (LABELED_BS_3D, CLASSES_3D, 96, 128, 128)
# short fits for the test CLIs' checkpoints when phase 9 runs alone
TEST_FIT_2D, TEST_FIT_3D = 40, 20

# phase 10: the 3D ViTs at train_fully_supervised_3D_ViT.py's recipe
# (SURVEY.md:141; net_factory_3d.py:24-38): supervised, batch 4, 2
# classes, float32, UNETR at 96^3 and SwinUNETR at 64^3 (feature size
# 48), from a store of the 250 volumes drawing from the 25 labeled ones;
# kernel #1 on the whole batch's logits; a short UNETR fit (one
# validation over 2 volumes, one checkpoint) and test_3d on 2 volumes
VIT3D_PATCH = {"unetr": 96, "swinunetr": 64}
VIT3D_BATCH = 4
VIT3D_CHECKED, VIT3D_TIMED = 5, 10
VIT3D_FIT_STEPS, VIT3D_TEST_VOLUMES = 40, 2

# phase 11: the rest of the 2D zoo at north-star config 2's recipe
# (mean_teacher, batch 24 = 12 + 12 at 256^2, 4 classes, float32), then
# --pretrained_ckpt fits (one validation over 2 volumes, one checkpoint)
# and test_2d --model efficient_unet on 4 volumes
ZOO_2D = ("enet", "pnet", "efficient_unet", "preunet")
MODEL_PARAMS.update({"enet": 349_284, "pnet": 486_596,
                     "efficient_unet": 12_566_060, "preunet": 55_581_692})
ZOO2D_FIT_STEPS, ZOO2D_VAL_VOLUMES, ZOO2D_TEST_VOLUMES = 20, 2, 4

# phase 12: the profiled fit at config 2's recipe, past the profiler's
# window of steps 10-20 (``utils/profiler.py::StepWindowProfiler``'s
# default, the one fit builds); no validation and no checkpoint in its run
PROFILE_FIT_STEPS = 25

# phase 13: data parallelism across processes (``parallel/``), two gloo
# ranks on the one card against one process from the same seed: config 2's
# mean-teacher steps (from step 1000, the consistency term live) in
# float32 (TF32 off) and in bf16; the tolerances of the float32 steps
PAR_WORLD, PAR_STEPS, PAR_START = 2, 5, 1000
PAR_METRIC_RTOL, PAR_STATE_ATOL = 1e-4, 1e-4
# 13b: the CLI's --distributed fit under torchrun (one nccl rank), against
# the same fit without it, and a second plain fit for the run-to-run
# spread: iterations, validation and checkpoint cadence, val volumes
PAR_CLI_STEPS, PAR_CLI_EVERY, PAR_CLI_VAL = 20, 10, 2
# the --distributed fit's largest difference from the plain fit, in units
# of two plain fits' (the card's step is not bit-reproducible)
PAR_CLI_SPREAD = 10.0
# 13c: the sliding window's windows split over the ranks, on one volume of
# config 5's shape; the share of voxels whose label may differ from the
# single rank's (summing the windows in another order may flip an exact
# tie); 13d: UNet3D's forward with its H axis split, at this shape
PAR_WINDOW_FLIPS = 1e-5
PAR_HALO_SHAPE, PAR_HALO_ATOL = (1, 1, 96, 192, 96), 1e-4

# phase 14: K steps a call as CUDA graphs (``Engine.train_steps_scan`` on
# the store, ``train_steps_fixed`` on one batch) against the eager steps on
# copies of one state: (a) config 2's mean_teacher in chunks of K from step
# 995, across its step-1000 graph key; (b) config 4's cross_teaching, one
# chunk; (c) UAMT-3D at config 5 through ``train_steps_fixed`` (bench.py:
# 296-336's record: one random batch, K = 10); steps timed each way in
# calls of K; (d) every other store-path method at a reduced size, in
# chunks where the step's host values turn; (e) config 2's fit through the
# CLI's flags with --scan_steps K, resumed. Graphed-against-eager
# differences are held to GRAPH_SPREAD times a second eager run's (the
# card's step is not bit-reproducible)
GRAPH_K, GRAPH_START, GRAPH_CHUNKS = 10, 995, 2
GRAPH_TIMED, GRAPH_VIT_CHUNKS, GRAPH_VIT_TIMED = 30, 1, 20
GRAPH_SPREAD = 10.0
GRAPH_EAGER_RUNS = 3           # eager runs beside each graphed one
# ... or this share of the largest value compared: at the reduced size
# the eager runs often agree to a few float32 steps, and then a sporadic
# change of atomic order moves the state by up to 5.7e-6 of it (urpc, in
# one eager run of two as often as in the graphed one)
GRAPH_FLOOR = 5e-5
GRAPH_EAGER_PROFILED = 3       # eager steps in a profile (a busy share)
UAMT_3D_LAUNCHES = 1           # kernel #1 each way a step of UAMT-3D
# (d): 2D batch 8 = 4 + 4 at 64^2 from 96 synthetic slices (16 labeled),
# SwinUnet thinned to two stages at window 4; 3D batch 4 = 2 + 2 at 32^3
# from 12 blob volumes of 48^3 (4 labeled); the consistency ramp one epoch
# long, so its staircase turns from exp(-5) (linear: 0) to 1 at step 150.
# Chunks (first step, rows), each replayed on the graphs of the last: from
# 0, where the EMA decay is 0, 1/2, 2/3, 3/4, 4/5 and contrastive_cross's
# epoch of 16 / 4 steps turns at 4; across 150, with uamt's threshold; and
# across the step-1000 graph key
GRAPH_SMALL_CHUNKS = ((0, 5), (149, 3), (998, 3))
GRAPH_SMALL_2D = dict(batch_size=8, labeled_bs=4, patch_size=(64, 64),
                      labeled_slices_override=16, consistency_rampup=1.0,
                      vit_kwargs=dict(embed_dim=24, depths=(2, 2),
                                      num_heads=(1, 2), window_size=4))
GRAPH_SMALL_SLICES = 96
GRAPH_SMALL_3D = dict(patch_size=(32, 32, 32), labeled_num=4, total_num=12,
                      consistency_rampup=1.0)
GRAPH_SMALL_VOLUMES, GRAPH_SMALL_VOLUME = 12, (48, 48, 48)
GRAPH_METHODS_2D = ("supervised", "uamt", "ict", "deep_co_training", "cps",
                    "cct", "urpc", "fixmatch", "adversarial",
                    "exam_student_teacher", "cnn_meet_vit", "tripleview",
                    "adversarial_consistency", "contrastive_cross")
GRAPH_METHODS_3D = ("supervised", "mean_teacher", "cps", "ict",
                    "adversarial", "exam_student_teacher")
# (e): config 2's mean_teacher fit, GRAPH_FIT_STEPS iterations validated
# every GRAPH_FIT_VAL and checkpointed every GRAPH_FIT_CKPT, so K = 10's
# chunks are cut to 10, 5, 5, 10; the graphed fit stops at GRAPH_FIT_STOP
# and resumes from its checkpoint on the same engine, and traces steps
# 11-20
GRAPH_FIT_STEPS, GRAPH_FIT_STOP, GRAPH_FIT_VAL, GRAPH_FIT_CKPT = 30, 20, 15, 10

# phase 15: the GAN nets at full width (ngf = ndf = 64, 1 channel in and
# out) at 256^2, batch 4; the card's float32 eval forwards against the CPU's
# on the first GAN_CPU_ROWS samples (eval mode draws nothing and mixes no
# samples); LSGAN steps, the first a warm-up
GAN_BATCH, GAN_SIDE, GAN_CPU_ROWS, GAN_STEPS = 4, 256, 2, 6
GAN_REL_TOL = 1e-4             # of the CPU output's largest element
SCSE_SHAPES = ((24, 16, 256, 256), (2, 16, 96, 96, 96))
SCSE_REL_TOL = 1e-5
INIT_STEPS = 5                 # mean-teacher steps after init_weights
INIT_ORTHO_TOL = 1e-4
STRONG_SAMPLES = 20            # host transform timings, median
PHASE15_BOUND_S = 45.0

# phase 16: the program's spans and step phases (``utils/tracing.py``):
# graphed calls of GRAPH_K steps of config 2's mean_teacher from the slice
# store and of UAMT-3D from the volume store, from step TRACE_START (past
# both methods' ramps' first turns, as the benchmark's train cells); the
# phases of the last replay of a profiled call against a replay's device
# time there (its busy time over its replays), within TRACE_PHASE_TOL; the
# sliding window's hand-overs of TRACE_VOLUMES volumes under the profiler,
# whose ``val3d.predict`` spans must cover TRACE_COVER of the hand-overs
TRACE_START = 25000
TRACE_PHASE_TOL = 0.05
TRACE_VOLUMES, TRACE_COVER = 6, 0.95
TRACE_PHASES = ("gather", "forward", "backward", "update")
PROGRAM_SPANS = TRACE_PHASES + ("teacher", "val3d.predict", "val3d.forward",
                                "val3d.accumulate")

# (memory bytes/s, float32 non-tensor FLOP/s, TF32 tensor-core FLOP/s) by
# card; NVIDIA data sheets, dense rates (half the "with sparsity" figures)
# at the full power limit
CARDS = (("H100 PCIe", 2.0e12, 51e12, 378e12),
         ("H100 NVL", 3.9e12, 60e12, 417.5e12),
         ("H100", 3.35e12, 67e12, 495e12),
         ("H200", 4.8e12, 67e12, 495e12))


class SyntheticACDC:
    """In-memory stand-in with ACDC's slice count and geometry (the port's
    copy of ``bench.py``'s)."""

    def __init__(self, n=ACDC_TRAIN_SLICES, shape=(232, 256),
                 classes=CLASSES):
        self._shape = shape
        self._n = n
        self._classes = classes

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"image": r.normal(0.5, 0.2, self._shape).astype(np.float32),
                "label": r.integers(0, self._classes,
                                    self._shape).astype(np.uint8)}


class BlobSlices:
    """In-memory train slices of ACDC's count and geometry with the blob
    generator of ``data/synthetic.py`` (one disc per class), so the model
    can learn and validation Dice means something."""

    def __init__(self, n=ACDC_TRAIN_SLICES, shape=(232, 256)):
        from cvssl_tpu_torch.data.synthetic import blob_image
        self._items = [blob_image(np.random.default_rng(i), shape, CLASSES)
                       for i in range(n)]

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        image, label = self._items[i]
        return {"image": image, "label": label}


def blob_volumes(n=FIT_VAL_VOLUMES, slices=FIT_VAL_SLICES, seed=10_000,
                 side=PATCH):
    """Uniform val volumes (slices, side, side) of blob slices."""
    from cvssl_tpu_torch.data.synthetic import blob_image
    rng = np.random.default_rng(seed)
    vols = []
    for _ in range(n):
        pairs = [blob_image(rng, (side, side), CLASSES)
                 for _ in range(slices)]
        vols.append({"image": np.stack([p[0] for p in pairs]),
                     "label": np.stack([p[1] for p in pairs])})
    return vols


def ptxas_summary(log: str):
    """One line per kernel of ``nvcc -Xptxas -v`` output: its (mangled)
    name, registers and spill stores."""
    lines, entry, spill = [], None, "0"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:  # drop the anonymous namespace and the parameter types
            entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "",
                           m.group(1))
            entry = (re.match(r"\w+?I\w+?EE", entry) or [entry])[0]
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            lines.append(f"{entry}: {m.group(1)} registers, {spill} bytes "
                         "spilled")
            entry, spill = None, "0"
    return lines


def card_rates(name: str):
    """(memory bytes/s, f32 FLOP/s, TF32 tensor FLOP/s) of the card."""
    for key, *rates in CARDS:
        if key in name:
            return tuple(rates)
    raise SystemExit(f"chip_smoke: no memory/compute rates for {name!r}")


def median_ms(fn, flush, reps=50, before=None):
    """Median device time of ``fn`` over ``reps`` calls, each timed with
    CUDA events after writing ``flush`` (larger than L2), so the inputs
    come from device memory, as the main path finds them; the flush also
    keeps the card busy while the host enqueues ``fn``, so the events time
    the device work and not the host's launch latency. ``before``, if
    given, runs in place of the write, to time from another L2 state."""
    import torch
    times = []
    for _ in range(reps + 5):
        if before is None:
            flush.zero_()
        else:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[5:]))


def l2_states(fn, flush):
    """``fn``'s event time from two more L2 states than the standard
    timer's (whose 1 GiB write leaves L2 full of dirty lines that the
    kernel's traffic must write back): after a 1 GiB read (cold and clean)
    and after a device-side spin that touches no memory (warm: the inputs
    still in L2 from the call before, as the main path finds the logits
    that the model has just written)."""
    import torch
    return {"clean": median_ms(fn, flush, before=flush.sum),
            "warm": median_ms(fn, flush,
                              before=lambda: torch.cuda._sleep(1_000_000))}


def offset_view(t):
    """``t``'s values at a storage offset of one element, 4 (f32) or 2
    (bf16) bytes off 16-byte alignment: the kernels' scalar loop."""
    view = t.new_empty(t.numel() + 1)[1:].view(t.shape)
    view.copy_(t)
    return view


def check_kernels(device):
    """Phase 2: forward and backward kernels against the float64 plain
    version, on the vector path (the main paths' shapes: the step loop's,
    the ViT methods' and north-star config 3's 2-class one, with the
    store's int32 labels) and the scalar loop (ragged shape, and the main
    shape at an unaligned offset), at 4 classes and at 2 and 16; two calls
    of each kernel on the same inputs must agree bit for bit. Returns the
    largest absolute errors seen."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    gen = torch.Generator(device=device).manual_seed(0)
    err = {"ce_dice_fwd": 0.0, "ce_dice_bwd": 0.0}
    f32, bf16, i32, u8 = (torch.float32, torch.bfloat16, torch.int32,
                          torch.uint8)
    cases = [(MAIN_SHAPE, f32, i32, False), (MAIN_SHAPE, bf16, i32, False),
             (VIT_SHAPE, f32, i32, False), (VIT_SHAPE, bf16, i32, False),
             (CONFIG3_SHAPE, f32, i32, False),
             (CONFIG3_SHAPE, bf16, i32, False)]
    cases += [(RAGGED_SHAPE, dt, lt, False) for dt in (f32, bf16)
              for lt in (i32, u8)]
    cases += [(MAIN_SHAPE, f32, i32, True), (MAIN_SHAPE, bf16, u8, True)]
    cases += [(shape, getattr(torch, dt), getattr(torch, lt), False)
              for shape, dt, lt in OTHER_CLASSES]
    for shape, dtype, label_dtype, offset in cases:
        check_case(device, gen, shape, dtype, label_dtype, offset,
                   shape[2:] != RAGGED_SHAPE[2:] and not offset, err)
    return err


def check_case(device, gen, shape, dtype, label_dtype, offset, vector,
               err):
    """One case of kernel #1 against the float64 plain version, forward
    and backward, on the path ``vector`` says, and bit-equal across two
    calls; the largest absolute errors go into ``err``."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    c = shape[1]
    logits = (2.0 * torch.randn(shape, generator=gen,
                                device=device)).to(dtype)
    labels = torch.randint(0, c, shape[:1] + shape[2:],
                           generator=gen, device=device
                           ).to(label_dtype)
    x = offset_view(logits) if offset else logits.clone()
    x.requires_grad_(True)
    tag = (f"{tuple(shape)} {str(dtype)[6:]} {str(label_dtype)[6:]}"
           f"{' offset' if offset else ''}")
    geo = fcd._geometry(x, labels)
    if geo.vector != vector:
        raise SystemExit(f"{tag}: vector path {geo.vector}")
    ce, dice = fcd.fused_ce_dice(x, labels, c)
    (COTANGENTS[0] * ce + COTANGENTS[1] * dice).backward()
    xd = logits.double().requires_grad_(True)
    ce_r, dice_r = fcd.ce_dice_plain(xd, labels, c)
    (COTANGENTS[0] * ce_r + COTANGENTS[1] * dice_r).backward()
    torch.cuda.synchronize()
    for got, want in ((ce, ce_r), (dice, dice_r)):
        got, want = float(got.detach()), float(want.detach())
        rel = abs(got - want) / abs(want)
        err["ce_dice_fwd"] = max(err["ce_dice_fwd"],
                                 abs(got - want))
        if not rel <= FWD_REL_TOL:
            raise SystemExit(f"forward mismatch {tag}: rel {rel}")
    g, gr = x.grad.double(), xd.grad
    if x.grad.dtype != dtype:
        raise SystemExit(f"grad dtype {x.grad.dtype} != {dtype}")
    rtol = GRAD_RTOL[str(dtype)[6:]]
    atol = GRAD_ATOL_OF_MAX * float(gr.abs().max())
    bad = (g - gr).abs() > atol + rtol * gr.abs()
    err["ce_dice_bwd"] = max(err["ce_dice_bwd"],
                             float((g - gr).abs().max()))
    if bool(bad.any()):
        raise SystemExit(
            f"backward mismatch {tag}: {int(bad.sum())} elements,"
            f" max abs err {float((g - gr).abs().max())}")
    # determinism: the same inputs give the same bits, call after call
    xs = x.detach()
    g_ce, g_dice = (torch.tensor(v, device=device) for v in COTANGENTS)
    outs = [fcd._forward_cuda(xs, labels) for _ in range(2)]
    stats = outs[0][2]
    grads = [fcd._backward_cuda(xs, labels, stats, g_ce, g_dice)
             for _ in range(2)]
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(*outs))
            and torch.equal(grads[0], grads[1])):
        raise SystemExit(f"{tag}: two calls on the same inputs differ")
    print(f"kernel check {tag}: ce {float(ce.detach()):.6f} "
          f"dice {float(dice.detach()):.6f} ok (vector path "
          f"{geo.vector}, tail {geo.tail}; bit-equal on repeat)")


def host_us(fn, calls=200):
    """Host microseconds to enqueue one call of ``fn`` (no synchronise
    inside the window; the device drains the queue after it)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def trace_launches(calls, flush, reps=20):
    """For each named call: the device kernels that one call launches (a
    ``torch.profiler`` window around that call alone; the most over three
    windows, or up to ten while none has seen a kernel, since the profiler
    now and then drops a short kernel's record, which can only lower a
    count), and each kernel's mean device time over ``reps`` calls with
    the L2 flushed before each.
    Returns {name: {"kernels": count, "us": {kernel: us}}}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def device_events(prof):
        return [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == cuda]

    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        own = {}
        for window in range(10):
            if window >= 3 and own:
                break
            with profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            seen = {e.key: e.count for e in device_events(prof)}
            if sum(seen.values()) > sum(own.values()):
                own = seen
        with profile(activities=acts) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = {e.key: e.self_device_time_total / e.count
              for e in device_events(prof) if e.key in own}
        out[name] = {"kernels": sum(own.values()), "us": us}
        print(f"trace {name}: {out[name]['kernels']} device kernel(s) in "
              f"one call; device us per launch (L2 flushed) "
              + ", ".join(f"{k[:60]} {v:.3f}" for k, v in us.items()))
    return out


def kernel_calls(device, shape=MAIN_SHAPE, dtype="bfloat16"):
    """Kernel #1 at ``shape`` (default the main path's) in ``dtype``
    (default the main path's bf16 logits; int32 labels): its forward and
    backward launches,
    the empty kernel, and a 1 GiB flush buffer, larger than L2 (50 MB),
    whose ~0.3 ms write outlasts the host's enqueueing of any call timed
    here."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    gen = torch.Generator(device=device).manual_seed(1)
    logits = torch.randn(shape, generator=gen, device=device).to(
        getattr(torch, dtype))
    labels = torch.randint(0, shape[1], shape[:1] + shape[2:],
                           generator=gen, device=device, dtype=torch.int32)
    flush = torch.empty(2 ** 28, dtype=torch.int32, device=device)
    _, _, stats = fcd._forward_cuda(logits, labels)
    g_ce, g_dice = (torch.tensor(v, device=device) for v in COTANGENTS)
    lib = fcd._library()
    return {
        "logits": logits, "labels": labels, "flush": flush,
        "fwd": lambda: fcd._forward_cuda(logits, labels),
        "bwd": lambda: fcd._backward_cuda(logits, labels, stats, g_ce,
                                          g_dice),
        "noop": lambda: lib.ce_dice_noop_launch(
            torch.cuda.current_stream().cuda_stream)}


def trace_kernels(device):
    """Kernel #1 under ``torch.profiler``: one device kernel per forward and
    per backward call, and the device time of each launch, also at one
    block of sites (the launches' fixed cost) beside the empty kernel's.
    Run after the step loop's throughput is measured, as the step's
    profile is: a profiler session leaves hooks behind that slow every
    later launch on the host."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    k = kernel_calls(device)
    one = (k["logits"][:1, :, :16, :16].contiguous(),
           k["labels"][:1, :16, :16].contiguous())
    _, _, one_stats = fcd._forward_cuda(*one)
    g_ce, g_dice = (torch.tensor(v, device=device) for v in COTANGENTS)
    trace = trace_launches({
        "ce_dice_fwd": k["fwd"], "ce_dice_bwd": k["bwd"],
        "empty kernel": k["noop"],
        "ce_dice_fwd one block": lambda: fcd._forward_cuda(*one),
        "ce_dice_bwd one block": lambda: fcd._backward_cuda(
            *one, one_stats, g_ce, g_dice)}, k["flush"])
    for name, t in trace.items():
        if t["kernels"] != 1:
            raise SystemExit(f"{name}: {t['kernels']} device kernels in one "
                             "call, not 1")
    return trace


def time_kernels(device, mem_bw, f32_rate, shape=MAIN_SHAPE,
                 dtype="bfloat16"):
    """Phase 2 timings of kernel #1 (:func:`kernel_calls`) at ``shape`` and
    ``dtype``: kernel, plain version, bound; the event timer's floor (an
    empty kernel through ctypes), and the host's enqueue time per call."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    k = kernel_calls(device, shape, dtype)
    logits, labels, flush = k["logits"], k["labels"], k["flush"]
    n = labels.numel()
    c = shape[1]

    def plain_fwd():
        with torch.no_grad():
            fcd.ce_dice_plain(logits, labels, c)

    x = logits.clone().requires_grad_(True)
    ce, dice = fcd.ce_dice_plain(x, labels, c)
    out = COTANGENTS[0] * ce + COTANGENTS[1] * dice

    def plain_bwd():
        torch.autograd.grad(out, x, retain_graph=True)

    floor_ms = median_ms(k["noop"], flush)
    floor_l2 = l2_states(k["noop"], flush)
    print(f"event timer floor (empty kernel through ctypes): {floor_ms:.6f}"
          f" ms (clean {floor_l2['clean']:.6f}, warm {floor_l2['warm']:.6f})"
          f"; host {host_us(k['noop']):.2f} us per launch")

    in_bytes = logits.numel() * logits.element_size() \
        + labels.numel() * labels.element_size()
    io = {  # bytes each input read once and each output written once
        "ce_dice_fwd": in_bytes + 4 * (2 + 3 * c),
        "ce_dice_bwd": in_bytes + 4 * (3 * c + 2)
        + logits.numel() * logits.element_size()}
    # per-site operations of the formulas (exp, log, div counted as one):
    # forward max/sub/exp/sum/div + 3 class sums ~ 10 per class + 4;
    # backward softmax again + gp, the Jacobian and the CE term ~ 16 + 4
    ops = {"ce_dice_fwd": n * (10 * c + 4), "ce_dice_bwd": n * (16 * c + 4)}
    timed = {"ce_dice_fwd": (k["fwd"], plain_fwd),
             "ce_dice_bwd": (k["bwd"], plain_bwd)}
    rows = {}
    for name, (kern, plain) in timed.items():
        t_bytes = io[name] / mem_bw * 1e3
        t_ops = ops[name] / f32_rate * 1e3
        rows[name] = {
            "ms": median_ms(kern, flush),
            "plain_ms": median_ms(plain, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": io[name], "host_us": host_us(kern),
            "l2": l2_states(kern, flush)}
        r = rows[name]
        print(f"kernel {name} at {tuple(shape)} {dtype}: kernel_ms "
              f"{r['ms']:.6f} "
              f"plain_ms "
              f"{r['plain_ms']:.6f} bound_us {r['bound_ms'] * 1e3:.3f} "
              f"({r['bound_by']}, {r['bytes']} bytes) library_ms none; "
              f"above the floor {(r['ms'] - floor_ms) * 1e3:.3f} us; "
              f"clean L2 {r['l2']['clean']:.6f} ms, warm L2 "
              f"{r['l2']['warm']:.6f} ms; host {r['host_us']:.2f} us per "
              "call")
    return rows


def run_main_path(device, card):
    """Phase 3: the mean-teacher train step at full width."""
    import torch
    from cvssl_tpu_torch.data.device_store import DeviceSliceStore
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine

    cfg = method_config("mean_teacher")
    engine = Engine(cfg)
    t0 = time.perf_counter()
    store = DeviceSliceStore(SyntheticACDC(), cfg.patch_size)
    engine.attach_store(store)
    print(f"store: {tuple(store.images.shape)} {store.images.dtype} on "
          f"{store.images.device}, built in {time.perf_counter() - t0:.1f} s")
    stream = two_stream(0).epochs()
    state = engine.init_state()
    model = state.models["model"]
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 1_813_764:
        raise SystemExit(f"UNet has {n_params} parameters, not 1,813,764")
    teacher0 = [p.detach().clone()
                for p in state.teachers["model"].parameters()]

    fcd.reset_launches()
    losses = []
    for start in (0, 1000):
        state.step = start
        for _ in range(10):
            before = dict(fcd.LAUNCHES)
            state, metrics = engine.train_steps(state, [next(stream)])
            for k in before:
                if fcd.LAUNCHES[k] != before[k] + 1:
                    raise SystemExit(f"{k}: {before[k]} -> "
                                     f"{fcd.LAUNCHES[k]} in one step")
            losses.append(metrics)
    torch.cuda.synchronize()
    launches = dict(fcd.LAUNCHES)
    vals = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(math.isfinite(v["loss"]) for v in vals):
        raise SystemExit(f"non-finite loss: {vals}")
    if not all(v["consistency_loss"] > 0.0 for v in vals[10:]):
        raise SystemExit("consistency term dead after step 1000")
    moved = any(not torch.equal(a, b) for a, b in
                zip(teacher0, state.teachers["model"].parameters()))
    if not moved:
        raise SystemExit("teacher did not move")
    print(f"main path: 20 steps, launches {launches}, loss "
          f"{vals[0]['loss']:.4f} -> {vals[9]['loss']:.4f} (from 0), "
          f"{vals[10]['loss']:.4f} -> {vals[19]['loss']:.4f} (from 1000), "
          f"cons {vals[19]['consistency_loss']:.3e} w "
          f"{vals[19]['consistency_weight']:.3e}")

    # throughput after the warm-up above
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MEASURE_STEPS // 10):
        state, metrics = engine.train_steps(
            state, [next(stream) for _ in range(10)])
    float(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    sps = MEASURE_STEPS * BATCH / dt
    print(f"main path throughput: {sps:.2f} slices/s "
          f"({dt / MEASURE_STEPS * 1e3:.2f} ms/step over {MEASURE_STEPS} "
          f"steps), peak memory {peak / 2 ** 30:.3f} GiB, on {card}")
    count_step_flops("main path (mean_teacher, config 2)",
                     lambda: engine.train_steps(state, [next(stream)]),
                     dt / MEASURE_STEPS, card)
    profile_steps(engine, state, stream, dt / MEASURE_STEPS)
    return engine, state, store, launches, sps


def profile_steps(engine, state, stream, step_s, steps=3, top=15,
                  step_fn=None):
    """Where the step's device time goes: the ``top`` kernels by device time
    over a few steps, and the device's busy share of the wall time with the
    profiler on. ``step_s``, the wall time of a step without the profiler
    (another window), gives an estimate of the busy share without it. The
    steps are ``engine.train_steps`` on the store's ``stream``, or
    ``step_fn()`` calls. Returns the device's busy ms per step (None if none
    was recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if step_fn is None:
            engine.train_steps(state, [next(stream) for _ in range(steps)])
        else:
            for _ in range(steps):
                step_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda]
    total_us = sum(e.self_device_time_total for e in events)
    if total_us <= 0:
        print("profile: no device time recorded")
        return None
    print(f"profile: {steps} steps, wall {wall / steps * 1e3:.2f} ms/step "
          f"(profiler on), device busy {total_us / steps / 1e3:.2f} ms/step, "
          f"busy share {total_us / 1e6 / wall:.3f}; estimated busy share "
          f"without the profiler {total_us / 1e6 / steps / step_s:.3f}")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    ours = ("ce_dice_fwd_kernel", "ce_dice_bwd_kernel")
    for e in ranked[:top] + [e for e in ranked[top:]
                             if any(k in e.key for k in ours)]:
        print(f"  {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
              f"{e.count // steps:5d}x  {e.key[:90]}")
    return total_us / steps / 1e3


def report_mfu(what, flops, step_s, card):
    """Print a step's (or a volume's) FLOPs, wall time, FLOP/s and MFU
    against the card's dense bf16 peak (``utils/mfu.py``), with the card's
    name and power limit. Returns the numbers."""
    from cvssl_tpu_torch.utils.mfu import mfu, peak_flops

    u = mfu(flops, step_s)
    peak = peak_flops()
    print(f"mfu {what}: flops_per_step {flops:.0f}, step {step_s * 1e3:.3f}"
          f" ms, {flops / step_s / 1e12:.3f} TFLOP/s achieved, mfu "
          f"{'none' if u is None else f'{u:.6f}'} of the dense bf16 peak "
          f"{'none' if peak is None else f'{peak / 1e12:.0f} TFLOP/s'}; "
          f"FlopCounterMode's count (no ctypes kernel), on {card}")
    return {"flops_per_step": flops, "step_s": step_s, "mfu": u}


def count_step_flops(what, step, step_s, card):
    """FLOPs of one more call of ``step`` (``utils/mfu.py::
    per_step_flops``: it runs, and its result is dropped), outside every
    timed window and sync debug window, then :func:`report_mfu` at the
    step time ``step_s`` measured before it."""
    import torch
    from cvssl_tpu_torch.utils.mfu import per_step_flops

    t0 = time.perf_counter()
    flops = per_step_flops(step)
    torch.cuda.synchronize()
    if not flops:
        raise SystemExit(f"{what}: no FLOPs counted")
    print(f"{what}: one step counted in {time.perf_counter() - t0:.2f} s")
    return report_mfu(what, flops, step_s, card)


def two_stream(seed, batch=BATCH, labeled_bs=LABELED_BS):
    """The step loop's sampler: 12 labeled + 12 unlabeled a batch (the ViT
    phase's: 8 + 8)."""
    from cvssl_tpu_torch.data.sampler import TwoStreamBatchSampler
    return TwoStreamBatchSampler(
        list(range(ACDC_LABELED_SLICES)),
        list(range(ACDC_LABELED_SLICES, ACDC_TRAIN_SLICES)),
        batch, batch - labeled_bs, rng=np.random.default_rng(seed))


def sync_sites(fn):
    """Where ``fn`` makes the host wait for the card: the port's source
    line (else the reported one) and the message of each synchronising call
    that ``torch.cuda``'s sync debug mode reports (mode "warn"), with their
    counts. The mode is set before the window opens, so the notice that
    setting it may print is not counted."""
    import collections
    import traceback
    import warnings

    import torch
    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if "cvssl_tpu_torch" in f.filename]
        where = (f"{os.path.relpath(ours[-1].filename)}:{ours[-1].lineno}"
                 if ours else f"{filename}:{lineno}")
        sites[f"{where}: {str(message)[:80]}"] += 1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return dict(sites)


def method_config(method, **kw):
    """The smoke's configuration of ``method`` (batch 24 = 12 + 12 at
    256^2, dtype auto); ``kw`` overrides."""
    from cvssl_tpu_torch.train.config import TrainConfig
    base = dict(method=method, model="unet", num_classes=CLASSES,
                batch_size=BATCH, labeled_bs=LABELED_BS,
                patch_size=(PATCH, PATCH),
                labeled_slices_override=ACDC_LABELED_SLICES)
    return TrainConfig(**{**base, **kw})


def vit_config(method, **kw):
    """North-star config 4's: a UNet and SwinUnet-tiny, batch 16 = 8 + 8 at
    224^2."""
    return method_config(method, model2="swin_unet", batch_size=VIT_BATCH,
                         labeled_bs=VIT_LABELED_BS,
                         patch_size=(VIT_PATCH, VIT_PATCH), **kw)


def run_other_methods(device, card, store):
    """Phase 5: the other UNet-family 2D methods at full width on the
    step loop's store, each through :func:`drive_method`; first whether the
    mean-teacher step makes a synchronising call (then no method's checked
    steps run under ``torch.cuda.set_sync_debug_mode("error")``). Returns
    the methods' results and that verdict."""
    import torch
    from cvssl_tpu_torch.data.device_store import DeviceSliceStore
    from cvssl_tpu_torch.train.engine import Engine

    stream = two_stream(1).epochs()
    mt = Engine(method_config("mean_teacher"))
    mt.attach_store(store)
    mt_state = mt.init_state()
    mt.train_steps(mt_state, [next(stream)])      # first launches: set-up
    mt_sites = sync_sites(lambda: mt.train_steps(
        mt_state, [next(stream) for _ in range(3)]))
    print(f"sync debug: the mean-teacher step, 3 steps: "
          f"{mt_sites or 'no synchronising call'}")
    del mt, mt_state

    strict = not mt_sites
    results = {}
    for method, per_step in METHOD_LAUNCHES.items():
        engine = Engine(method_config(method, **METHOD_KW.get(method, {})))
        mode = engine.method.transform
        if mode != "default":
            # the method's own store over the same slices (fixmatch's
            # weak_strong, contrastive_cross's weak; freed with the engine)
            t0 = time.perf_counter()
            engine.attach_store(DeviceSliceStore(
                SyntheticACDC(), engine.cfg.patch_size, mode=mode))
            print(f"{mode} store: {tuple(engine.store.images.shape)} "
                  f"built in {time.perf_counter() - t0:.1f} s")
        else:
            engine.attach_store(store)
        state = engine.init_state()
        if method == "uamt":
            for m in (state.models["model"], state.teachers["model"]):
                with torch.no_grad():
                    m.decoder.out_conv.weight.mul_(UAMT_LOGIT_SCALE)
                    m.decoder.out_conv.bias.mul_(UAMT_LOGIT_SCALE)
        results[method] = drive_method(engine, state, stream, per_step,
                                       strict, card, BATCH)
        del engine, state
        torch.cuda.empty_cache()
    return results, strict


def drive_method(engine, state, stream, per_step, strict, card, batch,
                 checked=METHOD_STEPS, timed=MEASURE_STEPS, profiled=3,
                 top=5, batches=None, count=False):
    """One method at full width: its models' parameter counts; ``checked``
    steps from step 0 and as many from step 1000 (under sync debug mode
    "error" if ``strict``), kernel #1 launched ``per_step`` times a step,
    forward and backward; finite losses; a live unsupervised term after
    step 1000 (the pseudo-supervision of cps and the CNN+ViT methods read
    through their ``_pseudo_*`` terms and recomputed here, see
    :func:`check_pseudo`); the teachers, or else every model, and the
    discriminators moved; then samples/s and peak memory over ``timed``
    steps, with ``count`` one more step's FLOPs and MFU
    (:func:`count_step_flops`), and a profile of ``profiled`` steps (its
    ``top`` kernels). The steps take index batches of ``stream`` from the
    engine's store, or with ``batches`` the host pipeline's pinned
    batches. Returns the method's numbers."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    method = engine.cfg.method
    expected = (MODEL_PARAMS_3D if engine.cfg.dim == 3 else
                MODEL_PARAMS if engine.cfg.num_classes == CLASSES
                else MODEL_PARAMS_2)
    counts = {}
    for slot, model in state.models.items():
        n = sum(p.numel() for p in model.parameters())
        kind = engine.method.net_types()[slot]
        if n != expected[kind]:
            raise SystemExit(f"{method} {slot}: {n} parameters, not "
                             f"{expected[kind]} ({kind})")
        counts[slot] = n
    # models in no optimizer (contrastive_cross's heads): their weights
    # stay, their BatchNorm statistics move
    frozen = {n: m for n, m in state.models.items()
              if n not in state.optimizers}
    watched = {f"teacher {n}": m for n, m in state.teachers.items()}
    if method in PSEUDO_PAIRS or not watched:
        watched.update({n: m for n, m in state.models.items()
                        if n not in frozen})
    watched.update({n: state.models[n]
                    for n in engine.method.adversarial_models})
    start_params = {n: [p.detach().clone() for p in m.parameters()]
                    for n, m in {**watched, **frozen}.items()}
    start_stats = {n: [b.detach().clone() for b in m.buffers()]
                   for n, m in frozen.items()}
    pseudo = spy_pseudo(engine.method) if method in PSEUDO_PAIRS else None

    def steps(n):
        """``n`` steps; the last one's metrics."""
        nonlocal state
        if batches is None:
            state, m = engine.train_steps(state,
                                          [next(stream) for _ in range(n)])
            return m
        for _ in range(n):
            state, m = engine.train_step(state,
                                         engine.host_batch(next(batches)))
        return m

    fcd.reset_launches()
    vals = []
    for start in (0, 1000):
        state.step = start
        for _ in range(checked):
            before = dict(fcd.LAUNCHES)
            if strict:
                torch.cuda.set_sync_debug_mode("error")
            try:
                metrics = steps(1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            for k in before:
                if fcd.LAUNCHES[k] != before[k] + per_step:
                    raise SystemExit(
                        f"{method} {k}: {before[k]} -> {fcd.LAUNCHES[k]} "
                        f"in one step, not +{per_step}")
            vals.append(metrics)
    torch.cuda.synchronize()
    launches = dict(fcd.LAUNCHES)
    vals = [{k: float(v) for k, v in m.items()} for m in vals]
    if not all(math.isfinite(x) for v in vals for x in v.values()):
        raise SystemExit(f"{method}: non-finite metrics {vals}")
    late = vals[checked:]
    cons_key = CONSISTENCY_KEY.get(method, "consistency_loss")
    if pseudo is not None:
        calls_per_step = len(PSEUDO_PAIRS[method])
        if len(pseudo) != calls_per_step * 2 * checked:
            raise SystemExit(f"{method}: {len(pseudo)} pseudo-supervision "
                             f"terms in {2 * checked} steps")
        cons_key = "pseudo_supervision"
        for i, v in enumerate(late, checked):
            v[cons_key] = check_pseudo(
                method, pseudo[calls_per_step * i:calls_per_step * (i + 1)],
                v)
        # the recording ends here: it would keep every step's maps alive
        # (and the method, whose bound term the spy holds)
        del engine.method.__dict__[PSEUDO_TERM[method]], pseudo
    if cons_key is not None and not all(v[cons_key] > 0.0 for v in late):
        raise SystemExit(f"{method}: {cons_key} not > 0 after step "
                         f"1000: {[v[cons_key] for v in late]}")
    for n, m in watched.items():
        if all(torch.equal(a, b) for a, b in
               zip(start_params[n], m.parameters())):
            raise SystemExit(f"{method}: {n} did not move")
    for n, m in frozen.items():
        if not all(torch.equal(a, b) for a, b in
                   zip(start_params[n], m.parameters())):
            raise SystemExit(f"{method}: {n}'s weights moved (it is in no "
                             "optimizer)")
        if all(torch.equal(a, b) for a, b in zip(start_stats[n],
                                                 m.buffers())):
            raise SystemExit(f"{method}: {n}'s BatchNorm statistics did "
                             "not move")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed // 10):
        metrics = steps(10)
    float(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    r = {"params": counts, "launches": launches,
         "slices_per_s": timed * batch / dt,
         "ms_per_step": dt / timed * 1e3,
         "peak_gib": peak / 2 ** 30}
    extra = (f", uncertainty mask {late[-1]['uncertainty_mask_frac']:.4f}"
             if method == "uamt" else "")
    if engine.method.adversarial_models:
        extra += (f", loss_d {late[-1]['loss_d']:.4f} dan_acc "
                  f"{late[-1]['dan_acc']:.3f}")
    extra += f"; compute dtypes {engine.model_dtypes}"
    term = (f"{cons_key} {late[-1][cons_key]:.3e}" if cons_key
            else "no unsupervised term")
    unit = "volumes" if engine.cfg.dim == 3 else "slices"
    print(f"method {method}: parameters {counts}; "
          f"{2 * checked} steps, launches {launches} "
          f"({per_step} + {per_step} a step"
          f"{', under sync debug mode error' if strict else ''}); loss "
          f"{vals[0]['loss']:.4f} -> {vals[checked - 1]['loss']:.4f}"
          f" (from 0), {late[0]['loss']:.4f} -> {late[-1]['loss']:.4f} "
          f"(from 1000), "
          f"{term}{extra}; "
          f"{r['slices_per_s']:.2f} {unit}/s ({r['ms_per_step']:.2f} "
          f"ms/step over {timed} steps of {batch}), peak memory "
          f"{r['peak_gib']:.3f} GiB, on {card}")
    if count:
        r.update(count_step_flops(f"method {method}", lambda: steps(1),
                                  dt / timed, card))
    r["busy_ms_per_step"] = profile_steps(
        engine, state, stream, dt / timed, steps=profiled, top=top,
        step_fn=None if batches is None else lambda: steps(1))
    return r


def run_vit_methods(card, strict):
    """Phase 5b: north-star config 4's CNN+ViT methods, a UNet and
    SwinUnet-tiny (27,168,420 parameters) at full width, batch 16 = 8 + 8
    at 224^2, dtype auto (bf16 for both), from their own store of the
    synthetic slices at 224^2; each through :func:`drive_method`, with its
    Dice pseudo-supervision recomputed; then the eval-mode SwinUnet on the
    card against the CPU (:func:`check_vit_eval`)."""
    import torch
    from cvssl_tpu_torch.data.device_store import DeviceSliceStore
    from cvssl_tpu_torch.train.engine import Engine

    t0 = time.perf_counter()
    store = DeviceSliceStore(SyntheticACDC(), (VIT_PATCH, VIT_PATCH))
    print(f"ViT store: {tuple(store.images.shape)} built in "
          f"{time.perf_counter() - t0:.1f} s")
    stream = two_stream(2, VIT_BATCH, VIT_LABELED_BS).epochs()
    results = {}
    stores = {"default": store}
    for method, per_step in VIT_METHOD_LAUNCHES.items():
        engine = Engine(vit_config(method, **VIT_KW.get(method, {})))
        mode = engine.method.transform
        if mode not in stores:
            t0 = time.perf_counter()
            stores[mode] = DeviceSliceStore(
                SyntheticACDC(), (VIT_PATCH, VIT_PATCH), mode=mode)
            print(f"ViT {mode} store: {tuple(stores[mode].images.shape)} "
                  f"built in {time.perf_counter() - t0:.1f} s")
        engine.attach_store(stores[mode])
        state = engine.init_state()
        # contrastive_cross runs in phase 5 too (its CNN variant)
        key = f"{method}_vit" if method in METHOD_LAUNCHES else method
        results[key] = drive_method(engine, state, stream, per_step,
                                    strict, card, VIT_BATCH)
        if method == "cross_teaching":
            check_vit_eval(engine, state, store)
        del engine, state
        torch.cuda.empty_cache()
    return results


def run_config3(card, strict):
    """Phase 5b, north-star config 3: SwinUnet-tiny (27,168,228
    parameters at 2 classes) fully supervised and with uamt (T = 8), batch
    16 = 8 + 8 at 224^2, dtype auto (bf16), from a 2-class store of the
    synthetic slices; each through :func:`drive_method` (kernel #1 once
    each way a step, uamt's teacher moved, its masked consistency live
    after step 1000 with the SwinUnet's output projection scaled as phase
    5 scales the UNet's output conv); uamt's Monte-Carlo teacher counted
    with a spy: the consistency-target pass over u samples and ONE pass
    over the T * u tiled batch a step, never a scan (the teacher holds no
    batch statistics)."""
    import torch
    from cvssl_tpu_torch.data.device_store import DeviceSliceStore
    from cvssl_tpu_torch.train.engine import Engine

    t_phase = time.perf_counter()
    store = DeviceSliceStore(SyntheticACDC(classes=CONFIG3_CLASSES),
                             (VIT_PATCH, VIT_PATCH))
    store.batch_fn(store.arrays(),
                   torch.arange(VIT_BATCH, device=store.images.device),
                   torch.Generator(device=store.images.device).manual_seed(0))
    print(f"config 3 store ({CONFIG3_CLASSES} classes): "
          f"{tuple(store.images.shape)} built in "
          f"{time.perf_counter() - t_phase:.1f} s")
    stream = two_stream(3, VIT_BATCH, VIT_LABELED_BS).epochs()
    results = {}
    for method, per_step in CONFIG3_LAUNCHES.items():
        cfg = vit_config(method, model="swin_unet",
                         num_classes=CONFIG3_CLASSES)
        engine = Engine(cfg)
        engine.attach_store(store)
        state = engine.init_state()
        passes, stop = [], lambda: None
        if method == "uamt":
            for m in (state.models["model"], state.teachers["model"]):
                with torch.no_grad():
                    m.output.weight.mul_(UAMT_LOGIT_SCALE)
            passes, stop = spy_teacher_passes()
        try:
            results[f"{method}_swin"] = drive_method(
                engine, state, stream, per_step, strict, card, VIT_BATCH)
        finally:
            stop()
        if method == "uamt":
            u = VIT_BATCH - VIT_LABELED_BS
            want = [("forward_teacher", u),
                    ("forward_teacher", cfg.uncertainty_T * u)]
            if not passes or passes != want * (len(passes) // 2):
                raise SystemExit(f"uamt on SwinUnet: teacher passes "
                                 f"{sorted(set(passes))}, not {want} a "
                                 "step")
            print(f"uamt on SwinUnet: {len(passes) // 2} steps, each with "
                  f"the teacher passes {want} (one T * u pass, no scan)")
        del engine, state
        torch.cuda.empty_cache()
    print(f"phase 5b config 3: {time.perf_counter() - t_phase:.1f} s")
    return results


def spy_pseudo(method):
    """Record each pseudo-supervision call of ``method`` (``_pseudo_ce`` of
    cps, ``_pseudo_dice`` of the CNN+ViT methods: one model's unlabeled
    logits or softmax with another model's pseudo-labels) as (input,
    pseudo-labels, term), kept on the card; deleting the instance's
    attribute ends the recording."""
    calls = []
    name = PSEUDO_TERM[method.name]
    inner = getattr(method, name)

    def spy(x, pseudo):
        term = inner(x, pseudo)
        calls.append((x.detach(), pseudo, term.detach()))
        return term
    setattr(method, name, spy)
    return calls


def plain_dice(soft, labels, classes):
    """1 - mean over classes of (2 sum p y + s) / (sum p^2 + sum y + s), in
    float64 (the reference's ``DiceLoss`` of a softmax, s = 1e-5)."""
    import torch.nn.functional as F
    p = soft.double()
    y = F.one_hot(labels.long(), classes).movedim(-1, 1).double()
    red = (0, 2, 3)
    per = 1.0 - (2.0 * (p * y).sum(red) + 1e-5) / (
        (p * p).sum(red) + y.sum(red) + 1e-5)
    return per.mean()


def check_pseudo(method, calls, metrics):
    """One step's pseudo-supervision calls, in the order of
    ``PSEUDO_PAIRS[method]`` ((i, j): model i's input, model j's
    pseudo-labels): each pseudo-label map is the argmax of model j's
    softmax (all but 1e-4 of the sites), and each term is the plain
    ``F.cross_entropy`` (cps) or float64 Dice (the CNN+ViT methods) against
    it (rel 1e-4). Returns the consistency weight times their sum."""
    import torch
    import torch.nn.functional as F
    pairs = PSEUDO_PAIRS[method]
    inputs = {}
    for (i, _), (x, _, _) in zip(pairs, calls):
        inputs.setdefault(i, x)
    total = 0.0
    for (i, j), (x, labels, term) in zip(pairs, calls):
        want = torch.argmax(torch.softmax(inputs[j].float(), dim=1), dim=1)
        flips = int((want != labels).sum())
        if flips > labels.numel() * 1e-4:
            raise SystemExit(f"{method}: {flips} of {labels.numel()} "
                             f"pseudo-labels are not model {j + 1}'s argmax")
        plain = (float(F.cross_entropy(x.float(), labels))
                 if method == "cps" else
                 float(plain_dice(x, labels, x.shape[1])))
        if not math.isclose(float(term), plain, rel_tol=1e-4):
            raise SystemExit(f"{method}: pseudo-supervision {float(term)} "
                             f"is not the plain term {plain}")
        total += metrics["consistency_weight"] * plain
    return total


def check_eval(engine, state, store):
    """Phase 4: eval-mode predictions, and the f32 eval forward on the card
    against the same weights on the CPU."""
    import torch
    from cvssl_tpu_torch.models.unet import UNet

    x = store.images[:BATCH].float()[:, None]
    for teacher in (False, True):
        pred = engine.predict_fn("model", state, teacher=teacher)(x)
        torch.cuda.synchronize()
        if pred.shape != (BATCH, PATCH, PATCH) or pred.dtype != torch.uint8:
            raise SystemExit(f"predict: {pred.shape} {pred.dtype}")
        if int(pred.max()) >= CLASSES:
            raise SystemExit("predict: class out of range")
    model = state.models["model"]
    ref = UNet()
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    small = x[:2, :, :64, :64]
    model.eval()
    try:
        with torch.no_grad():
            got = model(small).float().cpu()
    finally:
        model.train()
    with torch.no_grad():
        want = ref.eval()(small.cpu())
    err = float((got - want).abs().max() / want.abs().max())
    print(f"eval: predict ok; f32 card vs CPU forward max rel err {err:.2e}")
    if err > 1e-4:
        raise SystemExit("f32 eval forward on the card disagrees with CPU")


def check_vit_eval(engine, state, store):
    """Phase 5b's eval check: the SwinUnet slot's predictions, and its
    eval-mode forward in float32 on the card against the same weights on
    the CPU."""
    import torch
    from cvssl_tpu_torch.models.swin_unet import SwinUnet

    x = store.images[:VIT_BATCH].float()[:, None]
    pred = engine.predict_fn("model2", state)(x)
    torch.cuda.synchronize()
    if (pred.shape != (VIT_BATCH, VIT_PATCH, VIT_PATCH)
            or pred.dtype != torch.uint8 or int(pred.max()) >= CLASSES):
        raise SystemExit(f"SwinUnet predict: {pred.shape} {pred.dtype}")
    model = state.models["model2"]
    ref = SwinUnet(num_classes=CLASSES, img_size=VIT_PATCH)
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    small = x[:2]
    model.eval()
    try:
        with torch.no_grad():
            got = model(small).cpu()
    finally:
        model.train()
    with torch.no_grad():
        want = ref.eval()(small.cpu())
    if got.dtype != torch.float32:
        raise SystemExit(f"SwinUnet f32 forward gave {got.dtype}")
    err = float((got - want).abs().max() / want.abs().max())
    print(f"SwinUnet eval: predict ok; f32 card vs CPU forward max rel err "
          f"{err:.2e}")
    if err > 1e-4:
        raise SystemExit("SwinUnet's f32 eval forward on the card disagrees "
                         "with the CPU")


def check_conv(device):
    """Phase 6a: the three conv kernels against the plain version in
    float64 on the card (bf16 inputs: float64 of the bf16-rounded values),
    then each one bit-equal across two calls; returns the largest absolute
    error of each kernel."""
    import torch
    from cvssl_tpu_torch.ops import conv3x3_p8 as cv

    gen = torch.Generator(device=device).manual_seed(2)
    err = {name: 0.0 for name in cv.LAUNCHES}
    for shape, dtype, tile_h in CONV_CASES:
        x = torch.randn(shape, generator=gen, device=device).to(
            getattr(torch, dtype))
        k = 0.1 * torch.randn((3, 3, 16, 16), generator=gen, device=device)
        want = cv.conv3x3_p8_plain(x.double(), k.double())
        scale = float(want.abs().max())
        for name in cv.LAUNCHES:
            got = getattr(cv, name)(x, k, tile_h=tile_h)
            torch.cuda.synchronize()
            if got.dtype != torch.float32 or got.shape != want.shape:
                raise SystemExit(f"{name}: {got.dtype} {tuple(got.shape)}")
            e = float((got.double() - want).abs().max())
            err[name] = max(err[name], e)
            print(f"conv check {name} {shape} {dtype} tile_h {tile_h}: max "
                  f"abs err {e:.3e} ({e / scale:.3e} of max |out|)")
            if not e <= CONV_REL_TOL * scale:
                raise SystemExit(f"{name} {shape} {dtype}: error {e} above "
                                 f"{CONV_REL_TOL} x {scale}")
    # determinism of each kernel: the same bits, call after call
    shape, _, tile_h = CONV_CASES[0]
    x = torch.randn(shape, generator=gen, device=device)
    k = 0.1 * torch.randn((3, 3, 16, 16), generator=gen, device=device)
    for name in cv.LAUNCHES:
        for xin in (x, x.to(torch.bfloat16)):
            first, second = (getattr(cv, name)(xin, k, tile_h=tile_h)
                             for _ in range(2))
            torch.cuda.synchronize()
            if not torch.equal(first, second):
                raise SystemExit(f"{name} {shape} {xin.dtype}: two calls "
                                 "on the same inputs differ")
        print(f"conv check {name} {shape} f32 and bf16 input: bit-equal on "
              "repeat")
    return err


def time_conv(device, mem_bw, tf32_rate):
    """Phase 6b at the full shape (24, 256, 256, 16), f32 and bf16 input:
    kernel, plain version (f32), bound, and F.conv2d (channels-last, TF32
    off). The bound is the least time for the work: the larger of its bytes
    (input read once, output written once) and the conv's operations at the
    card's dense TF32 tensor-core rate."""
    import torch
    import torch.nn.functional as F
    from cvssl_tpu_torch.ops import conv3x3_p8 as cv

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(3)
    shape = CONV_CASES[0][0]
    x = torch.randn(shape, generator=gen, device=device)
    xb = x.to(torch.bfloat16)
    k = 0.1 * torch.randn((3, 3, 16, 16), generator=gen, device=device)
    flush = torch.empty(2 ** 28, dtype=torch.int32, device=device)
    b, h, w, c = shape
    # x (B, H, W, C) contiguous seen as (B, C, H, W) is channels-last
    xn, wn = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    ref = F.conv2d(xn, wn, padding=1).permute(0, 2, 3, 1)
    got = cv.conv3x3_p8(x, k)
    lib_err = float((ref - got).abs().max() / got.abs().max())
    ops = b * h * w * c * c * 9 * 2
    in_out = {"float32": x.numel() * 4 + k.numel() * 4 + b * h * w * c * 4,
              "bfloat16": x.numel() * 2 + k.numel() * 4 + b * h * w * c * 4}
    t_ops = ops / tf32_rate * 1e3
    bound = {}  # dtype -> (ms, what bounds it)
    for dt, n in in_out.items():
        t_bytes = n / mem_bw * 1e3
        bound[dt] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    library_ms = median_ms(lambda: F.conv2d(xn, wn, padding=1), flush)
    plain_ms = median_ms(lambda: cv.conv3x3_p8_plain(x, k), flush)
    rows = {}
    for name in cv.LAUNCHES:
        fn = getattr(cv, name)
        rows[name] = {"ms": median_ms(lambda: fn(x, k), flush),
                      "ms_bf16": median_ms(lambda: fn(xb, k), flush),
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound["float32"][0],
                      "bound_by": bound["float32"][1],
                      "bound_ms_bf16": bound["bfloat16"][0]}
        r = rows[name]
        print(f"kernel {name}: kernel_ms {r['ms']:.6f} (bf16 input "
              f"{r['ms_bf16']:.6f}) plain_ms {plain_ms:.6f} library_ms "
              f"{library_ms:.6f} bound_us {r['bound_ms'] * 1e3:.3f} "
              f"({r['bound_by']}), bf16 input "
              f"{r['bound_ms_bf16'] * 1e3:.3f} ({bound['bfloat16'][1]}): "
              f"bytes f32 {in_out['float32']} = "
              f"{in_out['float32'] / mem_bw * 1e6:.3f} us, bf16 "
              f"{in_out['bfloat16']} = "
              f"{in_out['bfloat16'] / mem_bw * 1e6:.3f} us; {ops} flop = "
              f"{t_ops * 1e3:.3f} us at dense TF32")
    print(f"conv: F.conv2d (channels-last f32, TF32 off) vs conv3x3_p8 max "
          f"rel err {lib_err:.2e}")
    return rows


def drive_conv(device):
    """Phase 6c, the conv kernels' own path: each public function once at
    each case, as the JAX package uses them (its tests' shapes and the
    docstring's timing shape), launch counts from 0."""
    import torch
    from cvssl_tpu_torch.ops import conv3x3_p8 as cv

    gen = torch.Generator(device=device).manual_seed(4)
    k = 0.1 * torch.randn((3, 3, 16, 16), generator=gen, device=device)
    inputs = [(torch.randn(shape, generator=gen, device=device).to(
        getattr(torch, dtype)), tile_h) for shape, dtype, tile_h in CONV_CASES]
    cv.reset_launches()
    outs = [getattr(cv, name)(x, k, tile_h=tile_h)
            for name in cv.LAUNCHES for x, tile_h in inputs]
    torch.cuda.synchronize()
    launches = dict(cv.LAUNCHES)
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise SystemExit("conv path: non-finite output")
    if any(n != len(CONV_CASES) for n in launches.values()):
        raise SystemExit(f"conv path launches {launches}")
    print(f"conv path: launches {launches}")
    return launches


def run_fit(device, card, strict):
    """Phase 7: fit, its files, the val table, resume, throughput; then
    the cps, fixmatch and cross_teaching fits, the host data path
    (:func:`run_host_fit`, its steps under sync debug mode "error" if
    ``strict``), the contrastive_cross fit and the contrastive_consistency
    fit on the host CTA path (:func:`run_ccons_fit`). Returns the latter's
    kernel #1 launches and the mean-teacher fit's
    ``unet_best_model.ckpt`` (phase 9's 2D test CLI reads it)."""
    import torch
    from cvssl_tpu_torch.ops import edt
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine, fit

    t0 = time.perf_counter()
    train_ds, val_ds = BlobSlices(), blob_volumes()
    print(f"fit data: {len(train_ds)} train slices, {len(val_ds)} val "
          f"volumes of {val_ds[0]['image'].shape}, made in "
          f"{time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    cfg = method_config("mean_teacher", val_every=FIT_EVERY,
                        ckpt_every=FIT_EVERY, log_every=100,
                        snapshot_root=tmp, exp="ACDC/smoke")
    snap = cfg.snapshot_path()
    results = []
    for steps in (FIT_STEPS, FIT_RESUME_STEPS):
        engine = Engine(cfg)
        fcd.reset_launches()
        t0 = time.perf_counter()
        # a fresh stream per fit call, as a restarted run has
        res = fit(cfg, engine=engine, max_steps=steps,
                  data=(train_ds, two_stream(cfg.seed), val_ds))
        wall = time.perf_counter() - t0
        launches = dict(fcd.LAUNCHES)
        ran = steps - (results[-1]["iterations"] if results else 0)
        if res["iterations"] != steps:
            raise SystemExit(f"fit stopped at {res['iterations']}")
        if any(v != ran for v in launches.values()):
            raise SystemExit(f"fit ran {ran} iterations, launches "
                             f"{launches}")
        print(f"fit to {steps}: {ran} iterations, {res['slices_per_sec']:.2f}"
              f" slices/s including validation and checkpoints (loop only; "
              f"{wall:.1f} s wall with store build and init), val passes "
              f"{[round(v, 3) for v in res['val_seconds']]} s, fused "
              f"launches {launches}, best dice {res['best_dice']}, on {card}")
        results.append(res)
    with open(os.path.join(snap, "log.txt")) as f:
        log = f.read()
    if f"resumed from iteration {FIT_STEPS}" not in log:
        raise SystemExit("second fit did not log a resume from "
                         f"{FIT_STEPS}")
    want = [f"iter_{FIT_EVERY}_dice_*.ckpt", "unet_best_model.ckpt",
            f"iter_{FIT_STEPS}.ckpt", f"ema_model_iter_{FIT_STEPS}.ckpt",
            f"iter_{FIT_RESUME_STEPS}.ckpt"]
    for pattern in want:
        if not glob.glob(os.path.join(snap, pattern)):
            raise SystemExit(f"fit: no {pattern} in {snap}")
    full = sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(snap, "model_iter_*.ckpt")))
    if full != [f"model_iter_{FIT_STEPS}.ckpt",
                f"model_iter_{FIT_RESUME_STEPS}.ckpt"]:
        raise SystemExit(f"prune_old left {full}")
    print(f"fit files: {sorted(os.listdir(snap))}")

    # the val table of the final state, the val pass's time and the EDT's
    # own peak memory (predictions of the resident val set as input)
    state = results[-1]["state"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = engine.validate(state, val_ds)
    val_s = time.perf_counter() - t0
    if not (np.isfinite(table).all() and (table[:, 0] >= 0).all()
            and (table[:, 0] <= 1).all()):
        raise SystemExit(f"val table {table}")
    store = engine._val_resident_store(val_ds, cfg.patch_size)
    from cvssl_tpu_torch.eval import val2d
    pred = val2d.predict_slices(engine.predict_fn("model", state),
                                store["images"]).reshape(
        store["labels"].shape)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    edt.val_metrics(pred, store["labels"], CLASSES).sum(dim=0).cpu()
    edt_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    print(f"fit val table (dice, hd95) per class: {table.tolist()}; val "
          f"pass {val_s:.3f} s; EDT metrics alone {edt_s:.3f} s, peak "
          f"{peak / 2 ** 20:.1f} MiB above its inputs, on {card}")
    store_sps = [r["slices_per_sec"] for r in results]
    del engine, results, state
    run_cps_fit(card, train_ds, val_ds)
    run_fixmatch_fit(card, train_ds, val_ds)
    vit_val_ds = blob_volumes(side=VIT_PATCH)
    run_vit_fit(card, train_ds, vit_val_ds)
    run_host_fit(card, train_ds, val_ds, store_sps, strict)
    run_cc_fit(card, train_ds, vit_val_ds)
    return (run_ccons_fit(card, train_ds, vit_val_ds, strict),
            os.path.join(snap, "unet_best_model.ckpt"))


def run_cps_fit(card, train_ds, val_ds):
    """Phase 7b: ``fit`` of cps (two UNets, two optimizers) on the same
    data, 100 iterations with val and checkpoints every 50: the dual-model
    files (JAX ``engine.py:693-707``), kernel #1's launches (two forward
    and two backward an iteration), slices/s."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine, fit

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cps_")
    cfg = method_config("cps", val_every=CPS_FIT_EVERY,
                        ckpt_every=CPS_FIT_EVERY, log_every=100,
                        snapshot_root=tmp, exp="ACDC/smoke_cps")
    snap = cfg.snapshot_path()
    fcd.reset_launches()
    res = fit(cfg, engine=Engine(cfg), max_steps=CPS_FIT_STEPS,
              data=(train_ds, two_stream(cfg.seed), val_ds))
    torch.cuda.synchronize()
    launches = dict(fcd.LAUNCHES)
    if res["iterations"] != CPS_FIT_STEPS:
        raise SystemExit(f"cps fit stopped at {res['iterations']}")
    if any(v != 2 * CPS_FIT_STEPS for v in launches.values()):
        raise SystemExit(f"cps fit: launches {launches} in "
                         f"{CPS_FIT_STEPS} iterations")
    files = sorted(os.listdir(snap))
    saved = (CPS_FIT_STEPS - CPS_FIT_EVERY, CPS_FIT_STEPS)
    want = ["unet_best_model1.ckpt", "unet_best_model2.ckpt"]
    want += [f"model_iter_{k}.ckpt" for k in saved]
    want += [f"model{i}_iter_{k}.ckpt" for i in (1, 2) for k in saved]
    for name in want:
        if name not in files:
            raise SystemExit(f"cps fit: no {name} in {files}")
    for slot in ("model1", "model2"):
        if not glob.glob(os.path.join(snap, f"{slot}_iter_*_dice_*.ckpt")):
            raise SystemExit(f"cps fit: no {slot}_iter_*_dice_* file")
    if any("ema" in f for f in files) or any(f.startswith("iter_")
                                             for f in files):
        raise SystemExit(f"cps fit: single-model or EMA files {files}")
    print(f"cps fit to {CPS_FIT_STEPS}: {res['slices_per_sec']:.2f} slices/s"
          f" including validation and checkpoints, val passes "
          f"{[round(v, 3) for v in res['val_seconds']]} s, fused launches "
          f"{launches}, best dice {res['best_dice']}, on {card}")
    print(f"cps fit files: {files}")


def run_fixmatch_fit(card, train_ds, val_ds):
    """Phase 7c: ``fit`` of fixmatch on the same data, 100 iterations with
    one validation and one checkpoint: ``fit`` builds the store in the
    ``weak_strong`` mode, kernel #1 runs once forward and once backward an
    iteration, the mean teacher's file names (its EMA teacher is kept)."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine, fit

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fixmatch_")
    cfg = method_config("fixmatch", val_every=FIXMATCH_FIT_STEPS,
                        ckpt_every=FIXMATCH_FIT_STEPS, log_every=50,
                        snapshot_root=tmp, exp="ACDC/smoke_fixmatch")
    snap = cfg.snapshot_path()
    engine = Engine(cfg)
    fcd.reset_launches()
    res = fit(cfg, engine=engine, max_steps=FIXMATCH_FIT_STEPS,
              data=(train_ds, two_stream(cfg.seed), val_ds))
    torch.cuda.synchronize()
    launches = dict(fcd.LAUNCHES)
    if res["iterations"] != FIXMATCH_FIT_STEPS:
        raise SystemExit(f"fixmatch fit stopped at {res['iterations']}")
    if engine.store.mode != "weak_strong":
        raise SystemExit(f"fixmatch fit: store mode {engine.store.mode}")
    if any(v != FIXMATCH_FIT_STEPS for v in launches.values()):
        raise SystemExit(f"fixmatch fit: launches {launches} in "
                         f"{FIXMATCH_FIT_STEPS} iterations")
    if len(res["val_seconds"]) != 1:
        raise SystemExit(f"fixmatch fit: {len(res['val_seconds'])} "
                         "validations")
    files = sorted(os.listdir(snap))
    k = FIXMATCH_FIT_STEPS
    for name in (f"iter_{k}.ckpt", f"ema_model_iter_{k}.ckpt",
                 f"model_iter_{k}.ckpt"):
        if name not in files:
            raise SystemExit(f"fixmatch fit: no {name} in {files}")
    print(f"fixmatch fit to {k}: {res['slices_per_sec']:.2f} slices/s "
          f"including validation and checkpoints (weak_strong store), val "
          f"pass {[round(v, 3) for v in res['val_seconds']]} s, fused "
          f"launches {launches}, best dice {res['best_dice']}, on {card}")
    print(f"fixmatch fit files: {files}")


def run_vit_fit(card, train_ds, val_ds):
    """Phase 7d: ``fit`` of cross_teaching at north-star config 4's size
    (a UNet and SwinUnet-tiny, batch 16 = 8 + 8 at 224^2) on the same
    train slices and val volumes at 224^2, 100 iterations with val and
    checkpoints every 50; model2 validated at ``patch_size2`` (224^2,
    JAX ``Engine.validate``): both slots validated each time, the
    dual-model files (``model1_``/``model2_`` prefixes, ``unet_best_model1``
    where model 1's Dice rose, no EMA files), two launches of each kernel
    an iteration, slices/s."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine, fit

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ct_")
    cfg = vit_config("cross_teaching", val_every=VIT_FIT_EVERY,
                     ckpt_every=VIT_FIT_EVERY, log_every=100,
                     snapshot_root=tmp, exp="ACDC/smoke_ct",
                     patch_size2=(VIT_PATCH, VIT_PATCH))
    snap = cfg.snapshot_path()
    fcd.reset_launches()
    res = fit(cfg, engine=Engine(cfg), max_steps=VIT_FIT_STEPS,
              data=(train_ds, two_stream(cfg.seed, VIT_BATCH,
                                         VIT_LABELED_BS), val_ds))
    torch.cuda.synchronize()
    launches = dict(fcd.LAUNCHES)
    if res["iterations"] != VIT_FIT_STEPS:
        raise SystemExit(f"cross_teaching fit stopped at {res['iterations']}")
    if any(v != 2 * VIT_FIT_STEPS for v in launches.values()):
        raise SystemExit(f"cross_teaching fit: launches {launches} in "
                         f"{VIT_FIT_STEPS} iterations")
    validations = VIT_FIT_STEPS // VIT_FIT_EVERY
    if (len(res["val_seconds"]) != 2 * validations
            or set(res["best_dice"]) != {"model1", "model2"}):
        raise SystemExit(f"cross_teaching fit: {len(res['val_seconds'])} "
                         f"validations of {sorted(res['best_dice'])}")
    files = sorted(os.listdir(snap))
    want = [f"model{i}_iter_{k}.ckpt" for i in (1, 2)
            for k in range(VIT_FIT_EVERY, VIT_FIT_STEPS + 1, VIT_FIT_EVERY)]
    want += [f"model_iter_{k}.ckpt" for k in
             range(VIT_FIT_EVERY, VIT_FIT_STEPS + 1, VIT_FIT_EVERY)]
    want += [f"unet_best_{slot}.ckpt"
             for slot, dice in res["best_dice"].items() if dice > 0.0]
    if res["best_dice"]["model1"] <= 0.0:
        raise SystemExit(f"cross_teaching fit: best dice {res['best_dice']}")
    for name in want:
        if name not in files:
            raise SystemExit(f"cross_teaching fit: no {name} in {files}")
    if any("ema" in f for f in files) or any(f.startswith("iter_")
                                             for f in files):
        raise SystemExit(f"cross_teaching fit: single-model or EMA files "
                         f"{files}")
    print(f"cross_teaching fit to {VIT_FIT_STEPS} (UNet + SwinUnet, batch "
          f"{VIT_BATCH} at {VIT_PATCH}^2): {res['slices_per_sec']:.2f} "
          f"slices/s including validation and checkpoints, val passes "
          f"{[round(v, 3) for v in res['val_seconds']]} s, fused launches "
          f"{launches}, best dice {res['best_dice']}, on {card}")
    print(f"cross_teaching fit files: {files}")


class HostSlices:
    """The host path's train set: each slice through a host transform
    (``data/transforms.py``, or CTAugment's ``CTATransform`` with its
    policies), with its index, through ``SliceDataset``'s own
    ``transform_sample``, as ``SliceDataset`` gives it."""

    def __init__(self, base, transform, ops_weak=None, ops_strong=None):
        self.base, self.transform = base, transform
        self.ops_weak, self.ops_strong = ops_weak, ops_strong

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        return self.load(i, self.ops_weak, self.ops_strong)

    def load(self, i, ops_weak=None, ops_strong=None):
        from cvssl_tpu_torch.data.datasets import transform_sample
        return {**transform_sample(self.transform, self.base[i], ops_weak,
                                   ops_strong), "idx": i}


def host_data(base, cfg):
    """(dataset, sampler) of the host path, as ``build_2d_data`` pairs
    them: the reference's RandomGenerator drawing from the sampler's
    generator."""
    from cvssl_tpu_torch.data import transforms as T
    sampler = two_stream(cfg.seed)
    return HostSlices(base, T.RandomGenerator(cfg.patch_size,
                                              sampler.rng)), sampler


def run_host_fit(card, train_ds, val_ds, store_sps, strict):
    """Phase 7e, the host data path (``device_data=False``) at full
    width: the host's time to load a batch (RandomGenerator on 24 slices
    of 232 x 256 and the collate, one thread, as the prefetch thread runs
    it) and to pin it; a few mean-teacher steps from the pipeline's pinned
    batches (under sync debug mode "error" if ``strict``); then a
    100-iteration mean-teacher ``fit`` with one validation and one
    checkpoint: no store, kernel #1 once each way an iteration, the
    sampler's state in the checkpoint, slices/s beside the store path's
    ``fit`` of this run."""
    import torch
    from cvssl_tpu_torch.data.pipeline import DataPipeline, pinned
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine, fit
    from cvssl_tpu_torch.utils import checkpoint as ckpt

    tmp = tempfile.mkdtemp(prefix="chip_smoke_host_")
    cfg = method_config("mean_teacher", device_data=False,
                        val_every=HOST_FIT_STEPS, ckpt_every=HOST_FIT_STEPS,
                        log_every=100, snapshot_root=tmp,
                        exp="ACDC/smoke_host")
    ds, sampler = host_data(train_ds, cfg)
    pipe = DataPipeline(ds, sampler)
    indices = sampler.epochs()
    load_s, pin_s = [], []
    for _ in range(HOST_TIMED_BATCHES):
        t0 = time.perf_counter()
        batch = pipe._load_batch(next(indices))
        t1 = time.perf_counter()
        pinned(batch)
        load_s.append(t1 - t0)
        pin_s.append(time.perf_counter() - t1)
    load_ms, pin_ms = (float(np.median(v)) * 1e3 for v in (load_s, pin_s))
    print(f"host batch ({BATCH} slices of {train_ds[0]['image'].shape}, "
          f"one thread, median of {HOST_TIMED_BATCHES}): transform + "
          f"collate {load_ms:.2f} ms, pinning {pin_ms:.2f} ms; the step "
          f"needs {BATCH * 1e3 / load_ms:.1f} slices/s of the host at most")

    engine = Engine(cfg)
    state = engine.init_state()
    ds, sampler = host_data(train_ds, cfg)
    stream = DataPipeline(ds, sampler, pin_memory=True).stream()
    try:
        engine.train_step(state, engine.host_batch(next(stream)))
        for _ in range(HOST_CHECKED_STEPS):
            batch = next(stream)
            if strict:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, metrics = engine.train_step(
                    state, engine.host_batch(batch))
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        stream.close()
    if not math.isfinite(float(metrics["loss"])):
        raise SystemExit(f"host path step: loss {float(metrics['loss'])}")
    print(f"host path: {HOST_CHECKED_STEPS} steps from pinned batches"
          f"{' under sync debug mode error' if strict else ''}, loss "
          f"{float(metrics['loss']):.4f}")
    del engine, state

    engine = Engine(cfg)
    fcd.reset_launches()
    res = fit(cfg, engine=engine, max_steps=HOST_FIT_STEPS,
              data=(*host_data(train_ds, cfg), val_ds))
    torch.cuda.synchronize()
    launches = dict(fcd.LAUNCHES)
    if res["iterations"] != HOST_FIT_STEPS or engine.store is not None:
        raise SystemExit(f"host fit: {res['iterations']} iterations, store "
                         f"{engine.store}")
    if any(v != HOST_FIT_STEPS for v in launches.values()):
        raise SystemExit(f"host fit: launches {launches} in "
                         f"{HOST_FIT_STEPS} iterations")
    snap = cfg.snapshot_path()
    files = sorted(os.listdir(snap))
    k = HOST_FIT_STEPS
    for name in (f"iter_{k}.ckpt", f"ema_model_iter_{k}.ckpt",
                 f"model_iter_{k}.ckpt"):
        if name not in files:
            raise SystemExit(f"host fit: no {name} in {files}")
    meta = ckpt.load_weights(os.path.join(snap, f"model_iter_{k}.ckpt"))[
        "meta"]
    data = meta.get("data") or {}
    if (set(data) != {"sampler", "loader", "requests"}
            or set(data["sampler"]) != {"rng", "primary", "p_pos",
                                        "secondary", "s_pos"}):
        raise SystemExit(f"host fit: no sampler state in the checkpoint "
                         f"({sorted(meta)}, data {sorted(data)})")
    print(f"host fit to {k} (device_data=False): "
          f"{res['slices_per_sec']:.2f} slices/s including validation and "
          f"checkpoints, beside the store path's {store_sps[0]:.2f} (fit to "
          f"{FIT_STEPS} above); val pass "
          f"{[round(v, 3) for v in res['val_seconds']]} s, fused launches "
          f"{launches}, best dice {res['best_dice']}, on {card}")
    print(f"host fit files: {files}")


def run_cc_fit(card, train_ds, val_ds):
    """Phase 7f: ``fit`` of contrastive_cross at north-star config 4's size
    (a UNet and SwinUnet-tiny with the four heads, batch 16 = 8 + 8 at
    224^2) from the store's ``weak`` mode, 100 iterations with one
    validation of both slots and one checkpoint: the dual-model files and
    no head files (the heads are in the full state only), two launches of
    kernel #1 each way an iteration."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine, fit
    from cvssl_tpu_torch.utils import checkpoint as ckpt

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cc_")
    cfg = vit_config("contrastive_cross", val_every=CC_FIT_STEPS,
                     ckpt_every=CC_FIT_STEPS, log_every=50,
                     snapshot_root=tmp, exp="ACDC/smoke_cc",
                     patch_size2=(VIT_PATCH, VIT_PATCH))
    engine = Engine(cfg)
    fcd.reset_launches()
    res = fit(cfg, engine=engine, max_steps=CC_FIT_STEPS,
              data=(train_ds, two_stream(cfg.seed, VIT_BATCH,
                                         VIT_LABELED_BS), val_ds))
    torch.cuda.synchronize()
    launches = dict(fcd.LAUNCHES)
    if res["iterations"] != CC_FIT_STEPS or engine.store.mode != "weak":
        raise SystemExit(f"contrastive_cross fit: {res['iterations']} "
                         f"iterations, store mode {engine.store.mode}")
    if any(v != 2 * CC_FIT_STEPS for v in launches.values()):
        raise SystemExit(f"contrastive_cross fit: launches {launches} in "
                         f"{CC_FIT_STEPS} iterations")
    if (len(res["val_seconds"]) != 2
            or set(res["best_dice"]) != {"model1", "model2"}):
        raise SystemExit(f"contrastive_cross fit: {len(res['val_seconds'])}"
                         f" validations of {sorted(res['best_dice'])}")
    snap = cfg.snapshot_path()
    files = sorted(os.listdir(snap))
    k = CC_FIT_STEPS
    for name in (f"model1_iter_{k}.ckpt", f"model2_iter_{k}.ckpt",
                 f"model_iter_{k}.ckpt"):
        if name not in files:
            raise SystemExit(f"contrastive_cross fit: no {name} in {files}")
    if any(h in f for f in files for h in ("ema", "classifier", "projector")):
        raise SystemExit(f"contrastive_cross fit: head or EMA files {files}")
    full = ckpt.load_weights(os.path.join(snap, f"model_iter_{k}.ckpt"))
    if set(full["state"]["optimizers"]) != {"model1", "model2"} or \
            len(full["state"]["models"]) != 6:
        raise SystemExit("contrastive_cross fit: full state of "
                         f"{sorted(full['state']['models'])}, optimizers "
                         f"{sorted(full['state']['optimizers'])}")
    print(f"contrastive_cross fit to {k} (UNet + SwinUnet + heads, batch "
          f"{VIT_BATCH} at {VIT_PATCH}^2, weak store): "
          f"{res['slices_per_sec']:.2f} slices/s including validation and "
          f"checkpoints, val passes "
          f"{[round(v, 3) for v in res['val_seconds']]} s, fused launches "
          f"{launches}, best dice {res['best_dice']}, on {card}")
    print(f"contrastive_cross fit files: {files}")


def cta_data(base, cfg, method):
    """(dataset, sampler) of the CTA host path, from ``build_cta_data``'s
    own ``cta_train_data`` on the in-memory slices."""
    from cvssl_tpu_torch.train.engine import cta_train_data
    return cta_train_data(cfg, method,
                          lambda *args: HostSlices(base, *args))


def run_ccons_fit(card, train_ds, val_ds, strict):
    """Phase 7g, contrastive_consistency on the host CTA path at the
    reference's recipe (two SwinUnet-tiny and four projector heads, batch
    16 = 8 + 8 at 224^2, on cell 2's train slices and the val volumes at
    224^2): the host's time to transform and collate a CTA batch (one
    thread, as the loader runs it); a few steps from the pipeline's pinned
    batches through ``fit``'s own iteration, ``cta_iteration`` (under sync
    debug mode "error" if ``strict``), then ms/step over more and a
    one-step profile; then a 68-iteration ``fit`` (4 epochs of 17) with
    one validation of both slots and one checkpoint: the host path (no
    store, though ``device_data`` is True),
    kernel #1 twice each way an iteration, the policy refreshes (each
    epoch, and after unfavorable crops), the rates moved, projector1/2
    tracking projector3/4 (which did not move), peak memory, slices/s.
    Returns kernel #1's launches in the fit."""
    import torch
    from cvssl_tpu_torch.data.pipeline import DataPipeline, collate
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine, cta_iteration, fit
    from cvssl_tpu_torch.utils import checkpoint as ckpt

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ccons_")
    cfg = vit_config("contrastive_consistency", model="swin_unet",
                     val_every=CCONS_FIT_STEPS, ckpt_every=CCONS_FIT_STEPS,
                     log_every=50, snapshot_root=tmp, exp="ACDC/smoke_ccons",
                     patch_size2=(VIT_PATCH, VIT_PATCH))
    engine = Engine(cfg)
    method = engine.method
    ds, sampler = cta_data(train_ds, cfg, method)
    indices = sampler.epochs()
    load_s = []
    for _ in range(CTA_TIMED_BATCHES):
        t0 = time.perf_counter()
        collate([ds.load(i, ds.ops_weak, ds.ops_strong)
                 for i in next(indices)])
        load_s.append(time.perf_counter() - t0)
    load_ms = float(np.median(load_s)) * 1e3
    print(f"CTA host batch ({VIT_BATCH} slices of "
          f"{train_ds[0]['image'].shape} to {VIT_PATCH}^2, weak and strong "
          f"policies of depth 2, one thread, median of "
          f"{CTA_TIMED_BATCHES}): transform + collate {load_ms:.2f} ms; the "
          f"step needs {VIT_BATCH * 1e3 / load_ms:.1f} slices/s of the host "
          "at most")

    t_steps = time.perf_counter()
    state = engine.init_state()
    ds, sampler = cta_data(train_ds, cfg, method)
    pipe = DataPipeline(ds, sampler, pin_memory=True,
                        policy=lambda: (ds.ops_weak, ds.ops_strong),
                        loader_rng=ds.transform.rng)
    stream = pipe.stream()
    method.on_epoch_start(ds, 0)

    def step():
        nonlocal state
        state, metrics = cta_iteration(engine, state, next(stream), pipe,
                                       ds, len(sampler))
        return state, metrics
    try:
        step()
        for _ in range(CTA_CHECKED_STEPS):
            if strict:
                torch.cuda.set_sync_debug_mode("error")
            try:
                _, metrics = step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CTA_TIMED_STEPS):
            _, metrics = step()
        float(metrics["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / CTA_TIMED_STEPS
        busy = profile_steps(engine, state, None, step_s,
                             steps=CTA_PROFILED_STEPS, top=8,
                             step_fn=step)
    finally:
        stream.close()
    vals = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in vals.values()):
        raise SystemExit(f"contrastive_consistency step: {vals}")
    print(f"contrastive_consistency on the CTA pipeline: "
          f"{CTA_CHECKED_STEPS} steps"
          f"{' under sync debug mode error' if strict else ''}, then "
          f"{step_s * 1e3:.2f} ms/step ({VIT_BATCH / step_s:.2f} slices/s) "
          f"over {CTA_TIMED_STEPS} steps with the hooks, device busy "
          f"{busy} ms/step, on {card}; metrics {vals} "
          f"({time.perf_counter() - t_steps:.1f} s)")
    del engine, state, pipe
    torch.cuda.empty_cache()

    t_fit = time.perf_counter()

    engine = Engine(cfg)
    method = engine.method
    heads = ("projector1", "projector2", "projector3", "projector4")
    start = {}
    init_state = engine.init_state

    def capture(seed=None):
        st = init_state(seed)
        start.update({n: [p.detach().clone()
                          for p in st.models[n].parameters()]
                      for n in heads})
        return st
    engine.init_state = capture
    refreshes = {"epoch": 0, "crop": 0}
    on_epoch_start, on_batch = method.on_epoch_start, method.on_batch

    def count_epoch(dataset, it):
        refreshes["epoch"] += 1
        return on_epoch_start(dataset, it)

    def count_crop(batch, dataset):
        before = (dataset.ops_weak, dataset.ops_strong)
        on_batch(batch, dataset)
        refreshes["crop"] += (dataset.ops_weak, dataset.ops_strong) != before
    method.on_epoch_start, method.on_batch = count_epoch, count_crop
    fcd.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = fit(cfg, engine=engine, max_steps=CCONS_FIT_STEPS,
              data=(*cta_data(train_ds, cfg, method), val_ds))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(fcd.LAUNCHES)
    if res["iterations"] != CCONS_FIT_STEPS or engine.store is not None:
        raise SystemExit(f"contrastive_consistency fit: {res['iterations']}"
                         f" iterations, store {engine.store}")
    if any(v != 2 * CCONS_FIT_STEPS for v in launches.values()):
        raise SystemExit(f"contrastive_consistency fit: launches {launches}"
                         f" in {CCONS_FIT_STEPS} iterations")
    if (len(res["val_seconds"]) != 2
            or set(res["best_dice"]) != {"model1", "model2"}):
        raise SystemExit(f"contrastive_consistency fit: "
                         f"{len(res['val_seconds'])} validations of "
                         f"{sorted(res['best_dice'])}")
    epochs = CCONS_FIT_STEPS // (ACDC_LABELED_SLICES // VIT_LABELED_BS)
    if refreshes["epoch"] != 1 + epochs:
        raise SystemExit(f"contrastive_consistency fit: {refreshes} policy "
                         f"refreshes in {epochs} epochs")
    moved = sum(int((r != 1).sum()) for rates in method.cta.rates.values()
                for r in rates)
    if not moved:
        raise SystemExit("contrastive_consistency fit: no CTA rate moved")
    models = res["state"].models
    for dst, src in method.param_ema_map.items():
        for a, b, a0 in zip(models[dst].parameters(),
                            models[src].parameters(), start[dst]):
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-7):
                raise SystemExit(f"{dst} does not track {src}")
        if all(torch.equal(a0, b) for a0, b in
               zip(start[dst], models[src].parameters())):
            raise SystemExit(f"{dst} started as {src}: nothing to track")
        if not all(torch.equal(a, b) for a, b in
                   zip(start[src], models[src].parameters())):
            raise SystemExit(f"{src}'s weights moved (it is in no "
                             "optimizer)")
    snap = cfg.snapshot_path()
    files = sorted(os.listdir(snap))
    k = CCONS_FIT_STEPS
    for name in (f"model1_iter_{k}.ckpt", f"model2_iter_{k}.ckpt",
                 f"model_iter_{k}.ckpt"):
        if name not in files:
            raise SystemExit(f"contrastive_consistency fit: no {name} in "
                             f"{files}")
    meta = ckpt.load_weights(os.path.join(snap, f"model_iter_{k}.ckpt"))[
        "meta"]
    if not {"data", "cta"} <= set(meta) or not meta["data"]["requests"]:
        raise SystemExit(f"contrastive_consistency fit: meta {sorted(meta)}")
    print(f"contrastive_consistency fit to {k} (two SwinUnet-tiny + four "
          f"heads, batch {VIT_BATCH} at {VIT_PATCH}^2, host CTA path): "
          f"{res['slices_per_sec']:.2f} slices/s including validation and "
          f"checkpoints ({VIT_BATCH * 1e3 / res['slices_per_sec']:.2f} "
          f"ms/iteration), peak memory {peak / 2 ** 30:.3f} GiB, policy "
          f"refreshes {refreshes}, {moved} CTA bins moved, val passes "
          f"{[round(v, 3) for v in res['val_seconds']]} s, fused launches "
          f"{launches}, best dice {res['best_dice']}, on {card}")
    print(f"contrastive_consistency fit files: {files} "
          f"({time.perf_counter() - t_fit:.1f} s)")
    print(f"phase 7g contrastive_consistency: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches



# ---------------------------------------------------------------------------
# Phase 8: the 3D path (north-star config 5)
# ---------------------------------------------------------------------------

def config_3d(method, **kw):
    """North-star config 5's configuration of ``method``: unet_3D, batch
    4 = 2 + 2 at 96^3, 2 classes, dtype auto; ``kw`` overrides."""
    from cvssl_tpu_torch.train.config import TrainConfig
    base = dict(method=method, model="unet_3D", dim=3,
                num_classes=CLASSES_3D, batch_size=BATCH_3D,
                labeled_bs=LABELED_BS_3D, patch_size=(PATCH_3D,) * 3,
                labeled_num=BRATS_LABELED, total_num=BRATS_TRAIN)
    return TrainConfig(**{**base, **kw})


def two_stream_3d(seed, labeled=BRATS_LABELED, total=BRATS_TRAIN):
    """Config 5's sampler: 2 of the labeled volumes + 2 of the rest a
    batch."""
    from cvssl_tpu_torch.data.sampler import TwoStreamBatchSampler
    return TwoStreamBatchSampler(
        list(range(labeled)), list(range(labeled, total)), BATCH_3D,
        BATCH_3D - LABELED_BS_3D, rng=np.random.default_rng(seed))


def brats_volumes(device, n=BRATS_TRAIN, seed=0):
    """BraTS2019's train count of blob volumes at 140 x 180 x 180, drawn on
    the card volume by volume (``data/synthetic.py::DeviceBlobVolumes``)."""
    from cvssl_tpu_torch.data.synthetic import DeviceBlobVolumes
    return DeviceBlobVolumes(n, BRATS_VOLUME, seed=seed,
                             num_classes=CLASSES_3D, device=device)


def spy_teacher_passes():
    """Record (name, batch) of every teacher pass of ``StepCtx``; returns
    the list and a function that ends the recording."""
    from cvssl_tpu_torch.train.state import StepCtx
    passes, restore = [], []
    for name in ("forward_teacher", "forward_teacher_scan"):
        inner = getattr(StepCtx, name)

        def spy(self, slot, x, *a, inner=inner, name=name, **k):
            passes.append((name, x.shape[0]))
            return inner(self, slot, x, *a, **k)
        restore.append((name, inner))
        setattr(StepCtx, name, spy)

    def stop():
        for name, inner in restore:
            setattr(StepCtx, name, inner)
    return passes, stop


def run_3d_methods(card, strict, store):
    """Phase 8.2-8.3: UAMT-3D at config 5 (kernel #1 once each way a step;
    the teacher moved; exactly one teacher pass over the (T + 1) * u = 18
    volumes a step, counted; its masked consistency live after step 1000
    with the output conv scaled as phase 5 scales the UNet's; volumes/s
    over 30 steps, peak memory and a one-step profile), then supervised,
    mean_teacher, cps, ict, adversarial and exam_student_teacher
    (FC3DDiscriminator) from the same store, 5 + 5 checked steps and 10
    timed each."""
    import torch
    from cvssl_tpu_torch.train.engine import Engine

    results = {}
    stream = two_stream_3d(8).epochs()
    t0 = time.perf_counter()
    cfg = config_3d("uamt")
    engine = Engine(cfg)
    engine.attach_store(store)
    state = engine.init_state()
    for m in (state.models["model"], state.teachers["model"]):
        with torch.no_grad():
            m.final.weight.mul_(UAMT_LOGIT_SCALE)
            m.final.bias.mul_(UAMT_LOGIT_SCALE)
    passes, stop = spy_teacher_passes()
    try:
        results["uamt_3d"] = drive_method(
            engine, state, stream, 1, strict, card, BATCH_3D,
            checked=UAMT_3D_CHECKED, timed=UAMT_3D_TIMED, profiled=1,
            top=15, count=True)
    finally:
        stop()
    u = BATCH_3D - LABELED_BS_3D
    want = ("forward_teacher", (cfg.uncertainty_T + 1) * u)
    if not passes or set(passes) != {want}:
        raise SystemExit(f"uamt 3D: teacher passes {sorted(set(passes))}, "
                         f"not one {want} a step")
    steps = 2 * UAMT_3D_CHECKED + UAMT_3D_TIMED + 2   # + counted, profiled
    if len(passes) != steps:
        raise SystemExit(f"uamt 3D: {len(passes)} teacher passes in "
                         f"{steps} steps")
    print(f"uamt 3D: {len(passes)} steps, each with one teacher pass over "
          f"{want[1]} volumes ((T + 1) * u); phase part "
          f"{time.perf_counter() - t0:.1f} s")
    del engine, state
    torch.cuda.empty_cache()
    for method, per_step in METHOD_LAUNCHES_3D.items():
        t0 = time.perf_counter()
        engine = Engine(config_3d(method))
        engine.attach_store(store)
        state = engine.init_state()
        results[f"{method}_3d"] = drive_method(
            engine, state, stream, per_step, strict, card, BATCH_3D,
            checked=METHOD_3D_CHECKED, timed=METHOD_3D_TIMED, profiled=1)
        print(f"{method} 3D: phase part {time.perf_counter() - t0:.1f} s")
        del engine, state
        torch.cuda.empty_cache()
    return results


def check_deep_sup_eval(device):
    """Phase 8.4: UNet3DDeepSup's four eval-mode heads in float32 on the
    card against the same weights on the CPU, at 64^3."""
    import copy

    import torch
    from cvssl_tpu_torch.models import net_factory_3d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        ref = net_factory_3d("unet_3D_dv_semi", 1, CLASSES_3D).eval()
    net = copy.deepcopy(ref).to(device)
    x = brats_volumes(device, 1, seed=77)[0]["image"][None, None,
                                                      :64, :64, :64]
    with torch.no_grad():
        got = [o.cpu() for o in net(x.contiguous())]
        want = ref(x.cpu())
    errs = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    print(f"UNet3DDeepSup eval: 4 heads of {tuple(got[0].shape)} "
          f"{got[0].dtype}; f32 card vs CPU max rel err {max(errs):.2e}")
    if any(g.dtype != torch.float32 for g in got) or max(errs) > 1e-4:
        raise SystemExit("UNet3DDeepSup's f32 eval forward on the card "
                         "disagrees with the CPU")


def run_sliding_window(device, card):
    """Phase 8.5: the sliding window (``eval/val3d.py``) on 5 volumes of
    140 x 180 x 180, 18 windows each at stride 64, UNet3D's eval softmax,
    pipelined as a validation runs it (volume i + 1 queued before volume i
    is collected): volumes/s over two passes after a warm-up; the label
    maps' shape and classes; and the evaluator with a net that thresholds
    each voxel against the thresholded volume, exactly."""
    import torch
    from cvssl_tpu_torch.eval import val3d
    from cvssl_tpu_torch.train.engine import Engine

    engine = Engine(config_3d("uamt"))
    state = engine.init_state()
    patch = (PATCH_3D,) * 3
    ev = val3d.SlidingWindowEvaluator(engine.predict_probs_fn("model", state),
                                      patch, CLASSES_3D, 64, 64,
                                      device=device)
    n_win = len(ev.plan(BRATS_VOLUME)[2])
    if n_win != SW_WINDOWS:
        raise SystemExit(f"sliding window: {n_win} windows, not "
                         f"{SW_WINDOWS}")
    src = brats_volumes(device, SW_VOLUMES, seed=500)
    vols = [src[i]["image"] for i in range(SW_VOLUMES)]
    first = ev.predict_volume(vols[0])
    if first.shape != BRATS_VOLUME or not set(np.unique(first)) <= {0, 1}:
        raise SystemExit(f"sliding window: map {first.shape} "
                         f"{np.unique(first)}")
    rates = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = None
        for i in range(SW_VOLUMES + 1):
            nxt = ev.predict_volume_async(vols[i]) if i < SW_VOLUMES \
                else None
            if pending is not None:
                pending()
            pending = nxt
        rates.append(SW_VOLUMES / (time.perf_counter() - t0))
    report_mfu(f"sliding window (a volume of {BRATS_VOLUME}, {n_win} "
               f"windows)", ev.last_flops(), 1.0 / rates[1], card)

    def threshold(x):
        hi = (x > 0.5).float()
        return torch.cat([1.0 - hi, hi], dim=1)
    ev_t = val3d.SlidingWindowEvaluator(threshold, patch, CLASSES_3D, 64, 64,
                                        device=device)
    small = src[1]["image"][:90, :130, :140]   # under the patch on one axis
    for vol in (vols[1], small):
        got = ev_t.predict_volume(vol)
        if not np.array_equal(got, (vol > 0.5).cpu().numpy()):
            raise SystemExit(f"sliding window of a threshold net on "
                             f"{tuple(vol.shape)}: not the threshold")
    print(f"sliding window: {SW_VOLUMES} volumes of {BRATS_VOLUME}, "
          f"{n_win} windows each, batches of {ev.patch_batch}, pipelined: "
          f"{rates[0]:.3f} / {rates[1]:.3f} volumes/s; a threshold net's "
          f"maps exact (also on {tuple(small.shape)}), on {card}")
    return rates


def run_fit_3d(device, card):
    """Phase 8.6: ``fit`` of UAMT-3D at config 5 from the device store of
    the 250 volumes (under the 8 GiB rule): 100 iterations with one
    validation (4 val volumes of mixed shapes) and one checkpoint, then a
    resume to 150; the files, the val table, kernel #1's launches (one
    each way an iteration; their sum over both calls is returned, with
    the weights phase 9's 3D test CLI loads, :func:`test_weights`),
    volumes/s including validation, the val pass's seconds and the host's
    HD95 share of it."""
    import torch
    from cvssl_tpu_torch.data.device_store import (STORE_LIMIT_BYTES,
                                                   DeviceVolumeStore)
    from cvssl_tpu_torch.data.synthetic import blob_volumes
    from cvssl_tpu_torch.eval import val3d
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine, fit

    train = brats_volumes(device)
    est = DeviceVolumeStore.estimated_bytes(train, (PATCH_3D,) * 3)
    if est >= STORE_LIMIT_BYTES:
        raise SystemExit(f"3D store estimate {est} bytes: over the rule")
    val = blob_volumes(VAL_3D_SHAPES, seed=20_000, num_classes=CLASSES_3D)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit3d_")
    cfg = config_3d("uamt", val_every=FIT_3D_STEPS, ckpt_every=FIT_3D_STEPS,
                    log_every=50, snapshot_root=tmp, exp="BraTS/smoke")
    snap = cfg.snapshot_path()
    hd95_s = []
    inner = val3d.M.hd95

    def timed_hd95(*a, **k):
        t0 = time.perf_counter()
        out = inner(*a, **k)
        hd95_s.append(time.perf_counter() - t0)
        return out
    val3d.M.hd95 = timed_hd95
    done, total = 0, {}
    try:
        for steps in (FIT_3D_STEPS, FIT_3D_RESUME):
            engine = Engine(cfg)
            fcd.reset_launches()
            t0 = time.perf_counter()
            res = fit(cfg, engine=engine, max_steps=steps,
                      data=(train, two_stream_3d(cfg.seed), val))
            wall = time.perf_counter() - t0
            launches = dict(fcd.LAUNCHES)
            ran = steps - done
            if res["iterations"] != steps or any(v != ran for v in
                                                  launches.values()):
                raise SystemExit(f"3D fit to {steps}: {res['iterations']} "
                                 f"iterations, launches {launches}")
            if not isinstance(engine.store, DeviceVolumeStore):
                raise SystemExit(f"3D fit: store {engine.store}")
            print(f"3D fit to {steps}: {ran} iterations, "
                  f"{res['slices_per_sec']:.3f} volumes/s including "
                  f"validation and checkpoints ({wall:.1f} s wall with the "
                  f"store build), val passes "
                  f"{[round(v, 3) for v in res['val_seconds']]} s, HD95 on "
                  f"the host {sum(hd95_s):.3f} s in {len(hd95_s)} calls, "
                  f"fused launches {launches}, best dice "
                  f"{res['best_dice']}, on {card}")
            done = steps
            total = {k: total.get(k, 0) + v for k, v in launches.items()}
        with open(os.path.join(snap, "log.txt")) as f:
            if f"resumed from iteration {FIT_3D_STEPS}" not in f.read():
                raise SystemExit("3D fit: no resume logged")
        files = sorted(os.listdir(snap))
        for name in (f"iter_{FIT_3D_STEPS}.ckpt",
                     f"ema_model_iter_{FIT_3D_STEPS}.ckpt",
                     f"model_iter_{FIT_3D_STEPS}.ckpt"):
            if name not in files:
                raise SystemExit(f"3D fit: no {name} in {files}")
        if res["best_dice"]["model"] > 0 and not (
                "unet_3D_best_model.ckpt" in files and glob.glob(
                    os.path.join(snap, f"iter_{FIT_3D_STEPS}_dice_*.ckpt"))):
            raise SystemExit(f"3D fit: no best-model files in {files}")
        print(f"3D fit files: {files}")
        hd95_s.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = engine.validate(res["state"], val)
        val_s = time.perf_counter() - t0
    finally:
        val3d.M.hd95 = inner
    if table.shape != (CLASSES_3D - 1, 2) or not (
            np.isfinite(table).all() and (table[:, 0] >= 0).all()
            and (table[:, 0] <= 1).all()):
        raise SystemExit(f"3D val table {table}")
    print(f"3D val table (dice, hd95): {table.tolist()} over "
          f"{len(val)} volumes {[v['image'].shape for v in val]}; val pass "
          f"{val_s:.3f} s, of which HD95 on the host {sum(hd95_s):.3f} s "
          f"(share {sum(hd95_s) / val_s:.3f}), on {card}")
    return total, test_weights(snap, "unet_3D", res["state"])


def test_weights(snap, model, state):
    """The weights phase 9's test CLI loads: the fit's
    ``{model}_best_model.ckpt``, or, where no validation scored above 0
    Dice (no best model written), its final weights written beside it."""
    import torch
    best = os.path.join(snap, f"{model}_best_model.ckpt")
    if os.path.exists(best):
        return best
    final = os.path.join(snap, f"{model}_final_weights.ckpt")
    torch.save({k: v.cpu() for k, v in
                state.models["model"].state_dict().items()}, final)
    print(f"{snap}: no {model}_best_model.ckpt (best Dice 0); the test CLI "
          f"loads the final weights")
    return final


class HostVolumes:
    """The 3D host path's train set: each volume through the host
    transform, with its index."""

    def __init__(self, base, transform):
        self.base, self.transform = base, transform

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        from cvssl_tpu_torch.data.datasets import transform_sample
        return {**transform_sample(self.transform, self.base[i]), "idx": i}


def run_host_3d(card, strict):
    """Phase 8.7, the 3D host path (``device_data=False``): 8 volumes of
    140 x 180 x 180 in host memory, the reference's RandomRotFlip3D +
    RandomCrop(96^3) drawing from the sampler's generator (as
    ``build_3d_data`` pairs them); the host's time to load a batch of 4
    (one thread) and to pin it; a few UAMT-3D steps from the pipeline's
    pinned batches (under sync debug mode "error" if ``strict``)."""
    import torch
    from cvssl_tpu_torch.data import transforms as T
    from cvssl_tpu_torch.data.pipeline import DataPipeline, pinned
    from cvssl_tpu_torch.data.synthetic import blob_volumes
    from cvssl_tpu_torch.train.engine import Engine

    t0 = time.perf_counter()
    base = blob_volumes([BRATS_VOLUME] * HOST_3D_VOLUMES, seed=30_000,
                        num_classes=CLASSES_3D)
    made = time.perf_counter() - t0

    def data():
        sampler = two_stream_3d(1, LABELED_BS_3D, HOST_3D_VOLUMES)
        transform = T.Compose([T.RandomRotFlip3D(sampler.rng),
                               T.RandomCrop((PATCH_3D,) * 3,
                                            rng=sampler.rng)])
        return HostVolumes(base, transform), sampler
    pipe = DataPipeline(*data())
    indices = pipe.batch_sampler.epochs()
    load_s, pin_s = [], []
    for _ in range(HOST_3D_TIMED):
        t0 = time.perf_counter()
        batch = pipe._load_batch(next(indices))
        t1 = time.perf_counter()
        pinned(batch)
        load_s.append(t1 - t0)
        pin_s.append(time.perf_counter() - t1)
    load_ms, pin_ms = (float(np.median(v)) * 1e3 for v in (load_s, pin_s))
    if batch["image"].shape != (BATCH_3D, 1) + (PATCH_3D,) * 3:
        raise SystemExit(f"3D host batch {batch['image'].shape}")
    print(f"3D host batch ({BATCH_3D} volumes of {BRATS_VOLUME} cropped to "
          f"{PATCH_3D}^3, one thread, median of {HOST_3D_TIMED}; volumes "
          f"made in {made:.1f} s): transform + collate {load_ms:.2f} ms, "
          f"pinning {pin_ms:.2f} ms")
    engine = Engine(config_3d("uamt", device_data=False))
    state = engine.init_state()
    stream = DataPipeline(*data(), pin_memory=True).stream()
    try:
        engine.train_step(state, engine.host_batch(next(stream)))
        t0 = time.perf_counter()
        for _ in range(HOST_3D_STEPS):
            batch = next(stream)
            if strict:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, metrics = engine.train_step(
                    state, engine.host_batch(batch))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        loss = float(metrics["loss"])
        step_ms = (time.perf_counter() - t0) / HOST_3D_STEPS * 1e3
    finally:
        stream.close()
    if not math.isfinite(loss):
        raise SystemExit(f"3D host path step: loss {loss}")
    print(f"3D host path: {HOST_3D_STEPS} UAMT-3D steps from pinned batches"
          f"{' under sync debug mode error' if strict else ''}, "
          f"{step_ms:.2f} ms/step, loss {loss:.4f}, on {card}")
    return load_ms


def run_3d(device, card, strict, mem_bw, f32_rate):
    """Phase 8: the 3D path. Kernel #1 at config 5's (2, 2, 96, 96, 96)
    and a ragged (2, 2, 17, 19, 23), f32 and bf16 logits, int32 and uint8
    labels, against float64 and bit-equal on repeat, and its time at
    config 5's shape; the store of 250 volumes of 140 x 180 x 180 built on
    the card; then :func:`run_3d_methods`, :func:`check_deep_sup_eval`,
    :func:`run_sliding_window`, :func:`run_fit_3d` and
    :func:`run_host_3d`, each part's seconds printed. Returns kernel #1's
    errors and times at 5D, the launches of each 3D run and the UAMT-3D
    fit's weights for phase 9."""
    import torch
    from cvssl_tpu_torch.data.device_store import DeviceVolumeStore

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(5)
    err = {"ce_dice_fwd": 0.0, "ce_dice_bwd": 0.0}
    for shape, vector in ((SHAPE_3D, True), (RAGGED_3D, False)):
        for dtype in (torch.float32, torch.bfloat16):
            for label_dtype in (torch.int32, torch.uint8):
                check_case(device, gen, shape, dtype, label_dtype, False,
                           vector, err)
    timing = time_kernels(device, mem_bw, f32_rate, SHAPE_3D)
    print(f"phase 8 part kernel #1 at 5D: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    store = DeviceVolumeStore(brats_volumes(device), (PATCH_3D,) * 3)
    torch.cuda.synchronize()
    print(f"3D store: {tuple(store.images.shape)} {store.images.dtype} + "
          f"{store.labels.dtype}, "
          f"{(store.images.nbytes + store.labels.nbytes) / 1e9:.3f} GB on "
          f"{store.images.device}, drawn and built in "
          f"{time.perf_counter() - t0:.1f} s")
    methods = run_3d_methods(card, strict, store)
    del store
    torch.cuda.empty_cache()
    print(f"phase 8 part methods: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_deep_sup_eval(device)
    rates = run_sliding_window(device, card)
    print(f"phase 8 part deep-sup eval + sliding window: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, weights = run_fit_3d(device, card)
    methods["uamt_3d_fit"] = {"launches": launches}
    torch.cuda.empty_cache()
    print(f"phase 8 part fit: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_host_3d(card, strict)
    print(f"phase 8 part host path: {time.perf_counter() - t0:.1f} s")
    print(f"phase 8 (3D): {time.perf_counter() - t_phase:.1f} s")
    return {"err": err, "timing": timing, "methods": methods,
            "sw_volumes_per_s": rates, "weights": weights}


# ---------------------------------------------------------------------------
# Phase 9: the held-out test CLIs and the 3D CNN zoo
# ---------------------------------------------------------------------------

def test_volumes_2d(seed=40_000, n=TEST_2D_VOLUMES):
    """``n`` blob volumes (ACDC's test count), ``TEST_2D_SLICES`` slices
    each, at ACDC's mixed in-plane sizes, by case name."""
    from cvssl_tpu_torch.data.synthetic import blob_image
    rng = np.random.default_rng(seed)
    vols = {}
    for i in range(n):
        shape = TEST_2D_SHAPES[i % len(TEST_2D_SHAPES)]
        pairs = [blob_image(rng, shape, CLASSES)
                 for _ in range(TEST_2D_SLICES)]
        vols[f"patient{i:03d}"] = (np.stack([p[0] for p in pairs]),
                                   np.stack([p[1] for p in pairs]))
    return vols


def placed_weights(flags, weights):
    """``weights`` copied to the test CLI's ``{snapshot}/{model}_best_model
    .ckpt``, where it loads them."""
    import shutil

    from cvssl_tpu_torch.eval.test_3d import snapshot_dir
    os.makedirs(snapshot_dir(flags), exist_ok=True)
    shutil.copy(weights, os.path.join(snapshot_dir(flags),
                                      f"{flags.model}_best_model.ckpt"))


def run_test_2d(card, weights):
    """Phase 9a: the 2D test CLI (``eval/test_2d.py``'s ``inference`` with
    ``--full_metrics``) on 40 ACDC-shaped volumes of mixed sizes with the
    mean-teacher fit's UNet: per-class (dice, hd95, asd); one case's three
    exports read back with the port's ``load_nifti`` (the prediction equal
    to the predictor's output, image and label to the inputs); the seconds
    per volume in each phase (zoom in, predict, zoom out, metrics,
    export)."""
    from cvssl_tpu_torch.eval import test_2d
    from cvssl_tpu_torch.eval.test_3d import snapshot_dir
    from cvssl_tpu_torch.utils.nifti import load_nifti

    t0 = time.perf_counter()
    vols = test_volumes_2d()
    made = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_test2d_")
    flags = test_2d.build_parser().parse_args([
        "--root_path", tmp, "--exp", "ACDC/smoke_test", "--model", "unet",
        "--num_classes", str(CLASSES), "--labeled_num", "7",
        "--snapshot_root", tmp, "--full_metrics"])
    placed_weights(flags, weights)
    times = {}
    t0 = time.perf_counter()
    avg = test_2d.inference(flags, volumes=vols, times=times)
    wall = time.perf_counter() - t0
    if avg.shape != (CLASSES - 1, 3) or not np.isfinite(avg).all() or not (
            (avg[:, 0] >= 0) & (avg[:, 0] <= 1)).all():
        raise SystemExit(f"test_2d: per-class results {avg}")
    case = "patient003"                     # the 428 x 512 volume
    image, label = vols[case]
    out = snapshot_dir(flags) + "_predictions"
    files = {t: load_nifti(os.path.join(out, f"{case}_{t}.nii.gz"))
             for t in ("pred", "img", "gt")}
    _, pred = test_2d.test_single_volume(
        image, label, test_2d.load_predictor(flags), flags)
    for tag, want in (("pred", pred), ("img", image), ("gt", label)):
        got, spacing = files[tag]
        if not (got.dtype == np.float32 and np.array_equal(
                got, want.astype(np.float32))
                and np.allclose(spacing, (1.0, 1.0, 10.0))):
            raise SystemExit(f"test_2d export {case}_{tag}: not the "
                             f"{tag} it scored")
    if len(os.listdir(out)) != 3 * TEST_2D_VOLUMES:
        raise SystemExit(f"test_2d: {len(os.listdir(out))} exports")
    per = {k: times[k] / TEST_2D_VOLUMES for k in test_2d.PHASES}
    zoom = per["zoom_in"] + per["zoom_out"]
    print(f"test_2d: {TEST_2D_VOLUMES} volumes of {TEST_2D_SLICES} slices "
          f"at {TEST_2D_SHAPES} (made in {made:.1f} s), --full_metrics, "
          f"per class (dice, hd95, asd) {avg.round(4).tolist()}; "
          f"{wall:.2f} s, {wall / TEST_2D_VOLUMES * 1e3:.1f} ms a volume: "
          + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in per.items())
          + f" ms; the host zoom's share {zoom * TEST_2D_VOLUMES / wall:.3f}"
          f"; {case}'s exports read back equal, on {card}")
    return {"s_per_volume": wall / TEST_2D_VOLUMES, **per}


def run_test_3d(device, card, weights):
    """Phase 9b: the 3D test CLI (``eval/test_3d.py``'s ``inference``) on
    10 volumes of 140 x 180 x 180 with the UAMT-3D fit's UNet3D, patch
    96^3, stride 64, full metrics and export: ``metrics.txt`` parsed (10
    rows and their mean), one case's exports read back (the prediction
    equal to the sliding window's map, image and label to the inputs);
    volumes/s and the host's share of the time in metrics and export."""
    from cvssl_tpu_torch.eval import test_3d, val3d
    from cvssl_tpu_torch.utils.nifti import load_nifti

    src = brats_volumes(device, TEST_3D_VOLUMES, seed=900)
    vols = []
    for i in range(TEST_3D_VOLUMES):
        s = src[i]
        vols.append({"image": s["image"].cpu().numpy(),
                     "label": s["label"].cpu().numpy(),
                     "case": f"BraTS19_{i:03d}"})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_test3d_")
    flags = test_3d.build_parser().parse_args([
        "--root_path", tmp, "--exp", "BraTS2019/smoke_test", "--model",
        "unet_3D", "--labeled_num", str(BRATS_LABELED), "--snapshot_root",
        tmp])
    placed_weights(flags, weights)
    times = {}
    t0 = time.perf_counter()
    mean = test_3d.inference(flags, dataset=vols, times=times)
    wall = time.perf_counter() - t0
    out = test_3d.snapshot_dir(flags) + "_predictions"
    with open(os.path.join(out, "metrics.txt")) as f:
        rows = [ln.strip().split(",") for ln in f]
    table = np.asarray([r[1:] for r in rows], float)
    if ([r[0] for r in rows] != [str(i) for i in range(TEST_3D_VOLUMES)]
            + ["mean"] or table.shape != (TEST_3D_VOLUMES + 1, 4)
            or not np.isfinite(table).all()
            or not np.allclose(table[-1], mean.ravel())
            or not np.allclose(table[:-1].mean(0), table[-1])):
        raise SystemExit(f"test_3d metrics.txt: {rows}")
    case = vols[3]
    ev = val3d.SlidingWindowEvaluator(test_3d.load_predictor(flags),
                                      tuple(flags.patch_size), CLASSES_3D,
                                      flags.stride_xy, flags.stride_z,
                                      device=device)
    want = {"pred": ev.predict_volume(case["image"]).astype(np.uint8),
            "img": case["image"], "lab": case["label"]}
    for tag, arr in want.items():
        got, spacing = load_nifti(os.path.join(
            out, f"{case['case']}_{tag}.nii.gz"))
        if not (got.dtype == arr.dtype and np.array_equal(got, arr)
                and np.allclose(spacing, (1.0, 1.0, 1.0))):
            raise SystemExit(f"test_3d export {case['case']}_{tag}: not "
                             f"the {tag} it scored")
    host = times["metrics"] + times["export"]
    print(f"test_3d: {TEST_3D_VOLUMES} volumes of {BRATS_VOLUME}, patch "
          f"{tuple(flags.patch_size)} stride {flags.stride_xy}, mean (dice, "
          f"ravd, hd95, asd) {mean.round(4).tolist()}; {wall:.2f} s, "
          f"{TEST_3D_VOLUMES / wall:.3f} volumes/s; the host's share "
          f"{host / wall:.3f} (metrics {times['metrics']:.2f} s, export "
          f"{times['export']:.2f} s), waiting on the card "
          f"{times['predict']:.2f} s; metrics.txt and "
          f"{case['case']}'s exports read back equal, on {card}")
    return {"volumes_per_s": TEST_3D_VOLUMES / wall, "wall_s": wall,
            **times}


def check_zoo_eval(engine, state, net, window, device):
    """Phase 9c's and 10's eval checks of a net: the softmax of a window
    batch
    sums to 1 over the classes; the sliding window (stride 64) over one
    140 x 180 x 180 volume gives a map of its shape and classes; the
    float32 eval forward on the card against the same weights on the CPU
    on one ``window``. Returns (windows, seconds of the volume)."""
    import copy

    import torch
    from cvssl_tpu_torch.eval import val3d

    patch = tuple(engine.cfg.patch_size)
    vol = brats_volumes(device, 1, seed=1234)[0]["image"]
    x = vol[None, None, :patch[0], :patch[1], :patch[2]].contiguous()
    probs = engine.eval_probs("model", state.models["model"], x)
    err_sum = float((probs.sum(dim=1) - 1).abs().max())
    if probs.dtype != torch.float32 or err_sum > 1e-5:
        raise SystemExit(f"{net}: eval softmax {probs.dtype}, sums off "
                         f"by {err_sum}")
    ev = val3d.SlidingWindowEvaluator(engine.predict_probs_fn("model",
                                                              state),
                                      patch, CLASSES_3D, 64, 64,
                                      device=device)
    n_win = len(ev.plan(BRATS_VOLUME)[2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    label = ev.predict_volume(vol)
    vol_s = time.perf_counter() - t0
    if label.shape != BRATS_VOLUME or not set(np.unique(label)) <= {0, 1}:
        raise SystemExit(f"{net}: sliding window map {label.shape} "
                         f"{np.unique(label)}")
    model = state.models["model"]
    ref = copy.deepcopy(model).cpu().eval()
    small = vol[None, None, :window[0], :window[1], :window[2]].contiguous()
    model.eval()
    try:
        with torch.no_grad():
            got = model(small).cpu()
            want = ref(small.cpu())
    finally:
        model.train()
    err = float((got - want).abs().max() / want.abs().max())
    print(f"{net} eval: softmax of {tuple(probs.shape)} sums to 1 within "
          f"{err_sum:.1e}; sliding window {n_win} windows, {vol_s:.3f} s a "
          f"volume; f32 card vs CPU on {window} max rel err {err:.2e}")
    if got.dtype != torch.float32 or err > 1e-4:
        raise SystemExit(f"{net}: f32 eval forward on the card disagrees "
                         "with the CPU")
    return n_win, vol_s


def zoo_host_pipeline(patch):
    """The host pipeline of a patch the store does not take: 8 volumes of
    140 x 180 x 180 in host memory through the reference's RandomRotFlip3D
    + RandomCrop(patch), pinned batches of 4 = 2 + 2."""
    from cvssl_tpu_torch.data import transforms as T
    from cvssl_tpu_torch.data.pipeline import DataPipeline
    from cvssl_tpu_torch.data.synthetic import blob_volumes as volumes_3d

    base = volumes_3d([BRATS_VOLUME] * HOST_3D_VOLUMES, seed=31_000,
                      num_classes=CLASSES_3D)
    sampler = two_stream_3d(13, LABELED_BS_3D, HOST_3D_VOLUMES)
    transform = T.Compose([T.RandomRotFlip3D(sampler.rng),
                           T.RandomCrop(patch, rng=sampler.rng)])
    return DataPipeline(HostVolumes(base, transform), sampler,
                        pin_memory=True)


def run_zoo(device, card, strict, mem_bw, f32_rate):
    """Phase 9c and 9d: kernel #1 at nnUNet's (2, 2, 96, 128, 128) float32
    with int32 labels against float64, bit-equal on repeat, and its time
    there; then each zoo net at config 5's recipe (mean_teacher, batch 4 =
    2 + 2, 2 classes, float32) from the store of the 250 volumes at 96^3
    (nnUNet's 96 x 128 x 128 from the host pipeline, as ``fit`` takes it:
    :func:`zoo_host_pipeline`), through :func:`drive_method` (5 + 5
    checked steps, kernel #1 once each way a step, 10 timed, a one-step
    profile) and :func:`check_zoo_eval`; then 2D nnUNet at config 2 (batch 24 = 12 + 12
    at 256^2, 4 classes, float32) from a store of ACDC-shaped slices.
    Returns kernel #1's error and times at nnUNet's shape and the
    launches of each run."""
    import torch
    from cvssl_tpu_torch.data.device_store import (DeviceSliceStore,
                                                   DeviceVolumeStore)
    from cvssl_tpu_torch.train.engine import Engine

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(9)
    err = {"ce_dice_fwd": 0.0, "ce_dice_bwd": 0.0}
    check_case(device, gen, NNUNET_SHAPE, torch.float32, torch.int32, False,
               True, err)
    timing = time_kernels(device, mem_bw, f32_rate, NNUNET_SHAPE, "float32")
    print(f"phase 9 part kernel #1 at nnUNet's shape: "
          f"{time.perf_counter() - t0:.1f} s")
    results, store = {}, None
    for net, (patch, window) in ZOO_3D.items():
        t0 = time.perf_counter()
        on_store = DeviceVolumeStore.takes_patch(patch)
        engine = Engine(config_3d("mean_teacher", model=net,
                                  patch_size=patch, device_data=on_store))
        if engine.model_dtypes != {"model": torch.float32}:
            raise SystemExit(f"{net}: compute dtypes {engine.model_dtypes}")
        state = engine.init_state()
        if on_store:
            if store is None:
                store = DeviceVolumeStore(brats_volumes(device), patch)
            engine.attach_store(store)
            r = drive_method(engine, state, two_stream_3d(11).epochs(), 1,
                             strict, card, BATCH_3D, checked=ZOO_CHECKED,
                             timed=ZOO_TIMED, profiled=1)
        else:
            # the store's rot90 follows the crop and needs the patch's
            # first two sides equal: fit's host pipeline, as fit takes it
            del store
            store = None
            torch.cuda.empty_cache()
            stream = zoo_host_pipeline(patch).stream()
            try:
                r = drive_method(engine, state, None, 1, strict, card,
                                 BATCH_3D, checked=ZOO_CHECKED,
                                 timed=ZOO_TIMED, profiled=1,
                                 batches=stream)
            finally:
                stream.close()
        r["windows"], r["volume_s"] = check_zoo_eval(engine, state, net,
                                                     window, device)
        results[f"mean_teacher_{net.lower()}_3d"] = r
        print(f"{net} 3D: phase part {time.perf_counter() - t0:.1f} s")
        del engine, state
        torch.cuda.empty_cache()
    del store
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine = Engine(method_config("mean_teacher", model="nnUNet"))
    if engine.model_dtypes != {"model": torch.float32}:
        raise SystemExit(f"nnUNet 2D: compute dtypes {engine.model_dtypes}")
    engine.attach_store(DeviceSliceStore(SyntheticACDC(),
                                         engine.cfg.patch_size))
    state = engine.init_state()
    results["mean_teacher_nnunet_2d"] = drive_method(
        engine, state, two_stream(12).epochs(), 1, strict, card, BATCH,
        checked=ZOO_CHECKED, timed=ZOO_TIMED, profiled=1)
    print(f"nnUNet 2D: phase part {time.perf_counter() - t0:.1f} s")
    del engine, state
    torch.cuda.empty_cache()
    return {"err": err, "timing": timing, "methods": results}


def short_fit_weights(device, card):
    """The test CLIs' checkpoints when phase 9 runs alone: a mean-teacher
    UNet ``fit`` of 40 iterations at config 2 and a UAMT-3D ``fit`` of 20
    at config 5, each with one validation (:func:`test_weights`)."""
    import torch
    from cvssl_tpu_torch.data.synthetic import blob_volumes as volumes_3d
    from cvssl_tpu_torch.train.engine import Engine, fit

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_testfits_")
    cfg = method_config("mean_teacher", val_every=TEST_FIT_2D,
                        ckpt_every=TEST_FIT_2D, snapshot_root=tmp,
                        exp="ACDC/smoke9")
    res = fit(cfg, engine=Engine(cfg), max_steps=TEST_FIT_2D,
              data=(BlobSlices(), two_stream(cfg.seed), blob_volumes()))
    w2d = test_weights(cfg.snapshot_path(), "unet", res["state"])
    del res
    cfg = config_3d("uamt", val_every=TEST_FIT_3D, ckpt_every=TEST_FIT_3D,
                    snapshot_root=tmp, exp="BraTS/smoke9")
    res = fit(cfg, engine=Engine(cfg), max_steps=TEST_FIT_3D,
              data=(brats_volumes(device), two_stream_3d(cfg.seed),
                    volumes_3d(VAL_3D_SHAPES[:1], seed=20_000,
                               num_classes=CLASSES_3D)))
    w3d = test_weights(cfg.snapshot_path(), "unet_3D", res["state"])
    del res
    torch.cuda.empty_cache()
    print(f"phase 9 short fits ({TEST_FIT_2D} 2D, {TEST_FIT_3D} 3D "
          f"iterations): {time.perf_counter() - t0:.1f} s, on {card}")
    return w2d, w3d


def run_phase9(device, card, strict, mem_bw, f32_rate, w2d, w3d):
    """Phase 9: :func:`run_test_2d`, :func:`run_test_3d` and
    :func:`run_zoo`, each part's seconds printed."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    test2d = run_test_2d(card, w2d)
    print(f"phase 9 part test_2d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    test3d = run_test_3d(device, card, w3d)
    print(f"phase 9 part test_3d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    zoo = run_zoo(device, card, strict, mem_bw, f32_rate)
    print(f"phase 9 part zoo: {time.perf_counter() - t0:.1f} s")
    print(f"phase 9 (test CLIs and zoo): {time.perf_counter() - t_phase:.1f}"
          " s")
    return {**zoo, "test_2d": test2d, "test_3d": test3d}


# ---------------------------------------------------------------------------
# Phase 10: the 3D ViTs, UNETR and SwinUNETR, fully supervised
# ---------------------------------------------------------------------------

def vit3d_shape(net):
    """Kernel #1's logits at ``net``'s step: the whole batch of 4."""
    return (VIT3D_BATCH, CLASSES_3D) + (VIT3D_PATCH[net],) * 3


def run_vit3d_steps(device, card, strict):
    """Phase 10.2: each 3D ViT at its recipe (supervised, batch 4, 2
    classes, float32, its own patch) from a store of the 250 volumes,
    batches of the 25 labeled: :func:`drive_method` (the parameter count,
    5 + 5 checked steps with kernel #1 once each way a step, 10 timed, a
    one-step profile) and :func:`check_zoo_eval` (eval softmax, the
    sliding window over one volume, the float32 eval forward on one window
    against the CPU)."""
    import torch
    from cvssl_tpu_torch.data.device_store import DeviceVolumeStore
    from cvssl_tpu_torch.data.sampler import ShuffleBatchSampler
    from cvssl_tpu_torch.train.engine import Engine

    results = {}
    volumes = brats_volumes(device)
    for net, side in VIT3D_PATCH.items():
        t0 = time.perf_counter()
        patch = (side,) * 3
        engine = Engine(config_3d("supervised", model=net,
                                  patch_size=patch))
        if engine.model_dtypes != {"model": torch.float32}:
            raise SystemExit(f"{net}: compute dtypes {engine.model_dtypes}")
        store = DeviceVolumeStore(volumes, patch)
        engine.attach_store(store)
        state = engine.init_state()
        stream = ShuffleBatchSampler(BRATS_LABELED, VIT3D_BATCH,
                                     rng=np.random.default_rng(14)).epochs()
        r = drive_method(engine, state, stream, 1, strict, card, VIT3D_BATCH,
                         checked=VIT3D_CHECKED, timed=VIT3D_TIMED,
                         profiled=1)
        r["windows"], r["volume_s"] = check_zoo_eval(engine, state, net,
                                                     patch, device)
        results[f"supervised_{net}_3d"] = r
        print(f"{net}: phase part {time.perf_counter() - t0:.1f} s")
        del engine, state, store
        torch.cuda.empty_cache()
    return results


def run_vit3d_fit(device, card):
    """Phase 10.3: a supervised UNETR ``fit`` of 40 iterations at 96^3 from
    the store of the 25 labeled volumes (one validation over 2 volumes,
    one checkpoint), kernel #1 once each way an iteration; then the 3D
    test CLI with ``--model unetr`` (``load_net`` builds it for the patch)
    on its weights over 2 volumes of 140 x 180 x 180: ``metrics.txt``
    parsed and each case's three files present. Returns the fit's
    launches."""
    import torch
    from cvssl_tpu_torch.data.sampler import ShuffleBatchSampler
    from cvssl_tpu_torch.data.synthetic import blob_volumes
    from cvssl_tpu_torch.eval import test_3d
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine, fit

    tmp = tempfile.mkdtemp(prefix="chip_smoke_vit3d_")
    cfg = config_3d("supervised", model="unetr", val_every=VIT3D_FIT_STEPS,
                    ckpt_every=VIT3D_FIT_STEPS, log_every=20,
                    snapshot_root=tmp, exp="BraTS/smoke_unetr")
    val = blob_volumes(VAL_3D_SHAPES[:2], seed=20_000,
                       num_classes=CLASSES_3D)
    sampler = ShuffleBatchSampler(BRATS_LABELED, VIT3D_BATCH,
                                  rng=np.random.default_rng(cfg.seed))
    fcd.reset_launches()
    t0 = time.perf_counter()
    res = fit(cfg, engine=Engine(cfg), max_steps=VIT3D_FIT_STEPS,
              data=(brats_volumes(device, BRATS_LABELED), sampler, val))
    wall = time.perf_counter() - t0
    launches = dict(fcd.LAUNCHES)
    if res["iterations"] != VIT3D_FIT_STEPS or any(
            v != VIT3D_FIT_STEPS for v in launches.values()):
        raise SystemExit(f"UNETR fit: {res['iterations']} iterations, "
                         f"launches {launches}")
    snap = cfg.snapshot_path()
    files = sorted(os.listdir(snap))
    if f"model_iter_{VIT3D_FIT_STEPS}.ckpt" not in files:
        raise SystemExit(f"UNETR fit: no checkpoint in {files}")
    weights = test_weights(snap, "unetr", res["state"])
    print(f"UNETR fit: {VIT3D_FIT_STEPS} iterations, "
          f"{res['slices_per_sec']:.3f} volumes/s including validation and "
          f"checkpoints ({wall:.1f} s wall with the store build), val pass "
          f"{[round(v, 3) for v in res['val_seconds']]} s, fused launches "
          f"{launches}, best dice {res['best_dice']}; files {files}; on "
          f"{card}")
    del res
    torch.cuda.empty_cache()

    src = brats_volumes(device, VIT3D_TEST_VOLUMES, seed=900)
    vols = [{"image": src[i]["image"].cpu().numpy(),
             "label": src[i]["label"].cpu().numpy(),
             "case": f"BraTS19_{i:03d}"} for i in range(VIT3D_TEST_VOLUMES)]
    flags = test_3d.build_parser().parse_args([
        "--root_path", tmp, "--exp", "BraTS2019/smoke_unetr_test",
        "--model", "unetr", "--labeled_num", str(BRATS_LABELED),
        "--patch_size", "96", "96", "96", "--snapshot_root", tmp])
    placed_weights(flags, weights)
    t0 = time.perf_counter()
    mean = test_3d.inference(flags, dataset=vols)
    wall = time.perf_counter() - t0
    out = test_3d.snapshot_dir(flags) + "_predictions"
    with open(os.path.join(out, "metrics.txt")) as f:
        rows = [ln.strip().split(",") for ln in f]
    table = np.asarray([r[1:] for r in rows], float)
    if ([r[0] for r in rows] != [str(i) for i in range(VIT3D_TEST_VOLUMES)]
            + ["mean"] or table.shape != (VIT3D_TEST_VOLUMES + 1, 4)
            or not np.isfinite(table).all()
            or not np.allclose(table[-1], mean.ravel())):
        raise SystemExit(f"test_3d --model unetr metrics.txt: {rows}")
    missing = [f"{v['case']}_{tag}.nii.gz" for v in vols
               for tag in ("pred", "img", "lab")
               if not os.path.exists(os.path.join(
                   out, f"{v['case']}_{tag}.nii.gz"))]
    if missing:
        raise SystemExit(f"test_3d --model unetr: no {missing}")
    print(f"test_3d --model unetr: {VIT3D_TEST_VOLUMES} volumes of "
          f"{BRATS_VOLUME}, patch 96^3, mean (dice, ravd, hd95, asd) "
          f"{mean.round(4).tolist()}; {wall:.2f} s; metrics.txt and the "
          f"exports present, on {card}")
    return launches


def run_vit3d(device, card, strict, mem_bw, f32_rate):
    """Phase 10: kernel #1 at the ViTs' (4, 2, 96, 96, 96) and (4, 2, 64,
    64, 64) float32 with int32 labels against float64, bit-equal on
    repeat, and its times there; :func:`run_vit3d_steps`;
    :func:`run_vit3d_fit`. Each part's seconds printed. Returns kernel
    #1's errors and times at each net's shape and the launches of each
    run."""
    import torch

    t_phase = t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(10)
    err, timing = {}, {}
    for net in VIT3D_PATCH:
        err[net] = {"ce_dice_fwd": 0.0, "ce_dice_bwd": 0.0}
        check_case(device, gen, vit3d_shape(net), torch.float32,
                   torch.int32, False, True, err[net])
        timing[net] = time_kernels(device, mem_bw, f32_rate,
                                   vit3d_shape(net), "float32")
    print(f"phase 10 part kernel #1 at the ViTs' shapes: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    methods = run_vit3d_steps(device, card, strict)
    print(f"phase 10 part steps: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    methods["unetr_fit"] = {"launches": run_vit3d_fit(device, card)}
    print(f"phase 10 part fit + test_3d: {time.perf_counter() - t0:.1f} s")
    print(f"phase 10 (3D ViTs): {time.perf_counter() - t_phase:.1f} s")
    return {"err": err, "timing": timing, "methods": methods}


# ---------------------------------------------------------------------------
# Phase 11: the rest of the 2D zoo and --pretrained_ckpt
# ---------------------------------------------------------------------------

def check_zoo2d_eval(engine, state, net, store):
    """Phase 11's eval checks of a 2D net: the float32 softmax of a batch
    of 24 slices sums to 1 over the classes; the float32 eval forward on
    the card against the same weights on the CPU on 2 slices of 64^2."""
    import copy

    import torch

    x = store.images[:BATCH].float()[:, None]
    model = state.models["model"]
    probs = engine.eval_probs("model", model, x)
    err_sum = float((probs.sum(dim=1) - 1).abs().max())
    if probs.dtype != torch.float32 or err_sum > 1e-5:
        raise SystemExit(f"{net}: eval softmax {probs.dtype}, sums off by "
                         f"{err_sum}")
    ref = copy.deepcopy(model).cpu().eval()
    small = x[:2, :, :64, :64].contiguous()
    model.eval()
    try:
        with torch.no_grad():
            got = model(small).cpu()
    finally:
        model.train()
    with torch.no_grad():
        want = ref(small.cpu())
    err = float((got - want).abs().max() / want.abs().max())
    print(f"{net} eval: softmax of {tuple(probs.shape)} sums to 1 within "
          f"{err_sum:.1e}; f32 card vs CPU forward on 2 x 64^2 max rel err "
          f"{err:.2e}")
    if got.dtype != torch.float32 or err > 1e-4:
        raise SystemExit(f"{net}: f32 eval forward on the card disagrees "
                         "with the CPU")


def run_zoo2d_steps(card, strict):
    """Phase 11.1: mean_teacher at north-star config 2 (batch 24 = 12 + 12
    at 256^2, 4 classes, float32 as JAX's ``model_kwargs`` gives these
    nets no dtype) on ENet, PNet2D, EffiUNet-B3 and PreUNet from a store
    of 1312 ACDC-shaped slices, each through :func:`drive_method` (the
    parameter count, 5 + 5 checked steps with kernel #1 once each way a
    step, 10 timed, a one-step profile) and :func:`check_zoo2d_eval`.
    Returns each run's numbers."""
    import torch
    from cvssl_tpu_torch.data.device_store import DeviceSliceStore
    from cvssl_tpu_torch.train.engine import Engine

    t0 = time.perf_counter()
    store = DeviceSliceStore(SyntheticACDC(), (PATCH, PATCH))
    print(f"zoo2d store: {tuple(store.images.shape)} built in "
          f"{time.perf_counter() - t0:.1f} s")
    results = {}
    for net in ZOO_2D:
        t0 = time.perf_counter()
        engine = Engine(method_config("mean_teacher", model=net))
        if engine.model_dtypes != {"model": torch.float32}:
            raise SystemExit(f"{net}: compute dtypes {engine.model_dtypes}")
        engine.attach_store(store)
        state = engine.init_state()
        results[f"mean_teacher_{net}"] = drive_method(
            engine, state, two_stream(14).epochs(), 1, strict, card, BATCH,
            checked=ZOO_CHECKED, timed=ZOO_TIMED, profiled=1)
        check_zoo2d_eval(engine, state, net, store)
        print(f"{net}: phase part {time.perf_counter() - t0:.1f} s")
        del engine, state
        torch.cuda.empty_cache()
    return results


def swin_tiny_state_dict(seed=0):
    """A Swin-tiny ``state_dict`` under the published schema
    (microsoft/Swin-Transformer ``swin_tiny_patch4_window7_224.pth``:
    depths 2, 2, 6, 2, heads 3, 6, 12, 24, embed 96; the
    ``relative_position_index`` and ``attn_mask`` buffers and the
    ImageNet head), N(0, 0.02) from ``seed``."""
    import torch
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(shape, generator=g) * 0.02
    depths, heads, embed = (2, 2, 6, 2), (3, 6, 12, 24), 96
    sd = {"patch_embed.proj.weight": t(embed, 3, 4, 4),
          "patch_embed.proj.bias": t(embed),
          "patch_embed.norm.weight": t(embed),
          "patch_embed.norm.bias": t(embed)}
    for i, (d, h) in enumerate(zip(depths, heads)):
        c = embed * 2 ** i
        for b in range(d):
            p = f"layers.{i}.blocks.{b}"
            sd.update({
                f"{p}.norm1.weight": t(c), f"{p}.norm1.bias": t(c),
                f"{p}.attn.relative_position_bias_table": t(169, h),
                f"{p}.attn.relative_position_index": torch.zeros(
                    (49, 49), dtype=torch.int64),
                f"{p}.attn.qkv.weight": t(3 * c, c),
                f"{p}.attn.qkv.bias": t(3 * c),
                f"{p}.attn.proj.weight": t(c, c),
                f"{p}.attn.proj.bias": t(c),
                f"{p}.norm2.weight": t(c), f"{p}.norm2.bias": t(c),
                f"{p}.mlp.fc1.weight": t(4 * c, c),
                f"{p}.mlp.fc1.bias": t(4 * c),
                f"{p}.mlp.fc2.weight": t(c, 4 * c),
                f"{p}.mlp.fc2.bias": t(c)})
            if b % 2 == 1:
                sd[f"{p}.attn_mask"] = torch.zeros(
                    ((56 // 2 ** i // 7) ** 2, 49, 49))
        if i < 3:
            sd.update({
                f"layers.{i}.downsample.reduction.weight": t(2 * c, 4 * c),
                f"layers.{i}.downsample.norm.weight": t(4 * c),
                f"layers.{i}.downsample.norm.bias": t(4 * c)})
    sd.update({"norm.weight": t(768), "norm.bias": t(768),
               "head.weight": t(1000, 768), "head.bias": t(1000)})
    return sd


def encoder_state_dict(net, seed):
    """A published encoder's ``state_dict`` from the port's own module
    (random weights from ``seed``, BatchNorm statistics off (0, 1)): the
    Res2Net-101 v1b 26w4s schema with ``layer4``/``fc`` entries the port
    ignores, or EfficientNet-B3's with its ``_conv_head``/``_bn1``/``_fc``
    head."""
    import torch
    from cvssl_tpu_torch.models import efficientunet, resunet
    torch.manual_seed(seed)
    enc = (resunet.Res2NetEncoder() if net == "preunet"
           else efficientunet.EfficientNetEncoder())
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    sd = dict(enc.state_dict())
    if net == "preunet":
        sd["layer4.0.conv1.weight"] = torch.randn(416, 1024, 1, 1)
        sd["fc.weight"] = torch.randn(1000, 2048) * 0.01
        sd["fc.bias"] = torch.zeros(1000)
    else:
        sd["_conv_head.weight"] = torch.randn(1536, 384, 1, 1) * 0.01
        sd.update({f"_bn1.{k}": torch.ones(1536) for k in
                   ("weight", "running_var")})
        sd.update({f"_bn1.{k}": torch.zeros(1536) for k in
                   ("bias", "running_mean")})
        sd["_fc.weight"] = torch.randn(1000, 1536) * 0.01
        sd["_fc.bias"] = torch.zeros(1000)
    return sd


def check_pretrained_init(cfg, sd, prefix, slots, untouched):
    """After ``Engine(cfg).init_state()`` the ``slots`` (model names) and
    their teachers hold ``sd``'s tensors wherever the model has the key
    (under ``prefix``) at the same shape, and the ``untouched`` slots equal
    an init without the file. Returns the count of tensors checked."""
    import dataclasses

    import torch
    from cvssl_tpu_torch.train.engine import Engine

    state = Engine(cfg).init_state()
    plain = Engine(dataclasses.replace(cfg, pretrained_ckpt=None)
                   ).init_state()
    checked = 0
    for slot in slots:
        for m in [state.models[slot]] + ([state.teachers[slot]] if slot in
                                         state.teachers else []):
            own = m.state_dict()
            hits = [k for k, v in sd.items() if prefix + k in own
                    and tuple(v.shape) == tuple(own[prefix + k].shape)
                    and not k.endswith("num_batches_tracked")]
            if not hits:
                raise SystemExit(f"pretrained: nothing of the file in {slot}")
            for k in hits:
                if not torch.equal(own[prefix + k].cpu(), sd[k]):
                    raise SystemExit(f"pretrained: {slot}'s {prefix}{k} is "
                                     "not the file's after init")
            checked += len(hits)
    for slot in untouched:
        ref = plain.models[slot].state_dict()
        if not all(torch.equal(v, ref[k]) for k, v in
                   state.models[slot].state_dict().items()):
            raise SystemExit(f"pretrained: {slot} (another family) changed")
    del state, plain
    torch.cuda.empty_cache()
    return checked


def run_pretrained_fits(card, train_ds, val_ds, vit_val_ds):
    """Phase 11.2: ``--pretrained_ckpt`` through the CLI's ``fit``
    (``train/cli.py::config_from_args``) on files written here from a seed
    under the published schemas: PreUNet with a Res2Net-101 file and
    EffiUNet with an EfficientNet-B3 file (mean_teacher at config 2), and
    cross_teaching's UNet + ``ViT_Seg`` with a Swin-tiny file (config 4).
    For each: after init the student's and the teacher's encoders are the
    file's (:func:`check_pretrained_init`; cross_teaching's UNet equal to
    an init without the file); then a fit of 20 iterations with one
    validation and one checkpoint, kernel #1's launches counted. Returns
    the launches of each fit and EffiUNet's test weights."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train import cli
    from cvssl_tpu_torch.train.engine import Engine, fit

    tmp = tempfile.mkdtemp(prefix="chip_smoke_pretrained_")
    runs = (("preunet", "mean_teacher", "res2net101_v1b_26w_4s.pth"),
            ("efficient_unet", "mean_teacher", "efficientnet-b3.pth"),
            ("ViT_Seg", "cross_teaching",
             "swin_tiny_patch4_window7_224.pth"))
    results, weights = {}, None
    for net, method, name in runs:
        t0 = time.perf_counter()
        path = os.path.join(tmp, name)
        vit = net == "ViT_Seg"
        sd = swin_tiny_state_dict() if vit else encoder_state_dict(net, 15)
        torch.save({"model": sd} if vit else sd, path)
        patch = VIT_PATCH if vit else PATCH
        argv = ["--root_path", tmp, "--exp", f"ACDC/pretrained_{net}",
                "--method", method, "--max_iterations",
                str(ZOO2D_FIT_STEPS), "--val_every", str(ZOO2D_FIT_STEPS),
                "--ckpt_every", str(ZOO2D_FIT_STEPS), "--batch_size",
                str(VIT_BATCH if vit else BATCH), "--labeled_bs",
                str(VIT_LABELED_BS if vit else LABELED_BS),
                "--labeled_slices", str(ACDC_LABELED_SLICES),
                "--patch_size", str(patch), str(patch),
                "--snapshot_root", tmp, "--pretrained_ckpt", path]
        argv += (["--model", "unet", "--model2", net] if vit
                 else ["--model", net])
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        slots, untouched = (["model2"], ["model1"]) if vit else (["model"],
                                                                 [])
        n = check_pretrained_init(cfg, sd, "" if vit else "encoder.", slots,
                                  untouched)
        fcd.reset_launches()
        per_step = 2 if vit else 1
        res = fit(cfg, engine=Engine(cfg), data=(
            train_ds, two_stream(cfg.seed, cfg.batch_size, cfg.labeled_bs),
            vit_val_ds if vit else val_ds))
        launches = dict(fcd.LAUNCHES)
        if res["iterations"] != ZOO2D_FIT_STEPS or any(
                v != per_step * ZOO2D_FIT_STEPS for v in launches.values()):
            raise SystemExit(f"{net} pretrained fit: {res['iterations']} "
                             f"iterations, launches {launches}")
        snap = cfg.snapshot_path()
        with open(os.path.join(snap, "log.txt")) as f:
            log = f.read()
        slot = "model2" if vit else "model"
        if f"loaded pretrained encoder into {slot} from {path}" not in log \
                or (vit and "loaded pretrained encoder into model1" in log):
            raise SystemExit(f"{net} pretrained fit: the log names no load "
                             f"into {slot} alone")
        if f"model_iter_{ZOO2D_FIT_STEPS}.ckpt" not in os.listdir(snap):
            raise SystemExit(f"{net} pretrained fit: no checkpoint in {snap}")
        if net == "efficient_unet":
            weights = test_weights(snap, net, res["state"])
        results[f"{method}_{net.lower()}_pretrained_fit"] = {
            "launches": launches}
        print(f"{net} with --pretrained_ckpt {name}: {n} tensors of the "
              f"file in {slot}{' and its teacher' if not vit else ''} "
              f"after init{', model1 untouched' if vit else ''}; fit "
              f"{ZOO2D_FIT_STEPS} iterations, {res['slices_per_sec']:.2f} "
              f"slices/s including validation and checkpoint, val pass "
              f"{[round(v, 3) for v in res['val_seconds']]} s, launches "
              f"{launches}, best dice {res['best_dice']}; "
              f"{time.perf_counter() - t0:.1f} s, on {card}")
        del res
        torch.cuda.empty_cache()
    return results, weights


def run_zoo2d_test(card, weights):
    """Phase 11.3: ``test_2d --model efficient_unet`` on the pretrained
    fit's weights over 4 of phase 9a's ACDC-shaped volumes of mixed sizes:
    the per-class Dice table finite in [0, 1] and each case's three
    exports present (the 2D CLI writes no ``metrics.txt``, in either
    package)."""
    from cvssl_tpu_torch.eval import test_2d
    from cvssl_tpu_torch.eval.test_3d import snapshot_dir

    vols = test_volumes_2d(n=ZOO2D_TEST_VOLUMES)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo2d_test_")
    flags = test_2d.build_parser().parse_args([
        "--root_path", tmp, "--exp", "ACDC/smoke_effiunet_test",
        "--model", "efficient_unet", "--num_classes", str(CLASSES),
        "--labeled_num", "7", "--snapshot_root", tmp])
    placed_weights(flags, weights)
    t0 = time.perf_counter()
    avg = test_2d.inference(flags, volumes=vols)
    wall = time.perf_counter() - t0
    if avg.shape != (CLASSES - 1, 1) or not np.isfinite(avg).all() or not (
            (avg >= 0) & (avg <= 1)).all():
        raise SystemExit(f"test_2d --model efficient_unet: {avg}")
    out = snapshot_dir(flags) + "_predictions"
    want = sorted(f"{c}_{t}.nii.gz" for c in vols
                  for t in ("pred", "img", "gt"))
    if sorted(os.listdir(out)) != want:
        raise SystemExit(f"test_2d --model efficient_unet: exports "
                         f"{sorted(os.listdir(out))}")
    print(f"test_2d --model efficient_unet: {len(vols)} volumes at "
          f"{TEST_2D_SHAPES}, per-class dice {avg.ravel().round(4).tolist()}"
          f"; {wall:.2f} s; the exports present, on {card}")


def run_zoo2d(card, strict):
    """Phase 11: :func:`run_zoo2d_steps`, :func:`run_pretrained_fits` and
    :func:`run_zoo2d_test`, each part's seconds printed. Returns the
    launches of each run."""
    t_phase = t0 = time.perf_counter()
    methods = run_zoo2d_steps(card, strict)
    print(f"phase 11 part steps: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_ds = BlobSlices()
    fits, weights = run_pretrained_fits(
        card, train_ds, blob_volumes(n=ZOO2D_VAL_VOLUMES),
        blob_volumes(n=ZOO2D_VAL_VOLUMES, side=VIT_PATCH))
    methods.update(fits)
    print(f"phase 11 part pretrained fits: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_zoo2d_test(card, weights)
    print(f"phase 11 part test_2d: {time.perf_counter() - t0:.1f} s")
    print(f"phase 11 (2D zoo): {time.perf_counter() - t_phase:.1f} s")
    return methods


def run_profiled_fit(device, card):
    """Phase 12: ``fit`` at config 2 on the store with ``profile_dir`` in a
    temporary directory, :data:`PROFILE_FIT_STEPS` iterations; one trace
    written under ``profile_dir``, holding kernel #1's forward and
    backward device kernels once each for every step of the window
    (start, stop]; the window's device time a step read from the trace
    and the fit's slices/s, profiled; then ``measure_fp_bp_time`` on the
    config-2 UNet (batch 24 at 256^2, bf16 autocast). Runs last: a
    profiler session slows every later launch on the host. Returns
    kernel #1's launches in the fit."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine, fit
    from cvssl_tpu_torch.utils.profiler import (StepWindowProfiler,
                                                measure_fp_bp_time)

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    prof_dir = os.path.join(tmp, "profile")
    cfg = method_config("mean_teacher", snapshot_root=tmp,
                        exp="ACDC/profile", profile_dir=prof_dir)
    if cfg.val_every <= PROFILE_FIT_STEPS or \
            cfg.ckpt_every <= PROFILE_FIT_STEPS:
        raise SystemExit("the profiled fit must validate and checkpoint "
                         "nowhere in its run")
    window = StepWindowProfiler(prof_dir)
    engine = Engine(cfg)
    fcd.reset_launches()
    res = fit(cfg, engine=engine, max_steps=PROFILE_FIT_STEPS,
              data=(SyntheticACDC(), two_stream(cfg.seed),
                    blob_volumes(n=1)))
    launches = dict(fcd.LAUNCHES)
    if res["iterations"] != PROFILE_FIT_STEPS or any(
            v != PROFILE_FIT_STEPS for v in launches.values()):
        raise SystemExit(f"profiled fit: {res['iterations']} iterations, "
                         f"launches {launches}")
    traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    if len(traces) != 1:
        raise SystemExit(f"profiled fit: traces {traces} in {prof_dir}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    steps = window.stop - window.start
    counts = {k: sum(f"{k}_kernel" in e.get("name", "") for e in kernels)
              for k in launches}
    if any(n != steps for n in counts.values()):
        raise SystemExit(f"profiled fit: kernel #1's device kernels "
                         f"{counts} in the trace of steps {window.start}-"
                         f"{window.stop}, not {steps} each")
    busy_ms = sum(e["dur"] for e in kernels) / 1e3
    span_ms = (max(e["ts"] + e["dur"] for e in kernels)
               - min(e["ts"] for e in kernels)) / 1e3
    print(f"profiled fit: {PROFILE_FIT_STEPS} iterations, launches "
          f"{launches}; trace {os.path.basename(traces[0])} "
          f"({os.path.getsize(traces[0])} bytes, {len(kernels)} device "
          f"kernels): kernel #1 {counts} in steps {window.start + 1}-"
          f"{window.stop}; device busy {busy_ms / steps:.3f} ms/step, first "
          f"to last kernel {span_ms / steps:.3f} ms/step; "
          f"{res['slices_per_sec']:.2f} slices/s profiled (not a "
          f"throughput), on {card}")

    model = res["state"].models["model"]
    x = torch.randn((BATCH, 1, PATCH, PATCH), device=device,
                    generator=torch.Generator(device=device).manual_seed(12))
    with torch.autocast("cuda", dtype=torch.bfloat16):
        fp, bp = measure_fp_bp_time(model, x)
    print(f"measure_fp_bp_time: UNet at ({BATCH}, 1, {PATCH}, {PATCH}) "
          f"bf16 autocast, eval mode: forward {fp * 1e3:.3f} ms, forward + "
          f"backward {bp * 1e3:.3f} ms (profiler hooks on), on {card}")
    print(f"phase 12 (profiled fit): {time.perf_counter() - t_phase:.1f} s")
    return launches


def par_mean_teacher(dtype):
    """Config 2's mean-teacher steps on this process's mesh (two ranks in a
    group, or one process): :data:`PAR_STEPS` steps from step
    :data:`PAR_START` from the device store, each step synchronised and
    timed, kernel #1's launches counted. Returns the metrics, launches and
    ms of every step and the models' and teachers' state (on the host)."""
    import torch
    from cvssl_tpu_torch.data.device_store import DeviceSliceStore
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine

    cfg = method_config("mean_teacher", dtype=dtype)
    engine = Engine(cfg)
    engine.attach_store(DeviceSliceStore(SyntheticACDC(), cfg.patch_size,
                                         device=engine.device))
    stream = two_stream(0).epochs()
    state = engine.init_state()
    state.step = PAR_START
    out = {"metrics": [], "launches": [], "ms": []}
    for _ in range(PAR_STEPS):
        before = dict(fcd.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = engine.train_steps(state, [next(stream)])
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append({k: fcd.LAUNCHES[k] - before[k]
                                for k in before})
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
    out["state"] = {
        f"{kind}/{k}": v.detach().cpu()
        for kind, m in (("model", state.models["model"]),
                        ("teacher", state.teachers["model"]))
        for k, v in m.state_dict().items()}
    return out


def par_volume():
    """One volume of config 5's shape (140 x 180 x 180) from a seed."""
    return np.random.default_rng(500).normal(
        0.5, 0.3, BRATS_VOLUME).astype(np.float32)


def par_unet3d(device):
    """Config 5's UNet3D (5,884,050 parameters, 2 classes) with weights
    from seed 0, in eval mode on ``device``."""
    import torch
    from cvssl_tpu_torch.models import net_factory_3d
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = net_factory_3d("unet_3D", 1, CLASSES_3D)
    return net.to(device).eval()


def par_predict(net):
    """The eval softmax of ``net`` in float32."""
    import torch

    def predict(x):
        with torch.no_grad():
            return torch.softmax(net(x).float(), dim=1)
    return predict


def par_halo_input():
    return np.random.default_rng(501).normal(size=PAR_HALO_SHAPE).astype(
        np.float32)


def par_rank(rank, world, init_file, out_dir):
    """One rank of phase 13 on the one card (gloo: NCCL refuses two ranks
    on one card): (a) config 2's mean-teacher steps in float32 and bf16,
    (c) the sliding window with its windows split, (d) UNet3D's forward
    with H split, (e) ``dryrun_multichip``. Results go to
    ``out_dir/rank{r}.pt``."""
    import torch
    from cvssl_tpu_torch.parallel.dryrun import dryrun_multichip
    from cvssl_tpu_torch.parallel.halo import sharded_unet3d_forward
    from cvssl_tpu_torch.parallel.mesh import distributed_init
    from cvssl_tpu_torch.parallel.spatial import ShardedSlidingWindowEvaluator

    mesh = distributed_init(init_method=f"file://{init_file}",
                            world_size=world, rank=rank, backend="gloo",
                            device="cuda:0")
    res = {dtype: par_mean_teacher(dtype) for dtype in ("float32", "auto")}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = par_unet3d(mesh.device)
    ev = ShardedSlidingWindowEvaluator(par_predict(net), (PATCH_3D,) * 3,
                                       CLASSES_3D, 64, 64, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res["window"] = ev.predict_volume(par_volume())
    res["window_windows"] = len(ev.corners(BRATS_VOLUME))
    res["window_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    res["halo"] = sharded_unet3d_forward(net, par_halo_input(), mesh).cpu()
    res["halo_ms"] = (time.perf_counter() - t0) * 1e3
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dryrun_multichip(world, "cuda")
    torch.distributed.destroy_process_group()


def par_cli_argv(snapshot_root, steps=PAR_CLI_STEPS, val=PAR_CLI_EVERY,
                 ckpt=PAR_CLI_STEPS):
    """Config 2's mean-teacher fit through the CLI: ``steps`` iterations,
    validated every ``val``, checkpointed every ``ckpt`` (by default at its
    end)."""
    return ["--exp", "par", "--method", "mean_teacher", "--max_iterations",
            str(steps), "--batch_size", str(BATCH), "--labeled_bs",
            str(LABELED_BS), "--labeled_slices", str(ACDC_LABELED_SLICES),
            "--patch_size", str(PATCH), str(PATCH), "--val_every",
            str(val), "--ckpt_every", str(ckpt),
            "--snapshot_root", snapshot_root]


def par_cli_fit(snapshot_root, distributed):
    """13b's child: the CLI's fit of :func:`par_cli_argv` on in-memory data
    (the card machine has no ``h5py`` for ``--root_path``'s files), with
    ``--distributed`` under torchrun."""
    from cvssl_tpu_torch.train import cli
    data = (SyntheticACDC(), two_stream(1337),
            blob_volumes(n=PAR_CLI_VAL))
    cli.main(par_cli_argv(snapshot_root)
             + (["--distributed"] if distributed else []), data=data)


def par_compare_steps(one, ranks, card):
    """13a: each rank's steps against one process's."""
    for dtype in ("float32", "auto"):
        want = one[dtype]
        for r, res in enumerate(ranks):
            got = res[dtype]
            for step, launches in enumerate(got["launches"]):
                if any(n != 1 for n in launches.values()):
                    raise SystemExit(f"phase 13a {dtype} rank {r} step "
                                     f"{step}: kernel #1 launches "
                                     f"{launches}, not 1 + 1")
            rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                      for g, w in zip(got["metrics"], want["metrics"])
                      for k in w)
            err = {k: float((got["state"][k].double()
                             - want["state"][k].double()).abs().max())
                   for k in want["state"]}
            worst = max(err, key=err.get)
            print(f"phase 13a {dtype} rank {r}/{len(ranks)}: metrics "
                  f"{[round(m['loss'], 6) for m in got['metrics']]} (one "
                  f"process {[round(m['loss'], 6) for m in want['metrics']]}"
                  f"), largest metric rel diff {rel:.3e}, largest state "
                  f"abs diff {err[worst]:.3e} ({worst}), kernel #1 "
                  f"launches per step {got['launches'][0]}, ms/step "
                  f"{[round(t, 2) for t in got['ms']]} (one process "
                  f"{[round(t, 2) for t in want['ms']]}; two ranks share "
                  f"one card: a correctness run, not a scaling number), "
                  f"on {card}")
            if dtype == "float32" and (rel > PAR_METRIC_RTOL
                                       or err[worst] > PAR_STATE_ATOL):
                raise SystemExit(f"phase 13a float32 rank {r}: metric rel "
                                 f"{rel:.3e} (bound {PAR_METRIC_RTOL}), "
                                 f"state {err[worst]:.3e} at {worst} "
                                 f"(bound {PAR_STATE_ATOL})")


def par_cli_tensors(root, name):
    """Every tensor of the fit's checkpoint files under ``root/name``, by
    file and path, and the file names."""
    import torch
    from cvssl_tpu_torch.utils import checkpoint as ckpt
    snap = os.path.join(root, name, "par_7_labeled", "unet")

    def leaves(tree, path):
        if torch.is_tensor(tree):
            yield path, tree
        elif isinstance(tree, dict):
            for k in sorted(tree, key=str):
                yield from leaves(tree[k], f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
    # the best model's file name holds its val Dice to 4 places, which the
    # card's run-to-run spread may move
    names = sorted(re.sub(r"_dice_[0-9.]+\.ckpt$", "_dice_*.ckpt", f)
                   for f in os.listdir(snap))
    tensors = {}
    for f in os.listdir(snap):
        if f.endswith(".ckpt"):
            key = re.sub(r"_dice_[0-9.]+\.ckpt$", "_dice_*.ckpt", f)
            tensors.update(leaves(ckpt.load_weights(os.path.join(snap, f)),
                                  key))
    return names, tensors


def par_cli_diff(a, b):
    """(tensors bit-equal, largest abs difference of the floating ones,
    the non-floating ones that differ) between two fits' tensors."""
    import torch
    equal, worst, exact_off = 0, 0.0, []
    for k in a:
        if torch.equal(a[k], b[k]):
            equal += 1
        elif a[k].is_floating_point():
            worst = max(worst, float((a[k].double()
                                      - b[k].double()).abs().max()))
        else:
            exact_off.append(k)
    return equal, worst, exact_off


def par_compare_cli(root, other="dist", steps=PAR_CLI_STEPS,
                    what="phase 13b", how="torchrun --nproc_per_node 1 ... "
                    "cli --distributed (nccl)"):
    """13b: the fit under ``root/other`` (by default the --distributed one)
    against the plain fit under ``root/plain``. Both must write the same
    files. The card's training step is not bit-reproducible (the bilinear
    upsample's backward adds with atomics, and
    ``torch.use_deterministic_algorithms`` refuses it), so a second plain
    fit (``root/again``) measures the run-to-run spread: every
    non-floating tensor (steps, counts, the generator's state) must be
    equal, and the floating ones bit-equal where the two plain fits are,
    else within :data:`PAR_CLI_SPREAD` times their spread."""
    names, plain = par_cli_tensors(root, "plain")
    spread = {}
    for name in ("again", other):
        other_names, tensors = par_cli_tensors(root, name)
        if other_names != names or f"model_iter_{steps}.ckpt" not in names:
            raise SystemExit(f"{what}: {name} wrote {other_names}, the "
                             f"plain fit {names}")
        if tensors.keys() != plain.keys():
            raise SystemExit(f"{what}: {name}'s checkpoint keys differ")
        spread[name] = par_cli_diff(plain, tensors)
    equal, worst, exact_off = spread[other]
    noise = spread["again"][1]
    print(f"{what}: {how}, {steps} iterations: {len(names)} files as the "
          f"plain fit's; {equal} of {len(plain)} checkpoint tensors "
          f"bit-equal to the plain fit's, largest abs difference {worst:.3e}"
          f"; a second plain fit: {spread['again'][0]} bit-equal, largest "
          f"{noise:.3e}")
    if exact_off or spread["again"][2]:
        raise SystemExit(f"{what}: non-floating tensors differ: "
                         f"{exact_off or spread['again'][2]}")
    if worst > PAR_CLI_SPREAD * noise:
        raise SystemExit(f"{what}: {other} differs by {worst:.3e}, over "
                         f"{PAR_CLI_SPREAD} x the plain fits' {noise:.3e}")


def run_parallel(device, card):
    """Phase 13: data parallelism across processes on the one card. Starts
    13b's two CLI fits (one under torchrun with --distributed, on nccl)
    and 13a/c/d/e's two gloo ranks, computes the one-process references
    meanwhile, then holds every result against them. A rank or a child that
    fails fails the smoke."""
    import torch
    import torch.multiprocessing as tmp
    from cvssl_tpu_torch.eval import val3d

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="par_")
    me = os.path.abspath(__file__)
    port = 29400 + os.getpid() % 1000
    cli_runs = {
        "dist": subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", "1", "--master_port", str(port), me,
             "--par-cli-fit", os.path.join(work, "dist"), "--distributed"]),
        "plain": subprocess.Popen(
            [sys.executable, me, "--par-cli-fit",
             os.path.join(work, "plain")]),
        "again": subprocess.Popen(
            [sys.executable, me, "--par-cli-fit",
             os.path.join(work, "again")])}
    ranks = tmp.start_processes(
        par_rank, args=(PAR_WORLD, os.path.join(work, "init"), work),
        nprocs=PAR_WORLD, join=False, start_method="spawn")
    try:
        one = {dtype: par_mean_teacher(dtype)
               for dtype in ("float32", "auto")}
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        net = par_unet3d(device)
        ev = val3d.SlidingWindowEvaluator(
            par_predict(net), (PATCH_3D,) * 3, CLASSES_3D, 64, 64,
            patch_batch=2, device=device)
        window = ev.predict_volume(par_volume())
        with torch.no_grad():
            halo = net(torch.from_numpy(par_halo_input()).to(device)).cpu()
    finally:
        while not ranks.join(timeout=600):
            pass
        for name, proc in cli_runs.items():
            if proc.wait(timeout=600) != 0:
                raise SystemExit(f"phase 13b: the {name} CLI fit exited "
                                 f"{proc.returncode}")
    res = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(PAR_WORLD)]
    par_compare_steps(one, res, card)
    par_compare_cli(work)
    for r, got in enumerate(res):
        flips = int((got["window"] != window).sum())
        if flips > PAR_WINDOW_FLIPS * window.size:
            raise SystemExit(f"phase 13c rank {r}: {flips} voxels differ")
        err = float((got["halo"] - halo).abs().max())
        if got["halo"].shape != halo.shape or err > PAR_HALO_ATOL:
            raise SystemExit(f"phase 13d rank {r}: max abs err {err:.3e} "
                             f"(bound {PAR_HALO_ATOL})")
        print(f"phase 13c rank {r}: sliding window over {BRATS_VOLUME}, "
              f"{got['window_windows']} of {len(ev.plan(BRATS_VOLUME)[2])} "
              f"windows on this rank, {flips} of {window.size} voxels "
              f"differ from one rank's map (bound {PAR_WINDOW_FLIPS} of "
              f"them), {got['window_ms']:.1f} ms; phase 13d: halo forward "
              f"at {PAR_HALO_SHAPE} float32, max abs err {err:.3e} against "
              f"the whole forward (bound {PAR_HALO_ATOL}), "
              f"{got['halo_ms']:.1f} ms; on {card}")
    print(f"phase 13e: dryrun_multichip({PAR_WORLD}, 'cuda') passed on "
          f"every rank")
    print(f"phase 13 (parallel): {time.perf_counter() - t_phase:.1f} s")
    return {f"mean_teacher_rank{r}_of_{PAR_WORLD}": {
        "launches": {k: sum(s[k] for s in got["float32"]["launches"]
                            + got["auto"]["launches"])
                     for k in got["float32"]["launches"][0]}}
        for r, got in enumerate(res)}


# ---------------------------------------------------------------------------
# phase 14: K steps a call as CUDA graphs
# ---------------------------------------------------------------------------

def graph_copies(engine, state, n=3):
    """``n`` independent copies of ``state`` (models, teachers, optimizers
    with their counts, generator): fresh states loaded from a snapshot
    each (one snapshot a copy: an optimizer keeps the tensors it loads)."""
    from cvssl_tpu_torch.utils import checkpoint as ckpt
    return [ckpt.load_state_tree(engine.init_state(), ckpt.device_snapshot(
        ckpt.state_tree(state)).tree) for _ in range(n)]


def graph_state_diff(a, b, group, kind):
    """(the largest |a - b|, the largest |a|) over the floating
    ``kind`` ("parameters" or "buffers") of two states' ``group``
    ("models" or "teachers"), float64; raises if any other tensor
    differs."""
    worst = top = 0.0
    for n, m in getattr(a, group).items():
        other = dict(getattr(getattr(b, group)[n], f"named_{kind}")())
        for k, v in getattr(m, f"named_{kind}")():
            v, w = v.detach(), other[k].detach()
            if v.is_floating_point():
                worst = max(worst, float((v.double() - w.double()).abs()
                                         .max()))
                top = max(top, float(v.double().abs().max()))
            elif not bool((v == w).all()):
                raise SystemExit(f"{group} {n} {k}: not equal")
    return worst, top


def graph_metric_diff(a, b):
    """(the largest |a - b|, the largest |a|) over the losses (keys with
    "loss") of two lists of metrics."""
    pairs = [(float(x[k]), float(y[k]))
             for x, y in zip(a, b) for k in x if "loss" in k]
    return (max(abs(x - y) for x, y in pairs),
            max(abs(x) for x, _ in pairs))


def graph_to_step(state, step):
    """``state`` at ``step``: its step and every optimizer's count (each
    run of a comparison jumps alike)."""
    state.step = step
    for o in state.optimizers.values():
        o.count = step


def check_graphed(what, runs, metrics, card):
    """The graphed run against the eager ones: ``runs`` the graphed state
    and ``GRAPH_EAGER_RUNS`` eager ones, ``metrics`` each one's metrics of
    every call. Step, every optimizer's count and the generator's state
    bit-equal. The models' parameters, their buffers (BatchNorm's
    statistics), the teachers' parameters and buffers, and the losses
    (the total among them, which the consistency weight scales), each
    apart, so that one kind's noise widens no other's bound: the largest
    difference of the graphed run from an eager one
    within ``GRAPH_SPREAD`` times the largest difference between two eager
    ones (the spread; one pair's difference of a scalar loss can be near
    0 by chance), or within ``GRAPH_FLOOR`` of the largest magnitude
    (eager runs that happen to agree give no spread). A replay that read
    a step's host value (a weight, the EMA decay, a rate) frozen at its
    capture moves the teachers or the losses past that."""
    import itertools

    import torch
    g, eager = runs[0], runs[1:]
    for e in eager:
        counts = ({n: o.count for n, o in g.optimizers.items()},
                  {n: o.count for n, o in e.optimizers.items()})
        if g.step != e.step or counts[0] != counts[1]:
            raise SystemExit(f"{what}: step {g.step} counts {counts[0]}, "
                             f"eager {e.step} {counts[1]}")
        if not torch.equal(g.generator.get_state(), e.generator.get_state()):
            raise SystemExit(f"{what}: generator state differs from eager")
    pairs = list(itertools.combinations(range(1, len(runs)), 2))
    checks = []
    for group in ("models", "teachers"):
        for kind in ("parameters", "buffers") if getattr(g, group) else ():
            checks.append((f"{group[:-1]} {kind}",
                           max(graph_state_diff(g, e, group, kind)
                               for e in eager),
                           max(graph_state_diff(runs[i], runs[j], group,
                                                kind)[0]
                               for i, j in pairs)))
    checks.append(("losses", max(graph_metric_diff(metrics[0], m)
                                 for m in metrics[1:]),
                   max(graph_metric_diff(metrics[i], metrics[j])[0]
                       for i, j in pairs)))
    print(f"{what}: step {g.step}, counts and generator bit-equal to "
          f"{len(eager)} eager runs; largest diff graphed-eager, "
          f"eager-eager: " + "; ".join(
              f"{name} {d:.3e}, {spread:.3e}"
              for name, (d, _), spread in checks)
          + f"; last loss graphed {float(metrics[0][-1]['loss']):.6f} eager "
          f"{float(metrics[1][-1]['loss']):.6f}, on {card}")
    for name, (d, top), spread in checks:
        bound = max(GRAPH_SPREAD * spread, GRAPH_FLOOR * top)
        if d > bound:
            raise SystemExit(f"{what}: {name} diff {d:.3e} graphed-eager "
                             f"over {bound:.3e} ({GRAPH_SPREAD} x eager-"
                             f"eager {spread:.3e}, or {GRAPH_FLOOR} of "
                             f"{top:.3e})")


def graph_against_eager(engine, what, card, chunks, batch=None, k=None,
                        strict=True):
    """Copies of a fresh state; ``chunks``, (first step, index rows)
    pairs (with ``batch``, rows None: a call of ``k`` steps on it), each
    from its first step (:func:`graph_to_step`), through
    ``train_steps_scan`` (``train_steps_fixed``) on one, the same steps
    eager on ``GRAPH_EAGER_RUNS`` (``train_steps``, ``train_step``); the
    graphed calls under sync debug mode "error" if ``strict``; then
    :func:`check_graphed`. Returns the graphed and the first eager state,
    and the bytes the graphed calls left reserved on the card (the graphs'
    memory pool, with the momentum buffers and static inputs they made)."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    runs = graph_copies(engine, engine.init_state(), 1 + GRAPH_EAGER_RUNS)
    metrics = [[] for _ in runs]
    before = dict(fcd.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    for start, rows in chunks:
        graph_to_step(runs[0], start)
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            if batch is None:
                runs[0], m = engine.train_steps_scan(runs[0], rows)
            else:
                runs[0], m = engine.train_steps_fixed(runs[0], batch, k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        metrics[0].append(m)
    host = {n: fcd.LAUNCHES[n] - before[n] for n in before}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool = torch.cuda.memory_reserved() - reserved
    for i in range(1, len(runs)):
        for start, rows in chunks:
            graph_to_step(runs[i], start)
            if batch is None:
                runs[i], m = engine.train_steps(runs[i], rows)
            else:
                for _ in range(k):
                    runs[i], m = engine.train_step(runs[i], batch)
            metrics[i].append(m)
    torch.cuda.synchronize()
    print(f"{what}: chunks from steps {[c[0] for c in chunks]}, "
          f"{len(engine._graphs)} graph(s) captured, "
          f"{pool / 2 ** 30:.3f} GiB left reserved by the graphed calls; "
          f"kernel #1's host launches over them {host} (warm-ups and "
          f"captures; a replay launches from the card)"
          f"{', under sync debug mode error' if strict else ''}")
    check_graphed(what, runs, metrics, card)
    return runs[0], runs[1], pool


def time_calls(fn, calls):
    """Wall seconds of ``calls`` calls of ``fn`` (each returns (state,
    metrics)), the last one's loss read."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        _, m = fn()
    float(m["loss"])
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def graph_profile(fn, steps):
    """``fn()`` (``steps`` steps) under ``torch.profiler``: (device busy ms
    a step, the busy share of the wall time with the profiler on, kernel
    #1's device kernels by name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == cuda]
    total_us = sum(e.self_device_time_total for e in events)
    counts = {k: sum(e.count for e in events if f"{k}_kernel" in e.key)
              for k in ("ce_dice_fwd", "ce_dice_bwd")}
    return total_us / steps / 1e3, total_us / 1e6 / wall, counts


def graph_timed(what, engine, card, g, e, pool, rows_fn, calls, k, unit,
                batch, per_step, fixed=None):
    """Samples/s and ms/step over ``calls`` calls of ``k`` steps graphed
    (``train_steps_scan``, or ``train_steps_fixed`` on ``fixed``) and
    eager (``train_steps``, or ``train_step``), with the peak memory
    allocated in each window (the graphs' ``pool`` is reserved beside the
    graphed window's); returns a function that profiles a graphed call of
    ``k`` steps and ``GRAPH_EAGER_PROFILED`` eager steps (run after every
    timed window: a profiler session slows later launches), checks kernel
    #1's device kernels in the graphed call (``per_step`` + as many a
    step) and prints the busy shares."""
    import torch

    def graphed():
        if fixed is None:
            return engine.train_steps_scan(g, rows_fn(k))
        return engine.train_steps_fixed(g, fixed, k)

    def eager(n=k):
        if fixed is None:
            return engine.train_steps(e, rows_fn(n))
        for _ in range(n):
            _, m = engine.train_step(e, fixed)
        return e, m
    out = {}
    for name, fn in (("graphed", graphed), ("eager", eager)):
        torch.cuda.reset_peak_memory_stats()
        dt = time_calls(fn, calls)
        out[name] = {"s_per_step": dt / (calls * k),
                     "rate": calls * k * batch / dt,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"{what}: {out['graphed']['rate']:.2f} {unit}/s graphed "
          f"({out['graphed']['s_per_step'] * 1e3:.2f} ms/step), "
          f"{out['eager']['rate']:.2f} {unit}/s eager "
          f"({out['eager']['s_per_step'] * 1e3:.2f} ms/step), over "
          f"{calls * k} steps each in calls of {k}; peak memory allocated "
          f"{out['graphed']['peak_gib']:.3f} GiB graphed (and the graphed "
          f"calls' {pool / 2 ** 30:.3f} GiB reserved), "
          f"{out['eager']['peak_gib']:.3f} GiB eager, on {card}")

    def profiled():
        for name, fn, n in (
                ("graphed", graphed, k),
                ("eager", lambda: eager(GRAPH_EAGER_PROFILED),
                 GRAPH_EAGER_PROFILED)):
            busy, share, counts = graph_profile(fn, n)
            out[name].update(busy_ms_per_step=busy, busy_share=share,
                             kernels=counts)
            print(f"{what} {name}, {n} steps profiled: device "
                  f"busy {busy:.2f} ms/step, busy share {share:.3f} with the "
                  f"profiler on, estimated without it "
                  f"{busy / 1e3 / out[name]['s_per_step']:.3f}; kernel #1's "
                  f"device kernels {counts}, on {card}")
        want = {n: per_step * k for n in ("ce_dice_fwd", "ce_dice_bwd")}
        if out["graphed"]["kernels"] != want:
            raise SystemExit(f"{what}: kernel #1's device kernels in a "
                             f"graphed call {out['graphed']['kernels']}, not "
                             f"{want}")
        return out
    return profiled


def graph_small_2d(method):
    """(d)'s 2D configuration of ``method``: batch 8 = 4 + 4 at 64^2, the
    SwinUnet slots thinned (``GRAPH_SMALL_2D``)."""
    return method_config(method, **GRAPH_SMALL_2D,
                         **VIT_KW.get(method, {}), **METHOD_KW.get(method, {}))


def run_graph_small(card):
    """14d: every other store-path method, 2D and 3D, at a reduced size:
    the graphed chunks of ``GRAPH_SMALL_CHUNKS`` under sync debug mode
    "error" against as many eager steps, three times."""
    import torch
    from cvssl_tpu_torch.data.device_store import (DeviceSliceStore,
                                                   DeviceVolumeStore)
    from cvssl_tpu_torch.data.sampler import TwoStreamBatchSampler
    from cvssl_tpu_torch.data.synthetic import DeviceBlobVolumes
    from cvssl_tpu_torch.train.engine import Engine

    stores = {}
    lb = GRAPH_SMALL_2D["labeled_slices_override"]
    stream = TwoStreamBatchSampler(
        list(range(lb)), list(range(lb, GRAPH_SMALL_SLICES)),
        GRAPH_SMALL_2D["batch_size"],
        GRAPH_SMALL_2D["batch_size"] - GRAPH_SMALL_2D["labeled_bs"],
        rng=np.random.default_rng(16)).epochs()

    def chunks(stream):
        return [(start, [next(stream) for _ in range(n)])
                for start, n in GRAPH_SMALL_CHUNKS]
    for method in GRAPH_METHODS_2D:
        t0 = time.perf_counter()
        engine = Engine(graph_small_2d(method))
        mode = engine.method.transform
        if mode not in stores:
            stores[mode] = DeviceSliceStore(
                SyntheticACDC(GRAPH_SMALL_SLICES), (64, 64), mode=mode)
        engine.attach_store(stores[mode])
        graph_against_eager(engine, f"phase 14d {method} 2D", card,
                            chunks(stream))
        print(f"phase 14d {method} 2D: {time.perf_counter() - t0:.1f} s")
        del engine
    del stores
    store = DeviceVolumeStore(DeviceBlobVolumes(
        GRAPH_SMALL_VOLUMES, GRAPH_SMALL_VOLUME, num_classes=CLASSES_3D,
        device="cuda"), GRAPH_SMALL_3D["patch_size"])
    stream = two_stream_3d(17, GRAPH_SMALL_3D["labeled_num"],
                           GRAPH_SMALL_3D["total_num"]).epochs()
    for method in GRAPH_METHODS_3D:
        t0 = time.perf_counter()
        engine = Engine(config_3d(method, **GRAPH_SMALL_3D))
        engine.attach_store(store)
        graph_against_eager(engine, f"phase 14d {method} 3D", card,
                            chunks(stream))
        print(f"phase 14d {method} 3D: {time.perf_counter() - t0:.1f} s")
        del engine
    torch.cuda.empty_cache()


def run_graph_fit(card):
    """14e: config 2's mean_teacher ``fit`` with the CLI's flags
    (:func:`par_cli_argv` at ``GRAPH_FIT_*``) and ``--scan_steps``
    ``GRAPH_K``: chunks cut at the validations and checkpoints, validation
    in eval mode between replays, checkpoints taken while the graphs
    live; stopped at ``GRAPH_FIT_STOP`` and resumed from its checkpoint on
    the same engine, which drops its graphs and their pool for the new
    state and captures anew; steps 11-20 traced (``profile_dir``).
    Against two fits through ``cli.main`` with ``--scan_steps 1``: the
    same step, counts and generator state, the same files, and the
    checkpoints' floating tensors within ``PAR_CLI_SPREAD`` times the two
    plain fits' spread (:func:`par_compare_cli`). Kernel #1: 2 + 2 host
    launches a capture (its warm-up step and the capture itself) and none
    a replay, and one forward and one backward device kernel a step in
    the trace. Returns those device kernels."""
    import dataclasses
    import shutil

    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train import cli
    from cvssl_tpu_torch.train.engine import Engine, fit
    from cvssl_tpu_torch.utils.profiler import StepWindowProfiler

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_graph_fit_")

    def argv(name, k):
        return par_cli_argv(os.path.join(root, name), GRAPH_FIT_STEPS,
                            GRAPH_FIT_VAL, GRAPH_FIT_CKPT) + [
                                "--scan_steps", str(k)]

    def data():
        return (SyntheticACDC(), two_stream(1337),
                blob_volumes(n=PAR_CLI_VAL))
    plain = [cli.main(argv(name, 1), data=data())
             for name in ("plain", "again")]
    prof_dir = os.path.join(root, "profile")
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        argv("graph", GRAPH_K) + ["--profile_dir", prof_dir]))
    window = StepWindowProfiler(prof_dir)
    engine = Engine(cfg)
    before = dict(fcd.LAUNCHES)
    first = fit(cfg, engine=engine, max_steps=GRAPH_FIT_STOP, data=data())
    graphs = len(engine._graphs)
    res = fit(dataclasses.replace(cfg, profile_dir=None), engine=engine,
              data=data())
    host = {n: fcd.LAUNCHES[n] - before[n] for n in before}
    g, p = res["state"], plain[0]["state"]
    print(f"phase 14e: fit --scan_steps {GRAPH_K}, {first['iterations']} "
          f"iterations, then resumed to {res['iterations']} on the same "
          f"engine: {graphs} graph(s) before the resume, "
          f"{len(engine._graphs)} after; kernel #1's host launches {host}; "
          f"{first['slices_per_sec']:.2f} slices/s (steps 11-20 profiled) "
          f"and {res['slices_per_sec']:.2f} (a capture among 10 steps), "
          f"--scan_steps 1: {plain[0]['slices_per_sec']:.2f}, "
          f"{plain[1]['slices_per_sec']:.2f} slices/s (all with validation "
          f"and checkpoints, not throughputs), on {card}")
    if (first["iterations"], res["iterations"]) != (GRAPH_FIT_STOP,
                                                    GRAPH_FIT_STEPS):
        raise SystemExit(f"phase 14e: iterations {first['iterations']}, "
                         f"{res['iterations']}")
    if graphs != 1 or len(engine._graphs) != 1 or \
            any(n != 4 for n in host.values()):
        raise SystemExit(f"phase 14e: {graphs} and {len(engine._graphs)} "
                         f"graphs, host launches {host}: not one graph "
                         "captured before and one after the resume")
    for other in plain:
        o = other["state"]
        if g.step != o.step or {n: x.count for n, x in g.optimizers.items()} \
                != {n: x.count for n, x in o.optimizers.items()} or \
                not torch.equal(g.generator.get_state(),
                                o.generator.get_state()):
            raise SystemExit("phase 14e: step, counts or generator state "
                             "differ from the --scan_steps 1 fit's")
    traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    if len(traces) != 1:
        raise SystemExit(f"phase 14e: traces {traces} in {prof_dir}")
    with open(traces[0]) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    counts = {k: sum(f"{k}_kernel" in e.get("name", "") for e in kernels)
              for k in fcd.LAUNCHES}
    steps = window.stop - window.start
    print(f"phase 14e: kernel #1's device kernels {counts} in the trace of "
          f"steps {window.start + 1}-{window.stop} (graph replays), on "
          f"{card}")
    if any(n != steps for n in counts.values()):
        raise SystemExit(f"phase 14e: kernel #1's device kernels {counts} "
                         f"in the trace, not {steps} each")
    par_compare_cli(root, "graph", GRAPH_FIT_STEPS, "phase 14e",
                    f"fit --scan_steps {GRAPH_K} resumed at "
                    f"{GRAPH_FIT_STOP}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 14e: {time.perf_counter() - t0:.1f} s")
    return counts


def run_graphs(card):
    """Phase 14: ``Engine.train_steps_scan`` and ``train_steps_fixed`` as
    CUDA graph replays against the eager steps (see the module's
    docstring). Returns kernel #1's device kernels in each graphed call
    profiled, keyed as the kernels line keys the methods."""
    import torch
    from cvssl_tpu_torch.data.device_store import DeviceSliceStore
    from cvssl_tpu_torch.train.engine import Engine

    t_phase = t0 = time.perf_counter()
    # (a) config 2's main path, across the step-1000 graph key
    cfg = method_config("mean_teacher")
    main = Engine(cfg)
    main.attach_store(DeviceSliceStore(SyntheticACDC(), cfg.patch_size))
    stream = two_stream(14).epochs()

    def rows(k=GRAPH_K):
        return [next(stream) for _ in range(k)]
    g, e, pool = graph_against_eager(
        main, "phase 14a mean_teacher config 2", card,
        [(GRAPH_START + c * GRAPH_K, rows()) for c in range(GRAPH_CHUNKS)])
    if len(main._graphs) != 2:
        raise SystemExit(f"phase 14a: {len(main._graphs)} graphs across "
                         "step 1000, not 2")
    prof_a = graph_timed("phase 14a mean_teacher config 2", main, card, g, e,
                         pool, rows, GRAPH_TIMED // GRAPH_K, GRAPH_K,
                         "slices", BATCH, 1)
    print(f"phase 14a: {time.perf_counter() - t0:.1f} s")

    # (b) config 4's cross_teaching: a UNet and SwinUnet-tiny, host-bound
    t0 = time.perf_counter()
    vit = Engine(vit_config("cross_teaching"))
    vit.attach_store(DeviceSliceStore(SyntheticACDC(),
                                      (VIT_PATCH, VIT_PATCH)))
    vstream = two_stream(15, VIT_BATCH, VIT_LABELED_BS).epochs()

    def vrows(k=GRAPH_K):
        return [next(vstream) for _ in range(k)]
    vg, ve, pool = graph_against_eager(
        vit, "phase 14b cross_teaching config 4", card,
        [(GRAPH_START + c * GRAPH_K, vrows())
         for c in range(GRAPH_VIT_CHUNKS)])
    prof_b = graph_timed("phase 14b cross_teaching config 4", vit, card, vg,
                         ve, pool, vrows, GRAPH_VIT_TIMED // GRAPH_K,
                         GRAPH_K, "slices", VIT_BATCH,
                         VIT_METHOD_LAUNCHES["cross_teaching"])
    print(f"phase 14b: {time.perf_counter() - t0:.1f} s")

    # (c) UAMT-3D at config 5 through train_steps_fixed on one random batch
    t0 = time.perf_counter()
    u3 = Engine(config_3d("uamt"))
    gen = torch.Generator(device="cuda").manual_seed(14)
    batch = {"image": torch.randn((BATCH_3D, 1) + (PATCH_3D,) * 3,
                                  generator=gen, device="cuda"),
             "label": torch.randint(0, CLASSES_3D, (BATCH_3D,)
                                    + (PATCH_3D,) * 3, generator=gen,
                                    device="cuda", dtype=torch.uint8)}
    ug, ue, pool = graph_against_eager(
        u3, "phase 14c uamt 3D config 5", card, [(GRAPH_START, None)],
        batch=batch, k=GRAPH_K)
    prof_c = graph_timed("phase 14c uamt 3D config 5", u3, card, ug, ue,
                         pool, None, GRAPH_TIMED // GRAPH_K, GRAPH_K,
                         "volumes", BATCH_3D, UAMT_3D_LAUNCHES, fixed=batch)
    print(f"phase 14c: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    profiles = {"mean_teacher_graphed": prof_a(),
                "cross_teaching_graphed": prof_b(),
                "uamt_3d_graphed": prof_c()}
    del main, vit, u3, g, e, vg, ve, ug, ue, prof_a, prof_b, prof_c
    torch.cuda.empty_cache()
    print(f"phase 14 profiles: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    run_graph_small(card)
    print(f"phase 14d: {time.perf_counter() - t0:.1f} s")
    fit_kernels = run_graph_fit(card)
    print(f"phase 14 (graphs): {time.perf_counter() - t_phase:.1f} s")
    return {**{m: {"launches": p["graphed"]["kernels"]}
               for m, p in profiles.items()},
            "mean_teacher_graphed_fit": {"launches": fit_kernels}}


def gan_nets():
    """Phase 15a's nets on the CPU, torch's default init from seed 15:
    ``define_g(1, 64, "resnet_9blocks")``, ``define_g(1, 64, "unet_256")``
    and ``define_d(64, "basic")``."""
    import torch
    from cvssl_tpu_torch.models import gan
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(15)
        return {"resnet_9blocks": gan.define_g(1, 64, "resnet_9blocks"),
                "unet_256": gan.define_g(1, 64, "unet_256"),
                "basic": gan.define_d(64, "basic")}


def run_gan_nets(card):
    """Phase 15a: an LSGAN step of each generator against the basic
    discriminator on the card (ms/step, peak memory), then each net's
    float32 eval forward on the card against the CPU's."""
    import copy

    import torch
    from cvssl_tpu_torch.models import gan
    from cvssl_tpu_torch.ops.schedules import DiscriminatorAdam

    cpu = gan_nets()
    nets = {n: copy.deepcopy(m).cuda() for n, m in cpu.items()}
    for name, m in nets.items():
        print(f"phase 15a: {name} {sum(p.numel() for p in m.parameters()):,}"
              " parameters")
    gen = torch.Generator(device="cuda").manual_seed(15)
    shape = (GAN_BATCH, 1, GAN_SIDE, GAN_SIDE)
    x = torch.rand(shape, generator=gen, device="cuda") * 2.0 - 1.0
    real = torch.rand(shape, generator=gen, device="cuda") * 2.0 - 1.0
    d = nets["basic"].train()
    opt_d = DiscriminatorAdam(d.parameters())
    for name in ("resnet_9blocks", "unet_256"):
        g = nets[name].train()
        opt_g = DiscriminatorAdam(g.parameters())
        d0 = [p.detach().clone() for p in d.parameters()]
        g0 = [p.detach().clone() for p in g.parameters()]
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for step in range(GAN_STEPS):
            if step == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            fake = g(x, gen)
            loss_g = gan.gan_loss(d(fake), True)
            opt_g.zero_grad(set_to_none=True)
            loss_g.backward()
            opt_g.step()
            loss_d = 0.5 * (gan.gan_loss(d(fake.detach()), False)
                            + gan.gan_loss(d(real), True))
            opt_d.zero_grad(set_to_none=True)
            loss_d.backward()
            opt_d.step()
            losses.append(torch.stack([loss_g.detach(), loss_d.detach()]))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (GAN_STEPS - 1) * 1e3
        vals = torch.stack(losses).cpu()
        if not bool(torch.isfinite(vals).all()):
            raise SystemExit(f"phase 15a {name}: losses {vals.tolist()}")
        for what, before, m in (("generator", g0, g), ("discriminator", d0,
                                                       d)):
            if all(torch.equal(a, b) for a, b in zip(before, m.parameters())):
                raise SystemExit(f"phase 15a {name}: the {what} did not "
                                 "move")
        print(f"phase 15a LSGAN {name} + basic D, batch {GAN_BATCH} at "
              f"{GAN_SIDE}^2 float32 (TF32 off): {ms:.2f} ms/step over "
              f"{GAN_STEPS - 1} steps, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, "
              f"losses G {vals[0, 0]:.4f} -> {vals[-1, 0]:.4f}, D "
              f"{vals[0, 1]:.4f} -> {vals[-1, 1]:.4f}, on {card}")
    rows = x[:GAN_CPU_ROWS]
    for name, m in nets.items():
        ref = cpu[name]
        ref.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
        inp = rows if name != "basic" else real[:GAN_CPU_ROWS]
        with torch.no_grad():
            got = m.eval()(inp).cpu()
            want = ref.eval()(inp.cpu())
        err = float((got - want).abs().max() / want.abs().max())
        sat = float((want.abs() > 0.99).float().mean())
        print(f"phase 15a eval {name}: output {tuple(got.shape)}, card vs "
              f"CPU max rel err {err:.3e} (bound {GAN_REL_TOL:g}; share of "
              f"|y| > 0.99 {sat:.3f})")
        if not err <= GAN_REL_TOL:
            raise SystemExit(f"phase 15a: {name}'s eval forward on the card "
                             "disagrees with the CPU")


def run_scse():
    """Phase 15b: ``SCSEModule`` on the card against the CPU at the main
    path's 2D and config 5's 3D activation shapes (16 channels)."""
    import torch
    from cvssl_tpu_torch.models.attention import SCSEModule

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(16)
        ref = SCSEModule(16)
    m = SCSEModule(16).cuda()
    m.load_state_dict(ref.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(16)
    for shape in SCSE_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda")
        with torch.no_grad():
            got = m(x).cpu()
            want = ref(x.cpu())
        err = float((got - want).abs().max() / want.abs().max())
        print(f"phase 15b SCSEModule {shape}: card vs CPU max rel err "
              f"{err:.3e} (bound {SCSE_REL_TOL:g})")
        if not err <= SCSE_REL_TOL:
            raise SystemExit(f"phase 15b: SCSEModule at {shape} disagrees")


def check_init(model, init_type):
    """Phase 15c's statistics of ``init_weights(model, init_type)``, the
    CPU test's: every bias exactly 0; each BatchNorm scale's mean within
    0.05 of 1; each kernel of at least 2,000 elements at JAX's std (normal:
    within 0.005 of 0.02; xavier, kaiming: within 10%, fans on the Flax
    shape), or orthonormal along its Flax matrix's shorter side to 1e-4."""
    import torch
    for name, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            what = f"phase 15c {init_type} {name}.{pname}"
            p = p.detach()
            if pname == "bias":
                if bool(p.any()):
                    raise SystemExit(f"{what}: a bias is not 0")
            elif isinstance(m, torch.nn.BatchNorm2d):
                if abs(float(p.mean()) - 1.0) >= 0.05:
                    raise SystemExit(f"{what}: scale mean {p.mean()}")
            elif p.numel() >= 2000:
                k = p.permute(2, 3, 1, 0).reshape(-1, p.shape[0]).double()
                if init_type == "orthogonal":
                    gram = k.T @ k if k.shape[0] >= k.shape[1] else k @ k.T
                    err = float((gram - torch.eye(
                        len(gram), dtype=gram.dtype,
                        device=gram.device)).abs().max())
                    if not err <= INIT_ORTHO_TOL:
                        raise SystemExit(f"{what}: not orthogonal ({err})")
                    continue
                fan_in, fan_out = k.shape[0], p.shape[0] * k.shape[0] \
                    // p.shape[1]
                std = {"normal": 0.02,
                       "xavier": (2.0 / (fan_in + fan_out)) ** 0.5,
                       "kaiming": (2.0 / fan_in) ** 0.5}[init_type]
                bound = 0.005 if init_type == "normal" else 0.1 * std
                if abs(float(k.std()) - std) >= bound:
                    raise SystemExit(f"{what}: std {float(k.std())} against "
                                     f"{std}")


def run_init_steps(card):
    """Phase 15c: ``init_weights`` of each type on config 2's UNet with a
    CUDA generator, then mean-teacher steps from its "normal" re-init (the
    teacher a copy of it), kernel #1 once each way a step by its counts and
    in a one-step profile. Returns its counts in the steps."""
    import torch
    from cvssl_tpu_torch.data.device_store import DeviceSliceStore
    from cvssl_tpu_torch.models.initializers import init_weights
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine

    cfg = method_config("mean_teacher")
    engine = Engine(cfg)
    engine.attach_store(DeviceSliceStore(SyntheticACDC(), cfg.patch_size))
    stream = two_stream(15).epochs()
    state = engine.init_state()
    model = state.models["model"]
    gen = torch.Generator(device="cuda").manual_seed(15)
    for init_type in ("xavier", "kaiming", "orthogonal", "normal"):
        init_weights(model, init_type, gen)
        check_init(model, init_type)
        print(f"phase 15c init_weights {init_type!r} on config 2's UNet: "
              "biases 0, scales, kernels' statistics ok")
    state.teachers["model"].load_state_dict(model.state_dict())
    fcd.reset_launches()
    losses = []
    for _ in range(INIT_STEPS):
        before = dict(fcd.LAUNCHES)
        state, metrics = engine.train_steps(state, [next(stream)])
        for k in before:
            if fcd.LAUNCHES[k] != before[k] + 1:
                raise SystemExit(f"phase 15c {k}: {before[k]} -> "
                                 f"{fcd.LAUNCHES[k]} in one step")
        losses.append(float(metrics["loss"]))
    launches = dict(fcd.LAUNCHES)
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"phase 15c: losses {losses}")
    counts = {}
    for _ in range(3):          # a dropped record can only lower a count
        _, _, seen = graph_profile(
            lambda: engine.train_steps(state, [next(stream)]), 1)
        counts = {k: max(counts.get(k, 0), v) for k, v in seen.items()}
    if counts != {"ce_dice_fwd": 1, "ce_dice_bwd": 1}:
        raise SystemExit(f"phase 15c: kernel #1 in a one-step profile: "
                         f"{counts}")
    print(f"phase 15c: {INIT_STEPS} mean-teacher steps at config 2 from the "
          f"re-initialised UNet, losses {[round(v, 4) for v in losses]}, "
          f"kernel #1 launches {launches} (1 + 1 a step), in a one-step "
          f"profile {counts}, on {card}")
    return launches


def run_strong_transforms():
    """Phase 15d: host ms per sample of ``RandomGeneratorStrong`` and
    ``RandomGenerator`` from a synthetic ACDC slice to 256^2."""
    from cvssl_tpu_torch.data import transforms as tr
    slices = SyntheticACDC()
    for cls in (tr.RandomGeneratorStrong, tr.RandomGenerator):
        t = cls((PATCH, PATCH), np.random.default_rng(15))
        times = []
        for i in range(STRONG_SAMPLES):
            sample = slices[i]
            t0 = time.perf_counter()
            out = t(sample)
            times.append((time.perf_counter() - t0) * 1e3)
            if out["image"].shape != (PATCH, PATCH):
                raise SystemExit(f"phase 15d {cls.__name__}: "
                                 f"{out['image'].shape}")
        print(f"phase 15d {cls.__name__}: {float(np.median(times)):.3f} host "
              f"ms per {PATCH}^2 sample (median of {STRONG_SAMPLES})")


def run_library(card):
    """Phase 15: the last library modules on the card (see the module's
    docstring). Returns kernel #1's launches in 15c's steps, keyed as the
    kernels line keys the methods."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = t0 = time.perf_counter()
    run_gan_nets(card)
    print(f"phase 15a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_scse()
    print(f"phase 15b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = run_init_steps(card)
    print(f"phase 15c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run_strong_transforms()
    print(f"phase 15d: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    print(f"phase 15 (library): {time.perf_counter() - t_phase:.1f} s "
          f"(bound {PHASE15_BOUND_S:g} s)")
    return {"mean_teacher_init_weights": {"launches": launches}}


# ---------------------------------------------------------------------------
# Phase 16: the program's spans and step phases
# ---------------------------------------------------------------------------

def profiled_ops(fn):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA), the card
    synchronised inside: (device operations, host operations), each a
    list of (start us, end us, name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for ev in prof.events():
        op = (ev.time_range.start, ev.time_range.end, ev.name)
        (device if ev.device_type == cuda else host).append(op)
    return device, host


def union_us(ops):
    """The length of the union of the operations' intervals, us."""
    total, end = 0.0, None
    for s, e, _ in sorted(ops):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def no_program_span_on_device(what, device_ops):
    named = sorted({n for _, _, n in device_ops if n in PROGRAM_SPANS})
    if named:
        raise SystemExit(f"{what}: device operations named as the "
                         f"program's spans: {named}")


def check_step_phases(what, engine, state, rows, card):
    """Phase 16a/b: a graphed call (the capture and K - 1 replays), then
    the phases read from the last replay's event nodes, positive; an
    eager step's; then a profiled graphed call: the last replay's
    ``gather + forward + backward + update`` against a replay's device
    time, and no device operation named as a phase."""
    import torch
    from cvssl_tpu_torch.utils import tracing

    state.step = TRACE_START
    state, _ = engine.train_steps_scan(state, rows())
    torch.cuda.synchronize()
    if not tracing._REGISTRY.newest.captured:
        raise SystemExit(f"{what}: the newest step is not a replay's")
    try:
        graphed = tracing.step_ms()
    except RuntimeError as e:
        raise SystemExit(f"{what}: elapsed_time on the events a graph "
                         f"replay recorded failed: {e}") from e
    want = set(TRACE_PHASES) | {"teacher"}
    if set(graphed) != want or not all(v > 0 for v in graphed.values()):
        raise SystemExit(f"{what}: a replay's phases {graphed}")
    dev, _ = profiled_ops(lambda: engine.train_steps(state, rows(1)))
    eager = tracing.step_ms()
    if tracing._REGISTRY.newest.captured or set(eager) != want or not all(
            v > 0 for v in eager.values()):
        raise SystemExit(f"{what}: eager phases {eager}")
    no_program_span_on_device(f"{what} eager step", dev)
    dev, _ = profiled_ops(lambda: engine.train_steps_scan(state, rows()))
    ms = tracing.step_ms()
    replay = union_us(dev) / 1e3 / GRAPH_K
    total = sum(ms[p] for p in TRACE_PHASES)
    gap = total / replay - 1.0
    print(f"{what}: last replay's phases (ms) " + " ".join(
        f"{k} {v:.3f}" for k, v in ms.items()) + f"; gather + forward + "
        f"backward + update {total:.3f} ms against a replay's busy "
        f"{replay:.3f} ms ({100 * gap:+.2f}%, bound "
        f"{100 * TRACE_PHASE_TOL:g}%); unprofiled replay "
        + " ".join(f"{k} {v:.3f}" for k, v in graphed.items())
        + "; eager step " + " ".join(f"{k} {v:.3f}"
                                     for k, v in eager.items())
        + f", on {card}")
    if abs(gap) > TRACE_PHASE_TOL:
        raise SystemExit(f"{what}: the phases sum to {total:.3f} ms, a "
                         f"replay takes {replay:.3f} ms")
    no_program_span_on_device(f"{what} graphed call", dev)


def check_window_spans(device, card):
    """Phase 16c: UNet3D's sliding window as ``Engine.validate`` builds it,
    TRACE_VOLUMES hand-overs of 140 x 180 x 180 volumes at depth 2 under
    the profiler, each inside a user annotation as the benchmark's: one
    ``val3d.predict`` a volume covering TRACE_COVER of its hand-over, one
    ``val3d.forward`` and two ``val3d.accumulate`` a batch of windows,
    none of them on the device."""
    import functools

    import torch
    from torch.profiler import record_function
    from cvssl_tpu_torch.eval import val3d
    from cvssl_tpu_torch.train.engine import Engine

    engine = Engine(config_3d("uamt"))
    state = engine.init_state()
    ev = val3d.SlidingWindowEvaluator(
        functools.partial(engine.eval_probs, "model"), (PATCH_3D,) * 3,
        CLASSES_3D, 64, 64, predict_takes_args=True, device=device)
    src = brats_volumes(device, 2, seed=600)
    vols = [src[i]["image"] for i in range(2)]
    model = state.models["model"]
    ev.predict_volume(vols[0], model)

    def stream():
        pending = []
        for i in range(TRACE_VOLUMES):
            with record_function("smoke.enqueue"):
                pending.append(ev.predict_volume_async(vols[i % 2], model))
            if len(pending) >= 2:
                pending.pop(0)()
        for done in pending:
            done()
    dev, host = profiled_ops(stream)
    no_program_span_on_device("phase 16c", dev)
    spans = {n: [(s, e) for s, e, m in host if m == n]
             for n in ("smoke.enqueue",) + PROGRAM_SPANS[-3:]}
    batches = math.ceil(SW_WINDOWS / ev.patch_batch)
    counts = {n: len(v) for n, v in spans.items()}
    if counts != {"smoke.enqueue": TRACE_VOLUMES,
                  "val3d.predict": TRACE_VOLUMES,
                  "val3d.forward": TRACE_VOLUMES * batches,
                  "val3d.accumulate": 2 * TRACE_VOLUMES * batches}:
        raise SystemExit(f"phase 16c: spans {counts}")
    ms = {n: sum(e - s for s, e in v) / 1e3 / TRACE_VOLUMES
          for n, v in spans.items()}
    cover = ms["val3d.predict"] / ms["smoke.enqueue"]
    print("phase 16c: sliding window, host ms a volume under the profiler: "
          + " ".join(f"{n} {v:.3f}" for n, v in ms.items())
          + f"; val3d.predict covers {100 * cover:.2f}% of the hand-over "
          f"(bound {100 * TRACE_COVER:g}%), on {card}")
    if cover < TRACE_COVER:
        raise SystemExit("phase 16c: the val3d.predict spans cover too "
                         "little of the hand-overs")


def run_tracing(device, card):
    """Phase 16: ``utils/tracing.py`` on the card (see the module's
    docstring)."""
    import torch
    from cvssl_tpu_torch.data.device_store import (DeviceSliceStore,
                                                   DeviceVolumeStore)
    from cvssl_tpu_torch.train.engine import Engine

    t_phase = t0 = time.perf_counter()
    cfg = method_config("mean_teacher")
    engine = Engine(cfg)
    engine.attach_store(DeviceSliceStore(SyntheticACDC(), cfg.patch_size))
    stream = two_stream(16).epochs()
    check_step_phases("phase 16a mean_teacher config 2", engine,
                      engine.init_state(),
                      lambda k=GRAPH_K: [next(stream) for _ in range(k)],
                      card)
    del engine
    print(f"phase 16a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine = Engine(config_3d("uamt"))
    engine.attach_store(DeviceVolumeStore(brats_volumes(device),
                                          (PATCH_3D,) * 3))
    stream3 = two_stream_3d(16).epochs()
    check_step_phases("phase 16b uamt 3D config 5", engine,
                      engine.init_state(),
                      lambda k=GRAPH_K: [next(stream3) for _ in range(k)],
                      card)
    del engine
    torch.cuda.empty_cache()
    print(f"phase 16b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_window_spans(device, card)
    torch.cuda.empty_cache()
    print(f"phase 16c: {time.perf_counter() - t0:.1f} s")
    print(f"phase 16 (tracing): {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--conv-only", action="store_true",
        help="build only csrc/conv3x3_p8.cu and run phase 6 (check, time "
        "and drive the conv kernels), then stop without the result line: "
        "the short first call after a change to the conv kernels")
    parser.add_argument(
        "--3d-only", dest="only_3d", action="store_true",
        help="build only csrc/fused_ce_dice.cu and run phase 8 (the 3D "
        "path, its checked steps under sync debug mode \"error\"), then "
        "stop without the result line")
    parser.add_argument(
        "--test-zoo-only", dest="only_9", action="store_true",
        help="build only csrc/fused_ce_dice.cu and run phase 9 (the test "
        "CLIs on the weights of two short fits, then the zoo, its checked "
        "steps under sync debug mode \"error\"), then stop without the "
        "result line")
    parser.add_argument(
        "--vit3d-only", dest="only_vit3d", action="store_true",
        help="build only csrc/fused_ce_dice.cu and run phase 10 (the 3D "
        "ViTs, their checked steps under sync debug mode \"error\"), then "
        "stop without the result line")
    parser.add_argument(
        "--zoo2d-only", dest="only_zoo2d", action="store_true",
        help="build only csrc/fused_ce_dice.cu and run phase 11 (the 2D "
        "zoo, its checked steps under sync debug mode \"error\", and the "
        "--pretrained_ckpt fits), then stop without the result line")
    parser.add_argument(
        "--profile-only", dest="only_profile", action="store_true",
        help="build only csrc/fused_ce_dice.cu and run phase 12 (fit with "
        "profile_dir, kernel #1 counted in its trace, measure_fp_bp_time), "
        "then stop without the result line")
    parser.add_argument(
        "--parallel-only", dest="only_parallel", action="store_true",
        help="build only csrc/fused_ce_dice.cu and run phase 13 (two gloo "
        "ranks on the card against one process, the --distributed CLI fit "
        "under torchrun), then stop without the result line")
    parser.add_argument(
        "--graph-only", dest="only_graph", action="store_true",
        help="build only csrc/fused_ce_dice.cu and run phase 14 (K steps "
        "a call as CUDA graphs against the eager steps), then stop "
        "without the result line")
    parser.add_argument(
        "--gan-only", dest="only_gan", action="store_true",
        help="build only csrc/fused_ce_dice.cu and run phase 15 (the GAN "
        "nets, SCSEModule, init_weights with mean-teacher steps, the "
        "strong transforms), then stop without the result line")
    parser.add_argument(
        "--tracing-only", dest="only_tracing", action="store_true",
        help="build only csrc/fused_ce_dice.cu and run phase 16 (the step "
        "phases of graphed and eager steps, the sliding window's spans "
        "under the profiler), then stop without the result line")
    parser.add_argument(
        "--par-cli-fit", metavar="DIR", default=None,
        help="phase 13b's child: the CLI's config-2 fit into DIR (with "
        "--distributed, under torchrun); phase 13 starts it")
    parser.add_argument("--distributed", action="store_true",
                        help="with --par-cli-fit: pass --distributed")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from cvssl_tpu_torch.ops import _cuda_build
    from cvssl_tpu_torch.ops import conv3x3_p8 as cv
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    # one nvcc per source, all started at once, in the background
    built = {}

    def build(name, load):
        try:
            t0 = time.perf_counter()
            load()
            built[name] = time.perf_counter() - t0
        except Exception as e:  # re-raised in the main thread below
            built[name] = e
    if args.par_cli_fit:
        par_cli_fit(args.par_cli_fit, args.distributed)
        return 0
    sources = ([] if (args.only_3d or args.only_9 or args.only_vit3d
                      or args.only_zoo2d or args.only_profile
                      or args.only_parallel or args.only_graph
                      or args.only_gan or args.only_tracing)
               else [("conv3x3_p8", cv._library)])
    if not args.conv_only:
        sources.insert(0, ("fused_ce_dice", fcd._library))
    builders = {name: threading.Thread(target=build, args=(name, load))
                for name, load in sources}
    for t in builders.values():
        t.start()

    def wait(name):
        builders[name].join()
        if isinstance(built[name], Exception):
            raise built[name]
        print(f"{name} built in {built[name]:.1f} s (nvcc, in the "
              f"background); ptxas, per kernel:\n  " + "\n  ".join(
                  ptxas_summary(_cuda_build.BUILD_LOGS.get(name, ""))))

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    mem_bw, f32_rate, tf32_rate = card_rates(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {name}; "
          f"rates {mem_bw / 1e12} TB/s, {f32_rate / 1e12} TFLOP/s f32, "
          f"{tf32_rate / 1e12} TFLOP/s TF32 tensor; "
          f"h5py installed: {importlib.util.find_spec('h5py') is not None}"
          f"; PIL installed: {importlib.util.find_spec('PIL') is not None}")

    if args.conv_only:
        wait("conv3x3_p8")
        check_conv(device)
        time_conv(device, mem_bw, tf32_rate)
        drive_conv(device)
        print("chip_smoke --conv-only: the conv kernels passed; no result "
              "line (the other phases did not run)")
        return 0

    wait("fused_ce_dice")
    if args.only_3d:
        run_3d(device, smi, True, mem_bw, f32_rate)
        print("chip_smoke --3d-only: phase 8 passed; no result line (the "
              "other phases did not run)")
        return 0
    if args.only_9:
        run_phase9(device, smi, True, mem_bw, f32_rate,
                   *short_fit_weights(device, smi))
        print("chip_smoke --test-zoo-only: phase 9 passed; no result line "
              "(the other phases did not run)")
        return 0
    if args.only_vit3d:
        run_vit3d(device, smi, True, mem_bw, f32_rate)
        print("chip_smoke --vit3d-only: phase 10 passed; no result line "
              "(the other phases did not run)")
        return 0
    if args.only_zoo2d:
        run_zoo2d(smi, True)
        print("chip_smoke --zoo2d-only: phase 11 passed; no result line "
              "(the other phases did not run)")
        return 0
    if args.only_profile:
        run_profiled_fit(device, smi)
        print("chip_smoke --profile-only: phase 12 passed; no result line "
              "(the other phases did not run)")
        return 0
    if args.only_parallel:
        run_parallel(device, smi)
        print("chip_smoke --parallel-only: phase 13 passed; no result line "
              "(the other phases did not run)")
        return 0
    if args.only_graph:
        run_graphs(smi)
        print("chip_smoke --graph-only: phase 14 passed; no result line "
              "(the other phases did not run)")
        return 0
    if args.only_gan:
        run_library(smi)
        print("chip_smoke --gan-only: phase 15 passed; no result line (the "
              "other phases did not run)")
        return 0
    if args.only_tracing:
        run_tracing(device, smi)
        print("chip_smoke --tracing-only: phase 16 passed; no result line "
              "(the other phases did not run)")
        return 0
    t0 = time.perf_counter()
    err = check_kernels(device)
    print(f"kernels checked in {time.perf_counter() - t0:.1f} s")
    timing = time_kernels(device, mem_bw, f32_rate)
    engine, state, store, launches, _ = run_main_path(device, smi)
    trace_kernels(device)
    check_eval(engine, state, store)
    del engine, state
    methods, strict = run_other_methods(device, smi, store)
    del store
    methods.update(run_vit_methods(smi, strict))
    methods.update(run_config3(smi, strict))

    wait("conv3x3_p8")
    conv_err = check_conv(device)
    conv_timing = time_conv(device, mem_bw, tf32_rate)
    conv_launches = drive_conv(device)
    ccons_launches, w2d = run_fit(device, smi, strict)
    methods["contrastive_consistency"] = {"launches": ccons_launches}
    r3d = run_3d(device, smi, strict, mem_bw, f32_rate)
    methods.update(r3d["methods"])
    r9 = run_phase9(device, smi, strict, mem_bw, f32_rate, w2d,
                    r3d["weights"])
    methods.update(r9["methods"])
    r10 = run_vit3d(device, smi, strict, mem_bw, f32_rate)
    methods.update(r10["methods"])
    methods.update(run_zoo2d(smi, strict))
    methods.update(run_parallel(device, smi))
    methods.update(run_graphs(smi))
    methods.update(run_library(smi))
    # last: the profiler's sessions slow every later launch
    run_tracing(device, smi)
    methods["mean_teacher_profiled_fit"] = {
        "launches": run_profiled_fit(device, smi)}

    source = "cvssl_tpu_torch/csrc/fused_ce_dice.cu"
    replaces = {"ce_dice_fwd": "cvssl_tpu/ops/pallas_kernels.py:65",
                "ce_dice_bwd": "cvssl_tpu/ops/pallas_kernels.py:131"}
    kernels = [{"name": k, "route": "cuda", "source": source,
                "replaces": replaces[k], "launches": launches[k],
                "method_launches": {m: r["launches"][k]
                                    for m, r in methods.items()},
                "max_abs_err": err[k], "ms": timing[k]["ms"],
                "plain_ms": timing[k]["plain_ms"],
                "bound_ms": timing[k]["bound_ms"],
                "bound_by": timing[k]["bound_by"], "library_ms": None,
                "at_5d": {"shape": list(SHAPE_3D),
                          "max_abs_err": r3d["err"][k],
                          **{f: r3d["timing"][k][f] for f in
                             ("ms", "plain_ms", "bound_ms", "bound_by")}},
                "at_nnunet": {"shape": list(NNUNET_SHAPE),
                              "dtype": "float32",
                              "max_abs_err": r9["err"][k],
                              **{f: r9["timing"][k][f] for f in
                                 ("ms", "plain_ms", "bound_ms",
                                  "bound_by")}},
                **{f"at_{net}": {"shape": list(vit3d_shape(net)),
                                 "dtype": "float32",
                                 "max_abs_err": r10["err"][net][k],
                                 **{f: r10["timing"][net][k][f] for f in
                                    ("ms", "plain_ms", "bound_ms",
                                     "bound_by")}}
                   for net in VIT3D_PATCH}}
               for k in fcd.LAUNCHES]
    replaces = {"conv3x3_p8": "cvssl_tpu/ops/pallas_conv.py:215",
                "conv3x3_p8_dma": "cvssl_tpu/ops/pallas_conv.py:112",
                "conv3x3_p8_db": "cvssl_tpu/ops/pallas_conv.py:182"}
    kernels += [{"name": k, "route": "cuda",
                 "source": "cvssl_tpu_torch/csrc/conv3x3_p8.cu",
                 "replaces": replaces[k], "launches": conv_launches[k],
                 "max_abs_err": conv_err[k], "ms": conv_timing[k]["ms"],
                 "plain_ms": conv_timing[k]["plain_ms"],
                 "bound_ms": conv_timing[k]["bound_ms"],
                 "bound_by": conv_timing[k]["bound_by"],
                 "library_ms": conv_timing[k]["library_ms"]}
                for k in cv.LAUNCHES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
