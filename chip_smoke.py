#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``cvssl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card. Builds the kernels from the CUDA sources in this
checkout with ``nvcc`` into ``build/kernels`` (one ``nvcc`` per source, all
started at once in the background), then runs, in order; any failure ends
the run with a non-zero exit:

1. device: CUDA must be available; prints the card's name and power limit,
   and whether ``h5py`` is installed (the fit phase does not need it);
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
   memory, a short profile of where the step's device time goes, and a
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
   adversarial and exam_student_teacher its models' parameter counts (UNet
   1,813,764, UNetCCT 3,713,664, UNetURPC 1,821,840, FCDiscriminator
   2,762,754), 5 steps from step 0 and 5 from step 1000 with kernel #1
   launched 1, 1, 1, 2, 4, 4, 1, 1, 1 times a step (forward and backward),
   finite losses, a live consistency term after step 1000 (for cps: its
   pseudo-supervision term, recomputed from the other model's argmax; for
   fixmatch its unsupervised term), the teachers (uamt, ict, fixmatch,
   exam), both models (cps) and the discriminators moved, slices/s and
   peak memory over 30 steps, and a short profile of each method's step
   (device busy time per step); every method's checked steps run under the
   sync debug mode "error" if the mean-teacher step made no synchronising
   call. uamt's output conv is scaled by 8 so that its MC teacher is sure
   somewhere;
5b. north-star config 4's CNN+ViT methods, cross_teaching, cnn_meet_vit
   and tripleview: a UNet and SwinUnet-tiny (27,168,420 parameters; two
   UNets for tripleview) at full width, batch 16 = 8 + 8 at 224^2, dtype
   auto (bf16 for both), from their own store of the same synthetic slices
   at 224^2; the same checks and numbers as phase 5 for each, kernel #1
   launched 2, 2 and 3 times a step, every model (and cnn_meet_vit's
   teacher) moved, the Dice pseudo-supervision after step 1000 recomputed
   from the other model's argmax with a plain float64 Dice; then the
   SwinUnet's predictions and its eval forward in float32 on the card
   against the CPU;
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
   10 x 256^2, so validation runs resident on the card); 400 iterations
   with val and checkpoints every 200 into a temporary snapshot
   directory, then a second ``fit`` to 600 that must resume from 400; the
   checkpoint files, the val table, the fused kernel's launches (one per
   iteration), slices/s including validation and checkpoints, the val
   pass's time and the EDT's peak memory; then ``fit`` of cps on the same
   data, 200 iterations with val and checkpoints every 100: the dual-model
   checkpoint files (``model1_``/``model2_`` prefixes,
   ``unet_best_model1.ckpt``, no EMA files), two launches of each kernel an
   iteration; then ``fit`` of fixmatch, 100 iterations with one
   validation and one checkpoint, through the store's ``weak_strong``
   mode; then ``fit`` of cross_teaching at config 4's size on the same
   train slices and val volumes at 224^2, 200 iterations with val and
   checkpoints every 100: both slots validated (model2 at ``patch_size2``),
   the dual-model files, two launches of each kernel an iteration;
8. one JSON line of the kernels (kernel #1's with its launches in each
   method's run of phases 5 and 5b), then the result line
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
MEASURE_STEPS = 30
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
FIT_STEPS, FIT_RESUME_STEPS, FIT_EVERY = 400, 600, 200
# the other UNet-family 2D methods: kernel #1's forward (and backward)
# launches per step of each
METHOD_LAUNCHES = {"uamt": 1, "ict": 1, "deep_co_training": 1, "cps": 2,
                   "cct": 4, "urpc": 4, "fixmatch": 1, "adversarial": 1,
                   "exam_student_teacher": 1}
METHOD_STEPS = 5               # from step 0, and again from step 1000
MODEL_PARAMS = {"unet": 1_813_764, "unet_cct": 3_713_664,
                "unet_urpc": 1_821_840, "discriminator": 2_762_754,
                "swin_unet": 27_168_420}
# the metric that carries each method's unsupervised term
CONSISTENCY_KEY = {"fixmatch": "unsup_loss"}
# uamt's output conv (student and teacher) scaled up, so that the MC
# teacher of a freshly initialised UNet is sure at some sites and the
# masked consistency term is live (random init alone: every site's entropy
# is above the threshold)
UAMT_LOGIT_SCALE = 8.0
CPS_FIT_STEPS, CPS_FIT_EVERY = 200, 100
# north-star config 4 (bench.py:176-178): a UNet and SwinUnet-tiny, batch
# 16 = 8 labeled + 8 unlabeled at 224^2; kernel #1's launches a step of
# each CNN+ViT method (one per model, forward and backward)
VIT_BATCH, VIT_LABELED_BS, VIT_PATCH = 16, 8, 224
VIT_SHAPE = (VIT_LABELED_BS, CLASSES, VIT_PATCH, VIT_PATCH)
VIT_METHOD_LAUNCHES = {"cross_teaching": 2, "cnn_meet_vit": 2,
                       "tripleview": 3}
VIT_FIT_STEPS, VIT_FIT_EVERY = 200, 100
# each method's pseudo-supervision term, and its calls in a step, in
# order: (i, j) is model i's input with model j's argmax as labels
PSEUDO_TERM = {"cps": "_pseudo_ce", "cross_teaching": "_pseudo_dice",
               "cnn_meet_vit": "_pseudo_dice", "tripleview": "_pseudo_dice"}
PSEUDO_PAIRS = {"cps": ((0, 1), (1, 0)),
                "cross_teaching": ((0, 1), (1, 0)),
                "cnn_meet_vit": ((0, 1), (1, 0)),
                "tripleview": ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0),
                               (2, 1))}
FIXMATCH_FIT_STEPS = 100       # one validation, one checkpoint

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

    def __init__(self, n=ACDC_TRAIN_SLICES, shape=(232, 256)):
        self._shape = shape
        self._n = n

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"image": r.normal(0.5, 0.2, self._shape).astype(np.float32),
                "label": r.integers(0, 4, self._shape).astype(np.uint8)}


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
    version, on the vector path (main shape) and the scalar loop (ragged
    shape, and the main shape at an unaligned offset), at 4 classes and at
    2 and 16; two calls of each kernel on the same inputs must agree bit
    for bit. Returns the largest absolute errors seen."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    gen = torch.Generator(device=device).manual_seed(0)
    err = {"ce_dice_fwd": 0.0, "ce_dice_bwd": 0.0}
    f32, bf16, i32, u8 = (torch.float32, torch.bfloat16, torch.int32,
                          torch.uint8)
    cases = [(MAIN_SHAPE, f32, i32, False), (MAIN_SHAPE, bf16, i32, False),
             (VIT_SHAPE, f32, i32, False), (VIT_SHAPE, bf16, i32, False)]
    cases += [(RAGGED_SHAPE, dt, lt, False) for dt in (f32, bf16)
              for lt in (i32, u8)]
    cases += [(MAIN_SHAPE, f32, i32, True), (MAIN_SHAPE, bf16, u8, True)]
    cases += [(shape, getattr(torch, dt), getattr(torch, lt), False)
              for shape, dt, lt in OTHER_CLASSES]
    for shape, dtype, label_dtype, offset in cases:
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
        if geo.vector != (shape[2:] != RAGGED_SHAPE[2:] and not offset):
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
    return err


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


def kernel_calls(device):
    """Kernel #1 at the main-path shape in the main path's dtype (bf16
    logits, int32 labels): its forward and backward launches, the empty
    kernel, and a 1 GiB flush buffer, larger than L2 (50 MB), whose ~0.3 ms
    write outlasts the host's enqueueing of any call timed here."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    gen = torch.Generator(device=device).manual_seed(1)
    logits = torch.randn(MAIN_SHAPE, generator=gen, device=device).to(
        torch.bfloat16)
    labels = torch.randint(0, CLASSES, MAIN_SHAPE[:1] + MAIN_SHAPE[2:],
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


def time_kernels(device, mem_bw, f32_rate):
    """Phase 2 timings of kernel #1 (:func:`kernel_calls`): kernel, plain
    version, bound; the event timer's floor (an empty kernel through
    ctypes), and the host's enqueue time per call."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    k = kernel_calls(device)
    logits, labels, flush = k["logits"], k["labels"], k["flush"]
    n = labels.numel()
    c = CLASSES

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
        print(f"kernel {name}: kernel_ms {r['ms']:.6f} plain_ms "
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
    profile_steps(engine, state, stream, dt / MEASURE_STEPS)
    return engine, state, store, launches, sps


def profile_steps(engine, state, stream, step_s, steps=3, top=15):
    """Where the step's device time goes: the ``top`` kernels by device time
    over a few steps, and the device's busy share of the wall time with the
    profiler on. ``step_s``, the wall time of a step without the profiler
    (another window), gives an estimate of the busy share without it.
    Returns the device's busy ms per step (None if none was recorded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_steps(state, [next(stream) for _ in range(steps)])
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
        engine = Engine(method_config(method))
        if engine.method.transform == "weak_strong":
            # fixmatch's own store over the same slices (freed with the
            # engine)
            t0 = time.perf_counter()
            engine.attach_store(DeviceSliceStore(
                SyntheticACDC(), engine.cfg.patch_size, mode="weak_strong"))
            print(f"weak_strong store: {tuple(engine.store.images.shape)} "
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


def drive_method(engine, state, stream, per_step, strict, card, batch):
    """One method at full width: its models' parameter counts; 5 steps
    from step 0 and 5 from step 1000 (under sync debug mode "error" if
    ``strict``), kernel #1 launched ``per_step`` times a step, forward and
    backward; finite losses; a live unsupervised term after step 1000 (the
    pseudo-supervision of cps and the CNN+ViT methods read through their
    ``_pseudo_*`` terms and recomputed here, see :func:`check_pseudo`); the
    teachers, or else every model, and the discriminators moved; then
    slices/s and peak memory over 30 steps and a short profile of the
    step. Returns the method's numbers."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    method = engine.cfg.method
    counts = {}
    for slot, model in state.models.items():
        n = sum(p.numel() for p in model.parameters())
        kind = engine.method.net_types()[slot]
        if n != MODEL_PARAMS[kind]:
            raise SystemExit(f"{method} {slot}: {n} parameters, not "
                             f"{MODEL_PARAMS[kind]} ({kind})")
        counts[slot] = n
    watched = {f"teacher {n}": m for n, m in state.teachers.items()}
    if method in PSEUDO_PAIRS or not watched:
        watched.update(state.models)
    watched.update({n: state.models[n]
                    for n in engine.method.adversarial_models})
    start_params = {n: [p.detach().clone() for p in m.parameters()]
                    for n, m in watched.items()}
    pseudo = spy_pseudo(engine.method) if method in PSEUDO_PAIRS else None

    fcd.reset_launches()
    vals = []
    for start in (0, 1000):
        state.step = start
        for _ in range(METHOD_STEPS):
            before = dict(fcd.LAUNCHES)
            if strict:
                torch.cuda.set_sync_debug_mode("error")
            try:
                state, metrics = engine.train_steps(state, [next(stream)])
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
    late = vals[METHOD_STEPS:]
    cons_key = CONSISTENCY_KEY.get(method, "consistency_loss")
    if pseudo is not None:
        calls_per_step = len(PSEUDO_PAIRS[method])
        if len(pseudo) != calls_per_step * 2 * METHOD_STEPS:
            raise SystemExit(f"{method}: {len(pseudo)} pseudo-supervision "
                             f"terms in {2 * METHOD_STEPS} steps")
        cons_key = "pseudo_supervision"
        for i, v in enumerate(late, METHOD_STEPS):
            v[cons_key] = check_pseudo(
                method, pseudo[calls_per_step * i:calls_per_step * (i + 1)],
                v)
        # the recording ends here: it would keep every step's maps alive
        # (and the method, whose bound term the spy holds)
        del engine.method.__dict__[PSEUDO_TERM[method]], pseudo
    if not all(v[cons_key] > 0.0 for v in late):
        raise SystemExit(f"{method}: {cons_key} not > 0 after step "
                         f"1000: {[v[cons_key] for v in late]}")
    for n, m in watched.items():
        if all(torch.equal(a, b) for a, b in
               zip(start_params[n], m.parameters())):
            raise SystemExit(f"{method}: {n} did not move")

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
    r = {"params": counts, "launches": launches,
         "slices_per_s": MEASURE_STEPS * batch / dt,
         "ms_per_step": dt / MEASURE_STEPS * 1e3,
         "peak_gib": peak / 2 ** 30}
    extra = (f", uncertainty mask {late[-1]['uncertainty_mask_frac']:.4f}"
             if method == "uamt" else "")
    if engine.method.adversarial_models:
        extra += (f", loss_d {late[-1]['loss_d']:.4f} dan_acc "
                  f"{late[-1]['dan_acc']:.3f}")
    extra += f"; compute dtypes {engine.model_dtypes}"
    print(f"method {method}: parameters {counts}; "
          f"{2 * METHOD_STEPS} steps, launches {launches} "
          f"({per_step} + {per_step} a step"
          f"{', under sync debug mode error' if strict else ''}); loss "
          f"{vals[0]['loss']:.4f} -> {vals[METHOD_STEPS - 1]['loss']:.4f}"
          f" (from 0), {late[0]['loss']:.4f} -> {late[-1]['loss']:.4f} "
          f"(from 1000), {cons_key} {late[-1][cons_key]:.3e}{extra}; "
          f"{r['slices_per_s']:.2f} slices/s ({r['ms_per_step']:.2f} "
          f"ms/step over {MEASURE_STEPS} steps of {batch}), peak memory "
          f"{r['peak_gib']:.3f} GiB, on {card}")
    r["busy_ms_per_step"] = profile_steps(engine, state, stream,
                                          dt / MEASURE_STEPS, top=5)
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
    # the store's first gather at a new size builds its rotation tables
    # (one host copy, cached): before the steps checked for synchronising
    # calls
    store.batch_fn(store.arrays(),
                   torch.arange(VIT_BATCH, device=store.images.device),
                   torch.Generator(device=store.images.device).manual_seed(0))
    stream = two_stream(2, VIT_BATCH, VIT_LABELED_BS).epochs()
    results = {}
    for method, per_step in VIT_METHOD_LAUNCHES.items():
        engine = Engine(vit_config(method))
        engine.attach_store(store)
        state = engine.init_state()
        results[method] = drive_method(engine, state, stream, per_step,
                                       strict, card, VIT_BATCH)
        if method == "cross_teaching":
            check_vit_eval(engine, state, store)
        del engine, state
        torch.cuda.empty_cache()
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


def run_fit(device, card):
    """Phase 7: fit, its files, the val table, resume, throughput; then
    the cps fit (:func:`run_cps_fit`)."""
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
    del engine, results, state
    run_cps_fit(card, train_ds, val_ds)
    run_fixmatch_fit(card, train_ds, val_ds)
    run_vit_fit(card, train_ds)


def run_cps_fit(card, train_ds, val_ds):
    """Phase 7b: ``fit`` of cps (two UNets, two optimizers) on the same
    data, 200 iterations with val and checkpoints every 100: the dual-model
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
    want = ["unet_best_model1.ckpt", "unet_best_model2.ckpt",
            "model_iter_100.ckpt", "model_iter_200.ckpt"]
    want += [f"model{i}_iter_{k}.ckpt" for i in (1, 2) for k in (100, 200)]
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


def run_vit_fit(card, train_ds):
    """Phase 7d: ``fit`` of cross_teaching at north-star config 4's size
    (a UNet and SwinUnet-tiny, batch 16 = 8 + 8 at 224^2) on the same
    train slices and val volumes at 224^2, 200 iterations with val and
    checkpoints every 100; model2 validated at ``patch_size2`` (224^2,
    JAX ``Engine.validate``): both slots validated each time, the
    dual-model files (``model1_``/``model2_`` prefixes, ``unet_best_model1``
    where model 1's Dice rose, no EMA files), two launches of each kernel
    an iteration, slices/s."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.engine import Engine, fit

    val_ds = blob_volumes(side=VIT_PATCH)
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


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--conv-only", action="store_true",
        help="build only csrc/conv3x3_p8.cu and run phase 6 (check, time "
        "and drive the conv kernels), then stop without the result line: "
        "the short first call after a change to the conv kernels")
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
    sources = [("conv3x3_p8", cv._library)]
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
          f"h5py installed: {importlib.util.find_spec('h5py') is not None}")

    if args.conv_only:
        wait("conv3x3_p8")
        check_conv(device)
        time_conv(device, mem_bw, tf32_rate)
        drive_conv(device)
        print("chip_smoke --conv-only: the conv kernels passed; no result "
              "line (the other phases did not run)")
        return 0

    wait("fused_ce_dice")
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

    wait("conv3x3_p8")
    conv_err = check_conv(device)
    conv_timing = time_conv(device, mem_bw, tf32_rate)
    conv_launches = drive_conv(device)
    run_fit(device, smi)

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
                "bound_by": timing[k]["bound_by"], "library_ms": None}
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
