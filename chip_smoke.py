#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``cvssl_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card. Builds the Triton kernels from the sources in this
checkout (cache in ``build/triton``), then runs, in order; any failure ends
the run with a non-zero exit:

1. device: CUDA must be available; prints the card's name and power limit;
2. kernels against their plain version: the fused CE+Dice forward and
   backward on the card at the main-path shape (12, 4, 256, 256) and a
   ragged (3, 4, 37, 41), f32 and bf16 logits, cotangents 0.3 / 1.7, held
   against ``ce_dice_plain`` run on the card in float64; then each kernel's
   time beside its plain version's and its bound;
3. the main path at full width: mean-teacher UNet (1,813,764 parameters),
   batch 24 = 12 labeled + 12 unlabeled at 256^2, 4 classes, dtype auto
   (bf16), from a device-resident store of 1312 synthetic ACDC-shaped
   slices; 10 steps from step 0 and 10 from step 1000 with every kernel's
   launch count rising by exactly one per step; then slices/s and peak
   memory, and a short profile of where the step's device time goes;
4. eval forward: ``predict_fn`` on a batch, and the eval-mode forward in
   float32 on the card against the same model on the CPU;
5. one JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

ACDC_TRAIN_SLICES = 1312
ACDC_LABELED_SLICES = 136
BATCH, LABELED_BS, PATCH, CLASSES = 24, 12, 256, 4
MAIN_SHAPE = (LABELED_BS, CLASSES, PATCH, PATCH)
RAGGED_SHAPE = (3, CLASSES, 37, 41)
COTANGENTS = (0.3, 1.7)
FWD_REL_TOL = 1e-5
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
# near-zero gradient elements need an absolute floor: 1e-5 of the largest
GRAD_ATOL_OF_MAX = 1e-5
MEASURE_STEPS = 30

# (memory bytes/s, float32 non-tensor FLOP/s) by card; NVIDIA data sheets,
# dense rates at the full power limit
CARDS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100", 3.35e12, 67e12), ("H200", 4.8e12, 67e12))


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


def card_rates(name: str):
    for key, bw, f32 in CARDS:
        if key in name:
            return bw, f32
    raise SystemExit(f"chip_smoke: no memory/compute rates for {name!r}")


def median_ms(fn, flush, reps=50):
    """Median device time of ``fn`` over ``reps`` calls, each timed with
    CUDA events after writing ``flush`` (larger than L2), so the inputs
    come from device memory, as the main path finds them; the flush also
    keeps the card busy while the host enqueues ``fn``, so the events time
    the device work and not the host's launch latency."""
    import torch
    times = []
    for _ in range(reps + 5):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[5:]))


def check_kernels(device):
    """Phase 2: forward and backward kernels against the float64 plain
    version; returns the largest absolute errors seen."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    gen = torch.Generator(device=device).manual_seed(0)
    err = {"ce_dice_fwd": 0.0, "ce_dice_bwd": 0.0}
    f32, bf16, i32, u8 = (torch.float32, torch.bfloat16, torch.int32,
                          torch.uint8)
    cases = [(MAIN_SHAPE, f32, i32), (MAIN_SHAPE, bf16, i32)]
    cases += [(RAGGED_SHAPE, dt, lt) for dt in (f32, bf16) for lt in (i32, u8)]
    for shape, dtype, label_dtype in cases:
        logits = (2.0 * torch.randn(shape, generator=gen,
                                    device=device)).to(dtype)
        labels = torch.randint(0, CLASSES, shape[:1] + shape[2:],
                               generator=gen, device=device
                               ).to(label_dtype)
        x = logits.clone().requires_grad_(True)
        ce, dice = fcd.fused_ce_dice(x, labels, CLASSES)
        (COTANGENTS[0] * ce + COTANGENTS[1] * dice).backward()
        xd = logits.double().requires_grad_(True)
        ce_r, dice_r = fcd.ce_dice_plain(xd, labels, CLASSES)
        (COTANGENTS[0] * ce_r + COTANGENTS[1] * dice_r).backward()
        torch.cuda.synchronize()
        tag = f"{tuple(shape)} {str(dtype)[6:]} {str(label_dtype)[6:]}"
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
        print(f"kernel check {tag}: ce {float(ce.detach()):.6f} "
              f"dice {float(dice.detach()):.6f} ok")
    return err


def time_kernels(device, mem_bw, f32_rate):
    """Phase 2 timings at the main-path shape in the main path's dtype
    (bf16 logits, int32 labels): kernel, plain version, bound."""
    import torch
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    gen = torch.Generator(device=device).manual_seed(1)
    logits = torch.randn(MAIN_SHAPE, generator=gen, device=device).to(
        torch.bfloat16)
    labels = torch.randint(0, CLASSES, MAIN_SHAPE[:1] + MAIN_SHAPE[2:],
                           generator=gen, device=device, dtype=torch.int32)
    n = labels.numel()
    c = CLASSES
    # 1 GiB: far larger than L2 (50 MB), and its ~0.3 ms write outlasts the
    # host's enqueueing of any call timed here
    flush = torch.empty(2 ** 28, dtype=torch.int32, device=device)
    _, _, stats = fcd._forward_cuda(logits, labels)
    g_ce, g_dice = (torch.tensor(v, device=device) for v in COTANGENTS)

    def fwd():
        fcd._forward_cuda(logits, labels)

    def bwd():
        fcd._backward_cuda(logits, labels, stats, g_ce, g_dice)

    def plain_fwd():
        with torch.no_grad():
            fcd.ce_dice_plain(logits, labels, c)

    x = logits.clone().requires_grad_(True)
    ce, dice = fcd.ce_dice_plain(x, labels, c)
    out = COTANGENTS[0] * ce + COTANGENTS[1] * dice

    def plain_bwd():
        torch.autograd.grad(out, x, retain_graph=True)

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
    timed = {"ce_dice_fwd": (fwd, plain_fwd), "ce_dice_bwd": (bwd, plain_bwd)}
    rows = {}
    for name, (kern, plain) in timed.items():
        t_bytes = io[name] / mem_bw * 1e3
        t_ops = ops[name] / f32_rate * 1e3
        rows[name] = {
            "ms": median_ms(kern, flush),
            "plain_ms": median_ms(plain, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": io[name]}
        r = rows[name]
        print(f"kernel {name}: kernel_ms {r['ms']:.6f} plain_ms "
              f"{r['plain_ms']:.6f} bound_us {r['bound_ms'] * 1e3:.3f} "
              f"({r['bound_by']}, {r['bytes']} bytes) library_ms none")
    return rows


def run_main_path(device, card):
    """Phase 3: the mean-teacher train step at full width."""
    import torch
    from cvssl_tpu_torch.data.device_store import DeviceSliceStore
    from cvssl_tpu_torch.data.sampler import TwoStreamBatchSampler
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd
    from cvssl_tpu_torch.train.config import TrainConfig
    from cvssl_tpu_torch.train.engine import Engine

    cfg = TrainConfig(method="mean_teacher", model="unet",
                      num_classes=CLASSES, batch_size=BATCH,
                      labeled_bs=LABELED_BS, patch_size=(PATCH, PATCH),
                      labeled_slices_override=ACDC_LABELED_SLICES)
    engine = Engine(cfg)
    t0 = time.perf_counter()
    store = DeviceSliceStore(SyntheticACDC(), cfg.patch_size)
    engine.attach_store(store)
    print(f"store: {tuple(store.images.shape)} {store.images.dtype} on "
          f"{store.images.device}, built in {time.perf_counter() - t0:.1f} s")
    sampler = TwoStreamBatchSampler(
        list(range(ACDC_LABELED_SLICES)),
        list(range(ACDC_LABELED_SLICES, ACDC_TRAIN_SLICES)),
        BATCH, BATCH - LABELED_BS, rng=np.random.default_rng(0))
    stream = sampler.epochs()
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


def profile_steps(engine, state, stream, step_s, steps=3):
    """Where the step's device time goes: top kernels by device time over a
    few steps, and the device's busy share of the wall time with the
    profiler on. ``step_s``, the wall time of a step without the profiler
    (another window), gives an estimate of the busy share without it."""
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
        return
    print(f"profile: {steps} steps, wall {wall / steps * 1e3:.2f} ms/step "
          f"(profiler on), device busy {total_us / steps / 1e3:.2f} ms/step, "
          f"busy share {total_us / 1e6 / wall:.3f}; estimated busy share "
          f"without the profiler {total_us / 1e6 / steps / step_s:.3f}")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    ours = ("_fwd_partials_kernel", "_finish_kernel", "_bwd_kernel")
    for e in ranked[:15] + [e for e in ranked[15:] if e.key in ours]:
        print(f"  {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
              f"{e.count // steps:5d}x  {e.key[:90]}")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from cvssl_tpu_torch.ops import fused_ce_dice as fcd

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    mem_bw, f32_rate = card_rates(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {name}; "
          f"rates {mem_bw / 1e12} TB/s, {f32_rate / 1e12} TFLOP/s f32")

    t0 = time.perf_counter()
    err = check_kernels(device)
    print(f"kernels built and checked in {time.perf_counter() - t0:.1f} s")
    timing = time_kernels(device, mem_bw, f32_rate)
    engine, state, store, launches, _ = run_main_path(device, smi)
    check_eval(engine, state, store)

    source = "cvssl_tpu_torch/ops/fused_ce_dice.py"
    replaces = {"ce_dice_fwd": "cvssl_tpu/ops/pallas_kernels.py:65",
                "ce_dice_bwd": "cvssl_tpu/ops/pallas_kernels.py:131"}
    kernels = [{"name": k, "route": "triton", "source": source,
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": err[k], "ms": timing[k]["ms"],
                "plain_ms": timing[k]["plain_ms"],
                "bound_ms": timing[k]["bound_ms"],
                "bound_by": timing[k]["bound_by"], "library_ms": None}
               for k in fcd.LAUNCHES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
