"""Closed-loop training from the program's device store: calls of
``Engine.train_steps_scan`` with ``scan_steps`` rows of two-stream batch
indices each (``fit --scan_steps``), queued back to back with at most
``depth`` calls in flight, from step ``start_step`` on.

Set-up draws the data and the weights from the seed, builds the store
through its public constructor, loads the weights into the program's
student and teacher by name, and runs the first ``check_steps`` steps
through the same call, one row a call, reading the loss of each and the
weights after the first and the last; the reference follows those steps
after the window. A warm-up call of ``scan_steps`` rows follows, so the
window replays graphs that exist. The mix's parameters:

``scan_steps``, ``depth``, ``start_step``, ``check_steps``,
``max_steps_per_s`` (rows drawn for the window), ``trace_calls`` (calls in
the traced window), ``gather_calls`` (calls of the store's gather timed
alone).
"""
from __future__ import annotations

import collections
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import check, data, trace, yardstick
from benchmark.harness import sync
from benchmark.reference import methods

# a spin of the card (~0.8 s at H100's 1.98 GHz) that the host's launches
# of the timed calls must finish within
SPIN_CYCLES = 1_500_000_000


def train_config(config: dict, device: str):
    """The program's TrainConfig of ``config``, computing in the stated
    dtype on the card and in float32 on the CPU."""
    from cvssl_tpu_torch.train.config import TrainConfig
    return TrainConfig(
        method=config["method"], model=config["model"], dim=config["dim"],
        in_channels=config["in_channels"],
        num_classes=config["num_classes"],
        batch_size=config["batch_size"], labeled_bs=config["labeled_bs"],
        patch_size=tuple(config["patch_size"]), base_lr=config["base_lr"],
        max_iterations=config["max_iterations"],
        ema_decay=config["ema_decay"], consistency=config["consistency"],
        consistency_rampup=config["consistency_rampup"],
        uncertainty_T=config.get("uncertainty_T", 8),
        dtype=config["compute_dtype"] if device != "cpu" else "float32")


def load_weights(module: torch.nn.Module, weights: dict):
    """Copy ``weights`` into ``module``'s parameters by name; every
    parameter must have one."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise RuntimeError("the program's parameters and the reference's "
                           f"differ: {sorted(set(params) ^ set(weights))}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(weights[k])


def copy_params(module: torch.nn.Module) -> dict:
    return {k: p.detach().clone() for k, p in module.named_parameters()}


class _Slices:
    """The train slices as a dataset of host arrays for the store."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "label": self.labels[i]}


class Session:
    def __init__(self, run):
        from cvssl_tpu_torch.data.device_store import (DeviceSliceStore,
                                                       DeviceVolumeStore)
        from cvssl_tpu_torch.train.engine import Engine

        self.run = run
        cfg, tr, dev = run.config, run.traffic, run.device
        self.cfg, self.tr, self.dev = cfg, tr, dev
        self.model = methods.MODELS[cfg["model"]]
        t = run.t0
        t = run.phase("imports", t)
        engine = Engine(train_config(cfg, dev), device=dev)
        t = run.phase("engine", t)
        patch = tuple(cfg["patch_size"])
        if cfg["dim"] == 2:
            n, labeled = cfg["train_slices"], cfg["labeled_slices"]
            images, labels = data.blobs(
                n, patch, cfg["num_classes"],
                data.generator(run.seed, "slices", dev), dev)
            self.slices = _Slices(images.cpu().numpy(), labels.cpu().numpy())
            del images, labels
            t = run.phase("data", t)
            store = DeviceSliceStore(self.slices, patch, device=dev)
        else:
            n, labeled = cfg["train_volumes"], cfg["labeled_volumes"]
            shape = tuple(cfg["volume_shape"])
            if any(s <= p for s, p in zip(shape, patch)):
                raise ValueError(f"volumes {shape} must exceed the patch "
                                 f"{patch} on every axis")
            self.volumes = data.VolumeSet(n, shape, cfg["num_classes"],
                                          run.seed, dev)
            store = DeviceVolumeStore(self.volumes, patch, device=dev)
            self.volumes.forget()
        engine.attach_store(store)
        t = run.phase("store", t)
        state = engine.init_state(seed=run.seed)
        sync(dev)
        t = run.phase("init_state", t)
        self.w0, self.t0 = data.weights(self.model, cfg, run.seed, dev)
        load_weights(state.models["model"], self.w0)
        load_weights(state.teachers["model"], self.t0)
        state.step = tr["start_step"]
        t = run.phase("weights", t)
        k = tr["scan_steps"]
        rows = tr["check_steps"] + k + int(
            tr["max_steps_per_s"] * max(run.seconds, 1.0)) + \
            tr["trace_calls"] * k + 2 * k
        self.rows = data.index_rows(rows, labeled, n, cfg["batch_size"],
                                    cfg["labeled_bs"], run.seed)
        self.engine, self.state, self.store = engine, state, store
        self.at = 0
        self.readings = self._first_steps()
        t = run.phase("first_steps", t)
        self._calls(calls=1)
        sync(dev)
        run.phase("warm_up", t)
        self.attempted = self.failed = 0

    # -- set-up ------------------------------------------------------------
    def _first_steps(self):
        """The first ``check_steps`` steps through the window's call, one
        row a call; the readings the comparison takes from them."""
        n = self.tr["check_steps"]
        control = self.run.control
        if control is not None:
            out = methods.train(self.cfg, self.w0, self.t0, *self._raw(n),
                                self.run.seed, self.tr["start_step"],
                                control.get("precision", "float32"),
                                control.get("fault"))
            self.at = n
            return check.reference_readings(out, self.w0, self.t0)
        losses, cons, w1 = [], [], None
        for r in range(n):
            self.state, m = self.engine.train_steps_scan(
                self.state, self.rows[r:r + 1])
            losses.append(float(m["loss"]))
            cons.append(float(m["consistency_loss"]))
            if r == 0:
                w1 = copy_params(self.state.models["model"])
        self.at = n
        return check.train_readings(
            losses, cons, self.w0, w1,
            copy_params(self.state.models["model"]),
            self.t0, copy_params(self.state.teachers["model"]),
            methods.poly_lr(0, self.cfg))

    def _raw(self, n: int):
        """The raw inputs of the first ``n`` rows and the rows renumbered
        into them, on the device."""
        first = self.rows[:n]
        uniq = np.unique(first)
        local = torch.as_tensor(np.searchsorted(uniq, first),
                                device=self.dev)
        if self.cfg["dim"] == 2:
            raw = {"images": torch.as_tensor(self.slices.images[uniq]),
                   "labels": torch.as_tensor(self.slices.labels[uniq])}
        else:
            raw = self.volumes.gather(uniq)
            raw["extents"] = torch.tensor(
                [list(self.cfg["volume_shape"])] * len(uniq),
                dtype=torch.int64)
        raw = {k: v.to(self.dev) for k, v in raw.items()}
        raw["labels"] = raw["labels"].long()
        return raw, local

    # -- the traffic -------------------------------------------------------
    def _calls(self, calls: int = None, seconds: float = None):
        """Calls of ``scan_steps`` rows back to back, at most ``depth`` in
        flight, until ``calls`` calls or ``seconds`` have passed; returns
        the last loss of each call (device tensors)."""
        k, depth = self.tr["scan_steps"], self.tr["depth"]
        cuda = self.dev != "cpu"
        inflight, losses = collections.deque(), []
        start = time.perf_counter()
        while True:
            if calls is not None and len(losses) >= calls:
                break
            if seconds is not None and time.perf_counter() - start >= \
                    seconds:
                break
            if self.at + k > len(self.rows):
                raise RuntimeError("the drawn rows ran out: raise the mix's "
                                   "max_steps_per_s")
            with record_function("bench.call"):
                self.state, m = self.engine.train_steps_scan(
                    self.state, self.rows[self.at:self.at + k])
            self.at += k
            losses.append(m["loss"])
            if cuda:
                done = torch.cuda.Event()
                done.record()
                inflight.append(done)
                if len(inflight) > depth:
                    with record_function("bench.wait"):
                        inflight.popleft().synchronize()
        with record_function("bench.sync"):
            sync(self.dev)
        return losses

    def _count(self, losses):
        k = self.tr["scan_steps"]
        self.attempted += k * len(losses)
        if losses:
            bad = int((~torch.isfinite(torch.stack(losses))).sum())
            self.failed += k * bad

    def measure(self, seconds: float) -> dict:
        sync(self.dev)
        t0 = time.perf_counter()
        losses = self._calls(seconds=seconds)
        elapsed = time.perf_counter() - t0
        self._count(losses)
        steps = self.tr["scan_steps"] * len(losses)
        return {"seconds": elapsed, "steps": steps,
                "samples": steps * self.cfg["batch_size"]}

    def trace(self):
        calls = self.tr["trace_calls"]
        out = {}
        tr = trace.profile(lambda: out.update(
            losses=self._calls(calls=calls)))
        self._count(out["losses"])
        return tr, calls * self.tr["scan_steps"]

    def layer_timings(self):
        """``gather_ms``: the store's ``batch_fn`` alone at the cell's batch,
        on a copy of the step's generator, by CUDA events over
        ``gather_calls`` calls queued behind a spin of the card that
        outlasts their launches, so that the events time the device and not
        the host (None where the launches outlast the spin)."""
        if self.dev == "cpu":
            return
        gen = torch.Generator(device=self.dev)
        gen.set_state(self.state.generator.get_state())
        idx = torch.as_tensor(self.rows[self.at], device=self.dev)
        arrays = self.store.arrays()

        def gather():
            return self.store.batch_fn(arrays, idx, gen)
        for _ in range(3):
            gather()
        n = self.tr["gather_calls"]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spun = torch.cuda.Event(enable_timing=True)
        sync(self.dev)
        spun.record()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            gather()
        host = time.perf_counter() - t0
        end.record()
        end.synchronize()
        spin = spun.elapsed_time(start) * 1e-3
        if host < spin:
            self.run.gather_ms = start.elapsed_time(end) / n
        print(f"gather: {n} calls, host {host:.4f} s behind a spin of "
              f"{spin:.4f} s", file=sys.stderr)

    def counts(self):
        return self.attempted, self.failed

    def flops_per_unit(self) -> float:
        return methods.flop_count(self.cfg)

    def ce_dice_bytes(self):
        cfg = self.cfg
        shape = (cfg["labeled_bs"], cfg["num_classes"]) + tuple(
            cfg["patch_size"])
        logit_bytes = 2 if cfg["compute_dtype"] == "bfloat16" else 4
        return yardstick.ce_dice_bytes(shape, logit_bytes, 4)

    # -- the comparison ----------------------------------------------------
    def check(self, wanted=None) -> dict:
        """Free the program's state, then run the reference over the first
        steps in float32 (TF32 off), and in the configuration's compute
        dtype where a number ``wanted`` (all where None) reads it, and
        compare."""
        del self.engine, self.state, self.store
        if self.dev != "cpu":
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        raw, rows = self._raw(self.tr["check_steps"])

        def reference(precision):
            return check.reference_readings(methods.train(
                self.cfg, self.w0, self.t0, raw, rows, self.run.seed,
                self.tr["start_step"], precision), self.w0, self.t0)
        ref = reference("float32")
        stated = reference(self.cfg["compute_dtype"]) if \
            check.wants_stated(wanted) else None
        return check.train_numbers(self.readings, ref, stated, wanted)
