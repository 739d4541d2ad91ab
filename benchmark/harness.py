"""One run of one cell: set-up, the measured window (``--trace 0``) or the
traced window (``--trace 1``), the per-layer timings, the comparison with
the plain reference, and the result line.

The traffic mix names its generator (``generators/<name>.py``), whose
``Session`` does the cell's work: ``Session(run)`` is the set-up (data and
weights from the seed, the program's state, the first steps or answers the
comparison reads, every shape warmed up); ``measure(seconds)`` the window;
``trace()`` the traced window; ``layer_timings()``, before it, what a
layer's metric times on its own; ``check(wanted)`` frees the program's
state and returns the numbers named in ``wanted`` (all where None).
"""
from __future__ import annotations

import copy
import importlib
import sys
import time

from benchmark import check, spec, yardstick


class Run:
    """What a run knows; the metric readers (``readers.py``) read it."""

    def __init__(self, cell: dict, seed: int, seconds: float, device: str,
                 control=None, t0: float = None):
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        # None: the program answers; {"precision": ..., "fault": ...}: the
        # plain reference answers in its place (the control, a fault)
        self.control = control
        self.t0 = time.perf_counter() if t0 is None else t0
        self.kind = self.traffic["kind"]
        self.setup_s = None
        self.setup_phases = {}
        self.window = None
        self.trace = None
        self.traced_units = 0
        self.flops_per_unit = None
        self.peak_flops = self.peak_bw = None
        self.ce_dice_bytes = None
        self.gather_ms = None
        self.enqueue_s = None

    def phase(self, name: str, since: float) -> float:
        now = time.perf_counter()
        self.setup_phases[name] = now - since
        return now


def apply_overrides(cell: dict, overrides: dict) -> dict:
    """A copy of ``cell`` with {"config": {...}, "traffic": {...}} keys
    replaced (the tests' small sizes)."""
    cell = copy.deepcopy(cell)
    for part, values in (overrides or {}).items():
        cell[part].update(values)
    return cell


def sync(device: str):
    if device != "cpu":
        import torch
        torch.cuda.synchronize()


def execute(name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", control=None, overrides=None,
            t0: float = None, log=None, every_number: bool = False):
    """Run cell ``name`` once; returns (result, checks, numbers): the
    result line's content, the numbers compared with their limits, and
    the numbers read: those the cell's limits name, or with
    ``every_number`` all its comparison has (``calibrate.py``). ``log``
    takes the run's notes (default: standard error)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = apply_overrides(spec.cell(name), overrides)
    run = Run(cell, seed, seconds, device, control, t0)
    generator = importlib.import_module(
        f"benchmark.generators.{run.traffic['generator']}")
    import torch

    session = generator.Session(run)
    sync(device)
    run.setup_s = time.perf_counter() - run.t0
    if trace:
        # before the profiler, whose hooks slow later launches on the host
        session.layer_timings()
        run.trace, run.traced_units = session.trace()
    else:
        run.window = session.measure(seconds)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    if device != "cpu":
        card = torch.cuda.get_device_name(0)
        run.peak_flops, run.peak_bw = yardstick.peaks(card) or (None, None)
    else:
        card = "cpu"
    if trace:
        run.flops_per_unit = session.flops_per_unit()
        run.ce_dice_bytes = session.ce_dice_bytes()
    log("setup phases (s): " + " ".join(
        f"{k} {v:.3f}" for k, v in run.setup_phases.items()))
    metrics = {}
    entries = cell["per_layer"] if trace else cell["end_to_end"]
    for entry in entries:
        value = spec.reader(entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    attempted, failed = session.counts()
    limits = cell["limits"]["limits"]
    numbers = session.check(None if every_number else set(limits))
    correct, checks = check.judge(numbers, limits)
    result = {"correct": correct and failed == 0, "attempted": attempted,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device != "cpu" else "cpu",
                         "kind": card, "count": cell["chips"],
                         "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    # last on the line: each number compared with its limit
    result["checks"] = checks
    return result, checks, numbers
