"""What the metric files under ``metrics/`` read from a run. Each returns
None where the run has nothing for it, and the harness then leaves the
metric out of the result line; a share of a peak or a roofline is never
reported as 0 for want of a reading."""
from __future__ import annotations

import statistics

from benchmark.yardstick import p95, rate


# -- end to end (the measured window, host clock) ---------------------------

def setup_s(run):
    return run.setup_s


def train_samples_per_s(run):
    w = run.window
    if w is None or run.kind != "train":
        return None
    return rate(w["samples"], w["seconds"])


def volumes_per_s(run):
    w = run.window
    if w is None or run.kind != "window":
        return None
    return rate(w["delivered"], w["seconds"])


def latency_p95_ms(run):
    w = run.window
    if w is None or run.kind != "window" or not w["latencies"]:
        return None
    return p95(w["latencies"]) * 1e3


# -- per layer (the traced window) ------------------------------------------

def idle_share(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(run):
    """The whole step's (or volume's) FLOPs, by the benchmark's count over
    its plain reference, times the units the traced window completed, over
    the window and the card's dense bf16 peak, in %."""
    t = run.trace
    if t is None or not run.flops_per_unit or not run.peak_flops:
        return None
    return 100.0 * run.flops_per_unit * run.traced_units / t.window_s \
        / run.peak_flops


def roofline(run, kernels):
    """Kernel #1's least time a step (its bytes over the card's memory
    rate, forward and backward) over the device time a step of the kernels
    named ``kernels``, in %."""
    t = run.trace
    if t is None or not run.ce_dice_bytes or not run.peak_bw:
        return None
    seconds, launches = t.kernel_seconds(kernels)
    if not launches or seconds <= 0:
        return None
    bound = sum(run.ce_dice_bytes) / run.peak_bw
    return 100.0 * bound * run.traced_units / seconds


def gather_ms(run):
    return run.gather_ms


def enqueue_ms(run):
    if not run.enqueue_s:
        return None
    return statistics.median(run.enqueue_s) * 1e3
