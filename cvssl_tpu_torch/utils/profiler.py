"""Profiling and forward/backward timing (port of
``cvssl_tpu/utils/profiler.py``).

``trace`` and :class:`StepWindowProfiler` record a ``torch.profiler``
trace (CPU activity, and CUDA activity when a card is available) and write
it through ``tensorboard_trace_handler`` as ``*.pt.trace.json`` under the
log directory (TensorBoard's profiler plugin or ``chrome://tracing`` read
it); :func:`measure_fp_bp_time` times a model's forward and its
forward + backward (the reference's ``measure_fp_bp_time``,
``networks_other.py:203-259``).
"""
from __future__ import annotations

import contextlib
import time

import torch


def _profile(log_dir: str) -> torch.profiler.profile:
    """A profiler session, not started, that writes its trace into
    ``log_dir`` when it stops."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


@contextlib.contextmanager
def trace(log_dir: str):
    """Record everything inside the block into ``log_dir``. JAX:
    ``profiler.trace``."""
    prof = _profile(log_dir)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()


def _sync(metrics) -> None:
    """Wait for the device that holds the metrics (the first tensor of a
    dict, list or tuple), so that its queued work lands in the trace."""
    if isinstance(metrics, dict):
        metrics = list(metrics.values())
    if isinstance(metrics, (list, tuple)):
        metrics = next((m for m in metrics if isinstance(m, torch.Tensor)),
                       None)
    if isinstance(metrics, torch.Tensor) and metrics.is_cuda:
        torch.cuda.synchronize(metrics.device)


class StepWindowProfiler:
    """Trace a window of training steps into ``log_dir``, driven by the
    step loop: ``tick(it, metrics)`` starts the trace at the first ``it >=
    start`` and, at the first ``it >= stop``, waits for the metrics'
    device and stops it; once stopped, or with an empty ``log_dir``, it
    does nothing. ``close`` stops a trace still running. JAX:
    ``profiler.StepWindowProfiler``, the same window; its metrics fetch
    is a device synchronisation here."""

    def __init__(self, log_dir: str, start: int = 10, stop: int = 20):
        self.log_dir = log_dir
        self.start = start
        self.stop = stop
        self._prof = None
        self._done = False

    @property
    def active(self) -> bool:
        return self._prof is not None

    def tick(self, it: int, metrics=None) -> None:
        if self._done or not self.log_dir:
            return
        if self._prof is None and it >= self.start:
            self._prof = _profile(self.log_dir)
            self._prof.start()
        elif self._prof is not None and it >= self.stop:
            if metrics is not None:
                _sync(metrics)
            self._finish()

    def close(self) -> None:
        if self._prof is not None:
            self._finish()

    def _finish(self) -> None:
        prof, self._prof = self._prof, None
        self._done = True
        prof.stop()


def measure_fp_bp_time(model: torch.nn.Module, x: torch.Tensor,
                       steps: int = 20, warmup: int = 3):
    """(forward seconds, forward + backward seconds) per call of ``model``
    on ``x`` in eval mode; the backward is that of ``mean(logits ** 2)`` in
    float32 (the first output of a tuple), over the parameters. The device
    is synchronised before each clock read. The model's train/eval mode is
    restored after. JAX: ``profiler.measure_fp_bp_time``."""
    was_training = model.training
    model.eval()
    params = [p for p in model.parameters() if p.requires_grad]

    def fwd():
        with torch.no_grad():
            return model(x)

    def fwd_bwd():
        out = model(x)
        logits = out[0] if isinstance(out, (tuple, list)) else out
        return torch.autograd.grad(torch.mean(logits.float() ** 2), params)

    def wait():
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    def timed(fn):
        for _ in range(warmup):
            fn()
        wait()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        wait()
        return (time.perf_counter() - t0) / steps

    try:
        return timed(fwd), timed(fwd_bwd)
    finally:
        model.train(was_training)
