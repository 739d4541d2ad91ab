"""What the program's own spans and step phases give a run's readers
(``cvssl_tpu_torch/utils/tracing.py``): the newest step's device time by
phase, and the host time of the program's spans in the traced window.
Each returns None where the program has no such module, phase or span,
and the harness then leaves the metric out of the result line."""
from __future__ import annotations

import importlib

TRACING = "cvssl_tpu_torch.utils.tracing"


def phase_ms(run, phase: str):
    """The phase's device ms in the program's newest step: in a train
    cell's traced run, the traced window's last replay."""
    if run.trace is None:
        return None
    try:
        tracing = importlib.import_module(TRACING)
    except ImportError:
        return None
    return tracing.step_ms().get(phase)


def host_span_ms(run, name: str):
    """The host ms of the program's spans ``name`` inside the traced
    window, a unit of work's share (a volume's)."""
    t = run.trace
    if t is None or not run.traced_units:
        return None
    lo, hi = t.window
    spans = [e - s for s, e, n in t.host_ops
             if n == name and s >= lo and e <= hi]
    if not spans:
        return None
    return sum(spans) * 1e-3 / run.traced_units
