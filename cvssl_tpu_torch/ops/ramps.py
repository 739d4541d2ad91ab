"""Consistency-weight ramps (port of ``cvssl_tpu/ops/ramps.py``).

The step is a host integer in the port, so these are host functions of
Python numbers, evaluated in float32 like the JAX versions.
"""
from __future__ import annotations

import numpy as np


def sigmoid_rampup(current, rampup_length) -> float:
    """exp(-5 * (1 - t)^2) ramp. JAX: ``ramps.sigmoid_rampup``."""
    if rampup_length == 0:
        return 1.0
    current = np.clip(np.float32(current), 0.0, rampup_length)
    phase = np.float32(1.0) - current / np.float32(rampup_length)
    return float(np.exp(np.float32(-5.0) * phase * phase))


def consistency_weight(step: int, consistency: float = 0.1,
                       consistency_rampup: float = 200.0,
                       ramp: str = "sigmoid") -> float:
    """``consistency * ramp(step // 150, rampup)``, with the reference's
    integer-divide staircase; ``ramp`` is "sigmoid"
    (:func:`sigmoid_rampup`), "linear" (:func:`linear_rampup`) or
    "temporal" (:func:`ramp_up_function` at ``int(rampup)``). JAX:
    ``ramps.consistency_weight``."""
    t = int(step) // 150
    if ramp == "sigmoid":
        r = sigmoid_rampup(t, consistency_rampup)
    elif ramp == "linear":
        r = linear_rampup(t, consistency_rampup)
    elif ramp == "temporal":
        r = ramp_up_function(t, int(consistency_rampup))
    else:
        raise ValueError(f"unknown ramp {ramp!r}")
    return float(np.float32(consistency) * np.float32(r))


def linear_rampup(current, rampup_length) -> float:
    """Linear 0 -> 1 ramp, in float32. JAX: ``ramps.linear_rampup``."""
    if rampup_length == 0:
        return 1.0
    return float(np.clip(np.float32(current) / np.float32(rampup_length),
                         0.0, 1.0))


def ramp_up_function(epoch, epoch_with_max_rampup: int = 80) -> float:
    """The temporal-ensembling ramp exp(-5 (1 - e / max)^2), in float32,
    switching to 1 exactly at ``epoch_with_max_rampup``. A host function of
    the epoch index, so a step that uses it makes no device
    synchronisation. JAX: ``ramps.ramp_up_function``."""
    epoch = np.float32(epoch)
    if epoch >= epoch_with_max_rampup:
        return 1.0
    p = np.float32(1.0) - (np.maximum(np.float32(0.0), epoch)
                           / np.float32(epoch_with_max_rampup))
    return float(np.exp(np.float32(-5.0) * p * p))


def cosine_rampdown(current, rampdown_length) -> float:
    """Cosine 1 -> 0 rampdown 0.5 (cos(pi t / length) + 1), in float32.
    JAX: ``ramps.cosine_rampdown``."""
    f32 = np.float32
    return float(f32(0.5) * (np.cos(f32(np.pi) * f32(current)
                                    / f32(rampdown_length)) + f32(1.0)))
