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
                       consistency_rampup: float = 200.0) -> float:
    """``consistency * sigmoid_rampup(step // 150, rampup)``, with the
    reference's integer-divide staircase. JAX: ``ramps.consistency_weight``
    (``ramp="sigmoid"``)."""
    return float(np.float32(consistency)
                 * np.float32(sigmoid_rampup(int(step) // 150,
                                             consistency_rampup)))


def linear_rampup(current, rampup_length) -> float:
    """Linear 0 -> 1 ramp, in float32. JAX: ``ramps.linear_rampup``."""
    if rampup_length == 0:
        return 1.0
    return float(np.clip(np.float32(current) / np.float32(rampup_length),
                         0.0, 1.0))
