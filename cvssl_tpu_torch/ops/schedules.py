"""Optimizers and LR schedules (port of ``cvssl_tpu/ops/schedules.py``)."""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


def poly_lr(base_lr: float, max_iterations: int,
            power: float = 0.9) -> Callable[[int], float]:
    """lr(t) = base_lr * (1 - t / max_it)^power, in float32 like the JAX
    schedule. JAX: ``schedules.poly_lr``."""
    def schedule(step: int) -> float:
        frac = np.float32(1.0) - np.float32(step) / np.float32(max_iterations)
        return float(np.float32(base_lr)
                     * np.maximum(frac, np.float32(0.0)) ** np.float32(power))
    return schedule


def two_phase_poly_lr(base_lr: float, max_iterations: int,
                      drop_to: float = 1e-4,
                      power: float = 0.9) -> Callable[[int], float]:
    """The contrastive trainers' rule, in float32: ``poly_lr`` until half
    the iterations, then a restart from ``drop_to`` decaying at half the
    rate. JAX: ``schedules.two_phase_poly_lr``."""
    f32 = np.float32

    def schedule(step: int) -> float:
        t = f32(step)
        if t / f32(max_iterations) > f32(0.5):
            frac = f32(1.0) - (t - f32(max_iterations * 0.5)) \
                / f32(max_iterations) * f32(0.5)
            base = f32(drop_to)
        else:
            frac = f32(1.0) - t / f32(max_iterations)
            base = f32(base_lr)
        return float(base * np.maximum(frac, f32(0.0)) ** f32(power))
    return schedule


class ReferenceSGD(torch.optim.SGD):
    """SGD(momentum=0.9, weight_decay=1e-4) whose learning rate follows
    ``poly_lr`` of ``count``, the number of updates applied so far (optax's
    schedule count). JAX: ``schedules.reference_sgd``.

    Weight decay is added to the gradient before momentum, in torch's SGD as
    in the optax chain (``add_decayed_weights`` before ``trace``)."""

    def __init__(self, params: Iterable[torch.Tensor], base_lr: float,
                 max_iterations: int, momentum: float = 0.9,
                 weight_decay: float = 1e-4, power: float = 0.9):
        super().__init__(params, lr=base_lr, momentum=momentum,
                         weight_decay=weight_decay)
        self.schedule = poly_lr(base_lr, max_iterations, power)
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.schedule(self.count)
        for group in self.param_groups:
            group["lr"] = lr
        loss = super().step(closure)
        self.count += 1
        return loss


class TwoPhaseReferenceSGD(ReferenceSGD):
    """``ReferenceSGD`` on ``two_phase_poly_lr``: the contrastive methods'
    segmenter optimizer. JAX: ``schedules.two_phase_reference_sgd``."""

    def __init__(self, params: Iterable[torch.Tensor], base_lr: float,
                 max_iterations: int, momentum: float = 0.9,
                 weight_decay: float = 1e-4):
        super().__init__(params, base_lr, max_iterations, momentum,
                         weight_decay)
        self.schedule = two_phase_poly_lr(base_lr, max_iterations)


class DiscriminatorAdam(torch.optim.Adam):
    """Adam(betas=(0.9, 0.99), eps=1e-8) at a constant learning rate with no
    weight decay, for the adversarial methods' discriminator
    (``train_adversarial_network_2D.py:123``). ``count`` is the number of
    updates applied, as ``ReferenceSGD``'s. JAX:
    ``schedules.discriminator_adam`` (``optax.adam``; torch's Adam takes
    the same bias-corrected step)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-4,
                 betas=(0.9, 0.99)):
        super().__init__(params, lr=lr, betas=betas, eps=1e-8)
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        loss = super().step(closure)
        self.count += 1
        return loss
