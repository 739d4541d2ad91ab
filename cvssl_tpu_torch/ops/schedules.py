"""Optimizers and LR schedules (port of ``cvssl_tpu/ops/schedules.py``)."""
from __future__ import annotations

from typing import Callable, Iterable, Optional

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


def two_phase_lr(base_lr: float, max_iterations: int,
                 drop_to: float = 1e-4) -> Callable[[int], float]:
    """``base_lr`` until half the iterations, then ``drop_to``, in float32.
    JAX: ``schedules.two_phase_lr``."""
    def schedule(step: int) -> float:
        return float(np.float32(base_lr if step < max_iterations // 2
                                else drop_to))
    return schedule


class ReferenceSGD(torch.optim.SGD):
    """SGD(momentum=0.9, weight_decay=1e-4) whose learning rate follows
    ``poly_lr`` of ``count``, the number of updates applied so far (optax's
    schedule count). JAX: ``schedules.reference_sgd``.

    Weight decay is added to the gradient before momentum, in torch's SGD as
    in the optax chain (``add_decayed_weights`` before ``trace``). The
    update is ``p - lr * buf`` with ``lr`` a 0-d float32 tensor on the
    parameters' device, two roundings as optax's ``scale`` then
    ``apply_updates`` (torch's SGD, which takes ``alpha=-lr`` and so reads a
    tensor ``lr`` on the host, does the same under ``torch.compile``): the
    engine's step passes the row of its step table, so that a captured
    CUDA graph reads each replay's rate from the card. ``count`` stays a
    host integer, advanced by each :meth:`step`; ``param_groups``' "lr"
    keeps the base rate and is not read."""

    def __init__(self, params: Iterable[torch.Tensor], base_lr: float,
                 max_iterations: int, momentum: float = 0.9,
                 weight_decay: float = 1e-4, power: float = 0.9):
        super().__init__(params, lr=base_lr, momentum=momentum,
                         weight_decay=weight_decay)
        self.schedule = poly_lr(base_lr, max_iterations, power)
        self.count = 0

    def lr_at(self, count: int) -> float:
        """The learning rate of the update after ``count`` updates."""
        return self.schedule(count)

    @torch.no_grad()
    def step(self, closure=None, lr: Optional[torch.Tensor] = None):
        """One update at ``lr`` (a 0-d float32 tensor on the parameters'
        device; None: :meth:`lr_at` of ``count``, written there from the
        host). The first update makes the momentum buffers, as torch's SGD
        does, so a CUDA graph of the step is captured after one."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            if lr is None:
                lr = torch.full((), self.lr_at(self.count),
                                dtype=torch.float32, device=params[0].device)
            grads = torch._foreach_add([p.grad for p in params], params,
                                       alpha=group["weight_decay"])
            bufs = [self.state[p].get("momentum_buffer") for p in params]
            if any(b is None for b in bufs):
                bufs = [g.detach().clone() for g in grads]
                for p, b in zip(params, bufs):
                    self.state[p]["momentum_buffer"] = b
            else:
                torch._foreach_mul_(bufs, group["momentum"])
                torch._foreach_add_(bufs, grads)
            torch._foreach_sub_(params, torch._foreach_mul(bufs, lr))
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
    the same bias-corrected step).

    On the card it is ``capturable``: its step count lives there and the
    bias corrections are computed there in float32, as optax computes them
    (on the CPU torch computes them in float64 on the host), so that a CUDA
    graph of the step can hold it. The rate is constant, so :meth:`step`
    takes no ``lr``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-4,
                 betas=(0.9, 0.99)):
        params = list(params)
        super().__init__(params, lr=lr, betas=betas, eps=1e-8,
                         capturable=any(p.is_cuda for p in params))
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None, lr: Optional[torch.Tensor] = None):
        if lr is not None:
            raise ValueError("DiscriminatorAdam: the rate is constant")
        loss = super().step(closure)
        self.count += 1
        return loss


# ---------------------------------------------------------------------------
# The reference's ``networks_other.py::get_scheduler`` family (:95-139),
# which no trainer calls: epoch -> lr functions in float32, as JAX's
# ---------------------------------------------------------------------------

def lambda_linear_lr(base_lr: float, niter: int, niter_decay: int,
                     epoch_count: int = 1) -> Callable[[int], float]:
    """'lambda': flat for ``niter`` epochs, then linear to 0 over
    ``niter_decay``. JAX: ``schedules.lambda_linear_lr``."""
    f32 = np.float32

    def schedule(epoch: int) -> float:
        e = f32(epoch)
        frac = f32(1.0) - np.maximum(
            f32(0.0), e + f32(1 + epoch_count - niter)) \
            / f32(niter_decay + 1)
        return float(f32(base_lr) * frac)
    return schedule


def step_lr(base_lr: float, step_size: int,
            gamma: float = 0.5) -> Callable[[int], float]:
    """'step' (gamma 0.5) and 'step2' (gamma 0.1): ``base_lr * gamma **
    (epoch // step_size)``. JAX: ``schedules.step_lr``."""
    def schedule(epoch: int) -> float:
        return float(np.float32(base_lr) * np.float32(gamma)
                     ** np.float32(int(epoch) // step_size))
    return schedule


def step_warmstart_lr(base_lr: float,
                      variant: int = 1) -> Callable[[int], float]:
    """'step_warmstart' (variant 1: drops at epochs 100 and 200) and
    'step_warmstart2' (variant 2: at 50 and 100): x0.1 for the first 5
    epochs, then x1, x0.1 and x0.01. JAX: ``schedules.step_warmstart_lr``.
    """
    hi = (100, 200) if variant == 1 else (50, 100)

    def schedule(epoch: int) -> float:
        scale = 0.1 if epoch < 5 else 1.0 if epoch < hi[0] else \
            0.1 if epoch < hi[1] else 0.01
        return float(np.float32(base_lr) * np.float32(scale))
    return schedule


class ReduceLROnPlateau:
    """'plateau': a host controller that scales the LR by ``factor`` once
    the monitored value has not improved by ``threshold`` (relative) for
    more than ``patience`` evaluations. Call ``update(metric)`` after each
    evaluation and multiply the base schedule by ``scale``. JAX:
    ``schedules.ReduceLROnPlateau``."""

    def __init__(self, factor: float = 0.1, patience: int = 5,
                 threshold: float = 0.01, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r}: 'min' or 'max'")
        self.factor, self.patience, self.threshold = (factor, patience,
                                                      threshold)
        self.mode = mode
        self.best = None
        self.bad_epochs = 0
        self.scale = 1.0

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def update(self, metric: float) -> float:
        if self._improved(metric):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale
