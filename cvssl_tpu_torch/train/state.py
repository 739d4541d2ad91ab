"""Train state + per-step forward context (port of
``cvssl_tpu/train/state.py``).

JAX threads an immutable pytree through a jitted step; here the state holds
the live modules and optimizers, which the engine's step updates in place
(and returns, so callers read ``state, metrics = engine.train_step(...)`` as
in JAX).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from cvssl_tpu_torch.parallel.mesh import Mesh, split_call
from cvssl_tpu_torch.utils import tracing


@dataclasses.dataclass
class TrainState:
    step: int                                   # global iteration
    models: Dict[str, nn.Module]                # students, train mode
    optimizers: Dict[str, torch.optim.Optimizer]
    teachers: Dict[str, nn.Module]              # EMA teachers, train mode
    generator: torch.Generator                  # dropout/noise/augmentation
    extra: Any = ()                             # method-specific state


class StepCtx:
    """Forward helper for one step.

    Student and teacher forwards both run in train mode unless asked
    otherwise: BatchNorm normalises with batch statistics and the running
    buffers of both update (torch buffers self-update during the teacher's
    train-mode forward, reference ``train_mean_teacher_2D.py:214``). Dropout
    bytes and method noise come from the state's generator. Each model
    computes in its own dtype (``dtypes``, by model name, float32 where
    absent): bfloat16 runs under autocast, as ``TrainConfig.model_dtype``
    gives it.

    With a ``mesh`` of several ranks every model call is split
    (``parallel/mesh.py::split_call``): the model runs on the rank's rows of
    the call's batch and the outputs come back gathered, so the methods'
    loss code sees the global tensors; a batch the world size does not
    divide runs whole.

    ``scalars`` are the step's host values (``Method.step_scalars``, the
    EMA decay, the learning rates) as 0-d float32 tensors on the device,
    by name; the loss reads them through :meth:`scalar`. ``step`` is the
    host integer, which the loss reads only where it branches, and each
    such branch is part of the method's ``graph_key``."""

    def __init__(self, cfg, models: Dict[str, nn.Module],
                 teachers: Dict[str, nn.Module],
                 generator: Optional[torch.Generator], step: int,
                 dtypes: Optional[Dict[str, torch.dtype]] = None,
                 mesh: Optional[Mesh] = None,
                 scalars: Optional[Dict[str, torch.Tensor]] = None):
        self.cfg = cfg
        self.models = models
        self.teachers = teachers
        self.generator = generator
        self.step = step
        self.dtypes = dtypes or {}
        self.mesh = mesh
        self.scalars = scalars or {}

    def _call(self, model: nn.Module, x: torch.Tensor, *args, **kwargs):
        if self.mesh is None:
            return model(x, *args, **kwargs)
        return split_call(self.mesh, model, x, *args, **kwargs)

    def _autocast(self, name: str, x: torch.Tensor):
        dtype = self.dtypes.get(name, torch.float32)
        if dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(x.device.type, dtype=dtype)

    def forward(self, name: str, x: torch.Tensor, train: bool = True,
                extra_args=()):
        """Student forward (autograd on). ``train=False`` runs the module in
        eval mode (running BatchNorm statistics, no dropout, no buffer
        update) and puts it back in the mode it was in. ``extra_args`` go
        after ``x`` (the discriminator's image). JAX:
        ``StepCtx.forward``."""
        model = self.models[name]
        if train:
            with self._autocast(name, x):
                return self._call(model, x, *extra_args,
                                  generator=self.generator)
        was_training = model.training
        model.eval()
        try:
            with self._autocast(name, x):
                return self._call(model, x, *extra_args)
        finally:
            model.train(was_training)

    def forward_teacher(self, name: str, x: torch.Tensor):
        """EMA-teacher forward under no_grad, in train mode like the
        reference; step phase ``teacher``."""
        model = self.teachers[name]
        with tracing.phase("teacher"), torch.no_grad(), \
                self._autocast(name, x):
            return self._call(model, x, self.generator)

    def forward_teacher_scan(self, name: str, x_groups: torch.Tensor):
        """Sequential teacher forwards under no_grad, one per group of
        ``x_groups`` (n_groups, group_batch, C, H, W): the reference's
        Monte-Carlo loop of separate passes
        (``train_uncertainty_aware_mean_teacher_2D.py:163-172``). BatchNorm
        normalises with each pass's own batch statistics and the running
        buffers update pass after pass; each pass draws its own dropout
        bytes. Returns the logits stacked on a leading group axis; with a
        mesh each group's batch is split. JAX:
        ``StepCtx.forward_teacher_scan`` (a ``lax.scan``). Step phase
        ``teacher``."""
        model = self.teachers[name]
        with tracing.phase("teacher"), torch.no_grad(), \
                self._autocast(name, x_groups):
            return torch.stack([self._call(model, xg, self.generator)
                                for xg in x_groups])

    # -- draws, all from the step's generator (a resume restores it) --------
    def normal(self, shape, device) -> torch.Tensor:
        """Standard normal draws from the step's generator."""
        return torch.randn(shape, generator=self.generator, device=device)

    def randint(self, high: int) -> torch.Tensor:
        """One integer in [0, high), as an int64 tensor on the generator's
        device (no host round trip)."""
        g = self.generator
        return torch.randint(0, high, (), generator=g, device=g.device)

    def beta(self, alpha: float, shape) -> torch.Tensor:
        """Beta(alpha, alpha) float32 draws as G1 / (G1 + G2) of two
        Gamma(alpha) draws (``torch.distributions.Beta`` would draw from the
        global generator). The gammas are drawn in float64, so that small
        alphas (ICT's 0.2) do not underflow both to 0."""
        g = self.generator
        a = torch.full((2,) + tuple(shape), float(alpha), dtype=torch.float64,
                       device=g.device)
        g1, g2 = torch._standard_gamma(a, generator=g)
        return (g1 / (g1 + g2)).float()

    def scalar(self, name: str) -> torch.Tensor:
        """The step's host value ``name``, a 0-d float32 tensor."""
        return self.scalars[name]

    def consistency_weight(self) -> torch.Tensor:
        return self.scalar("consistency_weight")
