"""The training engine (port of ``cvssl_tpu/train/engine.py``: state
construction, the step body, the device-store path, a K-step loop standing
in for ``train_steps_scan``, and the eval-mode predictor).

One step: zero the gradients, run the method's loss through a ``StepCtx``
(student and teacher forwards in train mode, under bfloat16 autocast when
the compute dtype is bfloat16), backward, SGD with the poly LR of the
optimizer's own update count, then the EMA of the teacher's parameters
with the decay of the step before its increment (``engine.py:236``).

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``; on a
machine without CUDA, ``Engine(cfg)`` raises.

Numerics on the card: float32 matmuls and convolutions run in full float32
(TF32 off for both cuBLAS and cuDNN, set explicitly, since cuDNN's default is
TF32); under ``dtype="auto"`` the convolutions run in bfloat16 through
autocast, with float32 parameters, BatchNorm statistics and losses.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from cvssl_tpu_torch.ops.ema import ema_decay_schedule, ema_update
from cvssl_tpu_torch.train.config import TrainConfig
from cvssl_tpu_torch.train.methods.base import Method, get_method
from cvssl_tpu_torch.train.state import StepCtx, TrainState


class Engine:
    def __init__(self, cfg: TrainConfig, method: Optional[Method] = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Engine: no CUDA device; pass "
                                   "device='cpu' to run on the CPU")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.method = method or get_method(cfg.method, cfg)
        self.compute_dtype = cfg.compute_dtype(self.device)
        self.store = None  # optional device-resident data store

    # ------------------------------------------------------------------
    # state construction
    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Models with random weights from ``seed`` (default ``cfg.seed``),
        their teachers as copies, optimizers, and the step's generator."""
        seed = self.cfg.seed if seed is None else seed
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            models = self.method.build_models()
        models = {n: m.to(self.device).train() for n, m in models.items()}
        teachers = {}
        for name in self.method.teacher_names:
            teachers[name] = copy.deepcopy(models[name]).requires_grad_(False)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        return TrainState(step=0, models=models,
                          optimizers=self.method.optimizers(models),
                          teachers=teachers, generator=generator,
                          extra=self.method.init_extra())

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, batch: dict):
        """One step on a batch already on the device: {"image": (B, 1, H, W)
        float32, "label": (B, H, W) int}. Updates ``state`` in place and
        returns (state, metrics); metrics are device tensors (no sync)."""
        for opt in state.optimizers.values():
            opt.zero_grad(set_to_none=True)
        ctx = StepCtx(self.cfg, state.models, state.teachers,
                      state.generator, state.step, self.compute_dtype)
        loss, metrics = self.method.loss(ctx, batch)
        loss.backward()
        for opt in state.optimizers.values():
            opt.step()
        decay = ema_decay_schedule(state.step, self.cfg.ema_decay)
        for name in self.method.teacher_names:
            ema_update(state.teachers[name].parameters(),
                       state.models[name].parameters(), decay)
        state.step += 1
        return state, {k: v.detach() if torch.is_tensor(v) else v
                       for k, v in metrics.items()}

    # -- device-store path: only indices cross the host boundary ----------
    def attach_store(self, store):
        self.store = store

    def _indices(self, indices: Sequence[int]) -> torch.Tensor:
        idx = torch.from_numpy(np.asarray(indices, np.int64))
        if self.device.type == "cuda":
            # pinned + non_blocking: the host does not wait for the card
            return idx.pin_memory().to(self.device, non_blocking=True)
        return idx

    def train_step_indices(self, state: TrainState, indices):
        """One step from the attached store: gather + augmentation on the
        device, then the step body."""
        if self.store is None:
            raise RuntimeError("attach_store() first")
        batch = self.store.batch_fn(self.store.arrays(),
                                    self._indices(indices), state.generator)
        return self.train_step(state, batch)

    def train_steps(self, state: TrainState, indices_matrix):
        """K steps, one per row of ``indices_matrix`` (K, B); returns
        (state, last step's metrics). Stands in for JAX's
        ``train_steps_scan``."""
        metrics = None
        for indices in indices_matrix:
            state, metrics = self.train_step_indices(state, indices)
        return state, metrics

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def predict_fn(self, name: str, state: TrainState,
                   teacher: bool = False):
        """Batched argmax predictor: x (B, C_in, H, W) -> uint8 (B, H, W),
        eval-mode forward (running BatchNorm statistics, no dropout)."""
        model = (state.teachers if teacher else state.models)[name]
        ctx = StepCtx(self.cfg, {name: model}, {}, None, state.step,
                      self.compute_dtype)

        def predict(x: torch.Tensor) -> torch.Tensor:
            model.eval()
            try:
                with torch.no_grad():
                    out = self.method.primary_logits(
                        ctx.forward(name, x.to(self.device)))
            finally:
                model.train()
            return out.float().argmax(dim=1).to(torch.uint8)
        return predict
