"""SSL method interface (port of ``cvssl_tpu/train/methods/base.py``).

A Method is one reference ``train_*.py`` loss block: the models to build,
their optimizers, and ``loss(ctx, batch)``. Stepping, EMA and BatchNorm
state live once in the engine. Adversarial methods also name their
``adversarial_models`` and give ``loss_d``, the discriminator phase the
engine runs after the generator phase.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from cvssl_tpu_torch.models import net_factory, net_factory_3d
from cvssl_tpu_torch.ops import losses, ramps, schedules

_REGISTRY: Dict[str, type] = {}


def register_method(name: str):
    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def available_methods():
    from cvssl_tpu_torch.train import methods  # noqa: F401 (registers)
    return sorted(_REGISTRY)


def get_method(name: str, cfg):
    if name not in _REGISTRY:
        from cvssl_tpu_torch.train import methods  # noqa: F401 (registers)
        if name not in _REGISTRY:
            raise ValueError(
                f"unknown method {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg)


class Method:
    """Base: single supervised model, no teacher, no extra state."""

    name = "base"
    model_names: Tuple[str, ...] = ("model",)
    teacher_names: Tuple[str, ...] = ()      # models that get an EMA teacher
    # models frozen in ``loss`` and trained by ``loss_d`` (discriminators)
    adversarial_models: Tuple[str, ...] = ()
    # destination -> source: after the optimizer step, the destination's
    # parameters become the EMA of the source's (JAX ``engine.py:240-246``)
    param_ema_map: Dict[str, str] = {}
    # augmentation: a store mode, or "cta" (CTAugment on the host, with
    # the method's hooks ``create_transform``, ``on_epoch_start``,
    # ``on_batch``, ``on_step_metrics``, ``on_epoch_end``)
    transform: str = "default"
    supervised_only: bool = False            # labeled-only dataset, no 2-stream

    def __init__(self, cfg):
        self.cfg = cfg

    # -- construction -----------------------------------------------------
    def _factory(self, net_type: str) -> nn.Module:
        """``net_type`` from the 2D registry, or the 3D one at ``dim=3``
        (JAX ``base.py:58-64``)."""
        factory = net_factory_3d if self.cfg.dim == 3 else net_factory
        return factory(net_type, self.cfg.in_channels, self.cfg.num_classes,
                       **self.cfg.model_kwargs(net_type))

    def net_types(self) -> Dict[str, str]:
        """The registered net type of each model slot; it also decides the
        slot's compute dtype (``TrainConfig.model_dtype``)."""
        return {"model": self.cfg.model}

    def build_models(self) -> Dict[str, nn.Module]:
        return {n: self._factory(t) for n, t in self.net_types().items()}

    def optimizers(self, models: Dict[str, nn.Module]
                   ) -> Dict[str, torch.optim.Optimizer]:
        return {name: schedules.ReferenceSGD(models[name].parameters(),
                                             self.cfg.base_lr,
                                             self.cfg.max_iterations)
                for name in self.model_names}

    def init_extra(self):
        return ()

    def eval_model_names(self) -> Tuple[str, ...]:
        """Models validated (and best-checkpointed) by ``fit``."""
        return self.model_names

    # -- the step's host values -------------------------------------------
    def step_scalars(self, step: int) -> Dict[str, np.float32]:
        """The float32 values the loss of step ``step`` reads, computed on
        the host by the numpy ramps; the step reads them as 0-d float32
        tensors on the device (``StepCtx.scalar``), so that a CUDA graph
        of the step reads each replay's values from the card. Default: the
        sigmoid-ramped consistency weight (``StepCtx.consistency_weight``).
        """
        return {"consistency_weight": np.float32(ramps.consistency_weight(
            step, self.cfg.consistency, self.cfg.consistency_rampup))}

    def graph_key(self, step: int) -> tuple:
        """What the step's Python code branches on at ``step``: the engine
        keeps one CUDA graph of the step per key. Default: no branch."""
        return ()

    # -- the strategy -----------------------------------------------------
    def loss(self, ctx, batch):
        """Return (total_loss, metrics_dict). Override per strategy."""
        raise NotImplementedError

    def loss_d(self, ctx, batch):
        """The discriminator phase of an adversarial method: (loss,
        metrics), differentiated w.r.t. ``adversarial_models`` only."""
        raise NotImplementedError

    def primary_logits(self, out):
        """The main logit map of a model output (DS variants return
        tuples)."""
        return out[0] if isinstance(out, (tuple, list)) else out

    def sup_ce_dice(self, logits, label):
        """(ce, dice) supervised pair, every method's labeled-loss
        ingredients, from the fused CE+Dice kernel, which casts the logits
        to float32 in registers."""
        return losses.ce_dice(logits, label, self.cfg.num_classes)


def split_batch(cfg, batch):
    """(labeled image, label, unlabeled image): the first ``labeled_bs``
    items are labeled (``train_mean_teacher_2D.py:204-210``)."""
    image = batch["image"]
    label = batch["label"]
    lb = cfg.labeled_bs
    return image[:lb], label[:lb], image[lb:]


def mean_softmax_mse(student_logits, teacher_logits):
    return torch.mean(losses.softmax_mse_loss(student_logits, teacher_logits))
