"""Uncertainty-aware mean teacher, 2D and 3D (port of
``cvssl_tpu/train/methods/uamt.py``;
``train_uncertainty_aware_mean_teacher_2D.py`` / ``_3D.py``)."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cvssl_tpu_torch.ops import losses, ramps
from cvssl_tpu_torch.train.methods.base import (Method, register_method,
                                                split_batch)


@register_method("uamt")
class UncertaintyAwareMeanTeacher(Method):
    """Mean teacher whose consistency counts only the sites where the
    teacher is sure: the entropy of the mean softmax of T noisy teacher
    passes (``:160-176``) below a threshold that ramps on the raw step,
    (0.75 + 0.25 * sigmoid_rampup(step, max_iterations)) * ln 2
    (``:187-189``).

    The MC passes branch as JAX's do, on whether the teacher holds batch
    statistics (:func:`has_batch_stats`). A BatchNorm teacher (the UNet)
    with even T runs the reference's T // 2 sequential passes over the
    twice-repeated unlabeled batch (``StepCtx.forward_teacher_scan``), after
    the consistency-target pass; the order fixes the teacher's running
    statistics. A stats-free teacher (SwinUnet's LayerNorm), or odd T, runs
    one pass over the T-tiled batch: no sample is coupled to another, so
    this is the reference's passes in one batch, and SwinUnet's stochastic
    depth draws one mask over the T * u samples, as JAX's. A stats-free 3D
    teacher (UNet3D's InstanceNorm) also takes the consistency-target
    batch into that pass: ONE forward over the (T + 1) * u batch
    [ema_inputs, tiled + noise] (JAX ``uamt.py:46-53``), so its dropout
    bytes are one draw over the (T + 1) * u volumes, as JAX's."""

    teacher_names = ("model",)

    def loss(self, ctx, batch):
        cfg = self.cfg
        T = cfg.uncertainty_T
        lb = cfg.labeled_bs
        _, label, unlabeled_img = split_batch(cfg, batch)
        u = unlabeled_img.shape[0]
        dev = unlabeled_img.device

        noise = torch.clamp(0.1 * ctx.normal(unlabeled_img.shape, dev),
                            -0.2, 0.2)
        ema_inputs = unlabeled_img + noise

        outputs = self.primary_logits(ctx.forward("model", batch["image"]))

        tiled = unlabeled_img.repeat((T,) + (1,) * (unlabeled_img.ndim - 1))
        mc_noise = torch.clamp(0.1 * ctx.normal(tiled.shape, dev), -0.2, 0.2)
        has_bn = has_batch_stats(ctx.teachers["model"])
        if cfg.dim == 3 and not has_bn:
            all_logits = self.primary_logits(ctx.forward_teacher(
                "model", torch.cat([ema_inputs, tiled + mc_noise])))
            ema_logits, mc_logits = all_logits[:u], all_logits[u:]
        elif has_bn and T % 2 == 0:
            ema_logits = self.primary_logits(
                ctx.forward_teacher("model", ema_inputs))
            groups = (tiled + mc_noise).reshape((T // 2, 2 * u)
                                                + tiled.shape[1:])
            mc = self.primary_logits(
                ctx.forward_teacher_scan("model", groups))
            mc_logits = mc.reshape((T * u,) + mc.shape[2:])
        else:
            ema_logits = self.primary_logits(
                ctx.forward_teacher("model", ema_inputs))
            mc_logits = self.primary_logits(
                ctx.forward_teacher("model", tiled + mc_noise))
        preds = torch.softmax(mc_logits.float(), dim=1)
        preds = preds.reshape((T, u) + preds.shape[1:]).mean(dim=0)
        uncertainty = -torch.sum(preds * torch.log(preds + 1e-6), dim=1,
                                 keepdim=True)

        ce, dice = self.sup_ce_dice(outputs[:lb], label)
        sup = 0.5 * (ce + dice)

        w = ctx.consistency_weight()
        dist = losses.softmax_mse_loss(outputs[lb:], ema_logits)
        mask = (uncertainty < ctx.scalar("threshold")).float()
        cons = torch.sum(mask * dist) / (2 * torch.sum(mask) + 1e-16)

        total = sup + w * cons
        return total, {"loss": total, "loss_ce": ce, "loss_dice": dice,
                       "consistency_loss": cons, "consistency_weight": w,
                       "uncertainty_mask_frac": torch.mean(mask)}

    def step_scalars(self, step):
        return {**super().step_scalars(step),
                "threshold": np.float32(self.threshold(step))}

    def threshold(self, step: int) -> float:
        """The entropy threshold at ``step``, in float32 as in JAX."""
        ramp = np.float32(ramps.sigmoid_rampup(step, self.cfg.max_iterations))
        return float((np.float32(0.75) + np.float32(0.25) * ramp)
                     * np.float32(np.log(2.0)))


def has_batch_stats(model: nn.Module) -> bool:
    """Whether ``model`` normalises with batch statistics, i.e. holds a
    BatchNorm with running buffers: the port's counterpart of JAX's
    ``bool(ctx.teacher_stats.get("model"))``."""
    return any(isinstance(m, nn.modules.batchnorm._BatchNorm)
               and m.track_running_stats for m in model.modules())
