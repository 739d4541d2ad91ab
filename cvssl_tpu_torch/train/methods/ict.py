"""Interpolation consistency training (port of
``cvssl_tpu/train/methods/ict.py``;
``train_interpolation_consistency_training_2D.py``)."""
from __future__ import annotations

import torch

from cvssl_tpu_torch.train.methods.base import (Method, register_method,
                                                split_batch)


@register_method("ict")
class InterpolationConsistency(Method):
    """Mix the two unlabeled halves with one Beta(alpha, alpha) factor per
    sample; the student sees [labeled, mixed]; the EMA teacher's softmaxes
    of the two halves (two separate train-mode passes, in that order) are
    mixed the same way; consistency is the MSE between the softmaxes
    (``:156-188``)."""

    teacher_names = ("model",)

    def loss(self, ctx, batch):
        cfg = self.cfg
        labeled_img, label, unlabeled_img = split_batch(cfg, batch)
        half = unlabeled_img.shape[0] // 2
        u0, u1 = unlabeled_img[:half], unlabeled_img[half:2 * half]

        mix = ctx.beta(cfg.ict_alpha,
                       (half,) + (1,) * (unlabeled_img.ndim - 1))
        mixed = u0 * (1.0 - mix) + u1 * mix

        inputs = torch.cat([labeled_img, mixed], dim=0)
        outputs = self.primary_logits(ctx.forward("model", inputs))
        outputs_soft = torch.softmax(outputs.float(), dim=1)

        ema0 = torch.softmax(self.primary_logits(
            ctx.forward_teacher("model", u0)).float(), dim=1)
        ema1 = torch.softmax(self.primary_logits(
            ctx.forward_teacher("model", u1)).float(), dim=1)
        pred_mixed = ema0 * (1.0 - mix) + ema1 * mix

        lb = cfg.labeled_bs
        ce, dice = self.sup_ce_dice(outputs[:lb], label)
        sup = 0.5 * (ce + dice)

        w = ctx.consistency_weight()
        cons = torch.mean((outputs_soft[lb:] - pred_mixed) ** 2)
        total = sup + w * cons
        return total, {"loss": total, "loss_ce": ce, "loss_dice": dice,
                       "consistency_loss": cons, "consistency_weight": w}
