"""Mean teacher (port of ``cvssl_tpu/train/methods/mean_teacher.py``)."""
from __future__ import annotations

import torch

from cvssl_tpu_torch.train.methods.base import (Method, mean_softmax_mse,
                                                register_method, split_batch)


@register_method("mean_teacher")
class MeanTeacher(Method):
    """Student sees the full batch; the EMA teacher sees the unlabeled half
    plus clamp(0.1*N(0,1), ±0.2) input noise (``train_mean_teacher_2D.py:
    208-216``); consistency = mean softmax-MSE, zero before iter 1000
    (``:224-228``); loss = sup + w(t)*cons (``:229``)."""

    teacher_names = ("model",)

    def graph_key(self, step):
        return (step >= 1000,)

    def loss(self, ctx, batch):
        cfg = self.cfg
        labeled_img, label, unlabeled_img = split_batch(cfg, batch)

        noise = torch.clamp(
            0.1 * ctx.normal(unlabeled_img.shape, unlabeled_img.device),
            -0.2, 0.2)
        ema_inputs = unlabeled_img + noise

        outputs = self.primary_logits(ctx.forward("model", batch["image"]))
        ema_logits = self.primary_logits(
            ctx.forward_teacher("model", ema_inputs))

        ce, dice = self.sup_ce_dice(outputs[:cfg.labeled_bs], label)
        sup = 0.5 * (ce + dice)

        # JAX computes the term and selects 0.0 before step 1000; here the
        # branch is the graph key (``graph_key``): the engine keeps a CUDA
        # graph of each side, and the dead term is not computed at all
        if ctx.step < 1000:
            cons = torch.zeros((), device=sup.device)
        else:
            cons = mean_softmax_mse(outputs[cfg.labeled_bs:], ema_logits)
        w = ctx.consistency_weight()
        total = sup + w * cons
        return total, {"loss": total, "loss_ce": ce, "loss_dice": dice,
                       "consistency_loss": cons, "consistency_weight": w}
