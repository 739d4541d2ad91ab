"""Fully-supervised baseline (port of
``cvssl_tpu/train/methods/supervised.py``)."""
from __future__ import annotations

from cvssl_tpu_torch.train.methods.base import Method, register_method


@register_method("supervised")
class Supervised(Method):
    """loss = 0.5*(ce + dice) on the whole batch
    (``train_fully_supervised_2D.py:109-114``)."""

    supervised_only = True

    def loss(self, ctx, batch):
        logits = self.primary_logits(ctx.forward("model", batch["image"]))
        ce, dice = self.sup_ce_dice(logits, batch["label"])
        total = 0.5 * (ce + dice)
        return total, {"loss": total, "loss_ce": ce, "loss_dice": dice}
