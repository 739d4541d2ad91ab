"""Deep co-training by rotation consistency (port of
``cvssl_tpu/train/methods/co_training.py``; ``train_deep_co_training_2D.py``):
one model, a rot90(k) view of the unlabeled batch, symmetric detached MSE
(``:142-157``)."""
from __future__ import annotations

import torch

from cvssl_tpu_torch.train.methods.base import (Method, register_method,
                                                split_batch)


def rot90_select(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """rot90 of (B, C, H, W) over (H, W) by ``k`` in {0..3}, a 0-dim tensor
    on the device: every rotation selected on the device, so the host never
    waits for ``k``. Square images. JAX: ``jnp.rot90(x, k, (1, 2))`` on
    NHWC."""
    out = x
    for r in (1, 2, 3):
        out = torch.where(k == r, torch.rot90(x, r, dims=(2, 3)), out)
    return out


@register_method("deep_co_training")
class DeepCoTraining(Method):
    """Student forwards of the full batch, then of the rotated unlabeled
    half (BatchNorm's running statistics update twice, in that order); one
    k per step, as the reference's ``random.randrange`` per iteration."""

    def loss(self, ctx, batch):
        cfg = self.cfg
        lb = cfg.labeled_bs
        _, label, unlabeled_img = split_batch(cfg, batch)

        outputs = self.primary_logits(ctx.forward("model", batch["image"]))
        outputs_soft = torch.softmax(outputs.float(), dim=1)

        k = ctx.randint(4)
        rot_out = self.primary_logits(
            ctx.forward("model", rot90_select(unlabeled_img, k)))
        rot_soft = torch.softmax(rot_out.float(), dim=1)
        unl_soft_rot = rot90_select(outputs_soft[lb:], k)

        ce, dice = self.sup_ce_dice(outputs[:lb], label)
        sup = 0.5 * (ce + dice)

        w = ctx.consistency_weight()
        cons = 0.5 * (torch.mean((rot_soft.detach() - unl_soft_rot) ** 2) +
                      torch.mean((rot_soft - unl_soft_rot.detach()) ** 2))
        total = sup + w * cons
        return total, {"loss": total, "loss_ce": ce, "loss_dice": dice,
                       "consistency_loss": cons, "consistency_weight": w}
