"""Adversarial consistency on a ViT (port of
``cvssl_tpu/train/methods/adversarial_consistency.py``;
``train_adversarial_consistency_ViT_2D.py``): ICT mixing of the unlabeled
halves under an EMA teacher, plus the DAN discriminator. The student sees
[labeled, mixed] (``:218-224``); the loss is 1.5 (2 dice + ce) + w (ict
mse + 0.5 dan ce) (``:243-247``). The discriminator phase is the
adversarial method's: the real batch, the segmenter in eval mode and its
output detached."""
from __future__ import annotations

import torch

from cvssl_tpu_torch.train.methods.adversarial import AdversarialNetwork
from cvssl_tpu_torch.train.methods.base import register_method


@register_method("adversarial_consistency")
class AdversarialConsistency(AdversarialNetwork):
    teacher_names = ("model",)

    def loss(self, ctx, batch):
        cfg = self.cfg
        lb = cfg.labeled_bs
        label = batch["label"][:lb]
        labeled_img = batch["image"][:lb]
        unlabeled = batch["image"][lb:]
        half = unlabeled.shape[0] // 2
        u0, u1 = unlabeled[:half], unlabeled[half:2 * half]

        mix = ctx.beta(cfg.ict_alpha, (half,) + (1,) * (unlabeled.ndim - 1))
        mixed = u0 * (1.0 - mix) + u1 * mix
        inputs = torch.cat([labeled_img, mixed], dim=0)

        outputs = self.primary_logits(ctx.forward("model", inputs))
        soft = torch.softmax(outputs.float(), dim=1)
        # two teacher passes, each in train mode with its own draws
        ema0 = torch.softmax(self.primary_logits(
            ctx.forward_teacher("model", u0)).float(), dim=1)
        ema1 = torch.softmax(self.primary_logits(
            ctx.forward_teacher("model", u1)).float(), dim=1)
        pred_mixed = ema0 * (1.0 - mix) + ema1 * mix

        ce, dice = self.sup_ce_dice(outputs[:lb], label)
        sup = 2.0 * dice + ce

        w = ctx.consistency_weight()
        cons_ict = torch.mean((soft[lb:] - pred_mixed) ** 2)
        # reference quirk (:241): the discriminator sees the outputs from
        # row lb // 2 on (labeled rows, then the mixed ones), paired with
        # the first unlabeled images
        n = soft.shape[0] - lb // 2
        cons_dan = self.fool_dan(ctx, soft[lb // 2:], unlabeled[:n])

        total = 1.5 * sup + w * (cons_ict + 0.5 * cons_dan)
        return total, {"loss": total, "loss_ce": ce, "loss_dice": dice,
                       "ict_loss": cons_ict, "dan_loss": cons_dan,
                       "consistency_weight": w}
