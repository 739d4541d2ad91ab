"""FixMatch with complementary (negative) learning (port of
``cvssl_tpu/train/methods/fixmatch.py``; ``train_Fixmatch_CNN_2D.py``).
The batch comes from the store's ``weak_strong`` mode (keys
``image_weak``, ``image_strong``, ``label_aug``)."""
from __future__ import annotations

import math

import torch

from cvssl_tpu_torch.ops import losses
from cvssl_tpu_torch.train.methods.base import Method, register_method


def normalize_softmax(soft: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The reference's min-max 'normalize' (``:161-165``): subtract the
    per-pixel class min, divide by the ORIGINAL per-pixel class max (a
    faithful quirk, not a true min-max)."""
    min_val = soft.amin(dim=dim, keepdim=True)
    max_val = soft.amax(dim=dim, keepdim=True)
    return (soft - min_val) / max_val


@register_method("fixmatch")
class FixMatch(Method):
    teacher_names = ("model",)   # EMA kept like the reference (unused in loss)
    transform = "weak_strong"

    def comp_loss(self, weak_soft, strong_soft):
        """Complementary loss and adaptive sample weight (``:132-159``): the
        entropy of the spatial distribution per (b, class), normalised by
        log(H*W); CE of (1 - strong_soft) taken as logits against the
        argmin class of weak. ``as_weight`` is not detached."""
        b, c = weak_soft.shape[:2]
        il = strong_soft.reshape(b, c, -1)
        p = il / torch.clamp(il.sum(dim=-1, keepdim=True), min=1e-12)
        ent = -torch.sum(p * torch.log(torch.clamp(p, min=1e-12)), dim=-1)
        as_weight = torch.mean(1.0 - ent / math.log(il.shape[-1]))
        comp_labels = torch.argmin(weak_soft.detach(), dim=1)
        comp = as_weight * losses.cross_entropy(1.0 - strong_soft,
                                                comp_labels)
        return comp, as_weight

    def loss(self, ctx, batch):
        cfg = self.cfg
        lb = cfg.labeled_bs
        label = batch["label_aug"][:lb]

        out_weak = self.primary_logits(ctx.forward("model",
                                                   batch["image_weak"]))
        soft_weak = torch.softmax(out_weak.float(), dim=1)
        out_strong = self.primary_logits(ctx.forward("model",
                                                     batch["image_strong"]))
        soft_strong = torch.softmax(out_strong.float(), dim=1)

        pseudo_mask = (normalize_softmax(soft_weak)
                       > cfg.conf_thresh).float()
        masked_weak = soft_weak * pseudo_mask
        pseudo = torch.argmax(masked_weak[lb:].detach(), dim=1)

        w = ctx.consistency_weight()
        # supervised: ce + dice, NOT halved (reference :273-277)
        sup = sum(self.sup_ce_dice(out_weak[:lb], label))

        comp, as_weight = self.comp_loss(soft_weak, soft_strong)
        # unsup adds as_weight * comp AGAIN (comp already carries one
        # factor), faithful to reference :279-286
        unsup = (losses.cross_entropy(out_strong[lb:], pseudo)
                 + losses.dice_loss(soft_strong[lb:], pseudo,
                                    cfg.num_classes)
                 + as_weight * comp)

        total = sup + w * unsup
        return total, {"loss": total, "sup_loss": sup, "unsup_loss": unsup,
                       "as_weight": as_weight, "consistency_weight": w}
