"""Cross teaching between a CNN and a transformer (port of
``cvssl_tpu/train/methods/cross_teaching.py``;
``train_cross_teaching_between_cnn_transformer_2D.py``): model1 is
``cfg.model`` (the UNet), model2 ``cfg.model2`` (SwinUnet); each takes the
other's argmax as Dice pseudo-supervision (``:234-245``)."""
from __future__ import annotations

import torch

from cvssl_tpu_torch.ops import losses
from cvssl_tpu_torch.train.methods.base import Method, register_method


@register_method("cross_teaching")
class CrossTeaching(Method):
    """JAX also has a grouped-logits path for the SwinUnet slot (the TPU's
    ``s2d_logits``); it computes the same values, and the port has only
    the plain one. cnn_meet_vit and tripleview share the pseudo-supervision
    term."""

    model_names = ("model1", "model2")

    def net_types(self):
        return {"model1": self.cfg.model, "model2": self.cfg.model2}

    def _pseudo_dice(self, soft_unl, pseudo):
        """Dice of one model's unlabeled softmax against another model's
        argmax (reference ``:239-243``)."""
        return losses.dice_loss(soft_unl, pseudo, self.cfg.num_classes)

    def loss(self, ctx, batch):
        cfg = self.cfg
        lb = cfg.labeled_bs
        label = batch["label"][:lb]

        out1 = self.primary_logits(ctx.forward("model1", batch["image"]))
        out2 = self.primary_logits(ctx.forward("model2", batch["image"]))
        soft1 = torch.softmax(out1.float(), dim=1)
        soft2 = torch.softmax(out2.float(), dim=1)

        loss1 = 0.5 * sum(self.sup_ce_dice(out1[:lb], label))
        loss2 = 0.5 * sum(self.sup_ce_dice(out2[:lb], label))

        pseudo1 = torch.argmax(soft1[lb:].detach(), dim=1)
        pseudo2 = torch.argmax(soft2[lb:].detach(), dim=1)
        ps1 = self._pseudo_dice(soft1[lb:], pseudo2)
        ps2 = self._pseudo_dice(soft2[lb:], pseudo1)

        w = ctx.consistency_weight()
        model1_loss = loss1 + w * ps1
        model2_loss = loss2 + w * ps2
        total = model1_loss + model2_loss
        return total, {"loss": total, "model1_loss": model1_loss,
                       "model2_loss": model2_loss, "consistency_weight": w}
