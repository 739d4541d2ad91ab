"""Cross pseudo supervision (port of ``cvssl_tpu/train/methods/cps.py``;
``train_cross_pseudo_supervision_2D.py``): two students supervise each
other's unlabeled argmax."""
from __future__ import annotations

import torch

from cvssl_tpu_torch.ops import losses
from cvssl_tpu_torch.train.methods.base import Method, register_method


@register_method("cps")
class CrossPseudoSupervision(Method):
    """Both models are ``cfg.model``, each with its own SGD; different
    initial weights come from consecutive draws of the seeded init.
    Pseudo-supervision is cross entropy (``:189-193``)."""

    model_names = ("model1", "model2")

    def net_types(self):
        return {"model1": self.cfg.model, "model2": self.cfg.model}

    def _pseudo_ce(self, logits_unl, pseudo):
        return losses.cross_entropy(logits_unl, pseudo)

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

        w = ctx.consistency_weight()
        ps1 = self._pseudo_ce(out1[lb:], pseudo2)
        ps2 = self._pseudo_ce(out2[lb:], pseudo1)

        model1_loss = loss1 + w * ps1
        model2_loss = loss2 + w * ps2
        total = model1_loss + model2_loss
        return total, {"loss": total, "model1_loss": model1_loss,
                       "model2_loss": model2_loss, "consistency_weight": w}
