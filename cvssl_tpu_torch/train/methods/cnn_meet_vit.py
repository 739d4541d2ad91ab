"""CNN meets ViT (port of ``cvssl_tpu/train/methods/cnn_meet_vit.py``;
``train_cnn_meet_vit_2D.py``): cross teaching between the UNet and
SwinUnet plus a mean-teacher branch whose EMA teacher tracks model2
(``:347``); linear ramp on step // 150; pseudo-supervision weighted x7
(``:336-337``); the teacher consistency is zero before step 1000."""
from __future__ import annotations

import numpy as np
import torch

from cvssl_tpu_torch.ops import ramps
from cvssl_tpu_torch.train.methods.base import register_method
from cvssl_tpu_torch.train.methods.cross_teaching import CrossTeaching


@register_method("cnn_meet_vit")
class CnnMeetVit(CrossTeaching):
    """cross_teaching's slots and pseudo-supervision, and a teacher."""

    teacher_names = ("model2",)

    def step_scalars(self, step):
        cfg = self.cfg
        return {"consistency_weight": np.float32(cfg.consistency) * np.float32(
            ramps.linear_rampup(step // 150, cfg.consistency_rampup))}

    def graph_key(self, step):
        return (step >= 1000,)

    def loss(self, ctx, batch):
        cfg = self.cfg
        lb = cfg.labeled_bs
        label = batch["label"][:lb]
        unlabeled = batch["image"][lb:]

        noise = torch.clamp(0.1 * ctx.normal(unlabeled.shape,
                                             unlabeled.device), -0.2, 0.2)
        out1 = self.primary_logits(ctx.forward("model1", batch["image"]))
        out2 = self.primary_logits(ctx.forward("model2", batch["image"]))
        soft1 = torch.softmax(out1.float(), dim=1)
        soft2 = torch.softmax(out2.float(), dim=1)
        ema_soft = torch.softmax(self.primary_logits(
            ctx.forward_teacher("model2", unlabeled + noise)).float(), dim=1)

        loss1 = 0.5 * sum(self.sup_ce_dice(out1[:lb], label))
        loss2 = 0.5 * sum(self.sup_ce_dice(out2[:lb], label))

        pseudo1 = torch.argmax(soft1[lb:].detach(), dim=1)
        pseudo2 = torch.argmax(soft2[lb:].detach(), dim=1)
        ps1 = self._pseudo_dice(soft1[lb:], pseudo2)
        ps2 = self._pseudo_dice(soft2[lb:], pseudo1)

        w = ctx.consistency_weight()
        # JAX selects 0.0 before step 1000; here the branch is the graph
        # key (``graph_key``): the engine keeps a CUDA graph of each side,
        # and the dead terms are not computed
        if ctx.step < 1000:
            cons1 = cons2 = torch.zeros((), device=out1.device)
        else:
            cons1 = torch.mean((soft1[lb:] - ema_soft) ** 2)
            cons2 = torch.mean((soft2[lb:] - ema_soft) ** 2)

        model1_loss = loss1 + 7 * w * ps1 + w * cons1
        model2_loss = loss2 + 7 * w * ps2 + w * cons2
        total = model1_loss + model2_loss
        return total, {"loss": total, "model1_loss": model1_loss,
                       "model2_loss": model2_loss, "consistency_weight": w}
