"""Contrastive cross teaching (port of
``cvssl_tpu/train/methods/contrastive.py``;
``train_Contrastive_Cross_CNN_2D.py`` / ``_CNN_ViT_2D.py``): cross pseudo
supervision between two models, a supervised patch-contrastive loss on the
labeled logits (classifier heads, stride-2 interleave) and patch-NCE on the
unlabeled logits (projector heads).

Kept from the reference:
* the heads are in no optimizer (``:185-190`` builds optimizer1/2 only):
  they stay at their initial weights (the engine keeps no gradient for a
  model without an optimizer), and their BatchNorm running statistics
  still move in train mode;
* the consistency weight is ``ramp_up_function`` of the epoch index
  (``:109-113``), and the LR drops at half the iterations (``:280-284``);
* the strong-augmented loader is zipped in but never forwarded
  (``:211-220``): the method trains on the weak (resize-only) batch.
"""
from __future__ import annotations

import numpy as np
import torch

from cvssl_tpu_torch.ops import losses, ramps, schedules
from cvssl_tpu_torch.train.methods.base import register_method
from cvssl_tpu_torch.train.methods.cross_teaching import CrossTeaching


@register_method("contrastive_cross")
class ContrastiveCross(CrossTeaching):
    """Shares cross_teaching's Dice pseudo-supervision term."""

    model_names = ("model1", "model2", "classifier1", "classifier2",
                   "projector1", "projector2")
    transform = "weak"

    def net_types(self):
        return {**super().net_types(),
                "classifier1": "classifier", "classifier2": "classifier",
                "projector1": "projector", "projector2": "projector"}

    def optimizers(self, models):
        cfg = self.cfg
        return {n: schedules.TwoPhaseReferenceSGD(models[n].parameters(),
                                                  cfg.base_lr,
                                                  cfg.max_iterations)
                for n in ("model1", "model2")}

    def eval_model_names(self):
        return ("model1", "model2")

    def _epoch(self, step: int) -> int:
        """The epoch index: iterations per epoch are the labeled pool over
        the labeled batch (``TwoStreamBatchSampler``)."""
        per_epoch = max(self.cfg.labeled_slices // self.cfg.labeled_bs, 1)
        return int(step) // per_epoch

    def step_scalars(self, step):
        """The weight ramps on the epoch, in float32 as JAX's."""
        cfg = self.cfg
        return {"consistency_weight": np.float32(cfg.consistency) * np.float32(
            ramps.ramp_up_function(self._epoch(step),
                                   int(cfg.consistency_rampup)))}

    def loss(self, ctx, batch):
        cfg = self.cfg
        lb = cfg.labeled_bs
        label = batch["label"][:lb]
        img = batch["image"]

        out1 = self.primary_logits(ctx.forward("model1", img))
        out2 = self.primary_logits(ctx.forward("model2", img))
        soft1 = torch.softmax(out1.float(), dim=1)
        soft2 = torch.softmax(out2.float(), dim=1)

        w = ctx.consistency_weight()

        loss1 = 0.5 * sum(self.sup_ce_dice(out1[:lb], label))
        loss2 = 0.5 * sum(self.sup_ce_dice(out2[:lb], label))

        pseudo1 = torch.argmax(soft1[lb:].detach(), dim=1)
        pseudo2 = torch.argmax(soft2[lb:].detach(), dim=1)
        ps1 = self._pseudo_dice(soft1[lb:], pseudo2)
        ps2 = self._pseudo_dice(soft2[lb:], pseudo1)

        # supervised contrastive: even labeled logits of model1 into
        # classifier1, odd ones of model2 into classifier2 (``:245-247``)
        feat_l_q = ctx.forward("classifier1", out1[:lb][0::2])
        feat_l_k = ctx.forward("classifier2", out2[:lb][1::2])
        lc_l = losses.contrastive_loss_sup(feat_l_q, feat_l_k)

        feat_q = ctx.forward("projector1", out1[lb:])
        feat_k = ctx.forward("projector2", out2[lb:])
        lc_u = losses.con_loss(feat_q, feat_k)

        supervised = loss1 + loss2
        semisup = w * ps1 + w * ps2
        contrastive = lc_l + lc_u
        total = 2.0 * supervised + 0.5 * contrastive + 1.25 * semisup
        return total, {"loss": total, "model1_loss": loss1 + w * ps1,
                       "model2_loss": loss2 + w * ps2,
                       "contrast_l": lc_l, "contrast_u": lc_u,
                       "consistency_weight": w}
