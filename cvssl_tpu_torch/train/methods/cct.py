"""Cross-consistency training on ``unet_cct`` (port of
``cvssl_tpu/train/methods/cct.py``): supervised CE+Dice on the main and
the three aux decoders, MSE consistency between each perturbed aux decoder
and the detached main decoder on the unlabeled half (SSL4MIS
``train_cct_2D``)."""
from __future__ import annotations

import torch

from cvssl_tpu_torch.train.methods.base import Method, register_method


@register_method("cct")
class CrossConsistencyTraining(Method):
    def net_types(self):
        return {"model": "unet_cct"}

    def loss(self, ctx, batch):
        cfg = self.cfg
        lb = cfg.labeled_bs
        label = batch["label"][:lb]

        main, aux1, aux2, aux3 = ctx.forward("model", batch["image"])
        soft_main = torch.softmax(main.float(), dim=1)

        sup = 0.0
        for out in (main, aux1, aux2, aux3):
            sup = sup + 0.5 * sum(self.sup_ce_dice(out[:lb], label))

        target = soft_main[lb:].detach()
        cons = 0.0
        for out in (aux1, aux2, aux3):
            soft = torch.softmax(out.float(), dim=1)
            cons = cons + torch.mean((soft[lb:] - target) ** 2)
        cons = cons / 3.0

        w = ctx.consistency_weight()
        total = sup + w * cons
        return total, {"loss": total, "sup_loss": sup,
                       "consistency_loss": cons, "consistency_weight": w}
