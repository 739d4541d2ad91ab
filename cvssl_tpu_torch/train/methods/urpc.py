"""Uncertainty-rectified pyramid consistency on ``unet_urpc`` (port of
``cvssl_tpu/train/methods/urpc.py``; SSL4MIS ``train_urpc_2D``): supervised
CE+Dice at every scale; on the unlabeled half each scale's softmax pulled
toward the scales' mean, weighted by exp(-KL(scale || mean)), plus the KL
itself."""
from __future__ import annotations

import torch

from cvssl_tpu_torch.train.methods.base import Method, register_method


@register_method("urpc")
class URPC(Method):
    def net_types(self):
        return {"model": "unet_urpc"}

    def loss(self, ctx, batch):
        cfg = self.cfg
        lb = cfg.labeled_bs
        label = batch["label"][:lb]

        outs = ctx.forward("model", batch["image"])
        softs = [torch.softmax(o.float(), dim=1) for o in outs]

        sup = 0.0
        for o in outs:
            sup = sup + 0.5 * sum(self.sup_ce_dice(o[:lb], label))
        sup = sup / len(outs)

        avg = (sum(s[lb:] for s in softs) / len(softs)).detach()
        cons = 0.0
        for s in softs:
            su = s[lb:]
            kl = torch.sum(su * torch.log((su + 1e-8) / (avg + 1e-8)), dim=1,
                           keepdim=True)
            mse = (su - avg) ** 2
            rect = torch.mean(mse * torch.exp(-kl)) + torch.mean(kl)
            cons = cons + rect
        cons = cons / len(softs)

        w = ctx.consistency_weight()
        total = sup + w * cons
        return total, {"loss": total, "sup_loss": sup,
                       "consistency_loss": cons, "consistency_weight": w}
