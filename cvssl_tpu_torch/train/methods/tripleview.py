"""Triple-view (port of ``cvssl_tpu/train/methods/tripleview.py``;
``train_tripleview_2D(demo).py``): two ``cfg.model`` CNNs and one
``cfg.model2`` ViT, each supervised by the other two's argmax through
Dice (``:290-336``)."""
from __future__ import annotations

import torch

from cvssl_tpu_torch.train.methods.base import register_method
from cvssl_tpu_torch.train.methods.cross_teaching import CrossTeaching


@register_method("tripleview")
class TripleView(CrossTeaching):
    """cross_teaching's pseudo-supervision among three slots."""

    model_names = ("model1", "model2", "model3")

    def net_types(self):
        return {"model1": self.cfg.model, "model2": self.cfg.model,
                "model3": self.cfg.model2}

    def loss(self, ctx, batch):
        cfg = self.cfg
        lb = cfg.labeled_bs
        label = batch["label"][:lb]
        w = ctx.consistency_weight()

        softs, sups, pseudos = [], [], []
        for name in self.model_names:
            out = self.primary_logits(ctx.forward(name, batch["image"]))
            soft = torch.softmax(out.float(), dim=1)
            softs.append(soft)
            sups.append(0.5 * sum(self.sup_ce_dice(out[:lb], label)))
            pseudos.append(torch.argmax(soft[lb:].detach(), dim=1))

        metrics, total = {}, 0.0
        for i in range(3):
            ps = sum(self._pseudo_dice(softs[i][lb:], pseudos[j])
                     for j in range(3) if j != i)
            model_loss = sups[i] + w * ps
            metrics[f"model{i + 1}_loss"] = model_loss
            total = total + model_loss
        metrics["loss"] = total
        metrics["consistency_weight"] = w
        return total, metrics
