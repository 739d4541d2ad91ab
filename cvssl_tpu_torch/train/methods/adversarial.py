"""Adversarial (DAN) training (port of
``cvssl_tpu/train/methods/adversarial.py``; ``train_adversarial_network_2D``):
a discriminator classifies (softmax map, image) pairs as labeled (1) or
unlabeled (0), and the segmenter learns to fool it on unlabeled data.

The engine runs the two phases of one step: the generator phase
(``loss``, the discriminator frozen and in eval mode) and the discriminator
phase (``loss_d``: the segmenter's outputs recomputed in eval mode and
detached, the reference's ``model.eval()`` + ``no_grad`` D phase).
"""
from __future__ import annotations

import torch

from cvssl_tpu_torch.models import net_factory, net_factory_3d
from cvssl_tpu_torch.ops import losses, schedules
from cvssl_tpu_torch.train.methods.base import Method, register_method


@register_method("adversarial")
class AdversarialNetwork(Method):
    model_names = ("model", "dan")
    adversarial_models = ("dan",)

    def net_types(self):
        return {"model": self.cfg.model, "dan": "discriminator"}

    def build_models(self):
        """The segmenter and the discriminator: at ``dim=3`` the 3D
        registry's (``FC3DDiscriminator``, JAX ``adversarial.py:27-33``),
        else the 2D one, whose classifier's width follows the patch."""
        cfg = self.cfg
        if cfg.dim == 3:
            dan = net_factory_3d("discriminator", cfg.in_channels,
                                 cfg.num_classes)
        else:
            dan = net_factory("discriminator", cfg.in_channels,
                              cfg.num_classes, patch_size=cfg.patch_size)
        return {"model": self._factory(cfg.model), "dan": dan}

    def optimizers(self, models):
        cfg = self.cfg
        return {"model": schedules.ReferenceSGD(models["model"].parameters(),
                                                cfg.base_lr,
                                                cfg.max_iterations),
                "dan": schedules.DiscriminatorAdam(
                    models["dan"].parameters(), cfg.dan_lr)}

    def eval_model_names(self):
        return ("model",)  # the discriminator is not a segmenter

    def fool_dan(self, ctx, soft_unl, image_unl):
        """CE of the eval-mode discriminator's verdict on the unlabeled
        pairs against 'labeled' (1) (reference ``DAN.eval()``, ``:143``)."""
        dan_out = ctx.forward("dan", soft_unl, train=False,
                              extra_args=(image_unl,))
        target = torch.ones(dan_out.shape[0], dtype=torch.long,
                            device=dan_out.device)
        return losses.cross_entropy(dan_out, target)

    def loss(self, ctx, batch):
        cfg = self.cfg
        lb = cfg.labeled_bs
        label = batch["label"][:lb]

        outputs = self.primary_logits(ctx.forward("model", batch["image"]))
        soft = torch.softmax(outputs.float(), dim=1)

        ce, dice = self.sup_ce_dice(outputs[:lb], label)
        sup = 0.5 * (ce + dice)

        w = ctx.consistency_weight()
        cons = self.fool_dan(ctx, soft[lb:], batch["image"][lb:])
        total = sup + w * cons
        return total, {"loss": total, "loss_ce": ce, "loss_dice": dice,
                       "consistency_loss": cons, "consistency_weight": w}

    def loss_d(self, ctx, batch):
        cfg = self.cfg
        with torch.no_grad():
            outputs = self.primary_logits(
                ctx.forward("model", batch["image"], train=False))
            soft = torch.softmax(outputs.float(), dim=1)
        dan_out = ctx.forward("dan", soft, extra_args=(batch["image"],))
        n, lb = dan_out.shape[0], cfg.labeled_bs
        target = (torch.arange(n, device=dan_out.device) < lb).long()
        d_loss = losses.cross_entropy(dan_out, target)
        return d_loss, {"dan_acc": torch.mean(
            (torch.argmax(dan_out, dim=1) == target).float())}
