"""Cross-CTA contrastive consistency, dual ViT, ICCVW'23 (port of
``cvssl_tpu/train/methods/contrastive_consistency.py``;
``train_Contrastive_Consistency_ViT_2D.py``).

Two segmenters on CTAugment's weak and strong views: ensemble masked
pseudo-labels from the weak views supervise the strong views (CE + Dice,
FixMatch-style); four projector heads give cross contrastive terms
(projector1/2 are EMA copies of projector3/4 through the engine's
``param_ema_map``; no head is in an optimizer, reference ``:186-190,
536-541``). The CTAugment policies are drawn anew each epoch with a depth
schedule (``:366-377``) and after an unfavorable crop (``:402-409``); the
bin rates move toward the epoch's mean loss (``:723-726``).

The CTAugment state lives on the method; ``fit`` drives the hooks on the
host CTA path (``train/engine.py``). Two differences from JAX, both for a
deterministic run that resumes bit-equal: the draws come from the
method's ``CTAugment`` generators, seeded from ``cfg.seed``
(``data/ctaugment.py``), and the epoch's losses stay on the device, summed
without a host sync each step, and are read once at the epoch's end (JAX
reads ``float(loss)`` every step).
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from cvssl_tpu_torch.data import ctaugment as cta_mod
from cvssl_tpu_torch.ops import losses, ramps
from cvssl_tpu_torch.ops.schedules import ReferenceSGD
from cvssl_tpu_torch.train.methods.base import Method, register_method
from cvssl_tpu_torch.train.methods.fixmatch import normalize_softmax

HEADS = tuple(f"projector{i}" for i in (1, 2, 3, 4))


@register_method("contrastive_consistency")
class ContrastiveConsistency(Method):
    model_names = ("model1", "model2") + HEADS
    transform = "cta"
    # projector1 <- EMA(projector3), projector2 <- EMA(projector4), after
    # the optimizer step, with the teacher's decay schedule
    param_ema_map = {"projector1": "projector3", "projector2": "projector4"}

    def __init__(self, cfg):
        super().__init__(cfg)
        self.cta = cta_mod.CTAugment(seed=cfg.seed)
        self._loss_sum = None     # sum of the epoch's losses (device)
        self._loss_count = 0

    def net_types(self):
        return {"model1": self.cfg.model, "model2": self.cfg.model2,
                **{n: "projector" for n in HEADS}}

    def optimizers(self, models):
        # the heads are in none: they keep no gradient, as JAX's zero
        # optimizer keeps their weights
        return {n: ReferenceSGD(models[n].parameters(), self.cfg.base_lr,
                                self.cfg.max_iterations)
                for n in ("model1", "model2")}

    def eval_model_names(self):
        return ("model1", "model2")

    # ------------------------------------------------------------------
    # host-side CTA hooks (driven by fit)
    # ------------------------------------------------------------------
    def create_transform(self, cfg):
        """(transform, ops_weak, ops_strong): a ``CTATransform`` whose
        cutout draws from a generator of its own (seeded with
        ``cfg.seed + 1``, so its stream is not the policies'), and the two
        initial policies, drawn from a ``CTAugment`` seeded with
        ``cfg.seed``."""
        self.cta = cta_mod.CTAugment(seed=cfg.seed)
        transform = cta_mod.CTATransform(
            cfg.patch_size, self.cta, rng=np.random.RandomState(cfg.seed + 1))
        ops_weak = self.cta.policy(probe=False, weak=True)
        ops_strong = self.cta.policy(probe=False, weak=False)
        return transform, ops_weak, ops_strong

    def refresh_policies(self, dataset, depth_weak: int, depth_strong: int):
        self.cta.random_depth_weak = depth_weak
        self.cta.random_depth_strong = depth_strong
        dataset.ops_weak = self.cta.policy(probe=False, weak=True)
        dataset.ops_strong = self.cta.policy(probe=False, weak=False)
        if (max(Counter(a.f for a in dataset.ops_weak).values()) >= 3 or
                max(Counter(a.f for a in dataset.ops_strong).values()) >= 3):
            self.refresh_policies(dataset, depth_weak, depth_strong)

    def on_epoch_start(self, dataset, iter_num: int):
        rng = self.cta.np_rng
        if iter_num <= 10000:
            dw = int(rng.randint(3, 5))
            ds = int(rng.randint(2, 5))
        elif iter_num >= 20000:
            dw = ds = 2
        else:
            dw = int(rng.randint(2, 5))
            ds = int(rng.randint(2, 5))
        self.refresh_policies(dataset, dw, ds)
        self._loss_sum, self._loss_count = None, 0

    def on_batch(self, batch, dataset):
        """Unfavorable-crop detection (``:402-409``), on the host batch:
        the raw labels have foreground but the augmented labels lost
        (almost) all of it."""
        label = np.asarray(batch["label"])
        n = label.size
        ratio = np.count_nonzero(label) / n
        ratio_aug = np.count_nonzero(np.asarray(batch["label_aug"])) / n
        if ratio > 0 and ratio_aug < 0.005:
            self.refresh_policies(dataset, self.cta.random_depth_weak,
                                  self.cta.random_depth_strong)

    def on_step_metrics(self, metrics):
        """Add the step's loss to the epoch's sum, where it lies (float64;
        no host sync)."""
        loss = metrics["loss"].detach().double()
        self._loss_sum = loss if self._loss_sum is None \
            else self._loss_sum + loss
        self._loss_count += 1

    def on_epoch_end(self, dataset):
        """Move the bin rates of the epoch's policies toward 1 - mean
        error, the error being half the loss (one read of the sum)."""
        if self._loss_count:
            mean_err = 0.5 * float(self._loss_sum) / self._loss_count
            self.cta.update_rates(dataset.ops_weak, 1.0 - 0.5 * mean_err)
            self.cta.update_rates(dataset.ops_strong, 1.0 - 0.5 * mean_err)

    def hook_state(self, dataset) -> dict:
        """Everything the hooks carry across steps, in plain Python
        values: the CTAugment state (rates, depths, generators), the
        dataset's policies and the epoch's losses so far (one read of the
        sum)."""
        return {"cta": dict(self.cta.state_dict()),
                "ops_weak": cta_mod.policy_to_plain(dataset.ops_weak),
                "ops_strong": cta_mod.policy_to_plain(dataset.ops_strong),
                "loss_sum": (None if self._loss_sum is None
                             else float(self._loss_sum)),
                "loss_count": self._loss_count}

    def load_hook_state(self, state: dict, dataset) -> None:
        self.cta.load_state_dict(state["cta"])
        dataset.ops_weak = cta_mod.policy_from_plain(state["ops_weak"])
        dataset.ops_strong = cta_mod.policy_from_plain(state["ops_strong"])
        # a float64 sum: adding the next step's float64 loss to it gives
        # what the uninterrupted run's device sum gives
        self._loss_sum = state["loss_sum"]
        self._loss_count = int(state["loss_count"])

    # ------------------------------------------------------------------
    def step_scalars(self, step):
        """The two weights on one sigmoid ramp, in float32 as JAX's."""
        cfg = self.cfg
        ramp = np.float32(ramps.sigmoid_rampup(int(step) // 150,
                                               cfg.consistency_rampup))
        return {"consistency_weight1": np.float32(cfg.consistency1) * ramp,
                "consistency_weight2": np.float32(cfg.consistency2) * ramp}

    def loss(self, ctx, batch):
        cfg = self.cfg
        lb = cfg.labeled_bs
        classes = cfg.num_classes
        weak, strong = batch["image_weak"], batch["image_strong"]
        label = torch.clamp(batch["label_aug"][:lb], 0, classes - 1)

        out_w1 = self.primary_logits(ctx.forward("model1", weak))
        out_s1 = self.primary_logits(ctx.forward("model1", strong))
        out_w2 = self.primary_logits(ctx.forward("model2", weak))
        out_s2 = self.primary_logits(ctx.forward("model2", strong))
        soft_w1 = torch.softmax(out_w1.float(), dim=1)
        soft_s1 = torch.softmax(out_s1.float(), dim=1)
        soft_w2 = torch.softmax(out_w2.float(), dim=1)
        soft_s2 = torch.softmax(out_s2.float(), dim=1)

        # ensemble masked pseudo-labels: a MASKED NORMALISED softmax,
        # unlike plain FixMatch (reference :424-434)
        norm1, norm2 = normalize_softmax(soft_w1), normalize_softmax(soft_w2)
        m1 = (norm1 > cfg.conf_thresh).float()
        m2 = (norm2 > cfg.conf_thresh).float()
        masked = (norm1 * m1 + norm2 * m2) / 2.0
        pseudo = torch.argmax(masked.detach(), dim=1)[lb:]

        w1 = ctx.scalar("consistency_weight1")
        w2 = ctx.scalar("consistency_weight2")

        sup = (sum(self.sup_ce_dice(out_w1[:lb], label))
               + sum(self.sup_ce_dice(out_w2[:lb], label)))

        unsup = (losses.cross_entropy(out_s1[lb:], pseudo)
                 + losses.dice_loss(soft_s1[lb:], pseudo, classes)
                 + losses.cross_entropy(out_s2[lb:], pseudo)
                 + losses.dice_loss(soft_s2[lb:], pseudo, classes))

        # the heads take and give NCHW maps, the layout the patch-NCE
        # reads (JAX moves its NHWC head outputs channel-first, ``chw``)
        lc_l = losses.contrastive_loss_sup(
            ctx.forward("projector3", out_w1[:lb]),
            ctx.forward("projector4", out_w2[:lb]))
        lc_u1 = losses.contrastive_loss_sup(
            ctx.forward("projector1", out_w1[lb:]),
            ctx.forward("projector4", out_s2[lb:]))
        lc_u2 = losses.contrastive_loss_sup(
            ctx.forward("projector2", out_w2[lb:]),
            ctx.forward("projector3", out_s1[lb:]))
        lc_u = lc_u1 + lc_u2

        total = sup + w1 * lc_l + w1 * unsup + w2 * lc_u
        return total, {"loss": total, "sup_loss": sup, "unsup_loss": unsup,
                       "contrast_l": lc_l, "contrast_u": lc_u,
                       "consistency_weight1": w1, "consistency_weight2": w2}
