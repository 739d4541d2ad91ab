"""Examiner-student-teacher (port of ``cvssl_tpu/train/methods/exam.py``;
``train_exam_student_teacher_3D.py``): mean teacher plus the adversarial
method's discriminator as an examiner; loss = (2 dice + ce) + w (2 mse +
dan) (``:170-182``); the examiner is trained on the whole batch
(``:189-197``)."""
from __future__ import annotations

import torch

from cvssl_tpu_torch.train.methods.adversarial import AdversarialNetwork
from cvssl_tpu_torch.train.methods.base import register_method


@register_method("exam_student_teacher")
class ExamStudentTeacher(AdversarialNetwork):
    teacher_names = ("model",)

    def loss(self, ctx, batch):
        cfg = self.cfg
        lb = cfg.labeled_bs
        label = batch["label"][:lb]
        unlabeled = batch["image"][lb:]

        noise = torch.clamp(
            0.1 * ctx.normal(unlabeled.shape, unlabeled.device), -0.2, 0.2)
        outputs = self.primary_logits(ctx.forward("model", batch["image"]))
        soft = torch.softmax(outputs.float(), dim=1)
        ema_soft = torch.softmax(self.primary_logits(
            ctx.forward_teacher("model", unlabeled + noise)).float(), dim=1)

        ce, dice = self.sup_ce_dice(outputs[:lb], label)
        sup = 2.0 * dice + ce

        w = ctx.consistency_weight()
        cons_mse = torch.mean((soft[lb:] - ema_soft) ** 2)
        cons_dan = self.fool_dan(ctx, soft[lb:], unlabeled)

        total = sup + w * (2.0 * cons_mse + cons_dan)
        return total, {"loss": total, "loss_ce": ce, "loss_dice": dice,
                       "consistency_loss": cons_mse, "dan_loss": cons_dan,
                       "consistency_weight": w}
