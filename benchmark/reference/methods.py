"""Plain training steps of the two semi-supervised methods the benchmark
trains: the mean teacher (``train_mean_teacher_2D.py``) and the
uncertainty-aware mean teacher in 3D (``train_uncertainty_aware_mean_
teacher_3D.py``), with SGD (momentum 0.9, weight decay 1e-4 added to the
gradient, poly learning rate of the update count) and the teacher's EMA
(decay min(1 - 1 / (t + 1), 0.99) of the step t before its increment).

A step draws, from one generator, in this order: the augmentation's draws,
the teacher's input noise, the student's dropout bytes, then (UAMT) the
Monte-Carlo passes' noise and the teacher's dropout bytes (mean teacher:
the teacher's dropout bytes after the student's). The host values (the
consistency weight's staircase ramp, UAMT's entropy threshold, the learning
rate, the EMA decay) are float32 as the reference scripts compute them.
This module imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import augment, unet2d, unet3d

MODELS = {"unet": unet2d, "unet_3D": unet3d}
SMOOTH = 1e-5


# -- host values -------------------------------------------------------------

def sigmoid_rampup(current, length) -> float:
    if length == 0:
        return 1.0
    current = np.clip(np.float32(current), 0.0, length)
    phase = np.float32(1.0) - current / np.float32(length)
    return float(np.exp(np.float32(-5.0) * phase * phase))


def consistency_weight(step: int, cfg: dict) -> float:
    """consistency * sigmoid_rampup(step // 150, rampup)."""
    r = sigmoid_rampup(int(step) // 150, cfg["consistency_rampup"])
    return float(np.float32(cfg["consistency"]) * np.float32(r))


def uamt_threshold(step: int, cfg: dict) -> float:
    """(0.75 + 0.25 sigmoid_rampup(step, max_iterations)) ln 2."""
    ramp = np.float32(sigmoid_rampup(step, cfg["max_iterations"]))
    return float((np.float32(0.75) + np.float32(0.25) * ramp)
                 * np.float32(np.log(2.0)))


def poly_lr(count: int, cfg: dict) -> float:
    frac = np.float32(1.0) - np.float32(count) / np.float32(
        cfg["max_iterations"])
    return float(np.float32(cfg["base_lr"]) * np.maximum(
        frac, np.float32(0.0)) ** np.float32(0.9))


def ema_decay(step: int, cfg: dict) -> float:
    t = np.float32(step)
    return float(min(np.float32(1.0) - np.float32(1.0) / (t + np.float32(1.0)),
                     np.float32(cfg["ema_decay"])))


# -- losses ------------------------------------------------------------------

def ce_dice(logits: torch.Tensor, labels: torch.Tensor, classes: int):
    """Mean softmax cross entropy and the class-mean soft Dice (squared
    sums), from float32 logits (B, C, ...)."""
    logp = torch.log_softmax(logits.float(), dim=1)
    ce = -logp.gather(1, labels[:, None]).mean()
    p = logp.exp()
    y = torch.nn.functional.one_hot(labels, classes).movedim(-1, 1).float()
    dims = (0,) + tuple(range(2, p.ndim))
    inter = (p * y).sum(dims)
    z = (p * p).sum(dims)
    ysum = (y * y).sum(dims)
    dice = (1.0 - (2.0 * inter + SMOOTH) / (z + ysum + SMOOTH)).sum() / classes
    return ce, dice


def softmax_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (torch.softmax(a.float(), 1) - torch.softmax(b.float(), 1)
            .detach()) ** 2


def _noise(shape, generator, device):
    return torch.clamp(0.1 * torch.randn(shape, generator=generator,
                                         device=device), -0.2, 0.2)


def _teacher(cfg, teacher, x, generator, precision, fault):
    """The teacher's logits of ``x`` (no gradient); with the ``no_teacher``
    fault its pass is left out and the logits are zeros."""
    if fault == "no_teacher":
        return torch.zeros((x.shape[0], cfg["num_classes"]) + x.shape[2:],
                           device=x.device)
    with torch.no_grad():
        return MODELS[cfg["model"]].forward(teacher, x, generator,
                                            precision=precision)


def mean_teacher_loss(cfg, student, teacher, image, label, step, generator,
                      precision, fault=None):
    """(loss, the consistency term before its weight)."""
    lb = cfg["labeled_bs"]
    unlabeled = image[lb:]
    ema_inputs = unlabeled + _noise(unlabeled.shape, generator, image.device)
    model = MODELS[cfg["model"]]
    outputs = model.forward(student, image, generator, precision=precision)
    ema = _teacher(cfg, teacher, ema_inputs, generator, precision, fault)
    ce, dice = ce_dice(outputs[:lb], label[:lb], cfg["num_classes"])
    sup = 0.5 * (ce + dice)
    if step < 1000:
        cons = torch.zeros((), device=image.device)
    else:
        cons = softmax_mse(outputs[lb:], ema).mean()
    return sup + consistency_weight(step, cfg) * cons, cons


def uamt3d_loss(cfg, student, teacher, image, label, step, generator,
                precision, fault=None):
    """UAMT with an InstanceNorm teacher: one teacher pass over the
    consistency target and the T noisy copies together. (loss, the
    consistency term before its weight)."""
    lb, T = cfg["labeled_bs"], cfg["uncertainty_T"]
    unlabeled = image[lb:]
    u, dev = unlabeled.shape[0], image.device
    ema_inputs = unlabeled + _noise(unlabeled.shape, generator, dev)
    model = MODELS[cfg["model"]]
    outputs = model.forward(student, image, generator, precision=precision)
    tiled = unlabeled.repeat((T,) + (1,) * (unlabeled.ndim - 1))
    mc_inputs = tiled + _noise(tiled.shape, generator, dev)
    both = _teacher(cfg, teacher, torch.cat([ema_inputs, mc_inputs]),
                    generator, precision, fault)
    ema, mc = both[:u], both[u:]
    preds = torch.softmax(mc.float(), 1).reshape((T, u) + mc.shape[1:])
    preds = preds.mean(0)
    uncertainty = -(preds * torch.log(preds + 1e-6)).sum(1, keepdim=True)
    ce, dice = ce_dice(outputs[:lb], label[:lb], cfg["num_classes"])
    sup = 0.5 * (ce + dice)
    mask = (uncertainty < uamt_threshold(step, cfg)).float()
    dist = softmax_mse(outputs[lb:], ema)
    cons = (mask * dist).sum() / (2.0 * mask.sum() + 1e-16)
    return sup + consistency_weight(step, cfg) * cons, cons


LOSSES = {"mean_teacher": mean_teacher_loss, "uamt": uamt3d_loss}


# -- the steps ---------------------------------------------------------------

def make_batch(cfg, raw, indices, generator):
    """One augmented batch from the raw data (``raw["images"]``,
    ``raw["labels"]`` indexed by volume or slice, and for 3D
    ``raw["extents"]``) at ``indices`` (B,) int64 on the device."""
    images, labels = raw["images"][indices], raw["labels"][indices]
    if cfg["dim"] == 2:
        draws = augment.draws_2d(indices.shape[0], generator, images.device)
        return augment.batch_2d(images, labels, draws)
    draws = augment.draws_3d(raw["extents"][indices], cfg["patch_size"],
                             generator)
    return augment.batch_3d(images, labels, draws, cfg["patch_size"])


def train(cfg: dict, student: dict, teacher: dict, raw, rows, seed: int,
          start_step: int, precision: str = "float32", fault: str = None):
    """Run ``len(rows)`` steps from the given weights and the generator of
    ``seed``. Returns {"losses": [...], "first_grad": {name: the
    optimizer's first update direction, gradient + wd * p}, "raw_grad":
    {name: the first gradient alone}, "student": weights after the steps,
    "teacher": teacher after the steps}. ``fault`` plants one of the
    faults the comparison must catch ("half_batch": the loss over the
    first half of each stream of the batch; "alter": the loss altered by a
    tenth where it is produced)."""
    dev = rows.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    s = {k: v.detach().clone().requires_grad_(True) for k, v in
         student.items()}
    t = {k: v.detach().clone() for k, v in teacher.items()}
    bufs, out = None, {"losses": [], "cons": []}
    loss_fn = LOSSES[cfg["method"]]
    for r in range(rows.shape[0]):
        step = start_step + r
        image, label = make_batch(cfg, raw, rows[r], gen)
        c = dict(cfg, uncertainty_T=1) if fault == "mc_one" else cfg
        if fault == "half_batch":
            lb, n = cfg["labeled_bs"], image.shape[0]
            keep = torch.cat([torch.arange(lb // 2),
                              torch.arange(lb, lb + (n - lb) // 2)]).to(dev)
            image, label = image[keep], label[keep]
            c = dict(cfg, labeled_bs=lb // 2)
        if fault == "unlabeled_half":
            lb, n = cfg["labeled_bs"], image.shape[0]
            half = (n - lb + 1) // 2
            image = torch.cat([image[:lb + half],
                               image[lb:n - half]])
        if fault == "unlabeled_out":
            lb, n = cfg["labeled_bs"], image.shape[0]
            image = torch.cat([image[:lb],
                               image[torch.arange(n - lb, device=dev) % lb]])
        loss, cons = loss_fn(c, s, t, image, label, step, gen, precision,
                             fault)
        if fault == "alter":
            loss = loss * 1.1
        names = list(s)
        grads = torch.autograd.grad(loss, [s[k] for k in names])
        out["losses"].append(float(loss.detach()))
        out["cons"].append(float(cons.detach()))
        lr = poly_lr(r, cfg)
        decay = ema_decay(step, cfg)
        with torch.no_grad():
            upd = [g + cfg["weight_decay"] * s[k]
                   for k, g in zip(names, grads)]
            if bufs is None:
                bufs = [u.clone() for u in upd]
                out["first_grad"] = dict(zip(names, [u.clone()
                                                     for u in upd]))
                out["raw_grad"] = dict(zip(names, grads))
            else:
                bufs = [0.9 * b + u for b, u in zip(bufs, upd)]
            for k, b in zip(names, bufs):
                s[k].sub_(b * torch.tensor(lr, device=dev))
            for k in names:
                t[k].mul_(decay).add_(s[k] * (1.0 - decay))
    out["student"] = {k: v.detach() for k, v in s.items()}
    out["teacher"] = t
    return out


def flop_count(cfg: dict) -> float:
    """FLOPs of one train step (2 x MACs of every convolution, forward and
    backward, every padded tap) by PyTorch's FlopCounterMode over this
    reference at the configuration's shapes, on the meta device (nothing
    computes)."""
    from torch.utils.flop_counter import FlopCounterMode
    model = MODELS[cfg["model"]]
    specs = model.param_specs(cfg["in_channels"], cfg["num_classes"])
    p = {n: torch.empty(sh, device="meta", requires_grad=True)
         for n, sh, _, _ in specs}
    b, lb = cfg["batch_size"], cfg["labeled_bs"]
    x = torch.empty((b, cfg["in_channels"]) + tuple(cfg["patch_size"]),
                    device="meta")
    teacher_batch = b - lb
    if cfg["method"] == "uamt":
        teacher_batch *= cfg["uncertainty_T"] + 1
    xt = torch.empty((teacher_batch,) + tuple(x.shape[1:]), device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        model.forward(p, x).sum().backward()
        with torch.no_grad():
            model.forward(p, xt)
    return float(counter.get_total_flops())


def window_flop_count(cfg: dict, windows: int, batch: int) -> float:
    """FLOPs of the sliding window over one volume: eval forwards of
    ``windows`` patches in batches of ``batch``."""
    from torch.utils.flop_counter import FlopCounterMode
    model = MODELS[cfg["model"]]
    specs = model.param_specs(cfg["in_channels"], cfg["num_classes"])
    p = {n: torch.empty(sh, device="meta") for n, sh, _, _ in specs}
    total = 0.0
    full, rest = divmod(windows, batch)
    for count, b in ((full, batch), (int(rest > 0), rest)):
        if not count:
            continue
        x = torch.empty((b, cfg["in_channels"]) + tuple(cfg["patch_size"]),
                        device="meta")
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            model.forward(p, x, train=False) if model is unet3d else \
                model.forward(p, x)
        total += count * float(counter.get_total_flops())
    return total
