"""The comparison that decides ``correct``: the numbers compared, each
against its limit from ``workloads/<cell>.json``.

Training (the first steps the window's own call ran, from the benchmark's
weights and inputs, against the plain reference's steps from the same):

- ``loss_gap``: the largest |loss - reference| / |reference| over the
  steps;
- ``cons_gap``: the same of the consistency term before its weight (the
  step's ``consistency_loss``): the unlabeled stream, the teacher's
  noisy forwards (UAMT's T Monte-Carlo passes and its uncertainty mask
  too) and the softmax MSE, which reach the loss, the gradients and the
  change only at the consistency weight (under a tenth);
- ``grad_gap``: the first update direction (gradient + weight decay, as
  the optimizer gets it; the program's worked out from its weights after
  one step as (w0 - w1) / lr), by the worst leaf: the gap between the two
  norms over the larger of the reference's norm of that leaf and of the
  median leaf; without the leaves whose reference gradient is under a
  thousandth of the median leaf's (a convolution's bias before a norm:
  zero up to rounding, so both sides' norms are rounding);
- ``change_gap``: the students' change after the steps, the same way and
  without the same leaves;
- ``ema_gap``: the teachers' change after the steps, the same way and
  without the same leaves (a teacher's bias before a norm follows its
  student's rounding motion there);
- ``grad_diff``, ``change_diff``: the median leaf's norm of the
  difference between the program's first update direction (students'
  change) and the reference's, over the same normaliser: where rounding
  moves every element, the median leaf sees it and one small leaf does
  not decide it;
- ``grad_ratio``, ``change_ratio``: the median over leaves of the norm of
  the program's difference from the reference (first update direction;
  students' change) over that of the reference computed in the
  configuration's own precision (bfloat16 storage around each
  convolution, ``reference/layers.py``) on the same inputs and draws: how
  many times its own precision's departure the program departs, so that
  how sensitive a seed's net is to rounding divides out.

Sliding window (a sample of the label maps delivered in the window,
against the reference's class probabilities of the same volumes):

- ``label_gap``: the widest gap over all voxels between the reference's
  best probability and its probability of the delivered label (1 for a
  missing or misshapen map);
- ``label_mismatch``: the share of voxels whose delivered label is not the
  reference's best.
"""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def worst_leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The widest gap of a leaf between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf."""
    names = [k for k in reference if keep is None or k in keep]
    med = statistics.median(reference[k] for k in names)
    gaps = [abs(program.get(k, 0.0) - reference[k])
            / max(reference[k], med, 1e-30) for k in names]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def train_readings(losses, cons, w0: dict, w1: dict, w_end: dict,
                   t0: dict, t_end: dict, lr0: float) -> dict:
    """The program's readings: each step's loss and consistency term, and
    its weights before the first step (``w0``, ``t0``: the benchmark's),
    after it (``w1``) and after the last (``w_end``, ``t_end``)."""
    return {"losses": list(losses), "cons": list(cons),
            "first_grad": {k: (w0[k] - w1[k]) / lr0 for k in w0},
            "student_change": {k: w_end[k] - w0[k] for k in w0},
            "teacher_change": {k: t_end[k] - t0[k] for k in t0}}


def reference_readings(ref: dict, w0: dict, t0: dict) -> dict:
    """The same readings from the reference's steps
    (``methods.train``), and its raw first gradient."""
    return {"losses": list(ref["losses"]), "cons": list(ref["cons"]),
            "first_grad": ref["first_grad"],
            "raw_grad": ref["raw_grad"],
            "student_change": {k: ref["student"][k] - w0[k] for k in w0},
            "teacher_change": {k: ref["teacher"][k] - t0[k] for k in t0}}


def relative_gaps(program, reference) -> float:
    """The largest |program - reference| / |reference| over the steps
    (inf for a step missing or not finite)."""
    gaps = [abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p)
            else math.inf for p, r in zip(program, reference)]
    if len(program) != len(reference):
        gaps.append(math.inf)
    return max(gaps)


def train_numbers(program: dict, reference: dict, stated: dict = None,
                  wanted=None) -> dict:
    """The numbers named in ``wanted`` (all where None); ``stated``, the
    reference in the configuration's own precision, is read only by
    ``*_ratio``."""
    raw = _norms(reference["raw_grad"])
    med = statistics.median(raw.values())
    moved = {k for k, v in raw.items() if v >= 1e-3 * med}
    keys = {"grad": "first_grad", "change": "student_change",
            "ema": "teacher_change"}

    def gap(what):
        key = keys[what]
        return worst_leaf_gap(_norms(program[key]), _norms(reference[key]),
                              moved)

    def diff(what):
        key = keys[what]
        return median_leaf_diff(program[key], reference[key], moved)

    def ratio(what):
        key = keys[what]
        return median_leaf_ratio(program[key], stated[key], reference[key],
                                 moved)
    numbers = {
        "loss_gap": lambda: relative_gaps(program["losses"],
                                          reference["losses"]),
        "cons_gap": lambda: relative_gaps(program["cons"],
                                          reference["cons"]),
        "grad_gap": lambda: gap("grad"), "change_gap": lambda: gap("change"),
        "ema_gap": lambda: gap("ema"), "grad_diff": lambda: diff("grad"),
        "change_diff": lambda: diff("change"),
        "grad_ratio": lambda: ratio("grad"),
        "change_ratio": lambda: ratio("change")}
    return {k: f() for k, f in numbers.items()
            if wanted is None or k in wanted}


def wants_stated(wanted) -> bool:
    """Whether the numbers ``wanted`` (all where None) read the reference
    in the configuration's own precision."""
    return wanted is None or any(k.endswith("_ratio") for k in wanted)


def median_leaf_diff(program: dict, reference: dict, keep) -> float:
    """The median leaf's norm of the difference between the program's
    tensor and the reference's, over the larger of the reference's norm
    of that leaf and of the median leaf."""
    ref = _norms({k: reference[k] for k in keep})
    med = statistics.median(ref.values())
    diff = _norms({k: program[k] - reference[k] for k in keep})
    return statistics.median(
        diff[k] / max(ref[k], med, 1e-30) if math.isfinite(diff[k])
        else math.inf for k in keep)


def median_leaf_ratio(program: dict, stated: dict, reference: dict,
                      keep) -> float:
    """The median over leaves of the norm of the program's difference from
    the reference over that of ``stated``'s (the reference computed in the
    configuration's own precision, on the same inputs and draws)."""
    p = _norms({k: program[k] - reference[k] for k in keep})
    s = _norms({k: stated[k] - reference[k] for k in keep})
    return statistics.median(p[k] / max(s[k], 1e-30) for k in keep)


WINDOW_NUMBERS = ("label_gap", "label_mismatch", "label_gap_mean")


def window_numbers(label_map, probs: torch.Tensor, wanted=None) -> dict:
    """The numbers named in ``wanted`` (all where None); ``label_map`` the
    delivered map (numpy), ``probs`` the reference's (C, D, H, W)
    probabilities of the same volume."""
    names = [k for k in WINDOW_NUMBERS if wanted is None or k in wanted]
    lab = np.asarray(label_map)
    if lab.shape != tuple(probs.shape[1:]) or lab.min() < 0 or \
            lab.max() >= probs.shape[0]:
        return {k: 1.0 for k in names}
    got = torch.from_numpy(lab.astype(np.int64)).to(probs.device)
    best, arg = probs.max(0)
    gap = best - probs.gather(0, got[None])[0]
    numbers = {"label_gap": lambda: float(gap.max()),
               "label_mismatch": lambda: float((arg != got).double().mean()),
               "label_gap_mean": lambda: float(gap.double().mean())}
    return {k: numbers[k]() for k in names}


def judge(numbers: dict, limits: dict):
    """(correct, checks): every number with a limit in ``limits`` is
    compared (at most its limit; NaN fails); the checks, by name,
    {"value", "limit"}, in the order of ``limits``."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        passed = math.isfinite(value) and value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
