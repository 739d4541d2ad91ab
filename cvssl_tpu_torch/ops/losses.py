"""Segmentation, SSL and patch-contrastive losses (port of
``cvssl_tpu/ops/losses.py``).

The class axis defaults to 1 (NCHW), as in the original torch code; the JAX
package's is -1. Every loss casts its inputs to float32 at entry (float64
stays float64, so a reference can run in double), and the smoothing
constants match the JAX package exactly.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F


def _upcast(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


# ---------------------------------------------------------------------------
# Dice family
# ---------------------------------------------------------------------------

def dice_loss_binary(score: torch.Tensor, target: torch.Tensor,
                     smooth: float = 1e-5) -> torch.Tensor:
    """Soft Dice with squared sums over every element, the batch too.
    JAX: ``losses.dice_loss_binary``."""
    score, target = _upcast(score), _upcast(target)
    intersect = torch.sum(score * target)
    y_sum = torch.sum(target * target)
    z_sum = torch.sum(score * score)
    return 1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)


def dice_loss_binary1(score: torch.Tensor, target: torch.Tensor,
                      smooth: float = 1e-5) -> torch.Tensor:
    """Soft Dice with plain sums over every element. JAX:
    ``losses.dice_loss_binary1``."""
    score, target = _upcast(score), _upcast(target)
    intersect = torch.sum(score * target)
    return 1.0 - (2.0 * intersect + smooth) / (
        torch.sum(score) + torch.sum(target) + smooth)


def one_hot(labels: torch.Tensor, num_classes: int, axis: int = 1,
            dtype=torch.float32) -> torch.Tensor:
    """Integer label map -> one-hot float map with the class axis at
    ``axis``. ``F.one_hot`` needs int64, so the widening happens here."""
    oh = F.one_hot(labels.long(), num_classes).to(dtype)
    return oh.movedim(-1, axis)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  axis: int = 1) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels (torch
    ``nn.CrossEntropyLoss()`` default). JAX: ``losses.cross_entropy``."""
    logp = F.log_softmax(_upcast(logits), dim=axis)
    picked = logp.gather(axis, labels.long().unsqueeze(axis))
    return -picked.mean()


def dice_loss(inputs: torch.Tensor, target: torch.Tensor, num_classes: int,
              weight: Sequence[float] | None = None, softmax: bool = False,
              axis: int = 1, smooth: float = 1e-5) -> torch.Tensor:
    """Multi-class squared-sum dice averaged over classes (the reference's
    ``DiceLoss``). JAX: ``losses.dice_loss``."""
    inputs = _upcast(inputs)
    if softmax:
        inputs = torch.softmax(inputs, dim=axis)
    tgt = one_hot(target, num_classes, axis, inputs.dtype)
    red = tuple(i for i in range(inputs.ndim) if i != axis % inputs.ndim)
    intersect = torch.sum(inputs * tgt, dim=red)
    z_sum = torch.sum(inputs * inputs, dim=red)
    y_sum = torch.sum(tgt * tgt, dim=red)
    per_class = 1.0 - (2.0 * intersect + smooth) / (z_sum + y_sum + smooth)
    if weight is not None:
        per_class = per_class * torch.as_tensor(weight, dtype=per_class.dtype,
                                                device=per_class.device)
    return torch.sum(per_class) / num_classes


def softmax_dice_loss(input_logits: torch.Tensor,
                      target_logits: torch.Tensor,
                      axis: int = 1) -> torch.Tensor:
    """Mean over classes of the plain-sum Dice between two softmaxes;
    gradients flow to ``input_logits`` only. JAX:
    ``losses.softmax_dice_loss``."""
    n = input_logits.shape[axis]
    input_soft = torch.softmax(_upcast(input_logits), dim=axis)
    target_soft = torch.softmax(_upcast(target_logits), dim=axis).detach()
    red = tuple(i for i in range(input_soft.ndim)
                if i != axis % input_soft.ndim)
    smooth = 1e-5
    intersect = torch.sum(input_soft * target_soft, dim=red)
    dice = 1.0 - (2.0 * intersect + smooth) / (
        torch.sum(input_soft, dim=red) + torch.sum(target_soft, dim=red)
        + smooth)
    return torch.sum(dice) / n


def softmax_mse_loss(input_logits: torch.Tensor, target_logits: torch.Tensor,
                     axis: int = 1) -> torch.Tensor:
    """Element-wise (softmax(a) - softmax(b))**2 with no reduction;
    gradients flow to ``input_logits`` only. JAX: ``losses.softmax_mse_loss``
    (``sigmoid=False``)."""
    input_soft = torch.softmax(_upcast(input_logits), dim=axis)
    target_soft = torch.softmax(_upcast(target_logits), dim=axis).detach()
    return (input_soft - target_soft) ** 2


def ce_dice(logits: torch.Tensor, labels: torch.Tensor, num_classes: int):
    """(cross_entropy, dice) pair through the fused CE+Dice wrapper
    (``ops/fused_ce_dice.py``): the CUDA kernels on a CUDA tensor, their
    plain version on a CPU tensor. JAX: ``losses.ce_dice``."""
    from cvssl_tpu_torch.ops.fused_ce_dice import fused_ce_dice
    return fused_ce_dice(logits, labels, num_classes)


def dice_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                 num_classes: int, axis: int = 1) -> torch.Tensor:
    """The canonical supervised loss ``0.5 * (ce + dice(softmax))``.
    JAX: ``losses.dice_ce_loss``."""
    ce = cross_entropy(logits, labels, axis=axis)
    dl = dice_loss(logits, labels, num_classes, softmax=True, axis=axis)
    return 0.5 * (ce + dl)


# ---------------------------------------------------------------------------
# Entropy family
# ---------------------------------------------------------------------------

def _plogp(p: torch.Tensor, axis: int, keepdim: bool) -> torch.Tensor:
    p = _upcast(p)
    return -torch.sum(p * torch.log(p + 1e-6), dim=axis, keepdim=keepdim)


def entropy_loss(p: torch.Tensor, num_classes: int = 2,
                 axis: int = 1) -> torch.Tensor:
    """Mean entropy of a probability map over log(num_classes). JAX:
    ``losses.entropy_loss``."""
    return torch.mean(_plogp(p, axis, False) / math.log(num_classes))


def entropy_loss_map(p: torch.Tensor, num_classes: int = 2,
                     axis: int = 1) -> torch.Tensor:
    """Per-pixel entropy over log(num_classes), the class axis kept at
    size 1. JAX: ``losses.entropy_loss_map``."""
    return _plogp(p, axis, True) / math.log(num_classes)


def entropy_minimization(p: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Mean entropy, not normalised. JAX: ``losses.entropy_minimization``."""
    return torch.mean(_plogp(p, axis, False))


def entropy_map(p: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Per-pixel entropy, not normalised, the class axis kept at size 1.
    JAX: ``losses.entropy_map``."""
    return _plogp(p, axis, True)


# ---------------------------------------------------------------------------
# Consistency family
# ---------------------------------------------------------------------------

def _kl_div_elems(log_p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``F.kl_div``'s terms q * (log q - log_p), with 0 * log 0 = 0."""
    return torch.xlogy(q, q) - q * log_p


def softmax_kl_loss(input_logits: torch.Tensor, target_logits: torch.Tensor,
                    sigmoid: bool = False, axis: int = 1) -> torch.Tensor:
    """KL(target || input) averaged over every element (torch's
    ``reduction='mean'``, not ``batchmean``); gradients flow to
    ``input_logits`` only. JAX: ``losses.softmax_kl_loss``."""
    a, b = _upcast(input_logits), _upcast(target_logits)
    if sigmoid:
        input_log = torch.log(torch.sigmoid(a))
        target_soft = torch.sigmoid(b)
    else:
        input_log = F.log_softmax(a, dim=axis)
        target_soft = torch.softmax(b, dim=axis)
    return torch.mean(_kl_div_elems(input_log, target_soft.detach()))


def symmetric_mse_loss(input1: torch.Tensor,
                       input2: torch.Tensor) -> torch.Tensor:
    """mean((a - b)^2), gradients to both sides. JAX:
    ``losses.symmetric_mse_loss``."""
    return torch.mean((input1 - input2) ** 2)


def compute_kl_loss(p: torch.Tensor, q: torch.Tensor,
                    axis: int = 1) -> torch.Tensor:
    """The mean of KL(q || p) and KL(p || q) over the class axis, each the
    mean of its terms (R-Drop). JAX: ``losses.compute_kl_loss``."""
    p, q = _upcast(p), _upcast(q)
    p_loss = torch.mean(_kl_div_elems(F.log_softmax(p, dim=axis),
                                      torch.softmax(q, dim=axis)))
    q_loss = torch.mean(_kl_div_elems(F.log_softmax(q, dim=axis),
                                      torch.softmax(p, dim=axis)))
    return (p_loss + q_loss) / 2.0


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0,
               alpha: Sequence[float] | float | None = None,
               size_average: bool = True, axis: int = 1) -> torch.Tensor:
    """-(1 - pt)^gamma * log pt with an optional per-class ``alpha`` (a
    float a is [a, 1 - a]); pt carries no gradient in the factor, as the
    reference's ``.data.exp()``. JAX: ``losses.focal_loss``."""
    logp = F.log_softmax(_upcast(logits), dim=axis)
    logpt = logp.gather(axis, labels.long().unsqueeze(axis)).reshape(-1)
    pt = torch.exp(logpt).detach()
    if alpha is not None:
        if isinstance(alpha, (float, int)):
            alpha = [alpha, 1.0 - alpha]
        alpha_vec = torch.as_tensor(alpha, dtype=logpt.dtype,
                                    device=logpt.device)
        logpt = logpt * alpha_vec[labels.reshape(-1).long()]
    loss = -((1.0 - pt) ** gamma) * logpt
    return torch.mean(loss) if size_average else torch.sum(loss)


# ---------------------------------------------------------------------------
# Boundary-weighted BCE + IoU (the deep co-training family)
# ---------------------------------------------------------------------------

def weighted_loss(pred: torch.Tensor, mask: torch.Tensor,
                  kernel_size: int = 31) -> torch.Tensor:
    """Boundary-weighted BCE plus weighted IoU of (N, C, H, W) probability
    maps ``pred`` in (0, 1) and binary masks: weights 1 + 5 |avg_pool(mask)
    - mask| (stride 1, zero padding counted in the mean), each reduced over
    H and W, then the mean. JAX: ``losses.weighted_loss`` (NHWC)."""
    pred, mask = _upcast(pred), _upcast(mask)
    pooled = F.avg_pool2d(mask, kernel_size, stride=1,
                          padding=kernel_size // 2, count_include_pad=True)
    weit = 1.0 + 5.0 * torch.abs(pooled - mask)
    eps = 1e-7
    p = torch.clamp(pred, eps, 1.0 - eps)
    wbce = -(mask * torch.log(p) + (1.0 - mask) * torch.log(1.0 - p))
    wbce = torch.sum(weit * wbce, dim=(2, 3)) / torch.sum(weit, dim=(2, 3))
    inter = torch.sum(pred * mask * weit, dim=(2, 3))
    union = torch.sum((pred + mask) * weit, dim=(2, 3))
    wiou = 1.0 - (inter + 1.0) / (union - inter + 1.0)
    return torch.mean(wbce + wiou)


def loss_sup(logit_s1, logit_s2, labels_s1, labels_s2) -> torch.Tensor:
    """The two students' weighted losses, summed. JAX: ``losses.loss_sup``.
    """
    return weighted_loss(logit_s1, labels_s1) + weighted_loss(logit_s2,
                                                              labels_s2)


def loss_diff(u_pred_1: torch.Tensor, u_pred_2: torch.Tensor
              ) -> torch.Tensor:
    """Each prediction's weighted loss against the other, summed, with no
    gradient (the reference detaches through ``.item()``). JAX:
    ``losses.loss_diff``."""
    with torch.no_grad():
        return weighted_loss(u_pred_1, u_pred_2) + weighted_loss(u_pred_2,
                                                                 u_pred_1)


# ---------------------------------------------------------------------------
# Contrastive family (JAX ``losses.py:322-362``)
# ---------------------------------------------------------------------------

def _l1_normalize(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``F.normalize(p=1)``: divide by the L1 norm clamped to 1e-12."""
    n = torch.clamp(torch.sum(torch.abs(x), dim=axis, keepdim=True),
                    min=1e-12)
    return x / n


def _patch_nce(feat_q: torch.Tensor, feat_k: torch.Tensor,
               temperature: float, pos_from_dot: bool) -> torch.Tensor:
    """Patch-NCE over the spatial sites of (B, C, ...) features, flattened
    H-major: each query site's positive is the key at the same site, its
    negatives the key's other sites (the diagonal of ``l_neg`` is -inf).
    The key side carries no gradient. As in the reference, the features
    are L1-normalised, not L2. JAX: ``losses._patch_nce``."""
    b, c = feat_q.shape[0], feat_q.shape[1]
    q = _l1_normalize(_upcast(feat_q).reshape(b, c, -1).transpose(1, 2))
    k = _l1_normalize(_upcast(feat_k).reshape(b, c, -1).transpose(1, 2))
    k = k.detach()
    npatches = q.shape[1]
    l_pos = torch.sum(q * k, dim=-1).reshape(-1, 1)         # (B*NP, 1)
    l_neg = torch.bmm(q, k.transpose(1, 2))                 # (B, NP, NP)
    eye = torch.eye(npatches, dtype=torch.bool, device=q.device)[None]
    l_neg = l_neg.masked_fill(eye, float("-inf")).reshape(-1, npatches)
    if not pos_from_dot:
        l_pos = torch.zeros_like(l_pos)
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    # cross entropy with the positive slot (class 0) as the target
    return torch.mean(-F.log_softmax(logits, dim=-1)[:, 0])


def con_loss(feat_q: torch.Tensor, feat_k: torch.Tensor,
             temperature: float = 0.07) -> torch.Tensor:
    """Patch-NCE of unlabeled features (the reference's ``ConLoss``).
    JAX: ``losses.con_loss``."""
    return _patch_nce(feat_q, feat_k, temperature, pos_from_dot=True)


# The reference's ConLoss_queue (losses.py:598) never reads its queue in
# forward (and its __init__ names an undefined variable), so it is ConLoss.
# JAX: ``losses.con_loss_queue``.
con_loss_queue = con_loss


def contrastive_loss_sup(feat_q: torch.Tensor, feat_k: torch.Tensor,
                         temperature: float = 0.07) -> torch.Tensor:
    """Supervised patch contrastive loss. The reference defines it twice
    and Python keeps the second definition, whose positive is the dot
    product; so does this. JAX: ``losses.contrastive_loss_sup``."""
    return _patch_nce(feat_q, feat_k, temperature, pos_from_dot=True)


def info_nce_loss(feats1: torch.Tensor, feats2: torch.Tensor,
                  temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE on cosine similarities of (N, D) features, each row's
    positive N // 2 rows away and itself masked out. JAX:
    ``losses.info_nce_loss``."""
    f1 = feats1 / torch.clamp(torch.linalg.norm(feats1, dim=-1,
                                                keepdim=True), min=1e-8)
    f2 = feats2 / torch.clamp(torch.linalg.norm(feats2, dim=-1,
                                                keepdim=True), min=1e-8)
    cos_sim = f1 @ f2.T
    n = cos_sim.shape[0]
    self_mask = torch.eye(n, dtype=torch.bool, device=cos_sim.device)
    cos_sim = cos_sim.masked_fill(self_mask, -9e15)
    pos_mask = torch.roll(self_mask, shifts=n // 2, dims=0)
    cos_sim = cos_sim / temperature
    nll = -torch.sum(torch.where(pos_mask, cos_sim, 0.0), dim=-1) \
        + torch.logsumexp(cos_sim, dim=-1)
    return torch.mean(nll)


class MocoQueue(NamedTuple):
    """A key queue of fixed capacity, written as a ring: ``keys`` (K, D),
    ``valid`` (K,) and the write position ``ptr``, a 0-d int64 tensor, all
    on the features' device. JAX: ``losses.MocoQueue`` (which drops the
    reference's staleness-keyed dict for static shapes)."""
    keys: torch.Tensor
    valid: torch.Tensor
    ptr: torch.Tensor


def moco_queue_init(capacity: int, dim: int, device="cuda") -> MocoQueue:
    """An empty queue of ``capacity`` keys of ``dim`` features on
    ``device`` (the card unless the caller asks for the CPU). JAX:
    ``losses.moco_queue_init``."""
    return MocoQueue(
        keys=torch.zeros((capacity, dim), dtype=torch.float32,
                         device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        ptr=torch.zeros((), dtype=torch.int64, device=device))


def moco_loss(feat_q: torch.Tensor, feat_k: torch.Tensor, queue: MocoQueue,
              temperature: float = 0.07) -> tuple[torch.Tensor, MocoQueue]:
    """MoCo loss on cosine similarities: each query's positive is its own
    key, its negatives the queue's valid keys, or the batch's keys while
    the queue is empty (padded with -inf to the queue's width); then the
    batch's keys go into the ring at ``ptr``. The keys carry no gradient.
    No host synchronisation. Returns (loss, new queue). JAX:
    ``losses.moco_loss``."""
    b = feat_q.shape[0]
    q = _upcast(feat_q).reshape(b, -1)
    k = _upcast(feat_k).reshape(b, -1).detach()

    def unit(a):
        return a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True),
                               min=1e-8)

    qn, kn = unit(q), unit(k)
    l_pos = torch.sum(qn * kn, dim=-1, keepdim=True)
    cap = queue.keys.shape[0]
    l_neg_queue = (qn @ unit(queue.keys).T).masked_fill(~queue.valid[None],
                                                        float("-inf"))
    l_neg_b = qn @ kn.T
    l_neg_b = F.pad(l_neg_b, (0, cap - b), value=float("-inf")) \
        if cap > b else l_neg_b[:, :cap]
    l_neg = torch.where(queue.valid.any(), l_neg_queue, l_neg_b)
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    loss = torch.mean(-F.log_softmax(logits, dim=-1)[:, 0])
    idx = (queue.ptr + torch.arange(b, device=k.device)) % cap
    keys = queue.keys.index_put((idx,), k)
    valid = queue.valid.index_put(
        (idx,), torch.ones((), dtype=torch.bool, device=k.device))
    return loss, MocoQueue(keys, valid, (queue.ptr + b) % cap)
