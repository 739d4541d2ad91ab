"""Segmentation, SSL and patch-contrastive losses (port of
``cvssl_tpu/ops/losses.py``).

The class axis defaults to 1 (NCHW), as in the original torch code; the JAX
package's is -1. Every loss casts its inputs to float32 at entry (float64
stays float64, so a reference can run in double), and the smoothing
constants match the JAX package exactly.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _upcast(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


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


def contrastive_loss_sup(feat_q: torch.Tensor, feat_k: torch.Tensor,
                         temperature: float = 0.07) -> torch.Tensor:
    """Supervised patch contrastive loss. The reference defines it twice
    and Python keeps the second definition, whose positive is the dot
    product; so does this. JAX: ``losses.contrastive_loss_sup``."""
    return _patch_nce(feat_q, feat_k, temperature, pos_from_dot=True)
