"""The benchmark's fixed arithmetic: the cards' published peaks, kernel
#1's byte count, and the statistics of a window."""
from __future__ import annotations

import numpy as np

# NVIDIA data sheets, dense rates (no sparsity) at the full power limit:
# (dense bf16 FLOP/s, memory bytes/s), by a key found in the card's name;
# the longest key found wins ("H100" is the SXM part)
PEAKS = {"H100": (989e12, 3.35e12),
         "H100 PCIe": (756e12, 2.0e12),
         "H100 NVL": (835e12, 3.9e12)}


def peaks(card_name: str):
    """(bf16 FLOP/s, bytes/s) of the card, or None for a card not in the
    table."""
    found = [k for k in PEAKS if k.lower() in card_name.lower()]
    return PEAKS[max(found, key=len)] if found else None


def ce_dice_bytes(logit_shape, logit_bytes: int, label_bytes: int):
    """(forward, backward) bytes of kernel #1 at logits ``logit_shape``
    (B, C, *spatial): each input read once and each output written once.
    Forward: logits and labels in, CE, Dice and the (3, C) statistics out.
    Backward: logits, labels, the statistics and the two cotangents in,
    the gradient (the logits' size) out."""
    b, c = int(logit_shape[0]), int(logit_shape[1])
    sites = b * int(np.prod(logit_shape[2:]))
    logits = sites * c * logit_bytes
    inputs = logits + sites * label_bytes
    return inputs + 4 * (2 + 3 * c), inputs + 4 * (3 * c + 2) + logits


def rate(units: float, seconds: float) -> float:
    return units / seconds


def p95(values) -> float:
    """The 95th percentile of all ``values`` (linear between the two
    nearest ranks)."""
    return float(np.percentile(np.asarray(values, np.float64), 95.0))
