"""Prediction post-processing + misc helpers from the reference
``code/dataloaders/utils.py`` (the port's copy of
``cvssl_tpu/data/postprocess.py``; numpy and scipy only)."""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def post_processing(prediction: np.ndarray,
                    min_fraction: float = 0.1) -> np.ndarray:
    """Connected-component filter (``dataloaders/utils.py:199-210``): drop
    components smaller than ``min_fraction`` of the largest one."""
    label_cc, num_cc = ndimage.label(prediction)
    if num_cc == 0:
        return prediction
    total_cc = np.sum(prediction)
    out = prediction.copy()
    sizes = ndimage.sum(prediction, label_cc, range(1, num_cc + 1))
    for cc in range(1, num_cc + 1):
        single_cc = (label_cc == cc) * prediction
        single_vol = sizes[cc - 1]
        if single_vol / total_cc < min_fraction:
            out = out - single_cc
    return out


def lr_poly(base_lr: float, iter_: int, max_iter: int, power: float) -> float:
    """(``dataloaders/utils.py:141``)"""
    return base_lr * ((1 - float(iter_) / max_iter) ** power)


def iou_binary(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = np.count_nonzero(np.logical_and(pred, gt))
    union = np.count_nonzero(np.logical_or(pred, gt))
    return inter / union if union else 0.0


# Pascal-VOC colormap (``dataloaders/utils.py:19-52`` equivalent)
def pascal_color_map(n: int = 256) -> np.ndarray:
    def bitget(v, i):
        return (v >> i) & 1
    cmap = np.zeros((n, 3), np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= bitget(c, 0) << (7 - j)
            g |= bitget(c, 1) << (7 - j)
            b |= bitget(c, 2) << (7 - j)
            c >>= 3
        cmap[i] = [r, g, b]
    return cmap
