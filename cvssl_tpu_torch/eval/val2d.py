"""2D per-volume validation (port of ``cvssl_tpu/eval/val2d.py``; parity
with ``code/val_2D.py:18-39``).

The slices of a volume go through the predictor in chunks of
``PREDICT_CHUNK`` (the JAX package pads them to shape buckets for XLA's
compilation cache; eval-mode BatchNorm is per sample, so chunking changes
no prediction), and the metrics are the medpy-style Dice + HD95 with the
background excluded and the empty-mask guard.

A predictor takes a float32 (B, 1, H, W) tensor and returns integer
(B, H, W) class maps (argmax already applied), as
``Engine.predict_fn`` does; the samples are numpy (S, H, W) volumes, so the
layout changes here, at this boundary.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from scipy import ndimage

from cvssl_tpu_torch.ops import metrics as M

PREDICT_CHUNK = 64  # slices per predictor call


def predict_slices(predict_fn, slices) -> torch.Tensor:
    """(N, H, W) float32 slices (numpy or tensor) -> (N, H, W) predictions,
    ``PREDICT_CHUNK`` slices per call, on the predictor's device."""
    if isinstance(slices, np.ndarray):
        slices = torch.from_numpy(np.ascontiguousarray(slices, np.float32))
    return torch.cat([predict_fn(slices[i:i + PREDICT_CHUNK, None])
                      for i in range(0, slices.shape[0], PREDICT_CHUNK)])


def _predict_patch(image: np.ndarray, predict_fn, patch_size
                   ) -> torch.Tensor:
    """(S, H, W) volume -> (S, *patch_size) predictions at patch
    resolution (order-0 zoom in), on the predictor's device."""
    _, x, y = image.shape
    zoomed = ndimage.zoom(image, (1, patch_size[0] / x, patch_size[1] / y),
                          order=0)
    return predict_slices(predict_fn, zoomed)


def _zoom_back(pred_patch: np.ndarray, shape, patch_size) -> np.ndarray:
    _, x, y = shape
    return ndimage.zoom(pred_patch,
                        (1, x / patch_size[0], y / patch_size[1]), order=0)


def _predict_volume(image: np.ndarray, predict_fn, patch_size):
    pred = _predict_patch(image, predict_fn, patch_size).cpu().numpy()
    return _zoom_back(pred, image.shape, patch_size)


def test_single_volume(image: np.ndarray, label: np.ndarray,
                       predict_fn: Callable[[torch.Tensor], torch.Tensor],
                       classes: int,
                       patch_size: Sequence[int] = (256, 256)):
    """image/label: (S, H, W). Returns [(dice, hd95)] for classes
    1..classes-1."""
    prediction = _predict_volume(image, predict_fn, patch_size)
    return [M.calculate_metric_percase_val(prediction == c, label == c)
            for c in range(1, classes)]


def evaluate(dataset, predict_fn, classes: int,
             patch_size: Sequence[int] = (256, 256),
             device_metrics: bool = None) -> np.ndarray:
    """Mean (dice, hd95) per foreground class over a val dataset of volumes
    (the reference's val loop, ``train_fully_supervised_2D.py:143-150``).

    ``device_metrics`` (default: on where CUDA is available, off on the
    CPU, as the JAX default is off on its CPU backend) computes Dice + HD95
    for all volumes and classes with the exact EDT of ``ops/edt.py`` on the
    predictor's device instead of the per-volume scipy loop."""
    if device_metrics is None:
        device_metrics = torch.cuda.is_available()
    if device_metrics:
        from cvssl_tpu_torch.ops import edt
        samples = [dataset[i] for i in range(len(dataset))]
        shapes = {tuple(s["image"].shape) for s in samples}
        if len(shapes) == 1 and next(iter(shapes))[1:] == tuple(patch_size):
            # uniform volumes at patch resolution, no zoom: every slice in
            # one pass and the predictions never leave the device
            n = len(samples)
            sv, xv, yv = next(iter(shapes))
            images = np.stack([s["image"] for s in samples]).reshape(
                n * sv, xv, yv)
            preds = predict_slices(predict_fn, images).reshape(n, sv, xv, yv)
            labels = torch.from_numpy(np.stack(
                [np.asarray(s["label"]) for s in samples]).astype(np.uint8))
            out = edt.val_metrics(preds.to(torch.uint8),
                                  labels.to(preds.device), classes)
            return out.cpu().numpy().astype(np.float64).sum(axis=0) / n
        preds, labels, device = [], [], None
        for sample in samples:
            patch = _predict_patch(sample["image"], predict_fn, patch_size)
            device = patch.device
            preds.append(_zoom_back(patch.cpu().numpy(),
                                    sample["image"].shape,
                                    patch_size).astype(np.uint8))
            labels.append(np.asarray(sample["label"]).astype(np.uint8))
        return edt.val_metrics_device(preds, labels, classes,
                                      device=device) / len(dataset)
    total = np.zeros((classes - 1, 2))
    for i in range(len(dataset)):
        sample = dataset[i]
        total += np.asarray(test_single_volume(
            sample["image"], sample["label"], predict_fn, classes,
            patch_size))
    return total / len(dataset)
