"""Evaluation metrics (port of ``cvssl_tpu/ops/metrics.py``).

Dice on tensors (torch, any device); the surface-distance metrics (HD95 /
ASD) run on the host through scipy's EDT, a dependency-free
reimplementation of the medpy functions the reference uses
(``code/utils/metrics.py:27-33``, ``code/val_2D.py:7-15``,
``code/test_3D_util.py:147-152``). The device version of HD95 is
``ops/edt.py``.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage


# ---------------------------------------------------------------------------
# On the device
# ---------------------------------------------------------------------------

def dice_coefficient(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Binary dice 2|A∩B| / (|A|+|B|) on boolean/0-1 tensors; 0 when both
    are empty."""
    pred = pred.to(torch.float32)
    gt = gt.to(torch.float32)
    intersect = torch.sum(pred * gt)
    denom = torch.sum(pred) + torch.sum(gt)
    return torch.where(denom > 0, 2.0 * intersect / denom,
                       torch.zeros_like(denom))


def dice_per_class(pred_labels: torch.Tensor, gt_labels: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """Per-class binary dice for classes 1..num_classes-1 (background
    excluded, as in ``val2d.test_single_volume``). Returns
    (num_classes-1,)."""
    return torch.stack([dice_coefficient(pred_labels == c, gt_labels == c)
                        for c in range(1, num_classes)])


def cal_dice(prediction, label, num: int = 2):
    """Reference ``metrics.py:13-24`` parity: per-class dice without the
    empty-denominator guard (nan when both are empty)."""
    total = []
    prediction = np.asarray(prediction)
    label = np.asarray(label)
    for i in range(1, num):
        p = (prediction == i).astype(np.float64)
        lab = (label == i).astype(np.float64)
        total.append(2 * np.sum(p * lab) / (np.sum(p) + np.sum(lab)))
    return np.asarray(total)


# ---------------------------------------------------------------------------
# Host-side surface metrics (medpy parity without medpy)
# ---------------------------------------------------------------------------

def _surface_distances(result: np.ndarray, reference: np.ndarray,
                       voxelspacing=None, connectivity: int = 1) -> np.ndarray:
    """Distances from result's surface voxels to reference's surface (medpy
    ``__surface_distances``: border = mask minus its erosion, then the EDT
    of the complement of the reference border).

    Both computations are cropped to the union bounding box of the two
    masks (+1 voxel margin): every surface voxel of either mask lies inside
    it, and the EDT at any in-box point is its distance to the nearest
    reference-border voxel, also in the box, so the distances are
    unchanged."""
    result = np.atleast_1d(result.astype(bool))
    reference = np.atleast_1d(reference.astype(bool))
    if not np.any(result):
        raise RuntimeError("result is empty — no surface distances defined")
    if not np.any(reference):
        raise RuntimeError("reference is empty — no surface distances defined")

    union = result | reference
    slices = ndimage.find_objects(union.astype(np.uint8), max_label=1)[0]
    slices = tuple(
        slice(max(s.start - 1, 0), min(s.stop + 1, dim))
        for s, dim in zip(slices, union.shape))
    result = result[slices]
    reference = reference[slices]

    footprint = ndimage.generate_binary_structure(result.ndim, connectivity)
    result_border = result ^ ndimage.binary_erosion(result, structure=footprint,
                                                    iterations=1)
    reference_border = reference ^ ndimage.binary_erosion(
        reference, structure=footprint, iterations=1)
    dt = ndimage.distance_transform_edt(~reference_border,
                                        sampling=voxelspacing)
    return dt[result_border]


def hd95(result: np.ndarray, reference: np.ndarray, voxelspacing=None,
         connectivity: int = 1) -> float:
    """95th-percentile symmetric Hausdorff distance (medpy ``binary.hd95``)."""
    d1 = _surface_distances(result, reference, voxelspacing, connectivity)
    d2 = _surface_distances(reference, result, voxelspacing, connectivity)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def asd(result: np.ndarray, reference: np.ndarray, voxelspacing=None,
        connectivity: int = 1) -> float:
    """Average (result->reference) surface distance (medpy ``binary.asd``)."""
    return float(_surface_distances(result, reference, voxelspacing,
                                    connectivity).mean())


def dc(result: np.ndarray, reference: np.ndarray) -> float:
    """Binary dice (medpy ``binary.dc``; 0.0 when both empty)."""
    result = np.asarray(result).astype(bool)
    reference = np.asarray(reference).astype(bool)
    intersection = np.count_nonzero(result & reference)
    size = np.count_nonzero(result) + np.count_nonzero(reference)
    return 2.0 * intersection / size if size > 0 else 0.0


def jc(result: np.ndarray, reference: np.ndarray) -> float:
    """Jaccard index (medpy ``binary.jc``)."""
    result = np.asarray(result).astype(bool)
    reference = np.asarray(reference).astype(bool)
    intersection = np.count_nonzero(result & reference)
    union = np.count_nonzero(result | reference)
    return intersection / union if union > 0 else 0.0


def ravd(result: np.ndarray, reference: np.ndarray) -> float:
    """Relative absolute volume difference (medpy ``binary.ravd``):
    (|result| - |reference|) / |reference|."""
    vol_res = float(np.count_nonzero(result))
    vol_ref = float(np.count_nonzero(reference))
    if vol_ref == 0:
        raise RuntimeError("reference is empty — ravd undefined")
    return (vol_res - vol_ref) / vol_ref


def calculate_metric_percase_val(pred: np.ndarray, gt: np.ndarray):
    """Validation pair (dice, hd95) with the reference's empty guard:
    (0, 0) if either mask has no positives (``val_2D.py:7-15``)."""
    pred = np.asarray(pred) > 0
    gt = np.asarray(gt) > 0
    if pred.sum() > 0 and gt.sum() > 0:
        return dc(pred, gt), hd95(pred, gt)
    return 0.0, 0.0


def calculate_metric_percase_test(pred: np.ndarray, gt: np.ndarray):
    """Test quadruple (dc, jc, hd95, asd) (``utils/metrics.py:27-33``)."""
    return dc(pred, gt), jc(pred, gt), hd95(pred, gt), asd(pred, gt)


def calculate_metric_percase_3d(pred: np.ndarray, gt: np.ndarray):
    """3D test quadruple (dice, ravd, hd95, asd) (``test_3D_util.py:147-152``)."""
    return dc(pred, gt), ravd(pred, gt), hd95(pred, gt), asd(pred, gt)
