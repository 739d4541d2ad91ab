"""Signed distance fields on the host (numpy/scipy; the port's copy of
``cvssl_tpu/ops/sdf.py``, the reference's ``code/utils/util.py:201-232``
``compute_sdf``).

Per batch element: the min-max-normalised signed EDT of a binary mask,
zero on the inner boundary. An EDT is irregular work, so it stays on the
host, and callers copy the result to the card.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def _inner_boundary(posmask: np.ndarray) -> np.ndarray:
    """Foreground voxels with a background neighbour, full connectivity
    (skimage's ``find_boundaries(mode='inner')``)."""
    structure = ndimage.generate_binary_structure(posmask.ndim, posmask.ndim)
    eroded = ndimage.binary_erosion(posmask, structure=structure,
                                    border_value=True)
    return posmask & ~eroded


def compute_sdf(img_gt: np.ndarray, out_shape) -> np.ndarray:
    """float64 signed distance map per batch element: norm(negdis) -
    norm(posdis), 0 on the inner boundary; an element with an empty mask
    stays all zero, as in the reference. JAX: ``sdf.compute_sdf``."""
    img_gt = np.asarray(img_gt).astype(np.uint8)
    normalized_sdf = np.zeros(out_shape, dtype=np.float64)
    for b in range(out_shape[0]):
        posmask = img_gt[b].astype(bool)
        if posmask.any():
            negmask = ~posmask
            posdis = ndimage.distance_transform_edt(posmask)
            negdis = ndimage.distance_transform_edt(negmask)
            boundary = _inner_boundary(posmask)
            sdf = (negdis - negdis.min()) / max(negdis.max() - negdis.min(),
                                                1e-12) \
                - (posdis - posdis.min()) / max(posdis.max() - posdis.min(),
                                                1e-12)
            sdf[boundary] = 0
            normalized_sdf[b] = sdf
    return normalized_sdf
