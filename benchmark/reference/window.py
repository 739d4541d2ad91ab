"""Plain sliding-window inference over one volume (SSL4MIS's
``val_3D.py::test_single_case``): the volume padded symmetrically to at
least the patch on each axis, corners every ``stride`` voxels on each axis
(stride_xy on the first two, stride_z on the last) with the last corner
clamped so that its window fits, each window's softmax added into a score
map and a count map, the score divided by the count and cropped back to
the volume. Returns the class probabilities (C, D, H, W), float32, for
the comparison to judge a label map by. This module imports nothing of the
program.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import unet3d


def corners_1d(size: int, patch: int, stride: int):
    n = math.ceil((size - patch) / stride) + 1 if size > patch else 1
    return [min(i * stride, size - patch) for i in range(n)]


def windows(extent, patch, stride_xy: int, stride_z: int):
    """Every window's corner (d, h, w) over ``extent``."""
    xs = corners_1d(extent[0], patch[0], stride_xy)
    ys = corners_1d(extent[1], patch[1], stride_xy)
    zs = corners_1d(extent[2], patch[2], stride_z)
    return [(x, y, z) for x in xs for y in ys for z in zs]


def probabilities(params: dict, volume: torch.Tensor, patch, classes: int,
                  stride_xy: int, stride_z: int, batch: int,
                  precision: str = "float32") -> torch.Tensor:
    shape = tuple(volume.shape)
    extent = tuple(max(s, int(p)) for s, p in zip(shape, patch))
    off = tuple((e - s) // 2 for e, s in zip(extent, shape))
    raw = tuple(slice(o, o + s) for o, s in zip(off, shape))
    padded = volume.new_zeros(extent)
    padded[raw] = volume.float()
    score = volume.new_zeros((classes,) + extent, dtype=torch.float32)
    count = volume.new_zeros(extent, dtype=torch.float32)
    pd, ph, pw = (int(p) for p in patch)
    corners = windows(extent, patch, stride_xy, stride_z)
    with torch.no_grad():
        for i in range(0, len(corners), batch):
            group = corners[i:i + batch]
            sl = [(slice(d, d + pd), slice(h, h + ph), slice(w, w + pw))
                  for d, h, w in group]
            x = torch.stack([padded[s] for s in sl])[:, None]
            probs = torch.softmax(unet3d.forward(params, x, train=False,
                                                 precision=precision), 1)
            for k, s in enumerate(sl):
                score[(slice(None),) + s] += probs[k]
                count[s] += 1.0
    return (score / count)[(slice(None),) + raw]
