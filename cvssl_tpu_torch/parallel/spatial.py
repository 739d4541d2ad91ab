"""Sliding-window inference with the windows split over the ranks (port of
``cvssl_tpu/parallel/spatial.py``).

Every rank holds the whole volume, runs the predictor on its share of the
window corners, and adds the probabilities into its own score and count
maps; one all-reduce of each sums them, and the argmax of score / count is
the label map. The corners and the padding are
``eval/val3d.py::SlidingWindowEvaluator``'s, so the result is the
single-rank evaluator's up to the order of the sums (an exact tie can flip).
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cvssl_tpu_torch.eval.val3d import SlidingWindowEvaluator
from cvssl_tpu_torch.parallel.mesh import Mesh


class ShardedSlidingWindowEvaluator:
    """The sliding window of one predictor, patch and stride, with the
    corner grid split over ``mesh``: the corner count is padded to a
    multiple of the world size by ``-1`` sentinels (which add nothing), and
    rank r takes the r-th contiguous block, as JAX's ``shard_map`` over the
    corner axis does. ``predict_fn`` takes a float32 (B, 1, pd, ph, pw)
    tensor on the mesh's device and returns (B, C, pd, ph, pw)
    probabilities."""

    def __init__(self, predict_fn: Callable, patch_size: Sequence[int],
                 num_classes: int, stride_xy: int, stride_z: int,
                 mesh: Mesh, patch_batch: int = 2):
        self.mesh = mesh
        self.num_classes = num_classes
        self.patch_batch = patch_batch
        self._predict = predict_fn
        # the plan (extent, offset, corners) and the windows
        self._plan = SlidingWindowEvaluator(
            predict_fn, patch_size, num_classes, stride_xy, stride_z,
            patch_batch=patch_batch, device=mesh.device)

    def corners(self, shape) -> np.ndarray:
        """This rank's corners of a (D, H, W) volume, sentinels dropped."""
        _, _, corners = self._plan.plan(tuple(shape))
        world = self.mesh.world
        n = corners.shape[0]
        n_pad = math.ceil(n / world) * world
        if n_pad != n:
            corners = np.concatenate(
                [corners, np.full((n_pad - n, 3), -1, corners.dtype)])
        share = n_pad // world
        mine = corners[self.mesh.rank * share:(self.mesh.rank + 1) * share]
        return mine[mine[:, 0] >= 0]

    def predict_volume(self, image) -> np.ndarray:
        """The label map of one (D, H, W) volume, int32 numpy of its shape,
        on every rank."""
        device = self.mesh.device
        shape = tuple(image.shape)
        extent, offset, _ = self._plan.plan(shape)
        raw = tuple(slice(o, o + s) for o, s in zip(offset, shape))
        volume = torch.zeros(extent, dtype=torch.float32, device=device)
        volume[raw] = torch.as_tensor(image).to(device, torch.float32)
        score = torch.zeros((self.num_classes,) + extent,
                            dtype=torch.float32, device=device)
        cnt = torch.zeros((1,) + extent, dtype=torch.float32, device=device)
        windows = list(self._plan._windows(self.corners(shape)))
        for i in range(0, len(windows), self.patch_batch):
            batch = windows[i:i + self.patch_batch]
            x = torch.stack([volume[w] for w in batch])[:, None]
            probs = self._predict(x).float()
            for k, w in enumerate(batch):
                score[(slice(None),) + w] += probs[k]
                cnt[(slice(None),) + w] += 1.0
        if self.mesh.distributed:
            dist.all_reduce(score, group=self.mesh.group)
            dist.all_reduce(cnt, group=self.mesh.group)
        label = torch.argmax(score / cnt.clamp_min(1e-8), dim=0)[raw]
        return label.to(torch.int32).cpu().numpy()
