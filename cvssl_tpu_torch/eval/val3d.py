"""3D sliding-window inference and evaluation (port of
``cvssl_tpu/eval/val3d.py``; parity with ``code/val_3D.py`` and
``code/test_3D_util.py``).

A volume (x, y, z) is the port's (D, H, W). The reference pads it
symmetrically to at least the patch on each axis (the raw volume at offset
(S - s) // 2 of the padded extent S), walks a corner grid of
ceil((S - patch) / stride) + 1 corners per axis with the last clamped to
S - patch (stride_xy on the first two axes, stride_z on the last), adds
each window's softmax into a score map and a count map, and takes the
argmax of score / count, cropped back to the raw volume.

On the card the volume, the score map (C, D, H, W) float32 and the count
map stay resident: the host slices batches of ``patch_batch`` windows at
its own integer corners (no round trip), the predictor runs each batch,
and the count map, a function of the corner set only, is cached per
(extent, corners). The label map is copied to pinned host memory behind
an event, so :meth:`SlidingWindowEvaluator.predict_volume_async` returns
while the card still works: :func:`test_all_case` queues volume i + 1
before it scores volume i on the host (HD95's EDT is host work). The JAX
package's 16-voxel shape buckets and bit-packed binary maps served its
compiler and its device-to-host link; the label maps do not depend on
them, and they are dropped here. JAX also fills the last batch of windows
with copies of the last window, which then counts more than once in the
mean wherever another window overlaps it; here each window counts once,
as in the reference (the two agree where every window predicts a voxel
alike, as for a net that thresholds each voxel).

A predictor takes a float32 (B, 1, pd, ph, pw) tensor on the card and
returns (B, C, pd, ph, pw) float32 probabilities (``Engine.predict_probs``);
with ``predict_takes_args`` it is ``predict_fn(args, x)``, with the
arguments given per volume (the engine passes the model, so one cached
evaluator serves every validation of a run).
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cvssl_tpu_torch.ops import metrics as M
from cvssl_tpu_torch.utils import tracing


def _grid_1d(dim: int, patch: int, stride: int) -> np.ndarray:
    """Corner positions on one axis: stride steps, the last clamped so that
    its window fits (reference ``val_3D.py:42-47,52-56``)."""
    n = math.ceil((dim - patch) / stride) + 1 if dim > patch else 1
    return np.asarray([min(i * stride, dim - patch) for i in range(n)],
                      np.int64)


def compute_corners(shape, patch_size, stride_xy: int, stride_z: int
                    ) -> np.ndarray:
    """(N, 3) window corners over an extent ``shape``: stride_xy on the
    first two axes, stride_z on the last (``val_3D.py:42-44``). JAX:
    ``val3d.compute_corners``."""
    xs = _grid_1d(shape[0], patch_size[0], stride_xy)
    ys = _grid_1d(shape[1], patch_size[1], stride_xy)
    zs = _grid_1d(shape[2], patch_size[2], stride_z)
    return np.stack(np.meshgrid(xs, ys, zs, indexing="ij"),
                    axis=-1).reshape(-1, 3)


def gaussian_importance_map(patch_size, sigma_scale: float = 1.0 / 8
                            ) -> np.ndarray:
    """nnUNet's Gaussian window weighting (``neural_network.py:274-290``):
    a centred Gaussian of sigma = patch * sigma_scale, max-normalised, its
    zeros raised to the smallest nonzero value. float32."""
    from scipy.ndimage import gaussian_filter
    tmp = np.zeros(patch_size)
    tmp[tuple(s // 2 for s in patch_size)] = 1
    g = gaussian_filter(tmp, [s * sigma_scale for s in patch_size],
                        mode="constant", cval=0)
    g = g / g.max()
    g[g == 0] = g[g != 0].min()
    return g.astype(np.float32)


def mirror_tta(predict_fn: Callable, mirror_axes: Sequence[int]):
    """nnUNet's mirroring test-time augmentation
    (``neural_network.py:96,146-151``): the mean of the predictions over
    all 2^len(mirror_axes) flips of the window, each flipped back.
    ``mirror_axes`` index the window's spatial axes (0, 1, 2); inputs and
    outputs are (B, C, *spatial)."""
    combos = [c for r in range(len(mirror_axes) + 1)
              for c in itertools.combinations(tuple(mirror_axes), r)]

    def fn(x):
        acc = None
        for combo in combos:
            dims = tuple(a + 2 for a in combo)
            xm = torch.flip(x, dims) if combo else x
            p = predict_fn(xm)
            p = torch.flip(p, dims) if combo else p
            acc = p if acc is None else acc + p
        return acc / len(combos)
    return fn


class SlidingWindowEvaluator:
    """The sliding window over volumes of any shape, for one predictor,
    patch and stride; it keeps the count maps of the corner sets it has
    seen (at most 8). ``gaussian`` weights each window's probabilities
    (and counts) by :func:`gaussian_importance_map`; ``mirror_axes`` turns
    on :func:`mirror_tta`. The volume, the maps and the window batches
    live on ``device``: the card unless the caller asks for the CPU."""

    def __init__(self, predict_fn: Callable, patch_size: Sequence[int],
                 num_classes: int, stride_xy: int, stride_z: int,
                 patch_batch: int = 6, gaussian: bool = False,
                 mirror_axes: Optional[Sequence[int]] = None,
                 predict_takes_args: bool = False, device="cuda"):
        self.patch_size = tuple(int(p) for p in patch_size)
        self.num_classes = num_classes
        self.stride_xy, self.stride_z = stride_xy, stride_z
        self.patch_batch = patch_batch
        self.device = torch.device(device)
        pf = predict_fn if predict_takes_args else (
            lambda args, x: predict_fn(x))
        if mirror_axes:
            base = pf

            def pf(args, x):
                return mirror_tta(lambda xx: base(args, xx), mirror_axes)(x)
        self._predict = pf
        self._weight = None if not gaussian else torch.from_numpy(
            gaussian_importance_map(self.patch_size)).to(self.device)
        self._cnt_cache = {}
        self._last = None        # (predict_args, windows) of the last volume

    def plan(self, shape):
        """The reference's extent S = max(s, patch) per axis, the raw
        volume's offset (S - s) // 2 in it, and the corners over S (clamped
        so that every voxel is covered, even at a stride above the patch).
        Returns (extent, offset, corners)."""
        extent = tuple(max(int(s), p) for s, p in zip(shape, self.patch_size))
        offset = tuple((e - int(s)) // 2 for e, s in zip(extent, shape))
        corners = compute_corners(extent, self.patch_size, self.stride_xy,
                                  self.stride_z)
        return extent, offset, corners

    def _windows(self, corners):
        pd, ph, pw = self.patch_size
        for c in corners:
            d, h, w = (int(v) for v in c)
            yield (slice(d, d + pd), slice(h, h + ph), slice(w, w + pw))

    def _count(self, extent, corners) -> torch.Tensor:
        """Per-voxel window coverage (1, *extent), or the sum of the
        Gaussian weights; cached per (extent, corners)."""
        key = (extent, corners.tobytes())
        cnt = self._cnt_cache.get(key)
        if cnt is None:
            cnt = torch.zeros((1,) + extent, dtype=torch.float32,
                              device=self.device)
            add = 1.0 if self._weight is None else self._weight
            for win in self._windows(corners):
                cnt[(slice(None),) + win] += add
            if len(self._cnt_cache) >= 8:
                self._cnt_cache.pop(next(iter(self._cnt_cache)))
            self._cnt_cache[key] = cnt
        return cnt

    def predict_volume_async(self, image, predict_args=()):
        """Queue the sliding window for one (D, H, W) volume and return a
        collector that gives its label map, int32 numpy of the volume's
        shape; the card works on while the caller does other host work.
        The hand-over is the host span ``val3d.predict``; in it each batch
        of windows is stacked and added into the score map in spans
        ``val3d.accumulate`` and predicted in a span ``val3d.forward``
        (``utils/tracing.py``)."""
        with tracing.span("val3d.predict"):
            return self._queue(image, predict_args)

    def _queue(self, image, predict_args):
        shape = tuple(image.shape)
        extent, offset, corners = self.plan(shape)
        raw = (slice(None),) + tuple(slice(o, o + s)
                                     for o, s in zip(offset, shape))
        volume = torch.zeros((1,) + extent, dtype=torch.float32,
                             device=self.device)
        volume[raw] = torch.as_tensor(image).to(self.device, torch.float32)
        cnt = self._count(extent, corners)
        score = torch.zeros((self.num_classes,) + extent,
                            dtype=torch.float32, device=self.device)
        windows = list(self._windows(corners))
        self._last = (predict_args, len(windows))
        for i in range(0, len(windows), self.patch_batch):
            batch = windows[i:i + self.patch_batch]
            with tracing.span("val3d.accumulate"):
                x = torch.stack([volume[(slice(None),) + w] for w in batch])
            with tracing.span("val3d.forward"):
                probs = self._predict(predict_args, x).float()
            with tracing.span("val3d.accumulate"):
                if self._weight is not None:
                    probs = probs * self._weight
                for k, w in enumerate(batch):
                    score[(slice(None),) + w] += probs[k]
        label = torch.argmax(score / cnt, dim=0).to(torch.uint8)[raw[1:]]
        if self.device.type != "cuda":
            out = label.numpy()
            return lambda: out.astype(np.int32)
        host = torch.empty(label.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(label, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def collect() -> np.ndarray:
            done.synchronize()
            return host.numpy().astype(np.int32)
        return collect

    def predict_volume(self, image, predict_args=()) -> np.ndarray:
        """The label map of one (D, H, W) volume."""
        return self.predict_volume_async(image, predict_args)()

    def last_flops(self):
        """Model FLOPs of the last volume's sliding window: the count
        (``utils/mfu.py::count_flops``) of one forward of a window batch of
        ``(patch_batch, 1, *patch)`` times the full batches, plus one of
        the last, smaller batch where there is one (JAX fills that batch to
        ``patch_batch``). The score and count maps' adds are not counted.
        Runs the forwards once more. None before any volume. JAX:
        ``SlidingWindowEvaluator.last_flops``."""
        if self._last is None:
            return None
        from cvssl_tpu_torch.utils.mfu import count_flops
        args, windows = self._last

        def batch_flops(b):
            x = torch.zeros((b, 1) + self.patch_size, dtype=torch.float32,
                            device=self.device)
            with torch.no_grad():
                return count_flops(self._predict, args, x)

        full, rest = divmod(windows, self.patch_batch)
        total = 0.0
        for n, b in ((full, self.patch_batch), (int(rest > 0), rest)):
            if n:
                f = batch_flops(b)
                if f is None:
                    return None
                total += n * f
        return total


def tiled_predict_2d(predict_fn, image: np.ndarray, patch_size,
                     num_classes: int, stride: int, gaussian: bool = True,
                     mirror: bool = False, device="cuda") -> np.ndarray:
    """nnUNet's 2D tiled prediction (``neural_network.py:190,261-265``):
    Gaussian-weighted tiles, optionally mirrored in the plane, through the
    3D evaluator on a volume of depth 1. ``predict_fn``: (B, 1, ph, pw) ->
    (B, C, ph, pw) probabilities; ``image`` (H, W)."""
    def pf3(x):                     # (B, 1, 1, ph, pw) -> (B, C, 1, ph, pw)
        return predict_fn(x[:, :, 0])[:, :, None]
    ev = SlidingWindowEvaluator(
        pf3, (1, *tuple(patch_size)), num_classes, stride_xy=stride,
        stride_z=stride, gaussian=gaussian,
        mirror_axes=(1, 2) if mirror else None, device=device)
    return ev.predict_volume(np.asarray(image)[None])[0]


def _scored(evaluator, dataset, predict_args):
    """(sample, label map) of each volume in order, volume i + 1 queued on
    the card before volume i's map is collected."""
    pending = None
    for i in range(len(dataset) + 1):
        nxt = None
        if i < len(dataset):
            sample = dataset[i]
            nxt = (evaluator.predict_volume_async(sample["image"],
                                                  predict_args), sample)
        if pending is not None:
            collect, sample_p = pending
            yield sample_p, collect()
        pending = nxt


def test_all_case(predict_fn, dataset, num_classes: int = 2,
                  patch_size=(96, 96, 96), stride_xy: int = 64,
                  stride_z: int = 64, evaluator=None,
                  predict_args=(), device="cuda") -> np.ndarray:
    """Mean (dice, hd95) per foreground class over a volume dataset,
    (classes - 1, 2): each class adds its dc and hd95 where both the
    prediction and the label hold it, and the sum is divided by the number
    of volumes (reference ``val_3D.test_all_case``, ``val_3D.py:91-107``).
    ``evaluator``/``predict_args``: the engine's cached evaluator and the
    model it predicts with."""
    ev = evaluator or SlidingWindowEvaluator(
        predict_fn, patch_size, num_classes, stride_xy, stride_z,
        device=device)
    total = np.zeros((num_classes - 1, 2))
    for sample, pred in _scored(ev, dataset, predict_args):
        label = np.asarray(sample["label"])
        for c in range(1, num_classes):
            p, g = pred == c, label == c
            if p.sum() > 0 and g.sum() > 0:
                total[c - 1] += [M.dc(p, g), M.hd95(p, g)]
    return total / len(dataset)


def test_all_case_full_metrics(predict_fn, dataset, num_classes: int = 2,
                               patch_size=(96, 96, 96), stride_xy: int = 64,
                               stride_z: int = 64, export_dir=None,
                               device="cuda", times=None):
    """Per-case (dice, ravd, hd95, asd) of each foreground class (zeros
    where the prediction or the label lacks it) and their mean over the
    cases: (rows (cases, classes - 1, 4), mean) (reference
    ``test_3D_util.test_all_case``, ``test_3D_util.py:91-152``). With
    ``export_dir`` each case is written as ``{id}_pred.nii.gz`` (uint8),
    ``{id}_img.nii.gz`` (float32) and ``{id}_lab.nii.gz`` (uint8), spacing
    (1, 1, 1) (``test_3D_util.py:111-124``; ``utils/nifti.py``, the bytes
    JAX's writer gives), ``id`` the sample's ``case`` or its index. Volume
    i is scored and exported on the host while the card runs volume i + 1.
    ``times``: a dict that gains the host's seconds waiting for the card
    (``predict``), scoring (``metrics``) and writing (``export``), from
    the host spans ``test_3d.predict``, ``test_3d.metrics`` and
    ``test_3d.export`` (``utils/tracing.py``)."""
    import os
    ev = SlidingWindowEvaluator(predict_fn, patch_size, num_classes,
                                stride_xy, stride_z, device=device)
    if times is not None:
        for k in ("predict", "metrics", "export"):
            times.setdefault(k, 0.0)
    scored = _scored(ev, dataset, ())
    rows = []
    for idx in range(len(dataset)):
        with tracing.span("test_3d.predict", times):
            sample, pred = next(scored)
        with tracing.span("test_3d.metrics", times):
            label = np.asarray(sample["label"])
            case = []
            for c in range(1, num_classes):
                p, g = pred == c, label == c
                if p.sum() > 0 and g.sum() > 0:
                    case.append(M.calculate_metric_percase_3d(p, g))
                else:
                    case.append((0.0, 0.0, 0.0, 0.0))
            rows.append(np.asarray(case))
        if export_dir is not None:
            with tracing.span("test_3d.export", times):
                from cvssl_tpu_torch.utils.nifti import save_nifti
                os.makedirs(export_dir, exist_ok=True)
                ids = sample.get("case", idx)
                save_nifti(os.path.join(export_dir, f"{ids}_pred.nii.gz"),
                           pred.astype(np.uint8))
                save_nifti(os.path.join(export_dir, f"{ids}_img.nii.gz"),
                           np.asarray(sample["image"], np.float32))
                save_nifti(os.path.join(export_dir, f"{ids}_lab.nii.gz"),
                           label.astype(np.uint8))
    rows = np.asarray(rows)
    return rows, rows.mean(axis=0)
