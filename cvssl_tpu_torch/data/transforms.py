"""Host-side augmentations, numpy + scipy: the port's own copy of
``cvssl_tpu/data/transforms.py``. ``build_2d_data`` and ``build_3d_data``
use, in 2D, ``random_rot_flip``, ``random_rotate``, ``zoom_to``,
``color_jitter``, ``RandomGenerator``, ``RandomGeneratorWeak`` and
``WeakStrongAugment``; in 3D ``pad_to_size``, ``CenterCrop``,
``RandomCrop``, ``RandomRotFlip3D``, ``RandomNoise3D``,
``CreateOnehotLabel`` and ``Compose``. No training path calls the strong
transform, ``RandomGeneratorStrong`` with its ``rand_affine`` and
``gaussian_blur``, or ``grid_mask``; they are library functions, as in
JAX.

They mirror the reference transforms of ``code/dataloaders/dataset.py``.
Every stochastic transform takes an explicit ``numpy.random.Generator`` and
makes the same draws in the same order as the JAX package's, so from the
same seed both give the same arrays, bit for bit.

Samples are dicts of images (H, W) or volumes (D, H, W) float32 and
labels of the same shape, int; the channel axis is added at collate time
(``data/pipeline.py``, NCHW / NCDHW).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
from scipy import ndimage


def random_rot_flip(rng: np.random.Generator, image, label=None):
    """rot90 by k ~ U{0..3}, then a flip along axis ~ U{0, 1}
    (``dataset.py:79``)."""
    k = int(rng.integers(0, 4))
    axis = int(rng.integers(0, 2))
    image = np.flip(np.rot90(image, k), axis=axis).copy()
    if label is not None:
        label = np.flip(np.rot90(label, k), axis=axis).copy()
        return image, label
    return image


def random_rotate(rng: np.random.Generator, image, label):
    """Rotate by an angle ~ U{-20..19} degrees, order 0, no reshape
    (``dataset.py:92``)."""
    angle = int(rng.integers(-20, 20))
    image = ndimage.rotate(image, angle, order=0, reshape=False)
    label = ndimage.rotate(label, angle, order=0, reshape=False)
    return image, label


def zoom_to(image, output_size, order: int = 0):
    """scipy zoom to a fixed output size (``dataset.py:421-422``)."""
    x, y = image.shape
    return ndimage.zoom(image, (output_size[0] / x, output_size[1] / y),
                        order=order)


def color_jitter(rng: np.random.Generator, image: np.ndarray) -> np.ndarray:
    """ColorJitter(0.8, 0.8, 0.8, 0.2) on a grayscale image
    (``dataset.py:99-107``): saturation and hue are identities on one
    channel, so it is brightness and contrast in a random order, each
    clamped to [0, 1]."""
    image = image.astype(np.float32)
    ops = [0, 1]
    rng.shuffle(ops)
    for op in ops:
        if op == 0:  # brightness: U(0.2, 1.8), multiplicative
            f = rng.uniform(0.2, 1.8)
            image = np.clip(image * f, 0.0, 1.0)
        else:  # contrast: a blend with the grayscale mean
            f = rng.uniform(0.2, 1.8)
            mean = image.mean()
            image = np.clip(f * image + (1.0 - f) * mean, 0.0, 1.0)
    return image


def rand_affine(rng: np.random.Generator, image: np.ndarray) -> np.ndarray:
    """RandomAffine(degrees=90, translate=(.5, .5), shear=30)
    (``dataset.py:109-115``): a rotation ~ U(-90, 90), a translation of up
    to half the image, an x shear ~ U(-30, 30), nearest neighbour. The
    matrix is torchvision's inverse about the centre, computed as JAX's
    is, term for term: another factoring rounds some pixel choices the
    other way."""
    h, w = image.shape
    angle = rng.uniform(-90, 90)
    max_dx, max_dy = 0.5 * w, 0.5 * h
    tx = float(np.round(rng.uniform(-max_dx, max_dx)))
    ty = float(np.round(rng.uniform(-max_dy, max_dy)))
    shear = rng.uniform(-30, 30)
    rot = math.radians(angle)
    sx = math.radians(shear)
    cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
    a = math.cos(rot - sx) / math.cos(sx)
    b = -math.cos(rot - sx) * math.tan(sx) / math.cos(sx) - math.sin(rot)
    c = math.sin(rot - sx) / math.cos(sx)
    d = -math.sin(rot - sx) * math.tan(sx) / math.cos(sx) + math.cos(rot)
    # output coordinates -> input coordinates, rows then columns
    m = np.array([[d, c], [b, a]], dtype=np.float64)
    center = np.array([cy, cx])
    trans = np.array([ty, tx])
    offset = center - m @ (center + trans)
    return ndimage.affine_transform(image, m, offset=offset, order=0,
                                    mode="constant", cval=0.0)


def gaussian_blur(rng: np.random.Generator, image: np.ndarray) -> np.ndarray:
    """GaussianBlur(kernel_size=3) with sigma ~ U(0.1, 2.0)
    (``dataset.py:117``): torchvision's 3-tap kernel from the Gaussian
    pdf, rows then columns, reflected at the edges."""
    sigma = rng.uniform(0.1, 2.0)
    x = np.array([-1.0, 0.0, 1.0])
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    out = ndimage.correlate1d(image, k, axis=0, mode="reflect")
    return ndimage.correlate1d(out, k, axis=1, mode="reflect")


def grid_mask(rng: np.random.Generator, image: np.ndarray, d1: int = 16,
              d2: int = 32, ratio: float = 0.5, rotate: int = 90,
              prob: float = 0.6) -> np.ndarray:
    """GridMask (``code/gridmask.py:15-107``): with probability ``prob``, a
    rotated regular grid of zeroed squares, period d ~ U{d1..d2}, side
    ceil(d * ratio)."""
    if rng.uniform() > prob:
        return image
    h, w = image.shape
    d = int(rng.integers(d1, d2 + 1))
    ll = int(math.ceil(d * ratio))
    hh = int(math.ceil(1.5 * max(h, w)))
    mask = np.ones((hh, hh), np.float32)
    st = int(rng.integers(0, d))
    for start in range(st, hh, d):
        mask[start:start + ll, :] = 0
    st = int(rng.integers(0, d))
    for start in range(st, hh, d):
        mask[:, start:start + ll] = 0
    if rotate:
        angle = int(rng.integers(0, rotate))
        mask = ndimage.rotate(mask, angle, order=0, reshape=False)
    off_h = (hh - h) // 2
    off_w = (hh - w) // 2
    return image * mask[off_h:off_h + h, off_w:off_w + w]


class RandomGenerator:
    """The default train transform (``dataset.py:406-425``): with
    probability 1/2 rot90 + flip, else with probability 1/2 a rotation of
    up to 20 degrees; then zoom to the patch (order 0)."""

    def __init__(self, output_size: Sequence[int], rng=None):
        self.output_size = tuple(output_size)
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        if self.rng.random() > 0.5:
            image, label = random_rot_flip(self.rng, image, label)
        elif self.rng.random() > 0.5:
            image, label = random_rotate(self.rng, image, label)
        image = zoom_to(image, self.output_size).astype(np.float32)
        label = zoom_to(label, self.output_size).astype(np.int32)
        return {"image": image, "label": label}


class RandomGeneratorWeak:
    """The weak transform, resize only (``RandomGenerator_w``,
    ``dataset.py:196``). It draws nothing."""

    def __init__(self, output_size: Sequence[int], rng=None):
        self.output_size = tuple(output_size)

    def __call__(self, sample):
        image = zoom_to(sample["image"], self.output_size).astype(np.float32)
        label = zoom_to(sample["label"], self.output_size).astype(np.int32)
        return {"image": image, "label": label}


class RandomGeneratorStrong:
    """The strong transform (``RandomGenerator_s``, ``dataset.py:377-403``):
    :class:`RandomGenerator`'s geometry and zoom, then color jitter, the
    random affine and the blur on the image (the grayscale step is an
    identity on one channel)."""

    def __init__(self, output_size: Sequence[int], rng=None):
        self.output_size = tuple(output_size)
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        image, label = sample["image"], sample["label"]
        if self.rng.random() > 0.5:
            image, label = random_rot_flip(self.rng, image, label)
        elif self.rng.random() > 0.5:
            image, label = random_rotate(self.rng, image, label)
        image = zoom_to(image, self.output_size).astype(np.float32)
        label = zoom_to(label, self.output_size).astype(np.int32)
        image = color_jitter(self.rng, image)
        image = rand_affine(self.rng, image)
        image = gaussian_blur(self.rng, image).astype(np.float32)
        return {"image": image, "label": label}


class WeakStrongAugment:
    """FixMatch's transform (``dataset.py:211-245``): resize; weak =
    rot90 + flip; strong = color jitter of the weak view. Returns image,
    image_weak, image_strong, label_aug and label."""

    def __init__(self, output_size: Sequence[int], rng=None):
        self.output_size = tuple(output_size)
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        image = zoom_to(sample["image"], self.output_size).astype(np.float32)
        label = zoom_to(sample["label"], self.output_size).astype(np.int32)
        image_weak, label = random_rot_flip(self.rng, image, label)
        image_strong = color_jitter(self.rng, image_weak).astype(np.float32)
        return {"image": image, "image_weak": image_weak.astype(np.float32),
                "image_strong": image_strong, "label_aug": label,
                "label": label}


# ---------------------------------------------------------------------------
# 3D (the BraTS recipe, ``brats2019.py:48-188``)
# ---------------------------------------------------------------------------

def pad_pads(shape: Sequence[int], output_size: Sequence[int],
             extra: int = 3):
    """The reference's pad rule (``brats2019.py:97-108``): if any axis is
    at most its target, every axis is padded by (target - dim) // 2 + 3 on
    both sides (none where that is negative); else no padding. Returns the
    per-axis pad, or None."""
    if not any(shape[i] <= output_size[i] for i in range(3)):
        return None
    return [max((output_size[i] - shape[i]) // 2 + extra, 0)
            for i in range(3)]


def pad_to_size(arr: np.ndarray, output_size: Sequence[int]) -> np.ndarray:
    """``arr`` zero-padded by :func:`pad_pads`. JAX:
    ``transforms._pad_to_size``."""
    pads = pad_pads(arr.shape, output_size)
    if pads is None:
        return arr
    return np.pad(arr, [(p, p) for p in pads], mode="constant",
                  constant_values=0)


class CenterCrop:
    """Pad by the reference rule, then the centred crop
    (``brats2019.py:48-77``)."""

    def __init__(self, output_size: Sequence[int]):
        self.output_size = tuple(output_size)

    def __call__(self, sample):
        image = pad_to_size(sample["image"], self.output_size)
        label = pad_to_size(sample["label"], self.output_size)
        starts = [int(round((image.shape[i] - self.output_size[i]) / 2.0))
                  for i in range(3)]
        sl = tuple(slice(s, s + o) for s, o in zip(starts, self.output_size))
        return {"image": image[sl], "label": label[sl]}


class RandomCrop:
    """Pad by the reference rule, then a crop at a corner drawn per axis
    from [0, dim - target) (``brats2019.py:80-128``; the reference's
    exclusive upper bound, so the last corner is never drawn)."""

    def __init__(self, output_size: Sequence[int], with_sdf: bool = False,
                 rng=None):
        self.output_size = tuple(output_size)
        self.with_sdf = with_sdf
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        image = pad_to_size(sample["image"], self.output_size)
        label = pad_to_size(sample["label"], self.output_size)
        starts = [int(self.rng.integers(0, image.shape[i]
                                        - self.output_size[i]))
                  for i in range(3)]
        sl = tuple(slice(s, s + o) for s, o in zip(starts, self.output_size))
        out = {"image": image[sl], "label": label[sl]}
        if self.with_sdf:
            out["sdf"] = pad_to_size(sample["sdf"], self.output_size)[sl]
        return out


class RandomRotFlip3D:
    """rot90 by k ~ U{0..3} in the first two axes, then a flip along axis
    ~ U{0, 1} (``brats2019.py:131-148``)."""

    def __init__(self, rng=None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        image, label = random_rot_flip(self.rng, sample["image"],
                                       sample["label"])
        return {"image": image, "label": label}


class RandomNoise3D:
    """Additive noise clip(sigma N(0, 1), -2 sigma, 2 sigma) + mu
    (``brats2019.py:150-162``)."""

    def __init__(self, mu: float = 0.0, sigma: float = 0.1, rng=None):
        self.mu, self.sigma = mu, sigma
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample):
        image = sample["image"]
        noise = np.clip(self.sigma * self.rng.standard_normal(image.shape),
                        -2 * self.sigma, 2 * self.sigma) + self.mu
        return {"image": image + noise, "label": sample["label"]}


class CreateOnehotLabel:
    """The one-hot label beside the sample's keys (``brats2019.py:164-175``),
    class axis first, (C, D, H, W), as the port's NCDHW layout has it (JAX's
    is last)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def __call__(self, sample):
        label = sample["label"]
        onehot = np.stack([(label == i).astype(np.float32)
                           for i in range(self.num_classes)])
        return {**sample, "onehot_label": onehot}


class Compose:
    """Sequential composition (torchvision ``Compose``,
    ``train_mean_teacher_3D.py:98-101``)."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample
