"""Host-side 2D augmentations, numpy + scipy (the port's own copy of the 2D
transforms of ``cvssl_tpu/data/transforms.py`` that ``build_2d_data``
uses: ``random_rot_flip``, ``random_rotate``, ``zoom_to``, ``color_jitter``,
``RandomGenerator``, ``RandomGeneratorWeak`` and ``WeakStrongAugment``).

They mirror the reference transforms of ``code/dataloaders/dataset.py``.
Every stochastic transform takes an explicit ``numpy.random.Generator`` and
makes the same draws in the same order as the JAX package's, so from the
same seed both give the same arrays, bit for bit.

Samples are dicts of 2D images (H, W) float32 and labels (H, W) int; the
channel axis is added at collate time (``data/pipeline.py``, NCHW).
"""
from __future__ import annotations

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
