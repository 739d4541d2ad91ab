"""Synthetic ACDC-style data (port of ``cvssl_tpu/data/synthetic.py``:
``make_synthetic_acdc`` and the blob generator; the BraTS tree waits for the
3D slice).

The blob generator draws from a numpy ``Generator`` exactly as the JAX
package's does, so the same seed gives the same arrays. ``h5py`` is imported
only where a tree is written.
"""
from __future__ import annotations

import os

import numpy as np


def blob_image(rng, shape, num_classes):
    """Image with class-correlated blobs so training can actually learn:
    one disc (ball) per foreground class, intensity +0.2 per class on
    N(0.3, 0.1) noise, clipped to [0, 1]. Returns (float32 image, uint8
    label)."""
    label = np.zeros(shape, np.uint8)
    image = rng.normal(0.3, 0.1, shape).astype(np.float32)
    for c in range(1, num_classes):
        center = [rng.integers(s // 4, 3 * s // 4) for s in shape]
        radius = max(min(shape) // 6, 2)
        grids = np.ogrid[tuple(slice(0, s) for s in shape)]
        dist = sum((g - ctr) ** 2 for g, ctr in zip(grids, center))
        mask = dist <= radius ** 2
        label[mask] = c
        image[mask] += 0.2 * c
    image = np.clip(image, 0, 1)
    return image, label


def make_synthetic_acdc(root: str, num_cases: int = 8,
                        slices_per_case: int = 4, num_val: int = 2,
                        size: int = 64, num_classes: int = 4,
                        seed: int = 0) -> str:
    """ACDC-style tree: data/slices/{case}_slice_{i}.h5 (2D), data/{case}.h5
    (3D stack for val), train_slices.list, val.list. Returns root."""
    import h5py
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "data", "slices"), exist_ok=True)
    train_lines, val_lines = [], []
    for ci in range(num_cases):
        case = f"patient{ci:03d}"
        vol_img, vol_lab = [], []
        for si in range(slices_per_case):
            img, lab = blob_image(rng, (size, size), num_classes)
            vol_img.append(img)
            vol_lab.append(lab)
            name = f"{case}_slice_{si}"
            with h5py.File(os.path.join(root, "data", "slices",
                                        f"{name}.h5"), "w") as f:
                f.create_dataset("image", data=img)
                f.create_dataset("label", data=lab)
            train_lines.append(name)
        with h5py.File(os.path.join(root, "data", f"{case}.h5"), "w") as f:
            f.create_dataset("image", data=np.stack(vol_img))
            f.create_dataset("label", data=np.stack(vol_lab))
        if ci < num_val:
            val_lines.append(case)
    with open(os.path.join(root, "train_slices.list"), "w") as f:
        f.write("\n".join(train_lines) + "\n")
    with open(os.path.join(root, "val.list"), "w") as f:
        f.write("\n".join(val_lines) + "\n")
    return root
