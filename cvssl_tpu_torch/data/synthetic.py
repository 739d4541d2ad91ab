"""Synthetic ACDC- and BraTS-style data (port of
``cvssl_tpu/data/synthetic.py``: ``make_synthetic_acdc``,
``make_synthetic_brats`` and the blob generator), and in-memory volume
sets: :func:`blob_volumes` (numpy, the blob generator's draws) and
:class:`DeviceBlobVolumes` (drawn on a device by torch, for sets too large
to draw on the host in time).

The blob generator draws from a numpy ``Generator`` exactly as the JAX
package's does, so the same seed gives the same arrays. ``h5py`` is imported
only where a tree is written.
"""
from __future__ import annotations

import os

import numpy as np
import torch


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


def make_synthetic_brats(root: str, num_train: int = 4, num_val: int = 2,
                         size: int = 32, seed: int = 0, num_test: int = 0
                         ) -> str:
    """BraTS-style tree: data/{name}.h5 volumes (2 classes), train/val/
    test.txt lists (test.txt is the held-out split of the reference's
    test_3D.py:33; with num_test == 0 it lists the val cases). Returns
    root."""
    import h5py
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    lines = {"train": [], "val": [], "test": []}
    for i in range(num_train + num_val + num_test):
        name = f"case_{i:03d}"
        img, lab = blob_image(rng, (size, size, size), 2)
        with h5py.File(os.path.join(root, "data", f"{name}.h5"), "w") as f:
            f.create_dataset("image", data=img)
            f.create_dataset("label", data=lab)
        split = ("train" if i < num_train
                 else "val" if i < num_train + num_val else "test")
        lines[split].append(name)
    if not lines["test"]:
        lines["test"] = list(lines["val"])
    for split, names in lines.items():
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


def blob_volumes(shapes, seed: int = 0, num_classes: int = 2) -> list:
    """In-memory volume samples {"image", "label"} of the given shapes,
    drawn one after another by :func:`blob_image` from one generator of
    ``seed`` (the order ``make_synthetic_brats`` draws its tree in)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        image, label = blob_image(rng, tuple(shape), num_classes)
        out.append({"image": image, "label": label})
    return out


class DeviceBlobVolumes:
    """``n`` blob volumes of ``shape`` drawn on ``device`` by torch, the
    blob generator's recipe: noise N(0.3, 0.1), per foreground class a ball
    of radius max(min(shape) // 6, 2) at a centre in the middle half of
    each axis, +0.2 c inside, clipped to [0, 1]. Volume i comes from a
    generator seeded ``seed + i``, so it is the same each time it is read
    (not the numpy generator's arrays). Samples are a float32 image and a
    uint8 label on the device."""

    def __init__(self, n: int, shape, seed: int = 0, num_classes: int = 2,
                 device="cuda"):
        self.n, self.shape, self.seed = n, tuple(shape), seed
        self.num_classes = num_classes
        self.device = torch.device(device)

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> dict:
        g = torch.Generator(device=self.device).manual_seed(self.seed + i)
        shape, dev = self.shape, self.device
        image = 0.3 + 0.1 * torch.randn(shape, generator=g, device=dev)
        label = torch.zeros(shape, dtype=torch.uint8, device=dev)
        radius = max(min(shape) // 6, 2)
        axes = [torch.arange(s, device=dev) for s in shape]
        for c in range(1, self.num_classes):
            dist = 0
            for ax, (s, a) in enumerate(zip(shape, axes)):
                ctr = torch.randint(s // 4, 3 * s // 4, (), generator=g,
                                    device=dev)
                view = [1] * len(shape)
                view[ax] = s
                dist = dist + ((a - ctr) ** 2).view(view)
            mask = dist <= radius ** 2
            label = torch.where(mask, c, label).to(torch.uint8)
            image = image + 0.2 * c * mask
        return {"image": image.clamp_(0.0, 1.0), "label": label}
