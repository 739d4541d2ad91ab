"""h5 slice and volume datasets + label-budget tables (port of
``cvssl_tpu/data/datasets.py``: ``SliceDataset``, ``VolumeDataset``,
``patients_to_slices`` and the ACDC/Prostate tables).

* ``SliceDataset`` mirrors the reference's ``BaseDataSets``: list files
  ``train_slices.list`` / ``val.list``; train slices at
  ``data/slices/{case}.h5``, val volumes at ``data/{case}.h5``; each h5 holds
  ``image`` and ``label``.
* ``VolumeDataset`` mirrors ``BraTS2019``: list files ``train.txt`` /
  ``val.txt`` / ``test.txt`` (first comma field), volumes at
  ``data/{name}.h5``.
* ``patients_to_slices`` maps a labeled-patient budget to a slice count;
  unknown dataset names raise (the reference's 'Prostate' branch is
  always-true).

Samples are numpy dicts. ``h5py`` is imported where a file is read, so the
package imports where ``h5py`` is not installed.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

ACDC_SLICE_TABLE = {1: 32, 3: 68, 7: 136, 14: 256, 21: 396, 28: 512,
                    35: 664, 140: 1312}
PROSTATE_SLICE_TABLE = {2: 27, 4: 53, 8: 120, 12: 179, 16: 256, 21: 312,
                        42: 623}


def patients_to_slices(dataset: str, patients_num) -> int:
    """Map a labeled-patient budget to a slice count."""
    name = os.path.basename(os.path.normpath(str(dataset))) or str(dataset)
    if "ACDC" in str(dataset):
        table = ACDC_SLICE_TABLE
    elif "Prostate" in str(dataset):
        table = PROSTATE_SLICE_TABLE
    else:
        raise ValueError(f"no slice table for dataset {name!r}")
    return table[int(patients_num)]


def transform_sample(transform: Optional[Callable], sample: dict,
                     ops_weak=None, ops_strong=None) -> dict:
    """The one place a train transform is applied to a sample: with the
    CTAugment policies ``ops_weak`` and ``ops_strong`` (``CTATransform``),
    or without (the other host transforms)."""
    if transform is None:
        return sample
    if ops_weak is not None:
        return transform(sample, ops_weak, ops_strong)
    return transform(sample)


class SliceDataset:
    """2D per-slice dataset (ACDC / Prostate layout). With CTAugment
    policies (``ops_weak`` and ``ops_strong``, both or neither) the
    transform takes them: ``dataset[i]`` applies the dataset's current
    ones, :meth:`load` the ones it is given (the CTA host pipeline's
    loader, which never reads the dataset's)."""

    def __init__(self, base_dir: str, split: str = "train",
                 num: Optional[int] = None,
                 transform: Optional[Callable] = None,
                 ops_weak=None, ops_strong=None):
        if bool(ops_weak) != bool(ops_strong):
            raise ValueError("provide both weak and strong CTAugment policies")
        self.base_dir = base_dir
        self.split = split
        self.transform = transform
        self.ops_weak = ops_weak
        self.ops_strong = ops_strong
        list_file = "train_slices.list" if split == "train" else "val.list"
        with open(os.path.join(base_dir, list_file)) as f:
            self.sample_list = [ln.strip() for ln in f if ln.strip()]
        if num is not None and split == "train":
            self.sample_list = self.sample_list[:num]

    def __len__(self):
        return len(self.sample_list)

    def case_path(self, case: str) -> str:
        sub = "data/slices" if self.split == "train" else "data"
        return os.path.join(self.base_dir, sub, f"{case}.h5")

    def __getitem__(self, idx: int) -> dict:
        return self.load(idx, self.ops_weak, self.ops_strong)

    def load(self, idx: int, ops_weak=None, ops_strong=None) -> dict:
        """Sample ``idx`` through the transform, with the given CTAugment
        policies (None: a transform that takes none)."""
        import h5py
        case = self.sample_list[idx]
        with h5py.File(self.case_path(case), "r") as h5f:
            image = h5f["image"][:]
            label = h5f["label"][:]
        sample = {"image": image.astype(np.float32), "label": label,
                  "case": case}
        sample = transform_sample(self.transform, sample, ops_weak,
                                  ops_strong)
        sample["idx"] = idx
        return sample


class VolumeDataset:
    """3D volume dataset (BraTS2019 layout; reference
    ``brats2019.py:11-46``). ``num`` keeps the first volumes of the list;
    samples are float32 images and uint8 labels of the volume's own shape,
    through the transform if there is one."""

    def __init__(self, base_dir: str, split: str = "train",
                 num: Optional[int] = None,
                 transform: Optional[Callable] = None):
        self.base_dir = base_dir
        self.transform = transform
        # the test split is what the reference's test_3D.py:33 evaluates
        list_file = {"train": "train.txt", "val": "val.txt",
                     "test": "test.txt"}[split]
        with open(os.path.join(base_dir, list_file)) as f:
            self.image_list = [ln.strip().split(",")[0] for ln in f
                               if ln.strip()]
        if num is not None:
            self.image_list = self.image_list[:num]

    def __len__(self):
        return len(self.image_list)

    def case_path(self, name: str) -> str:
        return os.path.join(self.base_dir, "data", f"{name}.h5")

    def __getitem__(self, idx: int) -> dict:
        import h5py
        name = self.image_list[idx]
        with h5py.File(self.case_path(name), "r") as h5f:
            image = h5f["image"][:]
            label = h5f["label"][:]
        sample = {"image": image.astype(np.float32),
                  "label": label.astype(np.uint8), "case": name}
        sample = transform_sample(self.transform, sample)
        sample["idx"] = idx
        return sample
