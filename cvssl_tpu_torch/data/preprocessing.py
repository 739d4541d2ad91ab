"""Offline dataset preprocessing — parity with
``code/dataloaders/acdc_data_processing.py`` and
``code/dataloaders/brats_proprecessing.py``.

NIfTI IO prefers SimpleITK/nibabel when present and otherwise falls back to
the built-in from-scratch NIfTI-1 reader (``utils/nifti.py``) — real
ACDC/BraTS ``.nii.gz`` trees preprocess fully offline. Port of
``cvssl_tpu/data/preprocessing.py``; ``h5py`` is imported only by the
functions that write h5, so the normalisers run where it is absent.
"""
from __future__ import annotations

import glob
import os

import numpy as np


def _is_stub_error(e: Exception) -> bool:
    # tests/reference_shim.py installs import-shape stubs whose callables
    # raise RuntimeError('... stub ...'); only THOSE fall through — a real
    # library's read error (corrupt/unsupported file) propagates, since its
    # diagnostic beats the minimal reader's assertion.
    return isinstance(e, AttributeError) or "stub" in str(e)


def _read_nifti(path: str) -> np.ndarray:
    try:
        import SimpleITK as sitk
        return sitk.GetArrayFromImage(sitk.ReadImage(path))
    except ImportError:
        pass
    except (AttributeError, RuntimeError) as e:
        if not _is_stub_error(e):
            raise
    try:
        import nibabel as nib
        return np.asanyarray(nib.load(path).dataobj).T
    except ImportError:
        pass
    except (AttributeError, RuntimeError) as e:
        if not _is_stub_error(e):
            raise
    # offline fallback: the built-in NIfTI-1 reader (single-file n+1,
    # little-endian — covers standard ACDC/BraTS exports)
    from cvssl_tpu_torch.utils.nifti import load_nifti
    return load_nifti(path)[0]


def minmax_normalize(image: np.ndarray) -> np.ndarray:
    """(image - min) / (max - min) (``acdc_data_processing.py:21``)."""
    lo, hi = image.min(), image.max()
    return ((image - lo) / max(hi - lo, 1e-12)).astype(np.float32)


def brain_bbox(data: np.ndarray, gt: np.ndarray):
    """Crop to the nonzero brain bounding box
    (``brats_proprecessing.py:10-35``)."""
    mask = data != 0
    idx = np.nonzero(mask)
    sl = tuple(slice(int(i.min()), int(i.max()) + 1) for i in idx)
    return data[sl], gt[sl]


def intensity_clip(img: np.ndarray, percent: float = 0.999) -> np.ndarray:
    """Clip above the ``percent`` cumulative-intensity watershed
    (``brats_proprecessing.py:81-95`` valid_img)."""
    values = np.sort(img.ravel())
    watershed = values[min(int(np.ceil(percent * values.size)) - 1,
                           values.size - 1)]
    return np.clip(img, img.min(), watershed)


def intensity_normalize_nonzero(volume: np.ndarray) -> np.ndarray:
    """z-score over the nonzero region (``brats_proprecessing.py:62-78``)."""
    pixels = volume[volume > 0]
    return ((volume - pixels.mean()) / pixels.std()).astype(np.float32)


def process_acdc(image_dir: str, out_dir: str) -> int:
    """NIfTI volumes -> per-slice h5 (min-max normalized, gzip datasets)."""
    import h5py
    os.makedirs(out_dir, exist_ok=True)
    slice_num = 0
    for case in sorted(glob.glob(os.path.join(image_dir, "*.nii.gz"))):
        image = _read_nifti(case)
        msk_path = case.replace("image", "label").replace(".nii.gz",
                                                          "_gt.nii.gz")
        if not os.path.exists(msk_path):
            continue
        mask = _read_nifti(msk_path)
        image = minmax_normalize(image)
        item = os.path.basename(case).split(".")[0]
        for ind in range(image.shape[0]):
            with h5py.File(os.path.join(out_dir,
                                        f"{item}_slice_{ind}.h5"), "w") as f:
                f.create_dataset("image", data=image[ind],
                                 compression="gzip")
                f.create_dataset("label", data=mask[ind], compression="gzip")
            slice_num += 1
    return slice_num


def process_brats_volume(flair: np.ndarray, seg: np.ndarray):
    """bbox crop + 99.9% clip + nonzero z-score + binarize labels
    (``brats_proprecessing.py:97-110``)."""
    img, lab = brain_bbox(flair, seg)
    img = intensity_clip(img, 0.999)
    img = intensity_normalize_nonzero(img)
    lab = (lab > 0).astype(np.uint8)
    return img, lab


def process_brats(flair_dir: str, out_dir: str) -> int:
    """``*_flair.nii.gz`` + ``*_seg.nii.gz`` -> one h5 volume a case."""
    import h5py
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for p in sorted(glob.glob(os.path.join(flair_dir, "*_flair.nii.gz"))):
        img = _read_nifti(p)
        lab = _read_nifti(p.replace("flair", "seg"))
        img, lab = process_brats_volume(img, lab)
        uid = os.path.basename(p).replace("_flair.nii.gz", "")
        with h5py.File(os.path.join(out_dir, f"{uid}.h5"), "w") as f:
            f.create_dataset("image", data=img, compression="gzip")
            f.create_dataset("label", data=lab, compression="gzip")
        n += 1
    return n
