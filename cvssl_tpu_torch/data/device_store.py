"""Device-resident datasets + in-step augmentation (port of
``cvssl_tpu/data/device_store.py``: ``DeviceSliceStore`` in
``mode="default"`` with ``gather_augment``, in ``mode="weak"`` with
``gather_weak`` (resize only), and in ``mode="weak_strong"`` with
``gather_weak_strong``, FixMatch's weak and strong views; and the 3D
``DeviceVolumeStore`` with ``gather_crop_rotflip``).

All train slices live on the card, pre-zoomed to the patch size; per step
only the batch indices cross from the host. The reference's RandomGenerator
(50% rot90+flip, else 50% rotate by an integer angle in [-20, 20)) runs on
the device, batched, with the JAX package's exact three-shear rotation, so
the same indices and draws give the same batch as JAX, bit for bit.

The random draws come from a ``torch.Generator`` (:func:`draw_augment`,
:func:`draw_weak_strong`, :func:`draw_crop_rotflip`) and enter the gather
functions as tensors, so a test can inject them.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from cvssl_tpu_torch.data.transforms import pad_pads

_MAX_ANGLE = 20
# the JAX store's modes
STORE_MODES = ("default", "weak", "weak_strong")


class DeviceSliceStore:
    """All train slices resident on ``device``, pre-zoomed (order 0) to
    ``patch_size``: images in ``image_dtype``, labels uint8. ``mode``
    "default" gives every batch the RandomGenerator augmentation, "weak"
    none (the reference's resize-only ``RandomGenerator_w``,
    ``dataset.py:196``), "weak_strong" FixMatch's WeakStrongAugment
    (``dataset.py:211-245``)."""

    def __init__(self, dataset, patch_size: Tuple[int, int],
                 image_dtype=torch.bfloat16, device="cuda",
                 mode: str = "default"):
        if mode not in STORE_MODES:
            raise ValueError(f"no store mode {mode!r}; the modes: "
                             f"{STORE_MODES}")
        self.mode = mode
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceSliceStore: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        n = len(dataset)
        h, w = patch_size
        images = np.zeros((n, h, w), np.float32)
        labels = np.zeros((n, h, w), np.uint8)
        for i in range(n):
            sample = dataset[i]
            img, lab = sample["image"], sample["label"]
            zh, zw = h / img.shape[0], w / img.shape[1]
            images[i] = ndimage.zoom(img, (zh, zw), order=0)
            labels[i] = ndimage.zoom(lab, (zh, zw), order=0)
        self.images = torch.from_numpy(images).to(device=device,
                                                  dtype=image_dtype)
        self.labels = torch.from_numpy(labels).to(device)
        self.patch_size = tuple(patch_size)

    def arrays(self):
        return (self.images, self.labels)

    def batch_fn(self, arrays, indices: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
        images, labels = arrays
        if self.mode == "weak_strong":
            draws = draw_weak_strong(indices.shape[0], generator,
                                     images.device)
            return gather_weak_strong(images, labels, indices, draws)
        if self.mode == "weak":
            return gather_weak(images, labels, indices)
        draws = draw_augment(indices.shape[0], generator, images.device)
        return gather_augment(images, labels, indices, draws)


def draw_augment(b: int, generator: Optional[torch.Generator],
                 device) -> Dict[str, torch.Tensor]:
    """The per-sample draws of one augmented batch: u1, u2 ~ U[0, 1),
    k in {0..3}, axis in {0, 1}, aidx in [0, 40) (angle = aidx - 20)."""
    def randint(high):
        return torch.randint(0, high, (b,), generator=generator,
                             device=device)
    return {"u1": torch.rand(b, generator=generator, device=device),
            "u2": torch.rand(b, generator=generator, device=device),
            "k": randint(4), "axis": randint(2),
            "aidx": randint(2 * _MAX_ANGLE)}


def _rot90_k(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-sample rot90 of (B, H, W) by k (B,) in {0..3} (square images),
    in numpy's direction."""
    out = x
    for r in (1, 2, 3):
        out = torch.where((k == r)[:, None, None],
                          torch.rot90(x, r, dims=(1, 2)), out)
    return out


def _flip_axis(x: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Per-sample flip of (B, H, W): rows where axis == 0, else columns."""
    return torch.where((axis == 0)[:, None, None], x.flip(1), x.flip(2))


@functools.lru_cache(maxsize=None)
def _shear_tables(h: int, w: int):
    """Integer shift vectors of the three shears for every angle in
    [-20, 20): (row_shift (40, h), col_shift (40, w)) as numpy int32;
    shears 1 and 3 share row_shift. Same numpy arithmetic as the JAX
    package, so the same tables."""
    angles = np.arange(-_MAX_ANGLE, _MAX_ANGLE)
    phi = angles * np.pi / 180.0
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ii = np.arange(h) - cy
    jj = np.arange(w) - cx
    a = -np.tan(phi / 2.0)[:, None]
    b = np.sin(phi)[:, None]
    row = np.round(a * ii[None, :]).astype(np.int32)
    col = np.round(b * jj[None, :]).astype(np.int32)
    return row, col


@functools.lru_cache(maxsize=8)
def _shear_tables_on(h: int, w: int, device: torch.device):
    """:func:`_shear_tables` as int64 on ``device``, cached; on the card
    copied from pinned memory without blocking the host, so that a step
    that builds them makes no synchronising call."""
    out = []
    for table in _shear_tables(h, w):
        t = torch.from_numpy(table.astype(np.int64))
        if torch.device(device).type == "cuda":
            t = t.pin_memory()
        out.append(t.to(device, non_blocking=True))
    return tuple(out)


def _cyclic_shift(arrs, s: torch.Tensor, axis: int):
    """Per-row/column cyclic shift: out[..., j] = a[..., (j + s) mod N]
    along ``axis`` (2: shift columns, one amount per (b, i); 1: shift rows,
    one amount per (b, j)). One gather per array: on the card a gather is
    a single coalesced pass (the TPU's roll-per-bit decomposition exists
    because TPU gathers are slow); the result is the same permutation."""
    n = arrs[0].shape[axis]
    if axis == 2:
        idx = torch.arange(n, device=s.device)[None, None, :] + s[:, :, None]
    else:
        idx = torch.arange(n, device=s.device)[None, :, None] + s[:, None, :]
    idx = (idx % n).expand(arrs[0].shape)
    return [torch.gather(a, axis, idx) for a in arrs]


def _shift_cols(arrs, valids, s):
    """out[b, i, j] = arr[b, i, j + s[b, i]] with zero fill (horizontal
    shear); ``valids`` (B, H, W) is sheared alongside."""
    w = arrs[0].shape[2]
    j_s = torch.arange(w, device=s.device)[None, None, :] + s[:, :, None]
    inb = (j_s >= 0) & (j_s < w)
    shifted = _cyclic_shift(list(arrs) + [valids], s, axis=2)
    outs = [torch.where(inb, a, 0) for a in shifted[:-1]]
    return outs, inb & shifted[-1]


def _shift_rows(arrs, valids, s):
    """out[b, i, j] = arr[b, i + s[b, j], j] with zero fill (vertical
    shear)."""
    h = arrs[0].shape[1]
    i_s = torch.arange(h, device=s.device)[None, :, None] + s[:, None, :]
    inb = (i_s >= 0) & (i_s < h)
    shifted = _cyclic_shift(list(arrs) + [valids], s, axis=1)
    outs = [torch.where(inb, a, 0) for a in shifted[:-1]]
    return outs, inb & shifted[-1]


def _rotate_shear3(img: torch.Tensor, lab: torch.Tensor,
                   angle_idx: torch.Tensor):
    """Batched nearest rotation of (B, H, W) images and labels by per-sample
    integer angles (angle_idx - 20 degrees) via three shears (Paeth), zero
    fill outside the source frame. JAX: ``device_store._rotate_shear3``."""
    b, h, w = img.shape
    row_t, col_t = _shear_tables_on(h, w, img.device)
    srow = row_t[angle_idx]                       # (B, H)
    scol = col_t[angle_idx]                       # (B, W)
    valid = torch.ones((b, h, w), dtype=torch.bool, device=img.device)
    (i1, l1), v1 = _shift_cols((img, lab), valid, srow)
    (i2, l2), v2 = _shift_rows((i1, l1), v1, scol)
    (i3, l3), v3 = _shift_cols((i2, l2), v2, srow)
    return torch.where(v3, i3, 0), torch.where(v3, l3, 0)


def gather_augment(images: torch.Tensor, labels: torch.Tensor,
                   indices: torch.Tensor, draws: Dict[str, torch.Tensor]):
    """Batch assembly: gather rows, per-sample augmentation from ``draws``,
    NCHW float32 image + int32 label.

    If u1 > .5: rot90(k) then flip(axis); elif u2 > .5: rotate by
    aidx - 20 degrees; else unchanged (reference ``dataset.py:415-419``).
    Every variant is computed for the whole batch and selected per sample;
    the ops are value-exact in the storage dtypes (bf16 image, uint8 label)
    and cast once at the end. JAX: ``device_store.gather_augment``."""
    img = images[indices]
    lab = labels[indices]
    rf_i = _flip_axis(_rot90_k(img, draws["k"]), draws["axis"])
    rf_l = _flip_axis(_rot90_k(lab, draws["k"]), draws["axis"])
    rot_i, rot_l = _rotate_shear3(img, lab, draws["aidx"])
    c1 = (draws["u1"] > 0.5)[:, None, None]
    c2 = (draws["u2"] > 0.5)[:, None, None]
    img = torch.where(c1, rf_i, torch.where(c2, rot_i, img))
    lab = torch.where(c1, rf_l, torch.where(c2, rot_l, lab))
    # rot90 views leave transposed strides behind; the batch is contiguous
    contiguous = torch.contiguous_format
    return {"image": img.to(torch.float32, memory_format=contiguous)[:, None],
            "label": lab.to(torch.int32, memory_format=contiguous),
            "idx": indices.to(torch.int32)}


def gather_weak(images: torch.Tensor, labels: torch.Tensor,
                indices: torch.Tensor):
    """Batch assembly without augmentation and without draws: gather rows,
    NCHW float32 image + int32 label. JAX: ``device_store.gather_augment``
    with ``augment=False``."""
    return {"image": images[indices].to(torch.float32)[:, None],
            "label": labels[indices].to(torch.int32),
            "idx": indices.to(torch.int32)}


# ---------------------------------------------------------------------------
# weak_strong mode (FixMatch). JAX: ``device_store.py:239-281``.
# ---------------------------------------------------------------------------

def draw_weak_strong(b: int, generator: Optional[torch.Generator],
                     device) -> Dict[str, torch.Tensor]:
    """The per-sample draws of one weak/strong batch: k in {0..3}, axis in
    {0, 1}, brightness and contrast factors bf, cf ~ U[0.2, 1.8), and the
    jitter order ~ U[0, 1)."""
    def randint(high):
        return torch.randint(0, high, (b,), generator=generator,
                             device=device)

    def uniform(lo, hi):
        u = torch.rand(b, generator=generator, device=device)
        return u * (hi - lo) + lo
    return {"k": randint(4), "axis": randint(2), "bf": uniform(0.2, 1.8),
            "cf": uniform(0.2, 1.8), "order": uniform(0.0, 1.0)}


def _color_jitter(x: torch.Tensor, draws: Dict[str, torch.Tensor]):
    """Grayscale ColorJitter(0.8, 0.8, 0.8, 0.2) of (B, H, W) float32:
    brightness clip(x * bf, 0, 1) and contrast clip(cf * x + (1 - cf) *
    mean(x), 0, 1), the mean per sample; contrast(brightness(x)) where the
    order draw is < 0.5, else brightness(contrast(x)). JAX:
    ``device_store._color_jitter_device``."""
    bf = draws["bf"][:, None, None]
    cf = draws["cf"][:, None, None]

    def brightness(v):
        return torch.clamp(v * bf, 0.0, 1.0)

    def contrast(v):
        return torch.clamp(cf * v + (1.0 - cf) * v.mean(dim=(1, 2),
                                                         keepdim=True),
                           0.0, 1.0)
    first = (draws["order"] < 0.5)[:, None, None]
    return torch.where(first, contrast(brightness(x)),
                       brightness(contrast(x)))


def gather_weak_strong(images: torch.Tensor, labels: torch.Tensor,
                       indices: torch.Tensor,
                       draws: Dict[str, torch.Tensor]):
    """Batch assembly for FixMatch: gather rows and cast the images to
    float32 first (unlike :func:`gather_augment`, which works in the
    storage dtypes); weak = flip(rot90(image, k), axis), the label the same
    way; strong = the color jitter of weak. NCHW images, int32 labels:
    ``image`` (not augmented), ``image_weak``, ``image_strong``,
    ``label_aug``, ``label`` (= ``label_aug``) and ``idx``. JAX:
    ``device_store.gather_weak_strong``."""
    img = images[indices].to(torch.float32)
    lab = labels[indices].to(torch.int32)
    # rot90 views leave transposed strides behind
    weak = _flip_axis(_rot90_k(img, draws["k"]), draws["axis"]).contiguous()
    lab_aug = _flip_axis(_rot90_k(lab, draws["k"]),
                         draws["axis"]).contiguous()
    strong = _color_jitter(weak, draws)
    return {"image": img[:, None], "image_weak": weak[:, None],
            "image_strong": strong[:, None], "label_aug": lab_aug,
            "label": lab_aug, "idx": indices.to(torch.int32)}


# ---------------------------------------------------------------------------
# 3D volumes (the BraTS recipe: RandomRotFlip + RandomCrop,
# ``brats2019.py:80-148``). JAX: ``device_store.py:284-363``.
# ---------------------------------------------------------------------------

# the JAX engine's rule (``engine.py:558-563``): the store is used while
# its estimate stays under this many bytes, else the host pipeline
STORE_LIMIT_BYTES = 8 * 1024 ** 3


class DeviceVolumeStore:
    """All train volumes resident on ``device``, each padded by the
    reference's rule (``data/transforms.py::pad_pads``) and placed at the
    origin of a common (n, D, H, W) shape, zeros beyond it: images in
    ``image_dtype`` (bfloat16), labels uint8, and each volume's padded
    extent (n, 3) int64, inside which every crop's corner is drawn.

    Samples may be numpy arrays or tensors on any device; each is moved to
    ``device`` and padded there one by one, so no host array of the whole
    set is made (the device holds the volumes once more while they are
    placed)."""

    def __init__(self, dataset, patch_size, image_dtype=torch.bfloat16,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceVolumeStore: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        self.patch_size = tuple(int(p) for p in patch_size)
        vols, labs = [], []
        for i in range(len(dataset)):
            sample = dataset[i]
            vols.append(self._pad(sample["image"], image_dtype, device))
            labs.append(self._pad(sample["label"], torch.uint8, device))
        shapes = [tuple(v.shape) for v in vols]
        top = tuple(max(sh[i] for sh in shapes) for i in range(3))
        n = len(vols)
        self.images = torch.zeros((n,) + top, dtype=image_dtype,
                                  device=device)
        self.labels = torch.zeros((n,) + top, dtype=torch.uint8,
                                  device=device)
        for i in range(n):
            d, h, w = shapes[i]
            self.images[i, :d, :h, :w] = vols[i]
            self.labels[i, :d, :h, :w] = labs[i]
            vols[i] = labs[i] = None
        self.shapes = torch.tensor(shapes, dtype=torch.int64, device=device)

    def _pad(self, x, dtype, device) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=device, dtype=dtype)
        pads = pad_pads(tuple(x.shape), self.patch_size)
        if pads is None:
            return x
        # F.pad takes the last axis first
        flat = [p for q in reversed(pads) for p in (q, q)]
        return F.pad(x, flat)

    @staticmethod
    def takes_patch(patch_size) -> bool:
        """Whether the store can serve ``patch_size``: its rot90 comes
        after the crop (JAX's order), so the patch's first two sides must
        be equal (JAX's store fails to trace another patch)."""
        return int(patch_size[0]) == int(patch_size[1])

    @staticmethod
    def estimated_bytes(dataset, patch_size, bytes_per_voxel: int = 3):
        """The store's size from the first volume's shape (at least the
        patch on each axis), 2 bytes of image and 1 of label a voxel. JAX:
        ``DeviceVolumeStore.estimated_bytes``."""
        shape = np.maximum(np.asarray(dataset[0]["image"].shape),
                           np.asarray(patch_size))
        return int(len(dataset) * np.prod(shape) * bytes_per_voxel)

    def arrays(self):
        return (self.images, self.labels, self.shapes)

    def batch_fn(self, arrays, indices: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
        images, labels, shapes = arrays
        draws = draw_crop_rotflip(shapes[indices], self.patch_size,
                                  generator)
        return gather_crop_rotflip(images, labels, indices, draws,
                                   self.patch_size)


def draw_crop_rotflip(shapes: torch.Tensor, patch,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
    """The per-sample draws of one 3D batch, on the shapes' device: the
    crop's corner (B, 3), each coordinate uniform in [0, extent - patch]
    (inclusive: JAX's ``randint(0, shape - patch + 1)``), k in {0..3} and
    axis in {0, 1}."""
    b, dev = shapes.shape[0], shapes.device
    # per axis with Python ints: a host tensor of the patch would be a
    # synchronising copy
    room = torch.stack([shapes[:, i] - (int(p) - 1)
                        for i, p in enumerate(patch)], dim=1)
    u = torch.rand((b, 3), generator=generator, device=dev)
    corner = torch.minimum((u * room).long(), room - 1)
    k = torch.randint(0, 4, (b,), generator=generator, device=dev)
    axis = torch.randint(0, 2, (b,), generator=generator, device=dev)
    return {"corner": corner, "k": k, "axis": axis}


def _rot_flip_source(n: int, k: torch.Tensor, axis: torch.Tensor):
    """For flip(rot90(v, k, axes=(0, 1)), axis) of (n, n, ...) crops
    (numpy's directions), the source coordinates (a, b) in the crop of each
    output position (i, j): two (B, n, n) int64 tensors."""
    dev = k.device
    i = torch.arange(n, device=dev)[None, :, None]
    j = torch.arange(n, device=dev)[None, None, :]
    ax = axis[:, None, None]
    # the flip: output (i, j) reads the rotated crop r at (p, q)
    p = torch.where(ax == 0, n - 1 - i, i)
    q = torch.where(ax == 1, n - 1 - j, j)
    # rot90 by k: r[p, q] = v[a, b]
    kk = k[:, None, None]
    a = torch.where(kk == 0, p, torch.where(
        kk == 1, q, torch.where(kk == 2, n - 1 - p, n - 1 - q)))
    b = torch.where(kk == 0, q, torch.where(
        kk == 1, n - 1 - p, torch.where(kk == 2, n - 1 - q, p)))
    return a, b


def gather_crop_rotflip(images: torch.Tensor, labels: torch.Tensor,
                        indices: torch.Tensor,
                        draws: Dict[str, torch.Tensor], patch):
    """Batch assembly: for each sample the crop of ``patch`` at its drawn
    corner (``brats2019.py:115-117``), then rot90(k) and a flip along axis
    in the first two volume axes (``brats2019.py:131-148``), applied after
    the crop as in JAX (its documented deviation from the reference's
    order; the first two sides of the patch must be equal). The crop, the
    rotation and the flip are one index map, so each of image and label is
    one gather from the store. NCDHW float32 image + int32 label. JAX:
    ``device_store.gather_crop_rotflip``."""
    pd, ph, pw = (int(p) for p in patch)
    if pd != ph:
        raise ValueError(f"patch {tuple(patch)}: rot90 in the first two axes "
                         "needs them equal")
    corner = draws["corner"]
    a, b = _rot_flip_source(pd, draws["k"], draws["axis"])
    src_d = (corner[:, 0, None, None] + a)[..., None]
    src_h = (corner[:, 1, None, None] + b)[..., None]
    src_w = (corner[:, 2, None] + torch.arange(pw, device=corner.device)
             )[:, None, None, :]
    vol = indices.long()[:, None, None, None]
    img = images[vol, src_d, src_h, src_w]
    lab = labels[vol, src_d, src_h, src_w]
    return {"image": img.to(torch.float32)[:, None],
            "label": lab.to(torch.int32), "idx": indices.to(torch.int32)}
