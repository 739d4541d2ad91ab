"""The training batches' augmentation, plain, with its random draws in the
order the draws are made.

2D, SSL4MIS's ``RandomGenerator`` (``dataloaders/dataset.py:415-419``):
with u1 > 0.5 rot90 by k then a flip along ``axis``; else with u2 > 0.5 a
nearest rotation by an integer angle in [-20, 20) degrees, done as three
shears with zero fill (Paeth; the shifts rounded as below); else the slice
unchanged. 3D, the BraTS recipe (``dataloaders/brats2019.py:80-148``): a
crop of the patch at a corner uniform over the volume, then rot90 by k in
the first two axes and a flip along ``axis`` of them (applied after the
crop).

The draws come from the caller's generator: 2D u1, u2 (B,) uniform, k
(B,) in 0..3, axis (B,) in 0..1, the angle's index (B,) in 0..39; 3D the
corner's three uniforms (B, 3), k, axis. This module imports nothing of
the program.
"""
from __future__ import annotations

import numpy as np
import torch

MAX_ANGLE = 20


def draws_2d(b: int, generator, device) -> dict:
    def randint(high):
        return torch.randint(0, high, (b,), generator=generator,
                             device=device)
    return {"u1": torch.rand(b, generator=generator, device=device),
            "u2": torch.rand(b, generator=generator, device=device),
            "k": randint(4), "axis": randint(2),
            "aidx": randint(2 * MAX_ANGLE)}


def _shear_shifts(h: int, w: int):
    """Integer shifts of the three shears for every angle: row shifts
    (40, h) for shears 1 and 3 (round(-tan(phi / 2) * (i - cy))) and column
    shifts (40, w) for shear 2 (round(sin(phi) * (j - cx)))."""
    phi = np.arange(-MAX_ANGLE, MAX_ANGLE) * np.pi / 180.0
    i = np.arange(h) - (h - 1) / 2.0
    j = np.arange(w) - (w - 1) / 2.0
    row = np.round(-np.tan(phi / 2.0)[:, None] * i[None, :])
    col = np.round(np.sin(phi)[:, None] * j[None, :])
    return row.astype(np.int64), col.astype(np.int64)


def _shear(x: torch.Tensor, valid: torch.Tensor, shift: torch.Tensor,
           axis: int):
    """Per line shift with zero fill: along the columns (axis 2), out[b,
    i, j] = x[b, i, j + s[b, i]]; along the rows (axis 1), out[b, i, j] =
    x[b, i + s[b, j], j]. ``valid`` marks the sites that came from inside
    the frame."""
    n = x.shape[axis]
    pos = torch.arange(n, device=x.device)
    if axis == 2:
        src = pos[None, None, :] + shift[:, :, None]
    else:
        src = pos[None, :, None] + shift[:, None, :]
    inside = (src >= 0) & (src < n)
    idx = src.clamp(0, n - 1).expand(x.shape)
    out = torch.where(inside, torch.gather(x, axis, idx), 0)
    return out, inside & torch.gather(valid, axis, idx)


def _rotate(x: torch.Tensor, aidx: torch.Tensor) -> torch.Tensor:
    b, h, w = x.shape
    row, col = (torch.from_numpy(t).to(x.device) for t in _shear_shifts(h, w))
    srow, scol = row[aidx], col[aidx]
    valid = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    x, valid = _shear(x, valid, srow, 2)
    x, valid = _shear(x, valid, scol, 1)
    x, valid = _shear(x, valid, srow, 2)
    return torch.where(valid, x, 0)


def _rot90_flip(x: torch.Tensor, k: torch.Tensor, axis: torch.Tensor):
    """Per sample, numpy's rot90(x, k) in the first two axes after the
    batch, then a flip of the first (axis 0) or the second (axis 1)."""
    out = x
    for r in (1, 2, 3):
        sel = (k == r).view((-1,) + (1,) * (x.ndim - 1))
        out = torch.where(sel, torch.rot90(x, r, dims=(1, 2)), out)
    sel = (axis == 0).view((-1,) + (1,) * (x.ndim - 1))
    return torch.where(sel, out.flip(1), out.flip(2))


def batch_2d(images: torch.Tensor, labels: torch.Tensor, draws: dict):
    """Augmented float32 images (B, 1, H, W) and int64 labels (B, H, W)
    from the raw slices of one batch (B, H, W)."""
    rf_i = _rot90_flip(images, draws["k"], draws["axis"])
    rf_l = _rot90_flip(labels, draws["k"], draws["axis"])
    rot_i = _rotate(images, draws["aidx"])
    rot_l = _rotate(labels, draws["aidx"])
    c1 = (draws["u1"] > 0.5)[:, None, None]
    c2 = (draws["u2"] > 0.5)[:, None, None]
    img = torch.where(c1, rf_i, torch.where(c2, rot_i, images))
    lab = torch.where(c1, rf_l, torch.where(c2, rot_l, labels))
    return img.float()[:, None].contiguous(), lab.long().contiguous()


def draws_3d(extents: torch.Tensor, patch, generator) -> dict:
    """The crop's corner (B, 3), each coordinate uniform over [0, extent -
    patch], then k and axis. ``extents`` (B, 3) int64 on the device."""
    b, dev = extents.shape[0], extents.device
    room = torch.stack([extents[:, i] - (int(p) - 1)
                        for i, p in enumerate(patch)], dim=1)
    u = torch.rand((b, 3), generator=generator, device=dev)
    corner = torch.minimum((u * room).long(), room - 1)
    k = torch.randint(0, 4, (b,), generator=generator, device=dev)
    axis = torch.randint(0, 2, (b,), generator=generator, device=dev)
    return {"corner": corner, "k": k, "axis": axis}


def batch_3d(volumes: torch.Tensor, labels: torch.Tensor, draws: dict,
             patch):
    """Cropped, rotated and flipped float32 images (B, 1, *patch) and int64
    labels (B, *patch) from one batch of raw volumes (B, D, H, W)."""
    pd, ph, pw = (int(p) for p in patch)
    imgs, labs = [], []
    for i in range(volumes.shape[0]):
        d, h, w = (int(v) for v in draws["corner"][i])
        imgs.append(volumes[i, d:d + pd, h:h + ph, w:w + pw])
        labs.append(labels[i, d:d + pd, h:h + ph, w:w + pw])
    img = _rot90_flip(torch.stack(imgs), draws["k"], draws["axis"])
    lab = _rot90_flip(torch.stack(labs), draws["k"], draws["axis"])
    return img.float()[:, None].contiguous(), lab.long().contiguous()
