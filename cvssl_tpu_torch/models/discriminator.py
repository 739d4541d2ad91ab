"""The GAN discriminators of the adversarial methods, NCHW and NCDHW (port
of ``cvssl_tpu/models/discriminator.py``: ``FCDiscriminator`` and
``FC3DDiscriminator``).

A conv ladder over (softmax map, image) pairs ending in a binary
labeled/unlabeled logit. Module names are the original torch code's
(``conv0`` ... ``conv4``, ``classifier``), and like it the classifier takes
the NCHW flatten, (c, h, w) order; the JAX ``Dense`` takes the NHWC flatten,
so ``models/convert.py`` reorders its rows.

The reference hard-codes ``Linear(ndf * 32, 2)``; here, as in JAX, the
classifier's width follows the input size, which the constructor takes
(``patch_size``): every weight exists after construction, so it is drawn
inside the engine's seeded initialisation.

``FC3DDiscriminator`` ends in a global mean (the reference's
``AvgPool3d(6)`` at 96^3), so its classifier takes the channel vector and
its width does not depend on the input size.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.models import unet


def pooled_size(patch_size: Sequence[int]) -> Tuple[int, int]:
    """(h, w) of the map that the classifier flattens: four 4x4 stride-2
    pad-1 convs halve each side (floor), then an average pool of window =
    stride = min(7, side), floor mode."""
    out = []
    for p in patch_size:
        s = int(p)
        for _ in range(4):
            s = (s + 2 - 4) // 2 + 1
        out.append(s // min(7, s))
    return tuple(out)


def channel_dropout(x: torch.Tensor, keep: torch.Tensor,
                    p: float) -> torch.Tensor:
    """Dropout of whole channels: ``keep`` (B, C, 1, 1[, 1]) bool is one
    draw per (sample, channel), broadcast over the spatial axes; survivors
    are scaled by 1 / (1 - p). Flax ``nn.Dropout(broadcast_dims=...)`` over
    the spatial axes of NHWC / NDHWC."""
    return torch.where(keep, x / (1.0 - p), 0.0)


class FCDiscriminator(nn.Module):
    """2D discriminator (reference ``discriminator.py:58-100``). conv0 on
    the softmax map and conv1 on the image are summed with no activation
    before conv2 (a reference quirk, kept); conv2, conv3 and conv4 are each
    followed by leaky_relu 0.2, the first two then by channel dropout
    (train mode only); then the average pool and the classifier."""

    def __init__(self, num_classes: int = 4, in_chns: int = 1, ndf: int = 64,
                 drop: float = 0.5,
                 patch_size: Sequence[int] = (256, 256)):
        super().__init__()
        self.drop = drop
        self.conv0 = nn.Conv2d(num_classes, ndf, 4, stride=2, padding=1)
        self.conv1 = nn.Conv2d(in_chns, ndf, 4, stride=2, padding=1)
        self.conv2 = nn.Conv2d(ndf, ndf * 2, 4, stride=2, padding=1)
        self.conv3 = nn.Conv2d(ndf * 2, ndf * 4, 4, stride=2, padding=1)
        self.conv4 = nn.Conv2d(ndf * 4, ndf * 8, 4, stride=2, padding=1)
        ph, pw = pooled_size(patch_size)
        self.classifier = nn.Linear(ndf * 8 * ph * pw, 2)

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.drop == 0.0:
            return x
        keep = unet._keep(x.shape[:2] + (1, 1), 1.0 - self.drop, generator,
                          x.device)
        return channel_dropout(x, keep, self.drop)

    def forward(self, seg_map: torch.Tensor, image: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.conv0(seg_map) + self.conv1(image)
        x = F.leaky_relu(self.conv2(x), 0.2)
        x = self._dropout(x, generator)
        x = F.leaky_relu(self.conv3(x), 0.2)
        x = self._dropout(x, generator)
        x = F.leaky_relu(self.conv4(x), 0.2)
        k = (min(7, x.shape[2]), min(7, x.shape[3]))
        x = F.avg_pool2d(x, k, stride=k)
        return self.classifier(x.flatten(1))


class FC3DDiscriminator(nn.Module):
    """3D discriminator (reference ``discriminator.py:6-55``): conv0 on the
    softmax map and conv1 on the image (4^3, stride 2, pad 1) summed, then
    leaky_relu 0.2 and channel dropout; conv2 and conv3, each followed by
    leaky_relu and channel dropout (train mode only; one keep per (sample,
    channel), broadcast over D, H and W: torch ``Dropout3d``); conv4 and
    leaky_relu; the global mean over D, H, W and the classifier. 96^3 inputs
    reach 6^3 after the four stride-2 levels. The three keep masks are
    drawn in that order from the caller's generator."""

    def __init__(self, num_classes: int = 2, in_chns: int = 1,
                 ndf: int = 64, drop: float = 0.5):
        super().__init__()
        self.drop = drop
        self.conv0 = nn.Conv3d(num_classes, ndf, 4, stride=2, padding=1)
        self.conv1 = nn.Conv3d(in_chns, ndf, 4, stride=2, padding=1)
        self.conv2 = nn.Conv3d(ndf, ndf * 2, 4, stride=2, padding=1)
        self.conv3 = nn.Conv3d(ndf * 2, ndf * 4, 4, stride=2, padding=1)
        self.conv4 = nn.Conv3d(ndf * 4, ndf * 8, 4, stride=2, padding=1)
        self.classifier = nn.Linear(ndf * 8, 2)

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.drop == 0.0:
            return x
        keep = unet._keep(x.shape[:2] + (1, 1, 1), 1.0 - self.drop,
                          generator, x.device)
        return channel_dropout(x, keep, self.drop)

    def forward(self, seg_map: torch.Tensor, image: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.leaky_relu(self.conv0(seg_map) + self.conv1(image), 0.2)
        x = self._dropout(x, generator)
        x = self._dropout(F.leaky_relu(self.conv2(x), 0.2), generator)
        x = self._dropout(F.leaky_relu(self.conv3(x), 0.2), generator)
        x = F.leaky_relu(self.conv4(x), 0.2)
        return self.classifier(x.mean(dim=(2, 3, 4)))
