"""VoxResNet, NCDHW (port of ``cvssl_tpu/models/voxresnet.py``; parity with
the reference ``code/networks/VoxResNet.py``): pre-activation residual
blocks at one width, three 2x2x2 max-pools, trilinear x2 up with
``align_corners=True`` and a skip concat. 1,992,578 parameters at
``feature_chns=64``, 2 classes. The reference defines ``SEBlock`` but
never wires it in; it is kept here for parity.

Module names: ``conv1``, ``res1`` ... ``res6`` (``.block.2``/``.block.5``,
the reference's ``nn.Sequential(IN, ReLU, conv, IN, ReLU, conv)``),
``up1``/``up2`` (``.conv.conv_conv.2``/``.5``), ``out``. InstanceNorm is
``models/unet3d.py::instance_norm`` (float32 statistics, as JAX's). The
net computes in float32 (JAX builds it without a dtype).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.models.unet3d import instance_norm


def trilinear_align_x2(x: torch.Tensor) -> torch.Tensor:
    """Trilinear x2 with ``align_corners=True``. JAX composes it from the
    2D align-corners resize, plane first, then depth
    (``voxresnet.trilinear_align_x2``); this is the same function in one
    call, rounded in another order."""
    return F.interpolate(x, scale_factor=2, mode="trilinear",
                         align_corners=True)


class SEBlock(nn.Module):
    """Squeeze-excite (``VoxResNet.py:9-23``; defined but unused upstream):
    the spatial mean, 1x1x1 conv to c / reduction, ReLU, 1x1x1 conv back,
    ReLU; ``f * x + x``."""

    def __init__(self, channels: int, reduction: int = 6):
        super().__init__()
        self.fc1 = nn.Conv3d(channels, int(channels / reduction), 1)
        self.fc2 = nn.Conv3d(int(channels / reduction), channels, 1)

    def forward(self, x):
        f = x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)
        f = torch.relu(self.fc2(torch.relu(self.fc1(f))))
        return f * x + x


class _PreAct(nn.Sequential):
    """IN, ReLU, conv 3^3 (no bias), IN, ReLU, conv 3^3 (no bias), under
    the reference's Sequential indices (the convs at 2 and 5)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(
            nn.Identity(), nn.ReLU(),
            nn.Conv3d(in_channels, out_channels, 3, padding=1, bias=False),
            nn.Identity(), nn.ReLU(),
            nn.Conv3d(out_channels, out_channels, 3, padding=1, bias=False))

    def forward(self, x):
        h = self[2](torch.relu(instance_norm(x)))
        return self[5](torch.relu(instance_norm(h)))


class VoxRex(nn.Module):
    """Pre-activation residual block (``VoxResNet.py:26-41``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.block = _PreAct(channels, channels)

    def forward(self, x):
        return self.block(x) + x


class _PreActConvBlock(nn.Module):
    """IN-ReLU-conv x2 (``VoxResNet.py:44-61``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_conv = _PreAct(in_channels, out_channels)

    def forward(self, x):
        return self.conv_conv(x)


class _UpBlock(nn.Module):
    """Align-corners trilinear x2 of the level below, concat skip-first,
    the pre-activation block (``VoxResNet.py:64-77``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = _PreActConvBlock(in_channels, out_channels)

    def forward(self, x1, x2):
        return self.conv(torch.cat([x2, trilinear_align_x2(x1)], dim=1))


class VoxResNet(nn.Module):
    """(``VoxResNet.py:79-116``) The spatial extent must be divisible by
    8."""

    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 feature_chns: int = 64):
        super().__init__()
        f = feature_chns
        self.conv1 = nn.Conv3d(in_chns, f, 3, padding=1)
        for i in range(1, 7):
            setattr(self, f"res{i}", VoxRex(f))
        self.up1 = _UpBlock(2 * f, f)
        self.up2 = _UpBlock(2 * f, f)
        self.out = nn.Conv3d(f, num_classes, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = F.max_pool3d(self.conv1(x), 2)
        x2 = self.res2(self.res1(x))
        x2_pool = F.max_pool3d(x2, 2)
        x4 = F.max_pool3d(self.res4(self.res3(x2_pool)), 2)
        x6 = self.res6(self.res5(x4))
        up1 = self.up1(x6, x2_pool)
        up2 = self.up2(up1, x)
        return self.out(trilinear_align_x2(up2))
