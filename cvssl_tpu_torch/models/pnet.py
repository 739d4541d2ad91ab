"""PNet2D, NCHW (port of ``cvssl_tpu/models/pnet.py``): five blocks of two
dilated 3x3 convs (dilations 1, 2, 4, 8, 16) at constant width, a dense
concat of the five block outputs, two 1x1 fusion convs and a head of two
channel dropouts (p 0.3) around a 1x1 conv. 486,596 parameters at 1 -> 4
classes.

The module names follow the reference's blocks (``block1``..``block5``,
``catblock``, ``out``); ``models/convert.py::_pnet`` names the Flax
counterparts. The dropouts' keep masks are drawn through
``unet3d.channel_dropout_3d`` (``unet._keep``) from the caller's generator,
in JAX's order.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.models.unet import BatchNorm2d
from cvssl_tpu_torch.models.unet3d import channel_dropout_3d

HEAD_DROPOUT = 0.3


class PNetBlock(nn.Module):
    """Two dilated conv3x3 + BatchNorm + LeakyReLU 0.01."""

    def __init__(self, in_channels: int, out_channels: int, dilation: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3,
                               padding=dilation, dilation=dilation)
        self.bn1 = BatchNorm2d(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3,
                               padding=dilation, dilation=dilation)
        self.bn2 = BatchNorm2d(out_channels)

    def forward(self, x):
        x = F.leaky_relu(self.bn1(self.conv1(x)), 0.01)
        return F.leaky_relu(self.bn2(self.conv2(x)), 0.01)


class ConcatBlock(nn.Module):
    """Two 1x1 convs, each followed by LeakyReLU 0.01."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, in_channels, 1)
        self.conv2 = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        x = F.leaky_relu(self.conv1(x), 0.01)
        return F.leaky_relu(self.conv2(x), 0.01)


class OutputBlock(nn.Module):
    """Channel dropout, 1x1 conv, LeakyReLU, channel dropout, 1x1 conv."""

    def __init__(self, in_channels: int, mid_channels: int,
                 num_classes: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, mid_channels, 1)
        self.conv2 = nn.Conv2d(mid_channels, num_classes, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.training:
            x = channel_dropout_3d(x, HEAD_DROPOUT, generator)
        x = F.leaky_relu(self.conv1(x), 0.01)
        if self.training:
            x = channel_dropout_3d(x, HEAD_DROPOUT, generator)
        return self.conv2(x)


class PNet2D(nn.Module):
    def __init__(self, in_chns: int = 1, num_classes: int = 4,
                 num_filters: int = 64,
                 ratios: Sequence[int] = (1, 2, 4, 8, 16)):
        super().__init__()
        self.n_blocks = len(ratios)
        for i, r in enumerate(ratios):
            setattr(self, f"block{i + 1}", PNetBlock(
                in_chns if i == 0 else num_filters, num_filters, r))
        cat = num_filters * len(ratios)
        self.catblock = ConcatBlock(cat, num_filters * 2)
        self.out = OutputBlock(num_filters * 2, num_filters, num_classes)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        feats = []
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i + 1}")(x)
            feats.append(x)
        return self.out(self.catblock(torch.cat(feats, dim=1)), generator)
