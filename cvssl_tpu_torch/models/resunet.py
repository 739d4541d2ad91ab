"""PreUNet, NCHW (port of ``cvssl_tpu/models/resunet.py``): a UNet decoder
on a Res2Net-101 v1b encoder (26w x 4s; the stem and layers 1-3, (3, 4, 23)
blocks, feed the decoder). 55,581,692 parameters at 1 -> 4 classes. A
1-channel input is tiled to 3 channels (the reference's preUnet takes only
3).

The encoder (``encoder``) keeps ``Res2Net_v1b``'s names, the keys that
``models/cnn_checkpoint.py`` reads: ``conv1.{0,1,3,4,6}`` and ``bn1`` (the
v1b stem: three 3x3 convs), ``layer{i}.{b}.conv1`` / ``bn1`` /
``convs.{k}`` / ``bns.{k}`` / ``conv3`` / ``bn3`` / ``downsample.{1,2}``.

The first block of each layer (a 'stage' block) runs each split on its
own and pools the last split with a 3x3 average pool, padding 1, at the
block's stride, even at stride 1; the padded zeros count
(``count_include_pad``, as Flax's ``avg_pool``). Its shortcut is the v1b
downsample: average pool (stride x stride, where the stride is 2), 1x1
conv, BatchNorm. The decoder is conv-BN-LeakyReLU 0.01 pairs (the convs
with bias) and bilinear x2 with ``align_corners=True``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.models.unet import BatchNorm2d

EXPANSION = 4


class Bottle2neck(nn.Module):
    """Res2Net bottleneck: 1x1, ``scale`` splits of which ``scale - 1`` go
    through cascaded 3x3 convs (a 'normal' block adds the previous split's
    output to the next split; a 'stage' block does not, and pools the last
    split), concat, 1x1, then the residual add and ReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 stage: bool = False, base_width: int = 26, scale: int = 4):
        super().__init__()
        width = int(planes * (base_width / 64.0))
        self.width, self.stage, self.stride = width, stage, stride
        self.conv1 = nn.Conv2d(inplanes, width * scale, 1, bias=False)
        self.bn1 = BatchNorm2d(width * scale)
        self.convs = nn.ModuleList(
            nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
            for _ in range(scale - 1))
        self.bns = nn.ModuleList(BatchNorm2d(width)
                                 for _ in range(scale - 1))
        self.conv3 = nn.Conv2d(width * scale, planes * EXPANSION, 1,
                               bias=False)
        self.bn3 = BatchNorm2d(planes * EXPANSION)
        if stage:
            self.downsample = nn.Sequential(
                nn.AvgPool2d(stride, stride),
                nn.Conv2d(inplanes, planes * EXPANSION, 1, bias=False),
                BatchNorm2d(planes * EXPANSION))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        splits = torch.split(out, self.width, dim=1)
        outs = []
        sp = None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = splits[i] if (i == 0 or self.stage) else sp + splits[i]
            sp = F.relu(bn(conv(sp)))
            outs.append(sp)
        if self.stage:
            outs.append(F.avg_pool2d(splits[-1], 3, self.stride, 1))
        else:
            outs.append(splits[-1])
        out = self.bn3(self.conv3(torch.cat(outs, dim=1)))
        identity = self.downsample(x) if self.stage else x
        return F.relu(out + identity)


class Res2NetEncoder(nn.Module):
    """The v1b stem and layers 1-3. Returns the stem's map (/2, 64
    channels) and the layers' (/4 256, /8 512, /16 1024)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23)):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv2d(3, 32, 3, stride=2, padding=1, bias=False),
            BatchNorm2d(32), nn.ReLU(),
            nn.Conv2d(32, 32, 3, padding=1, bias=False),
            BatchNorm2d(32), nn.ReLU(),
            nn.Conv2d(32, 64, 3, padding=1, bias=False))
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        self.n_layers = len(layers)
        for li, (planes, blocks) in enumerate(zip((64, 128, 256), layers)):
            stride = 1 if li == 0 else 2
            mods = [Bottle2neck(inplanes, planes, stride, stage=True)]
            inplanes = planes * EXPANSION
            mods += [Bottle2neck(inplanes, planes)
                     for _ in range(blocks - 1)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*mods))

    def forward(self, x):
        stem = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(stem, 3, stride=2, padding=1)
        feats = []
        for li in range(self.n_layers):
            h = getattr(self, f"layer{li + 1}")(h)
            feats.append(h)
        return stem, feats


def _conv_block(cin: int, mid: int, cout: int) -> nn.Sequential:
    """conv3x3-BN-LeakyReLU twice."""
    return nn.Sequential(nn.Conv2d(cin, mid, 3, padding=1), BatchNorm2d(mid),
                         nn.LeakyReLU(0.01),
                         nn.Conv2d(mid, cout, 3, padding=1),
                         BatchNorm2d(cout), nn.LeakyReLU(0.01))


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


class PreUNet(nn.Module):
    def __init__(self, in_chns: int = 1, num_classes: int = 4):
        super().__init__()
        self.encoder = Res2NetEncoder()
        self.decoder1 = _conv_block(1024, 1024, 512)
        self.decoder2 = _conv_block(1024, 512, 512)
        self.decoder3 = _conv_block(512, 512, 256)
        self.decoder4 = _conv_block(512, 256, 256)
        self.decoder5 = _conv_block(256, 256, 64)
        self.decoder6 = _conv_block(128, 64, 64)
        self.out_conv = nn.Conv2d(64, num_classes, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        stem, (x1, x2, x3) = self.encoder(x)
        h = self.decoder1(_up2(x3))
        h = self.decoder2(torch.cat([x2, h], dim=1))
        h = self.decoder3(_up2(h))
        h = self.decoder4(torch.cat([x1, h], dim=1))
        h = self.decoder5(_up2(h))
        h = self.decoder6(torch.cat([stem, h], dim=1))
        return self.out_conv(_up2(h))
