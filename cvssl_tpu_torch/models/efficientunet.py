"""EffiUNet, NCHW (port of ``cvssl_tpu/models/efficientunet.py``): a UNet
on an EfficientNet-B3 encoder with segmentation_models.pytorch's decoder
(nearest x2, skip concat, two conv-BN-ReLU; decoder channels 256, 128, 64,
32, 16; a 1x1 classifier). 12,566,060 parameters at 1 -> 4 classes. A
1-channel input is tiled to 3 channels; sides divisible by 32.

Module names are the published ones: the encoder's are lukemelas'
``efficientnet_pytorch`` (``encoder._conv_stem``, ``encoder._bn0``,
``encoder._blocks.{n}._expand_conv`` / ``_bn0`` / ``_depthwise_conv`` /
``_bn1`` / ``_se_reduce`` / ``_se_expand`` / ``_project_conv`` / ``_bn2``;
the classifier head ``_conv_head`` / ``_bn1`` / ``_fc`` is not built, as
in JAX), the decoder's smp's (``decoder.blocks.{n}.conv{1,2}.{0,1}``,
``classifier``). So an EfficientNet-B3 ``state_dict`` under ``encoder.``
and the reference ``Effi_UNet``'s are this model's own state
(``models/cnn_checkpoint.py``).

Static TF-SAME padding: each conv's pads come from the B3 ladder at
``image_size=300`` (150, 75, 38, 19, 10), not from the input's size, as
``Conv2dStaticSamePadding`` bakes them; they are (0, 1) on the three even
stride-2 3x3 convs (the stem, stage 2's and stage 4's first blocks) and are
applied by an explicit ``F.pad`` before the conv.

The encoder's BatchNorm is momentum 0.01 (Flax's 0.99), eps 1e-3; the
decoder's 0.1, 1e-5. Drop-connect is per sample at rate 0.2 * block /
blocks, drawn (``unet._keep``, from the caller's generator) only where the
rate is above 0, the stride is 1 and the block keeps its width, block after
block in JAX's order.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.models import unet
from cvssl_tpu_torch.models.unet import BatchNorm2d

# base (B0) stage configs: (expand, kernel, stride, channels, repeats)
B0_STAGES = ((1, 3, 1, 16, 1), (6, 3, 2, 24, 2), (6, 5, 2, 40, 2),
             (6, 3, 2, 80, 3), (6, 5, 1, 112, 3), (6, 5, 2, 192, 4),
             (6, 3, 1, 320, 1))
B3_WIDTH, B3_DEPTH, B3_IMAGE_SIZE = 1.2, 1.4, 300
DROP_CONNECT = 0.2


def round_filters(filters: int, width: float = B3_WIDTH) -> int:
    """EfficientNet's width scaling (to a multiple of 8)."""
    filters *= width
    new = max(8, int(filters + 4) // 8 * 8)
    if new < 0.9 * filters:
        new += 8
    return int(new)


def round_repeats(repeats: int, depth: float = B3_DEPTH) -> int:
    return int(math.ceil(depth * repeats))


def same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-SAME (before, after) pads of a ``k``/``s`` conv at the STATIC
    square ``size``: (pad // 2, pad - pad // 2)."""
    out = -(-size // s)
    pad = max((out - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


def _enc_bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-3, momentum=0.01)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with static TF-SAME pads for the square ``size``,
    applied by ``F.pad`` before the conv."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 size: int = 1, **kw):
        super().__init__(cin, cout, k, stride=stride, **kw)
        lo, hi = same_pad(size, k, stride)
        self.pads = (lo, hi, lo, hi)

    def forward(self, x):
        if any(self.pads):
            x = F.pad(x, self.pads)
        return super().forward(x)


class MBConv(nn.Module):
    """Mobile inverted bottleneck: 1x1 expand, depthwise conv, squeeze-
    excite on the block's INPUT channels x 0.25 (swish), 1x1 project;
    the residual (with drop-connect) where stride 1 keeps the width."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 expand: int, size: int, drop_rate: float = 0.0,
                 se_ratio: float = 0.25):
        super().__init__()
        c = cin * expand
        self.expand = expand != 1
        if self.expand:
            self._expand_conv = SameConv2d(cin, c, 1, size=size, bias=False)
            self._bn0 = _enc_bn(c)
        self._depthwise_conv = SameConv2d(c, c, k, stride=stride, size=size,
                                          groups=c, bias=False)
        self._bn1 = _enc_bn(c)
        se = max(1, int(cin * se_ratio))
        self._se_reduce = nn.Conv2d(c, se, 1)
        self._se_expand = nn.Conv2d(se, c, 1)
        self._project_conv = nn.Conv2d(c, cout, 1, bias=False)
        self._bn2 = _enc_bn(cout)
        self.residual = stride == 1 and cin == cout
        self.drop_rate = drop_rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = x
        if self.expand:
            h = F.silu(self._bn0(self._expand_conv(h)))
        h = F.silu(self._bn1(self._depthwise_conv(h)))
        s = h.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self._se_expand(F.silu(self._se_reduce(s))))
        h = self._bn2(self._project_conv(h * s))
        if not self.residual:
            return h
        if self.drop_rate > 0 and self.training:
            keep = 1.0 - self.drop_rate
            mask = unet._keep((h.shape[0], 1, 1, 1), keep, generator,
                              h.device)
            h = torch.where(mask, h / keep, 0.0)
        return h + x


class EfficientNetEncoder(nn.Module):
    """The B3 stem and its 26 MBConv blocks. Returns 5 maps at reductions
    2, 4, 8, 16, 32: the stem's output (40 channels), the inputs of the
    stride-2 blocks of stages 3, 4 and 6 (32, 48, 136) and the last block's
    output (384)."""

    def __init__(self, drop_connect: float = DROP_CONNECT):
        super().__init__()
        size = B3_IMAGE_SIZE
        stem = round_filters(32)
        self._conv_stem = SameConv2d(3, stem, 3, stride=2, size=size,
                                     bias=False)
        self._bn0 = _enc_bn(stem)
        size = -(-size // 2)
        total = sum(round_repeats(r) for *_, r in B0_STAGES)
        blocks: List[MBConv] = []
        taps: List[int] = []
        cin = stem
        for si, (t, k, s, c, r) in enumerate(B0_STAGES):
            cout = round_filters(c)
            for j in range(round_repeats(r)):
                stride = s if j == 0 else 1
                if stride == 2 and si > 1:
                    taps.append(len(blocks))
                blocks.append(MBConv(cin, cout, k, stride, t, size,
                                     drop_connect * len(blocks) / total))
                if stride == 2:
                    size = -(-size // 2)
                cin = cout
        self._blocks = nn.ModuleList(blocks)
        self.taps = tuple(taps)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = F.silu(self._bn0(self._conv_stem(x)))
        feats = [h]
        for i, block in enumerate(self._blocks):
            if i in self.taps:
                feats.append(h)
            h = block(h, generator)
        feats.append(h)
        return feats


def _conv_bn_relu(cin: int, cout: int) -> nn.Sequential:
    """smp's ``Conv2dReLU``: conv3x3 (no bias), BN, ReLU."""
    return nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False),
                         BatchNorm2d(cout), nn.ReLU())


class DecoderBlock(nn.Module):
    """Nearest x2, concat the skip after, two conv-BN-ReLU."""

    def __init__(self, cin: int, skip: int, cout: int):
        super().__init__()
        self.conv1 = _conv_bn_relu(cin + skip, cout)
        self.conv2 = _conv_bn_relu(cout, cout)

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class UnetDecoder(nn.Module):
    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int]):
        super().__init__()
        # smp: the deepest map is the head, the others the skips, deepest
        # first, then none
        head, *skips = encoder_channels[::-1]
        skips = list(skips) + [0]
        ins = [head] + list(decoder_channels[:-1])
        self.blocks = nn.ModuleList(
            DecoderBlock(i, s, o)
            for i, s, o in zip(ins, skips, decoder_channels))

    def forward(self, feats):
        feats = feats[::-1]
        h = feats[0]
        skips = list(feats[1:]) + [None]
        for block, skip in zip(self.blocks, skips):
            h = block(h, skip)
        return h


class EffiUNet(nn.Module):
    def __init__(self, in_chns: int = 1, num_classes: int = 4,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        self.encoder = EfficientNetEncoder()
        channels = [round_filters(32)] + [
            round_filters(B0_STAGES[si][3]) for si in (1, 2, 4)] + [
            round_filters(B0_STAGES[-1][3])]
        self.decoder = UnetDecoder(channels, decoder_channels)
        self.classifier = nn.Conv2d(decoder_channels[-1], num_classes, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if x.shape[1] == 1:
            x = x.expand(-1, 3, -1, -1)
        return self.classifier(self.decoder(self.encoder(x, generator)))
