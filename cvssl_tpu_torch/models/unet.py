"""2D UNet, NCHW (port of ``cvssl_tpu/models/unet.py`` on its plain path:
``s2d_levels=0``, ``bilinear=True``).

Module names are the original torch code's (``encoder.in_conv.conv_conv.0``
... ``decoder.out_conv``), so ``models/convert.py`` is the inverse of
``cvssl_tpu/models/torch_convert.py::convert_unet_checkpoint`` and
reference ``.pth`` files load as they are.

Every ``forward`` takes an optional ``torch.Generator`` for the dropout
bytes. Logits come out in the compute dtype (bfloat16 under the engine's
autocast on CUDA); every consumer casts them to float32 at entry, as the JAX
train step does with ``logits_f32=False``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.ops.dropout import BitsDropout

DEFAULT_FEATURES = (16, 32, 64, 128, 256)
DEFAULT_DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-statistics rule: the running
    variance follows the BIASED batch variance (torch's own uses the
    unbiased one). eps 1e-5, momentum 0.1 (flax's 0.9).

    The batch statistics come out of the normalisation itself: run with
    momentum 1 on scratch buffers, ``F.batch_norm`` (cuDNN on the card)
    leaves the batch mean and unbiased variance there, so the update costs no
    second pass over the activations."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m * (n - 1) / n)
        return y


class ConvBlock(nn.Module):
    """conv3x3-BN-LeakyReLU-dropout-conv3x3-BN-LeakyReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout_p: float):
        super().__init__()
        self.conv_conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1),
            BatchNorm2d(out_channels),
            nn.LeakyReLU(0.01),
            BitsDropout(dropout_p),
            nn.Conv2d(out_channels, out_channels, 3, padding=1),
            BatchNorm2d(out_channels),
            nn.LeakyReLU(0.01))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        c = self.conv_conv
        x = c[2](c[1](c[0](x)))
        x = c[3](x, generator)
        return c[6](c[5](c[4](x)))


class DownBlock(nn.Module):
    """2x2 maxpool then ConvBlock."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout_p: float):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2), ConvBlock(in_channels, out_channels, dropout_p))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.maxpool_conv[1](self.maxpool_conv[0](x), generator)


class UpBlock(nn.Module):
    """1x1 conv to the skip's width, bilinear x2 (align_corners), concat
    skip-first (``torch.cat([x2, x1], 1)``), ConvBlock."""

    def __init__(self, in_channels1: int, in_channels2: int,
                 out_channels: int, dropout_p: float = 0.0):
        super().__init__()
        self.conv1x1 = nn.Conv2d(in_channels1, in_channels2, 1)
        self.up = nn.Upsample(scale_factor=2, mode="bilinear",
                              align_corners=True)
        self.conv = ConvBlock(in_channels2 * 2, out_channels, dropout_p)

    def forward(self, x1, x2, generator: Optional[torch.Generator] = None):
        x1 = self.up(self.conv1x1(x1))
        return self.conv(torch.cat([x2, x1], dim=1), generator)


class Encoder(nn.Module):
    def __init__(self, in_chns: int, features: Sequence[int],
                 dropout: Sequence[float]):
        super().__init__()
        f, d = features, dropout
        self.in_conv = ConvBlock(in_chns, f[0], d[0])
        self.down1 = DownBlock(f[0], f[1], d[1])
        self.down2 = DownBlock(f[1], f[2], d[2])
        self.down3 = DownBlock(f[2], f[3], d[3])
        self.down4 = DownBlock(f[3], f[4], d[4])

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x0 = self.in_conv(x, generator)
        x1 = self.down1(x0, generator)
        x2 = self.down2(x1, generator)
        x3 = self.down3(x2, generator)
        x4 = self.down4(x3, generator)
        return [x0, x1, x2, x3, x4]


class Decoder(nn.Module):
    def __init__(self, num_classes: int, features: Sequence[int]):
        super().__init__()
        f = features
        self.up1 = UpBlock(f[4], f[3], f[3])
        self.up2 = UpBlock(f[3], f[2], f[2])
        self.up3 = UpBlock(f[2], f[1], f[1])
        self.up4 = UpBlock(f[1], f[0], f[0])
        self.out_conv = nn.Conv2d(f[0], num_classes, 3, padding=1)

    def forward(self, feats, generator: Optional[torch.Generator] = None):
        x0, x1, x2, x3, x4 = feats
        x = self.up1(x4, x3, generator)
        x = self.up2(x, x2, generator)
        x = self.up3(x, x1, generator)
        x = self.up4(x, x0, generator)
        return self.out_conv(x)


class UNet(nn.Module):
    """The workhorse 2D UNet: 1,813,764 parameters at the default widths."""

    def __init__(self, in_chns: int = 1, num_classes: int = 4,
                 features: Sequence[int] = DEFAULT_FEATURES,
                 dropout: Sequence[float] = DEFAULT_DROPOUT):
        super().__init__()
        self.encoder = Encoder(in_chns, features, dropout)
        self.decoder = Decoder(num_classes, features)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.decoder(self.encoder(x, generator), generator)
