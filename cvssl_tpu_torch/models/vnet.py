"""VNet, NCDHW (port of ``cvssl_tpu/models/vnet.py``; parity with the
reference ``code/networks/vnet.py:145-241``).

Stage widths 16..256 with 1/2/3/3/3 conv blocks, a stride-2 conv down
(kernel 2), a stride-2 transpose conv up (kernel 2) with additive skips,
channel dropout 0.5 at the bottleneck and before the head in train mode
(factory default: ``normalization="batchnorm"``, ``has_dropout=True``,
``net_factory_3d.py:20-21``): 9,448,866 parameters at 16 filters, 2
classes.

Module names are the reference's (``block_one`` ... ``block_nine``, their
``_dw``/``_up`` blocks, ``out_conv``), each block an ``nn.Sequential``
``conv`` of conv, norm (where there is one) and ReLU, so ``block_two.conv``
holds ``0`` (conv), ``1`` (norm), ``3``, ``4``. BatchNorm follows the Flax
rule of ``models/unet.py::BatchNorm2d`` (momentum 0.9 in Flax's terms, the
biased batch variance in the running one). The channel dropout draws its
keep masks through ``models/unet.py::_keep`` on the step's generator. The
net computes in float32 (JAX builds it without a dtype).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cvssl_tpu_torch.models.unet3d import (BatchNorm3d, channel_dropout_3d,
                                           instance_norm)

NORMS = ("batchnorm", "groupnorm", "instancenorm", "none")


class InstanceNorm3d(nn.Module):
    """torch ``InstanceNorm3d`` (affine False), computed in float32:
    ``models/unet3d.py::instance_norm``."""

    def forward(self, x):
        return instance_norm(x)


def _norm(kind: str, channels: int) -> Optional[nn.Module]:
    """JAX ``vnet._Norm``: BatchNorm (eps 1e-5), GroupNorm of 16 groups,
    InstanceNorm, or none."""
    if kind not in NORMS:
        raise ValueError(f"normalization {kind!r}: one of {NORMS}")
    if kind == "batchnorm":
        return BatchNorm3d(channels, eps=1e-5, momentum=0.1)
    if kind == "groupnorm":
        return nn.GroupNorm(16, channels, eps=1e-6)
    if kind == "instancenorm":
        return InstanceNorm3d()
    return None


def _conv_norm_relu(conv: nn.Module, channels: int, kind: str):
    norm = _norm(kind, channels)
    return [conv] + ([norm] if norm is not None else []) + [nn.ReLU()]


class _Block(nn.Module):
    """An ``nn.Sequential`` of ops under the reference's attribute
    ``conv``."""

    def __init__(self, ops):
        super().__init__()
        self.conv = nn.Sequential(*ops)

    def forward(self, x):
        return self.conv(x)


def ConvStage(n_stages: int, in_channels: int, out_channels: int,
              normalization: str = "batchnorm") -> nn.Module:
    """``n_stages`` x (conv 3^3 pad 1, norm, ReLU) (``vnet.py:5-31``)."""
    ops = []
    for i in range(n_stages):
        ops += _conv_norm_relu(
            nn.Conv3d(in_channels if i == 0 else out_channels, out_channels,
                      3, padding=1), out_channels, normalization)
    return _Block(ops)


def DownConv(in_channels: int, out_channels: int,
             normalization: str = "batchnorm") -> nn.Module:
    """Stride-2 conv (kernel 2), norm, ReLU (``vnet.py:67-92``)."""
    return _Block(_conv_norm_relu(
        nn.Conv3d(in_channels, out_channels, 2, stride=2), out_channels,
        normalization))


def UpDeconv(in_channels: int, out_channels: int,
             normalization: str = "batchnorm") -> nn.Module:
    """Stride-2 transpose conv (kernel 2), norm, ReLU
    (``vnet.py:94-117``)."""
    return _Block(_conv_norm_relu(
        nn.ConvTranspose3d(in_channels, out_channels, 2, stride=2),
        out_channels, normalization))


class VNet(nn.Module):
    """(``vnet.py:145-241``) The spatial extent must be divisible by 16."""

    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 n_filters: int = 16, normalization: str = "batchnorm",
                 has_dropout: bool = True):
        super().__init__()
        nf, nz = n_filters, normalization
        self.has_dropout = has_dropout
        self.block_one = ConvStage(1, in_chns, nf, nz)
        self.block_one_dw = DownConv(nf, nf * 2, nz)
        self.block_two = ConvStage(2, nf * 2, nf * 2, nz)
        self.block_two_dw = DownConv(nf * 2, nf * 4, nz)
        self.block_three = ConvStage(3, nf * 4, nf * 4, nz)
        self.block_three_dw = DownConv(nf * 4, nf * 8, nz)
        self.block_four = ConvStage(3, nf * 8, nf * 8, nz)
        self.block_four_dw = DownConv(nf * 8, nf * 16, nz)
        self.block_five = ConvStage(3, nf * 16, nf * 16, nz)
        self.block_five_up = UpDeconv(nf * 16, nf * 8, nz)
        self.block_six = ConvStage(3, nf * 8, nf * 8, nz)
        self.block_six_up = UpDeconv(nf * 8, nf * 4, nz)
        self.block_seven = ConvStage(3, nf * 4, nf * 4, nz)
        self.block_seven_up = UpDeconv(nf * 4, nf * 2, nz)
        self.block_eight = ConvStage(2, nf * 2, nf * 2, nz)
        self.block_eight_up = UpDeconv(nf * 2, nf, nz)
        self.block_nine = ConvStage(1, nf, nf, nz)
        self.out_conv = nn.Conv3d(nf, num_classes, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                turnoff_drop: bool = False):
        drop = self.has_dropout and self.training and not turnoff_drop
        x1 = self.block_one(x)
        x2 = self.block_two(self.block_one_dw(x1))
        x3 = self.block_three(self.block_two_dw(x2))
        x4 = self.block_four(self.block_three_dw(x3))
        x5 = self.block_five(self.block_four_dw(x4))
        if drop:
            x5 = channel_dropout_3d(x5, 0.5, generator)
        x6 = self.block_six(self.block_five_up(x5) + x4)
        x7 = self.block_seven(self.block_six_up(x6) + x3)
        x8 = self.block_eight(self.block_seven_up(x7) + x2)
        x9 = self.block_nine(self.block_eight_up(x8) + x1)
        if drop:
            x9 = channel_dropout_3d(x9, 0.5, generator)
        return self.out_conv(x9)
