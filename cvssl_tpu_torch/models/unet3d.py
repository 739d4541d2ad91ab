"""3D UNet family, NCDHW (port of ``cvssl_tpu/models/unet3d.py`` on its
native path, ``s2d_levels=0``): ``UNet3D`` (the reference's ``unet_3D``)
and ``UNet3DDeepSup`` (``unet_3D_dv_semi``).

Widths [64, 128, 256, 512, 1024] / ``feature_scale`` (4: [16, 32, 64, 128,
256]); each level two 3x3x3 convs, each followed by InstanceNorm (affine
False, eps 1e-5, statistics in float32) and ReLU; 2x2x2 max-pool down;
trilinear x2 up (half-pixel, edges clamped: ``jax.image.resize``'s
"trilinear"), concat skip-first, the conv block. ``UNet3D`` drops 0.3 at
the centre and before its 1x1x1 output conv (``ops/dropout.py``'s 8-bit
draws, as JAX's ``BitsDropout``); ``UNet3DDeepSup`` drops whole channels
down the decoder (p = .5, .3, .2, .1) and returns four logit maps.

Module names are the original torch code's (``conv1`` ... ``center``,
``up_concat4`` ... ``up_concat1``, ``final``; ``dsv4`` ... ``dsv1``), so
``models/convert.py`` follows ``cvssl_tpu/models/torch_convert.py::
convert_unet3d_checkpoint``.

Under the engine's bfloat16 autocast the convs compute in bfloat16; the
upsample and the pool run in their input's dtype with autocast off, the
InstanceNorm in float32 rounded to it, as JAX's modules compute in
``dtype``; ``UNet3D``'s logits come out in the compute dtype (JAX's
``logits_f32=False`` in the train step: every consumer casts to float32),
``UNet3DDeepSup``'s in float32, as JAX casts them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.models import unet
from cvssl_tpu_torch.ops.dropout import BitsDropout

BASE_FILTERS = (64, 128, 256, 512, 1024)
DEEP_SUP_DROPOUT = (0.5, 0.3, 0.2, 0.1)   # up4, up3, up2, up1


class BatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with Flax's running-statistics rule, as
    ``models/unet.py::BatchNorm2d`` (the zoo's BatchNorm: VNet's blocks,
    AttentionUNet3D's gates)."""

    forward = unet.BatchNorm2d.forward
    forward_act = unet.BatchNorm2d.forward_act


def _no_autocast(x: torch.Tensor):
    return torch.autocast(x.device.type, enabled=False)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalisation over the spatial axes (torch
    ``InstanceNorm3d`` with affine False), computed in float32 and rounded
    once to ``x``'s dtype, as JAX's ``unet3d.instance_norm`` (a bfloat16
    input straight into the norm rounds along the way on the CPU: two
    thirds of the outputs then differ by a bfloat16 step). A map of one
    site per channel (a 16^3 input's centre) normalises to 0, as in JAX;
    ``F.instance_norm`` would refuse it in train mode."""
    with _no_autocast(x):
        y = torch.instance_norm(x.float(), None, None, None, None, True,
                                0.0, eps, torch.backends.cudnn.enabled)
    return y.to(x.dtype)


def trilinear_x2(x: torch.Tensor) -> torch.Tensor:
    """Trilinear x2 upsample, half-pixel centres (``align_corners=False``),
    edges clamped: ``jax.image.resize(..., "trilinear")`` at scale 2. In
    ``x``'s dtype. JAX: ``unet3d.trilinear_x2``."""
    with _no_autocast(x):
        return F.interpolate(x, scale_factor=2, mode="trilinear",
                             align_corners=False)


def conv_f32(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` in its weights' dtype (float32) whatever the autocast:
    JAX's deep-supervision heads are Flax convs without a dtype, so a
    bfloat16 input meets float32 weights and the product is float32."""
    with _no_autocast(x):
        return conv(x.to(conv.weight.dtype))


def channel_dropout_3d(x: torch.Tensor, p: float,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
    """torch ``Dropout3d``: whole channels dropped, one Bernoulli(1 - p)
    keep per (sample, channel) (``unet._keep``), survivors scaled by
    1 / (1 - p). JAX: ``unet3d.channel_dropout``."""
    keep = unet._keep(x.shape[:2] + (1,) * (x.ndim - 2), 1.0 - p, generator,
                      x.device)
    return torch.where(keep, x / (1.0 - p), 0.0)


class _ConvNormRelu(nn.Sequential):
    """Conv3d 3^3 pad 1, InstanceNorm, ReLU: the reference's
    ``nn.Sequential(Conv3d, InstanceNorm3d, ReLU)`` (only the conv holds
    weights, at index 0)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(nn.Conv3d(in_channels, out_channels, 3, padding=1))

    def forward(self, x):
        return torch.relu(instance_norm(self[0](x)))


class UnetConv3(nn.Module):
    """Two conv-InstanceNorm-ReLU (``networks/utils.py:99-124``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = _ConvNormRelu(in_channels, out_channels)
        self.conv2 = _ConvNormRelu(out_channels, out_channels)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class UnetUp3CT(nn.Module):
    """Trilinear x2 of the level below, concat skip-first, UnetConv3
    (``utils.py:260-277``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = UnetConv3(in_channels + out_channels, out_channels)

    def forward(self, skip, below):
        return self.conv(torch.cat([skip, trilinear_x2(below)], dim=1))


class _UNet3DBody(nn.Module):
    """The levels both 3D UNets share: the encoder and the decoder's
    up-blocks, under the reference's names."""

    def __init__(self, in_chns: int, f):
        super().__init__()
        self.conv1 = UnetConv3(in_chns, f[0])
        self.conv2 = UnetConv3(f[0], f[1])
        self.conv3 = UnetConv3(f[1], f[2])
        self.conv4 = UnetConv3(f[2], f[3])
        self.center = UnetConv3(f[3], f[4])
        self.up_concat4 = UnetUp3CT(f[4], f[3])
        self.up_concat3 = UnetUp3CT(f[3], f[2])
        self.up_concat2 = UnetUp3CT(f[2], f[1])
        self.up_concat1 = UnetUp3CT(f[1], f[0])

    def encode(self, x):
        conv1 = self.conv1(x)
        conv2 = self.conv2(F.max_pool3d(conv1, 2))
        conv3 = self.conv3(F.max_pool3d(conv2, 2))
        conv4 = self.conv4(F.max_pool3d(conv3, 2))
        return conv1, conv2, conv3, conv4, self.center(F.max_pool3d(conv4,
                                                                    2))


def _filters(feature_scale: int):
    return [int(v / feature_scale) for v in BASE_FILTERS]


class UNet3D(_UNet3DBody):
    """``unet_3D`` (``unet_3D.py:20-97``): 5,884,050 parameters at the
    default widths and 2 classes."""

    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 feature_scale: int = 4, dropout: float = 0.3):
        f = _filters(feature_scale)
        super().__init__(in_chns, f)
        self.dropout1 = BitsDropout(dropout)
        self.dropout2 = BitsDropout(dropout)
        self.final = nn.Conv3d(f[0], num_classes, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        conv1, conv2, conv3, conv4, center = self.encode(x)
        center = self.dropout1(center, generator)
        up4 = self.up_concat4(conv4, center)
        up3 = self.up_concat3(conv3, up4)
        up2 = self.up_concat2(conv2, up3)
        up1 = self.up_concat1(conv1, up2)
        return self.final(self.dropout2(up1, generator))


class UnetDsv3(nn.Module):
    """1x1x1 conv to the classes, then trilinear x``scale_factor``
    (``utils.py:455-462``; ``dsv.0`` is the conv), in float32 (JAX's head
    has no dtype)."""

    def __init__(self, in_channels: int, num_classes: int,
                 scale_factor: int):
        super().__init__()
        self.dsv = nn.Sequential(nn.Conv3d(in_channels, num_classes, 1))
        self.scale_factor = scale_factor

    def forward(self, x):
        y = conv_f32(self.dsv[0], x)
        with _no_autocast(y):
            return F.interpolate(y, scale_factor=self.scale_factor,
                                 mode="trilinear", align_corners=False)


class UNet3DDeepSup(_UNet3DBody):
    """``unet_3D_dv_semi`` (``unet_3D_dv_semi.py:13-112``): in train mode
    channel dropout p = .5/.3/.2/.1 on up4..up1, in line (the dropped map
    feeds both its head and the next level); heads ``dsv4`` (x8), ``dsv3``
    (x4), ``dsv2`` (x2) and ``dsv1`` (1x1x1 at full size); returns (dsv1,
    dsv2, dsv3, dsv4), the heads in float32. The four keep masks are drawn
    in that order of levels from the caller's generator."""

    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 feature_scale: int = 4):
        f = _filters(feature_scale)
        super().__init__(in_chns, f)
        self.dsv4 = UnetDsv3(f[3], num_classes, 8)
        self.dsv3 = UnetDsv3(f[2], num_classes, 4)
        self.dsv2 = UnetDsv3(f[1], num_classes, 2)
        self.dsv1 = nn.Conv3d(f[0], num_classes, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        conv1, conv2, conv3, conv4, center = self.encode(x)
        p = DEEP_SUP_DROPOUT if self.training else (0.0,) * 4

        def drop(h, rate):
            return channel_dropout_3d(h, rate, generator) if rate else h
        up4 = drop(self.up_concat4(conv4, center), p[0])
        up3 = drop(self.up_concat3(conv3, up4), p[1])
        up2 = drop(self.up_concat2(conv2, up3), p[2])
        up1 = drop(self.up_concat1(conv1, up2), p[3])
        return (conv_f32(self.dsv1, up1), self.dsv2(up2), self.dsv3(up3),
                self.dsv4(up4))
