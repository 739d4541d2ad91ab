"""ENet, NCHW (port of ``cvssl_tpu/models/enet.py``): the initial conv +
max-pool block, the bottleneck encoder (regular, dilated and asymmetric),
a max-unpool decoder and a transpose-conv head; PReLU in the encoder, ReLU
in the decoder. 349,284 parameters at 1 -> 4 classes. Even sides only, as
in JAX.

Module names are the reference torch code's (``initial_block``,
``downsample1_0``, ``regular1_1`` ... ``transposed_conv``; inside a block
``ext_conv1``.. as ``Sequential(conv, bn, act)``), so
``models/convert.py::_enet`` names the Flax counterparts. Each PReLU is
torch's ``nn.PReLU()`` (one slope of shape (1,), 0.25 at init); JAX's is a
scalar of shape (), which the converter reshapes.

The max-unpool is JAX's mask, not torch's indices: the downsampling block
marks every input equal to its 2x2 window's max (ties give more than one
1), and the unpool multiplies the nearest x2 upsample by that mask.
``nn.MaxUnpool2d`` places one value a window and differs on ties (a window
of zeros after a ReLU).

The head is Flax's 3x3 stride-2 ``ConvTranspose`` with SAME padding,
cropped to the input's size: torch's ``conv_transpose2d`` with no padding
and the flipped kernel (``convert.torch_kernel``), then the same crop.

The channel dropouts (p 0.01 in the first stage, 0.1 after) draw their
keep masks through ``unet._keep`` from the caller's generator, block
after block in JAX's order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.models.unet import BatchNorm2d
from cvssl_tpu_torch.models.unet3d import channel_dropout_3d


def _act(relu: bool) -> nn.Module:
    return nn.ReLU() if relu else nn.PReLU()


def _conv_bn_act(cin: int, cout: int, kernel, relu: bool, **kw
                 ) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, bias=False, **kw),
                         BatchNorm2d(cout), _act(relu))


def _dropout(x, p: float, training: bool,
             generator: Optional[torch.Generator]):
    if p > 0 and training:
        return channel_dropout_3d(x, p, generator)
    return x


class InitialBlock(nn.Module):
    """conv3x3/s2 (out - in channels) beside maxpool3/s2 (pad -inf),
    concat, BN, act."""

    def __init__(self, in_channels: int, out_channels: int,
                 relu: bool = False):
        super().__init__()
        self.main_branch = nn.Conv2d(in_channels, out_channels - in_channels,
                                     3, stride=2, padding=1, bias=False)
        self.batch_norm = BatchNorm2d(out_channels)
        self.out_activation = _act(relu)

    def forward(self, x):
        main = self.main_branch(x)
        ext = F.max_pool2d(x, 3, stride=2, padding=1)
        return self.out_activation(self.batch_norm(torch.cat([main, ext],
                                                             dim=1)))


class RegularBottleneck(nn.Module):
    """1x1 projection, a (dilated or asymmetric) conv, 1x1 expansion, each
    with BN and act; channel dropout; residual add and act."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 padding: int = 0, dilation: int = 1,
                 asymmetric: bool = False, dropout_prob: float = 0.0,
                 relu: bool = True, internal_ratio: int = 4):
        super().__init__()
        internal = channels // internal_ratio
        self.dropout_prob = dropout_prob
        self.ext_conv1 = _conv_bn_act(channels, internal, 1, relu)
        if asymmetric:
            self.ext_conv2 = nn.Sequential(
                nn.Conv2d(internal, internal, (kernel_size, 1),
                          padding=(padding, 0), dilation=dilation,
                          bias=False),
                BatchNorm2d(internal), _act(relu),
                nn.Conv2d(internal, internal, (1, kernel_size),
                          padding=(0, padding), dilation=dilation,
                          bias=False),
                BatchNorm2d(internal), _act(relu))
        else:
            self.ext_conv2 = _conv_bn_act(internal, internal, kernel_size,
                                          relu, padding=padding,
                                          dilation=dilation)
        self.ext_conv3 = _conv_bn_act(internal, channels, 1, relu)
        self.out_activation = _act(relu)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        ext = self.ext_conv3(self.ext_conv2(self.ext_conv1(x)))
        ext = _dropout(ext, self.dropout_prob, self.training, generator)
        return self.out_activation(x + ext)


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2: each element repeated over its 2x2 block."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def max_pool_with_mask(x: torch.Tensor):
    """2x2/s2 max pool and its mask at the input's size: 1 where the input
    equals its window's max (every tied position)."""
    pooled = F.max_pool2d(x, 2)
    mask = (x == _up2(pooled)[:, :, :x.shape[2], :x.shape[3]]).to(x.dtype)
    return pooled, mask


def unpool_with_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _up2(x)[:, :, :mask.shape[2], :mask.shape[3]] * mask


class DownsamplingBottleneck(nn.Module):
    """main: max pool (and its mask), zero channels appended; ext: conv2x2
    /s2, conv3x3, conv1x1, channel dropout; add, act."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout_prob: float = 0.0, relu: bool = True,
                 internal_ratio: int = 4):
        super().__init__()
        internal = in_channels // internal_ratio
        self.out_channels = out_channels
        self.dropout_prob = dropout_prob
        self.ext_conv1 = _conv_bn_act(in_channels, internal, 2, relu,
                                      stride=2)
        self.ext_conv2 = _conv_bn_act(internal, internal, 3, relu, padding=1)
        self.ext_conv3 = _conv_bn_act(internal, out_channels, 1, relu)
        self.out_activation = _act(relu)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        main, mask = max_pool_with_mask(x)
        main = F.pad(main, (0, 0, 0, 0, 0, self.out_channels - main.shape[1]))
        ext = self.ext_conv3(self.ext_conv2(self.ext_conv1(x)))
        ext = _dropout(ext, self.dropout_prob, self.training, generator)
        return self.out_activation(main + ext), mask


class UpsamplingBottleneck(nn.Module):
    """main: 1x1 conv, BN, the mask unpool; ext: 1x1, transpose conv2x2
    /s2, 1x1, channel dropout; add, act."""

    def __init__(self, in_channels: int, out_channels: int,
                 dropout_prob: float = 0.0, relu: bool = True,
                 internal_ratio: int = 4):
        super().__init__()
        internal = in_channels // internal_ratio
        self.dropout_prob = dropout_prob
        self.main_conv1 = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 1, bias=False),
            BatchNorm2d(out_channels))
        self.ext_conv1 = _conv_bn_act(in_channels, internal, 1, relu)
        self.ext_tconv1 = nn.ConvTranspose2d(internal, internal, 2, stride=2,
                                             bias=False)
        self.ext_tconv1_bnorm = BatchNorm2d(internal)
        self.ext_tconv1_activation = _act(relu)
        self.ext_conv2 = _conv_bn_act(internal, out_channels, 1, relu)
        self.out_activation = _act(relu)

    def forward(self, x, mask, generator: Optional[torch.Generator] = None):
        main = unpool_with_mask(self.main_conv1(x), mask)
        ext = self.ext_tconv1_activation(self.ext_tconv1_bnorm(
            self.ext_tconv1(self.ext_conv1(x))))
        ext = self.ext_conv2(ext)
        ext = _dropout(ext, self.dropout_prob, self.training, generator)
        return self.out_activation(main + ext)


# stages 2 and 3's blocks: (kernel, padding, dilation, asymmetric)
_STAGE = ((3, 1, 1, False), (3, 2, 2, False), (5, 2, 1, True),
          (3, 4, 4, False), (3, 1, 1, False), (3, 8, 8, False),
          (5, 2, 1, True), (3, 16, 16, False))
STAGE_NAMES = ("regular", "dilated", "asymmetric", "dilated", "regular",
                "dilated", "asymmetric", "dilated")


class ENet(nn.Module):
    def __init__(self, in_chns: int = 1, num_classes: int = 4):
        super().__init__()
        self.initial_block = InitialBlock(in_chns, 16, relu=False)
        self.downsample1_0 = DownsamplingBottleneck(16, 64, 0.01, relu=False)
        for i in range(1, 5):
            setattr(self, f"regular1_{i}", RegularBottleneck(
                64, padding=1, dropout_prob=0.01, relu=False))
        self.downsample2_0 = DownsamplingBottleneck(64, 128, 0.1, relu=False)
        for stage in (2, 3):
            for i, ((k, pad, dil, asym), kind) in enumerate(
                    zip(_STAGE, STAGE_NAMES), 1):
                setattr(self, f"{kind}{stage}_{i}", RegularBottleneck(
                    128, kernel_size=k, padding=pad, dilation=dil,
                    asymmetric=asym, dropout_prob=0.1, relu=False))
        self.upsample4_0 = UpsamplingBottleneck(128, 64, 0.1, relu=True)
        self.regular4_1 = RegularBottleneck(64, padding=1, dropout_prob=0.1)
        self.regular4_2 = RegularBottleneck(64, padding=1, dropout_prob=0.1)
        self.upsample5_0 = UpsamplingBottleneck(64, 16, 0.1, relu=True)
        self.regular5_1 = RegularBottleneck(16, padding=1, dropout_prob=0.1)
        self.transposed_conv = nn.ConvTranspose2d(16, num_classes, 3,
                                                  stride=2, bias=False)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        g = generator
        h, w = x.shape[2], x.shape[3]
        x = self.initial_block(x)
        x, mask1 = self.downsample1_0(x, g)
        for i in range(1, 5):
            x = getattr(self, f"regular1_{i}")(x, g)
        x, mask2 = self.downsample2_0(x, g)
        for stage in (2, 3):
            for i, kind in enumerate(STAGE_NAMES, 1):
                x = getattr(self, f"{kind}{stage}_{i}")(x, g)
        x = self.upsample4_0(x, mask2, g)
        x = self.regular4_2(self.regular4_1(x, g), g)
        x = self.upsample5_0(x, mask1, g)
        x = self.regular5_1(x, g)
        # the crop is a view; the fused loss takes NCHW-contiguous logits
        return self.transposed_conv(x)[:, :, :h, :w].contiguous()
