"""nnUNet's Generic_UNet, NCHW / NCDHW (port of
``cvssl_tpu/models/nnunet.py``; parity with the reference
``code/networks/nnunet.py``).

The reference configuration (``nnunet.py:480-529``): 16 features doubling
to at most 320, six pools of (1,2,2)x2, (2,2,2)x2, (1,2,2)x2, kernels
(1,3,3)x2 then (3,3,3)x5, strided convs down and transpose convs up, two
convs a stage, each conv then InstanceNorm (affine, eps 1e-5, biased
variance) and LeakyReLU 0.01, no dropout, no deep supervision: 30,444,656
parameters in 3D. The 2D registry takes a true 2D configuration, as JAX's
does (the reference returns the 3D net from both factories): five (2,2)
pools, 3x3 kernels, 16 features up to 480; 7,388,496 parameters at 4
classes. A patch the pools do not divide raises (the 3D default needs
depth % 4 == 0 and the plane % 64 == 0).

Module names are the reference's: ``conv_blocks_context.{d}`` (a
``StackedConvLayers``; the bottleneck's entry is a pair, ``.0`` and
``.1``), ``tu.{u}`` (the transpose convs, no bias),
``conv_blocks_localization.{u}.0``/``.1`` and ``seg_outputs.{u}``, of which
only the heads that run exist (the last one unless ``deep_supervision``,
where the reference builds all and JAX only those it runs: the 1,600
parameters of difference in 3D). Each ``StackedConvLayers`` is ``blocks``
of ``ConvNormNonlin`` (``conv``, ``instnorm``). The net computes in
float32 (JAX builds it without a dtype).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

POOLS_3D = ((1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2), (1, 2, 2), (1, 2, 2))
KERNELS_3D = ((1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3), (3, 3, 3),
              (3, 3, 3), (3, 3, 3))


class InstanceNormAffine(nn.Module):
    """torch ``InstanceNormNd(affine=True)``: per-sample, per-channel
    statistics over the spatial axes (biased variance, eps 1e-5), then a
    per-channel ``weight`` and ``bias`` (JAX ``scale``/``bias``)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        # torch.instance_norm, not F.instance_norm, which refuses a map of
        # one site a channel in train mode (JAX gives ``bias`` there)
        return torch.instance_norm(x, self.weight, self.bias, None, None,
                                   True, 0.0, self.eps,
                                   torch.backends.cudnn.enabled)


class ConvNormNonlin(nn.Module):
    """conv (symmetric k // 2 padding), InstanceNorm (affine), LeakyReLU
    0.01 (``nnunet.py:42-86``; dropout p = 0 in the reference config)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int], stride: Sequence[int]):
        super().__init__()
        conv = nn.Conv3d if len(kernel) == 3 else nn.Conv2d
        self.conv = conv(in_channels, out_channels, tuple(kernel),
                         stride=tuple(stride),
                         padding=tuple(k // 2 for k in kernel))
        self.instnorm = InstanceNormAffine(out_channels)

    def forward(self, x):
        return F.leaky_relu(self.instnorm(self.conv(x)), 0.01)


class StackedConvLayers(nn.Module):
    """``num_convs`` blocks, the stride on the first only
    (``nnunet.py:97-155``); at least one, as JAX's applies its first
    whatever ``num_convs`` says."""

    def __init__(self, in_channels: int, out_channels: int, num_convs: int,
                 kernel: Sequence[int], first_stride: Sequence[int]):
        super().__init__()
        ones = (1,) * len(kernel)
        self.blocks = nn.Sequential(*[
            ConvNormNonlin(in_channels if i == 0 else out_channels,
                           out_channels, kernel,
                           first_stride if i == 0 else ones)
            for i in range(max(num_convs, 1))])

    def forward(self, x):
        return self.blocks(x)


class GenericUNet(nn.Module):
    """Generic_UNet (``nnunet.py:186-479``) with conv pooling and
    transpose-conv upsampling; its rank is that of its kernels."""

    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 base_features: int = 16, max_features: int = 320,
                 num_conv_per_stage: int = 2,
                 pool_kernels: Sequence[Tuple[int, ...]] = POOLS_3D,
                 conv_kernels: Sequence[Tuple[int, ...]] = KERNELS_3D,
                 deep_supervision: bool = False):
        super().__init__()
        self.pool_kernels = tuple(tuple(p) for p in pool_kernels)
        self.deep_supervision = deep_supervision
        num_pool = len(self.pool_kernels)
        nd = len(conv_kernels[0])
        ones = (1,) * nd
        tconv = nn.ConvTranspose3d if nd == 3 else nn.ConvTranspose2d
        conv = nn.Conv3d if nd == 3 else nn.Conv2d

        context, widths = [], []
        features, cin = base_features, in_chns
        for d in range(num_pool):
            stride = self.pool_kernels[d - 1] if d > 0 else ones
            context.append(StackedConvLayers(cin, features,
                                             num_conv_per_stage,
                                             conv_kernels[d], stride))
            widths.append(features)
            cin = features
            features = min(int(round(features * 2)), max_features)
        context.append(nn.Sequential(
            StackedConvLayers(cin, features, num_conv_per_stage - 1,
                              conv_kernels[num_pool], self.pool_kernels[-1]),
            StackedConvLayers(features, features, 1, conv_kernels[num_pool],
                              ones)))
        self.conv_blocks_context = nn.ModuleList(context)

        tu, local, heads = [], [], {}
        below = features
        for u in range(num_pool):
            skip = widths[-(u + 1)]
            pool = self.pool_kernels[-(u + 1)]
            tu.append(tconv(below, skip, pool, stride=pool, bias=False))
            local.append(nn.Sequential(
                StackedConvLayers(2 * skip, skip, num_conv_per_stage - 1,
                                  conv_kernels[-(u + 1)], ones),
                StackedConvLayers(skip, skip, 1, conv_kernels[-(u + 1)],
                                  ones)))
            if deep_supervision or u == num_pool - 1:
                heads[str(u)] = conv(skip, num_classes, 1, bias=False)
            below = skip
        self.tu = nn.ModuleList(tu)
        self.conv_blocks_localization = nn.ModuleList(local)
        self.seg_outputs = nn.ModuleDict(heads)

    def divisor(self) -> Tuple[int, ...]:
        """The product of the pools on each axis: what the spatial extent
        must be a multiple of."""
        return tuple(math.prod(p[a] for p in self.pool_kernels)
                     for a in range(len(self.pool_kernels[0])))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        div = self.divisor()
        if any(s % d for s, d in zip(x.shape[2:], div)):
            raise ValueError(
                f"nnUNet: spatial extent {tuple(x.shape[2:])} is not a "
                f"multiple of the pools' product {div}")
        skips = []
        for block in self.conv_blocks_context[:-1]:
            x = block(x)
            skips.append(x)
        x = self.conv_blocks_context[-1](x)
        outs = []
        for u, (tu, local) in enumerate(zip(self.tu,
                                            self.conv_blocks_localization)):
            x = local(torch.cat([tu(x), skips[-(u + 1)]], dim=1))
            if str(u) in self.seg_outputs:
                outs.append(self.seg_outputs[str(u)](x))
        if self.deep_supervision:
            return tuple(outs[::-1])
        return outs[-1]


def GenericUNet2D(in_chns: int = 1, num_classes: int = 2, **kw):
    """The 2D configuration (JAX ``nnunet.GenericUNet2D``): five (2, 2)
    pools, 3x3 kernels, 16 features up to 480."""
    return GenericUNet(in_chns=in_chns, num_classes=num_classes,
                       base_features=16, max_features=480,
                       pool_kernels=tuple((2, 2) for _ in range(5)),
                       conv_kernels=tuple((3, 3) for _ in range(6)), **kw)


def GenericUNet3D(in_chns: int = 1, num_classes: int = 2, **kw):
    """The reference's 3D configuration (``nnunet.py:480-529``)."""
    return GenericUNet(in_chns=in_chns, num_classes=num_classes, **kw)
