"""Attention modules (port of ``cvssl_tpu/models/attention.py``, the
reference's ``code/networks/attention.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv``'s 1x1 weights over the channel axis of an (N, C, ...)
    tensor of any number of spatial axes."""
    y = F.conv1d(x.flatten(2), conv.weight.flatten(1)[..., None], conv.bias)
    return y.unflatten(2, x.shape[2:])


class SCSEModule(nn.Module):
    """Concurrent spatial and channel squeeze-excite: cSE (the spatial
    mean, a 1x1 conv to ``max(in_channels // reduction, 1)``, ReLU, a 1x1
    conv back, sigmoid) gates the channels, sSE (a 1x1 conv to one channel,
    sigmoid) the sites; the output is ``x * cse + x * sse``.

    The names are smp's (``cSE.1``, ``cSE.3``, ``sSE.0``). Flax infers the
    input channels, so JAX has no ``in_channels``. As JAX's, the module
    takes (N, C, H, W) and (N, C, D, H, W): the mean runs over every axis
    after the channel axis, and the 1x1 convs over the channel axis."""

    def __init__(self, in_channels: int, reduction: int = 16):
        super().__init__()
        mid = max(in_channels // reduction, 1)
        self.cSE = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(in_channels, mid, 1),
            nn.ReLU(inplace=True), nn.Conv2d(mid, in_channels, 1),
            nn.Sigmoid())
        self.sSE = nn.Sequential(nn.Conv2d(in_channels, 1, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)
        s = torch.relu(_conv1x1(self.cSE[1], s))
        s = torch.sigmoid(_conv1x1(self.cSE[3], s))
        q = torch.sigmoid(_conv1x1(self.sSE[0], x))
        return x * s + x * q
