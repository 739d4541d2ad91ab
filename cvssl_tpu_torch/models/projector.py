"""The contrastive heads, NCHW (port of ``cvssl_tpu/models/projector.py``).

``Projector`` (the reference's ``projectors``): two conv3x3 + BatchNorm +
ReLU blocks, each followed by a 2x2 max pool, giving (ndf * 2, H/4, W/4).
The reference also defines a 1x1 ``final`` conv that its forward never
applies; like JAX, the port leaves it out. ``Classifier``: a third such
block, then a 1x1 conv, giving (ndf * 4, H/8, W/8).

Module names are the reference's (``conv_1``, ``conv_2``, ``conv_3``, each
with ``.conv`` and ``.bn``, and ``final``), the keys that
``cvssl_tpu/models/torch_convert.py::convert_projector_checkpoint`` and
``convert_classifier_checkpoint`` read. Their BatchNorm is the UNet's, with
Flax's running-statistics rule. The heads have no compute dtype in JAX:
they run in float32, and a bfloat16 logit map is cast to float32 on entry,
as Flax promotes it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.models.unet import BatchNorm2d


class _ConvBNRelu(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.bn = BatchNorm2d(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _pooled(block, x):
    return F.max_pool2d(block(x), 2, 2)


class Projector(nn.Module):
    """The unlabeled branch's projection head (reference
    ``projector.py:50-66``)."""

    def __init__(self, in_channels: int = 4, ndf: int = 8):
        super().__init__()
        self.conv_1 = _ConvBNRelu(in_channels, ndf)
        self.conv_2 = _ConvBNRelu(ndf, ndf * 2)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.conv_1.conv.weight.dtype)
        return _pooled(self.conv_2, _pooled(self.conv_1, x))


class Classifier(Projector):
    """The labeled branch's contrastive head (reference
    ``projector.py:69-94``): the projector's two blocks, a third, and the
    1x1 ``final`` conv."""

    def __init__(self, in_channels: int = 4, ndf: int = 8):
        super().__init__(in_channels, ndf)
        self.conv_3 = _ConvBNRelu(ndf * 2, ndf * 4)
        self.final = nn.Conv2d(ndf * 4, ndf * 4, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.final(_pooled(self.conv_3, super().forward(x)))
