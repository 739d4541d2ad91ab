"""The 3D UNet of SSL4MIS (``networks/unet_3D.py``, feature_scale 4),
plain and functional: widths 16-256, two conv3x3x3-InstanceNorm-ReLU a
level, 2x2x2 max-pool down, trilinear x2 up (half-pixel centres), the skip
first in the concat, dropout 0.3 on the centre and before the 1x1x1 output
conv. Parameters are a dict under the original torch module names. Train
mode draws the two dropouts' bytes from the caller's generator, the
centre's first; eval mode draws nothing. This module imports nothing of
the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import layers as L

FEATURES = (16, 32, 64, 128, 256)
DROPOUT = 0.3
LEVELS = ("conv1", "conv2", "conv3", "conv4", "center")
UPS = ("up_concat4", "up_concat3", "up_concat2", "up_concat1")


def _unit_specs(prefix, cin, cout):
    out = []
    for j, c in ((1, cin), (2, cout)):
        out += [(f"{prefix}.conv{j}.0.weight", (cout, c, 3, 3, 3), "conv",
                 c * 27),
                (f"{prefix}.conv{j}.0.bias", (cout,), "conv", c * 27)]
    return out


def param_specs(in_chns: int, num_classes: int, features=FEATURES):
    """[(name, shape, kind, fan_in)] of every parameter."""
    f = features
    specs, cin = [], in_chns
    for name, cout in zip(LEVELS, f):
        specs += _unit_specs(name, cin, cout)
        cin = cout
    for k, name in enumerate(UPS):
        lo, hi = f[3 - k], f[4 - k]
        specs += _unit_specs(f"{name}.conv", lo + hi, lo)
    specs += [("final.weight", (num_classes, f[0], 1, 1, 1), "conv", f[0]),
              ("final.bias", (num_classes,), "conv", f[0])]
    return specs


def _unit(p, prefix, x, precision):
    for j in (1, 2):
        x = L.conv(x, p[f"{prefix}.conv{j}.0.weight"],
                   p[f"{prefix}.conv{j}.0.bias"], precision, 1)
        x = torch.relu(L.instance_norm(x))
    return x


def forward(p: dict, x: torch.Tensor, generator=None, train: bool = True,
            precision: str = "float32") -> torch.Tensor:
    """Logits (B, classes, D, H, W) of x (B, 1, D, H, W)."""
    skips = []
    for name in LEVELS:
        x = _unit(p, name, F.max_pool3d(x, 2) if skips else x, precision)
        skips.append(x)
    x = skips.pop()
    if train:
        x = L.bits_dropout(x, DROPOUT, generator)
    for name in UPS:
        up = F.interpolate(x, scale_factor=2, mode="trilinear",
                           align_corners=False)
        x = _unit(p, f"{name}.conv", torch.cat([skips.pop(), up], dim=1),
                  precision)
    if train:
        x = L.bits_dropout(x, DROPOUT, generator)
    return L.conv(x, p["final.weight"], p["final.bias"], precision)
