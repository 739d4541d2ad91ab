"""The 2D UNet of SSL4MIS (``networks/unet.py``), plain and functional:
features 16-256, conv3x3-BN-LeakyReLU-dropout-conv3x3-BN-LeakyReLU blocks,
2x2 max-pool down, 1x1 conv + bilinear x2 (align_corners) up, the skip
first in the concat, a 3x3 output conv. Parameters are a dict under the
original torch module names, so the benchmark's weights load into the
program by name. Batch norm uses the batch's statistics (train mode);
dropout draws one byte per element from the caller's generator, in the
order of the layers. This module imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import layers as L

FEATURES = (16, 32, 64, 128, 256)
DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)


def _block_specs(prefix, cin, cout):
    c = f"{prefix}.conv_conv."
    return [(c + "0.weight", (cout, cin, 3, 3), "conv", cin * 9),
            (c + "0.bias", (cout,), "conv", cin * 9),
            (c + "1.weight", (cout,), "norm_weight", 0),
            (c + "1.bias", (cout,), "norm_bias", 0),
            (c + "4.weight", (cout, cout, 3, 3), "conv", cout * 9),
            (c + "4.bias", (cout,), "conv", cout * 9),
            (c + "5.weight", (cout,), "norm_weight", 0),
            (c + "5.bias", (cout,), "norm_bias", 0)]


def param_specs(in_chns: int, num_classes: int, features=FEATURES):
    """[(name, shape, kind, fan_in)] of every parameter."""
    f = features
    specs = _block_specs("encoder.in_conv", in_chns, f[0])
    for i in range(1, 5):
        specs += _block_specs(f"encoder.down{i}.maxpool_conv.1", f[i - 1],
                              f[i])
    for k, (hi, lo) in enumerate(((4, 3), (3, 2), (2, 1), (1, 0)), 1):
        p = f"decoder.up{k}"
        specs += [(f"{p}.conv1x1.weight", (f[lo], f[hi], 1, 1), "conv",
                   f[hi]),
                  (f"{p}.conv1x1.bias", (f[lo],), "conv", f[hi])]
        specs += _block_specs(f"{p}.conv", 2 * f[lo], f[lo])
    specs += [("decoder.out_conv.weight", (num_classes, f[0], 3, 3), "conv",
               f[0] * 9),
              ("decoder.out_conv.bias", (num_classes,), "conv", f[0] * 9)]
    return specs


def _block(p, prefix, x, rate, generator, precision):
    c = f"{prefix}.conv_conv."
    x = L.conv(x, p[c + "0.weight"], p[c + "0.bias"], precision, 1)
    x = F.leaky_relu(L.batch_norm_train(x, p[c + "1.weight"],
                                        p[c + "1.bias"]), 0.01)
    x = L.bits_dropout(x, rate, generator)
    x = L.conv(x, p[c + "4.weight"], p[c + "4.bias"], precision, 1)
    return F.leaky_relu(L.batch_norm_train(x, p[c + "5.weight"],
                                           p[c + "5.bias"]), 0.01)


def forward(p: dict, x: torch.Tensor, generator=None,
            precision: str = "float32") -> torch.Tensor:
    """Train-mode logits (B, classes, H, W) of x (B, 1, H, W)."""
    d = DROPOUT
    feats = [_block(p, "encoder.in_conv", x, d[0], generator, precision)]
    for i in range(1, 5):
        feats.append(_block(p, f"encoder.down{i}.maxpool_conv.1",
                            F.max_pool2d(feats[-1], 2), d[i], generator,
                            precision))
    x = feats[4]
    for k in range(1, 5):
        pre = f"decoder.up{k}"
        up = L.conv(x, p[f"{pre}.conv1x1.weight"], p[f"{pre}.conv1x1.bias"],
                    precision)
        up = F.interpolate(up, scale_factor=2, mode="bilinear",
                           align_corners=True)
        x = _block(p, f"{pre}.conv", torch.cat([feats[4 - k], up], dim=1),
                   0.0, generator, precision)
    return L.conv(x, p["decoder.out_conv.weight"], p["decoder.out_conv.bias"],
                  precision, 1)
