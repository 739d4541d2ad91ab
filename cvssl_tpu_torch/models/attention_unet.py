"""Attention-gated 3D UNet, NCDHW (port of
``cvssl_tpu/models/attention_unet.py``; parity with the reference
``code/networks/attention_unet.py`` and ``grid_attention_layer.py``,
"concatenation" mode): grid attention gates on skips 2-4, the gating
signal from the bottleneck, deep-supervision heads concatenated into the
final 1x1x1 conv. 6,469,328 parameters at ``feature_scale=4``, 2 classes.

The levels reuse ``models/unet3d.py``'s ``UnetConv3``, ``UnetUp3CT`` and
``UnetDsv3``, as JAX's do. Module names are the reference's: ``conv1`` ...
``conv4``, ``center``, ``gating`` (``.conv1.0``), ``attentionblock2`` ...
``attentionblock4`` (``gate_block_1``/``_2``, each ``theta``, ``phi``,
``psi``, ``W.0`` conv and ``W.1`` BatchNorm; ``combine_gates.0`` conv and
``.1`` BatchNorm), ``up_concat4`` ... ``up_concat1``, ``dsv4`` ... ``dsv2``,
``dsv1``, ``final``. BatchNorm follows Flax's rule
(``models/unet3d.py::BatchNorm3d``). The net computes in float32 (JAX
builds it without a dtype).

Resizes are ``jax.image.resize``'s bilinear/trilinear: half-pixel centres
(``align_corners=False``), edges clamped. JAX antialiases a downsampling
resize; no call of these nets downsamples (the gating map is resized to
the strided ``theta`` map's size, the same size, and the attention map up
to its input's), and :func:`_resize_nd` raises for one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.models import unet
from cvssl_tpu_torch.models.unet3d import (BatchNorm3d, UnetConv3, UnetDsv3,
                                           UnetUp3CT, _filters,
                                           instance_norm)

MODES = ("concatenation", "concatenation_debug", "concatenation_residual")
TORR_MODES = ("concatenation", "concatenation_softmax",
              "concatenation_sigmoid", "concatenation_mean",
              "concatenation_range_normalise", "concatenation_mean_flow")


def _resize_nd(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear (2D) / trilinear (3D) resize of an NC* tensor to ``size``,
    half-pixel centres: ``jax.image.resize`` without its antialiasing,
    which applies to downsampling only."""
    size = tuple(int(s) for s in size)
    if any(o < i for o, i in zip(size, x.shape[2:])):
        raise NotImplementedError(
            f"downsampling resize {tuple(x.shape[2:])} -> {size}: JAX "
            "antialiases it")
    if size == tuple(x.shape[2:]):
        return x
    mode = "trilinear" if len(size) == 3 else "bilinear"
    return F.interpolate(x, size=size, mode=mode, align_corners=False)


def _conv(nd: int):
    return nn.Conv3d if nd == 3 else nn.Conv2d


def _batch_norm(nd: int, channels: int) -> nn.Module:
    return (BatchNorm3d if nd == 3 else unet.BatchNorm2d)(channels, eps=1e-5,
                                                          momentum=0.1)


class _GridAttentionND(nn.Module):
    """``_GridAttentionBlockND`` (``grid_attention_layer.py:7-159``) in 2D
    or 3D (``nd``). Modes: "concatenation" (ReLU, psi, sigmoid),
    "concatenation_debug" (softplus for the ReLU) and
    "concatenation_residual" (a softmax over space for the sigmoid).
    Returns (W(att * x), att)."""

    nd = 3

    def __init__(self, in_channels: int, gating_channels: int,
                 inter_channels: int, sub_sample: int = 2,
                 mode: str = "concatenation"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: one of {MODES}")
        conv = _conv(self.nd)
        self.mode = mode
        self.theta = conv(in_channels, inter_channels, sub_sample,
                          stride=sub_sample, bias=False)
        self.phi = conv(gating_channels, inter_channels, 1)
        self.psi = conv(inter_channels, 1, 1)
        self.W = nn.Sequential(conv(in_channels, in_channels, 1),
                               _batch_norm(self.nd, in_channels))

    def forward(self, x, g):
        theta_x = self.theta(x)
        phi_g = _resize_nd(self.phi(g), theta_x.shape[2:])
        add = theta_x + phi_g
        f = F.softplus(add) if self.mode == "concatenation_debug" \
            else torch.relu(add)
        psi_f = self.psi(f)
        if self.mode == "concatenation_residual":     # softmax over space
            att = torch.softmax(psi_f.reshape(psi_f.shape[0], -1),
                                dim=-1).reshape(psi_f.shape)
        else:
            att = torch.sigmoid(psi_f)
        att = _resize_nd(att, x.shape[2:])
        return self.W(att * x), att


class GridAttentionBlock3D(_GridAttentionND):
    """3D instantiation (``grid_attention_layer.py:173-183``)."""


class GridAttentionBlock2D(_GridAttentionND):
    """2D instantiation (``grid_attention_layer.py:162-171``; no reference
    trainer uses it). x (B, C, H, W)."""

    nd = 2


class _GridAttentionNDTORR(nn.Module):
    """``_GridAttentionBlockND_TORR`` (``grid_attention_layer.py:176-390``):
    theta, phi, psi and W each optional (identity when off), six score
    normalisations, psi's bias started at 3.0 (sigmoid) or 10.0 (softmax),
    sub_sample 1 by default. As in JAX, "concatenation" normalises as
    "concatenation_sigmoid" (the reference raises at its forward)."""

    nd = 3

    def __init__(self, in_channels: int, gating_channels: int,
                 inter_channels: int, sub_sample: int = 1,
                 mode: str = "concatenation_sigmoid", bn_layer: bool = True,
                 use_w: bool = True, use_phi: bool = True,
                 use_theta: bool = True, use_psi: bool = True,
                 nonlinearity1: str = "relu"):
        super().__init__()
        if mode not in TORR_MODES:
            raise ValueError(f"mode {mode!r}: one of {TORR_MODES}")
        conv = _conv(self.nd)
        self.mode, self.nonlinearity1 = mode, nonlinearity1
        self.theta = conv(in_channels, inter_channels, sub_sample,
                          stride=sub_sample, bias=False) if use_theta else None
        self.phi = conv(gating_channels, inter_channels, sub_sample,
                        stride=sub_sample, bias=False) if use_phi else None
        self.psi = None
        if use_psi:
            self.psi = conv(inter_channels, 1, 1)
            nn.init.constant_(self.psi.bias, {
                "concatenation_sigmoid": 3.0,
                "concatenation_softmax": 10.0}.get(mode, 0.0))
        self.W = None
        if use_w:
            self.W = nn.Sequential(conv(in_channels, in_channels, 1), *(
                [_batch_norm(self.nd, in_channels)] if bn_layer else []))

    def forward(self, x, g):
        theta_x = self.theta(x) if self.theta is not None else x
        phi_g = self.phi(g) if self.phi is not None else g
        f = theta_x + _resize_nd(phi_g, theta_x.shape[2:])
        if self.nonlinearity1 == "relu":
            f = torch.relu(f)
        psi_f = self.psi(f) if self.psi is not None else f
        flat = psi_f.reshape(psi_f.shape[0], -1)
        if self.mode == "concatenation_softmax":
            att = torch.softmax(flat, dim=-1)
        elif self.mode == "concatenation_mean":
            att = flat / flat.sum(dim=-1, keepdim=True)
        elif self.mode == "concatenation_mean_flow":
            shifted = flat - flat.amin(dim=-1, keepdim=True)
            att = shifted / shifted.sum(dim=-1, keepdim=True)
        elif self.mode == "concatenation_range_normalise":
            lo = flat.amin(dim=-1, keepdim=True)
            hi = flat.amax(dim=-1, keepdim=True)
            att = (flat - lo) / (hi - lo)
        else:           # "concatenation" / "concatenation_sigmoid"
            att = torch.sigmoid(flat)
        att = _resize_nd(att.reshape(psi_f.shape), x.shape[2:])
        y = att * x
        return (self.W(y) if self.W is not None else y), att


class GridAttentionBlock2DTORR(_GridAttentionNDTORR):
    """(``grid_attention_layer.py:362-378``)"""

    nd = 2


class GridAttentionBlock3DTORR(_GridAttentionNDTORR):
    """(``grid_attention_layer.py:381-390``)"""


class MultiAttentionBlock(nn.Module):
    """Two parallel gates combined by conv, BatchNorm, ReLU
    (``attention_unet.py:113-135``). Returns (combined, both attention
    maps)."""

    def __init__(self, in_channels: int, gating_channels: int,
                 inter_channels: int):
        super().__init__()
        self.gate_block_1 = GridAttentionBlock3D(in_channels,
                                                 gating_channels,
                                                 inter_channels)
        self.gate_block_2 = GridAttentionBlock3D(in_channels,
                                                 gating_channels,
                                                 inter_channels)
        self.combine_gates = nn.Sequential(
            nn.Conv3d(2 * in_channels, in_channels, 1),
            BatchNorm3d(in_channels, eps=1e-5, momentum=0.1))

    def forward(self, x, g):
        g1, a1 = self.gate_block_1(x, g)
        g2, a2 = self.gate_block_2(x, g)
        h = self.combine_gates(torch.cat([g1, g2], dim=1))
        return torch.relu(h), torch.cat([a1, a2], dim=1)


class _GatingSignal(nn.Module):
    """1x1x1 conv, InstanceNorm, ReLU (``utils.py:192-204``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv3d(channels, channels, 1))

    def forward(self, x):
        return torch.relu(instance_norm(self.conv1[0](x)))


class AttentionUNet3D(nn.Module):
    """(``attention_unet.py:9-111``) The spatial extent must be divisible
    by 16."""

    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 feature_scale: int = 4):
        super().__init__()
        f = _filters(feature_scale)
        self.conv1 = UnetConv3(in_chns, f[0])
        self.conv2 = UnetConv3(f[0], f[1])
        self.conv3 = UnetConv3(f[1], f[2])
        self.conv4 = UnetConv3(f[2], f[3])
        self.center = UnetConv3(f[3], f[4])
        self.gating = _GatingSignal(f[4])
        self.attentionblock4 = MultiAttentionBlock(f[3], f[4], f[3])
        self.attentionblock3 = MultiAttentionBlock(f[2], f[3], f[2])
        self.attentionblock2 = MultiAttentionBlock(f[1], f[2], f[1])
        self.up_concat4 = UnetUp3CT(f[4], f[3])
        self.up_concat3 = UnetUp3CT(f[3], f[2])
        self.up_concat2 = UnetUp3CT(f[2], f[1])
        self.up_concat1 = UnetUp3CT(f[1], f[0])
        self.dsv4 = UnetDsv3(f[3], num_classes, 8)
        self.dsv3 = UnetDsv3(f[2], num_classes, 4)
        self.dsv2 = UnetDsv3(f[1], num_classes, 2)
        self.dsv1 = nn.Conv3d(f[0], num_classes, 1)
        self.final = nn.Conv3d(4 * num_classes, num_classes, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        conv1 = self.conv1(x)
        conv2 = self.conv2(F.max_pool3d(conv1, 2))
        conv3 = self.conv3(F.max_pool3d(conv2, 2))
        conv4 = self.conv4(F.max_pool3d(conv3, 2))
        center = self.center(F.max_pool3d(conv4, 2))
        gating = self.gating(center)
        g4, _ = self.attentionblock4(conv4, gating)
        up4 = self.up_concat4(g4, center)
        g3, _ = self.attentionblock3(conv3, up4)
        up3 = self.up_concat3(g3, up4)
        g2, _ = self.attentionblock2(conv2, up3)
        up2 = self.up_concat2(g2, up3)
        up1 = self.up_concat1(conv1, up2)
        return self.final(torch.cat([self.dsv1(up1), self.dsv2(up2),
                                     self.dsv3(up3), self.dsv4(up4)], dim=1))
