"""2D UNet and its variants, NCHW (port of ``cvssl_tpu/models/unet.py`` on
its plain path: ``s2d_levels=0``, ``bilinear=True``).

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

from cvssl_tpu_torch.ops.batch_norm_act import batch_norm_act
from cvssl_tpu_torch.ops.dropout import BitsDropout
from cvssl_tpu_torch.parallel import mesh as pmesh

DEFAULT_FEATURES = (16, 32, 64, 128, 256)
DEFAULT_DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-statistics rule: the running
    variance follows the BIASED batch variance (torch's own uses the
    unbiased one). eps 1e-5, momentum 0.1 (flax's 0.9).

    In train mode :meth:`forward_act` runs ``ops/batch_norm_act.py``: on the
    CPU its plain version (``F.batch_norm`` with momentum 1 on scratch
    buffers, which leaves the batch mean and unbiased variance there, so the
    update costs no second pass over the activations); on the card its
    kernels, which split each channel's reduction over many blocks (ATen's
    native NCHW kernels run one block a channel) and can fuse the LeakyReLU
    that follows. ``forward`` is ``forward_act`` with no activation.

    Inside a split model call (``parallel/mesh.py::split_call``) the batch
    is the global one: the mean and then the biased variance over it come
    from two differentiable all-reduces of per-channel sums, in float32,
    and the running buffers follow the same rule with the global count, so
    they stay equal on every rank."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_act(x)

    def forward_act(self, x: torch.Tensor,
                    slope: Optional[float] = None) -> torch.Tensor:
        """This norm, then LeakyReLU(``slope``) unless ``slope`` is None."""
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
        elif (split := pmesh.current_split()) is not None:
            y = _global_batch_norm(self, x, split.mesh)
        else:
            return batch_norm_act(
                x.contiguous() if x.is_cuda else x, self.weight, self.bias,
                self.running_mean, self.running_var, self.momentum, self.eps,
                slope)
        return y if slope is None else F.leaky_relu(y, slope)


def _global_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
                       mesh) -> torch.Tensor:
    """Train-mode batch norm of this rank's rows with the statistics of the
    global batch (two-pass: the mean, then the sum of squared deviations
    from it), and the Flax running-statistics update with them."""
    dims = [0] + list(range(2, x.ndim))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    n = x.numel() // x.shape[1] * mesh.world
    with torch.autocast(x.device.type, enabled=False):
        xf = x.float()
        mean = pmesh.all_reduce_sum(mesh, xf.sum(dims)) / n
        d = xf - mean.view(shape)
        var = pmesh.all_reduce_sum(mesh, (d * d).sum(dims)) / n
        y = d * torch.rsqrt(var + bn.eps).view(shape)
        if bn.affine:
            y = y * bn.weight.view(shape) + bn.bias.view(shape)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        bn.running_var.mul_(1.0 - m).add_(var, alpha=m)
    return y.to(x.dtype)


def bilinear_resize(x: torch.Tensor, new_hw, align_corners: bool = True
                    ) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to ``new_hw``: torch's
    ``align_corners=True`` interpolation (the bilinear UpBlock's, and the
    deep-supervision heads' upsample) when asked and both new sides are
    above 1, else half-pixel centres with antialiasing, as
    ``jax.image.resize`` does. JAX: ``unet.bilinear_resize`` (NHWC)."""
    new_hw = tuple(new_hw)
    if new_hw == tuple(x.shape[2:]):
        return x
    if align_corners and min(new_hw) > 1:
        return F.interpolate(x, size=new_hw, mode="bilinear",
                             align_corners=True)
    return F.interpolate(x, size=new_hw, mode="bilinear",
                         align_corners=False, antialias=True)


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
        # each BatchNorm with the LeakyReLU after it as one op (fused on
        # the card); the Sequential keeps its 7 entries for the checkpoints
        c = self.conv_conv
        x = c[1].forward_act(c[0](x), c[2].negative_slope)
        x = c[3](x, generator)
        return c[5].forward_act(c[4](x), c[6].negative_slope)


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


# ---------------------------------------------------------------------------
# Feature perturbations (CCT / URPC). JAX: ``unet.py:411-434``, class axis
# last there, 1 here. The draws go through ``_uniform`` and ``_keep``, one
# call each per perturbation, from the caller's generator.
# ---------------------------------------------------------------------------

def _uniform(shape, lo: float, hi: float,
             generator: Optional[torch.Generator], device) -> torch.Tensor:
    """U[lo, hi) float32 draws over the batch axis (``shape[0]``; inside a
    split call drawn at the global batch, ``parallel.mesh.draw_rows``)."""
    u = pmesh.draw_rows(shape, lambda s: torch.rand(s, generator=generator,
                                                    device=device))
    return u * (hi - lo) + lo


def _keep(shape, p_keep: float, generator: Optional[torch.Generator],
          device) -> torch.Tensor:
    """Bernoulli(p_keep) boolean draws (JAX: ``uniform < p``) over the batch
    axis, as :func:`_uniform`."""
    return pmesh.draw_rows(shape, lambda s: torch.rand(
        s, generator=generator, device=device)) < p_keep


def feature_noise(x: torch.Tensor, generator: Optional[torch.Generator],
                  uniform_range: float = 0.3) -> torch.Tensor:
    """x * U(-r, r) + x with the noise drawn over ``x.shape[1:]`` and shared
    across the batch (whole on every rank of a split call)."""
    with pmesh.shared_draws():
        noise = _uniform(x.shape[1:], -uniform_range, uniform_range,
                         generator, x.device).to(x.dtype)
    return x * noise[None] + x


def feature_dropout(x: torch.Tensor,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Drop the high-attention sites: attention is the channel mean, the
    per-sample threshold max(attention) * U(0.7, 0.9); keep attention <
    threshold."""
    attention = x.mean(dim=1, keepdim=True)
    max_val = attention.reshape(x.shape[0], -1).amax(dim=1)
    thresh = max_val * _uniform((x.shape[0],), 0.7, 0.9, generator,
                                x.device)
    return x * (attention < thresh.reshape(-1, 1, 1, 1)).to(x.dtype)


def dropout_perturb(x: torch.Tensor, generator: Optional[torch.Generator],
                    p: float = 0.3) -> torch.Tensor:
    """Inverted dropout with a Bernoulli(1 - p) keep mask."""
    keep = _keep(x.shape, 1.0 - p, generator, x.device)
    return torch.where(keep, x / (1.0 - p), 0.0)


# ---------------------------------------------------------------------------
# UNet variants. The original torch tree names none of these; the module
# names are SSL4MIS's (``encoder``, ``main_decoder``, ``aux_decoder1..3``;
# ``decoder.up1..4``, ``decoder.out_conv``, ``decoder.out_conv_dp1..3``).
# ---------------------------------------------------------------------------

class UNetFeature(nn.Module):
    """UNet that also returns the decoder's last feature map: (logits, h).
    JAX: ``UNetFeature`` (``unet.py:473``)."""

    def __init__(self, in_chns: int = 1, num_classes: int = 4,
                 features: Sequence[int] = DEFAULT_FEATURES,
                 dropout: Sequence[float] = DEFAULT_DROPOUT):
        super().__init__()
        self.encoder = Encoder(in_chns, features, dropout)
        self.decoder = Decoder(num_classes, features)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x0, x1, x2, x3, x4 = self.encoder(x, generator)
        d = self.decoder
        h = d.up1(x4, x3, generator)
        h = d.up2(h, x2, generator)
        h = d.up3(h, x1, generator)
        h = d.up4(h, x0, generator)
        return d.out_conv(h), h


class UNetCCT(nn.Module):
    """One encoder, a main decoder and three aux decoders fed perturbed
    features (feature noise, dropout, feature dropout), in train mode only;
    returns four logit maps. JAX: ``UNetCCT`` (``unet.py:495``), whose
    draws come in this order: the noise of every level, then the dropout
    masks, then the feature-dropout thresholds."""

    def __init__(self, in_chns: int = 1, num_classes: int = 4,
                 features: Sequence[int] = DEFAULT_FEATURES,
                 dropout: Sequence[float] = DEFAULT_DROPOUT):
        super().__init__()
        self.encoder = Encoder(in_chns, features, dropout)
        self.main_decoder = Decoder(num_classes, features)
        self.aux_decoder1 = Decoder(num_classes, features)
        self.aux_decoder2 = Decoder(num_classes, features)
        self.aux_decoder3 = Decoder(num_classes, features)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        feats = self.encoder(x, generator)
        main = self.main_decoder(feats, generator)
        if self.training:
            aux1_f = [feature_noise(f, generator) for f in feats]
            aux2_f = [dropout_perturb(f, generator) for f in feats]
            aux3_f = [feature_dropout(f, generator) for f in feats]
        else:
            aux1_f = aux2_f = aux3_f = feats
        return (main, self.aux_decoder1(aux1_f, generator),
                self.aux_decoder2(aux2_f, generator),
                self.aux_decoder3(aux3_f, generator))


class MultiScaleDecoder(Decoder):
    """The UNet decoder with 3x3 heads on the up1..up3 outputs as well,
    each upsampled (nearest) to the input size; returns (dp0, dp1, dp2, dp3).
    ``perturb`` (URPC) applies, in train mode, dropout p = 0.5 before the
    dp3 head, feature dropout before dp2 and feature noise before dp1.
    JAX: ``_MultiScaleDecoder`` (``unet.py:523``)."""

    def __init__(self, num_classes: int, features: Sequence[int],
                 perturb: bool = False):
        super().__init__(num_classes, features)
        f = features
        self.perturb = perturb
        self.out_conv_dp3 = nn.Conv2d(f[3], num_classes, 3, padding=1)
        self.out_conv_dp2 = nn.Conv2d(f[2], num_classes, 3, padding=1)
        self.out_conv_dp1 = nn.Conv2d(f[1], num_classes, 3, padding=1)

    def forward(self, feats, out_hw, generator: Optional[torch.Generator]
                = None):
        x0, x1, x2, x3, x4 = feats
        perturb = self.perturb and self.training

        x = self.up1(x4, x3, generator)
        h3 = dropout_perturb(x, generator, p=0.5) if perturb else x
        dp3 = self.out_conv_dp3(h3)
        x = self.up2(x, x2, generator)
        h2 = feature_dropout(x, generator) if perturb else x
        dp2 = self.out_conv_dp2(h2)
        x = self.up3(x, x1, generator)
        h1 = feature_noise(x, generator) if perturb else x
        dp1 = self.out_conv_dp1(h1)
        x = self.up4(x, x0, generator)
        dp0 = self.out_conv(x)

        def up(z):  # nearest, as torch's F.interpolate default
            return F.interpolate(z, size=tuple(out_hw), mode="nearest")
        return dp0, up(dp1), up(dp2), up(dp3)


class UNetDS(nn.Module):
    """Deep-supervision UNet: four logit maps at the input size. JAX:
    ``UNetDS`` (``unet.py:564``)."""

    perturb = False

    def __init__(self, in_chns: int = 1, num_classes: int = 4,
                 features: Sequence[int] = DEFAULT_FEATURES,
                 dropout: Sequence[float] = DEFAULT_DROPOUT):
        super().__init__()
        self.encoder = Encoder(in_chns, features, dropout)
        self.decoder = MultiScaleDecoder(num_classes, features,
                                         perturb=self.perturb)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.decoder(self.encoder(x, generator), x.shape[2:],
                            generator)


class UNetURPC(UNetDS):
    """URPC UNet: UNetDS with the perturbations before its aux heads in
    train mode. JAX: ``UNetURPC`` (``unet.py:581``)."""

    perturb = True
