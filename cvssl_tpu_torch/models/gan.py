"""pix2pix/CycleGAN-style GAN scaffolding, NCHW (port of
``cvssl_tpu/models/gan.py``, the GAN section of the reference's
``code/networks/networks_other.py``): ``gan_loss``, ``ResnetBlock`` and
``ResnetGenerator``, ``UnetSkipConnectionBlock`` and ``UnetGenerator``,
``NLayerDiscriminator``, ``define_g`` and ``define_d``. No training path
calls any of them, in JAX or here.

Module names are the reference's ``nn.Sequential`` indices (``model.{i}``;
a U-Net block's inner block is one index of its ``model``, so its tensors
nest as ``model.model.1.model.{j}`` ...), so a reference ``.pth`` of
``NLayerDiscriminator`` or ``UnetGenerator`` is the port's ``state_dict``.
The reference's ``ResnetGenerator`` cannot be built as shipped (its
``__init__`` is cut off mid-loop); JAX's is the standard Johnson-style
generator, and the port takes pix2pix's layout of it (``model.{i}``, each
block's ``conv_block.{j}``), with JAX's 4x4 stride-2 transpose convs.

Flax infers input channels; torch needs them, so every net and both
factories take ``input_nc`` as a keyword, 1 by default (a grayscale image,
the repo's ``in_chns`` default), JAX's one signature difference.

Norms: "batch" is ``unet.BatchNorm2d`` (Flax's running-statistics rule),
"instance" ``nn.InstanceNorm2d`` without affine (eps 1e-5), "none" an
``nn.Identity`` in the norm's place, so the indices do not move; convs
carry a bias only under "instance" (the outermost U-Net up-conv and the
discriminator's first and last convs always do). A transpose conv is
``ConvTranspose2d(k=4, stride=2, padding=1)``, Flax's
``ConvTranspose((4, 4), (2, 2), "SAME")`` with the kernel flipped
(``models/convert.py``). Dropout (0.5) draws its keep mask through
``unet._keep`` from the ``generator`` the caller passes to ``forward``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cvssl_tpu_torch.models import unet

_NORMS = ("batch", "instance", "none")
_PADS = {"reflect": nn.ReflectionPad2d, "replicate": nn.ReplicationPad2d}


def gan_loss(pred: torch.Tensor, target_is_real: bool,
             use_lsgan: bool = True, real_label: float = 1.0,
             fake_label: float = 0.0) -> torch.Tensor:
    """LSGAN (the mean squared error to a constant) or vanilla (binary
    cross-entropy of probabilities against a constant) GAN loss, in
    float32. JAX's formula, not ``F.binary_cross_entropy``: the
    probabilities are clipped to [1e-12, 1 - 1e-12] in float32, where the
    upper end rounds to 1, so a saturated probability gives JAX's inf or
    nan where torch's BCE would clamp each log at -100."""
    pred = pred.float()
    target = torch.tensor(real_label if target_is_real else fake_label,
                          dtype=torch.float32, device=pred.device)
    if use_lsgan:
        return torch.mean((pred - target) ** 2)
    eps = 1e-12
    p = torch.clamp(pred, eps, 1.0 - eps)
    return -torch.mean(target * torch.log(p)
                       + (1.0 - target) * torch.log1p(-p))


def _norm(norm: str, channels: int) -> nn.Module:
    if norm == "batch":
        return unet.BatchNorm2d(channels)
    if norm == "instance":
        return nn.InstanceNorm2d(channels, affine=False, eps=1e-5)
    if norm == "none":
        return nn.Identity()
    raise NotImplementedError(f"norm {norm!r}; options {_NORMS}")


def _use_bias(norm: str) -> bool:
    """The reference's convs drop their bias unless InstanceNorm follows."""
    return norm == "instance"


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose keep mask is drawn from the caller's generator
    (``unet._keep``); survivors are scaled by 1 / (1 - p)."""

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = unet._keep(x.shape, 1.0 - self.p, generator, x.device)
        return torch.where(keep, x / (1.0 - self.p), 0.0)


def _run(seq: nn.Sequential, x: torch.Tensor,
         generator: Optional[torch.Generator]) -> torch.Tensor:
    """``seq`` on ``x``, the generator passed to each module that draws."""
    for m in seq:
        x = (m(x, generator) if isinstance(
            m, (Dropout, ResnetBlock, UnetSkipConnectionBlock)) else m(x))
    return x


class ResnetBlock(nn.Module):
    """pad, conv3, norm, ReLU, [dropout], pad, conv3, norm, plus the input
    (``conv_block``: pix2pix's layout; with "zero" padding the convs pad
    and there is no pad module)."""

    def __init__(self, dim: int, padding_type: str = "reflect",
                 norm: str = "batch", use_dropout: bool = False):
        super().__init__()
        if padding_type not in _PADS and padding_type != "zero":
            raise NotImplementedError(f"padding {padding_type!r}")
        bias = _use_bias(norm)
        # a pad module before a 'valid' conv, or the conv pads the zeros
        padded = padding_type in _PADS
        layers = []
        for i in range(2):
            if i and use_dropout:
                layers.append(Dropout(0.5))
            if padded:
                layers.append(_PADS[padding_type](1))
            layers += [nn.Conv2d(dim, dim, 3, padding=0 if padded else 1,
                                 bias=bias),
                       _norm(norm, dim)]
            if not i:
                layers.append(nn.ReLU(True))
        self.conv_block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return x + _run(self.conv_block, x, generator)


class ResnetGenerator(nn.Module):
    """Johnson-style generator: a 7x7 stem, two stride-2 downs,
    ``n_blocks`` residual blocks, two 4x4 stride-2 transpose-conv ups, a
    7x7 head and tanh."""

    def __init__(self, output_nc: int, ngf: int = 64, norm: str = "batch",
                 use_dropout: bool = False, n_blocks: int = 6,
                 padding_type: str = "reflect", *, input_nc: int = 1):
        super().__init__()
        if n_blocks < 0:
            raise ValueError(f"n_blocks {n_blocks} < 0")
        bias = _use_bias(norm)
        layers = [nn.ReflectionPad2d(3),
                  nn.Conv2d(input_nc, ngf, 7, bias=bias), _norm(norm, ngf),
                  nn.ReLU(True)]
        for i in range(2):
            c = ngf * 2 ** i
            layers += [nn.Conv2d(c, 2 * c, 3, stride=2, padding=1, bias=bias),
                       _norm(norm, 2 * c), nn.ReLU(True)]
        layers += [ResnetBlock(ngf * 4, padding_type, norm, use_dropout)
                   for _ in range(n_blocks)]
        for i in range(2):
            c = ngf * 2 ** (2 - i)
            layers += [nn.ConvTranspose2d(c, c // 2, 4, stride=2, padding=1,
                                          bias=bias),
                       _norm(norm, c // 2), nn.ReLU(True)]
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7),
                   nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return _run(self.model, x, generator)


class UnetSkipConnectionBlock(nn.Module):
    """x -> cat(x, up(inner(down(x)))) (the outermost block returns
    up(...) alone, through tanh). ``model`` holds, in the reference's
    order: [LeakyReLU(0.2)], the 4x4 stride-2 down conv, [its norm],
    [``inner``], ReLU, the transpose up conv, then its norm and [dropout]
    (tanh at the outermost level)."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 inner: Optional["UnetSkipConnectionBlock"] = None,
                 outermost: bool = False, innermost: bool = False,
                 norm: str = "batch", use_dropout: bool = False, *,
                 input_nc: Optional[int] = None):
        super().__init__()
        self.outermost = outermost
        bias = _use_bias(norm)
        down = nn.Conv2d(outer_nc if input_nc is None else input_nc,
                         inner_nc, 4, stride=2, padding=1, bias=bias)
        up_in = inner_nc if innermost else 2 * inner_nc
        up = nn.ConvTranspose2d(up_in, outer_nc, 4, stride=2, padding=1,
                                bias=bias or outermost)
        if outermost:
            layers = [down, inner, nn.ReLU(True), up, nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(True), up,
                      _norm(norm, outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), down, _norm(norm, inner_nc),
                      inner, nn.ReLU(True), up, _norm(norm, outer_nc)]
            if use_dropout:
                layers.append(Dropout(0.5))
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # the reference's LeakyReLU here is in place, so its skip carries
        # the activated x; JAX's and this one carry x as it came in
        y = _run(self.model, x, generator)
        return y if self.outermost else torch.cat([x, y], dim=1)


class UnetGenerator(nn.Module):
    """``num_downs`` nested skip blocks (128^2 takes 7, 256^2 takes 8),
    the innermost ``num_downs - 5`` below the 8 * ngf level with dropout
    when ``use_dropout``."""

    def __init__(self, output_nc: int, num_downs: int, ngf: int = 64,
                 norm: str = "batch", use_dropout: bool = False, *,
                 input_nc: int = 1):
        super().__init__()
        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True,
                                        norm=norm)
        for _ in range(num_downs - 5):
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, block,
                                            norm=norm,
                                            use_dropout=use_dropout)
        for mult in (4, 2, 1):
            block = UnetSkipConnectionBlock(ngf * mult, ngf * mult * 2,
                                            block, norm=norm)
        self.model = UnetSkipConnectionBlock(output_nc, ngf, block,
                                             outermost=True, norm=norm,
                                             input_nc=input_nc)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.model(x, generator)


class NLayerDiscriminator(nn.Module):
    """PatchGAN: a 4x4 stride-2 conv ladder (ndf doubling, capped at 8x),
    one 4x4 stride-1 level and a 1-channel map of patch logits (through a
    sigmoid with ``use_sigmoid``)."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, norm: str = "batch",
                 use_sigmoid: bool = False, *, input_nc: int = 1):
        super().__init__()
        bias = _use_bias(norm)
        layers = [nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1),
                  nn.LeakyReLU(0.2, True)]
        nf = 1
        # n_layers - 1 levels at stride 2, then one at stride 1
        levels = [(n, 2) for n in range(1, n_layers)] + [(n_layers, 1)]
        for n, stride in levels:
            prev, nf = nf, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * nf, 4, stride=stride,
                                 padding=1, bias=bias),
                       _norm(norm, ndf * nf), nn.LeakyReLU(0.2, True)]
        layers.append(nn.Conv2d(ndf * nf, 1, 4, stride=1, padding=1))
        if use_sigmoid:
            layers.append(nn.Sigmoid())
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def define_g(output_nc: int, ngf: int, which_model_netG: str,
             norm: str = "batch", use_dropout: bool = False, *,
             input_nc: int = 1) -> nn.Module:
    """The reference's ``define_G`` (without its weight init: see
    ``models/initializers.py::init_weights``)."""
    if which_model_netG == "resnet_9blocks":
        return ResnetGenerator(output_nc, ngf, norm, use_dropout, n_blocks=9,
                               input_nc=input_nc)
    if which_model_netG == "resnet_6blocks":
        return ResnetGenerator(output_nc, ngf, norm, use_dropout, n_blocks=6,
                               input_nc=input_nc)
    if which_model_netG == "unet_128":
        return UnetGenerator(output_nc, 7, ngf, norm, use_dropout,
                             input_nc=input_nc)
    if which_model_netG == "unet_256":
        return UnetGenerator(output_nc, 8, ngf, norm, use_dropout,
                             input_nc=input_nc)
    raise NotImplementedError(
        f"Generator model name [{which_model_netG}] is not recognized")


def define_d(ndf: int, which_model_netD: str, n_layers_d: int = 3,
             norm: str = "batch", use_sigmoid: bool = False, *,
             input_nc: int = 1) -> nn.Module:
    """The reference's ``define_D`` (without its weight init)."""
    if which_model_netD == "basic":
        return NLayerDiscriminator(ndf, 3, norm, use_sigmoid,
                                   input_nc=input_nc)
    if which_model_netD == "n_layers":
        return NLayerDiscriminator(ndf, n_layers_d, norm, use_sigmoid,
                                   input_nc=input_nc)
    raise NotImplementedError(
        f"Discriminator model name [{which_model_netD}] is not recognized")
