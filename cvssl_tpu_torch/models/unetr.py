"""UNETR, NCDHW (port of ``cvssl_tpu/models/unetr.py``): the reference's
``unetr`` (``net_factory_3d.py:24-36``): img 96^3, patch 16^3, hidden 768,
12 layers, 12 heads, MLP 3072, learned position embeddings, feature size
16, parameter-free InstanceNorm, residual conv blocks. 92,783,842
parameters at one input channel and 2 classes.

Module names are MONAI's, the keys ``cvssl_tpu/models/monai_checkpoint.py``
reads (``vit.patch_embedding.patch_embeddings.1``, ``vit.blocks.{i}.attn.
qkv``, ``encoder1.layer.conv1.conv``, ``encoder2.blocks.{i}.0.conv``,
``decoder5.transp_conv.conv``, ``out.conv.conv``, ...), so a MONAI
``state_dict`` loads as it is (``models/monai_checkpoint.py`` checks it)
and ``models/convert.py`` maps the model onto the Flax tree.

As in JAX: the ViT's skip taps are the outputs after blocks 4, 7 and 10,
the bottleneck takes the final tokens through the ViT's closing
LayerNorm; attention is MONAI's SABlock (a bias-free qkv Dense packed
qkv-major, a biased ``out_proj``; softmax in float32); the patches are
flattened channel-last, ``(x y z c)``; every decoder conv and deconv is
bias-free, only the 1x1x1 head has a bias.

The position table fixes the input size: the model is built for
``img_size`` (each side a multiple of 16) and a forward at another size
raises, where JAX sizes the table at init and fails at a reshape. JAX's
``dropout_rate`` is not ported (the reference trains with none).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.models.unet3d import instance_norm

PATCH = 16


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


class ConvLayer(nn.Module):
    """MONAI ``Convolution(conv_only=True)``: the conv under ``.conv``;
    bias-free unless ``bias``. ``transposed``: a k2 s2 deconv."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, bias: bool = False,
                 transposed: bool = False):
        super().__init__()
        if transposed:
            self.conv = nn.ConvTranspose3d(in_channels, out_channels, kernel,
                                           stride=stride, bias=bias)
        else:
            self.conv = nn.Conv3d(in_channels, out_channels, kernel,
                                  stride=stride, padding=kernel // 2,
                                  bias=bias)

    def forward(self, x):
        return self.conv(x)


class UnetResBlock(nn.Module):
    """MONAI ``UnetResBlock``: conv3-IN-lrelu, conv3-IN, plus the input
    (through a 1x1x1 conv and IN where channels or stride change), then
    lrelu. JAX: ``_ResConvBlock``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, out_channels, 3, stride)
        self.conv2 = ConvLayer(out_channels, out_channels, 3)
        if in_channels != out_channels or stride != 1:
            self.conv3 = ConvLayer(in_channels, out_channels, 1, stride)
        else:
            self.conv3 = None

    def forward(self, x):
        h = _lrelu(instance_norm(self.conv1(x)))
        h = instance_norm(self.conv2(h))
        if self.conv3 is not None:
            x = instance_norm(self.conv3(x))
        return _lrelu(h + x)


class UnetrBasicBlock(nn.Module):
    """MONAI ``UnetrBasicBlock`` (res_block): the res block under
    ``.layer``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels)

    def forward(self, x):
        return self.layer(x)


class UnetrPrUpBlock(nn.Module):
    """MONAI ``UnetrPrUpBlock`` (conv_block, res_block): a deconv, then
    ``num_layer`` stages of (deconv, res block). JAX: ``_PrUpBlock``."""

    def __init__(self, in_channels: int, out_channels: int, num_layer: int):
        super().__init__()
        self.transp_conv_init = ConvLayer(in_channels, out_channels, 2, 2,
                                          transposed=True)
        self.blocks = nn.ModuleList([
            nn.Sequential(ConvLayer(out_channels, out_channels, 2, 2,
                                    transposed=True),
                          UnetResBlock(out_channels, out_channels))
            for _ in range(num_layer)])

    def forward(self, x):
        x = self.transp_conv_init(x)
        for block in self.blocks:
            x = block(x)
        return x


class UnetrUpBlock(nn.Module):
    """MONAI ``UnetrUpBlock``: deconv x2, concat the skip, res block. JAX:
    ``_UpBlock``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.transp_conv = ConvLayer(in_channels, out_channels, 2, 2,
                                     transposed=True)
        self.conv_block = UnetResBlock(2 * out_channels, out_channels)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class UnetOutBlock(nn.Module):
    """MONAI ``UnetOutBlock``: the biased 1x1x1 head."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = ConvLayer(in_channels, out_channels, 1, bias=True)

    def forward(self, x):
        return self.conv(x)


class MLPBlock(nn.Module):
    """MONAI ``MLPBlock``: linear1, exact GELU, linear2."""

    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.linear1 = nn.Linear(hidden, mlp_dim)
        self.linear2 = nn.Linear(mlp_dim, hidden)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SABlock(nn.Module):
    """MONAI ``SABlock``: a bias-free qkv Dense packed qkv-major
    (``(b, n, 3, heads, hd)``), softmax(q k^T * scale) in float32, then
    the biased ``out_proj``."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(hidden, 3 * hidden, bias=False)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q @ k.transpose(-2, -1) * hd ** -0.5).float(),
                             dim=-1)
        out = (attn.to(v.dtype) @ v).transpose(1, 2).reshape(b, n, c)
        return self.out_proj(out)


class TransformerBlock(nn.Module):
    """MONAI ``TransformerBlock``: x + attn(norm1(x)), then x +
    mlp(norm2(x))."""

    def __init__(self, hidden: int, mlp_dim: int, heads: int):
        super().__init__()
        self.mlp = MLPBlock(hidden, mlp_dim)
        self.norm1 = nn.LayerNorm(hidden)
        self.attn = SABlock(hidden, heads)
        self.norm2 = nn.LayerNorm(hidden)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbeddingBlock(nn.Module):
    """MONAI ``PatchEmbeddingBlock`` ('perceptron'): 16^3 patches flattened
    channel-last, ``(x y z c)``, in token order (d, h, w), into a biased
    Dense (``patch_embeddings.1``, after MONAI's Rearrange at ``.0``), plus
    the learned ``position_embeddings``."""

    def __init__(self, in_channels: int, grid: Tuple[int, int, int],
                 hidden: int):
        super().__init__()
        self.grid = grid
        self.patch_embeddings = nn.Sequential(
            nn.Identity(), nn.Linear(PATCH ** 3 * in_channels, hidden))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, grid[0] * grid[1] * grid[2], hidden))
        nn.init.trunc_normal_(self.position_embeddings, std=0.02)

    def forward(self, x):
        b, c = x.shape[:2]
        gd, gh, gw = self.grid
        p = PATCH
        x = x.reshape(b, c, gd, p, gh, p, gw, p)
        x = x.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(b, gd * gh * gw, -1)
        return self.patch_embeddings(x) + self.position_embeddings


class ViT(nn.Module):
    """MONAI ``ViT``: the embedding, the blocks, the closing ``norm``.
    Returns the normed tokens and every block's output."""

    def __init__(self, in_channels: int, grid: Tuple[int, int, int],
                 hidden: int, mlp_dim: int, num_layers: int, heads: int):
        super().__init__()
        self.patch_embedding = PatchEmbeddingBlock(in_channels, grid, hidden)
        self.blocks = nn.ModuleList([
            TransformerBlock(hidden, mlp_dim, heads)
            for _ in range(num_layers)])
        self.norm = nn.LayerNorm(hidden)

    def forward(self, x):
        x = self.patch_embedding(x)
        hidden_states = []
        for block in self.blocks:
            x = block(x)
            hidden_states.append(x)
        return self.norm(x), hidden_states


class UNETR(nn.Module):
    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 img_size: Sequence[int] = (96, 96, 96),
                 feature_size: int = 16, hidden_size: int = 768,
                 mlp_dim: int = 3072, num_heads: int = 12,
                 num_layers: int = 12):
        super().__init__()
        img_size = tuple(img_size)
        if len(img_size) != 3 or any(s % PATCH for s in img_size):
            raise ValueError(f"UNETR: img_size {img_size} must be three "
                             f"multiples of {PATCH}")
        if num_layers < 10:
            raise ValueError("UNETR taps the outputs of blocks 4, 7 and "
                             f"10: num_layers {num_layers} < 10")
        self.img_size = img_size
        self.grid = tuple(s // PATCH for s in img_size)
        self.hidden_size = hidden_size
        fs = feature_size
        self.vit = ViT(in_chns, self.grid, hidden_size, mlp_dim, num_layers,
                       num_heads)
        self.encoder1 = UnetrBasicBlock(in_chns, fs)
        self.encoder2 = UnetrPrUpBlock(hidden_size, 2 * fs, 2)
        self.encoder3 = UnetrPrUpBlock(hidden_size, 4 * fs, 1)
        self.encoder4 = UnetrPrUpBlock(hidden_size, 8 * fs, 0)
        self.decoder5 = UnetrUpBlock(hidden_size, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.out = UnetOutBlock(fs, num_classes)

    def _volume(self, tokens):
        """(B, N, hidden) -> (B, hidden, gd, gh, gw)."""
        b = tokens.shape[0]
        return tokens.reshape(b, *self.grid, self.hidden_size).permute(
            0, 4, 1, 2, 3).contiguous()

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if tuple(x.shape[2:]) != self.img_size:
            raise ValueError(f"UNETR built for {self.img_size} (its "
                             f"position table) got {tuple(x.shape[2:])}: "
                             "build the model with this img_size")
        final, hidden = self.vit(x)
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(self._volume(hidden[3]))
        enc3 = self.encoder3(self._volume(hidden[6]))
        enc4 = self.encoder4(self._volume(hidden[9]))
        dec = self.decoder5(self._volume(final), enc4)
        dec = self.decoder4(dec, enc3)
        dec = self.decoder3(dec, enc2)
        return self.out(self.decoder2(dec, enc1))
