"""SwinUNETR, NCDHW in and out (port of ``cvssl_tpu/models/swin_unetr.py``):
the reference's ``swinunetr`` (``net_factory_3d.py:38``: img 64^3, feature
size 48): a 3D Swin encoder (patch 2, depths (2, 2, 2, 2), heads (3, 6, 12,
24), window 7 clamped per stage, shifted windows, 3D relative-position
bias) feeding UNETR's residual conv decoder. 62,186,708 parameters at one
input channel and 2 classes.

Module names are MONAI's (``swinViT.patch_embed.proj``,
``swinViT.layers{s+1}.0.blocks.{j}.attn.qkv``, ``...downsample.
reduction``, ``encoder10.layer.conv1.conv``, ``decoder1.transp_conv.conv``,
``out.conv.conv``), so a MONAI ``state_dict`` loads through
``models/monai_checkpoint.py``, and ``models/convert.py`` maps the model
onto the Flax tree. MONAI's ``relative_position_index`` buffers are not in
the port's ``state_dict``: the index and the shift mask of each block are
built on the model's device by torch ops and cached outside it, as
``models/swin_unet.py::window_constants`` caches SwinUnet's.

As in JAX (and MONAI): inside the encoder the tokens are a (B, D, H, W, C)
map; a side no larger than the window takes a window of its own length
and no shift; after ``norm1`` each side is zero-padded up to a multiple of
its window (the padded tokens take part in attention, and the shift mask
is built on the padded map), and cropped back after the reverse roll. The
bias table is always sized for the configured 7^3 window, and a clamped
window of n tokens indexes it with the first n rows and columns of the
full window's index (a MONAI quirk, kept for checkpoint parity). Patch
merging concatenates the 2x2x2 neighbours in ``itertools.product`` order
(MONAI's fixed V2), then LayerNorm and a bias-free 8C -> 2C Dense. Every
tap, the patch embedding's output included, goes through a parameter-free
LayerNorm over the channels (``proj_out``).

The windows are fixed when the model is built, from ``img_size`` (each
side a multiple of 32); a forward at another size raises, where JAX
decides the windows at trace time. JAX's ``drop_path_rate`` is not ported
(the reference trains with none).
"""
from __future__ import annotations

import functools
import itertools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.models.unetr import (MLPBlock, UnetOutBlock,
                                          UnetrBasicBlock, UnetrUpBlock)

Dims = Tuple[int, int, int]


def window_partition_3d(x: torch.Tensor, ws: Dims) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * nW, wd * wh * ww, C)."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2],
                  c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        -1, ws[0] * ws[1] * ws[2], c)


def window_reverse_3d(windows: torch.Tensor, ws: Dims, d: int, h: int,
                      w: int) -> torch.Tensor:
    """(B * nW, wd * wh * ww, C) -> (B, D, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // (d * h * w // (ws[0] * ws[1] * ws[2]))
    x = windows.reshape(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1],
                        ws[2], c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)


def relative_position_index_3d(ws: Dims, device=None) -> torch.Tensor:
    """(n, n) int64 lookup into the (2wd-1)(2wh-1)(2ww-1) bias table of a
    ``ws`` window, n = wd * wh * ww (MONAI ``WindowAttention``)."""
    coords = torch.stack(torch.meshgrid(
        *(torch.arange(s, device=device) for s in ws),
        indexing="ij")).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    return ((rel[0] + ws[0] - 1) * (2 * ws[1] - 1) * (2 * ws[2] - 1)
            + (rel[1] + ws[1] - 1) * (2 * ws[2] - 1) + (rel[2] + ws[2] - 1))


def shifted_window_mask_3d(dims: Dims, ws: Dims, shift: Dims,
                           device=None) -> torch.Tensor:
    """(nW, n, n) float32 additive mask (0 / -100) of the shifted windows of
    a ``dims`` map (MONAI ``compute_mask``); an axis without shift is one
    region."""
    img_mask = torch.zeros(dims, device=device)

    def cuts(i):
        if not shift[i]:
            return (slice(None),)
        return (slice(0, -ws[i]), slice(-ws[i], -shift[i]),
                slice(-shift[i], None))
    for cnt, (sd, sh, sw) in enumerate(itertools.product(cuts(0), cuts(1),
                                                         cuts(2))):
        img_mask[sd, sh, sw] = cnt
    mw = window_partition_3d(img_mask[None, ..., None], ws).squeeze(-1)
    return torch.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0)


@functools.lru_cache(maxsize=64)
def window_constants(dims: Dims, ws: Dims, shift: Dims, full_ws: Dims,
                     device: torch.device
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The flat bias index of a ``ws`` window (the first n rows and columns
    of the ``full_ws`` window's index) and the shift mask of the padded
    ``dims`` map (None without a shift), built on ``device`` at the first
    call and cached."""
    n = ws[0] * ws[1] * ws[2]
    with torch.inference_mode(False), torch.no_grad():
        index = relative_position_index_3d(full_ws, device)[:n, :n]
        mask = (shifted_window_mask_3d(dims, ws, shift, device)
                if any(shift) else None)
    return index.reshape(-1), mask


class WindowAttention(nn.Module):
    """W-MSA with the 3D relative-position bias on a (B * nW, n, C) window
    batch; the bias table is sized for the configured window whatever the
    clamp. JAX: ``WindowAttention3D``."""

    def __init__(self, dim: int, num_heads: int, window_size: Dims):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        wd, wh, ww = window_size
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, index: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b_, n, c = x.shape
        heads = self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, heads, c // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        bias = torch.index_select(self.relative_position_bias_table, 0,
                                  index)
        attn = attn + bias.reshape(n, n, heads).permute(2, 0, 1)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b_ // nw, nw, heads, n, n)
                    + mask[None, :, None]).reshape(-1, heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b_, n, c))


class SwinTransformerBlock(nn.Module):
    """(Shifted-)window attention and the MLP, each on a LayerNorm'd
    residual branch, on a ``dims`` token map. JAX: ``SwinBlock3D``."""

    def __init__(self, dim: int, num_heads: int, dims: Dims,
                 window_size: int = 7, shifted: bool = False,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.dims = tuple(dims)
        self.full_ws = (window_size,) * 3
        self.ws = tuple(min(window_size, s) for s in self.dims)
        self.shift = tuple(w // 2 if shifted and s > w else 0
                           for w, s in zip(self.ws, self.dims))
        self.pads = tuple(-s % w for s, w in zip(self.dims, self.ws))
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, self.full_ws)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, h, w = x.shape[1:4]
        if (d, h, w) != self.dims:
            raise ValueError(f"SwinTransformerBlock built for a {self.dims} "
                             f"token map got {(d, h, w)}: build the model "
                             "with this img_size")
        pd, ph, pw = (s + p for s, p in zip(self.dims, self.pads))
        index, mask = window_constants((pd, ph, pw), self.ws, self.shift,
                                       self.full_ws, x.device)
        shortcut = x
        x = self.norm1(x)
        x = F.pad(x, (0, 0, 0, self.pads[2], 0, self.pads[1], 0,
                      self.pads[0]))
        if any(self.shift):
            x = torch.roll(x, tuple(-s for s in self.shift), dims=(1, 2, 3))
        x = window_reverse_3d(
            self.attn(window_partition_3d(x, self.ws), index, mask),
            self.ws, pd, ph, pw)
        if any(self.shift):
            x = torch.roll(x, self.shift, dims=(1, 2, 3))
        x = x[:, :d, :h, :w]
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """The 2x2x2 neighbours concatenated in ``itertools.product`` order
    (MONAI's ``PatchMergingV2``), LayerNorm, a bias-free 8C -> 2C Dense.
    JAX: ``PatchMerging3D``."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(8 * dim)

    def forward(self, x):
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in
                       itertools.product(range(2), repeat=3)], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """One stage: its blocks (every second one shifted), then the patch
    merging."""

    def __init__(self, dim: int, depth: int, num_heads: int, dims: Dims,
                 window_size: int):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, dims, window_size,
                                 shifted=j % 2 == 1)
            for j in range(depth)])
        self.downsample = PatchMerging(dim)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return self.downsample(x)


def proj_out(x: torch.Tensor) -> torch.Tensor:
    """MONAI ``SwinTransformer.proj_out(normalize=True)`` of a channel-last
    map: a parameter-free LayerNorm over the channels (eps 1e-5), returned
    NCDHW-contiguous."""
    x = F.layer_norm(x, x.shape[-1:])
    return x.permute(0, 4, 1, 2, 3).contiguous()


class SwinTransformer(nn.Module):
    """The encoder: ``patch_embed.proj`` (conv k2 s2), the stages as
    ``layers1`` ... ``layers4`` (each a one-element list, as MONAI's);
    returns the five taps through :func:`proj_out`."""

    def __init__(self, in_chns: int, embed_dim: int, img_size: Dims,
                 depths: Sequence[int], num_heads: Sequence[int],
                 window_size: int):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv3d(in_chns, embed_dim, 2, stride=2)
        self.num_layers = len(depths)
        for i, depth in enumerate(depths):
            dims = tuple(s // 2 ** (i + 1) for s in img_size)
            setattr(self, f"layers{i + 1}", nn.ModuleList([BasicLayer(
                embed_dim * 2 ** i, depth, num_heads[i], dims,
                window_size)]))

    def forward(self, x):
        h = self.patch_embed.proj(x).permute(0, 2, 3, 4, 1)
        taps = [proj_out(h)]
        for i in range(self.num_layers):
            h = getattr(self, f"layers{i + 1}")[0](h)
            taps.append(proj_out(h))
        return taps


class SwinUNETR(nn.Module):
    def __init__(self, in_chns: int = 1, num_classes: int = 2,
                 img_size: Sequence[int] = (64, 64, 64),
                 feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7):
        super().__init__()
        img_size = tuple(img_size)
        down = 2 ** (len(depths) + 1)
        if len(img_size) != 3 or any(s % down for s in img_size):
            raise ValueError(f"SwinUNETR: img_size {img_size} must be three "
                             f"multiples of {down}")
        self.img_size = img_size
        fs = feature_size
        self.swinViT = SwinTransformer(in_chns, fs, img_size, depths,
                                       num_heads, window_size)
        self.encoder1 = UnetrBasicBlock(in_chns, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = UnetOutBlock(fs, num_classes)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if tuple(x.shape[2:]) != self.img_size:
            raise ValueError(f"SwinUNETR built for {self.img_size} (its "
                             f"windows) got {tuple(x.shape[2:])}: build the "
                             "model with this img_size")
        hidden = self.swinViT(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(hidden[0])
        enc2 = self.encoder3(hidden[1])
        enc3 = self.encoder4(hidden[2])
        dec = self.decoder5(self.encoder10(hidden[4]), hidden[3])
        dec = self.decoder4(dec, enc3)
        dec = self.decoder3(dec, enc2)
        dec = self.decoder2(dec, enc1)
        return self.out(self.decoder1(dec, enc0))
