"""SwinUnet, NCHW in and out (port of ``cvssl_tpu/models/swin_unet.py`` on
its default ``"windows"`` layout).

The reference is ``SwinTransformerSys`` (Swin-tiny encoder: embed 96,
depths (2, 2, 2, 2), heads (3, 6, 12, 24), window 7, patch 4) behind the
``ViT_seg`` wrapper's 1 -> 3 channel repeat. Module names are the
reference's (``patch_embed.proj``, ``layers.{i}.blocks.{d}.attn.qkv``,
``layers_up.{j}``, ``concat_back_dim.{j}``, ``norm_up``, ``up``,
``output``), so a reference ``state_dict`` loads as it is and
``models/convert.py`` maps this model onto the Flax tree.

Inside the model the tokens stay a (B, H, W, C) map, as in JAX; windows are
reshapes, the cyclic shift is ``torch.roll``. The relative-position index and
the shifted-window mask are built once per token-map shape on the model's
device (torch ops, no host copy) and cached outside ``state_dict``.

As in the reference (``SwinTransformerBlock``), a stage whose map is no
larger than the window attends over the whole map with no shift; the port
decides this when it is built, from ``img_size`` (JAX decides it at trace
time), because the bias table's size follows the window.

Numerics: attention scores get the bias and mask added in float32 and the
softmax runs in float32, then the probabilities go back to the compute
dtype for the PV product, as in JAX. Under bfloat16 autocast two modules
run in float32 on float32 inputs, because JAX builds them without a dtype
and Flax promotes them to float32: ``concat_back_dim.{j}`` and
``layers_up.0``. The logits come out in the compute dtype, NCHW-contiguous
(the output head is applied to the tokens and the small class map is
transposed), which the fused CE+Dice kernel needs.

Not ported (the constructor raises): the ``"grid"`` and ``"fused"``
attention layouts (JAX layout oracles), ``s2d_logits`` (a TPU lane
reformulation with the same values), ``use_checkpoint``, ``ape``,
``patch_norm=False`` and non-zero ``drop_rate``/``attn_drop_rate`` (the
reference trains with neither). ``logits_f32`` is inert.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvssl_tpu_torch.models import unet


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int
                   ) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def relative_position_index(ws: int, device=None) -> torch.Tensor:
    """(ws*ws, ws*ws) int64 lookup into the (2ws-1)^2 bias table
    (reference ``swin_...sys.py:90-104``)."""
    r = torch.arange(ws, device=device)
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    return (rel[0] + ws - 1) * (2 * ws - 1) + (rel[1] + ws - 1)


def shifted_window_mask(h: int, w: int, ws: int, shift: int,
                        device=None) -> torch.Tensor:
    """(nW, ws*ws, ws*ws) float32 additive mask (0 / -100) of the shifted
    windows (reference ``:217-240``)."""
    img_mask = torch.zeros((h, w), device=device)
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in cuts:
        for wsl in cuts:
            img_mask[hs, wsl] = cnt
            cnt += 1
    mw = img_mask.reshape(h // ws, ws, w // ws, ws).permute(0, 2, 1, 3)
    mw = mw.reshape(-1, ws * ws)
    return torch.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0)


@functools.lru_cache(maxsize=64)
def window_constants(h: int, w: int, ws: int, shift: int,
                     device: torch.device
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The flat relative-position index and the shift mask (None without a
    shift) of a block on an (h, w) token map, built on ``device`` at the
    first call and cached."""
    with torch.inference_mode(False), torch.no_grad():
        index = relative_position_index(ws, device).reshape(-1)
        mask = (shifted_window_mask(h, w, ws, shift, device)
                if shift > 0 else None)
    return index, mask


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator],
              training: bool) -> torch.Tensor:
    """Per-sample stochastic depth (timm: survivors scaled by 1/keep); the
    keep mask is drawn through ``unet._keep`` from ``generator``. JAX:
    ``DropPath``."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = unet._keep((x.shape[0],) + (1,) * (x.ndim - 1), keep, generator,
                      x.device)
    return torch.where(mask, x / keep, 0.0)


class DropPath(nn.Module):
    """:func:`drop_path` as a module: active in train mode, the keep mask
    from the ``generator`` passed to ``forward``. JAX: ``DropPath``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return drop_path(x, self.rate, generator, self.training)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def _in_float32(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module`` on float32 ``x`` with autocast off: JAX builds
    ``concat_back_dim_{j}`` and ``up_0`` without a dtype, so Flax computes
    them in float32 even when the model computes in bfloat16."""
    with torch.autocast(x.device.type, enabled=False):
        return module(x.float())


class Mlp(nn.Module):
    """fc1, exact GELU, fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class WindowAttention(nn.Module):
    """W-MSA with the relative-position bias, on a (B*nW, ws*ws, C) window
    batch (reference ``:63-155``; JAX ``WindowAttention``, classic
    branch)."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, index: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b_, n, c = x.shape
        heads = self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, heads, c // heads)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * self.scale, qkv[1], qkv[2]
        attn = (q @ k.transpose(-2, -1)).float()
        bias = torch.index_select(self.relative_position_bias_table, 0,
                                  index)
        attn = attn + bias.float().reshape(n, n, heads).permute(2, 0, 1)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, heads, n, n) + mask[None, :,
                                                                  None]
            attn = attn.reshape(-1, heads, n, n)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    """(Shifted-)window attention and MLP, each on a LayerNorm'd residual
    branch with stochastic depth (reference ``SwinTransformerBlock``,
    ``:169-289``). A map no larger than the window collapses it to
    min(h, w) with no shift; the bias table is built for the window of the
    ``input_resolution`` map, and a forward on a map of another window
    raises."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path: float = 0.0):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.window_size, self.shift_size = window_size, shift_size
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, min(window_size,
                                             *input_resolution),
                                    num_heads, qkv_bias, qk_scale)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, w, c = x.shape
        # the window and shift of this map, as JAX finds them at trace time
        ws, shift = self.window_size, self.shift_size
        if min(h, w) <= ws:
            ws, shift = min(h, w), 0
        if ws != self.attn.window_size:
            raise ValueError(
                f"SwinBlock built for a {self.input_resolution} token map "
                f"(window {self.attn.window_size}) got {(h, w)}, whose "
                f"window is {ws}: build the model with this img_size")
        index, mask = window_constants(h, w, ws, shift, x.device)
        shortcut = x
        x = self.norm1(x)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        x = window_reverse(self.attn(window_partition(x, ws), index, mask),
                           ws, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + drop_path(x, self.drop_path, generator, self.training)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path,
                             generator, self.training)


class PatchMerging(nn.Module):
    """2x2 space-to-depth in the reference's x0, x1, x2, x3 order, then LN
    and a 4C -> 2C linear (reference ``:309-355``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchExpand(nn.Module):
    """C -> 2C linear, 2x2 depth-to-space, LN on C/2 (reference
    ``:358-382``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim // 2)

    def forward(self, x):
        b, h, w, c = x.shape
        x = self.expand(x).reshape(b, h, w, 2, 2, c // 2)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c // 2)
        return self.norm(x)


class FinalPatchExpandX4(nn.Module):
    """C -> 16C linear, 4x4 depth-to-space, LN on C (reference
    ``:385-410``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = nn.Linear(dim, 16 * dim, bias=False)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        b, h, w, c = x.shape
        x = self.expand(x).reshape(b, h, w, 4, 4, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, 4 * h, 4 * w, c)
        return self.norm(x)


class PatchEmbed(nn.Module):
    """4x4 stride-4 conv and its LN; NCHW in, (B, H/4, W/4, C) out."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x):
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class BasicLayer(nn.Module):
    """An encoder stage: its blocks, then ``downsample`` (None last)."""

    def __init__(self, blocks, downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample

    def forward(self, x, generator=None):
        for blk in self.blocks:
            x = blk(x, generator)
        return x if self.downsample is None else self.downsample(x)


class BasicLayerUp(nn.Module):
    """A decoder stage: its blocks, then ``upsample`` (None last)."""

    def __init__(self, blocks, upsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.upsample = upsample

    def forward(self, x, generator=None):
        for blk in self.blocks:
            x = blk(x, generator)
        return x if self.upsample is None else self.upsample(x)


class SwinUnet(nn.Module):
    """The full SwinUnet (``SwinTransformerSys`` and the 1 -> 3 channel
    repeat of ``vision_transformer.py:49-50``). ``img_size`` (an int or
    (h, w)) fixes each stage's token map, hence its window. The decoder's
    depths mirror the encoder's (the reference's ``depths_decoder`` is
    dead). ``forward(x, generator)``: x (B, 1 or 3, H, W) -> logits
    (B, num_classes, H, W); ``generator`` draws the stochastic depth in
    train mode."""

    def __init__(self, num_classes: int = 4, img_size=224,
                 patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, ape: bool = False,
                 patch_norm: bool = True, use_checkpoint: bool = False,
                 logits_f32: bool = True, s2d_logits: bool = False,
                 attn_layout: str = "windows"):
        super().__init__()
        unported = {"attn_layout": attn_layout != "windows",
                    "s2d_logits": s2d_logits,
                    "use_checkpoint": use_checkpoint, "ape": ape,
                    "patch_norm": not patch_norm,
                    "drop_rate": drop_rate != 0.0,
                    "attn_drop_rate": attn_drop_rate != 0.0}
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(
                f"SwinUnet: {', '.join(asked)} not ported (the port runs "
                "the windows layout, no remat, no absolute position "
                "embedding, no dropout)")
        del logits_f32   # inert: logits come out in the compute dtype
        num_layers = len(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        if isinstance(img_size, int):
            img_size = (img_size, img_size)
        h0, w0 = (s // patch_size for s in img_size)

        def stage_blocks(i):
            dim = embed_dim * 2 ** i
            res = (h0 // 2 ** i, w0 // 2 ** i)
            return [SwinBlock(dim, res, num_heads[i], window_size,
                              0 if d % 2 == 0 else window_size // 2,
                              mlp_ratio, qkv_bias, qk_scale,
                              dpr[sum(depths[:i]) + d])
                    for d in range(depths[i])]

        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.layers = nn.ModuleList(
            BasicLayer(stage_blocks(i),
                       PatchMerging(embed_dim * 2 ** i)
                       if i < num_layers - 1 else None)
            for i in range(num_layers))
        self.norm = nn.LayerNorm(embed_dim * 2 ** (num_layers - 1))
        up, cat = [], [nn.Identity()]
        for j in range(num_layers):
            stage = num_layers - 1 - j
            dim = embed_dim * 2 ** stage
            if j == 0:
                up.append(PatchExpand(dim))
                continue
            cat.append(nn.Linear(2 * dim, dim))
            up.append(BasicLayerUp(stage_blocks(stage),
                                   PatchExpand(dim)
                                   if j < num_layers - 1 else None))
        self.layers_up = nn.ModuleList(up)
        self.concat_back_dim = nn.ModuleList(cat)
        self.norm_up = nn.LayerNorm(embed_dim)
        self.up = FinalPatchExpandX4(embed_dim)
        self.output = nn.Conv2d(embed_dim, num_classes, 1, bias=False)
        for m in self.modules():          # reference ``_init_weights``
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        x = self.patch_embed(x)
        skips = []
        for layer in self.layers:
            skips.append(x)
            x = layer(x, generator)
        x = self.norm(x)
        last = len(self.layers) - 1
        for j, layer_up in enumerate(self.layers_up):
            if j == 0:
                x = _in_float32(layer_up, x)
                continue
            # the skip is the INPUT of encoder stage ``last - j``
            x = _in_float32(self.concat_back_dim[j],
                            torch.cat([x, skips[last - j]], dim=-1))
            x = layer_up(x, generator)
        x = self.up(self.norm_up(x))
        # the 1x1 head on the tokens, then the small class map to NCHW
        out = F.linear(x, self.output.weight.flatten(1))
        return out.permute(0, 3, 1, 2).contiguous()
