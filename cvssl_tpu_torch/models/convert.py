"""Flax weights <-> the port's ``state_dict``, for the UNet family, the
discriminators, SwinUnet, the contrastive heads, the 3D nets, the GAN
scaffolding and ``SCSEModule``.

Takes the numpy trees (``params``, ``batch_stats``) of a ``cvssl_tpu``
UNet-family model on its plain path, of its ``FCDiscriminator`` or of its
``SwinUnet``, and returns torch tensors under the port's names, and back.
For the plain UNet this is the inverse of
``cvssl_tpu/models/torch_convert.py::convert_unet_checkpoint`` (the
original torch names). The original torch tree names none of the
variants, so their names are SSL4MIS's:
``encoder``, ``main_decoder``, ``aux_decoder1..3`` (``unet_cct``);
``decoder.up1..4``, ``decoder.out_conv``, ``decoder.out_conv_dp1..3``
(``unet_ds``, ``unet_urpc``, ``unet_feature``).

Flax names compact submodules by type in call order: ``UNetCCT``'s
``Decoder_0..3`` are main, aux1, aux2, aux3; ``_MultiScaleDecoder_0``'s
``Conv_0..3`` are the dp3, dp2, dp1 and dp0 heads; ``UNetFeature`` has its
four ``UpBlock``s and its ``Conv_0`` at the top level.

The discriminator keeps the original torch names (``conv0``..``conv4``,
``classifier``); Flax's ``Conv_0``/``Conv_1`` take the softmax map and the
image, and its ``Dense_0`` the NHWC flatten, (h, w, c) order, where the
torch classifier takes the NCHW flatten: its rows are reordered, the pooled
map taken square as in ``cvssl_tpu/models/torch_convert.py::
convert_discriminator2d_checkpoint``.

SwinUnet keeps the names of the reference's ``SwinTransformerSys``, the
keys that ``cvssl_tpu/models/swin_checkpoint.py::convert_swinunet_full``
reads: Flax's ``enc_{i}_{d}`` is ``layers.{i}.blocks.{d}``, ``dec_{j}_{d}``
is ``layers_up.{j}.blocks.{d}``, ``up_0`` is ``layers_up.0``, ``up_{j}`` is
``layers_up.{j}.upsample``, ``final_up`` is ``up``, ``patch_norm`` is
``patch_embed.norm``, and each ``Mlp``'s ``Dense_0``/``Dense_1`` are
``mlp.fc1``/``mlp.fc2``. Its stage depths are read off the tree converted.

The contrastive heads keep the reference's names: ``conv_{i}.conv`` and
``conv_{i}.bn`` are Flax's ``_ConvBNRelu_{i-1}``'s ``Conv_0`` and
``BatchNorm_0``, the classifier's ``final`` its ``Conv_0``.

The 3D nets keep the original torch names, as ``cvssl_tpu/models/
torch_convert.py::convert_unet3d_checkpoint`` reads them: Flax's
``UnetConv3_0..4`` are ``conv1``..``conv4`` and ``center`` (their
``Conv_0``/``Conv_1`` are ``conv1.0``/``conv2.0``), ``UnetUp3CT_0..3`` are
``up_concat4``..``up_concat1`` (``.conv``), the top-level ``Conv_0`` is
``final`` (``unet_3D``) or ``dsv1`` (``unet_3D_dv_semi``, whose
``UnetDsv3_0..2`` are ``dsv4``..``dsv2``, ``.dsv.0``). The 3D
discriminator (``discriminator_3d`` here; ``discriminator`` in the 3D
registry) is the 2D one's names with a plain Dense: its classifier takes
the global mean's channel vector.

The 3D zoo (``vnet``, ``voxresnet``, ``attention_unet``, ``nnUNet`` in 2D
or 3D) keeps the reference torch code's names; each leaf function below
names its Flax counterparts. nnUNet's layout (pools, convs a stage, deep
supervision) is read off the tree converted (:func:`nnunet_layout`); VNet
converts with BatchNorm, its factory default.

The 3D ViTs (``unetr``, ``swinunetr``) keep MONAI's names, the keys
``cvssl_tpu/models/monai_checkpoint.py`` reads, and this is the inverse of
its two converters (:func:`_unetr`, :func:`_swin_unetr` name the Flax
counterparts); UNETR's block count and SwinUNETR's depths are read off the
tree converted (:func:`vit3d_layout`). UNETR's ``position_embeddings`` is
copied as it is.

The GAN scaffolding (``models/gan.py``) keeps the reference's
``nn.Sequential`` indices, and ``SCSEModule`` smp's names; each leaf
function below names the Flax counterparts. Their layouts are read off the
tree converted (:func:`gan_layout`), but for a ``ResnetGenerator``'s
padding and dropout, which move its indices and which a Flax tree does not
show: from Flax, pass its layout to :func:`state_dict_from_flax`.

Conv kernels go from (kh, kw, in, out) to (out, in, kh, kw), or (kd, kh,
kw, in, out) to (out, in, kd, kh, kw); a transpose conv's from (*k, in,
out) to (in, out, *k) flipped on every spatial axis, since Flax's
``nn.ConvTranspose`` correlates the dilated input with the kernel as it is
and torch's is the gradient of a conv (as
``cvssl_tpu/models/monai_checkpoint.py`` converts them); Dense kernels from
(in, out) to (out, in); LayerNorm's and the affine InstanceNorm's
``scale`` is ``weight``.
"""
from __future__ import annotations

import re
from typing import (Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

# (port key, flax collection, flax path, kind); kind "kernel" transposes a
# conv kernel, "dense" a Dense kernel, "count" is BatchNorm's
# num_batches_tracked, which flax does not keep, "dense:<port key>" is a
# Dense kernel over an NHWC flatten whose channel count is the length of
# that port tensor
Leaf = Tuple[str, str, Tuple[str, ...], str]


def _conv(port: str, path: Tuple[str, ...], bias: bool = True,
          kind: str = "kernel") -> List[Leaf]:
    out = [(f"{port}.weight", "params", path + ("kernel",), kind)]
    if bias:
        out.append((f"{port}.bias", "params", path + ("bias",), "plain"))
    return out


def _batch_norm(bn: str, p: Tuple[str, ...]) -> List[Leaf]:
    return [(f"{bn}.weight", "params", p + ("scale",), "plain"),
            (f"{bn}.bias", "params", p + ("bias",), "plain"),
            (f"{bn}.running_mean", "batch_stats", p + ("mean",), "plain"),
            (f"{bn}.running_var", "batch_stats", p + ("var",), "plain"),
            (f"{bn}.num_batches_tracked", "", (), "count")]


def _convblock(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    out = []
    for i, (conv_i, bn_i) in enumerate(((0, 1), (4, 5))):
        out += _conv(f"{port}.{conv_i}", path + (f"Conv_{i}",))
        out += _batch_norm(f"{port}.{bn_i}", path + (f"BatchNorm_{i}",))
    return out


def _encoder(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    out = _convblock(f"{port}.in_conv.conv_conv", path + ("ConvBlock_0",))
    for k in range(1, 5):
        out += _convblock(f"{port}.down{k}.maxpool_conv.1.conv_conv",
                          path + (f"DownBlock_{k - 1}", "ConvBlock_0"))
    return out


def _ups(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    out = []
    for k in range(1, 5):
        up = path + (f"UpBlock_{k - 1}",)
        out += _convblock(f"{port}.up{k}.conv.conv_conv",
                          up + ("ConvBlock_0",))
        out += _conv(f"{port}.up{k}.conv1x1", up + ("Conv_0",))
    return out


def _decoder(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    return _ups(port, path) + _conv(f"{port}.out_conv", path + ("Conv_0",))


def _multiscale_decoder(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    heads = ("out_conv_dp3", "out_conv_dp2", "out_conv_dp1", "out_conv")
    out = _ups(port, path)
    for i, head in enumerate(heads):
        out += _conv(f"{port}.{head}", path + (f"Conv_{i}",))
    return out


def _discriminator() -> List[Leaf]:
    out = [leaf for i in range(5) for leaf in _conv(f"conv{i}",
                                                    (f"Conv_{i}",))]
    return out + [("classifier.weight", "params", ("Dense_0", "kernel"),
                   "dense:conv4.bias"),
                  ("classifier.bias", "params", ("Dense_0", "bias"),
                   "plain")]


def _discriminator_3d() -> List[Leaf]:
    out = [leaf for i in range(5) for leaf in _conv(f"conv{i}",
                                                    (f"Conv_{i}",))]
    return out + _dense("classifier", ("Dense_0",))


def _unet_conv3(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    return (_conv(f"{port}.conv1.0", path + ("Conv_0",))
            + _conv(f"{port}.conv2.0", path + ("Conv_1",)))


def _unet_3d(deep_sup: bool) -> List[Leaf]:
    out = []
    for i, name in enumerate(("conv1", "conv2", "conv3", "conv4", "center")):
        out += _unet_conv3(name, (f"UnetConv3_{i}",))
    for i, k in enumerate((4, 3, 2, 1)):
        out += _unet_conv3(f"up_concat{k}.conv",
                           (f"UnetUp3CT_{i}", "UnetConv3_0"))
    if not deep_sup:
        return out + _conv("final", ("Conv_0",))
    for i, k in enumerate((4, 3, 2)):
        out += _conv(f"dsv{k}.dsv.0", (f"UnetDsv3_{i}", "Conv_0"))
    return out + _conv("dsv1", ("Conv_0",))


def _vnet() -> List[Leaf]:
    """VNet with BatchNorm: ``ConvStage_0..8`` are ``block_one`` ...
    ``block_nine`` (conv ``i`` at ``conv.{3i}``, its norm at ``{3i + 1}``),
    ``DownConv_0..3`` the ``_dw`` blocks, ``UpDeconv_0..3`` the ``_up``
    blocks (a transpose conv), ``Conv_0`` ``out_conv``."""
    names = ("one", "two", "three", "four", "five", "six", "seven", "eight",
             "nine")
    convs = (1, 2, 3, 3, 3, 3, 3, 2, 1)
    out = []

    def stage(port, path, i, conv_name, kind="kernel"):
        return (_conv(f"{port}.conv.{3 * i}", path + (conv_name,),
                      kind=kind)
                + _batch_norm(f"{port}.conv.{3 * i + 1}",
                              path + (f"_Norm_{i}", "BatchNorm_0")))
    for k, (name, n) in enumerate(zip(names, convs)):
        for i in range(n):
            out += stage(f"block_{name}", (f"ConvStage_{k}",), i,
                         f"Conv_{i}")
    for k in range(4):
        out += stage(f"block_{names[k]}_dw", (f"DownConv_{k}",), 0,
                     "Conv_0")
        out += stage(f"block_{names[k + 4]}_up", (f"UpDeconv_{k}",), 0,
                     "ConvTranspose_0", "tkernel")
    return out + _conv("out_conv", ("Conv_0",))


def _voxresnet() -> List[Leaf]:
    """VoxResNet: ``Conv_0`` is ``conv1``, ``VoxRex_0..5`` ``res1..6``
    (``block.2``/``block.5``, no bias), ``_UpBlock_0..1`` ``up1``/``up2``
    (``conv.conv_conv.2``/``.5``), ``Conv_1`` ``out``."""
    def pre_act(port, path):
        return (_conv(f"{port}.2", path + ("Conv_0",), bias=False)
                + _conv(f"{port}.5", path + ("Conv_1",), bias=False))
    out = _conv("conv1", ("Conv_0",))
    for k in range(6):
        out += pre_act(f"res{k + 1}.block", (f"VoxRex_{k}",))
    for j in range(2):
        out += pre_act(f"up{j + 1}.conv.conv_conv",
                       (f"_UpBlock_{j}", "_PreActConvBlock_0"))
    return out + _conv("out", ("Conv_1",))


def _attention_unet() -> List[Leaf]:
    """AttentionUNet3D: UNet3D's level names, ``Conv_0`` the gating conv
    (``gating.conv1.0``), ``MultiAttentionBlock_0..2`` ``attentionblock4``
    .. ``2`` (``GridAttentionBlock3D_0/1`` are ``gate_block_1/2``, whose
    ``W``/``W_bn`` are ``W.0``/``W.1``; ``Conv_0``/``BatchNorm_0`` are
    ``combine_gates.0``/``.1``), ``Conv_1`` ``dsv1``, ``Conv_2``
    ``final``."""
    out = []
    for i, name in enumerate(("conv1", "conv2", "conv3", "conv4", "center")):
        out += _unet_conv3(name, (f"UnetConv3_{i}",))
    out += _conv("gating.conv1.0", ("Conv_0",))
    for i, k in enumerate((4, 3, 2)):
        block, path = f"attentionblock{k}", (f"MultiAttentionBlock_{i}",)
        for g in range(2):
            gate = f"{block}.gate_block_{g + 1}"
            gp = path + (f"GridAttentionBlock3D_{g}",)
            out += (_conv(f"{gate}.theta", gp + ("theta",), bias=False)
                    + _conv(f"{gate}.phi", gp + ("phi",))
                    + _conv(f"{gate}.psi", gp + ("psi",))
                    + _conv(f"{gate}.W.0", gp + ("W",))
                    + _batch_norm(f"{gate}.W.1", gp + ("W_bn",)))
        out += (_conv(f"{block}.combine_gates.0", path + ("Conv_0",))
                + _batch_norm(f"{block}.combine_gates.1",
                              path + ("BatchNorm_0",)))
    for i, k in enumerate((4, 3, 2, 1)):
        out += _unet_conv3(f"up_concat{k}.conv",
                           (f"UnetUp3CT_{i}", "UnetConv3_0"))
    for i, k in enumerate((4, 3, 2)):
        out += _conv(f"dsv{k}.dsv.0", (f"UnetDsv3_{i}", "Conv_0"))
    return out + _conv("dsv1", ("Conv_1",)) + _conv("final", ("Conv_2",))


def nnunet_layout(tree) -> Tuple[int, int, bool]:
    """(pools, convs a stage, deep supervision) of a Generic_UNet, read
    off its Flax ``params`` (``ConvTranspose_{u}``, ``StackedConvLayers_0``'s
    blocks, the ``Conv_{k}`` heads) or its ``state_dict``'s names
    (``tu.{u}``, ``conv_blocks_context.0.blocks.{i}``,
    ``seg_outputs.{u}``)."""
    if "StackedConvLayers_0" in tree:
        pools = sum(k.startswith("ConvTranspose_") for k in tree)
        convs = len(tree["StackedConvLayers_0"])
        heads = sum(k.startswith("Conv_") for k in tree)
    else:
        def count(pattern):
            return len({m.group(1) for m in (re.match(pattern, k)
                                             for k in tree) if m})
        pools = count(r"tu\.(\d+)\.")
        convs = count(r"conv_blocks_context\.0\.blocks\.(\d+)\.")
        heads = count(r"seg_outputs\.(\d+)\.")
    return pools, convs, heads > 1


def _nnunet(pools: int, convs: int, deep_supervision: bool) -> List[Leaf]:
    """Generic_UNet: ``StackedConvLayers_{d}`` are the encoder's
    ``conv_blocks_context.{d}``, the next two the bottleneck's
    ``conv_blocks_context.{pools}.0``/``.1``, then two a level up
    (``conv_blocks_localization.{u}.0``/``.1``); ``ConvTranspose_{u}`` is
    ``tu.{u}``; the heads ``Conv_{k}`` are ``seg_outputs``. A stacked
    layer holds at least one conv (JAX's always applies its first)."""
    def stacked(port, k, n):
        out = []
        for i in range(max(n, 1)):
            path = (f"StackedConvLayers_{k}", f"ConvNormNonlin_{i}")
            out += (_conv(f"{port}.blocks.{i}.conv", path + ("Conv_0",))
                    + _layer_norm(f"{port}.blocks.{i}.instnorm",
                                  path + ("InstanceNormAffine_0",)))
        return out
    out = []
    for d in range(pools):
        out += stacked(f"conv_blocks_context.{d}", d, convs)
    out += stacked(f"conv_blocks_context.{pools}.0", pools, convs - 1)
    out += stacked(f"conv_blocks_context.{pools}.1", pools + 1, 1)
    for u in range(pools):
        out += _conv(f"tu.{u}", (f"ConvTranspose_{u}",), bias=False,
                     kind="tkernel")
        k = pools + 2 + 2 * u
        out += stacked(f"conv_blocks_localization.{u}.0", k, convs - 1)
        out += stacked(f"conv_blocks_localization.{u}.1", k + 1, 1)
    heads = range(pools) if deep_supervision else (pools - 1,)
    for i, u in enumerate(heads):
        out += _conv(f"seg_outputs.{u}", (f"Conv_{i}",), bias=False)
    return out


def _head(blocks: int, final: bool) -> List[Leaf]:
    """A contrastive head: ``conv_{i}.conv``/``.bn`` are Flax's
    ``_ConvBNRelu_{i-1}``, the classifier's ``final`` its ``Conv_0``."""
    out = []
    for i in range(blocks):
        p = (f"_ConvBNRelu_{i}",)
        out += (_conv(f"conv_{i + 1}.conv", p + ("Conv_0",))
                + _batch_norm(f"conv_{i + 1}.bn", p + ("BatchNorm_0",)))
    return out + (_conv("final", ("Conv_0",)) if final else [])


def _dense(port: str, path: Tuple[str, ...], bias: bool = True
           ) -> List[Leaf]:
    out = [(f"{port}.weight", "params", path + ("kernel",), "dense")]
    if bias:
        out.append((f"{port}.bias", "params", path + ("bias",), "plain"))
    return out


def _layer_norm(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    return [(f"{port}.weight", "params", path + ("scale",), "plain"),
            (f"{port}.bias", "params", path + ("bias",), "plain")]


def _swin_block(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    table = ("attn", "relative_position_bias_table")
    return (_layer_norm(f"{port}.norm1", path + ("norm1",))
            + [(f"{port}.attn.relative_position_bias_table", "params",
                path + table, "plain")]
            + _dense(f"{port}.attn.qkv", path + ("attn", "qkv"))
            + _dense(f"{port}.attn.proj", path + ("attn", "proj"))
            + _layer_norm(f"{port}.norm2", path + ("norm2",))
            + _dense(f"{port}.mlp.fc1", path + ("mlp", "Dense_0"))
            + _dense(f"{port}.mlp.fc2", path + ("mlp", "Dense_1")))


def _swin_unet(depths: Sequence[int]) -> List[Leaf]:
    n = len(depths)
    out = (_conv("patch_embed.proj", ("patch_embed",))
           + _layer_norm("patch_embed.norm", ("patch_norm",)))
    for i in range(n):
        for d in range(depths[i]):
            out += _swin_block(f"layers.{i}.blocks.{d}", (f"enc_{i}_{d}",))
        if i < n - 1:
            down = f"layers.{i}.downsample"
            out += (_layer_norm(f"{down}.norm", (f"downsample_{i}", "norm"))
                    + _dense(f"{down}.reduction",
                             (f"downsample_{i}", "reduction"), bias=False))
    out += _layer_norm("norm", ("norm",))
    for j in range(n):
        if j == 0:
            out += (_dense("layers_up.0.expand", ("up_0", "expand"), False)
                    + _layer_norm("layers_up.0.norm", ("up_0", "norm")))
            continue
        out += _dense(f"concat_back_dim.{j}", (f"concat_back_dim_{j}",))
        for d in range(depths[n - 1 - j]):
            out += _swin_block(f"layers_up.{j}.blocks.{d}", (f"dec_{j}_{d}",))
        if j < n - 1:
            up = f"layers_up.{j}.upsample"
            out += (_dense(f"{up}.expand", (f"up_{j}", "expand"), False)
                    + _layer_norm(f"{up}.norm", (f"up_{j}", "norm")))
    return (out + _layer_norm("norm_up", ("norm_up",))
            + _dense("up.expand", ("final_up", "expand"), False)
            + _layer_norm("up.norm", ("final_up", "norm"))
            + [("output.weight", "params", ("output", "kernel"), "kernel")])


def swin_depths(names: Iterable[str]) -> Tuple[int, ...]:
    """A SwinUnet's encoder depths from the names of its Flax tree
    (``enc_{i}_{d}``) or of its ``state_dict`` (``layers.{i}.blocks.{d}``)."""
    depth: Dict[int, int] = {}
    for name in names:
        m = re.match(r"(?:enc_(\d+)_(\d+)$|layers\.(\d+)\.blocks\.(\d+)\.)",
                     name)
        if m:
            i, d = (int(g) for g in m.groups() if g is not None)
            depth[i] = max(depth.get(i, 0), d + 1)
    return tuple(depth[i] for i in range(len(depth)))


def _res_block(port: str, path: Tuple[str, ...], project: bool
               ) -> List[Leaf]:
    """MONAI ``UnetResBlock`` (``{port}.conv{k}.conv``): JAX's
    ``_ResConvBlock``, its ``conv3`` where it ``project``s."""
    return [leaf for k in ((1, 2, 3) if project else (1, 2))
            for leaf in _conv(f"{port}.conv{k}.conv", path + (f"conv{k}",),
                              bias=False)]


def _deconv(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    return _conv(f"{port}.conv", path + ("ConvTranspose_0",), bias=False,
                 kind="tkernel")


def _up_block(name: str) -> List[Leaf]:
    """MONAI ``UnetrUpBlock``: JAX's ``_UpBlock``."""
    return (_deconv(f"{name}.transp_conv", (name, "transp_conv"))
            + _res_block(f"{name}.conv_block", (name, "conv_block"), True))


def _vit_block(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    return (_layer_norm(f"{port}.norm1", path + ("norm1",))
            + _layer_norm(f"{port}.norm2", path + ("norm2",))
            + _dense(f"{port}.attn.qkv", path + ("attn", "qkv"), bias=False)
            + _dense(f"{port}.attn.out_proj", path + ("attn", "out_proj"))
            + _dense(f"{port}.mlp.linear1", path + ("linear1",))
            + _dense(f"{port}.mlp.linear2", path + ("linear2",)))


def _unetr(layers: int) -> List[Leaf]:
    """UNETR under MONAI's names: ``patch_embeddings`` is
    ``vit.patch_embedding.patch_embeddings.1``, ``blocks_{i}`` is
    ``vit.blocks.{i}`` (its ``linear1``/``linear2`` under ``mlp``), an
    encoder's ``blocks_{i}_deconv``/``blocks_{i}_res`` are
    ``blocks.{i}.0``/``.1``; ``encoder1``'s res block sits under
    ``layer``."""
    emb = "vit.patch_embedding"
    out = (_dense(f"{emb}.patch_embeddings.1", ("patch_embeddings",))
           + [(f"{emb}.position_embeddings", "params",
               ("position_embeddings",), "plain")])
    for i in range(layers):
        out += _vit_block(f"vit.blocks.{i}", (f"blocks_{i}",))
    out += _layer_norm("vit.norm", ("norm",))
    out += _res_block("encoder1.layer", ("encoder1",), True)
    for k, stages in ((2, 2), (3, 1), (4, 0)):
        enc = f"encoder{k}"
        out += _deconv(f"{enc}.transp_conv_init", (enc, "transp_conv_init"))
        for i in range(stages):
            out += (_deconv(f"{enc}.blocks.{i}.0", (enc, f"blocks_{i}_deconv"))
                    + _res_block(f"{enc}.blocks.{i}.1",
                                 (enc, f"blocks_{i}_res"), False))
    for k in (5, 4, 3, 2):
        out += _up_block(f"decoder{k}")
    return out + _conv("out.conv.conv", ("out",))


def _swin_unetr(depths: Sequence[int]) -> List[Leaf]:
    """SwinUNETR under MONAI's names: ``patch_embed`` is
    ``swinViT.patch_embed.proj``, ``stage{s}_block{j}`` is
    ``swinViT.layers{s+1}.0.blocks.{j}`` (its ``Mlp``'s ``Dense_0``/
    ``Dense_1`` are ``mlp.linear1``/``mlp.linear2``), ``merge{s}`` is
    ``swinViT.layers{s+1}.0.downsample``; the encoders' res blocks sit
    under ``layer``, ``encoder1``'s (from the input's channels) with a
    ``conv3``."""
    out = _conv("swinViT.patch_embed.proj", ("patch_embed",))
    for s, depth in enumerate(depths):
        layer = f"swinViT.layers{s + 1}.0"
        for j in range(depth):
            port, path = f"{layer}.blocks.{j}", (f"stage{s}_block{j}",)
            out += (_layer_norm(f"{port}.norm1", path + ("norm1",))
                    + [(f"{port}.attn.relative_position_bias_table",
                        "params",
                        path + ("attn", "relative_position_bias_table"),
                        "plain")]
                    + _dense(f"{port}.attn.qkv", path + ("attn", "qkv"))
                    + _dense(f"{port}.attn.proj", path + ("attn", "proj"))
                    + _layer_norm(f"{port}.norm2", path + ("norm2",))
                    + _dense(f"{port}.mlp.linear1", path + ("mlp", "Dense_0"))
                    + _dense(f"{port}.mlp.linear2",
                             path + ("mlp", "Dense_1")))
        out += (_layer_norm(f"{layer}.downsample.norm", (f"merge{s}", "norm"))
                + _dense(f"{layer}.downsample.reduction",
                         (f"merge{s}", "reduction"), bias=False))
    for k in (1, 2, 3, 4, 10):
        out += _res_block(f"encoder{k}.layer", (f"encoder{k}",), k == 1)
    for k in (5, 4, 3, 2, 1):
        out += _up_block(f"decoder{k}")
    return out + _conv("out.conv.conv", ("out",))


def vit3d_layout(tree) -> Tuple[int, ...]:
    """UNETR's block count (one element) or SwinUNETR's stage depths, read
    off a Flax ``params`` tree (``blocks_{i}``, ``stage{s}_block{j}``) or a
    ``state_dict``'s names (``vit.blocks.{i}.``,
    ``swinViT.layers{s+1}.0.blocks.{j}.``)."""
    depth: Dict[int, int] = {}
    for name in tree:
        m = re.match(r"(?:blocks_(\d+)$|vit\.blocks\.(\d+)\.)", name)
        if m:
            depth[0] = max(depth.get(0, 0), int(m.group(1) or m.group(2)) + 1)
            continue
        m = re.match(r"(?:stage(\d+)_block(\d+)$|swinViT\.layers(\d+)\.0"
                     r"\.blocks\.(\d+)\.)", name)
        if m:
            s, j = (int(g) for g in m.groups() if g is not None)
            s = s - 1 if m.group(3) else s
            depth[s] = max(depth.get(s, 0), j + 1)
    return tuple(depth[i] for i in range(len(depth)))


def _pnet() -> List[Leaf]:
    """PNet2D: ``PNetBlock_{k}`` is ``block{k+1}`` (its ``Conv_0``/
    ``BatchNorm_0``/``Conv_1``/``BatchNorm_1`` are ``conv1``/``bn1``/
    ``conv2``/``bn2``), the top-level ``Conv_0``/``Conv_1`` are
    ``catblock.conv1``/``.conv2``, ``Conv_2``/``Conv_3`` ``out.conv1``/
    ``.conv2``."""
    out = []
    for k in range(5):
        p = (f"PNetBlock_{k}",)
        for i in range(2):
            out += (_conv(f"block{k + 1}.conv{i + 1}", p + (f"Conv_{i}",))
                    + _batch_norm(f"block{k + 1}.bn{i + 1}",
                                  p + (f"BatchNorm_{i}",)))
    for i, port in enumerate(("catblock.conv1", "catblock.conv2",
                              "out.conv1", "out.conv2")):
        out += _conv(port, (f"Conv_{i}",))
    return out


def _prelu(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    return [(f"{port}.weight", "params", path + ("prelu_alpha",), "prelu")]


def _enet_blocks():
    """ENet's blocks in call order: (port name, kind, ReLU); kind "asym" is
    an asymmetric RegularBottleneck."""
    from cvssl_tpu_torch.models.enet import STAGE_NAMES
    yield "downsample1_0", "down", False
    for i in range(1, 5):
        yield f"regular1_{i}", "regular", False
    yield "downsample2_0", "down", False
    for stage in (2, 3):
        for i, kind in enumerate(STAGE_NAMES, 1):
            yield (f"{kind}{stage}_{i}",
                   "asym" if kind == "asymmetric" else "regular", False)
    yield "upsample4_0", "up", True
    yield "regular4_1", "regular", True
    yield "regular4_2", "regular", True
    yield "upsample5_0", "up", True
    yield "regular5_1", "regular", True


def _enet() -> List[Leaf]:
    """ENet under the reference's block names: Flax's
    ``InitialBlock_0``, ``DownsamplingBottleneck_{k}``,
    ``RegularBottleneck_{k}`` and ``UpsamplingBottleneck_{k}`` in call
    order; a block's ``Conv_{i}``/``BatchNorm_{i}``/``_Act_{i}`` are its
    ``ext_conv{i+1}`` Sequential (an asymmetric block's ``Conv_1``/
    ``Conv_2`` are ``ext_conv2.0``/``.3``), its last ``_Act`` is
    ``out_activation``; an upsampling block's ``Conv_0``/``BatchNorm_0`` are
    ``main_conv1``, ``ConvTranspose_0``/``BatchNorm_2`` ``ext_tconv1``/
    ``ext_tconv1_bnorm``; the top-level ``ConvTranspose_0`` is
    ``transposed_conv``. PReLU slopes (``_Act_{i}``'s scalar
    ``prelu_alpha``) exist only in the encoder; the decoder's ReLU holds
    none."""
    p = ("InitialBlock_0",)
    out = (_conv("initial_block.main_branch", p + ("Conv_0",), bias=False)
           + _batch_norm("initial_block.batch_norm", p + ("BatchNorm_0",))
           + _prelu("initial_block.out_activation", p + ("_Act_0",)))
    count: Dict[str, int] = {}
    for name, kind, relu in _enet_blocks():
        typ = {"down": "DownsamplingBottleneck",
               "up": "UpsamplingBottleneck"}.get(kind, "RegularBottleneck")
        p = (f"{typ}_{count.get(typ, 0)}",)
        count[typ] = count.get(typ, 0) + 1
        if kind == "up":
            parts = (("main_conv1.0", "main_conv1.1", "Conv_0"),
                     ("ext_conv1.0", "ext_conv1.1", "Conv_1"),
                     ("ext_tconv1", "ext_tconv1_bnorm", "ConvTranspose_0"),
                     ("ext_conv2.0", "ext_conv2.1", "Conv_2"))
            for i, (conv, bn, flax) in enumerate(parts):
                out += (_conv(f"{name}.{conv}", p + (flax,), bias=False,
                              kind="tkernel" if i == 2 else "kernel")
                        + _batch_norm(f"{name}.{bn}",
                                      p + (f"BatchNorm_{i}",)))
            continue
        # Sequential(conv, bn, act) at these offsets, one a Flax index
        seqs = [("ext_conv1", 0), ("ext_conv2", 0)] + (
            [("ext_conv2", 3)] if kind == "asym" else []) + [("ext_conv3", 0)]
        for i, (seq, o) in enumerate(seqs):
            out += (_conv(f"{name}.{seq}.{o}", p + (f"Conv_{i}",), bias=False)
                    + _batch_norm(f"{name}.{seq}.{o + 1}",
                                  p + (f"BatchNorm_{i}",)))
            if not relu:
                out += _prelu(f"{name}.{seq}.{o + 2}", p + (f"_Act_{i}",))
        if not relu:
            out += _prelu(f"{name}.out_activation",
                          p + (f"_Act_{len(seqs)}",))
    return out + _conv("transposed_conv", ("ConvTranspose_0",), bias=False,
                       kind="tkernel")


def _effi_encoder(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    """EfficientNet-B3 under lukemelas' names: ``Conv_0``/``BatchNorm_0``
    are ``_conv_stem``/``_bn0``, ``MBConv_{b}`` is ``_blocks.{b}`` (its
    convs in call order: ``_expand_conv`` where the stage expands,
    ``_depthwise_conv``, ``_se_reduce``, ``_se_expand``, ``_project_conv``;
    its norms ``_bn0`` (expanding), ``_bn1``, ``_bn2``)."""
    from cvssl_tpu_torch.models.efficientunet import (B0_STAGES,
                                                      round_repeats)
    out = (_conv(f"{port}._conv_stem", path + ("Conv_0",), bias=False)
           + _batch_norm(f"{port}._bn0", path + ("BatchNorm_0",)))
    b = 0
    for t, *_, r in B0_STAGES:
        for _ in range(round_repeats(r)):
            blk, p = f"{port}._blocks.{b}", path + (f"MBConv_{b}",)
            convs = (["_expand_conv"] if t != 1 else []) + [
                "_depthwise_conv", "_se_reduce", "_se_expand",
                "_project_conv"]
            norms = (["_bn0"] if t != 1 else []) + ["_bn1", "_bn2"]
            for i, c in enumerate(convs):
                out += _conv(f"{blk}.{c}", p + (f"Conv_{i}",),
                             bias=c.startswith("_se"))
            for i, n in enumerate(norms):
                out += _batch_norm(f"{blk}.{n}", p + (f"BatchNorm_{i}",))
            b += 1
    return out


def _effiunet() -> List[Leaf]:
    """EffiUNet: ``EfficientNetEncoder_0`` is ``encoder``
    (:func:`_effi_encoder`), ``DecoderBlock_{i}``'s ``Conv_{j}``/
    ``BatchNorm_{j}`` are ``decoder.blocks.{i}.conv{j+1}.0``/``.1``, the
    top-level ``Conv_0`` is ``classifier``."""
    out = _effi_encoder("encoder", ("EfficientNetEncoder_0",))
    for i in range(5):
        for j in range(2):
            port, p = f"decoder.blocks.{i}.conv{j + 1}", (f"DecoderBlock_{i}",)
            out += (_conv(f"{port}.0", p + (f"Conv_{j}",), bias=False)
                    + _batch_norm(f"{port}.1", p + (f"BatchNorm_{j}",)))
    return out + _conv("classifier", ("Conv_0",))


def _res2net(port: str, path: Tuple[str, ...], layers: Sequence[int]
             ) -> List[Leaf]:
    """Res2Net v1b (stem and ``layers``) under its own names, the keys
    ``cvssl_tpu/models/cnn_checkpoint.py::convert_res2net_encoder`` reads:
    ``Conv_0..2``/``BatchNorm_0..2`` are ``conv1.0``/``conv1.1``,
    ``conv1.3``/``conv1.4``, ``conv1.6``/``bn1``; ``Bottle2neck_{k}``
    (numbered across the layers) is ``layer{i}.{b}``: ``Conv_0`` ``conv1``,
    ``Conv_{1..3}`` ``convs.{0..2}``, ``Conv_4`` ``conv3``, ``Conv_5`` (a
    layer's first block) ``downsample.1``, each with its norm."""
    out = []
    for i, (conv, bn) in enumerate((("conv1.0", "conv1.1"),
                                    ("conv1.3", "conv1.4"),
                                    ("conv1.6", "bn1"))):
        out += (_conv(f"{port}{conv}", path + (f"Conv_{i}",), bias=False)
                + _batch_norm(f"{port}{bn}", path + (f"BatchNorm_{i}",)))
    k = 0
    for li, blocks in enumerate(layers, 1):
        for b in range(blocks):
            t, p = f"{port}layer{li}.{b}", path + (f"Bottle2neck_{k}",)
            names = [("conv1", "bn1")] + [(f"convs.{j}", f"bns.{j}")
                                          for j in range(3)]
            names.append(("conv3", "bn3"))
            if b == 0:
                names.append(("downsample.1", "downsample.2"))
            for i, (conv, bn) in enumerate(names):
                out += (_conv(f"{t}.{conv}", p + (f"Conv_{i}",), bias=False)
                        + _batch_norm(f"{t}.{bn}", p + (f"BatchNorm_{i}",)))
            k += 1
    return out


def _preunet(layers: Sequence[int]) -> List[Leaf]:
    """PreUNet: ``Res2NetEncoder_0`` is ``encoder`` (:func:`_res2net`),
    ``_ConvBlock_{k}``'s ``Conv_0``/``BatchNorm_0``/``Conv_1``/
    ``BatchNorm_1`` are ``decoder{k+1}.0``/``.1``/``.3``/``.4``, the
    top-level ``Conv_0`` is ``out_conv``."""
    out = _res2net("encoder.", ("Res2NetEncoder_0",), layers)
    for k in range(6):
        p = (f"_ConvBlock_{k}",)
        for j, (c, n) in enumerate(((0, 1), (3, 4))):
            out += (_conv(f"decoder{k + 1}.{c}", p + (f"Conv_{j}",))
                    + _batch_norm(f"decoder{k + 1}.{n}",
                                  p + (f"BatchNorm_{j}",)))
    return out + _conv("out_conv", ("Conv_0",))


def res2net_layers(tree) -> Tuple[int, ...]:
    """The blocks of each Res2Net layer, read off a Flax tree (PreUNet's or
    its encoder's: a ``Bottle2neck`` with ``Conv_5`` opens a layer) or a
    ``state_dict``'s names (``layer{i}.{b}.``)."""
    tree = tree.get("Res2NetEncoder_0", tree)
    if "Bottle2neck_0" in tree:
        layers: List[int] = []
        k = 0
        while f"Bottle2neck_{k}" in tree:
            if "Conv_5" in tree[f"Bottle2neck_{k}"]:
                layers.append(0)
            layers[-1] += 1
            k += 1
        return tuple(layers)
    depth: Dict[int, int] = {}
    for name in tree:
        m = re.match(r"(?:encoder\.)?layer(\d+)\.(\d+)\.", name)
        if m:
            i, b = int(m.group(1)), int(m.group(2))
            depth[i] = max(depth.get(i, 0), b + 1)
    return tuple(depth[i] for i in sorted(depth))


def _gan_norm(norm: str, port: str, path: Tuple[str, ...]) -> List[Leaf]:
    """A GAN net's norm: BatchNorm's tensors under "batch"; "instance" and
    "none" hold none."""
    return _batch_norm(port, path + ("BatchNorm_0",)) if norm == "batch" \
        else []


def _nlayer_discriminator(levels: int, norm: str) -> List[Leaf]:
    """NLayerDiscriminator: ``Conv_0`` is ``model.0``; level n (1 ..
    ``levels``: the stride-2 levels, then the stride-1 one) is ``Conv_n``
    at ``model.{3n-1}`` and ``_Norm_{n-1}`` at ``model.{3n}``; the last
    ``Conv_{levels+1}`` is ``model.{3 levels + 2}``."""
    bias = norm == "instance"
    out = _conv("model.0", ("Conv_0",))
    for n in range(1, levels + 1):
        out += (_conv(f"model.{3 * n - 1}", (f"Conv_{n}",), bias)
                + _gan_norm(norm, f"model.{3 * n}", (f"_Norm_{n - 1}",)))
    return out + _conv(f"model.{3 * levels + 2}", (f"Conv_{levels + 1}",))


def _resnet_generator(blocks: int, norm: str, padded: bool = True,
                      dropout: bool = False) -> List[Leaf]:
    """ResnetGenerator in pix2pix's layout: ``Conv_0..2``/``_Norm_0..2``
    are ``model.1``/``.2``, ``model.4``/``.5``, ``model.7``/``.8``;
    ``ResnetBlock_{b}`` is ``model.{10+b}.conv_block``, its ``Conv_j``/
    ``_Norm_j`` at indices that move with the pad modules (none under
    "zero" padding) and the dropout; ``ConvTranspose_0..1``/``_Norm_3..4``
    follow the blocks, and ``Conv_3`` is the head (``model.{17+blocks}``)."""
    bias = norm == "instance"
    out = []
    for i, c in enumerate((1, 4, 7)):
        out += (_conv(f"model.{c}", (f"Conv_{i}",), bias)
                + _gan_norm(norm, f"model.{c + 1}", (f"_Norm_{i}",)))
    first = int(padded)
    second = first + 3 + int(dropout) + int(padded)
    for b in range(blocks):
        blk, p = f"model.{10 + b}.conv_block", (f"ResnetBlock_{b}",)
        for j, k in enumerate((first, second)):
            out += (_conv(f"{blk}.{k}", p + (f"Conv_{j}",), bias)
                    + _gan_norm(norm, f"{blk}.{k + 1}", p + (f"_Norm_{j}",)))
    t = 10 + blocks
    for j, c in enumerate((t, t + 3)):
        out += (_conv(f"model.{c}", (f"ConvTranspose_{j}",), bias, "tkernel")
                + _gan_norm(norm, f"model.{c + 1}", (f"_Norm_{3 + j}",)))
    return out + _conv(f"model.{t + 7}", ("Conv_3",))


def _unet_generator(blocks: int, norm: str) -> List[Leaf]:
    """UnetGenerator: Flax keeps every ``UnetSkipConnectionBlock_{k}`` at
    the top level, k = 0 the innermost, ``blocks - 1`` the outermost
    (``model.model``); each inner block is index 1 (of the outermost) or 3
    (of a middle block) of its parent's ``model``. A block's ``Conv_0`` is
    its down conv, ``ConvTranspose_0`` its up conv, ``_Norm_0``/``_Norm_1``
    its down and up norms (the innermost's ``_Norm_0`` is its up norm)."""
    bias = norm == "instance"
    out, port = [], "model.model"
    for k in reversed(range(blocks)):
        p = (f"UnetSkipConnectionBlock_{k}",)
        if k == blocks - 1:         # down, inner, ReLU, up, tanh
            out += (_conv(f"{port}.0", p + ("Conv_0",), bias)
                    + _conv(f"{port}.3", p + ("ConvTranspose_0",), True,
                            "tkernel"))
            port += ".1.model"
        elif k == 0:                # LeakyReLU, down, ReLU, up, norm
            out += (_conv(f"{port}.1", p + ("Conv_0",), bias)
                    + _conv(f"{port}.3", p + ("ConvTranspose_0",), bias,
                            "tkernel")
                    + _gan_norm(norm, f"{port}.4", p + ("_Norm_0",)))
        else:       # LeakyReLU, down, norm, inner, ReLU, up, norm
            out += (_conv(f"{port}.1", p + ("Conv_0",), bias)
                    + _gan_norm(norm, f"{port}.2", p + ("_Norm_0",))
                    + _conv(f"{port}.5", p + ("ConvTranspose_0",), bias,
                            "tkernel")
                    + _gan_norm(norm, f"{port}.6", p + ("_Norm_1",)))
            port += ".3.model"
    return out


def _scse() -> List[Leaf]:
    """SCSEModule: Flax's ``Conv_0``/``Conv_1`` are ``cSE.1``/``cSE.3``,
    ``Conv_2`` is ``sSE.0``."""
    return (_conv("cSE.1", ("Conv_0",)) + _conv("cSE.3", ("Conv_1",))
            + _conv("sSE.0", ("Conv_2",)))


_GAN_NETS = ("nlayer_discriminator", "resnet_generator", "unet_generator")


def _names(tree: Mapping) -> List[str]:
    """A ``state_dict``'s keys, or a nested Flax tree's paths joined by
    '/'."""
    out = []
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out += [f"{k}/{n}" for n in _names(v)]
        else:
            out.append(k)
    return out


def gan_layout(net_type: str, tree: Mapping) -> tuple:
    """A GAN net's layout, read off a Flax ``params`` tree or a
    ``state_dict``'s names: ``(levels, norm)`` of an NLayerDiscriminator,
    ``(blocks, norm)`` of a UnetGenerator, ``(blocks, norm, padded,
    dropout)`` of a ResnetGenerator (from Flax, padded and without dropout:
    its tree shows neither). ``norm`` is "batch" where BatchNorm's tensors
    are, else "instance" where the convs carry biases, else "none"."""
    names = _names(tree)
    flax = not any("." in n for n in names)
    bias = {"nlayer_discriminator": ("Conv_1/bias", "model.2.bias"),
            "resnet_generator": ("Conv_0/bias", "model.1.bias"),
            "unet_generator": ("UnetSkipConnectionBlock_0/Conv_0/bias",
                               "model.model.0.bias")}[net_type]
    norm = ("batch" if any("BatchNorm_0" in n or n.endswith("running_mean")
                           for n in names)
            else "instance" if bias[not flax] in names else "none")
    if net_type == "nlayer_discriminator":
        if flax:
            return len([n for n in tree if n.startswith("Conv_")]) - 2, norm
        last = max(int(n.split(".")[1]) for n in names)
        return (last - 2) // 3, norm
    if net_type == "unet_generator":
        if flax:
            return len([n for n in tree
                        if n.startswith("UnetSkipConnectionBlock_")]), norm
        return max(n.split(".").count("model") for n in names) - 1, norm
    if flax:
        return len([n for n in tree if n.startswith("ResnetBlock_")]), norm, \
            True, False
    blocks = {n.split(".")[1] for n in names if ".conv_block." in n}
    if not blocks:
        return 0, norm, True, False
    padded = "model.10.conv_block.0.weight" not in names
    # the dropout moves the second conv one index on
    dropout = f"model.10.conv_block.{5 if padded else 3}.weight" not in names
    return len(blocks), norm, padded, dropout


def _pooled_side(n_in: int, channels: int) -> int:
    side = int(round((n_in // channels) ** 0.5))
    if side * side * channels != n_in:
        raise ValueError(f"a Dense of {n_in} inputs over {channels} channels "
                         "is not a square pooled map")
    return side


def leaves(net_type: str, depths: Sequence[int] = (2, 2, 2, 2),
           layout: tuple = (6, 2, False)) -> List[Leaf]:
    """Every tensor of ``net_type``'s ``state_dict`` with its place in the
    flax trees (``depths``: SwinUnet's or SwinUNETR's stages, UNETR's
    block count as its one element; ``layout``: nnUNet's, as
    :func:`nnunet_layout` reads it, or a GAN net's, as :func:`gan_layout`
    does)."""
    if net_type == "nlayer_discriminator":
        return _nlayer_discriminator(*layout)
    if net_type == "resnet_generator":
        return _resnet_generator(*layout)
    if net_type == "unet_generator":
        return _unet_generator(*layout)
    if net_type == "scse":
        return _scse()
    if net_type == "unetr":
        return _unetr(depths[0])
    if net_type == "swinunetr":
        return _swin_unetr(depths)
    if net_type == "vnet":
        return _vnet()
    if net_type == "voxresnet":
        return _voxresnet()
    if net_type == "attention_unet":
        return _attention_unet()
    if net_type == "nnUNet":
        return _nnunet(*layout)
    if net_type == "pnet":
        return _pnet()
    if net_type == "enet":
        return _enet()
    if net_type == "efficient_unet":
        return _effiunet()
    if net_type == "preunet":
        return _preunet(depths)
    if net_type == "res2net_encoder":
        return _res2net("", (), depths)
    if net_type == "discriminator":
        return _discriminator()
    if net_type == "discriminator_3d":
        return _discriminator_3d()
    if net_type in ("unet_3D", "unet_3D_dv_semi"):
        return _unet_3d(net_type == "unet_3D_dv_semi")
    if net_type in ("swin_unet", "ViT_Seg"):
        return _swin_unet(depths)
    if net_type == "projector":
        return _head(2, final=False)
    if net_type == "classifier":
        return _head(3, final=True)
    enc = _encoder("encoder", ("Encoder_0",))
    if net_type == "unet":
        return enc + _decoder("decoder", ("Decoder_0",))
    if net_type == "unet_cct":
        names = ("main_decoder", "aux_decoder1", "aux_decoder2",
                 "aux_decoder3")
        return enc + [leaf for i, n in enumerate(names)
                      for leaf in _decoder(n, (f"Decoder_{i}",))]
    if net_type in ("unet_ds", "unet_urpc"):
        return enc + _multiscale_decoder("decoder",
                                         ("_MultiScaleDecoder_0",))
    if net_type == "unet_feature":
        return (enc + _ups("decoder", ())
                + _conv("decoder.out_conv", ("Conv_0",)))
    raise ValueError(f"no flax conversion for {net_type!r}")


def _get(tree: Mapping, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def torch_kernel(v: np.ndarray, kind: str = "kernel") -> np.ndarray:
    """A Flax conv kernel (*k, in, out) as torch's: (out, in, *k) for a
    conv (``kind`` "kernel"), (in, out, *k) flipped on every spatial axis
    for a transpose conv ("tkernel")."""
    n = v.ndim - 2
    if kind == "kernel":
        return np.transpose(v, (n + 1, n) + tuple(range(n)))
    return np.ascontiguousarray(np.flip(
        np.transpose(v, (n, n + 1) + tuple(range(n))), tuple(range(2, n + 2))))


def flax_kernel(v: np.ndarray, kind: str = "kernel") -> np.ndarray:
    """The inverse of :func:`torch_kernel`."""
    spatial = tuple(range(2, v.ndim))
    if kind == "kernel":
        return np.transpose(v, spatial + (1, 0))
    return np.transpose(np.flip(v, spatial), spatial + (0, 1))


def _leaves_of(net_type: str, tree: Mapping,
               layout: Optional[tuple] = None) -> List[Leaf]:
    """:func:`leaves` with the stage layout read off ``tree`` (a Flax
    ``params`` tree or a ``state_dict``), a GAN net's ``layout`` where
    given."""
    if net_type in _GAN_NETS:
        return leaves(net_type, layout=layout or gan_layout(net_type, tree))
    if net_type == "nnUNet":
        return leaves(net_type, layout=nnunet_layout(tree))
    if net_type in ("unetr", "swinunetr"):
        return leaves(net_type, vit3d_layout(tree))
    if net_type in ("preunet", "res2net_encoder"):
        return leaves(net_type, res2net_layers(tree))
    if net_type == "vnet" and not (
            "block_one.conv.1.running_mean" in tree
            or "BatchNorm_0" in tree.get("ConvStage_0", {}).get("_Norm_0",
                                                                {})):
        raise ValueError("vnet: only normalization='batchnorm' converts")
    return leaves(net_type, swin_depths(tree))


def state_dict_from_flax(net_type: str, params: Mapping,
                         batch_stats: Mapping, layout: Optional[tuple] = None
                         ) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) of the ``cvssl_tpu`` model registered as
    ``net_type`` -> a ``state_dict`` for the port's model of that name
    (``layout``: a GAN net's, as :func:`gan_layout` returns it, where the
    Flax tree cannot show it)."""
    trees = {"params": params, "batch_stats": batch_stats}
    sd: Dict[str, np.ndarray] = {}
    for key, coll, path, kind in _leaves_of(net_type, params, layout):
        if kind == "count":
            sd[key] = np.zeros((), np.int64)
            continue
        v = np.asarray(_get(trees[coll], path))
        if kind in ("kernel", "tkernel"):
            v = torch_kernel(v, kind)
        elif kind == "dense":
            v = v.T
        elif kind == "prelu":                  # () -> nn.PReLU's (1,)
            v = v.reshape(1)
        elif kind.startswith("dense:"):        # (h*w*c, out) -> (out, c*h*w)
            c = sd[kind[6:]].shape[0]
            s = _pooled_side(v.shape[0], c)
            v = v.reshape(s, s, c, -1).transpose(3, 2, 0, 1).reshape(
                v.shape[1], -1)
        sd[key] = v
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def flax_from_state_dict(net_type: str, state_dict: Mapping
                         ) -> Tuple[dict, dict]:
    """The inverse: a port ``state_dict`` (or any mapping with its keys, such
    as gradients) -> numpy (params, batch_stats) trees."""
    trees: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, coll, path, kind in _leaves_of(net_type, state_dict):
        if kind == "count":
            continue
        v = state_dict[key]
        v = np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
        if kind in ("kernel", "tkernel"):
            v = flax_kernel(v, kind)
        elif kind == "dense":
            v = v.T
        elif kind == "prelu":
            v = v.reshape(())
        elif kind.startswith("dense:"):        # (out, c*h*w) -> (h*w*c, out)
            c = state_dict[kind[6:]].shape[0]
            s = _pooled_side(v.shape[1], c)
            v = v.reshape(-1, c, s, s).transpose(2, 3, 1, 0).reshape(
                -1, v.shape[0])
        node = trees[coll]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(v, order="C")
    return trees["params"], trees["batch_stats"]
