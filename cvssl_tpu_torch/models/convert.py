"""Flax UNet-family and discriminator weights <-> the port's ``state_dict``.

Takes the numpy trees (``params``, ``batch_stats``) of a ``cvssl_tpu``
UNet-family model on its plain path, or of its ``FCDiscriminator``, and
returns torch tensors under the port's names, and back. For the plain UNet
this is the inverse of ``cvssl_tpu/models/torch_convert.py::
convert_unet_checkpoint`` (the original torch names). The original torch
tree names none of the variants, so their names are SSL4MIS's:
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

Conv kernels go from (kh, kw, in, out) to (out, in, kh, kw).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# (port key, flax collection, flax path, kind); kind "kernel" transposes,
# "count" is BatchNorm's num_batches_tracked, which flax does not keep,
# "dense:<port key>" is a Dense kernel over an NHWC flatten whose channel
# count is the length of that port tensor
Leaf = Tuple[str, str, Tuple[str, ...], str]


def _conv(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    return [(f"{port}.weight", "params", path + ("kernel",), "kernel"),
            (f"{port}.bias", "params", path + ("bias",), "plain")]


def _convblock(port: str, path: Tuple[str, ...]) -> List[Leaf]:
    out = []
    for i, (conv_i, bn_i) in enumerate(((0, 1), (4, 5))):
        out += _conv(f"{port}.{conv_i}", path + (f"Conv_{i}",))
        bn, p = f"{port}.{bn_i}", path + (f"BatchNorm_{i}",)
        out += [(f"{bn}.weight", "params", p + ("scale",), "plain"),
                (f"{bn}.bias", "params", p + ("bias",), "plain"),
                (f"{bn}.running_mean", "batch_stats", p + ("mean",), "plain"),
                (f"{bn}.running_var", "batch_stats", p + ("var",), "plain"),
                (f"{bn}.num_batches_tracked", "", (), "count")]
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


def _pooled_side(n_in: int, channels: int) -> int:
    side = int(round((n_in // channels) ** 0.5))
    if side * side * channels != n_in:
        raise ValueError(f"a Dense of {n_in} inputs over {channels} channels "
                         "is not a square pooled map")
    return side


def leaves(net_type: str) -> List[Leaf]:
    """Every tensor of ``net_type``'s ``state_dict`` with its place in the
    flax trees."""
    if net_type == "discriminator":
        return _discriminator()
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


def state_dict_from_flax(net_type: str, params: Mapping,
                         batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) of the ``cvssl_tpu`` model registered as
    ``net_type`` -> a ``state_dict`` for the port's model of that name."""
    trees = {"params": params, "batch_stats": batch_stats}
    sd: Dict[str, np.ndarray] = {}
    for key, coll, path, kind in leaves(net_type):
        if kind == "count":
            sd[key] = np.zeros((), np.int64)
            continue
        v = np.asarray(_get(trees[coll], path))
        if kind == "kernel":
            v = np.transpose(v, (3, 2, 0, 1))
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
    for key, coll, path, kind in leaves(net_type):
        if kind == "count":
            continue
        v = state_dict[key]
        v = np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
        if kind == "kernel":
            v = np.transpose(v, (2, 3, 1, 0))
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
