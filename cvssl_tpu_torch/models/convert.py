"""Flax UNet weights -> the port's ``state_dict``: the inverse of
``cvssl_tpu/models/torch_convert.py::convert_unet_checkpoint``.

Takes the numpy trees (``params``, ``batch_stats``) of a ``cvssl_tpu`` UNet
on its plain path and returns torch tensors under the original torch names.
Conv kernels go from (kh, kw, in, out) to (out, in, kh, kw).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _conv(p: Mapping) -> Dict[str, np.ndarray]:
    return {"weight": np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)),
            "bias": np.asarray(p["bias"])}


def _convblock(out: dict, prefix: str, p: Mapping, bs: Mapping):
    for i, (conv_i, bn_i) in enumerate(((0, 1), (4, 5))):
        for k, v in _conv(p[f"Conv_{i}"]).items():
            out[f"{prefix}.{conv_i}.{k}"] = v
        bn, st = p[f"BatchNorm_{i}"], bs[f"BatchNorm_{i}"]
        out[f"{prefix}.{bn_i}.weight"] = np.asarray(bn["scale"])
        out[f"{prefix}.{bn_i}.bias"] = np.asarray(bn["bias"])
        out[f"{prefix}.{bn_i}.running_mean"] = np.asarray(st["mean"])
        out[f"{prefix}.{bn_i}.running_var"] = np.asarray(st["var"])
        out[f"{prefix}.{bn_i}.num_batches_tracked"] = np.zeros((), np.int64)


def unet_state_dict_from_flax(params: Mapping, batch_stats: Mapping
                              ) -> Dict[str, torch.Tensor]:
    """(params, batch_stats) of ``cvssl_tpu.models.unet.UNet`` -> a
    ``state_dict`` for ``cvssl_tpu_torch.models.unet.UNet``."""
    enc_p, enc_bs = params["Encoder_0"], batch_stats["Encoder_0"]
    dec_p, dec_bs = params["Decoder_0"], batch_stats["Decoder_0"]
    sd: Dict[str, np.ndarray] = {}
    _convblock(sd, "encoder.in_conv.conv_conv", enc_p["ConvBlock_0"],
               enc_bs["ConvBlock_0"])
    for k in range(1, 5):
        _convblock(sd, f"encoder.down{k}.maxpool_conv.1.conv_conv",
                   enc_p[f"DownBlock_{k - 1}"]["ConvBlock_0"],
                   enc_bs[f"DownBlock_{k - 1}"]["ConvBlock_0"])
    for k in range(1, 5):
        up_p = dec_p[f"UpBlock_{k - 1}"]
        _convblock(sd, f"decoder.up{k}.conv.conv_conv", up_p["ConvBlock_0"],
                   dec_bs[f"UpBlock_{k - 1}"]["ConvBlock_0"])
        for name, v in _conv(up_p["Conv_0"]).items():
            sd[f"decoder.up{k}.conv1x1.{name}"] = v
    for name, v in _conv(dec_p["Conv_0"]).items():
        sd[f"decoder.out_conv.{name}"] = v
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}
