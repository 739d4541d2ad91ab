"""Pretrained encoders from a local torch file (port of
``cvssl_tpu/models/cnn_checkpoint.py``).

The reference downloads ImageNet weights for its Res2Net-101 and
EfficientNet-B3 encoders at run time (``Res2Net_v1b.py:208-214``,
``efficient_encoder.py:111``); here, as in JAX, ``--pretrained_ckpt``
names a local ``.pth`` (``res2net101_v1b_26w_4s-*.pth``,
``efficientnet-b3-*.pth`` or a Swin-tiny file) and ``Engine.init_state``
loads it into each model it belongs to, before the teachers are copied.

The port's ``PreUNet`` and ``EffiUNet`` keep the published names under
``encoder.`` (``models/resunet.py``, ``models/efficientunet.py``), so a
published ``state_dict`` is the encoder's own state: the loaders select and
check keys and shapes, with no layout change (torch's depthwise kernels
(C, 1, kh, kw) are the port's). Keys the port does not build are ignored:
Res2Net's ``layer4.*`` and ``fc.*``, EfficientNet's top-level
``_conv_head``, ``_bn1`` and ``_fc``; so are BatchNorm's
``num_batches_tracked`` counters, which Flax does not keep either.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping

import torch
from torch import nn

from cvssl_tpu_torch.models.efficientunet import EffiUNet
from cvssl_tpu_torch.models.resunet import PreUNet
from cvssl_tpu_torch.models.swin_unet import SwinUnet

StateDict = Dict[str, torch.Tensor]


def require_file(path: str):
    """``FileNotFoundError`` with the remedy where ``path`` is absent."""
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained checkpoint not found: {path!r}. The reference "
            "downloads ImageNet weights at run time (Res2Net_v1b.py:208, "
            "efficient_encoder.py:111); offline you must supply a local "
            ".pth file via --pretrained_ckpt.")


def load_torch_state_dict(path: str) -> StateDict:
    """A ``.pth`` file's tensors on the CPU, unwrapping a ``state_dict`` or
    ``model`` entry (Lightning's and the Swin zoo's wrappers). A missing
    file raises (:func:`require_file`)."""
    require_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def checkpoint_family(sd: Mapping[str, torch.Tensor]) -> str:
    """The published schema ``sd`` follows, by its signature keys:
    "swin" (microsoft/Swin-Transformer), "efficientnet" (lukemelas'
    efficientnet_pytorch), "res2net" (Res2Net v1b), else "unknown"."""
    if "layers.0.blocks.0.attn.qkv.weight" in sd:
        return "swin"
    if "_conv_stem.weight" in sd:
        return "efficientnet"
    if "conv1.0.weight" in sd and "layer1.0.convs.0.weight" in sd:
        return "res2net"
    return "unknown"


def _checked(module: nn.Module, sd: Mapping[str, torch.Tensor], what: str
             ) -> StateDict:
    """The entries of ``sd`` for every tensor of ``module``'s state (but
    the BatchNorm counters), shapes checked: a missing key or another
    shape raises ``ValueError``."""
    out = {}
    for k, v in module.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k not in sd:
            raise ValueError(f"{what}: the checkpoint has no {k!r} — wrong "
                             "checkpoint for this encoder?")
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{what}: {k!r} is {tuple(sd[k].shape)} in the "
                             f"checkpoint, {tuple(v.shape)} in the model")
        out[k] = sd[k]
    return out


def convert_res2net_encoder(sd: Mapping[str, torch.Tensor],
                            model: PreUNet) -> StateDict:
    """A ``res2net101_v1b_26w_4s`` ``state_dict`` -> the entries of
    ``model.encoder`` (its stem and layers 1-3), under ``encoder.``."""
    enc = _checked(model.encoder, sd, "res2net -> PreUNet encoder")
    return {f"encoder.{k}": v for k, v in enc.items()}


def convert_efficientnet_encoder(sd: Mapping[str, torch.Tensor],
                                 model: EffiUNet) -> StateDict:
    """An efficientnet_pytorch B3 ``state_dict`` -> the entries of
    ``model.encoder`` (the stem and the 26 blocks), under ``encoder.``."""
    enc = _checked(model.encoder, sd, "efficientnet -> EffiUNet encoder")
    return {f"encoder.{k}": v for k, v in enc.items()}


def convert_effiunet_full(sd: Mapping[str, torch.Tensor],
                          model: EffiUNet) -> StateDict:
    """A whole reference ``Effi_UNet`` ``state_dict``
    (``efficientunet.py:141-216``: ``encoder.*``, ``decoder.blocks.*``,
    ``classifier``) -> ``model``'s. A 1-channel stem (the reference's
    ``patch_first_conv`` sums the RGB kernel for ``in_channels=1``) becomes
    kernel / 3 tiled to 3 channels: the port tiles the input instead, and
    conv(tile(x), W / 3 tiled) == conv(x, W)."""
    sd = dict(sd)
    stem = sd.get("encoder._conv_stem.weight")
    if stem is not None and stem.shape[1] == 1:
        sd["encoder._conv_stem.weight"] = (stem / 3.0).repeat(1, 3, 1, 1)
    return _checked(model, sd, "Effi_UNet -> EffiUNet")


def maybe_load_encoder(model: nn.Module, sd: Mapping[str, torch.Tensor]
                       ) -> bool:
    """Load ``sd`` into ``model`` in place where it belongs, by its
    family: Swin-tiny into a ``SwinUnet`` (the reference's ``load_from``,
    ``models/swin_checkpoint.py``; nothing loaded raises ``ValueError``),
    Res2Net into ``PreUNet``'s encoder, EfficientNet into ``EffiUNet``'s.
    Any other pair is left untouched, so a multi-model run (cross-teaching's
    UNet and SwinUnet) loads the file only into the model it fits. Returns
    whether it loaded."""
    family = checkpoint_family(sd)
    if isinstance(model, SwinUnet) and family == "swin":
        from cvssl_tpu_torch.models.swin_checkpoint import load_from
        report = load_from(model, sd)
        if report["loaded"] == 0:
            raise ValueError("swin checkpoint matched no SwinUnet tensors — "
                             f"wrong geometry for this model? {report}")
        return True
    if isinstance(model, PreUNet) and family == "res2net":
        enc = convert_res2net_encoder(sd, model)
    elif isinstance(model, EffiUNet) and family == "efficientnet":
        enc = convert_efficientnet_encoder(sd, model)
    else:
        return False
    model.load_state_dict(enc, strict=False)
    return True
