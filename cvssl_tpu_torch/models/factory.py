"""Model registries (port of ``cvssl_tpu/models/factory.py``): in 2D the
UNet family, the discriminator, SwinUnet, the contrastive heads,
``nnUNet``, ``enet``, ``pnet``, ``efficient_unet`` and ``preunet`` (JAX's
2D list); in 3D ``unet_3D``, ``unet_3D_dv_semi``, ``vnet``,
``voxresnet``, ``attention_unet``, ``nnUNet``, the ViTs ``unetr`` and
``swinunetr`` (built for ``img_size``, which ``TrainConfig.model_kwargs``
sets to the patch) and the discriminator."""
from __future__ import annotations

from typing import Callable, Dict

from torch import nn

from cvssl_tpu_torch.models import (attention_unet, discriminator,
                                    efficientunet, enet, nnunet, pnet,
                                    projector, resunet, swin_unet,
                                    swin_unetr, unet, unet3d, unetr, vnet,
                                    voxresnet)

_REGISTRY_2D: Dict[str, Callable[..., nn.Module]] = {
    "unet": lambda in_chns, class_num, **kw: unet.UNet(
        in_chns=in_chns, num_classes=class_num, **kw),
    "unet_cct": lambda in_chns, class_num, **kw: unet.UNetCCT(
        in_chns=in_chns, num_classes=class_num, **kw),
    "unet_ds": lambda in_chns, class_num, **kw: unet.UNetDS(
        in_chns=in_chns, num_classes=class_num, **kw),
    "unet_urpc": lambda in_chns, class_num, **kw: unet.UNetURPC(
        in_chns=in_chns, num_classes=class_num, **kw),
    "unet_feature": lambda in_chns, class_num, **kw: unet.UNetFeature(
        in_chns=in_chns, num_classes=class_num, **kw),
    # takes patch_size: its classifier's width follows the input size
    "discriminator": lambda in_chns, class_num, **kw:
        discriminator.FCDiscriminator(num_classes=class_num, in_chns=in_chns,
                                      **kw),
    # one or three input channels (one is repeated, as ViT_seg does)
    "swin_unet": lambda in_chns, class_num, **kw: swin_unet.SwinUnet(
        num_classes=class_num, **kw),
    # the contrastive heads take the logit map: class_num input channels
    "projector": lambda in_chns, class_num, **kw: projector.Projector(
        in_channels=class_num, **kw),
    "classifier": lambda in_chns, class_num, **kw: projector.Classifier(
        in_channels=class_num, **kw),
    # a true 2D configuration, as in JAX (the reference returns the 3D net)
    "nnUNet": lambda in_chns, class_num, **kw: nnunet.GenericUNet2D(
        in_chns=in_chns, num_classes=class_num, **kw),
    "enet": lambda in_chns, class_num, **kw: enet.ENet(
        in_chns=in_chns, num_classes=class_num, **kw),
    "pnet": lambda in_chns, class_num, **kw: pnet.PNet2D(
        in_chns=in_chns, num_classes=class_num, **kw),
    # one or three input channels (one is tiled), sides % 32
    "efficient_unet": lambda in_chns, class_num, **kw:
        efficientunet.EffiUNet(in_chns=in_chns, num_classes=class_num, **kw),
    "preunet": lambda in_chns, class_num, **kw: resunet.PreUNet(
        in_chns=in_chns, num_classes=class_num, **kw),
}
_REGISTRY_2D["ViT_Seg"] = _REGISTRY_2D["swin_unet"]

_REGISTRY_3D: Dict[str, Callable[..., nn.Module]] = {
    "unet_3D": lambda in_chns, class_num, **kw: unet3d.UNet3D(
        in_chns=in_chns, num_classes=class_num, **kw),
    "unet_3D_dv_semi": lambda in_chns, class_num, **kw:
        unet3d.UNet3DDeepSup(in_chns=in_chns, num_classes=class_num, **kw),
    "vnet": lambda in_chns, class_num, **kw: vnet.VNet(
        in_chns=in_chns, num_classes=class_num, **kw),
    "voxresnet": lambda in_chns, class_num, **kw: voxresnet.VoxResNet(
        in_chns=in_chns, num_classes=class_num, **kw),
    "attention_unet": lambda in_chns, class_num, **kw:
        attention_unet.AttentionUNet3D(in_chns=in_chns,
                                       num_classes=class_num, **kw),
    "nnUNet": lambda in_chns, class_num, **kw: nnunet.GenericUNet3D(
        in_chns=in_chns, num_classes=class_num, **kw),
    "unetr": lambda in_chns, class_num, **kw: unetr.UNETR(
        in_chns=in_chns, num_classes=class_num, **kw),
    "swinunetr": lambda in_chns, class_num, **kw: swin_unetr.SwinUNETR(
        in_chns=in_chns, num_classes=class_num, **kw),
    "discriminator": lambda in_chns, class_num, **kw:
        discriminator.FC3DDiscriminator(num_classes=class_num,
                                        in_chns=in_chns, **kw),
}


def register_2d(name: str):
    """A decorator that enters a constructor ``(in_chns, class_num, **kw)
    -> nn.Module`` into the 2D registry under ``name``."""
    def deco(fn):
        _REGISTRY_2D[name] = fn
        return fn
    return deco


def register_3d(name: str):
    """:func:`register_2d` for the 3D registry."""
    def deco(fn):
        _REGISTRY_3D[name] = fn
        return fn
    return deco


def net_factory(net_type: str = "unet", in_chns: int = 1,
                class_num: int = 3, **kwargs) -> nn.Module:
    """2D registry (reference ``net_factory.py:77-107``)."""
    if net_type not in _REGISTRY_2D:
        raise ValueError(
            f"unknown 2D net {net_type!r}; available: {sorted(_REGISTRY_2D)}")
    return _REGISTRY_2D[net_type](in_chns=in_chns, class_num=class_num,
                                  **kwargs)


def net_factory_3d(net_type: str = "unet_3D", in_chns: int = 1,
                   class_num: int = 2, **kwargs) -> nn.Module:
    """3D registry (reference ``net_factory_3d.py:10-41``)."""
    if net_type not in _REGISTRY_3D:
        raise ValueError(
            f"unknown 3D net {net_type!r}; available: {sorted(_REGISTRY_3D)}")
    return _REGISTRY_3D[net_type](in_chns=in_chns, class_num=class_num,
                                  **kwargs)


def available_2d():
    return sorted(_REGISTRY_2D)


def available_3d():
    return sorted(_REGISTRY_3D)
