"""2D model registry (port of ``cvssl_tpu/models/factory.py``; the UNet
family, the discriminator, SwinUnet and the contrastive heads so far)."""
from __future__ import annotations

from typing import Callable, Dict

from torch import nn

from cvssl_tpu_torch.models import discriminator, projector, swin_unet, unet

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
}
_REGISTRY_2D["ViT_Seg"] = _REGISTRY_2D["swin_unet"]


def net_factory(net_type: str = "unet", in_chns: int = 1,
                class_num: int = 3, **kwargs) -> nn.Module:
    """2D registry (reference ``net_factory.py:77-107``)."""
    if net_type not in _REGISTRY_2D:
        raise ValueError(
            f"unknown 2D net {net_type!r}; available: {sorted(_REGISTRY_2D)}")
    return _REGISTRY_2D[net_type](in_chns=in_chns, class_num=class_num,
                                  **kwargs)
