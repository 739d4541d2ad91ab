"""Model zoo (the 2D UNet family, the discriminators, SwinUnet, nnUNet and
the 3D CNNs so far)."""

from cvssl_tpu_torch.models.factory import (net_factory,  # noqa: F401
                                            net_factory_3d)
