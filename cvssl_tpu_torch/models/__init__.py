"""Model zoo (the 2D UNet family, the discriminators, SwinUnet and the 3D
UNets so far)."""

from cvssl_tpu_torch.models.factory import (net_factory,  # noqa: F401
                                            net_factory_3d)
