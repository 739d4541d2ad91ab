"""Model zoo (the 2D UNet family, the discriminator and SwinUnet so far)."""

from cvssl_tpu_torch.models.factory import net_factory  # noqa: F401
