"""Model zoo (the plain 2D UNet so far)."""

from cvssl_tpu_torch.models.factory import net_factory  # noqa: F401
