"""Networks of the port (counterparts of ``stain2stain_tpu/models``)."""

from .unet import UNetModel
from .unet_4to3 import UNet4to3

__all__ = ["UNetModel", "UNet4to3"]
