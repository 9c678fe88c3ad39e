"""Networks of the port (counterparts of ``stain2stain_tpu/models``)."""

from .unet import UNetModel

__all__ = ["UNetModel"]
