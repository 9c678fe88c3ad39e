"""Networks of the port (counterparts of ``stain2stain_tpu/models``)."""

from .dit import DiT
from .segmentation_unet import SegmentationUNet
from .shared_encoder import DoubleConv, SharedEncoder, TimeEmbedding
from .simple_dense_net import SimpleDenseNet
from .task_decoders import FlowMatchingDecoder, SegmentationDecoder, Up
from .unet import UNetModel
from .unet_4to3 import UNet4to3

__all__ = [
    "DiT",
    "UNetModel",
    "UNet4to3",
    "SharedEncoder",
    "DoubleConv",
    "TimeEmbedding",
    "FlowMatchingDecoder",
    "SegmentationDecoder",
    "Up",
    "SegmentationUNet",
    "SimpleDenseNet",
]
