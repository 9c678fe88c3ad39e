"""Weight conversion between the JAX package, reference checkpoints and the port."""

from .multitask import (
    convert_multitask_state_dict,
    multitask_state_dict_from_flax,
    segmentation_unet_state_dict_from_flax,
)
from .simple_dense_net import simple_dense_net_state_dict_from_flax
from .unet import (
    ConversionError,
    convert_lightning_state_dict,
    convert_unet_state_dict,
    frac_head_state_dict_from_flax,
    load_strict,
    load_reference_checkpoint,
    unet_4to3_state_dict_from_flax,
    unet_state_dict_from_flax,
)

__all__ = [
    "ConversionError",
    "convert_lightning_state_dict",
    "convert_multitask_state_dict",
    "convert_unet_state_dict",
    "load_reference_checkpoint",
    "load_strict",
    "unet_state_dict_from_flax",
    "unet_4to3_state_dict_from_flax",
    "frac_head_state_dict_from_flax",
    "multitask_state_dict_from_flax",
    "segmentation_unet_state_dict_from_flax",
    "simple_dense_net_state_dict_from_flax",
]
