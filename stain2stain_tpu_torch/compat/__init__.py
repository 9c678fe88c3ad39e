"""Weight conversion between the JAX package, reference checkpoints and the port."""

from .unet import (
    frac_head_state_dict_from_flax,
    load_reference_checkpoint,
    unet_4to3_state_dict_from_flax,
    unet_state_dict_from_flax,
)

__all__ = [
    "load_reference_checkpoint",
    "unet_state_dict_from_flax",
    "unet_4to3_state_dict_from_flax",
    "frac_head_state_dict_from_flax",
]
