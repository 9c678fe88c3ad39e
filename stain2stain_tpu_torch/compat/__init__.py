"""Weight conversion between the JAX package, reference checkpoints and the port."""

from .unet import load_reference_checkpoint, unet_state_dict_from_flax

__all__ = ["load_reference_checkpoint", "unet_state_dict_from_flax"]
