"""Tensor ops of the port (counterparts of ``stain2stain_tpu/ops``)."""


def _kernels() -> dict:
    from .attention import fused_attention, fused_attention_backward
    from .conv import KERNELS
    from .dropout import hash_dropout
    from .norms import ln_modulate_bwd, ln_modulate_fwd

    return {"K1-fwd": fused_attention, "K1-bwd": fused_attention_backward,
            **{f"K{i}": kernel for i, kernel in enumerate(KERNELS, start=2)}, "dropout": hash_dropout,
            "ln_modulate_fwd": ln_modulate_fwd, "ln_modulate_bwd": ln_modulate_bwd}


def launches() -> dict:
    """{kernel: launches} of the hand-written kernels (K1-fwd, K1-bwd, K2-K5,
    the hash dropout's as ``"dropout"``, the DiT's LayerNorm-modulate pair as
    ``"ln_modulate_fwd"`` and ``"ln_modulate_bwd"``) since :func:`zero_launches`."""
    return {name: kernel.launches for name, kernel in _kernels().items()}


def zero_launches() -> None:
    """Every hand-written kernel's launch count to 0."""
    for kernel in _kernels().values():
        kernel.launches = 0
