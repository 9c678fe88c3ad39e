"""Tensor ops of the port (counterparts of ``stain2stain_tpu/ops``)."""

from .. import _build


def _declared() -> dict:
    """{name: kernel} of the hand-written kernels (``_build.KERNELS``), in the
    order of the op modules below and, within one, of its declarations:
    importing a module declares its kernels."""
    from . import attention, conv, dropout, norms

    return {k.name: k for module in (attention, conv, dropout, norms) for k in vars(module).values()
            if isinstance(k, _build.Kernel)}


def launches() -> dict:
    """{kernel: launches} of the hand-written kernels (K1-fwd, K1-bwd, K2-K5,
    the hash dropout's as ``"dropout"``, the DiT's LayerNorm-modulate pair as
    ``"ln_modulate_fwd"`` and ``"ln_modulate_bwd"``) since :func:`zero_launches`."""
    return {name: kernel.launches for name, kernel in _declared().items()}


def zero_launches() -> None:
    """Every hand-written kernel's launch count to 0."""
    for kernel in _declared().values():
        kernel.launches = 0
