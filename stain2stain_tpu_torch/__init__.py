"""stain2stain_tpu_torch — the PyTorch/CUDA port of ``stain2stain_tpu``.

The port runs on an NVIDIA Hopper card (H100). Plain tensor code is PyTorch;
every kernel the JAX package wrote in Pallas for the TPU becomes a kernel
written by hand in CUDA C++ for ``sm_90a`` (``csrc/``), built with ``nvcc``
at first use and bound through ``ctypes``. Module names mirror the JAX
package so each counterpart is easy to find. The port imports neither JAX nor
anything of ``stain2stain_tpu``.

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`resolve_device`); there is no silent fallback to the CPU.
"""

__version__ = "0.1.0"

from ._device import resolve_device

__all__ = ["resolve_device"]
