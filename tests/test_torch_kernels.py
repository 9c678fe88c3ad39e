"""The port's one kernel seam (``_build.Kernel``), on the CPU: each hand-written
kernel declared once, from a source in ``csrc/`` with a C signature of its
declared arity, listed and reset by ``ops.launches()``; and each kernel
wrapper's one rule for kernel or plain, which refuses a device other than
CUDA or CPU before anything builds."""

from __future__ import annotations

import re

import pytest
import torch

from stain2stain_tpu_torch import _build, ops
from stain2stain_tpu_torch.ops import attention, conv, dropout, norms

KERNEL_NAMES = ["K1-fwd", "K1-bwd", "K2", "K3", "K4", "K5", "dropout", "ln_modulate_fwd", "ln_modulate_bwd"]


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_is_declared_once_built_from_csrc_and_counted(name):
    assert list(ops.launches()) == KERNEL_NAMES
    kernel = _build.KERNELS[name]
    with pytest.raises(ValueError, match="already declared"):
        _build.Kernel(name, kernel.source, kernel.symbol, [])
    assert _build.KERNELS[name] is kernel
    assert (_build.CSRC / kernel.source).is_file() and kernel.source in _build.SOURCES
    # the C function takes one argument of each declared ctypes type, the stream last
    text = (_build.CSRC / kernel.source).read_text()
    params = re.search(rf'extern "C" int {kernel.symbol}\(([^)]*)\)', text)
    assert params is not None and len(params.group(1).split(",")) == len(kernel.c_args)
    assert params.group(1).split(",")[-1].split()[-1] == "stream"
    kernel.launches = 3
    assert ops.launches()[name] == 3
    ops.zero_launches()
    assert ops.launches()[name] == 0 and kernel.launches == 0


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device="meta")


_BF16 = torch.bfloat16
WRAPPERS = {
    "fused_attention": lambda: attention.fused_attention(_meta(2, 64, 32), _meta(2, 64, 32), _meta(2, 64, 32), 1.0),
    "fused_attention_backward": lambda: attention.fused_attention_backward(
        *(_meta(2, 64, 32) for _ in range(5)), 1.0),
    "fused_conv3x3": lambda: conv.fused_conv3x3(_meta(1, 8, 16, 128, dtype=_BF16), _meta(3, 3, 128, 128)),
    "conv3x3_input_grad": lambda: conv.conv3x3_input_grad(_meta(1, 8, 16, 128, dtype=_BF16), _meta(3, 3, 128, 128)),
    "prologue_grad": lambda: conv.prologue_grad(_meta(1, 8, 16, 128, dtype=_BF16), _meta(1, 8, 16, 128, dtype=_BF16)),
    "conv3x3_weight_grad": lambda: conv.conv3x3_weight_grad(_meta(1, 8, 16, 128, dtype=_BF16),
                                                            _meta(1, 8, 16, 128, dtype=_BF16)),
    "hash_dropout": lambda: dropout.hash_dropout(_meta(2, 8, 4, 4), 12345, 0.1),
    "layer_norm_modulate": lambda: norms.layer_norm_modulate(_meta(2, 4, 16), _meta(2, 16), _meta(2, 16)),
    "layer_norm_modulate-mixed": lambda: norms.layer_norm_modulate(torch.zeros(2, 4, 16), _meta(2, 16), _meta(2, 16)),
}


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_wrapper_refuses_other_devices_before_anything_builds(wrapper, monkeypatch):
    def no_build(*_):
        raise AssertionError("a kernel library was built or loaded")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build_all", no_build)
    ops.zero_launches()
    with pytest.raises(ValueError, match="runs on CUDA or CPU tensors"):
        WRAPPERS[wrapper]()
    assert not any(ops.launches().values())
