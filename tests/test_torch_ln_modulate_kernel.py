"""The DiT's LayerNorm-modulate kernels (``csrc/layer_norm_modulate.cu``) on the
card, against the plain chain (``ops/norms.py::_LayerNormModulate``) in f32.
Marked ``chip``: it skips without a card. The file imports neither JAX nor the
JAX package, so it runs on the card:
``python -m pytest --noconftest tests/test_torch_ln_modulate_kernel.py -m chip -q``."""

from __future__ import annotations

import pytest
import torch

from chip_smoke import LN_MODULATE_CASES, ln_modulate_case
from stain2stain_tpu_torch import ops
from stain2stain_tpu_torch.ops import norms


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("case", LN_MODULATE_CASES, ids=["dit-bf16", "f32-odd-t", "dit-s-bf16-x", "peaked"])
def test_kernels_are_the_plain_chain(card, case):
    """y within one bf16 step of the f32 chain (f32: 1e-6 by relative norm), dx,
    dscale and dshift within 1e-5 (bf16: one step); two runs bit for bit; one
    forward and one backward launch a call."""
    _, shape, x_dtype, param_dtype, y_dtype, peaked = case
    result = ln_modulate_case(shape, x_dtype, param_dtype, y_dtype, peaked)
    assert result["ok"], result


@pytest.mark.chip
@pytest.mark.parametrize("channels,dtype,match", [(20, torch.float32, "multiple of 8"),
                                                  (16, torch.float64, "float64")], ids=["c20", "float64"])
def test_kernels_refuse_what_they_do_not_take(card, channels, dtype, match):
    """A CUDA tensor the kernels do not take raises; it is not sent to the plain chain."""
    x = torch.zeros(2, 4, channels, dtype=dtype, device=card)
    p = torch.zeros(2, channels, dtype=dtype, device=card)
    ops.zero_launches()
    with pytest.raises(ValueError, match=match):
        norms.layer_norm_modulate(x, p, p)
    assert ops.launches()["ln_modulate_fwd"] == 0 and ops.launches()["ln_modulate_bwd"] == 0
