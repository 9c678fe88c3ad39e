"""The sealed generator under dopri5 (one ``while_loop`` node), on the CPU.

A one-level UNet (16 px, 16 channels, attention at ds 1 and in the mid
block: seven traces of the net in the program, kept small) with jittered
flax weights: the loaded program within 1e-6 of the direct ``generate`` and
3e-4 of JAX's dopri5 ``generate``; its graph holds the ``while_loop`` and,
inside its body, ``s2s::attention_fwd``. The direct path warns when the
loop stops short of t=1; the same function, exported, carries no warning.
"""

from __future__ import annotations

import warnings

import pytest
import torch

from stain2stain_tpu_torch.ops.solvers import odeint_dopri5
from tests.test_torch_export import _pair, check_sealed_generator


@pytest.fixture(scope="module")
def small_nets():
    return _pair(num_channels=16, num_res_blocks=1, channel_mult=(1,), attention_resolutions="16", num_head_channels=8)


def test_sealed_generator_matches_direct_and_jax(small_nets, tmp_path):
    check_sealed_generator(*small_nets, tmp_path, "dopri5", 100)


def test_stopped_short_warns_only_on_the_direct_path():
    """``max_steps=2`` stops the solve short: the direct call warns, the
    exported program (the same function) runs to the same state silently."""

    class Decay(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.rate = torch.nn.Parameter(torch.tensor(3.0))

        def forward(self, x):
            return odeint_dopri5(lambda t, y: -self.rate * y, x, max_steps=2, modules=(self,))

    model, x = Decay(), torch.ones(2, 3)
    with pytest.warns(RuntimeWarning, match="dopri5 stopped at t="), torch.no_grad():
        direct = model(x)
    program = torch.export.export(model, (x,), strict=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loaded = program.module()(x)
    assert torch.equal(loaded, direct)
