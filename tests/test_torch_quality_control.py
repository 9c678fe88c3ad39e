"""The port's noise-free quality control (counterpart of ``tests/test_quality_control.py``).

The same data, net, optimizer, epochs, validation cadence and gates as the
JAX control, on the CPU in f32. JAX's control is calibrated for one seed of
its own PRNG streams, which the port cannot replay, so the port trains seeds
0-3 and holds the mean over them to JAX's gates
(``stain2stain_tpu_torch.quality.control_verdict``); each seed's numbers are
printed. Run it with ``pytest -m slow tests/test_torch_quality_control.py -s``.
"""

import json

import pytest

from stain2stain_tpu_torch.quality import CONTROL_SEEDS, control_run, control_verdict

# slow tier: four controls of a few hundred train steps each
pytestmark = pytest.mark.slow


def test_ssim_not_degrading_with_ode_steps(tmp_path):
    runs = []
    for seed in CONTROL_SEEDS:
        run = control_run(seed, tmp_path, device="cpu")
        print("# quality control " + json.dumps(run))
        runs.append(run)
    verdict = control_verdict(runs)
    print("# quality control mean " + json.dumps(verdict))
    assert not verdict["failures"], verdict
