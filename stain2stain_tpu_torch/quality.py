"""The smoke-scale quality control (counterpart of ``tests/test_quality_control.py``).

A 16-channel UNet learns the noise-free synthetic translation
(``deterministic=True``: the target is an exact function of the source) at
32 px: 64 training pairs, batch 16, Adam 2e-3, 150 epochs, validation every
50, f32. The test tiles are then translated with 2, 8 and 50 euler steps.
A converged field translates well at every step count, and more steps must
not degrade the SSIM, since the CFM paths are straight lines.

The JAX control is calibrated for one seed of JAX's PRNG streams, which torch
cannot replay. So the port trains :data:`CONTROL_SEEDS` and holds the mean
over them to JAX's gates (:func:`control_verdict`): val/loss below
:data:`MAX_VAL_LOSS`, the 8- and 50-step SSIM no more than :data:`MAX_GAP`
below the 2-step SSIM, and the 50-step SSIM above :data:`MIN_SSIM` (JAX's
gate for f32 training on the CPU).
"""

from __future__ import annotations

import time
from pathlib import Path

CONTROL_SEEDS = (0, 1, 2, 3)
CONTROL_STEPS = (2, 8, 50)
MAX_VAL_LOSS = 0.02
MAX_GAP = 0.05
MIN_SSIM = 0.6


def control_run(seed: int, work: str | Path, device: str = "cuda", max_epochs: int = 150) -> dict:
    """Train the control net from ``seed`` under ``work`` on ``device`` and
    score the test split: {"seed", "val_loss", "ssim": {steps: value},
    "psnr": {steps: value}, "fit_s", "eval_s"}. The data are the same for
    every seed (the generator's seed 0, as JAX's control)."""
    from .data import PairedDataModule
    from .data.synthetic import generate_paired_dataset
    from .models import UNetModel
    from .ops.metrics import evaluate_quality
    from .tasks import ConditionalFlowMatchingModule
    from .training import Adam, Trainer
    from .utils.seed import seed_everything

    work = Path(work)
    seed_everything(seed)
    root = work / "d"
    if not (root / "metadata.csv").exists():
        generate_paired_dataset(root, n_train=64, n_val=8, n_test=8, size=32, deterministic=True)
    dm = PairedDataModule(data_dir=str(root), batch_size=16, image_size=32, num_workers=2, use_augmentation=False)
    net = UNetModel(dim=(3, 32, 32), num_channels=16, num_res_blocks=1, channel_mult=(1, 2),
                    attention_resolutions="", num_heads=1, dropout=0.0, device=device)
    task = ConditionalFlowMatchingModule(net=net, optimizer=lambda params: Adam(params, lr=2e-3))
    trainer = Trainer(default_root_dir=str(work / f"logs-{seed}"), max_epochs=max_epochs,
                      check_val_every_n_epoch=50, log_every_n_steps=1000, logger=False, accelerator=device)
    t0 = time.perf_counter()
    trainer.fit(task, dm)
    fit_s = time.perf_counter() - t0
    dm.setup("test")
    ssim, psnr = {}, {}
    t0 = time.perf_counter()
    for num_steps in CONTROL_STEPS:
        m = evaluate_quality(task, dm.test_dataloader(), num_steps=num_steps)
        ssim[num_steps], psnr[num_steps] = m["ssim"], m["psnr"]
    return dict(seed=seed, val_loss=trainer.callback_metrics["val/loss"], ssim=ssim, psnr=psnr, fit_s=fit_s,
                eval_s=time.perf_counter() - t0)


def control_verdict(runs: list[dict]) -> dict:
    """JAX's gates on the mean over ``runs``: {"mean_val_loss", "mean_ssim":
    {steps: value}, "failures": [the gates the means miss]}."""
    n = len(runs)
    val = sum(r["val_loss"] for r in runs) / n
    mean = {s: sum(r["ssim"][s] for r in runs) / n for s in CONTROL_STEPS}
    failures = []
    if not val < MAX_VAL_LOSS:
        failures.append(f"mean val/loss {val:.4f} >= {MAX_VAL_LOSS}")
    for s in (8, 50):
        if not mean[s] >= mean[2] - MAX_GAP:
            failures.append(f"mean {s}-step SSIM {mean[s]:.3f} < mean 2-step {mean[2]:.3f} - {MAX_GAP}")
    if not mean[50] > MIN_SSIM:
        failures.append(f"mean 50-step SSIM {mean[50]:.3f} <= {MIN_SSIM}")
    return dict(mean_val_loss=val, mean_ssim=mean, failures=failures)


__all__ = ["CONTROL_SEEDS", "CONTROL_STEPS", "control_run", "control_verdict"]
