#!/usr/bin/env python
"""Train the flagship to its recorded quality with the PyTorch port and score
it (counterpart of ``scripts/r3_quality_run.sh`` steps 3-4).

    python scripts/torch_quality_run.py --path unfused|fused [--until-epoch N]
        [--work DIR] [--tiles DIR] [--set KEY=VALUE ...]

1. Writes the noise-free tile tree (``scripts/torch_gen_quality_tiles.py``)
   when it is absent.
2. Trains ``experiment=quality_real_256 trainer.accelerator=gpu
   trainer.max_epochs=200 logger=csv`` (``--path fused`` adds
   ``+model.net.fused_conv=true``) through ``stain2stain_tpu_torch.train``
   in one pinned run directory, ``<work>/run``. A run resumes from its
   ``checkpoints/last`` when one is there, so it can go in segments
   (``--until-epoch N``): ``last`` is written on validation epochs only, so
   a segment ends on a multiple of the validation cadence (20 epochs).
3. At the last epoch, the experiment's test on the best checkpoint.
4. ``python -m stain2stain_tpu_torch.eval_quality`` on ``last`` over the 32
   test tiles (batch 16, no augmentation) at 2, 8 and 50 euler steps and
   once with the config's dopri5.

Prints one JSON line per segment and evaluation, then a summary line
(``"kind": "summary"``): the card, every validation's val/loss (from the
segments' ``logger=csv`` files), the median
step, peak memory and wall seconds, the kernels' launches, test/loss,
SSIM / PSNR / FID at each step count, the bands they are held to and the
JAX package's recorded numbers beside them. Progress is kept in
``<work>/progress.json``; a finished step is not run again.

Runs on the CUDA card and raises without one. ``--device cpu`` exists for
the tests, at a tiny width given by ``--set`` (keys under ``model.`` and
``data.image_size`` / ``data.load_size`` reach the evaluation too).
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import gc
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

SCRIPTS = Path(__file__).resolve().parent
REPO_ROOT = SCRIPTS.parent
for _path in (REPO_ROOT, SCRIPTS):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))
os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))

import torch  # noqa: E402

from stain2stain_tpu_torch.ops import launches, zero_launches  # noqa: E402
from stain2stain_tpu_torch.training import Callback, CSVLogger  # noqa: E402

MAX_EPOCHS = 200
PATHS = {"unfused": [], "fused": ["+model.net.fused_conv=true"]}
# (label, solver, num_steps) of each evaluation
EVALS = [("euler-2", "euler", 2), ("euler-8", "euler", 8), ("euler-50", "euler", 50), ("dopri5", "dopri5", 50)]
# the JAX package's recorded quality of the flagship after 200 epochs (BASELINE.md: quality_synthetic_256 at
# :53-65, quality_real_256 at :124); its quality figures, not times
JAX_RECORD = {
    "quality_synthetic_256": {"best_val": 6.4e-5, "test_loss": 7.2e-5,
                              "ssim": {"euler-2": 0.925, "euler-8": 0.927, "euler-50": 0.918},
                              "psnr": {"euler-2": 28.9, "euler-8": 28.6, "euler-50": 27.5}},
    "quality_real_256": {"best_val": 1.0e-4,
                         "ssim": {"euler-2": 0.935, "euler-8": 0.942, "euler-50": 0.936, "dopri5": 0.932},
                         "psnr": {"euler-2": 29.4, "euler-8": 29.5, "euler-50": 28.6, "dopri5": 28.2}},
}
# the port's bands: at most 0.02 SSIM and 1.0 dB PSNR below the lower of JAX's two runs; best val at most 2e-4
BANDS = {"ssim": {"euler-2": 0.905, "euler-8": 0.907, "euler-50": 0.898},
         "psnr": {"euler-2": 27.9, "euler-8": 27.6, "euler-50": 26.5}, "best_val": 2.0e-4}
# override keys of the training that the evaluation takes as well (the net, the tile size)
SHARED_PREFIXES = ("model.", "+model.", "data.image_size=", "data.load_size=")


def card_line(device: str) -> str:
    if device != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


class StepTimer(Callback):
    """Each optimizer step's end on the host clock, after the device has
    finished it (``_target_: torch_quality_run.StepTimer``)."""

    def __init__(self):
        self.ends, self.t0 = [], None

    def on_train_epoch_start(self, trainer, task):
        if self.t0 is None:
            if trainer.device.type == "cuda":
                torch.cuda.synchronize(trainer.device)
            self.t0 = time.perf_counter()

    def on_train_batch_end(self, trainer, task, metrics):
        float(metrics["loss"])  # waits for the step
        self.ends.append(time.perf_counter())

    def step_ms(self) -> list[float]:
        return [(b - a) * 1e3 for a, b in zip([self.t0] + self.ends[:-1], self.ends)]


def csv_val_losses(log_dir: Path) -> list[list]:
    """[[epoch, val/loss], ...] of each validation in a CSV logger's ``metrics.csv``."""
    vals, epoch = [], None
    with open(log_dir / "metrics.csv", newline="") as f:
        for row in csv.DictReader(f):
            if row.get("epoch"):
                epoch = int(float(row["epoch"])) + 1
            if row.get("val/loss") and epoch is not None:
                vals.append([epoch, float(row["val/loss"])])
    return vals


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def last_epoch(run_dir: Path) -> int:
    """Epochs the run's ``last`` checkpoint holds (0 without one)."""
    meta = run_dir / "checkpoints" / "last" / "meta.json"
    return int(json.loads(meta.read_text())["epoch"]) + 1 if meta.exists() else 0


def train_segment(args, run_dir: Path, until: int, start: int) -> dict:
    """Train from ``start`` (resuming from ``last``) to epoch ``until``; the
    final segment also tests the best checkpoint."""
    from stain2stain_tpu_torch.config import compose
    from stain2stain_tpu_torch.train import train

    final = until == args.max_epochs
    overrides = ["experiment=quality_real_256", f"trainer.accelerator={'gpu' if args.device == 'cuda' else 'cpu'}",
                 f"trainer.max_epochs={until}", "logger=csv", f"data.data_dir={args.tiles}",
                 f"test={str(final).lower()}", *PATHS[args.path], *args.set]
    if start:
        overrides.append(f"ckpt_path={run_dir / 'checkpoints' / 'last'}")
    cfg = compose(REPO_ROOT / "configs", "train.yaml", overrides)
    cfg["runtime"] = {"output_dir": str(run_dir), "cwd": str(Path.cwd())}
    cfg["callbacks"]["step_timer"] = {"_target_": "torch_quality_run.StepTimer"}
    if args.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    metrics, objects = train(cfg)
    wall_s = time.perf_counter() - t0
    counts = launches()
    steps = objects["callbacks"][-1].step_ms()
    csv_logger = next(lg for lg in objects["logger"] if isinstance(lg, CSVLogger))
    record = dict(kind="segment", path=args.path, from_epoch=start, to_epoch=until, steps=len(steps),
                  step_ms_median=statistics.median(steps[1:]) if len(steps) > 1 else None,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30 if args.device == "cuda" else None,
                  wall_s=wall_s, launches=counts, val_loss=csv_val_losses(csv_logger.log_dir),
                  datamodule=type(objects["datamodule"]).__name__, dtype=str(objects["model"].net.dtype))
    if final:
        ckpt = objects["trainer"].checkpoint_callback
        record.update(test_loss=metrics.get("test/loss"), best=ckpt.best_model_path,
                      best_val=ckpt.best_model_score)
    del objects
    gc.collect()
    if args.device == "cuda":
        torch.cuda.empty_cache()
    return record


def evaluate(args, run_dir: Path, solver: str, num_steps: int) -> dict:
    """``eval_quality`` on the run's ``last`` checkpoint, its JSON line captured."""
    from stain2stain_tpu_torch import eval_quality

    shared = [o for o in args.set if o.startswith(SHARED_PREFIXES)]
    argv = [f"ckpt_path={run_dir / 'checkpoints' / 'last'}", "data=paired_data", f"data.data_dir={args.tiles}",
            "data.csv_file_name=metadata.csv", "data.direction=S2T", "data.image_size=256", "data.batch_size=16",
            "data.use_augmentation=false", "model=conditional_flow_matching", f"model.solver.solver={solver}",
            f"num_steps={num_steps}", f"paths.log_dir={args.work / 'logs'}", f"+device={args.device}", *shared]
    zero_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        metrics = eval_quality.main(argv)
    return dict(metrics, s=time.perf_counter() - t0, launches=launches(), printed=out.getvalue().strip())


def summary(args, progress: dict, card: str) -> dict:
    segments = progress["segments"]
    final = next((s for s in segments if s["to_epoch"] == args.max_epochs), {})
    steps = [s["step_ms_median"] for s in segments if s["step_ms_median"] is not None]
    train_launches = {k: sum(s["launches"][k] for s in segments) for k in segments[0]["launches"]} if segments else {}
    vals = [v for s in segments for v in s["val_loss"]]
    evals = progress["evals"]
    ssim = {k: e["ssim"] for k, e in evals.items()}
    psnr = {k: e["psnr"] for k, e in evals.items()}
    best_val = min((v for _, v in vals), default=None)
    misses = [f"ssim {k} {ssim.get(k)} < {b}" for k, b in BANDS["ssim"].items() if not ssim.get(k, -1) >= b]
    misses += [f"psnr {k} {psnr.get(k)} < {b}" for k, b in BANDS["psnr"].items() if not psnr.get(k, -1) >= b]
    if best_val is None or not best_val <= BANDS["best_val"]:
        misses.append(f"best val {best_val} > {BANDS['best_val']}")
    return dict(
        kind="summary", path=args.path, card=card, epochs=last_epoch(args.work / "run"),
        val_loss=vals, best_val=best_val,
        step_ms_median=statistics.median(steps) if steps else None,
        peak_gib=max((s["peak_gib"] or 0.0 for s in segments), default=None),
        wall_s=sum(s["wall_s"] for s in segments), eval_s=sum(e["s"] for e in evals.values()),
        train_launches=train_launches, eval_launches={k: e["launches"] for k, e in evals.items()},
        test_loss=final.get("test_loss"), ssim=ssim, psnr=psnr, fid={k: e.get("fid") for k, e in evals.items()},
        fid_comparable=any(e.get("fid_comparable") for e in evals.values()),
        bands=BANDS, bands_met=not misses, misses=misses, jax_record=JAX_RECORD,
    )


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--path", choices=sorted(PATHS), required=True)
    parser.add_argument("--until-epoch", type=int, default=None,
                        help="end this call's segment at this epoch (a multiple of the validation cadence)")
    parser.add_argument("--max-epochs", type=int, default=MAX_EPOCHS)
    parser.add_argument("--work", type=Path, default=None, help="default: scratch/quality_run/<path>")
    parser.add_argument("--tiles", type=Path, default=REPO_ROOT / "scratch" / "quality_real_256_tiles")
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        help="another override of the training (model.* and the tile size reach the evaluation)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="cpu: for the tests only")
    args = parser.parse_args(argv)
    args.work = (args.work or REPO_ROOT / "scratch" / "quality_run" / args.path).absolute()
    args.tiles = args.tiles.absolute()
    until = args.until_epoch or args.max_epochs
    if until > args.max_epochs:
        parser.error(f"--until-epoch {until} is past --max-epochs {args.max_epochs}")

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the quality run trains on the card")
    card = card_line(args.device)

    from torch_gen_quality_tiles import write_tree

    write_tree(args.tiles)
    run_dir = args.work / "run"
    args.work.mkdir(parents=True, exist_ok=True)
    progress_file = args.work / "progress.json"
    progress = json.loads(progress_file.read_text()) if progress_file.exists() else {"segments": [], "evals": {}}

    def save():
        progress_file.write_text(json.dumps(progress, indent=1))

    start = last_epoch(run_dir)
    if start < until:
        record = train_segment(args, run_dir, until, start)
        record["card"] = card
        emit(record)
        progress["segments"].append(record)
        save()
    if until == args.max_epochs and last_epoch(run_dir) == args.max_epochs:
        for label, solver, num_steps in EVALS:
            if label in progress["evals"]:
                continue
            record = evaluate(args, run_dir, solver, num_steps)
            progress["evals"][label] = record
            save()
            emit(dict(kind="eval", path=args.path, label=label, card=card,
                      **{k: v for k, v in record.items() if k != "printed"}))
    result = summary(args, progress, card)
    emit(result)
    return result


if __name__ == "__main__":
    main()
