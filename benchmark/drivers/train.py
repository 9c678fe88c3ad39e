"""The training driver: one time-bounded ``Trainer.fit`` of the program.

Set-up composes the configuration's recipe with the program's own config
code, builds the datamodule, trainer and task, puts the benchmark's weights
into the task's net and starts ``fit``. A callback of the benchmark follows
the steps: the first ``warm_steps`` (at the cell's own shapes: they build
and warm every kernel) are set-up and are what the reference follows; then
the window runs for ``--seconds`` and ends the fit at the first step
boundary after it, the card synchronized at both ends. With ``--trace 1`` the profiler
covers ``trace_steps`` whole steps of the window.

After the window: the peak memory is read, the program's state freed, and
the plain reference that the configuration names repeats the warm steps on
the same tree and weights.
"""

from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Callable, Optional

from .. import inputs, trace, work
from ..core import Check, Record, cache_dir, moving_leaves, norm_gap


def compose_recipe(root: Path, cell_config: dict, tree: Path, seed: int, device: str):
    """The program's composed training config, checked against what the
    configuration's recipe states; a recipe whose ``dropout`` is null needs a
    net that states none."""
    from stain2stain_tpu_torch.config import compose

    overrides = list(cell_config["train"]["overrides"]) + [
        f"data.data_dir={tree}", "data.csv_file_name=metadata.csv", f"data.seed={seed}", f"seed={seed}",
        f"trainer.accelerator={'gpu' if device == 'cuda' else 'cpu'}",
    ]
    if device != "cuda":
        overrides.append("data.cache=null")
    cfg = compose(root / "configs", "train.yaml", overrides)
    cfg["runtime"] = {"output_dir": str(cache_dir(root) / "out"), "cwd": str(root)}
    recipe = cell_config["train"]["recipe"]
    stated = {
        "data.batch_size": recipe["batch_size"], "data.image_size": recipe["image_size"],
        "trainer.precision": recipe["precision"], "model.optimizer.lr": recipe["optimizer"]["lr"],
        "model.optimizer.weight_decay": recipe["optimizer"]["weight_decay"], "model.net.dropout": recipe["dropout"],
    }
    for key, want in stated.items():
        node = cfg
        for part in key.split("."):
            node = node.get(part) if node is not None else None
        if str(node) != str(want) and not (isinstance(want, float) and float(node) == want):
            raise ValueError(f"the composed recipe has {key}={node!r}, the configuration states {want!r}")
    return cfg


class WindowClosed(Exception):
    """Raised by the window's callback at the first step boundary after the window."""


def _leaf_norms(tensors) -> dict:
    return {k: float(v.norm()) for k, v in tensors}


def run(record: Record, root: Path, device: str, seconds: float, t_start: float,
        patch: Optional[Callable] = None) -> None:
    """Drive the cell; fills ``record``. ``patch(trainer, task)``, if given,
    runs at fit start (the tests break the timed path with it)."""
    import torch

    from stain2stain_tpu_torch import ops
    from stain2stain_tpu_torch.config import instantiate
    from stain2stain_tpu_torch.training import Callback
    from stain2stain_tpu_torch.utils.seed import seed_everything
    from stain2stain_tpu_torch.utils.utils import instantiate_task

    from ..reference import flow

    cell, seed = record.cell, record.seed
    traffic, recipe, net_cfg, ref = cell.traffic, cell.config["train"]["recipe"], cell.config["net"], cell.reference
    warm, trace_steps = int(traffic["warm_steps"]), int(traffic["trace_steps"])
    tree = inputs.tile_tree(cell.config["train"]["data"], cache_dir(root))
    cfg = compose_recipe(root, cell.config, tree, seed, device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    class Clock(Callback):
        def __init__(self):
            self.losses, self.grad1, self.change = [], None, None
            self.t0 = self.t1 = None
            self.window_steps = 0
            self.prof = None
            self.traced = None
            self.marks = []  # (event, host time) in the window: where its time went, for the notes

        def on_train_epoch_start(self, trainer, task):
            if self.t0 is not None:
                self.marks.append(("epoch start", time.monotonic()))

        def on_validation_epoch_end(self, trainer, task):
            if self.t0 is not None:
                self.marks.append(("validation end", time.monotonic()))

        def on_fit_start(self, trainer, task):
            if patch is not None:
                patch(trainer, task)

        def on_train_batch_end(self, trainer, task, metrics):
            step = trainer.global_step
            if step <= warm:
                self.losses.append(float(metrics["loss"]))
                opt = trainer.state.optimizer
                if step == 1:
                    beta1 = opt.param_groups[0]["betas"][0]
                    self.grad1 = _leaf_norms((k, opt.state[p]["exp_avg"] / (1 - beta1)) if p in opt.state
                                             else (k, torch.zeros(())) for k, p in task.net.named_parameters())
                if step == warm:
                    self.change = _leaf_norms((k, p.detach() - start[k].to(p.device))
                                              for k, p in task.net.named_parameters())
                    sync()
                    self.t0 = time.monotonic()
                return
            self.window_steps += 1
            n = self.window_steps
            self.marks.append(("step", time.monotonic()))
            if record.traced and n == 1:
                sync()
                ops.zero_launches()
                self.prof = trace.profiler()
                self.prof.start()
                self.trace_t0 = time.monotonic()
            if record.traced and n == 1 + trace_steps:
                sync()
                window = time.monotonic() - self.trace_t0
                self.prof.stop()
                self.launches = ops.launches()
                self.traced = (self.prof, window)
            if n > trace_steps + 1 or not record.traced:
                if time.monotonic() - self.t0 >= seconds:
                    sync()
                    self.t1 = time.monotonic()
                    raise WindowClosed  # ends the fit here, whatever the recipe's min_epochs says

    seed_everything(seed)
    datamodule = instantiate(cfg["data"])
    clock = Clock()
    trainer = instantiate(cfg["trainer"], callbacks=[clock], logger=None)
    task = instantiate_task(cfg["model"], device=trainer.device)
    names_shapes = [(k, tuple(p.shape)) for k, p in task.net.named_parameters()]
    reference_names = [(k, tuple(p.shape)) for k, p in ref.build(net_cfg, device="meta").named_parameters()]
    if sorted(names_shapes) != sorted(reference_names):
        raise ValueError("the program's net and the reference's have different parameters")
    weights = inputs.make_weights(names_shapes, seed, trainer.device, ref.zeroed)
    with torch.no_grad():
        for k, p in task.net.named_parameters():
            p.copy_(weights[k])
    start = {k: w.cpu() for k, w in weights.items()}
    del weights
    try:
        trainer.fit(task, datamodule)
    except WindowClosed:
        pass
    if clock.t1 is None:
        raise RuntimeError("the fit ended before the window did")

    batch = int(recipe["batch_size"])
    gaps = sorted(((b - a, f"{ea} -> {eb}") for (ea, a), (eb, b) in zip([("window start", clock.t0)] + clock.marks,
                                                                          clock.marks)), reverse=True)[:4]
    record.note(f"window {clock.t1 - clock.t0:.3f} s, {clock.window_steps} steps; longest host intervals: "
                + ", ".join(f"{what} {dt:.3f} s" for dt, what in gaps))
    record.window_s = clock.t1 - clock.t0
    record.counts.update(steps=clock.window_steps, tiles=clock.window_steps * batch, batch=batch,
                         warm_steps=warm)
    record.attempted, record.failed = clock.window_steps, 0
    record.end_to_end["setup_s"] = clock.t0 - t_start
    for m in cell.end_to_end:  # the cell's training rate, under the name its manifest entry gives it
        if m["unit"] == "tiles/s":
            record.end_to_end[m["name"]] = clock.window_steps * batch / record.window_s
    if device == "cuda":
        record.end_to_end["train_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        record.memory_peak_bytes = int(torch.cuda.max_memory_reserved())
    if clock.traced is not None:
        prof, window = clock.traced
        record.trace = trace.reduce(prof, window)
        record.counts.update(traced_steps=trace_steps, launches=clock.launches)
    size = int(recipe["image_size"])
    cdtype = "bfloat16" if str(recipe["precision"]).startswith("bf16") else "float32"
    record.work.update(
        precision=cdtype, forward_flops_per_tile=work.forward_flops(ref, net_cfg, size),
        attention=ref.attention_shapes(net_cfg, size), resblock_convs=ref.fused_convs(net_cfg, size),
        fused_conv=bool(cell.config["train"].get("fused_conv", False)),
    )

    # ---- after the window: the program's state goes, the reference follows the warm steps
    losses, grad1, change = clock.losses, clock.grad1, clock.change
    del trainer, task, datamodule, clock
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = ref.build(net_cfg, device=device)
    weights = inputs.make_weights(names_shapes, seed, device, ref.zeroed)
    followed = flow.train_steps(net, weights, tree, recipe, seed, warm, device,
                                rows_per_block=int(cell.config["train"]["reference_rows"]))
    compare_steps(record, {"losses": losses, "grad1": grad1, "change": change}, followed, cell.config["limits"])


def compare_steps(record: Record, program: dict, ref: dict, limits: dict) -> None:
    """The numbers of the warm steps, program against reference; those the
    configuration's ``limits`` name are compared, the others noted.

    ``loss_gap``: the worst step's relative loss gap; ``loss1_gap``: the first
    step's. ``grad1_gap`` / ``change_gap``: the worst leaf's norm gap of the
    first gradient / of the change over the steps; ``*_median_gap``: the
    median leaf's (each against the larger of the leaf's reference norm and
    the median leaf's)."""
    import statistics

    gaps = [abs(a - b) / abs(b) for a, b in zip(program["losses"], ref["losses"])]
    if len(program["losses"]) != len(ref["losses"]):
        gaps = [float("inf")]
    leaves = moving_leaves(ref["grad1"])
    values = {"loss_gap": max(gaps), "loss1_gap": gaps[0]}
    for name in ("grad1", "change"):
        values[f"{name}_gap"], worst = norm_gap(program[name], ref[name], leaves)
        median = statistics.median(ref[name][k] for k in leaves)
        values[f"{name}_median_gap"] = statistics.median(
            abs(program[name][k] - ref[name][k]) / max(ref[name][k], median) for k in leaves)
        record.note(f"worst leaf of {name}: {worst}")
    record.note(f"{len(ref['grad1']) - len(leaves)} of {len(ref['grad1'])} leaves left out: reference gradient "
                "under a thousandth of the median leaf's")
    record.note(f"losses program {program['losses']} reference {ref['losses']}")
    record.note("warm-step numbers " + " ".join(f"{k} {v!r}" for k, v in values.items()))
    record.checks += [Check(k, values[k], limits[k]) for k in values if k in limits]
