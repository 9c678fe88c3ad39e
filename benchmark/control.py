"""The control of a cell's comparison: the plain reference that the
configuration names, put in the program's place and computed in the
precision next below the one the configuration states
(``control_precision`` in the configuration file), compared by the run's
own numbers against the reference in float32. It has to come out as not
correct: the limits lie between what the program reads and what this reads.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

On the card at the cell's own size; prints one JSON line a seed with the
compared numbers. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path.cwd()
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def train_control(cell, seed: int, root: Path, device: str) -> dict:
    import torch

    from benchmark import core, inputs
    from benchmark.drivers.train import compare_steps
    from benchmark.reference import flow

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tree = inputs.tile_tree(cell.config["train"]["data"], core.cache_dir(root))
    ref = cell.reference
    net = ref.build(cell.config["net"], device=device)
    names_shapes = [(k, tuple(p.shape)) for k, p in net.named_parameters()]
    train = cell.config["train"]
    recipe, steps, rows = train["recipe"], int(cell.traffic["warm_steps"]), int(train["reference_rows"])
    runs = {}
    for precision in ("float32", cell.config["control_precision"]["train"]):
        weights = inputs.make_weights(names_shapes, seed, device, ref.zeroed)
        runs[precision] = flow.train_steps(net, weights, tree, recipe, seed, steps, device, precision=precision,
                                           rows_per_block=rows)
    record = core.Record(cell=cell, seed=seed, traced=False)
    truth = runs.pop("float32")
    compare_steps(record, next(iter(runs.values())), truth, cell.config["limits"])
    return {c.name: c.value for c in record.checks}


def serve_control(cell, seed: int, root: Path, device: str) -> dict:
    import numpy as np
    import torch

    from benchmark import core, inputs
    from benchmark.drivers.serve import compare_pixels, pixel_gaps
    from benchmark.reference import flow

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    traffic, serve = cell.traffic, cell.config["serve"]
    sizes = inputs.region_sizes(traffic)
    rng = np.random.default_rng(seed)
    images = [inputs.region_image(h, w, rng) for h, w in sizes]
    order = inputs.region_schedule(traffic, seed, 1)
    largest = max(range(len(sizes)), key=lambda i: sizes[i][0] * sizes[i][1])
    sample = [largest] + [i for i in order if i != largest][: int(traffic["check_sample"]) - 1]
    ref = cell.reference
    net = ref.build(cell.config["net"], device=device)
    names_shapes = [(k, tuple(p.shape)) for k, p in net.named_parameters()]
    net.load_state_dict(inputs.make_weights(names_shapes, seed, device, ref.zeroed))
    low = cell.config["control_precision"]["serve"]
    gaps = [pixel_gaps(flow.translate(net, images[i], serve, device, precision=low),
                       flow.translate(net, images[i], serve, device)) for i in sample]
    record = core.Record(cell=cell, seed=seed, traced=False)
    compare_pixels(record, gaps, cell.config["limits"])
    return {c.name: c.value for c in record.checks}


def control(cell, seed: int, root: Path, device: str) -> dict:
    kind = cell.traffic["kind"]
    return (train_control if kind == "train" else serve_control)(cell, seed, root, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Read a cell's control on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from benchmark import core

    cell = core.Cell.from_manifest(ROOT, core.load_manifest(ROOT), args.workload)
    for key, value in {**core.cache_env(ROOT), **cell.config.get("env", {})}.items():
        os.environ[key] = value
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name, "seed": seed, "control": control(cell, seed, ROOT, "cuda")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
