"""Run one cell of ``BENCHMARK.json`` on this machine's card and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` when traced, and last ``compared``: each number compared with
the plain reference beside its limit. The same comparisons are the last
lines of standard error. Exits non-zero with no result when there is no
CUDA card, fewer cards than the cell asks for, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import core

    cell = core.Cell.from_manifest(ROOT, core.load_manifest(ROOT), args.workload)
    for key, value in {**core.cache_env(ROOT), **cell.config.get("env", {})}.items():
        os.environ[key] = value
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    record = core.Record(cell=cell, seed=args.seed, traced=bool(args.trace))
    core.driver(cell.traffic["kind"]).run(record, ROOT, "cuda", args.seconds, T_START)
    loaded = core.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": record.memory_peak_bytes}
    if record.traced:
        if record.trace is None:
            print("the traced run recorded no trace", file=sys.stderr)
            return 4
        device.update(busy_s=record.trace.busy_s, window_s=record.trace.window_s)
        record.note("device time by category: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in sorted(record.trace.by_category.items(), key=lambda kv: -kv[1])))
    line = core.result_line(record, device)
    core.print_checks(record)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
