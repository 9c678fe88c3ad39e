"""What every run shares: the manifest and the files it names, the cache
directories, the run's record, the correctness verdict and the result line.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix. The configuration is ``configs/<name>.json`` (its file is
named in the manifest), and it names its plain reference net, a file of its
own (``reference``); the traffic is ``traffic/<name>.json``, whose ``kind``
names the driver in ``drivers/`` that runs it. Each per-layer metric is read
by ``metrics/<metric name>.py`` in the cells its ``workloads`` lists. A new
configuration, architecture, mix or metric is a new file and a new manifest
entry.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "stain2stain_tpu")


def cache_dir(root: Path) -> Path:
    """The fixed directory, inside the checkout, of everything a run keeps for later runs."""
    return root / "benchmark" / "cache"


def cache_env(root: Path) -> dict:
    """The environment that keeps every build and kernel cache at a fixed path in the checkout."""
    cache = cache_dir(root)
    return {
        "S2S_TORCH_BUILD_DIR": str(cache / "build"),
        "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
        "TRITON_CACHE_DIR": str(cache / "triton"),
        "USE_FLAX": "0",
        "USE_JAX": "0",
        "PROJECT_ROOT": str(root),
    }


def load_manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload with everything its files say."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    root: Path = HERE.parent

    @classmethod
    def from_manifest(cls, root: Path, manifest: dict, name: str) -> "Cell":
        work = find(manifest["workloads"], name, "workload")
        entry = find(manifest["configs"], work["config"], "config")
        config = load_json(root / entry["file"])
        traffic = load_json(root / "benchmark" / "traffic" / f"{work['traffic']}.json")
        ends = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
        layers = [m for m in manifest["per_layer"] if name in m["workloads"]]
        return cls(name, config, traffic, int(work["chips"]), ends, layers, root)

    @property
    def reference(self):
        """The module of the plain reference net that the configuration names."""
        return reference(self.root, self.config["reference"])


def driver(kind: str):
    """The module of ``drivers/<kind>.py``."""
    if not NAME.match(kind):
        raise ValueError(f"bad traffic kind {kind!r}")
    return importlib.import_module(f"benchmark.drivers.{kind}")


def _no_fused_convs(net_cfg: dict, size: int) -> list:
    return []


def _nothing_zeroed(name: str) -> bool:
    return False


def reference(root: Path, path: str):
    """The plain reference module at ``path`` under ``root`` (a configuration's
    ``reference``), loaded once a file. It has ``build(net_cfg, device)``,
    whose net has ``forward(t, x, ctx=None)`` and ``dropout_layers``, and
    ``attention_shapes(net_cfg, size)``; ``fused_convs(net_cfg, size)`` and
    ``zeroed(name)`` where it leaves them out list no convolution and zero
    nothing (``benchmark/README.md``)."""
    if Path(path).is_absolute() or ".." in Path(path).parts:
        raise ValueError(f"a reference lies inside the checkout: {path!r}")
    file = (root / path).resolve()
    name = f"benchmark_reference_{file.stem}_{hashlib.sha1(str(file).encode()).hexdigest()[:10]}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, file)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[name]
            raise
        for key, default in (("fused_convs", _no_fused_convs), ("zeroed", _nothing_zeroed)):
            if not hasattr(module, key):
                setattr(module, key, default)
    return sys.modules[name]


def metric_reader(root: Path, name: str) -> Callable[["Record"], Optional[float]]:
    """``read(record)`` of ``benchmark/metrics/<name>.py`` under ``root``: the
    metric's value, or None where it finds nothing."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Check:
    """One compared number beside its limit; it passes at or under the limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Record:
    """What a run measured: its window, the counts it made, the reduced trace
    (``--trace 1``) and the work counted from the configuration's shapes."""

    cell: Cell
    seed: int
    traced: bool
    window_s: float = 0.0
    counts: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    trace: Any = None
    end_to_end: dict = field(default_factory=dict)
    checks: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0

    def note(self, text: str) -> None:
        """A line for the reader of the run's standard error."""
        print(text, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's, compared whole."""
    return sorted({name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN})


def metrics_of(record: Record) -> dict:
    """The cell's end-to-end metrics (untraced) or its per-layer metrics
    (traced); a reader that finds nothing is left out."""
    out = {}
    if record.traced:
        for m in record.cell.per_layer:
            value = metric_reader(record.cell.root, m["name"])(record)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in record.cell.end_to_end:
            if m["name"] in record.end_to_end:
                out[m["name"]] = {"value": record.end_to_end[m["name"]], "unit": m["unit"]}
    return out


def result_line(record: Record, device: dict) -> dict:
    line = {
        "correct": bool(record.checks) and all(c.ok for c in record.checks),
        "attempted": record.attempted,
        "failed": record.failed,
        "metrics": metrics_of(record),
        "device": device,
    }
    if record.traced and record.trace is not None:
        line["breakdown"] = record.trace.breakdown()
    line["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in record.checks}
    return line


def print_checks(record: Record) -> None:
    for c in record.checks:
        print(f"compared {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()


def moving_leaves(reference_grad: dict, floor_share: float = 1e-3) -> set:
    """The leaves whose reference gradient is at least ``floor_share`` of the
    median leaf's. The others (a conv bias ahead of a GroupNorm, whose
    gradient the norm cancels) move under Adam by round-off alone."""
    import statistics

    median = statistics.median(reference_grad.values())
    return {k for k, g in reference_grad.items() if g >= floor_share * median}


def norm_gap(program: dict, reference: dict, leaves: set) -> tuple[float, str]:
    """The worst leaf's gap between two per-leaf norms, against the larger of
    that leaf's reference norm and the median leaf's, over ``leaves``."""
    import statistics

    median = statistics.median(reference[k] for k in leaves)
    worst, where = 0.0, ""
    for k in leaves:
        gap = abs(program[k] - reference[k]) / max(reference[k], median)
        if gap > worst or gap != gap:
            worst, where = gap, k
    return worst, where
