"""Nothing the benchmark runs loads JAX or the JAX package, by a whole
top-level-name comparison that lets the port's name through; the plain
reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark import core
from benchmark.tests.tiny import ROOT


def test_whole_name_comparison(monkeypatch):
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen", "stain2stain_tpu", "stain2stain_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name in core.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)
    for name in ("stain2stain_tpu_torch", "stain2stain_tpu_torch.ops", "jaxtyping_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name not in core.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("stain2stain_tpu", "stain2stain_tpu_torch", "jax", "flax"), (path, m)


def test_no_file_of_the_old_bench_is_read():
    old = ("bench" + ".py", "BENCH" + "_r0", "MULTICHIP" + "_r0", "BASELINE" + ".json")
    for path in (ROOT / "benchmark").rglob("*.py"):
        text = path.read_text().replace("test_bench", "")
        assert not any(name in text for name in old), path


def test_a_whole_tiny_run_loads_neither():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from benchmark import core\n"
        "from benchmark.tests import tiny\n"
        "cell = tiny.cell('train.cfm-unet-256')\n"
        "r = core.Record(cell=cell, seed=3, traced=False)\n"
        "core.driver('train').run(r, tiny.ROOT, 'cpu', 0.5, time.monotonic())\n"
        "from benchmark import control\n"
        "print('LOADED', core.forbidden_modules())\n" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PROJECT_ROOT": str(ROOT), "USE_FLAX": "0"})
    assert "LOADED []" in out.stdout, out.stderr[-2000:]
