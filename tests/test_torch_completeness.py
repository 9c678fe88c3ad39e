"""The port covers the JAX package: every public top-level ``def`` and
``class`` of ``stain2stain_tpu/`` has a name in ``stain2stain_tpu_torch/``
(or a planned difference below, with its reason), and every CLI
``src/<name>.py`` has its ``python -m stain2stain_tpu_torch.<name>`` module.

Both packages are read with ``ast``; nothing of the JAX package is imported.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
JAX_PACKAGE = REPO_ROOT / "stain2stain_tpu"
PORT = REPO_ROOT / "stain2stain_tpu_torch"

# JAX names the port has no counterpart of by design: name -> (JAX file, where the function lives in the port)
PLANNED_DIFFERENCES = {
    "FusedGroupNorm": ("models/unet.py", "the flax module of GroupNorm → (FiLM) → SiLU; the port keeps nn.GroupNorm "
                       "parameters and runs the chains as ops/norms.py's group_norm, group_norm_silu and "
                       "group_norm_film_silu"),
    "Norm2d": ("models/shared_encoder.py", "flax's group/batch switch; the port's norm2d() builds nn.GroupNorm or "
               "its flax-semantics BatchNorm2d"),
    "flatten_padded": ("training/optim.py", "optax over one padded flat vector, shardable on the fsdp axis; the port "
                       "steps torch.optim over the parameter list and shards the moments in parallel/zero.py"),
    "optax_global_norm": ("training/trainer.py", "the clipping norm over a pytree; the port's Trainer takes it over "
                          "the gradients inline (training/trainer.py, gradient_clip_val)"),
}


def _top_level(path: Path, with_assignments: bool) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif with_assignments and isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return names


def _public_defs() -> dict:
    """{name: JAX file} of every public top-level def and class of the JAX package."""
    found = {}
    for path in sorted(JAX_PACKAGE.rglob("*.py")):
        for name in _top_level(path, with_assignments=False):
            if not name.startswith("_"):
                found.setdefault(name, str(path.relative_to(JAX_PACKAGE)))
    return found


def _port_names() -> set:
    return set().union(*(_top_level(p, with_assignments=True) for p in PORT.rglob("*.py")))


def test_every_public_name_has_a_port_counterpart():
    missing = {name: where for name, where in _public_defs().items()
               if name not in _port_names() and name not in PLANNED_DIFFERENCES}
    assert not missing, f"JAX names without a port counterpart or a planned difference: {missing}"


@pytest.mark.parametrize("name", sorted(PLANNED_DIFFERENCES))
def test_planned_differences_are_current(name):
    """Each planned difference still names a JAX definition in its file, which
    the port still lacks (a name the port gains leaves the table)."""
    where, reason = PLANNED_DIFFERENCES[name]
    assert name in _top_level(JAX_PACKAGE / where, with_assignments=False)
    assert name not in _port_names() and reason


def test_every_cli_has_a_port_module():
    clis = sorted(p.stem for p in (REPO_ROOT / "src").glob("*.py") if p.stem != "__init__")
    missing = [name for name in clis if not (PORT / f"{name}.py").is_file()]
    assert not missing, f"src/*.py without a python -m stain2stain_tpu_torch.<name>: {missing}"
    for name in clis:
        source = (PORT / f"{name}.py").read_text()
        assert "def main(" in source and '__name__ == "__main__"' in source, name
