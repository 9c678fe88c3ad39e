"""Recursive ``_target_`` instantiation (hydra.utils.instantiate equivalent).

The port's own copy of ``stain2stain_tpu/config/instantiate.py``, with one
difference: the shared ``configs/`` tree names JAX-package targets
(``stain2stain_tpu.models.UNetModel``), and this module maps that prefix to
the port (``stain2stain_tpu_torch.models.UNetModel``), so no YAML is edited.
A target the port does not have raises :class:`InstantiationError` naming
it; nothing falls back to the JAX package.

Supported features:

- ``_target_``: dotted import path of a class or function
- ``_partial_: true`` → returns ``functools.partial``
- ``_recursive_: false`` → children passed as raw configs
- ``_args_``: positional arguments
- keyword overrides passed to :func:`instantiate` itself
"""

from __future__ import annotations

import functools
import importlib
from typing import Any

from .node import Config, MISSING

_JAX_PACKAGE = "stain2stain_tpu"
_PORT_PACKAGE = "stain2stain_tpu_torch"


class InstantiationError(Exception):
    pass


def port_target(path: str) -> str:
    """Map a JAX-package ``_target_`` onto the port's module of the same name."""
    if path == _JAX_PACKAGE or path.startswith(_JAX_PACKAGE + "."):
        return _PORT_PACKAGE + path[len(_JAX_PACKAGE):]
    return path


def get_class(path: str) -> Any:
    """Import and return the object at dotted ``path`` (after the port map)."""
    mapped = port_target(path)
    named = path if mapped == path else f"{path!r} (as {mapped!r})"
    module_path, _, name = mapped.rpartition(".")
    if not module_path:
        raise InstantiationError(f"Invalid _target_: {path!r}")
    try:
        module = importlib.import_module(module_path)
    except ImportError as e:
        raise InstantiationError(f"Cannot import module for _target_={named}: {e}") from e
    try:
        return getattr(module, name)
    except AttributeError as e:
        raise InstantiationError(
            f"_target_={named}: module {module_path!r} has no attribute {name!r}"
        ) from e


get_method = get_class  # hydra parity alias
get_object = get_class


def _resolve_node(value: Any, recursive: bool) -> Any:
    if isinstance(value, Config):
        if "_target_" in value:
            if recursive:
                return instantiate(value)
            return value
        if recursive:
            return Config({k: _resolve_node(value[k], recursive) for k in value})
        return value
    if isinstance(value, list):
        return [_resolve_node(v, recursive) for v in value]
    return value


def instantiate(config: Any, *args: Any, **kwargs: Any) -> Any:
    """Instantiate the object described by ``config``.

    ``None`` passes through (hydra parity); plain dicts are accepted too.
    """
    if config is None:
        return None
    if isinstance(config, dict) and not isinstance(config, Config):
        config = Config(config)
    if not isinstance(config, Config):
        raise InstantiationError(f"instantiate() expects a config mapping, got {type(config)}")
    if "_target_" not in config:
        raise InstantiationError("Config has no '_target_' key")

    target = config["_target_"]
    partial = bool(config.get("_partial_", False))
    recursive = bool(config.get("_recursive_", True))
    positional = [
        _resolve_node(v, True) for v in (config.get("_args_", []) or [])
    ] + list(args)

    call_kwargs: dict = {}
    for key in config:
        if key in ("_target_", "_partial_", "_recursive_", "_args_", "_convert_"):
            continue
        raw = config.get_raw(key)
        if raw == MISSING:
            if key not in kwargs:
                raise InstantiationError(
                    f"Missing mandatory value for '{key}' in _target_={target}"
                )
            continue  # the caller supplies it — resolving '???' would raise
        call_kwargs[key] = _resolve_node(config[key], recursive)
    call_kwargs.update(kwargs)

    fn = get_class(target)
    if partial:
        return functools.partial(fn, *positional, **call_kwargs)
    try:
        return fn(*positional, **call_kwargs)
    except TypeError as e:
        raise InstantiationError(f"Error instantiating {target}: {e}") from e


__all__ = [
    "instantiate",
    "get_class",
    "get_method",
    "get_object",
    "port_target",
    "InstantiationError",
]
