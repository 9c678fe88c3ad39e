"""Hydra/OmegaConf-equivalent config system of the PyTorch port.

The port's own copy of ``stain2stain_tpu/config``: ``compose`` (+ defaults
lists / experiment overlays / CLI overrides), ``instantiate`` (``_target_``
trees, with JAX-package targets mapped onto the port), ``Config`` (DictConfig
analog), and ``config_main`` (``@hydra.main`` analog with multirun).
"""

from .compose import ComposeError, compose, parse_overrides
from .instantiate import (
    InstantiationError,
    get_class,
    get_method,
    get_object,
    instantiate,
    port_target,
)
from .main import config_main, runtime_config
from .node import (
    MISSING,
    Config,
    InterpolationError,
    MissingMandatoryValue,
    register_resolver,
    select,
)

__all__ = [
    "Config",
    "ComposeError",
    "InstantiationError",
    "InterpolationError",
    "MISSING",
    "MissingMandatoryValue",
    "compose",
    "config_main",
    "get_class",
    "get_method",
    "get_object",
    "instantiate",
    "parse_overrides",
    "port_target",
    "register_resolver",
    "runtime_config",
    "select",
]
