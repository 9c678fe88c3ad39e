"""Hydra-style config composition: defaults lists, overlays, CLI overrides.

The port's own copy of ``stain2stain_tpu/config/compose.py`` (the port
imports nothing of the JAX package). It covers the composition features the
shared ``configs/`` tree uses (``configs/train.yaml``,
``configs/experiment/*.yaml``, ``configs/callbacks/default.yaml``):

- root defaults lists with ``_self_``, ``group: option``, ``group: null``,
  ``optional group: option``
- group option files with their own (relative) defaults lists
- ``# @package _global_`` overlays (experiment/debug files) whose defaults use
  ``override /group: option`` directives
- CLI overrides: ``group=option`` choice overrides, ``a.b.c=val`` value
  overrides, ``+a.b=val`` appends, ``~a.b`` deletes
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import yaml

from .node import Config, MISSING

_PACKAGE_RE = re.compile(r"^#\s*@package\s+(\S+)\s*$", re.MULTILINE)


class _ConfigLoader(yaml.SafeLoader):
    """SafeLoader with scientific-notation floats.

    YAML 1.1 (PyYAML) treats ``1e-4`` as a *string* because the exponent form
    requires a dot (``1.0e-4``); Hydra/OmegaConf accept it as float and the
    reference configs rely on that (e.g. ``lr: 1e-4``). Same fix as the
    well-known loader patch: re-register the float resolver with a regex that
    covers dotless exponents.
    """


_ConfigLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def yaml_load(text: str) -> Any:
    """yaml.safe_load with Hydra-compatible float parsing."""
    return yaml.load(text, Loader=_ConfigLoader)


class ComposeError(Exception):
    pass


@dataclass
class Overrides:
    """Parsed CLI overrides, split into group choices and value edits."""

    choices: dict = field(default_factory=dict)  # group path -> option (or None)
    values: list = field(default_factory=list)  # (dotted key, value)
    appends: list = field(default_factory=list)  # (dotted key, value)
    deletes: list = field(default_factory=list)  # dotted keys


def _parse_value(raw: str) -> Any:
    """Parse a CLI override value with YAML semantics (ints, bools, lists...)."""
    try:
        return yaml_load(raw)
    except yaml.YAMLError:
        return raw


def parse_overrides(config_dir: Path, overrides: list[str]) -> Overrides:
    out = Overrides()
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        if ov.startswith("~"):
            out.deletes.append(ov[1:].split("=", 1)[0])
            continue
        append = ov.startswith("+")
        if append:
            ov = ov[1:]
        if "=" not in ov:
            raise ComposeError(f"Override '{ov}' must be key=value, +key=value or ~key")
        key, raw = ov.split("=", 1)
        key = key.strip()
        # A key naming a config group directory is a group-choice override.
        if "." not in key and (config_dir / key).is_dir():
            out.choices[key] = None if raw in ("null", "None", "") else raw
        elif append:
            out.appends.append((key, _parse_value(raw)))
        else:
            out.values.append((key, _parse_value(raw)))
    return out


def _load_yaml(path: Path) -> tuple[dict, str | None]:
    """Load a yaml file, returning (body, @package directive or None)."""
    text = path.read_text()
    m = _PACKAGE_RE.search(text)
    package = m.group(1) if m else None
    body = yaml_load(text)
    if body is None:
        body = {}
    if not isinstance(body, dict):
        raise ComposeError(f"Config file {path} must contain a mapping at top level")
    return body, package


def _find_option_file(config_dir: Path, group: str, option: str) -> Path | None:
    option = option.removesuffix(".yaml")
    for candidate in (config_dir / group / f"{option}.yaml", config_dir / group / option / "default.yaml"):
        if candidate.is_file():
            return candidate
    return None


@dataclass
class _DefaultEntry:
    group: str | None  # None for _self_
    option: Any  # option name, or None (null choice)
    optional: bool = False
    is_override: bool = False
    absolute: bool = False  # '/group' style


def _parse_defaults(defaults: list, own_group: str | None) -> list[_DefaultEntry]:
    entries: list[_DefaultEntry] = []
    for item in defaults:
        if item == "_self_":
            entries.append(_DefaultEntry(group=None, option=None))
            continue
        if isinstance(item, str):
            # Relative sibling default inside a group (e.g. callbacks/default.yaml
            # composing `- model_checkpoint`), or `- default` inheritance.
            entries.append(_DefaultEntry(group=own_group or "", option=item))
            continue
        if isinstance(item, dict):
            (key, option), = item.items()
            key = key.strip()
            optional = False
            is_override = False
            if key.startswith("optional "):
                optional = True
                key = key[len("optional "):].strip()
            if key.startswith("override "):
                is_override = True
                key = key[len("override "):].strip()
            absolute = key.startswith("/")
            group = key.lstrip("/")
            if not absolute and own_group and "/" not in group:
                # Relative group reference inside a group file.
                group = f"{own_group}/{group}" if (option is not None) and group != own_group else group
            entries.append(
                _DefaultEntry(group=group, option=option, optional=optional, is_override=is_override, absolute=absolute)
            )
            continue
        raise ComposeError(f"Unsupported defaults entry: {item!r}")
    return entries


def _compose_group_file(config_dir: Path, group: str, option: str, seen: tuple = ()) -> tuple[Config, str | None]:
    """Load one group option file, recursively composing its relative defaults.

    Returns (config at the group's package level, package directive).
    """
    path = _find_option_file(config_dir, group, option)
    if path is None:
        raise ComposeError(f"Config group option not found: {group}={option}")
    key = (group, option)
    if key in seen:
        raise ComposeError(f"Defaults cycle at {group}/{option}")
    body, package = _load_yaml(path)
    defaults = body.pop("defaults", None)
    cfg = Config()
    if defaults is None:
        cfg.merge(body)
        return cfg, package

    entries = _parse_defaults(defaults, own_group=group)
    self_merged = False
    for e in entries:
        if e.group is None:  # _self_
            cfg.merge(body)
            self_merged = True
        elif e.is_override:
            # Override directives are handled at the top level (phase 1);
            # inside plain group files they are ignored here.
            continue
        elif e.option is None:
            continue
        else:
            sub_group = e.group if e.group else group
            if _find_option_file(config_dir, sub_group, str(e.option)) is None:
                # Relative `- default` style entries resolve within the same
                # dir; `optional` suppresses MISSING files only — errors
                # inside a file that exists must surface, not silently
                # compose a sibling (Hydra semantics).
                if _find_option_file(config_dir, group, str(e.option)) is not None:
                    sub_group = group
                elif e.optional:
                    continue
                else:
                    raise ComposeError(
                        f"Config group option not found: {sub_group}={e.option}"
                    )
            sub_cfg, sub_pkg = _compose_group_file(config_dir, sub_group, str(e.option), seen + (key,))
            # Relative siblings inherit the parent file's package placement
            # (e.g. debug/fdr -> debug/default, both @package _global_).
            cfg.merge(sub_cfg)
    if not self_merged:
        cfg.merge(body)
    return cfg, package


def _collect_choice_overrides(config_dir: Path, group: str, option: str) -> dict:
    """Phase-1 scan: read ``override /group: option`` directives from an overlay
    (experiment/debug/hparams_search file), following relative inheritance."""
    path = _find_option_file(config_dir, group, option)
    if path is None:
        return {}
    body, _ = _load_yaml(path)
    choices: dict = {}
    for e in _parse_defaults(body.get("defaults", []) or [], own_group=group):
        if e.is_override and e.group:
            choices[e.group.lstrip("/")] = e.option
        elif e.group == group and e.option is not None and not e.is_override:
            # relative inheritance (e.g. debug/fdr -> debug/default)
            choices.update(_collect_choice_overrides(config_dir, group, str(e.option)))
    return choices


# Groups whose files are global overlays rather than per-package configs.
_GLOBAL_OVERLAY_GROUPS = ("experiment", "debug", "hparams_search", "local")


def compose(
    config_dir: str | Path,
    config_name: str,
    overrides: list[str] | None = None,
) -> Config:
    """Compose a config exactly like ``hydra.compose(config_name, overrides)``."""
    config_dir = Path(config_dir)
    root_path = config_dir / (config_name if config_name.endswith(".yaml") else f"{config_name}.yaml")
    if not root_path.is_file():
        raise ComposeError(f"Primary config not found: {root_path}")
    ovr = parse_overrides(config_dir, overrides or [])

    root_body, _ = _load_yaml(root_path)
    root_defaults = _parse_defaults(root_body.pop("defaults", []) or [], own_group=None)

    # ---- Phase 1: resolve final group choices -------------------------------
    choices: dict[str, Any] = {}
    order: list[str] = []
    for e in root_defaults:
        if e.group is None:
            order.append("_self_")
        else:
            choices[e.group] = e.option
            order.append(e.group)
    if "_self_" not in order:
        # Hydra's implicit _self_: a root config without one still merges its
        # own body (after the defaults, so the body wins — OmegaConf order)
        order.append("_self_")
    # CLI can introduce groups not present in the root defaults list; they
    # compose after everything declared there.
    for g in ovr.choices:
        if g not in choices:
            order.append(g)

    # Overlay-driven choice overrides (experiment/debug/hparams_search), in
    # defaults-list order so later overlays win; CLI choices decide which
    # overlay files are consulted and always win for the groups they name.
    effective = dict(choices)
    effective.update(ovr.choices)
    for g in order:
        if g in _GLOBAL_OVERLAY_GROUPS and effective.get(g):
            overlay_choices = _collect_choice_overrides(config_dir, g, str(effective[g]))
            for grp, opt in overlay_choices.items():
                if grp not in choices and grp not in ovr.choices:
                    raise ComposeError(
                        f"Overlay '{g}={effective[g]}' overrides group '{grp}' "
                        f"which is not in the root defaults list (Hydra errors "
                        f"here too; add '- {grp}: ...' to the root config or "
                        f"select it on the CLI)"
                    )
                if grp not in ovr.choices:
                    effective[grp] = opt

    # ---- Phase 2: compose in defaults-list order -----------------------------
    cfg = Config()
    for g in order:
        if g == "_self_":
            cfg.merge(copy.deepcopy(root_body))
            continue
        option = effective.get(g)
        if option is None:
            continue
        entry = next((e for e in root_defaults if e.group == g), None)
        try:
            sub_cfg, package = _compose_group_file(config_dir, g, str(option))
        except ComposeError:
            if entry is not None and entry.optional:
                continue
            raise
        if package == "_global_":
            cfg.merge(sub_cfg)
        else:
            target = package if package else g.replace("/", ".")
            node = cfg
            parts = target.split(".")
            for p in parts[:-1]:
                if p not in node or not isinstance(node.get_raw(p), Config):
                    node[p] = {}
                node = node.get_raw(p)
            leaf = parts[-1]
            if leaf in node and isinstance(node.get_raw(leaf), Config):
                node.get_raw(leaf).merge(sub_cfg)
            else:
                node[leaf] = sub_cfg

    # ---- Phase 3: CLI value overrides ----------------------------------------
    for key, value in ovr.values:
        cfg[key] = value
    for key, value in ovr.appends:
        cfg[key] = value
    for key in ovr.deletes:
        try:
            del cfg[key]
        except KeyError:
            pass

    # Record the resolved choices (hydra exposes these via HydraConfig).
    cfg["runtime_choices"] = {k: v for k, v in effective.items()}
    cfg._rebind_root(cfg)
    return cfg


__all__ = ["compose", "ComposeError", "parse_overrides", "Overrides", "MISSING"]
