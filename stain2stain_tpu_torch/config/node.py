"""Config tree with lazy ``${...}`` interpolation and ``???`` mandatory values.

The port's own copy of ``stain2stain_tpu/config/node.py``: the OmegaConf
``DictConfig`` surface that the shared ``configs/**/*.yaml`` tree relies on.
Only the features the config tree actually uses are implemented:

- dot access and item access (``cfg.model.net.num_channels``)
- ``${a.b.c}`` absolute-path interpolation (resolved lazily, against the root)
- ``${oc.env:VAR}`` / ``${oc.env:VAR,default}`` environment resolver
- ``???`` mandatory-value markers that raise on access
- deep merge (``merge``) used by the composition engine
"""

from __future__ import annotations

import os
import re
from typing import Any, Iterator, Mapping

MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class MissingMandatoryValue(Exception):
    """Raised when a ``???`` value is accessed before being provided."""


class InterpolationError(Exception):
    """Raised when an interpolation cannot be resolved."""


class Config:
    """A dict-like config node with dot access and lazy interpolation.

    Values are stored raw; interpolations are resolved at access time against
    the root of the tree, so keys injected late (e.g. ``paths.output_dir`` set
    by the runtime) are picked up by earlier references.
    """

    __slots__ = ("_data", "_root")

    def __init__(self, data: Mapping[str, Any] | None = None, _root: "Config | None" = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_root", _root)
        if data:
            for k, v in data.items():
                self._data[k] = self._wrap(v)

    # -- construction helpers -------------------------------------------------
    def _wrap(self, value: Any) -> Any:
        if isinstance(value, Config):
            # Deep-copy + re-root the whole subtree: mutating the incoming
            # node's root in place would corrupt resolution in its SOURCE
            # tree, and re-rooting only the top node would leave descendants
            # interpolating against the old tree.
            import copy as _copy

            sub = Config()
            object.__setattr__(sub, "_data", _copy.deepcopy(value._data))
            sub._rebind_root(self._root_node())
            return sub
        if isinstance(value, Mapping):
            return Config(value, _root=self._root_node())
        if isinstance(value, list):
            return [self._wrap(v) for v in value]
        return value

    def _root_node(self) -> "Config":
        node = self
        while node._root is not None:
            node = node._root
        return node

    def _rebind_root(self, root: "Config") -> None:
        """Point every descendant node's root at ``root``."""
        object.__setattr__(self, "_root", root if root is not self else None)
        for v in self._data.values():
            if isinstance(v, Config):
                v._rebind_root(root)
            elif isinstance(v, list):
                for item in v:
                    if isinstance(item, Config):
                        item._rebind_root(root)

    # -- resolution ------------------------------------------------------------
    def _resolve_value(self, value: Any, _stack: tuple = ()) -> Any:
        if isinstance(value, str):
            return self._resolve_str(value, _stack)
        if isinstance(value, list):
            return [self._resolve_value(v, _stack) for v in value]
        return value

    def _resolve_str(self, s: str, _stack: tuple = ()) -> Any:
        if "${" not in s:
            if s == MISSING:
                raise MissingMandatoryValue(f"Mandatory value is missing: '{s}'")
            return s
        # Full-string single interpolation preserves the referenced type.
        m = _INTERP_RE.fullmatch(s)
        if m:
            return self._resolve_ref(m.group(1), _stack)
        # Embedded interpolation(s): stringify each piece.
        def sub(match: re.Match) -> str:
            v = self._resolve_ref(match.group(1), _stack)
            return "" if v is None else str(v)

        out = _INTERP_RE.sub(sub, s)
        # Handle nested ${...${...}...} by iterating until fixed point.
        while "${" in out:
            new = _INTERP_RE.sub(sub, out)
            if new == out:
                raise InterpolationError(f"Unresolvable interpolation in: {s!r}")
            out = new
        return out

    def _resolve_ref(self, expr: str, _stack: tuple = ()) -> Any:
        expr = expr.strip()
        if expr in _stack:
            raise InterpolationError(f"Interpolation cycle detected at '{expr}'")
        if ":" in expr:
            name = expr.split(":", 1)[0]
            if name in _RESOLVERS:
                return _RESOLVERS[name](expr.split(":", 1)[1], self._root_node())
        if expr.startswith("oc.env:"):
            payload = expr[len("oc.env:"):]
            if "," in payload:
                var, default = payload.split(",", 1)
                return os.environ.get(var.strip(), default.strip())
            val = os.environ.get(payload.strip())
            if val is None:
                raise InterpolationError(f"Environment variable '{payload}' not set")
            return val
        if expr.startswith("hydra:") or expr.startswith("runtime:"):
            # Runtime keys are injected under ``runtime.*`` by the entrypoint.
            # Accept both this module's short form (${hydra:output_dir}) and
            # verbatim reference syntax (${hydra:runtime.output_dir}).
            key = expr.split(":", 1)[1].replace(":", ".")
            if key.startswith("runtime."):
                key = key[len("runtime."):]
            return self._root_node()._select(f"runtime.{key}", _stack + (expr,))
        return self._root_node()._select(expr, _stack + (expr,))

    def _select(self, dotted: str, _stack: tuple = ()) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Config):
                if part not in node._data:
                    raise InterpolationError(f"Interpolation key not found: '{dotted}'")
                node = node._data[part]
            elif isinstance(node, list):
                node = node[int(part)]
            else:
                raise InterpolationError(f"Cannot descend into '{dotted}' at '{part}'")
        if isinstance(node, (str, list)):
            return self._resolve_value(node, _stack)
        return node

    # -- mapping protocol --------------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        # Literal keys win (covers non-string keys like int class ids and
        # literal dotted keys like sweeper params "model.optimizer.lr");
        # otherwise a dotted key is a path traversal.
        if key in self._data:
            return self._resolve_value(self._data[key])
        if isinstance(key, str) and "." in key:
            node: Any = self
            for part in key.split("."):
                node = node[part] if isinstance(node, Config) else node[int(part)]
            return node
        raise KeyError(key)

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(key, str) and "." in key:
            head, rest = key.split(".", 1)
            existing = self._data.get(head)
            if isinstance(existing, list):
                # list element update (OmegaConf semantics: a.layers.0=99)
                idx_s, _, tail = rest.partition(".")
                idx = int(idx_s)
                if tail:
                    if not isinstance(existing[idx], Config):
                        raise KeyError(
                            f"cannot set '{key}': list element {idx} is not a mapping"
                        )
                    existing[idx][tail] = value
                else:
                    existing[idx] = self._wrap(value)
                return
            if existing is not None and not isinstance(existing, Config):
                # silently replacing a scalar intermediate with an empty
                # mapping would destroy data on a typo'd override
                raise KeyError(
                    f"cannot set '{key}': '{head}' holds a {type(existing).__name__}, "
                    "not a mapping"
                )
            if existing is None:
                self._data[head] = Config(_root=self._root_node())
            self._data[head][rest] = value
        else:
            self._data[key] = self._wrap(value)

    def __delitem__(self, key: str) -> None:
        if isinstance(key, str) and "." in key:
            head, rest = key.split(".", 1)
            del self._data[head][rest]
        else:
            del self._data[key]

    def __getattr__(self, key: str) -> Any:
        # Underscore names (slots during copy/pickle reconstruction, dunder
        # protocol probes) must raise AttributeError, not recurse into
        # __getitem__ → _data → __getattr__.
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __deepcopy__(self, memo: dict) -> "Config":
        import copy as _copy

        new = Config()
        object.__setattr__(new, "_data", _copy.deepcopy(self._data, memo))
        new._rebind_root(new)
        return new

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __contains__(self, key: str) -> bool:
        if not isinstance(key, str):
            return key in self._data
        if "." in key:
            head, rest = key.split(".", 1)
            return head in self._data and isinstance(self._data[head], Config) and rest in self._data[head]
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __bool__(self) -> bool:
        return bool(self._data)

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Config):
            return self.to_container(resolve=False) == other.to_container(resolve=False)
        if isinstance(other, Mapping):
            return self.to_container(resolve=False) == dict(other)
        return NotImplemented

    def keys(self):
        return self._data.keys()

    def values(self):
        return [self[k] for k in self._data]

    def items(self):
        return [(k, self[k]) for k in self._data]

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except (KeyError, MissingMandatoryValue):
            return default

    def get_raw(self, key: str) -> Any:
        """Fetch without interpolation resolution or ``???`` checking."""
        return self._data[key]

    def pop(self, key: str, *default: Any) -> Any:
        try:
            val = self[key]
        except (KeyError, MissingMandatoryValue):
            if default:
                return default[0]
            raise
        del self[key]
        return val

    def setdefault(self, key: str, value: Any) -> Any:
        if key not in self:
            self[key] = value
        return self[key]

    # -- merge / export ---------------------------------------------------------
    def merge(self, other: "Config | Mapping[str, Any]") -> None:
        """Deep-merge ``other`` into self (other wins; dicts merge, lists replace)."""
        items = other._data.items() if isinstance(other, Config) else other.items()
        for k, v in items:
            if (
                k in self._data
                and isinstance(self._data[k], Config)
                and isinstance(v, (Config, Mapping))
            ):
                self._data[k].merge(v)
            else:
                self._data[k] = self._wrap(
                    v.copy_raw() if isinstance(v, Config) else v
                )

    def copy_raw(self) -> "Config":
        return Config(self.to_container(resolve=False))

    def to_container(self, resolve: bool = True) -> dict:
        out: dict = {}
        for k, raw in self._data.items():
            if isinstance(raw, Config):
                out[k] = raw.to_container(resolve=resolve)
            elif resolve:
                try:
                    v = self[k]
                except MissingMandatoryValue:
                    v = MISSING
                out[k] = v.to_container(resolve=True) if isinstance(v, Config) else _listify(v, resolve)
            else:
                out[k] = _listify(raw, resolve)
        return out

    def __repr__(self) -> str:
        return f"Config({self.to_container(resolve=False)!r})"

    def to_yaml(self, resolve: bool = False) -> str:
        import yaml

        return yaml.safe_dump(self.to_container(resolve=resolve), sort_keys=False, default_flow_style=False)


# -- custom resolvers ---------------------------------------------------------
_RESOLVERS: dict = {}


def register_resolver(name: str, fn) -> None:
    """Register ``${name:payload}`` → ``fn(payload, root_cfg)``."""
    _RESOLVERS[name] = fn


def _now_resolver(fmt: str, _root: "Config") -> str:
    import datetime

    return datetime.datetime.now().strftime(fmt)


register_resolver("now", _now_resolver)


def _listify(v: Any, resolve: bool) -> Any:
    if isinstance(v, Config):
        return v.to_container(resolve=resolve)
    if isinstance(v, list):
        return [_listify(x, resolve) for x in v]
    return v


def select(cfg: Config, dotted: str, default: Any = None) -> Any:
    """``OmegaConf.select`` equivalent: dotted lookup returning default on miss."""
    try:
        return cfg[dotted]
    except (KeyError, MissingMandatoryValue, InterpolationError):
        return default
